"""Lockdep-style runtime lock-order watchdog.

The counterpart of the JAX package's ``runtime/lockdep.py``: observe
every acquisition of the engine's locks, keep one process-wide
acquisition-order graph, and flag the first edge that closes a cycle,
so that a deadlock which needs a precise interleaving is reported from
any interleaving that takes both orders.

Each tracked lock has an identity (its key, e.g.
``runtime.semaphore.DeviceSemaphore._cv``): acquisition order is a
property of the code path, so one key covers every instance made at
one site.  Each thread keeps its held list; acquiring B while holding A
inserts the edge A->B (under a real, untracked lock, with a
thread-local reentrancy latch).  ``Condition.wait`` drops the held
entry for its duration and records edges again on the reacquire.  A
cycle is recorded as a ``Violation``, and raised as
``LockOrderViolation`` when ``raise_on_cycle``.

The JAX package's ``enable()`` swaps ``threading``'s factories for
shims filtered by the creation site.  The port does not patch
``threading``: its own locks are made through ``tracked_lock`` /
``tracked_condition`` (the device semaphore, the memory arbiter, the
kernel launch counters, the kernel cache, the shape plane, the
partition task pool, the cancel and resilience layers), which record
only while lockdep is enabled (one attribute read when it is not).

Conf (read by ``TpuSession.__init__`` through ``configure``):
``spark.rapids.tpu.lockdep.enabled`` turns recording on;
``spark.rapids.tpu.lockdep.raiseOnCycle`` raises at the acquisition
that closes a cycle.  The registry carries the JAX package's
``tpuq_lockdep_*`` gauges and violation counter; ``counters_snapshot``
reads the same state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_THREADING_FILE = threading.__file__


class LockOrderViolation(Exception):
    """Acquisition closed a cycle in the lock-order graph."""


@dataclasses.dataclass(frozen=True)
class Violation:
    edge: Tuple[str, str]          # the edge that closed the cycle
    cycle: Tuple[str, ...]         # key path b -> ... -> a
    site: Tuple[str, int]          # (rel path, line) of the acquisition
    thread: str

    def __str__(self) -> str:
        a, b = self.edge
        rel, line = self.site
        loop = " -> ".join(self.cycle + (self.cycle[0],))
        return (f"{rel}:{line}: lock-order cycle closed by {a} -> {b} "
                f"in thread {self.thread}: {loop}")


class _State:
    def __init__(self):
        self.enabled = False
        self.raise_on_cycle = False
        self.meta = threading.Lock()
        self.graph: Dict[str, Set[str]] = {}
        self.edge_sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.violations: List[Violation] = []
        self.sites: Set[str] = set()   # distinct tracked lock keys


_S = _State()
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


# -- telemetry (leaf tier; registered at import like every producer) -----
from spark_rapids_tpu_torch.runtime import telemetry as TM  # noqa: E402

TM.REGISTRY.gauge(
    "tpuq_lockdep_locks_tracked",
    "distinct lock creation sites under lockdep tracking",
    fn=lambda: float(len(_S.sites)))
TM.REGISTRY.gauge(
    "tpuq_lockdep_edges_observed",
    "distinct held->acquired edges in the runtime lock-order graph",
    fn=lambda: float(len(_S.edge_sites)))
_TM_VIOLATIONS = TM.REGISTRY.counter(
    "tpuq_lockdep_violations_total",
    "lock-order cycles observed by the lockdep watchdog")


def counters_snapshot() -> dict:
    """Distinct tracked keys, distinct edges and violations so far."""
    with _S.meta:
        return {"locks_tracked": len(_S.sites),
                "edges_observed": len(_S.edge_sites),
                "violations": len(_S.violations)}


def _acquire_site() -> Tuple[str, int]:
    """(relpath, line) of the repo frame performing the acquisition —
    walked only when an edge is new."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if (fn != __file__ and fn != _THREADING_FILE
                and fn.startswith(_REPO_DIR + os.sep)):
            return os.path.relpath(fn, _REPO_DIR), f.f_lineno
        f = f.f_back
    return "<unknown>", 0


# -- graph bookkeeping ----------------------------------------------------

def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in the current graph, or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _S.graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(obj) -> None:
    if not _S.enabled or getattr(_tls, "in_hook", False):
        return
    _tls.in_hook = True
    try:
        held = _held()
        first = all(e is not obj for e in held)
        raised: Optional[Violation] = None
        if first and held:
            for h in held:
                if h._key == obj._key:
                    continue
                v = _add_edge(h._key, obj._key)
                if v is not None:
                    raised = v
        if raised is not None and _S.raise_on_cycle:
            # the wrapper gives the lock back: the acquire did not happen
            raise LockOrderViolation(str(raised))
        held.append(obj)
    finally:
        _tls.in_hook = False


def _note_release(obj) -> None:
    if getattr(_tls, "in_hook", False):
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i] is obj:
            del held[i]
            return
    # released by a thread that never recorded the acquire — ignore


def _add_edge(a: str, b: str) -> Optional[Violation]:
    """Insert a->b; returns a Violation when it closes a cycle."""
    with _S.meta:
        succ = _S.graph.setdefault(a, set())
        if b in succ:
            return None
        back = _find_path(b, a)
        succ.add(b)
        _S.graph.setdefault(b, set())
        site = _acquire_site()
        _S.edge_sites[(a, b)] = site
        if back is None:
            return None
        v = Violation(edge=(a, b), cycle=tuple(back), site=site,
                      thread=threading.current_thread().name)
        _S.violations.append(v)
    _TM_VIOLATIONS.inc()
    return v


# -- tracked wrappers -----------------------------------------------------

class _TrackedLock:
    """Transparent Lock/RLock wrapper recording acquisition order."""

    def __init__(self, real, key: str, kind: str):
        self._real = real
        self._key = key
        self._kind = kind

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            try:
                _note_acquire(self)
            except LockOrderViolation:
                self._real.release()
                raise
        return ok

    def release(self):
        _note_release(self)
        self._real.release()

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep {self._kind} {self._key} of {self._real!r}>"


class _TrackedCondition:
    """Condition wrapper; ``wait`` drops the held entry for its duration
    so that edges observed after the wakeup reflect the reacquire."""

    def __init__(self, real, key: str):
        self._real = real
        self._key = key
        self._kind = "Condition"

    def acquire(self, *a, **k):
        ok = self._real.acquire(*a, **k)
        if ok:
            try:
                _note_acquire(self)
            except LockOrderViolation:
                self._real.release()
                raise
        return ok

    def release(self):
        _note_release(self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        _note_release(self)
        try:
            # the caller owns the token-polling loop around this wait
            return self._real.wait(timeout)
        finally:
            _note_acquire(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _note_release(self)
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            _note_acquire(self)

    def notify(self, n: int = 1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()

    def __repr__(self):
        return f"<lockdep Condition {self._key} of {self._real!r}>"


def _register(key: str) -> None:
    with _S.meta:
        _S.sites.add(key)


def tracked_lock(key: str, reentrant: bool = False) -> _TrackedLock:
    """A lock (an RLock when ``reentrant``) whose acquisitions lockdep
    records under ``key`` while it is enabled."""
    real = threading.RLock() if reentrant else threading.Lock()
    _register(key)
    return _TrackedLock(real, key, "RLock" if reentrant else "Lock")


def tracked_condition(key: str, lock: Optional[_TrackedLock] = None
                      ) -> _TrackedCondition:
    """A condition variable recorded under ``key``; over ``lock`` (a
    tracked lock) it shares that lock's mutex and its key."""
    if lock is not None:
        return _TrackedCondition(threading.Condition(lock._real), lock._key)
    _register(key)
    return _TrackedCondition(threading.Condition(threading.RLock()), key)


# -- lifecycle ------------------------------------------------------------

def enable(raise_on_cycle: bool = False) -> None:
    """Start recording.  Acquisitions already in progress stay
    unrecorded."""
    _S.raise_on_cycle = raise_on_cycle
    _S.enabled = True


def disable() -> None:
    _S.enabled = False


def is_enabled() -> bool:
    return _S.enabled


def reset() -> None:
    """Clear the graph, edge sites and violation log (tracked locks keep
    working; their next acquisitions rebuild the graph)."""
    with _S.meta:
        _S.graph.clear()
        _S.edge_sites.clear()
        _S.violations.clear()


def violations() -> List[Violation]:
    with _S.meta:
        return list(_S.violations)


def edges() -> Dict[Tuple[str, str], Tuple[str, int]]:
    """(a, b) -> (rel path, line) of the first observation."""
    with _S.meta:
        return dict(_S.edge_sites)


@contextlib.contextmanager
def scoped(raise_on_cycle: bool = True):
    """An isolated graph for a block (enabled for its duration): a
    deliberate inversion inside it cannot leak into the process-wide
    record."""
    with _S.meta:
        saved = (_S.graph, _S.edge_sites, _S.violations,
                 _S.raise_on_cycle, _S.enabled)
        _S.graph, _S.edge_sites, _S.violations = {}, {}, []
    enable(raise_on_cycle=raise_on_cycle)
    try:
        yield _S
    finally:
        with _S.meta:
            (_S.graph, _S.edge_sites, _S.violations,
             _S.raise_on_cycle, _S.enabled) = saved


def configure(conf) -> None:
    """Session-creation hook (``spark.rapids.tpu.lockdep.enabled`` /
    ``spark.rapids.tpu.lockdep.raiseOnCycle``)."""
    from spark_rapids_tpu_torch import conf as C
    if conf.get(C.LOCKDEP_ENABLED):
        enable(raise_on_cycle=bool(conf.get(C.LOCKDEP_RAISE_ON_CYCLE)))
