"""Query lifecycle layer: cooperative cancellation and deadlines.

[REF: Spark's task-kill/interrupt lifecycle (TaskContext.isInterrupted
 polled by long-running tasks) + spill/SpillFramework.scala's
 close-on-task-completion guarantees; GpuSemaphore.scala releases its
 permit on task completion callbacks, cancelled or not.]

The counterpart of the JAX package's ``runtime/cancel.py``, its
cooperative half.  Any query can be cancelled (``session.cancel``) or
deadlined (``df.collect(timeout_ms=...)`` /
``spark.rapids.tpu.query.timeoutMs``), and the engine returns to a clean
steady state: semaphore permits released, device reservations unwound,
spill files unlinked.

One ``CancelToken`` per query, opened by the query boundary
(``DataFrame.toArrow``) and polled at every blocking boundary: the exec
pumps (``exec/base.py`` wraps every ``execute``), the device semaphore's
wait (a cancel wakes it), the retry policy's backoff sleeps and the OOM
retry loop, the spill tier's IO and the shuffle's reduce-side read.  A
cancel surfaces as ``QueryCancelled`` within about twice
``spark.rapids.tpu.query.cancelPollMs``.

Not ported: the preemption half (``request_suspend``, ``resume``,
``preempt_point``, the suspend providers) comes with ROADMAP A.11.
The cancel counters are the registry's ``tpuq_query_cancelled_total``
and ``tpuq_cancel_latency_seconds`` (``counters_snapshot`` reads them),
and the first observation of a fired token sends a ``cancel`` event to
the query's flight recorder, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

DEFAULT_POLL_S = 0.05

_TM_CANCELLED = TM.REGISTRY.labeled_counter(
    "tpuq_query_cancelled_total",
    "queries cancelled, by reason (user | deadline)", label="reason")
_TM_LATENCY = TM.REGISTRY.histogram(
    "tpuq_cancel_latency_seconds",
    "cancel-request (or deadline-expiry) to QueryCancelled-raised "
    "latency")


def counters_snapshot() -> dict:
    """``{"cancelled": {reason: n}, "latency": {count, sum, ...}}`` so
    far in this process (the registry's cancel counter and latency
    histogram)."""
    return {"cancelled": _TM_CANCELLED.child_values(),
            "latency": _TM_LATENCY.snapshot()}


class QueryCancelled(RuntimeError):
    """The query's CancelToken fired.  Not retryable: the retry policy
    and the OOM retry loop propagate it unchanged (it is an order, not a
    fault)."""

    def __init__(self, reason: str, query_id: Optional[int] = None,
                 detail: str = ""):
        msg = f"query {query_id} cancelled ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason          # "user" | "deadline"
        self.query_id = query_id


class CancelToken:
    """Per-query cancel/deadline state, polled cooperatively.

    Thread-safe; one token is shared by every pump, retry and spill
    thread of its query.  ``check()`` is the poll: one attribute read
    and a deadline compare when clean, ``QueryCancelled`` once fired.
    The first raise records the latency (from the cancel request, or
    the deadline instant, to the raise) and counts the reason.
    """

    def __init__(self, query_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 poll_ms: float = DEFAULT_POLL_S * 1000.0):
        self.query_id = query_id
        self.poll_s = max(float(poll_ms) / 1000.0, 0.001)
        self._event = threading.Event()
        self._lock = lockdep.tracked_lock("runtime.cancel.CancelToken")
        self.reason: Optional[str] = None
        self.detail: str = ""
        self._deadline: Optional[float] = None
        if timeout_ms is not None and timeout_ms > 0:
            self._deadline = time.monotonic() + float(timeout_ms) / 1000.0
        # monotonic instant the cancel became effective (request time
        # for user cancels, the deadline itself for expiries)
        self._effective_at: Optional[float] = None
        self._observed = False
        self.latency_s: Optional[float] = None
        self._waiters: List[threading.Condition] = []
        self._callbacks: List[Callable[[], None]] = []

    # -- firing ---------------------------------------------------------

    def cancel(self, reason: str = "user", detail: str = "") -> bool:
        """Fire the token (the first cancel wins; True on the
        transition).  Wakes every registered waiter and runs every
        registered callback, both outside the token lock."""
        with self._lock:
            if self._event.is_set():
                return False
            self.reason = reason
            self.detail = detail
            self._effective_at = time.monotonic()
            self._event.set()
            waiters = list(self._waiters)
            callbacks = list(self._callbacks)
        for cv in waiters:
            with cv:
                cv.notify_all()
        for cb in callbacks:
            try:
                cb()
            except Exception:
                pass  # best effort, as in the JAX package
        return True

    def _deadline_fired(self) -> bool:
        if self._deadline is None or time.monotonic() < self._deadline:
            return False
        with self._lock:
            if not self._event.is_set():
                self.reason = "deadline"
                self.detail = "query deadline expired"
                self._effective_at = self._deadline
                self._event.set()
                waiters = list(self._waiters)
            else:
                waiters = []
        for cv in waiters:
            with cv:
                cv.notify_all()
        return True

    def cancelled(self) -> bool:
        return self._event.is_set() or self._deadline_fired()

    def check(self) -> None:
        """The poll: raise ``QueryCancelled`` once fired."""
        if not self.cancelled():
            return
        with self._lock:
            first = not self._observed
            if first:
                self._observed = True
                self.latency_s = max(
                    0.0, time.monotonic() - (self._effective_at
                                             or time.monotonic()))
        if first:
            _TM_CANCELLED.inc(self.reason or "user")
            _TM_LATENCY.observe(self.latency_s)
            # flight recorder: the first observation of the fired token
            # is the moment the cancel took effect for the query
            from spark_rapids_tpu_torch.runtime import attribution
            attribution.record_event("cancel", {
                "reason": self.reason or "user",
                "query_id": self.query_id,
                "detail": self.detail,
                "latency_s": round(self.latency_s or 0.0, 6),
            })
        raise QueryCancelled(self.reason or "user", self.query_id,
                             self.detail)

    # -- waiting --------------------------------------------------------

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (None when there is none)."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def wait_interval(self, want: Optional[float] = None) -> float:
        """How long a blocking wait may park before it re-polls:
        min(poll interval, remaining deadline, the caller's own
        bound)."""
        out = self.poll_s
        rem = self.remaining_s()
        if rem is not None:
            out = min(out, max(rem, 0.001))
        if want is not None:
            out = min(out, max(want, 0.0))
        return out

    def sleep(self, seconds: float) -> None:
        """Cancellable sleep: returns after ``seconds`` or raises
        ``QueryCancelled`` within one poll interval of a cancel."""
        deadline = time.monotonic() + max(seconds, 0.0)
        while True:
            self.check()
            rem = deadline - time.monotonic()
            if rem <= 0:
                return
            self._event.wait(self.wait_interval(rem))

    def add_waiter(self, cv: threading.Condition) -> None:
        """Register a condition variable to ``notify_all`` on cancel, so
        that its waiters wake at once instead of at the next poll."""
        with self._lock:
            self._waiters.append(cv)

    def remove_waiter(self, cv: threading.Condition) -> None:
        with self._lock:
            try:
                self._waiters.remove(cv)
            except ValueError:
                pass

    def on_cancel(self, cb: Callable[[], None]) -> Callable[[], None]:
        """Register a callback run (once) on cancel; returns an
        unregister function.  If the token already fired the callback
        runs at once.  A deadline found by a poll runs no callback."""
        with self._lock:
            fired = self._event.is_set()
            if not fired:
                self._callbacks.append(cb)

        def remove():
            with self._lock:
                try:
                    self._callbacks.remove(cb)
                except ValueError:
                    pass

        if fired:
            try:
                cb()
            except Exception:
                pass
        return remove


# ---------------------------------------------------------------------------
# per-thread query scope: concurrent queries each own a token, nested
# executions on the same thread join the outer scope, and the partition
# pump's tasks re-enter their query's scope through ``bind(token)``
# ---------------------------------------------------------------------------

class _Scope(threading.local):
    token: Optional[CancelToken]
    depth: int

    def __init__(self):
        self.token = None
        self.depth = 0


_SCOPE = _Scope()
_ACTIVE: Dict[int, CancelToken] = {}   # query_id -> token (in flight)
_ACTIVE_LOCK = lockdep.tracked_lock("runtime.cancel._ACTIVE_LOCK")
# tokens of open begin_query scopes, in open order: while exactly one
# query runs, threads the engine starts without bind() still see its
# token; with several, an unbound thread sees none
_AMBIENT: List[CancelToken] = []


def _thread_token() -> Optional[CancelToken]:
    tok = _SCOPE.token
    if tok is not None:
        return tok
    amb = _AMBIENT
    return amb[0] if len(amb) == 1 else None


def register(token: CancelToken) -> None:
    """Make a token addressable by ``cancel_query`` / ``active_queries``
    before its query executes."""
    if token.query_id is None:
        raise ValueError("cannot register a token without a query_id")
    with _ACTIVE_LOCK:
        _ACTIVE[token.query_id] = token


def unregister(token: CancelToken) -> None:
    """Drop a ``register``-ed token (idempotent; never drops another
    token that reused the id)."""
    if token.query_id is None:
        return
    with _ACTIVE_LOCK:
        if _ACTIVE.get(token.query_id) is token:
            del _ACTIVE[token.query_id]


def begin_query(query_id: int, conf=None,
                timeout_ms: Optional[float] = None,
                token: Optional[CancelToken] = None
                ) -> Optional[CancelToken]:
    """Open (or join) the calling thread's cancel scope.  Returns the
    token for the outermost open (the handle ``finish_query`` needs);
    nested executions on the same thread join the outer token and get
    None.  ``timeout_ms`` overrides ``spark.rapids.tpu.query.timeoutMs``;
    <= 0 means no deadline.  ``token`` adopts a token made earlier."""
    _SCOPE.depth += 1
    if _SCOPE.depth > 1:
        return None  # joined this thread's outer query token
    if token is None:
        poll_ms = DEFAULT_POLL_S * 1000.0
        conf_timeout = None
        if conf is not None:
            from spark_rapids_tpu_torch import conf as C
            poll_ms = float(conf.get(C.CANCEL_POLL_MS))
            conf_timeout = float(conf.get(C.QUERY_TIMEOUT_MS))
        eff = timeout_ms if timeout_ms is not None else conf_timeout
        if eff is not None and eff <= 0:
            eff = None
        token = CancelToken(query_id, timeout_ms=eff, poll_ms=poll_ms)
    _SCOPE.token = token
    with _ACTIVE_LOCK:
        _ACTIVE[query_id] = token
        _AMBIENT.append(token)
    return token


def finish_query(token: Optional[CancelToken]) -> None:
    """Close the scope opened by ``begin_query`` (no-op for joiners)."""
    _SCOPE.depth = max(0, _SCOPE.depth - 1)
    if token is None or _SCOPE.depth > 0:
        return
    _SCOPE.token = None
    with _ACTIVE_LOCK:
        if (token.query_id is not None
                and _ACTIVE.get(token.query_id) is token):
            del _ACTIVE[token.query_id]
        try:
            _AMBIENT.remove(token)
        except ValueError:
            pass


@contextlib.contextmanager
def bind(token: Optional[CancelToken]):
    """Run a block under a query's token on another thread than the one
    that opened the scope (the partition pump's tasks).  ``bind(None)``
    changes nothing.  Restores the thread's previous scope on exit."""
    prev_token, prev_depth = _SCOPE.token, _SCOPE.depth
    if token is not None:
        _SCOPE.token = token
        _SCOPE.depth = prev_depth + 1
    try:
        yield token
    finally:
        _SCOPE.token, _SCOPE.depth = prev_token, prev_depth


def current() -> Optional[CancelToken]:
    """The calling thread's query token: its own scope, or the sole open
    query's token when exactly one query runs.  None out of scope."""
    return _thread_token()


def bound() -> Optional[CancelToken]:
    """The token of the calling thread's own scope (opened or bound
    here), never the ambient one."""
    return _SCOPE.token


def check() -> None:
    """Raise ``QueryCancelled`` if the calling thread's query token
    fired.  Free outside a query scope."""
    tok = _thread_token()
    if tok is not None:
        tok.check()


def sleep(seconds: float) -> None:
    """Cancellable sleep under the calling thread's token; a plain sleep
    outside any query scope."""
    tok = _thread_token()
    if tok is not None:
        tok.sleep(seconds)
    else:
        time.sleep(seconds)


def cancel_query(query_id: int, reason: str = "user",
                 detail: str = "") -> bool:
    """Cancel one in-flight query by id (``session.cancel``).  False
    when no such query is active."""
    with _ACTIVE_LOCK:
        tok = _ACTIVE.get(query_id)
    if tok is None:
        return False
    return tok.cancel(reason, detail)


def get_token(query_id: int) -> Optional[CancelToken]:
    """The in-flight token for ``query_id`` (None when not active)."""
    with _ACTIVE_LOCK:
        return _ACTIVE.get(query_id)


def active_queries() -> List[int]:
    """Query ids with an open cancel scope, oldest first."""
    with _ACTIVE_LOCK:
        return sorted(_ACTIVE)


def reset() -> None:
    """Test hook: drop the calling thread's scope and the process-wide
    table of active tokens."""
    _SCOPE.token = None
    _SCOPE.depth = 0
    with _ACTIVE_LOCK:
        _ACTIVE.clear()
        del _AMBIENT[:]
