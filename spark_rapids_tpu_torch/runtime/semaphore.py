"""Device-admission semaphore — the ``GpuSemaphore`` analog.

The counterpart of the JAX package's ``runtime/semaphore.py``.
[REF: sql-plugin/../GpuSemaphore.scala :: GpuSemaphore] — the reference
gates how many Spark task threads may hold the GPU at once
(``spark.rapids.sql.concurrentGpuTasks``) so that device working sets
do not multiply by the executor's task slots.  Here the DataFrame's
partition pump runs partitions on a task pool
(``parallel/executor.py::run_pump_tasks``), and each task holds a permit
(``runtime/scheduler.py::device_hold``).  Time spent blocked is the
``semaphoreWaitTime`` metric.

One process-wide semaphore lives for the process (never swapped:
swapping under a waiter would let two queries admit through different
instances and break the cap); a conf with a different permit count
resizes it in place under its own condition variable.

A waiter of a query polls its cancel token (``runtime/cancel.py``):
it registers the condition variable with the token, so that a cancel
or a deadline wakes it at once, parks at most the token's wait
interval, and raises ``QueryCancelled`` without being admitted.
Without a token every wait parks at most 0.1 s and re-checks, as the
JAX package's does.

The registry's ``tpuq_semaphore_*`` counters, histogram and gauges are
the JAX package's; a blocked acquire (and only a blocked one) opens a
``DeviceSemaphore:semaphoreWait`` span, so that the wait lands in the
``semaphore_wait`` bucket of the attribution ledger.

Not ported yet: the preempt path (``preempt_pending``, the per-thread
permit stack the suspend provider walks) comes with ROADMAP A.11.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Optional

from spark_rapids_tpu_torch.runtime import cancel, lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.runtime import trace

_TM_WAIT = TM.REGISTRY.counter(
    "tpuq_semaphore_wait_seconds_total",
    "seconds tasks spent blocked on device admission (cumulative)")
_TM_ACQUIRE = TM.REGISTRY.histogram(
    "tpuq_semaphore_acquire_seconds",
    "per-acquire device-admission wait")


class DeviceSemaphore:
    """Counting semaphore with in-place resize and wait accounting.

    Per-query stats are keyed by query id (``begin_query_stats`` /
    ``end_query_stats``): each open window tracks the high-water holder
    count seen while that query was in flight and the wait its own
    tasks spent blocked.  ``max_holders`` / ``wait_time`` are the serial
    view, restarted at each query boundary; ``peak_holders`` is the
    process-lifetime high-water mark.
    """

    # open per-query windows beyond this evict oldest-first (a window
    # whose query died without end_query_stats must not leak forever)
    QUERY_WINDOW_CAP = 256
    # the longest one wait parks before it re-checks
    WAIT_S = 0.1

    def __init__(self, permits: int):
        self._cv = lockdep.tracked_condition(
            "runtime.semaphore.DeviceSemaphore._cv")
        self.permits = max(1, int(permits))
        self.holders = 0          # currently admitted tasks
        self.waiting = 0          # tasks currently blocked in acquire
        self.max_holders = 0      # high-water mark (query window)
        self.wait_time = 0.0      # seconds blocked (query window)
        self.peak_holders = 0     # high-water mark (process lifetime)
        # query_id -> {"max_holders": int, "wait_time": float}
        self._windows: "OrderedDict[int, dict]" = OrderedDict()

    def resize(self, permits: int) -> None:
        with self._cv:
            self.permits = max(1, int(permits))
            self._cv.notify_all()

    def acquire(self, query_id: Optional[int] = None) -> float:
        """Block until admitted; returns the seconds spent waiting (0.0
        on the uncontended path).  Only time blocked in the condition
        wait counts, on the monotonic clock.  ``query_id`` names the
        window the wait is charged to (by default the calling thread's
        query).  A cancel or deadline of that query raises
        ``QueryCancelled`` from the wait, unadmitted."""
        tok = cancel.current()
        if query_id is None and tok is not None:
            query_id = tok.query_id
        waited = 0.0
        blocked = False
        registered = False
        wait_tr = wait_span = None
        try:
            with self._cv:
                try:
                    while self.holders >= self.permits:
                        if not blocked:
                            blocked = True
                            self.waiting += 1
                            # the blocked path (and only it) opens a span,
                            # so that the wait lands in semaphore_wait
                            wait_tr = trace.current()
                            if wait_tr is not None:
                                wait_span = wait_tr.begin(
                                    "DeviceSemaphore", "semaphoreWait")
                        if tok is not None:
                            tok.check()
                            if not registered:
                                tok.add_waiter(self._cv)
                                registered = True
                            timeout = tok.wait_interval()
                        else:
                            timeout = self.WAIT_S
                        t0 = time.monotonic()
                        self._cv.wait(timeout=timeout)
                        waited += time.monotonic() - t0
                finally:
                    if blocked:
                        self.waiting -= 1
                    if wait_span is not None:
                        wait_tr.end(wait_span)
                self.holders += 1
                self.max_holders = max(self.max_holders, self.holders)
                self.peak_holders = max(self.peak_holders, self.holders)
                self.wait_time += waited
                for w in self._windows.values():
                    if self.holders > w["max_holders"]:
                        w["max_holders"] = self.holders
                if waited and query_id is not None:
                    w = self._windows.get(query_id)
                    if w is not None:
                        w["wait_time"] += waited
        finally:
            if registered:
                tok.remove_waiter(self._cv)
            if waited:
                _TM_WAIT.inc(waited)
            _TM_ACQUIRE.observe(waited)
        return waited

    def release(self) -> None:
        with self._cv:
            self.holders -= 1
            self._cv.notify()

    @contextlib.contextmanager
    def hold(self, waited_out: Optional[list] = None,
             query_id: Optional[int] = None):
        w = self.acquire(query_id)
        if waited_out is not None:
            waited_out.append(w)
        try:
            yield self
        finally:
            self.release()

    def begin_query_stats(self, query_id: Optional[int]) -> None:
        """Open a per-query window keyed by ``query_id`` and restart the
        serial window: the high-water mark restarts from the holders
        still admitted, the wait clock from zero."""
        with self._cv:
            self.max_holders = self.holders
            self.wait_time = 0.0
            if query_id is not None:
                self._windows[query_id] = {"max_holders": self.holders,
                                           "wait_time": 0.0}
                while len(self._windows) > self.QUERY_WINDOW_CAP:
                    self._windows.popitem(last=False)

    def end_query_stats(self, query_id: Optional[int]) -> Optional[dict]:
        """Close a keyed window and return its stats (None when no
        window is open for that id)."""
        if query_id is None:
            return None
        with self._cv:
            return self._windows.pop(query_id, None)

    def query_stats(self, query_id: int) -> Optional[dict]:
        """Peek an open keyed window without closing it."""
        with self._cv:
            w = self._windows.get(query_id)
            return dict(w) if w is not None else None

    def reset_query_stats(self) -> None:
        """Serial-query boundary: restart the un-keyed window only."""
        self.begin_query_stats(None)


_semaphore: Optional[DeviceSemaphore] = None
_sem_lock = lockdep.tracked_lock("runtime.semaphore._sem_lock")


def get_semaphore(conf=None) -> DeviceSemaphore:
    """The process semaphore, sized by
    ``spark.rapids.sql.concurrentGpuTasks`` (resized in place when a
    session asks for a different count)."""
    global _semaphore
    permits = None
    if conf is not None:
        from spark_rapids_tpu_torch import conf as C
        permits = conf.get(C.CONCURRENT_TASKS)
    with _sem_lock:
        if _semaphore is None:
            _semaphore = DeviceSemaphore(permits or 2)
        elif permits is not None and permits != _semaphore.permits:
            _semaphore.resize(permits)
        return _semaphore


def peek_semaphore() -> Optional[DeviceSemaphore]:
    """The process semaphore if one exists — never creates."""
    return _semaphore


def reset_semaphore() -> None:
    global _semaphore
    with _sem_lock:
        _semaphore = None


TM.REGISTRY.gauge(
    "tpuq_semaphore_holders", "tasks currently holding a permit",
    fn=lambda: _semaphore.holders if _semaphore is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_semaphore_waiting",
    "tasks currently blocked waiting for a permit (the admission "
    "controller's saturation signal)",
    fn=lambda: _semaphore.waiting if _semaphore is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_semaphore_holders_peak",
    "process-lifetime peak concurrent holders",
    fn=lambda: _semaphore.peak_holders if _semaphore is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_semaphore_permits", "configured concurrent-task permits",
    fn=lambda: _semaphore.permits if _semaphore is not None else 0)
