"""The partition pump's task pool.

The counterpart of the JAX package's ``parallel/executor.py``, for now
only ``run_pump_tasks`` (the Spark-task-slot analog).  The rest of that
module — the per-process ``ExecutorContext`` of multi-executor runs,
with its rendezvous client and stage ids — comes with ROADMAP A.10, and
the pump's registry metrics (tasks, task seconds, the queue-depth
gauge) with A.9; the in-flight count is a module integer here
(``inflight``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from spark_rapids_tpu_torch.runtime import lockdep

_pump_lock = lockdep.tracked_lock("parallel.executor._pump_lock")
_pump_inflight = 0  # tasks submitted and not yet completed


def inflight() -> int:
    """Pump tasks submitted and not yet completed, process-wide."""
    return _pump_inflight


def run_pump_tasks(fn: Callable, items: Sequence,
                   max_workers: int = 1) -> List:
    """Run ``fn`` over ``items`` preserving order — inline when a single
    worker suffices or there is a single item, else on a transient
    thread pool.  An exception in a task reaches the caller, as
    ``ThreadPoolExecutor.map`` gives it; the tasks not yet started are
    cancelled."""
    global _pump_inflight
    items = list(items)
    if not items:
        return []
    started = [0]

    def counted(item):
        global _pump_inflight
        with _pump_lock:
            started[0] += 1
        try:
            return fn(item)
        finally:
            with _pump_lock:
                _pump_inflight -= 1

    with _pump_lock:
        _pump_inflight += len(items)
    try:
        if max_workers <= 1 or len(items) == 1:
            return [counted(i) for i in items]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(counted, items))
    finally:
        # tasks cancelled before starting (an earlier task raised) never
        # ran their own decrement
        with _pump_lock:
            _pump_inflight -= len(items) - started[0]
