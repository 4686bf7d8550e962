"""The partition pump's task pool.

The counterpart of the JAX package's ``parallel/executor.py``, for now
only ``run_pump_tasks`` (the Spark-task-slot analog) with its registry
metrics: ``tpuq_pump_tasks_total``, ``tpuq_pump_task_seconds`` (per
task, semaphore wait included) and the ``tpuq_pump_queue_depth`` gauge
(tasks submitted and not yet completed, also ``inflight()``).  The rest
of that module — the per-process ``ExecutorContext`` of multi-executor
runs, with its rendezvous client and stage ids — comes with ROADMAP
A.10.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

_pump_lock = lockdep.tracked_lock("parallel.executor._pump_lock")
_pump_inflight = 0  # tasks submitted and not yet completed

_TM_PUMP_TASKS = TM.REGISTRY.counter(
    "tpuq_pump_tasks_total", "partition pump tasks completed")
_TM_PUMP_TASK_S = TM.REGISTRY.histogram(
    "tpuq_pump_task_seconds",
    "per-task pump execution time (incl. semaphore wait)")
TM.REGISTRY.gauge(
    "tpuq_pump_queue_depth",
    "pump tasks submitted but not yet completed",
    fn=lambda: _pump_inflight)


def inflight() -> int:
    """Pump tasks submitted and not yet completed, process-wide."""
    return _pump_inflight


def run_pump_tasks(fn: Callable, items: Sequence,
                   max_workers: int = 1) -> List:
    """Run ``fn`` over ``items`` preserving order — inline when a single
    worker suffices or there is a single item, else on a transient
    thread pool — with queue-depth and task-latency accounting either
    way.  An exception in a task reaches the caller, as
    ``ThreadPoolExecutor.map`` gives it; the tasks not yet started are
    cancelled."""
    global _pump_inflight
    items = list(items)
    if not items:
        return []
    started = [0]

    def timed(item):
        global _pump_inflight
        with _pump_lock:
            started[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(item)
        finally:
            _TM_PUMP_TASK_S.observe(time.perf_counter() - t0)
            _TM_PUMP_TASKS.inc()
            with _pump_lock:
                _pump_inflight -= 1

    with _pump_lock:
        _pump_inflight += len(items)
    try:
        if max_workers <= 1 or len(items) == 1:
            return [timed(i) for i in items]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(timed, items))
    finally:
        # tasks cancelled before starting (an earlier task raised) never
        # ran their own decrement: settle the gauge exactly
        with _pump_lock:
            _pump_inflight -= len(items) - started[0]
