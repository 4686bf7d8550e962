"""The per-process executor context, and the partition pump's task pool.

[REF: sql-plugin/../Plugin.scala :: RapidsExecutorPlugin — the
reference's executor plugin initializes the device runtime once per
executor JVM]

The counterpart of the JAX package's ``parallel/executor.py``.  One
``ExecutorContext`` per process, created by ``TpuSession`` when
``spark.rapids.executor.count > 1`` (``init_executor``):

* registers with the rendezvous coordinator under its heartbeat lease,
  then joins the **process group** through
  ``torch.distributed.init_process_group`` (the JAX package calls
  ``jax.distributed.initialize``): ``tcp://`` at
  ``spark.rapids.executor.coordinator.address``, world size the
  executor count, rank the executor id;
* picks the **transport** once, from the group's layout, and prints
  it: NCCL when the session asks for ``cuda`` without a card index and
  there are as many cards as executors (executor i takes ``cuda:i``);
  gloo otherwise — on the CPU, and when the processes share a card (a
  session pinned to ``cuda:<n>``, or fewer cards than executors: NCCL
  refuses two ranks on one card), where each exchange copies its cells
  to the host and back explicitly (``host_bytes`` counts them).  A
  failed NCCL setup raises; nothing falls back to gloo;
* holds the global **mesh**: each process contributes the same number
  of local ranks (its virtual ranks, ``parallel/mesh.py``, or one),
  process i owning ranks ``[i*L, (i+1)*L)``;
* assigns deterministic per-process stage ids: every executor plans
  the same query with the same deterministic planner, so the Nth
  exchange materialized in one process is the Nth in every process
  (the analog of Spark's driver-assigned shuffle ids).

``run_pump_tasks`` is the Spark-task-slot analog, with its registry
metrics: ``tpuq_pump_tasks_total``, ``tpuq_pump_task_seconds`` (per
task, semaphore wait included) and the ``tpuq_pump_queue_depth`` gauge
(tasks submitted and not yet completed, also ``inflight()``).
"""

from __future__ import annotations

import datetime
import itertools
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM


class Transport:
    """The process group's all_to_all of exchange cells: every leaf of
    a laid-out batch packed into one byte matrix, one
    ``all_to_all_single`` with equal splits (the cells' capacity is
    agreed at the rendezvous)."""

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        self.device = device
        # gloo moves host tensors: cells on a card go to the host and
        # back, explicitly
        self.host_staged = backend == "gloo" and device.type == "cuda"
        self.host_bytes = 0
        self.wire_bytes = 0

    def describe(self) -> str:
        return self.backend + (" (host-staged)" if self.host_staged
                               else "")

    def exchange_cells(self, laid, mesh, cap: int):
        """``laid``: this process's L ranks' ``[L, P, cap]`` cells
        (rank-major); returns the ``[L, P(sources), cap]`` cells
        received, sources in global rank order."""
        import torch.distributed as dist

        from spark_rapids_tpu_torch.parallel import shuffle as SH
        L = len(mesh.local_ranks())
        P = mesh.size
        nproc = P // L
        leaves = SH._leaves(laid)
        present = [x for x in leaves if x is not None]
        rows = present[0].shape[0]
        packs = [x.reshape(rows, -1).contiguous().view(torch.uint8)
                 for x in present]
        widths = [p.shape[1] for p in packs]
        rb = sum(widths)
        buf = torch.cat(packs, dim=1)
        del packs
        # (source, dest rank, cell) -> (dest process, dest rank, source)
        send = (buf.reshape(L, nproc, L, cap, rb).permute(1, 2, 0, 3, 4)
                .contiguous().reshape(-1))
        del buf
        if self.host_staged:
            send = send.cpu()
            self.host_bytes += 2 * send.numel()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        self.wire_bytes += send.numel()
        del send
        if self.host_staged:
            recv = recv.to(self.device)
        got = (recv.reshape(nproc, L, L, cap, rb).permute(1, 0, 2, 3, 4)
               .reshape(L * P * cap, rb))
        out, off, k = [], 0, 0
        for x in leaves:
            if x is None:
                out.append(None)
                continue
            w = widths[k]
            k += 1
            col = got[:, off:off + w].contiguous().view(x.dtype)
            out.append(col.reshape((L * P * cap,) + tuple(x.shape[1:])))
            off += w
        return SH._from_leaves(laid.schema, out)


class ExecutorContext:
    def __init__(self, process_id: int, num_processes: int,
                 coordinator_address: str, rendezvous_address: str,
                 timeout: float, heartbeat_s: float = 0.0,
                 device="cpu", local_ranks: Optional[int] = None):
        import torch.distributed as dist

        from spark_rapids_tpu_torch.parallel.mesh import Mesh, virtual_ranks
        from spark_rapids_tpu_torch.parallel.rendezvous import (
            RendezvousClient)
        # register under the coordinator's heartbeat lease BEFORE the
        # process-group handshake: a peer that dies mid-init is then
        # already visible to the reaper
        self.client = RendezvousClient(rendezvous_address, process_id,
                                       default_timeout=timeout)
        if heartbeat_s > 0:
            self.client.start_heartbeat(heartbeat_s)
        device = torch.device(device)
        if (device.type == "cuda" and device.index is None
                and torch.cuda.device_count() >= num_processes):
            # every executor takes the card of its id: NCCL
            backend = "nccl"
            device = torch.device("cuda", process_id)
            torch.cuda.set_device(device)
        else:
            # the CPU, or executors sharing one card (a session pinned
            # to a card, or fewer cards than executors): gloo
            backend = "gloo"
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=max(timeout, 30.0)))
        self.process_id = process_id
        self.num_processes = num_processes
        self.timeout = timeout
        self.device = device
        self.transport = Transport(backend, device)
        L = int(local_ranks or virtual_ranks() or 1)
        agreed = self.client.allgather("executor:init", L, timeout)
        if len(set(agreed)) != 1:
            raise ValueError(
                f"executors disagree on their local rank counts {agreed}: "
                "every process must hold the same number of ranks")
        self.mesh = Mesh([device if r // L == process_id else None
                          for r in range(num_processes * L)],
                         process_of=[r // L
                                     for r in range(num_processes * L)],
                         process_index=process_id)
        self._stage_counter = itertools.count()
        print(f"[executor {process_id}/{num_processes}] transport="
              f"{self.transport.describe()} device={device} ranks="
              f"{self.mesh.local_ranks()} of {self.mesh.size}",
              file=sys.stderr, flush=True)

    def next_stage_id(self) -> str:
        """Deterministic across processes (same planner, same order)."""
        return f"stage-{next(self._stage_counter)}"

    def local_partition_ids(self, mesh) -> List[int]:
        """Global mesh-partition indices this process owns."""
        return mesh.local_ranks()

    def shutdown(self) -> None:
        import torch.distributed as dist
        self.client.stop_heartbeat()
        if dist.is_initialized():
            dist.destroy_process_group()


_CTX: Optional[ExecutorContext] = None
_LOCK = lockdep.tracked_lock("parallel.executor._LOCK")


def rendezvous_timeout_s(conf) -> float:
    """Stage deadline in seconds: ``rendezvous.timeoutMs``, unless the
    legacy ``rendezvous.timeoutSec`` key was set explicitly (it wins)."""
    from spark_rapids_tpu_torch import conf as C
    legacy = conf.get_raw(C.RENDEZVOUS_TIMEOUT.key)
    if legacy is not None:
        return float(legacy)
    return float(conf.get(C.RENDEZVOUS_TIMEOUT_MS)) / 1000.0


def init_executor(conf, device="cpu") -> Optional[ExecutorContext]:
    """Create (or return) the process's executor context per conf.

    Idempotent; raises if a second session asks for a conflicting
    topology (a process joins one process group)."""
    from spark_rapids_tpu_torch import conf as C
    global _CTX
    count = int(conf.get(C.EXECUTOR_COUNT))
    if count <= 1:
        return None
    coord = str(conf.get(C.COORDINATOR_ADDRESS)).strip()
    rdv = str(conf.get(C.RENDEZVOUS_ADDRESS)).strip()
    if not coord or not rdv:
        raise ValueError(
            "executor.count > 1 requires both "
            "spark.rapids.executor.coordinator.address and "
            "spark.rapids.shuffle.rendezvous.address")
    if conf.shuffle_mode != "ICI":
        raise ValueError(
            "multi-executor mode requires spark.rapids.shuffle.mode=ICI "
            f"(got {conf.shuffle_mode})")
    pid = int(conf.get(C.EXECUTOR_ID))
    timeout = rendezvous_timeout_s(conf)
    heartbeat_s = float(conf.get(C.RENDEZVOUS_HEARTBEAT_MS)) / 1000.0
    with _LOCK:
        if _CTX is not None:
            if (_CTX.process_id, _CTX.num_processes) != (pid, count):
                raise ValueError(
                    "executor context already initialized as "
                    f"({_CTX.process_id}/{_CTX.num_processes}); cannot "
                    f"re-initialize as ({pid}/{count})")
            _CTX.timeout = timeout
            _CTX.client.default_timeout = timeout
            return _CTX
        _CTX = ExecutorContext(pid, count, coord, rdv, timeout,
                               heartbeat_s, device=device)
        return _CTX


def get_executor() -> Optional[ExecutorContext]:
    return _CTX

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
