"""ICI shuffle exchange exec: the distributed stage boundary.

[REF: GpuShuffleExchangeExecBase.scala + RapidsShuffleManager (UCX mode)]

The counterpart of the JAX package's ``exec/distributed.py``: instead of
reduce tasks pulling blocks point-to-point, the exchange runs ONE
collective exchange over the rank mesh (``parallel/mesh.py``,
``parallel/shuffle.py``) and the downstream operators consume their
partition's received rows locally, like Spark reduce tasks after a
shuffle fetch.  Stage shape on a D-rank mesh (the COMPILED exchange, the
single-process default):

  upstream partitions -> compact -> stacked per device group of ranks
    -> {murmur3 pid -> rank -> gather index table + counts}   (prepare)
    -> {clip-gather of cap cells -> all_to_all -> recv mask}   (boundary)
    -> D output partitions (compacted, sized from the host counts)

The *prepare* program emits the routing tables and the per-partition
counts together; the counts come to the host in one read, and the
*boundary* program is the only work on the stage seam.  On one device
(the virtual ranks of one card, or the CPU in tests) the all_to_all is
a transpose of the cells; across devices of one process the cells are
copied between them.  torch has no buffer donation:
``spark.rapids.tpu.exchange.donate`` drops the exchange's references to
its laid-out input as soon as the boundary has gathered from it.

Multi-executor mode (``executor.count > 1``) keeps the JAX package's
two-phase count/shuffle protocol inside ``run_stage_epochs``: shape
agreement, the counts allgather (which also merges the cluster-wide
partition counts into the stats plane), an entry barrier, then the
cells ride the process group's ``all_to_all_single``
(``parallel/executor.py::Transport``).  A transient rendezvous fault
re-runs the agreement at the next epoch over the same accumulated input
(bit-identical recovery); a dead peer raises a peer-tagged
``TerminalDeviceError('peer_loss')`` on every survivor.

``spark.rapids.tpu.exchange.mode=host`` routes the exchange through the
host-shuffle transport at plan time (``ici_active`` is then off), which
is also the degrade target of the ``collective`` failure domain: on
retry exhaustion a single-process collective re-executes its child
through ``TpuHostShuffleExchangeExec``, counted as a degraded op.

Activated by ``spark.rapids.shuffle.mode=ICI`` when the mesh has more
than one rank; the planner then splits aggregates into partial/final
around this exchange, co-partitions join inputs through it, sorts
behind ``TpuIciRangeExchangeExec`` and runs windows per partition.
Timers: ``partitionTime`` (stacking, prepare and its host read; not the
upstream pump, which its own operators time) and ``collectiveTime``
(the boundary); registry counters
``tpuq_ici_collective_seconds_total``, ``tpuq_ici_exchange_bytes_total``
and ``tpuq_ici_exchange_collective_seconds_total``.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, round_up_pow2, slice_batch)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.parallel import shuffle as SH
from spark_rapids_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_count
from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import stats as ST
from spark_rapids_tpu_torch.runtime import telemetry as TM

_TM_COLLECTIVE_S = TM.REGISTRY.counter(
    "tpuq_ici_collective_seconds_total",
    "ICI all-to-all collective dispatch seconds")
_TM_ICI_BYTES = TM.REGISTRY.counter(
    "tpuq_ici_exchange_bytes_total",
    "bytes moved through ICI shuffle exchanges (global batch size)")
_TM_ICI_EX_COLL_S = TM.REGISTRY.counter(
    "tpuq_ici_exchange_collective_seconds_total",
    "compiled-exchange boundary-program dispatch seconds")


def exchange_opts(conf) -> dict:
    """Conf-derived ICI-exchange constructor kwargs — every plan-time
    construction site passes these through."""
    return {"donate": bool(conf.get(C.EXCHANGE_DONATE))}


def ici_active(conf, device) -> bool:
    """ICI shuffle requested, the mesh has more than one rank, and the
    exchange is not conf-pinned to the host transport
    (``exchange.mode=host`` keeps ICI planning off entirely)."""
    if conf.shuffle_mode != "ICI":
        return False
    if conf.exchange_mode == "host":
        return False
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    ctx = get_executor()
    if ctx is not None:
        return ctx.mesh.size > 1
    return rank_count(device) > 1


def hashable_on_device(dt: T.DataType) -> bool:
    from spark_rapids_tpu_torch.plan.overrides import is_device_supported_type
    return is_device_supported_type(dt) is None


def owned_partitions(plan) -> List[int]:
    """Partitions an executor process serves of ``plan``: descend the
    partition-preserving spine to the nearest ICI exchange and take its
    local partitions; plans without an exchange serve every partition
    (executor-sliced scans make non-owned ones empty)."""
    node = plan
    while True:
        if isinstance(node, TpuIciShuffleExchangeExec):
            return node.local_partitions()
        if (node.children and node.num_partitions()
                == node.children[0].num_partitions()):
            node = node.children[0]
            continue
        return list(range(plan.num_partitions()))


def _accumulate_shards(child: TpuExec, d: int, partitions=None):
    """Stream child partitions onto ``d`` ranks round-robin (by
    enumeration index: owned partition ids can share a factor with d),
    each batch compacted and cut to its live rows' bucket.  Returns
    (per-rank [(batch, rows)], per-rank rows, per-column widths, validity
    presence, element-validity presence)."""
    schema = child.schema
    nc = len(schema.fields)
    parts: List[List[Tuple[DeviceBatch, int]]] = [[] for _ in range(d)]
    rows = [0] * d
    widths = [0] * nc
    has_val = [False] * nc
    has_eval = [False] * nc
    if partitions is None:
        partitions = range(child.num_partitions())
    for i, p in enumerate(partitions):
        r = i % d
        for b in child.execute(p):
            cb = compact(b)
            n = cb.num_rows_host()
            if n == 0:
                continue
            cap = round_up_pow2(n, 8)
            if cap < cb.capacity:
                cb = slice_batch(cb, 0, cap)
            for ci, c in enumerate(cb.columns):
                if c.is_string or c.is_array:
                    widths[ci] = max(widths[ci], int(c.data.shape[1]))
                has_val[ci] |= c.validity is not None
                has_eval[ci] |= c.evalid is not None
            parts[r].append((cb, n))
            rows[r] += n
    return parts, rows, widths, has_val, has_eval


def _stack_group(schema: T.StructType,
                 per_rank: List[List[Tuple[DeviceBatch, int]]],
                 local_b: int, widths, has_val, has_eval,
                 device: torch.device) -> DeviceBatch:
    """One group's stacked stage input: rank j's live rows at
    ``[j * local_b, j * local_b + rows_j)``, every rank padded to
    ``local_b`` with dead rows.  String/array widths and validity
    presence are the stage's (agreed across executors), so that every
    rank's shard has one layout."""
    from spark_rapids_tpu_torch.columnar.column import torch_dtype
    from spark_rapids_tpu_torch.ops.decimal128 import is128
    g = len(per_rank)
    total = g * local_b
    cols = []
    for ci, f in enumerate(schema.fields):
        ragged = isinstance(f.dtype, (T.StringType, T.BinaryType,
                                      T.ArrayType))
        if ragged:
            w = max(widths[ci], 1 if isinstance(f.dtype, T.ArrayType)
                    else 8)
            dt = (torch.uint8 if not isinstance(f.dtype, T.ArrayType)
                  else torch_dtype(f.dtype))
            data = torch.zeros((total, w), dtype=dt, device=device)
        elif is128(f.dtype):
            data = torch.zeros((total, 2), dtype=torch.int64, device=device)
        else:
            data = torch.zeros((total,), dtype=torch_dtype(f.dtype),
                               device=device)
        validity = (torch.zeros((total,), dtype=torch.bool, device=device)
                    if has_val[ci] else None)
        lengths = (torch.zeros((total,), dtype=torch.int32, device=device)
                   if ragged else None)
        evalid = (torch.ones(tuple(data.shape), dtype=torch.bool,
                             device=device)
                  if has_eval[ci] else None)
        for j, batches in enumerate(per_rank):
            at = j * local_b
            for b, n in batches:
                c = b.columns[ci]
                x = c.data[:n].to(device)
                if ragged:
                    data[at:at + n, :x.shape[1]] = x
                    lengths[at:at + n] = c.lengths[:n].to(device)
                    if evalid is not None and c.evalid is not None:
                        evalid[at:at + n, :x.shape[1]] = \
                            c.evalid[:n].to(device)
                else:
                    data[at:at + n] = x
                if validity is not None:
                    validity[at:at + n] = (
                        c.validity[:n].to(device) if c.validity is not None
                        else True)
                at += n
        cols.append(DeviceColumn(f.dtype, data, validity, lengths, evalid))
    rows = torch.tensor([sum(n for _, n in batches) for batches in per_rank],
                        dtype=torch.int64).to(device)
    sel = (torch.arange(local_b, device=device)[None, :]
           < rows[:, None]).reshape(-1)
    return DeviceBatch(schema, tuple(cols), sel)


def _stage_fingerprint(node, schema) -> str:
    """A structural key of a stage that every executor computes alike:
    stage ids are plan-conversion-ordered, so executors running
    different queries (or the same ones in another order) must fail
    loudly, not cross-match allgathers."""
    from spark_rapids_tpu_torch.runtime.kernel_cache import fingerprint
    return repr(node._base_key(schema)) + repr(fingerprint(schema))


class TpuIciShuffleExchangeExec(TpuExec):
    """Collective shuffle exchange over the rank mesh.

    ``num_partitions() == mesh size``; ``execute(p)`` yields the rows
    that hashed to partition p, on rank p's device."""

    def __init__(self, child: TpuExec, keys: Sequence[Expression],
                 mesh: Optional[Mesh] = None,
                 canon_int64: Sequence[bool] = (),
                 min_bucket: int = 1024, donate: bool = True,
                 device=None):
        super().__init__(child.schema, child)
        self.keys = list(keys)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.canon_int64 = tuple(canon_int64)
        self.min_bucket = min_bucket
        self.donate = donate
        self._received: Optional[SH.Received] = None
        self._empty = False
        # set when the collective degraded to the host-shuffle transport
        self._host_fallback = None
        self._kept_input = None
        # the live rows this process fed into the exchange
        self.input_rows = 0
        self._mat_lock = lockdep.tracked_lock(
            "exec.distributed.TpuIciShuffleExchangeExec._mat_lock")
        # multi-executor mode: rendezvous-coordinated collective entry.
        # Stage ids are assigned at plan-conversion time — every process
        # plans the same query with the same deterministic planner, so
        # the Nth exchange here is the Nth exchange everywhere
        from spark_rapids_tpu_torch.parallel.executor import get_executor
        self._ctx = get_executor()
        self._stage = (self._ctx.next_stage_id()
                       if self._ctx is not None else None)
        self._epoch = 0

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.mesh.local_ranks()[0]]

    def local_partitions(self) -> List[int]:
        """Partition ids this process can serve (all, single-process)."""
        if self._ctx is None:
            return list(range(self.nparts))
        return self._ctx.local_partition_ids(self.mesh)

    @property
    def nparts(self) -> int:
        return self.mesh.size

    def node_string(self):
        ks = ", ".join(str(k) for k in self.keys)
        return f"TpuIciShuffleExchange [hash({ks}) over {self.nparts}dev]"

    def num_partitions(self) -> int:
        return self.nparts

    def _materialize(self) -> Optional[SH.Received]:
        with self._mat_lock:
            return self._materialize_locked()

    def _materialize_locked(self) -> Optional[SH.Received]:
        if (self._received is not None or self._empty
                or self._host_fallback is not None):
            return self._received
        if self._ctx is not None:
            return self._materialize_multiproc()
        from spark_rapids_tpu_torch.plan.overrides import (
            _estimated_row_bytes)
        from spark_rapids_tpu_torch.runtime.memory import get_manager
        d = self.nparts
        schema = self.children[0].schema
        # the upstream pump stays outside partitionTime: its operators
        # time themselves, and this timer is the exchange's own cost
        parts, rows, widths, has_val, has_eval = _accumulate_shards(
            self.children[0], d)
        self.input_rows = sum(rows)
        if sum(rows) == 0:
            self._empty = True
            return None
        # uniform per-rank shard capacity (one layout for every rank)
        local_b = round_up_pow2(max(rows), self.min_bucket)
        row_bytes = _estimated_row_bytes(
            schema, str_width=max(widths, default=0))
        groups = self.mesh.groups()
        # the arbiter budget models ONE device: account the largest
        # group's working set (its ranks share the device)
        g_max = max(len(r) for _, r in groups)
        mgr = get_manager()
        with mgr.transient(2 * g_max * local_b * row_bytes):
            with self.timer("partitionTime"):
                stacked = [_stack_group(schema, [parts[r] for r in ranks],
                                        local_b, widths, has_val, has_eval,
                                        dev)
                           for dev, ranks in groups]
                del parts
                sharded = SH.ShardedBatch(self.mesh, local_b, stacked)
                del stacked
            aux = self._aux_args(sharded)
            # the compiled exchange: ONE producer-side prepare (routing
            # tables + counts together), then the boundary on the seam
            with mgr.transient(8 * g_max * d * local_b):  # index tables
                with self.timer("partitionTime"):
                    idx, counts = self._prepare_program()(sharded, *aux)
                    counts_np = torch.cat(
                        [c.to("cpu") for c in counts]).numpy() \
                        .astype(np.int64)                  # one read
                    cap = SH.exchange_cap(counts_np.max(), local_b)
                st = ST.current()
                if st is not None:
                    # rows per source rank x partition: summed over the
                    # sources, the partition sizes
                    st.record_partitions(self, counts_np.sum(axis=0),
                                         unit="rows")
                # the received rows: one bucket per partition
                with mgr.transient(2 * sum(rows) * row_bytes):
                    nbytes = sharded.nbytes()
                    inputs = {"sharded": sharded, "idx": idx}
                    if not self.donate:
                        self._kept_input = inputs.copy()
                    del sharded, idx
                    t0 = time.perf_counter()
                    with self.timer("collectiveTime"):
                        boundary = SH.build_boundary_program(
                            self.mesh, d, cap, donate=self.donate)
                        self._received = self._run_collective(
                            lambda: boundary(inputs, counts_np))
                    dt = time.perf_counter() - t0
                    _TM_COLLECTIVE_S.inc(dt)
                    _TM_ICI_EX_COLL_S.inc(dt)
                    _TM_ICI_BYTES.inc(nbytes)
        return self._received

    # -- resilience: the ``collective`` failure domain ----------------------
    def _run_collective(self, fn):
        """Dispatch the exchange through the ``collective`` failure
        domain.  Single-process retry exhaustion degrades to the
        host-path shuffle transport over the same child; multi-executor
        collectives fail together with a domain-tagged error — one
        process degrading alone would deadlock the others at the
        rendezvous."""
        from spark_rapids_tpu_torch.runtime import resilience as R

        def attempt():
            R.INJECTOR.on("collective")
            return fn()

        out = R.run_guarded("collective", attempt, op=self.node_string(),
                            degrade=self._host_degrade_fn())
        if self._host_fallback is not None:
            return None
        return out

    def _host_degrade_fn(self):
        """The degradation callable, or None when this exchange cannot
        degrade (multi-executor; the RANGE exchange, whose total-order
        contract a hash shuffle would break)."""
        if self._ctx is not None:
            return None

        def degrade():
            from spark_rapids_tpu_torch.shuffle.exchange import (
                TpuHostShuffleExchangeExec)
            self._host_fallback = TpuHostShuffleExchangeExec(
                self.children[0], self.nparts, self.keys, self.device,
                min_bucket=self.min_bucket)
            return None

        return degrade

    # -- pid-program hooks (overridden by the RANGE exchange) ---------------
    def _base_key(self, schema) -> tuple:
        return (self.nparts, self.canon_int64,
                tuple(str(k) for k in self.keys))

    def _aux_args(self, sharded) -> tuple:
        """Extra arguments of the count/shuffle/prepare programs."""
        return ()

    def _prepare_program(self):
        return SH.build_prepare_program(self.mesh, self.keys, self.nparts,
                                        self.canon_int64)

    def _count_program(self):
        return SH.build_count_program(self.mesh, self.keys, self.nparts,
                                      self.canon_int64)

    def _shuffle_program(self, cap: int):
        return SH.build_shuffle_program(
            self.mesh, self.keys, self.nparts, cap, self.canon_int64,
            transport=self._ctx.transport)

    def _materialize_multiproc(self) -> Optional[SH.Received]:
        """Rendezvous-coordinated collective shuffle across executor
        processes [REF: RapidsShuffleInternalManagerBase].

        1. accumulate this process's upstream slice onto its local
           ranks;
        2. rendezvous ``:shape`` allgather — shard capacity, widths and
           validity presence agreed globally (every process's cells
           must line up on the wire);
        3. per-rank partition counts, rendezvous ``:counts`` allgather
           -> the global cell capacity, and the cluster-wide partition
           counts into the stats plane;
        4. ``:enter`` barrier, then the layout and the process group's
           all_to_all.  Any rendezvous deadline failure raises in EVERY
           process (fail-together).

        Steps 2-4 run inside ``run_stage_epochs``."""
        from spark_rapids_tpu_torch.parallel.rendezvous import (
            run_stage_epochs)
        from spark_rapids_tpu_torch.plan.overrides import (
            _estimated_row_bytes)
        from spark_rapids_tpu_torch.runtime.memory import get_manager
        ctx = self._ctx
        timeout = ctx.timeout
        d = self.nparts
        local_ids = ctx.local_partition_ids(self.mesh)
        (dev, ranks), = self.mesh.groups()
        schema = self.children[0].schema
        # only the child partitions THIS process owns: executor-sliced
        # scans make the rest empty anyway (the pump outside
        # partitionTime, as in the single-process path)
        parts, rows, widths0, has_val0, has_eval0 = _accumulate_shards(
            self.children[0], len(local_ids),
            partitions=owned_partitions(self.children[0]))
        self.input_rows = sum(rows)
        fp = _stage_fingerprint(self, schema)
        payload = {"rows": max(rows) if rows else 0,
                   "total": sum(rows), "widths": widths0,
                   "has_val": has_val0, "has_eval": has_eval0, "fp": fp}
        mgr = get_manager()

        def attempt(epoch: int):
            # a retried epoch re-agrees EVERYTHING that rode the
            # rendezvous (range bounds included)
            self._epoch = epoch
            self._reset_aux()
            replies = ctx.client.allgather(self._stage + ":shape",
                                           payload, timeout, epoch=epoch)
            if any(r["fp"] != fp for r in replies):
                raise RuntimeError(
                    f"rendezvous stage {self._stage} mismatch across "
                    "executors (different queries or different order) — "
                    "every executor process must run the same queries "
                    "in the same order")
            if sum(r["total"] for r in replies) == 0:
                return None
            local_b = round_up_pow2(max(max(r["rows"] for r in replies), 1),
                                    self.min_bucket)
            widths = [max(ws) for ws in zip(*[r["widths"] for r in replies])]
            has_val = [any(v) for v in zip(*[r["has_val"] for r in replies])]
            has_eval = [any(v) for v in
                        zip(*[r["has_eval"] for r in replies])]
            row_bytes = _estimated_row_bytes(
                schema, str_width=max(widths, default=0))
            with mgr.transient(2 * len(local_ids) * local_b * row_bytes):
                with self.timer("partitionTime"):
                    sharded = SH.ShardedBatch(self.mesh, local_b, [
                        _stack_group(schema, parts, local_b, widths,
                                     has_val, has_eval, dev)])
                aux = self._aux_args(sharded)
                with self.timer("partitionTime"):
                    counts = self._count_program()(sharded, *aux) \
                        .to("cpu").numpy()
                local_max = int(counts.max())
                replies = ctx.client.allgather(
                    self._stage + ":counts",
                    {"max": local_max,
                     "parts": counts.sum(axis=0).tolist()},
                    timeout, epoch=epoch)
                cap = round_up_pow2(max(max(r["max"] for r in replies), 1),
                                    8)
                st = ST.current()
                if st is not None:
                    # every process (the coordinator's view) merges the
                    # replies into the CLUSTER-WIDE partition sizes
                    st.record_partitions(
                        self, ST.merge_partition_counts(
                            r["parts"] for r in replies),
                        unit="rows", executors=len(replies))
                with mgr.transient(2 * d * cap * len(local_ids)
                                   * row_bytes):
                    ctx.client.barrier(self._stage + ":enter", timeout,
                                       epoch=epoch)
                    t0 = time.perf_counter()
                    with self.timer("collectiveTime"):
                        fn = self._shuffle_program(cap)
                        got = self._run_collective(
                            lambda: fn(sharded, *aux))
                    _TM_COLLECTIVE_S.inc(time.perf_counter() - t0)
                    _TM_ICI_BYTES.inc(sharded.nbytes())
            return got[0], cap

        out = run_stage_epochs(ctx.client, self._stage, attempt)
        del parts
        if out is None:
            self._empty = True
            return None
        got, cap = out
        blocks = {r: slice_batch(got, j * d * cap, d * cap)
                  for j, r in enumerate(local_ids)}
        self._received = SH.Received(blocks, None)
        return self._received

    def _reset_aux(self) -> None:
        """Forget data-dependent program arguments (a retried epoch)."""

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        received = self._materialize()
        if self._host_fallback is not None:
            # collective degraded: serve this partition through the
            # host-shuffle transport (same hash, same row set)
            yield from self._host_fallback.execute(partition)
            return
        if received is None:
            return
        block = received.blocks.get(partition)
        if block is None:
            raise RuntimeError(
                f"partition {partition} is not local to this process "
                "(a multi-executor pump must only pull owned partitions)")
        block = compact(block)
        if received.counts is not None:
            # compiled path: the receive count is already on the host
            # (prepare's counts), so the handoff costs no device sync
            n = received.counts[partition]
        else:
            n = block.num_rows_host()
        cap = round_up_pow2(max(n, 1), self.min_bucket)
        if cap < block.capacity:
            block = slice_batch(block, 0, cap)
        self.metric("numOutputRows").add(n)
        self.metric("numOutputBatches").add(1)
        yield block


class TpuIciRangeExchangeExec(TpuIciShuffleExchangeExec):
    """RANGE-partitioned collective exchange [REF:
    GpuRangePartitioning.scala + GpuShuffleExchangeExecBase]: sampled
    order-key boundaries (agreed across executor processes via a
    rendezvous allgather) route each row to the partition owning its key
    range, so partition p's received rows all order before partition
    p+1's — a local per-partition sort then yields a TOTAL order."""

    def __init__(self, child: TpuExec, orders, mesh=None,
                 donate: bool = True, device=None):
        # keys only drive fingerprints; pids come from orders
        super().__init__(child, [o.expr for o in orders], mesh=mesh,
                         donate=donate, device=device)
        self.orders = list(orders)
        self._bounds: Optional[List[torch.Tensor]] = None

    def node_string(self):
        ks = ", ".join(str(o.expr) for o in self.orders)
        return f"TpuIciRangeExchange [range({ks}) over {self.nparts}dev]"

    def _base_key(self, schema) -> tuple:
        return ("range", self.nparts, tuple(str(o) for o in self.orders))

    def _host_degrade_fn(self):
        # the host transport hash-partitions; range partitions carry a
        # total-order contract a hash shuffle would silently break
        return None

    def _reset_aux(self) -> None:
        self._bounds = None

    def _sample_bounds(self, sharded) -> List[torch.Tensor]:
        """Per-limb boundary tensors (``nparts - 1`` rows): up to 256
        live rows of every local rank's shard, (multiproc: allgathered
        so that every process derives IDENTICAL boundaries), lexsorted
        on the host, quantiles picked."""
        from spark_rapids_tpu_torch.exec.sort import (
            _encode_key_limbs, pick_quantile_boundaries)
        samples = []
        ranks = [r for _, rs in self.mesh.groups() for r in rs]
        lives = torch.stack([sharded.shard(r).sel.sum() for r in ranks]
                            ).tolist()                  # one read
        for r, live in zip(ranks, lives):
            k = min(sharded.local_b, 256, int(live))
            if k == 0:
                continue
            shard = sharded.shard(r)
            # the shard's live rows are a prefix (stacked compacted)
            limbs = _encode_key_limbs(slice_batch(shard, 0, k), self.orders)
            samples.append([l.to("cpu") for l in limbs])
        if not samples:
            shard = sharded.shard(ranks[0])
            nlimbs = len(_encode_key_limbs(slice_batch(shard, 0, 8),
                                           self.orders))
            samples.append([torch.zeros(0, dtype=torch.int64)
                            for _ in range(nlimbs)])
        limbs = [torch.cat([s[i] for s in samples])
                 for i in range(len(samples[0]))]
        # int64 limbs hold unsigned bit patterns: the host orders them as
        # u64 (float64 limbs order as they are)
        cols = [l.numpy().view(np.uint64) if l.dtype == torch.int64
                else l.numpy() for l in limbs]
        if self._ctx is not None:
            payload = [[c.dtype.str, c.tolist()] for c in cols]
            replies = self._ctx.client.allgather(
                self._stage + ":range", payload, self._ctx.timeout,
                epoch=self._epoch)
            cols = [np.concatenate([np.array(r[i][1], dtype=r[i][0])
                                    for r in replies])
                    for i in range(len(cols))]
        picked = pick_quantile_boundaries(cols, self.nparts)
        return [torch.from_numpy(np.ascontiguousarray(c).view(np.int64)
                                 if c.dtype == np.uint64 else c)
                .to(self.device) for c in picked]

    def _aux_args(self, sharded) -> tuple:
        if self._bounds is None:
            self._bounds = self._sample_bounds(sharded)
        return (self._bounds,)

    def _prepare_program(self):
        # the boundary is pid-agnostic, so only prepare differs: range
        # pids from the sampled boundary limbs
        return SH.build_range_prepare_program(self.mesh, self.orders,
                                              self.nparts)

    def _count_program(self):
        return SH.build_range_count_program(self.mesh, self.orders,
                                            self.nparts)

    def _shuffle_program(self, cap: int):
        return SH.build_range_shuffle_program(
            self.mesh, self.orders, self.nparts, cap,
            transport=self._ctx.transport)
