"""The exchange programs over the rank mesh, and bucket splits of
device batches.

[REF: sql-plugin/../GpuShuffleExchangeExecBase.scala,
 RapidsShuffleInternalManagerBase.scala, GpuRangePartitioning.scala;
 GpuOutOfCoreSortIterator]

The counterpart of the JAX package's ``parallel/shuffle.py``.  There a
shuffle stage is one ``shard_map`` SPMD program over the mesh; here a
"program" is a plain function over all of a process's ranks at once: a
``ShardedBatch`` holds each group of ranks that share a device as one
stacked ``[ranks x local_b]`` batch on that device, so one launch of
each torch operation serves every rank of the group.

* ``make_pid_fn`` — Spark's murmur3 partition ids (``ops/hashing.py``);
  ``range_pid_fn`` — a row's range by a lexicographic search of its
  sort-key limbs among sampled boundary rows.
* The two-phase programs (``build_count_program`` then
  ``build_shuffle_program``, and their range variants): per-rank
  partition counts, then a sort-based ``partition_layout`` into
  ``[nparts x cap]`` cells and ``exchange_collective``, the all_to_all
  of the cells.  The multi-executor exchange runs these (its
  rendezvous agrees on ``cap``).
* The compiled exchange (``build_prepare_program`` then
  ``build_boundary_program``): per rank, a sort-free stable rank of
  every row within its destination (``_exchange_rank``: eight
  destinations count in the byte lanes of one 64-bit cumsum) and one
  scatter into a gather index table, with the per-partition counts of
  the same launch (``_prepare_index``); then the stage seam, in the
  JAX package's shape: slice the table to ``cap`` cells, clip-gather,
  ``exchange_collective`` (on one device a transpose of the cells,
  across devices copies between them), receive mask from the host-fed
  counts.
* ``exchange_cap`` — the wire cell's row capacity (the 1/32-octave
  ladder); ``shard_batch`` / ``slice_batch``.

Plus four functions under the out-of-core sort, the join's hash
sub-partitioning and the aggregate's repartitioned merge:
``_sorted_pids`` and ``_partition_bounds`` (rows stably sorted by
bucket id, and where each bucket's run starts), ``range_pid_fn`` and
``split_to_spillables``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, round_up_pow2, slice_batch)
from spark_rapids_tpu_torch.ops.hashing import make_pid_fn
from spark_rapids_tpu_torch.parallel.mesh import Mesh
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.runtime.memory import SpillableBatch

__all__ = ["make_pid_fn", "slice_batch"]

# one increment per program build (the JAX package's counts of SPMD
# program constructions): the two-phase count/shuffle programs, and the
# compiled exchange's prepare + boundary
_TM_ICI_PROGRAMS = TM.REGISTRY.counter(
    "tpuq_ici_programs_built_total",
    "SPMD count/shuffle programs constructed (pre-compile)")
_TM_ICI_EX_PROGRAMS = TM.REGISTRY.counter(
    "tpuq_ici_exchange_programs_built_total",
    "compiled-exchange SPMD programs constructed (prepare + boundary)")


def _sorted_pids(batch: DeviceBatch, pid: torch.Tensor, nparts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows stably sorted by destination id, dead rows into an overflow
    bucket ``nparts`` at the end: (sorted ids, permutation)."""
    pid = torch.where(batch.sel, pid.to(torch.int64), nparts)
    return torch.sort(pid, stable=True)


def _partition_bounds(pid_s: torch.Tensor, nparts: int) -> torch.Tensor:
    """Start of each id's run in the sorted ids, and the end of the last:
    int64[nparts + 1]."""
    probe = torch.arange(nparts + 1, dtype=torch.int64, device=pid_s.device)
    return torch.searchsorted(pid_s, probe)


def range_pid_fn(orders) -> Callable:
    """``pids(batch, boundary_limbs)``: each row's range id, the number
    of the ``nparts - 1`` boundary rows at or below its sort key (the
    key's orderable limbs, ``exec/sort.py::_encode_key_limbs``, searched
    lexicographically among the boundaries' limbs)."""
    def pids(batch: DeviceBatch, blimbs: List[torch.Tensor]
             ) -> torch.Tensor:
        from spark_rapids_tpu_torch.exec.join import _lex_search
        from spark_rapids_tpu_torch.exec.sort import _encode_key_limbs
        return _lex_search(blimbs, _encode_key_limbs(batch, orders),
                           "right")

    return pids


def split_to_spillables(batches: List[DeviceBatch], ids_fn, nbuckets: int,
                        mgr, aux=None, chunk_rows: int = 1 << 20
                        ) -> List[List[SpillableBatch]]:
    """Split batches by bucket id (``ids_fn(batch, aux)``), each slice
    registered with the arbiter as an unreserved spillable
    (``SpillableBatch(reserve=False)``, ``live_rows`` set): per bucket,
    its slices in input order.

    The batches coalesce into chunks of at most ``chunk_rows`` rows of
    capacity (a larger batch is a chunk of its own); as this path
    usually runs after a ``RetryOOM``, the cap is lowered so that a
    chunk and its sorted copy fit a quarter of the budget.  Each chunk's
    rows are stably sorted by bucket (dead rows last), one host read
    takes the bucket counts, and each non-empty bucket is cut into one
    compacted slice of ``max(8, next power of two)`` rows.  Within a
    bucket, rows keep their input order.

    DRAINS ``batches`` in place: the caller's frame still holds the
    list, and only emptying it lets the input free as its slices are
    cut."""
    from spark_rapids_tpu_torch.exec.basic import concat_device_batches
    out: List[List[SpillableBatch]] = [[] for _ in range(nbuckets)]
    if not batches:
        return out
    row_b = max(1, batches[0].nbytes() // max(batches[0].capacity, 1))
    budget_rows = max(1024, int(mgr.budget) // (4 * row_b))
    chunk_rows = min(chunk_rows,
                     1 << max(10, budget_rows.bit_length() - 1))
    while batches:
        chunk, acc = [], 0
        while batches and (not chunk
                           or acc + batches[0].capacity <= chunk_rows):
            chunk.append(compact(batches.pop(0)))
            acc += chunk[-1].capacity
        merged = (chunk[0] if len(chunk) == 1 else
                  concat_device_batches(chunk[0].schema, chunk))
        del chunk
        pid_s, perm = _sorted_pids(merged, ids_fn(merged, aux), nbuckets)
        bounds = _partition_bounds(pid_s, nbuckets)
        counts = (bounds[1:] - bounds[:-1]).tolist()  # the chunk's one read
        dev = merged.device
        lo = 0
        for i, n in enumerate(counts):
            if n:
                size = max(8, 1 << (n - 1).bit_length())
                iota = torch.arange(size, device=dev)
                rows = perm[(lo + iota).clamp(0, merged.capacity - 1)]
                sp = SpillableBatch(DeviceBatch(merged.schema, tuple(
                    c.gather(rows) for c in merged.columns), iota < n,
                    compacted=True), mgr, reserve=False)
                sp.live_rows = n
                out[i].append(sp)
            lo += n
        del merged, pid_s, perm
    return out


# ---------------------------------------------------------------------------
# The sharded stage input
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedBatch:
    """A batch row-sharded over a mesh's local ranks: ``parts[i]`` is
    group i's stacked batch (``len(ranks) * local_b`` rows; rank j of
    the group owns rows ``[j * local_b, (j + 1) * local_b)``)."""

    mesh: Mesh
    local_b: int
    parts: List[DeviceBatch]

    def shard(self, rank: int) -> DeviceBatch:
        """Rank ``rank``'s rows (a view)."""
        for (_, ranks), part in zip(self.mesh.groups(), self.parts):
            if rank in ranks:
                j = ranks.index(rank)
                return slice_batch(part, j * self.local_b, self.local_b)
        raise RuntimeError(
            f"rank {rank} is not local to this process (a multi-executor "
            "pump must only pull owned partitions)")

    def nbytes(self) -> int:
        return sum(p.nbytes() for p in self.parts)


def shard_batch(mesh: Mesh, batch: DeviceBatch) -> ShardedBatch:
    """Place a global batch row-sharded across the mesh (capacity must be
    divisible by the mesh size; a single-process mesh)."""
    d = mesh.size
    if batch.capacity % d:
        raise ValueError(f"capacity {batch.capacity} is not divisible by "
                         f"the mesh's {d} ranks")
    local_b = batch.capacity // d
    parts = []
    for dev, ranks in mesh.groups():
        part = slice_batch(batch, ranks[0] * local_b, len(ranks) * local_b)
        parts.append(DeviceBatch(
            part.schema, tuple(c.map_rows(lambda x: x.to(dev))
                               for c in part.columns),
            part.sel.to(dev)))
    return ShardedBatch(mesh, local_b, parts)


def _leaves(batch: DeviceBatch) -> List[Optional[torch.Tensor]]:
    out: List[Optional[torch.Tensor]] = []
    for c in batch.columns:
        out.extend((c.data, c.validity, c.lengths, c.evalid))
    out.append(batch.sel)
    return out


def _from_leaves(schema, leaves: List[Optional[torch.Tensor]],
                 compacted: bool = False) -> DeviceBatch:
    cols = []
    for i, f in enumerate(schema.fields):
        cols.append(DeviceColumn(f.dtype, *leaves[4 * i:4 * i + 4]))
    return DeviceBatch(schema, tuple(cols), leaves[-1], compacted)


def _map_leaves(batch: DeviceBatch, fn) -> DeviceBatch:
    return _from_leaves(batch.schema, [None if x is None else fn(x)
                                       for x in _leaves(batch)])


# ---------------------------------------------------------------------------
# Two-phase programs: count, then layout + all_to_all
# ---------------------------------------------------------------------------

def local_partition_counts(batch: DeviceBatch, pid: torch.Tensor,
                           nparts: int) -> torch.Tensor:
    """Live-row count per destination partition: int64[nparts]."""
    pid_s, _ = _sorted_pids(batch, pid, nparts)
    bounds = _partition_bounds(pid_s, nparts)
    return bounds[1:] - bounds[:-1]


def _group_counts(pid: torch.Tensor, sel: torch.Tensor, nparts: int
                  ) -> torch.Tensor:
    """Per-rank live-row counts of a group's ``[g, b]`` pids:
    int64[g, nparts], one scatter-add (no sort, no host read)."""
    g = pid.shape[0]
    slot = torch.arange(g, device=pid.device)[:, None] * nparts + \
        pid.to(torch.int64)
    slot = torch.where(sel, slot, g * nparts)
    out = torch.zeros(g * nparts + 1, dtype=torch.int64, device=pid.device)
    out.scatter_add_(0, slot.reshape(-1), torch.ones_like(slot.reshape(-1)))
    return out[:-1].reshape(g, nparts)


def partition_layout(batch: DeviceBatch, pid: torch.Tensor, nparts: int,
                     cap: int) -> DeviceBatch:
    """Local ``[B]`` batch -> ``[nparts * cap]`` batch: slot (p, c) holds
    the c-th local row destined for partition p (dead beyond each
    count).  Scatter-free: one stable sort and one gather.  Rows beyond
    ``cap`` per partition are dropped — callers pick cap >= the counts
    (the count program exists for exactly this)."""
    b = batch.capacity
    pid_s, perm = _sorted_pids(batch, pid, nparts)
    bounds = _partition_bounds(pid_s, nparts)
    starts, ends = bounds[:-1], bounds[1:]
    src = starts[:, None] + torch.arange(cap, device=pid.device)[None, :]
    live = src < ends[:, None]
    row_idx = perm[src.reshape(-1).clamp(0, b - 1)]
    cols = tuple(c.gather(row_idx) for c in batch.columns)
    return DeviceBatch(batch.schema, cols, live.reshape(-1))


def exchange_collective(laid: List[DeviceBatch], mesh: Mesh, nparts: int,
                        cap: int, transport=None) -> List[DeviceBatch]:
    """The wire: the all_to_all of ``[nparts x cap]`` cells.

    ``laid[i]`` is group i's stacked layout (per rank, ``nparts * cap``
    rows: block p destined for rank p).  Returns, per group, the
    stacked received rows: per rank, ``mesh.size * cap`` rows, block s
    received FROM rank s.  One group on one device: a transpose of the
    blocks; several groups of one process: copies between their
    devices; ranks in other processes: ``transport`` (the executor's
    process group) moves the cells."""
    d = mesh.size
    groups = mesh.groups()
    if transport is not None:
        if len(groups) != 1:
            raise NotImplementedError(
                "a multi-executor exchange holds one group of ranks per "
                "process")
        return [transport.exchange_cells(laid[0], mesh, cap)]
    if len(groups) == 1:
        def coll(x):
            y = x.reshape((d, nparts, cap) + x.shape[1:]).transpose(0, 1)
            return y.reshape((d * nparts * cap,) + x.shape[1:])
        return [_map_leaves(laid[0], coll)]
    out = []
    for dev, ranks in groups:
        def recv(xs):
            # xs[i]: group i's leaf, [g_i, nparts, cap, ...]
            blocks = []
            for r in ranks:
                blocks.append(torch.cat([x[:, r].to(dev) for x in xs])
                              .reshape((d * cap,) + xs[0].shape[3:]))
            return torch.cat(blocks)
        per_group = [_leaves(b) for b in laid]
        leaves = []
        for li in range(len(per_group[0])):
            if per_group[0][li] is None:
                leaves.append(None)
                continue
            xs = [pg[li].reshape((len(r), nparts, cap)
                                 + pg[li].shape[1:])
                  for pg, (_, r) in zip(per_group, groups)]
            leaves.append(recv(xs))
        out.append(_from_leaves(laid[0].schema, leaves))
    return out


def _layout_groups(sharded: ShardedBatch, pids: List[torch.Tensor],
                   nparts: int, cap: int) -> List[DeviceBatch]:
    b = sharded.local_b
    out = []
    for (dev, ranks), part, pid in zip(sharded.mesh.groups(),
                                       sharded.parts, pids):
        blocks = [partition_layout(slice_batch(part, j * b, b),
                                   pid[j * b:(j + 1) * b], nparts, cap)
                  for j in range(len(ranks))]
        if len(blocks) == 1:
            out.append(blocks[0])
            continue
        # stacked verbatim (dead cells kept: the layout is positional)
        out.append(_from_leaves(part.schema, [
            None if xs[0] is None else torch.cat(xs)
            for xs in zip(*[_leaves(bl) for bl in blocks])]))
    return out


def _count_groups(sharded: ShardedBatch, pids: List[torch.Tensor],
                  nparts: int) -> torch.Tensor:
    """int64[local ranks, nparts] on the first group's device."""
    b = sharded.local_b
    out = []
    for (_, ranks), part, pid in zip(sharded.mesh.groups(), sharded.parts,
                                     pids):
        g = len(ranks)
        out.append(_group_counts(pid.reshape(g, b), part.sel.reshape(g, b),
                                 nparts).to(sharded.parts[0].device))
    return torch.cat(out)


def build_count_program(mesh: Mesh, keys, nparts: int, canon_int64=()):
    """Phase 1: per-rank per-partition live-row counts
    (``int64[local ranks, nparts]``)."""
    pid_fn = make_pid_fn(keys, nparts, canon_int64)
    _TM_ICI_PROGRAMS.inc()

    def run(sharded: ShardedBatch) -> torch.Tensor:
        return _count_groups(sharded, [pid_fn(p) for p in sharded.parts],
                             nparts)
    return run


def build_shuffle_program(mesh: Mesh, keys, nparts: int, cap: int,
                          canon_int64=(), transport=None):
    """Phase 2: layout -> all_to_all -> per group, the received rows."""
    pid_fn = make_pid_fn(keys, nparts, canon_int64)
    _TM_ICI_PROGRAMS.inc()

    def run(sharded: ShardedBatch) -> List[DeviceBatch]:
        laid = _layout_groups(sharded, [pid_fn(p) for p in sharded.parts],
                              nparts, cap)
        return exchange_collective(laid, mesh, nparts, cap, transport)
    return run


def build_range_count_program(mesh: Mesh, orders, nparts: int):
    """Phase 1 of the RANGE exchange; the boundary limbs ride as an
    argument (data-dependent, never baked into the program)."""
    pid_fn = range_pid_fn(orders)
    _TM_ICI_PROGRAMS.inc()

    def run(sharded: ShardedBatch, blimbs) -> torch.Tensor:
        return _count_groups(
            sharded, [pid_fn(p, _on(blimbs, p.device))
                      for p in sharded.parts], nparts)
    return run


def build_range_shuffle_program(mesh: Mesh, orders, nparts: int, cap: int,
                                transport=None):
    """Phase 2 of the RANGE exchange: layout -> all_to_all (partition p
    holds key range p)."""
    pid_fn = range_pid_fn(orders)
    _TM_ICI_PROGRAMS.inc()

    def run(sharded: ShardedBatch, blimbs) -> List[DeviceBatch]:
        laid = _layout_groups(
            sharded, [pid_fn(p, _on(blimbs, p.device))
                      for p in sharded.parts], nparts, cap)
        return exchange_collective(laid, mesh, nparts, cap, transport)
    return run


def _on(tensors, device):
    return [t.to(device) for t in tensors]


# ---------------------------------------------------------------------------
# Compiled exchange: prepare (producer side) + boundary (stage seam)
# ---------------------------------------------------------------------------

# rows per ranking chunk: each destination's within-chunk count rides one
# byte lane of a packed 64-bit word, so a chunk may hold at most 255 rows
_RANK_CHUNK = 128


def exchange_cap(max_count: int, local_b: int) -> int:
    """Wire-cell row capacity for a measured (rank, partition) max.

    NOT the pow-2 ladder: every padded row is a row on the wire, so the
    ladder steps at 1/32 of the enclosing pow-2 bucket (<= ~3.2% pad)."""
    mc = max(int(max_count), 1)
    step = max(round_up_pow2(mc, 1) // 32, 8)
    return min(-(-mc // step) * step, local_b)


def _exchange_rank(pid: torch.Tensor, sel: torch.Tensor, nparts: int,
                   b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable within-partition rank of every live row + per-partition
    live counts — sort-free, over ``[..., b]`` (leading dims: ranks).

    Eight destinations pack into one 64-bit word (one byte lane each):
    an intra-chunk inclusive cumsum of the packed one-hot encodings
    counts all eight lanes at once, chunk totals unpack and a second
    (tiny) cumsum gives the chunk bases.  Dead rows encode as 0.
    Destinations beyond 8 run as further packed groups.  torch has no
    unsigned 64-bit type: the words are int64 bit patterns (the top
    lane may wrap into the sign bit; each lane is masked after its
    arithmetic shift)."""
    lead = tuple(pid.shape[:-1])
    ngroups = -(-nparts // 8)
    ch = min(_RANK_CHUNK, b)
    nch = b // ch
    pid = pid.to(torch.int64)
    ranks, counts = [], []
    for g in range(ngroups):
        lanes = min(8, nparts - 8 * g)
        lane = pid - 8 * g
        in_g = sel & (lane >= 0) & (lane < 8)
        lane_c = lane.clamp(0, 7)
        enc = torch.where(in_g, torch.ones_like(lane_c) << (8 * lane_c), 0)
        chunks = enc.reshape(lead + (nch, ch))
        incl = torch.cumsum(chunks, dim=-1)
        shifts = 8 * torch.arange(lanes, dtype=torch.int64,
                                  device=pid.device)
        tot = (incl[..., -1:] >> shifts) & 0xFF              # [.., nch, lanes]
        base = torch.cumsum(tot, dim=-2) - tot               # chunk bases
        excl = incl - chunks
        lane_ch = lane_c.reshape(lead + (nch, ch))
        within = (excl >> (8 * lane_ch)) & 0xFF
        cbase = torch.gather(base, -1, lane_ch.clamp(0, lanes - 1))
        ranks.append((within + cbase).reshape(lead + (b,)))
        counts.append(base[..., -1, :] + tot[..., -1, :])
    rank = ranks[0]
    for g in range(1, ngroups):
        rank = torch.where(pid // 8 == g, ranks[g], rank)
    return (rank.to(torch.int32),
            torch.cat(counts, dim=-1)[..., :nparts].to(torch.int32))


def _prepare_rows(sel: torch.Tensor, pid: torch.Tensor, nparts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[g, b]`` -> (gather index tables int64[g, nparts * b], counts
    int32[g, nparts]); ONE scatter: live rows write their slot, dead
    rows aim at distinct slots past the table and are cut off."""
    g, b = sel.shape
    rank, counts = _exchange_rank(pid, sel, nparts, b)
    iota = torch.arange(b, dtype=torch.int64, device=sel.device)
    slot = torch.where(sel, pid.to(torch.int64) * b + rank,
                       nparts * b + iota)
    idx = torch.full((g, (nparts + 1) * b), b, dtype=torch.int64,
                     device=sel.device)
    idx.scatter_(1, slot, iota.expand(g, b))
    return idx[:, :nparts * b], counts


def _prepare_index(batch: DeviceBatch, pid: torch.Tensor, nparts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather index table int64[nparts * B], live counts
    int32[nparts]) of one rank: slot (p, r) holds the source row of
    partition p's r-th live row (source order), B beyond each count (a
    clip-gather sentinel)."""
    idx, counts = _prepare_rows(batch.sel[None], pid[None], nparts)
    return idx[0], counts[0]


def _prepare_groups(sharded: ShardedBatch, pids: List[torch.Tensor],
                    nparts: int):
    b = sharded.local_b
    idx, counts = [], []
    for (_, ranks), part, pid in zip(sharded.mesh.groups(), sharded.parts,
                                     pids):
        g = len(ranks)
        i, c = _prepare_rows(part.sel.reshape(g, b), pid.reshape(g, b),
                             nparts)
        idx.append(i)
        counts.append(c)
    return idx, counts


def build_prepare_program(mesh: Mesh, keys, nparts: int, canon_int64=()):
    """Producer side: per rank, the gather index table + per-partition
    live counts, one pass, no sort.  Returns per group (tables
    ``[g, nparts * b]``, counts ``[g, nparts]``)."""
    pid_fn = make_pid_fn(keys, nparts, canon_int64)
    _TM_ICI_EX_PROGRAMS.inc()

    def run(sharded: ShardedBatch):
        return _prepare_groups(sharded, [pid_fn(p) for p in sharded.parts],
                               nparts)
    return run


def build_range_prepare_program(mesh: Mesh, orders, nparts: int):
    """RANGE flavor of the prepare program (boundary limbs as an
    argument)."""
    pid_fn = range_pid_fn(orders)
    _TM_ICI_EX_PROGRAMS.inc()

    def run(sharded: ShardedBatch, blimbs):
        return _prepare_groups(
            sharded, [pid_fn(p, _on(blimbs, p.device))
                      for p in sharded.parts], nparts)
    return run


@dataclasses.dataclass
class Received:
    """An exchange's output on this process: per local partition, one
    batch (``blocks[p]``); ``counts[p]`` its live rows when the host
    knows them (the compiled path), else None."""

    blocks: dict
    counts: Optional[dict] = None


def build_boundary_program(mesh: Mesh, nparts: int, cap: int,
                           donate: bool = True, transport=None):
    """The stage seam: every column across the mesh.

    ``run(inputs, counts)``: ``inputs`` holds the stage input
    (``"sharded"``) and the prepare program's index tables (``"idx"``);
    with ``donate`` they are dropped from it as soon as they have been
    gathered from (torch has no buffer donation).  ``counts[s][p]``:
    rows rank s sends to partition p, on the host from prepare's counts.

    Pid-agnostic — the index tables already encode routing, so hash and
    range exchanges share it.  The JAX package's shape: per rank, the
    table sliced to ``cap`` cells per destination, a clip-gather (the
    sentinel clips to a junk row hidden by the receive mask),
    ``exchange_collective``, then liveness from the host-fed receive
    counts, which ``Received.counts`` also carries."""
    _TM_ICI_EX_PROGRAMS.inc()

    def run(inputs: dict, counts: np.ndarray) -> Received:
        sharded, idx = inputs["sharded"], inputs["idx"]
        b = sharded.local_b
        laid = []
        for (dev, ranks), part, table in zip(mesh.groups(), sharded.parts,
                                             idx):
            g = len(ranks)
            t = table.reshape(g, nparts, b)[:, :, :cap].clamp(max=b - 1)
            t = t + (torch.arange(g, device=dev) * b)[:, None, None]
            rows = t.reshape(-1)
            laid.append(DeviceBatch(part.schema, tuple(
                c.gather(rows) for c in part.columns),
                torch.ones(rows.shape[0], dtype=torch.bool, device=dev)))
        del sharded, idx
        if donate:
            inputs.clear()
        recv = exchange_collective(laid, mesh, nparts, cap, transport)
        del laid
        blocks = {}
        for (dev, ranks), got in zip(mesh.groups(), recv):
            for j, r in enumerate(ranks):
                block = slice_batch(got, j * mesh.size * cap,
                                    mesh.size * cap)
                live = (torch.arange(cap, device=dev)[None, :]
                        < torch.from_numpy(counts[:, r].astype(np.int64))
                        .to(dev)[:, None]).reshape(-1)
                blocks[r] = block.with_sel(live)
        recv_counts = counts.sum(axis=0)
        return Received(blocks, {r: int(recv_counts[r]) for r in blocks})
    return run
