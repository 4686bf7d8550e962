"""Sort-merge equi-join on the device.

[REF: sql-plugin/../GpuShuffledHashJoinExec.scala, GpuBroadcastHashJoinExec]

The counterpart of the JAX package's ``exec/join.py`` (its device half):
the join keys encode as 64-bit limbs; the build (right) side is sorted
once; each left row finds its ``[lo, lo + m)`` range of matching build
rows — through ``kernels/hash_join.py::match_fused`` (one hash limb, the
CUDA kernel ``hash_pairs`` hashing both sides) on the ``cuda`` rung, or
the exact lexicographic bisection ``_lex_search`` on the ``jnp`` rung —
and the ranges expand into output rows with one host sync (the output
row count picks the output bucket).

Key encoding is canonical across sides: integral keys of any width
encode as 64-bit biased values, strings as byte matrices padded to the
shared width of both sides, float32 as orderable 32-bit values, float64
as a NaN flag plus a raw float limb.  Null and dead rows are excluded by
a leading exclusion flag, so null keys never match (Spark equi-join
semantics) but still surface in left and anti outputs.

Ported: inner, left, left_semi and left_anti joins; the in-core path,
the broadcast path, and the run-time pick by live row counts that
streams the big side in bounded groups against a side that fits
(``_broadcast_streamed``, ``_semi_stream_right``).  Not ported, and
raising ``NotImplementedError`` naming itself: the hash sub-partition
path for two oversized sides (``_sub_partition_join``), right joins
(``_execute_swapped``), full and cross joins, residual join conditions
(``_apply_condition``), the adaptive joins, and the co-partitioned
(exchanged) plan.  The JAX package reserves device memory around each
join step with its memory manager (``transient``, ``RetryOOM``); the
port has no memory manager yet, so those calls are left out.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, round_up_pow2, slice_batch)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.basic import (
    concat_device_batches, live_counts)
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.plan.analysis import _not_ported


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _gather_list(child) -> List[DeviceBatch]:
    """The child's batches (all partitions), compacted."""
    return [compact(b) for p in range(child.num_partitions())
            for b in child.execute(p)]


def _row_groups(batches: List[DeviceBatch], cap: int
                ) -> List[List[DeviceBatch]]:
    """Batches in groups of at most ``cap`` rows of capacity.  A batch
    above the cap is cut into row slices first; the batches are
    compacted, so each slice keeps a contiguous live prefix."""
    groups: List[List[DeviceBatch]] = [[]]
    acc = 0
    for b in batches:
        chunks = ([b] if b.capacity <= cap else
                  [slice_batch(b, lo, cap)
                   for lo in range(0, b.capacity, cap)])
        for c in chunks:
            if groups[-1] and acc + c.capacity > cap:
                groups.append([])
                acc = 0
            groups[-1].append(c)
            acc += c.capacity
    return groups


# ---------------------------------------------------------------------------
# device search machinery
# ---------------------------------------------------------------------------

def _lex_search(sorted_limbs: List[torch.Tensor],
                query_limbs: List[torch.Tensor], side: str) -> torch.Tensor:
    """Vectorized lexicographic binary search — the exact rung.

    Per query row, the first index i of the sorted table with
    table[i] >= query (``side='left'``) or > query (``'right'``).  Limbs
    are int64 bit patterns compared as unsigned (``ORD.sortable``), or
    raw float64 limbs compared as floats.  Returns int64 indices.
    """
    if len(sorted_limbs) != len(query_limbs):
        raise ValueError("join key limb layouts differ between sides: "
                         f"{len(sorted_limbs)} vs {len(query_limbs)}")
    n = int(sorted_limbs[0].shape[0])
    nq = int(query_limbs[0].shape[0])
    dev = query_limbs[0].device
    table = [ORD.sortable(l) for l in sorted_limbs]
    query = [ORD.sortable(l) for l in query_limbs]
    lo = torch.zeros((nq,), dtype=torch.int64, device=dev)
    hi = torch.full((nq,), n, dtype=torch.int64, device=dev)
    steps = max(1, (max(n, 2) - 1).bit_length() + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        lt = torch.zeros((nq,), dtype=torch.bool, device=dev)
        eq = torch.ones((nq,), dtype=torch.bool, device=dev)
        for tl, ql in zip(table, query):
            tv = tl[midc]
            lt = lt | (eq & (tv < ql))
            eq = eq & (tv == ql)
        go_right = (lt | eq) if side == "right" else lt
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _expand_counts(counts: torch.Tensor
                   ) -> Tuple[int, torch.Tensor, torch.Tensor, int]:
    """counts[B] -> (bucket, row_idx[bucket], offset[bucket], total).

    The ONE host sync of the join: the total match count picks the
    output bucket (a power of two); everything else stays on the device.
    """
    c64 = counts.to(torch.int64)
    cum = torch.cumsum(c64, 0)
    total = int(cum[-1]) if counts.shape[0] else 0
    bucket = round_up_pow2(max(total, 1))
    j = torch.arange(bucket, dtype=torch.int64, device=counts.device)
    i = torch.searchsorted(cum, j, right=True)
    i_c = i.clamp(0, max(counts.shape[0] - 1, 0))
    start = cum[i_c] - c64[i_c]
    return bucket, i_c, j - start, total


_INT_FAMILY = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


def _join_key_family(dt: T.DataType) -> str:
    """Key-compatibility class: members of the integral family may join
    each other (both canonicalize to 64 bits); others must match."""
    if isinstance(dt, _INT_FAMILY):
        return "int"
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        return "float" + str(32 if isinstance(dt, T.FloatType) else 64)
    return dt.simple_name


def _canonical_key_parts(c: DeviceColumn, str_width: int
                         ) -> List[ORD.Part]:
    """Equality-key parts whose layout depends only on the key's family
    (and the shared string width) — never on validity presence, the
    batch's own string width or the int width."""
    dt = c.dtype
    if isinstance(dt, (T.StringType, T.BinaryType)):
        data = c.data
        w = int(data.shape[1])
        if w < str_width:
            data = torch.nn.functional.pad(data, (0, str_width - w))
        return ORD._string_parts(data, c.lengths)
    if isinstance(dt, T.FloatType):
        # NaN canonicalized, -0.0 == 0.0 (Spark NormalizeFloatingNumbers)
        return [(ORD._f32_orderable_u32(c.data, normalize_zero=True), 32)]
    if isinstance(dt, T.DoubleType):
        # NaN rides a flag part, the value a raw float limb (NaN and -0.0
        # become +0.0 so that the sort and the search agree)
        isn = torch.isnan(c.data)
        val = torch.where(isn, 0.0, c.data)
        val = torch.where(val == 0.0, 0.0, val)
        return [ORD._flag_part(isn), (val, "f64")]
    if isinstance(dt, T.BooleanType):
        return [(c.data.to(torch.int64), 1)]
    # integral family, date, timestamp -> 64-bit biased encoding
    return [ORD._int_part(c.data.to(torch.int64), 64, True)]


def _key_parts(batch: DeviceBatch, keys: Sequence[Expression],
               str_widths: Sequence[int]
               ) -> Tuple[List[ORD.Part], torch.Tensor]:
    """(canonical equality key parts, has_null_key) of a batch's keys."""
    has_null = torch.zeros((batch.capacity,), dtype=torch.bool,
                           device=batch.device)
    parts: List[ORD.Part] = []
    for e, w in zip(keys, str_widths):
        c = e.eval(batch)
        if c.validity is not None:
            has_null = has_null | ~c.validity
        parts.extend(_canonical_key_parts(c, w))
    return parts, has_null


def _key_str_width(batch: DeviceBatch, e: Expression) -> int:
    """String width of a key expression's result on this batch: read off
    the batch for a column reference, else from the expression evaluated
    on a zero-row slice (shapes only, as the JAX package's
    ``eval_shape``)."""
    if not isinstance(e.dtype, (T.StringType, T.BinaryType)):
        return 0
    if hasattr(e, "index"):
        return int(batch.columns[e.index].data.shape[1])
    return int(e.eval(slice_batch(batch, 0, 0)).data.shape[1])


def _gather_col(c: DeviceColumn, idx: torch.Tensor,
                valid_out: torch.Tensor) -> DeviceColumn:
    g = c.gather(idx.clamp(0, c.capacity - 1))
    return DeviceColumn(c.dtype, g.data, g.valid_mask() & valid_out,
                        g.lengths)


# ---------------------------------------------------------------------------
# execs
# ---------------------------------------------------------------------------

class TpuBroadcastExchangeExec(TpuExec):
    """Gathers the (small) child into one batch once; the join reuses it.

    [REF: GpuBroadcastExchangeExec — in a single process the broadcast
    is the cached device batch itself]"""

    def __init__(self, child: TpuExec):
        super().__init__(child.schema, child)
        self._lock = threading.Lock()
        self._cached: Optional[DeviceBatch] = None

    def node_string(self):
        return "TpuBroadcastExchange"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        with self._lock:
            if self._cached is None:
                with self.timer("broadcastTime"):
                    self._cached = concat_device_batches(
                        self.schema, _gather_list(self.children[0]))
                self.metric("numOutputBatches").add(1)
        yield self._cached


class TpuSortMergeJoinExec(TpuExec):
    """[REF: GpuShuffledHashJoinExec — the same plan position, with the
    sort-merge algorithm; GpuBroadcastHashJoinExec when ``broadcast`` is
    set]

    ``broadcast`` names the side ("left"/"right") that is a
    ``TpuBroadcastExchangeExec``; ``sub_partition_rows``
    (``spark.rapids.tpu.join.targetRows``) caps the rows of one in-core
    join; join outputs re-batch to ``out_batch_rows``
    (``spark.rapids.tpu.batchRows``).  ``backend`` is the kernel plane's
    rung for the match ranges.

    Metrics beyond the JAX package's (``streamedJoins``): the port
    counts the groups of each side that streamed against the other
    (``streamedLeftGroups``, ``streamedRightGroups``), so that a run can
    tell which side stayed whole.
    """

    def __init__(self, join_type: str, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression], schema: T.StructType,
                 left: TpuExec, right: TpuExec, using: bool = True,
                 broadcast: Optional[str] = None,
                 sub_partition_rows: int = 1 << 18,
                 out_batch_rows: Optional[int] = None,
                 backend: str = "auto"):
        super().__init__(schema, left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.using = using
        self.broadcast = broadcast
        self.sub_partition_rows = sub_partition_rows
        self.out_batch_rows = out_batch_rows
        self.backend = KN.resolve("join", backend)

    def node_string(self):
        bc = f" broadcast={self.broadcast}" if self.broadcast else ""
        cond = f" cond={self.condition}" if self.condition else ""
        return f"TpuSortMergeJoin [{self.join_type}{bc}{cond}]"

    def num_partitions(self) -> int:
        return 1

    def _check_ported(self) -> None:
        jt = self.join_type
        if jt == "right":
            raise _not_ported("right outer join (_execute_swapped)")
        if jt == "full":
            raise _not_ported("full outer join")
        if jt == "cross" or not self.left_keys:
            raise _not_ported("cross join (a join without equi keys)")
        if self.condition is not None:
            raise _not_ported(
                "residual join condition (_apply_condition)")

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        if partition != 0:
            raise IndexError(f"partition {partition} of a 1-partition join")
        self._check_ported()
        jt = self.join_type
        with self.timer("gatherTime"):
            l_list = _gather_list(self.children[0])
            r_list = _gather_list(self.children[1])
        cap = self.sub_partition_rows
        l_counts = r_counts = None
        if cap and not self.broadcast:
            # run-time strategy pick by LIVE rows (one device read for
            # both sides): a filtered side keeps its scan bucket but may
            # hold few live rows
            counts = live_counts(l_list + r_list)
            l_counts = counts[:len(l_list)]
            r_counts = counts[len(l_list):]
            l_live = sum(l_counts) or 1
            r_live = sum(r_counts) or 1
            if max(l_live, r_live) > cap:
                # one side fits in-core: stream the other in bounded
                # groups against it
                if r_live <= cap:
                    self.metric("streamedJoins").add(1)
                    yield from self._broadcast_streamed(
                        l_list, r_list, jt, side="right")
                    return
                if l_live <= cap and jt == "inner":
                    self.metric("streamedJoins").add(1)
                    yield from self._broadcast_streamed(
                        l_list, r_list, jt, side="left")
                    return
                if l_live <= cap and jt in ("left_semi", "left_anti"):
                    self.metric("streamedJoins").add(1)
                    yield from self._semi_stream_right(
                        l_list, l_counts, r_list, jt)
                    return
                raise _not_ported(
                    "hash sub-partition join of two sides over "
                    f"spark.rapids.tpu.join.targetRows={cap} "
                    f"({l_live} and {r_live} live rows; "
                    "_sub_partition_join)")
        # a broadcast join's streamed side honors the row cap in bounded
        # groups (the broadcast side is capped by the byte threshold)
        if cap and self.broadcast and sum(
                b.capacity for b in (l_list if self.broadcast == "right"
                                     else r_list)) > cap:
            yield from self._broadcast_streamed(l_list, r_list, jt)
            return
        lb = self._concat(0, l_list, l_counts)
        rb = self._concat(1, r_list, r_counts)
        with self.timer():
            outs = list(self._merge_join(lb, rb, jt))
        yield from self._emit(outs)

    def _concat(self, side: int, batches, counts=None) -> DeviceBatch:
        """One batch of a side's gathered batches (every child yields at
        least one batch: a scan of no rows yields one with no live row)."""
        return concat_device_batches(self.children[side].schema, batches,
                                     counts=counts)

    def _emit(self, outs: List[DeviceBatch]) -> Iterator[DeviceBatch]:
        for o in outs:
            self.metric("numOutputBatches").add(1)
            yield o

    def _broadcast_streamed(self, l_list, r_list, jt,
                            side: Optional[str] = None
                            ) -> Iterator[DeviceBatch]:
        """Join the streamed side in groups of at most the row cap
        against the whole other side.  Correct for inner/left/semi/anti
        with the right side whole, and for inner with the left side
        whole: each streamed row's output depends only on the whole
        side, so groups are independent.  ``side`` (the whole side)
        overrides ``self.broadcast`` for the run-time pick on plans
        without a broadcast."""
        side = side or self.broadcast
        stream = l_list if side == "right" else r_list
        groups = _row_groups(stream, self.sub_partition_rows)
        self.metric("streamedLeftGroups" if side == "right"
                    else "streamedRightGroups").add(len(groups))
        # the WHOLE side's schema is the one named by ``side``, not by
        # self.broadcast (the JAX package's fix for TPC-H q7)
        bc = self._concat(1 if side == "right" else 0,
                          r_list if side == "right" else l_list)
        for g in groups:
            gb = self._concat(0 if side == "right" else 1, g)
            lb, rb = (gb, bc) if side == "right" else (bc, gb)
            with self.timer():
                outs = list(self._merge_join(lb, rb, jt))
            yield from self._emit(outs)

    def _semi_stream_right(self, l_list, l_counts, r_list, jt
                           ) -> Iterator[DeviceBatch]:
        """semi/anti with the LEFT side whole and an oversized RIGHT:
        stream the right side in bounded groups, OR-accumulating each
        left row's match flag.  A semi/anti verdict is "matched anywhere
        on the right", so group membership never changes it; null-key
        and dead left rows get m == 0 from every group."""
        lb = self._concat(0, l_list, l_counts)
        groups = _row_groups(r_list, self.sub_partition_rows)
        self.metric("streamedRightGroups").add(len(groups))
        matched = torch.zeros((lb.capacity,), dtype=torch.bool,
                              device=lb.device)
        for g in groups:
            rb = self._concat(1, g)
            with self.timer():
                m, _, _, _ = self._match_ranges(lb, rb)
                matched = matched | (m > 0)
        keep = matched if jt == "left_semi" else ~matched
        out = lb.with_sel(lb.sel & keep)
        yield from self._emit(list(self._rebatch(self._project_semi(out),
                                                 out.capacity)))

    # -- core ---------------------------------------------------------------
    def _match_ranges(self, lb: DeviceBatch, rb: DeviceBatch):
        """``(m, lo, perm, l_null)``: per left row, its match count and
        the position of its first match in the right side sorted by
        ``perm``.  The ``cuda`` rung runs ``kernels/hash_join.py::
        match_fused`` and descends to the exact rung on a detected
        64-bit collision; within a match range both rungs enumerate the
        same right rows in the same (original-index) order, so
        ``_merge_join``'s output is identical."""
        left_keys, right_keys = self.left_keys, self.right_keys
        # shared string width per key pair: the two sides' canonical
        # layouts must match even when their paddings differ
        widths = tuple(
            max(_key_str_width(lb, le), _key_str_width(rb, re))
            for le, re in zip(left_keys, right_keys))

        def run(backend):
            r_parts, r_null = _key_parts(rb, right_keys, widths)
            r_excl = (~rb.sel) | r_null
            l_parts, l_null = _key_parts(lb, left_keys, widths)
            l_live = lb.sel & ~l_null
            if backend != "jnp":
                from spark_rapids_tpu_torch.kernels import hash_join as KNJ
                res = KNJ.match_fused(
                    ORD.fuse_parts(l_parts), ORD.fuse_parts(r_parts),
                    r_excl, use_kernel=(backend == "cuda"))
                if res is not None:
                    m, lo, perm, okf = res
                    m = torch.where(l_live, m, 0)
                    return (m, lo, perm, l_null), okf
                # unhashable keys (raw-f64 limb): the exact rung runs
                # inside this rung; ok=None -> dispatch counts "jnp"
            sorted_limbs, perm = ORD.sort_by_keys(ORD.fuse_parts(
                [ORD._flag_part(r_excl)] + r_parts))
            # canonical encoding -> identical fused limb layout on both
            # sides, compared limb for limb
            q_zero = ORD._flag_part(torch.zeros(
                (lb.capacity,), dtype=torch.bool, device=lb.device))
            q_limbs = ORD.fuse_parts([q_zero] + l_parts)
            lo = _lex_search(sorted_limbs, q_limbs, "left")
            hi = _lex_search(sorted_limbs, q_limbs, "right")
            m = torch.where(l_live, hi - lo, 0)
            return (m, lo, perm, l_null), None

        return KN.dispatch("join", self.backend,
                           lambda be: (lambda: run(be)))

    def _merge_join(self, lb: DeviceBatch, rb: DeviceBatch, jt: str
                    ) -> Iterator[DeviceBatch]:
        m, lo, perm, _ = self._match_ranges(lb, rb)
        if jt in ("left_semi", "left_anti"):
            keep = (m > 0) if jt == "left_semi" else (m == 0)
            out = lb.with_sel(lb.sel & keep)
            yield from self._rebatch(self._project_semi(out),
                                     out.capacity)
            return
        counts = m
        if jt == "left":
            counts = torch.where(lb.sel & (m == 0), 1, m)
        bucket, li, off, total = _expand_counts(counts)
        matched = m[li] > 0
        r_sorted_pos = lo[li] + off
        r_idx = perm[r_sorted_pos.clamp(0, rb.capacity - 1)]
        out_live = torch.arange(bucket, device=lb.device) < total
        out = self._materialize(lb, rb, li, r_idx, out_live,
                                out_live & matched, out_live)
        yield from self._rebatch(out, total)

    def _rebatch(self, out: DeviceBatch, total: int
                 ) -> Iterator[DeviceBatch]:
        """Slice an expanded join output into ``out_batch_rows`` chunks
        (views); all-dead tail chunks are skipped via the host-known
        ``total``.  Buckets are powers of two, so a power-of-two chunk
        divides the capacity."""
        cap = self.out_batch_rows
        if not cap or out.capacity <= cap:
            yield out
            return
        cap = 1 << (int(cap).bit_length() - 1)
        for i in range(max(1, -(-int(total) // cap))):
            yield slice_batch(out, i * cap, cap)

    def _project_semi(self, lb: DeviceBatch) -> DeviceBatch:
        """semi/anti output: [keys, left-rest] for USING joins, the left
        side's own order for expression joins."""
        if not self.using:
            return DeviceBatch(self.schema, lb.columns, lb.sel)
        lkey = [e.index for e in self.left_keys]
        order = lkey + [i for i in range(len(lb.columns)) if i not in lkey]
        return DeviceBatch(self.schema, tuple(lb.columns[i] for i in order),
                           lb.sel)

    def _materialize(self, lb, rb, l_idx, r_idx, l_valid, r_valid,
                     out_live) -> DeviceBatch:
        """Gather the output columns: for USING joins the key columns
        once (from the left) then the left and right non-key columns;
        for expression joins all left then all right columns.  Live
        rows are a prefix (``out_live``), so the batch is compacted."""
        lkey = [e.index for e in self.left_keys]
        rkey = [e.index for e in self.right_keys]
        cols: List[DeviceColumn] = []
        if self.using:
            for ki in lkey:
                cols.append(_gather_col(lb.columns[ki], l_idx, l_valid))
        for i, c in enumerate(lb.columns):
            if not (self.using and i in lkey):
                cols.append(_gather_col(c, l_idx, l_valid))
        for j, c in enumerate(rb.columns):
            if not (self.using and j in rkey):
                cols.append(_gather_col(c, r_idx, r_valid))
        return DeviceBatch(self.schema, tuple(cols), out_live,
                           compacted=True)
