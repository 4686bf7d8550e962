"""Window-function execs: the CPU oracle and the device exec.

[REF: sql-plugin/../GpuWindowExec.scala :: GpuWindowExec,
 GpuWindowExpression.scala, GpuRunningWindowExec]

The counterpart of the JAX package's ``exec/window.py``.  The device
exec evaluates the whole Window node over one batch (every child
partition concatenated), in plain PyTorch:

  encode (dead flag, partition keys, order keys) as 64-bit key limbs
  (``ops/ordering.py``) -> one stable lexicographic sort
  (``ordering.sort_by_keys``: the JAX ``sort_perm``'s permutation, bit
  for bit) -> partition boundaries (a difference over the partition
  limbs) and peer boundaries (over every limb) -> each function a
  segmented scan (``exec/aggregate.py::segmented_scan``) and, for the
  range and partition frames, the value at each segment's last row
  broadcast back over it (``broadcast_last``).

Frames (``plan/analysis.py::resolve_window``): ``rows_current`` (ROWS
unbounded preceding to the current row), ``range_current`` (Spark's
default with an ORDER BY: peers share the frame's end), ``partition``
(the whole partition), ``rows_bounded`` (sums, counts and averages as
a difference of two reads of one segmented prefix, ``_range_sum``;
min and max from a doubling sparse table, ``_range_reduce``; first as a
gather) and ``range_bounded`` (the frame's bounds found by a
lexicographic binary search over (partition ordinal, null flag, order
value), ``_compute_range_bounds``).

Floats follow the JAX package: a prefix difference over a value that
is NaN or infinite would poison frames that exclude it, so bounded
float sums run over the finite values and count the special values per
frame; min and max follow Spark's total order (NaN greatest).  Integer
min and max reduce raw signed values with ``iinfo`` identities
(``exec/aggregate.py::_extreme_input``): the JAX package's unsigned
encoding and sentinel would compare as signed int64 here.

The exec reserves ``2 x`` its input's bytes from the memory arbiter, as
the JAX exec does, plus the sparse tables of its bounded min and max
(``(ceil(log2 n) + 1) x n`` values each), which the JAX exec leaves out
of its reservation.  Its output is one compacted batch whose rows are
in (partition keys, order keys) order, identical on the CPU oracle
(``CpuWindowExec``: the same key encoding, ``np.lexsort``, then Python
segment by segment), as in the JAX package.  Under
``spark.rapids.shuffle.mode=ICI`` on a mesh of more than one rank the
rewrite puts a hash exchange on the partition keys below the window
(``exec/distributed.py``) and the window runs per exchange partition
(``partitioned=True``): each owns disjoint window-partition keys.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, torch_dtype)
from spark_rapids_tpu_torch.exec.aggregate import (
    _extreme_input, _extreme_nan, _is_float, segmented_scan)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import concat_device_batches
from spark_rapids_tpu_torch.exec.sort import _concat_host
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.plan import logical as L


WINDOW_KINDS = ("row_number", "rank", "dense_rank", "lag", "lead",
                "sum", "min", "max", "count", "avg", "first",
                "ntile", "percent_rank", "cume_dist")


# ---------------------------------------------------------------------------
# Device pieces
# ---------------------------------------------------------------------------

def broadcast_last(values: torch.Tensor,
                   boundary: torch.Tensor) -> torch.Tensor:
    """Give every row the value its segment holds at its LAST row
    (``boundary`` marks segment starts): a gather at the nearest segment
    end at or after each row, found by a reversed ``cummin``."""
    n = int(values.shape[0])
    idx = torch.arange(n, device=values.device)
    is_end = torch.ones_like(boundary)
    is_end[:-1] = boundary[1:]
    ends = torch.where(is_end, idx, n)
    end = torch.flip(torch.cummin(torch.flip(ends, [0]), 0).values, [0])
    return values[end]


def _limb_diff(limbs: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where any limb differs from the previous row's."""
    d = torch.zeros((int(limbs[0].shape[0]),), dtype=torch.bool,
                    device=limbs[0].device)
    for l in limbs:
        d[1:] |= ORD.limb_neq(l[1:], l[:-1])
    return d


def _scan_sum(data_s, contrib, pb, acc_dt: torch.dtype) -> torch.Tensor:
    masked = torch.where(contrib, data_s.to(acc_dt),
                         torch.zeros((), dtype=acc_dt, device=data_s.device))
    return segmented_scan("add", masked, pb)


def _scan_minmax(data_s, contrib, pb, kind: str, dt: T.DataType):
    """Running segmented min or max: (raw scan, running count of real
    values, running count of NaNs), the last two None except for
    floats.  The caller frame-projects all three BEFORE combining them:
    the NaN bookkeeping rides the same projection as the value."""
    vals, isn = _extreme_input(data_s, dt, contrib, kind)
    agg = segmented_scan(kind, vals, pb)
    if isn is None:
        return agg, None, None
    n_real = segmented_scan("add", (contrib & ~isn).to(torch.int64), pb)
    any_nan = segmented_scan("add", (contrib & isn).to(torch.int64), pb)
    return agg, n_real, any_nan


def _range_sum(values, pb, start, end, part_start,
               acc_dt: torch.dtype) -> torch.Tensor:
    """Frame sum over absolute per-row bounds [start, end] as the
    difference of two reads of one inclusive segmented prefix.  [REF:
    cudf rolling window kernels]  The bounds lie in the row's partition;
    an empty frame (end < start) sums to zero."""
    n = int(values.shape[0])
    prefix = segmented_scan("add", values.to(acc_dt), pb)
    zero = torch.zeros((), dtype=acc_dt, device=values.device)
    nonempty = end >= start
    end_v = torch.where(nonempty, prefix[end.clamp(0, n - 1)], zero)
    start_v = torch.where(nonempty & (start > part_start),
                          prefix[(start - 1).clamp(0, n - 1)], zero)
    return end_v - start_v


def sparse_table_bytes(n: int, itemsize: int) -> int:
    """Bytes of ``_range_reduce``'s tables over ``n`` values."""
    return (_table_steps(n) + 1) * n * itemsize


def _table_steps(n: int) -> int:
    return max(1, (max(n, 2) - 1).bit_length())


def _range_reduce(vals: torch.Tensor, kind: str, start: torch.Tensor,
                  end: torch.Tensor) -> torch.Tensor:
    """Frame min or max over absolute per-row bounds via a doubling
    sparse table: ``table[j][i]`` reduces [i, i + 2^j - 1] (clamped at
    the tail), and a frame [s, e] is the reduction of ``table[k][s]``
    and ``table[k][e - 2^k + 1]``, 2^k the largest power of two not
    above its length.  The two windows overlap (min and max are
    idempotent) and lie inside [s, e], so never cross a partition."""
    n = int(vals.shape[0])
    steps = _table_steps(n)
    combine = torch.minimum if kind == "min" else torch.maximum
    i = torch.arange(n, device=vals.device)
    table = torch.empty((steps + 1, n), dtype=vals.dtype,
                        device=vals.device)
    table[0] = vals
    step = 1
    for j in range(1, steps + 1):
        prev = table[j - 1]
        table[j] = combine(prev, prev[torch.clamp(i + step, max=n - 1)])
        step *= 2
    flat = table.view(-1)
    ln = torch.clamp(end - start + 1, min=1)
    k = torch.zeros_like(ln)
    for j in range(1, steps + 1):
        k += (ln >= (1 << j)).to(ln.dtype)
    a = flat[k * n + start.clamp(0, n - 1)]
    b = flat[k * n + (end - (1 << k) + 1).clamp(0, n - 1)]
    return combine(a, b)


def _frame_bounds_rows(i, rn, pb, lo: int, hi: int):
    """Absolute [start, end] of a ROWS frame [i + lo, i + hi], clamped
    to the row's partition."""
    part_start = i - (rn - 1)
    part_len = broadcast_last(rn, pb)
    part_end = part_start + part_len - 1
    start = torch.minimum(torch.maximum(i + lo, part_start), part_end + 1)
    end = torch.minimum(torch.maximum(i + hi, part_start - 1), part_end)
    return start, end, part_start


def _eval_bounded(wf: L.WindowFunctionSpec, data_s, valid_s, contrib, pb,
                  rn, range_bounds) -> DeviceColumn:
    """An aggregate over a ``rows_bounded`` or ``range_bounded`` frame."""
    kind = wf.kind
    n = int(data_s.shape[0])
    if wf.frame == "rows_bounded":
        i = torch.arange(n, device=data_s.device)
        start, end, part_start = _frame_bounds_rows(
            i, rn, pb, wf.frame_lo, wf.frame_hi)
    else:
        start, end, part_start = range_bounds

    def rsum(vals, acc_dt):
        return _range_sum(vals, pb, start, end, part_start, acc_dt)

    def cnt(mask):
        return rsum(mask.to(torch.int64), torch.int64)

    n_contrib = cnt(contrib)
    if kind == "count":
        return DeviceColumn(T.LongT, n_contrib, None)
    if kind == "first":
        # the frame's first row, a null included
        pos = start.clamp(0, n - 1)
        return DeviceColumn(wf.dtype, data_s[pos],
                            valid_s[pos] & (end >= start))
    if kind in ("min", "max"):
        vals, isn = _extreme_input(data_s, wf.dtype, contrib, kind)
        agg = _range_reduce(vals, kind, start, end)
        if isn is not None:
            agg = _extreme_nan(kind, agg, n_contrib, cnt(contrib & ~isn),
                               cnt(contrib & isn))
        return DeviceColumn(wf.dtype, agg.to(data_s.dtype), n_contrib > 0)

    def frame_sum(acc_dt):
        """Bounded-frame sum, NaN and Inf safe: a prefix difference over
        a poisoned prefix would turn NaN - NaN or Inf - Inf into NaN in
        frames that EXCLUDE the special row, so the special values are
        counted per frame (integer prefixes cannot poison) and the sum
        runs over finite values only."""
        v = data_s.to(acc_dt)
        zero = torch.zeros((), dtype=acc_dt, device=v.device)
        if not acc_dt.is_floating_point:
            return rsum(torch.where(contrib, v, zero), acc_dt)
        isnan, ispinf, isninf = (torch.isnan(v), torch.isposinf(v),
                                 torch.isneginf(v))
        finite = contrib & ~(isnan | ispinf | isninf)
        s = rsum(torch.where(finite, v, zero), acc_dt)
        n_nan, n_pinf, n_ninf = (cnt(contrib & isnan), cnt(contrib & ispinf),
                                 cnt(contrib & isninf))
        s = torch.where(n_pinf > 0, float("inf"), s)
        s = torch.where(n_ninf > 0, float("-inf"), s)
        return torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)),
                           float("nan"), s)

    if kind == "sum":
        return DeviceColumn(wf.dtype, frame_sum(torch_dtype(wf.dtype)),
                            n_contrib > 0)
    if kind == "avg":
        s = frame_sum(torch.float64)
        denom = torch.where(n_contrib > 0, n_contrib, 1)
        return DeviceColumn(T.DoubleT, s / denom.to(torch.float64),
                            n_contrib > 0)
    raise NotImplementedError(f"bounded-frame window {kind}")  # tagged out


def _eval_agg(wf: L.WindowFunctionSpec, data_s, valid_s, live_s, pb,
              peer_b, rn, range_bounds=None) -> DeviceColumn:
    kind, frame = wf.kind, wf.frame
    contrib = valid_s & live_s
    if frame in ("rows_bounded", "range_bounded"):
        return _eval_bounded(wf, data_s, valid_s, contrib, pb, rn,
                             range_bounds)

    def proj(x):
        """Frame projection: running value -> the row's frame value."""
        if frame == "rows_current":
            return x
        return broadcast_last(x, peer_b if frame == "range_current" else pb)

    n_contrib = proj(segmented_scan("add", contrib.to(torch.int64), pb))
    if kind == "count":
        return DeviceColumn(T.LongT, n_contrib, None)
    if kind == "sum":
        s = proj(_scan_sum(data_s, contrib, pb, torch_dtype(wf.dtype)))
        return DeviceColumn(wf.dtype, s, n_contrib > 0)
    if kind == "avg":
        s = proj(_scan_sum(data_s, contrib, pb, torch.float64))
        denom = torch.where(n_contrib > 0, n_contrib, 1)
        return DeviceColumn(T.DoubleT, s / denom.to(torch.float64),
                            n_contrib > 0)
    if kind in ("min", "max"):
        agg, n_real, any_nan = _scan_minmax(data_s, contrib, pb, kind,
                                            wf.dtype)
        agg = proj(agg)
        if n_real is not None:
            agg = _extreme_nan(kind, agg, n_contrib, proj(n_real),
                               proj(any_nan))
        return DeviceColumn(wf.dtype, agg.to(data_s.dtype), n_contrib > 0)
    if kind == "first":
        # the partition's first row: the same in all three frames, each
        # of which starts unbounded preceding
        return DeviceColumn(wf.dtype, segmented_scan("first", data_s, pb),
                            segmented_scan("first", valid_s, pb))
    raise NotImplementedError(f"window aggregate {kind}")


def _ranking(wf: L.WindowFunctionSpec, pb, peer_b, rn) -> DeviceColumn:
    """row_number, rank, dense_rank, percent_rank, cume_dist, ntile."""
    kind = wf.kind
    if kind == "row_number":
        return DeviceColumn(wf.dtype, rn, None)
    if kind == "rank":
        return DeviceColumn(wf.dtype, segmented_scan("first", rn, peer_b),
                            None)
    if kind == "dense_rank":
        return DeviceColumn(
            wf.dtype, segmented_scan("add", peer_b.to(torch.int32), pb),
            None)
    b = int(rn.shape[0])
    i = torch.arange(b, dtype=torch.int32, device=rn.device)
    part_len = broadcast_last(rn, pb)
    if kind == "percent_rank":
        rank = segmented_scan("first", rn, peer_b)
        denom = torch.clamp(part_len - 1, min=1)
        v = torch.where(part_len > 1, (rank - 1).to(torch.float64)
                        / denom.to(torch.float64), 0.0)
        return DeviceColumn(wf.dtype, v, None)
    if kind == "cume_dist":
        part_start = i - (rn - 1)
        pe = broadcast_last(i, peer_b)
        v = ((pe - part_start + 1).to(torch.float64)
             / part_len.to(torch.float64))
        return DeviceColumn(wf.dtype, v, None)
    # ntile(n): the first (len % n) buckets get (len // n + 1) rows
    nb = int(wf.offset)
    q = torch.div(part_len, nb, rounding_mode="floor")
    r = part_len % nb
    size1 = q + 1
    cutoff = r * size1
    rn0 = rn - 1
    bucket = torch.where(
        rn0 < cutoff,
        torch.div(rn0, torch.clamp(size1, min=1), rounding_mode="floor"),
        r + torch.div(rn0 - cutoff, torch.clamp(q, min=1),
                      rounding_mode="floor")) + 1
    return DeviceColumn(wf.dtype, bucket.to(torch.int32), None)


def _offset_fn(wf: L.WindowFunctionSpec, data_s, valid_s, lengths_s,
               live_s, pb, rn) -> DeviceColumn:
    """lag and lead: a shift with the in-partition test, or, under
    IGNORE NULLS, the k-th valid neighbour by pointer doubling."""
    b = int(rn.shape[0])
    k = int(wf.offset)
    if k >= b:  # past the batch: every row's result is null
        return DeviceColumn(
            wf.dtype, torch.zeros_like(data_s),
            torch.zeros((b,), dtype=torch.bool, device=data_s.device),
            None if lengths_s is None else torch.zeros_like(lengths_s))
    if k == 0:
        return DeviceColumn(wf.dtype, data_s, valid_s & live_s, lengths_s)
    if wf.ignore_nulls:
        tgt = _kth_valid(wf.kind == "lag", valid_s & live_s, pb, k)
        pos = tgt.clamp(0, b - 1)
        return DeviceColumn(wf.dtype, data_s[pos], tgt >= 0,
                            None if lengths_s is None else lengths_s[pos])

    def shift(x, fill):
        pad = torch.full((k,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        if wf.kind == "lag":
            return torch.cat([pad, x[:-k]])
        return torch.cat([x[k:], pad])

    if wf.kind == "lag":
        in_part = rn > k
    else:
        # the target row is in the partition iff its row number is ours
        # plus k (the next partition, or the dead rows, restart at 1)
        in_part = shift(rn, -1) == rn + k
    sd = shift(data_s, 0)
    sv = shift(valid_s, False) & in_part
    sl = None if lengths_s is None else shift(lengths_s, 0)
    return DeviceColumn(wf.dtype, sd, sv, sl)


def _kth_valid(lag: bool, ok: torch.Tensor, pb: torch.Tensor,
               k: int) -> torch.Tensor:
    """Row index of each row's k-th valid neighbour in its partition
    (behind it for lag, ahead for lead; -1 where there is none): the
    previous valid index from a segmented running max of masked
    indices, composed k times by pointer doubling (O(log k) gathers,
    never k)."""
    b = int(ok.shape[0])
    idx = torch.arange(b, device=ok.device)

    def prev_valid(okm, pbm):
        last = segmented_scan("max_index", torch.where(okm, idx, -1), pbm)
        prev = torch.full_like(last, -1)
        prev[1:] = last[:-1]
        return torch.where(pbm, -1, prev)

    if lag:
        p1 = prev_valid(ok, pb)
    else:
        is_end = torch.ones_like(pb)
        is_end[:-1] = pb[1:]
        p1 = torch.flip(prev_valid(torch.flip(ok, [0]),
                                   torch.flip(is_end, [0])), [0])
        p1 = torch.where(p1 >= 0, b - 1 - p1, -1)

    def compose(f, g):
        return torch.where(f >= 0, g[f.clamp(0, b - 1)], -1)

    tgt, hop, rem = p1, p1, k - 1
    while rem:
        if rem & 1:
            tgt = compose(tgt, hop)
        rem >>= 1
        if rem:
            hop = compose(hop, hop)
    return tgt


def _eval_window_fn(wf: L.WindowFunctionSpec, batch: DeviceBatch,
                    perm, live_s, pb, peer_b, rn,
                    range_bounds=None) -> DeviceColumn:
    if wf.kind in ("row_number", "rank", "dense_rank", "percent_rank",
                   "cume_dist", "ntile"):
        return _ranking(wf, pb, peer_b, rn)
    c = wf.child.eval(batch)
    data_s = c.data[perm]
    valid_s = c.valid_mask()[perm]
    lengths_s = None if c.lengths is None else c.lengths[perm]
    if wf.kind in ("lag", "lead"):
        return _offset_fn(wf, data_s, valid_s, lengths_s, live_s, pb, rn)
    return _eval_agg(wf, data_s, valid_s, live_s, pb, peer_b,
                     rn.to(torch.int64), range_bounds)


def _compute_range_bounds(batch: DeviceBatch, order: L.SortOrder, perm,
                          pb, peer_b, rn, specs):
    """Per-row absolute [start, end] of each RANGE offset frame.

    The frame of row i holds the rows of i's partition whose ORDER value
    lies in [v_i + lo, v_i + hi]: a lexicographic binary search
    (``exec/join.py::_lex_search``) over a 3-limb monotone encoding of
    the sorted rows, (partition ordinal, null flag, biased order
    value).  A row whose order value is null takes its peer group as its
    frame (Spark's RANGE semantics); an unbounded end clamps to the
    partition."""
    from spark_rapids_tpu_torch.exec.join import _lex_search
    b = int(rn.shape[0])
    dev = rn.device
    i = torch.arange(b, device=dev)
    part_start = i - (rn - 1)
    part_end = part_start + broadcast_last(rn, pb) - 1
    ps = segmented_scan("first", i, peer_b)
    pe = broadcast_last(i, peer_b)

    c = order.expr.eval(batch)
    vals = c.data[perm].to(torch.int64)
    ovalid = c.valid_mask()[perm]
    pid_ord = torch.cumsum(pb.to(torch.int64), 0)
    null_limb = (ovalid if order.nulls_first else ~ovalid).to(torch.int64)
    q_null = torch.full((b,), 1 if order.nulls_first else 0,
                        dtype=torch.int64, device=dev)
    imax, imin = (1 << 63) - 1, -(1 << 63)

    def sat_add(v, off: int):
        """Saturating v + off: a wrapped bound would fall before the
        partition's values and empty every frame near the extremes (the
        CPU oracle compares exact Python ints; saturation agrees with
        it, as the bound only has to dominate every value)."""
        if off >= 0:
            return torch.where(v > imax - off, imax, v + off)
        return torch.where(v < imin - off, imin, v + off)

    # order-preserving int64 -> u64 bits (held in int64, as every limb)
    table = [pid_ord, null_limb, vals ^ ORD.TOP_BIT]
    out = {}
    for lo, hi in specs:
        if lo is None:
            start = part_start
        else:
            q = [pid_ord, q_null, sat_add(vals, lo) ^ ORD.TOP_BIT]
            start = _lex_search(table, q, "left")
        if hi is None:
            end = part_end
        else:
            q = [pid_ord, q_null, sat_add(vals, hi) ^ ORD.TOP_BIT]
            end = _lex_search(table, q, "right") - 1
        # a null current row: its frame is its peer group
        out[(lo, hi)] = (torch.where(ovalid, start, ps),
                         torch.where(ovalid, end, pe), part_start)
    return out


def window_sort(batch: DeviceBatch, pby: Sequence[Expression],
                orders: Sequence[L.SortOrder]):
    """The node's one stable sort, dead rows last: (sorted limbs,
    permutation, how many of the limbs are the partition's)."""
    pparts = ([ORD._flag_part(~batch.sel)]
              + ORD.batch_group_parts([e.eval(batch) for e in pby]))
    oparts = []
    for o in orders:
        oparts.extend(ORD.column_order_parts(o.expr.eval(batch),
                                             o.ascending, o.nulls_first))
    limbs_p = ORD.fuse_parts(pparts)
    sorted_limbs, perm = ORD.sort_by_keys(limbs_p + ORD.fuse_parts(oparts))
    return sorted_limbs, perm, len(limbs_p)


def _window_impl(batch: DeviceBatch, pby: Sequence[Expression],
                 orders: Sequence[L.SortOrder],
                 fns: Sequence[L.WindowFunctionSpec],
                 out_schema: T.StructType) -> DeviceBatch:
    b = batch.capacity
    sorted_limbs, perm, n_lp = window_sort(batch, pby, orders)
    live_s = batch.sel[perm]

    pb = _limb_diff(sorted_limbs[:n_lp])
    pb[0] = True
    peer_b = pb.clone()
    if n_lp < len(sorted_limbs):
        peer_b |= _limb_diff(sorted_limbs[n_lp:])
    rn = segmented_scan("add", torch.ones((b,), dtype=torch.int32,
                                          device=batch.device), pb)

    range_specs = {(wf.frame_lo, wf.frame_hi) for wf in fns
                   if wf.frame == "range_bounded"}
    range_bounds = {}
    if range_specs:
        range_bounds = _compute_range_bounds(
            batch, orders[0], perm, pb, peer_b, rn.to(torch.int64),
            sorted(range_specs, key=repr))

    out_cols: List[DeviceColumn] = [c.gather(perm) for c in batch.columns]
    for wf in fns:
        rb = (range_bounds.get((wf.frame_lo, wf.frame_hi))
              if wf.frame == "range_bounded" else None)
        out_cols.append(_eval_window_fn(wf, batch, perm, live_s, pb,
                                        peer_b, rn, rb))
    count = live_s.sum()
    sel = torch.arange(b, device=batch.device) < count
    return DeviceBatch(out_schema, tuple(out_cols), sel, compacted=True)


def _table_bytes(fns: Sequence[L.WindowFunctionSpec], n: int) -> int:
    """Bytes of the sparse tables the bounded min and max build over a
    batch of ``n`` rows (integers reduce as int64 or their own width,
    floats as themselves, booleans as int64)."""
    total = 0
    for wf in fns:
        if wf.kind in ("min", "max") and wf.frame in ("rows_bounded",
                                                      "range_bounded"):
            dt = wf.dtype
            item = (8 if isinstance(dt, T.BooleanType)
                    else torch.empty((), dtype=torch_dtype(dt)).element_size())
            total += sparse_table_bytes(n, item)
    return total


class TpuWindowExec(TpuExec):
    """[REF: GpuWindowExec] — the whole Window node over one batch.  Its
    ``reservedBytes`` metric is the arbiter reservation it held."""

    def __init__(self, partition_by: Sequence[Expression],
                 order_by: Sequence[L.SortOrder],
                 fns: Sequence[L.WindowFunctionSpec],
                 schema: T.StructType, child: TpuExec,
                 partitioned: bool = False):
        super().__init__(schema, child)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.fns = list(fns)
        # downstream of a hash exchange on partition_by: each exchange
        # partition owns disjoint window-partition keys, so the window
        # runs per partition (the distributed plan shape)
        self.partitioned = partitioned

    def node_string(self):
        parts = ", ".join(str(e) for e in self.partition_by)
        fns = ", ".join(f.kind for f in self.fns)
        mode = " partitioned" if self.partitioned else ""
        return f"TpuWindow{mode} [partitionBy=[{parts}] fns=[{fns}]]"

    def num_partitions(self) -> int:
        if self.partitioned:
            return self.children[0].num_partitions()
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.runtime.memory import get_manager
        child = self.children[0]
        parts = ([partition] if self.partitioned
                 else range(child.num_partitions()))
        batches = [compact(b) for p in parts for b in child.execute(p)]
        if not batches:
            return
        with self.timer():
            merged = concat_device_batches(child.schema, batches)
            del batches
            need = (2 * merged.nbytes()
                    + _table_bytes(self.fns, merged.capacity))
            with get_manager().transient(need):
                out = _window_impl(merged, self.partition_by, self.order_by,
                                   self.fns, self.schema)
        self.metric("numOutputBatches").add(1)
        self.metric("reservedBytes").add(need)
        yield out


# ---------------------------------------------------------------------------
# CPU oracle
# ---------------------------------------------------------------------------

_AGG_CLS = {"sum": A.Sum, "min": A.Min, "max": A.Max, "count": A.Count,
            "avg": A.Average, "first": A.First}


class CpuWindowExec(CpuExec):
    """Numpy and row-loop oracle: the device path's sort-key encoding
    (so the output rows come in the same order), then each function
    evaluated in Python partition by partition."""

    def __init__(self, partition_by: Sequence[Expression],
                 order_by: Sequence[L.SortOrder],
                 fns: Sequence[L.WindowFunctionSpec],
                 schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.fns = list(fns)

    def node_string(self):
        fns = ", ".join(f.kind for f in self.fns)
        return f"Window [fns=[{fns}]]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child = self.children[0]
        batches = [b for p in range(child.num_partitions())
                   for b in child.execute(p)]
        if not batches:
            return
        merged = _concat_host(child.schema, batches)
        n = merged.num_rows
        limbs_p: List[np.ndarray] = []
        for e in self.partition_by:
            c = e.eval_cpu(merged)
            data = c.data
            if _is_float(c.dtype):
                data = data + 0.0  # group semantics: -0.0 == 0.0
            limbs_p.extend(ORD.np_order_keys(data, c.validity, c.dtype,
                                             True, True))
        limbs_o: List[np.ndarray] = []
        for o in self.order_by:
            c = o.expr.eval_cpu(merged)
            limbs_o.extend(ORD.np_order_keys(c.data, c.validity, c.dtype,
                                             o.ascending, o.nulls_first))
        iota = np.arange(n, dtype=np.int64).view(np.uint64)
        perm = np.lexsort(list(reversed(limbs_p + limbs_o + [iota])))

        def diff(limbs):
            d = np.zeros(n, bool)
            for l in limbs:
                ls = l[perm]
                d[1:] |= ls[1:] != ls[:-1]
            return d

        pb = diff(limbs_p)
        pb[0] = True
        peer_b = pb | diff(limbs_o)
        peer_b[0] = True
        out_cols = [H.HostCol(c.dtype, c.data[perm],
                              None if c.validity is None
                              else c.validity[perm])
                    for c in merged.columns]
        for wf in self.fns:
            out_cols.append(self._eval_fn(wf, merged, perm, pb, peer_b))
        yield H.HostBatch(self.schema, out_cols)

    def _eval_fn(self, wf: L.WindowFunctionSpec, merged: H.HostBatch,
                 perm, pb, peer_b) -> H.HostCol:
        n = len(perm)
        vals: List[object] = [None] * n
        vc = None
        if wf.child is not None:
            c = wf.child.eval_cpu(merged)
            vc = H.HostCol(c.dtype, c.data[perm],
                           None if c.validity is None else c.validity[perm])
        starts = list(np.flatnonzero(pb)) + [n]
        for si in range(len(starts) - 1):
            lo, hi = int(starts[si]), int(starts[si + 1])
            peers = [i for i in range(lo, hi) if peer_b[i] or i == lo]
            peers.append(hi)
            _eval_partition(wf, vals, vc, lo, hi, peers,
                            self.order_by, merged, perm)
        return _vals_to_col(vals, wf.dtype)


def _eval_partition(wf, vals, vc, lo: int, hi: int, peers, order_by,
                    merged, perm) -> None:
    """One partition [lo, hi) of one function into ``vals``; ``peers``
    are its peer groups' starts, then ``hi``."""
    from spark_rapids_tpu_torch.exec.aggregate import (
        _acc_final, _acc_update, _new_acc)
    kind = wf.kind
    plen = hi - lo
    groups = [(peers[g], peers[g + 1]) for g in range(len(peers) - 1)]
    if kind == "row_number":
        for i in range(lo, hi):
            vals[i] = i - lo + 1
    elif kind in ("rank", "dense_rank", "percent_rank", "cume_dist"):
        for g, (a, z) in enumerate(groups):
            for i in range(a, z):
                if kind == "rank":
                    vals[i] = a - lo + 1
                elif kind == "dense_rank":
                    vals[i] = g + 1
                elif kind == "percent_rank":
                    vals[i] = (a - lo) / (plen - 1) if plen > 1 else 0.0
                else:
                    vals[i] = (z - lo) / plen
    elif kind == "ntile":
        q, r = divmod(plen, wf.offset)
        for i in range(lo, hi):
            rn0 = i - lo
            if rn0 < r * (q + 1):
                vals[i] = rn0 // (q + 1) + 1
            else:
                vals[i] = r + (rn0 - r * (q + 1)) // max(q, 1) + 1
    elif kind in ("lag", "lead") and wf.ignore_nulls:
        step = -1 if kind == "lag" else 1
        for i in range(lo, hi):
            remaining, src = wf.offset, i
            while remaining > 0:
                src += step
                if not lo <= src < hi:
                    src = None
                    break
                if vc.validity is None or bool(vc.validity[src]):
                    remaining -= 1
            if src is not None:
                vals[i] = vc.data[src]
    elif kind in ("lag", "lead"):
        k = wf.offset if kind == "lag" else -wf.offset
        for i in range(lo, hi):
            src = i - k
            if lo <= src < hi and (vc.validity is None
                                   or bool(vc.validity[src])):
                vals[i] = vc.data[src]
    elif wf.frame == "rows_bounded":
        fobj = _AGG_CLS[kind](wf.child)
        for i in range(lo, hi):
            acc = _new_acc()
            for j in range(max(lo, i + wf.frame_lo),
                           min(hi - 1, i + wf.frame_hi) + 1):
                _acc_update(acc, fobj, vc, j)
            vals[i] = _acc_final(acc, fobj)
    elif wf.frame == "range_bounded":
        _range_partition(wf, vals, vc, lo, hi, groups, order_by[0],
                         merged, perm)
    else:  # running and whole-partition aggregates
        fobj = _AGG_CLS[kind](wf.child)
        acc = _new_acc()
        if wf.frame == "rows_current":
            for i in range(lo, hi):
                _acc_update(acc, fobj, vc, i)
                vals[i] = _acc_final(acc, fobj)
        elif wf.frame == "range_current":
            for a, z in groups:
                for i in range(a, z):
                    _acc_update(acc, fobj, vc, i)
                v = _acc_final(acc, fobj)
                for i in range(a, z):
                    vals[i] = v
        else:
            for i in range(lo, hi):
                _acc_update(acc, fobj, vc, i)
            v = _acc_final(acc, fobj)
            for i in range(lo, hi):
                vals[i] = v


def _range_partition(wf, vals, vc, lo: int, hi: int, groups,
                     order: L.SortOrder, merged, perm) -> None:
    """A RANGE offset frame over one partition, by exact Python ints."""
    from spark_rapids_tpu_torch.exec.aggregate import (
        _acc_final, _acc_update, _new_acc)
    fobj = _AGG_CLS[wf.kind](wf.child)
    oc = order.expr.eval_cpu(merged)
    ov = oc.data[perm]
    ovalid = (np.ones(len(perm), bool) if oc.validity is None
              else oc.validity[perm])
    nf = order.nulls_first
    # offsets are in ORDER direction: under DESC, "x preceding" means
    # LARGER values, so the value window flips to [v - hi, v - lo]
    if order.ascending:
        vlo, vhi = wf.frame_lo, wf.frame_hi
    else:
        vlo = None if wf.frame_hi is None else -wf.frame_hi
        vhi = None if wf.frame_lo is None else -wf.frame_lo
    for a, z in groups:
        for i in range(a, z):
            acc = _new_acc()
            if not ovalid[i]:
                frame = range(a, z)  # a null order key: its peer group
            else:
                v = int(ov[i])
                frame = []
                for j in range(lo, hi):
                    if ovalid[j]:
                        if ((vlo is None or int(ov[j]) >= v + vlo)
                                and (vhi is None or int(ov[j]) <= v + vhi)):
                            frame.append(j)
                    # an unbounded end reaches that side's nulls
                    elif ((nf and wf.frame_lo is None)
                          or (not nf and wf.frame_hi is None)):
                        frame.append(j)
            for j in frame:
                _acc_update(acc, fobj, vc, j)
            vals[i] = _acc_final(acc, fobj)


def _vals_to_col(vals: List[object], dt: T.DataType) -> H.HostCol:
    from spark_rapids_tpu_torch.ops import decimal128 as D128
    validity = np.array([v is not None for v in vals], bool)
    if isinstance(dt, (T.StringType, T.BinaryType)):
        data = np.array([v if v is not None else "" for v in vals],
                        dtype=object)
    elif D128.is128(dt):
        data = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            w = 0 if v is None else int(v)
            if v is not None and not D128.py_fits(w, dt.precision):
                validity[i] = False
                w = 0
            data[i] = w
    else:
        data = np.array([v if v is not None else 0 for v in vals])
        data = data.astype(T.to_numpy_dtype(dt), copy=False)
    return H.HostCol(dt, data, None if validity.all() else validity)


# ---------------------------------------------------------------------------
# The plan-rewrite rule
# ---------------------------------------------------------------------------

def _tag_window(meta):
    from spark_rapids_tpu_torch.ops.decimal128 import is128
    cpu: CpuWindowExec = meta.cpu
    meta.tag_expressions(cpu.partition_by)
    meta.tag_expressions([o.expr for o in cpu.order_by])
    for wf in cpu.fns:
        if wf.kind not in WINDOW_KINDS:
            meta.will_not_work(
                f"window function {wf.kind} has no TPU implementation")
            continue
        if wf.frame == "range_bounded" and not cpu.order_by[0].ascending:
            meta.will_not_work(
                "RANGE offset frames over a descending ORDER BY key "
                "not yet supported on device (the bound search encodes "
                "ascending order)")
        if wf.child is not None:
            meta.tag_expressions([wf.child])
            if is128(wf.child.dtype) or is128(wf.dtype):
                meta.will_not_work(
                    f"window {wf.kind} over/into decimal128 not yet "
                    "on device (1-D scan kernels lack the carry; a "
                    "small-decimal SUM widens past 18 digits)")
            if wf.kind in ("min", "max", "first") and isinstance(
                    wf.child.dtype, (T.StringType, T.BinaryType)):
                meta.will_not_work(
                    f"window {wf.kind} over "
                    f"{wf.child.dtype.simple_name} input not yet "
                    "supported on device (string scan buffers)")


def _convert_window(cpu: CpuWindowExec, ch, conf, device):
    from spark_rapids_tpu_torch.exec.distributed import (
        TpuIciShuffleExchangeExec, exchange_opts, hashable_on_device,
        ici_active)
    if (ici_active(conf, device) and cpu.partition_by
            and all(hashable_on_device(e.dtype)
                    for e in cpu.partition_by)):
        # distributed: hash-exchange on partition_by — each exchange
        # partition owns disjoint window-partition keys [REF:
        # GpuWindowExec under Spark's required ClusteredDistribution]
        ex = TpuIciShuffleExchangeExec(ch[0], cpu.partition_by,
                                       device=device, **exchange_opts(conf))
        return TpuWindowExec(cpu.partition_by, cpu.order_by, cpu.fns,
                             cpu.schema, ex, partitioned=True)
    return TpuWindowExec(cpu.partition_by, cpu.order_by, cpu.fns,
                         cpu.schema, ch[0])
