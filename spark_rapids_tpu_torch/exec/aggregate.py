"""Hash-aggregate exec (complete, partial and final modes) and the
device group-by.

[REF: sql-plugin/../GpuAggregateExec.scala :: GpuHashAggregateExec,
 AggHelper]

The counterpart of the JAX package's ``exec/aggregate.py``: sum, min,
max, count, count(*), avg, first and the variance family, grouped or
global (and a group-by with no aggregate, the dedup below a
count(DISTINCT)), in complete mode (update per input batch of every
input partition -> merge the partials -> final projection), or split
around an ICI exchange into a per-partition partial (update + local
merge into buffer batches) and final (merge the received buffers +
final projection).  The
holistic functions (percentile, approx_percentile, and min, max and
first over strings, whose values cannot ride one buffer limb through
the merge) take the JAX package's gathered single pass instead
(``is_holistic_fn``, ``TpuHashAggregateExec._execute_collect``): every
input batch concatenated, then one stable sort per function on
(exclusion, keys, contribution, value) and a gather per group.

``collect_list`` and ``collect_set`` take that pass too: one sort on
(exclusion, keys, contribution[, value]) makes each group's values
contiguous, and a shifted gather per group fills a padded ``[G, cap]``
element matrix, ``cap`` the power of two of the largest group
(``segment_max_group_count``, one host read), as the JAX package does.

The group-by keeps the JAX package's layout and protocol: key limbs
from ``ops/ordering.py``; a group layout from the kernel plane (the
hash-grouped layout whose row hash is the CUDA kernel, or the exact
full-key sort); live groups compacted to the front of a batch of
unchanged capacity, in group order.  What differs is the reduction: the
JAX package reduces with segmented ``associative_scan``s (scatter is
serial on a TPU); here every row adds into its group's slot keyed by
group id (``scatter_reduce_`` for min and max, with the JAX package's
NaN rules: NaN is the greatest value; ``first`` is the least row
position of each group, an ``amin`` that no atomic order can change,
then a gather).  A cumulative-sum difference is
deliberately not used for float sums — at 2^20 rows the running total
reaches ~5e9 and the cancellation would ruin small groups.

Float sums must be deterministic, as the JAX package's scans are: a
query that runs one subtree twice (TPC-H q15 filters a grouped sum by
its own max) compares the two runs' sums exactly.  On a CUDA device
``index_add_`` adds in atomic order, which varies from run to run in
the last ulp, so float sums take ``torch.segment_reduce`` over the rows
in group order instead (a segmented tree reduction, the same order in
every run); integer sums and counts stay ``index_add_``, which is exact
in any order.  (``index_put_(accumulate=True)`` is deterministic too,
but adds a group's rows one after another: slow where groups are few.)
Float sums differ in the last ulps from the JAX package's scan order;
counts and keys are exact.  A decimal128 sum (every decimal sum past
18 digits: ``decimal(p+10, s)``) splits each value's bit pattern into
four 32-bit limbs held in int64, adds each limb per group with the
integer ``index_add_`` (exact in any order while a group has fewer
than 2^31 rows) and propagates the carries once per group, mod 2^128:
the bits of the JAX package's carry-aware associative scan.  The
keyless path sums the same limbs (the JAX package's keyless decimal
sum fails on its device path; ROADMAP C.4), and the final projection
nulls a sum past its precision.

``CpuAggregateExec`` is the JAX package's CPU oracle for the same
functions: a dict of groups in first-seen order, updated row by row in
Python (the variance family by Welford's update, as Spark's
CentralMomentAgg; decimal sums in exact Python ints, wrapped mod 2^128
and nulled past their precision), finals as Spark defines them.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, empty_batch, torch_dtype)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec, fuse_upstream
from spark_rapids_tpu_torch.exec.basic import (
    concat_device_batches, live_counts)
from spark_rapids_tpu_torch.ops import decimal128 as D128
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.ops.aggregates import (
    AggregateFunction, ApproxPercentile, Average, CollectList, CollectSet,
    Count, CountStar, First, Max, Min, Percentile, Sum, _VarianceBase)
from spark_rapids_tpu_torch.ops.expressions import BoundReference, Expression
from spark_rapids_tpu_torch.ops.hashing import make_pid_fn
from spark_rapids_tpu_torch.parallel.shuffle import split_to_spillables
from spark_rapids_tpu_torch.runtime.memory import (
    RetryOOM, get_manager, with_retry)

# the repartitioned merge's bucket hash seed ("AGRB")
AGG_SEED = 0x41475242


# ---------------------------------------------------------------------------
# The device group-by
# ---------------------------------------------------------------------------

def segment_groupby(
    key_cols: Sequence[DeviceColumn],
    sel: torch.Tensor,
    value_cols: Sequence[Tuple[DeviceColumn, str]],
    backend: str = "jnp",
) -> Tuple[List[DeviceColumn], List[DeviceColumn], torch.Tensor,
           Optional[torch.Tensor]]:
    """Group rows by keys; reduce values by kind ('sum', 'min', 'max',
    'first').

    Returns (out_key_cols, out_value_cols, out_sel, ok) — live groups
    compacted to the front in group order, capacity unchanged.

    ``backend`` selects the group layout: ``cuda`` sorts ONE 64-bit hash
    of the key limbs (kernels.hash_agg; group order = hash order), ``jnp``
    the full fused key encoding.  ``ok`` follows the kernel-plane
    protocol: None when the exact layout ran; a device bool (False =
    64-bit hash collision, the caller must redo the batch on the exact
    layout) from the hash layout.
    """
    b = int(sel.shape[0])
    dev = sel.device
    limbs, key_limbs = ORD.group_sort_limbs(list(key_cols), sel)
    okf = None
    res = None
    if backend != "jnp":
        from spark_rapids_tpu_torch.kernels import hash_agg as KNA
        res = KNA.group_layout_fused(key_limbs,
                                     use_kernel=(backend == "cuda"))
    if res is not None:
        perm, _, boundary, okf = res
    else:
        sorted_limbs, perm = ORD.sort_by_keys(limbs)
        boundary = torch.zeros((b,), dtype=torch.bool, device=dev)
        for l in sorted_limbs:
            boundary[1:] |= ORD.limb_neq(l[1:], l[:-1])
        boundary[0] = True  # row 0 always starts a group

    # group id of every sorted row, and of every input row
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    gid_row = torch.empty_like(gid)
    gid_row[perm] = gid
    batcher = _ScanBatcher(gid_row, b, perm, gid)
    nlive = batcher.add("add", sel.to(torch.int64), key="live")
    size = batcher.add("add", torch.ones_like(gid), key="size")
    plans = []
    for ci, (c, kind) in enumerate(value_cols):
        if kind == "first":
            # the group's first row in input order, a null included
            plans.append({"c": c, "kind": kind, "n_contrib": nlive,
                          "agg": batcher.add("first", torch.arange(
                              b, device=dev), key="position")})
            continue
        if c.validity is None:
            contrib, ckey = sel, "live"  # shared count for non-null inputs
        else:
            contrib, ckey = sel & c.validity, ("col", ci)
        e = {"c": c, "kind": kind,
             "n_contrib": batcher.add("add", contrib.to(torch.int64),
                                      key=ckey)}
        if kind == "sum" and c.data.dim() == 2:
            # decimal128: each 32-bit limb of the bit patterns sums on
            # its own (exact), the carries propagate once per group
            e["limbs"] = [batcher.add("add", l) for l in D128.limbs32(
                torch.where(contrib[:, None], c.data, 0))]
        elif kind == "sum":
            e["agg"] = batcher.add("add", torch.where(
                contrib, c.data, torch.zeros((), dtype=c.data.dtype,
                                             device=dev)))
        elif kind in ("min", "max"):
            _plan_extreme(batcher, e, contrib)
        else:
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: '{kind}' reduction is not "
                "ported yet")
        plans.append(e)
    batcher.run()

    glive = batcher.get(nlive) > 0
    # a group's END row in sorted order (where the JAX package's
    # segmented scans hold the whole-group result) supplies its keys
    end = torch.cumsum(batcher.get(size), 0) - 1
    # compaction: live groups to the front, in group order
    perm2 = torch.argsort((~glive).to(torch.uint8), stable=True)
    num_groups = glive.sum()
    src = perm[end][perm2]
    out_keys = [c.gather(src) for c in key_cols]
    out_vals = []
    for e in plans:
        n_contrib = batcher.get(e["n_contrib"])
        if "limbs" in e:
            agg = D128.from_limb_sums(*(batcher.get(h) for h in e["limbs"]))
        else:
            agg = batcher.get(e["agg"])
        if e["kind"] == "first":
            row = agg[perm2]
            out_vals.append(DeviceColumn(
                e["c"].dtype, e["c"].data[row],
                e["c"].valid_mask()[row] & (n_contrib[perm2] > 0)))
            continue
        if e["kind"] in ("min", "max"):
            agg = _finish_extreme(batcher, e, agg, n_contrib)
        out_vals.append(DeviceColumn(e["c"].dtype, agg[perm2],
                                     n_contrib[perm2] > 0))
    out_sel = torch.arange(b, device=dev) < num_groups
    return out_keys, out_vals, out_sel, okf


def segmented_scan(op: str, values: torch.Tensor,
                   boundary: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan: row i gets the ``op`` reduction of its
    segment's rows from the segment's start (``boundary`` marks starts)
    to i — the JAX package's ``segmented_scan``, an ``associative_scan``
    there.

    ``op`` is ``"add"``, ``"min"``, ``"max"``, ``"first"`` (each row gets
    its segment's first value) or ``"max_index"`` (a running max of row
    indices, -1 where a row has none).  Integer sums are a cumulative-sum
    difference (``kernels/hash_layout.py::seg_scan``: exact, wrapping as
    the JAX package's int64 scan does); a running max of indices is one
    ``cummax``, held back to -1 before the segment's start.  Float sums,
    and min and max, take a doubling scan that restarts at every
    boundary: log2(n) steps, each combining row i with row i - 2^k when
    both lie in one segment — one fixed order of combination on every
    run, no atomics, and no cancellation across segments (a float
    cumulative-sum difference would subtract the totals of every earlier
    segment).
    """
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    if op == "first":
        return HL.seg_scan(values, boundary, "first")
    if op == "add" and not values.dtype.is_floating_point:
        return HL.seg_scan(values, boundary, "add")
    start = HL._run_starts(boundary)
    if op == "max_index":
        run = torch.cummax(values, 0).values
        return torch.where(run >= start, run, -1)
    fn = {"add": torch.add, "min": torch.minimum,
          "max": torch.maximum}.get(op)
    if fn is None:
        raise ValueError(f"unknown segmented_scan op {op!r}")
    n = int(values.shape[0])
    idx = torch.arange(n, device=values.device)
    v = values
    d = 1
    while d < n:
        inside = (idx[d:] - d) >= start[d:]
        v = torch.cat([v[:d], torch.where(inside, fn(v[:-d], v[d:]),
                                          v[d:])])
        d *= 2
    return v


class _ScanBatcher:
    """Deduplicates segmented reductions over identical inputs.

    The JAX package's batcher shares segmented scans among requests over
    the same logical input (a q1-shaped aggregate asks for the live-row
    count eight times).  Here a request is one ``index_add_`` (``add``;
    ``segment_reduce`` in group order for float sums) or
    ``scatter_reduce_`` (``min``, ``max``; ``first``, an ``amin`` of row
    positions) of the input into its group's slot; ``add`` enqueues with an optional logical-input key
    and returns a handle, ``run`` reduces, ``get`` returns the per-group
    result (indexed by group id).  ``perm`` orders the rows by group and
    ``gid`` is the group id of each row in that order.
    """

    def __init__(self, gid_row: torch.Tensor, num_slots: int,
                 perm: torch.Tensor, gid: torch.Tensor):
        self.gid_row = gid_row
        self.num_slots = num_slots
        self.perm = perm
        self.gid = gid
        self._lengths = None
        self._reqs: List[list] = []  # [tag, array, result]
        self._dedupe = {}

    def _segment_sum(self, arr: torch.Tensor) -> torch.Tensor:
        """Deterministic per-slot sum: a segmented reduction over the
        rows in group order (every slot's rows are contiguous there)."""
        if self._lengths is None:
            self._lengths = torch.bincount(self.gid,
                                           minlength=self.num_slots)
        return torch.segment_reduce(arr[self.perm], "sum",
                                    lengths=self._lengths, initial=0)

    def add(self, tag: str, arr, key=None) -> int:
        if tag not in ("add", "min", "max", "first"):
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: '{tag}' reduction is not ported "
                "yet")
        if key is not None and (tag, key) in self._dedupe:
            return self._dedupe[(tag, key)]
        self._reqs.append([tag, arr, None])
        i = len(self._reqs) - 1
        if key is not None:
            self._dedupe[(tag, key)] = i
        return i

    def run(self) -> None:
        for req in self._reqs:
            tag, arr, _ = req
            if tag == "add":
                if arr.is_floating_point():
                    # one order of addition in every run (module doc)
                    req[2] = self._segment_sum(arr)
                    continue
                out = torch.zeros((self.num_slots,), dtype=arr.dtype,
                                  device=arr.device)
                req[2] = out.index_add_(0, self.gid_row, arr)
                continue
            # min/max over the rows of each slot only (a row that does
            # not contribute carries the reduction's identity); a slot
            # with no row stays 0 and is never a live group
            out = torch.zeros((self.num_slots,), dtype=arr.dtype,
                              device=arr.device)
            req[2] = out.scatter_reduce_(
                0, self.gid_row, arr, "amax" if tag == "max" else "amin",
                include_self=False)

    def get(self, i: int):
        return self._reqs[i][2]


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.FloatType, T.DoubleType))


def _extreme_input(data: torch.Tensor, dt: T.DataType, contrib, kind):
    """(values with the identity of ``kind`` where a row does not
    contribute, NaN rows or None).  Floats follow Spark's total order
    (NaN greatest) as the JAX package does: NaN rows leave the
    reduction and are reinstated by ``_extreme_nan``; other types
    reduce as integers (booleans as 0/1)."""
    if isinstance(dt, (T.StringType, T.BinaryType)):
        # such values take the gathered pass (``is_holistic_fn``)
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: {kind} of {dt} outside the gathered "
            "holistic pass")
    if _is_float(dt):
        isn = torch.isnan(data)
        ident = float("inf") if kind == "min" else float("-inf")
        return torch.where(contrib & ~isn, data, ident), isn
    x = data.to(torch.int64) if isinstance(dt, T.BooleanType) else data
    info = torch.iinfo(x.dtype)
    ident = info.max if kind == "min" else info.min
    return torch.where(contrib, x, ident), None


def _extreme_nan(kind: str, agg, n_contrib, n_real, any_nan):
    """Spark's NaN rule on a float min/max: min is NaN only when every
    contributing value is NaN, max whenever one is."""
    nan = torch.full((), float("nan"), dtype=agg.dtype, device=agg.device)
    if kind == "min":
        return torch.where((n_real == 0) & (n_contrib > 0), nan, agg)
    return torch.where(any_nan > 0, nan, agg)


def _plan_extreme(batcher: "_ScanBatcher", e: dict, contrib) -> None:
    c, kind = e["c"], e["kind"]
    vals, isn = _extreme_input(c.data, c.dtype, contrib, kind)
    e["agg"] = batcher.add(kind, vals)
    if isn is not None:
        e["n_real"] = batcher.add("add", (contrib & ~isn).to(torch.int64))
        e["any_nan"] = batcher.add("add", (contrib & isn).to(torch.int64))


def _finish_extreme(batcher: "_ScanBatcher", e: dict, agg, n_contrib):
    if "n_real" in e:
        return _extreme_nan(e["kind"], agg, n_contrib,
                            batcher.get(e["n_real"]),
                            batcher.get(e["any_nan"]))
    return agg.to(e["c"].data.dtype)


def _reduce_column(data: torch.Tensor, valid: torch.Tensor,
                   live: torch.Tensor, kind: str,
                   dt: T.DataType) -> DeviceColumn:
    """Whole-array masked reduction -> 1-element column, with the same
    semantics as ``segment_groupby`` (sums and extremes of valid live
    rows, NaN greatest; null when no row contributes; 'first' takes the
    first LIVE row's value, a null included)."""
    contrib = valid & live
    one = (1,) + tuple(data.shape[1:])
    if kind == "first":
        has_row = torch.any(live)
        idx = torch.argmax(live.to(torch.uint8))  # the first live row
        v = torch.where(has_row, data[idx], torch.zeros(
            (), dtype=data.dtype, device=data.device))
        return DeviceColumn(dt, v.reshape(one),
                            (valid[idx] & has_row).reshape(1))
    if kind == "sum" and data.dim() == 2:
        # decimal128: the grouped path's limb sums over one group
        limbs = D128.limbs32(torch.where(contrib[:, None], data, 0))
        v = D128.from_limb_sums(*(l.sum() for l in limbs))
    elif kind == "sum":
        v = torch.where(contrib, data, torch.zeros(
            (), dtype=data.dtype, device=data.device)).sum(dtype=data.dtype)
    elif kind in ("min", "max"):
        vals, isn = _extreme_input(data, dt, contrib, kind)
        v = vals.amin() if kind == "min" else vals.amax()
        if isn is not None:
            v = _extreme_nan(kind, v, contrib.sum(), (contrib & ~isn).sum(),
                             (contrib & isn).sum())
        v = v.to(data.dtype)
    else:
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: '{kind}' reduction is not ported "
            "yet")
    return DeviceColumn(dt, v.reshape(one), torch.any(contrib).reshape(1))


def _one_row_batch(schema: T.StructType, cols: List[DeviceColumn],
                   bucket: int = 8) -> DeviceBatch:
    """Pad 1-row columns to the minimum bucket; row 0 live."""
    out = []
    for c in cols:
        data = torch.zeros((bucket,) + tuple(c.data.shape[1:]),
                           dtype=c.data.dtype, device=c.data.device)
        data[:1] = c.data
        validity = None
        if c.validity is not None:
            validity = torch.zeros((bucket,), dtype=torch.bool,
                                   device=c.data.device)
            validity[:1] = c.validity
        out.append(DeviceColumn(c.dtype, data, validity))
    sel = torch.arange(bucket, device=cols[0].data.device) < 1
    return DeviceBatch(schema, tuple(out), sel, compacted=True)


# ---------------------------------------------------------------------------
# The holistic aggregates: one sort per function over the gathered input
# ---------------------------------------------------------------------------

def is_holistic_fn(f: AggregateFunction) -> bool:
    """Functions that need the gathered single pass (no partial/merge
    split): the collects, the percentiles, and min/max/first over
    strings and decimal128, whose values cannot ride a single-limb
    buffer through the merge.  The exec's one routing test, as in the
    JAX package."""
    if isinstance(f, (CollectList, Percentile)):
        return True
    return (isinstance(f, (Min, Max, First)) and f.child is not None
            and (isinstance(f.input_dtype, (T.StringType, T.BinaryType))
                 or D128.is128(f.input_dtype)))


def _boundaries(key_limbs: Sequence[torch.Tensor], perm: torch.Tensor,
                b: int) -> torch.Tensor:
    """Group starts of the rows in ``perm`` order: a row differs from
    the one before it in some key limb (the first row always starts)."""
    boundary = torch.zeros((b,), dtype=torch.bool, device=perm.device)
    for l in key_limbs:
        ls = l[perm]
        boundary[1:] |= ORD.limb_neq(ls[1:], ls[:-1])
    boundary[0] = True
    return boundary


def _sorted_groups(key_cols: Sequence[DeviceColumn], sel: torch.Tensor,
                   contrib: torch.Tensor,
                   value_col: Optional[DeviceColumn] = None):
    """The holistic aggregates' skeleton: a stable sort on (exclusion,
    keys[, contribution flag, value]) with group boundaries over the key
    limbs only.  Returns (perm, counts, starts): the sort's permutation,
    and per group, in ``segment_groupby``'s compacted group order of the
    exact layout, its contributing rows and its first sorted row."""
    b = int(sel.shape[0])
    tail = [] if value_col is None else [ORD._flag_part(~contrib)] + (
        ORD.column_order_parts(value_col, True, True,
                               distinguish_neg_zero=False))
    limbs, key_limbs = ORD.group_sort_limbs(list(key_cols), sel, tail)
    _, perm = ORD.sort_by_keys(limbs)
    gid = torch.cumsum(_boundaries(key_limbs, perm, b).to(torch.int64),
                       0) - 1
    start, _, perm2 = _group_slots(gid, sel[perm])
    # an integer sum: exact in any order
    counts = torch.zeros_like(gid).index_add_(0, gid,
                                              contrib[perm].to(torch.int64))
    return perm, counts[perm2], start[perm2]


def _group_slots(gid: torch.Tensor, live_sorted: torch.Tensor):
    """Per group id of the sorted rows: (its first sorted row, whether
    the group is live, and the permutation that puts the live groups
    first in group order — ``segment_groupby``'s compacted order)."""
    iota = torch.arange(gid.shape[0], device=gid.device)
    start = torch.zeros_like(gid).scatter_reduce_(0, gid, iota, "amin",
                                                  include_self=False)
    # a slot past the last group holds no row
    glive = (iota <= gid[-1]) & live_sorted[start]
    return start, glive, torch.argsort((~glive).to(torch.uint8),
                                       stable=True)


def segment_max_group_count(key_cols: Sequence[DeviceColumn],
                            sel: torch.Tensor,
                            contribs: Sequence[torch.Tensor]
                            ) -> torch.Tensor:
    """The largest number of contributing rows of any group, over every
    mask of ``contribs`` (a 0-d tensor): the collect matrix's width
    probe, read on the host by the caller."""
    b = int(sel.shape[0])
    _, key_limbs = ORD.group_sort_limbs(list(key_cols), sel)
    _, perm = ORD.sort_by_keys(key_limbs)
    gid = torch.cumsum(_boundaries(key_limbs, perm, b).to(torch.int64),
                       0) - 1
    out = torch.zeros((), dtype=torch.int64, device=sel.device)
    for contrib in contribs:
        n = torch.zeros((b,), dtype=torch.int64, device=sel.device)
        n.index_add_(0, gid, (contrib & sel)[perm].to(torch.int64))
        out = torch.maximum(out, n.max())
    return out


def segment_collect(key_cols: Sequence[DeviceColumn], sel: torch.Tensor,
                    value_col: DeviceColumn, cap: int,
                    distinct: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """collect_list / collect_set per group -> (matrix ``[B, cap]``,
    int32 lengths ``[B]``) in ``segment_groupby``'s compacted group
    order of the exact layout (rows past the last group are empty).

    A stable sort on (exclusion, keys, value invalid) puts each group's
    non-null values first in its block, in input order, so a group's
    list is one gather from its start.  ``distinct`` sorts by the value
    too, keeps the first row of each run of equal values (-0.0 and 0.0
    one value, every NaN one) and moves the kept rows to the front of
    their block with one more stable sort: the set's order is the value
    order."""
    b = int(sel.shape[0])
    dev = sel.device
    contrib = sel & value_col.valid_mask()
    tail = [ORD._flag_part(~contrib)]
    if distinct:
        tail += ORD.column_order_parts(value_col, True, True,
                                       distinguish_neg_zero=False)
    limbs, key_limbs = ORD.group_sort_limbs(list(key_cols), sel, tail)
    _, perm = ORD.sort_by_keys(limbs)
    gid = torch.cumsum(_boundaries(key_limbs, perm, b).to(torch.int64),
                       0) - 1
    values = value_col.data[perm]
    keep = contrib[perm]
    if distinct:
        # the first row of each run of equal (keys, flag, value)
        keep = keep & _boundaries(limbs, perm, b)
        # the kept rows to the front of their group's block (the blocks
        # keep their places: the group is the primary key)
        perm3 = torch.argsort(gid * 2 + (~keep).to(torch.int64),
                              stable=True)
        values, keep = values[perm3], keep[perm3]
    counts = torch.zeros_like(gid).index_add_(0, gid, keep.to(torch.int64))
    start, glive, perm2 = _group_slots(gid, sel[perm])
    starts_g = start[perm2]
    counts_g = torch.where(glive[perm2], counts[perm2], 0)
    j = torch.arange(cap, device=dev)
    idx = (starts_g[:, None] + j[None, :]).clamp(0, b - 1)
    mat = torch.where(j[None, :] < counts_g[:, None], values[idx],
                      torch.zeros((), dtype=values.dtype, device=dev))
    return mat, counts_g.to(torch.int32)


def segment_extreme(key_cols: Sequence[DeviceColumn], sel: torch.Tensor,
                    value_col: DeviceColumn, kind: str) -> DeviceColumn:
    """min/max/first of ``value_col`` per group for any orderable type
    (strings included): one stable sort on (exclusion, keys[, null flag,
    value]) and a row gather per group — min the first contributing
    row, max the last, first the first LIVE row, a null included.  The
    output is in ``segment_groupby``'s compacted group order."""
    b = int(sel.shape[0])
    if kind == "first":
        perm, counts_g, starts_g = _sorted_groups(key_cols, sel, sel)
    else:
        perm, counts_g, starts_g = _sorted_groups(
            key_cols, sel, sel & value_col.valid_mask(), value_col)
    idx = (starts_g + counts_g - 1) if kind == "max" else starts_g
    rows = perm[idx.clamp(0, b - 1)]
    out = value_col.gather(rows)
    if kind == "first":
        out.validity = value_col.valid_mask()[rows] & (counts_g > 0)
    else:
        out.validity = counts_g > 0
    return out


def segment_percentile(key_cols: Sequence[DeviceColumn], sel: torch.Tensor,
                       value_col: DeviceColumn, pct: float,
                       interpolate: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """percentile / approx_percentile over value-sorted groups ->
    (values, validity) in compacted group order.  Exact: Spark's rank
    p·(n-1) with linear interpolation; approx: the nearest-rank element
    (ceil(p·n) - 1)."""
    b = int(sel.shape[0])
    perm, counts_g, starts_g = _sorted_groups(
        key_cols, sel, sel & value_col.valid_mask(), value_col)
    values_sorted = value_col.data[perm]
    nonempty = counts_g > 0
    if interpolate:
        r = pct * torch.clamp_min(counts_g - 1, 0).to(torch.float64)
        lo = torch.floor(r)
        vlo = values_sorted[(starts_g + lo.to(torch.int64)).clamp(
            0, b - 1)].to(torch.float64)
        vhi = values_sorted[(starts_g + torch.ceil(r).to(torch.int64))
                            .clamp(0, b - 1)].to(torch.float64)
        return vlo + (r - lo) * (vhi - vlo), nonempty
    idx = torch.ceil(pct * counts_g.to(torch.float64)).to(torch.int64) - 1
    idx = torch.minimum(idx.clamp_min(0), torch.clamp_min(counts_g - 1, 0))
    return values_sorted[(starts_g + idx).clamp(0, b - 1)], nonempty


# ---------------------------------------------------------------------------
# Partial update / final projection per aggregate function
# ---------------------------------------------------------------------------

def update_value_cols(fns: Sequence[AggregateFunction], batch: DeviceBatch
                      ) -> List[Tuple[DeviceColumn, str]]:
    """Per-batch buffer inputs for the partial (update) pass."""
    out: List[Tuple[DeviceColumn, str]] = []
    for fn in fns:
        if isinstance(fn, CountStar):
            ones = DeviceColumn(T.LongT, torch.ones(
                (batch.capacity,), dtype=torch.int64, device=batch.device))
            out.append((ones, "sum"))
            continue
        c = fn.child.eval(batch)
        valid = c.valid_mask()
        if isinstance(fn, Count):
            out.append((DeviceColumn(T.LongT, valid.to(torch.int64)),
                        "sum"))
        elif isinstance(fn, (Sum, Average)):
            rdt = fn.buffer_dtypes()[0]
            if D128.is128(rdt):
                data = (c.data if D128.is128(c.dtype)
                        else D128.from_i64(c.data))
            else:
                data = c.data.to(torch_dtype(rdt))
            out.append((DeviceColumn(rdt, data, c.validity), "sum"))
            out.append((DeviceColumn(T.LongT, valid.to(torch.int64)),
                        "sum"))
        elif isinstance(fn, (Min, Max)):
            out.append((c, "min" if isinstance(fn, Min) else "max"))
        elif isinstance(fn, First):
            out.append((c, "first"))
        elif isinstance(fn, _VarianceBase):
            # the analyzer casts the child to double
            x = c.data.to(torch.float64)
            out.append((DeviceColumn(T.DoubleT, x, c.validity), "sum"))
            out.append((DeviceColumn(T.DoubleT, x * x, c.validity), "sum"))
            out.append((DeviceColumn(T.LongT, valid.to(torch.int64)),
                        "sum"))
        else:
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: aggregate {fn.name} is not "
                "ported yet")
    return out


def merge_kinds(fns: Sequence[AggregateFunction]) -> List[str]:
    kinds: List[str] = []
    for fn in fns:
        kinds.extend(fn.buffer_kinds)
    return kinds


def final_project(fns: Sequence[AggregateFunction],
                  bufs: List[DeviceColumn]) -> List[DeviceColumn]:
    out: List[DeviceColumn] = []
    i = 0
    for fn in fns:
        nb = len(fn.buffer_kinds)
        mine = bufs[i:i + nb]
        i += nb
        if isinstance(fn, (Count, CountStar)):
            out.append(DeviceColumn(T.LongT, mine[0].data, None))
        elif isinstance(fn, Sum):
            s, cnt = mine
            validity = cnt.data > 0
            if D128.is128(fn.result_dtype):
                # Spark nulls a sum past its precision (non-ANSI)
                validity = validity & D128.fits_precision(
                    s.data, fn.result_dtype.precision)
            out.append(DeviceColumn(fn.result_dtype, s.data, validity))
        elif isinstance(fn, Average):
            s, cnt = mine
            denom = torch.where(cnt.data > 0, cnt.data, 1)
            out.append(DeviceColumn(
                T.DoubleT, s.data / denom.to(torch.float64),
                cnt.data > 0))
        elif isinstance(fn, _VarianceBase):
            s1, s2, cnt = mine
            n = cnt.data.to(torch.float64)
            nsafe = torch.where(cnt.data > 0, n, 1.0)
            # sum((x - mean)^2) = sum(x^2) - sum(x)^2 / n, clamped at 0
            # (cancellation); NaN stays NaN, as jnp.maximum keeps it
            m2 = torch.maximum(s2.data - s1.data * s1.data / nsafe,
                               torch.zeros_like(n))
            denom = n - fn.ddof
            var = torch.where(denom > 0,
                              m2 / torch.where(denom > 0, denom, 1.0),
                              float("nan"))  # var_samp of one row
            v = torch.sqrt(var) if fn.sqrt_final else var
            out.append(DeviceColumn(T.DoubleT, v, cnt.data > 0))
        elif isinstance(fn, (Min, Max, First)):
            out.append(mine[0])  # the buffer is the result
        else:
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: aggregate {fn.name} is not "
                "ported yet")
    return out


# ---------------------------------------------------------------------------
# The exec
# ---------------------------------------------------------------------------

def _pull_all(src) -> Iterator[DeviceBatch]:
    """Every batch of every partition of ``src``, partition by partition
    (the complete-mode aggregate's input)."""
    for p in range(src.num_partitions()):
        yield from src.execute(p)


class TpuHashAggregateExec(TpuExec):
    """Hash aggregate in one of three modes, mirroring the reference's
    partial/final split [REF: GpuHashAggregateExec]:

    * ``complete`` — update per input batch -> merge the partials ->
      final projection; the input is every partition of the child, in
      order; one partition out (one batch per merge bucket);
    * ``partial`` — per child partition: update + local merge, emitting
      buffer-schema batches (feeds an ICI exchange keyed on k0..kn);
    * ``final`` — per child partition: merge the received buffer
      batches + final projection (downstream of a key-hash exchange, so
      each partition owns disjoint keys).

    Upstream filter/project run inside the partial pass
    (``fuse_upstream``).  ``device`` holds the empty batch that stands
    in for an input with no batch at all (an AQE read of a host shuffle
    yields none for an empty range).  The passes are memory-bounded as
    the JAX package's: input batches coalesce up to ``bucket_rows``
    live rows (``spark.rapids.tpu.agg.bucketRows``), each partial runs
    under ``with_retry`` with a ``transient`` reservation of its input,
    a first partial that keeps more than ``skip_ratio`` of its rows
    (``spark.rapids.sql.agg.skipAggPassReductionRatio``) makes the later
    batches skip their reduction, and an exploded merge re-partitions
    its partials by key into spillable buckets.
    """

    def __init__(self, grouping: Sequence[Expression],
                 fns: Sequence[AggregateFunction],
                 schema: T.StructType, child: TpuExec,
                 backend: str = "auto", device=None,
                 bucket_rows: int = 1 << 18, skip_ratio: float = 1.0,
                 mode: str = "complete"):
        super().__init__(schema, child)
        self.grouping = list(grouping)
        self.fns = list(fns)
        self.device = device
        assert mode in ("complete", "partial", "final")
        self.mode = mode
        # spark.rapids.tpu.kernel.backend, resolved to a ladder start
        self.backend = KN.resolve("agg", backend)
        # spark.rapids.tpu.agg.bucketRows: partial-pass input coalescing
        self.bucket_rows = bucket_rows
        # spark.rapids.sql.agg.skipAggPassReductionRatio
        self.skip_ratio = skip_ratio

    def node_string(self):
        keys = ", ".join(str(g) for g in self.grouping)
        aggs = ", ".join(fn.name for fn in self.fns)
        return (f"TpuHashAggregate [{self.mode} keys=[{keys}] "
                f"aggs=[{aggs}]]")

    def num_partitions(self) -> int:
        if self.mode == "complete":
            return 1
        return self.children[0].num_partitions()

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        if self.mode != "complete":
            yield from self._execute_staged(partition)
            return
        if partition != 0:
            raise IndexError(f"partition {partition} of a complete "
                             "aggregate")
        src, pre, _ = fuse_upstream(self.children[0])
        with self.timer():
            if any(is_holistic_fn(f) for f in self.fns):
                outs = [self._execute_collect(src, pre)]
            elif not self.grouping:
                outs = [self._execute_global(src, pre)]
            else:
                outs = self._execute_grouped(src, pre)
        for out in outs:
            self.metric("numOutputBatches").add(1)
            yield out

    def _execute_staged(self, partition: int) -> Iterator[DeviceBatch]:
        """partial/final modes: ONE child partition's stream (the
        stage-local halves of the distributed aggregate)."""
        with self.timer():
            if self.mode == "partial":
                mgr = get_manager()
                src, pre, _ = fuse_upstream(self.children[0])
                partials, skip = self._partial_stream(
                    src.execute(partition), pre, mgr)
                if partials is None:
                    yield empty_batch(self._buffer_schema(), self.device)
                    return
                if len(partials) == 1 or skip:
                    # skip mode: a local combine would do exactly the
                    # reduction the ratio said is useless — ship raw
                    # buffers to the exchange; the final pass reduces
                    outs = partials
                else:
                    outs = self._merge_bounded(partials,
                                               self._merge_buffers)
            else:  # final
                batches = [compact(b)
                           for b in self.children[0].execute(partition)]
                if not batches:
                    return
                with self.timer("mergeTime"):
                    outs = self._merge_bounded(batches, self._merge_final)
        for out in outs:
            self.metric("numOutputBatches").add(1)
            yield out

    def _merge_buffers(self, merged: DeviceBatch) -> DeviceBatch:
        """Merge buffer batches into one buffer batch (no final
        project): the partial side's local combine."""
        nk = len(self.grouping)
        keys = list(merged.columns[:nk])
        bufs = list(merged.columns[nk:])
        kinds = merge_kinds(self.fns)
        buffer_schema = self._buffer_schema()

        def run(backend):
            ok, ov, sel, okf = segment_groupby(
                keys, merged.sel, list(zip(bufs, kinds)), backend=backend)
            return DeviceBatch(buffer_schema, tuple(ok + ov), sel,
                               compacted=True), okf

        return self._dispatch(run)

    def _buffer_schema(self) -> T.StructType:
        fields = [T.StructField(f"k{i}", g.dtype)
                  for i, g in enumerate(self.grouping)]
        j = 0
        for fn in self.fns:
            for bd in fn.buffer_dtypes():
                fields.append(T.StructField(f"b{j}", bd))
                j += 1
        return T.StructType(tuple(fields))

    def _dispatch(self, fn_of_backend):
        """Run ``fn_of_backend(backend) -> (batch, ok)`` down the kernel
        plane's ladder."""
        return KN.dispatch("agg", self.backend,
                           lambda be: (lambda: fn_of_backend(be)),
                           node=self)

    def _partial(self, batch: DeviceBatch, pre) -> DeviceBatch:
        b = pre(batch)
        keys = [g.eval(b) for g in self.grouping]
        vals = update_value_cols(self.fns, b)
        buffer_schema = self._buffer_schema()

        def run(backend):
            ok, ov, sel, okf = segment_groupby(
                keys, b.sel, vals, backend=backend)
            return DeviceBatch(buffer_schema, tuple(ok + ov), sel,
                               compacted=True), okf

        return self._dispatch(run)

    def _update_raw(self, batch: DeviceBatch, pre) -> DeviceBatch:
        """Buffer-schema batch WITHOUT the per-batch reduction — the
        skip-agg-pass path: keys + per-row update buffers pass straight
        to the merge, whose single reduction then does all the work."""
        b = pre(batch)
        keys = [g.eval(b) for g in self.grouping]
        vals = [c for c, _ in update_value_cols(self.fns, b)]
        return DeviceBatch(self._buffer_schema(), tuple(keys + vals),
                           b.sel)

    def _merge_final(self, merged: DeviceBatch) -> DeviceBatch:
        nk = len(self.grouping)
        keys = list(merged.columns[:nk])
        bufs = list(merged.columns[nk:])
        kinds = merge_kinds(self.fns)

        def run(backend):
            ok, ov, sel, okf = segment_groupby(
                keys, merged.sel, list(zip(bufs, kinds)), backend=backend)
            results = final_project(self.fns, ov)
            return DeviceBatch(self.schema, tuple(ok + results), sel,
                               compacted=True), okf

        return self._dispatch(run)

    # -- grouped: the memory-bounded passes -----------------------------

    def _coalesced(self, stream) -> Iterator[DeviceBatch]:
        """Group input batches up to ``bucket_rows`` LIVE rows before the
        partial pass: fewer, larger partials.  The live counts of up to
        32 batches come back in one device read (``live_counts``)."""
        cap = self.bucket_rows
        if not cap:
            yield from stream
            return

        def flush(window) -> Iterator[DeviceBatch]:
            if not window:
                return
            if len(window) == 1:
                yield window[0]
                return
            counts = live_counts(window)  # one read
            group: List[DeviceBatch] = []
            gcounts: List[int] = []
            acc = 0
            for b, n in zip(window, counts):
                if group and acc + n > cap:
                    yield self._emit_group(group, gcounts)
                    group, gcounts, acc = [], [], 0
                group.append(b)
                gcounts.append(n)
                acc += n
            if group:
                yield self._emit_group(group, gcounts)

        window: List[DeviceBatch] = []
        wcap = 0
        for b in stream:
            if b.capacity >= cap and not window:
                yield b
                continue
            window.append(b)
            wcap += b.capacity
            if len(window) >= 32 or wcap >= 8 * cap:
                yield from flush(window)
                window, wcap = [], 0
        yield from flush(window)

    def _emit_group(self, group, gcounts) -> DeviceBatch:
        if len(group) == 1:
            return group[0]
        with self.timer("concatTime"):
            batches = [compact(b) for b in group]
            return concat_device_batches(batches[0].schema, batches,
                                         counts=gcounts)

    def _decide_skip(self, outs1: List[DeviceBatch], n_in: int) -> bool:
        """Should later batches skip the per-batch reduction?
        ``outs1`` = the first input batch's partial(s) (plural when the
        OOM retry split it), ``n_in`` its live rows [REF:
        GpuHashAggregateExec skipAggPassReductionRatio]."""
        if self.skip_ratio >= 1.0:
            return False
        # small batches can't establish the ratio (64 rows -> 60 groups
        # says nothing about 6M rows)
        if n_in < 4096:
            return False
        n_groups = sum(live_counts(outs1))
        return (n_groups / max(n_in, 1)) > self.skip_ratio

    def _partial_stream(self, stream, pre, mgr
                        ) -> Tuple[Optional[List[DeviceBatch]], bool]:
        """Coalesce, run the first group's partial under retry, decide
        the skip-agg pass from its reduction ratio, stream the rest.
        Returns (partials | None for an empty stream, skip)."""
        stream = self._coalesced(stream)
        first = next(stream, None)
        if first is None:
            return None, False

        def closure_partial(b):
            with mgr.transient(b.nbytes()):
                return self._partial(b, pre)

        with self.timer("decideTime"):
            n_in = (live_counts([first])[0]
                    if self.skip_ratio < 1.0 else 0)
            outs1 = list(with_retry(
                iter([first]), closure_partial,
                max_attempts=mgr.retry_max_attempts, manager=mgr))
            skip = self._decide_skip(outs1, n_in)
        if skip:
            self.metric("skippedAggPasses").add(1)

        def closure(b):
            with mgr.transient(b.nbytes()):
                if skip:
                    return self._update_raw(b, pre)
                return self._partial(b, pre)

        with self.timer("partialTime"):
            partials = outs1 + list(with_retry(
                stream, closure, max_attempts=mgr.retry_max_attempts,
                manager=mgr))
        return partials, skip

    def _execute_grouped(self, src, pre) -> List[DeviceBatch]:
        """Update per batch under the OOM-retry framework: a RetryOOM
        spills the arbiter's pool and re-runs the batch; repeated
        pressure halves it by rows (partials merge regardless) [REF:
        withRetry + GpuAggregateIterator].  The input is pulled lazily,
        one upstream batch live at a time."""
        mgr = get_manager()
        partials, _skip = self._partial_stream(_pull_all(src), pre, mgr)
        if partials is None:
            partials = [self._partial(
                empty_batch(src.schema, self.device), pre)]
        with self.timer("mergeTime"):
            return self._merge_bounded(partials, self._merge_final)

    def _merge_bounded(self, partials: List[DeviceBatch],
                       merge_fn) -> List[DeviceBatch]:
        """Concat + merge partial buffer batches, with the
        merge-explosion repartition fallback [REF: GpuAggregateExec
        repartition fallback]: when the partials' live rows pass twice
        the largest capacity, they re-hash-partition by grouping key
        into spillable buckets and each bucket merges on its own (equal
        keys share a bucket), so the merge's peak is one bucket."""
        partials = [compact(p) for p in partials]
        if len(partials) == 1:
            return [merge_fn(partials[0])]
        schema = self._buffer_schema()
        if len(partials) <= 2:
            return [merge_fn(concat_device_batches(schema, partials))]
        counts = live_counts(partials)
        total = sum(counts)
        cap = max(b.capacity for b in partials)
        if total <= 2 * cap:
            return [merge_fn(concat_device_batches(schema, partials,
                                                   counts))]
        self.metric("repartitionMerges").add(1)
        k = int(min(64, max(2, -(-total // cap))))
        keys = [BoundReference(i, g.dtype)
                for i, g in enumerate(self.grouping)]
        # not the shuffle seed 42: partials that crossed a seed-42
        # hash-mod-nparts exchange would collapse into few buckets
        pid_fn = make_pid_fn(keys, k, seed=AGG_SEED)
        slices = split_to_spillables(
            partials, lambda b, aux: pid_fn(b), k, get_manager())
        out = []
        for i in range(k):
            if not slices[i]:
                continue
            bs = [s.get() for s in slices[i]]
            bcounts = [s.live_rows for s in slices[i]]
            out.append(merge_fn(concat_device_batches(
                schema, bs, counts=bcounts)))
            for s in slices[i]:
                s.close()
        return out

    # -- holistic functions: the gathered single pass -------------------

    def _execute_collect(self, src, pre) -> DeviceBatch:
        """Every input batch concatenated into one, reserved twice over
        while it is reduced: the plain functions through
        ``segment_groupby`` on the exact layout (the holistic helpers
        sort by the full key encoding, and their columns zip with its
        groups by position), each holistic function by its own sort.  A
        global aggregate yields exactly one row, an empty input
        included."""
        batches = [compact(b) for b in _pull_all(src)]
        if not batches:
            batches = [empty_batch(src.schema, self.device)]
        merged = concat_device_batches(src.schema, batches)
        mgr = get_manager()
        with mgr.transient(2 * merged.nbytes()):
            m = pre(merged)
            keys = [g.eval(m) for g in self.grouping]
            lists = [f for f in self.fns if isinstance(f, CollectList)]
            cap = 1
            if lists:
                # the matrix width: the largest group's non-null values,
                # one host read, to a power of two
                most = int(segment_max_group_count(
                    keys, m.sel, [f.child.eval(m).valid_mask()
                                  for f in lists]))
                cap = 1 << (most - 1).bit_length() if most > 1 else 1
            normal = [f for f in self.fns if not is_holistic_fn(f)]
            ok, ov, sel, _ = segment_groupby(
                keys, m.sel, update_value_cols(normal, m), backend="jnp")
            normal_res = iter(final_project(normal, ov))
            cols = list(ok)
            for f in self.fns:
                if isinstance(f, CollectList):
                    v = f.child.eval(m)
                    # the [B, cap] matrix and its lengths, reserved
                    # before they are made
                    with mgr.transient(m.capacity * (
                            cap * v.data.element_size() + 4)):
                        mat, lens = segment_collect(
                            keys, m.sel, v, cap,
                            distinct=isinstance(f, CollectSet))
                    cols.append(DeviceColumn(f.result_dtype, mat, None,
                                             lens))
                elif isinstance(f, Percentile):
                    v, vv = segment_percentile(
                        keys, m.sel, f.child.eval(m), f.pct,
                        interpolate=not isinstance(f, ApproxPercentile))
                    cols.append(DeviceColumn(f.result_dtype, v, vv))
                elif is_holistic_fn(f):
                    kind = ("min" if isinstance(f, Min) else
                            "max" if isinstance(f, Max) else "first")
                    cols.append(segment_extreme(keys, m.sel,
                                                f.child.eval(m), kind))
                else:
                    cols.append(next(normal_res))
            if not self.grouping:
                sel = torch.arange(m.capacity, device=m.device) < 1
            return DeviceBatch(self.schema, tuple(cols), sel,
                               compacted=True)

    # -- global (keyless) aggregate ------------------------------------

    def _execute_global(self, src, pre) -> DeviceBatch:
        """Per-batch masked REDUCTION (no sort) under ``with_retry``; the
        single-batch case fuses the final projection, and falls through
        to the splittable two-phase path when its reservation fails."""
        mgr = get_manager()
        stream = _pull_all(src)
        first = next(stream, None)
        if first is None:
            return self._reduce_batch(
                empty_batch(src.schema, self.device), pre, final=True)
        second = next(stream, None)
        if second is None:
            try:
                with mgr.transient(first.nbytes()):
                    return self._reduce_batch(first, pre, final=True)
            except RetryOOM:
                pass  # fall through to the splittable two-phase path

        def closure(b):
            with mgr.transient(b.nbytes()):
                return self._reduce_batch(b, pre)

        def inputs():
            yield first
            if second is not None:
                yield second
            yield from stream

        partials = list(with_retry(
            inputs(), closure, max_attempts=mgr.retry_max_attempts,
            manager=mgr))
        return self._reduce_merge_final(partials)

    def _reduce_batch(self, batch: DeviceBatch, pre,
                      final: bool = False) -> DeviceBatch:
        b = pre(batch)
        vals = update_value_cols(self.fns, b)
        bufs = [_reduce_column(c.data, c.valid_mask(), b.sel, kind, c.dtype)
                for c, kind in vals]
        if final:
            bufs = final_project(self.fns, bufs)
        return _one_row_batch(self.schema if final
                              else self._buffer_schema(), bufs)

    def _reduce_merge_final(self, partials: List[DeviceBatch]
                            ) -> DeviceBatch:
        """Merge per-batch reductions and final-project."""
        sel = torch.cat([p.sel for p in partials])
        bufs = []
        for j, kind in enumerate(merge_kinds(self.fns)):
            data = torch.cat([p.columns[j].data for p in partials])
            valid = torch.cat([p.columns[j].valid_mask() for p in partials])
            bufs.append(_reduce_column(data, valid, sel, kind,
                                       partials[0].columns[j].dtype))
        return _one_row_batch(self.schema, final_project(self.fns, bufs))


# ---------------------------------------------------------------------------
# CPU oracle exec
# ---------------------------------------------------------------------------

class CpuAggregateExec(CpuExec):
    def __init__(self, grouping: Sequence[Expression],
                 fns: Sequence[AggregateFunction],
                 schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.grouping = list(grouping)
        self.fns = list(fns)

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child = self.children[0]
        groups = {}
        order: List[tuple] = []
        for p in range(child.num_partitions()):
            for b in child.execute(p):
                n = b.num_rows
                key_cols = [g.eval_cpu(b) for g in self.grouping]
                val_cols = [None if isinstance(fn, CountStar)
                            else fn.child.eval_cpu(b) for fn in self.fns]
                for i in range(n):
                    key = tuple(
                        None if (kc.validity is not None
                                 and not kc.validity[i])
                        else _norm_key(kc.data[i], kc.dtype)
                        for kc in key_cols)
                    st = groups.get(key)
                    if st is None:
                        st = [_new_acc() for _ in self.fns]
                        groups[key] = st
                        order.append(key)
                    for acc, fn, vc in zip(st, self.fns, val_cols):
                        _acc_update(acc, fn, vc, i)
        if not self.grouping and not groups:
            groups[()] = [_new_acc() for _ in self.fns]
            order.append(())
        rows = []
        for key in order:
            st = groups[key]
            rows.append(list(key) + [_acc_final(a, fn)
                                     for a, fn in zip(st, self.fns)])
        cols = list(zip(*rows)) if rows else [[] for _ in self.schema.fields]
        out_cols = []
        for vals, f in zip(cols, self.schema.fields):
            vals = list(vals)
            validity = np.array([v is not None for v in vals], bool)
            if isinstance(f.dtype, T.ArrayType):
                data = np.empty(len(vals), dtype=object)
                for i, v in enumerate(vals):
                    data[i] = v if v is not None else []
            elif isinstance(f.dtype, (T.StringType, T.BinaryType)):
                data = np.array([v if v is not None else "" for v in vals],
                                dtype=object)
            elif D128.is128(f.dtype):
                data = np.empty(len(vals), dtype=object)
                data[:] = [int(v) if v is not None else 0 for v in vals]
            else:
                npdt = T.to_numpy_dtype(f.dtype)
                data = np.array([v if v is not None else 0 for v in vals])
                data = data.astype(npdt, copy=False)
            out_cols.append(H.HostCol(
                f.dtype, data, None if validity.all() else validity))
        yield H.HostBatch(self.schema, out_cols)


def _norm_key(v, dt):
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        f = float(v)
        if np.isnan(f):
            return "NaN"
        if f == 0.0:
            return 0.0  # -0.0 and 0.0 one group (Spark normalizes keys)
        return f
    if isinstance(dt, T.BooleanType):
        return bool(v)
    if isinstance(dt, (T.StringType, T.BinaryType)):
        return v
    return int(v)


def _new_acc():
    return {"sum": 0, "count": 0, "min": None, "max": None, "first": None,
            "has_first": False, "mean": 0.0, "m2": 0.0, "list": []}


def _acc_update(acc, fn, vc, i):
    if isinstance(fn, CountStar):
        acc["count"] += 1
        return
    valid = vc.validity is None or bool(vc.validity[i])
    if isinstance(fn, First):
        if not acc["has_first"]:
            acc["first"] = vc.data[i] if valid else None
            acc["has_first"] = True
        return
    if not valid:
        return
    v = vc.data[i]
    if isinstance(fn, Count):
        acc["count"] += 1
    elif isinstance(fn, (Sum, Average)):
        acc["count"] += 1
        if isinstance(fn.child.dtype, T.DecimalType):
            # exact python ints: a decimal sum widens to p + 10 digits
            # (a decimal128 buffer on the device)
            acc["sum"] = int(acc["sum"]) + int(v)
        elif T.is_integral(fn.child.dtype):
            with np.errstate(over="ignore"):  # Spark non-ANSI sum wraps
                acc["sum"] = np.int64(acc["sum"] + np.int64(v))
        else:
            acc["sum"] = float(acc["sum"]) + float(v)
    elif isinstance(fn, _VarianceBase):
        # Welford, exactly Spark's CentralMomentAgg update
        acc["count"] += 1
        delta = float(v) - acc["mean"]
        acc["mean"] += delta / acc["count"]
        acc["m2"] += delta * (float(v) - acc["mean"])
    elif isinstance(fn, (CollectList, Percentile)):
        acc["list"].append(vc.data[i])
    elif isinstance(fn, Min):
        acc["min"] = v if acc["min"] is None else _spark_min(acc["min"], v, fn)
    elif isinstance(fn, Max):
        acc["max"] = v if acc["max"] is None else _spark_max(acc["max"], v, fn)


def _total_key(v, dt):
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        f = float(v)
        if np.isnan(f):
            return (1, 0.0)
        return (0, f)
    return (0, v)


def _spark_min(a, b, fn):
    dt = fn.child.dtype
    return a if _total_key(a, dt) <= _total_key(b, dt) else b


def _spark_max(a, b, fn):
    dt = fn.child.dtype
    return a if _total_key(a, dt) >= _total_key(b, dt) else b


def _acc_final(acc, fn):
    if isinstance(fn, (Count, CountStar)):
        return int(acc["count"])
    if isinstance(fn, Sum):
        if acc["count"] == 0:
            return None
        if isinstance(fn.child.dtype, T.DecimalType):
            # the 128-bit container's wrap, then overflow to null
            w = D128.py_wrap128(acc["sum"])
            return w if D128.py_fits(w, fn.result_dtype.precision) else None
        return acc["sum"]
    if isinstance(fn, Average):
        if acc["count"] == 0:
            return None
        return float(acc["sum"]) / acc["count"]
    if isinstance(fn, _VarianceBase):
        n = acc["count"]
        if n == 0:
            return None
        denom = n - fn.ddof
        var = acc["m2"] / denom if denom > 0 else float("nan")
        if not fn.sqrt_final:
            return var
        return math.sqrt(var) if var == var else float("nan")
    if isinstance(fn, CollectSet):
        dt = fn.input_dtype
        uniq = {}
        for v in acc["list"]:
            uniq.setdefault(_total_key(v, dt), v)
        return [_py_scalar(uniq[k], dt) for k in sorted(uniq)]
    if isinstance(fn, CollectList):
        return [_py_scalar(v, fn.input_dtype) for v in acc["list"]]
    if isinstance(fn, ApproxPercentile):
        vals = sorted(acc["list"],
                      key=lambda v: _total_key(v, fn.input_dtype))
        if not vals:
            return None
        idx = min(max(math.ceil(fn.pct * len(vals)) - 1, 0), len(vals) - 1)
        return _py_scalar(vals[idx], fn.input_dtype)
    if isinstance(fn, Percentile):
        vals = sorted((float(v) for v in acc["list"]),
                      key=lambda x: _total_key(x, T.DoubleT))
        if not vals:
            return None
        r = fn.pct * (len(vals) - 1)
        lo = math.floor(r)
        return vals[lo] + (r - lo) * (vals[math.ceil(r)] - vals[lo])
    if isinstance(fn, Min):
        return acc["min"]
    if isinstance(fn, Max):
        return acc["max"]
    if isinstance(fn, First):
        return acc["first"]
    raise NotImplementedError(fn.name)


def _py_scalar(v, dt):
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        return float(v)
    if isinstance(dt, T.BooleanType):
        return bool(v)
    if isinstance(dt, (T.StringType, T.BinaryType)):
        return v
    return int(v)

