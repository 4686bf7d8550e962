"""Hash-aggregate exec (complete mode) and the device group-by.

[REF: sql-plugin/../GpuAggregateExec.scala :: GpuHashAggregateExec,
 AggHelper]

The counterpart of the JAX package's ``exec/aggregate.py`` for the
q1/q6 slice: sum, count, count(*) and avg, grouped or global, in
complete mode (update per input batch -> merge the partials -> final
projection).

The group-by keeps the JAX package's layout and protocol: key limbs
from ``ops/ordering.py``; a group layout from the kernel plane (the
hash-grouped layout whose row hash is the CUDA kernel, or the exact
full-key sort); live groups compacted to the front of a batch of
unchanged capacity, in group order.  What differs is the reduction: the
JAX package reduces with segmented ``associative_scan``s (scatter is
serial on a TPU); here every row adds into its group's slot with one
``index_add_`` keyed by group id.  A cumulative-sum difference is
deliberately not used for float sums — at 2^20 rows the running total
reaches ~5e9 and the cancellation would ruin small groups.  On a CUDA
device ``index_add_`` on float64 adds in atomic order, so float sums
vary from run to run at the last-ulp level (and differ in the last ulps
from the JAX package's scan order); counts and keys are exact.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, torch_dtype)
from spark_rapids_tpu_torch.exec.base import TpuExec, fuse_upstream
from spark_rapids_tpu_torch.exec.basic import (
    concat_device_batches, live_counts)
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.ops.aggregates import (
    AggregateFunction, Average, Count, CountStar, Sum)
from spark_rapids_tpu_torch.ops.expressions import Expression


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
    """Group rows by keys; reduce values by kind (this slice: 'sum').

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
    batcher = _ScanBatcher(gid_row, b)
    nlive = batcher.add("add", sel.to(torch.int64), key="live")
    size = batcher.add("add", torch.ones_like(gid), key="size")
    plans = []
    for ci, (c, kind) in enumerate(value_cols):
        if kind != "sum":
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: '{kind}' reduction is not "
                "ported yet")
        if c.validity is None:
            contrib, ckey = sel, "live"  # shared count for non-null inputs
        else:
            contrib, ckey = sel & c.validity, ("col", ci)
        plans.append((c, batcher.add("add", contrib.to(torch.int64),
                                     key=ckey),
                      batcher.add("add", torch.where(
                          contrib, c.data, torch.zeros(
                              (), dtype=c.data.dtype, device=dev)))))
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
    for c, n_contrib, agg in plans:
        out_vals.append(DeviceColumn(c.dtype, batcher.get(agg)[perm2],
                                     batcher.get(n_contrib)[perm2] > 0))
    out_sel = torch.arange(b, device=dev) < num_groups
    return out_keys, out_vals, out_sel, okf


class _ScanBatcher:
    """Deduplicates segmented reductions over identical inputs.

    The JAX package's batcher shares segmented scans among requests over
    the same logical input (a q1-shaped aggregate asks for the live-row
    count eight times).  Here a request is one ``index_add_`` of the
    input into its group's slot; ``add`` enqueues with an optional
    logical-input key and returns a handle, ``run`` reduces, ``get``
    returns the per-group result (indexed by group id).
    """

    def __init__(self, gid_row: torch.Tensor, num_slots: int):
        self.gid_row = gid_row
        self.num_slots = num_slots
        self._reqs: List[list] = []  # [tag, array, result]
        self._dedupe = {}

    def add(self, tag: str, arr, key=None) -> int:
        if tag != "add":
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
            _, arr, _ = req
            out = torch.zeros((self.num_slots,), dtype=arr.dtype,
                              device=arr.device)
            req[2] = out.index_add_(0, self.gid_row, arr)

    def get(self, i: int):
        return self._reqs[i][2]


def _reduce_column(data: torch.Tensor, valid: torch.Tensor,
                   live: torch.Tensor, kind: str,
                   dt: T.DataType) -> DeviceColumn:
    """Whole-array masked reduction -> 1-element column (sums of valid
    live rows; null when no row contributes)."""
    if kind != "sum":
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: '{kind}' reduction is not ported "
            "yet")
    contrib = valid & live
    v = torch.where(contrib, data, torch.zeros(
        (), dtype=data.dtype, device=data.device)).sum(dtype=data.dtype)
    return DeviceColumn(dt, v.reshape(1), torch.any(contrib).reshape(1))


def _one_row_batch(schema: T.StructType, cols: List[DeviceColumn],
                   bucket: int = 8) -> DeviceBatch:
    """Pad 1-row columns to the minimum bucket; row 0 live."""
    out = []
    for c in cols:
        data = torch.zeros((bucket,), dtype=c.data.dtype,
                           device=c.data.device)
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
            data = c.data.to(torch_dtype(rdt))
            out.append((DeviceColumn(rdt, data, c.validity), "sum"))
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
            out.append(DeviceColumn(fn.result_dtype, s.data, cnt.data > 0))
        elif isinstance(fn, Average):
            s, cnt = mine
            denom = torch.where(cnt.data > 0, cnt.data, 1)
            out.append(DeviceColumn(
                T.DoubleT, s.data / denom.to(torch.float64),
                cnt.data > 0))
        else:
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: aggregate {fn.name} is not "
                "ported yet")
    return out


# ---------------------------------------------------------------------------
# The exec
# ---------------------------------------------------------------------------

class TpuHashAggregateExec(TpuExec):
    """Hash aggregate in complete mode: update per input batch -> merge
    the partials -> final projection [REF: GpuHashAggregateExec].

    Upstream filter/project run inside the partial pass
    (``fuse_upstream``).  The JAX package's partial/final modes (around a
    shuffle), OOM retry, input coalescing and skip-agg pass are later
    slices.
    """

    def __init__(self, grouping: Sequence[Expression],
                 fns: Sequence[AggregateFunction],
                 schema: T.StructType, child: TpuExec,
                 backend: str = "auto"):
        super().__init__(schema, child)
        self.grouping = list(grouping)
        self.fns = list(fns)
        self.mode = "complete"
        # spark.rapids.tpu.kernel.backend, resolved to a ladder start
        self.backend = KN.resolve("agg", backend)

    def node_string(self):
        keys = ", ".join(str(g) for g in self.grouping)
        aggs = ", ".join(fn.name for fn in self.fns)
        return (f"TpuHashAggregate [{self.mode} keys=[{keys}] "
                f"aggs=[{aggs}]]")

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        if partition != 0:
            raise IndexError(f"partition {partition} of a complete "
                             "aggregate")
        src, pre = fuse_upstream(self.children[0])
        with self.timer():
            if not self.grouping:
                outs = [self._execute_global(src, pre)]
            else:
                outs = self._execute_grouped(src, pre)
        for out in outs:
            self.metric("numOutputBatches").add(1)
            yield out

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
                           lambda be: (lambda: fn_of_backend(be)))

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

    def _execute_grouped(self, src, pre) -> List[DeviceBatch]:
        with self.timer("partialTime"):
            # a scan yields at least one batch, live rows or not
            partials = [self._partial(b, pre) for b in src.execute(0)]
        with self.timer("mergeTime"):
            return self._merge_bounded(partials, self._merge_final)

    def _merge_bounded(self, partials: List[DeviceBatch],
                       merge_fn) -> List[DeviceBatch]:
        """Concat + merge partial buffer batches.

        When the merged cardinality explodes (total live rows beyond
        twice one batch — TPC-H q3's partials over many small join
        outputs), the JAX package re-partitions the partials by key and
        merges each bucket, because XLA would otherwise compile a merge
        kernel at the exploded bucket.  Eager PyTorch compiles nothing,
        and the concat holds no more rows than the partials already do,
        so the port merges the one concat; the result is the same set of
        groups (``repartitionMerges`` counts where the JAX package would
        have split)."""
        partials = [compact(p) for p in partials]
        if len(partials) == 1:
            return [merge_fn(partials[0])]
        schema = self._buffer_schema()
        counts = live_counts(partials)
        total = sum(counts)
        cap = max(b.capacity for b in partials)
        if len(partials) > 2 and total > 2 * cap:
            self.metric("repartitionMerges").add(1)
        return [merge_fn(concat_device_batches(schema, partials, counts))]

    # -- global (keyless) aggregate ------------------------------------

    def _execute_global(self, src, pre) -> DeviceBatch:
        """Per-batch masked REDUCTION (no sort); the single-batch case
        fuses the final projection."""
        stream = src.execute(0)
        first = next(stream)  # a scan yields at least one batch
        second = next(stream, None)
        if second is None:
            return self._reduce_batch(first, pre, final=True)
        partials = [self._reduce_batch(first, pre),
                    self._reduce_batch(second, pre)]
        partials += [self._reduce_batch(b, pre) for b in stream]
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
