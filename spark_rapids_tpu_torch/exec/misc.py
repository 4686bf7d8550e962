"""Other operators: Range, Sample, Expand, Generate (explode) and the
top-N (TakeOrderedAndProject).

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuRangeExec,
 GpuSampleExec; GpuExpandExec.scala; GpuGenerateExec.scala;
 GpuTopN.scala :: GpuTopN]

The counterparts of the JAX package's ``exec/misc.py`` operators of the
same names, in one process:

* ``TpuRangeExec`` makes each batch's ids on the device
  (``start + arange(bucket) * step``, ``sel = arange < count``): no host
  data and no transfer.
* ``TpuSampleExec`` is the JAX package's stateless hash-Bernoulli draw:
  each live row's ordinal in its partition is hashed (Spark's murmur3
  ``hashInt``) with ``seed + partition`` and kept when the hash is below
  ``fraction * 2^32``; the keep folds into ``sel``.  The running ordinal
  stays a device scalar (no host read per batch), and the CPU oracle
  draws the same rows.  u32 values are held in int64 (torch has no
  uint32 arithmetic), so the compare is unsigned.
* ``TpuExpandExec`` (grouping sets: rollup and cube) emits one batch per
  projection per input batch, each sharing the input's ``sel``.
* ``TpuGenerateExec`` explodes an array column over its padded element
  matrix ``[B, W]``: the (row, element) pairs below each live row's
  length, counted with one host read, become the output's rows in row
  order (a compacted gather of every input column and of the
  elements); the ``outer`` forms keep one row, with a null element and
  position, for a null or empty list.  The output's bytes are reserved
  from the memory arbiter first, so that pool pressure spills other
  holders.
* ``TpuTopNExec``: each child partition reduces to at most ``n`` live
  rows (one stable sort of the batch, ``exec/sort.py::sort_batch``), and
  one more sort of the winners gives the answer.  The planner plans
  ``CpuTopNExec`` (the oracle: a CPU sort and its head) for
  ``Limit(Sort)`` and ``Limit(Project(Sort))``, as Spark's
  TakeOrderedAndProject.

In a multi-executor run each process reduces its slice the same way,
the <= n winner rows allgather host-side through the rendezvous (Arrow
IPC, tiny by construction), and process 0 emits the global answer — the
driver-side final reduce of Spark's TakeOrderedAndProject.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, round_up_pow2)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import _head, concat_device_batches
from spark_rapids_tpu_torch.exec.sort import CpuSortExec, sort_batch
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.ops.hashing import M32, _hash_int_vec
from spark_rapids_tpu_torch.plan.logical import SortOrder


# ---------------------------------------------------------------------------
# Range
# ---------------------------------------------------------------------------

def _range_count(start: int, end: int, step: int) -> int:
    if step == 0:
        raise ValueError("range step must not be 0")
    n = (end - start + step - (1 if step > 0 else -1)) // step
    return max(0, n)


class CpuRangeExec(CpuExec):
    """[REF: basicPhysicalOperators.scala :: GpuRangeExec] (CPU oracle).

    Partition ``p`` holds ids ``[p * per, (p + 1) * per)`` of the
    ``ceil(count / num_partitions)`` per partition, ``batch_rows`` a
    batch; an empty partition yields one empty batch."""

    def __init__(self, start: int, end: int, step: int,
                 schema: T.StructType, num_partitions: int = 1,
                 batch_rows: int = 1 << 20):
        super().__init__(schema)
        self.start, self.end, self.step = start, end, step
        self._num_partitions = max(1, num_partitions)
        self.batch_rows = batch_rows

    def node_string(self):
        return f"Range ({self.start}, {self.end}, step={self.step})"

    def num_partitions(self) -> int:
        return self._num_partitions

    def estimated_size_bytes(self):
        return _range_count(self.start, self.end, self.step) * 8

    def batch_bounds(self, partition: int):
        """(first, end) id ordinal of each batch of the partition."""
        n = _range_count(self.start, self.end, self.step)
        per = -(-n // self._num_partitions)
        lo = min(partition * per, n)
        hi = min(lo + per, n)
        return ([(lo, lo)] if hi == lo else
                [(b0, min(b0 + self.batch_rows, hi))
                 for b0 in range(lo, hi, self.batch_rows)])

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b0, b1 in self.batch_bounds(partition):
            ids = self.start + np.arange(b0, b1, dtype=np.int64) * self.step
            self.metric("numOutputRows").add(len(ids))
            self.metric("numOutputBatches").add(1)
            yield H.HostBatch(self.schema, [H.HostCol(T.LongT, ids)])


class TpuRangeExec(TpuExec):
    """Ids made on the device — no host data, no transfer.

    [REF: basicPhysicalOperators.scala :: GpuRangeExec] (cuDF sequence;
    here one ``start + arange * step``)."""

    def __init__(self, cpu: CpuRangeExec, device: torch.device):
        super().__init__(cpu.schema)
        self.start, self.end, self.step = cpu.start, cpu.end, cpu.step
        self._num_partitions = cpu.num_partitions()
        self.batch_bounds = cpu.batch_bounds
        self.device = device

    def node_string(self):
        return f"TpuRange ({self.start}, {self.end}, step={self.step})"

    def num_partitions(self) -> int:
        return self._num_partitions

    def estimated_size_bytes(self):
        return _range_count(self.start, self.end, self.step) * 8

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        for b0, b1 in self.batch_bounds(partition):
            count = b1 - b0
            bucket = round_up_pow2(max(count, 1))
            with self.timer():
                iota = torch.arange(bucket, dtype=torch.int64,
                                    device=self.device)
                ids = (self.start + b0 * self.step) + iota * self.step
                out = DeviceBatch(self.schema,
                                  (DeviceColumn(T.LongT, ids),),
                                  iota < count, compacted=True)
            self.metric("numOutputRows").add(count)
            self.metric("numOutputBatches").add(1)
            yield out


# ---------------------------------------------------------------------------
# Sample
# ---------------------------------------------------------------------------

def _sample_threshold(fraction: float) -> int:
    return min(int(fraction * 4294967296.0), 0xFFFFFFFF)


class CpuSampleExec(CpuExec):
    """Hash-Bernoulli sample oracle (the same draw as the device path)."""

    def __init__(self, fraction: float, seed: int, child: CpuExec):
        super().__init__(child.schema, child)
        self.fraction = float(fraction)
        self.seed = int(seed)

    def node_string(self):
        return f"Sample [{self.fraction}, seed={self.seed}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        if self.fraction >= 1.0:  # keep-all: h < thresh would drop the
            yield from self.children[0].execute(partition)  # 2^-32 tail
            return
        thresh = _sample_threshold(self.fraction)
        seed = (self.seed + partition) & M32
        base = 0
        for b in self.children[0].execute(partition):
            n = b.num_rows
            ordinals = torch.arange(base, base + n, dtype=torch.int64) & M32
            base += n
            keep = (_hash_int_vec(ordinals, seed) < thresh).numpy()
            cols = [H.HostCol(c.dtype, c.data[keep],
                              None if c.validity is None
                              else c.validity[keep])
                    for c in b.columns]
            out = H.HostBatch(b.schema, cols)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuSampleExec(TpuExec):
    """Stateless Bernoulli sample folded into the sel mask.

    [REF: basicPhysicalOperators.scala :: GpuSampleExec] — the draw is
    hash-based (see the module docstring), so the device result equals
    the CPU oracle's; Spark's own rows cannot be matched anyway (another
    generator), as the reference documents."""

    def __init__(self, fraction: float, seed: int, child: TpuExec):
        super().__init__(child.schema, child)
        self.fraction = float(fraction)
        self.seed = int(seed)

    def node_string(self):
        return f"TpuSample [{self.fraction}, seed={self.seed}]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        if self.fraction >= 1.0:  # keep-all (see the CPU exec)
            yield from self.children[0].execute(partition)
            return
        thresh = _sample_threshold(self.fraction)
        seed = (self.seed + partition) & M32
        base = None  # the running live-row ordinal, a device scalar
        for b in self.children[0].execute(partition):
            with self.timer():
                live = b.sel.to(torch.int64)
                ordinal = torch.cumsum(live, 0) - 1
                if base is not None:
                    ordinal = ordinal + base
                # the ordinal's low 32 bits, hashed and compared as u32
                h = _hash_int_vec(ordinal & M32, seed)
                out = DeviceBatch(b.schema, b.columns,
                                  b.sel & (h < thresh))
                # the ordinal advances by the INPUT live count
                total = live.sum()
                base = total if base is None else base + total
            self.metric("numOutputBatches").add(1)
            yield out


# ---------------------------------------------------------------------------
# Generate (explode / posexplode over array columns)
# ---------------------------------------------------------------------------

class CpuGenerateExec(CpuExec):
    """[REF: GpuGenerateExec.scala :: GpuExplodeBase] (the CPU oracle):
    row by row, a list's elements in order, each with its position."""

    def __init__(self, generator: Expression, with_pos: bool, outer: bool,
                 schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.generator = generator
        self.with_pos = with_pos
        self.outer = outer

    def node_string(self):
        k = "posexplode" if self.with_pos else "explode"
        return f"Generate [{k}{'_outer' if self.outer else ''}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        elem_dt = self.generator.dtype.element_type
        is_str = isinstance(elem_dt, (T.StringType, T.BinaryType))
        npdt = object if is_str else T.to_numpy_dtype(elem_dt)
        fill = "" if is_str else 0
        for b in self.children[0].execute(partition):
            with self.timer():
                arr = self.generator.eval_cpu(b)
                valid = arr.valid_mask(b.num_rows)
                rows: List[int] = []
                poss: List[int] = []
                vals: list = []
                elem_null: List[bool] = []
                pos_null: List[bool] = []  # only outer empty-list rows
                for i in range(b.num_rows):
                    lst = arr.data[i] if valid[i] else []
                    if not lst:
                        if self.outer:
                            rows.append(i)
                            poss.append(0)
                            vals.append(fill)
                            elem_null.append(True)
                            pos_null.append(True)
                        continue
                    for j, v in enumerate(lst):
                        rows.append(i)
                        poss.append(j)
                        vals.append(v if v is not None else fill)
                        elem_null.append(v is None)
                        pos_null.append(False)
                idx = np.asarray(rows, dtype=np.int64)
                cols = [H.HostCol(c.dtype, c.data[idx],
                                  None if c.validity is None
                                  else c.validity[idx])
                        for c in b.columns]
                enulls = np.asarray(elem_null, dtype=bool)
                pnulls = np.asarray(pos_null, dtype=bool)
                if self.with_pos:
                    cols.append(H.HostCol(
                        T.IntegerT, np.asarray(poss, np.int32),
                        ~pnulls if pnulls.any() else None))
                cols.append(H.HostCol(elem_dt, np.asarray(vals, npdt),
                                      ~enulls if enulls.any() else None))
                out = H.HostBatch(self.schema, cols)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuGenerateExec(TpuExec):
    """Explode over the padded element matrix.  [REF:
    GpuGenerateExec.scala] — cuDF explodes by offsets and a gather; the
    JAX package reshapes ``[B, W]`` into ``B * W`` rows with liveness
    (``j < length``) folded into ``sel``.  Here the output holds only
    its live rows (one host read of their count per batch, then a
    compacted gather): a ``[B, W]`` column repeated ``W`` times would
    otherwise make ``B * W * W`` elements, most of them dead."""

    def __init__(self, generator: Expression, with_pos: bool, outer: bool,
                 schema: T.StructType, child: TpuExec):
        super().__init__(schema, child)
        self.generator = generator
        self.with_pos = with_pos
        self.outer = outer

    def node_string(self):
        k = "posexplode" if self.with_pos else "explode"
        return f"TpuGenerate [{k}{'_outer' if self.outer else ''}]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.runtime.memory import get_manager
        mgr = get_manager()
        for b in self.children[0].execute(partition):
            with self.timer():
                arr = self.generator.eval(b)
                keep = generate_mask(b, arr, self.outer)
                n = int(keep.sum())
                cap = round_up_pow2(max(n, 1))
                # the output's working set, reserved before it is made:
                # each input row's bytes once per output row, the
                # element and position columns beside them
                row_bytes = b.nbytes() // b.capacity
                out_bytes = cap * (row_bytes + arr.data.element_size() + 6)
                with mgr.transient(out_bytes):
                    out = generate_batch(b, arr, keep, cap, self.with_pos,
                                         self.outer, self.schema)
            self.metric("numOutputRows").add(n)
            self.metric("numOutputBatches").add(1)
            yield out


def generate_mask(batch: DeviceBatch, arr: DeviceColumn,
                  outer: bool) -> torch.Tensor:
    """bool ``[B, W]``: which (row, element) pairs an explode emits — a
    live row's elements below its length; under ``outer`` also the first
    slot of a live row whose list is null or empty."""
    w = max(int(arr.data.shape[1]), 1)
    j = torch.arange(w, device=arr.data.device)[None, :]
    lens = torch.where(arr.valid_mask(), arr.lengths, 0)[:, None]
    keep = j < lens
    if outer:
        keep = keep | ((lens == 0) & (j == 0))
    return keep & batch.sel[:, None]


def generate_batch(batch: DeviceBatch, arr: DeviceColumn,
                   keep: torch.Tensor, cap: int, with_pos: bool,
                   outer: bool, schema: T.StructType) -> DeviceBatch:
    """The exploded batch of ``cap`` rows: the pairs of ``keep`` in row
    order, then dead padding.  Output row k is element ``j`` of input row
    ``i`` (every input column gathered at ``i``), with position ``j``;
    an outer row for a null or empty list has a null position and
    element.  An element's null rides the ``evalid`` plane."""
    dev = keep.device
    b, w = keep.shape
    flat = keep.reshape(-1).nonzero().flatten()
    n = flat.numel()
    idx = torch.zeros((cap,), dtype=torch.int64, device=dev)
    idx[:n] = flat
    i, j = idx // w, idx % w
    sel = torch.arange(cap, device=dev) < n
    mat = arr.data
    if mat.shape[1] == 0:
        mat = torch.zeros((b, 1), dtype=mat.dtype, device=dev)
    # False on an outer row (a null list's length may be anything)
    real = j < torch.where(arr.valid_mask(), arr.lengths, 0)[i]
    evalid = None
    if outer or arr.evalid is not None:
        evalid = real
        if arr.evalid is not None:
            evalid = evalid & arr.evalid[i, j]
    cols = [c.gather(i) for c in batch.columns]
    if with_pos:
        cols.append(DeviceColumn(T.IntegerT, j.to(torch.int32),
                                 real if outer else None))
    cols.append(DeviceColumn(arr.dtype.element_type, mat[i, j], evalid))
    return DeviceBatch(schema, tuple(cols), sel, compacted=True)


# ---------------------------------------------------------------------------
# Expand (grouping sets: rollup, cube)
# ---------------------------------------------------------------------------

class CpuExpandExec(CpuExec):
    """[REF: GpuExpandExec.scala] — every projection applied to every
    input batch (rows multiply by the number of projections)."""

    def __init__(self, projections: List[List[Expression]],
                 schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.projections = [list(p) for p in projections]

    def node_string(self):
        return f"Expand [{len(self.projections)} projections]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b in self.children[0].execute(partition):
            for proj in self.projections:
                with self.timer():
                    out = H.HostBatch(self.schema,
                                      [e.eval_cpu(b) for e in proj])
                self.metric("numOutputRows").add(out.num_rows)
                self.metric("numOutputBatches").add(1)
                yield out


class TpuExpandExec(TpuExec):
    """One batch per projection per input batch, each sharing the
    input's ``sel`` — no row scatter."""

    def __init__(self, projections: List[List[Expression]],
                 schema: T.StructType, child: TpuExec):
        super().__init__(schema, child)
        self.projections = [list(p) for p in projections]

    def node_string(self):
        return f"TpuExpand [{len(self.projections)} projections]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        for b in self.children[0].execute(partition):
            for proj in self.projections:
                with self.timer():
                    out = DeviceBatch(self.schema,
                                      tuple(e.eval(b) for e in proj),
                                      b.sel, compacted=b.compacted)
                self.metric("numOutputBatches").add(1)
                yield out


# ---------------------------------------------------------------------------
# TakeOrderedAndProject
# ---------------------------------------------------------------------------


class CpuTopNExec(CpuExec):
    """[REF: limit.scala :: GpuTopN] (CPU oracle: global sort + head)."""

    def __init__(self, orders: Sequence[SortOrder], n: int, child: CpuExec):
        super().__init__(child.schema, child)
        self.orders = list(orders)
        self.n = int(n)

    def node_string(self):
        return f"TakeOrderedAndProject [n={self.n}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        inner = CpuSortExec(self.orders, self.children[0])
        for b in inner.execute(0):
            out = _head(b, min(self.n, b.num_rows))
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out
            return


class TpuTopNExec(TpuExec):
    """The first ``n`` rows under ``orders``, in that order."""

    # gathers child partitions, but a multi-executor run merges through
    # an explicit winner-row allgather (exempt from the structural
    # multi-executor gather guard)
    _multiproc_gather_ok = True

    def __init__(self, orders: Sequence[SortOrder], n: int,
                 child: TpuExec):
        super().__init__(child.schema, child)
        self.orders = list(orders)
        self.n = int(n)
        from spark_rapids_tpu_torch.parallel.executor import get_executor
        self._ctx = get_executor()
        self._stage = (self._ctx.next_stage_id()
                       if self._ctx is not None else None)

    def node_string(self):
        return f"TpuTopN [n={self.n}]"

    def num_partitions(self) -> int:
        return 1

    def _top(self, batches: List[DeviceBatch]) -> DeviceBatch:
        """Sorted batch whose live rows are the first ``n``."""
        merged = concat_device_batches(self.schema, batches)
        s = sort_batch(merged, self.orders)
        keep = s.sel & (torch.arange(s.capacity, device=s.device) < self.n)
        return s.with_sel(keep)

    def _local_topn(self, p: int) -> Optional[DeviceBatch]:
        batches = [compact(b) for b in self.children[0].execute(p)]
        if not batches:
            return None
        with self.timer():
            return compact(self._top(batches))

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]
        parts = range(child.num_partitions())
        if self._ctx is not None:
            from spark_rapids_tpu_torch.exec.distributed import (
                owned_partitions)
            parts = owned_partitions(child)
        winners = [w for p in parts
                   for w in [self._local_topn(p)] if w is not None]
        if self._ctx is not None:
            winners = self._merge_across_executors(winners)
            if winners is None:
                return
        if not winners:
            return
        with self.timer():
            out = self._top(winners)
        self.metric("numOutputBatches").add(1)
        yield out

    def _merge_across_executors(self, winners: List[DeviceBatch]
                                ) -> Optional[List[DeviceBatch]]:
        """Allgather <= n local winner rows; only process 0 returns
        batches (the union over executors must not duplicate the global
        answer)."""
        import base64

        import pyarrow as pa

        from spark_rapids_tpu_torch.columnar.column import (
            device_to_host, host_to_device)
        ctx = self._ctx
        payload = None
        device = winners[0].device if winners else ctx.device
        if winners:
            # this process's top-n first: the payload is then <= n rows,
            # not partitions x n
            local = compact(self._top(winners))
            sink = pa.BufferOutputStream()
            table = device_to_host(local)
            with pa.ipc.new_stream(sink, table.schema) as w:
                w.write_table(table)
            payload = base64.b64encode(sink.getvalue().to_pybytes()) \
                .decode()
        replies = ctx.client.allgather(self._stage + ":topn", payload,
                                       ctx.timeout)
        if ctx.process_id != 0:
            return None
        out = []
        for r in replies:
            if r is None:
                continue
            t = pa.ipc.open_stream(base64.b64decode(r)).read_all()
            if t.num_rows:
                out.append(host_to_device(t, device))
        return out


# ---------------------------------------------------------------------------
# Override rules (registered in plan/overrides.py)
# ---------------------------------------------------------------------------

def _convert_range(cpu, ch, conf, device):
    return TpuRangeExec(cpu, device)


def _convert_sample(cpu, ch, conf, device):
    return TpuSampleExec(cpu.fraction, cpu.seed, ch[0])


def _tag_expand(meta):
    for proj in meta.cpu.projections:
        meta.tag_expressions(proj)


def _convert_expand(cpu, ch, conf, device):
    return TpuExpandExec(cpu.projections, cpu.schema, ch[0])


def _tag_topn(meta):
    meta.tag_expressions([o.expr for o in meta.cpu.orders])


def _convert_topn(cpu, ch, conf, device):
    return TpuTopNExec(cpu.orders, cpu.n, ch[0])


def _tag_generate(meta):
    from spark_rapids_tpu_torch.ops.expressions import BoundReference
    gen = meta.cpu.generator
    if not isinstance(gen, BoundReference):
        meta.will_not_work(
            "generator input must be a direct array-column reference")
        return
    et = gen.dtype.element_type
    if not T.is_numeric(et) and not isinstance(
            et, (T.BooleanType, T.DateType, T.TimestampType)):
        meta.will_not_work(
            f"explode over array<{et.simple_name}> not supported on "
            "device (element matrix is numeric-only)")


def _convert_generate(cpu, ch, conf, device):
    return TpuGenerateExec(cpu.generator, cpu.with_pos, cpu.outer,
                           cpu.schema, ch[0])
