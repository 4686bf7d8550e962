"""Other operators: Range, Sample, Expand and the top-N
(TakeOrderedAndProject).

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuRangeExec,
 GpuSampleExec; GpuExpandExec.scala; GpuTopN.scala :: GpuTopN]

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
* ``TpuTopNExec``: each child partition reduces to at most ``n`` live
  rows (one stable sort of the batch, ``exec/sort.py::sort_batch``), and
  one more sort of the winners gives the answer.  The planner plans
  ``CpuTopNExec`` (the oracle: a CPU sort and its head) for
  ``Limit(Sort)`` and ``Limit(Project(Sort))``, as Spark's
  TakeOrderedAndProject.

The JAX package's multi-executor top-N merge is ROADMAP A.10 and its
Generate (explode) A.8.
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

    def __init__(self, orders: Sequence[SortOrder], n: int,
                 child: TpuExec):
        super().__init__(child.schema, child)
        self.orders = list(orders)
        self.n = int(n)

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
        winners = [w for p in range(self.children[0].num_partitions())
                   for w in [self._local_topn(p)] if w is not None]
        if not winners:
            return
        with self.timer():
            out = self._top(winners)
        self.metric("numOutputBatches").add(1)
        yield out


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
