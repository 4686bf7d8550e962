"""Basic physical operators: scan, project, filter, coalesce.

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuProjectExec,
 GpuFilterExec; GpuCoalesceBatches.scala]

The counterparts of the JAX package's ``exec/basic.py`` operators of the
same names:

* ``TpuFilterExec`` never changes shapes — it ANDs the predicate into
  the batch ``sel`` mask (a null predicate drops the row).
* ``TpuProjectExec`` evaluates the bound expressions per batch.
* Both are fusible: a consumer (the aggregate) pulls from the scan and
  applies them itself.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, host_to_device, round_up_pow2)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.ops.expressions import Expression


class TpuScanExec(TpuExec):
    """In-memory arrow table scan -> padded DeviceBatch per ``batch_rows``
    slice: the host-to-device transfer point (timed as
    ``transferTime``).  An empty table still yields one batch (with no
    live row), so consumers always see at least one."""

    def __init__(self, table: pa.Table, schema: T.StructType,
                 device: torch.device, batch_rows: int = 1 << 20,
                 min_bucket: int = 1024):
        super().__init__(schema)
        self.table = table
        self.device = device
        self.batch_rows = batch_rows
        self.min_bucket = min_bucket

    def estimated_size_bytes(self):
        return self.table.nbytes

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        if partition != 0:
            raise IndexError(f"partition {partition} of a 1-partition scan")
        n = self.table.num_rows
        for lo in range(0, max(n, 1), self.batch_rows):
            chunk = self.table.slice(lo, self.batch_rows)
            with self.timer("transferTime"):
                b = host_to_device(chunk, self.device,
                                   min_bucket=self.min_bucket)
                b = DeviceBatch(self.schema, b.columns, b.sel,
                                compacted=True)
            self.metric("numOutputRows").add(chunk.num_rows)
            self.metric("numOutputBatches").add(1)
            yield b


class TpuProjectExec(TpuExec):
    """[REF: basicPhysicalOperators.scala :: GpuProjectExec]"""

    def __init__(self, exprs: Sequence[Expression], schema: T.StructType,
                 child: TpuExec):
        super().__init__(schema, child)
        self.exprs = list(exprs)

    def node_string(self):
        return f"TpuProject [{', '.join(str(e) for e in self.exprs)}]"

    def fusion(self):
        exprs, schema = self.exprs, self.schema

        def run(batch):
            return DeviceBatch(schema, tuple(e.eval(batch) for e in exprs),
                               batch.sel, compacted=batch.compacted)

        return run

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        run = self.fusion()
        for b in self.children[0].execute(partition):
            with self.timer():
                out = run(b)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuFilterExec(TpuExec):
    """Predicate folds into ``sel`` — no shape change, no compaction.

    [REF: basicPhysicalOperators.scala :: GpuFilterExec]
    """

    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child.schema, child)
        self.condition = condition

    def node_string(self):
        return f"TpuFilter [{self.condition}]"

    def fusion(self):
        cond = self.condition

        def run(batch):
            c = cond.eval(batch)
            keep = c.data.to(torch.bool)
            if c.validity is not None:
                keep = keep & c.validity
            return batch.with_sel(batch.sel & keep)

        return run

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        run = self.fusion()
        for b in self.children[0].execute(partition):
            with self.timer():
                out = run(b)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuCoalesceBatchesExec(TpuExec):
    """Concatenate all device batches of the partition into one — the
    RequireSingleBatch goal, what the global sort above it needs (the
    JAX package's row-budget goal has no caller on this slice yet).

    [REF: GpuCoalesceBatches.scala :: GpuCoalesceBatches]
    """

    def __init__(self, child: TpuExec):
        super().__init__(child.schema, child)

    def node_string(self):
        return "TpuCoalesceBatches [single]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        pending = [compact(b) for b in self.children[0].execute(partition)]
        if not pending:
            return
        with self.timer("concatTime"):
            out = concat_device_batches(self.schema, pending)
        self.metric("numOutputBatches").add(1)
        yield out


def live_counts(batches: Sequence[DeviceBatch]) -> List[int]:
    """Live-row counts of many batches with one device-to-host read."""
    if not batches:
        return []
    return torch.stack([b.sel.sum() for b in batches]).tolist()


def concat_device_batches(schema: T.StructType,
                          batches: List[DeviceBatch],
                          counts: Optional[List[int]] = None
                          ) -> DeviceBatch:
    """Concatenate device batches into one bucketed batch: the live rows
    of each batch in order, padded to the power-of-two bucket of the
    total (the JAX package's ``concat_device_batches`` layout).

    ``counts`` (live rows per batch) may be passed by callers that know
    them, saving the device read.
    """
    if not batches:
        raise ValueError("concat of no batches")
    if len(batches) == 1:
        return batches[0]
    batches = [compact(b) for b in batches]
    if counts is None:
        counts = live_counts(batches)
    total = sum(counts)
    bucket = round_up_pow2(max(total, 1))
    dev = batches[0].device
    cols = []
    for ci, f in enumerate(schema.fields):
        parts = [b.columns[ci] for b in batches]
        is_str = parts[0].is_string
        data = torch.zeros(
            (bucket,) + ((max(p.data.shape[1] for p in parts),)
                         if is_str else ()),
            dtype=parts[0].data.dtype, device=dev)
        any_val = any(p.validity is not None for p in parts)
        validity = (torch.zeros((bucket,), dtype=torch.bool, device=dev)
                    if any_val else None)
        lengths = (torch.zeros((bucket,), dtype=torch.int32, device=dev)
                   if is_str else None)
        at = 0
        for p, n in zip(parts, counts):
            if is_str:
                data[at:at + n, :p.data.shape[1]] = p.data[:n]
                lengths[at:at + n] = p.lengths[:n]
            else:
                data[at:at + n] = p.data[:n]
            if any_val:
                validity[at:at + n] = (p.validity[:n] if p.validity
                                       is not None else True)
            at += n
        cols.append(DeviceColumn(f.dtype, data, validity, lengths))
    sel = torch.arange(bucket, device=dev) < total
    return DeviceBatch(schema, tuple(cols), sel, compacted=True)
