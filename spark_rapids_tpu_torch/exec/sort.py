"""In-core device sort.

[REF: sql-plugin/../GpuSortExec.scala :: GpuSortExec]

The counterpart of the JAX package's ``exec/sort.py::TpuSortExec`` and
``sort_batch`` on the exact rung: one stable lexicographic sort over the
orderable key limbs of ``ops/ordering.py`` (direction and null
placement baked into the encoding), dead rows last.  The JAX package's
out-of-core range-partitioned path and its tiled segmented sort
(``kernels/segmented_sort.py``, an XLA trade for the TPU) are not
ported.  ``CpuSortExec`` is the JAX package's numpy oracle: one
``np.lexsort`` over ``ordering.np_order_keys`` limbs, stable.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import DeviceBatch, compact
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import concat_device_batches
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.plan.logical import SortOrder


class CpuSortExec(CpuExec):
    """Numpy-oracle global sort (gathers all partitions)."""

    def __init__(self, orders: Sequence[SortOrder], child: CpuExec):
        super().__init__(child.schema, child)
        self.orders = list(orders)

    def node_string(self):
        return f"Sort [{', '.join(str(o.expr) for o in self.orders)}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child = self.children[0]
        batches = [b for p in range(child.num_partitions())
                   for b in child.execute(p)]
        if not batches:
            return
        merged = _concat_host(self.schema, batches)
        limbs: List[np.ndarray] = []
        for o in self.orders:
            c = o.expr.eval_cpu(merged)
            limbs.extend(ORD.np_order_keys(
                c.data, c.validity, c.dtype, o.ascending, o.nulls_first))
        n = merged.num_rows
        limbs.append(np.arange(n, dtype=np.int64).view(np.uint64))  # stable
        perm = np.lexsort(list(reversed(limbs)))
        cols = [H.HostCol(c.dtype, c.data[perm],
                          None if c.validity is None else c.validity[perm])
                for c in merged.columns]
        yield H.HostBatch(self.schema, cols)


def _concat_host(schema, batches: List[H.HostBatch]) -> H.HostBatch:
    if len(batches) == 1:
        return batches[0]
    cols = []
    for i, f in enumerate(schema.fields):
        any_val = any(b.columns[i].validity is not None for b in batches)
        data = np.concatenate([b.columns[i].data for b in batches])
        validity = None
        if any_val:
            validity = np.concatenate([
                b.columns[i].validity if b.columns[i].validity is not None
                else np.ones(len(b.columns[i].data), bool)
                for b in batches])
        cols.append(H.HostCol(f.dtype, data, validity))
    return H.HostBatch(schema, cols)


class TpuSortExec(TpuExec):
    """Global sort of all input batches in one device batch."""

    def __init__(self, orders: Sequence[SortOrder], child: TpuExec):
        super().__init__(child.schema, child)
        self.orders = list(orders)

    def node_string(self):
        return f"TpuSort [{', '.join(str(o.expr) for o in self.orders)}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]
        batches = [compact(b) for p in range(child.num_partitions())
                   for b in child.execute(p)]
        if not batches:
            return
        with self.timer():
            merged = concat_device_batches(self.schema, batches)
            out = sort_batch(merged, self.orders)
        self.metric("numOutputBatches").add(1)
        yield out


def sort_batch(batch: DeviceBatch,
               orders: Sequence[SortOrder]) -> DeviceBatch:
    """Stable sort of live rows by the given orders; dead rows to the end."""
    parts = [ORD._flag_part(~batch.sel)]
    for o in orders:
        c = o.expr.eval(batch)
        parts.extend(ORD.column_order_parts(c, o.ascending, o.nulls_first))
    _, perm = ORD.sort_by_keys(ORD.fuse_parts(parts))
    cols = tuple(c.gather(perm) for c in batch.columns)
    return DeviceBatch(batch.schema, cols, batch.sel[perm])


def _tag_sort(meta):
    meta.tag_expressions([o.expr for o in meta.cpu.orders])


def _convert_sort(cpu, ch, conf, device):
    return TpuSortExec(cpu.orders, ch[0])
