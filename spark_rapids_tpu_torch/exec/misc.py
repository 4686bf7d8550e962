"""Miscellaneous operators — the top-N (TakeOrderedAndProject) only, so
far.

[REF: sql-plugin/../GpuTopN.scala :: GpuTopN]

The counterpart of the JAX package's ``exec/misc.py::TpuTopNExec`` in
one process: each child partition reduces to at most ``n`` live rows
(one stable sort of the batch, ``exec/sort.py::sort_batch``), and one
more sort of the winners gives the answer.  The planner plans
``CpuTopNExec`` (the oracle: a CPU sort and its head) for
``Limit(Sort)`` and ``Limit(Project(Sort))``, as Spark's
TakeOrderedAndProject, and the plan rewrite converts it.  The JAX package's multi-executor merge and its
other operators (Expand, Generate, Range, Sample, limits without a
sort) are later slices.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import DeviceBatch, compact
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import _head, concat_device_batches
from spark_rapids_tpu_torch.exec.sort import CpuSortExec, sort_batch
from spark_rapids_tpu_torch.plan.logical import SortOrder


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


def _tag_topn(meta):
    meta.tag_expressions([o.expr for o in meta.cpu.orders])


def _convert_topn(cpu, ch, conf, device):
    return TpuTopNExec(cpu.orders, cpu.n, ch[0])
