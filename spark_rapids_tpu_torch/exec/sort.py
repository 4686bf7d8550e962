"""Device sort: in-core, or out-of-core by range partitioning.

[REF: sql-plugin/../GpuSortExec.scala :: GpuSortExec,
 GpuOutOfCoreSortIterator]

The counterpart of the JAX package's ``exec/sort.py::TpuSortExec`` and
``sort_batch`` on the exact rung: one stable lexicographic sort over the
orderable key limbs of ``ops/ordering.py`` (direction and null
placement baked into the encoding), dead rows last.  The in-core sort
reserves its working set (the input and its sorted copy, ``2 x`` the
input's bytes) with the memory arbiter.  When that raises ``RetryOOM``
the sort goes out of core, the scheme Spark uses for a total-order range
exchange:

1. the key limbs of a few live rows of every input batch are sampled
   (8x the range count) and the host picks ``nranges - 1`` quantile
   boundary rows;
2. every row gets its range id by a lexicographic search among the
   boundaries, and ``parallel/shuffle.py::split_to_spillables`` cuts the
   input into per-range slices registered as spillables (the input
   frees as it is cut);
3. the ranges are restored, concatenated and sorted one at a time, each
   under its own reservation, which spills the other ranges' slices to
   host: the output is one batch per non-empty range, in order, and
   equals the in-core result row for row (the split is stable).

Under ``spark.rapids.shuffle.mode=ICI`` on a mesh of more than one rank
the sort is ``partitioned``: it sorts each partition of a range exchange
(``exec/distributed.py::TpuIciRangeExchangeExec``) on its own, and the
partitions in order are the total order.  The JAX package's tiled
segmented sort (``kernels/segmented_sort.py``, an XLA trade for the TPU)
is B.11.  ``CpuSortExec`` is the JAX package's
numpy oracle: one ``np.lexsort`` over ``ordering.np_order_keys`` limbs,
stable.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import DeviceBatch, compact
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import concat_device_batches
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.runtime.memory import RetryOOM, get_manager


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
    """Global sort of every input partition: in one device batch when
    the arbiter grants ``2 x`` the input's bytes, else out of core (see
    the module docstring)."""

    def __init__(self, orders: Sequence[SortOrder], child: TpuExec,
                 partitioned: bool = False):
        super().__init__(child.schema, child)
        self.orders = list(orders)
        # downstream of a RANGE exchange: each partition sorts locally
        # and ascending partition order IS the total order
        self.partitioned = partitioned

    def node_string(self):
        part = " partitioned" if self.partitioned else ""
        return (f"TpuSort{part} "
                f"[{', '.join(str(o.expr) for o in self.orders)}]")

    def num_partitions(self) -> int:
        if self.partitioned:
            return self.children[0].num_partitions()
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]
        parts = ([partition] if self.partitioned
                 else range(child.num_partitions()))
        batches = [compact(b) for p in parts for b in child.execute(p)]
        if not batches:
            return
        mgr = get_manager()
        total = sum(b.nbytes() for b in batches)
        try:
            # in-core: the input and its sorted copy live together
            with mgr.transient(2 * total):
                with self.timer():
                    merged = concat_device_batches(self.schema, batches)
                    out = sort_batch(merged, self.orders)
                self.metric("numOutputBatches").add(1)
                yield out
                return
        except RetryOOM:
            self.metric("outOfCoreSorts").add(1)
        yield from self._out_of_core(batches, total, mgr)

    def _out_of_core(self, batches: List[DeviceBatch], total: int, mgr
                     ) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.parallel.shuffle import (
            split_to_spillables)
        orders = self.orders
        # ranges sized so that one range's working set (~2x) fits
        nranges = max(2, min(64, -(-total // max(mgr.budget // 4, 1))))
        bounds = _sample_boundaries(batches, orders, nranges)
        with self.timer():
            # drains ``batches``, so the input frees as it is cut
            slices = split_to_spillables(
                batches, lambda b, aux: _range_ids(b, orders, aux),
                nranges, mgr, aux=bounds)
        for r in range(nranges):
            if not slices[r]:
                continue
            range_bytes = sum(sp.nbytes for sp in slices[r])
            # the range's reservation pushes other ranges' slices (and
            # older registrations) to host; clamped to the budget, as a
            # range's padded slices can pass a tiny one
            with mgr.transient(min(2 * range_bytes, mgr.budget)):
                with self.timer():
                    parts = [sp.get() for sp in slices[r]]
                    merged = concat_device_batches(
                        self.schema, parts,
                        [sp.live_rows for sp in slices[r]])
                    out = sort_batch(merged, orders)
                    for sp in slices[r]:
                        sp.close()
                    del parts, merged
            slices[r] = []
            self.metric("numOutputBatches").add(1)
            yield out


def _encode_key_limbs(batch: DeviceBatch, orders: Sequence[SortOrder]
                      ) -> List[torch.Tensor]:
    """The sort keys' fused orderable limbs (dead rows not flagged)."""
    parts = []
    for o in orders:
        parts.extend(ORD.column_order_parts(o.expr.eval(batch),
                                            o.ascending, o.nulls_first))
    return ORD.fuse_parts(parts)


def pick_quantile_boundaries(cols: List[np.ndarray], nranges: int
                             ) -> List[np.ndarray]:
    """Host quantile pick over sampled key limbs (uint64 or float64
    arrays, most significant first): per limb, the ``nranges - 1``
    boundary rows."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return [np.zeros(max(nranges - 1, 0), np.uint64) for _ in cols]
    order = np.lexsort(list(reversed(cols)))
    picks = [order[min(n - 1, (i + 1) * n // nranges)]
             for i in range(nranges - 1)]
    return [c[picks] for c in cols]


def _sample_boundaries(batches: List[DeviceBatch],
                       orders: Sequence[SortOrder], nranges: int
                       ) -> List[torch.Tensor]:
    """Boundary key limbs of ``nranges`` ranges (each a tensor of
    ``nranges - 1`` rows on the batches' device): the first live rows of
    every batch (8 x ``nranges`` in all; row 0 where a batch has fewer),
    quantiles picked on the host."""
    take = max(1, (nranges * 8) // max(len(batches), 1))
    samples = []
    for b in batches:
        # the batches are compacted: their live rows are a prefix
        idx = torch.arange(min(take, b.capacity, 1024), device=b.device)
        idx = torch.where(b.sel[idx], idx, 0)
        samples.append([l[idx] for l in _encode_key_limbs(b, orders)])
    limbs = [torch.cat([s[i] for s in samples]).cpu()
             for i in range(len(samples[0]))]
    # int64 limbs hold unsigned bit patterns: the host orders them as u64
    cols = [l.numpy().view(np.uint64) if l.dtype == torch.int64
            else l.numpy() for l in limbs]
    dev = batches[0].device
    return [torch.from_numpy(np.ascontiguousarray(c).view(np.int64)
                             if c.dtype == np.uint64 else c).to(dev)
            for c in pick_quantile_boundaries(cols, nranges)]


def _range_ids(batch: DeviceBatch, orders: Sequence[SortOrder],
               bounds: List[torch.Tensor]) -> torch.Tensor:
    """Range id per row (``parallel/shuffle.py::range_pid_fn``)."""
    from spark_rapids_tpu_torch.parallel.shuffle import range_pid_fn
    return range_pid_fn(orders)(batch, bounds)


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
    from spark_rapids_tpu_torch.exec.distributed import (
        TpuIciRangeExchangeExec, exchange_opts, ici_active)
    if ici_active(conf, device):
        # distributed total order: range exchange (sampled boundaries)
        # + per-partition local sort; ascending partition index IS the
        # global order [REF: GpuRangePartitioning.scala]
        ex = TpuIciRangeExchangeExec(ch[0], cpu.orders, device=device,
                                     **exchange_opts(conf))
        return TpuSortExec(cpu.orders, ex, partitioned=True)
    return TpuSortExec(cpu.orders, ch[0])
