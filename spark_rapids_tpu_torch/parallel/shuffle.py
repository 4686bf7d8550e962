"""Bucket splits of device batches: the range partition ids and the
spillable split.

[REF: sql-plugin/../GpuRangePartitioning.scala; GpuOutOfCoreSortIterator]

The port's own copy of four functions of the JAX package's
``parallel/shuffle.py``: ``_sorted_pids`` and ``_partition_bounds``
(rows stably sorted by bucket id, and where each bucket's run starts),
``range_pid_fn`` (a row's bucket by a lexicographic search of its sort
key limbs among sampled boundary rows) and ``split_to_spillables``,
under the out-of-core sort, the join's hash sub-partitioning and the
aggregate's repartitioned merge.
The mesh, the collective exchange and the hash exchange programs of
that module are ROADMAP A.10.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceBatch, compact
from spark_rapids_tpu_torch.runtime.memory import SpillableBatch


def _sorted_pids(batch: DeviceBatch, pid: torch.Tensor, nparts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows stably sorted by destination id, dead rows into an overflow
    bucket ``nparts`` at the end: (sorted ids, permutation)."""
    pid = torch.where(batch.sel, pid.to(torch.int64), nparts)
    return torch.sort(pid, stable=True)


def _partition_bounds(pid_s: torch.Tensor, nparts: int) -> torch.Tensor:
    """Start of each id's run in the sorted ids, and the end of the last:
    int64[nparts + 1]."""
    probe = torch.arange(nparts + 1, dtype=torch.int64, device=pid_s.device)
    return torch.searchsorted(pid_s, probe)


def range_pid_fn(orders) -> Callable:
    """``pids(batch, boundary_limbs)``: each row's range id, the number
    of the ``nparts - 1`` boundary rows at or below its sort key (the
    key's orderable limbs, ``exec/sort.py::_encode_key_limbs``, searched
    lexicographically among the boundaries' limbs)."""
    def pids(batch: DeviceBatch, blimbs: List[torch.Tensor]
             ) -> torch.Tensor:
        from spark_rapids_tpu_torch.exec.join import _lex_search
        from spark_rapids_tpu_torch.exec.sort import _encode_key_limbs
        return _lex_search(blimbs, _encode_key_limbs(batch, orders),
                           "right")

    return pids


def split_to_spillables(batches: List[DeviceBatch], ids_fn, nbuckets: int,
                        mgr, aux=None, chunk_rows: int = 1 << 20
                        ) -> List[List[SpillableBatch]]:
    """Split batches by bucket id (``ids_fn(batch, aux)``), each slice
    registered with the arbiter as an unreserved spillable
    (``SpillableBatch(reserve=False)``, ``live_rows`` set): per bucket,
    its slices in input order.

    The batches coalesce into chunks of at most ``chunk_rows`` rows of
    capacity (a larger batch is a chunk of its own); as this path
    usually runs after a ``RetryOOM``, the cap is lowered so that a
    chunk and its sorted copy fit a quarter of the budget.  Each chunk's
    rows are stably sorted by bucket (dead rows last), one host read
    takes the bucket counts, and each non-empty bucket is cut into one
    compacted slice of ``max(8, next power of two)`` rows.  Within a
    bucket, rows keep their input order.

    DRAINS ``batches`` in place: the caller's frame still holds the
    list, and only emptying it lets the input free as its slices are
    cut."""
    from spark_rapids_tpu_torch.exec.basic import concat_device_batches
    out: List[List[SpillableBatch]] = [[] for _ in range(nbuckets)]
    if not batches:
        return out
    row_b = max(1, batches[0].nbytes() // max(batches[0].capacity, 1))
    budget_rows = max(1024, int(mgr.budget) // (4 * row_b))
    chunk_rows = min(chunk_rows,
                     1 << max(10, budget_rows.bit_length() - 1))
    while batches:
        chunk, acc = [], 0
        while batches and (not chunk
                           or acc + batches[0].capacity <= chunk_rows):
            chunk.append(compact(batches.pop(0)))
            acc += chunk[-1].capacity
        merged = (chunk[0] if len(chunk) == 1 else
                  concat_device_batches(chunk[0].schema, chunk))
        del chunk
        pid_s, perm = _sorted_pids(merged, ids_fn(merged, aux), nbuckets)
        bounds = _partition_bounds(pid_s, nbuckets)
        counts = (bounds[1:] - bounds[:-1]).tolist()  # the chunk's one read
        dev = merged.device
        lo = 0
        for i, n in enumerate(counts):
            if n:
                size = max(8, 1 << (n - 1).bit_length())
                iota = torch.arange(size, device=dev)
                rows = perm[(lo + iota).clamp(0, merged.capacity - 1)]
                sp = SpillableBatch(DeviceBatch(merged.schema, tuple(
                    c.gather(rows) for c in merged.columns), iota < n,
                    compacted=True), mgr, reserve=False)
                sp.live_rows = n
                out[i].append(sp)
            lo += n
        del merged, pid_s, perm
    return out
