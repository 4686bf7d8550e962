"""Basic physical operators: scan, project, filter, limits, union,
coalesce.

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuProjectExec,
 GpuFilterExec, GpuUnionExec; GpuCoalesceBatches.scala; limit.scala]

The counterparts of the JAX package's ``exec/basic.py`` operators of the
same names.  The ``Cpu*`` execs are the numpy fallback and oracle path
the planner plans first (``plan/overrides.py`` converts what it can).
On the device:

* ``TpuScanExec`` caches the device batches of an in-memory table and
  registers them with the memory arbiter (``runtime/memory.py``).
* ``TpuFilterExec`` never changes shapes — it ANDs the predicate into
  the batch ``sel`` mask (a null predicate drops the row).
* ``TpuProjectExec`` evaluates the bound expressions per batch.
* Both are fusible: a consumer (the aggregate) pulls from the scan and
  applies them itself.
* ``TpuLocalLimitExec`` / ``TpuGlobalLimitExec`` keep the first n live
  rows by a live-prefix mask (``cumsum(sel) <= remaining``), one host
  read of the kept count per batch.  Both stop pulling as soon as n rows
  are out (the JAX package's pull one batch more, and the global limit
  one batch of the next partition); the global limit pulls the child's
  partitions one after another.  In a multi-executor run LIMIT takes
  ANY n rows (Spark semantics): the processes allgather their capped
  live-row counts through the rendezvous and each emits its quota of
  the first-come budget in process order.  Their subtrees are pumped
  without prefetch (``exec/base.py::no_prefetch_below``), else a
  producer would run a batch past the one that completes the rows.
* ``TpuUnionExec``: the partitions of its children one after another,
  under the first child's schema.
"""

from __future__ import annotations

import threading
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, host_to_device, round_up_pow2)
from spark_rapids_tpu_torch.exec.base import (
    CpuExec, TpuExec, no_prefetch_below)
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.runtime.memory import (
    RetryOOM, SpillableBatch, get_manager)


def _slice_table(table: pa.Table, num_partitions: int) -> List[pa.Table]:
    """The scan partitions of an in-memory table: ``num_partitions``
    contiguous row ranges of ``ceil(n / num_partitions)`` rows (the last
    ones shorter or empty)."""
    n = table.num_rows
    if num_partitions <= 1:
        return [table]
    step = (n + num_partitions - 1) // num_partitions
    out = []
    for i in range(num_partitions):
        lo = min(i * step, n)
        out.append(table.slice(lo, min(step, n - lo)))
    return out


class CpuScanExec(CpuExec):
    """In-memory arrow table scan -> HostBatch per ``batch_rows`` slice
    of each partition."""

    def __init__(self, table: pa.Table, schema: T.StructType,
                 num_partitions: int = 1, batch_rows: int = 1 << 20):
        super().__init__(schema)
        self.table = table
        self._num_partitions = num_partitions
        self.batch_rows = batch_rows

    def num_partitions(self) -> int:
        return self._num_partitions

    def estimated_size_bytes(self):
        return self.table.nbytes

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        part = _slice_table(self.table, self._num_partitions)[partition]
        for lo in range(0, max(part.num_rows, 1), self.batch_rows):
            chunk = part.slice(lo, self.batch_rows)
            if chunk.num_rows == 0 and lo > 0:
                break
            with self.timer():
                b = H.from_arrow_table(chunk)
                b = H.HostBatch(self.schema, b.columns)
            self.metric("numOutputRows").add(b.num_rows)
            self.metric("numOutputBatches").add(1)
            yield b


# Device-resident cache of in-memory relations: repeated executions of a
# query over the same table skip the host-to-device transfer (the
# steady-state regime the JAX package benchmarks; the analog of Spark's
# columnar cache).  Entries die with their table.
_scan_cache: dict = {}
_scan_cache_lock = threading.Lock()


def _scan_cache_get(table: pa.Table, key):
    with _scan_cache_lock:
        ent = _scan_cache.get(id(table))
        return None if ent is None else ent.get(key)


def _scan_cache_evict(tid):
    with _scan_cache_lock:
        entries = _scan_cache.pop(tid, None)
    if entries:
        for pairs in entries.values():
            for sp, _ in pairs:
                sp.close()  # releases the arbiter's accounting


def clear_scan_cache():
    """Evict every cached scan (e.g. when the budget arbiter is
    replaced — registrations against the old arbiter would go stale)."""
    for tid in list(_scan_cache):
        _scan_cache_evict(tid)


def _scan_cache_put(table: pa.Table, key, batches):
    tid = id(table)
    with _scan_cache_lock:
        entries = _scan_cache.get(tid)
        if entries is None:
            try:
                weakref.finalize(table, _scan_cache_evict, tid)
            except TypeError:  # not weak-referenceable: never cached
                pass
            else:
                entries = _scan_cache[tid] = {}
        if entries is not None and key not in entries:
            entries[key] = batches
            return
    # lost a build race (readers may already hold the installed list, so
    # the first put wins) or cannot cache: close ours
    for sp, _ in batches:
        sp.close()


class TpuScanExec(TpuExec):
    """In-memory arrow table scan -> padded DeviceBatch per ``batch_rows``
    slice of each partition: the host-to-device transfer point (timed as
    ``transferTime``).  An empty table still yields one batch (with no
    live row), so consumers always see at least one per partition.

    The first run over a table registers its batches with the memory
    arbiter and caches them; later runs yield the cached batches
    (restoring any the arbiter spilled to host) and add no
    ``transferTime``.  Cached tensors are shared by every later query,
    so no consumer may write into a scan batch in place.
    """

    def __init__(self, table: pa.Table, schema: T.StructType,
                 device: torch.device, num_partitions: int = 1,
                 batch_rows: int = 1 << 20, min_bucket: int = 1024,
                 executor: Tuple[int, int] = (0, 1)):
        super().__init__(schema)
        self.table = table
        self.device = device
        self._num_partitions = num_partitions
        self.batch_rows = batch_rows
        self.min_bucket = min_bucket
        # (executor_id, executor_count): in multi-executor mode each
        # process serves only source partitions p = id (mod count) — the
        # analog of the Spark scheduler assigning scan tasks to
        # executors; the union over processes is exactly the table
        self.executor = tuple(executor)

    def num_partitions(self) -> int:
        return self._num_partitions

    def estimated_size_bytes(self):
        return self.table.nbytes

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        eid, ecount = self.executor
        if ecount > 1 and partition % ecount != eid:
            return
        # the JAX package's key (num_partitions, batch_rows, min_bucket,
        # partition), plus the device: sessions of one process may run
        # on different devices.  Each partition is an entry of its own.
        key = (self._num_partitions, self.batch_rows, self.min_bucket,
               partition, str(self.device))
        cached = _scan_cache_get(self.table, key)
        if cached is None:
            yield from self._stream(partition, key, register=True)
            return
        for bi, (sp, nrows) in enumerate(cached):
            try:
                # restores the batch if the arbiter spilled it
                restored = sp.get()
            except RetryOOM:
                # no room to restore: drop the cache and stream the
                # REMAINDER from the arrow table (earlier batches were
                # already yielded — restarting at 0 would duplicate rows)
                _scan_cache_evict(id(self.table))
                yield from self._stream(partition, start_batch=bi)
                return
            self.metric("numOutputRows").add(nrows)
            self.metric("numOutputBatches").add(1)
            yield restored

    def _stream(self, partition: int, key=None, register: bool = False,
                start_batch: int = 0) -> Iterator[DeviceBatch]:
        out = []
        part = _slice_table(self.table, self._num_partitions)[partition]
        n = part.num_rows
        start = start_batch * self.batch_rows
        if start and start >= n:
            return
        for lo in range(start, max(n, 1), self.batch_rows):
            chunk = part.slice(lo, self.batch_rows)
            with self.timer("transferTime"):
                b = host_to_device(chunk, self.device,
                                   min_bucket=self.min_bucket)
                b = DeviceBatch(self.schema, b.columns, b.sel,
                                compacted=True)
            nrows = chunk.num_rows
            self.metric("numOutputRows").add(nrows)
            self.metric("numOutputBatches").add(1)
            if register and out is not None:
                # cache entries are the arbiter's reclaim pool; a full
                # budget (or an injected OOM) only means this scan is
                # not cached, never a query failure
                try:
                    out.append((SpillableBatch(b, get_manager()), nrows))
                except RetryOOM:
                    for sp, _ in out:
                        sp.close()
                    out = None
            try:
                yield b
            except GeneratorExit:
                # abandoned mid-partition (a limit has its rows): the
                # partial registrations would hold arbiter bytes that
                # no cache entry reads
                for sp, _ in out or ():
                    sp.close()
                raise
        if register and out is not None:
            _scan_cache_put(self.table, key, out)


class CpuProjectExec(CpuExec):
    def __init__(self, exprs: Sequence[Expression], schema: T.StructType,
                 child: CpuExec):
        super().__init__(schema, child)
        self.exprs = list(exprs)

    def node_string(self):
        return f"Project [{', '.join(str(e) for e in self.exprs)}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b in self.children[0].execute(partition):
            with self.timer():
                cols = [e.eval_cpu(b) for e in self.exprs]
                out = H.HostBatch(self.schema, cols)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuProjectExec(TpuExec):
    """[REF: basicPhysicalOperators.scala :: GpuProjectExec]"""

    def __init__(self, exprs: Sequence[Expression], schema: T.StructType,
                 child: TpuExec):
        super().__init__(schema, child)
        self.exprs = list(exprs)

    def node_string(self):
        return f"TpuProject [{', '.join(str(e) for e in self.exprs)}]"

    def fusion(self):
        from spark_rapids_tpu_torch.runtime.kernel_cache import fingerprint
        exprs, schema = self.exprs, self.schema

        def run(batch):
            return DeviceBatch(schema, tuple(e.eval(batch) for e in exprs),
                               batch.sel, compacted=batch.compacted)

        return run, ("project", fingerprint(exprs), fingerprint(schema))

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        run, _ = self.fusion()
        for b in self.children[0].execute(partition):
            with self.timer():
                out = run(b)
            self.metric("numOutputBatches").add(1)
            yield out


class CpuFilterExec(CpuExec):
    def __init__(self, condition: Expression, child: CpuExec):
        super().__init__(child.schema, child)
        self.condition = condition

    def node_string(self):
        return f"Filter [{self.condition}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b in self.children[0].execute(partition):
            with self.timer():
                c = self.condition.eval_cpu(b)
                keep = c.data.astype(bool)
                if c.validity is not None:
                    keep = keep & c.validity  # null predicate drops the row
                cols = [H.HostCol(col.dtype, col.data[keep],
                                  None if col.validity is None
                                  else col.validity[keep])
                        for col in b.columns]
                out = H.HostBatch(b.schema, cols)
            self.metric("numOutputRows").add(out.num_rows)
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
        from spark_rapids_tpu_torch.runtime.kernel_cache import fingerprint
        cond = self.condition

        def run(batch):
            c = cond.eval(batch)
            keep = c.data.to(torch.bool)
            if c.validity is not None:
                keep = keep & c.validity
            return batch.with_sel(batch.sel & keep)

        return run, ("filter", fingerprint(cond))

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        run, _ = self.fusion()
        for b in self.children[0].execute(partition):
            with self.timer():
                out = run(b)
            self.metric("numOutputBatches").add(1)
            yield out


def _head(b: H.HostBatch, take: int) -> H.HostBatch:
    return H.HostBatch(b.schema, [
        H.HostCol(c.dtype, c.data[:take],
                  None if c.validity is None else c.validity[:take])
        for c in b.columns])


class CpuLocalLimitExec(CpuExec):
    def __init__(self, n: int, child: CpuExec):
        super().__init__(child.schema, child)
        self.n = n

    def node_string(self):
        return f"LocalLimit [{self.n}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        remaining = self.n
        for b in self.children[0].execute(partition):
            if remaining <= 0:
                break
            take = min(remaining, b.num_rows)
            remaining -= take
            yield _head(b, take)


class CpuGlobalLimitExec(CpuExec):
    """Single-partition global cut across all child partitions.

    [REF: limit.scala :: GpuGlobalLimitExec] — planned above a per-
    partition LocalLimit, exactly Spark's GlobalLimit(LocalLimit(...)).
    """

    def __init__(self, n: int, child: CpuExec):
        super().__init__(child.schema, child)
        self.n = n

    def node_string(self):
        return f"GlobalLimit [{self.n}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        remaining = self.n
        child = self.children[0]
        for p in range(child.num_partitions()):
            for b in child.execute(p):
                if remaining <= 0:
                    return
                take = min(remaining, b.num_rows)
                remaining -= take
                yield _head(b, take)


def _live_prefix(b: DeviceBatch, remaining: int):
    """(the batch with only its first ``remaining`` live rows live, how
    many it kept): a mask, no shape change; the count is the limit's one
    host read per batch."""
    keep = b.sel & (torch.cumsum(b.sel.to(torch.int32), 0) <= remaining)
    return (DeviceBatch(b.schema, b.columns, keep, compacted=b.compacted),
            int(keep.sum()))


class TpuLocalLimitExec(TpuExec):
    """Keep the first n live rows of the partition (batch order).

    [REF: limit.scala :: GpuLocalLimitExec]
    """

    def __init__(self, n: int, child: TpuExec):
        super().__init__(child.schema, child)
        self.n = n

    def node_string(self):
        return f"TpuLocalLimit [{self.n}]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        no_prefetch_below(self)
        yield from _limit(self, self.n,
                          [self.children[0].execute(partition)])


class TpuGlobalLimitExec(TpuExec):
    """The first n live rows across the child's partitions, in partition
    order, as one partition.  [REF: limit.scala :: GpuGlobalLimitExec]

    Multi-executor mode: LIMIT takes ANY n rows (Spark semantics), so no
    row exchange is needed — processes allgather their live-row counts
    and each emits its quota of the first-come budget in process order.
    """

    _multiproc_gather_ok = True

    def __init__(self, n: int, child: TpuExec):
        super().__init__(child.schema, child)
        self.n = n
        from spark_rapids_tpu_torch.parallel.executor import get_executor
        self._ctx = get_executor()
        self._stage = (self._ctx.next_stage_id()
                       if self._ctx is not None else None)

    def node_string(self):
        return f"TpuGlobalLimit [{self.n}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]
        no_prefetch_below(self)
        if self._ctx is None:
            # lazily: a partition's pump starts only if rows are still
            # wanted
            yield from _limit(self, self.n, (child.execute(p) for p in
                                             range(child.num_partitions())))
            return
        from spark_rapids_tpu_torch.exec.distributed import owned_partitions
        ctx = self._ctx
        # drain only until n local rows are seen — reporting the CAPPED
        # count keeps the quota math exact (counts past n can never
        # change any process's quota) while keeping the early stop
        batches: List[DeviceBatch] = []
        local = 0
        for p in owned_partitions(child):
            if local >= self.n:
                break
            part = list(child.execute(p))
            if part:
                batches.extend(part)
                local += sum(live_counts(part))
        replies = ctx.client.allgather(
            self._stage + ":limit", min(local, self.n), ctx.timeout)
        before = sum(replies[:ctx.process_id])
        yield from _limit(self, max(0, min(local, self.n - before)),
                          [iter(batches)])


def _limit(node: TpuExec, n: int, streams) -> Iterator[DeviceBatch]:
    """The first ``n`` live rows of the streams' batches, in order.  The
    check follows each yield, so no batch is pulled once ``n`` rows are
    out, and an abandoned stream closes (its scan frees what it held)."""
    remaining = n
    for stream in streams:
        if remaining <= 0:
            return
        for b in stream:
            with node.timer():
                out, kept = _live_prefix(b, remaining)
            remaining -= kept
            node.metric("numOutputRows").add(kept)
            node.metric("numOutputBatches").add(1)
            yield out
            if remaining <= 0:
                return


class CpuUnionExec(CpuExec):
    def __init__(self, children_: Sequence[CpuExec]):
        super().__init__(children_[0].schema, *children_)

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child, p = _union_child(self, partition)
        for b in child.execute(p):
            yield H.HostBatch(self.schema, b.columns)


class TpuUnionExec(TpuExec):
    """[REF: GpuUnionExec] — partitions concatenate across children."""

    def __init__(self, children_: Sequence[TpuExec]):
        super().__init__(children_[0].schema, *children_)

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child, p = _union_child(self, partition)
        for b in child.execute(p):
            yield DeviceBatch(self.schema, b.columns, b.sel,
                              compacted=b.compacted)


def _union_child(node, partition: int):
    """(child, its partition) that a union's ``partition`` reads."""
    for c in node.children:
        np_ = c.num_partitions()
        if partition < np_:
            return c, partition
        partition -= np_
    raise IndexError("partition out of range")


class TpuCoalesceBatchesExec(TpuExec):
    """Concatenate small device batches up to a target row budget.

    [REF: GpuCoalesceBatches.scala :: GpuCoalesceBatches] — goal-directed,
    as the JAX package's: ``target_rows`` (the TargetSize goal, above a
    host-to-device transition) or ``require_single`` (RequireSingleBatch,
    under the global sort, which needs the whole partition).
    """

    def __init__(self, child: TpuExec, target_rows: Optional[int] = None,
                 require_single: bool = False):
        if target_rows is None and not require_single:
            raise ValueError("a TargetSize coalesce needs target_rows")
        super().__init__(child.schema, child)
        self.target_rows = target_rows
        self.require_single = require_single

    def node_string(self):
        goal = ("single" if self.require_single
                else f"target={self.target_rows}")
        return f"TpuCoalesceBatches [{goal}]"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        pending: List[DeviceBatch] = []
        counts: List[int] = []
        for b in self.children[0].execute(partition):
            b = compact(b)
            if not self.require_single:
                (n,) = live_counts([b])
                if pending and sum(counts) + n > self.target_rows:
                    yield self._emit(pending, counts)
                    pending, counts = [], []
                counts.append(n)
            pending.append(b)
        if pending:
            yield self._emit(pending, counts or None)

    def _emit(self, batches: List[DeviceBatch], counts) -> DeviceBatch:
        with self.timer("concatTime"):
            out = concat_device_batches(self.schema, batches, counts)
        self.metric("numOutputBatches").add(1)
        return out


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
        # strings and arrays are [B, W] matrices with lengths: the
        # batches' widths may differ, so pad to the widest
        ragged = parts[0].is_string or parts[0].is_array
        width = max(p.data.shape[1] for p in parts) if ragged else 0
        data = torch.zeros(
            (bucket,) + ((width,) if ragged
                         else tuple(parts[0].data.shape[1:])),
            dtype=parts[0].data.dtype, device=dev)
        any_val = any(p.validity is not None for p in parts)
        validity = (torch.zeros((bucket,), dtype=torch.bool, device=dev)
                    if any_val else None)
        lengths = (torch.zeros((bucket,), dtype=torch.int32, device=dev)
                   if ragged else None)
        # an array's element validity, padding elements valid (the JAX
        # package's padding)
        evalid = (torch.ones((bucket, width), dtype=torch.bool, device=dev)
                  if any(p.evalid is not None for p in parts) else None)
        at = 0
        for p, n in zip(parts, counts):
            if ragged:
                data[at:at + n, :p.data.shape[1]] = p.data[:n]
                lengths[at:at + n] = p.lengths[:n]
                if evalid is not None and p.evalid is not None:
                    evalid[at:at + n, :p.evalid.shape[1]] = p.evalid[:n]
            else:
                data[at:at + n] = p.data[:n]
            if any_val:
                validity[at:at + n] = (p.validity[:n] if p.validity
                                       is not None else True)
            at += n
        cols.append(DeviceColumn(f.dtype, data, validity, lengths, evalid))
    sel = torch.arange(bucket, device=dev) < total
    return DeviceBatch(schema, tuple(cols), sel, compacted=True)
