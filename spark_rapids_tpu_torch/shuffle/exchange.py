"""MULTITHREADED shuffle exchange exec — the host-path transport.

[REF: sql-plugin/../RapidsShuffleInternalManagerBase.scala ::
 RapidsShuffleThreadedWriter/Reader; GpuShuffleExchangeExecBase]

The counterpart of the JAX package's ``shuffle/exchange.py``: the
reference's default shuffle.  Map side: partition ids are computed on
the device with the bit-exact Spark murmur3 (the in-process exchange's
function), each map batch comes to the host in one device-to-host
round (every column, its validity and lengths, the live mask and the
ids, then one wait), and the native tudo serializer writes every
partition's rows into the map partition's shuffle file.  Reduce side:
seek-read the partition's sections (through the ``shuffle_exchange``
failure domain, polling the query's cancel token per partition),
concatenate them on the host (numpy views), one host-to-device copy per
read.  Rows come out in the order
of the in-process exchange (the bucketing is stable and map files read
in order).  Shuffle files die with the exec.

Metrics: ``writeTime`` (the whole map stage), ``partitionTime`` (the
ids on the device, synchronized; inside ``writeTime``; the JAX
package's exec has no such timer), ``bytesWritten``, ``readTime``,
``transferTime`` (the host-to-device copies of the reads),
``numOutputRows``; the registry's ``tpuq_shuffle_*`` counters sum them
over the process, and the map stage's byte sizes per reduce partition
go to the stats plane (``aqe_partition_stats``).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, _to_device, round_up_pow2)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.exchange import device_partition_ids
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.runtime import cancel
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import stats
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.shuffle.manager import (
    ShuffleEnv, ShuffleReader, ShuffleWriter)
from spark_rapids_tpu_torch.shuffle.serializer import HostColView

_TM_EXCHANGES = TM.REGISTRY.counter(
    "tpuq_shuffle_exchanges_total",
    "host-shuffle exchanges materialized")
_TM_PARTITIONS = TM.REGISTRY.counter(
    "tpuq_shuffle_partitions_total",
    "reduce partitions produced by materialized exchanges")
_TM_WRITE_S = TM.REGISTRY.counter(
    "tpuq_shuffle_write_seconds_total",
    "host-shuffle map-side write/serialize seconds")
_TM_READ_S = TM.REGISTRY.counter(
    "tpuq_shuffle_read_seconds_total",
    "host-shuffle reduce-side read/deserialize seconds")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(tensors: Sequence[Optional[torch.Tensor]]
             ) -> List[Optional[np.ndarray]]:
    """Host copies of device tensors: every copy queued without waiting,
    then one wait."""
    outs = [None if t is None else t.to("cpu", non_blocking=True)
            for t in tensors]
    devs = {t.device for t in tensors if t is not None}
    for d in devs:
        _sync(d)
    return [None if o is None else o.numpy() for o in outs]


def _host_views(batch: DeviceBatch, pid: Optional[torch.Tensor]):
    """One map batch on the host: (serializable column views, live mask,
    partition ids or None)."""
    tensors = [batch.sel, pid]
    for c in batch.columns:
        tensors += [c.data, c.validity, c.lengths]
    host = _to_host(tensors)
    live, pids, rest = host[0], host[1], host[2:]
    views = [HostColView(c.dtype, rest[3 * i], rest[3 * i + 1],
                         rest[3 * i + 2])
             for i, c in enumerate(batch.columns)]
    return views, live, pids


def _concat_views(schema: T.StructType, records) -> tuple:
    """Concatenate deserialized records on the host -> (nrows, views)."""
    records = list(records)
    if not records:
        return 0, None
    if len(records) == 1:
        return records[0]
    total = sum(n for n, _ in records)
    cols: List[HostColView] = []
    for ci, f in enumerate(schema.fields):
        parts = [r[1][ci] for r in records]
        any_val = any(p.validity is not None for p in parts)
        if parts[0].is_string:
            width = max(max(int(p.data.shape[1]) for p in parts), 1)
            mats = []
            for p, (n, _) in zip(parts, records):
                m = p.data[:n]
                if m.shape[1] < width:
                    m = np.pad(m, ((0, 0), (0, width - m.shape[1])))
                mats.append(m)
            data = np.concatenate(mats)
            lengths = np.concatenate(
                [p.lengths[:n] for p, (n, _) in zip(parts, records)])
        else:
            data = np.concatenate(
                [p.data[:n] for p, (n, _) in zip(parts, records)])
            lengths = None
        validity = None
        if any_val:
            validity = np.concatenate([
                (p.validity[:n] if p.validity is not None
                 else np.ones(n, np.uint8))
                for p, (n, _) in zip(parts, records)])
        cols.append(HostColView(f.dtype, data, validity, lengths))
    return total, cols


def _views_to_device(schema: T.StructType, cols: List[HostColView], n: int,
                     min_bucket: int, device: torch.device) -> DeviceBatch:
    """Host column views -> a padded, compacted DeviceBatch."""
    cap = round_up_pow2(max(n, 1), min_bucket)
    dcols = []
    for f, c in zip(schema.fields, cols):
        lengths = None
        if c.is_string:
            mat = np.zeros((cap, max(int(c.data.shape[1]), 1)), np.uint8)
            mat[:n] = c.data[:n]
            data = _to_device(mat, device)
            lens = np.zeros(cap, np.int32)
            lens[:n] = c.lengths[:n]
            lengths = _to_device(lens, device)
        else:
            buf = np.zeros((cap,) + c.data.shape[1:], c.data.dtype)
            buf[:n] = c.data[:n]
            data = _to_device(buf, device)
        validity = None
        if c.validity is not None:
            v = np.zeros(cap, bool)
            v[:n] = c.validity[:n].astype(bool)
            validity = _to_device(v, device)
        dcols.append(DeviceColumn(f.dtype, data, validity, lengths))
    sel = torch.arange(cap, device=device) < n
    return DeviceBatch(schema, tuple(dcols), sel, compacted=True)


class TpuHostShuffleExchangeExec(TpuExec):
    """Shuffle through host files with native tudo serialization.

    ``execute(p)`` yields partition p's rows as one batch (none when the
    partition is empty), in the in-process exchange's order.  The AQE
    read protocol (``aqe_partition_stats`` in serialized bytes,
    ``execute_pid_range``, ``execute_split``) is the in-process
    exchange's."""

    def __init__(self, child: TpuExec, num_partitions: int,
                 keys: Optional[Sequence[Expression]],
                 device: torch.device, nthreads: int = 4,
                 min_bucket: int = 1024):
        super().__init__(child.schema, child)
        self.nparts = num_partitions
        self.keys = list(keys) if keys else None
        self.device = device
        self.nthreads = nthreads
        self.min_bucket = min_bucket
        self._mat_lock = threading.Lock()
        self._shuffle_id: Optional[int] = None
        self._map_parts: List[int] = []

    def node_string(self):
        kind = "hash" if self.keys else "roundrobin"
        return (f"TpuHostShuffleExchange [{kind} {self.nparts} "
                f"threads={self.nthreads}]")

    def num_partitions(self) -> int:
        return self.nparts

    def _materialize(self) -> None:
        with self._mat_lock:
            if self._shuffle_id is not None:
                return
            env = ShuffleEnv.get()
            sid = env.new_shuffle_id()
            # shuffle files die with the exec (the query's lifetime)
            weakref.finalize(self, env.remove_shuffle, sid)
            child = self.children[0]
            row_base = 0
            t0 = time.perf_counter()
            with self.timer("writeTime"):
                for m in range(child.num_partitions()):
                    cancel.check()
                    writer = ShuffleWriter(env, sid, m, self.nparts,
                                           self.nthreads)
                    try:
                        for b in child.execute(m):
                            pid = None
                            if self.keys:
                                with self.timer("partitionTime"):
                                    pid = device_partition_ids(
                                        self.keys, self.nparts, b)
                                    _sync(b.device)
                            cols, live, pid = _host_views(b, pid)
                            if not self.keys:
                                idx = np.cumsum(live) - 1 + row_base
                                pid = (idx % self.nparts).astype(np.int32)
                                row_base += int(live.sum())
                            written = writer.write_batch(cols, pid, live)
                            self.metric("bytesWritten").add(written)
                    finally:
                        writer.close()
                    self._map_parts.append(m)
            _TM_WRITE_S.inc(time.perf_counter() - t0)
            _TM_EXCHANGES.inc()
            _TM_PARTITIONS.inc(self.nparts)
            self._shuffle_id = sid

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        yield from self.execute_pid_range(partition, partition + 1)

    # -- AQE stats + shaped reads [REF: GpuAQEShuffleReadExec] -----------
    def aqe_partition_stats(self):
        """Per-reduce-partition byte sizes, summed from the shuffle
        files' section tables (no data read)."""
        self._materialize()
        env = ShuffleEnv.get()
        sizes = np.zeros(self.nparts, np.int64)
        for m in self._map_parts:
            with open(env.map_file(self._shuffle_id, m), "rb") as f:
                f.read(8)  # magic + nparts
                while True:
                    tbl = f.read(8 * self.nparts)
                    if not tbl:
                        break
                    rec = np.frombuffer(tbl, np.int64)
                    sizes += rec
                    f.seek(int(rec.sum()), os.SEEK_CUR)
        st = stats.current()
        if st is not None:
            st.record_partitions(self, sizes, unit="bytes")
        return "bytes", sizes

    def _read_concat(self, parts) -> tuple:
        """The reduce-side fetch, through the ``shuffle_exchange``
        failure domain.  Map files are immutable once written, so the
        read is idempotent and a retry reads again (``bytesRead`` counts
        every attempt).  Not degradable: exhaustion is a domain-tagged
        terminal error."""
        reader = ShuffleReader(ShuffleEnv.get(), self._shuffle_id,
                               self._map_parts, self.schema)
        parts = list(parts)

        def attempt():
            R.INJECTOR.on("shuffle_exchange")
            records = []
            for p in parts:
                cancel.check()
                records.extend(reader.read_partition(p))
            return records

        t0 = time.perf_counter()
        with self.timer("readTime"):
            records = R.run_guarded("shuffle_exchange", attempt,
                                    op="shuffle_read")
            out = _concat_views(self.schema, records)
        _TM_READ_S.inc(time.perf_counter() - t0)
        return out

    def _emit(self, cols, n) -> DeviceBatch:
        with self.timer("transferTime"):
            out = _views_to_device(self.schema, cols, n, self.min_bucket,
                                   self.device)
        self.metric("numOutputRows").add(n)
        self.metric("numOutputBatches").add(1)
        return out

    def execute_pid_range(self, lo: int, hi: int
                          ) -> Iterator[DeviceBatch]:
        self._materialize()
        n, cols = self._read_concat(range(lo, hi))
        if n:
            yield self._emit(cols, n)

    def execute_split(self, p: int, j: int, k: int
                      ) -> Iterator[DeviceBatch]:
        """Slice j of k of a skewed partition: the rows of rank j mod k,
        cut on the host before the copy (the device exchange's rule)."""
        self._materialize()
        n, cols = self._read_concat([p])
        if n == 0:
            return
        idx = np.arange(j, n, k)
        if len(idx) == 0:
            return
        sliced = [HostColView(
            c.dtype, c.data[:n][idx],
            None if c.validity is None else c.validity[:n][idx],
            None if c.lengths is None else c.lengths[:n][idx])
            for c in cols]
        yield self._emit(sliced, len(idx))
