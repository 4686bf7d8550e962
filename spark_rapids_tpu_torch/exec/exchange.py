"""Shuffle exchange execs (repartitioning).

[REF: sql-plugin/../GpuShuffleExchangeExecBase.scala,
 GpuHashPartitioning.scala]

The counterpart of the JAX package's ``exec/exchange.py``.  Partition
ids are Spark's murmur3 of the key tuple from seed 42, pmod the
partition count (``ops/hashing.py``), or round robin by live-row rank
without keys.  ``spark.rapids.shuffle.mode`` picks the transport when
the plan rewrite converts ``CpuShuffleExchangeExec``
(``_convert_exchange``):

* CACHE_ONLY — ``TpuShuffleExchangeExec``, the in-process device
  exchange: each map batch keeps its partition ids beside it, and each
  output partition is the same batch viewed through a ``sel`` mask (no
  copy);
* MULTITHREADED (the default) — ``shuffle/exchange.py::
  TpuHostShuffleExchangeExec``, through host shuffle files and the
  native tudo serializer;
* ICI — a keyed repartition into the mesh's partition count becomes
  ``exec/distributed.py::TpuIciShuffleExchangeExec``, the collective
  all_to_all over the ranks; under ``spark.rapids.tpu.exchange.mode=
  host`` it runs the host-shuffle transport, and any other repartition
  the in-process device exchange.

Under ``spark.sql.adaptive.enabled`` (the default) the exchange is read
through ``exec/aqe.py::TpuAQEShuffleReadExec``, which under the
adaptive plane (``spark.rapids.tpu.adaptive.enabled``) re-targets its
row budget from observed bytes per row.  Each exchange records its
per-partition row counts in the stats plane (``runtime/stats.py``) when
a collector is active.  With ``spark.rapids.tpu.cache.subplan.enabled``
the CPU and the in-process device exchanges probe the result cache for
their materialized output under a subtree key (``_subplan_probe``): a
hit rehydrates it (host batches, or new device batches uploaded from
the stored host tables; nothing writes into a stored entry), a miss
stores it dehydrated to the host.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import DeviceBatch
from spark_rapids_tpu_torch.exec.aqe import TpuAQEShuffleReadExec
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.ops import hashing as HH
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.runtime import stats


def _subplan_probe(exec_node):
    """(store, subtree ResultKey) when the result cache's subplan mode
    applies to this exchange, else (None, None).  Keyed by the detailed
    subtree fingerprint, the configured session's conf fingerprint and
    the physical leaves' input fingerprints, so partially-overlapping
    queries reuse a shared stage."""
    from spark_rapids_tpu_torch import cache as cache_mod
    store = cache_mod.subplan_store()
    if store is None:
        return None, None
    try:
        return store, cache_mod.subplan_key(exec_node,
                                            store.subplan_conf_fp)
    except Exception:
        return None, None


def _dehydrate_pairs(pairs):
    """(DeviceBatch, pid) pairs -> host-resident payload.  Rows are
    compacted on the pull, so the stored pids are those of the live
    rows, aligned with the rehydrated batch's live rows."""
    from spark_rapids_tpu_torch.columnar.column import device_to_host
    payload = []
    nbytes = 0
    for b, pid in pairs:
        tbl = device_to_host(b)
        pids = pid[b.sel].cpu().numpy().astype(np.int32)
        payload.append((tbl, pids))
        nbytes += tbl.nbytes + pids.nbytes
    return payload, nbytes


def _rehydrate_pairs(payload, device):
    """Host payload -> new (DeviceBatch, pid) pairs: each batch padded
    to its power-of-two capacity, its pids padded with -1 (dead rows
    match no partition)."""
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    pairs = []
    for tbl, pids in payload:
        batch = host_to_device(tbl, device)
        pid = np.full(batch.capacity, -1, np.int32)
        pid[:len(pids)] = pids
        pairs.append((batch, torch.from_numpy(pid).to(device)))
    return pairs


def device_partition_ids(keys: Sequence[Expression], nparts: int,
                         batch: DeviceBatch) -> torch.Tensor:
    """int32 partition id of every row of a device batch (dead rows
    too): Spark's murmur3 of ``keys`` from seed 42, pmod ``nparts``."""
    h = torch.full((batch.capacity,), HH.SEED, dtype=torch.int64,
                   device=batch.device)
    for e in keys:
        c = e.eval(batch)
        h = HH.hash_column((c.data, c.lengths), c.dtype, h, c.valid_mask())
    return HH.partition_ids_from_hash(HH.int32_from_u32(h), nparts)


def host_partition_ids(keys: Sequence[Expression], nparts: int,
                       batch: H.HostBatch) -> np.ndarray:
    """The same ids for a host batch, through ``hash_column`` over torch
    CPU tensors of its columns (``host_hash_input``)."""
    n = batch.num_rows
    h = torch.full((n,), HH.SEED, dtype=torch.int64)
    for e in keys:
        c = e.eval_cpu(batch)
        col, valid = HH.host_hash_input(c, n)
        h = HH.hash_column(col, c.dtype, h, valid)
    return HH.partition_ids_from_hash(HH.int32_from_u32(h),
                                      nparts).numpy()


class CpuShuffleExchangeExec(CpuExec):
    def __init__(self, child: CpuExec, num_partitions: int,
                 keys: Optional[Sequence[Expression]] = None):
        super().__init__(child.schema, child)
        self.nparts = num_partitions
        self.keys = list(keys) if keys else None
        self._materialized: Optional[List[List[H.HostBatch]]] = None
        self._mat_lock = threading.Lock()

    def node_string(self):
        kind = "hash" if self.keys else "roundrobin"
        return f"ShuffleExchange [{kind} {self.nparts}]"

    def num_partitions(self) -> int:
        return self.nparts

    def _materialize(self) -> List[List[H.HostBatch]]:
        with self._mat_lock:
            if self._materialized is not None:
                return self._materialized
            store, skey = _subplan_probe(self)
            if store is not None and skey is not None:
                ent = store.lookup(skey.key)
                if ent is not None:
                    self._materialized = [
                        [H.from_arrow_table(t) for t in part]
                        for part in ent.value]
                    return self._materialized
            t0 = time.perf_counter()
            child = self.children[0]
            out: List[List[H.HostBatch]] = [[] for _ in range(self.nparts)]
            row_counter = 0
            for p in range(child.num_partitions()):
                for b in child.execute(p):
                    n = b.num_rows
                    if self.keys:
                        pid = host_partition_ids(self.keys, self.nparts, b)
                    else:
                        pid = (np.arange(n) + row_counter) % self.nparts
                        row_counter += n
                    for p_out in range(self.nparts):
                        mask = pid == p_out
                        if not mask.any():
                            continue
                        cols = [H.HostCol(
                            c.dtype, c.data[mask],
                            None if c.validity is None
                            else c.validity[mask])
                            for c in b.columns]
                        out[p_out].append(H.HostBatch(b.schema, cols))
            self._materialized = out
            st = stats.current()
            if st is not None:
                st.record_partitions(
                    self, [sum(b.num_rows for b in bl) for bl in out],
                    unit="rows")
            if store is not None and skey is not None:
                store.note_miss(sub=True)
                payload = [[H.to_arrow_table(b) for b in part]
                           for part in out]
                nbytes = sum(t.nbytes for part in payload for t in part)
                store.put(skey, payload, nbytes,
                          time.perf_counter() - t0, kind="subplan")
            return out

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        yield from self._materialize()[partition]


class TpuShuffleExchangeExec(TpuExec):
    """Zero-copy device repartition: ``sel``-mask views per partition.

    [REF: GpuShuffleExchangeExecBase — device murmur3 partitioning]

    The map stage runs once, at the first read: every batch of every
    child partition is kept with its partition ids.  The AQE read
    protocol: ``aqe_partition_stats`` (live rows per partition, one
    bincount per map batch), ``execute_pid_range`` (a coalesced read)
    and ``execute_split`` (slice j of k of a partition by in-partition
    row rank)."""

    def __init__(self, child: TpuExec, num_partitions: int,
                 keys: Optional[Sequence[Expression]] = None,
                 device: Optional[torch.device] = None):
        super().__init__(child.schema, child)
        self.nparts = num_partitions
        self.keys = list(keys) if keys else None
        # where a subplan-cache hit uploads its batches (no probe
        # without it)
        self.device = device
        self._materialized = None
        self._batch_counts: Optional[np.ndarray] = None
        self._mat_lock = threading.Lock()

    def node_string(self):
        kind = "hash" if self.keys else "roundrobin"
        return f"TpuShuffleExchange [{kind} {self.nparts}]"

    def num_partitions(self) -> int:
        return self.nparts

    def _pids(self, b: DeviceBatch, row_base: int) -> torch.Tensor:
        if self.keys:
            return device_partition_ids(self.keys, self.nparts, b)
        live_prefix = torch.cumsum(b.sel.to(torch.int32), 0) - 1
        return ((live_prefix + row_base) % self.nparts).to(torch.int32)

    def _materialize(self):
        with self._mat_lock:
            if self._materialized is not None:
                return self._materialized
            store, skey = (_subplan_probe(self) if self.device is not None
                           else (None, None))
            if store is not None and skey is not None:
                ent = store.lookup(skey.key)
                if ent is not None:
                    self._materialized = _rehydrate_pairs(ent.value,
                                                          self.device)
                    return self._materialized
            t0 = time.perf_counter()
            child = self.children[0]
            pairs = []  # (batch, partition ids)
            row_base = 0
            with self.timer("partitionTime"):
                for p in range(child.num_partitions()):
                    for b in child.execute(p):
                        pairs.append((b, self._pids(b, row_base)))
                        if not self.keys:
                            # only round robin needs the running row
                            # count (a device read)
                            row_base += int(b.sel.sum())
            self._materialized = pairs
            if store is not None and skey is not None:
                store.note_miss(sub=True)
                payload, nbytes = _dehydrate_pairs(pairs)
                store.put(skey, payload, nbytes,
                          time.perf_counter() - t0, kind="subplan")
            return pairs

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        for b, pid in self._materialize():
            self.metric("numOutputBatches").add(1)
            yield b.with_sel(b.sel & (pid == partition))

    # -- AQE stats + shaped reads [REF: GpuAQEShuffleReadExec] -----------
    def aqe_partition_stats(self):
        return "rows", self.partition_row_counts()

    def partition_row_counts(self) -> np.ndarray:
        """Live rows per output partition: one bincount per map batch,
        read back together.  Keeps the per-batch counts, so that split
        reads find their rank bases without another device read."""
        if self._batch_counts is not None:
            return self._batch_counts.sum(axis=0)
        nparts = self.nparts
        pairs = self._materialize()
        if pairs:
            per_batch = torch.stack([
                torch.bincount(
                    torch.where(b.sel, pid, nparts).to(torch.int64),
                    minlength=nparts + 1)[:nparts]
                for b, pid in pairs])
            self._batch_counts = per_batch.cpu().numpy()
        else:
            self._batch_counts = np.zeros((0, nparts), np.int64)
        counts = self._batch_counts.sum(axis=0)
        st = stats.current()
        if st is not None:
            # the map-output statistics AQE plans from double as the
            # stats plane's per-partition record of this exchange
            st.record_partitions(self, counts, unit="rows")
        return counts

    def execute_pid_range(self, lo: int, hi: int
                          ) -> Iterator[DeviceBatch]:
        """Coalesced read: partitions [lo, hi) as one output."""
        for b, pid in self._materialize():
            yield b.with_sel(b.sel & (pid >= lo) & (pid < hi))

    def execute_split(self, p: int, j: int, k: int
                      ) -> Iterator[DeviceBatch]:
        """Skew read: slice j of k of partition p, the rows whose rank
        within the partition (stable across batches) is j mod k."""
        self.partition_row_counts()  # ensures _batch_counts
        bases = (np.concatenate(
            [[0], np.cumsum(self._batch_counts[:, p])[:-1]])
            if len(self._batch_counts) else [])
        for (b, pid), base in zip(self._materialize(), bases):
            mine = b.sel & (pid == p)
            rank = int(base) + torch.cumsum(mine.to(torch.int32), 0) - 1
            yield b.with_sel(mine & (rank % k == j))


def _tag_exchange(meta):
    if meta.cpu.keys:
        meta.tag_expressions(meta.cpu.keys)


def _convert_exchange(cpu, ch, conf, device):
    """The transport by ``spark.rapids.shuffle.mode``, under the AQE
    read when ``spark.sql.adaptive.enabled`` (the collective exchange
    is read directly)."""
    from spark_rapids_tpu_torch.exec.distributed import (
        TpuIciShuffleExchangeExec, exchange_opts, ici_active)
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.plan.overrides import _estimated_row_bytes
    if ici_active(conf, device) and cpu.keys:
        mesh = make_mesh(device=device)
        if cpu.nparts == mesh.size:
            return TpuIciShuffleExchangeExec(ch[0], cpu.keys, mesh=mesh,
                                             **exchange_opts(conf))
    host_pinned = (conf.shuffle_mode == "ICI"
                   and conf.exchange_mode == "host")
    if conf.shuffle_mode == "MULTITHREADED" or host_pinned:
        # exchange.mode=host under ICI: same plan shape, but the stage
        # boundary runs the host-shuffle transport — the conf-selected
        # fallback and the collective domain's degrade target
        from spark_rapids_tpu_torch.shuffle.exchange import (
            TpuHostShuffleExchangeExec)
        exchange = TpuHostShuffleExchangeExec(
            ch[0], cpu.nparts, cpu.keys, device,
            nthreads=conf.get(C.SHUFFLE_THREADS),
            min_bucket=conf.min_bucket_rows)
    else:
        # CACHE_ONLY: in-process device-resident exchange
        exchange = TpuShuffleExchangeExec(ch[0], cpu.nparts, cpu.keys,
                                          device=device)
    if not conf.get(C.ADAPTIVE_ENABLED):
        return exchange
    from spark_rapids_tpu_torch import adaptive as AD
    pol = AD.policy_from_conf(conf)
    return TpuAQEShuffleReadExec(
        exchange, conf.get(C.ADVISORY_PARTITION_SIZE),
        _estimated_row_bytes(cpu.schema), allow_split=cpu.keys is None,
        retarget=pol if pol.wants_retarget else None)
