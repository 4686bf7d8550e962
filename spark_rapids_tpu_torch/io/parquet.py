"""File-source scan and write execs (parquet, orc).

[REF: sql-plugin/../GpuParquetScan.scala :: GpuParquetMultiFilePartitionReader
 (MULTITHREADED), GpuParquetFileFormat (write), GpuOrcScan.scala,
 GpuFileSourceScanExec.scala (partition values, input_file_name),
 GpuFileFormatDataWriter.scala (dynamic partitions)]

The counterpart of the JAX package's ``io/parquet.py``: decode stays on
the host (pyarrow's C++ readers) and the scan lands device batches:

* MULTITHREADED analog: a thread pool reads and decodes a partition's
  files concurrently while the device consumes earlier ones.  The decode
  threads never touch CUDA: every host-to-device copy runs on the
  consuming pump task's thread, stream and device-semaphore permit,
  through ``host_to_device`` (timed as ``transferTime``; the wait for a
  decoded file is ``scanTime``);
* dictionary-read string columns (``spark.rapids.tpu.parquet.
  deviceDictDecode``) cross as indices and a small dictionary and
  expand on the device (``columnar/column.py``; ``dictDecodedColumns``);
* predicate pushdown: row-group pruning against parquet column-chunk
  min/max statistics (``prunedRowGroups``); the Filter above re-applies
  the exact predicate, so pruning only has to be conservative;
* column pruning: the optimizer narrows the read set to the referenced
  columns (plan/optimizer.py);
* hive-style partition values and input_file_name() are appended as
  constant columns per file before the copy;
* dynamic partition pruning (``relation.dpp``): the build side's
  subquery is planned and drained once, on the host, before the scan's
  first file; files whose partition value it does not hold are skipped
  (``dppPrunedFiles``);
* row-level deletes (``relation.deletes``: Delta deletion vectors,
  Iceberg position deletes) apply as a row mask during the host decode
  (``deletedRows``).  Their positions are file-absolute, so after
  row-group pruning they are matched against the kept groups' rows.

A scan partition is a set of files (``_partition_files``): a scan has
``min(files, spark.sql.shuffle.partitions)`` partitions.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import threading
from typing import Iterator, List, Optional, Sequence, Set

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import DeviceBatch, host_to_device
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec


def parquet_schema(paths: Sequence[str]) -> T.StructType:
    s = pq.read_schema(paths[0])
    return T.StructType(tuple(
        T.StructField(f.name, T.from_arrow(f.type)) for f in s))


def orc_schema(paths: Sequence[str]) -> T.StructType:
    import pyarrow.orc as po
    s = po.ORCFile(paths[0]).schema
    return T.StructType(tuple(
        T.StructField(f.name, T.from_arrow(f.type)) for f in s))


def _partition_files(n_files: int, num_partitions: int) -> List[List[int]]:
    parts: List[List[int]] = [[] for _ in range(num_partitions)]
    for i in range(n_files):
        parts[i % num_partitions].append(i)
    return parts


def _rg_may_match(md_rg, colmap, filters) -> bool:
    """Conservative row-group keep test against chunk min/max stats.

    A conjunct that provably matches no non-null value lets the group be
    skipped: predicate comparisons drop null rows anyway, so null-only
    remains never survive the exact Filter above."""
    for name, op, val in filters:
        ci = colmap.get(name)
        if ci is None:
            continue
        st = md_rg.column(ci).statistics
        if st is None or not st.has_min_max:
            continue
        mn, mx = st.min, st.max
        try:
            if op == "eq" and (val < mn or val > mx):
                return False
            if op == "lt" and not (mn < val):
                return False
            if op == "le" and not (mn <= val):
                return False
            if op == "gt" and not (mx > val):
                return False
            if op == "ge" and not (mx >= val):
                return False
        except TypeError:
            continue  # incomparable stats type — keep the group
    return True


class CpuParquetScanExec(CpuExec):
    """Generic file scan (parquet/orc) — CPU oracle path."""

    def __init__(self, relation, conf: RapidsConf):
        super().__init__(relation.schema)
        self.relation = relation
        self.paths = list(relation.paths)
        self.conf = conf
        self.columns = relation.columns
        self._num_partitions = max(1, min(len(self.paths),
                                          conf.shuffle_partitions))
        self._dpp_keep_cache: Optional[Set[int]] = None
        self._dpp_lock = threading.Lock()

    def _dpp_keep(self) -> Optional[Set[int]]:
        """File indices surviving dynamic partition pruning (None = all).

        Plans the build side's subquery and drains it ONCE, on the host,
        before the scan's first file [REF: GpuSubqueryBroadcastExec —
        the reference reuses the broadcast; the build sides DPP takes
        are broadcast-sized, so a host evaluation is the in-process
        analog].  Its operators stay on the CPU, as in the JAX
        package."""
        if self.relation.dpp is None:
            return None
        with self._dpp_lock:
            if self._dpp_keep_cache is not None:
                return self._dpp_keep_cache
            sub_plan, col_name = self.relation.dpp
            from spark_rapids_tpu_torch.plan.planner import plan_physical
            sub = plan_physical(sub_plan, self.conf)
            values = set()
            for p in range(sub.num_partitions()):
                for b in sub.execute(p):
                    values.update(
                        v for v in H.to_arrow_column(b.columns[0]).to_pylist()
                        if v is not None)
            keep = {fi for fi, pv in
                    enumerate(self.relation.partition_values)
                    if pv.get(col_name) in values}
            self.metric("dppPrunedFiles").add(len(self.paths) - len(keep))
            self._dpp_keep_cache = keep
            return keep

    def node_string(self):
        extra = ""
        if self.relation.filters:
            extra = f", pushdown={self.relation.filters}"
        return (f"{self.relation.format.capitalize()}Scan "
                f"[{len(self.paths)} files{extra}]")

    def num_partitions(self) -> int:
        return self._num_partitions

    def _data_columns(self) -> List[str]:
        if self.columns is not None:
            return self.columns
        np_ = len(self.relation.partition_fields)
        nf = 1 if self.relation.file_name_col else 0
        fields = self.schema.fields
        end = len(fields) - np_ - nf
        return [f.name for f in fields[:end]]

    def _read_file(self, fi, dict_strings=False) -> pa.Table:
        """Read one file's pruned columns + append partition/file cols.

        Runs on a decode thread of the device scan: host work only.
        Columns missing from a file (schema evolution: added after the
        file was written) materialize as nulls — Delta/Spark semantics."""
        path = self.paths[fi]
        cols = self._data_columns()
        by_name = {f.name: f for f in self.schema.fields}
        dels = (self.relation.deletes[fi]
                if self.relation.deletes is not None else None)
        positions = None  # file-absolute row positions of the read rows
        if self.relation.format == "orc":
            import pyarrow.orc as po
            orc = po.ORCFile(path)
            present = set(orc.schema.names)
            read_cols = [c for c in cols if c in present]
            tbl = orc.read(columns=read_cols)
        else:
            read_dict = None
            if dict_strings:
                read_dict = [c for c in cols
                             if isinstance(by_name[c].dtype,
                                           (T.StringType, T.BinaryType))]
            pf = pq.ParquetFile(path, read_dictionary=read_dict)
            present = set(pf.schema_arrow.names)
            read_cols = [c for c in cols if c in present]
            filters = self.relation.filters
            if filters:
                colmap = {pf.metadata.schema.column(i).name: i
                          for i in range(pf.metadata.num_columns)}
                keep = [rg for rg in range(pf.metadata.num_row_groups)
                        if _rg_may_match(pf.metadata.row_group(rg),
                                         colmap, filters)]
                self.metric("prunedRowGroups").add(
                    pf.metadata.num_row_groups - len(keep))
                tbl = (pf.read_row_groups(keep, columns=read_cols)
                       if keep
                       else pf.schema_arrow.empty_table().select(
                           read_cols))
                if dels is not None and len(dels) and keep:
                    # delete positions are FILE-absolute; row-group
                    # pruning shifted the local indexes, so rebuild them
                    rg_rows = [pf.metadata.row_group(i).num_rows
                               for i in range(pf.metadata.num_row_groups)]
                    starts = np.concatenate(
                        [[0], np.cumsum(rg_rows)[:-1]])
                    positions = np.concatenate(
                        [np.arange(starts[rg], starts[rg] + rg_rows[rg],
                                   dtype=np.int64) for rg in keep])
            else:
                tbl = pf.read(columns=read_cols)  # reuse the open file
        if dels is not None and len(dels) and tbl.num_rows:
            # the row mask: a sorted searchsorted membership test (both
            # the deletes and the positions can be large)
            if positions is None:
                positions = np.arange(tbl.num_rows, dtype=np.int64)
            ix = np.searchsorted(dels, positions)
            hit = np.zeros(len(positions), bool)
            in_rng = ix < len(dels)
            hit[in_rng] = dels[ix[in_rng]] == positions[in_rng]
            self.metric("deletedRows").add(int(hit.sum()))
            tbl = tbl.filter(pa.array(~hit))
        if len(read_cols) < len(cols):
            for c in cols:
                if c not in present:
                    tbl = tbl.append_column(
                        c, pa.nulls(tbl.num_rows,
                                    type=T.to_arrow(by_name[c].dtype)))
            tbl = tbl.select(cols)
        n = tbl.num_rows
        if self.relation.partition_values is not None:
            pv = self.relation.partition_values[fi]
            for f in self.relation.partition_fields:
                v = pv.get(f.name)
                arr = pa.array(
                    [v] * n if v is not None else [None] * n,
                    type=T.to_arrow(f.dtype))
                tbl = tbl.append_column(f.name, arr)
        if self.relation.file_name_col:
            tbl = tbl.append_column(
                "input_file_name()",
                pa.array([path] * n, type=pa.string()))
        return tbl

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        idxs = _partition_files(len(self.paths),
                                self._num_partitions)[partition]
        keep = self._dpp_keep()
        if keep is not None:
            idxs = [fi for fi in idxs if fi in keep]
        for fi in idxs:
            with self.timer():
                tbl = self._read_file(fi)
                b = H.from_arrow_table(tbl)
                b = H.HostBatch(self.schema, b.columns)
            self.metric("numOutputRows").add(b.num_rows)
            self.metric("numOutputBatches").add(1)
            yield b


class TpuParquetScanExec(TpuExec):
    """Multithreaded host decode + H2D — the MULTITHREADED reader analog.

    [REF: GpuMultiFileReader.scala :: MultiFileCloudPartitionReader]
    The pool's threads only decode (``CpuParquetScanExec._read_file``);
    each decoded file crosses to the device here, on the thread (and so
    the CUDA stream and semaphore permit) of the task pumping this
    partition."""

    def __init__(self, cpu: CpuParquetScanExec, device: torch.device):
        super().__init__(cpu.schema)
        self._cpu = cpu
        self.device = device
        self.paths = cpu.paths
        self._num_partitions = cpu._num_partitions
        self.num_threads = int(cpu.conf.get(C.MULTITHREADED_READ_THREADS))
        self.dict_decode = bool(cpu.conf.get(C.PARQUET_DEVICE_DICT))

    def node_string(self):
        return "Tpu" + self._cpu.node_string()

    def num_partitions(self) -> int:
        return self._num_partitions

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        idxs = _partition_files(len(self.paths),
                                self._num_partitions)[partition]
        keep = self._cpu._dpp_keep()
        if keep is not None:
            idxs = [fi for fi in idxs if fi in keep]
            self.metric("dppPrunedFiles").value = \
                self._cpu.metric("dppPrunedFiles").value
        if not idxs:
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futures = [pool.submit(self._cpu._read_file, fi,
                                   self.dict_decode) for fi in idxs]
            for fut in futures:
                with self.timer("scanTime"):
                    tbl = fut.result()
                ndict = sum(1 for c in tbl.columns
                            if pa.types.is_dictionary(c.type))
                if ndict:
                    self.metric("dictDecodedColumns").add(ndict)
                with self.timer("transferTime"):
                    b = host_to_device(tbl, self.device)
                    b = DeviceBatch(self.schema, b.columns, b.sel,
                                    compacted=True)
                self.metric("numOutputRows").add(tbl.num_rows)
                self.metric("numOutputBatches").add(1)
                yield b
        # the pruning and delete metrics accrue on the shared CPU reader
        for name in ("prunedRowGroups", "deletedRows"):
            m = self._cpu.metrics.get(name)
            if m is not None:
                self.metric(name).value = m.value


def _convert_parquet(cpu: CpuParquetScanExec, ch, conf, device):
    return TpuParquetScanExec(cpu, device)


HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _prepare_out_dir(path: str, mode: str) -> bool:
    """Returns False when the write should be skipped (mode=ignore)."""
    if os.path.exists(path):
        if mode in ("error", "errorifexists"):
            raise FileExistsError(path)
        if mode == "ignore":
            return False
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
    os.makedirs(path, exist_ok=True)
    return True


def write_parquet(table: pa.Table, path: str, mode: str = "error",
                  partition_by: Optional[List[str]] = None,
                  fmt: str = "parquet"):
    """Write a table as a directory of part files, optionally
    hive-partitioned [REF: GpuFileFormatDataWriter.scala ::
    GpuDynamicPartitionDataSingleWriter]."""
    if not _prepare_out_dir(path, mode):
        return

    def _write(tbl: pa.Table, out_dir: str, part_idx: int):
        os.makedirs(out_dir, exist_ok=True)
        fname = f"part-{part_idx:05d}.{fmt}"
        if fmt == "orc":
            import pyarrow.orc as po
            po.write_table(tbl, os.path.join(out_dir, fname))
        else:
            pq.write_table(tbl, os.path.join(out_dir, fname))

    if not partition_by:
        _write(table, path, 0)
        return
    for c in partition_by:
        if c not in table.column_names:
            raise KeyError(f"partitionBy column '{c}' not in output")
    data_cols = [c for c in table.column_names if c not in partition_by]
    # group rows by distinct partition tuple
    keys = list(zip(*[table.column(c).to_pylist() for c in partition_by]))
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    for pi, (k, rows) in enumerate(sorted(
            groups.items(), key=lambda kv: str(kv[0]))):
        sub = table.take(pa.array(rows, type=pa.int64())).select(data_cols)
        segs = [f"{c}=" + (HIVE_NULL if v is None else str(v))
                for c, v in zip(partition_by, k)]
        _write(sub, os.path.join(path, *segs), pi)
