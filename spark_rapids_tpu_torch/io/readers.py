"""DataFrameReader / DataFrameWriter — the session.read / df.write API.

[REF: the reference accelerates Spark's DataFrameReader formats via
 GpuReadParquetFileFormat / GpuOrcScan / GpuCSVScan / GpuJsonScan; here
 the host formats are pyarrow's readers and the device path lands
 device batches via io/parquet.py]

The counterpart of the JAX package's ``io/readers.py``: parquet and orc
read as a file relation (column pruning, row-group pruning, hive
partition columns, ``input_file_name()``, dynamic partition pruning);
Delta (``io/delta.py``: log replay, deletion vectors) and Iceberg
(``io/iceberg.py``: snapshots, v2 position deletes) tables read as the
same file relation with per-file deletes; avro (``io/avro.py``), text,
csv and json read on the host into an in-memory relation.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.io.parquet import (
    HIVE_NULL, orc_schema, parquet_schema, write_parquet)


def _expand(path) -> List[str]:
    paths: List[str] = []
    for p in ([path] if isinstance(path, str) else list(path)):
        if os.path.isdir(p):
            # recursive walk: hive-partitioned layouts nest k=v dirs.
            # In-place dirs pruning skips metadata trees (_delta_log/,
            # _temporary/, .checkpoints/) and keeps traversal sorted.
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(("_", ".")))
                for f in sorted(files):
                    if not f.startswith(("_", ".")):
                        paths.append(os.path.join(root, f))
        else:
            matches = sorted(glob.glob(p))
            paths.extend(matches if matches else [p])
    if not paths:
        raise FileNotFoundError(f"no input files at {path}")
    return paths


def _discover_partitions(roots, paths: List[str]):
    """Hive-style partition columns from ``k=v`` directory segments.

    Returns (per-file value dicts, partition StructFields) — ((), ())
    when the layout is unpartitioned.  Values infer int64 when every
    non-null value parses as int (Spark's inference), else string."""
    root_list = [roots] if isinstance(roots, str) else list(roots)
    values: List[dict] = []
    keys: List[str] = []
    for p in paths:
        rel = None
        for r in root_list:
            if os.path.isdir(r) and os.path.abspath(p).startswith(
                    os.path.abspath(r) + os.sep):
                rel = os.path.relpath(p, r)
                break
        d = {}
        if rel:
            for seg in rel.split(os.sep)[:-1]:
                if "=" in seg:
                    k, v = seg.split("=", 1)
                    d[k] = None if v == HIVE_NULL else v
                    if k not in keys:
                        keys.append(k)
        values.append(d)
    if not keys:
        return (), ()
    fields = []
    for k in keys:
        vs = [d.get(k) for d in values]
        try:
            ints = [None if v is None else int(v) for v in vs]
            dt = T.LongT
            for d, iv in zip(values, ints):
                d[k] = iv
        except (TypeError, ValueError):
            dt = T.StringT
        fields.append(T.StructField(k, dt, any(v is None for v in vs)))
    return values, tuple(fields)


class DataFrameReader:
    def __init__(self, session):
        self.session = session
        self._options: Dict[str, str] = {}
        self._schema: Optional[T.StructType] = None

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[str(key)] = value
        return self

    def options(self, **kw) -> "DataFrameReader":
        self._options.update(kw)
        return self

    def schema(self, s: T.StructType) -> "DataFrameReader":
        self._schema = s
        return self

    def _file_relation(self, path, fmt: str):
        from spark_rapids_tpu_torch.plan.logical import ParquetRelation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame

        paths = _expand(path)
        data_schema = self._schema or (
            orc_schema(paths) if fmt == "orc" else parquet_schema(paths))
        part_values, part_fields = _discover_partitions(path, paths)
        schema = T.StructType(tuple(data_schema.fields) + part_fields)
        return DataFrame(self.session, ParquetRelation(
            paths, schema, format=fmt,
            partition_values=list(part_values) or None,
            partition_fields=part_fields))

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = str(fmt).lower()
        return self

    def load(self, path):
        fmt = getattr(self, "_format", "parquet")
        if fmt in ("delta", "iceberg", "parquet", "orc", "csv", "json",
                   "text", "avro"):
            return getattr(self, fmt)(path)
        raise ValueError(f"unknown read format {fmt!r}")

    def parquet(self, path):
        return self._file_relation(path, "parquet")

    def delta(self, path):
        """Delta Lake table read via transaction-log replay
        [REF: GpuDeltaLog / GpuDeltaParquetFileFormat]."""
        from spark_rapids_tpu_torch.io.delta import delta_relation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        return DataFrame(self.session, delta_relation(path))

    def orc(self, path):
        """[REF: GpuOrcScan.scala] — host pyarrow.orc decode + H2D."""
        return self._file_relation(path, "orc")

    def avro(self, path):
        """Flat-record avro via the built-in container codec
        [REF: GpuAvroScan.scala — host-parsed there too]; several files
        concatenate with permissive type promotion."""
        from spark_rapids_tpu_torch.io.avro import avro_to_arrow
        paths = _expand(path)
        tbl = pa.concat_tables([avro_to_arrow(p) for p in paths],
                               promote_options="permissive")
        if self._schema is not None:
            # a user schema casts the columns onto the declared types,
            # in the declared order, as for the other formats
            tbl = tbl.select(self._schema.field_names()).cast(pa.schema(
                [(f.name, T.to_arrow(f.dtype))
                 for f in self._schema.fields]))
        return self.session.createDataFrame(tbl)

    def iceberg(self, path):
        """Iceberg table read via metadata and manifest replay
        [REF: GpuIcebergParquetReader]."""
        from spark_rapids_tpu_torch.io.iceberg import iceberg_relation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        return DataFrame(self.session, iceberg_relation(path))

    def text(self, path):
        """Each line as one 'value' string column (spark.read.text)."""
        paths = _expand(path)
        rows = []
        for p in paths:
            with open(p, "r", errors="replace") as f:
                rows.extend(line.rstrip("\n") for line in f)
        return self.session.createDataFrame(
            pa.table({"value": pa.array(rows, type=pa.string())}))

    def csv(self, path, header: Optional[bool] = None):
        paths = _expand(path)
        if header is None:
            header = str(self._options.get("header", "false")).lower() in (
                "true", "1")
        read_opts = pacsv.ReadOptions(
            autogenerate_column_names=not header)
        convert = pacsv.ConvertOptions()
        if self._schema is not None:
            # user schema drives column types (and names when headerless)
            if not header:
                read_opts = pacsv.ReadOptions(
                    column_names=self._schema.field_names())
            convert = pacsv.ConvertOptions(column_types={
                f.name: T.to_arrow(f.dtype)
                for f in self._schema.fields})
        tables = [pacsv.read_csv(p, read_options=read_opts,
                                 convert_options=convert) for p in paths]
        tbl = pa.concat_tables(tables, promote_options="permissive")
        if not header and self._schema is None:
            tbl = tbl.rename_columns(
                [f"_c{i}" for i in range(tbl.num_columns)])
        return self.session.createDataFrame(tbl)

    def json(self, path):
        paths = _expand(path)
        parse = pajson.ParseOptions()
        if self._schema is not None:
            parse = pajson.ParseOptions(explicit_schema=pa.schema(
                [(f.name, T.to_arrow(f.dtype))
                 for f in self._schema.fields]))
        tables = [pajson.read_json(p, parse_options=parse) for p in paths]
        tbl = pa.concat_tables(tables, promote_options="permissive")
        return self.session.createDataFrame(tbl)


class DataFrameWriter:
    def __init__(self, df):
        self.df = df
        self._mode = "error"
        self._options: Dict[str, str] = {}
        self._partition_by: List[str] = []

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[str(key)] = value
        return self

    def partitionBy(self, *cols) -> "DataFrameWriter":
        """Hive-style dynamic-partition layout (k=v directories)
        [REF: GpuFileFormatDataWriter.scala]."""
        self._partition_by = [c for c in cols]
        return self

    def parquet(self, path: str):
        write_parquet(self.df.toArrow(), path, self._mode,
                      partition_by=self._partition_by)

    def orc(self, path: str):
        write_parquet(self.df.toArrow(), path, self._mode,
                      partition_by=self._partition_by, fmt="orc")

    def csv(self, path: str):
        table = self.df.toArrow()
        if os.path.exists(path) and self._mode == "overwrite":
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path) and self._mode in ("error",
                                                     "errorifexists"):
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        pacsv.write_csv(table, os.path.join(path, "part-00000.csv"))

    def json(self, path: str):
        table = self.df.toArrow()
        if os.path.exists(path) and self._mode == "overwrite":
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path) and self._mode in ("error",
                                                     "errorifexists"):
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        rows = table.to_pylist()
        with open(os.path.join(path, "part-00000.json"), "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
