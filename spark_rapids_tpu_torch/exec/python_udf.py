"""Python / pandas UDF bridge.

[REF: sql-plugin/../python/ :: GpuArrowEvalPythonExec (scalar + pandas
 UDFs), GpuMapInPandasExec, GpuFlatMapGroupsInPandasExec,
 GpuArrowPythonRunner] — the reference moves device batches JVM ->
Python over Arrow IPC sockets.  The counterpart of the JAX package's
``exec/python_udf.py``: this engine *is* Python, so the bridge is an
in-process Arrow handoff, with no sockets, worker pool or
serialization:

* UDF **arguments are computed on the device** (any supported
  expression), then only those columns cross device-to-host, never the
  whole row; they cross as Arrow arrays of the SQL types (a date is a
  ``date32``, so a row UDF sees ``datetime.date``; a null is ``None``);
* row UDFs get Python objects, pandas UDFs get ``pandas.Series``;
* a result returns host-to-device as one padded column appended to the
  batch (Spark's BatchEvalPython column-append contract);
* ``mapInPandas`` / ``applyInPandas`` stream Arrow -> pandas frames
  through the user function; the grouped map rides a hash exchange so
  that a group never splits across partitions.

The device execs time the device-to-host copies as ``transferTime`` and
the user functions as ``udfTime``, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Sequence

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, _pad_col, arrow_column_to_device, compact, device_to_host,
    host_to_device)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.ops.expressions import Expression


@dataclasses.dataclass
class PyUDFSpec:
    """One bound python UDF call: fn over evaluated arg expressions."""

    fn: Callable
    args: List[Expression]
    dtype: T.DataType
    vectorized: bool  # pandas_udf (Series -> Series) vs row udf
    name: str = "udf"


def _run_udf(udf: PyUDFSpec, arg_arrays: List[pa.ChunkedArray],
             n: int) -> pa.Array:
    """Invoke the user function; returns an arrow array of udf.dtype."""
    out_type = T.to_arrow(udf.dtype)
    if udf.vectorized:
        series = [a.to_pandas() for a in arg_arrays]
        res = udf.fn(*series)
        arr = pa.Array.from_pandas(res, type=out_type)
    else:
        cols = [a.to_pylist() for a in arg_arrays]
        out = [udf.fn(*vals) for vals in zip(*cols)] if cols else \
            [udf.fn() for _ in range(n)]
        arr = pa.array(out, type=out_type)
    if len(arr) != n:
        raise ValueError(
            f"UDF '{udf.name}' returned {len(arr)} rows, expected {n}")
    return arr


class CpuArrowEvalPythonExec(CpuExec):
    """[REF: GpuArrowEvalPythonExec] — CPU oracle path."""

    def __init__(self, udfs: Sequence[PyUDFSpec], schema: T.StructType,
                 child: CpuExec):
        super().__init__(schema, child)
        self.udfs = list(udfs)

    def node_string(self):
        return f"ArrowEvalPython [{', '.join(u.name for u in self.udfs)}]"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b in self.children[0].execute(partition):
            with self.timer():
                cols = list(b.columns)
                for udf in self.udfs:
                    args = [H.to_arrow_column(e.eval_cpu(b))
                            for e in udf.args]
                    res = _run_udf(udf, [pa.chunked_array([a])
                                         for a in args], b.num_rows)
                    cols.append(H.from_arrow_column(res, udf.dtype))
                out = H.HostBatch(self.schema, cols)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


class TpuArrowEvalPythonExec(TpuExec):
    """Device batch -> (args on the device) -> D2H of the args only ->
    python fn -> H2D of the result column, appended.

    [REF: GpuArrowEvalPythonExec + GpuArrowPythonRunner — re-designed
    in-process (module docstring)]"""

    def __init__(self, udfs: Sequence[PyUDFSpec], schema: T.StructType,
                 child: TpuExec, device: torch.device):
        super().__init__(schema, child)
        self.udfs = list(udfs)
        self.device = device

    def node_string(self):
        return (f"TpuArrowEvalPython "
                f"[{', '.join(u.name for u in self.udfs)}]")

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        for b in self.children[0].execute(partition):
            cb = compact(b)
            with self.timer():
                # evaluate args on the device, transfer just those columns
                arg_fields = []
                arg_cols = []
                for ui, udf in enumerate(self.udfs):
                    for ai, e in enumerate(udf.args):
                        arg_fields.append(
                            T.StructField(f"_u{ui}a{ai}", e.dtype))
                        arg_cols.append(e.eval(cb))
                sub = DeviceBatch(T.StructType(tuple(arg_fields)),
                                  tuple(arg_cols), cb.sel, compacted=True)
                with self.timer("transferTime"):
                    tbl = device_to_host(sub)
                # a zero-column table loses its row count: take the live
                # rows of the batch (zero-arg UDFs), one host read
                n = tbl.num_rows if tbl.num_columns else cb.num_rows_host()
                new_cols = list(cb.columns)
                k = 0
                for udf in self.udfs:
                    arrs = [tbl.column(k + i)
                            for i in range(len(udf.args))]
                    k += len(udf.args)
                    with self.timer("udfTime"):
                        res = _run_udf(udf, arrs, n)
                    dc = arrow_column_to_device(res, udf.dtype, self.device)
                    new_cols.append(_pad_col(dc, cb.capacity))
                out = DeviceBatch(self.schema, tuple(new_cols), cb.sel,
                                  compacted=True)
            self.metric("numOutputBatches").add(1)
            yield out


class CpuMapInPandasExec(CpuExec):
    """[REF: GpuMapInPandasExec] — fn(iterator of pandas.DataFrame) ->
    iterator of pandas.DataFrame with the declared output schema."""

    def __init__(self, fn: Callable, schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.fn = fn

    def node_string(self):
        return "MapInPandas"

    def _pump(self, frames) -> Iterator[H.HostBatch]:
        for df in self.fn(frames):
            tbl = pa.Table.from_pandas(df, preserve_index=False)
            tbl = _conform(tbl, self.schema)
            out = H.from_arrow_table(tbl)
            out = H.HostBatch(self.schema, out.columns)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child = self.children[0]

        def frames():
            for b in child.execute(partition):
                yield H.to_arrow_table(b).to_pandas()

        yield from self._pump(frames())


class TpuMapInPandasExec(TpuExec):
    """[REF: GpuMapInPandasExec] — D2H -> pandas -> fn -> H2D."""

    def __init__(self, fn: Callable, schema: T.StructType, child: TpuExec,
                 device: torch.device):
        super().__init__(schema, child)
        self.fn = fn
        self.device = device

    def node_string(self):
        return "TpuMapInPandas"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]

        def frames():
            for b in child.execute(partition):
                with self.timer("transferTime"):
                    tbl = device_to_host(b)
                yield tbl.to_pandas()

        for df in self.fn(frames()):
            with self.timer("udfTime"):
                tbl = pa.Table.from_pandas(df, preserve_index=False)
                tbl = _conform(tbl, self.schema)
            with self.timer():
                out = host_to_device(tbl, self.device)
                out = DeviceBatch(self.schema, out.columns, out.sel,
                                  compacted=True)
            self.metric("numOutputRows").add(tbl.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


def _apply_groups(tbl: pa.Table, key_indices: List[int], fn: Callable,
                  schema: T.StructType) -> Iterator[pa.Table]:
    """Shared grouped-map core: pandas groupby-apply, streamed per
    group, results conformed onto the declared schema.  One
    implementation so the CPU oracle and the device path can never
    diverge on group semantics (null keys grouped, sorted key order)."""
    if tbl.num_rows == 0:
        return
    df = tbl.to_pandas()
    keys = [tbl.column_names[i] for i in key_indices]
    for _, g in df.groupby(keys, dropna=False, sort=True):
        res = fn(g)
        out = pa.Table.from_pandas(res, preserve_index=False)
        yield _conform(out, schema)


class CpuFlatMapGroupsInPandasExec(CpuExec):
    """[REF: GpuFlatMapGroupsInPandasExec] — grouped map: the child is
    hash-partitioned on the keys, so every group lives in one partition;
    pandas groupby-apply runs per partition."""

    def __init__(self, key_indices: List[int], fn: Callable,
                 schema: T.StructType, child: CpuExec):
        super().__init__(schema, child)
        self.key_indices = list(key_indices)
        self.fn = fn

    def node_string(self):
        return "FlatMapGroupsInPandas"

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        child = self.children[0]
        tables = [H.to_arrow_table(b) for b in child.execute(partition)]
        if not tables:
            return
        with self.timer("udfTime"):
            outs = _apply_groups(pa.concat_tables(tables),
                                 self.key_indices, self.fn, self.schema)
            for out in outs:
                b = H.from_arrow_table(out)
                b = H.HostBatch(self.schema, b.columns)
                self.metric("numOutputRows").add(b.num_rows)
                self.metric("numOutputBatches").add(1)
                yield b


class TpuFlatMapGroupsInPandasExec(TpuExec):
    """[REF: GpuFlatMapGroupsInPandasExec] — device exchange upstream,
    D2H per partition, pandas groupby-apply, H2D per group result."""

    def __init__(self, key_indices: List[int], fn: Callable,
                 schema: T.StructType, child: TpuExec,
                 device: torch.device):
        super().__init__(schema, child)
        self.key_indices = list(key_indices)
        self.fn = fn
        self.device = device

    def node_string(self):
        return "TpuFlatMapGroupsInPandas"

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        child = self.children[0]
        tables = []
        for b in child.execute(partition):
            with self.timer("transferTime"):
                tables.append(device_to_host(b))
        if not tables:
            return
        groups = _apply_groups(pa.concat_tables(tables), self.key_indices,
                               self.fn, self.schema)
        while True:
            with self.timer("udfTime"):
                out = next(groups, None)
            if out is None:
                return
            with self.timer():
                d = host_to_device(out, self.device)
                d = DeviceBatch(self.schema, d.columns, d.sel,
                                compacted=True)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield d


def _conform(tbl: pa.Table, schema: T.StructType) -> pa.Table:
    """Cast/reorder a UDF result table onto the declared schema."""
    if tbl.column_names != schema.field_names():
        missing = [n for n in schema.field_names()
                   if n not in tbl.column_names]
        if missing:
            raise ValueError(
                f"UDF result is missing declared columns {missing}; "
                f"got {tbl.column_names}")
        tbl = tbl.select(schema.field_names())
    arrays = []
    for f in schema.fields:
        col = tbl.column(f.name)
        want = T.to_arrow(f.dtype)
        if col.type != want:
            col = col.cast(want)
        arrays.append(col)
    return pa.table(arrays, names=schema.field_names())


# -- override rules ---------------------------------------------------------

def _tag_python_eval(meta):
    for udf in meta.cpu.udfs:
        meta.tag_expressions(udf.args)


def _convert_python_eval(cpu, ch, conf, device):
    return TpuArrowEvalPythonExec(cpu.udfs, cpu.schema, ch[0], device)


def _convert_map_in_pandas(cpu, ch, conf, device):
    return TpuMapInPandasExec(cpu.fn, cpu.schema, ch[0], device)


def _convert_flat_map_groups(cpu, ch, conf, device):
    return TpuFlatMapGroupsInPandasExec(cpu.key_indices, cpu.fn,
                                        cpu.schema, ch[0], device)
