"""Host columns for the CPU fallback and oracle path.

The counterpart of the JAX package's ``columnar/host.py``: numpy data
plus a validity mask (True = valid, None = all valid).  CPU execs
evaluate expressions over these with ``eval_cpu``; strings are object
arrays of Python ``str``.  The types are the port's: numbers, booleans,
strings, binary, dates (int32 days), timestamps (int64 microseconds,
UTC), decimals (unscaled int64 for precision <= 18, and for wider
ones, decimal128, an object array of exact Python ints) and arrays of
any element type (an object array of Python lists, a null list held as
``[]`` under a False validity), as the JAX package keeps them; date and
timestamp elements are int32 days and int64 microseconds there, as
scalars are (the JAX package keeps ``datetime`` objects, which its CPU
explode cannot read: ROADMAP C.7).  Struct
and map columns raise ``NotImplementedError``: the session splits a
struct into one column per field before any exec sees it.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import List, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch.columnar import dtypes as T

_M64 = (1 << 64) - 1


@dataclasses.dataclass
class HostCol:
    dtype: T.DataType
    data: np.ndarray            # object array for strings on host
    validity: Optional[np.ndarray] = None  # bool, True = valid; None = all

    def valid_mask(self, n=None) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.data) if n is None else n, dtype=bool)
        return self.validity

    def __len__(self):
        return len(self.data)


@dataclasses.dataclass
class HostBatch:
    schema: T.StructType
    columns: List[HostCol]

    @property
    def num_rows(self):
        return len(self.columns[0]) if self.columns else 0


def _not_ported(dt: T.DataType) -> NotImplementedError:
    return NotImplementedError(
        f"spark_rapids_tpu_torch: host columns of type {dt.simple_name} "
        "are not ported yet")


def from_arrow_table(tbl: pa.Table) -> HostBatch:
    fields = []
    cols = []
    for name, col in zip(tbl.column_names, tbl.columns):
        dt = T.from_arrow(col.type)
        fields.append(T.StructField(name, dt))
        cols.append(from_arrow_column(col, dt))
    return HostBatch(T.StructType(tuple(fields)), cols)


def from_arrow_column(col, dt: T.DataType) -> HostCol:
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if pa.types.is_dictionary(col.type):
        col = col.cast(col.type.value_type)
    nulls = np.asarray(col.is_null())
    validity = ~nulls if nulls.any() else None
    if isinstance(dt, T.ArrayType):
        return HostCol(dt, _python_lists(col, dt.element_type), validity)
    if isinstance(dt, (T.StructType, T.MapType)):
        raise _not_ported(dt)
    if isinstance(dt, T.DecimalType):
        from spark_rapids_tpu_torch.columnar import column as C
        if dt.precision > T.DecimalType.MAX_LONG_DIGITS:
            hilo = C.decimal_to_hilo(col)
            data = np.empty(len(col), dtype=object)
            data[:] = [(int(h) << 64) | (int(l) & _M64) for h, l in hilo]
        else:
            data = np.ascontiguousarray(C.decimal_to_int64(col))
    elif isinstance(dt, (T.StringType, T.BinaryType)):
        data = np.array(
            ["" if v is None else v for v in col.to_pylist()], dtype=object)
    elif isinstance(dt, T.DateType):
        data = np.asarray(col.cast(pa.date32()).cast(pa.int32()).fill_null(0))
    elif isinstance(dt, T.TimestampType):
        c = col
        if c.type.unit != "us":
            c = c.cast(pa.timestamp("us", tz=c.type.tz))
        data = np.asarray(c.cast(pa.int64()).fill_null(0))
    elif isinstance(dt, T.BooleanType):
        data = np.asarray(col.cast(pa.int8()).fill_null(0)).astype(bool)
    else:
        data = np.asarray(col.fill_null(0)).astype(T.to_numpy_dtype(dt))
    return HostCol(dt, data, validity)


def _python_lists(col: pa.Array, et: T.DataType) -> np.ndarray:
    """An Arrow list column -> an object array of Python lists (a null
    list as ``[]``).  Fixed-width elements come from the values buffer
    in one ``tolist`` and are sliced per row (dates as int32 days,
    timestamps as int64 microseconds, the scalars' host rep, which the
    oracles' collects also produce): ``to_pylist`` boxes each element
    through an Arrow scalar, which made it most of a list column's
    pull.  Other elements take ``to_pylist``."""
    from spark_rapids_tpu_torch.columnar import column as C
    n = len(col)
    data = np.empty(n, dtype=object)
    if not C.is_primitive_element(et):
        for i, v in enumerate(col.to_pylist()):
            data[i] = [] if v is None else v
        return data
    if pa.types.is_large_list(col.type):
        col = col.cast(pa.list_(col.type.value_type))
    offs = np.asarray(col.offsets)
    ends = np.where(np.asarray(col.is_null()), offs[:-1], offs[1:])
    values = C._primitive_values(col.values, et).tolist()
    if col.values.null_count:
        for k in np.nonzero(np.asarray(col.values.is_null()))[0].tolist():
            values[k] = None
    # millions of new lists: the cyclic collector would rescan them all
    # at every generation threshold, and none of them can form a cycle
    enabled = gc.isenabled()
    gc.disable()
    try:
        for i, (a, b) in enumerate(zip(offs[:-1].tolist(), ends.tolist())):
            data[i] = values[a:b]
    finally:
        if enabled:
            gc.enable()
    return data


def to_arrow_table(batch: HostBatch) -> pa.Table:
    arrays = [to_arrow_column(c) for c in batch.columns]
    return pa.table(arrays, names=[f.name for f in batch.schema.fields])


def to_arrow_column(c: HostCol) -> pa.Array:
    mask = None
    if c.validity is not None:
        mask = ~c.validity
    if isinstance(c.dtype, T.ArrayType):
        vals = list(c.data)
        if mask is not None:
            vals = [None if m else v for v, m in zip(vals, mask)]
        return pa.array(vals, type=T.to_arrow(c.dtype))
    if isinstance(c.dtype, (T.StructType, T.MapType)):
        raise _not_ported(c.dtype)
    if isinstance(c.dtype, T.DecimalType):
        from spark_rapids_tpu_torch.columnar.column import decimal_array
        from spark_rapids_tpu_torch.ops.decimal128 import np_pack
        data = (np_pack(c.data)
                if c.dtype.precision > T.DecimalType.MAX_LONG_DIGITS
                else np.asarray(c.data, np.int64))
        return decimal_array(c.dtype, data, c.validity)
    if isinstance(c.dtype, (T.StringType, T.BinaryType)):
        # the object array converts in one call (a masked slot's value
        # is ignored)
        return pa.array(c.data, type=T.to_arrow(c.dtype), mask=mask)
    if isinstance(c.dtype, T.DateType):
        return pa.array(c.data.astype(np.int32), type=pa.int32(),
                        mask=mask).cast(pa.date32())
    if isinstance(c.dtype, T.TimestampType):
        return pa.array(c.data.astype(np.int64), type=pa.int64(),
                        mask=mask).cast(pa.timestamp("us", tz="UTC"))
    return pa.array(c.data, type=T.to_arrow(c.dtype), mask=mask)
