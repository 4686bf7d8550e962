"""Device columnar data model — ``DeviceColumn``/``DeviceBatch`` over tensors.

The same layout as the JAX package's ``columnar/column.py``:

* every column is a set of tensors padded to a power-of-two row bucket;
* row liveness is a boolean ``sel`` mask on the batch (padding and
  filtered-out rows are False); shapes never depend on the data, and
  compaction happens at deliberate points (host transfer, concat);
* strings are padded byte matrices ``uint8[B, W]`` plus ``int32``
  lengths;
* null validity is a separate ``bool[B]`` mask (True = valid).

Host representation is a ``pyarrow.Table``.  Decimal, array and nested
columns are outside this slice of the port and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T

_TORCH_DTYPE = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64, np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt: T.DataType) -> torch.dtype:
    """Physical tensor dtype of a SQL type's data buffer."""
    _check_supported(dt)
    return _TORCH_DTYPE[np.dtype(T.to_numpy_dtype(dt))]


def _check_supported(dt: T.DataType) -> None:
    if isinstance(dt, (T.DecimalType, T.ArrayType, T.StructType,
                       T.MapType, T.NullType)):
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: column type {dt} is not ported yet")


def round_up_pow2(n: int, min_bucket: int = 1024) -> int:
    """Row bucket for n rows: next power of two, floored at min_bucket."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class DeviceColumn:
    """One SQL column on device.

    data:     tensor [B] (fixed width types) or uint8 [B, W] (string/binary)
    validity: bool [B], True = valid; None = all valid
    lengths:  int32 [B] for string/binary; None otherwise
    """

    dtype: T.DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return self.lengths is not None

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    def gather(self, idx: torch.Tensor) -> "DeviceColumn":
        """Row gather (compaction, sort, group layout)."""
        return DeviceColumn(
            self.dtype, self.data[idx],
            None if self.validity is None else self.validity[idx],
            None if self.lengths is None else self.lengths[idx])


@dataclasses.dataclass
class DeviceBatch:
    """A columnar batch on device — the ``ColumnarBatch`` of this engine.

    ``sel`` is the live-row mask.  ``compacted`` promises that live rows
    sit at the front (sel == arange < n), letting consumers skip the
    compaction sort.
    """

    schema: T.StructType
    columns: Tuple[DeviceColumn, ...]
    sel: torch.Tensor  # bool[B]
    compacted: bool = False

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def num_rows(self) -> torch.Tensor:
        """Live row count (device scalar)."""
        return self.sel.sum()

    def num_rows_host(self) -> int:
        return int(self.num_rows())

    def with_sel(self, sel: torch.Tensor) -> "DeviceBatch":
        return DeviceBatch(self.schema, self.columns, sel)


# ---------------------------------------------------------------------------
# Compaction: live rows to the front, stably.
# ---------------------------------------------------------------------------

def compact(batch: DeviceBatch) -> DeviceBatch:
    """Stable move of the live rows to the front (a stable argsort of the
    dead flag and a gather, as the JAX package does)."""
    if batch.compacted:
        return batch
    order = torch.argsort((~batch.sel).to(torch.uint8), stable=True)
    cols = tuple(c.gather(order) for c in batch.columns)
    count = batch.sel.sum()
    sel = torch.arange(batch.capacity, device=batch.device) < count
    return DeviceBatch(batch.schema, cols, sel, compacted=True)


def empty_batch(schema: T.StructType, device: torch.device,
                bucket: int = 1024) -> DeviceBatch:
    """A batch of ``bucket`` rows, none live (strings 8 bytes wide), as
    the JAX package's ``empty_batch`` lays it out."""
    cols = []
    for f in schema.fields:
        if isinstance(f.dtype, (T.StringType, T.BinaryType)):
            cols.append(DeviceColumn(
                f.dtype, torch.zeros((bucket, 8), dtype=torch.uint8,
                                     device=device),
                None, torch.zeros((bucket,), dtype=torch.int32,
                                  device=device)))
        else:
            cols.append(DeviceColumn(f.dtype, torch.zeros(
                (bucket,), dtype=torch_dtype(f.dtype), device=device)))
    return DeviceBatch(schema, tuple(cols),
                       torch.zeros((bucket,), dtype=torch.bool,
                                   device=device), compacted=True)


def slice_batch(batch: DeviceBatch, lo: int, cap: int) -> DeviceBatch:
    """Row slice ``[lo, lo + cap)`` of every tensor of a batch (views).

    A port-local copy of the JAX package's ``parallel/shuffle.py::
    slice_batch``.  A slice of a compacted batch keeps its live rows as
    a contiguous prefix, so it stays compacted.
    """
    def cut(x):
        return x[lo:lo + cap]

    cols = tuple(
        DeviceColumn(c.dtype, cut(c.data),
                     None if c.validity is None else cut(c.validity),
                     None if c.lengths is None else cut(c.lengths))
        for c in batch.columns)
    return DeviceBatch(batch.schema, cols, cut(batch.sel),
                       compacted=batch.compacted)


# ---------------------------------------------------------------------------
# Host (pyarrow) <-> device conversion
# ---------------------------------------------------------------------------

def _string_to_matrix(arr: pa.Array) -> Tuple[np.ndarray, np.ndarray]:
    """Arrow string/binary array -> (uint8[B,W] matrix, int32 lengths)."""
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    if pa.types.is_large_string(arr.type) or pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.string() if pa.types.is_large_string(arr.type) else pa.binary())
    n = len(arr)
    # offsets/data straight from arrow buffers; nulls handled via validity
    buffers = arr.buffers()
    offs = np.frombuffer(buffers[1], dtype=np.int32, count=n + 1, offset=arr.offset * 4)
    data = np.frombuffer(buffers[2], dtype=np.uint8) if buffers[2] is not None else np.zeros(0, np.uint8)
    lengths = (offs[1:] - offs[:-1]).astype(np.int32)
    null_mask = np.asarray(arr.is_null())
    lengths = np.where(null_mask, 0, lengths).astype(np.int32)
    w = round_up_pow2(int(lengths.max()) if n else 1, 8)
    mat = np.zeros((n, w), dtype=np.uint8)
    total = int(lengths.sum())
    if total:
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        row_idx = np.repeat(np.arange(n), lengths)
        col_idx = np.arange(total) - np.repeat(starts, lengths)
        src_pos = np.repeat(offs[:-1].astype(np.int64), lengths) + col_idx
        mat[row_idx, col_idx] = data[src_pos]
    return mat, lengths


def _matrix_to_string(mat: np.ndarray, lengths: np.ndarray,
                      validity: Optional[np.ndarray], binary: bool) -> pa.Array:
    n, w = mat.shape
    lengths = lengths.astype(np.int64)
    col = np.arange(w)[None, :]
    mask2d = col < lengths[:, None]
    flat = mat[mask2d]
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    typ = pa.binary() if binary else pa.string()
    null_buf = None
    if validity is not None and not validity.all():
        null_buf = pa.py_buffer(np.packbits(validity, bitorder="little").tobytes())
    return pa.Array.from_buffers(
        typ, n,
        [null_buf, pa.py_buffer(offsets.tobytes()), pa.py_buffer(flat.tobytes())],
        null_count=-1 if null_buf is not None else 0,
    )


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device``.  Arrow hands out read-only
    buffers, so the data is always copied once: into a pinned staging
    tensor for a CUDA device (then an asynchronous DMA), or into an owned
    tensor for the CPU."""
    a = np.asarray(a)
    if device.type == "cuda":
        staging = torch.empty(a.shape, dtype=_TORCH_DTYPE[a.dtype],
                              pin_memory=True)
        staging.numpy()[...] = a
        return staging.to(device, non_blocking=True)
    return torch.from_numpy(np.array(a))


def arrow_column_to_device(arr, dt: T.DataType,
                           device: torch.device) -> DeviceColumn:
    _check_supported(dt)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    null_mask = np.asarray(arr.is_null())
    validity = (_to_device(~null_mask, device) if null_mask.any()
                else None)
    if isinstance(dt, (T.StringType, T.BinaryType)):
        mat, lengths = _string_to_matrix(arr)
        return DeviceColumn(dt, _to_device(mat, device), validity,
                            _to_device(lengths, device))
    npdt = T.to_numpy_dtype(dt)
    if isinstance(dt, T.DateType):
        if not pa.types.is_date32(arr.type):
            arr = arr.cast(pa.date32())
        casted = arr.cast(pa.int32())
    elif isinstance(dt, T.TimestampType):
        # any unit/tz to the device rep: micros since epoch UTC
        if arr.type.unit != "us":
            arr = arr.cast(pa.timestamp("us", tz=arr.type.tz))
        casted = arr.cast(pa.int64())
    elif isinstance(dt, T.BooleanType):
        casted = arr.cast(pa.int8())
    else:
        casted = arr
    data = np.asarray(casted.fill_null(0))
    if isinstance(dt, T.BooleanType):
        data = data.astype(np.bool_)
    data = data.astype(npdt, copy=False)
    return DeviceColumn(dt, _to_device(data, device), validity)


def _pad_col(c: DeviceColumn, bucket: int) -> DeviceColumn:
    n = c.capacity
    if n == bucket:
        return c
    pad = bucket - n

    def grow(x):
        out = torch.zeros((bucket,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:n] = x
        return out

    return DeviceColumn(c.dtype, grow(c.data),
                        None if c.validity is None else grow(c.validity),
                        None if c.lengths is None else grow(c.lengths))


def pad_batch(batch: DeviceBatch, capacity: int) -> DeviceBatch:
    """Grow a batch's row capacity (pad rows are dead)."""
    if batch.capacity >= capacity:
        return batch
    cols = tuple(_pad_col(c, capacity) for c in batch.columns)
    sel = torch.zeros((capacity,), dtype=torch.bool, device=batch.device)
    sel[:batch.capacity] = batch.sel
    return DeviceBatch(batch.schema, cols, sel, compacted=batch.compacted)


def host_to_device(table: pa.Table, device: torch.device,
                   bucket: Optional[int] = None,
                   min_bucket: int = 1024) -> DeviceBatch:
    """pyarrow.Table -> padded DeviceBatch on ``device``."""
    n = table.num_rows
    b = bucket or round_up_pow2(max(n, 1), min_bucket)
    fields = []
    cols = []
    for name, col in zip(table.column_names, table.columns):
        dt = T.from_arrow(col.type)
        dc = arrow_column_to_device(col, dt, device)
        cols.append(_pad_col(dc, b))
        fields.append(T.StructField(name, dt))
    sel = torch.arange(b, device=device) < n
    return DeviceBatch(T.StructType(tuple(fields)), tuple(cols), sel,
                       compacted=True)


def device_to_host(batch: DeviceBatch) -> pa.Table:
    """DeviceBatch -> pyarrow.Table (compacts first)."""
    batch = compact(batch)
    n = batch.num_rows_host()
    arrays = []
    names = []
    for f, c in zip(batch.schema.fields, batch.columns):
        names.append(f.name)
        validity = (None if c.validity is None
                    else c.validity[:n].cpu().numpy())
        if c.is_string:
            arrays.append(_matrix_to_string(
                c.data[:n].cpu().numpy(), c.lengths[:n].cpu().numpy(),
                validity, isinstance(f.dtype, T.BinaryType)))
            continue
        data = c.data[:n].cpu().numpy()
        if isinstance(f.dtype, T.DateType):
            arr = pa.array(data.astype(np.int32), type=pa.int32()).cast(
                pa.date32())
        elif isinstance(f.dtype, T.TimestampType):
            arr = pa.array(data.astype(np.int64), type=pa.int64()).cast(
                pa.timestamp("us", tz="UTC"))
        else:
            arr = pa.array(data, type=T.to_arrow(f.dtype))
        if validity is not None and not validity.all():
            arr = pa.Array.from_buffers(
                arr.type, n,
                [pa.py_buffer(np.packbits(validity, bitorder="little").tobytes())]
                + list(arr.buffers()[1:]),
                null_count=-1,
            )
        arrays.append(arr)
    return pa.table(arrays, names=names)


def from_numpy_batch(schema: T.StructType,
                     arrays: Sequence[Tuple[np.ndarray, Optional[np.ndarray],
                                            Optional[np.ndarray]]],
                     sel: np.ndarray, device) -> DeviceBatch:
    """Numpy buffers of a batch -> this port's DeviceBatch on ``device``.

    ``arrays`` holds one ``(data, validity, lengths)`` triple per schema
    field (``validity``/``lengths`` may be None), ``sel`` the live-row
    mask: the buffers of a JAX-side ``DeviceBatch`` after ``np.asarray``,
    so that both packages can be fed identical batches.
    """
    if len(arrays) != len(schema.fields):
        raise ValueError(f"{len(arrays)} column buffers for a "
                         f"{len(schema.fields)}-field schema")
    device = torch.device(device)
    sel = np.asarray(sel, dtype=np.bool_)
    cols = []
    for f, (data, validity, lengths) in zip(schema.fields, arrays):
        data = np.asarray(data)
        want = np.dtype(T.to_numpy_dtype(f.dtype))
        if data.dtype != want:
            raise TypeError(f"column {f.name!r}: {data.dtype} buffer for "
                            f"{f.dtype} (expected {want})")
        if data.shape[0] != sel.shape[0]:
            raise ValueError(f"column {f.name!r}: {data.shape[0]} rows, "
                             f"sel has {sel.shape[0]}")
        is_str = isinstance(f.dtype, (T.StringType, T.BinaryType))
        if is_str != (lengths is not None):
            raise ValueError(f"column {f.name!r}: lengths must be given "
                             "exactly for string/binary columns")
        cols.append(DeviceColumn(
            f.dtype, _to_device(data, device),
            None if validity is None else _to_device(
                np.asarray(validity, dtype=np.bool_), device),
            None if lengths is None else _to_device(
                np.asarray(lengths, dtype=np.int32), device)))
    return DeviceBatch(schema, tuple(cols), _to_device(sel, device))
