"""Device columnar data model — ``DeviceColumn``/``DeviceBatch`` over tensors.

The same layout as the JAX package's ``columnar/column.py``:

* every column is a set of tensors padded to a power-of-two row bucket;
* row liveness is a boolean ``sel`` mask on the batch (padding and
  filtered-out rows are False); shapes never depend on the data, and
  compaction happens at deliberate points (host transfer, concat);
* strings are padded byte matrices ``uint8[B, W]`` plus ``int32``
  lengths;
* null validity is a separate ``bool[B]`` mask (True = valid);
* decimals of precision <= 18 are scaled ``int64[B]``; wider ones
  (decimal128) are ``int64[B, 2]`` (hi, lo) — ``ops/decimal128.py``;
* an ``array<primitive>`` column is a padded element matrix
  ``elem[B, W]`` (W the next power of two of its longest list) plus
  ``int32`` lengths, and an optional ``bool[B, W]`` ``evalid`` plane
  when elements may be null — the layout ``collect_list`` produces and
  ``explode`` consumes.

What a column is (string, array, fixed width) is decided by its dtype,
never by which buffers it carries: strings and arrays both carry
lengths.  Host representation is a ``pyarrow.Table``.  Arrays of
strings, binaries, decimals or nested types, maps and nulls have no
device layout and raise; struct columns never reach a batch (the
session splits them into one column per field, ``sql/session.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops.decimal128 import is128

_TORCH_DTYPE = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64, np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt: T.DataType) -> torch.dtype:
    """Physical tensor dtype of a SQL type's data buffer (an array's:
    its element's)."""
    _check_supported(dt)
    if isinstance(dt, T.ArrayType):
        dt = dt.element_type
    return _TORCH_DTYPE[np.dtype(T.to_numpy_dtype(dt))]


def is_primitive_element(dt: T.DataType) -> bool:
    """An array element type with a device layout: a number (not a
    decimal), a boolean, a date or a timestamp."""
    return isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                           T.IntegerType, T.LongType, T.FloatType,
                           T.DoubleType, T.DateType, T.TimestampType))


def _check_supported(dt: T.DataType) -> None:
    if isinstance(dt, T.ArrayType) and is_primitive_element(
            dt.element_type):
        return
    if isinstance(dt, (T.ArrayType, T.StructType, T.MapType, T.NullType)):
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: column type {dt} has no device "
            "layout")


def round_up_pow2(n: int, min_bucket: int = 1024) -> int:
    """Row bucket for n rows: next power of two, floored at min_bucket."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class DeviceColumn:
    """One SQL column on device.

    data:     tensor [B] (fixed width types), uint8 [B, W] (string/binary),
              int64 [B, 2] (decimal128: hi, lo) or elem [B, W]
              (array<primitive>)
    validity: bool [B], True = valid; None = all valid
    lengths:  int32 [B] for string/binary/array; None otherwise
    evalid:   bool [B, W] element validity of an array column whose
              elements may be null; None = every element valid
    """

    dtype: T.DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    evalid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, (T.StringType, T.BinaryType))

    @property
    def is_array(self) -> bool:
        return isinstance(self.dtype, T.ArrayType)

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.validity is not None:
            n += self.validity.numel()
        if self.lengths is not None:
            n += self.lengths.numel() * 4
        if self.evalid is not None:
            n += self.evalid.numel()
        return n

    def gather(self, idx: torch.Tensor) -> "DeviceColumn":
        """Row gather (compaction, sort, group layout)."""
        return self.map_rows(lambda x: x[idx])

    def map_rows(self, fn) -> "DeviceColumn":
        """The column with ``fn`` applied to each of its row-indexed
        tensors (data, validity, lengths, evalid): a gather, a slice."""
        return DeviceColumn(
            self.dtype, fn(self.data),
            None if self.validity is None else fn(self.validity),
            None if self.lengths is None else fn(self.lengths),
            None if self.evalid is None else fn(self.evalid))


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

    def nbytes(self) -> int:
        """Bytes of every column's data, lengths and validity, plus
        ``sel`` (the JAX package's ``DeviceBatch.nbytes``)."""
        return sum(c.nbytes() for c in self.columns) + self.sel.numel()

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
        elif isinstance(f.dtype, T.ArrayType):
            cols.append(DeviceColumn(
                f.dtype, torch.zeros((bucket, 1),
                                     dtype=torch_dtype(f.dtype),
                                     device=device),
                None, torch.zeros((bucket,), dtype=torch.int32,
                                  device=device)))
        elif is128(f.dtype):
            cols.append(DeviceColumn(f.dtype, torch.zeros(
                (bucket, 2), dtype=torch.int64, device=device)))
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

    cols = tuple(c.map_rows(cut) for c in batch.columns)
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


def _list_to_matrix(arr: pa.Array, elem_dt: T.DataType):
    """Arrow list array -> (elem[B, W] padded matrix, int32 lengths,
    optional bool[B, W] element validity): W is the next power of two
    of the longest list (1 at least); a null list has length 0; the
    element validity is given only when some element is null."""
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    if pa.types.is_large_list(arr.type):
        arr = arr.cast(pa.list_(arr.type.value_type))
    n = len(arr)
    offs = np.asarray(arr.offsets)
    lengths = (offs[1:] - offs[:-1]).astype(np.int32)
    lengths = np.where(np.asarray(arr.is_null()), 0, lengths).astype(
        np.int32)
    npdt = T.to_numpy_dtype(elem_dt)
    values = _primitive_values(arr.values, elem_dt).astype(npdt,
                                                           copy=False)
    evalues = None
    if arr.values.null_count:
        evalues = ~np.asarray(arr.values.is_null())
    w = round_up_pow2(int(lengths.max()) if n else 1, 1)
    mat = np.zeros((n, w), dtype=npdt)
    emask = None if evalues is None else np.ones((n, w), dtype=bool)
    total = int(lengths.sum())
    if total:
        row_idx = np.repeat(np.arange(n), lengths)
        col_idx = (np.arange(total)
                   - np.repeat(np.cumsum(lengths) - lengths, lengths))
        src = np.repeat(offs[:-1].astype(np.int64), lengths) + col_idx
        mat[row_idx, col_idx] = values[src]
        if emask is not None:
            emask[row_idx, col_idx] = evalues[src]
    return mat, lengths, emask


def _matrix_to_list(mat: np.ndarray, lengths: np.ndarray,
                    evalid: Optional[np.ndarray],
                    validity: Optional[np.ndarray],
                    dt: T.DataType) -> pa.Array:
    """The inverse of ``_list_to_matrix``: a padded element matrix, its
    lengths, element validity and row validity -> an Arrow list array
    (a null row is a null list)."""
    n = mat.shape[0]
    lengths = lengths.astype(np.int64)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    keep = np.arange(mat.shape[1])[None, :] < lengths[:, None]
    values = mat[keep]
    emask = None if evalid is None else ~evalid[keep]
    elem = _primitive_array(values, dt.element_type, emask)
    mask = (None if validity is None or validity.all()
            else pa.array(~validity))
    return pa.ListArray.from_arrays(pa.array(offsets), elem, mask=mask)


def _primitive_values(arr: pa.Array, dt: T.DataType) -> np.ndarray:
    """A fixed-width Arrow array's values as numpy, nulls as 0: dates as
    int32 days, timestamps as int64 microseconds (UTC)."""
    if isinstance(dt, T.DateType):
        if not pa.types.is_date32(arr.type):
            arr = arr.cast(pa.date32())
        arr = arr.cast(pa.int32())
    elif isinstance(dt, T.TimestampType):
        # any unit/tz to the device rep: micros since epoch UTC
        if arr.type.unit != "us":
            arr = arr.cast(pa.timestamp("us", tz=arr.type.tz))
        arr = arr.cast(pa.int64())
    elif isinstance(dt, T.BooleanType):
        return np.asarray(arr.cast(pa.int8()).fill_null(0)).astype(np.bool_)
    return np.asarray(arr.fill_null(0))


def _primitive_array(data: np.ndarray, dt: T.DataType,
                     null_mask: Optional[np.ndarray]) -> pa.Array:
    """Numpy values of a fixed-width type -> an Arrow array (the inverse
    of ``_primitive_values``); ``null_mask`` True marks a null."""
    if isinstance(dt, T.DateType):
        return pa.array(data.astype(np.int32), type=pa.int32(),
                        mask=null_mask).cast(pa.date32())
    if isinstance(dt, T.TimestampType):
        return pa.array(data.astype(np.int64), type=pa.int64(),
                        mask=null_mask).cast(pa.timestamp("us", tz="UTC"))
    return pa.array(data, type=T.to_arrow(dt), mask=null_mask)


def _decimal_words(arr: pa.Array) -> np.ndarray:
    """An Arrow decimal128 array's 16-byte little-endian two's-complement
    values as int64 ``[n, 2]`` (low word, high word): a read-only view of
    the buffer, or a copy with null slots zeroed."""
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * len(arr),
                          offset=arr.offset * 16).reshape(-1, 2)
    if arr.null_count:
        words = np.where(np.asarray(arr.is_null())[:, None], 0, words)
    return words


def decimal_to_int64(arr: pa.Array) -> np.ndarray:
    """A decimal column of precision <= 18 -> its unscaled int64 values
    (the JAX package's ``_decimal_to_int64``), a strided view where the
    buffer allows: the copy to the device reads it in one pass."""
    words = _decimal_words(arr)
    low = words[:, 0]
    # precision <= 18 fits the low word; the high one is its sign
    if not np.array_equal(words[:, 1], low >> 63):
        raise OverflowError("decimal value exceeds 18 digits")
    return low


def decimal_to_hilo(arr: pa.Array) -> np.ndarray:
    """A decimal128 column -> int64[n, 2] (hi, lo bit patterns)."""
    return _decimal_words(arr)[:, ::-1]


def decimal_array(dt: T.DataType, data: np.ndarray,
                  validity: Optional[np.ndarray]) -> pa.Array:
    """Unscaled int64[n] or (hi, lo) int64[n, 2] values -> an Arrow
    decimal128 array, built on its 16-byte buffers (exact at 38 digits,
    free of ``decimal`` context rounding)."""
    n = data.shape[0]
    raw = np.empty(2 * n, dtype=np.int64)
    if data.ndim == 2:
        raw[0::2] = data[:, 1]
        raw[1::2] = data[:, 0]
    else:
        low = data.astype(np.int64)
        raw[0::2] = low
        raw[1::2] = low >> 63
    null_buf = None
    if validity is not None and not validity.all():
        null_buf = pa.py_buffer(
            np.packbits(validity, bitorder="little").tobytes())
    return pa.Array.from_buffers(
        T.to_arrow(dt), n, [null_buf, pa.py_buffer(raw.tobytes())],
        null_count=-1 if null_buf is not None else 0)


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
    is_str = isinstance(dt, (T.StringType, T.BinaryType))
    if pa.types.is_dictionary(arr.type) and (
            not is_str or len(arr.dictionary) == 0
            or arr.dictionary.null_count > 0):
        # the device decode takes only string dictionaries with no null
        # VALUES (index nulls are fine); everything else decodes to
        # plain first — is_null() of a DictionaryArray does not see
        # nulls stored in the dictionary values
        arr = arr.cast(arr.type.value_type)
    null_mask = np.asarray(arr.is_null())
    validity = (_to_device(~null_mask, device) if null_mask.any()
                else None)
    if pa.types.is_dictionary(arr.type):
        # device dictionary decode: int32 indices and the dictionary's
        # own (small) byte matrix cross to the device, and a gather
        # expands them there — H2D bytes drop from n*W to n*4 + D*W.
        # The matrix width is the dictionary's, as in the JAX package.
        idx = _to_device(np.asarray(arr.indices.fill_null(0))
                         .astype(np.int32), device)
        dmat, dlens = _string_to_matrix(arr.dictionary)
        return DeviceColumn(
            dt, torch.index_select(_to_device(dmat, device), 0, idx),
            validity,
            torch.index_select(_to_device(dlens, device), 0, idx))
    if is_str:
        mat, lengths = _string_to_matrix(arr)
        return DeviceColumn(dt, _to_device(mat, device), validity,
                            _to_device(lengths, device))
    if isinstance(dt, T.ArrayType):
        mat, lengths, emask = _list_to_matrix(arr, dt.element_type)
        return DeviceColumn(
            dt, _to_device(mat, device), validity,
            _to_device(lengths, device),
            None if emask is None else _to_device(emask, device))
    if isinstance(dt, T.DecimalType):
        data = (decimal_to_hilo(arr) if is128(dt)
                else decimal_to_int64(arr))
        return DeviceColumn(dt, _to_device(data, device), validity)
    data = _primitive_values(arr, dt).astype(T.to_numpy_dtype(dt),
                                             copy=False)
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

    evalid = None
    if c.evalid is not None:
        # padding elements read as valid, as in the JAX package
        evalid = torch.ones((bucket,) + tuple(c.evalid.shape[1:]),
                            dtype=torch.bool, device=c.evalid.device)
        evalid[:n] = c.evalid
    return DeviceColumn(c.dtype, grow(c.data),
                        None if c.validity is None else grow(c.validity),
                        None if c.lengths is None else grow(c.lengths),
                        evalid)


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
    """DeviceBatch -> pyarrow.Table (compacts first).

    The ``transfer`` failure domain (``runtime/resilience.py``) wraps
    the whole pull, so that a transient injected fault retries the
    actual copy.  Exhaustion degrades to the plain path, which is this
    same blocking pull: the port's pull has no overlapped variant to
    give up (the JAX package's degrade drops its async prefetch)."""
    from spark_rapids_tpu_torch.runtime import resilience as R
    if R.active():
        def attempt():
            R.INJECTOR.on("transfer")
            return _device_to_host_impl(batch)

        return R.run_guarded("transfer", attempt, op="device_to_host",
                             degrade=lambda: _device_to_host_impl(batch))
    return _device_to_host_impl(batch)


def _device_to_host_impl(batch: DeviceBatch) -> pa.Table:
    batch = compact(batch)
    n = batch.num_rows_host()
    arrays = []
    names = []
    for f, c in zip(batch.schema.fields, batch.columns):
        names.append(f.name)
        validity = (None if c.validity is None
                    else c.validity[:n].cpu().numpy())
        if c.is_array:
            arrays.append(_matrix_to_list(
                c.data[:n].cpu().numpy(), c.lengths[:n].cpu().numpy(),
                None if c.evalid is None else c.evalid[:n].cpu().numpy(),
                validity, f.dtype))
            continue
        if c.is_string:
            arrays.append(_matrix_to_string(
                c.data[:n].cpu().numpy(), c.lengths[:n].cpu().numpy(),
                validity, isinstance(f.dtype, T.BinaryType)))
            continue
        data = c.data[:n].cpu().numpy()
        if isinstance(f.dtype, T.DecimalType):
            arrays.append(decimal_array(f.dtype, data, validity))
            continue
        arr = _primitive_array(data, f.dtype, None)
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
