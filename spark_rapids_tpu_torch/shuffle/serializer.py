"""tudo shuffle serialization — the native writer's binding and the
zero-copy reader.

[REF: spark-rapids-jni :: kudo/KudoSerializer, sql-plugin ::
 GpuColumnarBatchSerializer.scala :: SerializedTableColumn]

The counterpart of the JAX package's ``shuffle/serializer.py``, with the
same wire format.  The write side is native C++ (``native/tudo.cpp``):
rows bucket by partition id, then each partition gather-serializes into
one contiguous buffer (threaded over partitions), or with one thread a
streaming scatter writes every partition in one pass.  Every column
section is a contiguous dtype run, so the read side is numpy
``frombuffer`` views — no native code and no copy until the device pad.

``_py_serialize_partitions`` is the plain numpy version, byte for byte
the same; no path uses it (a failed native build raises), the tests
hold the two against each other and against the JAX package's.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as T

_MAGIC = 0x30445554  # "TUD0"


class HostColView:
    """One column of a host-side batch, C-layout, ready to serialize.

    ``data``: fixed width -> 1-D array; string -> 2-D uint8 matrix;
    decimal128 -> int64[n, 2] (hi, lo).
    """

    __slots__ = ("dtype", "data", "validity", "lengths")

    def __init__(self, dtype: T.DataType, data: np.ndarray,
                 validity: Optional[np.ndarray],
                 lengths: Optional[np.ndarray]):
        if isinstance(dtype, T.ArrayType):
            # the wire format has string and fixed-width sections only
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: a {dtype.simple_name} column "
                "cannot cross the host shuffle (tudo has no list section)")
        self.dtype = dtype
        self.data = np.ascontiguousarray(data)
        self.validity = (None if validity is None
                         else np.ascontiguousarray(
                             validity.astype(np.uint8, copy=False)))
        self.lengths = (None if lengths is None
                        else np.ascontiguousarray(
                            lengths.astype(np.int32, copy=False)))

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, (T.StringType, T.BinaryType))


class _ColDesc(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("validity", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p),
                ("kind", ctypes.c_int32),
                ("itemsize", ctypes.c_int32)]


_lib = None


def _tudo_lib():
    """The native library, built at first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        from spark_rapids_tpu_torch.native import load_library
        lib = load_library("tudo")
        lib.tudo_bucket_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.tudo_partition_sizes.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ColDesc), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.tudo_partition_write.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ColDesc), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32]
        lib.tudo_scatter_sizes.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ColDesc), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tudo_scatter_write.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ColDesc), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _kind_itemsize(c: HostColView) -> Tuple[int, int]:
    """(0 fixed | 1 string, bytes per row | matrix width)."""
    if c.is_string:
        return 1, int(c.data.shape[1]) if c.data.ndim == 2 else 1
    return 0, int(c.data.dtype.itemsize) * (
        int(c.data.shape[1]) if c.data.ndim == 2 else 1)


def _descs(cols: Sequence[HostColView]):
    arr = (_ColDesc * len(cols))()
    for i, c in enumerate(cols):
        kind, isz = _kind_itemsize(c)
        arr[i] = _ColDesc(
            c.data.ctypes.data, None if c.validity is None
            else c.validity.ctypes.data,
            None if c.lengths is None else c.lengths.ctypes.data,
            kind, isz)
    return arr


_scratch_tls = threading.local()


def _scratch_buf(nbytes: int) -> np.ndarray:
    """Thread-local grow-only output buffer: a fresh ``np.empty`` pays a
    page fault at every first touch, so steady-state writers serialize
    into warm pages instead."""
    buf = getattr(_scratch_tls, "buf", None)
    if buf is None or buf.size < nbytes:
        buf = np.empty(max(nbytes, 1 << 20), np.uint8)
        buf[::4096] = 0  # touch the pages now
        _scratch_tls.buf = buf
    return buf


def serialize_partitions(
    cols: Sequence[HostColView], pids: np.ndarray,
    live: Optional[np.ndarray], nparts: int, nthreads: int = 4,
    scratch: bool = False,
) -> List[memoryview]:
    """Bucket rows by pid and serialize each partition: one tudo buffer
    per partition (dead rows dropped).

    ``scratch=True`` serializes into a thread-local reusable buffer: the
    returned memoryviews alias it and stay valid only until this
    thread's next scratch call (the shuffle file writer consumes them
    before it serializes the next batch)."""
    n = int(pids.shape[0])
    pids = np.ascontiguousarray(pids.astype(np.int32, copy=False))
    live8 = (None if live is None else
             np.ascontiguousarray(live.astype(np.uint8, copy=False)))
    lib = _tudo_lib()
    descs = _descs(cols)
    sizes = np.empty(nparts, np.int64)
    if min(int(nthreads), os.cpu_count() or 1) <= 1:
        # streaming scatter: sequential source reads and one write
        # cursor per partition, the faster single-threaded pass
        work = np.empty(nparts * (1 + len(cols)), np.int64)
        lib.tudo_scatter_sizes(len(cols), descs, _ptr(pids), _ptr(live8),
                               n, nparts, _ptr(sizes), _ptr(work))
        offsets = np.zeros(nparts, np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        total = int(sizes.sum())
        out = (_scratch_buf(total) if scratch
               else np.empty(total, np.uint8))
        lib.tudo_scatter_write(len(cols), descs, _ptr(pids), _ptr(live8),
                               n, nparts, _ptr(out), _ptr(offsets),
                               _ptr(work))
    else:
        idx = np.empty(n, np.int32)
        starts = np.empty(nparts + 1, np.int64)
        lib.tudo_bucket_rows(_ptr(pids), _ptr(live8), n, nparts,
                             _ptr(idx), _ptr(starts))
        lib.tudo_partition_sizes(len(cols), descs, _ptr(idx),
                                 _ptr(starts), nparts, _ptr(sizes))
        offsets = np.zeros(nparts, np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        out = np.empty(int(sizes.sum()), np.uint8)
        lib.tudo_partition_write(len(cols), descs, _ptr(idx), _ptr(starts),
                                 nparts, _ptr(out), _ptr(offsets),
                                 int(nthreads))
    mv = memoryview(out)
    return [mv[int(offsets[p]):int(offsets[p] + sizes[p])]
            for p in range(nparts)]


def _py_serialize_partitions(cols, pids, live8, nparts) -> List[memoryview]:
    """The same buffers in plain numpy."""
    keep = (np.ones(pids.shape[0], bool) if live8 is None
            else live8.astype(bool))
    out = []
    for p in range(nparts):
        idx = np.nonzero(keep & (pids == p))[0].astype(np.int32)
        out.append(memoryview(_py_serialize_one(cols, idx)))
    return out


def _py_serialize_one(cols, idx: np.ndarray) -> bytes:
    n = len(idx)
    parts = [struct.pack("<IIqI", _MAGIC, 1, n, len(cols))]
    for c in cols:
        kind, isz = _kind_itemsize(c)
        parts.append(struct.pack("<BBH", kind, 1 if c.validity is not None
                                 else 0, isz))
    for c in cols:
        if c.is_string:
            lens = c.lengths[idx]
            parts.append(lens.astype(np.int32).tobytes())
            if n:
                mat = c.data[idx]
                ii = np.repeat(np.arange(n), lens)
                jj = (np.arange(int(lens.sum()))
                      - np.repeat(np.cumsum(lens) - lens, lens))
                parts.append(mat[ii, jj].tobytes())
        else:
            parts.append(c.data[idx].tobytes())
        if c.validity is not None:
            parts.append(c.validity[idx].tobytes())
    return b"".join(parts)


def deserialize(buf, schema: T.StructType
                ) -> Tuple[int, List[HostColView]]:
    """Zero-copy numpy views over one tudo buffer -> (nrows, columns).

    String sections unpack to a padded byte matrix (vectorized)."""
    b = np.frombuffer(buf, np.uint8)
    magic, ver, nrows, ncols = struct.unpack_from("<IIqI", b, 0)
    if magic != _MAGIC or ver != 1:
        raise ValueError("bad tudo buffer")
    if ncols != len(schema.fields):
        raise ValueError(f"tudo buffer of {ncols} columns for a "
                         f"{len(schema.fields)}-field schema")
    off = 20
    metas = []
    for _ in range(ncols):
        metas.append(struct.unpack_from("<BBH", b, off))
        off += 4
    cols: List[HostColView] = []
    for f, (kind, hasv, isz) in zip(schema.fields, metas):
        if kind == 1:
            lengths = np.frombuffer(buf, np.int32, nrows, off)
            off += nrows * 4
            total = int(lengths.sum())
            packed = np.frombuffer(buf, np.uint8, total, off)
            off += total
            width = max(int(lengths.max()) if nrows else 1, 1)
            mat = np.zeros((nrows, width), np.uint8)
            if total:
                ii = np.repeat(np.arange(nrows), lengths)
                jj = (np.arange(total)
                      - np.repeat(np.cumsum(lengths) - lengths, lengths))
                mat[ii, jj] = packed
            data, lens = mat, lengths
        elif (isinstance(f.dtype, T.DecimalType)
              and f.dtype.precision > T.DecimalType.MAX_LONG_DIGITS):
            # decimal128 rides as 16-byte (hi, lo) rows
            if isz != 16:
                raise ValueError(f"column {f.name!r}: {isz}-byte rows "
                                 "for decimal128")
            data = np.frombuffer(buf, np.int64, nrows * 2,
                                 off).reshape(nrows, 2)
            off += nrows * 16
            lens = None
        else:
            npdt = np.dtype(T.to_numpy_dtype(f.dtype))
            if npdt.itemsize != isz:
                raise ValueError(f"column {f.name!r}: {isz}-byte rows "
                                 f"for {npdt}")
            data = np.frombuffer(buf, npdt, nrows, off)
            off += nrows * isz
            lens = None
        validity = None
        if hasv:
            validity = np.frombuffer(buf, np.uint8, nrows, off)
            off += nrows
        cols.append(HostColView(f.dtype, data, validity, lens))
    return nrows, cols
