"""Spark murmur3 column hashing in 32-bit lanes — the grouped
aggregate's wide-key tuple hash (``ops/ordering.py::group_sort_limbs``
past ``GROUP_HASH_LIMB_CAP``) and the partition id of a key tuple that
the join's hash sub-partitioning splits by (``make_pid_fn``).

[REF: spark-rapids-jni :: src/main/cpp/src/murmur_hash.cu]

A counterpart of the vectorized half of the JAX package's
``ops/hashing.py`` (``_mix_k1``, ``_mix_h1``, ``_fmix``,
``hash_column``) plus ``parallel/shuffle.py::_hash_f64_tpu_safe``, bit
for bit.  torch has no uint32 add or shift, so every u32 value is held
in an int64 tensor in [0, 2^32) and every step is masked; a 32x32-bit
multiply is split into 16-bit halves so that no int64 product
overflows.  ``partition_ids_from_hash`` and ``make_pid_fn`` are the
JAX package's ``ops/hashing.py`` and ``parallel/shuffle.py`` functions
of those names, bit for bit.  The exchanges' partition ids (``exec/
exchange.py``, ``shuffle/exchange.py``) are ``hash_column`` over the
key tuple from seed 42, ``int32_from_u32`` and ``partition_ids_from_
hash``: on the device, and on the host over torch CPU tensors of the
numpy columns (``host_hash_input``: strings padded by
``host_strings_to_matrix``, decimal128 packed to (hi, lo)), as the JAX
package's numpy path, bit for bit.  A decimal of up to 18 digits hashes
as its unscaled long; a decimal128 mixes its lo then its hi lane (the
JAX package's internal-consistency hash, not Spark's byte-array one).

The ``Murmur3Hash`` expression (Spark's ``hash``) mixes its columns
through ``hash_column`` from seed 42.  Spark's second family, xxhash64
(``xxh_*_py``, ``_xxh_{int,long,string}_vec``, ``xxhash_column``,
``XxHash64``; [REF: spark-rapids-jni :: xxhash64.cu]), keeps the same
column protocol in 64-bit lanes: each u64 value is the bit pattern of
an int64 tensor (torch lacks uint64 shifts and compares), products and
sums wrap mod 2^64 as int64 arithmetic does, constants past 2^63 are
given as their signed values, and every right shift masks the bits the
sign extended.  The string loop is plain PyTorch over the padded byte
matrix, every row walking the same W-wide loop with inactive positions
keeping their state.  Both expressions evaluate their host branch over
torch CPU tensors of the host columns, with the device branch's code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.host import HostCol
from spark_rapids_tpu_torch.ops import decimal128 as D128
from spark_rapids_tpu_torch.ops import expressions as E

C1 = 0xCC9E2D51
C2 = 0x1B873593
SEED = 42

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for u32 values ``x`` held in int64.

    ``x * c`` itself can reach 2^64 and overflow int64, so the constant
    is split into 16-bit halves: ``x*c = x*lo + (x*hi) << 16`` and only
    the low 16 bits of ``x*hi`` survive the shift mod 2^32.  Both
    partial products stay below 2^48.
    """
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> its low 32 bits as a non-negative int64."""
    return x.to(torch.int64) & M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_k1(k1):
    k1 = mul32(k1, C1)
    k1 = _rotl(k1, 15)
    return mul32(k1, C2)


def _mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl(h1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def _fmix(h1, length):
    """``length`` is a python int or a per-row tensor (string lengths)."""
    if isinstance(length, torch.Tensor):
        length = u32(length)
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = mul32(h1, 0xC2B2AE35)
    h1 = h1 ^ (h1 >> 16)
    return h1


def _hash_int_vec(vals_u32, seed_u32):
    return _fmix(_mix_h1(seed_u32, _mix_k1(vals_u32)), 4)


def _hash_long_vec(vals_i64, seed_u32):
    low = vals_i64 & M32
    high = (vals_i64 >> 32) & M32
    h1 = _mix_h1(seed_u32, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8)


def _hash_string_vec(mat, lengths, seed_u32):
    """mat: uint8[B, W]; per-row Spark hashUnsafeBytes."""
    b, w = mat.shape
    h1 = seed_u32
    m32 = mat.to(torch.int64)
    lengths = lengths.to(torch.int64)
    aligned = lengths - lengths % 4
    for blk in range(0, w - w % 4, 4):
        k = (m32[:, blk] | (m32[:, blk + 1] << 8)
             | (m32[:, blk + 2] << 16) | (m32[:, blk + 3] << 24))
        mixed = _mix_h1(h1, _mix_k1(k))
        h1 = torch.where(blk < aligned, mixed, h1)
    # tail bytes: sign-extended single-byte blocks
    for pos in range(w):
        active = (pos >= aligned) & (pos < lengths)
        byte = m32[:, pos]
        signed = torch.where(byte >= 128, byte | 0xFFFFFF00, byte)
        mixed = _mix_h1(h1, _mix_k1(signed))
        h1 = torch.where(active, mixed, h1)
    return _fmix(h1, lengths)


def _canon_float_bits(data):
    f32 = data.to(torch.float32)
    bits = u32(f32.view(torch.int32))
    return torch.where(torch.isnan(f32), 0x7FC00000, bits)


def _canon_double_bits(data):
    f64 = data.to(torch.float64)
    nanbits = 0x7FF8000000000000
    return torch.where(torch.isnan(f64), nanbits, f64.view(torch.int64))


def hash_column(col, dt: T.DataType, h, valid):
    """Mix one column (``(data, lengths)``) into the running u32 hash
    ``h``; rows where ``~valid`` keep ``h``."""
    data, lengths = col
    if isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType, T.DateType,
                       T.BooleanType)):
        nh = _hash_int_vec(u32(data.to(torch.int32)), h)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        nh = _hash_long_vec(data.to(torch.int64), h)
    elif isinstance(dt, T.FloatType):
        nh = _hash_int_vec(_canon_float_bits(data), h)
    elif isinstance(dt, T.DoubleType):
        nh = _hash_long_vec(_canon_double_bits(data), h)
    elif isinstance(dt, (T.StringType, T.BinaryType)):
        nh = _hash_string_vec(data, lengths, h)
    elif isinstance(dt, T.DecimalType) and data.dim() == 2:
        # decimal128 (hi, lo): both lanes mix, lo first (the JAX
        # package's internal-consistency hash, not Spark's byte-array
        # hash of a wide decimal)
        nh = _hash_long_vec(data[:, 1], h)
        nh = _hash_long_vec(data[:, 0], nh)
    elif isinstance(dt, T.DecimalType):
        nh = _hash_long_vec(data.to(torch.int64), h)  # the unscaled long
    else:
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: hash of {dt} is not ported yet")
    return torch.where(valid, nh, h)


def hash_f64_tpu_safe(data: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Mix a float64 column into the running hash the way the JAX
    package does on the TPU, where no 64-bit bitcast compiles: the value
    (NaN -> one NaN, -0.0 -> 0.0) is split into float32 hi/lo parts
    whose bit patterns feed the murmur3 long mix.  Kept so that group
    keys hash exactly as in the reference."""
    isn = torch.isnan(data)
    x = torch.where(isn, 0.0, data)
    x = torch.where(x == 0.0, 0.0, x)
    hi = x.to(torch.float32)
    lo = (x - hi.to(data.dtype)).to(torch.float32)
    hi_b = torch.where(isn, 0x7FC00000, u32(hi.view(torch.int32)))
    lo_b = torch.where(isn, 0, u32(lo.view(torch.int32)))
    h1 = _mix_h1(h, _mix_k1(lo_b))
    h1 = _mix_h1(h1, _mix_k1(hi_b))
    return _fmix(h1, 8)


def int32_from_u32(h: torch.Tensor) -> torch.Tensor:
    """A u32 hash held in int64 -> its signed 32-bit value (still
    int64): the JAX package's bitcast of the uint32 hash to int32."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h)


def host_strings_to_matrix(data) -> tuple:
    """Host object-array of str/bytes -> (uint8[B, W] matrix, int32
    lengths), W the longest value's byte length (at least 1): the
    padding helper of the host hash and shuffle paths."""
    enc = [v.encode() if isinstance(v, str) else bytes(v) for v in data]
    w = max(max((len(v) for v in enc), default=1), 1)
    mat = np.zeros((len(enc), w), np.uint8)
    lengths = np.zeros(len(enc), np.int32)
    for i, v in enumerate(enc):
        mat[i, :len(v)] = np.frombuffer(v, np.uint8)
        lengths[i] = len(v)
    return mat, lengths


def partition_ids_from_hash(h_i32: torch.Tensor,
                            num_partitions: int) -> torch.Tensor:
    """Spark's ``pmod(hash, n)``: the non-negative partition id (int32)
    of each signed 32-bit hash."""
    r = torch.remainder(h_i32.to(torch.int64), num_partitions)
    return r.to(torch.int32)


def make_pid_fn(keys: Sequence, nparts: int,
                canon_int64: Sequence[bool] = (),
                seed: Optional[int] = None):
    """batch -> int32 partition ids by Spark's murmur3 of the key tuple.

    ``seed`` overrides the Spark shuffle seed (42): the join's hash
    sub-partitioning re-hashes with a different seed per depth.
    ``canon_int64[i]`` widens key i to int64 before hashing (the two
    sides of a join whose int keys differ in width must agree on every
    id).  Float keys are normalized first (-0.0 -> 0.0, one NaN): equal
    keys must land in one partition."""
    canon = tuple(canon_int64) or (False,) * len(keys)
    seed_v = SEED if seed is None else seed

    def pids(batch) -> torch.Tensor:
        h = torch.full((batch.capacity,), seed_v & M32, dtype=torch.int64,
                       device=batch.device)
        for e, widen in zip(keys, canon):
            c = e.eval(batch)
            dt, data, valid = c.dtype, c.data, c.valid_mask()
            if widen and not isinstance(dt, T.LongType):
                data, dt = data.to(torch.int64), T.LongT
            if isinstance(dt, T.DoubleType):
                h = torch.where(valid, hash_f64_tpu_safe(data, h), h)
                continue
            if isinstance(dt, T.FloatType):
                data = torch.where(data == 0.0, 0.0, data)
            h = hash_column((data, c.lengths), dt, h, valid)
        return partition_ids_from_hash(int32_from_u32(h), nparts)

    return pids


# ---------------------------------------------------------------------------
# xxhash64 [REF: spark-rapids-jni :: src/main/cpp/src/xxhash64.cu; Spark
# XXH64.java]: the murmur3 column protocol (seed chain, h0 = 42, nulls
# keep h) in 64-bit lanes
# ---------------------------------------------------------------------------

XXH_P1 = 0x9E3779B185EBCA87
XXH_P2 = 0xC2B2AE3D27D4EB4F
XXH_P3 = 0x165667B19E3779F9
XXH_P4 = 0x85EBCA77C2B2AE63
XXH_P5 = 0x27D4EB2F165667C5
M64 = 0xFFFFFFFFFFFFFFFF


def _s64(x: int) -> int:
    """A u64 value (any Python int, taken mod 2^64) as the int64 with
    its bits."""
    x &= M64
    return x - (1 << 64) if x >= 1 << 63 else x


# -- the scalar Python reference ---------------------------------------------

def _rotl64_py(x, r):
    return ((x << r) | (x >> (64 - r))) & M64


def _fmix64_py(h):
    h ^= h >> 33
    h = (h * XXH_P2) & M64
    h ^= h >> 29
    h = (h * XXH_P3) & M64
    h ^= h >> 32
    return h


def xxh_int_py(i: int, seed: int) -> int:
    h = (seed + XXH_P5 + 4) & M64
    h ^= ((i & 0xFFFFFFFF) * XXH_P1) & M64
    h = (_rotl64_py(h, 23) * XXH_P2 + XXH_P3) & M64
    return _fmix64_py(h)


def xxh_long_py(v: int, seed: int) -> int:
    h = (seed + XXH_P5 + 8) & M64
    h ^= (_rotl64_py((v * XXH_P2) & M64, 31) * XXH_P1) & M64
    h = (_rotl64_py(h, 27) * XXH_P1 + XXH_P4) & M64
    return _fmix64_py(h)


def xxh_bytes_py(data: bytes, seed: int) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        acc = [(seed + XXH_P1 + XXH_P2) & M64, (seed + XXH_P2) & M64,
               seed & M64, (seed - XXH_P1) & M64]
        while i + 32 <= n:
            for k in range(4):
                x = int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little")
                v = (acc[k] + x * XXH_P2) & M64
                acc[k] = (_rotl64_py(v, 31) * XXH_P1) & M64
            i += 32
        h = (_rotl64_py(acc[0], 1) + _rotl64_py(acc[1], 7)
             + _rotl64_py(acc[2], 12) + _rotl64_py(acc[3], 18)) & M64
        for v in acc:
            h ^= (_rotl64_py((v * XXH_P2) & M64, 31) * XXH_P1) & M64
            h = (h * XXH_P1 + XXH_P4) & M64
    else:
        h = (seed + XXH_P5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        k = int.from_bytes(data[i:i + 8], "little")
        h ^= (_rotl64_py((k * XXH_P2) & M64, 31) * XXH_P1) & M64
        h = (_rotl64_py(h, 27) * XXH_P1 + XXH_P4) & M64
        i += 8
    if i + 4 <= n:
        k = int.from_bytes(data[i:i + 4], "little")
        h ^= (k * XXH_P1) & M64
        h = (_rotl64_py(h, 23) * XXH_P2 + XXH_P3) & M64
        i += 4
    while i < n:
        h ^= (data[i] * XXH_P5) & M64
        h = (_rotl64_py(h, 11) * XXH_P1) & M64
        i += 1
    return _fmix64_py(h)


# -- vectorized over int64 bit patterns --------------------------------------

_P1, _P2, _P3, _P4, _P5 = (_s64(p) for p in (XXH_P1, XXH_P2, XXH_P3,
                                             XXH_P4, XXH_P5))


def _shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr64(h, 33)
    h = h * _P2
    h = h ^ _shr64(h, 29)
    h = h * _P3
    return h ^ _shr64(h, 32)


def _xxh_int_vec(vals_u32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h = seed + _s64(XXH_P5 + 4)
    h = h ^ (vals_u32 * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _fmix64(h)


def _xxh_long_vec(vals: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h = seed + _s64(XXH_P5 + 8)
    h = h ^ (_rotl64(vals * _P2, 31) * _P1)
    h = _rotl64(h, 27) * _P1 + _P4
    return _fmix64(h)


def _xxh_string_vec(mat: torch.Tensor, lengths: torch.Tensor,
                    seed: torch.Tensor) -> torch.Tensor:
    """Per-row Spark ``XXH64.hashUnsafeBytes`` over a uint8[B, W]
    matrix."""
    w = mat.shape[1]
    m64 = mat.to(torch.int64)
    lengths = lengths.to(torch.int64)

    def le_word(base: int, nbytes: int) -> torch.Tensor:
        k = torch.zeros_like(lengths)
        for byte in range(min(nbytes, w - base)):
            k = k | (m64[:, base + byte] << (8 * byte))
        return k

    stripes = (lengths // 32) * 32
    acc = [seed + _s64(XXH_P1 + XXH_P2), seed + _P2, seed, seed - _P1]
    for base in range(0, w - w % 32, 32):
        active = base < stripes
        for k in range(4):
            nv = _rotl64(acc[k] + le_word(base + 8 * k, 8) * _P2, 31) * _P1
            acc[k] = torch.where(active, nv, acc[k])
    h_big = (_rotl64(acc[0], 1) + _rotl64(acc[1], 7)
             + _rotl64(acc[2], 12) + _rotl64(acc[3], 18))
    for v in acc:
        h_big = h_big ^ (_rotl64(v * _P2, 31) * _P1)
        h_big = h_big * _P1 + _P4
    h = torch.where(lengths >= 32, h_big, seed + _P5) + lengths
    # trailing 8-byte words after the stripes
    rem8_end = stripes + ((lengths - stripes) // 8) * 8
    for base in range(0, w - w % 8, 8):
        active = (base >= stripes) & (base < rem8_end)
        nh = h ^ (_rotl64(le_word(base, 8) * _P2, 31) * _P1)
        nh = _rotl64(nh, 27) * _P1 + _P4
        h = torch.where(active, nh, h)
    # one 4-byte word
    rem4_end = rem8_end + ((lengths - rem8_end) // 4) * 4
    for base in range(0, w - w % 4, 4):
        active = (base >= rem8_end) & (base < rem4_end)
        nh = h ^ (le_word(base, 4) * _P1)
        nh = _rotl64(nh, 23) * _P2 + _P3
        h = torch.where(active, nh, h)
    # tail bytes
    for pos in range(w):
        active = (pos >= rem4_end) & (pos < lengths)
        nh = _rotl64(h ^ (m64[:, pos] * _P5), 11) * _P1
        h = torch.where(active, nh, h)
    return _fmix64(h)


def xxhash_column(col, dt: T.DataType, h: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Mix one column (``(data, lengths)``) into the running u64 hash
    ``h`` (int64 bits); rows where ``~valid`` keep ``h``."""
    data, lengths = col
    if isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType, T.DateType,
                       T.BooleanType)):
        nh = _xxh_int_vec(u32(data.to(torch.int32)), h)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        nh = _xxh_long_vec(data.to(torch.int64), h)
    elif isinstance(dt, T.FloatType):
        nh = _xxh_int_vec(_canon_float_bits(data), h)
    elif isinstance(dt, T.DoubleType):
        nh = _xxh_long_vec(_canon_double_bits(data), h)
    elif isinstance(dt, (T.StringType, T.BinaryType)):
        nh = _xxh_string_vec(data, lengths, h)
    elif isinstance(dt, T.DecimalType) and data.dim() == 2:
        # decimal128 (hi, lo): both lanes, lo first, as murmur3 does
        nh = _xxh_long_vec(data[:, 1], h)
        nh = _xxh_long_vec(data[:, 0], nh)
    elif isinstance(dt, T.DecimalType):
        nh = _xxh_long_vec(data.to(torch.int64), h)
    else:
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: xxhash64 of {dt} is not ported yet")
    return torch.where(valid, nh, h)


# ---------------------------------------------------------------------------
# The hash expressions: one code for both branches
# ---------------------------------------------------------------------------

def host_hash_input(c: HostCol, n: Optional[int] = None):
    """A host column as the ``((data, lengths), validity)`` tensors the
    column hashes take (strings padded by ``host_strings_to_matrix``, as
    the JAX package's host path pads them; decimal128's python ints
    packed to (hi, lo))."""
    valid = torch.from_numpy(np.ascontiguousarray(c.valid_mask(n)))
    if isinstance(c.dtype, (T.StringType, T.BinaryType)):
        mat, lengths = host_strings_to_matrix(c.data)
        return (torch.from_numpy(mat), torch.from_numpy(lengths)), valid
    if D128.is128(c.dtype):
        return (torch.from_numpy(D128.np_pack(c.data)), None), valid
    return (torch.from_numpy(np.ascontiguousarray(c.data)), None), valid


@dataclasses.dataclass
class _ColumnHash(E.Expression):
    """Every column mixes into a running per-row hash from the seed; a
    null leaves it unchanged.  Subclasses give the mix (``_mix``), the
    seed's bits (``_seed_bits``) and the result (``_out``)."""

    exprs: List[E.Expression]

    @property
    def children(self):
        return tuple(self.exprs)

    def _run(self, cols, n: int, dev) -> torch.Tensor:
        h = torch.full((n,), self._seed_bits(), dtype=torch.int64,
                       device=dev)
        for e, (col, valid) in zip(self.exprs, cols):
            h = self._mix(col, e.dtype, h, valid)
        return self._out(h)

    def eval(self, batch):
        cols = []
        for e in self.exprs:
            c = e.eval(batch)
            cols.append(((c.data, c.lengths), c.valid_mask()))
        return DeviceColumn(self.dtype,
                            self._run(cols, batch.capacity, batch.device))

    def eval_cpu(self, batch):
        cols = [host_hash_input(e.eval_cpu(batch)) for e in self.exprs]
        h = self._run(cols, batch.num_rows, torch.device("cpu"))
        return HostCol(self.dtype, h.numpy())


@dataclasses.dataclass
class Murmur3Hash(_ColumnHash):
    """Spark ``hash(cols)``: murmur3 x86_32 from seed 42 -> int."""

    seed: int = SEED
    dtype: T.DataType = dataclasses.field(default_factory=T.IntegerType)

    def _seed_bits(self) -> int:
        return self.seed & M32

    def _mix(self, col, dt, h, valid):
        return hash_column(col, dt, h, valid)

    def _out(self, h):
        return int32_from_u32(h).to(torch.int32)


@dataclasses.dataclass
class XxHash64(_ColumnHash):
    """Spark ``xxhash64(cols)``: from seed 42 -> long."""

    seed: int = SEED
    dtype: T.DataType = dataclasses.field(default_factory=T.LongType)

    def _seed_bits(self) -> int:
        return _s64(self.seed)

    def _mix(self, col, dt, h, valid):
        return xxhash_column(col, dt, h, valid)

    def _out(self, h):
        return h


# -- TypeSig declarations (the JAX package's, see expressions.py) ----------
for _cls in (Murmur3Hash, XxHash64):
    _cls.type_sig = E.SIG_INTEGRAL
    _cls.input_sig = E.SIG_ALL_SCALAR
