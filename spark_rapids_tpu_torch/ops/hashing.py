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
of those names, bit for bit.  The xxhash64 family and the
``Murmur3Hash`` expression belong to the exchange slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtypes as T

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
        h_i32 = torch.where(h >= 1 << 31, h - (1 << 32), h)
        return partition_ids_from_hash(h_i32, nparts)

    return pids
