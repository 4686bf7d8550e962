"""Orderable-key encoding: any column -> 64-bit key limbs whose unsigned
lexicographic order equals the SQL ordering.

The counterpart of the JAX package's ``ops/ordering.py``, limb for limb:

* signed ints: flip the sign bit -> unsigned order == signed order
* float32: IEEE trick (negative -> ~bits, else bits | sign)
* float64: a RAW float64 limb, as in the JAX package (whose TPU target
  could not bitcast 64-bit values); kept so grouping and sort limbs
  equal the reference's
* strings: big-endian packing of the padded byte matrix into 64-bit
  limbs plus a 32-bit length part
* decimals: the unscaled int64 as a signed int; decimal128 ``[B, 2]``
  as its signed hi limb, then its lo limb's unsigned bits
* nulls: an extra leading 1-bit part

Unsigned values are carried as int64 BIT PATTERNS (torch has no usable
uint64): a limb here holds exactly the bits of the JAX package's uint64
limb.  Every right shift is masked, and ``sortable`` flips the top bit
before any sort or ``<`` so that signed order equals unsigned order.

``np_order_keys`` is the JAX package's host twin (numpy uint64 limbs
for ``np.lexsort``), which the CPU sort uses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

TOP_BIT = -(1 << 63)  # int64 with only bit 63 set


def sortable(limb: torch.Tensor) -> torch.Tensor:
    """A limb in a form whose torch (signed) order is the unsigned order
    of its bits; raw float64 limbs sort as they are."""
    if limb.dtype == torch.int64:
        return limb ^ TOP_BIT
    return limb


def _low_mask(bits: int) -> int:
    """Python int with the low ``bits`` bits set, as a signed int64."""
    m = (1 << bits) - 1
    return m - (1 << 64) if m >= (1 << 63) else m


def _i_to_u64(x: torch.Tensor) -> torch.Tensor:
    """Signed int (any width) -> order-preserving u64 bits."""
    return x.to(torch.int64) ^ TOP_BIT


# A key "part" is (tensor, bits): an order-preserving unsigned value held
# in the low ``bits`` bits of an int64 tensor — or (tensor, "f64") for a
# raw float64 limb.  ``fuse_parts`` packs consecutive parts into as few
# 64-bit limbs as possible.
Part = Tuple[torch.Tensor, object]


def _int_part(x: torch.Tensor, width: int, ascending: bool) -> Part:
    if width == 64:
        u = _i_to_u64(x)
        return ((~u if not ascending else u), 64)
    u = x.to(torch.int64) + (1 << (width - 1))
    if not ascending:
        u = u ^ ((1 << width) - 1)
    return (u, width)


def _flag_part(flag_is_one: torch.Tensor) -> Part:
    return (flag_is_one.to(torch.int64), 1)


def _f32_orderable_u32(x: torch.Tensor, normalize_zero: bool) -> torch.Tensor:
    canon = torch.where(torch.isnan(x), float("nan"), x)
    if normalize_zero:
        canon = torch.where(canon == 0.0, 0.0, canon)
    bits = canon.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    neg = (bits >> 31) != 0
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | (1 << 31))


def fuse_parts(parts: List[Part]) -> List[torch.Tensor]:
    """Pack consecutive uint parts into shared 64-bit limbs (big-endian:
    earlier = more significant), flushing around raw-float parts."""
    limbs: List[torch.Tensor] = []
    acc = None
    used = 0
    for arr, bits in parts:
        if bits == "f64":
            if acc is not None:
                limbs.append(acc)
                acc, used = None, 0
            limbs.append(arr)
            continue
        if acc is None:
            acc, used = arr, bits
        elif used + bits <= 64:
            # shifting into bit 63 wraps as unsigned bits do
            acc = (acc << bits) | arr
            used += bits
        else:
            limbs.append(acc)
            acc, used = arr, bits
    if acc is not None:
        limbs.append(acc)
    return limbs


def _string_parts(data: torch.Tensor, lengths: torch.Tensor) -> List[Part]:
    """uint8[B,W] + len -> big-endian packed byte parts + a length part.

    Bytes beyond each row's length are zeroed so padding cannot corrupt
    comparisons; the trailing length part disambiguates real NUL bytes
    ('a' vs 'a\\0').  The final byte chunk carries its true bit width.
    """
    b, w = data.shape
    colidx = torch.arange(w, device=data.device)
    masked = torch.where(colidx[None, :] < lengths[:, None].to(torch.int64),
                         data, 0).to(torch.int64)
    parts: List[Part] = []
    for i in range(0, w, 8):
        chunk = masked[:, i:i + 8]
        nbytes = chunk.shape[1]
        limb = torch.zeros((b,), dtype=torch.int64, device=data.device)
        for j in range(nbytes):
            limb = (limb << 8) | chunk[:, j]
        parts.append((limb, 8 * nbytes))
    parts.append((lengths.to(torch.int64), 32))
    return parts


_INT_WIDTH = {T.ByteType: 8, T.ShortType: 16, T.IntegerType: 32,
              T.DateType: 32, T.LongType: 64, T.TimestampType: 64}


def column_order_parts(col: DeviceColumn, ascending: bool = True,
                       nulls_first: bool = True,
                       distinguish_neg_zero: bool = True) -> List[Part]:
    """Encode one column as key parts (most-significant first)."""
    dt = col.dtype
    parts: List[Part]
    if isinstance(dt, (T.StringType, T.BinaryType)):
        parts = _string_parts(col.data, col.lengths)
        if not ascending:
            parts = [(a ^ _low_mask(b), b) for a, b in parts]
    elif isinstance(dt, T.FloatType):
        u = _f32_orderable_u32(col.data,
                               normalize_zero=not distinguish_neg_zero)
        if not ascending:
            u = (~u) & 0xFFFFFFFF
        parts = [(u, 32)]
    elif isinstance(dt, T.DoubleType):
        # NaN placement rides its own part (Spark: NaN greatest)
        isn = torch.isnan(col.data)
        nan_part = _flag_part(isn if ascending else ~isn)
        val = torch.where(isn, 0.0, col.data)
        parts = [nan_part, (val if ascending else -val, "f64")]
        if distinguish_neg_zero:
            # a sort treats -0.0 == 0.0; Spark orders -0.0 < 0.0.  The
            # sign is detected via 1/x, as the reference does.
            neg_zero = (col.data == 0.0) & ((1.0 / col.data) < 0.0)
            parts.append(_flag_part(~neg_zero if ascending else neg_zero))
    elif isinstance(dt, T.BooleanType):
        parts = [(col.data.to(torch.int64)
                  if ascending else (~col.data).to(torch.int64), 1)]
    elif type(dt) in _INT_WIDTH:
        parts = [_int_part(col.data, _INT_WIDTH[type(dt)], ascending)]
    elif isinstance(dt, T.DecimalType) and col.data.dim() == 2:
        # decimal128 [B, 2]: the signed-biased hi limb, then the lo
        # limb's raw (unsigned-ordered) bit pattern
        lu = col.data[:, 1].contiguous()  # limbs are whole tensors
        parts = [_int_part(col.data[:, 0], 64, ascending),
                 (lu if ascending else ~lu, 64)]
    elif isinstance(dt, T.DecimalType):
        parts = [_int_part(col.data, 64, ascending)]
    else:
        raise NotImplementedError(
            f"spark_rapids_tpu_torch: ordering of {dt} is not ported yet")
    # null part: orders independently of direction: nulls_first => nulls 0
    if col.validity is not None:
        np_ = _flag_part(col.validity if nulls_first else ~col.validity)
        # also zero data parts of nulls for deterministic grouping
        parts = [(torch.where(col.validity, a, torch.zeros(
            (), dtype=a.dtype, device=a.device)), b) for a, b in parts]
        parts = [np_] + parts
    return parts


def limb_neq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inequality under the grouping equivalence: NaN == NaN (one group),
    and IEEE -0.0 == 0.0."""
    if a.dtype.is_floating_point:
        return (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    return a != b


def batch_group_parts(cols: List[DeviceColumn]) -> List[Part]:
    """Key parts for GROUP BY (direction irrelevant; nulls one group;
    -0.0 and 0.0 one group — Spark normalizes float grouping keys)."""
    out: List[Part] = []
    for c in cols:
        out.extend(column_order_parts(c, True, True,
                                      distinguish_neg_zero=False))
    return out


# above this many fused limbs, group sorts switch to the 128-bit
# key-tuple hash (the JAX package's threshold, kept so the limbs match)
GROUP_HASH_LIMB_CAP = 3


def group_sort_limbs(cols: List[DeviceColumn], sel: torch.Tensor,
                     tail_parts: Sequence[Part] = ()
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(sort limbs, key-only limbs) for GROUP BY segmentation.

    Narrow key tuples keep the exact lexicographic encoding, with any
    ``tail_parts`` (a contribution flag, a value's order: the holistic
    aggregates') fused into the same limb set's spare bits.  Wide tuples
    (more than ``GROUP_HASH_LIMB_CAP`` fused limbs — TPC-H q1's two
    string keys already are: 1 + 64 + 32 + 64 + 32 bits in five limbs)
    sort by a 128-bit hash of the normalized key tuple instead, four
    murmur3 passes with independent seeds, exactly as the JAX package
    does.  Group boundaries come from the returned key limbs: the tail
    parts must not split groups.
    """
    from spark_rapids_tpu_torch.ops import hashing as HH
    key_parts = [_flag_part(~sel)] + batch_group_parts(cols)
    exact = fuse_parts(key_parts)
    if len(exact) <= GROUP_HASH_LIMB_CAP:
        if not tail_parts:
            return exact, exact
        return fuse_parts(key_parts + list(tail_parts)), exact
    n = int(sel.shape[0])

    def tuple_hash(seed: int) -> torch.Tensor:
        h = torch.full((n,), seed, dtype=torch.int64, device=sel.device)
        for c in cols:
            dt = c.dtype
            data = c.data
            valid = c.valid_mask()
            # the per-column null flag always mixes in: (null, x) and
            # (x, null) must not hash alike on every seed
            h = HH._mix_h1(h, HH._mix_k1(valid.to(torch.int64)))
            if isinstance(dt, T.DoubleType):
                h = torch.where(valid, HH.hash_f64_tpu_safe(data, h), h)
                continue
            if isinstance(dt, T.FloatType):
                data = torch.where(data == 0.0, 0.0, data)
            h = HH.hash_column((data, c.lengths), dt, h, valid)
        return h

    h = [tuple_hash(s) for s in (42, 0x5F3759DF, 0x9E3779B9, 0x85EBCA6B)]
    h64a = (h[0] << 32) | h[1]
    h64b = (h[2] << 32) | h[3]
    key_limbs = fuse_parts([_flag_part(~sel), (h64a, 64), (h64b, 64)])
    if not tail_parts:
        return key_limbs, key_limbs
    return key_limbs + fuse_parts(list(tail_parts)), key_limbs


def sort_by_keys(limbs: List[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable lexicographic sort; returns (sorted limbs, permutation).

    ``jax.lax.sort(num_keys=L+1)`` with a trailing iota has no torch
    counterpart, so stable sorts are chained from the last limb to the
    first, each applied to the permutation so far: the result is the
    lexicographic order with ties broken by original row index — the
    same permutation, bit for bit.
    """
    n = limbs[0].shape[0]
    perm = torch.arange(n, device=limbs[0].device)
    for l in reversed(limbs):
        idx = torch.argsort(sortable(l[perm]), stable=True)
        perm = perm[idx]
    return [l[perm] for l in limbs], perm


# ----------------------------------------------------------------------------
# Host (numpy oracle) twin
# ----------------------------------------------------------------------------

def np_order_keys(data: np.ndarray, validity: Optional[np.ndarray],
                  dt: T.DataType, ascending: bool = True,
                  nulls_first: bool = True) -> List[np.ndarray]:
    """uint64 limbs of a host column whose lexicographic order is the SQL
    order (the JAX package's ``np_order_keys``)."""
    if isinstance(dt, (T.StringType, T.BinaryType)):
        # host strings are object arrays — map to sortable tuples via bytes
        enc = np.array([
            v.encode() if isinstance(v, str) else bytes(v) for v in data
        ], dtype=object)
        mx = max((len(v) for v in enc), default=0)
        limbs = []
        padded = np.zeros((len(enc), mx + 1), dtype=np.uint8)
        for i, v in enumerate(enc):
            padded[i, :len(v)] = np.frombuffer(v, np.uint8)
        wpad = (-(mx + 1)) % 8
        padded = np.pad(padded, ((0, 0), (0, wpad)))
        for i in range(padded.shape[1] // 8):
            limb = np.zeros(len(enc), np.uint64)
            for j in range(8):
                limb = (limb << np.uint64(8)) | padded[:, i * 8 + j].astype(
                    np.uint64)
            limbs.append(limb)
        limbs.append(np.array([len(v) for v in enc], np.uint64))
    elif isinstance(dt, T.FloatType):
        canon = np.where(np.isnan(data), np.float32(np.nan),
                         data.astype(np.float32))
        bits = canon.view(np.uint32)
        neg = (bits >> np.uint32(31)) != 0
        limbs = [np.where(neg, ~bits, bits | np.uint32(1 << 31)).astype(
            np.uint64)]
    elif isinstance(dt, T.DoubleType):
        canon = np.where(np.isnan(data), np.nan, data.astype(np.float64))
        bits = canon.view(np.uint64)
        neg = (bits >> np.uint64(63)) != 0
        limbs = [np.where(neg, ~bits, bits | np.uint64(1 << 63))]
    elif isinstance(dt, T.BooleanType):
        limbs = [data.astype(np.uint64)]
    elif isinstance(dt, T.DecimalType) and data.dtype == object:
        # decimal128 host values are python ints: a biased hi, then lo
        hi = np.array([int(v) >> 64 for v in data], dtype=np.int64)
        lo = np.array([int(v) & 0xFFFFFFFFFFFFFFFF for v in data],
                      dtype=np.uint64)
        limbs = [hi.view(np.uint64) ^ np.uint64(1 << 63), lo]
    else:
        limbs = [(data.astype(np.int64).view(np.uint64))
                 ^ np.uint64(1 << 63)]
    if not ascending:
        limbs = [~l for l in limbs]
    if validity is not None:
        nl = np.where(validity, np.uint64(1 if nulls_first else 0),
                      np.uint64(0 if nulls_first else 1))
        limbs = [np.where(validity, l, np.uint64(0)) for l in limbs]
        limbs = [nl] + limbs
    return limbs
