"""decimal128 arithmetic on int64 tensors: a column of precision 19-38
is ``int64[B, 2]``, ``data[:, 0]`` the signed high limb and
``data[:, 1]`` the low limb's bit pattern (an int64 holding an
unsigned value).

[REF: NVIDIA/spark-rapids-jni :: src/main/cpp/src/decimal128 kernels]

The counterpart of the JAX package's ``ops/decimal128.py``, function by
function and bit for bit.  torch has no uint64 add, shift or compare, so
the JAX package's int64 formulation carries over as it is: an unsigned
compare flips the sign bit first (``_ult``), and multiplication splits
each 64-bit limb into four 32-bit halves held as non-negative int64
values, whose 32x32 products wrap mod 2^64 in int64 and give back their
true unsigned halves after an arithmetic shift and a mask.  Division
(rounding, down-scaling) is long division over the four 32-bit limbs of
the magnitude by a positive divisor below 2^31, every partial remainder
a positive int64.  Overflow wraps mod 2^128 (Spark's non-ANSI
container); the ``*_checked`` forms also say whether the exact result
fitted.

``limbs32``/``from_limb_sums`` are this port's own: the grouped and
keyless decimal128 sums add each 32-bit limb of the bit patterns with an
integer ``index_add_`` (exact in any order while a group has fewer than
2^31 rows) and propagate the carries once per group, mod 2^128 — the
same bits as the JAX package's carry-aware associative scan.

The ``np_*`` and ``py_*`` helpers are the host side's: Python ints for
the CPU path, whose decimal128 columns are object arrays of them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T

_MASK32 = 0xFFFFFFFF
_SIGN = -0x8000000000000000  # 1 << 63 as int64
_M64 = (1 << 64) - 1


def is128(dt) -> bool:
    return (isinstance(dt, T.DecimalType)
            and dt.precision > T.DecimalType.MAX_LONG_DIGITS)


def pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=-1)


def hi(d: torch.Tensor) -> torch.Tensor:
    return d[..., 0]


def lo(d: torch.Tensor) -> torch.Tensor:
    return d[..., 1]


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b over int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def from_i64(x: torch.Tensor) -> torch.Tensor:
    """Sign-extend an int64 unscaled value to (hi, lo)."""
    x = x.to(torch.int64)
    return pack(x >> 63, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo_s = lo(a) + lo(b)  # wraps mod 2^64
    carry = _ult(lo_s, lo(a)).to(torch.int64)
    return pack(hi(a) + hi(b) + carry, lo_s)


def neg(a: torch.Tensor) -> torch.Tensor:
    lo_n = -lo(a)  # two's complement of the low lane
    borrow = (lo(a) != 0).to(torch.int64)
    return pack(-hi(a) - borrow, lo_n)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, neg(b))


def is_negative(a: torch.Tensor) -> torch.Tensor:
    return hi(a) < 0


def abs128(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = is_negative(a)
    return torch.where(n[..., None], neg(a), a), n


def limbs32(a: torch.Tensor):
    """(hi, lo) -> four 32-bit limbs, most significant first, each held
    as a non-negative int64."""
    h, l = hi(a), lo(a)
    return ((h >> 32) & _MASK32, h & _MASK32,
            (l >> 32) & _MASK32, l & _MASK32)


def _from_limbs32(l3, l2, l1, l0) -> torch.Tensor:
    """Four CARRY-FREE 32-bit limbs (each < 2^32) -> (hi, lo)."""
    return pack((l3 << 32) | l2, (l1 << 32) | l0)


def from_limb_sums(s3, s2, s1, s0) -> torch.Tensor:
    """Per-limb sums (each a non-negative int64 below 2^63) -> their
    total mod 2^128 as (hi, lo): the carries propagate up once."""
    l0 = s0 & _MASK32
    s1 = s1 + (s0 >> 32)
    l1 = s1 & _MASK32
    s2 = s2 + (s1 >> 32)
    l2 = s2 & _MASK32
    s3 = s3 + (s2 >> 32)
    return _from_limbs32(s3 & _MASK32, l2, l1, l0)


def _p(x, y):
    """32x32 product as (hi32, lo32): the int64 product's bit pattern is
    exact mod 2^64 even when it wraps negative."""
    v = x * y
    return (v >> 32) & _MASK32, v & _MASK32


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^128 (wrapping schoolbook over 32-bit limbs)."""
    a3, a2, a1, a0 = limbs32(a)
    b3, b2, b1, b0 = limbs32(b)
    # column sums c_k of the partial products landing on limb k (k = 0
    # least significant); each term < 2^32, at most 8 terms: positive
    c = [torch.zeros_like(a0) for _ in range(4)]
    for i, ai in enumerate((a3, a2, a1, a0)):
        for j, bj in enumerate((b3, b2, b1, b0)):
            k = (3 - i) + (3 - j)  # limb index of the low half
            if k > 3:
                continue
            ph, pl = _p(ai, bj)
            c[k] = c[k] + pl
            if k < 3:
                c[k + 1] = c[k + 1] + ph
    return from_limb_sums(c[3], c[2], c[1], c[0])


def mul_small(a: torch.Tensor, m: int) -> torch.Tensor:
    """a * m mod 2^128 for a non-negative python int m < 2^31."""
    a3, a2, a1, a0 = limbs32(a)
    p0 = a0 * m
    p1 = a1 * m
    p2 = a2 * m
    p3 = a3 * m
    l0 = p0 & _MASK32
    p1 = p1 + ((p0 >> 32) & _MASK32)
    l1 = p1 & _MASK32
    p2 = p2 + ((p1 >> 32) & _MASK32)
    l2 = p2 & _MASK32
    p3 = p3 + ((p2 >> 32) & _MASK32)
    l3 = p3 & _MASK32
    return _from_limbs32(l3, l2, l1, l0)


def scale_up(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * 10^k mod 2^128 — factored into < 2^31 multipliers."""
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def scale_up_checked(a: torch.Tensor, k: int, precision: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a * 10^k, ok) where ok <=> |a * 10^k| < 10^precision, decided
    BEFORE the multiply (|a| < 10^(precision-k)), so that a wrap mod
    2^128 can never land back inside the valid range."""
    assert k >= 0
    rem = precision - k
    if rem <= 0:
        ok = cmp_eq(a, torch.zeros_like(a))
    else:
        ok = fits_precision(a, rem)
    return scale_up(a, k), ok


def divmod_small(a: torch.Tensor, d: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a // d, a % d) for a non-negative a and a positive python int
    d < 2^31: long division over the 32-bit limbs."""
    r = torch.zeros_like(a[..., 0])
    q = []
    for l in limbs32(a):
        cur = (r << 32) | l  # < 2^63: r < d < 2^31
        q.append(torch.div(cur, d, rounding_mode="floor"))
        r = torch.remainder(cur, d)
    return _from_limbs32(*q), r


def div_small_round(a: torch.Tensor, d: int) -> torch.Tensor:
    """a / d with HALF_UP rounding away from zero (Spark's decimal
    divide and average rounding); d a positive python int < 2^31."""
    mag, sign = abs128(a)
    q, r = divmod_small(mag, d)
    round_up = (r * 2 >= d).to(torch.int64)
    q = add(q, pack(torch.zeros_like(round_up), round_up))
    return torch.where(sign[..., None], neg(q), q)


def scale_down_round(a: torch.Tensor, k: int) -> torch.Tensor:
    """a / 10^k with HALF_UP rounding, for k <= 9 (the divisor stays
    below 2^31 so that the one rounding division is exact)."""
    if k == 0:
        return a
    assert k <= 9, "scale-down beyond 10^9 is tagged out"
    return div_small_round(a, 10 ** k)


def cmp_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) < hi(b)) | ((hi(a) == hi(b)) & _ult(lo(a), lo(b)))


def cmp_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (hi(a) == hi(b)) & (lo(a) == lo(b))


def to_double(a: torch.Tensor, scale: int) -> torch.Tensor:
    """Approximate double value (hi * 2^64 + unsigned lo) / 10^scale."""
    l = lo(a)
    lo_u = (l & ~_SIGN).to(torch.float64) + torch.where(
        l < 0, 2.0 ** 63, 0.0).to(torch.float64)
    v = hi(a).to(torch.float64) * (2.0 ** 64) + lo_u
    return v / (10.0 ** scale)


def add_checked(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a + b, ok): ok False on signed-128 overflow (same-sign operands
    giving the opposite sign)."""
    s = add(a, b)
    sa, sb, sr = is_negative(a), is_negative(b), is_negative(s)
    return s, ~((sa == sb) & (sr != sa))


def sub_checked(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return add_checked(a, neg(b))


def mul_checked(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a * b, ok): schoolbook over the MAGNITUDES with explicit overflow
    detection (dropped high columns, a final carry, or a magnitude
    taking the sign bit), so that results beyond 2^127 cannot wrap back
    into the valid range."""
    ma, sa = abs128(a)
    mb, sb = abs128(b)
    a3, a2, a1, a0 = limbs32(ma)
    b3, b2, b1, b0 = limbs32(mb)
    c = [torch.zeros_like(a0) for _ in range(4)]
    ovf = torch.zeros(a0.shape, dtype=torch.bool, device=a0.device)
    for i, ai in enumerate((a3, a2, a1, a0)):
        for j, bj in enumerate((b3, b2, b1, b0)):
            k = (3 - i) + (3 - j)
            ph, pl = _p(ai, bj)
            if k > 3:
                ovf = ovf | (pl != 0) | (ph != 0)
                continue
            c[k] = c[k] + pl
            if k < 3:
                c[k + 1] = c[k + 1] + ph
            else:
                ovf = ovf | (ph != 0)
    c0, c1, c2, c3 = c
    l0 = c0 & _MASK32
    c1 = c1 + (c0 >> 32)
    l1 = c1 & _MASK32
    c2 = c2 + (c1 >> 32)
    l2 = c2 & _MASK32
    c3 = c3 + (c2 >> 32)
    l3 = c3 & _MASK32
    ovf = ovf | ((c3 >> 32) != 0)
    mag = _from_limbs32(l3, l2, l1, l0)
    ovf = ovf | is_negative(mag)  # the magnitude took the sign bit
    sign = sa ^ sb
    return torch.where(sign[..., None], neg(mag), mag), ~ovf


def fits_precision(a: torch.Tensor, precision: int) -> torch.Tensor:
    """|a| < 10^precision: Spark nulls a decimal result that overflows
    its declared precision (non-ANSI)."""
    from spark_rapids_tpu_torch.runtime.device import device_constant
    bound = device_constant(
        ("decimal128.bound", precision), a.device,
        lambda: torch.from_numpy(np_pack([10 ** precision])[0]))
    mag, _ = abs128(a)
    return cmp_lt(mag, bound.expand_as(mag))


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def np_pack(values) -> np.ndarray:
    """Host iterable of python ints -> int64[n, 2] (hi, lo)."""
    out = np.zeros((len(values), 2), dtype=np.int64)
    for i, v in enumerate(values):
        v = int(v)
        out[i, 0] = v >> 64  # arithmetic shift keeps the sign
        l = v & _M64
        out[i, 1] = l - (1 << 64) if l >= (1 << 63) else l
    return out


def np_unpack(data: np.ndarray) -> np.ndarray:
    """int64[n, 2] -> host object array of python ints."""
    out = np.empty(data.shape[0], dtype=object)
    for i in range(data.shape[0]):
        out[i] = (int(data[i, 0]) << 64) | (int(data[i, 1]) & _M64)
    return out


def py_wrap128(v: int) -> int:
    """The device container's wrap of a python int: mod 2^128, signed."""
    w = int(v) % (1 << 128)
    return w - (1 << 128) if w >= (1 << 127) else w


def py_fits(v: int, precision: int) -> bool:
    return abs(int(v)) < 10 ** precision


def py_rescale_half_up(v: int, k: int) -> int:
    """Exact python-int rescale by 10^k (HALF_UP away from zero for a
    negative k), free of ``decimal`` context rounding."""
    v = int(v)
    if k >= 0:
        return v * (10 ** k)
    d = 10 ** (-k)
    q, r = divmod(abs(v), d)
    q += 1 if 2 * r >= d else 0
    return -q if v < 0 else q


def py_unscaled(dec, scale: int) -> int:
    """Exact unscaled int of a ``decimal.Decimal`` at ``scale``."""
    sign, digits, exp = dec.as_tuple()
    mag = int("".join(map(str, digits)) or "0")
    v = -mag if sign else mag
    return py_rescale_half_up(v, exp + scale)
