"""Shared primitives of the kernel plane: the 64-bit row hash, the
hash-grouped row layout, and the single-limb lower bound of the join.

The counterpart of the JAX package's ``kernels/hash_layout.py``.  Rows
are stably sorted by ONE 64-bit hash of their key limbs, and group
boundaries are recovered by comparing the full key limbs of adjacent
sorted rows.  A 64-bit collision between distinct keys in one batch is
detected exactly (any offending pair is adjacent after the hash sort)
and surfaces as ``ok = False``, so the dispatcher can take the exact
full-key sort instead.

The hash is two murmur3-finalizer lanes in uint32 arithmetic with
cross-feedback.  Here the lanes are held in int64 tensors in [0, 2^32)
with every step masked (torch has no uint32 add or shift); the CUDA
kernel ``csrc/hash_pairs.cu`` computes the same bits in native
``uint32_t``.  All 64-bit values (limbs, hashes) are int64 bit patterns.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.ops.hashing import M32, mul32

# murmur3 fmix32 constants and the two lane seeds (the JAX package's)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED_HI = 0x9E3779B9
_SEED_LO = 0x85EBCA77


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on u32 values held in int64."""
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def mix_rounds(hi: torch.Tensor, lo: torch.Tensor,
               wh: torch.Tensor, wl: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one 64-bit word (as two u32 lanes) into the running state."""
    hi = hi ^ wh
    lo = lo ^ wl
    hi = _fmix32((hi + lo + _SEED_HI) & M32)
    lo = _fmix32((lo + hi + _SEED_LO) & M32)
    return hi, lo


def limbs_hashable(limbs: List[torch.Tensor]) -> bool:
    """The hash path needs integer limbs; a raw float64 limb (DoubleType
    keys on the exact encoding) keeps the key set on the exact rung, as
    in the JAX package."""
    return all(l.dtype == torch.int64 for l in limbs)


def split_u64(limb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """64-bit limb -> (hi, lo) u32 lanes; the right shift of the signed
    bit pattern is masked."""
    return (limb >> 32) & M32, limb & M32


def hash_limbs(limbs: List[torch.Tensor],
               use_kernel: bool = False) -> torch.Tensor:
    """64-bit hash of each row's key limbs, as int64 bits.

    ``use_kernel`` routes the mixing loop through the hand-written CUDA
    kernel (kernels/cuda_backend.py; its plain version on CPU tensors),
    which reads the limbs where they lie.  The loop below is the
    bit-identical plain form.
    """
    if use_kernel:
        from spark_rapids_tpu_torch.kernels import cuda_backend as CB
        return CB.hash_pairs(limbs)
    n = limbs[0].shape[0]
    hi = torch.zeros((n,), dtype=torch.int64, device=limbs[0].device)
    lo = torch.zeros_like(hi)
    for l in limbs:
        wh, wl = split_u64(l)
        hi, lo = mix_rounds(hi, lo, wh, wl)
    return (hi << 32) | lo


def seg_scan(values: torch.Tensor, boundary: torch.Tensor,
             op: str) -> torch.Tensor:
    """Inclusive segmented scan over runs started by ``boundary``.

    ``op`` is ``"add"`` (integer values only: it is a cumulative-sum
    difference, which would cancel badly on floats) or ``"first"``
    (each row gets its run's first value).
    """
    start = _run_starts(boundary)
    if op == "first":
        return values[start]
    if op == "add":
        if values.dtype.is_floating_point:
            raise ValueError("seg_scan('add') takes integer values")
        cs = torch.cumsum(values.to(torch.int64), 0)
        before = torch.where(start > 0, cs[(start - 1).clamp(min=0)], 0)
        return (cs - before).to(values.dtype)
    raise ValueError(f"unknown seg_scan op {op!r}")


def _run_starts(boundary: torch.Tensor) -> torch.Tensor:
    """Index of each row's run start (row 0 always starts a run)."""
    n = boundary.shape[0]
    idx = torch.arange(n, device=boundary.device)
    b = boundary.clone()
    b[0] = True
    return torch.cummax(torch.where(b, idx, 0), 0).values


def run_lengths(boundary: torch.Tensor) -> torch.Tensor:
    """Per-row length of the row's run (``boundary`` marks run starts)."""
    b = boundary.clone()
    b[0] = True
    gid = torch.cumsum(b.to(torch.int64), 0) - 1
    sizes = torch.zeros_like(gid).index_add_(0, gid, torch.ones_like(gid))
    return sizes[gid].to(torch.int32)


def _adjacent_neq(limbs: List[torch.Tensor]) -> torch.Tensor:
    """row i differs from row i-1 in any limb (row 0 -> False)."""
    n = limbs[0].shape[0]
    neq = torch.zeros((n,), dtype=torch.bool, device=limbs[0].device)
    for l in limbs:
        neq[1:] |= l[1:] != l[:-1]
    return neq


def _bisection_end(n: int) -> int:
    """Where the JAX package's fixed-step bisection (``steps =
    ceil(log2(n)) + 1``, no convergence guard) ends for a query above
    every entry: it steps right every time, and once it has reached
    ``n`` a spare step takes it to ``n + 1``."""
    lo = 0
    for _ in range(max(1, (max(n, 2) - 1).bit_length() + 1)):
        lo = (lo + n) // 2 + 1
    return min(lo, n + 1)


def lower_bound(sorted_limb: torch.Tensor, queries: torch.Tensor,
                le: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First index whose entry is >= the query (or > when ``le[q]``).

    The JAX package runs a fixed-step branchless bisection over ONE limb;
    on a sorted limb that is ``searchsorted``, which the port calls on
    the ``sortable`` form of the int64 bit patterns (so that the
    comparison is the unsigned one).  A query above every entry gets
    the bisection's own end (``n`` or ``n + 1``), so the result is the
    JAX package's bit for bit.  ``le`` is a per-query flag switching to
    upper-bound counting.  Returns int64 indices.
    """
    from spark_rapids_tpu_torch.ops.ordering import sortable
    n = int(sorted_limb.shape[0])
    s = sortable(sorted_limb).contiguous()
    q = sortable(queries).contiguous()
    lo = torch.searchsorted(s, q)
    if le is not None:
        lo = torch.where(le, torch.searchsorted(s, q, right=True), lo)
    return torch.where(lo == n, _bisection_end(n), lo)


def hash_group_layout(key_limbs: List[torch.Tensor],
                      use_kernel: bool = False):
    """Hash-grouped row layout: the fused group-by core.

    Returns ``(perm, sorted_key_limbs, boundary, sorted_hash, ok)``:
    rows stably ordered by the 64-bit key hash (``perm``), group starts
    under that order (``boundary``, from FULL-key adjacent comparison),
    and ``ok`` — a device bool, False iff two adjacent sorted rows share
    the hash but not the key.  Callers must take the exact sort-based
    layout when ``ok`` is False.

    Caller contract: ``limbs_hashable(key_limbs)`` is True, and the limbs
    encode the full grouping equivalence (ops/ordering.py does that).
    """
    from spark_rapids_tpu_torch.ops import ordering as ORD
    h = hash_limbs(key_limbs, use_kernel=use_kernel)
    (sorted_h,), perm = ORD.sort_by_keys([h])
    kl_s = [l[perm] for l in key_limbs]
    same_h = torch.zeros_like(perm, dtype=torch.bool)
    same_h[1:] = sorted_h[1:] == sorted_h[:-1]
    key_neq = _adjacent_neq(kl_s)
    boundary = key_neq.clone()
    boundary[0] = True
    ok = ~torch.any(same_h & key_neq)
    return perm, kl_s, boundary, sorted_h, ok
