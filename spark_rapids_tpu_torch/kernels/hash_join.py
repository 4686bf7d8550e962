"""Fused build+probe hash join — match ranges over ONE hash limb.

The counterpart of the JAX package's ``kernels/hash_join.py``.  The
exact rung (``exec/join.py::_lex_search``) stably sorts the build side
by the full (exclusion flag + key limbs) encoding and bisects all of
those limbs twice per probe row.  This layout instead:

* build: sorts ONE limb — the 63-bit key hash with the exclusion flag in
  the top bit, so excluded (dead or null-key) rows sort after every
  probe value and are never landed on;
* probe: one single-limb lower bound; the upper bound is the hash run's
  length, counted once on the build side and gathered at the run start;
* exactness: the probed run start's FULL key limbs are compared with the
  probe row (a hash-only hit gives m = 0, never a wrong match), and an
  adjacent-pair scan of the build side detects the one case that cannot
  be repaired locally — two distinct live keys sharing a 64-bit hash —
  as ``ok = False``, so the dispatcher takes the exact rung.

Both sides are hashed by ONE launch of the hand-written CUDA kernel
``csrc/hash_pairs.cu`` (``cuda_backend.hash_pairs_multi``, two row
sets) on CUDA tensors, by ``hash_layout.hash_limbs``' plain loop
otherwise.  Hashes are int64 bit patterns:
the JAX package's uint64 ``>> 1`` is an arithmetic shift here, so it is
masked to 63 bits, and the sort and the bisection compare the
``sortable`` form, in which the top bit (the exclusion flag) orders
last as it does unsigned.

Bit-identity: within one hash run the stable sort keeps build rows in
original-index order — the order the exact rung's key sort gives inside
a key group — so ``(m, lo, perm)`` drive ``exec/join.py::_merge_join``
to the same output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.kernels import hash_layout as HL
from spark_rapids_tpu_torch.ops import ordering as ORD

_LOW63 = (1 << 63) - 1


def _hash63(r_limbs: List[torch.Tensor], l_limbs: List[torch.Tensor],
            use_kernel: bool) -> List[torch.Tensor]:
    """Both sides' 64-bit row hashes shifted right by one as unsigned;
    with ``use_kernel``, one launch for both."""
    if use_kernel:
        hashes = CB.hash_pairs_multi([r_limbs, l_limbs])
    else:
        hashes = [HL.hash_limbs(r_limbs), HL.hash_limbs(l_limbs)]
    return [(h >> 1) & _LOW63 for h in hashes]


def match_fused(l_limbs: List[torch.Tensor], r_limbs: List[torch.Tensor],
                r_excl: torch.Tensor, use_kernel: bool = False
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]]:
    """``(m, lo, perm, ok)`` under ``exec/join.py::_match_ranges``'
    contract, or None when the key limbs are unhashable (a raw float64
    limb: the caller stays on the exact rung).

    ``l_limbs``/``r_limbs`` are the fused key limbs WITHOUT the exclusion
    flag (it rides the hash limb's top bit here); masking of dead left
    rows stays with the caller, as in the JAX package.  ``m`` is the
    match count per probe row, ``lo`` the first match's position in the
    sorted build side, ``perm`` the build side's sort permutation and
    ``ok`` a device bool (False: a 64-bit collision between live keys).
    """
    if not HL.limbs_hashable(l_limbs + r_limbs):
        return None
    n = int(r_excl.shape[0])
    h_r, h_q = _hash63(r_limbs, l_limbs, use_kernel)
    build_limb = torch.where(r_excl, h_r | ORD.TOP_BIT, h_r)
    (sorted_h,), perm = ORD.sort_by_keys([build_limb])
    rl_s = [l[perm] for l in r_limbs]

    # hash-run structure of the build side (run start + run length)
    run_start = torch.ones((n,), dtype=torch.bool, device=r_excl.device)
    run_start[1:] = sorted_h[1:] != sorted_h[:-1]
    rlen = HL.run_lengths(run_start)

    # probe: one single-limb bisection, counts gathered at the run start
    lo = HL.lower_bound(sorted_h, h_q)
    loc = lo.clamp(0, n - 1)
    hit = (sorted_h[loc] == h_q) & (lo < n)
    # exact verification: the run start's key must equal the probe key
    for rl, ll in zip(rl_s, l_limbs):
        hit = hit & (rl[loc] == ll)
    m = torch.where(hit, rlen[loc], 0)

    # 64-bit collision between two distinct LIVE keys -> exact rung
    excl_s = r_excl[perm]
    key_neq = HL._adjacent_neq(rl_s)
    live_pair = torch.zeros((n,), dtype=torch.bool, device=r_excl.device)
    live_pair[1:] = (~excl_s[1:]) & (~excl_s[:-1])
    ok = ~torch.any((~run_start) & key_neq & live_pair)
    return m, lo, perm, ok
