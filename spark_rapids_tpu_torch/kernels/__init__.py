"""Kernel plane — rung selection and dispatch for the grouped aggregate
(``agg``) and the join's match ranges (``join``).

The counterpart of the JAX package's ``kernels/__init__.py``.  Rungs,
``spark.rapids.tpu.kernel.backend``:

* ``cuda`` — the hash layouts (``hash_agg.group_layout_fused``,
  ``hash_join.match_fused``), whose row hash is the hand-written CUDA
  kernel (kernels/csrc/hash_pairs.cu; on CPU tensors its plain PyTorch
  version);
* ``jnp``  — the exact full-key sort (and, for the join, the exact
  lexicographic bisection), the JAX package's reference rung, kept
  under its name;
* ``auto`` — ``cuda``.

The ladder is ``cuda -> jnp``.  It descends only on a detected 64-bit
hash collision (``ok`` False) — a correctness rule of the hash layout,
not a device fallback — or when the rung found the keys unhashable and
ran the exact layout itself (``ok`` None).  A failed build or launch is
an exception and propagates; it never descends.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

_KERNELS = ("agg", "join")

_LADDERS = {
    "cuda": ("cuda", "jnp"),
    "jnp": ("jnp",),
}


@dataclasses.dataclass
class KernelCounters:
    """Dispatches by the rung that produced the result, and descents."""

    dispatches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"cuda": 0, "jnp": 0})
    fallbacks: int = 0

    def reset(self) -> None:
        self.dispatches = {"cuda": 0, "jnp": 0}
        self.fallbacks = 0


COUNTERS = KernelCounters()


def resolve(kernel: str, backend: str) -> str:
    """Conf backend -> the rung this dispatch starts from."""
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    be = backend.lower()
    if be == "auto":
        be = "cuda"
    if be not in _LADDERS:
        raise ValueError(f"unknown kernel backend {backend!r} for {kernel}")
    return be


def dispatch(kernel: str, backend: str,
             runner: Callable[[str], Callable]):
    """Run one kernel down the ladder; returns its payload.

    ``runner(be)`` returns a zero-argument callable producing
    ``(payload, ok)``: ``ok`` is a device bool from the ``cuda`` rung
    (False = hash collision -> descend), or None when the rung ran the
    exact layout itself or IS the exact rung.  ``bool(ok)`` is the one
    host sync, the price of exactness.  Exceptions propagate.
    """
    for be in _LADDERS[backend]:
        payload, okf = runner(be)()
        if be == "jnp" or okf is None:
            COUNTERS.dispatches["jnp"] += 1
            return payload
        if not bool(okf):
            COUNTERS.fallbacks += 1
            continue
        COUNTERS.dispatches[be] += 1
        return payload
    raise AssertionError(f"kernel ladder for {backend!r} has no floor")
