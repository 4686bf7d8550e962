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

The module also holds the kernel plane's policy, as the JAX package's
does: the session installs ``KernelPolicy`` once (``configure``) and the
exec pump reads its ``pump_depth`` (``spark.rapids.tpu.exec.pumpDepth``).
The rung itself stays a per-session conf read at planning.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from spark_rapids_tpu_torch.runtime import lockdep

_KERNELS = ("agg", "join")

_LADDERS = {
    "cuda": ("cuda", "jnp"),
    "jnp": ("jnp",),
}


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """One immutable kernel-plane policy (the conf snapshot, parsed)."""

    backend: str = "auto"   # spark.rapids.tpu.kernel.backend
    pump_depth: int = 2     # spark.rapids.tpu.exec.pumpDepth


_POLICY = KernelPolicy()
_LOCK = lockdep.tracked_lock("kernels._LOCK")


def configure(conf) -> KernelPolicy:
    """Install the policy from a session's RapidsConf."""
    from spark_rapids_tpu_torch import conf as C
    pol = KernelPolicy(
        backend=str(conf.get(C.KERNEL_BACKEND)).lower(),
        pump_depth=int(conf.get(C.EXEC_PUMP_DEPTH)))
    global _POLICY
    with _LOCK:
        _POLICY = pol
    return pol


def current_policy() -> KernelPolicy:
    return _POLICY


@dataclasses.dataclass
class KernelCounters:
    """Dispatches by the rung that produced the result, and descents.
    Partitions pump on a task pool, so updates take the lock."""

    dispatches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"cuda": 0, "jnp": 0})
    fallbacks: int = 0
    _lock: object = dataclasses.field(
        default_factory=lambda: lockdep.tracked_lock("kernels.KernelCounters"),
        repr=False, compare=False)

    def note_dispatch(self, rung: str) -> None:
        with self._lock:
            self.dispatches[rung] += 1

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def reset(self) -> None:
        with self._lock:
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
            COUNTERS.note_dispatch("jnp")
            return payload
        if not bool(okf):
            COUNTERS.note_fallback()
            continue
        COUNTERS.note_dispatch(be)
        return payload
    raise AssertionError(f"kernel ladder for {backend!r} has no floor")
