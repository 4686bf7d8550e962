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

Every accepted dispatch counts in the registry's
``tpuq_kernel_dispatch_total`` and every descent in
``tpuq_kernel_fallback_total`` (``count``), and names its rung on the
operator's stats record (``kernel_backend``).  Kept deviation: the
dispatch counter's label values are the port's rungs, ``cuda`` and
``jnp``, where the JAX package's are ``pallas``, ``fused`` and ``jnp``.
``COUNTERS`` reads the same counters from its last ``reset``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

_KERNELS = ("agg", "join")

_LADDERS = {
    "cuda": ("cuda", "jnp"),
    "jnp": ("jnp",),
}

_TM_DISPATCH = TM.REGISTRY.labeled_counter(
    "tpuq_kernel_dispatch_total",
    "kernel-plane dispatches by the backend that produced the result",
    label="backend")
_TM_FALLBACK = TM.REGISTRY.labeled_counter(
    "tpuq_kernel_fallback_total",
    "kernel dispatches that descended the backend ladder (hash "
    "collision, unhashable keys, or a failed rung)",
    label="kernel")


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


class KernelCounters:
    """Dispatches by the rung that produced the result, and descents,
    since the last ``reset``: a view of the registry's counters."""

    def __init__(self):
        self._base = (self._dispatch_totals(), _TM_FALLBACK.value)

    @staticmethod
    def _dispatch_totals() -> Dict[str, int]:
        return {rung: _TM_DISPATCH.labels(rung).value
                for rung in ("cuda", "jnp")}

    @property
    def dispatches(self) -> Dict[str, int]:
        base = self._base[0]
        return {rung: n - base[rung]
                for rung, n in self._dispatch_totals().items()}

    @property
    def fallbacks(self) -> int:
        return _TM_FALLBACK.value - self._base[1]

    @staticmethod
    def note_fallback(kernel: str) -> None:
        _TM_FALLBACK.inc(kernel)

    def reset(self) -> None:
        self._base = (self._dispatch_totals(), _TM_FALLBACK.value)


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


def count(kernel: str, backend: str, node=None) -> None:
    """Record one accepted dispatch: telemetry and the op's stats row."""
    _TM_DISPATCH.inc(backend)
    if node is not None:
        from spark_rapids_tpu_torch.runtime import stats
        st = stats.current()
        if st is not None:
            st.node_stats(node).set_kernel_backend(backend)


def dispatch(kernel: str, backend: str,
             runner: Callable[[str], Callable], node=None):
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
            count(kernel, "jnp", node)
            return payload
        if not bool(okf):
            COUNTERS.note_fallback(kernel)
            continue
        count(kernel, be, node)
        return payload
    raise AssertionError(f"kernel ladder for {backend!r} has no floor")
