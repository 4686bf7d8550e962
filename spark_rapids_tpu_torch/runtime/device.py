"""Device selection — the ``GpuDeviceManager`` analog of the port.

The engine runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, what the CPU test suite passes).  A missing card is an
error, never a silent fallback: a query that was meant for the card must
not quietly run elsewhere.  Float columns are float64 tensors by
construction (``columnar/dtypes.py`` maps DoubleType to float64), so no
process-wide precision switch exists or is needed.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """Normalize ``device`` and check that it exists.

    Raises RuntimeError when a CUDA device is requested and CUDA is
    unavailable (no card, or a CPU-only torch build).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"spark_rapids_tpu_torch: device {str(device)!r} requested "
                "but CUDA is unavailable (torch "
                f"{torch.__version__}, built for CUDA "
                f"{torch.version.cuda}); pass device='cpu' to run on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"spark_rapids_tpu_torch: {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "use 'cuda', 'cuda:N' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Device copies of small host constants (string and pattern bytes,
# decimal bounds, power tables), one per (key, device).  Expressions
# upload them at their first evaluation and read the same tensor ever
# after: a fused region's CUDA graph capture may not copy from pageable
# host memory, and the eager run before its capture fills this memo.
# Consumers never write into a constant.  The memo is bounded and drops
# every entry at its cap, so a captured graph, which reads the
# addresses it was captured with, owns the constants it reads
# (``hold_constants``) instead of relying on the memo.
_CONSTANTS: dict = {}
_CONSTANTS_CAP = 4096
_HELD = threading.local()


@contextlib.contextmanager
def hold_constants():
    """Collect every constant this thread reads inside the block into
    the dict it yields, and serve a constant read earlier in the block
    from that dict even after the memo has dropped it: an eager run and
    the capture that follows it then read the same tensors, and the
    dict keeps them alive for the graph.  A nested block shares the
    outer block's dict."""
    outer = getattr(_HELD, "held", None)
    held = _HELD.held = {} if outer is None else outer
    try:
        yield held
    finally:
        _HELD.held = outer


def device_constant(key, device: torch.device, make) -> torch.Tensor:
    """The device copy of the CPU tensor ``make()`` under ``key``,
    uploaded once per device."""
    device = torch.device(device)
    if device.type == "cpu":
        return make()
    k = (key, device)
    held = getattr(_HELD, "held", None)
    got = None if held is None else held.get(k)
    if got is None:
        got = _CONSTANTS.get(k)
        if got is None:
            if len(_CONSTANTS) >= _CONSTANTS_CAP:
                _CONSTANTS.clear()
            got = _CONSTANTS.setdefault(
                k, make().to(device, non_blocking=True))
        if held is not None:
            held[k] = got
    return got
