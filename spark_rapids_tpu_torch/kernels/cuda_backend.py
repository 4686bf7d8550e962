"""Hand-written CUDA kernels — the ``cuda`` rung of the kernel plane.

The counterpart of the JAX package's ``kernels/pallas_backend.py``: its
one TPU kernel, ``hash_pairs`` (the row hash under the hash-grouped
layout), is ``csrc/hash_pairs.cu`` here.  The source is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface under ``build/kernels/`` at the root of the checkout
(git-ignored), named by a digest of the source and flags so that an
edited kernel is rebuilt, and loaded with ``ctypes``.

The wrapper ``hash_pairs`` launches the kernel for a CUDA tensor and
raises if the build or the launch fails — it never falls back.  For a
CPU tensor it runs the plain PyTorch version beside it
(``hash_pairs_plain``), which the CPU tests hold against the JAX
package bit for bit and the chip smoke test holds the kernel against.
``launches`` counts the kernel's launches and ``launch_shapes`` the
launches of each ``(L, n)`` shape; ``reset_counts`` sets both to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches of the hash_pairs kernel (not of its plain version), in all
# and by shape (L limbs, n rows)
launches = 0
launch_shapes: Dict[Tuple[int, int], int] = {}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("spark_rapids_tpu_torch: nvcc not found (looked in "
                       "$CUDA_HOME/bin, /usr/local/cuda/bin and PATH); the "
                       "CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/hash_pairs.cu`` (once per source digest); returns
    the shared library's path.  ``verbose`` adds ``-Xptxas -v`` and
    prints the compiler's report of registers and spills."""
    src = _CSRC / "hash_pairs.cu"
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                          ).hexdigest()[:16]
    out = BUILD_DIR / f"hash_pairs_{digest}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed building hash_pairs.cu:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if verbose:
        print(res.stdout + res.stderr, end="", flush=True)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.hash_pairs_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_limbs(limbs: torch.Tensor) -> None:
    if not isinstance(limbs, torch.Tensor):
        raise TypeError("hash_pairs takes a tensor")
    if limbs.dtype != torch.int64 or limbs.dim() != 2:
        raise TypeError("hash_pairs takes int64[L, n] limbs (64-bit bit "
                        f"patterns), got {limbs.dtype}{list(limbs.shape)}")
    if limbs.shape[0] < 1:
        raise ValueError("hash_pairs needs at least one limb")
    if limbs.shape[1] >= 1 << 31:
        raise ValueError(f"hash_pairs takes fewer than 2^31 rows, got "
                         f"{limbs.shape[1]}")
    if not limbs.is_contiguous():
        raise ValueError("hash_pairs takes contiguous [L, n] limbs")


def hash_pairs_plain(limbs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``hash_layout.hash_limbs``' mixing loop
    in masked int64 arithmetic."""
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    return HL.hash_limbs(list(limbs.unbind(0)), use_kernel=False)


def hash_pairs(limbs: torch.Tensor) -> torch.Tensor:
    """Row hash of ``int64[L, n]`` limbs -> ``int64[n]`` (64-bit bits).

    CUDA tensor: launches ``csrc/hash_pairs.cu`` on the current stream
    and raises if it cannot.  CPU tensor: the plain version.
    """
    global launches
    _check_limbs(limbs)
    if limbs.device.type == "cpu":
        return hash_pairs_plain(limbs)
    if limbs.device.type != "cuda":
        raise ValueError(f"hash_pairs: unsupported device {limbs.device}")
    lib = _library()
    n_limbs, n = limbs.shape
    out = torch.empty((n,), dtype=torch.int64, device=limbs.device)
    with torch.cuda.device(limbs.device):
        stream = torch.cuda.current_stream(limbs.device).cuda_stream
        err = lib.hash_pairs_launch(limbs.data_ptr(), int(n_limbs), int(n),
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash_pairs kernel launch failed: CUDA error "
                           f"{err} (L={n_limbs}, n={n})")
    launches += 1
    launch_shapes[(n_limbs, n)] = launch_shapes.get((n_limbs, n), 0) + 1
    return out


def reset_counts() -> None:
    """Set the launch counts to 0."""
    global launches
    launches = 0
    launch_shapes.clear()
