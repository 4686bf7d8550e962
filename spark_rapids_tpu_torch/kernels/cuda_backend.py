"""Hand-written CUDA kernels — the ``cuda`` rung of the kernel plane.

The counterpart of the JAX package's ``kernels/pallas_backend.py``: its
one TPU kernel, ``hash_pairs`` (the row hash under the hash-grouped
layout), is ``csrc/hash_pairs.cu`` here.  The source is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface under ``build/kernels/`` at the root of the checkout
(git-ignored), named by a digest of the source and flags so that an
edited kernel is rebuilt, and loaded with ``ctypes``.

The wrappers ``hash_pairs`` (one row set: an ``int64[L, n]`` tensor or
a list of ``int64[n]`` limbs, read where they lie) and
``hash_pairs_multi`` (up to two row sets in one launch: a join's build
and probe sides) launch the kernel for CUDA tensors and raise if the
build or the launch fails — they never fall back.  For CPU tensors they
run the plain PyTorch version beside it (``hash_pairs_plain``), which
the CPU tests hold against the JAX package bit for bit and the chip
smoke test holds the kernel against.  ``launches`` counts the kernel's
launches and ``launch_shapes`` the row sets hashed at each ``(L, n)``
shape, both under a lock (partitions pump on a task pool);
``reset_counts`` sets both to 0.  ``BUILD_DIR`` moves under
``spark.rapids.tpu.kernel.cacheDir`` when a session sets it
(``runtime/kernel_cache.py``), and every build is counted there.

Two failure domains of ``runtime/resilience.py`` sit here: ``compile``
around a build that is needed (the port's counterpart of the JAX
package's jit-wrapper build) and ``execute`` around each dispatch of
``hash_pairs_multi`` (its counterpart of ``cached_kernel``'s call).
Only injected faults retry there; a failed ``nvcc`` or launch raises as
it would without them.  When an injected fault exhausts its retries
with ``retry.hostDegrade.enabled``, the dispatch runs the plain version
on the same device instead, counted in ``plain_calls`` and recorded as
the query's degraded op.  Each dispatch opens a ``Kernel:kernel`` span
and each build a ``Kernel:compile`` span for the attribution ledger; a
span times the host's enqueue, not the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch.runtime import kernel_cache as KC
from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import trace

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LIMB_CAP = 8  # limbs of one row set in one launch (kCap in the source)
MAX_SETS = 2  # row sets in one launch (kSets)

# launches of the hash_pairs kernel (not of its plain version), and the
# row sets it hashed by shape (L limbs, n rows)
launches = 0
launch_shapes: Dict[Tuple[int, int], int] = {}
# dispatches the plain version served in place of the kernel (an
# injected execute or compile fault that exhausted its retries)
plain_calls = 0

_lock = lockdep.tracked_lock("kernels.cuda_backend._lock")
_count_lock = lockdep.tracked_lock("kernels.cuda_backend._count_lock")
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


def build(verbose: bool = False) -> Optional[Path]:
    """Compile ``csrc/hash_pairs.cu`` (once per source digest); returns
    the shared library's path.  ``verbose`` builds even when the library
    exists, adds ``-Xptxas -v`` (which changes no code, so the library
    keeps its name), prints the compiler's report of registers and
    spills and writes it beside the library (``ptxas_log``).

    A build passes the ``compile`` failure domain; None when an
    injected fault there exhausted its retries and degraded (the
    dispatch then runs the plain version)."""
    src = _CSRC / "hash_pairs.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]
    out = BUILD_DIR / f"hash_pairs_{digest}.so"
    if out.exists() and not verbose:
        KC.note_lookup(hit=True)
        return out
    KC.note_lookup(hit=False)
    if not R.active():
        return _build(src, out, verbose)

    def attempt():
        R.INJECTOR.on("compile")
        return _build(src, out, verbose)

    return R.run_guarded("compile", attempt, op="hash_pairs",
                         degrade=lambda: None)


def _build(src: Path, out: Path, verbose: bool) -> Path:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    with KC.build_span():
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed building hash_pairs.cu:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if verbose:
        print(res.stdout + res.stderr, end="", flush=True)
        ptxas_log(out).write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    KC.note_build(time.perf_counter() - t0)
    return out


def ptxas_log(lib: Path) -> Path:
    """Where ``build(verbose=True)`` leaves the compiler's report."""
    return lib.with_suffix(".ptxas.txt")


# One launch's arguments, packed as ``HashLaunch`` in the source lays them
# out: per row set ``limb[LIMB_CAP]`` pointers, ``out``, ``n`` (64-bit),
# ``num_limbs`` and ``chained`` (32-bit); then ``num_sets`` and ``device``.
LAUNCH_LAYOUT = struct.Struct("<" + f"{LIMB_CAP}QQqii" * MAX_SETS + "ii")
_SET_FIELDS = LIMB_CAP + 4
_I64 = torch.int64


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            if path is None:
                return None  # the compile domain degraded
            lib = ctypes.CDLL(str(path))
            fn = lib.hash_pairs_launch
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
            KC.note_loaded("hash_pairs")
        return _lib


LimbSet = Union[torch.Tensor, Sequence[torch.Tensor]]


def _check_set(limbs: LimbSet) -> Tuple[List[int], int, torch.device]:
    """``(limb pointers, n, device)`` of one row set; raises on what the
    kernel does not take.  A set is an ``int64[L, n]`` tensor whose rows
    have stride 1, or a list of ``int64[n]`` limbs with stride 1."""
    if isinstance(limbs, torch.Tensor):
        if limbs.dtype is not _I64 or limbs.dim() != 2:
            raise TypeError("hash_pairs takes int64[L, n] limbs (64-bit "
                            f"bit patterns), got {limbs.dtype}"
                            f"{list(limbs.shape)}")
        n_limbs, n = limbs.shape
        if n > 1 and limbs.stride(1) != 1:
            raise ValueError("hash_pairs takes [L, n] limbs whose rows "
                             "have stride 1")
        base, step = limbs.data_ptr(), 8 * limbs.stride(0)
        ptrs = [base + j * step for j in range(n_limbs)]
        device = limbs.device
    elif isinstance(limbs, (list, tuple)):
        ptrs, n, device = [], None, None
        for l in limbs:
            if (not isinstance(l, torch.Tensor) or l.dtype is not _I64
                    or l.dim() != 1):
                got = (f"{l.dtype}{list(l.shape)}"
                       if isinstance(l, torch.Tensor) else type(l).__name__)
                raise TypeError("hash_pairs takes int64[n] limbs (64-bit "
                                f"bit patterns), got {got}")
            if n is None:
                n, device = l.shape[0], l.device
            elif l.shape[0] != n:
                raise ValueError("hash_pairs: the limbs of one row set "
                                 f"differ in length ({l.shape[0]} != {n})")
            elif l.device != device:
                raise ValueError("hash_pairs: limbs on different devices "
                                 f"({l.device} and {device})")
            if not l.is_contiguous():
                raise ValueError("hash_pairs takes limbs with stride 1")
            ptrs.append(l.data_ptr())
    else:
        raise TypeError("hash_pairs takes an int64[L, n] tensor or a list "
                        f"of int64[n] tensors, got {type(limbs).__name__}")
    if not ptrs:
        raise ValueError("hash_pairs needs at least one limb")
    return ptrs, n, device


def hash_pairs_plain(limbs: LimbSet) -> torch.Tensor:
    """The plain PyTorch version: ``hash_layout.hash_limbs``' mixing loop
    in masked int64 arithmetic."""
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.unbind(0)
    return HL.hash_limbs(list(limbs), use_kernel=False)


def hash_pairs(limbs: LimbSet) -> torch.Tensor:
    """Row hash of one row set -> ``int64[n]`` (64-bit bits).

    ``limbs`` is an ``int64[L, n]`` tensor or a list of ``int64[n]``
    limbs, each with stride 1, read where they lie.  CUDA tensors:
    launches ``csrc/hash_pairs.cu`` on the current stream and raises if
    it cannot.  CPU tensors: the plain version.
    """
    return hash_pairs_multi((limbs,))[0]


def hash_pairs_multi(limb_sets: Sequence[LimbSet]) -> List[torch.Tensor]:
    """Row hashes of up to two row sets (each as ``hash_pairs`` takes
    it, with its own L and n) in one launch: one ``int64[n]`` per set.

    A set of more than ``LIMB_CAP`` limbs takes a chain of launches,
    each starting from the previous one's output."""
    if not 1 <= len(limb_sets) <= MAX_SETS:
        raise ValueError(f"hash_pairs_multi takes 1 to {MAX_SETS} row "
                         f"sets, got {len(limb_sets)}")
    sets = [_check_set(s) for s in limb_sets]
    device = sets[0][2]
    for _, _, d in sets[1:]:
        if d != device:
            raise ValueError("hash_pairs_multi: row sets on different "
                             "devices")
    # a Kernel:kernel span, as the JAX package's jitted dispatches open:
    # the launch's host time in the kernel_dispatch bucket
    with trace.span("Kernel", "kernel"):
        if not R.active():
            return _dispatch(limb_sets, sets, device)

        def attempt():
            R.INJECTOR.on("execute")
            return _dispatch(limb_sets, sets, device)

        return R.run_guarded("execute", attempt, op="hash_pairs",
                             degrade=lambda: _plain_in_place(limb_sets))


def _plain_in_place(limb_sets: Sequence[LimbSet]) -> List[torch.Tensor]:
    """The plain version in place of the kernel, on the limbs' device."""
    global plain_calls
    with _count_lock:
        plain_calls += 1
    return [hash_pairs_plain(s) for s in limb_sets]


def _dispatch(limb_sets: Sequence[LimbSet], sets, device
              ) -> List[torch.Tensor]:
    if device.type == "cpu":
        return [hash_pairs_plain(s) for s in limb_sets]
    if device.type != "cuda":
        raise ValueError(f"hash_pairs: unsupported device {device}")
    lib = _library()
    if lib is None:  # the build degraded: the plain version on the card
        return _plain_in_place(limb_sets)
    outs, todo = [], []
    for ptrs, n, _ in sets:
        out = torch.empty((n,), dtype=_I64, device=device)
        outs.append(out)
        if n:
            todo.append((ptrs, out.data_ptr(), n))
    if todo:
        args = launch_args(todo, device.index)
        if device.index == torch._C._cuda_getDevice():
            _launch(lib, args, device.index)
        else:
            with torch.cuda.device(device):
                _launch(lib, args, device.index)
        with _count_lock:
            for ptrs, _, n in todo:
                shape = (len(ptrs), n)
                launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return outs


def _launch(lib, args: List[bytes], device_index: int) -> None:
    """The launches ``args`` in order on the device's current stream (the
    device is the current one)."""
    global launches
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    for k, arg in enumerate(args):
        err = lib.hash_pairs_launch(arg, stream)
        if err != 0:
            raise RuntimeError(f"hash_pairs kernel launch failed: CUDA "
                               f"error {err} (launch {k + 1} of "
                               f"{len(args)})")
        with _count_lock:
            launches += 1


_ZEROS = (0,) * (_SET_FIELDS * MAX_SETS)


def launch_args(todo: Sequence[Tuple[List[int], int, int]],
                device_index: int) -> List[bytes]:
    """The launches for row sets ``todo`` (each: limb pointers, output
    pointer, n), packed as ``LAUNCH_LAYOUT``: the launch at limb k takes
    limbs k up to ``k + LIMB_CAP`` of every set that has them, and each
    launch after the first starts from the previous one's output
    (``chained``)."""
    args = []
    for k in range(0, max(len(ptrs) for ptrs, _, _ in todo), LIMB_CAP):
        fields: List[int] = []
        for ptrs, out, n in todo:
            part = ptrs[k:k + LIMB_CAP]
            if part:
                fields += part
                fields += _ZEROS[:LIMB_CAP - len(part)]
                fields += (out, n, len(part), k > 0)
        num_sets = len(fields) // _SET_FIELDS
        fields += _ZEROS[:_SET_FIELDS * (MAX_SETS - num_sets)]
        args.append(LAUNCH_LAYOUT.pack(*fields, num_sets, device_index))
    return args


def reset_counts() -> None:
    """Set the launch counts (and ``plain_calls``) to 0."""
    global launches, plain_calls
    with _count_lock:
        launches = 0
        plain_calls = 0
        launch_shapes.clear()
