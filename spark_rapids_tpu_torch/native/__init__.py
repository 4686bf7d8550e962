"""Native (C++) host components of the port, loaded with ``ctypes``.

The counterpart of the JAX package's ``native/__init__.py``: a library
``lib<name>`` is compiled from ``<name>.cpp`` beside this file with
``g++`` at first use, into ``build/native/`` at the root of the checkout
(git-ignored), named by a digest of the source and the flags so that an
edited source is rebuilt, and loaded once per process.  A failed build
raises with the compiler's output (as ``kernels/cuda_backend.py`` does
for ``nvcc``); the JAX package returns None there and falls back to
Python.  The flags leave out the JAX package's ``-march=native``: the
build directory travels with a copy of the checkout to other machines.
``BUILD_DIR`` moves under ``spark.rapids.tpu.kernel.cacheDir`` when a
session sets it (``runtime/kernel_cache.py``), and every build is
counted there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from spark_rapids_tpu_torch.runtime import kernel_cache as KC

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs = {}
# seconds each library's build took in this process (0.0: found built)
build_seconds = {}


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("spark_rapids_tpu_torch: g++ not found on PATH; "
                           "the native shuffle serializer cannot be built")
    return gxx


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` (once per source digest); returns the
    shared library's path."""
    import time
    src = _SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha1(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                          ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        KC.note_lookup(hit=True)
        return out
    KC.note_lookup(hit=False)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_gxx(), *GXX_FLAGS, str(src), "-o", str(tmp)]
    with KC.build_span():
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed building {name}.cpp:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    KC.note_build(build_seconds[name])
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and dlopen ``lib<name>``; raises when it cannot."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
            KC.note_loaded(name)
        return lib
