"""The persistent cache of built kernel libraries.

The counterpart of the JAX package's ``runtime/kernel_cache.py``.  There
the cache holds XLA executables; the port's compiled code is its built
libraries: ``kernels/csrc/hash_pairs.cu`` (``nvcc``, for ``sm_90a``) and
``native/tudo.cpp`` (``g++``).  Both are built at first use, named by a
digest of their source and flags, into ``build/`` at the root of the
checkout, which lives as long as the checkout.  With
``spark.rapids.tpu.kernel.cacheDir`` set, a session on the card points
both build sites at ``<cacheDir>/<GPU name>-sm<compute capability>``
(``configure_persistent_cache``), so a later process on the same kind
of card loads the libraries without building them.  The directory
carries a manifest of the versions that built it (``_cache_versions``);
a mismatch clears every entry (``_sync_manifest``).  A build that fails
there raises; it never falls back to ``build/``.

Both build sites count every lookup (``note_lookup``: a library found
built is a hit, one that must be built a miss) and every build
(``note_build``), and run the build inside a ``Kernel:compile`` span
(``build_span``), so that the attribution ledger charges it to the
``compile`` bucket.  The counters are the JAX package's
``tpuq_kernel_cache_*`` and ``tpuq_kernel_compile_*`` names; kept
deviation: here they count library lookups and builds, where the JAX
package counts jit-wrapper lookups and XLA compiles, so that the
compile-storm health check sees builds.  ``compile_snapshot`` returns
(builds, build seconds), which ``session.warmup`` diffs.  The JAX
package's in-process fingerprint cache of jitted kernels has no
counterpart: eager torch keeps none.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.runtime import trace

MANIFEST_NAME = "tpuq_cache_manifest.json"
_PERSISTENT_DIR: Optional[str] = None

_LOCK = lockdep.tracked_lock("runtime.kernel_cache._LOCK")

_TM_HITS = TM.REGISTRY.counter(
    "tpuq_kernel_cache_hits_total",
    "kernel library lookups served by an already built library")
_TM_MISSES = TM.REGISTRY.counter(
    "tpuq_kernel_cache_misses_total",
    "kernel library lookups that had to build the library")
_TM_COMPILES = TM.REGISTRY.counter(
    "tpuq_kernel_compile_total", "kernel library builds (nvcc, g++)")
_TM_COMPILE_S = TM.REGISTRY.counter(
    "tpuq_kernel_compile_seconds_total",
    "seconds spent building kernel libraries")


# the names of the libraries the build sites loaded (``note_loaded``)
_LOADED: set = set()
TM.REGISTRY.gauge(
    "tpuq_kernel_cache_size", "kernel libraries loaded in this process",
    fn=lambda: len(_LOADED))


def fingerprint(v) -> object:
    """Structural, hashable key of an expression or schema tree (the
    JAX package's ``kernel_cache.fingerprint``): a fusion hook's key."""
    import dataclasses
    from spark_rapids_tpu_torch.columnar import dtypes as T

    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if isinstance(v, T.DataType):
            return v.simple_name
        return (type(v).__name__,) + tuple(
            fingerprint(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return tuple(fingerprint(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, fingerprint(x)) for k, x in v.items()))
    return repr(v)


def note_lookup(hit: bool) -> None:
    """Count one library lookup at a build site."""
    (_TM_HITS if hit else _TM_MISSES).inc()


def build_span():
    """The span a build runs in (a no-op when no query traces)."""
    return trace.span("Kernel", "compile")


def note_build(seconds: float) -> None:
    """Count one library build (called by both build sites)."""
    _TM_COMPILES.inc()
    _TM_COMPILE_S.inc(float(seconds))


def note_loaded(name: str) -> None:
    """Count one library a build site loaded (until ``clear``)."""
    _LOADED.add(name)


def compile_snapshot() -> Tuple[int, float]:
    """(library builds, build seconds) so far in this process — the
    before/after pair ``session.warmup`` diffs."""
    return int(_TM_COMPILES.value), float(_TM_COMPILE_S.value)


def _tool_version(cmd, pattern: str) -> str:
    """The first match of ``pattern`` in ``cmd``'s output; '' when the
    tool is missing."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    m = re.search(pattern, res.stdout + res.stderr)
    return m.group(1) if m else ""


def _cache_versions() -> Dict[str, str]:
    """The compatibility tuple a cache directory is valid for (a fresh
    dict: callers may change it)."""
    return dict(_versions())


@functools.lru_cache(maxsize=1)
def _versions() -> Tuple[Tuple[str, str], ...]:
    """``_cache_versions``' items, read once per process (the tools'
    versions take a subprocess each)."""
    import torch

    from spark_rapids_tpu_torch import __version__ as engine_version
    from spark_rapids_tpu_torch.kernels.cuda_backend import _nvcc
    try:
        nvcc = _tool_version([_nvcc(), "--version"], r"release ([\d.]+)")
    except RuntimeError:  # no nvcc: nothing can be built for the card
        nvcc = ""
    gxx = shutil.which("g++")
    return (("format", "1"), ("torch", torch.__version__),
            ("cuda", str(torch.version.cuda)), ("nvcc", nvcc),
            ("gxx", _tool_version([gxx, "-dumpfullversion"], r"(\S+)")
             if gxx else ""),
            ("engine", engine_version))


def _sync_manifest(cache_dir: str) -> bool:
    """Validate ``cache_dir`` against the current versions.

    Returns True when existing entries were kept (manifest matched).
    On mismatch every entry is dropped and the manifest is rewritten
    for this build."""
    path = os.path.join(cache_dir, MANIFEST_NAME)
    want = _cache_versions()
    try:
        with open(path) as f:
            have = json.load(f)
    except (OSError, ValueError):
        have = None
    if have == want:
        return True
    for name in os.listdir(cache_dir):
        if name == MANIFEST_NAME:
            continue
        p = os.path.join(cache_dir, name)
        try:
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.unlink(p)
        except OSError:
            pass  # a torn delete only costs one stale entry re-check
    with open(path, "w") as f:
        json.dump(want, f)
    return False


def _machine_fingerprint(device) -> str:
    """The GPU's name and compute capability, as a directory name."""
    import torch
    name = re.sub(r"[^A-Za-z0-9]+", "_",
                  torch.cuda.get_device_name(device)).strip("_")
    major, minor = torch.cuda.get_device_capability(device)
    return f"{name}-sm{major}{minor}"


def configure_persistent_cache(conf, device) -> Optional[str]:
    """Point both build sites at ``kernel.cacheDir`` for ``device``.

    Called at session creation.  An empty cacheDir leaves the build
    sites where they are (``build/`` unless a session moved them).  A
    session on the CPU builds no kernel: it returns None and writes
    nothing.  Returns the active directory, or None."""
    import torch

    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    global _PERSISTENT_DIR
    cache_dir = str(conf.get(C.KERNEL_CACHE_DIR)).strip()
    if not cache_dir:
        return _PERSISTENT_DIR
    device = torch.device(device)
    if device.type != "cuda":
        return None
    cache_dir = os.path.join(os.path.expanduser(cache_dir),
                             _machine_fingerprint(device))
    with _LOCK:
        os.makedirs(cache_dir, exist_ok=True)
        _sync_manifest(cache_dir)
        CB.BUILD_DIR = Path(cache_dir) / "kernels"
        native.BUILD_DIR = Path(cache_dir) / "native"
        _PERSISTENT_DIR = cache_dir
    return cache_dir


def persistent_cache_dir() -> Optional[str]:
    """The conf-selected cache directory, when one is active."""
    return _PERSISTENT_DIR


def clear() -> None:
    """Forget the loaded libraries: the next launch looks each one up
    again under the current build directories (and builds it if it is
    not there)."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    from spark_rapids_tpu_torch.shuffle import serializer
    with CB._lock:
        CB._lib = None
    with native._lock:
        native._libs.clear()
    serializer._lib = None
    _LOADED.clear()
