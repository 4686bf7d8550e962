"""Device byte budget arbiter, spill tiers and the OOM-retry framework.

[REF: sql-plugin/../GpuDeviceManager.scala, spill/SpillFramework.scala,
 RmmRapidsRetryIterator.scala :: withRetry / splitSpillableInHalfByRows;
 spark-rapids-jni :: RmmSpark (forceRetryOOM injection)]

The counterpart of the JAX package's ``runtime/memory.py``.  The arbiter
is an accounting layer above the allocator: operators ``reserve()``
bytes (``transient`` around a device step), and registered
``SpillableBatch``es are the reclaim pool.  A reservation that would
pass the budget spills the oldest registration device -> host; a host
tier past ``spark.rapids.memory.host.spillStorageSize`` pushes its
oldest copies on to disk (one ``.npz`` with a CRC32 sidecar under a
per-process subdirectory of ``spark.rapids.tpu.spillPath``).  When
nothing is left to spill the reservation raises ``RetryOOM``, which
``with_retry`` catches: spill about one batch's bytes and re-run, halve
the input by rows (``SplitAndRetryOOM``), re-run the closure per half.
``injectOomAtAlloc`` forces a ``RetryOOM`` at the N-th reservation.

Three failure domains of ``runtime/resilience.py`` sit here, as in the
JAX package: ``alloc`` in ``reserve`` (an injected fault is a
``RetryOOM``, ridden out by ``with_retry``, whose retries count as
``alloc`` retries and which polls the query's cancel token),
``spill_write`` around the disk write (IO errors and injected faults
retry; exhaustion keeps the host copy) and ``spill_read`` around the
restore (retries, then a ``TerminalDeviceError`` tagged ``spill_read``:
the data is gone).

Not ported: tenancy (per-tenant HBM shares, ``suspend_spill``), ROADMAP
A.11.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import shutil
import uuid
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, slice_batch)
from spark_rapids_tpu_torch.runtime import cancel, lockdep
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.runtime import trace

# process-cumulative counters (per-manager views live in mgr.metrics);
# gauges pull the current manager's state at snapshot time
_TM_RESERVE = TM.REGISTRY.counter(
    "tpuq_hbm_reserve_bytes_total",
    "bytes reserved against the HBM budget (cumulative)")
_TM_SPILL_HOST = TM.REGISTRY.counter(
    "tpuq_spill_host_bytes_total", "device→host spill bytes")
_TM_SPILL_DISK = TM.REGISTRY.counter(
    "tpuq_spill_disk_bytes_total", "host→disk spill bytes")
_TM_RESTORE = TM.REGISTRY.counter(
    "tpuq_restore_bytes_total",
    "bytes restored to device from the host/disk spill tiers")
_TM_RETRY_OOM = TM.REGISTRY.counter(
    "tpuq_retry_oom_total", "RetryOOM raises (incl. injected)")
_TM_SPLIT_RETRY = TM.REGISTRY.counter(
    "tpuq_split_retry_total", "SplitAndRetryOOM batch halvings")


class RetryOOM(RuntimeError):
    """Device memory exhausted; caller should free/spill and re-run."""


class SplitAndRetryOOM(RetryOOM):
    """Re-running whole won't fit; caller must halve the input."""


def _leaves(batch: DeviceBatch) -> List[Optional[torch.Tensor]]:
    """Every tensor of a batch, in a fixed order (None where a column
    has no validity, lengths or element validity), ``sel`` last."""
    out: List[Optional[torch.Tensor]] = []
    for c in batch.columns:
        out += [c.data, c.validity, c.lengths, c.evalid]
    out.append(batch.sel)
    return out


def _rebuild(like: "SpillableBatch", leaves) -> DeviceBatch:
    cols = []
    for i, f in enumerate(like.schema.fields):
        cols.append(DeviceColumn(f.dtype, *leaves[4 * i:4 * i + 4]))
    return DeviceBatch(like.schema, tuple(cols), leaves[-1],
                       compacted=like.compacted)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a tensor: pinned for a CUDA tensor (so that the
    restore is an asynchronous DMA), an owned clone for a CPU one."""
    return _pinned(t) if t.device.type == "cuda" else t.clone()


def _from_disk(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host tensor of a loaded array, pinned when it goes on to a
    CUDA device (as the host tier's copies are)."""
    t = torch.from_numpy(a)
    return _pinned(t) if device.type == "cuda" else t


# ---------------------------------------------------------------------------
# spill-file integrity + per-process spill directory lifetime
# ---------------------------------------------------------------------------

def _file_crc32(path: str) -> int:
    """CRC32 of a file's bytes, chunked (spill files can be large)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _write_crc_sidecar(path: str) -> None:
    with open(path + ".crc32", "w") as f:
        f.write(f"{_file_crc32(path):08x}\n")


def _verify_crc_sidecar(path: str) -> None:
    """Raise ``ValueError`` when the payload no longer matches its
    recorded CRC — a garbled batch must never restore silently."""
    sidecar = path + ".crc32"
    if not os.path.exists(sidecar):
        return  # pre-integrity spill file; np.load is the only check
    with open(sidecar) as f:
        want = int(f.read().strip(), 16)
    got = _file_crc32(path)
    if got != want:
        raise ValueError(
            f"spill file {path} corrupt: crc32 {got:08x} != "
            f"recorded {want:08x}")


def _unlink_spill(path: str) -> None:
    for p in (path, path + ".crc32"):
        if os.path.exists(p):
            os.unlink(p)


# every per-process spill subdirectory ever handed to a manager in this
# process; one atexit hook removes them all, so a normal exit strands
# no orphan .npz files under the shared spillPath root
_SPILL_DIRS: set = set()
_SPILL_DIRS_LOCK = lockdep.tracked_lock("runtime.memory._SPILL_DIRS_LOCK")


def _cleanup_spill_dirs() -> None:
    with _SPILL_DIRS_LOCK:
        dirs = list(_SPILL_DIRS)
        _SPILL_DIRS.clear()
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _register_spill_dir(path: str) -> None:
    with _SPILL_DIRS_LOCK:
        if not _SPILL_DIRS:
            atexit.register(_cleanup_spill_dirs)
        _SPILL_DIRS.add(path)


class SpillableBatch:
    """A device batch registered with the arbiter as reclaimable.

    Tiers: device (batch live, bytes counted) -> host (a host copy of
    every tensor) -> disk (one ``.npz`` of those copies under
    ``spillPath``).  ``get()`` restores to the device, re-reserving its
    bytes.  ``reserve=False`` registers bytes that are already on the
    device without counting them (the out-of-core sort's slices, cut
    from an input its reservation never held): they count from their
    first restore on.  [REF: SpillableColumnarBatch]
    """

    def __init__(self, batch: DeviceBatch, manager: "DeviceMemoryManager",
                 reserve: bool = True):
        self._mgr = manager
        self._batch: Optional[DeviceBatch] = batch
        self._host: Optional[list] = None
        self._disk_path: Optional[str] = None
        # which leaves are None (no validity or lengths): the .npz holds
        # only the tensors
        self._absent: Tuple[bool, ...] = ()
        # True only while this batch's host copy is counted in the
        # manager's _host_used (a disk restore staged in _host is NOT)
        self._host_accounted = False
        # True while the device bytes are counted in _reserved
        self._device_accounted = reserve
        # set when a disk spill degraded (stayed in the host tier); the
        # host-limit eviction loop must skip such victims or it spins
        self._disk_spill_failed = False
        self.schema = batch.schema
        self.compacted = batch.compacted
        self.device = batch.device
        self.nbytes = batch.nbytes()
        # static row capacity, readable without restoring a spilled
        # batch (the join's re-split check must not force an unspill)
        self.capacity = batch.capacity
        # live rows, where the registrant knows them (the split's
        # slices): a concat reads it instead of the device
        self.live_rows: Optional[int] = None
        if reserve:
            manager.reserve(self.nbytes)
        manager._register(self)

    @property
    def tier(self) -> str:
        if self._batch is not None:
            return "device"
        if self._host is not None:
            return "host"
        return "disk"

    def spill_to_host(self) -> int:
        """Device -> host.  Returns bytes freed on the device."""
        if self._batch is None:
            return 0
        with trace.span("Spill", "spillTime"):
            return self._spill_to_host()

    def _spill_to_host(self) -> int:
        self._host = [None if x is None else _to_host(x)
                      for x in _leaves(self._batch)]
        self._batch = None
        self._host_accounted = True
        was_accounted = self._device_accounted
        self._device_accounted = False
        self._mgr._on_spill(self, self.nbytes, release_device=was_accounted)
        return self.nbytes

    def spill_to_disk(self) -> int:
        """Host -> disk, through the ``spill_write`` failure domain.
        Returns host bytes freed (0 when the write degraded: the batch
        stays in the host tier, marked so that the eviction loop skips
        it, and no partial file is left)."""
        if self._host is None:
            return 0
        with trace.span("Spill", "spillTime"):
            return self._spill_to_disk()

    def _spill_to_disk(self) -> int:
        leaves = self._host
        path = os.path.join(self._mgr.spill_path,
                            f"spill-{uuid.uuid4().hex}.npz")

        def attempt():
            R.INJECTOR.on("spill_write")
            os.makedirs(self._mgr.spill_path, exist_ok=True)
            np.savez(path, *[x.numpy() for x in leaves if x is not None])
            # integrity sidecar: restore refuses a payload whose bytes
            # no longer match what was written
            _write_crc_sidecar(path)
            return True

        def degrade():
            return False  # keep the host copy; the data is still safe

        try:
            ok = R.run_guarded("spill_write", attempt, op="spill_to_disk",
                               degrade=degrade)
        except BaseException:
            _unlink_spill(path)  # a cancel or a terminal error
            raise
        if not ok:
            self._disk_spill_failed = True
            _unlink_spill(path)  # drop any partial file
            return 0
        if self._disk_path is not None:
            _unlink_spill(self._disk_path)
        self._disk_path = path
        self._absent = tuple(x is None for x in leaves)
        freed = sum(x.numel() * x.element_size()
                    for x in leaves if x is not None)
        self._host = None
        if self._host_accounted:
            with self._mgr._lock:
                self._mgr._host_used = max(0, self._mgr._host_used - freed)
            self._host_accounted = False
        self._mgr._on_disk_spill(self, freed)
        return freed

    def _read_disk(self) -> list:
        """The leaves from this batch's spill file, CRC-checked, through
        the ``spill_read`` failure domain: IO faults (a missing, corrupt
        or CRC-mismatched file) retry, and exhaustion raises a
        ``TerminalDeviceError`` tagged ``spill_read`` — there is no
        plain path to degrade to."""
        def attempt():
            R.INJECTOR.on("spill_read")
            _verify_crc_sidecar(self._disk_path)
            with np.load(self._disk_path) as z:
                return [z[k] for k in z.files]

        arrays = iter(R.run_guarded("spill_read", attempt,
                                    op="spill_restore"))
        return [None if absent else _from_disk(next(arrays), self.device)
                for absent in self._absent]

    def get(self) -> DeviceBatch:
        """Restore (if needed) and return the device batch."""
        if self._batch is not None:
            return self._batch
        with trace.span("Spill", "restoreTime"):
            return self._restore()

    def _restore(self) -> DeviceBatch:
        from_host = self._host is not None
        if not from_host:
            if self._disk_path is None:
                raise RuntimeError("get() of a closed SpillableBatch")
            # disk staging never touches _host_used accounting
            self._host = self._read_disk()
            _unlink_spill(self._disk_path)
            self._disk_path = None
        # taken before the reservation: its spills may push this very
        # host copy on to disk (as in the JAX package, whose file then
        # stays until close or the next disk spill)
        leaves = self._host
        self._mgr.reserve(self.nbytes, _restoring=self)
        self._device_accounted = True
        self._batch = _rebuild(self, [
            None if x is None else x.to(self.device, non_blocking=True)
            for x in leaves])
        self._host = None
        self._mgr.metrics["restoredBytes"] += self.nbytes
        _TM_RESTORE.inc(self.nbytes)
        if from_host and self._host_accounted:
            self._host_accounted = False
            self._mgr._on_restore(self)
        return self._batch

    def close(self):
        self._mgr._unregister(self)
        if self._disk_path is not None:
            _unlink_spill(self._disk_path)
            self._disk_path = None
        self._batch = None
        self._host = None


class DeviceMemoryManager:
    """The budget arbiter [REF: GpuDeviceManager + SpillFramework].

    Budget = ``poolSize`` if set, else ``allocFraction`` x the card's
    memory (``torch.cuda.mem_get_info``); on the CPU ``allocFraction`` x
    4 GiB, the JAX package's fallback when the platform reports none.
    """

    def __init__(self, budget: Optional[int] = None,
                 alloc_fraction: float = 0.85,
                 host_limit: int = 4 << 30,
                 spill_path: str = "/tmp/tpuq-spill",
                 inject_oom_at: int = -1,
                 retry_max_attempts: int = 8,
                 debug: bool = False,
                 device=None):
        self.retry_max_attempts = retry_max_attempts
        self._lock = lockdep.tracked_lock(
            "runtime.memory.DeviceMemoryManager", reentrant=True)
        self._spillables: Dict[int, SpillableBatch] = {}
        # leak tracker [REF: cudf MemoryCleaner]: with debug on, every
        # registration records its creation stack; unreleased handles
        # are reported at exit (LEAK DETECTED)
        self.debug = debug
        self._origins: Dict[int, str] = {}
        if debug:
            atexit.register(self.report_leaks)
        self._reserved = 0
        self._host_used = 0
        self.host_limit = host_limit
        # each manager spills into its own per-process subdirectory of
        # the configured root (created at the first disk spill); the
        # atexit hook removes the whole subtree on normal exit
        self.spill_root = spill_path
        self.spill_path = os.path.join(
            spill_path, f"proc-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        _register_spill_dir(self.spill_path)
        self._alloc_count = 0
        self._inject_at = inject_oom_at
        self.metrics = {"spillToHostBytes": 0, "spillToDiskBytes": 0,
                        "restoredBytes": 0, "retryOOMs": 0,
                        "splitRetries": 0, "peakReserved": 0}
        self.budget = budget if budget else self._detect_budget(
            alloc_fraction, device)

    @staticmethod
    def _detect_budget(fraction: float, device=None) -> int:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            _, total = torch.cuda.mem_get_info(dev)
            return int(total * fraction)
        return int((4 << 30) * fraction)

    # -- accounting ---------------------------------------------------------
    def _oom(self, cls, msg: str):
        self.metrics["retryOOMs"] += 1
        _TM_RETRY_OOM.inc()
        return cls(msg)

    def reserve(self, nbytes: int, _restoring=None) -> None:
        """Claim bytes for an upcoming materialization.  Synchronously
        spills the oldest registrations if needed; raises RetryOOM when
        the budget cannot be met (or when fault injection fires)."""
        with self._lock:
            self._alloc_count += 1
            if self._inject_at >= 0 and self._alloc_count == self._inject_at:
                raise self._oom(RetryOOM, "injected OOM at allocation "
                                f"{self._alloc_count}")
            if R.INJECTOR.armed:
                # the ``alloc`` failure domain: an injected fault here is
                # a forced OOM, ridden out by the OOM rollback machinery
                try:
                    R.INJECTOR.on("alloc")
                except R.InjectedDeviceError as e:
                    raise self._oom(RetryOOM, str(e)) from e
            if nbytes > self.budget:
                raise self._oom(
                    SplitAndRetryOOM,
                    f"allocation of {nbytes} B exceeds the whole budget "
                    f"({self.budget} B) — split required")
            while self._reserved + nbytes > self.budget:
                if not self._spill_one(exclude=_restoring):
                    raise self._oom(
                        RetryOOM,
                        f"cannot reserve {nbytes} B: {self._reserved} of "
                        f"{self.budget} B reserved, nothing left to spill")
            self._reserved += nbytes
            _TM_RESERVE.inc(nbytes)
            self.metrics["peakReserved"] = max(
                self.metrics["peakReserved"], self._reserved)

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)

    @contextlib.contextmanager
    def transient(self, nbytes: int):
        """Reserve for the duration of a device op (operator working-set
        accounting; released on exit)."""
        self.reserve(nbytes)
        try:
            yield
        finally:
            self.release(nbytes)

    def _spill_one(self, exclude=None) -> bool:
        # oldest-registered first (approximate LRU)
        for s in list(self._spillables.values()):
            if s is exclude or s.tier != "device":
                continue
            s.spill_to_host()
            return True
        return False

    # -- spillable registry callbacks --------------------------------------
    def _register(self, s: SpillableBatch) -> None:
        with self._lock:
            self._spillables[id(s)] = s
            if self.debug:
                import traceback
                self._origins[id(s)] = "".join(
                    traceback.format_stack(limit=12)[:-2])

    def leaked(self, include_pinned: bool = False) -> List[tuple]:
        """(batch, origin-stack) for every never-closed registration.
        The scan cache is a deliberate long-lived pool — excluded unless
        ``include_pinned`` (its entries close on eviction)."""
        from spark_rapids_tpu_torch.exec.basic import _scan_cache
        pinned = {id(sp) for entries in list(_scan_cache.values())
                  for pairs in entries.values() for sp, _ in pairs}
        with self._lock:
            return [(s, self._origins.get(i, "<enable memory.gpu.debug "
                                             "for stacks>"))
                    for i, s in self._spillables.items()
                    if include_pinned or i not in pinned]

    def spill_pressure(self) -> float:
        """Occupancy fraction of the HOST spill tier (0.0 = empty,
        >= 1.0 = the next host spill will push victims to disk)."""
        if self.host_limit <= 0:
            return 0.0
        return self._host_used / self.host_limit

    def report_leaks(self) -> int:
        leaks = self.leaked()
        for s, origin in leaks:
            print(f"LEAK DETECTED: spillable batch {s.nbytes} B "
                  f"(tier={s.tier}) never closed; created at:\n{origin}")
        return len(leaks)

    def reclaim_all(self) -> int:
        """Close every non-pinned registered spillable.  Closing releases
        device/host accounting and unlinks disk spill files (+ CRC
        sidecars), so ``report_leaks()`` returns 0 afterwards.  Returns
        the number of batches reclaimed."""
        n = 0
        for s, _origin in self.leaked():
            s.close()
            n += 1
        return n

    def _unregister(self, s: SpillableBatch) -> None:
        with self._lock:
            self._spillables.pop(id(s), None)
            self._origins.pop(id(s), None)
            if s.tier == "device" and s._device_accounted:
                s._device_accounted = False
                self.release(s.nbytes)
            elif s._host_accounted:
                # host-tier bytes leave the host budget when the batch is
                # closed (staged disk restores were never counted)
                s._host_accounted = False
                self._host_used = max(0, self._host_used - s.nbytes)

    def _on_spill(self, s: SpillableBatch, nbytes: int,
                  release_device: bool = True) -> None:
        with self._lock:
            if release_device:
                self.release(nbytes)
            self._host_used += nbytes
            self.metrics["spillToHostBytes"] += nbytes
            _TM_SPILL_HOST.inc(nbytes)
            while self._host_used > self.host_limit:
                victim = next(
                    (v for v in self._spillables.values()
                     if v.tier == "host" and v._host_accounted
                     and not v._disk_spill_failed and v is not s), None)
                if victim is None:
                    break
                victim.spill_to_disk()  # decrements _host_used itself

    def _on_disk_spill(self, s: SpillableBatch, nbytes: int) -> None:
        self.metrics["spillToDiskBytes"] += nbytes
        _TM_SPILL_DISK.inc(nbytes)

    def _on_restore(self, s: SpillableBatch) -> None:
        with self._lock:
            self._host_used = max(0, self._host_used - s.nbytes)


# ---------------------------------------------------------------------------
# process-wide manager, configured per session conf
# ---------------------------------------------------------------------------

_manager: Optional[DeviceMemoryManager] = None
_manager_lock = lockdep.tracked_lock("runtime.memory._manager_lock")


def _build(conf, device=None) -> DeviceMemoryManager:
    if conf is None:
        return DeviceMemoryManager(device=device)
    from spark_rapids_tpu_torch import conf as C
    return DeviceMemoryManager(
        budget=conf.get(C.POOL_SIZE) or None,
        alloc_fraction=conf.get(C.MEMORY_FRACTION),
        host_limit=conf.get(C.HOST_SPILL_STORAGE),
        spill_path=conf.get(C.SPILL_PATH),
        inject_oom_at=conf.get(C.FAULT_INJECT),
        retry_max_attempts=conf.get(C.RETRY_MAX),
        debug=str(conf.get(C.MEMORY_DEBUG)).upper() == "STDOUT",
        device=device)


def _identity(m: DeviceMemoryManager) -> tuple:
    # the configured spill ROOT, not the per-instance subdirectory, or
    # every get_manager(conf) would rebuild the arbiter
    return (m.budget, m.host_limit, m._inject_at, m.retry_max_attempts,
            m.spill_root, m.debug)


def get_manager(conf=None, device=None) -> DeviceMemoryManager:
    """The process arbiter.  First caller's conf wins; a session whose
    memory confs (or device budget) differ replaces it, and the
    replacement evicts the scan cache, whose entries are registered with
    the old arbiter."""
    global _manager
    replaced = False
    with _manager_lock:
        if _manager is None:
            _manager = _build(conf, device)
        elif conf is not None:
            cfg = _build(conf, device)
            if _identity(cfg) != _identity(_manager):
                _manager = cfg
                replaced = True
        mgr = _manager
    if replaced:
        from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
        clear_scan_cache()
    return mgr


def peek_manager() -> Optional[DeviceMemoryManager]:
    """The process arbiter if one exists — never creates."""
    return _manager


def reset_manager() -> None:
    global _manager
    with _manager_lock:
        _manager = None


# pull-based gauges over the current manager (0 before the first query
# builds one): producers pay nothing, the sampler reads at snapshot time
TM.REGISTRY.gauge(
    "tpuq_hbm_reserved_bytes", "bytes currently reserved in HBM",
    fn=lambda: _manager._reserved if _manager is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_hbm_watermark_bytes", "peak reserved bytes (this manager)",
    fn=lambda: (_manager.metrics["peakReserved"]
                if _manager is not None else 0))
TM.REGISTRY.gauge(
    "tpuq_hbm_budget_bytes", "HBM budget the arbiter hands out",
    fn=lambda: _manager.budget if _manager is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_host_spill_used_bytes", "host spill tier bytes in use",
    fn=lambda: _manager._host_used if _manager is not None else 0)
TM.REGISTRY.gauge(
    "tpuq_spillable_batches", "live registered spillable batches",
    fn=lambda: len(_manager._spillables) if _manager is not None else 0)


# ---------------------------------------------------------------------------
# the retry framework [REF: RmmRapidsRetryIterator.scala :: withRetry]
# ---------------------------------------------------------------------------

def split_batch_in_half(batch: DeviceBatch) -> List[DeviceBatch]:
    """Halve a batch by row range (the splitSpillableInHalfByRows
    analog).  Views — each half keeps a pow-2 capacity."""
    cap = batch.capacity
    if cap <= 1:
        raise SplitAndRetryOOM("cannot split a 1-row batch")
    half = cap // 2
    return [slice_batch(batch, 0, half), slice_batch(batch, half, half)]


def with_retry(
    inputs: Iterable[DeviceBatch],
    closure: Callable[[DeviceBatch], object],
    max_attempts: Optional[int] = None,
    manager: Optional[DeviceMemoryManager] = None,
    allow_split: bool = True,
):
    """Run ``closure`` over each input batch with OOM rollback.

    On ``RetryOOM``: spill registered spillables and re-run the same
    batch.  On ``SplitAndRetryOOM`` (or a repeated RetryOOM): split the
    batch in half by rows and process the halves independently — the
    caller's closure must be merge-friendly (partial aggregates, sorted
    runs, ...).  Yields one result per processed (sub-)batch.  Attempts
    default to the manager's ``spark.rapids.tpu.retry.maxAttempts``;
    every retry counts as an ``alloc`` retry of the resilience layer
    (``R.note_retry``), and each round polls the query's cancel token.

    ``inputs`` is consumed LAZILY — one upstream batch is live at a
    time, so spilling actually frees device memory instead of fighting a
    pinned input list.
    """
    mgr = manager or get_manager()
    if max_attempts is None:
        max_attempts = mgr.retry_max_attempts
    it = iter(inputs)
    work: List[Tuple[DeviceBatch, int]] = []  # pending (sub-)batches
    while True:
        cancel.check()
        if work:
            batch, attempts = work.pop(0)
        else:
            batch = next(it, None)
            if batch is None:
                return
            attempts = 0
        try:
            yield closure(batch)
        except SplitAndRetryOOM:
            if not allow_split:
                raise
            mgr.metrics["splitRetries"] += 1
            _TM_SPLIT_RETRY.inc()
            R.note_retry("alloc")
            halves = split_batch_in_half(batch)
            work = [(h, attempts + 1) for h in halves] + work
        except RetryOOM:
            if attempts + 1 >= max_attempts:
                R.note_exhausted()
                raise
            R.note_retry("alloc")
            # free device pressure INCREMENTALLY: spill victims until
            # roughly this batch's working set is free, not the whole
            # pool (draining everything evicts the scan cache on the
            # first transient OOM and forces full re-materialization)
            freed, target = 0, max(batch.nbytes(), 1)
            for s in list(mgr._spillables.values()):
                if s.tier == "device":
                    freed += s.spill_to_host()
                    if freed >= target:
                        break
            if attempts >= 1 and allow_split and batch.capacity > 1:
                mgr.metrics["splitRetries"] += 1
                _TM_SPLIT_RETRY.inc()
                halves = split_batch_in_half(batch)
                work = [(h, attempts + 1) for h in halves] + work
            else:
                work.insert(0, (batch, attempts + 1))
