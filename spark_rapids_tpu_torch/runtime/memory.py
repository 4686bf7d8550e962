"""Device byte budget arbiter and host spill tier.

[REF: sql-plugin/../GpuDeviceManager.scala, spill/SpillFramework.scala;
 spark-rapids-jni :: RmmSpark (forceRetryOOM injection)]

The counterpart of the JAX package's ``runtime/memory.py``, cut to what
the scan cache, the join and the out-of-core sort use.  The arbiter is an accounting layer
above the allocator: operators ``reserve()`` bytes (``transient`` around
a device step), and registered ``SpillableBatch``es are the reclaim
pool.  A reservation that would pass the budget spills the oldest
registration to host first; when nothing is left to spill it raises
``RetryOOM``.  ``injectOomAtAlloc`` forces a ``RetryOOM`` at the N-th
reservation.

Not ported: the disk tier (with its CRC sidecars), tenancy, ``with_retry``
and the leak tracker.  Where the JAX package would push a host copy to
disk because ``spillStorageSize`` is full, the port raises ``RetryOOM``
instead.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceBatch, DeviceColumn


class RetryOOM(RuntimeError):
    """Device memory exhausted; caller should free/spill and re-run."""


class SplitAndRetryOOM(RetryOOM):
    """Re-running whole won't fit; caller must halve the input."""


def _leaves(batch: DeviceBatch) -> List[Optional[torch.Tensor]]:
    """Every tensor of a batch, in a fixed order (None where a column
    has no validity or lengths), ``sel`` last."""
    out: List[Optional[torch.Tensor]] = []
    for c in batch.columns:
        out += [c.data, c.validity, c.lengths]
    out.append(batch.sel)
    return out


def _rebuild(like: "SpillableBatch", leaves) -> DeviceBatch:
    cols = []
    for i, f in enumerate(like.schema.fields):
        data, validity, lengths = leaves[3 * i:3 * i + 3]
        cols.append(DeviceColumn(f.dtype, data, validity, lengths))
    return DeviceBatch(like.schema, tuple(cols), leaves[-1],
                       compacted=like.compacted)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a tensor: pinned for a CUDA tensor (so that the
    restore is an asynchronous DMA), an owned clone for a CPU one."""
    if t.device.type == "cuda":
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t.clone()


class SpillableBatch:
    """A device batch registered with the arbiter as reclaimable.

    Tiers: device (batch live, bytes counted) -> host (a host copy of
    every tensor).  ``get()`` restores to the device, re-reserving its
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
        # True while the host copy is counted in the manager's _host_used
        self._host_accounted = False
        # True while the device bytes are counted in _reserved
        self._device_accounted = reserve
        self.schema = batch.schema
        self.compacted = batch.compacted
        self.device = batch.device
        self.nbytes = batch.nbytes()
        # live rows, where the registrant knows them (the out-of-core
        # split's slices): a concat reads it instead of the device
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
        return "closed"

    def spill_to_host(self) -> int:
        """Device -> host.  Returns bytes freed on the device.  Raises
        ``RetryOOM`` when the host tier (``spillStorageSize``) cannot
        take the copy: the port has no disk tier to push it on to."""
        if self._batch is None:
            return 0
        mgr = self._mgr
        if mgr._host_used + self.nbytes > mgr.host_limit:
            raise RetryOOM(
                f"host spill tier full: {mgr._host_used} of "
                f"{mgr.host_limit} B used, cannot take {self.nbytes} B "
                "(the disk tier is not ported)")
        self._host = [None if x is None else _to_host(x)
                      for x in _leaves(self._batch)]
        self._batch = None
        self._host_accounted = True
        was_accounted = self._device_accounted
        self._device_accounted = False
        mgr._on_spill(self, self.nbytes, release_device=was_accounted)
        return self.nbytes

    def get(self) -> DeviceBatch:
        """Restore (if needed) and return the device batch."""
        if self._batch is not None:
            return self._batch
        if self._host is None:
            raise RuntimeError("get() of a closed SpillableBatch")
        self._mgr.reserve(self.nbytes, _restoring=self)
        self._device_accounted = True
        self._batch = _rebuild(self, [
            None if x is None else x.to(self.device, non_blocking=True)
            for x in self._host])
        self._host = None
        self._mgr.metrics["restoredBytes"] += self.nbytes
        if self._host_accounted:
            self._host_accounted = False
            self._mgr._on_restore(self)
        return self._batch

    def close(self):
        self._mgr._unregister(self)
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
                 inject_oom_at: int = -1,
                 device=None):
        self._lock = threading.RLock()
        self._spillables: Dict[int, SpillableBatch] = {}
        self._reserved = 0
        self._host_used = 0
        self.host_limit = host_limit
        self._alloc_count = 0
        self._inject_at = inject_oom_at
        self.metrics = {"spillToHostBytes": 0, "restoredBytes": 0,
                        "retryOOMs": 0, "peakReserved": 0}
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
            if nbytes > self.budget:
                raise self._oom(
                    SplitAndRetryOOM,
                    f"allocation of {nbytes} B exceeds the whole budget "
                    f"({self.budget} B) — split required")
            while self._reserved + nbytes > self.budget:
                try:
                    spilled = self._spill_one(exclude=_restoring)
                except RetryOOM as e:
                    raise self._oom(RetryOOM, str(e)) from e
                if not spilled:
                    raise self._oom(
                        RetryOOM,
                        f"cannot reserve {nbytes} B: {self._reserved} of "
                        f"{self.budget} B reserved, nothing left to spill")
            self._reserved += nbytes
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

    def _unregister(self, s: SpillableBatch) -> None:
        with self._lock:
            self._spillables.pop(id(s), None)
            if s.tier == "device" and s._device_accounted:
                s._device_accounted = False
                self.release(s.nbytes)
            elif s._host_accounted:
                s._host_accounted = False
                self._host_used = max(0, self._host_used - s.nbytes)

    def _on_spill(self, s: SpillableBatch, nbytes: int,
                  release_device: bool = True) -> None:
        with self._lock:
            if release_device:
                self.release(nbytes)
            self._host_used += nbytes
            self.metrics["spillToHostBytes"] += nbytes

    def _on_restore(self, s: SpillableBatch) -> None:
        with self._lock:
            self._host_used = max(0, self._host_used - s.nbytes)


# ---------------------------------------------------------------------------
# process-wide manager, configured per session conf
# ---------------------------------------------------------------------------

_manager: Optional[DeviceMemoryManager] = None
_manager_lock = threading.Lock()


def _build(conf, device=None) -> DeviceMemoryManager:
    if conf is None:
        return DeviceMemoryManager(device=device)
    from spark_rapids_tpu_torch import conf as C
    return DeviceMemoryManager(
        budget=conf.get(C.POOL_SIZE) or None,
        alloc_fraction=conf.get(C.MEMORY_FRACTION),
        host_limit=conf.get(C.HOST_SPILL_STORAGE),
        inject_oom_at=conf.get(C.FAULT_INJECT),
        device=device)


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
            if (cfg.budget, cfg.host_limit, cfg._inject_at) != (
                    _manager.budget, _manager.host_limit,
                    _manager._inject_at):
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
