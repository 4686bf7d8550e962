"""Result-cache plane — plan-signature query result caching.

The counterpart of the JAX package's ``cache/``.  Dashboard traffic is
mostly repeated plans over slowly-changing data.  The plane sits at the
``DataFrame.toArrow`` front door: a query whose result key is already
resident is served on the host from an Arrow table — it runs no pump,
acquires no device permit and launches nothing on the card.

Three layers:

* **keying** (``cache/keys.py``) — result key = sha1(physical-plan
  fingerprint + result-affecting confs + input fingerprints).  The
  stats plane's plan signature is op+path+schema only; the result key
  folds in the expression detail (``node_string``), the confs that
  select a different compute path (``kernel.backend``,
  ``adaptive.*``, ``exchange.mode``, the shape-bucket ladder), and a
  fingerprint per input relation (a content digest for in-memory
  tables, path+size+mtime for file scans).  A fused region's cached
  callable is keyed by its members (``exec/fused.py``); that key is not
  a result key.
* **fingerprints** (``cache/fingerprints.py``) — the registration and
  bump chokepoint for input fingerprints.
* **store** (``cache/store.py``) — byte-budgeted LRU + TTL store of
  host-resident entries with single-flight de-duplication, automatic
  supersede-invalidation when an input fingerprint changes, and a
  subplan mode that caches materialized exchange outputs (dehydrated to
  the host, rehydrated onto the device as new batches) under subtree
  keys, so partially-overlapping queries reuse shared stages.

Conf surface: ``spark.rapids.tpu.cache.{enabled,maxBytes,ttlMs,
minRuntimeMs,subplan.enabled}``.  Observability:
``tpuq_result_cache_*`` counters and the ``tpuq_result_cache_resident_
bytes`` gauge, ``entry["cache"]`` in the query event log,
``session.cache_stats()``, and ``profile top --cache``.
"""

from __future__ import annotations

import threading
from typing import Optional

from spark_rapids_tpu_torch.cache.keys import (
    ResultKey, result_key, subplan_key)
from spark_rapids_tpu_torch.cache.store import ResultCache
from spark_rapids_tpu_torch.runtime.telemetry import REGISTRY

__all__ = ["ResultKey", "ResultCache", "result_key", "subplan_key",
           "configure", "get_cache", "peek_cache", "subplan_store",
           "reset"]

# process-telemetry family (the JAX package's names)
HITS = REGISTRY.counter(
    "tpuq_result_cache_hits_total",
    "queries served from the result cache (device never touched)")
MISSES = REGISTRY.counter(
    "tpuq_result_cache_misses_total",
    "cache-enabled queries that had to execute")
EVICTIONS = REGISTRY.counter(
    "tpuq_result_cache_evictions_total",
    "entries dropped by LRU byte pressure or TTL expiry")
INVALIDATIONS = REGISTRY.counter(
    "tpuq_result_cache_invalidations_total",
    "entries dropped because an input fingerprint changed or an "
    "explicit invalidate_cache() matched")
BYTES = REGISTRY.counter(
    "tpuq_result_cache_bytes_total",
    "Arrow bytes served from the result cache on hits")

_lock = threading.Lock()
_store: Optional[ResultCache] = None


def _resident_bytes() -> float:
    s = _store
    return float(s.resident_bytes()) if s is not None else 0.0


REGISTRY.gauge("tpuq_result_cache_resident_bytes",
               "Arrow bytes currently resident in the result cache",
               fn=_resident_bytes)


def configure(conf) -> Optional[ResultCache]:
    """Create (or retune) the process result cache from a conf
    snapshot.  Entries survive a retune — two sessions with different
    kernel backends share one store and key separately; only the
    byte/TTL budgets and the subplan conf fingerprint follow the most
    recent session."""
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.cache import keys as K
    global _store
    if not conf.get(C.CACHE_ENABLED):
        return _store
    with _lock:
        if _store is None:
            _store = ResultCache(
                max_bytes=int(conf.get(C.CACHE_MAX_BYTES)),
                ttl_ms=float(conf.get(C.CACHE_TTL_MS)),
                min_runtime_ms=float(conf.get(C.CACHE_MIN_RUNTIME_MS)),
                subplan_enabled=bool(conf.get(C.CACHE_SUBPLAN_ENABLED)))
        else:
            _store.retune(
                max_bytes=int(conf.get(C.CACHE_MAX_BYTES)),
                ttl_ms=float(conf.get(C.CACHE_TTL_MS)),
                min_runtime_ms=float(conf.get(C.CACHE_MIN_RUNTIME_MS)),
                subplan_enabled=bool(conf.get(C.CACHE_SUBPLAN_ENABLED)))
        _store.subplan_conf_fp = K.conf_fingerprint(conf)
        return _store


def get_cache(conf) -> Optional[ResultCache]:
    """The store serving this conf snapshot — None when
    ``spark.rapids.tpu.cache.enabled`` is off."""
    from spark_rapids_tpu_torch import conf as C
    if not conf.get(C.CACHE_ENABLED):
        return None
    return configure(conf)


def peek_cache() -> Optional[ResultCache]:
    """Observation only — never creates."""
    return _store


def subplan_store() -> Optional[ResultCache]:
    """The store, iff subplan (exchange-output) caching is on — the
    exchange execs' gate."""
    s = _store
    return s if s is not None and s.subplan_enabled else None


def reset() -> None:
    """Drop the process store and the fingerprint registry (tests)."""
    from spark_rapids_tpu_torch.cache import fingerprints
    global _store
    with _lock:
        _store = None
    fingerprints.reset()
