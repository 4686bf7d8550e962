"""Byte-budgeted LRU + TTL store for cached query results.

The counterpart of the JAX package's ``cache/store.py``.  Entries are
host/Arrow-resident — serving a hit is a dictionary move plus a table
handoff, never a device transfer, so a hit acquires nothing
device-side.  One store holds both full results (``pa.Table``
values) and subplan/exchange payloads (keys prefixed ``sub:``) under a
single byte budget.

Invalidation surfaces, most to least specific:

* **supersede** — ``put`` drops any entry with the same ``plan_conf``
  (plan ⊕ conf) but a different full key: the inputs changed under the
  same query, so the old answer is stale (the *automatic* invalidation
  path for bumped fingerprints);
* **explicit** — ``invalidate(source=... / fingerprint=... /
  signature=... / everything=True)`` from
  ``session.invalidate_cache``;
* **TTL** — an expired entry found at lookup counts as an eviction;
* **LRU** — byte pressure evicts from the cold end.

Single-flight: concurrent executions of the same key elect one leader
via ``join_flight``; followers wait on its Event and re-lookup, so N
identical submissions compute once.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CacheEntry", "Flight", "ResultCache"]


class CacheEntry:
    __slots__ = ("key", "value", "nbytes", "sig", "plan_conf", "inputs",
                 "sources", "tenant", "runtime_s", "created",
                 "last_used", "hits", "kind")

    def __init__(self, key: str, value: Any, nbytes: int, *, sig: str,
                 plan_conf: str, inputs: Tuple[str, ...],
                 sources: Tuple[str, ...], tenant: Optional[str],
                 runtime_s: float, kind: str):
        self.key = key
        self.value = value
        self.nbytes = int(nbytes)
        self.sig = sig
        self.plan_conf = plan_conf
        self.inputs = inputs
        self.sources = sources
        self.tenant = tenant
        self.runtime_s = float(runtime_s)
        self.created = time.monotonic()
        self.last_used = self.created
        self.hits = 0
        self.kind = kind


class Flight:
    """One in-progress computation of a key (single-flight election).

    ``leader_qid`` is stamped by the winning query so followers can
    tell when the leader has been preempted and break away instead of
    holding their run slots hostage to a suspended computation."""

    __slots__ = ("key", "done", "leader_qid")

    def __init__(self, key: str):
        self.key = key
        self.done = threading.Event()
        self.leader_qid: Optional[int] = None


class ResultCache:
    def __init__(self, max_bytes: int, ttl_ms: float,
                 min_runtime_ms: float, subplan_enabled: bool):
        self._lock = threading.RLock()
        self.max_bytes = int(max_bytes)
        self.ttl_ms = float(ttl_ms)
        self.min_runtime_ms = float(min_runtime_ms)
        self.subplan_enabled = bool(subplan_enabled)
        # conf fingerprint of the most recently configured session —
        # the conf axis for subplan keys (exchanges have no conf).
        self.subplan_conf_fp = ""
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._flights: Dict[str, Flight] = {}
        self._bytes = 0
        self._counts = {
            "hits": 0, "misses": 0, "stored": 0, "evictions": 0,
            "invalidations": 0, "bytes_served": 0,
            "device_seconds_avoided": 0.0,
            "sub_hits": 0, "sub_misses": 0, "sub_stored": 0,
        }

    def retune(self, max_bytes: int, ttl_ms: float, min_runtime_ms: float,
               subplan_enabled: bool) -> None:
        with self._lock:
            self.max_bytes = int(max_bytes)
            self.ttl_ms = float(ttl_ms)
            self.min_runtime_ms = float(min_runtime_ms)
            self.subplan_enabled = bool(subplan_enabled)
            self._evict_to(self.max_bytes)

    # -- internal (lock held) -------------------------------------------

    def _remove(self, key: str) -> Optional[CacheEntry]:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self._bytes -= ent.nbytes
        return ent

    def _evict_to(self, budget: int) -> int:
        n = 0
        while self._entries and self._bytes > budget:
            k = next(iter(self._entries))
            self._remove(k)
            n += 1
        if n:
            self._counts["evictions"] += n
            self._count_evictions(n)
        return n

    def _count_evictions(self, n: int) -> None:
        from spark_rapids_tpu_torch import cache as cache_mod
        cache_mod.EVICTIONS.inc(n)

    def _expired(self, ent: CacheEntry) -> bool:
        return (self.ttl_ms > 0
                and (time.monotonic() - ent.created) * 1000.0
                > self.ttl_ms)

    # -- lookup / store -------------------------------------------------

    def lookup(self, key: str) -> Optional[CacheEntry]:
        """Hit-counting lookup: a live entry is a hit (LRU-refreshed);
        an expired entry counts as an eviction.  Misses are NOT counted
        here — a single-flight follower probes twice but a query is one
        hit or one miss, so the caller reports the miss exactly once
        via ``note_miss`` when it actually computes."""
        from spark_rapids_tpu_torch import cache as cache_mod
        sub = key.startswith("sub:")
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and self._expired(ent):
                self._remove(key)
                self._counts["evictions"] += 1
                self._count_evictions(1)
                ent = None
            if ent is not None:
                self._entries.move_to_end(key)
                ent.last_used = time.monotonic()
                ent.hits += 1
                self._counts["sub_hits" if sub else "hits"] += 1
                self._counts["bytes_served"] += ent.nbytes
                self._counts["device_seconds_avoided"] += ent.runtime_s
        if ent is not None and not sub:
            cache_mod.HITS.inc()
            cache_mod.BYTES.inc(ent.nbytes)
        return ent

    def note_miss(self, sub: bool = False) -> None:
        """One computed (non-served) cache-enabled query."""
        from spark_rapids_tpu_torch import cache as cache_mod
        with self._lock:
            self._counts["sub_misses" if sub else "misses"] += 1
        if not sub:
            cache_mod.MISSES.inc()

    def peek(self, key: str) -> Optional[CacheEntry]:
        """Non-counting, non-refreshing probe (server admission check)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and self._expired(ent):
                return None
            return ent

    def put(self, rk, value: Any, nbytes: int, runtime_s: float,
            kind: str = "result") -> Dict[str, Any]:
        """File a computed result under its ResultKey.  Returns a
        status dict destined for the query log's ``entry["cache"]``."""
        from spark_rapids_tpu_torch import cache as cache_mod
        nbytes = int(nbytes)
        if kind == "result" and runtime_s * 1000.0 < self.min_runtime_ms:
            return {"status": "uncached", "reason": "below_min_runtime"}
        if nbytes > self.max_bytes:
            return {"status": "uncached", "reason": "over_budget"}
        superseded = 0
        with self._lock:
            stale = [k for k, e in self._entries.items()
                     if e.plan_conf == rk.plan_conf and k != rk.key]
            for k in stale:
                self._remove(k)
            superseded = len(stale)
            if superseded:
                self._counts["invalidations"] += superseded
            self._remove(rk.key)
            self._evict_to(self.max_bytes - nbytes)
            ent = CacheEntry(rk.key, value, nbytes, sig=rk.sig,
                             plan_conf=rk.plan_conf, inputs=rk.inputs,
                             sources=rk.sources, tenant=rk.tenant,
                             runtime_s=runtime_s, kind=kind)
            self._entries[rk.key] = ent
            self._bytes += nbytes
            self._counts["sub_stored" if kind == "subplan"
                         else "stored"] += 1
        if superseded:
            cache_mod.INVALIDATIONS.inc(superseded)
        return {"status": "stored", "superseded": superseded}

    # -- single-flight --------------------------------------------------

    def join_flight(self, key: str) -> Tuple[str, Flight]:
        """('leader', flight) for the first caller of a key; everyone
        else gets ('follower', the leader's flight) to wait on."""
        with self._lock:
            fl = self._flights.get(key)
            if fl is None:
                fl = Flight(key)
                self._flights[key] = fl
                return "leader", fl
            return "follower", fl

    def finish_flight(self, key: str, flight: Flight) -> None:
        """Leader's finally-block: wake followers whether or not the
        computation stored (they re-lookup and fall back to computing)."""
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        flight.done.set()

    # -- invalidation ---------------------------------------------------

    def invalidate(self, *, key: Optional[str] = None,
                   source: Optional[str] = None,
                   fingerprint: Optional[str] = None,
                   signature: Optional[str] = None,
                   everything: bool = False) -> int:
        from spark_rapids_tpu_torch import cache as cache_mod
        with self._lock:
            if everything:
                doomed = list(self._entries)
            else:
                doomed = [
                    k for k, e in self._entries.items()
                    if (key is not None and k == key)
                    or (source is not None and source in e.sources)
                    or (fingerprint is not None
                        and fingerprint in e.inputs)
                    or (signature is not None and e.sig == signature)]
            for k in doomed:
                self._remove(k)
            n = len(doomed)
            if n:
                self._counts["invalidations"] += n
        if n:
            cache_mod.INVALIDATIONS.inc(n)
        return n

    # -- observation ----------------------------------------------------

    def resident_bytes(self) -> int:
        return self._bytes

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits = self._counts["hits"]
            misses = self._counts["misses"]
            by_sig: Dict[str, Dict[str, Any]] = {}
            for e in self._entries.values():
                d = by_sig.setdefault(
                    e.sig, {"entries": 0, "bytes": 0, "hits": 0})
                d["entries"] += 1
                d["bytes"] += e.nbytes
                d["hits"] += e.hits
            return {
                "entries": len(self._entries),
                "resident_bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "ttl_ms": self.ttl_ms,
                "hit_rate": (hits / (hits + misses)
                             if hits + misses else 0.0),
                "by_signature": by_sig,
                **dict(self._counts),
            }

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries)
