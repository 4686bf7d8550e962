"""Per-query wall-clock attribution ledger and flight recorder.

The counterpart of the JAX package's ``runtime/attribution.py``, with
its bucket catalog, verdicts and file formats.  [REF: GpuMetrics.scala;
the profiling tool's per-stage breakdown]  The port has spans
(``runtime/trace.py``), counter deltas (``runtime/telemetry.py``) and op
stats (``runtime/stats.py``); this module folds them into one exclusive
decomposition that closes against the end-to-end wall time, and that
survives a timeout or a cancel with evidence.

* **Ledger** (``attribute``): every trace span of the query is
  projected onto the one wall-clock timeline and each instant is
  charged to exactly one declared bucket (``BUCKETS``).  Overlaps across
  pump threads resolve by specificity (``BUCKET_PRIORITY``: a semaphore
  wait inside a pump task is a wait, not pump time), so that the buckets
  are exclusive, sum to at most e2e, and the gap is reported as
  ``unaccounted``, never absorbed.  ``closed`` is the verdict of
  ``closeTolerance`` on that gap.  Spans time the host: a kernel's
  device time lands in whichever span waited for it.

* **Flight recorder** (``FlightRecorder``): a bounded ring of the
  query's latest spans and its health, retry and cancel events, fed
  from the tracer's span-close path and ``record_event`` (deque
  appends, no new timers).  On a bad exit (timeout, cancel, error,
  health WARN) the ring and the ledger dump atomically to
  ``query-<id>.blackbox.json`` (tmp + rename, a bounded directory with
  oldest-first eviction), so that a query killed at its deadline still
  names its dominant bucket.

* **Verdict** (``verdict_line``): one ranked line, "kernel-bound: 71%
  of 3.3 s in kernel_dispatch", on the event-log entry, the stats
  profile, the black box, and in ``profile why``.

The bucket names are the JAX package's, ``compile`` and
``exchange_collective`` included (the port's compiles are library
builds; its ICI exchanges' ``collectiveTime`` spans land in
``exchange_collective``).  Kept deviation: one lock per directory is
held over a dump's write and its eviction, so that concurrent dumps in
one process can no longer evict each other's files.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from spark_rapids_tpu_torch.runtime import telemetry as TM

# ---------------------------------------------------------------------------
# The bucket catalog — the declared registry the ledger and the profile
# CLI read (the JAX package's names and verdicts).
# ---------------------------------------------------------------------------

BUCKETS: Dict[str, str] = {
    "queue_wait": "time queued for a QueryServer run slot before "
                  "execution started (server-submitted queries only)",
    "semaphore_wait": "time blocked in the device admission semaphore "
                      "(concurrentGpuTasks) or the pre-materialize hold",
    "compile": "kernel library builds (nvcc, g++) detected on this "
               "query's clock",
    "kernel_dispatch": "device compute, H2D/D2H transfer, gather/"
                       "broadcast/concat and other device-batch work",
    "exchange_collective": "ICI exchange collectives (the compiled "
                           "exchange's device launches)",
    "host_shuffle": "host-side shuffle partition/serialize/read/write",
    "spill_io": "device->host->disk spill writes and restore reads",
    "preempted": "time parked in the SUSPENDED state after the "
                 "scheduler preempted the query (permits released, "
                 "residency spilled) — never lands in unaccounted",
    "cache": "result-cache probe and store (serve on hit, put on miss)",
    "pump_idle": "partition-pump machinery between instrumented "
                 "stages: iterator plumbing, batch handoff, "
                 "arrow conversion at the root boundary",
    "host_fallback": "CPU-fallback operator pumps, python UDFs, and "
                     "host-side scans",
    "unaccounted": "e2e wall minus everything above — genuinely "
                   "uninstrumented time, reported, never absorbed",
}

# Verdict label per dominant bucket ("<label>: NN% of S s in <bucket>").
BUCKET_VERDICTS: Dict[str, str] = {
    "queue_wait": "queue-bound",
    "semaphore_wait": "admission-bound",
    "compile": "compile-bound",
    "kernel_dispatch": "kernel-bound",
    "exchange_collective": "exchange-bound",
    "host_shuffle": "shuffle-bound",
    "spill_io": "spill-bound",
    "preempted": "preempt-bound",
    "cache": "cache-bound",
    "pump_idle": "pump-bound",
    "host_fallback": "fallback-bound",
    "unaccounted": "uninstrumented",
}

# Every MetricTimer stage name and pump-stage label of runtime/ and exec/
# maps here (``tests/test_torch_attribution.py`` checks the port's timer
# names).  "pump" resolves per op at fold time: a Cpu* operator's pump is
# host fallback, not pump_idle.
STAGE_BUCKETS: Dict[str, Optional[str]] = {
    "pump": "pump_idle",            # Cpu* ops -> host_fallback
    "pumpTask": "pump_idle",
    "opTime": "kernel_dispatch",
    "kernel": "kernel_dispatch",
    "transferTime": "kernel_dispatch",
    "concatTime": "kernel_dispatch",
    "gatherTime": "kernel_dispatch",
    "broadcastTime": "kernel_dispatch",
    "partialTime": "kernel_dispatch",
    "mergeTime": "kernel_dispatch",
    "measureTime": "kernel_dispatch",
    "decideTime": "kernel_dispatch",
    "compile": "compile",
    "collectiveTime": "exchange_collective",
    "partitionTime": "host_shuffle",
    "writeTime": "host_shuffle",
    "readTime": "host_shuffle",
    "udfTime": "host_fallback",
    "scanTime": "host_fallback",
    "spillTime": "spill_io",
    "restoreTime": "spill_io",
    "semaphoreWait": "semaphore_wait",
    "semaphoreWaitTime": "semaphore_wait",
    "preemptWait": "preempted",
    "cacheProbe": "cache",
    "cacheServe": "cache",
    "queueWait": "queue_wait",
    # the query-root span: deliberately NOT charged to any bucket —
    # charging it would absorb every uninstrumented gap and make the
    # closure check vacuous
    "execute": None,
}

# Specificity order for overlap resolution, most specific first: an
# instant covered by several threads' spans charges to the
# highest-priority active bucket.  Waits and one-shot I/O stages beat
# compute; compute beats the pump envelope.
BUCKET_PRIORITY: Tuple[str, ...] = (
    "compile", "preempted", "semaphore_wait", "spill_io",
    "exchange_collective", "host_shuffle", "cache", "host_fallback",
    "kernel_dispatch", "queue_wait", "pump_idle",
)

# closure slack floor: on sub-100ms queries fixed per-query overheads
# (plan metric finalize, log append) dominate any percentage
ABS_CLOSE_SLACK_S = 0.010

_TM_UNACCOUNTED = TM.REGISTRY.counter(
    "tpuq_attribution_unaccounted_seconds_total",
    "per-query wall seconds the attribution ledger could not charge "
    "to any instrumented bucket (the explicit 'unaccounted' gap)")
_TM_DUMPS = TM.REGISTRY.labeled_counter(
    "tpuq_blackbox_dumps_total",
    "flight-recorder black boxes dumped, per trigger "
    "(timeout|cancel|error|health)")


def span_bucket(op: str, stage: str) -> Optional[str]:
    """Bucket of one span; None = uncharged (unknown stage or the
    query-root envelope)."""
    if stage == "pump" and op.startswith("Cpu"):
        return "host_fallback"
    return STAGE_BUCKETS.get(stage)


# ---------------------------------------------------------------------------
# The ledger fold
# ---------------------------------------------------------------------------

def _project(intervals: List[Tuple[float, float, int]],
             t0: float, t1: float) -> List[float]:
    """Charge the [t0, t1] timeline to buckets by priority sweep.

    ``intervals`` is (start, end, priority_index); returns seconds per
    ``BUCKET_PRIORITY`` index.  At each elementary segment between
    boundary points the highest-priority active bucket (lowest index)
    wins, so the result is exclusive by construction and sums to at
    most (t1 - t0)."""
    n = len(BUCKET_PRIORITY)
    out = [0.0] * n
    if t1 <= t0 or not intervals:
        return out
    events: List[Tuple[float, int, int]] = []
    for s, e, pri in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            events.append((s, 1, pri))
            events.append((e, -1, pri))
    if not events:
        return out
    events.sort(key=lambda ev: ev[0])
    active = [0] * n
    prev = events[0][0]
    i = 0
    while i < len(events):
        t = events[i][0]
        if t > prev:
            for pri in range(n):
                if active[pri]:
                    out[pri] += t - prev
                    break
            prev = t
        while i < len(events) and events[i][0] == t:
            active[events[i][2]] += events[i][1]
            i += 1
    return out


def attribute(tracer=None, spans: Optional[Iterable] = None,
              e2e_s: Optional[float] = None,
              tolerance: float = 0.10,
              extras: Optional[Dict[str, float]] = None
              ) -> Dict[str, Any]:
    """Fold a query's trace spans into the exclusive bucket ledger.

    ``tracer`` is a finished ``trace.Tracer`` (preferred — its
    ``t_start``/``wall_s`` anchor the timeline); ``spans`` + ``e2e_s``
    is the raw form the black-box/test path uses.  ``extras`` adds
    scalar seconds measured outside the trace window (the server's
    queue wait) — they extend e2e rather than competing for it.

    Returns ``{"buckets", "e2e_s", "unaccounted_s", "closed",
    "tolerance", "verdict", "dominant", "dominant_share"}`` with
    buckets rounded, exclusive, and summing (with ``unaccounted``) to
    ``e2e_s`` exactly."""
    if tracer is not None:
        spans = list(tracer.events)
        t0 = tracer.t_start
        wall = tracer.wall_s
        if wall is None:
            wall = (time.perf_counter() - t0)
        t1 = t0 + wall
    else:
        spans = list(spans or ())
        if spans:
            t0 = min(sp.t0 for sp in spans)
            t1 = max(sp.t1 for sp in spans)
        else:
            t0 = t1 = 0.0
        if e2e_s is not None:
            t1 = t0 + e2e_s
    e2e = max(t1 - t0, 0.0)
    pri_index = {b: i for i, b in enumerate(BUCKET_PRIORITY)}
    intervals: List[Tuple[float, float, int]] = []
    for sp in spans:
        b = span_bucket(sp.op, sp.stage)
        if b is None:
            continue
        intervals.append((sp.t0, sp.t1, pri_index[b]))
    per_pri = _project(intervals, t0, t1)
    buckets = {b: per_pri[i] for i, b in enumerate(BUCKET_PRIORITY)}
    covered = sum(per_pri)
    unaccounted = max(e2e - covered, 0.0)
    for name, secs in (extras or {}).items():
        if name in buckets and secs:
            buckets[name] += float(secs)
            e2e += float(secs)
    buckets["unaccounted"] = unaccounted
    tol = float(tolerance)
    closed = unaccounted <= max(tol * e2e, ABS_CLOSE_SLACK_S)
    ranked = sorted(buckets.items(), key=lambda kv: -kv[1])
    dominant, dom_s = ranked[0] if ranked else ("unaccounted", 0.0)
    share = (dom_s / e2e) if e2e > 0 else 0.0
    att = {
        "buckets": {b: round(s, 6) for b, s in buckets.items()},
        "e2e_s": round(e2e, 6),
        "unaccounted_s": round(unaccounted, 6),
        "closed": closed,
        "tolerance": tol,
        "dominant": dominant,
        "dominant_share": round(share, 4),
    }
    att["verdict"] = verdict_line(att)
    return att


def verdict_line(att: Dict[str, Any]) -> str:
    """The one-line diagnosis: '<label>: NN% of S s in <bucket>'."""
    dom = att.get("dominant") or "unaccounted"
    label = BUCKET_VERDICTS.get(dom, dom)
    share = float(att.get("dominant_share") or 0.0)
    e2e = float(att.get("e2e_s") or 0.0)
    line = f"{label}: {share:.0%} of {e2e:.1f} s in {dom}"
    if not att.get("closed", True):
        gap = float(att.get("unaccounted_s") or 0.0)
        line += f" (NOT CLOSED: {gap:.1f} s unaccounted)"
    return line


# ---------------------------------------------------------------------------
# Flight recorder — one query at a time owns it (trace._ACTIVE model)
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of a query's most recent spans + health/retry/
    cancel events.  Appends are lock-free deque pushes (deque.append
    is atomic) — the black box is cheap enough to leave on by
    default."""

    def __init__(self, query_id: int, ring_size: int = 256):
        self.query_id = query_id
        self.ring_size = max(8, int(ring_size))
        self.t_start = time.perf_counter()
        self.spans: deque = deque(maxlen=self.ring_size)
        self.events: deque = deque(maxlen=self.ring_size)

    # called from Tracer.end via the duck-typed ``recorder`` hook —
    # keep it to one append
    def record_span(self, span) -> None:
        self.spans.append((span.op, span.stage,
                           span.t0 - self.t_start, span.t1 - span.t0))

    def record_event(self, kind: str, payload: dict) -> None:
        self.events.append({
            "kind": kind,
            "t_s": round(time.perf_counter() - self.t_start, 6),
            **payload})

    def snapshot(self) -> Dict[str, Any]:
        return {
            "query_id": self.query_id,
            "ring_size": self.ring_size,
            "recent_spans": [
                {"op": op, "stage": stage, "t_s": round(t, 6),
                 "dur_s": round(d, 6)}
                for op, stage, t, d in list(self.spans)],
            "events": list(self.events),
        }


_ACTIVE: Optional[FlightRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def current() -> Optional[FlightRecorder]:
    return _ACTIVE


def start_query(query_id: int,
                ring_size: int = 256) -> Optional[FlightRecorder]:
    """Install a fresh recorder; None when another query owns it (a
    nested execution rides the owner, same as tracing)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            return None
        _ACTIVE = FlightRecorder(query_id, ring_size=ring_size)
        return _ACTIVE


def end_query(rec: Optional[FlightRecorder]) -> None:
    global _ACTIVE
    if rec is None:
        return
    with _ACTIVE_LOCK:
        if _ACTIVE is rec:
            _ACTIVE = None


def record_event(kind: str, payload: dict) -> None:
    """Event into the active query's ring, no-op otherwise — THE hook
    free-standing producers (retry policy, health evaluator, cancel
    path) use without carrying a recorder reference."""
    rec = _ACTIVE
    if rec is not None:
        rec.record_event(kind, payload)


# ---------------------------------------------------------------------------
# Black-box dumps — atomic, bounded, concurrent-safe
# ---------------------------------------------------------------------------

# one lock per dump directory: a dump's write and its eviction run under
# it, so that concurrent dumps never evict from a stale listing
_DIR_LOCKS: Dict[str, threading.Lock] = {}
_DIR_LOCKS_LOCK = threading.Lock()


def _dir_lock(dir_path: str) -> threading.Lock:
    key = os.path.abspath(dir_path)
    with _DIR_LOCKS_LOCK:
        lock = _DIR_LOCKS.get(key)
        if lock is None:
            lock = _DIR_LOCKS[key] = threading.Lock()
        return lock


def blackbox_path(dir_path: str, query_id: int) -> str:
    return os.path.join(dir_path, f"query-{query_id:06d}.blackbox.json")


def _evict_oldest(dir_path: str, max_dumps: int) -> None:
    """Keep at most ``max_dumps`` black boxes, oldest-first eviction by
    mtime — a crash-looping server must never flood the dump dir."""
    try:
        names = [n for n in os.listdir(dir_path)
                 if n.endswith(".blackbox.json")]
        if len(names) <= max_dumps:
            return
        full = [os.path.join(dir_path, n) for n in names]
        full.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in full[:len(full) - max_dumps]:
            try:
                os.unlink(p)
            except OSError:
                pass
    except OSError:
        pass


def dump_blackbox(dir_path: str, query_id: int, trigger: str,
                  attribution: Optional[Dict[str, Any]] = None,
                  recorder: Optional[FlightRecorder] = None,
                  extra: Optional[Dict[str, Any]] = None,
                  max_dumps: int = 64) -> Optional[str]:
    """Atomically write ``query-<id>.blackbox.json``.

    tmp + ``os.replace`` (a reader never sees a torn file; a crash
    mid-dump leaves only a uniquely named tmp, not a corrupt dump).  The
    tmp name carries the pid and random hex, and the directory's lock
    covers the write and the eviction, so that concurrent dumps into
    one directory never collide or evict each other.  Returns the path,
    None on failure: observability never fails the query, which covers
    the dump's ``OSError`` only."""
    import sys
    box = {
        "record": "blackbox",
        "query_id": query_id,
        "trigger": trigger,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if attribution is not None:
        box["attribution"] = attribution
        box["verdict"] = attribution.get("verdict")
    if recorder is not None:
        box["flight_recorder"] = recorder.snapshot()
    if extra:
        box.update(extra)
    try:
        os.makedirs(dir_path, exist_ok=True)
        final = blackbox_path(dir_path, query_id)
        tmp = os.path.join(
            dir_path,
            f".{os.path.basename(final)}.tmp-{os.getpid()}-"
            f"{uuid.uuid4().hex[:8]}")
        with _dir_lock(dir_path):
            try:
                with open(tmp, "w") as f:
                    json.dump(box, f, default=str)
                os.replace(tmp, final)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            _evict_oldest(dir_path, max_dumps)
        _TM_DUMPS.inc(trigger)
        return final
    except OSError as e:
        print(f"[tpuq] blackbox dump failed: {e}", file=sys.stderr,
              flush=True)
        return None


def note_unaccounted(seconds: float) -> None:
    if seconds > 0:
        _TM_UNACCOUNTED.inc(seconds)
