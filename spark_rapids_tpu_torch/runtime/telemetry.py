"""Process-wide telemetry: the metrics registry, the sampler, the
health evaluator.

The counterpart of the JAX package's ``runtime/telemetry.py``, with the
same metric names and help strings (``tpuq_*``), so that one dashboard
reads both.  [REF: sql-plugin/../GpuSemaphore.scala wait metrics,
spill/SpillFramework.scala accounting, GpuMetrics levels]

The tracer (``runtime/trace.py``) is query-scoped; this module is its
process-scoped counterpart: one ``MetricsRegistry`` (``REGISTRY``) of
counters, gauges and histograms that the runtime's subsystems update on
their hot paths (the memory arbiter, the device semaphore, the kernel
build cache, the shape plane, the kernel plane's dispatches, the host
shuffle, the failure domains, cancellation, lockdep).  Two kept
deviations: ``tpuq_kernel_dispatch_total`` is labelled by the port's
rungs (``cuda``, ``jnp``), and ``tpuq_kernel_compile_total`` /
``tpuq_kernel_compile_seconds_total`` count library builds
(``kernel_cache.note_build``), so that the compile-storm check sees
builds.

* **cheap on the hot path**: a counter ``inc`` is one lock and one
  add; gauges are pulled (a callable reads live state at snapshot
  time, producers pay nothing).
* **import leaf**: this module imports nothing of the package at
  module level, so that any producer may import it.
* **never fails the query**: sink IO errors go to stderr and are
  swallowed, as ``trace.append_query_log``'s are.

Surfaces: ``REGISTRY.snapshot()`` and ``session.metrics_report()``; the
background sampler (``spark.rapids.tpu.telemetry.enabled``), which
appends one JSONL snapshot per ``samplePeriodMs`` to ``sinkPath`` and
rewrites ``promPath`` in the Prometheus text format; query windows
(``begin_query`` -> ``QueryWindow.finish``), the counter deltas of one
query, which the health evaluator reads.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# seconds-scale latency buckets (semaphore acquires, pump tasks)
DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0)


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    __slots__ = ("name", "doc", "_lock", "_value")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, v=1) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        return self._value


class LabeledCounter:
    """A counter *family* with one label dimension (Prometheus
    ``name{label="value"}`` children).  ``labels(v)`` returns the child
    ``Counter`` for that label value, creating it on first use — hot
    paths hold the child reference and pay the same one-lock ``inc`` a
    plain counter costs.  The family itself reports the sum of its
    children."""

    __slots__ = ("name", "doc", "label", "_lock", "_children")

    def __init__(self, name: str, doc: str = "", label: str = "domain"):
        self.name = name
        self.doc = doc
        self.label = label
        self._lock = threading.Lock()
        self._children: Dict[str, Counter] = {}

    def child_name(self, value: str) -> str:
        return f'{self.name}{{{self.label}="{value}"}}'

    def labels(self, value: str) -> Counter:
        with self._lock:
            c = self._children.get(value)
            if c is None:
                c = Counter(self.child_name(value), self.doc)
                self._children[value] = c
            return c

    def inc(self, value: str, v=1) -> None:
        self.labels(value).inc(v)

    @property
    def value(self):
        with self._lock:
            return sum(c.value for c in self._children.values())

    def child_values(self) -> Dict[str, float]:
        """label value → count, only children that exist."""
        with self._lock:
            return {lv: c.value for lv, c in self._children.items()}

    def sample_items(self) -> List[Tuple[str, float]]:
        """(exposition sample name, value) per child, sorted."""
        with self._lock:
            return sorted((c.name, c.value)
                          for c in self._children.values())


class Gauge:
    """Point-in-time value; ``fn``-backed gauges pull live state at
    snapshot time so producers never pay a per-update cost."""

    __slots__ = ("name", "doc", "_fn", "_value")

    def __init__(self, name: str, doc: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.doc = doc
        self._fn = fn
        self._value = 0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return 0
        return self._value


class Histogram:
    """Fixed cumulative buckets for Prometheus export plus a bounded
    reservoir of recent observations for percentile snapshots."""

    __slots__ = ("name", "doc", "buckets", "_lock", "_bucket_counts",
                 "count", "sum", "min", "max", "_reservoir", "_rpos",
                 "_rcap")

    def __init__(self, name: str, doc: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 reservoir: int = 512):
        self.name = name
        self.doc = doc
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        self._rpos = 0
        self._rcap = reservoir

    def observe(self, v: float) -> None:
        with self._lock:
            self._bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._reservoir) < self._rcap:
                self._reservoir.append(v)
            else:  # bounded ring of the most recent observations
                self._reservoir[self._rpos] = v
                self._rpos = (self._rpos + 1) % self._rcap

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._reservoir:
                return 0.0
            s = sorted(self._reservoir)
            return s[min(len(s) - 1, int(q * len(s)))]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            s = sorted(self._reservoir)

            def pct(q):
                return s[min(len(s) - 1, int(q * len(s)))]

            return {"count": self.count, "sum": round(self.sum, 9),
                    "min": round(self.min, 9), "max": round(self.max, 9),
                    "p50": round(pct(0.50), 9),
                    "p95": round(pct(0.95), 9),
                    "p99": round(pct(0.99), 9)}

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending at +Inf."""
        with self._lock:
            out, acc = [], 0
            for ub, c in zip(self.buckets, self._bucket_counts):
                acc += c
                out.append((ub, acc))
            out.append((math.inf, self.count))
            return out


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return format(f, ".10g")


class MetricsRegistry:
    """Name → metric; registration is idempotent (same name returns the
    existing instance) so producer modules may register at import time
    in any order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._health: List[dict] = []  # recent health events (bounded)
        self.HEALTH_CAP = 64

    def _get_or_create(self, name, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._get_or_create(name, Counter,
                                   lambda: Counter(name, doc))

    def labeled_counter(self, name: str, doc: str = "",
                        label: str = "domain") -> LabeledCounter:
        return self._get_or_create(
            name, LabeledCounter, lambda: LabeledCounter(name, doc, label))

    def gauge(self, name: str, doc: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(name, Gauge,
                                   lambda: Gauge(name, doc, fn))

    def histogram(self, name: str, doc: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, doc, buckets))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def catalog(self) -> Dict[str, Tuple[str, str]]:
        """name → (kind, doc) — the drift check's source of truth."""
        with self._lock:
            return {n: (type(m).__name__.lower(), m.doc)
                    for n, m in sorted(self._metrics.items())}

    def snapshot(self) -> Dict[str, object]:
        """Flat name → value (histograms: summary dicts)."""
        with self._lock:
            metrics = list(self._metrics.items())
        out = {}
        for name, m in sorted(metrics):
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            elif isinstance(m, LabeledCounter):
                for child, v in m.sample_items():
                    out[child] = v
            else:
                out[name] = m.value
        return out

    def counter_values(self) -> Dict[str, float]:
        """Plain counters by name plus every labeled-family child by its
        exposition sample name (``name{label="v"}``) — the flat space
        query windows diff."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, float] = {}
        for m in metrics:
            if isinstance(m, Counter):
                out[m.name] = m.value
            elif isinstance(m, LabeledCounter):
                for child, v in m.sample_items():
                    out[child] = v
        return out

    def prometheus_text(self) -> str:
        """Text exposition format: one HELP/TYPE pair per family, then
        the samples; histograms expand to _bucket/_sum/_count."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            doc = (m.doc or name).replace("\\", "\\\\").replace(
                "\n", "\\n")
            lines.append(f"# HELP {name} {doc}")
            if isinstance(m, LabeledCounter):
                lines.append(f"# TYPE {name} counter")
                for child, v in m.sample_items():
                    lines.append(f"{child} {_fmt(v)}")
            elif isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                for ub, acc in m.cumulative_buckets():
                    lines.append(
                        f'{name}_bucket{{le="{_fmt(ub)}"}} {acc}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def record_health(self, event: dict) -> None:
        with self._lock:
            self._health.append(event)
            if len(self._health) > self.HEALTH_CAP:
                del self._health[:-self.HEALTH_CAP]
        # flight recorder (runtime/attribution.py): health verdicts
        # join the active query's black-box ring.  Lazy import —
        # attribution imports this module at its top level.
        from spark_rapids_tpu_torch.runtime import attribution
        attribution.record_event("health", dict(event))

    def recent_health(self) -> List[dict]:
        with self._lock:
            return list(self._health)


REGISTRY = MetricsRegistry()

# registry-owned metrics (producers own the rest)
_QUERIES = REGISTRY.counter(
    "tpuq_queries_total", "queries executed (toArrow/collect)")
_HEALTH_WARNS = REGISTRY.counter(
    "tpuq_health_warn_total", "health-evaluator WARN events emitted")


def ensure_producers() -> None:
    """Import every producer module so its registrations exist — the
    complete catalog for ``metrics_report`` and the docs drift check
    (registration is import-time; a cold process that never shuffled
    would otherwise miss the shuffle family)."""
    import importlib
    for mod in ("runtime.cancel", "runtime.memory", "runtime.semaphore",
                "runtime.attribution", "runtime.kernel_cache",
                "runtime.resilience", "runtime.lockdep", "runtime.shapes",
                "adaptive", "shuffle.manager", "shuffle.exchange",
                "parallel.executor", "parallel.shuffle",
                "parallel.rendezvous", "exec.distributed", "kernels",
                "cache", "fusion"):
        try:
            importlib.import_module(f"spark_rapids_tpu_torch.{mod}")
        except Exception as e:  # never fail a report over one producer
            print(f"telemetry: cannot import producer {mod}: {e}",
                  file=sys.stderr)


# ---------------------------------------------------------------------------
# sinks: JSONL time series + Prometheus text dump
# ---------------------------------------------------------------------------

def flush_sinks(sink_path: str, prom_path: str) -> None:
    """One snapshot: append a JSONL record, rewrite the prom dump
    atomically.  IO failures must never fail the caller."""
    snap = REGISTRY.snapshot()
    ts = time.time()
    if sink_path:
        try:
            d = os.path.dirname(sink_path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(sink_path, "a") as f:
                f.write(json.dumps(
                    {"ts": time.strftime("%Y-%m-%dT%H:%M:%S%z",
                                         time.localtime(ts)),
                     "unix_ms": int(ts * 1000),
                     "metrics": snap}) + "\n")
        except OSError as e:
            print(f"telemetry: cannot append {sink_path}: {e}",
                  file=sys.stderr)
    if prom_path:
        try:
            d = os.path.dirname(prom_path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(REGISTRY.prometheus_text())
            os.replace(tmp, prom_path)
        except OSError as e:
            print(f"telemetry: cannot write {prom_path}: {e}",
                  file=sys.stderr)


class TelemetrySampler(threading.Thread):
    """Daemon thread flushing the sinks every ``period_s``."""

    def __init__(self, period_s: float, sink_path: str, prom_path: str):
        super().__init__(name="tpuq-telemetry", daemon=True)
        self.period_s = max(0.01, period_s)
        self.sink_path = sink_path
        self.prom_path = prom_path
        # NB: not named _stop — Thread.join() calls a private method of
        # that name on CPython
        self._halt = threading.Event()

    def run(self):
        flush_sinks(self.sink_path, self.prom_path)
        # cancel-exempt: daemon sampler, no query scope — halts via its own event
        while not self._halt.wait(self.period_s):
            flush_sinks(self.sink_path, self.prom_path)

    def stop(self, final_flush: bool = True):
        self._halt.set()
        self.join(timeout=5)
        if final_flush:
            flush_sinks(self.sink_path, self.prom_path)


_sampler: Optional[TelemetrySampler] = None
_sampler_lock = threading.Lock()


def configure_sampler(conf) -> Optional[TelemetrySampler]:
    """Start (or retarget) the process sampler per session conf; a conf
    with telemetry disabled leaves a running sampler alone (another
    session owns it)."""
    from spark_rapids_tpu_torch import conf as C
    global _sampler
    if not conf.get(C.TELEMETRY_ENABLED):
        return _sampler
    ensure_producers()
    period = float(conf.get(C.TELEMETRY_PERIOD_MS)) / 1000.0
    sink = str(conf.get(C.TELEMETRY_SINK_PATH))
    prom = str(conf.get(C.TELEMETRY_PROM_PATH))
    with _sampler_lock:
        s = _sampler
        if (s is not None and s.is_alive()
                and (s.period_s, s.sink_path, s.prom_path)
                == (max(0.01, period), sink, prom)):
            return s
        if s is not None:
            s.stop(final_flush=False)
        _sampler = TelemetrySampler(period, sink, prom)
        _sampler.start()
        return _sampler


def stop_sampler() -> None:
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


# ---------------------------------------------------------------------------
# query windows + health evaluation
# ---------------------------------------------------------------------------

class QueryWindow:
    """Counter snapshot at query start; ``finish()`` yields the deltas
    this query contributed to the process-cumulative counters."""

    def __init__(self, query_id: int):
        self.query_id = query_id
        self.t0 = time.perf_counter()
        self._start = REGISTRY.counter_values()

    def finish(self) -> Tuple[Dict[str, float], float]:
        elapsed = time.perf_counter() - self.t0
        now = REGISTRY.counter_values()
        deltas = {}
        for name, v in now.items():
            d = v - self._start.get(name, 0)
            if d:
                deltas[name] = round(d, 9) if isinstance(d, float) else d
        return deltas, elapsed


def begin_query(query_id: int) -> QueryWindow:
    """Open a telemetry window and a semaphore stats window KEYED by
    this query id (overlapping queries each get their own
    ``max_holders``/``wait_time`` — the registry keeps the cumulative
    view).  Re-entrant under concurrency: every piece of per-query
    state this boundary touches is either per-``QueryWindow`` instance
    or keyed by ``query_id``; the only process-wide effect is the
    legacy serial-query semaphore window, which keyed readers ignore."""
    _QUERIES.inc()
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    sem = SEM.peek_semaphore()
    if sem is not None:
        sem.begin_query_stats(query_id)
    return QueryWindow(query_id)


def evaluate_health(deltas: Dict[str, float], elapsed_s: float, conf,
                    query_id: Optional[int] = None) -> List[dict]:
    """Threshold checks over one query's counter deltas.  Each breach
    is a structured WARN recorded in the registry and returned for the
    query event log [REF: the reference's driver-log WARN lines for
    spill/retry storms, machine-readable]."""
    from spark_rapids_tpu_torch import conf as C
    events = []

    def warn(check, value, threshold, detail):
        events.append({"severity": "WARN", "check": check,
                       "value": value, "threshold": threshold,
                       "query_id": query_id, "detail": detail})

    spill = (deltas.get("tpuq_spill_host_bytes_total", 0)
             + deltas.get("tpuq_spill_disk_bytes_total", 0))
    reserved = deltas.get("tpuq_hbm_reserve_bytes_total", 0)
    if spill:
        ratio = spill / reserved if reserved else math.inf
        thr = float(conf.get(C.HEALTH_SPILL_RATIO))
        if ratio > thr:
            warn("spill_ratio", round(min(ratio, 1e9), 6), thr,
                 f"spilled {spill} B against {reserved} B reserved — "
                 "working set exceeds the HBM budget; raise poolSize / "
                 "lower batchRows")
    wait = deltas.get("tpuq_semaphore_wait_seconds_total", 0.0)
    if wait and elapsed_s > 0:
        ratio = wait / elapsed_s
        thr = float(conf.get(C.HEALTH_SEM_WAIT_RATIO))
        if ratio > thr:
            warn("semaphore_saturation", round(ratio, 6), thr,
                 f"tasks blocked {wait:.3f}s on device admission over a "
                 f"{elapsed_s:.3f}s query — concurrentGpuTasks is the "
                 "bottleneck")
    compiles = deltas.get("tpuq_kernel_compile_total", 0)
    thr = int(conf.get(C.HEALTH_COMPILE_STORM))
    if compiles > thr:
        warn("compile_storm", compiles, thr,
             f"{compiles} kernel library builds in one query — the "
             "build cache (spark.rapids.tpu.kernel.cacheDir) is not "
             "being reused")
    degraded = deltas.get("tpuq_host_degraded_ops_total", 0)
    if degraded:
        warn("host_degraded", degraded, 0,
             f"{degraded} device step(s) re-ran on the host path after "
             "retry exhaustion tripped a circuit breaker — see "
             "docs/resilience.md")
    shed = sum(v for name, v in deltas.items()
               if name.startswith("tpuq_admission_shed_total"))
    if shed:
        warn("admission_shed", shed, 0,
             f"{shed} submission(s) were load-shed by admission control "
             "while this query ran — the service is saturated; see "
             "docs/serving.md for the watermark tuning guide")
    for e in events:
        _HEALTH_WARNS.inc()
        REGISTRY.record_health(e)
    return events
