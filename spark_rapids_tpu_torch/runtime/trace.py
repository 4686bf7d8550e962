"""Query-scoped span tracing and the persistent query event log.

The counterpart of the JAX package's ``runtime/trace.py``, with the
same names and file formats.  [REF: sql-plugin/../GpuMetrics.scala ::
NvtxRange / NvtxWithMetrics]: every exec's partition pump and its
internal stages (library builds, H2D transfer, device work, D2H, the
host shuffle, spill and restore) open spans on a per-query ``Tracer``.
Spans nest per thread (the pump's task threads each keep their own
stack) and accumulate their children's time, so that each operator's
self time is its span time less its children's.  They export as
Chrome-trace JSON (``chrome://tracing``, Perfetto).

Spans time the host.  A CUDA launch returns before its kernel has run,
so device time lands in whichever span waits for the device: a
device-to-host copy, an ``.item()``, the root's Arrow conversion.  No
span synchronizes the device to make its own time "truer".

The event log is one JSONL entry per query
(``spark.rapids.sql.queryLog.path``): the plan tree, the fallback
report of ``plan/overrides.py``, every metric at its level, the span
rollup and links to the profile capture and the trace file.  Query ids
come from ``next_query_id``, so that the trace file, the query log, the
profile store and the black box of one query carry the same id.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Span:
    """One timed range on one thread.  ``child_time`` accumulates the
    durations of directly-nested spans (any operator), so
    ``self_time = dur - child_time`` is this span's exclusive time."""

    __slots__ = ("op", "stage", "tid", "t0", "t1", "child_time",
                 "parent_op", "args")

    def __init__(self, op: str, stage: str, tid: int, t0: float,
                 parent_op: Optional[str], args: Optional[dict]):
        self.op = op
        self.stage = stage
        self.tid = tid
        self.t0 = t0
        self.t1 = t0
        self.child_time = 0.0
        self.parent_op = parent_op
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    @property
    def self_time(self) -> float:
        return max(self.dur - self.child_time, 0.0)


class _SpanCtx:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        self._tracer.end(self._span)
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class Tracer:
    """Thread-safe span collector for ONE query execution.

    Every thread keeps its own span stack (``threading.local``), so
    pump iterators nest correctly across the executor thread pool: a
    child operator's ``next()`` runs inside its consumer's span on the
    SAME thread and its duration subtracts from the consumer's
    self-time.  Spans on a pool thread with no enclosing span start a
    fresh top-level track for that thread."""

    def __init__(self, query_id: int, max_events: int = 100_000):
        self.query_id = query_id
        self.max_events = max_events
        self.t_start = time.perf_counter()
        self.wall_s: Optional[float] = None
        self.dropped = 0
        self.events: List[Span] = []
        # duck-typed flight-recorder hook (runtime/attribution.py):
        # when set, every closed span also lands in the recorder's
        # bounded ring — one extra deque append, no new timers
        self.recorder = None
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, op: str, stage: str,
              args: Optional[dict] = None) -> Span:
        st = self._stack()
        parent_op = st[-1].op if st else None
        sp = Span(op, stage, threading.get_ident(), time.perf_counter(),
                  parent_op, args)
        st.append(sp)
        return sp

    def end(self, span: Span) -> None:
        span.t1 = time.perf_counter()
        st = self._stack()
        # pop back to (and including) this span — tolerate a leaked
        # child that never closed (generator dropped mid-pump)
        while st and st[-1] is not span:
            st.pop()
        if st:
            st.pop()
        if st:
            st[-1].child_time += span.dur
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(span)
            else:
                self.dropped += 1
        rec = self.recorder
        if rec is not None:
            rec.record_span(span)

    def span(self, op: str, stage: str, args: Optional[dict] = None):
        """Context manager recording one span."""
        return _SpanCtx(self, self.begin(op, stage, args))

    def finish(self) -> None:
        self.wall_s = time.perf_counter() - self.t_start

    # -- export -------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """The ``chrome://tracing`` / Perfetto JSON object format:
        complete ('X') events with microsecond timestamps relative to
        query start, one track per pump thread."""
        tids: Dict[int, int] = {}
        events: List[dict] = []
        with self._lock:
            spans = list(self.events)
        for sp in spans:
            tid = tids.setdefault(sp.tid, len(tids) + 1)
            ev = {
                "name": f"{sp.op}:{sp.stage}",
                "cat": sp.stage,
                "ph": "X",
                "ts": round((sp.t0 - self.t_start) * 1e6, 3),
                "dur": round(sp.dur * 1e6, 3),
                "pid": 1,
                "tid": tid,
            }
            if sp.args:
                ev["args"] = sp.args
            events.append(ev)
        for ident, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"pump-{tid}"
                         if tid > 1 else "query-main"},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "query_id": self.query_id,
                "dropped_spans": self.dropped,
            },
        }

    def rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-operator total vs self time derived from the span tree.

        ``total_s`` counts only spans NOT nested inside a span of the
        same operator (a pump span's internal opTime span must not
        double-count); ``self_s`` sums every span's exclusive time, so
        across all operators self times partition the traced wall time
        exactly — the attribution ``opTime`` alone cannot give."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            spans = list(self.events)
        for sp in spans:
            r = out.setdefault(sp.op, {
                "total_s": 0.0, "self_s": 0.0, "spans": 0, "stages": {}})
            r["spans"] += 1
            if sp.parent_op != sp.op:
                r["total_s"] += sp.dur
            r["self_s"] += sp.self_time
            st = r["stages"]
            st[sp.stage] = st.get(sp.stage, 0.0) + sp.self_time
        for r in out.values():
            r["total_s"] = round(r["total_s"], 6)
            r["self_s"] = round(r["self_s"], 6)
            r["stages"] = {k: round(v, 6)
                           for k, v in sorted(r["stages"].items())}
        return out


# ---------------------------------------------------------------------------
# The active tracer — one query at a time owns it
# ---------------------------------------------------------------------------

# Checked on every pump step, so it is a bare module global (one
# attribute load when tracing is off).  A second query starting while
# one is active (a sub-query planned during execution) rides the owner's
# spans instead of replacing the tracer.
_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()
_QUERY_IDS = itertools.count(1)


def next_query_id() -> int:
    return next(_QUERY_IDS)


def current() -> Optional[Tracer]:
    return _ACTIVE


def start_query(query_id: int, max_events: int = 100_000
                ) -> Optional[Tracer]:
    """Install a fresh tracer; returns None when another query already
    owns tracing (the caller is a nested execution)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            return None
        _ACTIVE = Tracer(query_id, max_events=max_events)
        return _ACTIVE


def end_query(tracer: Optional[Tracer]) -> None:
    global _ACTIVE
    if tracer is None:
        return
    tracer.finish()
    with _ACTIVE_LOCK:
        if _ACTIVE is tracer:
            _ACTIVE = None


def span(op: str, stage: str, args: Optional[dict] = None):
    """Span on the active tracer, or a no-op when tracing is off —
    THE hook free-standing stages (kernel compile, spill, shuffle
    serialize) use without carrying a tracer reference."""
    tr = _ACTIVE
    if tr is None:
        return _NULL
    return tr.span(op, stage, args)


# ---------------------------------------------------------------------------
# Query event log
# ---------------------------------------------------------------------------

def plan_metrics(plan) -> List[dict]:
    """Every node's metrics WITH their verbosity levels — the event log
    records all levels; readers filter."""
    out: List[dict] = []

    def walk(node):
        out.append({
            "op": type(node).__name__,
            "metrics": {
                name: {"value": (round(m.value, 6)
                                 if isinstance(m.value, float)
                                 else m.value),
                       "level": m.level}
                for name, m in getattr(node, "metrics", {}).items()},
        })
        for c in node.children:
            walk(c)

    walk(plan)
    return out


_LOG_LOCK = threading.Lock()


def append_query_log(path: str, entry: Dict[str, Any]) -> None:
    """Append one JSONL record; directory auto-created.  Failures are
    swallowed to stderr — observability must never fail the query."""
    import sys
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        line = json.dumps(entry, default=str)
        with _LOG_LOCK:
            with open(path, "a") as f:
                f.write(line + "\n")
    except OSError as e:
        print(f"[tpuq] query log write failed: {e}", file=sys.stderr,
              flush=True)


def write_chrome_trace(dir_path: str, tracer: Tracer) -> Optional[str]:
    """``<dir>/query-<id>.trace.json``; returns the path (None on
    failure)."""
    import sys
    try:
        os.makedirs(dir_path, exist_ok=True)
        out = os.path.join(dir_path,
                           f"query-{tracer.query_id:06d}.trace.json")
        with open(out, "w") as f:
            json.dump(tracer.to_chrome_trace(), f)
        return out
    except OSError as e:
        print(f"[tpuq] chrome trace write failed: {e}", file=sys.stderr,
              flush=True)
        return None
