"""Per-operator runtime statistics — the stats plane.

The counterpart of the JAX package's ``runtime/stats.py``, with the
same record format.  [REF: the reference's qualification/profiling
tools, which post-process event logs into per-operator analyses, and
its AQE layer, which re-plans from observed map-output statistics]
One collection plane, four readers:

* **human**: ``df.explain("analyze")`` renders the plan annotated with
  observed rows/bytes/batches and the trace rollup's self time, and
  ``session.last_query_profile()`` returns the same record;
* **AQE**: exchanges record per-partition row counts here and
  ``TpuAQEShuffleReadExec`` prefers them over a fresh device count;
* **regression gate**: every query appends a profile record to the
  JSONL profile store (``spark.rapids.tpu.stats.storePath``) keyed by a
  stable plan-node signature, which ``utils/profile.py diff`` compares
  across runs;
* **planners** (later): the store outlives sessions.

Collection sits at every ``ExecNode`` pump boundary (the wrapper chain
of ``exec/base.py``).  One collector is active per query (a module
global, as in ``runtime/trace.py``); a nested execution rides its
owner's.

Cost: observing a DeviceBatch costs one host read of its live-row count
(``num_rows_host``); ``level=FULL`` adds one more for the null counts of
all its nullable columns together.  Off by default.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# The stats-field catalog: every key a profile record's per-op entry (or
# exchange summary) may carry — the JAX package's keys, so that records
# of both packages read alike.
STATS_FIELDS = {
    "op": "exec class name",
    "sig": "stable plan-node signature (op + tree path + schema)",
    "path": "pre-order tree path of the node (root = '0')",
    "rows_out": "live rows observed leaving the operator",
    "batches_out": "batches observed leaving the operator",
    "bytes_out": "physical bytes of the observed output batches",
    "rows_in": "sum of the children's rows_out",
    "bytes_in": "sum of the children's bytes_out",
    "batches_in": "sum of the children's batches_out",
    "batch_rows_hist": "pow-2 histogram of observed batch row counts",
    "padded_rows": "dead rows the shape plane appended to this "
                   "operator's output batches (bucket padding)",
    "null_ratio": "per-column observed null fraction (level=FULL)",
    "partition_rows": "per-partition live-row counts at an exchange",
    "partition_bytes": "per-partition byte sizes at an exchange",
    "skew_factor": "max/mean over an exchange's partition sizes",
    "skewed": "skew_factor exceeded spark.rapids.tpu.stats.skewThreshold",
    "executors": "executor processes whose counts were merged (ICI)",
    "self_s": "operator self-time from the trace rollup (traced runs)",
    "total_s": "operator total time from the trace rollup (traced runs)",
    "fused": "operator was fused into its consumer's kernel (stays zero)",
    "fused_region": "signature of the enclosing FusedStageExec on the "
                    "synthetic per-member records a fused region emits "
                    "(the member keeps its pre-fusion sig/path, so "
                    "profile diff lines it up with unfused history)",
    "region_ops": "member operators in this fused region's one cached "
                  "callable (FusedStageExec records only)",
    "region_compile_s": "seconds of this fused region's CUDA graph "
                        "captures (regionCompileTime)",
    "kernel_backend": "kernel-plane backend that produced this "
                      "operator's results (cuda/jnp; 'mixed' "
                      "when dispatches disagreed across batches)",
    "adaptive": "adaptive-plane decisions applied at this operator "
                "(kind + triggering stat + chosen action)",
}

_HIST_CAP = 1 << 30


def _hist_bucket(n: int) -> str:
    """Pow-2 bucket label for a batch row count ("0", "1-2", "3-4",
    "5-8", ...) — coarse enough to stay tiny, fine enough to show
    degenerate batch shapes (the 1-row-per-batch pathology)."""
    if n <= 0:
        return "0"
    hi = 1
    while hi < n and hi < _HIST_CAP:
        hi <<= 1
    return f"{hi // 2 + 1}-{hi}" if hi > 1 else "1"


def skew_factor(counts: Sequence[float]) -> float:
    """max/mean over partition sizes; 1.0 for empty or all-zero (a
    uniform nothing is not skewed)."""
    counts = [float(c) for c in counts]
    if not counts:
        return 1.0
    total = sum(counts)
    if total <= 0:
        return 1.0
    mean = total / len(counts)
    return max(counts) / mean


def merge_partition_counts(per_executor: Iterable[Sequence[int]]
                           ) -> List[int]:
    """Element-wise sum of each executor's per-partition counts — the
    merge of counts that rode a rendezvous allgather (every executor's
    ICI exchange records the cluster-wide view, ``executors=`` the
    number merged).  Ragged replies are an executor-desync bug; fail
    loudly."""
    merged: List[int] = []
    for counts in per_executor:
        counts = list(counts)
        if not merged:
            merged = [int(c) for c in counts]
            continue
        if len(counts) != len(merged):
            raise ValueError(
                f"per-executor partition counts disagree on width "
                f"({len(counts)} vs {len(merged)}) — executors ran "
                "different plans")
        for i, c in enumerate(counts):
            merged[i] += int(c)
    return merged


def plan_signature(op: str, path: str, schema) -> str:
    """Stable plan-node signature: op class + pre-order tree path +
    output schema field names.  Deterministic across processes and
    sessions (no ids, no memory addresses), so profile-store records of
    the same plan shape compare across runs."""
    try:
        fields = ",".join(schema.field_names())
    except Exception:
        fields = ""
    return hashlib.sha1(
        f"{path}/{op}({fields})".encode()).hexdigest()[:12]


class NodeStats:
    """Observed statistics of ONE plan node (all partitions).

    Pump threads update concurrently — one lock per node, so unrelated
    nodes never contend (same policy as exec.base.Metric)."""

    __slots__ = ("rows", "batches", "bytes", "hist", "nulls", "observed",
                 "partitions", "partition_unit", "executors", "padded",
                 "kernel_backend", "decisions", "_lock")

    def __init__(self):
        self.rows = 0
        self.batches = 0
        self.bytes = 0
        self.padded = 0
        self.kernel_backend: Optional[str] = None
        self.hist: Dict[str, int] = {}
        # col name -> [null count, rows observed]
        self.nulls: Dict[str, List[int]] = {}
        self.observed = 0  # rows scanned for null ratios
        self.partitions: Optional[List[int]] = None
        self.partition_unit = "rows"
        self.executors = 1
        # adaptive-plane decisions applied at this node, in order
        self.decisions: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def add_batch(self, n: int, nbytes: int,
                  null_counts: Optional[Dict[str, int]] = None) -> None:
        b = _hist_bucket(n)
        with self._lock:
            self.rows += n
            self.batches += 1
            self.bytes += nbytes
            self.hist[b] = self.hist.get(b, 0) + 1
            if null_counts is not None:
                self.observed += n
                for name, nc in null_counts.items():
                    slot = self.nulls.setdefault(name, [0, 0])
                    slot[0] += nc
                    slot[1] += n

    def add_padded(self, n: int) -> None:
        with self._lock:
            self.padded += int(n)

    def set_kernel_backend(self, backend: str) -> None:
        with self._lock:
            if self.kernel_backend is None:
                self.kernel_backend = backend
            elif self.kernel_backend != backend:
                # per-batch fallbacks can land different rungs on one op
                self.kernel_backend = "mixed"

    def add_decision(self, kind: str, detail: Dict[str, Any]) -> None:
        with self._lock:
            self.decisions.append({"kind": kind, **detail})

    def set_partitions(self, counts: Sequence[int], unit: str,
                       executors: int = 1) -> None:
        with self._lock:
            self.partitions = [int(c) for c in counts]
            self.partition_unit = unit
            self.executors = executors



class OpStatsCollector:
    """Stats of ONE query execution, keyed by plan-node identity.

    ``observe`` is called from the auto-wired pump boundary for every
    batch an operator yields; exchanges additionally call
    ``record_partitions`` with their measured per-partition sizes.
    ``report(plan)`` walks the plan pre-order and assembles the profile
    record (zeroed entries for nodes that never pumped — empty inputs
    and fused operators produce valid records, not holes)."""

    def __init__(self, query_id: int, level: str = "BASIC",
                 skew_threshold: float = 2.0):
        self.query_id = query_id
        self.level = str(level).upper()
        self.skew_threshold = float(skew_threshold)
        self._nodes: Dict[int, NodeStats] = {}
        self._refs: List[Any] = []  # keep nodes alive: id() stays unique
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def node_stats(self, node) -> NodeStats:
        key = id(node)
        ns = self._nodes.get(key)
        if ns is None:
            with self._lock:
                ns = self._nodes.get(key)
                if ns is None:
                    ns = NodeStats()
                    self._nodes[key] = ns
                    self._refs.append(node)
        return ns

    def observe(self, node, batch) -> None:
        """Record one pumped batch.  Duck-typed over the two batch
        kinds, so that this module imports neither torch nor the
        columnar layer at module scope."""
        ns = self.node_stats(node)
        sel = getattr(batch, "sel", None)
        if sel is not None:  # DeviceBatch
            n = int(batch.num_rows_host())
            nb = int(batch.nbytes())
            ns.add_batch(n, nb, self._device_nulls(batch, n))
            return
        nr = getattr(batch, "num_rows", None)
        if nr is None:  # unknown batch kind: count it, nothing else
            ns.add_batch(0, 0)
            return
        n = int(nr)
        nb = 0
        cols = getattr(batch, "columns", ())
        for c in cols:
            data = getattr(c, "data", None)
            if data is not None and hasattr(data, "nbytes"):
                nb += int(data.nbytes)
            v = getattr(c, "validity", None)
            if v is not None and hasattr(v, "nbytes"):
                nb += int(v.nbytes)
        ns.add_batch(n, nb, self._host_nulls(batch, n))

    def _device_nulls(self, batch, n: int) -> Optional[Dict[str, int]]:
        if self.level != "FULL" or n == 0:
            return None
        import torch
        names = batch.schema.field_names()
        out: Dict[str, int] = {name: 0 for name in names}
        nullable = [(name, c) for name, c in zip(names, batch.columns)
                    if c.validity is not None]
        if nullable:
            # one host read for every nullable column's count
            counts = torch.stack([(batch.sel & ~c.validity).sum()
                                  for _, c in nullable]).tolist()
            for (name, _), nc in zip(nullable, counts):
                out[name] = int(nc)
        return out

    def _host_nulls(self, batch, n: int) -> Optional[Dict[str, int]]:
        if self.level != "FULL" or n == 0:
            return None
        out: Dict[str, int] = {}
        names = batch.schema.field_names()
        for name, c in zip(names, batch.columns):
            v = getattr(c, "validity", None)
            out[name] = 0 if v is None else int((~v).sum())
        return out

    def record_partitions(self, node, counts: Sequence[int],
                          unit: str = "rows",
                          executors: int = 1) -> None:
        """Per-partition sizes measured at an exchange boundary (already
        cluster-merged when ``executors`` > 1)."""
        self.node_stats(node).set_partitions(counts, unit, executors)

    def record_decision(self, node, kind: str,
                        detail: Dict[str, Any]) -> None:
        """One adaptive-plane decision applied at ``node`` (the
        adaptive plane calls this through
        ``adaptive.record_decision``, which also bumps the telemetry
        counter)."""
        self.node_stats(node).add_decision(kind, detail)

    # -- AQE read side ------------------------------------------------------
    def partition_counts(self, node
                         ) -> Optional[Tuple[str, List[int]]]:
        """``(unit, sizes)`` previously recorded for ``node``, or None —
        the shaped-read planner consults this before paying for a fresh
        device count."""
        ns = self._nodes.get(id(node))
        if ns is None or ns.partitions is None:
            return None
        return ns.partition_unit, list(ns.partitions)

    def observed(self, node) -> Optional[Tuple[int, int]]:
        """``(rows, bytes)`` observed leaving ``node`` so far, or None
        when the node never pumped — the batch-retargeting input (the
        adaptive read replans from recorded observations, never a
        fresh device read)."""
        ns = self._nodes.get(id(node))
        if ns is None:
            return None
        return ns.rows, ns.bytes

    # -- reporting ----------------------------------------------------------
    def report(self, plan, rollup: Optional[dict] = None,
               wall_s: Optional[float] = None) -> Dict[str, Any]:
        """The structured profile record: pre-order per-op entries plus
        an exchange skew summary.  ``rollup`` is the PR-1 tracer's
        per-op self/total-time map (absent on untraced runs)."""
        ops: List[dict] = []
        exchanges: List[dict] = []

        def walk(node, path: str):
            ns = self._nodes.get(id(node)) or NodeStats()
            rec: Dict[str, Any] = {
                "op": node.name,
                "sig": plan_signature(node.name, path, node.schema),
                "path": path,
                "rows_out": ns.rows,
                "batches_out": ns.batches,
                "bytes_out": ns.bytes,
                "rows_in": sum(
                    (self._nodes.get(id(c)) or NodeStats()).rows
                    for c in node.children),
                "bytes_in": sum(
                    (self._nodes.get(id(c)) or NodeStats()).bytes
                    for c in node.children),
                "batches_in": sum(
                    (self._nodes.get(id(c)) or NodeStats()).batches
                    for c in node.children),
                "batch_rows_hist": dict(sorted(
                    ns.hist.items(),
                    key=lambda kv: 0 if kv[0] == "0"
                    else int(kv[0].split("-")[0]))),
            }
            if ns.padded:
                rec["padded_rows"] = ns.padded
            if ns.kernel_backend is not None:
                rec["kernel_backend"] = ns.kernel_backend
            fused = getattr(node, "metrics", {}).get("fusedIntoConsumer")
            if fused is not None and fused.value:
                rec["fused"] = True
            if ns.nulls:
                rec["null_ratio"] = {
                    name: round(nc / max(tot, 1), 6)
                    for name, (nc, tot) in sorted(ns.nulls.items())}
            if ns.partitions is not None:
                key = ("partition_rows" if ns.partition_unit == "rows"
                       else "partition_bytes")
                rec[key] = list(ns.partitions)
                sf = skew_factor(ns.partitions)
                rec["skew_factor"] = round(sf, 4)
                rec["skewed"] = sf > self.skew_threshold
                if ns.executors > 1:
                    rec["executors"] = ns.executors
                exchanges.append({
                    "op": rec["op"], "sig": rec["sig"],
                    "path": path,
                    "unit": ns.partition_unit,
                    "partitions": len(ns.partitions),
                    "max": max(ns.partitions, default=0),
                    "total": sum(ns.partitions),
                    "skew_factor": rec["skew_factor"],
                    "skewed": rec["skewed"],
                    "executors": ns.executors,
                })
            if ns.decisions:
                rec["adaptive"] = [dict(d) for d in ns.decisions]
            if rollup:
                r = rollup.get(node.name)
                if r is not None:
                    rec["self_s"] = r.get("self_s")
                    rec["total_s"] = r.get("total_s")
            ops.append(rec)
            members = getattr(node, "fusion_members", None)
            if members:
                rec["region_ops"] = len(members)
                ct = getattr(node, "metrics", {}).get("regionCompileTime")
                if ct is not None and ct.value:
                    rec["region_compile_s"] = round(float(ct.value), 6)
                # synthetic per-member records: each member keeps the
                # signature/path it would have carried unfused, so
                # `profile diff` compares fused runs against unfused
                # history; region time splits evenly over the members
                share = (rec["self_s"] / len(members)
                         if rec.get("self_s") is not None else None)
                for m in members:
                    mrec: Dict[str, Any] = {
                        "op": m["op"], "sig": m["sig"], "path": m["path"],
                        "fused": True, "fused_region": rec["sig"],
                        "rows_out": 0, "batches_out": 0, "bytes_out": 0,
                        "rows_in": 0, "bytes_in": 0, "batches_in": 0,
                        "batch_rows_hist": {},
                    }
                    if share is not None:
                        mrec["self_s"] = share
                        mrec["total_s"] = share
                    ops.append(mrec)
            for i, c in enumerate(node.children):
                walk(c, f"{path}.{i}")

        walk(plan, "0")
        out: Dict[str, Any] = {
            "record": "profile",
            "version": 1,
            "query_id": self.query_id,
            "level": self.level,
            "skew_threshold": self.skew_threshold,
            "ops": ops,
            "exchanges": exchanges,
        }
        decisions = [{"op": rec["op"], "sig": rec["sig"],
                      "path": rec["path"], **d}
                     for rec in ops for d in rec.get("adaptive", ())]
        if decisions:
            out["adaptive_decisions"] = decisions
        if wall_s is not None:
            out["wall_s"] = wall_s
        return out


# ---------------------------------------------------------------------------
# The active collector — one query at a time owns it
# ---------------------------------------------------------------------------

# Checked on every pump step; a bare module global keeps the off path to
# one attribute load (same shape as trace._ACTIVE).  A nested execution
# (sub-query planned mid-query) rides the owner's collector.
_ACTIVE: Optional[OpStatsCollector] = None
_ACTIVE_LOCK = threading.Lock()


def current() -> Optional[OpStatsCollector]:
    return _ACTIVE


def start_query(query_id: int, level: str = "BASIC",
                skew_threshold: float = 2.0
                ) -> Optional[OpStatsCollector]:
    """Install a fresh collector; returns None when another query
    already owns stats collection (the caller is a nested execution)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            return None
        _ACTIVE = OpStatsCollector(query_id, level=level,
                                   skew_threshold=skew_threshold)
        return _ACTIVE


def end_query(collector: Optional[OpStatsCollector]) -> None:
    global _ACTIVE
    if collector is None:
        return
    with _ACTIVE_LOCK:
        if _ACTIVE is collector:
            _ACTIVE = None


# ---------------------------------------------------------------------------
# The persistent profile store
# ---------------------------------------------------------------------------

def append_profile(path: str, record: Dict[str, Any]) -> None:
    """One JSONL profile record per query; same swallow-to-stderr policy
    as the query event log (observability must never fail the query)."""
    from spark_rapids_tpu_torch.runtime import trace
    trace.append_query_log(path, record)


def load_profiles(path: str) -> List[Dict[str, Any]]:
    """Every profile record in a store file (bad lines are skipped — a
    torn concurrent append must not invalidate the whole store)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out
