"""Regression-diff profiler CLI over the engine's profile artifacts.

The counterpart of the JAX package's ``utils/profile.py``, with the
same reports, text and exit codes, so that either package's CLI reads
either package's files.  [REF: the reference's qualification/profiling
tool, which post-processes event logs into per-query analyses and
compares runs]  Four artifact kinds, detected per file:

* **profile store** (``spark.rapids.tpu.stats.storePath``): one JSONL
  record per query from the stats plane — per-op observed rows/bytes
  and traced self time keyed by stable plan-node signatures, plus the
  exchange skew summary;
* **query event log** (``spark.rapids.sql.queryLog.path``): JSONL
  entries whose ``op_rollup``/``op_stats``/``telemetry`` fields carry
  the same signals (and the build counter for the storm report: the
  port's ``tpuq_kernel_compile_total`` counts kernel library builds);
* **bench scoreboard** (``BENCH_*.json``): one JSON object whose
  ``tpch_sf1_op_rollup``/``tpch_sf1_stats`` maps key per-op records by
  query name, plus the ``tpch_sf1_compile`` cold-vs-warm split the
  ``storms`` report reads;
* **black box** (``query-<id>.blackbox.json``): the flight-recorder
  dump of a query that died (timeout, cancel, error) — ``why`` renders
  its ledger, verdict and last ring events.

Usage::

    python -m spark_rapids_tpu_torch.utils.profile top    <input> [--n N]
        [--adaptive] [--cache]
    python -m spark_rapids_tpu_torch.utils.profile why    <input>
        [--query Q]
    python -m spark_rapids_tpu_torch.utils.profile skew   <input>
    python -m spark_rapids_tpu_torch.utils.profile storms <input>
    python -m spark_rapids_tpu_torch.utils.profile diff   <a> <b>
        [--threshold R] [--min-self-s S]

``why`` answers "where did this query's wall time go": the attribution
ledger's exclusive buckets as a ranked table under the one-line verdict
("kernel-bound: 71% of 3.3 s in kernel_dispatch"), over any of the four
inputs — and for a timed-out query, the black box's last spans and
cancel/health events.  ``top --adaptive`` lists adaptive-plane
decisions and ``top --cache`` the result-cache report where the input
carries them.  ``diff`` compares per-op self times of two runs (keys
matched by plan signature when both sides have one) and exits 2 when
any op regressed by at least the threshold ratio; joins whose adaptive
strategy flipped are flagged as ``DECISION FLIP``.

The profiler that traces the TPC-H queries on the card with
``torch.profiler`` is ``utils/device_profile.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

EXIT_OK = 0
EXIT_BAD_INPUT = 1
EXIT_REGRESSION = 2


# ---------------------------------------------------------------------------
# Input loading + normalization
# ---------------------------------------------------------------------------

def _load_json_lines(path: str) -> List[dict]:
    out: List[dict] = []
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


def detect_kind(records: List[dict]) -> str:
    """profile-store | event-log | bench | blackbox, from record shape
    alone."""
    if any(r.get("record") == "blackbox" for r in records):
        return "blackbox"
    if len(records) == 1 and ("tpch_sf1_op_rollup" in records[0]
                              or "tpch_sf1_stats" in records[0]
                              or "metric" in records[0]):
        return "bench"
    if any(r.get("record") == "profile" for r in records):
        return "profile-store"
    if any("op_rollup" in r or "op_stats" in r or "plan" in r
           for r in records):
        return "event-log"
    raise ValueError("unrecognized input: neither a profile store, a "
                     "query event log, a BENCH_*.json scoreboard, nor "
                     "a query-*.blackbox.json dump")


def _op_key(rec: dict) -> str:
    """Diff key of a per-op record: signature-qualified when the record
    carries a stable signature (profile store), bare op name otherwise
    (event-log rollups)."""
    sig = rec.get("sig")
    return f"{rec['op']}[{sig}]" if sig else str(rec["op"])


def _norm_op(rec: dict) -> dict:
    return {
        "op": rec.get("op"),
        "sig": rec.get("sig"),
        "self_s": rec.get("self_s"),
        "total_s": rec.get("total_s"),
        "rows_out": rec.get("rows_out"),
        "bytes_out": rec.get("bytes_out"),
        "batches_out": rec.get("batches_out"),
    }


def load_runs(path: str) -> List[dict]:
    """Normalize any input into runs of shape
    ``{label, ops: {key: oprec}, exchanges: [..], compiles, wall_s}``.
    One run per query (profile store / event log) or per bench query."""
    if path.endswith(".json"):
        try:
            with open(path) as f:
                records = [json.load(f)]
        except ValueError:
            records = _load_json_lines(path)
    else:
        records = _load_json_lines(path)
    if not records:
        raise ValueError(f"{path}: no records")
    kind = detect_kind(records)
    runs: List[dict] = []
    if kind == "blackbox":
        for r in records:
            if r.get("record") != "blackbox":
                continue
            runs.append({"label": f"query {r.get('query_id')}",
                         "ops": {}, "exchanges": [], "compiles": None,
                         "wall_s": None, "decisions": [],
                         "attribution": r.get("attribution"),
                         "blackbox": r,
                         "status": r.get("status")})
        return runs
    if kind == "bench":
        b = records[0]
        rollups = b.get("tpch_sf1_op_rollup") or {}
        statses = b.get("tpch_sf1_stats") or {}
        compile_recs = b.get("tpch_sf1_compile") or {}
        atts = b.get("tpch_sf1_attribution") or {}
        boxes = b.get("tpch_sf1_blackbox") or {}
        for q in sorted(set(rollups) | set(statses) | set(compile_recs)
                        | set(atts) | set(boxes)):
            ops: Dict[str, dict] = {}
            for op, r in (rollups.get(q) or {}).items():
                ops[f"{q}/{op}"] = {"op": op, "sig": None,
                                    "self_s": r.get("self_s"),
                                    "total_s": r.get("total_s")}
            st = statses.get(q) or {}
            for rec in st.get("ops") or []:
                ops[f"{q}/{_op_key(rec)}"] = _norm_op(rec)
            crec = compile_recs.get(q)
            runs.append({"label": q, "ops": ops,
                         "exchanges": (st.get("exchanges") or []),
                         "compiles": (crec or {}).get("cold_compiles"),
                         "compile_rec": crec, "wall_s": None,
                         "decisions": st.get("adaptive_decisions") or [],
                         "attribution": atts.get(q),
                         "blackbox": boxes.get(q)})
        return runs
    for r in records:
        if kind == "profile-store":
            if r.get("record") != "profile":
                continue
            ops = {_op_key(o): _norm_op(o) for o in r.get("ops", [])}
            runs.append({"label": f"query {r.get('query_id')}",
                         "ops": ops,
                         "exchanges": r.get("exchanges") or [],
                         "compiles": None,
                         "wall_s": r.get("wall_s"),
                         "decisions": r.get("adaptive_decisions") or [],
                         "attribution": r.get("attribution")})
            continue
        # event log: prefer the stats plane's op_stats, fall back to
        # the trace rollup alone
        ops = {}
        for o in r.get("op_stats") or []:
            ops[_op_key(o)] = _norm_op(o)
        if not ops:
            for op, ru in (r.get("op_rollup") or {}).items():
                ops[op] = {"op": op, "sig": None,
                           "self_s": ru.get("self_s"),
                           "total_s": ru.get("total_s")}
        compiles = None
        tel = r.get("telemetry")
        if isinstance(tel, dict):
            compiles = tel.get("tpuq_kernel_compile_total")
        runs.append({"label": f"query {r.get('query_id')}",
                     "ops": ops,
                     "exchanges": r.get("exchange_stats") or [],
                     "compiles": compiles,
                     "wall_s": r.get("wall_s"),
                     "health": r.get("health") or [],
                     "decisions": r.get("adaptive_decisions") or [],
                     "cache": r.get("cache"),
                     "attribution": r.get("attribution"),
                     "blackbox_file": r.get("blackbox"),
                     "status": r.get("status")})
    return runs


def merge_ops(runs: List[dict]) -> Dict[str, dict]:
    """Sum self/total time (and max rows/bytes) per op key across a
    run set — the per-input aggregate the reports and diff work on."""
    out: Dict[str, dict] = {}
    for run in runs:
        for key, rec in run["ops"].items():
            slot = out.setdefault(key, {
                "op": rec.get("op"), "self_s": 0.0, "total_s": 0.0,
                "timed": False, "rows_out": rec.get("rows_out"),
                "bytes_out": rec.get("bytes_out")})
            if rec.get("self_s") is not None:
                slot["self_s"] += float(rec["self_s"])
                slot["timed"] = True
            if rec.get("total_s") is not None:
                slot["total_s"] += float(rec["total_s"])
            for f in ("rows_out", "bytes_out"):
                if rec.get(f) is not None:
                    slot[f] = max(slot.get(f) or 0, rec[f])
    return out


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def report_top(runs: List[dict], n: int) -> List[str]:
    ops = merge_ops(runs)
    timed = {k: v for k, v in ops.items() if v["timed"]}
    lines = [f"top {n} ops by self time over {len(runs)} run(s):"]
    if not timed:
        lines.append("  (no traced self-times in this input — run with "
                     "spark.rapids.sql.trace.enabled)")
        ranked = sorted(ops.items(),
                        key=lambda kv: -(kv[1].get("rows_out") or 0))[:n]
        for key, v in ranked:
            lines.append(f"  {key}: rows={v.get('rows_out')} "
                         f"bytes={v.get('bytes_out')}")
        return lines
    ranked = sorted(timed.items(), key=lambda kv: -kv[1]["self_s"])[:n]
    for key, v in ranked:
        extra = ""
        if v.get("rows_out") is not None:
            extra = f" rows={v['rows_out']}"
            if v.get("bytes_out") is not None:
                extra += f" bytes={v['bytes_out']}"
        lines.append(f"  {key}: self={v['self_s']:.6f}s "
                     f"total={v['total_s']:.6f}s{extra}")
    return lines


def _fmt_decision(d: dict) -> str:
    """One adaptive decision with its triggering stat, one line."""
    kind = d.get("kind")
    where = f"{d.get('op')}[{d.get('sig', '')}]"
    if kind in ("broadcast", "shuffled"):
        return (f"{where}: {kind} (build_bytes={d.get('build_bytes')} "
                f"threshold={d.get('threshold')} "
                f"source={d.get('source')})")
    if kind == "skew-split":
        return (f"{where}: skew-split (partitions={d.get('partitions')} "
                f"splits={d.get('splits')} rows={d.get('rows')} "
                f"skew={d.get('skew_factor')} "
                f"threshold={d.get('threshold')})")
    if kind == "batch-retarget":
        return (f"{where}: batch-retarget "
                f"(target_rows={d.get('target_rows')} "
                f"observed_row_bytes={d.get('observed_row_bytes')} "
                f"static_row_bytes={d.get('static_row_bytes')})")
    return f"{where}: {kind} ({d})"


def report_adaptive(runs: List[dict]) -> List[str]:
    lines = [f"adaptive decisions over {len(runs)} run(s):"]
    found = False
    for run in runs:
        for d in run.get("decisions") or []:
            found = True
            lines.append(f"  {run['label']} {_fmt_decision(d)}")
    if not found:
        lines.append("  (no adaptive decisions in this input — run "
                     "with spark.rapids.tpu.adaptive.enabled)")
    return lines


def report_cache(runs: List[dict]) -> List[str]:
    """Result-cache effectiveness per plan signature, from the event
    log's ``entry["cache"]`` records: hit rate, bytes saved (hit bytes
    served from host), and device-seconds avoided (the cold runtime
    each hit skipped)."""
    per_sig: Dict[str, dict] = {}
    seen = False
    for run in runs:
        c = run.get("cache")
        if not isinstance(c, dict) or "status" not in c:
            continue
        seen = True
        slot = per_sig.setdefault(c.get("signature", "?"), {
            "hits": 0, "misses": 0, "bytes_saved": 0,
            "device_s_avoided": 0.0})
        if c["status"] == "hit":
            slot["hits"] += 1
            slot["bytes_saved"] += int(c.get("bytes") or 0)
            slot["device_s_avoided"] += float(c.get("saved_s") or 0.0)
        else:
            slot["misses"] += 1
    lines = [f"result cache over {len(runs)} run(s):"]
    if not seen:
        lines.append("  (no cache records in this input — run with "
                     "spark.rapids.tpu.cache.enabled)")
        return lines
    total_h = sum(s["hits"] for s in per_sig.values())
    total_m = sum(s["misses"] for s in per_sig.values())
    lines.append(
        f"  overall: {total_h} hit(s) / {total_m} miss(es) "
        f"(rate {total_h / max(1, total_h + total_m):.2%}), "
        f"{sum(s['bytes_saved'] for s in per_sig.values())} bytes "
        f"saved, "
        f"{sum(s['device_s_avoided'] for s in per_sig.values()):.3f} "
        f"device-seconds avoided")
    ranked = sorted(per_sig.items(),
                    key=lambda kv: -kv[1]["device_s_avoided"])
    for sig, s in ranked:
        n = s["hits"] + s["misses"]
        lines.append(f"  [{sig}]: {s['hits']}/{n} hits "
                     f"(rate {s['hits'] / max(1, n):.2%}) "
                     f"bytes_saved={s['bytes_saved']} "
                     f"device_s_avoided={s['device_s_avoided']:.3f}")
    return lines


def report_why(runs: List[dict],
               query: Optional[str] = None) -> Optional[List[str]]:
    """The attribution verdict per run: a ranked exclusive-bucket table
    under the one-line diagnosis, the black box's last ring events for
    a query that died.  ``query`` filters by run label substring.
    Returns None when no run in the input carries attribution (the
    caller exits EXIT_BAD_INPUT)."""
    lines: List[str] = []
    found = False
    for run in runs:
        if query is not None and query not in str(run["label"]):
            continue
        att = run.get("attribution")
        box = run.get("blackbox")
        if not isinstance(att, dict) and isinstance(box, dict):
            att = box.get("attribution")  # a query that died mid-flight
        if not isinstance(att, dict):
            continue
        found = True
        status = run.get("status")
        tag = f" [{status}]" if status and status != "ok" else ""
        lines.append(f"{run['label']}{tag}: {att.get('verdict')}")
        e2e = float(att.get("e2e_s") or 0.0)
        ranked = sorted((att.get("buckets") or {}).items(),
                        key=lambda kv: -float(kv[1] or 0.0))
        for b, s in ranked:
            s = float(s or 0.0)
            if s <= 0.0:
                continue
            share = s / e2e if e2e > 0 else 0.0
            lines.append(f"    {b:<20} {s:>10.3f} s  {share:>6.1%}")
        if not att.get("closed", True):
            lines.append(
                f"    NOT CLOSED: {att.get('unaccounted_s')} s "
                f"unaccounted exceeds the "
                f"{float(att.get('tolerance') or 0):.0%} tolerance")
        if isinstance(box, dict):
            lines.append(f"    black box: trigger={box.get('trigger')}")
            fr = box.get("flight_recorder") or {}
            for ev in list(fr.get("events") or [])[-5:]:
                rest = ", ".join(f"{k}={v}" for k, v in ev.items()
                                 if k not in ("kind", "t_s"))
                lines.append(f"      event {ev.get('kind')} "
                             f"@{ev.get('t_s')}s  {rest}")
            spans = list(fr.get("recent_spans") or [])
            if spans:
                lines.append("      last spans: " + ", ".join(
                    f"{sp.get('op')}:{sp.get('stage')}"
                    for sp in spans[-5:]))
        elif run.get("blackbox_file"):
            lines.append(f"    black box: {run['blackbox_file']}")
    return lines if found else None


def _join_decisions(runs: List[dict]) -> Dict[str, str]:
    """Latest join-strategy decision per join identity (build-side
    subtree signature when recorded, else op signature + path) — the
    diff side's flip detector input."""
    out: Dict[str, str] = {}
    for run in runs:
        for d in run.get("decisions") or []:
            if d.get("kind") not in ("broadcast", "shuffled"):
                continue
            key = (d.get("build_sig")
                   or f"{d.get('op')}[{d.get('sig', '')}]/"
                      f"{d.get('path', '')}")
            out[key] = d["kind"]
    return out


def report_decision_flips(a_runs: List[dict], b_runs: List[dict]
                          ) -> List[str]:
    """Joins whose adaptive strategy flipped between two runs —
    informational in diff output (a flip explains a self-time shift;
    it is not itself a regression)."""
    a_dec, b_dec = _join_decisions(a_runs), _join_decisions(b_runs)
    lines: List[str] = []
    for key in sorted(set(a_dec) & set(b_dec)):
        if a_dec[key] != b_dec[key]:
            lines.append(f"  DECISION FLIP {key}: "
                         f"{a_dec[key]} -> {b_dec[key]}")
    return lines


def report_skew(runs: List[dict]) -> List[str]:
    lines = [f"exchange skew over {len(runs)} run(s):"]
    found = False
    for run in runs:
        for ex in run["exchanges"]:
            found = True
            flag = "  SKEWED" if ex.get("skewed") else ""
            execs = (f" executors={ex['executors']}"
                     if ex.get("executors", 1) > 1 else "")
            lines.append(
                f"  {run['label']} {ex['op']}[{ex.get('sig', '')}]: "
                f"{ex.get('partitions')} parts "
                f"max={ex.get('max')} total={ex.get('total')} "
                f"({ex.get('unit')}) "
                f"skew={ex.get('skew_factor'):.2f}{execs}{flag}")
    if not found:
        lines.append("  (no exchange partition stats in this input)")
    return lines


def report_storms(runs: List[dict]) -> List[str]:
    lines = [f"compile activity over {len(runs)} run(s):"]
    found = False
    for run in runs:
        rec = run.get("compile_rec")
        if rec:
            # bench scoreboard: cold-vs-warm split from the shape plane
            found = True
            warm = rec.get("warm_compiles") or 0
            flag = "  WARM-PATH COMPILES" if warm else ""
            lines.append(
                f"  {run['label']}: cold {rec.get('cold_compiles', 0)} "
                f"compiles ({rec.get('cold_compile_s', 0.0):.1f}s), "
                f"warm {warm}, bucketing={rec.get('bucketing')} "
                f"hits/misses {rec.get('bucket_hits', 0)}/"
                f"{rec.get('bucket_misses', 0)}, "
                f"pad {rec.get('pad_rows', 0)} rows{flag}")
            continue
        storms = [h for h in run.get("health", [])
                  if h.get("check") == "compile_storm"]
        if run.get("compiles") or storms:
            found = True
            note = "".join(f"  WARN {h.get('detail', 'compile storm')}"
                           for h in storms)
            lines.append(f"  {run['label']}: "
                         f"{run.get('compiles') or 0} kernel "
                         f"compiles{note}")
    if not found:
        lines.append("  (no compile telemetry in this input — the "
                     "query event log carries it)")
    return lines


# ---------------------------------------------------------------------------
# diff — the regression gate
# ---------------------------------------------------------------------------

def diff_runs(a_runs: List[dict], b_runs: List[dict],
              threshold: float = 1.5, min_self_s: float = 0.005
              ) -> Tuple[List[str], List[dict]]:
    """Compare per-op self-times of run set b (candidate) against a
    (baseline).  A regression is an op whose summed self-time grew by
    >= ``threshold``x AND is >= ``min_self_s`` in b (absolute floor so
    microsecond noise on trivial ops never fails a gate).  Returns
    (report lines, regressions)."""
    a_ops, b_ops = merge_ops(a_runs), merge_ops(b_runs)
    lines: List[str] = []
    regressions: List[dict] = []
    improved = 0
    shared = sorted(set(a_ops) & set(b_ops))
    for key in shared:
        av, bv = a_ops[key], b_ops[key]
        if not (av["timed"] and bv["timed"]):
            continue
        a_s, b_s = av["self_s"], bv["self_s"]
        if b_s < min_self_s:
            continue
        ratio = b_s / a_s if a_s > 0 else float("inf")
        if ratio >= threshold:
            regressions.append({"op": key, "a_self_s": round(a_s, 6),
                                "b_self_s": round(b_s, 6),
                                "ratio": round(ratio, 2)})
        elif ratio <= 1.0 / threshold:
            improved += 1
    for key in sorted(set(b_ops) - set(a_ops)):
        bv = b_ops[key]
        if bv["timed"] and bv["self_s"] >= min_self_s:
            lines.append(f"  new op (no baseline): {key} "
                         f"self={bv['self_s']:.6f}s")
    lines.insert(0, f"compared {len(shared)} shared op(s); "
                    f"{len(regressions)} regression(s), "
                    f"{improved} improvement(s) at {threshold}x")
    for r in sorted(regressions, key=lambda r: -r["ratio"]):
        lines.append(f"  REGRESSION {r['op']}: "
                     f"{r['a_self_s']:.6f}s -> {r['b_self_s']:.6f}s "
                     f"({r['ratio']}x)")
    return lines, regressions


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.utils.profile",
        description="profile reports + regression diff over profile "
                    "stores, query event logs, and bench scoreboards")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, help_ in (("top", "slowest ops by traced self time"),
                        ("why", "attribution verdict: where the wall "
                                "time went, per query"),
                        ("skew", "exchange partition-skew report"),
                        ("storms", "kernel compile-storm report")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("input")
        if name == "why":
            sp.add_argument("--query", default=None,
                            help="filter runs by label substring "
                                 "(e.g. 'q3' or a query id)")
        if name == "top":
            sp.add_argument("--n", type=int, default=10)
            sp.add_argument("--adaptive", action="store_true",
                            help="also list per-query adaptive-plane "
                                 "decisions with the triggering stat")
            sp.add_argument("--cache", action="store_true",
                            help="also report per-signature result-"
                                 "cache hit rate, bytes saved, and "
                                 "device-seconds avoided")
    dp = sub.add_parser("diff", help="regression diff: b vs baseline a "
                                     "(nonzero exit on regression)")
    dp.add_argument("a", help="baseline input")
    dp.add_argument("b", help="candidate input")
    dp.add_argument("--threshold", type=float, default=1.5,
                    help="self-time growth ratio that fails (default "
                         "1.5)")
    dp.add_argument("--min-self-s", type=float, default=0.005,
                    help="ignore ops below this candidate self time")
    args = p.parse_args(argv)

    def load(path: str) -> List[dict]:
        try:
            return load_runs(path)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(EXIT_BAD_INPUT)

    if args.cmd == "top":
        runs = load(args.input)
        print("\n".join(report_top(runs, args.n)))
        if args.adaptive:
            print("\n".join(report_adaptive(runs)))
        if args.cache:
            print("\n".join(report_cache(runs)))
        return EXIT_OK
    if args.cmd == "why":
        lines = report_why(load(args.input), query=args.query)
        if lines is None:
            print("error: no attribution records in this input — run "
                  "with spark.rapids.tpu.attribution.enabled (default "
                  "on), or point at a query-*.blackbox.json",
                  file=sys.stderr)
            return EXIT_BAD_INPUT
        print("\n".join(lines))
        return EXIT_OK
    if args.cmd == "skew":
        print("\n".join(report_skew(load(args.input))))
        return EXIT_OK
    if args.cmd == "storms":
        print("\n".join(report_storms(load(args.input))))
        return EXIT_OK
    a_runs, b_runs = load(args.a), load(args.b)
    lines, regressions = diff_runs(a_runs, b_runs,
                                   threshold=args.threshold,
                                   min_self_s=args.min_self_s)
    lines.extend(report_decision_flips(a_runs, b_runs))
    print("\n".join(lines))
    return EXIT_REGRESSION if regressions else EXIT_OK


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
