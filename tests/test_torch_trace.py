"""The port's span tracer and query event log against the JAX package's.

Mirrors ``tests/test_observability.py`` without its LORE cases and its
docs drift gate (ROADMAP A.12): the leak tracker, the profile capture
(``torch.profiler`` into ``query-<id>``), the fallback summary, metric
levels, per-thread span nesting, the rollup, the Chrome trace, the
query log and ``explain("metrics")``.  Where the result is
deterministic it is held against the JAX package's on the same input:
the event-log entry's keys, the trace's set of (op, stage) pairs, the
metric names per level and the fallback summary.  Times are never
compared.  Also the query ids: one counter (``trace.next_query_id``)
names the trace file, the query log entry, the profile store record
and the black box of one query.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime import resilience as JR
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils import harness as JH

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import trace
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.utils import harness as H


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    B.clear_scan_cache()


@pytest.fixture(autouse=True)
def _disarmed():
    """The deadline cases arm both packages' process-wide fault injector
    and retry policy: each test starts and ends with them disarmed."""
    olds = (R._policy, JR._policy)
    for inj in (R.INJECTOR, JR.INJECTOR):
        inj.reset()
    yield
    R._policy, JR._policy = olds
    for inj in (R.INJECTOR, JR.INJECTOR):
        inj.reset()


def _t(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 30, n)),
        "v": pa.array(rng.uniform(-10, 10, n)),
    })


def _sessions(conf):
    """(JAX session, port session on the CPU) over the same conf."""
    return JH.tpu_session(dict(conf)), H.tpu_session(dict(conf),
                                                      device="cpu")


def _filter_agg(s, Fm, n=1000):
    return (s.createDataFrame(_t(n)).filter(Fm.col("v") > 0)
            .groupBy("k").agg(Fm.sum("v").alias("sv")))


@pytest.fixture(scope="module")
def traced_pair(tmp_path_factory):
    """The same traced, stats-collected query run twice in each package
    (the second run is the one read): {"jax"|"port": (session, df)}."""
    out = {}
    for name, Fm in (("jax", JF), ("port", F)):
        d = str(tmp_path_factory.mktemp(f"trace-{name}"))
        conf = {"spark.rapids.sql.trace.enabled": True,
                "spark.rapids.sql.trace.path": d,
                "spark.rapids.tpu.stats.enabled": True,
                "spark.rapids.sql.queryLog.path": d + "/qlog.jsonl"}
        s = (JH.tpu_session(conf) if name == "jax"
             else H.tpu_session(conf, device="cpu"))
        df = _filter_agg(s, Fm)
        df.toArrow()
        df.toArrow()
        out[name] = (s, df)
    return out


# ---------------------------------------------------------------------------
# leak tracker, profile capture, fallback summary
# ---------------------------------------------------------------------------

def test_leak_tracker_reports_unclosed():
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    mgr = M.DeviceMemoryManager(budget=1 << 30, debug=True)
    sp = M.SpillableBatch(host_to_device(_t(100), torch.device("cpu")),
                          mgr)
    leaks = mgr.leaked()
    assert len(leaks) == 1
    assert "test_torch_trace" in leaks[0][1]  # creation stack recorded
    assert mgr.report_leaks() == 1
    sp.close()
    assert mgr.leaked() == []


def test_leak_tracker_excludes_scan_cache():
    s = H.tpu_session({"spark.rapids.memory.gpu.debug": "STDOUT"},
                      device="cpu")
    s.createDataFrame(_t(1000)).groupBy("k").count().toArrow()
    # scan-cache registrations are pinned, not leaks
    assert M.get_manager().leaked() == []


def test_profiler_capture_writes_trace(tmp_path):
    prof = str(tmp_path / "prof")
    s = H.tpu_session({"spark.rapids.profile.enabled": True,
                       "spark.rapids.profile.path": prof}, device="cpu")
    out = s.createDataFrame(_t(500)).filter(F.col("v") > 0).groupBy(
        "k").count().toArrow()
    assert out.num_rows > 0
    captured = glob.glob(os.path.join(prof, "**", "*"), recursive=True)
    assert any(os.path.isfile(p) for p in captured), captured
    (path,) = glob.glob(os.path.join(prof, "query-*", "trace.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_profiler_capture_names_dump_after_query_id(tmp_path):
    prof = str(tmp_path / "prof")
    s = H.tpu_session({"spark.rapids.profile.enabled": True,
                       "spark.rapids.profile.path": prof}, device="cpu")
    s.createDataFrame(_t(300)).groupBy("k").count().toArrow()
    entry = s.query_history()[-1]
    d = entry["profile_dir"]
    assert d.startswith(prof)
    assert os.path.basename(d) == f"query-{entry['query_id']:06d}"
    assert os.path.isdir(d)


def test_profiler_capture_on_the_card_needs_the_cuda_activity(
        monkeypatch, tmp_path):
    """A capture on the card records the CUDA activity or refuses: it
    never quietly records the host alone."""
    import torch.profiler as TP

    from spark_rapids_tpu_torch.sql import dataframe as D
    monkeypatch.setattr(TP, "supported_activities",
                        lambda: {TP.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA activity"):
        with D.profile_capture(torch.device("cuda"), str(tmp_path)):
            pass


def test_fallback_summary_metric():
    t = pa.table({"k": pa.array(np.arange(50) % 5),
                  "v": pa.array(np.arange(50.0))})
    sums = []
    for s, Fm in zip(_sessions({}), (JF, F)):
        df = s.createDataFrame(t).groupBy("k").agg(Fm.sum("v").alias("sv"))
        df.toArrow()
        fs = df.fallback_summary()
        assert fs["fallback_ops"] == 0
        assert fs["device_fraction"] == 1.0
        assert fs["device_ops"] >= 2
        # a lazily planned frame gets a summary without execution
        assert s.createDataFrame(t).select("k").fallback_summary()[
            "device_ops"] >= 1
        sums.append(fs)
    assert sums[0] == sums[1]


# ---------------------------------------------------------------------------
# span tracing and the query event log
# ---------------------------------------------------------------------------

def test_metric_level_filtering_is_nested(traced_pair):
    """ESSENTIAL ⊂ MODERATE ⊂ DEBUG per node; the ESSENTIAL names per
    node are the JAX package's."""
    levels = ("ESSENTIAL", "MODERATE", "DEBUG")
    by_pkg = {}
    for name, (_, df) in traced_pair.items():
        by_level = {lvl: df.metrics(level=lvl) for lvl in levels}
        for lo, hi in (("ESSENTIAL", "MODERATE"), ("MODERATE", "DEBUG")):
            for (op, vals), (op2, vals2) in zip(by_level[lo],
                                                by_level[hi]):
                assert op == op2 and set(vals) <= set(vals2), (lo, hi, op)
        ess = by_level["ESSENTIAL"]
        assert all(set(v) <= {"numOutputRows", "numOutputBatches"}
                   for _, v in ess)
        assert any(set(m) - set(e) for (_, e), (_, m)
                   in zip(ess, by_level["MODERATE"]))
        by_pkg[name] = [(op, sorted(v)) for op, v in ess]
    assert by_pkg["port"] == by_pkg["jax"]


def test_metric_level_defaults_to_the_conf():
    s = H.tpu_session({"spark.rapids.sql.metrics.level": "ESSENTIAL"},
                      device="cpu")
    df = s.createDataFrame(_t(300)).groupBy("k").count()
    df.toArrow()
    assert df.metrics() == df.metrics(level="ESSENTIAL")
    assert df.metrics() != df.metrics(level="DEBUG")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_span_nesting_across_pool_threads(pkg):
    """Per-thread span stacks: concurrent threads nest independently; a
    child's duration subtracts from its parent's self time on the same
    thread only."""
    if pkg == "jax":
        from spark_rapids_tpu.runtime import trace as tr_mod
    else:
        tr_mod = trace
    tr = tr_mod.Tracer(query_id=99)
    # all four threads are alive at once (no thread id can be reused)
    overlap = threading.Barrier(4)

    def work():
        with tr.span("Outer", "pump"):
            with tr.span("Inner", "opTime"):
                overlap.wait(timeout=30)
                time.sleep(0.02)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tr.finish()
    outers = [sp for sp in tr.events if sp.op == "Outer"]
    inners = [sp for sp in tr.events if sp.op == "Inner"]
    assert len(outers) == len(inners) == 4
    assert {sp.tid for sp in outers} == {sp.tid for sp in inners}
    assert len({sp.tid for sp in outers}) == 4
    for sp in inners:
        assert sp.parent_op == "Outer"
        assert sp.dur >= 0.02
    for sp in outers:
        assert sp.parent_op is None
        assert sp.child_time >= 0.02
        assert sp.self_time < sp.dur
    roll = tr.rollup()
    assert roll["Inner"]["total_s"] >= 4 * 0.02
    assert roll["Outer"]["self_s"] < roll["Outer"]["total_s"]


def test_spans_nest_across_the_pump_task_pool(tmp_path):
    """A four-partition query pumps on the task pool: every pool
    thread's spans nest under its own PumpTask span."""
    s = H.tpu_session({"spark.rapids.sql.trace.enabled": True,
                       "spark.rapids.sql.trace.path": str(tmp_path),
                       "spark.default.parallelism": 4}, device="cpu")
    s.createDataFrame(_t(4000)).filter(F.col("v") > 0).select(
        "k", "v").toArrow()
    with open(s.query_history()[-1]["trace_file"]) as f:
        doc = json.load(f)
    tasks = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "PumpTask:pumpTask"]
    assert len(tasks) == 4
    assert {e["args"]["partition"] for e in tasks} == {0, 1, 2, 3}
    for task in tasks:
        inside = [e for e in doc["traceEvents"]
                  if e["ph"] == "X" and e["tid"] == task["tid"]
                  and e["name"].endswith(":pump")
                  and task["ts"] <= e["ts"] <= task["ts"] + task["dur"]]
        assert inside


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_same_op_nested_spans_do_not_double_count(pkg):
    if pkg == "jax":
        from spark_rapids_tpu.runtime import trace as tr_mod
    else:
        tr_mod = trace
    tr = tr_mod.Tracer(query_id=98)
    with tr.span("A", "pump"):
        with tr.span("A", "opTime"):
            pass
    roll = tr.rollup()
    outer = [sp for sp in tr.events if sp.stage == "pump"][0]
    assert roll["A"]["spans"] == 2
    assert abs(roll["A"]["total_s"] - round(outer.dur, 6)) < 1e-5


def test_chrome_trace_export_well_formed(traced_pair):
    """The trace file parses, and its set of (op, stage) pairs is the
    JAX package's for the same query."""
    pairs = {}
    for name, (s, _) in traced_pair.items():
        path = s.query_history()[-1]["trace_file"]
        with open(path) as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        x = [e for e in evs if e["ph"] == "X"]
        m = [e for e in evs if e["ph"] == "M"]
        assert x and m
        for e in x:
            assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
            assert ":" in e["name"] and e["pid"] == 1
        names = {e["name"] for e in x}
        assert any(n.endswith(":pump") for n in names), names
        assert "Query:execute" in names
        pairs[name] = {tuple(n.split(":")) for n in names}
    assert pairs["port"] == pairs["jax"]


def test_query_log_round_trip(tmp_path):
    """One JSONL entry per query; its fallback summary is the frame's,
    its metrics are collect_metrics', and the rollup's self times
    partition the traced wall time (10%)."""
    log = str(tmp_path / "qlog.jsonl")
    s = H.tpu_session({"spark.rapids.sql.trace.enabled": True,
                       "spark.rapids.sql.trace.path": str(tmp_path),
                       "spark.rapids.sql.queryLog.path": log},
                      device="cpu")
    df = s.createDataFrame(_t(2000)).groupBy("k").agg(
        F.sum("v").alias("sv"))
    out = df.toArrow()
    with open(log) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    entry = json.loads(lines[0])
    assert entry["status"] == "ok"
    assert entry["query_id"] == s.query_history()[-1]["query_id"]
    assert entry["fallback"] == df.fallback_summary()
    logged = {m["op"]: m["metrics"] for m in entry["metrics"]}
    for op, vals in df.metrics(level="DEBUG"):
        for name, v in vals.items():
            lv = logged[op][name]["value"]
            assert lv == (round(v, 6) if isinstance(v, float) else v)
    assert "*Tpu" in entry["plan"]
    self_sum = sum(r["self_s"] for r in entry["op_rollup"].values())
    assert abs(self_sum - entry["wall_s"]) <= 0.1 * entry["wall_s"], (
        self_sum, entry["wall_s"])
    assert out.num_rows > 0


def test_event_log_entry_keys_equal_jax(traced_pair):
    """The same query leaves an entry with the JAX package's keys, and a
    stats record with its rows, batches and signatures per node."""
    keys, ops = {}, {}
    for name, (s, _) in traced_pair.items():
        entry = s.query_history()[-1]
        keys[name] = sorted(entry)
        ops[name] = [(o["op"], o["sig"], o["path"], o["rows_out"],
                      o["batches_out"]) for o in entry["op_stats"]]
        with open(os.path.dirname(entry["trace_file"])
                  + "/qlog.jsonl") as f:
            logged = [json.loads(ln) for ln in f.read().splitlines()]
        assert len(logged) == 2
        assert logged[-1]["query_id"] == entry["query_id"]
    assert keys["port"] == keys["jax"]
    assert ops["port"] == ops["jax"]


def test_query_history_records_untraced_queries():
    s = H.tpu_session({}, device="cpu")
    df = s.createDataFrame(_t(300)).select("k")
    df.toArrow()
    df.toArrow()
    h = s.query_history()
    assert len(h) == 2
    assert h[0]["query_id"] != h[1]["query_id"]
    assert all(e["status"] == "ok" for e in h)
    assert "op_rollup" not in h[0]  # tracing was off
    assert s.query_history(1) == [h[-1]]


def test_explain_metrics_mode(capsys):
    s = H.tpu_session({"spark.rapids.sql.trace.enabled": True},
                      device="cpu")
    df = s.createDataFrame(_t(300)).groupBy("k").count()
    df.explain("metrics")
    assert "no execution yet" in capsys.readouterr().out
    df.toArrow()
    df.explain("metrics")
    out = capsys.readouterr().out
    assert "numOutputRows" in out
    assert "per-op time attribution" in out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tracer_event_cap_counts_dropped(pkg):
    if pkg == "jax":
        from spark_rapids_tpu.runtime import trace as tr_mod
    else:
        tr_mod = trace
    tr = tr_mod.Tracer(query_id=97, max_events=5)
    for _ in range(9):
        with tr.span("A", "pump"):
            pass
    assert len(tr.events) == 5
    assert tr.dropped == 4
    assert tr.to_chrome_trace()["otherData"]["dropped_spans"] == 4


def test_concat_empty_batch_list_returns_empty():
    """The JAX package's concat of no batches returns an empty batch;
    the port's takes no device, so its callers build the empty batch
    with ``empty_batch`` and a concat of nothing raises, naming
    itself."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import empty_batch
    from spark_rapids_tpu_torch.exec.basic import concat_device_batches
    schema = T.StructType((T.StructField("a", T.LongT, True),))
    b = empty_batch(schema, torch.device("cpu"))
    assert b.num_rows_host() == 0
    assert len(b.columns) == 1
    with pytest.raises(ValueError, match="concat of no batches"):
        concat_device_batches(schema, [])


def test_plan_metrics_carry_levels():
    """The event log's metric records carry each metric's level, as the
    JAX package's ``plan_metrics`` writes them."""
    s = H.tpu_session({}, device="cpu")
    df = s.createDataFrame(_t(300)).groupBy("k").count()
    df.toArrow()
    recs = trace.plan_metrics(df._last_plan)
    assert recs[0]["op"] == df._last_plan.name
    for rec in recs:
        for m in rec["metrics"].values():
            assert m["level"] in ("ESSENTIAL", "MODERATE", "DEBUG")


# ---------------------------------------------------------------------------
# query ids: one counter names every artifact of a query
# ---------------------------------------------------------------------------

def test_query_ids_come_from_the_trace_counter(tmp_path):
    """The trace file, the query log, the profile store and the black
    box of one query carry the id ``trace.next_query_id`` minted, and
    the next query takes the next id."""
    from spark_rapids_tpu_torch.runtime import cancel as CN
    from spark_rapids_tpu_torch.runtime import stats
    log = str(tmp_path / "qlog.jsonl")
    store = str(tmp_path / "profiles.jsonl")
    conf = {"spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.path": str(tmp_path / "tr"),
            "spark.rapids.sql.queryLog.path": log,
            "spark.rapids.tpu.stats.enabled": True,
            "spark.rapids.tpu.stats.storePath": store,
            "spark.rapids.tpu.attribution.blackboxPath":
                str(tmp_path / "bb"),
            # keep the query spinning in execute retries until its
            # deadline cuts it
            "spark.rapids.tpu.retry.maxAttempts": 1_000_000,
            "spark.rapids.tpu.retry.budgetPerQuery": 0,
            "spark.rapids.tpu.test.inject.execute.at": 1,
            "spark.rapids.tpu.test.inject.execute.transientCount": 10**6}
    s = H.tpu_session(conf, device="cpu")
    df = s.createDataFrame(_t(500)).groupBy("k").agg(F.sum("v"))
    first = trace.next_query_id()
    with pytest.raises(CN.QueryCancelled):
        df.toArrow(timeout_ms=200)
    entry = s.query_history()[-1]
    qid = entry["query_id"]
    assert qid == first + 1
    assert os.path.basename(entry["trace_file"]) == \
        f"query-{qid:06d}.trace.json"
    with open(entry["trace_file"]) as f:
        assert json.load(f)["otherData"]["query_id"] == qid
    with open(log) as f:
        assert json.loads(f.read().splitlines()[-1])["query_id"] == qid
    assert stats.load_profiles(store)[-1]["query_id"] == qid
    assert os.path.basename(entry["blackbox"]) == \
        f"query-{qid:06d}.blackbox.json"
    with open(entry["blackbox"]) as f:
        assert json.load(f)["query_id"] == qid
    assert trace.next_query_id() == qid + 1


def test_query_ids_follow_the_counter_as_in_jax(tmp_path):
    """In both packages a query's id is the next value of its trace
    module's counter, and its trace file carries it."""
    from spark_rapids_tpu.runtime import trace as JTR
    for tr_mod, (s, Fm) in zip((JTR, trace), zip(_sessions({
            "spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.path": str(tmp_path)}), (JF, F))):
        df = s.createDataFrame(_t(300)).groupBy("k").agg(Fm.sum("v"))
        first = tr_mod.next_query_id()
        df.toArrow()
        entry = s.query_history()[-1]
        assert entry["query_id"] == first + 1
        assert entry["trace_file"].endswith(
            f"query-{first + 1:06d}.trace.json")
        assert tr_mod.next_query_id() == first + 2
