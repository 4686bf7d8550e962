"""The port's attribution ledger, flight recorder, black box and
``profile why`` against the JAX package's.

Mirrors ``tests/test_attribution.py`` without its lint-rule fixtures and
its docs drift gate (ROADMAP A.12): exclusive buckets that close against
the end-to-end wall within the tolerance with the gap reported, a black
box for every query that dies, the CLI's verdict over every artifact
kind, and the overhead bound of the default-on ledger.  Held against the
JAX package's: the bucket catalog, the ledger's arithmetic over the same
synthetic spans (within 1e-9 s), and the CLI's text and exit code over
black boxes and query logs either package wrote.  Kept deviation: the
port holds one lock per directory over a dump's write and its eviction,
so that concurrent dumps never evict each other's files.
"""

import glob
import json
import os
import pathlib
import re
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime import attribution as JA
from spark_rapids_tpu.runtime import resilience as JR
from spark_rapids_tpu.utils import profile as JP

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import attribution
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime.cancel import QueryCancelled
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.utils import harness as H
from spark_rapids_tpu_torch.utils import profile as P

ROOT = pathlib.Path(__file__).resolve().parents[1]

# keeps a query spinning in execute retries until its deadline cuts it
_SPIN = {"spark.rapids.tpu.retry.maxAttempts": 1_000_000,
         "spark.rapids.tpu.retry.budgetPerQuery": 0,
         "spark.rapids.tpu.test.inject.execute.at": 1,
         "spark.rapids.tpu.test.inject.execute.transientCount": 10**6}


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


class _FakeSpan:
    def __init__(self, op, stage, t0, t1):
        self.op, self.stage, self.t0, self.t1 = op, stage, t0, t1


def _both(spans, **kw):
    """The ledger of both packages over the same spans; their buckets
    agree within 1e-9 s and the rest exactly."""
    port = attribution.attribute(spans=spans, **kw)
    jax = JA.attribute(spans=spans, **kw)
    assert set(port["buckets"]) == set(jax["buckets"])
    for b, s in port["buckets"].items():
        assert abs(s - jax["buckets"][b]) <= 1e-9, b
    for k in ("e2e_s", "unaccounted_s"):
        assert abs(port[k] - jax[k]) <= 1e-9, k
    for k in ("closed", "tolerance", "dominant", "dominant_share",
              "verdict"):
        assert port[k] == jax[k], k
    return port


# ---------------------------------------------------------------------------
# the ledger fold
# ---------------------------------------------------------------------------

def test_buckets_are_exclusive_and_sum_to_e2e():
    spans = [
        _FakeSpan("PumpTask", "pumpTask", 0.0, 10.0),
        _FakeSpan("TpuProject", "opTime", 1.0, 5.0),
        # a build overlapping the op on another thread: compile wins
        _FakeSpan("Kernel", "compile", 2.0, 4.0),
        _FakeSpan("DeviceSemaphore", "semaphoreWait", 6.0, 8.0),
    ]
    att = _both(spans, e2e_s=12.0, tolerance=0.5)
    b = att["buckets"]
    assert b["compile"] == pytest.approx(2.0)
    assert b["kernel_dispatch"] == pytest.approx(2.0)  # 1-2 + 4-5
    assert b["semaphore_wait"] == pytest.approx(2.0)
    assert b["pump_idle"] == pytest.approx(4.0)  # 0-1, 5-6, 8-10
    assert att["unaccounted_s"] == pytest.approx(2.0)  # 10-12
    assert sum(b.values()) == pytest.approx(att["e2e_s"])


def test_unaccounted_reported_never_absorbed():
    spans = [_FakeSpan("TpuSort", "opTime", 0.0, 5.0)]
    att = _both(spans, e2e_s=10.0, tolerance=0.10)
    assert not att["closed"]
    assert att["unaccounted_s"] == pytest.approx(5.0)
    assert att["buckets"]["unaccounted"] == pytest.approx(5.0)
    assert "NOT CLOSED" in att["verdict"]
    att2 = _both(spans, e2e_s=10.0, tolerance=0.6)
    assert att2["closed"]
    assert att2["unaccounted_s"] == pytest.approx(5.0)


def test_root_execute_span_not_charged():
    att = _both([_FakeSpan("Query", "execute", 0.0, 10.0)], e2e_s=10.0,
                tolerance=0.10)
    assert att["unaccounted_s"] == pytest.approx(10.0)
    assert not att["closed"]


def test_verdict_names_dominant_bucket():
    spans = [
        _FakeSpan("TpuIciShuffleExchangeExec", "collectiveTime", 0.0, 7.1),
        _FakeSpan("TpuProject", "opTime", 7.1, 10.0),
    ]
    att = _both(spans, e2e_s=10.0)
    assert att["dominant"] == "exchange_collective"
    assert att["verdict"].startswith("exchange-bound:")
    assert "exchange_collective" in att["verdict"]
    assert att["dominant_share"] == pytest.approx(0.71, abs=0.01)


def test_queue_wait_extras_extend_e2e():
    att = _both((), e2e_s=0.0, extras={"queue_wait": 3.0})
    assert att["buckets"]["queue_wait"] == pytest.approx(3.0)
    assert att["e2e_s"] == pytest.approx(3.0)
    assert att["dominant"] == "queue_wait"
    assert att["verdict"].startswith("queue-bound:")
    assert att["closed"]


def test_cpu_pump_spans_are_host_fallback():
    spans = [_FakeSpan("CpuProjectExec", "pump", 0.0, 4.0),
             _FakeSpan("TpuProject", "opTime", 4.0, 5.0)]
    att = _both(spans, e2e_s=5.0)
    assert att["buckets"]["host_fallback"] == pytest.approx(4.0)
    assert att["dominant"] == "host_fallback"


def test_ledger_arithmetic_equals_jax_on_random_spans():
    """Overlapping spans of every stage across threads: the same buckets
    in both packages, within 1e-9 s."""
    rng = np.random.default_rng(11)
    stages = sorted(attribution.STAGE_BUCKETS)
    for _ in range(20):
        spans = []
        for _ in range(int(rng.integers(1, 40))):
            t0 = float(rng.uniform(0, 5))
            op = "CpuSortExec" if rng.random() < 0.2 else "TpuSortExec"
            spans.append(_FakeSpan(op, stages[rng.integers(len(stages))],
                                   t0, t0 + float(rng.uniform(0, 2))))
        _both(spans, e2e_s=float(rng.uniform(4, 8)),
              tolerance=float(rng.uniform(0.05, 0.5)))


def test_stage_buckets_cover_declared_buckets():
    reachable = {b for b in attribution.STAGE_BUCKETS.values()
                 if b is not None}
    assert reachable <= set(attribution.BUCKETS)
    assert set(attribution.BUCKET_PRIORITY) <= set(attribution.BUCKETS)
    assert set(attribution.BUCKET_VERDICTS) == set(attribution.BUCKETS)


def test_bucket_catalog_equals_jax():
    """Names, verdicts, stage map, priority and closure slack are the
    JAX package's; the docs too, but for ``compile`` (library builds)."""
    assert list(attribution.BUCKETS) == list(JA.BUCKETS)
    assert attribution.BUCKET_VERDICTS == JA.BUCKET_VERDICTS
    assert attribution.STAGE_BUCKETS == JA.STAGE_BUCKETS
    assert attribution.BUCKET_PRIORITY == JA.BUCKET_PRIORITY
    assert attribution.ABS_CLOSE_SLACK_S == JA.ABS_CLOSE_SLACK_S
    for b, doc in attribution.BUCKETS.items():
        if b != "compile":
            assert doc == JA.BUCKETS[b], b


def test_every_timer_and_span_stage_of_the_port_maps_to_a_bucket():
    """Every ``timer("...")`` and span stage the port opens is charged
    to a declared bucket (the JAX package's lint rule, as a test)."""
    stages = set()
    for path in (ROOT / "spark_rapids_tpu_torch").rglob("*.py"):
        text = path.read_text()
        stages |= set(re.findall(r'\.timer\("(\w+)"\)', text))
        stages |= set(re.findall(
            r'(?:trace\.span|\.begin|\.span)\(\s*"\w+",\s*"(\w+)"', text))
    assert {"transferTime", "pumpTask", "compile", "kernel",
            "semaphoreWait", "spillTime", "restoreTime"} <= stages
    unmapped = sorted(s for s in stages
                      if attribution.STAGE_BUCKETS.get(s) is None
                      and s != "execute")
    assert unmapped == []


# ---------------------------------------------------------------------------
# closure on real queries
# ---------------------------------------------------------------------------

def _closes(att):
    assert att["closed"], att
    assert "unaccounted" in att["buckets"]
    assert sum(att["buckets"].values()) == pytest.approx(
        att["e2e_s"], rel=0.01, abs=0.005)
    assert att["verdict"]
    assert att["dominant"] in attribution.BUCKETS


def test_attribution_closes_q1_shaped(tmp_path):
    s = H.tpu_session({"spark.rapids.tpu.attribution.blackboxPath":
                       str(tmp_path)}, device="cpu")
    df = (s.createDataFrame(_t(4000)).filter(F.col("v") > -5)
          .groupBy("k").agg(F.sum("v").alias("sv"), F.avg("v").alias("av"),
                            F.count("v").alias("cv")))
    df.toArrow()
    entry = s.query_history()[-1]
    _closes(entry["attribution"])
    # tracing was off: the ledger leaks no trace artifact
    assert "op_rollup" not in entry
    assert "wall_s" not in entry
    assert "trace_file" not in entry


def test_attribution_closes_q3_shaped(tmp_path):
    s = H.tpu_session({"spark.rapids.tpu.attribution.blackboxPath":
                       str(tmp_path)}, device="cpu")
    left = s.createDataFrame(_t(3000))
    right = s.createDataFrame(pa.table({
        "k": pa.array(list(range(30))),
        "w": pa.array([float(i) * 2 for i in range(30)])}))
    df = left.join(right, "k", "inner").groupBy("k").agg(
        F.sum("v").alias("sv"))
    df.toArrow()
    att = s.query_history()[-1]["attribution"]
    _closes(att)
    assert att["e2e_s"] > 0


def test_attribution_closes_over_the_host_shuffle(tmp_path):
    """A four-partition aggregate through the host shuffle: pump tasks
    on the pool, serialization, reads — still one closed ledger."""
    s = H.tpu_session({"spark.rapids.tpu.attribution.blackboxPath":
                       str(tmp_path), "spark.default.parallelism": 4},
                      device="cpu")
    s.createDataFrame(_t(4000)).repartition(4, "k").groupBy("k").agg(
        F.sum("v").alias("sv")).toArrow()
    entry = s.query_history()[-1]
    assert "TpuHostShuffleExchange" in entry["plan"]
    att = entry["attribution"]
    _closes(att)
    assert att["buckets"]["host_shuffle"] > 0


def test_trace_enabled_keeps_rollup_and_attribution(tmp_path):
    s = H.tpu_session({"spark.rapids.sql.trace.enabled": True,
                       "spark.rapids.sql.trace.path": str(tmp_path),
                       "spark.rapids.tpu.attribution.blackboxPath":
                       str(tmp_path)}, device="cpu")
    s.createDataFrame(_t(3000)).groupBy("k").agg(
        F.sum("v").alias("sv")).toArrow()
    entry = s.query_history()[-1]
    assert "op_rollup" in entry
    assert entry["attribution"]["closed"]


def test_attribution_disabled_no_entry():
    s = H.tpu_session({"spark.rapids.tpu.attribution.enabled": False},
                      device="cpu")
    s.createDataFrame(_t(500)).select("k").toArrow()
    entry = s.query_history()[-1]
    assert "attribution" not in entry
    assert "op_rollup" not in entry  # tracing off too


def test_attribution_in_stats_profile(tmp_path):
    s = H.tpu_session({"spark.rapids.tpu.stats.enabled": True,
                       "spark.rapids.tpu.attribution.blackboxPath":
                       str(tmp_path)}, device="cpu")
    s.createDataFrame(_t(3000)).groupBy("k").agg(
        F.sum("v").alias("sv")).toArrow()
    prof = s.last_query_profile()
    assert prof is not None
    assert prof["attribution"]["verdict"]


# ---------------------------------------------------------------------------
# the flight recorder and the black box
# ---------------------------------------------------------------------------

def _deadline_box(tmp_path):
    bb = str(tmp_path / "bb")
    s = H.tpu_session(dict(_SPIN, **{
        "spark.rapids.tpu.attribution.blackboxPath": bb}), device="cpu")
    df = s.createDataFrame(_t(5000)).groupBy("k").agg(
        F.sum("v").alias("sv"), F.avg("v").alias("av"))
    with pytest.raises(QueryCancelled) as ei:
        df.toArrow(timeout_ms=100)
    assert ei.value.reason == "deadline"
    return s


def test_blackbox_on_deadline(tmp_path):
    """A deadline-killed query leaves a black box naming a dominant
    bucket, with the cancel and retry events in its ring."""
    s = _deadline_box(tmp_path)
    entry = s.query_history()[-1]
    assert entry["status"] == "cancelled"
    path = entry.get("blackbox")
    assert path and os.path.exists(path)
    with open(path) as f:
        box = json.load(f)
    assert box["record"] == "blackbox"
    assert box["trigger"] == "timeout"
    assert box["verdict"]
    assert box["attribution"]["dominant"] in attribution.BUCKETS
    kinds = {ev["kind"] for ev in box["flight_recorder"]["events"]}
    assert {"cancel", "retry"} <= kinds


def test_blackbox_on_error(tmp_path):
    bb = str(tmp_path / "bb")
    s = H.tpu_session({"spark.rapids.tpu.attribution.blackboxPath": bb,
                       "spark.rapids.sql.test.enabled": False},
                      device="cpu")
    bad = F.udf(lambda x: 1 // 0, returnType="int")
    df = s.createDataFrame(_t(200)).select(bad(F.col("k")).alias("z"))
    with pytest.raises(BaseException):
        df.toArrow()
    entry = s.query_history()[-1]
    assert entry["status"] == "error"
    with open(entry["blackbox"]) as f:
        box = json.load(f)
    assert box["trigger"] == "error"
    assert box.get("error")


@pytest.mark.parametrize("mod", [JA, attribution], ids=["jax", "port"])
def test_ring_is_bounded(mod):
    rec = mod.FlightRecorder(1, ring_size=16)
    for i in range(200):
        rec.record_span(_FakeSpan("Op", "opTime", float(i), i + 1.0))
        rec.record_event("retry", {"domain": "kernel", "i": i})
    snap = rec.snapshot()
    assert len(snap["recent_spans"]) == 16
    assert len(snap["events"]) == 16
    assert snap["events"][-1]["i"] == 199


def test_nested_query_rides_owner():
    rec = attribution.start_query(101, ring_size=32)
    try:
        assert rec is not None
        assert attribution.start_query(102) is None
        attribution.record_event("health", {"check": "x"})
        assert len(rec.snapshot()["events"]) == 1
    finally:
        attribution.end_query(rec)
    assert attribution.current() is None


def test_dump_atomic_bounded_concurrent(tmp_path):
    """Concurrent dumps into one directory: every surviving file is
    whole JSON, the count is bounded, and no tmp litter is left.  The
    directory's lock makes the survivors exactly the cap."""
    d = str(tmp_path / "boxes")
    att = attribution.attribute(spans=(), e2e_s=1.0)

    def dump_many(base):
        for i in range(8):
            assert attribution.dump_blackbox(d, base + i, "cancel",
                                             attribution=att,
                                             max_dumps=5)

    threads = [threading.Thread(target=dump_many, args=(b,))
               for b in (100, 200, 300)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    files = glob.glob(os.path.join(d, "*.blackbox.json"))
    assert len(files) == 5
    for f in files:
        with open(f) as fh:
            assert json.load(fh)["record"] == "blackbox"  # never torn
    assert not glob.glob(os.path.join(d, ".*tmp*"))  # no tmp litter


def test_dump_eviction_oldest_first(tmp_path):
    d = str(tmp_path / "boxes")
    for i in range(7):
        attribution.dump_blackbox(d, i, "error", max_dumps=3)
        os.utime(attribution.blackbox_path(d, i), (i + 1, i + 1))
    attribution.dump_blackbox(d, 99, "error", max_dumps=3)
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(d, "*.blackbox.json")))
    assert "query-000099.blackbox.json" in names
    assert len(names) == 3
    assert "query-000000.blackbox.json" not in names


def test_dump_failure_never_fails_the_query(tmp_path):
    """A black-box directory that cannot be made costs the dump, not the
    query: the query's own error is what reaches the caller."""
    blocked = tmp_path / "file"
    blocked.write_text("x")
    assert attribution.dump_blackbox(str(blocked / "bb"), 1,
                                     "error") is None
    s = H.tpu_session(dict(_SPIN, **{
        "spark.rapids.tpu.attribution.blackboxPath": str(blocked / "bb")}),
        device="cpu")
    df = s.createDataFrame(_t(500)).groupBy("k").agg(F.sum("v"))
    with pytest.raises(QueryCancelled):
        df.toArrow(timeout_ms=50)
    assert "blackbox" not in s.query_history()[-1]


# ---------------------------------------------------------------------------
# the overhead of the default-on ledger
# ---------------------------------------------------------------------------

def test_attribution_overhead_within_bound():
    """Attribution and the recorder (on by default) add at most 5% plus
    25 ms to a q1-shaped query's wall (min of 3, interleaved)."""
    s_on = H.tpu_session({}, device="cpu")
    s_off = H.tpu_session({"spark.rapids.tpu.attribution.enabled": False},
                          device="cpu")
    t = _t(4000)

    def run(sess):
        df = (sess.createDataFrame(t).filter(F.col("v") > -5)
              .groupBy("k").agg(F.sum("v").alias("sv"),
                                F.avg("v").alias("av"),
                                F.count("v").alias("cv")))
        t0 = time.perf_counter()
        df.toArrow()
        return time.perf_counter() - t0

    run(s_on)
    run(s_off)
    ons, offs = [], []
    for _ in range(3):
        ons.append(run(s_on))
        offs.append(run(s_off))
    on, off = min(ons), min(offs)
    assert on <= off * 1.05 + 0.025, (on, off)


# ---------------------------------------------------------------------------
# profile why
# ---------------------------------------------------------------------------

def _att_fixture(dom="exchange_collective", e2e=23.3):
    buckets = {b: 0.0 for b in attribution.BUCKETS}
    buckets[dom] = 16.5
    buckets["kernel_dispatch"] = 6.0
    buckets["unaccounted"] = 0.8
    return {"buckets": buckets, "e2e_s": e2e, "unaccounted_s": 0.8,
            "closed": True, "tolerance": 0.1, "dominant": dom,
            "dominant_share": 0.71,
            "verdict": "exchange-bound: 71% of 23.3 s in "
                       "exchange_collective"}


def _both_cli(argv, capsys):
    """The port's and the JAX package's CLI over the same input: the
    same exit code and text; returns them."""
    rc = P.main(argv)
    out = capsys.readouterr().out
    jrc = JP.main(argv)
    assert (rc, out) == (jrc, capsys.readouterr().out)
    return rc, out


def test_profile_why_event_log(tmp_path, capsys):
    log = tmp_path / "qlog.jsonl"
    entries = [
        {"query_id": 1, "status": "ok", "plan": "*TpuProject",
         "attribution": _att_fixture()},
        {"query_id": 2, "status": "ok", "plan": "*TpuSort"},
    ]
    log.write_text("".join(json.dumps(e) + "\n" for e in entries))
    rc, out = _both_cli(["why", str(log)], capsys)
    assert rc == P.EXIT_OK
    assert "exchange-bound: 71% of 23.3 s in exchange_collective" in out
    assert "16.5" in out


def test_profile_why_blackbox_of_timed_out_query(tmp_path, capsys):
    rec = attribution.FlightRecorder(7, ring_size=8)
    rec.record_span(_FakeSpan("TpuIciShuffleExchangeExec",
                              "collectiveTime", 0.0, 16.5))
    rec.record_event("cancel", {"reason": "deadline"})
    path = attribution.dump_blackbox(
        str(tmp_path), 7, "timeout", attribution=_att_fixture(),
        recorder=rec, extra={"status": "cancelled"})
    rc, out = _both_cli(["why", path], capsys)
    assert rc == P.EXIT_OK
    assert "[cancelled]" in out
    assert "trigger=timeout" in out
    assert "cancel" in out
    assert "collectiveTime" in out


def test_profile_why_bench_scoreboard(tmp_path, capsys):
    bench = {"metric": "tpch_sf1",
             "tpch_sf1_attribution": {"q3": _att_fixture()},
             "tpch_sf1_blackbox": {"q9": {
                 "record": "blackbox", "trigger": "timeout",
                 "attribution": _att_fixture(dom="unaccounted"),
                 "flight_recorder": {"events": [
                     {"kind": "cancel", "t_s": 1.0,
                      "reason": "deadline"}]}}}}
    p = tmp_path / "BENCH_r06.json"
    p.write_text(json.dumps(bench))
    rc, out = _both_cli(["why", str(p)], capsys)
    assert rc == P.EXIT_OK
    assert "q3" in out and "q9" in out
    assert "trigger=timeout" in out
    rc, out = _both_cli(["why", str(p), "--query", "q3"], capsys)
    assert "q3" in out and "q9" not in out


def test_profile_why_no_attribution_is_bad_input(tmp_path, capsys):
    log = tmp_path / "qlog.jsonl"
    log.write_text(json.dumps({"query_id": 1, "plan": "x"}) + "\n")
    rc, _ = _both_cli(["why", str(log)], capsys)
    assert rc == P.EXIT_BAD_INPUT


def test_real_blackbox_renders_via_cli(tmp_path, capsys):
    """End to end: a deadline kill, its black box, and ``profile why``
    of both packages rendering the port's box alike."""
    s = _deadline_box(tmp_path)
    path = s.query_history()[-1]["blackbox"]
    rc, out = _both_cli(["why", path], capsys)
    assert rc == P.EXIT_OK
    assert "trigger=timeout" in out
    assert any(lbl in out for lbl in attribution.BUCKET_VERDICTS.values())


def test_the_ports_cli_renders_a_jax_black_box(tmp_path, capsys):
    """A black box the JAX package dumped, from its own deadline kill,
    reads alike through both CLIs."""
    from spark_rapids_tpu.runtime.cancel import QueryCancelled as JQC
    from spark_rapids_tpu.utils import harness as JH
    bb = str(tmp_path / "jbb")
    s = JH.tpu_session(dict(_SPIN, **{
        "spark.rapids.tpu.attribution.blackboxPath": bb}))
    df = s.createDataFrame(_t(500)).groupBy("k").count()
    with pytest.raises(JQC):
        df.toArrow(timeout_ms=100)
    path = s.query_history()[-1]["blackbox"]
    rc, out = _both_cli(["why", path], capsys)
    assert rc == P.EXIT_OK and "trigger=timeout" in out


def test_why_cli_runs_as_a_module(tmp_path):
    """``python -m spark_rapids_tpu_torch.utils.profile why <box>`` exits
    0 and prints the verdict."""
    import subprocess
    import sys
    path = attribution.dump_blackbox(str(tmp_path), 3, "timeout",
                                     attribution=_att_fixture())
    r = subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.utils.profile",
         "why", path], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    assert "exchange-bound: 71% of 23.3 s" in r.stdout
