"""The port's stats plane and profile CLI against the JAX package's.

Mirrors ``tests/test_stats.py`` without its multi-process exchange case
(in ``tests/test_torch_multiproc.py``) and its docs drift gate (A.12): collection at the pump
boundary, per-partition exchange counts and their skew factor, the AQE
read preferring recorded counts, ``df.explain("analyze")`` and
``session.last_query_profile()``, the profile store with stable
signatures, and the ``utils/profile.py`` CLI.  Held against the JAX
package's on the same inputs: rows and batches per node, the plan
signature per node, the skew factor, ``last_query_profile()`` before
and after a stats-enabled query, and the CLI's text and exit code —
each package's CLI over files the other package wrote, and both
packages' ``diff`` on one regression.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime import stats as JS
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils import harness as JH
from spark_rapids_tpu.utils import profile as JP
from spark_rapids_tpu.utils.datagen import skewed_null_table

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import stats
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.utils import harness as H
from spark_rapids_tpu_torch.utils import profile as P

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _lineitem(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "l_returnflag": pa.array(rng.integers(0, 2, n)),
        "l_linestatus": pa.array(rng.integers(0, 2, n)),
        "l_quantity": pa.array(rng.uniform(1, 50, n)),
        "l_extendedprice": pa.array(rng.uniform(1, 1e5, n)),
    })


def _q1ish(s, t, Fm=F):
    return (s.createDataFrame(t)
            .groupBy("l_returnflag", "l_linestatus")
            .agg(Fm.sum("l_quantity").alias("sum_qty"),
                 Fm.sum("l_extendedprice").alias("sum_price"),
                 Fm.avg("l_quantity").alias("avg_qty"),
                 Fm.count("*").alias("cnt")))


def _session(pkg, conf=None):
    return (JH.tpu_session(dict(conf or {})) if pkg == "jax"
            else H.tpu_session(dict(conf or {}), device="cpu"))


def _node_rows(prof):
    """(op, sig, path, rows_out, batches_out) per node: what the two
    packages must agree on exactly."""
    return [(r["op"], r["sig"], r["path"], r["rows_out"], r["batches_out"])
            for r in prof["ops"]]


# ---------------------------------------------------------------------------
# collection primitives
# ---------------------------------------------------------------------------

def test_skew_factor():
    """The skew factor (the JAX test's merge half is the multi-executor
    exchange's, in ``tests/test_torch_multiproc.py``)."""
    for mod in (JS, stats):
        assert mod.skew_factor([]) == 1.0
        assert mod.skew_factor([0, 0, 0]) == 1.0
        assert mod.skew_factor([5, 5, 5, 5]) == 1.0
        assert mod.skew_factor([100, 1, 1, 1]) == pytest.approx(
            100 / 25.75)
    counts = [7, 1, 0, 13, 2]
    assert stats.skew_factor(counts) == JS.skew_factor(counts)


def test_hist_buckets():
    for n, want in ((0, "0"), (1, "1"), (2, "2-2"), (3, "3-4"),
                    (1000, "513-1024")):
        assert stats._hist_bucket(n) == want == JS._hist_bucket(n)


def test_plan_signature_is_stable_and_positional():
    from spark_rapids_tpu.columnar import dtypes as JT_
    schema = T.StructType((T.StructField("a", T.LongT, False),))
    jschema = JT_.StructType((JT_.StructField("a", JT_.LongT, False),))
    s1 = stats.plan_signature("TpuScanExec", "0.1", schema)
    assert s1 == stats.plan_signature("TpuScanExec", "0.1", schema)
    assert s1 != stats.plan_signature("TpuScanExec", "0.0", schema)
    assert s1 != stats.plan_signature("TpuProjectExec", "0.1", schema)
    assert s1 == JS.plan_signature("TpuScanExec", "0.1", jschema)


def test_nested_query_rides_owner_collector():
    st = stats.start_query(1)
    try:
        assert stats.start_query(2) is None  # nested: the owner keeps it
        assert stats.current() is st
    finally:
        stats.end_query(st)
    assert stats.current() is None


# ---------------------------------------------------------------------------
# explain("analyze") and last_query_profile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def q1_profiles():
    """The q1-shaped query with stats and tracing, once per package:
    {pkg: (session, df, profile before the run)}."""
    out = {}
    for pkg, Fm in (("jax", JF), ("port", F)):
        s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True,
                           "spark.rapids.sql.trace.enabled": True})
        before = s.last_query_profile()
        df = _q1ish(s, _lineitem(), Fm)
        df.toArrow()
        out[pkg] = (s, df, before)
    return out


def test_explain_analyze_q1_style_aggregation(q1_profiles, capsys):
    """Every operator shows observed rows, bytes, batch count and traced
    self time."""
    s, df, _ = q1_profiles["port"]
    df.explain("analyze")
    out = capsys.readouterr().out
    plan_lines = [ln for ln in out.splitlines() if "[rows=" in ln]
    assert len(plan_lines) >= 3  # scan, aggregate, D2H at least
    for ln in plan_lines:
        assert "batches=" in ln and "bytes=" in ln and "self=" in ln, ln
    assert "wall" in out
    prof = s.last_query_profile()
    assert prof is not None and prof["ops"]
    scan = next(r for r in prof["ops"] if r["op"] == "TpuScanExec")
    assert scan["rows_out"] == 4000
    assert scan["batches_out"] >= 1
    assert scan["bytes_out"] > 0
    assert scan["self_s"] is not None
    assert scan["batch_rows_hist"]
    root = prof["ops"][0]
    assert root["path"] == "0"
    assert root["rows_in"] == sum(
        r["rows_out"] for r in prof["ops"] if r["path"] == "0.0")


def test_explain_analyze_plan_lines_equal_jax(q1_profiles, capsys):
    """The annotated tree names the JAX package's nodes with its rows
    and batches (times and bytes aside)."""
    import re
    trees = {}
    for pkg, (_, df, _) in q1_profiles.items():
        df.explain("analyze")
        out = capsys.readouterr().out
        trees[pkg] = [re.sub(r" bytes=\S+| self=\S+| total=\S+"
                             r"| kernel=\S+", "", ln)
                      for ln in out.splitlines() if "[rows=" in ln]
    assert trees["port"] == trees["jax"]


def test_last_query_profile_equals_jax(q1_profiles):
    """None before a stats-enabled query, the stats plane's record after
    it: the JAX package's rows, batches and signatures per node."""
    profs = {}
    for pkg, (s, _, before) in q1_profiles.items():
        assert before is None
        prof = s.last_query_profile()
        assert prof["record"] == "profile" and prof["status"] == "ok"
        assert prof["query_id"] == s.query_history()[-1]["query_id"]
        profs[pkg] = prof
    assert _node_rows(profs["port"]) == _node_rows(profs["jax"])
    assert sorted(profs["port"]) == sorted(profs["jax"])


def test_explain_analyze_executes_when_needed(capsys):
    """On a frame that never ran, explain("analyze") runs the query with
    stats and tracing on for that execution, and the session's conf is
    left as it was."""
    from spark_rapids_tpu_torch import conf as C
    s = H.tpu_session({"spark.rapids.sql.trace.enabled": False},
                      device="cpu")
    df = _q1ish(s, _lineitem(500))
    df.explain("analyze")
    out = capsys.readouterr().out
    assert "rows=" in out and "self=" in out
    assert s.rapids_conf().get(C.TRACE_ENABLED) is False
    assert s.rapids_conf().get(C.STATS_ENABLED) is False
    assert s.last_query_profile() is not None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_zero_row_query_produces_zeroed_stats(pkg):
    """Zero-row operators leave valid (zeroed) records, not holes."""
    Fm = JF if pkg == "jax" else F
    s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True})
    df = (s.createDataFrame(_lineitem(300))
          .filter(Fm.col("l_quantity") > 1e18)  # selects nothing
          .groupBy("l_returnflag")
          .agg(Fm.sum("l_quantity").alias("sq")))
    assert df.toArrow().num_rows == 0
    prof = s.last_query_profile()
    assert prof is not None
    for rec in prof["ops"]:
        assert rec["rows_out"] == 0 or rec["op"] == "TpuScanExec", rec
        assert rec["rows_out"] >= 0 and rec["bytes_out"] >= 0
        assert isinstance(rec["batch_rows_hist"], dict)


def test_stats_off_by_default_records_nothing():
    s = H.tpu_session({}, device="cpu")
    df = _q1ish(s, _lineitem(500))
    df.toArrow()
    assert s.last_query_profile() is None
    assert "op_stats" not in df._last_query_entry


# ---------------------------------------------------------------------------
# exchange skew, null ratios, AQE wiring
# ---------------------------------------------------------------------------

def test_skewed_exchange_reports_skew_factor():
    """A hash exchange over the skewed generator's hot key reports the
    JAX package's skew factor, above the threshold."""
    t = skewed_null_table(6000, seed=2, hot_mass=0.9)
    exes = {}
    for pkg in ("jax", "port"):
        s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True,
                           "spark.rapids.tpu.stats.skewThreshold": 2.0})
        s.createDataFrame(t).repartition(8, "k").toArrow()
        prof = s.last_query_profile()
        assert prof["exchanges"], "no exchange stats recorded"
        ex = prof["exchanges"][0]
        assert ex["partitions"] == 8
        assert ex["skew_factor"] > 2.0
        assert ex["skewed"] is True
        assert ex["total"] > 0
        rec = next(r for r in prof["ops"] if r["sig"] == ex["sig"])
        sizes = rec.get("partition_rows") or rec.get("partition_bytes")
        assert len(sizes) == 8 and max(sizes) == ex["max"]
        exes[pkg] = ex
    # the host shuffle's sizes are serialized bytes, whose layout is the
    # port's own: the skew factor is compared on rows
    s = H.tpu_session({"spark.rapids.tpu.stats.enabled": True,
                       "spark.rapids.shuffle.mode": "CACHE_ONLY"},
                      device="cpu")
    s.createDataFrame(t).repartition(8, "k").toArrow()
    rows = s.last_query_profile()["exchanges"][0]
    js = _session("jax", {"spark.rapids.tpu.stats.enabled": True,
                          "spark.rapids.shuffle.mode": "CACHE_ONLY"})
    js.createDataFrame(t).repartition(8, "k").toArrow()
    jrows = js.last_query_profile()["exchanges"][0]
    assert rows["unit"] == jrows["unit"] == "rows"
    assert (rows["skew_factor"], rows["total"], rows["max"]) == \
        (jrows["skew_factor"], jrows["total"], jrows["max"])


def test_full_level_records_null_ratio():
    t = skewed_null_table(3000, seed=4, null_ratio=0.4)
    ratios = {}
    for pkg in ("jax", "port"):
        s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True,
                           "spark.rapids.tpu.stats.level": "FULL"})
        s.createDataFrame(t).repartition(4, "k").toArrow()
        prof = s.last_query_profile()
        assert prof["level"] == "FULL"
        recs = [r for r in prof["ops"] if r.get("null_ratio")]
        assert recs, "no null ratios recorded at level=FULL"
        nr = recs[0]["null_ratio"]
        assert nr["k"] == 0.0
        assert 0.3 < nr["v"] < 0.5
        ratios[pkg] = [(r["op"], r["null_ratio"]) for r in recs]
    assert ratios["port"] == ratios["jax"]


def test_aqe_prefers_recorded_partition_counts():
    """The AQE read plans from the collector's recorded counts before
    paying for a fresh device count."""
    from spark_rapids_tpu_torch.exec.aqe import TpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.base import TpuExec

    schema = T.StructType((T.StructField("a", T.LongT, False),))

    class _StubExchange(TpuExec):
        def num_partitions(self):
            return 4

        def aqe_partition_stats(self):
            raise AssertionError(
                "planner measured the exchange despite recorded stats")

    stub = _StubExchange(schema)
    st = stats.start_query(777)
    assert st is not None
    try:
        st.record_partitions(stub, [100, 1, 1, 1], unit="rows")
        reader = TpuAQEShuffleReadExec(stub, target_bytes=800,
                                       row_bytes=8)  # target = 100 rows
        specs = reader._plan()  # would raise if it re-measured
    finally:
        stats.end_query(st)
    assert ("range", 0, 1) in specs
    assert ("range", 1, 4) in specs


# ---------------------------------------------------------------------------
# the profile store
# ---------------------------------------------------------------------------

def test_profile_store_appends_with_stable_signatures(tmp_path):
    t = _lineitem(800)
    sigs = {}
    for pkg, Fm in (("jax", JF), ("port", F)):
        store = str(tmp_path / f"{pkg}.jsonl")
        for _ in range(2):  # two sessions, one logical plan
            s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True,
                               "spark.rapids.tpu.stats.storePath": store})
            _q1ish(s, t, Fm).toArrow()
        recs = stats.load_profiles(store)
        assert len(recs) == 2
        sigs0 = [(o["op"], o["sig"], o["path"]) for o in recs[0]["ops"]]
        sigs1 = [(o["op"], o["sig"], o["path"]) for o in recs[1]["ops"]]
        assert sigs0 == sigs1  # diffable across runs
        assert recs[0]["record"] == "profile"
        assert recs[0]["status"] == "ok"
        sigs[pkg] = sigs0
    assert sigs["port"] == sigs["jax"]


def test_load_profiles_skips_torn_lines(tmp_path):
    p = tmp_path / "store.jsonl"
    good = {"record": "profile", "ops": []}
    p.write_text(json.dumps(good) + "\n{torn\n" + json.dumps(good) + "\n")
    assert len(stats.load_profiles(str(p))) == 2


# ---------------------------------------------------------------------------
# the profile CLI
# ---------------------------------------------------------------------------

def _fake_profile(agg_self=0.2):
    return {"record": "profile", "version": 1, "query_id": 1,
            "level": "BASIC", "skew_threshold": 2.0, "wall_s": 1.0,
            "ops": [
                {"op": "TpuScanExec", "sig": "aaa", "path": "0",
                 "rows_out": 10, "self_s": 0.1, "total_s": 0.1},
                {"op": "TpuHashAggregateExec", "sig": "bbb",
                 "path": "0.0", "rows_out": 3, "self_s": agg_self,
                 "total_s": agg_self + 0.1}],
            "exchanges": [
                {"op": "TpuShuffleExchangeExec", "sig": "ccc",
                 "path": "0.1", "unit": "rows", "partitions": 4,
                 "max": 90, "total": 100, "skew_factor": 3.6,
                 "skewed": True, "executors": 1}]}


def _write_store(path, record):
    with open(path, "w") as f:
        f.write(json.dumps(record) + "\n")


def _cli(module, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, env=env,
                          cwd=REPO_ROOT)


def test_profile_cli_diff_detects_regression(tmp_path):
    """An injected 2x self-time regression exits 2 and names the op;
    identical runs exit 0.  The JAX package's CLI agrees, word for
    word."""
    a = str(tmp_path / "a.jsonl")
    b = str(tmp_path / "b.jsonl")
    _write_store(a, _fake_profile(agg_self=0.2))
    _write_store(b, _fake_profile(agg_self=0.4))
    r = _cli("spark_rapids_tpu_torch.utils.profile", ["diff", a, b])
    assert r.returncode == 2, r.stdout + r.stderr
    assert "REGRESSION" in r.stdout
    assert "TpuHashAggregateExec" in r.stdout
    same = _cli("spark_rapids_tpu_torch.utils.profile", ["diff", a, a])
    assert same.returncode == 0, same.stdout + same.stderr
    jr = _cli("spark_rapids_tpu.utils.profile", ["diff", a, b])
    assert (jr.returncode, jr.stdout) == (r.returncode, r.stdout)


def _run_with(self_s):
    return [{"label": "q", "ops": {"x": {"op": "x", "self_s": self_s,
                                         "total_s": self_s}},
             "exchanges": [], "compiles": None, "wall_s": None}]


def test_profile_cli_diff_thresholds():
    for mod in (JP, P):
        a = _run_with(0.1)
        _, regs = mod.diff_runs(a, _run_with(0.14), threshold=1.5)
        assert regs == []
        _, regs = mod.diff_runs(a, _run_with(0.25), threshold=2.0)
        assert len(regs) == 1 and regs[0]["ratio"] == 2.5
        # the absolute floor: microsecond ops never fail the gate
        _, regs = mod.diff_runs(_run_with(1e-6), _run_with(1e-4),
                                threshold=1.5)
        assert regs == []
        # a vanished baseline: an infinite ratio still regresses
        _, regs = mod.diff_runs(_run_with(0.0), _run_with(0.1),
                                threshold=1.5)
        assert len(regs) == 1


def _main_text(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_profile_cli_reports(tmp_path, capsys):
    store = str(tmp_path / "s.jsonl")
    _write_store(store, _fake_profile())
    assert P.main(["top", store, "--n", "5"]) == 0
    assert "TpuHashAggregateExec[bbb]" in capsys.readouterr().out
    assert P.main(["skew", store]) == 0
    out = capsys.readouterr().out
    assert "SKEWED" in out and "skew=3.60" in out
    assert P.main(["storms", store]) == 0  # no compile telemetry: noted
    assert "no compile telemetry" in capsys.readouterr().out
    for argv in (["top", store, "--n", "5"], ["skew", store],
                 ["storms", store], ["top", store, "--adaptive",
                                     "--cache"]):
        assert _main_text(P, argv, capsys) == _main_text(JP, argv, capsys)


def test_profile_cli_reads_event_log(tmp_path, capsys):
    """The CLI reads the query log directly: rollup self times and the
    build counter."""
    log = str(tmp_path / "qlog.jsonl")
    entry = {"query_id": 5, "status": "ok", "plan": "x", "wall_s": 2.0,
             "op_rollup": {"TpuScanExec": {"self_s": 1.5, "total_s": 1.5,
                                           "spans": 3}},
             "telemetry": {"tpuq_kernel_compile_total": 70},
             "health": [{"severity": "WARN", "check": "compile_storm",
                         "value": 70, "threshold": 64,
                         "detail": "70 kernel library builds in one "
                                   "query"}]}
    with open(log, "w") as f:
        f.write(json.dumps(entry) + "\n")
    assert P.load_runs(log)[0]["compiles"] == 70
    assert P.main(["storms", log]) == 0
    out = capsys.readouterr().out
    assert "70 kernel compiles" in out and "WARN" in out
    assert P.main(["top", log]) == 0
    assert "TpuScanExec" in capsys.readouterr().out
    for argv in (["storms", log], ["top", log]):
        assert _main_text(P, argv, capsys) == _main_text(JP, argv, capsys)


def test_profile_cli_bad_input(tmp_path):
    p = tmp_path / "junk.jsonl"
    p.write_text('{"neither": 1}\n')
    for mod in (JP, P):
        with pytest.raises(SystemExit) as e:
            mod.main(["top", str(p)])
        assert e.value.code == 1


def test_profile_cli_reads_the_other_packages_files(tmp_path, capsys):
    """Each package's CLI prints the same text over a profile store and
    a query log that the other package wrote, and the two ``diff``s
    agree on a run against itself."""
    t = _lineitem(800)
    files = {}
    for pkg, Fm in (("jax", JF), ("port", F)):
        store = str(tmp_path / f"{pkg}-store.jsonl")
        log = str(tmp_path / f"{pkg}-qlog.jsonl")
        s = _session(pkg, {"spark.rapids.tpu.stats.enabled": True,
                           "spark.rapids.tpu.stats.storePath": store,
                           "spark.rapids.sql.queryLog.path": log,
                           "spark.rapids.tpu.stats.skewThreshold": 1.5})
        _q1ish(s, t, Fm).toArrow()
        s.createDataFrame(skewed_null_table(2000, seed=2, hot_mass=0.9)) \
            .repartition(4, "k").toArrow()
        files[pkg] = (store, log)
    for store, log in files.values():
        for argv in (["top", store], ["skew", store], ["storms", log],
                     ["why", log], ["skew", log]):
            assert _main_text(P, argv, capsys) == \
                _main_text(JP, argv, capsys), argv
        assert _main_text(P, ["diff", store, store], capsys) == \
            _main_text(JP, ["diff", store, store], capsys)
    assert _main_text(P, ["diff", files["jax"][0], files["port"][0]],
                      capsys) == \
        _main_text(JP, ["diff", files["jax"][0], files["port"][0]], capsys)


# ---------------------------------------------------------------------------
# confs
# ---------------------------------------------------------------------------

def test_stats_confs_registered():
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu_torch import conf as C
    for key in ("spark.rapids.tpu.stats.enabled",
                "spark.rapids.tpu.stats.level",
                "spark.rapids.tpu.stats.storePath",
                "spark.rapids.tpu.stats.skewThreshold"):
        assert key in C.REGISTRY, key
        assert C.REGISTRY[key].default == JC.REGISTRY.entries[key].default
    with pytest.raises(ValueError):
        C.STATS_LEVEL.convert("VERBOSE")
    with pytest.raises(ValueError):
        C.STATS_SKEW_THRESHOLD.convert("1.0")


def test_the_planes_keys_are_the_jax_packages():
    """The plane's 23 keys (123 in all since the distributed plane's
    ten): the JAX package's defaults,
    categories and checks, and a session accepts them.  Kept deviation:
    a default path the JAX package puts under ``/tmp`` lies under the
    process's temporary directory."""
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu_torch import conf as C
    plane = [k for k in C.REGISTRY if k.startswith((
        "spark.rapids.sql.metrics.", "spark.rapids.profile.",
        "spark.rapids.sql.trace.", "spark.rapids.sql.queryLog.",
        "spark.rapids.tpu.stats.", "spark.rapids.tpu.attribution.",
        "spark.rapids.tpu.telemetry."))]
    assert len(plane) == 23 and len(C.REGISTRY) == 123
    probes = (True, False, "x", -1, 0, 0.5, 1.0, 2, "FULL", "basic",
              "DEBUG", "")
    for key in plane:
        mine, theirs = C.REGISTRY[key], JC.REGISTRY.entries[key]
        want = theirs.default
        if isinstance(want, str) and want.startswith("/tmp/"):
            want = os.path.join(tempfile.gettempdir(), *want.split("/")[2:])
        assert mine.default == want, key
        assert mine.category == theirs.category, key
        for v in probes:
            outcome = []
            for e in (mine, theirs):
                try:
                    outcome.append(("ok", e.convert(v)))
                except (ValueError, TypeError):
                    outcome.append(("raises", None))
            assert outcome[0] == outcome[1], (key, v, outcome)
    H.tpu_session({"spark.rapids.sql.trace.enabled": True,
                   "spark.rapids.tpu.stats.enabled": True,
                   "spark.rapids.profile.enabled": True}, device="cpu")
