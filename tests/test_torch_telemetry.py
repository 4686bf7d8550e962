"""The port's process telemetry against the JAX package's.

Mirrors ``tests/test_telemetry.py`` without its docs drift gate (ROADMAP
A.12): the registry's primitives, the Prometheus exposition, the
spill/restore, OOM-retry and split accounting, the semaphore's query
windows, the query windows of the event log, the health evaluator, the
sampler's sinks and ``metrics_report``.  The registry is process-wide
and monotonic, so scenario assertions are deltas of
``counter_values()``; primitives use private registries.  Where the
result is deterministic it is held against the JAX package's on the
same steps: the registry's names and kinds, the counter deltas of each
scenario, ``evaluate_health`` and the exposition's series.
"""

import json
import math
import os
import re
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.column import host_to_device as jax_h2d
from spark_rapids_tpu.conf import RapidsConf as JaxConf
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.runtime import telemetry as JT
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils import harness as JH

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import semaphore as SEM
from spark_rapids_tpu_torch.runtime import telemetry
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.utils import harness as H

CPU = torch.device("cpu")

# JAX-package metrics whose producers belong to planes the port has not
# ported yet, by the ROADMAP item that brings them
NOT_PORTED = {
    # A.11: the scheduler, admission, preemption, tenancy, SLOs
    "tpuq_admission_rejected_total": "A.11",
    "tpuq_admission_shed_total": "A.11",
    "tpuq_preempt_force_resumed_total": "A.11",
    "tpuq_preempt_requests_total": "A.11",
    "tpuq_preempt_resumed_total": "A.11",
    "tpuq_preempt_spilled_bytes_total": "A.11",
    "tpuq_preempt_suspend_latency_seconds": "A.11",
    "tpuq_preempt_suspended": "A.11",
    "tpuq_preempt_suspended_total": "A.11",
    "tpuq_scheduler_cancelled_queued_total": "A.11",
    "tpuq_scheduler_completed_total": "A.11",
    "tpuq_scheduler_preempted_total": "A.11",
    "tpuq_scheduler_queue_depth": "A.11",
    "tpuq_scheduler_queue_wait_seconds": "A.11",
    "tpuq_scheduler_remote_suspended_total": "A.11",
    "tpuq_scheduler_running": "A.11",
    "tpuq_scheduler_submitted_total": "A.11",
    "tpuq_slo_breach_total": "A.11",
    "tpuq_tenant_hbm_breach_total": "A.11",
    "tpuq_tenancy_degraded_total": "A.11",
    "tpuq_tenancy_directives_stale_total": "A.11",
    "tpuq_tenancy_directives_total": "A.11",
    "tpuq_tenancy_resyncs_total": "A.11",
}

# kept deviation: these count kernel library lookups and builds, where
# the JAX package's count jit-wrapper lookups and XLA compiles; a fused
# region's compile is its CUDA graph capture
DEVIATING_DOCS = {"tpuq_kernel_cache_hits_total",
                  "tpuq_kernel_cache_misses_total",
                  "tpuq_kernel_cache_size",
                  "tpuq_kernel_compile_seconds_total",
                  "tpuq_kernel_compile_total",
                  "tpuq_fusion_compile_seconds_total",
                  "tpuq_fusion_fallback_total"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_manager():
    M.reset_manager()
    JM.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    JM.reset_manager()
    B.clear_scan_cache()


def counters(reg=telemetry.REGISTRY):
    return reg.counter_values()


def deltas(before, reg=telemetry.REGISTRY):
    after = counters(reg)
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _small(seed=0, n=100):
    rng = np.random.default_rng(seed)
    return pa.table({"a": pa.array(rng.integers(0, 50, n)),
                     "b": pa.array(rng.uniform(0, 1, n))})


def _table(n=4000):
    rng = np.random.default_rng(7)
    return pa.table({
        "k": pa.array(rng.integers(0, 23, n).astype(np.int32)),
        "v": pa.array(rng.integers(-100, 100, n)),
    })


def _agg_query(s, t, Fm=F):
    return (s.createDataFrame(t).groupBy("k")
            .agg(Fm.sum("v").alias("sv"), Fm.count("*").alias("c")))


def _rows(tbl):
    return sorted(map(repr, tbl.to_pylist()))


def _port_device_and_cpu(builder, conf=None):
    """The port's device run (on CPU tensors) and its CPU session's run
    of one query, equal row for row — the JAX harness's
    ``assert_tpu_and_cpu_are_equal_collect``."""
    conf = dict(conf or {})
    t = builder(H.tpu_session(conf, device="cpu")).toArrow()
    c = builder(H.tpu_session(dict(conf, **{"spark.rapids.sql.enabled":
                                            False}), device="cpu")).toArrow()
    assert _rows(t) == _rows(c)


# ---------------------------------------------------------------------------
# registry primitives (private registries keep the process catalog clean)
# ---------------------------------------------------------------------------

def test_registration_is_idempotent_and_kind_checked():
    r = telemetry.MetricsRegistry()
    c1 = r.counter("tpuq_test_idem_total", "doc A")
    c2 = r.counter("tpuq_test_idem_total", "doc B")
    assert c1 is c2
    assert c1.doc == "doc A"  # first registration wins
    with pytest.raises(TypeError):
        r.gauge("tpuq_test_idem_total")


def test_counter_inc_and_snapshot():
    r = telemetry.MetricsRegistry()
    c = r.counter("tpuq_test_ctr_total")
    c.inc()
    c.inc(41)
    assert c.value == 42
    assert r.snapshot()["tpuq_test_ctr_total"] == 42
    assert r.counter_values() == {"tpuq_test_ctr_total": 42}


def test_fn_gauge_pulls_live_state_and_swallows_errors():
    r = telemetry.MetricsRegistry()
    box = {"v": 7}
    g = r.gauge("tpuq_test_gauge", fn=lambda: box["v"])
    assert g.value == 7
    box["v"] = 9
    assert g.value == 9
    bad = r.gauge("tpuq_test_gauge_bad", fn=lambda: 1 / 0)
    assert bad.value == 0  # never raises at snapshot time


def test_histogram_buckets_percentiles_reservoir_bound():
    snaps = []
    for mod in (JT, telemetry):
        h = mod.Histogram("h", buckets=(0.1, 1.0), reservoir=8)
        for v in (0.05, 0.5, 0.5, 2.0):
            h.observe(v)
        assert h.cumulative_buckets() == [(0.1, 1), (1.0, 3),
                                          (math.inf, 4)]
        snap = h.snapshot()
        assert snap["count"] == 4
        assert snap["min"] == 0.05 and snap["max"] == 2.0
        assert abs(snap["sum"] - 3.05) < 1e-9
        assert snap["p50"] == 0.5
        for v in range(100):  # bounded reservoir, totals keep counting
            h.observe(float(v))
        assert len(h._reservoir) == 8
        assert h.count == 104
        assert h.snapshot()["p50"] >= 90  # the reservoir holds recent values
        snaps.append(h.snapshot())
    assert snaps[0] == snaps[1]


def test_histogram_thread_safety():
    h = telemetry.Histogram("ht")

    def worker():
        for _ in range(1000):
            h.observe(0.01)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert h.count == 4000
    assert h.cumulative_buckets()[-1] == (math.inf, 4000)


# ---------------------------------------------------------------------------
# the registry's catalog and the Prometheus exposition
# ---------------------------------------------------------------------------

def test_registry_names_and_kinds_equal_jax():
    """Every producer the port has registers the JAX package's metrics
    under the same names and kinds; the JAX package's others (every
    producer imported: ``ensure_producers`` leaves tenancy out) belong to
    planes not ported yet (``NOT_PORTED``)."""
    import spark_rapids_tpu.runtime.tenancy  # noqa: F401 (its producers)
    telemetry.ensure_producers()
    JT.ensure_producers()
    port, jax = telemetry.REGISTRY.catalog(), JT.REGISTRY.catalog()
    assert set(port) == set(jax) - set(NOT_PORTED)
    for name, (kind, doc) in port.items():
        assert kind == jax[name][0], name
        if name not in DEVIATING_DOCS:
            assert doc == jax[name][1], name


# the registry's metrics of the engine planes and of the pump pool, which
# NOT_PORTED held until those planes were ported
ENGINE_PLANE_METRICS = {
    "tpuq_result_cache_bytes_total", "tpuq_result_cache_evictions_total",
    "tpuq_result_cache_hits_total", "tpuq_result_cache_invalidations_total",
    "tpuq_result_cache_misses_total", "tpuq_result_cache_resident_bytes",
    "tpuq_fusion_compile_seconds_total", "tpuq_fusion_fallback_total",
    "tpuq_fusion_regions_built_total", "tpuq_adaptive_decisions_total"}
PUMP_METRICS = {"tpuq_pump_tasks_total", "tpuq_pump_task_seconds",
                "tpuq_pump_queue_depth"}


def test_pump_metrics_of_a_four_partition_query_equal_jax():
    """The pump pool's three metrics: a four-partition query moves the
    task counter and the task-seconds histogram's count by the JAX
    package's deltas (one per task), and the queue-depth gauge settles
    at zero after both; none of them, nor the engine planes' metrics,
    is left in ``NOT_PORTED``."""
    assert not (PUMP_METRICS | ENGINE_PLANE_METRICS) & set(NOT_PORTED)
    telemetry.ensure_producers()
    JT.ensure_producers()
    conf = {"spark.default.parallelism": 4}

    def query(s, Fm):
        return s.createDataFrame(_table()).filter(Fm.col("v") > 0)

    def moved(reg, run):
        def read():
            snap = reg.snapshot()
            return (snap["tpuq_pump_tasks_total"],
                    snap["tpuq_pump_task_seconds"]["count"])
        before = read()
        out = run()
        after = read()
        return ((after[0] - before[0], after[1] - before[1]),
                reg.snapshot()["tpuq_pump_queue_depth"], out)

    got = moved(telemetry.REGISTRY, lambda: query(
        H.tpu_session(conf, device="cpu"), F).toArrow())
    want = moved(JT.REGISTRY, lambda: query(JH.tpu_session(conf),
                                             JF).toArrow())
    assert got[0] == want[0] == (4, 4)
    assert got[1] == want[1] == 0
    assert _rows(got[2]) == _rows(want[2])


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$')
_META = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")


def test_prometheus_exposition_parses():
    telemetry.ensure_producers()
    telemetry.REGISTRY.labeled_counter("tpuq_retry_total").labels("execute")
    text = telemetry.REGISTRY.prometheus_text()
    assert text.endswith("\n")
    families = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, kind = line.split()[2], line.split()[3]
            families.append(name)
            assert kind in ("counter", "gauge", "histogram")
        if line.startswith("#"):
            assert _META.match(line), line
        else:
            assert _SAMPLE.match(line), line
    assert len(families) == len(set(families))
    assert set(families) == set(telemetry.REGISTRY.names())


def test_prometheus_type_lines_equal_jax():
    """The exposition's families and their types are the JAX package's
    for every metric the port registers."""
    telemetry.ensure_producers()
    JT.ensure_producers()

    def types(text):
        return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
                if ln.startswith("# TYPE ")}

    port = types(telemetry.REGISTRY.prometheus_text())
    jax = types(JT.REGISTRY.prometheus_text())
    assert port == {n: jax[n] for n in port}


def test_prometheus_histogram_series_well_formed():
    texts = []
    for mod in (JT, telemetry):
        r = mod.MetricsRegistry()
        h = r.histogram("tpuq_test_prom_hist")
        h.observe(0.002)
        h.observe(10.0)
        lines = [ln for ln in r.prometheus_text().splitlines()
                 if ln.startswith("tpuq_test_prom_hist")]
        buckets = [ln for ln in lines if "_bucket" in ln]
        assert len(buckets) == len(telemetry.DEFAULT_BUCKETS) + 1
        counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
        assert counts == sorted(counts)
        assert buckets[-1].startswith(
            'tpuq_test_prom_hist_bucket{le="+Inf"}')
        n = int([ln for ln in lines if ln.startswith(
            "tpuq_test_prom_hist_count")][0].split()[1])
        assert counts[-1] == n == h.count == 2
        texts.append(r.prometheus_text())
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# spill / OOM accounting: the counter deltas are the JAX package's
# ---------------------------------------------------------------------------

def _spill_restore(MM, TM, batch, spill_path):
    before = counters(TM.REGISTRY)
    mgr = MM.DeviceMemoryManager(budget=1 << 30, spill_path=spill_path)
    sp = MM.SpillableBatch(batch, mgr)
    nb = sp.nbytes
    sp.spill_to_host()
    sp.spill_to_disk()
    assert sp.tier == "disk"
    sp.get()  # disk -> device restore
    sp.close()
    return deltas(before, TM.REGISTRY), nb, mgr


def test_counters_track_spill_restore_sequence_with_disk_tier(tmp_path):
    d, nb, mgr = _spill_restore(M, telemetry, host_to_device(_small(), CPU),
                                str(tmp_path / "port"))
    assert d.get("tpuq_hbm_reserve_bytes_total", 0) >= nb
    assert d.get("tpuq_spill_host_bytes_total") == nb == (
        mgr.metrics["spillToHostBytes"])
    assert d.get("tpuq_spill_disk_bytes_total") == (
        mgr.metrics["spillToDiskBytes"]) > 0
    assert d.get("tpuq_restore_bytes_total") == nb == (
        mgr.metrics["restoredBytes"])
    assert "tpuq_retry_oom_total" not in d
    assert "tpuq_split_retry_total" not in d
    jd, jnb, _ = _spill_restore(JM, JT, jax_h2d(_small()),
                                str(tmp_path / "jax"))
    assert (d, nb) == (jd, jnb)


def _retry_split(MM, TM, batch, spill_path):
    before = counters(TM.REGISTRY)
    mgr = MM.DeviceMemoryManager(budget=1000, spill_path=spill_path)
    with pytest.raises(MM.SplitAndRetryOOM):
        mgr.reserve(2000)  # bigger than the whole budget
    mgr.reserve(800)
    with pytest.raises(MM.RetryOOM):
        mgr.reserve(800)  # nothing registered to spill
    oom = deltas(before, TM.REGISTRY)
    assert oom.get("tpuq_retry_oom_total") == 2 == mgr.metrics["retryOOMs"]
    mgr2 = MM.DeviceMemoryManager(budget=1 << 30, spill_path=spill_path)

    def closure(b):
        if b.capacity > batch.capacity // 2:
            raise MM.SplitAndRetryOOM("too big")
        return b.capacity

    list(MM.with_retry([batch], closure, manager=mgr2))
    d = deltas(before, TM.REGISTRY)
    assert d.get("tpuq_split_retry_total") == 1 == (
        mgr2.metrics["splitRetries"])
    return d


def test_counters_track_retry_oom_and_split(tmp_path):
    port = _retry_split(M, telemetry, host_to_device(_small(), CPU),
                        str(tmp_path))
    jax = _retry_split(JM, JT, jax_h2d(_small()), str(tmp_path))
    keys = ("tpuq_retry_oom_total", "tpuq_split_retry_total",
            "tpuq_hbm_reserve_bytes_total")
    assert {k: port.get(k) for k in keys} == {k: jax.get(k) for k in keys}


_PRESSURE = ("tpuq_retry_oom_total", "tpuq_split_retry_total",
             "tpuq_spill_host_bytes_total", "tpuq_spill_disk_bytes_total",
             "tpuq_queries_total", "tpuq_restore_bytes_total")


def _scenario(conf, t=None):
    """{package: counter deltas} of one query's device and CPU runs."""
    t = t if t is not None else _table()
    before = counters(JT.REGISTRY)
    JH.assert_tpu_and_cpu_are_equal_collect(
        lambda s: _agg_query(s, t, JF), conf=conf, ignore_order=True)
    jax = deltas(before, JT.REGISTRY)
    jax_mgr = dict(JM.get_manager().metrics)
    before = counters()
    _port_device_and_cpu(lambda s: _agg_query(s, t), conf)
    port = deltas(before)
    return ({k: port.get(k) for k in _PRESSURE},
            {k: jax.get(k) for k in _PRESSURE}, M.get_manager().metrics,
            jax_mgr)


def test_injected_oom_end_to_end_counters_match_manager():
    port, jax, mgr, _ = _scenario(
        {"spark.rapids.tpu.test.injectOomAtAlloc": 2})
    assert port["tpuq_retry_oom_total"] >= mgr["retryOOMs"] >= 1
    # both the device run and the CPU run open a query window
    assert port["tpuq_queries_total"] == 2
    assert port == jax


def test_tiny_budget_spill_counters_match_manager():
    t = _table()
    conf = {"spark.rapids.tpu.memory.poolSize":
            int(host_to_device(t, CPU).nbytes() * 1.5),
            "spark.rapids.tpu.batchRows": 4000}
    port, jax, mgr, _ = _scenario(conf, t)
    assert port["tpuq_spill_host_bytes_total"] >= (
        mgr["spillToHostBytes"]) > 0
    assert port == jax


def test_unconstrained_run_moves_no_pressure_counters():
    port, jax, _, _ = _scenario({})
    for k in ("tpuq_spill_host_bytes_total", "tpuq_spill_disk_bytes_total",
              "tpuq_retry_oom_total", "tpuq_split_retry_total"):
        assert port[k] is None, k
    assert port == jax
    before = counters()
    _port_device_and_cpu(lambda s: _agg_query(s, _table()))
    # an uncontended acquire never counts as a wait (exactly zero)
    assert "tpuq_semaphore_wait_seconds_total" not in deltas(before)


# ---------------------------------------------------------------------------
# semaphore query windows
# ---------------------------------------------------------------------------

def test_semaphore_query_stats_reset_but_lifetime_counters_keep():
    SEM.reset_semaphore()
    sem = SEM.get_semaphore()
    before = counters()
    with sem.hold():
        with sem.hold():
            pass
    assert sem.max_holders == 2 and sem.peak_holders == 2
    # the next query boundary: window stats restart, the lifetime peak
    # stays
    telemetry.begin_query(999)
    assert sem.max_holders == 0 and sem.wait_time == 0.0
    assert sem.peak_holders == 2
    with sem.hold():
        pass
    assert sem.max_holders == 1 and sem.peak_holders == 2
    assert deltas(before).get("tpuq_queries_total") == 1
    SEM.reset_semaphore()


def test_semaphore_wait_counted_only_when_blocked():
    SEM.reset_semaphore()
    sem = SEM.get_semaphore()
    sem.resize(1)
    before = counters()
    order = []

    def blocked():
        with sem.hold():
            order.append("second")

    sem.acquire()
    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.05)  # let it block on the held permit
    sem.release()
    t.join(timeout=5)
    assert order == ["second"]
    d = deltas(before)
    assert d.get("tpuq_semaphore_wait_seconds_total", 0) > 0
    assert abs(sem.wait_time - d["tpuq_semaphore_wait_seconds_total"]) \
        < 1e-6
    SEM.reset_semaphore()


# ---------------------------------------------------------------------------
# query windows, the event log, health
# ---------------------------------------------------------------------------

def test_query_entry_carries_telemetry_deltas(tmp_path):
    log = str(tmp_path / "qlog.jsonl")
    s = H.tpu_session({"spark.rapids.sql.queryLog.path": log},
                      device="cpu")
    _agg_query(s, _table()).toArrow()
    entry = s.query_history()[-1]
    tm = entry["telemetry"]
    assert tm.get("tpuq_hbm_reserve_bytes_total", 0) > 0
    assert all(v > 0 for v in tm.values())  # only changed counters
    with open(log) as f:
        logged = json.loads(f.read().splitlines()[-1])
    assert logged["query_id"] == entry["query_id"]
    assert logged["telemetry"] == tm


def test_spill_ratio_breach_emits_health_warn_into_query_log(tmp_path):
    t = _table()
    log = str(tmp_path / "qlog.jsonl")
    warns0 = counters()["tpuq_health_warn_total"]
    s = H.tpu_session({
        "spark.rapids.tpu.memory.poolSize":
            int(host_to_device(t, CPU).nbytes() * 1.5),
        "spark.rapids.tpu.batchRows": 4000,
        "spark.rapids.tpu.telemetry.health.spillRatio": 1e-9,
        "spark.rapids.sql.queryLog.path": log,
        "spark.rapids.tpu.attribution.blackboxPath": str(tmp_path / "bb"),
    }, device="cpu")
    _agg_query(s, t).toArrow()
    entry = s.query_history()[-1]
    checks = {h["check"] for h in entry["health"]}
    assert "spill_ratio" in checks
    ev = [h for h in entry["health"] if h["check"] == "spill_ratio"][0]
    assert ev["severity"] == "WARN"
    assert ev["query_id"] == entry["query_id"]
    assert ev["value"] > ev["threshold"]
    with open(log) as f:
        logged = json.loads(f.read().splitlines()[-1])
    assert logged["health"] == entry["health"]
    assert ev in s.metrics_report()["health"]
    assert counters()["tpuq_health_warn_total"] > warns0
    # a health WARN on an otherwise good run leaves a black box
    with open(entry["blackbox"]) as f:
        assert json.load(f)["trigger"] == "health"


def test_healthy_query_emits_no_health_key():
    s = H.tpu_session({}, device="cpu")
    _agg_query(s, _table()).toArrow()
    assert "health" not in s.query_history()[-1]


_HEALTH_CASES = [
    ({"tpuq_semaphore_wait_seconds_total": 0.9,
      "tpuq_kernel_compile_total": 10}, 1.0),
    ({"tpuq_semaphore_wait_seconds_total": 0.1}, 1.0),
    ({"tpuq_spill_host_bytes_total": 900, "tpuq_spill_disk_bytes_total": 50,
      "tpuq_hbm_reserve_bytes_total": 1000}, 2.0),
    ({"tpuq_spill_host_bytes_total": 10}, 2.0),
    ({"tpuq_host_degraded_ops_total": 3}, 0.5),
    ({'tpuq_admission_shed_total{tenant="a"}': 2}, 0.5),
]


@pytest.mark.parametrize("case", range(len(_HEALTH_CASES)))
def test_evaluate_health_equals_jax(case):
    """The same deltas give the JAX package's events (the compile storm's
    detail names library builds in the port)."""
    d, elapsed = _HEALTH_CASES[case]
    conf = {"spark.rapids.tpu.telemetry.health.semaphoreWaitRatio": 0.5,
            "spark.rapids.tpu.telemetry.health.compileStorm": 3}
    port = telemetry.evaluate_health(d, elapsed, RapidsConf(conf),
                                     query_id=42)
    jax = JT.evaluate_health(d, elapsed, JaxConf(conf), query_id=42)
    for ev in port + jax:
        if ev["check"] == "compile_storm":
            ev.pop("detail")
    assert port == jax


def test_evaluate_health_semaphore_and_compile_checks():
    conf = RapidsConf({
        "spark.rapids.tpu.telemetry.health.semaphoreWaitRatio": 0.5,
        "spark.rapids.tpu.telemetry.health.compileStorm": 3,
    })
    events = telemetry.evaluate_health(
        {"tpuq_semaphore_wait_seconds_total": 0.9,
         "tpuq_kernel_compile_total": 10},
        elapsed_s=1.0, conf=conf, query_id=42)
    checks = {e["check"]: e for e in events}
    assert set(checks) == {"semaphore_saturation", "compile_storm"}
    assert checks["semaphore_saturation"]["value"] == 0.9
    assert checks["compile_storm"]["value"] == 10
    assert "library builds" in checks["compile_storm"]["detail"]
    assert all(e["query_id"] == 42 for e in events)
    assert telemetry.evaluate_health(
        {"tpuq_semaphore_wait_seconds_total": 0.1},
        elapsed_s=1.0, conf=conf) == []


def test_metrics_report_matches_registry():
    s = H.tpu_session({}, device="cpu")
    _agg_query(s, _table()).toArrow()
    rep = s.metrics_report()
    snap = telemetry.REGISTRY.snapshot()
    for name in ("tpuq_queries_total", "tpuq_hbm_reserve_bytes_total",
                 "tpuq_kernel_cache_hits_total"):
        assert rep["metrics"][name] == snap[name]
    assert rep["metrics"]["tpuq_queries_total"] >= 1
    assert "count" in rep["metrics"]["tpuq_semaphore_acquire_seconds"]
    line = [ln for ln in telemetry.REGISTRY.prometheus_text().splitlines()
            if ln.startswith("tpuq_queries_total ")][0]
    assert int(line.split()[1]) >= rep["metrics"]["tpuq_queries_total"]


def test_kernel_dispatch_counter_reads_the_ports_rungs():
    """The dispatch counter is labelled by the port's rungs; a grouped
    query's dispatches move it exactly as ``KN.COUNTERS`` counts them."""
    from spark_rapids_tpu_torch import kernels as KN
    KN.COUNTERS.reset()
    before = counters()
    s = H.tpu_session({}, device="cpu")
    _agg_query(s, _table()).toArrow()
    d = deltas(before)
    assert d['tpuq_kernel_dispatch_total{backend="cuda"}'] == \
        KN.COUNTERS.dispatches["cuda"] > 0
    assert s.query_history()[-1]["telemetry"][
        'tpuq_kernel_dispatch_total{backend="cuda"}'] == \
        KN.COUNTERS.dispatches["cuda"]
    KN.COUNTERS.reset()


# ---------------------------------------------------------------------------
# the sampler and its sinks
# ---------------------------------------------------------------------------

def test_sampler_writes_jsonl_and_prom_sinks(tmp_path):
    sink = str(tmp_path / "ts" / "metrics.jsonl")
    prom = str(tmp_path / "ts" / "metrics.prom")
    s = H.tpu_session({
        "spark.rapids.tpu.telemetry.enabled": True,
        "spark.rapids.tpu.telemetry.samplePeriodMs": 20,
        "spark.rapids.tpu.telemetry.sinkPath": sink,
        "spark.rapids.tpu.telemetry.promPath": prom,
    }, device="cpu")
    try:
        _agg_query(s, _table()).toArrow()
        lines = []
        deadline = time.time() + 10
        while time.time() < deadline:
            if os.path.exists(sink) and os.path.exists(prom):
                with open(sink) as f:
                    lines = f.read().splitlines()
                if len(lines) >= 2:
                    break
            time.sleep(0.02)
        assert len(lines) >= 2
        recs = [json.loads(ln) for ln in lines]
        for r in recs:
            assert {"ts", "unix_ms", "metrics"} <= set(r)
        assert recs[-1]["unix_ms"] >= recs[0]["unix_ms"]
        assert (recs[-1]["metrics"]["tpuq_queries_total"]
                <= telemetry.REGISTRY.snapshot()["tpuq_queries_total"])
        with open(prom) as f:
            text = f.read()
        assert "# TYPE tpuq_queries_total counter" in text
        assert not os.path.exists(prom + ".tmp")  # atomic rewrite
    finally:
        telemetry.stop_sampler()


def test_configure_sampler_disabled_is_noop_and_flush_never_raises(
        tmp_path):
    telemetry.stop_sampler()
    assert telemetry.configure_sampler(RapidsConf({})) is None
    blocked = tmp_path / "dir"
    blocked.mkdir()
    # sink IO failure is swallowed (observability never fails the query)
    telemetry.flush_sinks(str(blocked), str(blocked))
