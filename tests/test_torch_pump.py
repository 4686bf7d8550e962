"""The port's pump concurrency against the JAX package: the device
semaphore, the partition task pool, the prefetching pump and the six
keys of this plane.

* ``DeviceSemaphore``: the cap under contention, no wait counted when
  uncontended, resize in place (a blocked waiter wakes), per-query
  windows and ``device_hold``, each run the same way on the JAX
  package's semaphore.
* ``run_pump_tasks``: order kept, inline for one item or one worker, an
  exception reaching the caller, the in-flight count settled — as the
  JAX package's.
* The prefetch depth: ``_prefetch_pump`` over one counting iterator in
  both packages, and a scan under a filter pulled one batch at a time
  (the scan's ``numOutputBatches`` equal to the JAX package's at
  ``pumpDepth`` 1 to 3).  A limit's subtree is not prefetched: its scan
  stops at the batch that completes the rows at every depth.
* Plans whose root keeps its partitions (a filter, a broadcast join, the
  part-catalogue select) and ``repartition(4)``, under parallelism 4 at
  ``concurrentGpuTasks`` 1, 2 and 4: row for row the JAX package's at the
  same conf, the semaphore's high-water mark within the permits.
* The thread-safety repairs: the kernel plane's counters, the shape
  plane's counters and the scan cache under concurrent tasks.
* The six keys: defaults, docs and checks equal to the JAX package's.

The JAX package is imported inside the tests, so that the ``gpu``-marked
cases (the launch counters under 4 threads, a kernel build kept in
``kernel.cacheDir`` for a second process) run on a card without JAX
(``python3 -m pytest --noconftest -m gpu tests/test_torch_pump.py``).
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.exec import base as EB
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.parallel import executor as EX
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import scheduler as SCH
from spark_rapids_tpu_torch.runtime import semaphore as SEM
from spark_rapids_tpu_torch.runtime import shapes
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERMITS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The batches are small: torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    M.reset_manager()
    B.clear_scan_cache()
    SEM.reset_semaphore()
    yield
    M.reset_manager()
    B.clear_scan_cache()
    SEM.reset_semaphore()
    shapes._POLICY = shapes.ShapePolicy()
    KN._POLICY = KN.KernelPolicy()


def _jax():
    """The JAX package's modules these tests hold the port against."""
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu.exec import base as JEB
    from spark_rapids_tpu.parallel import executor as JEX
    from spark_rapids_tpu.runtime import semaphore as JSEM
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.column import col as jcol
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    return {"C": JC, "EB": JEB, "EX": JEX, "SEM": JSEM, "F": JF,
            "col": jcol, "Session": JaxSession}


# ---------------------------------------------------------------------------
# the semaphore
# ---------------------------------------------------------------------------

def _contend(sem, threads=8, hold_s=0.02):
    """``threads`` tasks each holding a permit for ``hold_s``; returns
    the most holders any task saw inside its hold."""
    seen = []
    start = threading.Barrier(threads)

    def task():
        start.wait()
        with sem.hold():
            seen.append(sem.holders)
            time.sleep(hold_s)

    ts = [threading.Thread(target=task) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return max(seen)


@pytest.mark.parametrize("permits", [1, 2, 3])
def test_semaphore_caps_holders_under_contention(permits):
    J = _jax()
    for mod in (SEM, J["SEM"]):
        sem = mod.DeviceSemaphore(permits)
        assert _contend(sem) == permits
        assert sem.peak_holders == sem.max_holders == permits
        assert sem.holders == 0 and sem.waiting == 0
        assert sem.wait_time > 0  # 8 tasks for at most 3 permits


def test_semaphore_uncontended_counts_no_wait():
    J = _jax()
    for mod in (SEM, J["SEM"]):
        sem = mod.DeviceSemaphore(2)
        waits = []
        for _ in range(5):
            with sem.hold(waited_out=waits):
                pass
        assert waits == [0.0] * 5 and sem.wait_time == 0.0
        assert sem.peak_holders == 1


def test_semaphore_resizes_in_place_and_wakes_a_waiter():
    J = _jax()
    for mod in (SEM, J["SEM"]):
        sem = mod.DeviceSemaphore(1)
        sem.acquire()
        got = []
        t = threading.Thread(target=lambda: got.append(sem.acquire()))
        t.start()
        while sem.waiting == 0:
            time.sleep(0.001)
        sem.resize(2)
        t.join(timeout=5)
        assert not t.is_alive() and got and got[0] > 0
        assert sem.permits == 2 and sem.holders == 2
        sem.release()
        sem.release()


def test_get_semaphore_is_one_object_resized_by_the_conf():
    J = _jax()
    for mod, Conf in ((SEM, C.RapidsConf), (J["SEM"], J["C"].RapidsConf)):
        mod.reset_semaphore()
        assert mod.peek_semaphore() is None
        a = mod.get_semaphore(Conf({}))
        assert a.permits == 2  # concurrentGpuTasks' default
        b = mod.get_semaphore(
            Conf({"spark.rapids.sql.concurrentGpuTasks": 4}))
        assert b is a and a.permits == 4
        assert mod.get_semaphore() is a and mod.peek_semaphore() is a
        mod.reset_semaphore()


def test_semaphore_query_windows():
    sem = SEM.DeviceSemaphore(1)
    sem.begin_query_stats(7)
    sem.begin_query_stats(8)
    sem.acquire(7)
    t = threading.Thread(target=lambda: sem.acquire(8))
    t.start()
    time.sleep(0.05)
    sem.release()
    t.join()
    w7, w8 = sem.query_stats(7), sem.query_stats(8)
    assert w7 == {"max_holders": 1, "wait_time": 0.0}
    assert w8["max_holders"] == 1 and w8["wait_time"] > 0
    assert sem.end_query_stats(8) == w8 and sem.query_stats(8) is None
    assert sem.end_query_stats(8) is None and sem.end_query_stats(None) is None
    sem.release()
    sem.reset_query_stats()
    assert sem.max_holders == 0 and sem.wait_time == 0.0
    for q in range(sem.QUERY_WINDOW_CAP + 2):
        sem.begin_query_stats(100 + q)
    assert sem.query_stats(7) is None  # evicted oldest-first
    assert len(sem._windows) == sem.QUERY_WINDOW_CAP


def test_device_hold_takes_a_permit_of_the_conf_semaphore():
    conf = C.RapidsConf({"spark.rapids.sql.concurrentGpuTasks": 3})
    waits = []
    with SCH.device_hold(conf, waited_out=waits) as sem:
        assert sem is SEM.peek_semaphore()
        assert sem.permits == 3 and sem.holders == 1
    assert sem.holders == 0 and waits == [0.0]


# ---------------------------------------------------------------------------
# the task pool
# ---------------------------------------------------------------------------

def _slow_square(i):
    time.sleep(0.002 * ((7 * i) % 5))
    return i * i, threading.get_ident()


@pytest.mark.parametrize("workers", [1, 4])
def test_run_pump_tasks_keeps_order(workers):
    J = _jax()
    items = list(range(12))
    for run in (EX.run_pump_tasks, J["EX"].run_pump_tasks):
        out = run(_slow_square, items, max_workers=workers)
        assert [v for v, _ in out] == [i * i for i in items]
        threads = {t for _, t in out}
        if workers == 1:
            assert threads == {threading.get_ident()}
    assert EX.inflight() == 0 and EX.run_pump_tasks(_slow_square, []) == []


def test_run_pump_tasks_runs_one_item_inline():
    J = _jax()
    for run in (EX.run_pump_tasks, J["EX"].run_pump_tasks):
        [(v, t)] = run(_slow_square, [3], max_workers=8)
        assert v == 9 and t == threading.get_ident()


def test_run_pump_tasks_exception_reaches_the_caller():
    J = _jax()

    def task(i):
        if i == 2:
            raise ValueError(f"task {i} failed")
        time.sleep(0.01)
        return i

    for run in (EX.run_pump_tasks, J["EX"].run_pump_tasks):
        with pytest.raises(ValueError, match="task 2 failed"):
            run(task, range(16), max_workers=2)
    assert EX.inflight() == 0


# ---------------------------------------------------------------------------
# the prefetch depth
# ---------------------------------------------------------------------------

class _Counting:
    def __init__(self, n):
        self.n, self.pulled = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pulled == self.n:
            raise StopIteration
        self.pulled += 1
        return self.pulled


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_prefetch_pump_runs_depth_ahead_as_jax(depth):
    J = _jax()
    trails = []
    for pump in (EB._prefetch_pump, J["EB"]._prefetch_pump):
        src = _Counting(7)
        it = pump(src, depth)
        trail = []
        for v in it:
            trail.append((v, src.pulled))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][0] == (1, min(depth, 7))


def _pulled(df, to_pull):
    """Scan batches made after pulling ``to_pull`` batches of
    partition 0, one at a time."""
    plan = df._execute_plan()
    it = plan.execute(0)
    for _ in range(to_pull):
        next(it)
    scans = []

    def walk(n):
        if type(n).__name__ == "TpuScanExec":
            scans.append(n.metric("numOutputBatches").value)
        for c in n.children:
            walk(c)

    walk(plan)
    it.close()
    return scans


def _kv(n=256, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 50, n)),
                     "v": pa.array(rng.uniform(-1, 1, n))})


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_producers_run_depth_minus_one_ahead_as_jax(depth):
    J = _jax()
    conf = {"spark.rapids.tpu.batchRows": 16,
            "spark.rapids.tpu.exec.pumpDepth": depth}
    t = _kv()
    got = {}
    for name, s, c in (("port", TpuSession(conf, device="cpu"), col),
                       ("jax", J["Session"](conf), J["col"])):
        df = s.createDataFrame(t).filter(c("k") > 3).select("v")
        got[name] = [_pulled(df, k) for k in (1, 2, 3)]
    assert got["port"] == got["jax"]
    # the project's, the filter's and the scan's pumps each run
    # depth - 1 batches ahead
    assert got["port"][0] == [1 + 3 * (depth - 1)]


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_a_limits_subtree_is_not_prefetched(depth):
    """A limit stops at the batch that completes its rows at every pump
    depth (the JAX package's producers run one batch past it)."""
    s = TpuSession({"spark.default.parallelism": 4,
                    "spark.rapids.tpu.batchRows": 16,
                    "spark.rapids.tpu.exec.pumpDepth": depth},
                   device="cpu")
    df = s.createDataFrame(_kv()).limit(20)
    assert df.count() == 20
    scans = [m for name, m in df.metrics() if name == "TpuScanExec"]
    assert [m["numOutputBatches"] for m in scans] == [2]
    assert not M.peek_manager()._spillables and not B._scan_cache


# ---------------------------------------------------------------------------
# plans whose root keeps its partitions, on the task pool
# ---------------------------------------------------------------------------

SF = 0.002
# AQE off: the repartition's read keeps its 4 partitions
P4 = {"spark.default.parallelism": 4,
      "spark.sql.adaptive.enabled": False,
      "spark.rapids.sql.incompatibleOps.enabled": True}


def _filter_plan(s, F, col, t):
    return (s.createDataFrame(t["lineitem"])
            .filter(col("l_quantity") > 45)
            .select("l_orderkey", "l_partkey", "l_extendedprice",
                    "l_discount"))


def _broadcast_join(s, F, col, t):
    part = (s.createDataFrame(t["part"])
            .select("p_partkey", "p_brand", "p_container")
            .filter(col("p_brand") == "Brand#23"))
    return (s.createDataFrame(t["lineitem"])
            .join(part, col("l_partkey") == col("p_partkey"))
            .select("l_orderkey", "l_partkey", "l_quantity",
                    "l_extendedprice", "l_discount", "p_container"))


def _catalogue(s, F, col, t):
    """``chip_smoke.py``'s part-catalogue select, without its sort."""
    return s.createDataFrame(t["part"]).select(
        col("p_partkey"),
        F.lower(col("p_type")).alias("type_lc"),
        F.length(col("p_name")).alias("name_len"),
        F.locate("green", col("p_name")).alias("green_at"),
        F.concat(col("p_mfgr"), F.lit("/"), col("p_brand")).alias(
            "mfgr_brand"),
        F.lpad(col("p_size").cast("string"), 4, "0").alias("size4"),
        F.reverse(col("p_container")).alias("container_rev"),
        F.rtrim(F.rpad(col("p_brand"), 12, " ")).alias("brand"),
        F.replace(col("p_type"), "BRASS", "Cu-Zn").alias("type_cu"),
        F.regexp_replace(col("p_name"), "[aeiou]+", "").alias(
            "consonants"),
        F.regexp_extract(col("p_name"), "[a-z]+$", 0).alias("last_word"))


def _repartition(s, F, col, t):
    return (s.createDataFrame(t["orders"])
            .select("o_orderkey", "o_custkey", "o_totalprice")
            .repartition(4, col("o_custkey")))


PLANS = {"filter": _filter_plan, "broadcast join": _broadcast_join,
         "catalogue": _catalogue, "repartition": _repartition}


@pytest.fixture(scope="module")
def tables():
    from spark_rapids_tpu_torch.utils import tpch
    return tpch.gen_tpch(SF)


@pytest.fixture(scope="module")
def jax_rows(tables):
    """The JAX package's rows of each plan at each permit count, its
    partitions in order; made once per module."""
    J = _jax()
    from spark_rapids_tpu.exec import basic as JB
    from spark_rapids_tpu.runtime import memory as JM
    out = {}
    for name, build in PLANS.items():
        for permits in PERMITS:
            JM.reset_manager()
            JB.clear_scan_cache()
            s = J["Session"](dict(P4, **{
                "spark.rapids.sql.concurrentGpuTasks": permits}))
            out[name, permits] = repr(
                build(s, J["F"], J["col"], tables).toArrow().to_pylist())
    JM.reset_manager()
    JB.clear_scan_cache()
    return out


def _find(node, name):
    out = [node] if type(node).__name__ == name else []
    for c in node.children:
        out += _find(c, name)
    return out


@pytest.mark.parametrize("permits", PERMITS)
@pytest.mark.parametrize("name", list(PLANS))
def test_root_partitioned_plans_equal_jax_on_the_pool(
        tables, jax_rows, monkeypatch, name, permits):
    calls = []
    run = EX.run_pump_tasks

    def spy(fn, items, max_workers=1):
        calls.append((len(list(items)), max_workers))
        return run(fn, items, max_workers=max_workers)

    monkeypatch.setattr(EX, "run_pump_tasks", spy)
    s = TpuSession(dict(P4, **{
        "spark.rapids.sql.concurrentGpuTasks": permits}), device="cpu")
    df = PLANS[name](s, F, col, tables)
    got = df.toArrow()
    assert repr(got.to_pylist()) == jax_rows[name, permits]
    assert calls == [(4, 4)]  # min(partitions, max(2 * permits, 4))
    sem = SEM.peek_semaphore()
    assert sem.permits == permits and 1 <= sem.peak_holders <= permits
    assert sem.holders == 0
    assert df.metrics()[0][1]["semaphoreWaitTime"] >= 0.0
    assert df.fallback_summary()["fallback_ops"] == 0
    if name == "broadcast join":
        [j] = _find(df._last_plan, "TpuSortMergeJoinExec")
        [bc] = _find(df._last_plan, "TpuBroadcastExchangeExec")
        assert j.broadcast == "right" and j.num_partitions() == 4
        # gathered once under its lock, whatever the tasks' interleaving
        assert bc.metric("numOutputBatches").value == 1
    if name == "repartition":
        [scan] = _find(df._last_plan, "TpuScanExec")
        # the map stage ran once under its lock: each scan partition was
        # pumped once
        assert scan.metric("numOutputBatches").value == 4


def test_scan_cache_under_concurrent_tasks(tables):
    """Four tasks put their partitions' entries at once; a second run
    reads every one of them (no transfer) and equals the first."""
    s = TpuSession(dict(P4, **{"spark.rapids.sql.concurrentGpuTasks": 4}),
                   device="cpu")
    runs = []
    for _ in range(2):
        df = _filter_plan(s, None, col, tables)
        runs.append((df.toArrow(), df))
    [entries] = B._scan_cache.values()
    assert sorted(k[3] for k in entries) == [0, 1, 2, 3]
    scans = _find(runs[1][1]._last_plan, "TpuScanExec")
    assert [n.metric("transferTime").value for n in scans] == [0]
    assert runs[0][0].equals(runs[1][0])


def test_a_failing_task_fails_the_query(tables, monkeypatch):
    """A task that raises fails the query: nothing retries it serially
    or on another device."""
    s = TpuSession(dict(P4, **{"spark.rapids.sql.concurrentGpuTasks": 2}),
                   device="cpu")
    execute = B.TpuFilterExec.execute
    calls = []

    def failing(self, partition):
        calls.append(partition)
        if partition == 2:
            raise RuntimeError("partition 2 failed")
        return execute(self, partition)

    monkeypatch.setattr(B.TpuFilterExec, "execute", failing)
    with pytest.raises(RuntimeError, match="partition 2 failed"):
        _filter_plan(s, None, col, tables).toArrow()
    assert calls.count(2) == 1
    assert SEM.peek_semaphore().holders == 0


def test_a_plan_without_device_work_pumps_serially(tables, monkeypatch):
    monkeypatch.setattr(EX, "run_pump_tasks", None)  # never reached
    s = TpuSession(dict(P4, **{"spark.rapids.sql.enabled": False}),
                   device="cpu")
    got = _filter_plan(s, None, col, tables).toArrow()
    assert got.num_rows > 0 and SEM.peek_semaphore() is None


# ---------------------------------------------------------------------------
# counters that the pool's threads update at once
# ---------------------------------------------------------------------------

def _hammer(fn, threads=16, n=2000):
    """``fn`` called ``n`` times on each of ``threads`` threads at once
    (more threads than cores, a short switch interval: a lost update
    shows); returns the calls made."""
    start = threading.Barrier(threads)

    def task():
        start.wait()
        for _ in range(n):
            fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=task) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    return threads * n


def test_kernel_plane_counters_are_exact_under_threads():
    KN.COUNTERS.reset()
    n = _hammer(lambda: KN.count("agg", "cuda"))
    m = _hammer(lambda: KN.COUNTERS.note_fallback("agg"))
    assert KN.COUNTERS.dispatches == {"cuda": n, "jnp": 0}
    assert KN.COUNTERS.fallbacks == m
    KN.COUNTERS.reset()


def test_shape_counters_are_exact_under_threads():
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    b = host_to_device(pa.table({"a": pa.array([1, 2, 3])}),
                       torch.device("cpu"), bucket=16, min_bucket=16)
    pol = shapes.ShapePolicy(mode="pow2", min_bucket=64)
    before = shapes.snapshot()
    n = _hammer(lambda: shapes.bucket_batch(b, policy=pol), n=100)
    after = shapes.snapshot()
    assert after[1] - before[1] == n and after[2] - before[2] == 48 * n


# ---------------------------------------------------------------------------
# the six keys
# ---------------------------------------------------------------------------

# entry name (the same in both packages): values to try
KEY_VALUES = {
    "CONCURRENT_TASKS": (1, 2, "4", 0, "x"),
    "EXEC_PUMP_DEPTH": (0, 1, 2, "8", 9, "x"),
    "KERNEL_BUCKETING": ("off", "POW2", "ladder", "x"),
    "KERNEL_BUCKET_LADDER": (
        "", "1024", "1024, 8192", "8192,1024", "0,8", "a,b", "5,5"),
    "KERNEL_MAX_PAD_FRACTION": (0.0, 0.5, "0.99", 1.0, -0.1, "x"),
    "KERNEL_CACHE_DIR": ("", "/tmp/tpuq-cache"),
}


@pytest.mark.parametrize("name", list(KEY_VALUES))
def test_the_six_keys_equal_jax(name):
    J = _jax()
    pe, je = getattr(C, name), getattr(J["C"], name)
    key = pe.key
    assert key == je.key and pe.default == je.default
    if name != "KERNEL_CACHE_DIR":  # rewritten for the built libraries
        assert pe.doc == je.doc
    for v in KEY_VALUES[name]:
        outcome = []
        for Conf, entry in ((C.RapidsConf, pe),
                            (J["C"].RapidsConf, je)):
            try:
                outcome.append(("ok", Conf({key: v}).get(entry)))
            except ValueError:
                outcome.append(("raises", None))
        assert outcome[0] == outcome[1], (key, v, outcome)


def test_thirty_five_keys_and_unregistered_keys_still_raise():
    # 35 keys through the pump slice; the failure domains add 36, the
    # UDF and file-scan slice 4, the lakehouse slice 1 (dynamic
    # partition pruning), the observability plane 23, the rest of the
    # engine planes 14 (fusion 3, the result cache 5, adaptive 6), the
    # distributed plane 10 (executor.*, shuffle.rendezvous.*,
    # tpu.rendezvous.*, tpu.exchange.donate)
    assert len(C.REGISTRY) == 123
    with pytest.raises(ValueError, match="unknown"):
        C.RapidsConf({"spark.rapids.tpu.kernel.warmupOnStart": True})


def test_session_installs_the_pump_policies():
    TpuSession({"spark.rapids.tpu.exec.pumpDepth": 3,
                "spark.rapids.tpu.kernel.bucketing": "off"}, device="cpu")
    assert KN.current_policy() == KN.KernelPolicy("auto", 3)
    assert not shapes.current_policy().enabled
    TpuSession(device="cpu")
    assert KN.current_policy().pump_depth == 2
    assert shapes.current_policy() == shapes.ShapePolicy(mode="pow2")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hash_pairs CUDA kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_launch_counters_exact_under_four_threads(cuda_device):
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    limbs = torch.arange(3 * 4096, dtype=torch.int64,
                         device=cuda_device).reshape(3, 4096)
    CB.hash_pairs(limbs)  # built and loaded before the threads start
    torch.cuda.synchronize()
    CB.reset_counts()
    stream = torch.cuda.current_stream(cuda_device)

    def launch():
        with torch.cuda.stream(stream):
            CB.hash_pairs_multi([limbs, limbs[:2]])

    n = _hammer(launch, threads=4, n=500)
    torch.cuda.synchronize()
    assert CB.launches == n
    assert CB.launch_shapes == {(3, 4096): n, (2, 4096): n}
    CB.reset_counts()


_BUILD_SCRIPT = """
import json, sys
import pyarrow as pa
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession
s = TpuSession({"spark.rapids.tpu.kernel.cacheDir": sys.argv[1]})
t = pa.table({"k": list(range(5000)), "v": [1.0] * 5000})
print(json.dumps(s.warmup([s.createDataFrame(t).groupBy("k").agg(
    F.sum("v").alias("s"))])))
"""


@pytest.mark.gpu
def test_a_build_in_cache_dir_is_loaded_by_a_second_process(cuda_device,
                                                            tmp_path):
    import json
    reports = []
    for _ in range(2):
        res = subprocess.run(
            [sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        assert res.returncode == 0, res.stderr
        reports.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert reports[0]["plans"] == 1 and reports[0]["compiles"] >= 1
    assert reports[1]["compiles"] == 0
