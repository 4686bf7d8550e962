"""The port's distributed plan against the JAX package's.

Every case of ``tests/test_parallel.py`` that runs the DataFrame API
(its ``slow`` ones too, at these sizes), the ICI cases of
``tests/test_agg_breadth.py`` (the distributed variance) and of
``tests/test_aqe_dpp.py`` (the adaptive join over ICI exchanges), the
``collective`` rows of ``tests/test_chaos.py`` and
``tests/test_cancel.py``, and the multi-executor plan validation: a
port session with ``spark.rapids.shuffle.mode=ICI`` on eight virtual
CPU ranks plans the JAX package's tree — the same ICI node lines
(partial/final aggregates around ``TpuIciShuffleExchange``, the
co-partitioned join, the range exchange under a ``partitioned`` sort,
the ``partitioned`` window) — and returns its rows: exactly, floats
within 1e-9 relative (sums add in another order across the exchange).
The JAX side plans on its eight virtual CPU devices without running;
its device runs (a compile each) are memoized per module, and the rest
of the rows come from its CPU oracle session.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.parallel import mesh as MESH
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.sql.window import Window
from spark_rapids_tpu_torch.utils import harness as H

# broadcast disabled so joins exercise the co-partitioned ICI exchange
ICI_CONF = {"spark.rapids.shuffle.mode": "ICI",
            "spark.sql.autoBroadcastJoinThreshold": 0,
            "spark.rapids.sql.test.enabled": True}


@pytest.fixture(scope="module", autouse=True)
def _eight_ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MESH, "_virtual", 8)
        mp.setattr(MESH, "_latched", True)
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    from spark_rapids_tpu_torch.exec import basic as B
    M.reset_manager()
    B.clear_scan_cache()
    R.INJECTOR.reset()
    yield
    R.INJECTOR.reset()
    M.reset_manager()
    B.clear_scan_cache()


def _dist_tables(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "g": pa.array([f"grp{i % 13:02d}" if i % 17 else None
                       for i in range(n)]),
        "k": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "v": pa.array(rng.uniform(-100, 100, n)),
        "l": pa.array(rng.integers(-50, 50, n)),
    })
    r = pa.table({
        "k": pa.array(rng.integers(0, 9, n // 5).astype(np.int32)),
        "w": pa.array(rng.integers(0, 1000, n // 5)),
    })
    return t, r


def _zero_nan_tables():
    special = [float("nan"), -0.0, 0.0, None, 1.5]
    rng = np.random.default_rng(6)
    lv = list(rng.integers(-3, 3, 40).astype(float)) + special
    rv = list(rng.integers(-3, 3, 30).astype(float)) + special
    return (pa.table({"d": pa.array(lv, type=pa.float64()),
                      "x": pa.array(list(range(len(lv))))}),
            pa.table({"d": pa.array(rv, type=pa.float64()),
                      "y": pa.array(list(range(len(rv))))}))


def _ordered_table(n=20_000, seed=4):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(-500, 500, n)),
                     "u": pa.array(rng.permutation(n))})


def _window_table(n=8000):
    rng = np.random.default_rng(8)
    return pa.table({"k": pa.array(rng.integers(0, 40, n)),
                     "u": pa.array(rng.permutation(n)),
                     "v": pa.array(rng.uniform(0, 1, n))})


_T1 = _dist_tables(1)
_T2 = _dist_tables(2)
_T3 = _dist_tables(3)
_T4 = _dist_tables(4)
_T5 = _dist_tables(5)
_ZN = _zero_nan_tables()
_VAR = pa.table({"k": pa.array(np.random.default_rng(3).integers(
    0, 9, 4000)), "v": pa.array(np.random.default_rng(4).normal(
        0, 10, 4000))})


def _win(s, F, col, Window):
    return (s.createDataFrame(_window_table())
            .select(col("k"), col("u"),
                    F.sum(col("v")).over(Window.partitionBy("k")
                                         .orderBy("u")).alias("rs")))


# name -> builder(session, F, col, Window): the DataFrame API is the
# same in both packages
CASES = {
    "groupby_string_numeric_keys": lambda s, F, col, W: (
        s.createDataFrame(_T1[0]).filter(F.col("v") > -50)
        .groupBy("g", "k")
        .agg(F.sum("l").alias("sl"), F.count("*").alias("c"),
             F.min("v").alias("mn"), F.max("v").alias("mx"))),
    "groupby_double_sum": lambda s, F, col, W: (
        s.createDataFrame(_T2[0]).groupBy("k")
        .agg(F.sum("v").alias("sv"), F.avg("v").alias("av"))),
    "join_inner": lambda s, F, col, W: s.createDataFrame(_T3[0]).join(
        s.createDataFrame(_T3[1]), "k", "inner"),
    "join_left": lambda s, F, col, W: s.createDataFrame(_T3[0]).join(
        s.createDataFrame(_T3[1]), "k", "left"),
    "join_full": lambda s, F, col, W: s.createDataFrame(_T3[0]).join(
        s.createDataFrame(_T3[1]), "k", "full"),
    "join_left_anti": lambda s, F, col, W: s.createDataFrame(_T3[0]).join(
        s.createDataFrame(_T3[1]), "k", "left_anti"),
    "join_zero_nan_inner": lambda s, F, col, W: s.createDataFrame(
        _ZN[0]).join(s.createDataFrame(_ZN[1]), "d", "inner"),
    "join_zero_nan_full": lambda s, F, col, W: s.createDataFrame(
        _ZN[0]).join(s.createDataFrame(_ZN[1]), "d", "full"),
    "groupby_zero_nan": lambda s, F, col, W: (
        s.createDataFrame(pa.table({
            "d": pa.array([float("nan"), -0.0, 0.0, None, 2.5] * 20,
                          type=pa.float64()),
            "x": pa.array(list(range(100)))}))
        .groupBy("d").agg(F.count("*").alias("c"), F.sum("x").alias("sx"))),
    "join_then_aggregate": lambda s, F, col, W: (
        s.createDataFrame(_T4[0]).join(s.createDataFrame(_T4[1]), "k")
        .groupBy("g").agg(F.sum("w").alias("sw"), F.count("*").alias("c"))),
    "repartition": lambda s, F, col, W: (
        s.createDataFrame(_T5[0]).repartition(8, "k").groupBy("k").count()),
    "range_total_order": lambda s, F, col, W: s.createDataFrame(
        _ordered_table()).orderBy(col("k").desc(), col("u")),
    "window_hash_exchange": lambda s, F, col, W: _win(s, F, col, W),
    "variance_distributed": lambda s, F, col, W: (
        s.createDataFrame(_VAR).groupBy("k")
        .agg(F.stddev(F.col("v")).alias("sd"), F.sum("v").alias("sv"))),
}

# the node each plan must hold (the JAX package's names)
NODES = {
    "groupby_string_numeric_keys": "TpuIciShuffleExchange",
    "groupby_double_sum": "TpuIciShuffleExchange",
    "join_inner": "TpuSortMergeJoin [inner partitioned]",
    "join_left": "TpuSortMergeJoin [left partitioned]",
    "join_full": "TpuSortMergeJoin [full partitioned]",
    "join_left_anti": "TpuSortMergeJoin [left_anti partitioned]",
    "join_zero_nan_inner": "partitioned",
    "join_zero_nan_full": "partitioned",
    "groupby_zero_nan": "TpuIciShuffleExchange",
    "join_then_aggregate": "TpuIciShuffleExchange",
    "repartition": "TpuIciShuffleExchange",
    "range_total_order": "TpuIciRangeExchange",
    "window_hash_exchange": "TpuWindow partitioned",
    "variance_distributed": "TpuIciShuffleExchange",
}
ORDERED = {"range_total_order"}
# the JAX package's device run of these (a compile each) is the reference
JAX_DEVICE_RUNS = ("groupby_double_sum", "range_total_order")


def _jax_env():
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.column import col as jcol
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    from spark_rapids_tpu.sql.window import Window as JWindow
    return JaxSession, JF, jcol, JWindow


def _ici_lines(tree: str):
    """The distributed plan's shape: its aggregate, exchange, join, sort
    and window lines, fusion and coalesce marks aside."""
    keep = ("TpuHashAggregate", "TpuIci", "TpuSortMergeJoin", "TpuSort ",
            "TpuSort partitioned", "TpuWindow", "TpuAdaptiveJoin")
    out = []
    for line in tree.splitlines():
        s = line.strip().lstrip("*")
        if s.startswith(keep):
            out.append(s)
    return out


def _norm(rows):
    def v(x):
        if isinstance(x, float):
            if math.isnan(x):
                return "nan"
            return round(x, 6) + 0.0
        return x
    return sorted(repr(tuple(v(x) for x in r.values())) for r in rows)


def _close(got, want, ordered=False):
    assert len(got) == len(want)
    if ordered:
        assert got == want
        return
    key = lambda r: repr(tuple(  # noqa: E731
        (round(x, 3) if isinstance(x, float) and not math.isnan(x)
         else x) for x in r.values()))
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        for x, y in zip(a.values(), b.values()):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or math.isclose(
                    x, y, rel_tol=1e-9, abs_tol=1e-9), (a, b)
            else:
                assert x == y, (a, b)


@pytest.fixture(scope="module")
def jax_ref():
    """Per case: the JAX ICI plan's lines (planned, not run) and its
    rows (its device run for ``JAX_DEVICE_RUNS``, else its CPU
    oracle)."""
    JaxSession, JF, jcol, JWindow = _jax_env()
    memo = {}

    def get(name):
        if name not in memo:
            build = CASES[name]
            dev = JaxSession({"spark.rapids.sql.enabled": True,
                              **ICI_CONF})
            jdf = build(dev, JF, jcol, JWindow)
            lines = _ici_lines(jdf._execute_plan().tree_string())
            if name in JAX_DEVICE_RUNS:
                rows = jdf.toArrow().to_pylist()
            else:
                cpu = JaxSession({"spark.rapids.sql.enabled": False})
                rows = build(cpu, JF, jcol, JWindow).toArrow().to_pylist()
            memo[name] = (lines, rows)
        return memo[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_plan_and_rows_equal_jax(name, jax_ref):
    lines, want = jax_ref(name)
    df = CASES[name](TpuSession(ICI_CONF, device="cpu"), F, col, Window)
    got = df.toArrow().to_pylist()
    tree = df._last_plan.tree_string()
    assert NODES[name] in tree, tree
    assert _ici_lines(tree) == lines, (tree, lines)
    _close(got, want, ordered=name in ORDERED)


def test_groupby_plan_splits_partial_final_around_the_exchange():
    df = CASES["groupby_string_numeric_keys"](
        TpuSession(ICI_CONF, device="cpu"), F, col, Window)
    lines = _ici_lines(df._execute_plan().tree_string())
    assert lines[0].startswith("TpuHashAggregate [final")
    assert lines[1].startswith("TpuIciShuffleExchange [hash(")
    assert lines[1].endswith("over 8dev]")
    assert lines[2].startswith("TpuHashAggregate [partial")


def test_exchange_under_a_small_budget():
    """``test_distributed_exchange_under_table_sized_budget``'s run at a
    pool of twice the table: the eight virtual ranks share one device,
    so its arbiter holds the whole stage (the JAX package's ranks each
    hold a shard of their own); the exchange reserves the group's
    working set and the run completes under the pool."""
    n = 40_000
    rng = np.random.default_rng(9)
    t = pa.table({"k": pa.array(rng.integers(0, 97, n).astype(np.int32)),
                  "v": pa.array(rng.uniform(-100, 100, n)),
                  "w": pa.array(rng.integers(-50, 50, n))})
    pool = 2 * t.nbytes
    conf = dict(ICI_CONF, **{"spark.rapids.tpu.memory.poolSize": pool})
    got = (TpuSession(conf, device="cpu").createDataFrame(t).groupBy("k")
           .agg(F.sum("v").alias("sv"), F.count("*").alias("c"))
           .toArrow().to_pylist())
    want = (TpuSession({"spark.rapids.sql.enabled": False}, device="cpu")
            .createDataFrame(t).groupBy("k")
            .agg(F.sum("v").alias("sv"), F.count("*").alias("c"))
            .toArrow().to_pylist())
    _close(got, want)
    mgr = M.get_manager()
    assert mgr.budget == pool
    assert 0 < mgr.metrics["peakReserved"] <= pool


# ---------------------------------------------------------------------------
# the adaptive join over ICI exchanges (tests/test_aqe_dpp.py)
# ---------------------------------------------------------------------------

def _adaptive_tables(sel):
    rng = np.random.default_rng(81)
    n = 40_000
    left = pa.table({"k": pa.array(rng.integers(0, 5000, n)),
                     "v": pa.array(rng.uniform(-5, 5, n))})
    right = pa.table({"k": pa.array(rng.integers(0, 6000, n)),
                      "w": pa.array(rng.integers(0, 1000 if sel else 2,
                                                 n))})
    return left, right


_ADAPTIVE = {"spark.rapids.shuffle.mode": "ICI",
             "spark.sql.adaptive.enabled": True,
             "spark.sql.autoBroadcastJoinThreshold": 64 << 10}


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


@pytest.mark.parametrize("case", ["flips_to_broadcast", "stays_shuffled",
                                  "off_keeps_planned_shuffle"])
def test_adaptive_join_over_ici(case):
    """The planned shuffled join collapses to broadcast once the
    filtered build side measures under the threshold; stays shuffled
    when big; with adaptive off keeps its two exchanges.  Rows as the
    JAX package's CPU oracle, plan nodes as the JAX plan's."""
    JaxSession, JF, jcol, _ = _jax_env()
    left, right = _adaptive_tables(sel=case != "stays_shuffled")
    w = 1 if case == "stays_shuffled" else 3
    conf = dict(_ADAPTIVE)
    if case == "off_keeps_planned_shuffle":
        conf["spark.sql.adaptive.enabled"] = False

    def build(s, F):
        return s.createDataFrame(left).join(
            s.createDataFrame(right).filter(F.col("w") == w), "k", "inner")

    df = build(TpuSession(conf, device="cpu"), F)
    got = df.toArrow().to_pylist()
    want = build(JaxSession({"spark.rapids.sql.enabled": False}),
                 JF).toArrow().to_pylist()
    _close(got, want)
    assert len(got) > 0
    jtree = build(JaxSession(dict(conf)), JF)._execute_plan().tree_string()
    j = _find(df._last_plan, "TpuAdaptiveJoinExec")
    if case == "off_keeps_planned_shuffle":
        assert j is None and "TpuAdaptiveJoin" not in jtree
        assert _find(df._last_plan, "TpuIciShuffleExchangeExec") is not None
        return
    assert j is not None and "TpuAdaptiveJoin [inner" in jtree
    if case == "flips_to_broadcast":
        assert j._mode == "broadcast"
        assert j.metric("adaptiveBroadcastJoins").value == 1
        # no collective ran
        assert _find(df._last_plan, "TpuIciShuffleExchangeExec") is None
    else:
        assert j._mode == "shuffled"
        assert j.metric("adaptiveShuffledJoins").value == 1
        assert _find(j._inner, "TpuIciShuffleExchangeExec") is not None


# ---------------------------------------------------------------------------
# the ``collective`` failure domain (tests/test_chaos.py, test_cancel.py)
# ---------------------------------------------------------------------------

_CT = pa.table({"k": pa.array(np.random.default_rng(0).integers(0, 11, 800)),
                "v": pa.array(np.random.default_rng(1).normal(0, 2, 800))})
_ICI = {"spark.rapids.shuffle.mode": "ICI"}


def q_agg(s):
    return (s.createDataFrame(_CT).filter(col("v") > -3.0)
            .groupBy("k").agg(F.sum("v").alias("sv"),
                              F.count("*").alias("c")))


def test_transient_collective_fault_recovers_bit_identical():
    clean = H.run_chaos(q_agg, {}, conf=_ICI, device="cpu")
    rec = H.run_chaos(q_agg, {"collective": (1, 1)}, conf=_ICI,
                      device="cpu")
    assert rec["status"] == "ok"
    assert rec["result"].to_pylist() == clean["result"].to_pylist()
    res = (rec["entry"] or {}).get("resilience") or {}
    assert not res.get("degraded_ops")
    assert res.get("retries_total") == 1


def test_terminal_collective_degrades_to_host_shuffle():
    """The single-process collective degrades to the host-shuffle
    transport on a terminal fault: result equal, the degrade recorded
    (domain ``collective``) and counted, as the JAX package's."""
    JaxSession, JF, jcol, _ = _jax_env()
    clean = H.run_chaos(q_agg, {}, conf=_ICI, device="cpu")
    base = R.counters_snapshot()["host_degraded_ops"]
    rec = H.run_chaos(q_agg, {"collective": (1, 0)}, conf=_ICI,
                      device="cpu")
    assert rec["status"] == "ok"
    res = rec["entry"]["resilience"]
    assert any(d["domain"] == "collective" for d in res["degraded_ops"])
    assert R.counters_snapshot()["host_degraded_ops"] == base + 1
    _close(rec["result"].to_pylist(), clean["result"].to_pylist())
    # the JAX package's CPU oracle on the same rows
    want = (JaxSession({"spark.rapids.sql.enabled": False})
            .createDataFrame(_CT).filter(jcol("v") > -3.0).groupBy("k")
            .agg(JF.sum("v").alias("sv"), JF.count("*").alias("c"))
            .toArrow().to_pylist())
    _close(rec["result"].to_pylist(), want)


def test_terminal_collective_without_degrade_fails_tagged():
    rec = H.run_chaos(
        q_agg, {"collective": (1, 0)},
        conf=dict(_ICI, **{"spark.rapids.tpu.retry.hostDegrade.enabled":
                           False}), device="cpu")
    assert rec["status"] == "failed" and rec["domain"] == "collective"


def test_cancel_mid_collective():
    """A cancel fired while the query keeps hitting a transient
    ``collective`` fault is observed at the retry loop's poll."""
    rec = H.run_cancel_chaos(q_agg, {"collective": (1, 10 ** 6)},
                             conf=_ICI, poll_ms=50.0, seed=7,
                             device="cpu")
    assert rec["fired"] == "collective"
    assert rec["status"] == "cancelled"
    assert rec["leaks"] == 0


# ---------------------------------------------------------------------------
# multi-executor validation and conf keys
# ---------------------------------------------------------------------------

class _FakeCtx:
    process_id, num_processes, timeout = 0, 2, 5.0
    device = torch.device("cpu")

    def __init__(self):
        self.mesh = MESH.Mesh([torch.device("cpu")] * 2 + [None] * 2,
                              process_of=[0, 0, 1, 1])
        self._n = 0

    def next_stage_id(self):
        self._n += 1
        return f"stage-{self._n}"

    def local_partition_ids(self, mesh):
        return mesh.local_ranks()


@pytest.mark.parametrize("what", ["sample", "broadcast_join",
                                  "aggregate_ok"])
def test_multiproc_validation(what, monkeypatch):
    """With an executor context, global-gather operators raise naming
    multi-executor mode (``test_multiprocess_global_gather_raises``);
    the partial/final aggregate plans."""
    from spark_rapids_tpu_torch.parallel import executor as EX
    monkeypatch.setattr(EX, "_CTX", _FakeCtx())
    s = TpuSession({"spark.rapids.shuffle.mode": "ICI",
                    "spark.default.parallelism": 4}, device="cpu")
    t = _T2[0]
    if what == "sample":
        df = s.createDataFrame(t).sample(fraction=0.5, seed=1)
    elif what == "broadcast_join":
        df = s.createDataFrame(t).crossJoin(s.createDataFrame(_T2[1]))
    else:
        df = s.createDataFrame(t).groupBy("k").agg(F.sum("l"))
    if what == "aggregate_ok":
        tree = df._execute_plan().tree_string()
        assert "over 4dev" in tree and "partial" in tree
        return
    with pytest.raises(NotImplementedError, match="multi-executor"):
        df._execute_plan()


# the key docs that name the port's process group or its donation
DEVIATING_DOCS = {
    "spark.rapids.executor.id", "spark.rapids.executor.count",
    "spark.rapids.executor.coordinator.address",
    "spark.rapids.tpu.exchange.donate",
    "spark.rapids.tpu.rendezvous.timeoutMs",
}
DISTRIBUTED_KEYS = (
    "spark.rapids.executor.id", "spark.rapids.executor.count",
    "spark.rapids.executor.coordinator.address",
    "spark.rapids.shuffle.rendezvous.address",
    "spark.rapids.shuffle.rendezvous.timeoutSec",
    "spark.rapids.tpu.rendezvous.timeoutMs",
    "spark.rapids.tpu.rendezvous.heartbeatMs",
    "spark.rapids.tpu.rendezvous.leaseMs",
    "spark.rapids.tpu.rendezvous.socketTimeoutMs",
    "spark.rapids.tpu.exchange.donate")


@pytest.mark.parametrize("key", DISTRIBUTED_KEYS)
def test_distributed_keys_are_the_jax_packages(key):
    """The plane's ten keys: the JAX package's defaults, categories,
    checks and docs (those naming ``jax.distributed`` or buffer
    donation say what the port does instead)."""
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu_torch import conf as C
    mine, theirs = C.REGISTRY[key], JC.REGISTRY.entries[key]
    assert mine.default == theirs.default
    assert mine.category == theirs.category
    if key not in DEVIATING_DOCS:
        assert mine.doc == theirs.doc
    for v in (-1, 0, 1, 2, 0.5, True, "x", ""):
        outcome = []
        for e in (mine, theirs):
            try:
                outcome.append(("ok", e.convert(v)))
            except (ValueError, TypeError):
                outcome.append(("raises", None))
        assert outcome[0] == outcome[1], (key, v)


# ---------------------------------------------------------------------------
# chip_smoke.py's [distributed] plans
# ---------------------------------------------------------------------------

def test_chip_smoke_distributed_plans_are_the_jax_packages():
    """The ICI plan lines ``chip_smoke.py`` holds its SF1 plans to are
    the JAX package's plans of q1, q3, q5 and q18 (its planner on eight
    virtual devices), and the port's, at a small scale with the byte
    and row thresholds scaled by it (sizes scale with the data, so the
    plans are SF1's)."""
    import bench
    import chip_smoke as CS
    from spark_rapids_tpu_torch.utils import tpch
    JaxSession = _jax_env()[0]
    sf = 0.01
    tables = bench.gen_tpch(sf)
    conf = dict(CS.SESSION_CONF, **CS.DIST_CONF, **{
        "spark.sql.autoBroadcastJoinThreshold": int((10 << 20) * sf),
        "spark.rapids.tpu.join.targetRows": int((1 << 18) * sf)})
    conf.pop(CS.BLACKBOX_KEY, None)
    for q in CS.DIST_QUERIES:
        jax_lines = CS.ici_lines(getattr(bench, q)(
            JaxSession(dict(conf)), tables)._execute_plan().tree_string())
        port_lines = CS.ici_lines(tpch.build(
            q, TpuSession(dict(conf), device="cpu"), tables)
            ._execute_plan().tree_string())
        assert jax_lines == port_lines == CS.DIST_PLAN_LINES[q], q


def test_chip_smoke_murmur3_long_is_the_ports_pids():
    """The numpy murmur3 pmod 8 that ``[distributed]`` counts partition
    rows with equals the port's partition ids."""
    import chip_smoke as CS
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.ops.expressions import BoundReference
    from spark_rapids_tpu_torch.ops.hashing import make_pid_fn
    keys = np.random.default_rng(3).integers(-(1 << 40), 1 << 40, 4000)
    b = host_to_device(pa.table({"k": pa.array(keys)}),
                       torch.device("cpu"))
    want = make_pid_fn([BoundReference(0, T.LongT)], 8)(b)[:4000]
    got = CS.pmod_partitions(CS.spark_murmur3_long(keys), 8)
    np.testing.assert_array_equal(got, want.numpy())


def test_merge_partition_counts_equals_jax():
    """The cluster-wide merge of per-executor partition counts (the
    counts allgather's), and its refusal of ragged replies."""
    from spark_rapids_tpu.runtime import stats as JS
    from spark_rapids_tpu_torch.runtime import stats as ST
    replies = [[3, 0, 7, 1], [2, 5, 0, 1], [0, 0, 9, 4]]
    assert ST.merge_partition_counts(replies) == \
        JS.merge_partition_counts(replies) == [5, 5, 16, 6]
    assert ST.merge_partition_counts([]) == []
    with pytest.raises(ValueError, match="disagree on width"):
        ST.merge_partition_counts([[1, 2], [1, 2, 3]])
