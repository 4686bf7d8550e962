"""Multi-partition execution (``spark.default.parallelism`` > 1) in the
port against the JAX package, at ``bench.py``'s oracle scales.

* Scans of ``spark.default.parallelism`` in {2, 4} partitions yield the
  JAX package's rows partition by partition (device and CPU sessions),
  and the scan cache holds one entry per partition.
* ``repartition(k[, key]).groupBy(...)`` over lineitem, under
  MULTITHREADED and CACHE_ONLY, AQE on and off, equals the JAX
  package's result, and the CPU session equals the JAX package's CPU
  session.  Float sums compared across exchange transports may differ
  by an ulp (the addends regroup), so they are compared at 1e-12
  relative; keys and counts exactly.
* The CPU session (``spark.rapids.sql.enabled=false``) equals the JAX
  package's CPU session on all 22 TPC-H builders under parallelism 4,
  exactly.
* A third of the 22 builders (the rest in
  ``test_torch_partitions_tpch_{1,2}.py``, for the JAX side's compile
  time) under parallelism 4 equal the JAX package's results
  (``bench._rows_equal(tol=1e-6)``) and its join strategy metrics, and
  their 1-partition results; q3 and q4 also under
  ``autoBroadcastJoinThreshold=0`` (gathered, streamed and
  sub-partitioned joins over partitioned scans).
"""

import pytest
import torch

import bench

from spark_rapids_tpu.columnar import host as JH
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.002
QUERIES = ("q1", "q3", "q4", "q6", "q12", "q13", "q14", "q15", "q17",
           "q19", "q22")
CONFS = {
    "defaults": {"spark.default.parallelism": 4},
    "noBroadcast": {"spark.default.parallelism": 4,
                    "spark.sql.autoBroadcastJoinThreshold": 0,
                    "spark.rapids.tpu.join.targetRows": 1024},
}
_STRATEGY = ("streamedJoins", "subPartitionJoins")


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


_TABLES = {}


def _tables_for(q):
    sf = tpch.ORACLE_SF.get(q, tpch.ORACLE_DEFAULT_SF)
    if sf not in _TABLES:
        _TABLES[sf] = bench.gen_tpch(sf)
    return _TABLES[sf]


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()
    M.reset_manager()


def _partitions(df, to_arrow):
    plan = df._execute_plan()
    return [[repr(r) for b in plan.execute(p)
             for r in to_arrow(b).to_pylist()]
            for p in range(plan.num_partitions())]


def _strategies(df):
    return [tuple(m.get(k, 0) for k in _STRATEGY)
            for name, m in df.metrics() if name == "TpuSortMergeJoinExec"]


@pytest.mark.parametrize("sql", [True, False], ids=["device", "cpu"])
@pytest.mark.parametrize("nparts", [2, 4])
def test_scan_partitions_equal_jax(tables, nparts, sql):
    t = tables["lineitem"]
    conf = {"spark.default.parallelism": nparts,
            "spark.rapids.tpu.batchRows": 1024,
            "spark.rapids.sql.enabled": sql}
    got = _partitions(TpuSession(dict(conf), device="cpu")
                      .createDataFrame(t), PH.to_arrow_table)
    want = _partitions(JaxSession(dict(conf)).createDataFrame(t),
                       JH.to_arrow_table)
    assert got == want
    assert len(got) == nparts and all(got)
    assert sum(len(p) for p in got) == t.num_rows
    if sql:
        # one cache entry per partition under the JAX package's key
        assert sorted(B._scan_cache[id(t)]) == [
            (nparts, 1024, 1024, p, "cpu") for p in range(nparts)]


def _hash_key(s, t, f):
    return (s.createDataFrame(t)
            .select("l_orderkey", "l_quantity", "l_returnflag")
            .repartition(8, "l_orderkey").groupBy("l_orderkey")
            .agg(f.sum("l_quantity").alias("q")))


def _rr_string_keys(s, t, f):
    return (s.createDataFrame(t).repartition(6)
            .groupBy("l_returnflag", "l_linestatus")
            .agg(f.sum("l_extendedprice").alias("p"),
                 f.count("*").alias("c")))


def _string_key_keyless(s, t, f):
    return (s.createDataFrame(t).repartition(5, "l_shipmode")
            .agg(f.sum("l_discount").alias("d"), f.count("*").alias("c")))


# repartitioned aggregates over lineitem, each for a session and its
# ``functions`` module
AGGS = {"hash_key": _hash_key, "rr_string_keys": _rr_string_keys,
        "string_key_keyless": _string_key_keyless}
MODES = [("MULTITHREADED", True), ("MULTITHREADED", False),
         ("CACHE_ONLY", True), ("CACHE_ONLY", False)]


@pytest.mark.parametrize("mode, aqe", MODES,
                         ids=[f"{m}-aqe{int(a)}" for m, a in MODES])
@pytest.mark.parametrize("query", list(AGGS))
def test_repartitioned_aggregate_equals_jax(tables, query, mode, aqe):
    t = tables["lineitem"]
    conf = {"spark.default.parallelism": 3,
            "spark.rapids.shuffle.mode": mode,
            "spark.sql.adaptive.enabled": aqe,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": 64 << 10}
    build = AGGS[query]
    df = build(TpuSession(dict(conf), device="cpu"), t, F)
    got = df.toArrow()
    want = build(JaxSession(dict(conf)), t, JF).toArrow()
    assert got.num_rows > 0 and got.schema == want.schema
    # keys and counts exactly, float sums to 1e-12 relative
    assert bench._rows_equal(got, want, tol=1e-12)
    assert df.fallback_summary()["fallback_ops"] == 0
    one = build(TpuSession(device="cpu"), t, F).toArrow()
    assert bench._rows_equal(got, one, tol=1e-12)
    cpu = dict(conf, **{"spark.rapids.sql.enabled": False})
    got_cpu = build(TpuSession(dict(cpu), device="cpu"), t, F).toArrow()
    want_cpu = build(JaxSession(dict(cpu)), t, JF).toArrow()
    assert got_cpu.equals(want_cpu)


@pytest.mark.parametrize("query", tpch.QUERIES)
def test_cpu_session_equals_jax_cpu_session(query):
    t = _tables_for(query)
    conf = {"spark.default.parallelism": 4, "spark.rapids.sql.enabled": False}
    got = tpch.build(query, TpuSession(dict(conf), device="cpu"), t)
    want = bench.TPCH_BUILDERS[query](JaxSession(dict(conf)), t)
    assert got.toArrow().equals(want.toArrow())


RUNS = ([(q, "defaults") for q in QUERIES]
        + [(q, "noBroadcast") for q in ("q3", "q4")])


@pytest.mark.parametrize("query, conf", RUNS,
                         ids=[f"{q}-{c}" for q, c in RUNS])
def test_query_matches_jax_under_parallelism(tables, query, conf):
    KN.COUNTERS.reset()
    df = tpch.build(query, TpuSession(dict(CONFS[conf]), device="cpu"),
                    tables)
    got = df.toArrow()
    jdf = bench.TPCH_BUILDERS[query](JaxSession(dict(CONFS[conf])), tables)
    want = jdf.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == [
        tuple(m.get(k, 0) for k in _STRATEGY)
        for name, m in jdf.metrics() if name == "TpuSortMergeJoinExec"]
    assert KN.COUNTERS.fallbacks == 0
    one = tpch.build(query, TpuSession(device="cpu"), tables).toArrow()
    assert bench._rows_equal(got, one, tol=1e-6)
