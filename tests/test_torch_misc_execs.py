"""The port's range, sample, expand (rollup, cube), limit and union execs
and the DataFrame methods over them, against the JAX package on the same
inputs.

Mirrors ``tests/test_misc_execs.py`` (range, sample, rollup and cube)
and ``tests/test_dataframe_exec.py`` (limit, the global limit across
partitions, an aggregate above an empty limit, union, ``withColumn``,
``drop`` and ``GroupedData``'s shorthand aggregates), at those tests'
sizes, tables made with numpy from a seed.  Every case runs through the
JAX package's session and the port's (``device="cpu"``) under the same
conf; the port's tree string and fallback report equal the JAX
package's.  Pass-through results (range, sample, limit, union, column
edits) equal the JAX package's row for row, NaN and -0.0 included;
aggregates under ``bench._rows_equal(tol=1e-6)`` (keys, counts and
nulls exactly).  The sample's CPU oracle (the port's CPU session) draws
the device path's rows under parallelism 1 and 4.  Each JAX run is made
once per module (``jax_run``).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession
from spark_rapids_tpu.utils import datagen as dg

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kv_table(seed=0, n=400):
    """``tests/test_misc_execs.py::kv_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array((np.arange(n) % 7).astype(np.int32)),
        "g": pa.array([f"g{i % 3}" for i in range(n)]),
        "v": dg.DoubleGen().generate(rng, n),
        "i": dg.IntegerGen().generate(rng, n),
    })


def gen_table(seed=0, n=500):
    """``tests/test_dataframe_exec.py::gen_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": dg.IntegerGen().generate(rng, n),
        "l": dg.LongGen().generate(rng, n),
        "d": dg.DoubleGen().generate(rng, n),
        "f": dg.FloatGen().generate(rng, n),
        "s": dg.StringGen().generate(rng, n),
        "b": dg.BooleanGen().generate(rng, n),
        "g": pa.array([f"g{int(x) % 7}" for x in range(n)]),
        "k": pa.array((np.arange(n) % 13).astype(np.int32)),
    })


NULL_KEYS = pa.table({
    "k": pa.array([1, None, 2, None, 1], type=pa.int32()),
    "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
})
NULL_STRING_KEYS = pa.table({
    "g": pa.array(["a", None, "bb", None, "a"]),
    "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
})
P4 = {"spark.default.parallelism": 4}

# name: (build(session, F, col), conf, ordered).  ``ordered``: the rows
# must equal the JAX package's in order, exactly.
CASES = {
    # -- range
    "range_simple": (lambda s, F, col: s.range(100), {}, True),
    "range_step_partitions": (
        lambda s, F, col: s.range(5, 95, 3, numPartitions=4), {}, True),
    "range_negative_step": (lambda s, F, col: s.range(50, 0, -7), {}, True),
    "range_empty": (lambda s, F, col: s.range(10, 10), {}, True),
    "range_feeds_ops": (
        lambda s, F, col: s.range(0, 1000, 1, numPartitions=3)
        .filter(col("id") % 5 == 0).select((col("id") * 2).alias("x")),
        {}, True),
    "range_default_parallelism": (lambda s, F, col: s.range(3, 40), P4,
                                  True),
    # -- sample
    "sample_oracle_equal": (
        lambda s, F, col: s.createDataFrame(kv_table()).sample(0.5, 42),
        {}, True),
    "sample_parallelism_4": (
        lambda s, F, col: s.createDataFrame(kv_table()).sample(0.5, 42),
        P4, True),
    "sample_seed_1": (
        lambda s, F, col: s.createDataFrame(
            pa.table({"x": pa.array(np.arange(5000, dtype=np.int64))}))
        .sample(0.5, 1), {}, True),
    "sample_seed_2": (
        lambda s, F, col: s.createDataFrame(
            pa.table({"x": pa.array(np.arange(5000, dtype=np.int64))}))
        .sample(0.5, 2), {}, True),
    "sample_full_fraction": (
        lambda s, F, col: s.createDataFrame(kv_table(12)).sample(1.0, 5),
        {}, True),
    "sample_keyword_seed": (
        lambda s, F, col: s.createDataFrame(kv_table(13))
        .sample(0.4, seed=7).select("k", "i"), {}, True),
    "sample_then_aggregate": (
        lambda s, F, col: s.createDataFrame(kv_table(14))
        .sample(0.3, 11).groupBy("g").agg(F.sum("v").alias("s"),
                                          F.count("*").alias("c")),
        P4, False),
    # -- expand: rollup and cube
    "rollup_single_key": (
        lambda s, F, col: s.createDataFrame(kv_table(1)).rollup("k").agg(
            F.sum("v").alias("s"), F.count("*").alias("c")), {}, False),
    "rollup_two_keys": (
        lambda s, F, col: s.createDataFrame(kv_table(2)).rollup("k", "g")
        .agg(F.sum("v").alias("s")), {}, False),
    "cube_two_keys": (
        lambda s, F, col: s.createDataFrame(kv_table(4)).cube("k", "g").agg(
            F.min("i").alias("mn"), F.max("v").alias("mx")), {}, False),
    "rollup_row_counts": (
        lambda s, F, col: s.createDataFrame(kv_table(5)).rollup("k").agg(
            F.count("*").alias("c")), {}, False),
    "cube_null_keys": (
        lambda s, F, col: s.createDataFrame(NULL_KEYS).cube("k").agg(
            F.sum("v").alias("s")), {}, False),
    "cube_null_string_keys": (
        lambda s, F, col: s.createDataFrame(NULL_STRING_KEYS).cube("g")
        .agg(F.sum("v").alias("s"), F.count("*").alias("c")), {}, False),
    # -- limits
    "limit": (
        lambda s, F, col: s.createDataFrame(gen_table(3))
        .select("i", "s").limit(17), {}, True),
    "global_limit_10": (
        lambda s, F, col: s.createDataFrame(gen_table(20, 100)).limit(10)
        .select("i"), P4, True),
    "global_limit_95": (
        lambda s, F, col: s.createDataFrame(gen_table(20, 100)).limit(95)
        .select("i"), P4, True),
    "filtered_limit_parallelism_4": (
        lambda s, F, col: s.createDataFrame(gen_table(22))
        .filter(col("k") > 9).limit(40), P4, True),
    "grouped_aggregate_above_empty_limit": (
        lambda s, F, col: s.createDataFrame(gen_table(21, 50)).limit(0)
        .groupBy("g").agg(F.sum("i").alias("si")), {}, False),
    "global_aggregate_above_empty_limit": (
        lambda s, F, col: s.createDataFrame(gen_table(21, 50)).limit(0)
        .agg(F.sum("i").alias("si"), F.count("*").alias("c")), {}, False),
    # -- union and column edits
    "union": (
        lambda s, F, col: s.createDataFrame(gen_table(4, 100))
        .union(s.createDataFrame(gen_table(5, 80))), {}, True),
    "union_partitions": (
        lambda s, F, col: s.createDataFrame(gen_table(4, 100))
        .select("i", "s").unionAll(
            s.createDataFrame(gen_table(5, 80)).select("k", "g")),
        P4, True),
    "with_column_and_drop": (
        lambda s, F, col: s.createDataFrame(gen_table(6))
        .withColumn("i", col("i") * 10).withColumn("kk", col("k") + 1)
        .drop("d", "f"), {}, True),
    "grouped_sum": (
        lambda s, F, col: s.createDataFrame(kv_table(8)).groupBy("g")
        .sum("v", "i"), {}, False),
    "grouped_count": (
        lambda s, F, col: s.createDataFrame(kv_table(8)).groupBy("g")
        .count(), {}, False),
    "grouped_avg": (
        lambda s, F, col: s.createDataFrame(kv_table(8)).groupBy("g")
        .avg(), {}, False),
}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name)`` -> the JAX package's (result, fallback report, tree
    string) of a case, run once per module."""
    memo = {}

    def run(name):
        if name not in memo:
            build, conf, _ = CASES[name]
            df = build(JaxSession(dict(conf)), JF, jcol)
            out = df.toArrow()
            memo[name] = (out, df._last_override.fallback_report(),
                          df._last_plan.tree_string())
        return memo[name]

    return run


def _port(name, conf=None):
    build, case_conf, _ = CASES[name]
    df = build(TpuSession(dict(case_conf, **(conf or {})), device="cpu"),
               F, col)
    return df, df.toArrow()


def _same_rows(got, want, ordered):
    assert got.schema == want.schema
    if ordered:
        assert repr(got.to_pylist()) == repr(want.to_pylist())
    else:
        assert bench._rows_equal(got, want, tol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_equals_jax(jax_run, name):
    df, got = _port(name)
    want, report, tree = jax_run(name)
    _same_rows(got, want, CASES[name][2])
    assert df._last_override.fallback_report() == report == []
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", ["sample_oracle_equal",
                                  "sample_parallelism_4",
                                  "sample_then_aggregate"])
def test_sample_cpu_oracle_draws_the_device_rows(jax_run, name):
    """The CPU session's hash draw over compacted host batches keeps the
    rows the device path keeps (``seed + partition`` per partition)."""
    _, device = _port(name)
    _, cpu = _port(name, {"spark.rapids.sql.enabled": False})
    _same_rows(cpu, device, CASES[name][2])
    _same_rows(cpu, jax_run(name)[0], CASES[name][2])


def test_sample_is_deterministic_and_seeded(jax_run):
    a = _port("sample_keyword_seed")[1]
    assert a.equals(_port("sample_keyword_seed")[1])
    one, two = _port("sample_seed_1")[1], _port("sample_seed_2")[1]
    assert not one.equals(two)
    assert one.equals(jax_run("sample_seed_1")[0])
    # full fraction keeps every row
    assert _port("sample_full_fraction")[1].num_rows == 400


def test_sample_arguments():
    df = TpuSession(device="cpu").createDataFrame(kv_table())
    with pytest.raises(NotImplementedError, match="withReplacement"):
        df.sample(True, 0.5, 1)
    with pytest.raises(AnalysisException, match="fraction"):
        df.sample(1.5)
    assert df.sample(False, 0.5, 3)._plan.seed == 3
    assert df.sample(0.5, 3)._plan.seed == 3
    assert df.sample(0.5, 3, seed=4)._plan.seed == 4
    assert 0 <= df.sample(0.5)._plan.seed < 2**31


def test_rollup_and_cube_row_counts(jax_run):
    # rollup(k) over 7 distinct keys: 7 + 1 grand total
    assert _port("rollup_row_counts")[0].count() == 8
    # cube(k) over k in {1, 2, null}: 3 groups, and the grand total
    # apart from the null key's group
    rows = sorted(_port("cube_null_keys")[1].to_pylist(), key=repr)
    assert rows == sorted([{"k": 1, "s": 6.0}, {"k": 2, "s": 3.0},
                           {"k": None, "s": 6.0},
                           {"k": None, "s": 15.0}], key=repr)
    assert rows == sorted(jax_run("cube_null_keys")[0].to_pylist(),
                          key=repr)


def test_count_distinct_under_rollup_is_refused():
    df = TpuSession(device="cpu").createDataFrame(kv_table())
    with pytest.raises(AnalysisException, match="rollup/cube"):
        df.rollup("k").agg(F.countDistinct("i"))
    with pytest.raises(AnalysisException, match="rollup/cube"):
        df.cube("k", "g").agg(F.countDistinct("i"))
    jdf = JaxSession().createDataFrame(kv_table())
    with pytest.raises(Exception, match="rollup/cube"):
        jdf.rollup("k").agg(JF.countDistinct("i"))


def test_with_column_replaces_in_place():
    t = pa.table({"a": [1], "b": [2], "c": [3]})
    out = TpuSession(device="cpu").createDataFrame(t).withColumn(
        "b", col("b") * 10)
    assert out.columns == ["a", "b", "c"]
    assert out.collect()[0].b == 20
    assert out.drop("a", "c").columns == ["b"]
    assert out.toPandas()["b"].tolist() == [20]


def test_grouped_shorthands_name_their_columns():
    """``min/max/mean`` are ``agg`` of the function over each named
    column (every numeric non-key column when none is named), each
    named ``fn(column)``, as in the JAX package."""
    df = TpuSession(device="cpu").createDataFrame(kv_table(9))
    g = df.groupBy("k")
    for kind, fn in (("min", F.min), ("max", F.max), ("avg", F.avg)):
        got = (g.mean() if kind == "avg" else getattr(g, kind)()).toArrow()
        want = g.agg(*[fn(c).alias(f"{kind}({c})")
                       for c in ("v", "i")]).toArrow()
        assert got.column_names == ["k", f"{kind}(v)", f"{kind}(i)"]
        assert repr(got.to_pylist()) == repr(want.to_pylist())


def test_union_schema_is_the_first_childs():
    s = TpuSession(device="cpu")
    a = s.createDataFrame(pa.table({"x": pa.array([1, 2])}))
    b = s.createDataFrame(pa.table({"y": pa.array([3])}))
    out = a.union(b)
    assert out.columns == ["x"] and out.count() == 3
    with pytest.raises(AnalysisException, match="column count"):
        a.union(b.withColumn("z", col("y")))


def test_limits_stop_pulling_once_they_have_their_rows():
    """The global limit pulls no partition and no batch past the one
    that completes its rows, and the scan it abandons closes the cache
    registrations it made."""
    M.reset_manager()
    B.clear_scan_cache()
    s = TpuSession({"spark.default.parallelism": 4,
                    "spark.rapids.tpu.batchRows": 16}, device="cpu")
    df = s.createDataFrame(gen_table(23, 256)).limit(20)
    assert df.count() == 20
    scans = [m for name, m in df.metrics() if name == "TpuScanExec"]
    assert scans == [dict(scans[0], numOutputBatches=2,
                          numOutputRows=32)]
    mgr = M.peek_manager()
    assert not mgr._spillables and mgr._reserved == 0
    assert not B._scan_cache
    M.reset_manager()


def test_show_prints_the_first_rows(capsys):
    TpuSession(device="cpu").range(3, 9).show(2)
    out = capsys.readouterr().out
    assert "3" in out and "4" in out and "5" not in out
