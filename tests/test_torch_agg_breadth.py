"""The aggregate breadth of the port — ``first``, the variance family,
``percentile``/``approx_percentile``, ``approx_count_distinct`` and the
holistic pass (min, max and first over strings) — against the JAX
package through the DataFrame API.

Mirrors the flat-result cases of ``tests/test_agg_breadth.py`` (the
variance family grouped, global, over one-row groups, an all-null group
and an int input; min/max/first over strings grouped, global and over
an empty input; the exact and approximate percentiles, with an all-null
group; ``approx_count_distinct``; the wide multi-string keys that sort
by the tuple hash) at its sizes, tables made with numpy from a seed,
and adds ``first`` and the percentiles over several batches
(``spark.rapids.tpu.batchRows`` 512) and under
``spark.default.parallelism=4``.  Every case runs through the JAX
package's session and the port's (``device="cpu"``) under the same
conf: the tree strings and the (empty) fallback reports are equal, the
rows are equal as multisets (``ORACLE_ONLY``'s cases against the JAX
package's CPU oracle) — keys, counts, strings, ``first`` and the
percentiles exactly, the variance family within the JAX tests'
``approx_float`` tolerance (1e-6 relative and absolute: the device sums
Σx and Σx² in another order).  The host branch (the CPU accumulators)
runs each case in a plain CPU session on both sides, and its rows equal
the JAX package's the same way.  Each JAX run is made once per module
(``jax_run``).
"""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession

REL = 1e-6  # the JAX tests' approx_float


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


def _t(n=3000, seed=21, nulls=True):
    """``tests/test_agg_breadth.py::_t``."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-100, 100, n)
    vals = [None if nulls and i % 13 == 0 else float(v[i])
            for i in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 20, n)),
        "v": pa.array(vals, pa.float64()),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
    })


def _str_table(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    words = ["apple", "Banana", "cherry", "", "zebra", "éclair",
             "apple pie", "APPLE"]
    s = [None if i % 17 == 0 else words[rng.integers(0, len(words))]
         for i in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 12, n)),
        "s": pa.array(s, pa.string()),
        "v": pa.array(rng.integers(0, 100, n)),
    })


def _pct_table():
    rng = np.random.default_rng(62)
    n = 6000
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n)),
        "v": pa.array(np.where(rng.random(n) < 0.08, None,
                               rng.normal(100, 40, n))),
        "i": pa.array(rng.integers(-500, 500, n)),
    })


def _wide_table():
    rng = np.random.default_rng(71)
    n = 8000
    names = [f"Customer#{i:09d}" for i in range(400)]
    nations = [f"NATION_{i:02d}" for i in range(25)]
    return pa.table({
        "ck": pa.array(rng.integers(0, 400, n)),
        "name": pa.array([names[i] for i in rng.integers(0, 400, n)]),
        "bal": pa.array(rng.uniform(-999, 9999, n).round(2)),
        "nat": pa.array([nations[i] for i in rng.integers(0, 25, n)]),
        "v": pa.array(rng.uniform(0, 100, n)),
    })


def _null_positions_table():
    return pa.table({
        "a": pa.array(["x", None, "x", None] * 50),
        "b": pa.array([None, "x", None, "x"] * 50),
        "c": pa.array(["pad_to_wide_key_0123456789"] * 200),
        "d": pa.array(["another_wide_padding_col__"] * 200),
        "v": pa.array(list(range(200)), type=pa.int64()),
    })


T_ = _t()
STR = _str_table()
PCT = _pct_table()
MULTI = {"spark.rapids.tpu.batchRows": 512}
P4 = {"spark.default.parallelism": 4}
VARIANCE_COLS = {"vs", "vp", "ss", "sp", "r", "sd"}

# name: (build(session, F), conf)
CASES = {
    "variance_family_grouped": (
        lambda s, F: s.createDataFrame(T_).groupBy("k").agg(
            F.var_samp("v").alias("vs"), F.var_pop("v").alias("vp"),
            F.stddev_samp("v").alias("ss"), F.stddev_pop("v").alias("sp")),
        {}),
    "variance_global": (
        lambda s, F: s.createDataFrame(T_).agg(
            F.var_samp("v").alias("vs"), F.stddev_pop("v").alias("sp")),
        {}),
    "variance_single_row_groups": (
        lambda s, F: s.createDataFrame(pa.table({
            "k": pa.array([1, 2, 3]), "v": pa.array([1.0, 2.0, 3.0])}))
        .groupBy("k").agg(F.var_samp("v").alias("vs"),
                          F.var_pop("v").alias("vp")), {}),
    "variance_all_null_group": (
        lambda s, F: s.createDataFrame(pa.table({
            "k": pa.array([1, 1, 2]),
            "v": pa.array([None, None, 5.0], pa.float64())}))
        .groupBy("k").agg(F.stddev_samp("v").alias("sd")), {}),
    "variance_int_input": (
        lambda s, F: s.createDataFrame(T_).groupBy("k").agg(
            F.variance("i").alias("r"), F.stddev("i").alias("sd"),
            F.mean("i").alias("m")), {}),
    "first_grouped_multi_batch": (
        lambda s, F: s.createDataFrame(T_).groupBy("k").agg(
            F.first("v").alias("f"), F.first("i").alias("fi"),
            F.sum("i").alias("si")), MULTI),
    "first_global_parallelism_4": (
        lambda s, F: s.createDataFrame(T_).agg(
            F.first("v").alias("f"), F.first("i").alias("fi"),
            F.var_pop("v").alias("vp")), dict(P4, **MULTI)),
    "min_max_string_grouped": (
        lambda s, F: s.createDataFrame(STR).groupBy("k").agg(
            F.min("s").alias("mn"), F.max("s").alias("mx"),
            F.count("s").alias("c")), {}),
    "first_string_grouped": (
        lambda s, F: s.createDataFrame(STR).groupBy("k").agg(
            F.first("s").alias("f")), {}),
    "first_string_grouped_parallelism_4": (
        lambda s, F: s.createDataFrame(STR).groupBy("k").agg(
            F.first("s").alias("f"), F.first("v").alias("fv")),
        dict(P4, **MULTI)),
    "min_max_string_global": (
        lambda s, F: s.createDataFrame(STR).agg(
            F.min("s").alias("mn"), F.max("s").alias("mx")), {}),
    "min_max_string_global_empty": (
        lambda s, F: s.createDataFrame(pa.table({
            "k": pa.array([], pa.int64()), "s": pa.array([], pa.string())}))
        .agg(F.min("s").alias("mn"), F.first("s").alias("f")), {}),
    "percentile_exact_and_approx": (
        lambda s, F: s.createDataFrame(PCT).groupBy("k").agg(
            F.percentile("v", 0.5).alias("p50"),
            F.percentile("i", 0.25).alias("p25"),
            F.percentile("v", 0.0).alias("p0"),
            F.percentile("v", 1.0).alias("p100"),
            F.percentile_approx("v", 0.9).alias("a90"),
            F.percentile_approx("i", 0.1).alias("a10")), {}),
    "percentile_all_null_group": (
        lambda s, F: s.createDataFrame(pa.table({
            "k": pa.array([0, 0, 1, 1]),
            "v": pa.array([None, None, 3.0, 5.0])}))
        .groupBy("k").agg(F.percentile("v", 0.5).alias("p"),
                          F.percentile_approx("v", 0.5).alias("a")), {}),
    "percentile_multi_batch_parallelism_4": (
        lambda s, F: s.createDataFrame(PCT).groupBy("k").agg(
            F.percentile("v", 0.75).alias("p75"),
            F.approx_percentile("i", 0.5).alias("a50"),
            F.sum("i").alias("si")), dict(P4, **MULTI)),
    "percentile_global": (
        lambda s, F: s.createDataFrame(PCT).agg(
            F.percentile("v", 0.5).alias("p50"),
            F.count("*").alias("c")), MULTI),
    "approx_count_distinct": (
        lambda s, F: s.createDataFrame(T_).groupBy("k").agg(
            F.approx_count_distinct("i").alias("acd")), {}),
    "wide_multi_string_key": (
        lambda s, F: s.createDataFrame(_wide_table())
        .groupBy("ck", "name", "bal", "nat")
        .agg(F.sum("v").alias("sv"), F.count("*").alias("c")), {}),
    "wide_key_null_positions": (
        lambda s, F: s.createDataFrame(_null_positions_table())
        .groupBy("a", "b", "c", "d")
        .agg(F.count("*").alias("n"), F.sum("v").alias("sv")), {}),
}
HOST = {"spark.rapids.sql.enabled": False}


# The cases whose JAX device run compiles for 4-25 s (the wide keys'
# four-pass murmur3 tuple hash, the variance family's f64 scans, the
# percentiles' sorts) hold the port's rows against the JAX package's
# CPU oracle, which its own tests hold its device run to, and its plan
# (tree string, fallback report) against the JAX session's plan made
# without running it; the rest run the JAX session's device path.
ORACLE_ONLY = {"wide_multi_string_key", "wide_key_null_positions",
               "variance_family_grouped", "variance_int_input",
               "variance_single_row_groups", "variance_all_null_group",
               "first_grouped_multi_batch", "percentile_exact_and_approx",
               "percentile_multi_batch_parallelism_4",
               "approx_count_distinct"}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF).toArrow(), None, None)
            elif name in ORACLE_ONLY:
                df = build(JaxSession(dict(conf)), JF)
                plan = df._execute_plan()  # planned, not run
                memo[(name, host)] = (
                    run(name, True)[0],
                    df._last_override.fallback_report(),
                    plan.tree_string())
            else:
                df = build(JaxSession(dict(conf)), JF)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=REL, abs_tol=REL)
    return a == b


def same_rows(got, want):
    """Equal row multisets: the variance columns within ``REL``, every
    other value exactly (by ``repr``: NaN and -0.0 included)."""
    assert got.schema == want.schema
    names = want.column_names
    exact = [n for n in names if n not in VARIANCE_COLS]

    def key(r):
        return repr([r[n] for n in exact])

    g = sorted(got.to_pylist(), key=key)
    w = sorted(want.to_pylist(), key=key)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for n in names:
            if n in VARIANCE_COLS:
                assert _close(rg[n], rw[n]), (n, rg, rw)
            else:
                assert repr(rg[n]) == repr(rw[n]), (n, rg, rw)


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want)
    assert df._last_override.fallback_report() == report == []
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F).toArrow()
    same_rows(got, jax_run(name, host=True)[0])


def _aggregates(node):
    out = [node] if isinstance(node, TpuHashAggregateExec) else []
    for c in node.children:
        out += _aggregates(c)
    return out


def test_holistic_functions_take_the_gathered_pass():
    """min/max/first over strings and the percentiles run on the device
    (no fallback) through the gathered single pass; a global one yields
    one row; the variance family and a numeric first stay on the
    partial/merge passes."""
    from spark_rapids_tpu_torch.exec import aggregate as AG
    s = TpuSession({"spark.rapids.sql.test.enabled": True}, device="cpu")
    calls = []
    real = AG.TpuHashAggregateExec._execute_collect

    def spy(self, *a):
        calls.append(self)
        return real(self, *a)

    AG.TpuHashAggregateExec._execute_collect = spy
    try:
        for aggs, holistic in (
                ([F.min("s")], True), ([F.first("s")], True),
                ([F.percentile("v", 0.5)], True),
                ([F.approx_percentile("v", 0.5)], True),
                ([F.var_samp("v"), F.first("v")], False)):
            calls.clear()
            df = s.createDataFrame(STR).groupBy("k").agg(*aggs)
            assert df.toArrow().num_rows == 12
            assert bool(calls) == holistic
        out = s.createDataFrame(STR.slice(0, 0)).agg(
            F.max("s").alias("m"), F.percentile("v", 0.5).alias("p"))
        assert out.toArrow().to_pylist() == [{"m": None, "p": None}]
    finally:
        AG.TpuHashAggregateExec._execute_collect = real


def test_collect_and_decimal_inputs_stay_refused():
    """What the aggregate path still refuses: a window function inside
    ``agg`` and a row python UDF there (the analyzer refuses both as the
    JAX package's does), and the JAX package's own argument errors."""
    from spark_rapids_tpu_torch.sql.column import Column, UExpr
    df = TpuSession(device="cpu").createDataFrame(T_)
    for op, payload, exc, what in (
            ("winfn", ("row_number",), AnalysisException,
             "unknown expression op 'winfn'"),
            ("pyudf", (abs, T_.schema.field("v").type, False, "abs"),
             AnalysisException,
             "python UDFs are only supported as top-level select")):
        agg = Column(UExpr("agg", "sum", (UExpr(op, payload, ()),)))
        with pytest.raises(exc, match=what):
            df.groupBy("k").agg(agg)
    with pytest.raises(AnalysisException, match=r"must be in \[0, 1\]"):
        df.agg(F.percentile("v", 1.5))
    with pytest.raises(AnalysisException, match="numeric input"):
        TpuSession(device="cpu").createDataFrame(STR).agg(
            F.stddev("s"))
    with pytest.raises(ValueError, match="rsd"):
        F.approx_count_distinct("i", rsd=1.5)
