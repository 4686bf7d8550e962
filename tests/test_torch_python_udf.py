"""The python / pandas UDF bridge in the port against the JAX package.

Every case of ``tests/test_python_udf.py`` (row and pandas UDFs, UDFs
over computed arguments, the decorator form, several UDFs in one
select, a UDF then a filter and an aggregate, ``mapInPandas``,
``applyInPandas``, a zero-argument UDF, nulls across the bridge, the
grouped-aggregate pandas UDFs and the four error cases) runs through the
port's session (``device="cpu"``, under ``spark.rapids.sql.test.enabled``)
and the JAX package's: rows, tree strings and fallback reports are
equal, and the CPU sessions of both give equal rows.  Added here: a row
UDF over a date column (a date crosses the bridge as ``datetime.date``,
a null as ``None``), the device execs' ``transferTime`` and ``udfTime``,
and the bridge moving only the argument columns.

Tolerances: integers, strings, nulls and row sets exactly; a UDF's
per-row doubles exactly (both packages hand the function the same
bits), or within 1e-12 relative where rows reach a grouped function in
another order; float aggregates within ``bench._rows_equal(tol=1e-6)``.
Each JAX run is made once per module (``jax_run``).
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench
from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.plan.analysis import AnalysisException as JAE
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession
from spark_rapids_tpu.sql.window import Window as JWindow

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.sql.window import Window


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ensure_initialized()
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


def base_table(n=300, seed=0):
    """``tests/test_python_udf.py::base_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array((np.arange(n) % 5).astype(np.int32)),
        "a": pa.array(rng.integers(-100, 100, n)),
        "b": pa.array(rng.normal(size=n)),
        "s": pa.array([f"row{i}" for i in range(n)]),
    })


def _grouped_agg_table():
    rng = np.random.default_rng(11)
    return pa.table({"k": pa.array(rng.integers(0, 7, 900)),
                     "v": pa.array(rng.uniform(-5, 5, 900))})


def _dates_table():
    d0 = datetime.date(1992, 1, 1)
    return pa.table({
        "id": pa.array(np.arange(40, dtype=np.int64)),
        "d": pa.array([None if i % 7 == 3 else d0 + datetime.timedelta(
            days=97 * i) for i in range(40)], pa.date32())})


TABLES = {"t0": base_table(), "t1": base_table(1), "t2": base_table(2),
          "t3": base_table(3), "t4": base_table(4), "t5": base_table(5),
          "t6": base_table(6), "t7": base_table(7), "t8": base_table(8),
          "t11": base_table(50, 11),
          "nulls": pa.table({"x": pa.array([1, None, 3], type=pa.int64())}),
          "agg": _grouped_agg_table(), "dates": _dates_table()}
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}


def _parity(F):
    @F.udf(returnType="int")
    def parity(x):
        return int(x) % 2 if x is not None else None

    return parity


def _double_and_filter(frames):
    for df in frames:
        out = df[df["a"] > 0][["k", "a"]].copy()
        out["a"] = out["a"] * 2
        yield out


def _center(g):
    out = g[["k", "b"]].copy()
    out["b"] = out["b"] - out["b"].mean()
    return out


def _wmean(F):
    @F.pandas_udf(returnType="double")
    def wmean(v):
        return float((v * 2).mean())

    return wmean


def _schema(T, *fields):
    return T.StructType(tuple(T.StructField(n, getattr(T, t))
                              for n, t in fields))


# name: (build(session, F, col, T), conf, ordered, float tolerance)
# tolerance 0 = exactly; "agg" = bench._rows_equal(tol=1e-6)
CASES = {
    "row_udf": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t0"]).select(
            "a", F.udf(lambda x: None if x is None else int(x) + 1,
                       "long")(c("a")).alias("a1")), TEST, True, 0),
    "row_udf_two_args_string": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t1"]).select(
            F.udf(lambda k, s: f"{s}#{k}", "string")(
                c("k"), c("s")).alias("f")), TEST, True, 0),
    "pandas_udf_vectorized": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t2"]).select(
            "b", F.pandas_udf(lambda x: x * 2.0, "double")(
                c("b")).alias("b2")), TEST, True, 0),
    "udf_over_expression_args": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t3"]).select(
            F.pandas_udf(lambda x: x.abs(), "double")(
                (c("a") + c("b")) / 2.0).alias("m")), TEST, True, 0),
    "udf_decorator_form": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t4"]).select(
            "a", _parity(F)(c("a")).alias("p")), TEST, True, 0),
    "multiple_udfs_one_select": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t5"]).select(
            F.udf(lambda x: int(x) * 10, "long")(c("a")).alias("x"), "k",
            F.pandas_udf(lambda x: -x, "double")(c("b")).alias("y")),
        TEST, True, 0),
    "udf_then_filter_agg": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t6"])
        .select("k", F.pandas_udf(lambda x: x * x, "double")(
            c("b")).alias("b2"))
        .filter(c("b2") > 0.5)
        .groupBy("k").agg(F.sum("b2").alias("sb")), TEST, False, "agg"),
    "map_in_pandas": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t7"]).mapInPandas(
            _double_and_filter,
            _schema(T, ("k", "IntegerT"), ("a", "LongT"))),
        TEST, False, 0),
    "apply_in_pandas_grouped": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t8"]).groupBy("k")
        .applyInPandas(_center,
                       _schema(T, ("k", "IntegerT"), ("b", "DoubleT"))),
        dict(TEST, **{"spark.sql.shuffle.partitions": 3}), False, 1e-12),
    "zero_arg_udf": (
        lambda s, F, c, T: s.createDataFrame(TABLES["t11"]).select(
            "k", F.udf(lambda: 1, "long")().alias("c")), TEST, True, 0),
    "udf_nulls_cross_bridge": (
        lambda s, F, c, T: s.createDataFrame(TABLES["nulls"]).select(
            F.udf(lambda v: None if v is None else v * 100, "long")(
                c("x")).alias("y")), TEST, True, 0),
    "pandas_udf_grouped_agg": (
        lambda s, F, c, T: s.createDataFrame(TABLES["agg"]).groupBy("k")
        .agg(_wmean(F)(c("v")).alias("wm")),
        dict(TEST, **{"spark.rapids.sql.test.allowedNonGpu":
                      "FlatMapGroupsInPandas,InMemoryScan,HashAggregate"}),
        False, "agg"),
    "global_pandas_udf_agg": (
        lambda s, F, c, T: s.createDataFrame(TABLES["agg"])
        .agg(_wmean(F)(c("v")).alias("wm")), TEST, True, "agg"),
    "row_udf_over_dates": (
        lambda s, F, c, T: s.createDataFrame(TABLES["dates"]).select(
            "id", F.udf(lambda d: None if d is None
                        else d.year * 10000 + d.month * 100 + d.day,
                        "int")(c("d")).alias("ymd")), TEST, True, 0),
}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf, _, _ = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol, JT).toArrow(), None, None)
            else:
                df = build(JaxSession(dict(conf)), JF, jcol, JT)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


def _key(r):
    return repr(tuple(round(v, 9) if isinstance(v, float) else v
                      for v in r.values()))


def same_rows(got: pa.Table, want: pa.Table, ordered: bool, tol) -> None:
    assert got.schema == want.schema
    if tol == "agg":
        assert bench._rows_equal(got, want, tol=1e-6)
        return
    g, w = got.to_pylist(), want.to_pylist()
    if not ordered:
        g, w = sorted(g, key=_key), sorted(w, key=_key)
    if tol == 0:
        assert [repr(r) for r in g] == [repr(r) for r in w]
        return
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for u, v in zip(rg.values(), rw.values()):
            if isinstance(u, float) and isinstance(v, float):
                assert abs(u - v) <= tol * max(abs(u), abs(v)), (u, v)
            else:
                assert u == v


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf, ordered, tol = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col, T)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want, ordered, tol)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf, ordered, tol = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F, col,
                T).toArrow()
    same_rows(got, jax_run(name, host=True)[0], ordered, tol)


def test_what_the_jax_tests_pin(jax_run):
    """The facts ``tests/test_python_udf.py`` states of its cases: nulls
    cross as ``None`` and come back null; a zero-argument UDF fills
    every live row; a date arrives as ``datetime.date``."""
    assert jax_run("udf_nulls_cross_bridge")[0].column("y").to_pylist() \
        == [100, None, 300]
    assert jax_run("zero_arg_udf")[0].column("c").to_pylist() == [1] * 50
    ymd = jax_run("row_udf_over_dates")[0].column("ymd").to_pylist()
    assert ymd[0] == 19920101 and ymd[3] is None


def test_apply_in_pandas_matches_engine_agg():
    """A grouped-map sum equals the engine's own groupBy sum (the JAX
    test's check), and both equal the JAX package's."""
    import pandas as pd

    def gsum(g):
        return pd.DataFrame({"k": [g["k"].iloc[0]],
                             "sb": [g["b"].sum()]})

    t = base_table(9)

    def run(s, F, T):
        schema = T.StructType((T.StructField("k", T.IntegerT),
                               T.StructField("sb", T.DoubleT)))
        got = {r.k: r.sb for r in s.createDataFrame(t).groupBy("k")
               .applyInPandas(gsum, schema).collect()}
        want = {r.k: r.sb for r in s.createDataFrame(t).groupBy("k")
                .agg(F.sum("b").alias("sb")).collect()}
        return got, want

    got, want = run(TpuSession(dict(TEST), device="cpu"), F, T)
    jgot, _ = run(JaxSession(dict(TEST)), JF, JT)
    assert set(got) == set(want) == set(jgot)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-9
        assert got[k] == jgot[k]


def _bad_frames(frames):
    import pandas as pd
    for _ in frames:
        yield pd.DataFrame({"wrong": [1]})


def _raises(build_port, build_jax, exc_port, exc_jax, match):
    with pytest.raises(exc_jax, match=match) as je:
        build_jax()
    with pytest.raises(exc_port, match=match) as pe:
        build_port()
    assert str(pe.value) == str(je.value)


def test_udf_result_missing_column_raises():
    t = base_table(10)

    def build(s, T):
        schema = T.StructType((T.StructField("k", T.IntegerT),))
        return s.createDataFrame(t).mapInPandas(_bad_frames, schema)

    _raises(lambda: build(TpuSession(dict(TEST), device="cpu"),
                          T).collect(),
            lambda: build(JaxSession(dict(TEST)), JT).collect(),
            ValueError, ValueError, "missing declared columns")


def test_pandas_udf_wrong_length_raises():
    t = base_table(12)

    def build(s, F, c):
        bad = F.pandas_udf(lambda x: x.head(5), "double")
        return s.createDataFrame(t).select(bad(c("b")).alias("x"))

    _raises(lambda: build(TpuSession(dict(TEST), device="cpu"), F,
                          col).collect(),
            lambda: build(JaxSession(dict(TEST)), JF, jcol).collect(),
            ValueError, ValueError, "expected")


def test_udf_window_mix_raises():
    t = base_table(13)

    def build(s, F, c, W):
        u = F.udf(lambda x: x, "long")
        w = W.partitionBy("k").orderBy("a")
        return s.createDataFrame(t).select(
            u(c("a")).alias("ua"), F.row_number().over(w).alias("r"))

    _raises(lambda: build(TpuSession(dict(TEST), device="cpu"), F, col,
                          Window),
            lambda: build(JaxSession(dict(TEST)), JF, jcol, JWindow),
            AnalysisException, JAE, "mix python UDFs")


def test_pandas_udf_grouped_agg_mixing_rejected():
    t = pa.table({"k": pa.array([1, 2]), "v": pa.array([1.0, 2.0])})

    def build(s, F, c):
        @F.pandas_udf(returnType="double")
        def m(v):
            return float(v.mean())

        return s.createDataFrame(t).groupBy("k").agg(m(c("v")),
                                                     F.sum("v"))

    _raises(lambda: build(TpuSession({}, device="cpu"), F, col),
            lambda: build(JaxSession({}), JF, jcol),
            AnalysisException, JAE, "mix")


def test_a_udf_outside_a_select_raises():
    """A python UDF is a top-level select expression only: inside a
    filter both analyzers refuse it with the same message."""
    t = base_table(14)

    def build(s, F, c):
        u = F.udf(lambda x: x > 0, "boolean")
        return s.createDataFrame(t).filter(u(c("a")))

    _raises(lambda: build(TpuSession({}, device="cpu"), F, col),
            lambda: build(JaxSession({}), JF, jcol),
            AnalysisException, JAE, "top-level select")


def test_the_bridge_moves_only_argument_columns():
    """The device exec evaluates the arguments on the device, copies only
    those columns to the host (``transferTime``), times the function
    (``udfTime``) and appends the result to the batch it was given."""
    seen = []
    from spark_rapids_tpu_torch.exec import python_udf as PU
    real = PU.device_to_host

    def spy(batch):
        seen.append(batch.schema.field_names())
        return real(batch)

    PU.device_to_host = spy
    try:
        df = TpuSession(dict(TEST), device="cpu").createDataFrame(
            TABLES["t0"]).select(
            "s", F.udf(lambda a, b: a * b, "double")(
                col("a") + 1, col("b")).alias("y"))
        out = df.toArrow()
    finally:
        PU.device_to_host = real
    assert seen == [["_u0a0", "_u0a1"]]
    t = TABLES["t0"]
    assert out.column("y").to_pylist() == [
        (a + 1) * b for a, b in zip(t.column("a").to_pylist(),
                                    t.column("b").to_pylist())]
    node = [m for n, m in df.metrics() if n == "TpuArrowEvalPythonExec"][0]
    assert node["transferTime"] > 0 and node["udfTime"] > 0
    assert 0 < node["udfTime"] <= node["opTime"]
