"""The modules the eleven new TPC-H queries brought into the port, each
against its JAX counterpart on seeded numpy inputs: ``Divide``, ``If``,
``CaseWhen``, the numeric and boolean ``Cast``, ``Year`` (days before
1970 included), ``Min`` and ``Max`` (grouped and global, with NaN, -0.0
and nulls), the count(DISTINCT) rewrite with nulls, and the five TPC-H
tables ``gen_tpch`` gained.

The expressions evaluate on one batch per package over the same
buffers (the JAX package's ``host_to_device``, handed to the port
through ``column.from_numpy_batch``); validity must agree on every live
row and values on every valid live row, bit for bit (floats compared as
bits, except that -0.0 and 0.0 are equal only where noted).  The
aggregates run through both DataFrame APIs and are compared row for row
after sorting, with NaN equal only to NaN.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import bench

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar.column import host_to_device as j_h2d  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.ops import datetime_ops as JD  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.ops import datetime_ops as D  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402
from spark_rapids_tpu_torch.utils import tpch  # noqa: E402

N = 4000


def _table(seed=23):
    rng = np.random.default_rng(seed)
    null = rng.random((6, N)) < 0.1
    specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.5,
                         3e9, -3e9, 9.3e18, -9.3e18, 1e300, 0.999999])
    d1 = np.where(rng.random(N) < 0.4, rng.choice(specials, N),
                  rng.normal(0, 1e6, N))
    d2 = np.where(rng.random(N) < 0.2, rng.choice([0.0, -0.0, np.nan], N),
                  rng.normal(0, 10, N))
    return pa.table({
        "d1": pa.array(d1, mask=null[0]),
        "d2": pa.array(d2, mask=null[1]),
        "i": pa.array(rng.integers(-5, 5, N).astype(np.int32)
                      * rng.integers(1, 1 << 28, N).astype(np.int32),
                      mask=null[2]),
        "l": pa.array(rng.integers(-1 << 62, 1 << 62, N) * 2,
                      mask=null[3]),
        "b": pa.array(rng.random(N) < 0.5, mask=null[4]),
        "dt": pa.array(rng.integers(-800_000, 800_001, N).astype(np.int32),
                       mask=null[5]).cast(pa.date32()),
        "s": pa.array([["", "ab", "été", "x" * 11][k]
                       for k in rng.integers(0, 4, N)]),
    })


@pytest.fixture(scope="module")
def batches():
    jb = j_h2d(_table())
    sel = np.asarray(jb.sel)
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity),
               None if c.lengths is None else np.asarray(c.lengths))
              for c in jb.columns]
    schema = T.StructType(tuple(
        T.StructField(f.name, getattr(T, type(f.dtype).__name__)())
        for f in jb.schema.fields))
    return jb, from_numpy_batch(schema, arrays, sel, "cpu")


class _Both:
    """Builds one expression in both packages: ``ref("d1")`` is a bound
    column, ``lit(v, "DoubleT")`` a literal, ``node("Divide", a, b)``
    an expression node of the class of that name."""

    def __init__(self, jb):
        self.schema = jb.schema

    def ref(self, name):
        i = self.schema.field_index(name)
        dt = self.schema.fields[i].dtype
        return (JE.BoundReference(i, dt),
                E.BoundReference(i, getattr(T, type(dt).__name__)()))

    @staticmethod
    def lit(v, dt):
        return JE.Literal(v, getattr(JT, dt)), E.Literal(v, getattr(T, dt))

    @staticmethod
    def node(name, *args, **kw):
        jmod = JD if name == "Year" else JE
        pmod = D if name == "Year" else E
        return (getattr(jmod, name)(*[a[0] for a in args], **kw),
                getattr(pmod, name)(*[a[1] for a in args], **kw))

    @staticmethod
    def cast(a, dt):
        return JE.Cast(a[0], getattr(JT, dt)), E.Cast(a[1], getattr(T, dt))

    @staticmethod
    def case(branches, else_value=None):
        return (JE.CaseWhen([(p[0], v[0]) for p, v in branches],
                            None if else_value is None else else_value[0]),
                E.CaseWhen([(p[1], v[1]) for p, v in branches],
                           None if else_value is None else else_value[1]))


def _bits(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.float64:
        return x.view(np.int64)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


def _check(pair, batches):
    jb, pb = batches
    jexpr, pexpr = pair
    jc = jexpr.eval_tpu(jb)
    pc = pexpr.eval(pb)
    assert pexpr.dtype.simple_name == jexpr.dtype.simple_name
    live = np.asarray(jb.sel)
    jv = np.asarray(jc.valid_mask())[live]
    pv = pc.valid_mask().numpy()[live]
    assert np.array_equal(jv, pv)
    jd = np.asarray(jc.data)[live][jv]
    pd = pc.data.numpy()[live][jv]
    assert pd.dtype == jd.dtype
    if jc.lengths is not None:
        jl = np.asarray(jc.lengths)[live][jv]
        assert np.array_equal(pc.lengths.numpy()[live][jv], jl)
        for r, n in zip(range(len(jl)), jl):
            assert bytes(pd[r, :n]) == bytes(jd[r, :n])
        return pv
    assert np.array_equal(_bits(pd), _bits(jd))
    return pv


def _cases(b):
    d1, d2, i, l, bo = (b.ref(n) for n in ("d1", "d2", "i", "l", "b"))
    gt = b.node("GreaterThan", d2, b.lit(0.5, "DoubleT"))
    return {
        "divide": b.node("Divide", d1, d2),
        "divide_int_by_long": b.node("Divide", b.cast(i, "DoubleT"),
                                     b.cast(l, "DoubleT")),
        "divide_by_literal_zero": b.node("Divide", d1,
                                         b.lit(0.0, "DoubleT")),
        "if": b.node("If", bo, d1, d2),
        "if_null_branch": b.node("If", gt, i, b.lit(None, "IntegerT")),
        "case_else": b.case([(bo, d1), (gt, d2)], b.lit(-1.0, "DoubleT")),
        "case_no_else": b.case([(bo, i), (gt, b.lit(7, "IntegerT"))]),
        "case_strings": b.case([(gt, b.ref("s"))], b.lit("zz", "StringT")),
        "cast_int_to_double": b.cast(i, "DoubleT"),
        "cast_long_to_int": b.cast(l, "IntegerT"),
        "cast_double_to_long": b.cast(d1, "LongT"),
        "cast_double_to_int": b.cast(d1, "IntegerT"),
        "cast_long_to_double": b.cast(l, "DoubleT"),
        "cast_int_to_bool": b.cast(i, "BooleanT"),
        "cast_double_to_bool": b.cast(d1, "BooleanT"),
        "cast_bool_to_int": b.cast(bo, "IntegerT"),
        "cast_bool_to_double": b.cast(bo, "DoubleT"),
        "year": b.node("Year", b.ref("dt")),
    }


_CASE_NAMES = [
    "divide", "divide_int_by_long", "divide_by_literal_zero", "if",
    "if_null_branch", "case_else", "case_no_else", "case_strings",
    "cast_int_to_double", "cast_long_to_int", "cast_double_to_long",
    "cast_double_to_int", "cast_long_to_double", "cast_int_to_bool",
    "cast_double_to_bool", "cast_bool_to_int", "cast_bool_to_double",
    "year"]


@pytest.mark.parametrize("case", _CASE_NAMES)
def test_expression_matches_jax(batches, case):
    cases = _cases(_Both(batches[0]))
    assert sorted(cases) == sorted(_CASE_NAMES)
    pair = cases[case]
    valid = _check(pair, batches)
    if case == "divide_by_literal_zero":
        assert not valid.any()  # x / 0 is null
        return
    assert valid.any()
    if case in ("case_no_else", "divide"):
        assert not valid.all()  # a missing else, x / 0 and nulls: null


def test_year_covers_days_before_1970(batches):
    jb, _ = batches
    days = np.asarray(jb.columns[jb.schema.field_index("dt")].data)
    assert days.min() < -700_000 and days.max() > 700_000


def test_cast_to_string_is_not_ported():
    with pytest.raises(NotImplementedError, match="Cast"):
        E.Cast(E.BoundReference(0, T.IntegerT), T.StringT)


# ---------------------------------------------------------------------------
# through the DataFrame API: CASE coercion, min/max, count(DISTINCT)
# ---------------------------------------------------------------------------

def _agg_table(seed=29, n=3000):
    rng = np.random.default_rng(seed)
    null = rng.random((4, n)) < 0.12
    vals = np.where(rng.random(n) < 0.3,
                    rng.choice([0.0, -0.0, np.nan, np.inf, -np.inf], n),
                    rng.normal(0, 100, n))
    return pa.table({
        "g": pa.array(rng.integers(0, 40, n), mask=null[0]),
        "x": pa.array(vals, mask=null[1]),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=null[2]),
        "v": pa.array(rng.integers(0, 25, n), mask=null[3]),
        "s": pa.array([f"k{j % 9}" for j in range(n)]),
    })


def _same(u, v):
    if u == v:
        return True
    if isinstance(u, float) and isinstance(v, float):
        if math.isnan(u) or math.isnan(v):
            return math.isnan(u) and math.isnan(v)
        return abs(u - v) <= 1e-9 * max(1.0, abs(u), abs(v))
    return u == v


def _rows_same(got, want):
    key = lambda r: repr(tuple("nan" if isinstance(x, float)  # noqa: E731
                               and math.isnan(x) else x for x in r))
    a = sorted((tuple(r.values()) for r in got.to_pylist()), key=key)
    b = sorted((tuple(r.values()) for r in want.to_pylist()), key=key)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert all(_same(u, v) for u, v in zip(x, y)), (x, y)


_API_CASES = {
    "min_max_grouped": lambda df, F, col: df.groupBy("g").agg(
        F.min("x"), F.max("x"), F.min("i"), F.max("i"),
        F.min(col("v") > 12).alias("min_b"),
        F.max(col("v") > 12).alias("max_b")),
    "min_max_global": lambda df, F, col: df.agg(
        F.min("x"), F.max("x"), F.min("i"), F.max("i")),
    "min_max_global_all_null": lambda df, F, col: df.filter(
        col("i") > 5000).agg(F.min("x"), F.max("i")),
    "count_distinct_grouped": lambda df, F, col: df.groupBy("s").agg(
        F.countDistinct("v").alias("n")),
    "count_distinct_nullable_key": lambda df, F, col: df.groupBy("g").agg(
        F.countDistinct(col("x")).alias("n")),
    "count_distinct_global": lambda df, F, col: df.agg(
        F.countDistinct("v").alias("n")),
    "case_int_sum": lambda df, F, col: df.groupBy("s").agg(
        F.sum(F.when(col("v").isin(1, 2, 3), 1).otherwise(0)).alias("h"),
        F.sum(1 - F.when(col("v") > 10, 1).otherwise(0)).alias("lo")),
    "case_widened": lambda df, F, col: df.select(
        F.when(col("i") > 0, col("i")).otherwise(0.5).alias("w"),
        F.when(col("x").between(-1.0, 1.0), col("s")).alias("n"),
        (col("i") / col("v")).alias("q"), (2 / col("x")).alias("r")),
}


@pytest.mark.parametrize("case", list(_API_CASES))
def test_api_matches_jax(case):
    build = _API_CASES[case]
    t = _agg_table()
    want = build(JaxSession().createDataFrame(t), JF, jcol).toArrow()
    got = build(TpuSession(device="cpu").createDataFrame(t), F,
                col).toArrow()
    assert got.schema == want.schema
    assert got.num_rows > 0
    _rows_same(got, want)


# ---------------------------------------------------------------------------
# the five tables gen_tpch gained
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf", [0.002, 0.01])
def test_gen_tpch_new_tables_equal_bench(sf):
    got, want = tpch.gen_tpch(sf), bench.gen_tpch(sf)
    assert list(got) == list(want)
    for name in ("nation", "region", "supplier", "part", "partsupp"):
        a, b = got[name], want[name]
        assert a.column_names == b.column_names, name
        for c in b.column_names:
            assert a.column(c).equals(b.column(c)), (name, c)
        assert a.nbytes == b.nbytes, name
