"""Decimal columns in the port — decimal(<=18) as a scaled int64 and
decimal128 as int64 ``[B, 2]`` (hi, lo) — against the JAX package.

* ``ops/decimal128.py``: every function equals its JAX twin bit for bit
  on seeded edge values (+-(2^127 - 1), -2^127, carries across 2^64,
  negative products, products and rescales that overflow into null).
* The 128-bit grouped sum (``segment_groupby``'s limb sums) equals the
  ends of the JAX package's ``segmented_scan_dec128`` on random
  segments, the wrap mod 2^128 included; a keyless ``sum`` and ``avg``
  over ``decimal(12,2)`` and ``decimal(38,4)`` equal the JAX package's
  CPU session (its device run of a keyless decimal sum fails, ROADMAP
  C).
* Every case of ``tests/test_decimal128.py`` but its two window ones,
  ``tests/test_columnar.py::test_decimal_roundtrip_values`` and the
  decimal cases of ``tests/test_agg_breadth.py`` run through the
  DataFrame API on the port (``device="cpu"``) and the JAX package
  under the same conf: rows, tree strings and fallback reports equal,
  on the accelerated session and on the plain CPU one.
* TPC-H q1, q6, q18 and the eleven other builders that read a decimal
  column (q3, q5, q7, q8, q9, q10, q14, q15, q17, q19, q20) over
  ``tpch.decimal_tables`` at the oracle scale (sf 0.002) equal the JAX
  package's CPU session, with the JAX session's plan made without
  running it (its device runs compile for 20-26 s each, and fail on
  q6); so do the join variants ``q17_cond`` and ``q3_full``.

Tolerances: integers, decimals, validity, strings and plan strings are
exact.  A double average is within ``AVG_REL`` = 1e-12 relative of the
JAX run, whose float sums add in another order, and so is a decimal
cast to double (the JAX session's compiled division by 10^scale
multiplies by its reciprocal: 1 ulp off the port's, whose host and
direct-call values equal the JAX package's bit for bit); the standard
deviation over decimal128 within the JAX test's own ``approx_float``
tolerance, ``VAR_REL`` = 1e-6 (Σx² less (Σx)²/n cancels).  Each JAX
run is made once per module (``jax_run``).
"""

import decimal
import math
import random

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.exec import aggregate as JAG
from spark_rapids_tpu.ops import decimal128 as JD
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.shuffle import serializer as JSER
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import segment_groupby
from spark_rapids_tpu_torch.ops import decimal128 as D
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.shuffle import serializer as SER
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch

decimal.getcontext().prec = 60  # as tests/test_decimal128.py sets it

AVG_REL = 1e-12
VAR_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ensure_initialized()  # x64 for the JAX twins
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


# ---------------------------------------------------------------------------
# ops/decimal128.py against its JAX twin
# ---------------------------------------------------------------------------

_EDGES = [0, 1, -1, (1 << 127) - 1, -(1 << 127), (1 << 64) - 1, 1 << 64,
          -(1 << 64), (1 << 63), -(1 << 63), (1 << 63) - 1, 10 ** 38 - 1,
          -(10 ** 38 - 1), 10 ** 37, (1 << 96) + 12345, -(1 << 100) - 7,
          999_999_999, -1_000_000_001, 1 << 32, (1 << 32) - 1]


def _values(n=600, seed=5):
    """Edge values, random 128-bit values, and near-edge ones."""
    rng = random.Random(seed)
    out = list(_EDGES)
    while len(out) < n:
        kind = rng.random()
        if kind < 0.3:
            out.append(rng.randint(-(1 << 127), (1 << 127) - 1))
        elif kind < 0.6:
            out.append(rng.randint(-(10 ** 19), 10 ** 19))
        elif kind < 0.8:
            out.append(rng.choice(_EDGES) + rng.randint(-3, 3))
        else:
            out.append(rng.randint(-(1 << 70), 1 << 70))
    return [D.py_wrap128(v) for v in out]


def _pair():
    a = D.np_pack(_values(seed=5))
    b = D.np_pack(_values(seed=6)[::-1])
    return a, b


def _same(got, want):
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape
    if g.dtype == np.float64:
        assert np.array_equal(g.view(np.int64), w.view(np.int64))
    else:
        assert np.array_equal(g, w.astype(g.dtype))


BINARY = ["add", "sub", "mul", "cmp_lt", "cmp_eq", "add_checked",
          "sub_checked", "mul_checked"]


@pytest.mark.parametrize("fn", BINARY)
def test_binary_function_equals_jax(fn):
    a, b = _pair()
    _same(getattr(D, fn)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(JD, fn)(a, b))


UNARY = {
    "neg": (), "abs128": (), "is_negative": (),
    "mul_small": (10 ** 9,), "scale_up": (17,),
    "scale_up_checked": (6, 38), "div_small_round": (7,),
    "scale_down_round": (9,), "fits_precision": (30,),
    "to_double": (4,),
}


@pytest.mark.parametrize("fn", sorted(UNARY))
def test_unary_function_equals_jax(fn):
    a, _ = _pair()
    _same(getattr(D, fn)(torch.from_numpy(a), *UNARY[fn]),
          getattr(JD, fn)(a, *UNARY[fn]))


def test_divmod_from_i64_pack_and_host_helpers_equal_jax():
    a, _ = _pair()
    mag = np.array(JD.abs128(a)[0])
    _same(D.divmod_small(torch.from_numpy(mag), 1_000_003),
          JD.divmod_small(mag, 1_000_003))
    x = np.array([0, -1, 1, -(1 << 63), (1 << 63) - 1, 42], np.int64)
    _same(D.from_i64(torch.from_numpy(x)), JD.from_i64(x))
    _same(D.pack(torch.from_numpy(x), torch.from_numpy(x[::-1].copy())),
          JD.pack(x, x[::-1]))
    vals = _values(seed=9)
    assert np.array_equal(D.np_pack(vals), JD.np_pack(vals))
    assert list(D.np_unpack(D.np_pack(vals))) == vals
    for v in vals[:40] + [(1 << 130) + 5, -(1 << 129)]:
        assert D.py_wrap128(v) == JD.py_wrap128(v)
        assert D.py_fits(v, 38) == JD.py_fits(v, 38)
        for k in (-9, -1, 0, 3):
            assert D.py_rescale_half_up(v, k) == JD.py_rescale_half_up(v, k)
    for s in ("123.455", "-0.005", "1E+5", "99999999999999999999.999"):
        dec = decimal.Decimal(s)
        assert D.py_unscaled(dec, 2) == JD.py_unscaled(dec, 2)


def test_products_that_overflow_into_null():
    """mul_checked flags products past 2^127 (also those that wrap back
    into range) and fits_precision those past 10^38, as the JAX twins."""
    big = [1 << 64, -(1 << 64), 10 ** 19, -(10 ** 20), (1 << 126), 3, -3]
    a = D.np_pack(big)
    b = D.np_pack(big[::-1])
    got, ok = D.mul_checked(torch.from_numpy(a), torch.from_numpy(b))
    want, jok = JD.mul_checked(a, b)
    _same((got, ok), (want, jok))
    exact = [x * y for x, y in zip(big, big[::-1])]
    assert list(ok.numpy()) == [abs(v) < (1 << 127) for v in exact]
    fits = D.fits_precision(got, 38).numpy() & ok.numpy()
    assert list(fits) == [abs(v) < 10 ** 38 for v in exact]


def test_grouped_sum_equals_segmented_scan():
    """The limb sums of ``segment_groupby`` against the ends of the JAX
    package's carry-aware scan, on random segments whose sums wrap."""
    rng = np.random.default_rng(17)
    n = 3000
    vals = _values(n, seed=21)
    data = D.np_pack(vals)
    seg = np.sort(rng.integers(0, 97, n))
    boundary = np.concatenate([[True], seg[1:] != seg[:-1]])
    import jax
    # jitted: the eager scan dispatches op by op (~18 s on the CPU)
    scan = np.asarray(jax.jit(JAG.segmented_scan_dec128)(data, boundary))
    ends = np.concatenate([seg[1:] != seg[:-1], [True]])
    want = scan[ends]
    key = DeviceColumn(T.LongT, torch.from_numpy(seg))
    val = DeviceColumn(T.DecimalType(38, 0), torch.from_numpy(data))
    sel = torch.ones(n, dtype=torch.bool)
    ok, ov, osel, _ = segment_groupby([key], sel, [(val, "sum")])
    g = int(osel.sum())
    assert g == len(want)
    assert np.array_equal(ok[0].data[:g].numpy(), np.unique(seg))
    assert np.array_equal(ov[0].data[:g].numpy(), want)
    py = {}
    for s, v in zip(seg, vals):
        py[s] = py.get(s, 0) + v
    assert list(D.np_unpack(want)) == [D.py_wrap128(py[s])
                                       for s in np.unique(seg)]


# ---------------------------------------------------------------------------
# through the DataFrame API
# ---------------------------------------------------------------------------

def _dec_col(rng, n, digits=30, scale=4, null_p=0.06):
    """``tests/test_decimal128.py::_dec_col``."""
    return [None if rng.random() < null_p else
            decimal.Decimal(rng.randint(-10 ** digits, 10 ** digits))
            .scaleb(-scale) for _ in range(n)]


def _table(n=2000, seed=11):
    """``tests/test_decimal128.py::_table``."""
    rng = random.Random(seed)
    return pa.table({
        "k": pa.array([rng.randint(0, 40) for _ in range(n)]),
        "d": pa.array(_dec_col(rng, n), type=pa.decimal128(38, 4)),
        "e": pa.array(_dec_col(rng, n, digits=20, scale=2),
                      type=pa.decimal128(24, 2)),
    })


def _mul_overflow_table():
    rng = random.Random(14)
    return pa.table({"d": pa.array(
        _dec_col(rng, 500, digits=34, scale=0, null_p=0),
        type=pa.decimal128(38, 0))})


def _group_key_table():
    rng = random.Random(16)
    keys = [decimal.Decimal(rng.randint(-10 ** 25, 10 ** 25)).scaleb(-3)
            for _ in range(25)]
    n = 3000
    return pa.table({
        "g": pa.array([keys[rng.randint(0, 24)] for _ in range(n)],
                      type=pa.decimal128(30, 3)),
        "v": pa.array([rng.randint(0, 1000) for _ in range(n)]),
    })


def _join_tables():
    rng = random.Random(18)
    t = _table(seed=18)
    probe = [v for v in t.column("d").to_pylist() if v is not None]
    keys = sorted(set(rng.sample(probe, 150)))
    return t, pa.table({"d": pa.array(keys, type=pa.decimal128(38, 4)),
                        "w": pa.array(list(range(len(keys))))})


def _d128_table(n=500, seed=9):
    """``tests/test_agg_breadth.py::_d128_table``."""
    rng = np.random.default_rng(seed)
    vals = [None if i % 11 == 0 else
            decimal.Decimal(int(rng.integers(-10**9, 10**9)) * 10**11
                            + int(rng.integers(0, 10**11))) / 100
            for i in range(n)]
    return pa.table({"k": pa.array(rng.integers(0, 8, n)),
                     "d": pa.array(vals, pa.decimal128(25, 2))})


def _small_decimal_table(n=4000, seed=3):
    """A decimal(12,2) and a decimal(38,4) column with nulls, for the
    keyless sum and average."""
    rng = random.Random(seed)
    return pa.table({
        "p": pa.array(_dec_col(rng, n, digits=10, scale=2),
                      type=pa.decimal128(12, 2)),
        "d": pa.array(_dec_col(rng, n, digits=33, scale=4),
                      type=pa.decimal128(38, 4))})


T13, T_JOIN = _table(seed=13), _join_tables()
WRAP = pa.table({"d": pa.array([decimal.Decimal(1 << 64), decimal.Decimal(3)],
                               type=pa.decimal128(20, 0))})
BIG = pa.table({"d": pa.array(
    [decimal.Decimal("1234567890123456789012345678901234.5678")],
    type=pa.decimal128(38, 4))})
STR = pa.table({"s": pa.array(["3.7", "abc", "-12.345", None,
                               "99999999999999999999999999.99"])})
SCALE_UP = pa.table({"d": pa.array(
    [decimal.Decimal(340282366920938463463374607431769),
     decimal.Decimal(10) ** 31, decimal.Decimal(-(10 ** 33)),
     decimal.Decimal(7), decimal.Decimal(0), None],
    type=pa.decimal128(38, 0))})
INTS = pa.table({"i": pa.array([10 ** 17, -10 ** 17, 5, 0, None])})
ROUNDTRIP = pa.table({"d": pa.array(
    [decimal.Decimal("123.45"), None, decimal.Decimal("-99999999.99"),
     decimal.Decimal("0.01")], pa.decimal128(10, 2))})
PCT = pa.table({
    "k": pa.array([0, 0, 0, 1]),
    "d": pa.array([decimal.Decimal("1.50"), decimal.Decimal("2.50"),
                   decimal.Decimal("3.50"), decimal.Decimal("9.99")],
                  type=pa.decimal128(10, 2))})
KEYLESS = _small_decimal_table()
LIT = decimal.Decimal("123456789012345678901234.5678")
# ROADMAP C.6: unary minus, abs and <=> over a decimal(38,2) column whose
# third value is 2^64 / 100 (a carry across the low word)
C6 = pa.table({
    "d": pa.array([decimal.Decimal("1.00"), decimal.Decimal("-3.50"),
                   decimal.Decimal(1 << 64).scaleb(-2), None],
                  type=pa.decimal128(38, 2)),
    "e": pa.array([decimal.Decimal("1.00"), None,
                   decimal.Decimal(1 << 64).scaleb(-2), None],
                  type=pa.decimal128(38, 2))})
ALLOW_PROJECT = {"spark.rapids.sql.test.allowedNonGpu":
                 "Project,InMemoryScan"}
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}

# name: (build(session, F, col), conf, float tolerances by column)
CASES = {
    "roundtrip_and_projection": (
        lambda s, F, c: s.createDataFrame(_table()).select("k", "d", "e"),
        TEST, {}),
    "comparisons": (
        lambda s, F, c: s.createDataFrame(_table(seed=12)).select(
            (c("d") < c("e")).alias("lt"), (c("d") >= c("e")).alias("ge"),
            (c("d") == c("e")).alias("eq"), c("d").isNull().alias("nn"))
        .filter(c("lt").isNotNull()), TEST, {}),
    "filter_against_literal": (
        lambda s, F, c: s.createDataFrame(_table(seed=12))
        .filter(c("d") > LIT), TEST, {}),
    "add_sub_mul_bit_exact": (
        lambda s, F, c: s.createDataFrame(T13).select(
            (c("d") + c("d")).alias("dd"), (c("d") - c("e")).alias("sub"),
            (c("e") * c("e")).alias("prod")), TEST, {}),
    "mul_overflow_nulls": (
        lambda s, F, c: s.createDataFrame(_mul_overflow_table()).select(
            (c("d") * c("d")).alias("p")), TEST, {}),
    "sort_desc": (
        lambda s, F, c: s.createDataFrame(_table(seed=15)).orderBy(
            c("d").desc(), "k"), TEST, {}),
    "sort_asc": (
        lambda s, F, c: s.createDataFrame(_table(seed=15)).orderBy(
            "d", "k"), TEST, {}),
    "groupby_decimal128_key": (
        lambda s, F, c: s.createDataFrame(_group_key_table()).groupBy("g")
        .agg(F.sum("v").alias("sv"), F.count("*").alias("c")), TEST, {}),
    "sum_avg_decimal128": (
        lambda s, F, c: s.createDataFrame(_table(seed=17)).groupBy("k")
        .agg(F.sum("d").alias("sd"), F.avg("d").alias("ad"),
             F.count("d").alias("c")), TEST, {"ad": AVG_REL}),
    "join_inner": (
        lambda s, F, c: s.createDataFrame(T_JOIN[0]).join(
            s.createDataFrame(T_JOIN[1]), on="d", how="inner"), TEST, {}),
    "join_left_semi": (
        lambda s, F, c: s.createDataFrame(T_JOIN[0]).join(
            s.createDataFrame(T_JOIN[1]), on="d", how="left_semi"),
        TEST, {}),
    "cast_rescale_and_double": (
        lambda s, F, c: s.createDataFrame(_table(seed=19)).select(
            c("e").cast("decimal(38,6)").alias("up"),
            c("d").cast("decimal(38,2)").alias("down"),
            c("d").cast("double").alias("dd")), TEST, {"dd": AVG_REL}),
    "int_to_decimal128_cast": (
        lambda s, F, c: s.createDataFrame(pa.table({"i": pa.array(
            [random.Random(20).randint(-10 ** 17, 10 ** 17)
             for _ in range(400)])})).select(
            c("i").cast("decimal(38,6)").alias("d")), TEST, {}),
    "decimal128_minmax_falls_back": (
        lambda s, F, c: s.createDataFrame(_table(seed=21)).groupBy("k")
        .agg(F.min("d").alias("m")),
        dict(TEST, **{"spark.rapids.sql.test.allowedNonGpu":
                      "HashAggregate,InMemoryScan"}), {}),
    "null_decimal128_literal_in_casewhen": (
        lambda s, F, c: s.createDataFrame(_table(seed=23, n=300)).select(
            F.when(c("k") > 20, c("d")).otherwise(None).alias("x")),
        TEST, {}),
    "mul_wrapback_is_null_not_garbage": (
        lambda s, F, c: s.createDataFrame(WRAP).select(
            (c("d") * c("d")).alias("p")), TEST, {}),
    "large_precision_values_unrounded": (
        lambda s, F, c: s.createDataFrame(BIG).select("d"), TEST, {}),
    "string_to_decimal_cpu": (
        lambda s, F, c: s.createDataFrame(STR).select(
            c("s").cast("decimal(30,2)").alias("d")),
        dict(TEST, **ALLOW_PROJECT), {}),
    "decimal_to_string_cpu": (
        lambda s, F, c: s.createDataFrame(_table(seed=31, n=50)).select(
            c("d").cast("string").alias("s")),
        dict(TEST, **ALLOW_PROJECT), {}),
    "cast_scale_up_overflow_is_null": (
        lambda s, F, c: s.createDataFrame(SCALE_UP).select(
            c("d").cast("decimal(38,6)").alias("up")), TEST, {}),
    "int_to_decimal_overflow_is_null": (
        lambda s, F, c: s.createDataFrame(INTS).select(
            c("i").cast("decimal(18,6)").alias("d")), TEST, {}),
    "decimal_roundtrip_values": (
        lambda s, F, c: s.createDataFrame(ROUNDTRIP), TEST, {}),
    "percentile_decimal_input": (
        lambda s, F, c: s.createDataFrame(PCT).groupBy("k")
        .agg(F.percentile("d", 0.5).alias("p")), TEST, {}),
    "min_max_first_decimal128_grouped": (
        lambda s, F, c: s.createDataFrame(_d128_table()).groupBy("k").agg(
            F.min(F.col("d")).alias("mn"), F.max(F.col("d")).alias("mx"),
            F.first(F.col("d")).alias("f")), TEST, {}),
    "variance_decimal128_grouped": (
        lambda s, F, c: s.createDataFrame(_d128_table()).groupBy("k").agg(
            F.stddev_samp(F.col("d")).alias("sd")), TEST, {"sd": VAR_REL}),
    "unary_minus_decimal_38_2": (
        lambda s, F, c: s.createDataFrame(C6).select(
            (-c("d")).alias("n")), TEST, {}),
    "abs_decimal_38_2": (
        lambda s, F, c: s.createDataFrame(C6).select(
            F.abs(c("d")).alias("a")), TEST, {}),
    "eq_null_safe_decimal_38_2": (
        lambda s, F, c: s.createDataFrame(C6).select(
            c("d").eqNullSafe(c("e")).alias("q")), TEST, {}),
}

# the keyless sum and average: the JAX package's device run of a keyless
# decimal sum fails (ROADMAP C), so these hold the port's device run to
# the JAX package's CPU session, and its plan to the JAX session's plan
# made without running it
KEYLESS_CASES = {
    "keyless_sum_avg_decimal_12_2": (
        lambda s, F, c: s.createDataFrame(KEYLESS).agg(
            F.sum("p").alias("s"), F.avg("p").alias("a"),
            F.count("p").alias("n")), TEST, {"a": AVG_REL}),
    "keyless_sum_avg_decimal_38_4": (
        lambda s, F, c: s.createDataFrame(KEYLESS).agg(
            F.sum("d").alias("s"), F.avg("d").alias("a"),
            F.count("*").alias("n")), TEST, {"a": AVG_REL}),
}
ALL = dict(CASES, **KEYLESS_CASES)
# the JAX package's device branch is wrong or fails on the C.6 cases
# (ROADMAP C.5): they are held to its CPU session, as the keyless sums
# are
CPU_HELD = set(KEYLESS_CASES) | {"unary_minus_decimal_38_2",
                                 "abs_decimal_38_2",
                                 "eq_null_safe_decimal_38_2"}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf, _ = ALL[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol).toArrow(), None, None)
            elif name in CPU_HELD:
                df = build(JaxSession(dict(conf)), JF, jcol)
                plan = df._execute_plan()  # planned, not run
                memo[(name, host)] = (
                    run(name, True)[0],
                    df._last_override.fallback_report(),
                    plan.tree_string())
            else:
                df = build(JaxSession(dict(conf)), JF, jcol)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


def _close(a, b, rel) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
    return a == b


def same_rows(got, want, tol, ordered=False):
    """Equal rows (as multisets unless ``ordered``): the columns of
    ``tol`` within their relative tolerance, every other value exactly
    (by ``repr``: NaN, -0.0 and a decimal's digits included)."""
    assert got.schema == want.schema
    names = want.column_names
    exact = [n for n in names if n not in tol]

    def key(r):
        return repr([r[n] for n in exact])

    g, w = got.to_pylist(), want.to_pylist()
    if not ordered:
        g, w = sorted(g, key=key), sorted(w, key=key)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for n in names:
            if n in tol:
                assert _close(rg[n], rw[n], tol[n]), (n, rg, rw)
            else:
                assert repr(rg[n]) == repr(rw[n]), (n, rg, rw)


ORDERED = {"sort_desc", "sort_asc", "roundtrip_and_projection",
           "unary_minus_decimal_38_2", "abs_decimal_38_2",
           "eq_null_safe_decimal_38_2",
           "add_sub_mul_bit_exact", "mul_overflow_nulls",
           "cast_rescale_and_double", "decimal_roundtrip_values",
           "large_precision_values_unrounded"}


@pytest.mark.parametrize("name", list(ALL))
def test_device_equals_jax(jax_run, name):
    build, conf, tol = ALL[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want, tol, ordered=name in ORDERED)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(ALL))
def test_host_equals_jax(jax_run, name):
    build, conf, _ = ALL[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=True)[0], {},
              ordered=name in ORDERED)


def test_decimal128_sign_functions_values(jax_run):
    """ROADMAP C.6: -d, abs(d) and d <=> e over decimal(38,2) give the
    right values (the JAX package's CPU session's) on the port's device
    branch."""
    big = decimal.Decimal(1 << 64).scaleb(-2)
    one, m35 = decimal.Decimal("1.00"), decimal.Decimal("-3.50")
    want = {"unary_minus_decimal_38_2": [-one, -m35, -big, None],
            "abs_decimal_38_2": [one, -m35, big, None],
            "eq_null_safe_decimal_38_2": [True, False, True, True]}
    for name, values in want.items():
        build, conf, _ = ALL[name]
        got = build(TpuSession(dict(conf), device="cpu"), F, col).toArrow()
        assert got.column(0).to_pylist() == values, name
        assert jax_run(name)[0].column(0).to_pylist() == values, name


def test_outcomes_the_jax_tests_pin():
    """The values ``tests/test_decimal128.py`` asserts on its own."""
    s = TpuSession(dict(TEST), device="cpu")
    p = s.createDataFrame(WRAP).select(
        (col("d") * col("d")).alias("p")).toArrow().column("p").to_pylist()
    assert p == [None, decimal.Decimal(9)]  # 2^128 wraps to 0: null
    assert (s.createDataFrame(BIG).toArrow().column("d").to_pylist()
            == BIG.column("d").to_pylist())
    up = s.createDataFrame(SCALE_UP).select(
        col("d").cast("decimal(38,6)").alias("up")).toArrow()
    py = up.column("up").to_pylist()
    assert py[0] is None and py[2] is None
    assert py[1] == decimal.Decimal(10) ** 31 and py[3] == 7
    assert py[4] == 0 and py[5] is None
    d = s.createDataFrame(INTS).select(
        col("i").cast("decimal(18,6)").alias("d")).toArrow()
    py = d.column("d").to_pylist()
    assert py[0] is None and py[1] is None and py[2] == 5
    assert (s.createDataFrame(ROUNDTRIP).toArrow().column(0).to_pylist()
            == ROUNDTRIP.column(0).to_pylist())
    keyless = s.createDataFrame(KEYLESS).agg(F.sum("p").alias("s"))
    want = sum(v for v in KEYLESS.column("p").to_pylist() if v is not None)
    assert keyless.toArrow().column("s").to_pylist() == [want]


def test_decimal_refusals_equal_jax():
    """approx_percentile over a decimal and decimal division are refused
    with the JAX package's messages."""
    from spark_rapids_tpu.plan.analysis import (
        AnalysisException as JaxAnalysisException)
    s, js = TpuSession(device="cpu"), JaxSession({})
    with pytest.raises(AnalysisException, match="approx_percentile") as pe:
        s.createDataFrame(PCT).groupBy("k").agg(
            F.percentile_approx("d", 0.5))
    with pytest.raises(JaxAnalysisException) as je:
        js.createDataFrame(PCT).groupBy("k").agg(
            JF.percentile_approx("d", 0.5))
    assert str(pe.value) == str(je.value)
    with pytest.raises(AnalysisException, match="decimal 'mod'"):
        s.createDataFrame(PCT).select(col("d") % col("d"))
    with pytest.raises(AnalysisException, match="invalid decimal"):
        s.createDataFrame(PCT).select(col("d").cast("decimal(40,2)"))


def test_decimal128_serializer_roundtrip():
    """decimal128 rides the host shuffle's wire format as 16 bytes a row,
    byte for byte as the JAX package writes it."""
    rng = random.Random(30)
    n = 1000
    vals = [rng.randint(-10 ** 37, 10 ** 37) for _ in range(n)]
    pair = D.np_pack(vals)
    ids = np.arange(n, dtype=np.int64)
    pids = np.array([i % 4 for i in range(n)], np.int32)
    cols = [SER.HostColView(T.DecimalType(38, 4), pair, None, None),
            SER.HostColView(T.LongT, ids, None, None)]
    jcols = [JSER.HostColView(JT.DecimalType(38, 4), pair, None, None),
             JSER.HostColView(JT.LongT, ids, None, None)]
    bufs = SER.serialize_partitions(cols, pids, None, 4, 2)
    jbufs = JSER.serialize_partitions(jcols, pids, None, 4, 2)
    assert [bytes(b) for b in bufs] == [bytes(b) for b in jbufs]
    schema = T.StructType((T.StructField("d", T.DecimalType(38, 4)),
                           T.StructField("i", T.LongT)))
    got = {}
    for p in range(4):
        nr, cs = SER.deserialize(bufs[p], schema)
        dec = D.np_unpack(np.asarray(cs[0].data))
        for j in range(nr):
            got[int(cs[1].data[j])] = int(dec[j])
    assert [got[i] for i in range(n)] == vals


def test_decimal_keys_through_the_host_shuffle():
    """A decimal128 group key crosses a host-file exchange (partition ids
    by murmur3 of its two lanes) and a repartitioned aggregate: the same
    rows as one partition."""
    conf = dict(TEST, **{"spark.default.parallelism": 4,
                         "spark.rapids.shuffle.mode": "MULTITHREADED"})
    t = _group_key_table()

    def q(s):
        return (s.createDataFrame(t).repartition(4, "g").groupBy("g")
                .agg(F.sum("v").alias("sv"), F.count("*").alias("c")))

    got = q(TpuSession(conf, device="cpu")).toArrow()
    want = q(TpuSession(dict(TEST), device="cpu")).toArrow()
    same_rows(got, want, {})


# ---------------------------------------------------------------------------
# TPC-H over decimal(12,2) columns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decimal_tpch():
    return tpch.decimal_tables(tpch.gen_tpch(tpch.ORACLE_DEFAULT_SF))


# q1, q6 and q18, then the eleven other builders that read a decimal
# column
DECIMAL_QUERIES = ["q1", "q6", "q18", "q3", "q5", "q7", "q8", "q9", "q10",
                   "q14", "q15", "q17", "q19", "q20"]
DECIMAL_ROWS = {"q1": 6, "q6": 1, "q18": 10}


@pytest.mark.parametrize("q", DECIMAL_QUERIES)
def test_tpch_over_decimals_equals_jax(decimal_tpch, q):
    t = decimal_tpch
    assert t["lineitem"].schema.field("l_tax").type == pa.decimal128(12, 2)
    jt = t["lineitem"] if q == "q6" else t
    want = getattr(bench, q)(JaxSession(dict(HOST)), jt).toArrow()
    jdf = getattr(bench, q)(JaxSession(dict(TEST)), jt)
    jplan = jdf._execute_plan()  # planned, not run
    df = tpch.build(q, TpuSession(dict(TEST), device="cpu"), t)
    got = df.toArrow()
    tol = {c: AVG_REL for c in ("avg_qty", "avg_price", "avg_disc")
           if c in want.column_names}
    same_rows(got, want, tol, ordered=True)
    assert df._last_override.fallback_report() == \
        jdf._last_override.fallback_report() == []
    assert df._last_plan.tree_string() == jplan.tree_string()
    host = tpch.build(q, TpuSession(dict(HOST), device="cpu"), t).toArrow()
    same_rows(host, want, {}, ordered=True)
    assert want.num_rows == DECIMAL_ROWS.get(q, got.num_rows)


@pytest.mark.parametrize("variant", ["q17_cond", "q3_full"])
def test_join_variants_over_decimals_equal_jax(decimal_tpch, variant):
    """``q17_cond`` (a residual condition over a decimal quantity and a
    double average) and ``q3_full`` (a full join summing a decimal
    price) over the decimal tables, held as
    ``tests/test_torch_tpch_join_variants.py`` holds them over doubles:
    the JAX package's rows (its CPU session: its device run of a keyless
    decimal sum fails, ROADMAP C.4), fallback report and plan (made
    without running), and ``q17_cond`` equal to q17."""
    from tests.test_torch_tpch_join_variants import (  # noqa: E402
        jax_q3_full, jax_q17_cond)
    jbuild = {"q17_cond": jax_q17_cond, "q3_full": jax_q3_full}[variant]
    t = decimal_tpch
    want = jbuild(JaxSession(dict(HOST)), t).toArrow()
    jdf = jbuild(JaxSession(dict(TEST)), t)
    jplan = jdf._execute_plan()  # planned, not run
    df = tpch.build(variant, TpuSession(dict(TEST), device="cpu"), t)
    got = df.toArrow()
    same_rows(got, want, {}, ordered=True)
    assert df._last_override.fallback_report() == \
        jdf._last_override.fallback_report() == []
    assert df._last_plan.tree_string() == jplan.tree_string()
    if variant == "q17_cond":
        base = tpch.build("q17", TpuSession(dict(TEST), device="cpu"), t)
        assert got.equals(base.toArrow())
    else:
        assert got.num_rows == 1 and got.column("n")[0].as_py() > 0
        assert got.schema.field("total_price").type == pa.decimal128(22, 2)
