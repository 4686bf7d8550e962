"""The port's CPU oracle against the JAX package's.

* Each expression class's ``eval_cpu`` equals the JAX package's
  ``eval_cpu`` on the same seeded host batch (nulls, NaN, +-0.0, int64
  overflow, non-ASCII strings), data and validity, bit for bit.
* The port's CPU session (``spark.rapids.sql.enabled=false``) equals
  the JAX package's CPU session on all 22 TPC-H builders exactly, row
  order included, at ``bench.py``'s oracle scales.
* ``tpch.oracle_check(device="cpu")`` (bench's CPU-oracle loop) is true
  for all 22.
* ``tpch.TPCH_SF1_CONF`` is ``bench.TPCH_SF1_CONF`` less
  ``tpch.UNPORTED_SF1_KEYS``, which is empty: each of the four keys of
  the engine planes (adaptive, fusion, the result cache) is accepted
  and its plane acts on a small TPC-H query whose result equals the JAX
  package's CPU session.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar import host as JH
from spark_rapids_tpu.ops import datetime_ops as JD
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.ops import strings as JS
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.ops import datetime_ops as D
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import strings as S
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


PORT = (E, S, D, T)
JAX = (JE, JS, JD, JT)


def _table(n=257, seed=11):
    rng = np.random.default_rng(seed)

    def nulls(p=0.15):
        return rng.random(n) < p

    d = rng.normal(0, 100, n)
    d[rng.random(n) < 0.08] = np.nan
    d[rng.random(n) < 0.06] = 0.0
    d[rng.random(n) < 0.06] = -0.0
    d2 = np.where(rng.random(n) < 0.3, 0.0, rng.normal(0, 3, n))
    d2[rng.random(n) < 0.05] = np.nan
    big = rng.integers(-(1 << 62), 1 << 62, n) * 2
    words = ["", "a", "abc", "special requests", "PROMO BRASS", "été",
             "a%c", "xspecialyrequestsz", "STANDARD BRASS", "ac"]
    s = np.array(words, dtype=object)[rng.integers(0, len(words), n)]
    s2 = np.array(words, dtype=object)[rng.integers(0, len(words), n)]
    days = rng.integers(-40000, 40000, n)
    micros = rng.integers(-(1 << 50), 1 << 50, n)
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=nulls()),
        "l": pa.array(big, mask=nulls(0.05)),
        "d": pa.array(d, mask=nulls(0.1)),
        "d2": pa.array(d2, mask=nulls(0.1)),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "b2": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "s": pa.array(list(s), mask=nulls(0.1)),
        "s2": pa.array(list(s2), mask=nulls(0.1)),
        "dt": pa.array(days.astype(np.int32), type=pa.int32(),
                       mask=nulls()).cast(pa.date32()),
        "ts": pa.array(micros, type=pa.int64(),
                       mask=nulls()).cast(pa.timestamp("us", tz="UTC")),
        "f": pa.array(rng.normal(0, 1e3, n).astype(np.float32),
                      mask=nulls()),
    })


COLS = {"i": 0, "l": 1, "d": 2, "d2": 3, "b": 4, "b2": 5, "s": 6,
        "s2": 7, "dt": 8, "ts": 9, "f": 10}


def _cases():
    """name -> builder(E, S, D, T) of the same expression in a package."""

    def ref(name, t):
        return lambda E_, T_: E_.BoundReference(
            COLS[name], getattr(T_, t))

    i, l, d, d2 = ref("i", "IntegerT"), ref("l", "LongT"), \
        ref("d", "DoubleT"), ref("d2", "DoubleT")
    b, b2 = ref("b", "BooleanT"), ref("b2", "BooleanT")
    s, s2 = ref("s", "StringT"), ref("s2", "StringT")
    dt, ts, f = ref("dt", "DateT"), ref("ts", "TimestampT"), \
        ref("f", "FloatT")

    def lit(v, t):
        return lambda E_, T_: E_.Literal(v, getattr(T_, t))

    cases = {
        "ref_double": lambda E_, S_, D_, T_: d(E_, T_),
        "lit_int": lambda E_, S_, D_, T_: lit(7, "IntegerT")(E_, T_),
        "lit_double": lambda E_, S_, D_, T_: lit(-0.0, "DoubleT")(E_, T_),
        "lit_string": lambda E_, S_, D_, T_: lit("été", "StringT")(E_, T_),
        "lit_null": lambda E_, S_, D_, T_: lit(None, "LongT")(E_, T_),
        "lit_null_string": lambda E_, S_, D_, T_: lit(None, "StringT")(
            E_, T_),
        "alias": lambda E_, S_, D_, T_: E_.Alias(
            E_.Add(d(E_, T_), d2(E_, T_)), "x"),
        "add_int": lambda E_, S_, D_, T_: E_.Add(i(E_, T_), i(E_, T_)),
        "add_long_wraps": lambda E_, S_, D_, T_: E_.Add(l(E_, T_),
                                                        l(E_, T_)),
        "sub_double": lambda E_, S_, D_, T_: E_.Subtract(d(E_, T_),
                                                         d2(E_, T_)),
        "mul_long_wraps": lambda E_, S_, D_, T_: E_.Multiply(l(E_, T_),
                                                             l(E_, T_)),
        "mul_double": lambda E_, S_, D_, T_: E_.Multiply(d(E_, T_),
                                                         d2(E_, T_)),
        "div_double": lambda E_, S_, D_, T_: E_.Divide(d(E_, T_),
                                                       d2(E_, T_)),
        "not": lambda E_, S_, D_, T_: E_.Not(b(E_, T_)),
        "and": lambda E_, S_, D_, T_: E_.And(b(E_, T_), b2(E_, T_)),
        "or": lambda E_, S_, D_, T_: E_.Or(b(E_, T_), b2(E_, T_)),
        "if": lambda E_, S_, D_, T_: E_.If(b(E_, T_), d(E_, T_),
                                           d2(E_, T_)),
        "case_else": lambda E_, S_, D_, T_: E_.CaseWhen(
            [(b(E_, T_), i(E_, T_)),
             (b2(E_, T_), lit(5, "IntegerT")(E_, T_))],
            lit(-1, "IntegerT")(E_, T_)),
        "case_no_else": lambda E_, S_, D_, T_: E_.CaseWhen(
            [(b(E_, T_), d(E_, T_))]),
        "year_date": lambda E_, S_, D_, T_: D_.Year(dt(E_, T_)),
        "year_timestamp": lambda E_, S_, D_, T_: D_.Year(ts(E_, T_)),
    }
    for op in ("EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
               "GreaterThanOrEqual"):
        cases[f"{op}_double"] = (
            lambda E_, S_, D_, T_, op=op: getattr(E_, op)(d(E_, T_),
                                                          d2(E_, T_)))
        cases[f"{op}_float_nan_literal"] = (
            lambda E_, S_, D_, T_, op=op: getattr(E_, op)(
                d(E_, T_), lit(float("nan"), "DoubleT")(E_, T_)))
        cases[f"{op}_int"] = (
            lambda E_, S_, D_, T_, op=op: getattr(E_, op)(
                i(E_, T_), lit(3, "IntegerT")(E_, T_)))
    for src, dst in (("d", "IntegerT"), ("d", "LongT"), ("f", "IntegerT"),
                     ("i", "DoubleT"), ("l", "IntegerT"), ("b", "IntegerT"),
                     ("i", "BooleanT"), ("d", "BooleanT"),
                     ("i", "LongT")):
        src_t = {"d": "DoubleT", "f": "FloatT", "i": "IntegerT",
                 "l": "LongT", "b": "BooleanT"}[src]
        cases[f"cast_{src}_{dst}"] = (
            lambda E_, S_, D_, T_, src=src, src_t=src_t, dst=dst:
            E_.Cast(ref(src, src_t)(E_, T_), getattr(T_, dst)))
    for op in ("eq", "lt", "le", "gt", "ge"):
        cases[f"string_{op}"] = (
            lambda E_, S_, D_, T_, op=op: S_.StringComparison(
                op, s(E_, T_), s2(E_, T_)))
        cases[f"string_{op}_literal"] = (
            lambda E_, S_, D_, T_, op=op: S_.StringComparison(
                op, s(E_, T_), lit("abc", "StringT")(E_, T_)))
    for pos, n in ((1, 2), (-3, 2), (0, 5), (2, 0), (4, 100)):
        cases[f"substring_{pos}_{n}"] = (
            lambda E_, S_, D_, T_, pos=pos, n=n: S_.Substring(
                s(E_, T_), pos, n))
    for op in ("startswith", "endswith", "contains"):
        for pat in ("a", "", "BRASS", "é"):
            cases[f"{op}_{pat!r}"] = (
                lambda E_, S_, D_, T_, op=op, pat=pat: S_.StringPredicate(
                    op, s(E_, T_), lit(pat, "StringT")(E_, T_)))
    for pat in ("%special%requests%", "PROMO%", "%BRASS", "a_c%", "%", "",
                "a\\%c", "_", "%é"):
        cases[f"like_{pat!r}"] = (
            lambda E_, S_, D_, T_, pat=pat: S_.Like(s(E_, T_), pat))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def batches():
    t = _table()
    return H.from_arrow_table(t), JH.from_arrow_table(t)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:
        return a.tolist() == b.tolist()
    return a.tobytes() == b.tobytes()  # bits: NaN and -0.0 included


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cpu_equals_jax(batches, case):
    port_batch, jax_batch = batches
    got = CASES[case](*PORT).eval_cpu(port_batch)
    want = CASES[case](*JAX).eval_cpu(jax_batch)
    assert type(got.dtype).__name__ == type(want.dtype).__name__
    assert _same(got.data, want.data), (got.data, want.data)
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        assert _same(got.validity, want.validity)


def test_host_batch_round_trips_like_jax():
    t = _table()
    got = H.to_arrow_table(H.from_arrow_table(t))
    want = JH.to_arrow_table(JH.from_arrow_table(t))
    # repr: NaN equals NaN, and -0.0 differs from 0.0
    assert got.schema == want.schema == t.schema
    assert repr(got.to_pylist()) == repr(want.to_pylist())
    assert repr(got.to_pylist()) == repr(t.to_pylist())


@pytest.fixture(scope="module")
def tables_for():
    cache = {}

    def get(sf):
        if sf not in cache:
            cache[sf] = bench.gen_tpch(sf)
        return cache[sf]

    return get


def _jax_builder(q):
    if q == "q6":
        return lambda s, t: bench.q6(s, t["lineitem"])
    return bench.TPCH_BUILDERS[q]


@pytest.mark.parametrize("q", tpch.QUERIES)
def test_cpu_session_equals_jax_cpu_session(tables_for, q):
    t = tables_for(tpch.ORACLE_SF.get(q, tpch.ORACLE_DEFAULT_SF))
    off = {"spark.rapids.sql.enabled": False}
    got = tpch.build(q, TpuSession(dict(off), device="cpu"), t).toArrow()
    want = _jax_builder(q)(JaxSession(dict(off)), t).toArrow()
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


def test_oracle_check_on_the_cpu(tables_for):
    out = tpch.oracle_check(tables_for, device="cpu")
    assert list(out) == list(tpch.QUERIES)
    assert all(out.values()), out


def test_sf1_conf_is_bench_less_the_unported_keys():
    want = {k: v for k, v in bench.TPCH_SF1_CONF.items()
            if k not in tpch.UNPORTED_SF1_KEYS}
    assert tpch.TPCH_SF1_CONF == want
    assert set(tpch.UNPORTED_SF1_KEYS) <= set(bench.TPCH_SF1_CONF)
    assert set(tpch.UNPORTED_SF1_KEYS.values()) <= {"A.4", "A.9"}


# the four keys the port refused before its engine planes, each with the
# query its plane acts on and the conf that makes it act
ENGINE_PLANE_KEYS = {
    "spark.rapids.tpu.adaptive.enabled":
        ("q13", {"spark.sql.autoBroadcastJoinThreshold": 0}),
    "spark.rapids.tpu.fusion.enabled": ("q3", {}),
    "spark.rapids.tpu.cache.enabled": ("q1", {}),
    "spark.rapids.tpu.cache.minRuntimeMs":
        ("q1", {"spark.rapids.tpu.cache.enabled": True}),
}


@pytest.mark.parametrize("key", sorted(ENGINE_PLANE_KEYS))
def test_engine_plane_sf1_key_is_accepted(tables_for, key):
    """Each engine plane's key of ``bench.TPCH_SF1_CONF`` is accepted,
    ``TPCH_SF1_CONF`` carries it, and its plane acts on a small TPC-H
    query (a decision recorded, a region built, a probe counted) whose
    result equals the JAX package's CPU session."""
    from spark_rapids_tpu_torch import cache as cache_mod
    from spark_rapids_tpu_torch import fusion as FU
    from spark_rapids_tpu_torch.runtime import telemetry as TM
    assert tpch.TPCH_SF1_CONF[key] == bench.TPCH_SF1_CONF[key]
    q, extra = ENGINE_PLANE_KEYS[key]
    conf = dict(extra, **{key: bench.TPCH_SF1_CONF[key]})
    session = TpuSession(conf, device="cpu")
    assert session.rapids_conf().get_raw(key) == conf[key]
    t = tables_for(tpch.ORACLE_DEFAULT_SF)
    decision = 'tpuq_adaptive_decisions_total{kind="shuffled"}'
    before = (FU.REGIONS_BUILT.value, cache_mod.MISSES.value,
              TM.REGISTRY.snapshot().get(decision, 0))
    cache_mod.reset()
    try:
        got = tpch.build(q, session, t).toArrow()
        entry = session.query_history()[-1]
    finally:
        cache_mod.reset()
    want = _jax_builder(q)(JaxSession({"spark.rapids.sql.enabled": False}),
                           t).toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    if key == "spark.rapids.tpu.adaptive.enabled":
        assert TM.REGISTRY.snapshot().get(decision, 0) > before[2]
        assert "TpuAdaptiveLocalJoin" in entry["plan"]
    elif key == "spark.rapids.tpu.fusion.enabled":
        assert FU.REGIONS_BUILT.value > before[0]
        assert "FusedStage" in entry["plan"]
    else:
        assert cache_mod.MISSES.value == before[1] + 1
        status = entry["cache"]["status"]
        if key == "spark.rapids.tpu.cache.minRuntimeMs":
            assert status == "uncached"
            assert entry["cache"]["reason"] == "below_min_runtime"
        else:
            assert status == "stored"


def test_sql_enabled_false_runs_datetime_and_strings_on_the_cpu():
    """A CPU session evaluates the date and string expressions of the
    port on the host (year of a pre-1970 date, a LIKE with a non-ASCII
    byte) as the JAX package's CPU session does."""
    t = pa.table({"d": pa.array([datetime.date(1969, 12, 31),
                                 datetime.date(2000, 2, 29), None]),
                  "s": pa.array(["été", "ete", None])})
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.column import col as jcol
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col

    def build(s, F_, col_):
        return s.createDataFrame(t).select(
            F_.year(col_("d")).alias("y"),
            col_("s").like("_t_").alias("m"))

    off = {"spark.rapids.sql.enabled": False}
    got = build(TpuSession(dict(off), device="cpu"), F, col).toArrow()
    want = build(JaxSession(dict(off)), JF, jcol).toArrow()
    assert got.equals(want)
    assert got.column("y").to_pylist() == [1969, 2000, None]
