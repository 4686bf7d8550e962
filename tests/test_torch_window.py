"""Window functions in the port against the JAX package: the API, the
analyzer, the CPU oracle, the plan rule and the device exec.

Every case of ``tests/test_window.py`` (``CASES``, with its parameters:
ranking, running, whole-partition, ROWS and RANGE frames, lag and lead
with and without IGNORE NULLS, the fallbacks) and the two window cases
of ``tests/test_decimal128.py`` run through the port's session
(``device="cpu"``, under ``spark.rapids.sql.test.enabled`` or the JAX
test's own conf) and through the JAX package's: results (schema
included), tree strings and fallback reports are equal, exactly except
doubles within 1e-6 where the JAX test passes ``approx_float``; the
CPU sessions of both packages give equal results too.  This file runs
the ranking, running, whole-partition and offset cases;
``tests/test_torch_window_frames.py`` the bounded and RANGE frames.
The cases the JAX test marks slow (``ORACLE_ONLY``: each compiles for
~20 s there) hold the port's device run against the JAX package's CPU
session and its plan, made without running it.

Also here: the refusals (a frame RANGE offsets cannot take, a window
function outside ``.over``), and the device pieces of
``exec/window.py`` and ``exec/aggregate.py::segmented_scan`` against
their JAX twins on seeded inputs — bit for bit on integers and min and
max, within 1e-12 relative on float sums (the doubling scan adds in
another order than ``associative_scan``).  Each JAX run is made once
per module (``jax_run``).
"""

import decimal
import math
import random

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan.analysis import AnalysisException as JaxAE
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession
from spark_rapids_tpu.sql.window import Window as JWindow
from spark_rapids_tpu.utils import datagen as dg

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.sql.window import Window

REL = 1e-6
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
PORT = (F, col, Window)
JAX = (JF, jcol, JWindow)


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


def gen_table(seed=0, n=300):
    """``tests/test_window.py::gen_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": dg.IntegerGen(min_val=0, max_val=6).generate(rng, n),
        "o": dg.IntegerGen(min_val=-20, max_val=20).generate(rng, n),
        "v": dg.LongGen().generate(rng, n),
        "d": dg.DoubleGen().generate(rng, n),
        "s": dg.StringGen().generate(rng, n),
    })


TIES = pa.table({
    "k": pa.array([1, 1, None, None, 2, 2, 2, 1, None, 2], type=pa.int32()),
    "o": pa.array([5, 5, 3, None, 1, 1, None, 5, 3, 2], type=pa.int32()),
    "v": pa.array(list(range(10)), type=pa.int64())})
NAN_ORDER = pa.table({
    "k": pa.array([0, 0, 0, 1, 1, 1, 0, 1]),
    "d": pa.array([1.0, float("nan"), -0.0, 0.0, float("nan"), None,
                   float("-inf"), 2.5]),
    "v": pa.array(list(range(8)), type=pa.int64())})
NAN_PART = pa.table({
    "k": pa.array([float("nan"), float("nan"), -0.0, 0.0, 1.0, None,
                   None, 1.0]),
    "o": pa.array([1, 2, 3, 4, 5, 6, 7, 8], type=pa.int32()),
    "v": pa.array(list(range(8)), type=pa.int64())})
MINMAX_NAN = pa.table({
    "k": pa.array([0, 0, 0, 1, 1, 2, 2, 2]),
    "o": pa.array([1, 2, 3, 1, 2, 1, 2, 3], type=pa.int32()),
    "d": pa.array([float("nan"), 1.0, -2.0, float("nan"), float("nan"),
                   None, 3.5, -0.0])})
NULL_VALUES = pa.table({
    "k": pa.array([0, 0, 0, 0, 1, 1], type=pa.int32()),
    "o": pa.array([1, 2, 3, 4, 1, 2], type=pa.int32()),
    "v": pa.array([1.0, None, 3.0, None, 5.0, 6.0])})
NAN_INF = pa.table({
    "k": pa.array([0] * 6, type=pa.int32()),
    "o": pa.array(list(range(6)), type=pa.int32()),
    "v": pa.array([float("nan"), 1.0, 2.0, float("inf"), 5.0, 6.0])})
DESC = pa.table({"k": pa.array([0, 0, 0, 0]),
                 "o": pa.array([1, 2, 3, 10], type=pa.int32()),
                 "v": pa.array([1, 2, 3, 10], type=pa.int64())})


def _dec_col(rng, n, digits=30, scale=4, null_p=0.06):
    """``tests/test_decimal128.py::_dec_col``."""
    return [None if rng.random() < null_p else
            decimal.Decimal(rng.randint(-10 ** digits, 10 ** digits))
            .scaleb(-scale) for _ in range(n)]


def _dec_table(n=2000, seed=22):
    """``tests/test_decimal128.py::_table``."""
    decimal.getcontext().prec = 60
    rng = random.Random(seed)
    return pa.table({
        "k": pa.array([rng.randint(0, 40) for _ in range(n)]),
        "d": pa.array(_dec_col(rng, n), type=pa.decimal128(38, 4)),
        "e": pa.array(_dec_col(rng, n, digits=20, scale=2),
                      type=pa.decimal128(24, 2))})


SMALL_DEC = pa.table({
    "k": pa.array([0] * 11), "o": pa.array(list(range(11)), type=pa.int32()),
    "d": pa.array([decimal.Decimal(9 * 10 ** 17)] * 11,
                  type=pa.decimal128(18, 0))})
T0, T1, T2, T3, T4, T5 = (gen_table(0), gen_table(1), gen_table(2),
                          gen_table(3), gen_table(4), gen_table(5, n=80))
T6, T7, T8, T9, T10 = (gen_table(6), gen_table(7, n=100), gen_table(8),
                       gen_table(9), gen_table(10))
T11S, T11, T12S, T12, T13, T14 = (gen_table(11, n=200), gen_table(11),
                                  gen_table(12, n=60), gen_table(12),
                                  gen_table(13), gen_table(14))
T21, T22, T23, T24, T25, T26 = (gen_table(21, n=400), gen_table(22, n=300),
                                gen_table(23, n=400), gen_table(24, n=300),
                                gen_table(25, n=400), gen_table(26, n=300))
DEC = _dec_table()


def _allow(*names):
    return dict(TEST, **{"spark.rapids.sql.test.allowedNonGpu":
                         ",".join(names)})


def _c(t, *cols_, fns=()):
    """``createDataFrame(t).select(*cols_, *fns(F, col, W))``."""
    def build(s, ns):
        return s.createDataFrame(t).select(*cols_, *fns(*ns))
    return build


# name: (build(session, (F, col, Window)), conf, approx_float, ordered);
# ``ordered`` False where the JAX test passes ``ignore_order``
CASES = {
    "row_number_rank_dense_rank": (_c(T0, "k", "o", fns=lambda F, c, W: [
        F.row_number().over(W.partitionBy("k").orderBy("o")).alias("rn"),
        F.rank().over(W.partitionBy("k").orderBy("o")).alias("rk"),
        F.dense_rank().over(W.partitionBy("k").orderBy("o")).alias("dr")]),
        TEST, False, True),
    "rank_with_ties_and_null_keys": (_c(TIES, "k", "o", "v", fns=lambda F, c,
                                        W: [
        F.rank().over(W.partitionBy("k").orderBy("o")).alias("rk"),
        F.dense_rank().over(W.partitionBy("k").orderBy("o")).alias("dr"),
        F.row_number().over(W.partitionBy("k").orderBy("o")).alias("rn")]),
        TEST, False, True),
    "window_nan_order_keys": (_c(NAN_ORDER, "k", "d", fns=lambda F, c, W: [
        F.rank().over(W.partitionBy("k").orderBy("d")).alias("rk"),
        F.sum("v").over(W.partitionBy("k").orderBy("d")).alias("rs")]),
        TEST, False, True),
    "window_nan_partition_keys": (_c(NAN_PART, "k", "o", fns=lambda F, c, W: [
        F.row_number().over(W.partitionBy("k").orderBy("o")).alias("rn"),
        F.count("v").over(W.partitionBy("k").orderBy("o")).alias("c")]),
        TEST, False, True),
    "running_aggregates_range_frame": (_c(T1, "k", "o", "v", fns=lambda F, c,
                                          W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o")).alias("rsum"),
        F.count("v").over(W.partitionBy("k").orderBy("o")).alias("rcnt"),
        F.min("v").over(W.partitionBy("k").orderBy("o")).alias("rmin"),
        F.max("v").over(W.partitionBy("k").orderBy("o")).alias("rmax")]),
        TEST, False, True),
    "running_aggregates_rows_frame": (_c(T2, "k", "o", "v", fns=lambda F, c,
                                         W: [
        F.sum("v").over(_rows_running(W)).alias("rsum"),
        F.avg("v").over(_rows_running(W)).alias("ravg"),
        F.first("v").over(_rows_running(W)).alias("rfirst")]),
        TEST, True, True),
    "whole_partition_frame_unordered": (_c(T3, "k", "v", fns=lambda F, c,
                                           W: [
        F.sum("v").over(W.partitionBy("k")).alias("total"),
        F.max("v").over(W.partitionBy("k")).alias("mx")]), TEST, False,
        False),
    "whole_partition_frame_explicit": (_c(T3, "k", "o", "v", fns=lambda F, c,
                                          W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o").rowsBetween(
            W.unboundedPreceding, W.unboundedFollowing)).alias("total")]),
        TEST, False, True),
    "float_min_max_nan_values": (_c(MINMAX_NAN, "k", "o", "d", fns=lambda F,
                                    c, W: [
        F.min("d").over(W.partitionBy("k").orderBy("o")).alias("mn"),
        F.max("d").over(W.partitionBy("k").orderBy("o")).alias("mx")]),
        TEST, False, True),
    "lag_lead": (_c(T4, "k", "o", "v", fns=lambda F, c, W: [
        F.lag("v").over(_kov(W)).alias("lag1"),
        F.lag("v", 3).over(_kov(W)).alias("lag3"),
        F.lead("v").over(_kov(W)).alias("lead1"),
        F.lead("v", 2).over(_kov(W)).alias("lead2"),
        F.lag("v", -1).over(_kov(W)).alias("neg_lag")]), TEST, False, True),
    "lag_lead_strings": (_c(T5, "k", "s", fns=lambda F, c, W: [
        F.lag("s").over(_kov(W)).alias("prev_s"),
        F.lead("s", 2).over(_kov(W)).alias("next_s")]), TEST, False, True),
    "multiple_window_specs_one_select": (_c(T6, "k", "o", "v", fns=lambda F,
                                            c, W: [
        F.row_number().over(W.partitionBy("k").orderBy("o")).alias("rn1"),
        F.sum("v").over(W.partitionBy("k").orderBy("o")).alias("s1"),
        F.row_number().over(W.partitionBy("o").orderBy(c("v").desc()))
        .alias("rn2")]), TEST, False, False),
    "global_window_no_partition": (_c(T7, "o", "v", fns=lambda F, c, W: [
        F.row_number().over(W.orderBy("o", "v")).alias("rn"),
        F.sum("v").over(W.orderBy("o", "v")).alias("rs")]), TEST, False,
        True),
    "window_desc_nulls_order": (_c(T8, "k", "o", "v", fns=lambda F, c, W: [
        F.row_number().over(W.partitionBy("k").orderBy(
            c("o").desc_nulls_last(), "v")).alias("rn"),
        F.lag("v").over(W.partitionBy("k").orderBy(
            c("o").desc_nulls_last(), "v")).alias("lg")]), TEST, False, True),
    "window_over_multi_partition_input": (_c(T9, "k", "o", "v", fns=lambda F,
                                             c, W: [
        F.row_number().over(_kov(W)).alias("rn")]),
        dict(TEST, **{"spark.default.parallelism": 4}), False, True),
    "window_avg_double": (_c(T10, "k", "d", fns=lambda F, c, W: [
        F.avg("d").over(_kov(W)).alias("ra")]), TEST, True, True),
    "window_rows_current_to_unbounded_following": (_c(T11S, "k", "o",
                                                      fns=lambda F, c, W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o").rowsBetween(
            0, W.unboundedFollowing)).alias("x")]), TEST, True, True),
    # assert_tpu_fallback_collect: test mode off, Window on the CPU
    "window_string_minmax_falls_back": (_c(T12S, "k", "s", fns=lambda F, c,
                                           W: [
        F.first("s").over(_kov(W)).alias("fs")]),
        {"spark.rapids.sql.test.enabled": False}, False, True),
    "bounded_rows_frame_trailing": (_c(T11, "k", "o", "v", fns=lambda F, c,
                                       W: [
        F.sum("v").over(_kov(W).rowsBetween(-2, W.currentRow)).alias("rsum"),
        F.count("v").over(_kov(W).rowsBetween(-2, W.currentRow))
        .alias("rcnt"),
        F.avg("v").over(_kov(W).rowsBetween(-2, W.currentRow))
        .alias("ravg")]), TEST, True, True),
    "bounded_rows_frame_centered_and_following": (_c(T12, "k", "o",
                                                     fns=lambda F, c, W: [
        F.sum("v").over(_kov(W).rowsBetween(-1, 1)).alias("c3"),
        F.count("v").over(_kov(W).rowsBetween(1, 3)).alias("f3")]),
        TEST, True, True),
    "bounded_rows_frame_empty_at_edges": (_c(T13, "k", "o", fns=lambda F, c,
                                             W: [
        F.sum("v").over(_kov(W).rowsBetween(-3, -2)).alias("behind")]),
        TEST, True, True),
    "bounded_rows_frame_nulls_in_values": (_c(NULL_VALUES, "k", "o",
                                              fns=lambda F, c, W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o").rowsBetween(-1, 0))
        .alias("s"),
        F.count("v").over(W.partitionBy("k").orderBy("o").rowsBetween(-1, 0))
        .alias("c")]), TEST, False, True),
    "bounded_rows_frame_minmax_falls_back": (_c(T14, "k", fns=lambda F, c,
                                                W: [
        F.min("v").over(_kov(W).rowsBetween(-2, 0)).alias("m")]),
        _allow("Window", "InMemoryScan", "Project"), False, True),
    "bounded_rows_frame_nan_inf_isolated": (_c(NAN_INF, "o", fns=lambda F, c,
                                               W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o").rowsBetween(-1, 0))
        .alias("s"),
        F.avg("v").over(W.partitionBy("k").orderBy("o").rowsBetween(-1, 0))
        .alias("a")]), TEST, False, True),
    "ntile_percent_rank_cume_dist": (_c(T25, "k", "o", fns=lambda F, c, W: [
        F.ntile(4).over(_kov(W)).alias("nt"),
        F.percent_rank().over(_kov(W)).alias("pr"),
        F.cume_dist().over(_kov(W)).alias("cd")]), TEST, True, True),
    "range_unbounded_ends": (_c(T24, "k", "o", fns=lambda F, c, W: [
        F.sum("v").over(W.partitionBy("k").orderBy("o").rangeBetween(
            W.unboundedPreceding, 2)).alias("a"),
        F.count("v").over(W.partitionBy("k").orderBy("o").rangeBetween(
            -1, W.unboundedFollowing)).alias("b")]), TEST, True, False),
    "range_frame_desc_order": (_c(DESC, "o", fns=lambda F, c, W: [
        F.sum("v").over(W.partitionBy("k").orderBy(c("o").desc())
                        .rangeBetween(-2, 0)).alias("s")]),
        _allow("Window"), False, True),
    # tests/test_decimal128.py's two window cases
    "decimal128_window_falls_back": (_c(DEC, "k", fns=lambda F, c, W: [
        F.sum("d").over(W.partitionBy("k").orderBy("e")).alias("rs")]),
        _allow("Window", "InMemoryScan"), False, True),
    "small_decimal_window_sum_falls_back": (_c(SMALL_DEC, "o", fns=lambda F,
                                               c, W: [
        F.sum("d").over(W.partitionBy("k").orderBy("o").rowsBetween(
            W.unboundedPreceding, W.unboundedFollowing)).alias("sd")]),
        _allow("Window", "InMemoryScan"), False, True),
}


def _rows_running(W):
    return (W.partitionBy("k").orderBy("o", "v")
            .rowsBetween(W.unboundedPreceding, W.currentRow))


def _kov(W):
    return W.partitionBy("k").orderBy("o", "v")


def _param_case(name, t, fn, frame, approx, ordered, slow=False):
    def fns(F, c, W):
        w = W.partitionBy("k").orderBy(*frame[0])
        w = (w.rowsBetween(*frame[2]) if frame[1] == "rows"
             else w.rangeBetween(*frame[2]))
        return [getattr(F, fn)(frame[3]).over(w).alias("x")]
    CASES[name] = (_c(t, "k", "o", "v", fns=fns), TEST, approx, ordered)
    if slow:
        ORACLE_ONLY.add(name)


# the JAX test's slow parameters: against its CPU session and its plan
ORACLE_ONLY = set()
for _fn in ("min", "max", "first"):
    _param_case(f"bounded_rows_min_max_first[{_fn}]", T21, _fn,
                (("o", "v"), "rows", (-3, 1), "v"), True, True,
                slow=_fn == "max")
for _fn in ("min", "max"):
    _param_case(f"bounded_rows_minmax_double_nan[{_fn}]", T22, _fn,
                (("o", "v"), "rows", (-2, 2), "d"), True, True, slow=True)
for _fn in ("sum", "count", "avg", "min", "max", "first"):
    _param_case(f"range_bounded_frames[{_fn}]", T23, _fn,
                (("o",), "range", (-4, 3), "v"), True, False,
                slow=_fn in ("count", "avg", "max"))
for _kind, _off in (("lag", 1), ("lag", 2), ("lead", 1), ("lead", 3)):
    CASES[f"lead_lag_ignore_nulls[{_kind}-{_off}]"] = (_c(
        T26, "k", "o", fns=lambda F, c, W, k=_kind, o=_off: [
            getattr(F, k)("s", o, ignorenulls=True).over(_kov(W))
            .alias("x")]), TEST, True, True)

# the bounded and RANGE frames run in tests/test_torch_window_frames.py
FRAME_CASES = [n for n in CASES if n.startswith(
    ("bounded_", "range_", "window_rows_current", "decimal128",
     "small_decimal"))]
BASIC_CASES = [n for n in CASES if n not in FRAME_CASES]


def make_jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string): its device run, or for ``ORACLE_ONLY`` its CPU
    session's result and its plan made without running; with ``host``
    its CPU session's result alone."""
    memo = {}

    def run(name, host=False):
        if (name, host) in memo:
            return memo[(name, host)]
        build, conf, _, _ = CASES[name]
        if host or name in ORACLE_ONLY:
            want = build(JaxSession(dict(conf, **HOST)), JAX).toArrow()
            if host:
                memo[(name, host)] = (want, None, None)
                return memo[(name, host)]
            df = build(JaxSession(dict(conf)), JAX)
            plan = df._execute_plan()  # planned, not run
        else:
            df = build(JaxSession(dict(conf)), JAX)
            want = df.toArrow()
            plan = df._last_plan
        memo[(name, host)] = (want, df._last_override.fallback_report(),
                              plan.tree_string())
        return memo[(name, host)]

    return run


@pytest.fixture(scope="module")
def jax_run():
    return make_jax_run()


def _close(a, b, approx: bool) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if approx and not (math.isinf(a) or math.isinf(b)):
            return math.isclose(a, b, rel_tol=REL, abs_tol=REL)
        return a == b
    return a == b


def same_rows(got: pa.Table, want: pa.Table, approx: bool,
              ordered: bool = True) -> None:
    """Equal schemas, then equal rows column by column: doubles within
    ``REL`` when ``approx`` (NaN equals NaN), the rest exactly; rows in
    order unless ``ordered`` is False."""
    assert got.schema == want.schema
    g, w = got.to_pylist(), want.to_pylist()
    assert len(g) == len(w)
    if not ordered:
        def key(r):
            return repr([v for v in r.values() if not isinstance(v, float)])
        g, w = sorted(g, key=key), sorted(w, key=key)
    for i, (rg, rw) in enumerate(zip(g, w)):
        for k in rg:
            assert _close(rg[k], rw[k], approx), (i, k, rg, rw)


def check_device(name, jax_run):
    build, conf, approx, ordered = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), PORT)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    # the port's device rows come in the JAX device run's order; an
    # ORACLE_ONLY case the JAX test compares unordered is held to its
    # CPU session's rows as a multiset, as the JAX test does
    same_rows(got, want, approx, ordered or name not in ORACLE_ONLY)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    return got


def check_host(name, jax_run):
    build, conf, _, _ = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), PORT).toArrow()
    same_rows(got, jax_run(name, host=True)[0], False)


@pytest.mark.parametrize("name", BASIC_CASES)
def test_device_equals_jax(jax_run, name):
    check_device(name, jax_run)


@pytest.mark.parametrize("name", BASIC_CASES)
def test_host_equals_jax(jax_run, name):
    check_host(name, jax_run)


def test_what_the_jax_tests_pin(jax_run):
    """The string ``first`` falls back with the JAX reason and keeps the
    Window on the CPU; the desc RANGE frame's oracle flips the value
    window (frame of v = values in [v, v + 2])."""
    report = jax_run("window_string_minmax_falls_back")[1]
    assert any("window first over string input" in r for r in report)
    tree = jax_run("window_string_minmax_falls_back")[2]
    assert any(ln.strip().startswith("Window")
               for ln in tree.splitlines())
    got = CASES["range_frame_desc_order"][0](
        TpuSession(dict(HOST), device="cpu"), PORT).toArrow()
    assert {r["o"]: r["s"] for r in got.to_pylist()} == {
        10: 10, 3: 3, 2: 5, 1: 6}


@pytest.mark.parametrize("spec, what", [
    (lambda W: W.partitionBy("k").orderBy("o", "v").rangeBetween(-2, 2),
     "exactly one ORDER BY"),
    (lambda W: W.partitionBy("k").orderBy("d").rangeBetween(-2, 2),
     "integral or date"),
    (lambda W: W.partitionBy("k").orderBy("o").rowsBetween(2, 1),
     "unsupported window frame"),
])
def test_window_unsupported_frame_raises(spec, what):
    """RANGE offsets need one integral or date ORDER BY key; a frame
    whose start follows its end is refused; both packages alike."""
    t = gen_table(11, n=20)
    for s, (F_, _, W), exc in (
            (TpuSession(dict(HOST), device="cpu"), PORT, AnalysisException),
            (JaxSession(dict(HOST)), JAX, JaxAE)):
        with pytest.raises(exc, match=what):
            s.createDataFrame(t).select(F_.sum("v").over(spec(W)).alias("x"))


@pytest.mark.parametrize("build, what", [
    (lambda F, W: F.row_number().over(W.partitionBy("k")),
     "row_number\\(\\) requires an ORDER BY"),
    (lambda F, W: F.ntile(0).over(W.orderBy("o")), "positive bucket"),
    (lambda F, W: F.var_samp("v").over(W.orderBy("o")),
     "unsupported window aggregate 'var_samp'"),
    (lambda F, W: F.sum("s").over(W.orderBy("o")), "numeric input"),
    (lambda F, W: (F.col("v") + 1).over(W.orderBy("o")),
     "only window functions and aggregates"),
    (lambda F, W: F.row_number().over(W.orderBy("o")) + 1,
     "unknown expression op 'window'"),
])
def test_window_analysis_errors_match_jax(build, what):
    t = gen_table(3, n=10)
    for s, (F_, _, W), exc in (
            (TpuSession(dict(HOST), device="cpu"), PORT, AnalysisException),
            (JaxSession(dict(HOST)), JAX, JaxAE)):
        with pytest.raises(exc, match=what):
            s.createDataFrame(t).select(build(F_, W).alias("x"))


def test_lag_default_raises_as_in_jax():
    for F_ in (F, JF):
        with pytest.raises(NotImplementedError, match="lag default"):
            F_.lag("v", 1, 0)
        with pytest.raises(NotImplementedError, match="lead default"):
            F_.lead("v", 1, 0)


def test_with_column_reaches_windows():
    """``withColumn`` goes through ``select``: the window column joins
    the frame's columns, in the JAX package's order and plan."""
    outs = []
    for s, (F_, c, W) in ((TpuSession(dict(TEST), device="cpu"), PORT),
                          (JaxSession(dict(TEST)), JAX)):
        df = (s.createDataFrame(T0)
              .withColumn("rk", F_.rank().over(W.partitionBy("k")
                                                .orderBy(c("o").desc())))
              .withColumn("o", c("o") * 2))
        outs.append((df.toArrow(), df._last_plan.tree_string()))
    same_rows(outs[0][0], outs[1][0], False)
    assert outs[0][1] == outs[1][1]


def test_window_reserves_its_working_set():
    """The exec reserves 2 x its input's bytes and, for a bounded min or
    max, the sparse table's (ceil(log2 n) + 1) x n values."""
    from spark_rapids_tpu_torch.exec import window as W_
    seen = []
    real = M.DeviceMemoryManager.transient

    def spy(self, nbytes):
        seen.append(nbytes)
        return real(self, nbytes)

    M.DeviceMemoryManager.transient = spy
    try:
        s = TpuSession(dict(TEST), device="cpu")
        s.createDataFrame(T14).select(
            "k", F.max("v").over(_kov(Window).rowsBetween(-2, 0))
            .alias("m")).toArrow()
        s.createDataFrame(T14).select(
            "k", F.sum("v").over(_kov(Window)).alias("m")).toArrow()
    finally:
        M.DeviceMemoryManager.transient = real
    # 1024 rows: k int32 + validity, o int32 + validity, v int64 +
    # validity, d float64 + validity, s [1024, W] bytes + lengths +
    # validity, and sel
    assert len(seen) == 2 and seen[0] - seen[1] == W_.sparse_table_bytes(
        1024, 8) == 11 * 1024 * 8


# ---------------------------------------------------------------------------
# The device pieces against their JAX twins
# ---------------------------------------------------------------------------

def _segments(rng, n, p=0.1):
    b = rng.random(n) < p
    b[0] = True
    return b


def _jax():
    import jax
    import jax.numpy as jnp
    from spark_rapids_tpu.exec import aggregate as JA
    from spark_rapids_tpu.exec import window as JW
    return jax, jnp, JA, JW


@pytest.mark.parametrize("op, dtype", [
    ("add", np.int64), ("add", np.int32), ("add", np.float64),
    ("min", np.int64), ("max", np.int32), ("min", np.float64),
    ("max", np.float64), ("first", np.int64), ("first", np.float64),
    ("max_index", np.int64)])
def test_segmented_scan_equals_jax(op, dtype):
    from spark_rapids_tpu_torch.exec.aggregate import segmented_scan
    jax, jnp, JA, _ = _jax()
    rng = np.random.default_rng(5)
    n = 1000
    b = _segments(rng, n)
    if op == "max_index":
        v = np.where(rng.random(n) < 0.3, np.arange(n), -1).astype(dtype)
    elif np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = rng.integers(info.min // 2, info.max // 2, n, dtype=dtype)
    else:
        v = rng.normal(0, 1e6, n).astype(dtype)
    jop = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum,
           "first": lambda a, _b: a, "max_index": jnp.maximum}[op]
    # jitted: an eager first call compiles every primitive for seconds
    want = np.asarray(jax.jit(lambda x, y: JA.segmented_scan(jop, x, y))(
        jnp.asarray(v), jnp.asarray(b)))
    got = segmented_scan(op, torch.from_numpy(v), torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(v).dtype
    if op == "add" and dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_broadcast_last_and_range_pieces_equal_jax():
    from spark_rapids_tpu_torch.exec import window as W_
    jax, jnp, JA, JW = _jax()
    rng = np.random.default_rng(7)
    n = 777
    b = _segments(rng, n, 0.05)
    tb = torch.from_numpy(b)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    np.testing.assert_array_equal(
        W_.broadcast_last(torch.from_numpy(v), tb).numpy(),
        np.asarray(jax.jit(JW.broadcast_last)(jnp.asarray(v),
                                              jnp.asarray(b))))
    # ROWS bounds, then the prefix-difference sum and the sparse table
    rn = np.asarray(jax.jit(lambda x: JA.segmented_scan(
        jnp.add, jnp.ones(n, jnp.int32), x))(jnp.asarray(b)))
    i = np.arange(n)
    f = rng.normal(0, 100, n)

    @jax.jit
    def jax_frames(i, rn, b, v, f, lo, hi):
        s, e, p = JW._frame_bounds_rows(i, rn, b, lo, hi)
        return (s, e, JW._range_sum(v, b, s, e, p, jnp.int64),
                JW._range_sum(f, b, s, e, p, jnp.float64),
                JW._range_reduce(v, jnp.minimum, s, e),
                JW._range_reduce(v, jnp.maximum, s, e))

    for lo, hi in ((-3, 0), (-1, 2), (1, 4), (-5, -2)):
        js, je, jsum, jfsum, jmin, jmax = (np.asarray(x) for x in jax_frames(
            jnp.asarray(i, jnp.int32), jnp.asarray(rn), jnp.asarray(b),
            jnp.asarray(v), jnp.asarray(f), jnp.int32(lo), jnp.int32(hi)))
        s, e, p = W_._frame_bounds_rows(
            torch.from_numpy(i), torch.from_numpy(rn.copy()).to(torch.int64),
            tb, lo, hi)
        np.testing.assert_array_equal(s.numpy(), js)
        np.testing.assert_array_equal(e.numpy(), je)
        np.testing.assert_array_equal(
            W_._range_sum(torch.from_numpy(v), tb, s, e, p,
                          torch.int64).numpy(), jsum)
        np.testing.assert_allclose(
            W_._range_sum(torch.from_numpy(f), tb, s, e, p,
                          torch.float64).numpy(), jfsum, rtol=1e-12,
            atol=1e-9)
        ne = je >= js
        for kind, want in (("min", jmin), ("max", jmax)):
            got = W_._range_reduce(torch.from_numpy(v), kind, s, e).numpy()
            np.testing.assert_array_equal(got[ne], want[ne])


def test_compute_range_bounds_equals_jax():
    """The RANGE bound search over (partition ordinal, null flag, biased
    order value), nulls first and last, saturating at the int64 ends."""
    from spark_rapids_tpu.columnar.column import DeviceBatch as JB
    from spark_rapids_tpu.columnar.column import DeviceColumn as JC
    from spark_rapids_tpu.ops.expressions import BoundReference as JRef
    from spark_rapids_tpu.plan import logical as JL
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import (
        DeviceBatch, DeviceColumn)
    from spark_rapids_tpu_torch.exec import window as W_
    from spark_rapids_tpu_torch.ops.expressions import BoundReference
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu.columnar import dtypes as JT
    jax, jnp, JA, JW = _jax()
    rng = np.random.default_rng(9)
    n = 128
    b = _segments(rng, n, 0.08)
    pid = np.cumsum(b)
    vals = rng.integers(-30, 30, n).astype(np.int64)
    vals[:3] = [-(1 << 63), -(1 << 63) + 1, (1 << 63) - 1]
    valid = rng.random(n) > 0.1
    rn = np.asarray(jax.jit(lambda x: JA.segmented_scan(
        jnp.add, jnp.ones(n, jnp.int32), x))(jnp.asarray(b)))
    perm = np.arange(n)
    specs = [(-3, 2), (None, 1), (-2, None)]
    for nf in (True, False):
        # each partition sorted as the exec's sort leaves it: nulls on
        # their side, then ascending values
        null_key = valid if nf else ~valid
        o = np.lexsort((np.where(valid, vals, 0), null_key, pid))
        vals, valid = vals[o], valid[o]
        key = np.where(valid, vals, 0)
        peer = b | np.r_[True, (key[1:] != key[:-1])
                         | (valid[1:] != valid[:-1])]
        jb = JB(JT.StructType((JT.StructField("o", JT.LongT),)),
                (JC(JT.LongT, jnp.asarray(vals), jnp.asarray(valid)),),
                jnp.ones(n, bool))
        order = JL.SortOrder(JRef(0, JT.LongT, True), True, nf)
        want = jax.jit(lambda bt, pm, pb, pr, r: [
            JW._compute_range_bounds(bt, order, pm, pb, pr, r, specs)[sp]
            for sp in specs])(
                jb, jnp.asarray(perm), jnp.asarray(b), jnp.asarray(peer),
                jnp.asarray(rn))
        tb = DeviceBatch(T.StructType((T.StructField("o", T.LongT),)),
                         (DeviceColumn(T.LongT, torch.from_numpy(vals),
                                       torch.from_numpy(valid)),),
                         torch.ones(n, dtype=torch.bool))
        got = W_._compute_range_bounds(
            tb, L.SortOrder(BoundReference(0, T.LongT, True), True, nf),
            torch.from_numpy(perm), torch.from_numpy(b),
            torch.from_numpy(peer), torch.from_numpy(rn.copy()).to(
                torch.int64), specs)
        for sp, w3 in zip(specs, want):
            for g, w in zip(got[sp], w3):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
