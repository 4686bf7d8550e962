"""The arithmetic, null, math and date expressions of the port's
``ops/expressions.py`` and ``ops/datetime_ops.py`` against the JAX
package's, on both branches, and through the DataFrame API.

Mirrors ``tests/test_expressions.py``'s cases for these classes
(``IntegralDivide``, ``Remainder``, ``UnaryMinus``, ``Abs``,
``EqualNullSafe``, ``IsNull``, ``IsNotNull``, ``IsNaN``, ``Coalesce``,
``Sqrt``, ``Exp``, ``Log``, ``Pow``, ``Floor``, ``Ceil``, ``Round``,
``Month``, ``DayOfMonth``, ``DateAdd``, ``DateSub``, ``DateDiff``) over
tables made with the JAX package's data generators from a seed, with
the edge rows appended: ``MIN div -1``, ``MIN % -1``, ``x % 0``, NaN,
the infinities, +-1e300, -0.0, .5 ties, zero and negative logarithms.

The device branch is the port's ``eval`` on CPU tensors against the
JAX package's ``eval_tpu``; the host branch the port's ``eval_cpu``
against its ``eval_cpu``.  Validity must be equal on every live row,
and the data on every valid live row, bit for bit (-0.0 included; a
NaN equals any NaN, as NaN payloads differ between libraries), except the device branch's ``Exp``, ``Log`` and ``Pow``:
torch's and XLA's transcendental functions are different
implementations, so those must agree within ``ULPS`` units in the last
place.  The host branch is numpy on both sides and exact everywhere.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar import column as JC  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.columnar import host as JH  # noqa: E402
from spark_rapids_tpu.ops import datetime_ops as JD  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import strings as JS  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402
from spark_rapids_tpu.utils import datagen as dg  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar import host as H  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import host_to_device  # noqa: E402
from spark_rapids_tpu_torch.ops import datetime_ops as D  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import strings as S  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402

# the device branch's Exp, Log and Pow against XLA's: units in the last
# place (every other result is exact)
ULPS = 2
MIN64, MAX64 = -(1 << 63), (1 << 63) - 1
MIN32 = -(1 << 31)
N = 500


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small batches: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_edges(gens, edges, seed):
    """``N`` generated rows, then the edge rows (columns as lists)."""
    t = dg.gen_table(gens, N, seed=seed)
    cols = {}
    for i, name in enumerate(t.column_names):
        cols[name] = pa.concat_arrays([
            t.column(i).combine_chunks(),
            pa.array(edges[i], t.column(i).type)])
    return pa.table(cols)


_NAN, _INF = float("nan"), float("inf")
_D_EDGE_A = [_NAN, _INF, -_INF, 1e300, -1e300, 0.0, -0.0, 0.5, 1.5, 2.5,
             -0.5, -2.5, 1.005, 2.675, -1e-300, 9.2233720368547758e18,
             -9.2233720368547758e18, 5.5, -7.25, 3.0, None, 0.125]
_D_EDGE_B = [_NAN, 2.0, 0.0, -0.0, 3.0, 0.0, 1.0, _NAN, -2.0, 0.5, 3.0,
             _INF, 0.0, -1.0, 2.0, -0.0, 1e300, None, 2.0, -3.0, 1.0, -0.5]


def _tables():
    long_edges = ([MIN64, MIN64, 7, -7, 7, -7, 3, 0, MAX64, MIN64, 0, None,
                   MIN64, 12],
                  [-1, 1, 3, 3, -3, -3, 0, 5, -1, 0, -1, 2, MIN64, None])
    int_edges = ([MIN32, MIN32, 7, -7, 3, (1 << 31) - 1, None, 9],
                 [-1, 0, -3, 3, 0, -1, 4, None])
    return {
        "longs": _with_edges([dg.LongGen(), dg.LongGen()], long_edges, 1),
        "ints": _with_edges([dg.IntegerGen(), dg.IntegerGen()], int_edges,
                            2),
        "doubles": _with_edges([dg.DoubleGen(), dg.DoubleGen()],
                               (_D_EDGE_A, _D_EDGE_B), 3),
        "floats": _with_edges([dg.FloatGen()],
                              ([_NAN, -0.0, 0.25, -2.5, 1e30, None],), 4),
        "strings": _with_edges([dg.StringGen(max_len=13),
                                dg.StringGen(max_len=13)],
                               (["", "a", None, "é", None],
                                ["", "a", "b", None, None]), 5),
        "dates": _with_edges(
            [dg.DateGen(), dg.IntegerGen(), dg.DateGen()],
            ([datetime.date(2020, 2, 29), datetime.date(1969, 12, 31),
              datetime.date(1582, 10, 15), None],
             [1, -1, 365, 3], [datetime.date(2020, 1, 1),
                               datetime.date(1970, 1, 1), None,
                               datetime.date(1600, 3, 1)]), 6),
        "timestamps": _with_edges([dg.TimestampGen()], ([0, -1, None],), 7),
    }


TABLES = _tables()


def _ref(E_, T_, table, i):
    t = TABLES[table]
    return E_.BoundReference(i, T_.from_arrow(t.column(i).type))


def _lit(E_, T_, v, dt="LongT"):
    return E_.Literal(v, getattr(T_, dt))


def _cases():
    """name -> (table, build(E, D, S, T)) of the same expression in
    either package."""
    r = _ref
    c = {}
    for t in ("longs", "ints"):
        c[f"integral_divide_{t}"] = (t, lambda E_, D_, S_, T_, t=t:
                                     E_.IntegralDivide(r(E_, T_, t, 0),
                                                       r(E_, T_, t, 1)))
        c[f"remainder_{t}"] = (t, lambda E_, D_, S_, T_, t=t: E_.Remainder(
            r(E_, T_, t, 0), r(E_, T_, t, 1)))
        c[f"unary_minus_{t}"] = (t, lambda E_, D_, S_, T_, t=t:
                                 E_.UnaryMinus(r(E_, T_, t, 0)))
        c[f"abs_{t}"] = (t, lambda E_, D_, S_, T_, t=t: E_.Abs(
            r(E_, T_, t, 0)))
        c[f"equal_null_safe_{t}"] = (t, lambda E_, D_, S_, T_, t=t:
                                     E_.EqualNullSafe(r(E_, T_, t, 0),
                                                      r(E_, T_, t, 1)))
        c[f"is_null_{t}"] = (t, lambda E_, D_, S_, T_, t=t: E_.IsNull(
            r(E_, T_, t, 0)))
        c[f"is_not_null_{t}"] = (t, lambda E_, D_, S_, T_, t=t:
                                 E_.IsNotNull(r(E_, T_, t, 1)))
    c["coalesce_longs"] = ("longs", lambda E_, D_, S_, T_: E_.Coalesce(
        [r(E_, T_, "longs", 0), r(E_, T_, "longs", 1)]))
    c["coalesce_longs_literal"] = (
        "longs", lambda E_, D_, S_, T_: E_.Coalesce(
            [r(E_, T_, "longs", 0), r(E_, T_, "longs", 1),
             _lit(E_, T_, 0)]))
    c["coalesce_doubles"] = ("doubles", lambda E_, D_, S_, T_: E_.Coalesce(
        [r(E_, T_, "doubles", 0), r(E_, T_, "doubles", 1)]))
    c["coalesce_strings"] = ("strings", lambda E_, D_, S_, T_: E_.Coalesce(
        [r(E_, T_, "strings", 0), r(E_, T_, "strings", 1),
         _lit(E_, T_, "none", "StringT")]))
    c["equal_null_safe_strings"] = (
        "strings", lambda E_, D_, S_, T_: S_.string_comparison(
            "eqns", r(E_, T_, "strings", 0), r(E_, T_, "strings", 1)))
    d = "doubles"
    c["remainder_doubles"] = (d, lambda E_, D_, S_, T_: E_.Remainder(
        r(E_, T_, d, 0), r(E_, T_, d, 1)))
    c["unary_minus_doubles"] = (d, lambda E_, D_, S_, T_: E_.UnaryMinus(
        r(E_, T_, d, 0)))
    c["abs_doubles"] = (d, lambda E_, D_, S_, T_: E_.Abs(r(E_, T_, d, 0)))
    c["equal_null_safe_doubles"] = (d, lambda E_, D_, S_, T_:
                                    E_.EqualNullSafe(r(E_, T_, d, 0),
                                                     r(E_, T_, d, 1)))
    c["is_nan_doubles"] = (d, lambda E_, D_, S_, T_: E_.IsNaN(
        r(E_, T_, d, 0)))
    c["is_nan_floats"] = ("floats", lambda E_, D_, S_, T_: E_.IsNaN(
        r(E_, T_, "floats", 0)))
    for name in ("Sqrt", "Exp", "Log", "Floor", "Ceil"):
        c[name.lower()] = (d, lambda E_, D_, S_, T_, name=name: getattr(
            E_, name)(r(E_, T_, d, 0)))
        c[name.lower() + "_b"] = (d, lambda E_, D_, S_, T_, name=name:
                                  getattr(E_, name)(r(E_, T_, d, 1)))
    c["pow"] = (d, lambda E_, D_, S_, T_: E_.Pow(r(E_, T_, d, 0),
                                                 r(E_, T_, d, 1)))
    for scale in (0, 2, -1):
        c[f"round_{scale}"] = (d, lambda E_, D_, S_, T_, scale=scale:
                               E_.Round(r(E_, T_, d, 0), scale))
    c["round_floats_1"] = ("floats", lambda E_, D_, S_, T_: E_.Round(
        r(E_, T_, "floats", 0), 1))
    c["round_longs_2"] = ("longs", lambda E_, D_, S_, T_: E_.Round(
        r(E_, T_, "longs", 0), 2))
    for field in ("Year", "Month", "DayOfMonth"):
        c[f"{field.lower()}_dates"] = (
            "dates", lambda E_, D_, S_, T_, field=field: getattr(
                D_, field)(r(E_, T_, "dates", 0)))
        c[f"{field.lower()}_timestamps"] = (
            "timestamps", lambda E_, D_, S_, T_, field=field: getattr(
                D_, field)(r(E_, T_, "timestamps", 0)))
    for cls in ("DateAdd", "DateSub"):
        c[cls.lower()] = ("dates", lambda E_, D_, S_, T_, cls=cls: getattr(
            D_, cls)(r(E_, T_, "dates", 0), r(E_, T_, "dates", 1)))
    c["datediff"] = ("dates", lambda E_, D_, S_, T_: D_.DateDiff(
        r(E_, T_, "dates", 0), r(E_, T_, "dates", 2)))
    return c


CASES = _cases()
INEXACT = {"exp", "exp_b", "log", "log_b", "pow"}


@pytest.fixture(scope="module")
def batches():
    """table -> (JAX device batch, port device batch, JAX host batch,
    port host batch)."""
    cpu = torch.device("cpu")
    return {name: (JC.host_to_device(t), host_to_device(t, cpu),
                   JH.from_arrow_table(t), H.from_arrow_table(t))
            for name, t in TABLES.items()}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between float64 arrays (0
    where both are NaN)."""
    def ordered(x):
        i = x.view(np.int64)
        return np.where(i < 0, np.int64(MIN64) - i, i)
    both_nan = np.isnan(a) & np.isnan(b)
    with np.errstate(over="ignore"):
        d = np.abs(ordered(a) - ordered(b))
    return np.where(both_nan, 0, d)


def _same(got, want, valid, exact=True):
    """Data equal at the valid rows: bit for bit, or within ``ULPS``."""
    got, want = got[valid], want[valid]
    assert got.dtype == want.dtype
    if got.dtype == object:
        assert got.tolist() == want.tolist()
    elif exact:
        if got.dtype.kind == "f":  # one NaN: payloads differ by library
            got = np.where(np.isnan(got), np.nan, got)
            want = np.where(np.isnan(want), np.nan, want)
        assert got.tobytes() == want.tobytes()
    else:
        assert int(_ulps(got, want).max(initial=0)) <= ULPS


@pytest.mark.parametrize("case", list(CASES))
def test_device_branch_equals_jax(batches, case):
    table, build = CASES[case]
    jb, pb, _, _ = batches[table]
    jexpr, pexpr = build(JE, JD, JS, JT), build(E, D, S, T)
    assert pexpr.dtype.simple_name == jexpr.dtype.simple_name
    jc, pc = jexpr.eval_tpu(jb), pexpr.eval(pb)
    live = np.asarray(jb.sel)
    jv = np.asarray(jc.valid_mask())[live]
    pv = pc.valid_mask().numpy()[live]
    np.testing.assert_array_equal(pv, jv)
    jd, pd = np.asarray(jc.data)[live], pc.data.numpy()[live]
    if jc.lengths is not None:  # strings: each valid row's bytes
        jl = np.asarray(jc.lengths)[live]
        np.testing.assert_array_equal(pc.lengths.numpy()[live][jv], jl[jv])
        for row in np.flatnonzero(jv):
            assert bytes(pd[row, :jl[row]]) == bytes(jd[row, :jl[row]])
        return
    _same(pd, jd, jv, exact=case not in INEXACT)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cpu_equals_jax(batches, case):
    table, build = CASES[case]
    _, _, jh, ph = batches[table]
    jc = build(JE, JD, JS, JT).eval_cpu(jh)
    pc = build(E, D, S, T).eval_cpu(ph)
    jv, pv = np.asarray(jc.valid_mask()), np.asarray(pc.valid_mask())
    np.testing.assert_array_equal(pv, jv)
    _same(np.asarray(pc.data), np.asarray(jc.data), jv)


def test_the_edges_are_the_jax_packages(batches):
    """``MIN div -1`` wraps to MIN and ``MIN % -1`` is 0 without a trap;
    ``x % 0`` is null; floor and ceil of NaN, +-inf and +-1e300 give
    ``eval_tpu``'s bits on CPU tensors: NaN -> 0, saturating."""
    jb, pb, _, _ = batches["longs"]
    n = N
    div = E.IntegralDivide(_ref(E, T, "longs", 0), _ref(E, T, "longs", 1))
    rem = E.Remainder(_ref(E, T, "longs", 0), _ref(E, T, "longs", 1))
    q, m = div.eval(pb), rem.eval(pb)
    assert q.data[n].item() == MIN64 and q.data[n + 8].item() == -MAX64
    assert m.data[n].item() == 0 and m.data[n + 8].item() == 0
    assert not m.validity[n + 6] and not q.validity[n + 6]  # x % 0
    jb, pb, _, _ = batches["doubles"]
    fl = E.Floor(_ref(E, T, "doubles", 0)).eval(pb).data[N:N + 5].tolist()
    ce = E.Ceil(_ref(E, T, "doubles", 0)).eval(pb).data[N:N + 5].tolist()
    assert fl == ce == [0, MAX64, MIN64, MAX64, MIN64]
    want = np.asarray(JE.Floor(_ref(JE, JT, "doubles", 0)).eval_tpu(
        jb).data)[N:N + 5].tolist()
    assert fl == want


def test_round_keeps_the_branches_signs(batches):
    """HALF_UP at .5 ties; -0.0 stays -0.0 on the device branch, as
    ``jnp.sign`` keeps it, and becomes 0.0 on the host branch, as
    ``np.sign`` gives it."""
    _, pb, _, ph = batches["doubles"]
    rd = E.Round(_ref(E, T, "doubles", 0), 0)
    dev = rd.eval(pb).data[N:N + 12].numpy()
    host = rd.eval_cpu(ph).data[N:N + 12]
    assert dev[7:12].tolist() == [1.0, 2.0, 3.0, -1.0, -3.0]
    assert np.signbit(dev[6]) and not np.signbit(host[6])


# -- through the DataFrame API ------------------------------------------------

def api_table(seed=11, n=600):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": dg.IntegerGen().generate(rng, n),
        "l": dg.LongGen().generate(rng, n),
        "d": dg.DoubleGen().generate(rng, n),
        "dt": dg.DateGen().generate(rng, n),
        "dt2": dg.DateGen().generate(rng, n),
        "s": dg.StringGen(max_len=9).generate(rng, n),
    })


def api_select(s, F_, col_):
    d, i = col_("d"), col_("i")
    maybe = F_.when(i > 0, d)  # null on part of the rows
    return s.createDataFrame(api_table()).select(
        (i % 7).alias("mod"), (col_("l") % col_("i")).alias("lmod"),
        (-col_("l")).alias("neg"), F_.abs(i).alias("abs"),
        F_.sqrt(d).alias("sqrt"), F_.floor(d).alias("floor"),
        F_.ceil(d).alias("ceil"),
        F_.isnan(d).alias("isnan"), d.isNaN().alias("isnan2"),
        F_.coalesce(maybe, F_.lit(-1.0)).alias("coalesce"),
        maybe.isNull().alias("isnull"), maybe.isNotNull().alias("notnull"),
        maybe.eqNullSafe(d).alias("eqns"),
        col_("s").eqNullSafe(F_.lit("a")).alias("eqns_s"),
        F_.month(col_("dt")).alias("month"),
        F_.dayofmonth(col_("dt")).alias("day"),
        F_.date_add(col_("dt"), F_.lit(30)).alias("add"),
        F_.date_sub(col_("dt"), F_.lit(7)).alias("sub"),
        F_.datediff(col_("dt"), col_("dt2")).alias("diff"),
        F_.hash(i, col_("s")).alias("h"),
        F_.xxhash64(col_("l"), col_("s")).alias("x"))


def api_math(s, F_, col_):
    """Exp, log, pow and round through the API: on the device equal to
    the JAX package's within ``ULPS`` — the transcendental functions are
    different libraries, and XLA compiles ``Round``'s division by
    10^scale into a multiplication by its reciprocal (1 ulp from the
    JAX package's own eager ``eval_tpu``, which the port equals
    exactly above); on the host exactly."""
    d = col_("d")
    return s.createDataFrame(api_table()).select(
        F_.exp(d).alias("exp"), F_.log(d).alias("log"),
        F_.pow(d, F_.lit(1.5)).alias("pow"), F_.round(d, 2).alias("round"))


def _same_rows(got, want):
    """Every column's values in order, by ``repr`` (NaN and -0.0
    included; dates as their int32 days, since a shifted date can leave
    Python's range); a mismatch names its column and first row."""
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_date32(w.type):
            g, w = g.cast(pa.int32()), w.cast(pa.int32())
        gl, wl = g.to_pylist(), w.to_pylist()
        bad = [i for i, (a, b) in enumerate(zip(gl, wl)) if repr(a) != repr(b)]
        assert len(gl) == len(wl) and not bad, (
            name, bad[:5], [(gl[i], wl[i]) for i in bad[:5]])


@pytest.mark.parametrize("build", [api_select, api_math],
                         ids=["select", "math"])
@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_api_equals_jax(build, device):
    """Every new function through ``select``: the port's rows equal the
    JAX package's in order, NaN and -0.0 included, the tree string and
    the empty fallback report too; the host branch through a plain CPU
    session (``spark.rapids.sql.enabled=false``) on both sides."""
    conf = {} if device else {"spark.rapids.sql.enabled": False}
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    jdf = build(JaxSession(dict(conf)), JF, jcol)
    got, want = df.toArrow(), jdf.toArrow()
    assert got.schema == want.schema
    if build is api_select or not device:
        _same_rows(got, want)
    else:
        for name in got.column_names:
            g = got.column(name).to_numpy(zero_copy_only=False)
            w = want.column(name).to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            assert int(_ulps(g, w).max(initial=0)) <= ULPS, name
    if device:
        assert df._last_override.fallback_report() == []
        assert df._last_override.fallback_report() == \
            jdf._last_override.fallback_report()
        assert df._last_plan.tree_string() == jdf._last_plan.tree_string()


def test_api_operators_resolve_to_the_classes():
    schema = T.StructType((T.StructField("a", T.LongT),
                           T.StructField("d", T.DoubleT),
                           T.StructField("s", T.StringT)))
    from spark_rapids_tpu_torch.plan import analysis as AN
    got = {
        "mod": AN.resolve((col("a") % 3)._u, schema),
        "neg": AN.resolve((-col("a"))._u, schema),
        "eqns": AN.resolve(col("a").eqNullSafe(1)._u, schema),
        "eqns_s": AN.resolve(col("s").eqNullSafe("x")._u, schema),
        "pow": AN.resolve(F.pow(col("a"), 2)._u, schema),
        "floor": AN.resolve(F.floor(col("a"))._u, schema),
    }
    assert isinstance(got["mod"], E.Remainder)
    assert isinstance(got["neg"], E.UnaryMinus)
    assert isinstance(got["eqns"], E.EqualNullSafe)
    assert isinstance(got["eqns_s"], S.StringComparison)
    assert got["eqns_s"].op == "eqns"
    assert isinstance(got["pow"], E.Pow)
    assert isinstance(got["pow"].left, E.Cast)  # long -> double
    assert isinstance(got["floor"], E.Floor)
    assert got["floor"].dtype == T.LongT
    df = TpuSession(device="cpu").createDataFrame(
        pa.table({"a": pa.array([3, None, 1], pa.int64())}))
    for order, want in (
            (col("a").asc_nulls_first(), [None, 1, 3]),
            (col("a").asc_nulls_last(), [1, 3, None]),
            (col("a").desc_nulls_first(), [None, 3, 1]),
            (col("a").desc_nulls_last(), [3, 1, None])):
        assert df.orderBy(order).toArrow()["a"].to_pylist() == want


def test_rebinding_walk_reaches_coalesce_children():
    """``Coalesce.exprs`` is a list field: the optimizer's generic walk
    rebinds every argument (the walk that once missed CASE branches)."""
    t = pa.table({"a": pa.array([1, None, 3], pa.int64()),
                  "b": pa.array([None, 20, None], pa.int64()),
                  "c": pa.array([5, 6, 7], pa.int64())})
    s = TpuSession(device="cpu")
    df = s.createDataFrame(t).select(
        F.coalesce(col("b"), col("a")).alias("x"), col("c"))
    out = df.filter(col("c") > 5).toArrow()
    assert out.to_pylist() == [{"x": 20, "c": 6}, {"x": 3, "c": 7}]
    jdf = JaxSession().createDataFrame(t).select(
        JF.coalesce(jcol("b"), jcol("a")).alias("x"), jcol("c"))
    assert out.equals(jdf.filter(jcol("c") > 5).toArrow())


def test_the_analyzer_checks_numeric_operands():
    s = TpuSession(device="cpu")
    df = s.createDataFrame(pa.table({"s": pa.array(["a"])}))
    from spark_rapids_tpu_torch.plan.analysis import AnalysisException
    with pytest.raises(AnalysisException, match="'mod' needs numeric"):
        df.select(col("s") % 2)
