"""The UDF compiler and device UDFs in the port against the JAX package.

Every case of ``tests/test_udf_compiler.py`` runs through the port's
session (``device="cpu"``, under ``spark.rapids.sql.test.enabled``) and
the JAX package's: rows, tree strings and fallback reports are equal,
and the CPU sessions of both give equal rows.  For each UDF that
compiles, the ``str()`` of the lowered tree (the select's expression,
and ``compile_udf``'s own result) equals the JAX package's, and the
plan holds no ``ArrowEvalPython``; a UDF that does not compile (a loop,
``int(s, 16)``, Python truthiness, two lambdas on one source line, the
compiler turned off) runs over the bridge, whose node the plan holds.
The device UDFs use functions valid on both jax arrays and torch
tensors (operators, ``abs``).

Each lambda sits alone on its source line: the compiler reads the
source (``inspect.getsource``).  Tolerances: integers, strings, nulls
and booleans exactly; doubles exactly, except where the two packages'
devices may contract a multiply-add differently (1e-12 relative).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.ops.expressions import BoundReference as JRef
from spark_rapids_tpu.plan.analysis import AnalysisException as JAE
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import udf_compiler as JU
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.ops.expressions import BoundReference
from spark_rapids_tpu_torch.plan.analysis import AnalysisException
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import udf_compiler as U
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


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


CONF = {"spark.rapids.sql.test.enabled": True,
        "spark.rapids.sql.udfCompiler.enabled": True}
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}


def base_table(n=200, seed=0):
    """``tests/test_udf_compiler.py::base_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(-50, 50, n)),
        "b": pa.array(rng.normal(size=n)),
        "s": pa.array([f"Str{i%7}" for i in range(n)]),
    })


def _device_table():
    rng = np.random.default_rng(5)
    return pa.table({
        "x": pa.array([None if i % 9 == 0 else float(v) for i, v in
                       enumerate(rng.uniform(0.1, 5, 2000))],
                      pa.float64()),
        "y": pa.array(rng.integers(1, 50, 2000)),
    })


ARITH = lambda x: x * 2 + 1  # noqa: E731
CONDITIONAL = lambda x: x if x > 0 else -x  # noqa: E731
MATH = lambda x, y: max(abs(x), y * y)  # noqa: E731
UPPER = lambda s: s.upper()  # noqa: E731
IS_NONE = lambda v: v is None  # noqa: E731
LOOP = lambda x: sum(range(int(x) % 3))  # noqa: E731
PLUS_ONE = lambda x: x + 1  # noqa: E731
AMBIGUOUS_A, AMBIGUOUS_B = (lambda v: v + 1), (lambda v: v - 1)  # noqa: E731
HEX = lambda s: int(s, 16)  # noqa: E731
MOD7 = lambda x: x % 7  # noqa: E731
TRUTHY = lambda x: 1 if x else 0  # noqa: E731
NONE = lambda x: None  # noqa: E731
STRIP_EQ = lambda s: s.strip() != "Str3" and s.lower() >= "str2"  # noqa: E731
MIN_MIX = lambda x, y: min(x, y) - 2 ** x / 4 if x is not None else 0.5  # noqa: E731


def half(x):
    """Docstrings are fine."""
    return x / 2


def smooth(x, y):
    """A device UDF valid on jax arrays and torch tensors alike."""
    return abs(x) * y - x * x


def _sel(fn, rt, args, table, keep=()):
    """build(session, F, col): ``table`` -> select(keep..., udf(args))."""
    def build(s, F, c):
        return s.createDataFrame(table).select(
            *keep, F.udf(fn, rt)(*[c(a) for a in args]).alias("y"))
    return build


T0, T1, T2, T3 = base_table(), base_table(1), base_table(2), base_table(3)
T4, T5, T6, T7 = base_table(4), base_table(5), base_table(6), base_table(7)
T8, T9 = base_table(8), base_table(20, 9)
NULLS = pa.table({"x": pa.array([1, None, 3], type=pa.int64())})
HEXES = pa.table({"s": pa.array(["1f", "ff"])})
MODS = pa.table({"x": pa.array([-3, 3, -7, 7, 0], type=pa.int64())})
DEV = _device_table()
INCOMPAT = dict(CONF, **{"spark.rapids.sql.incompatibleOps.enabled": True})

# name: (build, conf, compiles, float tolerance)
CASES = {
    "arith_udf_compiles_to_device": (
        _sel(ARITH, "long", ["a"], T0, keep=("a",)), CONF, True, 0),
    "conditional_udf_compiles": (
        _sel(CONDITIONAL, "long", ["a"], T1), CONF, True, 0),
    "two_arg_and_math_udf": (
        _sel(MATH, "double", ["a", "b"], T2), CONF, True, 0),
    "string_method_udf": (
        _sel(UPPER, "string", ["s"], T3), INCOMPAT, True, 0),
    "none_check_udf": (
        _sel(IS_NONE, "boolean", ["x"], NULLS), CONF, True, 0),
    "def_form_compiles": (
        _sel(half, "double", ["a"], T4), CONF, True, 0),
    "unsupported_falls_back_to_bridge": (
        _sel(LOOP, "long", ["a"], T5), CONF, False, 0),
    "disabled_always_bridges": (
        _sel(PLUS_ONE, "long", ["a"], T6), TEST, False, 0),
    "two_lambdas_one_line_falls_back": (
        _sel(AMBIGUOUS_B, "long", ["a"], T7, keep=("a",)), CONF, False, 0),
    "int_with_base_falls_back": (
        _sel(HEX, "long", ["s"], HEXES), CONF, False, 0),
    "compiled_modulo_python_semantics": (
        _sel(MOD7, "long", ["x"], MODS), CONF, True, 0),
    "truthiness_condition_falls_back": (
        _sel(TRUTHY, "long", ["a"], T8), CONF, False, 0),
    "none_returning_udf_compiles_with_declared_type": (
        _sel(NONE, "long", ["a"], T9), CONF, True, 0),
    "string_compare_and_strip": (
        _sel(STRIP_EQ, "boolean", ["s"], T3), INCOMPAT, True, 0),
    "min_pow_and_none_check": (
        _sel(MIN_MIX, "double", ["a", "b"], T2), CONF, True, 0),
    "device_udf_fuses_on_device": (
        lambda s, F, c: s.createDataFrame(DEV).select(
            (F.device_udf(returnType="double")(smooth)(c("x"), c("y"))
             + 1.0).alias("r"), c("y")), TEST, None, 1e-12),
}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string, logical select expressions), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf, _, _ = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol).toArrow(), None, None, None)
            else:
                df = build(JaxSession(dict(conf)), JF, jcol)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string(),
                    [str(e) for e in df._plan.exprs])
        return memo[(name, host)]

    return run


def same_rows(got: pa.Table, want: pa.Table, tol) -> None:
    assert got.schema == want.schema
    g, w = got.to_pylist(), want.to_pylist()
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
    build, conf, compiles, tol = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree, exprs = jax_run(name)
    same_rows(got, want, tol)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    if compiles is not None:
        assert ("ArrowEvalPython" in tree) is (not compiles)
        if compiles:
            assert [str(e) for e in df._plan.exprs] == exprs


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf, _, tol = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=True)[0], tol)


def test_what_the_jax_tests_pin(jax_run):
    """The facts ``tests/test_udf_compiler.py`` states: the conditional
    is non-negative, upper() starts ``STR``, the two-lambda line gives
    ``a - 1`` (not ``a + 1``), ``int(s, 16)`` reads hex, Python's ``%``
    sign rule, and a UDF returning None is a null of the declared type;
    the device UDF plan has no bridge node."""
    assert all(v >= 0 for v in jax_run("conditional_udf_compiles")[0]
               .column("y").to_pylist())
    assert jax_run("string_method_udf")[0].column("y").to_pylist()[0] \
        .startswith("STR")
    out = jax_run("two_lambdas_one_line_falls_back")[0]
    assert out.column("y").to_pylist() == [
        v - 1 for v in out.column("a").to_pylist()]
    assert jax_run("int_with_base_falls_back")[0].column("y") \
        .to_pylist() == [31, 255]
    assert jax_run("compiled_modulo_python_semantics")[0].column("y") \
        .to_pylist() == [4, 3, 0, 0, 0]
    out = jax_run("none_returning_udf_compiles_with_declared_type")[0]
    assert out.column("y").to_pylist() == [None] * 20
    assert out.schema.field("y").type == pa.int64()
    assert "ArrowEvalPython" not in jax_run("device_udf_fuses_on_device")[2]


@pytest.mark.parametrize("fn, arg_types, rt", [
    (ARITH, ("LongT",), "LongT"), (CONDITIONAL, ("LongT",), "LongT"),
    (MATH, ("LongT", "DoubleT"), "DoubleT"),
    (UPPER, ("StringT",), "StringT"), (IS_NONE, ("LongT",), "BooleanT"),
    (half, ("LongT",), "DoubleT"), (MOD7, ("LongT",), "LongT"),
    (NONE, ("LongT",), "LongT"), (STRIP_EQ, ("StringT",), "BooleanT"),
    (MIN_MIX, ("LongT", "DoubleT"), "DoubleT"),
    (PLUS_ONE, ("IntegerT",), "LongT")])
def test_compile_udf_lowers_as_the_jax_package(fn, arg_types, rt):
    """``compile_udf``'s lowered tree prints as the JAX package's."""
    got = U.compile_udf(fn, [BoundReference(i, getattr(T, t))
                             for i, t in enumerate(arg_types)],
                        getattr(T, rt))
    want = JU.compile_udf(fn, [JRef(i, getattr(JT, t))
                               for i, t in enumerate(arg_types)],
                          getattr(JT, rt))
    assert str(got) == str(want)
    assert type(got).__name__ == type(want).__name__


def test_compile_udf_unit():
    """``tests/test_udf_compiler.py::test_compile_udf_unit``, and each
    refusal's message equal to the JAX package's."""
    e = U.compile_udf(lambda x: x + 1,
                      [BoundReference(0, T.LongT)], T.LongT)
    assert type(e).__name__ in ("Add", "Cast")
    cases = [
        (lambda x: [x], 1), (lambda x, y: x, 1),
        (LOOP, 1), (HEX, 1), (TRUTHY, 1), (AMBIGUOUS_A, 1),
        (lambda x: x < 1 < 2, 1), (lambda x: x.upper(), 1),
        (lambda *x: x, 1), (lambda x: x // 2, 1)]
    for fn, n in cases:
        args = [BoundReference(i, T.LongT) for i in range(n)]
        jargs = [JRef(i, JT.LongT) for i in range(n)]
        with pytest.raises(JU.UdfCompileError) as je:
            JU.compile_udf(fn, jargs, JT.LongT)
        with pytest.raises(U.UdfCompileError) as pe:
            U.compile_udf(fn, args, T.LongT)
        assert str(pe.value) == str(je.value)


def test_device_udf_rejects_string_args():
    t = pa.table({"s": pa.array(["a", "b"])})

    def build(s, F, c):
        @F.device_udf(returnType="double")
        def bad(s):
            return s

        return s.createDataFrame(t).select(bad(c("s")))

    with pytest.raises(JAE, match="device_udf") as je:
        build(JaxSession({}), JF, jcol)
    with pytest.raises(AnalysisException, match="device_udf") as pe:
        build(TpuSession({}, device="cpu"), F, col)
    assert str(pe.value) == str(je.value)


def test_device_udf_sees_tensors_on_the_batch_device():
    """The device branch hands the function the columns' tensors (on the
    batch's device); the CPU oracle hands it CPU tensors made from the
    host arrays; nulls are the intersection of the inputs'."""
    seen = []

    def probe(x, y):
        seen.append((type(x), x.dtype, y.dtype))
        return x + y

    t = pa.table({"x": pa.array([1.5, None, 3.0]),
                  "y": pa.array([1, 2, None], pa.int64())})
    for conf in (TEST, HOST):
        out = TpuSession(dict(conf), device="cpu").createDataFrame(t) \
            .select(F.device_udf(probe)(col("x"), col("y")).alias("z")) \
            .toArrow()
        assert out.column("z").to_pylist() == [2.5, None, None]
    assert seen == [(torch.Tensor, torch.float64, torch.int64)] * 2
