"""The port's join exec against the JAX package on small numpy tables:
inner, left, right, full, left_semi and left_anti joins with null and
duplicate keys (int64, int32 x int64 and string keys; USING and
expression joins, residual conditions on inner and cross joins) under
each strategy the exec picks, the top-N, string comparisons, and the
branches the port does not have, each of which must raise
``NotImplementedError`` naming itself (the joins the JAX package runs
on the CPU fall back to the port's CPU join with the JAX package's
fallback report).  Results must be equal under
``bench._rows_equal(tol=1e-6)``, the reference's oracle rule.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import bench

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

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


# ---------------------------------------------------------------------------
# join types on a table with null and duplicate keys
# ---------------------------------------------------------------------------

def _sides(key_type=pa.int64(), right_key_type=None, n=3000,
           n_right=None, seed=3):
    """A left and a right table with null and duplicate keys ``k``."""
    rng = np.random.default_rng(seed)
    n_right = n // 2 if n_right is None else n_right

    def keys(n):
        k = rng.integers(-300, 300, n)
        null = rng.random(n) < 0.08
        return pa.array(np.where(null, 0, k), mask=null)

    left = pa.table({"k": keys(n).cast(key_type),
                     "a": pa.array(np.arange(n)),
                     "s": pa.array([f"r{i % 17}" for i in range(n)])})
    right = pa.table({"k": keys(n_right).cast(right_key_type or key_type),
                      "b": pa.array(rng.random(n_right)),
                      "k2": pa.array(rng.integers(0, 40, n_right))})
    return left, right


def _both(conf, build):
    """``build(session, F, col)`` through the JAX session and the port."""
    want = build(JaxSession(dict(conf)), JF, jcol).toArrow()
    got = build(TpuSession(dict(conf), device="cpu"), F, col).toArrow()
    return got, want


# (left rows, right rows, conf): both sides whole and broadcast; the
# left side streamed against the whole right side; the right side
# streamed (inner: the left side whole; semi/anti: _semi_stream_right)
_LAYOUTS = {
    "broadcast": (3000, 1500, {}),
    "streamLeft": (3000, 1500, {"spark.sql.autoBroadcastJoinThreshold": 0,
                                "spark.rapids.tpu.join.targetRows": 2048}),
    "streamRight": (1500, 3000, {"spark.sql.autoBroadcastJoinThreshold": 0,
                                 "spark.rapids.tpu.join.targetRows": 2048}),
}


def _join_type_cases():
    """(keys, how, layout).  A left or full join cannot stream its right
    side, nor a right join (a swapped left join) its left side: both
    packages sub-partition both sides there.  Mixed-width int keys on a
    right or full join fall back to the CPU in the JAX package and raise
    in the port (``test_unported_branch_raises``)."""
    return [pytest.param(k, h, l, id=f"{k}-{h}-{l}")
            for k in ("long", "int_x_long", "string", "string_widths",
                      "double")
            for h in ("inner", "left", "left_semi", "left_anti", "right",
                      "full")
            for l in _LAYOUTS
            if not (k == "int_x_long" and h in ("right", "full"))]


@pytest.mark.parametrize("keys, how, layout", _join_type_cases())
def test_join_types_match_jax(how, layout, keys):
    n, n_right, conf = _LAYOUTS[layout]
    if keys == "long":
        left, right = _sides(n=n, n_right=n_right)
    elif keys == "int_x_long":
        left, right = _sides(pa.int32(), pa.int64(), n=n, n_right=n_right)
    elif keys == "string":
        left, right = _sides(pa.string(), n=n, n_right=n_right)
    elif keys == "string_widths":
        # the right side's strings pad to 16 bytes, the left's to 8: the
        # keys must encode at the shared width
        left, right = _sides(pa.string(), n=n, n_right=n_right)
        k = right.column("k")
        longer = pc.if_else(pc.less(pc.utf8_length(k), 3),
                            pc.binary_join_element_wise(k, "-0123456789",
                                                        ""), k)
        right = right.set_column(0, "k", longer)
    else:
        # float64 keys have a raw float limb: unhashable, so the cuda
        # rung runs the exact search itself
        left, right = _sides(pa.float64(), n=n, n_right=n_right)

    def build(s, F_, c):
        return s.createDataFrame(left).join(s.createDataFrame(right),
                                            on="k", how=how)

    got, want = _both(conf, build)
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert got.num_rows > 0


# case -> (how, condition over left (k, a, s) and right (rk, b, k2))
_EXPRESSION_JOINS = {
    "inner": ("inner", lambda c: c("k") == c("rk")),
    "left_semi": ("left_semi", lambda c: c("k") == c("rk")),
    # the right join's swapped output remaps all left ++ all right
    "right": ("right", lambda c: c("k") == c("rk")),
    "full": ("full", lambda c: c("k") == c("rk")),
    # an equi key with a residual condition, applied as a sel mask
    "residual": ("inner", lambda c: (c("k") == c("rk"))
                 & (c("a") < 100 + c("k2") * 40)),
    # no equi key: the cross product with the condition
    "cross_condition": ("cross", lambda c: c("a") < c("rk")),
}


@pytest.mark.parametrize("case", list(_EXPRESSION_JOINS))
def test_expression_join_matches_jax(case):
    how, cond = _EXPRESSION_JOINS[case]
    left, right = _sides()
    if how == "cross":
        left = left.slice(0, 300)

    def build(s, F_, c):
        r = s.createDataFrame(right).select(c("k").alias("rk"), c("b"),
                                            c("k2"))
        return s.createDataFrame(left).join(r, cond(c), how)

    got, want = _both(_LAYOUTS["streamLeft"][2], build)
    assert got.column_names == want.column_names
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert got.num_rows > 0


def test_topn_matches_jax():
    left, _ = _sides()

    def build(s, F_, c):
        return (s.createDataFrame(left).groupBy("s")
                .agg(F_.sum("a").alias("t"))
                .orderBy(c("t").desc(), c("s")).limit(7))

    got, want = _both({}, build)
    assert got.to_pylist() == want.to_pylist()


def test_string_literal_comparison_matches_jax():
    left, _ = _sides(pa.string())

    def build(s, F_, c):
        df = s.createDataFrame(left)
        return df.filter((c("k") == "44") | (c("s") < "r12")
                         | (c("s") >= "r7"))

    got, want = _both({}, build)
    assert bench._rows_equal(got, want)
    assert 0 < got.num_rows < left.num_rows


# ---------------------------------------------------------------------------
# what the slice does not port raises
# ---------------------------------------------------------------------------

def _raises_cases():
    """(build, conf, what): ``what`` names the ``NotImplementedError`` of
    a branch the port does not have; None marks a branch the JAX package
    runs on the CPU, which the port now falls back to as well, or one
    both packages run on the device (a bare limit, the adaptive join)."""
    def join(how, on="k"):
        def build(s, F, col):
            left, right = _sides()
            return s.createDataFrame(left).join(
                s.createDataFrame(right), on=on, how=how)
        return build

    def residual_left(s, F, col):
        left, right = _sides()
        r = s.createDataFrame(right).select(col("k").alias("rk"), col("b"))
        return s.createDataFrame(left).join(
            r, (col("k") == col("rk")) & (col("a") < 100), "left")

    def bare_limit(s, F, col):
        left, _ = _sides()
        return s.createDataFrame(left).limit(3)

    def mismatched_keys(s, F, col):
        left, _ = _sides()
        _, right = _sides(pa.string())
        return s.createDataFrame(left).join(s.createDataFrame(right),
                                            on="k")

    def mixed_width_full(s, F, col):
        left, right = _sides(pa.int32(), pa.int64())
        return s.createDataFrame(left).join(s.createDataFrame(right),
                                            on="k", how="full")

    no_bc = {"spark.sql.autoBroadcastJoinThreshold": 0}
    return [
        pytest.param(residual_left, {}, None, id="residual_left"),
        pytest.param(mixed_width_full, {}, None, id="mixed_width_full"),
        pytest.param(join("inner"), dict(no_bc, **{
            "spark.rapids.tpu.adaptive.enabled": True}),
            None, id="adaptive"),
        pytest.param(bare_limit, {}, None, id="bare_limit"),
        pytest.param(mismatched_keys, {}, None, id="mismatched_keys"),
    ]


# a bare limit runs on the device in both packages: no fallback line
LIMIT_FALLBACK = []


@pytest.mark.parametrize("build, conf, what", _raises_cases())
def test_unported_branch_raises(build, conf, what):
    """A branch the port does not have raises naming itself; a join the
    JAX package keeps on the CPU (a residual condition on a left join,
    mixed-width int keys on a full join, key types of different
    families) falls back to the port's CPU join with the JAX package's
    result and fallback report.  A bare limit and the adaptive join
    (ported with the adaptive plane) run on the device with the JAX
    package's result, plan and empty report."""
    session = TpuSession(dict(conf), device="cpu")
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
            build(session, F, col).toArrow()
        return
    df = build(session, F, col)
    got = df.toArrow()
    jdf = build(JaxSession(dict(conf)), JF, jcol)
    want = jdf.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    want_report = jdf._last_override.fallback_report()
    if build.__name__ == "bare_limit":
        assert want_report == LIMIT_FALLBACK
        tree = df._last_plan.tree_string()
        assert "*TpuGlobalLimit [3]" in tree and "*TpuLocalLimit [3]" in tree
        assert tree == jdf._last_plan.tree_string()
    elif conf.get("spark.rapids.tpu.adaptive.enabled"):
        assert want_report == []
        tree = df._last_plan.tree_string()
        assert "*TpuAdaptiveLocalJoin [inner runtime=shuffled thresh=0]" \
            in tree
        assert tree == jdf._last_plan.tree_string()
    else:
        assert want_report  # the JAX package falls back too
    assert df._last_override.fallback_report() == want_report
