"""The port's join exec against the JAX package on small numpy tables:
inner, left, left_semi and left_anti joins with null and duplicate keys
(int64, int32 x int64 and string keys; USING and expression joins) under
each strategy the exec picks, the top-N, string comparisons, and the
branches the slice does not port, each of which must raise
``NotImplementedError`` naming itself.  Results must be equal under
``bench._rows_equal(tol=1e-6)``, the reference's oracle rule.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import bench

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


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


@pytest.mark.parametrize("how, layout", [
    (h, l) for h in ("inner", "left", "left_semi", "left_anti")
    # a left join cannot stream its right side: both packages
    # sub-partition both sides there
    for l in _LAYOUTS])
@pytest.mark.parametrize("keys", ["long", "int_x_long", "string",
                                  "string_widths", "double"])
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


@pytest.mark.parametrize("how", ["inner", "left_semi"])
def test_expression_join_matches_jax(how):
    left, right = _sides()

    def build(s, F_, c):
        r = s.createDataFrame(right).select(c("k").alias("rk"), c("b"))
        return s.createDataFrame(left).join(r, c("k") == c("rk"), how)

    got, want = _both(_LAYOUTS["streamLeft"][2], build)
    assert got.column_names == want.column_names
    assert bench._rows_equal(got, want, tol=1e-6)


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
    def join(how, on="k", conf=None):
        def run():
            left, right = _sides()
            s = TpuSession(conf or {}, device="cpu")
            return s.createDataFrame(left).join(
                s.createDataFrame(right), on=on, how=how).toArrow()
        return run

    def residual():
        left, right = _sides()
        s = TpuSession(device="cpu")
        r = s.createDataFrame(right).select(col("k").alias("rk"), col("b"))
        return s.createDataFrame(left).join(
            r, (col("k") == col("rk")) & (col("a") < 100), "inner"
        ).toArrow()

    def cross_condition():
        left, right = _sides()
        s = TpuSession(device="cpu")
        r = s.createDataFrame(right).select(col("k").alias("rk"), col("b"))
        return s.createDataFrame(left).join(
            r, col("a") < col("rk"), "cross").toArrow()

    def bare_limit():
        left, _ = _sides()
        return TpuSession(device="cpu").createDataFrame(left).limit(
            3).toArrow()

    def mismatched_keys():
        left, _ = _sides()
        _, right = _sides(pa.string())
        s = TpuSession(device="cpu")
        return s.createDataFrame(left).join(
            s.createDataFrame(right), on="k").toArrow()

    no_bc = {"spark.sql.autoBroadcastJoinThreshold": 0}
    return [
        pytest.param(join("right"), "right outer join", id="right"),
        pytest.param(join("full"), "full outer join", id="full"),
        pytest.param(cross_condition, "residual join condition",
                     id="cross_condition"),
        pytest.param(residual, "residual join condition", id="residual"),
        pytest.param(
            join("right", conf=dict(no_bc, **{
                "spark.rapids.tpu.join.targetRows": 256})),
            "right outer join", id="sub_partition_right"),
        pytest.param(
            join("inner", conf=dict(no_bc, **{
                "spark.rapids.tpu.adaptive.enabled": True})),
            "adaptive join", id="adaptive"),
        pytest.param(bare_limit, "limit without an order-by",
                     id="bare_limit"),
        pytest.param(mismatched_keys, "mismatched key types",
                     id="mismatched_keys"),
    ]


@pytest.mark.parametrize("run, what", _raises_cases())
def test_unported_branch_raises(run, what):
    with pytest.raises(NotImplementedError, match=what):
        run()
