"""TPC-H q11, q15, q17, q18 and q19 through the port against the JAX
package — the cross joins against a one-row side (q11's grouped sum
against its total, q15's revenue against its own max), a grouped avg
joined back to its own input (q17), a semi join on a filtered aggregate
(q18) and a disjunctive filter over a join (q19) — and the cross join
itself against one row and against zero rows.

Both sessions run ``bench.gen_tpch`` at ``bench.py``'s oracle scale
(sf 0.002; 0.01 for q11) under the defaults and under
``autoBroadcastJoinThreshold=0`` with ``join.targetRows=1024``.  At sf
0.01 no supplier of q11's nation exists, so q11 runs again at sf 0.02,
where it returns rows.  Results must be equal under
``bench._rows_equal(tol=1e-6)`` with equal schemas, and each join must
report the JAX package's strategy metrics.
"""

import numpy as np
import pyarrow as pa
import pytest

import bench

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch

# case -> (query, scale)
CASES = {"q11": ("q11", 0.01), "q11_sf0.02": ("q11", 0.02),
         "q15": ("q15", 0.002), "q17": ("q17", 0.002),
         "q18": ("q18", 0.002),
         "q19": ("q19", 0.002)}
CONFS = {
    "defaults": {},
    "noBroadcast": {"spark.sql.autoBroadcastJoinThreshold": 0,
                    "spark.rapids.tpu.join.targetRows": 1024},
}
_STRATEGY = ("streamedJoins", "subPartitionJoins")


def _strategies(df):
    """Each join's run-time strategy metrics, root first."""
    return [tuple(m.get(k, 0) for k in _STRATEGY)
            for name, m in df.metrics() if name == "TpuSortMergeJoinExec"]


@pytest.fixture(scope="module")
def tables():
    return {sf: bench.gen_tpch(sf) for _, sf in CASES.values()}


@pytest.fixture(scope="module")
def jax_runs(tables):
    """(case, conf name) -> (result, join strategies) of the JAX
    session."""
    out = {}
    for name, conf in CONFS.items():
        for case, (q, sf) in CASES.items():
            df = getattr(bench, q)(JaxSession(dict(conf)), tables[sf])
            out[case, name] = (df.toArrow(), _strategies(df))
    return out


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("case", list(CASES))
def test_query_matches_jax(tables, jax_runs, case, conf):
    q, sf = CASES[case]
    KN.COUNTERS.reset()
    df = getattr(tpch, q)(TpuSession(dict(CONFS[conf]), device="cpu"),
                          tables[sf])
    got = df.toArrow()
    want, want_strategies = jax_runs[case, conf]
    assert got.num_rows == want.num_rows
    assert got.num_rows > 0 or case == "q11"
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == want_strategies
    assert KN.COUNTERS.fallbacks == 0


def _cross(session, F, col, n_right):
    """A 300-row side with nulls and strings crossed with a side of
    ``n_right`` rows (a global aggregate for one row, an empty filter
    of it for zero), then filtered on both sides' columns."""
    rng = np.random.default_rng(11)
    n = 300
    null = rng.random(n) < 0.1
    left = pa.table({"k": pa.array(rng.integers(-50, 50, n), mask=null),
                     "x": pa.array(rng.random(n)),
                     "s": pa.array([f"s{i % 7}" for i in range(n)])})
    right = session.createDataFrame(pa.table({
        "v": pa.array(rng.random(40)), "g": pa.array(np.arange(40))}))
    one = right.agg(F.max(col("v")).alias("mv"), F.sum("g").alias("sg"))
    if n_right == 0:
        one = one.filter(col("sg") < 0)
    return (session.createDataFrame(left).crossJoin(one)
            .filter(col("x") <= col("mv")))


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("n_right", [1, 0])
def test_cross_join_matches_jax(n_right, conf):
    want = _cross(JaxSession(dict(CONFS[conf])), JF, jcol,
                  n_right).toArrow()
    got = _cross(TpuSession(dict(CONFS[conf]), device="cpu"), F, col,
                 n_right).toArrow()
    assert got.num_rows == (0 if n_right == 0 else 300)
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)


def test_cross_join_with_a_condition_raises():
    s = TpuSession(device="cpu")
    a = s.createDataFrame(pa.table({"a": [1, 2]}))
    b = s.createDataFrame(pa.table({"b": [1, 3]}))
    with pytest.raises(NotImplementedError,
                       match="residual join condition"):
        a.join(b, col("a") < col("b"), "cross").toArrow()
