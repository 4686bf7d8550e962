"""TPC-H q5, q10 and q12 through the port against the JAX package: the
multi-join queries (five tables in q5, a group-by over a double and a
string key in q10, a conditional count in q12).

Both sessions run ``bench.gen_tpch(0.002)``, ``bench.py``'s oracle
scale, through their own DataFrame API, under the defaults (every join
small enough to broadcast) and under ``autoBroadcastJoinThreshold=0``
with ``join.targetRows=1024`` (the run-time pick: streamed sides and,
where both sides exceed 1024 live rows, the hash sub-partition join).
Results must be equal under ``bench._rows_equal(tol=1e-6)`` with equal
schemas, and each join must report the same strategy metrics as the
JAX package's.  The JAX results are shared through a module-scoped
fixture.
"""

import pytest

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch

SF = 0.002
QUERIES = ("q5", "q10", "q12")
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
    return bench.gen_tpch(SF)


@pytest.fixture(scope="module")
def jax_runs(tables):
    """(query, conf name) -> (result, join strategies) of the JAX
    session."""
    out = {}
    for name, conf in CONFS.items():
        for q in QUERIES:
            df = getattr(bench, q)(JaxSession(dict(conf)), tables)
            out[q, name] = (df.toArrow(), _strategies(df))
    return out


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax(tables, jax_runs, query, conf):
    KN.COUNTERS.reset()
    df = getattr(tpch, query)(TpuSession(dict(CONFS[conf]), device="cpu"),
                              tables)
    got = df.toArrow()
    want, want_strategies = jax_runs[query, conf]
    assert got.num_rows > 0
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == want_strategies
    assert KN.COUNTERS.fallbacks == 0
