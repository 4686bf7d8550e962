"""TPC-H q7 and q8 through the port against the JAX package: the
queries over renamed copies of one table (``withColumnRenamed``), with
``isin``, ``year``, ``when(...).otherwise(...)`` and a division.

Both sessions run ``bench.gen_tpch`` at ``bench.py``'s oracle scale
(sf 0.002 for q8; 0.01 for q7, whose filters leave nothing at 0.002) through
their own DataFrame API, under the defaults and under
``autoBroadcastJoinThreshold=0`` with ``join.targetRows=1024``.
Results must be equal under ``bench._rows_equal(tol=1e-6)`` with equal
schemas, and each join must report the JAX package's strategy metrics.
"""

import pytest
import torch

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
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


QUERIES = {"q7": 0.01, "q8": 0.002}  # query -> scale
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
    return {sf: bench.gen_tpch(sf) for sf in set(QUERIES.values())}


@pytest.fixture(scope="module")
def jax_runs(tables):
    """(query, conf name) -> (result, join strategies) of the JAX
    session."""
    out = {}
    for name, conf in CONFS.items():
        for q, sf in QUERIES.items():
            df = getattr(bench, q)(JaxSession(dict(conf)), tables[sf])
            out[q, name] = (df.toArrow(), _strategies(df))
    return out


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_jax(tables, jax_runs, query, conf):
    KN.COUNTERS.reset()
    df = getattr(tpch, query)(TpuSession(dict(CONFS[conf]), device="cpu"),
                              tables[QUERIES[query]])
    got = df.toArrow()
    want, want_strategies = jax_runs[query, conf]
    assert got.num_rows > 0
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == want_strategies
    assert KN.COUNTERS.fallbacks == 0
