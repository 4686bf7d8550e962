"""TPC-H builders under ``spark.default.parallelism=4`` in the port
against the JAX package: q10, q11, q16, q18,
q20 and q21: string group keys, a subtree used twice, semi and anti
joins.

The rest of the 22 run in ``test_torch_partitions.py`` and
``test_torch_partitions_tpch_{1,2}.py`` (split for the JAX side's
compile time).  Each builder at ``bench.py``'s oracle scale (sf 0.01
for q2, q7 and q11, else 0.002) must equal the JAX package's result
(``bench._rows_equal(tol=1e-6)``) with the same schema, report the
JAX package's join strategy metrics, launch no fallback and equal its
own 1-partition result.
"""

import pytest
import torch

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
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


QUERIES = ('q10', 'q11', 'q16', 'q18', 'q20', 'q21')
CONF = {"spark.default.parallelism": 4}
_STRATEGY = ("streamedJoins", "subPartitionJoins")
_TABLES = {}


def _tables_for(q):
    sf = tpch.ORACLE_SF.get(q, tpch.ORACLE_DEFAULT_SF)
    if sf not in _TABLES:
        _TABLES[sf] = bench.gen_tpch(sf)
    return _TABLES[sf]


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()
    M.reset_manager()


def _strategies(df):
    return [tuple(m.get(k, 0) for k in _STRATEGY)
            for name, m in df.metrics() if name == "TpuSortMergeJoinExec"]


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax_under_parallelism(query):
    tables = _tables_for(query)
    KN.COUNTERS.reset()
    df = tpch.build(query, TpuSession(dict(CONF), device="cpu"), tables)
    got = df.toArrow()
    jdf = bench.TPCH_BUILDERS[query](JaxSession(dict(CONF)), tables)
    want = jdf.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == _strategies(jdf)
    assert KN.COUNTERS.fallbacks == 0
    one = tpch.build(query, TpuSession(device="cpu"), tables).toArrow()
    assert bench._rows_equal(got, one, tol=1e-6)
