"""TPC-H q13, q14, q16 and q22 through the port against the JAX package:
the string-pattern queries without a multi-key join (``NOT LIKE`` over
``o_comment`` under a left outer join in q13, ``LIKE`` inside a CASE sum
in q14, ``!=`` and ``NOT LIKE`` on strings with a left anti join and
count(DISTINCT) in q16, ``substring`` and ``isin`` on strings with a
cross join and a left anti join in q22).

Both sessions run ``bench.gen_tpch(0.002)``, ``bench.py``'s oracle
scale, under the defaults and under ``autoBroadcastJoinThreshold=0``
with ``join.targetRows=1024`` (the run-time pick; q13's left join then
hash sub-partitions).  Results must be equal under
``bench._rows_equal(tol=1e-6)`` with equal schemas, each join must take
the JAX package's planned broadcast side and report its strategy
metrics, and no hash collision may fall back.  q22 keeps nobody at this
scale (every customer has about ten orders), so it runs a second time
with ``orders`` cut to its first 10% of rows, where the anti join keeps
customers.
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


SF = 0.002
QUERIES = ("q13", "q14", "q16", "q22")
CONFS = {
    "defaults": {},
    "noBroadcast": {"spark.sql.autoBroadcastJoinThreshold": 0,
                    "spark.rapids.tpu.join.targetRows": 1024},
}
_STRATEGY = ("streamedJoins", "subPartitionJoins")


def _strategies(df):
    """Each join's planned node (type and broadcast side) and run-time
    strategy metrics, root first."""
    nodes = [l.strip() for l in df._last_plan.tree_string().splitlines()
             if "TpuSortMergeJoin" in l]
    return nodes, [tuple(m.get(k, 0) for k in _STRATEGY)
                   for name, m in df.metrics()
                   if name == "TpuSortMergeJoinExec"]


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


@pytest.fixture(scope="module")
def few_orders(tables):
    """The tables with ``orders`` cut to its first 10% of rows."""
    t = dict(tables)
    t["orders"] = t["orders"].slice(0, t["orders"].num_rows // 10)
    return t


def _jax_run(query, conf, t):
    df = getattr(bench, query)(JaxSession(dict(conf)), t)
    return df.toArrow(), _strategies(df)


@pytest.fixture(scope="module")
def jax_runs(tables, few_orders):
    """(query, conf name) -> (result, join strategies) of the JAX
    session; ``q22_few_orders`` runs on ``few_orders``."""
    out = {}
    for name, conf in CONFS.items():
        for q in QUERIES:
            out[q, name] = _jax_run(q, conf, tables)
        out["q22_few_orders", name] = _jax_run("q22", conf, few_orders)
    return out


def _check(query, conf, t, want, want_strategies):
    KN.COUNTERS.reset()
    df = getattr(tpch, query)(TpuSession(dict(CONFS[conf]), device="cpu"),
                              t)
    got = df.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == want_strategies
    assert KN.COUNTERS.fallbacks == 0
    return got


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax(tables, jax_runs, query, conf):
    got = _check(query, conf, tables, *jax_runs[query, conf])
    # q22's anti join keeps nobody at this scale in both packages
    assert got.num_rows > 0 or query == "q22"


@pytest.mark.parametrize("conf", list(CONFS))
def test_q22_with_rows_matches_jax(few_orders, jax_runs, conf):
    got = _check("q22", conf, few_orders, *jax_runs["q22_few_orders", conf])
    assert got.num_rows > 0
