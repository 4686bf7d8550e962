"""The port's OOM retry through its DataFrame API against the JAX
package's, on the same seeded tables and the same confs.

Mirrors ``tests/test_memory.py::test_injected_oom_forces_retry_results_match``
and ``test_tiny_budget_forces_spill_results_match`` (a grouped sum and
count over 4,000 rows: an OOM injected at the aggregate's first
reservation, and a pool of 1.5 scan batches) and
``tests/test_out_of_core.py::test_sub_partitioned_join_spills_and_counts``
(40,000 x 20,000 rows under a 500 KiB pool: one sub-partition join whose
slices spill).  Beside them: the same aggregate under a pool below one
scan batch (each partial's reservation splits its batch in half), and a
keyless aggregate under an injected OOM (its single-batch path falls
through to the retried two-phase path).  Each run's rows must equal the
JAX package's in order, and its arbiter metrics (``retryOOMs``,
``splitRetries``, spilled and restored bytes) and the named operator
metrics must be the JAX package's.  Each JAX run is made once per
module (``jax_run``).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.column import host_to_device as jax_h2d
from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.utils.harness import tpu_session

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession

ARBITER = ("retryOOMs", "splitRetries", "spillToHostBytes",
           "spillToDiskBytes", "restoredBytes")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The batches are small: torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_managers():
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()
    yield
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()


def _agg_table(n=4000):
    """``tests/test_memory.py::_table``."""
    rng = np.random.default_rng(7)
    return pa.table({
        "k": pa.array(rng.integers(0, 23, n).astype(np.int32)),
        "v": pa.array(rng.integers(-100, 100, n)),
    })


def _join_tables(n=40_000, m=20_000, seed=11):
    """``tests/test_out_of_core.py::_join_tables``."""
    rng = np.random.default_rng(seed)
    left = pa.table({
        "k": pa.array(rng.integers(0, 5000, n)),
        "v": pa.array(rng.uniform(-10, 10, n)),
    })
    right = pa.table({
        "k": pa.array(rng.integers(0, 6000, m)),
        "w": pa.array(rng.integers(-100, 100, m)),
    })
    return left, right


AGG_T = _agg_table()
JOIN_T = _join_tables()
BATCH_BYTES = jax_h2d(AGG_T).nbytes()


def _grouped(s, F):
    return (s.createDataFrame(AGG_T).groupBy("k")
            .agg(F.sum("v").alias("sv"), F.count("*").alias("c")))


def _keyless(s, F):
    return s.createDataFrame(AGG_T).agg(F.sum("v").alias("sv"),
                                        F.count("*").alias("c"))


def _join(s, F):
    return s.createDataFrame(JOIN_T[0]).join(s.createDataFrame(JOIN_T[1]),
                                             "k", "inner")


# name: (query, conf, operator, its metrics, what must be above 0)
CASES = {
    # allocation 2 is the aggregate's first reservation (1 is the scan
    # batch's registration)
    "injected_oom": (_grouped, {"spark.rapids.tpu.test.injectOomAtAlloc": 2},
                     "TpuHashAggregateExec", (), ("retryOOMs",)),
    # room for ~1.5 scan batches: the aggregate's reservation evicts the
    # scan cache entry
    "tiny_budget": (_grouped, {
        "spark.rapids.tpu.memory.poolSize": int(BATCH_BYTES * 1.5),
        "spark.rapids.tpu.batchRows": 4000},
        "TpuHashAggregateExec", (), ("spillToHostBytes",)),
    # below one scan batch: the scan streams uncached, and each partial's
    # reservation raises SplitAndRetryOOM, which halves its batch
    "split_retry": (_grouped, {
        "spark.rapids.tpu.memory.poolSize": int(BATCH_BYTES * 0.75),
        "spark.rapids.tpu.batchRows": 4000},
        "TpuHashAggregateExec", (), ("splitRetries", "retryOOMs")),
    "keyless_injected": (_keyless, {
        "spark.rapids.tpu.test.injectOomAtAlloc": 2},
        "TpuHashAggregateExec", (), ("retryOOMs",)),
    "sub_partition_join": (_join, {
        "spark.rapids.tpu.memory.poolSize": 500 << 10,
        "spark.sql.autoBroadcastJoinThreshold": 0,
        "spark.rapids.tpu.batchRows": 8192},
        "TpuSortMergeJoinExec", ("subPartitionJoins",),
        ("spillToHostBytes",)),
}


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _run(name, port: bool):
    query, conf, op, op_metrics, _ = CASES[name]
    mod, basic = (M, B) if port else (JM, JB)
    mod.reset_manager()
    basic.clear_scan_cache()
    if port:
        s = TpuSession(dict(conf, **{"spark.rapids.sql.test.enabled": True}),
                       device="cpu")
    else:
        s = tpu_session(dict(conf))
    df = query(s, F if port else JF)
    out = df.toArrow()
    node = _find(df._last_plan, op)
    mgr = mod.get_manager()
    return out, {"arbiter": {k: mgr.metrics[k] for k in ARBITER},
                 "op": {k: node.metric(k).value for k in op_metrics},
                 "budget": mgr.budget}


@pytest.fixture(scope="module")
def jax_run():
    memo = {}

    def run(name):
        if name not in memo:
            memo[name] = _run(name, port=False)
            JM.reset_manager()
            JB.clear_scan_cache()
        return memo[name]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_retry_equals_jax(jax_run, name):
    got, metrics = _run(name, port=True)
    want, want_metrics = jax_run(name)
    assert got.schema == want.schema
    assert repr(got.to_pylist()) == repr(want.to_pylist())
    assert metrics == want_metrics
    for k in CASES[name][4]:
        assert metrics["arbiter"][k] > 0, metrics
    if name == "split_retry":
        # one split per scan batch at least
        assert metrics["arbiter"]["splitRetries"] >= -(-AGG_T.num_rows
                                                       // 4000)
    if name == "sub_partition_join":
        assert metrics["op"]["subPartitionJoins"] == 1
        assert got.num_rows > 0
