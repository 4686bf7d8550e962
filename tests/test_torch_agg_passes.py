"""The port's memory-bounded aggregate passes against the JAX package's:
input coalescing (``spark.rapids.tpu.agg.bucketRows``), the skip-agg
pass (``spark.rapids.sql.agg.skipAggPassReductionRatio``, 0.9 by
default) and the repartitioned merge.

Mirrors ``tests/test_agg_breadth.py::test_merge_explosion_repartition_fallback``
(60,000 unique keys in 4,096-row batches, coalescing at 4,096 rows),
plus the same table in 1,024-row batches that coalesce into 4,096-row
groups, and nearly unique keys (an int key with nulls beside a string
key with nulls; sum, count(*), avg, min and max) at the default ratio
(the first partial keeps more than 0.9 of its rows, so the later
batches skip their reduction) and with skipping off.  Each run goes
through both DataFrame APIs on the same seeded table, on the device
branch (the port's hash rung on ``device="cpu"``, the JAX package's
fused rung) and, for the unique int keys, on the exact ``jnp`` rung of
both.  The port's rows must equal the JAX
package's in order (keys, counts, min and max as the same bits; the
float sums within 1e-12 relative), and ``skippedAggPasses``,
``repartitionMerges`` and the aggregate's output batches must be equal.
Each JAX run is made once per module (``jax_run``).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession

COUNTED = ("skippedAggPasses", "repartitionMerges", "numOutputBatches")


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


def _unique_table(n=60_000):
    """``test_merge_explosion_repartition_fallback``'s table."""
    rng = np.random.default_rng(63)
    return pa.table({"k": pa.array(rng.permutation(n)),
                     "v": pa.array(rng.integers(0, 100, n))})


def _wide_table(n=30_000, n_keys=25_000, seed=5):
    """Nearly unique int keys beside a 3-value string key, both with
    nulls; a nullable double and a long to aggregate."""
    rng = np.random.default_rng(seed)
    null = rng.random((3, n)) < 0.02
    return pa.table({
        "k": pa.array(rng.integers(0, n_keys, n), mask=null[0]),
        "s": pa.array(np.array(["a", "bb", "ccc"], object)[
            rng.integers(0, 3, n)], mask=null[1]),
        "d": pa.array(rng.normal(0, 100, n), mask=null[2]),
        "l": pa.array(rng.integers(-1000, 1000, n)),
    })


TABLES = {"unique": _unique_table(), "wide": _wide_table()}


def _sum_count(s, F, t):
    return (s.createDataFrame(t).groupBy("k")
            .agg(F.sum("v").alias("sv"), F.count("*").alias("c")))


def _wide(s, F, t):
    return (s.createDataFrame(t).groupBy("k", "s")
            .agg(F.sum("d").alias("sd"), F.count("*").alias("c"),
                 F.avg("l").alias("al"),
                 F.min("d").alias("mn"), F.max("l").alias("mx")))


# name: (table, query, conf, (skippedAggPasses, repartitionMerges))
CASES = {
    "merge_explosion": ("unique", _sum_count, {
        "spark.rapids.tpu.batchRows": 4096,
        "spark.rapids.tpu.agg.bucketRows": 4096}, (1, 1)),
    "skip_at_default_ratio": ("wide", _wide, {
        "spark.rapids.tpu.batchRows": 8192}, (1, 1)),
    "skip_off": ("wide", _wide, {
        "spark.rapids.tpu.batchRows": 8192,
        "spark.rapids.sql.agg.skipAggPassReductionRatio": 1.0}, (0, 1)),
    "coalesced": ("unique", _sum_count, {
        "spark.rapids.tpu.batchRows": 1024,
        "spark.rapids.tpu.minBucketRows": 1024,
        "spark.rapids.tpu.agg.bucketRows": 4096}, (1, 1)),
}
BACKENDS = {"device": ("auto", "auto"), "jnp": ("jnp", "jnp")}


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _run(name, backend, port: bool):
    table, query, conf, _ = CASES[name]
    conf = dict(conf, **{"spark.rapids.tpu.kernel.backend":
                         BACKENDS[backend][0 if port else 1]})
    mod, basic = (M, B) if port else (JM, JB)
    mod.reset_manager()
    basic.clear_scan_cache()
    s = TpuSession(conf, device="cpu") if port else JaxSession(conf)
    df = query(s, F if port else JF, TABLES[table])
    out = df.toArrow()
    agg = _find(df._last_plan, "TpuHashAggregateExec")
    return out, {k: agg.metric(k).value for k in COUNTED}, agg


@pytest.fixture(scope="module")
def jax_run():
    memo = {}

    def run(name, backend):
        if (name, backend) not in memo:
            out, counted, _ = _run(name, backend, port=False)
            memo[name, backend] = (out, counted)
            JM.reset_manager()
            JB.clear_scan_cache()
        return memo[name, backend]

    return run


# the float sums (and the average over them) add in another order than
# the JAX package's scans (a segmented reduction in group order): within
# 1e-12 relative; every other column exactly
SUMMED = ("sd", "al")


# every case on the device branch; the exact rung on the two cases of
# the int key, which run all three passes (its compiles over the
# string key cost the JAX side ~9 s a rung)
RUNS = [(name, "device") for name in CASES] + [
    (name, "jnp") for name in ("merge_explosion", "coalesced")]


@pytest.mark.parametrize("name, backend", RUNS)
def test_agg_passes_equal_jax(jax_run, name, backend):
    got, counted, agg = _run(name, backend, port=True)
    want, want_counted = jax_run(name, backend)
    assert got.schema == want.schema
    for f in got.schema.names:
        g, w = got.column(f), want.column(f)
        if f in SUMMED:
            assert _close(g, w), f
        else:
            assert _bits(g) == _bits(w), f
    assert counted == want_counted
    skipped, repartitioned = CASES[name][3]
    assert counted["skippedAggPasses"] == skipped
    assert counted["repartitionMerges"] == repartitioned
    if name == "coalesced":
        assert agg.metric("concatTime").value > 0
    if name == "merge_explosion":
        assert got.num_rows == 60_000
        assert got.column("c").to_pylist() == [1] * 60_000


def _bits(c) -> list:
    """A column's values, floats as their bit patterns (NaN and -0.0
    exact)."""
    vals = c.to_pylist()
    if pa.types.is_floating(c.type):
        vals = [None if v is None else np.float64(v).view(np.uint64).item()
                for v in vals]
    return vals


def _close(g, w) -> bool:
    g, w = g.to_pylist(), w.to_pylist()
    if [x is None for x in g] != [x is None for x in w]:
        return False
    a = np.array([0.0 if x is None else x for x in g], np.float64)
    b = np.array([0.0 if x is None else x for x in w], np.float64)
    return bool(np.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True))
