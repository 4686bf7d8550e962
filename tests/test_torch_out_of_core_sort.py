"""The port's out-of-core sort against the JAX package's, under a pool
below the sort's working set.

Mirrors the three sort tests of ``tests/test_out_of_core.py``: the
60,000-row table under a 400 KiB pool and ``batchRows`` 8192 (and its
40,000-row and 5,000-row siblings).  Each run equals the JAX package's
row for row and the port's in-core sort under the default pool, and
reports the JAX package's ``outOfCoreSorts``, ``numOutputBatches`` and
``spillToHostBytes`` (above 0 on the 60,000-row table), tree string
and (empty) fallback report.  A descending
sort over string and null keys goes out of core too.  The split under
it (``parallel/shuffle.py::split_to_spillables``) drains its input list,
and its slices keep each bucket's rows in input order.  Each JAX run is
made once per module (``jax_run``).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.parallel.shuffle import split_to_spillables
from spark_rapids_tpu_torch.runtime import memory as M
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


@pytest.fixture(autouse=True)
def _fresh_manager():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    B.clear_scan_cache()


def _sort_table(n=60_000, seed=3):
    """``tests/test_out_of_core.py::_sort_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(-10**6, 10**6, n)),
        "b": pa.array(rng.uniform(-1000, 1000, n)),
    })


def _string_table(n=20_000, seed=8):
    rng = np.random.default_rng(seed)
    s = np.array([f"s{x:03d}" for x in rng.integers(0, 300, n)], object)
    return pa.table({
        "s": pa.array(s, mask=rng.random(n) < 0.05),
        "a": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.05),
        "i": pa.array(np.arange(n)),
    })


def _tight(pool):
    return {"spark.rapids.tpu.memory.poolSize": pool,
            "spark.rapids.tpu.batchRows": 8192}


# name: (table, order-by arguments of a package's ``col``, conf)
CASES = {
    "matches_oracle_and_spills": (
        lambda: _sort_table(), lambda c: ("a", "b"), _tight(400 << 10)),
    "streams_multiple_batches": (
        lambda: _sort_table(40_000, seed=5), lambda c: ("a",),
        _tight(300 << 10)),
    "in_core_with_room": (
        lambda: _sort_table(5000, seed=6), lambda c: ("a",), {}),
    "descending_strings_and_nulls": (
        _string_table,
        lambda c: (c("s").desc(), c("a")),
        _tight(200 << 10)),
}


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _run(session_cls, name, col_fn, mod, basic, conf=None):
    table, keys, case_conf = CASES[name]
    mod.reset_manager()
    basic.clear_scan_cache()
    kw = {} if session_cls is JaxSession else {"device": "cpu"}
    df = session_cls(dict(case_conf if conf is None else conf), **kw) \
        .createDataFrame(table()).orderBy(*keys(col_fn))
    out = df.toArrow()
    sort = _find(df._last_plan, "TpuSortExec")
    return out, {"outOfCoreSorts": sort.metric("outOfCoreSorts").value,
                 "numOutputBatches": sort.metric("numOutputBatches").value,
                 "spillToHostBytes":
                     mod.get_manager().metrics["spillToHostBytes"],
                 "tree": df._last_plan.tree_string(),
                 "report": df._last_override.fallback_report()}


@pytest.fixture(scope="module")
def jax_run():
    from spark_rapids_tpu.sql.column import col as jcol
    memo = {}

    def run(name):
        if name not in memo:
            memo[name] = _run(JaxSession, name, jcol, JM, JB)
            JM.reset_manager()
            JB.clear_scan_cache()
        return memo[name]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_sort_equals_jax_and_in_core(jax_run, name):
    got, metrics = _run(TpuSession, name, col, M, B)
    want, want_metrics = jax_run(name)
    assert got.schema == want.schema
    assert repr(got.to_pylist()) == repr(want.to_pylist())
    assert metrics == want_metrics and metrics["report"] == []
    if CASES[name][2]:
        assert metrics["outOfCoreSorts"] == 1, metrics
        assert metrics["numOutputBatches"] > 1, metrics
        if name == "matches_oracle_and_spills":
            assert metrics["spillToHostBytes"] > 0, metrics
        in_core, plain = _run(TpuSession, name, col, M, B, conf={})
        assert plain["outOfCoreSorts"] == 0
        assert repr(in_core.to_pylist()) == repr(got.to_pylist())
    else:
        assert metrics["outOfCoreSorts"] == 0
        assert metrics["numOutputBatches"] == 1


def test_split_drains_its_input_and_keeps_input_order():
    mgr = M.get_manager()
    t = _sort_table(5000, seed=11)
    batches = [host_to_device(t.slice(lo, 1000), torch.device("cpu"))
               for lo in range(0, 5000, 1000)]
    want = t.column("a").to_numpy()
    listed = batches  # the caller's own reference to the list

    def bucket(b, aux):
        return b.columns[0].data % aux

    slices = split_to_spillables(batches, bucket, 3, mgr, aux=3)
    assert listed == [] and batches is listed
    for i, parts in enumerate(slices):
        assert parts and all(sp.tier == "device" for sp in parts)
        rows = np.concatenate([sp.get().columns[0].data[:sp.live_rows]
                               .numpy() for sp in parts])
        assert rows.tolist() == want[want % 3 == i].tolist()
        for sp in parts:
            sp.close()
    assert mgr._reserved == 0 and not mgr._spillables
