"""The port's whole slice against the JAX package: TPC-H q1 and q6.

Both sessions run the same ``bench.gen_tpch(0.002)`` tables through their
own DataFrame API; results must be equal under ``bench._rows_equal``
(keys and counts exact, floats within a relative 1e-9).  The JAX runs
are shared through module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
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


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


@pytest.fixture(scope="module")
def jax_results(tables):
    s = JaxSession({})
    return {"q1": bench.q1(s, tables).toArrow(),
            "q6": bench.q6(s, tables["lineitem"]).toArrow()}


def test_gen_lineitem_equals_bench(tables):
    li = tpch.gen_lineitem(SF)
    ref = tables["lineitem"]
    assert li.column_names == ref.column_names
    for name in ref.column_names:
        assert li.column(name).equals(ref.column(name)), name


@pytest.mark.parametrize("batch_rows", [1 << 20, 4096])
@pytest.mark.parametrize("backend", ["auto", "cuda", "jnp"])
@pytest.mark.parametrize("query", ["q1", "q6"])
def test_query_matches_jax(tables, jax_results, query, backend,
                           batch_rows):
    s = TpuSession({"spark.rapids.tpu.kernel.backend": backend,
                    "spark.rapids.tpu.batchRows": batch_rows},
                   device="cpu")
    li = tables["lineitem"]
    KN.COUNTERS.reset()
    launches = CB.launches
    got = getattr(tpch, query)(s, li).toArrow()
    assert got.column_names == jax_results[query].column_names
    assert got.schema == jax_results[query].schema
    assert bench._rows_equal(got, jax_results[query])
    # CPU tensors never launch the kernel: the wrapper ran its plain twin
    assert CB.launches == launches
    n_batches = -(-li.num_rows // batch_rows)
    if query == "q1":
        rung = "jnp" if backend == "jnp" else "cuda"
        # one group layout per input batch plus one for the merge
        assert KN.COUNTERS.dispatches[rung] == n_batches + 1
        assert KN.COUNTERS.fallbacks == 0
    else:
        assert KN.COUNTERS.dispatches == {"cuda": 0, "jnp": 0}
    KN.COUNTERS.reset()


def test_q1_plan_shape(tables):
    s = TpuSession(device="cpu")
    plan = tpch.q1(s, tables["lineitem"])._execute_plan()
    lines = plan.tree_string().splitlines()
    assert [l.strip().split(" ")[0] for l in lines] == [
        "DeviceToHostExec", "*TpuSort", "*TpuCoalesceBatches",
        "*TpuHashAggregate", "*TpuFilter", "*TpuProject", "*TpuScanExec"]
    # the scan moves only the 7 referenced lineitem columns
    assert len(plan.children[0].children[0].children[0].children[0]
               .children[0].children[0].schema.fields) == 7


def test_collect_rows(tables, jax_results):
    rows = tpch.q1(TpuSession(device="cpu"), tables["lineitem"]).collect()
    ref = jax_results["q1"].to_pylist()
    assert [r.l_returnflag for r in rows] == [r["l_returnflag"]
                                              for r in ref]
    assert [r.cnt for r in rows] == [r["cnt"] for r in ref]
    assert np.isclose(sum(r.sum_qty for r in rows),
                      sum(r["sum_qty"] for r in ref), rtol=1e-9)


def test_profile_query_runs_and_unions_intervals(tables):
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.utils import device_profile as PR
    clear_scan_cache()  # the first run stages its scans
    out = PR.profile_query(TpuSession(device="cpu"), "q1", tables)
    assert out["rows"] == tables["lineitem"].num_rows
    assert out["traced_wall_s"] > 0 and out["h2d_s"] > 0
    assert out["device_busy_s"] is None  # no card: not measured
    # the next run reads them from the scan cache
    assert PR.profile_query(TpuSession(device="cpu"), "q1",
                            tables)["h2d_s"] == 0
    clear_scan_cache()
    assert PR._busy_us([(5, 6), (0, 2), (1, 3), (3, 3)]) == 4


def test_profile_kernel_sees_no_kernel_on_the_cpu():
    from spark_rapids_tpu_torch.utils import device_profile as PR
    out = PR.profile_kernel(3, 1024, torch.device("cpu"), iters=2)
    # a CPU tensor takes the plain version: no kernel, nothing measured
    assert out["cold_launches"] == out["warm_launches"] == 0
    assert out["cold_median_ms"] is None and out["warm_median_ms"] is None


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_empty_input_matches_jax(tables, query):
    li = tables["lineitem"].slice(0, 0)
    got = getattr(tpch, query)(TpuSession(device="cpu"), li).toArrow()
    ref = getattr(bench, query)(
        JaxSession({}), {"lineitem": li} if query == "q1" else li
    ).toArrow()
    assert got.schema == ref.schema
    assert bench._rows_equal(got, ref)
    assert got.num_rows == (1 if query == "q6" else 0)
