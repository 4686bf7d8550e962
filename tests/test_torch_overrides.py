"""The port's plan rewrite (``plan/overrides.py``) against the JAX
package's ``apply_overrides`` on the same queries.

* Under the defaults, every TPC-H builder's ``fallback_summary()``
  equals the JAX package's (0 fallback operators; the port's q6
  transcribes ``bench.q6``, the headline q6 over lineitem, so it is held
  to that builder rather than to ``bench.q6_sf``).
* Under each per-operator kill switch (``spark.rapids.sql.exec.<Name>``,
  ``spark.rapids.sql.expression.<Name>``), on a query holding that node,
  ``fallback_report()`` equals the JAX package's line for line, and the
  result equals the JAX package's under the same conf and the port's
  all-device result (``bench._rows_equal(tol=1e-6)``).
* Under ``spark.sql.ansi.enabled=true`` the same holds for q1 and q6
  (arithmetic and sums on the CPU; the results still wrap).
* ``spark.rapids.sql.test.enabled`` raises the JAX package's
  ``AssertionError``; ``test.allowedNonGpu`` lets the named exec through
  (by class or rule name); ``explain(True)`` prints the JAX package's
  report lines; a CPU session (``spark.rapids.sql.enabled=false``)
  plans no device exec and touches no device.
* Mirrors of the JAX package's ``test_conf_truth.py`` coalesce tests: a
  TargetSize coalesce above every host-to-device transition, small
  batches merged up to the target (row-capped at ``batchRows``), and
  the single batch under the sort.

The JAX side plans only where reports are compared and runs (on the
CPU platform) where results are compared, at ``bench.py``'s oracle
scale, sf 0.002.
"""

import contextlib
import io

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
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


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()
    M.reset_manager()


def jax_builder(q):
    """The JAX package's builder the port's ``tpch.<q>`` transcribes."""
    if q == "q6":
        return lambda s, t: bench.q6(s, t["lineitem"])
    return bench.TPCH_BUILDERS[q]


@pytest.mark.parametrize("q", tpch.QUERIES)
def test_fallback_summary_equals_jax_under_the_defaults(tables, q):
    got = tpch.build(q, TpuSession(device="cpu"), tables).fallback_summary()
    want = jax_builder(q)(JaxSession(), tables).fallback_summary()
    assert got == want
    assert got["fallback_ops"] == 0 and got["device_ops"] > 0


KILL_SWITCHES = [
    ("q6", "exec", "InMemoryScan"),
    ("q3", "exec", "Project"),
    ("q6", "exec", "Filter"),
    ("q1", "exec", "HashAggregate"),
    ("q1", "exec", "Sort"),
    ("q3", "exec", "SortMergeJoin"),
    ("q3", "exec", "TakeOrderedAndProject"),
    ("q22", "expression", "Substring"),
    ("q13", "expression", "Like"),
]


@pytest.mark.parametrize("q, kind, name", KILL_SWITCHES,
                         ids=[f"{k}.{n}" for _, k, n in KILL_SWITCHES])
def test_kill_switch_report_and_result_equal_jax(tables, q, kind, name):
    conf = {f"spark.rapids.sql.{kind}.{name}": False}
    df = tpch.build(q, TpuSession(dict(conf), device="cpu"), tables)
    got = df.toArrow()
    report = df._last_override.fallback_report()
    jdf = jax_builder(q)(JaxSession(dict(conf)), tables)
    want = jdf.toArrow()
    assert report == jdf._last_override.fallback_report()
    assert report and all(f"spark.rapids.sql.{kind}.{name}=false" in line
                          for line in report)
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    device = tpch.build(q, TpuSession(device="cpu"), tables).toArrow()
    assert bench._rows_equal(got, device, tol=1e-6)
    # the fallen operator is a CPU exec between transitions
    assert "DeviceToHostExec" in df._last_plan.tree_string()


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_ansi_report_and_result_equal_jax(tables, q):
    """``spark.sql.ansi.enabled=true`` keeps the arithmetic and the sums
    on the CPU with the JAX package's reasons; the CPU path is non-ANSI
    too, so the result is the all-device one."""
    conf = {"spark.sql.ansi.enabled": True}
    df = tpch.build(q, TpuSession(dict(conf), device="cpu"), tables)
    got = df.toArrow()
    report = df._last_override.fallback_report()
    jdf = jax_builder(q)(JaxSession(dict(conf)), tables)
    want = jdf.toArrow()
    assert report == jdf._last_override.fallback_report()
    assert any("spark.sql.ansi.enabled=true" in line for line in report)
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    device = tpch.build(q, TpuSession(device="cpu"), tables).toArrow()
    assert bench._rows_equal(got, device, tol=1e-6)


def test_test_mode_raises_the_jax_message(tables):
    conf = {"spark.rapids.sql.exec.Sort": False,
            "spark.rapids.sql.test.enabled": True}
    with pytest.raises(AssertionError) as got:
        tpch.build("q1", TpuSession(dict(conf), device="cpu"),
                   tables).toArrow()
    with pytest.raises(AssertionError) as want:
        jax_builder("q1")(JaxSession(dict(conf)), tables).toArrow()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(
        "Part of the plan is not columnar (TPU test mode): ")


@pytest.mark.parametrize("allowed", ["CpuSortExec", "Sort",
                                     "CpuProjectExec, Sort"])
def test_allowed_non_gpu_lets_the_named_exec_through(tables, allowed):
    conf = {"spark.rapids.sql.exec.Sort": False,
            "spark.rapids.sql.test.enabled": True,
            "spark.rapids.sql.test.allowedNonGpu": allowed}
    df = tpch.build("q1", TpuSession(dict(conf), device="cpu"), tables)
    got = df.toArrow()
    assert df.fallback_summary()["fallback_ops"] == 1
    jdf = jax_builder("q1")(JaxSession(dict(conf)), tables)
    assert jdf.fallback_summary() == df.fallback_summary()
    assert got.equals(tpch.build("q1", TpuSession(device="cpu"),
                                 tables).toArrow())


def test_explain_prints_the_jax_report(tables):
    conf = {"spark.rapids.sql.expression.Substring": False}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tpch.build("q22", TpuSession(dict(conf), device="cpu"),
                   tables).explain(True)
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jax_builder("q22")(JaxSession(dict(conf)), tables).explain(True)

    def report(text):
        return [l for l in text.splitlines() if l.startswith("!Exec")]

    assert report(buf.getvalue()) == report(jbuf.getvalue())
    assert len(report(buf.getvalue())) == 2
    tree = buf.getvalue().splitlines()
    assert tree[0] == "DeviceToHostExec"
    assert any(l.strip().startswith("Project [") for l in tree)


def test_explain_mode_all_prints_the_rewrite(tables, capsys):
    conf = {"spark.rapids.sql.explain": "ALL",
            "spark.rapids.sql.exec.Sort": False}
    tpch.build("q1", TpuSession(dict(conf), device="cpu"),
               tables).toArrow()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "TPU plan rewrite:"
    assert out[1] == ("  !Exec <CpuSortExec> cannot run on TPU because "
                      "exec Sort disabled by "
                      "spark.rapids.sql.exec.Sort=false")
    assert out[2] == "Sort [input[0], input[1]]"


def test_cpu_session_plans_no_device_exec_and_touches_no_device(
        tables, monkeypatch):
    """``sql.enabled=false`` keeps the CPU plan: no TpuExec, no arbiter,
    nothing placed on the session's device — even a "cuda" session on a
    machine whose torch cannot allocate there runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    session = TpuSession({"spark.rapids.sql.enabled": False},
                         device="cuda")
    assert session.device.type == "cuda"
    M.reset_manager()
    for q in ("q1", "q3", "q13", "q22"):
        df = tpch.build(q, session, tables)
        got = df.toArrow()

        def walk(node):
            assert not isinstance(node, TpuExec), node.name
            for c in node.children:
                walk(c)

        walk(df._last_plan)
        assert df.fallback_summary() == {
            "device_ops": 0, "fallback_ops": 0, "device_fraction": 0.0,
            "fallback_reasons": []}
        want = jax_builder(q)(JaxSession({"spark.rapids.sql.enabled":
                                          False}), tables).toArrow()
        assert got.equals(want)
    assert M.peek_manager() is None


# ---------------------------------------------------------------------------
# the coalesce pass (mirrors of the JAX package's test_conf_truth.py)
# ---------------------------------------------------------------------------

def _table(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(0, 50, n)),
        "b": pa.array(rng.uniform(-10, 10, n)),
        "s": pa.array([f"row{i % 97}" for i in range(n)]),
    })


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        got = _find(c, name)
        if got is not None:
            return got
    return None


def test_coalesce_inserted_above_h2d():
    t = _table(2000)
    s = TpuSession({"spark.rapids.sql.exec.InMemoryScan": False},
                   device="cpu")
    df = s.createDataFrame(t).select((F.col("a") + 1).alias("a1"))
    tree = df._execute_plan().tree_string()
    assert "TpuCoalesceBatches [target=" in tree, tree
    co = _find(df._last_override.plan, "TpuCoalesceBatchesExec")
    assert type(co.children[0]).__name__ == "HostToDeviceExec"
    out = df.toArrow()
    assert out.column("a1").to_pylist() == [
        v + 1 for v in t.column("a").to_pylist()]


def test_coalesce_merges_small_batches():
    """The H2D coalesce merges sub-batchRows batches up to its target;
    the plan-level target is row-capped at batchRows (a 512 MB byte
    target must not override it)."""

    class _Feed(TpuExec):
        def __init__(self, batches):
            super().__init__(batches[0].schema)
            self._batches = batches

        def execute(self, p):
            yield from self._batches

    small = [host_to_device(pa.table({"a": list(range(i * 256,
                                                      (i + 1) * 256))}),
                            torch.device("cpu"), min_bucket=8)
             for i in range(20)]
    co = B.TpuCoalesceBatchesExec(_Feed(small), target_rows=4096)
    outs = list(co.execute(0))
    assert len(outs) < 5
    assert sum(b.num_rows_host() for b in outs) == 20 * 256
    assert torch.cat([b.columns[0].data[:b.num_rows_host()]
                      for b in outs]).tolist() == list(range(20 * 256))

    t = _table(5000)
    s = TpuSession({"spark.rapids.sql.exec.InMemoryScan": False,
                    "spark.rapids.tpu.batchRows": 256}, device="cpu")
    df = s.createDataFrame(t).select((F.col("a") * 2).alias("a2"))
    co2 = _find(df._execute_plan(), "TpuCoalesceBatchesExec")
    assert co2 is not None and co2.target_rows <= 256
    out = df.toArrow()
    assert out.column("a2").to_pylist() == [
        v * 2 for v in t.column("a").to_pylist()]


def test_coalesce_single_batch_under_sort():
    """The sort's single-partition child gets a plan-visible
    RequireSingleBatch coalesce (multi-batch scan -> one sorted batch)."""
    t = _table(3000)
    s = TpuSession({"spark.rapids.tpu.batchRows": 1024}, device="cpu")
    df = s.createDataFrame(t).orderBy(F.col("b"))
    plan = df._execute_plan()
    sort = _find(plan, "TpuSortExec")
    (co,) = sort.children
    assert type(co).__name__ == "TpuCoalesceBatchesExec"
    assert co.require_single
    out = df.toArrow()
    assert out.column("b").to_pylist() == sorted(t.column("b").to_pylist())
    assert [m["numOutputBatches"] for name, m in df.metrics()
            if name == "TpuCoalesceBatchesExec"] == [1]
