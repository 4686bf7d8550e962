"""Dynamic partition pruning in the port against the JAX package.

The five DPP cases of ``tests/test_aqe_dpp.py`` over a fact table
hive-partitioned into ten ``part`` directories (written by the port's
``df.write.partitionBy``) joined to a two-row dimension: an inner join
prunes the eight other partitions' files; a grouped sum over the join
equals on the device and the host sessions; with
``spark.sql.optimizer.dynamicPartitionPruning.enabled=false`` nothing is
pruned and the rows are equal; a left join prunes nothing of its left
side; a projection between the scan and the join does not stop the
pruning.  Each runs on the port (``device="cpu"``, under
``spark.rapids.sql.test.enabled``: the subquery's host drain is no
fallback) and on the JAX package over the same files: rows (by
``repr``), tree strings, fallback reports and the scans'
``dppPrunedFiles`` equal.  The optimizer rule attaches the same
subquery column to the same relation in both packages, and skips a
build side over the broadcast threshold.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan.optimizer import optimize as joptimize
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.optimizer import optimize
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ensure_initialized()
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
OFF = dict(TEST, **{"spark.sql.optimizer.dynamicPartitionPruning.enabled":
                    False})


@pytest.fixture(scope="module")
def fact_dir(tmp_path_factory):
    n = 2000
    t = pa.table({
        "part": pa.array((np.arange(n) % 10).astype(np.int64)),
        "x": pa.array(np.arange(n, dtype=np.int64)),
    })
    out = str(tmp_path_factory.mktemp("dpp") / "fact")
    TpuSession(dict(HOST), device="cpu").createDataFrame(t).write \
        .partitionBy("part").parquet(out)
    return out


def _dim(s):
    return s.createDataFrame(pa.table({
        "part": pa.array([2, 5], type=pa.int64()),
        "name": pa.array(["two", "five"]),
    }))


# name: (build(session, F, fact dir), conf, ordered, rows, pruned files)
CASES = {
    "prunes_files": (
        lambda s, F, f: s.read.parquet(f).join(_dim(s), on="part",
                                               how="inner"),
        TEST, False, 400, 8),
    "oracle_equality": (
        lambda s, F, f: s.read.parquet(f).join(_dim(s), on="part")
        .groupBy("name").agg(F.sum("x").alias("sx")), TEST, False, 2, 8),
    "disabled": (
        lambda s, F, f: s.read.parquet(f).join(_dim(s), on="part",
                                               how="inner"),
        OFF, False, 400, 0),
    "left_join_prunes_right_only": (
        lambda s, F, f: s.read.parquet(f).join(_dim(s), on="part",
                                               how="left"),
        TEST, False, 2000, 0),
    "survives_column_pruning": (
        lambda s, F, f: s.read.parquet(f).select("part", "x")
        .join(_dim(s), on="part", how="inner"), TEST, False, 400, 8),
}


def _pruned(plan) -> int:
    """``dppPrunedFiles`` of the plan's file scans, summed."""
    total = 0

    def walk(node):
        nonlocal total
        if type(node).__name__ in ("TpuParquetScanExec",
                                   "CpuParquetScanExec"):
            m = node.metrics.get("dppPrunedFiles")
            total += 0 if m is None else m.value
        for c in node.children:
            walk(c)

    walk(plan)
    return total


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    assert got.schema == want.schema
    g = [repr(r) for r in got.to_pylist()]
    w = [repr(r) for r in want.to_pylist()]
    if not ordered:
        g, w = sorted(g), sorted(w)
    assert g == w


@pytest.mark.parametrize("name", list(CASES))
def test_dpp_equals_jax(fact_dir, name):
    build, conf, ordered, rows, pruned = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, fact_dir)
    jdf = build(JaxSession(dict(conf)), JF, fact_dir)
    got, want = df.toArrow(), jdf.toArrow()
    same_rows(got, want, ordered)
    assert got.num_rows == rows
    assert _pruned(df._last_plan) == _pruned(jdf._last_plan) == pruned
    assert (df._last_override.fallback_report()
            == jdf._last_override.fallback_report() == [])
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    if name == "left_join_prunes_right_only":
        assert sum(v is not None for v in got.column("name")
                   .to_pylist()) == 400
    # the host session prunes the same files to the same rows
    host = build(TpuSession(dict(conf, **HOST), device="cpu"), F, fact_dir)
    same_rows(host.toArrow(), want, ordered)
    assert _pruned(host._last_plan) == pruned


def _dpp_of(plan):
    """(side, partition column) of each relation carrying a DPP
    subquery in a logical plan."""
    out = []

    def walk(node, side):
        if type(node).__name__ == "ParquetRelation" and node.dpp is not None:
            out.append((side, node.dpp[1]))
        if type(node).__name__ == "Join":
            walk(node.left, "left")
            walk(node.right, "right")
            return
        for c in node.children:
            walk(c, side)

    walk(plan, None)
    return out


@pytest.mark.parametrize("how, threshold", [
    ("inner", None), ("right", None), ("left_semi", None),
    ("left", None), ("inner", 1)])
def test_rule_attaches_as_jax(fact_dir, how, threshold):
    """Which side carries the subquery, per join type and with the build
    side over the broadcast threshold (none), equal to the JAX
    optimizer's; the port's subquery plans the dimension's key."""
    conf = {} if threshold is None else {
        "spark.sql.autoBroadcastJoinThreshold": threshold}
    s, js = (TpuSession(dict(conf), device="cpu"), JaxSession(dict(conf)))
    plans = []
    for sess, opt in ((s, optimize), (js, joptimize)):
        df = sess.read.parquet(fact_dir).join(_dim(sess), on="part",
                                              how=how)
        plans.append(opt(df._plan, sess.rapids_conf()))
    got = _dpp_of(plans[0])
    assert got == _dpp_of(plans[1])
    want = ({"inner": [("left", "part")], "right": [("left", "part")],
             "left_semi": [("left", "part")], "left": []}[how]
            if threshold is None else [])
    assert got == want
    if got:
        rel = [n for n in _walk(plans[0])
               if isinstance(n, L.ParquetRelation)][0]
        sub = rel.dpp[0]
        assert isinstance(sub, L.Project)
        assert [f.name for f in sub.schema.fields] == ["_dpp_key"]
    assert C.DPP_ENABLED.key in C.REGISTRY


def _walk(node):
    out = [node]
    for c in node.children:
        out.extend(_walk(c))
    return out


def test_subquery_drains_once_under_concurrent_partitions(fact_dir):
    """The scan's partitions may pump on several threads: the DPP keep
    set is computed once under its lock, and ``dppPrunedFiles`` counts
    the pruned files once, however many threads ask at the same time."""
    import sys
    import threading
    from spark_rapids_tpu_torch.io import parquet as PQ
    from spark_rapids_tpu_torch.plan.planner import plan_physical
    s = TpuSession(dict(TEST), device="cpu")
    plan = optimize(s.read.parquet(fact_dir).join(_dim(s), on="part")._plan,
                    s.rapids_conf())
    (rel,) = [n for n in _walk(plan) if isinstance(n, L.ParquetRelation)]
    scan = PQ.CpuParquetScanExec(rel, s.rapids_conf())
    drains = []
    real = plan_physical

    def counting(node, conf):
        if node is rel.dpp[0]:  # the subquery's root, not its children
            drains.append(1)
        return real(node, conf)

    import spark_rapids_tpu_torch.plan.planner as P
    got, errors = [], []

    def ask():
        try:
            got.append(scan._dpp_keep())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    P.plan_physical = counting
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        P.plan_physical = real
    assert not errors
    assert len(drains) == 1 and len(got) == 16
    assert all(k == got[0] for k in got) and len(got[0]) == 2
    assert scan.metrics["dppPrunedFiles"].value == 8
