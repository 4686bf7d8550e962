"""Multi-executor engine end to end: two OS processes run the SAME
queries through the public DataFrame API, and their ICI exchanges
rendezvous into one collective over a gloo process group
(``tests/test_multiproc_engine.py``'s four cases and
``tests/test_stats.py``'s cluster-wide merge).

2 processes x 2 virtual CPU ranks = a 4-rank mesh.  Each process
computes its executor slice; the union of the slices equals the JAX
package's single-process ICI run on the same rows (its eight virtual
CPU devices) or its CPU oracle.  The two processes are spawned once per
module and run every query in one sequence (as every executor must),
then the ``rendezvous`` (one transient fault: both retry at epoch 1,
equal result) and ``peer_loss`` (the victim dies; the survivor raises a
peer-tagged terminal error within about one lease) domains.

ROADMAP C.10: the JAX package's
``test_multiprocess_exchange_merges_cluster_wide_counts`` expects its
grouped sum's exchange to count the 20,000 input rows; that exchange
sits above the partial aggregate, so it counts the partial aggregates'
rows (2138: the distinct keys of each of the eight scan partitions).
The port holds the merge to the test's own contract on an exchange that
takes the input rows (the window's), and pins the partial count on the
grouped sum; ``test_jax_exchange_counts_partial_aggregate_rows`` shows
the JAX package recording the same 2138 on its single-process run.

The spawned workers re-import this module: JAX is imported only inside
the test functions and fixtures.
"""

import multiprocessing as mp
import socket
import traceback

import numpy as np
import pyarrow as pa
import pytest
import torch

LEASE_MS = 1000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agg_table() -> pa.Table:
    rng = np.random.default_rng(5)
    n = 30_000
    return pa.table({"k": pa.array(rng.integers(0, 200, n)),
                     "v": pa.array(rng.integers(-1000, 1000, n))})


def _join_tables():
    rng = np.random.default_rng(6)
    n, m = 20_000, 4_000
    left = pa.table({"k": pa.array(rng.integers(0, 2000, n)),
                     "v": pa.array(rng.integers(0, 10_000, n))})
    right = pa.table({"k": pa.array(rng.integers(0, 2500, m)),
                      "w": pa.array(rng.integers(-50, 50, m))})
    return left, right


def _ordered_table() -> pa.Table:
    rng = np.random.default_rng(9)
    n = 12_000
    return pa.table({"k": pa.array(rng.integers(0, 50, n)),
                     "u": pa.array(rng.permutation(n)),
                     "v": pa.array(rng.integers(-100, 100, n))})


def _stats_table() -> pa.Table:
    rng = np.random.default_rng(5)
    n = 20_000
    # hot-headed key: one hash partition dominates cluster-wide
    k = np.where(rng.random(n) < 0.85, 7, rng.integers(0, 500, n))
    return pa.table({"k": pa.array(k),
                     "v": pa.array(rng.integers(-100, 100, n))})


def _queries(F, col, Window):
    """name -> builder(session): the same sequence in every process."""
    t = _ordered_table()
    left, right = _join_tables()
    return {
        "agg": lambda s: s.createDataFrame(_agg_table()).groupBy("k").agg(
            F.sum("v").alias("sv"), F.count("*").alias("c")),
        "join": lambda s: s.createDataFrame(left).join(
            s.createDataFrame(right), "k", "inner"),
        "sort": lambda s: s.createDataFrame(t).orderBy("k", "u"),
        "window": lambda s: s.createDataFrame(t).select(
            col("k"), col("u"), F.row_number().over(
                Window.partitionBy("k").orderBy("u")).alias("rn")),
        "topn": lambda s: s.createDataFrame(t).orderBy(
            col("u").desc()).limit(7),
        "limit": lambda s: s.createDataFrame(t).limit(11),
    }


def _conf(pid, nprocs, port, rdv_addr, **extra):
    conf = {"spark.rapids.sql.enabled": True,
            "spark.rapids.shuffle.mode": "ICI",
            "spark.default.parallelism": 8,
            "spark.rapids.executor.id": pid,
            "spark.rapids.executor.count": nprocs,
            "spark.rapids.executor.coordinator.address":
                f"127.0.0.1:{port}",
            "spark.rapids.shuffle.rendezvous.address": rdv_addr,
            "spark.rapids.shuffle.rendezvous.timeoutSec": 60.0,
            "spark.rapids.tpu.rendezvous.heartbeatMs": 100,
            "spark.rapids.tpu.rendezvous.leaseMs": LEASE_MS,
            "spark.rapids.tpu.retry.backoffBaseMs": 0}
    conf.update(extra)
    return conf


def _worker(pid, nprocs, port, rdv_addr, q):
    out = {}
    try:
        import os
        import time
        os.environ["TPUQ_VIRTUAL_RANKS"] = "2"
        torch.set_num_threads(1)
        from spark_rapids_tpu_torch.parallel import rendezvous as RD
        from spark_rapids_tpu_torch.parallel.executor import get_executor
        from spark_rapids_tpu_torch.runtime import resilience as R
        from spark_rapids_tpu_torch.sql import functions as F
        from spark_rapids_tpu_torch.sql.column import col
        from spark_rapids_tpu_torch.sql.session import TpuSession
        from spark_rapids_tpu_torch.sql.window import Window
        s = TpuSession(_conf(pid, nprocs, port, rdv_addr), device="cpu")
        for name, build in _queries(F, col, Window).items():
            df = build(s)
            out[name] = df.toArrow().to_pylist()
            out[name + ":tree"] = df._last_plan.tree_string()
        # the cluster-wide merge of the exchange counts (stats plane)
        st = TpuSession(_conf(pid, nprocs, port, rdv_addr, **{
            "spark.rapids.tpu.stats.enabled": True}), device="cpu")
        st.createDataFrame(_stats_table()).groupBy("k").agg(
            F.sum("v").alias("sv")).toArrow()
        out["stats_agg"] = st.last_query_profile()["exchanges"]
        st.createDataFrame(_stats_table()).select(
            col("k"), col("v"), F.row_number().over(
                Window.partitionBy("k").orderBy("v")).alias("rn")).toArrow()
        out["stats_window"] = st.last_query_profile()["exchanges"]
        out["transport"] = get_executor().transport.describe()
        # global-gather operators raise in multi-executor mode
        try:
            s.createDataFrame(_agg_table()).sample(fraction=0.5,
                                                   seed=1).toArrow()
            out["sample"] = "did not raise"
        except NotImplementedError as e:
            out["sample"] = str(e)
        # one transient rendezvous fault on pid 0: both retry at epoch 1
        base = RD.counters_snapshot()["epoch_retries"]
        inj = {}
        if pid == 0:
            inj = {"spark.rapids.tpu.test.inject.rendezvous.at": 1,
                   "spark.rapids.tpu.test.inject.rendezvous.transientCount":
                       1}
        fs = TpuSession(_conf(pid, nprocs, port, rdv_addr, **inj),
                        device="cpu")
        out["agg_faulted"] = _queries(F, col, Window)["agg"](fs) \
            .toArrow().to_pylist()
        out["epoch_retries"] = RD.counters_snapshot()["epoch_retries"] - base
        # peer_loss last (the group is broken after it): pid 1 dies
        inj = ({"spark.rapids.tpu.test.inject.peer_loss.at": 1}
               if pid == 1 else {})
        ps = TpuSession(_conf(pid, nprocs, port, rdv_addr, **inj),
                        device="cpu")
        try:
            _queries(F, col, Window)["agg"](ps).toArrow()
            out["peer_loss"] = ("completed", None, None, time.time())
        except R.TerminalDeviceError as e:
            # the wall clock of the failure: the victim's is its death
            out["peer_loss"] = ("failed", e.domain, e.peer, time.time())
        q.put(("ok", pid, out))
    except Exception:  # pragma: no cover
        q.put(("err", pid, traceback.format_exc()))


@pytest.fixture(scope="module")
def cluster():
    from spark_rapids_tpu_torch.parallel.rendezvous import (
        RendezvousCoordinator)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    nprocs = 2
    port = _free_port()
    coord = RendezvousCoordinator(num_processes=nprocs,
                                  lease_s=LEASE_MS / 1000.0)
    procs = [ctx.Process(target=_worker,
                         args=(i, nprocs, port, coord.address, q))
             for i in range(nprocs)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(nprocs):
            results.append(q.get(timeout=240))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        coord.shutdown()
    errs = [r for r in results if r[0] == "err"]
    assert not errs, errs[0][2]
    return [r[2] for r in sorted(results, key=lambda r: r[1])]


def _norm(rows):
    return sorted(repr(tuple(r.values())) for r in rows)


@pytest.fixture(scope="module")
def jax_single_process():
    """The JAX package's single-process ICI run (eight virtual CPU
    devices) of the aggregate and the join, on the same rows."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    s = JaxSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.shuffle.mode": "ICI",
                    "spark.default.parallelism": 8})
    agg = (s.createDataFrame(_agg_table()).groupBy("k")
           .agg(JF.sum("v").alias("sv"), JF.count("*").alias("c"))
           .toArrow().to_pylist())
    left, right = _join_tables()
    join = (s.createDataFrame(left).join(s.createDataFrame(right), "k",
                                         "inner").toArrow().to_pylist())
    return {"agg": agg, "join": join}


def _jax_oracle(name):
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.column import col as jcol
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    from spark_rapids_tpu.sql.window import Window as JWindow
    cpu = JaxSession({"spark.rapids.sql.enabled": False})
    return _queries(JF, jcol, JWindow)[name](cpu).toArrow().to_pylist()


def test_multiprocess_engine_agg_and_join_match_jax(cluster,
                                                    jax_single_process):
    """Every group and every join match land on exactly one executor:
    the union is the JAX package's single-process ICI result."""
    for name in ("agg", "join"):
        got = [row for out in cluster for row in out[name]]
        assert _norm(got) == _norm(jax_single_process[name]), name
        # both executors contributed (the slice actually spread)
        assert all(len(out[name]) > 0 for out in cluster), name
        assert "TpuIciShuffleExchange" in cluster[0][name + ":tree"]
    assert "over 4dev" in cluster[0]["agg:tree"]
    assert cluster[0]["transport"] == "gloo"


def test_multiprocess_global_gather_raises(cluster):
    """Global-gather operators fail loudly in multi-executor mode
    instead of silently computing per-slice results."""
    assert all("multi-executor" in out["sample"] for out in cluster)


def test_executor_conf_validation():
    """count > 1 without addresses (or without ICI mode) must raise."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.parallel.executor import init_executor
    with pytest.raises(ValueError, match="coordinator.address"):
        init_executor(RapidsConf({"spark.rapids.executor.count": 2}))
    with pytest.raises(ValueError, match="ICI"):
        init_executor(RapidsConf({
            "spark.rapids.executor.count": 2,
            "spark.rapids.executor.coordinator.address": "127.0.0.1:1",
            "spark.rapids.shuffle.rendezvous.address": "127.0.0.1:2",
        }))


def test_multiprocess_sort_window_topn(cluster):
    """Sort/Window/TopN/Limit distribute across executor processes:
    range exchange + local sorts, the window's hash exchange, the
    winner allgather, the limit's quota."""
    # processes own CONTIGUOUS partition ranges, so proc0 ++ proc1 IS
    # the total order
    got = [row for out in cluster for row in out["sort"]]
    assert got == _jax_oracle("sort")
    assert all(len(out["sort"]) > 0 for out in cluster)
    assert "TpuIciRangeExchange" in cluster[0]["sort:tree"]
    got = [row for out in cluster for row in out["window"]]
    assert _norm(got) == _norm(_jax_oracle("window"))
    assert all(len(out["window"]) > 0 for out in cluster)
    # TopN: only process 0 emits the (global) answer
    assert cluster[0]["topn"] == _jax_oracle("topn")
    assert cluster[1]["topn"] == []
    # LIMIT takes any 11 rows, process 0's quota first
    assert len(cluster[0]["limit"]) + len(cluster[1]["limit"]) == 11


def test_multiprocess_exchange_merges_cluster_wide_counts(cluster):
    """Each executor's per-partition counts ride the rendezvous
    allgather; EVERY process's profile shows the cluster-wide totals.
    The window's exchange takes the input rows: they merge back to the
    full input, counted exactly once (the JAX test's contract).  The
    grouped sum's exchange counts the partial aggregates' rows."""
    win = [out["stats_window"][0] for out in cluster]
    assert win[0]["executors"] == win[1]["executors"] == 2
    assert win[0]["total"] == win[1]["total"] == 20_000
    assert win[0]["max"] == win[1]["max"]
    assert win[0]["skew_factor"] == win[1]["skew_factor"]
    assert win[0]["skew_factor"] > 2.0 and win[0]["skewed"]
    agg = [out["stats_agg"][0] for out in cluster]
    k = _stats_table().column("k").to_numpy()
    partial_rows = sum(len(np.unique(p)) for p in np.array_split(k, 8))
    assert agg[0]["total"] == agg[1]["total"] == partial_rows == 2138
    assert agg[0]["executors"] == 2


def test_jax_exchange_counts_partial_aggregate_rows():
    """ROADMAP C.10: the JAX package's grouped-sum exchange records the
    partial aggregates' rows, not the 20,000 input rows its
    multi-process test expects (here on its single-process run)."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    s = JaxSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.tpu.stats.enabled": True,
                    "spark.rapids.shuffle.mode": "ICI",
                    "spark.default.parallelism": 8})
    (s.createDataFrame(_stats_table()).groupBy("k")
     .agg(JF.sum("v").alias("sv")).toArrow())
    ex = s.last_query_profile()["exchanges"][0]
    assert ex["total"] == 2138 != 20_000


def test_multiprocess_rendezvous_and_peer_loss_domains(cluster):
    """A transient ``rendezvous`` fault retries at epoch 1 with an
    equal result; a ``peer_loss`` fails both: the victim by its own
    death, the survivor peer-tagged within about one lease."""
    for out in cluster:
        assert _norm(out["agg_faulted"]) == _norm(out["agg"])
    assert cluster[0]["epoch_retries"] >= 1
    victim, survivor = cluster[1]["peer_loss"], cluster[0]["peer_loss"]
    assert victim[:2] == ("failed", "peer_loss")
    assert survivor[:3] == ("failed", "peer_loss", 1)
    # detected within about one lease of the death (the reaper looks
    # every quarter lease), far inside the 60 s stage deadline
    assert survivor[3] - victim[3] < 3 * LEASE_MS / 1000.0
