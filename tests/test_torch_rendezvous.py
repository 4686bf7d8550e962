"""The port's rendezvous: ``tests/test_rendezvous.py``'s nine cases.

In-process coordinator cases (exception taxonomy, stage GC, abort
fan-out, coordinator restart recovery, heartbeat-lease expiry latency)
run client threads against a real coordinator; the two multi-process
cases spawn 2 executor processes x 2 virtual ranks that join a gloo
process group (``parallel/executor.py``) and run one collective shuffle
stage through ``DistributedShuffleExecutor``.  Plus the distributed
failure domains of ``tests/test_chaos.py`` (``rendezvous`` recovers at
the next epoch; ``peer_loss`` fails every survivor within about one
lease) over ``utils/harness.py::run_rendezvous_chaos``.  Torch only: the
spawned workers re-import this module, which imports nothing of JAX.
"""

import multiprocessing as mp
import socket
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.parallel.rendezvous import (
    RendezvousAborted, RendezvousClient, RendezvousCoordinator,
    RendezvousProtocolError, RendezvousTimeout, run_stage_epochs)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _threads(fn, n):
    """Run ``fn(pid)`` on n threads that start together (a barrier)."""
    gate = threading.Barrier(n)

    def run(pid):
        gate.wait(timeout=30)
        fn(pid)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


# ---------------------------------------------------------------------------
# coordinator unit cases (in-process)
# ---------------------------------------------------------------------------

def test_allgather_returns_all_payloads():
    coord = RendezvousCoordinator(num_processes=3)
    out = [None] * 3

    def run(pid):
        c = RendezvousClient(coord.address, pid)
        out[pid] = c.allgather("s1", {"pid": pid, "v": pid * 10})

    _threads(run, 3)
    for pid in range(3):
        assert [p["v"] for p in out[pid]] == [0, 10, 20]
    coord.shutdown()


def test_rendezvous_timeout_fails_all_waiters():
    coord = RendezvousCoordinator(num_processes=2)
    c = RendezvousClient(coord.address, 0)
    t0 = time.monotonic()
    with pytest.raises(RendezvousTimeout):
        c.allgather("never", 1, timeout=1.5)
    assert time.monotonic() - t0 < 10
    coord.shutdown()


def test_duplicate_registration_rejected():
    """A duplicate pid is a PROTOCOL error for the duplicate caller only
    — the stage itself proceeds untouched."""
    coord = RendezvousCoordinator(num_processes=2)
    res = [None]
    c = RendezvousClient(coord.address, 0)

    def first():
        res[0] = c.allgather("dup", 0, timeout=20)

    t1 = threading.Thread(target=first)
    t1.start()
    deadline = time.monotonic() + 10
    while not coord._stages and time.monotonic() < deadline:
        time.sleep(0.01)  # pid 0 is parked in the stage
    with pytest.raises(RendezvousProtocolError):
        RendezvousClient(coord.address, 0).allgather("dup", 99, timeout=2)
    RendezvousClient(coord.address, 1).allgather("dup", 1, timeout=20)
    t1.join(timeout=30)
    assert res[0] == [0, 1]
    coord.shutdown()


def test_straggler_abort_reaches_every_waiter():
    """A deadline failure fails EVERY waiter, and a straggler arriving
    after the failure hits the stage's tombstone at once instead of
    waiting out its own full deadline."""
    coord = RendezvousCoordinator(num_processes=3)
    errs = [None, None]

    def run(pid):
        try:
            RendezvousClient(coord.address, pid).allgather(
                "strag:x", pid, timeout=1.0)
        except Exception as e:
            errs[pid] = e

    _threads(run, 2)
    assert all(isinstance(e, RendezvousTimeout) for e in errs), errs
    t0 = time.monotonic()
    with pytest.raises(RendezvousTimeout):
        RendezvousClient(coord.address, 2).allgather("strag:x", 2,
                                                     timeout=30.0)
    assert time.monotonic() - t0 < 5.0
    coord.shutdown()


def test_completed_stage_gc():
    """The last waiter out deletes the stage: ``_stages`` is empty after
    every completed (or failed) stage."""
    coord = RendezvousCoordinator(num_processes=3)

    def run_query(pid):
        c = RendezvousClient(coord.address, pid)
        c.allgather("q:shape", {"pid": pid})
        c.barrier("q:enter")

    _threads(run_query, 3)
    assert coord._stages == {}
    with pytest.raises(RendezvousTimeout):
        RendezvousClient(coord.address, 0).allgather("q2:x", 0,
                                                     timeout=0.5)
    assert coord._stages == {}
    coord.shutdown()


def test_client_retry_after_coordinator_restart():
    """Clients under ``run_stage_epochs`` survive a coordinator restart
    mid-stage: the orphaned epoch is abandoned, both sides converge on a
    later epoch, and the stage completes on the new coordinator."""
    from spark_rapids_tpu_torch.runtime.resilience import RetryPolicy

    port = _free_port()
    coord1 = RendezvousCoordinator(num_processes=2, port=port)
    addr = coord1.address
    policy = RetryPolicy(backoff_base_ms=0, max_attempts=10)
    out = [None, None]
    errs = [None, None]

    def run(pid):
        try:
            client = RendezvousClient(addr, pid, default_timeout=2.0)

            def attempt(epoch):
                return client.allgather("restart:x", pid, epoch=epoch)

            out[pid] = run_stage_epochs(client, "restart", attempt,
                                        policy=policy)
        except Exception as e:  # pragma: no cover - assertion surface
            errs[pid] = e

    t0 = threading.Thread(target=run, args=(0,))
    t0.start()
    deadline = time.monotonic() + 10
    while not coord1._stages and time.monotonic() < deadline:
        time.sleep(0.01)  # pid 0 is now parked at epoch 0
    coord1.shutdown()          # coordinator dies mid-stage
    coord2 = RendezvousCoordinator(num_processes=2, port=port)
    t1 = threading.Thread(target=run, args=(1,))
    t1.start()
    t0.join(timeout=90)
    t1.join(timeout=90)
    assert errs == [None, None], errs
    assert out[0] == out[1] == [0, 1]
    assert coord2._stages == {}
    coord2.shutdown()


def test_lease_expiry_abort_latency():
    """A silent peer is detected by the lease and every survivor's
    in-flight stage aborts peer-tagged within 2x the lease."""
    lease = 0.5
    coord = RendezvousCoordinator(num_processes=2, lease_s=lease)
    a = RendezvousClient(coord.address, 0, default_timeout=30.0)
    b = RendezvousClient(coord.address, 1)
    a.start_heartbeat(0.1)
    b.start_heartbeat(0.1)
    time.sleep(0.2)
    b.simulate_death()
    t0 = time.monotonic()
    with pytest.raises(RendezvousAborted) as ei:
        a.allgather("lease:x", 0)
    elapsed = time.monotonic() - t0
    assert elapsed < 2 * lease, f"abort took {elapsed:.2f}s"
    assert ei.value.peer == 1
    assert ei.value.transient is False
    assert "executor 1" in str(ei.value)
    a.stop_heartbeat()
    coord.shutdown()


# ---------------------------------------------------------------------------
# the distributed failure domains (thread-level harness)
# ---------------------------------------------------------------------------

_LEASE_S = 0.4


def test_chaos_peer_loss_survivors_fail_together_fast():
    """peer_loss: the victim goes silent, and EVERY survivor raises the
    same peer-tagged ``TerminalDeviceError`` within ~2x the lease."""
    from spark_rapids_tpu_torch.utils.harness import run_rendezvous_chaos
    out = run_rendezvous_chaos({"peer_loss": (1, 0)}, nprocs=3,
                               lease_s=_LEASE_S, stage_timeout=30.0)
    dead = [r for r in out["records"] if r["died"]]
    survivors = [r for r in out["records"] if not r["died"]]
    assert len(dead) == 1 and len(survivors) == 2
    victim = dead[0]["pid"]
    for r in out["records"]:
        assert r["status"] == "failed"
        assert r["domain"] == "peer_loss"
    for r in survivors:
        assert r["peer"] == victim
        assert r["elapsed"] < 2 * _LEASE_S + 0.5, (
            f"survivor {r['pid']} took {r['elapsed']:.2f}s")
    assert out["live_stages"] == {}


def test_chaos_transient_rendezvous_recovers_next_epoch():
    """rendezvous: one transient fault -> every participant re-enters
    at epoch+1 and the stage completes as a clean run would."""
    from spark_rapids_tpu_torch.parallel import rendezvous as RD
    from spark_rapids_tpu_torch.utils.harness import run_rendezvous_chaos
    base = RD.counters_snapshot()["epoch_retries"]
    out = run_rendezvous_chaos({"rendezvous": (1, 1)}, nprocs=3,
                               lease_s=_LEASE_S)
    for r in out["records"]:
        assert r["status"] == "ok", r["error"]
        assert r["result"] == out["expected"]
    assert RD.counters_snapshot()["epoch_retries"] > base
    assert out["live_stages"] == {}


# ---------------------------------------------------------------------------
# full multi-process shuffle stage (2 processes x 2 ranks, gloo)
# ---------------------------------------------------------------------------

_PER = 64


def _shards(ex, seed_base, unique=True):
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar.column import host_to_device
    rng = np.random.default_rng(seed_base + ex.process_id)
    shards, rows = [], []
    for li, r in enumerate(ex.mesh.local_ranks()):
        k = rng.integers(0, 37, _PER)
        v = r * 1_000_000 + np.arange(_PER) * (100 if unique else 1) + (
            k if unique else 0)
        rows.extend(zip(k.tolist(), v.tolist()))
        tbl = pa.table({"k": pa.array(k), "v": pa.array(v)})
        shards.append(host_to_device(tbl, ex.ctx.device, bucket=_PER))
    return shards, rows


def _received(outs):
    got = []
    for ob in outs:
        sel = ob.sel
        got.append((ob.columns[0].data[sel].tolist(),
                    ob.columns[1].data[sel].tolist()))
    return got


def _worker(pid, nprocs, port, rdv_addr, q):
    try:
        torch.set_num_threads(1)
        from spark_rapids_tpu_torch.columnar import dtypes as T
        from spark_rapids_tpu_torch.ops.expressions import BoundReference
        from spark_rapids_tpu_torch.parallel.rendezvous import (
            DistributedShuffleExecutor)
        ex = DistributedShuffleExecutor(
            f"127.0.0.1:{port}", rdv_addr, pid, nprocs, device="cpu",
            local_ranks=2)
        shards, rows = _shards(ex, 0)
        outs = ex.shuffle_stage("stage-7", shards,
                                [BoundReference(0, T.LongT)])
        got = [(r, ks, vs) for r, (ks, vs) in
               zip(ex.mesh.local_ranks(), _received(outs))]
        ex.shutdown()
        q.put(("ok", pid, rows, got))
    except Exception:  # pragma: no cover
        import traceback
        q.put(("err", pid, traceback.format_exc(), None))


def _spawn(target, nprocs=2, timeout=120):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    coord = RendezvousCoordinator(num_processes=nprocs)
    procs = [ctx.Process(target=target,
                         args=(i, nprocs, port, coord.address, q))
             for i in range(nprocs)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(nprocs):
            results.append(q.get(timeout=timeout))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        stages_left = dict(coord._stages)
        coord.shutdown()
    errs = [r for r in results if r[0] == "err"]
    assert not errs, errs[0][2]
    assert stages_left == {}, f"stage leak: {stages_left}"
    return sorted(results, key=lambda r: r[1])


def test_multiprocess_shuffle_stage():
    results = _spawn(_worker)
    all_rows = sorted(r for res in results for r in res[2])
    received = {}
    key_home = {}
    for res in results:
        for rank, ks, vs in res[3]:
            for k, v in zip(ks, vs):
                received[(k, v)] = received.get((k, v), 0) + 1
                assert key_home.setdefault(k, rank) == rank, (
                    f"key {k} split across partitions")
    assert sorted(received) == all_rows
    assert all(c == 1 for c in received.values())
    # murmur3 partitioning is deterministic — both processes agree with
    # this process's pids
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.ops.expressions import BoundReference
    from spark_rapids_tpu_torch.ops.hashing import make_pid_fn
    ks = sorted(key_home)
    b = host_to_device(pa.table({"k": pa.array(ks, pa.int64())}),
                       torch.device("cpu"))
    pids = make_pid_fn([BoundReference(0, T.LongT)], 4)(b)[:len(ks)]
    assert pids.tolist() == [key_home[k] for k in ks]


def _chaos_worker(pid, nprocs, port, rdv_addr, q):
    """pid 0 arms one transient ``rendezvous`` fault, runs a faulted
    stage (which must recover at epoch+1) and then a clean stage over
    the SAME shards, and reports whether they are bit-identical."""
    try:
        torch.set_num_threads(1)
        from spark_rapids_tpu_torch.columnar import dtypes as T
        from spark_rapids_tpu_torch.conf import RapidsConf
        from spark_rapids_tpu_torch.ops.expressions import BoundReference
        from spark_rapids_tpu_torch.parallel import rendezvous as RD
        from spark_rapids_tpu_torch.runtime import resilience as R
        ex = RD.DistributedShuffleExecutor(
            f"127.0.0.1:{port}", rdv_addr, pid, nprocs, device="cpu",
            local_ranks=2, timeout=60.0, heartbeat_s=0.2)
        shards, _ = _shards(ex, 100, unique=False)
        keys = [BoundReference(0, T.LongT)]
        R.configure_policy(RapidsConf(
            {"spark.rapids.tpu.retry.backoffBaseMs": 0}))
        if pid == 0:
            R.INJECTOR.configure({"rendezvous": (1, 1)})
        faulted = ex.shuffle_stage("stage-0", shards, keys)
        clean = ex.shuffle_stage("stage-1", shards, keys)

        def snap(outs):
            from spark_rapids_tpu_torch.parallel.shuffle import _leaves
            return [[None if x is None else x.tolist() for x in _leaves(ob)]
                    for ob in outs]

        same = snap(faulted) == snap(clean)
        ex.shutdown()
        q.put(("ok", pid, same, RD.counters_snapshot()))
    except Exception:  # pragma: no cover
        import traceback
        q.put(("err", pid, traceback.format_exc(), None))


def test_multiprocess_shuffle_transient_rendezvous_chaos():
    """One transient ``rendezvous`` fault over real processes: the stage
    retries at epoch+1 in EVERY process, the result is bit-identical to
    the unfaulted stage, and the coordinator's stage table drains."""
    from spark_rapids_tpu_torch.parallel import rendezvous as RD
    base_aborts = RD.counters_snapshot()["aborts"].get("requested", 0)
    results = _spawn(_chaos_worker)
    assert all(r[2] for r in results), (
        "faulted stage result differs from clean stage result")
    by_pid = {r[1]: r[3] for r in results}
    assert by_pid[0]["epoch_retries"] >= 1
    # the abandoned epoch was poisoned at the coordinator (this process)
    assert RD.counters_snapshot()["aborts"].get("requested", 0) \
        > base_aborts
