"""The port's lock-order watchdog (``runtime/lockdep.py``).

* A deliberate inversion (A then B on one path, B then A on another)
  raises ``LockOrderViolation`` at the acquisition that closes the cycle
  under ``scoped``, records one violation, and leaves the lock free — as
  the JAX package's watchdog does on its own tracked locks.  A
  condition's wait drops its held entry.
* The pump at 4 permits (a host-shuffled aggregate under parallelism 4
  over a pool that spills to disk, and a root that keeps its four
  partitions) records edges between the engine's tracked locks and no
  cycle, with ``raiseOnCycle`` on; the session's conf turns the
  watchdog on.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import lockdep as LD
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import semaphore as SEM
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    was = LD.is_enabled()
    M.reset_manager()
    B.clear_scan_cache()
    SEM.reset_semaphore()
    yield
    M.reset_manager()
    B.clear_scan_cache()
    SEM.reset_semaphore()
    if not was:
        LD.disable()


def _jax_lockdep():
    from spark_rapids_tpu.runtime import lockdep as JLD
    return JLD


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_deliberate_inversion_raises_under_scoped(jax):
    ld = _jax_lockdep() if jax else LD
    with ld.scoped(raise_on_cycle=True):
        a = ld.tracked_lock("test.inversion.A")
        b = ld.tracked_lock("test.inversion.B")
        with a:
            with b:
                pass
        b.acquire()
        try:
            with pytest.raises(ld.LockOrderViolation,
                               match="test.inversion.B -> "
                                     "test.inversion.A"):
                a.acquire()
        finally:
            b.release()
        (v,) = ld.violations()
        assert v.edge == ("test.inversion.B", "test.inversion.A")
    if not jax:
        # the port gives the lock back at the raise
        assert not a.locked() and not b.locked()
    # the scoped graph does not leak into the process-wide record
    assert all(v.edge[0] != "test.inversion.B" for v in ld.violations())


def test_condition_wait_drops_its_held_entry():
    with LD.scoped(raise_on_cycle=True):
        cv = LD.tracked_condition("test.cv")
        other = LD.tracked_lock("test.other")
        done = threading.Event()

        def notifier():
            with other:
                with cv:  # other -> cv
                    cv.notify_all()
            done.set()

        with cv:
            threading.Thread(target=notifier, daemon=True).start()
            # waiting drops cv, so the notifier's other -> cv and the
            # reacquire below close no cycle
            cv.wait_for(done.is_set, timeout=5.0)
        with other:
            pass
        assert LD.violations() == []
        assert ("test.other", "test.cv") in LD.edges()


def _table(n=40000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 500, n)),
                     "v": pa.array(rng.normal(size=n))})


def test_pump_at_four_permits_records_no_cycle(tmp_path):
    t = _table()
    conf = {"spark.rapids.sql.test.enabled": True,
            "spark.default.parallelism": 4,
            "spark.rapids.sql.concurrentGpuTasks": 4,
            "spark.rapids.tpu.batchRows": 4096,
            "spark.rapids.tpu.memory.poolSize": 200_000,
            "spark.rapids.memory.host.spillStorageSize": 1,
            "spark.rapids.tpu.spillPath": str(tmp_path),
            "spark.rapids.tpu.lockdep.enabled": True,
            "spark.rapids.tpu.lockdep.raiseOnCycle": True}
    with LD.scoped(raise_on_cycle=True):
        s = TpuSession(conf, device="cpu")
        assert LD.is_enabled()
        agg = (s.createDataFrame(t).repartition(4, "k").groupBy("k")
               .agg(F.sum("v").alias("sv"), F.count("*").alias("c")))
        got = agg.toArrow()
        kept = s.createDataFrame(t).filter(col("v") > 0.5).toArrow()
        assert LD.violations() == []
        edges = LD.edges()
    assert got.num_rows == len(np.unique(t.column("k").to_numpy()))
    assert kept.num_rows == int((t.column("v").to_numpy() > 0.5).sum())
    assert M.peek_manager().metrics["spillToDiskBytes"] > 0
    keys = {k for e in edges for k in e}
    assert "runtime.memory.DeviceMemoryManager" in keys
    assert SEM.peek_semaphore().peak_holders > 1
