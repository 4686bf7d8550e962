"""The port's memory arbiter (``runtime/memory.py``) against the JAX
package's on the same sequence of registrations, spills, restores and
reservations with the same budget: after every step both managers must
hold the same tiers, the same reserved bytes and the same ``metrics``
(``spillToHostBytes``, ``spillToDiskBytes``, ``restoredBytes``,
``peakReserved``, ``retryOOMs``, ``splitRetries``) and the same host
tier bytes.  Batches come from the same arrow tables through each
package's ``host_to_device``.  Plus the port's own rules: the memory
confs and the manager's replacement (which evicts the scan cache).
The disk tier, ``with_retry`` and the leak tracker are held against
the JAX package in ``tests/test_torch_disk_spill.py``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.column import host_to_device as jax_h2d
from spark_rapids_tpu.runtime import memory as JM

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
METRICS = ("spillToHostBytes", "spillToDiskBytes", "restoredBytes",
           "peakReserved", "retryOOMs", "splitRetries")


@pytest.fixture(autouse=True)
def _fresh_managers():
    for mod in (M, JM):
        mod.reset_manager()
    B.clear_scan_cache()
    yield
    for mod in (M, JM):
        mod.reset_manager()
    B.clear_scan_cache()


def _table(seed=0, n=100):
    rng = np.random.default_rng(seed)
    return pa.table({"a": pa.array(rng.integers(0, 50, n)),
                     "b": pa.array(rng.uniform(0, 1, n)),
                     "s": pa.array([f"v{i % 7}" for i in range(n)])})


class _Side:
    """One package's manager, batches and spillables, driven by name."""

    def __init__(self, mod, make_batch, budget, tmp_path=None, **kw):
        kw["spill_path"] = str(tmp_path / mod.__name__.split(".")[0])
        self.mod = mod
        self.mgr = mod.DeviceMemoryManager(budget=budget, **kw)
        self.make_batch = make_batch
        self.sps = []

    def register(self, seed):
        self.sps.append(self.mod.SpillableBatch(self.make_batch(seed),
                                                self.mgr))

    def state(self):
        return ([s.tier for s in self.sps], self.mgr._reserved,
                self.mgr._host_used,
                {k: self.mgr.metrics[k] for k in METRICS})


def _both(tmp_path, budget, **kw):
    jax_side = _Side(JM, lambda seed: jax_h2d(_table(seed)), budget,
                     tmp_path, **kw)
    port_side = _Side(M, lambda seed: host_to_device(_table(seed), CPU),
                      budget, tmp_path, **kw)
    return jax_side, port_side


def _size():
    size = host_to_device(_table(), CPU).nbytes()
    assert size == jax_h2d(_table()).nbytes()
    return size


def _run(sides, steps):
    """Apply each step to both sides; states must agree after each."""
    for step in steps:
        outcomes = []
        for side in sides:
            try:
                step(side)
                outcomes.append(None)
            except side.mod.RetryOOM as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1], step
        assert sides[0].state() == sides[1].state(), step
    return sides[1]


def test_nbytes_matches_jax():
    t = _table(4, 333).append_column(
        "n", pa.array([None if i % 3 else i for i in range(333)],
                      pa.int32()))
    assert host_to_device(t, CPU).nbytes() == jax_h2d(t).nbytes()


def test_spill_roundtrip_host(tmp_path):
    port = _run(_both(tmp_path, 1 << 30), [
        lambda s: s.register(0),
        lambda s: s.sps[0].spill_to_host(),
        lambda s: s.sps[0].get(),
        lambda s: s.sps[0].close(),
    ])
    assert port.mgr._reserved == 0 and port.mgr._host_used == 0
    assert port.mgr.metrics["spillToHostBytes"] == _size()


def test_restore_returns_the_same_bits():
    mgr = M.DeviceMemoryManager(budget=1 << 30)
    b = host_to_device(_table(1), CPU)
    want = [c.data.clone() for c in b.columns]
    sp = M.SpillableBatch(b, mgr)
    sp.spill_to_host()
    got = sp.get()
    assert sp.tier == "device" and mgr._reserved == sp.nbytes
    assert all(torch.equal(g.data, w) for g, w in zip(got.columns, want))
    assert got.schema == b.schema and got.compacted == b.compacted


def test_budget_pressure_spills_oldest(tmp_path):
    port = _run(_both(tmp_path, int(_size() * 2.5)), [
        lambda s: s.register(1),
        lambda s: s.register(2),
        lambda s: s.register(3),  # forces the first out
    ])
    assert [s.tier for s in port.sps] == ["host", "device", "device"]
    assert port.mgr.metrics["spillToHostBytes"] == _size()


def test_restore_rereserves_and_spills_the_oldest(tmp_path):
    port = _run(_both(tmp_path, int(_size() * 2.5)), [
        lambda s: s.register(1),
        lambda s: s.register(2),
        lambda s: s.register(3),
        lambda s: s.sps[0].get(),  # restoring spills the second
        lambda s: s.mgr.reserve(_size() // 2),  # spills the third
        lambda s: s.sps[1].get(),  # spills the first again
        lambda s: s.sps[2].close(),
    ])
    assert port.mgr.metrics["restoredBytes"] == 2 * _size()


def test_oom_when_nothing_spillable(tmp_path):
    port = _run(_both(tmp_path, 1000), [
        lambda s: s.mgr.reserve(2000),  # bigger than the whole budget
        lambda s: s.mgr.reserve(800),
        lambda s: s.mgr.reserve(800),  # nothing registered to spill
    ])
    assert port.mgr.metrics["retryOOMs"] == 2
    with pytest.raises(M.SplitAndRetryOOM):
        port.mgr.reserve(2000)


def test_injected_oom_at_the_nth_reservation(tmp_path):
    _run(_both(tmp_path, 1 << 30, inject_oom_at=3), [
        lambda s: s.register(1),
        lambda s: s.mgr.reserve(10),
        lambda s: s.register(2),  # the third reservation
        lambda s: s.register(3),
    ])


def test_transient_releases_on_exit_and_on_error(tmp_path):
    def failing(s):
        with pytest.raises(ValueError):
            with s.mgr.transient(_size()):
                raise ValueError("inside")

    def nested(s):
        with s.mgr.transient(_size()):  # spills the oldest
            assert s.sps[0].tier == "host"

    port = _run(_both(tmp_path, int(_size() * 2.5)), [
        lambda s: s.register(1),
        lambda s: s.register(2),
        failing,
        nested,
    ])
    assert port.mgr._reserved == port.sps[1].nbytes


def test_host_limit_pushes_to_disk(tmp_path):
    """``tests/test_memory.py::test_host_limit_pushes_to_disk``: a host
    tier of one batch pushes its oldest copy on to disk; the restore
    reads it back; closing removes the file."""
    size = _size()
    port = _run(_both(tmp_path, size, host_limit=size), [
        lambda s: s.register(1),
        lambda s: s.register(2),  # s1 -> host
        lambda s: s.register(3),  # s2 -> host, s1 -> disk
        lambda s: s.sps[0].get(),  # s3 -> host, s2 -> disk
        lambda s: s.sps[1].close(),
    ])
    assert [s.tier for s in port.sps] == ["device", "disk", "host"]
    assert port.mgr.metrics["spillToDiskBytes"] == 2 * size
    assert port.mgr._host_used == size
    assert not port.sps[1]._disk_path


def test_memory_confs_and_budget_match_jax():
    from spark_rapids_tpu import conf as JC
    from spark_rapids_tpu.conf import RapidsConf as JaxConf
    raw = {"spark.rapids.tpu.memory.poolSize": "64m",
           "spark.rapids.memory.gpu.allocFraction": 0.5,
           "spark.rapids.memory.host.spillStorageSize": "1g",
           "spark.rapids.tpu.test.injectOomAtAlloc": 7,
           "spark.rapids.tpu.spillPath": "/nonexistent/spill",
           "spark.rapids.tpu.retry.maxAttempts": 3,
           "spark.rapids.memory.gpu.debug": "stdout"}
    port, jax = RapidsConf(raw), JaxConf(raw)
    from spark_rapids_tpu_torch import conf as C
    for pe, je in ((C.POOL_SIZE, JC.POOL_SIZE),
                   (C.MEMORY_FRACTION, JC.MEMORY_FRACTION),
                   (C.HOST_SPILL_STORAGE, JC.HOST_SPILL_STORAGE),
                   (C.FAULT_INJECT, JC.FAULT_INJECT),
                   (C.SPILL_PATH, JC.SPILL_PATH),
                   (C.RETRY_MAX, JC.RETRY_MAX),
                   (C.MEMORY_DEBUG, JC.MEMORY_DEBUG)):
        assert pe.key == je.key and pe.doc == je.doc
        assert pe.default == je.default
        assert port.get(pe) == jax.get(je)
    mgr = M.get_manager(port, CPU)
    jmgr = JM.get_manager(jax)
    ident = ("budget", "host_limit", "_inject_at", "retry_max_attempts",
             "spill_root", "debug")
    assert [getattr(mgr, a) for a in ident] == [
        getattr(jmgr, a) for a in ident] == [
        64 << 20, 1 << 30, 7, 3, "/nonexistent/spill", True]
    import atexit
    atexit.unregister(mgr.report_leaks)
    atexit.unregister(jmgr.report_leaks)
    # without poolSize: allocFraction of the JAX package's 4 GiB CPU
    # fallback, as its manager computes on the CPU platform
    frac = {"spark.rapids.memory.gpu.allocFraction": 0.5}
    M.reset_manager()
    JM.reset_manager()
    assert (M.get_manager(RapidsConf(frac), CPU).budget
            == JM.get_manager(JaxConf(frac)).budget == 2 << 30)
    with pytest.raises(ValueError, match="unknown"):
        RapidsConf({"spark.rapids.tpu.memory.poolSizes": 1})


def test_get_manager_stable_across_same_conf_replaced_on_change():
    conf = RapidsConf({"spark.rapids.tpu.memory.poolSize": "1g"})
    a = M.get_manager(conf, CPU)
    assert M.get_manager(RapidsConf(
        {"spark.rapids.tpu.memory.poolSize": "1g"}), CPU) is a
    assert M.get_manager() is a and M.peek_manager() is a
    # a cached scan registered with ``a``: replacing the arbiter closes it
    t = _table(5)
    sp = M.SpillableBatch(host_to_device(t, CPU), a)
    B._scan_cache_put(t, ("k",), [(sp, t.num_rows)])
    b = M.get_manager(RapidsConf(
        {"spark.rapids.tpu.memory.poolSize": "2g"}), CPU)
    assert b is not a and b.budget == 2 << 30
    # closed: no copy on any tier (the JAX package reports it as "disk")
    assert not B._scan_cache and sp.tier == "disk" and not sp._disk_path
    assert a._reserved == 0
    M.reset_manager()
    assert M.peek_manager() is None
