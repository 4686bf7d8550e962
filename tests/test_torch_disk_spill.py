"""The port's disk spill tier, ``with_retry`` and leak tracker against
the JAX package's (``runtime/memory.py`` in both packages).

Mirrors the cases of ``tests/test_memory.py`` (the spillable lifecycle,
the retry framework, the spill files' integrity, the per-process spill
directories and the cases that arm the fault injector's ``spill_read``
and ``spill_write`` domains) and the leak tracker's two cases of
``tests/test_observability.py``.  Each case runs the same steps on both
packages' managers over the same 100-row batches (each package's
``host_to_device`` of one seeded table): tiers, reserved and host
bytes, ``metrics``, the restored bits, the spill files' arrays and the
outcome of a bad restore must agree.  A bad restore retries and then
raises ``TerminalDeviceError`` tagged ``spill_read`` in both packages;
a failed disk write retries and then keeps the host copy.
"""

import atexit
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.column import host_to_device as jax_h2d
from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.runtime import resilience as R
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as PR
from spark_rapids_tpu_torch.sql.session import TpuSession


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
           "retryOOMs", "splitRetries", "peakReserved")


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh arbiters and scan caches; both packages' retry policies
    without backoff (a restore retries a missing file before giving up),
    and a clean injector and out-of-query breaker set (these calls run
    outside any query scope, where a breaker tripped by one case would
    send the next case's spill straight to its degrade path)."""
    olds = (R._policy, PR._policy)
    # outside any query scope on the JAX side too (its depth stays
    # raised after some of its test files, ROADMAP "Reference side")
    R._STATE.depth = 0
    for mod in (R, PR):
        mod._policy = mod.RetryPolicy(backoff_base_ms=0)
        mod.INJECTOR.reset()
        mod._STATE.breakers = set()
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()
    yield
    R._policy, PR._policy = olds
    for mod in (R, PR):
        mod.INJECTOR.reset()
        mod._STATE.breakers = set()
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()


def _table(seed=0, n=100):
    """``tests/test_memory.py::small_batch``'s table."""
    rng = np.random.default_rng(seed)
    return pa.table({"a": pa.array(rng.integers(0, 50, n)),
                     "b": pa.array(rng.uniform(0, 1, n))})


class _Pkg:
    """One package's manager and helpers."""

    def __init__(self, mod, tmp_path, **kw):
        self.mod = mod
        self.h2d = (jax_h2d if mod is JM
                    else lambda t: host_to_device(t, CPU))
        root = tmp_path / ("jax" if mod is JM else "port")
        self.mgr = mod.DeviceMemoryManager(budget=kw.pop("budget", 1 << 30),
                                           spill_path=str(root), **kw)
        self.sps = []

    def batch(self, seed=0):
        return self.h2d(_table(seed))

    def register(self, seed=0):
        self.sps.append(self.mod.SpillableBatch(self.batch(seed), self.mgr))
        return self.sps[-1]

    def state(self):
        return ([s.tier for s in self.sps], self.mgr._reserved,
                self.mgr._host_used,
                {k: self.mgr.metrics[k] for k in METRICS})


def _pair(tmp_path, **kw):
    return _Pkg(JM, tmp_path, **dict(kw)), _Pkg(M, tmp_path, **dict(kw))


def _col(batch, i) -> np.ndarray:
    return np.asarray(batch.columns[i].data)


def _files(pkg) -> int:
    """Files in the manager's spill directory (made at its first disk
    spill)."""
    d = pkg.mgr.spill_path
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def _disk(pkg, seed=5):
    """A batch spilled device -> host -> disk; returns (spillable, its
    first column's values)."""
    sp = pkg.register(seed)
    ref = _col(sp.get(), 0).copy()
    sp.spill_to_host()
    sp.spill_to_disk()
    assert sp.tier == "disk"
    return sp, ref


# ---------------------------------------------------------------------------
# spillable lifecycle
# ---------------------------------------------------------------------------

def test_spill_roundtrip_disk(tmp_path):
    pkgs = _pair(tmp_path)
    files = []
    for p in pkgs:
        sp = p.register(1)
        ref = _col(sp.get(), 1).copy()
        sp.spill_to_host()
        assert sp.spill_to_disk() == sp.nbytes
        assert sp.tier == "disk" and p.mgr.metrics["spillToDiskBytes"] > 0
        assert os.path.dirname(sp._disk_path) == p.mgr.spill_path
        assert os.path.basename(sp._disk_path).startswith("spill-")
        with np.load(sp._disk_path) as z:
            files.append([z[k] for k in z.files])
        out = sp.get()
        assert np.array_equal(_col(out, 1), ref)
        assert not os.listdir(p.mgr.spill_path)  # restored: file gone
        sp.close()
    jax, port = pkgs
    assert jax.state() == port.state()
    assert port.mgr._reserved == 0 and port.mgr._host_used == 0
    # the same arrays under the same member names, in the same order
    assert len(files[0]) == len(files[1])
    for a, b in zip(*files):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_limit_eviction_order_and_accounting(tmp_path):
    """``tests/test_memory.py::test_host_limit_pushes_to_disk``, then
    restores from both tiers and a close of a disk batch."""
    size = jax_h2d(_table()).nbytes()
    pkgs = _pair(tmp_path, budget=size, host_limit=size)
    steps = [
        lambda p: p.register(1),
        lambda p: p.register(2),  # s1 -> host
        lambda p: p.register(3),  # s2 -> host, s1 -> disk
        lambda p: p.sps[0].get(),  # s3 -> host, s2 -> disk
        # s1 -> host pushes the host copy being restored (s3's) to disk;
        # s3 restores from the copy it holds, its file stays until close
        lambda p: p.sps[2].get(),
        lambda p: p.sps[1].close(),  # a disk batch: its file goes
        lambda p: p.sps[0].get(),  # s3 -> host, s1's copy -> disk
    ]
    for step in steps:
        for p in pkgs:
            step(p)
        assert pkgs[0].state() == pkgs[1].state()
        assert _files(pkgs[0]) == _files(pkgs[1])
    port = pkgs[1]
    assert port.state()[0] == ["device", "disk", "host"]
    assert port.mgr.metrics["spillToDiskBytes"] == 4 * size
    assert _files(port) == 4  # s1's and s3's files, with sidecars
    assert port.mgr.spill_pressure() == pkgs[0].mgr.spill_pressure() == 1.0
    for s in port.sps:
        s.close()
    assert _files(port) == 0
    assert port.mgr._host_used == 0 and port.mgr._reserved == 0


# ---------------------------------------------------------------------------
# retry framework
# ---------------------------------------------------------------------------

def _retry(pkg, closure, **kw):
    return list(pkg.mod.with_retry([pkg.batch()], closure,
                                   manager=pkg.mgr, **kw))


def test_with_retry_retries_then_splits(tmp_path):
    outs = []
    for p in _pair(tmp_path):
        spilled = p.register(4)  # the retry spills it
        fails = {"n": 2}

        def closure(batch, p=p, fails=fails):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise p.mod.RetryOOM("transient")
            return batch.capacity

        outs.append((_retry(p, closure), spilled.tier, p.state()))
    # the second failure splits: two halves processed
    assert outs[0] == outs[1]
    assert outs[1][0] == [512, 512] and outs[1][1] == "host"
    assert outs[1][2][3]["splitRetries"] == 1


def test_with_retry_split_on_split_oom(tmp_path):
    outs = []
    for p in _pair(tmp_path):
        calls = {"n": 0}
        full = p.batch().capacity

        def closure(batch, p=p, calls=calls, full=full):
            calls["n"] += 1
            if batch.capacity > full // 2:
                raise p.mod.SplitAndRetryOOM("too big")
            return (batch.capacity, int(np.asarray(batch.sel).sum()))

        outs.append((_retry(p, closure), calls["n"], p.state()))
    assert outs[0] == outs[1]
    assert outs[1][0] == [(512, 100), (512, 0)]
    assert outs[1][2][3]["splitRetries"] == 1


def test_with_retry_exhausts(tmp_path):
    for p in _pair(tmp_path):
        calls = {"n": 0}

        def closure(batch, p=p, calls=calls):
            calls["n"] += 1
            raise p.mod.RetryOOM("always")

        with pytest.raises(p.mod.RetryOOM):
            _retry(p, closure, max_attempts=3, allow_split=False)
        assert calls["n"] == 3


def test_with_retry_defaults_to_the_conf_attempts(tmp_path):
    """``spark.rapids.tpu.retry.maxAttempts`` bounds the attempts when
    the caller passes none (the JAX package reads the same key through
    its retry policy)."""
    mgr = M.DeviceMemoryManager(budget=1 << 30, retry_max_attempts=2,
                                spill_path=str(tmp_path))
    calls = {"n": 0}

    def closure(batch):
        calls["n"] += 1
        raise M.RetryOOM("always")

    with pytest.raises(M.RetryOOM):
        list(M.with_retry([host_to_device(_table(), CPU)], closure,
                          manager=mgr, allow_split=False))
    assert calls["n"] == 2
    with pytest.raises(M.SplitAndRetryOOM, match="1-row"):
        M.split_batch_in_half(host_to_device(_table(n=1), CPU).with_sel(
            torch.ones(1, dtype=torch.bool)))


def test_split_batch_in_half_keeps_pow2_halves(tmp_path):
    jb, pb = jax_h2d(_table(3)), host_to_device(_table(3), CPU)
    for jh, ph in zip(JM.split_batch_in_half(jb), M.split_batch_in_half(pb)):
        assert jh.capacity == ph.capacity == 512
        for jc, pc in zip(jh.columns, ph.columns):
            assert np.array_equal(np.asarray(jc.data), pc.data.numpy())
        assert np.array_equal(np.asarray(jh.sel), ph.sel.numpy())


# ---------------------------------------------------------------------------
# bad restores and failed writes
# ---------------------------------------------------------------------------

def _bad_restore(pkg, spoil):
    sp, _ = _disk(pkg)
    spoil(sp._disk_path)
    err = (R.TerminalDeviceError if pkg.mod is JM
           else PR.TerminalDeviceError)
    with pytest.raises(err, match="spill_read") as ei:
        sp.get()
    sp.close()
    return (ei.value.domain, type(ei.value.cause).__name__,
            str(ei.value.cause), pkg.state())


def _flip_a_bit(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


def _garble(path):
    with open(path, "wb") as f:
        f.write(b"this is not an npz archive")


@pytest.mark.parametrize("spoil", [os.unlink, _garble, _flip_a_bit],
                         ids=["missing", "corrupt", "bitflip"])
def test_bad_restore_raises_spill_read(tmp_path, spoil):
    """A missing, garbled or bit-flipped spill file never restores: its
    retries exhaust and the ``TerminalDeviceError`` is tagged
    ``spill_read`` (never a bare FileNotFoundError), its cause is the
    JAX package's, and the state is the JAX package's."""
    jax, port = (_bad_restore(p, spoil) for p in _pair(tmp_path))
    assert jax[0] == port[0] == "spill_read"
    assert jax[1] == port[1] and jax[3] == port[3]
    if spoil is _flip_a_bit:
        assert "crc32" in port[2]
        # the paths differ; the message's shape does not
        assert jax[2].split(": ", 1)[1] == port[2].split(": ", 1)[1]


def test_failed_disk_write_keeps_the_host_copy(tmp_path):
    """A spill path that cannot be written (a file where the directory
    should be) makes the write fail with an OSError: its retries exhaust
    and the batch stays in the host tier (0 bytes freed, the
    ``spill_write`` domain's degrade), no partial file or sidecar is
    left, the host-limit eviction skips it, and its data restores
    intact."""
    root = tmp_path / "not-a-directory"
    root.write_text("")
    b = host_to_device(_table(9), CPU)
    size = b.nbytes()
    mgr = M.DeviceMemoryManager(budget=size, host_limit=size,
                                spill_path=str(root))
    ref = b.columns[0].data.clone()
    s1 = M.SpillableBatch(b, mgr)
    s1.spill_to_host()
    assert s1.spill_to_disk() == 0
    assert s1.tier == "host" and s1._disk_spill_failed
    assert s1._disk_path is None and not os.path.isdir(mgr.spill_path)
    assert mgr._host_used == size and mgr.metrics["spillToDiskBytes"] == 0
    # the tier is full: later host copies cannot push s1 to disk; each
    # victim's write fails once, is marked, and the loop ends
    s2 = M.SpillableBatch(host_to_device(_table(8), CPU), mgr)
    s3 = M.SpillableBatch(host_to_device(_table(7), CPU), mgr)  # s2 out
    assert not s2._disk_spill_failed  # s1 was skipped, s2 is the new one
    s3.spill_to_host()  # s2's write fails now
    assert [s.tier for s in (s1, s2, s3)] == ["host"] * 3
    assert s2._disk_spill_failed and not s3._disk_spill_failed
    assert mgr._host_used == 3 * size and mgr._reserved == 0
    assert torch.equal(s1.get().columns[0].data, ref)
    assert mgr._host_used == 2 * size
    for s in (s1, s2, s3):
        s.close()
    assert mgr._host_used == 0 and mgr._reserved == 0


# ---------------------------------------------------------------------------
# spill-file integrity (CRC32 sidecar) + per-process spill directories
# ---------------------------------------------------------------------------

def test_spill_writes_crc_sidecar(tmp_path):
    for p in _pair(tmp_path):
        sp, ref = _disk(p)
        sidecar = sp._disk_path + ".crc32"
        with open(sidecar) as f:
            assert int(f.read().strip(), 16) == p.mod._file_crc32(
                sp._disk_path)
        out = sp.get()  # a clean restore removes payload AND sidecar
        assert np.array_equal(_col(out, 0), ref)
        assert not os.path.exists(sidecar)
        sp.close()


def test_close_removes_spill_file_and_sidecar(tmp_path):
    for p in _pair(tmp_path):
        sp, _ = _disk(p)
        path = sp._disk_path
        sp.close()
        assert not os.path.exists(path)
        assert not os.path.exists(path + ".crc32")
        assert sp.tier == "disk" and sp._disk_path is None


def test_per_process_spill_subdirectory(tmp_path):
    for mod in (JM, M):
        mgr = mod.DeviceMemoryManager(budget=1 << 30,
                                      spill_path=str(tmp_path))
        assert mgr.spill_root == str(tmp_path)
        assert os.path.dirname(mgr.spill_path) == str(tmp_path)
        base = os.path.basename(mgr.spill_path)
        assert base.startswith(f"proc-{os.getpid()}-")
        assert len(base) == len(f"proc-{os.getpid()}-") + 8
        assert mgr.spill_path in mod._SPILL_DIRS
        assert not os.path.exists(mgr.spill_path)  # made at first spill
        other = mod.DeviceMemoryManager(budget=1 << 30,
                                        spill_path=str(tmp_path))
        assert other.spill_path != mgr.spill_path


def test_spill_dir_cleanup_hook(tmp_path):
    for p in _pair(tmp_path):
        sp, _ = _disk(p)
        assert os.listdir(p.mgr.spill_path)
        p.mod._cleanup_spill_dirs()  # what atexit runs
        assert not os.path.exists(p.mgr.spill_path)
        assert not p.mod._SPILL_DIRS
        p.mgr._spillables.clear()  # the batch's file is gone with the dir


def test_get_manager_stable_across_same_conf(tmp_path):
    """The replace-on-change check compares the configured ROOT, not
    the instance subdirectory; a changed root, retry bound or debug
    flag replaces the arbiter, as in the JAX package."""
    def confs(**extra):
        raw = dict({"spark.rapids.tpu.spillPath": str(tmp_path)}, **extra)
        return (TpuSession(raw, device="cpu").rapids_conf(),
                JaxSession(raw).rapids_conf())

    for change in ({"spark.rapids.tpu.spillPath": str(tmp_path / "x")},
                   {"spark.rapids.tpu.retry.maxAttempts": 2}):
        port_a = M.get_manager(confs()[0], CPU)
        jax_a = JM.get_manager(confs()[1])
        assert M.get_manager(confs()[0], CPU) is port_a
        assert JM.get_manager(confs()[1]) is jax_a
        port_b = M.get_manager(confs(**change)[0], CPU)
        jax_b = JM.get_manager(confs(**change)[1])
        assert (port_b is port_a) == (jax_b is jax_a) is False


# ---------------------------------------------------------------------------
# the leak tracker (``tests/test_observability.py``)
# ---------------------------------------------------------------------------

def test_leak_tracker_reports_unclosed(tmp_path, capsys):
    for p in _pair(tmp_path, debug=True):
        atexit.unregister(p.mgr.report_leaks)
        sp = p.register(2)
        leaks = p.mgr.leaked()
        assert len(leaks) == 1 and leaks[0][0] is sp
        assert "test_torch_disk_spill" in leaks[0][1]  # creation stack
        assert p.mgr.report_leaks() == 1
        assert "LEAK DETECTED: spillable batch" in capsys.readouterr().out
        sp.close()
        assert p.mgr.leaked() == []
        # reclaim_all closes what is left, disk files included
        _disk(p)
        p.register(3)
        assert p.mgr.reclaim_all() == 2
        assert p.mgr.report_leaks() == 0 and p.mgr._reserved == 0
        assert not os.listdir(p.mgr.spill_path)


def test_leak_tracker_excludes_scan_cache():
    t = pa.table({"k": pa.array(np.arange(1000) % 7),
                  "v": pa.array(np.arange(1000))})
    conf = {"spark.rapids.memory.gpu.debug": "STDOUT"}
    for mod, session in ((M, TpuSession(dict(conf), device="cpu")),
                         (JM, JaxSession(dict(conf)))):
        session.createDataFrame(t).groupBy("k").count().toArrow()
        mgr = mod.get_manager()
        atexit.unregister(mgr.report_leaks)
        assert mgr.debug
        # the scan cache's registrations are pinned, not leaks
        assert mgr.leaked() == []
        assert len(mgr.leaked(include_pinned=True)) == 1


# ---------------------------------------------------------------------------
# the injector armed at the spill tier's two IO sites
# (``tests/test_memory.py``'s cases that arm ``R.INJECTOR``)
# ---------------------------------------------------------------------------

def _injector(pkg):
    return (R if pkg.mod is JM else PR).INJECTOR


def test_disk_restore_transient_injection_recovers(tmp_path):
    """One transient ``spill_read`` fault: the restore retries and
    returns the data; the state is the JAX package's."""
    out = []
    for pkg in _pair(tmp_path):
        sp, ref = _disk(pkg)
        _injector(pkg).configure({"spill_read": (1, 1)})
        got = _col(sp.get(), 0)
        assert np.array_equal(got, ref)
        assert not _injector(pkg).armed  # the one fire was spent
        out.append(pkg.state())
        sp.close()
    assert out[0] == out[1]


def test_spill_write_terminal_fault_keeps_host_copy(tmp_path):
    """A terminal ``spill_write`` fault degrades: the batch stays in the
    host tier (0 bytes freed), marked so that the eviction skips it, no
    partial file or sidecar is left, and the data restores intact — in
    both packages, with the same state."""
    out = []
    for pkg in _pair(tmp_path):
        sp = pkg.register(9)
        ref = _col(sp.get(), 0).copy()
        sp.spill_to_host()
        _injector(pkg).configure({"spill_write": (1, 0)})
        assert sp.spill_to_disk() == 0
        assert sp.tier == "host" and sp._disk_spill_failed
        assert _files(pkg) == 0
        out.append(pkg.state())
        assert np.array_equal(_col(sp.get(), 0), ref)
        sp.close()
    assert out[0] == out[1]
