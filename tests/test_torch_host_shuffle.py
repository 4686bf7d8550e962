"""The port's MULTITHREADED host shuffle (``native/``, ``shuffle/``)
against the JAX package's.

* On the views of the JAX package's ``tests/test_host_shuffle.py`` (a
  nullable long, a double and a string column; the same seed), the
  port's native serializer (threaded gather and single-thread scatter),
  its plain numpy twin ``_py_serialize_partitions`` and the JAX
  package's native serializer give byte-identical buffers, and every
  buffer deserializes back to exactly the rows it was given.
* ``TpuHostShuffleExchangeExec`` (on the CPU) gives every partition's
  rows in the order of the port's in-process exchange and of the JAX
  package's host exchange, with the JAX package's ``bytesWritten``.
* Shuffle files are gone once the plan is dropped; a missing ``g++`` or
  a failed build raises with the compiler's output.
"""

import gc
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar import host as JH
from spark_rapids_tpu.shuffle import serializer as JSER
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import native as NAT
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.shuffle import serializer as SER
from spark_rapids_tpu_torch.shuffle.manager import ShuffleEnv
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
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()
    M.reset_manager()


def _arrays():
    """``tests/test_host_shuffle.py::_views``'s data."""
    n = 1000
    rng = np.random.default_rng(11)
    ints = rng.integers(-1000, 1000, n)
    ivalid = rng.random(n) > 0.1
    dbl = rng.uniform(-5, 5, n)
    strs = [f"s{i % 37}" * (i % 4) for i in range(n)]
    lens = np.array([len(s) for s in strs], np.int32)
    mat = np.zeros((n, max(int(lens.max()), 1)), np.uint8)
    for i, s in enumerate(strs):
        mat[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
    return ints, ivalid, dbl, strs, lens, mat


def _views(ser, t):
    ints, ivalid, dbl, _, lens, mat = _arrays()
    return [ser.HostColView(t.LongT, ints, ivalid, None),
            ser.HostColView(t.DoubleT, dbl, None, None),
            ser.HostColView(t.StringT, mat, None, lens)]


SCHEMA = T.StructType((T.StructField("i", T.LongT),
                       T.StructField("d", T.DoubleT),
                       T.StructField("s", T.StringT)))


@pytest.mark.parametrize("nthreads", [1, 3])
@pytest.mark.parametrize("nparts", [1, 3, 5, 16])
def test_serializers_byte_identical_to_each_other_and_jax(nparts, nthreads):
    cols = _views(SER, T)
    n = cols[0].data.shape[0]
    pids = (np.arange(n) * 7 % nparts).astype(np.int32)
    live = np.arange(n) % 13 != 0
    native = SER.serialize_partitions(cols, pids, live, nparts, nthreads)
    plain = SER._py_serialize_partitions(cols, pids, live.astype(np.uint8),
                                         nparts)
    assert JSER.native_enabled()
    jax = JSER.serialize_partitions(_views(JSER, JT), pids, live, nparts,
                                    nthreads)
    assert len(native) == len(plain) == len(jax) == nparts
    for a, b, c in zip(native, plain, jax):
        assert bytes(a) == bytes(b) == bytes(c)


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
def test_round_trip_is_exact(native):
    ints, ivalid, dbl, strs, lens, _ = _arrays()
    cols = _views(SER, T)
    n, nparts = len(ints), 5
    pids = (np.arange(n) * 7 % nparts).astype(np.int32)
    live = np.arange(n) % 13 != 0
    bufs = (SER.serialize_partitions(cols, pids, live, nparts, 3) if native
            else SER._py_serialize_partitions(cols, pids,
                                              live.astype(np.uint8), nparts))
    rows = 0
    for p in range(nparts):
        nrows, out = SER.deserialize(bufs[p], SCHEMA)
        idx = np.nonzero(live & (pids == p))[0]
        assert nrows == len(idx)
        rows += nrows
        np.testing.assert_array_equal(out[0].data, ints[idx])
        np.testing.assert_array_equal(out[0].validity.astype(bool),
                                      ivalid[idx])
        np.testing.assert_array_equal(out[1].data, dbl[idx])
        assert out[1].validity is None
        np.testing.assert_array_equal(out[2].lengths, lens[idx])
        for k, i in enumerate(idx):
            assert bytes(out[2].data[k, :lens[i]]) == strs[i].encode()
    assert rows == int(live.sum())


def _table(n=4000, seed=5):
    """``tests/test_host_shuffle.py::_shuffle_table`` plus a bool, a
    date and an int column."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n)),
        "v": pa.array(rng.uniform(-100, 100, n)),
        "s": pa.array([None if i % 19 == 0 else f"name{i % 23}"
                       for i in range(n)]),
        "b": pa.array(rng.random(n) > 0.5, mask=np.arange(n) % 7 == 0),
        "t": pa.array(rng.integers(0, 20000, n).astype(np.int32)
                      ).cast(pa.date32()),
        "x": pa.array(rng.integers(-9, 9, n).astype(np.int32))})


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _partitions(df, to_arrow):
    plan = df._execute_plan()
    return plan, [[repr(r) for b in plan.execute(p)
                   for r in to_arrow(b).to_pylist()]
                  for p in range(plan.num_partitions())]


CONF = {"spark.default.parallelism": 3, "spark.rapids.tpu.batchRows": 1024,
        "spark.sql.adaptive.enabled": False,
        "spark.rapids.shuffle.multiThreaded.writer.threads": 2}


@pytest.mark.parametrize("nparts", [3, 16])
@pytest.mark.parametrize("keys", [("k",), ("s",), ("x", "b", "t"), ()],
                         ids=lambda k: "+".join(k) or "rr")
def test_host_exchange_rows_and_bytes_equal_jax(keys, nparts):
    t = _table()
    host = dict(CONF, **{"spark.rapids.shuffle.mode": "MULTITHREADED"})
    inproc = dict(CONF, **{"spark.rapids.shuffle.mode": "CACHE_ONLY"})
    pdf = TpuSession(dict(host), device="cpu").createDataFrame(t) \
        .repartition(nparts, *keys)
    plan, got = _partitions(pdf, PH.to_arrow_table)
    jdf = JaxSession(dict(host)).createDataFrame(t) \
        .repartition(nparts, *keys)
    jplan, want = _partitions(jdf, JH.to_arrow_table)
    _, inproc_rows = _partitions(
        TpuSession(dict(inproc), device="cpu").createDataFrame(t)
        .repartition(nparts, *keys), PH.to_arrow_table)
    assert got == want == inproc_rows
    assert sum(len(p) for p in got) == t.num_rows
    ex = _find(plan, "TpuHostShuffleExchangeExec")
    jex = _find(jplan, "TpuHostShuffleExchangeExec")
    assert ex.nthreads == 2
    assert plan.tree_string() == jplan.tree_string()
    assert ex.metric("bytesWritten").value == jex.metric(
        "bytesWritten").value > 0
    assert ex.metric("numOutputRows").value == t.num_rows


def test_shuffle_files_die_with_the_plan():
    t = _table(1000)
    s = TpuSession({"spark.rapids.shuffle.mode": "MULTITHREADED"},
                   device="cpu")
    env = ShuffleEnv.get()
    before = env.metrics["bytesRead"]
    df = s.createDataFrame(t).repartition(4, "k")
    assert df.toArrow().num_rows == t.num_rows
    ex = _find(df._last_plan, "TpuHostShuffleExchangeExec")
    path = env.shuffle_dir(ex._shuffle_id)
    assert sorted(os.listdir(path)) == ["map-0.tudo"]
    assert env.metrics["bytesRead"] > before
    del ex, df
    gc.collect()
    assert not os.path.exists(path)


@pytest.fixture()
def fresh_native(monkeypatch, tmp_path):
    """No library loaded or built yet: builds go to ``tmp_path``."""
    monkeypatch.setattr(NAT, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(NAT, "_libs", {})
    monkeypatch.setattr(SER, "_lib", None)
    return tmp_path


def test_missing_compiler_raises(fresh_native, monkeypatch):
    monkeypatch.setattr(NAT.shutil, "which", lambda name: None)
    cols = _views(SER, T)
    pids = np.zeros(cols[0].data.shape[0], np.int32)
    with pytest.raises(RuntimeError, match="g..? not found"):
        SER.serialize_partitions(cols, pids, None, 2)


def test_failed_build_raises_with_the_compiler_output(fresh_native,
                                                      monkeypatch):
    src = fresh_native / "src"
    src.mkdir()
    (src / "tudo.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(NAT, "_SRC_DIR", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building "
                       "tudo.cpp(.|\\n)*error"):
        NAT.load_library("tudo")


def test_build_goes_to_the_build_dir_once(fresh_native):
    first = NAT.build("tudo")
    assert first.parent == fresh_native / "native"
    assert first.name.startswith("libtudo_") and first.suffix == ".so"
    stamp = first.stat().st_mtime_ns
    assert NAT.build("tudo") == first
    assert first.stat().st_mtime_ns == stamp
