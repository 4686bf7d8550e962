"""The port's exchange plane (``exec/exchange.py``, ``exec/aqe.py``)
against the JAX package's on the same seeded inputs.

* For hash exchanges on an int, a long, a double (NaN, -0.0 and 0.0
  among its values), a string with nulls and two keys, and for the
  round-robin exchange, at 1, 3 and 16 partitions, every output
  partition's rows, in order, from the port's ``TpuShuffleExchangeExec``
  (on the CPU) and ``CpuShuffleExchangeExec`` equal the JAX package's
  device and CPU exchanges' (exactly: the rows' ``repr``).
* ``TpuAQEShuffleReadExec``'s read specs, ``num_partitions()`` and its
  ``coalescedReads`` / ``splitSkewedPartitions`` equal the JAX
  package's under the confs of the JAX package's AQE tests (coalesced
  tiny partitions, the split machinery, a hash exchange over one hot
  key that must not split, a round-robin one that does, AQE off),
  over both transports.
* ``spark.rapids.sql.exec.ShuffleExchange=false`` gives the JAX
  package's fallback report line for line and its result; test mode
  raises the JAX package's error unless the exec is allowed.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.columnar import host as JH
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = {"spark.default.parallelism": 2, "spark.rapids.tpu.batchRows": 512}
KEYS = [("i",), ("l",), ("d",), ("s",), ("i", "s"), ()]


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()
    M.reset_manager()


def _table(n=1500, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n)
    d[::17] = np.nan
    d[::23] = -0.0
    d[::29] = 0.0
    return pa.table({
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=np.arange(n) % 11 == 0),
        "l": pa.array(rng.integers(-2 ** 40, 2 ** 40, n)),
        "d": pa.array(d),
        "s": pa.array([None if k % 13 == 0 else f"v{k % 41}" * (k % 5)
                       for k in range(n)], type=pa.string())})


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _partitions(df, to_arrow):
    """Each output partition's rows of the planned ``df``, in order."""
    plan = df._execute_plan()
    return [[repr(r) for b in plan.execute(p)
             for r in to_arrow(b).to_pylist()]
            for p in range(plan.num_partitions())]


@pytest.mark.parametrize("nparts", [1, 3, 16])
@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "+".join(k) or "rr")
def test_partition_rows_equal_jax(keys, nparts):
    t = _table()
    conf = dict(BASE, **{"spark.rapids.shuffle.mode": "CACHE_ONLY",
                         "spark.sql.adaptive.enabled": False})
    cpu = dict(conf, **{"spark.rapids.sql.enabled": False})
    want = _partitions(JaxSession(dict(conf)).createDataFrame(t)
                       .repartition(nparts, *keys), JH.to_arrow_table)
    pdf = TpuSession(dict(conf), device="cpu").createDataFrame(t) \
        .repartition(nparts, *keys)
    got = _partitions(pdf, PH.to_arrow_table)
    assert _find(pdf._last_override.plan, "TpuShuffleExchangeExec")
    assert got == want
    assert sum(len(p) for p in got) == t.num_rows
    assert len(got) == nparts
    want_cpu = _partitions(JaxSession(dict(cpu)).createDataFrame(t)
                           .repartition(nparts, *keys), JH.to_arrow_table)
    got_cpu = _partitions(TpuSession(dict(cpu), device="cpu")
                          .createDataFrame(t).repartition(nparts, *keys),
                          PH.to_arrow_table)
    assert got_cpu == want_cpu == want


def _aqe_nodes(df):
    df.toArrow()
    return _find(df._last_plan, "TpuAQEShuffleReadExec")


def _aqe_state(aqe):
    return (aqe._specs, aqe.num_partitions(),
            aqe.metrics["coalescedReads"].value,
            aqe.metric("splitSkewedPartitions").value)


def _skew_table(n=4000):
    return pa.table({"k": pa.array(np.zeros(n, dtype=np.int32)),
                     "v": pa.array(np.arange(n, dtype=np.float64))})


AQE_CASES = {
    # 64 tiny partitions, a large advisory size: few coalesced reads
    "coalesce": (lambda: pa.table({
        "k": pa.array(np.arange(1000, dtype=np.int64) % 97),
        "v": pa.array(np.ones(1000))}),
        {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 20},
        (64, "k")),
    # one hot key under a tiny advisory size: a hash exchange coalesces
    # only, it never splits a key's rows
    "hash_hot_key": (_skew_table,
                     {"spark.sql.adaptive.advisoryPartitionSizeInBytes":
                      1000}, (8, "k")),
    # a round-robin exchange of oversized partitions splits them
    "roundrobin_split": (_skew_table,
                         {"spark.sql.adaptive.advisoryPartitionSizeInBytes":
                          4000}, (3,)),
    # a string key: rows coalesce by the row estimate on the device
    # exchange and by serialized bytes on the host one
    "string_key": (_table,
                   {"spark.sql.adaptive.advisoryPartitionSizeInBytes":
                    20000}, (16, "s")),
}


@pytest.mark.parametrize("mode", ["CACHE_ONLY", "MULTITHREADED"])
@pytest.mark.parametrize("case", list(AQE_CASES))
def test_aqe_read_specs_equal_jax(case, mode):
    make, conf, args = AQE_CASES[case]
    t = make()
    conf = dict(conf, **{"spark.rapids.shuffle.mode": mode})
    jdf = JaxSession(dict(conf)).createDataFrame(t).repartition(*args)
    pdf = TpuSession(dict(conf), device="cpu").createDataFrame(t) \
        .repartition(*args)
    want, got = _aqe_nodes(jdf), _aqe_nodes(pdf)
    assert got is not None and want is not None
    assert _aqe_state(got) == _aqe_state(want)
    if case == "hash_hot_key":
        assert got.metric("splitSkewedPartitions").value == 0
    if case == "roundrobin_split":
        assert got.metric("splitSkewedPartitions").value > 0
    if case == "coalesce":
        assert got.num_partitions() < 64
    assert _partitions(pdf, PH.to_arrow_table) == _partitions(
        jdf, JH.to_arrow_table)


def test_aqe_split_machinery_exact_rows():
    """The JAX package's direct drive of the split machinery: a scan, a
    hash exchange over one key and a read that may split."""
    from spark_rapids_tpu.exec.aqe import TpuAQEShuffleReadExec as JAqe
    from spark_rapids_tpu.exec.basic import TpuScanExec as JScan
    from spark_rapids_tpu.exec.exchange import TpuShuffleExchangeExec as JEx
    from spark_rapids_tpu.plan.analysis import resolve as jresolve
    from spark_rapids_tpu.sql.column import UExpr as JUExpr
    from spark_rapids_tpu.columnar.column import device_to_host as jd2h
    import torch
    from spark_rapids_tpu_torch.columnar.column import device_to_host
    from spark_rapids_tpu_torch.exec.aqe import TpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.plan.analysis import resolve
    from spark_rapids_tpu_torch.sql.column import UExpr

    n = 5000
    t = pa.table({"k": pa.array(np.zeros(n, dtype=np.int64)),
                  "v": pa.array(np.arange(n, dtype=np.float64))})
    jschema = JaxSession().createDataFrame(t).schema
    jaqe = JAqe(JEx(JScan(t, jschema, 1), 8,
                    [jresolve(JUExpr("attr", "k"), jschema)]),
                target_bytes=1000 * 18, row_bytes=18, allow_split=True)
    schema = TpuSession(device="cpu").createDataFrame(t).schema
    aqe = TpuAQEShuffleReadExec(
        TpuShuffleExchangeExec(
            B.TpuScanExec(t, schema, torch.device("cpu"), 1), 8,
            [resolve(UExpr("attr", "k"), schema)]),
        target_bytes=1000 * 18, row_bytes=18, allow_split=True)
    got = [[device_to_host(b).column("v").to_pylist()
            for b in aqe.execute(p)] for p in range(aqe.num_partitions())]
    want = [[jd2h(b).column("v").to_pylist() for b in jaqe.execute(p)]
            for p in range(jaqe.num_partitions())]
    assert got == want
    assert aqe._specs == jaqe._specs
    assert aqe.metrics["splitSkewedPartitions"].value == 1
    assert sorted(v for p in got for b in p for v in b) == \
        t.column("v").to_pylist()


@pytest.mark.parametrize("mode", ["CACHE_ONLY", "MULTITHREADED"])
def test_aqe_off_keeps_partitions(mode):
    t = pa.table({"k": pa.array(np.arange(100, dtype=np.int64))})
    conf = {"spark.sql.adaptive.enabled": False,
            "spark.rapids.shuffle.mode": mode}
    df = TpuSession(dict(conf), device="cpu").createDataFrame(t) \
        .repartition(16, "k")
    df.toArrow()
    jdf = JaxSession(dict(conf)).createDataFrame(t).repartition(16, "k")
    jdf.toArrow()
    assert _find(df._last_plan, "TpuAQEShuffleReadExec") is None
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    assert df._last_plan.children[0].num_partitions() == 16


@pytest.mark.parametrize("mode, aqe", [("MULTITHREADED", True),
                                       ("CACHE_ONLY", True),
                                       ("MULTITHREADED", False),
                                       ("CACHE_ONLY", False)])
def test_plan_tree_equals_jax(mode, aqe):
    """The plan the rewrite builds for a repartitioned aggregate reads
    as the JAX package's, line for line, after execution."""
    t = _table()
    conf = dict(BASE, **{"spark.rapids.shuffle.mode": mode,
                         "spark.sql.adaptive.enabled": aqe})
    build = (lambda s: s.createDataFrame(t).repartition(5, "s")
             .groupBy("i").agg(F.sum("d").alias("sd"),
                               F.count("*").alias("c")))
    from spark_rapids_tpu.sql import functions as JF
    jdf = (JaxSession(dict(conf)).createDataFrame(t).repartition(5, "s")
           .groupBy("i").agg(JF.sum("d").alias("sd"),
                             JF.count("*").alias("c")))
    df = build(TpuSession(dict(conf), device="cpu"))
    got, want = df.toArrow(), jdf.toArrow()
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    assert bench._rows_equal(got, want, tol=1e-12)


def _exchange_query(s, t):
    return s.createDataFrame(t).repartition(4, "l").select("i", "s")


def test_kill_switch_report_and_result_equal_jax():
    t = _table()
    conf = dict(BASE, **{"spark.rapids.sql.exec.ShuffleExchange": False})
    df = _exchange_query(TpuSession(dict(conf), device="cpu"), t)
    jdf = _exchange_query(JaxSession(dict(conf)), t)
    got, want = df.toArrow(), jdf.toArrow()
    report = df._last_override.fallback_report()
    assert report == jdf._last_override.fallback_report()
    assert report == [
        "!Exec <CpuShuffleExchangeExec> cannot run on TPU because exec "
        "ShuffleExchange disabled by "
        "spark.rapids.sql.exec.ShuffleExchange=false"]
    assert got.equals(want)
    assert df.fallback_summary() == jdf.fallback_summary()
    assert "DeviceToHostExec" in df._last_plan.tree_string()


def test_test_mode_raises_as_jax_unless_allowed():
    t = _table()
    conf = dict(BASE, **{"spark.rapids.sql.exec.ShuffleExchange": False,
                         "spark.rapids.sql.test.enabled": True})
    with pytest.raises(AssertionError) as got:
        _exchange_query(TpuSession(dict(conf), device="cpu"), t).toArrow()
    with pytest.raises(AssertionError) as want:
        _exchange_query(JaxSession(dict(conf)), t).toArrow()
    assert str(got.value) == str(want.value)
    for allowed in ("CpuShuffleExchangeExec", "ShuffleExchange"):
        ok = dict(conf, **{"spark.rapids.sql.test.allowedNonGpu": allowed})
        out = _exchange_query(TpuSession(dict(ok), device="cpu"), t)
        assert out.toArrow().equals(
            _exchange_query(JaxSession(dict(ok)), t).toArrow())


@pytest.mark.parametrize("mode, aqe", [("MULTITHREADED", True),
                                       ("MULTITHREADED", False),
                                       ("CACHE_ONLY", True),
                                       ("CACHE_ONLY", False)])
def test_empty_input_through_every_transport(mode, aqe):
    """No row reaches the reads (a host read of an empty range yields no
    batch at all): grouped, global and joined consumers still answer as
    the JAX package does."""
    t = _table(0)
    conf = {"spark.rapids.shuffle.mode": mode,
            "spark.sql.adaptive.enabled": aqe}
    from spark_rapids_tpu.sql import functions as JF

    def queries(s, f):
        df = s.createDataFrame(t).repartition(4, "s")
        return [df.groupBy("i").agg(f.sum("d").alias("sd")),
                df.agg(f.count("*").alias("c"), f.sum("l").alias("sl")),
                df.join(s.createDataFrame(_table(50)), on="s", how="left")]

    got = [q.toArrow() for q in queries(
        TpuSession(dict(conf), device="cpu"), F)]
    want = [q.toArrow() for q in queries(JaxSession(dict(conf)), JF)]
    assert [g.num_rows for g in got] == [0, 1, 0]
    for g, w in zip(got, want):
        assert g.equals(w)
