"""collect_list and collect_set in the port against the JAX package.

* Every collect case of ``tests/test_agg_breadth.py`` (grouped lists, a
  list that skips nulls with an all-null group, lists beside other
  aggregates, double elements, the device plan, the string-input
  fallback, ``collect_set`` against the oracle, the global list and the
  global list over an empty input) runs through the port's session
  (``device="cpu"``) and the JAX package's under the same conf:
  results, tree strings and fallback reports equal; the CPU sessions of
  both give equal results too.  Added here: a set over -0.0, 0.0, NaN
  and infinities, lists over several batches (``batchRows`` 512) and
  four partitions, lists of dates and booleans, and a list keyed by a
  struct.
* ``segment_collect`` (lists and sets) and ``segment_max_group_count``
  equal the JAX package's functions bit for bit on random keys with
  nulls, dead rows and values with NaN, -0.0 and nulls, on the exact
  key layout and on the wide keys' tuple-hash layout.

Lists keep the input order and sets the value order, so every value is
compared exactly (by ``repr``); only the row order of a grouped result
is free.  Each JAX run is made once per module (``jax_run``).
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import column as JC
from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.exec import aggregate as JAG
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import aggregate as AG
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
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


def _t(n=3000, seed=21, nulls=True):
    """``tests/test_agg_breadth.py::_t``."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-100, 100, n)
    vals = [None if nulls and i % 13 == 0 else float(v[i])
            for i in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 20, n)),
        "v": pa.array(vals, pa.float64()),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
    })


def _set_table():
    """``test_collect_set_matches_oracle``'s table."""
    rng = np.random.default_rng(61)
    n = 4000
    return pa.table({
        "k": pa.array(rng.integers(0, 12, n)),
        "v": pa.array(np.where(rng.random(n) < 0.1, None,
                               rng.integers(0, 25, n).astype("float64"))),
    })


def _global_table():
    rng = np.random.default_rng(3)
    return pa.table({"v": pa.array(
        [None if i % 7 == 0 else int(rng.integers(0, 50))
         for i in range(400)], pa.int64())})


def _edges():
    vals = [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5,
            None, -0.0, float("nan"), 1.5]
    return pa.table({"k": pa.array([i % 3 for i in range(30)]),
                     "v": pa.array(vals * 3, pa.float64())})


def _typed():
    d = datetime.date(1994, 1, 1)
    rng = np.random.default_rng(8)
    n = 300
    return pa.table({
        "k": pa.array(rng.integers(0, 7, n)),
        "d": pa.array([None if i % 9 == 0 else
                       d + datetime.timedelta(int(rng.integers(0, 900)))
                       for i in range(n)], pa.date32()),
        "b": pa.array([None if i % 5 == 0 else bool(i % 3)
                       for i in range(n)]),
    })


def _struct_keyed():
    rng = np.random.default_rng(12)
    n = 500
    s = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 4, n)),
         pa.array(rng.choice(["x", "yy", "zzz"], n))], names=["a", "b"])
    return pa.table({"s": s, "v": pa.array(rng.integers(0, 99, n))})


T800, T500, T400, T300 = _t(800), _t(500), _t(400), _t(300)
SET, GLOBAL, EDGES, TYPED, SKEY = (_set_table(), _global_table(), _edges(),
                                   _typed(), _struct_keyed())
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
MULTI = dict(TEST, **{"spark.rapids.tpu.batchRows": 512,
                      "spark.default.parallelism": 4})

# name: (build(session, F, col), conf)
CASES = {
    "collect_list_grouped": (
        lambda s, F, c: s.createDataFrame(T800).groupBy("k").agg(
            F.collect_list(c("i")).alias("xs")), TEST),
    "collect_list_skips_nulls_empty_ok": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "k": pa.array([1, 1, 2, 3, 3]),
            "x": pa.array([7, None, None, 1, 2], pa.int64())}))
        .groupBy("k").agg(F.collect_list(c("x")).alias("xs")), TEST),
    "collect_list_with_other_aggs": (
        lambda s, F, c: s.createDataFrame(T500).groupBy("k").agg(
            F.count("*").alias("c"), F.collect_list(c("i")).alias("xs"),
            F.max("i").alias("mx")), TEST),
    "collect_list_double_elements": (
        lambda s, F, c: s.createDataFrame(T400).groupBy("k").agg(
            F.collect_list(c("v")).alias("xs")), TEST),
    "collect_list_on_device": (
        lambda s, F, c: s.createDataFrame(T300).groupBy("k").agg(
            F.collect_list(c("i")).alias("xs")), TEST),
    "collect_list_string_falls_back": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "k": pa.array([1, 1, 2]), "s": pa.array(["a", "b", "c"])}))
        .groupBy("k").agg(F.collect_list(c("s")).alias("xs")),
        dict(TEST, **{"spark.rapids.sql.test.allowedNonGpu":
                      "HashAggregate,InMemoryScan"})),
    "collect_set_matches_oracle": (
        lambda s, F, c: s.createDataFrame(SET).groupBy("k")
        .agg(F.collect_set("v").alias("cs")), TEST),
    "global_collect_list": (
        lambda s, F, c: s.createDataFrame(GLOBAL).agg(
            F.collect_list(c("v")).alias("l")), TEST),
    "global_collect_list_empty": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "v": pa.array([], pa.int64())})).agg(
            F.collect_list(c("v")).alias("l")), TEST),
    "collect_set_signed_zero_nan": (
        lambda s, F, c: s.createDataFrame(EDGES).groupBy("k").agg(
            F.collect_set("v").alias("cs"), F.collect_list("v").alias("cl")),
        TEST),
    "collect_multi_batch_parallelism_4": (
        lambda s, F, c: s.createDataFrame(T800).groupBy("k").agg(
            F.collect_list("i").alias("l"), F.collect_set("i").alias("st"),
            F.sum("i").alias("si")), MULTI),
    "collect_dates_and_booleans": (
        lambda s, F, c: s.createDataFrame(TYPED).groupBy("k").agg(
            F.collect_list("d").alias("ld"), F.collect_set("d").alias("sd"),
            F.collect_list("b").alias("lb")), TEST),
    "collect_list_by_struct_key": (
        lambda s, F, c: s.createDataFrame(SKEY).groupBy("s").agg(
            F.collect_list("v").alias("l"), F.count("*").alias("n")), TEST),
}



@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol).toArrow(), None, None)
            else:
                df = build(JaxSession(dict(conf)), JF, jcol)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


def same_rows(got: pa.Table, want: pa.Table) -> None:
    """Equal schemas and row multisets, every value by ``repr``."""
    assert got.schema == want.schema
    assert sorted(repr(r) for r in got.to_pylist()) == sorted(
        repr(r) for r in want.to_pylist())


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=True)[0])


def test_what_the_jax_tests_pin(jax_run):
    """Groups hold more than one value; the collect runs on the device
    (a ``TpuHashAggregate``); the string input falls back; the global
    list over an empty input is one empty list."""
    got = jax_run("collect_list_grouped")[0]
    assert any(len(r["xs"]) > 1 for r in got.to_pylist())
    assert "TpuHashAggregate" in jax_run("collect_list_on_device")[2]
    assert any("collect_list over string" in r
               for r in jax_run("collect_list_string_falls_back")[1])
    assert jax_run("global_collect_list_empty")[0].to_pylist() == [
        {"l": []}]


# ---------------------------------------------------------------------------
# The device functions against the JAX package's, bit for bit
# ---------------------------------------------------------------------------

def _inputs(n_keys: int, b=2048, seed=5):
    """Key columns (int64 with nulls), a live mask with dead rows, and
    a float64 value column with NaN, -0.0, duplicates and nulls."""
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(n_keys):
        data = rng.integers(0, 6 if i else 40, b).astype(np.int64)
        valid = rng.random(b) > 0.05
        keys.append((np.where(valid, data, 0), valid))
    sel = rng.random(b) > 0.1
    vals = rng.choice([np.nan, -0.0, 0.0, 1.0, 2.5, -3.0, 7.0, 1e300], b)
    vvalid = rng.random(b) > 0.1
    return keys, sel, (np.where(vvalid, vals, 0.0), vvalid)


def _both(keys, value):
    mine = [DeviceColumn(T.LongT, torch.from_numpy(d), torch.from_numpy(v))
            for d, v in keys]
    theirs = [JC.DeviceColumn(JT.LongT, jnp.asarray(d), jnp.asarray(v))
              for d, v in keys]
    d, v = value
    return (mine, theirs,
            DeviceColumn(T.DoubleT, torch.from_numpy(d),
                         torch.from_numpy(v)),
            JC.DeviceColumn(JT.DoubleT, jnp.asarray(d), jnp.asarray(v)))


@pytest.mark.parametrize("n_keys", [1, 4])
@pytest.mark.parametrize("distinct", [False, True])
def test_segment_collect_equals_jax(n_keys, distinct):
    """One key takes the exact layout; four int64 keys (over three fused
    limbs) the 128-bit tuple hash."""
    keys, sel, value = _inputs(n_keys)
    mine, theirs, v, jv = _both(keys, value)
    tsel = torch.from_numpy(sel)
    jsel = jnp.asarray(sel)
    most = int(AG.segment_max_group_count(mine, tsel, [v.valid_mask()]))
    # jitted: the JAX functions run op by op for ~15 s eager
    jmost = int(np.asarray(jax.jit(JAG.segment_max_group_count)(
        theirs, jsel, [jv.valid_mask()])))
    assert most == jmost > 1
    cap = 1 << (most - 1).bit_length()
    mat, lens = AG.segment_collect(mine, tsel, v, cap, distinct=distinct)
    jmat, jlens = jax.jit(lambda k, s_, x: JAG.segment_collect(
        k, s_, x, cap, distinct=distinct))(theirs, jsel, jv)
    _, _, gsel, _ = jax.jit(lambda k, s_: JAG.segment_groupby(k, s_, []))(
        theirs, jsel)
    g = int(np.asarray(gsel).sum())
    assert g > 10
    assert lens[:g].numpy().tobytes() == np.asarray(jlens)[:g].tobytes()
    assert mat[:g].numpy().tobytes() == np.asarray(jmat)[:g].tobytes()
    assert not bool(lens[g:].any())
