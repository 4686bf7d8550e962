"""Generate (explode, explode_outer, posexplode, posexplode_outer) in the
port against the JAX package.

Every Generate case of ``tests/test_misc_execs.py`` (the four
generators over a list column with empty and null lists, explode then a
grouped sum, double elements, null elements on the device, a list
column's round trip with null elements, and the string-element
fallback) runs through the port's session (``device="cpu"``, under
``spark.rapids.sql.test.enabled``) and the JAX package's: results
(schema included), tree strings and fallback reports are equal; the CPU
sessions of both give equal results too.  Added here: the generators
over date, boolean and timestamp elements, a list column spread over
batches of different widths (``spark.rapids.tpu.batchRows`` 4) under a
filter, the generator after ``collect_list``, and a select that keeps
``*`` beside the generator.

The device exec keeps only the live (row, element) pairs (the JAX
package emits all ``B * W`` with ``sel``; the rows are the same), and it
reserves its output's bytes from the arbiter before it makes them
(``test_generate_reserves_its_output``).  Every value is
compared exactly (by ``repr``).  Each JAX run is made once per module
(``jax_run``).
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec import misc as MI
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


def list_table():
    """``tests/test_misc_execs.py::list_table``."""
    return pa.table({
        "id": pa.array(np.arange(6, dtype=np.int64)),
        "arr": pa.array([[1, 2, 3], [], [7], None, [9, 10], [0]],
                        type=pa.list_(pa.int64())),
    })


def _typed_lists():
    d = datetime.date(2020, 2, 29)
    return pa.table({
        "id": pa.array([1, 2, 3, 4], pa.int64()),
        "ds": pa.array([[d, None], [], None, [d + datetime.timedelta(1)]],
                       pa.list_(pa.date32())),
        "bs": pa.array([[True, False], [None], [], None],
                       pa.list_(pa.bool_())),
        "ts": pa.array([[1, 2], None, [3], [None, 5]],
                       pa.list_(pa.timestamp("us", tz="UTC"))),
    })


def _ragged(n=40, seed=9):
    rng = np.random.default_rng(seed)
    rows = [None if i % 11 == 5 else
            [None if rng.random() < 0.1 else float(v)
             for v in rng.normal(0, 5, int(rng.integers(0, 1 + i % 9)))]
            for i in range(n)]
    return pa.table({"id": pa.array(np.arange(n)),
                     "v": pa.array(rows, pa.list_(pa.float64()))})


LT, TYPED, RAGGED = list_table(), _typed_lists(), _ragged()
DOUBLES = pa.table({"id": pa.array([1, 2], type=pa.int64()),
                    "arr": pa.array([[1.5, -2.5], [0.0]],
                                    type=pa.list_(pa.float64()))})
NULL_ELEMS = pa.table({"id": pa.array([1, 2], type=pa.int64()),
                       "arr": pa.array([[1, None, 3], [None]],
                                       type=pa.list_(pa.int64()))})
STRINGS = pa.table({"id": pa.array([1, 2], type=pa.int64()),
                    "arr": pa.array([["x", "y"], [None]],
                                    type=pa.list_(pa.string()))})
ROUND = pa.table({"arr": pa.array([[1, None], None, [3]],
                                  type=pa.list_(pa.int64()))})
KV = pa.table({"k": pa.array([1, 2, 1, 3, 2, 1]),
               "v": pa.array([5, 6, None, 7, 8, 9], pa.int64())})
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
SMALL = dict(TEST, **{"spark.rapids.tpu.batchRows": 4})

# name: (build(session, F, col), conf, ordered)
CASES = {
    "explode_basic": (
        lambda s, F, c: s.createDataFrame(LT).select(
            "id", F.explode(c("arr")).alias("x")), TEST, True),
    "explode_outer": (
        lambda s, F, c: s.createDataFrame(LT).select(
            "id", F.explode_outer(c("arr")).alias("x")), TEST, True),
    "posexplode": (
        lambda s, F, c: s.createDataFrame(LT).select(
            "id", F.posexplode(c("arr"))), TEST, True),
    "posexplode_outer": (
        lambda s, F, c: s.createDataFrame(LT).select(
            "id", F.posexplode_outer(c("arr"))), TEST, True),
    "explode_then_agg": (
        lambda s, F, c: s.createDataFrame(LT)
        .select("id", F.explode(c("arr")).alias("x"))
        .groupBy("id").agg(F.sum("x").alias("s")), TEST, False),
    "explode_double_elements": (
        lambda s, F, c: s.createDataFrame(DOUBLES).select(
            "id", F.explode(c("arr")).alias("x")), TEST, True),
    "explode_null_elements_on_device": (
        lambda s, F, c: s.createDataFrame(NULL_ELEMS).select(
            "id", F.explode(c("arr")).alias("x")), TEST, True),
    "posexplode_outer_null_elements_on_device": (
        lambda s, F, c: s.createDataFrame(NULL_ELEMS).select(
            "id", F.posexplode_outer(c("arr"))), TEST, True),
    "array_null_elements_round_trip": (
        lambda s, F, c: s.createDataFrame(ROUND).select("arr"), {}, True),
    "explode_string_elements_falls_back": (
        lambda s, F, c: s.createDataFrame(STRINGS).select(
            "id", F.explode(c("arr")).alias("e")),
        dict(TEST, **{"spark.rapids.sql.test.allowedNonGpu":
                      "Generate,InMemoryScan,Project"}), True),
    "posexplode_dates_booleans_timestamps": (
        lambda s, F, c: s.createDataFrame(TYPED).select(
            "id", F.posexplode_outer("ds").alias("d"), "bs", "ts"),
        TEST, True),
    "explode_booleans_and_timestamps": (
        lambda s, F, c: s.createDataFrame(TYPED).select(
            "*", F.explode("ts").alias("t")).select(
            "id", "t", "bs"), TEST, True),
    "explode_ragged_batches_filtered": (
        lambda s, F, c: s.createDataFrame(RAGGED)
        .filter(c("id") % 3 != 1)
        .select("id", F.posexplode_outer("v").alias("x")), SMALL, False),
    "explode_after_collect_list": (
        lambda s, F, c: s.createDataFrame(KV).groupBy("k")
        .agg(F.collect_list("v").alias("vs"))
        .select("k", F.posexplode("vs").alias("v"))
        .groupBy("v").agg(F.count("*").alias("n"),
                          F.sum("pos").alias("sp")), TEST, False),
}


@pytest.fixture(scope="module")
def jax_run():
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf, _ = CASES[name]
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


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    assert got.schema == want.schema
    g = [repr(r) for r in got.to_pylist()]
    w = [repr(r) for r in want.to_pylist()]
    if not ordered:
        g, w = sorted(g), sorted(w)
    assert g == w


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf, ordered = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want, ordered)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree


# the JAX package's CPU explode cannot read date and timestamp elements
# (ROADMAP C.7): the port's host run of these is held to the JAX device
# run, which equals Spark's answer
JAX_HOST_FAILS = {"posexplode_dates_booleans_timestamps",
                  "explode_booleans_and_timestamps"}


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf, ordered = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=name not in JAX_HOST_FAILS)[0],
              ordered)


@pytest.mark.parametrize("name", sorted(JAX_HOST_FAILS))
def test_jax_cpu_explode_of_dates_fails(name):
    """ROADMAP C.7: the JAX package's CPU Generate keeps date and
    timestamp list elements as Python ``datetime`` objects and fails on
    them; the port holds them as int32 days and int64 microseconds."""
    build, conf, _ = CASES[name]
    with pytest.raises(TypeError, match="datetime"):
        build(JaxSession(dict(conf, **HOST)), JF, jcol).toArrow()


def test_what_the_jax_tests_pin(jax_run):
    """The device result of null elements is (1, NULL, 3), not 0s; the
    string-element case falls back as the JAX package's does; the round
    trip keeps null elements and null lists."""
    got = jax_run("explode_null_elements_on_device")[0]
    assert got.column("x").to_pylist() == [1, None, 3, None]
    assert jax_run("array_null_elements_round_trip")[0].column(
        "arr").to_pylist() == [[1, None], None, [3]]
    report = jax_run("explode_string_elements_falls_back")[1]
    assert any("explode over array<string>" in r for r in report)


def test_generate_reserves_its_output():
    """The device exec holds a transient reservation of its output's
    bytes while it explodes a batch: per output row (the live pairs'
    count to a power of two, 1024 at least), each input row's bytes and
    the element, position and validity columns."""
    seen = []
    real = M.DeviceMemoryManager.transient

    def spy(self, nbytes):
        seen.append(nbytes)
        return real(self, nbytes)

    M.DeviceMemoryManager.transient = spy
    try:
        s = TpuSession(dict(TEST), device="cpu")
        out = s.createDataFrame(LT).select(
            "id", F.explode("arr").alias("x")).toArrow()
    finally:
        M.DeviceMemoryManager.transient = real
    assert out.num_rows == 7
    # an input row: id 8 B, arr 4 x 8 B + 4 B lengths + 1 B validity, sel
    row = 8 + 4 * 8 + 4 + 1 + 1
    assert seen == [1024 * (row + 8 + 6)]


def test_generate_batch_layout():
    """The output holds the live (row, element) pairs in row order, then
    dead padding; an outer row has a null position and element."""
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    b = host_to_device(LT, torch.device("cpu"), min_bucket=8)
    arr = b.columns[1]
    keep = MI.generate_mask(b, arr, True)
    assert keep.shape == (8, 4) and int(keep.sum()) == 9
    out = MI.generate_batch(b, arr, keep, 16, True, True, None)
    assert out.compacted and out.capacity == 16
    assert out.sel.tolist() == [True] * 9 + [False] * 7
    assert out.columns[0].data[:9].tolist() == [0, 0, 0, 1, 2, 3, 4, 4, 5]
    assert out.columns[2].data[:9].tolist() == [0, 1, 2, 0, 0, 0, 0, 1, 0]
    assert out.columns[2].validity[:9].tolist() == [
        True, True, True, False, True, False, True, True, True]
    assert out.columns[3].data[:9].tolist() == [1, 2, 3, 0, 7, 0, 9, 10, 0]
