"""Struct and array columns in the port against the JAX package.

* Every case of ``tests/test_nested_types.py`` (structs as one column
  per field: round trips with and without null structs, field access
  with ``getField`` and a dotted name, a struct as a group key and as a
  sort key, ``F.struct``, a join that carries the struct) runs through
  the port's session (``device="cpu"``) and the JAX package's under the
  same conf: the Arrow results (schema included), the tree strings and
  the fallback reports are equal; the CPU sessions of both give equal
  results too.
* The array layout: ``_list_to_matrix`` (Arrow list -> padded element
  matrix, lengths, element validity) and a list column's host-to-device
  and device-to-host paths equal the JAX package's bit for bit, on lists
  with null lists, null elements, empty lists and one long list, over
  every element type with a device layout.
* A column's kind is decided by its dtype: an array column carries
  lengths as a string does, and each use (concat, compaction, padding,
  slicing, the device-to-host pull, the row select of a CASE, the host
  shuffle's views) treats it as an array, never as a string.

Integers, strings, validity, Arrow schemas and plan strings are exact;
doubles too (by ``repr``: NaN and -0.0 included) — the JAX tests'
``approx_float`` is not needed here.  Each JAX run is made once per
module (``jax_run``).
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import column as JC
from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import column as C
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.ops.expressions import device_select
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.shuffle.serializer import HostColView
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ensure_initialized()  # x64 for the JAX side
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


def _t(n=4000, nulls=False):
    """``tests/test_nested_types.py::_t``."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 10, n)
    b = rng.uniform(0, 1, n)
    s = pa.StructArray.from_arrays(
        [pa.array(a), pa.array(b)], names=["a", "b"],
        mask=pa.array([nulls and i % 7 == 0 for i in range(n)]))
    return pa.table({"k": pa.array(rng.integers(0, 5, n)), "s": s})


def _xy():
    rng = np.random.default_rng(3)
    return pa.table({"x": pa.array(rng.integers(0, 100, 1000)),
                     "y": pa.array(rng.uniform(0, 1, 1000))})


T4000, T_NULLS, T500, T1000, XY = (_t(), _t(nulls=True), _t(500),
                                   _t(1000), _xy())
RIGHT = pa.table({"k": pa.array(np.arange(5)),
                  "w": pa.array(np.arange(5) * 10)})
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}

# name: (build(session, F, col), conf, ordered)
CASES = {
    "struct_roundtrip": (
        lambda s, F, c: s.createDataFrame(T4000).select("s", "k"), {},
        True),
    "struct_roundtrip_with_nulls": (
        lambda s, F, c: s.createDataFrame(T_NULLS).select("s"), {}, True),
    "struct_field_access_on_device": (
        lambda s, F, c: s.createDataFrame(T4000)
        .filter(c("s").getField("a") > 4)
        .select(c("s.a").alias("a"), (c("s").getField("b") * 2).alias("b2"),
                c("k")), TEST, True),
    "struct_as_agg_key_on_device": (
        lambda s, F, c: s.createDataFrame(T4000).groupBy("s")
        .agg(F.count("*").alias("c"), F.sum(c("k")).alias("sk")), TEST,
        False),
    "struct_agg_key_output_reassembles": (
        lambda s, F, c: s.createDataFrame(T4000).groupBy("s")
        .agg(F.count("*").alias("c")), {}, False),
    "create_struct_function": (
        lambda s, F, c: s.createDataFrame(XY).select(
            F.struct(c("x"), (c("y") * 10).alias("y10")).alias("st"),
            c("x")), {}, True),
    "struct_sort_by_struct": (
        lambda s, F, c: s.createDataFrame(T500).orderBy("s").limit(50),
        TEST, True),
    "struct_null_sort_and_group": (
        lambda s, F, c: s.createDataFrame(T_NULLS).groupBy("s")
        .agg(F.count("*").alias("c")).orderBy("s"), TEST, True),
    "struct_join_carries_spec": (
        lambda s, F, c: s.createDataFrame(T1000)
        .join(s.createDataFrame(RIGHT).withColumnRenamed("k", "rk"),
              c("k") == c("rk")).select("s", "w"), {}, False),
    "struct_rename_and_drop": (
        lambda s, F, c: s.createDataFrame(T_NULLS)
        .withColumnRenamed("s", "t").withColumn("k2", c("k") + 1)
        .drop("k"), TEST, True),
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
    """Equal schemas and rows (as multisets unless ``ordered``), every
    value by ``repr``."""
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
    assert df._last_override.fallback_report() == report == []
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf, ordered = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=True)[0], ordered)


def test_what_the_jax_tests_pin(jax_run):
    """The facts ``tests/test_nested_types.py`` asserts on its own."""
    s = TpuSession(device="cpu")
    out = s.createDataFrame(T4000).select("s", "k").toArrow()
    assert out.column("s").to_pylist() == T4000.column("s").to_pylist()
    assert out.schema.field("s").type == T4000.schema.field("s").type
    out = s.createDataFrame(T4000).groupBy("s").agg(
        F.count("*").alias("c")).toArrow()
    assert pa.types.is_struct(out.schema.field("s").type)
    exp = {(r["a"], round(r["b"], 9)) for r in T4000["s"].to_pylist()}
    assert {(r["a"], round(r["b"], 9))
            for r in out["s"].to_pylist()} == exp
    out = s.createDataFrame(XY).select(
        F.struct(col("x"), (col("y") * 10).alias("y10")).alias("st"),
        col("x")).toArrow()
    st = out.schema.field("st").type
    assert [st.field(i).name for i in range(st.num_fields)] == ["x", "y10"]
    assert all(r["st"]["x"] == r["x"] for r in out.to_pylist())
    out = (s.createDataFrame(T1000)
           .join(s.createDataFrame(RIGHT).withColumnRenamed("k", "rk"),
                 col("k") == col("rk")).select("s", "w").toArrow())
    assert pa.types.is_struct(out.schema.field("s").type)
    assert out.num_rows == 1000


def test_struct_refusals_equal_jax():
    """Deeper nesting, getField off a reference, and two generators in
    one select raise the JAX package's errors."""
    deep = pa.table({"s": pa.StructArray.from_arrays(
        [pa.StructArray.from_arrays([pa.array([1])], names=["x"])],
        names=["inner"])})
    for Session in (JaxSession, lambda: TpuSession(device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="one level of struct nesting"):
            Session().createDataFrame(deep)
    lists = pa.table({"a": pa.array([[1]]), "b": pa.array([[2]])})
    for s, Fn, c in ((JaxSession(), JF, jcol),
                     (TpuSession(device="cpu"), F, col)):
        df = s.createDataFrame(T500)
        with pytest.raises(Exception, match="getField is only supported"):
            df.select((c("k") + 1).getField("a"))
        with pytest.raises(Exception, match="only one generator"):
            s.createDataFrame(lists).select(Fn.explode("a"),
                                            Fn.explode("b"))
        with pytest.raises(Exception, match="explode needs an array"):
            df.select(Fn.explode("k"))


# ---------------------------------------------------------------------------
# The array layout against the JAX package's, bit for bit
# ---------------------------------------------------------------------------

def _lists(kind: str, n=700, seed=11):
    """Lists of ``kind`` elements: null lists, null elements, empty
    lists and one list of 300 elements (W = 512)."""
    rng = np.random.default_rng(seed)
    make = {
        "int64": lambda k: [int(v) for v in rng.integers(-1 << 40,
                                                         1 << 40, k)],
        "int32": lambda k: [int(v) for v in rng.integers(-1000, 1000, k)],
        "float64": lambda k: [float(v) for v in rng.choice(
            [np.nan, -0.0, 0.0, np.inf, 1.5, -2.25, 1e300], k)],
        "bool": lambda k: [bool(v) for v in rng.integers(0, 2, k)],
        "date32": lambda k: [datetime.date(1970, 1, 1)
                             + datetime.timedelta(days=int(v))
                             for v in rng.integers(0, 20000, k)],
        "timestamp": lambda k: [int(v) for v in rng.integers(0, 1 << 50,
                                                             k)],
    }[kind]
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.05:
            out.append(None)
        elif r < 0.1:
            out.append([])
        else:
            vals = make(int(rng.integers(1, 9)))
            out.append([None if rng.random() < 0.08 else v for v in vals])
    out[n // 2] = make(300)
    typ = {"int64": pa.int64(), "int32": pa.int32(),
           "float64": pa.float64(), "bool": pa.bool_(),
           "date32": pa.date32(),
           "timestamp": pa.timestamp("us", tz="UTC")}[kind]
    return pa.array(out, type=pa.list_(typ))


KINDS = ["int64", "int32", "float64", "bool", "date32", "timestamp"]


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_list_to_matrix_equals_jax(kind):
    arr = _lists(kind)
    dt = T.from_arrow(arr.type)
    mat, lengths, emask = C._list_to_matrix(arr, dt.element_type)
    jmat, jlengths, jemask = JC._list_to_matrix(
        arr, JT.from_arrow(arr.type).element_type)
    assert mat.dtype == jmat.dtype and mat.shape == jmat.shape == (700, 512)
    assert _bits(mat) == _bits(jmat)
    assert _bits(lengths) == _bits(jlengths)
    assert emask is not None and _bits(emask) == _bits(jemask)
    # no element null: no element validity plane
    clean = pa.array([[1, 2], [], None, [3]], pa.list_(pa.int64()))
    assert C._list_to_matrix(clean, T.LongT)[2] is None


@pytest.mark.parametrize("kind", KINDS)
def test_list_transfer_equals_jax(kind):
    """host_to_device's buffers (padded to the row bucket) and the
    device-to-host pull equal the JAX package's."""
    tbl = pa.table({"l": _lists(kind, seed=12), "i": pa.array(
        np.arange(700))})
    dev = C.host_to_device(tbl, CPU)
    jdev = JC.host_to_device(tbl)
    c, jc = dev.columns[0], jdev.columns[0]
    assert c.capacity == jc.capacity == 1024
    for got, want in ((c.data, jc.data), (c.validity, jc.validity),
                      (c.lengths, jc.lengths), (c.evalid, jc.evalid)):
        assert _bits(got.numpy()) == _bits(np.asarray(want))
    back = C.device_to_host(dev)
    want = JC.device_to_host(jdev)
    assert back.schema == want.schema == tbl.schema
    # by repr: NaN and -0.0 compare as themselves
    assert repr(back.to_pylist()) == repr(want.to_pylist()) == repr(
        tbl.to_pylist())
    # a filtered batch compacts with its element validity
    dev = dev.with_sel(dev.sel & (torch.arange(1024) % 3 == 0))
    assert repr(C.device_to_host(dev).column("l").to_pylist()) == repr(
        tbl.column("l").to_pylist()[::3])


def test_array_concat_pads_to_the_widest():
    """Two batches of one array column with different widths concatenate
    padded to the widest, element validity and all; a spill and restore
    keeps every buffer."""
    a = pa.table({"l": pa.array([[1, None, 3], [4]], pa.list_(pa.int64()))})
    b = pa.table({"l": pa.array([[5] * 9, None, [None]],
                                pa.list_(pa.int64()))})
    ba, bb = C.host_to_device(a, CPU), C.host_to_device(b, CPU)
    assert ba.columns[0].data.shape[1] == 4
    assert bb.columns[0].data.shape[1] == 16
    cat = B.concat_device_batches(ba.schema, [ba, bb])
    assert cat.columns[0].data.shape[1] == 16
    assert C.device_to_host(cat).column("l").to_pylist() == [
        [1, None, 3], [4], [5] * 9, None, [None]]
    mgr = M.get_manager()
    sp = M.SpillableBatch(cat, mgr)
    assert sp.spill_to_host() > 0
    restored = sp.get()
    assert C.device_to_host(restored).equals(C.device_to_host(cat))
    sp.close()


def test_column_kind_is_decided_by_dtype():
    """An array column and a string column each carry lengths; every use
    reads the dtype."""
    tbl = pa.table({
        "l": pa.array([[1, 2], None, [], [None, 7]], pa.list_(pa.int64())),
        "s": pa.array(["ab", None, "", "xyz"])})
    b = C.host_to_device(tbl, CPU)
    arr, st = b.columns
    assert arr.lengths is not None and st.lengths is not None
    assert arr.is_array and not arr.is_string
    assert st.is_string and not st.is_array
    # compaction (a gather), padding and slicing keep the element plane
    half = b.with_sel(torch.tensor([False, True, True, True] + [False] *
                                   1020))
    comp = C.compact(half)
    assert comp.columns[0].evalid is not None
    assert C.device_to_host(comp).column("l").to_pylist() == \
        [None, [], [None, 7]]
    padded = C._pad_col(arr, 2048)
    assert padded.evalid.shape == (2048, arr.data.shape[1])
    assert bool(padded.evalid[1024:].all())
    cut = C.slice_batch(b, 0, 4)
    assert cut.columns[0].evalid.shape[0] == 4
    # the pull builds a list array and a string array
    out = C.device_to_host(b)
    assert out.equals(tbl)
    # a batch whose only other column is an array still concatenates
    cat = B.concat_device_batches(b.schema, [b, b])
    assert C.device_to_host(cat).equals(pa.concat_tables([tbl, tbl]))
    # the CASE row select pads strings only
    sel = device_select(torch.ones(1024, dtype=torch.bool), st, st,
                        T.StringT)
    assert sel.lengths is not None and sel.data.shape == st.data.shape
    # the host shuffle refuses a list column by its dtype
    with pytest.raises(NotImplementedError, match="cannot cross the host "
                       "shuffle"):
        HostColView(arr.dtype, arr.data.numpy(), None,
                    arr.lengths.numpy())
    assert HostColView(st.dtype, st.data.numpy(), None,
                       st.lengths.numpy()).is_string
    # empty batches of an array type
    e = C.empty_batch(b.schema, CPU, 8)
    assert e.columns[0].is_array and e.columns[0].data.shape == (8, 1)
    assert C.device_to_host(e).num_rows == 0
    # arrays of strings have no device layout
    with pytest.raises(NotImplementedError, match="no device layout"):
        C.torch_dtype(T.ArrayType(T.StringT))
