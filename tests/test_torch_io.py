"""Parquet, ORC, CSV, JSON and text reads and writes in the port against
the JAX package.

Every case of ``tests/test_io.py`` (a directory of parquet files read
whole and under a filter and an aggregate, a write read back, the write
modes, CSV and JSON round trips and user schemas, the device dictionary
decode of string columns and an all-null string column) runs through
the port's session (``device="cpu"``, under
``spark.rapids.sql.test.enabled``) and the JAX package's over the same
files, written by pyarrow from the same seeded tables: rows, tree
strings and fallback reports are equal, the CPU sessions of both give
equal rows, and what one package writes the other reads back equal.
The dictionary decode counts the same ``dictDecodedColumns`` as the
JAX package's scan.  Every value is compared exactly (by ``repr``,
row order ignored where the JAX test ignores it).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession
from spark_rapids_tpu.utils import datagen as dg

from spark_rapids_tpu_torch.columnar import dtypes as T
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


TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
NO_DICT = dict(TEST, **{"spark.rapids.tpu.parquet.deviceDictDecode": False})


def gen_table(seed=0, n=200):
    """``tests/test_io.py::gen_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": dg.IntegerGen().generate(rng, n),
        "d": dg.DoubleGen().generate(rng, n),
        "s": dg.StringGen().generate(rng, n),
        "k": pa.array((np.arange(n) % 7).astype(np.int32)),
    })


def _dict_table():
    rng = np.random.default_rng(91)
    n = 20_000
    names = [f"name_{i:04d}" for i in range(200)]
    return pa.table({
        "s": pa.array([names[i] for i in rng.integers(0, 200, n)]),
        "v": pa.array(rng.integers(0, 1000, n)),
        "maybe": pa.array([None if i % 7 == 0 else names[i % 200]
                           for i in range(n)]),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The parquet inputs of the read cases, written once."""
    root = tmp_path_factory.mktemp("io")
    d = root / "data"
    d.mkdir()
    for i in range(3):
        pq.write_table(gen_table(i), d / f"part-{i:05d}.parquet")
    pq.write_table(_dict_table(), root / "dict.parquet")
    pq.write_table(pa.table({"s": pa.array([None] * 3, type=pa.string()),
                             "v": pa.array([1, 2, 3])}),
                   root / "nulls.parquet")
    return {"dir": str(d), "dict": str(root / "dict.parquet"),
            "nulls": str(root / "nulls.parquet")}


# name: (build(session, F, col, files), conf, ordered)
CASES = {
    "parquet_read": (
        lambda s, F, c, f: s.read.parquet(f["dir"]), TEST, False),
    "parquet_read_filter_agg": (
        lambda s, F, c, f: s.read.parquet(f["dir"])
        .filter(c("i").isNotNull())
        .groupBy("k").agg(F.count("*").alias("c"), F.sum("i").alias("si")),
        TEST, False),
    "parquet_dict_grouped": (
        lambda s, F, c, f: s.read.parquet(f["dict"]).groupBy("s")
        .agg(F.count("*").alias("c"), F.sum("v").alias("sv")), TEST, False),
    "parquet_dict_null_entries": (
        lambda s, F, c, f: s.read.parquet(f["dict"]).filter(
            c("maybe").isNull()).select("v"), TEST, False),
    "parquet_dict_off": (
        lambda s, F, c, f: s.read.parquet(f["dict"]).select("s"),
        NO_DICT, True),
    "parquet_all_null_string_dict_decode": (
        lambda s, F, c, f: s.read.parquet(f["nulls"]).select("s", "v"),
        TEST, True),
}


@pytest.fixture(scope="module")
def jax_run(files):
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string, the scan's dictDecodedColumns), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf, _ = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol, files).toArrow(),) + (None,) * 3
            else:
                df = build(JaxSession(dict(conf)), JF, jcol, files)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string(), _dict_cols(df))
        return memo[(name, host)]

    return run


def _dict_cols(df):
    return sum(m.get("dictDecodedColumns", 0)
               for n, m in df._last_plan.collect_metrics()
               if n == "TpuParquetScanExec")


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    assert got.schema == want.schema
    g = [repr(r) for r in got.to_pylist()]
    w = [repr(r) for r in want.to_pylist()]
    if not ordered:
        g, w = sorted(g), sorted(w)
    assert g == w


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, files, name):
    build, conf, ordered = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col, files)
    got = df.toArrow()
    want, report, tree, ndict = jax_run(name)
    same_rows(got, want, ordered)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    assert _dict_cols(df) == ndict


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, files, name):
    build, conf, ordered = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F, col,
                files).toArrow()
    same_rows(got, jax_run(name, host=True)[0], ordered)


def test_parquet_device_dict_decode(jax_run):
    """``tests/test_io.py::test_parquet_device_dict_decode``: 200 groups,
    at least one column decoded on the device (column pruning keeps only
    ``s`` of the two string columns), none with the conf off."""
    want, _, _, ndict = jax_run("parquet_dict_grouped")
    assert want.num_rows == 200 and ndict >= 1
    assert jax_run("parquet_dict_off")[3] == 0


def test_parquet_write_round_trip(tmp_path, files):
    """A filtered read written by each package reads back equal, in
    either package."""
    def write(s, c, out):
        df = s.read.parquet(files["dir"]).filter(c("k") > 2)
        df.write.mode("overwrite").parquet(out)
        return df.toArrow()

    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    got = write(TpuSession(dict(TEST), device="cpu"), col, port_out)
    want = write(JaxSession(dict(TEST)), jcol, jax_out)
    same_rows(got, want, True)
    for out in (port_out, jax_out):
        back = TpuSession(dict(TEST), device="cpu").read.parquet(out) \
            .toArrow()
        jback = JaxSession(dict(TEST)).read.parquet(out).toArrow()
        same_rows(back, want, True)
        same_rows(jback, want, True)


def test_parquet_write_mode_error(tmp_path):
    out = str(tmp_path / "out")
    df = TpuSession(dict(TEST), device="cpu").createDataFrame(gen_table())
    df.write.parquet(out)
    with pytest.raises(FileExistsError):
        df.write.parquet(out)
    df.write.mode("overwrite").parquet(out)  # no raise
    same_rows(JaxSession({}).read.parquet(out).toArrow(), gen_table(), True)


def test_csv_round_trip(tmp_path):
    t = pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                  "b": pa.array(["x", "y", "z"])})
    out = str(tmp_path / "csv")
    s = TpuSession(dict(HOST), device="cpu")
    s.createDataFrame(t).write.mode("overwrite").csv(out)
    back = s.read.option("header", "true").csv(out)
    assert back.toArrow().num_rows == 3
    assert back.columns == ["a", "b"]
    same_rows(back.toArrow(), JaxSession(dict(HOST)).read.option(
        "header", "true").csv(out).toArrow(), True)


def test_json_round_trip(tmp_path):
    t = pa.table({"a": pa.array([1, 2], pa.int64()),
                  "b": pa.array(["x", None])})
    out = str(tmp_path / "json")
    s = TpuSession(dict(HOST), device="cpu")
    s.createDataFrame(t).write.mode("overwrite").json(out)
    back = s.read.json(out).toArrow()
    assert back.num_rows == 2
    same_rows(back, JaxSession(dict(HOST)).read.json(out).toArrow(), True)


def test_csv_reader_honors_schema(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("1,2.5,x\n3,4.5,y\n")

    def read(s, T):
        schema = T.StructType((
            T.StructField("a", T.LongT), T.StructField("b", T.DoubleT),
            T.StructField("c", T.StringT)))
        return s.read.schema(schema).csv(str(p))

    df = read(TpuSession({}, device="cpu"), T)
    assert df.schema.field_names() == ["a", "b", "c"]
    assert [f.dtype.simple_name for f in df.schema.fields] == [
        "long", "double", "string"]
    assert df.toArrow().column("a").to_pylist() == [1, 3]
    same_rows(df.toArrow(), read(JaxSession({}), JT).toArrow(), True)


def test_json_reader_honors_schema(tmp_path):
    p = tmp_path / "data.json"
    p.write_text('{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n')

    def read(s, T):
        schema = T.StructType((
            T.StructField("a", T.DoubleT), T.StructField("b", T.StringT)))
        return s.read.schema(schema).json(str(p))

    df = read(TpuSession({}, device="cpu"), T)
    assert [f.dtype.simple_name for f in df.schema.fields] == [
        "double", "string"]
    assert df.toArrow().column("a").to_pylist() == [1.0, 2.0]
    same_rows(df.toArrow(), read(JaxSession({}), JT).toArrow(), True)


def test_formats_of_the_next_slice_raise():
    """avro, delta and iceberg, once refused, now read as in the JAX
    package (``tests/test_torch_{avro_iceberg,delta}.py``): ``load``
    routes to them as to the others, and a missing path raises the JAX
    package's ``FileNotFoundError`` with its message."""
    r = TpuSession({}, device="cpu").read
    jr = JaxSession({}).read
    for fmt in ("avro", "delta", "iceberg"):
        msgs = []
        for read in (getattr(r, fmt), r.format(fmt).load,
                     getattr(jr, fmt), jr.format(fmt).load):
            with pytest.raises(FileNotFoundError) as e:
                read("x")
            msgs.append(str(e.value))
        assert len(set(msgs)) == 1, msgs
    with pytest.raises(ValueError, match="unknown read format"):
        r.format("xml").load("x")
