"""File-scan pushdown in the port against the JAX package: column
pruning, row-group statistics pruning, hive partitions,
``input_file_name()``, partitioned writes, ORC and text.

Every case of ``tests/test_io_pushdown.py`` but the avro one (held in
``tests/test_torch_avro_iceberg.py``) runs through the port's session
(``device="cpu"``, under ``spark.rapids.sql.test.enabled``) and the JAX
package's over the same files, written by pyarrow from the same seeded
tables: rows, tree strings and fallback reports are equal, the CPU
sessions of both give equal rows, the optimized scan's pruned
``columns``, pushed ``filters``, partition fields and file-name column
equal those of the JAX package's optimized ``ParquetRelation``, and
``prunedRowGroups`` equals the JAX package's count.  Every value is
compared exactly (by ``repr``; row order ignored where the JAX test
ignores it).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan.optimizer import optimize as joptimize
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.optimizer import optimize
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


def big_table(n=10000, seed=0):
    """``tests/test_io_pushdown.py::big_table``."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(np.arange(n, dtype=np.int64)),
        "b": pa.array(rng.normal(size=n)),
        "c": pa.array([f"s{i % 50}" for i in range(n)]),
        "d": pa.array((np.arange(n) % 11).astype(np.int32)),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs of the read cases, written once by pyarrow (the
    partitioned and ORC layouts by the JAX package's CPU writer, as the
    JAX tests write them)."""
    root = tmp_path_factory.mktemp("pushdown")
    p = str(root / "t.parquet")
    # many small row groups so stats pruning has something to skip
    pq.write_table(big_table(), p, row_group_size=1000)
    cpu = JaxSession(dict(HOST))
    parts = str(root / "p2")
    cpu.createDataFrame(big_table(2000, 3)).write.partitionBy(
        "d").parquet(parts)
    orc = str(root / "t_orc")
    cpu.createDataFrame(big_table(500, 1)).write.orc(orc)
    po = str(root / "po")
    cpu.createDataFrame(pa.table({
        "k": pa.array([1, 1, 2], type=pa.int64()),
        "v": pa.array([1.0, 2.0, 3.0])})).write.partitionBy("k").orc(po)
    text = str(root / "lines.txt")
    with open(text, "w") as f:
        f.write("alpha\nbeta\ngamma\n")
    return {"file": p, "parts": parts, "orc": orc, "po": po, "text": text}


# name: (build(session, F, col, files), ordered)
CASES = {
    "column_pruning_narrows_scan": (
        lambda s, F, c, f: s.read.parquet(f["file"]).select(
            (c("a") + 1).alias("a1")), True),
    "row_group_pruning_skips_groups": (
        lambda s, F, c, f: s.read.parquet(f["file"]).filter(c("a") < 1500)
        .select(c("a"), c("b")), True),
    "pushdown_oracle_equal": (
        lambda s, F, c, f: s.read.parquet(f["file"])
        .filter((c("a") >= 2000) & (c("a") < 4000) & (c("d") != 3))
        .select("a", "d", (c("b") * 2).alias("b2")), True),
    "flipped_literal_and_equality": (
        lambda s, F, c, f: s.read.parquet(f["file"])
        .filter((F.lit(8500) < c("a")) & (c("d") == 4)).select("a", "c"),
        True),
    "agg_head_pruning_oracle": (
        lambda s, F, c, f: s.read.parquet(f["file"]).groupBy("d").agg(
            F.sum("a").alias("sa")), False),
    "input_file_name": (
        lambda s, F, c, f: s.read.parquet(f["file"]).select(
            "a", F.input_file_name().alias("f")).limit(5), True),
    "input_file_name_per_partition": (
        lambda s, F, c, f: s.read.parquet(f["parts"]).select(
            F.input_file_name().alias("f"), "d"), False),
    "partitioned_read_oracle": (
        lambda s, F, c, f: s.read.parquet(f["parts"]).groupBy("d").agg(
            F.count("*").alias("c"), F.sum("a").alias("sa")), False),
    "partitioned_filter_on_partition_column": (
        lambda s, F, c, f: s.read.parquet(f["parts"]).filter(c("d") == 4)
        .select("a", "c", "d"), False),
    "orc_round_trip": (
        lambda s, F, c, f: s.read.orc(f["orc"]).filter(c("d") == 5)
        .select("a", "c"), True),
    "orc_partition_only_select": (
        lambda s, F, c, f: s.read.orc(f["po"]).select("k"), False),
    "orc_partition_only_count": (
        lambda s, F, c, f: s.read.orc(f["po"]).agg(
            F.count("*").alias("c")), True),
    "text_reader": (
        lambda s, F, c, f: s.read.text(f["text"]), True),
}


def _relation(plan, cls):
    """The file relation of an optimized logical plan (or None)."""
    if isinstance(plan, cls):
        return plan
    for c in plan.children:
        r = _relation(c, cls)
        if r is not None:
            return r
    return None


def _pushdown(rel):
    if rel is None:
        return None
    return (rel.columns, rel.filters, [f.name for f in rel.partition_fields],
            rel.file_name_col, [f.name for f in rel.schema.fields])


def _pruned(df) -> int:
    return sum(m.get("prunedRowGroups", 0)
               for n, m in df._last_plan.collect_metrics()
               if "ParquetScan" in n)


@pytest.fixture(scope="module")
def jax_run(files):
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string, the optimized relation's pushdown, prunedRowGroups),
    once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, _ = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(HOST)), JF,
                                            jcol, files).toArrow(),)
            else:
                df = build(JaxSession(dict(TEST)), JF, jcol, files)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string(),
                    _pushdown(_relation(joptimize(df._plan),
                                        JL.ParquetRelation)),
                    _pruned(df))
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
def test_device_equals_jax(jax_run, files, name):
    build, ordered = CASES[name]
    df = build(TpuSession(dict(TEST), device="cpu"), F, col, files)
    got = df.toArrow()
    want, report, tree, pushdown, pruned = jax_run(name)
    same_rows(got, want, ordered)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    assert _pushdown(_relation(optimize(df._plan),
                               L.ParquetRelation)) == pushdown
    assert _pruned(df) == pruned


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, files, name):
    build, ordered = CASES[name]
    got = build(TpuSession(dict(HOST), device="cpu"), F, col,
                files).toArrow()
    same_rows(got, jax_run(name, host=True)[0], ordered)


def test_what_the_jax_tests_pin(jax_run, files):
    """The facts ``tests/test_io_pushdown.py`` states of its cases."""
    _, _, tree, pushdown, _ = jax_run("column_pruning_narrows_scan")
    assert "1 files" in tree and pushdown[0] == ["a"]
    out, _, _, pushdown, pruned = jax_run("row_group_pruning_skips_groups")
    assert out.num_rows == 1500 and pruned >= 8
    assert pushdown[1] == [("a", "lt", 1500)]
    assert jax_run("flipped_literal_and_equality")[3][1] == [
        ("a", "gt", 8500), ("d", "eq", 4)]
    paths = jax_run("input_file_name")[0].column("f").to_pylist()
    assert len(paths) == 5 and all(v == files["file"] for v in paths)
    per_file = jax_run("input_file_name_per_partition")[0]
    assert per_file.num_rows == 2000
    assert len(set(per_file.column("f").to_pylist())) == 11
    assert all(f"d={d}" in f for f, d in zip(
        per_file.column("f").to_pylist(), per_file.column("d").to_pylist()))
    assert jax_run("orc_partition_only_select")[0].num_rows == 3
    assert jax_run("orc_partition_only_count")[0].column("c") \
        .to_pylist() == [3]
    assert jax_run("text_reader")[0].column("value").to_pylist() == [
        "alpha", "beta", "gamma"]


def test_partitioned_write_read_round_trip(tmp_path):
    """The port's hive layout on disk, read back by both packages."""
    t = pa.table({
        "k": pa.array([1, 1, 2, 2, 3], type=pa.int64()),
        "g": pa.array(["x", "y", "x", "y", "x"]),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    })
    out = str(tmp_path / "part_out")
    TpuSession(dict(HOST), device="cpu").createDataFrame(t).write \
        .partitionBy("k").parquet(out)
    assert sorted(os.listdir(out)) == ["k=1", "k=2", "k=3"]
    back = TpuSession(dict(TEST), device="cpu").read.parquet(out) \
        .orderBy("v").toArrow()
    assert back.column("v").to_pylist() == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert back.column("k").to_pylist() == [1, 1, 2, 2, 3]
    same_rows(back, JaxSession(dict(TEST)).read.parquet(out)
              .orderBy("v").toArrow(), True)


def test_partition_nulls_write_the_hive_default(tmp_path):
    """A null partition value writes ``__HIVE_DEFAULT_PARTITION__`` and
    reads back as a null, in both packages."""
    t = pa.table({"k": pa.array(["a", None, "a"]),
                  "v": pa.array([1, 2, 3], pa.int64())})
    out = str(tmp_path / "hn")
    TpuSession(dict(TEST), device="cpu").createDataFrame(t).write \
        .partitionBy("k").parquet(out)
    assert sorted(os.listdir(out)) == ["k=__HIVE_DEFAULT_PARTITION__",
                                       "k=a"]
    got = TpuSession(dict(TEST), device="cpu").read.parquet(out) \
        .orderBy("v").toArrow()
    assert got.column("k").to_pylist() == ["a", None, "a"]
    same_rows(got, JaxSession(dict(TEST)).read.parquet(out)
              .orderBy("v").toArrow(), True)


def test_metadata_dirs_skipped(tmp_path):
    t = pa.table({"x": pa.array([1, 2, 3], type=pa.int64())})
    out = str(tmp_path / "d")
    TpuSession(dict(HOST), device="cpu").createDataFrame(t).write \
        .parquet(out)
    os.makedirs(os.path.join(out, "_delta_log"))
    with open(os.path.join(out, "_delta_log", "00000.json"), "w") as f:
        f.write("{}")
    assert TpuSession(dict(TEST), device="cpu").read.parquet(out) \
        .count() == 3
    assert JaxSession(dict(TEST)).read.parquet(out).count() == 3


def test_write_modes(tmp_path):
    t = pa.table({"x": pa.array([1, 2], type=pa.int64())})
    out = str(tmp_path / "m")
    s = TpuSession(dict(HOST), device="cpu")
    s.createDataFrame(t).write.parquet(out)
    with pytest.raises(FileExistsError):
        s.createDataFrame(t).write.parquet(out)
    s.createDataFrame(t).write.mode("ignore").parquet(out)
    s.createDataFrame(t).write.mode("overwrite").parquet(out)
    assert TpuSession(dict(TEST), device="cpu").read.parquet(out) \
        .count() == 2


def test_input_file_name_outside_a_file_scan_raises():
    """Over an in-memory table, and under an aggregate head (the JAX
    optimizer binds the marker in a projection only), the marker raises
    the JAX package's RuntimeError."""
    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    for s, F_ in ((TpuSession(dict(TEST), device="cpu"), F),
                  (JaxSession(dict(TEST)), JF)):
        with pytest.raises(RuntimeError, match="not bound to a file scan"):
            s.createDataFrame(t).select(
                F_.input_file_name().alias("f")).toArrow()


def test_relation_fields_of_a_later_slice_raise(tmp_path):
    """The JAX package's ``dpp`` and ``deletes`` relation fields, once
    refused, now run in the file scan as in the JAX package: ``deletes``
    masks file-absolute positions (``deletedRows``) and ``dpp`` drains
    its subquery once and skips the files whose partition value it does
    not hold (``dppPrunedFiles``)."""
    from spark_rapids_tpu.columnar import dtypes as JT
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.io.parquet import CpuParquetScanExec as JScan
    from spark_rapids_tpu.ops import expressions as JE
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.parquet import CpuParquetScanExec
    from spark_rapids_tpu_torch.ops import expressions as E
    paths = []
    for k in range(3):
        paths.append(str(tmp_path / f"p{k}.parquet"))
        pq.write_table(pa.table({"a": pa.array(np.arange(5) + 10 * k)}),
                       paths[-1])
    dels = [np.array([0, 3], np.int64), None, np.array([4], np.int64)]
    pv = [{"k": k} for k in range(3)]
    dim = pa.table({"k": pa.array([0, 2], pa.int64())})
    got = []
    for LL, TT, EE, Scan, Conf in (
            (L, T, E, CpuParquetScanExec, RapidsConf),
            (JL, JT, JE, JScan, JConf)):
        schema = TT.StructType((TT.StructField("a", TT.LongT),
                                TT.StructField("k", TT.LongT)))
        ks = TT.StructType((TT.StructField("k", TT.LongT),))
        sub = LL.Project(
            LL.InMemoryRelation(dim, ks),
            [EE.BoundReference(0, TT.LongT, True)],
            TT.StructType((TT.StructField("_dpp_key", TT.LongT),)))
        rel = LL.ParquetRelation(paths, schema, partition_values=pv,
                                 partition_fields=(schema.fields[1],),
                                 deletes=dels, dpp=(sub, "k"))
        scan = Scan(rel, Conf({}))
        rows = [r for p in range(scan.num_partitions())
                for b in scan.execute(p)
                for r in zip(*(c.data.tolist() for c in b.columns))]
        got.append((sorted(rows), scan.metrics["deletedRows"].value,
                     scan.metrics["dppPrunedFiles"].value))
    assert got[0] == got[1]
    assert got[0] == ([(1, 0), (2, 0), (4, 0), (20, 2), (21, 2), (22, 2),
                       (23, 2)], 3, 1)
