"""Delta Lake reads in the port against the JAX package.

Every case of ``tests/test_delta.py`` (log replay with removes, a
filtered projection, partition values, checkpoints, deletion vectors on
disk and inline, schema evolution, a percent-encoded path, a date
partition value, an empty table, the missing log and the version gap)
runs through ``session.read.delta`` of the port (``device="cpu"``, under
``spark.rapids.sql.test.enabled``) and of the JAX package over the same
tables, written by hand to the public Delta protocol from seeded
values: rows, row order, types and nulls equal (compared by ``repr``),
tree strings and fallback reports equal, the CPU sessions of both equal,
and the scans' ``deletedRows`` equal.  Error cases raise exceptions of
the JAX package's class names with its messages.

The deletion vectors of one table are written by the JAX package's
``write_dv_file`` and of another by the port's, so that each package
reads the other's files.  The delete edge cases: deletes beside
row-group pruning (file-absolute positions rebuilt from the kept
groups), beside the device dictionary decode, beside
``input_file_name()``, and a file whose every row is deleted.
"""

import datetime
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.io import deletion_vectors as JDV
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.io import deletion_vectors as DV
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


def _field(name, typ, nullable=True):
    return {"name": name, "type": typ, "nullable": nullable, "metadata": {}}


SCHEMA_STR = json.dumps({"type": "struct", "fields": [
    _field("id", "long", False), _field("v", "double")]})


def _commit(log_dir, version, actions):
    with open(os.path.join(log_dir, f"{version:020d}.json"), "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")


def _meta(partition_cols=(), schema=SCHEMA_STR):
    return {"metaData": {
        "id": "test-table", "format": {"provider": "parquet"},
        "schemaString": schema,
        "partitionColumns": list(partition_cols),
        "configuration": {}}}


def _add(path, pv=None, dv=None):
    a = {"path": path, "partitionValues": pv or {}, "size": 1,
         "modificationTime": 0, "dataChange": True}
    if dv is not None:
        a["deletionVector"] = dv
    return {"add": a}


def _write_part(table_dir, name, ids, vs, **kw):
    pq.write_table(pa.table({
        "id": pa.array(ids, type=pa.int64()),
        "v": pa.array(vs, type=pa.float64())}),
        os.path.join(table_dir, name), **kw)


def _new_table(root, name):
    d = str(root / name)
    log = os.path.join(d, "_delta_log")
    os.makedirs(log)
    return d, log


def _removes_table(root):
    d, log = _new_table(root, "tbl")
    _write_part(d, "part-0.parquet", [1, 2, 3], [1.0, 2.0, 3.0])
    _write_part(d, "part-1.parquet", [4, 5], [4.0, 5.0])
    _write_part(d, "part-2.parquet", [6], [6.0])
    _commit(log, 0, [_meta(), _add("part-0.parquet"),
                     _add("part-1.parquet")])
    _commit(log, 1, [{"remove": {"path": "part-0.parquet",
                                 "dataChange": True}},
                     _add("part-2.parquet")])
    return d


def _partitioned_table(root):
    d, log = _new_table(root, "ptbl")
    os.makedirs(os.path.join(d, "k=1"))
    os.makedirs(os.path.join(d, "k=2"))
    schema = json.dumps({"type": "struct", "fields": [
        _field("id", "long", False), _field("v", "double"),
        _field("k", "long")]})
    _write_part(d, "k=1/f1.parquet", [1, 2], [1.0, 2.0])
    _write_part(d, "k=2/f2.parquet", [3], [3.0])
    _commit(log, 0, [_meta(("k",), schema),
                     _add("k=1/f1.parquet", {"k": "1"}),
                     _add("k=2/f2.parquet", {"k": "2"})])
    return d


def _checkpoint_table(root):
    d, log = _new_table(root, "cptbl")
    _write_part(d, "part-0.parquet", [1], [1.0])
    _write_part(d, "part-1.parquet", [2], [2.0])
    meta_row = {"id": "test-table", "schemaString": SCHEMA_STR,
                "partitionColumns": []}
    cp = pa.table({
        "metaData": pa.array([meta_row, None], type=pa.struct([
            ("id", pa.string()), ("schemaString", pa.string()),
            ("partitionColumns", pa.list_(pa.string()))])),
        "add": pa.array([None, {"path": "part-0.parquet",
                                "partitionValues": []}],
                        type=pa.struct([
                            ("path", pa.string()),
                            ("partitionValues",
                             pa.map_(pa.string(), pa.string()))])),
    })
    pq.write_table(cp, os.path.join(log, f"{1:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1, "size": 2}, f)
    _commit(log, 2, [_add("part-1.parquet")])
    _commit(log, 0, [_meta()])  # stale, before the checkpoint: ignored
    return d


def _dv_file_table(root):
    """An on-disk deletion vector written by the JAX package."""
    d, log = _new_table(root, "dv")
    _write_part(d, "p.parquet", [1, 2, 3, 4, 5, 6],
                [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    desc = JDV.write_dv_file(os.path.join(d, "dv1.bin"), [1, 3, 5])
    _commit(log, 0, [_meta(), _add("p.parquet", dv=desc)])
    return d


def _dv_inline_table(root):
    d, log = _new_table(root, "dvi")
    _write_part(d, "p.parquet", [10, 20, 30], [1.0, 2.0, 3.0])
    blob = DV.serialize_bitmap_array([0, 2])
    desc = {"storageType": "i",
            "pathOrInlineDv": DV.z85_encode(blob + b"\0" * (-len(blob) % 4)),
            "sizeInBytes": len(blob), "cardinality": 2}
    _commit(log, 0, [_meta(), _add("p.parquet", dv=desc)])
    return d


def _evolution_table(root):
    d, log = _new_table(root, "evo")
    pq.write_table(pa.table({"id": pa.array([1, 2], type=pa.int64())}),
                   os.path.join(d, "old.parquet"))
    _write_part(d, "new.parquet", [3], [30.0])
    old_schema = json.dumps({"type": "struct", "fields": [
        _field("id", "long", False)]})
    _commit(log, 0, [_meta(schema=old_schema), _add("old.parquet")])
    _commit(log, 1, [_meta(), _add("new.parquet")])
    return d


def _encoded_path_table(root):
    d, log = _new_table(root, "enc")
    _write_part(d, "part a.parquet", [9], [9.0])
    _commit(log, 0, [_meta(), _add("part%20a.parquet")])
    return d


def _date_partition_table(root):
    d, log = _new_table(root, "dpart")
    schema = json.dumps({"type": "struct", "fields": [
        _field("id", "long", False), _field("v", "double"),
        _field("day", "date")]})
    os.makedirs(os.path.join(d, "day=2021-03-04"))
    _write_part(d, "day=2021-03-04/f.parquet", [1], [1.0])
    _commit(log, 0, [_meta(("day",), schema),
                     _add("day=2021-03-04/f.parquet",
                          {"day": "2021-03-04"})])
    return d


def _empty_table(root):
    d, log = _new_table(root, "empty")
    _commit(log, 0, [_meta()])
    return d


def _gap_table(root):
    d, log = _new_table(root, "gap")
    _write_part(d, "p.parquet", [1], [1.0])
    _commit(log, 0, [_meta(), _add("p.parquet")])
    _commit(log, 2, [{"remove": {"path": "p.parquet",
                                 "dataChange": True}}])  # no version 1
    return d


EDGE_ROWS, EDGE_GROUP = 400, 50


def _edge_table(root):
    """Two files with deletion vectors written by the port: ``a`` of
    ``EDGE_ROWS`` seeded rows in row groups of ``EDGE_GROUP`` with a
    low-cardinality string column (read dictionary-encoded), a random
    seventh of its positions deleted (an on-disk vector); ``b`` of 30
    rows, every one deleted (an inline vector)."""
    rng = np.random.default_rng(19)
    d, log = _new_table(root, "edge")
    schema = json.dumps({"type": "struct", "fields": [
        _field("id", "long", False), _field("v", "double"),
        _field("s", "string")]})
    words = [f"w{i:02d}" for i in range(12)]

    def part(name, ids):
        n = len(ids)
        pq.write_table(pa.table({
            "id": pa.array(ids, type=pa.int64()),
            "v": pa.array(rng.normal(size=n)),
            "s": pa.array([None if rng.random() < 0.05
                           else words[i] for i in rng.integers(0, 12, n)])}),
            os.path.join(d, name), row_group_size=EDGE_GROUP)

    part("a.parquet", np.arange(EDGE_ROWS))
    part("b.parquet", np.arange(EDGE_ROWS, EDGE_ROWS + 30))
    dels = np.flatnonzero(rng.random(EDGE_ROWS) < 1 / 7)
    desc_a = DV.write_dv_file(os.path.join(d, "dv_a.bin"), dels.tolist())
    blob = DV.serialize_bitmap_array(range(30))
    desc_b = {"storageType": "i",
              "pathOrInlineDv": DV.z85_encode(blob + b"\0" * (-len(blob) % 4)),
              "sizeInBytes": len(blob), "cardinality": 30}
    _commit(log, 0, [_meta(schema=schema), _add("a.parquet", dv=desc_a),
                     _add("b.parquet", dv=desc_b)])
    return d


TABLES = {
    "removes": _removes_table, "partitioned": _partitioned_table,
    "checkpoint": _checkpoint_table, "dv_file": _dv_file_table,
    "dv_inline": _dv_inline_table, "evolution": _evolution_table,
    "encoded": _encoded_path_table, "date_part": _date_partition_table,
    "empty": _empty_table, "gap": _gap_table, "edge": _edge_table,
}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("delta")
    out = {name: make(root) for name, make in TABLES.items()}
    out["missing"] = str(root / "nope")
    return out


# name: (table, build(session, F, col, path), conf, ordered, want ids)
CASES = {
    "snapshot_reflects_removes": (
        "removes", lambda s, F, c, p: s.read.delta(p).orderBy("id"),
        TEST, True, [4, 5, 6]),
    "filter_project": (
        "removes", lambda s, F, c, p: s.read.format("delta").load(p)
        .filter(c("id") > 4).select("id", (c("v") * 2).alias("v2")),
        TEST, False, [5, 6]),
    "partitioned": (
        "partitioned", lambda s, F, c, p: s.read.delta(p).groupBy("k")
        .agg(F.count("*").alias("c")).orderBy("k"), TEST, True, None),
    "checkpoint": (
        "checkpoint", lambda s, F, c, p: s.read.delta(p).orderBy("id"),
        TEST, True, [1, 2]),
    "dv_file": (
        "dv_file", lambda s, F, c, p: s.read.delta(p).orderBy("id"),
        TEST, True, [1, 3, 5]),
    "dv_inline": (
        "dv_inline", lambda s, F, c, p: s.read.delta(p), TEST, True, [20]),
    "schema_evolution": (
        "evolution", lambda s, F, c, p: s.read.delta(p).orderBy("id"),
        TEST, True, [1, 2, 3]),
    "percent_encoded_path": (
        "encoded", lambda s, F, c, p: s.read.delta(p), TEST, True, [9]),
    "date_partition": (
        "date_part", lambda s, F, c, p: s.read.delta(p), TEST, True, [1]),
    "empty_table": (
        "empty", lambda s, F, c, p: s.read.delta(p), TEST, True, []),
    "deletes_with_row_group_pruning": (
        "edge", lambda s, F, c, p: s.read.delta(p)
        .filter(c("id") >= 3 * EDGE_GROUP - 25).select("id", "v"),
        TEST, True, None),
    "deletes_with_dict_decode": (
        "edge", lambda s, F, c, p: s.read.delta(p).select("s", "id"),
        TEST, True, None),
    "deletes_with_plain_decode": (
        "edge", lambda s, F, c, p: s.read.delta(p).select("s", "id"),
        NO_DICT, True, None),
    "deletes_with_file_names": (
        "edge", lambda s, F, c, p: s.read.delta(p).select(
            F.input_file_name().alias("f"), "id"),
        TEST, True, None),
    "deletes_counted_over_an_all_deleted_file": (
        "edge", lambda s, F, c, p: s.read.delta(p).agg(
            F.count("*").alias("n"), F.sum("id").alias("si"),
            F.max("v").alias("mv")),
        TEST, True, None),
}


def _scan_metric(plan, name) -> int:
    """A metric of the plan's file scans, summed (the device scan's
    delete count accrues on its CPU reader in the JAX package)."""
    total = 0

    def walk(node):
        nonlocal total
        if type(node).__name__ in ("TpuParquetScanExec",
                                   "CpuParquetScanExec"):
            m = getattr(node, "_cpu", node).metrics.get(name)
            total += 0 if m is None else m.value
        for c in node.children:
            walk(c)

    walk(plan)
    return total


@pytest.fixture(scope="module")
def jax_run(tables):
    """``run(name, host)`` -> the JAX package's (result, fallback report,
    tree string, deletedRows), once per module."""
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            table, build, conf, _, _ = CASES[name]
            s = JaxSession(dict(conf, **HOST) if host else dict(conf))
            df = build(s, JF, jcol, tables[table])
            out = df.toArrow()
            memo[(name, host)] = (
                out, None if host else df._last_override.fallback_report(),
                None if host else df._last_plan.tree_string(),
                _scan_metric(df._last_plan, "deletedRows"))
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
def test_device_equals_jax(jax_run, tables, name):
    table, build, conf, ordered, ids = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col, tables[table])
    got = df.toArrow()
    want, report, tree, deleted = jax_run(name)
    same_rows(got, want, ordered)
    if ids is not None:
        assert got.column("id").to_pylist() == ids
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    assert _scan_metric(df._last_plan, "deletedRows") == deleted


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, tables, name):
    table, build, conf, ordered, _ = CASES[name]
    df = build(TpuSession(dict(conf, **HOST), device="cpu"), F, col,
               tables[table])
    got = df.toArrow()
    want, _, _, deleted = jax_run(name, host=True)
    same_rows(got, want, ordered)
    assert _scan_metric(df._last_plan, "deletedRows") == deleted


def test_partitioned_and_evolved_values(jax_run):
    """The JAX tests' own checks: partition counts, null-filled evolved
    columns, the date partition value, the empty table's columns."""
    part = jax_run("partitioned")[0]
    assert part.column("k").to_pylist() == [1, 2]
    assert part.column("c").to_pylist() == [2, 1]
    assert jax_run("schema_evolution")[0].column("v").to_pylist() == [
        None, None, 30.0]
    assert jax_run("date_partition")[0].column("day").to_pylist() == [
        datetime.date(2021, 3, 4)]
    empty = jax_run("empty_table")[0]
    assert empty.num_rows == 0 and empty.column_names == ["id", "v"]


def test_delete_edge_cases_delete_what_numpy_says(jax_run, tables):
    """The edge table's surviving rows against numpy: the pruned read
    skips two row groups and still deletes by file-absolute position;
    the all-deleted file contributes nothing and counts its 30 rows."""
    vec = DV.read_dv(json.loads(open(os.path.join(
        tables["edge"], "_delta_log", f"{0:020d}.json")).read().splitlines(
        )[1])["add"]["deletionVector"], tables["edge"])
    keep = np.setdiff1d(np.arange(EDGE_ROWS), vec)
    lo = 3 * EDGE_GROUP - 25
    pruned = jax_run("deletes_with_row_group_pruning")
    assert pruned[0].column("id").to_pylist() == keep[keep >= lo].tolist()
    # the pruned groups' deletes are never counted
    assert pruned[3] == int((vec >= 2 * EDGE_GROUP).sum()) + 30
    whole = jax_run("deletes_with_dict_decode")
    assert whole[0].column("id").to_pylist() == keep.tolist()
    assert whole[3] == len(vec) + 30
    names = jax_run("deletes_with_file_names")[0]
    assert names.column("id").to_pylist() == keep.tolist()
    # b.parquet keeps no row
    assert {os.path.basename(f) for f in names.column("f").to_pylist()} \
        == {"a.parquet"}
    counted = jax_run("deletes_counted_over_an_all_deleted_file")[0]
    assert counted.column("n").to_pylist() == [len(keep)]
    assert counted.column("si").to_pylist() == [int(keep.sum())]


def test_errors_match_jax(tables):
    """No ``_delta_log``: ``FileNotFoundError``; a version gap: the JAX
    package's ``DeltaProtocolError`` class name and message."""
    for path, kind, name, text in (
            (tables["missing"], FileNotFoundError, "FileNotFoundError",
             "_delta_log"),
            (tables["gap"], NotImplementedError, "DeltaProtocolError",
             "gap")):
        caught = []
        for s in (TpuSession(dict(TEST), device="cpu"), JaxSession(TEST)):
            with pytest.raises(kind) as e:
                s.read.delta(path).toArrow()
            caught.append((type(e.value).__name__, str(e.value)))
        assert caught[0] == caught[1]
        assert caught[0][0] == name and text in caught[0][1]


def _positions(rng):
    """Positions over array and bitmap containers, two high buckets and
    16-bit key edges (``test_deletion_vector_bitmap_round_trip``)."""
    return sorted(set(
        rng.integers(0, 5000, 300).tolist()
        + rng.integers(1 << 33, (1 << 33) + 70_000, 6000).tolist()
        + [0, 65535, 65536, (1 << 40)]))


def test_bitmap_round_trip_across_packages():
    pos = _positions(np.random.default_rng(2))
    blob = DV.serialize_bitmap_array(pos)
    assert blob == JDV.serialize_bitmap_array(pos)
    for parse in (DV.parse_bitmap_array, JDV.parse_bitmap_array):
        assert parse(blob).tolist() == pos
    raw = bytes(np.random.default_rng(3).integers(0, 256, 64,
                                                  dtype=np.uint8))
    assert DV.z85_encode(raw) == JDV.z85_encode(raw)
    assert DV.z85_decode(DV.z85_encode(raw)) == raw


def test_dv_files_read_across_packages(tmp_path):
    """A file of either package's ``write_dv_file`` reads back equal in
    both, with equal descriptors; ``u`` storage names its file from the
    z85 UUID as the JAX package does."""
    pos = _positions(np.random.default_rng(4))
    for i, write in enumerate((DV.write_dv_file, JDV.write_dv_file)):
        path = str(tmp_path / f"dv{i}.bin")
        desc = write(path, pos)
        assert desc == dict(
            (JDV.write_dv_file if i == 0 else DV.write_dv_file)(
                str(tmp_path / f"other{i}.bin"), pos),
            pathOrInlineDv=path)
        for read in (DV.read_dv, JDV.read_dv):
            assert read(desc, str(tmp_path)).tolist() == pos
    uid = bytes(range(16))
    pod = "ab" + DV.z85_encode(uid)
    assert DV.dv_file_name("/t", pod) == JDV.dv_file_name("/t", pod)
