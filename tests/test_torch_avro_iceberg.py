"""Avro and Iceberg reads in the port against the JAX package.

Every case of ``tests/test_avro_iceberg.py`` and
``tests/test_io_pushdown.py::test_avro_missing_file_raises``:

* the avro container codec (``io/avro.py``): records through both
  codecs, written by either package and read back equal by both; the two
  packages' files equal byte for byte once their random 16-byte sync
  markers are masked; a corrupt magic raises ``AvroError`` with the same
  message; ``avro_to_arrow`` gives equal tables;
* ``session.read.avro`` (flat records with logical date and timestamp
  types, a user schema that casts and orders the columns, several files
  concatenated, a missing file);
* ``session.read.iceberg`` over v2 tables assembled by hand to the
  public spec, their manifests written by one package or the other: a
  basic partitioned read, a manifest entry of status 2 skipped, a group
  by the partition column, position deletes, the equality-delete and
  non-identity-transform gates, an empty table and catalog-named
  metadata files.

Each query runs on the port (``device="cpu"``, under
``spark.rapids.sql.test.enabled``) and on the JAX package over the same
files: rows, row order, types and nulls equal (by ``repr``), tree
strings and fallback reports equal, the CPU sessions of both equal, and
the scans' ``deletedRows`` equal.  Errors raise exceptions of the JAX
package's class names with its messages.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.io import avro as JA
from spark_rapids_tpu.io import iceberg as JI
from spark_rapids_tpu.runtime.device import ensure_initialized
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.io import avro as A
from spark_rapids_tpu_torch.io import iceberg as I
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
WRITERS = {"port": A.write_container, "jax": JA.write_container}

# -- avro codec -------------------------------------------------------------

REC_SCHEMA = {
    "type": "record", "name": "r", "fields": [
        {"name": "i", "type": "int"},
        {"name": "l", "type": "long"},
        {"name": "d", "type": "double"},
        {"name": "s", "type": "string"},
        {"name": "b", "type": "boolean"},
        {"name": "opt", "type": ["null", "long"]},
        {"name": "arr", "type": {"type": "array", "items": "int"}},
        {"name": "m", "type": {"type": "map", "values": "string"}},
        {"name": "e", "type": {"type": "enum", "name": "color",
                               "symbols": ["red", "green"]}},
        {"name": "fx", "type": {"type": "fixed", "name": "f4",
                                "size": 4}},
    ]}


def _records(n=40, seed=5):
    """``tests/test_avro_iceberg.py::ROWS`` (with an enum and a fixed
    field) and ``n`` seeded records more."""
    rng = np.random.default_rng(seed)
    rows = [
        {"i": 1, "l": -(1 << 40), "d": 2.5, "s": "héllo", "b": True,
         "opt": None, "arr": [1, 2, 3], "m": {"a": "x"}, "e": "red",
         "fx": b"abcd"},
        {"i": -7, "l": 0, "d": float(-0.0), "s": "", "b": False,
         "opt": 99, "arr": [], "m": {}, "e": "green", "fx": b"\0\0\0\1"},
    ]
    for k in range(n):
        rows.append({
            "i": int(rng.integers(-2**31, 2**31)),
            "l": int(rng.integers(-2**63, 2**63 - 1)),
            "d": float(rng.normal() * 1e6), "s": f"s{k}" * int(k % 4),
            "b": bool(k % 2), "opt": None if k % 3 else k,
            "arr": rng.integers(-100, 100, k % 5).tolist(),
            "m": {f"k{j}": str(j) for j in range(k % 3)},
            "e": "red" if k % 2 else "green",
            "fx": bytes(rng.integers(0, 256, 4, dtype=np.uint8))})
    return rows


def _masked(path):
    """A container's bytes with its sync marker (the 16 bytes after the
    header, repeated after each block) zeroed."""
    raw = open(path, "rb").read()
    header_end = raw.index(b"\0", raw.index(b"avro.codec")) + 1
    # the header map ends in a 0 block count; then the sync marker
    sync = raw[header_end:header_end + 16]
    return raw.replace(sync, b"\0" * 16)


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", list(WRITERS))
def test_avro_round_trip_across_packages(tmp_path, codec, writer):
    rows = _records()
    p = str(tmp_path / f"{writer}.avro")
    WRITERS[writer](p, REC_SCHEMA, rows, codec=codec)
    for read in (A.read_container, JA.read_container):
        schema, recs = read(p)
        assert schema == REC_SCHEMA and recs == rows
    other = str(tmp_path / "other.avro")
    WRITERS["jax" if writer == "port" else "port"](other, REC_SCHEMA, rows,
                                                   codec=codec)
    assert _masked(p) == _masked(other)
    assert open(p, "rb").read() != open(other, "rb").read()


def test_avro_corrupt_magic_raises_as_jax(tmp_path):
    p = str(tmp_path / "bad.avro")
    with open(p, "wb") as f:
        f.write(b"nope")
    caught = []
    for read, err in ((A.read_container, A.AvroError),
                      (JA.read_container, JA.AvroError)):
        with pytest.raises(err) as e:
            read(p)
        caught.append((type(e.value).__name__, str(e.value)))
    assert caught[0] == caught[1]


FLAT_SCHEMA = {"type": "record", "name": "t", "fields": [
    {"name": "x", "type": "long"},
    {"name": "y", "type": ["null", "double"]},
    {"name": "day", "type": {"type": "int", "logicalType": "date"}},
    {"name": "ts", "type": {"type": "long",
                            "logicalType": "timestamp-micros"}},
    {"name": "name", "type": "string"},
]}


def _flat_rows(n, seed, start=0):
    rng = np.random.default_rng(seed)
    return [{"x": start + i, "y": None if i % 5 == 1 else float(
        rng.normal()), "day": 19000 + int(rng.integers(0, 400)),
        "ts": 1_600_000_000_000_000 + int(rng.integers(0, 10**12)),
        "name": f"n{start + i}"} for i in range(n)]


@pytest.fixture(scope="module")
def avro_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("avro")
    flat = str(root / "flat.avro")
    A.write_container(flat, FLAT_SCHEMA, _flat_rows(4, 1))
    d = root / "many"
    d.mkdir()
    JA.write_container(str(d / "a.avro"), FLAT_SCHEMA, _flat_rows(300, 2),
                       codec="deflate")
    A.write_container(str(d / "b.avro"), FLAT_SCHEMA,
                      _flat_rows(200, 3, start=300))
    user = str(root / "u.avro")
    A.write_container(user, {"type": "record", "name": "t", "fields": [
        {"name": "x", "type": "long"}, {"name": "y", "type": "double"}]},
        [{"x": 1, "y": 2.0}, {"x": -3, "y": 0.5}])
    return {"flat": flat, "many": str(d), "user": user,
            "missing": str(root / "x.avro")}


def test_avro_to_arrow_equals_jax(avro_files):
    for name in ("flat", "user"):
        got = A.avro_to_arrow(avro_files[name])
        assert got.equals(JA.avro_to_arrow(avro_files[name]))
    got = A.avro_to_arrow(avro_files["flat"])
    assert got.column("x").to_pylist() == [0, 1, 2, 3]
    assert got.column("y").to_pylist()[1] is None


def _user_schema(T_):
    return T_.StructType((T_.StructField("y", T_.FloatT),
                          T_.StructField("x", T_.IntegerT)))


# name: (build(session, F, col, T, files), ordered)
AVRO_CASES = {
    "read_avro_flat": (
        lambda s, F, c, T_, f: s.read.avro(f["flat"])
        .filter(c("x") > 1).select("x", "name"), True),
    "read_avro_many_files": (
        lambda s, F, c, T_, f: s.read.format("avro").load(f["many"])
        .filter(c("y").isNotNull()).select("x", "day", "ts", "y"), True),
    "read_avro_grouped": (
        lambda s, F, c, T_, f: s.read.avro(f["many"]).groupBy("day")
        .agg(F.count("*").alias("n"), F.sum("x").alias("sx")), False),
    "read_avro_user_schema": (
        lambda s, F, c, T_, f: s.read.schema(_user_schema(T_))
        .format("avro").load(f["user"]), True),
}


@pytest.mark.parametrize("name", list(AVRO_CASES))
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_read_avro_equals_jax(avro_files, name, host):
    build, ordered = AVRO_CASES[name]
    conf = dict(TEST, **HOST) if host else dict(TEST)
    df = build(TpuSession(conf, device="cpu"), F, col, T, avro_files)
    jdf = build(JaxSession(dict(conf)), JF, jcol, JT, avro_files)
    same_rows(df.toArrow(), jdf.toArrow(), ordered)
    if not host:
        assert (df._last_override.fallback_report()
                == jdf._last_override.fallback_report())
        assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    if name == "read_avro_user_schema":
        got = df.toArrow()
        assert got.column_names == ["y", "x"]
        assert got.schema.field("x").type == pa.int32()
        assert got.schema.field("y").type == pa.float32()


def test_avro_missing_file_raises(avro_files):
    caught = []
    for s in (TpuSession(dict(TEST), device="cpu"), JaxSession(TEST)):
        with pytest.raises(FileNotFoundError) as e:
            s.read.avro(avro_files["missing"])
        caught.append(str(e.value))
    assert caught[0] == caught[1]


# -- iceberg ----------------------------------------------------------------

ICE_SCHEMA = {
    "type": "struct", "schema-id": 0, "fields": [
        {"id": 1, "name": "id", "type": "long", "required": True},
        {"id": 2, "name": "v", "type": "double", "required": False},
        {"id": 3, "name": "part", "type": "long", "required": False},
    ]}

MANIFEST_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "data_file", "type": {
            "type": "record", "name": "data_file", "fields": [
                {"name": "content", "type": "int"},
                {"name": "file_path", "type": "string"},
                {"name": "file_format", "type": "string"},
                {"name": "partition", "type": {
                    "type": "record", "name": "r102", "fields": [
                        {"name": "part", "type": ["null", "long"]}]}},
                {"name": "record_count", "type": "long"},
            ]}},
    ]}

MLIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
    ]}


def _make_iceberg(d, entries, writer, partitioned=True, snapshot_id=10):
    meta = os.path.join(d, "metadata")
    os.makedirs(meta)
    manifest = os.path.join(meta, "m1.avro")
    WRITERS[writer](manifest, MANIFEST_SCHEMA, entries, codec="deflate")
    mlist = os.path.join(meta, "snap-10.avro")
    WRITERS[writer](mlist, MLIST_SCHEMA, [
        {"manifest_path": manifest,
         "manifest_length": os.path.getsize(manifest)}])
    md = {
        "format-version": 2, "table-uuid": "u", "location": d,
        "current-schema-id": 0, "schemas": [ICE_SCHEMA],
        "default-spec-id": 0,
        "partition-specs": [{"spec-id": 0, "fields": (
            [{"name": "part", "transform": "identity",
              "source-id": 3, "field-id": 1000}] if partitioned
            else [])}],
        "current-snapshot-id": snapshot_id,
        "snapshots": [{"snapshot-id": 10, "manifest-list": mlist}],
    }
    with open(os.path.join(meta, "v1.metadata.json"), "w") as f:
        json.dump(md, f)
    with open(os.path.join(meta, "version-hint.text"), "w") as f:
        f.write("1")
    return d


def _data_file(d, name, ids, vs):
    os.makedirs(os.path.join(d, "data"), exist_ok=True)
    p = os.path.join(d, "data", name)
    pq.write_table(pa.table({
        "id": pa.array(ids, type=pa.int64()),
        "v": pa.array(vs, type=pa.float64())}), p)
    return p


def _entry(path, part, status=1, content=0):
    return {"status": status, "data_file": {
        "content": content, "file_path": path, "file_format": "PARQUET",
        "partition": {"part": part}, "record_count": 1}}


def _basic(d, writer):
    f1 = _data_file(d, "f1.parquet", [1, 2], [1.0, 2.0])
    f2 = _data_file(d, "f2.parquet", [3], [3.0])
    return _make_iceberg(d, [_entry(f1, 7), _entry(f2, 8)], writer)


def _deleted_entry(d, writer):
    f1 = _data_file(d, "f1.parquet", [1], [1.0])
    f2 = _data_file(d, "f2.parquet", [2], [2.0])
    return _make_iceberg(d, [_entry(f1, 1), _entry(f2, 1, status=2)],
                         writer)


def _grouped(d, writer):
    rng = np.random.default_rng(11)
    entries = []
    for k in range(4):
        n = 50 + 10 * k
        f = _data_file(d, f"f{k}.parquet", np.arange(n) + 1000 * k,
                       rng.integers(-50, 50, n) / 4.0)
        entries.append(_entry(f, k % 2 + 1))
    return _make_iceberg(d, entries, writer)


def _position_deletes(d, writer):
    f1 = _data_file(d, "f1.parquet", [1, 2, 3, 4], [1.0, 2.0, 3.0, 4.0])
    f2 = _data_file(d, "f2.parquet", [5, 6], [5.0, 6.0])
    f3 = _data_file(d, "f3.parquet", [7, 8], [7.0, 8.0])
    delp = os.path.join(d, "data", "del1.parquet")
    pq.write_table(pa.table({
        "file_path": pa.array([f1, f1, f2, f3, f3, "/elsewhere.parquet"]),
        "pos": pa.array([0, 2, 1, 0, 1, 0], type=pa.int64())}), delp)
    return _make_iceberg(d, [_entry(f1, 1), _entry(f2, 2), _entry(f3, 2),
                             _entry(delp, None, content=1)], writer)


def _equality_deletes(d, writer):
    f1 = _data_file(d, "f1.parquet", [1], [1.0])
    return _make_iceberg(d, [_entry(f1, None, content=2)], writer)


def _bucket_transform(d, writer):
    _make_iceberg(d, [], writer)
    meta = os.path.join(d, "metadata", "v1.metadata.json")
    with open(meta) as f:
        md = json.load(f)
    md["partition-specs"][0]["fields"] = [
        {"name": "part_bucket", "transform": "bucket[16]",
         "source-id": 3, "field-id": 1000}]
    with open(meta, "w") as f:
        json.dump(md, f)
    return d


def _empty(d, writer):
    return _make_iceberg(d, [], writer, snapshot_id=None)


ICE_TABLES = {"basic": _basic, "deleted_entry": _deleted_entry,
              "grouped": _grouped, "position_deletes": _position_deletes,
              "equality_deletes": _equality_deletes,
              "bucket_transform": _bucket_transform, "empty": _empty}


@pytest.fixture(scope="module")
def ice(tmp_path_factory):
    """Each table twice: its manifests written by the port
    (``<name>@port``) and by the JAX package (``<name>@jax``)."""
    root = tmp_path_factory.mktemp("ice")
    return {f"{name}@{w}": make(str(root / f"{name}_{w}"), w)
            for name, make in ICE_TABLES.items() for w in WRITERS}


# name: (table, build(session, F, col, path), ordered, want ids)
ICE_CASES = {
    "basic_read": (
        "basic", lambda s, F, c, p: s.read.format("iceberg").load(p)
        .orderBy("id"), True, [1, 2, 3]),
    "deleted_entries_skipped": (
        "deleted_entry", lambda s, F, c, p: s.read.iceberg(p), True, [1]),
    "group_by_partition": (
        "grouped", lambda s, F, c, p: s.read.iceberg(p).groupBy("part")
        .agg(F.sum("v").alias("sv"), F.count("*").alias("n")), False,
        None),
    "position_deletes": (
        "position_deletes", lambda s, F, c, p: s.read.iceberg(p)
        .orderBy("id"), True, [2, 4, 5]),
    "position_deletes_filtered": (
        "position_deletes", lambda s, F, c, p: s.read.iceberg(p)
        .filter(c("part") == 2).select("id", "part"), True, [5]),
    "empty_table": (
        "empty", lambda s, F, c, p: s.read.iceberg(p), True, []),
}


def _deleted_rows(plan) -> int:
    total = 0

    def walk(node):
        nonlocal total
        if type(node).__name__ in ("TpuParquetScanExec",
                                   "CpuParquetScanExec"):
            m = getattr(node, "_cpu", node).metrics.get("deletedRows")
            total += 0 if m is None else m.value
        for c in node.children:
            walk(c)

    walk(plan)
    return total


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    assert got.schema == want.schema
    g = [repr(r) for r in got.to_pylist()]
    w = [repr(r) for r in want.to_pylist()]
    if not ordered:
        g, w = sorted(g), sorted(w)
    assert g == w


@pytest.mark.parametrize("writer", list(WRITERS))
@pytest.mark.parametrize("name", list(ICE_CASES))
def test_iceberg_equals_jax(ice, name, writer):
    table, build, ordered, ids = ICE_CASES[name]
    path = ice[f"{table}@{writer}"]
    df = build(TpuSession(dict(TEST), device="cpu"), F, col, path)
    jdf = build(JaxSession(dict(TEST)), JF, jcol, path)
    got, want = df.toArrow(), jdf.toArrow()
    same_rows(got, want, ordered)
    if ids is not None:
        assert got.column("id").to_pylist() == ids
    assert (df._last_override.fallback_report()
            == jdf._last_override.fallback_report())
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    assert _deleted_rows(df._last_plan) == _deleted_rows(jdf._last_plan)
    host = build(TpuSession(dict(HOST), device="cpu"), F, col, path)
    same_rows(host.toArrow(), want, ordered)
    assert _deleted_rows(host._last_plan) == _deleted_rows(jdf._last_plan)
    if name == "basic_read":
        assert got.column("part").to_pylist() == [7, 7, 8]
    if name == "position_deletes":
        # the entry for a file outside the snapshot deletes nothing
        assert _deleted_rows(df._last_plan) == 5
    if name == "empty_table":
        assert got.num_rows == 0 and "id" in got.column_names


@pytest.mark.parametrize("table, err, text", [
    ("equality_deletes", "IcebergProtocolError", "EQUALITY"),
    ("bucket_transform", "IcebergProtocolError", "transform")])
def test_iceberg_gates_raise_as_jax(ice, table, err, text):
    path = ice[f"{table}@port"]
    caught = []
    for s in (TpuSession(dict(TEST), device="cpu"), JaxSession(TEST)):
        with pytest.raises(NotImplementedError) as e:
            s.read.iceberg(path).toArrow()
        caught.append((type(e.value).__name__, str(e.value)))
    assert caught[0] == caught[1]
    assert caught[0][0] == err and text in caught[0][1]


def test_iceberg_catalog_metadata_naming(tmp_path):
    """``<version>-<uuid>.metadata.json`` without a version hint: the
    latest version wins, its uuid digits do not count, in both
    packages."""
    d = _make_iceberg(str(tmp_path / "ice"), [], "port")
    meta = os.path.join(d, "metadata")
    os.remove(os.path.join(meta, "version-hint.text"))
    src = os.path.join(meta, "v1.metadata.json")
    with open(src) as f:
        md = json.load(f)
    os.remove(src)
    stale = dict(md, **{"current-snapshot-id": None})
    with open(os.path.join(meta, "00001-99999999aaaa.metadata.json"),
              "w") as f:
        json.dump(stale, f)
    with open(os.path.join(meta, "00002-00000000bbbb.metadata.json"),
              "w") as f:
        json.dump(md, f)
    got = I._latest_metadata(d)
    assert got == JI._latest_metadata(d)
    assert got.endswith("00002-00000000bbbb.metadata.json")
    with pytest.raises(FileNotFoundError) as e:
        I._latest_metadata(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError) as je:
        JI._latest_metadata(str(tmp_path / "none"))
    assert str(e.value) == str(je.value)
