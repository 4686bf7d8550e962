"""Iceberg read path: metadata.json → manifest list → manifests → scan.

[REF: iceberg/src/main/scala :: GpuIcebergParquetReader, iceberg scan
 metas] — the reference plugs its GPU parquet reader under Iceberg's
scan planning.  Here the table format itself is implemented against the
public Iceberg spec (v1/v2): the current snapshot's manifest list and
manifest files (Avro, read by this package's ``io/avro.py``) flatten
into a data-file list with identity-transform partition values and
per-file v2 position deletes, which feeds the port's file scan
(``io/parquet.py``: pruning, DPP and the delete mask apply).

The counterpart of the JAX package's ``io/iceberg.py``, host code in
both.  Gated with ``IcebergProtocolError``: equality delete files,
non-identity partition transforms, non-parquet data files.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.io.avro import read_container


class IcebergProtocolError(NotImplementedError):
    pass


_PRIMITIVES = {
    "boolean": T.BooleanT, "int": T.IntegerT, "long": T.LongT,
    "float": T.FloatT, "double": T.DoubleT, "date": T.DateT,
    "string": T.StringT, "binary": T.BinaryT,
    "timestamp": T.TimestampT, "timestamptz": T.TimestampT,
}


def _parse_iceberg_type(t) -> T.DataType:
    if isinstance(t, str):
        if t in _PRIMITIVES:
            return _PRIMITIVES[t]
        if t.startswith("decimal("):
            p, s = t[len("decimal("):-1].split(",")
            return T.DecimalType(int(p), int(s))
        raise IcebergProtocolError(f"iceberg type {t!r} not supported")
    if isinstance(t, dict) and t.get("type") == "list":
        return T.ArrayType(_parse_iceberg_type(t["element"]))
    raise IcebergProtocolError(f"iceberg type {t!r} not supported")


def _current_schema_spec(md: dict) -> dict:
    schemas = md.get("schemas")
    if schemas:
        sid = md.get("current-schema-id", 0)
        return next((s for s in schemas if s.get("schema-id") == sid),
                    schemas[-1])
    return md["schema"]  # v1 single-schema layout


def _schema_from_metadata(md: dict) -> T.StructType:
    fields = []
    for f in _current_schema_spec(md)["fields"]:
        fields.append(T.StructField(
            f["name"], _parse_iceberg_type(f["type"]),
            not f.get("required", False)))
    return T.StructType(tuple(fields))


def _latest_metadata(table_path: str) -> str:
    meta_dir = os.path.join(table_path, "metadata")
    hint = os.path.join(meta_dir, "version-hint.text")
    if os.path.exists(hint):
        with open(hint) as f:
            v = f.read().strip()
        cand = os.path.join(meta_dir, f"v{v}.metadata.json")
        if os.path.exists(cand):
            return cand
    best: Optional[str] = None
    best_v = -1
    for fn in os.listdir(meta_dir) if os.path.isdir(meta_dir) else ():
        if fn.endswith(".metadata.json"):
            # 'v3.metadata.json' or catalog-written
            # '00003-<uuid>.metadata.json' — the version is the numeric
            # prefix (before any '-'), never the uuid digits
            stem = fn.split(".")[0].split("-")[0].lstrip("v")
            v = int(stem) if stem.isdigit() else 0
            if v > best_v:
                best_v, best = v, os.path.join(meta_dir, fn)
    if best is None:
        raise FileNotFoundError(
            f"not an iceberg table (no metadata/*.metadata.json): "
            f"{table_path}")
    return best


def _resolve_path(p: str, table_path: str) -> str:
    if p.startswith("file://"):
        p = p[len("file://"):]
    if os.path.isabs(p):
        return p
    return os.path.join(table_path, p)


def load_snapshot(table_path: str):
    """(table schema, partition field names, [(path, {pcol: value})],
    per-file deleted-position arrays | None)."""
    with open(_latest_metadata(table_path)) as f:
        md = json.load(f)
    schema = _schema_from_metadata(md)
    # identity partition columns from the default spec
    specs = md.get("partition-specs") or (
        [{"fields": md.get("partition-spec", [])}])
    spec_id = md.get("default-spec-id", 0)
    spec = next((s for s in specs if s.get("spec-id", 0) == spec_id),
                specs[-1] if specs else {"fields": []})
    part_cols: List[str] = []
    field_by_id = {f["id"]: f["name"]
                   for f in _current_schema_spec(md).get("fields", [])}
    for pf in spec.get("fields", []):
        if pf.get("transform", "identity") != "identity":
            raise IcebergProtocolError(
                f"partition transform {pf.get('transform')!r} is not "
                "supported (identity only)")
        part_cols.append(pf.get("name")
                         or field_by_id.get(pf.get("source-id")))

    snap_id = md.get("current-snapshot-id")
    if snap_id in (None, -1):
        return schema, part_cols, [], None
    snap = next(s for s in md.get("snapshots", [])
                if s.get("snapshot-id") == snap_id)
    files: List[tuple] = []
    if "manifest-list" in snap:
        ml_path = _resolve_path(snap["manifest-list"], table_path)
        _, entries = read_container(ml_path)
        manifests = [_resolve_path(e["manifest_path"], table_path)
                     for e in entries]
    else:  # v1 inline manifest array
        manifests = [_resolve_path(p, table_path)
                     for p in snap.get("manifests", [])]
    delete_files: List[str] = []
    for mpath in manifests:
        _, entries = read_container(mpath)
        for e in entries:
            status = e.get("status", 1)
            if status == 2:  # DELETED
                continue
            df = e["data_file"]
            content = df.get("content", 0)
            if content == 1:
                # v2 POSITION deletes: a parquet file of
                # (file_path, pos) rows — collected here, applied as
                # per-file row masks at scan [REF: iceberg spec
                # "Position Delete Files"; GpuDeleteFilter]
                delete_files.append(
                    _resolve_path(df["file_path"], table_path))
                continue
            if content != 0:
                raise IcebergProtocolError(
                    "iceberg EQUALITY delete files (content=2) are not "
                    "supported — compact the table, or read with the "
                    "reference engine")
            fmt = str(df.get("file_format", "PARQUET")).upper()
            if fmt != "PARQUET":
                raise IcebergProtocolError(
                    f"iceberg data format {fmt!r} not supported")
            part = df.get("partition") or {}
            files.append((_resolve_path(df["file_path"], table_path),
                          dict(part)))
    files = sorted(files, key=lambda t: t[0])
    deletes = None
    if delete_files:
        deletes = _load_position_deletes(
            delete_files, [p for p, _ in files], table_path)
    return schema, part_cols, files, deletes


def _load_position_deletes(delete_files: List[str],
                           data_paths: List[str], table_path: str):
    """Read position-delete parquet files → per-data-file sorted
    position arrays aligned with ``data_paths``.

    The spec's file_path values are the manifests' (possibly
    absolute/URI) paths; match both the raw string and the resolved
    local path so synthesized and real tables both hit."""
    by_path = {}
    for i, p in enumerate(data_paths):
        by_path[p] = i
        by_path[os.path.abspath(p)] = i
    acc: dict = {}
    for dp in delete_files:
        tbl = pq.read_table(dp, columns=["file_path", "pos"])
        for fp, pos in zip(tbl.column("file_path").to_pylist(),
                           tbl.column("pos").to_pylist()):
            i = by_path.get(fp)
            if i is None:
                i = by_path.get(_resolve_path(fp, table_path))
            if i is None:
                continue  # deletes for a file not in this snapshot
            acc.setdefault(i, []).append(pos)
    out = [None] * len(data_paths)
    for i, lst in acc.items():
        out[i] = np.unique(np.asarray(lst, dtype=np.int64))
    return out


def iceberg_relation(table_path: str):
    from spark_rapids_tpu_torch.plan.logical import ParquetRelation
    schema, part_cols, files, deletes = load_snapshot(table_path)
    data_fields = tuple(f for f in schema.fields
                        if f.name not in part_cols)
    part_fields = tuple(f for f in schema.fields if f.name in part_cols)
    paths = [p for p, _ in files]
    pvals = [pv for _, pv in files]
    out_schema = T.StructType(data_fields + part_fields)
    return ParquetRelation(
        paths, out_schema, format="parquet",
        partition_values=pvals if part_fields else None,
        partition_fields=part_fields, deletes=deletes)
