"""Delta Lake read path: transaction-log snapshot reconstruction.

[REF: delta-lake/common/../GpuDeltaParquetFileFormat, GpuDeltaLog,
 RapidsDeltaUtils] — the reference accelerates Delta through its GPU
parquet reader per Delta version module.  Here the log protocol itself
is implemented once (it is an open spec): JSON commits and optional
parquet checkpoints replay into a snapshot {add-file set, partition
values, schema, deletion vectors}, which then rides the port's file
scan (``io/parquet.py``) — so column pruning, row-group statistics
pruning and dynamic partition pruning apply to Delta tables too.

The counterpart of the JAX package's ``io/delta.py``, host code in both.
Supported: commits, checkpoints (``_last_checkpoint`` pointer),
add/remove reconciliation, partition values, ``schemaString``, deletion
vectors (decoded at load by ``io/deletion_vectors.py``, applied by the
scan as a row mask).  Gated with ``DeltaProtocolError``: column mapping
(id/name modes), non-parquet data, unknown reader features.
"""

from __future__ import annotations

import datetime
import decimal
import json
import os
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

import pyarrow.parquet as pq

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.io.deletion_vectors import read_dv


class DeltaProtocolError(NotImplementedError):
    pass


_PRIMITIVES = {
    "string": T.StringT, "long": T.LongT, "integer": T.IntegerT,
    "short": T.ShortT, "byte": T.ByteT, "float": T.FloatT,
    "double": T.DoubleT, "boolean": T.BooleanT, "binary": T.BinaryT,
    "date": T.DateT, "timestamp": T.TimestampT,
}


def _parse_delta_type(t) -> T.DataType:
    if isinstance(t, str):
        if t in _PRIMITIVES:
            return _PRIMITIVES[t]
        if t.startswith("decimal("):
            p, s = t[len("decimal("):-1].split(",")
            return T.DecimalType(int(p), int(s))
        raise DeltaProtocolError(f"delta type {t!r} not supported")
    if isinstance(t, dict) and t.get("type") == "array":
        return T.ArrayType(_parse_delta_type(t["elementType"]))
    raise DeltaProtocolError(f"delta type {t!r} not supported")


def _parse_schema_string(s: str) -> T.StructType:
    spec = json.loads(s)
    fields = []
    for f in spec["fields"]:
        fields.append(T.StructField(f["name"], _parse_delta_type(
            f["type"]), bool(f.get("nullable", True))))
    return T.StructType(tuple(fields))


def _partition_value(raw: Optional[str], dt: T.DataType):
    """Delta stores partition values as strings (null = None)."""
    if raw is None:
        return None
    if isinstance(dt, (T.LongType, T.IntegerType, T.ShortType,
                       T.ByteType)):
        return int(raw)
    if isinstance(dt, (T.DoubleType, T.FloatType)):
        return float(raw)
    if isinstance(dt, T.BooleanType):
        return raw.lower() == "true"
    if isinstance(dt, T.DateType):
        return datetime.date.fromisoformat(raw)
    if isinstance(dt, T.TimestampType):
        v = datetime.datetime.fromisoformat(raw)
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        return v
    if isinstance(dt, T.DecimalType):
        return decimal.Decimal(raw)
    return raw


def _as_dict(v):
    """Arrow map columns deserialize as [(k, v), ...] — normalize."""
    if isinstance(v, list):
        return dict(v)
    return v or {}


class DeltaSnapshot:
    def __init__(self, schema: T.StructType, partition_columns: List[str],
                 files: List[Tuple[str, Dict, Optional[Dict]]]):
        self.schema = schema  # full table schema incl. partition cols
        self.partition_columns = partition_columns
        # [(abs path, raw partitionValues dict, DV descriptor | None)]
        self.files = files


def _apply_action(state: dict, action: dict) -> None:
    if "metaData" in action:
        md = action["metaData"]
        fmt = md.get("format", {}).get("provider", "parquet")
        if fmt != "parquet":
            raise DeltaProtocolError(f"delta data format {fmt!r}")
        cfg = _as_dict(md.get("configuration"))
        if cfg.get("delta.columnMapping.mode", "none") not in (
                "none", None):
            raise DeltaProtocolError(
                "delta column mapping (id/name mode) is not supported")
        state["schema"] = _parse_schema_string(md["schemaString"])
        state["partition_columns"] = list(md.get("partitionColumns", []))
    if "protocol" in action:
        p = action["protocol"]
        if int(p.get("minReaderVersion", 1)) > 2:
            feats = p.get("readerFeatures") or []
            unsupported = [f for f in feats
                           if f not in ("timestampNtz", "columnMapping",
                                        "deletionVectors")]
            if "columnMapping" in feats:
                raise DeltaProtocolError("delta column mapping feature")
            if unsupported:
                raise DeltaProtocolError(
                    f"delta reader features {unsupported} not supported")
    if "add" in action:
        a = action["add"]
        # deletion vectors decode at load (io/deletion_vectors.py) and
        # apply as a scan-time row mask
        state["files"][a["path"]] = (
            _as_dict(a.get("partitionValues")),
            _as_dict(a.get("deletionVector")) or None)
    if "remove" in action:
        state["files"].pop(action["remove"]["path"], None)


def _read_checkpoint(path: str, state: dict) -> None:
    pf = pq.ParquetFile(path)
    # project away per-file stats/txn/commitInfo — only actions matter
    want = [c for c in ("metaData", "protocol", "add", "remove")
            if c in pf.schema_arrow.names]
    tbl = pf.read(columns=want)
    for row in tbl.to_pylist():
        action = {k: v for k, v in row.items() if v is not None}
        _apply_action(state, action)


def load_snapshot(table_path: str) -> DeltaSnapshot:
    log_dir = os.path.join(table_path, "_delta_log")
    if not os.path.isdir(log_dir):
        raise FileNotFoundError(
            f"not a delta table (no _delta_log): {table_path}")
    state = {"schema": None, "partition_columns": [], "files": {}}
    start_version = 0
    last_cp = os.path.join(log_dir, "_last_checkpoint")
    if os.path.exists(last_cp):
        with open(last_cp) as f:
            cp = json.load(f)
        v = int(cp["version"])
        parts = int(cp.get("parts", 0) or 0)
        if parts:
            cps = [os.path.join(
                log_dir, f"{v:020d}.checkpoint.{i + 1:010d}."
                         f"{parts:010d}.parquet") for i in range(parts)]
        else:
            cps = [os.path.join(log_dir, f"{v:020d}.checkpoint.parquet")]
        for p in cps:
            _read_checkpoint(p, state)
        start_version = v + 1
    versions = []
    for fn in os.listdir(log_dir):
        if fn.endswith(".json") and fn[:-5].isdigit():
            ver = int(fn[:-5])
            if ver >= start_version:
                versions.append((ver, fn))
    versions.sort()
    # Delta readers must verify commit contiguity — a gap means a
    # missing commit and a silently wrong snapshot
    for i, (ver, _) in enumerate(versions):
        if ver != start_version + i:
            raise DeltaProtocolError(
                f"delta log has a gap: expected version "
                f"{start_version + i}, found {ver}")
    for _, fn in versions:
        with open(os.path.join(log_dir, fn)) as f:
            for line in f:
                line = line.strip()
                if line:
                    _apply_action(state, json.loads(line))
    if state["schema"] is None:
        raise DeltaProtocolError(
            f"delta log at {table_path} has no metaData action")
    # add.path is an RFC 2396 percent-encoded relative URI per the spec
    files = [(os.path.join(table_path, unquote(p)), pv, dv)
             for p, (pv, dv) in sorted(state["files"].items())]
    return DeltaSnapshot(state["schema"], state["partition_columns"],
                         files)


def delta_relation(table_path: str):
    """DeltaSnapshot → the engine's ParquetRelation (scan stack reuse)."""
    from spark_rapids_tpu_torch.plan.logical import ParquetRelation
    snap = load_snapshot(table_path)
    part_cols = snap.partition_columns
    data_fields = tuple(f for f in snap.schema.fields
                        if f.name not in part_cols)
    part_fields = tuple(f for f in snap.schema.fields
                        if f.name in part_cols)
    by_name = {f.name: f for f in part_fields}
    paths = [p for p, _, _ in snap.files]
    pvals = [{k: _partition_value(v, by_name[k].dtype)
              for k, v in pv.items() if k in by_name}
             for _, pv, _ in snap.files]
    deletes = None
    if any(dv for _, _, dv in snap.files):
        deletes = [read_dv(dv, table_path) if dv else None
                   for _, _, dv in snap.files]
    schema = T.StructType(data_fields + part_fields)
    return ParquetRelation(
        paths, schema, format="parquet",
        partition_values=pvals if part_fields else None,
        partition_fields=part_fields, deletes=deletes)
