"""Minimal Avro object-container codec (pure python, no dependency).

[REF: sql-plugin/../GpuAvroScan.scala — the reference host-parses Avro;
 also the enabling piece for Iceberg: its manifest lists and manifests
 are Avro files]

The counterpart of the JAX package's ``io/avro.py``, host code in both.
Scope: the container format (magic, metadata, sync-marked blocks, null
and deflate codecs) and the binary encoding of records built from
primitives, nullable unions, arrays, maps, enums and fixed — enough for
Iceberg metadata and flat data files.  Schema resolution and evolution
are not implemented (readers use the writer schema embedded in the
file).  ``write_container`` draws a random 16-byte sync marker per file,
so two writes of the same records differ in those bytes only.
"""

from __future__ import annotations

import datetime
import io
import json
import os
import struct
import zlib
from typing import Any, List, Tuple

MAGIC = b"Obj\x01"


class AvroError(Exception):
    pass


# ---------------------------------------------------------------------------
# binary primitives
# ---------------------------------------------------------------------------

def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise AvroError("EOF in varint")
        v = b[0]
        acc |= (v & 0x7F) << shift
        if not (v & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag


def _write_long(out: io.BytesIO, v: int) -> None:
    u = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    u &= (1 << 64) - 1
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise AvroError("EOF in bytes")
    return data


def _write_bytes(out: io.BytesIO, b: bytes) -> None:
    _write_long(out, len(b))
    out.write(b)


# ---------------------------------------------------------------------------
# schema-driven decode / encode
# ---------------------------------------------------------------------------

def _norm_schema(schema):
    """Normalize: type names may be bare strings or {"type": ...}."""
    if isinstance(schema, str):
        return {"type": schema}
    return schema


def decode_value(buf: io.BytesIO, schema) -> Any:
    s = _norm_schema(schema)
    t = s["type"] if isinstance(s, dict) else s
    if isinstance(s, list):  # union
        idx = _read_long(buf)
        if not 0 <= idx < len(s):
            raise AvroError(f"union branch {idx} out of range")
        return decode_value(buf, s[idx])
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1)[0] != 0
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t in ("bytes",):
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    if t == "record":
        return {f["name"]: decode_value(buf, f["type"])
                for f in s["fields"]}
    if t == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)  # block byte size — skippable
                n = -n
            for _ in range(n):
                out.append(decode_value(buf, s["items"]))
        return out
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)
                n = -n
            for _ in range(n):
                k = _read_bytes(buf).decode("utf-8")
                out[k] = decode_value(buf, s["values"])
        return out
    if t == "enum":
        return s["symbols"][_read_long(buf)]
    if t == "fixed":
        return buf.read(s["size"])
    if isinstance(t, (dict, list)):
        return decode_value(buf, t)
    raise AvroError(f"unsupported avro type {t!r}")


def encode_value(out: io.BytesIO, schema, v: Any) -> None:
    s = _norm_schema(schema)
    t = s["type"] if isinstance(s, dict) else s
    if isinstance(s, list):  # union: first matching branch
        for i, branch in enumerate(s):
            bt = _norm_schema(branch)
            bt = bt["type"] if isinstance(bt, dict) else bt
            if (v is None) == (bt == "null"):
                _write_long(out, i)
                encode_value(out, branch, v)
                return
        raise AvroError(f"no union branch for {v!r}")
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif t in ("int", "long"):
        _write_long(out, int(v))
    elif t == "float":
        out.write(struct.pack("<f", v))
    elif t == "double":
        out.write(struct.pack("<d", v))
    elif t == "bytes":
        _write_bytes(out, bytes(v))
    elif t == "string":
        _write_bytes(out, str(v).encode("utf-8"))
    elif t == "record":
        for f in s["fields"]:
            encode_value(out, f["type"], v.get(f["name"]))
    elif t == "array":
        if v:
            _write_long(out, len(v))
            for item in v:
                encode_value(out, s["items"], item)
        _write_long(out, 0)
    elif t == "map":
        if v:
            _write_long(out, len(v))
            for k, mv in v.items():
                _write_bytes(out, str(k).encode())
                encode_value(out, s["values"], mv)
        _write_long(out, 0)
    elif t == "enum":
        _write_long(out, s["symbols"].index(v))
    elif t == "fixed":
        out.write(bytes(v))
    elif isinstance(t, (dict, list)):
        encode_value(out, t, v)
    else:
        raise AvroError(f"unsupported avro type {t!r}")


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def read_container(path: str) -> Tuple[dict, List[dict]]:
    """Avro object-container file → (writer schema, list of records)."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
    if buf.read(4) != MAGIC:
        raise AvroError(f"not an avro container: {path}")
    meta = decode_value(buf, {"type": "map", "values": "bytes"})
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported avro codec {codec!r}")
    sync = buf.read(16)
    records: List[dict] = []
    while buf.tell() < len(raw):
        n = _read_long(buf)
        size = _read_long(buf)
        block = buf.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bbuf = io.BytesIO(block)
        for _ in range(n):
            records.append(decode_value(bbuf, schema))
        if buf.read(16) != sync:
            raise AvroError("sync marker mismatch")
    return schema, records


def write_container(path: str, schema: dict, records: List[dict],
                    codec: str = "null") -> None:
    body = io.BytesIO()
    for r in records:
        encode_value(body, schema, r)
    block = body.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        block = comp.compress(block) + comp.flush()
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    encode_value(out, {"type": "map", "values": "bytes"},
                 {"avro.schema": json.dumps(schema).encode(),
                  "avro.codec": codec.encode()})
    out.write(sync)
    _write_long(out, len(records))
    _write_long(out, len(block))
    out.write(block)
    out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


# ---------------------------------------------------------------------------
# flat records → arrow (the read.avro data path)
# ---------------------------------------------------------------------------

_AVRO_TO_ARROW = {"boolean": "bool", "int": "int32", "long": "int64",
                  "float": "float32", "double": "float64",
                  "string": "string", "bytes": "binary"}


def avro_to_arrow(path: str):
    """Flat-record avro file → pyarrow.Table (primitive/nullable-union
    fields; logical types date/timestamp-micros honored)."""
    import pyarrow as pa
    schema, records = read_container(path)
    if _norm_schema(schema).get("type") != "record":
        raise AvroError("read.avro expects a record schema")
    fields = []
    for f in _norm_schema(schema)["fields"]:
        ft = f["type"]
        if isinstance(ft, list):  # nullable union
            non_null = [b for b in ft if _norm_schema(b).get(
                "type", b) != "null"]
            if len(non_null) != 1:
                raise AvroError(
                    f"field {f['name']}: only [null, T] unions supported")
            ft = non_null[0]
        ft = _norm_schema(ft)
        t = ft.get("type")
        logical = ft.get("logicalType")
        if logical == "date":
            at = pa.date32()
        elif logical == "timestamp-micros":
            at = pa.timestamp("us", tz="UTC")
        elif t in _AVRO_TO_ARROW:
            at = getattr(pa, _AVRO_TO_ARROW[t])()
        else:
            raise AvroError(
                f"field {f['name']}: avro type {t!r} not supported in "
                "read.avro (flat primitives only)")
        fields.append((f["name"], at))
    arrays = []
    for name, at in fields:
        vals = [r.get(name) for r in records]
        if pa.types.is_date32(at):
            vals = [None if v is None
                    else datetime.date(1970, 1, 1)
                    + datetime.timedelta(days=v) for v in vals]
        elif pa.types.is_timestamp(at):
            arrays.append(pa.array(
                [None if v is None else int(v) for v in vals],
                type=pa.int64()).cast(at))
            continue
        arrays.append(pa.array(vals, type=at))
    return pa.table(arrays, names=[n for n, _ in fields])
