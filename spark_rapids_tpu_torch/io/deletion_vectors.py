"""Delta deletion-vector (DV) decoding — row-level deletes at read.

[REF: delta-io PROTOCOL.md "Deletion Vectors" + delta-storage
 RoaringBitmapArray; spark-rapids GpuDeltaParquetFileFormat applies the
 same vectors as a row mask during the parquet decode]

A DV marks deleted row positions of ONE data file as a 64-bit roaring
bitmap ("RoaringBitmapArray"): the 64-bit position space is split into
2^32 buckets by the high 32 bits; each non-empty bucket holds a standard
32-bit Roaring bitmap of the low bits.  Wire layout implemented here:

* descriptor (in the `add` action): ``storageType`` 'i' (inline),
  'u' (relative file, name derived from a z85-encoded UUID) or
  'p' (absolute path); ``pathOrInlineDv``; ``offset`` (file storage);
  ``sizeInBytes``; ``cardinality``.
* serialized blob: int32 LE magic 1681511377, then int64 LE bucket
  count, then per bucket: int32 LE high-key + a standard
  `Roaring format spec <https://github.com/RoaringBitmap/RoaringFormatSpec>`_
  32-bit bitmap (cookies 12346/12347, array/bitmap/run containers).
* file storage: 1 version byte (=1) at offset 0; each blob at its
  descriptor ``offset`` as int32 BE length, blob bytes, int32 BE CRC32
  (Java DataOutputStream framing around a little-endian payload).

The counterpart of the JAX package's ``io/deletion_vectors.py``, host
code in both.  The writers mirror the parser; real tables produced by
Delta decode identically — any divergence fails loudly (magic and
cookie checks), never silently drops deletes.  The decoded positions
are FILE-absolute: the scan rebuilds them after row-group pruning.
"""

from __future__ import annotations

import os
import struct
import uuid
import zlib
from typing import List

import numpy as np

MAGIC = 1681511377
SERIAL_COOKIE_NO_RUN = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4

_Z85_CHARS = ("0123456789abcdefghijklmnopqrstuvwxyz"
              "ABCDEFGHIJKLMNOPQRSTUVWXYZ.-:+=^!/*?&<>()[]{}@%$#")
_Z85_MAP = {c: i for i, c in enumerate(_Z85_CHARS)}


def z85_decode(s: str) -> bytes:
    """ZeroMQ base85 (the encoding Delta uses for DV file UUIDs)."""
    if len(s) % 5:
        raise ValueError(f"z85 length {len(s)} not a multiple of 5")
    out = bytearray()
    for i in range(0, len(s), 5):
        v = 0
        for c in s[i:i + 5]:
            v = v * 85 + _Z85_MAP[c]
        out += v.to_bytes(4, "big")
    return bytes(out)


def z85_encode(b: bytes) -> str:
    if len(b) % 4:
        raise ValueError(f"z85 input length {len(b)} not a multiple of 4")
    out = []
    for i in range(0, len(b), 4):
        v = int.from_bytes(b[i:i + 4], "big")
        chunk = []
        for _ in range(5):
            v, r = divmod(v, 85)
            chunk.append(_Z85_CHARS[r])
        out.extend(reversed(chunk))
    return "".join(out)


def _parse_roaring32(buf: memoryview, off: int):
    """One standard-format 32-bit Roaring bitmap → (uint32 values, end
    offset)."""
    cookie = struct.unpack_from("<i", buf, off)[0]
    has_runs = (cookie & 0xFFFF) == SERIAL_COOKIE
    if has_runs:
        n = (cookie >> 16) + 1
        off += 4
        run_flags = bytes(buf[off:off + (n + 7) // 8])
        off += (n + 7) // 8
    elif cookie == SERIAL_COOKIE_NO_RUN:
        n = struct.unpack_from("<i", buf, off + 4)[0]
        off += 8
        run_flags = b"\x00" * ((n + 7) // 8)
    else:
        raise ValueError(f"bad roaring cookie {cookie}")
    keys = np.zeros(n, np.uint32)
    cards = np.zeros(n, np.int64)
    for i in range(n):
        k, c = struct.unpack_from("<HH", buf, off)
        keys[i], cards[i] = k, c + 1
        off += 4
    if (not has_runs) or n >= NO_OFFSET_THRESHOLD:
        off += 4 * n  # container offsets — sequential parse ignores them
    parts: List[np.ndarray] = []
    for i in range(n):
        is_run = bool(run_flags[i // 8] & (1 << (i % 8)))
        base = np.uint32(keys[i]) << np.uint32(16)
        if is_run:
            n_runs = struct.unpack_from("<H", buf, off)[0]
            off += 2
            vals = []
            for _ in range(n_runs):
                start, length = struct.unpack_from("<HH", buf, off)
                off += 4
                vals.append(np.arange(start, start + length + 1,
                                      dtype=np.uint32))
            lo = (np.concatenate(vals) if vals
                  else np.zeros(0, np.uint32))
        elif cards[i] > 4096:
            # bitmap container: 8 KiB bitset
            words = np.frombuffer(buf, np.uint8, 8192, off)
            off += 8192
            bits = np.unpackbits(words, bitorder="little")
            lo = np.nonzero(bits)[0].astype(np.uint32)
        else:
            lo = np.frombuffer(buf, np.uint16, int(cards[i]),
                               off).astype(np.uint32)
            off += 2 * int(cards[i])
        parts.append(base | lo)
    vals = (np.concatenate(parts) if parts else np.zeros(0, np.uint32))
    return vals, off


def parse_bitmap_array(blob: bytes) -> np.ndarray:
    """Serialized RoaringBitmapArray → sorted int64 positions."""
    buf = memoryview(blob)
    magic = struct.unpack_from("<i", buf, 0)[0]
    if magic != MAGIC:
        raise ValueError(f"bad deletion-vector magic {magic}")
    nbuckets = struct.unpack_from("<q", buf, 4)[0]
    off = 12
    out: List[np.ndarray] = []
    for _ in range(nbuckets):
        high = struct.unpack_from("<i", buf, off)[0]
        off += 4
        lows, off = _parse_roaring32(buf, off)
        out.append((np.int64(high) << np.int64(32))
                   | lows.astype(np.int64))
    if not out:
        return np.zeros(0, np.int64)
    return np.sort(np.concatenate(out))


def dv_file_name(table_path: str, path_or_inline: str) -> str:
    """'u' storage: pathOrInlineDv = <raw random prefix chars> + the
    20-char z85 encoding of the 16-byte UUID (delta-spark splits with
    dropRight(20)/takeRight(20) — the PREFIX is raw text, only the UUID
    is encoded); file = <prefix>/deletion_vector_<uuid>.bin."""
    if len(path_or_inline) < 20:
        raise ValueError(
            f"deletion vector path {path_or_inline!r} shorter than a "
            "z85 UUID")
    prefix = path_or_inline[:-20]
    uid = z85_decode(path_or_inline[-20:])
    name = f"deletion_vector_{uuid.UUID(bytes=uid)}.bin"
    if prefix:
        return os.path.join(table_path, prefix, name)
    return os.path.join(table_path, name)


def read_dv(descriptor: dict, table_path: str) -> np.ndarray:
    """DV descriptor (the `add` action's ``deletionVector``) → sorted
    int64 deleted positions."""
    st = descriptor.get("storageType")
    pod = descriptor["pathOrInlineDv"]
    if st == "i":
        blob = z85_decode(pod)
        size = int(descriptor.get("sizeInBytes", 0) or 0)
        if size:
            blob = blob[:size]  # z85 pads to 4-byte groups
        return parse_bitmap_array(blob)
    if st == "u":
        path = dv_file_name(table_path, pod)
    elif st == "p":
        path = pod
    else:
        raise ValueError(f"unknown DV storage type {st!r}")
    offset = int(descriptor.get("offset", 0) or 0)
    with open(path, "rb") as f:
        f.seek(offset)
        (size,) = struct.unpack(">i", f.read(4))
        blob = f.read(size)
        (crc,) = struct.unpack(">I", f.read(4))
    if (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
        raise ValueError(f"deletion vector checksum mismatch in {path}")
    return parse_bitmap_array(blob)


# ---------------------------------------------------------------------------
# writer side — builds tables with deletes (tests, chip_smoke.py's Delta
# table); the format mirror of the parser above
# ---------------------------------------------------------------------------

def serialize_bitmap_array(positions) -> bytes:
    positions = np.asarray(sorted(set(int(p) for p in positions)),
                           np.int64)
    out = bytearray(struct.pack("<i", MAGIC))
    highs = positions >> np.int64(32)
    out += struct.pack("<q", len(np.unique(highs)) if len(positions)
                       else 0)
    for h in np.unique(highs):
        lows = (positions[highs == h] & np.int64(0xFFFFFFFF)).astype(
            np.uint32)
        out += struct.pack("<i", int(h))
        out += _serialize_roaring32(lows)
    return bytes(out)


def _serialize_roaring32(vals: np.ndarray) -> bytes:
    keys = np.unique(vals >> np.uint32(16))
    n = len(keys)
    out = bytearray(struct.pack("<ii", SERIAL_COOKIE_NO_RUN, n))
    conts = []
    for k in keys:
        lo = (vals[(vals >> np.uint32(16)) == k]
              & np.uint32(0xFFFF)).astype(np.uint16)
        out += struct.pack("<HH", int(k), len(lo) - 1)
        if len(lo) > 4096:
            bits = np.zeros(65536, np.uint8)
            bits[lo] = 1
            conts.append(np.packbits(bits, bitorder="little").tobytes())
        else:
            conts.append(lo.tobytes())
    off = len(out) + 4 * n
    for c in conts:
        out += struct.pack("<i", off)
        off += len(c)
    for c in conts:
        out += c
    return bytes(out)


def write_dv_file(path: str, positions) -> dict:
    """Write a single-DV file; returns the descriptor dict for the
    `add` action (absolute-path storage)."""
    blob = serialize_bitmap_array(positions)
    with open(path, "wb") as f:
        f.write(b"\x01")  # format version
        offset = f.tell()
        f.write(struct.pack(">i", len(blob)))
        f.write(blob)
        f.write(struct.pack(">I", zlib.crc32(blob) & 0xFFFFFFFF))
    return {"storageType": "p", "pathOrInlineDv": path,
            "offset": offset, "sizeInBytes": len(blob),
            "cardinality": len(set(int(p) for p in positions))}
