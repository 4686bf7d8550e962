"""Time-zone conversions over transition tables: ``from_utc_timestamp``
and ``to_utc_timestamp``.

[REF: spark-rapids-jni :: src/main/cpp/src/GpuTimeZoneDB — the zone
 rules loaded into device tables, a binary search of the transitions
 per row]

The counterpart of the JAX package's ``ops/timezone.py``, bit for bit:
each zone's TZif file (the operating system's tzdata, found along
``zoneinfo.TZPATH``) parses into two sorted arrays, the transition
instants (int64 seconds) and the UTC offset in force from each (int32
seconds), entry 0 a sentinel carrying the zone's offset before its first
transition.  A row's offset is one ``searchsorted`` and a gather, on the
device over tensors cached per (zone, device), on the host in numpy.

Semantics kept from the reference (its documented divergences):

* ``to_utc_timestamp`` keys the table by local wall seconds, so a wall
  time in a DST overlap takes the post-transition offset (Java takes the
  pre-transition one): results can differ by the DST delta inside the
  overlap, which is why the expression is ``incompat``;
* instants past the file's last transition keep its last offset (the
  TZif footer's rule string is not evaluated).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.host import HostCol
from spark_rapids_tpu_torch.ops.expressions import Expression

_SENTINEL = -(1 << 62)


def _tz_path(name: str) -> str:
    import zoneinfo
    for base in zoneinfo.TZPATH:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise ValueError(f"unknown timezone {name!r}")


def parse_tzif(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """TZif v1/v2/v3 -> (transitions int64[T+1], offsets int32[T+1]).

    Entry 0 is a -inf sentinel carrying the zone's pre-history offset,
    so ``searchsorted(..., 'right') - 1`` is always a valid index."""
    with open(_tz_path(name), "rb") as f:
        raw = f.read()

    def parse_block(buf, off, time_size):
        fmt = ">i" if time_size == 4 else ">q"
        if buf[off:off + 4] != b"TZif":
            raise ValueError(f"timezone {name!r}: not a TZif file")
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6I", buf[off + 20:off + 44])
        p = off + 44
        trans = np.frombuffer(
            buf, dtype=np.dtype(fmt), count=timecnt, offset=p
        ).astype(np.int64)
        p += timecnt * time_size
        idxs = np.frombuffer(buf, np.uint8, timecnt, p)
        p += timecnt
        utoffs = np.zeros(typecnt, np.int32)
        isdst = np.zeros(typecnt, np.uint8)
        for t in range(typecnt):
            utoff, dst, _ = struct.unpack(">iBB", buf[p:p + 6])
            utoffs[t] = utoff
            isdst[t] = dst
            p += 6
        p += charcnt + leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return (trans, idxs, utoffs, isdst), p

    (trans, idxs, utoffs, isdst), end = parse_block(raw, 0, 4)
    if raw[4:5] in (b"2", b"3"):
        (trans, idxs, utoffs, isdst), _ = parse_block(raw, end, 8)
    # pre-history offset: the first non-dst type, else type 0 (RFC 8536)
    std = np.nonzero(isdst == 0)[0]
    first_off = int(utoffs[std[0]] if len(std) else utoffs[0]) \
        if len(utoffs) else 0
    transitions = np.concatenate(
        [np.array([_SENTINEL], np.int64), trans])
    offsets = np.concatenate(
        [np.array([first_off], np.int32),
         utoffs[idxs].astype(np.int32) if len(trans) else
         np.zeros(0, np.int32)])
    return transitions, offsets


class _TzCache:
    """Host tables per zone, and their tensors per (zone, device), for
    the process's lifetime."""

    def __init__(self):
        self._lock = threading.Lock()
        self._host: Dict[str, tuple] = {}
        self._dev: Dict[Tuple[str, torch.device], tuple] = {}

    def host(self, name: str):
        """(transitions, offsets, local transitions) of a zone; raises
        ``ValueError`` for an unknown one."""
        with self._lock:
            if name not in self._host:
                trans, offs = parse_tzif(name)
                # keyed by local wall seconds, for the to_utc direction
                local = trans.astype(np.int64) + offs.astype(np.int64)
                self._host[name] = (trans, offs, local)
            return self._host[name]

    def device(self, name: str, device: torch.device):
        trans, offs, local = self.host(name)
        key = (name, torch.device(device))
        with self._lock:
            if key not in self._dev:
                self._dev[key] = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (trans, offs.astype(np.int64), local))
            return self._dev[key]


TZ_CACHE = _TzCache()


def _offsets_us(table: torch.Tensor, offs: torch.Tensor,
                ts_us: torch.Tensor) -> torch.Tensor:
    """The offset (microseconds) in force at each row's second."""
    secs = torch.div(ts_us, 1_000_000, rounding_mode="floor")
    idx = torch.searchsorted(table, secs, right=True) - 1
    return offs[idx] * 1_000_000


def _offsets_us_h(table: np.ndarray, offs: np.ndarray,
                  ts_us: np.ndarray) -> np.ndarray:
    secs = np.floor_divide(ts_us.astype(np.int64), 1_000_000)
    idx = np.searchsorted(table, secs, side="right") - 1
    return offs[idx].astype(np.int64) * 1_000_000


@dataclasses.dataclass
class FromUTCTimestamp(Expression):
    """from_utc_timestamp(ts, tz): the UTC instant re-rendered as the
    zone's wall time."""

    child: Expression
    tz: str
    dtype: T.DataType = dataclasses.field(default_factory=T.TimestampType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        trans, offs, _ = TZ_CACHE.device(self.tz, batch.device)
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype,
                            c.data + _offsets_us(trans, offs, c.data),
                            c.validity)

    def eval_cpu(self, batch):
        trans, offs, _ = TZ_CACHE.host(self.tz)
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype,
                       c.data + _offsets_us_h(trans, offs, c.data),
                       c.validity)


@dataclasses.dataclass
class ToUTCTimestamp(Expression):
    """to_utc_timestamp(ts, tz): a wall time in the zone -> the UTC
    instant (the overlap caveat in the module docstring)."""

    child: Expression
    tz: str
    dtype: T.DataType = dataclasses.field(default_factory=T.TimestampType)
    incompat = ("DST overlap resolves to the post-transition offset "
                "(Java uses pre-transition)")

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        _, offs, local = TZ_CACHE.device(self.tz, batch.device)
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype,
                            c.data - _offsets_us(local, offs, c.data),
                            c.validity)

    def eval_cpu(self, batch):
        _, offs, local = TZ_CACHE.host(self.tz)
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype,
                       c.data - _offsets_us_h(local, offs, c.data),
                       c.validity)
