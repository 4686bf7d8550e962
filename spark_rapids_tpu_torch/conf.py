"""Typed config registry — the ``spark.rapids.*`` keys this port reads.

The same builder DSL and the same key names as the JAX package's
``conf.py`` [REF: sql-plugin/../RapidsConf.scala :: RapidsConf], cut to
the entries the slices ported so far (TPC-H q1, q3, q4, q6) use.  Values are validated the same way:
an unknown ``spark.rapids.*`` key raises, and so does a value the
entry's checker rejects.  Keys outside the ``spark.rapids.`` namespace
are kept raw.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional

_SIZE_RE = re.compile(r"^(\d+)([kKmMgGtT]?)[bB]?$")
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(v) -> int:
    """``10485760``, ``"10m"``, ``"10MB"`` -> bytes (the JAX package's
    parser)."""
    if isinstance(v, int):
        return v
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise ValueError(f"cannot parse byte size {v!r}")
    return int(m.group(1)) * _SIZE_MULT[m.group(2).lower()]


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise ValueError(f"cannot parse boolean {v!r}")


@dataclasses.dataclass
class ConfEntry:
    key: str
    doc: str
    default: Any
    converter: Callable[[Any], Any]
    checker: Optional[Callable[[Any], bool]] = None
    check_msg: str = ""

    def convert(self, raw):
        v = self.converter(raw)
        if self.checker is not None and not self.checker(v):
            hint = f" ({self.check_msg})" if self.check_msg else ""
            raise ValueError(f"invalid value {v!r} for {self.key}{hint}")
        return v


REGISTRY: Dict[str, ConfEntry] = {}


class ConfBuilder:
    """``conf(key).doc(...).integer().create_with_default(x)``."""

    def __init__(self, key: str):
        self._key = key
        self._doc = ""
        self._converter: Callable = str
        self._checker = None
        self._check_msg = ""

    def doc(self, d: str) -> "ConfBuilder":
        self._doc = d
        return self

    def boolean(self) -> "ConfBuilder":
        self._converter = _parse_bool
        return self

    def integer(self) -> "ConfBuilder":
        self._converter = int
        return self

    def bytes(self) -> "ConfBuilder":
        self._converter = parse_bytes
        return self

    def string(self) -> "ConfBuilder":
        self._converter = str
        return self

    def check(self, fn, msg="") -> "ConfBuilder":
        self._checker = fn
        self._check_msg = msg
        return self

    def create_with_default(self, default) -> ConfEntry:
        if self._key in REGISTRY:
            raise ValueError(f"duplicate conf key {self._key}")
        e = ConfEntry(self._key, self._doc, default, self._converter,
                      self._checker, self._check_msg)
        REGISTRY[e.key] = e
        return e


def conf(key: str) -> ConfBuilder:
    return ConfBuilder(key)


BATCH_ROWS = (
    conf("spark.rapids.tpu.batchRows")
    .doc("Target device batch row count. Row counts are padded up to "
         "power-of-two buckets.")
    .integer()
    .check(lambda v: v > 0, "positive")
    .create_with_default(1 << 20)
)

MIN_BUCKET_ROWS = (
    conf("spark.rapids.tpu.minBucketRows")
    .doc("Smallest row bucket.")
    .integer()
    .check(lambda v: v > 0, "positive")
    .create_with_default(1 << 10)
)

HAS_NANS = (
    conf("spark.rapids.sql.hasNans")
    .doc("Assume float data may contain NaNs. Validated so that job "
         "configs carry over; it changes min/max only, which the port "
         "does not have yet.")
    .boolean()
    .create_with_default(True)
)

KERNEL_BACKENDS = ("auto", "cuda", "jnp")

KERNEL_BACKEND = (
    conf("spark.rapids.tpu.kernel.backend")
    .doc("Group-layout rung of the grouped aggregate: 'cuda' sorts one "
         "64-bit row hash computed by the hand-written CUDA kernel "
         "(kernels/csrc/hash_pairs.cu; its plain PyTorch version on CPU "
         "tensors); 'jnp' keeps the exact full-key sort (the JAX "
         "package's reference rung, under its name); 'auto' is 'cuda'. "
         "A detected 64-bit hash collision descends to the exact rung.")
    .string()
    .check(lambda v: v.lower() in KERNEL_BACKENDS,
           "one of " + ", ".join(KERNEL_BACKENDS))
    .create_with_default("auto")
)


BROADCAST_THRESHOLD = (
    conf("spark.sql.autoBroadcastJoinThreshold")
    .doc("Max estimated size of a join side to broadcast it (gathered "
         "once, reused per stream partition — no exchange). -1 or 0 "
         "disables broadcast joins. Spark core key, honored here.")
    .bytes()
    .create_with_default(10 << 20)
)

JOIN_TARGET_ROWS = (
    conf("spark.rapids.tpu.join.targetRows")
    .doc("Row cap for one in-core sort-merge join. When a gathered side "
         "exceeds it and the other side fits, the big side streams "
         "through the join in groups of at most this many rows (the "
         "streamed side of a broadcast join too); when neither fits, "
         "both sides hash-sub-partition into pairs of about this many "
         "rows. Join outputs are re-batched to "
         "spark.rapids.tpu.batchRows chunks.")
    .integer()
    .create_with_default(1 << 18)
)

ADAPTIVE_PLANE_ENABLED = (
    conf("spark.rapids.tpu.adaptive.enabled")
    .doc("Master switch of the JAX package's adaptive execution plane "
         "(runtime broadcast-vs-shuffled join choice, skew splitting). "
         "Not ported: true raises NotImplementedError at planning.")
    .boolean()
    .create_with_default(False)
)


class RapidsConf:
    """Validated view over a raw key -> value dict.

    [REF: RapidsConf.scala :: RapidsConf]
    """

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        unknown = []
        for k, v in dict(raw or {}).items():
            e = REGISTRY.get(k)
            if e is not None:
                self._values[k] = e.convert(v)
            elif k.startswith("spark.rapids."):
                unknown.append(k)
            else:
                self._values[k] = v
        if unknown:
            raise ValueError(f"unknown spark.rapids.* conf keys: {unknown}")

    def get(self, entry: ConfEntry):
        return self._values.get(entry.key, entry.default)

    def get_raw(self, key: str, default=None):
        return self._values.get(key, default)

    @property
    def batch_rows(self) -> int:
        return self.get(BATCH_ROWS)

    @property
    def min_bucket_rows(self) -> int:
        return self.get(MIN_BUCKET_ROWS)

    @property
    def kernel_backend(self) -> str:
        return str(self.get(KERNEL_BACKEND)).lower()
