"""The shape plane — canonical batch-shape bucketing.

The counterpart of the JAX package's ``runtime/shapes.py``.  There it
bounds the XLA compiles a sweep can trigger: every kernel compiles per
(op, schema, row bucket), and join group slices, sub-partitions and
trimmed concats emit straggler capacities.  The port's eager kernels
compile nothing per shape, so padding saves no compile here; the port
keeps the JAX package's policy all the same, because capacities feed
decisions downstream (the aggregate's repartition rule, the join's
sub-partition sizes) and the two packages must take the same ones.
``exec/base.py`` pins every pumped ``DeviceBatch`` to the policy's
bucket at the operator boundary.

Padding is dead-row padding: appended rows carry ``sel=False`` (and
zeroed data, validity and lengths), which every kernel already ignores.
A compacted batch stays compacted: pad rows extend the dead tail.

Policies (``spark.rapids.tpu.kernel.bucketing``):

* ``pow2``   — round capacity up to the next power of two, floored at
  ``spark.rapids.tpu.minBucketRows``;
* ``ladder`` — round up to the smallest rung of
  ``spark.rapids.tpu.kernel.bucketLadder``; capacities above the top
  rung, and rungs that would exceed
  ``spark.rapids.tpu.kernel.maxPadFraction`` of padding, fall back to
  pow2;
* ``off``    — pass batches through untouched.

Hits, misses, pad rows and pad bytes are the registry's
``tpuq_shape_*`` counters (``snapshot`` reads them); the pump records
each operator's pad rows in the stats plane as ``padded_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, _pad_col, round_up_pow2)
from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

_TM_HITS = TM.REGISTRY.counter(
    "tpuq_shape_bucket_hits_total",
    "pumped device batches whose capacity already sat on the bucket "
    "ladder (no padding)")
_TM_MISSES = TM.REGISTRY.counter(
    "tpuq_shape_bucket_misses_total",
    "pumped device batches padded up to a canonical bucket")
_TM_PAD_ROWS = TM.REGISTRY.counter(
    "tpuq_shape_pad_rows_total",
    "dead rows appended by shape-plane bucketing")
_TM_PAD_BYTES = TM.REGISTRY.counter(
    "tpuq_shape_pad_bytes_total",
    "physical bytes of shape-plane padding (pad-waste)")


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """One immutable bucketing policy (the conf snapshot, parsed)."""

    mode: str = "off"                  # off | pow2 | ladder
    ladder: Tuple[int, ...] = ()       # strictly increasing rungs
    max_pad_fraction: float = 0.75     # ladder-rung pad budget
    min_bucket: int = 1 << 10

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def bucket_for(self, capacity: int) -> int:
        """Canonical bucket (>= capacity) for a batch capacity.

        Ladder rungs are only taken within the pad budget; everything
        else (including capacities above the top rung) rounds pow2."""
        capacity = max(int(capacity), 1)
        if self.mode == "ladder":
            for rung in self.ladder:
                if rung >= capacity:
                    if (rung - capacity) / rung <= self.max_pad_fraction:
                        return rung
                    break  # smallest fitting rung over budget: pow2
        return round_up_pow2(capacity, self.min_bucket)


# The active policy: the session installs it once and every pump
# boundary reads one attribute.
_POLICY = ShapePolicy()
_LOCK = lockdep.tracked_lock("runtime.shapes._LOCK")


def configure(conf) -> ShapePolicy:
    """Install the policy from a session's RapidsConf."""
    from spark_rapids_tpu_torch import conf as C
    mode = str(conf.get(C.KERNEL_BUCKETING)).lower()
    raw = str(conf.get(C.KERNEL_BUCKET_LADDER)).strip()
    ladder = tuple(int(x.strip()) for x in raw.split(",")) if raw else ()
    pol = ShapePolicy(
        mode=mode,
        ladder=ladder,
        max_pad_fraction=float(conf.get(C.KERNEL_MAX_PAD_FRACTION)),
        min_bucket=int(conf.get(C.MIN_BUCKET_ROWS)))
    global _POLICY
    with _LOCK:
        _POLICY = pol
    return pol


def current_policy() -> ShapePolicy:
    return _POLICY


def bucket_batch(batch, policy: Optional[ShapePolicy] = None):
    """(bucketed batch, padded row count) for one pumped DeviceBatch.

    Capacity and bytes come from tensor shapes, so bucketing never
    waits for the device.  Values that are not a DeviceBatch (host
    batches) pass through untouched."""
    pol = policy if policy is not None else _POLICY
    if not pol.enabled or not isinstance(batch, DeviceBatch):
        return batch, 0
    cap = batch.capacity
    bucket = pol.bucket_for(cap)
    if bucket <= cap:
        _TM_HITS.inc()
        return batch, 0
    _TM_MISSES.inc()
    pad = bucket - cap
    cols = tuple(_pad_col(c, bucket) for c in batch.columns)
    sel = batch.sel.new_zeros((bucket,))
    sel[:cap] = batch.sel
    # the dead tail keeps live rows at the front: the compacted promise
    # survives
    out = DeviceBatch(batch.schema, cols, sel, compacted=batch.compacted)
    _TM_PAD_ROWS.inc(pad)
    _TM_PAD_BYTES.inc(max(out.nbytes() - batch.nbytes(), 0))
    return out, pad


def retarget_bucket(rows: int) -> int:
    """Canonical bucket for a row target: the policy's bucket when
    bucketing is on, else the pow2 round-up producers already emit."""
    rows = max(int(rows), 1)
    pol = _POLICY
    if pol.enabled:
        return pol.bucket_for(rows)
    return round_up_pow2(rows)


def snapshot() -> Tuple[int, int, int, int]:
    """(hits, misses, pad_rows, pad_bytes) so far — a run's are the
    difference of two snapshots."""
    return (_TM_HITS.value, _TM_MISSES.value,
            _TM_PAD_ROWS.value, _TM_PAD_BYTES.value)
