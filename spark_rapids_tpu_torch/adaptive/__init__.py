"""The adaptive execution plane — stats-driven replanning.

The counterpart of the JAX package's ``adaptive/``.  The reference
accelerator leans on Spark AQE to pick join strategies and heal skew at
runtime; the stats plane (``runtime/stats.py``) is the measurement half
(rows, bytes, per-partition sizes with skew factors keyed by stable
plan signatures), and this package is the half that spends those
stats: a cost model and a replanner that rewrite the physical plan at
stage boundaries.

Three decisions, each conf-gated under ``spark.rapids.tpu.adaptive.*``:

* **join strategy** (``joinStrategy.enabled``) — broadcast vs
  shuffled-hash per join from observed build-side cardinality:
  profile-store history for warm queries, upstream pump counts for
  cold ones.  A build side that fits the broadcast threshold
  eliminates the exchange entirely (exec/join.py
  ``TpuAdaptiveLocalJoinExec``).
* **skew splitting** (``skewSplit.enabled``) — when an exchange's
  recorded skew factor exceeds the threshold, split the hot stream
  partition(s) into rank-interleaved sub-partitions and replicate the
  build side's matching partition (exec/join.py partitioned
  ``TpuSortMergeJoinExec``).  This spreads a SINGLE hot key — the one
  case hash sub-partitioning provably cannot.
* **batch retargeting** (``batchRetarget.enabled``) — the AQE shuffle
  read replans its coalesce/split target from observed bytes/row
  instead of the static schema estimate, snapped to the shape plane's
  bucket ladder (exec/aqe.py).

Purity contract: code in this package decides from RECORDED stats,
history and conf only — never a fresh device read.  Anything that
must touch the device to measure (gathering a build side, counting
partition rows) lives in the exec layer, which hands the numbers in.

Every decision taken is recorded on the deciding exec node in the
stats plane (so it flows into EXPLAIN ANALYZE ``adaptive=...``
annotations, the event log and profile-store records) and counted in
``tpuq_adaptive_decisions_total{kind}``.
"""

from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch.runtime import stats
from spark_rapids_tpu_torch.runtime import telemetry as TM

_TM_DECISIONS = TM.REGISTRY.labeled_counter(
    "tpuq_adaptive_decisions_total",
    "adaptive-plane replanning decisions applied, by kind "
    "(broadcast / shuffled / skew-split / batch-retarget)",
    label="kind")


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """One immutable adaptive policy (the conf snapshot, parsed).

    Built per query at plan-conversion time (``policy_from_conf``) so
    per-query conf overrides land in the plan that query runs, same as
    every other planner input."""

    enabled: bool = False
    join_strategy: bool = True
    skew_split: bool = True
    batch_retarget: bool = True
    skew_threshold: float = 2.0        # hottest/mean, resolved (never 0)
    max_splits: int = 8                # fan-out cap per hot partition
    target_rows: int = 1 << 18         # sub-partition row goal
    broadcast_threshold: int = 10 << 20
    history_path: str = ""             # "" = no warm-query history

    @property
    def wants_join(self) -> bool:
        return self.enabled and self.join_strategy

    @property
    def wants_skew(self) -> bool:
        return self.enabled and self.skew_split

    @property
    def wants_retarget(self) -> bool:
        return self.enabled and self.batch_retarget


def policy_from_conf(conf) -> AdaptivePolicy:
    """Parse a RapidsConf into an AdaptivePolicy snapshot."""
    from spark_rapids_tpu_torch import conf as C
    skew = float(conf.get(C.ADAPTIVE_SKEW_THRESHOLD))
    if skew <= 0:  # 0 = inherit the stats plane's skew flagging bar
        skew = float(conf.get(C.STATS_SKEW_THRESHOLD))
    thresh = conf.get(C.BROADCAST_THRESHOLD)
    return AdaptivePolicy(
        enabled=bool(conf.get(C.ADAPTIVE_PLANE_ENABLED)),
        join_strategy=bool(conf.get(C.ADAPTIVE_JOIN_STRATEGY)),
        skew_split=bool(conf.get(C.ADAPTIVE_SKEW_SPLIT)),
        batch_retarget=bool(conf.get(C.ADAPTIVE_BATCH_RETARGET)),
        skew_threshold=skew,
        max_splits=int(conf.get(C.ADAPTIVE_MAX_SPLITS)),
        target_rows=int(conf.get(C.JOIN_TARGET_ROWS)),
        broadcast_threshold=int(thresh) if thresh else 0,
        history_path=(str(conf.get(C.ADAPTIVE_HISTORY_PATH))
                      or str(conf.get(C.STATS_STORE_PATH))))


def record_decision(node, kind: str, **detail) -> None:
    """Count one applied decision and attach it to the deciding exec
    node's stats record (rendered by EXPLAIN ANALYZE and rolled up
    into the query profile's ``adaptive_decisions``).

    Exec nodes constructed at runtime (the replanner's rewritten
    subtree) are invisible to the plan walk, so they forward to a
    ``_decision_owner`` — the adaptive node that IS in the plan."""
    _TM_DECISIONS.labels(kind).inc()
    owner = getattr(node, "_decision_owner", node)
    st = stats.current()
    if st is not None:
        st.record_decision(owner, kind, detail)
