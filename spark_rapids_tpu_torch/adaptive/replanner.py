"""Replanner: decision orchestration for the adaptive plane.

The counterpart of the JAX package's ``adaptive/replanner.py``.  Each
function takes an ``AdaptivePolicy`` plus numbers the exec layer
already holds (recorded partition counts, observed build bytes) and
returns the decision the exec node should APPLY, together with the
triggering stat — the dict that ``adaptive.record_decision`` attaches
to the plan node, so every decision is explainable from its inputs.

Pure by contract: decisions come from recorded stats, history and
conf — never a fresh device read.  The exec layer measures; this
module decides; the exec layer applies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.adaptive import AdaptivePolicy, cost_model
from spark_rapids_tpu_torch.runtime import stats

# Join types for which a stream-side row can be decided independently
# against a fully present build side — the correctness condition for
# both broadcast-streaming AND rank-interleaved skew splitting (each
# stream slice sees the WHOLE matching build partition).
STREAMABLE_JOINS = ("inner", "left", "left_semi", "left_anti")


def decide_join_from_history(pol: AdaptivePolicy, build_sig: str
                             ) -> Optional[Tuple[str, Dict]]:
    """Warm path: (strategy, trigger detail) from the profile store's
    most recent build-side measurement for this plan signature, or
    None when there is no usable history (caller then measures)."""
    if not pol.wants_join or pol.broadcast_threshold <= 0:
        return None
    hist = cost_model.history_build_bytes(pol.history_path, build_sig)
    if hist is None:
        return None
    strategy = cost_model.choose_join_strategy(hist,
                                               pol.broadcast_threshold)
    return strategy, {"build_bytes": hist,
                      "threshold": pol.broadcast_threshold,
                      "build_sig": build_sig,
                      "source": "history"}


def decide_join_from_measurement(pol: AdaptivePolicy, build_sig: str,
                                 build_bytes: int) -> Tuple[str, Dict]:
    """Cold path: (strategy, trigger detail) from build-side bytes the
    exec layer measured off the upstream pump."""
    strategy = cost_model.choose_join_strategy(build_bytes,
                                               pol.broadcast_threshold)
    return strategy, {"build_bytes": int(build_bytes),
                      "threshold": pol.broadcast_threshold,
                      "build_sig": build_sig,
                      "source": "measured"}


def plan_skew_reads(pol: AdaptivePolicy, join_type: str,
                    counts: Sequence[int]
                    ) -> Optional[Tuple[List[Tuple[int, int, int]], Dict]]:
    """Skew-healing read plan for a partitioned join's stream side.

    Returns (specs, trigger detail) where specs is one ``(p, j, k)``
    per output partition — slice j of k over exchange partition p
    (k == 1 for partitions read whole) — or None when nothing is hot
    enough to split (the join keeps its 1:1 partition mapping)."""
    if not pol.wants_skew or join_type not in STREAMABLE_JOINS:
        return None
    splits = cost_model.plan_skew_splits(
        counts, pol.skew_threshold, pol.target_rows, pol.max_splits)
    if not splits:
        return None
    specs: List[Tuple[int, int, int]] = []
    for p in range(len(counts)):
        k = splits.get(p, 1)
        specs.extend((p, j, k) for j in range(k))
    detail = {"partitions": sorted(splits),
              "splits": [splits[p] for p in sorted(splits)],
              "skew_factor": round(stats.skew_factor(counts), 4),
              "threshold": pol.skew_threshold,
              "rows": [int(counts[p]) for p in sorted(splits)]}
    return specs, detail


def retarget_read_rows(pol: AdaptivePolicy, target_bytes: int,
                       static_row_bytes: int, observed_rows: int,
                       observed_bytes: int
                       ) -> Optional[Tuple[int, Dict]]:
    """(new row target, trigger detail) for an AQE shuffle read, from
    observed bytes/row — snapped to the shape plane's bucket ladder so
    coalesce targets land on compile-cached batch shapes — or None
    when the static estimate was close enough (or nothing observed)."""
    if not pol.wants_retarget:
        return None
    rows = cost_model.retarget_rows(target_bytes, observed_rows,
                                    observed_bytes, static_row_bytes)
    if rows is None:
        return None
    from spark_rapids_tpu_torch.runtime import shapes
    target = shapes.retarget_bucket(rows)
    detail = {"target_rows": target,
              "static_row_bytes": int(static_row_bytes),
              "observed_row_bytes": round(observed_bytes
                                          / max(observed_rows, 1), 2),
              "observed_rows": int(observed_rows)}
    return target, detail
