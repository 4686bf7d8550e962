"""Cost model: the numeric half of the adaptive plane.

The counterpart of the JAX package's ``adaptive/cost_model.py``: pure
functions over numbers the caller already holds — recorded partition
counts, observed byte totals, conf thresholds.  Nothing here touches
the device; measurement lives in the exec layer, history in the stats
plane's JSONL profile store.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

from spark_rapids_tpu_torch.runtime import stats


# -- join strategy -----------------------------------------------------------

def choose_join_strategy(build_bytes: int, threshold: int) -> str:
    """"broadcast" when the observed build side fits the broadcast
    threshold (the exchange disappears), else "shuffled"."""
    if threshold > 0 and build_bytes <= threshold:
        return "broadcast"
    return "shuffled"


def subtree_signature(node) -> str:
    """Stable signature of a physical subtree — op names + schema
    fields in pre-order, same recipe as ``stats.plan_signature`` but
    covering the whole subtree so it identifies a join's build side
    across runs of the same query shape."""
    parts = []

    def walk(n, path):
        try:
            fields = ",".join(n.schema.field_names())
        except Exception:
            fields = ""
        parts.append(f"{path}/{n.name}({fields})")
        for i, c in enumerate(getattr(n, "children", ()) or ()):
            walk(c, f"{path}.{i}")

    walk(node, "0")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def history_build_bytes(path: str, build_sig: str) -> Optional[int]:
    """Most recent recorded build-side bytes for a join signature from
    the profile store — the warm-query path: a query shape seen before
    decides its strategy without re-measuring.  None when the store is
    unset, unreadable, or has no record for this signature."""
    if not path or not build_sig:
        return None
    try:
        records = stats.load_profiles(path)
    except Exception:
        return None
    for rec in reversed(records):
        for d in rec.get("adaptive_decisions", ()) or ():
            if (d.get("build_sig") == build_sig
                    and d.get("build_bytes") is not None):
                return int(d["build_bytes"])
    return None


# -- skew splitting ----------------------------------------------------------

def plan_skew_splits(counts: Sequence[int], skew_threshold: float,
                     target_rows: int, max_splits: int) -> Dict[int, int]:
    """{partition: k} for partitions hot enough to split.

    A partition is hot when it exceeds ``skew_threshold`` x the mean
    (the stats plane's skew-factor definition, applied per partition)
    AND holds more than ``target_rows`` rows — tiny-but-lopsided
    exchanges are not worth the replication cost.  k aims each slice
    at ``target_rows``, capped at ``max_splits``."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    if total <= 0 or not counts:
        return {}
    mean = total / len(counts)
    out: Dict[int, int] = {}
    for p, c in enumerate(counts):
        if c > skew_threshold * mean and c > target_rows:
            k = min(int(max_splits), -(-c // max(int(target_rows), 1)))
            if k >= 2:
                out[p] = k
    return out


# -- batch retargeting -------------------------------------------------------

# Observed bytes/row must disagree with the static estimate by at
# least this ratio before a retarget is worth a decision record — the
# schema estimate is already right for fixed-width rows.
RETARGET_MIN_RATIO = 1.25


def retarget_rows(target_bytes: int, observed_rows: int,
                  observed_bytes: int, static_row_bytes: int
                  ) -> Optional[int]:
    """Row target from OBSERVED bytes/row, or None when the static
    estimate is already within ``RETARGET_MIN_RATIO`` of reality (or
    nothing was observed)."""
    if observed_rows <= 0 or observed_bytes <= 0:
        return None
    bpr = max(observed_bytes / observed_rows, 1.0)
    est = max(int(static_row_bytes), 1)
    ratio = bpr / est if bpr > est else est / bpr
    if ratio < RETARGET_MIN_RATIO:
        return None
    return max(int(target_bytes // bpr), 1)
