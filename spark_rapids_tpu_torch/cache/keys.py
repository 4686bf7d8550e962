"""Result-key derivation.

The counterpart of the JAX package's ``cache/keys.py``.  The stats
plane's plan signature (``stats.plan_signature``) is deliberately
coarse — op class + tree path + schema fields — so profile-store
records of the same plan *shape* compare across runs.  A cache key has
the opposite requirement: it must distinguish anything that can change
the answer.  Three components are folded together:

* **plan fingerprint** — pre-order walk of the *physical* plan using
  ``node_string()`` (which carries expression detail: ``Filter
  [ (x > 1) ]`` vs ``Filter [ (x > 2) ]``) plus schema fields and the
  CPU/TPU placement marker, a fused region's members included;
* **conf fingerprint** — the curated list of result-affecting entries
  (kernel backend, adaptive plane, exchange mode, shape-bucket ladder,
  ANSI, partitioning) plus any per-tenant raw overrides, so two
  backends or two tenants never share a slot;
* **input fingerprints** — one per leaf relation, minted by
  ``cache/fingerprints.py``.

``sha1(plan ⊕ conf)`` is also kept separately (``plan_conf``): when a
later store sees the same plan+conf with *different* input
fingerprints it supersedes — that is the automatic
fingerprint-change invalidation path.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.cache import fingerprints
from spark_rapids_tpu_torch.runtime import stats

__all__ = ["ResultKey", "result_key", "subplan_key", "conf_fingerprint",
           "plan_fingerprint"]


def _sha(s: str, n: int = 16) -> str:
    return hashlib.sha1(s.encode()).hexdigest()[:n]


@dataclasses.dataclass(frozen=True)
class ResultKey:
    """Everything the store needs to file and later invalidate a result."""

    key: str                    # full result key (plan ⊕ conf ⊕ inputs)
    plan_conf: str              # plan ⊕ conf only — supersede axis
    sig: str                    # root plan signature — attribution axis
    inputs: Tuple[str, ...]     # input fingerprints (invalidation axis)
    sources: Tuple[str, ...]    # catalog names feeding the plan
    tenant: Optional[str]


def _result_conf_entries():
    """The curated result-affecting entry list (the coarse plan
    signature alone would alias results across these)."""
    from spark_rapids_tpu_torch import conf as C
    return (
        C.SQL_ENABLED, C.ANSI_ENABLED, C.BATCH_ROWS, C.MIN_BUCKET_ROWS,
        C.SHUFFLE_PARTITIONS, C.SHUFFLE_MODE, C.EXCHANGE_MODE,
        C.KERNEL_BACKEND, C.KERNEL_BUCKETING, C.KERNEL_BUCKET_LADDER,
        C.KERNEL_MAX_PAD_FRACTION,
        C.ADAPTIVE_ENABLED, C.ADAPTIVE_PLANE_ENABLED,
        C.ADAPTIVE_JOIN_STRATEGY, C.ADAPTIVE_SKEW_SPLIT,
        C.ADAPTIVE_SKEW_THRESHOLD, C.ADAPTIVE_MAX_SPLITS,
        C.ADAPTIVE_BATCH_RETARGET,
    )


def conf_fingerprint(conf, tenant: Optional[str] = None) -> str:
    parts: List[str] = [
        f"{e.key}={conf.get(e)!r}" for e in _result_conf_entries()]
    if tenant:
        prefix = f"spark.rapids.tpu.scheduler.tenant.{tenant}."
        parts.append(f"tenant={tenant}")
        parts.extend(f"{k}={v!r}"
                     for k, v in sorted(conf.raw_prefix(prefix).items()))
    return _sha("|".join(parts), 12)


def plan_fingerprint(node) -> str:
    """Detailed pre-order fingerprint of a physical (sub)tree.

    A fused region's ``node_string`` names only its members' classes,
    and its one child is the region's source, so each member's own
    line is folded in as well: two plans that differ only in a literal
    inside a region key apart (the JAX package's walk leaves them out).
    """
    from spark_rapids_tpu_torch.exec.fused import FusedStageExec
    parts: List[str] = []

    def line(n, path: str) -> str:
        try:
            fields = ",".join(n.schema.field_names())
        except Exception:
            fields = ""
        return f"{path}/{n.node_string()}({fields})"

    def walk(n, path: str) -> None:
        parts.append(line(n, path))
        if isinstance(n, FusedStageExec):
            parts.extend(line(m, f"{path}.m{j}")
                         for j, m in enumerate(n.members))
        for i, c in enumerate(n.children):
            walk(c, f"{path}.{i}")

    walk(node, "0")
    return _sha("|".join(parts), 16)


def result_key(logical_plan, physical_plan, conf,
               tenant: Optional[str] = None) -> ResultKey:
    """Derive the full result key for a query about to execute.

    Raises (``OSError`` from a stat, anything from an exotic plan) if
    any input cannot be fingerprinted — callers treat that as
    uncacheable and execute normally.
    """
    pfp = plan_fingerprint(physical_plan)
    cfp = conf_fingerprint(conf, tenant)
    fps, sources = fingerprints.relation_inputs(logical_plan)
    plan_conf = _sha(f"{pfp}|{cfp}", 16)
    key = _sha(f"{plan_conf}|{'|'.join(fps)}", 16)
    sig = stats.plan_signature(physical_plan.name, "0",
                               physical_plan.schema)
    return ResultKey(key=key, plan_conf=plan_conf, sig=sig,
                     inputs=tuple(fps), sources=tuple(sorted(sources)),
                     tenant=tenant)


def subplan_key(exchange_node, conf_fp: str) -> ResultKey:
    """Key for a materialized exchange output: detailed subtree
    fingerprint ⊕ the owning session's conf fingerprint ⊕ the physical
    leaves' input fingerprints.  Prefixed so result and subplan entries
    can never collide in the shared store."""
    pfp = plan_fingerprint(exchange_node)
    fps = fingerprints.physical_inputs(exchange_node)
    plan_conf = "sub:" + _sha(f"{pfp}|{conf_fp}", 16)
    key = "sub:" + _sha(f"{plan_conf}|{'|'.join(fps)}", 16)
    from spark_rapids_tpu_torch.adaptive.cost_model import subtree_signature
    sig = subtree_signature(exchange_node)
    return ResultKey(key=key, plan_conf=plan_conf, sig=sig,
                     inputs=tuple(fps), sources=(), tenant=None)
