"""Physical planning: logical plan -> device exec tree.

The JAX package plans a CPU exec tree and lets ``plan/overrides.py``
rewrite supported subtrees onto the device (with per-operator CPU
fallback).  That overrides plane is a later slice of the port: here the
slice's nodes plan straight onto device execs, shaped as the JAX
package's rewrite shapes them (a single-batch coalesce below the
global sort, a topN for a limit over a sort, the join strategy of
``exec/join.py::_convert_join``), and anything else raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.join import (
    TpuBroadcastExchangeExec, TpuSortMergeJoinExec, _join_key_family)
from spark_rapids_tpu_torch.exec.misc import TpuTopNExec
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.analysis import _not_ported


def plan_physical(node: L.LogicalPlan, conf: RapidsConf,
                  device: torch.device) -> TpuExec:
    if isinstance(node, L.InMemoryRelation):
        return B.TpuScanExec(node.table, node.schema, device,
                             conf.batch_rows, conf.min_bucket_rows)
    if isinstance(node, L.Project):
        return B.TpuProjectExec(node.exprs, node.schema,
                                plan_physical(node.child, conf, device))
    if isinstance(node, L.Filter):
        return B.TpuFilterExec(node.condition,
                               plan_physical(node.child, conf, device))
    if isinstance(node, L.Aggregate):
        return TpuHashAggregateExec(
            node.grouping, node.aggregates, node.schema,
            plan_physical(node.child, conf, device),
            backend=conf.kernel_backend)
    if isinstance(node, L.Sort):
        return TpuSortExec(node.orders, B.TpuCoalesceBatchesExec(
            plan_physical(node.child, conf, device)))
    if isinstance(node, L.Limit):
        # TakeOrderedAndProject: Limit(Sort) / Limit(Project(Sort)) plan a
        # topN instead of a full global sort [REF: GpuTopN]
        inner, proj = node.child, None
        if isinstance(inner, L.Project):
            proj, inner = inner, inner.child
        if not isinstance(inner, L.Sort):
            raise _not_ported("limit without an order-by "
                              "(GlobalLimit/LocalLimit)")
        topn = TpuTopNExec(inner.orders, node.n,
                           plan_physical(inner.child, conf, device))
        if proj is not None:
            return B.TpuProjectExec(proj.exprs, proj.schema, topn)
        return topn
    if isinstance(node, L.Join):
        return _convert_join(node, plan_physical(node.left, conf, device),
                             plan_physical(node.right, conf, device), conf)
    raise _not_ported(f"device plan for {node.name}")


def _convert_join(node: L.Join, left: TpuExec, right: TpuExec,
                  conf: RapidsConf) -> TpuExec:
    """The JAX package's single-process ``_convert_join``: broadcast the
    small side when its estimate fits ``autoBroadcastJoinThreshold``,
    else a sort-merge join that picks its strategy from live row counts
    at run time."""
    jt = node.join_type
    # the JAX package's exec/join.py::_tag_join: these joins fall back to
    # the CPU there, and the CPU-fallback plane is not ported yet
    if node.condition is not None and jt not in ("inner", "cross"):
        raise _not_ported(
            f"CPU fallback of a join (residual join conditions on {jt} "
            "joins not yet on device (inner/cross only))")
    for le, re in zip(node.left_keys, node.right_keys):
        if _join_key_family(le.dtype) != _join_key_family(re.dtype):
            raise _not_ported(
                f"CPU fallback of a join with mismatched key types "
                f"({le.dtype.simple_name} vs {re.dtype.simple_name})")
        if type(le.dtype) is not type(re.dtype) and jt in ("right", "full"):
            raise _not_ported(
                "CPU fallback of a join (mixed-width int join keys not "
                f"supported for {jt} joins (output key column would mix "
                f"{le.dtype.simple_name} and {re.dtype.simple_name}))")
    common = dict(using=node.using,
                  sub_partition_rows=conf.get(C.JOIN_TARGET_ROWS),
                  out_batch_rows=conf.batch_rows,
                  backend=conf.kernel_backend)
    thresh = conf.get(C.BROADCAST_THRESHOLD)
    if thresh and thresh > 0:
        rsize = right.estimated_size_bytes()
        lsize = left.estimated_size_bytes()
        if (rsize is not None and rsize <= thresh
                and jt in ("inner", "left", "left_semi", "left_anti",
                           "cross")):
            return TpuSortMergeJoinExec(
                jt, node.left_keys, node.right_keys, node.condition,
                node.schema, left, TpuBroadcastExchangeExec(right),
                broadcast="right", **common)
        if lsize is not None and lsize <= thresh and jt == "inner":
            return TpuSortMergeJoinExec(
                jt, node.left_keys, node.right_keys, node.condition,
                node.schema, TpuBroadcastExchangeExec(left), right,
                broadcast="left", **common)
    if (conf.get(C.ADAPTIVE_PLANE_ENABLED) and node.left_keys
            and jt in ("inner", "left", "left_semi", "left_anti")):
        raise _not_ported("adaptive join (TpuAdaptiveLocalJoinExec, "
                          "spark.rapids.tpu.adaptive.enabled)")
    return TpuSortMergeJoinExec(
        jt, node.left_keys, node.right_keys, node.condition, node.schema,
        left, right, **common)
