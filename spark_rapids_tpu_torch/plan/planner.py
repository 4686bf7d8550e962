"""Physical planning: logical plan -> CPU physical plan.

The counterpart of the JAX package's ``plan/planner.py`` (the
vanilla-Spark-planner analog): it produces a ``CpuExec`` tree, and the
overrides engine (``plan/overrides.py``) then rewrites supported
subtrees onto the device [REF: sql-plugin/../GpuOverrides.scala ::
ColumnarOverrideRules].  A limit over a sort (``Limit(Sort)``,
``Limit(Project(Sort))``) plans a TakeOrderedAndProject; any other limit
plans ``GlobalLimit(LocalLimit(...))``.  A repartition plans a
``CpuShuffleExchangeExec``, which the rewrite converts by
``spark.rapids.shuffle.mode``.  A range plans ``CpuRangeExec`` with
``spark.rapids.tpu.batchRows`` ids a batch.  A file relation plans
``io/parquet.py::CpuParquetScanExec``; the python-UDF nodes plan the
``exec/python_udf.py`` execs.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import CpuAggregateExec
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.exec.exchange import CpuShuffleExchangeExec
from spark_rapids_tpu_torch.exec.join import CpuJoinExec
from spark_rapids_tpu_torch.exec import python_udf as PU
from spark_rapids_tpu_torch.exec.misc import (
    CpuExpandExec, CpuGenerateExec, CpuRangeExec, CpuSampleExec,
    CpuTopNExec)
from spark_rapids_tpu_torch.exec.sort import CpuSortExec
from spark_rapids_tpu_torch.plan import logical as L


def plan_physical(node: L.LogicalPlan, conf: RapidsConf) -> CpuExec:
    if isinstance(node, L.InMemoryRelation):
        return B.CpuScanExec(node.table, node.schema, node.num_partitions,
                             conf.batch_rows)
    if isinstance(node, L.ParquetRelation):
        from spark_rapids_tpu_torch.io.parquet import CpuParquetScanExec
        return CpuParquetScanExec(node, conf)
    if isinstance(node, L.Project):
        return B.CpuProjectExec(node.exprs, node.schema,
                                plan_physical(node.child, conf))
    if isinstance(node, L.Filter):
        return B.CpuFilterExec(node.condition,
                               plan_physical(node.child, conf))
    if isinstance(node, L.Limit):
        # TakeOrderedAndProject pattern: Limit(Sort) / Limit(Project(Sort))
        # plans a topN instead of a full global sort [REF: GpuTopN]
        inner = node.child
        proj = None
        if isinstance(inner, L.Project):
            proj, inner = inner, inner.child
        if isinstance(inner, L.Sort):
            topn = CpuTopNExec(inner.orders, node.n,
                               plan_physical(inner.child, conf))
            if proj is not None:
                return B.CpuProjectExec(proj.exprs, proj.schema, topn)
            return topn
        return B.CpuGlobalLimitExec(
            node.n, B.CpuLocalLimitExec(node.n,
                                        plan_physical(node.child, conf)))
    if isinstance(node, L.Range):
        return CpuRangeExec(node.start, node.end, node.step, node.schema,
                            node.num_partitions, conf.batch_rows)
    if isinstance(node, L.Sample):
        return CpuSampleExec(node.fraction, node.seed,
                             plan_physical(node.child, conf))
    if isinstance(node, L.Expand):
        return CpuExpandExec(node.projections, node.schema,
                             plan_physical(node.child, conf))
    if isinstance(node, L.Generate):
        return CpuGenerateExec(node.generator, node.with_pos, node.outer,
                               node.schema,
                               plan_physical(node.child, conf))
    if isinstance(node, L.Window):
        from spark_rapids_tpu_torch.exec.window import CpuWindowExec
        return CpuWindowExec(node.partition_by, node.order_by,
                             node.functions, node.schema,
                             plan_physical(node.child, conf))
    if isinstance(node, L.PythonEval):
        return PU.CpuArrowEvalPythonExec(node.udfs, node.schema,
                                         plan_physical(node.child, conf))
    if isinstance(node, L.MapInPandas):
        return PU.CpuMapInPandasExec(node.fn, node.schema,
                                     plan_physical(node.child, conf))
    if isinstance(node, L.FlatMapGroupsInPandas):
        return PU.CpuFlatMapGroupsInPandasExec(
            node.key_indices, node.fn, node.schema,
            plan_physical(node.child, conf))
    if isinstance(node, L.Union):
        return B.CpuUnionExec([plan_physical(c, conf) for c in node.inputs])
    if isinstance(node, L.Aggregate):
        return CpuAggregateExec(node.grouping, node.aggregates, node.schema,
                                plan_physical(node.child, conf))
    if isinstance(node, L.Sort):
        return CpuSortExec(node.orders, plan_physical(node.child, conf))
    if isinstance(node, L.Join):
        return CpuJoinExec(node.join_type, node.left_keys, node.right_keys,
                           node.condition, node.schema,
                           plan_physical(node.left, conf),
                           plan_physical(node.right, conf),
                           using=node.using)
    if isinstance(node, L.Repartition):
        return CpuShuffleExchangeExec(
            plan_physical(node.child, conf), node.num_partitions, node.keys)
    raise NotImplementedError(f"no physical plan for {node.name}")
