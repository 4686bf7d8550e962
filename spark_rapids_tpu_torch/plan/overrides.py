"""The plan-rewrite engine: CPU physical plan -> device plan with fallback.

[REF: sql-plugin/../GpuOverrides.scala :: GpuOverrides (expressions/execs
 rule maps, wrapPlan), RapidsMeta.scala :: SparkPlanMeta.tagForGpu /
 willNotWorkOnGpu / convertToGpu, GpuTransitionOverrides.scala]

The counterpart of the JAX package's ``plan/overrides.py``, with the same
mechanics and the same reason texts:

* every exec class the port has carries a rule in ``EXEC_RULES``;
* each plan node is wrapped in an ``ExecMeta`` that collects readable
  "cannot run on TPU because ..." reasons (type checks, the per-op
  kill switches ``spark.rapids.sql.{exec,expression}.<Name>``, missing
  rules);
* subtrees tagged ok convert to device execs, and transitions
  (``HostToDeviceExec`` / ``DeviceToHostExec``) go in at every boundary;
* the coalesce pass adds a TargetSize coalesce above every host-to-device
  transition and a RequireSingleBatch coalesce under the global sort and
  the window;
* ``spark.rapids.sql.explain=NOT_ON_TPU|ALL`` prints the rewrite, and
  ``spark.rapids.sql.test.enabled`` turns an unexpected fallback into an
  ``AssertionError``.

The port's rules convert onto the session's device, so ``convert``
takes it beside the conf.  As in the JAX package, ``apply_overrides``
arms the fault injector and refreshes the retry policy from the conf
(``runtime/resilience.py::configure_from_conf``), and runs the
whole-stage fusion pass last (``fusion/regions.py::fuse_plan``).
Under ``spark.rapids.shuffle.mode=ICI`` on a mesh of more than one rank
(``exec/distributed.py::ici_active``) the conversions plan the JAX
package's distributed trees: a grouped aggregate splits into
partial/final around a ``TpuIciShuffleExchangeExec`` on its keys, a
repartition into the mesh's partition count becomes that exchange, a
join co-partitions both sides through two of them (or defers to
``TpuAdaptiveJoinExec``), a sort runs ``partitioned`` behind a
``TpuIciRangeExchangeExec``, and a window ``partitioned`` behind a hash
exchange on its partition keys.  In a multi-executor run
(``spark.rapids.executor.count > 1``) in-memory scans serve this
executor's slice of partitions, and ``_validate_multiproc`` refuses the
operators that would compute on one slice only.  The LORE dump taps
``install_lore_taps`` are A.12.  A repartition otherwise converts by
``spark.rapids.shuffle.mode`` (``exec/exchange.py::_convert_exchange``);
the coalesce pass asks a sort's child for its partition count, which on
an AQE read runs the exchange's map stage at planning, as in the JAX
package.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Type

import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import (
    CpuAggregateExec, TpuHashAggregateExec, is_holistic_fn)
from spark_rapids_tpu_torch.exec.base import CpuExec, ExecNode, TpuExec
from spark_rapids_tpu_torch.exec.exchange import (
    CpuShuffleExchangeExec, _convert_exchange, _tag_exchange)
from spark_rapids_tpu_torch.exec.join import (
    CpuJoinExec, TpuBroadcastExchangeExec, _convert_join, _tag_join)
from spark_rapids_tpu_torch.exec import misc as M
from spark_rapids_tpu_torch.exec import python_udf as PU
from spark_rapids_tpu_torch.exec import window as W
from spark_rapids_tpu_torch.exec.sort import (
    CpuSortExec, TpuSortExec, _convert_sort, _tag_sort)
from spark_rapids_tpu_torch.exec.transitions import (
    DeviceToHostExec, HostToDeviceExec)
from spark_rapids_tpu_torch.io import parquet as PQ
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops.expressions import (
    BoundReference, Expression, sig_tag)


# ---------------------------------------------------------------------------
# Type support lattice — the TypeSig analog
# [REF: sql-plugin/../TypeChecks.scala :: TypeSig]
# ---------------------------------------------------------------------------

def is_device_supported_type(dt: T.DataType) -> Optional[str]:
    """None if supported on device; else the reason string."""
    if isinstance(dt, T.DecimalType):
        if dt.precision > 38:
            return f"decimal precision {dt.precision} > 38"
        return None
    if isinstance(dt, (T.ArrayType, T.MapType, T.StructType)):
        return f"nested type {dt.simple_name} not yet supported on device"
    if isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
                       T.LongType, T.FloatType, T.DoubleType, T.StringType,
                       T.BinaryType, T.DateType, T.TimestampType, T.NullType)):
        return None
    return f"type {dt.simple_name} not supported on device"


def is_device_supported_output_type(dt: T.DataType) -> Optional[str]:
    """Exec OUTPUT columns additionally allow array<primitive> (the JAX
    package's collect_list result) while expressions over arrays stay
    unsupported."""
    if isinstance(dt, T.ArrayType):
        et = dt.element_type
        if isinstance(et, (T.ArrayType, T.MapType, T.StructType,
                           T.StringType, T.BinaryType, T.DecimalType)):
            return (f"array element type {et.simple_name} not supported "
                    "on device")
        return None
    return is_device_supported_type(dt)


# ---------------------------------------------------------------------------
# Meta: per-node tagging state
# ---------------------------------------------------------------------------

class ExecMeta:
    def __init__(self, cpu: CpuExec, conf: RapidsConf,
                 children: List["ExecMeta"]):
        self.cpu = cpu
        self.conf = conf
        self.children = children
        self.reasons: List[str] = []
        self.rule: Optional["ExecRule"] = None

    def will_not_work(self, reason: str):
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    def tag_expressions(self, exprs):
        for e in exprs:
            tag_expression(e, self)

    def tag(self):
        rule = EXEC_RULES.get(type(self.cpu))
        if rule is None:
            self.will_not_work(
                f"no TPU rule for exec {type(self.cpu).__name__}")
            return
        self.rule = rule
        if not self.conf.is_op_enabled("exec", rule.name):
            self.will_not_work(
                f"exec {rule.name} disabled by "
                f"spark.rapids.sql.exec.{rule.name}=false")
        for f in self.cpu.schema.fields:
            r = is_device_supported_output_type(f.dtype)
            if r:
                self.will_not_work(f"output column '{f.name}': {r}")
        # a CPU-falling child feeds this node through an H2D transition —
        # every column of the child's schema must survive the transfer
        # [REF: GpuTransitionOverrides.scala — transition type validation]
        for c in self.children:
            if not c.can_run_on_tpu:
                for f in c.cpu.schema.fields:
                    r = is_device_supported_output_type(f.dtype)
                    if r:
                        self.will_not_work(
                            f"input column '{f.name}' cannot cross the "
                            f"host→device transition: {r}")
        rule.tag(self)


def tag_expression(e: Expression, meta: ExecMeta):
    name = type(e).__name__
    if not meta.conf.is_op_enabled("expression", name):
        meta.will_not_work(
            f"expression {name} disabled by "
            f"spark.rapids.sql.expression.{name}=false")
    incompat = getattr(type(e), "incompat", None)
    if incompat and not meta.conf.get(C.INCOMPATIBLE_OPS):
        meta.will_not_work(
            f"expression {name} is not fully compatible with Spark "
            f"({incompat}); set "
            "spark.rapids.sql.incompatibleOps.enabled=true to enable")
    if meta.conf.ansi_enabled and getattr(type(e), "ansi_sensitive", False):
        meta.will_not_work(
            f"expression {name} under spark.sql.ansi.enabled=true: device "
            "lowering implements non-ANSI semantics (overflow wraps, "
            "invalid input nulls) — CPU fallback until ANSI kernels exist")
    hook = getattr(e, "device_support_reason", None)
    if hook is not None:
        r = hook(meta.conf)
        if r:
            meta.will_not_work(f"expression {name}: {r}")
    if isinstance(e, BoundReference):
        # direct column pass-through supports everything a batch can
        # carry; computed expressions stay restricted to scalar types
        r = is_device_supported_output_type(e.dtype)
    else:
        r = is_device_supported_type(e.dtype)
    if r:
        meta.will_not_work(f"expression {e}: {r}")
    # per-op TypeSig [REF: TypeChecks.scala]: the class declares which
    # type tags its device lowering produces/accepts
    cls = type(e)
    tag = sig_tag(e.dtype)
    if tag not in cls.type_sig:
        meta.will_not_work(
            f"expression {name} does not produce {tag} on device "
            f"(type sig: {', '.join(sorted(cls.type_sig))})")
    in_sig = cls.input_sig if cls.input_sig is not None else cls.type_sig
    for c in e.children:
        ctag = sig_tag(c.dtype)
        if ctag not in in_sig:
            meta.will_not_work(
                f"expression {name} does not accept a {ctag} input on "
                f"device (input sig: {', '.join(sorted(in_sig))})")
    # the port's device lowering is ``eval``
    if type(e).eval is Expression.eval:
        meta.will_not_work(f"expression {name} has no TPU implementation")
    for c in e.children:
        tag_expression(c, meta)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

class ExecRule:
    """One entry of the GpuOverrides execs map.

    ``convert(cpu, tpu_children, conf, device)`` builds the device exec
    on the session's device."""

    def __init__(self, name: str,
                 tag: Callable[[ExecMeta], None],
                 convert: Callable[[CpuExec, List[TpuExec], RapidsConf,
                                    torch.device], TpuExec]):
        self.name = name
        self._tag = tag
        self.convert = convert

    def tag(self, meta: ExecMeta):
        self._tag(meta)


EXEC_RULES: Dict[Type[CpuExec], ExecRule] = {}


def _convert_scan(cpu: B.CpuScanExec, children, conf, device):
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    ctx = get_executor()
    executor = ((ctx.process_id, ctx.num_processes) if ctx is not None
                else (0, 1))
    return B.TpuScanExec(cpu.table, cpu.schema, device,
                         cpu.num_partitions(), cpu.batch_rows,
                         conf.min_bucket_rows, executor=executor)


EXEC_RULES[B.CpuScanExec] = ExecRule(
    "InMemoryScan", lambda m: None, _convert_scan)

EXEC_RULES[B.CpuProjectExec] = ExecRule(
    "Project",
    lambda m: m.tag_expressions(m.cpu.exprs),
    lambda cpu, ch, conf, device: B.TpuProjectExec(cpu.exprs, cpu.schema,
                                                   ch[0]))

EXEC_RULES[B.CpuFilterExec] = ExecRule(
    "Filter",
    lambda m: m.tag_expressions([m.cpu.condition]),
    lambda cpu, ch, conf, device: B.TpuFilterExec(cpu.condition, ch[0]))

EXEC_RULES[B.CpuLocalLimitExec] = ExecRule(
    "LocalLimit",
    lambda m: None,
    lambda cpu, ch, conf, device: B.TpuLocalLimitExec(cpu.n, ch[0]))

EXEC_RULES[B.CpuGlobalLimitExec] = ExecRule(
    "GlobalLimit",
    lambda m: None,
    lambda cpu, ch, conf, device: B.TpuGlobalLimitExec(cpu.n, ch[0]))

EXEC_RULES[B.CpuUnionExec] = ExecRule(
    "Union",
    lambda m: None,
    lambda cpu, ch, conf, device: B.TpuUnionExec(ch))


def _tag_aggregate(meta: ExecMeta):
    cpu: CpuAggregateExec = meta.cpu
    meta.tag_expressions(cpu.grouping)
    for fn in cpu.fns:
        if isinstance(fn, A.Sum) and meta.conf.ansi_enabled:
            meta.will_not_work(
                "sum under spark.sql.ansi.enabled=true: device sum wraps "
                "on overflow (non-ANSI) — CPU fallback")
        if not isinstance(fn, (A.Sum, A.Min, A.Max, A.Count, A.CountStar,
                               A.Average, A.First, A._VarianceBase,
                               A.CollectList, A.Percentile)):
            meta.will_not_work(
                f"aggregate function {fn.name} has no TPU implementation")
            continue
        if not isinstance(fn, A.CountStar):
            meta.tag_expressions([fn.child])
        if isinstance(fn, A._VarianceBase) and not T.is_numeric(
                fn.input_dtype):
            meta.will_not_work(f"{fn.name} needs a numeric input")
        if isinstance(fn, A.CollectList):
            if isinstance(fn.input_dtype,
                          (T.StringType, T.BinaryType, T.DecimalType,
                           T.ArrayType)):
                meta.will_not_work(
                    f"collect_list over {fn.input_dtype.simple_name} not "
                    "on device yet (element matrix is numeric-only)")


def _convert_aggregate(cpu, ch, conf, device):
    from spark_rapids_tpu_torch.exec.distributed import ici_active
    tuning = dict(backend=conf.kernel_backend, device=device,
                  bucket_rows=conf.get(C.AGG_BUCKET_ROWS),
                  skip_ratio=conf.get(C.AGG_SKIP_RATIO))
    # holistic functions (the collects, the percentiles; min/max/first
    # over strings) route themselves to the exec's gathered single pass:
    # they cannot ride buffer batches through a partial/final split
    has_collect = any(is_holistic_fn(f) for f in cpu.fns)
    if ici_active(conf, device) and cpu.grouping and not has_collect:
        # distributed: {partial agg -> hash exchange on keys -> final
        # agg}, one collective exchange per shuffle stage
        from spark_rapids_tpu_torch.exec.distributed import (
            TpuIciShuffleExchangeExec, exchange_opts)
        from spark_rapids_tpu_torch.ops.expressions import BoundReference
        partial = TpuHashAggregateExec(cpu.grouping, cpu.fns, None, ch[0],
                                       mode="partial", **tuning)
        partial.schema = partial._buffer_schema()
        keys = [BoundReference(i, g.dtype)
                for i, g in enumerate(cpu.grouping)]
        exchange = TpuIciShuffleExchangeExec(partial, keys, device=device,
                                             **exchange_opts(conf))
        return TpuHashAggregateExec(cpu.grouping, cpu.fns, cpu.schema,
                                    exchange, mode="final", **tuning)
    return TpuHashAggregateExec(cpu.grouping, cpu.fns, cpu.schema, ch[0],
                                **tuning)


# the JAX package registers the next fourteen lazily
# (``_register_lazy_rules``); the port's exec modules import this module
# only inside functions, so their rules register here, at import
EXEC_RULES[CpuAggregateExec] = ExecRule(
    "HashAggregate", _tag_aggregate, _convert_aggregate)
EXEC_RULES[CpuSortExec] = ExecRule(
    "Sort", _tag_sort, _convert_sort)
EXEC_RULES[CpuJoinExec] = ExecRule(
    "SortMergeJoin", _tag_join, _convert_join)
EXEC_RULES[M.CpuTopNExec] = ExecRule(
    "TakeOrderedAndProject", M._tag_topn, M._convert_topn)
EXEC_RULES[CpuShuffleExchangeExec] = ExecRule(
    "ShuffleExchange", _tag_exchange, _convert_exchange)
EXEC_RULES[M.CpuRangeExec] = ExecRule(
    "Range", lambda m: None, M._convert_range)
EXEC_RULES[M.CpuSampleExec] = ExecRule(
    "Sample", lambda m: None, M._convert_sample)
EXEC_RULES[M.CpuExpandExec] = ExecRule(
    "Expand", M._tag_expand, M._convert_expand)
EXEC_RULES[M.CpuGenerateExec] = ExecRule(
    "Generate", M._tag_generate, M._convert_generate)
EXEC_RULES[W.CpuWindowExec] = ExecRule(
    "Window", W._tag_window, W._convert_window)
EXEC_RULES[PQ.CpuParquetScanExec] = ExecRule(
    "ParquetScan", lambda m: None, PQ._convert_parquet)
EXEC_RULES[PU.CpuArrowEvalPythonExec] = ExecRule(
    "ArrowEvalPython", PU._tag_python_eval, PU._convert_python_eval)
EXEC_RULES[PU.CpuMapInPandasExec] = ExecRule(
    "MapInPandas", lambda m: None, PU._convert_map_in_pandas)
EXEC_RULES[PU.CpuFlatMapGroupsInPandasExec] = ExecRule(
    "FlatMapGroupsInPandas", lambda m: None, PU._convert_flat_map_groups)


def op_names(kind: str) -> frozenset:
    """The names a kill switch ``spark.rapids.sql.<kind>.<Name>`` may
    carry: a rule's name (``exec``) or an expression class that
    ``tag_expression`` meets (``expression``)."""
    if kind == "exec":
        return frozenset(r.name for r in EXEC_RULES.values())
    # the modules that define the string, date, hash and JSON
    # expressions
    from spark_rapids_tpu_torch.ops import (  # noqa: F401
        datetime_ops, hashing, json_ops, strings)
    names, stack = set(), [Expression]
    while stack:
        for cls in stack.pop().__subclasses__():
            stack.append(cls)
            if not cls.__name__.startswith("_"):
                names.add(cls.__name__)
    return frozenset(names)


# ---------------------------------------------------------------------------
# The rewrite pass
# ---------------------------------------------------------------------------

class OverrideResult:
    def __init__(self, plan: ExecNode, metas: List[ExecMeta]):
        self.plan = plan
        self.metas = metas

    def fallback_report(self) -> List[str]:
        out = []
        for m in self.metas:
            if not m.can_run_on_tpu:
                for r in m.reasons:
                    out.append(
                        f"!Exec <{type(m.cpu).__name__}> cannot run on TPU "
                        f"because {r}")
        return out

    def fallback_summary(self) -> dict:
        """The fallback budget as a metric [REF: ExplainPlanImpl]: how
        many plan operators run on device vs fell back, with reasons."""
        device = sum(1 for m in self.metas if m.can_run_on_tpu)
        fallen = [m for m in self.metas if not m.can_run_on_tpu]
        return {
            "device_ops": device,
            "fallback_ops": len(fallen),
            "device_fraction": round(
                device / max(len(self.metas), 1), 3),
            "fallback_reasons": sorted(
                {f"{type(m.cpu).__name__}: {r}"
                 for m in fallen for r in m.reasons}),
        }


def wrap(cpu: CpuExec, conf: RapidsConf,
         all_metas: List[ExecMeta]) -> ExecMeta:
    children = [wrap(c, conf, all_metas) for c in cpu.children
                if isinstance(c, CpuExec)]
    meta = ExecMeta(cpu, conf, children)
    meta.tag()
    all_metas.append(meta)
    return meta


def _rebuild_cpu(cpu: CpuExec, new_children: List[ExecNode]) -> CpuExec:
    """Copy a CPU exec onto (possibly transition-wrapped) children.

    A shallow copy, not in-place mutation: the original plan nodes stay
    pristine, so re-planning a DataFrame never sees a half-rewritten
    tree."""
    clone = copy.copy(cpu)
    clone._children = tuple(new_children)
    clone.metrics = {k: type(m)(m.name) for k, m in cpu.metrics.items()}
    return clone


def convert_meta(meta: ExecMeta, device: torch.device) -> ExecNode:
    """Bottom-up conversion with transition insertion."""
    converted = [convert_meta(c, device) for c in meta.children]
    if meta.can_run_on_tpu:
        tpu_children = [
            c if isinstance(c, TpuExec) else HostToDeviceExec(c, device)
            for c in converted
        ]
        return meta.rule.convert(meta.cpu, tpu_children, meta.conf, device)
    cpu_children = [
        c if isinstance(c, CpuExec) else DeviceToHostExec(c)
        for c in converted
    ]
    return _rebuild_cpu(meta.cpu, cpu_children)


def _estimated_row_bytes(schema: T.StructType,
                         str_width: Optional[int] = None) -> int:
    """Rough bytes/row for batch-size targeting.  ``str_width``: known
    string-matrix width; default is a 40-byte planning-time guess."""
    total = 0
    for f in schema.fields:
        if isinstance(f.dtype, (T.StringType, T.BinaryType)):
            total += (max(str_width, 8) + 4) if str_width is not None \
                else 40
        else:
            total += 8
        total += 1  # validity
    return max(total, 1)


def insert_coalesce(node: ExecNode, conf: RapidsConf) -> ExecNode:
    """The GpuTransitionOverrides coalesce pass [REF:
    GpuTransitionOverrides.scala + GpuCoalesceBatches.scala]:

    * a TargetSize coalesce above every H2D transition (CPU-fallback
      sources emit small batches; merge them up to
      ``spark.rapids.sql.batchSizeBytes``, row-capped at
      ``spark.rapids.tpu.batchRows``, before device operators), and
    * a RequireSingleBatch coalesce under the global sort and the
      window (a single-partition child), the batching contract as a
      plan node.
      Joins deliberately get none: a pre-concatenated side would bypass
      the join's row-capped streaming and sub-partitioning.
    """
    node._children = tuple(insert_coalesce(c, conf)
                           for c in node.children)
    if isinstance(node, HostToDeviceExec):
        target = max(conf.get(C.BATCH_SIZE_BYTES)
                     // _estimated_row_bytes(node.schema),
                     conf.min_bucket_rows)
        target = min(target, conf.batch_rows)
        return B.TpuCoalesceBatchesExec(node, target_rows=target)
    if isinstance(node, (TpuSortExec, W.TpuWindowExec)):
        from spark_rapids_tpu_torch.exec.distributed import (
            TpuIciShuffleExchangeExec)
        node._children = tuple(
            B.TpuCoalesceBatchesExec(c, require_single=True)
            if isinstance(c, TpuExec) and c.num_partitions() == 1
            and not isinstance(
                c, (B.TpuCoalesceBatchesExec, TpuIciShuffleExchangeExec,
                    TpuBroadcastExchangeExec))
            else c
            for c in node._children)
    return node


# multi-executor mode supports the partition-preserving pipeline around
# ICI exchanges; global-gather operators would silently compute on one
# process's slice only, so they fail loudly instead.  The name list
# covers operators wrong-by-semantics even when partition-preserving
# (broadcast captures one slice; the non-collective shuffle exchanges
# are in-process only); the structural checks below catch every gather
# point and partition-structure change, including CPU-fallback nodes.
# Sort/Window/TopN/GlobalLimit distribute: Sort rides a RANGE exchange +
# per-partition local sorts, Window a hash exchange on partition_by,
# TopN/GlobalLimit reduce locally then rendezvous-allgather their (tiny)
# winner rows / counts.  The names are the JAX package's list, plus the
# host exchange (``exchange.mode=host`` under a multi-executor run would
# shuffle one slice only).
_MULTIPROC_UNSUPPORTED = {
    "TpuBroadcastExchangeExec", "TpuExpandExec",
    "TpuGenerateExec", "TpuPythonUDFExec", "TpuSampleExec",
    "CpuSortExec", "CpuGlobalLimitExec", "CpuTakeOrderedAndProjectExec",
    "CpuWindowExec", "CpuSampleExec", "CpuPythonUDFExec",
    "TpuShuffleExchangeExec", "TpuHostShuffleExchangeExec",
    "CpuShuffleExchangeExec",
}


def _validate_multiproc(plan) -> None:
    from spark_rapids_tpu_torch.exec.distributed import (
        TpuIciShuffleExchangeExec)
    from spark_rapids_tpu_torch.exec.join import (
        CpuJoinExec, TpuSortMergeJoinExec)

    def bad(name, why):
        raise NotImplementedError(
            f"{name} is not supported in multi-executor mode "
            f"(executor.count > 1): {why}. Run on a single executor, or "
            "restructure the query around hash exchanges (agg / "
            "co-partitioned equi-join pipelines are supported).")

    def has_exchange(node):
        return isinstance(node, TpuIciShuffleExchangeExec) or any(
            has_exchange(c) for c in node.children)

    def walk(node):
        name = type(node).__name__
        if name in _MULTIPROC_UNSUPPORTED:
            bad(name, "it computes on one executor's slice only")
        if isinstance(node, TpuSortMergeJoinExec) and not node.partitioned:
            bad(name, "only co-partitioned (ICI-exchanged) equi-joins "
                "are distributed; this join would match one slice "
                "against another")
        if isinstance(node, CpuJoinExec):
            bad(name, "CPU-fallback joins gather one slice per process")
        gather_ok = getattr(node, "_multiproc_gather_ok", False)
        for c in node.children:
            # structural guards: a gather point collapses partitions
            # this process only partly owns; a partition-structure
            # change above an exchange breaks local-partition ownership.
            # Nodes flagged _multiproc_gather_ok (TopN, GlobalLimit)
            # gather via an explicit cross-process allgather instead.
            if (not isinstance(node, TpuIciShuffleExchangeExec)
                    and not gather_ok
                    and c.num_partitions() > 1
                    and node.num_partitions() == 1):
                bad(name, "it gathers all partitions into one, but "
                    "each executor holds only its slice")
            if (has_exchange(c) and not isinstance(
                    node, TpuIciShuffleExchangeExec)
                    and not gather_ok
                    and node.num_partitions() != c.num_partitions()):
                bad(name, "it re-groups partitions above a collective "
                    "exchange, breaking local-partition ownership")
            walk(c)

    walk(plan)


def apply_overrides(cpu_plan: CpuExec, conf: RapidsConf,
                    device: torch.device) -> OverrideResult:
    """GpuOverrides.apply + GpuTransitionOverrides in one pass.  A CPU
    session (``spark.rapids.sql.enabled=false``) keeps the CPU plan and
    places nothing on the device."""
    if not conf.sql_enabled:
        return OverrideResult(cpu_plan, [])
    # configure the budget arbiter from this query's conf before any
    # device materialization
    from spark_rapids_tpu_torch.runtime.memory import get_manager
    get_manager(conf, device)
    # arm the fault injector and refresh the retry policy from this
    # query's conf (spark.rapids.tpu.test.inject.*, retry.*)
    from spark_rapids_tpu_torch.runtime.resilience import (
        configure_from_conf)
    configure_from_conf(conf)
    metas: List[ExecMeta] = []
    root = wrap(cpu_plan, conf, metas)
    plan = convert_meta(root, device)
    if isinstance(plan, TpuExec):
        plan = DeviceToHostExec(plan)
    plan = insert_coalesce(plan, conf)
    # whole-stage fusion last: it needs the final converted tree (so the
    # member signatures it records match what an unfused run of this
    # exact plan would execute — see fusion/regions.py)
    from spark_rapids_tpu_torch.fusion import fuse_plan
    plan, _ = fuse_plan(plan, conf)
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    if get_executor() is not None:
        _validate_multiproc(plan)
    result = OverrideResult(plan, metas)

    explain = conf.explain
    report = result.fallback_report()
    if explain == "ALL" or (explain in ("NOT_ON_GPU", "NOT_ON_TPU")
                            and report):
        print("TPU plan rewrite:")
        for line in report:
            print("  " + line)
        if explain == "ALL":
            print(plan.tree_string())

    if conf.test_enabled and report:
        allowed = set(conf.allowed_non_gpu)
        bad = [m for m in metas if not m.can_run_on_tpu
               and type(m.cpu).__name__ not in allowed
               and (EXEC_RULES.get(type(m.cpu)) is None
                    or EXEC_RULES[type(m.cpu)].name not in allowed)]
        if bad:
            lines = "\n".join(r for m in bad for r in m.reasons)
            raise AssertionError(
                "Part of the plan is not columnar (TPU test mode): \n"
                + lines)
    return result
