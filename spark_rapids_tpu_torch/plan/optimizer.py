"""Logical optimizer: column pruning and file-scan pushdown.

The counterpart of the JAX package's ``plan/optimizer.py`` [REF: the
reference relies on Spark's own optimizer for column pruning and filter
pushdown and implements the scan side in GpuParquetScan.scala and
GpuFileSourceScanExec.scala].  Rules (bottom-up, one pass; they reach
through both sides of a join, below every one-child node and into each
input of a union):

* **In-memory column pruning** (``_prune_head``): a Project or Aggregate
  head over a chain of Filters over an in-memory relation narrows the
  arrow table to the columns it references before the host-to-device
  transfer (memoized per table and column set, so that the scan cache
  keeps hitting): q1 and q6 move 7 and 4 of lineitem's 16 columns;
* **Filter pushdown**: ``Filter* -> ParquetRelation`` chains attach
  their simple conjuncts ``(col, cmp, literal)`` to the relation for
  row-group statistics pruning.  The Filter stays in the plan: pruning
  is conservative, exactness comes from the Filter itself;
* **File column pruning** (``_prune_file_head``): a ``Project |
  Aggregate -> Filter* -> ParquetRelation`` chain narrows the relation
  to the referenced columns and remaps every bound reference in the
  chain;
* **input_file_name() binding**: markers in a head projection turn on
  the relation's file-name column and rebind to it (an Aggregate head's
  marker stays unbound and raises at execution, as in the JAX package);
* **Dynamic partition pruning** (``_dynamic_partition_pruning``, under
  ``spark.sql.optimizer.dynamicPartitionPruning.enabled``): a join whose
  probe side is a hive-partitioned file relation keyed on a partition
  column attaches the build side's key projection to the relation
  (``dpp``); the scan drains it on the host once and skips the files
  whose partition value it does not hold.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import List, Optional, Set, Tuple

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.plan import logical as L


def transform_expr(e: E.Expression, fn) -> E.Expression:
    """Rebuild an expression tree bottom-up; fn(node) may return a
    replacement (or None to keep the rebuilt node)."""
    if dataclasses.is_dataclass(e):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            nv = _transform_field(v, fn)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            e = dataclasses.replace(e, **changes)
    out = fn(e)
    return e if out is None else out


def _transform_field(v, fn):
    """A field of an expression node: an expression, or a list/tuple of
    them (``CaseWhen.branches`` holds (predicate, value) pairs)."""
    if isinstance(v, E.Expression):
        return transform_expr(v, fn)
    if isinstance(v, (list, tuple)):
        items = [_transform_field(x, fn) for x in v]
        if all(a is b for a, b in zip(items, v)):
            return v
        return type(v)(items) if isinstance(v, tuple) else items
    return v


def collect_refs(e: E.Expression, out: Set[int]) -> None:
    if isinstance(e, E.BoundReference):
        out.add(e.index)
    for c in e.children:
        collect_refs(c, out)


# Narrowed-table memo: ``pa.Table.select`` is zero-copy but makes a NEW
# object on every call, and the device scan cache (exec/basic.py) keys on
# table identity — without this memo every execution of a pruned plan
# would transfer its columns again.  Entries die with their parent table.
_narrow_memo: dict = {}


def _narrow_table(table, names: Tuple[str, ...]):
    key = (id(table), names)
    hit = _narrow_memo.get(key)
    if hit is not None:
        return hit
    out = table.select(list(names))
    try:
        weakref.finalize(table, _narrow_memo.pop, key, None)
    except TypeError:
        return out
    _narrow_memo[key] = out
    return out


def _has_file_name_marker(exprs) -> bool:
    found = [False]

    def look(e):
        if isinstance(e, E.InputFileName):
            found[0] = True
        for c in e.children:
            look(c)

    for e in exprs:
        look(e)
    return found[0]


_CMP_OPS = {E.EqualTo: "eq", E.LessThan: "lt", E.LessThanOrEqual: "le",
            E.GreaterThan: "gt", E.GreaterThanOrEqual: "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
_PUSHABLE_LIT = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                 T.FloatType, T.DoubleType, T.StringType, T.BooleanType)


def _n_data(rel: L.ParquetRelation) -> int:
    """The relation's data columns (before its partition and file-name
    columns)."""
    return (len(rel.schema.fields) - len(rel.partition_fields)
            - (1 if rel.file_name_col else 0))


def _extract_filters(cond: E.Expression, rel: L.ParquetRelation
                     ) -> List[tuple]:
    """Simple (col-name, op, literal) conjuncts for row-group pruning."""
    n_data = _n_data(rel)
    out = []

    def visit(e):
        if isinstance(e, E.And):
            visit(e.left)
            visit(e.right)
            return
        op = _CMP_OPS.get(type(e))
        if op is None:
            return
        ref, lit, flip = None, None, False
        if (isinstance(e.left, E.BoundReference)
                and isinstance(e.right, E.Literal)):
            ref, lit = e.left, e.right
        elif (isinstance(e.right, E.BoundReference)
              and isinstance(e.left, E.Literal)):
            ref, lit, flip = e.right, e.left, True
        if ref is None or lit.value is None or ref.index >= n_data:
            return
        if not isinstance(lit.dtype, _PUSHABLE_LIT):
            return
        v = lit.value
        if isinstance(v, float) and v != v:  # NaN never prunes
            return
        out.append((rel.schema.fields[ref.index].name,
                    _FLIP[op] if flip else op, v))

    visit(cond)
    return out


def _filter_chain(node) -> Tuple[List[L.Filter], L.LogicalPlan]:
    """(the chain of Filter nodes from the top, the node below it)."""
    filters = []
    while isinstance(node, L.Filter):
        filters.append(node)
        node = node.child
    return filters, node


def _rebuild_chain(filters: List[L.Filter], leaf, remap=None):
    """Re-stack Filter nodes (innermost last) over a new leaf, remapping
    their conditions when the leaf schema changed."""
    node = leaf
    for f in reversed(filters):
        cond = f.condition
        if remap is not None:
            cond = transform_expr(cond, remap)
        node = L.Filter(node, cond)
    return node


def _head_required_refs(plan, filters) -> Tuple[List, Set[int]]:
    """(head exprs, referenced column indexes) of a Project|Aggregate
    head over a Filter* chain — shared by the file and in-memory
    pruning rules so the two can never disagree on required columns."""
    if isinstance(plan, L.Project):
        head_exprs = list(plan.exprs)
    else:
        head_exprs = list(plan.grouping) + [f.child
                                            for f in plan.aggregates]
    required: Set[int] = set()
    for e in head_exprs:
        collect_refs(e, required)
    for f in filters:
        collect_refs(f.condition, required)
    return head_exprs, required


def _rebuild_head(plan, child, remap):
    """The Project|Aggregate head over ``child``, its references
    remapped."""
    if isinstance(plan, L.Project):
        return L.Project(child, [transform_expr(e, remap)
                                 for e in plan.exprs], plan.schema)
    return L.Aggregate(
        child, [transform_expr(e, remap) for e in plan.grouping],
        [dataclasses.replace(a, child=transform_expr(a.child, remap))
         for a in plan.aggregates], plan.schema)


def _make_remap(index_map, fn_idx):
    def remap(e):
        if isinstance(e, E.BoundReference):
            return E.BoundReference(index_map[e.index], e.dtype,
                                    e.nullable)
        if isinstance(e, E.InputFileName):
            if fn_idx is None:
                return None
            return E.BoundReference(fn_idx, T.StringT, False)
        return None
    return remap


def _prune_head(plan):
    """Project|Aggregate -> Filter* -> InMemoryRelation: narrow the arrow
    table to the referenced columns before the H2D transfer."""
    filters, node = _filter_chain(plan.child)
    if not isinstance(node, L.InMemoryRelation):
        return None
    head, required = _head_required_refs(plan, filters)
    fields = node.schema.fields
    if len(required) >= len(fields) or _has_file_name_marker(head):
        return None
    keep = sorted(required) or [0]
    remap = _make_remap({old: new for new, old in enumerate(keep)}, None)
    child = L.InMemoryRelation(
        _narrow_table(node.table, tuple(fields[i].name for i in keep)),
        T.StructType(tuple(fields[i] for i in keep)), node.num_partitions)
    return _rebuild_head(plan, _rebuild_chain(filters, child, remap),
                         remap)


def _prune_relation(rel: L.ParquetRelation, required: Set[int],
                    need_file_name: bool):
    """Narrowed file relation + old->new index map + the file-name
    column's new index (None without one)."""
    fields = rel.schema.fields
    n_data = _n_data(rel)
    if n_data and not any(i < n_data for i in required):
        # partition-only / count(*) shapes: always read >= 1 data column
        # — ORC's reader loses the row count on a zero-column read
        required = set(required) | {0}
    keep = sorted(required)
    index_map = {old: new for new, old in enumerate(keep)}
    new_fields = [fields[i] for i in keep]
    columns = [fields[i].name for i in keep if i < n_data]
    part_fields = tuple(fields[i] for i in keep
                        if n_data <= i < n_data + len(rel.partition_fields))
    file_name_col = rel.file_name_col or need_file_name
    if file_name_col:
        new_fields.append(T.StructField("input_file_name()", T.StringT,
                                        False))
        fn_idx = len(new_fields) - 1
    else:
        fn_idx = None
    new_rel = dataclasses.replace(
        rel, schema=T.StructType(tuple(new_fields)), columns=columns,
        partition_fields=part_fields, file_name_col=file_name_col)
    return new_rel, index_map, fn_idx


def _prune_file_head(plan):
    """Project|Aggregate -> Filter* -> ParquetRelation: read only the
    referenced columns, push the filters' simple conjuncts, bind a
    Project head's input_file_name() markers."""
    filters, rel = _filter_chain(plan.child)
    # the inner Filter rule may already have attached row-group filters
    # (bottom-up order): pruning only needs columns unset
    if not isinstance(rel, L.ParquetRelation) or rel.columns is not None:
        return None
    head, required = _head_required_refs(plan, filters)
    need_fn = isinstance(plan, L.Project) and _has_file_name_marker(head)
    pushed = rel.filters
    if pushed is None:
        pushed = []
        for f in filters:
            pushed.extend(_extract_filters(f.condition, rel))
    new_rel, index_map, fn_idx = _prune_relation(rel, required, need_fn)
    if pushed:
        new_rel = dataclasses.replace(new_rel, filters=pushed)
    remap = _make_remap(index_map, fn_idx)
    return _rebuild_head(plan, _rebuild_chain(filters, new_rel, remap),
                         remap)


def _push_filters(plan: L.Filter):
    """Filter* -> ParquetRelation: attach the chain's simple conjuncts to
    the relation (None when there is nothing to push)."""
    filters, rel = _filter_chain(plan)
    if not isinstance(rel, L.ParquetRelation) or rel.filters is not None:
        return None
    pushed = []
    for f in filters:
        pushed.extend(_extract_filters(f.condition, rel))
    if not pushed:
        return None
    return _rebuild_chain(filters, dataclasses.replace(rel, filters=pushed))


def optimize(plan: L.LogicalPlan, conf=None) -> L.LogicalPlan:
    plan = _rewrite_children(plan, conf)
    if isinstance(plan, (L.Project, L.Aggregate)):
        pruned = _prune_head(plan)
        if pruned is None:
            pruned = _prune_file_head(plan)
        if pruned is not None:
            return pruned
    if isinstance(plan, L.Filter):
        pushed = _push_filters(plan)
        if pushed is not None:
            return pushed
    if isinstance(plan, L.Join) and (conf is None
                                     or conf.get(C.DPP_ENABLED)):
        threshold = (conf.get(C.BROADCAST_THRESHOLD) if conf is not None
                     else 10 << 20)
        plan = _dynamic_partition_pruning(plan, threshold)
    return plan


def _rewrite_children(plan: L.LogicalPlan, conf=None) -> L.LogicalPlan:
    if isinstance(plan, L.Union):
        return L.Union([optimize(c, conf) for c in plan.inputs])
    if isinstance(plan, L.Join):
        return dataclasses.replace(plan, left=optimize(plan.left, conf),
                                   right=optimize(plan.right, conf))
    if hasattr(plan, "child"):
        return dataclasses.replace(plan, child=optimize(plan.child, conf))
    return plan


def _estimated_plan_bytes(plan) -> Optional[int]:
    """Rough output-size upper bound of a logical plan (None=unknown)."""
    if isinstance(plan, L.InMemoryRelation):
        return plan.table.nbytes
    if isinstance(plan, L.ParquetRelation):
        try:
            return sum(os.path.getsize(p) for p in plan.paths) * 4
        except OSError:
            return None
    if isinstance(plan, (L.Filter, L.Project, L.Sample, L.Limit,
                         L.Sort)):
        return _estimated_plan_bytes(plan.children[0])
    return None


def _dynamic_partition_pruning(join: L.Join, threshold: int) -> L.Join:
    """Attach a DPP subquery to a partitioned probe-side scan.

    [REF: GpuSubqueryBroadcastExec / DPP integration] When one join side
    is a hive-partitioned file relation whose join key IS a partition
    column, the other side's distinct keys (computed once, on the host,
    before the scan's first file) prune entire files.  Valid for the
    join types that drop probe rows without a match: inner, left-semi
    and right joins prune the left side; inner and left joins the
    right."""
    candidates = []
    if join.join_type in ("inner", "left_semi", "right"):
        candidates.append(("left", join.left, join.left_keys,
                           join.right, join.right_keys))
    if join.join_type in ("inner", "left"):
        candidates.append(("right", join.right, join.right_keys,
                           join.left, join.left_keys))
    for side, probe, probe_keys, build, build_keys in candidates:
        # column pruning may have left a Project head over the (already
        # narrowed) relation: peel it and map the key indices through
        # its exprs (_prune_relation keeps the [data..., partition...,
        # file name] layout, so the index math below still holds)
        proj = None
        inner = probe
        if isinstance(inner, L.Project):
            proj = inner
            inner = inner.child
        filters, rel = _filter_chain(inner)
        if (not isinstance(rel, L.ParquetRelation)
                or not rel.partition_values or rel.dpp is not None):
            continue
        # the subquery runs on the host before the scan: only worth it
        # (and only safe) for broadcast-sized build sides, the gate Spark
        # uses for DPP without broadcast reuse
        est = _estimated_plan_bytes(build)
        if threshold <= 0 or est is None or est > threshold:
            continue
        n_data = _n_data(rel)
        for ki, key in enumerate(probe_keys):
            if not isinstance(key, E.BoundReference):
                continue
            if proj is not None:
                key = proj.exprs[key.index]
                if not isinstance(key, E.BoundReference):
                    continue
            if not (n_data <= key.index
                    < n_data + len(rel.partition_fields)):
                continue
            col_name = rel.schema.fields[key.index].name
            bkey = build_keys[ki]
            sub = L.Project(
                build, [bkey],
                T.StructType((T.StructField("_dpp_key", bkey.dtype),)))
            new_probe = _rebuild_chain(
                filters, dataclasses.replace(rel, dpp=(sub, col_name)))
            if proj is not None:
                new_probe = dataclasses.replace(proj, child=new_probe)
            if side == "left":
                return dataclasses.replace(join, left=new_probe)
            return dataclasses.replace(join, right=new_probe)
    return join
