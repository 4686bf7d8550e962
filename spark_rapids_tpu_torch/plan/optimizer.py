"""Logical optimizer — only the in-memory column-pruning rule so far.

The counterpart of ``_inmemory_prune_head`` in the JAX package's
``plan/optimizer.py``: a Project or Aggregate head over a chain of
Filters over an in-memory relation narrows the arrow table to the
columns it references before the host-to-device transfer (the analog of
Spark's ColumnPruning), so that q1 and q6 move 7 and 4 of lineitem's 16
columns to the device.  The rule reaches through both sides of a join
and below a limit.  The JAX package's other rules (parquet
pushdown, dynamic partition pruning) are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Set

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


def _prune_head(plan):
    filters = []
    node = plan.child
    while isinstance(node, L.Filter):
        filters.append(node)
        node = node.child
    if not isinstance(node, L.InMemoryRelation):
        return None
    if isinstance(plan, L.Project):
        head = list(plan.exprs)
    else:
        head = list(plan.grouping) + [f.child for f in plan.aggregates]
    required: Set[int] = set()
    for e in head:
        collect_refs(e, required)
    for f in filters:
        collect_refs(f.condition, required)
    fields = node.schema.fields
    if len(required) >= len(fields):
        return None
    keep = sorted(required) or [0]
    index_map = {old: new for new, old in enumerate(keep)}

    def remap(e):
        if isinstance(e, E.BoundReference):
            return E.BoundReference(index_map[e.index], e.dtype,
                                    e.nullable)
        return None

    child = L.InMemoryRelation(
        node.table.select([fields[i].name for i in keep]),
        T.StructType(tuple(fields[i] for i in keep)))
    for f in reversed(filters):
        child = L.Filter(child, transform_expr(f.condition, remap))
    if isinstance(plan, L.Project):
        return L.Project(child, [transform_expr(e, remap)
                                 for e in plan.exprs], plan.schema)
    return L.Aggregate(
        child, [transform_expr(e, remap) for e in plan.grouping],
        [dataclasses.replace(a, child=transform_expr(a.child, remap))
         for a in plan.aggregates], plan.schema)


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    if isinstance(plan, L.Join):
        return dataclasses.replace(plan, left=optimize(plan.left),
                                   right=optimize(plan.right))
    if isinstance(plan, (L.Project, L.Filter, L.Aggregate, L.Sort,
                         L.Limit)):
        plan = dataclasses.replace(plan, child=optimize(plan.child))
    if isinstance(plan, (L.Project, L.Aggregate)):
        pruned = _prune_head(plan)
        if pruned is not None:
            return pruned
    return plan
