"""String comparison over padded byte matrices — the subset of the JAX
package's ``ops/strings.py`` that the join slice needs (TPC-H q3's
``c_mktsegment == 'BUILDING'``): ``_pad_to``, ``_lex_lt_le``,
``StringComparison`` and ``string_comparison``.  The analyzer routes
every comparison of two strings here, as the JAX analyzer does.  The
other string expressions (``Like``, ``Substring``, predicates, casts)
are a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops.expressions import (
    Expression, merge_validity)


def _pad_to(col: DeviceColumn, w: int) -> torch.Tensor:
    """Pad (with zero bytes) or truncate a string column's byte matrix to
    width ``w``."""
    cur = col.data.shape[1]
    if cur == w:
        return col.data
    if cur < w:
        return torch.nn.functional.pad(col.data, (0, w - cur))
    return col.data[:, :w]


def _lex_lt_le(a: DeviceColumn, b: DeviceColumn):
    """(a < b, a <= b), bytewise lexicographic."""
    w = max(a.data.shape[1], b.data.shape[1])
    am = _pad_to(a, w).to(torch.int32)
    bm = _pad_to(b, w).to(torch.int32)
    diff = am != bm
    any_diff = diff.any(dim=1)
    first = torch.argmax(diff.to(torch.uint8), dim=1)
    rows = torch.arange(am.shape[0], device=am.device)
    ab = am[rows, first]
    bb = bm[rows, first]
    lt = torch.where(any_diff, ab < bb, a.lengths < b.lengths)
    eq = ~any_diff & (a.lengths == b.lengths)
    return lt, lt | eq


@dataclasses.dataclass
class StringComparison(Expression):
    op: str  # eq, lt, le, gt, ge
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def name(self):
        return {"eq": "EqualTo", "lt": "LessThan", "le": "LessThanOrEqual",
                "gt": "GreaterThan", "ge": "GreaterThanOrEqual"}[self.op]

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        validity = merge_validity(l.validity, r.validity)
        if self.op == "eq":
            w = max(l.data.shape[1], r.data.shape[1])
            eq = (_pad_to(l, w) == _pad_to(r, w)).all(dim=1) & (
                l.lengths == r.lengths)
            return DeviceColumn(self.dtype, eq, validity)
        lt, le = _lex_lt_le(l, r)
        data = {"lt": lt, "le": le, "gt": ~le, "ge": ~lt}[self.op]
        return DeviceColumn(self.dtype, data, validity)


def string_comparison(op: str, l: Expression, r: Expression) -> Expression:
    return StringComparison(op, l, r)
