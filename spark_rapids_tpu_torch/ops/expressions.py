"""Bound, typed expressions over device batches — the subset of the
ported TPC-H queries.

Counterparts of the JAX package's ``ops/expressions.py`` classes of the
same names, with the same Spark semantics (non-ANSI arithmetic and
division, NaN greater than every other value in comparisons,
three-valued And/Or, a null predicate taking a conditional's else
branch, Java's numeric casts).
Each node evaluates with ``eval(batch)`` on tensors.  Expressions that
this slice does not port are not defined here; the analyzer raises
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, torch_dtype)


def merge_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.FloatType, T.DoubleType))


class Expression:
    """Base expression.  Subclasses are dataclasses with typed children."""

    dtype: T.DataType

    @property
    def children(self) -> Sequence["Expression"]:
        return ()

    @property
    def name(self) -> str:
        return type(self).__name__

    def eval(self, batch: DeviceBatch) -> DeviceColumn:
        raise NotImplementedError(f"{self.name}.eval")

    def __str__(self):
        cs = ", ".join(str(c) for c in self.children)
        return f"{self.name}({cs})"


@dataclasses.dataclass
class BoundReference(Expression):
    index: int
    dtype: T.DataType
    nullable: bool = True

    def eval(self, batch):
        return batch.columns[self.index]

    def __str__(self):
        return f"input[{self.index}]"


@dataclasses.dataclass
class Literal(Expression):
    """A constant column; dates arrive as int32 days since the epoch (the
    analyzer converts ``datetime.date`` values)."""

    value: Any
    dtype: T.DataType

    def eval(self, batch):
        b = batch.capacity
        dev = batch.device
        if isinstance(self.dtype, T.StringType):
            return self._eval_string(b, dev)
        if isinstance(self.dtype, (T.BinaryType, T.NullType)):
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: {self.dtype} literal is not "
                "ported yet")
        tdt = torch_dtype(self.dtype)
        if self.value is None:
            return DeviceColumn(self.dtype,
                                torch.zeros((b,), dtype=tdt, device=dev),
                                torch.zeros((b,), dtype=torch.bool,
                                            device=dev))
        return DeviceColumn(self.dtype, torch.full(
            (b,), self.value, dtype=tdt, device=dev))

    def _eval_string(self, b: int, dev) -> DeviceColumn:
        """A string constant as a broadcast ``uint8[B, W]`` matrix (W =
        its UTF-8 length, at least 1), as the JAX package builds it."""
        if self.value is None:
            return DeviceColumn(
                self.dtype, torch.zeros((b, 1), dtype=torch.uint8,
                                        device=dev),
                torch.zeros((b,), dtype=torch.bool, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev))
        bs = str(self.value).encode()
        row = torch.tensor(list(bs.ljust(max(len(bs), 1), b"\0")),
                           dtype=torch.uint8, device=dev)
        return DeviceColumn(self.dtype, row.expand(b, -1), None,
                            torch.full((b,), len(bs), dtype=torch.int32,
                                       device=dev))

    def __str__(self):
        return repr(self.value)


@dataclasses.dataclass
class Alias(Expression):
    child: Expression
    alias_name: str

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        return self.child.eval(batch)

    def __str__(self):
        return f"{self.child} AS {self.alias_name}"


# ---------------------------------------------------------------------------
# arithmetic  [REF: arithmetic.scala :: GpuAdd, GpuSubtract, GpuMultiply]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BinaryArith(Expression):
    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def children(self):
        return (self.left, self.right)

    def _op(self, a, b):
        raise NotImplementedError

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        # integer overflow wraps (non-ANSI Spark), as torch's int ops do
        return DeviceColumn(self.dtype, self._op(l.data, r.data),
                            merge_validity(l.validity, r.validity))


class Add(_BinaryArith):
    def _op(self, a, b):
        return a + b


class Subtract(_BinaryArith):
    def _op(self, a, b):
        return a - b


class Multiply(_BinaryArith):
    def _op(self, a, b):
        return a * b


@dataclasses.dataclass
class Divide(Expression):
    """Double division; x / 0 -> null (non-ANSI Spark).  The analyzer
    casts both sides to double."""

    left: Expression
    right: Expression

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        zero = r.data == 0.0
        data = l.data / torch.where(zero, 1.0, r.data)
        return DeviceColumn(self.dtype, torch.where(zero, 0.0, data),
                            merge_validity(l.validity, r.validity, ~zero))


# ---------------------------------------------------------------------------
# comparisons  [REF: predicates.scala]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BinaryComparison(Expression):
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.left, self.right)

    def _cmp(self, a, b):
        raise NotImplementedError

    def _cmp_nan(self, a, b, an, bn):
        """Spark float order: NaN is greater than every other value and
        equal to itself."""
        raise NotImplementedError

    def eval(self, batch):
        if isinstance(self.left.dtype, (T.StringType, T.BinaryType)):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: binary comparison is not ported "
                "yet (string comparisons are ops/strings.py's)")
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if _is_float(self.left.dtype):
            data = self._cmp_nan(l.data, r.data, torch.isnan(l.data),
                                 torch.isnan(r.data))
        else:
            data = self._cmp(l.data, r.data)
        return DeviceColumn(self.dtype, data,
                            merge_validity(l.validity, r.validity))


class EqualTo(_BinaryComparison):
    def _cmp(self, a, b):
        return a == b

    def _cmp_nan(self, a, b, an, bn):
        return (an & bn) | (a == b)


class LessThan(_BinaryComparison):
    def _cmp(self, a, b):
        return a < b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(bn & ~an, True, torch.where(an, False, a < b))


class LessThanOrEqual(_BinaryComparison):
    def _cmp(self, a, b):
        return a <= b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(bn, True, torch.where(an, False, a <= b))


class GreaterThan(_BinaryComparison):
    def _cmp(self, a, b):
        return a > b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(an & ~bn, True, torch.where(bn, False, a > b))


class GreaterThanOrEqual(_BinaryComparison):
    def _cmp(self, a, b):
        return a >= b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(an, True, torch.where(bn, False, a >= b))


# ---------------------------------------------------------------------------
# three-valued logic  [REF: predicates.scala :: GpuAnd, GpuOr, GpuNot]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Not(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, ~c.data, c.validity)


@dataclasses.dataclass
class And(Expression):
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if l.validity is None and r.validity is None:
            return DeviceColumn(self.dtype, l.data & r.data)
        lv, rv = l.valid_mask(), r.valid_mask()
        # null unless: both valid, or either side is a valid False
        validity = (lv & rv) | (lv & ~l.data) | (rv & ~r.data)
        return DeviceColumn(self.dtype, l.data & r.data & validity,
                            validity)


@dataclasses.dataclass
class Or(Expression):
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if l.validity is None and r.validity is None:
            return DeviceColumn(self.dtype, l.data | r.data)
        lv, rv = l.valid_mask(), r.valid_mask()
        data = (l.data & lv) | (r.data & rv)
        validity = (lv & rv) | (lv & l.data) | (rv & r.data)
        return DeviceColumn(self.dtype, data, validity)


# ---------------------------------------------------------------------------
# conditionals  [REF: conditionalExpressions.scala :: GpuIf, GpuCaseWhen]
# ---------------------------------------------------------------------------

def device_select(cond: torch.Tensor, a: DeviceColumn, b: DeviceColumn,
                  dtype: T.DataType) -> DeviceColumn:
    """Row-wise ``a`` where ``cond`` else ``b`` (string-aware: byte
    matrices pad to the wider of the two).  Validity is the caller's."""
    if a.lengths is not None or b.lengths is not None:
        w = max(int(a.data.shape[1]), int(b.data.shape[1]))
        da = torch.nn.functional.pad(a.data, (0, w - a.data.shape[1]))
        db = torch.nn.functional.pad(b.data, (0, w - b.data.shape[1]))
        return DeviceColumn(dtype, torch.where(cond[:, None], da, db),
                            None, torch.where(cond, a.lengths, b.lengths))
    return DeviceColumn(dtype, torch.where(cond, a.data, b.data))


@dataclasses.dataclass
class If(Expression):
    pred: Expression
    true_value: Expression
    false_value: Expression

    @property
    def dtype(self):
        return self.true_value.dtype

    @property
    def children(self):
        return (self.pred, self.true_value, self.false_value)

    def eval(self, batch):
        p = self.pred.eval(batch)
        t = self.true_value.eval(batch)
        f = self.false_value.eval(batch)
        cond = p.data & p.valid_mask()  # null predicate -> false branch
        out = device_select(cond, t, f, self.dtype)
        out.validity = torch.where(cond, t.valid_mask(), f.valid_mask())
        return out


@dataclasses.dataclass
class CaseWhen(Expression):
    """``CASE WHEN p1 THEN v1 ... [ELSE e] END``: the first branch whose
    predicate is true (null counts as false); no ELSE gives null."""

    branches: List[Tuple[Expression, Expression]]
    else_value: Optional[Expression] = None

    @property
    def dtype(self):
        return self.branches[0][1].dtype

    @property
    def children(self):
        cs = []
        for p, v in self.branches:
            cs += [p, v]
        if self.else_value is not None:
            cs.append(self.else_value)
        return tuple(cs)

    def eval(self, batch):
        if self.else_value is not None:
            acc = self.else_value.eval(batch)
            validity = acc.valid_mask()
        else:
            first = self.branches[0][1].eval(batch)
            acc = DeviceColumn(
                self.dtype, torch.zeros_like(first.data), None,
                None if first.lengths is None
                else torch.zeros_like(first.lengths))
            validity = torch.zeros((batch.capacity,), dtype=torch.bool,
                                   device=batch.device)
        for pred, val in reversed(self.branches):
            p = pred.eval(batch)
            v = val.eval(batch)
            cond = p.data & p.valid_mask()
            acc = device_select(cond, v, acc, self.dtype)
            validity = torch.where(cond, v.valid_mask(), validity)
        return DeviceColumn(self.dtype, acc.data, validity, acc.lengths)


# ---------------------------------------------------------------------------
# casts  [REF: GpuCast.scala] — numeric and boolean only
# ---------------------------------------------------------------------------

_INT_RANGES = {
    T.ByteType: (-128, 127),
    T.ShortType: (-(1 << 15), (1 << 15) - 1),
    T.IntegerType: (-(1 << 31), (1 << 31) - 1),
    T.LongType: (-(1 << 63), (1 << 63) - 1),
}


def _castable(dt: T.DataType) -> bool:
    return T.is_integral(dt) or isinstance(
        dt, (T.FloatType, T.DoubleType, T.BooleanType))


@dataclasses.dataclass
class Cast(Expression):
    """Java's casts among int, long, float, double and boolean: integral
    narrowing wraps, floating to integral maps NaN to 0, saturates at the
    type's bounds and truncates toward zero, anything to boolean is
    ``!= 0``.  Casts from or to strings, dates and decimals are not
    ported and raise when built."""

    child: Expression
    dtype: T.DataType

    def __post_init__(self):
        src, dst = self.child.dtype, self.dtype
        if not (_castable(src) and _castable(dst)):
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: Cast({self.child} as "
                f"{dst.simple_name}) from {src.simple_name} is not "
                "ported yet")

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, self._cast(c.data), c.validity)

    def _cast(self, data: torch.Tensor) -> torch.Tensor:
        src, dst = self.child.dtype, self.dtype
        out = torch_dtype(dst)
        if isinstance(dst, T.BooleanType):
            return data != 0
        if _is_float(src) and T.is_integral(dst):
            lo, hi = _INT_RANGES[type(dst)]
            d = torch.where(torch.isnan(data), 0.0, data).to(torch.float64)
            # the bounds as doubles: 2^63 - 1 rounds up to 2^63, which no
            # int64 holds, so the top saturates explicitly
            top = d >= float(hi)
            d = torch.trunc(d.clamp(float(lo), float(hi)))
            res = torch.where(top, 0.0, d).to(torch.int64)
            res = torch.where(top, hi, res)
            return res.to(out)
        return data.to(out)  # integral narrowing wraps (Java)

    def __str__(self):
        return f"cast({self.child} as {self.dtype.simple_name})"
