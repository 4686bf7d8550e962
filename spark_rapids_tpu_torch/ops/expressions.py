"""Bound, typed expressions over device batches — the subset of the
ported TPC-H queries.

Counterparts of the JAX package's ``ops/expressions.py`` classes of the
same names, with the same Spark semantics (non-ANSI arithmetic and
division, NaN greater than every other value in comparisons,
three-valued And/Or, a null predicate taking a conditional's else
branch, Java's numeric casts).
Each node lowers two ways, as there: ``eval(DeviceBatch)`` on tensors,
and ``eval_cpu(HostBatch)`` in numpy, the CPU fallback and oracle path
(the JAX package's bodies, copied).  Each class also declares the
TypeSig the plan rewrite checks (``type_sig``, ``input_sig``; the
``ansi_sensitive`` flag).  Where the JAX package's own two branches
disagree (``Floor``/``Ceil`` of NaN, the infinities and out-of-range
values; ``Round`` of -0.0), the device branch gives ``eval_tpu``'s bits
on every device and the host branch ``eval_cpu``'s.  Decimals keep the
JAX package's representation: a scaled int64 up to 18 digits,
``ops/decimal128.py``'s (hi, lo) pair past it on the device and exact
Python ints on the host; a decimal128 result of ``+``, ``-`` or ``*``
is null where it overflows its precision.  Expressions that
this slice does not port are not defined here; the analyzer raises
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, torch_dtype)
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostCol
from spark_rapids_tpu_torch.ops import decimal128 as D128
from spark_rapids_tpu_torch.runtime.device import device_constant


def merge_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def merge_validity_h(*vs: Optional[np.ndarray]) -> Optional[np.ndarray]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.FloatType, T.DoubleType))


# ---------------------------------------------------------------------------
# TypeSig: per-expression declared type support [REF: TypeChecks.scala ::
# TypeSig/ExprChecks].  Each expression class declares the type TAGS its
# device lowering accepts for inputs (``input_sig``) and produces
# (``type_sig``); the plan rewrite checks both while tagging.
# ---------------------------------------------------------------------------

SIG_TAGS = ("boolean", "byte", "short", "int", "long", "float", "double",
            "decimal", "string", "binary", "date", "timestamp", "null",
            "array", "map", "struct")

SIG_ALL_SCALAR = frozenset(SIG_TAGS) - {"array", "map", "struct"}
SIG_NUMERIC = frozenset({"byte", "short", "int", "long", "float",
                         "double", "decimal", "null"})
SIG_INTEGRAL = frozenset({"byte", "short", "int", "long", "null"})
SIG_FLOATING = frozenset({"float", "double", "null"})
SIG_STRINGY = frozenset({"string", "binary", "null"})
SIG_BOOLEAN = frozenset({"boolean", "null"})
SIG_DATETIME = frozenset({"date", "timestamp", "null"})
SIG_ALL = frozenset(SIG_TAGS)


def sig_tag(dt: T.DataType) -> str:
    """Type tag of a dtype for TypeSig membership checks."""
    if isinstance(dt, T.DecimalType):
        return "decimal"
    if isinstance(dt, T.ArrayType):
        return "array"
    if isinstance(dt, T.MapType):
        return "map"
    if isinstance(dt, T.StructType):
        return "struct"
    return {T.BooleanType: "boolean", T.ByteType: "byte",
            T.ShortType: "short", T.IntegerType: "int",
            T.LongType: "long", T.FloatType: "float",
            T.DoubleType: "double", T.StringType: "string",
            T.BinaryType: "binary", T.DateType: "date",
            T.TimestampType: "timestamp",
            T.NullType: "null"}.get(type(dt), dt.simple_name)


class Expression:
    """Base expression.  Subclasses are dataclasses with typed children."""

    dtype: T.DataType
    # TypeSig declarations; tagging checks result dtype against
    # ``type_sig`` and every child dtype against ``input_sig`` (None =
    # same as type_sig).  Default = every scalar type; classes narrow.
    type_sig: frozenset = SIG_ALL_SCALAR
    input_sig: Optional[frozenset] = None

    @property
    def children(self) -> Sequence["Expression"]:
        return ()

    @property
    def name(self) -> str:
        return type(self).__name__

    def eval(self, batch: DeviceBatch) -> DeviceColumn:
        raise NotImplementedError(f"{self.name}.eval")

    def eval_cpu(self, batch: HostBatch) -> HostCol:
        raise NotImplementedError(f"{self.name}.eval_cpu")

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

    def eval_cpu(self, batch):
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
        shape = (b, 2) if D128.is128(self.dtype) else (b,)
        if self.value is None:
            return DeviceColumn(self.dtype,
                                torch.zeros(shape, dtype=tdt, device=dev),
                                torch.zeros((b,), dtype=torch.bool,
                                            device=dev))
        v = self.value
        if isinstance(self.dtype, T.DecimalType):
            v = _unscaled_literal(v, self.dtype)
            if D128.is128(self.dtype):
                pair = device_constant(
                    ("literal.decimal128", v), dev,
                    lambda: torch.from_numpy(D128.np_pack([v])))
                return DeviceColumn(self.dtype, pair.expand(b, 2))
        return DeviceColumn(self.dtype, torch.full(
            (b,), v, dtype=tdt, device=dev))

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
        padded = bs.ljust(max(len(bs), 1), b"\0")
        row = device_constant(
            ("literal.string", padded), dev,
            lambda: torch.tensor(list(padded), dtype=torch.uint8))
        return DeviceColumn(self.dtype, row.expand(b, -1), None,
                            torch.full((b,), len(bs), dtype=torch.int32,
                                       device=dev))

    def eval_cpu(self, batch):
        n = batch.num_rows
        if self.value is None:
            if isinstance(self.dtype, (T.StringType, T.BinaryType)):
                return HostCol(self.dtype, np.full(n, "", object),
                               np.zeros(n, bool))
            npdt = (np.int32 if isinstance(self.dtype, T.NullType)
                    else T.to_numpy_dtype(self.dtype))
            return HostCol(self.dtype, np.zeros(n, npdt), np.zeros(n, bool))
        if isinstance(self.dtype, T.StringType):
            return HostCol(self.dtype, np.array([self.value] * n, object))
        v = self.value
        if isinstance(self.dtype, T.DecimalType):
            v = _unscaled_literal(v, self.dtype)
            if D128.is128(self.dtype):
                out = np.empty(n, dtype=object)
                out[:] = v
                return HostCol(self.dtype, out)
        return HostCol(self.dtype,
                       np.full(n, v, T.to_numpy_dtype(self.dtype)))

    def __str__(self):
        return repr(self.value)


def _unscaled_literal(v, dt: T.DecimalType) -> int:
    """A decimal literal's unscaled value at its type's scale."""
    import decimal
    return D128.py_unscaled(decimal.Decimal(str(v)), dt.scale)


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

    def eval_cpu(self, batch):
        return self.child.eval_cpu(batch)

    def __str__(self):
        return f"{self.child} AS {self.alias_name}"


# ---------------------------------------------------------------------------
# arithmetic  [REF: arithmetic.scala :: GpuAdd, GpuSubtract, GpuMultiply]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BinaryArith(Expression):
    # device lowering implements NON-ANSI Spark semantics (overflow
    # wraps, invalid ops null); under spark.sql.ansi.enabled the planner
    # keeps these on CPU [REF: GpuOverrides ANSI checks]
    ansi_sensitive = True
    left: Expression
    right: Expression
    # a decimal result type (the analyzer's precision and scale
    # bookkeeping); None = the left operand's type passes through
    forced_dtype: Optional[T.DataType] = None

    # the decimal128 lowering: ``ops/decimal128.py``'s checked limb
    # arithmetic (values wrap mod 2^128, the ok flag says whether the
    # exact result fitted)
    _d128_op = None

    @property
    def dtype(self):
        return self.forced_dtype or self.left.dtype

    @property
    def children(self):
        return (self.left, self.right)

    def _op(self, a, b):
        raise NotImplementedError

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if D128.is128(self.dtype):
            op = type(self)._d128_op
            if op is None:
                raise NotImplementedError(
                    f"decimal128 {type(self).__name__}")
            data, ok = op(_as128(l.data, l.dtype), _as128(r.data, r.dtype))
            # Spark non-ANSI: overflow past the result's precision (or
            # the 128-bit container) nulls the row
            fits = ok & D128.fits_precision(data, self.dtype.precision)
            return DeviceColumn(self.dtype, data, merge_validity(
                l.validity, r.validity, fits))
        # integer overflow wraps (non-ANSI Spark), as torch's int ops do
        return DeviceColumn(self.dtype, self._op(l.data, r.data),
                            merge_validity(l.validity, r.validity))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        if D128.is128(self.dtype):
            la = np.array([int(v) for v in l.data], dtype=object)
            ra = np.array([int(v) for v in r.data], dtype=object)
            data = self._op(la, ra)
            # the exact python-int result; overflow past the declared
            # precision nulls the row (its value stored as 0)
            fits = np.array([D128.py_fits(v, self.dtype.precision)
                             for v in data], dtype=bool)
            out = np.empty(len(data), dtype=object)
            for i, v in enumerate(data):
                out[i] = int(v) if fits[i] else 0
            return HostCol(self.dtype, out, merge_validity_h(
                l.validity, r.validity, fits))
        with np.errstate(all="ignore"):
            data = self._op(l.data, r.data)
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


class Add(_BinaryArith):
    _d128_op = staticmethod(D128.add_checked)

    def _op(self, a, b):
        return a + b


class Subtract(_BinaryArith):
    _d128_op = staticmethod(D128.sub_checked)

    def _op(self, a, b):
        return a - b


class Multiply(_BinaryArith):
    _d128_op = staticmethod(D128.mul_checked)

    def _op(self, a, b):
        return a * b


@dataclasses.dataclass
class Divide(Expression):
    """Double division; x / 0 -> null (non-ANSI Spark).  The analyzer
    casts both sides to double."""

    ansi_sensitive = True

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

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        zero = r.data == 0.0
        with np.errstate(all="ignore"):
            data = np.where(zero, 0.0, l.data / np.where(zero, 1.0, r.data))
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity, ~zero))

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class IntegralDivide(Expression):
    """``div``: long division truncating toward zero; x div 0 -> null.

    ``MIN div -1`` wraps to ``MIN`` (the JAX package's ``lax.div``),
    computed as a negation: the integer division itself traps on it on
    the CPU, so no divisor of -1 reaches it."""

    ansi_sensitive = True

    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.LongType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        num = l.data.to(torch.int64)
        den = r.data.to(torch.int64)
        zero = den == 0
        neg_one = den == -1
        safe = torch.where(zero | neg_one, 1, den)
        data = torch.div(num, safe, rounding_mode="trunc")
        data = torch.where(neg_one, -num, data)  # -MIN wraps to MIN
        return DeviceColumn(self.dtype, torch.where(zero, 0, data),
                            merge_validity(l.validity, r.validity, ~zero))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        zero = r.data == 0
        den = np.where(zero, 1, r.data).astype(np.int64)
        num = l.data.astype(np.int64)
        with np.errstate(all="ignore"):
            q = np.abs(num) // np.abs(den)
            data = np.where((num < 0) != (den < 0), -q, q)
        return HostCol(self.dtype, np.where(zero, 0, data),
                       merge_validity_h(l.validity, r.validity, ~zero))


@dataclasses.dataclass
class Remainder(Expression):
    """``%``: the sign follows the dividend (Java); x % 0 -> null.  An
    integer divisor of -1 becomes 1 (the remainder is 0 either way), so
    ``MIN % -1`` never reaches a trapping op."""

    ansi_sensitive = True

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
        if _is_float(self.dtype):
            return DeviceColumn(self.dtype, torch.fmod(l.data, r.data),
                                merge_validity(l.validity, r.validity))
        zero = r.data == 0
        den = torch.where(zero | (r.data == -1), 1, r.data)
        data = torch.fmod(l.data, den)
        return DeviceColumn(self.dtype, torch.where(zero, 0, data),
                            merge_validity(l.validity, r.validity, ~zero))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        with np.errstate(all="ignore"):
            if _is_float(self.dtype):
                return HostCol(self.dtype, np.fmod(l.data, r.data),
                               merge_validity_h(l.validity, r.validity))
            zero = r.data == 0
            den = np.where(zero, 1, r.data)
            data = np.fmod(l.data, den)
        return HostCol(self.dtype, np.where(zero, 0, data),
                       merge_validity_h(l.validity, r.validity, ~zero))


@dataclasses.dataclass
class UnaryMinus(Expression):
    ansi_sensitive = True
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        if D128.is128(self.dtype):
            return DeviceColumn(self.dtype, D128.neg(c.data), c.validity)
        return DeviceColumn(self.dtype, -c.data, c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, -c.data, c.validity)


@dataclasses.dataclass
class Abs(Expression):
    ansi_sensitive = True
    child: Expression

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        if D128.is128(self.dtype):
            return DeviceColumn(self.dtype, D128.abs128(c.data)[0],
                                c.validity)
        return DeviceColumn(self.dtype, torch.abs(c.data), c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, np.abs(c.data), c.validity)


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

    def _is128(self) -> bool:
        return D128.is128(self.left.dtype) or D128.is128(self.right.dtype)

    def eval(self, batch):
        if isinstance(self.left.dtype, (T.StringType, T.BinaryType)):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: binary comparison is not ported "
                "yet (string comparisons are ops/strings.py's)")
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if self._is128():
            # in terms of the limb-pair primitives
            data = _D128_CMPS[type(self).__name__](
                D128.cmp_lt, D128.cmp_eq, _as128(l.data, self.left.dtype),
                _as128(r.data, self.right.dtype))
        elif _is_float(self.left.dtype):
            data = self._cmp_nan(l.data, r.data, torch.isnan(l.data),
                                 torch.isnan(r.data))
        else:
            data = self._cmp(l.data, r.data)
        return DeviceColumn(self.dtype, data,
                            merge_validity(l.validity, r.validity))

    def eval_cpu(self, batch):
        if isinstance(self.left.dtype, (T.StringType, T.BinaryType)):
            raise NotImplementedError(
                "string comparison handled in strings.py")
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        with np.errstate(all="ignore"):
            if self._is128():
                # exact python ints
                la = np.array([int(v) for v in l.data], dtype=object)
                ra = np.array([int(v) for v in r.data], dtype=object)
                data = _D128_CMPS[type(self).__name__](
                    lambda a, b: a < b, lambda a, b: a == b,
                    la, ra).astype(bool)
            elif _is_float(self.left.dtype):
                data = self._cmp_h(l.data, r.data, np.isnan(l.data),
                                   np.isnan(r.data))
            else:
                zeros = np.zeros(len(l.data), bool)
                data = self._cmp_h(l.data, r.data, zeros, zeros)
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


def _as128(data: torch.Tensor, dt: T.DataType) -> torch.Tensor:
    return data if D128.is128(dt) else D128.from_i64(data)


# the decimal128 comparisons, in terms of (less than, equal)
_D128_CMPS = {
    "EqualTo": lambda lt, eq, a, b: eq(a, b),
    "EqualNullSafe": lambda lt, eq, a, b: eq(a, b),
    "LessThan": lambda lt, eq, a, b: lt(a, b),
    "LessThanOrEqual": lambda lt, eq, a, b: ~lt(b, a),
    "GreaterThan": lambda lt, eq, a, b: lt(b, a),
    "GreaterThanOrEqual": lambda lt, eq, a, b: ~lt(a, b),
}


class EqualTo(_BinaryComparison):
    def _cmp(self, a, b):
        return a == b

    def _cmp_nan(self, a, b, an, bn):
        return (an & bn) | (a == b)

    def _cmp_h(self, a, b, an, bn):
        return np.where(an & bn, True, a == b)


class LessThan(_BinaryComparison):
    def _cmp(self, a, b):
        return a < b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(bn & ~an, True, torch.where(an, False, a < b))

    def _cmp_h(self, a, b, an, bn):
        return np.where(bn & ~an, True, np.where(an, False, a < b))


class LessThanOrEqual(_BinaryComparison):
    def _cmp(self, a, b):
        return a <= b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(bn, True, torch.where(an, False, a <= b))

    def _cmp_h(self, a, b, an, bn):
        return np.where(bn, True, np.where(an, False, a <= b))


class GreaterThan(_BinaryComparison):
    def _cmp(self, a, b):
        return a > b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(an & ~bn, True, torch.where(bn, False, a > b))

    def _cmp_h(self, a, b, an, bn):
        return np.where(an & ~bn, True, np.where(bn, False, a > b))


class GreaterThanOrEqual(_BinaryComparison):
    def _cmp(self, a, b):
        return a >= b

    def _cmp_nan(self, a, b, an, bn):
        return torch.where(an, True, torch.where(bn, False, a >= b))

    def _cmp_h(self, a, b, an, bn):
        return np.where(an, True, np.where(bn, False, a >= b))


@dataclasses.dataclass
class EqualNullSafe(Expression):
    """``<=>``: never null; null <=> null is true, NaN <=> NaN too."""

    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        lv, rv = l.valid_mask(), r.valid_mask()
        if D128.is128(self.left.dtype) or D128.is128(self.right.dtype):
            eq = D128.cmp_eq(_as128(l.data, self.left.dtype),
                             _as128(r.data, self.right.dtype))
        else:
            eq = l.data == r.data
        if _is_float(self.left.dtype):
            eq = eq | (torch.isnan(l.data) & torch.isnan(r.data))
        return DeviceColumn(self.dtype,
                            torch.where(lv & rv, eq, ~lv & ~rv), None)

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        lv = l.valid_mask()
        rv = r.valid_mask()
        with np.errstate(all="ignore"):
            if _is_float(self.left.dtype):
                eq = np.where(np.isnan(l.data) & np.isnan(r.data), True,
                              l.data == r.data)
            else:
                eq = np.asarray(l.data == r.data, dtype=bool)
        return HostCol(self.dtype, np.where(lv & rv, eq, ~lv & ~rv), None)


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

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype, ~c.data.astype(bool), c.validity)


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

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        lv, rv = l.valid_mask(), r.valid_mask()
        ld, rd = l.data.astype(bool), r.data.astype(bool)
        validity = (lv & rv) | (lv & ~ld) | (rv & ~rd)
        return HostCol(self.dtype, ld & rd & validity, validity)


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

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        lv, rv = l.valid_mask(), r.valid_mask()
        ld, rd = l.data.astype(bool), r.data.astype(bool)
        validity = (lv & rv) | (lv & ld) | (rv & rd)
        return HostCol(self.dtype, (ld & lv) | (rd & rv), validity)


# ---------------------------------------------------------------------------
# null handling  [REF: nullExpressions.scala]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IsNull(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, ~c.valid_mask(), None)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype, ~c.valid_mask(), None)


@dataclasses.dataclass
class IsNotNull(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, c.valid_mask(), None)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype, c.valid_mask(), None)


@dataclasses.dataclass
class IsNaN(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype,
                            torch.isnan(c.data) & c.valid_mask(), None)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        return HostCol(self.dtype, np.isnan(c.data) & c.valid_mask(), None)


# ---------------------------------------------------------------------------
# conditionals  [REF: conditionalExpressions.scala :: GpuIf, GpuCaseWhen]
# ---------------------------------------------------------------------------

def device_select(cond: torch.Tensor, a: DeviceColumn, b: DeviceColumn,
                  dtype: T.DataType) -> DeviceColumn:
    """Row-wise ``a`` where ``cond`` else ``b`` (string-aware: byte
    matrices pad to the wider of the two).  Validity is the caller's."""
    if a.is_string or b.is_string:
        w = max(int(a.data.shape[1]), int(b.data.shape[1]))
        da = torch.nn.functional.pad(a.data, (0, w - a.data.shape[1]))
        db = torch.nn.functional.pad(b.data, (0, w - b.data.shape[1]))
        return DeviceColumn(dtype, torch.where(cond[:, None], da, db),
                            None, torch.where(cond, a.lengths, b.lengths))
    if a.data.dim() == 2:  # decimal128 (hi, lo) lanes
        return DeviceColumn(dtype, torch.where(cond[:, None], a.data,
                                               b.data))
    return DeviceColumn(dtype, torch.where(cond, a.data, b.data))


@dataclasses.dataclass
class Coalesce(Expression):
    """The first non-null of ``exprs`` per row (string-aware)."""

    exprs: List[Expression]

    @property
    def dtype(self):
        return self.exprs[0].dtype

    @property
    def children(self):
        return tuple(self.exprs)

    def eval(self, batch):
        cols = [e.eval(batch) for e in self.exprs]
        acc = cols[-1]
        validity = cols[-1].valid_mask()
        for c in reversed(cols[:-1]):
            cv = c.valid_mask()
            acc = device_select(cv, c, acc, self.dtype)
            validity = cv | validity
        return DeviceColumn(self.dtype, acc.data, validity, acc.lengths)

    def eval_cpu(self, batch):
        cols = [e.eval_cpu(batch) for e in self.exprs]
        data = cols[-1].data.copy()
        validity = cols[-1].valid_mask().copy()
        for c in reversed(cols[:-1]):
            cv = c.valid_mask()
            data = np.where(cv, c.data, data)
            validity = cv | validity
        return HostCol(self.dtype, data, validity)


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

    def eval_cpu(self, batch):
        p = self.pred.eval_cpu(batch)
        t = self.true_value.eval_cpu(batch)
        f = self.false_value.eval_cpu(batch)
        cond = p.data.astype(bool) & p.valid_mask()
        data = np.where(cond, t.data, f.data)
        validity = np.where(cond, t.valid_mask(), f.valid_mask())
        return HostCol(self.dtype, data, validity)


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
                torch.zeros_like(first.lengths) if first.is_string
                else None)
            validity = torch.zeros((batch.capacity,), dtype=torch.bool,
                                   device=batch.device)
        for pred, val in reversed(self.branches):
            p = pred.eval(batch)
            v = val.eval(batch)
            cond = p.data & p.valid_mask()
            acc = device_select(cond, v, acc, self.dtype)
            validity = torch.where(cond, v.valid_mask(), validity)
        return DeviceColumn(self.dtype, acc.data, validity, acc.lengths)

    def eval_cpu(self, batch):
        n = batch.num_rows
        if self.else_value is not None:
            e = self.else_value.eval_cpu(batch)
            data, validity = e.data.copy(), e.valid_mask().copy()
        else:
            first = self.branches[0][1].eval_cpu(batch)
            data = np.zeros_like(first.data)
            validity = np.zeros(n, bool)
        for pred, val in reversed(self.branches):
            p = pred.eval_cpu(batch)
            v = val.eval_cpu(batch)
            cond = p.data.astype(bool) & p.valid_mask()
            data = np.where(cond, v.data, data)
            validity = np.where(cond, v.valid_mask(), validity)
        return HostCol(self.dtype, data, validity)


# ---------------------------------------------------------------------------
# math  [REF: mathExpressions.scala]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _UnaryMath(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.DoubleType)

    @property
    def children(self):
        return (self.child,)

    def _op(self, a):
        raise NotImplementedError

    def _op_h(self, a):
        raise NotImplementedError

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, self._op(c.data), c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, self._op_h(c.data), c.validity)


def ieee_sqrt(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  torch's float64 ``sqrt`` on
    the CPU is not (its sqrt(0.5) is 1 ulp low), so a CPU tensor takes
    numpy's; CUDA's double ``sqrt`` is correctly rounded."""
    if a.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(a.numpy()))
    return torch.sqrt(a)


class Sqrt(_UnaryMath):
    def _op(self, a):
        return ieee_sqrt(a)

    def _op_h(self, a):
        return np.sqrt(a)


class Exp(_UnaryMath):
    def _op(self, a):
        return torch.exp(a)

    def _op_h(self, a):
        return np.exp(a)


@dataclasses.dataclass
class Log(Expression):
    """Spark ``ln``: null for x <= 0."""

    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.DoubleType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        bad = c.data <= 0.0
        data = torch.log(torch.where(bad, 1.0, c.data))
        return DeviceColumn(self.dtype, data,
                            merge_validity(c.validity, ~bad))

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        bad = c.data <= 0.0
        with np.errstate(all="ignore"):
            data = np.log(np.where(bad, 1.0, c.data))
        return HostCol(self.dtype, data, merge_validity_h(c.validity, ~bad))


@dataclasses.dataclass
class Pow(Expression):
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.DoubleType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        return DeviceColumn(self.dtype, torch.pow(l.data, r.data),
                            merge_validity(l.validity, r.validity))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, np.power(l.data, r.data),
                           merge_validity_h(l.validity, r.validity))


def _saturating_long(d: torch.Tensor) -> torch.Tensor:
    """An integral-valued float tensor -> int64 as the JAX package's
    device conversion gives it: NaN -> 0, values past the int64 range
    saturate.  Explicit, because a plain conversion's answer for those
    inputs depends on the device (torch on the CPU gives ``MIN`` for
    all of them)."""
    d = d.to(torch.float64)
    isn = torch.isnan(d)
    top = d >= float(_I64_MAX)  # the double 2^63
    bot = d < float(_I64_MIN)
    res = torch.where(isn | top | bot, 0.0, d).to(torch.int64)
    res = torch.where(top, _I64_MAX, res)
    return torch.where(bot, _I64_MIN, res)


@dataclasses.dataclass
class Floor(Expression):
    """Spark floor(double) -> long.  The device branch converts as the
    JAX package's ``eval_tpu`` does (``_saturating_long``); the host
    branch is its numpy ``eval_cpu``, whose conversion of NaN, the
    infinities and out-of-range values is numpy's."""

    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.LongType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, _saturating_long(torch.floor(c.data)),
                            c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, np.floor(c.data).astype(np.int64),
                           c.validity)


@dataclasses.dataclass
class Ceil(Expression):
    """Spark ceil(double) -> long, converted as ``Floor`` is."""

    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.LongType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        return DeviceColumn(self.dtype, _saturating_long(torch.ceil(c.data)),
                            c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, np.ceil(c.data).astype(np.int64),
                           c.validity)


@dataclasses.dataclass
class Round(Expression):
    """Spark ``round``: HALF_UP at the given scale, by hand on both
    branches.  The device branch's sign keeps a zero's sign, as
    ``jnp.sign`` does (``round(-0.0)`` is -0.0 there; the host branch's
    ``np.sign`` gives 0.0)."""

    child: Expression
    scale: int = 0

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        if not _is_float(self.dtype):
            return c
        m = 10.0 ** self.scale
        x = c.data
        sign = torch.where(x == 0.0, x, torch.sign(x))
        data = sign * torch.floor(torch.abs(x) * m + 0.5) / m
        data = torch.where(torch.isfinite(x), data, x)
        return DeviceColumn(self.dtype, data, c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        if not _is_float(self.dtype):
            return c
        m = 10.0 ** self.scale
        with np.errstate(all="ignore"):
            data = np.sign(c.data) * np.floor(np.abs(c.data) * m + 0.5) / m
            data = np.where(np.isfinite(c.data), data, c.data)
        return HostCol(self.dtype, data, c.validity)


# ---------------------------------------------------------------------------
# casts  [REF: GpuCast.scala]: numeric, boolean and string
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


def _string_castable(dt: T.DataType) -> bool:
    """The other side of a cast from or to a string that the port has."""
    return _castable(dt) or isinstance(
        dt, (T.StringType, T.DateType, T.TimestampType, T.DecimalType))


def _decimal_castable(src: T.DataType, dst: T.DataType) -> bool:
    """The casts with a decimal side that the port has: decimal or
    integral to decimal, and decimal to double."""
    if isinstance(dst, T.DecimalType):
        return isinstance(src, T.DecimalType) or T.is_integral(src)
    return isinstance(src, T.DecimalType) and isinstance(dst, T.DoubleType)


@dataclasses.dataclass
class Cast(Expression):
    """Java's casts among int, long, float, double and boolean: integral
    narrowing wraps, floating to integral maps NaN to 0, saturates at the
    type's bounds and truncates toward zero, anything to boolean is
    ``!= 0``.  Casts from or to a string run on the device where
    ``device_support_reason`` allows (integral and boolean both ways,
    string to floating under ``castStringToFloat``) through
    ``ops/strings.py``'s device casts, and on the host otherwise, with
    the JAX package's host semantics.  A decimal or an integral casts to
    a decimal through the 128-bit container (HALF_UP rescale, overflow
    to null) and a decimal to a double on the device; strings cast to
    and from decimals on the host.  Other casts with a decimal side, and
    those between dates or timestamps and numbers, are not ported and
    raise when built."""

    ansi_sensitive = True
    child: Expression
    dtype: T.DataType

    def __post_init__(self):
        src, dst = self.child.dtype, self.dtype
        stringy = isinstance(src, T.StringType) or isinstance(
            dst, T.StringType)
        if not ((_castable(src) and _castable(dst))
                or _decimal_castable(src, dst) or (
                stringy and _string_castable(src)
                and _string_castable(dst))):
            raise NotImplementedError(
                f"spark_rapids_tpu_torch: Cast({self.child} as "
                f"{dst.simple_name}) from {src.simple_name} is not "
                "ported yet")

    @property
    def children(self):
        return (self.child,)

    def device_support_reason(self, conf):
        """Per-combination device support (the tagging hook); None = ok.
        The JAX package's reasons, word for word."""
        from spark_rapids_tpu_torch import conf as C
        src, dst = self.child.dtype, self.dtype
        if self._decimal_combo() is not None:
            if isinstance(dst, T.DecimalType):
                down = (src.scale - dst.scale
                        if isinstance(src, T.DecimalType) else -1)
                if down > 9:
                    return ("decimal scale-down beyond 10^9 not on "
                            "device (single-step rounded division cap)")
                if (isinstance(src, T.DecimalType)
                        or T.is_integral(src)):
                    return None
                return (f"cast {src.simple_name}→{dst.simple_name} "
                        "not yet on device")
            if isinstance(dst, T.DoubleType):
                return None
            return (f"cast {src.simple_name}→{dst.simple_name} not "
                    "yet on device")
        src_s = isinstance(src, T.StringType)
        dst_s = isinstance(dst, T.StringType)
        if not (src_s or dst_s):
            return None
        if src_s and (T.is_integral(dst) or isinstance(dst, T.BooleanType)):
            return None
        if src_s and isinstance(dst, (T.FloatType, T.DoubleType)):
            if conf.get(C.CAST_STRING_TO_FLOAT):
                return None
            return ("cast string→floating can differ from Java by 1 ulp "
                    "beyond 15 significant digits; set spark.rapids.sql."
                    "castStringToFloat.enabled=true to run on device")
        if dst_s and (T.is_integral(src) or isinstance(src, T.BooleanType)):
            return None
        if dst_s and isinstance(src, (T.FloatType, T.DoubleType)):
            return ("cast floating→string not on device (Java "
                    "shortest-round-trip formatting)")
        return (f"cast {src.simple_name}→{dst.simple_name} not yet on "
                "device")

    def _decimal_combo(self):
        """A non-string cast with a decimal side, else None (string <->
        decimal takes the string paths)."""
        src, dst = self.child.dtype, self.dtype
        if isinstance(src, T.StringType) or isinstance(dst, T.StringType):
            return None
        if not (isinstance(src, T.DecimalType)
                or isinstance(dst, T.DecimalType)):
            return None
        return (src, dst)

    def _cast_decimal(self, c: DeviceColumn) -> DeviceColumn:
        src, dst = self.child.dtype, self.dtype
        if isinstance(dst, T.DecimalType):
            # EVERY cast to a decimal runs through the 128-bit container:
            # the rescale cannot wrap int64, and the overflow-to-null
            # check applies uniformly (Spark non-ANSI)
            if isinstance(src, T.DecimalType):
                k = dst.scale - src.scale
                d = _as128(c.data, src)
                if k >= 0:
                    # checked: overflow decided BEFORE the multiply
                    d, fits = D128.scale_up_checked(d, k, dst.precision)
                else:
                    d = D128.scale_down_round(d, -k)
                    fits = D128.fits_precision(d, dst.precision)
            else:
                d, fits = D128.scale_up_checked(
                    D128.from_i64(c.data), dst.scale, dst.precision)
            if not D128.is128(dst):
                d = D128.lo(d)
            return DeviceColumn(dst, d, merge_validity(c.validity, fits))
        # a decimal to a double
        if D128.is128(src):
            return DeviceColumn(dst, D128.to_double(c.data, src.scale),
                                c.validity)
        return DeviceColumn(dst, c.data.to(torch.float64)
                            / (10.0 ** src.scale), c.validity)

    def _cast_decimal_cpu(self, c: HostCol) -> HostCol:
        """The JAX package's host decimal casts: exact python ints."""
        src, dst = self.child.dtype, self.dtype
        n = len(c.data)
        if isinstance(dst, T.DecimalType):
            k = (dst.scale - src.scale
                 if isinstance(src, T.DecimalType) else dst.scale)
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = D128.py_rescale_half_up(int(c.data[i]), k)
            bound = 10 ** dst.precision
            fits = np.array([abs(int(v)) < bound for v in out], bool)
            # overflowed rows are null: zero their payload so that the
            # int64 narrowing (or the 16-byte Arrow value) cannot raise
            out[~fits] = 0
            if not D128.is128(dst):
                out = out.astype(np.int64)
            return HostCol(dst, out, merge_validity_h(c.validity, fits))
        out = np.array([int(v) / (10.0 ** src.scale) for v in c.data],
                       dtype=np.float64)
        return HostCol(dst, out, c.validity)

    def eval(self, batch):
        from spark_rapids_tpu_torch.ops import strings as S
        c = self.child.eval(batch)
        src, dst = self.child.dtype, self.dtype
        if self._decimal_combo() is not None:
            return self._cast_decimal(c)
        if isinstance(dst, T.StringType):
            if isinstance(src, T.BooleanType):
                return S.cast_bool_to_string_device(c)
            if T.is_integral(src):
                return S.cast_int_to_string_device(c)
            raise NotImplementedError(f"cast {src}→string on device")
        if isinstance(src, T.StringType):
            if isinstance(dst, T.BooleanType):
                return S.cast_string_to_bool_device(c)
            if T.is_integral(dst):
                return S.cast_string_to_int_device(c, dst)
            if isinstance(dst, (T.FloatType, T.DoubleType)):
                return S.cast_string_to_float_device(c, dst)
            raise NotImplementedError(f"cast string→{dst} on device")
        return DeviceColumn(self.dtype, self._cast(c.data), c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        if self._decimal_combo() is not None:
            return self._cast_decimal_cpu(c)
        if isinstance(self.child.dtype, T.StringType) or isinstance(
                self.dtype, T.StringType):
            return self._cast_string_cpu(c)
        with np.errstate(all="ignore"):
            return HostCol(self.dtype, self._cast_h(c.data), c.validity)

    def _cast_string_cpu(self, c: HostCol) -> HostCol:
        """The JAX package's host string casts: a date or timestamp
        becomes the string of its int32 days or int64 microseconds, and a
        string parses into one as a number (its ``_cast_string_cpu``,
        kept bit for bit)."""
        src, dst = self.child.dtype, self.dtype
        n = len(c.data)
        if isinstance(dst, T.StringType):
            out = np.empty(n, object)
            for i in range(n):
                v = c.data[i]
                if isinstance(src, T.BooleanType):
                    out[i] = "true" if v else "false"
                elif isinstance(src, (T.FloatType, T.DoubleType)):
                    out[i] = repr(float(v))
                elif isinstance(src, T.DecimalType):
                    u = int(v)
                    sc = src.scale
                    sign = "-" if u < 0 else ""
                    m = str(abs(u))
                    if sc == 0:
                        out[i] = sign + m
                    else:
                        m = m.rjust(sc + 1, "0")
                        out[i] = sign + m[:-sc] + "." + m[-sc:]
                else:
                    out[i] = str(v)
            return HostCol(dst, out, c.validity)
        if isinstance(dst, T.DecimalType):
            return self._parse_decimal_cpu(c)
        # string -> numeric: invalid -> null (non-ANSI).  Integral casts
        # accept decimal strings truncated toward zero ('3.7' -> 3) and
        # null out-of-range values, matching Spark (and the device casts
        # in ops/strings.py).
        import re as _re
        data = np.zeros(n, T.to_numpy_dtype(dst))
        validity = c.valid_mask().copy()
        int_pat = _re.compile(r"^([+-]?)(\d*)(?:\.(\d*))?$")
        lo_hi = _INT_RANGES.get(type(dst))
        if isinstance(dst, T.BooleanType):
            for i in range(n):
                if not validity[i]:
                    continue
                s = str(c.data[i]).strip().lower()
                if s in ("true", "t", "yes", "y", "1"):
                    data[i] = True
                elif s in ("false", "f", "no", "n", "0"):
                    data[i] = False
                else:
                    validity[i] = False
            return HostCol(dst, data, validity)
        for i in range(n):
            if not validity[i]:
                continue
            s = str(c.data[i]).strip()
            try:
                if T.is_integral(dst):
                    m = int_pat.match(s)
                    if (not m or not (m.group(2) or m.group(3))):
                        validity[i] = False
                        continue
                    v = int(m.group(2) or "0")
                    if m.group(1) == "-":
                        v = -v
                    if not (lo_hi[0] <= v <= lo_hi[1]):
                        validity[i] = False
                        continue
                    data[i] = v
                else:
                    if "_" in s:  # Python float() accepts these; Java no
                        validity[i] = False
                        continue
                    data[i] = float(s)
            except (ValueError, OverflowError):
                validity[i] = False
        return HostCol(dst, data, validity)

    def _parse_decimal_cpu(self, c: HostCol) -> HostCol:
        """string -> decimal: an exact parse, HALF_UP to the target
        scale, overflow and invalid input to null (non-ANSI)."""
        import decimal
        dst = self.dtype
        n = len(c.data)
        big = D128.is128(dst)
        out = np.empty(n, object) if big else np.zeros(n, np.int64)
        validity = c.valid_mask().copy()
        for i in range(n):
            u = 0
            if validity[i]:
                try:
                    dec = decimal.Decimal(str(c.data[i]).strip())
                    if not dec.is_finite():
                        raise decimal.InvalidOperation
                    u = D128.py_unscaled(dec, dst.scale)
                    if not D128.py_fits(u, dst.precision):
                        validity[i] = False
                        u = 0
                except decimal.InvalidOperation:
                    validity[i] = False
            out[i] = u
        return HostCol(dst, out, validity)

    def _cast_h(self, data: np.ndarray) -> np.ndarray:
        """The JAX package's numpy ``_cast``."""
        src, dst = self.child.dtype, self.dtype
        npdt = T.to_numpy_dtype(dst)
        if isinstance(dst, T.BooleanType):
            return data != 0
        if isinstance(src, T.BooleanType):
            return data.astype(npdt)
        if _is_float(src) and T.is_integral(dst):
            # java (T) cast: NaN -> 0, saturate at bounds, truncate to 0
            lo, hi = _INT_RANGES[type(dst)]
            d = np.where(np.isnan(data), 0.0, data)
            d = np.clip(d, lo, hi)
            return np.trunc(d).astype(npdt)
        return data.astype(npdt)  # java narrowing wraps

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


@dataclasses.dataclass
class InputFileName(Expression):
    """Marker for input_file_name(): the optimizer rewrites it to a
    BoundReference over the file scan's appended file-name column
    [REF: GpuFileSourceScanExec.scala :: InputFileName handling]."""

    dtype: T.DataType = dataclasses.field(
        default_factory=lambda: T.StringT)

    def eval(self, batch):
        raise RuntimeError(
            "input_file_name() was not bound to a file scan — it is only "
            "valid directly above a file source")

    eval_cpu = eval

    def __str__(self):
        return "input_file_name()"


@dataclasses.dataclass
class DeviceUDF(Expression):
    """A user function over the argument columns' raw tensors, run on the
    batch's device with the surrounding expressions [REF: spark-rapids
    RapidsUDF — there a JNI hook handing the user cuDF columns].

    Contract: ``fn(*tensors) -> tensor`` is pure and shape-preserving
    torch; the result goes through ``torch.as_tensor(...).to(dtype)``;
    nulls propagate as the intersection of the inputs' validities
    (Spark's null-safe semantics); numeric, boolean and datetime
    columns only (strings ride byte matrices whose layout is not a
    stable public surface).  ``eval_cpu`` runs the same ``fn`` on CPU
    tensors made from the host arrays: the oracle of the device run."""

    fn: object
    args: Tuple[Expression, ...]
    dtype: T.DataType
    fname: str = "device_udf"

    type_sig = SIG_ALL_SCALAR - SIG_STRINGY | frozenset({"null"})
    input_sig = SIG_ALL_SCALAR - SIG_STRINGY | frozenset({"null"})

    @property
    def children(self):
        return tuple(self.args)

    def eval(self, batch: DeviceBatch) -> DeviceColumn:
        cols = [a.eval(batch) for a in self.args]
        out = self.fn(*[c.data for c in cols])
        out = torch.as_tensor(out, device=batch.device).to(
            torch_dtype(self.dtype))
        return DeviceColumn(self.dtype, out,
                            merge_validity(*[c.validity for c in cols]))

    def eval_cpu(self, batch: HostBatch) -> HostCol:
        cols = [a.eval_cpu(batch) for a in self.args]
        # owned copies: the host arrays may be read-only Arrow buffers
        out = self.fn(*[torch.from_numpy(np.array(c.data)) for c in cols])
        out = torch.as_tensor(out).to(torch_dtype(self.dtype))
        return HostCol(self.dtype, out.numpy(),
                       merge_validity_h(*[c.validity for c in cols]))

    def __str__(self):
        args = ", ".join(str(a) for a in self.args)
        return f"{self.fname}({args})"


# ---------------------------------------------------------------------------
# TypeSig declarations [REF: TypeChecks.scala — per-op type signatures],
# the JAX package's for the classes this port has.
# ---------------------------------------------------------------------------

for _cls in (Add, Subtract, Multiply, Divide, IntegralDivide, Remainder,
             UnaryMinus, Abs, Round):
    _cls.type_sig = SIG_NUMERIC
for _cls in (Sqrt, Exp, Log, Pow):
    _cls.type_sig = SIG_FLOATING
    _cls.input_sig = SIG_NUMERIC
for _cls in (Floor, Ceil):
    _cls.type_sig = SIG_NUMERIC
for _cls in (EqualTo, LessThan, LessThanOrEqual, GreaterThan,
             GreaterThanOrEqual, EqualNullSafe):
    _cls.type_sig = SIG_BOOLEAN
    _cls.input_sig = SIG_ALL_SCALAR
for _cls in (Not, And, Or):
    _cls.type_sig = SIG_BOOLEAN
for _cls in (IsNull, IsNotNull):
    _cls.type_sig = SIG_BOOLEAN
    _cls.input_sig = SIG_ALL_SCALAR | frozenset({"array"})
IsNaN.type_sig = SIG_BOOLEAN
IsNaN.input_sig = SIG_FLOATING
# column pass-through carries everything a batch can hold
BoundReference.type_sig = SIG_ALL
