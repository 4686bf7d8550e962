"""Name resolution and implicit type coercion (the analyzer) — the subset
of TPC-H q1, q3, q4 and q6.

The counterpart of the JAX package's ``plan/analysis.py``: unresolved
``sql.column.UExpr`` trees become bound, typed ``ops.expressions``
nodes against a schema, with Spark's implicit-cast rules (widest
numeric type for binary ops, comparison operands unified, literal
widenings folded).  An operator outside this slice raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.sql.column import UExpr


class AnalysisException(Exception):
    pass


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"spark_rapids_tpu_torch: {what} is not ported yet")


def infer_literal_type(v) -> T.DataType:
    if v is None:
        return T.NullT
    if isinstance(v, bool):
        return T.BooleanT
    if isinstance(v, int):
        return T.IntegerT if -(1 << 31) <= v < (1 << 31) else T.LongT
    if isinstance(v, float):
        return T.DoubleT
    if isinstance(v, str):
        return T.StringT
    if isinstance(v, datetime.datetime):
        return T.TimestampT
    if isinstance(v, datetime.date):
        return T.DateT
    raise _not_ported(f"literal {v!r} of type {type(v).__name__}")


def literal(v) -> E.Literal:
    dt = infer_literal_type(v)
    if isinstance(dt, T.TimestampType):
        epoch = datetime.datetime(1970, 1, 1,
                                  tzinfo=datetime.timezone.utc)
        vv = v if v.tzinfo else v.replace(tzinfo=datetime.timezone.utc)
        v = int((vv - epoch).total_seconds() * 1_000_000)
    elif isinstance(dt, T.DateType):
        v = (v - datetime.date(1970, 1, 1)).days
    return E.Literal(v, dt)


_INT_ORDER = [T.ByteType, T.ShortType, T.IntegerType, T.LongType]


def common_type(a: T.DataType, b: T.DataType) -> T.DataType:
    if a == b:
        return a
    if isinstance(a, T.NullType):
        return b
    if isinstance(b, T.NullType):
        return a
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        raise _not_ported("decimal arithmetic")
    if isinstance(a, T.DoubleType) or isinstance(b, T.DoubleType):
        if T.is_numeric(a) and T.is_numeric(b):
            return T.DoubleT
    if isinstance(a, T.FloatType) or isinstance(b, T.FloatType):
        if T.is_numeric(a) and T.is_numeric(b):
            return T.FloatT
    if T.is_integral(a) and T.is_integral(b):
        ia, ib = _INT_ORDER.index(type(a)), _INT_ORDER.index(type(b))
        return a if ia >= ib else b
    if isinstance(a, T.DateType) and isinstance(b, T.TimestampType):
        return b
    if isinstance(a, T.TimestampType) and isinstance(b, T.DateType):
        return a
    raise AnalysisException(f"incompatible types: {a} vs {b}")


def cast_to(e: E.Expression, dt: T.DataType) -> E.Expression:
    """Literal widenings fold into a new literal (as the JAX analyzer
    does); a cast of a column is not ported yet."""
    if e.dtype == dt:
        return e
    if isinstance(e, E.Literal):
        if e.value is None:
            return E.Literal(None, dt)
        v = e.value
        if not isinstance(v, bool):
            if T.is_integral(dt) and isinstance(v, int):
                return E.Literal(v, dt)
            if isinstance(dt, (T.DoubleType, T.FloatType)) and isinstance(
                    v, (int, float)):
                return E.Literal(float(v), dt)
    raise _not_ported(f"Cast({e} as {dt})")


def _coerce_pair(l: E.Expression, r: E.Expression):
    ct = common_type(l.dtype, r.dtype)
    return cast_to(l, ct), cast_to(r, ct)


_BIN_ARITH = {"add": E.Add, "sub": E.Subtract, "mul": E.Multiply}
_BIN_CMP = {"eq": E.EqualTo, "lt": E.LessThan, "le": E.LessThanOrEqual,
            "gt": E.GreaterThan, "ge": E.GreaterThanOrEqual}


def resolve(u: UExpr, schema: T.StructType) -> E.Expression:
    op = u.op
    if op == "attr":
        name = u.payload
        try:
            idx = schema.field_index(name)
        except KeyError:
            raise AnalysisException(
                f"cannot resolve column '{name}' among "
                f"{schema.field_names()}")
        f = schema.fields[idx]
        return E.BoundReference(idx, f.dtype, f.nullable)
    if op == "lit":
        return literal(u.payload)
    if op == "alias":
        return E.Alias(resolve(u.children[0], schema), u.payload)
    if op in _BIN_ARITH:
        l = resolve(u.children[0], schema)
        r = resolve(u.children[1], schema)
        for side in (l, r):
            if not T.is_numeric(side.dtype):
                raise AnalysisException(f"'{op}' needs numeric operands, "
                                        f"got {side.dtype}")
        l, r = _coerce_pair(l, r)
        return _BIN_ARITH[op](l, r)
    if op in _BIN_CMP:
        l = resolve(u.children[0], schema)
        r = resolve(u.children[1], schema)
        l, r = _coerce_pair(l, r)
        if isinstance(l.dtype, T.StringType):
            return S.string_comparison(op, l, r)
        return _BIN_CMP[op](l, r)
    if op in ("and", "or"):
        l = resolve(u.children[0], schema)
        r = resolve(u.children[1], schema)
        for side in (l, r):
            if not isinstance(side.dtype, (T.BooleanType, T.NullType)):
                raise AnalysisException(f"'{op}' needs boolean operands, "
                                        f"got {side.dtype}")
        cls = E.And if op == "and" else E.Or
        return cls(cast_to(l, T.BooleanT), cast_to(r, T.BooleanT))
    if op == "not":
        return E.Not(resolve(u.children[0], schema))
    raise _not_ported(f"expression '{op}'")


_AGG_MAP = {"sum": A.Sum, "avg": A.Average, "count": A.Count}


def resolve_aggregate(u: UExpr, schema: T.StructType
                      ) -> Tuple[A.AggregateFunction, Optional[str]]:
    """Resolve an agg expression (optionally aliased).  Returns (fn, name)."""
    alias = None
    if u.op == "alias":
        alias = u.payload
        u = u.children[0]
    if u.op != "agg":
        raise AnalysisException(
            f"agg() expects aggregate expressions, got {u}")
    kind = u.payload
    child = resolve(u.children[0], schema)
    if kind == "count_star":
        return A.CountStar(child), alias or "count(1)"
    cls = _AGG_MAP.get(kind)
    if cls is None:
        raise _not_ported(f"aggregate '{kind}'")
    if kind == "avg":
        child = cast_to(child, T.DoubleT)
    if kind in ("sum", "avg") and not T.is_numeric(child.dtype):
        raise AnalysisException(f"{kind} needs a numeric input, got "
                                f"{child.dtype}")
    return cls(child), alias or f"{kind}({u.children[0]})"
