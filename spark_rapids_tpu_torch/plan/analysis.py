"""Name resolution and implicit type coercion (the analyzer) — the subset
of the port.

The counterpart of the JAX package's ``plan/analysis.py``: unresolved
``sql.column.UExpr`` trees become bound, typed ``ops.expressions``
nodes against a schema, with Spark's implicit-cast rules (widest
numeric type for binary ops, comparison operands, CASE branches and
``coalesce`` arguments unified, both sides of a division cast to
double, the math functions' inputs too; literal widenings fold into a
new literal, a column's widening is a ``Cast``), the arithmetic, null,
math and date expressions, the two hashes, the time-zone conversions
(``ops/timezone.py``), and the string expressions of ``ops/strings.py``:
LIKE, substring, the predicates, length, the case maps, trim, replace,
locate, concat, reverse, the pads and the regular expressions
(``rlike`` transpiles a simple pattern to a comparison or predicate
first), ``split`` and ``get_json_object`` (``ops/json_ops.py``), both
host-only as in the JAX package.  Decimals follow Spark's result types
(non-ANSI; a result past precision 38 is refused rather than
scale-adjusted): add and subtract widen to the common type plus one
digit, multiply to p1 + p2 + 1 digits at scale s1 + s2; other decimal
arithmetic is refused.  Struct field access (``getField``), ``struct``
and the generators are the DataFrame layer's: the analyzer meets them
only outside a select, and refuses them as the JAX package's does; so
is a window function, which ``resolve_window`` resolves with its spec
and frame when it stands under ``.over`` at a select's top level, and
so is a python UDF, which the DataFrame layer lifts into a
``PythonEval`` node when it is a top-level select expression.
``input_file_name()`` resolves to a marker the optimizer binds to a
file scan's file-name column, and ``device_udf`` to a ``DeviceUDF``
over numeric, boolean and datetime arguments.  An
operator outside the port raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import datetime
import decimal
import re
from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import datetime_ops as D
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import hashing as HS
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
    if isinstance(v, decimal.Decimal):
        sign, digits, exp = v.as_tuple()
        scale = -exp if exp < 0 else 0
        return T.DecimalType(max(len(digits), scale), scale)
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
    if isinstance(a, T.DoubleType) or isinstance(b, T.DoubleType):
        if T.is_numeric(a) and T.is_numeric(b):
            return T.DoubleT
    if isinstance(a, T.FloatType) or isinstance(b, T.FloatType):
        if T.is_numeric(a) and T.is_numeric(b):
            return T.FloatT
    if T.is_integral(a) and T.is_integral(b):
        ia, ib = _INT_ORDER.index(type(a)), _INT_ORDER.index(type(b))
        return a if ia >= ib else b
    if isinstance(a, T.DecimalType) and T.is_integral(b):
        return a
    if T.is_integral(a) and isinstance(b, T.DecimalType):
        return b
    if isinstance(a, T.DecimalType) and isinstance(b, T.DecimalType):
        # widest: keep every integer digit and every fraction digit
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return T.DecimalType(min(intd + scale, 38), scale)
    if isinstance(a, T.DateType) and isinstance(b, T.TimestampType):
        return b
    if isinstance(a, T.TimestampType) and isinstance(b, T.DateType):
        return a
    raise AnalysisException(f"incompatible types: {a} vs {b}")


def cast_to(e: E.Expression, dt: T.DataType) -> E.Expression:
    """Literal widenings fold into a new literal (as the JAX analyzer
    does); anything else becomes a ``Cast``, which raises for the casts
    the port lacks (dates and timestamps to and from numbers, a
    floating value to a decimal)."""
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
    return E.Cast(e, dt)


def _coerce_pair(l: E.Expression, r: E.Expression):
    ct = common_type(l.dtype, r.dtype)
    return cast_to(l, ct), cast_to(r, ct)


_BIN_ARITH = {"add": E.Add, "sub": E.Subtract, "mul": E.Multiply,
              "mod": E.Remainder}
_BIN_CMP = {"eq": E.EqualTo, "lt": E.LessThan, "le": E.LessThanOrEqual,
            "gt": E.GreaterThan, "ge": E.GreaterThanOrEqual,
            "eqns": E.EqualNullSafe}
_UNARY = {"not": E.Not, "neg": E.UnaryMinus, "abs": E.Abs,
          "isnull": E.IsNull, "isnotnull": E.IsNotNull, "isnan": E.IsNaN}
_UNARY_MATH = {"sqrt": E.Sqrt, "exp": E.Exp, "log": E.Log,
               "floor": E.Floor, "ceil": E.Ceil}
_DATE_FIELD = {"year": D.Year, "month": D.Month, "dayofmonth": D.DayOfMonth}
_DATE_BINARY = {"date_add": D.DateAdd, "date_sub": D.DateSub,
                "datediff": D.DateDiff}
_HASHES = {"hash": HS.Murmur3Hash, "xxhash64": HS.XxHash64}
_TYPE_NAMES = {"int": T.IntegerT, "integer": T.IntegerT, "long": T.LongT,
               "bigint": T.LongT, "short": T.ShortT, "byte": T.ByteT,
               "float": T.FloatT, "double": T.DoubleT,
               "string": T.StringT, "boolean": T.BooleanT,
               "date": T.DateT, "timestamp": T.TimestampT}


def _parse_type(s) -> T.DataType:
    if isinstance(s, T.DataType):
        return s
    key = str(s).strip().lower()
    dm = re.fullmatch(r"decimal\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)", key)
    if dm:
        p, sc = int(dm.group(1)), int(dm.group(2))
        if not (0 < p <= 38 and 0 <= sc <= p):
            raise AnalysisException(f"invalid decimal type {s!r}")
        return T.DecimalType(p, sc)
    if key not in _TYPE_NAMES:
        raise _not_ported(f"cast to type {s!r}")
    return _TYPE_NAMES[key]


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
        if (isinstance(l.dtype, T.DecimalType)
                and isinstance(r.dtype, T.DecimalType)):
            return _decimal_arith(op, l, r)
        l, r = _coerce_pair(l, r)
        return _BIN_ARITH[op](l, r)
    if op == "div":
        l = resolve(u.children[0], schema)
        r = resolve(u.children[1], schema)
        return E.Divide(cast_to(l, T.DoubleT), cast_to(r, T.DoubleT))
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
    if op in _UNARY:
        return _UNARY[op](resolve(u.children[0], schema))
    if op == "coalesce":
        exprs = [resolve(c, schema) for c in u.children]
        ct = exprs[0].dtype
        for e in exprs[1:]:
            ct = common_type(ct, e.dtype)
        return E.Coalesce([cast_to(e, ct) for e in exprs])
    if op in _UNARY_MATH:
        c = cast_to(resolve(u.children[0], schema), T.DoubleT)
        return _UNARY_MATH[op](c)
    if op == "round":
        return E.Round(resolve(u.children[0], schema), u.payload)
    if op == "pow":
        return E.Pow(cast_to(resolve(u.children[0], schema), T.DoubleT),
                     cast_to(resolve(u.children[1], schema), T.DoubleT))
    if op in _DATE_BINARY:
        return _DATE_BINARY[op](resolve(u.children[0], schema),
                                resolve(u.children[1], schema))
    if op in _HASHES:
        return _HASHES[op]([resolve(c, schema) for c in u.children])
    if op == "casewhen":
        kids = [resolve(c, schema) for c in u.children]
        has_else = len(kids) % 2 == 1
        pairs = [(kids[i], kids[i + 1]) for i in range(0, len(kids) - 1, 2)]
        else_v = kids[-1] if has_else else None
        ct = pairs[0][1].dtype
        for _, v in pairs[1:]:
            ct = common_type(ct, v.dtype)
        if else_v is not None:
            ct = common_type(ct, else_v.dtype)
            else_v = cast_to(else_v, ct)
        pairs = [(p, cast_to(v, ct)) for p, v in pairs]
        return E.CaseWhen(pairs, else_v)
    if op == "cast":
        return E.Cast(resolve(u.children[0], schema), _parse_type(u.payload))
    if op in _DATE_FIELD:
        return _DATE_FIELD[op](resolve(u.children[0], schema))
    if op == "like":
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.StringType):
            raise AnalysisException("like needs a string operand")
        return S.Like(child, u.payload)
    if op == "substring":
        pos, ln = u.payload
        return S.Substring(resolve(u.children[0], schema), pos, ln)
    if op in ("upper", "lower", "length"):
        return S.string_unary(op, resolve(u.children[0], schema))
    if op in ("trim", "ltrim", "rtrim"):
        side = {"trim": "both", "ltrim": "leading",
                "rtrim": "trailing"}[op]
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.StringType):
            raise AnalysisException(f"{op} needs a string operand")
        return S.Trim(child, side)
    if op == "replace":
        search, repl = u.payload
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.StringType):
            raise AnalysisException("replace needs a string operand")
        return S.StringReplace(child, search, repl)
    if op == "locate":
        substr = resolve(u.children[0], schema)
        child = resolve(u.children[1], schema)
        return S.StringLocate(substr, child, u.payload)
    if op == "rlike":
        return _rlike(resolve(u.children[0], schema), u.payload)
    if op == "regexp_extract":
        pattern, idx = u.payload
        S.check_regex_supported(pattern)
        return S.RegexpExtract(resolve(u.children[0], schema), pattern,
                               idx)
    if op == "regexp_replace":
        pattern, repl = u.payload
        S.check_regex_supported(pattern)
        return S.RegexpReplace(resolve(u.children[0], schema), pattern,
                               repl)
    if op == "split":
        pattern, limit = u.payload
        S.check_regex_supported(pattern)
        return S.Split(resolve(u.children[0], schema), pattern, limit)
    if op == "get_json_object":
        from spark_rapids_tpu_torch.ops.json_ops import GetJsonObject
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, (T.StringType, T.BinaryType)):
            raise AnalysisException(
                "get_json_object needs a string operand, got "
                f"{child.dtype.simple_name}")
        return GetJsonObject(child, str(u.payload))
    if op == "input_file_name":
        return E.InputFileName()
    if op == "device_udf":
        fn, dt, name = u.payload
        args = tuple(resolve(c, schema) for c in u.children)
        for a in args:
            if isinstance(a.dtype, (T.StringType, T.BinaryType)):
                raise AnalysisException(
                    "device_udf arguments must be numeric/boolean/"
                    f"datetime columns, got {a.dtype.simple_name} "
                    "(string byte-matrix layout is not a stable UDF "
                    "surface)")
        return E.DeviceUDF(fn, args, dt, name)
    if op == "pyudf":
        # the DataFrame layer extracts top-level UDFs into a PythonEval
        raise AnalysisException(
            "python UDFs are only supported as top-level select "
            "expressions (optionally aliased)")
    if op in ("getfield", "make_struct", "generate", "window", "winfn"):
        # the DataFrame layer rewrites these where it allows them (a
        # window function only under ``.over`` at a select's top level)
        raise AnalysisException(f"unknown expression op '{op}'")
    if op == "reverse":
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.StringType):
            raise AnalysisException("reverse needs a string operand")
        return S.StringReverse(child)
    if op in ("lpad", "rpad"):
        ln, pad = u.payload
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.StringType):
            raise AnalysisException(f"{op} needs a string operand")
        return S.StringPad(child, int(ln), str(pad), op == "lpad")
    if op in ("startswith", "endswith", "contains"):
        return S.string_predicate(op, resolve(u.children[0], schema),
                                  resolve(u.children[1], schema))
    if op == "concat":
        return S.Concat([resolve(c, schema) for c in u.children])
    if op in ("from_utc_timestamp", "to_utc_timestamp"):
        from spark_rapids_tpu_torch.ops import timezone as TZ
        child = resolve(u.children[0], schema)
        if not isinstance(child.dtype, T.TimestampType):
            child = cast_to(child, T.TimestampT)
        tz = str(u.payload)
        TZ.TZ_CACHE.host(tz)  # validates the zone eagerly
        cls = (TZ.FromUTCTimestamp if op == "from_utc_timestamp"
               else TZ.ToUTCTimestamp)
        return cls(child, tz)
    raise _not_ported(f"expression '{op}'")


def _decimal_arith(op: str, l: E.Expression, r: E.Expression
                   ) -> E.Expression:
    """Spark's decimal result types (non-ANSI; past precision 38 is
    refused rather than scale-adjusted)."""
    p1, s1 = l.dtype.precision, l.dtype.scale
    p2, s2 = r.dtype.precision, r.dtype.scale
    if op == "mul":
        rt = T.DecimalType(min(p1 + p2 + 1, 38), s1 + s2)
        if rt.scale > rt.precision:
            raise AnalysisException(
                f"decimal multiply result scale {rt.scale} exceeds "
                "precision 38")
        return E.Multiply(l, r, rt)
    if op in ("add", "sub"):
        ct = common_type(l.dtype, r.dtype)
        rt = T.DecimalType(min(ct.precision + 1, 38), ct.scale)
        return _BIN_ARITH[op](cast_to(l, ct), cast_to(r, ct), rt)
    raise AnalysisException(f"decimal '{op}' not supported")


def _rlike(child: E.Expression, pattern: str) -> E.Expression:
    """``rlike``: a simple pattern transpiles to the device predicates
    (the RegexParser fast path [REF: CudfRegexTranspiler]); only the
    rest becomes ``RLike``."""
    if not isinstance(child.dtype, T.StringType):
        raise AnalysisException("rlike needs a string operand")
    S.check_regex_supported(pattern)
    simple = S.regex_as_simple(pattern)
    if not simple:
        return S.RLike(child, pattern)
    kind, lit = simple

    def one(lit2):
        if kind == "eq":
            return S.string_comparison("eq", child,
                                       E.Literal(lit2, T.StringT))
        return S.string_predicate(kind, child, E.Literal(lit2, T.StringT))

    if kind not in ("eq", "endswith"):
        return one(lit)
    # Java's '$' (Pattern.find, no UNIX_LINES) also matches just before a
    # FINAL line terminator: "abc\n" rlike "abc$" is true, so OR in each
    # terminator variant
    out = one(lit)
    for term in ("\n", "\r\n", "\r", "\u0085", "\u2028", "\u2029"):
        out = E.Or(out, one(lit + term))
    return out


_AGG_MAP = {"sum": A.Sum, "min": A.Min, "max": A.Max, "count": A.Count,
            "avg": A.Average, "first": A.First,
            "var_samp": A.VarianceSamp, "var_pop": A.VariancePop,
            "stddev_samp": A.StddevSamp, "stddev_pop": A.StddevPop,
            "count_distinct": A.CountDistinct,
            "collect_list": A.CollectList, "collect_set": A.CollectSet}
_VARIANCE = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")


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
    args = ()
    if isinstance(kind, tuple):
        kind, args = kind[0], kind[1:]
    child = resolve(u.children[0], schema)
    if kind == "count_star":
        return A.CountStar(child), alias or "count(1)"
    if kind in ("percentile", "approx_percentile"):
        return _percentile(kind, args, child, u, alias)
    cls = _AGG_MAP.get(kind)
    if cls is None:
        raise _not_ported(f"aggregate '{kind}'")
    if kind in ("sum", "avg") + _VARIANCE and not T.is_numeric(
            child.dtype):
        raise AnalysisException(f"{kind} needs a numeric input, got "
                                f"{child.dtype}")
    if kind in ("avg",) + _VARIANCE or (
            kind == "sum" and isinstance(child.dtype, T.FloatType)):
        child = cast_to(child, T.DoubleT)
    fn = cls(child)
    if kind == "count_distinct":
        return fn, alias or f"count(DISTINCT {u.children[0]})"
    return fn, alias or f"{kind}({u.children[0]})"


def _percentile(kind: str, args, child: E.Expression, u: UExpr,
                alias: Optional[str]):
    """percentile / approx_percentile with the JAX package's argument
    checks: a decimal input's percentile is over its doubles, and its
    approx_percentile is refused."""
    if not T.is_numeric(child.dtype):
        raise AnalysisException(f"{kind} needs a numeric input")
    if isinstance(child.dtype, T.DecimalType):
        if kind == "approx_percentile":
            # the result type is the input type; the unscaled-int64
            # representation cannot round-trip through the kernel
            raise AnalysisException(
                "approx_percentile over decimal input is not supported "
                "(use percentile, which returns double)")
        child = cast_to(child, T.DoubleT)
    pct = float(args[0])
    if not 0.0 <= pct <= 1.0:
        raise AnalysisException(
            f"{kind} percentage must be in [0, 1], got {pct}")
    if kind == "percentile":
        fn = A.Percentile(child, pct)
    else:
        fn = A.ApproxPercentile(child, pct,
                                int(args[1]) if len(args) > 1 else 10000)
    return fn, alias or f"{kind}({u.children[0]}, {pct})"


_WINDOW_AGGS = ("sum", "min", "max", "count", "avg", "first")


def resolve_window(u: UExpr, schema: T.StructType):
    """Resolve a ``col.over(WindowSpec)`` expression, as the JAX
    package's ``resolve_window`` does.

    Returns (partition_by, order_by SortOrders, WindowFunctionSpec,
    default name).  [REF: GpuWindowExpression tagging]
    """
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.sql.window import Window

    spec = u.payload
    fu = u.children[0]
    pby = [resolve(p, schema) for p in spec.partition_by]
    orders = []
    for o in spec.order_by:
        asc, nf = True, True
        if o.op == "sortorder":
            d, n = o.payload
            asc, nf = d == "asc", n == "nulls_first"
            o = o.children[0]
        orders.append(L.SortOrder(resolve(o, schema), asc, nf))
    frame, frame_lo, frame_hi = _window_frame(spec.frame, orders, Window)

    if fu.op == "winfn":
        wf, name = _window_fn(fu, schema, orders, frame, L)
    elif fu.op == "agg":
        kind = fu.payload
        if kind == "count_star":
            child = resolve(UExpr("lit", 1), schema)
            kind = "count"
        else:
            child = resolve(fu.children[0], schema)
        if kind not in _WINDOW_AGGS:
            raise AnalysisException(
                f"unsupported window aggregate '{kind}'")
        if kind in ("sum", "avg") and not T.is_numeric(child.dtype):
            raise AnalysisException(
                f"{kind}() over window needs a numeric input, got "
                f"{child.dtype.simple_name}")
        if kind == "avg" or (kind == "sum"
                             and isinstance(child.dtype, T.FloatType)):
            child = cast_to(child, T.DoubleT)
        if kind == "count":
            dtype = T.LongT
        elif kind == "avg":
            dtype = T.DoubleT
        elif kind == "sum":
            dtype = A.Sum(child).result_dtype
        else:
            dtype = child.dtype
        wf = L.WindowFunctionSpec(kind, child, dtype, frame=frame,
                                  frame_lo=frame_lo, frame_hi=frame_hi)
        name = f"{kind}({fu.children[0] if fu.children else '1'})"
    else:
        raise AnalysisException(
            f"only window functions and aggregates may be used with "
            f".over(), got {fu}")
    return pby, orders, wf, f"{name} OVER (...)"


def _window_frame(spec_frame, orders, Window):
    """(frame kind, lo, hi) of a spec's frame: the JAX package's frames
    and refusals."""
    if spec_frame is None:
        return ("range_current" if orders else "partition"), 0, 0
    kind, lo, hi = spec_frame
    unb_lo = lo == Window.unboundedPreceding
    unb_hi = hi == Window.unboundedFollowing
    if kind == "rows" and unb_lo and hi == 0:
        return "rows_current", 0, 0
    if unb_lo and unb_hi:
        return "partition", 0, 0
    if kind == "rows" and lo <= hi:
        # a sliding frame (an unbounded end clamps to the partition's
        # edge in the exec); offsets capped past any batch, int32-safe
        cap = 1 << 30
        return "rows_bounded", max(int(lo), -cap), min(int(hi), cap)
    if kind == "range" and unb_lo and hi == 0:
        return "range_current", 0, 0
    if kind == "range" and lo <= hi:
        if not orders or len(orders) != 1:
            raise AnalysisException(
                "RANGE frame with offsets requires exactly one ORDER BY "
                "expression")
        okey = orders[0]
        if not (T.is_integral(okey.expr.dtype)
                or isinstance(okey.expr.dtype, T.DateType)):
            raise AnalysisException(
                "RANGE frame offsets need an integral or date ORDER BY "
                f"key, got {okey.expr.dtype.simple_name}")
        return ("range_bounded", None if unb_lo else int(lo),
                None if unb_hi else int(hi))
    raise AnalysisException(
        f"unsupported window frame {spec_frame} (supported: ROWS "
        "unboundedPreceding..currentRow, unbounded..unbounded, bounded "
        "rowsBetween(a, b), and rangeBetween over one integral/date "
        "ORDER BY key)")


def _window_fn(fu: UExpr, schema: T.StructType, orders, frame: str, L):
    """(WindowFunctionSpec, default name) of a ranking or offset
    function."""
    kind = fu.payload[0]
    if not orders:
        raise AnalysisException(f"{kind}() requires an ORDER BY spec")
    if kind in ("row_number", "rank", "dense_rank"):
        return (L.WindowFunctionSpec(kind, None, T.IntegerT, frame=frame),
                f"{kind}()")
    if kind in ("percent_rank", "cume_dist"):
        return (L.WindowFunctionSpec(kind, None, T.DoubleT, frame=frame),
                f"{kind}()")
    if kind == "ntile":
        n = int(fu.payload[1])
        if n <= 0:
            raise AnalysisException("ntile() needs a positive bucket count")
        return (L.WindowFunctionSpec(kind, None, T.IntegerT, offset=n,
                                     frame=frame), f"ntile({n})")
    # lag / lead
    child = resolve(fu.children[0], schema)
    offset = int(fu.payload[1])
    ignore_nulls = bool(fu.payload[2]) if len(fu.payload) > 2 else False
    # Spark's default name keeps the user's spelling, even when a
    # negative offset turns lag into lead below
    name = f"{kind}({fu.children[0]}, {fu.payload[1]})"
    if offset < 0:  # Spark: lag(-k) == lead(k) and the other way round
        kind = "lead" if kind == "lag" else "lag"
        offset = -offset
    return (L.WindowFunctionSpec(kind, child, child.dtype, offset=offset,
                                 frame=frame, ignore_nulls=ignore_nulls),
            name)
