"""pyspark.sql.functions-compatible surface — the subset of the port
(``col``, ``lit``, ``when``, ``year``, the string functions, ``sum``,
``avg``, ``min``, ``max``, ``count``, ``countDistinct``), with the JAX
package's signatures."""

from __future__ import annotations

from spark_rapids_tpu_torch.sql.column import Column, UExpr, _to_uexpr, col, lit  # noqa: F401


def _cu(c) -> UExpr:
    """Function-argument conversion: bare strings are column names
    (pyspark.sql.functions semantics), everything else like _to_uexpr."""
    if isinstance(c, str):
        return UExpr("attr", c)
    return _to_uexpr(c)


def _agg(op):
    def fn(c) -> Column:
        return Column(UExpr("agg", op, (_cu(c),)))
    fn.__name__ = op
    return fn


sum = _agg("sum")  # noqa: A001
min = _agg("min")  # noqa: A001
max = _agg("max")  # noqa: A001
avg = _agg("avg")


def count(c) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(UExpr("agg", "count_star", (UExpr("lit", 1),)))
    return Column(UExpr("agg", "count", (_cu(c),)))


def countDistinct(c) -> Column:
    return Column(UExpr("agg", "count_distinct", (_cu(c),)))


def when(cond: Column, value) -> Column:
    return Column(UExpr("casewhen", None,
                        (_to_uexpr(cond), _to_uexpr(value))))


def _unary(op):
    def fn(c) -> Column:
        return Column(UExpr(op, None, (_cu(c),)))
    fn.__name__ = op
    return fn


year = _unary("year")
upper = _unary("upper")
lower = _unary("lower")
length = _unary("length")
trim = _unary("trim")
ltrim = _unary("ltrim")
rtrim = _unary("rtrim")
reverse = _unary("reverse")


def substring(c, pos, length) -> Column:
    return Column(UExpr("substring", (pos, length), (_cu(c),)))


def concat(*cols) -> Column:
    return Column(UExpr("concat", None, tuple(_cu(c) for c in cols)))


def rlike(c, pattern: str) -> Column:
    return Column(UExpr("rlike", pattern, (_cu(c),)))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    return Column(UExpr("regexp_extract", (pattern, idx), (_cu(c),)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return Column(UExpr("regexp_replace", (pattern, replacement),
                        (_cu(c),)))


def lpad(c, length: int, pad: str = " ") -> Column:
    return Column(UExpr("lpad", (length, pad), (_cu(c),)))


def rpad(c, length: int, pad: str = " ") -> Column:
    return Column(UExpr("rpad", (length, pad), (_cu(c),)))


def replace(c, search: str, replacement: str) -> Column:
    """replace(str, search, replace) with a literal search and
    replacement."""
    return Column(UExpr("replace", (search, replacement), (_cu(c),)))


def instr(c, substr: str) -> Column:
    """1-based position of the first occurrence; 0 if absent."""
    return Column(UExpr("locate", 1, (UExpr("lit", substr), _cu(c))))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(UExpr("locate", pos, (UExpr("lit", substr), _cu(c))))
