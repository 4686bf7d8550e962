"""pyspark.sql.functions-compatible surface — the subset of the ported
TPC-H queries (``col``, ``lit``, ``when``, ``year``, ``substring``,
``sum``, ``avg``, ``min``, ``max``, ``count``, ``countDistinct``)."""

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


def year(c) -> Column:
    return Column(UExpr("year", None, (_cu(c),)))


def substring(c, pos, length) -> Column:
    return Column(UExpr("substring", (pos, length), (_cu(c),)))
