"""User-facing Column API — unresolved expression trees.

The counterpart of the JAX package's ``sql/column.py``: operator
overloading builds an unresolved ``UExpr`` tree; the analyzer
(plan/analysis.py) resolves it against a schema.  The port has the
arithmetic (division included), comparison and boolean operators,
``alias``, ``cast``, ``between``, ``isin``, the ``when(...).otherwise(...)``
chain and sort direction; the analyzer raises on anything else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple


@dataclasses.dataclass
class UExpr:
    """Unresolved expression node: (op, payload, children)."""

    op: str
    payload: Any = None
    children: Tuple["UExpr", ...] = ()

    def __str__(self):
        if self.op == "attr":
            return str(self.payload)
        if self.op == "lit":
            return repr(self.payload)
        return f"{self.op}({', '.join(str(c) for c in self.children)})"


def _to_uexpr(v) -> UExpr:
    if isinstance(v, Column):
        return v._u
    if isinstance(v, UExpr):
        return v
    return UExpr("lit", v)


class Column:
    def __init__(self, u: UExpr):
        self._u = u

    def _bin(self, op, other, reverse=False):
        l, r = self._u, _to_uexpr(other)
        if reverse:
            l, r = r, l
        return Column(UExpr(op, None, (l, r)))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, True)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __rand__(self, o):
        return self._bin("and", o, True)

    def __or__(self, o):
        return self._bin("or", o)

    def __ror__(self, o):
        return self._bin("or", o, True)

    def __invert__(self):
        return Column(UExpr("not", None, (self._u,)))

    def alias(self, name: str) -> "Column":
        return Column(UExpr("alias", name, (self._u,)))

    def cast(self, dtype) -> "Column":
        return Column(UExpr("cast", dtype, (self._u,)))

    def between(self, low, high) -> "Column":
        return (self >= low) & (self <= high)

    def isin(self, *values) -> "Column":
        """Membership test [REF: Spark Column.isin], lowered as an OR
        chain of equalities (no ``In`` expression)."""
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        if not values:
            return lit(False)
        out = self == values[0]
        for v in values[1:]:
            out = out | (self == v)
        return out

    def when(self, cond: "Column", value) -> "Column":
        u = self._u
        if u.op != "casewhen" or u.payload == "closed":
            raise TypeError("when() only chains after functions.when(...) "
                            "and before otherwise()")
        return Column(UExpr("casewhen", u.payload,
                            u.children + (_to_uexpr(cond),
                                          _to_uexpr(value))))

    def otherwise(self, value) -> "Column":
        u = self._u
        if u.op != "casewhen" or u.payload == "closed":
            raise TypeError("otherwise() only follows when() and may "
                            "appear once")
        return Column(UExpr("casewhen", "closed",
                            u.children + (_to_uexpr(value),)))

    def asc(self) -> "Column":
        return Column(UExpr("sortorder", ("asc", "nulls_first"), (self._u,)))

    def desc(self) -> "Column":
        return Column(UExpr("sortorder", ("desc", "nulls_last"), (self._u,)))

    def __str__(self):
        return str(self._u)

    def __repr__(self):
        return f"Column<{self._u}>"

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise ValueError(
            "Cannot convert Column to bool: use '&' for 'and', '|' for "
            "'or', '~' for 'not' in DataFrame filter expressions.")


def col(name: str) -> Column:
    return Column(UExpr("attr", name))


def lit(value) -> Column:
    return Column(UExpr("lit", value))
