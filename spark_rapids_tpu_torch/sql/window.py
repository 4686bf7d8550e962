"""pyspark.sql.window-compatible ``WindowSpec`` surface.

[REF: sql-plugin/../GpuWindowExec.scala — plan surface; the spec object
itself mirrors pyspark.sql.Window]

The counterpart of the JAX package's ``sql/window.py``: a ``WindowSpec``
holds the unresolved partition and order expressions and the frame
(``None`` is Spark's default: RANGE unbounded preceding to the current
row with an ORDER BY, the whole partition without one; else ``("rows",
lo, hi)`` or ``("range", lo, hi)``).  ``Column.over(spec)`` attaches it
to a window function or an aggregate; the analyzer resolves it
(``plan/analysis.py::resolve_window``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Tuple

from spark_rapids_tpu_torch.sql.column import UExpr, _to_uexpr


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    partition_by: Tuple[UExpr, ...] = ()
    order_by: Tuple[UExpr, ...] = ()
    frame: object = None

    def partitionBy(self, *cols) -> "WindowSpec":
        return dataclasses.replace(
            self, partition_by=self.partition_by + tuple(
                _col_u(c) for c in cols))

    def orderBy(self, *cols) -> "WindowSpec":
        return dataclasses.replace(
            self, order_by=self.order_by + tuple(_col_u(c) for c in cols))

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return dataclasses.replace(self, frame=("rows", start, end))

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        return dataclasses.replace(self, frame=("range", start, end))


def _col_u(c) -> UExpr:
    if isinstance(c, str):
        return UExpr("attr", c)
    return _to_uexpr(c)


class Window:
    """pyspark.sql.Window entry points."""

    unboundedPreceding = -sys.maxsize
    unboundedFollowing = sys.maxsize
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)
