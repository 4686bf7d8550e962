"""Aggregate functions with Spark result-type and null semantics — the
subset of the ported TPC-H queries (``Sum``, ``Min``, ``Max``,
``Count``, ``CountStar``, ``Average``, and ``CountDistinct``, which the
DataFrame API rewrites away before execution).

[REF: sql-plugin/../aggregate/ :: GpuSum, GpuMin, GpuMax, GpuCount,
 GpuAverage]

The same partial/merge/final split as the JAX package's
``ops/aggregates.py``: ``buffer_kinds`` names the reduction of each
partial buffer column, ``buffer_dtypes`` its type; the final projection
lives in ``exec/aggregate.py::final_project``.
"""

from __future__ import annotations

import dataclasses
from typing import List

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops.expressions import Expression


@dataclasses.dataclass
class AggregateFunction:
    child: Expression  # bound input expression (ignored for CountStar)

    # class attributes (NOT dataclass fields — subclasses override them)
    name = "agg"
    # reduction kind per buffer column: "sum", "min" or "max"
    buffer_kinds = None

    @property
    def input_dtype(self) -> T.DataType:
        return self.child.dtype

    @property
    def result_dtype(self) -> T.DataType:
        raise NotImplementedError

    def buffer_dtypes(self) -> List[T.DataType]:
        raise NotImplementedError


class Sum(AggregateFunction):
    name = "sum"
    buffer_kinds = ["sum", "sum"]  # (sum, valid_count)

    @property
    def result_dtype(self):
        dt = self.input_dtype
        if T.is_integral(dt):
            return T.LongT
        if isinstance(dt, T.DecimalType):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: decimal sum is not ported yet")
        return T.DoubleT

    def buffer_dtypes(self):
        return [self.result_dtype, T.LongT]


class Min(AggregateFunction):
    name = "min"
    buffer_kinds = ["min"]

    @property
    def result_dtype(self):
        return self.input_dtype

    def buffer_dtypes(self):
        return [self.input_dtype]


class Max(AggregateFunction):
    name = "max"
    buffer_kinds = ["max"]

    @property
    def result_dtype(self):
        return self.input_dtype

    def buffer_dtypes(self):
        return [self.input_dtype]


class Count(AggregateFunction):
    """count(expr): number of non-null values."""

    name = "count"
    buffer_kinds = ["sum"]

    @property
    def result_dtype(self):
        return T.LongT

    def buffer_dtypes(self):
        return [T.LongT]


class CountStar(AggregateFunction):
    name = "count_star"
    buffer_kinds = ["sum"]

    @property
    def result_dtype(self):
        return T.LongT

    def buffer_dtypes(self):
        return [T.LongT]


class Average(AggregateFunction):
    name = "avg"
    buffer_kinds = ["sum", "sum"]  # (sum as double, valid_count)

    @property
    def result_dtype(self):
        return T.DoubleT

    def buffer_dtypes(self):
        return [T.DoubleT, T.LongT]


class CountDistinct(AggregateFunction):
    """count(DISTINCT x): ``GroupedData.agg`` rewrites it into a two-level
    aggregate (a dedup group-by on (keys, x) below a plain count), so it
    never reaches an exec.  [REF: Spark's RewriteDistinctAggregates]"""

    name = "count_distinct"

    @property
    def result_dtype(self):
        return T.LongT
