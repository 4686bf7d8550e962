"""Aggregate functions with Spark result-type and null semantics — the
port's subset: ``Sum``, ``Min``, ``Max``, ``Count``, ``CountStar``,
``Average``, ``First``, the variance family (``VarianceSamp``,
``VariancePop``, ``StddevSamp``, ``StddevPop``), ``CollectList`` and
``CollectSet``, ``Percentile`` and ``ApproxPercentile``, and
``CountDistinct``, which the DataFrame API rewrites away before
execution.

[REF: sql-plugin/../aggregate/ :: GpuSum, GpuMin, GpuMax, GpuCount,
 GpuAverage, GpuFirst, GpuStddev/GpuVariance, GpuCollectList,
 GpuCollectSet, GpuPercentileDefault]

The same partial/merge/final split as the JAX package's
``ops/aggregates.py``: ``buffer_kinds`` names the reduction of each
partial buffer column, ``buffer_dtypes`` its type; the final projection
lives in ``exec/aggregate.py::final_project``.  The collects and the
percentiles are holistic (``buffer_kinds`` ``["collect"]``): they run
only on the aggregate's gathered single pass.
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
    # reduction kind per buffer column: "sum", "min", "max" or "first"
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
            return T.DecimalType(min(dt.precision + 10, 38), dt.scale)
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


class First(AggregateFunction):
    """first(expr, ignoreNulls=False): the group's first row in input
    order, a null included (batches keep their input order)."""

    name = "first"
    buffer_kinds = ["first"]

    @property
    def result_dtype(self):
        return self.input_dtype

    def buffer_dtypes(self):
        return [self.input_dtype]


class _VarianceBase(AggregateFunction):
    """The variance family over the JAX package's buffers (Σx, Σx², n):
    plain "sum" kinds that ride the partial/merge protocol.  The final
    is Σx² - (Σx)²/n, clamped at 0, over n - ddof (NaN when that is not
    positive: var_samp of one row); an empty group is null.  As in the
    JAX package, data with |mean| >> stddev loses digits to
    cancellation, unlike Spark's Welford update (the CPU exec's)."""

    buffer_kinds = ["sum", "sum", "sum"]  # Σx, Σx², valid n
    ddof = 1          # sample by default
    sqrt_final = False

    @property
    def result_dtype(self):
        return T.DoubleT

    def buffer_dtypes(self):
        return [T.DoubleT, T.DoubleT, T.LongT]


class VarianceSamp(_VarianceBase):
    name = "var_samp"
    ddof = 1


class VariancePop(_VarianceBase):
    name = "var_pop"
    ddof = 0


class StddevSamp(_VarianceBase):
    name = "stddev_samp"
    ddof = 1
    sqrt_final = True


class StddevPop(_VarianceBase):
    name = "stddev_pop"
    ddof = 0
    sqrt_final = True


class CollectList(AggregateFunction):
    """collect_list(x) -> array<x>: each group's non-null values in
    input order.  On the device the result is a padded element matrix
    ``[G, cap]`` plus lengths (``columnar/column.py``'s array layout),
    gathered from the stable group sort (each group's rows are
    contiguous there) on the aggregate's gathered single pass; ``cap``
    is the power of two of the largest group, probed with one host
    read.  [REF: GpuCollectList]"""

    name = "collect_list"
    buffer_kinds = ["collect"]  # holistic: the gathered single pass

    @property
    def result_dtype(self):
        return T.ArrayType(self.input_dtype)

    def buffer_dtypes(self):
        return [self.result_dtype]


class CollectSet(CollectList):
    """collect_set(x) -> array<x>: each group's distinct non-null values.
    Spark leaves the order undefined; both the device and the CPU oracle
    emit ascending value order, as the JAX package does (-0.0 and 0.0
    are one value, every NaN one).  [REF: GpuCollectSet]"""

    name = "collect_set"


@dataclasses.dataclass
class Percentile(AggregateFunction):
    """percentile(x, p): the exact percentile with linear interpolation
    (rank p·(n-1)), over value-sorted groups on the gathered single
    pass.  [REF: GpuPercentileDefault]"""

    pct: float = 0.5
    name = "percentile"
    buffer_kinds = ["collect"]  # holistic: the gathered single pass

    @property
    def result_dtype(self):
        return T.DoubleT

    def buffer_dtypes(self):
        return [self.result_dtype]


@dataclasses.dataclass
class ApproxPercentile(Percentile):
    """approx_percentile(x, p[, accuracy]): the nearest-rank element
    (rank ceil(p·n) - 1), as in the JAX package — no rank error, so
    within any accuracy, but not Spark's t-digest output; the result
    type is the input type.  [REF: ApproxPercentileFromTDigest]"""

    accuracy: int = 10000
    name = "approx_percentile"

    @property
    def result_dtype(self):
        return self.input_dtype


class CountDistinct(AggregateFunction):
    """count(DISTINCT x): ``GroupedData.agg`` rewrites it into a two-level
    aggregate (a dedup group-by on (keys, x) below a plain count), so it
    never reaches an exec.  [REF: Spark's RewriteDistinctAggregates]"""

    name = "count_distinct"

    @property
    def result_dtype(self):
        return T.LongT
