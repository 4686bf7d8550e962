"""Logical plan nodes — the subset the TPC-H queries, ``repartition``,
``union``, ``session.range``, ``sample``, rollup/cube, the
generators (explode), the window functions, the python UDF bridge
(``PythonEval``, ``MapInPandas``, ``FlatMapGroupsInPandas``) and the
file scan (``ParquetRelation``) use.

The counterparts of the JAX package's ``plan/logical.py`` nodes of the
same names.  The DataFrame API resolves names and coerces types eagerly,
so logical nodes already hold bound, typed expressions; physical
planning (plan/planner.py) maps them onto CPU execs, and the plan
rewrite (plan/overrides.py) moves what it can onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops.aggregates import AggregateFunction
from spark_rapids_tpu_torch.ops.expressions import Expression


@dataclasses.dataclass
class SortOrder:
    expr: Expression
    ascending: bool = True
    nulls_first: bool = True


class LogicalPlan:
    schema: T.StructType

    @property
    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    @property
    def name(self):
        return type(self).__name__


@dataclasses.dataclass
class InMemoryRelation(LogicalPlan):
    table: pa.Table
    schema: T.StructType
    num_partitions: int = 1
    # result-cache input identity: the content fingerprint (assigned only
    # by cache/fingerprints.py and the session catalog) and the catalog
    # name the relation was registered under, if any
    fingerprint: Optional[str] = None
    source: Optional[str] = None

    @property
    def name(self):
        return "InMemoryRelation"


@dataclasses.dataclass
class ParquetRelation(LogicalPlan):
    """File-source relation (parquet or orc — ``format`` selects).

    ``columns``: pruned data-column names (projection pushdown);
    ``filters``: (name, op, literal) conjuncts for row-group pruning;
    ``partition_values``: hive-style partition values per file (aligned
    with ``paths``); ``partition_fields``: their columns, after the data
    columns; ``file_name_col``: append the input_file_name() column.
    Pushdown fields are filled by plan/optimizer.py, not by users;
    ``deletes`` by the Delta and Iceberg loaders (``io/delta.py``,
    ``io/iceberg.py``).
    """

    paths: List[str]
    schema: T.StructType
    format: str = "parquet"
    columns: Optional[List[str]] = None
    filters: Optional[List[tuple]] = None
    partition_values: Optional[List[dict]] = None
    partition_fields: Tuple = ()
    file_name_col: bool = False
    # dynamic partition pruning: (build-side Project plan yielding the
    # join key column, partition column name) — filled by the optimizer
    dpp: Optional[tuple] = None
    # row-level deletes, aligned with ``paths``: per file a SORTED int64
    # array of deleted FILE-absolute row positions (or None), applied as
    # a row mask at scan time
    deletes: Optional[List] = None


@dataclasses.dataclass
class Project(LogicalPlan):
    child: LogicalPlan
    exprs: List[Expression]
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Filter(LogicalPlan):
    child: LogicalPlan
    condition: Expression

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    child: LogicalPlan
    grouping: List[Expression]
    aggregates: List[AggregateFunction]
    schema: T.StructType  # grouping cols then agg results

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Sort(LogicalPlan):
    child: LogicalPlan
    orders: List[SortOrder]

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Limit(LogicalPlan):
    child: LogicalPlan
    n: int

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    join_type: str  # inner, left, right, full, left_semi, left_anti, cross
    left_keys: List[Expression]
    right_keys: List[Expression]
    condition: Optional[Expression]  # residual; refs bound to left++right
    schema: T.StructType
    # USING join (key columns coalesced once in the output) vs
    # expression join (all left cols ++ all right cols, Spark semantics)
    using: bool = True

    @property
    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass
class Range(LogicalPlan):
    """session.range — generated ids, no backing data."""

    start: int
    end: int
    step: int
    schema: T.StructType
    num_partitions: int = 1


@dataclasses.dataclass
class Sample(LogicalPlan):
    """Bernoulli sample (without replacement)."""

    child: LogicalPlan
    fraction: float
    seed: int

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Expand(LogicalPlan):
    """Grouping-sets row multiplication [REF: Spark Expand]."""

    child: LogicalPlan
    projections: List[List[Expression]]
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Generate(LogicalPlan):
    """explode/posexplode of an array column, appending the position
    (posexplode) and element columns to the child's output [REF: Spark
    Generate]."""

    child: LogicalPlan
    generator: Expression  # array-valued
    with_pos: bool
    outer: bool
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class WindowFunctionSpec:
    """One bound window expression [REF: GpuWindowExpression].

    kind: row_number | rank | dense_rank | ntile | percent_rank |
          cume_dist | lag | lead | sum | min | max | count | avg | first
    frame: 'range_current' (Spark's default with ORDER BY: RANGE
           unbounded preceding to the current row, peers included),
           'rows_current' (ROWS unbounded preceding to the current
           row), 'partition' (the whole partition: the default without
           ORDER BY), 'rows_bounded' or 'range_bounded'.
    """

    kind: str
    child: Optional[Expression]
    dtype: T.DataType
    offset: int = 1          # lag/lead offset; ntile's bucket count
    frame: str = "partition"
    # a rows_bounded frame's offsets from the current row (negative =
    # preceding), e.g. rowsBetween(-2, 0) -> lo=-2, hi=0; a
    # range_bounded frame's ORDER-value offsets, None = unbounded
    frame_lo: Optional[int] = 0
    frame_hi: Optional[int] = 0
    # lead/lag IGNORE NULLS: step over null values
    ignore_nulls: bool = False


@dataclasses.dataclass
class Window(LogicalPlan):
    """Appends one result column per window function to the child's
    output."""

    child: LogicalPlan
    partition_by: List[Expression]
    order_by: List[SortOrder]
    functions: List[WindowFunctionSpec]
    schema: T.StructType  # the child's fields, then one per function

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class PythonEval(LogicalPlan):
    """Appends python-UDF result columns [REF: Spark BatchEvalPython /
    ArrowEvalPython]."""

    child: LogicalPlan
    udfs: List  # List[exec.python_udf.PyUDFSpec]
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class MapInPandas(LogicalPlan):
    child: LogicalPlan
    fn: object
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class FlatMapGroupsInPandas(LogicalPlan):
    """Grouped map — the child must be co-partitioned on key_indices."""

    child: LogicalPlan
    key_indices: List[int]
    fn: object
    schema: T.StructType

    @property
    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Union(LogicalPlan):
    inputs: List[LogicalPlan]

    @property
    def schema(self):
        return self.inputs[0].schema

    @property
    def children(self):
        return tuple(self.inputs)


@dataclasses.dataclass
class Repartition(LogicalPlan):
    child: LogicalPlan
    num_partitions: int
    keys: Optional[List[Expression]] = None  # None = round robin

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)
