"""DataFrame API — the subset of the ported TPC-H queries.

The counterpart of the JAX package's ``sql/dataframe.py``:
``select``, ``withColumnRenamed``, ``filter``, ``groupBy(...).agg``
(count(DISTINCT) rewritten into two aggregates), ``agg``, ``orderBy``,
``limit``, ``join`` (USING joins on column names and expression joins on
a ``Column`` condition), ``crossJoin``, and the actions ``toArrow`` and
``collect``.
Transformations build the logical plan eagerly (pyspark-style errors at
the call site); actions optimize, plan onto the session's device and
pump the exec tree.
"""

from __future__ import annotations

from typing import List, Union

import pyarrow as pa

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec.transitions import DeviceToHostExec
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops.expressions import BoundReference
from spark_rapids_tpu_torch.plan import analysis as AN
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.optimizer import optimize
from spark_rapids_tpu_torch.plan.planner import plan_physical
from spark_rapids_tpu_torch.sql.column import Column, UExpr, col  # noqa: F401


class Row(tuple):
    """A result row: a tuple whose fields are also reachable by name."""

    def __new__(cls, values, fields):
        r = super().__new__(cls, values)
        r._fields = tuple(fields)
        return r

    def __getattr__(self, item):
        try:
            return self[self._fields.index(item)]
        except ValueError:
            raise AttributeError(item)

    def asDict(self):
        return dict(zip(self._fields, self))

    def __repr__(self):
        return "Row(" + ", ".join(f"{k}={v!r}" for k, v in
                                  zip(self._fields, self)) + ")"


_JOIN_TYPES = {
    "inner": "inner", "left": "left", "leftouter": "left",
    "left_outer": "left", "right": "right", "rightouter": "right",
    "right_outer": "right", "outer": "full", "full": "full",
    "fullouter": "full", "full_outer": "full", "semi": "left_semi",
    "leftsemi": "left_semi", "left_semi": "left_semi", "anti": "left_anti",
    "leftanti": "left_anti", "left_anti": "left_anti", "cross": "cross"}


def _to_column(c: Union[str, Column]) -> Column:
    return col(c) if isinstance(c, str) else c


def _output_name(u: UExpr, e) -> str:
    if u.op in ("alias", "attr"):
        return u.payload
    return str(e)


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self._plan = plan
        self._last_plan = None

    @property
    def schema(self) -> T.StructType:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.field_names()

    def _derive(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self.session, plan)

    # -- transformations ------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        exprs = []
        fields = []
        for c in cols:
            if isinstance(c, str) and c == "*":
                for i, f in enumerate(self.schema.fields):
                    exprs.append(BoundReference(i, f.dtype, f.nullable))
                    fields.append(f)
                continue
            u = _to_column(c)._u
            e = AN.resolve(u, self.schema)
            exprs.append(e)
            fields.append(T.StructField(_output_name(u, e), e.dtype))
        return self._derive(L.Project(self._plan, exprs,
                                      T.StructType(tuple(fields))))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return self.select(*[(col(n).alias(new) if n == old else n)
                             for n in self.columns])

    def filter(self, condition: Column) -> "DataFrame":
        if isinstance(condition, str):
            raise NotImplementedError("SQL-string filters not yet supported")
        cond = AN.resolve(condition._u, self.schema)
        if not isinstance(cond.dtype, (T.BooleanType, T.NullType)):
            raise AN.AnalysisException(
                f"filter condition must be boolean, got {cond.dtype}")
        return self._derive(L.Filter(self._plan, cond))

    def groupBy(self, *cols) -> "GroupedData":
        exprs = []
        names = []
        for c in cols:
            u = _to_column(c)._u
            e = AN.resolve(u, self.schema)
            exprs.append(e)
            names.append(_output_name(u, e))
        return GroupedData(self, exprs, names)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, [], []).agg(*aggs)

    def orderBy(self, *cols, ascending=None) -> "DataFrame":
        orders = []
        for i, c in enumerate(cols):
            u = _to_column(c)._u
            asc, nulls_first = True, True
            if u.op == "sortorder":
                direction, nulls = u.payload
                asc = direction == "asc"
                nulls_first = nulls == "nulls_first"
                u = u.children[0]
            if ascending is not None:
                asc = (ascending[i] if isinstance(ascending, (list, tuple))
                       else bool(ascending))
                nulls_first = asc
            orders.append(L.SortOrder(AN.resolve(u, self.schema), asc,
                                      nulls_first))
        return self._derive(L.Sort(self._plan, orders))

    def limit(self, n: int) -> "DataFrame":
        return self._derive(L.Limit(self._plan, n))

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join with ``other``: ``on`` is a column name, a list of names
        (a USING join: each key column once in the output, from the
        left) or a ``Column`` condition (an expression join: all left
        columns, then all right columns)."""
        how = _JOIN_TYPES[how.lower()]
        if on is None:
            on = []
        if isinstance(on, str):
            on = [on]
        if isinstance(on, Column):
            return self._expression_join(other, on, how)
        if not all(isinstance(c, str) for c in on):
            raise AN.AnalysisException(
                "join 'on' must be a column-name list or a single Column "
                "condition")
        left_keys = [AN.resolve(UExpr("attr", n), self.schema) for n in on]
        right_keys = [AN.resolve(UExpr("attr", n), other.schema)
                      for n in on]
        # USING semantics: join columns once (from the left), then the
        # remaining left columns, then the remaining right columns
        fields: List[T.StructField] = []
        for name in on:
            f = self.schema.fields[self.schema.field_index(name)]
            fields.append(T.StructField(
                name, f.dtype, f.nullable or how in ("right", "full")))
        for f in self.schema.fields:
            if f.name not in on:
                fields.append(T.StructField(
                    f.name, f.dtype, f.nullable or how in ("right", "full")))
        if how not in ("left_semi", "left_anti"):
            for f in other.schema.fields:
                if f.name not in on:
                    fields.append(T.StructField(
                        f.name, f.dtype,
                        f.nullable or how in ("left", "full")))
        return self._derive(L.Join(
            self._plan, other._plan, how, left_keys, right_keys, None,
            T.StructType(tuple(fields))))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return self.join(other, on=[], how="cross")

    def _expression_join(self, other: "DataFrame", on: Column, how: str
                         ) -> "DataFrame":
        """Spark's ExtractEquiJoinKeys: resolve the condition against
        left ++ right, take its ``left.col == right.col`` conjuncts as
        equi keys and keep the rest as a residual condition."""
        nl = len(self.schema)
        combined = T.StructType(tuple(self.schema.fields)
                                + tuple(other.schema.fields))
        cond = AN.resolve(on._u, combined)
        if not isinstance(cond.dtype, (T.BooleanType, T.NullType)):
            raise AN.AnalysisException(
                f"join condition must be boolean, got {cond.dtype}")
        conjuncts: List[E.Expression] = []

        def split(e):
            if isinstance(e, E.And):
                split(e.left)
                split(e.right)
            else:
                conjuncts.append(e)

        split(cond)
        left_keys, right_keys, residual = [], [], None
        for c in conjuncts:
            sides = None
            if (isinstance(c, E.EqualTo)
                    and isinstance(c.left, E.BoundReference)
                    and isinstance(c.right, E.BoundReference)):
                li, ri = c.left.index, c.right.index
                if li < nl <= ri:
                    sides = (li, ri - nl)
                elif ri < nl <= li:
                    sides = (ri, li - nl)
            if sides is None:
                residual = c if residual is None else E.And(residual, c)
                continue
            li, ri = sides
            lf, rf = self.schema.fields[li], other.schema.fields[ri]
            left_keys.append(E.BoundReference(li, lf.dtype, lf.nullable))
            right_keys.append(E.BoundReference(ri, rf.dtype, rf.nullable))
        if not left_keys and how not in ("inner", "cross"):
            raise AN.AnalysisException(
                f"{how} join requires at least one equi-join conjunct "
                "(left.col == right.col); got only a non-equi condition")
        fields: List[T.StructField] = [
            T.StructField(f.name, f.dtype,
                          f.nullable or how in ("right", "full"))
            for f in self.schema.fields]
        if how not in ("left_semi", "left_anti"):
            fields += [T.StructField(f.name, f.dtype,
                                     f.nullable or how in ("left", "full"))
                       for f in other.schema.fields]
        return self._derive(L.Join(
            self._plan, other._plan, how, left_keys, right_keys, residual,
            T.StructType(tuple(fields)), using=False))

    # -- actions ----------------------------------------------------------
    def _execute_plan(self) -> DeviceToHostExec:
        plan = plan_physical(optimize(self._plan),
                             self.session.rapids_conf(),
                             self.session.device)
        return DeviceToHostExec(plan)

    def toArrow(self) -> pa.Table:
        """Execute and return the result as an Arrow table."""
        plan = self._execute_plan()
        self._last_plan = plan
        tables = [t for p in range(plan.num_partitions())
                  for t in plan.execute(p)]
        if not tables:
            return pa.table([pa.array([], type=T.to_arrow(f.dtype))
                             for f in self.schema.fields],
                            names=self.columns)
        return pa.concat_tables(tables)

    def metrics(self):
        """Operator metrics of the last execution, root first."""
        if self._last_plan is None:
            raise RuntimeError("no execution yet — run collect()/toArrow()")
        return self._last_plan.collect_metrics()

    def collect(self) -> List[Row]:
        tbl = self.toArrow()
        names = tuple(tbl.column_names)
        cols = [tbl.column(i).to_pylist() for i in range(tbl.num_columns)]
        return [Row(vals, names) for vals in zip(*cols)] if cols else []



class GroupedData:
    def __init__(self, df: DataFrame, grouping, names):
        self.df = df
        self.grouping = grouping
        self.names = names

    def agg(self, *aggs) -> DataFrame:
        fns = []
        names = []
        for a in aggs:
            fn, name = AN.resolve_aggregate(_to_column(a)._u,
                                            self.df.schema)
            fns.append(fn)
            names.append(name)
        if any(isinstance(f, A.CountDistinct) for f in fns):
            return self._agg_distinct(fns, names)
        fields = [T.StructField(n, g.dtype)
                  for n, g in zip(self.names, self.grouping)]
        fields += [T.StructField(n, f.result_dtype)
                   for n, f in zip(names, fns)]
        return self.df._derive(L.Aggregate(
            self.df._plan, self.grouping, fns, T.StructType(tuple(fields))))

    def _agg_distinct(self, fns, names) -> DataFrame:
        """count(DISTINCT x): Spark's RewriteDistinctAggregates shape — a
        dedup group-by on (keys, x) below a plain count (null x groups
        too, and ``count`` skips it)."""
        if not all(isinstance(f, A.CountDistinct) for f in fns):
            raise AN.AnalysisException(
                "mixing distinct and non-distinct aggregates in one "
                "agg() is not yet supported")
        if len(fns) != 1:
            raise AN.AnalysisException(
                "multiple count(DISTINCT) aggregates in one agg() are "
                "not yet supported")
        fn = fns[0]
        nk = len(self.grouping)
        inner_fields = [T.StructField(f"k{i}", g.dtype)
                        for i, g in enumerate(self.grouping)]
        inner_fields.append(T.StructField("_dv", fn.child.dtype))
        inner = L.Aggregate(self.df._plan,
                            list(self.grouping) + [fn.child], [],
                            T.StructType(tuple(inner_fields)))
        outer_grouping = [BoundReference(i, g.dtype)
                          for i, g in enumerate(self.grouping)]
        fields = [T.StructField(n, g.dtype)
                  for n, g in zip(self.names, self.grouping)]
        fields.append(T.StructField(names[0], T.LongT))
        return self.df._derive(L.Aggregate(
            inner, outer_grouping,
            [A.Count(BoundReference(nk, fn.child.dtype))],
            T.StructType(tuple(fields))))
