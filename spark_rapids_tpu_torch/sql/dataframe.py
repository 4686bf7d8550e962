"""DataFrame API — the subset of the ported TPC-H queries.

The counterpart of the JAX package's ``sql/dataframe.py``:
``select``, ``withColumn``, ``withColumnRenamed``, ``drop``, ``filter``,
``groupBy(...).agg`` (count(DISTINCT) rewritten into two aggregates)
and ``GroupedData``'s ``count/sum/min/max/avg``, ``rollup`` and
``cube`` (grouping sets through ``Expand``), ``agg``, ``orderBy``,
``limit``, ``union``, ``sample``, ``distinct``, ``repartition``,
``join`` (USING joins on column names and expression joins on a
``Column`` condition), ``crossJoin``, the generators in ``select``
(one ``explode``/``posexplode`` per select, through a ``Generate``
node), window functions in ``select`` and ``withColumn`` (one
``Window`` node per distinct spec), python UDFs in ``select``
(one ``PythonEval`` node, or expressions where the UDF compiler lowers
them), ``mapInPandas``, ``GroupedData.applyInPandas`` and
grouped-aggregate pandas UDFs (a grouped map over a hash exchange on
the keys), the actions ``toArrow``, ``collect``, ``count``,
``toPandas`` and ``show``, ``write`` (``io/readers.py``), and
``explain`` and ``fallback_summary``.
Transformations build the logical plan eagerly (pyspark-style errors at
the call site); actions optimize, plan a CPU exec tree, let the plan
rewrite (``plan/overrides.py``) move what it can onto the session's
device, and pump the result.

Struct columns are a view of this layer, as in the JAX package: the
session stores a struct as one physical column per field (``s.a``,
``s.b``, and ``s#null`` when the struct has nulls) and each DataFrame
keeps a ``StructSpec`` per logical struct column.  Selecting, grouping
or ordering by a struct means its physical columns; ``getField`` and
``col("s.a")`` name a field's column; ``F.struct`` makes one column per
field; ``toArrow`` reassembles the Arrow struct.  No exec sees a struct.

Each execution (``toArrow``) is a query: it gets an id, opens the
resilience scope and the cancel scope (``runtime/resilience.py``,
``runtime/cancel.py``; ``timeout_ms`` or
``spark.rapids.tpu.query.timeoutMs`` deadlines it), and closes both in
``finally``.  A cancelled query's registered spillables are reclaimed
before ``QueryCancelled`` reaches the caller.  Each execution leaves an
entry in the session's ``query_history``: its id, status, error, the
resilience rollup and a fallback-report line per op degraded at run
time.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import time
from typing import List, Optional, Union

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.exec.base import ExecNode
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops.expressions import BoundReference
from spark_rapids_tpu_torch.plan import analysis as AN
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.optimizer import optimize
from spark_rapids_tpu_torch.plan.overrides import (
    OverrideResult, apply_overrides)
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


def _is_star(c) -> bool:
    return isinstance(c, str) and c == "*"


def _generate_u(c) -> Optional[UExpr]:
    """The explode/posexplode UExpr under an optional alias, or None."""
    if isinstance(c, str):
        return None
    u = _to_column(c)._u
    core = u.children[0] if u.op == "alias" else u
    return core if core.op == "generate" else None


def _pyudf_u(c) -> Optional[UExpr]:
    """The python-UDF UExpr under an optional alias, or None."""
    if isinstance(c, str):
        return None
    u = _to_column(c)._u
    core = u.children[0] if u.op == "alias" else u
    return core if core.op == "pyudf" else None


def _window_u(c) -> Optional[UExpr]:
    """The ``.over(spec)`` UExpr under an optional alias, or None."""
    if isinstance(c, str):
        return None
    u = _to_column(c)._u
    core = u.children[0] if u.op == "alias" else u
    return core if core.op == "window" else None


@contextlib.contextmanager
def profile_capture(device: torch.device, profile_dir: str = None):
    """``torch.profiler`` over the block, yielding the profiler; with
    ``profile_dir``, exported there as ``trace.json`` (a Chrome trace).
    On the card it records the CUDA activity and refuses to run without
    it: a capture of the host alone would hide the device.
    [REF: spark-rapids-jni profiler]"""
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "spark.rapids.profile.enabled: torch.profiler cannot "
                "record the CUDA activity on this machine")
        acts.append(ProfilerActivity.CUDA)
    if profile_dir is not None:
        os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    if profile_dir is not None:
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StructSpec:
    """One logical STRUCT column, stored as one physical column per field
    (struct-of-arrays).  ``fields``: [(field name, physical column
    name)]; ``null_col``: the physical bool column that marks a null
    struct (absent when the struct has no null).
    [REF: complexTypeCreator.scala / cuDF struct columns — here structs
    are a view of the DataFrame layer; every exec sees plain columns]"""

    __slots__ = ("fields", "null_col")

    def __init__(self, fields, null_col=None):
        self.fields = list(fields)
        self.null_col = null_col

    @property
    def phys_cols(self) -> List[str]:
        out = [p for _, p in self.fields]
        if self.null_col:
            out.append(self.null_col)
        return out

    def renamed(self, new_name: str) -> "StructSpec":
        return StructSpec(
            [(f, f"{new_name}.{f}") for f, _ in self.fields],
            f"{new_name}#null" if self.null_col else None)


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan, structs=None):
        self.session = session
        self._plan = plan
        # the logical struct columns over the physical schema
        self._structs: dict = dict(structs or {})
        self._last_plan = None
        self._last_override = None
        # the last execution's trace rollup and stats profile
        self._last_rollup = None
        self._last_profile = None
        # host milliseconds of the last plan rewrite: _execute_plan
        # called to the plan returned
        self.plan_ms = None

    @property
    def schema(self) -> T.StructType:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.field_names()

    def _derive(self, plan: L.LogicalPlan,
                structs="inherit") -> "DataFrame":
        """A new frame over ``plan``: the struct views whose physical
        columns all survive carry over, unless ``structs`` is given."""
        if structs == "inherit":
            names = set(plan.schema.field_names())
            structs = {k: v for k, v in self._structs.items()
                       if all(p in names for p in v.phys_cols)}
        return DataFrame(self.session, plan, structs)

    def _adopt_structs(self, out: "DataFrame",
                       other: "DataFrame") -> "DataFrame":
        """Add the right join side's struct views to the result (those
        whose physical columns all survived)."""
        names = set(out.schema.field_names())
        for k, v in other._structs.items():
            if k not in out._structs and all(p in names
                                             for p in v.phys_cols):
                out._structs[k] = v
        return out

    def _struct_name_of(self, c) -> Optional[str]:
        """The struct column ``c`` names (a bare string or a plain
        ``col('s')``), else None."""
        if isinstance(c, str):
            return c if c in self._structs else None
        if isinstance(c, Column) and c._u.op == "attr" \
                and c._u.payload in self._structs:
            return c._u.payload
        return None

    def _expand_struct_names(self, cols) -> list:
        """Bare struct names or references replaced by their physical
        columns (the null flag included: null structs group and sort as
        one value)."""
        out = []
        for c in cols:
            sname = self._struct_name_of(c)
            if sname is not None:
                out.extend(self._structs[sname].phys_cols)
            else:
                out.append(c)
        return out

    def _rewrite_struct_ref(self, u: UExpr) -> UExpr:
        """``getField`` chains to the field's physical column
        (``col('s').getField('a')`` -> ``col('s.a')``)."""
        if u.op == "getfield":
            child = self._rewrite_struct_ref(u.children[0])
            if child.op == "attr":
                return UExpr("attr", f"{child.payload}.{u.payload}")
            raise AN.AnalysisException(
                "getField is only supported on (nested) column "
                "references")
        if not u.children:
            return u
        kids = tuple(self._rewrite_struct_ref(c) for c in u.children)
        if all(a is b for a, b in zip(kids, u.children)):
            return u
        return UExpr(u.op, u.payload, kids)

    def _logical_columns(self) -> List[str]:
        """Column names as the user sees them: a struct's physical
        columns collapse to its name, at its first field's place."""
        phys_to_struct = {p: sname for sname, spec in self._structs.items()
                          for p in spec.phys_cols}
        out, seen = [], set()
        for n in self.columns:
            sname = phys_to_struct.get(n)
            if sname is None:
                out.append(n)
            elif sname not in seen:
                seen.add(sname)
                out.append(sname)
        return out

    # -- transformations ------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        if any(_generate_u(c) is not None for c in cols):
            return self._select_with_generate(cols)
        if any(_pyudf_u(c) is not None for c in cols):
            if any(_window_u(c) is not None for c in cols):
                raise AN.AnalysisException(
                    "cannot mix python UDFs and window functions in one "
                    "select — materialize one of them first "
                    "(e.g. withColumn)")
            return self._select_with_pyudfs(cols)
        if any(_window_u(c) is not None for c in cols):
            return self._select_with_windows(cols)
        exprs = []
        fields = []
        new_structs = {}

        def add_ref(i, name=None):
            f = self.schema.fields[i]
            exprs.append(BoundReference(i, f.dtype, f.nullable))
            fields.append(f if name is None
                          else T.StructField(name, f.dtype, f.nullable))

        for c in cols:
            if _is_star(c):
                for i in range(len(self.schema)):
                    add_ref(i)
                continue
            sname = self._struct_name_of(c)
            if sname is not None:
                # a struct column is its physical columns; the view
                # rides along
                spec = self._structs[sname]
                for p in spec.phys_cols:
                    add_ref(self.schema.field_index(p))
                new_structs[sname] = spec
                continue
            u = _to_column(c)._u
            if (u.op == "alias" and u.children[0].op == "attr"
                    and u.children[0].payload in self._structs):
                # a struct renamed: its physical columns under the new
                # name's layout
                spec = self._structs[u.children[0].payload]
                new = spec.renamed(u.payload)
                for old_p, new_p in zip(spec.phys_cols, new.phys_cols):
                    add_ref(self.schema.field_index(old_p), new_p)
                new_structs[u.payload] = new
                continue
            mk = u.children[0] if u.op == "alias" else u
            if mk.op == "make_struct":
                # F.struct(...): one physical column per field
                # [REF: complexTypeCreator CreateStruct]
                sname = (u.payload if u.op == "alias"
                         else f"struct_{len(new_structs)}")
                sfields = []
                for fname, fu in zip(mk.payload, mk.children):
                    e = AN.resolve(self._rewrite_struct_ref(fu),
                                   self.schema)
                    pname = f"{sname}.{fname}"
                    exprs.append(e)
                    fields.append(T.StructField(pname, e.dtype))
                    sfields.append((fname, pname))
                new_structs[sname] = StructSpec(sfields, None)
                continue
            e = AN.resolve(self._rewrite_struct_ref(u), self.schema)
            exprs.append(e)
            fields.append(T.StructField(_output_name(u, e), e.dtype))
        out = self._derive(L.Project(self._plan, exprs,
                                     T.StructType(tuple(fields))))
        out._structs.update(new_structs)
        return out

    def _select_with_generate(self, cols) -> "DataFrame":
        """Spark's ExtractGenerator: one Generate node appends the
        position (posexplode: ``pos``, nullable under ``outer``) and the
        element (the alias, else ``col``; nullable) to the child's
        columns, and a Project picks the requested output.  One
        generator per select."""
        gens = [c for c in cols if _generate_u(c) is not None]
        if len(gens) > 1:
            raise AN.AnalysisException(
                "only one generator (explode/posexplode) is allowed per "
                "select")
        base = self.schema
        gu = _generate_u(gens[0])
        with_pos, outer = gu.payload
        gen = AN.resolve(self._rewrite_struct_ref(gu.children[0]), base)
        if not isinstance(gen.dtype, T.ArrayType):
            raise AN.AnalysisException(
                f"explode needs an array column, got "
                f"{gen.dtype.simple_name}")
        alias_u = _to_column(gens[0])._u
        elem_name = alias_u.payload if alias_u.op == "alias" else "col"
        elem_dt = gen.dtype.element_type
        nc = len(base)
        ext = list(base.fields)
        if with_pos:
            ext.append(T.StructField("pos", T.IntegerT, outer))
        ext.append(T.StructField(elem_name, elem_dt, True))
        ext_schema = T.StructType(tuple(ext))
        plan = L.Generate(self._plan, gen, with_pos, outer, ext_schema)
        exprs, fields = [], []
        for c in cols:
            if _is_star(c):
                for i, f in enumerate(base.fields):
                    exprs.append(BoundReference(i, f.dtype, f.nullable))
                    fields.append(f)
                continue
            if _generate_u(c) is not None:
                for i in range(nc, len(ext)):
                    f = ext[i]
                    exprs.append(BoundReference(i, f.dtype, f.nullable))
                    fields.append(f)
                continue
            u = _to_column(c)._u
            e = AN.resolve(self._rewrite_struct_ref(u), ext_schema)
            exprs.append(e)
            fields.append(T.StructField(_output_name(u, e), e.dtype))
        return self._derive(L.Project(plan, exprs,
                                      T.StructType(tuple(fields))))

    def _select_with_pyudfs(self, cols) -> "DataFrame":
        """Spark's ExtractPythonUDFs: one PythonEval node appends every
        UDF result column (``_udf0``, ``_udf1``, ...), then a Project
        picks the output.

        With ``spark.rapids.sql.udfCompiler.enabled`` the AST compiler
        first tries to lower each UDF onto the expression tree
        [REF: udf-compiler/ :: CatalystExpressionBuilder]; a compiled UDF
        becomes a plain device expression and skips the bridge."""
        from spark_rapids_tpu_torch import conf as C
        from spark_rapids_tpu_torch.exec.python_udf import PyUDFSpec
        compile_enabled = bool(self.session.rapids_conf().get(
            C.UDF_COMPILER_ENABLED))
        base = self.schema
        nc = len(base)
        udfs = []
        out_specs = []  # ("plain", c) | ("compiled", e, name, dt) |
        #                 ("udf", index, name, dt)
        for c in cols:
            uu = _pyudf_u(c)
            if uu is None:
                out_specs.append(("plain", c))
                continue
            fn, dt, vectorized, fname = uu.payload
            args = [AN.resolve(self._rewrite_struct_ref(a), base)
                    for a in uu.children]
            u = _to_column(c)._u
            alias = u.payload if u.op == "alias" else None
            name = alias or f"{fname}({', '.join(map(str, args))})"
            if compile_enabled:
                from spark_rapids_tpu_torch.sql.udf_compiler import (
                    UdfCompileError, compile_udf)
                try:
                    expr = compile_udf(fn, args, dt)
                    out_specs.append(("compiled", expr, name, dt))
                    continue
                except (UdfCompileError, AN.AnalysisException):
                    pass  # outside the subset: the arrow bridge
            udfs.append(PyUDFSpec(fn, args, dt, vectorized, name))
            out_specs.append(("udf", len(udfs) - 1, name, dt))
        ext_schema = T.StructType(tuple(
            list(base.fields) + [T.StructField(f"_udf{i}", u.dtype, True)
                                 for i, u in enumerate(udfs)]))
        plan = (L.PythonEval(self._plan, udfs, ext_schema) if udfs
                else self._plan)
        exprs, fields = [], []
        for spec in out_specs:
            if spec[0] == "compiled":
                _, e, name, dt = spec
                exprs.append(e)
                fields.append(T.StructField(name, dt, True))
                continue
            if spec[0] == "udf":
                _, i, name, dt = spec
                exprs.append(BoundReference(nc + i, dt, True))
                fields.append(T.StructField(name, dt, True))
                continue
            c = spec[1]
            if _is_star(c):
                for i, f in enumerate(base.fields):
                    exprs.append(BoundReference(i, f.dtype, f.nullable))
                    fields.append(f)
                continue
            u = _to_column(c)._u
            e = AN.resolve(self._rewrite_struct_ref(u), ext_schema)
            exprs.append(e)
            fields.append(T.StructField(_output_name(u, e), e.dtype))
        return self._derive(L.Project(plan, exprs,
                                      T.StructType(tuple(fields))))

    def mapInPandas(self, fn, schema) -> "DataFrame":
        """fn(iterator[pandas.DataFrame]) -> iterator[pandas.DataFrame]
        with the declared output schema [REF: GpuMapInPandasExec]."""
        if not isinstance(schema, T.StructType):
            raise AN.AnalysisException(
                "mapInPandas needs a StructType output schema")
        return self._derive(L.MapInPandas(self._plan, fn, schema))

    def _select_with_windows(self, cols) -> "DataFrame":
        """Spark's ExtractWindowExpressions, as the JAX package does it:
        one ``Window`` node per distinct spec (in the order the specs
        first appear) appends its functions' columns (``_w0``,
        ``_w1``, ...), then a Project picks the requested output."""
        base = self.schema
        plan = self._plan
        groups = {}     # spec key -> (pby, orders, [fns])
        out_specs = []  # ("plain", c) | ("win", (key, j), name, dtype)
        for c in cols:
            wu = _window_u(c)
            if wu is None:
                out_specs.append(("plain", c))
                continue
            u = _to_column(c)._u
            pby, orders, wf, default_name = AN.resolve_window(wu, base)
            alias = u.payload if u.op == "alias" else None
            key = repr((wu.payload.partition_by, wu.payload.order_by,
                        wu.payload.frame))
            g = groups.setdefault(key, (pby, orders, []))
            g[2].append(wf)
            out_specs.append(("win", (key, len(g[2]) - 1),
                              alias or default_name, wf.dtype))
        offsets = {}
        ext = list(base.fields)
        for key, (pby, orders, fns) in groups.items():
            offsets[key] = len(ext)
            nw = len(ext) - len(base)
            ext.extend(T.StructField(f"_w{nw + i}", fn.dtype)
                       for i, fn in enumerate(fns))
            plan = L.Window(plan, pby, orders, fns,
                            T.StructType(tuple(ext)))
        ext_schema = T.StructType(tuple(ext))
        exprs, fields = [], []
        for spec in out_specs:
            if spec[0] == "win":
                (key, j), name, dtype = spec[1], spec[2], spec[3]
                exprs.append(BoundReference(offsets[key] + j, dtype, True))
                fields.append(T.StructField(name, dtype))
                continue
            c = spec[1]
            if _is_star(c):
                for i, f in enumerate(base.fields):
                    exprs.append(BoundReference(i, f.dtype, f.nullable))
                    fields.append(f)
                continue
            u = _to_column(c)._u
            e = AN.resolve(self._rewrite_struct_ref(u), ext_schema)
            exprs.append(e)
            fields.append(T.StructField(_output_name(u, e), e.dtype))
        return self._derive(L.Project(plan, exprs,
                                      T.StructType(tuple(fields))))

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        """Add a column, or replace one of the same name in place."""
        cols = self._logical_columns()
        if name in cols:
            return self.select(*[(c.alias(name) if n == name else n)
                                 for n in cols])
        return self.select(*cols, c.alias(name))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return self.select(*[(col(n).alias(new) if n == old else n)
                             for n in self._logical_columns()])

    def drop(self, *names) -> "DataFrame":
        return self.select(*[n for n in self._logical_columns()
                             if n not in names])

    def filter(self, condition: Column) -> "DataFrame":
        if isinstance(condition, str):
            raise NotImplementedError("SQL-string filters not yet supported")
        cond = AN.resolve(self._rewrite_struct_ref(condition._u),
                          self.schema)
        if not isinstance(cond.dtype, (T.BooleanType, T.NullType)):
            raise AN.AnalysisException(
                f"filter condition must be boolean, got {cond.dtype}")
        return self._derive(L.Filter(self._plan, cond))

    where = filter

    def groupBy(self, *cols) -> "GroupedData":
        exprs = []
        names = []
        for c in self._expand_struct_names(cols):
            u = self._rewrite_struct_ref(_to_column(c)._u)
            e = AN.resolve(u, self.schema)
            exprs.append(e)
            names.append(_output_name(u, e))
        return GroupedData(self, exprs, names)

    groupby = groupBy

    def rollup(self, *cols) -> "GroupedData":
        """Hierarchical grouping sets: (a, b), (a), () for rollup(a, b).
        [REF: GpuExpandExec.scala — Spark's Expand + Aggregate plan]"""
        g = self.groupBy(*cols)
        nk = len(g.grouping)
        g.sets = [list(range(k)) for k in range(nk, -1, -1)]
        return g

    def cube(self, *cols) -> "GroupedData":
        """All 2^n grouping sets, the widest first."""
        g = self.groupBy(*cols)
        nk = len(g.grouping)
        g.sets = [list(s) for r in range(nk, -1, -1)
                  for s in itertools.combinations(range(nk), r)]
        return g

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, [], []).agg(*aggs)

    def orderBy(self, *cols, ascending=None) -> "DataFrame":
        # ``ascending`` follows the caller's arguments; a struct expands
        # after, each field taking its struct's direction (Spark orders
        # structs field by field)
        pairs = []
        for i, c in enumerate(cols):
            a = (None if ascending is None
                 else (ascending[i] if isinstance(ascending, (list, tuple))
                       else bool(ascending)))
            sname = self._struct_name_of(c)
            if sname is not None:
                pairs.extend((p, a) for p in self._structs[sname].phys_cols)
            else:
                pairs.append((c, a))
        orders = []
        for c, a in pairs:
            u = self._rewrite_struct_ref(_to_column(c)._u)
            asc, nulls_first = True, True
            if u.op == "sortorder":
                direction, nulls = u.payload
                asc = direction == "asc"
                nulls_first = nulls == "nulls_first"
                u = u.children[0]
            if a is not None:
                asc = a
                nulls_first = asc
            orders.append(L.SortOrder(AN.resolve(u, self.schema), asc,
                                      nulls_first))
        return self._derive(L.Sort(self._plan, orders))

    sort = orderBy

    def limit(self, n: int) -> "DataFrame":
        return self._derive(L.Limit(self._plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        """Every row of both, by position, under this DataFrame's schema
        (Spark's ``union`` keeps duplicates)."""
        if len(other.schema) != len(self.schema):
            raise AN.AnalysisException("union: column count mismatch")
        return self._derive(L.Union([self._plan, other._plan]))

    unionAll = union

    def sample(self, withReplacement=None, fraction=None, seed=None
               ) -> "DataFrame":
        """Bernoulli sample, in pyspark's three forms: ``sample(fraction)``,
        ``sample(fraction, seed)`` and ``sample(withReplacement,
        fraction, seed)``; a keyword ``seed=`` wins over the positional
        one.  Without a seed, a random one is drawn."""
        if isinstance(withReplacement, float):
            s2 = seed if seed is not None else fraction
            withReplacement, fraction, seed = (
                False, withReplacement, None if s2 is None else int(s2))
        if withReplacement:
            raise NotImplementedError(
                "sample(withReplacement=True) is not supported")
        if fraction is None or not (0.0 <= fraction <= 1.0):
            raise AN.AnalysisException(
                f"sample fraction must be in [0, 1], got {fraction}")
        if seed is None:
            seed = random.randint(0, 2**31 - 1)
        return self._derive(L.Sample(self._plan, float(fraction),
                                     int(seed)))

    def repartition(self, num: int, *cols) -> "DataFrame":
        """``num`` partitions: by the Spark murmur3 hash of ``cols``, or
        round robin without keys."""
        keys = [AN.resolve(_to_column(c)._u, self.schema)
                for c in cols] or None
        return self._derive(L.Repartition(self._plan, num, keys))

    def distinct(self) -> "DataFrame":
        return self.groupBy(*self.columns).agg()

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
        return self._adopt_structs(self._derive(L.Join(
            self._plan, other._plan, how, left_keys, right_keys, None,
            T.StructType(tuple(fields)))), other)

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
        return self._adopt_structs(self._derive(L.Join(
            self._plan, other._plan, how, left_keys, right_keys, residual,
            T.StructType(tuple(fields)), using=False)), other)

    # -- actions ----------------------------------------------------------
    def _rewrite(self) -> OverrideResult:
        conf = self.session.rapids_conf()
        cpu = plan_physical(optimize(self._plan, conf), conf)
        return apply_overrides(cpu, conf, self.session.device)

    def _execute_plan(self) -> ExecNode:
        t0 = time.perf_counter()
        result = self._rewrite()
        self._last_override = result
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        return result.plan

    def fallback_summary(self) -> dict:
        """Device-vs-fallback operator counts for the last planned
        execution (the reference's explain=NOT_ON_GPU signal as a
        metric [REF: ExplainPlanImpl])."""
        if self._last_override is None:
            self._execute_plan()
        return self._last_override.fallback_summary()

    def explain(self, extended: bool = False) -> None:
        """``explain()`` prints the physical plan (device nodes starred);
        ``explain(True)`` adds the fallback report;
        ``explain("metrics")`` prints the last execution's per-node
        metrics (at the configured level) and, when tracing was on, the
        per-operator self/total-time rollup; ``explain("analyze")``
        executes the query if needed and prints the plan tree annotated
        with the observed per-operator stats (rows/batches/bytes,
        exchange skew) and traced self times."""
        if isinstance(extended, str) and extended.lower() == "metrics":
            return self._explain_metrics()
        if isinstance(extended, str) and extended.lower() == "analyze":
            return self._explain_analyze()
        result = self._rewrite()
        print(result.plan.tree_string())
        if extended:
            for line in result.fallback_report():
                print(line)

    def _explain_metrics(self) -> None:
        plan = self._last_plan
        if plan is None:
            print("<no execution yet — run collect()/toArrow() first>")
            return
        print(plan.tree_string())
        for op, vals in self.metrics():
            shown = {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in vals.items()}
            print(f"  {op}: {shown}")
        rollup = self._last_rollup
        if rollup:
            print("-- per-op time attribution (traced) --")
            for op, r in sorted(rollup.items(),
                                key=lambda kv: -kv[1]["self_s"]):
                print(f"  {op}: self={r['self_s']:.6f}s "
                      f"total={r['total_s']:.6f}s spans={r['spans']}")

    @staticmethod
    def _fmt_bytes(n) -> str:
        n = float(n)
        for unit in ("B", "KiB", "MiB", "GiB"):
            if n < 1024 or unit == "GiB":
                return (f"{int(n)}{unit}" if unit == "B"
                        else f"{n:.1f}{unit}")
            n /= 1024
        return f"{n:.1f}GiB"

    def _explain_analyze(self) -> None:
        """EXPLAIN ANALYZE: run the query (with stats and tracing on for
        this execution when it has not run with stats yet), then print
        the plan tree with each operator's observed statistics."""
        from spark_rapids_tpu_torch import conf as C
        profile = self._last_profile
        if profile is None:
            saved = {}
            for key in (C.STATS_ENABLED.key, C.TRACE_ENABLED.key):
                saved[key] = self.session.conf.get(key, None)
                self.session.conf.set(key, True)
            try:
                self.toArrow()
            finally:
                for key, old in saved.items():
                    if old is None:
                        self.session.conf.unset(key)
                    else:
                        self.session.conf.set(key, old)
            profile = self._last_profile
        if profile is None:
            # a concurrent query owns the collector (nested execution)
            print("<stats unavailable — another query owns the stats "
                  "plane; re-run when it finishes>")
            return
        by_path = {r["path"]: r for r in profile["ops"]
                   if "fused_region" not in r}
        lines = []

        def walk(node, path, depth):
            rec = by_path.get(path, {})
            ann = (f"rows={rec.get('rows_out', 0)} "
                   f"batches={rec.get('batches_out', 0)} "
                   f"bytes={self._fmt_bytes(rec.get('bytes_out', 0))}")
            if rec.get("self_s") is not None:
                ann += (f" self={rec['self_s']:.6f}s"
                        f" total={rec['total_s']:.6f}s")
            parts = rec.get("partition_rows",
                            rec.get("partition_bytes"))
            if parts is not None:
                ann += (f" partitions={len(parts)}"
                        f" skew={rec.get('skew_factor', 1.0):.2f}")
                if rec.get("skewed"):
                    ann += " SKEWED"
                if rec.get("executors", 1) > 1:
                    ann += f" executors={rec['executors']}"
            if rec.get("fused"):
                ann += " fused"
            if rec.get("region_ops"):
                ann += f" region_ops={rec['region_ops']}"
                if rec.get("region_compile_s") is not None:
                    ann += f" compile={rec['region_compile_s']:.6f}s"
            if rec.get("kernel_backend"):
                ann += f" kernel={rec['kernel_backend']}"
            if rec.get("adaptive"):
                labels = []
                for d in rec["adaptive"]:
                    kind = d.get("kind")
                    if kind == "skew-split":
                        labels.extend(
                            f"skew-split({k})"
                            for k in d.get("splits", ()) or ("?",))
                    elif kind == "batch-retarget":
                        labels.append(
                            f"batch-retarget({d.get('target_rows')})")
                    else:
                        labels.append(str(kind))
                ann += " adaptive=" + ",".join(labels)
            lines.append("  " * depth
                         + ("*" if node.is_tpu else "")
                         + node.node_string() + f"  [{ann}]")
            for i, c in enumerate(node.children):
                walk(c, f"{path}.{i}", depth + 1)

        walk(self._last_plan, "0", 0)
        print("\n".join(lines))
        if profile.get("wall_s") is not None:
            print(f"-- wall {profile['wall_s']:.6f}s "
                  f"(query {profile['query_id']}, "
                  f"stats level {profile['level']}) --")

    def toArrow(self, timeout_ms: Optional[float] = None) -> pa.Table:
        """Execute and return the result as an Arrow table.

        ``timeout_ms`` puts an in-process deadline on this execution
        (overriding ``spark.rapids.tpu.query.timeoutMs``): when it
        expires, every blocking boundary raises
        ``QueryCancelled(reason="deadline")``, and the query's resources
        are reclaimed before the exception reaches the caller.

        The execution runs inside the JAX package's query window: a
        telemetry window (counter deltas and health verdicts), a tracer
        (with ``spark.rapids.sql.trace.enabled`` or attribution, which is
        on by default), the flight recorder, the stats collector (with
        ``spark.rapids.tpu.stats.enabled``) and, with
        ``spark.rapids.profile.enabled``, a ``torch.profiler`` capture
        into ``<profile.path>/query-<id>``.

        With ``spark.rapids.tpu.cache.enabled``, the result cache is
        consulted first (``cache/``): a hit hands back the resident
        Arrow table — no partition pump, no device permit, no launch —
        while the query window still runs, so the event-log entry
        carries ``cache.status="hit"``.  A query whose inputs cannot be
        fingerprinted runs uncached."""
        from spark_rapids_tpu_torch import conf as C
        from spark_rapids_tpu_torch.runtime import attribution as attr_mod
        from spark_rapids_tpu_torch.runtime import cancel
        from spark_rapids_tpu_torch.runtime import resilience
        from spark_rapids_tpu_torch.runtime import stats as stats_mod
        from spark_rapids_tpu_torch.runtime import telemetry, trace
        conf = self.session.rapids_conf()
        plan = self._execute_plan()
        self._last_plan = plan
        cache_store = ckey = None
        if conf.get(C.CACHE_ENABLED):
            from spark_rapids_tpu_torch import cache as cache_mod
            cache_store = cache_mod.get_cache(conf)
            try:
                ckey = cache_mod.result_key(self._plan, plan, conf)
            except Exception:
                # unkeyable inputs (a vanished scan file): run uncached
                cache_store = None
        qid = trace.next_query_id()
        qwin = telemetry.begin_query(qid)
        rwin = resilience.begin_query(qid)
        cwin = cancel.begin_query(qid, conf, timeout_ms=timeout_ms)
        # the attribution plane rides the tracer: with attribution on
        # (the default) the tracer runs even with tracing off, and
        # _record_query emits the rollup and the trace file only when
        # tracing was asked for
        attr_on = bool(conf.get(C.ATTRIBUTION_ENABLED))
        tracer = None
        if conf.get(C.TRACE_ENABLED) or attr_on:
            tracer = trace.start_query(
                qid, max_events=int(conf.get(C.QUERY_LOG_MAX_EVENTS)))
        arec = None
        if attr_on:
            arec = attr_mod.start_query(
                qid, ring_size=int(conf.get(C.ATTRIBUTION_RING_SIZE)))
            if tracer is not None and arec is not None:
                tracer.recorder = arec
        collector = None
        if conf.get(C.STATS_ENABLED):
            collector = stats_mod.start_query(
                qid, level=str(conf.get(C.STATS_LEVEL)),
                skew_threshold=float(conf.get(C.STATS_SKEW_THRESHOLD)))
        profile = contextlib.nullcontext()
        profile_dir = None
        if conf.get(C.PROFILE_ENABLED):
            profile_dir = os.path.join(str(conf.get(C.PROFILE_PATH)),
                                       f"query-{qid:06d}")
            profile = profile_capture(self.session.device, profile_dir)
        root = (tracer.span("Query", "execute")
                if tracer is not None else contextlib.nullcontext())
        error = cancelled = None
        cache_info = flight = None
        try:
            with profile, root:
                served = None
                if cache_store is not None:
                    with trace.span("ResultCache", "cacheProbe"):
                        served = cache_store.lookup(ckey.key)
                        if served is None:
                            role, fl = cache_store.join_flight(ckey.key)
                            if role == "leader":
                                flight = fl
                                fl.leader_qid = qid
                            else:
                                # another execution of this key is in
                                # progress: wait for it, then re-probe;
                                # compute here if it stored nothing
                                while not fl.done.wait(0.05):
                                    cancel.check()
                                served = cache_store.lookup(ckey.key)
                                if served is not None:
                                    cache_info = {"coalesced": True}
                if served is not None:
                    out = served.value
                    cache_info = {
                        "status": "hit", "key": served.key,
                        "signature": served.sig,
                        "bytes": served.nbytes,
                        "saved_s": round(served.runtime_s, 6),
                        "age_s": round(
                            time.monotonic() - served.created, 6),
                        **(cache_info or {})}
                else:
                    t_exec = time.perf_counter()
                    tables = self._pump_partitions(plan, conf,
                                                   self.session.device)
                    with trace.span("Result", "concatTime"):
                        if not tables:
                            out = pa.table(
                                [pa.array([], type=T.to_arrow(f.dtype))
                                 for f in self.schema.fields],
                                names=self.columns)
                        else:
                            out = pa.concat_tables(tables)
                        out = self._reassemble_structs(out)
                    if cache_store is not None:
                        runtime_s = time.perf_counter() - t_exec
                        cache_store.note_miss()
                        with trace.span("ResultCache", "cacheServe"):
                            stored = cache_store.put(
                                ckey, out, out.nbytes, runtime_s)
                        cache_info = {
                            "key": ckey.key, "signature": ckey.sig,
                            "bytes": out.nbytes,
                            "runtime_s": round(runtime_s, 6), **stored}
        except cancel.QueryCancelled as e:
            cancelled = e
            error = f"{type(e).__name__}: {e}"
            # the cancelled pumps abandoned their registered spillables:
            # close them all, so that the device accounting unwinds and
            # the disk spill files are unlinked
            from spark_rapids_tpu_torch.runtime import memory
            mgr = memory.peek_manager()
            if mgr is not None:
                mgr.reclaim_all()
            raise
        except BaseException as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            if flight is not None:
                # wake single-flight followers even on failure: they
                # re-probe and compute for themselves
                cache_store.finish_flight(ckey.key, flight)
            trace.end_query(tracer)
            stats_mod.end_query(collector)
            attr_mod.end_query(arec)
            res = resilience.finish_query(rwin)
            cancel.finish_query(cwin)
            if rwin is not None:  # nested executions record nothing
                self._record_query(qid, conf, error, res, cancelled, cwin,
                                   tracer=tracer, qwin=qwin,
                                   collector=collector, recorder=arec,
                                   profile_dir=profile_dir,
                                   cache_info=cache_info)
        return out

    def _reassemble_structs(self, t: pa.Table) -> pa.Table:
        """The physical field columns -> the logical Arrow struct
        columns, each at its first field's place (the inverse of the
        session's ``_decompose_structs``)."""
        for sname, spec in self._structs.items():
            names = t.column_names
            if not all(p in names for _, p in spec.fields):
                continue

            def one_chunk(c):
                return (pa.array([], type=c.type) if c.num_chunks == 0
                        else pa.concat_arrays(c.chunks))

            mask = None
            if spec.null_col and spec.null_col in names:
                mask = one_chunk(t.column(spec.null_col))
            sa = pa.StructArray.from_arrays(
                [one_chunk(t.column(p)) for _, p in spec.fields],
                names=[f for f, _ in spec.fields], mask=mask)
            drop = set(spec.phys_cols)
            arrays, out_names = [], []
            for n in names:
                if n == spec.fields[0][1]:
                    arrays.append(sa)
                    out_names.append(sname)
                if n not in drop:
                    arrays.append(t.column(n))
                    out_names.append(n)
            t = pa.table(dict(zip(out_names, arrays)))
        return t

    def _record_query(self, qid, conf, error, res, cancelled, ctoken,
                      tracer=None, qwin=None, collector=None,
                      recorder=None, profile_dir=None,
                      cache_info=None) -> None:
        """One event-log entry per execution, the JAX package's: plan
        tree, fallback report, every metric at its level, the span
        rollup, the attribution ledger, the telemetry deltas and health
        verdicts, the semaphore window, the resilience rollup, the stats
        profile and the links to the trace, profile and black box.
        Kept in ``query_history`` and appended to
        ``spark.rapids.sql.queryLog.path``."""
        from spark_rapids_tpu_torch import conf as C
        from spark_rapids_tpu_torch.runtime import attribution as attr_mod
        from spark_rapids_tpu_torch.runtime import stats as stats_mod
        from spark_rapids_tpu_torch.runtime import telemetry, trace
        from spark_rapids_tpu_torch.runtime.semaphore import peek_semaphore
        plan = self._last_plan
        entry = {
            "query_id": qid,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "status": ("cancelled" if cancelled is not None
                       else "error" if error else "ok"),
            "plan": plan.tree_string(),
            "metrics": trace.plan_metrics(plan),
        }
        if error:
            entry["error"] = error
        if cache_info is not None:
            # result-cache outcome: status hit|stored|uncached, with
            # key/signature/bytes and saved_s (hit) or runtime_s (miss)
            entry["cache"] = cache_info
        if cancelled is not None:
            cinfo = {"reason": cancelled.reason}
            if ctoken is not None:
                if ctoken.latency_s is not None:
                    cinfo["latency_s"] = round(ctoken.latency_s, 6)
                if ctoken.detail:
                    cinfo["detail"] = ctoken.detail
            entry["cancel"] = cinfo
        override = self._last_override
        if override is not None:
            entry["fallback"] = override.fallback_summary()
            entry["fallback_report"] = override.fallback_report()
        if tracer is not None and conf.get(C.TRACE_ENABLED):
            # trace artifacts only when tracing was asked for: an
            # attribution-only tracer feeds the ledger below
            entry["wall_s"] = round(tracer.wall_s, 6)
            rollup = tracer.rollup()
            entry["op_rollup"] = rollup
            entry["dropped_spans"] = tracer.dropped
            self._last_rollup = rollup
            tf = trace.write_chrome_trace(str(conf.get(C.TRACE_PATH)),
                                          tracer)
            if tf:
                entry["trace_file"] = tf
        attribution = None
        if tracer is not None and conf.get(C.ATTRIBUTION_ENABLED):
            attribution = attr_mod.attribute(
                tracer, tolerance=float(
                    conf.get(C.ATTRIBUTION_CLOSE_TOLERANCE)))
            entry["attribution"] = attribution
            attr_mod.note_unaccounted(attribution["unaccounted_s"])
        if profile_dir:
            entry["profile_dir"] = profile_dir
        if qwin is not None:
            deltas, elapsed = qwin.finish()
            entry["telemetry"] = deltas
            health = telemetry.evaluate_health(deltas, elapsed, conf,
                                               query_id=qid)
            if health:
                entry["health"] = health
        sem = peek_semaphore()
        if sem is not None:
            sw = sem.end_query_stats(qid)
            if sw is not None:
                entry["semaphore"] = {
                    "max_holders": sw["max_holders"],
                    "wait_s": round(sw["wait_time"], 6)}
        if res is not None:
            entry["resilience"] = res
            # runtime degradations join the plan-time fallback report
            entry.setdefault("fallback_report", []).extend(
                f"!{d['op']} degraded to the host path at runtime "
                f"[{d['domain']}] because {d['cause']}"
                for d in res["degraded_ops"])
        if collector is not None:
            profile = collector.report(
                plan, rollup=entry.get("op_rollup"),
                wall_s=entry.get("wall_s"))
            profile["ts"] = entry["ts"]
            profile["status"] = entry["status"]
            if attribution is not None:
                profile["attribution"] = attribution
            entry["op_stats"] = profile["ops"]
            if profile["exchanges"]:
                entry["exchange_stats"] = profile["exchanges"]
            self._last_profile = profile
            self.session._last_profile = profile
            store = str(conf.get(C.STATS_STORE_PATH))
            if store:
                stats_mod.append_profile(store, profile)
        if recorder is not None:
            # a bad exit leaves the black box: a deadline, a cancel, an
            # error, or a health WARN on an otherwise good run
            trigger = None
            if cancelled is not None:
                trigger = ("timeout" if cancelled.reason == "deadline"
                           else "cancel")
            elif error:
                trigger = "error"
            elif entry.get("health"):
                trigger = "health"
            bb_dir = str(conf.get(C.ATTRIBUTION_BLACKBOX_PATH))
            if trigger is not None and bb_dir:
                extra = {k: entry[k] for k in
                         ("status", "error", "cancel", "health")
                         if entry.get(k)}
                path = attr_mod.dump_blackbox(
                    bb_dir, qid, trigger, attribution=attribution,
                    recorder=recorder, extra=extra,
                    max_dumps=int(conf.get(C.ATTRIBUTION_BLACKBOX_MAX)))
                if path:
                    entry["blackbox"] = path
        self._last_query_entry = entry
        self.session._record_query(entry)
        log_path = str(conf.get(C.QUERY_LOG_PATH))
        if log_path:
            trace.append_query_log(log_path, entry)

    @staticmethod
    def _pump_partitions(plan, conf, device) -> List[pa.Table]:
        """Execute every partition.  A plan with device work runs its
        partitions on a task pool (the Spark-task-slot analog), each
        task holding a permit of the device semaphore [REF:
        GpuSemaphore.scala] — permits =
        ``spark.rapids.sql.concurrentGpuTasks``; a plan without pumps
        its partitions one after another on this thread.

        Every task runs on this thread's current CUDA stream, so that
        the query's kernels queue on one stream in the order they are
        launched (a new thread starts on the default stream); the
        tasks overlap their host work.  Each task also binds the
        query's cancel token, so that every blocking boundary under it
        (semaphore, retry backoff, spill IO, shuffle) polls that query's
        token and charges that query's resilience scope."""
        from spark_rapids_tpu_torch import conf as C
        from spark_rapids_tpu_torch.exec.base import TpuExec
        from spark_rapids_tpu_torch.parallel.executor import run_pump_tasks
        from spark_rapids_tpu_torch.runtime import cancel, scheduler, trace

        def has_device_work(node) -> bool:
            return isinstance(node, TpuExec) or any(
                has_device_work(c) for c in node.children)

        def pump(p: int) -> List[pa.Table]:
            # per-partition envelope span: iterator plumbing and the
            # root's Arrow conversion (the time between instrumented
            # stages) go to the pump_idle bucket
            with trace.span("PumpTask", "pumpTask", {"partition": p}):
                return [H.to_arrow_table(b) for b in plan.execute(p)]

        parts = list(range(plan.num_partitions()))
        if not has_device_work(plan):
            return [t for p in parts for t in pump(p)]

        waits: List[float] = []  # this query's waits only
        from spark_rapids_tpu_torch.parallel.executor import get_executor
        if get_executor() is not None:
            # multi-executor: every process must enter each collective
            # in the SAME order — materialize exchanges sequentially
            # (children first = execution-dependency order) before the
            # parallel pump, then pump only partitions whose rank is
            # local to this process
            from spark_rapids_tpu_torch.exec.distributed import (
                TpuIciShuffleExchangeExec, owned_partitions)

            def pre_materialize(node):
                for c in node.children:
                    pre_materialize(c)
                if isinstance(node, TpuIciShuffleExchangeExec):
                    node._materialize()

            with scheduler.device_hold(conf, waited_out=waits):
                pre_materialize(plan)
            parts = owned_partitions(plan)
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        tok = cancel.current()

        def task(p: int) -> List[pa.Table]:
            # torch.cuda.stream(None) changes nothing (a CPU session)
            with cancel.bind(tok), \
                    scheduler.device_hold(conf, waited_out=waits), \
                    torch.cuda.stream(stream):
                return pump(p)

        # a single task still holds a permit: a 1-partition query counts
        # against the concurrency cap like any other
        permits = int(conf.get(C.CONCURRENT_TASKS) or 2)
        workers = min(len(parts), max(permits * 2, 4))
        chunks = run_pump_tasks(task, parts, max_workers=workers)
        plan.metric("semaphoreWaitTime").add(sum(waits))
        return [t for chunk in chunks for t in chunk]

    def metrics(self, level: Optional[str] = None):
        """Operator metrics of the last execution, root first, filtered
        by ``spark.rapids.sql.metrics.level`` (or an explicit level)."""
        if self._last_plan is None:
            raise RuntimeError("no execution yet — run collect()/toArrow()")
        if level is None:
            from spark_rapids_tpu_torch import conf as C
            level = self.session.rapids_conf().get(C.METRICS_LEVEL)
        return self._last_plan.collect_metrics(level=str(level))

    def collect(self, timeout_ms: Optional[float] = None) -> List[Row]:
        """Collect rows; ``timeout_ms`` deadlines the execution
        in-process (``QueryCancelled(reason="deadline")`` on expiry)."""
        tbl = self.toArrow(timeout_ms=timeout_ms)
        names = tuple(tbl.column_names)
        cols = [tbl.column(i).to_pylist() for i in range(tbl.num_columns)]
        return [Row(vals, names) for vals in zip(*cols)] if cols else []

    def count(self) -> int:
        return self.toArrow().num_rows

    def toPandas(self):
        return self.toArrow().to_pandas()

    def show(self, n: int = 20, truncate: bool = True):
        print(self.limit(n).toArrow().to_pandas().to_string())

    @property
    def write(self):
        from spark_rapids_tpu_torch.io.readers import DataFrameWriter
        return DataFrameWriter(self)



class GroupedData:
    def __init__(self, df: DataFrame, grouping, names):
        self.df = df
        self.grouping = grouping
        self.names = names
        self.sets = None  # grouping sets (rollup/cube); None = plain

    @staticmethod
    def _pandas_agg_u(a):
        """(the UExpr, its vectorized pyudf core) of a grouped-aggregate
        pandas UDF under an optional alias, or None."""
        u = _to_column(a)._u
        core = u.children[0] if u.op == "alias" else u
        if core.op == "pyudf" and core.payload[2]:  # vectorized
            return u, core
        return None

    def agg(self, *aggs) -> DataFrame:
        if any(self._pandas_agg_u(a) is not None for a in aggs):
            return self._agg_in_pandas(aggs)
        fns = []
        names = []
        for a in aggs:
            fn, name = AN.resolve_aggregate(_to_column(a)._u,
                                            self.df.schema)
            fns.append(fn)
            names.append(name)
        if any(isinstance(f, A.CountDistinct) for f in fns):
            if self.sets is not None:
                raise AN.AnalysisException(
                    "count(DISTINCT) under rollup/cube is not yet "
                    "supported")
            return self._agg_distinct(fns, names)
        if self.sets is not None:
            return self._agg_grouping_sets(fns, names)
        fields = [T.StructField(n, g.dtype)
                  for n, g in zip(self.names, self.grouping)]
        fields += [T.StructField(n, f.result_dtype)
                   for n, f in zip(names, fns)]
        return self.df._derive(L.Aggregate(
            self.df._plan, self.grouping, fns, T.StructType(tuple(fields))))

    def _agg_in_pandas(self, aggs) -> DataFrame:
        """Grouped-aggregate pandas UDFs [REF: GpuAggregateInPandasExec],
        lowered onto the grouped-map bridge: each agg fn(*series) ->
        scalar runs per group inside one applyInPandas wrapper (device
        co-partitioning and the arrow bridge come with it)."""
        import pandas as pd
        if self.sets is not None:
            raise AN.AnalysisException(
                "pandas-UDF aggregates under rollup/cube are not "
                "supported")
        if not self.names:
            # a global pandas-UDF aggregate: one row — group on a
            # constant key, then drop it
            from spark_rapids_tpu_torch.sql.functions import lit
            return (self.df.withColumn("__g", lit(0))
                    .groupBy("__g").agg(*aggs).drop("__g"))
        child_names = set(self.df.schema.field_names())
        for n in self.names:
            if n not in child_names:
                raise AN.AnalysisException(
                    "pandas-UDF aggregates need plain column grouping "
                    f"keys (got expression {n!r})")
        specs = []
        for i, a in enumerate(aggs):
            got = self._pandas_agg_u(a)
            if got is None:
                raise AN.AnalysisException(
                    "cannot mix pandas-UDF aggregates with built-in "
                    "aggregate functions in one agg() — split into two "
                    "aggregations and join")
            u, core = got
            fn, dt, _vec, fname = core.payload
            out_name = u.payload if u.op == "alias" else f"{fname}_{i}"
            arg_names = []
            for cu in core.children:
                if cu.op != "attr" or cu.payload not in child_names:
                    raise AN.AnalysisException(
                        "pandas-UDF aggregate arguments must be plain "
                        "columns (pre-compute expressions with "
                        "withColumn)")
                arg_names.append(cu.payload)
            specs.append((fn, dt, out_name, arg_names))
        key_names = list(self.names)
        by_name = {f.name: f for f in self.df.schema.fields}
        fields = [T.StructField(n, by_name[n].dtype) for n in key_names]
        fields += [T.StructField(n, dt) for _, dt, n, _ in specs]
        schema = T.StructType(tuple(fields))

        def wrapper(pdf):
            row = {k: [pdf[k].iloc[0]] for k in key_names}
            for fn, _dt, name, arg_names in specs:
                row[name] = [fn(*[pdf[an] for an in arg_names])]
            return pd.DataFrame(row)

        return self.applyInPandas(wrapper, schema)

    def applyInPandas(self, fn, schema) -> DataFrame:
        """Grouped-map pandas UDF: fn(pandas.DataFrame) -> DataFrame per
        group.  Rides a hash exchange on the keys into
        ``spark.sql.shuffle.partitions`` partitions, so that one group
        never splits [REF: GpuFlatMapGroupsInPandasExec]."""
        if not isinstance(schema, T.StructType):
            raise AN.AnalysisException(
                "applyInPandas needs a StructType output schema")
        if self.sets is not None:
            raise AN.AnalysisException(
                "applyInPandas is not supported under rollup/cube")
        key_indices = []
        for g in self.grouping:
            if not isinstance(g, BoundReference):
                raise AN.AnalysisException(
                    "applyInPandas grouping keys must be plain columns")
            key_indices.append(g.index)
        nparts = self.df.session.rapids_conf().shuffle_partitions
        shuffled = L.Repartition(self.df._plan, nparts,
                                 list(self.grouping))
        return DataFrame(self.df.session, L.FlatMapGroupsInPandas(
            shuffled, key_indices, fn, schema))

    def _agg_grouping_sets(self, fns, names) -> DataFrame:
        """rollup/cube: Spark's ResolveGroupingAnalytics shape — an
        Expand (the child's columns, each key or a null in its place,
        and the grouping id), an aggregate over the keys and ``_gid``,
        and a project that drops ``_gid``.  ``_gid`` keeps a rolled-up
        null apart from a null key."""
        child_schema = self.df.schema
        nc = len(child_schema)
        nk = len(self.grouping)
        projections = []
        for s in self.sets:
            inc = set(s)
            proj = [BoundReference(i, f.dtype, f.nullable)
                    for i, f in enumerate(child_schema.fields)]
            for i, g in enumerate(self.grouping):
                proj.append(g if i in inc else E.Literal(None, g.dtype))
            # Spark's grouping_id: bit (nk-1-i) set when key i is NOT in
            # the grouping set
            gid = sum(1 << (nk - 1 - i) for i in range(nk)
                      if i not in inc)
            proj.append(E.Literal(gid, T.IntegerT))
            projections.append(proj)
        ex_fields = (list(child_schema.fields)
                     + [T.StructField(f"_g{i}", g.dtype, True)
                        for i, g in enumerate(self.grouping)]
                     + [T.StructField("_gid", T.IntegerT, False)])
        expand = L.Expand(self.df._plan, projections,
                          T.StructType(tuple(ex_fields)))
        grouping = [BoundReference(nc + i, g.dtype, True)
                    for i, g in enumerate(self.grouping)]
        grouping.append(BoundReference(nc + nk, T.IntegerT, False))
        key_fields = [T.StructField(n, g.dtype, True)
                      for n, g in zip(self.names, self.grouping)]
        agg_fields = [T.StructField(n, f.result_dtype)
                      for n, f in zip(names, fns)]
        agg = L.Aggregate(expand, grouping, fns, T.StructType(tuple(
            key_fields + [T.StructField("_gid", T.IntegerT, False)]
            + agg_fields)))
        exprs = ([BoundReference(i, g.dtype, True)
                  for i, g in enumerate(self.grouping)]
                 + [BoundReference(nk + 1 + i, f.result_dtype)
                    for i, f in enumerate(fns)])
        return self.df._derive(L.Project(
            agg, exprs, T.StructType(tuple(key_fields + agg_fields))))

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

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self.agg(F.count("*").alias("count"))

    def _simple(self, kind, *cols) -> DataFrame:
        """``kind`` of each named column, or of every numeric column
        that is not a grouping key."""
        from spark_rapids_tpu_torch.sql import functions as F
        targets = cols or [
            f.name for f in self.df.schema.fields
            if T.is_numeric(f.dtype) and f.name not in self.names]
        fn = getattr(F, kind)
        return self.agg(*[fn(col(c)).alias(f"{kind}({c})")
                          for c in targets])

    def sum(self, *cols) -> DataFrame:
        return self._simple("sum", *cols)

    def min(self, *cols) -> DataFrame:
        return self._simple("min", *cols)

    def max(self, *cols) -> DataFrame:
        return self._simple("max", *cols)

    def avg(self, *cols) -> DataFrame:
        return self._simple("avg", *cols)

    mean = avg
