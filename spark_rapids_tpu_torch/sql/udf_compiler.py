"""Python UDF -> expression compiler.

[REF: udf-compiler/src/main/scala/com/nvidia/spark/udf ::
 CatalystExpressionBuilder, LambdaReflection] — the reference decompiles
JVM bytecode of simple Scala lambdas into Catalyst expressions so that
"UDFs" run as native GPU kernels.  The counterpart of the JAX package's
``sql/udf_compiler.py``: it inspects the *source AST* of a Python
lambda or def and lowers it onto the port's Expression tree, so that a
compiled UDF never crosses the arrow bridge; it runs on the device with
the surrounding expressions like any built-in one.

Supported subset (same spirit as the reference's opcode whitelist):
* arithmetic  + - * / % ** on arguments/constants (``%`` with Python's
  sign rule, built from the engine's Java-sign ``Remainder``)
* comparisons  == != < <= > >=, boolean and/or/not
* conditional expressions  ``a if cond else b``
* calls to  abs, min, max (2-arg), int, float
* string methods  .upper() .lower() .strip()
* None-checks  ``x is None`` / ``x is not None``

Anything outside the subset raises ``UdfCompileError`` and the caller
falls back to the arrow-bridge UDF — opt-in via
``spark.rapids.sql.udfCompiler.enabled`` exactly like the reference.
Two lambdas on one source line do not compile: the source cannot say
which one a function object is.  A compiled form gives null where
Python would raise (``x % 0``) or see ``None``.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Dict, List

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import strings as S


class UdfCompileError(Exception):
    pass


def _fn_ast(fn: Callable):
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise UdfCompileError(f"no source available: {e}")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        # getsource returns a fragment for lambdas defined mid-expression
        raise UdfCompileError(f"source fragment does not parse: {e}")
    lambdas = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)]
    if getattr(fn, "__name__", "") == "<lambda>":
        if len(lambdas) != 1:
            # two lambdas on one source line: no way to tell which one
            # this function object is — compiling the wrong body would
            # be silent wrong results
            raise UdfCompileError(
                f"{len(lambdas)} lambdas share the source line; "
                "cannot disambiguate")
        return lambdas[0].args, lambdas[0].body
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            body = [st for st in node.body
                    if not isinstance(st, (ast.Expr,))
                    or not isinstance(st.value, ast.Constant)]
            if len(body) != 1 or not isinstance(body[0], ast.Return):
                raise UdfCompileError(
                    "only single-return functions compile")
            return node.args, body[0].value
    raise UdfCompileError("no lambda or def found in source")


_BINOPS = {
    ast.Add: E.Add, ast.Sub: E.Subtract, ast.Mult: E.Multiply,
}
_CMPOPS = {
    ast.Eq: E.EqualTo, ast.Lt: E.LessThan,
    ast.LtE: E.LessThanOrEqual, ast.Gt: E.GreaterThan,
    ast.GtE: E.GreaterThanOrEqual,
}


class _Lowerer:
    def __init__(self, params: Dict[str, E.Expression]):
        self.params = params

    def lower(self, node) -> E.Expression:
        from spark_rapids_tpu_torch.plan.analysis import (
            cast_to, common_type, literal)
        if isinstance(node, ast.Name):
            if node.id not in self.params:
                raise UdfCompileError(f"free variable {node.id!r}")
            return self.params[node.id]
        if isinstance(node, ast.Constant):
            if node.value is None:
                return E.Literal(None, T.NullT)
            return literal(node.value)
        if isinstance(node, ast.BinOp):
            l, r = self.lower(node.left), self.lower(node.right)
            if isinstance(node.op, ast.Div):
                return E.Divide(cast_to(l, T.DoubleT),
                                cast_to(r, T.DoubleT))
            if isinstance(node.op, ast.Pow):
                return E.Pow(cast_to(l, T.DoubleT),
                             cast_to(r, T.DoubleT))
            if isinstance(node.op, ast.Mod):
                return self._py_mod(l, r)
            cls = _BINOPS.get(type(node.op))
            if cls is None:
                raise UdfCompileError(
                    f"operator {type(node.op).__name__} not supported")
            ct = common_type(l.dtype, r.dtype)
            return cls(cast_to(l, ct), cast_to(r, ct))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return E.UnaryMinus(self.lower(node.operand))
            if isinstance(node.op, ast.Not):
                return E.Not(self._require_bool(
                    self.lower(node.operand), "not"))
            raise UdfCompileError("unary operator not supported")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise UdfCompileError("chained comparisons")
            op, right = node.ops[0], node.comparators[0]
            if isinstance(op, (ast.Is, ast.IsNot)):
                if not (isinstance(right, ast.Constant)
                        and right.value is None):
                    raise UdfCompileError("'is' only against None")
                inner = E.IsNull(self.lower(node.left))
                return E.Not(inner) if isinstance(op, ast.IsNot) \
                    else inner
            l, r = self.lower(node.left), self.lower(right)
            ct = common_type(l.dtype, r.dtype)
            l, r = cast_to(l, ct), cast_to(r, ct)
            if isinstance(l.dtype, T.StringType):
                if isinstance(op, ast.NotEq):
                    return E.Not(S.string_comparison("eq", l, r))
                kinds = {ast.Eq: "eq", ast.Lt: "lt", ast.LtE: "le",
                         ast.Gt: "gt", ast.GtE: "ge"}
                return S.string_comparison(kinds[type(op)], l, r)
            if isinstance(op, ast.NotEq):
                return E.Not(E.EqualTo(l, r))
            cls = _CMPOPS.get(type(op))
            if cls is None:
                raise UdfCompileError(
                    f"comparison {type(op).__name__} not supported")
            return cls(l, r)
        if isinstance(node, ast.BoolOp):
            parts = [self._require_bool(self.lower(v), "and/or")
                     for v in node.values]
            cls = E.And if isinstance(node.op, ast.And) else E.Or
            out = parts[0]
            for p in parts[1:]:
                out = cls(out, p)
            return out
        if isinstance(node, ast.IfExp):
            cond = self._require_bool(self.lower(node.test), "if/else")
            t, f = self.lower(node.body), self.lower(node.orelse)
            ct = common_type(t.dtype, f.dtype)
            return E.CaseWhen([(cond, cast_to(t, ct))], cast_to(f, ct))
        if isinstance(node, ast.Call):
            return self._call(node)
        raise UdfCompileError(
            f"AST node {type(node).__name__} not supported")

    @staticmethod
    def _require_bool(e: E.Expression, where: str) -> E.Expression:
        """Python truthiness over non-booleans (`1 if x else 0` with int
        x) has no columnar equivalent — the device And/CaseWhen are
        bitwise.  Outside booleans → fall back to the bridge."""
        if not isinstance(e.dtype, (T.BooleanType, T.NullType)):
            raise UdfCompileError(
                f"non-boolean condition in {where} (python truthiness "
                "does not compile)")
        return e

    def _py_mod(self, l: E.Expression, r: E.Expression) -> E.Expression:
        """Python % (sign follows divisor) from the engine's Java-sign
        Remainder: rem + divisor when signs disagree and rem != 0.
        (x % 0: python raises, the compiled form is null — same
        error-vs-null caveat as null inputs, see module docstring.)"""
        from spark_rapids_tpu_torch.plan.analysis import (
            cast_to, common_type, literal)
        ct = common_type(l.dtype, r.dtype)
        l, r = cast_to(l, ct), cast_to(r, ct)
        rem = E.Remainder(l, r)
        zero = cast_to(literal(0), ct)
        signs_differ = E.Or(
            E.And(E.LessThan(rem, zero), E.GreaterThan(r, zero)),
            E.And(E.GreaterThan(rem, zero), E.LessThan(r, zero)))
        return E.CaseWhen([(signs_differ, E.Add(rem, r))], rem)

    def _call(self, node: ast.Call) -> E.Expression:
        from spark_rapids_tpu_torch.plan.analysis import cast_to, common_type
        if isinstance(node.func, ast.Attribute):
            target = self.lower(node.func.value)
            meth = node.func.attr
            if not isinstance(target.dtype, T.StringType):
                raise UdfCompileError(
                    f"method .{meth}() on non-string")
            if node.args or node.keywords:
                raise UdfCompileError(f".{meth}() with arguments")
            if meth == "upper":
                return S.Upper(target)
            if meth == "lower":
                return S.Lower(target)
            if meth == "strip":
                return S.Trim(target, "both")
            raise UdfCompileError(f"string method .{meth}()")
        if isinstance(node.func, ast.Name):
            name = node.func.id
            args = [self.lower(a) for a in node.args]
            if name == "abs" and len(args) == 1:
                return E.Abs(args[0])
            if name in ("min", "max") and len(args) == 2:
                ct = common_type(args[0].dtype, args[1].dtype)
                a, b = cast_to(args[0], ct), cast_to(args[1], ct)
                cond = (E.LessThanOrEqual(a, b) if name == "min"
                        else E.GreaterThanOrEqual(a, b))
                return E.CaseWhen([(cond, a)], b)
            if name in ("int", "float") and len(args) == 1:
                dt = T.LongT if name == "int" else T.DoubleT
                return cast_to(args[0], dt) if args[0].dtype != dt \
                    else args[0]
            raise UdfCompileError(f"call to {name}() not supported")
        raise UdfCompileError("unsupported call form")


def compile_udf(fn: Callable, args: List[E.Expression],
                result_dtype: T.DataType) -> E.Expression:
    """Lower fn(*args) onto the expression tree, cast to the declared
    return type.  Raises UdfCompileError when outside the subset."""
    from spark_rapids_tpu_torch.plan.analysis import cast_to
    params, body = _fn_ast(fn)
    names = [a.arg for a in params.args]
    if params.vararg or params.kwonlyargs or params.kwarg:
        raise UdfCompileError("only plain positional parameters")
    if len(names) != len(args):
        raise UdfCompileError(
            f"UDF takes {len(names)} args, called with {len(args)}")
    expr = _Lowerer(dict(zip(names, args))).lower(body)
    if expr.dtype != result_dtype:
        # cast_to constant-folds Literal(None) onto the declared type,
        # so NullType results also land with the right column dtype
        expr = cast_to(expr, result_dtype)
    return expr
