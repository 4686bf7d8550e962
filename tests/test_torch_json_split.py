"""get_json_object and split in the port against the JAX package.

Both are evaluated on the host, as in the JAX package (a JSON document
and an ``array<string>`` have no device kernel there): the operator
that holds them falls back to the CPU and the plan rewrite reports it.

* Every case of ``tests/test_json_ops.py``: the six paths over
  well-formed, malformed, empty and null documents (under
  ``spark.rapids.sql.test.enabled``, ``Project`` and ``InMemoryScan``
  allowed on the CPU), the value semantics (a number serialized, a
  string unquoted, a JSON null, malformed input and a null document as
  null, objects and arrays compact), an invalid path, and the fallback
  report.
* The three split cases of ``tests/test_regex_strings.py`` (a split
  then its parts, ``limit`` 2, and ``limit`` 0 against -1: Java drops
  trailing empty strings only at 0).
* ``parse_json_path`` and ``extract_json_path`` equal the JAX package's
  on every path and document of the cases and on a few more.

Results (schema included), tree strings and fallback reports equal the
JAX package's exactly; the CPU sessions of both give equal results too.
"""

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import json_ops as JJ
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.ops import json_ops as PJ
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


DOCS = [  # tests/test_json_ops.py::DOCS
    '{"a": 1, "b": {"c": "x"}, "d": [1, 2, 3]}',
    '{"a": "str", "b": {}, "d": []}',
    '{"a": null}',
    'not json at all',
    '',
    None,
    '{"b": {"c": {"deep": true}}}',
    '[{"a": 10}, {"a": 20}]',
]
JT = pa.table({"j": pa.array(DOCS, pa.string())})
PATHS = ["$.a", "$.b.c", "$.d[1]", "$.missing", "$['b']['c']", "$[0].a"]
ALLOW = {"spark.rapids.sql.test.enabled": True,
         "spark.rapids.sql.test.allowedNonGpu": "Project,InMemoryScan"}
LOOSE = {"spark.rapids.sql.test.enabled": False}
HOST = {"spark.rapids.sql.enabled": False}

# name: (build(session, F, col), conf)
CASES = {f"get_json_object_paths[{p}]": (
    (lambda p: lambda s, F, c: s.createDataFrame(JT).select(
        F.get_json_object(c("j"), p).alias("r")))(p), ALLOW)
    for p in PATHS}
CASES.update({
    "get_json_object_semantics": (
        lambda s, F, c: s.createDataFrame(JT).select(
            F.get_json_object(c("j"), "$.a").alias("a"),
            F.get_json_object(c("j"), "$.b").alias("b"),
            F.get_json_object(c("j"), "$.d").alias("d")), LOOSE),
    "get_json_object_invalid_path_is_null": (
        lambda s, F, c: s.createDataFrame(JT).select(
            F.get_json_object(c("j"), "a.b").alias("r")), LOOSE),
    "split_then_explode": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "s": pa.array(["a,b,c", "x", "", "p,q"])})).select(
            F.split(c("s"), ",").alias("p")), LOOSE),
    "split_limit": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "s": pa.array(["a:b:c:d"])})).select(
            F.split(c("s"), ":", 2).alias("p")), LOOSE),
    "split_limit_zero_drops_trailing_empties": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "s": pa.array(["a,b,,", "x,"])})).select(
            F.split(c("s"), ",", 0).alias("p0"),
            F.split(c("s"), ",", -1).alias("pm")), LOOSE),
    "split_explode_word_count": (
        lambda s, F, c: s.createDataFrame(pa.table({
            "s": pa.array(["a b a", None, "", "b c", "a"])}))
        .select(F.explode(F.split(c("s"), " ")).alias("w"))
        .groupBy("w").count(),
        dict(ALLOW, **{"spark.rapids.sql.test.allowedNonGpu":
                       "Generate"})),
})


@pytest.fixture(scope="module")
def jax_run():
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol).toArrow(), None, None)
            else:
                df = build(JaxSession(dict(conf)), JF, jcol)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    assert got.schema == want.schema
    g = [repr(r) for r in got.to_pylist()]
    w = [repr(r) for r in want.to_pylist()]
    if not ordered:
        g, w = sorted(g), sorted(w)
    assert g == w


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    same_rows(got, want, ordered="count" not in name)
    assert df._last_override.fallback_report() == report
    assert report  # each falls back, as in the JAX package
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    same_rows(got, jax_run(name, host=True)[0],
              ordered="count" not in name)


def test_what_the_jax_tests_pin(jax_run):
    """The values ``tests/test_json_ops.py`` and the split cases of
    ``tests/test_regex_strings.py`` assert on their own."""
    out = jax_run("get_json_object_semantics")[0]
    a = out.column("a").to_pylist()
    assert a[0] == "1" and a[1] == "str"
    assert a[2] is None and a[3] is None and a[5] is None
    assert out.column("b").to_pylist()[0] == '{"c":"x"}'
    assert out.column("d").to_pylist()[0] == "[1,2,3]"
    assert jax_run("get_json_object_invalid_path_is_null")[0].column(
        "r").to_pylist() == [None] * len(DOCS)
    assert jax_run("split_then_explode")[0].column("p").to_pylist() == [
        ["a", "b", "c"], ["x"], [""], ["p", "q"]]
    assert jax_run("split_limit")[0].column("p").to_pylist() == [
        ["a", "b:c:d"]]
    out = jax_run("split_limit_zero_drops_trailing_empties")[0]
    assert out.column("p0").to_pylist() == [["a", "b"], ["x"]]
    assert out.column("pm").to_pylist() == [["a", "b", "", ""], ["x", ""]]


def test_get_json_object_reports_fallback():
    """``tests/test_json_ops.py::test_get_json_object_reports_fallback``:
    the summary counts the fallback and names the expression."""
    got = {}
    for name, s, Fn, c in (
            ("jax", JaxSession(dict(LOOSE)), JF, jcol),
            ("port", TpuSession(dict(LOOSE), device="cpu"), F, col)):
        df = s.createDataFrame(JT).select(
            Fn.get_json_object(c("j"), "$.a").alias("r"))
        df.toArrow()
        got[name] = fb = df.fallback_summary()
        assert fb["fallback_ops"] >= 1
        assert any("GetJsonObject" in r for r in fb["fallback_reasons"])
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("path", PATHS + [
    "$", "$.a[0][1]", "$[\"b\"]", "a.b", "", "$.", "$[x]", "$.a b"])
def test_json_path_functions_equal_jax(path):
    steps = PJ.parse_json_path(path)
    assert steps == JJ.parse_json_path(path)
    if steps is None:
        return
    for doc in DOCS + ['{"a": [[0, {"k": 1.00}]], "b": "é"}']:
        if doc is not None:
            assert PJ.extract_json_path(doc, steps) == \
                JJ.extract_json_path(doc, steps)
