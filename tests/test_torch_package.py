"""Rules of the PyTorch port as a package.

* No file of ``spark_rapids_tpu_torch/``, and neither ``chip_smoke.py``
  nor ``hash_pairs_ab.py``, imports ``jax`` or anything of
  ``spark_rapids_tpu`` (checked on the AST, so an import inside a
  function counts too).
* Entry points run on the card unless the caller asks for the CPU: a
  session created without ``device="cpu"`` raises when CUDA is
  unavailable.
* The ``spark.rapids.*`` conf is validated as the JAX package's is, and
  what the slice does not port raises ``NotImplementedError`` instead of
  running elsewhere; a bare limit runs on the device, with the JAX
  package's result and its empty fallback report.  The kill switches of
  the limits, union, range, sample, expand and window, and of the
  ``InputFileName`` and ``DeviceUDF`` expressions, are valid names, and
  each turned off falls back with the JAX package's reason.
"""

import ast
import pathlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    device_to_host, from_numpy_batch, host_to_device, pad_batch)
from spark_rapids_tpu_torch.runtime.device import resolve_device
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import Column, UExpr, col
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "hash_pairs_ab.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "spark_rapids_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_import_check_covers_the_join_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("exec/join.py", "exec/misc.py", "kernels/hash_join.py",
                "ops/strings.py", "utils/tpch.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_tpch_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "spark_rapids_tpu_torch/ops/datetime_ops.py" in names


def test_import_check_covers_the_scan_cache_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "spark_rapids_tpu_torch/runtime/memory.py" in names


def test_import_check_covers_the_failure_domain_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("runtime/cancel.py", "runtime/resilience.py",
                "runtime/faultinj.py", "runtime/lockdep.py",
                "utils/harness.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_overrides_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("plan/overrides.py", "columnar/host.py",
                "exec/transitions.py", "plan/planner.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_exchange_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("exec/exchange.py", "exec/aqe.py", "shuffle/__init__.py",
                "shuffle/serializer.py", "shuffle/manager.py",
                "shuffle/exchange.py", "native/__init__.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_strings_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("ops/regex_device.py", "ops/strings.py",
                "ops/expressions.py", "sql/functions.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_nested_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("ops/json_ops.py", "ops/aggregates.py", "exec/misc.py",
                "exec/aggregate.py", "sql/session.py", "sql/dataframe.py",
                "columnar/column.py", "plan/logical.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_operators_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("parallel/__init__.py", "parallel/shuffle.py",
                "exec/sort.py", "exec/misc.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_window_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("sql/window.py", "exec/window.py", "exec/aggregate.py",
                "plan/analysis.py", "plan/overrides.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_lakehouse_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("io/avro.py", "io/deletion_vectors.py", "io/delta.py",
                "io/iceberg.py", "io/parquet.py", "plan/optimizer.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


def test_import_check_covers_the_observability_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("runtime/trace.py", "runtime/telemetry.py",
                "runtime/stats.py", "runtime/attribution.py",
                "utils/profile.py", "utils/device_profile.py"):
        assert "spark_rapids_tpu_torch/" + mod in names, mod


@pytest.mark.parametrize("alias, build", [
    ("where", lambda df, c: df.where(c("a") > 1).select("a", "s")),
    ("groupby", lambda df, c: df.groupby("s").count()),
    ("sort", lambda df, c: df.sort(c("f").desc(), "a")),
])
def test_dataframe_aliases_equal_jax(alias, build):
    """``where``, ``groupby`` and ``sort`` are ``filter``, ``groupBy``
    and ``orderBy``, as in the JAX package: the same rows and plan."""
    from spark_rapids_tpu.sql.column import col as jcol
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    test = {"spark.rapids.sql.test.enabled": True}
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    name = {"where": "filter", "groupby": "groupBy", "sort": "orderBy"}
    assert getattr(DataFrame, alias) is getattr(DataFrame, name[alias])
    df = build(TpuSession(dict(test), device="cpu").createDataFrame(
        _table()), col)
    jdf = build(JaxSession(dict(test)).createDataFrame(_table()), jcol)
    got, want = df.toArrow(), jdf.toArrow()
    assert got.schema == want.schema
    rows = [repr(r) for r in got.to_pylist()]
    jrows = [repr(r) for r in want.to_pylist()]
    if alias == "groupby":
        rows, jrows = sorted(rows), sorted(jrows)
    assert rows == jrows and got.num_rows > 0
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()


def test_session_without_cpu_raises_when_cuda_is_unavailable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TpuSession()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TpuSession(device="cuda:0")
    assert TpuSession(device="cpu").device == torch.device("cpu")


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("conf, match", [
    ({"spark.rapids.tpu.noSuchKey": 1}, "unknown spark.rapids"),
    ({"spark.rapids.tpu.kernel.backend": "pallas"}, "invalid value"),
    ({"spark.rapids.tpu.batchRows": 0}, "invalid value"),
    ({"spark.rapids.sql.hasNans": "maybe"}, "cannot parse boolean"),
    ({"spark.rapids.memory.gpu.allocFraction": 1.5}, "invalid value"),
    ({"spark.rapids.tpu.memory.poolSize": "lots"}, "cannot parse byte"),
    ({"spark.rapids.sql.explain": "SOMETIMES"}, "invalid value"),
    ({"spark.rapids.sql.exec.Sort": "maybe"}, "cannot parse boolean"),
    ({"spark.rapids.sql.expression.Like": "off?"}, "cannot parse boolean"),
    ({"spark.sql.ansi.enabled": "perhaps"}, "cannot parse boolean"),
    ({"spark.rapids.sql.exec.SortExec": False}, "unknown spark.rapids"),
    ({"spark.rapids.sql.exec.CpuSortExec": False}, "unknown spark.rapids"),
    # ids kept from the slices that had no InputFileName and DeviceUDF:
    # both are kill switches of the UDF and file-scan slice
    pytest.param({"spark.rapids.sql.expression.InputFileName": False},
                 None, id="conf12-unknown spark.rapids"),
    pytest.param({"spark.rapids.sql.expression.DeviceUDF": False},
                 None, id="conf13-unknown spark.rapids"),
    ({"spark.rapids.shuffle.mode": "UCX"}, "invalid value"),
    ({"spark.rapids.tpu.exchange.mode": "sometimes"}, "invalid value"),
    ({"spark.rapids.shuffle.multiThreaded.writer.threads": "four"},
     "invalid literal"),
    ({"spark.sql.adaptive.enabled": "maybe"}, "cannot parse boolean"),
    ({"spark.sql.adaptive.advisoryPartitionSizeInBytes": "big"},
     "cannot parse byte"),
    # id kept from the slices before the distributed plane registered
    # the key: now its value is checked
    pytest.param({"spark.rapids.tpu.exchange.donate": "maybe"},
                 "cannot parse boolean", id="conf19-unknown spark.rapids"),
    ({"spark.rapids.tpu.retry.maxAttempts": 0}, "invalid value"),
    ({"spark.rapids.sql.agg.skipAggPassReductionRatio": 0.0},
     "invalid value"),
    ({"spark.rapids.memory.gpu.debug": "LOUD"}, "invalid value"),
    ({"spark.rapids.tpu.agg.bucketRows": "many"}, "invalid literal"),
    ({"spark.rapids.sql.exec.LocalLimit": False}, None),
    ({"spark.rapids.sql.exec.GlobalLimit": False}, None),
    ({"spark.rapids.sql.exec.Union": False}, None),
    ({"spark.rapids.sql.exec.Range": False}, None),
    ({"spark.rapids.sql.exec.Sample": False}, None),
    ({"spark.rapids.sql.exec.Expand": False}, None),
    ({"spark.rapids.sql.exec.Window": False}, None),
    ({"spark.rapids.sql.expression.Upper": False,
      "Remainder": lambda s, F: s.createDataFrame(_table()).filter(
        F.col("a") % 2 == 1).select("a", (F.col("a") % 3).alias("m")),
    "XxHash64": lambda s, F: s.createDataFrame(_table()).select(
        F.xxhash64(F.col("a"), F.col("s")).alias("h")),
    "spark.rapids.sql.incompatibleOps.enabled": True}, None),
    ({"spark.rapids.sql.expression.RLike": False}, None),
    ({"spark.rapids.sql.expression.StringPad": False,
      "Remainder": lambda s, F: s.createDataFrame(_table()).filter(
        F.col("a") % 2 == 1).select("a", (F.col("a") % 3).alias("m")),
    "XxHash64": lambda s, F: s.createDataFrame(_table()).select(
        F.xxhash64(F.col("a"), F.col("s")).alias("h")),
    "spark.rapids.sql.incompatibleOps.enabled": True}, None),
    ({"spark.rapids.sql.incompatibleOps.enabled": True}, None),
    ({"spark.rapids.sql.castStringToFloat.enabled": True}, None),
    ({"spark.rapids.sql.expression.Remainder": False}, None),
    ({"spark.rapids.sql.expression.XxHash64": False}, None),
])
def test_conf_is_validated(conf, match):
    """A bad key or value raises (``match``); a kill switch of an exec or
    expression, or a registered gate (``match`` None), is accepted, and
    on a query it touches the report and result are the JAX package's: a
    kill switch's operator falls back naming the key, a gate turned on
    keeps its operator on the device.  The first key is the one under
    test; a second turns on the gate an incompatible expression needs,
    so that only the kill switch reports."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            TpuSession(conf, device="cpu")
        return
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    key = next(iter(conf))
    gate = key.endswith(".enabled")
    build = _KILL_SWITCH_QUERIES[key if gate else key.rsplit(".", 1)[1]]
    df = build(TpuSession(dict(conf), device="cpu"), F)
    jdf = build(JaxSession(dict(conf)), JF)
    if key.endswith("InputFileName"):
        # away from a file scan the marker falls back with the switch's
        # reason, then raises at execution in both packages
        for d in (df, jdf):
            with pytest.raises(RuntimeError, match="not bound"):
                d.toArrow()
        report = df._last_override.fallback_report()
        assert report == jdf._last_override.fallback_report()
        assert report and all(f"{key}=false" in line for line in report)
        return
    got = df.toArrow()
    want = jdf.toArrow()
    report = df._last_override.fallback_report()
    assert report == jdf._last_override.fallback_report()
    if gate:
        from spark_rapids_tpu_torch import conf as C
        assert TpuSession(device="cpu").rapids_conf().get(
            C.REGISTRY[key]) is False  # the JAX package's default
        assert report == []
    else:
        assert report and all(f"{key}=false" in line for line in report)
    assert repr(got.to_pylist()) == repr(want.to_pylist())


_KILL_SWITCH_QUERIES = {
    "InputFileName": lambda s, F: s.createDataFrame(_table()).select(
        "a", F.input_file_name().alias("f")),
    "DeviceUDF": lambda s, F: s.createDataFrame(_table()).select(
        F.device_udf(_plus_one, "int")(F.col("a")).alias("b")),
    "LocalLimit": lambda s, F: s.createDataFrame(_table()).limit(2),
    "GlobalLimit": lambda s, F: s.createDataFrame(_table()).limit(2),
    "Union": lambda s, F: s.createDataFrame(_table()).union(
        s.createDataFrame(_table())),
    "Range": lambda s, F: s.range(2, 9, 2),
    "Sample": lambda s, F: s.createDataFrame(_table()).sample(0.5, 3),
    "Expand": lambda s, F: s.createDataFrame(_table()).rollup("s").agg(
        F.count("*").alias("c")).orderBy("s", "c"),
    "Window": lambda s, F: s.createDataFrame(_table()).select(
        "a", F.rank().over(_window_of(F).orderBy("s")).alias("r")),
    "Upper": lambda s, F: s.createDataFrame(_table()).select(
        F.upper(F.col("s")).alias("u")),
    "RLike": lambda s, F: s.createDataFrame(_table()).filter(
        F.col("s").rlike("[a-x]+")),
    "StringPad": lambda s, F: s.createDataFrame(_table()).select(
        F.lpad(F.col("s"), 3, "*").alias("p")),
    "Remainder": lambda s, F: s.createDataFrame(_table()).filter(
        F.col("a") % 2 == 1).select("a", (F.col("a") % 3).alias("m")),
    "XxHash64": lambda s, F: s.createDataFrame(_table()).select(
        F.xxhash64(F.col("a"), F.col("s")).alias("h")),
    "spark.rapids.sql.incompatibleOps.enabled":
        lambda s, F: s.createDataFrame(_table()).select(
            F.upper(F.col("s")).alias("u"),
            F.reverse(F.col("s")).alias("r")),
    "spark.rapids.sql.castStringToFloat.enabled":
        lambda s, F: s.createDataFrame(_table()).select(
            F.col("s").cast("double").alias("d")),
}


def _window_of(F):
    """The ``Window`` of the package whose functions module is ``F``."""
    import importlib
    return importlib.import_module(
        F.__name__.rsplit(".", 1)[0] + ".window").Window


def test_exchange_confs_read_as_the_jax_package_reads_them():
    conf = TpuSession({"spark.rapids.shuffle.mode": "cache_only",
                       "spark.rapids.tpu.exchange.mode": "COMPILED",
                       "spark.sql.adaptive.advisoryPartitionSizeInBytes":
                       "1m"}, device="cpu").rapids_conf()
    from spark_rapids_tpu_torch import conf as C
    assert conf.shuffle_mode == "CACHE_ONLY"
    assert conf.exchange_mode == "compiled"
    assert conf.get(C.ADVISORY_PARTITION_SIZE) == 1 << 20
    assert conf.get(C.ADAPTIVE_ENABLED) is True
    assert conf.get(C.SHUFFLE_THREADS) == 4
    assert TpuSession(device="cpu").rapids_conf().shuffle_mode == \
        "MULTITHREADED"


def test_ici_shuffle_mode_raises_at_planning():
    """ICI used to be refused at planning; the distributed plane plans
    it now.  On a two-rank mesh a keyed repartition into two partitions
    is the collective exchange and a grouped sum splits into partial
    and final around one; the rows are the CPU session's.  A CPU
    session under ICI plans nothing on the device."""
    from spark_rapids_tpu_torch.parallel import mesh as MESH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MESH, "_virtual", 2)
        mp.setattr(MESH, "_latched", True)
        df = TpuSession({"spark.rapids.shuffle.mode": "ICI"},
                        device="cpu").createDataFrame(_table())
        cpu = TpuSession({"spark.rapids.shuffle.mode": "ICI",
                          "spark.rapids.sql.enabled": False}, device="cpu")
        rep = df.repartition(2, "a")
        assert sorted(rep.toArrow().column("a").to_pylist()) == [1, 2, 3]
        assert "TpuIciShuffleExchange" in rep._last_plan.tree_string()
        agg = df.groupBy("s").agg(F.sum("a"))
        tree = (agg.toArrow(), agg._last_plan.tree_string())[1]
        assert "partial" in tree and "final" in tree
        want = cpu.createDataFrame(_table()).groupBy("s").agg(F.sum("a"))
        assert sorted(map(repr, agg.toArrow().to_pylist())) == sorted(
            map(repr, want.toArrow().to_pylist()))
        assert cpu.createDataFrame(_table()).repartition(2, "a") \
            .toArrow().num_rows == 3


def test_aqe_read_under_the_adaptive_plane_raises():
    """The AQE read under the adaptive plane (which re-targets its rows,
    ported since the rewrite stopped refusing it) plans and returns the
    rows; with AQE off it plans the bare exchange."""
    on = {"spark.rapids.tpu.adaptive.enabled": True}
    df = TpuSession(on, device="cpu").createDataFrame(_table())
    plan_rows = df.repartition(2)
    assert plan_rows.toArrow().num_rows == 3
    assert "TpuAQEShuffleRead" in plan_rows._last_plan.tree_string()
    off = dict(on, **{"spark.sql.adaptive.enabled": False})
    assert TpuSession(off, device="cpu").createDataFrame(_table()) \
        .repartition(2).toArrow().num_rows == 3


def test_parallelism_is_a_raw_key():
    s = TpuSession({"spark.default.parallelism": 3}, device="cpu")
    df = s.createDataFrame(_table())
    assert df._plan.num_partitions == 3
    assert df.toArrow().equals(_table())


def _plus_one(x):
    """A device UDF valid on jax arrays and torch tensors alike."""
    return x + 1


def _functions(df):
    """The ``sql.functions`` module of the package ``df`` belongs to."""
    import importlib
    pkg = type(df).__module__.split(".")[0]
    return importlib.import_module(f"{pkg}.sql.functions")


def _table():
    return pa.table({"a": pa.array([1, 2, 3], type=pa.int32()),
                     "s": pa.array(["x", "y", None]),
                     "f": pa.array([1.5, None, -2.0])})


@pytest.mark.parametrize("build, what", [
    (lambda df: df.select(col("a").cast(T.ArrayType(T.IntegerT))), "Cast"),
    # id kept from the slice that refused first(): a window function
    # outside ``.over`` is refused by both packages' analyzers alike
    # (``AnalysisException``)
    pytest.param(lambda df: df.select(Column(UExpr("winfn",
                                                   ("row_number",)))),
                 ("AnalysisException", "unknown expression op 'winfn'"),
                 id="<lambda>-aggregate 'first'"),
    pytest.param(lambda df: df.limit(2), None, id="limit"),
    # ids kept from the slices that refused a python UDF and
    # input_file_name(): a top-level UDF select now runs with the JAX
    # package's rows, and input_file_name() over an in-memory table
    # raises the JAX package's RuntimeError
    pytest.param(
        lambda df: df.select(_functions(df).udf(abs, "int")("a")
                             .alias("abs")),
        "rows", id="<lambda>-expression 'isnull'"),
    pytest.param(lambda df: df.select(_functions(df).input_file_name()),
                 RuntimeError, id="<lambda>-expression 'split'"),
])
def test_outside_the_slice_raises(build, what):
    """What the slice does not port raises naming itself; a bare limit
    (``what`` None) runs on the device, with the JAX package's result
    and its empty fallback report; a bare window function (``what`` a
    pair) raises the JAX package's ``AnalysisException``; a python UDF
    (``"rows"``) gives the JAX package's rows; ``input_file_name()``
    away from a file scan raises the JAX package's RuntimeError."""
    df = TpuSession(device="cpu").createDataFrame(_table())
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    if what is RuntimeError:
        for d in (df, JaxSession().createDataFrame(_table())):
            with pytest.raises(RuntimeError,
                               match="not bound to a file scan"):
                build(d).toArrow()
        return
    if what == "rows":
        got = build(df).toArrow()
        assert got.equals(build(JaxSession().createDataFrame(
            _table())).toArrow())
        assert got.column("abs").to_pylist() == [1, 2, 3]
        return
    if isinstance(what, tuple):
        # refused by the analyzer, with the JAX package's message
        from spark_rapids_tpu.plan.analysis import AnalysisException as JAE
        from spark_rapids_tpu_torch.plan.analysis import AnalysisException
        with pytest.raises(AnalysisException, match=what[1]):
            build(df).toArrow()
        with pytest.raises(JAE, match=what[1]):
            build(JaxSession().createDataFrame(_table())).toArrow()
        return
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
            build(df).toArrow()
        return
    out = build(df)
    got = out.toArrow()
    jout = build(JaxSession().createDataFrame(_table()))
    want = jout.toArrow()
    assert got.equals(want) and got.num_rows == 2
    assert out.fallback_summary() == jout.fallback_summary()
    assert out.fallback_summary()["fallback_reasons"] == []
    assert out._last_override.fallback_report() == []


def test_host_device_round_trip_keeps_nulls_and_strings():
    t = pa.table({
        "i": pa.array([1, None, -7], type=pa.int32()),
        "l": pa.array([1 << 40, 2, None], type=pa.int64()),
        "d": pa.array([0, 18000, None], type=pa.int32()).cast(pa.date32()),
        "s": pa.array(["", None, "été x" * 3]),
        "f": pa.array([float("nan"), -0.0, None]),
        "b": pa.array([True, None, False]),
    })
    batch = host_to_device(t, torch.device("cpu"))
    for b in (batch, pad_batch(batch, 4 * batch.capacity)):
        back = device_to_host(b)
        assert back.schema.names == t.schema.names
        for name in t.column_names:
            assert repr(back.column(name).to_pylist()) == repr(
                t.column(name).to_pylist()), name


def test_from_numpy_batch_checks_buffers():
    schema = T.StructType((T.StructField("a", T.IntegerT),
                           T.StructField("s", T.StringT)))
    sel = np.array([True, False])
    ok = from_numpy_batch(schema, [
        (np.array([1, 2], np.int32), None, None),
        (np.zeros((2, 8), np.uint8), np.array([True, False]),
         np.array([0, 0], np.int32))], sel, "cpu")
    assert ok.capacity == 2 and ok.columns[1].is_string
    with pytest.raises(TypeError):
        from_numpy_batch(schema, [
            (np.array([1, 2], np.int64), None, None),
            (np.zeros((2, 8), np.uint8), None, np.zeros(2, np.int32))],
            sel, "cpu")
    with pytest.raises(ValueError):
        from_numpy_batch(schema, [
            (np.array([1, 2], np.int32), None, None),
            (np.zeros((2, 8), np.uint8), None, None)], sel, "cpu")
