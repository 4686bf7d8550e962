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
  running elsewhere.
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
])
def test_conf_is_validated(conf, match):
    with pytest.raises(ValueError, match=match):
        TpuSession(conf, device="cpu")


def _table():
    return pa.table({"a": pa.array([1, 2, 3], type=pa.int32()),
                     "s": pa.array(["x", "y", None]),
                     "f": pa.array([1.5, None, -2.0])})


@pytest.mark.parametrize("build, what", [
    (lambda df: df.select(col("a").cast("string")), "Cast"),
    (lambda df: df.agg(F._agg("first")("a")), "aggregate 'first'"),
    (lambda df: df.limit(2), "limit without an order-by"),
    (lambda df: df.select(Column(UExpr("isnull", None, (col("a")._u,)))),
     "expression 'isnull'"),
    (lambda df: df.filter(Column(UExpr("like", "x%", (col("s")._u,)))),
     "expression 'like'"),
])
def test_outside_the_slice_raises(build, what):
    df = TpuSession(device="cpu").createDataFrame(_table())
    with pytest.raises(NotImplementedError, match=what):
        build(df).toArrow()


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
