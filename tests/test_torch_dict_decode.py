"""Device dictionary decode (``columnar/column.py::
arrow_column_to_device``) against the JAX package's, bit for bit: a
string dictionary with no null values crosses as int32 indices plus the
dictionary's own byte matrix and expands on the device, so the matrix
width is the dictionary's; any other dictionary (null values, empty,
non-string) decodes to plain first.  Then TPC-H q1 and q19 over a
lineitem whose low-cardinality string columns are dictionary-encoded
(sf 0.002), against the JAX package on the same input and against the
plain run.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import bench

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar.column import (
    arrow_column_to_device as jax_to_device)
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import arrow_column_to_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    B.clear_scan_cache()


def _dict(indices, values, value_type=pa.string()):
    return pa.DictionaryArray.from_arrays(
        pa.array(indices, pa.int32()), pa.array(values, value_type))


def _cases():
    words = ["DELIVER IN PERSON", "NONE", "COLLECT COD", "a", ""]
    rng = np.random.default_rng(5)
    idx = rng.integers(0, len(words), 200).tolist()
    with_nulls = [None if i % 9 == 0 else v for i, v in enumerate(idx)]
    long_last = words + ["x" * 40]
    return {
        "plain": _dict(idx, words),
        "index_nulls": _dict(with_nulls, words),
        # null VALUES: decoded to plain before the transfer
        "value_nulls": _dict(idx, ["x", None, "yy", "z", "w"]),
        "empty_dictionary": _dict([None] * 7, []),
        # a slice that holds none of the dictionary's longest value: the
        # matrix keeps the dictionary's width (64), not the slice's
        "sliced": _dict([0, 1, 2, 5] * 40, long_last).slice(37, 50),
        "sliced_index_nulls": _dict(with_nulls, words).slice(3, 101),
        "binary": _dict(idx, [w.encode() for w in words], pa.binary()),
        "chunked": pa.chunked_array([_dict(idx, words).slice(10, 90)]),
        # an integer dictionary decodes to plain
        "int_values": _dict(idx, [7, 8, 9, 10, 11], pa.int64()),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_arrow_column_to_device_matches_jax(case):
    arr = _cases()[case]
    value_type = arr.type.value_type
    got = arrow_column_to_device(arr, T.from_arrow(value_type), CPU)
    want = jax_to_device(arr, JT.from_arrow(value_type))
    w_data = np.asarray(want.data)
    assert got.data.numpy().dtype == w_data.dtype
    assert got.data.shape == w_data.shape
    assert np.array_equal(got.data.numpy(), w_data)
    for g, w in ((got.lengths, want.lengths), (got.validity,
                                               want.validity)):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w))
    if case == "sliced":
        assert got.data.shape[1] == 64


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(0.002)


def _encoded(li):
    """lineitem with its four low-cardinality strings dictionary-encoded
    (``pc.dictionary_encode``), as ``chip_smoke.py``'s dict phase."""
    for name in ("l_returnflag", "l_linestatus", "l_shipmode",
                 "l_shipinstruct"):
        i = li.column_names.index(name)
        li = li.set_column(i, name, pc.dictionary_encode(li.column(name)))
    return li


@pytest.mark.parametrize("query", ["q1", "q19"])
def test_query_over_dictionary_columns_matches_jax_and_plain(tables,
                                                             query):
    enc = dict(tables, lineitem=_encoded(tables["lineitem"]))
    assert pa.types.is_dictionary(enc["lineitem"].schema.field(
        "l_shipmode").type)

    def port(t):
        return getattr(tpch, query)(TpuSession(device="cpu"), t[
            "lineitem"] if query == "q1" else t).toArrow()

    got = port(enc)
    plain = port(tables)
    want = getattr(bench, query)(JaxSession({}), enc).toArrow()
    assert got.schema == plain.schema == want.schema
    assert got.equals(plain)
    assert bench._rows_equal(got, want, tol=1e-6)
    assert got.num_rows > 0
