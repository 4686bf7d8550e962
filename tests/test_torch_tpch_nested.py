"""The nested slice as a whole: ``utils/tpch.py``'s nested queries over
``nested_tables(gen_tpch(0.002))`` on the port against the JAX package.

``nested_tables`` derives a ``list<double>`` of each order's quantities
(null elements, null and empty lists), a struct column on orders (null
structs) and customers' JSON documents from the generated tables and a
seed; ``NESTED_QUERIES`` are the ``[nested]`` phase's queries of
``chip_smoke.py``: order baskets by ``collect_list``/``collect_set``,
their ``posexplode`` back to part keys, ``explode_outer`` of the
quantity lists, q1 keyed by a struct, a filter and top-N over the
orders' struct, a word count by ``split`` and ``explode``, and
``get_json_object``.

Each query runs on the port's accelerated session (``device="cpu"``,
under ``spark.rapids.sql.test.enabled`` with only ``NESTED_ALLOWED`` on
the CPU) and on its CPU session, and both equal the JAX package's CPU
session; the tree string and fallback report equal the JAX session's
plan, made without running it (its device runs compile for seconds
each).  Keys, counts, lists and strings are exact; the double sums and
averages within the JAX tests' ``approx_float`` (1e-6 relative and
absolute: the device adds in another order).
"""

import math

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch

REL = 1e-6
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}


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


@pytest.fixture(scope="module")
def tables():
    return tpch.nested_tables(tpch.gen_tpch(0.002))


def _conf(name):
    allowed = tpch.NESTED_ALLOWED.get(name)
    return dict(TEST, **({"spark.rapids.sql.test.allowedNonGpu": allowed}
                         if allowed else {}))


@pytest.fixture(scope="module")
def jax_run(tables):
    """``run(name)`` -> the JAX package's (CPU session's result, fallback
    report, tree string of the accelerated plan), once per module."""
    memo = {}

    def run(name):
        if name not in memo:
            build = tpch.NESTED_QUERIES[name]
            want = build(JaxSession(dict(HOST)), tables, JF).toArrow()
            df = build(JaxSession(_conf(name)), tables, JF)
            plan = df._execute_plan()  # planned, not run
            memo[name] = (want, df._last_override.fallback_report(),
                          plan.tree_string())
        return memo[name]

    return run


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=REL, abs_tol=REL)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return a == b


def same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
    """Equal schemas and rows: doubles within ``REL``, the rest exactly;
    rows matched by their exact values unless ``ordered``."""
    assert got.schema == want.schema
    g, w = got.to_pylist(), want.to_pylist()
    assert len(g) == len(w)
    if not ordered:
        def key(r):
            return repr([v for v in r.values()
                         if not isinstance(v, float)])
        g, w = sorted(g, key=key), sorted(w, key=key)
    for rg, rw in zip(g, w):
        assert rg.keys() == rw.keys()
        for k in rg:
            assert _close(rg[k], rw[k]), (k, rg, rw)


ORDERED = {"q1 struct", "orders by info", "customer json"}


@pytest.mark.parametrize("name", list(tpch.NESTED_QUERIES))
def test_device_equals_jax(tables, jax_run, name):
    df = tpch.NESTED_QUERIES[name](TpuSession(_conf(name), device="cpu"),
                                   tables)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    assert got.num_rows > 0
    same_rows(got, want, name in ORDERED)
    assert df._last_override.fallback_report() == report
    assert bool(report) == (name in tpch.NESTED_ALLOWED)
    assert df._last_plan.tree_string() == tree


@pytest.mark.parametrize("name", list(tpch.NESTED_QUERIES))
def test_host_equals_jax(tables, jax_run, name):
    got = tpch.NESTED_QUERIES[name](TpuSession(dict(HOST), device="cpu"),
                                    tables).toArrow()
    same_rows(got, jax_run(name)[0], name in ORDERED)


def test_nested_tables_shapes(tables):
    """The nested inputs hold what the phase relies on: about 1% null
    elements, null lists and null structs; empty lists where an order
    has no line; one document per customer."""
    q = tables["order_quantities"]
    lists = q.column("qty").combine_chunks()
    n = q.num_rows
    assert n == tables["lineitem"].num_rows // 4
    assert 0 < lists.null_count < 0.05 * n
    assert 0 < lists.values.null_count < 0.05 * len(lists.values)
    lens = lists.value_lengths().fill_null(-1).to_numpy()
    assert (lens == 0).sum() > 0
    info = tables["orders_info"].column("o_info").combine_chunks()
    assert 0 < info.null_count < 0.05 * n
    assert tables["customer_json"].num_rows == 300
