"""The window slice as a whole: ``utils/tpch.py``'s window queries over
``window_tables(gen_tpch(0.002))`` on the port against the JAX package.

``WINDOW_QUERIES`` are the ``[window]`` phase's queries of
``chip_smoke.py``: supplier ranks (a join and an aggregate, then
``rank``, ``dense_rank`` and ``row_number`` by revenue, descending, kept
to the top three), revenue share (a whole-partition sum), order gaps
(``lag`` and ``lead`` over dates, doubles and strings, ``lag`` with
IGNORE NULLS), line running totals (a ROWS and the default RANGE
frame), customer trailing spend (a RANGE offset frame on a date, two
bounded ROWS frames), customer quartiles (``ntile``, ``percent_rank``,
``cume_dist`` by a string partition) and the top orders (a window with
no partition).

Each query runs on the port's accelerated session (``device="cpu"``,
under ``spark.rapids.sql.test.enabled``: nothing falls back) and on its
CPU session, and both equal the JAX package's CPU session; the tree
string and fallback report equal the JAX session's plan, made without
running it (its device runs compile for seconds each).  Keys, ranks,
counts, dates and strings are exact; doubles within 1e-6 relative and
absolute, as the JAX tests' ``approx_float`` (the device adds in
another order).  Rows compare in order where the window's sort fixes
it.
"""

import datetime

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSession as JaxSession
from spark_rapids_tpu.sql.window import Window as JWindow

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch
from tests.test_torch_window import same_rows  # noqa: E402

TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
# the aggregate's output order is its hash order on the device and its
# first-seen order on the CPU: these compare as multisets
UNORDERED = {"revenue share"}


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
    return tpch.window_tables(tpch.gen_tpch(0.002))


@pytest.fixture(scope="module")
def jax_run(tables):
    """``run(name)`` -> the JAX package's (CPU session's result, fallback
    report, tree string of the accelerated plan), once per module."""
    memo = {}

    def run(name):
        if name not in memo:
            build = tpch.WINDOW_QUERIES[name]
            want = build(JaxSession(dict(HOST)), tables, JF,
                         JWindow).toArrow()
            df = build(JaxSession(dict(TEST)), tables, JF, JWindow)
            plan = df._execute_plan()  # planned, not run
            memo[name] = (want, df._last_override.fallback_report(),
                          plan.tree_string())
        return memo[name]

    return run


@pytest.mark.parametrize("name", list(tpch.WINDOW_QUERIES))
def test_device_equals_jax(tables, jax_run, name):
    df = tpch.WINDOW_QUERIES[name](TpuSession(dict(TEST), device="cpu"),
                                   tables)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    assert got.num_rows > 0
    same_rows(got, want, True, name not in UNORDERED)
    assert df._last_override.fallback_report() == report == []
    assert df._last_plan.tree_string() == tree
    assert "TpuWindow" in tree


@pytest.mark.parametrize("name", list(tpch.WINDOW_QUERIES))
def test_host_equals_jax(tables, jax_run, name):
    got = tpch.WINDOW_QUERIES[name](TpuSession(dict(HOST), device="cpu"),
                                    tables).toArrow()
    same_rows(got, jax_run(name)[0], False, name not in UNORDERED)


def test_window_tables_number_each_orders_lines(tables):
    """``l_linenumber`` runs 1..n over each order's lines, in generator
    order."""
    li = tables["lineitem"]
    seen = {}
    for k, n in zip(li["l_orderkey"].to_pylist(),
                    li["l_linenumber"].to_pylist()):
        seen[k] = seen.get(k, 0) + 1
        assert n == seen[k]
    assert li.schema.field("l_linenumber").type == pa.int32()


def test_what_the_queries_show(tables, jax_run):
    """Nulls exist where the phase relies on them: the first order of a
    customer has no previous date, IGNORE NULLS skips unfulfilled
    orders, the top orders are 100, the supplier ranks 1 to 3."""
    gaps = jax_run("order gaps")[0].to_pylist()
    assert any(r["prev_date"] is None for r in gaps)
    assert any(r["prev_filled"] is not None for r in gaps)
    assert isinstance(gaps[0]["o_orderdate"], datetime.date)
    assert jax_run("top orders")[0].num_rows == 100
    assert {r["rk"] for r in jax_run("supplier ranks")[0].to_pylist()} \
        <= {1, 2, 3}
