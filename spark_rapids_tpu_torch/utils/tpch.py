"""TPC-H customer, orders and lineitem, and the q1, q3, q4 and q6
builders for this port.

``gen_tpch`` reproduces those three tables of the repository's
``bench.gen_tpch`` exactly (the same rng streams
``default_rng([seed, k])``, the same draws in the same order, the same
column types and buffers) without importing it, so the port can run
TPC-H on its own.  Draws from a list of strings are taken as indices
and decoded through an arrow dictionary, which gives the same values as
``rng.choice(values, n)`` (that draws ``integers(0, len(values), n)``,
or one ``random`` per row against the cumulative ``p``) without building
a Python list of n strings; the formatted string columns are built
column-wise with arrow compute.

``q1``, ``q3``, ``q4`` and ``q6`` transcribe ``bench.py``'s builders
onto this port's DataFrame API (those import the JAX package).
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col

_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"]


_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_WORDS = ["slyly", "quick", "pending", "final", "ironic", "express",
          "bold", "regular", "even", "special", "silent", "furious",
          "careful", "requests", "deposits", "accounts", "packages",
          "Complaints", "Customer", "theodolites", "pinto", "waters"]


def _plain(arr: pa.Array) -> pa.Array:
    """A null-free string array without a validity bitmap, as
    ``pa.array(list_of_str)`` builds it (so ``nbytes`` agrees too)."""
    if arr.type != pa.string():
        arr = arr.cast(pa.string())
    return pa.Array.from_buffers(pa.string(), len(arr),
                                 [None] + arr.buffers()[1:],
                                 offset=arr.offset)


def _decode(idx: np.ndarray, values) -> pa.Array:
    return _plain(pa.DictionaryArray.from_arrays(
        pa.array(np.asarray(idx).astype(np.int32)), pa.array(values)))


def _choice(rng, values, n, p=None) -> pa.Array:
    return _decode(rng.choice(len(values), n, p=p), values)


def _join(*parts, sep: str = "") -> pa.Array:
    return _plain(pc.binary_join_element_wise(*parts, sep))


def _fmt_int(x: np.ndarray, width: int = 0) -> pa.Array:
    s = pa.array(np.asarray(x, dtype=np.int64)).cast(pa.string())
    return pc.utf8_lpad(s, width, "0") if width else s


def _comments(rng, n: int, special_every: int = 0) -> pa.Array:
    """``bench._comments``: three random words; every
    ``special_every``-th row wrapped as 'Customer ... Complaints' or
    'special ... requests', alternately."""
    w = rng.choice(len(_WORDS), (n, 3))
    out = _join(*(_decode(w[:, k], _WORDS) for k in range(3)), sep=" ")
    if not special_every:
        return out
    i = np.arange(n)
    kind = np.where(i % special_every != 0, 0,
                    1 + (i // special_every) % 2)
    return _join(_decode(kind, ["", "Customer ", "special "]), out,
                 _decode(kind, ["", " Complaints", " requests"]))


def _dates(days: np.ndarray) -> pa.Array:
    return pa.array(days, type=pa.int32()).cast(pa.date32())


def gen_lineitem(sf: float, seed: int = 7) -> pa.Table:
    """TPC-H-shaped lineitem at scale factor ``sf`` (6,000,000 * sf rows):
    ``bench.gen_tpch(sf, seed)["lineitem"]``, column for column."""
    n_li = int(6_000_000 * sf)
    n_ord = int(1_500_000 * sf)
    n_part = max(int(200_000 * sf), 16)
    n_supp = max(int(10_000 * sf), 8)
    sstep = n_supp // 4 + 1
    rng = np.random.default_rng([seed, 6])
    l_partkey = rng.integers(0, n_part, n_li)
    l_suppkey = (l_partkey + rng.integers(0, 4, n_li) * sstep) % n_supp
    l_ship = rng.integers(8036, 10_592, n_li).astype(np.int32)
    cols = {}
    cols["l_orderkey"] = rng.integers(0, n_ord, n_li)
    cols["l_partkey"] = l_partkey
    cols["l_suppkey"] = l_suppkey
    cols["l_quantity"] = rng.uniform(1, 50, n_li)
    cols["l_extendedprice"] = rng.uniform(100, 10_000, n_li)
    cols["l_discount"] = rng.uniform(0.0, 0.11, n_li).round(2)
    cols["l_tax"] = rng.uniform(0.0, 0.08, n_li).round(2)
    cols["l_returnflag"] = _choice(rng, ["A", "N", "R"], n_li)
    cols["l_linestatus"] = _choice(rng, ["O", "F"], n_li)
    cols["l_shipdate"] = _dates(l_ship)
    cols["l_commitdate"] = _dates(
        l_ship + rng.integers(-15, 16, n_li).astype(np.int32))
    cols["l_receiptdate"] = _dates(
        l_ship + rng.integers(1, 31, n_li).astype(np.int32))
    cols["l_shipmode"] = _choice(rng, _MODES, n_li)
    cols["l_shipinstruct"] = _choice(rng, _INSTRUCT, n_li)
    return pa.table(cols)


def gen_tpch(sf: float, seed: int = 7) -> Dict[str, pa.Table]:
    """``bench.gen_tpch(sf, seed)``'s customer, orders and lineitem
    tables, column for column: 150,000, 1,500,000 and 6,000,000 rows
    at ``sf`` = 1."""
    n_ord = int(1_500_000 * sf)
    n_cust = max(int(150_000 * sf), 10)
    rng = np.random.default_rng([seed, 1])
    c_nationkey = rng.integers(0, 25, n_cust)
    i = np.arange(n_cust)
    customer = pa.table({
        "c_custkey": i,
        "c_nationkey": c_nationkey,
        "c_mktsegment": _choice(rng, _SEGMENTS, n_cust),
        "c_acctbal": rng.uniform(-999, 9999, n_cust),
        "c_name": _join(pa.array(["Customer#"] * n_cust), _fmt_int(i, 9)),
        "c_address": _join(pa.array(["Addr "] * n_cust),
                           _fmt_int(i % 997), pa.array([" Way"] * n_cust)),
        "c_phone": _join(_fmt_int(10 + c_nationkey), _fmt_int(i % 900 + 100),
                         _fmt_int(i % 9000 + 1000), sep="-"),
        "c_comment": _comments(rng, n_cust),
    })
    rng = np.random.default_rng([seed, 2])
    orders = pa.table({
        "o_orderkey": np.arange(n_ord),
        "o_custkey": rng.integers(0, n_cust, n_ord),
        "o_orderdate": _dates(
            rng.integers(8036, 10_592, n_ord).astype(np.int32)),
        "o_shippriority": rng.integers(0, 2, n_ord).astype(np.int32),
        "o_totalprice": rng.uniform(800, 500_000, n_ord),
        "o_orderstatus": _choice(rng, ["F", "O", "P"], n_ord,
                                 p=[0.49, 0.49, 0.02]),
        "o_orderpriority": _choice(rng, _PRIORITIES, n_ord),
        "o_clerk": _decode(np.arange(n_ord) % 1000,
                           [f"Clerk#{k:09d}" for k in range(1000)]),
        "o_comment": _comments(rng, n_ord, special_every=23),
    })
    return {"customer": customer, "orders": orders,
            "lineitem": gen_lineitem(sf, seed)}


_D = datetime.date


def _t(session, t: Dict[str, pa.Table], name: str, *cols):
    """A TPC-H table narrowed to the referenced columns (``bench._t``)."""
    return session.createDataFrame(t[name]).select(*cols)


def q6(session, li: pa.Table):
    """TPC-H q6 (``bench.q6``): forecasting revenue change."""
    return (session.createDataFrame(li).filter(
        (col("l_shipdate") >= _D(1994, 1, 1))
        & (col("l_shipdate") < _D(1995, 1, 1))
        & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24))
        .agg(F.sum(col("l_extendedprice") * col("l_discount"))
             .alias("revenue")))


def q1(session, li: pa.Table):
    """TPC-H q1 (``bench.q1``): pricing summary report."""
    return (session.createDataFrame(li)
            .select("l_returnflag", "l_linestatus", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
            .filter(col("l_shipdate") <= _D(1998, 9, 2))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base"),
                 F.sum(col("l_extendedprice")
                       * (1 - col("l_discount"))).alias("sum_disc"),
                 F.sum(col("l_extendedprice") * (1 - col("l_discount"))
                       * (1 + col("l_tax"))).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("cnt"))
            .orderBy("l_returnflag", "l_linestatus"))


def q3(session, t: Dict[str, pa.Table]):
    """TPC-H q3 (``bench.q3``): shipping priority — two inner joins, a
    grouped sum and a top 10."""
    cust = _t(session, t, "customer", "c_custkey", "c_mktsegment").filter(
        col("c_mktsegment") == "BUILDING")
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_orderdate", "o_shippriority").filter(
        col("o_orderdate") < _D(1995, 3, 15))
    li = _t(session, t, "lineitem", "l_orderkey", "l_extendedprice",
            "l_discount", "l_shipdate").filter(
        col("l_shipdate") > _D(1995, 3, 15))
    return (cust.join(orders, col("c_custkey") == col("o_custkey"),
                      "inner")
            .join(li, col("o_orderkey") == col("l_orderkey"), "inner")
            .groupBy("o_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(col("l_extendedprice")
                       * (1 - col("l_discount"))).alias("revenue"))
            .orderBy(col("revenue").desc(), col("o_orderdate"))
            .limit(10))


def q4(session, t: Dict[str, pa.Table]):
    """TPC-H q4 (``bench.q4``): order priority checking — a left semi
    join, a grouped count and an order-by."""
    orders = _t(session, t, "orders", "o_orderkey", "o_orderdate",
                "o_orderpriority").filter(
        (col("o_orderdate") >= _D(1993, 7, 1))
        & (col("o_orderdate") < _D(1993, 10, 1)))
    li = _t(session, t, "lineitem", "l_orderkey", "l_commitdate",
            "l_receiptdate").filter(
        col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(li, col("o_orderkey") == col("l_orderkey"),
                        "left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .orderBy("o_orderpriority"))
