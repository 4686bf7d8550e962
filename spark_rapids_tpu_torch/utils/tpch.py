"""TPC-H's eight tables, and the builders of the 22 queries, for this
port.

``gen_tpch`` reproduces the repository's ``bench.gen_tpch`` exactly (the same rng streams
``default_rng([seed, k])``, the same draws in the same order, the same
column types and buffers) without importing it, so the port can run
TPC-H on its own.  Draws from a list of strings are taken as indices
and decoded through an arrow dictionary, which gives the same values as
``rng.choice(values, n)`` (that draws ``integers(0, len(values), n)``,
or one ``random`` per row against the cumulative ``p``) without building
a Python list of n strings; the formatted string columns are built
column-wise with arrow compute.

``q1`` … ``q22`` transcribe ``bench.py``'s builders onto this port's
DataFrame API (those import the JAX package); ``JOIN_VARIANTS`` are
rewrites of five of them that run the right join, the full join and the
residual join conditions (``q13_cond`` the one the plan rewrite keeps on
the CPU).

``decimal_tables`` gives the money and quantity columns the type that
Spark users load TPC-H with (databricks/spark-sql-perf's ``TPCH.scala``
declares them ``decimal(12,2)``): the same builders then run over
decimal columns.

``nested_tables`` derives nested and array inputs from the generated
tables and a seed (a ``list<double>`` of each order's quantities, a
struct column on orders, JSON documents of customers), and
``NESTED_QUERIES`` are the builders that run over them: order baskets by
``collect_list``/``collect_set``, their ``posexplode`` back to parts,
``explode_outer`` of the quantity lists, q1 keyed by a struct, a filter
and top-N over the orders' struct, a word count by ``split`` and
``explode``, and ``get_json_object``.  Each builder takes the functions
module (``F``) as an argument, so that the same query can be built on
another implementation of the API.

``window_tables`` adds each line's number within its order to lineitem,
and ``WINDOW_QUERIES`` are window queries of the kinds TPC-DS runs
(rank within a partition, revenue share, lag and lead, running
totals, bounded ROWS and RANGE frames, quartiles, a window with no
partition); each takes ``F`` and ``W`` (the ``Window`` class) as
arguments.

``TPCH_SF1_CONF`` is ``bench.TPCH_SF1_CONF``, the whole of it: the
adaptive plane, whole-stage fusion and the result cache included
(``UNPORTED_SF1_KEYS``, the keys of planes the port had not got, is
empty), and ``oracle_check`` is bench's CPU-oracle loop: each
builder at a small scale under the accelerated session and under
``TpuSession({"spark.rapids.sql.enabled": False})``, compared with a
copy of ``bench._rows_equal(tol=1e-6)``.
"""

from __future__ import annotations

import datetime
import json
from typing import Callable, Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col

_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
           "dim", "dodger", "drab", "firebrick", "floral", "forest",
           "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
           "honeydew", "hot", "indian", "ivory", "khaki", "lace",
           "lavender", "lawn", "lemon", "light", "lime", "linen"]
_TYPES1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPES2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPES3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONT1 = ["SM", "MED", "LG", "JUMBO", "WRAP"]
_CONT2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
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


def _phone(nationkey: np.ndarray, i: np.ndarray) -> pa.Array:
    return _join(_fmt_int(10 + nationkey), _fmt_int(i % 900 + 100),
                 _fmt_int(i % 9000 + 1000), sep="-")


def _const(s: str, n: int) -> pa.Array:
    return pa.array([s] * n)


def gen_tpch(sf: float, seed: int = 7) -> Dict[str, pa.Table]:
    """``bench.gen_tpch(sf, seed)``'s eight tables, column for column:
    6,000,000 lineitem, 1,500,000 orders, 150,000 customer, 200,000
    part, 800,000 partsupp and 10,000 supplier rows at ``sf`` = 1, and
    25 nations in 5 regions."""
    n_ord = int(1_500_000 * sf)
    n_cust = max(int(150_000 * sf), 10)
    n_part = max(int(200_000 * sf), 16)
    n_supp = max(int(10_000 * sf), 8)
    n_nat, n_reg = 25, 5
    sstep = n_supp // 4 + 1  # partsupp supplier stride (4 per part)

    def r(k):
        return np.random.default_rng([seed, k])

    region = pa.table({
        "r_regionkey": np.arange(n_reg),
        "r_name": pa.array(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                            "MIDDLE EAST"]),
    })
    nation = pa.table({
        "n_nationkey": np.arange(n_nat),
        "n_regionkey": r(0).integers(0, n_reg, n_nat),
        "n_name": pa.array([f"NATION_{i:02d}" for i in range(n_nat)]),
    })
    rng = r(1)
    c_nationkey = rng.integers(0, n_nat, n_cust)
    i = np.arange(n_cust)
    customer = pa.table({
        "c_custkey": i,
        "c_nationkey": c_nationkey,
        "c_mktsegment": _choice(rng, _SEGMENTS, n_cust),
        "c_acctbal": rng.uniform(-999, 9999, n_cust),
        "c_name": _join(_const("Customer#", n_cust), _fmt_int(i, 9)),
        "c_address": _join(_const("Addr ", n_cust), _fmt_int(i % 997),
                           _const(" Way", n_cust)),
        "c_phone": _phone(c_nationkey, i),
        "c_comment": _comments(rng, n_cust),
    })
    rng = r(2)
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
    rng = r(3)
    s_nationkey = rng.integers(0, n_nat, n_supp)
    i = np.arange(n_supp)
    supplier = pa.table({
        "s_suppkey": i,
        "s_name": _join(_const("Supplier#", n_supp), _fmt_int(i, 9)),
        "s_address": _join(_const("Dock ", n_supp), _fmt_int(i % 463),
                           _const(" St", n_supp)),
        "s_nationkey": s_nationkey,
        "s_phone": _phone(s_nationkey, i),
        "s_acctbal": rng.uniform(-999, 9999, n_supp),
        "s_comment": _comments(rng, n_supp, special_every=17),
    })
    rng = r(4)
    name_ix = rng.integers(0, len(_COLORS), (n_part, 2))
    mfgr = rng.integers(1, 6, n_part)
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    t1 = rng.integers(0, 6, n_part)
    t2 = rng.integers(0, 5, n_part)
    t3 = rng.integers(0, 5, n_part)
    p_size = rng.integers(1, 51, n_part).astype(np.int32)
    c1 = rng.integers(0, 5, n_part)
    c2 = rng.integers(0, 8, n_part)
    part = pa.table({
        "p_partkey": np.arange(n_part),
        "p_name": _join(_decode(name_ix[:, 0], _COLORS),
                        _decode(name_ix[:, 1], _COLORS), sep=" "),
        "p_mfgr": _decode(mfgr - 1,
                          [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_brand": _decode((brand_m - 1) * 5 + brand_n - 1,
                           [f"Brand#{m}{k}" for m in range(1, 6)
                            for k in range(1, 6)]),
        "p_type": _join(_decode(t1, _TYPES1), _decode(t2, _TYPES2),
                        _decode(t3, _TYPES3), sep=" "),
        "p_size": p_size,
        "p_container": _join(_decode(c1, _CONT1), _decode(c2, _CONT2),
                             sep=" "),
        "p_retailprice": rng.uniform(900, 2000, n_part),
    })
    rng = r(5)
    ps_partkey = np.repeat(np.arange(n_part), 4)
    partsupp = pa.table({
        "ps_partkey": ps_partkey,
        "ps_suppkey": (ps_partkey + np.tile(np.arange(4), n_part)
                       * sstep) % n_supp,
        "ps_availqty": rng.integers(1, 10_000, 4 * n_part).astype(
            np.int32),
        "ps_supplycost": rng.uniform(1, 1000, 4 * n_part),
    })
    return {"lineitem": gen_lineitem(sf, seed), "orders": orders,
            "customer": customer, "nation": nation, "region": region,
            "supplier": supplier, "part": part, "partsupp": partsupp}


_D = datetime.date


def _t(session, t: Dict[str, pa.Table], name: str, *cols):
    """A TPC-H table narrowed to the referenced columns (``bench._t``)."""
    return session.createDataFrame(t[name]).select(*cols)


def q6(session, li: pa.Table):
    """TPC-H q6 (``bench.q6``): forecasting revenue change."""
    return q6_over(session.createDataFrame(li))


def q6_over(df):
    """q6's filter and sum over a DataFrame of lineitem rows (a file
    scan)."""
    return (df.filter(
        (col("l_shipdate") >= _D(1994, 1, 1))
        & (col("l_shipdate") < _D(1995, 1, 1))
        & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24))
        .agg(F.sum(col("l_extendedprice") * col("l_discount"))
             .alias("revenue")))


def q1(session, li: pa.Table):
    """TPC-H q1 (``bench.q1``): pricing summary report."""
    return q1_over(session.createDataFrame(li))


def q1_over(df):
    """q1's projection, filter, aggregate and order over a DataFrame of
    lineitem rows (a union, a sample)."""
    return (df
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


def q2(session, t: Dict[str, pa.Table]):
    """TPC-H q2 (``bench.q2``): minimum cost supplier — ``endswith`` on
    ``p_type``, a subtree joined with its own per-part minimum on a long
    and a double key, a top 100 over four keys."""
    region = _t(session, t, "region", "r_regionkey", "r_name").filter(
        col("r_name") == "EUROPE")
    nation = _t(session, t, "nation", "n_nationkey", "n_regionkey",
                "n_name")
    supp = _t(session, t, "supplier", "s_suppkey", "s_nationkey",
              "s_name", "s_acctbal", "s_address", "s_phone", "s_comment")
    ps = _t(session, t, "partsupp", "ps_partkey", "ps_suppkey",
            "ps_supplycost")
    part = _t(session, t, "part", "p_partkey", "p_mfgr", "p_size",
              "p_type").filter(
        (col("p_size") == 15) & col("p_type").endswith("BRASS"))
    euro = (region.join(nation,
                        col("r_regionkey") == col("n_regionkey"))
            .join(supp, col("n_nationkey") == col("s_nationkey"))
            .join(ps, col("s_suppkey") == col("ps_suppkey")))
    j = part.join(euro, col("p_partkey") == col("ps_partkey"))
    minc = (j.groupBy("p_partkey")
            .agg(F.min(col("ps_supplycost")).alias("min_cost"))
            .withColumnRenamed("p_partkey", "mc_partkey"))
    return (j.join(minc, (col("p_partkey") == col("mc_partkey"))
                   & (col("ps_supplycost") == col("min_cost")))
            .select("s_acctbal", "s_name", "n_name", "p_partkey",
                    "p_mfgr", "s_address", "s_phone", "s_comment")
            .orderBy(col("s_acctbal").desc(), col("n_name"),
                     col("s_name"), col("p_partkey"))
            .limit(100))


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
    return q4_over(session.createDataFrame(t["orders"]),
                   session.createDataFrame(t["lineitem"]))


def q4_over(orders, lineitem):
    """q4 over DataFrames of orders and lineitem rows (a table format's
    scan)."""
    orders = orders.select("o_orderkey", "o_orderdate",
                           "o_orderpriority").filter(
        (col("o_orderdate") >= _D(1993, 7, 1))
        & (col("o_orderdate") < _D(1993, 10, 1)))
    li = lineitem.select("l_orderkey", "l_commitdate",
                         "l_receiptdate").filter(
        col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(li, col("o_orderkey") == col("l_orderkey"),
                        "left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .orderBy("o_orderpriority"))


def q5(session, t: Dict[str, pa.Table]):
    """TPC-H q5 (``bench.q5``): local supplier volume — region, nation,
    customer, orders and lineitem joined, a grouped sum."""
    region = _t(session, t, "region", "r_regionkey", "r_name").filter(
        col("r_name") == "ASIA")
    nation = _t(session, t, "nation", "n_nationkey", "n_regionkey",
                "n_name")
    cust = _t(session, t, "customer", "c_custkey", "c_nationkey")
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_orderdate").filter(
        (col("o_orderdate") >= _D(1994, 1, 1))
        & (col("o_orderdate") < _D(1995, 1, 1)))
    li = _t(session, t, "lineitem", "l_orderkey", "l_extendedprice",
            "l_discount")
    return (region.join(nation,
                        col("r_regionkey") == col("n_regionkey"),
                        "inner")
            .join(cust, col("n_nationkey") == col("c_nationkey"),
                  "inner")
            .join(orders, col("c_custkey") == col("o_custkey"), "inner")
            .join(li, col("o_orderkey") == col("l_orderkey"), "inner")
            .groupBy("n_name")
            .agg(F.sum(col("l_extendedprice")
                       * (1 - col("l_discount"))).alias("revenue"))
            .orderBy(col("revenue").desc()))


def q7(session, t: Dict[str, pa.Table]):
    """TPC-H q7 (``bench.q7``): volume shipping between two nations —
    renamed nation copies, five joins, a grouped sum by year."""
    NA, NB = "NATION_06", "NATION_07"
    n1 = (_t(session, t, "nation", "n_nationkey", "n_name")
          .withColumnRenamed("n_nationkey", "n1_key")
          .withColumnRenamed("n_name", "supp_nation")
          .filter(col("supp_nation").isin(NA, NB)))
    n2 = (_t(session, t, "nation", "n_nationkey", "n_name")
          .withColumnRenamed("n_nationkey", "n2_key")
          .withColumnRenamed("n_name", "cust_nation")
          .filter(col("cust_nation").isin(NA, NB)))
    supp = _t(session, t, "supplier", "s_suppkey", "s_nationkey").join(
        n1, col("s_nationkey") == col("n1_key"))
    cust = _t(session, t, "customer", "c_custkey", "c_nationkey").join(
        n2, col("c_nationkey") == col("n2_key"))
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey").join(
        cust, col("o_custkey") == col("c_custkey"))
    li = _t(session, t, "lineitem", "l_orderkey", "l_suppkey",
            "l_extendedprice", "l_discount", "l_shipdate").filter(
        (col("l_shipdate") >= _D(1995, 1, 1))
        & (col("l_shipdate") <= _D(1996, 12, 31)))
    return (li.join(orders, col("l_orderkey") == col("o_orderkey"))
            .join(supp, col("l_suppkey") == col("s_suppkey"))
            .filter(((col("supp_nation") == NA)
                     & (col("cust_nation") == NB))
                    | ((col("supp_nation") == NB)
                       & (col("cust_nation") == NA)))
            .select(col("supp_nation"), col("cust_nation"),
                    F.year(col("l_shipdate")).alias("l_year"),
                    (col("l_extendedprice")
                     * (1 - col("l_discount"))).alias("volume"))
            .groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(col("volume")).alias("revenue"))
            .orderBy("supp_nation", "cust_nation", "l_year"))


def q8(session, t: Dict[str, pa.Table]):
    """TPC-H q8 (``bench.q8``): national market share — seven joins and
    a conditional sum divided by a sum, by year."""
    NB = "NATION_05"
    part = _t(session, t, "part", "p_partkey", "p_type").filter(
        col("p_type") == "ECONOMY ANODIZED STEEL")
    li = _t(session, t, "lineitem", "l_orderkey", "l_partkey",
            "l_suppkey", "l_extendedprice", "l_discount")
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_orderdate").filter(
        (col("o_orderdate") >= _D(1995, 1, 1))
        & (col("o_orderdate") <= _D(1996, 12, 31)))
    cust = _t(session, t, "customer", "c_custkey", "c_nationkey")
    n1 = (_t(session, t, "nation", "n_nationkey", "n_regionkey")
          .withColumnRenamed("n_nationkey", "n1_key"))
    region = _t(session, t, "region", "r_regionkey", "r_name").filter(
        col("r_name") == "AMERICA")
    n2 = (_t(session, t, "nation", "n_nationkey", "n_name")
          .withColumnRenamed("n_nationkey", "n2_key")
          .withColumnRenamed("n_name", "nation"))
    supp = _t(session, t, "supplier", "s_suppkey", "s_nationkey")
    j = (li.join(part, col("l_partkey") == col("p_partkey"))
         .join(orders, col("l_orderkey") == col("o_orderkey"))
         .join(cust, col("o_custkey") == col("c_custkey"))
         .join(n1, col("c_nationkey") == col("n1_key"))
         .join(region, col("n_regionkey") == col("r_regionkey"))
         .join(supp, col("l_suppkey") == col("s_suppkey"))
         .join(n2, col("s_nationkey") == col("n2_key"))
         .select(F.year(col("o_orderdate")).alias("o_year"),
                 (col("l_extendedprice")
                  * (1 - col("l_discount"))).alias("volume"),
                 col("nation")))
    return (j.groupBy("o_year")
            .agg(F.sum(F.when(col("nation") == NB, col("volume"))
                       .otherwise(0.0)).alias("nat_vol"),
                 F.sum(col("volume")).alias("tot_vol"))
            .select(col("o_year"),
                    (col("nat_vol") / col("tot_vol")).alias("mkt_share"))
            .orderBy("o_year"))


def q9(session, t: Dict[str, pa.Table]):
    """TPC-H q9 (``bench.q9``): product type profit — ``contains`` on
    ``p_name``, six tables, a two-key join with partsupp."""
    part = _t(session, t, "part", "p_partkey", "p_name").filter(
        col("p_name").contains("green"))
    li = _t(session, t, "lineitem", "l_orderkey", "l_partkey",
            "l_suppkey", "l_quantity", "l_extendedprice", "l_discount")
    supp = _t(session, t, "supplier", "s_suppkey", "s_nationkey")
    ps = _t(session, t, "partsupp", "ps_partkey", "ps_suppkey",
            "ps_supplycost")
    orders = _t(session, t, "orders", "o_orderkey", "o_orderdate")
    nation = _t(session, t, "nation", "n_nationkey", "n_name")
    j = (li.join(part, col("l_partkey") == col("p_partkey"))
         .join(supp, col("l_suppkey") == col("s_suppkey"))
         .join(ps, (col("ps_partkey") == col("l_partkey"))
               & (col("ps_suppkey") == col("l_suppkey")))
         .join(orders, col("l_orderkey") == col("o_orderkey"))
         .join(nation, col("s_nationkey") == col("n_nationkey"))
         .select(col("n_name").alias("nation"),
                 F.year(col("o_orderdate")).alias("o_year"),
                 (col("l_extendedprice") * (1 - col("l_discount"))
                  - col("ps_supplycost") * col("l_quantity"))
                 .alias("amount")))
    return (j.groupBy("nation", "o_year")
            .agg(F.sum(col("amount")).alias("sum_profit"))
            .orderBy(col("nation"), col("o_year").desc()))


def q10(session, t: Dict[str, pa.Table]):
    """TPC-H q10 (``bench.q10``): returned item reporting — three joins,
    a grouped sum over a double and a string key, a top 20."""
    return q10_over(*(session.createDataFrame(t[name]) for name in (
        "customer", "orders", "lineitem", "nation")))


def q10_over(customer, orders, lineitem, nation):
    """q10 over DataFrames of the four tables' rows (avro reads)."""
    cust = customer.select("c_custkey", "c_nationkey", "c_name",
                           "c_acctbal")
    orders = orders.select("o_orderkey", "o_custkey", "o_orderdate").filter(
        (col("o_orderdate") >= _D(1993, 10, 1))
        & (col("o_orderdate") < _D(1994, 1, 1)))
    li = lineitem.select("l_orderkey", "l_extendedprice", "l_discount",
                         "l_returnflag").filter(
        col("l_returnflag") == "R")
    nation = nation.select("n_nationkey", "n_name")
    return (cust.join(orders, col("c_custkey") == col("o_custkey"),
                      "inner")
            .join(li, col("o_orderkey") == col("l_orderkey"), "inner")
            .join(nation, col("c_nationkey") == col("n_nationkey"),
                  "inner")
            .groupBy("c_custkey", "c_name", "c_acctbal", "n_name")
            .agg(F.sum(col("l_extendedprice")
                       * (1 - col("l_discount"))).alias("revenue"))
            .orderBy(col("revenue").desc())
            .limit(20))


def q11(session, t: Dict[str, pa.Table]):
    """TPC-H q11 (``bench.q11``): important stock — a grouped sum
    crossed with the global sum of the same subtree."""
    NB = "NATION_07"
    nation = _t(session, t, "nation", "n_nationkey", "n_name").filter(
        col("n_name") == NB)
    supp = _t(session, t, "supplier", "s_suppkey", "s_nationkey").join(
        nation, col("s_nationkey") == col("n_nationkey"))
    ps = (_t(session, t, "partsupp", "ps_partkey", "ps_suppkey",
             "ps_availqty", "ps_supplycost")
          .join(supp, col("ps_suppkey") == col("s_suppkey"))
          .select(col("ps_partkey"),
                  (col("ps_supplycost")
                   * col("ps_availqty")).alias("val")))
    grouped = ps.groupBy("ps_partkey").agg(F.sum(col("val"))
                                           .alias("value"))
    total = ps.agg(F.sum(col("val")).alias("tot"))
    return (grouped.crossJoin(total)
            .filter(col("value") > 0.0001 * col("tot"))
            .select("ps_partkey", "value")
            .orderBy(col("value").desc()))


def q12(session, t: Dict[str, pa.Table]):
    """TPC-H q12 (``bench.q12``): shipping modes and order priority —
    one join, conditional counts."""
    return q12_over(session.createDataFrame(t["lineitem"]),
                    session.createDataFrame(t["orders"]))


def q12_over(lineitem, orders):
    """q12 over DataFrames of lineitem and orders rows (file scans)."""
    li = lineitem.select("l_orderkey", "l_shipmode", "l_shipdate",
                         "l_commitdate", "l_receiptdate").filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_receiptdate") >= _D(1994, 1, 1))
        & (col("l_receiptdate") < _D(1995, 1, 1))
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate")))
    orders = orders.select("o_orderkey", "o_orderpriority")
    high = (F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), 1)
            .otherwise(0))
    return (li.join(orders, col("l_orderkey") == col("o_orderkey"))
            .groupBy("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(1 - high).alias("low_line_count"))
            .orderBy("l_shipmode"))


def q13(session, t: Dict[str, pa.Table]):
    """TPC-H q13 (``bench.q13``): customer distribution — ``NOT LIKE``
    over ``o_comment``, a left outer join, a count over a count."""
    orders = (_t(session, t, "orders", "o_orderkey", "o_custkey",
                 "o_comment")
              .filter(~col("o_comment").like("%special%requests%"))
              .select("o_orderkey", "o_custkey"))
    cust = _t(session, t, "customer", "c_custkey")
    per_cust = (cust.join(orders, col("c_custkey") == col("o_custkey"),
                          "left")
                .groupBy("c_custkey")
                .agg(F.count(col("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(col("custdist").desc(), col("c_count").desc()))


def q14(session, t: Dict[str, pa.Table]):
    """TPC-H q14 (``bench.q14``): promotion effect — ``LIKE 'PROMO%'``
    inside a CASE sum."""
    li = _t(session, t, "lineitem", "l_partkey", "l_extendedprice",
            "l_discount", "l_shipdate").filter(
        (col("l_shipdate") >= _D(1995, 9, 1))
        & (col("l_shipdate") < _D(1995, 10, 1)))
    part = _t(session, t, "part", "p_partkey", "p_type")
    vol = col("l_extendedprice") * (1 - col("l_discount"))
    promo = F.when(col("p_type").like("PROMO%"), vol).otherwise(0.0)
    return (li.join(part, col("l_partkey") == col("p_partkey"))
            .agg(F.sum(promo).alias("promo"),
                 F.sum(vol).alias("total"))
            .select((100.0 * col("promo")
                     / col("total")).alias("promo_revenue")))


def q15(session, t: Dict[str, pa.Table]):
    """TPC-H q15 (``bench.q15``): top supplier — a grouped sum crossed
    with its own global max."""
    rev = (_t(session, t, "lineitem", "l_suppkey", "l_extendedprice",
              "l_discount", "l_shipdate")
           .filter((col("l_shipdate") >= _D(1996, 1, 1))
                   & (col("l_shipdate") < _D(1996, 4, 1)))
           .groupBy("l_suppkey")
           .agg(F.sum(col("l_extendedprice")
                      * (1 - col("l_discount"))).alias("total_revenue"))
           .withColumnRenamed("l_suppkey", "supplier_no"))
    maxr = rev.agg(F.max(col("total_revenue")).alias("max_rev"))
    supp = _t(session, t, "supplier", "s_suppkey", "s_name",
              "s_address", "s_phone")
    return (rev.crossJoin(maxr)
            .filter(col("total_revenue") >= col("max_rev"))
            .join(supp, col("supplier_no") == col("s_suppkey"))
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .orderBy("s_suppkey"))


def q16(session, t: Dict[str, pa.Table]):
    """TPC-H q16 (``bench.q16``): parts/supplier relationship — ``!=``
    and ``NOT LIKE`` on strings, a left anti join, count(DISTINCT) over
    three group keys."""
    bad_supp = (_t(session, t, "supplier", "s_suppkey", "s_comment")
                .filter(col("s_comment")
                        .like("%Customer%Complaints%"))
                .select("s_suppkey"))
    part = _t(session, t, "part", "p_partkey", "p_brand", "p_type",
              "p_size").filter(
        (col("p_brand") != "Brand#45")
        & ~col("p_type").like("MEDIUM POLISHED%")
        & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
    ps = _t(session, t, "partsupp", "ps_partkey", "ps_suppkey")
    return (part.join(ps, col("p_partkey") == col("ps_partkey"))
            .join(bad_supp, col("ps_suppkey") == col("s_suppkey"),
                  "left_anti")
            .groupBy("p_brand", "p_type", "p_size")
            .agg(F.countDistinct(col("ps_suppkey"))
                 .alias("supplier_cnt"))
            .orderBy(col("supplier_cnt").desc(), col("p_brand"),
                     col("p_type"), col("p_size")))


def q17(session, t: Dict[str, pa.Table]):
    """TPC-H q17 (``bench.q17``): small-quantity-order revenue — a semi
    join, a grouped avg joined back."""
    part = _t(session, t, "part", "p_partkey", "p_brand",
              "p_container").filter(
        (col("p_brand") == "Brand#23")
        & (col("p_container") == "MED BOX")).select("p_partkey")
    li = (_t(session, t, "lineitem", "l_partkey", "l_quantity",
             "l_extendedprice")
          .join(part, col("l_partkey") == col("p_partkey"),
                "left_semi"))
    avgq = (li.groupBy("l_partkey")
            .agg(F.avg(col("l_quantity")).alias("aq"))
            .withColumnRenamed("l_partkey", "ap"))
    return (li.join(avgq, col("l_partkey") == col("ap"))
            .filter(col("l_quantity") < 0.2 * col("aq"))
            .agg(F.sum(col("l_extendedprice")).alias("s"))
            .select((col("s") / 7.0).alias("avg_yearly")))


def q18(session, t: Dict[str, pa.Table]):
    """TPC-H q18 (``bench.q18``): large volume customer — a grouped sum
    filtered into a semi join, two joins, a top 100."""
    li = _t(session, t, "lineitem", "l_orderkey", "l_quantity")
    big = (li.groupBy("l_orderkey")
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > 300)
           .select("l_orderkey"))
    orders = (_t(session, t, "orders", "o_orderkey", "o_custkey",
                 "o_orderdate", "o_totalprice")
              .join(big, col("o_orderkey") == col("l_orderkey"),
                    "left_semi"))
    cust = _t(session, t, "customer", "c_custkey", "c_name")
    return (cust.join(orders, col("c_custkey") == col("o_custkey"))
            .join(li, col("o_orderkey") == col("l_orderkey"))
            .groupBy("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                     "o_totalprice")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"))
            .orderBy(col("o_totalprice").desc(), col("o_orderdate"))
            .limit(100))


def q19(session, t: Dict[str, pa.Table]):
    """TPC-H q19 (``bench.q19``): discounted revenue — one join and a
    disjunction of three conjunctions over both sides."""
    li = _t(session, t, "lineitem", "l_partkey", "l_quantity",
            "l_extendedprice", "l_discount", "l_shipinstruct",
            "l_shipmode").filter(
        col("l_shipmode").isin("AIR", "REG AIR")
        & (col("l_shipinstruct") == "DELIVER IN PERSON"))
    part = _t(session, t, "part", "p_partkey", "p_brand", "p_container",
              "p_size")
    c1 = ((col("p_brand") == "Brand#12")
          & col("p_container").isin("SM CASE", "SM BOX", "SM PACK",
                                    "SM PKG")
          & col("l_quantity").between(1, 11)
          & col("p_size").between(1, 5))
    c2 = ((col("p_brand") == "Brand#23")
          & col("p_container").isin("MED BAG", "MED BOX", "MED PKG",
                                    "MED PACK")
          & col("l_quantity").between(10, 20)
          & col("p_size").between(1, 10))
    c3 = ((col("p_brand") == "Brand#34")
          & col("p_container").isin("LG CASE", "LG BOX", "LG PACK",
                                    "LG PKG")
          & col("l_quantity").between(20, 30)
          & col("p_size").between(1, 15))
    return (li.join(part, col("l_partkey") == col("p_partkey"))
            .filter(c1 | c2 | c3)
            .agg(F.sum(col("l_extendedprice")
                       * (1 - col("l_discount"))).alias("revenue")))


def q20(session, t: Dict[str, pa.Table]):
    """TPC-H q20 (``bench.q20``): potential part promotion —
    ``startswith``, two semi joins, a two-key join, ``distinct``."""
    NB = "NATION_03"
    halfq = (_t(session, t, "lineitem", "l_partkey", "l_suppkey",
                "l_quantity", "l_shipdate")
             .filter((col("l_shipdate") >= _D(1994, 1, 1))
                     & (col("l_shipdate") < _D(1995, 1, 1)))
             .groupBy("l_partkey", "l_suppkey")
             .agg(F.sum(col("l_quantity")).alias("sq")))
    forest = _t(session, t, "part", "p_partkey", "p_name").filter(
        col("p_name").startswith("forest")).select("p_partkey")
    ps = (_t(session, t, "partsupp", "ps_partkey", "ps_suppkey",
             "ps_availqty")
          .join(forest, col("ps_partkey") == col("p_partkey"),
                "left_semi")
          .join(halfq, (col("ps_partkey") == col("l_partkey"))
                & (col("ps_suppkey") == col("l_suppkey")))
          .filter(col("ps_availqty") > 0.5 * col("sq"))
          .select("ps_suppkey").distinct())
    nation = _t(session, t, "nation", "n_nationkey", "n_name").filter(
        col("n_name") == NB)
    supp = _t(session, t, "supplier", "s_suppkey", "s_name",
              "s_address", "s_nationkey").join(
        nation, col("s_nationkey") == col("n_nationkey"))
    return (supp.join(ps, col("s_suppkey") == col("ps_suppkey"),
                      "left_semi")
            .select("s_name", "s_address")
            .orderBy("s_name"))


def q21(session, t: Dict[str, pa.Table]):
    """TPC-H q21 (``bench.q21``): suppliers who kept orders waiting —
    two count(DISTINCT) group-bys joined back to late lineitems."""
    NB = "NATION_10"
    li = _t(session, t, "lineitem", "l_orderkey", "l_suppkey",
            "l_commitdate", "l_receiptdate")
    late = (li.filter(col("l_receiptdate") > col("l_commitdate"))
            .select("l_orderkey", "l_suppkey"))
    allcnt = (li.select("l_orderkey", "l_suppkey").groupBy("l_orderkey")
              .agg(F.countDistinct(col("l_suppkey")).alias("nsupp"))
              .withColumnRenamed("l_orderkey", "ak"))
    latecnt = (late.groupBy("l_orderkey")
               .agg(F.countDistinct(col("l_suppkey")).alias("nlate"))
               .withColumnRenamed("l_orderkey", "lk"))
    orders = _t(session, t, "orders", "o_orderkey",
                "o_orderstatus").filter(
        col("o_orderstatus") == "F").select("o_orderkey")
    nation = _t(session, t, "nation", "n_nationkey", "n_name").filter(
        col("n_name") == NB)
    supp = _t(session, t, "supplier", "s_suppkey", "s_name",
              "s_nationkey").join(
        nation, col("s_nationkey") == col("n_nationkey")).select(
        "s_suppkey", "s_name")
    return (late.join(orders, col("l_orderkey") == col("o_orderkey"),
                      "left_semi")
            .join(allcnt, col("l_orderkey") == col("ak"))
            .join(latecnt, col("l_orderkey") == col("lk"))
            .filter((col("nsupp") >= 2) & (col("nlate") == 1))
            .join(supp, col("l_suppkey") == col("s_suppkey"))
            .groupBy("s_name")
            .agg(F.count("*").alias("numwait"))
            .orderBy(col("numwait").desc(), col("s_name"))
            .limit(100))


def q22(session, t: Dict[str, pa.Table]):
    """TPC-H q22 (``bench.q22``): global sales opportunity —
    ``substring``, ``isin`` on strings, a cross join with an average, a
    left anti join with orders."""
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (_t(session, t, "customer", "c_custkey", "c_phone",
               "c_acctbal")
            .select(col("c_custkey"), col("c_acctbal"),
                    F.substring(col("c_phone"), 1, 2)
                    .alias("cntrycode"))
            .filter(col("cntrycode").isin(*codes)))
    avg_bal = (cust.filter(col("c_acctbal") > 0.0)
               .agg(F.avg(col("c_acctbal")).alias("ab")))
    orders = _t(session, t, "orders", "o_custkey")
    return (cust.crossJoin(avg_bal)
            .filter(col("c_acctbal") > col("ab"))
            .join(orders, col("c_custkey") == col("o_custkey"),
                  "left_anti")
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum(col("c_acctbal")).alias("totacctbal"))
            .orderBy("cntrycode"))


# the 22 queries, in TPC-H order; q1 and q6 take lineitem, the others
# the dict of tables
QUERIES = tuple(f"q{i}" for i in range(1, 23))


# ---------------------------------------------------------------------------
# bench's accelerated conf and its CPU-oracle loop
# ---------------------------------------------------------------------------

# the keys of bench.TPCH_SF1_CONF whose planes the port lacks, with the
# ROADMAP item that brings each: none since the engine planes (A.9)
UNPORTED_SF1_KEYS: Dict[str, str] = {}

# spark-sql-perf's TPCH.scala: the decimal(12,2) columns this port
# generates as doubles
DECIMAL_COLUMNS = {"lineitem": ("l_quantity", "l_extendedprice",
                                "l_discount", "l_tax"),
                   "orders": ("o_totalprice",)}


def decimal_tables(t: Dict[str, pa.Table]) -> Dict[str, pa.Table]:
    """``t`` with ``DECIMAL_COLUMNS`` rounded to 2 places (half to even,
    on the value times 100) and made Arrow ``decimal128(12, 2)``, built
    on its buffers from the int64 cents; other tables are unchanged."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import decimal_array
    dt = T.DecimalType(12, 2)
    out = dict(t)
    for name, cols in DECIMAL_COLUMNS.items():
        tbl = t[name]
        for c in cols:
            cents = np.rint(tbl[c].to_numpy() * 100.0).astype(np.int64)
            tbl = tbl.set_column(tbl.schema.get_field_index(c), c,
                                 decimal_array(dt, cents, None))
        out[name] = tbl
    return out


# ---------------------------------------------------------------------------
# Nested and array inputs, and the queries over them
# ---------------------------------------------------------------------------

NESTED_NULL_SHARE = 0.01  # null quantities, null lists, null structs


def nested_tables(t: Dict[str, pa.Table],
                  seed: int = 7) -> Dict[str, pa.Table]:
    """Nested inputs made from ``t`` (``gen_tpch``'s tables) and ``seed``:

    * ``lineitem`` and ``part``, as they are;
    * ``order_quantities``: ``o_orderkey`` and ``qty``, a
      ``list<double>`` of the order's ``l_quantity`` values in lineitem
      order, with ``NESTED_NULL_SHARE`` of the elements null and as many
      of the lists null; an order without lines has an empty list (the
      generator draws ``l_orderkey`` uniformly: about e^-4 = 1.8% of the
      orders);
    * ``orders_info``: ``o_orderkey`` and ``o_info``, a struct of
      ``o_orderpriority``, ``o_shippriority`` and ``o_clerk``, with
      ``NESTED_NULL_SHARE`` of the structs null;
    * ``customer_json``: ``c_custkey`` and ``c_json``, a JSON document
      ``{"name": c_name, "nation": c_nationkey, "acct": {"bal":
      c_acctbal}}`` per customer."""
    rng = np.random.default_rng([seed, 16])
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    n_ord = orders.num_rows
    okey = li["l_orderkey"].to_numpy()
    by_order = np.argsort(okey, kind="stable")
    offsets = np.zeros(n_ord + 1, np.int32)
    np.cumsum(np.bincount(okey, minlength=n_ord), out=offsets[1:])
    qty = li["l_quantity"].to_numpy()[by_order]
    values = pa.array(qty, mask=rng.random(len(qty)) < NESTED_NULL_SHARE)
    lists = pa.ListArray.from_arrays(
        pa.array(offsets), values,
        mask=pa.array(rng.random(n_ord) < NESTED_NULL_SHARE))
    info = pa.StructArray.from_arrays(
        [_plain(orders["o_orderpriority"].combine_chunks()),
         orders["o_shippriority"].combine_chunks(),
         _plain(orders["o_clerk"].combine_chunks())],
        names=["o_orderpriority", "o_shippriority", "o_clerk"],
        mask=pa.array(rng.random(n_ord) < NESTED_NULL_SHARE))
    docs = [json.dumps({"name": n, "nation": k, "acct": {"bal": b}})
            for n, k, b in zip(cust["c_name"].to_pylist(),
                               cust["c_nationkey"].to_pylist(),
                               cust["c_acctbal"].to_pylist())]
    return {
        "lineitem": li, "part": t["part"],
        "order_quantities": pa.table({"o_orderkey": orders["o_orderkey"],
                                      "qty": lists}),
        "orders_info": pa.table({"o_orderkey": orders["o_orderkey"],
                                 "o_info": info}),
        "customer_json": pa.table({"c_custkey": cust["c_custkey"],
                                   "c_json": pa.array(docs)}),
    }


def order_baskets(session, t, F=F):
    """Each order's parts in lineitem order, its distinct suppliers in
    ascending order, and its line count."""
    return (session.createDataFrame(t["lineitem"]).groupBy("l_orderkey")
            .agg(F.collect_list("l_partkey").alias("parts"),
                 F.collect_set("l_suppkey").alias("supps"),
                 F.count("*").alias("n")))


def basket_parts(session, t, F=F):
    """The baskets exploded back to parts: per part key, its lines and
    the sum of its positions in the baskets."""
    return (order_baskets(session, t, F).select("l_orderkey", "parts")
            .select("l_orderkey", F.posexplode("parts").alias("l_partkey"))
            .groupBy("l_partkey")
            .agg(F.count("*").alias("n"), F.sum("pos").alias("sum_pos")))


def quantity_totals(session, t, F=F):
    """``explode_outer`` of each order's quantity list, summed back per
    order: the non-null quantities' sum and count, and the rows (an
    empty or null list keeps one)."""
    return (session.createDataFrame(t["order_quantities"])
            .select("o_orderkey", F.explode_outer("qty").alias("q"))
            .groupBy("o_orderkey")
            .agg(F.sum("q").alias("total"), F.count("q").alias("n"),
                 F.count("*").alias("rows")))


def q1_struct(session, t, F=F):
    """TPC-H q1 with its two keys as one struct, ``flags``."""
    c = F.col
    return (session.createDataFrame(t["lineitem"])
            .select(F.struct("l_returnflag", "l_linestatus").alias("flags"),
                    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                    "l_shipdate")
            .filter(c("l_shipdate") <= _D(1998, 9, 2))
            .groupBy("flags")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base"),
                 F.sum(c("l_extendedprice")
                       * (1 - c("l_discount"))).alias("sum_disc"),
                 F.sum(c("l_extendedprice") * (1 - c("l_discount"))
                       * (1 + c("l_tax"))).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("cnt"))
            .orderBy("flags"))


def orders_by_info(session, t, F=F):
    """The first 100 orders of ship priority 1 in the order of their
    struct (priority, ship priority, clerk), then of their key."""
    return (session.createDataFrame(t["orders_info"])
            .filter(F.col("o_info").getField("o_shippriority") == 1)
            .orderBy("o_info", "o_orderkey").limit(100))


def name_words(session, t, F=F):
    """A word count over the part names (``split`` and ``explode``)."""
    return (session.createDataFrame(t["part"]).select("p_name")
            .select(F.explode(F.split("p_name", " ")).alias("word"))
            .groupBy("word").count())


def customer_json_fields(session, t, F=F):
    """Three paths out of each customer's JSON document (one missing)."""
    return session.createDataFrame(t["customer_json"]).select(
        "c_custkey",
        F.get_json_object("c_json", "$.nation").alias("nation"),
        F.get_json_object("c_json", "$.acct.bal").alias("bal"),
        F.get_json_object("c_json", "$.missing").alias("missing"))


NESTED_QUERIES = {"order baskets": order_baskets,
                  "basket parts": basket_parts,
                  "quantity totals": quantity_totals,
                  "q1 struct": q1_struct,
                  "orders by info": orders_by_info,
                  "name words": name_words,
                  "customer json": customer_json_fields}
# the operators each query runs on the CPU, as the JAX package does
# (``split``'s array<string> and ``get_json_object`` have no device
# lowering there)
NESTED_ALLOWED = {"name words": "Generate", "customer json": "Project"}


def window_tables(t: Dict[str, pa.Table]) -> Dict[str, pa.Table]:
    """The generated tables with what the window queries need:
    lineitem gets ``l_linenumber`` (the generator has none), each line's
    1-based position among its order's lines in generator order, as
    dbgen numbers an order's lines."""
    li = t["lineitem"]
    key = li["l_orderkey"].to_numpy()
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    pos = np.arange(len(ks)) - np.maximum.accumulate(
        np.where(first, np.arange(len(ks)), 0))
    linenumber = np.empty(len(ks), np.int32)
    linenumber[order] = pos + 1
    out = dict(t)
    out["lineitem"] = li.append_column("l_linenumber",
                                       pa.array(linenumber))
    return out


def supplier_ranks(session, t, F=F, W=None):
    """TPC-DS q67/q70's rank within a partition: revenue per (nation,
    supplier) from lineitem joined with supplier, ranked within each
    nation by revenue, descending, and kept to the top three."""
    W = W or _window()
    c = F.col
    li = session.createDataFrame(t["lineitem"]).select(
        "l_suppkey", "l_extendedprice", "l_discount")
    su = session.createDataFrame(t["supplier"]).select("s_suppkey",
                                                       "s_nationkey")
    rev = (li.join(su, c("l_suppkey") == c("s_suppkey"))
           .groupBy("s_nationkey", "s_suppkey")
           .agg(F.sum(c("l_extendedprice") * (1 - c("l_discount")))
                .alias("revenue")))
    w = W.partitionBy("s_nationkey").orderBy(c("revenue").desc())
    return (rev.select("s_nationkey", "s_suppkey", "revenue",
                       F.rank().over(w).alias("rk"),
                       F.dense_rank().over(w).alias("drk"),
                       F.row_number().over(w).alias("rn"))
            .filter(c("rk") <= 3))


def revenue_share(session, t, F=F, W=None):
    """TPC-DS q98/q12's revenue share: revenue per (type, brand) from
    lineitem joined with part, as a percentage of its type's total (a
    sum over the whole partition)."""
    W = W or _window()
    c = F.col
    li = session.createDataFrame(t["lineitem"]).select(
        "l_partkey", "l_extendedprice", "l_discount")
    pt = session.createDataFrame(t["part"]).select("p_partkey", "p_type",
                                                   "p_brand")
    rev = (li.join(pt, c("l_partkey") == c("p_partkey"))
           .groupBy("p_type", "p_brand")
           .agg(F.sum(c("l_extendedprice") * (1 - c("l_discount")))
                .alias("rev")))
    return (rev.select("p_type", "p_brand", "rev",
                       F.sum("rev").over(W.partitionBy("p_type"))
                       .alias("total"))
            .select("p_type", "p_brand", "rev",
                    (c("rev") * 100 / c("total")).alias("share")))


def order_gaps(session, t, F=F, W=None):
    """TPC-DS q47/q57's lag and lead: each customer's orders in date
    order with the previous order's date, the next order's price, the
    priority two orders back (a string), the order's number, and the
    last fulfilled (status F) order's price before it (IGNORE NULLS)."""
    W = W or _window()
    c = F.col
    w = W.partitionBy("o_custkey").orderBy("o_orderdate", "o_orderkey")
    filled = F.when(c("o_orderstatus") == "F", c("o_totalprice"))
    return _columns(session, t["orders"], "o_custkey", "o_orderkey",
                    "o_orderdate", "o_totalprice", "o_orderpriority",
                    "o_orderstatus").select(
        "o_custkey", "o_orderkey", "o_orderdate",
        F.row_number().over(w).alias("n"),
        F.lag("o_orderdate").over(w).alias("prev_date"),
        F.lead("o_totalprice").over(w).alias("next_price"),
        F.lag("o_orderpriority", 2).over(w).alias("prio_2_back"),
        F.lag(filled, 1, ignorenulls=True).over(w).alias("prev_filled"))


def line_running_totals(session, t, F=F, W=None):
    """Running totals over each order's lines in line-number order: the
    quantity in a ROWS frame, then the lines, the average price, the
    first part and the largest discount so far in the default RANGE
    frame."""
    W = W or _window()
    w = W.partitionBy("l_orderkey").orderBy("l_linenumber")
    rows = w.rowsBetween(W.unboundedPreceding, W.currentRow)
    return _columns(session, t["lineitem"], "l_orderkey", "l_linenumber",
                    "l_partkey", "l_quantity", "l_extendedprice",
                    "l_discount").select(
        "l_orderkey", "l_linenumber",
        F.sum("l_quantity").over(rows).alias("run_qty"),
        F.count("l_extendedprice").over(w).alias("n"),
        F.avg("l_extendedprice").over(w).alias("run_avg_price"),
        F.first("l_partkey").over(w).alias("first_part"),
        F.max("l_discount").over(w).alias("max_disc"))


def trailing_spend(session, t, F=F, W=None):
    """Each customer's trailing spend over bounded frames: the 90 days
    up to an order's date (a RANGE frame on the date), the average of
    the five orders around it and the largest of the four up to it
    (ROWS frames)."""
    W = W or _window()
    w = W.partitionBy("o_custkey").orderBy("o_orderdate")
    return _columns(session, t["orders"], "o_custkey", "o_orderkey",
                    "o_orderdate", "o_totalprice").select(
        "o_custkey", "o_orderkey", "o_orderdate",
        F.sum("o_totalprice").over(w.rangeBetween(-90, 0))
        .alias("spend_90d"),
        F.avg("o_totalprice").over(w.rowsBetween(-2, 2)).alias("avg_5"),
        F.max("o_totalprice").over(w.rowsBetween(-3, 0)).alias("max_4"))


def customer_quartiles(session, t, F=F, W=None):
    """Each customer's balance quartile, percent rank and cumulative
    distribution within its market segment."""
    W = W or _window()
    w = W.partitionBy("c_mktsegment").orderBy("c_acctbal")
    return _columns(session, t["customer"], "c_custkey", "c_mktsegment",
                    "c_acctbal").select(
        "c_custkey", "c_mktsegment", "c_acctbal",
        F.ntile(4).over(w).alias("quartile"),
        F.percent_rank().over(w).alias("pct_rank"),
        F.cume_dist().over(w).alias("cume"))


def top_orders(session, t, F=F, W=None):
    """A window with no partition: every order numbered by price,
    descending, kept to the first 100."""
    W = W or _window()
    c = F.col
    return (_columns(session, t["orders"], "o_orderkey", "o_custkey",
                     "o_totalprice")
            .select("o_orderkey", "o_custkey", "o_totalprice",
                    F.row_number().over(W.orderBy(c("o_totalprice").desc()))
                    .alias("rn"))
            .filter(c("rn") <= 100))


def _window():
    from spark_rapids_tpu_torch.sql.window import Window
    return Window


def _columns(session, table, *names):
    """The table's named columns: a Window keeps every column of its
    child (the optimizer prunes no scan below it), so the queries select
    theirs first, as a subquery would."""
    return session.createDataFrame(table).select(*names)


WINDOW_QUERIES = {"supplier ranks": supplier_ranks,
                  "revenue share": revenue_share,
                  "order gaps": order_gaps,
                  "line running totals": line_running_totals,
                  "customer trailing spend": trailing_spend,
                  "customer quartiles": customer_quartiles,
                  "top orders": top_orders}


TPCH_SF1_CONF = {"spark.rapids.sql.enabled": True,
                 "spark.rapids.tpu.batchRows": 1 << 16,
                 # stats-driven replanning: the adaptive joins, skew
                 # splits and batch retargeting
                 "spark.rapids.tpu.adaptive.enabled": True,
                 # whole-stage fusion of the scan-side filter/project
                 # chains every TPC-H query carries
                 "spark.rapids.tpu.fusion.enabled": True,
                 # consulted only under spark.rapids.shuffle.mode=ICI,
                 # in the JAX package as in the port
                 "spark.rapids.tpu.exchange.mode": "compiled",
                 "spark.rapids.tpu.kernel.backend": "auto",
                 # the result cache probes every query; minRuntimeMs is
                 # above any SF1 query, so timed runs stay misses
                 "spark.rapids.tpu.cache.enabled": True,
                 "spark.rapids.tpu.cache.minRuntimeMs": 10_000_000}

# q2/q7/q11's filters are so selective that sf 0.002 yields zero rows (a
# vacuous check): those three check at sf 0.01 instead (bench.py)
ORACLE_SF = {"q2": 0.01, "q7": 0.01, "q11": 0.01}
ORACLE_DEFAULT_SF = 0.002


def rows_equal(a: pa.Table, b: pa.Table, tol: float = 1e-9) -> bool:
    """Row multiset equality: floats within ``tol`` relative (absolute
    below 1), everything else exactly (``bench._rows_equal``)."""
    la = [tuple(r.values()) for r in a.to_pylist()]
    lb = [tuple(r.values()) for r in b.to_pylist()]
    if len(la) != len(lb):
        return False
    for x, y in zip(sorted(la, key=repr), sorted(lb, key=repr)):
        for u, v in zip(x, y):
            if isinstance(u, float) and isinstance(v, float):
                if abs(u - v) > tol * max(1.0, abs(u), abs(v)):
                    return False
            elif u != v:
                return False
    return True


def build(q: str, session, t: Dict[str, pa.Table]):
    """Query ``q`` (a TPC-H query or a join variant) over the dict of
    tables (q1 and q6 take lineitem alone)."""
    return globals()[q](session, t["lineitem"] if q in ("q1", "q6") else t)


def oracle_check(tables_for: Callable[[float], Dict[str, pa.Table]],
                 device="cuda") -> Dict[str, bool]:
    """bench.py's CPU-oracle loop on the port: each of the 22 builders at
    its small scale (``tables_for(sf)``, sf from ``ORACLE_SF``) under
    ``TPCH_SF1_CONF`` on ``device`` and under the CPU session, compared
    with ``rows_equal(tol=1e-6)``.  Returns ``{query: equal}``."""
    from spark_rapids_tpu_torch.sql.session import TpuSession
    accel = TpuSession(dict(TPCH_SF1_CONF), device=device)
    cpu = TpuSession({"spark.rapids.sql.enabled": False}, device=device)
    out = {}
    for q in QUERIES:
        t = tables_for(ORACLE_SF.get(q, ORACLE_DEFAULT_SF))
        a = build(q, accel, t).toArrow()
        b = build(q, cpu, t).toArrow()
        out[q] = rows_equal(a, b, tol=1e-6)
    return out


# ---------------------------------------------------------------------------
# join variants: rewrites of TPC-H queries (not engine features) that run
# the right join, the residual join conditions and the full join
# ---------------------------------------------------------------------------

def q13_right(session, t: Dict[str, pa.Table]):
    """q13 with its left join written as ``orders RIGHT JOIN customer``:
    a swapped left join, the same rows in the same order, so the result
    equals q13's."""
    orders = (_t(session, t, "orders", "o_orderkey", "o_custkey",
                 "o_comment")
              .filter(~col("o_comment").like("%special%requests%"))
              .select("o_orderkey", "o_custkey"))
    cust = _t(session, t, "customer", "c_custkey")
    per_cust = (orders.join(cust, col("o_custkey") == col("c_custkey"),
                            "right")
                .groupBy("c_custkey")
                .agg(F.count(col("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(col("custdist").desc(), col("c_count").desc()))


def q13_cond(session, t: Dict[str, pa.Table]):
    """TPC-H q13 as the specification writes it: ``customer LEFT OUTER
    JOIN orders ON c_custkey = o_custkey AND o_comment NOT LIKE
    '%special%requests%'``.  Equals q13; the residual condition on a
    left join keeps the join on the CPU (between device scans and
    device aggregates)."""
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_comment")
    cust = _t(session, t, "customer", "c_custkey")
    per_cust = (cust.join(orders, (col("c_custkey") == col("o_custkey"))
                          & ~col("o_comment").like("%special%requests%"),
                          "left")
                .groupBy("c_custkey")
                .agg(F.count(col("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(col("custdist").desc(), col("c_count").desc()))


def q17_cond(session, t: Dict[str, pa.Table]):
    """q17 with ``l_quantity < 0.2 * aq`` in the join condition beside
    ``l_partkey == ap`` (the spec's correlated predicate): an inner equi
    join with a residual condition; equals q17."""
    part = _t(session, t, "part", "p_partkey", "p_brand",
              "p_container").filter(
        (col("p_brand") == "Brand#23")
        & (col("p_container") == "MED BOX")).select("p_partkey")
    li = (_t(session, t, "lineitem", "l_partkey", "l_quantity",
             "l_extendedprice")
          .join(part, col("l_partkey") == col("p_partkey"),
                "left_semi"))
    avgq = (li.groupBy("l_partkey")
            .agg(F.avg(col("l_quantity")).alias("aq"))
            .withColumnRenamed("l_partkey", "ap"))
    return (li.join(avgq, (col("l_partkey") == col("ap"))
                    & (col("l_quantity") < 0.2 * col("aq")))
            .agg(F.sum(col("l_extendedprice")).alias("s"))
            .select((col("s") / 7.0).alias("avg_yearly")))


def q22_cond(session, t: Dict[str, pa.Table]):
    """q22 with ``c_acctbal > ab`` as the condition of the join with the
    average: an inner join without an equi key (a cross product with a
    condition); equals q22."""
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (_t(session, t, "customer", "c_custkey", "c_phone",
               "c_acctbal")
            .select(col("c_custkey"), col("c_acctbal"),
                    F.substring(col("c_phone"), 1, 2)
                    .alias("cntrycode"))
            .filter(col("cntrycode").isin(*codes)))
    avg_bal = (cust.filter(col("c_acctbal") > 0.0)
               .agg(F.avg(col("c_acctbal")).alias("ab")))
    orders = _t(session, t, "orders", "o_custkey")
    return (cust.join(avg_bal, col("c_acctbal") > col("ab"))
            .join(orders, col("c_custkey") == col("o_custkey"),
                  "left_anti")
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum(col("c_acctbal")).alias("totacctbal"))
            .orderBy("cntrycode"))


def q3_full(session, t: Dict[str, pa.Table]):
    """q3's two filtered sides, ``customer`` (BUILDING) FULL JOIN
    ``orders`` (before 1995-03-15), counted: rows, customers, orders and
    the orders' total price."""
    cust = _t(session, t, "customer", "c_custkey", "c_mktsegment").filter(
        col("c_mktsegment") == "BUILDING")
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_orderdate", "o_totalprice").filter(
        col("o_orderdate") < _D(1995, 3, 15))
    return (cust.join(orders, col("c_custkey") == col("o_custkey"),
                      "full")
            .agg(F.count("*").alias("n"),
                 F.count(col("c_custkey")).alias("n_cust"),
                 F.count(col("o_orderkey")).alias("n_orders"),
                 F.sum(col("o_totalprice")).alias("total_price")))


# variant -> the query it must equal (None: no base query)
JOIN_VARIANTS = {"q13_right": "q13", "q17_cond": "q17",
                 "q22_cond": "q22", "q3_full": None, "q13_cond": "q13"}
