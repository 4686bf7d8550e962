"""TPC-H's eight tables, and the builders of the fifteen queries that
need no string pattern matching, for this port.

``gen_tpch`` reproduces the repository's ``bench.gen_tpch`` exactly (the same rng streams
``default_rng([seed, k])``, the same draws in the same order, the same
column types and buffers) without importing it, so the port can run
TPC-H on its own.  Draws from a list of strings are taken as indices
and decoded through an arrow dictionary, which gives the same values as
``rng.choice(values, n)`` (that draws ``integers(0, len(values), n)``,
or one ``random`` per row against the cumulative ``p``) without building
a Python list of n strings; the formatted string columns are built
column-wise with arrow compute.

``q1``, ``q3``, ``q4``, ``q5``, ``q6``, ``q7``, ``q8``, ``q10``, ``q11``,
``q12``, ``q15``, ``q17``, ``q18``, ``q19`` and ``q21`` transcribe
``bench.py``'s builders onto this port's DataFrame API (those import the
JAX package).
"""

from __future__ import annotations

import datetime
from typing import Dict

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


def q10(session, t: Dict[str, pa.Table]):
    """TPC-H q10 (``bench.q10``): returned item reporting — three joins,
    a grouped sum over a double and a string key, a top 20."""
    cust = _t(session, t, "customer", "c_custkey", "c_nationkey",
              "c_name", "c_acctbal")
    orders = _t(session, t, "orders", "o_orderkey", "o_custkey",
                "o_orderdate").filter(
        (col("o_orderdate") >= _D(1993, 10, 1))
        & (col("o_orderdate") < _D(1994, 1, 1)))
    li = _t(session, t, "lineitem", "l_orderkey", "l_extendedprice",
            "l_discount", "l_returnflag").filter(
        col("l_returnflag") == "R")
    nation = _t(session, t, "nation", "n_nationkey", "n_name")
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
    li = _t(session, t, "lineitem", "l_orderkey", "l_shipmode",
            "l_shipdate", "l_commitdate", "l_receiptdate").filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_receiptdate") >= _D(1994, 1, 1))
        & (col("l_receiptdate") < _D(1995, 1, 1))
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate")))
    orders = _t(session, t, "orders", "o_orderkey", "o_orderpriority")
    high = (F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), 1)
            .otherwise(0))
    return (li.join(orders, col("l_orderkey") == col("o_orderkey"))
            .groupBy("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(1 - high).alias("low_line_count"))
            .orderBy("l_shipmode"))


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


# the fifteen ported queries, in TPC-H order; q1 and q6 take lineitem,
# the others the dict of tables
QUERIES = ("q1", "q3", "q4", "q5", "q6", "q7", "q8", "q10", "q11", "q12",
           "q15", "q17", "q18", "q19", "q21")
