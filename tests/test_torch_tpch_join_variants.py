"""The five TPC-H join variants (``utils/tpch.py::JOIN_VARIANTS``)
through the port against the JAX package, where each is built with the
JAX package's own API, and against its base query.

* ``q13_right``: q13's left join written as ``orders RIGHT JOIN
  customer`` (a swapped left join); equals q13;
* ``q17_cond``: q17's ``l_quantity < 0.2 * aq`` as the residual
  condition of its equi join; equals q17;
* ``q22_cond``: q22's ``c_acctbal > ab`` as the condition of an inner
  join without an equi key (a cross product with a condition); equals
  q22;
* ``q3_full``: q3's filtered ``customer`` FULL JOIN its filtered
  ``orders``, counted;
* ``q13_cond``: q13 as the specification writes it, the NOT LIKE in the
  ON clause of the left join; the plan rewrite keeps that join on the
  CPU in both packages (the same fallback report); equals q13.

They run at ``bench.py``'s oracle scale (sf 0.002) under the defaults
and under ``autoBroadcastJoinThreshold=0`` with ``join.targetRows=1024``
(``q13_right``'s right join then sub-partitions as q13's left join
does); q22's anti join keeps nobody at that scale, so ``q22_cond`` also
runs with ``orders`` cut to a tenth; and ``q3_full`` runs at sf 0.05
with both thresholds scaled by 1/20, where its left side fits the row
cap and its right side does not, so that it sub-partitions into k = 3 as
at SF1.  Results must be equal under ``bench._rows_equal(tol=1e-6)``
with equal schemas; each join must take the JAX package's planned type
and broadcast side, with its strategy metrics (the JAX package leaves a
right join's on its inner swapped node, so the port's right join is held
to its base query's left join instead); no hash collision may fall back.
"""

import datetime

import pytest
import torch

import bench
import chip_smoke

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
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


SF = 0.002
CONFS = {
    "defaults": {},
    "noBroadcast": {"spark.sql.autoBroadcastJoinThreshold": 0,
                    "spark.rapids.tpu.join.targetRows": 1024},
}
# the SF1 thresholds scaled by 1/20 (sizes and live rows scale with sf)
SF1_AT_005 = {"spark.sql.autoBroadcastJoinThreshold": (10 << 20) // 20,
              "spark.rapids.tpu.join.targetRows": (1 << 18) // 20}
_STRATEGY = ("streamedJoins", "subPartitionJoins")
_t = bench._t


# ---------------------------------------------------------------------------
# the variants on the JAX package's API
# ---------------------------------------------------------------------------

def jax_q13_right(s, t):
    orders = (_t(s, t, "orders", "o_orderkey", "o_custkey", "o_comment")
              .filter(~jcol("o_comment").like("%special%requests%"))
              .select("o_orderkey", "o_custkey"))
    cust = _t(s, t, "customer", "c_custkey")
    per_cust = (orders.join(cust, jcol("o_custkey") == jcol("c_custkey"),
                            "right")
                .groupBy("c_custkey")
                .agg(JF.count(jcol("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(JF.count("*").alias("custdist"))
            .orderBy(jcol("custdist").desc(), jcol("c_count").desc()))


def jax_q17_cond(s, t):
    part = _t(s, t, "part", "p_partkey", "p_brand", "p_container").filter(
        (jcol("p_brand") == "Brand#23")
        & (jcol("p_container") == "MED BOX")).select("p_partkey")
    li = (_t(s, t, "lineitem", "l_partkey", "l_quantity",
             "l_extendedprice")
          .join(part, jcol("l_partkey") == jcol("p_partkey"), "left_semi"))
    avgq = (li.groupBy("l_partkey")
            .agg(JF.avg(jcol("l_quantity")).alias("aq"))
            .withColumnRenamed("l_partkey", "ap"))
    return (li.join(avgq, (jcol("l_partkey") == jcol("ap"))
                    & (jcol("l_quantity") < 0.2 * jcol("aq")))
            .agg(JF.sum(jcol("l_extendedprice")).alias("s"))
            .select((jcol("s") / 7.0).alias("avg_yearly")))


def jax_q22_cond(s, t):
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (_t(s, t, "customer", "c_custkey", "c_phone", "c_acctbal")
            .select(jcol("c_custkey"), jcol("c_acctbal"),
                    JF.substring(jcol("c_phone"), 1, 2).alias("cntrycode"))
            .filter(jcol("cntrycode").isin(*codes)))
    avg_bal = (cust.filter(jcol("c_acctbal") > 0.0)
               .agg(JF.avg(jcol("c_acctbal")).alias("ab")))
    orders = _t(s, t, "orders", "o_custkey")
    return (cust.join(avg_bal, jcol("c_acctbal") > jcol("ab"))
            .join(orders, jcol("c_custkey") == jcol("o_custkey"),
                  "left_anti")
            .groupBy("cntrycode")
            .agg(JF.count("*").alias("numcust"),
                 JF.sum(jcol("c_acctbal")).alias("totacctbal"))
            .orderBy("cntrycode"))


def jax_q13_cond(s, t):
    orders = _t(s, t, "orders", "o_orderkey", "o_custkey", "o_comment")
    cust = _t(s, t, "customer", "c_custkey")
    per_cust = (cust.join(orders, (jcol("c_custkey") == jcol("o_custkey"))
                          & ~jcol("o_comment").like("%special%requests%"),
                          "left")
                .groupBy("c_custkey")
                .agg(JF.count(jcol("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(JF.count("*").alias("custdist"))
            .orderBy(jcol("custdist").desc(), jcol("c_count").desc()))


def jax_q3_full(s, t):
    cust = _t(s, t, "customer", "c_custkey", "c_mktsegment").filter(
        jcol("c_mktsegment") == "BUILDING")
    orders = _t(s, t, "orders", "o_orderkey", "o_custkey", "o_orderdate",
                "o_totalprice").filter(
        jcol("o_orderdate") < datetime.date(1995, 3, 15))
    return (cust.join(orders, jcol("c_custkey") == jcol("o_custkey"),
                      "full")
            .agg(JF.count("*").alias("n"),
                 JF.count(jcol("c_custkey")).alias("n_cust"),
                 JF.count(jcol("o_orderkey")).alias("n_orders"),
                 JF.sum(jcol("o_totalprice")).alias("total_price")))


# ---------------------------------------------------------------------------

def _joins(root):
    """(join type, broadcast side, strategy metrics) of each join of a
    plan after its run, root first."""
    out = []

    def walk(node):
        if type(node).__name__ == "TpuSortMergeJoinExec":
            m = {k: v.value for k, v in node.metrics.items()}
            out.append((node.join_type, node.broadcast,
                        tuple(m.get(k, 0) for k in _STRATEGY)))
        for c in node.children:
            walk(c)

    walk(root)
    return out


@pytest.fixture(scope="module")
def tables():
    t = bench.gen_tpch(SF)
    few = dict(t)  # q22 keeps customers only where orders are few
    few["orders"] = t["orders"].slice(0, t["orders"].num_rows // 10)
    return {"sf": t, "few_orders": few}


def _run(variant, conf, t):
    KN.COUNTERS.reset()
    session = TpuSession(dict(conf), device="cpu")
    df = getattr(tpch, variant)(session, t)
    got = df.toArrow()
    assert KN.COUNTERS.fallbacks == 0
    jdf = globals()["jax_" + variant](JaxSession(dict(conf)), t)
    want = jdf.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert (df._last_override.fallback_report()
            == jdf._last_override.fallback_report())
    return got, df, _joins(jdf._last_override.plan)


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("variant, data", [
    ("q13_right", "sf"), ("q17_cond", "sf"), ("q22_cond", "sf"),
    ("q22_cond", "few_orders"), ("q3_full", "sf"), ("q13_cond", "sf")])
def test_variant_matches_jax_and_its_base_query(tables, variant, data,
                                                conf):
    t = tables[data]
    got, df, want_joins = _run(variant, CONFS[conf], t)
    joins = _joins(df._last_plan)
    base = tpch.JOIN_VARIANTS[variant]
    if base is None:
        assert got.num_rows == 1 and got.column("n")[0].as_py() > 0
        assert joins == want_joins
        return
    bdf = getattr(tpch, base)(TpuSession(dict(CONFS[conf]), device="cpu"),
                              t)
    # the same rows survive, in the same order
    assert got.equals(bdf.toArrow())
    assert got.num_rows > 0 or (variant == "q22_cond" and data == "sf")
    base_joins = _joins(bdf._last_plan)
    if variant == "q13_right":
        # the JAX package's outer right-join node keeps no strategy
        # metric; the port forwards its swapped left join's
        ((jt, bc, strategy),) = joins
        assert [(jt, bc)] == [(j, b) for j, b, _ in want_joins]
        assert (jt, bc) == ("right", None)
        assert [strategy] == [s for _, _, s in base_joins]
    elif variant == "q13_cond":
        # the left join stays on the CPU: no device join in either plan
        assert joins == want_joins == []
        assert df.fallback_summary()["fallback_reasons"] == [
            "CpuJoinExec: residual join conditions on left joins not yet "
            "on device (inner/cross only)"]
    elif variant == "q22_cond":
        # the inner join without an equi key stands where q22 crosses
        assert joins == want_joins
        assert [j[0] for j in joins] == ["left_anti", "inner"]
        assert [j[1:] for j in joins] == [j[1:] for j in base_joins]
    else:
        assert joins == want_joins == base_joins


@pytest.fixture(scope="module")
def tables_005():
    return bench.gen_tpch(0.05)


def test_q3_full_sub_partitions_as_at_sf1(tables_005):
    t = tables_005
    got, df, want_joins = _run("q3_full", SF1_AT_005, t)
    ((jt, bc, strategy),) = _joins(df._last_plan)
    assert (jt, bc, strategy) == ("full", None, (0, 1))
    assert want_joins == [("full", None, (0, 1))]
    (m,) = [m for name, m in df.metrics()
            if name == "TpuSortMergeJoinExec"]
    # k = ceil(~36k live orders / 13107); each pair's slices still pad
    # past the cap and split again in two, as at SF1
    assert m["subPartitions"] == 3 and m["subPartitionResplits"] == 6
    want = chip_smoke.ref_q3_full(t)
    assert got.column_names == want.column_names
    assert chip_smoke.rows_equal(got, want)


def test_sf1_strategies_of_the_variants_at_a_small_scale(tables_005):
    """The strategies ``chip_smoke.py`` pins for the variants at SF1
    (``VARIANT_STRATEGIES``; q3_full's k = 3), reproduced at sf 0.05 with
    both thresholds scaled by 1/20, and each result against its pyarrow
    reference there."""
    session = TpuSession(dict(SF1_AT_005), device="cpu")
    for v in tpch.JOIN_VARIANTS:
        df = chip_smoke.build_on(v, session, tables_005)
        got = df.toArrow()
        chip_smoke.check_variant_strategies(
            v, chip_smoke.join_strategies(df))
        want = getattr(chip_smoke, "ref_" + v)(tables_005)
        assert got.column_names == want.column_names, v
        assert chip_smoke.rows_equal(got, want), v
