"""The port's whole-stage fusion plane against the JAX package's.

Mirrors every case of ``tests/test_fusion.py``: region selection (one
region for a filter -> project -> filter chain, the off and aggressive
modes, ``maxOpsPerRegion``, a Python UDF splitting a chain), the
bit-identity matrix over the skewed, null-heavy and string-heavy
tables, zero-row partitions, a forced shape ladder, the fall-open on a
build failure, the member signatures against an unfused run and
``explain("analyze")``.  Each query runs fused and unfused in the port
(``device="cpu"``: a region's callable is the plain composed chain
there) and against the JAX package's CPU session, exactly; the chain's
region, its node string and its member signatures are held against
the JAX package's fused run.  The CUDA graph a region replays on the
card is held against the plain chain in
``tests/test_torch_tpch_card.py::
test_fused_region_replays_its_cuda_graph_bit_for_bit``.
"""

import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu.exec.fused import FusedStageExec as JaxFused
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.utils import harness as JH
from spark_rapids_tpu.utils.datagen import (
    DoubleGen, LongGen, SkewedLongGen, StringGen, gen_table,
    skewed_null_table)

from spark_rapids_tpu_torch import fusion as FU
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.fused import FusedStageExec
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.utils import harness as H

FUSED = {"spark.rapids.tpu.fusion.enabled": True}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    B.clear_scan_cache()


def tpu(conf=None):
    return H.tpu_session(conf, device="cpu")


def cpu():
    return H.tpu_session({"spark.rapids.sql.enabled": False},
                         device="cpu")


def _canon(t: pa.Table) -> pa.Table:
    t = t.combine_chunks()
    idx = pc.sort_indices(
        t, sort_keys=[(n, "ascending") for n in t.column_names])
    return t.take(idx)


def _assert_identical(a: pa.Table, b: pa.Table, what: str):
    assert _canon(a).equals(_canon(b)), f"{what}: tables differ"


def _regions(node, cls=FusedStageExec):
    out = [node] if isinstance(node, cls) else []
    for c in node.children:
        out.extend(_regions(c, cls))
    return out


def _chain(s, t, c=col):
    """filter -> project -> filter: the canonical 3-op fusable chain."""
    return (s.createDataFrame(t)
            .filter(c("k") % 3 != 1)
            .select((c("k") % 7).alias("k7"), c("v"))
            .filter(c("k7") > 1))


def _jax_cpu(build, t):
    return build(JH.cpu_session(), t, jcol).toArrow()


# ---------------------------------------------------------------------------
# region selection
# ---------------------------------------------------------------------------

def test_chain_fuses_into_one_region():
    t = gen_table([LongGen(min_val=0, max_val=1000, nullable=False),
                   DoubleGen(no_nans=True)], 2000, seed=0,
                  names=["k", "v"])
    df = _chain(tpu(FUSED), t)
    fused = df.toArrow()
    regions = _regions(df._last_plan)
    assert len(regions) == 1
    assert len(regions[0].fusion_members) == 3
    assert "[fused: TpuFilter+TpuProject+TpuFilter]" in \
        regions[0].node_string()
    unfused = _chain(tpu(), t)
    t_off = unfused.toArrow()
    assert _regions(unfused._last_plan) == []
    _assert_identical(fused, t_off, "fused vs unfused")
    _assert_identical(fused, _chain(cpu(), t).toArrow(), "fused vs cpu")
    # the JAX package's fused run: the same region, the same rows
    jdf = _chain(JH.tpu_session(FUSED), t, jcol)
    _assert_identical(fused, jdf.toArrow(), "port vs jax fused")
    (jregion,) = _regions(jdf._last_plan, JaxFused)
    assert regions[0].node_string() == jregion.node_string()
    assert df._last_plan.tree_string() == jdf._last_plan.tree_string()
    assert ([(m["op"], m["sig"], m["path"])
             for m in regions[0].fusion_members]
            == [(m["op"], m["sig"], m["path"])
                for m in jregion.fusion_members])


def test_mode_off_and_aggressive():
    t = gen_table([LongGen(min_val=0, max_val=100, nullable=False),
                   DoubleGen(no_nans=True)], 512, seed=3,
                  names=["k", "v"])

    off = dict(FUSED, **{"spark.rapids.tpu.fusion.mode": "off"})
    df = _chain(tpu(off), t)
    df.toArrow()
    assert _regions(df._last_plan) == []

    # aggressive wraps even a singleton fusable op
    agg = dict(FUSED, **{"spark.rapids.tpu.fusion.mode": "aggressive"})
    df1 = tpu(agg).createDataFrame(t).filter(col("k") > 10)
    out = df1.toArrow()
    regions = _regions(df1._last_plan)
    assert regions and len(regions[0].fusion_members) == 1
    _assert_identical(
        out,
        JH.cpu_session().createDataFrame(t).filter(jcol("k") > 10)
        .toArrow(), "aggressive singleton vs jax cpu")


def test_max_ops_per_region_splits_chain():
    t = gen_table([LongGen(min_val=0, max_val=1000, nullable=False),
                   DoubleGen(no_nans=True)], 1024, seed=4,
                  names=["k", "v"])

    def q(s, t, c=col):
        return (s.createDataFrame(t)
                .filter(c("k") % 2 == 0)
                .select((c("k") % 11).alias("a"), c("v"))
                .filter(c("a") > 2)
                .select((c("a") + 1).alias("b"), c("v")))

    conf = dict(FUSED, **{"spark.rapids.tpu.fusion.maxOpsPerRegion": 2})
    df = q(tpu(conf), t)
    fused = df.toArrow()
    regions = _regions(df._last_plan)
    assert len(regions) == 2
    assert all(len(r.fusion_members) == 2 for r in regions)
    _assert_identical(fused, _jax_cpu(q, t), "split regions vs jax cpu")


def test_udf_mid_chain_splits_region():
    from spark_rapids_tpu.sql import functions as JF
    t = gen_table([LongGen(min_val=0, max_val=500, nullable=False),
                   DoubleGen(no_nans=True)], 600, seed=5,
                  names=["k", "v"])

    def q(s, t, c=col, Fm=F):
        bump = Fm.pandas_udf(lambda x: x + 1.0, "double")
        return (s.createDataFrame(t)
                .filter(c("k") % 3 != 0)
                .select(c("k"), (c("v") * 2).alias("v2"))
                .withColumn("u", bump(c("v2")))
                .filter(c("k") % 5 != 0)
                .select((c("k") % 9).alias("k9"), c("u")))

    df = q(tpu(FUSED), t)
    fused = df.toArrow()
    regions = _regions(df._last_plan)
    # the UDF is a host round trip by definition: one region below it,
    # one above — never one region through it
    assert len(regions) == 2
    want = q(JH.cpu_session(), t, jcol, JF).toArrow()
    _assert_identical(fused, want, "udf-split chain vs jax cpu")


# ---------------------------------------------------------------------------
# bit-identity matrix over the nasty generators
# ---------------------------------------------------------------------------

_GEN_TABLES = {
    "skewed": lambda: pa.table({
        "k": gen_table([SkewedLongGen(hot_mass=0.8, nullable=False)],
                       4000, seed=11, names=["k"])["k"],
        "v": gen_table([DoubleGen(no_nans=True, null_ratio=0.1)],
                       4000, seed=12, names=["v"])["v"]}),
    "null_heavy": lambda: skewed_null_table(4000, seed=13,
                                            null_ratio=0.5)
    .select(["k", "v"]),
    "string_heavy": lambda: gen_table(
        [LongGen(min_val=0, max_val=200, nullable=False),
         StringGen(min_len=0, max_len=16, null_ratio=0.3)],
        4000, seed=14, names=["k", "v"]),
}


@pytest.mark.parametrize("kind", sorted(_GEN_TABLES))
def test_bit_identity_matrix(kind):
    t = _GEN_TABLES[kind]()
    df = _chain(tpu(FUSED), t)
    fused = df.toArrow()
    assert _regions(df._last_plan), "expected a fused region"
    t_off = _chain(tpu(), t).toArrow()
    _assert_identical(fused, t_off, f"{kind}: fused vs unfused")
    _assert_identical(fused, _chain(cpu(), t).toArrow(),
                      f"{kind}: fused vs cpu")
    _assert_identical(fused, _jax_cpu(_chain, t), f"{kind}: vs jax cpu")


def test_zero_row_partitions():
    # (a) a fused region whose predicate keeps nothing
    t = gen_table([LongGen(min_val=0, max_val=50, nullable=False),
                   DoubleGen(no_nans=True)], 300, seed=21,
                  names=["k", "v"])

    def empty_q(s, t, c=col):
        return (s.createDataFrame(t)
                .filter(c("k") < -1)
                .select((c("k") % 3).alias("k3"), c("v"))
                .filter(c("k3") >= 0))

    df = empty_q(tpu(FUSED), t)
    out = df.toArrow()
    assert out.num_rows == 0
    assert _regions(df._last_plan)
    _assert_identical(out, _jax_cpu(empty_q, t), "empty result vs jax cpu")

    # (b) zero-row input partitions: 3 rows across 8 partitions
    tiny = pa.table({"k": pa.array([1, 2, 3], type=pa.int64()),
                     "v": pa.array([1.0, 2.0, 3.0])})

    def part_q(s, t, c=col):
        return (s.createDataFrame(t).repartition(8)
                .filter(c("k") != 2)
                .select((c("k") * 10).alias("k10"), c("v")))

    df2 = part_q(tpu(FUSED), tiny)
    fused2 = df2.toArrow()
    assert _regions(df2._last_plan)
    _assert_identical(fused2, _jax_cpu(part_q, tiny),
                      "zero-row partitions vs jax cpu")


def test_pad_mask_invariance_forced_ladder():
    """Fused regions see the shape plane's pad rows exactly once per
    region; a forced bucket ladder (heavy padding) must not leak pads
    into answers."""
    t = skewed_null_table(3000, seed=31).select(["k", "v"])
    ladder = dict(FUSED, **{
        "spark.rapids.tpu.kernel.bucketing": "ladder",
        "spark.rapids.tpu.kernel.bucketLadder": "1024,8192"})
    off = dict(FUSED, **{"spark.rapids.tpu.kernel.bucketing": "off"})
    df = _chain(tpu(ladder), t)
    t_ladder = df.toArrow()
    assert _regions(df._last_plan)
    t_off = _chain(tpu(off), t).toArrow()
    _assert_identical(t_ladder, t_off, "ladder vs bucketing-off")
    _assert_identical(t_ladder, _jax_cpu(_chain, t), "ladder vs jax cpu")


# ---------------------------------------------------------------------------
# fall-open on a build failure
# ---------------------------------------------------------------------------

def test_compile_failure_falls_open(monkeypatch):
    t = gen_table([LongGen(min_val=0, max_val=100, nullable=False),
                   DoubleGen(no_nans=True)], 1000, seed=41,
                  names=["k", "v"])

    def boom(self):
        raise ValueError("forced region build failure")

    monkeypatch.setattr(FusedStageExec, "_composed", boom)
    before = FU.FALLBACKS.value
    df = _chain(tpu(FUSED), t)
    out = df.toArrow()
    assert FU.FALLBACKS.value > before
    region = _regions(df._last_plan)[0]
    assert region._fell_open
    assert region.metrics["fusionFellOpen"].value == 1
    monkeypatch.undo()
    _assert_identical(out, _jax_cpu(_chain, t), "fell-open region vs cpu")


# ---------------------------------------------------------------------------
# observability: diffable member signatures + EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

def test_member_signatures_diff_against_unfused():
    """The fused run's synthetic member records carry the SAME
    signatures an unfused run of the same query records (and the JAX
    package's fused run records) — what ``profile diff`` needs to line
    fused runs up against unfused history."""
    t = gen_table([LongGen(min_val=0, max_val=1000, nullable=False),
                   DoubleGen(no_nans=True)], 2000, seed=51,
                  names=["k", "v"])
    stats_on = {"spark.rapids.tpu.stats.enabled": True}

    s_off = tpu(stats_on)
    _chain(s_off, t).toArrow()
    prof_off = s_off.last_query_profile()
    sigs_off = {(r["op"], r["sig"]) for r in prof_off["ops"]
                if r["op"] in ("TpuFilterExec", "TpuProjectExec")}

    s_on = tpu(dict(FUSED, **stats_on))
    _chain(s_on, t).toArrow()
    prof_on = s_on.last_query_profile()
    members = [r for r in prof_on["ops"] if "fused_region" in r]
    assert len(members) == 3
    assert {(r["op"], r["sig"]) for r in members} == sigs_off
    assert all(r["fused"] for r in members)
    region = next(r for r in prof_on["ops"] if r.get("region_ops"))
    assert region["region_ops"] == 3
    assert all(m["fused_region"] == region["sig"] for m in members)


def test_explain_analyze_renders_fused_region(capsys):
    t = gen_table([LongGen(min_val=0, max_val=1000, nullable=False),
                   DoubleGen(no_nans=True)], 2000, seed=61,
                  names=["k", "v"])
    df = _chain(tpu(dict(
        FUSED, **{"spark.rapids.tpu.stats.enabled": True})), t)
    df.toArrow()
    df.explain("analyze")
    out = capsys.readouterr().out
    assert "[fused: TpuFilter+TpuProject+TpuFilter]" in out
    assert "region_ops=3" in out


# ---------------------------------------------------------------------------
# what a cached region graph holds (device-free parts of the card's path)
# ---------------------------------------------------------------------------

def test_held_constants_survive_the_memo_cap():
    # the memo drops every entry at its cap; a block that holds its
    # constants keeps serving (and owning) the tensors it read first
    from spark_rapids_tpu_torch.runtime import device as DV
    dev = torch.device("meta")  # not the CPU: goes through the memo

    def mk():
        return torch.zeros(3, dtype=torch.uint8)

    with DV.hold_constants() as held:
        first = DV.device_constant(("test.lit", b"abc"), dev, mk)
        with DV.hold_constants() as inner:
            assert inner is held
        for i in range(DV._CONSTANTS_CAP + 1):
            DV.device_constant(("test.filler", i), dev, mk)
        assert (("test.lit", b"abc"), dev) not in DV._CONSTANTS
        assert DV.device_constant(("test.lit", b"abc"), dev, mk) is first
        assert held[(("test.lit", b"abc"), dev)] is first
    assert DV.device_constant(("test.lit", b"abc"), dev, mk) is not first
    DV._CONSTANTS.clear()


def test_region_graphs_are_bounded_by_bytes(monkeypatch):
    # the graphs' pools and static inputs lie outside the arbiter: the
    # least recently used graphs go beyond the byte cap, the newest stays
    from spark_rapids_tpu_torch.exec import fused as FX
    monkeypatch.setattr(FX, "_GRAPHS_BYTES_CAP", 1000)
    FX.clear_graphs()

    def graph(pool):
        static = [torch.zeros(25, dtype=torch.float64)]  # 200 bytes
        return FX._RegionGraph(None, static, [("graph", static[0])],
                               None, pool)

    try:
        for i in range(4):
            FX._keep(("k", i), graph(200))  # 400 bytes each
        assert list(FX._GRAPHS) == [("k", 2), ("k", 3)]
        assert FX.graph_pool_bytes() == {
            "graphs": 2, "pool_bytes": 400, "static_input_bytes": 400}
        FX._keep(("big",), graph(5000))
        assert list(FX._GRAPHS) == [("big",)]
        assert FX._GRAPHS_BYTES[0] == 5200
    finally:
        FX.clear_graphs()
    assert FX._GRAPHS_BYTES[0] == 0
