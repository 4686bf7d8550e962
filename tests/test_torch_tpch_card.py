"""The ported TPC-H slice on the CUDA card, where a CPU run cannot show
a fault: float sums in atomic order, the seven string-pattern queries
and the join variants (``q13_cond``'s CPU join between device scans and
aggregates among them) on the card against the same queries on the CPU,
and bench's CPU-oracle loop on the card.  Imports
neither JAX nor the JAX package, so that it also runs on a machine with
a card and no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_tpch_card.py

Every test carries the ``gpu`` marker and skips without a card.
"""

import pytest
import torch

import chip_smoke

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.aggregate import segment_groupby
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these tests hold the port on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_grouped_float_sums_are_deterministic(cuda_device):
    """The same grouped float sum gives the same bits in every run (few
    groups: many atomic adds land on each slot)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    n = 1 << 20
    key = DeviceColumn(T.LongT, torch.randint(
        0, 6, (n,), device=cuda_device, generator=gen))
    val = DeviceColumn(T.DoubleT, torch.rand(
        (n,), device=cuda_device, generator=gen, dtype=torch.float64) * 1e4)
    sel = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    runs = [segment_groupby([key], sel, [(val, "sum")],
                            backend="cuda")[1][0].data for _ in range(4)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.gpu
def test_q15_finds_its_top_supplier_in_every_run(cuda_device):
    """q15 filters a grouped sum by the max of a second run of the same
    subtree: with sums in a varying order the filter can drop the top
    supplier."""
    t = tpch.gen_tpch(0.05)
    session = TpuSession(device=cuda_device)
    for _ in range(5):
        assert tpch.q15(session, t).toArrow().num_rows == 1


@pytest.fixture(scope="module")
def small_tables():
    t = tpch.gen_tpch(0.01)
    few = dict(t)  # q22 keeps customers only where orders are few
    few["orders"] = t["orders"].slice(0, t["orders"].num_rows // 10)
    return t, few


@pytest.mark.gpu
@pytest.mark.parametrize("query",
                         chip_smoke.STRING_QUERIES + ("q22_few_orders",))
def test_string_query_on_the_card_equals_the_cpu(cuda_device, small_tables,
                                                 query):
    """Each string-pattern query gives the same rows on the card as on the
    CPU (floats within 1e-9 relative), at sf 0.01."""
    t, few = small_tables
    q, tables = (("q22", few) if query == "q22_few_orders"
                 else (query, t))
    got = getattr(tpch, q)(TpuSession(device=cuda_device), tables).toArrow()
    want = getattr(tpch, q)(TpuSession(device="cpu"), tables).toArrow()
    assert got.schema == want.schema
    assert chip_smoke.rows_equal(got, want)
    assert got.num_rows > 0 or q == "q22"


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(tpch.JOIN_VARIANTS))
def test_join_variant_on_the_card_equals_the_cpu(cuda_device, small_tables,
                                                 variant):
    """Each join variant (a right join, residual conditions, a full join)
    gives the same rows on the card as on the CPU and as its pyarrow
    reference, at sf 0.01."""
    t, _ = small_tables
    got = getattr(tpch, variant)(TpuSession(device=cuda_device),
                                 t).toArrow()
    want = getattr(tpch, variant)(TpuSession(device="cpu"), t).toArrow()
    assert got.schema == want.schema
    assert chip_smoke.rows_equal(got, want)
    assert chip_smoke.rows_equal(got, getattr(chip_smoke,
                                              "ref_" + variant)(t))


@pytest.mark.gpu
def test_oracle_check_on_the_card(cuda_device):
    """bench's CPU-oracle loop (``tpch.oracle_check``) on the card: the 22
    builders at its small scales under ``TPCH_SF1_CONF`` equal the
    port's CPU session."""
    cache = {}

    def tables_for(sf):
        if sf not in cache:
            cache[sf] = tpch.gen_tpch(sf)
        return cache[sf]

    out = tpch.oracle_check(tables_for, device=cuda_device)
    assert list(out) == list(tpch.QUERIES)
    assert all(out.values()), out


@pytest.mark.gpu
def test_scan_cache_and_dictionary_decode_on_the_card(cuda_device,
                                                      small_tables):
    """A warm run reads every scan from the card's cache and equals the
    cold run; after a spill of every entry to host, the next run
    restores them; q1 over dictionary-encoded lineitem equals q1."""
    from spark_rapids_tpu_torch.exec import basic as B
    t, _ = small_tables
    session = TpuSession(device=cuda_device)
    B.clear_scan_cache()
    cold = tpch.q3(session, t).toArrow()
    warm_df = tpch.q3(session, t)
    assert warm_df.toArrow().equals(cold)
    assert all(t_ == 0 for t_ in chip_smoke.scan_transfer_times(warm_df))
    for _, sp in chip_smoke.cache_entries():
        assert sp.tier == "device" and sp.device.type == "cuda"
        sp.spill_to_host()
    assert tpch.q3(session, t).toArrow().equals(cold)
    assert all(sp.tier == "device" for _, sp in chip_smoke.cache_entries())
    li = t["lineitem"]
    plain = tpch.q1(session, li).toArrow()
    enc = tpch.q1(session, chip_smoke.dictionary_lineitem(li)).toArrow()
    assert enc.equals(plain)
    B.clear_scan_cache()


@pytest.mark.gpu
def test_fused_region_replays_its_cuda_graph_bit_for_bit(cuda_device,
                                                         small_tables):
    """A fused region on the card captures one CUDA graph per input
    shape and replays it for every later batch: q1 and q3 fused equal
    their unfused runs on the card bit for bit (the plain chain of the
    same functions), a second run only replays, no region falls open,
    and a batch held from an earlier replay is not overwritten by a
    later one."""
    import pyarrow as pa
    from spark_rapids_tpu_torch import fusion as FU
    from spark_rapids_tpu_torch.exec import fused as FX
    from spark_rapids_tpu_torch.sql.column import col
    t, _ = small_tables
    fused = TpuSession({"spark.rapids.tpu.fusion.enabled": True,
                        "spark.rapids.tpu.batchRows": 4096},
                       device=cuda_device)
    plain = TpuSession({"spark.rapids.tpu.batchRows": 4096},
                       device=cuda_device)
    fallbacks = FU.FALLBACKS.value
    FX.clear_graphs()  # this test's shapes capture here, whatever ran
    for q in ("q1", "q3"):
        want = tpch.build(q, plain, t).toArrow()
        s0 = FX.program_stats()
        first = tpch.build(q, fused, t)
        assert first.toArrow().equals(want), q
        assert "FusedStage" in first._last_plan.tree_string()
        s1 = FX.program_stats()
        assert s1["captures"] > s0["captures"], q
        again = tpch.build(q, fused, t).toArrow()
        s2 = FX.program_stats()
        assert again.equals(want), q
        assert s2["captures"] == s1["captures"], q
        assert s2["replays"] > s1["replays"], q
    assert FU.FALLBACKS.value == fallbacks
    # outputs held across replays keep their bits
    tab = pa.table({"k": list(range(20_000)),
                    "v": [float(i) for i in range(20_000)]})
    df = (fused.createDataFrame(tab).filter(col("k") % 3 != 0)
          .select((col("v") * 2).alias("w"), col("k")))
    region = next(n for n in [df._execute_plan().children[0]]
                  if isinstance(n, FX.FusedStageExec))
    batches = [b for p in range(region.num_partitions())
               for b in region.execute(p)]
    before = [b.columns[0].data.clone() for b in batches]
    for p in range(region.num_partitions()):
        for _ in region.execute(p):
            pass
    assert all(torch.equal(x, b.columns[0].data)
               for x, b in zip(before, batches))
    assert FX.graph_pool_bytes()["graphs"] > 0


@pytest.mark.gpu
def test_region_graph_owns_its_constants_past_the_memo_cap(cuda_device):
    """A captured region reads its string literals at the addresses it
    was captured with: filling the constants' memo past its cap (which
    drops every entry) and refilling the freed memory leaves every later
    replay equal to the unfused run."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import fused as FX
    from spark_rapids_tpu_torch.runtime import device as DV
    from spark_rapids_tpu_torch.sql.column import col
    n = 50_000
    tab = pa.table({"k": list(range(n)),
                    "s": [f"w{i % 97}" for i in range(n)]})
    conf = {"spark.rapids.tpu.batchRows": 4096}
    fused = TpuSession(dict(conf, **{"spark.rapids.tpu.fusion.enabled":
                                     True}), device=cuda_device)
    plain = TpuSession(conf, device=cuda_device)

    def q(s):
        return (s.createDataFrame(tab)
                .filter((col("s") == "w13") | col("s").contains("w4"))
                .select((col("k") * 3).alias("k3"), col("s")))

    want = q(plain).toArrow()
    FX.clear_graphs()
    assert q(fused).toArrow().equals(want)  # the eager run and capture
    s0 = FX.program_stats()
    assert s0["captures"] > 0
    for i in range(DV._CONSTANTS_CAP + 1):
        DV.device_constant(("test.filler", i), cuda_device,
                           lambda: torch.zeros(1, dtype=torch.uint8))
    junk = [torch.full((64,), 255, dtype=torch.uint8, device=cuda_device)
            for _ in range(4096)]
    got = q(fused).toArrow()
    assert FX.program_stats()["replays"] > s0["replays"]
    assert FX.program_stats()["captures"] == s0["captures"]
    assert got.equals(want)
    del junk
