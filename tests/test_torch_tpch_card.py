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
