"""The ported TPC-H slice on the CUDA card, where a CPU run cannot show
a fault: float sums in atomic order.  Imports neither JAX nor the JAX
package, so that it also runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_tpch_card.py

Every test carries the ``gpu`` marker and skips without a card.
"""

import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.aggregate import segment_groupby
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: atomic float adds run in a varying "
                    "order only on the card")
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
