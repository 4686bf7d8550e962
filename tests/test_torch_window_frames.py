"""Window functions over bounded ROWS frames and RANGE frames in the port
against the JAX package: the frame cases of ``tests/test_window.py``
(``tests/test_torch_window.py::FRAME_CASES``: trailing, centered,
following and empty ROWS frames, nulls and NaN/Inf in the values, min,
max and first over ROWS frames, sum, count, avg, min, max and first
over RANGE frames, unbounded RANGE ends, the descending RANGE frame's
fallback) and the two window cases of ``tests/test_decimal128.py``.

Each runs through the port's session (``device="cpu"``) and through the
JAX package's, as ``tests/test_torch_window.py`` holds the other cases:
results, tree strings and fallback reports equal, doubles within 1e-6
where the JAX test passes ``approx_float``; the CPU sessions of both
packages equal too.  The JAX test's slow parameters hold the port to
the JAX package's CPU session and its plan made without running it.
"""

import pytest
import torch

from spark_rapids_tpu.runtime.device import ensure_initialized

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from tests.test_torch_window import (  # noqa: E402
    FRAME_CASES, check_device, check_host, make_jax_run)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ensure_initialized()
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


@pytest.fixture(scope="module")
def jax_run():
    return make_jax_run()


@pytest.mark.parametrize("name", FRAME_CASES)
def test_device_equals_jax(jax_run, name):
    got = check_device(name, jax_run)
    if name == "bounded_rows_frame_nan_inf_isolated":
        # a NaN or Inf row poisons no frame that excludes it
        rows = {r["o"]: r["s"] for r in got.to_pylist()}
        assert rows[2] == 3.0 and rows[5] == 11.0
        assert rows[3] == float("inf")
    if name == "small_decimal_window_sum_falls_back":
        # 11 x 9e17 past 18 digits, exact on the CPU window
        import decimal
        assert got.column("sd").to_pylist()[0] == decimal.Decimal(
            99 * 10 ** 17)


@pytest.mark.parametrize("name", FRAME_CASES)
def test_host_equals_jax(jax_run, name):
    check_host(name, jax_run)
