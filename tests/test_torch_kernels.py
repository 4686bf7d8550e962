"""The port's hash kernel module against the JAX package.

``spark_rapids_tpu_torch.kernels.cuda_backend.hash_pairs`` replaces the
Pallas kernel ``spark_rapids_tpu.kernels.pallas_backend.hash_pairs``.
Its plain PyTorch version (what the wrapper runs on CPU tensors) must
give the JAX package's ``hash_limbs`` bits exactly, and so must the
Pallas kernel in interpret mode on the same limbs.  The CUDA kernel
itself is held against the plain version by the ``gpu`` test at the
end, which runs only where there is a card (and by chip_smoke.py).

The wrapper takes a row set as an ``int64[L, n]`` tensor or as a list of
limbs read where they lie, and ``hash_pairs_multi`` takes two sets of
different n for one launch; a set of more than ``LIMB_CAP`` limbs is a
chain of launches, whose plan is checked here and whose bits the ``gpu``
tests check on the card.

Limbs are made with numpy from a fixed seed, half of them with the top
bit set, and handed to both packages; the port carries them as int64
bit patterns (``np.ndarray.view``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()  # x64, so the JAX limbs are real uint64

from spark_rapids_tpu.kernels import hash_layout as JHL  # noqa: E402
from spark_rapids_tpu.kernels import pallas_backend as JPB  # noqa: E402

from spark_rapids_tpu_torch import kernels as KN  # noqa: E402
from spark_rapids_tpu_torch.kernels import cuda_backend as CB  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash_layout as HL  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs_np(n_limbs: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_limbs):
        a = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        if j % 2 == 0:
            a |= np.uint64(1 << 63)  # top bit set
        else:
            a[::3] |= np.uint64(1 << 63)
        out.append(a)
    return out


def _jax_hash(limbs_np):
    return np.asarray(JHL.hash_limbs([jnp.asarray(a) for a in limbs_np]))


def _jax_pallas_hash(limbs_np):
    limbs = [jnp.asarray(a) for a in limbs_np]
    his = jnp.stack([JHL.split_u64(l)[0] for l in limbs])
    los = jnp.stack([JHL.split_u64(l)[1] for l in limbs])
    hi, lo = JPB.hash_pairs(his, los, interpret=True)
    return np.asarray((hi.astype(jnp.uint64) << jnp.uint64(32))
                      | lo.astype(jnp.uint64))


def _port_stack(limbs_np):
    return torch.from_numpy(np.stack(limbs_np).view(np.int64))


@pytest.mark.parametrize("n", [512, 5000, 8192])
@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_plain_hash_bit_identical_to_jax_and_pallas(n_limbs, n):
    limbs_np = _limbs_np(n_limbs, n, seed=100 * n_limbs + n)
    ref = _jax_hash(limbs_np)
    assert np.array_equal(ref, _jax_pallas_hash(limbs_np))
    stacked = _port_stack(limbs_np)
    plain = CB.hash_pairs_plain(stacked).numpy().view(np.uint64)
    assert np.array_equal(plain, ref)
    # on a CPU tensor the wrapper runs the plain version, not the kernel
    before = CB.launches
    wrapped = CB.hash_pairs(stacked).numpy().view(np.uint64)
    assert np.array_equal(wrapped, ref)
    assert CB.launches == before
    got = HL.hash_limbs(list(stacked.unbind(0)), use_kernel=True)
    assert np.array_equal(got.numpy().view(np.uint64), ref)


def test_mix_rounds_matches_jax_lanes():
    rng = np.random.default_rng(3)
    lanes = [rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(
        np.uint32) for _ in range(4)]
    jh, jl = JHL.mix_rounds(*[jnp.asarray(x) for x in lanes])
    th, tl = HL.mix_rounds(*[torch.from_numpy(x.astype(np.int64))
                             for x in lanes])
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))


def _i64(n, device="cpu"):
    return torch.zeros((n,), dtype=torch.int64, device=device)


@pytest.mark.parametrize("bad, exc", [
    (torch.zeros((2, 8), dtype=torch.int32), TypeError),
    (torch.zeros((8,), dtype=torch.int64), TypeError),
    (torch.zeros((0, 8), dtype=torch.int64), ValueError),
    (torch.zeros((8, 2), dtype=torch.int64).t(), ValueError),
    # the list form
    ([], ValueError),
    ([_i64(8), _i64(9)], ValueError),  # mixed n within a set
    ([_i64(8), torch.zeros((8,), dtype=torch.int32)], TypeError),
    ([_i64(8), torch.zeros((8, 1), dtype=torch.int64)], TypeError),
    ([_i64(16)[::2]], ValueError),  # stride 2
    ([_i64(8), _i64(8, "meta")], ValueError),  # mixed devices
    ([np.zeros(8, np.int64)], TypeError),
    (np.zeros((1, 8), np.int64), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        CB.hash_pairs(bad)


@pytest.mark.parametrize("sets", [
    [],
    [[_i64(8)]] * 3,  # three sets
    [[_i64(8)], [_i64(8, "meta")]],  # sets on different devices
    [[_i64(8)], [_i64(8), _i64(7)]],  # a bad set beside a good one
])
def test_multi_rejects_what_the_kernel_does_not_take(sets):
    with pytest.raises(ValueError):
        CB.hash_pairs_multi(sets)


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4, 9, 17])
def test_list_and_two_set_entry_points_bit_identical_to_jax(n_limbs):
    """Two sets of different n (and one of them odd), as a list and as a
    stacked tensor, L up to past two launches' worth of limbs."""
    sets_np = [_limbs_np(n_limbs, n, seed=7 * n_limbs + n)
               for n in (700, 1501)]
    refs = [_jax_hash(x) for x in sets_np]
    for x, ref in zip(sets_np, refs):
        assert np.array_equal(ref, _jax_pallas_hash(x))
    lists = [list(_port_stack(x).unbind(0)) for x in sets_np]
    before = CB.launches
    for got in (CB.hash_pairs_multi(lists),
                CB.hash_pairs_multi([lists[0], _port_stack(sets_np[1])]),
                [CB.hash_pairs(lists[0]), CB.hash_pairs(lists[1])],
                [HL.hash_limbs(lists[0], use_kernel=True),
                 HL.hash_limbs(lists[1], use_kernel=True)]):
        assert len(got) == 2
        for g, ref in zip(got, refs):
            assert np.array_equal(g.numpy().view(np.uint64), ref)
    assert CB.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("lengths", [
    (CB.LIMB_CAP + 1, 1), (1, 2 * CB.LIMB_CAP + 1), (CB.LIMB_CAP, 3),
    (2 * CB.LIMB_CAP + 1, CB.LIMB_CAP + 1)])
def test_launch_plan_chains_limbs_past_the_capacity(lengths):
    """Launch k takes each set's limbs k*CAP .. (k+1)*CAP - 1, the sets
    that still have limbs in order, chained after the first launch."""
    cap = CB.LIMB_CAP
    todo = [([1000 * (s + 1) + 8 * j for j in range(L)], 77 + s, 5 + s)
            for s, L in enumerate(lengths)]
    args = CB.launch_args(todo, device_index=3)
    assert len(args) == -(-max(lengths) // cap)
    for k, arg in enumerate(args):
        fields = CB.LAUNCH_LAYOUT.unpack(arg)
        num_sets, device = fields[-2:]
        assert device == 3
        live = [t for t in todo if len(t[0]) > k * cap]
        assert num_sets == len(live)
        for i in range(CB.MAX_SETS):
            limb = fields[i * (cap + 4):i * (cap + 4) + cap]
            out, n, n_limbs, chained = fields[i * (cap + 4) + cap:
                                              (i + 1) * (cap + 4)]
            if i >= len(live):
                assert not any(limb) and (out, n, n_limbs) == (0, 0, 0)
                continue
            ptrs, want_out, want_n = live[i]
            part = ptrs[k * cap:(k + 1) * cap]
            assert list(limb) == part + [0] * (cap - len(part))
            assert (out, n, n_limbs, chained) == (want_out, want_n,
                                                  len(part), int(k > 0))


def test_launch_layout_is_the_c_structs():
    """``HashLaunch``: per set 8 pointers, out, n (8 bytes each), then
    two 4-byte ints; after the sets, two 4-byte ints; no padding."""
    per_set = 8 * (CB.LIMB_CAP + 2) + 2 * 4
    assert CB.LAUNCH_LAYOUT.size == CB.MAX_SETS * per_set + 2 * 4
    src = (CB._CSRC / "hash_pairs.cu").read_text()
    assert f"constexpr int kCap = {CB.LIMB_CAP};" in src
    assert f"constexpr int kSets = {CB.MAX_SETS};" in src


@pytest.mark.parametrize("n_limbs", [CB.LIMB_CAP + 1, 2 * CB.LIMB_CAP + 1])
def test_chained_state_is_the_output_word(n_limbs):
    """What a chained launch relies on: folding limbs CAP.. into the
    state read back from the previous launch's output word gives the
    JAX package's hash of all the limbs."""
    limbs_np = _limbs_np(n_limbs, 999, seed=n_limbs)
    limbs = list(_port_stack(limbs_np).unbind(0))
    word = torch.zeros(999, dtype=torch.int64)
    for k in range(0, n_limbs, CB.LIMB_CAP):
        hi, lo = HL.split_u64(word)
        for l in limbs[k:k + CB.LIMB_CAP]:
            hi, lo = HL.mix_rounds(hi, lo, *HL.split_u64(l))
        word = (hi << 32) | lo
    assert np.array_equal(word.numpy().view(np.uint64), _jax_hash(limbs_np))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(CB.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CB.build()


# ---------------------------------------------------------------------------
# the rung ladder
# ---------------------------------------------------------------------------

def test_resolve():
    assert KN.resolve("agg", "auto") == "cuda"
    assert KN.resolve("agg", "CUDA") == "cuda"
    assert KN.resolve("agg", "jnp") == "jnp"
    with pytest.raises(ValueError):
        KN.resolve("agg", "pallas")


def test_dispatch_descends_on_collision_only():
    KN.COUNTERS.reset()
    calls = []

    def runner(be):
        def call():
            calls.append(be)
            if be == "cuda":
                return "hash", torch.tensor(False)
            return "exact", None
        return call

    assert KN.dispatch("agg", "cuda", runner) == "exact"
    assert calls == ["cuda", "jnp"]
    assert KN.COUNTERS.fallbacks == 1
    assert KN.COUNTERS.dispatches == {"cuda": 0, "jnp": 1}

    ok = KN.dispatch("agg", "cuda",
                     lambda be: (lambda: ("hash", torch.tensor(True))))
    assert ok == "hash" and KN.COUNTERS.dispatches["cuda"] == 1
    KN.COUNTERS.reset()


def test_dispatch_propagates_launch_failures():
    def runner(be):
        def call():
            raise RuntimeError("hash_pairs kernel launch failed")
        return call

    with pytest.raises(RuntimeError, match="launch failed"):
        KN.dispatch("agg", "cuda", runner)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hash_pairs CUDA kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_cuda_kernel_matches_plain(cuda_device, n_limbs):
    for n in (1, 4095, 1 << 20):
        stacked = _port_stack(_limbs_np(n_limbs, n, seed=n_limbs + n))
        before = CB.launches
        got = CB.hash_pairs(stacked.to(cuda_device))
        torch.cuda.synchronize()
        assert CB.launches == before + 1
        assert torch.equal(got.cpu(), CB.hash_pairs_plain(stacked))


@pytest.mark.gpu
@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_cuda_kernel_odd_n_and_misaligned_views(cuda_device, n_limbs):
    """Odd n (the vector path's scalar tail), and limbs that are not
    16-byte aligned (rows of a stacked tensor with odd n, columns sliced
    by one row): the one-row path of the same kernel."""
    for n in (1, 3, 4095, (1 << 20) + 1):
        host = _port_stack(_limbs_np(n_limbs, n + 1, seed=n_limbs + n))
        want_all = CB.hash_pairs_plain(host)
        want_tail = CB.hash_pairs_plain([l[1:] for l in host.unbind(0)])
        want_odd = CB.hash_pairs_plain(host[:, :n].contiguous())
        dev = host.to(cuda_device)
        odd = dev[:, :n].contiguous()
        cases = [(dev, want_all), (list(dev.unbind(0)), want_all),
                 ([l[1:] for l in dev.unbind(0)], want_tail),
                 (odd, want_odd), (list(odd.unbind(0)), want_odd),
                 ([l.clone() for l in odd], want_odd)]
        cases = [(CB.hash_pairs(x), want) for x, want in cases]
        torch.cuda.synchronize()
        for got, want in cases:
            assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [(1, 1), (3, 2), (CB.LIMB_CAP + 1, 1),
                                     (2 * CB.LIMB_CAP + 1, 3)])
def test_cuda_two_sets_and_chained_launches(cuda_device, lengths):
    sizes = ((1 << 18) + 1, 1 << 16)
    hosts = [_port_stack(_limbs_np(L, n, seed=L * n))
             for L, n in zip(lengths, sizes)]
    before = CB.launches
    got = CB.hash_pairs_multi([[l.clone() for l in h.to(cuda_device)]
                               for h in hosts])
    torch.cuda.synchronize()
    assert CB.launches == before + -(-max(lengths) // CB.LIMB_CAP)
    for g, h in zip(got, hosts):
        assert torch.equal(g.cpu(), CB.hash_pairs_plain(h))
