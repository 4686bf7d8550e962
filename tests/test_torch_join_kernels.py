"""The join's kernel plane in the port against the JAX package.

``kernels/hash_layout.py::lower_bound``, ``exec/join.py::_lex_search``
and ``_expand_counts``, and ``kernels/hash_join.py::match_fused`` must
give the JAX package's results exactly: ``(m, lo, perm, ok)`` bit for
bit, from the same numpy inputs made from a seed.  The port carries the
JAX package's uint64 limbs as int64 bit patterns.  ``match_fused`` is
fed key limbs that both packages encode from the same key columns
(``_key_parts``), with dead rows, null keys, int32 x int64 keys, negative
keys and keys whose encoding has bit 63 set.  A forced 64-bit collision
(a constant hash, patched into both packages) must give ``ok = False``,
and the port's dispatcher must then descend to the exact rung with the
same join output.  The CUDA kernel on the join's shapes is held against
the plain version by the ``gpu`` test at the end (and by chip_smoke.py).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()  # x64, so the JAX limbs are real uint64

from spark_rapids_tpu.columnar import column as JC  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.exec import join as JJ  # noqa: E402
from spark_rapids_tpu.kernels import hash_join as JHJ  # noqa: E402
from spark_rapids_tpu.kernels import hash_layout as JHL  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import ordering as JORD  # noqa: E402

from spark_rapids_tpu_torch import kernels as KN  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import (  # noqa: E402
    from_numpy_batch)
from spark_rapids_tpu_torch.exec import join as J  # noqa: E402
from spark_rapids_tpu_torch.kernels import cuda_backend as CB  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash_join as HJ  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash_layout as HL  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import ordering as ORD  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _sorted_u64(n: int, seed: int) -> np.ndarray:
    """Sorted uint64 values with duplicates, half with the top bit."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 63, max(n // 3, 1), dtype=np.uint64)
    v[::2] |= np.uint64(1 << 63)
    return np.sort(rng.choice(v, n))


@pytest.mark.parametrize("n", [1, 1000, 70_000])
@pytest.mark.parametrize("with_le", [False, True])
def test_lower_bound_equals_jax(n, with_le):
    table = _sorted_u64(n, seed=n)
    rng = np.random.default_rng(n + 1)
    q = np.concatenate([rng.choice(table, 500),
                        rng.integers(0, 1 << 64, 500, dtype=np.uint64),
                        np.array([0, (1 << 64) - 1], np.uint64)])
    le = rng.random(q.shape[0]) < 0.5 if with_le else None
    want = np.asarray(JHL.lower_bound(
        jnp.asarray(table), jnp.asarray(q),
        None if le is None else jnp.asarray(le)))
    got = HL.lower_bound(torch.from_numpy(table.view(np.int64)),
                         torch.from_numpy(q.view(np.int64)),
                         None if le is None else torch.from_numpy(le))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _lex_table(n: int, n_limbs: int, seed: int):
    """Lexicographically sorted uint64 limb table with duplicate prefixes
    and queries drawn from it and beside it."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(n_limbs):
        dom = rng.integers(0, 1 << 64, 7, dtype=np.uint64)
        cols.append(rng.choice(dom, n))
    order = np.lexsort(cols[::-1])
    table = [c[order] for c in cols]
    qi = rng.integers(0, n, 300)
    queries = [np.concatenate([c[qi], rng.integers(0, 1 << 64, 100,
                                                   dtype=np.uint64)])
               for c in table]
    return table, queries


@pytest.mark.parametrize("n", [1, 1000, 70_000])
@pytest.mark.parametrize("n_limbs", [1, 2, 3])
@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_search_equals_jax(n, n_limbs, side):
    table, queries = _lex_table(n, n_limbs, seed=10 * n + n_limbs)
    want = np.asarray(JJ._lex_search([jnp.asarray(c) for c in table],
                                     [jnp.asarray(c) for c in queries],
                                     side))
    got = J._lex_search([torch.from_numpy(c.view(np.int64)) for c in table],
                        [torch.from_numpy(c.view(np.int64))
                         for c in queries], side)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_lex_search_float_limb_equals_jax():
    # the exact rung keeps a float64 key as a NaN flag limb and a raw
    # float limb, compared as floats
    rng = np.random.default_rng(5)
    vals = rng.choice([-2.5, -0.0, 0.0, 1.0, 3.25, 1e300], 2000)
    flag = np.zeros(2000, np.uint64)
    order = np.argsort(vals, kind="stable")
    table = [flag[order], vals[order]]
    q = [np.zeros(50, np.uint64), rng.choice(vals, 50)]
    for side in ("left", "right"):
        want = np.asarray(JJ._lex_search([jnp.asarray(c) for c in table],
                                         [jnp.asarray(c) for c in q], side))
        got = J._lex_search(
            [torch.from_numpy(table[0].view(np.int64)),
             torch.from_numpy(table[1])],
            [torch.from_numpy(q[0].view(np.int64)), torch.from_numpy(q[1])],
            side)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 1000, 70_000])
def test_expand_counts_equals_jax(n):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts[rng.random(n) < 0.4] = 0
    jb, ji, jo, jt = JJ._expand_counts(jnp.asarray(counts))
    b, i, o, t = J._expand_counts(torch.from_numpy(counts))
    assert (b, t) == (jb, jt)
    assert np.array_equal(i.numpy(), np.asarray(ji).astype(np.int64))
    assert np.array_equal(o.numpy(), np.asarray(jo).astype(np.int64))


def test_expand_counts_all_zero():
    b, i, o, t = J._expand_counts(torch.zeros(10, dtype=torch.int32))
    jb, ji, jo, jt = JJ._expand_counts(jnp.zeros(10, jnp.int32))
    assert (b, t) == (jb, jt) == (1024, 0)


# ---------------------------------------------------------------------------
# match_fused, fed identically encoded keys
# ---------------------------------------------------------------------------

_PORT_T = {"int": T.IntegerT, "long": T.LongT, "str": T.StringT}
_JAX_T = {"int": JT.IntegerType(), "long": JT.LongType(),
          "str": JT.StringType()}


def _key_columns(kinds, n: int, seed: int):
    """numpy key columns (data, validity, lengths) of the given kinds, a
    small shared domain (duplicates and matches across sides), about
    10% nulls and 10% dead rows."""
    rng = np.random.default_rng(seed)
    cols = []
    for k in kinds:
        dom = rng.integers(-40, 40, n)
        valid = rng.random(n) > 0.1
        if k == "int":
            cols.append(((dom * 1_000_003).astype(np.int32), valid, None))
        elif k == "long":
            # the int keys' values (so int x long keys match), except
            # that one row in eight lies beyond the int32 range
            big = np.where(dom % 8 == 0, 1 << 40, 0)
            cols.append((dom * 1_000_003 + big, valid, None))
        else:
            words = np.array([f"k{abs(v):03d}" + "x" * (v % 5)
                              for v in dom])
            mat = np.zeros((n, 16), np.uint8)
            lengths = np.zeros(n, np.int32)
            for i, w in enumerate(words):
                b = w.encode()
                mat[i, :len(b)] = np.frombuffer(b, np.uint8)
                lengths[i] = len(b)
            cols.append((mat, valid, lengths))
    sel = rng.random(n) > 0.1
    return cols, sel


def _port_batch(kinds, cols, sel):
    schema = T.StructType(tuple(T.StructField(f"k{i}", _PORT_T[k])
                                for i, k in enumerate(kinds)))
    return from_numpy_batch(schema, cols, sel, "cpu")


def _jax_batch(kinds, cols, sel):
    schema = JT.StructType(tuple(JT.StructField(f"k{i}", _JAX_T[k])
                                 for i, k in enumerate(kinds)))
    jcols = tuple(JC.DeviceColumn(_JAX_T[k], jnp.asarray(d),
                                  jnp.asarray(v),
                                  None if l is None else jnp.asarray(l))
                  for k, (d, v, l) in zip(kinds, cols))
    return JC.DeviceBatch(schema, jcols, jnp.asarray(sel))


def _limbs_both(l_kinds, r_kinds, n: int, seed: int):
    """(port, jax) inputs of match_fused from the same key columns."""
    lc, lsel = _key_columns(l_kinds, n, seed)
    rc, rsel = _key_columns(r_kinds, n, seed + 1)
    widths = [16 if k == "str" else 0 for k in l_kinds]
    out = []
    for mk, keys_of, kp, fuse, flag in (
            (_port_batch, lambda kinds: [E.BoundReference(i, _PORT_T[k])
                                         for i, k in enumerate(kinds)],
             J._key_parts, ORD.fuse_parts, None),
            (_jax_batch, lambda kinds: [JE.BoundReference(i, _JAX_T[k])
                                        for i, k in enumerate(kinds)],
             JJ._key_parts, JORD.fuse_parts, None)):
        lb, rb = mk(l_kinds, lc, lsel), mk(r_kinds, rc, rsel)
        l_parts, _ = kp(lb, keys_of(l_kinds), widths)
        r_parts, r_null = kp(rb, keys_of(r_kinds), widths)
        out.append((fuse(l_parts), fuse(r_parts), (~rb.sel) | r_null))
    return out


# one compiled program per input shape: far quicker on the CPU than
# running the JAX function op by op
_jax_match_fused = jax.jit(JHJ.match_fused)

_CASES = {  # name -> (left key kinds, right key kinds, fused limbs)
    "long": (["long"], ["long"], 1),
    "int_x_long": (["int"], ["long"], 1),
    "str": (["str"], ["str"], 3),
    "int_long": (["int", "long"], ["long", "int"], 2),
    "three": (["long", "int", "long"], ["long", "long", "int"], 3),
}


@pytest.mark.parametrize("n", [1, 1000, 70_000])
@pytest.mark.parametrize("case", list(_CASES))
def test_match_fused_bit_identical_to_jax(case, n):
    l_kinds, r_kinds, n_limbs = _CASES[case]
    (pl, pr, pex), (jl, jr, jex) = _limbs_both(l_kinds, r_kinds, n,
                                               seed=n + len(case))
    assert len(pl) == len(jl) == n_limbs
    for a, b in zip(pl + pr, jl + jr):
        assert np.array_equal(_u64(a), np.asarray(b))
    jm, jlo, jperm, jok = _jax_match_fused(jl, jr, jex)
    before = CB.launches
    m, lo, perm, ok = HJ.match_fused(pl, pr, pex, use_kernel=True)
    assert CB.launches == before  # CPU tensors: the plain version
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(perm.numpy(), np.asarray(jperm).astype(np.int64))
    assert bool(ok) == bool(jok) is True
    if n >= 1000:
        assert int((m > 0).sum()) > 0  # the inputs do match


def test_match_fused_unhashable_keys_return_none():
    f = torch.zeros(4, dtype=torch.float64)
    assert HJ.match_fused([f], [f], torch.zeros(4, dtype=torch.bool)) is None


def test_forced_collision_gives_not_ok_in_both(monkeypatch):
    (pl, pr, pex), (jl, jr, jex) = _limbs_both(["long"], ["long"], 1000, 7)
    monkeypatch.setattr(JHL, "hash_limbs",
                        lambda limbs, use_pallas=False: jnp.zeros(
                            limbs[0].shape, jnp.uint64))
    monkeypatch.setattr(HL, "hash_limbs",
                        lambda limbs, use_kernel=False: torch.zeros(
                            limbs[0].shape, dtype=torch.int64))
    # a fresh function, so that jit traces the patched hash (a jit of
    # match_fused itself may reuse an earlier trace of the same shapes)
    jm, jlo, jperm, jok = jax.jit(
        lambda a, b, c: JHJ.match_fused(a, b, c))(jl, jr, jex)
    m, lo, perm, ok = HJ.match_fused(pl, pr, pex)
    assert not bool(jok) and not bool(ok)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(perm.numpy(), np.asarray(jperm).astype(np.int64))


def _join_tables():
    rng = np.random.default_rng(11)
    n = 3000
    left = pa.table({"k": pa.array(rng.integers(0, 500, n)),
                     "a": pa.array(np.arange(n))})
    right = pa.table({"k": pa.array(rng.integers(0, 500, n)),
                      "b": pa.array(rng.random(n))})
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_dispatcher_descends_on_forced_collision(monkeypatch, how):
    left, right = _join_tables()

    def run():
        s = TpuSession(device="cpu")
        return s.createDataFrame(left).join(
            s.createDataFrame(right), on="k", how=how).toArrow()

    KN.COUNTERS.reset()
    clean = run()
    assert KN.COUNTERS.fallbacks == 0
    assert KN.COUNTERS.dispatches["cuda"] >= 1
    monkeypatch.setattr(HL, "hash_limbs",
                        lambda limbs, use_kernel=False: torch.zeros(
                            limbs[0].shape, dtype=torch.int64))
    KN.COUNTERS.reset()
    forced = run()
    assert KN.COUNTERS.fallbacks >= 1
    assert KN.COUNTERS.dispatches["cuda"] == 0
    assert forced.equals(clean)
    KN.COUNTERS.reset()


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
@pytest.mark.parametrize("case", ["long", "str", "three"])
def test_match_fused_on_the_card_equals_plain(cuda_device, case):
    l_kinds, r_kinds, _ = _CASES[case]
    (pl, pr, pex), _ = _limbs_both(l_kinds, r_kinds, 1 << 18, seed=3)
    want = HJ.match_fused(pl, pr, pex)
    before = CB.launches
    got = HJ.match_fused([x.to(cuda_device) for x in pl],
                         [x.to(cuda_device) for x in pr],
                         pex.to(cuda_device), use_kernel=True)
    torch.cuda.synchronize()
    assert CB.launches == before + 1  # build and probe: one launch
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
