"""The port's key encoding and hash-grouped layout against the JAX package.

Both packages get the same batch: an arrow table made with numpy from a
fixed seed goes through the JAX package's ``host_to_device``, and the
port receives that batch's buffers through
``column.from_numpy_batch``.  Key limbs must agree bit for bit (the
port's int64 limbs viewed as uint64; raw float64 limbs compared as
bits), and so must the hash layout's permutation, boundaries and
collision flag.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar.column import host_to_device as j_h2d  # noqa: E402
from spark_rapids_tpu.kernels import hash_layout as JHL  # noqa: E402
from spark_rapids_tpu.ops import ordering as JORD  # noqa: E402

from spark_rapids_tpu_torch import kernels as KN  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.exec.aggregate import segment_groupby  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash_layout as HL  # noqa: E402
from spark_rapids_tpu_torch.ops import ordering as ORD  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 3000
_WORDS = ["", "a", "ab", "abc", "MAIL", "TRUCK", "REG AIR", "été",
          "DELIVER IN PER", "x" * 12]


def _table(seed=11):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-50, 50, N).astype(np.int32)
    dates = rng.integers(8000, 8030, N).astype(np.int32)
    words = np.array(_WORDS, dtype=object)[rng.integers(0, len(_WORDS), N)]
    dbl = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan, np.inf,
                               -np.inf, 1e300]), N)
    longs = rng.integers(-3, 3, N) * (1 << 40)
    null = rng.random((4, N)) < 0.1
    return pa.table({
        "i": pa.array(ints, mask=null[0]),
        "d": pa.array(dates, type=pa.int32()).cast(pa.date32()),
        "s": pa.array(words.tolist(), mask=null[1]),
        "f": pa.array(dbl, mask=null[2]),
        "l": pa.array(longs),
        "t": pa.array(words.tolist()),
    })


@pytest.fixture(scope="module")
def batches():
    """(jax batch, port batch) over the same buffers, with dead rows."""
    jb = j_h2d(_table())
    kill = np.random.default_rng(5).random(jb.capacity) < 0.05
    sel = np.asarray(jb.sel) & ~kill
    jb = jb.with_sel(jnp.asarray(sel))
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity),
               None if c.lengths is None else np.asarray(c.lengths))
              for c in jb.columns]
    pb = from_numpy_batch(_port_schema(jb), arrays, sel, "cpu")
    return jb, pb


def _port_schema(jb):
    return T.StructType(tuple(
        T.StructField(f.name, getattr(T, type(f.dtype).__name__)())
        for f in jb.schema.fields))


def _cols(batch, names):
    return [batch.columns[batch.schema.field_index(n)] for n in names]


def _bits(limb):
    """uint64 bits of a JAX limb or a port limb; float64 limbs as bits."""
    a = limb.numpy() if isinstance(limb, torch.Tensor) else np.asarray(limb)
    if a.dtype == np.float64:
        return a.view(np.uint64)
    return a.view(np.uint64) if a.dtype == np.int64 else a


# narrow sets keep the exact encoding; wide ones (> 3 fused limbs) take
# the 128-bit tuple hash, as TPC-H q1's two string keys do
KEY_SETS = {
    "int": ["i"], "date": ["d"], "long": ["l"], "double": ["f"],
    "string": ["s"], "int_date": ["i", "d"],
    "two_strings_q1": ["t", "s"], "wide_mixed": ["i", "s", "f", "d"],
    "wide_int_string": ["s", "i", "l"],
}


@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_group_sort_limbs_bit_identical(batches, case):
    jb, pb = batches
    names = KEY_SETS[case]
    jl, jk = JORD.group_sort_limbs(_cols(jb, names), jb.sel)
    pl, pk = ORD.group_sort_limbs(_cols(pb, names), pb.sel)
    assert len(jl) == len(pl) and len(jk) == len(pk)
    for a, b in zip(jl + jk, pl + pk):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_sort_by_keys_same_permutation(batches, case):
    jb, pb = batches
    jl, _ = JORD.group_sort_limbs(_cols(jb, KEY_SETS[case]), jb.sel)
    pl, _ = ORD.group_sort_limbs(_cols(pb, KEY_SETS[case]), pb.sel)
    js, jperm = JORD.sort_by_keys(jl)
    ps, pperm = ORD.sort_by_keys(pl)
    assert np.array_equal(np.asarray(jperm), pperm.numpy())
    for a, b in zip(js, ps):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", sorted(k for k in KEY_SETS
                                        if k != "double"))
def test_hash_group_layout_identical(batches, case):
    jb, pb = batches
    _, jk = JORD.group_sort_limbs(_cols(jb, KEY_SETS[case]), jb.sel)
    _, pk = ORD.group_sort_limbs(_cols(pb, KEY_SETS[case]), pb.sel)
    assert JHL.limbs_hashable(jk) and HL.limbs_hashable(pk)
    jperm, _, jbound, jh, jok = JHL.hash_group_layout(jk)
    for use_kernel in (False, True):
        pperm, _, pbound, ph, pok = HL.hash_group_layout(
            pk, use_kernel=use_kernel)
        assert np.array_equal(np.asarray(jperm), pperm.numpy())
        assert np.array_equal(np.asarray(jbound), pbound.numpy())
        assert np.array_equal(np.asarray(jh), _bits(ph))
        assert bool(jok) and bool(pok)


def test_double_keys_are_unhashable_in_both(batches):
    jb, pb = batches
    _, jk = JORD.group_sort_limbs(_cols(jb, ["f"]), jb.sel)
    _, pk = ORD.group_sort_limbs(_cols(pb, ["f"]), pb.sel)
    assert not JHL.limbs_hashable(jk)
    assert not HL.limbs_hashable(pk)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("name", ["i", "d", "s", "f", "l"])
def test_column_order_parts_match(batches, name, desc):
    jb, pb = batches
    jc, = _cols(jb, [name])
    pc, = _cols(pb, [name])
    ja = JORD.fuse_parts(JORD.column_order_parts(jc, not desc, desc))
    pa_ = ORD.fuse_parts(ORD.column_order_parts(pc, not desc, desc))
    assert len(ja) == len(pa_)
    for a, b in zip(ja, pa_):
        assert np.array_equal(_bits(a), _bits(b))


def test_seg_scan_and_run_lengths_match():
    rng = np.random.default_rng(9)
    vals = rng.integers(-5, 100, 4096).astype(np.int32)
    bnd = rng.random(4096) < 0.05
    bnd[0] = False  # row 0 starts a run regardless
    jv, jb_ = jnp.asarray(vals), jnp.asarray(bnd)
    tv, tb = torch.from_numpy(vals), torch.from_numpy(bnd)
    assert np.array_equal(np.asarray(JHL.seg_scan(jv, jb_, jnp.add)),
                          HL.seg_scan(tv, tb, "add").numpy())
    assert np.array_equal(
        np.asarray(JHL.seg_scan(jv, jb_, lambda a, b: a)),
        HL.seg_scan(tv, tb, "first").numpy())
    assert np.array_equal(np.asarray(JHL.run_lengths(jb_)),
                          HL.run_lengths(tb).numpy())
    with pytest.raises(ValueError):
        HL.seg_scan(tv.double(), tb, "add")


def test_collision_detected_exactly(monkeypatch):
    monkeypatch.setattr(
        HL, "hash_limbs",
        lambda limbs, use_kernel=False: torch.zeros(
            (int(limbs[0].shape[0]),), dtype=torch.int64))
    limbs = [torch.tensor([1, 2, 1, 2], dtype=torch.int64)]
    *_, ok = HL.hash_group_layout(limbs)
    assert not bool(ok)


def test_collision_descends_to_exact_rung(batches, monkeypatch):
    """A forced collision on the cuda rung: the ladder redoes the batch on
    the exact rung, and the groups equal an exact-rung run."""
    _, pb = batches
    keys = _cols(pb, ["t", "s"])
    vals = [(c, "sum") for c in _cols(pb, ["l"])]

    def runner(be):
        def call():
            out = segment_groupby(keys, pb.sel, vals, backend=be)
            return out, out[3]
        return call

    exact = segment_groupby(keys, pb.sel, vals, backend="jnp")
    monkeypatch.setattr(
        HL, "hash_limbs",
        lambda limbs, use_kernel=False: torch.zeros(
            (int(limbs[0].shape[0]),), dtype=torch.int64))
    KN.COUNTERS.reset()
    got = KN.dispatch("agg", "cuda", runner)
    assert KN.COUNTERS.fallbacks == 1
    assert KN.COUNTERS.dispatches == {"cuda": 0, "jnp": 1}
    KN.COUNTERS.reset()
    for a, b in zip(got[0] + got[1], exact[0] + exact[1]):
        assert torch.equal(a.data, b.data)
    assert torch.equal(got[2], exact[2])
