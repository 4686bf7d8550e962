"""The port's device group-by against the JAX package's.

``segment_groupby`` gets identical batches in both packages (the JAX
batch's buffers carried across with ``column.from_numpy_batch``) and
must produce the same groups: the same keys, the same counts, and float
sums within a relative 1e-9 (the JAX package adds along a segmented
scan tree, the port in row order with ``index_add_``).  On each rung
the two packages also agree on group ORDER — key order on the exact
rung, hash order on the hash rung — so the outputs are compared row by
row.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar.column import host_to_device as j_h2d  # noqa: E402
from spark_rapids_tpu.exec import aggregate as JAGG  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.exec import aggregate as AGG  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 5000
_FLAGS = ["A", "N", "R", "", "NN"]


def _table(seed):
    rng = np.random.default_rng(seed)
    null = rng.random((3, N)) < 0.08
    return pa.table({
        "k1": pa.array(np.array(_FLAGS, dtype=object)[
            rng.integers(0, len(_FLAGS), N)].tolist(), mask=null[0]),
        "k2": pa.array(rng.integers(0, 7, N).astype(np.int32),
                       mask=null[1]),
        "v_f": pa.array(rng.uniform(-1e4, 1e4, N), mask=null[2]),
        "v_l": pa.array(rng.integers(-1 << 40, 1 << 40, N)),
    })


def _carry(jb, sel):
    schema = T.StructType(tuple(
        T.StructField(f.name, getattr(T, type(f.dtype).__name__)())
        for f in jb.schema.fields))
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity),
               None if c.lengths is None else np.asarray(c.lengths))
              for c in jb.columns]
    return from_numpy_batch(schema, arrays, sel, "cpu")


@pytest.fixture(scope="module", params=[21, 22])
def batches(request):
    jb = j_h2d(_table(request.param))
    sel = np.asarray(jb.sel) & (
        np.random.default_rng(request.param).random(jb.capacity) < 0.9)
    return jb.with_sel(jnp.asarray(sel)), _carry(jb, sel)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_column(jc, pc, n, exact):
    jv = None if jc.validity is None else _np(jc.validity)[:n]
    pv = None if pc.validity is None else _np(pc.validity)[:n]
    if jv is not None or pv is not None:
        jv = np.ones(n, bool) if jv is None else jv
        pv = np.ones(n, bool) if pv is None else pv
        assert np.array_equal(jv, pv)
    else:
        jv = np.ones(n, bool)
    jd, pd = _np(jc.data)[:n], _np(pc.data)[:n]
    if jc.lengths is not None:
        ln = _np(jc.lengths)[:n]
        assert np.array_equal(ln, _np(pc.lengths)[:n])
        w = min(jd.shape[1], pd.shape[1])
        assert np.array_equal(jd[:, :w] * (np.arange(w) < ln[:, None]),
                              pd[:, :w] * (np.arange(w) < ln[:, None]))
        return
    if exact:
        assert np.array_equal(jd[jv], pd[jv])
    else:
        np.testing.assert_allclose(pd[jv], jd[jv], rtol=1e-9, atol=1e-9)


_JITTED = {}


def _jax_groupby(backend):
    """The JAX group-by of sum columns, jitted once per rung: one program
    compiles far faster than the eager scans' many small ones."""
    if backend not in _JITTED:
        _JITTED[backend] = jax.jit(lambda ks, sel, vs: JAGG.segment_groupby(
            ks, sel, [(v, "sum") for v in vs], backend=backend))
    return _JITTED[backend]


@pytest.mark.parametrize("keys", [["k1"], ["k2"], ["k1", "k2"]])
@pytest.mark.parametrize("rung", [("jnp", "jnp"), ("fused", "cuda")])
def test_segment_groupby_same_groups(batches, keys, rung):
    jb, pb = batches
    jrung, prung = rung
    idx = [jb.schema.field_index(k) for k in keys]
    vi = [jb.schema.field_index(v) for v in ("v_f", "v_l")]
    jout = _jax_groupby(jrung)(
        [jb.columns[i] for i in idx], jb.sel, [jb.columns[i] for i in vi])
    pout = AGG.segment_groupby(
        [pb.columns[i] for i in idx], pb.sel,
        [(pb.columns[i], "sum") for i in vi], backend=prung)
    n = int(np.asarray(jout[2]).sum())
    assert n == int(pout[2].sum()) and n > 1
    assert np.array_equal(_np(jout[2]), _np(pout[2]))
    for jc, pc in zip(jout[0], pout[0]):
        _assert_same_column(jc, pc, n, exact=True)
    _assert_same_column(jout[1][0], pout[1][0], n, exact=False)
    _assert_same_column(jout[1][1], pout[1][1], n, exact=True)
    if prung == "cuda":
        assert bool(jout[3]) and bool(pout[3])
    else:
        assert jout[3] is None and pout[3] is None


def test_update_and_final_project_match(batches):
    """Buffers of sum/avg/count/count(*) and their final projection."""
    from spark_rapids_tpu.ops import aggregates as JA
    from spark_rapids_tpu.ops import expressions as JE
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops import expressions as E
    jb, pb = batches
    i = jb.schema.field_index("v_f")
    jfns = [JA.Sum(JE.BoundReference(i, jb.schema.fields[i].dtype)),
            JA.Average(JE.BoundReference(i, jb.schema.fields[i].dtype)),
            JA.Count(JE.BoundReference(i, jb.schema.fields[i].dtype)),
            JA.CountStar(JE.Literal(1, jb.schema.fields[i].dtype))]
    pfns = [A.Sum(E.BoundReference(i, T.DoubleT)),
            A.Average(E.BoundReference(i, T.DoubleT)),
            A.Count(E.BoundReference(i, T.DoubleT)),
            A.CountStar(E.Literal(1, T.IntegerT))]
    k = [jb.schema.field_index("k1")]
    jout = jax.jit(lambda b: JAGG.segment_groupby(
        [b.columns[j] for j in k], b.sel,
        JAGG.update_value_cols(jfns, b)))(jb)
    pout = AGG.segment_groupby([pb.columns[j] for j in k], pb.sel,
                               AGG.update_value_cols(pfns, pb))
    n = int(np.asarray(jout[2]).sum())
    jres = JAGG.final_project(jfns, jout[1])
    pres = AGG.final_project(pfns, pout[1])
    assert len(jres) == len(pres) == 4
    for j, (jc, pc) in enumerate(zip(jres, pres)):
        _assert_same_column(jc, pc, n, exact=j >= 2)
