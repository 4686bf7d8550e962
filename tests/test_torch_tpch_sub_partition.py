"""The hash sub-partition join against the JAX package: TPC-H q21, whose
joins with the two count(DISTINCT) aggregates meet two sides above
``join.targetRows``; ``_sub_partition_join`` for each join type, row for
row in the JAX package's order; and the murmur3 partition id that it
splits by, bit for bit.

q21 runs at ``bench.py``'s oracle scale (sf 0.002) under the defaults
and under ``autoBroadcastJoinThreshold=0`` with ``join.targetRows=1024``
(which sends its two count(DISTINCT) joins and the semi join with
orders through the sub-partition path in both packages).  The join-type
cases use ``join.targetRows=256`` on tables with null and duplicate
keys; the output must equal the JAX package's table exactly, in order,
as both packages pick the same sub-partition count at these sizes.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar.column import host_to_device as j_h2d  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.parallel.shuffle import make_pid_fn as j_pid_fn  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch import kernels as KN  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.exec.join import TpuSortMergeJoinExec  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops.hashing import make_pid_fn  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402
from spark_rapids_tpu_torch.utils import tpch  # noqa: E402


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
_STRATEGY = ("streamedJoins", "subPartitionJoins")
SUB = {"spark.sql.autoBroadcastJoinThreshold": 0,
       "spark.rapids.tpu.join.targetRows": 256}


def _strategies(df):
    """Each join's run-time strategy metrics, root first."""
    return [tuple(m.get(k, 0) for k in _STRATEGY)
            for name, m in df.metrics() if name == "TpuSortMergeJoinExec"]


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


@pytest.fixture(scope="module")
def jax_q21(tables):
    out = {}
    for name, conf in CONFS.items():
        df = bench.q21(JaxSession(dict(conf)), tables)
        out[name] = (df.toArrow(), _strategies(df))
    return out


@pytest.mark.parametrize("conf", list(CONFS))
def test_q21_matches_jax(tables, jax_q21, conf):
    KN.COUNTERS.reset()
    df = tpch.q21(TpuSession(dict(CONFS[conf]), device="cpu"), tables)
    got = df.toArrow()
    want, want_strategies = jax_q21[conf]
    assert got.num_rows > 0
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert _strategies(df) == want_strategies
    if conf == "noBroadcast":
        # both count(DISTINCT) joins, and the semi join with orders
        assert [s for _, s in want_strategies] == [0, 1, 1, 1, 0]
    assert KN.COUNTERS.fallbacks == 0


# ---------------------------------------------------------------------------
# _sub_partition_join by join type, in order
# ---------------------------------------------------------------------------

def _sides(n, n_right, left_keys, right_keys, seed=3):
    rng = np.random.default_rng(seed)

    def keys(n, values):
        k = rng.choice(values, n)
        null = rng.random(n) < 0.08
        return pa.array(np.where(null, 0, k), mask=null)

    left = pa.table({"k": keys(n, left_keys),
                     "a": pa.array(np.arange(n)),
                     "s": pa.array([f"r{i % 17}" for i in range(n)])})
    right = pa.table({"k": keys(n_right, right_keys),
                      "b": pa.array(rng.random(n_right)),
                      "t": pa.array([f"t{i % 5}" * (i % 3)
                                     for i in range(n_right)])})
    return left, right


# case -> (left rows, right rows, left key values, right key values)
_CASES = {
    # keys spread; the null keys all hash to one sub-partition, whose
    # pairs re-split down to the depth cap
    "spread": (3000, 1500, np.arange(-300, 300), np.arange(-300, 300)),
    # two distinct keys: no seed spreads them, the pairs re-split down
    # to the depth cap and then join in-core
    "low_cardinality": (600, 300, np.array([4, 9]), np.array([4, 9])),
    # the right side's few keys leave most sub-partitions without a
    # right row (left and anti pairs still run, inner and semi skip)
    "empty_right_pairs": (3000, 600, np.arange(-300, 300),
                          np.array([5, 6, 7])),
}


def _join_both(case, how, monkeypatch):
    n, n_right, lk, rk = _CASES[case]
    left, right = _sides(n, n_right, lk, rk)
    out = []
    depths = []
    real = TpuSortMergeJoinExec._sub_partition_join

    def spy(self, l_list, r_list, jt, total, mgr, depth=0,
            live_rows=None):
        depths.append(depth)
        return real(self, l_list, r_list, jt, total, mgr, depth,
                    live_rows)

    monkeypatch.setattr(TpuSortMergeJoinExec, "_sub_partition_join", spy)
    for session in (JaxSession(dict(SUB)),
                    TpuSession(dict(SUB), device="cpu")):
        df = session.createDataFrame(left).join(
            session.createDataFrame(right), on="k", how=how)
        out.append((df.toArrow(), _strategies(df)))
    return out, depths


@pytest.mark.parametrize("how", ["inner", "left", "left_semi",
                                 "left_anti"])
@pytest.mark.parametrize("case", list(_CASES))
def test_sub_partition_join_matches_jax_in_order(case, how, monkeypatch):
    ((want, want_st), (got, got_st)), depths = _join_both(case, how,
                                                         monkeypatch)
    assert want_st == got_st == [(0, 1)]
    assert got.schema == want.schema
    assert got.num_rows > 0
    assert got.equals(want)
    assert max(depths) == 3


# ---------------------------------------------------------------------------
# the murmur3 partition id
# ---------------------------------------------------------------------------

def _key_table(seed=17, n=3000):
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "ab", "abcd", "MAIL", "été", "x" * 13],
                     dtype=object)[rng.integers(0, 7, n)]
    null = rng.random((4, n)) < 0.1
    return pa.table({
        "i": pa.array(rng.integers(-1 << 31, 1 << 31, n).astype(np.int32),
                      mask=null[0]),
        "l": pa.array(rng.integers(-1 << 62, 1 << 62, n), mask=null[1]),
        "f": pa.array(rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan,
                                           np.inf, 1e300, 3.3]), n),
                      mask=null[2]),
        "s": pa.array(words.tolist(), mask=null[3]),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32)).cast(
            pa.date32()),
    })


@pytest.fixture(scope="module")
def key_batches():
    jb = j_h2d(_key_table())
    sel = np.asarray(jb.sel)
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity),
               None if c.lengths is None else np.asarray(c.lengths))
              for c in jb.columns]
    schema = T.StructType(tuple(
        T.StructField(f.name, getattr(T, type(f.dtype).__name__)())
        for f in jb.schema.fields))
    return jb, from_numpy_batch(schema, arrays, sel, "cpu")


@pytest.mark.parametrize("names, canon, seed, nparts", [
    pytest.param(("i",), (), None, 200, id="int"),
    pytest.param(("l",), (), None, 7, id="long"),
    pytest.param(("f",), (), None, 16, id="double"),
    pytest.param(("s",), (), None, 13, id="string"),
    pytest.param(("d",), (), 0x53504C54, 12, id="date_seed"),
    pytest.param(("i", "s", "f", "l"), (), 0x53504C54 + 2, 256,
                 id="tuple_seed"),
    pytest.param(("i", "l"), (True, False), 0x53504C54 + 1, 2,
                 id="widened_int"),
])
def test_partition_ids_match_jax_bit_for_bit(key_batches, names, canon,
                                             seed, nparts):
    jb, pb = key_batches
    idx = [jb.schema.field_index(n) for n in names]
    jkeys = [JE.BoundReference(i, jb.schema.fields[i].dtype) for i in idx]
    pkeys = [E.BoundReference(i, pb.schema.fields[i].dtype) for i in idx]
    want = np.asarray(j_pid_fn(jkeys, nparts, canon, seed=seed)(jb))
    got = make_pid_fn(pkeys, nparts, canon, seed=seed)(pb).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert 0 <= got.min() and got.max() < nparts
    assert len(np.unique(got)) > 1
