"""The port's shape plane and kernel build cache against the JAX package.

Mirrors ``tests/test_shapes.py`` case by case:

* the policies: both packages' ``ShapePolicy.bucket_for`` over one grid
  of capacities, under pow2, ladder (rungs within and over the pad
  budget, above the top rung) and off; ``configure`` from a session;
* ``bucket_batch``: dead-row padding (the counters moved, the batch
  reads back as the same table), identity on a hit, the ``compacted``
  promise kept, host values passed through;
* the zero-row concat (q7's crash site in the JAX package);
* padded against unpadded queries — an aggregate over a null-heavy
  skewed table, a join on skewed keys, a string-heavy sort, a zero-row
  query and a capacity on an exact rung — bit-identical in the port,
  and equal to the JAX package at ``PAD_CONF`` (rows in order for the
  sort, as multisets otherwise; float sums at ``bench._rows_equal``'s
  1e-6, everything else exactly);
* the kernel cache: a warm second sweep builds nothing, ``warmup``
  reports its plan and a second ``warmup`` builds nothing; the
  manifest's fresh, matching and mismatched cases; a CPU session
  writes nothing.

Not mirrored, each waiting for its slice: the window case (ROADMAP
A.8d), the stats plane's ``padded_rows`` (A.9) and ``QueryServer``'s
warmup on start (A.11); the two ``_concat_compacted_fast`` cases (the
port has no such function: its ``concat_device_batches`` compacts
each batch).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.runtime import kernel_cache as JKC
from spark_rapids_tpu.runtime import shapes as JS
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.utils import datagen as dg
from spark_rapids_tpu.utils.asserts import assert_tables_equal
from spark_rapids_tpu.utils.datagen import skewed_null_table
from spark_rapids_tpu.utils.harness import tpu_session

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import column as PC
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import kernel_cache as KC
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import shapes
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The batches are small: torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_policy():
    """Sessions install the shape policy globally; park both packages'
    back at the default so test order can't leak a forced-padding
    ladder."""
    M.reset_manager()
    B.clear_scan_cache()
    yield
    shapes._POLICY = shapes.ShapePolicy()
    JS._POLICY = JS.ShapePolicy()
    KN._POLICY = KN.KernelPolicy()
    M.reset_manager()
    B.clear_scan_cache()


def _session(conf=None):
    return TpuSession(conf, device="cpu")


# ---------------------------------------------------------------------------
# ShapePolicy
# ---------------------------------------------------------------------------

GRID = [1, 2, 100, 1000, 1023, 1024, 1025, 3000, 4096, 5000, 8191, 8192,
        8193, 16384, 20000, 1 << 20, (1 << 20) + 1]
POLICIES = {
    "pow2": dict(mode="pow2", min_bucket=1024),
    "pow2_small_floor": dict(mode="pow2", min_bucket=16),
    "ladder": dict(mode="ladder", ladder=(4096, 16384),
                   max_pad_fraction=0.75, min_bucket=1024),
    "ladder_tight": dict(mode="ladder", ladder=(1024, 8192, 65536),
                         max_pad_fraction=0.25, min_bucket=1024),
    "ladder_forced": dict(mode="ladder", ladder=(8192,),
                          max_pad_fraction=0.99, min_bucket=1024),
    "off": dict(),
}


@pytest.mark.parametrize("name", list(POLICIES))
def test_policies_equal_jax_over_one_grid(name):
    p, j = (mod.ShapePolicy(**POLICIES[name]) for mod in (shapes, JS))
    assert p.enabled == j.enabled == (name != "off")
    assert ([p.bucket_for(c) for c in GRID]
            == [j.bucket_for(c) for c in GRID])


def test_policy_pow2():
    p = shapes.ShapePolicy(mode="pow2", min_bucket=1024)
    assert p.enabled
    assert p.bucket_for(1) == 1024
    assert p.bucket_for(1000) == 1024
    assert p.bucket_for(1024) == 1024
    assert p.bucket_for(1025) == 2048


def test_policy_ladder_rungs_and_fallbacks():
    p = shapes.ShapePolicy(mode="ladder", ladder=(4096, 16384),
                           max_pad_fraction=0.75, min_bucket=1024)
    assert p.bucket_for(3000) == 4096     # within pad budget
    assert p.bucket_for(4096) == 4096     # exact rung
    assert p.bucket_for(5000) == 16384    # (16384-5000)/16384 ~ 0.69
    # smallest fitting rung would waste >75% -> pow2 fallback
    assert p.bucket_for(100) == 1024
    # above the top rung -> pow2 fallback
    assert p.bucket_for(20000) == 32768


def test_policy_off():
    p = shapes.ShapePolicy()
    assert not p.enabled
    b = PC.host_to_device(pa.table({"a": pa.array([1, 2, 3], pa.int64())}),
                          CPU)
    out, pad = shapes.bucket_batch(b, policy=p)
    assert out is b and pad == 0


def test_configure_parses_conf_as_jax():
    conf = {"spark.rapids.tpu.kernel.bucketing": "ladder",
            "spark.rapids.tpu.kernel.bucketLadder": "2048,8192",
            "spark.rapids.tpu.kernel.maxPadFraction": 0.5,
            "spark.rapids.tpu.minBucketRows": 64}
    _session(conf)
    tpu_session(conf)
    p = shapes.current_policy()
    assert p.mode == "ladder"
    assert p.ladder == (2048, 8192)
    assert p.max_pad_fraction == 0.5 and p.min_bucket == 64
    assert dataclass_tuple(p) == dataclass_tuple(JS.current_policy())
    assert shapes.retarget_bucket(1500) == JS.retarget_bucket(1500) == 2048
    assert shapes.retarget_bucket(100) == JS.retarget_bucket(100) == 128
    _session({"spark.rapids.tpu.kernel.bucketing": "off"})
    tpu_session({"spark.rapids.tpu.kernel.bucketing": "off"})
    assert shapes.retarget_bucket(100) == JS.retarget_bucket(100) == 1024


def dataclass_tuple(p):
    return (p.mode, p.ladder, p.max_pad_fraction, p.min_bucket)


# ---------------------------------------------------------------------------
# bucket_batch: dead-row padding mechanics
# ---------------------------------------------------------------------------

def test_bucket_batch_pads_with_dead_rows():
    tbl = pa.table({"a": pa.array(list(range(16)), pa.int64()),
                    "s": pa.array([f"s{i}" for i in range(16)])})
    b = PC.host_to_device(tbl, CPU, bucket=16, min_bucket=16)
    pol = shapes.ShapePolicy(mode="pow2", min_bucket=64)
    before = shapes.snapshot()
    out, pad = shapes.bucket_batch(b, policy=pol)
    after = shapes.snapshot()
    assert pad == 48 and out.capacity == 64
    assert not bool(out.sel[16:].any())  # dead tail
    assert out.compacted == b.compacted
    for c in out.columns:  # zeroed planes
        assert not bool(c.data[16:].any())
    # counters moved: one miss, 48 pad rows, the pad's bytes
    assert after[1] - before[1] == 1
    assert after[2] - before[2] == 48
    assert after[3] - before[3] == out.nbytes() - b.nbytes() > 0
    # padded batch reads back as the same table
    assert_tables_equal(PC.device_to_host(b), PC.device_to_host(out))


def test_bucket_batch_hit_is_identity():
    b = PC.host_to_device(pa.table({"a": pa.array([1, 2, 3], pa.int64())}),
                          CPU)
    pol = shapes.ShapePolicy(mode="pow2", min_bucket=1024)
    before = shapes.snapshot()
    out, pad = shapes.bucket_batch(b, policy=pol)
    assert out is b and pad == 0
    assert shapes.snapshot()[0] - before[0] == 1  # one hit


def test_bucket_batch_preserves_compacted_promise():
    tbl = pa.table({"a": pa.array(list(range(16)), pa.int64())})
    b = PC.host_to_device(tbl, CPU, bucket=16, min_bucket=16)
    b = PC.compact(b.with_sel(torch.as_tensor(np.arange(16) % 2 == 0)
                              & b.sel))
    assert b.compacted
    out, pad = shapes.bucket_batch(
        b, policy=shapes.ShapePolicy(mode="pow2", min_bucket=64))
    assert pad and out.compacted
    sel = out.sel.numpy()
    live = int(sel.sum())
    assert sel[:live].all() and not sel[live:].any()  # still front-packed


def test_bucket_batch_passes_non_device_values():
    out, pad = shapes.bucket_batch(
        "not-a-batch", policy=shapes.ShapePolicy(mode="pow2"))
    assert out == "not-a-batch" and pad == 0


def test_concat_zero_row_compacted_batches():
    """Three compacted batches with zero live rows each — the shape a
    streamed broadcast join pumps when a partition's build side is
    empty — concat to an empty batch."""
    tbl = pa.table({"a": pa.array([1, 2, 3, 4], pa.int64()),
                    "s": pa.array(["x", "y", "z", "w"])})
    batches = []
    for _ in range(3):
        b = PC.host_to_device(tbl, CPU, bucket=4, min_bucket=4)
        b = PC.compact(b.with_sel(torch.zeros(4, dtype=torch.bool)))
        assert b.compacted
        batches.append(b)
    schema = T.StructType((T.StructField("a", T.LongT, True),
                           T.StructField("s", T.StringT, True)))
    out = B.concat_device_batches(schema, batches)
    assert out.num_rows_host() == 0


# ---------------------------------------------------------------------------
# padded vs unpadded: bit-identical in the port, equal to the JAX package
# ---------------------------------------------------------------------------

# a ladder whose single rung swallows every small batch: padding is
# forced on essentially every pumped batch
PAD_CONF = {"spark.rapids.tpu.kernel.bucketing": "ladder",
            "spark.rapids.tpu.kernel.bucketLadder": "8192",
            "spark.rapids.tpu.kernel.maxPadFraction": 0.99}
OFF_CONF = {"spark.rapids.tpu.kernel.bucketing": "off"}


def _padded_vs_unpadded(build, jbuild, ignore_order=False,
                        expect_padding=True, tol=None):
    before = shapes.snapshot()
    padded = build(_session(PAD_CONF)).toArrow()
    after = shapes.snapshot()
    if expect_padding:
        assert after[1] > before[1], "forced-padding conf never padded"
    plain = build(_session(OFF_CONF)).toArrow()
    # bit-identical: no approx_float escape hatch
    assert_tables_equal(plain, padded, ignore_order=ignore_order)
    jax = jbuild(tpu_session(PAD_CONF)).toArrow()
    if tol is not None:
        assert bench._rows_equal(padded, jax, tol=tol)
    elif ignore_order:
        assert (sorted(map(repr, padded.to_pylist()))
                == sorted(map(repr, jax.to_pylist())))
    else:
        assert repr(padded.to_pylist()) == repr(jax.to_pylist())
    return padded


def _both(fn):
    """(port build, JAX build) of ``fn(session, F, col)``."""
    return (lambda s: fn(s, F, col)), (lambda s: fn(s, JF, jcol))


def test_padded_agg_null_heavy_skewed():
    t = skewed_null_table(3000, seed=11, hot_mass=0.9, null_ratio=0.4)
    _padded_vs_unpadded(*_both(
        lambda s, F, col: s.createDataFrame(t).groupBy("k").agg(
            F.sum(col("v")).alias("sv"),
            F.count(col("s")).alias("cs"))),
        ignore_order=True, tol=1e-6)


def test_padded_join_skewed_keys():
    left = skewed_null_table(300, seed=5, hot_mass=0.5, null_ratio=0.3)
    right = skewed_null_table(200, seed=9, hot_mass=0.5, null_ratio=0.3)
    _padded_vs_unpadded(*_both(
        lambda s, F, col: s.createDataFrame(left).join(
            s.createDataFrame(right).withColumnRenamed("v", "v2")
             .withColumnRenamed("s", "s2"),
            on="k")),
        ignore_order=True)


def test_padded_sort_string_heavy():
    t = dg.gen_table(
        [dg.IntegerGen(min_val=0, max_val=9, null_ratio=0.2),
         dg.StringGen(min_len=0, max_len=12, null_ratio=0.4),
         dg.StringGen(min_len=1, max_len=4)],
        1500, seed=3, names=["k", "s", "t"])
    _padded_vs_unpadded(*_both(
        lambda s, F, col: s.createDataFrame(t).orderBy("k", "s", "t")))


def test_padded_zero_row_query():
    t = skewed_null_table(400, seed=2)
    out = _padded_vs_unpadded(*_both(
        lambda s, F, col: s.createDataFrame(t).filter(col("k") < -10**17)
        .groupBy("k").agg(F.sum(col("v")).alias("sv"))),
        ignore_order=True, expect_padding=False)
    assert out.num_rows == 0


def test_exact_bucket_boundary_is_a_hit():
    """A capacity sitting exactly on a rung pads nothing — and the
    results still match the bucketing-off run and the JAX package."""
    t = dg.gen_table([dg.LongGen(nullable=False)], 1024, seed=6,
                     names=["a"])
    conf = {"spark.rapids.tpu.kernel.bucketing": "ladder",
            "spark.rapids.tpu.kernel.bucketLadder": "1024,8192"}
    before = shapes.snapshot()
    padded = _session(conf).createDataFrame(t).orderBy("a").toArrow()
    after = shapes.snapshot()
    assert after[0] > before[0]          # hits moved
    assert after[2] == before[2]         # zero pad rows
    plain = _session(OFF_CONF).createDataFrame(t).orderBy("a").toArrow()
    assert_tables_equal(plain, padded)
    jax = tpu_session(conf).createDataFrame(t).orderBy("a").toArrow()
    assert padded.equals(jax)


# ---------------------------------------------------------------------------
# the kernel build cache
# ---------------------------------------------------------------------------

def _sweep(s, t):
    return s.createDataFrame(t).groupBy("k").agg(
        F.sum(col("v")).alias("sv")).orderBy("k").toArrow()


def test_warm_second_run_builds_nothing():
    t = skewed_null_table(2000, seed=1)
    s = _session()  # bucketing defaults to pow2
    first = _sweep(s, t)
    c0 = KC.compile_snapshot()[0]
    second = _sweep(s, t)
    assert KC.compile_snapshot()[0] == c0, (
        "warm identical sweep rebuilt a kernel library")
    assert_tables_equal(first, second)


def test_session_warmup_report_and_idempotence():
    s = _session()
    rep = s.warmup([lambda sess: sess.range(0, 2048)])
    assert rep["plans"] == 1 and rep["compiles"] >= 0
    assert set(rep) == {"plans", "compiles", "compile_seconds", "wall_s"}
    # warming the same plan again finds everything built
    rep2 = s.warmup([lambda sess: sess.range(0, 2048),
                     sess_df(s)])
    assert rep2["plans"] == 2 and rep2["compiles"] == 0
    assert rep2["compile_seconds"] == 0.0


def sess_df(s):
    return s.createDataFrame(pa.table({"k": [1, 2, 2], "v": [1.0, 2.0,
                                                              3.0]}))


def test_build_sites_count_every_build(monkeypatch, tmp_path):
    """A library built under a moved build directory counts one build;
    loading it again counts none (the native build, which g++ makes
    here)."""
    from spark_rapids_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    c0, s0 = KC.compile_snapshot()
    native.build("tudo")
    c1, s1 = KC.compile_snapshot()
    assert c1 == c0 + 1 and s1 > s0
    native.build("tudo")
    assert KC.compile_snapshot()[0] == c1
    assert len(list((tmp_path / "native").glob("libtudo_*.so"))) == 1
    # clear() forgets the loaded libraries: the next load looks under the
    # current build directory (built above: no build)
    KC.clear()
    assert not native._libs
    native.load_library("tudo")
    assert "tudo" in native._libs and KC.compile_snapshot()[0] == c1
    KC.clear()  # later loads look under build/ again


def test_sync_manifest_fresh_dir_writes_manifest(tmp_path):
    d = str(tmp_path)
    assert KC._sync_manifest(d) is False  # no manifest yet -> (re)stamp
    mf = os.path.join(d, KC.MANIFEST_NAME)
    assert os.path.exists(mf)
    with open(mf) as f:
        assert json.load(f) == KC._cache_versions()
    # second sync: versions match, entries survive
    entry = os.path.join(d, "kernels", "hash_pairs_0123.so")
    os.makedirs(os.path.dirname(entry))
    with open(entry, "w") as f:
        f.write("built")
    assert KC._sync_manifest(d) is True
    assert os.path.exists(entry)
    # the JAX package's manifest follows the same protocol
    jd = str(tmp_path / "jax")
    os.makedirs(jd)
    assert JKC._sync_manifest(jd) is False and JKC._sync_manifest(jd)


def test_sync_manifest_version_mismatch_clears_entries(tmp_path):
    d = str(tmp_path)
    KC._sync_manifest(d)
    entry = os.path.join(d, "native_entry.so")
    os.makedirs(os.path.join(d, "kernels"))
    with open(entry, "w") as f:
        f.write("built")
    mf = os.path.join(d, KC.MANIFEST_NAME)
    with open(mf) as f:
        stamped = json.load(f)
    assert set(stamped) == {"format", "torch", "cuda", "nvcc", "gxx",
                            "engine"}
    stamped["torch"] = "0.0.0-stale"
    with open(mf, "w") as f:
        json.dump(stamped, f)
    assert KC._sync_manifest(d) is False   # mismatch -> invalidate
    assert not os.path.exists(entry)
    assert not os.path.exists(os.path.join(d, "kernels"))
    with open(mf) as f:
        assert json.load(f) == KC._cache_versions()


def test_persistent_cache_is_a_noop_on_the_cpu(tmp_path):
    """A CPU session builds no kernel: the conf path returns None and
    writes nothing, as the JAX package's does on its CPU backend."""
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    build_dir = CB.BUILD_DIR
    s = _session({"spark.rapids.tpu.kernel.cacheDir": str(tmp_path)})
    assert KC.configure_persistent_cache(s.rapids_conf(), s.device) is None
    assert not os.listdir(str(tmp_path))
    assert CB.BUILD_DIR == build_dir
    got = JKC.configure_persistent_cache(
        tpu_session({"spark.rapids.tpu.kernel.cacheDir":
                     str(tmp_path)}).conf.snapshot())
    assert got is None and not os.listdir(str(tmp_path))
