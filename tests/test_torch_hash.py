"""Spark's ``hash`` (``Murmur3Hash``) and ``xxhash64`` (``XxHash64``) in
the port's ``ops/hashing.py`` against the JAX package's, bit for bit.

Mirrors the hash cases of ``tests/test_hash_and_strings.py`` (the
published vector, the scalar reference, every column type) and the four
xxhash64 cases of ``tests/test_hash_tz.py`` (device against the CPU
oracle, the scalar reference, every string length 0..W through each of
the 32-byte stripes, 8-byte words, the 4-byte word and the tail bytes,
and NaN, -0.0, +0.0, null and inf), on tables made with the JAX
package's data generators from a seed.  The device branch is the port's
``eval`` on CPU tensors against the JAX package's ``eval_tpu``, the host
branch its ``eval_cpu`` against the JAX package's; the API cases run the
JAX package's session and the port's (``device="cpu"`` and a plain CPU
session), the rows equal in order.  Every hash is exact.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

from spark_rapids_tpu.columnar import column as JC  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.columnar import host as JH  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import hashing as JHH  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402
from spark_rapids_tpu.utils import datagen as dg  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar import host as H  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import host_to_device  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import hashing as HH  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(tbl, build):
    """(port device, JAX device, port host, JAX host) results of the same
    hash expression over ``tbl``'s columns, as int lists of the live
    rows."""
    refs = [(i, T.from_arrow(c.type)) for i, c in enumerate(tbl.columns)]
    pexpr = build(HH, [E.BoundReference(i, dt) for i, dt in refs])
    jexpr = build(JHH, [JE.BoundReference(i, JT.from_arrow(c.type))
                        for i, c in enumerate(tbl.columns)])
    n = tbl.num_rows
    pd = pexpr.eval(host_to_device(tbl, torch.device("cpu"))).data
    jd = jexpr.eval_tpu(JC.host_to_device(tbl)).data
    ph = pexpr.eval_cpu(H.from_arrow_table(tbl)).data
    jh = jexpr.eval_cpu(JH.from_arrow_table(tbl)).data
    assert pd.numpy().dtype == np.asarray(jd).dtype
    assert ph.dtype == np.asarray(jh).dtype
    return (pd.numpy()[:n].tolist(), np.asarray(jd)[:n].tolist(),
            ph.tolist(), np.asarray(jh).tolist())


def murmur(M, refs):
    return M.Murmur3Hash(refs)


def xxh(M, refs):
    return M.XxHash64(refs)


def test_spark_hash_known_vectors():
    """``SELECT hash('Spark')`` is 228093765 in Spark; a null leaves the
    seed, 42."""
    t = pa.table({"s": pa.array(["Spark"]),
                  "i": pa.array([None], pa.int32())})
    pd, jd, ph, jh = both(t.select(["s"]), murmur)
    assert pd == jd == ph == jh == [228093765]
    pd, jd, ph, jh = both(t.select(["i"]), murmur)
    assert pd == jd == ph == jh == [42]


def test_hash_ints_against_the_scalar_reference():
    tbl = dg.gen_table([dg.IntegerGen(), dg.LongGen()], 300, seed=11)
    pd, jd, ph, jh = both(tbl, murmur)
    assert pd == jd and ph == jh == pd
    a, b = tbl.column(0).to_pylist(), tbl.column(1).to_pylist()
    for i in range(0, 300, 37):
        assert pd[i] == JHH.spark_hash_py([a[i], b[i]],
                                          [JT.IntegerT, JT.LongT]), i


GENS = [dg.FloatGen(), dg.DoubleGen(), dg.BooleanGen(), dg.DateGen(),
        dg.TimestampGen(), dg.StringGen(max_len=13), dg.ByteGen(),
        dg.ShortGen()]


@pytest.mark.parametrize("build", [murmur, xxh], ids=["hash", "xxhash64"])
@pytest.mark.parametrize("gen", GENS, ids=lambda g: str(g.dtype))
def test_every_type_equals_jax(gen, build):
    tbl = dg.gen_table([gen], 300, seed=12)
    pd, jd, ph, jh = both(tbl, build)
    assert pd == jd
    assert ph == jh == pd


def test_hash_strings_against_the_scalar_reference():
    tbl = dg.gen_table([dg.StringGen(max_len=11)], 64, seed=13)
    pd, _, ph, _ = both(tbl, murmur)
    vals = tbl.column(0).to_pylist()
    for i in range(64):
        want = JHH.spark_hash_py([vals[i]], [JT.StringT])
        assert pd[i] == ph[i] == want, (i, vals[i])


# -- xxhash64 (tests/test_hash_tz.py) ---------------------------------------

def gen_table(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": dg.IntegerGen().generate(rng, n),
        "l": dg.LongGen().generate(rng, n),
        "d": dg.DoubleGen().generate(rng, n),
        "f": dg.FloatGen().generate(rng, n),
        "s": dg.StringGen().generate(rng, n),
        "b": dg.BooleanGen().generate(rng, n),
    })


def _xxh_all(s, F_, col_):
    return s.createDataFrame(gen_table()).select(
        F_.xxhash64(col_("i"), col_("l"), col_("d"), col_("f"), col_("s"),
                    col_("b")).alias("h"))


def test_xxhash64_device_matches_oracle():
    """The device path equals the CPU session's (the oracle) and the JAX
    package's, row for row; the plan has no fallback."""
    df = _xxh_all(TpuSession(device="cpu"), F, col)
    got = df.toArrow()
    assert df._last_override.fallback_report() == []
    cpu = _xxh_all(TpuSession({"spark.rapids.sql.enabled": False},
                              device="cpu"), F, col).toArrow()
    want = _xxh_all(JaxSession(), JF, jcol).toArrow()
    assert got.equals(cpu) and got.equals(want)


def test_xxhash64_matches_scalar_reference():
    t = gen_table(7, 64)
    got = TpuSession(device="cpu").createDataFrame(t).select(
        F.xxhash64(col("i"), col("s"), col("d")).alias("h")).toArrow()
    for r, h in zip(t.to_pylist(), got.column("h").to_pylist()):
        want = JHH.spark_xxhash_py([r["i"], r["s"], r["d"]],
                                   [JT.IntegerT, JT.StringT, JT.DoubleT])
        assert h == want, (r, h, want)


W = 70


def test_xxhash64_string_all_lengths():
    """Every length 0..W in one padded matrix: each reaches the stripes,
    the 8-byte words, the 4-byte word and the tail bytes in its own
    mix; both branches equal the JAX package's and the scalar
    reference."""
    strs = ["x" * i for i in range(W + 1)]
    strs += [bytes(range(97, 97 + i % 26)).decode() * (1 + i // 26)
             for i in range(W + 1)]
    t = pa.table({"s": pa.array(strs)})
    pd, jd, ph, jh = both(t, xxh)
    assert pd == jd and ph == jh == pd
    for v, h in zip(strs, pd):
        assert h == JHH.spark_xxhash_py([v], [JT.StringT]), (len(v), h)


def test_xxhash64_specials():
    """NaN hashes as the canonical NaN, -0.0 by its own bits, a null
    leaves the seed."""
    t = pa.table({"d": pa.array([float("nan"), -0.0, 0.0, None,
                                 float("inf")]),
                  "f": pa.array([float("nan"), -0.0, 0.0, None,
                                 float("inf")], pa.float32())})
    for c in ("d", "f"):
        pd, jd, ph, jh = both(t.select([c]), xxh)
        assert pd == jd and ph == jh == pd
        assert pd[1] != pd[2] and pd[3] == 42
    both_t = TpuSession(device="cpu").createDataFrame(t).select(
        F.xxhash64(col("d")).alias("h"), F.hash(col("d")).alias("m"))
    want = JaxSession().createDataFrame(t).select(
        JF.xxhash64(jcol("d")).alias("h"), JF.hash(jcol("d")).alias("m"))
    assert both_t.toArrow().equals(want.toArrow())


def test_scalar_references_agree():
    """The port's scalar xxhash64 reference is the JAX package's."""
    rng = np.random.default_rng(5)
    for n in range(0, 80, 3):
        b = bytes(rng.integers(0, 256, n).astype(np.uint8))
        assert HH.xxh_bytes_py(b, 42) == JHH.xxh_bytes_py(b, 42)
    for v in (0, 1, -1, 1 << 62, -(1 << 63)):
        assert HH.xxh_long_py(v & HH.M64, 42) == JHH.xxh_long_py(
            v & HH.M64, 42)
        assert HH.xxh_int_py(v & 0xFFFFFFFF, 7) == JHH.xxh_int_py(
            v & 0xFFFFFFFF, 7)
