"""Casts from and to strings: the five device casts of ``ops/strings.py``
(``cast_int_to_string_device``, ``cast_bool_to_string_device``,
``cast_string_to_int_device``, ``cast_string_to_bool_device``,
``cast_string_to_float_device``) through ``Cast.eval``, ``Cast``'s host
string casts (``eval_cpu``) and its ``device_support_reason``, against
the JAX package's, and the cast round trip over lineitem through the
API.

The inputs are the JAX package's own (``tests/test_string_cast_tail.py``:
``INTS``, ``STR_INTS``, the uint64 boundary, ``STR_FLOATS``) plus
exponents where ``torch.pow`` is 1 ulp off and 16 to 19 digit
mantissas, laid into one padded batch (W = 16 for the strings, 24 for
the longest boundary ones) beside dead rows.  Data, validity, lengths
and output width are equal exactly on the device branch (``eval`` on
CPU tensors against ``eval_tpu``); data (bits) and validity on the host
branch.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu import conf as JCONF  # noqa: E402
from spark_rapids_tpu.columnar import column as JC  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.columnar import host as JH  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar import host as H  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.conf import RapidsConf  # noqa: E402
from spark_rapids_tpu_torch.exec import basic as B  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.runtime import memory as M  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402
from spark_rapids_tpu_torch.utils import tpch  # noqa: E402

from tests.test_torch_string_ops import check_device, check_host  # noqa: E402

CAP = 64  # rows of a batch; the inputs fill the front, the rest are dead

INTS = [0, 1, -1, 127, -128, 32767, 2147483647, -2147483648,
        9223372036854775807, -9223372036854775808, 42, -999, None]
STR_INTS = ["0", "1", "-1", "+5", " 42 ", "3.7", "-3.7", ".5", "-",
            "abc", "", "  ", "127", "128", "-128", "-129",
            "9223372036854775807", "9223372036854775808",
            "-9223372036854775808", "-9223372036854775809",
            "00012", "1.", None, "\t7\n", "1+2", "--1", "32768", "-32769",
            "2147483648", "-2147483649", "1.2.3", "+-3"]
UINT64_BOUNDARY = ["18446744073709551616", "18446744073709551615",
                   "18446744073709551617", "99999999999999999999",
                   "9223372036854775807", "-9223372036854775808",
                   "1844674407370955161", "18446744073709551610",
                   "-18446744073709551615", "0018446744073709551615"]
STR_BOOLS = ["true", "FALSE", "t", "f", "yes", "no", "y", "N", "1", "0",
             " true ", "x", "", None, "True\t", "tru", "yess"]
STR_FLOATS = ["0", "1.5", "-2.25", "1e3", "-1.5E2", "3.14159", ".5",
              "5.", "inf", "-inf", "Infinity", "NaN", "nan", " 2.5 ",
              "abc", "1e", "", "1.2.3", "--5", "1e400",
              "1e+-5", "1e++5", "1e--5", "1e+5", "1e-5", "1_000", None,
              # exponents where torch.pow(10.0, k) is 1 ulp off (k - 22
              # = 23, 45, ...), mantissas of 16 digits and more
              "1e45", "3e67", "1e187", "2e232", "1e272",
              "9e326", "1e-330", "9999999999999999", "1234567890123456",
              "0.1234567890123", "-0.000001e-300", "+INF", "-Infinity",
              "1e22", "1e23", "123456789e-20"]
# normal as doubles, subnormal as floats
SUBNORMAL_F32 = ["7e-45", "1e-40", "-3.5e-42"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The batches are small (1024 rows): torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def string_batches(strings, width):
    """Both packages' device batches of one string column (the strings
    at the front, dead empty rows behind) and both host batches."""
    n = len(strings)
    mat = np.zeros((CAP, width), np.uint8)
    lengths = np.zeros(CAP, np.int32)
    validity = np.ones(CAP, bool)
    for i, s in enumerate(strings):
        if s is None:
            validity[i] = False
            continue
        b = s.encode()
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    sel = np.arange(CAP) < n
    jb = JC.DeviceBatch(
        JT.StructType((JT.StructField("s", JT.StringT),)),
        (JC.DeviceColumn(JT.StringT, jnp.asarray(mat), jnp.asarray(validity),
                         jnp.asarray(lengths)),), jnp.asarray(sel))
    pb = from_numpy_batch(T.StructType((T.StructField("s", T.StringT),)),
                          [(mat, validity, lengths)], sel, "cpu")
    t = pa.table({"s": pa.array(strings, pa.string())})
    return jb, pb, JH.from_arrow_table(t), H.from_arrow_table(t)


def value_batches(values, arrow_type):
    """Both packages' device and host batches of one fixed-width column."""
    arr = pa.array(values, arrow_type)
    npdt = {pa.int8(): np.int8, pa.int16(): np.int16, pa.int32(): np.int32,
            pa.int64(): np.int64, pa.bool_(): np.bool_}[arrow_type]
    data = np.zeros(CAP, npdt)
    validity = np.ones(CAP, bool)
    for i, v in enumerate(values):
        if v is None:
            validity[i] = False
        else:
            data[i] = v
    sel = np.arange(CAP) < len(values)
    jdt = JT.from_arrow(arrow_type)
    pdt = T.from_arrow(arrow_type)
    jb = JC.DeviceBatch(JT.StructType((JT.StructField("v", jdt),)),
                        (JC.DeviceColumn(jdt, jnp.asarray(data),
                                         jnp.asarray(validity)),),
                        jnp.asarray(sel))
    pb = from_numpy_batch(T.StructType((T.StructField("v", pdt),)),
                          [(data, validity, None)], sel, "cpu")
    t = pa.table({"v": arr})
    return jb, pb, JH.from_arrow_table(t), H.from_arrow_table(t), jdt, pdt


def _both(batches, jdt_src, pdt_src, dst):
    jb, pb, jh, ph = batches
    je = JE.Cast(JE.BoundReference(0, jdt_src), getattr(JT, dst))
    pe = E.Cast(E.BoundReference(0, pdt_src), getattr(T, dst))
    out = check_device(je, pe, jb, pb)
    check_host(je, pe, jh, ph)
    return out


INT_TYPES = [(pa.int8(), [0, 1, -1, 127, -128, 42, None]),
             (pa.int16(), [0, -1, 32767, -32768, 255, None]),
             (pa.int32(), [0, 5, -3, 2147483647, -2147483648, 1000, None]),
             (pa.int64(), INTS)]


@pytest.mark.parametrize("arrow_type, values", INT_TYPES,
                         ids=[str(t) for t, _ in INT_TYPES])
def test_int_to_string_equals_jax(arrow_type, values):
    jb, pb, jh, ph, jdt, pdt = value_batches(values, arrow_type)
    out = _both((jb, pb, jh, ph), jdt, pdt, "StringT")
    assert out.shape == (CAP, 24)


def test_bool_to_string_equals_jax():
    jb, pb, jh, ph, jdt, pdt = value_batches([True, False, None, True],
                                             pa.bool_())
    out = _both((jb, pb, jh, ph), jdt, pdt, "StringT")
    assert out.shape == (CAP, 8)


@pytest.mark.parametrize("dst", ["ByteT", "ShortT", "IntegerT", "LongT"])
def test_string_to_int_family_equals_jax(dst):
    _both(string_batches(STR_INTS, 24), JT.StringT, T.StringT, dst)


def test_string_to_long_uint64_boundary():
    """20-digit magnitudes near 2^64 must null, not wrap: the unsigned
    overflow test runs on int64 bit patterns in the port."""
    batches = string_batches(UINT64_BOUNDARY, 24)
    _both(batches, JT.StringT, T.StringT, "LongT")
    got = E.Cast(E.BoundReference(0, T.StringT), T.LongT).eval(batches[1])
    valid = got.validity.numpy()[:len(UINT64_BOUNDARY)].tolist()
    assert valid == [False, False, False, False, True, True, True, False,
                     False, False]


def test_string_to_bool_equals_jax():
    _both(string_batches(STR_BOOLS, 16), JT.StringT, T.StringT, "BooleanT")


EXACT = ["0", "1.5", "-2.25", "1e3", "-1.5E2", "3.14159", ".5", "5.",
         " 2.5 ", "1e+5", "1e-5", "1e22", "123456789e-20",
         "1234567890123456"]


@pytest.mark.parametrize("dst", ["DoubleT", "FloatT"])
def test_string_to_floating_equals_jax(dst):
    strings = STR_FLOATS + (SUBNORMAL_F32 if dst == "DoubleT" else [])
    jb, pb, jh, ph = string_batches(strings, 16)
    out = _both((jb, pb, jh, ph), JT.StringT, T.StringT, dst)
    if dst == "DoubleT":
        # Python's float() (Java's parseDouble for this grammar): exact
        # where the mantissa fits 2^53 and |exponent| <= 22, within 1 ulp
        # elsewhere (the reason castStringToFloat gates the device cast)
        for i, s in enumerate(strings):
            if s in EXACT:
                assert out[i] == float(s), s
            elif s in ("1e45", "3e67", "1e187", "2e232", "1e272", "1e23"):
                assert abs(out[i] - float(s)) <= np.spacing(float(s)), s


def test_float32_subnormals_are_not_flushed():
    """A string whose value is a float32 subnormal casts to that
    subnormal on the device branch, as Java's parseFloat, the port's CPU
    path and the JAX package's CPU path give it; the JAX package's
    device path on the CPU flushes it to 0.0 (XLA's flush-to-zero on
    f32), a divergence of the reference kept out of the exact
    comparison above (ROADMAP §C)."""
    jb, pb, jh, ph = string_batches(SUBNORMAL_F32, 16)
    pe = E.Cast(E.BoundReference(0, T.StringT), T.FloatT)
    je = JE.Cast(JE.BoundReference(0, JT.StringT), JT.FloatT)
    n = len(SUBNORMAL_F32)
    java = np.array([np.float32(float(s)) for s in SUBNORMAL_F32])
    got = pe.eval(pb).data.numpy()[:n]
    assert got.tobytes() == java.tobytes()
    assert np.asarray(pe.eval_cpu(ph).data).tobytes() == java.tobytes()
    assert np.asarray(je.eval_cpu(jh).data).tobytes() == java.tobytes()
    assert (np.asarray(je.eval_tpu(jb).data)[:n] == 0.0).all()


def test_string_round_trip_at_the_card_shapes():
    """int64 -> string -> int64 over a batch of 1024 random values (the
    round trip of the lineitem cast run)."""
    rng = np.random.default_rng(7)
    vals = rng.integers(-10**18, 10**18, 1000).tolist() + [
        -(1 << 63), (1 << 63) - 1, 0]
    arr = np.array(vals, np.int64)
    pb = from_numpy_batch(T.StructType((T.StructField("v", T.LongT),)),
                          [(arr, None, None)], np.ones(len(arr), bool),
                          "cpu")
    ref = E.BoundReference(0, T.LongT)
    back = E.Cast(E.Cast(ref, T.StringT), T.LongT).eval(pb)
    assert back.validity.all()
    np.testing.assert_array_equal(back.data.numpy(), arr)


HOST_CASTS = [  # (source column, its types, destination)
    ("d", "DoubleT", "StringT"), ("f", "FloatT", "StringT"),
    ("dt", "DateT", "StringT"), ("ts", "TimestampT", "StringT"),
    ("s", "StringT", "DateT"), ("s", "StringT", "TimestampT"),
    ("s", "StringT", "StringT"), ("i", "IntegerT", "StringT"),
    ("b", "BooleanT", "StringT"), ("s", "StringT", "DoubleT"),
    ("s", "StringT", "IntegerT"), ("s", "StringT", "BooleanT"),
]


@pytest.fixture(scope="module")
def host_batches():
    rng = np.random.default_rng(3)
    n = 60
    strs = (STR_INTS + STR_FLOATS + ["19000", "-3", "2020-01-01"])[:n]
    t = pa.table({
        "d": pa.array(list(rng.normal(0, 1e6, n - 4)) + [np.nan, -0.0,
                                                          1e300, None]),
        "f": pa.array(rng.normal(0, 10, n).astype(np.float32)),
        "dt": pa.array(rng.integers(-40000, 40000, n).astype(np.int32),
                       pa.int32()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-(1 << 50), 1 << 50, n),
                       pa.int64()).cast(pa.timestamp("us", tz="UTC")),
        "s": pa.array(strs + [None] * (n - len(strs)), pa.string()),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.5),
    })
    return H.from_arrow_table(t), JH.from_arrow_table(t)


@pytest.mark.parametrize("name, src, dst", HOST_CASTS,
                         ids=[f"{s}_{d}" for _, s, d in HOST_CASTS])
def test_host_string_casts_equal_jax(host_batches, name, src, dst):
    """``Cast.eval_cpu`` with a string on one side equals the JAX
    package's bit for bit: a date or timestamp casts to the string of
    its int32 days or int64 microseconds and parses back as a number,
    as there."""
    ph, jh = host_batches
    idx = ["d", "f", "dt", "ts", "s", "i", "b"].index(name)
    pe = E.Cast(E.BoundReference(idx, getattr(T, src)), getattr(T, dst))
    je = JE.Cast(JE.BoundReference(idx, getattr(JT, src)), getattr(JT, dst))
    got, want = pe.eval_cpu(ph), je.eval_cpu(jh)
    gd, wd = np.asarray(got.data), np.asarray(want.data)
    assert gd.dtype == wd.dtype
    if gd.dtype == object:
        assert gd.tolist() == wd.tolist()
    else:
        assert gd.tobytes() == wd.tobytes()
    np.testing.assert_array_equal(got.valid_mask(), want.valid_mask())


REASON_TYPES = ["StringT", "IntegerT", "LongT", "ByteT", "BooleanT",
                "DoubleT", "FloatT", "DateT", "TimestampT"]


@pytest.mark.parametrize("float_on", [False, True])
def test_device_support_reason_equals_jax(float_on):
    """Every combination with a string on one side gives the JAX
    package's reason (None where the device runs it), with
    ``castStringToFloat`` off and on."""
    raw = {"spark.rapids.sql.castStringToFloat.enabled": float_on}
    conf, jconf = RapidsConf(raw), JCONF.RapidsConf(raw)
    for other in REASON_TYPES:
        for src, dst in (("StringT", other), (other, "StringT")):
            pe = E.Cast(E.BoundReference(0, getattr(T, src)),
                        getattr(T, dst))
            je = JE.Cast(JE.BoundReference(0, getattr(JT, src)),
                         getattr(JT, dst))
            assert pe.device_support_reason(conf) == \
                je.device_support_reason(jconf), (src, dst)
    assert E.Cast(E.BoundReference(0, T.IntegerT),
                  T.LongT).device_support_reason(conf) is None


def test_unported_casts_raise_when_built():
    ref = E.BoundReference(0, T.StringT)
    with pytest.raises(NotImplementedError, match="array"):
        E.Cast(ref, T.ArrayType(T.IntegerT))
    with pytest.raises(NotImplementedError, match="from date"):
        E.Cast(E.BoundReference(0, T.DateT), T.LongT)
    assert E.Cast(ref, T.DateT).dtype == T.DateT


def test_date_and_timestamp_strings_keep_the_reference():
    """The JAX package's host path casts a date to the string of its day
    number, not Spark's ISO date, and parses a string to a date as a day
    number; the port keeps it (ROADMAP §C)."""
    t = pa.table({"dt": pa.array([0, 19000], pa.int32()).cast(pa.date32()),
                  "s": pa.array(["19000", "2020-01-01"])})
    for session, c in ((TpuSession(device="cpu"), col),
                       (JaxSession(), jcol)):
        out = session.createDataFrame(t).select(
            c("dt").cast("string").alias("a"),
            c("s").cast("date").alias("b")).toArrow()
        assert out.column("a").to_pylist() == ["0", "19000"]
        assert out.column("b").to_pylist() == [
            datetime.date(2022, 1, 8), None]


# -- the cast round trip over lineitem through the API -----------------------

def round_trip(c, F_, li):
    """count where cast(cast(l_orderkey as string) as long) == l_orderkey."""
    return li.filter(c("l_orderkey").cast("string").cast("long")
                     == c("l_orderkey")).agg(F_.count("*").alias("n"))


def parsed_sum(c, F_, li):
    return li.agg(F_.sum(F_.concat(c("l_partkey").cast("string"),
                                   F_.lit(".25")).cast("double"))
                  .alias("s"))


def flag_count(c, F_, li):
    return li.filter((c("l_returnflag") == "R").cast("string")
                     .cast("boolean")).agg(F_.count("*").alias("n"))


API_CASES = {"round_trip": round_trip, "parsed_sum": parsed_sum,
             "flag_count": flag_count}


@pytest.fixture(scope="module")
def lineitem():
    return tpch.gen_tpch(0.002)["lineitem"]


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


@pytest.mark.parametrize("float_on", [True, False],
                         ids=["castStringToFloat", "default"])
@pytest.mark.parametrize("case", list(API_CASES))
def test_cast_round_trip_matches_jax(lineitem, case, float_on):
    conf = ({"spark.rapids.sql.castStringToFloat.enabled": True}
            if float_on else {})
    build = API_CASES[case]
    jdf = build(jcol, JF, JaxSession(dict(conf)).createDataFrame(lineitem))
    want = jdf.toArrow()
    df = build(col, F, TpuSession(dict(conf), device="cpu")
               .createDataFrame(lineitem))
    got = df.toArrow()
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert df.fallback_summary() == jdf.fallback_summary()
    assert (df._last_override.fallback_report()
            == jdf._last_override.fallback_report())
    if case == "round_trip":
        assert got.column("n").to_pylist() == [lineitem.num_rows]
    if case == "parsed_sum" and not float_on:
        assert df.fallback_summary()["fallback_ops"] > 0
    else:
        assert df.fallback_summary()["fallback_ops"] == 0
