"""``from_utc_timestamp`` and ``to_utc_timestamp`` in the port
(``ops/timezone.py``) against the JAX package: the time-zone cases of
``tests/test_hash_tz.py`` through the DataFrame API.

* Each of the JAX test's four zones (America/Los_Angeles, Asia/Tokyo,
  Europe/Berlin, UTC): every row's shift equals Python's ``zoneinfo``
  offset at that instant, and the rows equal the JAX package's device
  run, with its tree string and its (empty) fallback report.
* The round trip through Asia/Tokyo (``to_utc_timestamp`` is
  ``incompat``: under ``incompatibleOps`` it runs on the device; without
  it the project falls back with the JAX package's reason) gives back
  the input, on the device and on the host.
* The device branch equals the host oracle on America/Los_Angeles, and
  both equal the JAX package's.
* An unknown zone raises at analysis, as the JAX package's does.
* The parsed transition tables equal the JAX package's, and the device
  tables are cached per (zone, device).

Timestamps, validity and plan strings are compared exactly.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import timezone as JTZ
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.ops import timezone as TZ
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession

ZONES = ["America/Los_Angeles", "Asia/Tokyo", "Europe/Berlin", "UTC"]
TEST = {"spark.rapids.sql.test.enabled": True}
HOST = {"spark.rapids.sql.enabled": False}
INCOMPAT = {"spark.rapids.sql.incompatibleOps.enabled": True}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


def _ts_table(start=1950, end=2030, n=500, seed=3):
    """``tests/test_hash_tz.py::_ts_table``."""
    rng = np.random.default_rng(seed)
    lo = int(datetime.datetime(start, 1, 1,
                               tzinfo=datetime.timezone.utc).timestamp())
    hi = int(datetime.datetime(end, 1, 1,
                               tzinfo=datetime.timezone.utc).timestamp())
    secs = rng.integers(lo, hi, n)
    us = secs * 1_000_000 + rng.integers(0, 1_000_000, n)
    return pa.table({"ts": pa.array(us, type=pa.int64()).cast(
        pa.timestamp("us", tz="UTC"))})


WIDE = _ts_table()
ROUND = _ts_table(1995, 2025, 300, 9)
ORACLE = _ts_table(1960, 2035, 400, 11)


def _from(tz):
    return lambda s, F, c: s.createDataFrame(WIDE).select(
        c("ts"), F.from_utc_timestamp(c("ts"), tz).alias("w"))


def _round_trip(s, F, c):
    return s.createDataFrame(ROUND).select(
        F.to_utc_timestamp(F.from_utc_timestamp(c("ts"), "Asia/Tokyo"),
                           "Asia/Tokyo").alias("rt"), c("ts"))


# name: (build(session, F, col), conf)
CASES = dict(
    {f"from_utc_{tz}": (_from(tz), TEST) for tz in ZONES},
    round_trip=(_round_trip, dict(TEST, **INCOMPAT)),
    round_trip_falls_back=(_round_trip, {}),
    device_equals_oracle=(
        lambda s, F, c: s.createDataFrame(ORACLE).select(
            F.from_utc_timestamp(c("ts"), "America/Los_Angeles")
            .alias("w")), TEST))


@pytest.fixture(scope="module")
def jax_run():
    memo = {}

    def run(name, host=False):
        if (name, host) not in memo:
            build, conf = CASES[name]
            if host:
                memo[(name, host)] = (build(JaxSession(dict(
                    conf, **HOST)), JF, jcol).toArrow(), None, None)
            else:
                df = build(JaxSession(dict(conf)), JF, jcol)
                out = df.toArrow()
                memo[(name, host)] = (
                    out, df._last_override.fallback_report(),
                    df._last_plan.tree_string())
        return memo[(name, host)]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_device_equals_jax(jax_run, name):
    build, conf = CASES[name]
    df = build(TpuSession(dict(conf), device="cpu"), F, col)
    got = df.toArrow()
    want, report, tree = jax_run(name)
    assert got.equals(want)
    assert df._last_override.fallback_report() == report
    assert df._last_plan.tree_string() == tree
    if name == "round_trip_falls_back":
        assert report and all("ToUTCTimestamp" in r for r in report)
    else:
        assert report == []


@pytest.mark.parametrize("name", list(CASES))
def test_host_equals_jax(jax_run, name):
    build, conf = CASES[name]
    got = build(TpuSession(dict(conf, **HOST), device="cpu"), F,
                col).toArrow()
    assert got.equals(jax_run(name, host=True)[0])


@pytest.mark.parametrize("tz", ZONES)
def test_from_utc_timestamp_matches_zoneinfo(tz):
    """Every row's shift is the zone's ``zoneinfo`` offset then."""
    import zoneinfo
    out = _from(tz)(TpuSession(dict(TEST), device="cpu"), F, col).toArrow()
    zi = zoneinfo.ZoneInfo(tz)
    for ts, w in zip(out.column("ts").to_pylist(),
                     out.column("w").to_pylist()):
        off = zi.utcoffset(ts).total_seconds()
        assert (w - ts).total_seconds() == off, (ts, w, off)


def test_round_trip_gives_back_the_input():
    for conf in (dict(TEST, **INCOMPAT), HOST):
        out = _round_trip(TpuSession(conf, device="cpu"), F, col).toArrow()
        assert out.column("rt").equals(out.column("ts"))


def test_device_branch_equals_host_branch():
    build, conf = CASES["device_equals_oracle"]
    dev = build(TpuSession(dict(conf), device="cpu"), F, col).toArrow()
    host = build(TpuSession(dict(HOST), device="cpu"), F, col).toArrow()
    assert dev.equals(host)


def test_unknown_zone_raises():
    """At analysis, before anything runs, as the JAX package's does."""
    t = _ts_table(2000, 2001, 5)
    with pytest.raises(ValueError, match="unknown timezone") as pe:
        TpuSession(dict(TEST), device="cpu").createDataFrame(t).select(
            F.from_utc_timestamp(col("ts"), "Not/AZone"))
    with pytest.raises(ValueError) as je:
        JaxSession(dict(TEST)).createDataFrame(t).select(
            JF.from_utc_timestamp(jcol("ts"), "Not/AZone"))
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("tz", ZONES + ["Asia/Kolkata"])
def test_tables_equal_jax_and_cache_per_device(tz):
    trans, offs = TZ.parse_tzif(tz)
    jtrans, joffs = JTZ.parse_tzif(tz)
    assert np.array_equal(trans, jtrans) and np.array_equal(offs, joffs)
    cpu = torch.device("cpu")
    first = TZ.TZ_CACHE.device(tz, cpu)
    assert TZ.TZ_CACHE.device(tz, cpu) is first
    assert np.array_equal(first[0].numpy(), trans)
    assert np.array_equal(first[1].numpy(), offs.astype(np.int64))
