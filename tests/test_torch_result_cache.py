"""The port's result cache against the JAX package's.

Mirrors every case of ``tests/test_result_cache.py``: the hit served
bit-identically without the device (no pump task, no device permit),
the cache off, the run-time floor, the conf axes of the key (kernel
rungs, exchange and adaptive confs, the tenant axis), the invalidation
matrix (a re-registered table, a file rewritten in place, TTL expiry,
LRU eviction, an oversized result, ``invalidate_cache``), single-flight
and the subplan (exchange output) mode.  The JAX package's
``QueryServer`` and tenancy are not ported (ROADMAP A.11): its case is
held here through the hit's bypass of the pump and the device permit
and through the tenant axis of the result key.  The JAX package runs
the same cold and warm sequence once per module: its statuses, counter
deltas and rows equal the port's.
"""

import os
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import cache as jcache
from spark_rapids_tpu.runtime import cancel as JCN
from spark_rapids_tpu.runtime import scheduler as JSCH
from spark_rapids_tpu.runtime import semaphore as JSEM
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import cache as cache_mod
from spark_rapids_tpu_torch.cache import keys as K
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import cancel as CN
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import semaphore as SEM
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import TpuSession


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_cache_state():
    """The result cache, the semaphore and the cancel scope are process
    singletons: every test starts and ends with none."""
    cache_mod.reset()
    CN.reset()
    SEM.reset_semaphore()
    M.reset_manager()
    B.clear_scan_cache()
    yield
    cache_mod.reset()
    CN.reset()
    SEM.reset_semaphore()
    M.reset_manager()
    B.clear_scan_cache()


def mk_session(**over):
    raw = {"spark.rapids.tpu.cache.enabled": "true"}
    raw.update({k: str(v) for k, v in over.items()})
    return TpuSession(raw, device="cpu")


def sample_table(scale=1, shift=0):
    n = 64 * scale
    return pa.table({
        "k": [i % 8 for i in range(n)],
        "v": [float(i + shift) for i in range(n)]})


def a_query(s, c=col, Fm=F):
    return s.table("t").filter(c("v") > 2.0).groupBy(
        "k").agg(Fm.sum("v").alias("sv"))


def serialized(t: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue().to_pybytes()


def _rows(t: pa.Table):
    return sorted(map(repr, t.to_pylist()))


@pytest.fixture(scope="module")
def jax_cold_warm():
    """The JAX package's cold and warm run of ``a_query``: the two
    entries' cache statuses, the hit/miss counter deltas and the rows."""
    jcache.reset()
    JCN.reset()
    JSCH.reset_scheduler()
    JSEM.reset_semaphore()
    try:
        s = JaxSession({"spark.rapids.tpu.cache.enabled": "true"})
        s.registerTable("t", sample_table())
        h0, m0 = jcache.HITS.value, jcache.MISSES.value
        cold = a_query(s, jcol, JF).toArrow()
        cold_status = s.query_history()[-1]["cache"]["status"]
        warm = a_query(s, jcol, JF).toArrow()
        warm_entry = s.query_history()[-1]
        return {"statuses": (cold_status, warm_entry["cache"]["status"]),
                "deltas": (jcache.HITS.value - h0, jcache.MISSES.value - m0),
                "semaphore": warm_entry["semaphore"],
                "rows": _rows(cold), "warm_equal": serialized(warm)
                == serialized(cold),
                "stats": {k: s.cache_stats()[k] for k in
                          ("hits", "misses", "entries", "stored")}}
    finally:
        jcache.reset()
        JCN.reset()
        JSCH.reset_scheduler()
        JSEM.reset_semaphore()


# ---------------------------------------------------------------------------
# hit path
# ---------------------------------------------------------------------------

def test_hit_bit_identical_without_device_semaphore(jax_cold_warm):
    s = mk_session()
    s.registerTable("t", sample_table())
    h0 = cache_mod.HITS.value
    m0 = cache_mod.MISSES.value

    cold = a_query(s).toArrow()
    cold_entry = s.query_history()[-1]
    assert cold_entry["cache"]["status"] == "stored"

    warm = a_query(s).toArrow()
    warm_entry = s.query_history()[-1]

    # bit-identical to the cold run, down to the IPC serialization
    assert serialized(warm) == serialized(cold)
    # tagged cache=hit in the query log, with attribution
    assert warm_entry["cache"]["status"] == "hit"
    assert warm_entry["cache"]["key"] == cold_entry["cache"]["key"]
    assert warm_entry["cache"]["signature"]
    assert warm_entry["query_id"] != cold_entry["query_id"]
    # the hit's keyed semaphore window shows no device permit was taken
    assert warm_entry["semaphore"]["max_holders"] == 0
    assert warm_entry["semaphore"]["wait_s"] == 0.0
    # telemetry counters moved exactly once each
    assert cache_mod.HITS.value == h0 + 1
    assert cache_mod.MISSES.value == m0 + 1

    stats = s.cache_stats()
    assert stats["enabled"] and stats["hits"] == 1
    assert stats["misses"] == 1 and stats["entries"] == 1
    assert stats["device_seconds_avoided"] > 0

    # the JAX package's run of the same sequence
    want = jax_cold_warm
    assert (cold_entry["cache"]["status"],
            warm_entry["cache"]["status"]) == want["statuses"]
    assert (1, 1) == want["deltas"]
    assert want["semaphore"] == warm_entry["semaphore"]
    assert want["warm_equal"]
    assert _rows(cold) == want["rows"]
    assert {k: stats[k] for k in want["stats"]} == want["stats"]


def test_cache_disabled_is_inert():
    s = TpuSession({}, device="cpu")
    s.registerTable("t", sample_table())
    a_query(s).toArrow()
    assert "cache" not in s.query_history()[-1]
    assert s.cache_stats() == {"enabled": False}


def test_min_runtime_floor_skips_store():
    s = mk_session(**{"spark.rapids.tpu.cache.minRuntimeMs": 10 ** 7})
    s.registerTable("t", sample_table())
    a_query(s).toArrow()
    e = s.query_history()[-1]["cache"]
    assert e["status"] == "uncached"
    assert e["reason"] == "below_min_runtime"
    a_query(s).toArrow()
    assert s.cache_stats()["hits"] == 0


# ---------------------------------------------------------------------------
# key derivation: confs fold into the key
# ---------------------------------------------------------------------------

def test_backends_do_not_share_a_cache_slot():
    """The plan signature is op+path+schema only: without conf folding,
    kernel.backend=jnp and =cuda would alias one slot."""
    t = sample_table()
    s_jnp = mk_session(**{"spark.rapids.tpu.kernel.backend": "jnp"})
    s_jnp.registerTable("t", t)
    r_jnp = a_query(s_jnp).toArrow()
    key_jnp = s_jnp.query_history()[-1]["cache"]["key"]

    s_cuda = mk_session(**{"spark.rapids.tpu.kernel.backend": "cuda"})
    s_cuda.registerTable("t", t)
    r_cuda = a_query(s_cuda).toArrow()
    e = s_cuda.query_history()[-1]["cache"]
    assert e["status"] == "stored", "second backend must NOT hit"
    assert e["key"] != key_jnp
    # both slots resident; answers agree (rung bit-identity)
    store = cache_mod.peek_cache()
    assert store.stats()["entries"] == 2
    assert sorted(r_jnp.to_pydict()["k"]) == sorted(
        r_cuda.to_pydict()["k"])


def test_result_conf_axes_key_separately():
    base = RapidsConf({})
    assert K.conf_fingerprint(base) == K.conf_fingerprint(RapidsConf({}))
    for key, value in (
            ("spark.rapids.tpu.kernel.backend", "cuda"),
            ("spark.rapids.shuffle.mode", "CACHE_ONLY"),
            ("spark.rapids.tpu.exchange.mode", "host"),
            ("spark.rapids.tpu.adaptive.enabled", "true"),
            ("spark.rapids.tpu.kernel.bucketLadder", "32,64"),
            ("spark.sql.adaptive.enabled", "false")):
        changed = RapidsConf({key: value})
        assert K.conf_fingerprint(changed) != K.conf_fingerprint(base), key
    # the same entries as the JAX package's key, by name
    from spark_rapids_tpu.cache import keys as JK
    assert ([e.key for e in K._result_conf_entries()]
            == [e.key for e in JK._result_conf_entries()])


def test_tenant_conf_overrides_key_separately():
    """The tenant axis: a tenant name folds into the key.  The port
    registers no per-tenant scheduler keys yet (ROADMAP A.11), so the
    tenant's raw overrides are none here."""
    conf = RapidsConf({})
    assert (K.conf_fingerprint(conf, tenant="gold")
            != K.conf_fingerprint(conf, tenant="bronze"))
    assert (K.conf_fingerprint(conf, tenant="gold")
            != K.conf_fingerprint(conf))
    with pytest.raises(ValueError, match="unknown"):
        RapidsConf({"spark.rapids.tpu.scheduler.tenant.gold.weight": "4"})


# ---------------------------------------------------------------------------
# invalidation matrix
# ---------------------------------------------------------------------------

def test_reregistered_table_invalidates():
    s = mk_session()
    s.registerTable("t", sample_table(shift=0))
    first = a_query(s).toArrow()
    i0 = cache_mod.INVALIDATIONS.value

    # refresh the data under the same name: the bump chokepoint
    s.registerTable("t", sample_table(shift=100))
    assert cache_mod.INVALIDATIONS.value > i0
    fresh = a_query(s).toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "stored"
    assert serialized(fresh) != serialized(first), "stale result served"
    # and the fresh result is itself cacheable
    again = a_query(s).toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "hit"
    assert serialized(again) == serialized(fresh)


def test_file_mtime_bump_invalidates(tmp_path):
    path = str(tmp_path / "data.parquet")
    pq.write_table(pa.table({"x": [1, 2, 3]}), path)
    s = mk_session()

    def q():
        return s.read.parquet(path).filter(col("x") > 0)

    first = q().toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "stored"
    hit = q().toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "hit"
    assert serialized(hit) == serialized(first)

    # in-place rewrite: same path, new contents, bumped mtime
    pq.write_table(pa.table({"x": [7, 8, 9]}), path)
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 1_000_000))
    fresh = q().toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "stored"
    assert fresh.to_pydict()["x"] == [7, 8, 9]


def test_ttl_expiry_counts_eviction():
    s = mk_session(**{"spark.rapids.tpu.cache.ttlMs": 50})
    s.registerTable("t", sample_table())
    a_query(s).toArrow()
    time.sleep(0.12)
    a_query(s).toArrow()
    st = s.cache_stats()
    assert st["hits"] == 0 and st["misses"] == 2
    assert st["evictions"] >= 1


def test_lru_eviction_under_max_bytes():
    s = mk_session(**{"spark.rapids.tpu.cache.maxBytes": "2k"})
    s.registerTable("t", sample_table())

    def q(thresh):
        return s.table("t").filter(col("v") > float(thresh))

    sizes = []
    for i in range(8):
        out = q(i).toArrow()
        sizes.append(out.nbytes)
    store = cache_mod.peek_cache()
    st = store.stats()
    assert st["resident_bytes"] <= 2048
    assert st["evictions"] >= 1, (st, sizes)
    # the oldest key is gone; the newest is a hit
    q(7).toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "hit"
    q(0).toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "stored"


def test_oversized_result_never_cached():
    s = mk_session(**{"spark.rapids.tpu.cache.maxBytes": 64})
    s.registerTable("t", sample_table(scale=4))
    s.table("t").filter(col("v") >= 0.0).toArrow()
    e = s.query_history()[-1]["cache"]
    assert e["status"] == "uncached" and e["reason"] == "over_budget"
    assert cache_mod.peek_cache().stats()["entries"] == 0


def test_explicit_invalidate_cache():
    s = mk_session()
    s.registerTable("t", sample_table())
    s.registerTable("u", sample_table(shift=5))
    a_query(s).toArrow()
    s.table("u").filter(col("v") > 6.0).toArrow()
    assert cache_mod.peek_cache().stats()["entries"] == 2

    assert s.invalidate_cache("t") == 1
    a_query(s).toArrow()
    assert s.query_history()[-1]["cache"]["status"] == "stored"

    assert s.invalidate_cache() == 2  # everything
    assert cache_mod.peek_cache().stats()["entries"] == 0
    assert s.invalidate_cache("no-such-table") == 0


# ---------------------------------------------------------------------------
# the front door's bypass, and single-flight
# ---------------------------------------------------------------------------

def test_server_hit_bypasses_scheduler_and_tenants_isolate():
    """A hit runs no pump task and takes no device permit (the JAX
    package's server admits nothing for it); a tenant keys separately
    (``result_key``'s tenant axis)."""
    s = mk_session()
    s.registerTable("t", sample_table())
    cold = a_query(s).toArrow()

    def tasks():
        return TM.REGISTRY.snapshot()["tpuq_pump_tasks_total"]

    t0 = tasks()
    warm = a_query(s).toArrow()
    assert tasks() == t0, "a hit must not pump"
    assert serialized(warm) == serialized(cold)
    entry = s.query_history()[-1]
    assert entry["cache"]["status"] == "hit"
    assert entry["semaphore"]["max_holders"] == 0

    df = a_query(s)
    plan = df._execute_plan()
    conf = s.rapids_conf()
    keys = {tenant: cache_mod.result_key(df._plan, plan, conf,
                                         tenant=tenant).key
            for tenant in (None, "gold", "free")}
    assert len(set(keys.values())) == 3
    assert keys[None] == entry["cache"]["key"]
    st = s.cache_stats()
    assert st["hits"] == 1 and st["stored"] == 1


def test_single_flight_computes_once():
    s = mk_session()
    s.registerTable("t", sample_table(scale=4))
    n = 4
    barrier = threading.Barrier(n)
    results = [None] * n
    errors = []
    # the leader holds its flight open until every follower has joined
    # it, so the four overlap by construction
    store = cache_mod.get_cache(s.rapids_conf())
    joined = threading.Barrier(n)
    orig = store.join_flight

    def join_flight(key):
        role, fl = orig(key)
        if role == "follower":
            joined.wait(timeout=30)
        return role, fl

    store.join_flight = join_flight
    orig_put = store.put

    def put(*a, **kw):
        joined.wait(timeout=30)
        return orig_put(*a, **kw)

    store.put = put

    def run(i):
        try:
            barrier.wait(timeout=30)
            results[i] = a_query(s).toArrow()
        except BaseException as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    base = serialized(results[0])
    assert all(serialized(r) == base for r in results[1:])
    st = s.cache_stats()
    assert st["stored"] == 1, "same key must compute exactly once"
    assert st["misses"] == 1 and st["hits"] == n - 1


# ---------------------------------------------------------------------------
# subplan (exchange-output) mode
# ---------------------------------------------------------------------------

def test_subplan_reuses_shared_exchange_stage():
    # subplan caching hooks the in-process device exchange (CACHE_ONLY);
    # the host-file transport materializes to shuffle files of its own
    s = mk_session(**{"spark.rapids.tpu.cache.subplan.enabled": "true",
                      "spark.rapids.shuffle.mode": "CACHE_ONLY"})
    s.registerTable("t", sample_table(scale=2))

    def shared_stage(s, c=col):
        return s.table("t").repartition(4, c("k"))

    r1 = shared_stage(s).filter(col("v") > 10.0).toArrow()
    st1 = s.cache_stats()
    assert st1["sub_stored"] >= 1, "exchange output must be cached"

    # a PARTIALLY-overlapping query: same exchange subtree, different
    # downstream — the full result key misses, the stage is reused
    r2 = shared_stage(s).filter(col("v") > 50.0).toArrow()
    st2 = s.cache_stats()
    assert st2["sub_hits"] >= 1, "shared stage must be served"
    assert s.query_history()[-1]["cache"]["status"] == "stored"

    # correctness: bit-identical to an uncached evaluation, and equal to
    # the JAX package's
    cache_mod.reset()
    s_ref = TpuSession({"spark.rapids.shuffle.mode": "CACHE_ONLY"},
                       device="cpu")
    s_ref.registerTable("t", sample_table(scale=2))
    ref1 = shared_stage(s_ref).filter(col("v") > 10.0).toArrow()
    ref2 = shared_stage(s_ref).filter(col("v") > 50.0).toArrow()
    assert serialized(r1) == serialized(ref1)
    assert serialized(r2) == serialized(ref2)
    js = JaxSession({"spark.rapids.shuffle.mode": "CACHE_ONLY",
                     "spark.rapids.sql.enabled": False})
    js.registerTable("t", sample_table(scale=2))
    want = shared_stage(js, jcol).filter(jcol("v") > 50.0).toArrow()
    assert _rows(r2) == _rows(want)


def test_fused_regions_that_differ_in_a_literal_key_apart():
    # with fusion and both cache modes on, two queries that differ only
    # in a literal inside a fused filter -> project region neither share
    # a result slot nor an exchange-output slot
    from spark_rapids_tpu_torch.exec.fused import FusedStageExec

    s = mk_session(**{"spark.rapids.tpu.cache.subplan.enabled": "true",
                      "spark.rapids.shuffle.mode": "CACHE_ONLY",
                      "spark.rapids.tpu.fusion.enabled": "true"})
    s.registerTable("t", sample_table(scale=2))
    js = JaxSession({"spark.rapids.shuffle.mode": "CACHE_ONLY",
                     "spark.rapids.sql.enabled": False})
    js.registerTable("t", sample_table(scale=2))

    def q(s, lit, c=col):
        return (s.table("t").filter(c("v") > lit)
                .select(c("k"), (c("v") * 2.0).alias("w"))
                .repartition(4, c("k")))

    def regions(n):
        return ([n] if isinstance(n, FusedStageExec) else []) + [
            r for ch in n.children for r in regions(ch)]

    for lit in (10.0, 50.0):
        df = q(s, lit)
        got = df.toArrow()
        assert len(regions(df._last_plan)) == 1
        assert s.query_history()[-1]["cache"]["status"] == "stored"
        assert _rows(got) == _rows(q(js, lit, jcol).toArrow()), lit
    st = s.cache_stats()
    assert st["hits"] == 0 and st["sub_hits"] == 0
    assert st["sub_stored"] >= 2
