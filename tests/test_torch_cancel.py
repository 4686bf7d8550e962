"""The port's cooperative cancellation against the JAX package's.

Mirrors ``tests/test_cancel.py`` without its rendezvous and collective
cases (those are in ``tests/test_torch_distributed.py`` and
``tests/test_torch_rendezvous.py``): a cancel fired while a query is provably inside
an armed failure domain (its injection counter moved, so the query
spins in that domain's retry loop) must surface as ``QueryCancelled``
and leave the engine clean — no spillable left registered, no
semaphore holder, an empty spill directory — in both packages, for
``execute``, ``transfer``, ``shuffle_ser``, ``shuffle_exchange`` and
``spill_write`` through the DataFrame API; ``alloc`` (the OOM retry
loop), ``spill_read`` (the restore's retry loop) and ``compile`` (a
build, which no CPU query reaches, with a stand-in compiler) called
directly on a thread inside a query scope.  Then the blocked semaphore
waiter (woken by the cancel, never admitted), the semaphore's wait
accounting, a deadline through ``collect(timeout_ms=)`` and
``session.cancel`` with no active query, each against the JAX
package's on the same steps.

Latency bounds are generous (``BOUND_S``, twenty poll intervals): six
loaded test workers delay a woken thread by far more than the JAX
test's two poll intervals.
"""

import os
import stat
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.column import host_to_device as jax_h2d
from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import cancel as JCN
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.runtime import resilience as JR
from spark_rapids_tpu.runtime import semaphore as JSEM
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.utils import harness as JH

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.runtime import cancel as CN
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import semaphore as SEM
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.utils import harness as H

pytestmark = pytest.mark.chaos

POLL_MS = 50.0
BOUND_S = 20 * POLL_MS / 1000.0

_HOST_SHUFFLE = {"spark.rapids.shuffle.mode": "MULTITHREADED"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_cancel_state():
    """Fresh injectors, cancel scopes, policies and out-of-query
    breakers on both sides: the direct-call cases run outside any query
    scope, where a tripped breaker would outlive its test."""
    olds = (R._policy, JR._policy)
    # the JAX package's query scope depth stays raised after some of its
    # test files (ROADMAP, "Reference side"): its queries here must open
    # their own scope
    JR._STATE.depth = 0
    for mod, cn in ((R, CN), (JR, JCN)):
        mod.INJECTOR.reset()
        cn.reset()
        mod._STATE.breakers = set()
    yield
    R._policy, JR._policy = olds
    for mod, cn in ((R, CN), (JR, JCN)):
        mod.INJECTOR.reset()
        cn.reset()
        mod._STATE.breakers = set()
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()


def table(n=800, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 17, n).astype(np.int32)),
        "v": pa.array(rng.normal(size=n)),
    })


_T = table()
_BIG = table(n=20000, seed=6)


def q_agg(s, jax=False):
    f, c = (JF, jcol) if jax else (F, col)
    return (s.createDataFrame(_T).filter(c("v") > -2.5)
            .groupBy("k").agg(f.sum("v").alias("sv"),
                              f.count("k").alias("c")))


def q_shuffle(s, jax=False):
    f = JF if jax else F
    return (s.createDataFrame(_T).repartition(6, "k")
            .groupBy("k").agg(f.sum("v").alias("sv")))


def q_big(s, jax=False):
    f, c = (JF, jcol) if jax else (F, col)
    return (s.createDataFrame(_BIG).filter(c("v") > -3.0)
            .groupBy("k").agg(f.sum("v").alias("sv")))


# the JAX test's pressure: a pool of a third of the table's bytes and a
# 1-byte host tier, so that the scan's batches go on to disk
_SPILL = {"spark.rapids.tpu.memory.poolSize": 110_000,
          "spark.rapids.memory.host.spillStorageSize": 1,
          "spark.rapids.tpu.batchRows": 4000}


def _check_invariant(rec, jax: bool) -> None:
    who = "jax" if jax else "port"
    assert rec["cancel_sent"], (who, rec["fired"], rec["status"])
    assert rec["status"] == "cancelled", (who, rec["error"])
    assert rec["latency_s"] is not None and rec["latency_s"] < BOUND_S, (
        who, rec["latency_s"])
    assert rec["leaks"] == 0, who
    assert rec["sem_holders"] == 0, who
    assert not rec["spill_files"], (who, rec["spill_files"])
    assert rec["entry"].get("status") == "cancelled"
    assert (rec["entry"].get("cancel") or {}).get("reason") == "user"


@pytest.mark.parametrize("domain,builder,conf", [
    ("execute", q_agg, None),
    ("transfer", q_agg, None),
    ("shuffle_ser", q_shuffle, _HOST_SHUFFLE),
    ("shuffle_exchange", q_shuffle, _HOST_SHUFFLE),
    ("spill_write", q_big, _SPILL),
], ids=["execute", "transfer", "shuffle_ser", "shuffle_exchange",
        "spill_write"])
def test_cancel_mid_domain(domain, builder, conf):
    seed = sum(map(ord, domain)) % 1000
    recs = []
    for jax in (True, False):
        for mod, basic in ((M, B), (JM, JB)):
            mod.reset_manager()
            basic.clear_scan_cache()
        if jax:
            rec = JH.run_cancel_chaos(
                lambda s: builder(s, True), {domain: (1, 10**6)},
                conf=conf, poll_ms=POLL_MS, seed=seed)
        else:
            rec = H.run_cancel_chaos(
                builder, {domain: (1, 10**6)}, conf=conf, poll_ms=POLL_MS,
                seed=seed, device="cpu")
        _check_invariant(rec, jax)
        recs.append(rec)
    assert recs[0]["fired"] == recs[1]["fired"] == domain


# ---------------------------------------------------------------------------
# direct-layer domains: alloc's OOM loop, spill_read's restore loop and
# compile's build
# ---------------------------------------------------------------------------

def _small_batch(jax, seed=0, n=100):
    rng = np.random.default_rng(seed)
    t = pa.table({"a": pa.array(rng.integers(0, 50, n)),
                  "b": pa.array(rng.uniform(0, 1, n))})
    return jax_h2d(t) if jax else host_to_device(t, torch.device("cpu"))


def _cancel_once_inside(mods, domain, qid, work):
    """Run ``work`` on a thread with query ``qid``'s scope open, wait
    until ``domain``'s injection counter moves, cancel, and return
    (exception, request-to-raise seconds)."""
    Rm, CNm = mods

    def fires():
        if Rm is JR:
            return JR._TM_INJECTED.child_values().get(domain, 0)
        return R.counters_snapshot()["faults_injected"].get(domain, 0)

    tok = CNm.begin_query(qid)
    box = {}

    def run():
        try:
            work()
        except BaseException as e:
            box["err"] = e
            box["at"] = time.monotonic()

    base = fires()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and th.is_alive() and fires() <= base:
        time.sleep(0.002)
    t0 = time.monotonic()
    assert CNm.cancel_query(qid, detail=f"test mid-{domain}")
    th.join(timeout=10.0)
    assert not th.is_alive(), f"worker ignored the cancel mid-{domain}"
    CNm.finish_query(tok)
    return box.get("err"), box.get("at", time.monotonic()) - t0


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_cancel_mid_alloc_retry(tmp_path, jax):
    Mm, Rm, CNm = (JM, JR, JCN) if jax else (M, R, CN)
    mgr = Mm.DeviceMemoryManager(budget=1 << 30, spill_path=str(tmp_path))
    b = _small_batch(jax)
    Rm.INJECTOR.configure({"alloc": (1, 10**6)})

    def work():
        # every reserve fires RetryOOM; allow_split=False keeps the same
        # batch spinning, so the loop's own poll is the only way out
        list(Mm.with_retry([b], lambda batch: mgr.reserve(batch.nbytes()),
                           manager=mgr, max_attempts=10**6,
                           allow_split=False))

    err, latency = _cancel_once_inside((Rm, CNm), "alloc", 4301, work)
    assert isinstance(err, CNm.QueryCancelled)
    assert latency < BOUND_S
    assert mgr.report_leaks() == 0


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_cancel_mid_spill_read_retry(tmp_path, jax):
    Mm, Rm, CNm = (JM, JR, JCN) if jax else (M, R, CN)
    mgr = Mm.DeviceMemoryManager(budget=1 << 30, spill_path=str(tmp_path))
    sp = Mm.SpillableBatch(_small_batch(jax, 1), mgr)
    sp.spill_to_host()
    sp.spill_to_disk()
    assert sp.tier == "disk"
    Rm.INJECTOR.configure({"spill_read": (1, 10**6)})
    # real backoff, so that the cancel lands inside a retry sleep
    Rm._policy = Rm.RetryPolicy(backoff_base_ms=2 * POLL_MS,
                                backoff_max_ms=2 * POLL_MS,
                                max_attempts=10**6, budget_per_query=0)
    err, latency = _cancel_once_inside((Rm, CNm), "spill_read", 4302,
                                       sp.get)
    assert isinstance(err, CNm.QueryCancelled)
    assert latency < BOUND_S
    sp.close()
    assert mgr.report_leaks() == 0
    assert not os.listdir(mgr.spill_path)  # payload and sidecar unlinked


def test_cancel_mid_compile(tmp_path, monkeypatch):
    """The JAX test cancels a query inside its jit-build retries; the
    port's ``compile`` domain is the kernel build, cancelled the same
    way inside its retry backoff (a stand-in compiler)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(CB, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path / "kernels")
    R.INJECTOR.configure({"compile": (1, 10**6)})
    R._policy = R.RetryPolicy(backoff_base_ms=2 * POLL_MS,
                              backoff_max_ms=2 * POLL_MS,
                              max_attempts=10**6, budget_per_query=0)
    err, latency = _cancel_once_inside((R, CN), "compile", 4304, CB.build)
    assert isinstance(err, CN.QueryCancelled)
    assert latency < BOUND_S
    assert not (tmp_path / "kernels").exists()  # nothing was built


# ---------------------------------------------------------------------------
# the device semaphore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_cancel_wakes_blocked_semaphore_waiter(jax):
    SEMm, CNm = (JSEM, JCN) if jax else (SEM, CN)
    sem = SEMm.DeviceSemaphore(1)
    tok = CNm.begin_query(4303)
    try:
        sem.acquire()  # pin the only permit
        started = threading.Event()
        box = {}

        def waiter():
            started.set()
            try:
                sem.acquire()
                box["admitted"] = True
            except CNm.QueryCancelled as e:
                box["err"] = e
                box["at"] = time.monotonic()

        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        assert started.wait(5.0)
        time.sleep(0.15)  # the waiter is parked in the wait
        t0 = time.monotonic()
        assert CNm.cancel_query(4303)
        th.join(timeout=5.0)
        assert not th.is_alive()
        assert isinstance(box.get("err"), CNm.QueryCancelled)
        assert box["at"] - t0 < BOUND_S
        assert sem.holders == 1  # the cancelled waiter was never admitted
    finally:
        sem.release()
        CNm.finish_query(tok)
    assert sem.holders == 0


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_semaphore_wait_accounting_counts_only_blocked_time(jax):
    sem = (JSEM if jax else SEM).DeviceSemaphore(1)
    assert sem.acquire() == 0.0  # uncontended: exactly zero
    out = {}

    def waiter():
        out["waited"] = sem.acquire()

    th = threading.Thread(target=waiter, daemon=True)
    t0 = time.monotonic()
    th.start()
    hold_s = 0.3
    # spurious wakeups while the permit is held must not inflate (or
    # reset) the accounting
    for _ in range(5):
        time.sleep(hold_s / 6)
        with sem._cv:
            sem._cv.notify_all()
    time.sleep(hold_s / 6)
    sem.release()
    th.join(timeout=5.0)
    elapsed = time.monotonic() - t0
    assert not th.is_alive()
    assert 0.5 * hold_s <= out["waited"] <= elapsed + 0.01
    sem.release()


# ---------------------------------------------------------------------------
# deadlines and the session API
# ---------------------------------------------------------------------------

_DEADLINE_CONF = {
    "spark.rapids.tpu.query.cancelPollMs": int(POLL_MS),
    "spark.rapids.tpu.retry.backoffBaseMs": int(2 * POLL_MS),
    "spark.rapids.tpu.retry.backoffMaxMs": int(2 * POLL_MS),
    "spark.rapids.tpu.retry.maxAttempts": 1_000_000,
    "spark.rapids.tpu.retry.budgetPerQuery": 0,
    # keep the query spinning in execute retries past the deadline
    "spark.rapids.tpu.test.inject.execute.at": 1,
    "spark.rapids.tpu.test.inject.execute.transientCount": 10**6,
}


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_deadline_expiry_through_collect(jax):
    if jax:
        before = dict(JCN._TM_CANCELLED.child_values())
        s = JH.tpu_session(dict(_DEADLINE_CONF))
    else:
        before = CN.counters_snapshot()["cancelled"]
        s = H.tpu_session(dict(_DEADLINE_CONF), device="cpu")
    df = q_agg(s, jax)
    t0 = time.monotonic()
    with pytest.raises((JCN if jax else CN).QueryCancelled) as ei:
        df.collect(timeout_ms=250)
    wall = time.monotonic() - t0
    assert ei.value.reason == "deadline"
    assert 0.25 <= wall < 0.25 + BOUND_S + 5.0  # planning included
    entry = df._last_query_entry
    assert entry["status"] == "cancelled"
    assert entry["cancel"]["reason"] == "deadline"
    assert entry["cancel"]["latency_s"] < BOUND_S
    after = (JCN._TM_CANCELLED.child_values() if jax
             else CN.counters_snapshot()["cancelled"])
    assert after.get("deadline", 0) == before.get("deadline", 0) + 1
    assert not s.active_queries()
    # both packages: no stats-plane profile without stats collection
    assert s.last_query_profile() is None
    if not jax:
        assert s.query_history(1) == [entry]


def test_query_timeout_conf_deadlines_to_arrow():
    """``spark.rapids.tpu.query.timeoutMs`` deadlines every execution of
    the session without an explicit ``timeout_ms``; the reclaim leaves
    nothing registered and no permit held."""
    s = H.tpu_session(dict(_DEADLINE_CONF, **{
        "spark.rapids.tpu.query.timeoutMs": 200}), device="cpu")
    with pytest.raises(CN.QueryCancelled, match="deadline"):
        q_agg(s).toArrow()
    R.INJECTOR.reset()
    assert M.peek_manager().report_leaks() == 0
    sem = SEM.peek_semaphore()
    assert sem is None or sem.holders == 0
    assert R.open_queries() == [] and CN.active_queries() == []


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_session_cancel_without_active_query_is_false(jax):
    s = JH.tpu_session({}) if jax else H.tpu_session({}, device="cpu")
    assert s.active_queries() == []
    assert s.cancel() is False
    assert s.cancel(12345) is False
