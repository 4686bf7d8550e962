"""The port's chaos invariant against the JAX package's.

Mirrors the deterministic cases of ``tests/test_chaos.py`` for the
port's eight failure domains, on the same seeded 800-row table and the
same schedules (``utils/harness.py::run_chaos`` in both packages):

* a transient fault in each domain (``execute``, ``transfer``,
  ``alloc``, ``shuffle_ser``, ``shuffle_exchange``, and ``spill_write``
  / ``spill_read`` over a pool that pushes the scan to disk) recovers:
  status ``ok`` in both packages, the port's rows bit-identical to its
  clean run, retries equal to fires, no degraded op; ``compile``, which
  no CPU query reaches (nothing is built for CPU tensors), against a
  build with a stand-in compiler inside a query scope;
* a terminal ``execute`` fault degrades and records a tripped breaker,
  or, with ``hostDegrade`` off, fails tagged ``execute``; a terminal
  ``shuffle_exchange`` fault fails tagged;
* the retry counters match the fires, and the per-query budget caps the
  retries;
* the seeded soak at two seeds: both packages hold the invariant.

The JAX package's rows are held to the port's within 1e-9 (the float
sums add in another order); statuses, domain tags, retry counts and
degraded domains exactly.  The ``collective`` case and the rendezvous
cases are in ``tests/test_torch_distributed.py`` and
``tests/test_torch_rendezvous.py``.
"""

import stat

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.runtime import resilience as JR
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.utils import harness as JH

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.runtime import cancel as CN
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.utils import harness as H

pytestmark = pytest.mark.chaos

_HOST_SHUFFLE = {"spark.rapids.shuffle.mode": "MULTITHREADED"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    """A clean injector on both sides, and the JAX package's query scope
    depth at 0: its ``_STATE.depth`` stays raised after some JAX test
    files (ROADMAP, "Reference side"), and a raised depth makes its
    queries join a scope that is never read out."""
    JR._STATE.depth = 0
    for inj in (R.INJECTOR, JR.INJECTOR):
        inj.reset()
    yield
    for inj in (R.INJECTOR, JR.INJECTOR):
        inj.reset()


def table(n=800, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 17, n).astype(np.int32)),
        "v": pa.array(rng.normal(size=n)),
    })


_T = table()
_BIG = table(n=20000, seed=6)


def q_agg(s, jax=False):
    f, c = (JF, jcol) if jax else (F, col)
    return (s.createDataFrame(_T).filter(c("v") > -3.0)
            .groupBy("k").agg(f.sum("v").alias("sv"),
                              f.count("*").alias("c")))


def q_minmax(s, jax=False):
    f, c = (JF, jcol) if jax else (F, col)
    return (s.createDataFrame(_T).filter(c("v") < 3.0)
            .groupBy("k").agg(f.min("v").alias("mn"),
                              f.max("v").alias("mx")))


def q_shuffle(s, jax=False):
    f = JF if jax else F
    return (s.createDataFrame(_T).repartition(6, "k")
            .groupBy("k").agg(f.sum("v").alias("sv")))


def q_big(s, jax=False):
    f, c = (JF, jcol) if jax else (F, col)
    return (s.createDataFrame(_BIG).filter(c("v") > -3.0)
            .groupBy("k").agg(f.sum("v").alias("sv")))


def _spill_conf():
    """A pool of about a third of the big table and a 1-byte host tier:
    the scan's cached batches go device -> host -> disk, and a second
    run restores them from disk."""
    return {"spark.rapids.tpu.memory.poolSize": 110_000,
            "spark.rapids.memory.host.spillStorageSize": 1,
            "spark.rapids.tpu.batchRows": 4000}


def _rows(t: pa.Table) -> list:
    return sorted(t.to_pylist(), key=lambda r: r["k"])


def _close(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                np.testing.assert_allclose(x[k], y[k], rtol=1e-9,
                                           atol=1e-12)
            else:
                assert x[k] == y[k], (k, x, y)


def _fresh():
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()


def _summary(rec) -> dict:
    res = (rec["entry"] or {}).get("resilience") or {}
    return {"status": rec["status"], "domain": rec["domain"],
            "retries": res.get("retries", {}),
            "degraded": sorted({d["domain"]
                                for d in res.get("degraded_ops", [])}),
            "breaker_trips": res.get("breaker_trips", 0)}


def chaos_pair(builder, inject, conf=None, warm=False):
    """``run_chaos`` in both packages (fresh arbiters; ``warm`` runs the
    query once first, unarmed), then each package's clean run.  Returns
    (jax record, port record, jax clean rows, port clean rows)."""
    out = []
    for jax in (True, False):
        _fresh()
        mk = ((lambda c: JH.tpu_session(c)) if jax
              else (lambda c: H.tpu_session(c, device="cpu")))
        if warm:
            builder(mk(dict(conf or {})), jax).toArrow()
        run = JH.run_chaos if jax else (
            lambda b, i, conf: H.run_chaos(b, i, conf, device="cpu"))
        rec = run(lambda s: builder(s, jax), inject, conf)
        clean = _rows(builder(mk(dict(conf or {})), jax).toArrow())
        out.append((rec, clean))
    (jrec, jclean), (prec, pclean) = out
    _close(pclean, jclean)
    return jrec, prec, jclean, pclean


# ---------------------------------------------------------------------------
# transient faults: recovered, bit-identical, retries equal to fires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inject,builder,conf,warm", [
    ({"execute": (2, 1)}, q_agg, None, False),
    ({"transfer": (1, 1)}, q_agg, None, False),
    ({"alloc": (2, 1)}, q_agg, None, False),
    ({"shuffle_ser": (1, 1)}, q_shuffle, _HOST_SHUFFLE, False),
    ({"shuffle_exchange": (1, 1)}, q_shuffle, _HOST_SHUFFLE, False),
    ({"spill_write": (1, 1)}, q_big, _spill_conf(), False),
    ({"spill_read": (1, 1)}, q_big, _spill_conf(), True),
], ids=["execute", "transfer", "alloc", "shuffle_ser", "shuffle_exchange",
        "spill_write", "spill_read"])
def test_transient_fault_recovers_bit_identical(inject, builder, conf,
                                                 warm):
    (domain, (_, fires)), = inject.items()
    f0 = R.counters_snapshot()["faults_injected"].get(domain, 0)
    jrec, prec, jclean, pclean = chaos_pair(builder, inject, conf, warm)
    js, ps = _summary(jrec), _summary(prec)
    assert ps == js
    assert ps["status"] == "ok" and not ps["degraded"]
    assert ps["retries"] == {domain: fires}
    assert (R.counters_snapshot()["faults_injected"].get(domain, 0) - f0
            == fires)
    assert _rows(prec["result"]) == pclean  # bit-identical
    _close(_rows(jrec["result"]), jclean)


def _stand_in_nvcc(tmp_path):
    """A compiler that writes an empty library where nvcc's goes."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return str(fake)


def test_transient_compile_fault_recovers(tmp_path, monkeypatch):
    """JAX: ``{"compile": (1, 1)}`` over ``q_minmax`` recovers with one
    compile retry.  The port's compile domain guards the kernel build,
    which no CPU query reaches: the same schedule over one build inside
    a query scope (a stand-in compiler) gives the same record, and the
    query itself runs clean under it."""
    jrec = JH.run_chaos(lambda s: q_minmax(s, True), {"compile": (1, 1)})
    monkeypatch.setattr(CB, "_nvcc", lambda: _stand_in_nvcc(tmp_path))
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path / "kernels")
    R.INJECTOR.configure({"compile": (1, 1)})
    scope = R.begin_query(10**9)
    tok = CN.begin_query(10**9)
    try:
        path = CB.build()
    finally:
        CN.finish_query(tok)
        res = R.finish_query(scope)
    assert path is not None and path.exists()
    port = {"status": "ok", "retries": res["retries"],
            "degraded": [d["domain"] for d in res["degraded_ops"]]}
    jres = jrec["entry"]["resilience"]
    assert port == {"status": jrec["status"], "retries": jres["retries"],
                    "degraded": [d["domain"]
                                 for d in jres["degraded_ops"]]}
    assert port["retries"] == {"compile": 1}
    prec = H.run_chaos(q_minmax, {"compile": (1, 1)}, device="cpu")
    assert prec["status"] == "ok"


# ---------------------------------------------------------------------------
# terminal faults: degradable domains degrade and record; others fail
# ---------------------------------------------------------------------------

def test_terminal_execute_degrades_and_records():
    plain0 = CB.plain_calls
    jrec, prec, jclean, pclean = chaos_pair(q_agg, {"execute": (2, 0)})
    js, ps = _summary(jrec), _summary(prec)
    assert ps == js
    assert ps["status"] == "ok" and ps["breaker_trips"] >= 1
    assert ps["degraded"] == ["execute"]
    assert CB.plain_calls > plain0  # the plain version served the op
    assert _rows(prec["result"]) == pclean
    assert any("[execute]" in line
               for line in prec["entry"]["fallback_report"])


def test_terminal_execute_without_degrade_fails_clean():
    conf = {"spark.rapids.tpu.retry.hostDegrade.enabled": False}
    jrec, prec, _, _ = chaos_pair(q_agg, {"execute": (2, 0)}, conf)
    assert _summary(prec) == _summary(jrec)
    assert (prec["status"], prec["domain"]) == ("failed", "execute")


def test_terminal_shuffle_exchange_fails_domain_tagged():
    jrec, prec, _, _ = chaos_pair(q_shuffle, {"shuffle_exchange": (1, 0)},
                                  _HOST_SHUFFLE)
    assert _summary(prec) == _summary(jrec)
    assert (prec["status"], prec["domain"]) == ("failed",
                                                "shuffle_exchange")


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def test_retry_counters_match_injected_fires():
    before = R.counters_snapshot()
    jrec, prec, _, pclean = chaos_pair(q_agg, {"execute": (1, 3)})
    after = R.counters_snapshot()
    assert _summary(prec) == _summary(jrec)
    res = prec["entry"]["resilience"]
    assert res["retries"] == {"execute": 3}
    assert res["retries_total"] == 3 and res["retry_exhausted"] == 0
    for k in ("retries", "faults_injected"):
        assert (after[k].get("execute", 0) - before[k].get("execute", 0)
                == 3)
    assert _rows(prec["result"]) == pclean


def test_retry_budget_caps_retries_per_query():
    conf = {"spark.rapids.tpu.retry.budgetPerQuery": 2,
            "spark.rapids.tpu.retry.hostDegrade.enabled": False}
    jrec, prec, _, _ = chaos_pair(q_agg, {"execute": (1, 5)}, conf)
    assert _summary(prec) == _summary(jrec)
    assert (prec["status"], prec["domain"]) == ("failed", "execute")
    res = prec["entry"]["resilience"]
    jres = jrec["entry"]["resilience"]
    assert res["retries_total"] == jres["retries_total"] == 2
    assert res["retry_exhausted"] >= 1


# ---------------------------------------------------------------------------
# the seeded soak
# ---------------------------------------------------------------------------

_SOAK_DOMAINS = ["execute", "transfer", "alloc", "compile",
                 "shuffle_ser", "shuffle_exchange"]


@pytest.mark.parametrize("seed", range(2))
def test_seeded_chaos_soak(seed):
    sched = H.random_chaos_schedule(seed, domains=_SOAK_DOMAINS)
    assert sched == JH.random_chaos_schedule(seed, domains=_SOAK_DOMAINS)
    jrec, prec, jclean, pclean = chaos_pair(q_shuffle, sched,
                                            _HOST_SHUFFLE)
    for rec, clean in ((prec, pclean), (jrec, jclean)):
        if rec["status"] == "failed":
            assert rec["domain"] in ("shuffle_ser", "shuffle_exchange")
        else:
            _close(_rows(rec["result"]), clean)
    assert prec["status"] == jrec["status"]
    if prec["status"] == "ok" and not _summary(prec)["degraded"]:
        assert _rows(prec["result"]) == pclean


def test_no_query_scope_leaks_after_chaos():
    """Every query scope closes, after a success and after a failure,
    also when the fault is raised inside the partition task pool: no
    resilience or cancel scope is left open, no permit held (the JAX
    package's ``_STATE.depth`` leak has no counterpart)."""
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    ok = H.run_chaos(q_agg, {"execute": (1, 0)}, device="cpu")
    failed = H.run_chaos(q_agg, {"execute": (1, 0)}, device="cpu", conf={
        "spark.rapids.tpu.retry.hostDegrade.enabled": False})
    pooled = H.run_chaos(
        lambda s: s.createDataFrame(_T).repartition(4, "k"),
        {"shuffle_exchange": (1, 0)}, device="cpu",
        conf={"spark.rapids.sql.concurrentGpuTasks": 4,
              "spark.sql.adaptive.enabled": False, **_HOST_SHUFFLE})
    assert ((ok["status"], failed["status"], pooled["status"])
            == ("ok", "failed", "failed"))
    assert pooled["domain"] == "shuffle_exchange"
    assert R.open_queries() == [] and CN.active_queries() == []
    assert SEM.peek_semaphore().holders == 0
