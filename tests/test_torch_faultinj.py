"""The port's fault injection against the JAX package's.

Mirrors the twelve cases of ``tests/test_faultinj.py`` (the legacy
``injectExecuteErrorAt`` / ``injectTransferErrorAt`` /
``injectTransientCount`` keys, the per-domain keys, the retry attempts,
arming at planning and re-arming) on the same seeded 500-row table and
the same confs: each case's outcome — the rows, or the domain tag and
transience of the ``TerminalDeviceError`` — must be the JAX package's,
and the port's retries must equal its fires.  The ``at`` values are the
JAX test's: the port's ``execute`` counts ``hash_pairs`` dispatches (two
in this query) where the JAX package counts every jitted kernel, so
only outcomes are compared.  Beside them: the new conf keys' defaults
and checks against the JAX package's, the domains the port refuses, and
that a real (not injected) kernel build failure still raises under an
armed injector.
"""

import os
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
from spark_rapids_tpu.utils.harness import tpu_session as jax_session

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.runtime import faultinj
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.utils.harness import tpu_session

_NO_DEGRADE = {"spark.rapids.tpu.retry.hostDegrade.enabled": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_managers():
    """The JAX package's scan stays cached across the module, as in its
    own test file (so its ``at`` values hit the same kernels there: at
    2, the merge)."""
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()
    JR.INJECTOR.reset()
    clean_rows(True)  # caches the JAX package's scan
    yield
    for mod, basic in ((M, B), (JM, JB)):
        mod.reset_manager()
        basic.clear_scan_cache()


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


def table(n=500):
    rng = np.random.default_rng(0)
    return pa.table({"k": pa.array((np.arange(n) % 5).astype(np.int32)),
                     "v": pa.array(rng.normal(size=n))})


_T = table()


def _query(s, jax: bool):
    f, c = (JF, jcol) if jax else (F, col)
    return s.createDataFrame(_T).filter(c("v") > -10).groupBy("k").agg(
        f.sum("v").alias("sv"))


def _session(jax: bool, conf=None):
    return jax_session(conf) if jax else tpu_session(conf, device="cpu")


def _rows(t: pa.Table) -> list:
    return sorted(t.to_pylist(), key=lambda r: r["k"])


def outcome(jax: bool, conf=None):
    """("ok", rows, retries) or ("failed", domain, transient, retries)
    of one run; the injector's fires beside the retries they caused."""
    s = _session(jax, conf)
    df = _query(s, jax)
    err = (JR if jax else R).TerminalDeviceError
    try:
        rows = _rows(df.toArrow())
    except err as e:
        res = (df._last_query_entry.get("resilience") or {})
        return ("failed", e.domain, e.transient,
                res.get("retries_total", 0))
    res = df._last_query_entry.get("resilience") or {}
    return ("ok", rows, res.get("retries_total", 0))


_CLEAN = {}


def clean_rows(jax: bool) -> list:
    """A package's clean run, made once per module."""
    if jax not in _CLEAN:
        _CLEAN[jax] = outcome(jax)[1]
    return _CLEAN[jax]


def _close(a: list, b: list) -> None:
    """Keys exactly, sums within 1e-9 relative (the JAX package adds
    along its segmented scan, the port in group order)."""
    assert [r["k"] for r in a] == [r["k"] for r in b]
    np.testing.assert_allclose([r["sv"] for r in a], [r["sv"] for r in b],
                               rtol=1e-9, atol=1e-12)


def both(conf=None):
    """Both packages' outcomes under ``conf``.  A successful port run
    equals the port's clean rows bit for bit (its degrade path computes
    the same bits); the JAX package's equals its clean rows as its own
    test holds them (within 1e-9: its eager re-run may reorder a sum);
    the two clean runs agree within 1e-9."""
    jax, port = outcome(True, conf), outcome(False, conf)
    assert port[0] == jax[0], (port, jax)
    if port[0] == "ok":
        assert port[1] == clean_rows(False)
        _close(jax[1], clean_rows(True))
        _close(clean_rows(False), clean_rows(True))
    else:
        assert port[1:3] == jax[1:3]
    return jax, port


def _fires(domain: str) -> int:
    return R.counters_snapshot()["faults_injected"].get(domain, 0)


def test_terminal_execute_error_fails_query():
    jax, port = both({"spark.rapids.tpu.test.injectExecuteErrorAt": 2,
                      **_NO_DEGRADE})
    assert port[:3] == ("failed", "execute", False)


def test_terminal_execute_error_degrades_by_default():
    jax, port = both({"spark.rapids.tpu.test.injectExecuteErrorAt": 2})
    assert port[0] == "ok"


def test_transient_execute_error_recovers():
    f0 = _fires("execute")
    jax, port = both({"spark.rapids.tpu.test.injectExecuteErrorAt": 2,
                      "spark.rapids.tpu.test.injectTransientCount": 1})
    assert port[0] == "ok"
    assert port[2] == _fires("execute") - f0 == 1


def test_terminal_transfer_error_fails_query():
    jax, port = both({"spark.rapids.tpu.test.injectTransferErrorAt": 1,
                      **_NO_DEGRADE})
    assert port[:3] == ("failed", "transfer", False)


def test_transient_transfer_error_recovers():
    jax, port = both({"spark.rapids.tpu.test.injectTransferErrorAt": 1,
                      "spark.rapids.tpu.test.injectTransientCount": 1})
    assert len(port[1]) == 5 and port[2] == 1


def test_disarmed_runs_clean():
    jax, port = both()
    assert len(port[1]) == 5 and port[2] == 0


def test_persistent_transient_exhausts_retries():
    f0 = _fires("execute")
    jax, port = both({"spark.rapids.tpu.test.injectExecuteErrorAt": 1,
                      "spark.rapids.tpu.test.injectTransientCount": 5,
                      "spark.rapids.tpu.retry.maxAttempts": 3,
                      "spark.rapids.tpu.retry.backoffBaseMs": 0,
                      **_NO_DEGRADE})
    # retries exhausted on a transient fault: 3 fires, 2 retries
    assert port == ("failed", "execute", True, 2)
    assert _fires("execute") - f0 == 3


def test_max_attempts_conf_is_honored():
    jax, port = both({"spark.rapids.tpu.test.injectExecuteErrorAt": 1,
                      "spark.rapids.tpu.test.injectTransientCount": 4,
                      "spark.rapids.tpu.retry.maxAttempts": 6,
                      "spark.rapids.tpu.retry.backoffBaseMs": 0,
                      **_NO_DEGRADE})
    assert len(port[1]) == 5 and port[2] == 4


@pytest.mark.parametrize("jax", [True, False], ids=["jax", "port"])
def test_clean_session_does_not_disarm(jax):
    inj = (JR if jax else R).INJECTOR
    armed = _session(jax, {"spark.rapids.tpu.test.injectExecuteErrorAt": 4})
    _query(armed, jax)._execute_plan()  # arming happens at planning
    assert inj.armed
    clean = _session(jax)
    clean.createDataFrame(_T).select("k").toArrow()  # another plan
    assert inj.armed  # untouched by the clean conf


def test_rearm_with_identical_conf():
    conf = {"spark.rapids.tpu.test.injectExecuteErrorAt": 1, **_NO_DEGRADE}
    for _ in range(2):
        jax, port = both(conf)
        assert port[:2] == ("failed", "execute")


def test_domain_key_arms_named_domain():
    jax, port = both({"spark.rapids.tpu.test.inject.transfer.at": 1,
                      **_NO_DEGRADE})
    assert port[:2] == ("failed", "transfer")
    assert not R.INJECTOR.armed and not JR.INJECTOR.armed


def test_unknown_domain_rejected():
    for inj in (JR.INJECTOR, R.INJECTOR, faultinj.INJECTOR):
        with pytest.raises(ValueError, match="unknown failure domain"):
            inj.configure({"warp_drive": (1, 0)})


# ---------------------------------------------------------------------------
# the conf keys, and the domains the port refuses
# ---------------------------------------------------------------------------

_NEW_KEYS = {
    "RETRY_BACKOFF_BASE_MS": (0, 2.5, "7", -1),
    "RETRY_BACKOFF_MAX_MS": (0, 1000, -0.5),
    "RETRY_JITTER_SEED": (0, 42, "x"),
    "RETRY_BUDGET_PER_QUERY": (0, 64, -1),
    "RETRY_HOST_DEGRADE": (True, "false", "maybe"),
    "QUERY_TIMEOUT_MS": (0, 250, -5, "x"),
    "CANCEL_POLL_MS": (1, 50, 0, -3),
    "INJECT_EXECUTE_AT": (-1, 2),
    "INJECT_TRANSFER_AT": (-1, 1),
    "INJECT_TRANSIENT_COUNT": (0, 3),
    "LOCKDEP_ENABLED": (False, "true", "x"),
    "LOCKDEP_RAISE_ON_CYCLE": (True, "0"),
}


def _try(Conf, key, v):
    try:
        return ("ok", Conf({key: v})._values[key])
    except ValueError:
        return ("raises", None)


@pytest.mark.parametrize("name", list(_NEW_KEYS))
def test_new_keys_equal_jax(name):
    from spark_rapids_tpu import conf as JC
    pe, je = getattr(C, name), getattr(JC, name)
    assert pe.key == je.key and pe.default == je.default
    for v in _NEW_KEYS[name]:
        assert _try(C.RapidsConf, pe.key, v) == _try(
            JC.RapidsConf, je.key, v), (pe.key, v)


def test_domain_keys_equal_jax_for_the_ported_domains():
    from spark_rapids_tpu import conf as JC
    assert set(C.FAILURE_DOMAINS) < set(JC.FAILURE_DOMAINS)
    assert (set(JC.FAILURE_DOMAINS) - set(C.FAILURE_DOMAINS)
            == set(C.REFUSED_FAILURE_DOMAINS))
    for d in C.FAILURE_DOMAINS:
        for pe, je in ((C.INJECT_DOMAIN_AT[d], JC.INJECT_DOMAIN_AT[d]),
                       (C.INJECT_DOMAIN_TRANSIENT[d],
                        JC.INJECT_DOMAIN_TRANSIENT[d])):
            assert (pe.key, pe.default) == (je.key, je.default)
            assert C.RapidsConf({pe.key: 3}).get(pe) == 3


# ids kept from the slices before the distributed plane: its three
# domains are armable now, with the JAX package's keys
_NOW_PORTED = ("collective", "peer_loss", "rendezvous")


@pytest.mark.parametrize("domain", sorted(
    set(C.REFUSED_FAILURE_DOMAINS) | set(_NOW_PORTED)))
def test_refused_domains_name_their_roadmap_item(domain):
    if domain in _NOW_PORTED:
        from spark_rapids_tpu import conf as JC
        assert domain in C.FAILURE_DOMAINS
        for suffix, v in (("at", 1), ("transientCount", 2)):
            key = f"spark.rapids.tpu.test.inject.{domain}.{suffix}"
            assert C.RapidsConf({key: v}).get(C.REGISTRY[key]) == v
            assert C.REGISTRY[key].default == \
                JC.REGISTRY.entries[key].default
        R.INJECTOR.configure({domain: (1, 0)})
        R.INJECTOR.reset()
        return
    item = "A.11"
    for suffix, v in (("at", 1), ("transientCount", 2)):
        with pytest.raises(ValueError, match=item):
            C.RapidsConf({f"spark.rapids.tpu.test.inject.{domain}."
                          f"{suffix}": v})
    # the defaults are accepted, and change nothing
    C.RapidsConf({f"spark.rapids.tpu.test.inject.{domain}.at": -1})
    with pytest.raises(ValueError, match=item):
        R.INJECTOR.configure({domain: (1, 0)})


# ---------------------------------------------------------------------------
# no silent fallback: a real kernel failure is never retried or degraded
# ---------------------------------------------------------------------------

def test_real_build_failure_raises_under_an_armed_injector(
        tmp_path, monkeypatch):
    """A failing ``nvcc`` raises its RuntimeError through the armed
    ``compile`` domain at once: one attempt, no retry, no degrade."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no GPU toolchain' >&2\n"
                    "exit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    calls = []

    def nvcc():
        calls.append(1)
        return str(fake)

    monkeypatch.setattr(CB, "_nvcc", nvcc)
    monkeypatch.setattr(CB, "BUILD_DIR", tmp_path / "kernels")
    R.INJECTOR.configure({"compile": (5, 2)})  # armed, not firing yet
    before = R.counters_snapshot()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        CB.build()
    after = R.counters_snapshot()
    assert len(calls) == 1
    assert after["retries"] == before["retries"]
    assert after["host_degraded_ops"] == before["host_degraded_ops"]
    assert not os.listdir(tmp_path / "kernels")


def test_real_launch_failure_raises_under_an_armed_injector(monkeypatch):
    """An error raised by the dispatch (as a failed CUDA launch raises)
    propagates unchanged through the armed ``execute`` domain."""
    calls = []

    def failing(*a):
        calls.append(1)
        raise RuntimeError("hash_pairs kernel launch failed: CUDA error 700")

    monkeypatch.setattr(CB, "_dispatch", failing)
    R.INJECTOR.configure({"execute": (9, 1)})
    plain0 = CB.plain_calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        CB.hash_pairs(torch.zeros((2, 8), dtype=torch.int64))
    assert len(calls) == 1 and CB.plain_calls == plain0
