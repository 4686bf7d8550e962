"""The chaos and cancel harnesses of the failure domains.

The counterpart of the JAX package's ``utils/harness.py``, its chaos
part: run a query under a fault-injection schedule across the failure
domains (``runtime/resilience.py``) and read the outcome — transient
faults ridden out, terminal faults degraded to a recorded plain-path
result or failed with a domain-tagged error, a bare
``InjectedDeviceError`` never — and fire a cancel while a query is
provably inside an armed domain, then read what is left (spillables,
semaphore holders, spill files).  ``run_rendezvous_chaos`` holds the
distributed domains (``rendezvous``, ``peer_loss``) to their invariant
over N client threads and a real coordinator.  Sessions run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.sql.session import TpuSession

Schedule = Dict[str, Tuple[int, int]]


def tpu_session(conf: Optional[Dict] = None, device="cuda") -> TpuSession:
    base = {"spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": True}
    base.update(conf or {})
    return TpuSession(base, device=device)


def inject_conf(inject: Schedule) -> Dict:
    """The conf keys arming ``inject`` ({domain: (at, transient)})."""
    out = {}
    for d, (at, budget) in inject.items():
        out[f"spark.rapids.tpu.test.inject.{d}.at"] = at
        out[f"spark.rapids.tpu.test.inject.{d}.transientCount"] = budget
    return out


def run_chaos(df_builder: Callable[[TpuSession], "object"],
              inject: Schedule, conf: Optional[Dict] = None,
              device="cuda") -> dict:
    """Run one query with ``inject``'s domains armed (backoff zeroed).

    Returns ``{"status": "ok" | "failed", "result", "error", "domain",
    "entry"}``: ``ok`` covers recovery and degraded success (see
    ``entry["resilience"]["degraded_ops"]``), ``failed`` a
    domain-tagged ``TerminalDeviceError``.  A bare
    ``InjectedDeviceError`` leaving the engine raises AssertionError."""
    from spark_rapids_tpu_torch.runtime import resilience as R

    full: Dict = {"spark.rapids.tpu.retry.backoffBaseMs": 0}
    full.update(conf or {})
    full.update(inject_conf(inject))
    R.INJECTOR.reset()
    df = df_builder(tpu_session(full, device))
    rec = {"status": "ok", "result": None, "error": None,
           "domain": None, "entry": None}
    try:
        rec["result"] = df.toArrow()
    except R.InjectedDeviceError as e:
        raise AssertionError(
            f"bare InjectedDeviceError escaped the engine: {e}") from e
    except R.TerminalDeviceError as e:
        rec.update(status="failed", error=e, domain=e.domain)
    finally:
        R.INJECTOR.reset()
    rec["entry"] = getattr(df, "_last_query_entry", None)
    return rec


def random_chaos_schedule(seed: int, domains=None,
                          max_at: int = 6) -> Schedule:
    """A seed-deterministic schedule: 1-2 domains, each armed at a
    random call count with a random transient budget (0 = terminal)."""
    from spark_rapids_tpu_torch.runtime.resilience import DOMAINS

    rnd = random.Random(seed)
    pool = list(domains if domains is not None else DOMAINS)
    picks = rnd.sample(pool, k=min(rnd.randint(1, 2), len(pool)))
    return {d: (rnd.randint(1, max_at), rnd.choice([0, 1, 1, 2, 3]))
            for d in picks}


def run_rendezvous_chaos(inject: Schedule, nprocs: int = 3,
                         heartbeat_s: float = 0.05, lease_s: float = 0.3,
                         stage_timeout: float = 5.0) -> dict:
    """Run an N-participant two-phase rendezvous stage (allgather +
    entry barrier through ``run_stage_epochs``) with the ``rendezvous``
    / ``peer_loss`` domains armed, one client thread per participant.

    The invariant: a **transient** ``rendezvous`` fault -> every
    participant retries at a bumped epoch and completes with results
    identical to a clean run; a ``peer_loss`` fault -> the victim
    simulates death (heartbeat silenced, lease expires) and EVERY
    survivor raises the same peer-tagged ``TerminalDeviceError`` within
    ~2x the lease; either way the coordinator's ``_stages`` table drains
    to empty, and a bare ``InjectedDeviceError`` never escapes.

    Returns ``{"records": [per-pid record], "live_stages": {...},
    "expected": [the clean allgather result]}``; each record holds
    ``pid, status (ok|failed|bare_injected), result, error, domain,
    peer, died, elapsed``."""
    from spark_rapids_tpu_torch.parallel import rendezvous as RD
    from spark_rapids_tpu_torch.runtime import resilience as R

    R.INJECTOR.reset()
    R.INJECTOR.configure(inject)
    policy = R.RetryPolicy(backoff_base_ms=0)
    coord = RD.RendezvousCoordinator(nprocs, lease_s=lease_s)
    payloads = {pid: {"pid": pid, "v": pid * 11} for pid in range(nprocs)}
    records: list = [None] * nprocs
    ready = threading.Barrier(nprocs)

    def run(pid: int) -> None:
        client = RD.RendezvousClient(coord.address, pid,
                                     default_timeout=stage_timeout)
        rec = {"pid": pid, "status": "ok", "result": None, "error": None,
               "domain": None, "peer": None, "died": False,
               "elapsed": 0.0}
        try:
            client.start_heartbeat(heartbeat_s)
            ready.wait(timeout=30.0)
            t0 = time.monotonic()

            def attempt(epoch: int):
                vals = client.allgather("chaos:gather", payloads[pid],
                                        epoch=epoch)
                client.barrier("chaos:enter", epoch=epoch)
                return vals

            try:
                rec["result"] = RD.run_stage_epochs(
                    client, "chaos", attempt, policy=policy)
            finally:
                rec["elapsed"] = time.monotonic() - t0
        except R.TerminalDeviceError as e:
            rec["status"] = "failed"
            rec["error"] = e
            rec["domain"] = e.domain
            rec["peer"] = e.peer
            rec["died"] = isinstance(e.cause, R.InjectedDeviceError)
        except R.InjectedDeviceError as e:  # pragma: no cover - invariant
            rec["status"] = "bare_injected"
            rec["error"] = e
        finally:
            client.stop_heartbeat()
            records[pid] = rec

    threads = [threading.Thread(target=run, args=(pid,), daemon=True)
               for pid in range(nprocs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    hung = [i for i, r in enumerate(records) if r is None]
    live_stages = {k: st.waiters for k, st in coord._stages.items()}
    coord.shutdown()
    R.INJECTOR.reset()
    assert not hung, f"rendezvous chaos participants hung: {hung}"
    for rec in records:
        assert rec["status"] != "bare_injected", (
            f"bare InjectedDeviceError escaped: {rec['error']!r}")
    return {"records": records, "live_stages": live_stages,
            "expected": [payloads[i] for i in range(nprocs)]}


def run_cancel_chaos(df_builder: Callable[[TpuSession], "object"],
                     inject: Schedule, conf: Optional[Dict] = None,
                     poll_ms: float = 50.0, seed: int = 0,
                     timeout_s: float = 60.0, device="cuda") -> dict:
    """Run one query on a thread with ``inject``'s domains armed (a
    large transient budget keeps it spinning in the domain's retry
    loop, backoff pinned to 2x the poll interval), wait until a domain
    fired, cancel at a seeded point inside the retry window, and read
    what is left.

    Returns ``{"status": "cancelled" | "completed" | "error", "error",
    "fired", "cancel_sent", "latency_s", "leaks", "sem_holders",
    "spill_files", "entry"}``."""
    from spark_rapids_tpu_torch.runtime import cancel as CN
    from spark_rapids_tpu_torch.runtime import memory as M
    from spark_rapids_tpu_torch.runtime import resilience as R
    from spark_rapids_tpu_torch.runtime.semaphore import peek_semaphore

    backoff_ms = max(int(2 * poll_ms), 1)
    full: Dict = {
        "spark.rapids.tpu.query.cancelPollMs": int(poll_ms),
        "spark.rapids.tpu.retry.backoffBaseMs": backoff_ms,
        "spark.rapids.tpu.retry.backoffMaxMs": backoff_ms,
        "spark.rapids.tpu.retry.maxAttempts": 1_000_000,
        "spark.rapids.tpu.retry.budgetPerQuery": 0,  # unlimited
    }
    full.update(conf or {})
    full.update(inject_conf(inject))
    R.INJECTOR.reset()
    CN.reset()
    df = df_builder(tpu_session(full, device))
    base = R.counters_snapshot()["faults_injected"]
    box: Dict = {}

    def run():
        try:
            box["result"] = df.toArrow()
        except BaseException as e:
            box["error"] = e

    worker = threading.Thread(target=run, daemon=True,
                              name="tpuq-cancel-chaos-query")
    worker.start()
    fired = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and worker.is_alive():
        cur = R.counters_snapshot()["faults_injected"]
        fired = next((d for d in inject
                      if cur.get(d, 0) > base.get(d, 0)), None)
        if fired is not None:
            break
        time.sleep(0.002)
    time.sleep(random.Random(seed).uniform(0.0, backoff_ms / 1000.0))
    active = CN.active_queries()
    cancel_sent = bool(active) and CN.cancel_query(
        active[0], reason="user",
        detail=f"cancel-chaos mid-{fired or 'unknown'}")
    worker.join(timeout=timeout_s)
    R.INJECTOR.reset()
    assert not worker.is_alive(), (
        f"query failed to observe the cancel within {timeout_s}s "
        f"(mid-{fired}; cancel_sent={cancel_sent})")
    err = box.get("error")
    status = ("cancelled" if isinstance(err, CN.QueryCancelled)
              else "error" if err is not None else "completed")
    entry = getattr(df, "_last_query_entry", None) or {}
    mgr = M.peek_manager()
    sem = peek_semaphore()
    spill_files = []
    if mgr is not None and os.path.isdir(mgr.spill_path):
        spill_files = sorted(os.listdir(mgr.spill_path))
    return {
        "status": status, "error": err, "fired": fired,
        "cancel_sent": cancel_sent,
        "latency_s": (entry.get("cancel") or {}).get("latency_s"),
        "leaks": mgr.report_leaks() if mgr is not None else 0,
        "sem_holders": sem.holders if sem is not None else 0,
        "spill_files": spill_files, "entry": entry,
    }
