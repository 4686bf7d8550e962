"""Failure domains, retry policy and circuit breakers.

[REF: spark-rapids-jni :: src/main/cpp/faultinj/ — the LD_PRELOAD CUDA
 interceptor forcing errors at arbitrary driver entry points;
 sql-plugin :: RmmRapidsRetryIterator.scala — the uniform
 rollback-and-retry contract every device step gets]

The counterpart of the JAX package's ``runtime/resilience.py``.  The
engine's device and IO boundaries are named **failure domains**:

======================  ======================================  ==========
domain                  chokepoint                              degradable
======================  ======================================  ==========
``execute``             ``hash_pairs`` dispatch (cuda_backend)  yes: plain
``transfer``            device->host pull (columnar.column)     yes: plain
``alloc``               device reservation (runtime.memory)     OOM retry
``spill_write``         host->disk spill (np.savez)             yes: host
``spill_read``          disk->host restore (np.load)            no
``shuffle_ser``         tudo serialization (shuffle.manager)    no
``shuffle_exchange``    reduce-side shuffle read                no
``collective``          ICI all_to_all (exec.distributed)       yes: host
                                                                shuffle
``rendezvous``          coordinator barrier (parallel.          no: epoch
                        rendezvous :: allgather)                retry
``peer_loss``           simulated executor death                no: fails
                                                                slice
``compile``             ``hash_pairs.cu`` build (cuda_backend)  yes: plain
======================  ======================================  ==========

The distributed domains retry as in the JAX package: ``rendezvous``
faults re-enter the stage at epoch+1 through ``run_stage_epochs`` (same
policy, same budget), and ``peer_loss`` is always terminal — every
survivor raises the same peer-tagged ``TerminalDeviceError`` within
about one heartbeat lease.  The JAX package's ``tenancy`` domain guards
a plane the port does not have: its conf keys raise
(``conf.REFUSED_FAILURE_DOMAINS`` names its ROADMAP item).  ``execute``
counts ``hash_pairs`` dispatches, the port's one kernel; the JAX
package counts every jitted kernel.

Three pieces, all conf-driven:

* ``INJECTOR`` — independently armable injectors, one per domain
  (``spark.rapids.tpu.test.inject.<domain>.{at,transientCount}``), with
  the JAX package's firing model.
* ``RetryPolicy`` — ``retry.maxAttempts`` attempts with exponential
  backoff (``retry.backoffBaseMs``..``retry.backoffMaxMs``) and seeded
  jitter (``retry.jitterSeed``), spending from a per-query retry budget
  (``retry.budgetPerQuery``).  Only injected faults retry, and real IO
  errors in the IO domains; any other exception (a failed ``nvcc``, a
  CUDA launch error) propagates at once, untouched.
* per-op **circuit breakers** — when an injected fault exhausts its
  retries in a degradable domain, the op's breaker trips and the step
  re-runs on its plain path on the same device
  (``retry.hostDegrade.enabled``); later calls of the op inside the
  query go straight there.  The rest raise a domain-tagged
  ``TerminalDeviceError``.

Per-query state (budget, breakers, records) belongs to the query whose
cancel token the calling thread carries (``runtime/cancel.py``: the
query thread and every pump task it binds), so concurrent queries never
share it; a call outside any query uses the process-level ``_STATE``.
The process-cumulative counts are the JAX package's registry counters
(``tpuq_retry_total`` and the rest; ``counters_snapshot`` reads them);
retries and tripped breakers also land in the flight recorder and the
health ring, as in the JAX package.
"""

from __future__ import annotations

import random
import threading
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.runtime import cancel, lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

DOMAINS: Tuple[str, ...] = C.FAILURE_DOMAINS

# IO-backed domains also retry real filesystem faults, not only
# injected ones (a flaky spill dir, a vanished shuffle file)
_IO_RETRYABLE = (OSError, EOFError, zipfile.BadZipFile)
_IO_DOMAINS = frozenset(
    {"spill_write", "spill_read", "shuffle_ser", "shuffle_exchange"})

_TM_RETRY = TM.REGISTRY.labeled_counter(
    "tpuq_retry_total",
    "retries performed by the unified retry policy, per failure domain")
_TM_INJECTED = TM.REGISTRY.labeled_counter(
    "tpuq_faults_injected_total",
    "fault-injector fires, per failure domain")
_TM_EXHAUSTED = TM.REGISTRY.counter(
    "tpuq_retry_exhausted_total",
    "device/IO steps whose retries were exhausted (incl. terminal "
    "faults, which exhaust immediately)")
_TM_BREAKER = TM.REGISTRY.counter(
    "tpuq_breaker_trips_total",
    "per-op circuit breakers tripped by retry exhaustion")
_TM_DEGRADED = TM.REGISTRY.counter(
    "tpuq_host_degraded_ops_total",
    "op executions served by the host degradation path")


class InjectedDeviceError(RuntimeError):
    """A fault-injected device/IO error (any failure domain)."""

    def __init__(self, where: str, nth: int, transient: bool):
        super().__init__(
            f"injected {where} error at call #{nth} "
            f"({'transient' if transient else 'terminal'})")
        self.where = where
        self.transient = transient

    @property
    def domain(self) -> str:
        return self.where


class TerminalDeviceError(RuntimeError):
    """A failure domain gave up: retries exhausted (or the fault was
    terminal) and no degradation applied.  Tagged with the domain, so
    that the caller sees which boundary failed — a bare
    ``InjectedDeviceError`` never leaves the engine."""

    def __init__(self, domain: str, cause: BaseException,
                 attempts: int = 1):
        super().__init__(
            f"{domain} failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")
        self.domain = domain
        self.cause = cause
        self.attempts = attempts

    @property
    def transient(self) -> bool:
        """True when the underlying fault was transient (retries were
        exhausted on a fault that kept firing)."""
        return bool(getattr(self.cause, "transient", False))

    @property
    def peer(self):
        """The dead executor's pid for ``peer_loss`` failures (from the
        underlying ``RendezvousAborted``); None elsewhere."""
        return getattr(self.cause, "peer", None)


class _DomainState:
    __slots__ = ("at", "budget", "count", "fired")

    def __init__(self, at: int = -1, budget: int = 0):
        self.at = int(at)
        self.budget = int(budget)
        self.count = 0
        self.fired = 0


class FaultInjector:
    """Registry of per-domain injectors.

    Firing model per domain: once its call count reaches the configured
    N it starts firing.  With a transient budget of 0 the fire is
    terminal and the domain disarms.  With a budget K > 0, K consecutive
    calls fire transient and then the domain disarms.  ``armed`` is a
    plain attribute recomputed under the lock on every change, so the
    disarmed fast path is one attribute read.
    """

    def __init__(self):
        self._lock = lockdep.tracked_lock(
            "runtime.resilience.FaultInjector")
        self.armed = False
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._config: Optional[tuple] = None
            self._domains: Dict[str, _DomainState] = {
                d: _DomainState() for d in DOMAINS}
            self.armed = False

    def configure(self, domains: Dict[str, Tuple[int, int]]) -> None:
        """Arm from {domain: (at, transient_budget)}; unlisted domains
        disarm.  Call counts restart at zero."""
        for d in domains:
            if d in C.REFUSED_FAILURE_DOMAINS:
                raise ValueError(C.refused_domain_message(d))
            if d not in DOMAINS:
                raise ValueError(f"unknown failure domain {d!r}; "
                                 f"expected one of {DOMAINS}")
        with self._lock:
            self._config = tuple(sorted(
                (d, int(at), int(b)) for d, (at, b) in domains.items()))
            self._domains = {d: _DomainState() for d in DOMAINS}
            for d, (at, budget) in domains.items():
                self._domains[d] = _DomainState(at, budget)
            self._recompute_armed()

    def configure_legacy(self, exec_at: int, transfer_at: int,
                         transient_count: int) -> None:
        """The original two-chokepoint signature (execute/transfer with
        a shared transient budget)."""
        self.configure({"execute": (exec_at, transient_count),
                        "transfer": (transfer_at, transient_count)})

    def _recompute_armed(self) -> None:
        # callers hold self._lock
        self.armed = any(s.at >= 0 for s in self._domains.values())

    def on(self, domain: str) -> None:
        """The chokepoint: count this call and fire if configured."""
        if not self.armed:
            return
        with self._lock:
            s = self._domains[domain]
            if s.at < 0:
                return
            s.count += 1
            if s.count < s.at:
                return
            transient = s.fired < s.budget
            if transient:
                s.fired += 1
                if s.fired >= s.budget:
                    s.at = -1  # budget spent: later calls pass
            else:
                s.at = -1  # terminal
            self._recompute_armed()
            n = s.count
        _TM_INJECTED.inc(domain)
        raise InjectedDeviceError(domain, n, transient)


INJECTOR = FaultInjector()


def configure_from_conf(conf) -> None:
    """Arm the injector and refresh the retry policy from a session
    conf.  Injection reconfigures only when the requested config
    changes (or an identical one is fully spent): a conf with every
    injection key at its default never touches the injector, so a clean
    session cannot disarm another session's armed injection."""
    configure_policy(conf)
    legacy_ex = int(conf.get(C.INJECT_EXECUTE_AT))
    legacy_tr = int(conf.get(C.INJECT_TRANSFER_AT))
    legacy_tc = int(conf.get(C.INJECT_TRANSIENT_COUNT))
    requested: Dict[str, Tuple[int, int]] = {}
    for d in DOMAINS:
        at = int(conf.get(C.INJECT_DOMAIN_AT[d]))
        budget = int(conf.get(C.INJECT_DOMAIN_TRANSIENT[d]))
        # the legacy execute/transfer keys map onto their domains unless
        # the domain key is set explicitly
        if at < 0 and d == "execute" and legacy_ex >= 0:
            at, budget = legacy_ex, legacy_tc
        if at < 0 and d == "transfer" and legacy_tr >= 0:
            at, budget = legacy_tr, legacy_tc
        if at >= 0:
            requested[d] = (at, budget)
    if not requested:
        return
    config_token = tuple(sorted(
        (d, at, b) for d, (at, b) in requested.items()))
    # never while a domain of the current config is still armed, which
    # would reset another in-flight query's injection pattern
    if INJECTOR._config != config_token or not INJECTOR.armed:
        INJECTOR.configure(requested)


# ---------------------------------------------------------------------------
# per-query state (budget, breakers, degradations)
# ---------------------------------------------------------------------------

class _QueryState:
    """One query's resilience scope, shared by all its pump tasks: the
    retry budget, tripped breakers and degradation records."""

    def __init__(self, query_id: Optional[int] = None):
        self.lock = lockdep.tracked_lock("runtime.resilience._QueryState")
        self.query_id = query_id
        self.retries_used = 0
        self.breakers: set = set()
        self.degraded_ops: List[dict] = []
        self.retries_by_domain: Dict[str, int] = {}
        self.exhausted = 0


# calls outside any query scope (direct calls to the spill tier, say)
_STATE = _QueryState()
_QUERIES: Dict[int, _QueryState] = {}
_QUERIES_LOCK = lockdep.tracked_lock("runtime.resilience._QUERIES_LOCK")


def _state() -> _QueryState:
    """The calling thread's query state (through its cancel token), or
    the process-level one outside any query."""
    tok = cancel.current()
    if tok is not None and tok.query_id is not None:
        st = _QUERIES.get(tok.query_id)
        if st is not None:
            return st
    return _STATE


def begin_query(query_id: int) -> Optional[_QueryState]:
    """Open the query's resilience scope, before its cancel scope.  A
    nested execution on a thread already inside a query joins that
    query's scope and gets None."""
    tok = cancel.bound()
    with _QUERIES_LOCK:
        if tok is not None and tok.query_id in _QUERIES:
            return None
        st = _QUERIES[query_id] = _QueryState(query_id)
    return st


def finish_query(scope: Optional[_QueryState]) -> Optional[dict]:
    """Close a scope opened by ``begin_query``; returns the query's
    resilience record (None for a joiner, or when nothing happened)."""
    if scope is None:
        return None
    with _QUERIES_LOCK:
        if _QUERIES.get(scope.query_id) is scope:
            del _QUERIES[scope.query_id]
    with scope.lock:
        out = {
            "retries": dict(scope.retries_by_domain),
            "retries_total": scope.retries_used,
            "retry_exhausted": scope.exhausted,
            "breaker_trips": len(scope.breakers),
            "degraded_ops": list(scope.degraded_ops),
        }
    if not (out["retries"] or out["retry_exhausted"]
            or out["degraded_ops"]):
        return None
    return out


def open_queries() -> List[int]:
    """Query ids with an open resilience scope."""
    with _QUERIES_LOCK:
        return sorted(_QUERIES)


class RetryPolicy:
    """Conf-driven retry contract every failure domain shares."""

    def __init__(self, max_attempts: int = 8,
                 backoff_base_ms: float = 5.0,
                 backoff_max_ms: float = 1000.0,
                 jitter_seed: int = 0,
                 budget_per_query: int = 64,
                 host_degrade: bool = True):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.jitter_seed = int(jitter_seed)
        self.budget_per_query = int(budget_per_query)
        self.host_degrade = bool(host_degrade)

    def _token(self) -> tuple:
        return (self.max_attempts, self.backoff_base_ms,
                self.backoff_max_ms, self.jitter_seed,
                self.budget_per_query, self.host_degrade)

    def backoff_s(self, domain: str, attempt: int) -> float:
        """Exponential backoff with deterministic seeded jitter: a pure
        function of (seed, domain, attempt)."""
        if self.backoff_base_ms <= 0:
            return 0.0
        base = min(self.backoff_base_ms * (2 ** (attempt - 1)),
                   self.backoff_max_ms)
        rnd = random.Random(f"{self.jitter_seed}:{domain}:{attempt}")
        return base * (0.5 + 0.5 * rnd.random()) / 1000.0

    def _retryable(self, domain: str, exc: BaseException) -> bool:
        if isinstance(exc, InjectedDeviceError):
            return True
        if domain in _IO_DOMAINS and isinstance(exc, _IO_RETRYABLE):
            return True
        # a corrupt .npz payload surfaces from np.load (or the CRC
        # check) as ValueError — still a spill-tier IO fault
        if domain == "spill_read" and isinstance(exc, ValueError):
            return True
        # only the abort/timeout family of rendezvous failures retries
        # (epoch re-entry); protocol errors and dead peers never do
        if (domain == "rendezvous"
                and getattr(exc, "rendezvous_retryable", False)):
            return True
        return False

    def _budget_left(self, st: _QueryState) -> bool:
        if self.budget_per_query <= 0 or st is _STATE:
            return True  # the budget is a per-query notion
        with st.lock:
            return st.retries_used < self.budget_per_query

    def run(self, domain: str, fn: Callable, *,
            op: Optional[str] = None,
            degrade: Optional[Callable] = None):
        """Run one device/IO step under the policy.

        ``fn`` performs the step (firing the domain's chokepoint itself,
        so that retries meet the injector again).  ``degrade``, when
        given and enabled, is the plain path taken on exhaustion; its
        use is recorded as a degraded op.  Without it, exhaustion raises
        a domain-tagged ``TerminalDeviceError``."""
        op_key = (domain, op or domain)
        if degrade is not None and breaker_open(op_key):
            _TM_DEGRADED.inc()
            return degrade()
        attempt = 0
        while True:
            attempt += 1
            cancel.check()
            try:
                return fn()
            except BaseException as e:
                if not self._retryable(domain, e):
                    raise
                transient = bool(getattr(e, "transient", True))
                if (transient and attempt < self.max_attempts
                        and self._budget_left(_state())):
                    note_retry(domain)
                    delay = self.backoff_s(domain, attempt)
                    if delay > 0:
                        cancel.sleep(delay)
                    continue
                note_exhausted()
                if degrade is not None and self.host_degrade:
                    _trip_breaker(op_key, domain, op, e)
                    _TM_DEGRADED.inc()
                    return degrade()
                raise TerminalDeviceError(domain, e, attempt) from e


_policy = RetryPolicy()
_policy_lock = lockdep.tracked_lock("runtime.resilience._policy_lock")


def get_policy() -> RetryPolicy:
    return _policy


def configure_policy(conf) -> RetryPolicy:
    """Refresh the process policy from a session conf (last writer
    wins, as for the memory arbiter)."""
    global _policy
    cfg = RetryPolicy(
        max_attempts=conf.get(C.RETRY_MAX),
        backoff_base_ms=conf.get(C.RETRY_BACKOFF_BASE_MS),
        backoff_max_ms=conf.get(C.RETRY_BACKOFF_MAX_MS),
        jitter_seed=conf.get(C.RETRY_JITTER_SEED),
        budget_per_query=conf.get(C.RETRY_BUDGET_PER_QUERY),
        host_degrade=conf.get(C.RETRY_HOST_DEGRADE),
    )
    with _policy_lock:
        if cfg._token() != _policy._token():
            _policy = cfg
    return _policy


def active() -> bool:
    """Hot-path check: anything armed, or a breaker open in the calling
    thread's query?  The chokepoints wrap themselves in the policy only
    when this is True."""
    return INJECTOR.armed or bool(_state().breakers)


def note_retry(domain: str) -> None:
    """Count one retry, process-wide and against the query's budget;
    also what ``with_retry`` (the OOM rollback) calls, so every retry in
    the engine lands here."""
    _TM_RETRY.inc(domain)
    # flight recorder: a retry burst right before a timeout is the
    # evidence the black box exists to keep
    from spark_rapids_tpu_torch.runtime import attribution
    attribution.record_event("retry", {"domain": domain})
    st = _state()
    with st.lock:
        st.retries_used += 1
        st.retries_by_domain[domain] = (
            st.retries_by_domain.get(domain, 0) + 1)


def note_exhausted() -> None:
    _TM_EXHAUSTED.inc()
    st = _state()
    with st.lock:
        st.exhausted += 1


def breaker_open(op_key: tuple) -> bool:
    st = _state()
    with st.lock:
        return op_key in st.breakers


def _trip_breaker(op_key: tuple, domain: str, op: Optional[str],
                  cause: BaseException) -> None:
    rec = {"domain": domain, "op": op or domain,
           "cause": f"{type(cause).__name__}: {cause}"}
    st = _state()
    with st.lock:
        fresh = op_key not in st.breakers
        if fresh:
            st.breakers.add(op_key)
        st.degraded_ops.append(rec)
    if fresh:
        _TM_BREAKER.inc()
    TM.REGISTRY.record_health({
        "severity": "WARN", "check": "host_degraded", "value": 1,
        "threshold": 0, "query_id": st.query_id,
        "detail": (f"{domain} op {rec['op']!r} degraded to the host "
                   f"path after retry exhaustion ({rec['cause']})")})


def run_guarded(domain: str, fn: Callable, *, op: Optional[str] = None,
                degrade: Optional[Callable] = None):
    """``get_policy().run(...)``."""
    return get_policy().run(domain, fn, op=op, degrade=degrade)


def counters_snapshot() -> dict:
    """Process-cumulative resilience counters."""
    return {
        "retries": _TM_RETRY.child_values(),
        "faults_injected": _TM_INJECTED.child_values(),
        "retry_exhausted": _TM_EXHAUSTED.value,
        "breaker_trips": _TM_BREAKER.value,
        "host_degraded_ops": _TM_DEGRADED.value,
    }


def retry_device_call(fn, *args, max_attempts: Optional[int] = None,
                      **kw):
    """The original faultinj API: run a device call retrying transient
    injected faults, attempts from the conf-driven policy
    (``spark.rapids.tpu.retry.maxAttempts``)."""
    attempts = max_attempts or get_policy().max_attempts
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kw)
        except InjectedDeviceError as e:
            if not e.transient or attempt >= attempts:
                raise
            note_retry(e.domain)
