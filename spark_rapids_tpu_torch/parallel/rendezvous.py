"""Multi-executor shuffle rendezvous — the collective/task impedance fix.

[REF: sql-plugin/../shuffle/ucx/ :: RapidsShuffleServer/Client — the
reference's executors pull shuffle blocks point-to-point, so reduce tasks
start independently; an all_to_all needs EVERY participant to enter the
same exchange, but Spark schedules executor tasks independently.]

The port's own copy of the JAX package's ``parallel/rendezvous.py``
(without its ``TenancyArbiter``, ROADMAP A.11), with the port's
lockdep-named locks:

* One **coordinator** (driver-side): a tiny TCP service holding
  per-stage registration state.  Its one primitive is
  ``allgather(stage, payload)`` — a barrier that returns every
  participant's payload.  Used per shuffle stage for shape agreement
  (row counts, string widths, validity presence → identical cell
  capacities everywhere), the partition counts, and an entry barrier;
  the rows then ride the process group's ``all_to_all_single``.
* **Executors**: ``DistributedShuffleExecutor`` wraps the executor
  context (``parallel/executor.py``: the rendezvous client and the
  ``torch.distributed`` process group) and the shuffle programs of
  ``parallel/shuffle.py``.
* **Failure policy**: every rendezvous has a deadline; the coordinator
  fails ALL waiters of an incomplete stage, so that every executor
  aborts together instead of a subset entering a collective that can
  never complete.

Coordinated fault tolerance on top of that fail-together core:

* **Liveness**: executors register under a heartbeat lease
  (``spark.rapids.tpu.rendezvous.{heartbeatMs,leaseMs}``).  A reaper
  thread declares a silent peer dead after one lease and immediately
  poisons every in-flight stage with a peer-tagged, non-transient
  abort — survivors unwind in ~one lease instead of N independent full
  stage deadlines.
* **Epochs**: stages are ``(stage, epoch)``-keyed.  A transient fault
  (coordinator restart, injected ``rendezvous`` fault, requested abort)
  makes every participant re-enter the same stage at epoch+1 through
  the shared ``RetryPolicy`` (``run_stage_epochs``).  Aborts leave
  bounded tombstones so stragglers still parked on a failed epoch get
  the abort (with a ``min_epoch`` hint) instead of a fresh deadline.
* **GC**: each stage refcounts its waiters; the last one out deletes
  the entry (the coordinator's ``_stages`` is empty after every
  completed query).

The registry's ``tpuq_rendezvous_*`` metrics and ``counters_snapshot``
are the JAX package's.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.runtime import lockdep
from spark_rapids_tpu_torch.runtime import telemetry as TM

_TM_ABORTS = TM.REGISTRY.labeled_counter(
    "tpuq_rendezvous_aborts_total",
    "Rendezvous stage aborts by reason (timeout, requested, peer_dead)",
    label="reason")
_TM_EPOCH_RETRIES = TM.REGISTRY.counter(
    "tpuq_rendezvous_epoch_retries_total",
    "Stage re-entries at a bumped epoch after a transient rendezvous "
    "fault")
_TM_HB_MISSES = TM.REGISTRY.counter(
    "tpuq_rendezvous_heartbeat_misses_total",
    "Executor heartbeats that could not reach the coordinator")
_TM_PEERS_DEAD = TM.REGISTRY.counter(
    "tpuq_rendezvous_peers_dead_total",
    "Executors declared dead by the coordinator's heartbeat lease")
_TM_STAGES = TM.REGISTRY.counter(
    "tpuq_rendezvous_stages_total",
    "Rendezvous stages completed (all participants delivered)")

_COORDS: "weakref.WeakSet[RendezvousCoordinator]" = weakref.WeakSet()
TM.REGISTRY.gauge(
    "tpuq_rendezvous_live_stages",
    "In-flight rendezvous stages across live coordinators (nonzero at "
    "rest indicates a stage leak)",
    fn=lambda: float(sum(len(c._stages) for c in list(_COORDS))))


def counters_snapshot() -> dict:
    """Rendezvous counter rollup for bench records / reports."""
    return {
        "aborts": _TM_ABORTS.child_values(),
        "epoch_retries": _TM_EPOCH_RETRIES.value,
        "heartbeat_misses": _TM_HB_MISSES.value,
        "peers_dead": _TM_PEERS_DEAD.value,
        "stages_completed": _TM_STAGES.value,
    }


def _send_msg(sock: socket.socket, obj) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("rendezvous peer closed")
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise ConnectionError("rendezvous peer closed")
        data += chunk
    return json.loads(data)


class RendezvousError(RuntimeError):
    """Base of the rendezvous failure family."""


class RendezvousTimeout(RendezvousError):
    """Stage did not assemble before the deadline (or the coordinator is
    unreachable) — slice-wide abort, retryable at the next epoch."""

    rendezvous_retryable = True


class RendezvousAborted(RendezvousError):
    """Stage was poisoned: by a peer's explicit abort (transient — retry
    at ``min_epoch``) or by the coordinator's lease reaper declaring
    ``peer`` dead (non-transient — every survivor fails together)."""

    def __init__(self, msg: str, peer: Optional[int] = None,
                 transient: bool = True, min_epoch: int = 0):
        super().__init__(msg)
        self.peer = peer
        self.transient = bool(transient)
        self.min_epoch = int(min_epoch)
        # only the transient family may re-enter the retry loop
        self.rendezvous_retryable = self.transient


class RendezvousProtocolError(RendezvousError):
    """A caller bug (duplicate registration, malformed request) — never
    retried; retrying cannot fix a protocol violation."""


class _Stage:
    def __init__(self, expected: int):
        self.expected = expected
        self.payloads: Dict[int, Any] = {}
        self.cv = lockdep.tracked_condition(
            "parallel.rendezvous._Stage.cv")
        self.failed: Optional[str] = None
        self.kind: Optional[str] = None       # timeout | aborted | peer_dead
        self.peer: Optional[int] = None
        self.transient = True
        self.waiters = 0
        self.delivered = 0

    def fail(self, kind: str, msg: str, peer: Optional[int] = None,
             transient: bool = True) -> bool:
        """First failure wins; returns True on the transition."""
        if self.failed is not None:
            return False
        self.failed, self.kind = msg, kind
        self.peer, self.transient = peer, transient
        return True


def coordinator_from_conf(conf, num_processes: int,
                          host: str = "127.0.0.1",
                          port: int = 0) -> "RendezvousCoordinator":
    """Driver-side constructor: heartbeat lease and handler socket
    timeout from ``spark.rapids.tpu.rendezvous.{leaseMs,socketTimeoutMs}``."""
    from spark_rapids_tpu_torch import conf as C
    return RendezvousCoordinator(
        num_processes, host=host, port=port,
        lease_s=float(conf.get(C.RENDEZVOUS_LEASE_MS)) / 1000.0,
        socket_timeout_s=float(
            conf.get(C.RENDEZVOUS_SOCKET_TIMEOUT_MS)) / 1000.0)


class RendezvousCoordinator:
    """Driver-side rendezvous service (the MapOutputTracker analog for
    collective entry).  Thread-per-connection TCP; message = one JSON
    request ``{op, stage, pid, payload, timeout, epoch}`` →
    ``{ok, payloads | kind, error, peer, transient, min_epoch}``.

    Ops: ``allgather`` (the barrier primitive), ``register`` (join the
    heartbeat lease; re-registering a dead pid revives it and bumps the
    generation), ``heartbeat`` (renew the lease), ``abort`` (poison one
    stage family at one epoch)."""

    _TOMB_CAP = 256

    def __init__(self, num_processes: int, host: str = "127.0.0.1",
                 port: int = 0, *, lease_s: float = 15.0,
                 socket_timeout_s: float = 10.0):
        self.num_processes = num_processes
        self.lease_s = float(lease_s)
        self.socket_timeout_s = float(socket_timeout_s)
        self._stages: Dict[Tuple[str, int], _Stage] = {}
        self._tombs: "OrderedDict[Tuple[str, int], dict]" = OrderedDict()
        self._peers: Dict[int, float] = {}    # pid -> last heartbeat
        self._dead: Dict[int, str] = {}       # pid -> why
        self._generation = 0
        self._lock = lockdep.tracked_lock(
            "parallel.rendezvous.RendezvousCoordinator._lock")
        self._halt = threading.Event()
        coord = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    # a half-open client must not pin this thread forever
                    self.request.settimeout(coord.socket_timeout_s)
                    req = _recv_msg(self.request)
                    resp = coord._handle(req)
                    _send_msg(self.request, resp)
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = "{}:{}".format(*self._server.server_address[:2])
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True,
            name="tpuq-rendezvous-reaper")
        self._reaper.start()
        _COORDS.add(self)

    # -- liveness -------------------------------------------------------

    def _reap_loop(self):
        while not self._halt.wait(max(self.lease_s / 4.0, 0.01)):
            now = time.monotonic()
            newly: List[Tuple[int, str]] = []
            live: List[Tuple[Tuple[str, int], _Stage]] = []
            with self._lock:
                for pid, seen in self._peers.items():
                    if pid in self._dead:
                        continue
                    if now - seen > self.lease_s:
                        why = (f"executor {pid} missed its heartbeat "
                               f"lease ({self.lease_s:.1f}s) — presumed "
                               "dead")
                        self._dead[pid] = why
                        newly.append((pid, why))
                if newly:
                    live = list(self._stages.items())
            for pid, why in newly:
                _TM_PEERS_DEAD.inc()
                # poison EVERY in-flight stage: survivors unwind in ~one
                # lease instead of each waiting out its own deadline
                for _, st in live:
                    with st.cv:
                        if st.fail("peer_dead", why, peer=pid,
                                   transient=False):
                            _TM_ABORTS.inc("peer_dead")
                        st.cv.notify_all()

    def _op_register(self, req) -> dict:
        pid = int(req["pid"])
        with self._lock:
            if pid in self._dead:
                # a revived executor starts a new generation; stages of
                # the old one stay poisoned/tombstoned
                del self._dead[pid]
                self._generation += 1
            self._peers[pid] = time.monotonic()
            return {"ok": True, "generation": self._generation}

    def _op_heartbeat(self, req) -> dict:
        pid = int(req["pid"])
        with self._lock:
            if pid in self._dead:
                # too late: survivors may already be unwinding on this
                # pid's death — it must re-register to rejoin
                return {"ok": False, "kind": "dead",
                        "error": self._dead[pid]}
            self._peers[pid] = time.monotonic()
            gen = self._generation
            dead = sorted(self._dead)
        return {"ok": True, "generation": gen, "dead": dead}

    # -- stage fault plumbing -------------------------------------------

    def _tomb(self, key: Tuple[str, int], kind: str, error: str,
              peer: Optional[int], transient: bool) -> bool:
        # callers hold self._lock; returns True if the tombstone is new
        if key in self._tombs:
            return False
        self._tombs[key] = {"kind": kind, "error": error, "peer": peer,
                            "transient": transient}
        while len(self._tombs) > self._TOMB_CAP:
            self._tombs.popitem(last=False)
        return True

    @staticmethod
    def _covers(prefix: str, stage: str) -> bool:
        # "stage-1" covers "stage-1" and "stage-1:counts",
        # NOT "stage-10:counts"
        return stage == prefix or stage.startswith(prefix + ":")

    def _match_tomb(self, stage: str, epoch: int) -> Optional[dict]:
        # callers hold self._lock
        for (p, e), t in self._tombs.items():
            if e == epoch and self._covers(p, stage):
                return t
        return None

    def _min_epoch(self, stage: str) -> int:
        # callers hold self._lock: the first epoch with no tombstone for
        # this stage family — the convergence hint retrying clients use
        root = stage.split(":", 1)[0]
        best = -1
        for (p, e), _ in self._tombs.items():
            if p.split(":", 1)[0] == root:
                best = max(best, e)
        return best + 1

    def _abort_resp(self, kind: str, error: str, peer: Optional[int],
                    transient: bool, min_epoch: int) -> dict:
        return {"ok": False, "kind": kind, "error": error, "peer": peer,
                "transient": transient, "min_epoch": min_epoch}

    def _op_abort(self, req) -> dict:
        prefix = str(req["prefix"])
        epoch = int(req.get("epoch", 0))
        transient = bool(req.get("transient", True))
        peer = req.get("peer")
        reason = req.get("reason") or (
            f"stage {prefix}@e{epoch} aborted by pid {req.get('pid')}")
        with self._lock:
            fresh = self._tomb((prefix, epoch), "aborted", reason, peer,
                               transient)
            live = [st for (s, e), st in self._stages.items()
                    if e == epoch and self._covers(prefix, s)]
        for st in live:
            with st.cv:
                st.fail("aborted", reason, peer=peer, transient=transient)
                st.cv.notify_all()
        if fresh:
            _TM_ABORTS.inc("requested")
        return {"ok": True}

    # -- the barrier primitive ------------------------------------------

    def _op_allgather(self, req) -> dict:
        stage = str(req["stage"])
        pid = int(req["pid"])
        epoch = int(req.get("epoch", 0))
        timeout = float(req.get("timeout", 60.0))
        key = (stage, epoch)
        with self._lock:
            if self._dead:
                dpid = sorted(self._dead)[0]
                return self._abort_resp(
                    "peer_dead", self._dead[dpid], dpid, False,
                    self._min_epoch(stage))
            tomb = self._match_tomb(stage, epoch)
            if tomb is not None:
                return self._abort_resp(
                    tomb["kind"], tomb["error"], tomb["peer"],
                    tomb["transient"], self._min_epoch(stage))
            st = self._stages.get(key)
            if st is None:
                st = _Stage(self.num_processes)
                self._stages[key] = st
        deadline = time.monotonic() + timeout
        with st.cv:
            st.waiters += 1
            try:
                if st.failed is None and pid in st.payloads:
                    # caller bug; the stage itself is unaffected
                    return {"ok": False, "kind": "protocol",
                            "error": f"pid {pid} registered twice for "
                                     f"{stage}@e{epoch}"}
                if st.failed is None:
                    st.payloads[pid] = req.get("payload")
                    if len(st.payloads) == st.expected:
                        st.cv.notify_all()
                    else:
                        while (len(st.payloads) < st.expected
                               and st.failed is None):
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                # fail EVERY waiter: nobody may enter
                                # the collective alone
                                if st.fail(
                                        "timeout",
                                        f"stage {stage}@e{epoch}: only "
                                        f"{len(st.payloads)}/"
                                        f"{st.expected} executors "
                                        "arrived before the deadline"):
                                    _TM_ABORTS.inc("timeout")
                                st.cv.notify_all()
                                break
                            st.cv.wait(timeout=min(remaining, 1.0))
                if st.failed is not None:
                    return self._abort_resp(st.kind, st.failed, st.peer,
                                            st.transient, epoch + 1)
                st.delivered += 1
                payloads = [st.payloads[i] for i in range(st.expected)]
                return {"ok": True, "payloads": payloads}
            finally:
                st.waiters -= 1
                self._maybe_gc(key, st)

    def _maybe_gc(self, key: Tuple[str, int], st: _Stage) -> None:
        # callers hold st.cv; last waiter out deletes the stage —
        # failed stages leave a tombstone so stragglers get the abort
        done = st.failed is not None or st.delivered >= st.expected
        if st.waiters > 0 or not done:
            return
        with self._lock:
            if self._stages.pop(key, None) is None:
                return
            if st.failed is not None:
                self._tomb(key, st.kind or "aborted", st.failed,
                           st.peer, st.transient)
        if st.failed is None:
            _TM_STAGES.inc()

    def _handle(self, req) -> dict:
        op = req.get("op", "allgather")
        if op == "allgather":
            return self._op_allgather(req)
        if op == "register":
            return self._op_register(req)
        if op == "heartbeat":
            return self._op_heartbeat(req)
        if op == "abort":
            return self._op_abort(req)
        return {"ok": False, "kind": "protocol",
                "error": f"unknown rendezvous op {op!r}"}

    def shutdown(self):
        self._halt.set()
        self._server.shutdown()
        self._server.server_close()


class RendezvousClient:
    """One executor's handle on the coordinator.

    ``default_timeout`` (conf: ``spark.rapids.tpu.rendezvous.timeoutMs``)
    applies wherever a call site passes ``timeout=None``.  A client that
    ``start_heartbeat``s registers under the coordinator's lease and
    renews it from a daemon thread; ``simulate_death`` (the ``peer_loss``
    chaos hook) silences the heartbeat so the lease expires for real."""

    def __init__(self, address: str, pid: int,
                 default_timeout: float = 60.0):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.pid = pid
        self.default_timeout = float(default_timeout)
        self.dead = False
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_halt = threading.Event()

    def _request(self, obj, io_timeout: float):
        with socket.create_connection((self.host, self.port),
                                      timeout=io_timeout) as sock:
            sock.settimeout(io_timeout)
            _send_msg(sock, obj)
            return _recv_msg(sock)

    # -- liveness -------------------------------------------------------

    def register(self, timeout: float = 5.0) -> int:
        try:
            resp = self._request({"op": "register", "pid": self.pid},
                                 timeout)
        except OSError as e:
            raise RendezvousTimeout(
                f"pid {self.pid}: cannot reach coordinator to register: "
                f"{e}") from e
        if not resp.get("ok"):
            raise RendezvousProtocolError(
                resp.get("error", "register failed"))
        return int(resp.get("generation", 0))

    def start_heartbeat(self, period_s: float) -> None:
        """Register, then renew the lease every ``period_s`` (<= 0:
        register only — no liveness tracking)."""
        self.register()
        if period_s <= 0 or self._hb_thread is not None:
            return
        self._hb_halt.clear()
        t = threading.Thread(
            target=self._hb_loop, args=(float(period_s),), daemon=True,
            name=f"tpuq-rendezvous-heartbeat-{self.pid}")
        self._hb_thread = t
        t.start()

    def _hb_loop(self, period_s: float) -> None:
        while not self._hb_halt.wait(period_s):
            try:
                self._request({"op": "heartbeat", "pid": self.pid}, 5.0)
            except OSError:
                _TM_HB_MISSES.inc()

    def stop_heartbeat(self) -> None:
        self._hb_halt.set()
        t, self._hb_thread = self._hb_thread, None
        if t is not None:
            t.join(timeout=2.0)

    def simulate_death(self) -> None:
        """peer_loss chaos hook: go silent and let the lease expire."""
        self.dead = True
        self.stop_heartbeat()

    # -- the barrier primitive ------------------------------------------

    def allgather(self, stage_id: str, payload=None,
                  timeout: Optional[float] = None,
                  epoch: int = 0) -> List[Any]:
        from spark_rapids_tpu_torch.runtime import cancel
        from spark_rapids_tpu_torch.runtime import resilience as R
        cancel.check()  # don't enter a barrier the query already left
        R.INJECTOR.on("rendezvous")
        if self.dead:
            raise RendezvousAborted(
                f"pid {self.pid} is simulated-dead", peer=self.pid,
                transient=False)
        timeout = (self.default_timeout if timeout is None
                   else float(timeout))
        try:
            resp = self._request(
                {"op": "allgather", "stage": stage_id, "pid": self.pid,
                 "payload": payload, "timeout": timeout, "epoch": epoch},
                timeout + 10)
        except OSError as e:
            raise RendezvousTimeout(
                f"stage {stage_id}@e{epoch}: coordinator unreachable: "
                f"{e}") from e
        if resp.get("ok"):
            return resp["payloads"]
        kind = resp.get("kind", "timeout")
        err = resp.get("error", "rendezvous failed")
        if kind == "protocol":
            raise RendezvousProtocolError(err)
        if kind == "timeout":
            raise RendezvousTimeout(err)
        raise RendezvousAborted(
            err, peer=resp.get("peer"),
            transient=bool(resp.get("transient", True)),
            min_epoch=int(resp.get("min_epoch", 0)))

    def barrier(self, stage_id: str, timeout: Optional[float] = None,
                epoch: int = 0) -> None:
        self.allgather(stage_id, None, timeout, epoch=epoch)

    def abort(self, stage_id: str, epoch: int, reason: str,
              transient: bool = True, peer: Optional[int] = None) -> None:
        """Best-effort stage poison (a dead coordinator cannot deliver
        aborts anyway — peers then fall back to their own deadlines)."""
        try:
            self._request(
                {"op": "abort", "prefix": stage_id, "epoch": epoch,
                 "pid": self.pid, "reason": reason,
                 "transient": transient, "peer": peer}, 5.0)
        except OSError:
            pass


def run_stage_epochs(client: RendezvousClient, stage_id: str,
                     attempt_fn: Callable[[int], Any], *,
                     policy=None, token=None) -> Any:
    """Run ``attempt_fn(epoch)`` under the shared ``RetryPolicy`` with
    epoch bumping — the distributed analog of ``RetryPolicy.run``.

    Every transient rendezvous fault (deadline, coordinator restart,
    peer-requested abort, injected ``rendezvous`` fault) aborts the
    current epoch for everyone — so peers stop waiting — and re-enters
    at epoch+1 (or the coordinator's ``min_epoch`` hint, so restarted
    clients converge instead of leapfrogging).  A confirmed-dead peer
    surfaces as a peer-tagged ``TerminalDeviceError('peer_loss')`` on
    every survivor; a ``peer_loss`` injection on THIS client simulates
    the death itself.

    ``token`` is this participant's CancelToken (defaults to the active
    query's).  A cancel fast-aborts the stage for EVERYONE — the
    cancelled participant poisons the epoch non-transiently (tagged
    with its own pid, so survivors fail like they would on a dead peer)
    and raises ``QueryCancelled`` instead of re-entering."""
    from spark_rapids_tpu_torch.runtime import cancel as _cancel
    from spark_rapids_tpu_torch.runtime import resilience as R

    pol = policy if policy is not None else R.get_policy()
    tok = token if token is not None else _cancel.current()
    state = {"epoch": 0}

    def _cancel_abort() -> None:
        # runs on the cancel thread, waking peers (and this
        # participant) out of a parked allgather; the coordinator's
        # tombstone is first-wins, so a repeated abort is harmless
        client.abort(
            stage_id, state["epoch"],
            f"pid {client.pid} cancelled during {stage_id}",
            transient=False, peer=client.pid)

    def _advance(min_epoch: int, why: str) -> None:
        nxt = max(state["epoch"] + 1, min_epoch)
        _TM_EPOCH_RETRIES.inc()
        client.abort(stage_id, state["epoch"],
                     f"pid {client.pid} retrying {stage_id} at epoch "
                     f"{nxt}: {why}")
        state["epoch"] = nxt

    def attempt():
        epoch = state["epoch"]
        if tok is not None and tok.cancelled():
            _cancel_abort()
            tok.check()  # raises QueryCancelled
        try:
            R.INJECTOR.on("peer_loss")
        except R.InjectedDeviceError as e:
            client.simulate_death()
            raise R.TerminalDeviceError("peer_loss", e) from e
        unhook = tok.on_cancel(_cancel_abort) if tok is not None else None
        try:
            return attempt_fn(epoch)
        except RendezvousAborted as e:
            if tok is not None and tok.cancelled():
                tok.check()  # our own cancel-abort came back around
            if not e.transient:
                dom = "peer_loss" if e.peer is not None else "rendezvous"
                raise R.TerminalDeviceError(dom, e) from e
            _advance(e.min_epoch, str(e))
            raise
        except RendezvousTimeout as e:
            if tok is not None and tok.cancelled():
                tok.check()
            _advance(0, str(e))
            raise
        except R.InjectedDeviceError as e:
            if getattr(e, "where", "") == "rendezvous":
                if e.transient:
                    _advance(0, str(e))
                else:
                    # fail together: peers must not wait out their full
                    # deadline on a fault that will never clear
                    client.abort(
                        stage_id, state["epoch"],
                        f"terminal rendezvous fault on pid "
                        f"{client.pid}: {e}", transient=False)
            raise
        except _cancel.QueryCancelled:
            # a nested cancellation point fired mid-stage: poison the
            # epoch peer-tagged, like a dead peer — survivors fail
            # together instead of waiting out their deadline
            _cancel_abort()
            raise
        except BaseException as e:
            # non-rendezvous failure mid-stage (compile error, local
            # crash): poison the epoch so peers fail now instead of
            # waiting out their full deadline on a stage that can no
            # longer complete
            client.abort(stage_id, state["epoch"],
                         f"pid {client.pid} failed mid-stage: {e}",
                         transient=False)
            raise
        finally:
            if unhook is not None:
                unhook()

    return pol.run("rendezvous", attempt, op=stage_id)


class DistributedShuffleExecutor:
    """One executor process of a multi-process shuffle slice.

    Joins the process group (``torch.distributed``, through the
    executor context) and runs rendezvous-coordinated collective
    shuffle stages with the SAME programs the engine's multi-executor
    ICI exchange uses."""

    def __init__(self, coordinator_addr: str, rendezvous_addr: str,
                 process_id: int, num_processes: int, *,
                 device="cpu", local_ranks: int = 1,
                 timeout: float = 60.0, heartbeat_s: float = 0.0):
        from spark_rapids_tpu_torch.parallel.executor import ExecutorContext
        self.ctx = ExecutorContext(
            process_id, num_processes, coordinator_addr, rendezvous_addr,
            timeout, heartbeat_s, device=device, local_ranks=local_ranks)
        self.client = self.ctx.client
        self.process_id = process_id
        self.num_processes = num_processes
        self.mesh = self.ctx.mesh

    @property
    def nparts(self) -> int:
        return self.mesh.size

    def shuffle_stage(self, stage_id: str, local_shards, keys,
                      timeout: Optional[float] = None):
        """Run one collective shuffle stage.

        ``local_shards``: one DeviceBatch per LOCAL rank (uniform
        capacity, on this process's device).  Returns one received
        DeviceBatch per local rank (that rank's hash partition, its
        ``sel`` the receive mask).  Transient rendezvous faults re-enter
        at the next epoch; the inputs are assembled once outside the
        epoch loop, so a retried stage reruns over identical data
        (bit-identical recovery)."""
        import torch

        from spark_rapids_tpu_torch.columnar.column import (
            round_up_pow2, slice_batch)
        from spark_rapids_tpu_torch.parallel import shuffle as SH
        d = self.nparts
        pid_fn = SH.make_pid_fn(keys, d)
        local_max = 0
        for shard in local_shards:
            cnt = SH.local_partition_counts(shard, pid_fn(shard), d)
            local_max = max(local_max, int(cnt.max()))
        stacked = SH._from_leaves(local_shards[0].schema, [
            None if xs[0] is None else torch.cat(xs)
            for xs in zip(*[SH._leaves(s) for s in local_shards])])
        sharded = SH.ShardedBatch(self.mesh, local_shards[0].capacity,
                                  [stacked])

        def attempt(epoch: int):
            # shape agreement: the cell capacity must be identical in
            # every process, or the cells would not line up on the wire
            counts = self.client.allgather(
                stage_id + ":counts", local_max, timeout, epoch=epoch)
            cap = round_up_pow2(max(max(counts), 1), 8)
            self.client.barrier(stage_id + ":enter", timeout,
                                epoch=epoch)
            fn = SH.build_shuffle_program(self.mesh, keys, d, cap,
                                          transport=self.ctx.transport)
            return fn(sharded)[0], cap

        got, cap = run_stage_epochs(self.client, stage_id, attempt)
        return [slice_batch(got, j * d * cap, d * cap)
                for j in range(len(local_shards))]

    def shutdown(self) -> None:
        self.ctx.shutdown()
