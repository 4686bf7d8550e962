"""FusedStageExec: one exec node, one cached callable, N operators.

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuTieredProject;
 Spark WholeStageCodegenExec]

The counterpart of the JAX package's ``exec/fused.py``.  The fusion
pass (``fusion/regions.py``) replaces a chain of fusable map operators
with one of these.  Execution composes the members' ``fusion()``
functions bottom-up into one batch -> batch function, and runs it
through the region's one cached callable (``RegionProgram``):

* on the card, one CUDA graph per region key and input shape (every
  tensor's shape and dtype, a string column's width included, and the
  batch's layout): the first batch of a shape runs the chain eagerly
  (its result is that batch's output, and it uploads the constants the
  chain reads), then the chain is captured on a side stream over static
  copies of the inputs; every later batch of that shape is copied into
  the static inputs and replayed, one ``cudaGraphLaunch`` for the whole
  chain;
* on the CPU, the plain composed chain, which is also the plain version
  the tests hold the graph against.

Because the region is ONE exec node, the pump stack (stats, cancel,
shape bucket, prefetch) runs once per region instead of once per
member.  A region is itself a pure batch -> batch map, so it exposes
``fusion()`` too, and its function is the same cached callable: an
aggregate that applies its upstream maps itself (``fuse_upstream``)
replays the region's graph once per batch.

Replay writes the graph's static outputs, which live in the graph's
private memory pool: every output that is not one of the inputs passed
through is cloned after the replay, so no batch anyone holds (the
aggregate's partials, a prefetched batch, the scan cache) is written
by a later replay.  One lock per graph orders copy-in, replay and
clone-out, and an event orders a replay after the previous one's
clone-out when the callers' streams differ.  Captures are serialized
by one process lock on one side stream per device, in
``capture_error_mode="thread_local"``: pump tasks share the query
thread's stream and may launch or read back on other threads during a
capture, which only this thread's calls may invalidate.  A graph owns
the device constants its kernels read (``runtime.device.hold_constants``
around the eager run and the capture), so no eviction from the
constants' memo frees memory a replay reads.  The graphs' private pools
and static inputs are outside the memory arbiter's budget:
``graph_pool_bytes()`` reports them, and the cache of graphs drops its
least recently used graphs beyond ``_GRAPHS_CAP`` graphs or
``_GRAPHS_BYTES_CAP`` bytes.

Fall-open: the member nodes keep their chain wiring (bottom member ->
shared source), so if the callable cannot be built, or its first batch
fails (a member that reads to the host, such as a width probe, fails
the capture), the region reverts to pumping that unfused chain —
counted in ``tpuq_fusion_fallback_total`` and flagged by the
``fusionFellOpen`` metric.  A failure after the first batch propagates.
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Iterator, List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.exec.base import TpuExec


class FusedStageExec(TpuExec):
    def __init__(self, members: Sequence[TpuExec], sigs: List[dict],
                 child: TpuExec):
        if not members:
            raise ValueError("a fused region needs at least one member")
        super().__init__(members[0].schema, child)
        self.members = list(members)  # top-down (consumer first)
        # member metadata consumed by the stats plane: each member's
        # pre-fusion plan signature/path, so profile records stay
        # diffable against unfused history (runtime/stats.py)
        self.fusion_members = list(sigs)
        self._region_key = ("fused_region",) + tuple(
            s["key"] for s in sigs)
        self._fell_open = False
        self._program = None
        self._program_lock = threading.Lock()

    def node_string(self) -> str:
        names = "+".join(
            m.name[:-4] if m.name.endswith("Exec") else m.name
            for m in self.members)
        return f"FusedStage [fused: {names}]"

    def fusion(self):
        return self.program(), self._region_key

    def _composed(self):
        # bottom-up application order: members are stored top-down
        fns = [m.fusion()[0] for m in reversed(self.members)]

        def run(batch: DeviceBatch) -> DeviceBatch:
            for f in fns:
                batch = f(batch)
            return batch

        return run

    def program(self) -> "RegionProgram":
        """The region's one cached callable (built once)."""
        with self._program_lock:
            if self._program is None:
                self._program = RegionProgram(self, self._composed())
            return self._program

    def _fall_open(self) -> None:
        from spark_rapids_tpu_torch import fusion as F
        if self._fell_open:
            return
        self._fell_open = True
        self.metric("fusionFellOpen").value = 1
        F.FALLBACKS.inc()

    def _note_capture(self, seconds: float) -> None:
        from spark_rapids_tpu_torch import fusion as F
        self.metric("regionCompileTime").add(seconds)
        F.COMPILE_SECONDS.inc(seconds)

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        fn = None
        if not self._fell_open:
            try:
                fn = self.program()
            except Exception:
                self._fall_open()
        if self._fell_open:
            yield from self.members[0].execute(partition)
            return
        first = True
        for b in self.children[0].execute(partition):
            try:
                with self.timer():
                    out = fn(b)
            except Exception:
                if not first:
                    raise  # a real mid-stream execution failure
                # nothing yielded yet: fall open to the unfused chain,
                # which re-pulls the shared source from scratch
                self._fall_open()
                yield from self.members[0].execute(partition)
                return
            first = False
            self.metric("numOutputBatches").add(1)
            yield out


# ---------------------------------------------------------------------------
# the region's cached callable
# ---------------------------------------------------------------------------

def _flatten(batch: DeviceBatch):
    """(tensors, layout): ``sel`` then each column's data, validity,
    lengths and element validity that are present."""
    tensors = [batch.sel]
    cols = []
    for c in batch.columns:
        present = []
        for t in (c.data, c.validity, c.lengths, c.evalid):
            present.append(t is not None)
            if t is not None:
                tensors.append(t)
        cols.append((c.dtype, tuple(present)))
    return tensors, (batch.schema, tuple(cols), batch.compacted)


def _unflatten(layout, tensors) -> DeviceBatch:
    schema, cols, compacted = layout
    it = iter(tensors)
    sel = next(it)
    out = []
    for dtype, present in cols:
        parts = [next(it) if p else None for p in present]
        out.append(DeviceColumn(dtype, *parts))
    return DeviceBatch(schema, tuple(out), sel, compacted=compacted)


def _signature(tensors, layout) -> tuple:
    """What a graph is specialized to: every tensor's shape and dtype
    (a string column's width among them) and the batch's layout."""
    _, cols, compacted = layout
    return (tuple((tuple(t.shape), t.dtype) for t in tensors),
            tuple((repr(c[0]), c[1]) for c in cols), compacted)


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride())


class _RegionGraph:
    """One captured graph: its static inputs, what each output is (an
    input passed through, or a graph-owned tensor cloned after each
    replay) and the output layout.  A region whose every output is an
    input passed through (a project that only reorders columns) does no
    device work: it replays nothing.  ``constants`` holds the device
    constants the captured kernels read."""

    def __init__(self, graph, static, outs, layout, pool_bytes):
        self.graph = graph
        self.static = static
        self.outs = outs  # ("in", i) or ("graph", tensor), per output
        self.layout = layout
        self.pool_bytes = pool_bytes
        self.constants = ()
        self.passthrough = all(kind == "in" for kind, _ in outs)
        if self.passthrough:
            self.static = []  # no replay ever reads them
        self.static_bytes = sum(t.numel() * t.element_size()
                                for t in self.static)
        self.lock = threading.Lock()
        self.done = None  # event after the last replay's clone-out

    def replay(self, tensors) -> DeviceBatch:
        if self.passthrough:
            return _unflatten(self.layout, [tensors[i] for _, i in self.outs])
        with self.lock:
            cur = torch.cuda.current_stream(tensors[0].device)
            if self.done is not None:
                cur.wait_event(self.done)
            for s, t in zip(self.static, tensors):
                s.copy_(t)
            self.graph.replay()
            clones = {}
            outs = []
            for kind, v in self.outs:
                if kind == "in":
                    outs.append(tensors[v])
                else:
                    got = clones.get(id(v))
                    if got is None:
                        got = clones[id(v)] = v.clone()
                    outs.append(got)
            self.done = torch.cuda.Event()
            self.done.record(cur)
        return _unflatten(self.layout, outs)


# process-wide graphs by (region key, device, input signature): equal
# region keys name equal functions, so regions of different plans share.
# Least recently used graphs go beyond _GRAPHS_CAP graphs or beyond
# _GRAPHS_BYTES_CAP bytes of pools and static inputs, memory the
# arbiter does not see (the newest graph always stays)
_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_GRAPHS_CAP = 512
_GRAPHS_BYTES_CAP = 2 << 30
_GRAPHS_BYTES = [0]
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}
_STATS = {"captures": 0, "replays": 0, "capture_failures": 0}
_STATS_LOCK = threading.Lock()


def _count(what: str) -> None:
    with _STATS_LOCK:
        _STATS[what] += 1


def graph_pool_bytes() -> dict:
    """Device bytes the cached region graphs hold outside the memory
    arbiter: the private pools' growth over each capture (reserved
    memory, so approximate under concurrent allocation) and the static
    input copies."""
    with _GRAPHS_LOCK:
        graphs = list(_GRAPHS.values())
    return {"graphs": len(graphs),
            "pool_bytes": sum(g.pool_bytes for g in graphs),
            "static_input_bytes": sum(g.static_bytes for g in graphs)}


def program_stats() -> dict:
    """Captures, replays and failed captures since the process began."""
    with _STATS_LOCK:
        return dict(_STATS)


def clear_graphs() -> None:
    """Drop every cached region graph (tests, memory pressure)."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()
        _GRAPHS_BYTES[0] = 0


def _keep(key, g: _RegionGraph) -> None:
    """File a new graph and drop the least recently used beyond the
    caps."""
    with _GRAPHS_LOCK:
        _GRAPHS[key] = g
        _GRAPHS_BYTES[0] += g.pool_bytes + g.static_bytes
        while len(_GRAPHS) > 1 and (len(_GRAPHS) > _GRAPHS_CAP
                                    or _GRAPHS_BYTES[0] > _GRAPHS_BYTES_CAP):
            _, old = _GRAPHS.popitem(last=False)
            _GRAPHS_BYTES[0] -= old.pool_bytes + old.static_bytes


def _capture(fn, tensors, layout) -> _RegionGraph:
    """Capture ``fn`` over static copies of ``tensors`` on the device's
    side stream.  Raises when ``fn`` does what a capture forbids (a read
    to the host, a copy from pageable memory)."""
    dev = tensors[0].device
    static = [torch.empty(t.shape, dtype=t.dtype, device=dev)
              for t in tensors]
    for s, t in zip(static, tensors):
        s.copy_(t)
    cur = torch.cuda.current_stream(dev)
    side = _CAPTURE_STREAMS.get(dev)
    if side is None:
        side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    reserved0 = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), warnings.catch_warnings():
        # a chain that only passes columns through captures no kernel
        warnings.filterwarnings("ignore", message=".*Graph is empty")
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(_unflatten(layout, static))
        except BaseException:
            try:
                graph.capture_end()
            except Exception:
                pass  # the capture was invalidated by the failure
            raise
        graph.capture_end()
    cur.wait_stream(side)
    out_tensors, out_layout = _flatten(out)
    outs = []
    for t in out_tensors:
        hit = next((i for i, s in enumerate(static)
                    if _same_tensor(t, s)), None)
        outs.append(("in", hit) if hit is not None else ("graph", t))
    pool = max(torch.cuda.memory_reserved(dev) - reserved0, 0)
    return _RegionGraph(graph, static, outs, out_layout, pool)


class RegionProgram:
    """A region's cached callable: the composed chain on CPU tensors, a
    CUDA graph per input shape on the card."""

    def __init__(self, region: FusedStageExec, fn):
        self._region = region
        self._fn = fn
        self._lock = threading.Lock()
        self._started = False

    def __call__(self, batch: DeviceBatch) -> DeviceBatch:
        if batch.device.type != "cuda" or self._region._fell_open:
            return self._fn(batch)
        with self._lock:
            first, self._started = not self._started, True
        tensors, layout = _flatten(batch)
        key = (self._region._region_key, batch.device,
               _signature(tensors, layout))
        with _GRAPHS_LOCK:
            g = _GRAPHS.get(key)
            if g is not None:
                _GRAPHS.move_to_end(key)
        if g is not None:
            _count("replays")
            return g.replay(tensors)
        # the first batch of this shape: its eager result is its output,
        # and the eager run uploads every constant the capture reads,
        # which the graph then holds
        from spark_rapids_tpu_torch.runtime import trace
        from spark_rapids_tpu_torch.runtime.device import hold_constants
        with hold_constants() as held:
            out = self._fn(batch)
            with _CAPTURE_LOCK:
                with _GRAPHS_LOCK:
                    if key in _GRAPHS:
                        return out  # another thread captured it meanwhile
                t0 = time.perf_counter()
                try:
                    with trace.span("Kernel", "compile"):
                        g = _capture(self._fn, tensors, layout)
                except Exception:
                    _count("capture_failures")
                    if not first:
                        raise
                    # the chain reads to the host: run it unfused from now
                    self._region._fall_open()
                    return out
                g.constants = tuple(held.values())
                self._region._note_capture(time.perf_counter() - t0)
                _count("captures")
                _keep(key, g)
        return out
