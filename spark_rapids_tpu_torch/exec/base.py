"""Physical operator base classes.

[REF: sql-plugin/../GpuExec.scala :: GpuExec, GpuMetrics]

The counterpart of the JAX package's ``exec/base.py``: a physical plan
is a tree; ``execute(partition)`` returns an iterator of batches for
that partition (iterator chaining = operator pipelining).  ``TpuExec``
nodes pump ``DeviceBatch`` (torch tensors on the session's device);
``CpuExec`` nodes pump ``columnar/host.py::HostBatch`` (the numpy
fallback and oracle path).  Transition nodes (``exec/transitions.py``)
convert at each boundary the plan rewrite (``plan/overrides.py``)
finds.

Every subclass's ``execute`` is wrapped at class creation
(``_wrap_execute``), as in the JAX package: a device operator's output
is pumped ``spark.rapids.tpu.exec.pumpDepth`` batches ahead of its
consumer (``_prefetch_pump``, innermost) and pinned to the shape
plane's bucket (``_shape_pump``, ``runtime/shapes.py``).  A limit's
subtree is not prefetched (``no_prefetch``): the limit stops pulling
once it has its rows.  Inside a query, every operator's output (device
or host) polls the query's cancel token before each batch
(``_cancellable_pump``), so that every operator boundary is a
cancellation point.  With a stats collector active
(``spark.rapids.tpu.stats.enabled``), every yielded batch is observed
(``_stats_pump``, ``runtime/stats.py``); with a tracer active (tracing
or attribution, which is on by default), each ``next()`` becomes one
``<op>:pump`` span (``_traced_pump``, outermost), and every
``MetricTimer`` opens a span named after its operator and metric.  The
order is the JAX package's: shape, prefetch, cancel, stats, trace.
With no tracer the trace pump is left out (one attribute read).

Spans time the host: a kernel launch returns before the kernel runs,
so device time lands in the span that waits for it (a device-to-host
copy, an ``.item()``, the root's Arrow conversion).  No span
synchronizes the device.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, Iterator, Tuple

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.runtime import cancel, shapes, stats, trace

# Metric verbosity levels [REF: GpuMetrics.scala :: MetricsLevel]:
# ESSENTIAL always collected, MODERATE the default, DEBUG opt-in.
METRIC_LEVELS = ("ESSENTIAL", "MODERATE", "DEBUG")
_DEFAULT_METRIC_LEVEL = {
    "numOutputRows": "ESSENTIAL",
    "numOutputBatches": "ESSENTIAL",
    "opTime": "MODERATE",
    "transferTime": "MODERATE",
    "partitionTime": "MODERATE",
    "collectiveTime": "MODERATE",
    "semaphoreWaitTime": "MODERATE",
    "concatTime": "DEBUG",
    "fusedIntoConsumer": "DEBUG",
}


class Metric:
    """One operator metric (opTime, numOutputRows, ...).

    [REF: sql-plugin/../GpuMetrics.scala :: GpuMetric]
    """

    __slots__ = ("name", "value", "level", "_lock")

    def __init__(self, name: str, level: str = None):
        self.name = name
        self.value = 0
        self.level = level or _DEFAULT_METRIC_LEVEL.get(name, "MODERATE")
        self._lock = threading.Lock()

    def add(self, v):
        with self._lock:
            self.value += v


class MetricTimer:
    """Adds the host wall time of its ``with`` block to a Metric and,
    when a query tracer is active, opens a span (op = the owning exec,
    stage = the metric's name), so that every timer site is a trace
    range.  Device work is asynchronous: a block that enqueues kernels
    without waiting times the enqueue."""

    __slots__ = ("metric", "op", "_t0", "_tr", "_span")

    def __init__(self, metric: Metric, op: str = None):
        self.metric = metric
        self.op = op
        self._tr = None
        self._span = None

    def __enter__(self):
        if self.op is not None:
            tr = trace.current()
            if tr is not None:
                self._tr = tr
                self._span = tr.begin(self.op, self.metric.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter() - self._t0)
        if self._span is not None:
            self._tr.end(self._span)
            self._tr = self._span = None
        return False


def _traced_pump(node: "ExecNode", partition: int, it: Iterator) -> Iterator:
    """Each ``next()`` on a pump iterator becomes one span, so that
    operator time nests through the iterator chain: a child's pump span
    opens inside its consumer's on the same thread and its duration
    subtracts from the consumer's self time."""
    op = node.name
    try:
        while True:
            tr = trace.current()
            if tr is None:  # tracer closed mid-pump (a leaked iterator)
                yield from it
                return
            sp = tr.begin(op, "pump", {"partition": partition})
            try:
                batch = next(it)
            except StopIteration:
                tr.end(sp)
                return
            except BaseException:
                tr.end(sp)
                raise
            tr.end(sp)
            yield batch
    finally:
        _close(it)


def _stats_pump(st, node: "ExecNode", it: Iterator) -> Iterator:
    """Record every yielded batch on the query's OpStatsCollector: rows,
    batches and bytes out per node (``runtime/stats.py``)."""
    try:
        for batch in it:
            st.observe(node, batch)
            yield batch
    finally:
        _close(it)


def _shape_pump(node: "ExecNode", it: Iterator) -> Iterator:
    """Pin every pumped DeviceBatch to the shape plane's canonical
    bucket (runtime/shapes.py).  Pad rows are dead (sel False) and are
    recorded per node in the stats plane as ``padded_rows``."""
    try:
        for batch in it:
            batch, pad = shapes.bucket_batch(batch)
            if pad:
                st = stats.current()
                if st is not None:
                    st.node_stats(node).add_padded(pad)
            yield batch
    finally:
        _close(it)


def _prefetch_pump(it: Iterator, depth: int) -> Iterator:
    """Keep up to ``depth`` batches in flight ahead of the consumer.

    Kernel launches are asynchronous: pulling batch N+1 from the
    producer while the consumer still holds batch N queues N+1's copies
    and kernels on the stream behind N's, so that the host work of one
    batch overlaps the device work of the other.  Only the in-flight
    window is kept alive; ``spark.rapids.tpu.exec.pumpDepth`` = 1
    disables it."""
    buf: collections.deque = collections.deque()
    exhausted = False
    try:
        while True:
            while not exhausted and len(buf) < depth:
                try:
                    buf.append(next(it))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            yield buf.popleft()
    finally:
        _close(it)


def _cancellable_pump(tok, it: Iterator) -> Iterator:
    """Poll the query's CancelToken before each pumped batch; a cancel
    closes the producer before ``QueryCancelled`` leaves."""
    it = iter(it)
    try:
        while True:
            tok.check()
            try:
                batch = next(it)
            except StopIteration:
                return
            yield batch
    finally:
        _close(it)


def _close(it: Iterator) -> None:
    """Close an abandoned producer now (a scan frees what it holds),
    not when the collector finds it."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def no_prefetch_below(node: "ExecNode") -> None:
    """Pump ``node``'s subtree without prefetch: a limit's, whose
    producers must not run past the batch that completes its rows."""
    for c in node.children:
        c.no_prefetch = True
        no_prefetch_below(c)


def _wrap_execute(fn):
    @functools.wraps(fn)
    def execute(self, partition: int) -> Iterator:
        it = fn(self, partition)
        if isinstance(self, TpuExec):
            depth = kernels.current_policy().pump_depth
            if depth > 1 and not self.no_prefetch:
                # innermost: the producer runs ahead of every downstream
                # pump, so its launches queue behind the consumer's batch
                it = _prefetch_pump(it, depth)
            if shapes.current_policy().enabled:
                # downstream pumps and consumers see the bucketed batch
                it = _shape_pump(self, it)
        tok = cancel.current()
        if tok is not None:
            it = _cancellable_pump(tok, it)
        st = stats.current()
        if st is not None:
            # registered up front: a pump that yields nothing still
            # leaves a (zeroed) stats record
            st.node_stats(self)
            it = _stats_pump(st, self, it)
        if trace.current() is None:  # tracing off: no trace pump
            return it
        return _traced_pump(self, partition, it)

    execute._wrapped = True
    return execute


class ExecNode:
    """Base physical operator.

    Subclass ``execute`` methods are wrapped at class creation
    (``_wrap_execute``), so no exec opts in or out of the pump's
    planes individually."""

    # set on a limit's subtree: its pumps never run ahead of the limit
    no_prefetch = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fn = cls.__dict__.get("execute")
        if fn is not None and not getattr(fn, "_wrapped", False):
            cls.execute = _wrap_execute(fn)

    def __init__(self, schema: T.StructType, *children: "ExecNode"):
        self.schema = schema
        self._children: Tuple[ExecNode, ...] = children
        self.metrics: Dict[str, Metric] = {}
        for m in ("opTime", "numOutputRows", "numOutputBatches"):
            self.metrics[m] = Metric(m)

    @property
    def children(self) -> Tuple["ExecNode", ...]:
        return self._children

    @property
    def name(self) -> str:
        return type(self).__name__

    def metric(self, name: str) -> Metric:
        m = self.metrics.get(name)
        if m is None:
            m = self.metrics.setdefault(name, Metric(name))
        return m

    def timer(self, name: str = "opTime") -> MetricTimer:
        return MetricTimer(self.metric(name), op=self.name)

    def num_partitions(self) -> int:
        if self._children:
            return self._children[0].num_partitions()
        return 1

    def estimated_size_bytes(self):
        """Planner-side output size estimate (broadcast decisions); None
        = unknown.  A one-child operator forwards its child's estimate
        (an upper bound, like Spark's statistics)."""
        if len(self._children) == 1:
            return self._children[0].estimated_size_bytes()
        return None

    def execute(self, partition: int) -> Iterator:
        raise NotImplementedError

    def node_string(self) -> str:
        return self.name

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + ("*" if self.is_tpu else "") +
                 self.node_string()]
        for c in self._children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    @property
    def is_tpu(self) -> bool:
        return isinstance(self, TpuExec)

    def collect_metrics(self, out=None, level: str = "DEBUG"):
        """(node name, {metric: value}) for this node and its subtree,
        filtered by verbosity level (``spark.rapids.sql.metrics.level``):
        ESSENTIAL ⊂ MODERATE ⊂ DEBUG."""
        out = out if out is not None else []
        rank = METRIC_LEVELS.index(level.upper())
        out.append((self.name,
                    {k: m.value for k, m in self.metrics.items()
                     if METRIC_LEVELS.index(m.level) <= rank}))
        for c in self._children:
            c.collect_metrics(out, level)
        return out


class CpuExec(ExecNode):
    """Operator over HostBatch — the CPU fallback and oracle path."""


class TpuExec(ExecNode):
    """Operator over DeviceBatch — the accelerated path.

    [REF: GpuExec.scala :: GpuExec]
    """

    def fusion(self):
        """(pure batch -> batch fn, cache key) when this operator is a
        per-batch map that a downstream consumer may apply itself
        (filter/project, a fused region), else None.  The key carries
        everything the function computes from (the member's expressions
        and schema), so equal keys name equal functions."""
        return None


def fuse_upstream(node: "TpuExec"):
    """Walk down through fusible map operators.

    Returns (source_exec, composed_fn, cache_key): pull batches from
    ``source_exec`` and apply ``composed_fn`` inside the consumer; the
    key is the tuple of the absorbed operators' keys, top-down.  Fused
    operators get a ``fusedIntoConsumer`` metric, which says why their
    own row/time metrics stay zero.
    """
    fns = []
    keys = []
    while isinstance(node, TpuExec):
        f = node.fusion()
        if f is None:
            break
        fn, key = f
        fns.append(fn)
        keys.append(key)
        node.metric("fusedIntoConsumer").value = 1
        node = node.children[0]
    fns.reverse()

    if not fns:
        return node, (lambda b: b), ()

    def composed(batch):
        for f in fns:
            batch = f(batch)
        return batch

    return node, composed, tuple(reversed(keys))
