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
(``_cancellable_pump``, outermost), so that every operator boundary is
a cancellation point.  The JAX package's stats and trace pumps (A.9)
are not ported yet.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, Iterator, Tuple

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.runtime import cancel, shapes


class Metric:
    """One operator metric (opTime, numOutputRows, ...).

    [REF: sql-plugin/../GpuMetrics.scala :: GpuMetric]
    """

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, v):
        with self._lock:
            self.value += v


class MetricTimer:
    """Adds the host wall time of its ``with`` block to a Metric.  Device
    work is asynchronous: a block that enqueues kernels without waiting
    times the enqueue."""

    __slots__ = ("metric", "_t0")

    def __init__(self, metric: Metric):
        self.metric = metric

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter() - self._t0)
        return False


def _shape_pump(it: Iterator) -> Iterator:
    """Pin every pumped DeviceBatch to the shape plane's canonical
    bucket (runtime/shapes.py).  Pad rows are dead (sel False)."""
    try:
        for batch in it:
            yield shapes.bucket_batch(batch)[0]
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
                it = _shape_pump(it)
        tok = cancel.current()
        if tok is not None:
            it = _cancellable_pump(tok, it)
        return it

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
        return MetricTimer(self.metric(name))

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

    def collect_metrics(self, out=None):
        """(node name, {metric: value}) for this node and its subtree."""
        out = out if out is not None else []
        out.append((self.name,
                    {k: m.value for k, m in self.metrics.items()}))
        for c in self._children:
            c.collect_metrics(out)
        return out


class CpuExec(ExecNode):
    """Operator over HostBatch — the CPU fallback and oracle path."""


class TpuExec(ExecNode):
    """Operator over DeviceBatch — the accelerated path.

    [REF: GpuExec.scala :: GpuExec]
    """

    def fusion(self):
        """A pure batch -> batch fn when this operator is a per-batch map
        that a downstream consumer may apply itself (filter/project),
        else None."""
        return None


def fuse_upstream(node: "TpuExec"):
    """Walk down through fusible map operators.

    Returns (source_exec, composed_fn): pull batches from
    ``source_exec`` and apply ``composed_fn`` inside the consumer.
    Fused operators get a ``fusedIntoConsumer`` metric, which says why
    their own row/time metrics stay zero.
    """
    fns = []
    while isinstance(node, TpuExec):
        fn = node.fusion()
        if fn is None:
            break
        fns.append(fn)
        node.metric("fusedIntoConsumer").value = 1
        node = node.children[0]
    fns.reverse()

    def composed(batch):
        for f in fns:
            batch = f(batch)
        return batch

    return node, composed
