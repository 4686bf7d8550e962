"""Physical operator base classes.

[REF: sql-plugin/../GpuExec.scala :: GpuExec, GpuMetrics]

The counterpart of the JAX package's ``exec/base.py``: a physical plan
is a tree; ``execute(partition)`` returns an iterator of batches for
that partition (iterator chaining = operator pipelining).  ``TpuExec``
nodes pump ``DeviceBatch`` (torch tensors on the session's device);
``CpuExec`` nodes pump ``columnar/host.py::HostBatch`` (the numpy
fallback and oracle path).  Transition nodes (``exec/transitions.py``)
convert at each boundary the plan rewrite (``plan/overrides.py``)
finds.  The JAX package's trace, stats, cancel and shape planes, which
wrap every pump, are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, Tuple

from spark_rapids_tpu_torch.columnar import dtypes as T


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


class ExecNode:
    """Base physical operator."""

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
