"""Adaptive query execution: shuffle-read coalescing and skew splitting.

[REF: sql-plugin shims :: GpuAQEShuffleReadExec /
 GpuCustomShuffleReaderExec, GpuQueryStagePrepOverrides]

The counterpart of the JAX package's ``exec/aqe.py``.  The reference
re-plans query stages from map-output statistics: it merges adjacent
small shuffle partitions up to the advisory size and splits skewed
ones.  Both exchanges here run their map stage at the first read, so
the same statistics (live rows per partition on the device exchange,
serialized bytes per partition on the host one) exist before the reduce
side pumps, and ``num_partitions()`` is the re-planning point — called
at planning (by the coalesce pass) it runs the map stage there:

* a run of adjacent small partitions reads as one ``[lo, hi)`` range;
* a skewed partition of a round-robin exchange reads as k
  rank-interleaved slices (a hash exchange never splits: its consumers
  rely on every key staying in one partition).

Counts the stats plane already recorded for the exchange (an earlier
materialization) are read first, and the exchange is asked only when
there are none.  Under the adaptive plane (``retarget``, an
``AdaptivePolicy``) a read over row counts replans its row target from
the bytes per row the stats plane observed leaving the exchange's input
(``adaptive/replanner.py::retarget_read_rows``), when the static schema
estimate was off.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.column import DeviceBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.runtime import stats


class TpuAQEShuffleReadExec(TpuExec):
    """Plans its output partitioning from the exchange's measured sizes.

    Works over any exchange with the shaped-read protocol:
    ``aqe_partition_stats() -> ("rows"|"bytes", sizes)``,
    ``execute_pid_range(lo, hi)``, ``execute_split(p, j, k)``.  Read
    specs: ``("range", lo, hi)`` coalesces map partitions [lo, hi);
    ``("split", p, j, k)`` is slice j of k of skewed partition p.
    """

    def __init__(self, child: TpuExec, target_bytes: int, row_bytes: int,
                 allow_split: bool = False, retarget=None):
        super().__init__(child.schema, child)
        self.target_bytes = max(int(target_bytes), 1)
        self.row_bytes = max(int(row_bytes), 1)
        # splitting scatters one map partition's rows across reads: only
        # valid when no consumer relies on key co-partitioning (a
        # round-robin repartition)
        self.allow_split = allow_split
        # AdaptivePolicy (or None): replan the row target from the
        # OBSERVED bytes/row of the exchange input
        self.retarget = retarget
        self._specs: Optional[List[tuple]] = None
        self._lock = threading.Lock()

    def node_string(self):
        spec = (f"{len(self._specs)} reads" if self._specs is not None
                else "unplanned")
        return f"TpuAQEShuffleRead [{spec}]"

    def _plan(self) -> List[tuple]:
        with self._lock:
            if self._specs is not None:
                return self._specs
            st = stats.current()
            recorded = (st.partition_counts(self.children[0])
                        if st is not None else None)
            if recorded is not None:
                # the stats plane already measured this exchange: prefer
                # it over paying for a fresh device count
                unit, sizes = recorded
            else:
                unit, sizes = self.children[0].aqe_partition_stats()
            counts = [int(c) for c in sizes]
            target = (max(self.target_bytes // self.row_bytes, 1)
                      if unit == "rows" else self.target_bytes)
            if self.retarget is not None and unit == "rows":
                # by the time counts exist the exchange input has fully
                # pumped, so the stats plane holds its observed rows and
                # bytes: replan the target from them
                obs = (st.observed(self.children[0].children[0])
                       if st is not None and self.children[0].children
                       else None)
                if obs is not None:
                    from spark_rapids_tpu_torch import adaptive as AD
                    from spark_rapids_tpu_torch.adaptive import replanner
                    planned = replanner.retarget_read_rows(
                        self.retarget, self.target_bytes,
                        self.row_bytes, obs[0], obs[1])
                    if planned is not None:
                        target, detail = planned
                        self.metric("retargetedReads").add(1)
                        AD.record_decision(self, "batch-retarget",
                                           **detail)
            specs: List[tuple] = []
            i, n = 0, len(counts)
            while i < n:
                if self.allow_split and counts[i] > 2 * target:
                    k = int(np.ceil(counts[i] / target))  # skewed
                    specs.extend(("split", i, j, k) for j in range(k))
                    self.metric("splitSkewedPartitions").add(1)
                    i += 1
                    continue
                lo, run = i, 0
                while (i < n
                       and (self.allow_split is False
                            or counts[i] <= 2 * target)
                       and (run == 0 or run + counts[i] <= target)):
                    run += counts[i]
                    i += 1
                specs.append(("range", lo, i))
            if not specs:  # an empty input still needs one partition
                specs = [("range", 0, self.children[0].num_partitions())]
            merged = sum(1 for s in specs if s[0] == "range"
                         and s[2] - s[1] > 1)
            self.metric("coalescedReads").add(merged)
            self._specs = specs
            return specs

    def num_partitions(self) -> int:
        return len(self._plan())

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        spec = self._plan()[partition]
        child = self.children[0]
        with self.timer():
            if spec[0] == "range":
                it = child.execute_pid_range(spec[1], spec[2])
            else:
                it = child.execute_split(spec[1], spec[2], spec[3])
        for b in it:
            self.metric("numOutputBatches").add(1)
            yield b
