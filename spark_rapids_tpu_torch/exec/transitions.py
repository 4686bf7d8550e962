"""Host/device transitions — inserted by ``plan/overrides.py`` at every
boundary between device and CPU operators of the rewritten plan.

[REF: sql-plugin/../GpuTransitionOverrides.scala; GpuRowToColumnarExec.scala,
 GpuColumnarToRowExec.scala]

The counterparts of the JAX package's ``exec/transitions.py``:
``HostToDeviceExec`` stages a CPU child's ``HostBatch``es onto the
session's device through ``host_to_device``; ``DeviceToHostExec``
yields ``HostBatch``es, so that a CPU parent (or ``toArrow`` at the
root) can consume them.  ``DeviceToHostExec`` waits for the device
before it starts its ``transferTime`` timer, so that the device-to-host
time does not absorb the queued compute of the plan below it.
"""

from __future__ import annotations

from typing import Iterator

import torch

from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, device_to_host, host_to_device)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.runtime.device import synchronize


class HostToDeviceExec(TpuExec):
    """CPU child -> device batches (the H2D admission point)."""

    def __init__(self, child: CpuExec, device: torch.device,
                 min_bucket: int = 1024):
        super().__init__(child.schema, child)
        self.device = device
        self.min_bucket = min_bucket

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        for b in self.children[0].execute(partition):
            with self.timer("transferTime"):
                tbl = H.to_arrow_table(b)
                out = host_to_device(tbl, self.device,
                                     min_bucket=self.min_bucket)
                out = DeviceBatch(self.schema, out.columns, out.sel,
                                  compacted=True)
            self.metric("numOutputRows").add(b.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out


class DeviceToHostExec(CpuExec):
    """TPU child -> host batches (D2H; compacts first)."""

    def __init__(self, child: TpuExec):
        super().__init__(child.schema, child)

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        for b in self.children[0].execute(partition):
            synchronize(b.device)
            with self.timer("transferTime"):
                tbl = device_to_host(b)
                out = H.from_arrow_table(tbl)
                out = H.HostBatch(self.schema, out.columns)
            self.metric("numOutputRows").add(out.num_rows)
            self.metric("numOutputBatches").add(1)
            yield out
