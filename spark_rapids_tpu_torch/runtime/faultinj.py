"""Re-export shim over the resilience layer.

The counterpart of the JAX package's ``runtime/faultinj.py``: the
original two-chokepoint fault injector (kernel execute and the D2H
transfer) grew into ``runtime/resilience.py``'s per-domain registry
with a conf-driven retry policy and circuit breakers; this module keeps
the historical import surface (``INJECTOR``, ``InjectedDeviceError``,
``TerminalDeviceError``, ``configure_from_conf``, ``retry_device_call``).

[REF: spark-rapids-jni :: src/main/cpp/faultinj/]
"""

from __future__ import annotations

from spark_rapids_tpu_torch.runtime.resilience import (  # noqa: F401
    INJECTOR, FaultInjector, InjectedDeviceError, TerminalDeviceError,
    configure_from_conf, retry_device_call)

__all__ = ["INJECTOR", "FaultInjector", "InjectedDeviceError",
           "TerminalDeviceError", "configure_from_conf",
           "retry_device_call"]
