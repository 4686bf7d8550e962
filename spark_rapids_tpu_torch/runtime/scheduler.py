"""Query scheduler — for now only ``device_hold``.

The counterpart of the JAX package's ``runtime/scheduler.py``.  Its
``device_hold`` is the one sanctioned way to take a permit of the
device semaphore (``runtime/semaphore.py``): every device-admission
hold goes through here, so that admission control and the scheduler's
pressure signals see the same traffic.  The rest of the module (the
``QueryScheduler`` with its tenants, run slots, shedding and
preemption) comes with ROADMAP A.11.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from spark_rapids_tpu_torch.runtime.semaphore import get_semaphore


@contextlib.contextmanager
def device_hold(conf=None, waited_out: Optional[list] = None):
    """Hold one permit of the process semaphore (sized by ``conf``) for
    the ``with`` block; the seconds spent waiting for it are appended to
    ``waited_out``."""
    sem = get_semaphore(conf)
    with sem.hold(waited_out=waited_out):
        yield sem
