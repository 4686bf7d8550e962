"""spark_rapids_tpu_torch — the PyTorch/CUDA port of ``spark_rapids_tpu``.

Same module paths and class names as the JAX package (``TpuSession``,
``DeviceColumn``, ``TpuHashAggregateExec``, ...), so each counterpart is
easy to find; inside, plain PyTorch functions on tensors with an explicit
``device``.  Entry points run on the CUDA card unless the caller asks for
``device="cpu"``.  An operator the device path lacks falls back to the
numpy CPU oracle through the plan rewrite (``plan/overrides.py``), which
reports it (``explain(True)``, ``fallback_summary()``) and, under
``spark.rapids.sql.test.enabled``, raises instead.

Unsigned 64-bit values (sort limbs, hashes) are carried as ``int64`` bit
patterns: torch has no usable uint64/uint32 arithmetic.  Before any sort
or ``<`` on such a value the top bit is flipped (``x ^ (1 << 63)``) so
signed order equals unsigned order, and every right shift is masked.

This package imports torch, numpy and pyarrow only — never jax, and
nothing of ``spark_rapids_tpu``.
"""

__version__ = "0.1.0"
