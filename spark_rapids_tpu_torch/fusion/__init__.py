"""Whole-stage fusion plane: operator chains as one cached callable.

[REF: sql-plugin/../basicPhysicalOperators.scala :: GpuTieredProject;
 Spark WholeStageCodegenExec]

The counterpart of the JAX package's ``fusion/``.  The exec layer pays
a fixed toll at every operator boundary: a pump (the stats, trace,
cancel, prefetch and shape generators), an intermediate device batch
and, on the card, one kernel launch per elementwise op.  For map-shaped
operators (project and filter chains) none of that buys anything: they
are pure batch -> batch functions.

``fuse_plan`` walks the converted plan after ``apply_overrides`` has
rewritten it, stitches maximal chains of single-child ``TpuExec`` nodes
whose ``fusion()`` hook is not None into ``FusedStageExec`` regions
(``exec/fused.py``), and leaves everything else (exchanges, joins,
aggregates, limits, UDF bridges, CPU islands) as region boundaries.
Where the JAX package compiles a region into one XLA program, the port
runs it as one cached callable per input shape: on the card a CUDA
graph captured at the first batch of that shape and replayed after, on
the CPU the plain composed chain.

Conf-gated under ``spark.rapids.tpu.fusion.{enabled,maxOpsPerRegion,
mode}``; a region whose callable cannot be built or captured on its
first batch falls open to the unfused chain (counted in
``tpuq_fusion_fallback_total``), so fusion never changes an answer,
only its launch count.  Kept deviation: capture seconds count as the
region's compile time (``tpuq_fusion_compile_seconds_total``,
``regionCompileTime``), as library builds count as compiles.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.runtime.telemetry import REGISTRY

# process-telemetry family (the JAX package's names)
REGIONS_BUILT = REGISTRY.counter(
    "tpuq_fusion_regions_built_total",
    "FusedStageExec regions stitched into plans by the fusion pass")
FALLBACKS = REGISTRY.counter(
    "tpuq_fusion_fallback_total",
    "fused regions that fell open to their unfused pump chain after a "
    "region callable failed to build or capture")
COMPILE_SECONDS = REGISTRY.counter(
    "tpuq_fusion_compile_seconds_total",
    "CUDA graph capture seconds attributed to fused regions (first "
    "batch per region key and input shape)")

from spark_rapids_tpu_torch.fusion.regions import fuse_plan  # noqa: E402

__all__ = ["fuse_plan", "REGIONS_BUILT", "FALLBACKS", "COMPILE_SECONDS"]
