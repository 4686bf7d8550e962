#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero and the final
result line is not printed):

1. device — torch's device name, and ``nvidia-smi``'s name and power
   limit;
2. build — compiles the hand-written CUDA kernel(s) of the port from the
   sources in this checkout (``nvcc``, ``sm_90a``) and prints the build
   seconds and ``ptxas``' registers and spills of each specialisation;
3. kernels — calls each kernel's wrapper on tensors on the card at the
   shapes TPC-H q1 and the joins of q3 and q4 give it and at edge cases
   (odd n, limbs that are not 16-byte aligned, more limbs than one
   launch takes, two row sets in one launch), and holds the result
   against the kernel's plain PyTorch version on the same inputs, bit
   for bit.  A kernel's time is the median over launches timed by CUDA
   events, each launch after a 256 MB write that evicts the L2 cache
   and puts the host ahead of the device (``ms``, cold), and again back
   to back behind a device sleep (``ms_warm``); beside them the bound
   (bytes over the card's memory rate) and the plain version's time;
4. all 22 TPC-H queries (q1, q6, q3, q4, q5, q7, q8, q10, q11, q12,
   q15, q17, q18, q19, q21, then the seven with string patterns: q2, q9,
   q13, q14, q16, q20, q22) at SF1 (6,000,000 lineitem,
   1,500,000 orders, 150,000 customer, 200,000 part, 800,000 partsupp
   and 10,000 supplier rows, 25 nations, 5 regions) through the port's
   DataFrame API on ``device="cuda"`` — the main path, one query at a
   time, every plan through the plan rewrite (``plan/overrides.py``)
   under ``spark.rapids.sql.test.enabled=true``, so that any CPU
   fallback raises (``[overrides]``: 0 fallback operators per query and
   the rewrite's host time ``plan_ms``, median of the warm runs): the
   device scan cache is cleared, and the query's first run
   (its cold wall, which pays the host-to-device transfer) has the
   kernel's launch counts set to 0 just before and read just after;
   the hash-collision fallback count must stay 0.  Each result is
   checked against an independent pyarrow computation (``ref_q*``: keys
   and counts exactly, floats within 1e-9 relative) and against the
   exact ``jnp`` rung on the card; every join must take the strategy of
   the JAX package's plan at SF1 (``check_strategies``, read from the
   joins' metrics).  ``MAIN_WARM_RUNS`` warm run(s) follow, each of
   which must read every
   scan from the cache (``transferTime`` 0) and match the reference;
   prints the cold wall and its H2D share, the median warm wall and the
   kernel's launches, and for the seven string queries the ``opTime``
   of each filter or project holding a string pattern and the
   ``transferTime`` of the scans of string columns.  q22's reference
   may be empty (its anti join can keep nobody); then the customers
   that reach its anti join must not be;
5. ``[scan cache]``: every query once more without clearing the cache,
   so that all 22 queries' tables are resident together; the memory
   arbiter's budget, ``peakReserved``, the cached bytes and entries and
   ``torch.cuda.max_memory_allocated`` — nothing may spill;
   then ``[attribution cost]``: attribution (the ledger and the flight
   recorder) is on by default, so every phase runs under the tracer; the
   22 queries once warm with ``spark.rapids.tpu.attribution.enabled=
   false`` (every scan from the cache, each equal to its reference),
   their sum beside the main phase's warm sum, and q1 and q3 three times
   each, on and off in turns, the minimum of each against the JAX
   package's bound ``on <= off x 1.05 + 0.025 s`` (printed, not failed
   on: a timing);
6. ``[spill]``: q3 twice in a fresh arbiter whose pool holds about 1.5
   of the 2^20-row lineitem batches q3 caches (at least q3's largest
   single reservation): the first run's registrations and joins spill
   the oldest entries to host, the second restores them; both equal
   q3, with spilled and restored bytes above 0;
7. ``[dict decode]``: q1, q12 and q19 cold over a lineitem whose four
   low-cardinality string columns are dictionary-encoded (indices cross
   to the card, which gathers the strings): each equals its plain run
   and the reference; their cold H2D beside the plain cold H2D;
8. ``[join variant]``: the ``JOIN_VARIANTS`` of ``utils/tpch.py`` that
   run all on the card (``q13_right``, ``q17_cond``, ``q22_cond``,
   ``q3_full``) at SF1, each
   driven as a path of its own (cache cleared, counts to 0 before its
   cold run, read after): against pyarrow's right and full outer joins
   (``ref_*``), their base queries (the same rows in the same order),
   the exact rung and their strategies (``VARIANT_STRATEGIES``; q3_full
   sub-partitions into k = 3); then ``VARIANT_WARM_RUNS`` warm runs;
9. ``[fallback]``: three plans with an operator on the CPU at SF1, each
   a path of its own (cache cleared, counts to 0 before its cold run,
   read after) under ``test.enabled`` with ``allowedNonGpu`` naming
   exactly the exec that must fall (``FALLBACK_CASES``): q1 under
   ``spark.rapids.sql.exec.Sort=false`` (4 rows cross to a CPU sort),
   q22 under ``spark.rapids.sql.expression.Substring=false`` (customer's
   project on the host, back through ``HostToDeviceExec`` and its
   TargetSize coalesce into the device joins) and ``q13_cond`` (its left
   join with a residual condition on the CPU between device scans and
   device aggregates); each against its pyarrow reference and its
   all-device run, with its fallback summary, its cold wall and one
   warm run's, and its transitions' ``transferTime``;
10. ``[oracle]``: ``utils/tpch.py::oracle_check`` on the card — bench's
   CPU-oracle loop, the 22 builders at its small scales under
   ``TPCH_SF1_CONF`` against the port's CPU session
   (``spark.rapids.sql.enabled=false``), all equal;
11. ``[partitions]``: q1, q6, q3, q13, q18 and q21 under
   ``spark.default.parallelism=8``, each a path of its own (cache
   cleared, counts to 0 before its cold run, read after): against
   pyarrow, its 1-partition run of phase 4 and that run's join
   strategies, 8 scan-cache entries per table, then 1 warm run from
   the cache; the walls beside phase 4's;
12. ``[exchange]``: q18's inner aggregate over
   ``repartition(16, "l_orderkey")`` of lineitem's three columns through
   the host shuffle (MULTITHREADED) and the in-process exchange
   (CACHE_ONLY), each with AQE on and off, each a path of its own,
   against pyarrow's ``group_by`` and beside the same aggregate without
   the repartition; with AQE off both transports' partitions on the card
   row for row, their row counts equal to this script's numpy Spark
   murmur3 pmod 16; orders (every column) round robin, 93,750 rows a
   partition and the (o_orderkey, o_comment) multiset of the input;
   customer by its string key ``c_mktsegment``, counts against the
   numpy murmur3 of the UTF-8 bytes, unsplit under AQE; the exchanges'
   ``partitionTime``, ``writeTime``, ``readTime``, ``transferTime``,
   ``bytesWritten`` and the AQE reads, and the tudo build's seconds;
13. ``[operators]``: the limits (``lineitem.limit(100000)`` and a
   filtered ``limit(1000)`` under 1 and 8 partitions, equal to the
   table's first rows; the scan batches they pulled), q1 over a union
   of two halves of lineitem, ``session.range`` of 2^27 ids summed and
   counted against the closed form, q1 over ``lineitem.sample(0.1,
   seed=42)`` under 1 and 8 partitions against this script's numpy
   murmur3 draw, a rollup of lineitem and a cube of orders against
   pyarrow per grouping set (``hash_pairs`` launched on each), and the
   out-of-core sort of 6M rows under a pool of its input's bytes (one
   out-of-core sort, at least 3 output batches, spilled bytes, rows
   equal to pyarrow's stable order and to the in-core run), each
   aggregate a path of its own; 0 fallback operators throughout;
14. ``[strings]``: the rest of the string expressions, the device regex
   engine and the string casts at SF1 under ``test.enabled`` with
   ``incompatibleOps`` and ``castStringToFloat`` on, each run a path of
   its own against this script's pyarrow reference with 0 fallback
   operators: the phone-code report over customer (a DFA ``rlike``,
   grouped by ``cast(substring(c_phone, 1, 2) as int)``), the
   part-catalogue cleanup over part (ten string expressions row for
   row, and grouped by ``regexp_extract`` and ``lower``, with the tuple
   hash of its keys timed alone), the comment search over orders
   (``rlike('special.*requests')`` selects q13's LIKE rows; the
   arbiter's ``peakReserved``), the cast round trip over lineitem (all
   6,000,000 rows survive int -> string -> long), the same catalogue and
   a float cast to string in a plain session (the JAX package's
   fallback reasons, the same rows), and each new expression alone
   against its byte bound; the DFA's state count per pattern;
15. ``[retry]``: the memory runtime under the main path, each run a
   path of its own under ``test.enabled`` against pyarrow: q3 twice
   under ``[spill]``'s pool with the host tier at one lineitem batch
   (host copies overflow to disk: spilled bytes per tier, every disk
   restore CRC-checked, the spill directory's peak file count, and no
   file left once the cache is cleared; both runs equal q3 exactly);
   q1 under a pool of 0.75 of one scan batch (the scan streams
   uncached and every partial splits its batch: ``splitRetries`` at
   least the batches); q18 with an OOM injected at its first
   aggregate reservation (read from a recording run; ``retryOOMs``);
   the aggregates' ``skippedAggPasses``, ``repartitionMerges`` and
   timers in q3, q10 and q18 at the default conf (q18's inner
   aggregate's merge repartitions); ``q3_full`` under a pool of about
   1.5 of its largest sub-partition pair, with an OOM injected at an
   aggregate reservation made while only its slices are on the card
   (the retry spills them; equal to its phase-8 run);
16. ``[pump]``: the pump's concurrency at SF1, each run a path of its
   own under ``test.enabled``: plans whose root keeps its partitions
   (lineitem's large-quantity lines, lineitem broadcast-joined with one
   brand's parts, the part-catalogue select) under 8 partitions at
   ``concurrentGpuTasks`` 1, 2 and 4 (and the first at ``pumpDepth``
   1), each against pyarrow and row for row against the run at one
   permit, the semaphore's high-water mark within the permits, its wait
   time, the cold wall and one warm wall; q1 and q18 under 8 partitions
   (one task, inline) against ``[partitions]``, cold and one warm run;
   q3 and q18 under bucketing
   off, pow2 and a forced ladder, bit for bit, with the shape plane's
   hits, misses and pad rows and bytes; and the kernel build cache: two
   processes warming q1 up into one fresh ``kernel.cacheDir`` (the
   second builds nothing), and a third after a manifest version is
   changed (it builds again);
17. ``[faults]``: the failure domains at SF1, each run a path of its
   own under ``test.enabled``: a transient fault in each of the eight
   domains (``execute`` in q3's ``hash_pairs``, ``transfer`` at q1's
   root pull, ``compile`` in a fresh build into a temporary
   ``kernel.cacheDir``, ``alloc`` at q3's first aggregate reservation,
   ``spill_write`` and ``spill_read`` in q3 over the disk tier,
   ``shuffle_ser`` and ``shuffle_exchange`` in q18's inner aggregate
   behind the host shuffle), each equal to its clean run row for row
   with retries equal to the fires and no degraded op; a terminal
   ``execute`` fault degraded (equal to q3, one breaker, the plain
   version's calls counted) and, with ``hostDegrade`` off, failed
   tagged ``execute``; a terminal ``shuffle_exchange`` fault, tagged;
   q18 cancelled from a second thread after its first launch and q3
   under a deadline of a third of its cold wall, with their latencies;
   after each failed or cancelled run no spillable, permit, spill file
   or query scope left and the next clean run equal to pyarrow; the
   ``[pump]`` catalogue at 4 permits under lockdep with
   ``raiseOnCycle`` (no violation).  The resilience counters show no
   injected fault, breaker or degraded op before the phase and move
   nowhere after it.  ``python3 chip_smoke.py --faults`` runs this
   phase alone (after the build, the kernel checks, q1, q3 and q18
   cold and ``[spill]``);
18. ``[breadth]``: the scalar and aggregate breadth at SF1, each run a
   path of its own under ``test.enabled``, against this script's numpy
   and pyarrow references: a lineitem profile by (returnflag,
   linestatus) on the gathered holistic pass (the variance family of
   three columns, ``percentile``, ``approx_percentile``, ``first``, min
   and max over strings, ``mean``) and its ``approx_count_distinct``;
   a report over every 60th order's lines (``%``, the date fields and
   arithmetic, unary minus, ``abs``, ``floor``/``ceil``/``round``, the
   math functions, ``coalesce``/``isNull``/``eqNullSafe`` over a
   ``when`` column null on part of the rows) row for row, and grouped by
   month over all rows; Spark's ``hash`` and ``xxhash64`` of
   (l_orderkey, l_comment) against this script's numpy murmur3 and
   xxhash64 (lineitem gets an ``l_comment`` at set-up: its order's
   comment and its ship instruction); ``xxhash64(l_comment)`` alone over
   6,000,000 rows against its byte bound; the report under
   ``spark.rapids.sql.expression.Remainder=false``, falling back with
   the JAX package's reason and giving the same rows.
   ``python3 chip_smoke.py --breadth`` runs this phase alone (after the
   build and the kernel checks);
19. ``[decimal]``: TPC-H q1, q6 and q18 at SF1 over ``decimal(12,2)``
   money and quantity columns (``tpch.decimal_tables``, spark-sql-perf's
   schema: decimal128 products and sums, decimal group keys, a keyless
   decimal sum), each a path of its own under ``test.enabled``, cold and
   warm, against this script's int64/pyarrow references (decimals and
   counts exactly, averages within 1e-9); then the eleven other
   builders that read a decimal column (q3, q5, q7, q8, q9, q10, q14,
   q15, q17, q19, q20) and the join variants ``q17_cond`` and
   ``q3_full``, cold and one warm run each, against the ``ref_*``
   functions over the decimal tables (decimal sums exact, the doubles
   of q8, q9, q14 and q17 within 1e-9); ``from_utc_timestamp`` and
   ``to_utc_timestamp`` to America/Los_Angeles and Asia/Kolkata over
   6,000,000 timestamps, every 100th row exactly against ``zoneinfo``;
   the decimal columns' H2D alone.  ``python3 chip_smoke.py --decimal``
   runs this phase alone (after the build and the kernel checks), then
   the kernel bit for bit at every shape the phase launched it with;
20. ``[nested]``: nested and array columns at SF1
   (``tpch.nested_tables``), each run a path of its own under
   ``test.enabled`` (only the JAX package's host operators, the
   Generate over ``split`` and the Project of ``get_json_object``, on
   the CPU), cold and one warm run, against this script's numpy,
   pyarrow and Python references: order baskets by ``collect_list``
   (lineitem order) and ``collect_set`` (ascending) over 6,000,000
   lines, exactly;
   the baskets ``posexplode``d back to part keys with ``count`` and
   ``sum(pos)``, equal to lineitem's per-part counts; a list column of
   each order's quantities (1% null elements, 1% null lists, empty
   lists) round-tripped unchanged and ``explode_outer``ed into grouped
   sums; q1 keyed by a struct, row for row q1; a filter on a struct
   field and a top-100 by the struct; a word count by ``split`` and
   ``explode`` over the part names; ``get_json_object`` of three paths
   over 150,000 JSON documents; the list column's H2D and D2H alone.
   ``python3 chip_smoke.py --nested`` runs this phase alone (after the
   build and the kernel checks), then the kernel bit for bit at every
   shape the phase launched it with;
21. ``[window]``: window functions at SF1 (``tpch.window_tables``:
   lineitem with each line's number in its order), each run a path of
   its own under ``test.enabled`` with 0 operators on the CPU, cold and
   1 warm run equal to it, against this script's numpy references
   (a stable ``np.lexsort``, segment starts, shifted reads, running
   values, ``bincount`` and ``searchsorted``): supplier ranks
   (``rank``, ``dense_rank``, ``row_number`` of revenue per supplier in
   its nation, after a join and an aggregate, top 3), revenue share (a
   whole-partition sum per part type), order gaps over 1,500,000 orders
   (``lag``/``lead`` of a date, a double and a string, ``lag`` IGNORE
   NULLS), line running totals over 6,000,000 lines (a ROWS and the
   default RANGE frame), customer trailing spend (a 90-day RANGE frame,
   ROWS frames of 5 and 4 rows), customer quartiles (``ntile``,
   ``percent_rank``, ``cume_dist``) and the top 100 orders (no
   partition); each run's walls, rows, launches, the windows'
   ``opTime`` and reservations and the arbiter's peak, and three runs'
   Window nodes alone and their sorts alone, by CUDA events.
   ``python3 chip_smoke.py --window`` runs this phase alone (after the
   build and the kernel checks), then the kernel bit for bit at every
   shape the phase launched it with;
22. ``[udf]``: python UDFs at SF1, each run a path of its own under
   ``test.enabled`` with 0 operators on the CPU, cold and 1 warm run
   equal to it, against this script's numpy references: a row
   ``F.udf`` (``o_custkey % 97``) over 1,500,000 orders through the
   arrow bridge, then compiled by the UDF compiler (no bridge node, the
   bridge run's rows); a ``pandas_udf`` over 6,000,000 lines
   (``l_extendedprice * (1 - l_discount)``) summed by the two flags,
   equal to the built-in expression and to a device UDF over torch
   tensors (no bridge node); ``mapInPandas`` over orders;
   ``applyInPandas`` over 150,000 customers by nation under
   ``spark.sql.shuffle.partitions=8``; a grouped-aggregate pandas UDF
   (the median order price per priority); each run's walls, the path
   it took (read from the plan tree) and its bridge nodes'
   ``transferTime`` and ``udfTime``.  ``python3 chip_smoke.py --udf``
   runs this phase alone (after the build and the kernel checks), then
   the kernel bit for bit at every shape the phase launched it with;
23. ``[io]``: parquet at SF1 through ``session.read`` and
   ``DataFrame.write`` (lineitem in key order as 8 files, orders as 4,
   row groups of 2^17 rows, written by pyarrow into a temporary
   directory removed at the end), each run cold under ``test.enabled``
   with 0 operators on the CPU: q1 and q6 equal to their in-memory runs
   and pyarrow (q1's launches counted), an ``l_orderkey < 600000``
   count that prunes row groups and reads two columns,
   ``input_file_name()`` grouped over the orders files (each file's row
   count), q12 with the device dictionary decode on and off (equal),
   and orders written from the card partitioned by priority and read
   back (5 partitions, counts and sums against numpy and the in-memory
   grouping); each run's wall and its scans' ``scanTime``,
   ``transferTime``, ``dictDecodedColumns`` and ``prunedRowGroups``.
   ``python3 chip_smoke.py --io`` runs this phase alone, as ``--udf``;
24. ``[lakehouse]``: the table formats at SF1, written by hand to their
   public specs into a ``tpuq-lake-*`` temporary directory removed at
   the end, each run cold under ``test.enabled`` with 0 operators on
   the CPU (the DPP subquery drains on the host, as in the JAX
   package): a Delta lineitem (8 files, on-disk and inline deletion
   vectors, a checkpoint, a removed file) under q1, q6, ``count(*)``
   and a q1 whose pushed key range prunes row groups, against pyarrow
   over the surviving rows and numpy's ``deletedRows``; an Iceberg
   orders table (identity-partitioned by priority, a deleted manifest
   entry, position deletes of every 7th order key in three files)
   under q4 and ``count(*)``; customer and nation as deflate avro
   containers under q10 (the avro decode timed apart), equal to
   ``ref_q10`` and the in-memory q10; customer written from the card
   partitioned by nation and joined to one region's nations: dynamic
   partition pruning skips the other 20 nations' files, equal to
   pyarrow and to the run with it off, and the left-outer form prunes
   none.  ``python3 chip_smoke.py --lakehouse`` runs this phase alone;
25. ``[observe]``: the observability plane at SF1 under one
   ``tpuq-observe-*`` temporary directory (removed): q1, q3, q5 and q18
   cold (cache cleared, counts to 0 before, read after) then warm under
   tracing, the stats plane at ``FULL``, the query log, the profile
   store and the telemetry sampler (100 ms, both sinks); each run's
   ledger closes (``unaccounted_s`` <= ``closeTolerance`` x e2e), its
   buckets sum to at most e2e, the stats record's root rows equal the
   result's, the Chrome trace parses with a ``pump`` span for every
   node that pumps (fused ones do not) and the query log, the trace file
   and the profile store carry one id per run; prints each run's walls,
   buckets, verdict, launches and rows per node, and
   ``explain("analyze")`` of q3.  Then q1 under
   ``spark.rapids.profile.enabled`` (its ``torch.profiler`` trace must
   name the ``hash_pairs`` kernel among its device events), q18 cut by
   a deadline (``QueryCancelled(reason="deadline")``, a black box naming
   its dominant bucket, rendered by ``python -m
   spark_rapids_tpu_torch.utils.profile why``), and the registry:
   ``metrics_report()``, the Prometheus file parses, q1's
   ``tpuq_kernel_dispatch_total{backend="cuda"}`` delta equals the
   kernel plane's count, the sampler wrote JSONL lines.  ``python3
   chip_smoke.py --observe`` runs this phase and ``[attribution cost]``
   alone;
26. ``[planes]``: the engine planes at SF1.  The 22 queries under the
   whole of ``tpch.TPCH_SF1_CONF`` (the adaptive plane, whole-stage
   fusion and the result cache, whose ``minRuntimeMs`` keeps every run
   a miss) with ``test.enabled``, each cold (cache cleared, counts to 0
   before, read after) then warm (not after a cold run over
   ``PLANES_WARM_MAX_COLD_S``): 0 operators on the CPU, equal to its
   ``ref_q*``, every run probed by the cache; prints per query the
   regions built and fallen open, the graphs captured and replayed,
   the adaptive decisions by kind, the cache probes, the ``hash_pairs``
   launches and the cold and warm walls.  At the main path's conf: q1,
   q3 and q6 with fusion on and off (q6, whose only map is one filter,
   under ``fusion.mode=aggressive``): warm walls interleaved, and one
   warm run of each under ``torch.profiler``
   (``utils/device_profile.py``): device kernel events, ``cudaLaunch*``
   and ``cudaGraphLaunch`` calls; none of the three may fall open; the
   bytes the graphs hold outside the memory arbiter.  The cache at SF1:
   q1 twice with ``minRuntimeMs`` 0, the second a hit (equal rows, 0 ``hash_pairs``
   launches, no CUDA event in its ``torch.profiler`` trace),
   ``invalidate_cache`` making the next run a miss, and two queries over
   one shared in-process exchange (``cache.subplan.enabled``), the
   second served the stage.  The adaptive plane: the join variants with
   the decisions recorded (``adaptive.historyPath`` under a temporary
   directory, so each variant's second run decides from history), each
   the strategy ``cost_model.choose_join_strategy`` gives for its build
   bytes and threshold; and lineitem with a seeded quarter of its rows
   moved to one order key, joined to orders with broadcasts off: the
   hot partition splits, equal to pyarrow's join.  ``python3
   chip_smoke.py --planes`` runs this phase alone;
27. ``[distributed]``: the ICI plane at SF1 (``distributed_phase``).
   On 8 virtual ranks of the card under ``spark.rapids.shuffle.mode=ICI``
   and ``spark.default.parallelism`` 8: q1, q3, q5 and q18 (their plans'
   ICI lines the JAX package's, ``DIST_PLAN_LINES``), the 1.5M orders
   by price (a range exchange under a ``partitioned`` sort) and the line
   running totals (a window behind a hash exchange), each cold then
   warm, equal to its reference (q1–q18 also to the main path's
   one-rank run), with the ICI exchanges' ``partitionTime``,
   ``collectiveTime`` and bytes; q18's inner aggregate behind a
   repartition under ``exchange.mode=compiled`` and ``host``, the
   exchanges' partitions equal row for row and their row counts the
   script's numpy murmur3 pmod 8; a terminal ``collective`` fault in q1
   degraded to the host transport, counted; then two executor
   processes (``--dist-child``) x 2 virtual ranks on the card over the
   rendezvous (gloo, staged through the host), reading the tables from
   Arrow IPC files: q1 and q3 as unions of the slices, the cluster-wide
   partition counts, one transient ``rendezvous`` fault and a
   ``peer_loss``; over NCCL, one card each, only on a machine with two.
   ``python3 chip_smoke.py --distributed`` runs this phase alone;
28. the string expressions of the string queries (LIKE, NOT LIKE,
   ``contains``, ``startswith``, ``endswith``, ``substring``) alone on
   the card at the batches of their scans: the column's H2D, the
   expression's time by CUDA events, and its byte bound;
29. the kernel at every shape the main path (queries, variants,
   fallback cases, partitions, exchanges, operators, strings, retry,
   pump, faults, breadth, decimal, nested, window, udf, io, lakehouse,
   observe, planes and distributed) launched it with, bit for bit against its plain version, timed as
   in phase 3 and by a ring of distinct inputs larger than the L2 cache
   (``ms_ring``, from which ``pct_of_bound`` is read), traced alone by
   ``torch.profiler`` after an L2-evicting write (``traced_ms``) and
   read (``traced_clean_ms``), called from a list of limbs through
   ``hash_layout.hash_limbs`` (``from_list_ms``), and at the join's
   shapes both sides in one launch (``pair_ms``, bit-identical to the
   plain version first, and traced) against two; and the wrappers'
   host time per call;
30. the seconds of each phase, a JSON line of every kernel's numbers,
   the ``nvidia-smi`` line again,
   and last the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when CUDA is unavailable or the port's package is not
beside it.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# ``python3 chip_smoke.py --faults``: the [faults] phase alone (with the
# clean runs and the spill pool it needs)
FAULTS_ONLY = "--faults" in sys.argv[1:]
# ``python3 chip_smoke.py --breadth``: the [breadth] phase alone
BREADTH_ONLY = "--breadth" in sys.argv[1:]
# ``python3 chip_smoke.py --decimal``: the [decimal] phase alone
DECIMAL_ONLY = "--decimal" in sys.argv[1:]
# ``python3 chip_smoke.py --nested``: the [nested] phase alone
NESTED_ONLY = "--nested" in sys.argv[1:]
# ``python3 chip_smoke.py --window``: the [window] phase alone
WINDOW_ONLY = "--window" in sys.argv[1:]
# ``python3 chip_smoke.py --udf`` / ``--io`` / ``--lakehouse``: the [udf] /
# [io] / [lakehouse] phase alone
UDF_ONLY = "--udf" in sys.argv[1:]
IO_ONLY = "--io" in sys.argv[1:]
LAKEHOUSE_ONLY = "--lakehouse" in sys.argv[1:]
# ``python3 chip_smoke.py --observe``: [attribution cost] and [observe]
OBSERVE_ONLY = "--observe" in sys.argv[1:]
# ``python3 chip_smoke.py --planes``: the [planes] phase alone
PLANES_ONLY = "--planes" in sys.argv[1:]
# ``python3 chip_smoke.py --distributed``: [distributed] alone (with the
# one-rank runs of its four queries)
DISTRIBUTED_ONLY = "--distributed" in sys.argv[1:]
SF = 1.0
# (L limbs, n rows): edge shapes, q1's aggregate (3, 2^20), and the
# join's build and probe sides (1, 2^18) and q4's probe side (1, 2^16)
KERNEL_SHAPES = [(n_limbs, n) for n_limbs in (1, 2, 3, 4)
                 for n in (1, 1024, 4095, 1 << 20, 6_000_001)] + [
                     (1, 1 << 18), (1, 1 << 16)]
MAIN_PATH_SHAPE = (3, 1 << 20)  # q1: flag limb + 128-bit key hash, 2^20 rows
# odd n (the vector path's scalar tail; rows of a stacked tensor that are
# not 16-byte aligned)
ODD_NS = (1, 3, 4095, (1 << 20) + 1)
# the main path's session conf: test mode, so that any operator the plan
# rewrite would leave on the CPU raises
SESSION_CONF = {"spark.rapids.sql.test.enabled": True}
# every session's black boxes go to a directory of this run's own, made
# and removed by ``run``
BLACKBOX_KEY = "spark.rapids.tpu.attribution.blackboxPath"
# join sides hashed in one launch: q3's (build, probe) and q4's
JOIN_PAIRS = (((1, 1 << 18), (1, 1 << 18)), ((1, 1 << 18), (1, 1 << 16)))
QUERIES = ("q1", "q6", "q3", "q4", "q5", "q7", "q8", "q10", "q11", "q12",
           "q15", "q17", "q18", "q19", "q21", "q2", "q9", "q13", "q14",
           "q16", "q20", "q22")
# the string expressions of the seven pattern queries, timed alone on the
# card at the batches their scans make: (query, table, column, pattern
# expression over the column)
STRING_EXPRS = (
    ("q13", "orders", "o_comment", "not like", "%special%requests%"),
    ("q16", "supplier", "s_comment", "like", "%Customer%Complaints%"),
    ("q16", "part", "p_type", "not like", "MEDIUM POLISHED%"),
    ("q14", "part", "p_type", "like", "PROMO%"),
    ("q9", "part", "p_name", "contains", "green"),
    ("q20", "part", "p_name", "startswith", "forest"),
    ("q2", "part", "p_type", "endswith", "BRASS"),
    ("q22", "customer", "c_phone", "substring", (1, 2)),
)
FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
RING_BYTES = 128 << 20  # inputs of one ring pass: > 2x the L2
RING_LAUNCHES = 100
RING_MAX = 400  # ring entries at most (the launch queue holds ~1000)
GATE_CYCLES = 40_000_000  # device sleep that lets the host queue a run


# -- [operators]: limits, union, range, sample, rollup/cube, out-of-core sort

LIMIT_PARTITIONS = (1, 8)
RANGE_END = 1 << 27  # 134M ids, 1 GiB of int64 made on the card
SAMPLE_FRACTION, SAMPLE_SEED = 0.1, 42
UNION_SPLIT = datetime.date(1995, 6, 17)
# the generator's lineitem has no l_linenumber: l_partkey breaks the
# orderkey ties in its place
SORT_COLUMNS = ["l_orderkey", "l_partkey", "l_extendedprice",
                "l_shipdate"]


def spark_murmur3_int(values, seeds):
    """Spark's ``Murmur3_x86_32.hashInt`` of u32 values under per-value
    seeds (numpy, written here so the check does not lean on the
    package)."""
    import numpy as np
    with np.errstate(over="ignore"):
        h = _mix_h1(np.asarray(seeds, np.uint32),
                    _mix_k1(np.asarray(values, np.uint32)))
        return _fmix32(h, 4)


def sample_mask(n: int, nparts: int, fraction: float, seed: int):
    """The rows ``sample(fraction, seed)`` keeps of an n-row table in
    ``nparts`` scan partitions of ``ceil(n / nparts)`` rows: a row's
    ordinal in its partition, hashed with ``seed + partition``, below
    ``fraction * 2^32``."""
    import numpy as np
    step = -(-n // nparts)
    rows = np.arange(n, dtype=np.int64)
    part = rows // step
    thresh = min(int(fraction * 4294967296.0), 0xFFFFFFFF)
    h = spark_murmur3_int((rows - part * step).astype(np.uint32),
                          ((seed + part) & 0xFFFFFFFF).astype(np.uint32))
    return h < np.uint32(thresh)


def ref_grouping_sets(table, keys, sets, aggs):
    """rollup/cube by pyarrow: ``group_by`` per grouping set, the keys
    outside the set null.  ``aggs``: (output name, column, pyarrow
    function); ``count`` counts rows."""
    import pyarrow as pa
    t = table.append_column("_one", pa.array(
        [1] * table.num_rows, pa.int64()))
    out = []
    for s in sets:
        by = [keys[i] for i in s] or ["_one"]
        g = t.group_by(by).aggregate(
            [(("_one", "sum") if fn == "count" else (c, fn))
             for _, c, fn in aggs])
        n = g.num_rows
        cols = {k: (g[k] if i in s else pa.nulls(n, table.schema.field(
            k).type)) for i, k in enumerate(keys)}
        for name, c, fn in aggs:
            cols[name] = g["_one_sum" if fn == "count" else f"{c}_{fn}"]
        out.append(pa.table(cols))
    return pa.concat_tables(out)


def scan_batches(df) -> int:
    """Batches the plan's scans yielded in the last run."""
    return sum(m.get("numOutputBatches", 0) for name, m in df.metrics()
               if name == "TpuScanExec")


def operators_phase(dev, tables, refs, CB, KN, range_end=RANGE_END
                    ) -> dict:
    """The slice's operators at SF1 under ``SESSION_CONF`` (any fallback
    raises), each aggregate a path of its own (counts set to 0 before
    its run, read after; the scan cache cleared once, at the start):

    1. limits: ``lineitem.limit(100000)`` and ``lineitem.filter(
       l_quantity > 45).limit(1000)`` under parallelism 1 and 8, equal
       to the table's and the filtered table's first rows; the scan
       batches they pulled;
    2. union: q1 over the union of lineitem below and at or above
       1995-06-17, equal to q1's pyarrow reference;
    3. range: ``range(0, 2^27)`` and ``range(5, 2^27, 3,
       numPartitions=8)``, sum and count against the closed form; the
       warm wall and ids per second;
    4. sample: ``lineitem.sample(0.1, seed=42)``'s count and q1 over it
       under parallelism 1 and 8, against this script's numpy murmur3
       draw (count exactly, q1 within 1e-9);
    5. rollup of lineitem by (l_returnflag, l_linestatus), 10 rows (the
       generator draws the two independently: 6 pairs, 3 flags, the
       total), and cube of orders by (o_orderpriority, o_orderstatus),
       24 rows, against pyarrow per grouping set;
    6. the out-of-core sort: lineitem's (l_orderkey, l_partkey,
       l_extendedprice, l_shipdate) by extendedprice descending, then
       orderkey and partkey, in core under the default pool, then
       under a pool of the sorted input's bytes (half the in-core
       working set): one out-of-core sort of at least 3 output batches
       that spills, equal to pyarrow's stable sort and to the in-core
       run row for row.

    Returns the counts of the paths that aggregate, by name."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    li, orders = tables["lineitem"], tables["orders"]

    def session(nparts=1, **conf):
        return TpuSession(dict(SESSION_CONF, **{
            "spark.default.parallelism": nparts}, **conf), device=dev)

    def no_fallback(name, df):
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"{name}: plan rewrite fell back: {fb}")

    counts = {}

    def path(name, build, want):
        """An aggregate's path: counts to 0, the cold run, read; against
        ``want``; one warm run."""
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = build()
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] operators {name} " + json.dumps(c), flush=True)
        no_fallback(name, df)
        check(c["hash_pairs_launches"] > 0,
              f"operators {name}: hash_pairs was not launched")
        check(c["collision_fallbacks"] == 0,
              f"operators {name}: hash-collision fallbacks")
        check(got.column_names == want.column_names
              and rows_equal(got, want),
              f"operators {name} differs from its reference:\n"
              f"{got}\n{want}")
        warm_out, warm = timed(build())
        check(rows_equal(warm_out, got, 0.0),
              f"operators {name}: the warm run differs")
        return got, {"cold_wall_s": cold, "warm_wall_s": warm,
                     "rows": got.num_rows,
                     "hash_pairs_launches": c["hash_pairs_launches"]}

    clear_scan_cache()
    # -- limits
    over45 = li.filter(pc.greater(li["l_quantity"], 45))
    for nparts in LIMIT_PARTITIONS:
        s = session(nparts)
        for name, build, want in (
                ("limit 100000",
                 lambda: s.createDataFrame(li).limit(100_000),
                 li.slice(0, 100_000)),
                ("filter l_quantity > 45 limit 1000",
                 lambda: s.createDataFrame(li)
                 .filter(col("l_quantity") > 45).limit(1000),
                 over45.slice(0, 1000))):
            df = build()
            got, wall = timed(df)
            no_fallback(name, df)
            check(got.equals(want), f"operators {name} (parallelism "
                  f"{nparts}) differs from the table's first rows")
            tree = df._last_plan.tree_string()
            check("*TpuGlobalLimit" in tree and "*TpuLocalLimit" in tree,
                  f"operators {name}: {tree}")
            print("[operators] " + json.dumps(
                {"query": name, "partitions": nparts, "rows": got.num_rows,
                 "wall_s": wall, "scan_batches_pulled": scan_batches(df),
                 "equal_first_rows": True}), flush=True)

    # -- union: q1 over two halves of lineitem
    s = session()
    _, line = path("union q1", lambda: tpch.q1_over(
        s.createDataFrame(li).filter(col("l_shipdate") < UNION_SPLIT)
        .union(s.createDataFrame(li)
               .filter(col("l_shipdate") >= UNION_SPLIT))), refs["q1"])
    print("[operators] union q1 " + json.dumps(line), flush=True)

    # -- range: ids made on the card, sum and count
    n1 = range_end
    n2 = -(-(range_end - 5) // 3)
    for name, build, want in (
            (f"range(0, {range_end})",
             lambda: session().range(0, range_end),
             (n1 * (n1 - 1) // 2, n1)),
            (f"range(5, {range_end}, 3, numPartitions=8)",
             lambda: session().range(5, range_end, 3, numPartitions=8),
             (5 * n2 + 3 * n2 * (n2 - 1) // 2, n2))):
        def agg(build=build):
            return build().agg(F.sum("id").alias("s"),
                               F.count("*").alias("n"))
        walls = []
        for _ in range(2):
            df = agg()
            got, wall = timed(df)
            walls.append(wall)
            no_fallback(name, df)
            check((got.column("s")[0].as_py(), got.column("n")[0].as_py())
                  == want, f"operators {name}: {got.to_pylist()}, closed "
                  f"form {want}")
        print("[operators] " + json.dumps(
            {"query": name + ".agg(sum, count)", "ids": want[1],
             "cold_wall_s": walls[0], "warm_wall_s": walls[1],
             "ids_per_s": want[1] / walls[1], "equal_closed_form": True}),
            flush=True)

    # -- sample: the draw against numpy's murmur3, under 1 and 8 partitions
    for nparts in LIMIT_PARTITIONS:
        s = session(nparts)
        mask = sample_mask(li.num_rows, nparts, SAMPLE_FRACTION,
                           SAMPLE_SEED)
        kept = li.filter(pa.array(mask))

        def sampled(s=s):
            return s.createDataFrame(li).sample(SAMPLE_FRACTION,
                                                seed=SAMPLE_SEED)
        df = sampled().agg(F.count("*").alias("n"))
        got, wall = timed(df)
        no_fallback("sample count", df)
        check(got.column("n")[0].as_py() == int(mask.sum()),
              f"operators sample (parallelism {nparts}): "
              f"{got.column('n')[0]} rows, numpy murmur3 keeps "
              f"{int(mask.sum())}")
        _, line = path(f"sample q1 parallelism {nparts}",
                       lambda: tpch.q1_over(sampled()), ref_q1(kept))
        line.update(partitions=nparts, sampled_rows=int(mask.sum()),
                    count_wall_s=wall, equal_numpy_murmur3=True)
        print("[operators] sample q1 " + json.dumps(line), flush=True)

    # -- rollup and cube
    s = session()
    rollup_want = ref_grouping_sets(
        li, ["l_returnflag", "l_linestatus"], [[0, 1], [0], []],
        [("sq", "l_quantity", "sum"), ("sp", "l_extendedprice", "sum"),
         ("ad", "l_discount", "mean"), ("c", None, "count")])
    cube_want = ref_grouping_sets(
        orders, ["o_orderpriority", "o_orderstatus"],
        [[0, 1], [0], [1], []],
        [("st", "o_totalprice", "sum"), ("c", None, "count")])
    check(rollup_want.num_rows == 10 and cube_want.num_rows == 24,
          f"grouping-set references: {rollup_want.num_rows} and "
          f"{cube_want.num_rows} rows")
    for name, build, want in (
            ("rollup lineitem", lambda: s.createDataFrame(li).rollup(
                "l_returnflag", "l_linestatus").agg(
                F.sum("l_quantity").alias("sq"),
                F.sum("l_extendedprice").alias("sp"),
                F.avg("l_discount").alias("ad"),
                F.count("*").alias("c")), rollup_want),
            ("cube orders", lambda: s.createDataFrame(orders).cube(
                "o_orderpriority", "o_orderstatus").agg(
                F.sum("o_totalprice").alias("st"),
                F.count("*").alias("c")), cube_want)):
        _, line = path(name, build, want)
        line["hash_pairs_shapes"] = counts[name]["shapes"]
        print(f"[operators] {name} " + json.dumps(line), flush=True)

    # -- the out-of-core sort
    def sort_query(s):
        return s.createDataFrame(li).select(*SORT_COLUMNS).orderBy(
            col("l_extendedprice").desc(), "l_orderkey", "l_partkey")

    srt = li.select(SORT_COLUMNS)
    want = srt.take(pc.sort_indices(srt, sort_keys=[
        ("l_extendedprice", "descending"), ("l_orderkey", "ascending"),
        ("l_partkey", "ascending")]))
    s = session()
    mgr = MM.get_manager(s.rapids_conf(), dev)
    reserve, largest = mgr.reserve, []

    def recording(nbytes, _restoring=None):
        largest.append(nbytes)
        return reserve(nbytes, _restoring)

    runs = {}
    clear_scan_cache()
    mgr.reserve = recording  # the in-core sort's transient: 2x its input
    try:
        in_core, in_cold = timed(sort_query(s))
    finally:
        del mgr.reserve
    sorted_bytes = max(largest) // 2
    in_warm_df = sort_query(s)
    _, in_warm = timed(in_warm_df)
    sort = find_node(in_warm_df._last_plan, "TpuSortExec")
    check(sort.metric("outOfCoreSorts").value == 0,
          "the in-core sort went out of core under the default pool")
    check(in_core.equals(want), "operators in-core sort differs from "
          "pyarrow's stable sort_indices order")
    runs["in_core"] = {"pool": mgr.budget, "cold_wall_s": in_cold,
                       "warm_wall_s": in_warm}
    pool = sorted_bytes
    tight = session(**{"spark.rapids.tpu.memory.poolSize": pool})
    walls, metrics = [], []
    for _ in range(2):
        df = sort_query(tight)
        got, wall = timed(df)
        no_fallback("out-of-core sort", df)
        walls.append(wall)
        sort = find_node(df._last_plan, "TpuSortExec")
        smgr = MM.peek_manager()
        # this run's share of the arbiter's running totals
        before = metrics[-1] if metrics else {}
        metrics.append(dict(
            {k: sort.metric(k).value for k in
             ("outOfCoreSorts", "numOutputBatches")},
            peakReserved=smgr.metrics["peakReserved"],
            **{k: smgr.metrics[k] - before.get("total_" + k, 0) for k in (
                "spillToHostBytes", "restoredBytes", "retryOOMs")},
            **{"total_" + k: smgr.metrics[k] for k in (
                "spillToHostBytes", "restoredBytes", "retryOOMs")}))
        check(smgr.budget == pool, f"sort pool {smgr.budget} != {pool}")
        check(got.equals(want) and got.equals(in_core),
              "the out-of-core sort differs from pyarrow's stable order "
              "or from the in-core run")
    first = metrics[0]
    check(first["outOfCoreSorts"] == 1 and first["numOutputBatches"] >= 3
          and first["spillToHostBytes"] > 0,
          f"out-of-core sort metrics {metrics}")
    runs["out_of_core"] = {"pool": pool, "cold_wall_s": walls[0],
                           "warm_wall_s": walls[1], "runs": metrics}
    print("[operators] out-of-core sort " + json.dumps(dict(
        rows=li.num_rows, sorted_input_bytes=sorted_bytes,
        in_core_working_set_bytes=2 * sorted_bytes,
        equal_pyarrow_stable_sort=True, equal_in_core=True, **runs)),
        flush=True)
    MM.get_manager(session().rapids_conf(), dev)
    clear_scan_cache()
    print(f"[operators] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


STRINGS_WARM_RUNS = 1
EXPR_TIMING_ITERS = 5
STRINGS_CONF = {"spark.rapids.sql.incompatibleOps.enabled": True,
                "spark.rapids.sql.castStringToFloat.enabled": True}
PHONE_PATTERN = "^(1[3-9]|2[0-9])-[0-9]{3}-[0-9]{4}$"
COMMENT_PATTERN = "special.*requests"
NAME_WORD = "[a-z]+$"
VOWELS = "[aeiou]+"
# the plan rewrite's reasons for the incompatible expressions and the
# float cast (the JAX package's texts)
INCOMPAT_REASONS = {
    "Lower": "expression Lower is not fully compatible with Spark "
             "(ASCII-only case mapping on device; non-ASCII bytes pass "
             "through unchanged); set "
             "spark.rapids.sql.incompatibleOps.enabled=true to enable",
    "StringReverse": "expression StringReverse is not fully compatible "
                     "with Spark (byte-based reverse differs from Spark on "
                     "non-ASCII); set "
                     "spark.rapids.sql.incompatibleOps.enabled=true to "
                     "enable",
    "StringPad": "expression StringPad is not fully compatible with Spark "
                 "(byte-based padding differs from Spark on non-ASCII); "
                 "set spark.rapids.sql.incompatibleOps.enabled=true to "
                 "enable"}
FLOAT_TO_STRING_REASON = ("expression Cast: cast floating→string not on "
                          "device (Java shortest-round-trip formatting)")


def catalogue_query(s, part):
    """Run 2: the part-catalogue cleanup, ten string expressions sorted
    by p_partkey."""
    return catalogue_select(s, part).orderBy("p_partkey")


def catalogue_select(s, part):
    """The part-catalogue cleanup's ten string expressions, unsorted: a
    root that keeps its partitions."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(part).select(
        col("p_partkey"),
        F.lower(col("p_type")).alias("type_lc"),
        F.length(col("p_name")).alias("name_len"),
        F.locate("green", col("p_name")).alias("green_at"),
        F.concat(col("p_mfgr"), F.lit("/"), col("p_brand")).alias(
            "mfgr_brand"),
        F.lpad(col("p_size").cast("string"), 4, "0").alias("size4"),
        F.reverse(col("p_container")).alias("container_rev"),
        F.rtrim(F.rpad(col("p_brand"), 12, " ")).alias("brand"),
        F.replace(col("p_type"), "BRASS", "Cu-Zn").alias("type_cu"),
        F.regexp_replace(col("p_name"), VOWELS, "").alias("consonants"),
        F.regexp_extract(col("p_name"), NAME_WORD, 0).alias("last_word"))


def ref_catalogue(part):
    import pyarrow as pa
    import pyarrow.compute as pc
    srt = part.take(pc.sort_indices(part, sort_keys=[("p_partkey",
                                                      "ascending")]))
    name, ptype = srt["p_name"], srt["p_type"]
    last = pc.struct_field(pc.extract_regex(name, f"(?P<w>{NAME_WORD})"),
                           [0])
    return pa.table({
        "p_partkey": srt["p_partkey"],
        "type_lc": pc.utf8_lower(ptype),
        "name_len": pc.utf8_length(name),
        "green_at": pc.add(pc.find_substring(name, "green"), 1),
        "mfgr_brand": pc.binary_join_element_wise(
            srt["p_mfgr"], pa.array(["/"] * srt.num_rows), srt["p_brand"],
            ""),
        "size4": pc.utf8_lpad(pc.cast(srt["p_size"], pa.string()), 4, "0"),
        "container_rev": pc.cast(pc.binary_reverse(
            pc.cast(srt["p_container"], pa.binary())), pa.string()),
        "brand": pc.utf8_rtrim(pc.utf8_rpad(srt["p_brand"], 12, " "), " "),
        "type_cu": pc.replace_substring(ptype, "BRASS", "Cu-Zn"),
        "consonants": pc.replace_substring_regex(name, VOWELS, ""),
        "last_word": pc.fill_null(last, ""),
    })


def catalogue_grouped(s, part):
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(part).groupBy(
        F.regexp_extract(col("p_name"), NAME_WORD, 0).alias("last_word"),
        F.lower(col("p_type")).alias("type_lc")).agg(
        F.count("*").alias("n"),
        F.sum(F.length(col("p_name"))).alias("name_bytes"))


def ref_catalogue_grouped(part):
    import pyarrow as pa
    import pyarrow.compute as pc
    last = pc.fill_null(pc.struct_field(pc.extract_regex(
        part["p_name"], f"(?P<w>{NAME_WORD})"), [0]), "")
    t = pa.table({"last_word": last,
                  "type_lc": pc.utf8_lower(part["p_type"]),
                  "len": pc.cast(pc.utf8_length(part["p_name"]),
                                 pa.int64())})
    g = t.group_by(["last_word", "type_lc"]).aggregate(
        [([], "count_all"), ("len", "sum")])
    return pa.table({"last_word": g["last_word"], "type_lc": g["type_lc"],
                     "n": g["count_all"], "name_bytes": g["len_sum"]})


def phone_report(s, customer):
    """Run 1: customers with a phone of country code 13-29, counted and
    summed by that code, cast to int."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(customer).filter(
        col("c_phone").rlike(PHONE_PATTERN)).groupBy(
        F.substring(col("c_phone"), 1, 2).cast("int").alias("cc")).agg(
        F.count("*").alias("n"), F.sum("c_acctbal").alias("bal"))


def ref_phone_report(customer):
    import pyarrow as pa
    import pyarrow.compute as pc
    c = customer.filter(pc.match_substring_regex(customer["c_phone"],
                                                 PHONE_PATTERN))
    t = pa.table({"cc": pc.cast(pc.utf8_slice_codeunits(c["c_phone"], 0, 2),
                                pa.int32()),
                  "bal": c["c_acctbal"]})
    g = t.group_by("cc").aggregate([([], "count_all"), ("bal", "sum")])
    return pa.table({"cc": g["cc"], "n": g["count_all"],
                     "bal": g["bal_sum"]})


def comment_search(s, orders):
    """Run 3: orders whose comment matches special.*requests, the
    comment bytes summed by priority."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(orders).filter(
        col("o_comment").rlike(COMMENT_PATTERN)).groupBy(
        "o_orderpriority").agg(
        F.sum(F.length(col("o_comment"))).alias("comment_bytes"))


def ref_comment_search(orders):
    import pyarrow as pa
    import pyarrow.compute as pc
    o = orders.filter(pc.match_substring_regex(orders["o_comment"],
                                               COMMENT_PATTERN))
    t = pa.table({"o_orderpriority": o["o_orderpriority"],
                  "len": pc.cast(pc.utf8_length(o["o_comment"]),
                                 pa.int64())})
    g = t.group_by("o_orderpriority").aggregate([("len", "sum")])
    return pa.table({"o_orderpriority": g["o_orderpriority"],
                     "comment_bytes": g["len_sum"]})


def cast_queries(s, li):
    """Run 4: the cast round trip over lineitem, three aggregates."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    d = s.createDataFrame(li)
    return {
        "round trip": d.filter(col("l_orderkey").cast("string")
                               .cast("long") == col("l_orderkey"))
        .agg(F.count("*").alias("n")),
        "parsed sum": d.agg(F.sum(F.concat(
            col("l_partkey").cast("string"), F.lit(".25"))
            .cast("double")).alias("s")),
        "flag count": d.filter((col("l_returnflag") == "R").cast("string")
                               .cast("boolean"))
        .agg(F.count("*").alias("n"))}


def ref_cast_queries(li):
    import pyarrow as pa
    import pyarrow.compute as pc
    parsed = pc.cast(pc.binary_join_element_wise(
        pc.cast(li["l_partkey"], pa.string()),
        pa.array([".25"] * li.num_rows), ""), pa.float64())
    back = pc.cast(pc.cast(li["l_orderkey"], pa.string()), pa.int64())
    flag = pc.cast(pc.cast(pc.equal(li["l_returnflag"], "R"), pa.string()),
                   pa.bool_())
    return {
        "round trip": pa.table({"n": pa.array([pc.sum(pc.equal(
            back, li["l_orderkey"])).as_py()], pa.int64())}),
        "parsed sum": pa.table({"s": pa.array([pc.sum(parsed).as_py()],
                                              pa.float64())}),
        "flag count": pa.table({"n": pa.array([pc.sum(flag).as_py()],
                                              pa.int64())})}


def float_to_string(s, li):
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(li).select(
        col("l_extendedprice").cast("string").alias("price"))


def ref_float_to_string(li):
    """Java's Double.toString, which for |x| in [1e-3, 1e7) prints as
    Python's repr does."""
    import numpy as np
    import pyarrow as pa
    v = li["l_extendedprice"].to_numpy()
    check(bool(((np.abs(v) >= 1e-3) & (np.abs(v) < 1e7)).all()),
          "l_extendedprice outside [1e-3, 1e7): Java's format differs")
    return pa.table({"price": pa.array([repr(float(x)) for x in v])})


def new_string_exprs():
    """``(name, table, columns, prep, build)`` of each expression the
    string slice added: ``build(refs)`` over the scan's columns, or over
    the output of ``prep(refs)`` (the casts from a string time the cast
    alone, on the string the main path's inner cast makes)."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.ops import expressions as E
    from spark_rapids_tpu_torch.ops import strings as S

    def lit(v):
        return E.Literal(v, T.StringT)

    return (
        ("length", "part", ["p_name"], None, lambda r: S.Length(r[0])),
        ("upper", "part", ["p_type"], None, lambda r: S.Upper(r[0])),
        ("lower", "part", ["p_type"], None, lambda r: S.Lower(r[0])),
        ("trim", "part", ["p_container"], None,
         lambda r: S.Trim(r[0], "both")),
        ("ltrim", "part", ["p_container"], None,
         lambda r: S.Trim(r[0], "leading")),
        ("rtrim", "part", ["p_container"], None,
         lambda r: S.Trim(r[0], "trailing")),
        ("locate 'green'", "part", ["p_name"], None,
         lambda r: S.StringLocate(lit("green"), r[0], 1)),
        ("replace 'BRASS' 'Cu-Zn'", "part", ["p_type"], None,
         lambda r: S.StringReplace(r[0], "BRASS", "Cu-Zn")),
        ("concat p_mfgr '/' p_brand", "part", ["p_mfgr", "p_brand"], None,
         lambda r: S.Concat([r[0], lit("/"), r[1]])),
        ("reverse", "part", ["p_container"], None,
         lambda r: S.StringReverse(r[0])),
        ("lpad 4 '0'", "part", ["p_brand"], None,
         lambda r: S.StringPad(r[0], 4, "0", True)),
        ("rpad 12 ' '", "part", ["p_brand"], None,
         lambda r: S.StringPad(r[0], 12, " ", False)),
        ("cast long as string", "lineitem", ["l_orderkey"], None,
         lambda r: E.Cast(r[0], T.StringT)),
        ("cast boolean as string", "lineitem", ["l_returnflag"],
         lambda r: S.StringComparison("eq", r[0], lit("R")),
         lambda r: E.Cast(r[0], T.StringT)),
        ("cast string as long", "lineitem", ["l_orderkey"],
         lambda r: E.Cast(r[0], T.StringT),
         lambda r: E.Cast(r[0], T.LongT)),
        ("cast string as boolean", "lineitem", ["l_returnflag"],
         lambda r: E.Cast(S.StringComparison("eq", r[0], lit("R")),
                          T.StringT),
         lambda r: E.Cast(r[0], T.BooleanT)),
        ("cast string as double", "lineitem", ["l_partkey"],
         lambda r: S.Concat([E.Cast(r[0], T.StringT), lit(".25")]),
         lambda r: E.Cast(r[0], T.DoubleT)),
        (f"rlike {PHONE_PATTERN!r}", "customer", ["c_phone"], None,
         lambda r: S.RLike(r[0], PHONE_PATTERN)),
        (f"rlike {COMMENT_PATTERN!r}", "orders", ["o_comment"], None,
         lambda r: S.RLike(r[0], COMMENT_PATTERN)),
        (f"regexp_extract {NAME_WORD!r} 0", "part", ["p_name"], None,
         lambda r: S.RegexpExtract(r[0], NAME_WORD, 0)),
        (f"regexp_replace {VOWELS!r} ''", "part", ["p_name"], None,
         lambda r: S.RegexpReplace(r[0], VOWELS, "")),
    )


def _col_bytes(c) -> int:
    """A column's data and lengths bytes (its validity not counted, as
    ``[string expression]`` counts them)."""
    n = c.data.numel() * c.data.element_size()
    return n + (0 if c.lengths is None else 4 * c.capacity)


def new_string_expr_times(tables, session) -> list:
    """Each of ``new_string_exprs()`` alone on the card at the batches of
    its scan (``host_to_device`` at the session's batch rows): the time
    of the expression over those batches (``cuda_ms``: events around
    the calls, host time included) against its byte bound, every input
    column's bytes read once and the output's written once, over the
    memory rate."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import (
        DeviceBatch, host_to_device)
    from spark_rapids_tpu_torch.ops import expressions as E
    conf = session.rapids_conf()
    rows = []
    for name, table, columns, prep, build in new_string_exprs():
        tbl = tables[table].select(columns)
        batches = [host_to_device(tbl.slice(lo, conf.batch_rows),
                                  session.device,
                                  min_bucket=conf.min_bucket_rows)
                   for lo in range(0, tbl.num_rows, conf.batch_rows)]
        refs = [E.BoundReference(i, f.dtype)
                for i, f in enumerate(batches[0].schema.fields)]
        if prep is not None:
            inner = prep(refs)
            batches = [DeviceBatch(
                T.StructType((T.StructField("x", inner.dtype),)),
                (inner.eval(b),), b.sel) for b in batches]
            refs = [E.BoundReference(0, inner.dtype)]
        expr = build(refs)
        outs = [expr.eval(b) for b in batches]
        in_bytes = sum(_col_bytes(c) for b in batches for c in b.columns)
        out_bytes = sum(_col_bytes(o) for o in outs)
        ms = cuda_ms(lambda: [expr.eval(b) for b in batches],
                     iters=EXPR_TIMING_ITERS)
        bound = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
        line = {"expression": name, "table": table, "columns": columns,
                "rows": tbl.num_rows,
                "batches": [list(b.columns[0].data.shape)
                            for b in batches],
                "output_width": (None if outs[0].lengths is None
                                 else int(outs[0].data.shape[1])),
                "ms": ms, "bound_ms": bound, "bound_by": "bytes",
                "pct_of_bound": 100.0 * bound / ms}
        rx = getattr(expr, "_rx", None)
        if rx is not None and rx() is not None:
            line["dfa_states"] = int(rx().table.shape[0])
        rows.append(line)
        del batches, outs
    return rows


def strings_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """The string slice's expressions at SF1 under ``SESSION_CONF``
    with ``STRINGS_CONF`` (any fallback raises), each run a path of its
    own (counts set to 0 before its cold run, read after; the scan cache
    cleared once, at the start), each against this script's pyarrow
    reference, then ``STRINGS_WARM_RUNS`` warm runs:

    1. the phone-code report over customer: ``c_phone`` against a
       pattern outside the simple transpile (the DFA runs on the card),
       grouped by ``cast(substring(c_phone, 1, 2) as int)`` with count
       and ``sum(c_acctbal)``;
    2. the part-catalogue cleanup over part: ten string expressions
       sorted by ``p_partkey``, row for row, and its grouped form by
       ``regexp_extract(p_name, '[a-z]+$', 0)`` and ``lower(p_type)``
       (more than 3 key limbs: the tuple hash, timed alone beside);
    3. the comment search over orders: ``rlike('special.*requests')``
       selects exactly q13's ``like('%special%requests%')`` rows, then
       the comment bytes by priority; the arbiter's ``peakReserved`` and
       ``max_memory_allocated`` of the run;
    4. the cast round trip over lineitem: the int -> string -> long
       round trip keeps all 6,000,000 rows, a string built by concat
       parses to double and sums, a boolean round-trips through a
       string;
    5. fallback: run 2's select and ``cast(l_extendedprice as string)``
       in a session without test mode and without ``incompatibleOps``:
       the report names ``Lower``, ``StringReverse``, ``StringPad`` and
       the float cast with the JAX package's reasons, and the rows
       equal the device run's and the reference;
    6. every new expression alone at the batches of its scan, against
       its byte bound.

    Returns the counts of the runs, by name."""
    import pyarrow.compute as pc
    import torch
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.ops import regex_device as RXD
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    s = TpuSession(dict(SESSION_CONF, **STRINGS_CONF), device=dev)
    counts, lines = {}, {}

    def dfa_states(*patterns):
        return {p: int(RXD.compile_regex(p).table.shape[0])
                for p in patterns}

    def run(name, build, want, ordered=False, hashed=True):
        """A run's path: counts to 0, the cold run, read; against
        ``want``; ``STRINGS_WARM_RUNS`` warm runs equal to the cold
        one."""
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = build()
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] strings {name} " + json.dumps(c), flush=True)
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"strings {name}: plan rewrite fell back: {fb}")
        check(df._last_override.fallback_report() == [],
              f"strings {name}: {df._last_override.fallback_report()}")
        check(c["collision_fallbacks"] == 0,
              f"strings {name}: hash-collision fallbacks")
        check(not hashed or c["hash_pairs_launches"] > 0,
              f"strings {name}: hash_pairs was not launched")
        check(got.column_names == want.column_names,
              f"strings {name} columns {got.column_names}")
        if ordered:
            for cname in want.column_names:
                check(got[cname].to_pylist() == want[cname].to_pylist(),
                      f"strings {name}: column {cname} differs from the "
                      "pyarrow reference")
        else:
            check(rows_equal(got, want), f"strings {name} differs from "
                  f"its pyarrow reference:\n{got}\n{want}")
        warm = []
        for _ in range(STRINGS_WARM_RUNS):
            out, wall = timed(build())
            warm.append(wall)
            check(rows_equal(out, got, 0.0),
                  f"strings {name}: a warm run differs")
        lines[name] = line = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "hash_pairs_shapes": c["shapes"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": 0, "equal_reference": True}
        return got, line

    clear_scan_cache()
    customer, part = tables["customer"], tables["part"]
    orders, li = tables["orders"], tables["lineitem"]

    # -- 1. the phone-code report
    want = ref_phone_report(customer)
    check(want.num_rows > 0, "reference phone report is empty")
    _, line = run("phone report", lambda: phone_report(s, customer), want)
    line["dfa_states"] = dfa_states(PHONE_PATTERN)
    print("[strings] phone report " + json.dumps(line), flush=True)

    # -- 2. the part catalogue, as a select and grouped
    want = ref_catalogue(part)
    selected, line = run("catalogue", lambda: catalogue_query(s, part), want,
                         ordered=True, hashed=False)
    line["dfa_states"] = dfa_states(VOWELS, NAME_WORD)
    print("[strings] catalogue " + json.dumps(line), flush=True)
    want = ref_catalogue_grouped(part)
    _, line = run("catalogue grouped", lambda: catalogue_grouped(s, part),
                  want)
    line["dfa_states"] = dfa_states(NAME_WORD)
    line["tuple_hash"] = tuple_hash_times(s, part)
    print("[strings] catalogue grouped " + json.dumps(line), flush=True)

    # -- 3. the comment search, with the memory it takes
    def by_rlike():
        return s.createDataFrame(orders).filter(
            col("o_comment").rlike(COMMENT_PATTERN)).select("o_orderkey")

    def by_like():
        return s.createDataFrame(orders).filter(
            col("o_comment").like("%special%requests%")).select(
            "o_orderkey")

    torch.cuda.reset_peak_memory_stats(dev)
    want = ref_comment_search(orders)
    _, line = run("comment search", lambda: comment_search(s, orders), want)
    mgr = MM.peek_manager()
    line.update(peakReserved=mgr.metrics["peakReserved"],
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                dfa_states=dfa_states(COMMENT_PATTERN))
    rl, _ = timed(by_rlike())
    lk, _ = timed(by_like())
    ref_keys = orders.filter(pc.match_like(
        orders["o_comment"], "%special%requests%"))["o_orderkey"]
    check(rl.num_rows > 0 and sorted(rl["o_orderkey"].to_pylist())
          == sorted(lk["o_orderkey"].to_pylist())
          == sorted(ref_keys.to_pylist()),
          "strings comment search: rlike and q13's LIKE select different "
          "rows")
    line["rlike_rows_equal_like_rows"] = rl.num_rows
    print("[strings] comment search " + json.dumps(line), flush=True)

    # -- 4. the cast round trip
    wants = ref_cast_queries(li)
    check(wants["round trip"]["n"][0].as_py() == li.num_rows,
          "reference cast round trip lost rows")
    for name in ("round trip", "parsed sum", "flag count"):
        got, line = run(f"cast {name}",
                        lambda name=name: cast_queries(s, li)[name],
                        wants[name], hashed=False)
        if name == "round trip":
            check(got["n"][0].as_py() == li.num_rows
                  == int(6_000_000 * SF),
                  f"cast round trip kept {got['n'][0]} rows")
        line["result"] = got.to_pylist()[0]
        print(f"[strings] cast {name} " + json.dumps(line), flush=True)

    # -- 5. the same without test mode and without incompatibleOps
    plain = TpuSession({BLACKBOX_KEY: SESSION_CONF[BLACKBOX_KEY]},
                       device=dev)
    df = catalogue_query(plain, part)
    got, wall = timed(df)
    report = df._last_override.fallback_report()
    for cls, reason in INCOMPAT_REASONS.items():
        check(any(reason in r for r in report),
              f"strings fallback: no {cls} reason in {report}")
    check(got.equals(selected), "strings fallback: the catalogue differs "
          "from its device run")
    fb = df.fallback_summary()
    check(fb["fallback_ops"] > 0, f"strings fallback: {fb}")
    df2 = float_to_string(plain, li)
    got2, wall2 = timed(df2)
    report2 = df2._last_override.fallback_report()
    check(any(FLOAT_TO_STRING_REASON in r for r in report2),
          f"strings fallback: no float cast reason in {report2}")
    check(got2["price"].to_pylist()
          == ref_float_to_string(li)["price"].to_pylist(),
          "strings fallback: cast(l_extendedprice as string) differs from "
          "Java's format")
    line = {"catalogue": {"wall_s": wall, "fallback": fb,
                          "report": report, "equal_device_run": True},
            "cast l_extendedprice as string": {
                "rows": got2.num_rows, "wall_s": wall2,
                "fallback": df2.fallback_summary(), "report": report2,
                "equal_reference": True}}
    print("[strings] fallback " + json.dumps(line), flush=True)
    del got2

    # -- 6. each new expression alone
    for row in new_string_expr_times(tables, s):
        print("[strings] expression " + json.dumps(row), flush=True)
    clear_scan_cache()
    print(f"[strings] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


def tuple_hash_times(s, part) -> dict:
    """B.2's Python tuple-hash loop on run 2's grouped keys: the key
    columns evaluated on the card at the scan's batches, then
    ``ordering.group_sort_limbs`` (more than 3 limbs: four murmur3
    passes over each string key byte by byte) timed alone."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.ops import expressions as E
    from spark_rapids_tpu_torch.ops import ordering as O
    from spark_rapids_tpu_torch.ops import strings as S
    conf = s.rapids_conf()
    tbl = part.select(["p_name", "p_type"])
    batches = [host_to_device(tbl.slice(lo, conf.batch_rows), s.device,
                              min_bucket=conf.min_bucket_rows)
               for lo in range(0, tbl.num_rows, conf.batch_rows)]
    keys = [S.RegexpExtract(E.BoundReference(0, T.StringT), NAME_WORD, 0),
            S.Lower(E.BoundReference(1, T.StringT))]
    cols = [[k.eval(b) for k in keys] for b in batches]
    limbs = [O.group_sort_limbs(c, b.sel)[0] for c, b in zip(cols, batches)]
    return {"batches": [[int(b.capacity)] + [int(c.data.shape[1])
                                             for c in cs]
                        for b, cs in zip(batches, cols)],
            "limbs_after_hash": len(limbs[0]),
            "ms": cuda_ms(lambda: [O.group_sort_limbs(c, b.sel)
                                   for c, b in zip(cols, batches)],
                          iters=5)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events recorded
    around the call, one synchronize per call: the host's own time in
    ``fn`` counts.  Used for the plain versions (many small kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class KernelTimer:
    """Times one kernel launch by CUDA events with the host ahead of the
    device, so that the wrapper's host work before the launch is not in
    the time (the method of ``triton.testing.do_bench``)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.scratch = torch.empty((FLUSH_BYTES // 4,), dtype=torch.int32,
                                   device=device)
        # about 50 ms of memory traffic first, so that the card has left
        # its idle clocks before the first timed launch
        for _ in range(500):
            self.scratch.zero_()
        torch.cuda.synchronize()

    def _median(self, pairs) -> float:
        self.torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def cold_ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        """Each launch after a 256 MB write: L2 holds none of the
        inputs, and the write keeps the device busy while the host
        queues the launch.  No synchronize inside the loop."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.scratch.zero_()
            a, b = self._events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        return self._median(pairs)

    def warm_ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        """The same input back to back (L2 warm), behind a device sleep
        that lets the host queue every launch first."""
        for _ in range(warmup):
            fn()
        self.torch.cuda.synchronize()
        self.torch.cuda._sleep(GATE_CYCLES)
        pairs = []
        for _ in range(iters):
            a, b = self._events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        return self._median(pairs)

    def ring_ms(self, make_input, fn, in_bytes: int) -> float:
        """Mean time of one launch over a run of launches between two
        events, cycling through a ring of distinct inputs made by
        ``make_input()`` whose bytes (``in_bytes`` each) pass 2x the L2
        cache, so that no launch finds its input there: 100 launches, or
        one pass of the ring where the ring is longer.  The ring has at
        most ``RING_MAX`` entries, so below about 320 KB of input per
        launch it does not pass the L2 cache twice.  Every launch's
        output is kept, so that each writes memory of its own (one
        output block reused would let its writes stay in L2); an untimed
        run first fills the allocator's cache with those blocks.  A
        device sleep lets the host queue every launch first."""
        torch = self.torch
        n_ring = min(RING_MAX, max(2, math.ceil(RING_BYTES / in_bytes)))
        ring = [make_input() for _ in range(n_ring)]
        n_launch = max(RING_LAUNCHES, n_ring)
        kept = [fn(ring[i % n_ring]) for i in range(n_launch)]
        del kept
        torch.cuda.synchronize()
        torch.cuda._sleep(GATE_CYCLES)
        a, b = self._events()
        a.record()
        kept = [fn(ring[i % n_ring]) for i in range(n_launch)]
        b.record()
        b.synchronize()
        del kept
        return a.elapsed_time(b) / n_launch

    def host_us(self, fn, calls: int = 1000, chunk: int = 250) -> float:
        """The host's microseconds per call of ``fn``: ``calls`` calls in
        chunks of ``chunk``, each chunk timed by ``perf_counter`` behind a
        device sleep, so that the device never holds the host back."""
        torch = self.torch
        fn()
        total = 0.0
        for _ in range(calls // chunk):
            torch.cuda.synchronize()
            torch.cuda._sleep(5 * GATE_CYCLES)
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / (calls // chunk * chunk) * 1e6


def kernel_bound_ms(n_limbs: int, n: int) -> float:
    """Least time for hash_pairs: read L x n int64 limbs once, write n
    int64 hashes once, at the card's memory rate."""
    return (8 * n_limbs + 8) * n / H100_BYTES_PER_S * 1e3


def random_limbs(n_limbs: int, n: int, gen, dev):
    """Uniform 64-bit patterns (half with the top bit set), then the top
    bit forced on every other row."""
    import torch
    limbs = torch.randint(0, 256, (n_limbs, n, 8), dtype=torch.uint8,
                          device=dev, generator=gen).view(
                              torch.int64).squeeze(-1)
    limbs[:, ::2] |= -(1 << 63)
    return limbs


def hash_bytes(shapes) -> int:
    """Bytes that hash_pairs must move for row sets of ``(L, n)``."""
    return sum((8 * n_limbs + 8) * n for n_limbs, n in shapes)


def check_hash(CB, sets, name: str) -> None:
    """``hash_pairs_multi`` on ``sets`` (each an [L, n] tensor or a list
    of limbs on the card) equals the plain version bit for bit, in
    ceil(max L / LIMB_CAP) launches."""
    import torch
    before = CB.launches
    got = CB.hash_pairs_multi(sets)
    want = [CB.hash_pairs_plain(s) for s in sets]
    torch.cuda.synchronize()
    n_limbs = [len(s) for s in sets]
    check(CB.launches - before == -(-max(n_limbs) // CB.LIMB_CAP),
          f"{name}: {CB.launches - before} launches")
    for g, w in zip(got, want):
        mismatches = int((g != w).sum())
        check(mismatches == 0, f"hash_pairs {name}: {mismatches} rows "
              f"differ from the plain version")


def kernel_cases(CB, gen, dev):
    """The kernel against its plain version beyond the timed shapes:
    ``(name, sets)`` of every edge case, made one at a time."""
    for n_limbs in (1, 2, 3, 4):
        for n in ODD_NS:
            stacked = random_limbs(n_limbs, n, gen, dev)
            # rows of a stacked tensor with odd n: not 16-byte aligned
            yield (f"odd n, stacked L={n_limbs} n={n}", [stacked])
            # separate limbs: aligned, with a one-row tail
            yield (f"odd n, list L={n_limbs} n={n}",
                   [[l.clone() for l in stacked]])
        big = random_limbs(n_limbs, (1 << 18) + 1, gen, dev)
        yield (f"misaligned row views L={n_limbs} n=2^18",
               [[l[1:] for l in big]])
    for n_limbs in (CB.LIMB_CAP + 1, 2 * CB.LIMB_CAP + 1):
        for n in (4095, 1 << 20):
            yield (f"chained L={n_limbs} n={n}",
                   [random_limbs(n_limbs, n, gen, dev)])
    for (la, na), (lb, nb) in JOIN_PAIRS + (
            ((3, 1 << 20), (2, 4095)), ((CB.LIMB_CAP + 1, 1000), (1, 1 << 18))):
        yield (f"two sets L={la} n={na} + L={lb} n={nb}",
               [list(random_limbs(la, na, gen, dev)),
                random_limbs(lb, nb, gen, dev)])


def kernel_line(CB, timer, limbs, timed: bool) -> dict:
    """Bit-identity of the kernel against its plain version on
    ``limbs``; with ``timed``, the cold/warm kernel times, the bound and
    the plain version's time."""
    n_limbs, n = limbs.shape
    check_hash(CB, [limbs], f"L={n_limbs} n={n}")
    line = {"L": n_limbs, "n": n, "bit_identical": True,
            "bound_ms": kernel_bound_ms(n_limbs, n)}
    if timed:
        line["ms"] = timer.cold_ms(lambda: CB.hash_pairs(limbs))
        line["ms_warm"] = timer.warm_ms(lambda: CB.hash_pairs(limbs))
        line["plain_ms"] = cuda_ms(lambda: CB.hash_pairs_plain(limbs),
                                   iters=5)
    return line


def ptxas_summary(text: str) -> dict:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``'s
    report, by specialisation: ``L1``..``L4`` and the generic
    ``L<=8``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            t = re.search(r"hash_pairs_kernelILi(\d+)E", m.group(1))
            name = ("unknown" if t is None else
                    "L<=8" if t.group(1) == "0" else f"L{t.group(1)}")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# independent reference: pyarrow compute
# ---------------------------------------------------------------------------

def _date(y, m, d):
    import pyarrow as pa
    return pa.scalar(datetime.date(y, m, d), pa.date32())


def ref_q1(li):
    import pyarrow as pa
    import pyarrow.compute as pc
    f = li.filter(pc.less_equal(li["l_shipdate"], _date(1998, 9, 2)))
    disc = pc.multiply(f["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), f["l_discount"]))
    charge = pc.multiply(disc, pc.add(pa.scalar(1.0), f["l_tax"]))
    t = pa.table({"l_returnflag": f["l_returnflag"],
                  "l_linestatus": f["l_linestatus"],
                  "q": f["l_quantity"], "p": f["l_extendedprice"],
                  "dp": disc, "ch": charge, "d": f["l_discount"]})
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate(
        [("q", "sum"), ("p", "sum"), ("dp", "sum"), ("ch", "sum"),
         ("q", "mean"), ("p", "mean"), ("d", "mean"), ("q", "count")])
    names = ["sum_qty", "sum_base", "sum_disc", "sum_charge", "avg_qty",
             "avg_price", "avg_disc", "cnt"]
    aggs = ["q_sum", "p_sum", "dp_sum", "ch_sum", "q_mean", "p_mean",
            "d_mean", "q_count"]
    return pa.table([g["l_returnflag"], g["l_linestatus"]]
                    + [g[a] for a in aggs],
                    names=["l_returnflag", "l_linestatus"] + names)


def ref_q6(li):
    import pyarrow as pa
    import pyarrow.compute as pc
    m = pc.and_(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
        pc.less(li["l_shipdate"], _date(1995, 1, 1))),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.05),
                        pc.less_equal(li["l_discount"], 0.07)),
                pc.less(li["l_quantity"], 24.0)))
    f = li.filter(m)
    rev = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"]))
    return pa.table({"revenue": pa.array([rev.as_py()], pa.float64())})


def ref_q3(t):
    """q3 by pyarrow's hash join and group-by."""
    import pyarrow as pa
    import pyarrow.compute as pc
    cut = _date(1995, 3, 15)
    c = t["customer"]
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING")).select(
        ["c_custkey"])
    o = t["orders"]
    o = o.filter(pc.less(o["o_orderdate"], cut)).select(
        ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    li = t["lineitem"]
    li = li.filter(pc.greater(li["l_shipdate"], cut))
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": _rev(li)})
    j = c.join(o, keys="c_custkey", right_keys="o_custkey",
               join_type="inner")
    j = j.join(li, keys="o_orderkey", right_keys="l_orderkey",
               join_type="inner")
    g = j.group_by(["o_orderkey", "o_orderdate", "o_shippriority"]
                   ).aggregate([("rev", "sum")])
    g = g.sort_by([("rev_sum", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 10)
    return pa.table([g["o_orderkey"], g["o_orderdate"],
                     g["o_shippriority"], g["rev_sum"]],
                    names=["o_orderkey", "o_orderdate", "o_shippriority",
                           "revenue"])


def ref_q4(t):
    """q4 by pyarrow: the semi join as membership in the set of
    qualifying lineitem order keys."""
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 7, 1)),
        pc.less(o["o_orderdate"], _date(1993, 10, 1))))
    li = t["lineitem"]
    li = li.filter(pc.less(li["l_commitdate"], li["l_receiptdate"]))
    o = o.filter(pc.is_in(o["o_orderkey"],
                          value_set=pc.unique(li["l_orderkey"])))
    g = o.group_by("o_orderpriority").aggregate(
        [("o_orderkey", "count")]).sort_by("o_orderpriority")
    return pa.table([g["o_orderpriority"], g["o_orderkey_count"]],
                    names=["o_orderpriority", "order_count"])


def _rev(t):
    """``l_extendedprice * (1 - l_discount)`` of a lineitem table; over
    ``tpch.decimal_tables``' ``decimal(12,2)`` columns exactly, as
    ``decimal(18,4)`` made from the int64 cents (a row's value below
    1.1e9), so that pyarrow's decimal sums of it are exact."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if _is_dec(t["l_extendedprice"]):
        from spark_rapids_tpu_torch.columnar import dtypes as T
        from spark_rapids_tpu_torch.columnar.column import decimal_array
        p, d = _unscaled(t["l_extendedprice"]), _unscaled(t["l_discount"])
        return decimal_array(T.DecimalType(18, 4), p * (100 - d), None)
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), t["l_discount"]))


def _is_dec(c) -> bool:
    import pyarrow as pa
    return pa.types.is_decimal(c.type)


def _zero(c):
    """A 0 of ``c``'s type (a double or a decimal) for ``if_else``."""
    import decimal
    import pyarrow as pa
    return (pa.scalar(decimal.Decimal(0), c.type) if _is_dec(c)
            else pa.scalar(0.0))


def _as_double(c):
    """``c`` as float64: a decimal cast to double, as the engine casts
    one for double arithmetic and comparisons."""
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.cast(c, pa.float64()) if _is_dec(c) else c


def _sum_column(c):
    """The sum of ``c`` as a one-row column of its sum type: a double,
    or a decimal summed exactly."""
    import pyarrow as pa
    import pyarrow.compute as pc
    s = pc.sum(c)
    return pa.array([s.as_py()], s.type if _is_dec(c) else pa.float64())


def _between(c, lo, hi):
    import pyarrow.compute as pc
    return pc.and_(pc.greater_equal(c, lo), pc.less_equal(c, hi))


def _in(c, *values):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.is_in(c, value_set=pa.array(values))


def _year(c):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.cast(pc.year(c), pa.int32())


def ref_q5(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    r = t["region"]
    r = r.filter(pc.equal(r["r_name"], "ASIA")).select(["r_regionkey"])
    n = t["nation"].select(["n_nationkey", "n_regionkey", "n_name"])
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1994, 1, 1)),
        pc.less(o["o_orderdate"], _date(1995, 1, 1)))).select(
        ["o_orderkey", "o_custkey"])
    li = t["lineitem"]
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": _rev(li)})
    j = r.join(n, "r_regionkey", "n_regionkey", join_type="inner")
    j = j.join(t["customer"].select(["c_custkey", "c_nationkey"]),
               "n_nationkey", "c_nationkey", join_type="inner")
    j = j.join(o, "c_custkey", "o_custkey", join_type="inner")
    j = j.join(li, "o_orderkey", "l_orderkey", join_type="inner")
    g = j.group_by("n_name").aggregate([("rev", "sum")])
    return pa.table([g["n_name"], g["rev_sum"]],
                    names=["n_name", "revenue"])


def ref_q7(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    na, nb = "NATION_06", "NATION_07"
    n = t["nation"]
    n = n.filter(_in(n["n_name"], na, nb)).select(["n_nationkey",
                                                   "n_name"])
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n.rename_columns(["n1_key", "supp_nation"]), "s_nationkey",
        "n1_key", join_type="inner")
    cust = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n.rename_columns(["n2_key", "cust_nation"]), "c_nationkey",
        "n2_key", join_type="inner")
    o = t["orders"].select(["o_orderkey", "o_custkey"]).join(
        cust, "o_custkey", "c_custkey", join_type="inner")
    li = t["lineitem"]
    li = li.filter(_between(li["l_shipdate"], _date(1995, 1, 1),
                            _date(1996, 12, 31)))
    li = pa.table({"l_orderkey": li["l_orderkey"],
                   "l_suppkey": li["l_suppkey"],
                   "l_year": _year(li["l_shipdate"]), "volume": _rev(li)})
    j = li.join(o, "l_orderkey", "o_orderkey", join_type="inner")
    j = j.join(supp, "l_suppkey", "s_suppkey", join_type="inner")
    j = j.filter(pc.or_(
        pc.and_(pc.equal(j["supp_nation"], na),
                pc.equal(j["cust_nation"], nb)),
        pc.and_(pc.equal(j["supp_nation"], nb),
                pc.equal(j["cust_nation"], na))))
    g = j.group_by(["supp_nation", "cust_nation", "l_year"]).aggregate(
        [("volume", "sum")])
    return pa.table([g["supp_nation"], g["cust_nation"], g["l_year"],
                     g["volume_sum"]],
                    names=["supp_nation", "cust_nation", "l_year",
                           "revenue"])


def ref_q8(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    p = t["part"]
    p = p.filter(pc.equal(p["p_type"], "ECONOMY ANODIZED STEEL")).select(
        ["p_partkey"])
    o = t["orders"]
    o = o.filter(_between(o["o_orderdate"], _date(1995, 1, 1),
                          _date(1996, 12, 31)))
    o = pa.table({"o_orderkey": o["o_orderkey"],
                  "o_custkey": o["o_custkey"],
                  "o_year": _year(o["o_orderdate"])})
    r = t["region"]
    r = r.filter(pc.equal(r["r_name"], "AMERICA")).select(["r_regionkey"])
    n1 = t["nation"].select(["n_nationkey", "n_regionkey"]).join(
        r, "n_regionkey", "r_regionkey", join_type="inner")
    cust = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n1, "c_nationkey", "n_nationkey", join_type="inner")
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        t["nation"].select(["n_nationkey", "n_name"]), "s_nationkey",
        "n_nationkey", join_type="inner")
    li = t["lineitem"]
    li = pa.table({"l_orderkey": li["l_orderkey"],
                   "l_partkey": li["l_partkey"],
                   "l_suppkey": li["l_suppkey"], "volume": _rev(li)})
    j = (li.join(p, "l_partkey", "p_partkey", join_type="inner")
         .join(o, "l_orderkey", "o_orderkey", join_type="inner")
         .join(cust, "o_custkey", "c_custkey", join_type="inner")
         .join(supp, "l_suppkey", "s_suppkey", join_type="inner"))
    nat = pc.if_else(pc.equal(j["n_name"], "NATION_05"), j["volume"],
                     _zero(j["volume"]))
    j = pa.table({"o_year": j["o_year"], "nat": nat,
                  "volume": j["volume"]})
    g = j.group_by("o_year").aggregate([("nat", "sum"),
                                        ("volume", "sum")])
    return pa.table([g["o_year"], pc.divide(_as_double(g["nat_sum"]),
                                            _as_double(g["volume_sum"]))],
                    names=["o_year", "mkt_share"])


def ref_q10(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 10, 1)),
        pc.less(o["o_orderdate"], _date(1994, 1, 1)))).select(
        ["o_orderkey", "o_custkey"])
    li = t["lineitem"]
    li = li.filter(pc.equal(li["l_returnflag"], "R"))
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": _rev(li)})
    j = (t["customer"].select(["c_custkey", "c_nationkey", "c_name",
                               "c_acctbal"])
         .join(o, "c_custkey", "o_custkey", join_type="inner")
         .join(li, "o_orderkey", "l_orderkey", join_type="inner")
         .join(t["nation"].select(["n_nationkey", "n_name"]),
               "c_nationkey", "n_nationkey", join_type="inner"))
    g = j.group_by(["c_custkey", "c_name", "c_acctbal", "n_name"]
                   ).aggregate([("rev", "sum")])
    g = g.sort_by([("rev_sum", "descending")]).slice(0, 20)
    return pa.table([g["c_custkey"], g["c_name"], g["c_acctbal"],
                     g["n_name"], g["rev_sum"]],
                    names=["c_custkey", "c_name", "c_acctbal", "n_name",
                           "revenue"])


def ref_q11(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    n = t["nation"]
    n = n.filter(pc.equal(n["n_name"], "NATION_07")).select(
        ["n_nationkey"])
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n, "s_nationkey", "n_nationkey", join_type="inner")
    ps = t["partsupp"].join(supp, "ps_suppkey", "s_suppkey", join_type="inner")
    ps = pa.table({"ps_partkey": ps["ps_partkey"], "val": pc.multiply(
        ps["ps_supplycost"], pc.cast(ps["ps_availqty"], pa.float64()))})
    tot = pc.sum(ps["val"]).as_py() or 0.0
    g = ps.group_by("ps_partkey").aggregate([("val", "sum")])
    g = g.filter(pc.greater(g["val_sum"], 0.0001 * tot))
    return pa.table([g["ps_partkey"], g["val_sum"]],
                    names=["ps_partkey", "value"])


def ref_q12(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(pc.and_(pc.and_(
        _in(li["l_shipmode"], "MAIL", "SHIP"),
        pc.greater_equal(li["l_receiptdate"], _date(1994, 1, 1))),
        pc.and_(pc.less(li["l_receiptdate"], _date(1995, 1, 1)),
                pc.less(li["l_commitdate"], li["l_receiptdate"]))),
        pc.less(li["l_shipdate"], li["l_commitdate"]))).select(
        ["l_orderkey", "l_shipmode"])
    j = li.join(t["orders"].select(["o_orderkey", "o_orderpriority"]),
                "l_orderkey", "o_orderkey", join_type="inner")
    high = pc.cast(_in(j["o_orderpriority"], "1-URGENT", "2-HIGH"),
                   pa.int64())
    j = pa.table({"l_shipmode": j["l_shipmode"], "high": high,
                  "low": pc.subtract(1, high)})
    g = j.group_by("l_shipmode").aggregate([("high", "sum"),
                                            ("low", "sum")])
    return pa.table([g["l_shipmode"], g["high_sum"], g["low_sum"]],
                    names=["l_shipmode", "high_line_count",
                           "low_line_count"])


def ref_q15(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1996, 1, 1)),
        pc.less(li["l_shipdate"], _date(1996, 4, 1))))
    rev = pa.table({"supplier_no": li["l_suppkey"], "rev": _rev(li)})
    g = rev.group_by("supplier_no").aggregate([("rev", "sum")])
    top = g.filter(pc.greater_equal(g["rev_sum"], pc.max(g["rev_sum"])))
    supp = t["supplier"].select(["s_suppkey", "s_name", "s_address",
                                 "s_phone"])
    j = supp.join(top, "s_suppkey", "supplier_no", join_type="inner")
    return pa.table([j["s_suppkey"], j["s_name"], j["s_address"],
                     j["s_phone"], j["rev_sum"]],
                    names=["s_suppkey", "s_name", "s_address", "s_phone",
                           "total_revenue"])


def ref_q17(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    p = t["part"]
    p = p.filter(pc.and_(pc.equal(p["p_brand"], "Brand#23"),
                         pc.equal(p["p_container"], "MED BOX")))
    li = t["lineitem"].select(["l_partkey", "l_quantity",
                               "l_extendedprice"])
    li = li.filter(pc.is_in(li["l_partkey"], value_set=p["p_partkey"]))
    # a decimal quantity averages and compares as a double
    li = li.set_column(1, "l_quantity", _as_double(li["l_quantity"]))
    avg = li.group_by("l_partkey").aggregate([("l_quantity", "mean")])
    j = li.join(avg, "l_partkey", join_type="inner")
    j = j.filter(pc.less(j["l_quantity"],
                         pc.multiply(0.2, j["l_quantity_mean"])))
    s = pc.sum(j["l_extendedprice"]).as_py()
    s = None if s is None else float(s)
    return pa.table({"avg_yearly": pa.array(
        [None if s is None else s / 7.0], pa.float64())})


def ref_q18(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"].select(["l_orderkey", "l_quantity"])
    g = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = g.filter(pc.greater(g["l_quantity_sum"], 300.0))["l_orderkey"]
    o = t["orders"].select(["o_orderkey", "o_custkey", "o_orderdate",
                            "o_totalprice"])
    o = o.filter(pc.is_in(o["o_orderkey"], value_set=big))
    j = (t["customer"].select(["c_custkey", "c_name"])
         .join(o, "c_custkey", "o_custkey", join_type="inner")
         .join(li, "o_orderkey", "l_orderkey", join_type="inner"))
    g = j.group_by(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"]).aggregate([("l_quantity", "sum")])
    g = g.sort_by([("o_totalprice", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 100)
    return pa.table([g["c_name"], g["c_custkey"], g["o_orderkey"],
                     g["o_orderdate"], g["o_totalprice"],
                     g["l_quantity_sum"]],
                    names=["c_name", "c_custkey", "o_orderkey",
                           "o_orderdate", "o_totalprice", "sum_qty"])


def ref_q19(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(_in(li["l_shipmode"], "AIR", "REG AIR"),
                           pc.equal(li["l_shipinstruct"],
                                    "DELIVER IN PERSON")))
    li = pa.table({"l_partkey": li["l_partkey"],
                   "l_quantity": li["l_quantity"], "rev": _rev(li)})
    p = t["part"].select(["p_partkey", "p_brand", "p_container",
                          "p_size"])
    j = li.join(p, "l_partkey", "p_partkey", join_type="inner")

    def arm(brand, containers, qlo, qhi, shi):
        return pc.and_(pc.and_(pc.equal(j["p_brand"], brand),
                               _in(j["p_container"], *containers)),
                       pc.and_(_between(j["l_quantity"], qlo, qhi),
                               _between(j["p_size"], 1, shi)))

    m = pc.or_(pc.or_(
        arm("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
            1.0, 11.0, 5),
        arm("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
            10.0, 20.0, 10)),
        arm("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
            20.0, 30.0, 15))
    return pa.table({"revenue": _sum_column(j.filter(m)["rev"])})


def ref_q21(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"].select(["l_orderkey", "l_suppkey", "l_commitdate",
                               "l_receiptdate"])
    late = li.filter(pc.greater(li["l_receiptdate"], li["l_commitdate"])
                     ).select(["l_orderkey", "l_suppkey"])
    def ndistinct(t, key, name):
        g = t.group_by("l_orderkey").aggregate(
            [("l_suppkey", "count_distinct")])
        return pa.table({key: g["l_orderkey"],
                         name: g["l_suppkey_count_distinct"]})

    allcnt = ndistinct(li, "ak", "nsupp")
    latecnt = ndistinct(late, "lk", "nlate")
    o = t["orders"]
    fo = o.filter(pc.equal(o["o_orderstatus"], "F"))["o_orderkey"]
    n = t["nation"]
    n = n.filter(pc.equal(n["n_name"], "NATION_10")).select(
        ["n_nationkey"])
    supp = t["supplier"].select(["s_suppkey", "s_name", "s_nationkey"])
    supp = supp.join(n, "s_nationkey", "n_nationkey", join_type="inner")
    j = late.filter(pc.is_in(late["l_orderkey"], value_set=fo))
    j = j.join(allcnt, "l_orderkey", "ak", join_type="inner")
    j = j.join(latecnt, "l_orderkey", "lk", join_type="inner")
    j = j.filter(pc.and_(pc.greater_equal(j["nsupp"], 2),
                         pc.equal(j["nlate"], 1)))
    j = j.join(supp, "l_suppkey", "s_suppkey", join_type="inner")
    g = j.group_by("s_name").aggregate([("l_orderkey", "count")])
    g = g.sort_by([("l_orderkey_count", "descending"),
                   ("s_name", "ascending")]).slice(0, 100)
    return pa.table([g["s_name"], g["l_orderkey_count"]],
                    names=["s_name", "numwait"])


def _like(c, pattern):
    import pyarrow.compute as pc
    return pc.match_like(c, pattern)


def ref_q2(t):
    """q2 by pyarrow: the per-part minimum joined back on the part key,
    then held to the cost (min_cost is never null)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    r = t["region"]
    r = r.filter(pc.equal(r["r_name"], "EUROPE")).select(["r_regionkey"])
    n = t["nation"].select(["n_nationkey", "n_regionkey", "n_name"]).join(
        r, "n_regionkey", "r_regionkey", join_type="inner")
    supp = t["supplier"].select(["s_suppkey", "s_nationkey", "s_name",
                                 "s_acctbal", "s_address", "s_phone",
                                 "s_comment"]).join(
        n, "s_nationkey", "n_nationkey", join_type="inner")
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey",
                               "ps_supplycost"]).join(
        supp, "ps_suppkey", "s_suppkey", join_type="inner")
    p = t["part"]
    p = p.filter(pc.and_(pc.equal(p["p_size"], 15),
                         pc.ends_with(p["p_type"], "BRASS"))).select(
        ["p_partkey", "p_mfgr"])
    j = p.join(ps, "p_partkey", "ps_partkey", join_type="inner")
    g = j.group_by("p_partkey").aggregate([("ps_supplycost", "min")])
    g = pa.table({"mc_partkey": g["p_partkey"],
                  "min_cost": g["ps_supplycost_min"]})
    j = j.join(g, "p_partkey", "mc_partkey", join_type="inner")
    j = j.filter(pc.equal(j["ps_supplycost"], j["min_cost"]))
    names = ["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
             "s_address", "s_phone", "s_comment"]
    j = j.select(names).sort_by([
        ("s_acctbal", "descending"), ("n_name", "ascending"),
        ("s_name", "ascending"), ("p_partkey", "ascending")])
    return j.slice(0, 100)


def ref_q9(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    p = t["part"]
    green = p.filter(pc.match_substring(p["p_name"], "green"))["p_partkey"]
    li = t["lineitem"].select(["l_orderkey", "l_partkey", "l_suppkey",
                               "l_quantity", "l_extendedprice",
                               "l_discount"])
    li = li.filter(pc.is_in(li["l_partkey"], value_set=green))
    j = (li.join(t["supplier"].select(["s_suppkey", "s_nationkey"]),
                 "l_suppkey", "s_suppkey", join_type="inner")
         .join(t["partsupp"].select(["ps_partkey", "ps_suppkey",
                                     "ps_supplycost"]),
               ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"],
               join_type="inner")
         .join(t["orders"].select(["o_orderkey", "o_orderdate"]),
               "l_orderkey", "o_orderkey", join_type="inner")
         .join(t["nation"].select(["n_nationkey", "n_name"]),
               "s_nationkey", "n_nationkey", join_type="inner"))
    amount = pc.subtract(_as_double(_rev(j)), pc.multiply(
        j["ps_supplycost"], _as_double(j["l_quantity"])))
    j = pa.table({"nation": j["n_name"], "o_year": _year(j["o_orderdate"]),
                  "amount": amount})
    g = j.group_by(["nation", "o_year"]).aggregate([("amount", "sum")])
    return pa.table([g["nation"], g["o_year"], g["amount_sum"]],
                    names=["nation", "o_year", "sum_profit"])


def ref_q13(t):
    """q13 by pyarrow: orders per customer, customers without one
    counted as 0."""
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.invert(_like(o["o_comment"], "%special%requests%")))
    per = o.group_by("o_custkey").aggregate([("o_orderkey", "count")])
    per = pa.table({"ck": per["o_custkey"],
                    "n": per["o_orderkey_count"]})
    c = t["customer"].select(["c_custkey"]).join(
        per, "c_custkey", "ck", join_type="left outer")
    n = pc.fill_null(c["n"], 0)
    g = pa.table({"c_count": n, "x": n}).group_by("c_count").aggregate(
        [("x", "count")])
    return pa.table([g["c_count"], g["x_count"]],
                    names=["c_count", "custdist"])


def ref_q14(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1995, 9, 1)),
        pc.less(li["l_shipdate"], _date(1995, 10, 1))))
    li = pa.table({"l_partkey": li["l_partkey"], "rev": _rev(li)})
    j = li.join(t["part"].select(["p_partkey", "p_type"]), "l_partkey",
                "p_partkey", join_type="inner")
    promo = pc.if_else(_like(j["p_type"], "PROMO%"), j["rev"],
                       _zero(j["rev"]))
    s = (100.0 * float(pc.sum(promo).as_py())
         / float(pc.sum(j["rev"]).as_py()))
    return pa.table({"promo_revenue": pa.array([s], pa.float64())})


def ref_q16(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    s = t["supplier"]
    bad = s.filter(_like(s["s_comment"], "%Customer%Complaints%"))[
        "s_suppkey"]
    p = t["part"]
    p = p.filter(pc.and_(pc.and_(
        pc.not_equal(p["p_brand"], "Brand#45"),
        pc.invert(_like(p["p_type"], "MEDIUM POLISHED%"))),
        _in(p["p_size"], 49, 14, 23, 45, 19, 3, 36, 9))).select(
        ["p_partkey", "p_brand", "p_type", "p_size"])
    j = p.join(t["partsupp"].select(["ps_partkey", "ps_suppkey"]),
               "p_partkey", "ps_partkey", join_type="inner")
    j = j.filter(pc.invert(pc.is_in(j["ps_suppkey"], value_set=bad)))
    g = j.group_by(["p_brand", "p_type", "p_size"]).aggregate(
        [("ps_suppkey", "count_distinct")])
    return pa.table([g["p_brand"], g["p_type"], g["p_size"],
                     g["ps_suppkey_count_distinct"]],
                    names=["p_brand", "p_type", "p_size", "supplier_cnt"])


def ref_q20(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
        pc.less(li["l_shipdate"], _date(1995, 1, 1))))
    half = li.group_by(["l_partkey", "l_suppkey"]).aggregate(
        [("l_quantity", "sum")])
    p = t["part"]
    forest = p.filter(pc.starts_with(p["p_name"], "forest"))["p_partkey"]
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey", "ps_availqty"])
    ps = ps.filter(pc.is_in(ps["ps_partkey"], value_set=forest))
    ps = ps.join(half, ["ps_partkey", "ps_suppkey"],
                 ["l_partkey", "l_suppkey"], join_type="inner")
    ps = ps.filter(pc.greater(pc.cast(ps["ps_availqty"], pa.float64()),
                              pc.multiply(0.5, ps["l_quantity_sum"])))
    n = t["nation"]
    n = n.filter(pc.equal(n["n_name"], "NATION_03")).select(
        ["n_nationkey"])
    supp = t["supplier"].select(["s_suppkey", "s_name", "s_address",
                                 "s_nationkey"]).join(
        n, "s_nationkey", "n_nationkey", join_type="inner")
    supp = supp.filter(pc.is_in(supp["s_suppkey"],
                                value_set=pc.unique(ps["ps_suppkey"])))
    return supp.select(["s_name", "s_address"])


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def ref_q22_before_anti(t):
    """q22's customers in the seven country codes whose balance is above
    the codes' positive average: the input of its anti join."""
    import pyarrow as pa
    import pyarrow.compute as pc
    c = t["customer"]
    code = pc.utf8_slice_codeunits(c["c_phone"], 0, 2)
    c = pa.table({"c_custkey": c["c_custkey"], "c_acctbal": c["c_acctbal"],
                  "cntrycode": code})
    c = c.filter(_in(c["cntrycode"], *Q22_CODES))
    pos = c.filter(pc.greater(c["c_acctbal"], 0.0))["c_acctbal"]
    return c.filter(pc.greater(c["c_acctbal"], pc.mean(pos)))


def ref_q22(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    c = ref_q22_before_anti(t)
    c = c.filter(pc.invert(pc.is_in(
        c["c_custkey"], value_set=pc.unique(t["orders"]["o_custkey"]))))
    g = c.group_by("cntrycode").aggregate([("c_custkey", "count"),
                                           ("c_acctbal", "sum")])
    return pa.table([g["cntrycode"], g["c_custkey_count"],
                     g["c_acctbal_sum"]],
                    names=["cntrycode", "numcust", "totacctbal"])


# the join variants (utils/tpch.py::JOIN_VARIANTS): pyarrow's right and
# full outer joins, and a filter after an inner join (for q17_cond and
# q22_cond, their base queries' references are exactly that)
def ref_q13_right(t):
    """q13_right by pyarrow's right outer join."""
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.invert(_like(o["o_comment"], "%special%requests%")))
    j = o.select(["o_orderkey", "o_custkey"]).join(
        t["customer"].select(["c_custkey"]), keys="o_custkey",
        right_keys="c_custkey", join_type="right outer",
        coalesce_keys=False)
    per = j.group_by("c_custkey").aggregate([("o_orderkey", "count")])
    n = per["o_orderkey_count"]
    g = pa.table({"c_count": n, "x": n}).group_by("c_count").aggregate(
        [("x", "count")])
    return pa.table([g["c_count"], g["x_count"]],
                    names=["c_count", "custdist"])


ref_q17_cond = ref_q17
ref_q22_cond = ref_q22
# the ON-clause predicate of q13_cond's left join reads only orders, so
# it equals filtering orders before the join: q13's reference
ref_q13_cond = ref_q13


def ref_q3_full(t):
    """q3_full by pyarrow's full outer join."""
    import pyarrow as pa
    import pyarrow.compute as pc
    c = t["customer"]
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING")).select(
        ["c_custkey"])
    o = t["orders"]
    o = o.filter(pc.less(o["o_orderdate"], _date(1995, 3, 15))).select(
        ["o_orderkey", "o_custkey", "o_totalprice"])
    j = c.join(o, keys="c_custkey", right_keys="o_custkey",
               join_type="full outer", coalesce_keys=False)
    return pa.table({
        "n": pa.array([j.num_rows], pa.int64()),
        "n_cust": pa.array([pc.count(j["c_custkey"]).as_py()], pa.int64()),
        "n_orders": pa.array([pc.count(j["o_orderkey"]).as_py()],
                             pa.int64()),
        "total_price": _sum_column(j["o_totalprice"])})


def rows_equal(a, b, tol=1e-9):
    """Row multiset equality: floats within ``tol`` relative (absolute
    below 1), everything else exactly — the repository's oracle rule."""
    la = [tuple(r.values()) for r in a.to_pylist()]
    lb = [tuple(r.values()) for r in b.to_pylist()]
    if len(la) != len(lb):
        return False
    for x, y in zip(sorted(la, key=repr), sorted(lb, key=repr)):
        for u, v in zip(x, y):
            if isinstance(u, float) and isinstance(v, float):
                if abs(u - v) > tol * max(1.0, abs(u), abs(v)):
                    return False
            elif u != v:
                return False
    return True


def phase_times(df) -> dict:
    """H2D and D2H seconds of the last run, from the plan's metrics."""
    out = {"h2d_s": 0.0, "d2h_s": 0.0}
    for name, m in df.metrics():
        if name == "TpuScanExec":
            out["h2d_s"] += m.get("transferTime", 0.0)
        elif name == "DeviceToHostExec":
            out["d2h_s"] += m.get("transferTime", 0.0)
    return out


def join_strategies(df) -> list:
    """Each join of the last run's plan, root first: its type, planned
    broadcast side, and the run-time strategy metrics; a join the plan
    rewrite kept on the CPU (``CpuJoinExec``) has ``cpu`` set."""
    out = []

    def walk(node):
        if type(node).__name__ == "CpuJoinExec":
            out.append({"join_type": node.join_type, "broadcast": None,
                        "keys": len(node.left_keys), "cpu": True,
                        "streamedJoins": 0, "streamedLeftGroups": 0,
                        "streamedRightGroups": 0, "subPartitionJoins": 0,
                        "subPartitions": 0})
        if type(node).__name__ == "TpuSortMergeJoinExec":
            m = {k: v.value for k, v in node.metrics.items()}
            out.append({"join_type": node.join_type,
                        "broadcast": node.broadcast,
                        "keys": len(node.left_keys), "cpu": False,
                        "streamedJoins": m.get("streamedJoins", 0),
                        "streamedLeftGroups": m.get(
                            "streamedLeftGroups", 0),
                        "streamedRightGroups": m.get(
                            "streamedRightGroups", 0),
                        "subPartitionJoins": m.get(
                            "subPartitionJoins", 0),
                        "subPartitions": m.get("subPartitions", 0)})
        for c in node.children:
            walk(c)

    walk(df._last_plan)
    return out


# The JAX package's single-process plan at SF1, root join first (its
# exec/join.py::_convert_join broadcasts a side whose estimated size is
# within autoBroadcastJoinThreshold, 10 MB; TpuSortMergeJoinExec.execute
# then picks by live rows against join.targetRows, 2^18).  "bc right" /
# "bc left": the broadcast side; "streamed left" / "streamed right":
# the side cut into groups against the other, whole side; "sub": both
# sides over the row cap, hash sub-partitioned, and every left join
# that no side's broadcast covers (execute streams only inner and semi
# joins); "in-core": one join of both sides.  A prefix names the join
# type: "semi" a left semi join, "left" a left outer join, "anti" a left
# anti join, "cross" a join without keys ("cross" alone: the in-core
# cross product); every other join here is inner.  q21's semi join with
# orders is "sub": orders narrowed to (o_orderkey, o_orderstatus) is
# ~19 MB by estimate, and both its 5.2 M late lineitems and ~0.74 M
# finished orders pass 2^18 live rows.  The nearest to a threshold among
# the string queries: q2's filtered part (4 columns) is 1.04 of 10 MB by
# estimate (not broadcast), q16's 0.93 (broadcast), and q9's lineitems
# of green parts are ~0.96 of 2^18 live rows (the left side fits: the
# joins with partsupp and orders stream their right side).
STRATEGIES = {
    "q2": ("in-core", "in-core", "streamed right", "bc right", "bc right",
           "in-core", "streamed right", "bc right", "bc right"),
    "q5": ("streamed right", "in-core", "bc right", "bc right"),
    "q7": ("in-core", "streamed left", "streamed left", "bc right",
           "bc right"),
    "q8": ("bc right",) * 5 + ("streamed right", "bc right"),
    "q9": ("bc right", "streamed right", "streamed right", "bc right",
           "bc right"),
    "q10": ("bc right", "streamed right", "bc left"),
    "q11": ("cross", "streamed left", "bc right", "streamed left",
            "bc right"),
    "q12": ("streamed right",),
    "q13": ("left sub",),
    "q14": ("bc right",),
    "q15": ("bc right", "cross"),
    "q16": ("anti bc right", "bc left"),
    "q17": ("in-core", "semi bc right", "semi bc right"),
    "q18": ("streamed right", "bc left", "semi streamed left"),
    "q19": ("bc right",),
    "q20": ("semi in-core", "bc right", "streamed right", "semi bc right"),
    "q21": ("in-core", "sub", "sub", "semi sub", "bc right"),
    "q22": ("anti streamed right", "cross bc right"),
}
_JOIN_PREFIX = {"semi": "left_semi", "left": "left", "anti": "left_anti",
                "cross": "cross", "right": "right", "full": "full"}
# the join variants' plans at SF1: q13_right's right join runs as q13's
# left join with the sides swapped (its strategy metrics are forwarded to
# the right join's node) and sub-partitions; q3_full's full join must not
# stream, its left side fits the row cap and its right side (~727k live
# orders) does not: it sub-partitions into k = 3; q17_cond and q22_cond
# keep their base queries' strategies ("cross" names a join without an
# equi key, here an inner join with a condition); q13_cond's left join
# with a residual condition stays on the CPU ("cpu": CpuJoinExec)
VARIANT_STRATEGIES = {
    "q13_right": ("right sub",),
    "q17_cond": STRATEGIES["q17"],
    "q22_cond": STRATEGIES["q22"],
    "q3_full": ("full sub",),
    "q13_cond": ("left cpu",),
}
VARIANT_SUB_PARTITIONS = {"q3_full": 3}


def _strategy_holds(want: str, j: dict) -> bool:
    jt = "inner"
    head, _, rest = want.partition(" ")
    if head in _JOIN_PREFIX:
        jt, want = _JOIN_PREFIX[head], rest or "in-core"
    if jt == "cross" and j["join_type"] == "inner" and j["keys"] == 0:
        jt = "inner"  # an inner join without an equi key: a cross product
    if j["join_type"] != jt or j["cpu"] != (want == "cpu"):
        return False
    if want == "cpu":
        return True
    streamed = (j["streamedJoins"], j["streamedLeftGroups"] > 0,
                j["streamedRightGroups"] > 0)
    if want.startswith("bc "):
        return (j["broadcast"] == want[3:] and j["streamedJoins"] == 0
                and j["subPartitionJoins"] == 0)
    if j["broadcast"] is not None:
        return False
    if want == "streamed left":
        return streamed == (1, True, False) and not j["subPartitionJoins"]
    if want == "streamed right":
        return streamed == (1, False, True) and not j["subPartitionJoins"]
    if want == "sub":
        return streamed == (0, False, False) and j["subPartitionJoins"] == 1
    return (streamed == (0, False, False)  # in-core
            and j["subPartitionJoins"] == 0)


def check_strategies(q: str, joins: list) -> None:
    """The JAX package's single-process plan at SF1 (exec/join.py::
    _convert_join and TpuSortMergeJoinExec.execute)."""
    if q == "q3":
        check(len(joins) == 2, f"q3 has {len(joins)} joins")
        outer, inner = joins
        # customer (~3 MB narrowed) fits autoBroadcastJoinThreshold:
        # broadcast left, orders streamed in groups of targetRows
        check(inner["broadcast"] == "left"
              and inner["streamedRightGroups"] > 0
              and inner["streamedJoins"] == 0,
              f"q3 customer x orders strategy {inner}")
        # no side small by estimate; at run time the left side's live
        # rows fit targetRows: left whole, lineitem streamed
        check(outer["broadcast"] is None and outer["streamedJoins"] == 1
              and outer["streamedRightGroups"] > 0
              and outer["streamedLeftGroups"] == 0,
              f"q3 x lineitem strategy {outer}")
    elif q == "q4":
        check(len(joins) == 1, f"q4 has {len(joins)} joins")
        (semi,) = joins
        # left small at run time, semi join: _semi_stream_right
        check(semi["join_type"] == "left_semi"
              and semi["broadcast"] is None and semi["streamedJoins"] == 1
              and semi["streamedRightGroups"] > 0
              and semi["streamedLeftGroups"] == 0,
              f"q4 strategy {semi}")
    elif q in STRATEGIES:
        want = STRATEGIES[q]
        check(len(joins) == len(want), f"{q} has {len(joins)} joins")
        for i, (w, j) in enumerate(zip(want, joins)):
            check(_strategy_holds(w, j),
                  f"{q} join {i} (root first): want {w}, got {j}")
    else:
        check(not joins, f"{q} has joins")


def check_variant_strategies(v: str, joins: list) -> None:
    want = VARIANT_STRATEGIES[v]
    check(len(joins) == len(want), f"{v} has {len(joins)} joins")
    for i, (w, j) in enumerate(zip(want, joins)):
        check(_strategy_holds(w, j),
              f"{v} join {i} (root first): want {w}, got {j}")
    if v in VARIANT_SUB_PARTITIONS:
        check(joins[0]["subPartitions"] == VARIANT_SUB_PARTITIONS[v],
              f"{v}: k = {joins[0]['subPartitions']}, want "
              f"{VARIANT_SUB_PARTITIONS[v]}")


def build_on(q: str, session, tables):
    """A query or join variant of ``utils/tpch.py`` over ``tables`` (q1
    and q6 take lineitem alone)."""
    from spark_rapids_tpu_torch.utils import tpch
    return tpch.build(q, session, tables)


def scan_transfer_times(df) -> list:
    """Each scan's ``transferTime`` in the last run (0 when it read the
    scan cache)."""
    return [m.get("transferTime", 0.0) for name, m in df.metrics()
            if name == "TpuScanExec"]


def cache_entries() -> list:
    """(column names, spillable batch) of every cached scan batch."""
    from spark_rapids_tpu_torch.exec import basic as B
    return [(sp.schema.field_names(), sp)
            for entries in list(B._scan_cache.values())
            for pairs in entries.values() for sp, _ in pairs]


DICT_COLUMNS = ("l_returnflag", "l_linestatus", "l_shipmode",
                "l_shipinstruct")


def dictionary_lineitem(li):
    """lineitem with its four low-cardinality string columns
    dictionary-encoded."""
    import pyarrow.compute as pc
    for name in DICT_COLUMNS:
        li = li.set_column(li.column_names.index(name), name,
                           pc.dictionary_encode(li[name]))
    return li


STRING_QUERIES = ("q2", "q9", "q13", "q14", "q16", "q20", "q22")
_STRING_NODES = ("Like", "StartsWith", "EndsWith", "Contains", "Substring")


def string_op_times(df) -> list:
    """The last run's filters and projects that hold a string pattern
    expression, with their ``opTime`` (the host's time in the operator:
    it queues the device work and waits only where a tensor is read
    back), and the ``transferTime`` of the scans below them."""
    out = []

    def walk(node):
        name = type(node).__name__
        text = node.node_string()
        if (name in ("TpuFilterExec", "TpuProjectExec")
                and any(k + "(" in text for k in _STRING_NODES)):
            out.append({"node": text,
                        "opTime_s": node.metrics["opTime"].value})
        if name == "TpuScanExec":
            out.append({"scan": node.schema.field_names(),
                        "transferTime_s": node.metrics.get(
                            "transferTime").value
                        if "transferTime" in node.metrics else 0.0})
        for c in node.children:
            walk(c)

    walk(df._last_plan)
    return [o for o in out if "node" in o or any(
        f in ("o_comment", "p_name", "p_type", "c_phone", "s_comment")
        for f in o["scan"])]


def string_expr(kind: str, arg):
    """The expression of a ``STRING_EXPRS`` entry over input column 0."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.ops import expressions as E
    from spark_rapids_tpu_torch.ops import strings as S
    ref = E.BoundReference(0, T.StringT)
    if kind == "substring":
        return S.Substring(ref, *arg)
    if kind in ("like", "not like"):
        e = S.Like(ref, arg)
        return E.Not(e) if kind == "not like" else e
    return S.StringPredicate(kind, ref, E.Literal(arg, T.StringT))


def string_expr_times(tables, session) -> list:
    """Each of ``STRING_EXPRS`` on the card at SF1: the column's H2D alone
    in the scan's batches (host matrix build and copy, median of 3
    synchronised runs), then the expression over those batches
    (``cuda_ms``: events around the calls, host time included); the
    bound is the bytes it must move (matrix and lengths read once, the
    result written once) over the memory rate."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    conf = session.rapids_conf()
    rows = []
    for q, table, column, kind, arg in STRING_EXPRS:
        tbl = tables[table].select([column])

        def h2d():
            return [host_to_device(tbl.slice(lo, conf.batch_rows),
                                   session.device,
                                   min_bucket=conf.min_bucket_rows)
                    for lo in range(0, tbl.num_rows, conf.batch_rows)]

        h2d_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = h2d()
            torch.cuda.synchronize()
            h2d_s.append(time.perf_counter() - t0)
        expr = string_expr(kind, arg)
        outs = [expr.eval(b) for b in batches]
        out_bytes = sum(o.data.numel() * o.data.element_size()
                        + (0 if o.lengths is None else 4 * o.capacity)
                        for o in outs)
        in_bytes = sum(b.columns[0].data.numel() + 4 * b.capacity
                       for b in batches)
        ms = cuda_ms(lambda: [expr.eval(b) for b in batches],
                     iters=EXPR_TIMING_ITERS)
        rows.append({
            "query": q, "column": column, "expression": f"{kind} {arg!r}",
            "rows": tbl.num_rows,
            "batches": [list(b.columns[0].data.shape) for b in batches],
            "h2d_s": statistics.median(h2d_s), "expr_ms": ms,
            "bound_ms": (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3,
            "true_rows": None if kind == "substring" else int(sum(
                (o.data & b.sel).sum() for o, b in zip(outs, batches)))})
        del batches, outs
    return rows


def timed(df):
    """Run a DataFrame on its device: (result, wall seconds), the device
    synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = df.toArrow()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def path_counts(df, CB, KN) -> dict:
    """The kernel's launches in the run just made (the counts were set
    to 0 just before it), and its joins' strategies."""
    return {
        "hash_pairs_launches": CB.launches,
        "shapes": {f"{l}x{n}": c for (l, n), c
                   in sorted(CB.launch_shapes.items())},
        "cuda_rung_dispatches": KN.COUNTERS.dispatches["cuda"],
        "jnp_rung_dispatches": KN.COUNTERS.dispatches["jnp"],
        "collision_fallbacks": KN.COUNTERS.fallbacks,
        "joins": join_strategies(df)}


def check_result(name: str, got, want) -> None:
    """Columns and rows equal to the pyarrow reference, floats finite."""
    import numpy as np
    import pyarrow as pa
    check(got.column_names == want.column_names,
          f"{name} columns {got.column_names}")
    check(rows_equal(got, want),
          f"{name} differs from the pyarrow reference:\n{got}\n{want}")
    for c in got.columns:
        if pa.types.is_floating(c.type):
            check(bool(np.isfinite(c.to_numpy()).all()),
                  f"{name} has non-finite values")


# warm runs of each of the 22 at the main path's conf: one, since
# [planes]' 22 under bench's conf take ~150 s of the script's time
MAIN_WARM_RUNS = 1


def query_phase(q, session, exact, tables, ref, CB, KN):
    """One TPC-H query: the scan cache cleared, its cold run (the main
    path: the kernel's counts set to 0 just before it and read just
    after), ``MAIN_WARM_RUNS`` warm runs that must read every scan from
    the cache, and
    the exact rung.  Returns (cold result, counts, summary)."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    cold_df = build_on(q, session, tables)
    got, cold_wall = timed(cold_df)
    counts = path_counts(cold_df, CB, KN)
    print(f"[main path] {q} " + json.dumps(counts), flush=True)
    check(counts["collision_fallbacks"] == 0,
          f"{q}: {counts['collision_fallbacks']} hash-collision fallbacks")
    check_strategies(q, counts["joins"])
    check_result(q, got, ref)
    fallback = cold_df.fallback_summary()
    check(fallback["fallback_ops"] == 0 and fallback["device_ops"] > 0,
          f"{q}: plan rewrite fell back: {fallback}")
    cold_ph = phase_times(cold_df)
    walls, phases, metrics, plan_ms = [], [], [], []
    for _ in range(MAIN_WARM_RUNS):
        df = build_on(q, session, tables)
        out, wall = timed(df)
        walls.append(wall)
        plan_ms.append(df.plan_ms)
        phases.append(phase_times(df))
        metrics.append(df.metrics())
        check(rows_equal(out, ref), f"{q} warm run differs")
        check(all(t == 0 for t in scan_transfer_times(df)),
              f"{q}: a warm scan missed the cache: "
              f"{scan_transfer_times(df)}")
    check(rows_equal(build_on(q, exact, tables).toArrow(), got),
          f"{q}: cuda rung != jnp rung")
    i = walls.index(statistics.median(walls))
    ph = phases[i]
    print(f"[overrides] {q} " + json.dumps(dict(
        fallback, plan_ms_cold=cold_df.plan_ms,
        plan_ms_warm=statistics.median(plan_ms), plan_ms=plan_ms)),
        flush=True)
    print(f"[{q} metrics] " + json.dumps(metrics[i]), flush=True)
    rows = tables["lineitem"].num_rows
    summary = {
        "lineitem_rows": rows,
        "cold_wall_s": cold_wall, "cold_h2d_s": cold_ph["h2d_s"],
        "cold_h2d_share": cold_ph["h2d_s"] / cold_wall,
        "wall_s_median": walls[i], "wall_s": walls,
        "h2d_s": ph["h2d_s"], "d2h_s": ph["d2h_s"],
        "execute_s": walls[i] - ph["h2d_s"] - ph["d2h_s"],
        "plan_ms": statistics.median(plan_ms),
        "rows_per_s": rows / walls[i],
        "hash_pairs_launches": counts["hash_pairs_launches"],
        "matches_reference": True, "cuda_equals_jnp_rung": True,
        "warm_scans_cached": True}
    if q in STRING_QUERIES:
        summary["string_ops"] = string_op_times(cold_df)
    print(f"[{q}] SF{SF:g} cold {cold_wall:.4f} s, warm {walls[i]:.4f} s "
          + json.dumps(summary), flush=True)
    return got, counts, summary


def resident_phase(session, tables, refs, dev) -> dict:
    """Every query once more, the cache not cleared, so that all 22
    queries' tables are resident at once: the default budget must hold
    them without a spill."""
    import torch
    from spark_rapids_tpu_torch.exec import basic as B
    from spark_rapids_tpu_torch.runtime import memory as MM
    t0 = time.perf_counter()
    for q in QUERIES:
        check(rows_equal(build_on(q, session, tables).toArrow(), refs[q]),
              f"{q} differs in the resident pass")
    torch.cuda.synchronize()
    mgr = MM.peek_manager()
    cached = cache_entries()
    out = {
        "pass_s": time.perf_counter() - t0, "budget": mgr.budget,
        "peakReserved": mgr.metrics["peakReserved"],
        "reserved": mgr._reserved,
        "cached_bytes": sum(sp.nbytes for _, sp in cached),
        "cache_entries": len(B._scan_cache),
        "cached_batches": len(cached),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "spillToHostBytes": mgr.metrics["spillToHostBytes"],
        "retryOOMs": mgr.metrics["retryOOMs"]}
    print("[scan cache] " + json.dumps(out), flush=True)
    check(out["spillToHostBytes"] == 0 and out["retryOOMs"] == 0,
          "the default budget spilled with all 22 queries cached")
    check(all(sp.tier == "device" for _, sp in cached),
          "a cache entry is not on the device")
    return out


Q3_LINEITEM = ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"]


def spill_phase(session, conf, tables, ref, first, n_batches, dev) -> dict:
    """q3 twice in a fresh manager whose pool holds about 1.5 of the
    lineitem batches q3 caches (or q3's largest single reservation, if
    that is more): the first run's registrations and join reservations
    spill the oldest entries to host, the second run restores them.
    Both results must equal q3's; the default manager comes back after
    (which clears the cache).  ``conf`` is ``session``'s conf."""
    from spark_rapids_tpu_torch.exec import basic as B
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.sql.session import TpuSession
    mgr = MM.peek_manager()
    batch = [sp.nbytes for names, sp in cache_entries()
             if names == Q3_LINEITEM]
    check(len(batch) == n_batches, f"q3's lineitem batches: {batch}")
    largest = []
    reserve = mgr.reserve

    def recording(nbytes, _restoring=None):
        largest.append(nbytes)
        return reserve(nbytes, _restoring)

    clear_scan_cache()
    mgr.reserve = recording  # q3's largest single reservation
    check(rows_equal(build_on("q3", session, tables).toArrow(), ref),
          "q3 differs while its reservations were read")
    del mgr.reserve
    pool = max(int(1.5 * batch[0]), int(1.05 * max(largest)))
    small = TpuSession(dict(conf, **{"spark.rapids.tpu.memory.poolSize":
                                     pool}), device=dev)
    out = {"pool": pool, "lineitem_batch_bytes": batch[0],
           "largest_reservation": max(largest), "walls_s": [],
           "h2d_s": [], "runs": []}
    for _ in range(2):
        df = build_on("q3", small, tables)
        got, wall = timed(df)
        out["walls_s"].append(wall)
        out["h2d_s"].append(phase_times(df)["h2d_s"])
        smgr = MM.peek_manager()
        out["runs"].append({k: smgr.metrics[k] for k in (
            "spillToHostBytes", "restoredBytes", "peakReserved",
            "retryOOMs")})
        check(rows_equal(got, ref) and rows_equal(got, first, tol=0.0),
              "q3 under the small pool differs")
    print("[spill] " + json.dumps(out), flush=True)
    check(smgr.budget == pool, f"spill manager budget {smgr.budget}")
    check(out["runs"][0]["spillToHostBytes"] > 0,
          "q3 under the small pool spilled nothing")
    check(out["runs"][1]["restoredBytes"] > 0,
          "q3's second run under the small pool restored nothing")
    MM.get_manager(session.rapids_conf(), dev)
    check(MM.peek_manager().budget == mgr.budget and not B._scan_cache,
          "the default manager was not restored")
    return out


# -- [retry]: OOM retry, the disk tier, the aggregate's bounded passes -----

# q3_full's pool in multiples of its largest sub-partition pair's bytes
SUB_POOL_PAIRS = 1.5
AGG_REPORTED = ("skippedAggPasses", "repartitionMerges", "partialTime",
                "decideTime", "mergeTime", "numOutputBatches")
EARLIER_WARM_S = {"q18": 1.7408, "q3": 0.40}  # PERF.md, the previous slice


def find_nodes(node, name) -> list:
    """Every node of a plan named ``name``, root first."""
    out = [node] if type(node).__name__ == name else []
    for c in node.children:
        out += find_nodes(c, name)
    return out


def _caller_outside(paths):
    """The first frame above this one whose file is not in ``paths``."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith(paths):
        f = f.f_back
    return f


def recorded_reservations(run, probe=lambda mgr: None) -> list:
    """``run()`` with every arbiter reservation recorded: (allocation
    index, bytes, calling function, its file, ``probe(manager)`` just
    before) — the caller is the first frame outside the arbiter and
    ``contextlib``."""
    from spark_rapids_tpu_torch.runtime import memory as MM
    seen = []
    reserve = MM.DeviceMemoryManager.reserve

    def recording(self, nbytes, _restoring=None):
        f = _caller_outside((os.path.join("runtime", "memory.py"),
                             "contextlib.py"))
        state = probe(self)
        reserve(self, nbytes, _restoring)
        seen.append((self._alloc_count, nbytes, f.f_code.co_name,
                     f.f_code.co_filename, state))

    MM.DeviceMemoryManager.reserve = recording
    try:
        run()
    finally:
        MM.DeviceMemoryManager.reserve = reserve
    return seen


def retry_run(name, q, session, tables, ref, CB, KN) -> tuple:
    """One run of the phase as a path of its own: the scan cache cleared
    and the kernel's counts set to 0 just before, read just after; the
    result against the pyarrow reference with 0 fallback operators.
    Returns (result, wall, counts, DataFrame)."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = build_on(q, session, tables)
    got, wall = timed(df)
    counts = path_counts(df, CB, KN)
    print(f"[main path] retry {name} " + json.dumps(counts), flush=True)
    check(counts["collision_fallbacks"] == 0,
          f"retry {name}: hash-collision fallbacks")
    check(counts["hash_pairs_launches"] > 0,
          f"retry {name}: hash_pairs was not launched")
    check_result(f"retry {name}", got, ref)
    fallback = df.fallback_summary()
    check(fallback["fallback_ops"] == 0 and fallback["device_ops"] > 0,
          f"retry {name}: plan rewrite fell back: {fallback}")
    return got, wall, counts, df


def agg_metrics(df) -> list:
    """Each aggregate's pass metrics and key count, root first."""
    return [dict({k: a.metric(k).value for k in AGG_REPORTED},
                 keys=len(a.grouping))
            for a in find_nodes(df._last_plan, "TpuHashAggregateExec")]


def retry_phase(session, tables, refs, first, summary, spill, n_batches,
                dev, CB, KN) -> dict:
    """The memory runtime under the main path at SF1, five runs, each a
    path of its own under ``test.enabled``: q3 twice with the host tier
    at one lineitem batch (the disk tier: CRC-checked restores, an empty
    spill directory after), q1 under a pool below one scan batch (split
    retries), q18 with an OOM injected at its first aggregate
    reservation, q3/q10/q18's aggregate passes at the default conf
    (q18's inner aggregate's merge repartitions), and ``q3_full`` under
    a pool of about 1.5 of its largest sub-partition pair (its slices
    spill).  The default manager
    comes back after (which clears the cache).  Returns each run's
    counts."""
    import shutil
    import tempfile
    from spark_rapids_tpu_torch.exec import basic as B
    from spark_rapids_tpu_torch.exec import join as J
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    default_budget = MM.peek_manager().budget
    counts = {}

    def small(**conf):
        return TpuSession(dict(SESSION_CONF, **conf), device=dev)

    # -- 1. disk tier: q3 twice, the host tier at one lineitem batch ------
    root = tempfile.mkdtemp(prefix="tpuq-spill-")
    verified, files = [], [0]
    verify = MM._verify_crc_sidecar
    to_disk = MM.SpillableBatch.spill_to_disk

    def verifying(path):
        verified.append(os.path.exists(path + ".crc32"))
        return verify(path)

    def counting(self):
        freed = to_disk(self)
        files[0] = max(files[0], len(os.listdir(self._mgr.spill_path)))
        return freed

    MM._verify_crc_sidecar = verifying
    MM.SpillableBatch.spill_to_disk = counting
    disk = small(**{"spark.rapids.tpu.memory.poolSize": spill["pool"],
                    "spark.rapids.memory.host.spillStorageSize":
                        spill["lineitem_batch_bytes"],
                    "spark.rapids.tpu.spillPath": root})
    runs = []
    try:
        for i in range(2):
            if i == 0:
                got, wall, counts["disk tier"], _ = retry_run(
                    "disk tier", "q3", disk, tables, refs["q3"], CB, KN)
            else:
                got, wall = timed(build_on("q3", disk, tables))
            check(rows_equal(got, first["q3"], tol=0.0),
                  f"q3 run {i + 1} with the disk tier differs from q3")
            m = MM.peek_manager()
            runs.append(dict({k: m.metrics[k] for k in (
                "spillToHostBytes", "spillToDiskBytes", "restoredBytes",
                "retryOOMs", "peakReserved")}, wall_s=wall))
        mgr = MM.peek_manager()
        clear_scan_cache()
        left = (os.listdir(mgr.spill_path)
                if os.path.isdir(mgr.spill_path) else [])
    finally:
        MM._verify_crc_sidecar = verify
        MM.SpillableBatch.spill_to_disk = to_disk
        shutil.rmtree(root, ignore_errors=True)
    line = {"pool": spill["pool"],
            "host_limit": spill["lineitem_batch_bytes"], "runs": runs,
            "disk_restores_crc_checked": len(verified),
            "peak_spill_files": files[0], "files_left": len(left),
            "reserved_after_clear": mgr._reserved}
    print("[retry] disk tier " + json.dumps(line), flush=True)
    check(mgr.budget == spill["pool"], "disk-tier manager budget")
    check(runs[-1]["spillToDiskBytes"] > 0, "q3 spilled nothing to disk")
    check(runs[-1]["restoredBytes"] > 0, "q3 restored nothing")
    check(verified and all(verified),
          f"a disk restore had no CRC sidecar: {verified}")
    check(not left, f"spill files left after the cache was cleared: {left}")

    # -- 2. split retry: q1 under a pool of 0.75 of one scan batch --------
    MM.get_manager(session.rapids_conf(), dev)
    clear_scan_cache()
    build_on("q1", session, tables).toArrow()
    batch = max(sp.nbytes for names, sp in cache_entries()
                if "l_returnflag" in names)
    split = small(**{"spark.rapids.tpu.memory.poolSize":
                     int(0.75 * batch)})
    got, wall, counts["split retry"], _ = retry_run(
        "split retry", "q1", split, tables, refs["q1"], CB, KN)
    m = MM.peek_manager().metrics
    line = {"pool": int(0.75 * batch), "scan_batch_bytes": batch,
            "wall_s": wall, "q1_warm_wall_s": summary["q1"]["wall_s_median"],
            "splitRetries": m["splitRetries"], "retryOOMs": m["retryOOMs"],
            "scan_batches": n_batches, "cached_batches": len(cache_entries())}
    print("[retry] split retry " + json.dumps(line), flush=True)
    check(m["splitRetries"] >= n_batches,
          f"q1 split {m['splitRetries']} times over {n_batches} batches")

    # -- 3. an OOM injected at q18's first aggregate reservation -----------
    MM.reset_manager()
    clear_scan_cache()
    seen = recorded_reservations(
        lambda: build_on("q18", session, tables).toArrow())
    agg = [i for i, _, _, f, _ in seen
           if f.endswith(os.path.join("exec", "aggregate.py"))]
    check(bool(agg), "q18 made no aggregate reservation")
    inject = small(**{"spark.rapids.tpu.test.injectOomAtAlloc": agg[0]})
    got, wall, counts["injected oom"], _ = retry_run(
        "injected oom", "q18", inject, tables, refs["q18"], CB, KN)
    check(rows_equal(got, first["q18"]), "q18 under injection differs")
    m = MM.peek_manager().metrics
    line = {"inject_at": agg[0], "reservations": len(seen),
            "wall_s": wall, "retryOOMs": m["retryOOMs"],
            "splitRetries": m["splitRetries"],
            "spillToHostBytes": m["spillToHostBytes"]}
    print("[retry] injected oom " + json.dumps(line), flush=True)
    check(m["retryOOMs"] >= 1, "the injected OOM was not retried")

    # -- 4. the aggregate's passes at the default conf ---------------------
    MM.get_manager(session.rapids_conf(), dev)
    for q in ("q3", "q10", "q18"):
        got, wall, counts[f"passes {q}"], df = retry_run(
            f"passes {q}", q, session, tables, refs[q], CB, KN)
        aggs = agg_metrics(df)
        line = {"cold_wall_s": wall,
                "warm_wall_s": summary[q]["wall_s_median"],
                "earlier_warm_wall_s": EARLIER_WARM_S.get(q),
                "aggregates": aggs}
        print(f"[retry] aggregate passes {q} " + json.dumps(line),
              flush=True)
    # q18's inner aggregate: 1.5M groups of 6M rows, one key
    inner = [a for a in aggs if a["keys"] == 1]
    check(len(inner) == 1 and inner[0]["repartitionMerges"] >= 1,
          f"q18's inner aggregate did not repartition: {aggs}")
    # -- 5. q3_full under a pool of ~1.5 of its largest pair ----------------
    # The split sizes each pair to about a quarter of the pool and its
    # slices are unreserved, so the pool alone never reaches them: an OOM
    # injected at an aggregate reservation made while only slices are
    # left on the card makes the retry spill them (later pairs restore
    # theirs from host).
    MM.get_manager(session.rapids_conf(), dev)
    clear_scan_cache()
    seen = recorded_reservations(
        lambda: build_on("q3_full", session, tables).toArrow())
    pair = max(n for _, n, fn, _, _ in seen
               if fn == "_sub_partition_join") // 2
    pool = int(SUB_POOL_PAIRS * pair)
    tagged, slice_spilled = set(), [0]
    splitter = J.split_to_spillables
    spill_host = MM.SpillableBatch.spill_to_host

    def tagging(*a, **kw):
        out = splitter(*a, **kw)
        tagged.update(id(sp) for part in out for sp in part)
        return out

    def spilling(self):
        freed = spill_host(self)
        if id(self) in tagged:
            slice_spilled[0] += freed
        return freed

    def only_slices(mgr):
        on = [id(sp) in tagged for sp in mgr._spillables.values()
              if sp.tier == "device"]
        return bool(on) and all(on)

    J.split_to_spillables = tagging
    MM.SpillableBatch.spill_to_host = spilling
    try:
        sub_conf = {"spark.rapids.tpu.memory.poolSize": pool}
        MM.reset_manager()
        clear_scan_cache()
        seen = recorded_reservations(
            lambda: build_on("q3_full", small(**sub_conf), tables).toArrow(),
            probe=only_slices)
        at = [i for i, _, _, f, slices_only in seen if slices_only
              and f.endswith(os.path.join("exec", "aggregate.py"))]
        check(bool(at), "q3_full: no aggregate reservation while only "
              "slices were on the card")
        tagged.clear()
        slice_spilled[0] = 0
        sub = small(**dict(sub_conf, **{
            "spark.rapids.tpu.test.injectOomAtAlloc": at[0]}))
        got, wall, counts["sub-partition join"], df = retry_run(
            "sub-partition join", "q3_full", sub, tables, refs["q3_full"],
            CB, KN)
    finally:
        J.split_to_spillables = splitter
        MM.SpillableBatch.spill_to_host = spill_host
    check(rows_equal(got, first["q3_full"]),
          "q3_full under the small pool differs from its phase-8 run")
    m = MM.peek_manager().metrics
    joins = join_strategies(df)
    line = {"pool": pool, "largest_pair_bytes": pair, "inject_at": at[0],
            "wall_s": wall, "slices": len(tagged),
            "slice_spill_bytes": slice_spilled[0], "joins": joins,
            "spillToHostBytes": m["spillToHostBytes"],
            "restoredBytes": m["restoredBytes"], "retryOOMs": m["retryOOMs"],
            "splitRetries": m["splitRetries"]}
    print("[retry] sub-partition join " + json.dumps(line), flush=True)
    check(sum(j["subPartitionJoins"] for j in joins) >= 1,
          "q3_full did not sub-partition")
    check(m["retryOOMs"] >= 1 and slice_spilled[0] > 0,
          "no sub-partition slice spilled")

    MM.get_manager(session.rapids_conf(), dev)
    check(MM.peek_manager().budget == default_budget and not B._scan_cache,
          "the default manager was not restored")
    print(f"[retry] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


PUMP_PERMITS = (1, 2, 4)
PUMP_BRAND = "Brand#23"
PUMP_LINEITEM = ["l_orderkey", "l_partkey", "l_extendedprice", "l_discount"]
PUMP_JOINED = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
               "l_discount", "p_container"]
# one warm run per setting (and per [partitions] query): it still reads
# every scan from the cache, equals the run at one permit and keeps the
# semaphore within the permits
PUMP_WARM_RUNS = 1
SHAPE_CONFS = {
    "off": {"spark.rapids.tpu.kernel.bucketing": "off"},
    "pow2": {"spark.rapids.tpu.kernel.bucketing": "pow2"},
    # a single rung that swallows every small batch: padding forced
    "ladder": {"spark.rapids.tpu.kernel.bucketing": "ladder",
               "spark.rapids.tpu.kernel.bucketLadder": "8192",
               "spark.rapids.tpu.kernel.maxPadFraction": 0.99}}
CACHE_SF = 0.01
# one process of the build-cache check: a session whose kernel.cacheDir
# is argv[1], warmed up on q1 at SF argv[2]; prints the warmup report
CACHE_CHILD = """
import json, sys, time
t0 = time.perf_counter()
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.runtime import kernel_cache as KC
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch
s = TpuSession({"spark.rapids.tpu.kernel.cacheDir": sys.argv[1]})
li = tpch.gen_tpch(float(sys.argv[2]))["lineitem"]
rep = s.warmup([lambda sess: tpch.q1(sess, li)])
rep.update(cache_dir=KC.persistent_cache_dir(), build_dir=str(CB.BUILD_DIR),
           launches=CB.launches, process_s=time.perf_counter() - t0)
print(json.dumps(rep))
"""


def pump_filter(s, li):
    """Lineitem's large-quantity lines (about a tenth), four columns: a
    filter whose root keeps its partitions."""
    from spark_rapids_tpu_torch.sql.column import col
    return (s.createDataFrame(li).filter(col("l_quantity") > 45)
            .select(*PUMP_LINEITEM))


def ref_pump_filter(li):
    import pyarrow.compute as pc
    return li.filter(pc.greater(li["l_quantity"], 45)).select(PUMP_LINEITEM)


def pump_join(s, t):
    """q17's join without its aggregate: lineitem broadcast-joined with
    one brand's parts, six columns; the join streams lineitem partition
    by partition."""
    from spark_rapids_tpu_torch.sql.column import col
    part = (s.createDataFrame(t["part"])
            .select("p_partkey", "p_brand", "p_container")
            .filter(col("p_brand") == PUMP_BRAND))
    return (s.createDataFrame(t["lineitem"])
            .join(part, col("l_partkey") == col("p_partkey"))
            .select(*PUMP_JOINED))


def ref_pump_join(t):
    import pyarrow.compute as pc
    part = t["part"].filter(pc.equal(t["part"]["p_brand"], PUMP_BRAND))
    li = t["lineitem"].select(PUMP_JOINED[:5])
    return li.join(part.select(["p_partkey", "p_container"]), "l_partkey",
                   right_keys="p_partkey",
                   join_type="inner").select(PUMP_JOINED)


def pump_run(tag, build, session, ref, CB, KN, base=None) -> tuple:
    """One setting of ``[pump]``: a cold run (the scan cache cleared; a
    path of its own: the counts set to 0 just before, read just after)
    and ``PUMP_WARM_RUNS`` warm runs, each row for row equal to ``base``
    (the run at one permit, which must equal pyarrow as a multiset);
    the semaphore's high-water mark of each run within the permits.
    Returns (cold result, line, counts, cold DataFrame)."""
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    conf = session.rapids_conf()
    permits = conf.get(C.CONCURRENT_TASKS)
    sem = SEM.get_semaphore(conf)
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    sem.reset_query_stats()
    df = build(session)
    got, cold = timed(df)
    counts = path_counts(df, CB, KN)
    print(f"[main path] pump {tag} " + json.dumps(counts), flush=True)
    check(counts["collision_fallbacks"] == 0,
          f"pump {tag}: hash-collision fallbacks")
    fallback = df.fallback_summary()
    check(fallback["fallback_ops"] == 0 and fallback["device_ops"] > 0,
          f"pump {tag}: plan rewrite fell back: {fallback}")
    if base is None:  # the run at one permit: against pyarrow
        check_result(f"pump {tag}", got, ref)
        base = got
    # row for row equal to the run at one permit, which equals pyarrow
    check(got.equals(base), f"pump {tag} differs row for row from the run "
          "at one permit")
    peaks = [sem.max_holders]
    waits = [df._last_plan.metric("semaphoreWaitTime").value]
    warm = []
    for _ in range(PUMP_WARM_RUNS):
        sem.reset_query_stats()
        wdf = build(session)
        out, wall = timed(wdf)
        warm.append(wall)
        peaks.append(sem.max_holders)
        waits.append(wdf._last_plan.metric("semaphoreWaitTime").value)
        check(out.equals(base), f"pump {tag}: a warm run differs")
        check(all(t == 0 for t in scan_transfer_times(wdf)),
              f"pump {tag}: a warm scan missed the cache")
    check(max(peaks) <= permits and sem.holders == 0,
          f"pump {tag}: {max(peaks)} holders at {permits} permits")
    line = {"rows": got.num_rows, "permits": permits,
            "pump_depth": conf.get(C.EXEC_PUMP_DEPTH),
            "tasks": df._last_plan.num_partitions(),
            "peak_holders": max(peaks), "peak_holders_per_run": peaks,
            "semaphoreWaitTime_s": waits, "cold_wall_s": cold,
            "cold_h2d_s": phase_times(df)["h2d_s"],
            "wall_s_median": statistics.median(warm), "wall_s": warm,
            "d2h_s_cold": phase_times(df)["d2h_s"],
            "hash_pairs_launches": counts["hash_pairs_launches"]}
    print(f"[pump] {tag} " + json.dumps(line), flush=True)
    return got, line, counts, df


def pump_phase(dev, tables, refs, part_runs, CB, KN) -> dict:
    """The pump's concurrency at SF1, every run a path of its own under
    ``test.enabled``: plans whose root keeps its partitions (a filter, a
    broadcast join and the part-catalogue select) under 8 partitions at
    1, 2 and 4 permits (and the filter at ``pumpDepth`` 1); q1 and q18
    under 8 partitions (one task, inline) against ``[partitions]``; q3
    and q18 under the three bucketing policies, bit for bit; and the
    kernel build cache across processes.  Returns each run's counts."""
    import shutil
    import tempfile
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import kernel_cache as KC
    from spark_rapids_tpu_torch.runtime import shapes
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    counts = {}
    li, part = tables["lineitem"], tables["part"]
    plans = {"filter": (lambda s: pump_filter(s, li), ref_pump_filter(li)),
             "broadcast join": (lambda s: pump_join(s, tables),
                                ref_pump_join(tables)),
             "catalogue": (lambda s: catalogue_select(s, part),
                           ref_catalogue(part))}
    settings = [(name, p, 2) for name in plans for p in PUMP_PERMITS]
    settings.append(("filter", 1, 1))
    base, lines = {}, {}
    for name, permits, depth in settings:
        build, ref = plans[name]
        tag = f"{name} permits={permits} depth={depth}"
        session = TpuSession(dict(SESSION_CONF, **STRINGS_CONF, **{
            "spark.default.parallelism": PARTITIONS,
            "spark.rapids.sql.concurrentGpuTasks": permits,
            "spark.rapids.tpu.exec.pumpDepth": depth}), device=dev)
        got, lines[tag], counts[tag], df = pump_run(
            tag, build, session, ref, CB, KN, base.get(name))
        base.setdefault(name, got)
        check(lines[tag]["tasks"] == PARTITIONS,
              f"pump {tag}: {lines[tag]['tasks']} tasks")
        if name == "broadcast join":
            joins = join_strategies(df)
            check(len(joins) == 1 and joins[0]["broadcast"] == "right"
                  and joins[0]["streamedJoins"] == 0,
                  f"pump {tag}: part is not the broadcast side: {joins}")
    check(sum(counts[f"broadcast join permits={p} depth=2"]
              ["hash_pairs_launches"] for p in PUMP_PERMITS) > 0,
          "hash_pairs was not launched on the [pump] broadcast joins")

    sections = {"roots_s": time.perf_counter() - t_phase}
    # -- q1 and q18 under 8 partitions: one task, run inline ---------------
    for q in ("q1", "q18"):
        session = TpuSession(dict(SESSION_CONF, **{
            "spark.default.parallelism": PARTITIONS}), device=dev)
        clear_scan_cache()
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = build_on(q, session, tables)
        got, cold = timed(df)
        counts[f"partitions {q}"] = path_counts(df, CB, KN)
        check(df._last_plan.num_partitions() == 1,
              f"pump {q}: {df._last_plan.num_partitions()} tasks")
        check(rows_equal(got, part_runs[q]["rows"], tol=0.0),
              f"pump {q} differs from its [partitions] run")
        warm = [timed(build_on(q, session, tables))[1]
                for _ in range(PUMP_WARM_RUNS)]
        line = {"tasks": 1, "cold_wall_s": cold,
                "wall_s_median": statistics.median(warm), "wall_s": warm,
                "partitions_cold_wall_s": part_runs[q]["cold_wall_s"],
                "partitions_wall_s_median": part_runs[q]["wall_s_median"],
                "hash_pairs_launches":
                    counts[f"partitions {q}"]["hash_pairs_launches"]}
        print(f"[pump] partitions {q} " + json.dumps(line), flush=True)

    sections["partitions_s"] = (time.perf_counter() - t_phase
                                - sum(sections.values()))
    # -- the shape plane: q3 and q18 under each bucketing policy ------------
    for q in ("q3", "q18"):
        clear_scan_cache()
        build_on(q, TpuSession(dict(SESSION_CONF), device=dev),
                 tables).toArrow()  # stages the scans
        results, line = {}, {}
        for mode, conf in SHAPE_CONFS.items():
            # a session installs its policy when it is made
            session = TpuSession(dict(SESSION_CONF, **conf), device=dev)
            CB.reset_counts()
            KN.COUNTERS.reset()
            before = shapes.snapshot()
            df = build_on(q, session, tables)
            got, wall = timed(df)
            delta = [a - b for a, b in zip(shapes.snapshot(), before)]
            counts[f"shapes {q} {mode}"] = path_counts(df, CB, KN)
            results[mode] = got
            line[mode] = {"hits": delta[0], "misses": delta[1],
                          "pad_rows": delta[2], "pad_bytes": delta[3],
                          "warm_wall_s": wall,
                          "hash_pairs_launches": CB.launches}
            check(all(t == 0 for t in scan_transfer_times(df)),
                  f"shapes {q} {mode}: a scan missed the cache")
            check(got.equals(results["off"]),
                  f"{q} under bucketing={mode} differs bit for bit from "
                  "bucketing=off")
        check_result(f"shapes {q}", results["off"], refs[q])
        check(line["off"]["hits"] == line["off"]["misses"] == 0,
              f"shapes {q}: bucketing=off bucketed")
        check(all(line[m]["hits"] + line[m]["misses"] > 0
                  for m in ("pow2", "ladder")),
              f"shapes {q}: the shape pump saw no batch")
        print(f"[pump] shapes {q} " + json.dumps(line), flush=True)

    sections["shapes_s"] = (time.perf_counter() - t_phase
                            - sum(sections.values()))
    # -- the kernel build cache across processes ----------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="tpuq-kernel-cache-")

    def child(name):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", CACHE_CHILD, root,
                              str(CACHE_SF)], cwd=here, capture_output=True,
                             text=True, timeout=600)
        check(res.returncode == 0, f"build cache {name} process failed "
              f"({res.returncode}):\n{res.stdout[-2000:]}{res.stderr[-4000:]}")
        rep = json.loads(res.stdout.strip().splitlines()[-1])
        rep["wall_with_start_s"] = time.perf_counter() - t0
        print(f"[pump] build cache {name} " + json.dumps(rep), flush=True)
        check(rep["plans"] == 1 and rep["launches"] > 0,
              f"build cache {name}: q1 did not run on the card: {rep}")
        check(rep["build_dir"].startswith(root),
              f"build cache {name}: built outside kernel.cacheDir: {rep}")
        return rep

    try:
        first = child("first")
        second = child("second")
        check(first["compiles"] >= 1 and first["compile_seconds"] > 0,
              f"the first process built nothing: {first}")
        check(second["compiles"] == 0 and second["wall_s"] < first["wall_s"],
              f"the second process built again or was not faster: {second}")
        manifest = os.path.join(first["cache_dir"], KC.MANIFEST_NAME)
        with open(manifest) as f:
            stamped = json.load(f)
        check(stamped == KC._cache_versions(),
              f"manifest {stamped} != {KC._cache_versions()}")
        stamped["nvcc"] = "0.0-stale"
        with open(manifest, "w") as f:
            json.dump(stamped, f)
        third = child("after a version change")
        check(third["compiles"] >= 1,
              f"a changed manifest did not rebuild: {third}")
        with open(manifest) as f:
            check(json.load(f) == KC._cache_versions(),
                  "the manifest was not rewritten")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[pump] build cache " + json.dumps({
        "versions": KC._cache_versions(),
        "first_compiles": first["compiles"],
        "first_compile_s": first["compile_seconds"],
        "first_wall_s": first["wall_s"], "second_wall_s": second["wall_s"],
        "rebuilt_compiles": third["compiles"]}), flush=True)
    sections["build_cache_s"] = (time.perf_counter() - t_phase
                                 - sum(sections.values()))
    print(f"[pump] phase {time.perf_counter() - t_phase:.1f} s "
          + json.dumps(sections), flush=True)
    return counts


# -- [faults]: failure domains, retry policy, breakers, cancel, lockdep ----

FAULT_POLL_MS = 50
FAULT_PARTS = 16  # q18's inner aggregate behind the host shuffle


def q18_inner(s, li):
    """q18's inner aggregate behind ``repartition(16, "l_orderkey")``, as
    ``[exchange]`` runs it."""
    from spark_rapids_tpu_torch.sql import functions as F
    return (s.createDataFrame(li).repartition(FAULT_PARTS, "l_orderkey")
            .groupBy("l_orderkey").agg(F.sum("l_quantity").alias("q")))


def faults_phase(dev, tables, refs, first, spill, CB, KN) -> dict:
    """The failure domains at SF1 on the card, each run a path of its
    own (cache cleared and counts set to 0 before it, read after), under
    ``test.enabled``:

    1. a transient fault in each of the eight domains (``execute`` in
       q3's ``hash_pairs``; ``transfer`` at q1's root pull; ``compile``
       in a fresh build into a temporary ``kernel.cacheDir``; ``alloc``
       at q3's first aggregate reservation, read from a recording run;
       ``spill_write`` and ``spill_read`` in q3 over the disk tier, as
       ``[retry]`` runs it; ``shuffle_ser`` and ``shuffle_exchange`` in
       q18's inner aggregate behind the host shuffle): each equal to its
       clean run row for row, retries equal to the fires, no degraded
       op;
    2. terminal ``execute`` faults: degraded (equal to q3, the breaker
       tripped, ``execute`` named, the plain version's calls counted)
       and, with ``hostDegrade`` off, a ``TerminalDeviceError`` tagged
       ``execute``; a terminal ``shuffle_exchange`` fault, tagged;
    3. q18 cancelled from a second thread once its first kernel
       launched, and q3 under ``timeout_ms``: request-to-raise
       latencies;
    4. after each failed or cancelled run: no spillable left, no
       semaphore permit held, an empty spill directory, and the next
       clean run equal to pyarrow;
    5. the ``[pump]`` catalogue root at 4 permits under lockdep with
       ``raiseOnCycle``: no violation.

    Returns each run's counts."""
    import shutil
    import tempfile
    import threading
    import torch
    from spark_rapids_tpu_torch import native as NAT
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import cancel as CN
    from spark_rapids_tpu_torch.runtime import kernel_cache as KC
    from spark_rapids_tpu_torch.runtime import lockdep as LD
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.runtime import resilience as R
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    before = R.counters_snapshot()
    print("[faults] counters before the phase " + json.dumps(before),
          flush=True)
    # no injected fault, exhausted retry, breaker or degraded op yet;
    # retries only of the OOM rollback (``alloc``)
    check(not before["faults_injected"] and before["retry_exhausted"] == 0
          and before["breaker_trips"] == 0
          and before["host_degraded_ops"] == 0
          and set(before["retries"]) <= {"alloc"},
          f"failure-domain activity before [faults]: {before}")
    li = tables["lineitem"]
    li18 = li.select(["l_orderkey", "l_quantity", "l_returnflag"])
    default_conf = TpuSession(dict(SESSION_CONF), device=dev).rapids_conf()
    counts, lines = {}, {}

    def session(inject=None, **conf):
        full = dict(SESSION_CONF, **{
            "spark.rapids.tpu.query.cancelPollMs": FAULT_POLL_MS}, **conf)
        for d, (at, n) in (inject or {}).items():
            full[f"spark.rapids.tpu.test.inject.{d}.at"] = at
            full[f"spark.rapids.tpu.test.inject.{d}.transientCount"] = n
        return TpuSession(full, device=dev)

    def settled(name):
        """No spillable, permit, spill file or query scope is left."""
        mgr, sem = MM.peek_manager(), SEM.peek_semaphore()
        files = (os.listdir(mgr.spill_path)
                 if mgr is not None and os.path.isdir(mgr.spill_path)
                 else [])
        state = {"leaks": mgr.report_leaks() if mgr is not None else 0,
                 "permits_held": sem.holders if sem is not None else 0,
                 "spill_files": len(files),
                 "open_queries": len(R.open_queries())
                 + len(CN.active_queries())}
        check(state == {"leaks": 0, "permits_held": 0, "spill_files": 0,
                        "open_queries": 0},
              f"faults {name}: not settled: {state}")
        return state

    def faulted(name, build, sess, inject):
        """One run with ``inject`` armed: (result or the error, wall,
        its entry, the fires, the path's counts)."""
        R.INJECTOR.reset()
        clear_scan_cache()
        CB.reset_counts()
        KN.COUNTERS.reset()
        f0 = R.counters_snapshot()["faults_injected"]
        df = build(sess)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            got = df.toArrow()
        except BaseException as e:  # noqa: BLE001 (read below)
            got = e
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        R.INJECTOR.reset()
        f1 = R.counters_snapshot()["faults_injected"]
        fires = {d: f1.get(d, 0) - f0.get(d, 0) for d in inject
                 if f1.get(d, 0) - f0.get(d, 0)}
        counts[name] = c = path_counts(df, CB, KN)
        c["plain_calls"] = CB.plain_calls
        print(f"[main path] faults {name} " + json.dumps(c), flush=True)
        return got, wall, df._last_query_entry, fires, c

    def transient(name, build, sess, inject, clean):
        got, wall, entry, fires, c = faulted(name, build, sess, inject)
        check(not isinstance(got, BaseException),
              f"faults {name}: {got!r}")
        res = entry.get("resilience") or {}
        line = {"wall_s": wall, "fires": fires,
                "retries": res.get("retries", {}),
                "degraded_ops": res.get("degraded_ops", []),
                "hash_pairs_launches": c["hash_pairs_launches"]}
        lines[name] = line
        print(f"[faults] {name} " + json.dumps(line), flush=True)
        check(sum(fires.values()) > 0, f"faults {name}: nothing fired")
        # retries equal to fires in the armed domains; beside them only
        # the OOM rollback's own (a small pool's ``alloc`` retries)
        check({d: line["retries"].get(d, 0) for d in inject} == {
            d: fires.get(d, 0) for d in inject}
            and set(line["retries"]) - set(inject) <= {"alloc"},
            f"faults {name}: retries {line['retries']} != fires {fires}")
        check(not line["degraded_ops"], f"faults {name}: degraded")
        check(got.equals(clean),
              f"faults {name}: differs row for row from its clean run")
        return got

    def failing(name, build, sess, inject, domain, ref, clean_build):
        got, wall, entry, fires, c = faulted(name, build, sess, inject)
        check(isinstance(got, R.TerminalDeviceError)
              and got.domain == domain,
              f"faults {name}: expected a TerminalDeviceError tagged "
              f"{domain}, got {got!r}")
        check(entry["status"] == "error", f"faults {name}: {entry}")
        after = settled(name)
        nxt = clean_build(session()).toArrow()
        check_result(f"faults {name} next clean run", nxt, ref)
        lines[name] = {"wall_s": wall, "fires": fires, "error": str(got),
                       "after": after}
        print(f"[faults] {name} " + json.dumps(lines[name]), flush=True)

    # -- 1. transient faults ---------------------------------------------
    q3 = lambda s: build_on("q3", s, tables)  # noqa: E731
    q1 = lambda s: build_on("q1", s, tables)  # noqa: E731
    transient("execute transient", q3, session({"execute": (2, 2)}),
              {"execute": (2, 2)}, first["q3"])
    transient("transfer transient", q1, session({"transfer": (1, 1)}),
              {"transfer": (1, 1)}, first["q1"])
    # compile: a fresh build into a temporary cacheDir (the build sites
    # move there for the run and come back after)
    cache_root = tempfile.mkdtemp(prefix="tpuq-faults-cache-")
    saved = (CB.BUILD_DIR, NAT.BUILD_DIR, KC._PERSISTENT_DIR)
    try:
        sess = session({"compile": (1, 1)}, **{
            "spark.rapids.tpu.kernel.cacheDir": cache_root})
        KC.clear()
        b0 = KC.compile_snapshot()[0]
        transient("compile transient", q1, sess, {"compile": (1, 1)},
                  first["q1"])
        builds = KC.compile_snapshot()[0] - b0
        lines["compile transient"]["builds"] = builds
        check(builds == 1, f"faults compile: {builds} builds")
    finally:
        CB.BUILD_DIR, NAT.BUILD_DIR, KC._PERSISTENT_DIR = saved
        KC.clear()
        shutil.rmtree(cache_root, ignore_errors=True)
    # alloc: the first aggregate reservation of q3, from a recording run
    MM.reset_manager()
    clear_scan_cache()
    seen = recorded_reservations(lambda: q3(session()).toArrow())
    agg = [i for i, _, _, f, _ in seen
           if f.endswith(os.path.join("exec", "aggregate.py"))]
    check(bool(agg), "q3 made no aggregate reservation")
    MM.reset_manager()
    transient("alloc transient", q3, session({"alloc": (agg[0], 1)}),
              {"alloc": (agg[0], 1)}, first["q3"])
    lines["alloc transient"]["at"] = agg[0]
    # spill_write and spill_read: q3 over the disk tier
    root = tempfile.mkdtemp(prefix="tpuq-faults-spill-")
    disk = {"spark.rapids.tpu.memory.poolSize": spill["pool"],
            "spark.rapids.memory.host.spillStorageSize":
                spill["lineitem_batch_bytes"],
            "spark.rapids.tpu.spillPath": root}
    try:
        transient("spill_write transient", q3,
                  session({"spill_write": (1, 1)}, **disk),
                  {"spill_write": (1, 1)}, first["q3"])
        # the cold run above left scan batches on disk: the warm run
        # restores them
        sess = session({"spill_read": (1, 1)}, **disk)
        R.INJECTOR.reset()
        f0 = R.counters_snapshot()["faults_injected"].get("spill_read", 0)
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = q3(sess)
        got, wall = timed(df)
        R.INJECTOR.reset()
        fires = (R.counters_snapshot()["faults_injected"]
                 .get("spill_read", 0) - f0)
        counts["spill_read transient"] = path_counts(df, CB, KN)
        res = df._last_query_entry.get("resilience") or {}
        lines["spill_read transient"] = {
            "wall_s": wall, "fires": {"spill_read": fires},
            "retries": res.get("retries", {}),
            "restoredBytes": MM.peek_manager().metrics["restoredBytes"]}
        print("[faults] spill_read transient " + json.dumps(
            lines["spill_read transient"]), flush=True)
        check(fires == 1 and res.get("retries", {}).get("spill_read") == 1
              and set(res.get("retries", {})) <= {"spill_read", "alloc"}
              and not res.get("degraded_ops"),
              f"faults spill_read: {lines['spill_read transient']}")
        check(got.equals(first["q3"]), "faults spill_read: q3 differs")
        clear_scan_cache()
        settled("spill tier")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        MM.get_manager(default_conf, dev)
    # shuffle_ser and shuffle_exchange: q18's inner aggregate
    q18i = lambda s: q18_inner(s, li18)  # noqa: E731
    clear_scan_cache()
    clean18, wall18 = timed(q18i(session()))
    want18 = li18.group_by("l_orderkey").aggregate(
        [("l_quantity", "sum")]).rename_columns(["l_orderkey", "q"])
    check(rows_equal(clean18, want18.select(["l_orderkey", "q"]), 1e-12),
          "faults: q18's inner aggregate differs from pyarrow")
    for d in ("shuffle_ser", "shuffle_exchange"):
        transient(f"{d} transient", q18i, session({d: (1, 1)}),
                  {d: (1, 1)}, clean18)

    # -- 2. terminal faults ------------------------------------------------
    got, wall, entry, fires, c = faulted(
        "execute terminal degraded", q3, session({"execute": (2, 0)}),
        {"execute": (2, 0)})
    check(not isinstance(got, BaseException),
          f"faults execute terminal degraded: {got!r}")
    res = entry.get("resilience") or {}
    lines["execute terminal degraded"] = line = {
        "wall_s": wall, "fires": fires,
        "degraded_domains": sorted({d["domain"]
                                    for d in res.get("degraded_ops", [])}),
        "breaker_trips": res.get("breaker_trips", 0),
        "hash_pairs_launches": c["hash_pairs_launches"],
        "hash_pairs_plain_calls": c["plain_calls"],
        "fallback_report": [x for x in entry.get("fallback_report", [])
                            if x.startswith("!")]}
    print("[faults] execute terminal degraded " + json.dumps(line),
          flush=True)
    check(line["degraded_domains"] == ["execute"]
          and line["breaker_trips"] >= 1 and line["hash_pairs_plain_calls"]
          > 0, f"faults execute terminal degraded: {line}")
    check(got.equals(first["q3"]),
          "faults execute terminal degraded: q3 differs row for row")
    failing("execute terminal", q3,
            session({"execute": (2, 0)}, **{
                "spark.rapids.tpu.retry.hostDegrade.enabled": False}),
            {"execute": (2, 0)}, "execute", refs["q3"], q3)
    failing("shuffle_exchange terminal", q18i,
            session({"shuffle_exchange": (1, 0)}),
            {"shuffle_exchange": (1, 0)}, "shuffle_exchange",
            clean18, q18i)

    # -- 3. cancel ---------------------------------------------------------
    q18 = lambda s: build_on("q18", s, tables)  # noqa: E731
    sess = session()
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = q18(sess)
    box = {}

    def run18():
        try:
            box["out"] = df.toArrow()
        except BaseException as e:  # noqa: BLE001 (read below)
            box["err"] = e
            box["at"] = time.perf_counter()

    th = threading.Thread(target=run18, name="faults-q18", daemon=True)
    t_start = time.perf_counter()
    th.start()
    while th.is_alive() and CB.launches == 0:
        time.sleep(0.001)
    time.sleep(0.05)  # partway through the device work
    t_req = time.perf_counter()
    sent = sess.cancel()
    th.join(timeout=120)
    check(not th.is_alive(), "faults: q18 ignored its cancel")
    torch.cuda.synchronize()
    counts["cancel q18"] = path_counts(df, CB, KN)
    entry = df._last_query_entry
    lines["cancel q18"] = line = {
        "cancel_sent": sent, "after_s": t_req - t_start,
        "request_to_raise_s": box.get("at", t_req) - t_req,
        "token_latency_s": (entry.get("cancel") or {}).get("latency_s"),
        "status": entry["status"],
        "hash_pairs_launches": CB.launches,
        "after": settled("cancel q18")}
    print("[faults] cancel q18 " + json.dumps(line), flush=True)
    check(sent and isinstance(box.get("err"), CN.QueryCancelled)
          and entry["cancel"]["reason"] == "user",
          f"faults: q18 was not cancelled: {line} {box}")
    check_result("faults q18 after its cancel", q18(session()).toArrow(),
                 refs["q18"])
    # q3 under a deadline of a third of its clean cold wall
    clear_scan_cache()
    _, cold3 = timed(q3(session()))
    timeout_ms = max(1, int(cold3 * 1000 / 3))
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = q3(session())
    t0 = time.perf_counter()
    try:
        df.toArrow(timeout_ms=timeout_ms)
        err = None
    except CN.QueryCancelled as e:
        err = e
    t_raise = time.perf_counter()
    torch.cuda.synchronize()
    counts["deadline q3"] = path_counts(df, CB, KN)
    entry = df._last_query_entry
    lines["deadline q3"] = line = {
        "timeout_ms": timeout_ms, "clean_cold_wall_s": cold3,
        "raised_after_s": t_raise - t0,
        "token_latency_s": (entry.get("cancel") or {}).get("latency_s"),
        "status": entry["status"], "after": settled("deadline q3")}
    print("[faults] deadline q3 " + json.dumps(line), flush=True)
    check(err is not None and err.reason == "deadline",
          f"faults: q3 under its deadline: {line}")
    check_result("faults q3 after its deadline", q3(session()).toArrow(),
                 refs["q3"])

    # -- 4. lockdep over the [pump] catalogue root at 4 permits ------------
    part = tables["part"]
    LD.reset()
    sess = session(**STRINGS_CONF, **{
        "spark.default.parallelism": PARTITIONS,
        "spark.rapids.sql.concurrentGpuTasks": 4,
        "spark.rapids.tpu.lockdep.enabled": True,
        "spark.rapids.tpu.lockdep.raiseOnCycle": True})
    try:
        clear_scan_cache()
        got, wall = timed(catalogue_select(sess, part))
    finally:
        LD.disable()
    check(rows_equal(got, ref_catalogue(part)),
          "faults: the catalogue under lockdep differs from pyarrow")
    lines["lockdep catalogue"] = line = {
        "wall_s": wall, "violations": [str(v) for v in LD.violations()],
        **LD.counters_snapshot()}
    print("[faults] lockdep catalogue permits=4 " + json.dumps(line),
          flush=True)
    check(not line["violations"], f"faults: lockdep: {line}")
    LD.reset()

    after = R.counters_snapshot()
    total = time.perf_counter() - t_phase
    print("[faults] " + json.dumps({
        "phase_s": total, "card": nvidia_smi_line(),
        "counters_after": after,
        "walls_s": {k: v["wall_s"] for k, v in lines.items()
                    if "wall_s" in v}}), flush=True)
    return counts


def dict_phase(session, tables, refs, first, summary) -> list:
    """q1, q12 and q19 cold over a lineitem whose four low-cardinality
    string columns are dictionary-encoded: each equals its plain run and
    the pyarrow reference; their cold H2D beside the plain cold H2D."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    enc = dict(tables, lineitem=dictionary_lineitem(tables["lineitem"]))
    rows = []
    for q in ("q1", "q12", "q19"):
        clear_scan_cache()
        df = build_on(q, session, enc)
        got, wall = timed(df)
        check_result(f"{q} (dictionary lineitem)", got, refs[q])
        check(rows_equal(got, first[q], tol=0.0),
              f"{q} over dictionary columns differs from its plain run")
        row = {"query": q, "cold_wall_s": wall,
               "cold_h2d_s": phase_times(df)["h2d_s"],
               "plain_cold_wall_s": summary[q]["cold_wall_s"],
               "plain_cold_h2d_s": summary[q]["cold_h2d_s"]}
        rows.append(row)
        print("[dict decode] " + json.dumps(row), flush=True)
    clear_scan_cache()
    return rows


VARIANT_WARM_RUNS = 1


def variant_phase(v, session, exact, tables, first, CB, KN) -> dict:
    """One join variant as a query of its own: its cold run (counts set
    to 0 just before, read just after) against the pyarrow reference,
    its base query (the same rows in the same order), the exact rung
    and its strategy; then ``VARIANT_WARM_RUNS`` warm runs.  Returns the
    counts."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.utils import tpch
    base = tpch.JOIN_VARIANTS[v]
    want = globals()["ref_" + v](tables)
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = build_on(v, session, tables)
    got, cold_wall = timed(df)
    counts = path_counts(df, CB, KN)
    print(f"[main path] {v} " + json.dumps(counts), flush=True)
    check(counts["collision_fallbacks"] == 0,
          f"{v}: {counts['collision_fallbacks']} hash-collision fallbacks")
    check(counts["hash_pairs_launches"] > 0,
          f"{v}: hash_pairs was not launched")
    check_variant_strategies(v, counts["joins"])
    check_result(v, got, want)
    if base is not None:
        check(got.equals(first[base]),
              f"{v} differs from {base}:\n{got}\n{first[base]}")
    first[v] = got
    check(rows_equal(build_on(v, exact, tables).toArrow(), got),
          f"{v}: cuda rung != jnp rung")
    warm = []
    for _ in range(VARIANT_WARM_RUNS):
        out, wall = timed(build_on(v, session, tables))
        warm.append(wall)
        check(rows_equal(out, want), f"{v} warm run differs")
    line = {"rows": got.num_rows, "equals_base": base,
            "cold_wall_s": cold_wall,
            "wall_s_median": statistics.median(warm), "wall_s": warm,
            "hash_pairs_launches": counts["hash_pairs_launches"]}
    print(f"[join variant] {v} SF{SF:g} " + json.dumps(line), flush=True)
    return counts


# the plans with an operator on the CPU: (name, query, conf, the exec
# that must fall — what allowedNonGpu names —, how many of it, the
# all-device query it must equal)
FALLBACK_CASES = (
    ("q1_cpu_sort", "q1", {"spark.rapids.sql.exec.Sort": False},
     "CpuSortExec", 1, "q1"),
    ("q22_host_substring", "q22",
     {"spark.rapids.sql.expression.Substring": False},
     "CpuProjectExec", 2, "q22"),
    ("q13_cond", "q13_cond", {}, "CpuJoinExec", 1, "q13"),
)


def transition_times(df) -> list:
    """Each transition of the last run, root first: its direction, rows
    and ``transferTime`` (the root's device-to-host copy of the result
    included)."""
    out = []

    def walk(node):
        name = type(node).__name__
        if name in ("HostToDeviceExec", "DeviceToHostExec"):
            m = {k: v.value for k, v in node.metrics.items()}
            out.append({"node": name,
                        "rows": m.get("numOutputRows", 0),
                        "batches": m.get("numOutputBatches", 0),
                        "transferTime_s": m.get("transferTime", 0.0)})
        for c in node.children:
            walk(c)

    walk(df._last_plan)
    return out


# one warm run a case (q13_cond's host join takes ~11 s a run): it still
# equals the reference
FALLBACK_WARM_RUNS = 1


def fallback_phase(case, dev, tables, refs, first, CB, KN) -> dict:
    """One plan with an operator on the CPU, as a path of its own: the
    cache cleared and the counts set to 0 before its cold run, read
    after; under test.enabled with allowedNonGpu naming exactly the exec
    that must fall, so any other fallback raises.  Against its pyarrow
    reference and its all-device run; then ``FALLBACK_WARM_RUNS`` warm
    runs."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql.session import TpuSession
    name, q, conf, cpu_exec, n_fallen, base = case
    session = TpuSession(dict(conf, **{
        "spark.rapids.sql.test.enabled": True,
        "spark.rapids.sql.test.allowedNonGpu": cpu_exec,
        BLACKBOX_KEY: SESSION_CONF[BLACKBOX_KEY]}), device=dev)
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = build_on(q, session, tables)
    got, cold_wall = timed(df)
    counts = path_counts(df, CB, KN)
    summary = df.fallback_summary()
    print(f"[main path] {name} " + json.dumps(counts), flush=True)
    check(summary["fallback_ops"] == n_fallen and all(
        r.startswith(cpu_exec + ": ") for r in summary["fallback_reasons"]),
        f"{name}: want {n_fallen} x {cpu_exec} on the CPU, got {summary}")
    check(counts["collision_fallbacks"] == 0,
          f"{name}: {counts['collision_fallbacks']} hash-collision "
          "fallbacks")
    check(counts["hash_pairs_launches"] > 0,
          f"{name}: hash_pairs was not launched")
    check_result(name, got, refs[base])
    check(rows_equal(got, first[base]),
          f"{name} differs from its all-device run:\n{got}\n{first[base]}")
    cold_tr = transition_times(df)
    if q == "q22":
        check(sum(t["node"] == "HostToDeviceExec" for t in cold_tr) == 2,
              f"{name}: transitions {cold_tr}")
        check("TpuCoalesceBatches [target=" in df._last_plan.tree_string(),
              f"{name}: no TargetSize coalesce above HostToDeviceExec")
    warm, warm_tr = [], []
    for _ in range(FALLBACK_WARM_RUNS):
        wdf = build_on(q, session, tables)
        out, wall = timed(wdf)
        warm.append(wall)
        warm_tr.append(transition_times(wdf))
        check(rows_equal(out, refs[base]), f"{name} warm run differs")
    i = warm.index(statistics.median(warm))
    line = {"query": q, "conf": conf, "allowedNonGpu": cpu_exec,
            "rows": got.num_rows, "fallback": summary,
            "report": df._last_override.fallback_report(),
            "cold_wall_s": cold_wall, "wall_s_median": warm[i],
            "wall_s": warm, "all_device_equal": True,
            "cold_transitions": cold_tr, "warm_transitions": warm_tr[i],
            "hash_pairs_launches": counts["hash_pairs_launches"]}
    print(f"[fallback] {name} SF{SF:g} " + json.dumps(line), flush=True)
    return counts


def oracle_phase(dev) -> dict:
    """bench's CPU-oracle loop on the card (``tpch.oracle_check``): the
    22 builders at its small scales under ``TPCH_SF1_CONF`` against the
    port's CPU session; all must be equal."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.utils import tpch
    clear_scan_cache()
    cache = {}

    def tables_for(sf):
        if sf not in cache:
            cache[sf] = tpch.gen_tpch(sf)
        return cache[sf]

    t0 = time.perf_counter()
    out = tpch.oracle_check(tables_for, device=dev)
    line = {"seconds": time.perf_counter() - t0, "equal": out,
            "scales": sorted(cache)}
    print("[oracle] " + json.dumps(line), flush=True)
    bad = [q for q, ok in out.items() if not ok]
    check(len(out) == 22 and not bad,
          f"oracle_check: the card differs from the CPU session on {bad}")
    clear_scan_cache()
    return line


# ---------------------------------------------------------------------------
# multi-partition execution and the exchange plane
# ---------------------------------------------------------------------------

# queries run again under spark.default.parallelism=8: string group keys
# (q1), keyless (q6), broadcast and streamed joins (q3), the
# sub-partition join (q13), semi joins and the most hash_pairs launches
# (q18, q21)
PARTITION_QUERIES = ("q1", "q6", "q3", "q13", "q18", "q21")
PARTITIONS = 8
EXCHANGE_PARTS = 16
EXCHANGE_RUNS = (("MULTITHREADED", True), ("MULTITHREADED", False),
                 ("CACHE_ONLY", True), ("CACHE_ONLY", False))


def _fmix32(h, length):
    import numpy as np
    h = h ^ np.uint32(length) if np.isscalar(length) else h ^ length
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _mix_k1(k):
    import numpy as np
    k = k * np.uint32(0xCC9E2D51)
    k = (k << np.uint32(15)) | (k >> np.uint32(17))
    return k * np.uint32(0x1B873593)


def _mix_h1(h, k):
    import numpy as np
    h = h ^ k
    h = (h << np.uint32(13)) | (h >> np.uint32(19))
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def spark_murmur3_long(values, seed: int = 42):
    """Spark's ``Murmur3_x86_32.hashLong`` of int64 values (numpy,
    written here so the check does not lean on the package)."""
    import numpy as np
    v = np.asarray(values, np.int64).view(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(v.shape, seed, np.uint32)
        h = _mix_h1(h, _mix_k1(lo))
        h = _mix_h1(h, _mix_k1(hi))
        return _fmix32(h, 8)


def spark_murmur3_bytes(b: bytes, seed: int = 42) -> int:
    """Spark's ``hashUnsafeBytes`` of one UTF-8 string: 4-byte
    little-endian blocks, then each tail byte sign-extended."""
    import numpy as np
    with np.errstate(over="ignore"):
        h = np.uint32(seed)
        aligned = len(b) - len(b) % 4
        for i in range(0, aligned, 4):
            h = _mix_h1(h, _mix_k1(np.uint32(int.from_bytes(
                b[i:i + 4], "little"))))
        for i in range(aligned, len(b)):
            byte = b[i] - 256 if b[i] >= 128 else b[i]
            h = _mix_h1(h, _mix_k1(np.uint32(byte & 0xFFFFFFFF)))
        return int(_fmix32(np.uint32(h), len(b)))


def spark_pmod(h, n: int):
    """Spark's partition id: ``pmod(hash as int32, n)``."""
    import numpy as np
    return np.mod(np.asarray(h, np.uint32).view(np.int32).astype(np.int64),
                  n)


def find_node(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = find_node(c, name)
        if r is not None:
            return r
    return None


def cache_partitions() -> dict:
    """Cached scan entries per table: the partition counts of their keys
    and how many partitions each holds."""
    from spark_rapids_tpu_torch.exec import basic as B
    return {str(tid): {"num_partitions": sorted({k[0] for k in e}),
                       "entries": len(e)}
            for tid, e in B._scan_cache.items()}


def _strategy_key(joins) -> list:
    return [(j["join_type"], j["broadcast"], j["cpu"], j["streamedJoins"],
             j["subPartitionJoins"]) for j in joins]


# warm runs of the older phases, cut to keep the script within 800 s as
# the lakehouse phase came (2 before)
PARTITIONS_WARM_RUNS = EXCHANGE_WARM_RUNS = BREADTH_WARM_RUNS = 1


def partitions_phase(q, dev, tables, ref, first, summary, main_counts,
                     CB, KN, runs=None) -> dict:
    """One query under spark.default.parallelism=8, a path of its own:
    the cache cleared and the counts set to 0 before its cold run, read
    after; against pyarrow and its 1-partition run of phase 4, with the
    1-partition run's join strategies; 8 cache entries per scanned
    table; then ``PARTITIONS_WARM_RUNS`` warm runs that must read every
    scan from the cache.  ``runs[q]`` keeps the cold result and the
    walls for ``[pump]``."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql.session import TpuSession
    session = TpuSession(dict(SESSION_CONF, **{
        "spark.default.parallelism": PARTITIONS}), device=dev)
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = build_on(q, session, tables)
    got, cold_wall = timed(df)
    counts = path_counts(df, CB, KN)
    print(f"[main path] partitions {q} " + json.dumps(counts), flush=True)
    check(counts["collision_fallbacks"] == 0,
          f"partitions {q}: {counts['collision_fallbacks']} hash-collision "
          "fallbacks")
    check(counts["hash_pairs_launches"] > 0 or q == "q6",
          f"partitions {q}: hash_pairs was not launched")
    check(df.fallback_summary()["fallback_ops"] == 0,
          f"partitions {q}: {df.fallback_summary()}")
    check_result(f"partitions {q}", got, ref)
    check(rows_equal(got, first[q]),
          f"{q} under {PARTITIONS} partitions differs from its "
          f"1-partition run:\n{got}\n{first[q]}")
    check(_strategy_key(counts["joins"])
          == _strategy_key(main_counts["joins"]),
          f"partitions {q}: join strategies {counts['joins']} differ from "
          f"the 1-partition run's {main_counts['joins']}")
    scans = find_scans(df._last_plan)
    check(scans and all(n.num_partitions() == PARTITIONS for n in scans),
          f"partitions {q}: scans of {[n.num_partitions() for n in scans]}"
          " partitions")
    cached = cache_partitions()
    check(cached and all(c == {"num_partitions": [PARTITIONS],
                               "entries": PARTITIONS}
                         for c in cached.values()),
          f"partitions {q}: scan cache entries {cached}")
    warm = []
    for _ in range(PARTITIONS_WARM_RUNS):
        wdf = build_on(q, session, tables)
        out, wall = timed(wdf)
        warm.append(wall)
        check(rows_equal(out, ref), f"partitions {q} warm run differs")
        check(all(t == 0 for t in scan_transfer_times(wdf)),
              f"partitions {q}: a warm scan missed the cache")
    line = {"partitions": PARTITIONS, "rows": got.num_rows,
            "cold_wall_s": cold_wall,
            "cold_h2d_s": phase_times(df)["h2d_s"],
            "wall_s_median": statistics.median(warm), "wall_s": warm,
            "one_partition_cold_wall_s": summary[q]["cold_wall_s"],
            "one_partition_wall_s_median": summary[q]["wall_s_median"],
            "hash_pairs_launches": counts["hash_pairs_launches"],
            "one_partition_hash_pairs_launches":
                summary[q]["hash_pairs_launches"],
            "scan_cache_entries_per_table": sorted(
                c["entries"] for c in cached.values()),
            "equals_one_partition_run": True}
    print(f"[partitions] {q} SF{SF:g} " + json.dumps(line), flush=True)
    if runs is not None:
        runs[q] = dict(line, rows=got)
    return counts


def find_scans(node) -> list:
    out = [node] if type(node).__name__ == "TpuScanExec" else []
    for c in node.children:
        out += find_scans(c)
    return out


def exchange_metrics(df) -> dict:
    """The exchange's and the AQE read's metrics of the last run."""
    out = {}
    for name in ("TpuHostShuffleExchangeExec", "TpuShuffleExchangeExec"):
        ex = find_node(df._last_plan, name)
        if ex is not None:
            m = {k: v.value for k, v in ex.metrics.items()}
            out.update(exchange=name, **{k: m.get(k, 0) for k in (
                "partitionTime", "writeTime", "readTime", "transferTime",
                "bytesWritten")})
    aqe = find_node(df._last_plan, "TpuAQEShuffleReadExec")
    if aqe is not None:
        out["aqe_reads"] = aqe.num_partitions()
        out["coalescedReads"] = aqe.metrics["coalescedReads"].value
        out["splitSkewedPartitions"] = aqe.metric(
            "splitSkewedPartitions").value
    return out


def device_partitions(exchange, nparts: int) -> list:
    """Each output partition of an exchange as its live rows on the card:
    per column ``(data, validity, lengths)``, batches concatenated."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import compact
    out = []
    for p in range(nparts):
        parts = []
        for b in exchange.execute(p):
            b = compact(b)
            n = int(b.sel.sum())
            parts.append([(c.data[:n], c.valid_mask()[:n],
                           None if c.lengths is None else c.lengths[:n])
                          for c in b.columns])
        cols = []
        for ci in range(len(exchange.schema.fields)):
            pieces = [pt[ci] for pt in parts]
            if not pieces:
                cols.append(None)
                continue
            w = max((x[0].shape[1] for x in pieces
                     if x[0].dim() == 2), default=0)
            data = torch.cat([
                torch.nn.functional.pad(x[0], (0, w - x[0].shape[1]))
                if x[0].dim() == 2 else x[0] for x in pieces])
            cols.append((data, torch.cat([x[1] for x in pieces]),
                         None if pieces[0][2] is None
                         else torch.cat([x[2] for x in pieces])))
        out.append(cols)
    return out


def _rows_of(part) -> int:
    return 0 if part[0] is None else int(part[0][0].shape[0])


def same_partitions(a: list, b: list) -> bool:
    """Two exchanges' partitions hold the same rows in the same order
    (string matrices compared up to the wider one's zero padding)."""
    import torch
    if len(a) != len(b):
        return False
    for pa_, pb_ in zip(a, b):
        if _rows_of(pa_) != _rows_of(pb_):
            return False
        if _rows_of(pa_) == 0:
            continue
        for (da, va, la), (db, vb, lb) in zip(pa_, pb_):
            if not torch.equal(va, vb):
                return False
            if la is not None:
                w = min(da.shape[1], db.shape[1])
                if not (torch.equal(la, lb)
                        and torch.equal(da[:, :w], db[:, :w])
                        and not da[:, w:].any() and not db[:, w:].any()):
                    return False
            elif not torch.equal(da, db):
                return False
    return True


def exchange_phase(dev, tables, CB, KN) -> dict:
    """The exchange plane at SF1, each run a path of its own (cache
    cleared and counts set to 0 before its cold run, read after):

    1. q18's inner aggregate, ``lineitem(l_orderkey, l_quantity,
       l_returnflag).repartition(16, "l_orderkey").groupBy("l_orderkey")
       .agg(sum(l_quantity))``, under MULTITHREADED and CACHE_ONLY, each
       with AQE on (the default) and off: every run equals pyarrow's
       ``group_by``; with AQE off the two transports' partitions hold the
       same rows in the same order, counted as this script's numpy
       murmur3 pmod 16 counts them;
    2. orders, every column, ``.repartition(16)`` round robin under
       MULTITHREADED: 93,750 rows per partition (AQE off), and the
       multiset of (o_orderkey, o_comment) is the input's (AQE on);
    3. customer ``.repartition(16, "c_mktsegment")``: per-partition
       counts against the numpy murmur3 of the UTF-8 bytes (AQE off); AQE
       on must not split the hash exchange.

    Returns the counts of the aggregate runs (the others launch no
    kernel), by name."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch import native as NAT
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.session import TpuSession
    li = tables["lineitem"].select(["l_orderkey", "l_quantity",
                                    "l_returnflag"])
    want = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    want = want.sort_by("l_orderkey")
    want_keys = want.column("l_orderkey").to_numpy()
    want_sums = want.column("l_quantity_sum").to_numpy()

    def check_sums(name, got):
        got = got.sort_by("l_orderkey")
        check(np.array_equal(got.column("l_orderkey").to_numpy(),
                             want_keys), f"{name}: group keys differ")
        g = got.column("q").to_numpy()
        check(bool(np.allclose(g, want_sums, rtol=1e-12, atol=0)),
              f"{name}: sums differ from pyarrow's")

    def session(mode, aqe):
        return TpuSession(dict(SESSION_CONF, **{
            "spark.rapids.shuffle.mode": mode,
            "spark.sql.adaptive.enabled": aqe}), device=dev)

    def agg(s, repartition=True):
        df = s.createDataFrame(li)
        if repartition:
            df = df.repartition(EXCHANGE_PARTS, "l_orderkey")
        return df.groupBy("l_orderkey").agg(F.sum("l_quantity").alias("q"))

    # the serializer's library first, so no run's writeTime holds its
    # build
    t0 = time.perf_counter()
    NAT.load_library("tudo")
    print("[exchange] tudo build " + json.dumps(
        {"seconds": time.perf_counter() - t0,
         "compile_seconds": NAT.build_seconds.get("tudo")}), flush=True)
    counts = {}
    # the same aggregate without the repartition, for scale
    plain = session("CACHE_ONLY", True)
    clear_scan_cache()
    _, plain_cold = timed(agg(plain, False))
    plain_warm = [timed(agg(plain, False))[1] for _ in range(2)]
    for mode, aqe in EXCHANGE_RUNS:
        name = f"agg {mode} aqe={'on' if aqe else 'off'}"
        s = session(mode, aqe)
        clear_scan_cache()
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = agg(s)
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] exchange {name} " + json.dumps(c), flush=True)
        check(c["hash_pairs_launches"] > 0,
              f"exchange {name}: hash_pairs was not launched")
        check(c["collision_fallbacks"] == 0,
              f"exchange {name}: hash-collision fallbacks")
        check(df.fallback_summary()["fallback_ops"] == 0,
              f"exchange {name}: {df.fallback_summary()}")
        check_sums(name, got)
        ex = exchange_metrics(df)
        want_ex = ("TpuHostShuffleExchangeExec" if mode == "MULTITHREADED"
                   else "TpuShuffleExchangeExec")
        check(ex.get("exchange") == want_ex and ("aqe_reads" in ex) == aqe,
              f"exchange {name}: plan {df._last_plan.tree_string()}")
        warm, warm_ex = [], []
        for _ in range(EXCHANGE_WARM_RUNS):
            wdf = agg(s)
            out, wall = timed(wdf)
            warm.append(wall)
            warm_ex.append(exchange_metrics(wdf))
            check_sums(name + " warm", out)
        # the exchange's metrics of the cold run (its timers hold the
        # scan's H2D: they time the child's pull) and of the faster warm
        # run
        line = dict(cold=ex, warm=warm_ex[warm.index(min(warm))],
                    rows=got.num_rows, cold_wall_s=cold,
                    wall_s_median=statistics.median(warm), wall_s=warm,
                    hash_pairs_launches=c["hash_pairs_launches"],
                    without_repartition_cold_wall_s=plain_cold,
                    without_repartition_wall_s_median=statistics.median(
                        plain_warm))
        print(f"[exchange] {name} SF{SF:g} " + json.dumps(line), flush=True)

    # both transports, AQE off: partitions row for row, counts by murmur3
    want_counts = np.bincount(spark_pmod(spark_murmur3_long(
        li.column("l_orderkey").to_numpy()), EXCHANGE_PARTS),
        minlength=EXCHANGE_PARTS)
    parts = {}
    for mode in ("MULTITHREADED", "CACHE_ONLY"):
        df = session(mode, False).createDataFrame(li).repartition(
            EXCHANGE_PARTS, "l_orderkey")
        plan = df._execute_plan()
        t0 = time.perf_counter()
        parts[mode] = device_partitions(plan.children[0], EXCHANGE_PARTS)
        got_counts = [_rows_of(p) for p in parts[mode]]
        check(got_counts == want_counts.tolist(),
              f"exchange {mode}: partition rows {got_counts}, numpy "
              f"murmur3 says {want_counts.tolist()}")
        print(f"[exchange] hash {mode} partition rows " + json.dumps(
            {"rows": got_counts, "equal_numpy_murmur3": True,
             "read_s": time.perf_counter() - t0}), flush=True)
    check(same_partitions(parts["MULTITHREADED"], parts["CACHE_ONLY"]),
          "exchange: the two transports' partitions differ")
    del parts

    # orders, every column, round robin through the host shuffle
    orders = tables["orders"]
    n = orders.num_rows
    clear_scan_cache()
    df = session("MULTITHREADED", False).createDataFrame(orders) \
        .repartition(EXCHANGE_PARTS)
    plan = df._execute_plan()
    t0 = time.perf_counter()
    rr = device_partitions(plan.children[0], EXCHANGE_PARTS)
    rr_counts = [_rows_of(p) for p in rr]
    del rr
    want_rr = np.bincount(np.arange(n) % EXCHANGE_PARTS).tolist()
    check(rr_counts == want_rr, f"exchange orders round robin: {rr_counts}")
    ex = find_node(plan, "TpuHostShuffleExchangeExec")
    print("[exchange] orders roundrobin MULTITHREADED " + json.dumps(
        {"rows": rr_counts, "seconds": time.perf_counter() - t0,
         "bytesWritten": ex.metrics["bytesWritten"].value,
         "writeTime": ex.metrics["writeTime"].value,
         "readTime": ex.metrics["readTime"].value,
         "transferTime": ex.metrics["transferTime"].value}), flush=True)
    del df, plan, ex
    df = session("MULTITHREADED", True).createDataFrame(orders) \
        .repartition(EXCHANGE_PARTS)
    got, wall = timed(df)
    check(got.num_rows == n, f"orders round robin: {got.num_rows} rows")
    keep = ["o_orderkey", "o_comment"]
    check(got.select(keep).sort_by("o_orderkey").equals(
        orders.select(keep).sort_by("o_orderkey")),
        "orders round robin: (o_orderkey, o_comment) differ from the input")
    print("[exchange] orders roundrobin MULTITHREADED aqe=on " + json.dumps(
        dict(exchange_metrics(df), wall_s=wall, rows=got.num_rows,
             multiset_equal=True)), flush=True)
    del df, got

    # customer by its 5-value string key
    cust = tables["customer"]
    seg = cust.column("c_mktsegment").to_pylist()
    pid_of = {v: int(spark_pmod(spark_murmur3_bytes(v.encode()),
                                EXCHANGE_PARTS)) for v in set(seg)}
    want_c = np.bincount([pid_of[v] for v in seg],
                         minlength=EXCHANGE_PARTS).tolist()
    for aqe in (False, True):
        df = session("MULTITHREADED", aqe).createDataFrame(cust) \
            .repartition(EXCHANGE_PARTS, "c_mktsegment")
        plan = df._execute_plan()
        t0 = time.perf_counter()
        if not aqe:
            cp = device_partitions(plan.children[0], EXCHANGE_PARTS)
            got_c = [_rows_of(p) for p in cp]
            check(got_c == want_c, f"customer by c_mktsegment: {got_c}, "
                  f"numpy murmur3 says {want_c}")
            ex = find_node(plan, "TpuHostShuffleExchangeExec")
            line = {"rows": got_c, "equal_numpy_murmur3": True,
                    "partitionTime": ex.metrics["partitionTime"].value,
                    "bytesWritten": ex.metrics["bytesWritten"].value}
        else:
            out = df.toArrow()
            check(out.num_rows == cust.num_rows, "customer rows lost")
            line = exchange_metrics(df)
            check(line["splitSkewedPartitions"] == 0,
                  "the hash exchange over c_mktsegment was split")
        line["seconds"] = time.perf_counter() - t0
        print(f"[exchange] customer c_mktsegment aqe="
              f"{'on' if aqe else 'off'} " + json.dumps(line), flush=True)
    clear_scan_cache()
    return counts


# ---------------------------------------------------------------------------
# [breadth]: the scalar and aggregate breadth at SF1
# ---------------------------------------------------------------------------

REPORT_EVERY = 60  # the report's filter: l_orderkey % 60 == 0
BREADTH_KILL = "spark.rapids.sql.expression.Remainder"
KILL_REASON = ("expression Remainder disabled by "
               f"{BREADTH_KILL}=false")  # the JAX package's text
PROFILE_VARIANCE = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")
PROFILE_COLUMNS = ("l_extendedprice", "l_discount", "l_quantity")


def with_comment(li, orders):
    """lineitem with an ``l_comment``: the generator (``bench``'s,
    column for column) has none, so each line takes its order's
    ``o_comment`` joined to its ``l_shipinstruct`` — 19 to 70 bytes,
    across the 32-byte stripe of xxhash64 — made on the host at set-up
    (``o_orderkey`` is the row number of orders)."""
    import pyarrow.compute as pc
    comment = pc.binary_join_element_wise(
        pc.take(orders["o_comment"], li["l_orderkey"]),
        li["l_shipinstruct"], " ")
    return li.append_column("l_comment", comment)


def lineitem_profile(s, li):
    """Run 1: a profiling query — the variance family of three columns,
    the exact median price, the nearest-rank 90th quantity percentile,
    the first ship mode in table order, string extremes and a mean, by
    (l_returnflag, l_linestatus): the gathered holistic pass."""
    from spark_rapids_tpu_torch.sql import functions as F
    aggs = [getattr(F, fn)(c).alias(f"{fn}_{c}")
            for fn in PROFILE_VARIANCE for c in PROFILE_COLUMNS]
    aggs += [F.percentile("l_extendedprice", 0.5).alias("p50_price"),
             F.approx_percentile("l_quantity", 0.9).alias("p90_qty"),
             F.first("l_shipmode").alias("first_mode"),
             F.min("l_shipmode").alias("min_mode"),
             F.max("l_shipinstruct").alias("max_instr"),
             F.mean("l_tax").alias("mean_tax")]
    return s.createDataFrame(li).groupBy(
        "l_returnflag", "l_linestatus").agg(*aggs)


def lineitem_suppliers(s, li):
    """Run 1b: ``approx_count_distinct(l_suppkey)`` by the profile's
    keys (a distinct aggregate cannot share an ``agg`` with others, in
    either package)."""
    from spark_rapids_tpu_torch.sql import functions as F
    return s.createDataFrame(li).groupBy(
        "l_returnflag", "l_linestatus").agg(
        F.approx_count_distinct("l_suppkey").alias("suppliers"))


def _groups(li, keys):
    """{key tuple: row indices in table order} of a small-cardinality
    grouping of string columns (their dictionary codes combined)."""
    import numpy as np
    import pyarrow.compute as pc
    code = np.zeros(li.num_rows, np.int64)
    dicts = []
    for k in keys:
        enc = pc.dictionary_encode(li[k]).combine_chunks()
        code = code * len(enc.dictionary) + enc.indices.to_numpy()
        dicts.append(enc.dictionary.to_pylist())
    out = {}
    for c in np.unique(code):
        parts, rest = [], int(c)
        for d in reversed(dicts):
            parts.append(d[rest % len(d)])
            rest //= len(d)
        out[tuple(reversed(parts))] = np.flatnonzero(code == c)
    return out


def ref_lineitem_profile(li):
    """numpy per group: two-pass variances, the percentiles by the JAX
    package's rank rules (exact: p(n-1) interpolated; approx: element
    ceil(pn) - 1 of the sorted values), the first row's ship mode, the
    byte-order string extremes, the mean."""
    import math
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    rows = []
    cols = {c: li[c].to_numpy() for c in PROFILE_COLUMNS + ("l_tax",)}
    mode, instr = li["l_shipmode"], li["l_shipinstruct"]
    for (rf, ls), idx in _groups(li, ["l_returnflag",
                                      "l_linestatus"]).items():
        row = {"l_returnflag": rf, "l_linestatus": ls}
        for fn in PROFILE_VARIANCE:
            for c in PROFILE_COLUMNS:
                v = np.var(cols[c][idx], ddof=1 if "samp" in fn else 0)
                row[f"{fn}_{c}"] = float(np.sqrt(v) if "stddev" in fn
                                         else v)
        price = np.sort(cols["l_extendedprice"][idx])
        r = 0.5 * (len(price) - 1)
        lo = math.floor(r)
        row["p50_price"] = float(price[lo] + (r - lo)
                                 * (price[math.ceil(r)] - price[lo]))
        qty = np.sort(cols["l_quantity"][idx])
        row["p90_qty"] = float(qty[min(max(math.ceil(0.9 * len(qty)) - 1,
                                           0), len(qty) - 1)])
        row["first_mode"] = mode[int(idx[0])].as_py()
        # pyarrow orders strings by their bytes, as Spark does
        row["min_mode"] = pc.min_max(mode.take(idx))["min"].as_py()
        row["max_instr"] = pc.min_max(instr.take(idx))["max"].as_py()
        row["mean_tax"] = float(cols["l_tax"][idx].mean())
        rows.append(row)
    return pa.Table.from_pylist(rows)


def ref_lineitem_suppliers(li):
    import numpy as np
    import pyarrow as pa
    rows = []
    supp = li["l_suppkey"].to_numpy()
    for (rf, ls), idx in _groups(li, ["l_returnflag",
                                      "l_linestatus"]).items():
        rows.append({"l_returnflag": rf, "l_linestatus": ls,
                     "suppliers": int(len(np.unique(supp[idx])))})
    return pa.Table.from_pylist(rows)


def _maybe_net(F, col):
    """``price * (1 - discount)`` where the discount is above 5%, null on
    the other rows."""
    return F.when(col("l_discount") > 0.05,
                  col("l_extendedprice") * (1 - col("l_discount")))


def date_report(s, li):
    """Run 2: the date-and-arithmetic report over lines of every 60th
    order (about 100,000 rows), row for row."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    price, qty = col("l_extendedprice"), col("l_quantity")
    maybe = _maybe_net(F, col)
    return s.createDataFrame(li).filter(
        col("l_orderkey") % REPORT_EVERY == 0).select(
        "l_orderkey",
        F.month(col("l_shipdate")).alias("month"),
        F.dayofmonth(col("l_shipdate")).alias("day"),
        F.datediff(col("l_receiptdate"), col("l_shipdate")).alias("transit"),
        F.date_add(col("l_shipdate"), 30).alias("due"),
        F.date_sub(col("l_commitdate"), 7).alias("warn"),
        (-qty).alias("neg_qty"),
        F.abs(price - 50000).alias("dev"),
        F.floor(price / 7).alias("floor7"), F.ceil(price / 7).alias("ceil7"),
        F.round(price * col("l_discount"), 2).alias("disc_amt"),
        F.sqrt(price).alias("sqrt_price"), F.log(qty).alias("log_qty"),
        F.exp(col("l_discount")).alias("exp_disc"),
        F.pow(col("l_tax") + 1, qty).alias("pow_tax"),
        F.coalesce(maybe, price).alias("net"),
        maybe.isNull().alias("full_price"),
        maybe.eqNullSafe(price * (1 - col("l_discount"))).alias("eqns"),
        (col("l_partkey") % 7).alias("pmod"))


def ref_date_report(li):
    """numpy over the same rows, in table order."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    f = li.filter(every_mask(li, REPORT_EVERY))
    ship = f["l_shipdate"].cast(pa.int32()).to_numpy()
    receipt = f["l_receiptdate"].cast(pa.int32()).to_numpy()
    commit = f["l_commitdate"].cast(pa.int32()).to_numpy()
    price = f["l_extendedprice"].to_numpy()
    qty = f["l_quantity"].to_numpy()
    disc = f["l_discount"].to_numpy()
    tax = f["l_tax"].to_numpy()
    x = price * disc
    rounded = np.sign(x) * np.floor(np.abs(x) * 100.0 + 0.5) / 100.0
    discounted = disc > 0.05
    net = price * (1 - disc)
    return pa.table({
        "l_orderkey": f["l_orderkey"],
        "month": pc.cast(pc.month(f["l_shipdate"]), pa.int32()),
        "day": pc.cast(pc.day(f["l_shipdate"]), pa.int32()),
        "transit": pa.array((receipt - ship).astype(np.int32)),
        "due": pa.array(ship + 30, pa.int32()).cast(pa.date32()),
        "warn": pa.array(commit - 7, pa.int32()).cast(pa.date32()),
        "neg_qty": pa.array(-qty),
        "dev": pa.array(np.abs(price - 50000.0)),
        "floor7": pa.array(np.floor(price / 7.0).astype(np.int64)),
        "ceil7": pa.array(np.ceil(price / 7.0).astype(np.int64)),
        "disc_amt": pa.array(rounded),
        "sqrt_price": pa.array(np.sqrt(price)),
        "log_qty": pa.array(np.log(qty)),
        "exp_disc": pa.array(np.exp(disc)),
        "pow_tax": pa.array(np.power(tax + 1.0, qty)),
        "net": pa.array(np.where(discounted, net, price)),
        "full_price": pa.array(~discounted),
        "eqns": pa.array(discounted),
        "pmod": pa.array(f["l_partkey"].to_numpy() % 7),
    })


def month_report(s, li):
    """Run 2b: the report's expressions grouped by ``month(l_shipdate)``
    over all 6,000,000 rows (plain aggregates, the variance family and a
    numeric first: the partial/merge passes through ``hash_pairs``)."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    price = col("l_extendedprice")
    return s.createDataFrame(li).groupBy(
        F.month(col("l_shipdate")).alias("month")).agg(
        F.count("*").alias("n"),
        F.sum(F.datediff(col("l_receiptdate"), col("l_shipdate"))).alias(
            "transit"),
        F.sum(F.floor(price / 7)).alias("floor7"),
        F.max(F.round(price * col("l_discount"), 2)).alias("max_disc"),
        F.sum(col("l_partkey") % 7).alias("pmod"),
        F.sum(F.coalesce(_maybe_net(F, col), price)).alias("net"),
        F.stddev_samp("l_discount").alias("sd_disc"),
        F.var_pop("l_tax").alias("vp_tax"),
        F.first("l_orderkey").alias("first_order"),
        F.avg(F.abs(price - 50000)).alias("mean_dev"))


def ref_month_report(li):
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    month = pc.month(li["l_shipdate"]).to_numpy()
    price = li["l_extendedprice"].to_numpy()
    disc = li["l_discount"].to_numpy()
    tax = li["l_tax"].to_numpy()
    transit = (li["l_receiptdate"].cast(pa.int32()).to_numpy().astype(
        np.int64) - li["l_shipdate"].cast(pa.int32()).to_numpy())
    x = price * disc
    rounded = np.sign(x) * np.floor(np.abs(x) * 100.0 + 0.5) / 100.0
    net = np.where(disc > 0.05, price * (1 - disc), price)
    pmod = li["l_partkey"].to_numpy() % 7
    okey = li["l_orderkey"].to_numpy()
    rows = []
    for m in np.unique(month):
        idx = np.flatnonzero(month == m)
        rows.append({
            "month": int(m), "n": int(len(idx)),
            "transit": int(transit[idx].sum()),
            "floor7": int(np.floor(price[idx] / 7.0).astype(np.int64).sum()),
            "max_disc": float(rounded[idx].max()),
            "pmod": int(pmod[idx].sum()), "net": float(net[idx].sum()),
            "sd_disc": float(np.std(disc[idx], ddof=1)),
            "vp_tax": float(np.var(tax[idx])),
            "first_order": int(okey[idx[0]]),
            "mean_dev": float(np.abs(price[idx] - 50000.0).mean())})
    return pa.Table.from_pylist(rows)


def hash_report(s, li):
    """Run 3: Spark's two hashes of (l_orderkey, l_comment) over the
    report's rows."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    return s.createDataFrame(li).filter(
        col("l_orderkey") % REPORT_EVERY == 0).select(
        "l_orderkey", "l_comment",
        F.hash(col("l_orderkey"), col("l_comment")).alias("murmur3"),
        F.xxhash64(col("l_orderkey"), col("l_comment")).alias("xxhash64"))


# -- this script's own Spark xxhash64 (numpy uint64) --------------------------

XXH_P = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
         0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
_M64 = (1 << 64) - 1


def xxh64_bytes_py(b: bytes, seed: int) -> int:
    """Spark's ``XXH64.hashUnsafeBytes`` of one byte string, Python
    ints (the scalar check of ``np_xxh64_strings``)."""
    p1, p2, p3, p4, p5 = XXH_P

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def rnd(acc, x):
        return (rotl((acc + x * p2) & _M64, 31) * p1) & _M64

    n, i = len(b), 0
    if n >= 32:
        v = [(seed + p1 + p2) & _M64, (seed + p2) & _M64, seed,
             (seed - p1) & _M64]
        while i + 32 <= n:
            v = [rnd(v[k], int.from_bytes(b[i + 8 * k:i + 8 * k + 8],
                                          "little")) for k in range(4)]
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & _M64
        for x in v:
            h = (((h ^ rnd(0, x)) * p1) + p4) & _M64
    else:
        h = (seed + p5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(b[i:i + 8], "little")), 27)
             * p1 + p4) & _M64
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ ((int.from_bytes(b[i:i + 4], "little") * p1) & _M64),
                  23) * p2 + p3) & _M64
        i += 4
    while i < n:
        h = (rotl(h ^ ((b[i] * p5) & _M64), 11) * p1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _M64
    h ^= h >> 29
    h = (h * p3) & _M64
    return h ^ (h >> 32)


def _np_u64(x):
    import numpy as np
    return np.uint64(x)


def np_xxh64_fmix(h):
    import numpy as np
    h = h ^ (h >> np.uint64(33))
    h = h * _np_u64(XXH_P[1])
    h = h ^ (h >> np.uint64(29))
    h = h * _np_u64(XXH_P[2])
    return h ^ (h >> np.uint64(32))


def _np_rotl(x, r):
    import numpy as np
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def np_xxh64_long(values, seed):
    """Spark's ``XXH64.hashLong`` of int64 values with per-row uint64
    seeds."""
    import numpy as np
    p1, p2, _, p4, p5 = (_np_u64(p) for p in XXH_P)
    with np.errstate(over="ignore"):
        v = np.asarray(values, np.int64).view(np.uint64)
        h = seed + p5 + np.uint64(8)
        h = h ^ (_np_rotl(v * p2, 31) * p1)
        return np_xxh64_fmix(_np_rotl(h, 27) * p1 + p4)


def string_matrix(arr):
    """A pyarrow string array -> (uint8[n, W] zero-padded, int64 byte
    lengths)."""
    import numpy as np
    import pyarrow.compute as pc
    arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
    n = len(arr)
    offs = np.frombuffer(arr.buffers()[1], np.int32)[arr.offset:
                                                     arr.offset + n + 1]
    data = np.frombuffer(arr.buffers()[2], np.uint8)
    lengths = pc.binary_length(arr).to_numpy().astype(np.int64)
    w = max(int(lengths.max(initial=0)), 1)
    mat = np.zeros((n, w), np.uint8)
    for j in range(w):
        rows = lengths > j
        mat[rows, j] = data[offs[:-1][rows] + j]
    return mat, lengths


def np_xxh64_strings(mat, lengths, seed):
    """Spark's ``XXH64.hashUnsafeBytes`` of each row (per-row uint64
    seeds): the stripes at fixed offsets, then the 8-byte words, the
    4-byte word and the tail bytes gathered at each row's own offset."""
    import numpy as np
    p1, p2, p3, p4, p5 = (_np_u64(p) for p in XXH_P)
    n, w = mat.shape
    m = mat.astype(np.uint64)
    rows = np.arange(n)

    def word_at(pos, nbytes):
        k = np.zeros(n, np.uint64)
        for j in range(nbytes):
            k |= m[rows, np.minimum(pos + j, w - 1)] << np.uint64(8 * j)
        return k

    def rnd(acc, x):
        return _np_rotl(acc + x * p2, 31) * p1

    with np.errstate(over="ignore"):
        stripes = (lengths // 32) * 32
        v = [seed + p1 + p2, seed + p2, seed.copy(), seed - p1]
        for base in range(0, w - 31, 32):
            on = base + 32 <= stripes
            for k in range(4):
                at = np.full(n, base + 8 * k)
                v[k] = np.where(on, rnd(v[k], word_at(at, 8)), v[k])
        big = (_np_rotl(v[0], 1) + _np_rotl(v[1], 7) + _np_rotl(v[2], 12)
               + _np_rotl(v[3], 18))
        for x in v:
            big = (big ^ rnd(np.uint64(0), x)) * p1 + p4
        h = np.where(lengths >= 32, big, seed + p5) + lengths.astype(
            np.uint64)
        pos = stripes.copy()
        for _ in range(3):
            on = pos + 8 <= lengths
            nh = _np_rotl(h ^ rnd(np.uint64(0), word_at(pos, 8)), 27) * p1 + p4
            h, pos = np.where(on, nh, h), np.where(on, pos + 8, pos)
        on = pos + 4 <= lengths
        nh = _np_rotl(h ^ (word_at(pos, 4) * p1), 23) * p2 + p3
        h, pos = np.where(on, nh, h), np.where(on, pos + 4, pos)
        for _ in range(3):
            on = pos < lengths
            nh = _np_rotl(h ^ (word_at(pos, 1) * p5), 11) * p1
            h, pos = np.where(on, nh, h), np.where(on, pos + 1, pos)
        return np_xxh64_fmix(h)


def np_murmur3_strings(mat, lengths, seed):
    """Spark's ``hashUnsafeBytes`` (murmur3 x86_32) of each row, per-row
    uint32 seeds: 4-byte little-endian blocks, then each tail byte
    sign-extended as a block of its own."""
    import numpy as np
    m = mat.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = seed.astype(np.uint32)
        aligned = lengths - lengths % 4
        for blk in range(0, mat.shape[1] - 3, 4):
            k = (m[:, blk] | (m[:, blk + 1] << np.uint32(8))
                 | (m[:, blk + 2] << np.uint32(16))
                 | (m[:, blk + 3] << np.uint32(24)))
            h = np.where(blk + 4 <= aligned, _mix_h1(h, _mix_k1(k)), h)
        for pos in range(mat.shape[1]):
            b = m[:, pos]
            signed = np.where(b >= 128, b | np.uint32(0xFFFFFF00), b)
            h = np.where((pos >= aligned) & (pos < lengths),
                         _mix_h1(h, _mix_k1(signed)), h)
        return _fmix32(h, lengths.astype(np.uint32))


def ref_hash_report(f):
    """numpy Spark hashes of the report rows' (l_orderkey, l_comment),
    each string seeded by its key's hash; a few rows held against the
    scalar forms too."""
    import numpy as np
    import pyarrow as pa
    key = f["l_orderkey"].to_numpy()
    mat, lengths = string_matrix(f["l_comment"])
    mm = np_murmur3_strings(mat, lengths, spark_murmur3_long(key))
    xx = np_xxh64_strings(mat, lengths, np_xxh64_long(key, _np_u64(42)))
    comments = f["l_comment"].to_pylist()
    for i in range(0, len(key), max(1, len(key) // 64)):
        b = comments[i].encode()
        seed = int(spark_murmur3_long([key[i]])[0])
        check(int(mm[i]) == spark_murmur3_bytes(b, seed),
              f"numpy murmur3 differs from its scalar form at row {i}")
        s64 = int(np_xxh64_long([key[i]], _np_u64(42))[0])
        check(int(xx[i]) == xxh64_bytes_py(b, s64),
              f"numpy xxhash64 differs from its scalar form at row {i}")
    return pa.table({"l_orderkey": f["l_orderkey"],
                     "l_comment": f["l_comment"],
                     "murmur3": pa.array(mm.view(np.int32)),
                     "xxhash64": pa.array(xx.view(np.int64))})


def xxhash_alone(tables, session) -> dict:
    """``xxhash64(l_comment)`` alone over all 6,000,000 rows at the
    batches of their scan (``host_to_device`` at the session's batch
    rows): the expression's time by CUDA events around the calls
    (``cuda_ms``, host time included) beside its byte bound (the
    comment matrix and lengths read once, the hashes written once, over
    the memory rate); every 60th row against this script's numpy
    xxhash64."""
    import numpy as np
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.ops import expressions as E
    from spark_rapids_tpu_torch.ops import hashing as HH
    conf = session.rapids_conf()
    tbl = tables["lineitem"].select(["l_comment"])
    batches = [host_to_device(tbl.slice(lo, conf.batch_rows),
                              session.device,
                              min_bucket=conf.min_bucket_rows)
               for lo in range(0, tbl.num_rows, conf.batch_rows)]
    expr = HH.XxHash64([E.BoundReference(0, T.StringT)])
    outs = [expr.eval(b) for b in batches]
    got = torch.cat([o.data[:min(conf.batch_rows, tbl.num_rows - i *
                                 conf.batch_rows)]
                     for i, o in enumerate(outs)]).cpu().numpy()
    sample = tbl.take(np.arange(0, tbl.num_rows, REPORT_EVERY))
    mat, lengths = string_matrix(sample["l_comment"])
    want = np_xxh64_strings(mat, lengths,
                            np.full(len(lengths), 42, np.uint64))
    check(np.array_equal(got[::REPORT_EVERY], want.view(np.int64)),
          "xxhash64(l_comment) alone differs from the numpy reference")
    in_bytes = sum(_col_bytes(c) for b in batches for c in b.columns)
    out_bytes = sum(_col_bytes(o) for o in outs)
    ms = cuda_ms(lambda: [expr.eval(b) for b in batches],
                 iters=EXPR_TIMING_ITERS)
    bound = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    return {"expression": "xxhash64(l_comment)", "rows": tbl.num_rows,
            "batches": [list(b.columns[0].data.shape) for b in batches],
            "ms": ms, "bound_ms": bound, "bound_by": "bytes",
            "pct_of_bound": 100.0 * bound / ms,
            "equal_reference_rows": int(len(want))}


def breadth_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """The scalar and aggregate breadth at SF1 under ``SESSION_CONF``
    (any fallback raises), each run a path of its own (the scan cache
    cleared, counts set to 0 before its cold run, read after), each
    against this script's numpy/pyarrow reference, then
    ``BREADTH_WARM_RUNS`` warm runs equal to the cold one:

    1. the lineitem profile (``lineitem_profile``: the gathered holistic
       pass) and its supplier count (``approx_count_distinct``);
    2. the date-and-arithmetic report over every 60th order's lines,
       row for row, and its expressions grouped by month over all rows
       (``hash_pairs`` launched);
    3. ``hash`` and ``xxhash64`` of (l_orderkey, l_comment) over the
       report's rows, exactly;
    4. ``xxhash64(l_comment)`` alone over all rows against its byte
       bound;
    5. the report under ``spark.rapids.sql.expression.Remainder=false``
       in a session without test mode: it falls back naming the switch
       with the JAX package's reason, and gives the device run's rows.

    Floats are held within 1e-9 relative (the repository's oracle rule),
    the percentiles, ``first``, the string extremes, integers, dates,
    booleans and hashes exactly.  Returns the counts of the runs."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    li = with_comment(tables["lineitem"], tables["orders"])
    tables = dict(tables, lineitem=li)
    s = TpuSession(dict(SESSION_CONF), device=dev)
    counts, lines = {}, {}

    def run(name, build, want, ordered=False, hashed=True, exact=()):
        CB.reset_counts()
        KN.COUNTERS.reset()
        clear_scan_cache()
        df = build()
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] breadth {name} " + json.dumps(c), flush=True)
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"breadth {name}: plan rewrite fell back: {fb}")
        check(c["collision_fallbacks"] == 0,
              f"breadth {name}: hash-collision fallbacks")
        check(not hashed or c["hash_pairs_launches"] > 0,
              f"breadth {name}: hash_pairs was not launched")
        check(got.column_names == want.column_names,
              f"breadth {name} columns {got.column_names}")
        if ordered:
            check(rows_equal_ordered(got, want),
                  f"breadth {name} differs from its reference row for row")
        else:
            check(rows_equal(got, want), f"breadth {name} differs from "
                  f"its reference:\n{got}\n{want}")
        for cname in exact:
            g = sorted(map(repr, zip(*(got[k].to_pylist() for k in
                                       got.column_names[:2] + [cname]))))
            w = sorted(map(repr, zip(*(want[k].to_pylist() for k in
                                       want.column_names[:2] + [cname]))))
            check(g == w, f"breadth {name}: {cname} is not exact")
        warm = []
        for _ in range(BREADTH_WARM_RUNS):
            out, wall = timed(build())
            warm.append(wall)
            check(rows_equal(out, got, 0.0),
                  f"breadth {name}: a warm run differs")
        lines[name] = line = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "hash_pairs_shapes": c["shapes"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": 0, "equal_reference": True}
        print(f"[breadth] {name} " + json.dumps(line), flush=True)
        return got

    # -- 1. the lineitem profile (holistic) and its distinct suppliers
    profile = run("lineitem profile", lambda: lineitem_profile(s, li),
                  ref_lineitem_profile(li), hashed=False,
                  exact=("p50_price", "p90_qty", "first_mode", "min_mode",
                         "max_instr"))
    check(profile.num_rows == 6, "the profile should have 6 groups")
    run("lineitem suppliers", lambda: lineitem_suppliers(s, li),
        ref_lineitem_suppliers(li))
    # -- 2. the report, row for row, and grouped by month over all rows
    report = run("date report", lambda: date_report(s, li),
                 ref_date_report(li), ordered=True, hashed=False)
    check(90_000 < report.num_rows < 110_000,
          f"the report has {report.num_rows} rows")
    run("month report", lambda: month_report(s, li), ref_month_report(li),
        exact=("n", "transit", "floor7", "pmod", "first_order"))
    # -- 3. the two hashes over the report's rows
    f = li.filter(every_mask(li, REPORT_EVERY))
    run("hashes", lambda: hash_report(s, li), ref_hash_report(f),
        ordered=True, hashed=False)
    # -- 4. xxhash64 alone over every comment
    alone = xxhash_alone(tables, s)
    print("[breadth] alone " + json.dumps(alone), flush=True)
    # -- 5. the kill switch: the report falls back, the same rows
    plain = TpuSession({BREADTH_KILL: False,
                        BLACKBOX_KEY: SESSION_CONF[BLACKBOX_KEY]},
                       device=dev)
    clear_scan_cache()
    df = date_report(plain, li)
    got, wall = timed(df)
    report_lines = df._last_override.fallback_report()
    fb = df.fallback_summary()
    check(report_lines and all(KILL_REASON in r for r in report_lines),
          f"kill switch: the fallback report {report_lines}")
    check(fb["fallback_ops"] >= 1, f"kill switch: no fallback: {fb}")
    check(rows_equal_ordered(got, report),
          "kill switch: the rows differ from the device run's")
    line = {"rows": got.num_rows, "wall_s": wall,
            "fallback_report": report_lines, "fallback_ops":
            fb["fallback_ops"], "device_ops": fb["device_ops"],
            "equal_device_run": True}
    print("[breadth] kill switch " + json.dumps(line), flush=True)
    print("[breadth] " + json.dumps({
        "seconds": time.perf_counter() - t_phase,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
        "warm_wall_s": {k: v["warm_wall_s"] for k, v in lines.items()},
        "xxhash64_alone_ms": alone["ms"],
        "xxhash64_alone_bound_ms": alone["bound_ms"]}), flush=True)
    return counts


def every_mask(t, every: int):
    """``l_orderkey % every == 0`` as a pyarrow mask."""
    import pyarrow as pa
    return pa.array(t["l_orderkey"].to_numpy() % every == 0)


def rows_equal_ordered(a, b, tol=1e-9) -> bool:
    """Row for row in order: floats within ``tol`` relative (absolute
    below 1), everything else exactly."""
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        return False
    for name in a.column_names:
        for u, v in zip(a[name].to_pylist(), b[name].to_pylist()):
            if isinstance(u, float) and isinstance(v, float):
                if not (u == v or abs(u - v)
                        <= tol * max(1.0, abs(u), abs(v))):
                    return False
            elif u != v:
                return False
    return True


def breadth_only(dev, tables, CB, KN) -> int:
    """``--breadth``: the [breadth] phase alone (after the build and the
    kernel checks)."""
    t0 = time.perf_counter()
    counts = breadth_phase(dev, tables, CB, KN, set())
    print("[breadth only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


# -- [decimal]: TPC-H over decimal(12,2) columns, and the time zones ------

DECIMAL_ZONES = ("America/Los_Angeles", "Asia/Kolkata")
TZ_CHECK_EVERY = 100  # rows checked against zoneinfo: every 100th
INCOMPAT_CONF = {"spark.rapids.sql.incompatibleOps.enabled": True}


def _unscaled(arr):
    """The unscaled int64 values of an Arrow decimal column of precision
    <= 18: the low words of its 16-byte little-endian values."""
    import numpy as np
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    raw = np.frombuffer(arr.buffers()[1], np.int64, 2 * len(arr),
                        arr.offset * 16)
    return raw[0::2].copy()


def _dec_array(values, precision: int, scale: int):
    """Unscaled python ints -> an Arrow decimal128 array, exactly (a
    60-digit context: no rounding at 38 digits)."""
    import decimal
    import pyarrow as pa
    ctx = decimal.Context(prec=60)
    return pa.array([decimal.Decimal(int(v)).scaleb(-scale, ctx)
                     for v in values], pa.decimal128(precision, scale))


def _group_sums(inv, n_groups: int, columns):
    """Per-group sums of int64 columns (exact: ``np.add.reduceat`` in
    int64, every caller's bound below 2^63) and of float64 columns."""
    import numpy as np
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(n_groups))
    return [np.add.reduceat(c[order], starts) for c in columns]


def ref_decimal_q1(li):
    """q1 over the decimal(12,2) columns, in int64 cents: sum_qty and
    sum_base at scale 2, sum_disc at scale 4 (a row's value below 1e8),
    sum_charge at scale 6 (below 1.1e10 a row, 6.6e16 over 6M rows:
    int64 holds every sum); the averages over the values as doubles, as
    Spark's avg of a decimal cast to double."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    ship = li["l_shipdate"].combine_chunks().cast(pa.int32()).to_numpy()
    m = ship <= (datetime.date(1998, 9, 2) - datetime.date(1970, 1, 1)).days
    q, p, d, tx = (_unscaled(li[c])[m] for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    # the two 1-byte keys as one code: returnflag's byte, linestatus's
    rf, ls = (pc.dictionary_encode(li[c].combine_chunks().filter(
        pa.array(m))) for c in ("l_returnflag", "l_linestatus"))
    code = (np.asarray(rf.dictionary.to_pylist(), "U1").view(np.int32)
            [rf.indices.to_numpy()] * 256
            + np.asarray(ls.dictionary.to_pylist(), "U1").view(np.int32)
            [ls.indices.to_numpy()])
    uniq, inv = np.unique(code, return_inverse=True)
    disc = p * (100 - d)
    charge = disc * (100 + tx)
    ones = np.ones(len(q), np.int64)
    sq, sp, sd, sc, n = _group_sums(inv, len(uniq),
                                    [q, p, disc, charge, ones])
    aq, ap, ad = _group_sums(inv, len(uniq),
                             [q / 100.0, p / 100.0, d / 100.0])
    return pa.table({
        "l_returnflag": pa.array([chr(int(k) // 256) for k in uniq]),
        "l_linestatus": pa.array([chr(int(k) % 256) for k in uniq]),
        "sum_qty": _dec_array(sq, 22, 2),
        "sum_base": _dec_array(sp, 22, 2),
        "sum_disc": _dec_array(sd, 35, 4),
        "sum_charge": _dec_array(sc, 38, 6),
        "avg_qty": pa.array(aq / n), "avg_price": pa.array(ap / n),
        "avg_disc": pa.array(ad / n), "cnt": pa.array(n)})


def ref_decimal_q6(li):
    """q6's revenue, exactly: the discount compared as a double (the
    engine casts the column for the double literals), the quantity in
    cents against 24 made decimal(12,2)."""
    import numpy as np
    import pyarrow as pa
    ship = li["l_shipdate"].combine_chunks().cast(pa.int32()).to_numpy()
    lo = (datetime.date(1994, 1, 1) - datetime.date(1970, 1, 1)).days
    hi = (datetime.date(1995, 1, 1) - datetime.date(1970, 1, 1)).days
    q, p, d = (_unscaled(li[c]) for c in (
        "l_quantity", "l_extendedprice", "l_discount"))
    m = ((ship >= lo) & (ship < hi) & (d / 100.0 >= 0.05)
         & (d / 100.0 <= 0.07) & (q < 2400))
    rev = int((p[m] * d[m]).sum())  # below 1.1e8 a row: int64 exact
    return pa.table({"revenue": _dec_array([rev], 35, 4)})


def ref_decimal_q18(t):
    """q18 over the cents as int64 columns (pyarrow's exact integer
    sums and joins), its decimals made back from them."""
    import pyarrow as pa
    import pyarrow.compute as pc
    cents = dict(t)
    for name, cols in (("lineitem", ("l_quantity",)),
                       ("orders", ("o_totalprice",))):
        tbl = cents[name]
        for c in cols:
            tbl = tbl.set_column(tbl.schema.get_field_index(c), c,
                                 pa.array(_unscaled(tbl[c])))
        cents[name] = tbl
    li = cents["lineitem"].select(["l_orderkey", "l_quantity"])
    g = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = g.filter(pc.greater(g["l_quantity_sum"], 30000))["l_orderkey"]
    o = cents["orders"].select(["o_orderkey", "o_custkey", "o_orderdate",
                                "o_totalprice"])
    o = o.filter(pc.is_in(o["o_orderkey"], value_set=big))
    j = (cents["customer"].select(["c_custkey", "c_name"])
         .join(o, "c_custkey", "o_custkey", join_type="inner")
         .join(li, "o_orderkey", "l_orderkey", join_type="inner"))
    g = j.group_by(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"]).aggregate([("l_quantity", "sum")])
    g = g.sort_by([("o_totalprice", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 100)
    return pa.table([g["c_name"], g["c_custkey"], g["o_orderkey"],
                     g["o_orderdate"],
                     _dec_array(g["o_totalprice"].to_pylist(), 12, 2),
                     _dec_array(g["l_quantity_sum"].to_pylist(), 22, 2)],
                    names=["c_name", "c_custkey", "o_orderkey",
                           "o_orderdate", "o_totalprice", "sum_qty"])


def zone_table(li):
    """6,000,000 timestamps: each line's ship date plus a second of the
    day taken from its order key (microseconds, UTC)."""
    import numpy as np
    import pyarrow as pa
    days = li["l_shipdate"].combine_chunks().cast(pa.int32()).to_numpy()
    key = li["l_orderkey"].to_numpy()
    secs = days.astype(np.int64) * 86400 + key % 86400
    return pa.table({"ts": pa.array(secs * 1_000_000).cast(
        pa.timestamp("us", tz="UTC"))})


def zone_query(s, t):
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    cols = [col("ts")]
    for tz in DECIMAL_ZONES:
        tag = tz.split("/")[1].lower()
        cols += [F.from_utc_timestamp(col("ts"), tz).alias(f"from_{tag}"),
                 F.to_utc_timestamp(col("ts"), tz).alias(f"to_{tag}")]
    return s.createDataFrame(t).select(*cols)


def check_zones(got) -> int:
    """Every ``TZ_CHECK_EVERY``-th row against Python's zoneinfo, exactly:
    ``from_utc`` adds the offset at the instant; ``to_utc`` subtracts
    the offset at the wall time, and where the wall time is ambiguous or
    skipped takes the lesser of its two ``fold`` offsets — the JAX
    package's documented rule (an overlap resolves to the
    post-transition offset, a gap to the pre-transition one).  Returns
    the rows checked."""
    import zoneinfo
    import pyarrow as pa
    epoch = datetime.datetime(1970, 1, 1)
    ts = got["ts"].cast(pa.int64()).to_numpy()[::TZ_CHECK_EVERY]
    n = 0
    for tz in DECIMAL_ZONES:
        zi = zoneinfo.ZoneInfo(tz)
        tag = tz.split("/")[1].lower()
        fr, to = (got[f"{d}_{tag}"].cast(pa.int64()).to_numpy()
                  [::TZ_CHECK_EVERY] for d in ("from", "to"))
        for v, f, u in zip(ts.tolist(), fr.tolist(), to.tolist()):
            wall = epoch + datetime.timedelta(microseconds=v)
            at = wall.replace(tzinfo=datetime.timezone.utc)
            off = int(at.astimezone(zi).utcoffset().total_seconds())
            check(f == v + off * 1_000_000,
                  f"from_utc_timestamp {tz} at {v}: {f}")
            back = min(int(zi.utcoffset(wall.replace(fold=k))
                           .total_seconds()) for k in (0, 1))
            check(u == v - back * 1_000_000,
                  f"to_utc_timestamp {tz} at {v}: {u}")
            n += 1
    return n


# the builders beyond q1, q6 and q18 that read a decimal column, and the
# join variants that do
DECIMAL_MORE = ("q3", "q5", "q7", "q8", "q9", "q10", "q14", "q15", "q17",
                "q19", "q20", "q17_cond", "q3_full")


def decimal_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """TPC-H over ``decimal(12,2)`` money and quantity columns
    (``tpch.decimal_tables``: spark-sql-perf's schema) at SF1 under
    ``SESSION_CONF`` (any fallback raises), each run a path of its own
    (the scan cache cleared, counts set to 0 before its cold run, read
    after), then 1 warm run equal to the cold one (2 before the
    lakehouse phase came):

    1. q1, q6 and q18 through ``utils/tpch.py``'s builders, against this
       script's int64/pyarrow references: decimal sums, counts and keys
       exactly, the double averages within 1e-9 relative (q6's keyless
       decimal sum is the path on which the JAX package's device run
       fails); then ``DECIMAL_MORE`` (the eleven other builders that
       read a decimal column, ``q17_cond`` and ``q3_full``), one cold
       and one warm run each, against the ``ref_*`` functions run over
       the decimal tables (``_rev`` exact in int64 cents, pyarrow's
       decimal sums exact; the double results within 1e-9);
    2. ``from_utc_timestamp`` and ``to_utc_timestamp`` to
       America/Los_Angeles and Asia/Kolkata over 6,000,000 timestamps,
       every 100th row exactly against ``zoneinfo`` (``check_zones``).

    Also the decimal columns' H2D alone.  Returns the counts of the
    runs."""
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dt = tpch.decimal_tables(tables)
    set_up_s = time.perf_counter() - t0
    li = dt["lineitem"]
    check(li.schema.field("l_tax").type == pa.decimal128(12, 2)
          and dt["orders"].schema.field("o_totalprice").type
          == pa.decimal128(12, 2), "the decimal tables' types")
    t0 = time.perf_counter()
    refs = {"q1": ref_decimal_q1(li), "q6": ref_decimal_q6(li),
            "q18": ref_decimal_q18(dt)}
    ref_s = time.perf_counter() - t0
    zt = zone_table(li)
    s = TpuSession(dict(SESSION_CONF), device=dev)
    sz = TpuSession(dict(SESSION_CONF, **INCOMPAT_CONF), device=dev)
    counts, lines = {}, {}

    def run(name, build, want=None, hashed=True, same_schema=True):
        CB.reset_counts()
        KN.COUNTERS.reset()
        clear_scan_cache()
        df = build()
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] decimal {name} " + json.dumps(c), flush=True)
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"decimal {name}: plan rewrite fell back: {fb}")
        check(c["collision_fallbacks"] == 0,
              f"decimal {name}: hash-collision fallbacks")
        check(not hashed or c["hash_pairs_launches"] > 0,
              f"decimal {name}: hash_pairs was not launched")
        if want is not None and same_schema:
            check(got.schema == want.schema,
                  f"decimal {name} schema {got.schema}")
        elif want is not None:
            # pyarrow's exact sums widen to decimal(38, s): the names,
            # the kinds and each decimal's scale must agree
            check(got.column_names == want.column_names and all(
                _is_dec(g) == _is_dec(w) and (not _is_dec(g)
                                              or g.type.scale == w.type.scale)
                for g, w in zip(got.columns, want.columns)),
                f"decimal {name} schema {got.schema} against "
                f"{want.schema}")
        if want is not None:
            check(rows_equal(got, want), f"decimal {name} differs from "
                  f"its reference:\n{got}\n{want}")
        out, wall = timed(build())
        warm = [wall]
        check(out.equals(got), f"decimal {name}: the warm run differs")
        lines[name] = line = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "h2d_s": phase_times(df)["h2d_s"],
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "hash_pairs_shapes": c["shapes"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": 0, "equal_reference": want is not None}
        print(f"[decimal] {name} " + json.dumps(line), flush=True)
        return got

    for q in ("q1", "q6", "q18"):
        got = run(q, lambda q=q: tpch.build(q, s, dt), refs[q],
                  hashed=q != "q6")
        print(f"[decimal {q} result] {got.num_rows} rows\n"
              f"{got.slice(0, 6).to_pandas().to_string()}", flush=True)
    # the other builders that read a decimal column, and two join
    # variants: one cold and one warm run each, against this script's
    # pyarrow references over the decimal tables (decimal sums exact;
    # the doubles of q8, q9, q14 and q17 within 1e-9 relative)
    t0 = time.perf_counter()
    more_refs = {q: globals()["ref_" + q](dt) for q in DECIMAL_MORE}
    ref_s += time.perf_counter() - t0
    for q in DECIMAL_MORE:
        check(more_refs[q].num_rows > 0, f"decimal reference {q} is empty")
        got = run(q, lambda q=q: tpch.build(q, s, dt), more_refs[q],
                  same_schema=False)
        print(f"[decimal {q} result] {got.num_rows} rows\n"
              f"{got.slice(0, 3).to_pandas().to_string()}", flush=True)
    zones = run("time zones", lambda: zone_query(sz, zt), hashed=False)
    n_checked = check_zones(zones)
    # the decimal columns alone across the bus, as the scans move them
    cols = {"lineitem": li.select(list(tpch.DECIMAL_COLUMNS["lineitem"])),
            "orders": dt["orders"].select(["o_totalprice"])}
    h2d = {}
    for name, tbl in cols.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = host_to_device(tbl, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nbytes = sum(c.data.numel() * c.data.element_size()
                     for c in b.columns)
        h2d[name] = {"columns": tbl.column_names, "rows": tbl.num_rows,
                     "device_bytes": nbytes, "s": wall,
                     "gb_per_s": nbytes / wall / 1e9}
        del b
    print("[decimal] h2d " + json.dumps(h2d), flush=True)
    print("[decimal] " + json.dumps({
        "seconds": time.perf_counter() - t_phase,
        "set_up_s": set_up_s, "reference_s": ref_s,
        "zone_rows_checked": n_checked,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
        "warm_wall_s": {k: v["warm_wall_s"] for k, v in lines.items()},
        "h2d_s": {k: v["h2d_s"] for k, v in lines.items()}}), flush=True)
    return counts


# -- [nested]: structs, arrays, explode, collect, split, get_json_object ------

NESTED_WARM_RUNS = 1
# the operators the JAX package runs on the host for these queries
NESTED_FALLBACKS = {"name words": {"CpuGenerateExec"},
                    "customer json": {"CpuProjectExec"}}
# the runs that group with a hash: the kernel must launch in them
NESTED_HASHED = {"basket parts", "quantity totals", "q1 struct",
                 "name words"}


def _list_parts(col):
    """A list column (any chunking) -> (int64 lengths with a null list
    as -1, its flattened values as a pyarrow array)."""
    import pyarrow.compute as pc
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    lens = pc.list_value_length(arr).fill_null(-1).to_numpy()
    return lens.astype("int64"), pc.list_flatten(arr)


def _group_runs(keys):
    """(the stable order of ``keys``, the distinct keys ascending, each
    one's first position in that order and its count)."""
    import numpy as np
    order = np.argsort(keys, kind="stable")
    uniq, start, count = np.unique(keys[order], return_index=True,
                                   return_counts=True)
    return order, uniq, start, count


def check_baskets(got, li) -> dict:
    """``order baskets`` against numpy: per order present in lineitem,
    its part keys in lineitem order, its distinct supplier keys
    ascending, its line count."""
    import numpy as np
    import pyarrow.compute as pc
    ok = li["l_orderkey"].to_numpy()
    order, uniq, start, count = _group_runs(ok)
    got = got.take(pc.sort_indices(got, [("l_orderkey", "ascending")]))
    check(np.array_equal(got["l_orderkey"].to_numpy(), uniq),
          "order baskets: the orders differ from lineitem's")
    check(np.array_equal(got["n"].to_numpy(), count),
          "order baskets: the line counts differ")
    lens, parts = _list_parts(got["parts"])
    check(np.array_equal(lens, count), "order baskets: list lengths")
    check(np.array_equal(parts.to_numpy(),
                         li["l_partkey"].to_numpy()[order]),
          "order baskets: the parts lists differ from lineitem order")
    # sets: each order's distinct suppliers, ascending
    sk = li["l_suppkey"].to_numpy()
    o2 = np.lexsort((sk, ok))
    ks, vs = ok[o2], sk[o2]
    first = np.ones(len(ks), bool)
    first[1:] = (ks[1:] != ks[:-1]) | (vs[1:] != vs[:-1])
    slens, supps = _list_parts(got["supps"])
    check(np.array_equal(slens, np.bincount(ks[first], minlength=len(
        np.bincount(ok)))[uniq]), "order baskets: set sizes")
    check(np.array_equal(supps.to_numpy(), vs[first]),
          "order baskets: the supplier sets differ")
    return {"orders": int(len(uniq)), "largest_basket": int(count.max()),
            "distinct_suppliers": int(first.sum())}


def ref_basket_parts(li):
    """Per part key: its lines, and the sum of each line's position in
    its order's basket (lineitem order)."""
    import numpy as np
    import pyarrow as pa
    ok, pk = li["l_orderkey"].to_numpy(), li["l_partkey"].to_numpy()
    order, _, start, count = _group_runs(ok)
    pos = np.arange(len(ok)) - np.repeat(start, count)
    pks = pk[order]
    n = np.bincount(pks)
    sp = np.bincount(pks, weights=pos)
    keep = n > 0
    return pa.table({"l_partkey": np.nonzero(keep)[0].astype(np.int64),
                     "n": n[keep].astype(np.int64),
                     "sum_pos": sp[keep].astype(np.int64)})


def ref_quantity_totals(q):
    """explode_outer of each quantity list summed back per order: the
    non-null quantities' sum (null when none) and count, and the rows
    (an empty or null list keeps one)."""
    import numpy as np
    import pyarrow as pa
    lens, vals = _list_parts(q["qty"])
    n_ord = len(lens)
    real = np.maximum(lens, 0)
    owner = np.repeat(np.arange(n_ord), real)
    valid = ~np.asarray(vals.is_null())
    x = np.where(valid, vals.fill_null(0.0).to_numpy(), 0.0)
    total = np.bincount(owner, weights=x, minlength=n_ord)
    n = np.bincount(owner, weights=valid, minlength=n_ord).astype(np.int64)
    return pa.table({"o_orderkey": q["o_orderkey"],
                     "total": pa.array(total, mask=n == 0),
                     "n": n, "rows": np.maximum(real, 1).astype(np.int64)})


def same_sorted(got, want, key, tol=1e-9) -> bool:
    """Equal row for row after sorting both by ``key``: integers exactly,
    doubles within ``tol`` relative (absolute below 1), nulls alike."""
    import numpy as np
    import pyarrow.compute as pc
    if got.num_rows != want.num_rows or got.schema != want.schema:
        return False
    g = got.take(pc.sort_indices(got, [(key, "ascending")]))
    w = want.take(pc.sort_indices(want, [(key, "ascending")]))
    for name in want.column_names:
        a, b = g[name].combine_chunks(), w[name].combine_chunks()
        if not np.array_equal(np.asarray(a.is_null()),
                              np.asarray(b.is_null())):
            return False
        av = a.fill_null(0).to_numpy(zero_copy_only=False)
        bv = b.fill_null(0).to_numpy(zero_copy_only=False)
        if av.dtype.kind == "f":
            if not np.all(np.abs(av - bv) <= tol * np.maximum(
                    1.0, np.maximum(np.abs(av), np.abs(bv)))):
                return False
        elif not np.array_equal(av, bv):
            return False
    return True


def ref_orders_by_info(oi):
    """The first 100 orders of ship priority 1 by (priority, ship
    priority, clerk, key), as the port's struct order gives them."""
    import pyarrow as pa
    import pyarrow.compute as pc
    info = oi["o_info"].combine_chunks()
    t = pa.table({"o_orderkey": oi["o_orderkey"],
                  "p": pc.struct_field(info, "o_orderpriority"),
                  "s": pc.struct_field(info, "o_shippriority"),
                  "c": pc.struct_field(info, "o_clerk"),
                  "info": info})
    t = t.filter(pc.equal(t["s"], 1))
    t = t.sort_by([("p", "ascending"), ("s", "ascending"),
                   ("c", "ascending"), ("o_orderkey", "ascending")])
    t = t.slice(0, 100)
    return pa.table({"o_orderkey": t["o_orderkey"], "o_info": t["info"]})


def ref_name_words(part):
    """Each word of the part names (Python's ``str.split``) and its
    count."""
    import collections
    return collections.Counter(
        w for name in part["p_name"].to_pylist() for w in name.split(" "))


def ref_customer_json(cj):
    """``$.nation``, ``$.acct.bal`` and ``$.missing`` by Python's
    ``json``: a number serialized, a missing path null."""
    import pyarrow as pa
    nation, bal = [], []
    for doc in cj["c_json"].to_pylist():
        d = json.loads(doc)
        nation.append(json.dumps(d["nation"]))
        bal.append(json.dumps(d["acct"]["bal"]))
    return pa.table({"c_custkey": cj["c_custkey"],
                     "nation": pa.array(nation),
                     "bal": pa.array(bal),
                     "missing": pa.array([None] * cj.num_rows,
                                         pa.string())})


def fallback_ops(df) -> set:
    """The class names of the operators the plan rewrite left on the
    CPU."""
    return {r.split(":")[0] for r in
            df.fallback_summary()["fallback_reasons"]}


def nested_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """Structs, arrays, explode, collect, split and get_json_object at SF1
    (``tpch.nested_tables``: a list of each order's quantities, a struct
    on orders, customers' JSON documents), each run a path of its own
    under ``SESSION_CONF`` (only ``NESTED_FALLBACKS``' operators may run
    on the CPU, as in the JAX package), cold then ``NESTED_WARM_RUNS``
    warm run equal to it, against this script's numpy, pyarrow and
    Python references:

    1. ``order baskets``: lineitem by order, ``collect_list`` of its part
       keys (lineitem order), ``collect_set`` of its supplier keys
       (ascending) and ``count``;
    2. ``basket parts``: the baskets ``posexplode``d back to part keys,
       grouped with ``count`` and ``sum(pos)``: the counts equal
       lineitem's per part key;
    3. the quantity lists (1% null elements, 1% null lists, empty lists)
       through ``createDataFrame`` -> ``toArrow`` unchanged, and
       ``quantity totals`` (``explode_outer`` then a grouped sum and
       counts);
    4. ``q1 struct``: q1 keyed by ``struct(l_returnflag,
       l_linestatus)``, row for row q1's reference with the struct
       reassembled; ``orders by info``: a filter on a struct field and
       a top-100 by the struct over orders;
    5. ``name words`` (``split`` + ``explode`` + ``count`` over 200,000
       part names, the Generate on the host) and ``customer json``
       (``get_json_object`` of three paths over 150,000 documents, the
       Project on the host).

    Also the list column's H2D and D2H alone.  Returns the counts of the
    runs."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch
    from spark_rapids_tpu_torch.columnar.column import (
        device_to_host, host_to_device)
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    nt = tpch.nested_tables(tables)
    set_up_s = time.perf_counter() - t0
    li, q = nt["lineitem"], nt["order_quantities"]
    t0 = time.perf_counter()
    refs = {"basket parts": ref_basket_parts(li),
            "quantity totals": ref_quantity_totals(q),
            "orders by info": ref_orders_by_info(nt["orders_info"]),
            "name words": ref_name_words(nt["part"]),
            "customer json": ref_customer_json(nt["customer_json"])}
    q1_ref = ref_q1(li)
    ref_s = time.perf_counter() - t0
    counts, lines, facts = {}, {}, {}

    def session(name):
        allowed = tpch.NESTED_ALLOWED.get(name)
        conf = dict(SESSION_CONF)
        if allowed:
            conf["spark.rapids.sql.test.allowedNonGpu"] = allowed
        return TpuSession(conf, device=dev)

    def run(name, build, verify):
        s = session(name)
        CB.reset_counts()
        KN.COUNTERS.reset()
        clear_scan_cache()
        df = build(s)
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] nested {name} " + json.dumps(c), flush=True)
        fb = fallback_ops(df)
        check(fb == NESTED_FALLBACKS.get(name, set()),
              f"nested {name}: operators on the CPU {sorted(fb)}")
        check(c["collision_fallbacks"] == 0,
              f"nested {name}: hash-collision fallbacks")
        check(name not in NESTED_HASHED or c["hash_pairs_launches"] > 0,
              f"nested {name}: hash_pairs was not launched")
        facts[name] = verify(got)
        warm = []
        for _ in range(NESTED_WARM_RUNS):
            out, wall = timed(build(s))
            warm.append(wall)
            check(out.equals(got), f"nested {name}: a warm run differs")
        lines[name] = line = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "h2d_s": phase_times(df)["h2d_s"],
            "d2h_s": phase_times(df)["d2h_s"],
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "hash_pairs_shapes": c["shapes"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": sorted(fb), "equal_reference": True}
        print(f"[nested] {name} " + json.dumps(line), flush=True)
        return got

    def query(name):
        return lambda s: tpch.NESTED_QUERIES[name](s, nt)

    # 1-2. baskets, and exploded back to parts
    run("order baskets", query("order baskets"),
        lambda got: check_baskets(got, li))

    def parts(got):
        check(same_sorted(got, refs["basket parts"], "l_partkey"),
              "basket parts differ from lineitem's per-part counts")
        return {"part_keys": got.num_rows}

    run("basket parts", query("basket parts"), parts)

    # 3. the quantity lists: the round trip, and explode_outer
    def round_trip(got):
        check(got.equals(q), "the quantity lists' round trip differs")
        lens, vals = _list_parts(q["qty"])
        return {"orders": q.num_rows,
                "null_lists": int((lens < 0).sum()),
                "empty_lists": int((lens == 0).sum()),
                "elements": len(vals), "null_elements": vals.null_count}

    run("quantity lists", lambda s: s.createDataFrame(q), round_trip)

    def totals(got):
        check(same_sorted(got, refs["quantity totals"], "o_orderkey"),
              "quantity totals differ from numpy")
        return {"orders": got.num_rows}

    run("quantity totals", query("quantity totals"), totals)

    # 4. structs
    def q1s(got):
        check(pa.types.is_struct(got.schema.field("flags").type),
              "q1 struct: flags is not a struct")
        flags = got["flags"].combine_chunks()
        flat = pa.table(
            [pc.struct_field(flags, "l_returnflag"),
             pc.struct_field(flags, "l_linestatus")]
            + [got[n] for n in got.column_names[1:]],
            names=q1_ref.column_names)
        check(rows_equal_ordered(flat, q1_ref.sort_by(
            [("l_returnflag", "ascending"), ("l_linestatus",
                                             "ascending")])),
              f"q1 struct differs from q1:\n{flat}\n{q1_ref}")
        return {"groups": got.num_rows}

    run("q1 struct", query("q1 struct"), q1s)

    def by_info(got):
        want = refs["orders by info"]
        check(got.schema == want.schema
              and got.to_pylist() == want.to_pylist(),
              f"orders by info differs from pyarrow:\n{got}\n{want}")
        return {"rows": got.num_rows}

    run("orders by info", query("orders by info"), by_info)

    # 5. the host-only operators
    def words(got):
        want = refs["name words"]
        have = dict(zip(got["word"].to_pylist(), got["count"].to_pylist()))
        check(have == dict(want), "name words differ from str.split")
        return {"words": sum(want.values()), "distinct": len(want)}

    run("name words", query("name words"), words)

    def docs(got):
        want = refs["customer json"]
        check(got.schema == want.schema
              and got.to_pylist() == want.to_pylist(),
              "customer json differs from Python's json")
        return {"documents": got.num_rows}

    run("customer json", query("customer json"), docs)

    # the list column alone across the bus, both ways
    lists = q.select(["qty"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = host_to_device(lists, dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    c = b.columns[0]
    nbytes = sum(x.numel() * x.element_size() for x in
                 (c.data, c.validity, c.lengths, c.evalid)
                 if x is not None)
    t0 = time.perf_counter()
    back = device_to_host(b)
    d2h_s = time.perf_counter() - t0
    check(back.equals(lists), "the list column's D2H differs")
    transfer = {"rows": lists.num_rows, "width": int(c.data.shape[1]),
                "device_bytes": nbytes, "h2d_s": h2d_s, "d2h_s": d2h_s,
                "h2d_gb_per_s": nbytes / h2d_s / 1e9,
                "d2h_gb_per_s": nbytes / d2h_s / 1e9}
    del b, c
    print("[nested] list transfer " + json.dumps(transfer), flush=True)
    print("[nested] " + json.dumps({
        "seconds": time.perf_counter() - t_phase,
        "set_up_s": set_up_s, "reference_s": ref_s, "facts": facts,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
        "warm_wall_s": {k: v["warm_wall_s"] for k, v in lines.items()},
        "d2h_s": {k: v["d2h_s"] for k, v in lines.items()}}), flush=True)
    return counts


def nested_only(dev, tables, CB, KN) -> int:
    """``--nested``: the [nested] phase alone (after the build and the
    kernel checks), then the kernel bit for bit at every shape it
    launched."""
    t0 = time.perf_counter()
    counts = nested_phase(dev, tables, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[nested only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


# -- [window]: window functions at SF1 ---------------------------------------

WINDOW_WARM_RUNS = 1  # 3 before the UDF and file-scan phases came
# the runs whose Window nodes are also timed alone on their cached input
WINDOW_ALONE = ("order gaps", "line running totals",
                "customer trailing spend")
# the runs that join and aggregate before their window: the kernel must
# launch in them
WINDOW_HASHED = {"supplier ranks", "revenue share"}


def _sorted_rows(*keys):
    """Stable row order by ``keys``, the first the most significant."""
    import numpy as np
    return np.lexsort(list(reversed(keys)))


def _run_starts(first):
    """Each row's segment start, from the segment-start mask."""
    import numpy as np
    idx = np.arange(len(first))
    return np.maximum.accumulate(np.where(first, idx, 0))


def _starts_of(*keys):
    """Segment-start mask of rows sorted by ``keys`` (row 0 starts)."""
    import numpy as np
    n = len(keys[0])
    first = np.zeros(n, bool)
    first[:1] = True
    for k in keys:
        first[1:] |= k[1:] != k[:-1]
    return first


def _np(col, fill=0):
    """An Arrow column as numpy, nulls as ``fill``."""
    import pyarrow.compute as pc
    return pc.fill_null(col, fill).to_numpy()


def _nulls(col):
    import numpy as np
    return np.asarray(col.is_null().to_numpy(), dtype=bool)


def _close(a, b, tol=1e-9) -> bool:
    import numpy as np
    return bool(np.allclose(a, b, rtol=tol, atol=0.0))


def ref_supplier_ranks(wt) -> dict:
    """Revenue per supplier by ``bincount`` (supplier keys are
    ``arange``), ranked in each nation by revenue, descending."""
    import numpy as np
    li, su = wt["lineitem"], wt["supplier"]
    n_supp = su.num_rows
    sk = li["l_suppkey"].to_numpy()
    rev = np.bincount(sk, weights=li["l_extendedprice"].to_numpy()
                      * (1 - li["l_discount"].to_numpy()),
                      minlength=n_supp)
    keys = su["s_suppkey"].to_numpy()
    keys = keys[np.bincount(sk, minlength=n_supp)[keys] > 0]
    nat = su["s_nationkey"].to_numpy()[keys]
    order = _sorted_rows(nat, -rev[keys])
    nat, keys, r = nat[order], keys[order], rev[keys][order]
    start = _run_starts(_starts_of(nat))
    peer_first = _starts_of(nat, r)
    rn = np.arange(len(nat)) - start + 1
    rk = _run_starts(peer_first) - start + 1
    # dense rank: the peer groups since the partition's start
    groups = np.cumsum(peer_first)
    drk = groups - groups[start] + 1
    keep = rk <= 3
    return {"s_nationkey": nat[keep], "s_suppkey": keys[keep],
            "revenue": r[keep], "rk": rk[keep], "drk": drk[keep],
            "rn": rn[keep]}


def check_supplier_ranks(got, want) -> dict:
    for k in ("s_nationkey", "s_suppkey", "rk", "drk", "rn"):
        check(np_equal(_np(got[k]), want[k]), f"supplier ranks: {k} differs")
    check(_close(_np(got["revenue"]), want["revenue"]),
          "supplier ranks: revenue differs")
    return {"nations": int(len(set(want["s_nationkey"].tolist()))),
            "rows": int(len(want["rk"]))}


def np_equal(a, b) -> bool:
    import numpy as np
    return a.shape == b.shape and bool(np.array_equal(a, b))


def ref_revenue_share(wt) -> dict:
    """Revenue per (type, brand) by ``bincount`` over dictionary codes
    (part keys are ``arange``), and each type's total."""
    import numpy as np
    li, part = wt["lineitem"], wt["part"]
    pk = li["l_partkey"].to_numpy()
    types = part["p_type"].dictionary_encode().combine_chunks()
    brands = part["p_brand"].dictionary_encode().combine_chunks()
    tc, bc = types.indices.to_numpy(), brands.indices.to_numpy()
    nb = len(brands.dictionary)
    g = tc[pk] * nb + bc[pk]
    rev = np.bincount(g, weights=li["l_extendedprice"].to_numpy()
                      * (1 - li["l_discount"].to_numpy()),
                      minlength=len(types.dictionary) * nb)
    has = np.bincount(g, minlength=len(rev)) > 0
    total = np.bincount(np.arange(len(rev)) // nb, weights=rev)
    tnames = types.dictionary.to_pylist()
    bnames = brands.dictionary.to_pylist()
    return {(tnames[i // nb], bnames[i % nb]):
            (rev[i], total[i // nb], rev[i] * 100 / total[i // nb])
            for i in np.flatnonzero(has)}


def check_revenue_share(got, want) -> dict:
    rows = got.to_pylist()
    check(len(rows) == len(want), f"revenue share: {len(rows)} rows, "
          f"{len(want)} expected")
    for r in rows:
        w = want.get((r["p_type"], r["p_brand"]))
        check(w is not None and math.isclose(r["rev"], w[0], rel_tol=1e-9)
              and math.isclose(r["share"], w[2], rel_tol=1e-9),
              f"revenue share differs at {r}: {w}")
    return {"groups": len(rows)}


def ref_order_gaps(wt) -> dict:
    """Each customer's orders by (date, key): previous date, next price,
    the priority two back, the number, and the previous fulfilled
    price (a running max of fulfilled row indices)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    o = wt["orders"]
    ck, ok = o["o_custkey"].to_numpy(), o["o_orderkey"].to_numpy()
    od = o["o_orderdate"].cast(pa.int32()).to_numpy()
    order = _sorted_rows(ck, od, ok)
    ck, ok, od = ck[order], ok[order], od[order]
    tp = o["o_totalprice"].to_numpy()[order]
    n = len(ck)
    idx = np.arange(n)
    start = _run_starts(_starts_of(ck))
    num = idx - start + 1
    nxt = np.r_[idx[1:], 0]
    has_next = np.r_[ck[1:] == ck[:-1], False]
    filled = np.asarray(pc.equal(o["o_orderstatus"], "F").to_numpy(),
                        dtype=bool)[order]
    last = np.maximum.accumulate(np.where(filled, idx, -1))
    prev = np.r_[-1, last[:-1]]
    prev_ok = prev >= start
    back2 = np.where(num > 2, idx - 2, -1)
    prio = o["o_orderpriority"].take(pa.array(order))
    return {"o_custkey": ck, "o_orderkey": ok, "o_orderdate": od,
            "n": num, "prev_date": od[np.maximum(idx - 1, 0)],
            "prev_date_null": num == 1,
            "next_price": tp[nxt], "next_price_null": ~has_next,
            "prio_2_back": prio.take(pa.array(back2, mask=back2 < 0)),
            "prev_filled": tp[np.maximum(prev, 0)],
            "prev_filled_null": ~prev_ok}


def check_order_gaps(got, want) -> dict:
    import pyarrow as pa
    for k in ("o_custkey", "o_orderkey", "n"):
        check(np_equal(_np(got[k]), want[k]), f"order gaps: {k} differs")
    check(np_equal(_np(got["o_orderdate"].cast(pa.int32())),
                   want["o_orderdate"]), "order gaps: o_orderdate differs")
    for k, cast in (("prev_date", pa.int32()), ("next_price", None),
                    ("prev_filled", None)):
        c = got[k] if cast is None else got[k].cast(cast)
        nul = _nulls(c)
        check(np_equal(nul, want[k + "_null"]),
              f"order gaps: {k}'s nulls differ")
        check(np_equal(_np(c)[~nul], want[k][~nul]),
              f"order gaps: {k} differs")
    check(got["prio_2_back"].cast(pa.string()).combine_chunks().equals(
        want["prio_2_back"].cast(pa.string()).combine_chunks()),
        "order gaps: prio_2_back differs")
    return {"orders": got.num_rows,
            "first_orders": int(want["prev_date_null"].sum()),
            "no_prior_fulfilled": int(want["prev_filled_null"].sum())}


def _by_position(pos, fn, init):
    """A running value within segments, row by row in order: row i at
    position p > 0 takes ``fn(out[i - 1], init[i])``, one position at a
    time (each a vectorized step over the rows at that position)."""
    import numpy as np
    out = init.copy()
    for p in range(1, int(pos.max()) + 1 if len(pos) else 0):
        i = np.flatnonzero(pos == p)
        out[i] = fn(out[i - 1], init[i])
    return out


def ref_line_running_totals(wt) -> dict:
    import numpy as np
    li = wt["lineitem"]
    ok, ln = li["l_orderkey"].to_numpy(), li["l_linenumber"].to_numpy()
    # one stable sort of a combined key (line numbers are below 32)
    check(int(ln.max()) < 32, "an order has 32 lines or more")
    order = np.argsort(ok * 32 + ln, kind="stable")
    ok, ln = ok[order], ln[order]
    start = _run_starts(_starts_of(ok))
    pos = np.arange(len(ok)) - start
    q = li["l_quantity"].to_numpy()[order]
    price = li["l_extendedprice"].to_numpy()[order]
    disc = li["l_discount"].to_numpy()[order]
    return {"l_orderkey": ok, "l_linenumber": ln,
            "run_qty": _by_position(pos, np.add, q),
            "n": pos + 1,
            "run_avg_price": _by_position(pos, np.add, price) / (pos + 1),
            "first_part": li["l_partkey"].to_numpy()[order][start],
            "max_disc": _by_position(pos, np.maximum, disc)}


def check_line_running_totals(got, want) -> dict:
    for k in ("l_orderkey", "l_linenumber", "n", "first_part", "max_disc"):
        check(np_equal(_np(got[k]), want[k]),
              f"line running totals: {k} differs")
    for k in ("run_qty", "run_avg_price"):
        check(_close(_np(got[k]), want[k]),
              f"line running totals: {k} differs")
    return {"lines": got.num_rows, "longest_order": int(want["n"].max())}


def ref_trailing_spend(wt) -> dict:
    """Per customer by date (stable): the 90-day RANGE sum by a search
    over (customer, date) keys and a long-double prefix difference, the
    five-row average and four-row max by shifted reads."""
    import numpy as np
    import pyarrow as pa
    o = wt["orders"]
    ck = o["o_custkey"].to_numpy()
    od = o["o_orderdate"].cast(pa.int32()).to_numpy().astype(np.int64)
    order = _sorted_rows(ck, od)
    ck, od = ck[order], od[order]
    tp = o["o_totalprice"].to_numpy()[order]
    key = ck * (1 << 15) + od
    lo = np.searchsorted(key, key - 90, "left")
    hi = np.searchsorted(key, key, "right")
    cs = np.r_[0, np.cumsum(tp.astype(np.longdouble))]
    spend = (cs[hi] - cs[lo]).astype(np.float64)
    n = len(ck)
    idx = np.arange(n)
    s5 = np.zeros(n)
    c5 = np.zeros(n)
    m4 = tp.copy()
    for off in (-2, -1, 0, 1, 2, -3):
        j = idx + off
        inside = (j >= 0) & (j < n)
        inside[inside] &= ck[j[inside]] == ck[inside]
        if off >= -2:
            s5[inside] += tp[j[inside]]
            c5 += inside
        if off <= 0:
            m4[inside] = np.maximum(m4[inside], tp[j[inside]])
    return {"o_custkey": ck, "o_orderkey": o["o_orderkey"].to_numpy()[order],
            "o_orderdate": od, "spend_90d": spend, "avg_5": s5 / c5,
            "max_4": m4}


def check_trailing_spend(got, want) -> dict:
    import pyarrow as pa
    for k in ("o_custkey", "o_orderkey", "max_4"):
        check(np_equal(_np(got[k]), want[k]),
              f"customer trailing spend: {k} differs")
    check(np_equal(_np(got["o_orderdate"].cast(pa.int32())).astype(
        "int64"), want["o_orderdate"]),
        "customer trailing spend: o_orderdate differs")
    for k in ("spend_90d", "avg_5"):
        check(_close(_np(got[k]), want[k]),
              f"customer trailing spend: {k} differs")
    return {"orders": got.num_rows}


def ref_customer_quartiles(wt) -> dict:
    import numpy as np
    c = wt["customer"]
    seg = c["c_mktsegment"].dictionary_encode().combine_chunks()
    names = np.array(seg.dictionary.to_pylist(), dtype=object)
    rank_of = np.argsort(np.argsort(names))  # codes in string order
    code = rank_of[seg.indices.to_numpy()]
    names = np.sort(names)
    bal = c["c_acctbal"].to_numpy()
    order = _sorted_rows(code, bal)
    code, bal = code[order], bal[order]
    n = len(code)
    idx = np.arange(n)
    first = _starts_of(code)
    start = _run_starts(first)
    ends = np.r_[np.flatnonzero(first)[1:], n]
    plen = (ends[np.cumsum(first) - 1] - start)
    pstart = _run_starts(_starts_of(code, bal))
    pfirst = _starts_of(code, bal)
    pend = np.r_[np.flatnonzero(pfirst)[1:], n][np.cumsum(pfirst) - 1] - 1
    rank = pstart - start + 1
    rn0 = idx - start
    q, r = plen // 4, plen % 4
    cut = r * (q + 1)
    quart = np.where(rn0 < cut, rn0 // np.maximum(q + 1, 1),
                     r + (rn0 - cut) // np.maximum(q, 1)) + 1
    pct = np.where(plen > 1, (rank - 1) / np.maximum(plen - 1, 1), 0.0)
    return {"c_custkey": c["c_custkey"].to_numpy()[order],
            "c_mktsegment": names[code],
            "c_acctbal": bal, "quartile": quart, "pct_rank": pct,
            "cume": (pend - start + 1) / plen}


def check_customer_quartiles(got, want) -> dict:
    import numpy as np
    for k in ("c_custkey", "c_acctbal", "quartile", "pct_rank", "cume"):
        check(np_equal(_np(got[k]), want[k]),
              f"customer quartiles: {k} differs")
    check(np.array_equal(np.array(got["c_mktsegment"].to_pylist(),
                                  dtype=object), want["c_mktsegment"]),
          "customer quartiles: c_mktsegment differs")
    return {"customers": got.num_rows,
            "segments": int(len(set(want["c_mktsegment"].tolist())))}


def ref_top_orders(wt) -> dict:
    import numpy as np
    o = wt["orders"]
    tp = o["o_totalprice"].to_numpy()
    order = np.argsort(-tp, kind="stable")[:100]
    return {"o_orderkey": o["o_orderkey"].to_numpy()[order],
            "o_custkey": o["o_custkey"].to_numpy()[order],
            "o_totalprice": tp[order], "rn": np.arange(1, 101)}


def check_top_orders(got, want) -> dict:
    for k in want:
        check(np_equal(_np(got[k]), want[k]), f"top orders: {k} differs")
    return {"orders": got.num_rows}


WINDOW_RUNS = (
    ("supplier ranks", ref_supplier_ranks, check_supplier_ranks),
    ("revenue share", ref_revenue_share, check_revenue_share),
    ("order gaps", ref_order_gaps, check_order_gaps),
    ("line running totals", ref_line_running_totals,
     check_line_running_totals),
    ("customer trailing spend", ref_trailing_spend, check_trailing_spend),
    ("customer quartiles", ref_customer_quartiles,
     check_customer_quartiles),
    ("top orders", ref_top_orders, check_top_orders))


def window_alone(wins) -> list:
    """Each Window node of a plan alone on its input (its child run
    again, every scan from the cache), by CUDA events, median of 5
    after 2: the whole node (``_window_impl``) and its one sort
    (``window_sort``: the chained stable argsorts over its limbs)."""
    from spark_rapids_tpu_torch.exec import window as W
    from spark_rapids_tpu_torch.exec.basic import concat_device_batches
    out = []
    for w in wins:
        child = w.children[0]
        batch = concat_device_batches(child.schema, [
            b for p in range(child.num_partitions())
            for b in child.execute(p)])
        limbs, _, n_lp = W.window_sort(batch, w.partition_by, w.order_by)
        out.append({
            "node": w.node_string(), "rows": batch.capacity,
            "limbs": len(limbs), "partition_limbs": n_lp,
            "sort_ms": cuda_ms(lambda: W.window_sort(
                batch, w.partition_by, w.order_by), 5),
            "node_ms": cuda_ms(lambda: W._window_impl(
                batch, w.partition_by, w.order_by, w.fns, w.schema), 5)})
        del batch, limbs
    return out


def window_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """Window functions at SF1 (``tpch.window_tables``: lineitem with each
    line's number in its order), every run of ``tpch.WINDOW_QUERIES`` a
    path of its own under ``SESSION_CONF`` (nothing on the CPU), cold
    then ``WINDOW_WARM_RUNS`` warm runs from the scan cache, each equal
    to the cold run, against this script's numpy references (a stable
    ``np.lexsort``, then segment starts, shifted reads, running values
    position by position, ``bincount`` and ``searchsorted``): supplier
    ranks and revenue share (a join and an aggregate before the window:
    the kernel launches), order gaps, line running totals (6,000,000
    lines, one 2^23-row batch), customer trailing spend (a RANGE frame
    on the date and two ROWS frames), customer quartiles and the top
    orders (no partition).  Keys, ranks, counts, dates, strings and
    copied or compared doubles exactly; sums and averages within 1e-9
    relative.  Prints each run's walls, rows, launches, the windows'
    ``opTime`` and reservations and the arbiter's peak, and for
    ``WINDOW_ALONE``'s runs each Window node alone and its sort alone
    by CUDA events (``window_alone``).  Returns the counts of the
    runs."""
    import torch
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import memory as MM
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    wt = tpch.window_tables(tables)
    set_up_s = time.perf_counter() - t0
    counts, lines, facts, ref_s = {}, {}, {}, {}
    for name, ref, verify in WINDOW_RUNS:
        t0 = time.perf_counter()
        want = ref(wt)
        ref_s[name] = time.perf_counter() - t0
        s = TpuSession(dict(SESSION_CONF), device=dev)
        CB.reset_counts()
        KN.COUNTERS.reset()
        clear_scan_cache()
        mgr = MM.get_manager()
        mgr.metrics["peakReserved"] = 0  # this run's peak, from here
        torch.cuda.reset_peak_memory_stats(dev)
        df = tpch.WINDOW_QUERIES[name](s, wt)
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] window {name} " + json.dumps(c), flush=True)
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"window {name}: operators on the CPU {fb}")
        check(c["collision_fallbacks"] == 0,
              f"window {name}: hash-collision fallbacks")
        check(name not in WINDOW_HASHED or c["hash_pairs_launches"] > 0,
              f"window {name}: hash_pairs was not launched")
        wins = find_nodes(df._last_plan, "TpuWindowExec")
        check(wins and all(w.metric("numOutputBatches").value == 1
                           for w in wins),
              f"window {name}: no TpuWindowExec ran")
        facts[name] = verify(got, want)
        peak = mgr.metrics["peakReserved"]
        alloc = torch.cuda.max_memory_allocated(dev)
        warm = []
        for _ in range(WINDOW_WARM_RUNS):
            wdf = tpch.WINDOW_QUERIES[name](s, wt)
            out, wall = timed(wdf)
            warm.append(wall)
            check(out.equals(got), f"window {name}: a warm run differs")
            check(all(t == 0 for t in scan_transfer_times(wdf)),
                  f"window {name}: a warm scan missed the cache")
        lines[name] = line = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "h2d_s": phase_times(df)["h2d_s"],
            "d2h_s": phase_times(df)["d2h_s"],
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "windows": len(wins),
            "window_op_time_s": [w.metric("opTime").value for w in wins],
            "window_reserved_bytes": [w.metric("reservedBytes").value
                                      for w in wins],
            "peak_reserved_bytes": peak, "max_memory_allocated": alloc,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "hash_pairs_shapes": c["shapes"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": fb["fallback_ops"], "equal_reference": True,
            "facts": facts[name], "reference_s": ref_s[name]}
        if name in WINDOW_ALONE:
            line["alone"] = window_alone(wins)
        print(f"[window] {name} " + json.dumps(line), flush=True)
        del got, df, want
    print("[window] " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "set_up_s": set_up_s,
        "reference_s": sum(ref_s.values()),
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
        "warm_wall_s": {k: v["warm_wall_s"] for k, v in lines.items()},
        "window_op_time_s": {k: v["window_op_time_s"]
                             for k, v in lines.items()}}), flush=True)
    return counts


def window_only(dev, tables, CB, KN) -> int:
    """``--window``: the [window] phase alone (after the build and the
    kernel checks), then the kernel bit for bit at every shape it
    launched."""
    t0 = time.perf_counter()
    counts = window_phase(dev, tables, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[window only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


def decimal_only(dev, tables, CB, KN) -> int:
    """``--decimal``: the [decimal] phase alone (after the build and the
    kernel checks), then the kernel bit for bit at every shape it
    launched."""
    t0 = time.perf_counter()
    counts = decimal_phase(dev, tables, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[decimal only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


def faults_only(dev, tables, refs, CB, KN) -> int:
    """``--faults``: q1, q3 and q18 cold (their clean runs), ``[spill]``
    (the disk tier's pool), then ``[faults]`` alone."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import resilience as RES
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t0 = time.perf_counter()
    session = TpuSession(dict(SESSION_CONF), device=dev)
    first = {}
    for q in ("q1", "q3", "q18"):
        clear_scan_cache()
        first[q] = build_on(q, session, tables).toArrow()
        check_result(f"{q} clean", first[q], refs[q])
    clear_scan_cache()
    build_on("q3", session, tables).toArrow()
    n_batches = -(-tables["lineitem"].num_rows
                  // session.rapids_conf().batch_rows)
    spill = spill_phase(session, SESSION_CONF, tables, refs["q3"],
                        first["q3"], n_batches, dev)
    counts = faults_phase(dev, tables, refs, first, spill, CB, KN)
    print("[faults only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "counters": RES.counters_snapshot()}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


UDF_WARM_RUNS = 1
UDF_MOD = 97  # CUST_MOD's divisor, for the reference
UDF_PARTITIONS = 8  # applyInPandas's spark.sql.shuffle.partitions
# the row UDF: a Python % expression (Python's sign rule), alone on its
# source line so that the UDF compiler can read it (no free variable)
CUST_MOD = lambda k: k % 97  # noqa: E731
UDF_COMPILER = {"spark.rapids.sql.udfCompiler.enabled": True}
BRIDGE_NODES = ("TpuArrowEvalPythonExec", "TpuMapInPandasExec",
                "TpuFlatMapGroupsInPandasExec")


def net_price(p, d):
    """l_extendedprice * (1 - l_discount): a pandas UDF over Series and
    a device UDF over tensors alike."""
    return p * (1 - d)


def big_orders(frames):
    """mapInPandas: the orders above 250,000, their price doubled."""
    for df in frames:
        out = df[df["o_totalprice"] > 250_000.0][
            ["o_orderkey", "o_totalprice"]].copy()
        out["o_totalprice"] = out["o_totalprice"] * 2.0
        yield out


def centered_balance(g):
    """applyInPandas: each customer's balance less its nation's mean."""
    out = g[["c_custkey", "c_nationkey"]].copy()
    out["centered"] = g["c_acctbal"] - g["c_acctbal"].mean()
    return out


def median_price(v):
    """A grouped-aggregate pandas UDF: the median of a group."""
    return float(v.median())


def _udf_schema(T, *fields):
    return T.StructType(tuple(T.StructField(n, getattr(T, t))
                              for n, t in fields))


def udf_runs(F, T, col):
    """name -> (build(session, tables), extra conf, bridged): the runs of
    ``[udf]``; ``bridged`` says whether the plan must hold a bridge node
    (a compiled or device UDF must not)."""
    def rev_by_flags(value):
        def build(s, t):
            return (s.createDataFrame(t["lineitem"])
                    .select("l_returnflag", "l_linestatus",
                            value(col("l_extendedprice"),
                                  col("l_discount")).alias("rev"))
                    .groupBy("l_returnflag", "l_linestatus")
                    .agg(F.sum("rev").alias("rev"),
                         F.count("*").alias("n"))
                    .orderBy("l_returnflag", "l_linestatus"))
        return build

    def row_udf(s, t):
        return s.createDataFrame(t["orders"]).select(
            "o_orderkey", F.udf(CUST_MOD, "long")(
                col("o_custkey")).alias("m"))

    return {
        "row udf bridge": (row_udf, {}, True),
        "row udf compiled": (row_udf, UDF_COMPILER, False),
        "pandas udf revenue": (rev_by_flags(
            F.pandas_udf(net_price, "double")), {}, True),
        "builtin revenue": (rev_by_flags(net_price), {}, False),
        "device udf revenue": (rev_by_flags(
            F.device_udf(net_price, "double")), {}, False),
        "map in pandas": (
            lambda s, t: s.createDataFrame(t["orders"]).select(
                "o_orderkey", "o_totalprice").mapInPandas(
                big_orders, _udf_schema(T, ("o_orderkey", "LongT"),
                                        ("o_totalprice", "DoubleT"))),
            {}, True),
        "apply in pandas": (
            lambda s, t: s.createDataFrame(t["customer"]).select(
                "c_custkey", "c_nationkey", "c_acctbal")
            .groupBy("c_nationkey").applyInPandas(
                centered_balance, _udf_schema(
                    T, ("c_custkey", "LongT"), ("c_nationkey", "LongT"),
                    ("centered", "DoubleT"))),
            {"spark.sql.shuffle.partitions": UDF_PARTITIONS}, True),
        "grouped agg median": (
            lambda s, t: s.createDataFrame(t["orders"]).select(
                "o_orderpriority", "o_totalprice")
            .groupBy("o_orderpriority").agg(
                F.pandas_udf(median_price, "double")(
                    col("o_totalprice")).alias("median")), {}, True),
    }


def ref_udf(name, t):
    """This script's numpy reference of a ``[udf]`` run, as an Arrow
    table in the run's row order (sorted where the run has none)."""
    import numpy as np
    import pyarrow as pa
    if name.startswith("row udf"):
        o = t["orders"]
        return pa.table({"o_orderkey": o["o_orderkey"],
                         "m": pa.array(o["o_custkey"].to_numpy() % UDF_MOD)})
    if name.endswith("revenue"):
        li = t["lineitem"]
        keys = np.char.add(li["l_returnflag"].to_numpy(
            zero_copy_only=False).astype("U1"), li["l_linestatus"].to_numpy(
            zero_copy_only=False).astype("U1"))
        uk, inv = np.unique(keys, return_inverse=True)
        rev = (li["l_extendedprice"].to_numpy()
               * (1 - li["l_discount"].to_numpy()))
        return pa.table({
            "l_returnflag": pa.array([k[0] for k in uk]),
            "l_linestatus": pa.array([k[1] for k in uk]),
            "rev": pa.array(np.bincount(inv, weights=rev)),
            "n": pa.array(np.bincount(inv).astype(np.int64))})
    if name == "map in pandas":
        o = t["orders"]
        price = o["o_totalprice"].to_numpy()
        keep = price > 250_000.0
        return pa.table({"o_orderkey": pa.array(
            o["o_orderkey"].to_numpy()[keep]),
            "o_totalprice": pa.array(price[keep] * 2.0)})
    if name == "apply in pandas":
        c = t["customer"]
        nat = c["c_nationkey"].to_numpy()
        bal = c["c_acctbal"].to_numpy()
        mean = np.bincount(nat, weights=bal) / np.bincount(nat)
        return pa.table({"c_custkey": c["c_custkey"],
                         "c_nationkey": c["c_nationkey"],
                         "centered": pa.array(bal - mean[nat])})
    o = t["orders"]
    pri = o["o_orderpriority"].to_numpy(zero_copy_only=False)
    price = o["o_totalprice"].to_numpy()
    names = sorted(set(pri.tolist()))
    return pa.table({"o_orderpriority": pa.array(names),
                     "median": pa.array([float(np.median(price[pri == p]))
                                         for p in names])})


def bridge_metrics(df) -> dict:
    """The bridge nodes' ``transferTime`` and ``udfTime`` of the last run
    (seconds, summed over nodes)."""
    out = {"bridge_nodes": 0, "transferTime": 0.0, "udfTime": 0.0}
    for name, m in df.metrics():
        if name in BRIDGE_NODES:
            out["bridge_nodes"] += 1
            out["transferTime"] += m.get("transferTime", 0.0)
            out["udfTime"] += m.get("udfTime", 0.0)
    return out


def udf_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """Python UDFs at SF1, each run a path of its own under
    ``SESSION_CONF`` (0 operators on the CPU), cold then
    ``UDF_WARM_RUNS`` warm runs from the scan cache, each equal to the
    cold run and to this script's numpy reference (keys and counts
    exactly, doubles within 1e-9 relative): a row ``F.udf`` over
    1,500,000 orders through ``TpuArrowEvalPython``, then with
    ``spark.rapids.sql.udfCompiler.enabled`` compiled (no bridge node,
    the bridge run's rows); a ``pandas_udf`` over 6,000,000 lines summed
    by the two flags, the built-in expression's sums and a device UDF on
    torch tensors (no bridge node) alike; ``mapInPandas`` over orders;
    ``applyInPandas`` over 150,000 customers by nation under
    ``spark.sql.shuffle.partitions=8``; a grouped-aggregate pandas UDF
    (the median order price per priority).  Prints each run's walls,
    rows, launches, which path it took (read from the plan tree) and
    its bridge nodes' ``transferTime`` and ``udfTime``.  Returns the
    counts of the runs."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t_phase = time.perf_counter()
    counts, lines, outs, ref_s, refs = {}, {}, {}, 0.0, {}
    for name, (build, conf, bridged) in udf_runs(F, T, col).items():
        t0 = time.perf_counter()
        # the revenue runs share one reference, the row UDF runs another
        kind = name.split(" ")[-1] if name.endswith("revenue") else name[:7]
        if kind not in refs:
            refs[kind] = ref_udf(name, tables)
        want = refs[kind]
        ref_s += time.perf_counter() - t0
        s = TpuSession(dict(SESSION_CONF, **conf), device=dev)
        CB.reset_counts()
        KN.COUNTERS.reset()
        clear_scan_cache()
        df = build(s, tables)
        got, cold = timed(df)
        counts[name] = c = path_counts(df, CB, KN)
        print(f"[main path] udf {name} " + json.dumps(c), flush=True)
        fb = df.fallback_summary()
        check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
              f"udf {name}: operators on the CPU {fb}")
        check(c["collision_fallbacks"] == 0,
              f"udf {name}: hash-collision fallbacks")
        tree = df._last_plan.tree_string()
        bm = bridge_metrics(df)
        check((bm["bridge_nodes"] > 0) is bridged,
              f"udf {name}: bridge nodes {bm['bridge_nodes']}:\n{tree}")
        check(("ArrowEvalPython" in tree) is (name == "row udf bridge"
                                             or name.startswith("pandas")),
              f"udf {name}: the plan's ArrowEvalPython:\n{tree}")
        ordered = name.endswith("revenue") or name.startswith("row udf")
        if name == "grouped agg median":
            got = got.sort_by("o_orderpriority")
        elif name == "map in pandas":
            got = got.sort_by("o_orderkey")
        elif name == "apply in pandas":
            got = got.sort_by("c_custkey")
        check(got.column_names == want.column_names
              and (rows_equal_ordered(got, want) if ordered
                   else rows_equal(got, want)),
              f"udf {name} differs from the reference:\n{got}\n{want}")
        outs[name] = got
        warm = []
        for _ in range(UDF_WARM_RUNS):
            wdf = build(s, tables)
            out, wall = timed(wdf)
            warm.append(wall)
            if name == "grouped agg median":
                out = out.sort_by("o_orderpriority")
            elif name == "map in pandas":
                out = out.sort_by("o_orderkey")
            elif name == "apply in pandas":
                out = out.sort_by("c_custkey")
            check(out.equals(got), f"udf {name}: a warm run differs")
            check(all(w == 0 for w in scan_transfer_times(wdf)),
                  f"udf {name}: a warm scan missed the cache")
        lines[name] = {
            "rows": got.num_rows, "cold_wall_s": cold,
            "warm_wall_s": statistics.median(warm), "warm_walls_s": warm,
            "h2d_s": phase_times(df)["h2d_s"],
            "d2h_s": phase_times(df)["d2h_s"],
            "path": ("bridge" if bridged else
                     "compiled" if name == "row udf compiled" else
                     "device udf" if name.startswith("device") else
                     "built-in"),
            **bm,
            "hash_pairs_launches": c["hash_pairs_launches"],
            "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                            - query_shapes),
            "fallback_ops": fb["fallback_ops"], "equal_reference": True}
        print(f"[udf] {name} " + json.dumps(lines[name]), flush=True)
        del df
    check(outs["row udf compiled"].equals(outs["row udf bridge"]),
          "udf: the compiled row UDF differs from the bridge run")
    for name in ("pandas udf revenue", "device udf revenue"):
        check(rows_equal_ordered(outs[name], outs["builtin revenue"]),
              f"udf {name} differs from the built-in expression")
    check(counts["pandas udf revenue"]["hash_pairs_launches"] > 0,
          "udf: hash_pairs was not launched by the grouped revenue")
    print("[udf] " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "reference_s": ref_s,
        "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
        "warm_wall_s": {k: v["warm_wall_s"] for k, v in lines.items()},
        "transferTime": {k: v["transferTime"] for k, v in lines.items()},
        "udfTime": {k: v["udfTime"] for k, v in lines.items()},
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    torch.cuda.synchronize()
    return counts


IO_LINEITEM_FILES = 8
IO_ORDERS_FILES = 4
IO_ROW_GROUP = 1 << 17
IO_PRUNE_KEY = 600_000  # l_orderkey < this: the first 40% of the orders


def write_io_files(root, tables) -> dict:
    """lineitem as ``IO_LINEITEM_FILES`` parquet files and orders as
    ``IO_ORDERS_FILES``, row groups of ``IO_ROW_GROUP`` rows; lineitem
    in ``l_orderkey`` order, as TPC-H's dbgen writes it (orders already
    is), so that row groups cover key ranges."""
    import pyarrow.parquet as pq
    out = {}
    for name, t, n_files in (
            ("lineitem", tables["lineitem"].sort_by("l_orderkey"),
             IO_LINEITEM_FILES),
            ("orders", tables["orders"], IO_ORDERS_FILES)):
        d = os.path.join(root, name)
        os.makedirs(d)
        step = -(-t.num_rows // n_files)
        rows = []
        for i in range(n_files):
            part = t.slice(i * step, step)
            pq.write_table(part, os.path.join(d, f"part-{i:05d}.parquet"),
                           row_group_size=IO_ROW_GROUP)
            rows.append(part.num_rows)
        out[name] = d
        out[name + "_rows"] = rows
    return out


def scan_metrics(df) -> dict:
    """The file scans' metrics of the last run, summed over scans."""
    out = {"scans": 0, "scanTime": 0.0, "transferTime": 0.0,
           "dictDecodedColumns": 0, "prunedRowGroups": 0,
           "numOutputBatches": 0, "numOutputRows": 0, "deletedRows": 0,
           "dppPrunedFiles": 0}
    for name, m in df.metrics():
        if name == "TpuParquetScanExec":
            out["scans"] += 1
            for k in list(out)[1:]:
                out[k] += m.get(k, 0)
    return out


def io_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """Parquet scans and writes at SF1 through ``session.read`` and
    ``DataFrame.write``, each run a path of its own under
    ``SESSION_CONF`` (0 operators on the CPU), cold (a file scan has no
    cache).  Set-up, untimed: pyarrow writes lineitem (in key order) as
    8 files and orders as 4 into a temporary directory, removed at the
    end.  q1 and q6 over the lineitem files equal to the in-memory run
    and to pyarrow (q1's ``hash_pairs`` launches counted); an
    ``l_orderkey < 600000`` count and sum, which must prune row groups
    and read only its two columns; ``input_file_name()`` grouped over
    the orders files (4 rows, each file's row count); q12 over both
    file sets with the device dictionary decode on and off (equal, both
    H2D times printed); orders written from the card partitioned by
    ``o_orderpriority`` and read back (5 partitions; count and
    ``sum(o_totalprice)`` per priority equal to the in-memory grouping).
    Prints each run's wall, rows, launches and its scans' ``scanTime``,
    ``transferTime``, ``dictDecodedColumns`` and ``prunedRowGroups``.
    Returns the counts of the runs."""
    import shutil
    import tempfile
    import numpy as np
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.optimizer import optimize
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    li, orders = tables["lineitem"], tables["orders"]
    root = tempfile.mkdtemp(prefix="tpuq-io-")
    try:
        t0 = time.perf_counter()
        files = write_io_files(root, tables)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        keys = li["l_orderkey"].to_numpy()
        pruned_keep = keys < IO_PRUNE_KEY
        refs = {"q1": ref_q1(li), "q6": ref_q6(li), "q12": ref_q12(tables),
                "prune": (int(pruned_keep.sum()), float(
                    li["l_quantity"].to_numpy()[pruned_keep].sum()))}
        ref_s = time.perf_counter() - t0
        s = TpuSession(dict(SESSION_CONF), device=dev)
        nodict = TpuSession(dict(SESSION_CONF, **{
            "spark.rapids.tpu.parquet.deviceDictDecode": False}), device=dev)
        part_dir = os.path.join(root, "orders_by_priority")

        def prune_run(ss):
            return ss.read.parquet(files["lineitem"]).filter(
                col("l_orderkey") < IO_PRUNE_KEY).agg(
                F.count("*").alias("n"), F.sum("l_quantity").alias("qty"))

        runs = {
            "q1": lambda: tpch.q1_over(s.read.parquet(files["lineitem"])),
            "q6": lambda: tpch.q6_over(s.read.parquet(files["lineitem"])),
            "pruned count": lambda: prune_run(s),
            "file names": lambda: s.read.parquet(files["orders"]).select(
                F.input_file_name().alias("f")).groupBy("f").count(),
            "q12 dict decode": lambda: tpch.q12_over(
                s.read.parquet(files["lineitem"]),
                s.read.parquet(files["orders"])),
            "q12 plain decode": lambda: tpch.q12_over(
                nodict.read.parquet(files["lineitem"]),
                nodict.read.parquet(files["orders"])),
            "partitioned write": None,
            "partitioned read": lambda: s.read.parquet(part_dir).groupBy(
                "o_orderpriority").agg(
                F.count("*").alias("n"),
                F.sum("o_totalprice").alias("total")),
        }
        counts, lines, outs = {}, {}, {}
        for name, build in runs.items():
            CB.reset_counts()
            KN.COUNTERS.reset()
            clear_scan_cache()
            if build is None:
                # from the card: the scan and D2H of orders' three
                # columns, then the hive-layout write
                df = s.createDataFrame(orders).select(
                    "o_orderkey", "o_totalprice", "o_orderpriority")
                __import__("torch").cuda.synchronize()
                t0 = time.perf_counter()
                df.write.partitionBy("o_orderpriority").parquet(part_dir)
                wall = time.perf_counter() - t0
                dirs = sorted(os.listdir(part_dir))
                got = None
            else:
                df = build()
                got, wall = timed(df)
            counts[name] = c = path_counts(df, CB, KN)
            print(f"[main path] io {name} " + json.dumps(c), flush=True)
            fb = df.fallback_summary()
            check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
                  f"io {name}: operators on the CPU {fb}")
            check(c["collision_fallbacks"] == 0,
                  f"io {name}: hash-collision fallbacks")
            sm = scan_metrics(df)
            check(build is None or sm["scans"] > 0,
                  f"io {name}: no TpuParquetScanExec ran")
            outs[name] = got
            lines[name] = line = {
                "rows": None if got is None else got.num_rows,
                "cold_wall_s": wall, **sm,
                "d2h_s": phase_times(df)["d2h_s"],
                "hash_pairs_launches": c["hash_pairs_launches"],
                "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                                - query_shapes),
                "fallback_ops": fb["fallback_ops"]}
            if build is None:
                line["partition_dirs"] = dirs
            print(f"[io] {name} " + json.dumps(line), flush=True)
            del df
        # -- the checks ---------------------------------------------------
        memory = {"q1": tpch.q1(s, li).toArrow(),
                  "q6": tpch.q6(s, li).toArrow(),
                  "q12": tpch.q12(s, tables).toArrow()}
        for q in ("q1", "q6"):
            check_result(f"io {q}", outs[q], refs[q])
            check(rows_equal_ordered(outs[q], memory[q]),
                  f"io {q} differs from its in-memory run")
        check(counts["q1"]["hash_pairs_launches"] > 0,
              "io q1: hash_pairs was not launched")
        n = outs["pruned count"]["n"][0].as_py()
        qty = outs["pruned count"]["qty"][0].as_py()
        check(n == refs["prune"][0]
              and abs(qty - refs["prune"][1]) <= 1e-9 * refs["prune"][1],
              f"io pruned count {n} {qty} against {refs['prune']}")
        check(lines["pruned count"]["prunedRowGroups"] > 0,
              "io: the l_orderkey filter pruned no row group")
        rel = [r for r in _logical_nodes(optimize(prune_run(s)._plan))
               if isinstance(r, L.ParquetRelation)]
        check(len(rel) == 1 and rel[0].columns == ["l_orderkey",
                                                   "l_quantity"]
              and rel[0].filters == [("l_orderkey", "lt", IO_PRUNE_KEY)],
              f"io: the pruned scan reads {rel and rel[0].columns}")
        fn = outs["file names"].sort_by("f")
        want_paths = sorted(os.path.join(files["orders"], f)
                            for f in os.listdir(files["orders"]))
        check(fn.column("f").to_pylist() == want_paths
              and fn.column("count").to_pylist() == files["orders_rows"],
              f"io: input_file_name counts {fn.to_pylist()}")
        for name in ("q12 dict decode", "q12 plain decode"):
            check_result(f"io {name}", outs[name], refs["q12"])
            check(rows_equal_ordered(outs[name], memory["q12"]),
                  f"io {name} differs from its in-memory run")
        check(outs["q12 dict decode"].equals(outs["q12 plain decode"]),
              "io: q12 differs between the dictionary and plain decodes")
        check(lines["q12 dict decode"]["dictDecodedColumns"] > 0
              and lines["q12 plain decode"]["dictDecodedColumns"] == 0,
              "io: dictDecodedColumns "
              f"{lines['q12 dict decode']['dictDecodedColumns']} / "
              f"{lines['q12 plain decode']['dictDecodedColumns']}")
        check(lines["partitioned write"]["partition_dirs"] == sorted(
            f"o_orderpriority={p}" for p in set(
                orders["o_orderpriority"].to_pylist())),
              "io: partition directories "
              f"{lines['partitioned write']['partition_dirs']}")
        grouped = s.createDataFrame(orders).groupBy("o_orderpriority").agg(
            F.count("*").alias("n"),
            F.sum("o_totalprice").alias("total")).toArrow()
        back = outs["partitioned read"]
        check(back.num_rows == 5 and rows_equal(back, grouped),
              f"io: the partitioned read back differs:\n{back}\n{grouped}")
        pri = orders["o_orderpriority"].to_numpy(zero_copy_only=False)
        price = orders["o_totalprice"].to_numpy()
        for r in back.to_pylist():
            m = pri == r["o_orderpriority"]
            check(r["n"] == int(m.sum()) and abs(
                r["total"] - float(price[m].sum())) <= 1e-9 * r["total"],
                  f"io: priority {r['o_orderpriority']} against numpy")
        print(f"[io q1 result] {outs['q1'].num_rows} rows\n"
              f"{outs['q1'].to_pandas().to_string()}", flush=True)
        print("[io] " + json.dumps({
            "seconds": time.perf_counter() - t_phase, "write_s": write_s,
            "reference_s": ref_s,
            "cold_wall_s": {k: v["cold_wall_s"] for k, v in lines.items()},
            "scanTime": {k: v["scanTime"] for k, v in lines.items()},
            "transferTime": {k: v["transferTime"]
                             for k, v in lines.items()},
            "dictDecodedColumns": {k: v["dictDecodedColumns"]
                                   for k, v in lines.items()},
            "prunedRowGroups": lines["pruned count"]["prunedRowGroups"],
            "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                    for k, c in counts.items()}}),
            flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# -- [lakehouse]: Delta with deletion vectors, Iceberg with position
# deletes, avro, dynamic partition pruning ------------------------------------

LAKE_DELTA_FILES = 8  # lineitem in key order, row groups of IO_ROW_GROUP
LAKE_DV_FILES = (0, 1)  # on-disk vectors: every l_returnflag 'R' row
LAKE_INLINE_FILE, LAKE_INLINE_ROWS = 2, 64  # an inline vector
# the pruned q1 reads LAKE_PRUNE_LOW <= l_orderkey < IO_PRUNE_KEY: the
# lower bound prunes the first row group of file 0, so that its kept
# rows start past position 0 and the vector must be matched by
# file-absolute positions
LAKE_PRUNE_LOW = 40_000
LAKE_ICEBERG_FILES = 2  # data files per o_orderpriority partition
LAKE_ICEBERG_DELETE_EVERY = 7  # o_orderkey % 7 == 0 deleted ...
LAKE_ICEBERG_DELETE_FILES = 3  # ... in the first three data files
# nation.filter(n_regionkey == 3): the generator draws each nation's
# region, and region 3 holds 5 of the 25 nations (as each TPC-H region
# does; region 2 holds 3), so 20 nations' files are pruned
LAKE_DPP_REGION = 3
DPP_KEY = "spark.sql.optimizer.dynamicPartitionPruning.enabled"
# arrow type -> the Delta and Iceberg schemas' type names
LAKE_TYPES = {"int64": ("long", "long"), "int32": ("integer", "int"),
              "double": ("double", "double"), "string": ("string", "string"),
              "date32[day]": ("date", "date")}
AVRO_TYPES = {"int64": "long", "int32": "int", "double": "double",
              "string": "string"}


def _keep_rows(part, deleted):
    """``part`` without the rows at the ``deleted`` positions."""
    import numpy as np
    import pyarrow as pa
    keep = np.ones(part.num_rows, bool)
    keep[deleted] = False
    return part.filter(pa.array(keep))


def write_delta_lineitem(root, li) -> dict:
    """lineitem in ``l_orderkey`` order as ``LAKE_DELTA_FILES`` parquet
    files, row groups of ``IO_ROW_GROUP`` rows, under a Delta log written
    by hand to the protocol: commit 0 adds the files; commit 1 removes
    files 0-2 and adds them back with deletion vectors (files 0 and 1 an
    on-disk ``u`` vector of every ``l_returnflag = 'R'`` row, file 2 an
    inline ``i`` vector of its first 64 positions); a checkpoint at
    version 1 and ``_last_checkpoint``; commit 2 removes the last file.
    Returns the table's path, its surviving rows (the kept files' rows
    less the deleted positions, by numpy), each file's deleted positions
    and its row groups' ``l_orderkey`` ranges."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io import deletion_vectors as DV
    d = os.path.join(root, "delta_lineitem")
    log = os.path.join(d, "_delta_log")
    os.makedirs(log)
    li = li.sort_by("l_orderkey")
    step = -(-li.num_rows // LAKE_DELTA_FILES)
    parts = [li.slice(i * step, step) for i in range(LAKE_DELTA_FILES)]
    names = [f"part-{i:05d}.parquet" for i in range(LAKE_DELTA_FILES)]
    for part, name in zip(parts, names):
        pq.write_table(part, os.path.join(d, name),
                       row_group_size=IO_ROW_GROUP)
    deleted, dvs = {}, {}
    rng = np.random.default_rng(20261018)
    for i in LAKE_DV_FILES:
        flags = parts[i]["l_returnflag"].to_numpy(zero_copy_only=False)
        deleted[i] = np.flatnonzero(flags == "R")
        # 'u' storage: a raw prefix and the z85 of the vector file's UUID
        pod = "dv" + DV.z85_encode(rng.bytes(16))
        path = DV.dv_file_name(d, pod)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        dvs[i] = dict(DV.write_dv_file(path, deleted[i].tolist()),
                      storageType="u", pathOrInlineDv=pod)
    deleted[LAKE_INLINE_FILE] = np.arange(LAKE_INLINE_ROWS)
    blob = DV.serialize_bitmap_array(range(LAKE_INLINE_ROWS))
    dvs[LAKE_INLINE_FILE] = {
        "storageType": "i",
        "pathOrInlineDv": DV.z85_encode(blob + b"\0" * (-len(blob) % 4)),
        "offset": None, "sizeInBytes": len(blob),
        "cardinality": LAKE_INLINE_ROWS}
    schema = json.dumps({"type": "struct", "fields": [
        {"name": f.name, "type": LAKE_TYPES[str(f.type)][0],
         "nullable": True, "metadata": {}} for f in li.schema]})
    meta = {"id": "lineitem", "format": {"provider": "parquet"},
            "schemaString": schema, "partitionColumns": [],
            "configuration": {}}
    protocol = {"minReaderVersion": 3, "minWriterVersion": 7,
                "readerFeatures": ["deletionVectors"],
                "writerFeatures": ["deletionVectors"]}

    def add(i, with_dv):
        a = {"path": names[i], "partitionValues": {},
             "size": os.path.getsize(os.path.join(d, names[i])),
             "modificationTime": 0, "dataChange": True}
        if with_dv:
            a["deletionVector"] = dvs[i]
        return a

    def commit(version, actions):
        with open(os.path.join(log, f"{version:020d}.json"), "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")

    commit(0, [{"protocol": protocol}, {"metaData": meta}]
           + [{"add": add(i, False)} for i in range(LAKE_DELTA_FILES)])
    commit(1, [{"remove": {"path": names[i], "dataChange": True}}
               for i in dvs] + [{"add": add(i, True)} for i in dvs])
    # the checkpoint of version 1: protocol, metadata, the eight adds
    dv_type = pa.struct([("storageType", pa.string()),
                         ("pathOrInlineDv", pa.string()),
                         ("offset", pa.int32()),
                         ("sizeInBytes", pa.int32()),
                         ("cardinality", pa.int64())])
    adds = [dict(add(i, i in dvs), partitionValues=[])
            for i in range(LAKE_DELTA_FILES)]
    for a in adds:
        a.setdefault("deletionVector", None)
    n_rows = 2 + len(adds)
    cp = pa.table({
        "protocol": pa.array([protocol] + [None] * (n_rows - 1), pa.struct([
            ("minReaderVersion", pa.int32()),
            ("minWriterVersion", pa.int32()),
            ("readerFeatures", pa.list_(pa.string())),
            ("writerFeatures", pa.list_(pa.string()))])),
        "metaData": pa.array(
            [None, dict(meta, configuration=[])] + [None] * len(adds),
            pa.struct([("id", pa.string()),
                       ("format", pa.struct([("provider", pa.string())])),
                       ("schemaString", pa.string()),
                       ("partitionColumns", pa.list_(pa.string())),
                       ("configuration",
                        pa.map_(pa.string(), pa.string()))])),
        "add": pa.array([None, None] + adds, pa.struct([
            ("path", pa.string()),
            ("partitionValues", pa.map_(pa.string(), pa.string())),
            ("size", pa.int64()), ("modificationTime", pa.int64()),
            ("dataChange", pa.bool_()), ("deletionVector", dv_type)])),
    })
    pq.write_table(cp, os.path.join(log, f"{1:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1, "size": n_rows}, f)
    commit(2, [{"remove": {"path": names[-1], "dataChange": True}}])
    kept = range(LAKE_DELTA_FILES - 1)
    survivors = pa.concat_tables([
        _keep_rows(parts[i], deleted[i]) if i in deleted else parts[i]
        for i in kept])
    groups = {}
    for i in kept:
        keys = parts[i]["l_orderkey"].to_numpy()
        groups[i] = [(int(keys[g:g + IO_ROW_GROUP].min()),
                      int(keys[g:g + IO_ROW_GROUP].max()))
                     for g in range(0, len(keys), IO_ROW_GROUP)]
    return {"path": d, "survivors": survivors, "deleted": deleted,
            "groups": groups,
            "deleted_rows": sum(len(v) for v in deleted.values())}


def pruned_deletes(delta) -> int:
    """The deleted positions of ``LAKE_PRUNE_LOW <= l_orderkey <
    IO_PRUNE_KEY``'s read: those in a row group whose key range the
    statistics test keeps (the pruned groups' deletes are never
    counted)."""
    n = 0
    for i, pos in delta["deleted"].items():
        for g, (lo, hi) in enumerate(delta["groups"][i]):
            if hi >= LAKE_PRUNE_LOW and lo < IO_PRUNE_KEY:
                n += int(((pos >= g * IO_ROW_GROUP)
                          & (pos < (g + 1) * IO_ROW_GROUP)).sum())
    return n


def write_iceberg_orders(root, orders) -> dict:
    """orders as a format-version 2 Iceberg table identity-partitioned by
    ``o_orderpriority``, ``LAKE_ICEBERG_FILES`` parquet data files per
    priority, assembled by hand to the spec, its manifests and manifest
    list written by the port's ``io/avro.py::write_container``: one
    manifest of the data files plus an entry of status 2 (deleted) for
    an eleventh file that must not be read, one of a position-delete
    file deleting every order with ``o_orderkey % 7 == 0`` in the first
    three data files.  Returns the table's path, the surviving orders
    (numpy) and the deleted count."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.avro import write_container
    d = os.path.join(root, "iceberg_orders")
    meta_dir = os.path.join(d, "metadata")
    os.makedirs(meta_dir)
    files, kept = [], []
    for pri in sorted(set(orders["o_orderpriority"].to_pylist())):
        sub = orders.filter(pc.equal(orders["o_orderpriority"], pri))
        out = os.path.join(d, "data", f"o_orderpriority={pri}")
        os.makedirs(out)
        step = -(-sub.num_rows // LAKE_ICEBERG_FILES)
        for k in range(LAKE_ICEBERG_FILES):
            part = sub.slice(k * step, step)
            path = os.path.join(out, f"{k:05d}.parquet")
            pq.write_table(part, path, row_group_size=IO_ROW_GROUP)
            files.append((path, pri, part))
    orphan = os.path.join(d, "data", "replaced.parquet")
    pq.write_table(orders.slice(0, 1000), orphan)
    dels = []
    deleted = 0
    for i, (path, pri, part) in enumerate(files):
        if i < LAKE_ICEBERG_DELETE_FILES:
            pos = np.flatnonzero(part["o_orderkey"].to_numpy()
                                 % LAKE_ICEBERG_DELETE_EVERY == 0)
            dels.append(pa.table({
                "file_path": pa.array([path] * len(pos), pa.string()),
                "pos": pa.array(pos, pa.int64())}))
            deleted += len(pos)
            part = _keep_rows(part, pos)
        kept.append(part)
    del_path = os.path.join(d, "data", "deletes-00000.parquet")
    pq.write_table(pa.concat_tables(dels), del_path)
    manifest_schema = {
        "type": "record", "name": "manifest_entry", "fields": [
            {"name": "status", "type": "int"},
            {"name": "data_file", "type": {
                "type": "record", "name": "data_file", "fields": [
                    {"name": "content", "type": "int"},
                    {"name": "file_path", "type": "string"},
                    {"name": "file_format", "type": "string"},
                    {"name": "partition", "type": {
                        "type": "record", "name": "r102", "fields": [
                            {"name": "o_orderpriority",
                             "type": ["null", "string"]}]}},
                    {"name": "record_count", "type": "long"}]}}]}

    def entry(path, pri, n, status=1, content=0):
        return {"status": status, "data_file": {
            "content": content, "file_path": path,
            "file_format": "PARQUET",
            "partition": {"o_orderpriority": pri}, "record_count": n}}

    m_data = os.path.join(meta_dir, "m-data.avro")
    write_container(m_data, manifest_schema, [
        entry(p, pri, part.num_rows) for p, pri, part in files]
        + [entry(orphan, files[0][1], 1000, status=2)], codec="deflate")
    m_del = os.path.join(meta_dir, "m-deletes.avro")
    write_container(m_del, manifest_schema, [
        entry(del_path, None, deleted, content=1)], codec="deflate")
    m_list = os.path.join(meta_dir, "snap-1.avro")
    write_container(m_list, {
        "type": "record", "name": "manifest_file", "fields": [
            {"name": "manifest_path", "type": "string"},
            {"name": "manifest_length", "type": "long"}]},
        [{"manifest_path": m, "manifest_length": os.path.getsize(m)}
         for m in (m_data, m_del)])
    fields = [{"id": k + 1, "name": f.name,
               "type": LAKE_TYPES[str(f.type)][1], "required": False}
              for k, f in enumerate(orders.schema)]
    pri_id = next(f["id"] for f in fields
                  if f["name"] == "o_orderpriority")
    md = {"format-version": 2, "table-uuid": "orders", "location": d,
          "current-schema-id": 0,
          "schemas": [{"type": "struct", "schema-id": 0,
                       "fields": fields}],
          "default-spec-id": 0,
          "partition-specs": [{"spec-id": 0, "fields": [
              {"name": "o_orderpriority", "transform": "identity",
               "source-id": pri_id, "field-id": 1000}]}],
          "current-snapshot-id": 1,
          "snapshots": [{"snapshot-id": 1, "manifest-list": m_list}]}
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as f:
        json.dump(md, f)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as f:
        f.write("1")
    return {"path": d, "survivors": pa.concat_tables(kept),
            "deleted_rows": deleted, "data_files": len(files)}


def write_avro_tables(root, tables) -> dict:
    """customer and nation as deflate avro containers (flat records of
    their columns' types), through the port's ``write_container``."""
    from spark_rapids_tpu_torch.io.avro import write_container
    out = {}
    for name in ("customer", "nation"):
        t = tables[name]
        schema = {"type": "record", "name": name, "fields": [
            {"name": f.name, "type": AVRO_TYPES[str(f.type)]}
            for f in t.schema]}
        path = os.path.join(root, f"{name}.avro")
        write_container(path, schema, t.to_pylist(), codec="deflate")
        out[name] = path
    return out


def ref_dpp(customer, nation):
    """The DPP join by pyarrow: customers of the region's nations,
    counted and their balances summed per nation."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = nation.filter(pc.equal(nation["n_regionkey"], LAKE_DPP_REGION))
    j = customer.select(["c_nationkey", "c_acctbal"]).join(
        n.select(["n_nationkey", "n_name"]), "c_nationkey", "n_nationkey",
        join_type="inner")
    g = j.group_by("n_name").aggregate([("c_acctbal", "count"),
                                        ("c_acctbal", "sum")])
    return pa.table([g["n_name"], g["c_acctbal_count"], g["c_acctbal_sum"]],
                    names=["n_name", "n", "balance"])


def lakehouse_phase(dev, tables, CB, KN, query_shapes) -> dict:
    """The table formats at SF1, each run a path of its own under
    ``SESSION_CONF`` (0 operators on the CPU: the DPP subquery drains on
    the host outside the plan rewrite, as in the JAX package), cold.
    Set-up, untimed, in one ``tpuq-lake-*`` temporary directory removed
    at the end:

    1. Delta: lineitem (``write_delta_lineitem``) read by
       ``session.read.delta``: q1, q6 and ``count(*)`` against pyarrow
       over the surviving rows, and q1 over ``LAKE_PRUNE_LOW <=
       l_orderkey < IO_PRUNE_KEY`` (row groups pruned, the vector matched
       by file-absolute positions): ``deletedRows`` as numpy counts;
    2. Iceberg: orders (``write_iceberg_orders``) by
       ``session.read.iceberg``: TPC-H q4 with lineitem in memory against
       pyarrow's q4 over the surviving orders, and ``count(*)``;
    3. avro: customer and nation (``write_avro_tables``) by
       ``session.read.avro`` (its decode timed apart), q10 with orders and
       lineitem in memory against ``ref_q10`` and the in-memory q10;
    4. DPP: customer written from the card partitioned by
       ``c_nationkey`` (25 directories) and joined to the nations of
       region ``LAKE_DPP_REGION``, grouped by ``n_name``: the scan prunes
       the other 20 nations' files (``dppPrunedFiles``), equal to
       pyarrow and to the run with DPP off (0 pruned); the left-outer
       form keeps all 150,000 customers and prunes none.

    Prints each run's wall, rows, launches, join strategies and its
    scans' ``scanTime``, ``transferTime``, ``deletedRows``,
    ``dppPrunedFiles`` and ``prunedRowGroups``.  Returns the counts of
    the runs."""
    import shutil
    import tempfile
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    li, orders = tables["lineitem"], tables["orders"]
    customer, nation = tables["customer"], tables["nation"]
    root = tempfile.mkdtemp(prefix="tpuq-lake-")
    try:
        write_s = {}
        t0 = time.perf_counter()
        delta = write_delta_lineitem(root, li)
        write_s["delta"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ice = write_iceberg_orders(root, orders)
        write_s["iceberg"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        avro = write_avro_tables(root, tables)
        write_s["avro"] = time.perf_counter() - t0
        s = TpuSession(dict(SESSION_CONF), device=dev)
        off = TpuSession(dict(SESSION_CONF, **{DPP_KEY: False}), device=dev)
        cust_dir = os.path.join(root, "customer_by_nation")
        region = nation.filter(pc.equal(nation["n_regionkey"],
                                        LAKE_DPP_REGION))
        t0 = time.perf_counter()
        surv = delta["survivors"]
        in_range = pc.and_(
            pc.greater_equal(surv["l_orderkey"], LAKE_PRUNE_LOW),
            pc.less(surv["l_orderkey"], IO_PRUNE_KEY))
        refs = {"delta q1": ref_q1(surv), "delta q6": ref_q6(surv),
                "delta q1 pruned": ref_q1(surv.filter(in_range)),
                "iceberg q4": ref_q4({"orders": ice["survivors"],
                                      "lineitem": li}),
                "avro q10": ref_q10(tables),
                "dpp": ref_dpp(customer, nation)}
        ref_s = time.perf_counter() - t0
        avro_read = {}

        def delta_df(ss):
            return ss.read.delta(delta["path"])

        def avro_q10():
            t0 = time.perf_counter()
            c, n = s.read.avro(avro["customer"]), s.read.avro(avro["nation"])
            avro_read["s"] = time.perf_counter() - t0
            return tpch.q10_over(c, s.createDataFrame(orders),
                                 s.createDataFrame(li), n)

        def dpp_join(ss, how="inner"):
            return ss.read.parquet(cust_dir).join(
                ss.createDataFrame(nation).filter(
                    col("n_regionkey") == LAKE_DPP_REGION),
                col("c_nationkey") == col("n_nationkey"), how)

        def dpp_grouped(ss):
            return dpp_join(ss).groupBy("n_name").agg(
                F.count("*").alias("n"), F.sum("c_acctbal").alias("balance"))

        # name: (build, joins or groups, the join strategies wanted)
        runs = {
            "delta q1": (lambda: tpch.q1_over(delta_df(s)), True, ()),
            "delta q6": (lambda: tpch.q6_over(delta_df(s)), False, ()),
            "delta count": (lambda: delta_df(s).agg(
                F.count("*").alias("n")), False, ()),
            "delta q1 pruned": (lambda: tpch.q1_over(delta_df(s).filter(
                (col("l_orderkey") >= LAKE_PRUNE_LOW)
                & (col("l_orderkey") < IO_PRUNE_KEY))), True, ()),
            "iceberg q4": (lambda: tpch.q4_over(
                s.read.iceberg(ice["path"]), s.createDataFrame(li)),
                True, None),
            "iceberg count": (lambda: s.read.iceberg(ice["path"]).agg(
                F.count("*").alias("n")), False, ()),
            "avro q10": (avro_q10, True, None),
            "memory q10": (lambda: tpch.q10(s, tables), True, None),
            "customer write": (None, False, ()),
            "dpp": (lambda: dpp_grouped(s), True, ("bc right",)),
            "dpp off": (lambda: dpp_grouped(off), True, ("bc right",)),
            "dpp left": (lambda: dpp_join(s, "left").agg(
                F.count("*").alias("n"),
                F.count(col("n_nationkey")).alias("matched")), True,
                ("left bc right",)),
        }
        counts, lines, outs = {}, {}, {}
        for name, (build, hashed, strategies) in runs.items():
            CB.reset_counts()
            KN.COUNTERS.reset()
            clear_scan_cache()
            if build is None:
                # from the card: the scan and D2H of customer, then the
                # hive-layout write
                df = s.createDataFrame(customer)
                __import__("torch").cuda.synchronize()
                t0 = time.perf_counter()
                df.write.partitionBy("c_nationkey").parquet(cust_dir)
                got, wall = None, time.perf_counter() - t0
            else:
                df = build()
                got, wall = timed(df)
            counts[name] = c = path_counts(df, CB, KN)
            print(f"[main path] lakehouse {name} " + json.dumps(c),
                  flush=True)
            fb = df.fallback_summary()
            check(fb["fallback_ops"] == 0 and fb["device_ops"] > 0,
                  f"lakehouse {name}: operators on the CPU {fb}")
            check(c["collision_fallbacks"] == 0,
                  f"lakehouse {name}: hash-collision fallbacks")
            check(not hashed or c["hash_pairs_launches"] > 0,
                  f"lakehouse {name}: hash_pairs was not launched")
            joins = c["joins"]
            if name in ("iceberg q4", "avro q10", "memory q10"):
                check_strategies(name.split()[1], joins)
            elif strategies is not None:
                check(len(joins) == len(strategies) and all(
                    _strategy_holds(w, j) for w, j in zip(strategies, joins)),
                    f"lakehouse {name}: joins {joins}, want {strategies}")
            outs[name] = got
            sm = scan_metrics(df)
            lines[name] = line = {
                "rows": None if got is None else got.num_rows,
                "cold_wall_s": wall, **sm,
                "h2d_s": phase_times(df)["h2d_s"],
                "hash_pairs_launches": c["hash_pairs_launches"],
                "new_hash_pairs_shapes": sorted(set(c["shapes"])
                                                - query_shapes),
                "joins": [_strategy_key([j])[0] for j in joins],
                "fallback_ops": fb["fallback_ops"]}
            if name == "avro q10":
                line["avro_read_s"] = avro_read["s"]
            print(f"[lakehouse] {name} " + json.dumps(line), flush=True)
            del df
        # -- Delta ---------------------------------------------------------
        for name in ("delta q1", "delta q6", "delta q1 pruned"):
            check_result(f"lakehouse {name}", outs[name], refs[name])
        check(outs["delta count"]["n"][0].as_py() == surv.num_rows,
              f"lakehouse delta count {outs['delta count']['n'][0]} "
              f"against {surv.num_rows}")
        for name in ("delta q1", "delta q6", "delta count"):
            check(lines[name]["deletedRows"] == delta["deleted_rows"]
                  and lines[name]["numOutputRows"] == surv.num_rows
                  and lines[name]["scans"] == 1,
                  f"lakehouse {name}: deletedRows "
                  f"{lines[name]['deletedRows']} (want "
                  f"{delta['deleted_rows']}), rows read "
                  f"{lines[name]['numOutputRows']} (want {surv.num_rows})")
        pruned = lines["delta q1 pruned"]
        check(pruned["prunedRowGroups"] > 0
              and pruned["deletedRows"] == pruned_deletes(delta),
              f"lakehouse delta q1 pruned: prunedRowGroups "
              f"{pruned['prunedRowGroups']}, deletedRows "
              f"{pruned['deletedRows']} (want {pruned_deletes(delta)})")
        # -- Iceberg -------------------------------------------------------
        check_result("lakehouse iceberg q4", outs["iceberg q4"],
                     refs["iceberg q4"])
        n_ice = ice["survivors"].num_rows
        check(outs["iceberg count"]["n"][0].as_py() == n_ice
              and lines["iceberg count"]["numOutputRows"] == n_ice,
              f"lakehouse iceberg count {outs['iceberg count']['n'][0]} "
              f"against {n_ice}")
        for name in ("iceberg q4", "iceberg count"):
            check(lines[name]["prunedRowGroups"] > 0
                  or lines[name]["deletedRows"] == ice["deleted_rows"],
                  f"lakehouse {name}: deletedRows "
                  f"{lines[name]['deletedRows']}, want "
                  f"{ice['deleted_rows']}")
        # -- avro ------------------------------------------------------------
        check_result("lakehouse avro q10", outs["avro q10"],
                     refs["avro q10"])
        check(outs["avro q10"].equals(outs["memory q10"]),
              "lakehouse: avro q10 differs from the in-memory q10")
        check(_strategy_key(counts["avro q10"]["joins"])
              == _strategy_key(counts["memory q10"]["joins"]),
              "lakehouse: avro q10's joins differ from the in-memory q10's")
        # -- DPP -------------------------------------------------------------
        dirs = sorted(os.listdir(cust_dir))
        check(len(dirs) == 25, f"lakehouse: {len(dirs)} partitions")
        keep = {f"c_nationkey={k}" for k in region["n_nationkey"].to_pylist()}
        other_files = sum(len(os.listdir(os.path.join(cust_dir, x)))
                          for x in dirs if x not in keep)
        check(lines["dpp"]["dppPrunedFiles"] == other_files == 20
              and region.num_rows == 5,
              f"lakehouse dpp: dppPrunedFiles "
              f"{lines['dpp']['dppPrunedFiles']}, want {other_files}")
        check(lines["dpp off"]["dppPrunedFiles"] == 0
              and lines["dpp left"]["dppPrunedFiles"] == 0,
              "lakehouse: dpp off / left pruned "
              f"{lines['dpp off']['dppPrunedFiles']} / "
              f"{lines['dpp left']['dppPrunedFiles']}")
        check(rows_equal(outs["dpp"], refs["dpp"])
              and outs["dpp"].num_rows == region.num_rows,
              f"lakehouse dpp differs from pyarrow:\n{outs['dpp']}\n"
              f"{refs['dpp']}")
        check(rows_equal(outs["dpp"], outs["dpp off"]),
              "lakehouse: dpp differs from its DPP-off run")
        left = outs["dpp left"]
        n_region = int(pc.sum(pc.is_in(
            customer["c_nationkey"], value_set=region["n_nationkey"])).as_py())
        check(left["n"][0].as_py() == customer.num_rows
              and left["matched"][0].as_py() == n_region,
              f"lakehouse dpp left: {left.to_pylist()}, want "
              f"{customer.num_rows} rows, {n_region} matched")
        print(f"[lakehouse q4 result] {outs['iceberg q4'].num_rows} rows\n"
              f"{outs['iceberg q4'].to_pandas().to_string()}", flush=True)
        summary = {
            "seconds": time.perf_counter() - t_phase,
            "write_s": write_s, "reference_s": ref_s,
            "avro_read_s": avro_read["s"],
            "delta": {"files": LAKE_DELTA_FILES - 1,
                      "deleted_rows": delta["deleted_rows"],
                      "surviving_rows": surv.num_rows},
            "iceberg": {"data_files": ice["data_files"],
                        "deleted_rows": ice["deleted_rows"],
                        "surviving_rows": n_ice},
            "dpp_pruned_files": lines["dpp"]["dppPrunedFiles"],
            "dpp_partitions": len(dirs),
            "exactly_equal_dpp_off": outs["dpp"].equals(outs["dpp off"])}
        for k in ("cold_wall_s", "scanTime", "transferTime", "deletedRows",
                  "dppPrunedFiles", "prunedRowGroups", "numOutputRows"):
            summary[k] = {name: v[k] for name, v in lines.items()}
        summary["hash_pairs_launches"] = {k: c["hash_pairs_launches"]
                                          for k, c in counts.items()}
        print("[lakehouse] " + json.dumps(summary), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# -- the observability plane ---------------------------------------------------

OBSERVE_QUERIES = ("q1", "q3", "q5", "q18")
OBSERVE_DEADLINE_MS = 1000  # q18's warm wall is 3.3-3.8 s (PERF.md)
OVERHEAD_QUERIES = ("q1", "q3")
OVERHEAD_TURNS = 3
ATTRIBUTION_OFF = {"spark.rapids.tpu.attribution.enabled": False}
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$')


def attribution_cost(dev, tables, refs, main_warm) -> dict:
    """The default's cost: the 22 queries once warm with attribution off
    (every scan from the cache), their sum beside ``main_warm`` (the
    main phase's warm walls, attribution on), and q1 and q3 on and off
    in turns, the minimum of each against the JAX package's bound."""
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t0 = time.perf_counter()
    on = TpuSession(dict(SESSION_CONF), device=dev)
    off = TpuSession(dict(SESSION_CONF, **ATTRIBUTION_OFF), device=dev)
    off_walls = {}
    for q in QUERIES:
        df = build_on(q, off, tables)
        got, off_walls[q] = timed(df)
        check(rows_equal(got, refs[q]), f"{q} differs with attribution off")
        check(all(t == 0 for t in scan_transfer_times(df)),
              f"{q}: a scan missed the cache with attribution off")
        check("attribution" not in df._last_query_entry,
              f"{q}: an attribution ledger with attribution off")
    turns = {}
    for q in OVERHEAD_QUERIES:
        ons, offs = [], []
        for _ in range(OVERHEAD_TURNS):
            ons.append(timed(build_on(q, on, tables))[1])
            offs.append(timed(build_on(q, off, tables))[1])
        bound = min(offs) * 1.05 + 0.025
        turns[q] = {"on_s": ons, "off_s": offs, "on_min_s": min(ons),
                    "off_min_s": min(offs),
                    "ratio": min(ons) / min(offs),
                    "bound_s": bound, "within_bound": min(ons) <= bound}
    out = {"off_warm_sum_s": sum(off_walls.values()),
           "on_warm_sum_s": sum(main_warm.values()),
           "off_warm_s": off_walls, "on_warm_s": main_warm,
           "interleaved": turns, "seconds": time.perf_counter() - t0,
           "card": nvidia_smi_line()}
    print("[attribution cost] " + json.dumps(out), flush=True)
    return out


def _pumping_nodes(node) -> list:
    """Nodes whose ``execute`` runs: fused operators are pulled through
    by their consumer and never pump."""
    out = []
    fused = node.metrics.get("fusedIntoConsumer")
    if fused is None or not fused.value:
        out.append(node.name)
    for c in node.children:
        out.extend(_pumping_nodes(c))
    return out


def observe_run(tag, q, s, tables, ref, CB, KN, paths) -> tuple:
    """One run under the plane, its kernel counts set to 0 just before
    and read just after; the checks of ``[observe]``."""
    from spark_rapids_tpu_torch.runtime import stats
    CB.reset_counts()
    KN.COUNTERS.reset()
    df = build_on(q, s, tables)
    got, wall = timed(df)
    counts = path_counts(df, CB, KN)
    counts["cuda_dispatch_delta"] = df._last_query_entry["telemetry"].get(
        'tpuq_kernel_dispatch_total{backend="cuda"}', 0)
    check(rows_equal(got, ref), f"observe {tag} differs from its reference")
    entry = df._last_query_entry
    qid = entry["query_id"]
    att = entry["attribution"]
    check(att["closed"]
          and att["unaccounted_s"] <= att["tolerance"] * att["e2e_s"],
          f"observe {tag}: the ledger does not close: {att}")
    charged = sum(v for b, v in att["buckets"].items() if b != "unaccounted")
    check(charged <= att["e2e_s"] + 1e-6,
          f"observe {tag}: buckets {charged} s over e2e {att['e2e_s']} s")
    prof = s.last_query_profile()
    check(prof["query_id"] == qid and prof["ops"][0]["rows_out"]
          == got.num_rows, f"observe {tag}: stats root rows "
          f"{prof['ops'][0]['rows_out']} for {got.num_rows}")
    with open(entry["trace_file"]) as f:
        doc = json.load(f)
    check(doc["otherData"]["query_id"] == qid
          and os.path.basename(entry["trace_file"])
          == f"query-{qid:06d}.trace.json",
          f"observe {tag}: the trace file names another query")
    pumped = {e["name"][:-len(":pump")] for e in doc["traceEvents"]
              if e["ph"] == "X" and e["name"].endswith(":pump")}
    missing = sorted(set(_pumping_nodes(df._last_plan)) - pumped)
    check(not missing, f"observe {tag}: no pump span for {missing}")
    paths["runs"] += 1
    with open(paths["qlog"]) as f:
        logged = [json.loads(ln) for ln in f.read().splitlines()]
    check(len(logged) == paths["runs"] and logged[-1]["query_id"] == qid,
          f"observe {tag}: {len(logged)} query log lines for "
          f"{paths['runs']} runs")
    check(stats.load_profiles(paths["store"])[-1]["query_id"] == qid,
          f"observe {tag}: the profile store's last record is not {qid}")
    line = {"wall_s": wall, "query_id": qid, "e2e_s": att["e2e_s"],
            "buckets": {b: v for b, v in att["buckets"].items() if v},
            "unaccounted_s": att["unaccounted_s"],
            "verdict": att["verdict"],
            "hash_pairs_launches": counts["hash_pairs_launches"],
            "cuda_dispatches": counts["cuda_rung_dispatches"],
            "rows_per_node": [(r["op"], r["rows_out"])
                              for r in prof["ops"]],
            "spans": len([e for e in doc["traceEvents"] if e["ph"] == "X"]),
            # where the kernel_dispatch bucket goes, by operator and stage
            "top_self_s": [
                (op, r["self_s"], {k: v for k, v in r["stages"].items()
                                   if v >= 0.01 * att["e2e_s"]})
                for op, r in sorted(entry["op_rollup"].items(),
                                    key=lambda kv: -kv[1]["self_s"])[:4]]}
    print(f"[observe] {tag} " + json.dumps(line), flush=True)
    return df, counts, line


def observe_phase(dev, tables, refs, CB, KN, query_shapes) -> dict:
    """``[observe]``: the plane at SF1 (see the module's docstring)."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import attribution, telemetry
    from spark_rapids_tpu_torch.runtime.cancel import QueryCancelled
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tpuq-observe-")
    counts, lines = {}, {}
    try:
        paths = {"qlog": f"{root}/qlog.jsonl",
                 "store": f"{root}/profiles.jsonl", "runs": 0}
        sink = f"{root}/telemetry/metrics.jsonl"
        prom = f"{root}/telemetry/metrics.prom"
        conf = dict(SESSION_CONF, **{
            "spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.path": f"{root}/trace",
            "spark.rapids.tpu.stats.enabled": True,
            "spark.rapids.tpu.stats.level": "FULL",
            "spark.rapids.sql.queryLog.path": paths["qlog"],
            "spark.rapids.tpu.stats.storePath": paths["store"],
            BLACKBOX_KEY: f"{root}/blackbox",
            "spark.rapids.tpu.telemetry.enabled": True,
            "spark.rapids.tpu.telemetry.samplePeriodMs": 100,
            "spark.rapids.tpu.telemetry.sinkPath": sink,
            "spark.rapids.tpu.telemetry.promPath": prom})
        s = TpuSession(conf, device=dev)
        for q in OBSERVE_QUERIES:
            clear_scan_cache()
            df, counts[q], lines[f"{q} cold"] = observe_run(
                f"{q} cold", q, s, tables, refs[q], CB, KN, paths)
            check(counts[q]["collision_fallbacks"] == 0,
                  f"observe {q}: hash-collision fallbacks")
            check(counts[q]["hash_pairs_launches"] > 0,
                  f"observe {q}: hash_pairs was not launched")
            df, _, lines[f"{q} warm"] = observe_run(
                f"{q} warm", q, s, tables, refs[q], CB, KN, paths)
            if q == "q3":
                buf = io.StringIO()
                with redirect_stdout(buf):
                    df.explain("analyze")
                print("[observe] q3 explain(\"analyze\")\n"
                      + buf.getvalue(), end="", flush=True)
        q1 = counts["q1"]
        check(q1["cuda_dispatch_delta"] > 0 and q1["cuda_dispatch_delta"]
              == q1["cuda_rung_dispatches"],
              f"observe q1: dispatch counter delta "
              f"{q1['cuda_dispatch_delta']} against the kernel plane's "
              f"{q1['cuda_rung_dispatches']}")

        # -- q1 under torch.profiler: the capture names the kernel
        prof_s = TpuSession(dict(SESSION_CONF, **{
            "spark.rapids.profile.enabled": True,
            "spark.rapids.profile.path": f"{root}/profile"}), device=dev)
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = build_on("q1", prof_s, tables)
        got, prof_wall = timed(df)
        counts["q1 profiled"] = path_counts(df, CB, KN)
        check(rows_equal(got, refs["q1"]), "observe: profiled q1 differs")
        entry = df._last_query_entry
        pdir = entry["profile_dir"]
        check(os.path.basename(pdir) == f"query-{entry['query_id']:06d}",
              f"observe: profile directory {pdir}")
        with open(os.path.join(pdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        hp = [e for e in kernel_events if "hash_pairs" in e.get("name", "")]
        check(hp, "observe: the profile names no hash_pairs kernel among "
              f"its {len(kernel_events)} device kernel events")
        lines["q1 profiled"] = {
            "wall_s": prof_wall, "trace_events": len(events),
            "device_kernel_events": len(kernel_events),
            "hash_pairs_events": len(hp),
            "hash_pairs_launches": CB.launches,
            "hash_pairs_device_us": sum(e.get("dur", 0) for e in hp),
            "kernel_name": hp[0]["name"] if hp else None}
        print("[observe] q1 profiled " + json.dumps(lines["q1 profiled"]),
              flush=True)

        # -- q18 cut by a deadline: the black box and `profile why`
        box_s = TpuSession(dict(SESSION_CONF, **{
            BLACKBOX_KEY: f"{root}/blackbox"}), device=dev)
        df = build_on("q18", box_s, tables)
        t1 = time.perf_counter()
        try:
            df.toArrow(timeout_ms=OBSERVE_DEADLINE_MS)
            raise RuntimeError("chip_smoke: q18 ran to its end under a "
                               f"{OBSERVE_DEADLINE_MS} ms deadline")
        except QueryCancelled as e:
            check(e.reason == "deadline", f"observe: q18 cancelled by "
                  f"{e.reason!r}, not its deadline")
        cut_s = time.perf_counter() - t1
        entry = df._last_query_entry
        box_path = entry.get("blackbox")
        check(box_path is not None and os.path.exists(box_path),
              f"observe: q18 left no black box: {entry.get('status')}")
        with open(box_path) as f:
            box = json.load(f)
        check(box["trigger"] == "timeout"
              and box["attribution"]["dominant"] in attribution.BUCKETS,
              f"observe: the black box {box.get('trigger')} names "
              f"{box.get('attribution', {}).get('dominant')}")
        why = subprocess.run(
            [sys.executable, "-m", "spark_rapids_tpu_torch.utils.profile",
             "why", box_path], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(why.returncode == 0 and box["verdict"] in why.stdout,
              f"observe: profile why exited {why.returncode}: "
              f"{why.stdout}{why.stderr}")
        lines["q18 deadline"] = {
            "deadline_ms": OBSERVE_DEADLINE_MS, "raised_after_s": cut_s,
            "cancel_latency_s": entry["cancel"].get("latency_s"),
            "verdict": box["verdict"], "trigger": box["trigger"],
            "ring_spans": len(box["flight_recorder"]["recent_spans"]),
            "ring_events": [ev["kind"] for ev
                            in box["flight_recorder"]["events"]]}
        print("[observe] q18 deadline " + json.dumps(lines["q18 deadline"])
              + "\n[observe] profile why:\n" + why.stdout, end="",
              flush=True)

        # -- the registry, the prom dump, the sampler's JSONL
        report = s.metrics_report()
        check(report["metrics"]["tpuq_queries_total"] >= paths["runs"],
              "observe: metrics_report counts fewer queries than ran")
        telemetry.stop_sampler()
        with open(prom) as f:
            prom_lines = f.read().splitlines()
        bad = [ln for ln in prom_lines if not ln.startswith("#")
               and not PROM_SAMPLE.match(ln)]
        check(prom_lines and not bad, f"observe: prom lines {bad[:3]}")
        with open(sink) as f:
            samples = [json.loads(ln) for ln in f.read().splitlines()]
        check(len(samples) >= 1, "observe: the sampler wrote no line")
        lines["telemetry"] = {
            "metrics": len(report["metrics"]),
            "prom_lines": len(prom_lines), "jsonl_samples": len(samples),
            "q1_cuda_dispatch_delta": q1["cuda_dispatch_delta"],
            "q1_kernel_plane_dispatches": q1["cuda_rung_dispatches"],
            "health": report["health"][-3:]}
        print("[observe] telemetry " + json.dumps(lines["telemetry"]),
              flush=True)
    finally:
        telemetry.stop_sampler()
        shutil.rmtree(root, ignore_errors=True)
    summary = {"seconds": time.perf_counter() - t0,
               "card": nvidia_smi_line(),
               "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                       for k, c in counts.items()},
               "new_hash_pairs_shapes": sorted(
                   {k for c in counts.values() for k in c["shapes"]}
                   - query_shapes)}
    print("[observe] " + json.dumps(summary), flush=True)
    return counts


def observe_only(dev, tables, refs, CB, KN) -> int:
    """``--observe``: the 22 queries once to fill the scan cache, once
    more warm (the default, attribution on), ``[attribution cost]`` and
    ``[observe]``, then the kernel bit for bit at every shape it
    launched."""
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t0 = time.perf_counter()
    session = TpuSession(dict(SESSION_CONF), device=dev)
    warm = {}
    for q in QUERIES:
        check(rows_equal(build_on(q, session, tables).toArrow(), refs[q]),
              f"{q} differs from its reference")
    for q in QUERIES:
        got, warm[q] = timed(build_on(q, session, tables))
        check(rows_equal(got, refs[q]), f"{q} warm run differs")
    attribution_cost(dev, tables, refs, warm)
    counts = observe_phase(dev, tables, refs, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[observe only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


def _logical_nodes(plan) -> list:
    out = [plan]
    for c in plan.children:
        out.extend(_logical_nodes(c))
    return out


def phase_only(dev, tables, CB, KN, which: str) -> int:
    """``--udf`` / ``--io`` / ``--lakehouse``: that phase alone (after the
    build and the kernel checks), then the kernel bit for bit at every
    shape it launched."""
    t0 = time.perf_counter()
    phase = {"udf": udf_phase, "io": io_phase,
             "lakehouse": lakehouse_phase}[which]
    counts = phase(dev, tables, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print(f"[{which} only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()}}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


# ---------------------------------------------------------------------------
# [planes]: whole-stage fusion, the result cache and the adaptive plane
# ---------------------------------------------------------------------------

# warm runs of each query under the SF1 conf, skipped for a query whose
# cold run took over PLANES_WARM_MAX_COLD_S: the conf's 2^16-row batches
# make q1, q5, q10, q18 and q21 take 4-58 s a run on the H100 (their warm
# walls 62-105% of their cold ones), and the script must end within its
# time limit
PLANES_WARM_RUNS = 1
PLANES_WARM_MAX_COLD_S = 4.0
FUSION_QUERIES = ("q1", "q3", "q6")
FUSION_WARM_RUNS = 2  # warm runs each with fusion on and off, interleaved
# q6's only map operator is one filter (its product is inside the
# aggregate): under the default mode it forms no region in either package
FUSION_MODE = {"q6": "aggressive"}
SKEW_SHARE = 0.3  # lineitem rows moved to the hot key of [planes]' skew join
SKEW_SEED = 20261018
DECISION_KINDS = ("broadcast", "shuffled", "skew-split", "batch-retarget")


def plane_counters() -> dict:
    """The engine planes' process counters (deltas read a run)."""
    from spark_rapids_tpu_torch import cache as cache_mod
    from spark_rapids_tpu_torch import fusion as FU
    from spark_rapids_tpu_torch.exec import fused as FX
    from spark_rapids_tpu_torch.runtime import telemetry as TM
    snap = TM.REGISTRY.snapshot()
    prog = FX.program_stats()
    out = {"regions_built": FU.REGIONS_BUILT.value,
           "regions_fell_open": FU.FALLBACKS.value,
           "capture_s": FU.COMPILE_SECONDS.value,
           "captures": prog["captures"], "replays": prog["replays"],
           "capture_failures": prog["capture_failures"],
           "cache_hits": cache_mod.HITS.value,
           "cache_misses": cache_mod.MISSES.value}
    for k in DECISION_KINDS:
        out[k] = snap.get(f'tpuq_adaptive_decisions_total{{kind="{k}"}}',
                          0)
    return out


def plane_delta(before: dict) -> dict:
    after = plane_counters()
    return {k: after[k] - before[k] for k in after}


def planes_run(name, q, session, tables, ref, CB, KN, cold=True):
    """One run of ``q``: counts to 0 before and read after, the result
    against its reference, no operator on the CPU, the cache probed
    where the session enables it."""
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    if cold:
        clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    before = plane_counters()
    df = build_on(q, session, tables)
    got, wall = timed(df)
    counts = path_counts(df, CB, KN)
    delta = plane_delta(before)
    check_result(name, got, ref)
    fb = df.fallback_summary()
    check(fb["fallback_ops"] == 0, f"planes {name}: {fb}")
    entry = df._last_query_entry
    from spark_rapids_tpu_torch import conf as C
    check("cache" in entry
          or not session.rapids_conf().get(C.CACHE_ENABLED),
          f"planes {name}: the result cache did not probe (an unkeyable "
          "input)")
    check(counts["collision_fallbacks"] == 0,
          f"planes {name}: hash-collision fallbacks")
    return df, got, wall, counts, delta, entry.get("cache")


def planes_phase(dev, tables, refs, CB, KN, query_shapes) -> dict:
    """``[planes]``: the engine planes at SF1 (see the module's
    docstring)."""
    import shutil
    import tempfile

    import pyarrow as pa
    import pyarrow.compute as pc
    import numpy as np

    from spark_rapids_tpu_torch.adaptive import cost_model
    from spark_rapids_tpu_torch.exec import fused as FX
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import device_profile as PR
    from spark_rapids_tpu_torch.utils import tpch
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    counts, lines = {}, {}
    sf1 = dict(SESSION_CONF, **tpch.TPCH_SF1_CONF)
    root = tempfile.mkdtemp(prefix="tpuq-planes-")
    try:
        # -- the 22 under the whole SF1 conf -------------------------------
        s = TpuSession(dict(sf1), device=dev)
        kinds = {k: 0 for k in DECISION_KINDS}
        for q in QUERIES:
            _, _, cold_s, c, d, cache = planes_run(
                q, q, s, tables, refs[q], CB, KN)
            counts[q] = c
            check(d["regions_fell_open"] == 0 or q not in FUSION_QUERIES,
                  f"planes {q}: a fused region fell open")
            check(cache["status"] == "uncached"
                  and cache["reason"] == "below_min_runtime",
                  f"planes {q}: cache {cache}")
            warm = []
            for _ in range(PLANES_WARM_RUNS
                           if cold_s <= PLANES_WARM_MAX_COLD_S else 0):
                _, _, w, _, wd, _ = planes_run(q, q, s, tables, refs[q],
                                               CB, KN, cold=False)
                warm.append(w)
                d["warm_replays"] = d.get("warm_replays", 0) \
                    + wd["replays"]
                d["warm_captures"] = d.get("warm_captures", 0) \
                    + wd["captures"]
            for k in DECISION_KINDS:
                kinds[k] += d[k]
            lines[q] = {
                "cold_s": cold_s,
                "warm_median_s": statistics.median(warm) if warm else None,
                "warm_s": warm,
                "hash_pairs_launches": c["hash_pairs_launches"],
                "regions_built": d["regions_built"],
                "regions_fell_open": d["regions_fell_open"],
                "graph_captures": d["captures"],
                "capture_s": round(d["capture_s"], 6),
                "graph_replays": d["replays"],
                "warm_graph_replays": d.get("warm_replays", 0),
                "warm_graph_captures": d.get("warm_captures", 0),
                "decisions": {k: d[k] for k in DECISION_KINDS if d[k]},
                "cache_probes": d["cache_hits"] + d["cache_misses"],
                "cache": cache["status"]}
            print(f"[planes] {q} SF{SF:g} " + json.dumps(lines[q]),
                  flush=True)
        lines["22"] = {
            "cold_sum_s": sum(lines[q]["cold_s"] for q in QUERIES),
            "warm_sum_s": sum(lines[q]["warm_median_s"] for q in QUERIES
                              if lines[q]["warm_s"]),
            "warm_skipped": [q for q in QUERIES if not lines[q]["warm_s"]],
            "decisions": kinds,
            "regions_built": sum(lines[q]["regions_built"]
                                 for q in QUERIES),
            "regions_fell_open": {q: lines[q]["regions_fell_open"]
                                  for q in QUERIES
                                  if lines[q]["regions_fell_open"]}}
        print("[planes] the 22 under TPCH_SF1_CONF " + json.dumps(
            lines["22"]), flush=True)
        for q in FUSION_QUERIES:
            check(lines[q]["regions_built"] > 0 or q in FUSION_MODE,
                  f"planes {q}: no fused region under the SF1 conf")

        # -- fusion on and off: q1, q3, q6 at the main path's conf ----------
        off = TpuSession(dict(SESSION_CONF), device=dev)
        for q in FUSION_QUERIES:
            on = TpuSession(dict(SESSION_CONF, **{
                "spark.rapids.tpu.fusion.enabled": True,
                "spark.rapids.tpu.fusion.mode": FUSION_MODE.get(q, "auto")}),
                device=dev)
            walls = {"on": [], "off": []}
            for name, sess in (("on", on), ("off", off)):
                planes_run(f"{q} fusion {name}", q, sess, tables, refs[q],
                           CB, KN)  # fills the scan cache, captures
            fell = []
            for _ in range(FUSION_WARM_RUNS):
                for name, sess in (("on", on), ("off", off)):
                    df, _, w, _, d, _ = planes_run(
                        f"{q} fusion {name}", q, sess, tables, refs[q],
                        CB, KN, cold=False)
                    walls[name].append(w)
                    if name == "on":
                        fell.append(d["regions_fell_open"])
                        check(d["regions_built"] > 0,
                              f"planes {q}: fusion on built no region")
                        check(d["captures"] == 0 and d["replays"] > 0,
                              f"planes {q}: a warm run captured "
                              f"{d['captures']}, replayed {d['replays']}")
            check(not any(fell), f"planes {q}: a fused region fell open")
            prof = {name: PR.profile_query(sess, q, tables)
                    for name, sess in (("on", on), ("off", off))}
            lines[f"{q} fusion"] = {
                "mode": FUSION_MODE.get(q, "auto"),
                "warm_on_s": walls["on"], "warm_off_s": walls["off"],
                "median_on_s": statistics.median(walls["on"]),
                "median_off_s": statistics.median(walls["off"]),
                **{f"{k}_{name}": prof[name].get(k)
                   for name in ("on", "off")
                   for k in ("device_events", "kernel_launches",
                             "graph_launches", "traced_wall_s",
                             "device_busy_s")}}
            check(prof["on"]["graph_launches"] > 0
                  and prof["off"]["graph_launches"] == 0,
                  f"planes {q}: graph launches on/off "
                  f"{prof['on']['graph_launches']}/"
                  f"{prof['off']['graph_launches']}")
            print(f"[planes] {q} fusion on/off " + json.dumps(
                lines[f"{q} fusion"]), flush=True)
        lines["graph pools"] = FX.graph_pool_bytes()
        print("[planes] graph pools (outside the memory arbiter) "
              + json.dumps(lines["graph pools"]), flush=True)

        # -- the result cache at SF1, at the main path's conf ---------------
        cs = TpuSession(dict(SESSION_CONF, **{
            "spark.rapids.tpu.cache.enabled": True}), device=dev)
        cs.invalidate_cache()
        _, first, miss_s, _, d1, c1 = planes_run(
            "q1 cache", "q1", cs, tables, refs["q1"], CB, KN)
        d1["miss_s"] = miss_s
        check(c1["status"] == "stored", f"planes: q1 cache {c1}")
        CB.reset_counts()
        df = build_on("q1", cs, tables)
        import torch
        torch.cuda.synchronize()
        from spark_rapids_tpu_torch.sql.dataframe import profile_capture
        from torch.autograd import DeviceType
        t1 = time.perf_counter()
        with profile_capture(dev) as prof:
            hit = df.toArrow()
            torch.cuda.synchronize()
        hit_s = time.perf_counter() - t1
        cuda_events = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
        entry = df._last_query_entry
        check(entry["cache"]["status"] == "hit",
              f"planes: second q1 {entry['cache']}")
        check(hit.equals(first), "planes: the hit differs from q1")
        check(CB.launches == 0, f"planes: the hit launched hash_pairs "
              f"{CB.launches} times")
        check(not cuda_events, f"planes: the hit ran {len(cuda_events)} "
              "CUDA events")
        h2d = sum(scan_transfer_times(df))
        check(h2d == 0, f"planes: the hit moved {h2d} s host to device")
        dropped = cs.invalidate_cache()
        _, _, miss_s, _, _, c3 = planes_run("q1 after invalidate", "q1",
                                            cs, tables, refs["q1"], CB, KN,
                                            cold=False)
        check(dropped >= 1 and c3["status"] == "stored",
              f"planes: after invalidate_cache ({dropped}) {c3}")
        # a subplan hit: two queries over one shared in-process exchange
        ss = TpuSession(dict(SESSION_CONF, **{
            "spark.rapids.tpu.cache.enabled": True,
            "spark.rapids.tpu.cache.subplan.enabled": True,
            "spark.rapids.shuffle.mode": "CACHE_ONLY"}), device=dev)
        ss.invalidate_cache()
        li = tables["lineitem"].select(
            ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount"])

        def shared():
            return ss.createDataFrame(li).repartition(16, "l_orderkey")

        sub = []
        for lo, hi in ((0.0, 10.0), (40.0, 51.0)):
            stats0 = ss.cache_stats()
            df = (shared().filter((col("l_quantity") >= lo)
                                  & (col("l_quantity") < hi))
                  .agg(F.sum("l_extendedprice").alias("rev"),
                       F.count("*").alias("n")))
            got, w = timed(df)
            m = pc.and_(pc.greater_equal(li["l_quantity"], lo),
                        pc.less(li["l_quantity"], hi))
            want = pa.table({"rev": [pc.sum(pc.filter(
                li["l_extendedprice"], m)).as_py()],
                "n": [pc.sum(m.cast(pa.int64())).as_py()]})
            check(rows_equal(got, want), f"planes: subplan query {lo}-{hi}"
                  f"\n{got}\n{want}")
            st = ss.cache_stats()
            sub.append({"wall_s": w,
                        "sub_hits": st["sub_hits"] - stats0["sub_hits"],
                        "sub_stored": st["sub_stored"]
                        - stats0["sub_stored"]})
        check(sub[0]["sub_stored"] >= 1 and sub[1]["sub_hits"] >= 1,
              f"planes: subplan {sub}")
        lines["cache"] = {"q1_miss_s": d1["miss_s"],
                          "q1_hit_s": hit_s, "hit_cuda_events": 0,
                          "hit_hash_pairs_launches": 0,
                          "hit_bytes": entry["cache"]["bytes"],
                          "invalidated": dropped,
                          "q1_after_invalidate_s": miss_s,
                          "subplan": sub,
                          "stats": {k: v for k, v in cs.cache_stats().items()
                                    if k != "by_signature"}}
        print("[planes] cache " + json.dumps(lines["cache"]), flush=True)
        ss.invalidate_cache()
        cs.invalidate_cache()

        # -- the adaptive plane: the join variants and a skewed join -------
        hist = os.path.join(root, "history.jsonl")
        ad = TpuSession(dict(sf1, **{
            "spark.rapids.tpu.stats.enabled": True,
            "spark.rapids.tpu.stats.storePath": hist,
            "spark.rapids.tpu.adaptive.historyPath": hist}), device=dev)
        seen = {k: 0 for k in DECISION_KINDS}
        for v, base in tpch.JOIN_VARIANTS.items():
            if v in {c[1] for c in FALLBACK_CASES}:
                continue  # a CPU join by design
            want = globals()["ref_" + v](tables)
            for run in ("cold", "history"):
                df, got, w, c, d, _ = planes_run(
                    f"{v} adaptive {run}", v, ad, tables, want, CB, KN,
                    cold=run == "cold")
                if run == "cold":
                    counts[f"{v} adaptive"] = c
                decs = df.session.last_query_profile().get(
                    "adaptive_decisions", [])
                for dec in decs:
                    seen[dec["kind"]] += 1
                    if "build_bytes" in dec:
                        check(dec["kind"] == cost_model.choose_join_strategy(
                            dec["build_bytes"], dec["threshold"]),
                            f"planes {v}: decision {dec}")
                lines[f"{v} adaptive {run}"] = {
                    "wall_s": w, "hash_pairs_launches":
                    c["hash_pairs_launches"],
                    "decisions": [{k: dec.get(k) for k in (
                        "kind", "source", "build_bytes", "threshold",
                        "splits", "partitions", "target_rows")
                        if dec.get(k) is not None} for dec in decs]}
                print(f"[planes] {v} adaptive {run} " + json.dumps(
                    lines[f"{v} adaptive {run}"]), flush=True)
        # skew: a seeded SKEW_SHARE of lineitem's rows on one order key
        li = tables["lineitem"].select(["l_orderkey", "l_extendedprice"])
        rng = np.random.default_rng(SKEW_SEED)
        keys = li["l_orderkey"].to_numpy().copy()
        hot = int(keys[rng.integers(0, len(keys))])
        keys[rng.random(len(keys)) < SKEW_SHARE] = hot
        li = li.set_column(0, "l_orderkey", pa.array(keys))
        orders = tables["orders"].select(["o_orderkey", "o_totalprice"])
        check(int(pc.sum(pc.equal(li["l_orderkey"], hot)).as_py())
              >= li.num_rows // 4, "planes: the hot key holds under a "
              "quarter of the rows")
        sk = TpuSession(dict(sf1, **{
            "spark.rapids.tpu.stats.enabled": True,
            "spark.sql.autoBroadcastJoinThreshold": 0}), device=dev)
        CB.reset_counts()
        KN.COUNTERS.reset()
        before = plane_counters()
        df = (sk.createDataFrame(li)
              .join(sk.createDataFrame(orders),
                    col("l_orderkey") == col("o_orderkey"))
              .agg(F.count("*").alias("n"),
                   F.sum("l_extendedprice").alias("price"),
                   F.sum("o_totalprice").alias("total")))
        got, skew_s = timed(df)
        d = plane_delta(before)
        counts["skewed join"] = path_counts(df, CB, KN)
        j = li.join(orders, "l_orderkey", right_keys="o_orderkey")
        want = pa.table({"n": [j.num_rows],
                         "price": [pc.sum(j["l_extendedprice"]).as_py()],
                         "total": [pc.sum(j["o_totalprice"]).as_py()]})
        check(rows_equal(got, want), f"planes: the skewed join\n{got}\n"
              f"{want}")
        split = [dec for dec in df.session.last_query_profile().get(
            "adaptive_decisions", []) if dec["kind"] == "skew-split"]
        check(split and sum(split[0]["splits"]) > 0,
              f"planes: the skewed join split nothing: {split}")
        seen["skew-split"] += len(split)
        lines["skewed join"] = {
            "hot_key_rows": int(pc.sum(pc.equal(li["l_orderkey"],
                                                hot)).as_py()),
            "rows": li.num_rows, "wall_s": skew_s,
            "split": {k: split[0][k] for k in (
                "partitions", "splits", "rows", "skew_factor",
                "threshold")} if split else None,
            "decisions": {k: d[k] for k in DECISION_KINDS if d[k]},
            "hash_pairs_launches": CB.launches}
        print("[planes] skewed join " + json.dumps(lines["skewed join"]),
              flush=True)
        total = {k: kinds[k] + seen[k] for k in DECISION_KINDS}
        check(total["broadcast"] > 0 and total["skew-split"] > 0,
              f"planes: decisions {total}")
        lines["decisions"] = total
    finally:
        shutil.rmtree(root, ignore_errors=True)
        clear_scan_cache()
    summary = {"seconds": time.perf_counter() - t0, "card": card,
               "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                       for k, c in counts.items()},
               "decisions": lines["decisions"],
               "new_hash_pairs_shapes": sorted(
                   {k for c in counts.values() for k in c["shapes"]}
                   - query_shapes)}
    print("[planes] " + json.dumps(summary), flush=True)
    return counts


def planes_only(dev, tables, refs, CB, KN) -> int:
    """``--planes``: [planes] alone, then the kernel bit for bit at every
    shape it launched."""
    t0 = time.perf_counter()
    counts = planes_phase(dev, tables, refs, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261018)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[planes only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": sum(c["hash_pairs_launches"]
                                   for c in counts.values())}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


# ---------------------------------------------------------------------------
# [distributed]: the ICI plane on eight virtual ranks of the card, and two
# executor processes over the rendezvous
# ---------------------------------------------------------------------------

DIST_RANKS = 8
DIST_QUERIES = ("q1", "q3", "q5", "q18")
DIST_CONF = {"spark.rapids.shuffle.mode": "ICI",
             "spark.default.parallelism": DIST_RANKS}
DIST_CHILD_RANKS = 2
DIST_LEASE_MS = 2000
DIST_CHILD_TIMEOUT_S = 240
_ICI_KEEP = ("TpuHashAggregate", "TpuIci", "TpuSortMergeJoin", "TpuSort ",
             "TpuSort partitioned", "TpuWindow", "TpuAdaptiveJoin",
             "TpuTopN", "TpuBroadcast")
# The JAX package's ICI plans of the four queries (its planner on eight
# virtual CPU devices, the thresholds scaled to the data, before any
# run; ``tests/test_torch_distributed.py`` holds the port's plans and
# these lines to the JAX package's)
DIST_PLAN_LINES = {
    "q1": [
        "TpuSort partitioned [input[0], input[1]]",
        "TpuIciRangeExchange [range(input[0], input[1]) over 8dev]",
        "TpuHashAggregate [final keys=[input[0], input[1]] aggs=[sum, "
        "sum, sum, sum, avg, avg, avg, count_star]]",
        "TpuIciShuffleExchange [hash(input[0], input[1]) over 8dev]",
        "TpuHashAggregate [partial keys=[input[0], input[1]] aggs=[sum, "
        "sum, sum, sum, avg, avg, avg, count_star]]"],
    "q3": [
        "TpuTopN [n=10]",
        "TpuHashAggregate [final keys=[input[2], input[4], input[5]] "
        "aggs=[sum]]",
        "TpuIciShuffleExchange [hash(input[0], input[1], input[2]) over "
        "8dev]",
        "TpuHashAggregate [partial keys=[input[2], input[4], input[5]] "
        "aggs=[sum]]",
        "TpuAdaptiveJoin [inner runtime=undecided thresh=T]",
        "TpuSortMergeJoin [inner broadcast=left]",
        "TpuBroadcastExchange"],
    "q5": [
        "TpuSort partitioned [input[1]]",
        "TpuIciRangeExchange [range(input[1]) over 8dev]",
        "TpuHashAggregate [final keys=[input[4]] aggs=[sum]]",
        "TpuIciShuffleExchange [hash(input[0]) over 8dev]",
        "TpuHashAggregate [partial keys=[input[4]] aggs=[sum]]",
        "TpuAdaptiveJoin [inner runtime=undecided thresh=T]",
        "TpuAdaptiveJoin [inner runtime=undecided thresh=T]",
        "TpuSortMergeJoin [inner broadcast=right]",
        "TpuSortMergeJoin [inner broadcast=right]",
        "TpuBroadcastExchange", "TpuBroadcastExchange"],
    "q18": [
        "TpuTopN [n=100]",
        "TpuHashAggregate [final keys=[input[1], input[0], input[2], "
        "input[4], input[5]] aggs=[sum]]",
        "TpuIciShuffleExchange [hash(input[0], input[1], input[2], "
        "input[3], input[4]) over 8dev]",
        "TpuHashAggregate [partial keys=[input[1], input[0], input[2], "
        "input[4], input[5]] aggs=[sum]]",
        "TpuAdaptiveJoin [inner runtime=undecided thresh=T]",
        "TpuSortMergeJoin [inner broadcast=left]",
        "TpuBroadcastExchange",
        "TpuAdaptiveJoin [left_semi runtime=undecided thresh=T]",
        "TpuHashAggregate [final keys=[input[0]] aggs=[sum]]",
        "TpuIciShuffleExchange [hash(input[0]) over 8dev]",
        "TpuHashAggregate [partial keys=[input[0]] aggs=[sum]]"],
}


def ici_lines(tree: str) -> list:
    """A plan's distributed shape: its aggregate, exchange, join, sort,
    window and top-N lines (fusion marks and thresholds aside)."""
    out = []
    for line in tree.splitlines():
        s = line.strip().lstrip("*")
        if s.startswith(_ICI_KEEP):
            out.append(re.sub(r"thresh=\d+", "thresh=T", s))
    return out


def ici_exchanges(node) -> list:
    """Every ICI exchange that ran under ``node``, those an adaptive join
    built at run time included."""
    out = []
    if type(node).__name__ in ("TpuIciShuffleExchangeExec",
                               "TpuIciRangeExchangeExec"):
        out.append(node)
    inner = getattr(node, "_inner", None)
    for c in list(node.children) + ([inner] if inner is not None else []):
        out.extend(ici_exchanges(c))
    return out


def spark_murmur3_long(values):
    """Spark's ``Murmur3_x86_32.hashLong`` of int64 values, seed 42
    (numpy): the low word, then the high word."""
    import numpy as np
    v = np.asarray(values, np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.uint64(32)).astype(np.uint32)
        h = _mix_h1(np.full(len(v), 42, np.uint32), _mix_k1(lo))
        h = _mix_h1(h, _mix_k1(hi))
        return _fmix32(h, 8)


def pmod_partitions(hashes, nparts: int):
    """Spark's ``pmod(hash, n)`` of the u32 hashes read as int32."""
    import numpy as np
    h = hashes.view(np.int32).astype(np.int64)
    return ((h % nparts) + nparts) % nparts


def dist_run(name, build, session, CB, KN):
    """One distributed run: cold (scan cache cleared, counts to 0 just
    before it, read just after) and one warm, equal; the ICI exchanges'
    timers and bytes."""
    from spark_rapids_tpu_torch.exec import distributed as DX
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    clear_scan_cache()
    CB.reset_counts()
    KN.COUNTERS.reset()
    bytes0 = DX._TM_ICI_BYTES.value
    df = build(session)
    got, cold = timed(df)
    counts = path_counts(df, CB, KN)
    exchanged = DX._TM_ICI_BYTES.value - bytes0
    exes = ici_exchanges(df._last_plan)
    check(exes, f"[distributed] {name}: no ICI exchange ran")
    wdf = build(session)
    out, warm = timed(wdf)
    # the same plan over the same cached batches: the same bits (one
    # Arrow comparison; the row-wise one only to report a difference)
    check(out.equals(got) or rows_equal(out, got),
          f"[distributed] {name}: the warm run differs from the cold run")
    fb = df.fallback_summary()
    check(fb["fallback_ops"] == 0,
          f"[distributed] {name}: operators on the CPU {fb}")
    line = {
        "rows": got.num_rows, "cold_wall_s": cold, "warm_wall_s": warm,
        "ici_exchanges": len(exes),
        "partitionTime_s": sum(e.metric("partitionTime").value
                               for e in exes),
        "collectiveTime_s": sum(e.metric("collectiveTime").value
                                for e in exes),
        "bytes_exchanged": exchanged,
        "hash_pairs_launches": counts["hash_pairs_launches"],
        "hash_pairs_shapes": counts["shapes"]}
    return got, df, counts, line


def dist_child(argv) -> int:
    """``chip_smoke.py --dist-child <pid> <nprocs> <port> <rendezvous>
    <tables dir> <device>``: one executor process of the two-process
    runs: q1 and q3 over the rendezvous, their exchanges' cluster-wide
    counts and local input rows, the transport, then one transient
    ``rendezvous`` fault in q1 and a ``peer_loss`` (pid 1 dies).  Writes
    its result tables as ``<tables dir>/out/<pid>-<run>.arrow`` and
    prints one JSON line."""
    import pyarrow as pa
    import torch
    pid, nprocs, port = int(argv[0]), int(argv[1]), int(argv[2])
    rdv, tdir, device = argv[3], argv[4], argv[5]
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    from spark_rapids_tpu_torch.parallel import mesh as MESH
    from spark_rapids_tpu_torch.parallel import rendezvous as RD
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    from spark_rapids_tpu_torch.runtime import resilience as R
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    MESH.set_virtual_ranks(DIST_CHILD_RANKS)
    if device == "cpu":
        torch.set_num_threads(2)  # two executors share the host's cores
    tables = {}
    for f in sorted(os.listdir(tdir)):
        if f.endswith(".arrow"):
            with pa.memory_map(os.path.join(tdir, f)) as src:
                tables[f[:-len(".arrow")]] = \
                    pa.ipc.open_file(src).read_all()
    odir = os.path.join(tdir, "out")
    os.makedirs(odir, exist_ok=True)

    def save(name, table):
        with pa.OSFile(os.path.join(odir, f"{pid}-{name}.arrow"),
                       "wb") as f:
            with pa.ipc.new_file(f, table.schema) as w:
                w.write_table(table)

    def conf(**extra):
        c = dict(SESSION_CONF, **DIST_CONF, **{
            "spark.rapids.executor.id": pid,
            "spark.rapids.executor.count": nprocs,
            "spark.rapids.executor.coordinator.address":
                f"127.0.0.1:{port}",
            "spark.rapids.shuffle.rendezvous.address": rdv,
            "spark.rapids.tpu.rendezvous.heartbeatMs": 100,
            "spark.rapids.tpu.rendezvous.leaseMs": DIST_LEASE_MS,
            "spark.rapids.tpu.retry.backoffBaseMs": 0})
        c.pop(BLACKBOX_KEY, None)
        c.update(extra)
        return c

    out = {"pid": pid, "runs": {}}
    # the stats plane records the exchanges' cluster-wide counts
    s = TpuSession(conf(**{"spark.rapids.tpu.stats.enabled": True}),
                   device=device)
    ctx = get_executor()
    out["transport"] = ctx.transport.describe()
    out["device"] = str(s.device)
    sync = (torch.cuda.synchronize if s.device.type == "cuda"
            else (lambda: None))
    for q in ("q1", "q3"):
        CB.reset_counts()
        sync()
        t0 = time.perf_counter()
        df = tpch.build(q, s, tables)
        got = df.toArrow()
        sync()
        wall = time.perf_counter() - t0
        exes = ici_exchanges(df._last_plan)
        prof = s.last_query_profile() or {}
        save(q, got)
        out["runs"][q] = {
            "rows": got.num_rows, "wall_s": wall,
            "exchange_input_rows": sum(getattr(e, "input_rows", 0)
                                       for e in exes),
            "exchanges": [{k: e.get(k) for k in ("total", "executors",
                                                  "max", "skew_factor")}
                          for e in prof.get("exchanges", [])],
            "hash_pairs_launches": CB.launches,
            "shapes": {f"{l}x{n}": c for (l, n), c
                       in sorted(CB.launch_shapes.items())}}
    out["host_bytes"] = ctx.transport.host_bytes
    out["wire_bytes"] = ctx.transport.wire_bytes
    # one transient rendezvous fault on pid 0: both re-enter at epoch 1
    base = RD.counters_snapshot()["epoch_retries"]
    inj = ({"spark.rapids.tpu.test.inject.rendezvous.at": 1,
            "spark.rapids.tpu.test.inject.rendezvous.transientCount": 1}
           if pid == 0 else {})
    fs = TpuSession(conf(**inj), device=device)
    save("q1_faulted", tpch.build("q1", fs, tables).toArrow())
    out["epoch_retries"] = RD.counters_snapshot()["epoch_retries"] - base
    # peer_loss last (the group is broken after it): pid 1 dies
    inj = ({"spark.rapids.tpu.test.inject.peer_loss.at": 1}
           if pid == 1 else {})
    ps = TpuSession(conf(**inj), device=device)
    try:
        tpch.build("q1", ps, tables).toArrow()
        out["peer_loss"] = ["completed", None, None, time.time()]
    except R.TerminalDeviceError as e:
        # the wall clock of the failure: the victim's is its death
        out["peer_loss"] = ["failed", e.domain, e.peer, time.time()]
    out["rendezvous"] = RD.counters_snapshot()
    print(json.dumps(out), flush=True)
    return 0


def two_process_runs(tdir, device_arg, refs, first) -> dict:
    """Spawn the two executor processes (``dist_child``) around a
    rendezvous coordinator in this process; check their slices and
    faults.  Returns the children's records."""
    import socket

    from spark_rapids_tpu_torch.parallel.rendezvous import (
        RendezvousCoordinator)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    coord = RendezvousCoordinator(num_processes=2,
                                  lease_s=DIST_LEASE_MS / 1000.0)
    env = dict(os.environ)
    env.pop("TPUQ_VIRTUAL_RANKS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-child",
         str(pid), "2", str(port), coord.address, tdir, device_arg],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(timeout=DIST_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
            outs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        stages_left = dict(coord._stages)
        coord.shutdown()
    for pid, (rc, so, se) in enumerate(outs):
        check(rc == 0 and so.strip(), f"[distributed] executor {pid} "
              f"exited {rc}:\n{se[-4000:]}")
    recs = [json.loads(so.strip().splitlines()[-1]) for _, so, _ in outs]
    check(stages_left == {}, f"[distributed] stage leak {stages_left}")
    import pyarrow as pa

    def result(pid, name):
        with pa.memory_map(os.path.join(tdir, "out",
                                        f"{pid}-{name}.arrow")) as src:
            return pa.ipc.open_file(src).read_all()

    for q in ("q1", "q3"):
        union = pa.concat_tables([result(pid, q) for pid in range(2)])
        check(rows_equal(union, refs[q]) and rows_equal(union, first[q]),
              f"[distributed] two-process {q}: the union of the slices "
              "differs from the reference")
        inputs = sum(rec["runs"][q]["exchange_input_rows"] for rec in recs)
        for rec in recs:
            for ex in rec["runs"][q]["exchanges"][:1]:
                check(ex["executors"] == 2,
                      f"[distributed] {q}: counts merged from "
                      f"{ex['executors']} executors")
            total = sum(ex["total"] for ex in rec["runs"][q]["exchanges"])
            check(total == inputs,
                  f"[distributed] {q}: pid {rec['pid']}'s cluster-wide "
                  f"counts sum to {total}, the exchanges took {inputs}")
    for pid in range(2):
        check(rows_equal(result(pid, "q1_faulted"), result(pid, "q1")),
              f"[distributed] pid {pid}: q1 under a transient rendezvous "
              "fault differs")
    check(recs[0]["epoch_retries"] >= 1,
          "[distributed] the transient rendezvous fault did not retry")
    victim, survivor = recs[1]["peer_loss"], recs[0]["peer_loss"]
    check(victim[:2] == ["failed", "peer_loss"],
          f"[distributed] the victim of peer_loss: {victim}")
    # the survivor fails peer-tagged within about one lease of the death
    # (the reaper looks every quarter lease)
    detect_s = survivor[3] - victim[3]
    check(survivor[:3] == ["failed", "peer_loss", 1]
          and detect_s < 2 * DIST_LEASE_MS / 1000.0 + 0.5,
          f"[distributed] the survivor of peer_loss: {survivor}, "
          f"{detect_s:.3f} s after the victim's death")
    for rec in recs:
        rec["peer_loss_detect_s"] = detect_s
    return recs


def distributed_phase(dev, tables, refs, first, CB, KN, query_shapes
                      ) -> dict:
    """``[distributed]``: the ICI plane on the card at SF1.

    Single process, eight virtual ranks on the one card (the JAX tests'
    eight devices) under ``spark.rapids.shuffle.mode=ICI``,
    ``spark.default.parallelism`` 8 and ``test.enabled``: q1, q3, q5
    and q18 (partial/final aggregates, the adaptive joins deciding
    between broadcast and two ICI exchanges, range exchanges under
    ``partitioned`` sorts), the 1.5M orders ordered by price (a range
    exchange), and the line running totals over lineitem partitioned by
    ``l_orderkey`` (the window behind a hash exchange); each cold then
    warm, equal to its reference (and q1-q18 to the main path's
    one-rank run), its plan's ICI lines the JAX package's.  q18's inner
    aggregate behind a repartition under ``exchange.mode=compiled`` and
    ``host``: the exchanges' partitions equal row for row, their row
    counts this script's numpy murmur3 pmod 8.  A terminal
    ``collective`` fault in q1: degraded to the host transport, equal,
    counted.  Then two executor processes x 2 virtual ranks on the card
    over the rendezvous (``two_process_runs``), and over NCCL one card
    each when the machine has two.  Returns the runs' counts."""
    import tempfile

    import numpy as np
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch.exec.basic import clear_scan_cache
    from spark_rapids_tpu_torch.runtime import resilience as RES
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.sql.column import col
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    t_phase = time.perf_counter()
    conf = dict(SESSION_CONF, **DIST_CONF)
    session = TpuSession(conf, device=dev)
    counts, lines = {}, {}
    for q in DIST_QUERIES:
        plan = ici_lines(build_on(q, session, tables)._execute_plan()
                         .tree_string())
        check(plan == DIST_PLAN_LINES[q],
              f"[distributed] {q}'s plan is not the JAX package's:\n"
              + "\n".join(plan))
        got, df, counts[q], lines[q] = dist_run(
            q, lambda s, q=q: build_on(q, s, tables), session, CB, KN)
        check_result(f"[distributed] {q}", got, refs[q])
        check(rows_equal(got, first[q]),
              f"[distributed] {q} differs from its one-rank run")
        lines[q]["joins"] = join_strategies(df)
        print(f"[distributed] {q} " + json.dumps(lines[q]), flush=True)
    # the range exchange under a partitioned sort: all 1.5M orders
    orders = tables["orders"]

    def by_price(s):
        return s.createDataFrame(orders).orderBy(
            col("o_totalprice").desc(), col("o_orderkey"))

    got, df, counts["orders by price"], line = dist_run(
        "orders by price", by_price, session, CB, KN)
    want = orders.sort_by([("o_totalprice", "descending"),
                           ("o_orderkey", "ascending")])
    check(got.num_rows == orders.num_rows and all(
        got.column(c).combine_chunks().equals(
            want.column(c).combine_chunks()) for c in want.column_names),
        "[distributed] orders by price differs from pyarrow's sort")
    check(ici_lines(df._last_plan.tree_string())[:2] == [
        "TpuSort partitioned [input[4], input[0]]",
        "TpuIciRangeExchange [range(input[4], input[0]) over 8dev]"],
        "[distributed] orders by price: not a partitioned sort behind a "
        "range exchange")
    lines["orders by price"] = line
    print("[distributed] orders by price " + json.dumps(line), flush=True)
    # the window behind a hash exchange on its partition key
    wt = tpch.window_tables(tables)
    want = ref_line_running_totals(wt)
    got, df, counts["line running totals"], line = dist_run(
        "line running totals",
        lambda s: tpch.WINDOW_QUERIES["line running totals"](s, wt),
        session, CB, KN)
    check("TpuWindow partitioned [partitionBy=[input[0]]"
          in df._last_plan.tree_string(),
          "[distributed] line running totals: no partitioned window")
    got = got.sort_by([("l_orderkey", "ascending"),
                       ("l_linenumber", "ascending")])
    line["facts"] = check_line_running_totals(got, want)
    lines["line running totals"] = line
    print("[distributed] line running totals " + json.dumps(line),
          flush=True)
    del wt, want, got
    # q18's inner aggregate behind a repartition: compiled vs host
    li = tables["lineitem"].select(["l_orderkey", "l_quantity"])
    keys = li.column("l_orderkey").to_numpy()
    want_counts = np.bincount(pmod_partitions(spark_murmur3_long(keys),
                                              DIST_RANKS),
                              minlength=DIST_RANKS).tolist()
    parts, aggs = {}, {}
    for mode, node in (("compiled", "TpuIciShuffleExchangeExec"),
                       ("host", "TpuHostShuffleExchangeExec")):
        s = TpuSession(dict(conf, **{"spark.rapids.tpu.exchange.mode":
                                     mode}), device=dev)
        clear_scan_cache()
        df = (s.createDataFrame(li).repartition(DIST_RANKS, "l_orderkey")
              .groupBy("l_orderkey")
              .agg(SF_.sum("l_quantity").alias("sum_qty")))
        aggs[mode] = df.toArrow()
        # the repartition's exchange: the one with no exchange below it
        ex = [e for e in find_nodes(df._last_plan, node)
              if not find_nodes(e.children[0], node)]
        check(len(ex) == 1, f"[distributed] exchange.mode={mode}: "
              f"{len(ex)} {node} over the scan")
        parts[mode] = [exchange_partition(ex[0], p)
                       for p in range(DIST_RANKS)]
    got_counts = [t.num_rows for t in parts["compiled"]]
    check(got_counts == want_counts,
          f"[distributed] compiled partition rows {got_counts}, numpy "
          f"murmur3 pmod 8 {want_counts}")
    for p in range(DIST_RANKS):
        check(parts["compiled"][p].equals(parts["host"][p]),
              f"[distributed] partition {p}: compiled != host row for row")
    ref18 = q18_inner_ref(li)
    for mode in ("compiled", "host"):
        check(keyed_equal(aggs[mode], ref18, "l_orderkey"),
              f"[distributed] q18's inner aggregate ({mode}) differs")
    print("[distributed] q18 inner aggregate " + json.dumps({
        "partition_rows": got_counts, "equal_row_for_row": True,
        "groups": aggs["compiled"].num_rows}), flush=True)
    # a terminal collective fault: degraded to the host transport
    base = RES.counters_snapshot()
    fs = TpuSession(dict(conf, **{
        "spark.rapids.tpu.test.inject.collective.at": 1,
        "spark.rapids.tpu.test.inject.collective.transientCount": 0,
        "spark.rapids.tpu.retry.backoffBaseMs": 0}), device=dev)
    fdf = build_on("q1", fs, tables)
    fgot = fdf.toArrow()
    degraded = (fdf._last_query_entry or {}).get("resilience", {}) \
        .get("degraded_ops", [])
    check(any(d["domain"] == "collective" for d in degraded),
          f"[distributed] the collective fault did not degrade: {degraded}")
    check(RES.counters_snapshot()["host_degraded_ops"]
          == base["host_degraded_ops"] + 1,
          "[distributed] the collective degrade was not counted")
    check(rows_equal(fgot, refs["q1"]),
          "[distributed] q1 degraded to the host transport differs")
    RES.INJECTOR.reset()
    print("[distributed] collective fault " + json.dumps(
        {"degraded_ops": degraded, "equal_reference": True}), flush=True)
    # two executor processes x 2 virtual ranks on the card
    tdir = tempfile.mkdtemp(prefix="tpuq-dist-")
    try:
        t0 = time.perf_counter()
        for name, t in tables.items():
            with pa.OSFile(os.path.join(tdir, name + ".arrow"), "wb") as f:
                with pa.ipc.new_file(f, t.schema) as w:
                    w.write_table(t)
        ipc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = two_process_runs(
            tdir, "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}",
            refs, first)
        two_s = time.perf_counter() - t0
        print("[distributed] two processes " + json.dumps({
            "ipc_write_s": ipc_s, "seconds": two_s,
            "transport": [r["transport"] for r in recs],
            "devices": [r["device"] for r in recs],
            "host_bytes": [r["host_bytes"] for r in recs],
            "wire_bytes": [r["wire_bytes"] for r in recs],
            "walls_s": {q: [r["runs"][q]["wall_s"] for r in recs]
                        for q in ("q1", "q3")},
            "exchange_input_rows": {
                q: [r["runs"][q]["exchange_input_rows"] for r in recs]
                for q in ("q1", "q3")},
            "cluster_counts": {q: [r["runs"][q]["exchanges"] for r in recs]
                               for q in ("q1", "q3")},
            "hash_pairs_launches": {
                q: [r["runs"][q]["hash_pairs_launches"] for r in recs]
                for q in ("q1", "q3")},
            "epoch_retries": [r["epoch_retries"] for r in recs],
            "peer_loss": [r["peer_loss"][:3] for r in recs],
            "peer_loss_detect_s": recs[0]["peer_loss_detect_s"],
            "rendezvous": [r["rendezvous"] for r in recs]}), flush=True)
        check(all(r["transport"].startswith("gloo") for r in recs),
              "[distributed] two processes on one card must use gloo")
        for q in ("q1", "q3"):
            counts["two-process " + q] = {
                "hash_pairs_launches": sum(
                    r["runs"][q]["hash_pairs_launches"] for r in recs),
                "shapes": _merge_shapes(r["runs"][q]["shapes"]
                                        for r in recs)}
        if torch.cuda.device_count() >= 2:
            recs = two_process_runs(tdir, "cuda", refs, first)
            check(all(r["transport"] == "nccl" for r in recs),
                  "[distributed] one card per process must use NCCL")
            print("[distributed] two processes over NCCL " + json.dumps({
                "devices": [r["device"] for r in recs],
                "wire_bytes": [r["wire_bytes"] for r in recs]}),
                flush=True)
        else:
            print("[distributed] the NCCL path did not run: the machine "
                  f"shows {torch.cuda.device_count()} card", flush=True)
    finally:
        import shutil
        shutil.rmtree(tdir, ignore_errors=True)
    print("[distributed] " + json.dumps({
        "seconds": time.perf_counter() - t_phase,
        "hash_pairs_launches": {k: c["hash_pairs_launches"]
                                for k, c in counts.items()},
        "new_hash_pairs_shapes": sorted(
            {k for c in counts.values() for k in c["shapes"]}
            - query_shapes)}), flush=True)
    return counts


def exchange_partition(exchange, p):
    """Partition ``p`` of an executed exchange as one Arrow table."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.column import device_to_host
    from spark_rapids_tpu_torch.columnar.dtypes import to_arrow
    got = [device_to_host(b) for b in exchange.execute(p)]
    if got:
        return pa.concat_tables(got)
    return pa.table({f.name: pa.array([], to_arrow(f.dtype))
                     for f in exchange.schema.fields})


def _merge_shapes(shape_dicts) -> dict:
    out = {}
    for d in shape_dicts:
        for k, n in d.items():
            out[k] = out.get(k, 0) + n
    return out


def keyed_equal(a, b, key: str, tol=1e-9) -> bool:
    """Two tables with one row per ``key`` value, equal after sorting by
    it: integers exactly, floats within ``tol`` relative (vectorized;
    ``rows_equal``'s Python rows take minutes at 1.5M rows)."""
    import numpy as np
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        return False
    a, b = a.sort_by(key), b.sort_by(key)
    for name in a.column_names:
        x = a.column(name).to_numpy(zero_copy_only=False)
        y = b.column(name).to_numpy(zero_copy_only=False)
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            x, y = x.astype(np.float64), y.astype(np.float64)
            if not np.all(np.abs(x - y) <= tol * np.maximum(
                    1.0, np.maximum(np.abs(x), np.abs(y)))):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def q18_inner_ref(li):
    """q18's inner aggregate by pyarrow: sum of quantity per order."""
    agg = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    return agg.select(["l_orderkey", "l_quantity_sum"]).rename_columns(
        ["l_orderkey", "sum_qty"])


def distributed_only(dev, tables, refs, first, CB, KN) -> int:
    """``--distributed``: [distributed] alone (the one-rank runs of its
    four queries first), then the kernel bit for bit at every shape it
    launched."""
    t0 = time.perf_counter()
    counts = distributed_phase(dev, tables, refs, first, CB, KN, set())
    gen = __import__("torch").Generator(device=dev)
    gen.manual_seed(20261019)
    shapes = sorted({k for c in counts.values() for k in c["shapes"]},
                    key=lambda k: tuple(map(int, k.split("x"))))
    for key in shapes:
        n_limbs, n = (int(x) for x in key.split("x"))
        kernel_line(CB, None, random_limbs(n_limbs, n, gen, dev),
                    timed=False)
    print("[distributed only] " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "shapes_bit_identical": shapes,
        "hash_pairs_launches": sum(c["hash_pairs_launches"]
                                   for c in counts.values())}), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import pyarrow as pa
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is unavailable (torch "
              f"{torch.__version__}); this test needs a CUDA card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    laps, lap_t = {}, [t_start]

    def lap(name):
        """Seconds since the previous lap, printed at the end."""
        now = time.perf_counter()
        laps[name] = round(now - lap_t[0], 3)
        lap_t[0] = now

    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from spark_rapids_tpu_torch import kernels as KN
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.parallel import mesh as MESH
    from spark_rapids_tpu_torch.utils import device_profile as PR
    from spark_rapids_tpu_torch.utils import tpch

    # the ICI plane's eight virtual ranks (only ICI sessions read them)
    MESH.set_virtual_ranks(DIST_RANKS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[device] torch: {kind} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = CB.build(verbose=True)
    CB._library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(CB.ptxas_log(lib_path).read_text())
    check(set(ptxas) == {"L1", "L2", "L3", "L4", "L<=8"},
          f"ptxas reported {sorted(ptxas)}")
    print(f"[build] hash_pairs.cu -> {os.path.relpath(lib_path, here)} in "
          f"{build_s:.3f} s; ptxas " + json.dumps(ptxas), flush=True)

    # -- kernel vs plain ---------------------------------------------------
    timer = KernelTimer(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    for n_limbs, n in KERNEL_SHAPES:
        limbs = random_limbs(n_limbs, n, gen, dev)
        line = kernel_line(CB, timer, limbs, timed=n >= 1 << 16)
        print("[kernel] hash_pairs " + json.dumps(line), flush=True)
        del limbs
    n_cases = 0
    for name, sets in kernel_cases(CB, gen, dev):
        check_hash(CB, sets, name)
        n_cases += 1
    print(f"[kernel] hash_pairs: {n_cases} edge cases (odd n, misaligned "
          "row views, chained L, two sets) bit-identical to the plain "
          "version", flush=True)

    # -- TPC-H at SF1 on the card: the main path ------------------------------
    t0 = time.perf_counter()
    tables = tpch.gen_tpch(SF)
    gen_s = time.perf_counter() - t0
    li = tables["lineitem"]
    print(f"[generate] SF{SF:g}: " + ", ".join(
        f"{k} {v.num_rows} rows" for k, v in tables.items())
        + f" in {gen_s:.3f} s", flush=True)
    lap("build, kernels, generate")
    if BREADTH_ONLY:
        return breadth_only(dev, tables, CB, KN)
    if DECIMAL_ONLY:
        return decimal_only(dev, tables, CB, KN)
    if NESTED_ONLY:
        return nested_only(dev, tables, CB, KN)
    if WINDOW_ONLY:
        return window_only(dev, tables, CB, KN)
    if UDF_ONLY or IO_ONLY or LAKEHOUSE_ONLY:
        return phase_only(dev, tables, CB, KN, "udf" if UDF_ONLY else
                           "io" if IO_ONLY else "lakehouse")
    check(len(QUERIES) == 22 and set(QUERIES) == set(tpch.QUERIES)
          == {f"q{i}" for i in range(1, 23)},
          f"QUERIES lists {sorted(QUERIES)}, not TPC-H's 22")
    t0 = time.perf_counter()
    refs = {q: globals()["ref_" + q](li if q in ("q1", "q6") else tables)
            for q in QUERIES}
    print(f"[reference] pyarrow {' '.join(QUERIES)} in "
          f"{time.perf_counter() - t0:.3f} s; rows " + json.dumps(
              {q: r.num_rows for q, r in refs.items()}), flush=True)
    check(refs["q1"].num_rows == 6, "reference q1 should have 6 groups")
    check(refs["q3"].num_rows == 10, "reference q3 should have 10 rows")
    check(refs["q4"].num_rows == 5, "reference q4 should have 5 groups")
    check(refs["q10"].num_rows == 20, "reference q10 should have 20 rows")
    for q, r in refs.items():
        if q == "q22" and r.num_rows == 0:
            # its anti join may keep nobody; then its input must hold rows
            n_in = ref_q22_before_anti(tables).num_rows
            check(n_in > 0, "reference q22 is empty before its anti join")
            print(f"[reference] q22 is empty; {n_in} customers reach its "
                  "anti join", flush=True)
            continue
        check(r.num_rows > 0, f"reference {q} is empty")

    def build(q, session):
        return build_on(q, session, tables)

    if FAULTS_ONLY:
        return faults_only(dev, tables, refs, CB, KN)
    if OBSERVE_ONLY:
        return observe_only(dev, tables, refs, CB, KN)
    if PLANES_ONLY:
        return planes_only(dev, tables, refs, CB, KN)
    if DISTRIBUTED_ONLY:
        one = TpuSession(dict(SESSION_CONF), device=dev)
        first = {q: build(q, one).toArrow() for q in DIST_QUERIES}
        return distributed_only(dev, tables, refs, first, CB, KN)

    # test mode: any CPU fallback in the main path raises
    session = TpuSession(dict(SESSION_CONF), device=dev)
    check(session.device.type == "cuda", "session is not on the card")
    exact = TpuSession(dict(SESSION_CONF, **{
        "spark.rapids.tpu.kernel.backend": "jnp"}), device=dev)

    # each query: the scan cache cleared, then its cold run (the main
    # path: counts to 0 just before, read just after), warm runs that
    # must find every scan in the cache, and the exact rung
    first, counts, summary = {}, {}, {}
    for q in QUERIES:
        first[q], counts[q], summary[q] = query_phase(
            q, session, exact, tables, refs[q], CB, KN)
    main_shapes = {}
    for q in QUERIES:
        for key, c in counts[q]["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + c
    n_batches = -(-li.num_rows // session.rapids_conf().batch_rows)
    check(counts["q1"]["hash_pairs_launches"] >= n_batches + 1,
          f"hash_pairs launched {counts['q1']['hash_pairs_launches']} "
          f"times in q1, expected at least one per input batch plus one "
          f"per merge ({n_batches + 1})")
    for q in QUERIES:
        joins = counts[q]["joins"]
        streamed = sum(j["streamedLeftGroups"] + j["streamedRightGroups"]
                       for j in joins)
        # one launch (build and probe) per match of each streamed group,
        # of each broadcast join and of each sub-partition pair
        check(counts[q]["hash_pairs_launches"] >= streamed,
              f"{q}: {counts[q]['hash_pairs_launches']} hash_pairs "
              f"launches for {streamed} streamed join groups")
        check(counts[q]["hash_pairs_launches"] > 0 or q == "q6",
              f"{q}: hash_pairs was not launched")
    for q in QUERIES:
        print(f"[{q} result] {first[q].num_rows} rows\n"
              f"{first[q].slice(0, 6).to_pandas().to_string()}",
              flush=True)

    lap("22 queries")
    # -- the scan cache with all 22 queries' tables resident ---------------
    resident_phase(session, tables, refs, dev)
    lap("scan cache")
    # -- attribution is on by default: its cost over the warm 22 -------------
    attribution_cost(dev, tables, refs,
                     {q: summary[q]["wall_s_median"] for q in QUERIES})
    lap("attribution cost")
    # -- spill: q3 under a pool of ~1.5 of lineitem's cached batches --------
    spill = spill_phase(session, SESSION_CONF, tables, refs["q3"],
                        first["q3"], n_batches, dev)
    # -- device dictionary decode: q1, q12, q19 cold -----------------------
    dict_phase(session, tables, refs, first, summary)
    lap("spill, dict decode")
    # -- the join variants: right, residual, cross condition, full ---------
    var_counts = {}
    fallback_names = {c[1] for c in FALLBACK_CASES}
    for v in tpch.JOIN_VARIANTS:
        if v not in fallback_names:  # q13_cond is a [fallback] case
            var_counts[v] = variant_phase(v, session, exact, tables, first,
                                          CB, KN)
    query_shapes = set(main_shapes)
    for v in var_counts:
        for key, c in var_counts[v]["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + c
    print("[join variant] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("join variant")

    # -- plans with an operator on the CPU ----------------------------------
    refs["q13_cond"] = ref_q13_cond(tables)
    fb_counts = {}
    for case in FALLBACK_CASES:
        fb_counts[case[0]] = fallback_phase(case, dev, tables, refs, first,
                                            CB, KN)
    for c in fb_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[fallback] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    # -- bench's CPU-oracle loop on the card --------------------------------
    oracle_phase(dev)
    lap("fallback, oracle")

    # -- multi-partition execution: six queries under 8 partitions ----------
    part_counts, part_runs = {}, {}
    for q in PARTITION_QUERIES:
        part_counts[q] = partitions_phase(q, dev, tables, refs[q], first,
                                          summary, counts[q], CB, KN,
                                          part_runs)
    # -- the exchange plane: repartition through both transports -------------
    ex_counts = exchange_phase(dev, tables, CB, KN)
    new_paths = list(part_counts.values()) + list(ex_counts.values())
    check(sum(c["hash_pairs_launches"] for c in part_counts.values()) > 0
          and sum(c["hash_pairs_launches"] for c in ex_counts.values()) > 0,
          "hash_pairs was not launched under [partitions] or [exchange]")
    for c in new_paths:
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[partitions/exchange] hash_pairs shapes the 22 queries did not "
          "launch: " + json.dumps(sorted(set(main_shapes) - query_shapes)),
          flush=True)
    lap("partitions, exchange")
    # -- limits, union, range, sample, rollup/cube, out-of-core sort --------
    op_counts = operators_phase(dev, tables, refs, CB, KN)
    for c in op_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[operators] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("operators")
    # -- the string expressions, the regex engine and the string casts -------
    str_counts = strings_phase(dev, tables, CB, KN, query_shapes)
    check(str_counts["phone report"]["hash_pairs_launches"] > 0
          and str_counts["catalogue grouped"]["hash_pairs_launches"] > 0,
          "hash_pairs was not launched on [strings] runs 1-2")
    for c in str_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[strings] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("strings")
    # -- the memory runtime: disk tier, OOM retry, the aggregate's passes ----
    refs["q3_full"] = ref_q3_full(tables)
    retry_counts = retry_phase(session, tables, refs, first, summary, spill,
                               n_batches, dev, CB, KN)
    for c in retry_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[retry] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("retry")
    # -- the pump's concurrency: the task pool, prefetch, shapes, cache -------
    pump_counts = pump_phase(dev, tables, refs, part_runs, CB, KN)
    for c in pump_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[pump] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("pump")
    # -- the failure domains: faults, retries, breakers, cancel, lockdep -----
    from spark_rapids_tpu_torch.runtime import resilience as RES
    fault_counts = faults_phase(dev, tables, refs, first, spill, CB, KN)
    after_faults = RES.counters_snapshot()
    for c in fault_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[faults] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("faults")
    # -- the scalar and aggregate breadth: expressions, hashes, aggregates --
    breadth_counts = breadth_phase(dev, tables, CB, KN, query_shapes)
    for c in breadth_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[breadth] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("breadth")
    # -- decimals and time zones: q1, q6, q18 over decimal(12,2) -----------
    decimal_counts = decimal_phase(dev, tables, CB, KN, query_shapes)
    for c in decimal_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[decimal] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("decimal")
    # -- nested and array columns: structs, explode, collect, split, JSON --
    nested_counts = nested_phase(dev, tables, CB, KN, query_shapes)
    for c in nested_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[nested] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("nested")
    # -- window functions: ranks, offsets, running and bounded frames ------
    window_counts = window_phase(dev, tables, CB, KN, query_shapes)
    for c in window_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[window] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("window")
    # -- python UDFs: the arrow bridge, the compiler, device UDFs ----------
    udf_counts = udf_phase(dev, tables, CB, KN, query_shapes)
    for c in udf_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[udf] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("udf")
    # -- parquet scans and writes: pushdown, input_file_name, dict decode ---
    io_counts = io_phase(dev, tables, CB, KN, query_shapes)
    for c in io_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[io] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("io")
    # -- table formats: Delta, Iceberg, avro, dynamic partition pruning ------
    lake_counts = lakehouse_phase(dev, tables, CB, KN, query_shapes)
    for c in lake_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[lakehouse] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("lakehouse")
    # -- the observability plane: ledger, profile capture, black box ---------
    obs_counts = observe_phase(dev, tables, refs, CB, KN, query_shapes)
    for c in obs_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[observe] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("observe")
    # -- the engine planes: the 22 under the SF1 conf, fusion, cache, AQE ----
    plane_counts = planes_phase(dev, tables, refs, CB, KN, query_shapes)
    for c in plane_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[planes] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("planes")
    # -- the distributed plane: ICI on eight virtual ranks, two executors ----
    check(RES.counters_snapshot() == after_faults,
          "failure-domain counters moved between [faults] and "
          "[distributed]")
    dist_counts = distributed_phase(dev, tables, refs, first, CB, KN,
                                    query_shapes)
    # [distributed] arms collective, rendezvous and peer_loss faults
    after_faults = RES.counters_snapshot()
    for c in dist_counts.values():
        for key, n in c["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + n
    print("[distributed] hash_pairs shapes the 22 queries did not launch: "
          + json.dumps(sorted(set(main_shapes) - query_shapes)), flush=True)
    lap("distributed")

    # -- the string expressions alone, at the batches of their scans ---------
    string_rows = string_expr_times(tables, session)
    for line in string_rows:
        print("[string expression] " + json.dumps(line), flush=True)
    lap("string expression")

    # -- the kernel at the main path's shapes ---------------------------------
    shape_rows, kernel_row = [], None
    for key in sorted(main_shapes, key=lambda k: tuple(map(int,
                                                           k.split("x")))):
        n_limbs, n = (int(x) for x in key.split("x"))
        limbs = random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]  # separate tensors, as on the path
        line = kernel_line(CB, timer, limbs, timed=True)
        line["main_path_sets"] = main_shapes[key]
        line["ms_ring"] = timer.ring_ms(
            lambda: random_limbs(n_limbs, n, gen, dev), CB.hash_pairs,
            8 * n_limbs * n)
        traced = PR.profile_kernel(n_limbs, n, dev)
        line["traced_ms"] = traced["cold_median_ms"]
        line["traced_clean_ms"] = traced["cold_clean_median_ms"]
        line["from_list_ms"] = timer.cold_ms(
            lambda: HL.hash_limbs(listed, True))
        line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms_ring"]
        shape_rows.append(line)
        if (n_limbs, n) == MAIN_PATH_SHAPE:
            kernel_row = line
        print("[kernel main-path shape] hash_pairs " + json.dumps(line),
              flush=True)
        del limbs, listed
    check(kernel_row is not None, "q1's kernel shape was not launched")

    # both join sides in one launch, against two launches
    for shapes in JOIN_PAIRS:
        if not all(f"{l}x{n}" in main_shapes for l, n in shapes):
            continue

        def make():
            return [list(random_limbs(l, n, gen, dev)) for l, n in shapes]

        def two(sides):
            return [CB.hash_pairs(x) for x in sides]

        sides = make()
        name = " + ".join(f"L={l} n={n}" for l, n in shapes)
        check_hash(CB, sides, f"join pair {name}")
        traced = PR.trace_kernel(lambda: CB.hash_pairs_multi(sides), dev)
        in_bytes = sum(8 * l * n for l, n in shapes)
        line = {"sets": [{"L": l, "n": n} for l, n in shapes],
                "bit_identical": True,
                "bound_ms": hash_bytes(shapes) / H100_BYTES_PER_S * 1e3,
                "pair_ms": timer.cold_ms(lambda: CB.hash_pairs_multi(sides)),
                "pair_ms_ring": timer.ring_ms(make, CB.hash_pairs_multi,
                                              in_bytes),
                "pair_traced_ms": traced["cold_median_ms"],
                "pair_traced_clean_ms": traced["cold_clean_median_ms"],
                "two_launches_ms": timer.cold_ms(lambda: two(sides)),
                "two_launches_ms_ring": timer.ring_ms(make, two, in_bytes)}
        print("[kernel join pair] hash_pairs " + json.dumps(line),
              flush=True)

    # the wrappers' host time per call
    host = {}
    for n_limbs, n in ((1, 1 << 18), MAIN_PATH_SHAPE):
        limbs = random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]
        calls = {"from a list": lambda: CB.hash_pairs(listed),
                 "stacked": lambda: CB.hash_pairs(limbs)}
        if n_limbs == 1:
            calls["two sets"] = lambda: CB.hash_pairs_multi([listed, listed])
        host[f"{n_limbs}x{n}"] = {k: timer.host_us(f)
                                  for k, f in calls.items()}
        del limbs, listed
    print("[host us per call] " + json.dumps(host), flush=True)
    lap("kernel at the main path's shapes")

    kernels = [{
        "name": "hash_pairs", "route": "cuda",
        "source": "spark_rapids_tpu_torch/kernels/csrc/hash_pairs.cu",
        "replaces": "spark_rapids_tpu/kernels/pallas_backend.py:42",
        "launches": sum(c["hash_pairs_launches"] for c in
                        list(counts.values()) + list(var_counts.values())
                        + list(fb_counts.values()) + new_paths
                        + list(op_counts.values())
                        + list(str_counts.values())
                        + list(retry_counts.values())
                        + list(pump_counts.values())
                        + list(fault_counts.values())
                        + list(breadth_counts.values())
                        + list(decimal_counts.values())
                        + list(nested_counts.values())
                        + list(window_counts.values())
                        + list(udf_counts.values())
                        + list(io_counts.values())
                        + list(lake_counts.values())
                        + list(obs_counts.values())
                        + list(plane_counts.values())
                        + list(dist_counts.values())),
        "launches_per_query": {q: counts[q]["hash_pairs_launches"]
                               for q in QUERIES},
        "launches_per_variant": {v: c["hash_pairs_launches"]
                                 for v, c in var_counts.items()},
        "launches_per_fallback_case": {k: c["hash_pairs_launches"]
                                       for k, c in fb_counts.items()},
        "launches_per_partitions_query": {
            q: c["hash_pairs_launches"] for q, c in part_counts.items()},
        "launches_per_exchange_run": {
            k: c["hash_pairs_launches"] for k, c in ex_counts.items()},
        "launches_per_operators_path": {
            k: c["hash_pairs_launches"] for k, c in op_counts.items()},
        "launches_per_strings_run": {
            k: c["hash_pairs_launches"] for k, c in str_counts.items()},
        "launches_per_retry_run": {
            k: c["hash_pairs_launches"] for k, c in retry_counts.items()},
        "launches_per_pump_run": {
            k: c["hash_pairs_launches"] for k, c in pump_counts.items()},
        "launches_per_faults_run": {
            k: c["hash_pairs_launches"] for k, c in fault_counts.items()},
        "launches_per_breadth_run": {
            k: c["hash_pairs_launches"] for k, c in breadth_counts.items()},
        "launches_per_decimal_run": {
            k: c["hash_pairs_launches"] for k, c in decimal_counts.items()},
        "launches_per_nested_run": {
            k: c["hash_pairs_launches"] for k, c in nested_counts.items()},
        "launches_per_window_run": {
            k: c["hash_pairs_launches"] for k, c in window_counts.items()},
        "launches_per_udf_run": {
            k: c["hash_pairs_launches"] for k, c in udf_counts.items()},
        "launches_per_io_run": {
            k: c["hash_pairs_launches"] for k, c in io_counts.items()},
        "launches_per_lakehouse_run": {
            k: c["hash_pairs_launches"] for k, c in lake_counts.items()},
        "launches_per_observe_run": {
            k: c["hash_pairs_launches"] for k, c in obs_counts.items()},
        "launches_per_planes_run": {
            k: c["hash_pairs_launches"] for k, c in plane_counts.items()},
        "launches_per_distributed_run": {
            k: c["hash_pairs_launches"] for k, c in dist_counts.items()},
        "plain_calls_per_faults_run": {
            k: c.get("plain_calls", 0) for k, c in fault_counts.items()},
        "max_abs_err": 0.0,
        "ms": kernel_row["ms"], "ms_warm": kernel_row["ms_warm"],
        "ms_ring": kernel_row["ms_ring"],
        "traced_ms": kernel_row["traced_ms"],
        "traced_clean_ms": kernel_row["traced_clean_ms"],
        "from_list_ms": kernel_row["from_list_ms"],
        "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"], "bound_by": "bytes",
        "pct_of_bound": kernel_row["pct_of_bound"],
        "pct_of_bound_from": "ms_ring",
        "library_ms": None,
        "ptxas": ptxas,
        "shape": {"L": MAIN_PATH_SHAPE[0], "n": MAIN_PATH_SHAPE[1]},
        "main_path_shapes": shape_rows}]
    # no failure-domain activity outside [faults]
    end = RES.counters_snapshot()
    check(end == after_faults,
          f"failure-domain counters moved after [faults]: {end}")
    print("[phase seconds] " + json.dumps(laps), flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run() -> int:
    """``main`` with ``SESSION_CONF``'s black-box directory made before
    and removed after, and the cached region graphs dropped before the
    interpreter tears the device down."""
    import shutil
    import tempfile
    box = SESSION_CONF[BLACKBOX_KEY] = tempfile.mkdtemp(
        prefix="tpuq-blackbox-")
    try:
        return main()
    finally:
        shutil.rmtree(box, ignore_errors=True)
        if "spark_rapids_tpu_torch.exec.fused" in sys.modules:
            sys.modules["spark_rapids_tpu_torch.exec.fused"].clear_graphs()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        sys.exit(dist_child(sys.argv[2:]))
    sys.exit(run())
