"""Session entry point — ``TpuSession``.

The counterpart of the JAX package's ``sql/session.py``:
``TpuSession(conf)`` validates the ``spark.rapids.*`` conf once and
``createDataFrame(pa.Table)`` returns a DataFrame over an in-memory
relation of ``spark.default.parallelism`` partitions (a struct column
split into one column per field, ``_decompose_structs``), and
``range(start, end, step, numPartitions)`` a DataFrame of generated ids
(made on the device, no host data); ``read`` returns the
DataFrameReader of ``io/readers.py``.  The port's
session also carries the device its queries run
on: the CUDA card unless the caller asks for ``device="cpu"``; a
missing card raises here, at creation.  Creation installs the shape
plane's policy, the kernel plane's policy and the persistent kernel
cache from the conf, in the JAX package's order; ``warmup(plans)``
drains plans outside ``toArrow`` so that the kernels they need are
built now (and, with ``spark.rapids.tpu.kernel.cacheDir``, kept for
later processes).  Creation also turns on the lock-order watchdog when
``spark.rapids.tpu.lockdep.enabled`` asks for it.

The query lifecycle: ``cancel(query_id)`` stops an in-flight query
(``runtime/cancel.py``), ``active_queries()`` lists them, and
``query_history(n)`` returns the event-log entries the executions left
(the JAX package's: plan, metrics, fallback report, attribution,
telemetry deltas and health verdicts, semaphore window, resilience
rollup, stats, artifact links).  ``last_query_profile()`` is the stats
plane's record of the latest query run with
``spark.rapids.tpu.stats.enabled`` (None before one), and
``metrics_report()`` the process registry's snapshot with the recent
health events.  Creation starts the telemetry sampler when
``spark.rapids.tpu.telemetry.enabled`` asks for it.

The conf surface is the JAX package's: ``session.conf`` is a
``RuntimeConf`` (``set``, ``get``, ``unset``, ``snapshot``) whose
validated snapshot every query plans with (``rapids_conf()``), and
``TpuSession.builder.config(key, value).getOrCreate()`` builds a
session (with ``device=`` beside the conf).  The catalog
(``registerTable``, ``table``) is the result cache's fingerprint-bump
chokepoint for in-memory inputs; ``invalidate_cache`` and
``cache_stats`` reach the process's result cache (``cache/``), which
creation configures from the conf; ``stop`` does nothing, as in the
JAX package.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Dict, Iterable, List, Optional

import pyarrow as pa

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.runtime.device import resolve_device


class RuntimeConf:
    """Mutable session conf view (the ``spark.conf`` analog).  Values are
    validated when a snapshot is taken: a query plans with
    ``snapshot()``, which raises on an unknown ``spark.rapids.*`` key or
    a value its entry rejects."""

    def __init__(self, raw: Dict[str, Any]):
        self._raw = dict(raw)
        self._snap: Optional[RapidsConf] = None

    def set(self, key: str, value) -> None:
        self._raw[str(key)] = value
        self._snap = None

    def get(self, key: str, default=None):
        return self._raw.get(key, default)

    def unset(self, key: str) -> None:
        self._raw.pop(key, None)
        self._snap = None

    def snapshot(self) -> RapidsConf:
        snap = self._snap
        if snap is None:
            snap = self._snap = RapidsConf(self._raw)
        return snap


class TpuSessionBuilder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}
        self._device = "cuda"

    def config(self, key=None, value=None, conf: Optional[Dict] = None,
               device=None) -> "TpuSessionBuilder":
        if conf:
            self._conf.update(conf)
        if key is not None:
            self._conf[key] = value
        if device is not None:
            self._device = device
        return self

    def getOrCreate(self) -> "TpuSession":
        return TpuSession(self._conf, device=self._device)


class _BuilderDescriptor:
    """Class-level ``TpuSession.builder`` (the SparkSession.builder
    idiom): a fresh builder at every access."""

    def __get__(self, obj, objtype=None) -> TpuSessionBuilder:
        return TpuSessionBuilder()


# Decomposed-table memo: a table with struct columns becomes a new
# table at every createDataFrame, and the device scan cache keys on table
# identity, so the split is kept per source table (entries die with it)
# and repeated queries over one table hit the cache.
_decomposed: dict = {}


def _decompose_structs(table: pa.Table):
    """Split Arrow STRUCT columns into one physical column per field
    (``s.a``, ``s.b``, plus ``s#null`` when the struct has nulls) — the
    struct-of-arrays data model of the JAX package's
    ``_decompose_structs``: every exec sees plain columns, the DataFrame
    layer keeps the logical view (``StructSpec``) and ``toArrow``
    reassembles.  One level of nesting only.  Returns (table, {struct
    name: StructSpec})."""
    if not any(pa.types.is_struct(f.type) for f in table.schema):
        return table, {}
    hit = _decomposed.get(id(table))
    if hit is not None:
        return hit
    from spark_rapids_tpu_torch.sql.dataframe import StructSpec
    arrays, names = [], []
    structs: Dict[str, object] = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if not pa.types.is_struct(t):
            arrays.append(col)
            names.append(name)
            continue
        if any(pa.types.is_struct(t.field(i).type)
               or pa.types.is_map(t.field(i).type)
               for i in range(t.num_fields)):
            raise NotImplementedError(
                f"struct column {name!r}: nested struct/map fields are "
                "not supported yet (one level of struct nesting)")
        arr = col.combine_chunks()
        null_col = None
        if arr.null_count > 0:
            null_col = f"{name}#null"
            arrays.append(pa.chunked_array([arr.is_null()]))
            names.append(null_col)
        flat = arr.flatten()  # the parent's nulls applied to the fields
        fields = []
        for i in range(t.num_fields):
            pname = f"{name}.{t.field(i).name}"
            arrays.append(flat[i])
            names.append(pname)
            fields.append((t.field(i).name, pname))
        structs[name] = StructSpec(fields, null_col)
    out = (pa.table(dict(zip(names, arrays))), structs)
    try:
        weakref.finalize(table, _decomposed.pop, id(table), None)
    except TypeError:
        return out
    _decomposed[id(table)] = out
    return out


class TpuSession:
    builder = _BuilderDescriptor()

    QUERY_HISTORY_CAP = 256

    def __init__(self, conf: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self.conf = RuntimeConf(conf or {})
        self._conf = self.conf.snapshot()  # validated at creation
        self.device = resolve_device(device)
        # multi-executor mode (spark.rapids.executor.count > 1) joins the
        # process group first [REF: RapidsExecutorPlugin.init]; the
        # context may move this process to a card of its own
        from spark_rapids_tpu_torch.parallel.executor import init_executor
        ctx = init_executor(self._conf, device)
        if ctx is not None:
            self.device = ctx.device
        self._query_history: List[Dict[str, Any]] = []
        # the stats plane's record of the latest stats-enabled query
        self._last_profile: Optional[Dict[str, Any]] = None
        # continuous telemetry: the background sampler when
        # spark.rapids.tpu.telemetry.enabled (the registry always updates)
        from spark_rapids_tpu_torch.runtime import telemetry
        telemetry.configure_sampler(self._conf)
        # conf-gated lock-order watchdog (spark.rapids.tpu.lockdep.*)
        from spark_rapids_tpu_torch.runtime import lockdep
        lockdep.configure(self._conf)
        # shape plane: batch-shape bucketing for every exec pump
        # (spark.rapids.tpu.kernel.bucketing/bucketLadder/maxPadFraction)
        from spark_rapids_tpu_torch.runtime import shapes
        shapes.configure(self._conf)
        # kernel plane: the prefetching pump (spark.rapids.tpu.exec.pumpDepth)
        from spark_rapids_tpu_torch import kernels
        kernels.configure(self._conf)
        # persistent cache of built kernel libraries
        # (spark.rapids.tpu.kernel.cacheDir; none on the CPU)
        from spark_rapids_tpu_torch.runtime import kernel_cache
        kernel_cache.configure_persistent_cache(self._conf, self.device)
        # result-cache plane (spark.rapids.tpu.cache.*): host-resident
        # plan-signature result cache served ahead of the pump
        from spark_rapids_tpu_torch import cache as cache_mod
        cache_mod.configure(self._conf)
        # name -> (table, structs, fingerprint): the catalog behind
        # registerTable()/table(), mutated only through registerTable
        self._catalog: Dict[str, Any] = {}

    def rapids_conf(self) -> RapidsConf:
        return self.conf.snapshot()

    def stop(self) -> None:
        """Nothing to release (the JAX package's ``stop`` is a no-op)."""

    # -- catalog + result cache ---------------------------------------------
    def registerTable(self, name: str, data) -> "DataFrame":
        """Register (or re-register) a named table in the session
        catalog.  This is the fingerprint-bump chokepoint for in-memory
        inputs: re-registering a name re-mints the content digest and
        drops every cached result that read the old version, so a
        refreshed table never serves stale hits."""
        from spark_rapids_tpu_torch import cache as cache_mod
        from spark_rapids_tpu_torch.cache import fingerprints
        if not isinstance(data, pa.Table):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: registerTable takes a "
                "pyarrow.Table")
        table, structs = _decompose_structs(data)
        rebind = name in self._catalog
        fp = (fingerprints.bump_table_fingerprint(table) if rebind
              else fingerprints.table_fingerprint(table))
        self._catalog[name] = (table, structs, fp)
        if rebind:
            store = cache_mod.peek_cache()
            if store is not None:
                store.invalidate(source=name)
        return self.table(name)

    def table(self, name: str) -> "DataFrame":
        """A DataFrame over a catalog table registered with
        ``registerTable``: its relation carries the content
        fingerprint, so results derived from it are cache-keyed."""
        from spark_rapids_tpu_torch.plan.logical import InMemoryRelation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        if name not in self._catalog:
            raise KeyError(f"table {name!r} is not registered")
        table, structs, fp = self._catalog[name]
        st = T.StructType(tuple(
            T.StructField(n, T.from_arrow(table.schema.field(n).type))
            for n in table.column_names))
        rel = InMemoryRelation(table, st, self._parallelism(),
                               fingerprint=fp, source=name)
        return DataFrame(self, rel, structs)

    def invalidate_cache(self, name: Optional[str] = None, *,
                         signature: Optional[str] = None,
                         fingerprint: Optional[str] = None) -> int:
        """Explicitly drop cached results: by catalog ``name``, plan
        ``signature``, input ``fingerprint``, or — with no arguments —
        everything.  Returns the number of entries dropped."""
        from spark_rapids_tpu_torch import cache as cache_mod
        store = cache_mod.peek_cache()
        if store is None:
            return 0
        if name is None and signature is None and fingerprint is None:
            return store.invalidate(everything=True)
        return store.invalidate(source=name, signature=signature,
                                fingerprint=fingerprint)

    def cache_stats(self) -> Dict[str, Any]:
        """Result-cache observability: counts, hit rate, resident
        bytes, device seconds avoided, and a per-signature breakdown
        (the numbers ``profile top --cache`` reports)."""
        from spark_rapids_tpu_torch import cache as cache_mod
        from spark_rapids_tpu_torch import conf as C
        store = cache_mod.peek_cache()
        # the store is a process singleton: THIS session's conf decides
        # whether its queries take part
        if store is None or not self.rapids_conf().get(C.CACHE_ENABLED):
            return {"enabled": False}
        return {"enabled": True, **store.stats()}

    # -- observability ------------------------------------------------------
    def _record_query(self, entry: Dict[str, Any]) -> None:
        self._query_history.append(entry)
        if len(self._query_history) > self.QUERY_HISTORY_CAP:
            del self._query_history[:-self.QUERY_HISTORY_CAP]

    def query_history(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Entries of the queries this session executed, oldest first;
        ``n`` keeps the most recent n."""
        h = self._query_history
        return list(h[-n:] if n else h)

    def last_query_profile(self) -> Optional[Dict[str, Any]]:
        """The stats plane's profile of the most recent query run with
        ``spark.rapids.tpu.stats.enabled``: the record
        ``df.explain("analyze")`` renders and the profile store keeps —
        per-operator rows/batches/bytes, batch-shape histograms,
        per-partition exchange counts with skew factors, and traced
        self/total time when tracing was on.  None until a query has
        run with stats collection."""
        return self._last_profile

    def metrics_report(self) -> Dict[str, Any]:
        """Point-in-time process telemetry: every registry counter and
        gauge value and histogram summary (what the JSONL sink and the
        Prometheus dump export), plus the recent health WARN events."""
        from spark_rapids_tpu_torch.runtime import telemetry
        telemetry.ensure_producers()
        return {"ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                "metrics": telemetry.REGISTRY.snapshot(),
                "health": telemetry.REGISTRY.recent_health()}

    # -- query lifecycle ----------------------------------------------------
    def active_queries(self) -> List[int]:
        """Ids of the queries executing now (cancellable)."""
        from spark_rapids_tpu_torch.runtime import cancel
        return cancel.active_queries()

    def cancel(self, query_id: Optional[int] = None,
               reason: str = "user") -> bool:
        """Cancel an in-flight query: every blocking boundary of its
        execution raises ``QueryCancelled`` within ~2x
        ``spark.rapids.tpu.query.cancelPollMs`` and the query's
        resources are reclaimed.  With no ``query_id``, cancels the
        oldest active query.  False when nothing matched."""
        from spark_rapids_tpu_torch.runtime import cancel
        if query_id is None:
            active = cancel.active_queries()
            if not active:
                return False
            query_id = active[0]
        return cancel.cancel_query(query_id, reason=reason)

    def createDataFrame(self, data) -> "DataFrame":
        from spark_rapids_tpu_torch.plan.logical import InMemoryRelation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        if not isinstance(data, pa.Table):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: createDataFrame takes a "
                "pyarrow.Table")
        data, structs = _decompose_structs(data)
        st = T.StructType(tuple(
            T.StructField(n, T.from_arrow(data.schema.field(n).type))
            for n in data.column_names))
        # in-memory tables slice into spark.default.parallelism scan
        # partitions (a raw key, as in the JAX package)
        return DataFrame(self, InMemoryRelation(data, st,
                                                self._parallelism()),
                         structs)

    def _parallelism(self) -> int:
        # spark.default.parallelism is a raw key, as in the JAX package
        return int(self.conf.get("spark.default.parallelism", 1))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              numPartitions: Optional[int] = None) -> "DataFrame":
        """One non-null ``id`` column: ``start, start + step, ...`` below
        ``end`` (above it for a negative step); ``range(n)`` is
        ``range(0, n)``.  [REF: basicPhysicalOperators.scala ::
        GpuRangeExec]"""
        from spark_rapids_tpu_torch.plan.logical import Range
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        if end is None:
            start, end = 0, start
        schema = T.StructType((T.StructField("id", T.LongT, False),))
        return DataFrame(self, Range(int(start), int(end), int(step),
                                     schema,
                                     numPartitions or self._parallelism()))

    @property
    def read(self):
        """The DataFrameReader: parquet and orc files as a file relation,
        text, csv and json read on the host (``io/readers.py``)."""
        from spark_rapids_tpu_torch.io.readers import DataFrameReader
        return DataFrameReader(self)

    def warmup(self, plans: Iterable[Any]) -> Dict[str, Any]:
        """Build the kernels a set of plans will need.

        ``plans`` is an iterable of DataFrames (or callables taking this
        session and returning one).  Each plan is planned and every
        partition drained through the full exec pipeline, outside
        ``toArrow``; the results are discarded.  With
        ``spark.rapids.tpu.kernel.cacheDir`` set, what is built lands in
        the cache for later processes.

        Returns ``{"plans", "compiles", "compile_seconds", "wall_s"}``:
        a compile is a library build in this process.
        """
        from spark_rapids_tpu_torch.runtime import kernel_cache
        t0 = time.perf_counter()
        c0, s0 = kernel_cache.compile_snapshot()
        count = 0
        for p in plans:
            df = p(self) if callable(p) else p
            plan = df._execute_plan()
            for part in range(plan.num_partitions()):
                for _ in plan.execute(part):
                    pass
            count += 1
        c1, s1 = kernel_cache.compile_snapshot()
        return {"plans": count,
                "compiles": c1 - c0,
                "compile_seconds": round(s1 - s0, 6),
                "wall_s": round(time.perf_counter() - t0, 6)}
