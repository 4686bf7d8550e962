"""Input fingerprints — the bump chokepoint for the result cache.

The counterpart of the JAX package's ``cache/fingerprints.py``.  A
result key is only sound if every input relation contributes a
fingerprint that changes whenever its contents can have changed; this
module is the one place they are minted and bumped:

* in-memory tables — a content digest over the Arrow IPC stream,
  computed once per ``pa.Table`` object (id-keyed, weakref-cleaned) and
  re-minted when a table is re-registered under a catalog name;
* file scans — a digest over the sorted (path, size, mtime_ns) stat
  tuples, recomputed at every key derivation, so an in-place rewrite
  (an mtime bump) yields a fresh key without any registration step.
"""

from __future__ import annotations

import hashlib
import os
import threading
import weakref
from typing import Dict, Iterable, List, Set, Tuple

import pyarrow as pa

__all__ = ["table_fingerprint", "bump_table_fingerprint",
           "file_fingerprint", "relation_inputs", "physical_inputs",
           "reset"]

# id(table) -> (weakref to the table, fingerprint).  RLock: a weakref
# callback may fire on this thread mid-update when a gc cycle collects
# a dead table while the lock is held.
_lock = threading.RLock()
_table_fps: Dict[int, Tuple[weakref.ref, str]] = {}


def _content_fingerprint(table: pa.Table) -> str:
    """Digest of the canonical Arrow IPC serialization — stable across
    chunking and slicing layouts that a raw buffer walk would tell
    apart."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    h = hashlib.sha1()
    h.update(memoryview(sink.getvalue()))
    return "t" + h.hexdigest()[:15]


def _register(table: pa.Table, bump: bool) -> str:
    key = id(table)
    with _lock:
        ent = _table_fps.get(key)
        if ent is not None and ent[0]() is table and not bump:
            return ent[1]
    fp = _content_fingerprint(table)

    def _drop(ref, _key=key):
        with _lock:
            cur = _table_fps.get(_key)
            if cur is not None and cur[0] is ref:
                del _table_fps[_key]

    with _lock:
        _table_fps[key] = (weakref.ref(table, _drop), fp)
    return fp


def table_fingerprint(table: pa.Table) -> str:
    """Content fingerprint of a table, memoized per object identity."""
    return _register(table, bump=False)


def bump_table_fingerprint(table: pa.Table) -> str:
    """Re-mint the fingerprint (the re-registration chokepoint), called
    by ``TpuSession.registerTable`` when a name is re-bound."""
    return _register(table, bump=True)


def file_fingerprint(paths: Iterable[str]) -> str:
    """Stat digest over (path, size, mtime_ns) — raises ``OSError`` for
    a missing path; callers treat that as an unkeyable plan."""
    h = hashlib.sha1()
    for p in sorted(paths):
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    return "f" + h.hexdigest()[:15]


def relation_inputs(plan) -> Tuple[List[str], Set[str]]:
    """(input fingerprints, catalog source names) of a logical plan.

    In-memory relations carry their fingerprint on the node (assigned
    here); file relations are re-statted at every call, so staleness is
    caught at lookup time."""
    from spark_rapids_tpu_torch.plan.logical import (
        InMemoryRelation, ParquetRelation)

    fps: List[str] = []
    sources: Set[str] = set()

    def walk(n) -> None:
        if isinstance(n, InMemoryRelation):
            fp = n.fingerprint
            if fp is None:
                fp = table_fingerprint(n.table)
                n.fingerprint = fp
            fps.append(fp)
            if n.source:
                sources.add(n.source)
        elif isinstance(n, ParquetRelation):
            fps.append(file_fingerprint(list(n.paths)))
        for c in n.children:
            walk(c)

    walk(plan)
    return fps, sources


def physical_inputs(node) -> List[str]:
    """Input fingerprints of a physical subtree (subplan keys): scan
    execs hold either a ``.table`` (in memory) or ``.paths`` (files)."""
    fps: List[str] = []

    def walk(n) -> None:
        t = getattr(n, "table", None)
        if isinstance(t, pa.Table):
            fps.append(table_fingerprint(t))
        paths = getattr(n, "paths", None)
        if isinstance(paths, (list, tuple)) and paths and all(
                isinstance(p, str) for p in paths):
            fps.append(file_fingerprint(list(paths)))
        for c in n.children:
            walk(c)

    walk(node)
    return fps


def reset() -> None:
    """Clear the registry (tests)."""
    with _lock:
        _table_fps.clear()
