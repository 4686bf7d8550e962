"""MULTITHREADED host-path shuffle: writer, reader, shuffle file layout.

[REF: sql-plugin/../RapidsShuffleInternalManagerBase.scala ::
 RapidsShuffleThreadedWriter/Reader, GpuShuffleEnv]

The counterpart of the JAX package's ``shuffle/manager.py``, with the
same file layout.  The map side writes one file per map partition:

  [u32 'TUDF'][u32 nparts]
  repeated per input batch:
    [i64 sizes[nparts]]  then the nparts tudo sections back to back

A reduce read seeks straight to its section in every map file (offsets
from the per-record size table), the local-filesystem analog of Spark's
IndexShuffleBlockResolver index.  Serialization rides the native tudo
library, threaded by ``spark.rapids.shuffle.multiThreaded.writer.threads``.
Shuffle files live in a temporary directory of the process, removed at
exit.  Serialization passes the ``shuffle_ser`` failure domain
(``runtime/resilience.py``), as in the JAX package, and the process
totals of the environment's byte counts are the registry's
``tpuq_shuffle_bytes_{written,read}_total``.
"""

from __future__ import annotations

import atexit
import os
import shutil
import struct
import tempfile
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.runtime import resilience as R
from spark_rapids_tpu_torch.runtime import telemetry as TM
from spark_rapids_tpu_torch.shuffle.serializer import (
    HostColView, deserialize, serialize_partitions)

_FILE_MAGIC = struct.pack("<I", 0x46445554)  # "TUDF"

# process-cumulative mirrors of the per-env metrics dict
_TM_SHUFFLE = {
    "bytesWritten": TM.REGISTRY.counter(
        "tpuq_shuffle_bytes_written_total",
        "host-shuffle bytes serialized to map files"),
    "bytesRead": TM.REGISTRY.counter(
        "tpuq_shuffle_bytes_read_total",
        "host-shuffle bytes fetched by reduce reads"),
}


class ShuffleEnv:
    """Process-wide shuffle workspace [REF: GpuShuffleEnv]."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.base_dir = tempfile.mkdtemp(prefix="tpuq-shuffle-")
        atexit.register(shutil.rmtree, self.base_dir, True)
        self._next_id = 0
        self._metrics_lock = threading.Lock()
        self.metrics = {"bytesWritten": 0, "bytesRead": 0}

    def add_metric(self, name: str, v: int) -> None:
        with self._metrics_lock:
            self.metrics[name] += v
        tm = _TM_SHUFFLE.get(name)
        if tm is not None:
            tm.inc(v)

    @classmethod
    def get(cls) -> "ShuffleEnv":
        with cls._lock:
            if cls._instance is None:
                cls._instance = ShuffleEnv()
            return cls._instance

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        os.makedirs(self.shuffle_dir(sid), exist_ok=True)
        return sid

    def shuffle_dir(self, shuffle_id: int) -> str:
        return os.path.join(self.base_dir, f"shuffle-{shuffle_id}")

    def map_file(self, shuffle_id: int, map_part: int) -> str:
        return os.path.join(self.shuffle_dir(shuffle_id),
                            f"map-{map_part}.tudo")

    def remove_shuffle(self, shuffle_id: int) -> None:
        shutil.rmtree(self.shuffle_dir(shuffle_id), ignore_errors=True)


class ShuffleWriter:
    """Writes one map partition's batches into its shuffle file."""

    def __init__(self, env: ShuffleEnv, shuffle_id: int, map_part: int,
                 nparts: int, nthreads: int):
        self.env = env
        self.path = env.map_file(shuffle_id, map_part)
        self.nparts = nparts
        self.nthreads = nthreads
        self._f = open(self.path, "wb")
        self._f.write(_FILE_MAGIC)
        self._f.write(struct.pack("<I", nparts))

    def write_batch(self, cols: Sequence[HostColView], pids: np.ndarray,
                    live: Optional[np.ndarray]) -> int:
        """Serialize one batch's rows into per-partition sections and
        append them as one record; returns the bytes written.

        Serialization passes the ``shuffle_ser`` failure domain: the
        sections are made (retryably: nothing is written until they
        are) before any byte reaches the map file, so a retried fault
        never leaves a partial record.  Not degradable: exhaustion is a
        domain-tagged terminal error."""
        def attempt():
            R.INJECTOR.on("shuffle_ser")
            # scratch=True: the sections are written to the map file
            # before this thread serializes its next batch
            return serialize_partitions(cols, pids, live, self.nparts,
                                        self.nthreads, scratch=True)

        sections = R.run_guarded("shuffle_ser", attempt,
                                 op="shuffle_serialize")
        sizes = np.array([len(s) for s in sections], np.int64)
        self._f.write(sizes.tobytes())
        for s in sections:
            self._f.write(s)
        written = int(sizes.sum()) + sizes.nbytes
        self.env.add_metric("bytesWritten", written)
        return written

    def close(self):
        self._f.close()


class ShuffleReader:
    """Reads one reduce partition's sections from every map file."""

    def __init__(self, env: ShuffleEnv, shuffle_id: int,
                 map_parts: Sequence[int], schema: T.StructType):
        self.env = env
        self.shuffle_id = shuffle_id
        self.map_parts = list(map_parts)
        self.schema = schema

    def read_partition(self, p: int) -> Iterator[tuple]:
        """Yields (nrows, host column views) per serialized record."""
        for m in self.map_parts:
            path = self.env.map_file(self.shuffle_id, m)
            with open(path, "rb") as f:
                if f.read(4) != _FILE_MAGIC:
                    raise ValueError(f"not a shuffle file: {path}")
                (nparts,) = struct.unpack("<I", f.read(4))
                while True:
                    size_tbl = f.read(8 * nparts)
                    if not size_tbl:
                        break
                    sizes = np.frombuffer(size_tbl, np.int64)
                    # seek directly to section p, skip the rest
                    f.seek(int(sizes[:p].sum()), os.SEEK_CUR)
                    buf = f.read(int(sizes[p]))
                    self.env.add_metric("bytesRead", len(buf))
                    f.seek(int(sizes[p + 1:].sum()), os.SEEK_CUR)
                    nrows, cols = deserialize(buf, self.schema)
                    if nrows:
                        yield nrows, cols
