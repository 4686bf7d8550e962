"""Session entry point — ``TpuSession``.

The counterpart of the JAX package's ``sql/session.py``:
``TpuSession(conf)`` validates the ``spark.rapids.*`` conf once and
``createDataFrame(pa.Table)`` returns a DataFrame over an in-memory
relation of ``spark.default.parallelism`` partitions, and
``range(start, end, step, numPartitions)`` a DataFrame of generated ids
(made on the device, no host data).  The port's
session also carries the device its queries run
on: the CUDA card unless the caller asks for ``device="cpu"``; a
missing card raises here, at creation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import pyarrow as pa

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.runtime.device import resolve_device


class TpuSession:
    def __init__(self, conf: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self._conf = RapidsConf(conf)
        self.device = resolve_device(device)

    def rapids_conf(self) -> RapidsConf:
        return self._conf

    def createDataFrame(self, data) -> "DataFrame":
        from spark_rapids_tpu_torch.plan.logical import InMemoryRelation
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        if not isinstance(data, pa.Table):
            raise NotImplementedError(
                "spark_rapids_tpu_torch: createDataFrame takes a "
                "pyarrow.Table")
        st = T.StructType(tuple(
            T.StructField(n, T.from_arrow(data.schema.field(n).type))
            for n in data.column_names))
        # in-memory tables slice into spark.default.parallelism scan
        # partitions (a raw key, as in the JAX package)
        return DataFrame(self, InMemoryRelation(data, st,
                                                self._parallelism()))

    def _parallelism(self) -> int:
        # spark.default.parallelism is a raw key, as in the JAX package
        return int(self._conf.get_raw("spark.default.parallelism", 1))

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
