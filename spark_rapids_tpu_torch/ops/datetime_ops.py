"""Datetime expressions — the calendar year of a date.

[REF: sql-plugin/../datetimeExpressions.scala]

The counterpart of the JAX package's ``ops/datetime_ops.py``
(``civil_from_days``, ``_DateField``, ``Year``): dates are int32 days
since the epoch, timestamps int64 microseconds since the epoch (UTC),
and the calendar decomposition is the integer-only civil calendar
algorithm.  Every division is a floor division: a truncating one would
give wrong fields for days before 1970.
"""

from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops.expressions import Expression

MICROS_PER_DAY = 86_400_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days since the epoch -> (year, month, day) as int32 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


@dataclasses.dataclass
class _DateField(Expression):
    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.IntegerType)

    FIELD = 0  # 0 = year, 1 = month, 2 = day

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        days = c.data
        if isinstance(self.child.dtype, T.TimestampType):
            days = _fdiv(days, MICROS_PER_DAY)  # floor: micros may be < 0
        parts = civil_from_days(days)
        return DeviceColumn(self.dtype, parts[self.FIELD], c.validity)


class Year(_DateField):
    FIELD = 0
