"""Datetime expressions — the calendar fields of a date (year, month,
day of month), ``date_add``, ``date_sub`` and ``datediff``.

[REF: sql-plugin/../datetimeExpressions.scala]

The counterpart of the JAX package's ``ops/datetime_ops.py``
(``civil_from_days``, ``_DateField``, ``Year``, ``Month``,
``DayOfMonth``, ``DateAdd``, ``DateSub``, ``DateDiff``): dates are int32 days
since the epoch, timestamps int64 microseconds since the epoch (UTC),
and the calendar decomposition is the integer-only civil calendar
algorithm.  Every division is a floor division: a truncating one would
give wrong fields for days before 1970.  ``eval_cpu`` is the JAX
package's numpy twin (``np_civil_from_days``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.host import HostCol
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops.expressions import (
    Expression, merge_validity, merge_validity_h)

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


def np_civil_from_days(z: np.ndarray):
    """The JAX package's ``civil_from_days`` with ``xp=np``."""
    z = z.astype(np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + np.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y.astype(np.int32), m.astype(np.int32), d.astype(np.int32)


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

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        days = c.data
        if isinstance(self.child.dtype, T.TimestampType):
            # floor to days (micros may be negative)
            days = np.where(days >= 0, days // MICROS_PER_DAY,
                            -((-days + MICROS_PER_DAY - 1)
                              // MICROS_PER_DAY))
        parts = np_civil_from_days(days)
        return HostCol(self.dtype, parts[self.FIELD], c.validity)


class Year(_DateField):
    FIELD = 0


class Month(_DateField):
    FIELD = 1


class DayOfMonth(_DateField):
    FIELD = 2


@dataclasses.dataclass
class _DayShift(Expression):
    """``date ± days`` -> date, in int64 then narrowed to int32 days (an
    overflow wraps, as in the JAX package)."""

    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.DateType)

    SIGN = 1

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        data = (l.data.to(torch.int64)
                + self.SIGN * r.data.to(torch.int64)).to(torch.int32)
        return DeviceColumn(self.dtype, data,
                            merge_validity(l.validity, r.validity))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        data = (l.data.astype(np.int64)
                + self.SIGN * r.data.astype(np.int64)).astype(np.int32)
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


class DateAdd(_DayShift):
    """date_add(start, days) -> date."""

    SIGN = 1


class DateSub(_DayShift):
    """date_sub(start, days) -> date."""

    SIGN = -1


@dataclasses.dataclass
class DateDiff(Expression):
    """datediff(end, start) -> int days."""

    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.IntegerType)

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        return DeviceColumn(self.dtype, (l.data - r.data).to(torch.int32),
                            merge_validity(l.validity, r.validity))

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        return HostCol(self.dtype, (l.data - r.data).astype(np.int32),
                       merge_validity_h(l.validity, r.validity))


# -- TypeSig declarations (the JAX package's, see expressions.py) ----------
for _cls in (Year, Month, DayOfMonth):
    _cls.type_sig = E.SIG_INTEGRAL
    _cls.input_sig = E.SIG_DATETIME
for _cls in (DateAdd, DateSub):
    _cls.type_sig = E.SIG_DATETIME
    _cls.input_sig = E.SIG_DATETIME | E.SIG_INTEGRAL
DateDiff.type_sig = E.SIG_INTEGRAL
DateDiff.input_sig = E.SIG_DATETIME
