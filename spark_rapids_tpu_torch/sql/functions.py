"""pyspark.sql.functions-compatible surface — the subset of the port
(``col``, ``lit``, ``when``, ``coalesce``, the math, date, time-zone,
hash and string functions, ``split``, ``get_json_object``, ``struct``,
the generators ``explode``, ``explode_outer``, ``posexplode`` and
``posexplode_outer``, the aggregates ``sum``, ``avg``/``mean``,
``min``, ``max``, ``count``, ``first``, the variance family,
``collect_list``, ``collect_set``, the percentiles, ``countDistinct``
and ``approx_count_distinct``, and the window functions ``row_number``,
``rank``, ``dense_rank``, ``ntile``, ``percent_rank``, ``cume_dist``,
``lag`` and ``lead``), the python UDFs ``udf``, ``pandas_udf`` and
``device_udf``, and ``input_file_name``, with the JAX package's
signatures."""

from __future__ import annotations

from spark_rapids_tpu_torch.sql.column import Column, UExpr, _to_uexpr, col, lit  # noqa: F401


def _cu(c) -> UExpr:
    """Function-argument conversion: bare strings are column names
    (pyspark.sql.functions semantics), everything else like _to_uexpr."""
    if isinstance(c, str):
        return UExpr("attr", c)
    return _to_uexpr(c)


def _agg(op):
    def fn(c) -> Column:
        return Column(UExpr("agg", op, (_cu(c),)))
    fn.__name__ = op
    return fn


sum = _agg("sum")  # noqa: A001
min = _agg("min")  # noqa: A001
max = _agg("max")  # noqa: A001
avg = _agg("avg")
mean = _agg("avg")
first = _agg("first")
var_samp = _agg("var_samp")
var_pop = _agg("var_pop")
stddev_samp = _agg("stddev_samp")
stddev_pop = _agg("stddev_pop")
variance = var_samp
stddev = stddev_samp
collect_list = _agg("collect_list")
collect_set = _agg("collect_set")


def count(c) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(UExpr("agg", "count_star", (UExpr("lit", 1),)))
    return Column(UExpr("agg", "count", (_cu(c),)))


def countDistinct(c) -> Column:
    return Column(UExpr("agg", "count_distinct", (_cu(c),)))


count_distinct = countDistinct


def approx_count_distinct(c, rsd: float = 0.05) -> Column:
    """Exact, through the count(DISTINCT) rewrite: an exact count is
    within any ``rsd``.  [REF: GpuApproximateCountDistinct]"""
    if not (0.0 <= float(rsd) < 1.0):
        raise ValueError(f"rsd must be in [0, 1), got {rsd}")
    return countDistinct(c)


def percentile(c, pct: float) -> Column:
    return Column(UExpr("agg", ("percentile", float(pct)), (_cu(c),)))


def percentile_approx(c, pct: float, accuracy: int = 10000) -> Column:
    return Column(UExpr("agg", ("approx_percentile", float(pct),
                                int(accuracy)), (_cu(c),)))


approx_percentile = percentile_approx


def when(cond: Column, value) -> Column:
    return Column(UExpr("casewhen", None,
                        (_to_uexpr(cond), _to_uexpr(value))))


def _unary(op):
    def fn(c) -> Column:
        return Column(UExpr(op, None, (_cu(c),)))
    fn.__name__ = op
    return fn


def from_utc_timestamp(c, tz: str) -> Column:
    return Column(UExpr("from_utc_timestamp", tz, (_cu(c),)))


def to_utc_timestamp(c, tz: str) -> Column:
    return Column(UExpr("to_utc_timestamp", tz, (_cu(c),)))


def _binary(op):
    def fn(a, b) -> Column:
        return Column(UExpr(op, None, (_cu(a), _cu(b))))
    fn.__name__ = op
    return fn


sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("log")
abs = _unary("abs")  # noqa: A001
floor = _unary("floor")
ceil = _unary("ceil")
isnan = _unary("isnan")
year = _unary("year")
month = _unary("month")
dayofmonth = _unary("dayofmonth")
upper = _unary("upper")
lower = _unary("lower")
length = _unary("length")
trim = _unary("trim")
ltrim = _unary("ltrim")
rtrim = _unary("rtrim")
reverse = _unary("reverse")


pow = _binary("pow")  # noqa: A001
date_add = _binary("date_add")
date_sub = _binary("date_sub")
datediff = _binary("datediff")


def round(c, scale=0) -> Column:  # noqa: A001
    return Column(UExpr("round", scale, (_cu(c),)))


def coalesce(*cols) -> Column:
    return Column(UExpr("coalesce", None, tuple(_cu(c) for c in cols)))


def hash(*cols) -> Column:  # noqa: A001
    """Spark murmur3 hash (seed 42) -> int."""
    return Column(UExpr("hash", None, tuple(_cu(c) for c in cols)))


def xxhash64(*cols) -> Column:
    """Spark xxhash64 (seed 42) -> long."""
    return Column(UExpr("xxhash64", None, tuple(_cu(c) for c in cols)))


def substring(c, pos, length) -> Column:
    return Column(UExpr("substring", (pos, length), (_cu(c),)))


def concat(*cols) -> Column:
    return Column(UExpr("concat", None, tuple(_cu(c) for c in cols)))


def rlike(c, pattern: str) -> Column:
    return Column(UExpr("rlike", pattern, (_cu(c),)))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    return Column(UExpr("regexp_extract", (pattern, idx), (_cu(c),)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return Column(UExpr("regexp_replace", (pattern, replacement),
                        (_cu(c),)))


def lpad(c, length: int, pad: str = " ") -> Column:
    return Column(UExpr("lpad", (length, pad), (_cu(c),)))


def rpad(c, length: int, pad: str = " ") -> Column:
    return Column(UExpr("rpad", (length, pad), (_cu(c),)))


def replace(c, search: str, replacement: str) -> Column:
    """replace(str, search, replace) with a literal search and
    replacement."""
    return Column(UExpr("replace", (search, replacement), (_cu(c),)))


def instr(c, substr: str) -> Column:
    """1-based position of the first occurrence; 0 if absent."""
    return Column(UExpr("locate", 1, (UExpr("lit", substr), _cu(c))))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(UExpr("locate", pos, (UExpr("lit", substr), _cu(c))))


def split(c, pattern: str, limit: int = -1) -> Column:
    return Column(UExpr("split", (pattern, limit), (_cu(c),)))


def get_json_object(c, path: str) -> Column:
    """Extract a JSON path from a JSON string column (evaluated on the
    host, as in the JAX package)."""
    return Column(UExpr("get_json_object", path, (_cu(c),)))


def struct(*cols) -> Column:
    """A STRUCT column [REF: complexTypeCreator CreateStruct]: the
    DataFrame layer stores it as one column per field (the field names
    from an alias, a column's last dotted part, else ``col<i>``)."""
    names = []
    kids = []
    for i, c in enumerate(cols):
        if isinstance(c, str):
            names.append(c.split(".")[-1])
            kids.append(UExpr("attr", c))
            continue
        u = _cu(c)
        if u.op == "alias":
            names.append(u.payload)
        elif u.op == "attr":
            names.append(str(u.payload).split(".")[-1])
        else:
            names.append(f"col{i + 1}")
        kids.append(u.children[0] if u.op == "alias" else u)
    return Column(UExpr("make_struct", tuple(names), tuple(kids)))


# generators: payload (with_pos, outer)

def explode(c) -> Column:
    return Column(UExpr("generate", (False, False), (_cu(c),)))


def explode_outer(c) -> Column:
    return Column(UExpr("generate", (False, True), (_cu(c),)))


def posexplode(c) -> Column:
    return Column(UExpr("generate", (True, False), (_cu(c),)))


def posexplode_outer(c) -> Column:
    return Column(UExpr("generate", (True, True), (_cu(c),)))


# window functions (``.over(spec)``) --------------------------------------

def row_number() -> Column:
    return Column(UExpr("winfn", ("row_number",)))


def rank() -> Column:
    return Column(UExpr("winfn", ("rank",)))


def dense_rank() -> Column:
    return Column(UExpr("winfn", ("dense_rank",)))


def lag(c, offset: int = 1, default=None,
        ignorenulls: bool = False) -> Column:
    if default is not None:
        raise NotImplementedError("lag default value not supported")
    return Column(UExpr("winfn", ("lag", offset, ignorenulls), (_cu(c),)))


def lead(c, offset: int = 1, default=None,
         ignorenulls: bool = False) -> Column:
    if default is not None:
        raise NotImplementedError("lead default value not supported")
    return Column(UExpr("winfn", ("lead", offset, ignorenulls), (_cu(c),)))


def ntile(n: int) -> Column:
    return Column(UExpr("winfn", ("ntile", int(n))))


def percent_rank() -> Column:
    return Column(UExpr("winfn", ("percent_rank",)))


def cume_dist() -> Column:
    return Column(UExpr("winfn", ("cume_dist",)))


# python UDFs ---------------------------------------------------------------

def _make_udf(f, returnType, vectorized: bool):
    from spark_rapids_tpu_torch.plan.analysis import _parse_type
    dt = _parse_type(returnType)

    def call(*cols) -> Column:
        name = getattr(f, "__name__", "udf")
        return Column(UExpr("pyudf", (f, dt, vectorized, name),
                            tuple(_cu(c) for c in cols)))

    call.__name__ = getattr(f, "__name__", "udf")
    return call


def device_udf(f=None, returnType="double"):
    """Columnar device UDF [REF: spark-rapids RapidsUDF]: ``f`` receives
    the argument columns' raw tensors on the batch's device and returns
    the result tensor; it runs with the surrounding expressions (no host
    round trip).  Also usable as ``@device_udf(returnType=...)``.
    Numeric, boolean and datetime columns; nulls propagate as the
    intersection of the inputs' validities."""
    from spark_rapids_tpu_torch.plan.analysis import _parse_type

    def make(fn):
        dt = _parse_type(returnType)

        def call(*cols) -> Column:
            name = getattr(fn, "__name__", "device_udf")
            return Column(UExpr("device_udf", (fn, dt, name),
                                tuple(_cu(c) for c in cols)))

        call.__name__ = getattr(fn, "__name__", "device_udf")
        return call

    if f is None or not callable(f):
        if f is not None:
            returnType = f
        return make
    return make(f)


def udf(f=None, returnType="string"):
    """Row-at-a-time python UDF (also usable as ``@udf(returnType=...)``):
    runs on the host over the arrow bridge, its arguments computed on
    the device [REF: GpuRowBasedScalaUDF analog]."""
    if f is None or not callable(f):
        rt = returnType if f is None else f
        return lambda fn: _make_udf(fn, rt, False)
    return _make_udf(f, returnType, False)


def pandas_udf(f=None, returnType="double"):
    """Vectorized pandas UDF (Series -> Series; a scalar per group under
    ``groupBy(...).agg``)."""
    if f is None or not callable(f):
        rt = returnType if f is None else f
        return lambda fn: _make_udf(fn, rt, True)
    return _make_udf(f, returnType, True)


def input_file_name() -> Column:
    """File path of the current row's source file (file scans only)."""
    return Column(UExpr("input_file_name", None))
