"""The string expressions of ``ops/strings.py`` (``Like``,
``StringPredicate``, ``Substring``) against the JAX package's, and the
API that reaches them (``!=``, ``like``, ``substr``/``substring``,
``startswith``/``endswith``/``contains``, ``distinct``).

Both packages evaluate on one batch built from the same buffers: a
padded ``uint8[B, W]`` byte matrix (W = 16) of seeded numpy strings over
a small alphabet that holds ``%``, ``_`` and a backslash, with nulls,
empty strings and strings exactly W bytes long, plus dead padding rows.
Data, validity, lengths and the output width must be equal exactly, on
every row.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import column as JC  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import strings as JS  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import strings as S  # noqa: E402
from spark_rapids_tpu_torch.plan import analysis as AN  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import UExpr, col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 16
N = 700  # live rows; the batch holds 1024
CAP = 1024
ALPHABET = np.frombuffer(b"abcab%_\\", np.uint8)


def _strings(seed=41):
    """(matrix, lengths, validity) of N live rows and CAP - N dead ones."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, W + 1, CAP).astype(np.int32)
    lengths[rng.random(CAP) < 0.15] = W  # exactly the padded width
    lengths[rng.random(CAP) < 0.1] = 0  # empty strings
    mat = ALPHABET[rng.integers(0, len(ALPHABET), (CAP, W))]
    # a few rows spell the patterns out, so that long ones match too
    mat[:40, :] = np.frombuffer(b"abcabcabcabcabca", np.uint8)
    mat[40:60, :8] = np.frombuffer(b"ab%c_\\ab", np.uint8)
    validity = rng.random(CAP) >= 0.1
    lengths[N:] = 0  # dead rows are empty
    lengths[~validity] = 0
    mat = np.where(np.arange(W)[None, :] < lengths[:, None], mat,
                   0).astype(np.uint8)
    return mat, lengths, validity


@pytest.fixture(scope="module")
def batches():
    mat, lengths, validity = _strings()
    sel = np.arange(CAP) < N
    jb = JC.DeviceBatch(
        JT.StructType((JT.StructField("s", JT.StringT),)),
        (JC.DeviceColumn(JT.StringT, jnp.asarray(mat),
                         jnp.asarray(validity), jnp.asarray(lengths)),),
        jnp.asarray(sel))
    pb = from_numpy_batch(T.StructType((T.StructField("s", T.StringT),)),
                          [(mat, validity, lengths)], sel, "cpu")
    return jb, pb


def _check(jexpr, pexpr, batches):
    jb, pb = batches
    jc = jexpr.eval_tpu(jb)
    pc = pexpr.eval(pb)
    assert pexpr.dtype.simple_name == jexpr.dtype.simple_name
    jd, pd = np.asarray(jc.data), pc.data.numpy()
    assert pd.shape == jd.shape  # the output width included
    assert pd.dtype == jd.dtype
    np.testing.assert_array_equal(pd, jd)
    assert (pc.validity is None) == (jc.validity is None)
    if jc.validity is not None:
        np.testing.assert_array_equal(pc.validity.numpy(),
                                      np.asarray(jc.validity))
    assert (pc.lengths is None) == (jc.lengths is None)
    if jc.lengths is not None:
        np.testing.assert_array_equal(pc.lengths.numpy(),
                                      np.asarray(jc.lengths))
    return pd


def _ref():
    return (JE.BoundReference(0, JT.StringT),
            E.BoundReference(0, T.StringT))


LIKE_PATTERNS = [
    "%", "%%", "", "abc", "abcabcabcabcabca",  # whole string, W bytes
    "ab%", "%ab", "%ab%", "%b%a%", "a%c", "ab%ca%", "%a%b%c%a%",
    "_", "_%", "%_", "_bc%", "a_c%", "ab_%", "%ab_", "%a_c%", "___",
    "a__a%", "________________", "%\\%%", "%\\_%", "ab\\%c%", "\\%",
    "%\\\\%", "a" * 20 + "%", "%" + "b" * 17, "%" + "abca" * 5 + "%",
    "ab%%ca", "%ca", "abcabcabcabcabc_", "%abcabcabcabcabca",
]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_matches_jax(batches, pattern):
    jr, pr = _ref()
    got = _check(JS.Like(jr, pattern), S.Like(pr, pattern), batches)
    # the data holds matches and misses alike for the usual patterns
    if pattern in ("%ab%", "ab%", "%\\%%"):
        assert 0 < got[:N].sum() < N


PREDICATES = [(op, pat) for op in ("startswith", "endswith", "contains")
              for pat in ("", "a", "ab", "%_", "cab", "\\", "bcabca",
                          "abcabcabcabcabca", "abcabcabcabcabcab")]


@pytest.mark.parametrize("op,pattern", PREDICATES)
def test_string_predicate_matches_jax(batches, op, pattern):
    jr, pr = _ref()
    _check(JS.StringPredicate(op, jr, JE.Literal(pattern, JT.StringT)),
           S.StringPredicate(op, pr, E.Literal(pattern, T.StringT)),
           batches)


SUBSTRINGS = [(1, 2), (3, 4), (0, 3), (1, W), (2, 100), (W, 2), (W + 3, 2),
              (5, 0), (2, -1), (-1, 1), (-2, 5), (-W, 3), (-W - 5, 4),
              (0, 0), (7, 9)]


@pytest.mark.parametrize("pos,length", SUBSTRINGS)
def test_substring_matches_jax(batches, pos, length):
    jr, pr = _ref()
    _check(JS.Substring(jr, pos, length), S.Substring(pr, pos, length),
           batches)


def test_pattern_must_be_a_literal(batches):
    _, pb = batches
    expr = S.StringPredicate("contains", _ref()[1], _ref()[1])
    with pytest.raises(NotImplementedError, match="literal pattern"):
        expr.eval(pb)


def test_analyzer_string_errors():
    schema = T.StructType((T.StructField("s", T.StringT),
                           T.StructField("i", T.IntegerT)))
    with pytest.raises(AN.AnalysisException, match="like needs a string"):
        AN.resolve(col("i").like("1%")._u, schema)
    # split and get_json_object resolve since the nested slice (host
    # only); a python UDF resolves only as a top-level select expression
    # and a window function only under ``.over`` at a select's top level
    # (elsewhere the JAX package's analyzer refuses them too);
    # input_file_name() is a marker the optimizer binds to a file scan
    for op in ("sha2", "initcap", "translate"):
        with pytest.raises(NotImplementedError, match=f"'{op}'"):
            AN.resolve(UExpr(op, "x", (UExpr("attr", "s"),)), schema)
    with pytest.raises(AN.AnalysisException,
                       match="only supported as top-level select"):
        AN.resolve(UExpr("pyudf", "x", (UExpr("attr", "s"),)), schema)
    assert isinstance(AN.resolve(UExpr("input_file_name", None), schema),
                      E.InputFileName)
    with pytest.raises(AN.AnalysisException,
                       match="unknown expression op 'winfn'"):
        AN.resolve(UExpr("winfn", ("row_number",)), schema)
    assert type(AN.resolve(UExpr("split", (",", -1), (
        UExpr("attr", "s"),)), schema)).__name__ == "Split"
    assert type(AN.resolve(UExpr("get_json_object", "$.a", (
        UExpr("attr", "s"),)), schema)).__name__ == "GetJsonObject"
    assert isinstance(AN.resolve((col("s") != "a")._u, schema), E.Not)


def _api_table(seed=43):
    rng = np.random.default_rng(seed)
    words = np.array(["", "ab", "abc", "b%c", "zz_top", "PROMO BRUSHED",
                      "forest green", "31-555", "13-021", None], object)
    return pa.table({
        "s": pa.array(list(rng.choice(words, 300))),
        "k": pa.array(rng.integers(0, 4, 300).astype(np.int32)),
    })


API_CASES = {
    "ne_filter": lambda c, F: ([c("s") != "ab"], None, None),
    "not_like": lambda c, F: ([~c("s").like("%b%")], None, None),
    "substr": lambda c, F: (None, [c("s").substr(2, 3).alias("x"),
                                   F.substring(c("s"), -2, 5).alias("y")],
                            None),
    "predicates": lambda c, F: (None, [
        c("s").startswith("ab").alias("a"),
        c("s").endswith("c").alias("b"),
        c("s").contains("re").alias("d")], None),
    "distinct": lambda c, F: (None, ["s"], "distinct"),
    "distinct_two": lambda c, F: (None, ["k", F.substring(
        c("s"), 1, 2).alias("cc")], "distinct"),
}


@pytest.mark.parametrize("case", list(API_CASES))
def test_api_matches_jax(case):
    t = _api_table()

    def run(session, c, fns):
        filters, cols, tail = API_CASES[case](c, fns)
        df = session.createDataFrame(t)
        for f in filters or []:
            df = df.filter(f)
        if cols is not None:
            df = df.select(*cols)
        if tail == "distinct":
            df = df.distinct()
        return df.toArrow()

    want = run(JaxSession(), jcol, JF)
    got = run(TpuSession(device="cpu"), col, F)
    assert got.num_rows > 0
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=0.0)
