"""The port's regex engine (``ops/regex_device.py``) and the regex
expressions (``RLike``, ``RegexpExtract``, ``RegexpReplace``), against the
JAX package's.

* ``compile_regex`` gives the JAX package's ``table``, ``accept`` and
  flags, array for array, over a corpus of supported, rejected,
  anchored, alternating, counted and class patterns (the JAX package's
  ``tests/test_regex_strings.py`` corpus among them), and ``None`` where
  it gives ``None``.
* ``match_lens``, ``extract_first`` and ``replace_all`` equal the JAX
  package's results in both branches: numpy against its numpy branch,
  torch (on CPU tensors) against its numpy branch on every pattern and
  against its jnp branch on the slice's and the anchored ones, on a seeded
  ``uint8[1024, 16]`` matrix whose strings hold line terminators and the
  UTF-8 bytes of the Unicode ones.
* ``check_regex_supported`` raises where the JAX package raises, with
  its message; the analyzer's ``rlike`` transpiles a simple pattern to
  the same tree of comparisons and predicates.
* The expressions equal the JAX package's on both branches, and the
  phone-code report and the comment search equal its session's rows and
  fallback reports through the API.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.runtime.device import ensure_initialized

ensure_initialized()

import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import dtypes as JT  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import regex_device as JRX  # noqa: E402
from spark_rapids_tpu.ops import strings as JS  # noqa: E402
from spark_rapids_tpu.plan import analysis as JAN  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.exec import basic as B  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import regex_device as RX  # noqa: E402
from spark_rapids_tpu_torch.ops import strings as S  # noqa: E402
from spark_rapids_tpu_torch.plan import analysis as AN  # noqa: E402
from spark_rapids_tpu_torch.runtime import memory as M  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402
from spark_rapids_tpu_torch.utils import tpch  # noqa: E402

from tests.test_torch_string_ops import (  # noqa: E402
    CAP, W, both_batches, check_device, check_host, string_rows)

CORPUS = [
    # the JAX package's corpus
    r"abc", r"^abc", r"abc$", r"^abc$", r"a.c", r"[a-z]+", r"\d+",
    r"\d{3}-\d{4}", r"(ab)+c", r"a|bc|def", r"[^0-9]+", r"\w+@\w+\.com",
    r"x(yz)?w", r"a{2,3}b", r"(?:ab|cd)+", r"colou?r", r".*xyz",
    r"h.llo$", r"^[A-Z][a-z]*", r"\s+", r"[abc]{2}", r"a\.b",
    r"a+?", r"(a)\1", r"(?=x)y", r"\bword\b",
    # anchors, alternation, counts, classes, escapes, the slice's own
    r"^(1[3-9]|2[0-9])-[0-9]{3}-[0-9]{4}$", r"special.*requests",
    r"[aeiou]+", r"[a-z]+$", r"a[b0-9]$", r"^abc|def", r"\x41", r"a{0}",
    r"a{,3}", r"a{3,1}", r"a{65}", r"[]a]", r"[a-]", r"[\d\s]+",
    r"[^\n]*", r"\t\n\r\f", r"é", r"a**", r"(?i)abc", r"a*", r"^$",
    r"(a|b)*c{1,2}", r"\.\*\+", r"[A-Za-z0-9_]{1,16}", r".{10,}",
    r"(ab|a)(bc|c)", r"x*y*z*", r"[[]", r"\p{L}", r"a++", r"(a",
    r"((((a))))+", r"[0-9]{64}", r"(a|b|c|d|e|f|g|h){8}[a-h]{8}",
]
ALPHABET = list("abcdexyz0123456789 .-@_ABC\n\r")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The batches are small (1024 rows): torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def regex_rows(seed=5, n=CAP, width=W):
    """Strings of at most ``width`` bytes over ``ALPHABET``, with final
    line terminators (\\n, \\r\\n, \\r, U+0085, U+2028, U+2029) on some
    rows and a few fixed ones that the corpus matches."""
    rng = np.random.default_rng(seed)
    fixed = ["abc", "abc\n", "abc\r\n", "abc\r", "ab\u0085", "ab\u2028",
             "ab\u2029", "ab\u2028\u2028", "colour vs color", "h2llo",
             "mail@host.com", "555-1234 x", "13-555-1234", "31-100-1000",
             "special requests", "xspecialyrequest", "Abc def", "a0\n",
             "a9\r\n", "aabbc", "x%y_z", None, ""]
    terms = ["\n", "\r\n", "\r", "\u0085", "\u2028", "\u2029"]
    out = []
    for i in range(n):
        if i < len(fixed):
            out.append(fixed[i])
            continue
        if rng.random() < 0.05:
            out.append(None)
            continue
        s = "".join(rng.choice(ALPHABET, rng.integers(0, width + 1)))
        if rng.random() < 0.2:
            s = s[:width - 3] + terms[rng.integers(0, len(terms))]
        out.append(s.encode()[:width].decode("utf-8", "ignore"))
    return out


@pytest.fixture(scope="module")
def batches():
    return both_batches({"s": regex_rows(), "s2": string_rows(43)})


@pytest.mark.parametrize("pattern", CORPUS)
def test_compile_regex_equals_jax(pattern):
    got, want = RX.compile_regex(pattern), JRX.compile_regex(pattern)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.table.dtype == want.table.dtype == np.int32
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accept, want.accept)
    for f in ("start_state", "anchored_start", "anchored_end",
              "has_alternation", "matches_empty", "pattern"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.table.shape[0] <= RX.MAX_DFA_STATES + 1


def test_corpus_covers_both_outcomes():
    compiled = [RX.compile_regex(p) is not None for p in CORPUS]
    assert 20 < sum(compiled) < len(CORPUS) - 10


SIM_PATTERNS = [p for p in CORPUS if JRX.compile_regex(p) is not None]


def _port_sim(fn, mat, lengths, rx, xp, *extra):
    if xp is np:
        return fn(mat, lengths, rx, *extra, np) if extra else fn(
            mat, lengths, rx, np)
    args = (torch.from_numpy(mat), torch.from_numpy(lengths), rx)
    out = fn(*args, *extra, torch) if extra else fn(*args, torch)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


# the JAX package's jnp branch compiles per pattern (~1.7 s each), so the
# torch branch meets it on these, and its numpy branch on every pattern
JNP_PATTERNS = [r"^abc", r"a|bc|def",
                r"^(1[3-9]|2[0-9])-[0-9]{3}-[0-9]{4}$", r"[a-z]+$",
                r"special.*requests"]
SIM_CASES = ([(p, "numpy", "numpy") for p in SIM_PATTERNS]
             + [(p, "torch", "numpy") for p in SIM_PATTERNS]
             + [(p, "torch", "jnp") for p in JNP_PATTERNS])


@pytest.mark.parametrize("pattern, branch, jax_branch", SIM_CASES)
def test_simulation_equals_jax(batches, pattern, branch, jax_branch):
    """match_lens, match_any, extract_first and (for the patterns the
    replace accepts) replace_all, every array exactly."""
    _, pb, _, _ = batches
    c = pb.columns[0]
    mat, lengths = c.data.numpy(), c.lengths.numpy()
    rx, jrx = RX.compile_regex(pattern), JRX.compile_regex(pattern)
    xp = np if branch == "numpy" else torch
    jxp = np if jax_branch == "numpy" else jnp
    jm, jl = (mat, lengths) if jxp is np else (jnp.asarray(mat),
                                             jnp.asarray(lengths))

    def same(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    same(_port_sim(RX.match_lens, mat, lengths, rx, xp),
         JRX.match_lens(jm, jl, jrx, jxp))
    same(_port_sim(RX.match_any, mat, lengths, rx, xp),
         JRX.match_any(jm, jl, jrx, jxp))
    for g, w in zip(_port_sim(RX.extract_first, mat, lengths, rx, xp),
                    JRX.extract_first(jm, jl, jrx, jxp)):
        same(g, w)
    if not (rx.matches_empty or rx.has_alternation):
        for repl in (b"", b"#", b"XYZ"):
            for g, w in zip(
                    _port_sim(RX.replace_all, mat, lengths, rx, xp, repl),
                    JRX.replace_all(jm, jl, jrx, repl, jxp)):
                same(g, w)


CHECK_PATTERNS = [r"a*+b", r"x++", r"\p{L}", r"\P{Lu}+", r"[*+]",
                  r"\*+", r"a{2}+", r"(a", r"[a-", r"ok.*", r"a?+",
                  r"[\p{L}]", r"\\p"]


@pytest.mark.parametrize("pattern", CHECK_PATTERNS)
def test_check_regex_supported_raises_where_jax_raises(pattern):
    try:
        JS.check_regex_supported(pattern)
        want = None
    except JAN.AnalysisException as e:
        want = str(e)
    if want is None:
        S.check_regex_supported(pattern)
        return
    with pytest.raises(AN.AnalysisException) as got:
        S.check_regex_supported(pattern)
    assert str(got.value) == want


def _tree(e):
    """A package-independent spelling of a resolved expression tree."""
    kids = ", ".join(_tree(c) for c in e.children)
    if type(e).__name__ == "Literal":
        return f"Literal({e.value!r})"
    extra = getattr(e, "op", None) or getattr(e, "pattern", None) or ""
    return f"{type(e).__name__}[{extra}]({kids})"


SIMPLE = ["abc", "^abc", "abc$", "^abc$", "", "^", "$", "^$", "a b",
          "ab\\$", "a.c", "é$", "^a|b", "a$b"]


@pytest.mark.parametrize("pattern", SIMPLE)
def test_rlike_transpile_equals_jax(pattern):
    """A simple pattern becomes the JAX package's comparison or
    predicate (a ``$`` the OR over the six line terminators); the rest
    becomes ``RLike``."""
    schema = T.StructType((T.StructField("s", T.StringT),))
    jschema = JT.StructType((JT.StructField("s", JT.StringT),))
    got = AN.resolve(col("s").rlike(pattern)._u, schema)
    want = JAN.resolve(jcol("s").rlike(pattern)._u, jschema)
    assert _tree(got) == _tree(want)
    assert S.regex_as_simple(pattern) == JS.regex_as_simple(pattern)


def test_analyzer_regex_errors():
    schema = T.StructType((T.StructField("s", T.StringT),
                           T.StructField("i", T.IntegerT)))
    with pytest.raises(AN.AnalysisException, match="rlike needs a string"):
        AN.resolve(col("i").rlike("a")._u, schema)
    with pytest.raises(AN.AnalysisException, match="Java-only"):
        AN.resolve(F.regexp_extract(col("s"), "a*+", 0)._u, schema)
    with pytest.raises(AN.AnalysisException, match="Java-only"):
        AN.resolve(F.regexp_replace(col("s"), r"\p{L}", "")._u, schema)


def _regex_cases():
    cases = {}
    for p in (r"\d+", r"[a-z]+$", r"^abc", r"a[b0-9]$", r"(a)\1",
              r"colou?r", r"a|bc|def", r"ab$", r".*"):
        cases[f"rlike_{p!r}"] = (
            lambda E_, S_, T_, p=p: S_.RLike(E_.BoundReference(0, T_.StringT),
                                             p))
    for p, idx in ((r"\d+", 0), (r"[a-z]+@[a-z]+", 0), (r"c[a-z]*r", 0),
                   (r"x.z", 0), (r"(\d+)-(\d+)", 2), (r"a|bc", 0),
                   (r"[a-z]+$", 0)):
        cases[f"extract_{p!r}_{idx}"] = (
            lambda E_, S_, T_, p=p, idx=idx: S_.RegexpExtract(
                E_.BoundReference(0, T_.StringT), p, idx))
    for p, r in ((r"\d+", "#"), (r"[aeiou]", ""), (r"ab+", "AB"),
                 (r"\s+", "_"), (r"(\d+)", "<$1>"), (r"[aeiou]+", ""),
                 (r"a*", "-"), (r"b|c", "x"), (r"\d", "\\$"),
                 (r"[a-z]", "é")):
        cases[f"replace_{p!r}_{r!r}"] = (
            lambda E_, S_, T_, p=p, r=r: S_.RegexpReplace(
                E_.BoundReference(0, T_.StringT), p, r))
    return cases


CASES = _regex_cases()


@pytest.mark.parametrize("case", list(CASES))
def test_regex_expressions_equal_jax(batches, case):
    """The device branch where the DFA takes the pattern (eval against
    eval_tpu), and eval_cpu always; the tag reason is the JAX
    package's."""
    jb, pb, jh, ph = batches
    je, pe = CASES[case](JE, JS, JT), CASES[case](E, S, T)
    reason = pe.device_support_reason(None)
    assert reason == je.device_support_reason(None)
    if reason is None:
        check_device(je, pe, jb, pb)
    check_host(je, pe, jh, ph)


def test_dollar_matches_java_before_final_terminators():
    """Java's ``$`` under find matches before a final \\n, \\r\\n, \\r,
    U+0085, U+2028 or U+2029, never between the \\r and \\n of a final
    CRLF: the DFA's end mask and the simple-pattern OR give Java's
    answers, hard-coded, on the device branch."""
    strs = ["ab", "ab\u0085", "ab\u2028", "ab\u2029", "ab\u0085x",
            "ab\u2028\u2028", "ab\r\n", "ab\n", "ab\r", "ab\n\n", "a\rb"]
    java = [True, True, True, True, False, False, True, True, True, False,
            False]
    t = pa.table({"s": pa.array(strs)})
    session = TpuSession({"spark.rapids.sql.test.enabled": True},
                         device="cpu")
    for pattern in ("ab$", "a[b]$"):
        out = session.createDataFrame(t).select(
            F.rlike(col("s"), pattern).alias("m")).toArrow()
        assert out.column("m").to_pylist() == java, pattern


# -- the phone-code report and the comment search through the API -------------

PHONE = "^(1[3-9]|2[0-9])-[0-9]{3}-[0-9]{4}$"


def phone_report(c, F_, t):
    return t["customer"].filter(c("c_phone").rlike(PHONE)).groupBy(
        F_.substring(c("c_phone"), 1, 2).cast("int").alias("cc")).agg(
        F_.count("*").alias("n"), F_.sum(c("c_acctbal")).alias("bal"))


def comment_search(c, F_, t):
    return t["orders"].filter(c("o_comment").rlike("special.*requests"))\
        .groupBy("o_orderpriority").agg(
            F_.sum(F_.length(c("o_comment"))).alias("comment_bytes"))


def comment_rows(c, F_, t):
    return t["orders"].filter(c("o_comment").rlike("special.*requests"))\
        .select("o_orderkey")


API_CASES = {"phone_report": phone_report, "comment_search": comment_search,
             "comment_rows": comment_rows}


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_tpch(0.002)


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


@pytest.mark.parametrize("case", list(API_CASES))
def test_api_matches_jax(tables, case):
    """The JAX session's rows and fallback report, line for line, with 0
    fallback operators: the patterns run the DFA on the device."""
    build = API_CASES[case]
    conf = {"spark.rapids.sql.test.enabled": True}
    jdf = build(jcol, JF, {k: JaxSession(dict(conf)).createDataFrame(v)
                           for k, v in tables.items()
                           if k in ("customer", "orders")})
    want = jdf.toArrow()
    df = build(col, F, {k: TpuSession(dict(conf), device="cpu")
                        .createDataFrame(v) for k, v in tables.items()
                        if k in ("customer", "orders")})
    got = df.toArrow()
    assert got.schema == want.schema
    if case == "comment_rows":
        assert got.equals(want)
    else:
        assert bench._rows_equal(got, want, tol=1e-6)
    assert got.num_rows > 0
    assert df.fallback_summary() == jdf.fallback_summary()
    assert df.fallback_summary()["fallback_ops"] == 0
    if case == "comment_rows":
        like = tables["orders"].filter(
            bench_like(tables["orders"]["o_comment"]))
        assert sorted(got.column("o_orderkey").to_pylist()) == sorted(
            like.column("o_orderkey").to_pylist())


def bench_like(column):
    """q13's ``like('%special%requests%')`` in pyarrow."""
    import pyarrow.compute as pc
    return pc.match_like(column, "%special%requests%")
