"""The string expressions of ``ops/strings.py`` past the LIKE slice
(``Length``, ``Upper``/``Lower``, ``Trim``, ``StringLocate``,
``StringReplace``, ``Concat``, ``StringReverse``, ``StringPad``) against
the JAX package's, and the part-catalogue queries that reach them
through the API, with and without ``incompatibleOps``.

Both packages evaluate one batch built from the same seeded buffers: a
padded ``uint8[B, W]`` byte matrix (W = 16, 1024 rows of which 700 are
live) of strings drawn from words that hold spaces, upper and lower
case, ``%`` and multi-byte UTF-8, with nulls, empty strings and strings
exactly W bytes long.  On the device branch (the port's ``eval`` on CPU
tensors against the JAX package's ``eval_tpu``) data, validity, lengths
and the output width must be equal exactly, on every row; on the host
branch (``eval_cpu`` over the live rows as host strings) data and
validity.
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
from spark_rapids_tpu.columnar import host as JH  # noqa: E402
from spark_rapids_tpu.ops import expressions as JE  # noqa: E402
from spark_rapids_tpu.ops import strings as JS  # noqa: E402
from spark_rapids_tpu.sql import functions as JF  # noqa: E402
from spark_rapids_tpu.sql.column import col as jcol  # noqa: E402
from spark_rapids_tpu.sql.session import TpuSession as JaxSession  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as T  # noqa: E402
from spark_rapids_tpu_torch.columnar import host as H  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import from_numpy_batch  # noqa: E402
from spark_rapids_tpu_torch.exec import basic as B  # noqa: E402
from spark_rapids_tpu_torch.ops import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.ops import strings as S  # noqa: E402
from spark_rapids_tpu_torch.runtime import memory as M  # noqa: E402
from spark_rapids_tpu_torch.sql import functions as F  # noqa: E402
from spark_rapids_tpu_torch.sql.column import col  # noqa: E402
from spark_rapids_tpu_torch.sql.session import TpuSession  # noqa: E402
from spark_rapids_tpu_torch.utils import tpch  # noqa: E402

W = 16
N = 700  # live rows; the batch holds 1024
CAP = 1024
WORDS = ["a", "b", "ab", "aa", " ", "  ", "BRASS", "green", "é", "日本",
         "x%", "Cu", "0", "-", "\t", "Zz"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The batches are small (1024 rows): torch's intra-op threads only
    oversubscribe the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def string_rows(seed: int, n: int = CAP, width: int = W):
    """``n`` Python strings of at most ``width`` UTF-8 bytes (None for a
    null): words joined at random, some exactly ``width`` bytes long,
    some empty."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.08:
            out.append(None)
            continue
        if r < 0.16:
            out.append("")
            continue
        s = ""
        for _ in range(rng.integers(1, 8)):
            w = WORDS[rng.integers(0, len(WORDS))]
            if len((s + w).encode()) > width:
                break
            s += w
        if r > 0.85:  # exactly the padded width
            s = (s + "a" * width).encode()[:width].decode("utf-8", "ignore")
            s = s + "a" * (width - len(s.encode()))
        out.append(s)
    return out


def matrix(strings, width: int = W):
    """(uint8[n, width], int32 lengths, bool validity) of the strings."""
    n = len(strings)
    mat = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    validity = np.array([s is not None for s in strings])
    for i, s in enumerate(strings):
        if s:
            b = s.encode()
            mat[i, :len(b)] = np.frombuffer(b, np.uint8)
            lengths[i] = len(b)
    return mat, lengths, validity


def both_batches(columns):
    """The JAX package's and the port's device batch over string columns
    ``{name: strings}`` (rows past N are dead), and both host batches of
    the N live rows."""
    sel = np.arange(CAP) < N
    jfields, pfields, jcols, pcols = [], [], [], []
    for name, strings in columns.items():
        # dead rows: empty and valid
        mat, lengths, validity = matrix(strings[:N] + [""] * (CAP - N))
        jfields.append(JT.StructField(name, JT.StringT))
        pfields.append(T.StructField(name, T.StringT))
        jcols.append(JC.DeviceColumn(JT.StringT, jnp.asarray(mat),
                                     jnp.asarray(validity),
                                     jnp.asarray(lengths)))
        pcols.append((mat, validity, lengths))
    jb = JC.DeviceBatch(JT.StructType(tuple(jfields)), tuple(jcols),
                        jnp.asarray(sel))
    pb = from_numpy_batch(T.StructType(tuple(pfields)), pcols, sel, "cpu")
    t = pa.table({name: pa.array(strings[:N], pa.string())
                  for name, strings in columns.items()})
    return jb, pb, JH.from_arrow_table(t), H.from_arrow_table(t)


@pytest.fixture(scope="module")
def batches():
    return both_batches({"s": string_rows(41), "s2": string_rows(42)})


def check_device(jexpr, pexpr, jb, pb):
    """The port's ``eval`` equals the JAX package's ``eval_tpu``: data,
    validity, lengths and the output width, exactly."""
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
        assert pc.lengths.numpy().dtype == np.asarray(jc.lengths).dtype
        np.testing.assert_array_equal(pc.lengths.numpy(),
                                      np.asarray(jc.lengths))
    return pd


def check_host(jexpr, pexpr, jh, ph):
    """The port's ``eval_cpu`` equals the JAX package's: data (dtype and
    values; numbers bit for bit, NaN included) and validity."""
    jc = jexpr.eval_cpu(jh)
    pc = pexpr.eval_cpu(ph)
    jd, pd = np.asarray(jc.data), np.asarray(pc.data)
    assert pd.dtype == jd.dtype and pd.shape == jd.shape
    if pd.dtype == object:
        assert pd.tolist() == jd.tolist()
    else:
        assert pd.tobytes() == jd.tobytes()
    assert (pc.validity is None) == (jc.validity is None)
    if jc.validity is not None:
        np.testing.assert_array_equal(pc.validity, jc.validity)


def _s(E_, T_, i=0):
    return E_.BoundReference(i, T_.StringT)


def _lit(E_, T_, v):
    return E_.Literal(v, T_.StringT)


def _cases():
    """name -> builder(E, S, T) of the same expression in a package."""
    cases = {
        "length": lambda E_, S_, T_: S_.Length(_s(E_, T_)),
        "upper": lambda E_, S_, T_: S_.Upper(_s(E_, T_)),
        "lower": lambda E_, S_, T_: S_.Lower(_s(E_, T_)),
        "reverse": lambda E_, S_, T_: S_.StringReverse(_s(E_, T_)),
        "concat_three": lambda E_, S_, T_: S_.Concat(
            [_s(E_, T_), _lit(E_, T_, "/"), _s(E_, T_, 1)]),
        "concat_one": lambda E_, S_, T_: S_.Concat([_s(E_, T_, 1)]),
        "concat_null_literal": lambda E_, S_, T_: S_.Concat(
            [_s(E_, T_), _lit(E_, T_, None)]),
        "concat_utf8_literal": lambda E_, S_, T_: S_.Concat(
            [_lit(E_, T_, "été-"), _s(E_, T_)]),
    }
    for side in ("both", "leading", "trailing"):
        cases[f"trim_{side}"] = (
            lambda E_, S_, T_, side=side: S_.Trim(_s(E_, T_), side))
    for sub, pos in (("a", 1), ("ab", 1), ("ab", 3), ("", 1), ("", 5),
                     ("", W + 2), ("é", 1), ("BRASS", 2), ("a", 0),
                     ("a", W + 1), ("z" * (W + 2), 1), ("aaaa", 1)):
        cases[f"locate_{sub!r}_{pos}"] = (
            lambda E_, S_, T_, sub=sub, pos=pos: S_.StringLocate(
                _lit(E_, T_, sub), _s(E_, T_), pos))
    for search, repl in (("a", "XY"), ("ab", ""), ("aa", "b"), (" ", "_"),
                         ("BRASS", "Cu-Zn"), ("é", "e"), ("", "x"),
                         ("z" * (W + 1), "q"), ("a", "abcdefgh"),
                         ("aaaa", "A"), ("日本", "JP")):
        cases[f"replace_{search!r}_{repl!r}"] = (
            lambda E_, S_, T_, search=search, repl=repl: S_.StringReplace(
                _s(E_, T_), search, repl))
    for target, pad in ((6, "*"), (6, "-+"), (3, "#"), (5, ""), (0, "x"),
                        (W + 4, "ab"), (-2, "y"), (W, " ")):
        for left in (True, False):
            cases[f"{'l' if left else 'r'}pad_{target}_{pad!r}"] = (
                lambda E_, S_, T_, target=target, pad=pad, left=left:
                S_.StringPad(_s(E_, T_), target, pad, left))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_device_branch_equals_jax(batches, case):
    jb, pb, _, _ = batches
    got = check_device(CASES[case](JE, JS, JT), CASES[case](E, S, T),
                       jb, pb)
    assert got.shape[0] == CAP


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cpu_equals_jax(batches, case):
    _, _, jh, ph = batches
    check_host(CASES[case](JE, JS, JT), CASES[case](E, S, T), jh, ph)


def test_the_data_exercises_the_edges(batches):
    """Nulls, empty strings, W-byte strings and multi-byte UTF-8 are all
    in the live rows."""
    _, pb, _, ph = batches
    c = pb.columns[0]
    live = np.arange(CAP) < N
    lengths = c.lengths.numpy()[live]
    assert (~c.validity.numpy()[live]).sum() > 20
    assert ((lengths == 0) & c.validity.numpy()[live]).sum() > 20
    assert (lengths == W).sum() > 20
    assert sum(1 for s in ph.columns[0].data
               if s is not None and len(s.encode()) > len(s)) > 20


def test_string_unary_builds_the_classes():
    ref = _s(E, T)
    assert isinstance(S.string_unary("length", ref), S.Length)
    assert isinstance(S.string_unary("upper", ref), S.Upper)
    assert isinstance(S.string_unary("lower", ref), S.Lower)
    with pytest.raises(ValueError):
        S.string_unary("initcap", ref)


def test_locate_needs_a_literal(batches):
    _, pb, _, _ = batches
    with pytest.raises(NotImplementedError, match="literal substr"):
        S.StringLocate(_s(E, T, 1), _s(E, T), 1).eval(pb)


NEW_CLASSES = ["Length", "Upper", "Lower", "Trim", "StringLocate",
               "StringReplace", "Concat", "StringReverse", "StringPad",
               "RLike", "RegexpExtract", "RegexpReplace"]


@pytest.mark.parametrize("name", NEW_CLASSES)
def test_each_new_class_is_a_kill_switch(name):
    """``spark.rapids.sql.expression.<Name>`` names every class the slice
    adds, and its incompat declaration is the JAX package's."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    conf = RapidsConf({f"spark.rapids.sql.expression.{name}": "false"})
    assert conf.is_op_enabled("expression", name) is False
    assert getattr(getattr(S, name), "incompat", None) == getattr(
        getattr(JS, name), "incompat", None)
    assert getattr(S, name).type_sig == getattr(JS, name).type_sig


def test_gate_confs_equal_jax():
    """The two gates carry the JAX package's docs and defaults."""
    from spark_rapids_tpu import conf as JC_
    from spark_rapids_tpu_torch import conf as C
    for key in ("spark.rapids.sql.incompatibleOps.enabled",
                "spark.rapids.sql.castStringToFloat.enabled"):
        got, want = C.REGISTRY[key], JC_.REGISTRY.entries[key]
        assert (got.doc, got.default) == (want.doc, want.default) == (
            want.doc, False)
        assert C.RapidsConf({key: "true"}).get(got) is True


# -- the part-catalogue queries through the API ------------------------------

INCOMPAT = {"spark.rapids.sql.incompatibleOps.enabled": True}


def catalogue(c, F_, part):
    """The part-catalogue cleanup: ten string expressions, sorted by
    p_partkey."""
    return part.select(
        c("p_partkey"),
        F_.lower(c("p_type")).alias("type_lc"),
        F_.length(c("p_name")).alias("name_len"),
        F_.locate("green", c("p_name")).alias("green_at"),
        F_.concat(c("p_mfgr"), F_.lit("/"), c("p_brand")).alias("mfgr_brand"),
        F_.lpad(c("p_size").cast("string"), 4, "0").alias("size4"),
        F_.reverse(c("p_container")).alias("container_rev"),
        F_.rtrim(F_.rpad(c("p_brand"), 12, " ")).alias("brand"),
        F_.replace(c("p_type"), "BRASS", "Cu-Zn").alias("type_cu"),
        F_.regexp_replace(c("p_name"), "[aeiou]+", "").alias("consonants"),
        F_.regexp_extract(c("p_name"), "[a-z]+$", 0).alias("last_word"),
    ).orderBy("p_partkey")


def catalogue_grouped(c, F_, part):
    return part.groupBy(
        F_.regexp_extract(c("p_name"), "[a-z]+$", 0).alias("last_word"),
        F_.lower(c("p_type")).alias("type_lc")).agg(
        F_.count("*").alias("n"),
        F_.sum(F_.length(c("p_name"))).alias("name_bytes"))


def float_to_string(c, F_, li):
    return li.select(c("l_orderkey"),
                     c("l_extendedprice").cast("string").alias("price"))


API_CASES = {"catalogue": catalogue, "catalogue_grouped": catalogue_grouped,
             "float_to_string": float_to_string}
API_TABLES = {"catalogue": "part", "catalogue_grouped": "part",
              "float_to_string": "lineitem"}


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_tpch(0.002)


@pytest.fixture(autouse=True)
def fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    B.clear_scan_cache()


@pytest.mark.parametrize("incompat", [True, False], ids=["incompat",
                                                         "default"])
@pytest.mark.parametrize("case", list(API_CASES))
def test_api_matches_jax(tables, case, incompat):
    """The JAX session's rows, fallback summary and report, line for
    line; without ``incompatibleOps`` the projects holding ``Lower``,
    ``StringReverse`` and ``StringPad`` fall back with its reasons, and
    a float cast to string always does."""
    conf = dict(INCOMPAT) if incompat else {}
    table = tables[API_TABLES[case]]
    build = API_CASES[case]
    jdf = build(jcol, JF, JaxSession(dict(conf)).createDataFrame(table))
    want = jdf.toArrow()
    df = build(col, F, TpuSession(dict(conf), device="cpu")
               .createDataFrame(table))
    got = df.toArrow()
    assert got.schema == want.schema
    if case == "catalogue_grouped":
        assert bench._rows_equal(got, want, tol=1e-6)
    else:
        assert got.equals(want)
    assert got.num_rows > 0
    assert df.fallback_summary() == jdf.fallback_summary()
    report = df._last_override.fallback_report()
    assert report == jdf._last_override.fallback_report()
    if case == "float_to_string":
        assert any("cast floating→string not on device" in r
                   for r in report)
    elif not incompat:
        for name in ("Lower", "StringReverse", "StringPad")[
                :1 if case == "catalogue_grouped" else 3]:
            assert any(f"expression {name} is not fully compatible" in r
                       for r in report), (name, report)
    else:
        assert report == [] and df.fallback_summary()["fallback_ops"] == 0
