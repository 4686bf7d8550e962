"""The port's adaptive plane against the JAX package's.

Mirrors every case of ``tests/test_adaptive.py`` and the three
adaptive-join cases of ``tests/test_aqe_dpp.py``.  The cost model and
the replanner are pure: each unit case runs the port's function and the
JAX package's on the same numbers and asserts the JAX package's
expected values of both.  The integration cases (the skew split, the
broadcast flip, a zero-row build side, the history's warm path and a
forced flip, batch retargeting) run each query with the plane on and
off in the port (``device="cpu"``) and against the JAX package's CPU
session, exactly, and the decisions the stats plane records equal the
JAX package's on the same tables (one JAX run per scenario, shared
through module-scoped fixtures).  ``test_aqe_dpp.py``'s adaptive joins
run over the ICI exchange (``TpuAdaptiveJoinExec``: held in
``tests/test_torch_distributed.py``); here their tables, filters and
threshold drive the single-process ``TpuAdaptiveLocalJoinExec``.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu import adaptive as JAD
from spark_rapids_tpu.adaptive import cost_model as jcost
from spark_rapids_tpu.adaptive import replanner as jrep
from spark_rapids_tpu.conf import RapidsConf as JaxConf
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.utils import harness as JH
from spark_rapids_tpu.utils import profile as JP
from spark_rapids_tpu.utils.datagen import (
    SkewedLongGen, StringGen, gen_table, skewed_null_table)

from spark_rapids_tpu_torch import adaptive as AD
from spark_rapids_tpu_torch.adaptive import cost_model, replanner
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import stats
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.utils import harness as H
from spark_rapids_tpu_torch.utils import profile as P


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_arbiter():
    M.reset_manager()
    B.clear_scan_cache()
    yield
    M.reset_manager()
    B.clear_scan_cache()


def tpu_session(conf=None):
    return H.tpu_session(conf, device="cpu")


def cpu_session():
    return H.tpu_session({"spark.rapids.sql.enabled": False},
                         device="cpu")


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _canon(t: pa.Table) -> pa.Table:
    """Row-order-free canonical form: sort by every column."""
    t = t.combine_chunks()
    idx = pc.sort_indices(
        t, sort_keys=[(n, "ascending") for n in t.column_names])
    return t.take(idx)


def _assert_identical(a: pa.Table, b: pa.Table, what: str):
    assert _canon(a).equals(_canon(b)), f"{what}: tables differ"


# -- cost model (pure units) -------------------------------------------------

@pytest.mark.parametrize("mod", [cost_model, jcost], ids=["port", "jax"])
def test_choose_join_strategy_threshold(mod):
    assert mod.choose_join_strategy(100, 1000) == "broadcast"
    assert mod.choose_join_strategy(1000, 1000) == "broadcast"
    assert mod.choose_join_strategy(1001, 1000) == "shuffled"
    # threshold 0/-1 = broadcast disabled entirely
    assert mod.choose_join_strategy(0, 0) == "shuffled"
    assert mod.choose_join_strategy(1, -1) == "shuffled"


def test_plan_skew_splits_hot_partition():
    for mod in (cost_model, jcost):
        splits = mod.plan_skew_splits(
            [100, 100, 100, 5000], skew_threshold=2.0, target_rows=1000,
            max_splits=8)
        assert splits == {3: 5}  # ceil(5000/1000)


def test_plan_skew_splits_clamps_to_max():
    for mod in (cost_model, jcost):
        assert mod.plan_skew_splits(
            [10, 10_000], skew_threshold=1.5, target_rows=100,
            max_splits=4) == {1: 4}


def test_plan_skew_splits_ignores_small_and_uniform():
    for mod in (cost_model, jcost):
        # lopsided but tiny: not worth replicating the build side
        assert mod.plan_skew_splits(
            [1, 50], skew_threshold=2.0, target_rows=100,
            max_splits=8) == {}
        # heavy but uniform: nothing exceeds threshold x mean
        assert mod.plan_skew_splits(
            [5000, 5000], skew_threshold=2.0, target_rows=100,
            max_splits=8) == {}
        assert mod.plan_skew_splits(
            [], skew_threshold=2.0, target_rows=100, max_splits=8) == {}


def test_retarget_rows_ratio_gate():
    for mod in (cost_model, jcost):
        # static estimate within 1.25x of reality: leave the target
        assert mod.retarget_rows(1 << 20, 1000, 10_000, 10) is None
        # observed rows 10x fatter than estimated: shrink the target
        assert mod.retarget_rows(1 << 20, 1000, 100_000, 10) \
            == (1 << 20) // 100
        # thinner than estimated: grow it
        assert mod.retarget_rows(1 << 20, 1000, 2_000, 10) \
            == (1 << 20) // 2
        assert mod.retarget_rows(1 << 20, 0, 0, 10) is None


def test_subtree_signature_stable_and_discriminating():
    class _Node:
        def __init__(self, name, fields, children=()):
            self._n, self._f = name, fields
            self.children = list(children)

        @property
        def name(self):
            return self._n

        @property
        def schema(self):
            fields = self._f

            class _S:
                def field_names(self):
                    return list(fields)
            return _S()

    a = _Node("Scan", ["k", "v"])
    b = _Node("Filter", ["k", "v"], [a])
    for mod in (cost_model, jcost):
        assert (mod.subtree_signature(b)
                == mod.subtree_signature(_Node(
                    "Filter", ["k", "v"], [_Node("Scan", ["k", "v"])])))
        assert (mod.subtree_signature(b)
                != mod.subtree_signature(_Node("Filter", ["k", "w"], [a])))
        assert mod.subtree_signature(a) != mod.subtree_signature(b)
    assert cost_model.subtree_signature(b) == jcost.subtree_signature(b)


def test_history_build_bytes_most_recent_wins(tmp_path):
    store = str(tmp_path / "store.jsonl")
    stats.append_profile(store, {"adaptive_decisions": [
        {"kind": "shuffled", "build_sig": "aaa", "build_bytes": 999}]})
    stats.append_profile(store, {"adaptive_decisions": [
        {"kind": "broadcast", "build_sig": "aaa", "build_bytes": 7},
        {"kind": "broadcast", "build_sig": "bbb", "build_bytes": 11}]})
    for mod in (cost_model, jcost):
        assert mod.history_build_bytes(store, "aaa") == 7
        assert mod.history_build_bytes(store, "bbb") == 11
        assert mod.history_build_bytes(store, "zzz") is None
        assert mod.history_build_bytes("", "aaa") is None
        assert mod.history_build_bytes(
            str(tmp_path / "missing.jsonl"), "aaa") is None


# -- replanner (pure units) --------------------------------------------------

def _pol(ad=AD, **kw):
    base = dict(enabled=True, skew_threshold=2.0, max_splits=8,
                target_rows=1000, broadcast_threshold=1 << 20)
    base.update(kw)
    return ad.AdaptivePolicy(**base)


def test_plan_skew_reads_specs_cover_every_partition():
    got = replanner.plan_skew_reads(_pol(), "inner", [100, 100, 5000, 100])
    want = jrep.plan_skew_reads(_pol(JAD), "inner", [100, 100, 5000, 100])
    assert got == want
    specs, detail = got
    # partitions 0,1,3 read whole; partition 2 in 5 slices
    assert specs == ([(0, 0, 1), (1, 0, 1)]
                     + [(2, j, 5) for j in range(5)]
                     + [(3, 0, 1)])
    assert detail["partitions"] == [2]
    assert detail["splits"] == [5]
    assert detail["rows"] == [5000]
    assert detail["skew_factor"] > 3


def test_plan_skew_reads_gates():
    for rep, ad in ((replanner, AD), (jrep, JAD)):
        # full outer join: a stream row's NULL-extension depends on
        # every slice — not streamable, never split
        assert rep.plan_skew_reads(_pol(ad), "full", [100, 5000]) is None
        assert rep.plan_skew_reads(_pol(ad, skew_split=False), "inner",
                                   [100, 5000]) is None
        assert rep.plan_skew_reads(_pol(ad, enabled=False), "inner",
                                   [100, 5000]) is None
        assert rep.plan_skew_reads(_pol(ad), "inner", [100, 100]) is None


def test_decide_join_from_history_roundtrip(tmp_path):
    store = str(tmp_path / "store.jsonl")
    stats.append_profile(store, {"adaptive_decisions": [
        {"kind": "broadcast", "build_sig": "sig1", "build_bytes": 64}]})
    pol, jpol = _pol(history_path=store), _pol(JAD, history_path=store)
    got = replanner.decide_join_from_history(pol, "sig1")
    assert got == jrep.decide_join_from_history(jpol, "sig1")
    strategy, detail = got
    assert strategy == "broadcast"
    assert detail["source"] == "history"
    assert detail["build_bytes"] == 64
    # huge recorded build side: history says shuffled
    stats.append_profile(store, {"adaptive_decisions": [
        {"kind": "broadcast", "build_sig": "sig1",
         "build_bytes": 1 << 30}]})
    strategy, _ = replanner.decide_join_from_history(pol, "sig1")
    assert strategy == "shuffled"
    assert replanner.decide_join_from_history(pol, "nosuch") is None
    assert replanner.decide_join_from_history(
        _pol(join_strategy=False, history_path=store), "sig1") is None


def test_retarget_read_rows_snaps_to_bucket():
    got = replanner.retarget_read_rows(
        _pol(), target_bytes=1 << 20, static_row_bytes=10,
        observed_rows=1000, observed_bytes=100_000)
    want = jrep.retarget_read_rows(
        _pol(JAD), target_bytes=1 << 20, static_row_bytes=10,
        observed_rows=1000, observed_bytes=100_000)
    assert got == want
    target, detail = got
    assert target & (target - 1) == 0  # a pow-2 bucket
    assert detail["observed_row_bytes"] == 100.0
    assert replanner.retarget_read_rows(
        _pol(batch_retarget=False), 1 << 20, 10, 1000, 100_000) is None


def test_policy_from_conf_defaults_and_inheritance(tmp_path):
    s = tpu_session()
    pol = AD.policy_from_conf(s.rapids_conf())
    assert pol.enabled is False  # off by default
    assert not pol.wants_join and not pol.wants_skew
    assert not pol.wants_retarget
    store = str(tmp_path / "profiles.jsonl")
    confs = [
        {"spark.rapids.tpu.adaptive.enabled": True,
         "spark.rapids.tpu.stats.skewThreshold": 3.5,
         "spark.rapids.tpu.stats.storePath": store},
        {"spark.rapids.tpu.adaptive.enabled": True,
         "spark.rapids.tpu.adaptive.skewThreshold": 1.5,
         "spark.rapids.tpu.adaptive.historyPath": "/elsewhere.jsonl"}]
    pol2 = AD.policy_from_conf(tpu_session(confs[0]).rapids_conf())
    assert pol2.enabled and pol2.wants_join and pol2.wants_skew
    # skewThreshold 0 inherits the stats plane's bar; historyPath ""
    # inherits the stats store
    assert pol2.skew_threshold == 3.5
    assert pol2.history_path == store
    pol3 = AD.policy_from_conf(tpu_session(confs[1]).rapids_conf())
    assert pol3.skew_threshold == 1.5
    assert pol3.history_path == "/elsewhere.jsonl"
    # the JAX package parses the same confs into the same policies
    from spark_rapids_tpu.conf import RapidsConf as JaxConf
    for conf in [{}] + confs:
        assert (AD.policy_from_conf(tpu_session(conf).rapids_conf())
                .__dict__ == JAD.policy_from_conf(JaxConf(conf)).__dict__)


# -- bit-identity matrix -----------------------------------------------------

_SKEW_CONF = {
    "spark.rapids.tpu.stats.enabled": True,
    # threshold 0 kills the static broadcast fast-path AND the adaptive
    # measurement: the plan must go shuffled so skew splitting engages
    "spark.sql.autoBroadcastJoinThreshold": 0,
    "spark.rapids.tpu.join.targetRows": 2048,
    "spark.rapids.tpu.batchRows": 8192,
}
_ON = dict(_SKEW_CONF, **{"spark.rapids.tpu.adaptive.enabled": True})


def _skew_tables():
    n = 20_000
    stream = gen_table(
        [SkewedLongGen(hot_mass=0.6, distinct=2048, nullable=False)],
        n, seed=11, names=["k"])
    stream = stream.append_column(
        "v", pa.array(np.arange(n, dtype=np.int64)))
    build = pa.table({"k": np.arange(2048, dtype=np.int64),
                      "b": np.arange(2048, dtype=np.int64) * 3})
    return stream, build


def _join(s, stream, build, how="inner"):
    return s.createDataFrame(stream).join(
        s.createDataFrame(build), on="k", how=how)


def _decisions(profile):
    """The decisions the stats plane recorded, every key of each."""
    return [dict(d) for d in profile.get("adaptive_decisions", [])]


@pytest.fixture(scope="module")
def jax_skew():
    """The JAX package's skew-split join: its rows and decisions."""
    stream, build = _skew_tables()
    df = _join(JH.tpu_session(dict(_ON)), stream, build)
    out = df.toArrow()
    return out, _decisions(df.session.last_query_profile())


def test_skew_split_bit_identity(jax_skew):
    stream, build = _skew_tables()
    df_on = _join(tpu_session(_ON), stream, build)
    t_on = df_on.toArrow()
    t_off = _join(tpu_session(_SKEW_CONF), stream, build).toArrow()
    t_cpu = _join(cpu_session(), stream, build).toArrow()
    _assert_identical(t_on, t_off, "adaptive on vs off")
    _assert_identical(t_on, t_cpu, "adaptive on vs cpu")
    _assert_identical(t_on, jax_skew[0], "adaptive on vs jax")
    prof = df_on.session.last_query_profile()
    kinds = {d["kind"] for d in prof["adaptive_decisions"]}
    assert "skew-split" in kinds, prof["adaptive_decisions"]
    assert _decisions(prof) == jax_skew[1]
    node = _find(df_on._last_plan, "TpuAdaptiveLocalJoinExec")
    assert node is not None and node._mode == "shuffled"


def test_skew_split_left_join_skewed_null_table():
    # null-heavy left join over the canonical nasty table: null stream
    # keys match nothing but must survive the split exactly once
    stream = skewed_null_table(12_000, seed=5, hot_mass=0.6)
    build = pa.table({"k": np.arange(0, 4096, dtype=np.int64),
                      "b": np.arange(4096, dtype=np.int64)})

    def q(s, c=col):
        return _join(s, stream, build, how="left").select("k", "v", "b")

    df_on = q(tpu_session(_ON))
    t_on = df_on.toArrow()
    t_off = q(tpu_session(_SKEW_CONF)).toArrow()
    t_cpu = q(JH.cpu_session(), jcol).toArrow()
    _assert_identical(t_on, t_off, "left-join adaptive on vs off")
    _assert_identical(t_on, t_cpu, "left-join adaptive on vs jax cpu")
    # the split the JAX package's replanner plans on the same counts
    node = _find(df_on._last_plan, "TpuAdaptiveLocalJoinExec")
    counts = node._inner.children[0].partition_row_counts()
    want = jrep.plan_skew_reads(JAD.policy_from_conf(JaxConf(dict(_ON))),
                                "left", counts)
    split = [d for d in df_on.session.last_query_profile()
             ["adaptive_decisions"] if d["kind"] == "skew-split"]
    assert want is not None and len(split) == 1
    assert {k: split[0][k] for k in want[1]} == want[1]


def _flip_tables():
    stream, build = _skew_tables()
    return stream, build


_FLIP_CONF = {"spark.rapids.tpu.stats.enabled": True,
              "spark.rapids.tpu.adaptive.enabled": True,
              "spark.sql.autoBroadcastJoinThreshold": 4096,
              "spark.rapids.tpu.batchRows": 8192}


def _flip_q(s, stream, build, pred, c=col):
    b = s.createDataFrame(build).filter(pred(c))
    return s.createDataFrame(stream).join(b, on="k", how="inner")


@pytest.fixture(scope="module")
def jax_flip():
    """The JAX package's broadcast flip: its rows and decisions."""
    stream, build = _flip_tables()
    df = _flip_q(JH.tpu_session(dict(_FLIP_CONF)), stream, build,
                 lambda c: c("k") < 100, jcol)
    out = df.toArrow()
    return out, _decisions(df.session.last_query_profile())


def test_broadcast_flip_mid_query(jax_flip):
    # plan-time can't prove the build side small: the size estimate is
    # an upper bound that ignores the filter, so the whole-table ~33KB
    # exceeds the 4KB threshold — the adaptive join measures the ~100
    # live rows mid-query and flips the shuffled plan to broadcast
    stream, build = _flip_tables()
    df_on = _flip_q(tpu_session(_FLIP_CONF), stream, build,
                    lambda c: c("k") < 100)
    t_on = df_on.toArrow()
    t_cpu = _flip_q(cpu_session(), stream, build,
                    lambda c: c("k") < 100).toArrow()
    _assert_identical(t_on, t_cpu, "broadcast flip vs cpu")
    _assert_identical(t_on, jax_flip[0], "broadcast flip vs jax")
    node = _find(df_on._last_plan, "TpuAdaptiveLocalJoinExec")
    assert node is not None
    assert node._mode == "broadcast"
    assert "runtime=broadcast" in node.node_string()
    assert node.metrics["adaptiveBroadcastJoins"].value == 1
    decisions = _decisions(df_on.session.last_query_profile())
    dec = [d for d in decisions if d["kind"] == "broadcast"]
    assert dec and dec[0]["source"] == "measured"
    assert dec[0]["build_bytes"] <= dec[0]["threshold"]
    assert decisions == jax_flip[1]


def test_zero_row_build_side():
    stream, build = _flip_tables()
    df_on = _flip_q(tpu_session(_FLIP_CONF), stream, build,
                    lambda c: c("k") < 0)  # empty
    t_on = df_on.toArrow()
    assert t_on.num_rows == 0
    t_cpu = _flip_q(JH.cpu_session(), stream, build,
                    lambda c: c("k") < 0, jcol).toArrow()
    _assert_identical(t_on, t_cpu, "zero-row build vs jax cpu")
    node = _find(df_on._last_plan, "TpuAdaptiveLocalJoinExec")
    assert node is not None and node._mode == "broadcast"
    (dec,) = _decisions(df_on.session.last_query_profile())
    assert dec["build_bytes"] == 0 and dec["source"] == "measured"


def test_history_warm_path_and_forced_flip(tmp_path, jax_flip):
    stream, build = _flip_tables()
    store = str(tmp_path / "profiles.jsonl")
    conf = dict(_FLIP_CONF, **{"spark.rapids.tpu.stats.storePath": store})

    def q(s):
        return _flip_q(s, stream, build, lambda c: c("k") < 100)

    # cold: measured broadcast, decision recorded into the store
    df1 = q(tpu_session(conf))
    t1 = df1.toArrow()
    d1 = [d for d in df1.session.last_query_profile()
          ["adaptive_decisions"] if d["kind"] == "broadcast"]
    assert d1 and d1[0]["source"] == "measured"
    sig = d1[0]["build_sig"]
    # the JAX package's run measured the same build side under the same
    # signature
    jd = [d for d in jax_flip[1] if d["kind"] == "broadcast"]
    assert (sig, d1[0]["build_bytes"]) == (jd[0]["build_sig"],
                                          jd[0]["build_bytes"])

    # warm: same query shape in a new session decides from history —
    # no build-side measurement this time
    df2 = q(tpu_session(conf))
    t2 = df2.toArrow()
    d2 = [d for d in df2.session.last_query_profile()
          ["adaptive_decisions"] if d["kind"] == "broadcast"]
    assert d2 and d2[0]["source"] == "history"
    assert d2[0]["build_sig"] == sig
    _assert_identical(t1, t2, "cold vs warm")

    # forced flip: poison the history with a huge recorded build side —
    # the same query now plans shuffled, answers must not move
    stats.append_profile(store, {"adaptive_decisions": [
        {"kind": "shuffled", "build_sig": sig,
         "build_bytes": 1 << 30}]})
    df3 = q(tpu_session(conf))
    t3 = df3.toArrow()
    d3 = [d for d in df3.session.last_query_profile()
          ["adaptive_decisions"] if d["kind"] in ("broadcast",
                                                  "shuffled")]
    assert d3 and d3[0]["kind"] == "shuffled"
    assert d3[0]["source"] == "history"
    _assert_identical(t1, t3, "broadcast vs forced-shuffled")
    # the JAX package reads the port's store to the same decision
    assert (jrep.decide_join_from_history(
        _pol(JAD, history_path=store, broadcast_threshold=4096), sig)
        == replanner.decide_join_from_history(
            _pol(history_path=store, broadcast_threshold=4096), sig))


_RETARGET_BASE = {
    "spark.sql.adaptive.enabled": True,
    "spark.sql.adaptive.advisoryPartitionSizeInBytes": 64 << 10,
    "spark.rapids.tpu.stats.enabled": True,
    # retarget consumes ROW counts: needs the device-resident exchange
    # (the host path records partition BYTES)
    "spark.rapids.shuffle.mode": "CACHE_ONLY",
    "spark.rapids.tpu.batchRows": 8192}


def _retarget_table():
    return gen_table(
        [SkewedLongGen(hot_mass=0.3, distinct=64, nullable=False),
         StringGen(min_len=120, max_len=120, null_ratio=0.0)],
        6000, seed=3, names=["k", "s"])


@pytest.fixture(scope="module")
def jax_retarget():
    t = _retarget_table()
    on = dict(_RETARGET_BASE, **{"spark.rapids.tpu.adaptive.enabled": True})
    df = JH.tpu_session(on).createDataFrame(t).repartition(16, "k")
    out = df.toArrow()
    aqe = _find(df._last_plan, "TpuAQEShuffleReadExec")
    return out, _decisions(df.session.last_query_profile()), aqe._specs


def test_batch_retarget_bit_identity(jax_retarget):
    # fat string rows: the static 40-byte/string planning guess is far
    # off the observed width, so the AQE read retargets its coalesce
    t = _retarget_table()
    on = dict(_RETARGET_BASE, **{"spark.rapids.tpu.adaptive.enabled": True})

    def q(s):
        return s.createDataFrame(t).repartition(16, "k")

    df_on = q(tpu_session(on))
    t_on = df_on.toArrow()
    t_off = q(tpu_session(_RETARGET_BASE)).toArrow()
    t_cpu = q(cpu_session()).toArrow()
    _assert_identical(t_on, t_off, "retarget on vs off")
    _assert_identical(t_on, t_cpu, "retarget on vs cpu")
    _assert_identical(t_on, jax_retarget[0], "retarget on vs jax")
    aqe = _find(df_on._last_plan, "TpuAQEShuffleReadExec")
    assert aqe is not None
    assert aqe.metrics["retargetedReads"].value == 1
    decisions = _decisions(df_on.session.last_query_profile())
    dec = [d for d in decisions if d["kind"] == "batch-retarget"]
    assert dec, "no batch-retarget decision recorded"
    assert dec[0]["observed_row_bytes"] > dec[0]["static_row_bytes"]
    assert dec[0]["target_rows"] == [
        d for d in jax_retarget[1]
        if d["kind"] == "batch-retarget"][0]["target_rows"]
    assert aqe._specs == jax_retarget[2]


def test_explain_analyze_shows_decisions(capsys):
    stream, build = _skew_tables()
    df = _join(tpu_session(_ON), stream, build)
    df.toArrow()
    df.explain("analyze")
    out = capsys.readouterr().out
    assert "adaptive=" in out
    assert "skew-split(" in out


def test_adaptive_decisions_counter_ticks():
    from spark_rapids_tpu_torch.runtime import telemetry as TM
    stream, build = _skew_tables()
    key = 'tpuq_adaptive_decisions_total{kind="skew-split"}'
    before = TM.REGISTRY.snapshot().get(key, 0)
    _join(tpu_session(_ON), stream, build).toArrow()
    assert TM.REGISTRY.snapshot().get(key, 0) > before


# -- profiler CLI ------------------------------------------------------------

def _store_record(qid, decisions):
    return {"record": "profile", "query_id": qid, "wall_s": 0.5,
            "ops": [{"op": "TpuAdaptiveLocalJoinExec", "sig": "s1",
                     "path": "0.0", "self_s": 0.1, "total_s": 0.2,
                     "rows": 10, "bytes": 100}],
            "exchanges": [], "adaptive_decisions": decisions}


def test_profile_top_adaptive_lists_decisions(tmp_path, capsys):
    store = tmp_path / "a.jsonl"
    store.write_text(json.dumps(_store_record(1, [
        {"kind": "broadcast", "op": "TpuAdaptiveLocalJoinExec",
         "sig": "s1", "build_sig": "bs1", "build_bytes": 64,
         "threshold": 1 << 20, "source": "measured"},
        {"kind": "skew-split", "op": "TpuSortMergeJoinExec",
         "sig": "s2", "partitions": [3], "splits": [5],
         "rows": [5000], "skew_factor": 4.2, "threshold": 2.0},
    ])) + "\n")
    outs = []
    for mod in (P, JP):
        rc = mod.main(["top", str(store), "--adaptive"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "adaptive decisions" in out
        assert "broadcast (build_bytes=64" in out
        assert "skew-split (partitions=[3]" in out
        # without --adaptive the report stays quiet about decisions
        mod.main(["top", str(store)])
        assert "adaptive decisions" not in capsys.readouterr().out
        outs.append(out)
    assert outs[0] == outs[1]


def test_profile_diff_flags_decision_flips(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text(json.dumps(_store_record(1, [
        {"kind": "broadcast", "op": "TpuAdaptiveLocalJoinExec",
         "sig": "s1", "build_sig": "bs1", "build_bytes": 64,
         "threshold": 1 << 20, "source": "measured"}])) + "\n")
    b.write_text(json.dumps(_store_record(2, [
        {"kind": "shuffled", "op": "TpuAdaptiveLocalJoinExec",
         "sig": "s1", "build_sig": "bs1", "build_bytes": 1 << 30,
         "threshold": 1 << 20, "source": "measured"}])) + "\n")
    for mod in (P, JP):
        rc = mod.main(["diff", str(a), str(b)])
        out = capsys.readouterr().out
        assert "DECISION FLIP bs1: broadcast -> shuffled" in out
        assert rc == 0  # informational, not a regression
        # no flip when both sides agree
        rc = mod.main(["diff", str(a), str(a)])
        assert "DECISION FLIP" not in capsys.readouterr().out
        assert rc == 0


# -- test_aqe_dpp.py's adaptive joins, through the local adaptive join -------

def _adaptive_tables(sel):
    rng = np.random.default_rng(81)
    n = 40_000
    left = pa.table({"k": pa.array(rng.integers(0, 5000, n)),
                     "v": pa.array(rng.uniform(-5, 5, n))})
    # right side BIG pre-filter (the planner sees the upper bound), small
    # or big post-filter depending on `sel`
    right = pa.table({"k": pa.array(rng.integers(0, 6000, n)),
                      "w": pa.array(rng.integers(0, 1000 if sel else 2,
                                                 n))})
    return left, right


# threshold UNDER the unfiltered upper bound (so the static planner
# cannot broadcast) but far above the filtered build side's real size
_AQE_CONF = {"spark.sql.adaptive.enabled": True,
             "spark.rapids.tpu.adaptive.enabled": True,
             "spark.rapids.tpu.stats.enabled": True,
             "spark.sql.autoBroadcastJoinThreshold": 64 << 10}


def _aqe_join(s, left, right, w, c=col):
    return s.createDataFrame(left).join(
        s.createDataFrame(right).filter(c("w") == w), "k", "inner")


@pytest.fixture(scope="module")
def jax_aqe():
    """The JAX package's local adaptive join over both tables: its
    decisions."""
    out = {}
    for sel, w in ((True, 3), (False, 1)):
        left, right = _adaptive_tables(sel=sel)
        df = _aqe_join(JH.tpu_session(dict(_AQE_CONF)), left, right, w,
                       jcol)
        df.toArrow()
        out[sel] = _decisions(df.session.last_query_profile())
    return out


def _check_aqe(sel, w, mode, jax_aqe):
    left, right = _adaptive_tables(sel=sel)
    df = _aqe_join(tpu_session(_AQE_CONF), left, right, w)
    out = df.toArrow()
    assert out.num_rows > 0
    want = _aqe_join(JH.cpu_session(), left, right, w, jcol).toArrow()
    _assert_identical(out, want, f"{mode} join vs jax cpu")
    j = _find(df._last_plan, "TpuAdaptiveLocalJoinExec")
    assert j is not None
    assert j._mode == mode
    assert j.metric(f"adaptive{mode.capitalize()}Joins").value == 1
    assert _decisions(df.session.last_query_profile()) == jax_aqe[sel]
    return df


def test_adaptive_join_flips_to_broadcast_at_runtime(jax_aqe):
    """The planned shuffled join collapses to broadcast once the
    filtered build side measures under the threshold: no exchange runs."""
    df = _check_aqe(True, 3, "broadcast", jax_aqe)
    j = _find(df._last_plan, "TpuAdaptiveLocalJoinExec")
    assert _find(j._inner, "TpuShuffleExchangeExec") is None


def test_adaptive_join_stays_shuffled_when_big(jax_aqe):
    df = _check_aqe(False, 1, "shuffled", jax_aqe)
    j = _find(df._last_plan, "TpuAdaptiveLocalJoinExec")
    assert _find(j._inner, "TpuShuffleExchangeExec") is not None


def test_adaptive_off_keeps_planned_shuffle():
    left, right = _adaptive_tables(sel=True)
    conf = dict(_AQE_CONF, **{"spark.rapids.tpu.adaptive.enabled": False})
    df = _aqe_join(tpu_session(conf), left, right, 3)
    out = df.toArrow()
    assert _find(df._last_plan, "TpuAdaptiveLocalJoinExec") is None
    assert _find(df._last_plan, "TpuSortMergeJoinExec") is not None
    want = _aqe_join(JH.cpu_session(), left, right, 3, jcol).toArrow()
    _assert_identical(out, want, "adaptive off vs jax cpu")
