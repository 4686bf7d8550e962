"""The port's join slice against the JAX package: TPC-H q3 and q4, the
planner's strategies, and the TPC-H generator (the join types and what
the slice leaves out are ``test_torch_join_types.py``'s).

Both sessions run the same tables through their own DataFrame API.
Results must be equal under ``bench._rows_equal(tol=1e-6)``, the
reference's oracle rule (keys and counts exact, floats within a relative
1e-6: the two packages add in different orders).  q3 and q4 run at sf
0.002 under three confs so that every branch the SF1 run takes runs at a
small size, as ``bench.py`` does: the defaults (both joins of q3 and
q4's semi join broadcast their right side), ``join.targetRows = 1024``
(a broadcast join whose streamed side is cut into groups) and
``autoBroadcastJoinThreshold = 0`` with ``join.targetRows = 1024`` (the
run-time pick: ``_broadcast_streamed`` with the left side whole, and
``_semi_stream_right``).  The JAX results are shared through
module-scoped fixtures.
"""

import pytest

import bench

from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.kernels import cuda_backend as CB
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch

SF = 0.002
CONFS = {
    "defaults": {},
    "targetRows1024": {"spark.rapids.tpu.join.targetRows": 1024},
    "noBroadcast": {"spark.sql.autoBroadcastJoinThreshold": 0,
                    "spark.rapids.tpu.join.targetRows": 1024},
}


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


def _plan_facts(df):
    """(plan tree lines, streamedJoins of each join, root first)."""
    lines = [l.rstrip() for l in df._last_plan.tree_string().splitlines()]
    streamed = [m.get("streamedJoins", 0) for name, m in df.metrics()
                if name == "TpuSortMergeJoinExec"]
    return lines, streamed


@pytest.fixture(scope="module")
def jax_runs(tables):
    """conf name -> query -> (result, plan facts) of the JAX session."""
    out = {}
    for name, conf in CONFS.items():
        s = JaxSession(dict(conf))
        out[name] = {}
        for q in ("q3", "q4"):
            df = getattr(bench, q)(s, tables)
            res = df.toArrow()
            out[name][q] = (res, _plan_facts(df))
    return out


def test_gen_tpch_equals_bench_at_the_test_scale(tables):
    _check_generator(tpch.gen_tpch(SF), tables)


def test_gen_tpch_equals_bench_at_sf_0_01():
    _check_generator(tpch.gen_tpch(0.01), bench.gen_tpch(0.01))


def _check_generator(got, ref):
    for name in ("customer", "orders", "lineitem"):
        a, b = got[name], ref[name]
        assert a.column_names == b.column_names, name
        for c in b.column_names:
            assert a.column(c).equals(b.column(c)), (name, c)
        # the broadcast decision reads table sizes: buffers agree too
        assert a.nbytes == b.nbytes, name


@pytest.mark.parametrize("backend", ["cuda", "jnp"])
@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", ["q3", "q4"])
def test_query_matches_jax(tables, jax_runs, query, conf, backend):
    s = TpuSession(dict(CONFS[conf],
                        **{"spark.rapids.tpu.kernel.backend": backend}),
                   device="cpu")
    KN.COUNTERS.reset()
    launches = CB.launches
    got = getattr(tpch, query)(s, tables).toArrow()
    want = jax_runs[conf][query][0]
    assert got.schema == want.schema
    assert bench._rows_equal(got, want, tol=1e-6)
    assert got.num_rows == (10 if query == "q3" else 5)
    # CPU tensors never launch the kernel; the rung ran what was asked
    assert CB.launches == launches
    assert KN.COUNTERS.fallbacks == 0
    other = "jnp" if backend == "cuda" else "cuda"
    assert KN.COUNTERS.dispatches[backend] > 0
    assert KN.COUNTERS.dispatches[other] == 0
    KN.COUNTERS.reset()


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", ["q3", "q4"])
def test_planner_takes_the_jax_strategy(tables, jax_runs, query, conf):
    df = getattr(tpch, query)(TpuSession(dict(CONFS[conf]), device="cpu"),
                              tables)
    df.toArrow()
    lines, streamed = _plan_facts(df)
    want_lines, want_streamed = jax_runs[conf][query][1]
    assert lines == want_lines
    assert streamed == want_streamed


def test_sf1_strategies_at_a_small_scale():
    """The strategies the SF1 run takes (chip_smoke.py asserts them at
    SF1), reproduced at sf 0.05 by scaling the thresholds: customer fits
    the broadcast threshold and orders does not; q3's second join and
    q4's semi join find their left side within targetRows at run time."""
    t = tpch.gen_tpch(0.05)
    s = TpuSession({"spark.sql.autoBroadcastJoinThreshold": "1m",
                    "spark.rapids.tpu.join.targetRows": 16384},
                   device="cpu")
    import chip_smoke
    for q in ("q3", "q4"):
        df = getattr(tpch, q)(s, t)
        got = df.toArrow()
        chip_smoke.check_strategies(q, chip_smoke.join_strategies(df))
        ref = getattr(chip_smoke, "ref_" + q)(t)
        assert chip_smoke.rows_equal(got, ref)


def test_sf1_strategies_of_the_new_queries_at_a_small_scale():
    """The joins of q5 ... q21 take the strategies that chip_smoke.py
    pins for SF1, reproduced at sf 0.05 with both thresholds scaled by
    sf: autoBroadcastJoinThreshold 10 MB / 20 and join.targetRows
    2^18 / 20 (table sizes and live rows scale with sf).  No join sits
    near a threshold: the nearest are q5's in-core join, whose orders
    side holds 0.83 of targetRows, and q19's broadcast of part, 6.8 of
    the 10 MB.  Each result must also match chip_smoke.py's pyarrow
    reference."""
    t = tpch.gen_tpch(0.05)
    s = TpuSession({"spark.sql.autoBroadcastJoinThreshold": (10 << 20) // 20,
                    "spark.rapids.tpu.join.targetRows": (1 << 18) // 20},
                   device="cpu")
    import chip_smoke
    for q in chip_smoke.STRATEGIES:
        df = getattr(tpch, q)(s, t)
        got = df.toArrow()
        chip_smoke.check_strategies(q, chip_smoke.join_strategies(df))
        ref = getattr(chip_smoke, "ref_" + q)(t)
        assert got.column_names == ref.column_names, q
        assert got.num_rows > 0, q
        assert chip_smoke.rows_equal(got, ref), q
