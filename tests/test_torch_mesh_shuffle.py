"""The port's rank mesh and exchange programs against the JAX package's.

``parallel/mesh.py`` and ``parallel/shuffle.py`` of the port on eight
virtual CPU ranks (the counterpart of the JAX tests' eight virtual CPU
devices): the mesh and its all_to_all round trip, the sort-free rank
and the prepare index table (exact to the JAX package's), the wire-cell
ladder, and ``tests/test_exchange_compiled.py``'s matrix — the compiled
exchange bit-identical to the host-shuffle transport at d = 1, 2, 8 over
its three tables, on one stacked group and on groups copied between
(stand-in) devices — plus the compiled exchange held against the JAX
package's on the same rows, the two-phase count/shuffle programs, and
``spark.rapids.tpu.exchange.mode``'s plans and results.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import device_to_host
from spark_rapids_tpu_torch.exec.basic import TpuScanExec
from spark_rapids_tpu_torch.exec.distributed import TpuIciShuffleExchangeExec
from spark_rapids_tpu_torch.ops.expressions import BoundReference
from spark_rapids_tpu_torch.parallel import mesh as MESH
from spark_rapids_tpu_torch.parallel import shuffle as SH
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.shuffle.exchange import TpuHostShuffleExchangeExec

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _eight_ranks():
    """Eight virtual ranks on the CPU, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MESH, "_virtual", 8)
        mp.setattr(MESH, "_latched", True)
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_arbiter():
    M.reset_manager()
    yield
    M.reset_manager()


def _schema(table: pa.Table) -> T.StructType:
    return T.StructType(tuple(
        T.StructField(f.name, T.from_arrow(f.type)) for f in table.schema))


def _tables():
    from spark_rapids_tpu.utils.datagen import (
        DoubleGen, SkewedLongGen, gen_table, skewed_null_table)
    n = 4000
    skew_nulls = skewed_null_table(n, seed=3)
    skew_gen = gen_table(
        [SkewedLongGen(hot_keys=1, hot_mass=0.9, distinct=10_000,
                       nullable=False),
         DoubleGen(no_nans=True)], n, seed=7, names=["k", "v"])
    rng = np.random.default_rng(9)
    # constant key: every row hashes to ONE partition
    const_key = pa.table({"k": pa.array([7] * n, pa.int64()),
                          "v": pa.array(rng.uniform(-10, 10, n))})
    return {"skewed_null_table": skew_nulls, "skewed_long": skew_gen,
            "constant_key": const_key}


@pytest.fixture(scope="module")
def tables():
    return _tables()


def _partitions(ex):
    """Per-partition Arrow tables; a partition with no batch (the host
    transport's empty partition) is the schema's empty table."""
    out = []
    for p in range(ex.num_partitions()):
        got = [device_to_host(b) for b in ex.execute(p)]
        out.append(pa.concat_tables(got) if got else pa.table({
            f.name: pa.array([], T.to_arrow(f.dtype))
            for f in ex.schema.fields}))
    return out


def _pair(table, d, mesh=None, donate=True):
    schema = _schema(table)
    keys = [BoundReference(0, schema.fields[0].dtype)]
    # child partitions == mesh size: one source per rank, the layout
    # under which the compiled and host transports agree on row order
    ici = TpuIciShuffleExchangeExec(
        TpuScanExec(table, schema, CPU, num_partitions=d), keys,
        mesh=mesh if mesh is not None else MESH.make_mesh(d, CPU),
        donate=donate)
    host = TpuHostShuffleExchangeExec(
        TpuScanExec(table, schema, CPU, num_partitions=d), d, keys, CPU)
    return ici, host


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh():
    mesh = MESH.make_mesh(8, CPU)
    assert mesh.size == 8 and MESH.make_mesh(device=CPU).size == 8
    assert mesh.groups() == [(CPU, list(range(8)))]
    assert mesh.local_ranks() == list(range(8))
    assert MESH.make_mesh(2, CPU).size == 2
    with pytest.raises(ValueError, match="only 8"):
        MESH.make_mesh(9, CPU)
    # a session on the card builds its mesh there, never on the CPU,
    # and a mesh without the session's device is refused
    card = MESH.make_mesh(device="cuda:0")
    assert {d.type for d in card.devices} == {"cuda"}
    with pytest.raises(ValueError, match="session's device"):
        MESH.make_mesh(8)
    # the count is read once: another count after the first mesh raises
    with pytest.raises(RuntimeError, match="already 8"):
        MESH.set_virtual_ranks(4)
    MESH.set_virtual_ranks(8)  # the same count is a no-op


def test_groups_split_ranks_by_device():
    mesh = MESH.Mesh([CPU] * 8, group_of=[0, 0, 1, 1, 2, 2, 3, 3])
    assert [r for _, r in mesh.groups()] == [[0, 1], [2, 3], [4, 5],
                                             [6, 7]]
    assert len(mesh.groups()) == 4
    remote = MESH.Mesh([CPU, CPU, None, None], process_of=[0, 0, 1, 1])
    assert remote.local_ranks() == [0, 1]
    assert remote.groups() == [(CPU, [0, 1])]


def test_all_to_all_shuffle_roundtrip():
    """``tests/test_parallel.py``'s round trip: parts[src, dst] =
    100*src + dst comes back as out[dst, src], as the JAX collective
    returns it."""
    import jax.numpy as jnp

    from spark_rapids_tpu.parallel.mesh import (
        all_to_all_shuffle as jax_a2a, make_mesh as jax_mesh)
    d = 4
    parts = (np.arange(d * d, dtype=np.int64).reshape(d, d) % d
             + 100 * (np.arange(d * d).reshape(d, d) // d))
    want = np.asarray(jax_a2a(jax_mesh(d), jnp.asarray(parts)))
    mesh = MESH.make_mesh(d, CPU)
    got = MESH.all_to_all_shuffle(mesh, torch.from_numpy(parts)).numpy()
    np.testing.assert_array_equal(got, want)
    for dst in range(d):
        for src in range(d):
            assert got[dst, src] == 100 * src + dst
    # ranks on several devices: per-rank blocks, copied across
    split = MESH.Mesh([CPU] * d, group_of=[0, 1, 2, 3])
    blocks = MESH.all_to_all_shuffle(
        split, [torch.from_numpy(parts[r]) for r in range(d)])
    np.testing.assert_array_equal(torch.stack(blocks).numpy(), want)


# ---------------------------------------------------------------------------
# the programs' pieces, exact to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [3, 8, 12])
def test_exchange_rank_matches_jax(nparts):
    """The packed-lane rank (nparts > 8 runs several lane groups) and
    the counts, exact to the JAX package's, and over leading rank dims
    as one launch."""
    import jax.numpy as jnp

    from spark_rapids_tpu.parallel.shuffle import _exchange_rank as jrank
    b = 1024
    rng = np.random.default_rng(5 + nparts)
    pid_np = rng.integers(0, nparts, (3, b))
    sel_np = rng.random((3, b)) < 0.8
    rank, counts = SH._exchange_rank(torch.from_numpy(pid_np),
                                     torch.from_numpy(sel_np), nparts, b)
    for g in range(3):
        jr, jc = jrank(jnp.asarray(pid_np[g], jnp.int32),
                       jnp.asarray(sel_np[g]), nparts, b)
        live = sel_np[g]
        np.testing.assert_array_equal(rank[g].numpy()[live],
                                      np.asarray(jr)[live])
        np.testing.assert_array_equal(counts[g].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            counts[g].numpy(), np.bincount(pid_np[g][live],
                                           minlength=nparts))


def test_prepare_index_and_layout_match_jax(tables):
    """The gather index table and counts of one rank, and the sort-based
    layout of the two-phase program, against the JAX package's."""
    import jax.numpy as jnp

    from spark_rapids_tpu.columnar.column import (
        host_to_device as jax_h2d)
    from spark_rapids_tpu.parallel import shuffle as JSH
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    t = tables["skewed_null_table"].slice(0, 1000)
    b = host_to_device(t, CPU)
    jb = jax_h2d(t)
    pid_np = np.random.default_rng(2).integers(0, 8, b.capacity)
    idx, counts = SH._prepare_index(b, torch.from_numpy(pid_np), 8)
    jidx, jcounts = JSH._prepare_index(jb, jnp.asarray(pid_np, jnp.int32),
                                       8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(
        SH.local_partition_counts(b, torch.from_numpy(pid_np), 8).numpy(),
        np.asarray(JSH.local_partition_counts(
            jb, jnp.asarray(pid_np, jnp.int32), 8)))
    cap = int(counts.max())
    laid = SH.partition_layout(b, torch.from_numpy(pid_np), 8, cap)
    jlaid = JSH.partition_layout(jb, jnp.asarray(pid_np, jnp.int32), 8,
                                 cap)
    np.testing.assert_array_equal(laid.sel.numpy(), np.asarray(jlaid.sel))
    live = laid.sel.numpy()
    np.testing.assert_array_equal(
        laid.columns[0].data.numpy()[live],
        np.asarray(jlaid.columns[0].data)[live])


def test_exchange_cap_matches_jax():
    from spark_rapids_tpu.parallel.shuffle import exchange_cap as jcap
    for mc in (0, 1, 7, 8, 9, 31, 33, 100, 1000, 1025, 4096, 5000):
        for local_b in (1024, 8192):
            assert SH.exchange_cap(mc, local_b) == jcap(mc, local_b)


# ---------------------------------------------------------------------------
# the compiled exchange: bit-identical to the host transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("name", ["skewed_null_table", "skewed_long",
                                  "constant_key"])
def test_compiled_exchange_bit_identical_to_host(tables, name, d):
    table = tables[name]
    ici, host = _pair(table, d)
    got, exp = _partitions(ici), _partitions(host)
    assert len(got) == len(exp) == d
    total = 0
    for p, (a, b) in enumerate(zip(got, exp)):
        assert a.schema.names == b.schema.names
        assert a.num_rows == b.num_rows, (name, d, p)
        assert a.equals(b), f"{name} d={d} partition {p} diverged"
        total += a.num_rows
    assert total == table.num_rows
    if name == "constant_key" and d > 1:
        assert sorted(t.num_rows for t in got)[:-1] == [0] * (d - 1)


@pytest.mark.parametrize("name", ["skewed_null_table", "constant_key"])
def test_exchange_across_device_groups_matches_host(tables, name):
    """Four groups of two ranks, each group a device of its own (the
    copies between cards of one process, over stand-in CPU devices):
    the JAX package's cap-cell boundary, bit-identical as well."""
    mesh = MESH.Mesh([CPU] * 8, group_of=[0, 0, 1, 1, 2, 2, 3, 3])
    ici, host = _pair(tables[name], 8, mesh=mesh)
    for a, b in zip(_partitions(ici), _partitions(host)):
        assert a.equals(b)


def test_compiled_exchange_without_donation_matches(tables):
    ici, host = _pair(tables["skewed_null_table"], 2, donate=False)
    for a, b in zip(_partitions(ici), _partitions(host)):
        assert a.equals(b)
    assert ici._kept_input is not None


@pytest.fixture(scope="module")
def jax_partitions(tables):
    """The JAX package's compiled exchange over the same rows, d = 8."""
    from spark_rapids_tpu.columnar import dtypes as JT
    from spark_rapids_tpu.columnar.column import (
        device_to_host as jax_d2h)
    from spark_rapids_tpu.exec.basic import TpuScanExec as JScan
    from spark_rapids_tpu.exec.distributed import (
        TpuIciShuffleExchangeExec as JIci)
    from spark_rapids_tpu.ops.expressions import (
        BoundReference as JRef)
    from spark_rapids_tpu.parallel.mesh import make_mesh as jax_mesh
    t = tables["skewed_null_table"]
    schema = JT.StructType(tuple(
        JT.StructField(f.name, JT.from_arrow(f.type)) for f in t.schema))
    ex = JIci(JScan(t, schema, num_partitions=8),
              [JRef(0, schema.fields[0].dtype)], mesh=jax_mesh(8))
    return [pa.concat_tables([jax_d2h(b) for b in ex.execute(p)])
            for p in range(8)]


def test_compiled_exchange_equals_jax(tables, jax_partitions):
    ici, _ = _pair(tables["skewed_null_table"], 8)
    for p, (a, b) in enumerate(zip(_partitions(ici), jax_partitions)):
        assert a.num_rows == b.num_rows, p
        assert a.to_pylist() == b.to_pylist(), p


def test_two_phase_programs_equal_compiled(tables):
    """The count/shuffle programs (the multi-executor exchange's) give
    each partition the compiled exchange's rows, in its order."""
    t = tables["skewed_null_table"]
    ici, _ = _pair(t, 8)
    want = [x.to_pylist() for x in _partitions(ici)]
    from spark_rapids_tpu_torch.columnar.column import (
        compact, host_to_device, slice_batch)
    mesh = MESH.make_mesh(8, CPU)
    n, per = t.num_rows, 1024
    # rank r's rows: the r-th slice of the table, padded to ``per`` rows
    shards = [host_to_device(t.slice(r * (n // 8), n // 8), CPU,
                             bucket=per) for r in range(8)]
    glob = SH._from_leaves(shards[0].schema, [
        None if xs[0] is None else torch.cat(xs)
        for xs in zip(*[SH._leaves(b) for b in shards])])
    sharded = SH.shard_batch(mesh, glob)
    keys = [BoundReference(0, T.LongT)]
    counts = SH.build_count_program(mesh, keys, 8)(sharded)
    assert counts.sum().item() == n
    cap = int(counts.max())
    got, = SH.build_shuffle_program(mesh, keys, 8, cap)(sharded)
    for p in range(8):
        block = compact(slice_batch(got, p * 8 * cap, 8 * cap))
        nlive = block.num_rows_host()
        assert device_to_host(slice_batch(block, 0, max(nlive, 1))) \
            .slice(0, nlive).to_pylist() == want[p]


# ---------------------------------------------------------------------------
# spark.rapids.tpu.exchange.mode
# ---------------------------------------------------------------------------

def test_exchange_mode_conf_selects_transport():
    """exchange.mode=host pins ICI plans to the host transport;
    compiled (and auto) keep the collective."""
    from spark_rapids_tpu_torch.sql.session import TpuSession
    rng = np.random.default_rng(2)
    t = pa.table({"k": pa.array(rng.integers(0, 50, 2000)),
                  "v": pa.array(rng.uniform(0, 1, 2000))})

    def tree_for(mode):
        s = TpuSession({"spark.rapids.shuffle.mode": "ICI",
                        "spark.rapids.tpu.exchange.mode": mode},
                       device="cpu")
        df = s.createDataFrame(t).repartition(8, "k")
        df.toArrow()
        return df._last_plan.tree_string()

    host_tree = tree_for("host")
    assert "TpuHostShuffleExchange" in host_tree, host_tree
    assert "TpuIciShuffleExchange" not in host_tree, host_tree
    assert "TpuIciShuffleExchange" in tree_for("compiled")
    assert "TpuIciShuffleExchange" in tree_for("auto")


def test_exchange_mode_host_matches_compiled_results():
    """End to end: the two modes return the same aggregate answer, and
    the JAX package's host mode the same one."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession as JaxSession
    from spark_rapids_tpu.utils.datagen import skewed_null_table
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.session import TpuSession
    t = skewed_null_table(3000, seed=1)

    def run(session, F):
        import math
        rows = (session.createDataFrame(t).groupBy("k")
                .agg(F.sum("v").alias("sv"), F.count("*").alias("c"))
                .toArrow().to_pylist())

        def norm(v):
            if v is None:
                return "null"
            return "nan" if math.isnan(v) else round(v, 9)

        return sorted((r["k"], r["c"], norm(r["sv"])) for r in rows)

    def conf(mode):
        return {"spark.rapids.shuffle.mode": "ICI",
                "spark.rapids.tpu.exchange.mode": mode}

    compiled = run(TpuSession(conf("compiled"), device="cpu"), F)
    assert compiled == run(TpuSession(conf("host"), device="cpu"), F)
    assert compiled == run(JaxSession(conf("host")), JF)
