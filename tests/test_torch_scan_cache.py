"""The port's device-resident scan cache (``exec/basic.py``) and the
narrowed-table memo (``plan/optimizer.py::_narrow_table``) that lets it
hit, at the oracle scale (``bench.gen_tpch(0.002)``; 0.01 for q2, q7 and
q11 in the aliasing guard).

Results must be equal with and without the cache and equal the JAX
package's under ``bench._rows_equal(tol=1e-6)``; a second run adds no
``transferTime``; an entry dies with its table; the first put wins;
an injected OOM at registration only means "not cached"; a ``RetryOOM``
on restore streams the rest of the table without repeating rows; a tiny
``poolSize`` makes the joins' working-set reservations spill cache
entries to host in both packages with equal results.  The aliasing
guard runs every TPC-H builder twice over one set of tables and holds
every tensor of every cache entry unchanged between the runs: cached
tensors are shared by all later queries, so an in-place write anywhere
downstream would corrupt them.
"""

import gc
import hashlib

import pyarrow as pa
import pytest
import torch

import bench

from spark_rapids_tpu.exec import basic as JB
from spark_rapids_tpu.plan import optimizer as JO
from spark_rapids_tpu.runtime import memory as JM
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.plan import optimizer as O
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.sql.session import TpuSession
from spark_rapids_tpu_torch.utils import tpch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tables: torch's intra-op threads only oversubscribe the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.002


@pytest.fixture(autouse=True)
def _fresh_cache():
    for mgr, cache in ((M, B), (JM, JB)):
        mgr.reset_manager()
        cache.clear_scan_cache()
    yield
    for mgr, cache in ((M, B), (JM, JB)):
        mgr.reset_manager()
        cache.clear_scan_cache()


@pytest.fixture(scope="module")
def tables():
    return bench.gen_tpch(SF)


def _port(query, session, t):
    return getattr(tpch, query)(session, t["lineitem"] if query in (
        "q1", "q6") else t)


def _transfer_times(df):
    return [m.get("transferTime", 0.0) for name, m in df.metrics()
            if name == "TpuScanExec"]


def _scan_rows(df):
    return [m.get("numOutputRows", 0) for name, m in df.metrics()
            if name == "TpuScanExec"]


@pytest.mark.parametrize("query", ["q1", "q3", "q13"])
def test_results_equal_with_and_without_the_cache(tables, query):
    session = TpuSession(device="cpu")
    cold = _port(query, session, tables)
    got_cold = cold.toArrow()
    assert all(t > 0 for t in _transfer_times(cold))
    assert B._scan_cache
    warm = _port(query, session, tables)
    got_warm = warm.toArrow()
    # every scan hit the cache: no host-to-device transfer at all
    assert _transfer_times(warm) and all(
        t == 0 for t in _transfer_times(warm))
    assert _scan_rows(warm) == _scan_rows(cold)
    B.clear_scan_cache()
    assert not B._scan_cache
    got_uncached = _port(query, session, tables).toArrow()
    want = getattr(bench, query)(JaxSession({}), tables).toArrow()
    assert got_cold.equals(got_warm) and got_cold.equals(got_uncached)
    assert got_cold.schema == want.schema
    assert bench._rows_equal(got_cold, want, tol=1e-6)


def test_entry_dies_with_its_table(tables):
    li = tables["lineitem"].slice(0, 3000).combine_chunks()
    memo = len(O._narrow_memo)
    session = TpuSession(device="cpu")
    df = tpch.q1(session, li)
    df.toArrow()
    assert len(B._scan_cache) == 1 and len(O._narrow_memo) == memo + 1
    mgr = M.get_manager()
    assert mgr._reserved > 0
    del df, li
    gc.collect()
    assert not B._scan_cache and len(O._narrow_memo) == memo
    assert mgr._reserved == 0 and not mgr._spillables


def _closed(sp) -> bool:
    """Closed: no copy on any tier (reported as "disk" with no file, as
    the JAX package's manager reports it)."""
    return sp.tier == "disk" and sp._disk_path is None


def test_first_put_wins():
    mgr = M.get_manager(device="cpu")
    t = pa.table({"a": pa.array(range(10))})
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    first = M.SpillableBatch(host_to_device(t, torch.device("cpu")), mgr)
    second = M.SpillableBatch(host_to_device(t, torch.device("cpu")), mgr)
    B._scan_cache_put(t, "k", [(first, 10)])
    B._scan_cache_put(t, "k", [(second, 10)])
    assert B._scan_cache_get(t, "k") == [(first, 10)]
    assert first.tier == "device" and _closed(second)
    assert mgr._reserved == first.nbytes
    B.clear_scan_cache()
    assert _closed(first) and mgr._reserved == 0


def test_narrow_table_is_memoized_like_jax(tables):
    li = tables["lineitem"]
    for memo in (O._narrow_table, JO._narrow_table):
        a = memo(li, ("l_orderkey", "l_tax"))
        assert memo(li, ("l_orderkey", "l_tax")) is a
        assert memo(li, ("l_tax",)) is not a
        assert a.column_names == ["l_orderkey", "l_tax"]
    # each run of q3 rebuilds its DataFrame, and still hits the cache
    session = TpuSession(device="cpu")
    tpch.q3(session, tables).toArrow()
    n = len(B._scan_cache)
    tpch.q3(session, tables).toArrow()
    assert len(B._scan_cache) == n == 3


def test_injected_oom_at_registration_means_not_cached(tables):
    li = tables["lineitem"]
    conf = {"spark.rapids.tpu.batchRows": 4096,
            "spark.rapids.tpu.test.injectOomAtAlloc": 2}
    want = tpch.q6(TpuSession(device="cpu"), li).toArrow()
    B.clear_scan_cache()
    session = TpuSession(conf, device="cpu")
    df = tpch.q6(session, li)
    assert df.toArrow().equals(want)
    assert _scan_rows(df) == [li.num_rows]
    assert M.get_manager().metrics["retryOOMs"] == 1
    # the second registration failed: the first was closed, none cached
    assert not B._scan_cache and M.get_manager()._reserved == 0
    again = tpch.q6(session, li)
    assert again.toArrow().equals(want)
    assert all(t > 0 for t in _transfer_times(again))  # cached now
    warm = tpch.q6(session, li)
    assert warm.toArrow().equals(want)
    assert all(t == 0 for t in _transfer_times(warm))


def test_retry_oom_on_restore_streams_the_remainder(tables, monkeypatch):
    li = tables["lineitem"]
    session = TpuSession({"spark.rapids.tpu.batchRows": 2048},
                         device="cpu")
    want = tpch.q6(session, li).toArrow()
    (entries,) = B._scan_cache.values()
    (pairs,) = entries.values()
    assert len(pairs) == -(-li.num_rows // 2048) > 4
    mgr = M.get_manager()
    for sp, _ in pairs:
        sp.spill_to_host()
    # the third restore fails: two batches come from the cache, the
    # rest streams from the table, starting at the third batch (the
    # aggregate's own reservations in between do not count)
    calls = []
    reserve = mgr.reserve

    def third_fails(nbytes, _restoring=None):
        if _restoring is not None:
            calls.append(nbytes)
            if len(calls) == 3:
                raise M.RetryOOM("no room to restore")
        return reserve(nbytes, _restoring)

    monkeypatch.setattr(mgr, "reserve", third_fails)
    df = tpch.q6(session, li)
    got = df.toArrow()
    assert got.equals(want)
    assert _scan_rows(df) == [li.num_rows]
    assert mgr.metrics["restoredBytes"] == sum(sp.nbytes
                                               for sp, _ in pairs[:2])
    assert not B._scan_cache  # evicted, its registrations closed
    assert all(_closed(sp) for sp, _ in pairs)
    assert mgr._reserved == 0 and mgr._host_used == 0


def test_tiny_pool_spills_cache_entries_in_both_packages(tables, tmp_path):
    """q3's two joins reserve their working sets under a pool that holds
    about two of lineitem's three cached batches: registrations and the joins'
    transient reservations push the oldest entries to host, and a second
    run restores them."""
    # q3's lineitem batch: 4096 rows x (three 8-byte columns, a 4-byte
    # date and the 1-byte sel); the JAX package's largest working-set
    # reservation here is 1.52 batches (it raises above the whole pool)
    pool = 2 * 4096 * 29
    conf = {"spark.rapids.tpu.batchRows": 4096,
            "spark.rapids.tpu.memory.poolSize": pool,
            "spark.sql.autoBroadcastJoinThreshold": 0,
            "spark.rapids.tpu.join.targetRows": 1024}
    jax_conf = dict(conf, **{"spark.rapids.tpu.spillPath": str(tmp_path)})
    want = bench.q3(JaxSession(jax_conf), tables).toArrow()
    session = TpuSession(conf, device="cpu")
    got = tpch.q3(session, tables).toArrow()
    mgr = M.get_manager()
    assert mgr.budget == pool
    spilled = mgr.metrics["spillToHostBytes"]
    assert spilled > 0
    again = tpch.q3(session, tables)
    assert again.toArrow().equals(got)
    assert all(t == 0 for t in _transfer_times(again))
    assert mgr.metrics["restoredBytes"] > 0
    assert bench._rows_equal(got, want, tol=1e-6)
    assert JM.get_manager().metrics["spillToHostBytes"] > 0


def _checksums():
    """sha1 of every tensor of every cache entry (device tier)."""
    out = {}
    for tid, entries in B._scan_cache.items():
        for key, pairs in entries.items():
            for bi, (sp, _) in enumerate(pairs):
                b = sp.get()
                tensors = [b.sel] + [x for c in b.columns
                                     for x in (c.data, c.validity,
                                               c.lengths)
                                     if x is not None]
                out[tid, key, bi] = [
                    hashlib.sha1(x.contiguous().view(torch.uint8)
                                 .numpy().tobytes()).hexdigest()
                    for x in tensors]
    return out


def test_no_query_writes_into_a_cached_batch(tables):
    small = bench.gen_tpch(0.01)
    session = TpuSession(device="cpu")
    scale = {"q2": small, "q7": small, "q11": small}
    firsts, sums = {}, {}
    for q in tpch.QUERIES:
        firsts[q] = _port(q, session, scale.get(q, tables)).toArrow()
        # the entries this query created, right after it ran
        sums.update({k: v for k, v in _checksums().items()
                     if k not in sums})
    for q in tpch.QUERIES:
        df = _port(q, session, scale.get(q, tables))
        assert df.toArrow().equals(firsts[q]), q
        assert all(t == 0 for t in _transfer_times(df)), q
    assert _checksums() == sums
