#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero and the final
result line is not printed):

1. device — torch's device name, and ``nvidia-smi``'s name and power
   limit;
2. build — compiles the hand-written CUDA kernel(s) of the port from the
   sources in this checkout (``nvcc``, ``sm_90a``) and prints the build
   seconds and ``ptxas``' registers and spills of each specialisation;
3. kernels — calls each kernel's wrapper on tensors on the card at the
   shapes TPC-H q1 and the joins of q3 and q4 give it and at edge cases
   (odd n, limbs that are not 16-byte aligned, more limbs than one
   launch takes, two row sets in one launch), and holds the result
   against the kernel's plain PyTorch version on the same inputs, bit
   for bit.  A kernel's time is the median over launches timed by CUDA
   events, each launch after a 256 MB write that evicts the L2 cache
   and puts the host ahead of the device (``ms``, cold), and again back
   to back behind a device sleep (``ms_warm``); beside them the bound
   (bytes over the card's memory rate) and the plain version's time;
4. the fifteen TPC-H queries the port runs (q1, q6, q3, q4, q5, q7, q8,
   q10, q11, q12, q15, q17, q18, q19, q21) at SF1 (6,000,000 lineitem,
   1,500,000 orders, 150,000 customer, 200,000 part, 800,000 partsupp
   and 10,000 supplier rows, 25 nations, 5 regions) through the port's
   DataFrame API on ``device="cuda"`` — the main path, one query at a
   time: the kernel's launch counts are set to 0 just before each
   query and read just after, and the hash-collision fallback count
   must stay 0.  Each result is checked against an independent pyarrow
   computation (``ref_q*``: keys and counts exactly, floats within 1e-9
   relative) and against the exact ``jnp`` rung on the card; every
   join must take the strategy of the JAX package's plan at SF1
   (``check_strategies``, read from the joins' metrics); prints the
   median wall time of 3 warm runs per query, its H2D share and the
   kernel's launches;
5. the kernel at every shape the main path launched it with, timed as
   in phase 3 and by a ring of distinct inputs larger than the L2 cache
   (``ms_ring``, from which ``pct_of_bound`` is read), traced alone by
   ``torch.profiler`` after an L2-evicting write (``traced_ms``) and
   read (``traced_clean_ms``), called from a list of limbs through
   ``hash_layout.hash_limbs`` (``from_list_ms``), and at the join's
   shapes both sides in one launch (``pair_ms``, bit-identical to the
   plain version first, and traced) against two; and the wrappers'
   host time per call;
6. a JSON line of every kernel's numbers, the ``nvidia-smi`` line again,
   and last the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when CUDA is unavailable or the port's package is not
beside it.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SF = 1.0
# (L limbs, n rows): edge shapes, q1's aggregate (3, 2^20), and the
# join's build and probe sides (1, 2^18) and q4's probe side (1, 2^16)
KERNEL_SHAPES = [(n_limbs, n) for n_limbs in (1, 2, 3, 4)
                 for n in (1, 1024, 4095, 1 << 20, 6_000_001)] + [
                     (1, 1 << 18), (1, 1 << 16)]
MAIN_PATH_SHAPE = (3, 1 << 20)  # q1: flag limb + 128-bit key hash, 2^20 rows
# odd n (the vector path's scalar tail; rows of a stacked tensor that are
# not 16-byte aligned)
ODD_NS = (1, 3, 4095, (1 << 20) + 1)
# join sides hashed in one launch: q3's (build, probe) and q4's
JOIN_PAIRS = (((1, 1 << 18), (1, 1 << 18)), ((1, 1 << 18), (1, 1 << 16)))
QUERIES = ("q1", "q6", "q3", "q4", "q5", "q7", "q8", "q10", "q11", "q12",
           "q15", "q17", "q18", "q19", "q21")
FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
RING_BYTES = 128 << 20  # inputs of one ring pass: > 2x the L2
RING_LAUNCHES = 100
RING_MAX = 400  # ring entries at most (the launch queue holds ~1000)
GATE_CYCLES = 40_000_000  # device sleep that lets the host queue a run


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events recorded
    around the call, one synchronize per call: the host's own time in
    ``fn`` counts.  Used for the plain versions (many small kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class KernelTimer:
    """Times one kernel launch by CUDA events with the host ahead of the
    device, so that the wrapper's host work before the launch is not in
    the time (the method of ``triton.testing.do_bench``)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.scratch = torch.empty((FLUSH_BYTES // 4,), dtype=torch.int32,
                                   device=device)
        # about 50 ms of memory traffic first, so that the card has left
        # its idle clocks before the first timed launch
        for _ in range(500):
            self.scratch.zero_()
        torch.cuda.synchronize()

    def _median(self, pairs) -> float:
        self.torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def cold_ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        """Each launch after a 256 MB write: L2 holds none of the
        inputs, and the write keeps the device busy while the host
        queues the launch.  No synchronize inside the loop."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.scratch.zero_()
            a, b = self._events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        return self._median(pairs)

    def warm_ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        """The same input back to back (L2 warm), behind a device sleep
        that lets the host queue every launch first."""
        for _ in range(warmup):
            fn()
        self.torch.cuda.synchronize()
        self.torch.cuda._sleep(GATE_CYCLES)
        pairs = []
        for _ in range(iters):
            a, b = self._events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        return self._median(pairs)

    def ring_ms(self, make_input, fn, in_bytes: int) -> float:
        """Mean time of one launch over a run of launches between two
        events, cycling through a ring of distinct inputs made by
        ``make_input()`` whose bytes (``in_bytes`` each) pass 2x the L2
        cache, so that no launch finds its input there: 100 launches, or
        one pass of the ring where the ring is longer.  The ring has at
        most ``RING_MAX`` entries, so below about 320 KB of input per
        launch it does not pass the L2 cache twice.  Every launch's
        output is kept, so that each writes memory of its own (one
        output block reused would let its writes stay in L2); an untimed
        run first fills the allocator's cache with those blocks.  A
        device sleep lets the host queue every launch first."""
        torch = self.torch
        n_ring = min(RING_MAX, max(2, math.ceil(RING_BYTES / in_bytes)))
        ring = [make_input() for _ in range(n_ring)]
        n_launch = max(RING_LAUNCHES, n_ring)
        kept = [fn(ring[i % n_ring]) for i in range(n_launch)]
        del kept
        torch.cuda.synchronize()
        torch.cuda._sleep(GATE_CYCLES)
        a, b = self._events()
        a.record()
        kept = [fn(ring[i % n_ring]) for i in range(n_launch)]
        b.record()
        b.synchronize()
        del kept
        return a.elapsed_time(b) / n_launch

    def host_us(self, fn, calls: int = 1000, chunk: int = 250) -> float:
        """The host's microseconds per call of ``fn``: ``calls`` calls in
        chunks of ``chunk``, each chunk timed by ``perf_counter`` behind a
        device sleep, so that the device never holds the host back."""
        torch = self.torch
        fn()
        total = 0.0
        for _ in range(calls // chunk):
            torch.cuda.synchronize()
            torch.cuda._sleep(5 * GATE_CYCLES)
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / (calls // chunk * chunk) * 1e6


def kernel_bound_ms(n_limbs: int, n: int) -> float:
    """Least time for hash_pairs: read L x n int64 limbs once, write n
    int64 hashes once, at the card's memory rate."""
    return (8 * n_limbs + 8) * n / H100_BYTES_PER_S * 1e3


def random_limbs(n_limbs: int, n: int, gen, dev):
    """Uniform 64-bit patterns (half with the top bit set), then the top
    bit forced on every other row."""
    import torch
    limbs = torch.randint(0, 256, (n_limbs, n, 8), dtype=torch.uint8,
                          device=dev, generator=gen).view(
                              torch.int64).squeeze(-1)
    limbs[:, ::2] |= -(1 << 63)
    return limbs


def hash_bytes(shapes) -> int:
    """Bytes that hash_pairs must move for row sets of ``(L, n)``."""
    return sum((8 * n_limbs + 8) * n for n_limbs, n in shapes)


def check_hash(CB, sets, name: str) -> None:
    """``hash_pairs_multi`` on ``sets`` (each an [L, n] tensor or a list
    of limbs on the card) equals the plain version bit for bit, in
    ceil(max L / LIMB_CAP) launches."""
    import torch
    before = CB.launches
    got = CB.hash_pairs_multi(sets)
    want = [CB.hash_pairs_plain(s) for s in sets]
    torch.cuda.synchronize()
    n_limbs = [len(s) for s in sets]
    check(CB.launches - before == -(-max(n_limbs) // CB.LIMB_CAP),
          f"{name}: {CB.launches - before} launches")
    for g, w in zip(got, want):
        mismatches = int((g != w).sum())
        check(mismatches == 0, f"hash_pairs {name}: {mismatches} rows "
              f"differ from the plain version")


def kernel_cases(CB, gen, dev):
    """The kernel against its plain version beyond the timed shapes:
    ``(name, sets)`` of every edge case, made one at a time."""
    for n_limbs in (1, 2, 3, 4):
        for n in ODD_NS:
            stacked = random_limbs(n_limbs, n, gen, dev)
            # rows of a stacked tensor with odd n: not 16-byte aligned
            yield (f"odd n, stacked L={n_limbs} n={n}", [stacked])
            # separate limbs: aligned, with a one-row tail
            yield (f"odd n, list L={n_limbs} n={n}",
                   [[l.clone() for l in stacked]])
        big = random_limbs(n_limbs, (1 << 18) + 1, gen, dev)
        yield (f"misaligned row views L={n_limbs} n=2^18",
               [[l[1:] for l in big]])
    for n_limbs in (CB.LIMB_CAP + 1, 2 * CB.LIMB_CAP + 1):
        for n in (4095, 1 << 20):
            yield (f"chained L={n_limbs} n={n}",
                   [random_limbs(n_limbs, n, gen, dev)])
    for (la, na), (lb, nb) in JOIN_PAIRS + (
            ((3, 1 << 20), (2, 4095)), ((CB.LIMB_CAP + 1, 1000), (1, 1 << 18))):
        yield (f"two sets L={la} n={na} + L={lb} n={nb}",
               [list(random_limbs(la, na, gen, dev)),
                random_limbs(lb, nb, gen, dev)])


def kernel_line(CB, timer, limbs, timed: bool) -> dict:
    """Bit-identity of the kernel against its plain version on
    ``limbs``; with ``timed``, the cold/warm kernel times, the bound and
    the plain version's time."""
    n_limbs, n = limbs.shape
    check_hash(CB, [limbs], f"L={n_limbs} n={n}")
    line = {"L": n_limbs, "n": n, "bit_identical": True,
            "bound_ms": kernel_bound_ms(n_limbs, n)}
    if timed:
        line["ms"] = timer.cold_ms(lambda: CB.hash_pairs(limbs))
        line["ms_warm"] = timer.warm_ms(lambda: CB.hash_pairs(limbs))
        line["plain_ms"] = cuda_ms(lambda: CB.hash_pairs_plain(limbs),
                                   iters=5)
    return line


def ptxas_summary(text: str) -> dict:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``'s
    report, by specialisation: ``L1``..``L4`` and the generic
    ``L<=8``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            t = re.search(r"hash_pairs_kernelILi(\d+)E", m.group(1))
            name = ("unknown" if t is None else
                    "L<=8" if t.group(1) == "0" else f"L{t.group(1)}")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# independent reference: pyarrow compute
# ---------------------------------------------------------------------------

def _date(y, m, d):
    import pyarrow as pa
    return pa.scalar(datetime.date(y, m, d), pa.date32())


def ref_q1(li):
    import pyarrow as pa
    import pyarrow.compute as pc
    f = li.filter(pc.less_equal(li["l_shipdate"], _date(1998, 9, 2)))
    disc = pc.multiply(f["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), f["l_discount"]))
    charge = pc.multiply(disc, pc.add(pa.scalar(1.0), f["l_tax"]))
    t = pa.table({"l_returnflag": f["l_returnflag"],
                  "l_linestatus": f["l_linestatus"],
                  "q": f["l_quantity"], "p": f["l_extendedprice"],
                  "dp": disc, "ch": charge, "d": f["l_discount"]})
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate(
        [("q", "sum"), ("p", "sum"), ("dp", "sum"), ("ch", "sum"),
         ("q", "mean"), ("p", "mean"), ("d", "mean"), ("q", "count")])
    names = ["sum_qty", "sum_base", "sum_disc", "sum_charge", "avg_qty",
             "avg_price", "avg_disc", "cnt"]
    aggs = ["q_sum", "p_sum", "dp_sum", "ch_sum", "q_mean", "p_mean",
            "d_mean", "q_count"]
    return pa.table([g["l_returnflag"], g["l_linestatus"]]
                    + [g[a] for a in aggs],
                    names=["l_returnflag", "l_linestatus"] + names)


def ref_q6(li):
    import pyarrow as pa
    import pyarrow.compute as pc
    m = pc.and_(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
        pc.less(li["l_shipdate"], _date(1995, 1, 1))),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.05),
                        pc.less_equal(li["l_discount"], 0.07)),
                pc.less(li["l_quantity"], 24.0)))
    f = li.filter(m)
    rev = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"]))
    return pa.table({"revenue": pa.array([rev.as_py()], pa.float64())})


def ref_q3(t):
    """q3 by pyarrow's hash join and group-by."""
    import pyarrow as pa
    import pyarrow.compute as pc
    cut = _date(1995, 3, 15)
    c = t["customer"]
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING")).select(
        ["c_custkey"])
    o = t["orders"]
    o = o.filter(pc.less(o["o_orderdate"], cut)).select(
        ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    li = t["lineitem"]
    li = li.filter(pc.greater(li["l_shipdate"], cut))
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": pc.multiply(
        li["l_extendedprice"], pc.subtract(pa.scalar(1.0),
                                           li["l_discount"]))})
    j = c.join(o, keys="c_custkey", right_keys="o_custkey",
               join_type="inner")
    j = j.join(li, keys="o_orderkey", right_keys="l_orderkey",
               join_type="inner")
    g = j.group_by(["o_orderkey", "o_orderdate", "o_shippriority"]
                   ).aggregate([("rev", "sum")])
    g = g.sort_by([("rev_sum", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 10)
    return pa.table([g["o_orderkey"], g["o_orderdate"],
                     g["o_shippriority"], g["rev_sum"]],
                    names=["o_orderkey", "o_orderdate", "o_shippriority",
                           "revenue"])


def ref_q4(t):
    """q4 by pyarrow: the semi join as membership in the set of
    qualifying lineitem order keys."""
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 7, 1)),
        pc.less(o["o_orderdate"], _date(1993, 10, 1))))
    li = t["lineitem"]
    li = li.filter(pc.less(li["l_commitdate"], li["l_receiptdate"]))
    o = o.filter(pc.is_in(o["o_orderkey"],
                          value_set=pc.unique(li["l_orderkey"])))
    g = o.group_by("o_orderpriority").aggregate(
        [("o_orderkey", "count")]).sort_by("o_orderpriority")
    return pa.table([g["o_orderpriority"], g["o_orderkey_count"]],
                    names=["o_orderpriority", "order_count"])


def _rev(t):
    """``l_extendedprice * (1 - l_discount)`` of a lineitem table."""
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), t["l_discount"]))


def _between(c, lo, hi):
    import pyarrow.compute as pc
    return pc.and_(pc.greater_equal(c, lo), pc.less_equal(c, hi))


def _in(c, *values):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.is_in(c, value_set=pa.array(values))


def _year(c):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.cast(pc.year(c), pa.int32())


def ref_q5(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    r = t["region"]
    r = r.filter(pc.equal(r["r_name"], "ASIA")).select(["r_regionkey"])
    n = t["nation"].select(["n_nationkey", "n_regionkey", "n_name"])
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1994, 1, 1)),
        pc.less(o["o_orderdate"], _date(1995, 1, 1)))).select(
        ["o_orderkey", "o_custkey"])
    li = t["lineitem"]
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": _rev(li)})
    j = r.join(n, "r_regionkey", "n_regionkey", join_type="inner")
    j = j.join(t["customer"].select(["c_custkey", "c_nationkey"]),
               "n_nationkey", "c_nationkey", join_type="inner")
    j = j.join(o, "c_custkey", "o_custkey", join_type="inner")
    j = j.join(li, "o_orderkey", "l_orderkey", join_type="inner")
    g = j.group_by("n_name").aggregate([("rev", "sum")])
    return pa.table([g["n_name"], g["rev_sum"]],
                    names=["n_name", "revenue"])


def ref_q7(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    na, nb = "NATION_06", "NATION_07"
    n = t["nation"]
    n = n.filter(_in(n["n_name"], na, nb)).select(["n_nationkey",
                                                   "n_name"])
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n.rename_columns(["n1_key", "supp_nation"]), "s_nationkey",
        "n1_key", join_type="inner")
    cust = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n.rename_columns(["n2_key", "cust_nation"]), "c_nationkey",
        "n2_key", join_type="inner")
    o = t["orders"].select(["o_orderkey", "o_custkey"]).join(
        cust, "o_custkey", "c_custkey", join_type="inner")
    li = t["lineitem"]
    li = li.filter(_between(li["l_shipdate"], _date(1995, 1, 1),
                            _date(1996, 12, 31)))
    li = pa.table({"l_orderkey": li["l_orderkey"],
                   "l_suppkey": li["l_suppkey"],
                   "l_year": _year(li["l_shipdate"]), "volume": _rev(li)})
    j = li.join(o, "l_orderkey", "o_orderkey", join_type="inner")
    j = j.join(supp, "l_suppkey", "s_suppkey", join_type="inner")
    j = j.filter(pc.or_(
        pc.and_(pc.equal(j["supp_nation"], na),
                pc.equal(j["cust_nation"], nb)),
        pc.and_(pc.equal(j["supp_nation"], nb),
                pc.equal(j["cust_nation"], na))))
    g = j.group_by(["supp_nation", "cust_nation", "l_year"]).aggregate(
        [("volume", "sum")])
    return pa.table([g["supp_nation"], g["cust_nation"], g["l_year"],
                     g["volume_sum"]],
                    names=["supp_nation", "cust_nation", "l_year",
                           "revenue"])


def ref_q8(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    p = t["part"]
    p = p.filter(pc.equal(p["p_type"], "ECONOMY ANODIZED STEEL")).select(
        ["p_partkey"])
    o = t["orders"]
    o = o.filter(_between(o["o_orderdate"], _date(1995, 1, 1),
                          _date(1996, 12, 31)))
    o = pa.table({"o_orderkey": o["o_orderkey"],
                  "o_custkey": o["o_custkey"],
                  "o_year": _year(o["o_orderdate"])})
    r = t["region"]
    r = r.filter(pc.equal(r["r_name"], "AMERICA")).select(["r_regionkey"])
    n1 = t["nation"].select(["n_nationkey", "n_regionkey"]).join(
        r, "n_regionkey", "r_regionkey", join_type="inner")
    cust = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n1, "c_nationkey", "n_nationkey", join_type="inner")
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        t["nation"].select(["n_nationkey", "n_name"]), "s_nationkey",
        "n_nationkey", join_type="inner")
    li = t["lineitem"]
    li = pa.table({"l_orderkey": li["l_orderkey"],
                   "l_partkey": li["l_partkey"],
                   "l_suppkey": li["l_suppkey"], "volume": _rev(li)})
    j = (li.join(p, "l_partkey", "p_partkey", join_type="inner")
         .join(o, "l_orderkey", "o_orderkey", join_type="inner")
         .join(cust, "o_custkey", "c_custkey", join_type="inner")
         .join(supp, "l_suppkey", "s_suppkey", join_type="inner"))
    nat = pc.if_else(pc.equal(j["n_name"], "NATION_05"), j["volume"], 0.0)
    j = pa.table({"o_year": j["o_year"], "nat": nat,
                  "volume": j["volume"]})
    g = j.group_by("o_year").aggregate([("nat", "sum"),
                                        ("volume", "sum")])
    return pa.table([g["o_year"], pc.divide(g["nat_sum"],
                                            g["volume_sum"])],
                    names=["o_year", "mkt_share"])


def ref_q10(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    o = t["orders"]
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 10, 1)),
        pc.less(o["o_orderdate"], _date(1994, 1, 1)))).select(
        ["o_orderkey", "o_custkey"])
    li = t["lineitem"]
    li = li.filter(pc.equal(li["l_returnflag"], "R"))
    li = pa.table({"l_orderkey": li["l_orderkey"], "rev": _rev(li)})
    j = (t["customer"].select(["c_custkey", "c_nationkey", "c_name",
                               "c_acctbal"])
         .join(o, "c_custkey", "o_custkey", join_type="inner")
         .join(li, "o_orderkey", "l_orderkey", join_type="inner")
         .join(t["nation"].select(["n_nationkey", "n_name"]),
               "c_nationkey", "n_nationkey", join_type="inner"))
    g = j.group_by(["c_custkey", "c_name", "c_acctbal", "n_name"]
                   ).aggregate([("rev", "sum")])
    g = g.sort_by([("rev_sum", "descending")]).slice(0, 20)
    return pa.table([g["c_custkey"], g["c_name"], g["c_acctbal"],
                     g["n_name"], g["rev_sum"]],
                    names=["c_custkey", "c_name", "c_acctbal", "n_name",
                           "revenue"])


def ref_q11(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    n = t["nation"]
    n = n.filter(pc.equal(n["n_name"], "NATION_07")).select(
        ["n_nationkey"])
    supp = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n, "s_nationkey", "n_nationkey", join_type="inner")
    ps = t["partsupp"].join(supp, "ps_suppkey", "s_suppkey", join_type="inner")
    ps = pa.table({"ps_partkey": ps["ps_partkey"], "val": pc.multiply(
        ps["ps_supplycost"], pc.cast(ps["ps_availqty"], pa.float64()))})
    tot = pc.sum(ps["val"]).as_py() or 0.0
    g = ps.group_by("ps_partkey").aggregate([("val", "sum")])
    g = g.filter(pc.greater(g["val_sum"], 0.0001 * tot))
    return pa.table([g["ps_partkey"], g["val_sum"]],
                    names=["ps_partkey", "value"])


def ref_q12(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(pc.and_(pc.and_(
        _in(li["l_shipmode"], "MAIL", "SHIP"),
        pc.greater_equal(li["l_receiptdate"], _date(1994, 1, 1))),
        pc.and_(pc.less(li["l_receiptdate"], _date(1995, 1, 1)),
                pc.less(li["l_commitdate"], li["l_receiptdate"]))),
        pc.less(li["l_shipdate"], li["l_commitdate"]))).select(
        ["l_orderkey", "l_shipmode"])
    j = li.join(t["orders"].select(["o_orderkey", "o_orderpriority"]),
                "l_orderkey", "o_orderkey", join_type="inner")
    high = pc.cast(_in(j["o_orderpriority"], "1-URGENT", "2-HIGH"),
                   pa.int64())
    j = pa.table({"l_shipmode": j["l_shipmode"], "high": high,
                  "low": pc.subtract(1, high)})
    g = j.group_by("l_shipmode").aggregate([("high", "sum"),
                                            ("low", "sum")])
    return pa.table([g["l_shipmode"], g["high_sum"], g["low_sum"]],
                    names=["l_shipmode", "high_line_count",
                           "low_line_count"])


def ref_q15(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1996, 1, 1)),
        pc.less(li["l_shipdate"], _date(1996, 4, 1))))
    rev = pa.table({"supplier_no": li["l_suppkey"], "rev": _rev(li)})
    g = rev.group_by("supplier_no").aggregate([("rev", "sum")])
    top = g.filter(pc.greater_equal(g["rev_sum"], pc.max(g["rev_sum"])))
    supp = t["supplier"].select(["s_suppkey", "s_name", "s_address",
                                 "s_phone"])
    j = supp.join(top, "s_suppkey", "supplier_no", join_type="inner")
    return pa.table([j["s_suppkey"], j["s_name"], j["s_address"],
                     j["s_phone"], j["rev_sum"]],
                    names=["s_suppkey", "s_name", "s_address", "s_phone",
                           "total_revenue"])


def ref_q17(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    p = t["part"]
    p = p.filter(pc.and_(pc.equal(p["p_brand"], "Brand#23"),
                         pc.equal(p["p_container"], "MED BOX")))
    li = t["lineitem"].select(["l_partkey", "l_quantity",
                               "l_extendedprice"])
    li = li.filter(pc.is_in(li["l_partkey"], value_set=p["p_partkey"]))
    avg = li.group_by("l_partkey").aggregate([("l_quantity", "mean")])
    j = li.join(avg, "l_partkey", join_type="inner")
    j = j.filter(pc.less(j["l_quantity"],
                         pc.multiply(0.2, j["l_quantity_mean"])))
    s = pc.sum(j["l_extendedprice"]).as_py()
    return pa.table({"avg_yearly": pa.array(
        [None if s is None else s / 7.0], pa.float64())})


def ref_q18(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"].select(["l_orderkey", "l_quantity"])
    g = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = g.filter(pc.greater(g["l_quantity_sum"], 300.0))["l_orderkey"]
    o = t["orders"].select(["o_orderkey", "o_custkey", "o_orderdate",
                            "o_totalprice"])
    o = o.filter(pc.is_in(o["o_orderkey"], value_set=big))
    j = (t["customer"].select(["c_custkey", "c_name"])
         .join(o, "c_custkey", "o_custkey", join_type="inner")
         .join(li, "o_orderkey", "l_orderkey", join_type="inner"))
    g = j.group_by(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"]).aggregate([("l_quantity", "sum")])
    g = g.sort_by([("o_totalprice", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 100)
    return pa.table([g["c_name"], g["c_custkey"], g["o_orderkey"],
                     g["o_orderdate"], g["o_totalprice"],
                     g["l_quantity_sum"]],
                    names=["c_name", "c_custkey", "o_orderkey",
                           "o_orderdate", "o_totalprice", "sum_qty"])


def ref_q19(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"]
    li = li.filter(pc.and_(_in(li["l_shipmode"], "AIR", "REG AIR"),
                           pc.equal(li["l_shipinstruct"],
                                    "DELIVER IN PERSON")))
    li = pa.table({"l_partkey": li["l_partkey"],
                   "l_quantity": li["l_quantity"], "rev": _rev(li)})
    p = t["part"].select(["p_partkey", "p_brand", "p_container",
                          "p_size"])
    j = li.join(p, "l_partkey", "p_partkey", join_type="inner")

    def arm(brand, containers, qlo, qhi, shi):
        return pc.and_(pc.and_(pc.equal(j["p_brand"], brand),
                               _in(j["p_container"], *containers)),
                       pc.and_(_between(j["l_quantity"], qlo, qhi),
                               _between(j["p_size"], 1, shi)))

    m = pc.or_(pc.or_(
        arm("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
            1.0, 11.0, 5),
        arm("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
            10.0, 20.0, 10)),
        arm("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
            20.0, 30.0, 15))
    s = pc.sum(j.filter(m)["rev"]).as_py()
    return pa.table({"revenue": pa.array([s], pa.float64())})


def ref_q21(t):
    import pyarrow as pa
    import pyarrow.compute as pc
    li = t["lineitem"].select(["l_orderkey", "l_suppkey", "l_commitdate",
                               "l_receiptdate"])
    late = li.filter(pc.greater(li["l_receiptdate"], li["l_commitdate"])
                     ).select(["l_orderkey", "l_suppkey"])
    def ndistinct(t, key, name):
        g = t.group_by("l_orderkey").aggregate(
            [("l_suppkey", "count_distinct")])
        return pa.table({key: g["l_orderkey"],
                         name: g["l_suppkey_count_distinct"]})

    allcnt = ndistinct(li, "ak", "nsupp")
    latecnt = ndistinct(late, "lk", "nlate")
    o = t["orders"]
    fo = o.filter(pc.equal(o["o_orderstatus"], "F"))["o_orderkey"]
    n = t["nation"]
    n = n.filter(pc.equal(n["n_name"], "NATION_10")).select(
        ["n_nationkey"])
    supp = t["supplier"].select(["s_suppkey", "s_name", "s_nationkey"])
    supp = supp.join(n, "s_nationkey", "n_nationkey", join_type="inner")
    j = late.filter(pc.is_in(late["l_orderkey"], value_set=fo))
    j = j.join(allcnt, "l_orderkey", "ak", join_type="inner")
    j = j.join(latecnt, "l_orderkey", "lk", join_type="inner")
    j = j.filter(pc.and_(pc.greater_equal(j["nsupp"], 2),
                         pc.equal(j["nlate"], 1)))
    j = j.join(supp, "l_suppkey", "s_suppkey", join_type="inner")
    g = j.group_by("s_name").aggregate([("l_orderkey", "count")])
    g = g.sort_by([("l_orderkey_count", "descending"),
                   ("s_name", "ascending")]).slice(0, 100)
    return pa.table([g["s_name"], g["l_orderkey_count"]],
                    names=["s_name", "numwait"])


def rows_equal(a, b, tol=1e-9):
    """Row multiset equality: floats within ``tol`` relative (absolute
    below 1), everything else exactly — the repository's oracle rule."""
    la = [tuple(r.values()) for r in a.to_pylist()]
    lb = [tuple(r.values()) for r in b.to_pylist()]
    if len(la) != len(lb):
        return False
    for x, y in zip(sorted(la, key=repr), sorted(lb, key=repr)):
        for u, v in zip(x, y):
            if isinstance(u, float) and isinstance(v, float):
                if abs(u - v) > tol * max(1.0, abs(u), abs(v)):
                    return False
            elif u != v:
                return False
    return True


def phase_times(df) -> dict:
    """H2D and D2H seconds of the last run, from the plan's metrics."""
    out = {"h2d_s": 0.0, "d2h_s": 0.0}
    for name, m in df.metrics():
        if name == "TpuScanExec":
            out["h2d_s"] += m.get("transferTime", 0.0)
        elif name == "DeviceToHostExec":
            out["d2h_s"] += m.get("transferTime", 0.0)
    return out


def join_strategies(df) -> list:
    """Each join of the last run's plan, root first: its type, planned
    broadcast side, and the run-time strategy metrics."""
    out = []

    def walk(node):
        if type(node).__name__ == "TpuSortMergeJoinExec":
            m = {k: v.value for k, v in node.metrics.items()}
            out.append({"join_type": node.join_type,
                        "broadcast": node.broadcast,
                        "streamedJoins": m.get("streamedJoins", 0),
                        "streamedLeftGroups": m.get(
                            "streamedLeftGroups", 0),
                        "streamedRightGroups": m.get(
                            "streamedRightGroups", 0),
                        "subPartitionJoins": m.get(
                            "subPartitionJoins", 0)})
        for c in node.children:
            walk(c)

    walk(df._last_plan)
    return out


# The JAX package's single-process plan at SF1, root join first (its
# exec/join.py::_convert_join broadcasts a side whose estimated size is
# within autoBroadcastJoinThreshold, 10 MB; TpuSortMergeJoinExec.execute
# then picks by live rows against join.targetRows, 2^18).  "bc right" /
# "bc left": the broadcast side; "streamed left" / "streamed right":
# the side cut into groups against the other, whole side; "sub": both
# sides over the row cap, hash sub-partitioned; "in-core": one join of
# both sides; "cross": the in-core cross product.  A "semi" prefix is a
# left semi join (every other join here is inner or cross).  q21's semi
# join with orders is "sub": orders narrowed to (o_orderkey,
# o_orderstatus) is ~19 MB by estimate, and both its 5.2 M late
# lineitems and ~0.74 M finished orders pass 2^18 live rows.
STRATEGIES = {
    "q5": ("streamed right", "in-core", "bc right", "bc right"),
    "q7": ("in-core", "streamed left", "streamed left", "bc right",
           "bc right"),
    "q8": ("bc right",) * 5 + ("streamed right", "bc right"),
    "q10": ("bc right", "streamed right", "bc left"),
    "q11": ("cross", "streamed left", "bc right", "streamed left",
            "bc right"),
    "q12": ("streamed right",),
    "q15": ("bc right", "cross"),
    "q17": ("in-core", "semi bc right", "semi bc right"),
    "q18": ("streamed right", "bc left", "semi streamed left"),
    "q19": ("bc right",),
    "q21": ("in-core", "sub", "sub", "semi sub", "bc right"),
}


def _strategy_holds(want: str, j: dict) -> bool:
    jt = "inner"
    if want.startswith("semi "):
        jt, want = "left_semi", want[len("semi "):]
    if want == "cross":
        jt = "cross"
    if j["join_type"] != jt:
        return False
    streamed = (j["streamedJoins"], j["streamedLeftGroups"] > 0,
                j["streamedRightGroups"] > 0)
    if want.startswith("bc "):
        return (j["broadcast"] == want[3:] and j["streamedJoins"] == 0
                and j["subPartitionJoins"] == 0)
    if j["broadcast"] is not None:
        return False
    if want == "streamed left":
        return streamed == (1, True, False) and not j["subPartitionJoins"]
    if want == "streamed right":
        return streamed == (1, False, True) and not j["subPartitionJoins"]
    if want == "sub":
        return streamed == (0, False, False) and j["subPartitionJoins"] == 1
    return (streamed == (0, False, False)  # in-core, cross
            and j["subPartitionJoins"] == 0)


def check_strategies(q: str, joins: list) -> None:
    """The JAX package's single-process plan at SF1 (exec/join.py::
    _convert_join and TpuSortMergeJoinExec.execute)."""
    if q == "q3":
        check(len(joins) == 2, f"q3 has {len(joins)} joins")
        outer, inner = joins
        # customer (~3 MB narrowed) fits autoBroadcastJoinThreshold:
        # broadcast left, orders streamed in groups of targetRows
        check(inner["broadcast"] == "left"
              and inner["streamedRightGroups"] > 0
              and inner["streamedJoins"] == 0,
              f"q3 customer x orders strategy {inner}")
        # no side small by estimate; at run time the left side's live
        # rows fit targetRows: left whole, lineitem streamed
        check(outer["broadcast"] is None and outer["streamedJoins"] == 1
              and outer["streamedRightGroups"] > 0
              and outer["streamedLeftGroups"] == 0,
              f"q3 x lineitem strategy {outer}")
    elif q == "q4":
        check(len(joins) == 1, f"q4 has {len(joins)} joins")
        (semi,) = joins
        # left small at run time, semi join: _semi_stream_right
        check(semi["join_type"] == "left_semi"
              and semi["broadcast"] is None and semi["streamedJoins"] == 1
              and semi["streamedRightGroups"] > 0
              and semi["streamedLeftGroups"] == 0,
              f"q4 strategy {semi}")
    elif q in STRATEGIES:
        want = STRATEGIES[q]
        check(len(joins) == len(want), f"{q} has {len(joins)} joins")
        for i, (w, j) in enumerate(zip(want, joins)):
            check(_strategy_holds(w, j),
                  f"{q} join {i} (root first): want {w}, got {j}")
    else:
        check(not joins, f"{q} has joins")


def main() -> int:
    import numpy as np
    import pyarrow as pa
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is unavailable (torch "
              f"{torch.__version__}); this test needs a CUDA card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from spark_rapids_tpu_torch import kernels as KN
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import profile as PR
    from spark_rapids_tpu_torch.utils import tpch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[device] torch: {kind} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = CB.build(verbose=True)
    CB._library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(CB.ptxas_log(lib_path).read_text())
    check(set(ptxas) == {"L1", "L2", "L3", "L4", "L<=8"},
          f"ptxas reported {sorted(ptxas)}")
    print(f"[build] hash_pairs.cu -> {os.path.relpath(lib_path, here)} in "
          f"{build_s:.3f} s; ptxas " + json.dumps(ptxas), flush=True)

    # -- kernel vs plain ---------------------------------------------------
    timer = KernelTimer(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    for n_limbs, n in KERNEL_SHAPES:
        limbs = random_limbs(n_limbs, n, gen, dev)
        line = kernel_line(CB, timer, limbs, timed=n >= 1 << 16)
        print("[kernel] hash_pairs " + json.dumps(line), flush=True)
        del limbs
    n_cases = 0
    for name, sets in kernel_cases(CB, gen, dev):
        check_hash(CB, sets, name)
        n_cases += 1
    print(f"[kernel] hash_pairs: {n_cases} edge cases (odd n, misaligned "
          "row views, chained L, two sets) bit-identical to the plain "
          "version", flush=True)

    # -- TPC-H at SF1 on the card: the main path ------------------------------
    t0 = time.perf_counter()
    tables = tpch.gen_tpch(SF)
    gen_s = time.perf_counter() - t0
    li = tables["lineitem"]
    print(f"[generate] SF{SF:g}: " + ", ".join(
        f"{k} {v.num_rows} rows" for k, v in tables.items())
        + f" in {gen_s:.3f} s", flush=True)
    t0 = time.perf_counter()
    refs = {q: globals()["ref_" + q](li if q in ("q1", "q6") else tables)
            for q in QUERIES}
    print(f"[reference] pyarrow {' '.join(QUERIES)} in "
          f"{time.perf_counter() - t0:.3f} s; rows " + json.dumps(
              {q: r.num_rows for q, r in refs.items()}), flush=True)
    check(refs["q1"].num_rows == 6, "reference q1 should have 6 groups")
    check(refs["q3"].num_rows == 10, "reference q3 should have 10 rows")
    check(refs["q4"].num_rows == 5, "reference q4 should have 5 groups")
    check(refs["q10"].num_rows == 20, "reference q10 should have 20 rows")
    for q, r in refs.items():
        check(r.num_rows > 0, f"reference {q} is empty")

    def build(q, session):
        return getattr(tpch, q)(session, li if q in ("q1", "q6")
                                else tables)

    session = TpuSession(device=dev)
    check(session.device.type == "cuda", "session is not on the card")
    exact = TpuSession({"spark.rapids.tpu.kernel.backend": "jnp"},
                       device=dev)

    # each query: counts to 0 just before, read just after
    first, counts = {}, {}
    for q in QUERIES:
        CB.reset_counts()
        KN.COUNTERS.reset()
        df = build(q, session)
        first[q] = df.toArrow()
        torch.cuda.synchronize()
        counts[q] = {
            "hash_pairs_launches": CB.launches,
            "shapes": {f"{l}x{n}": c for (l, n), c
                       in sorted(CB.launch_shapes.items())},
            "cuda_rung_dispatches": KN.COUNTERS.dispatches["cuda"],
            "jnp_rung_dispatches": KN.COUNTERS.dispatches["jnp"],
            "collision_fallbacks": KN.COUNTERS.fallbacks,
            "joins": join_strategies(df)}
        print(f"[main path] {q} " + json.dumps(counts[q]), flush=True)
        check(counts[q]["collision_fallbacks"] == 0,
              f"{q}: {KN.COUNTERS.fallbacks} hash-collision fallbacks")
        check_strategies(q, counts[q]["joins"])
    main_shapes = {}
    for q in QUERIES:
        for key, c in counts[q]["shapes"].items():
            main_shapes[key] = main_shapes.get(key, 0) + c
    n_batches = -(-li.num_rows // session.rapids_conf().batch_rows)
    check(counts["q1"]["hash_pairs_launches"] >= n_batches + 1,
          f"hash_pairs launched {counts['q1']['hash_pairs_launches']} "
          f"times in q1, expected at least one per input batch plus one "
          f"per merge ({n_batches + 1})")
    for q in QUERIES:
        joins = counts[q]["joins"]
        streamed = sum(j["streamedLeftGroups"] + j["streamedRightGroups"]
                       for j in joins)
        # one launch (build and probe) per match of each streamed group,
        # of each broadcast join and of each sub-partition pair
        check(counts[q]["hash_pairs_launches"] >= streamed,
              f"{q}: {counts[q]['hash_pairs_launches']} hash_pairs "
              f"launches for {streamed} streamed join groups")
        check(counts[q]["hash_pairs_launches"] > 0 or q == "q6",
              f"{q}: hash_pairs was not launched")

    summary = {}
    for q in QUERIES:
        got = first[q]
        check(got.column_names == refs[q].column_names,
              f"{q} columns {got.column_names}")
        check(rows_equal(got, refs[q]),
              f"{q} differs from the pyarrow reference:\n{got}\n"
              f"{refs[q]}")
        for c in got.columns:
            if pa.types.is_floating(c.type):
                check(bool(np.isfinite(c.to_numpy()).all()),
                      f"{q} has non-finite values")
        check(rows_equal(build(q, exact).toArrow(), got),
              f"{q}: cuda rung != jnp rung")
        walls, phases, metrics = [], [], []
        for _ in range(3):
            df = build(q, session)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = df.toArrow()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            phases.append(phase_times(df))
            metrics.append(df.metrics())
            check(rows_equal(out, refs[q]), f"{q} warm run differs")
        i = walls.index(statistics.median(walls))
        ph = phases[i]
        print(f"[{q} metrics] " + json.dumps(metrics[i]), flush=True)
        summary[q] = {
            "lineitem_rows": li.num_rows, "wall_s_median": walls[i],
            "wall_s": walls, "h2d_s": ph["h2d_s"], "d2h_s": ph["d2h_s"],
            "h2d_share": ph["h2d_s"] / walls[i],
            "execute_s": walls[i] - ph["h2d_s"] - ph["d2h_s"],
            "rows_per_s": li.num_rows / walls[i],
            "hash_pairs_launches": counts[q]["hash_pairs_launches"],
            "matches_reference": True, "cuda_equals_jnp_rung": True}
        print(f"[{q}] SF{SF:g} " + json.dumps(summary[q]), flush=True)
    for q in QUERIES:
        print(f"[{q} result] {first[q].num_rows} rows\n"
              f"{first[q].slice(0, 6).to_pandas().to_string()}",
              flush=True)

    # -- the kernel at the main path's shapes ---------------------------------
    shape_rows, kernel_row = [], None
    for key in sorted(main_shapes, key=lambda k: tuple(map(int,
                                                           k.split("x")))):
        n_limbs, n = (int(x) for x in key.split("x"))
        limbs = random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]  # separate tensors, as on the path
        line = kernel_line(CB, timer, limbs, timed=True)
        line["main_path_sets"] = main_shapes[key]
        line["ms_ring"] = timer.ring_ms(
            lambda: random_limbs(n_limbs, n, gen, dev), CB.hash_pairs,
            8 * n_limbs * n)
        traced = PR.profile_kernel(n_limbs, n, dev)
        line["traced_ms"] = traced["cold_median_ms"]
        line["traced_clean_ms"] = traced["cold_clean_median_ms"]
        line["from_list_ms"] = timer.cold_ms(
            lambda: HL.hash_limbs(listed, True))
        line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms_ring"]
        shape_rows.append(line)
        if (n_limbs, n) == MAIN_PATH_SHAPE:
            kernel_row = line
        print("[kernel main-path shape] hash_pairs " + json.dumps(line),
              flush=True)
        del limbs, listed
    check(kernel_row is not None, "q1's kernel shape was not launched")

    # both join sides in one launch, against two launches
    for shapes in JOIN_PAIRS:
        if not all(f"{l}x{n}" in main_shapes for l, n in shapes):
            continue

        def make():
            return [list(random_limbs(l, n, gen, dev)) for l, n in shapes]

        def two(sides):
            return [CB.hash_pairs(x) for x in sides]

        sides = make()
        name = " + ".join(f"L={l} n={n}" for l, n in shapes)
        check_hash(CB, sides, f"join pair {name}")
        traced = PR.trace_kernel(lambda: CB.hash_pairs_multi(sides), dev)
        in_bytes = sum(8 * l * n for l, n in shapes)
        line = {"sets": [{"L": l, "n": n} for l, n in shapes],
                "bit_identical": True,
                "bound_ms": hash_bytes(shapes) / H100_BYTES_PER_S * 1e3,
                "pair_ms": timer.cold_ms(lambda: CB.hash_pairs_multi(sides)),
                "pair_ms_ring": timer.ring_ms(make, CB.hash_pairs_multi,
                                              in_bytes),
                "pair_traced_ms": traced["cold_median_ms"],
                "pair_traced_clean_ms": traced["cold_clean_median_ms"],
                "two_launches_ms": timer.cold_ms(lambda: two(sides)),
                "two_launches_ms_ring": timer.ring_ms(make, two, in_bytes)}
        print("[kernel join pair] hash_pairs " + json.dumps(line),
              flush=True)

    # the wrappers' host time per call
    host = {}
    for n_limbs, n in ((1, 1 << 18), MAIN_PATH_SHAPE):
        limbs = random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]
        calls = {"from a list": lambda: CB.hash_pairs(listed),
                 "stacked": lambda: CB.hash_pairs(limbs)}
        if n_limbs == 1:
            calls["two sets"] = lambda: CB.hash_pairs_multi([listed, listed])
        host[f"{n_limbs}x{n}"] = {k: timer.host_us(f)
                                  for k, f in calls.items()}
        del limbs, listed
    print("[host us per call] " + json.dumps(host), flush=True)

    kernels = [{
        "name": "hash_pairs", "route": "cuda",
        "source": "spark_rapids_tpu_torch/kernels/csrc/hash_pairs.cu",
        "replaces": "spark_rapids_tpu/kernels/pallas_backend.py:42",
        "launches": sum(counts[q]["hash_pairs_launches"] for q in QUERIES),
        "launches_per_query": {q: counts[q]["hash_pairs_launches"]
                               for q in QUERIES},
        "max_abs_err": 0.0,
        "ms": kernel_row["ms"], "ms_warm": kernel_row["ms_warm"],
        "ms_ring": kernel_row["ms_ring"],
        "traced_ms": kernel_row["traced_ms"],
        "traced_clean_ms": kernel_row["traced_clean_ms"],
        "from_list_ms": kernel_row["from_list_ms"],
        "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"], "bound_by": "bytes",
        "pct_of_bound": kernel_row["pct_of_bound"],
        "pct_of_bound_from": "ms_ring",
        "library_ms": None,
        "ptxas": ptxas,
        "shape": {"L": MAIN_PATH_SHAPE[0], "n": MAIN_PATH_SHAPE[1]},
        "main_path_shapes": shape_rows}]
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
