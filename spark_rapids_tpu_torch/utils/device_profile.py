"""Where the time of the ported TPC-H queries goes: one run under
``torch.profiler``.

    python3 -m spark_rapids_tpu_torch.utils.device_profile [q1 q5 ...]

runs each query named (by default all 22 of ``tpch.QUERIES``) once
warm and once traced at SF1 on the CUDA card and
prints, per query, one JSON line: the traced run's wall time, the
device's busy time (the union of the intervals of every kernel and
memory copy the card ran) and busy share, the host-to-device phase
time from the plan's metrics, the host operators with the most self
time and the kernel launches, the kernels and copies that took the
most device time, the ``cudaLaunch*`` and ``cudaGraphLaunch`` calls (a
fused region's replays), and the device durations of the hand-written
``hash_pairs`` kernel's launches as the trace recorded them; then the
kernel alone at three shapes, cold and warm (``profile_kernel``).  The
trace adds host overhead, so its wall time is longer than an untraced
run's (``chip_smoke.py`` times those).
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Dict, List

import torch

from spark_rapids_tpu_torch.runtime.device import synchronize
from spark_rapids_tpu_torch.sql.dataframe import profile_capture
from spark_rapids_tpu_torch.utils import tpch


def _busy_us(intervals: List[tuple]) -> float:
    """Length of the union of [start, end) intervals."""
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _query(tpch_mod, query: str, session, tables):
    """The query's DataFrame: q1 and q6 read lineitem alone."""
    arg = tables["lineitem"] if query in ("q1", "q6") else tables
    return getattr(tpch_mod, query)(session, arg)


def profile_query(session, query: str, tables, top: int = 8) -> Dict:
    """Run ``query`` (one of ``tpch.QUERIES``) once under the profiler;
    ``tables`` is ``tpch.gen_tpch``'s dict.  Scans an earlier run cached
    are read from the scan cache (``h2d_s`` 0): ``main`` runs each query
    once before, so that it traces the warm run."""
    from torch.autograd import DeviceType
    df = _query(tpch, query, session, tables)
    synchronize(session.device)
    t0 = time.perf_counter()
    with profile_capture(session.device) as prof:
        df.toArrow()
        synchronize(session.device)
    wall = time.perf_counter() - t0
    intervals, by_name, kernel_us = [], {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        intervals.append((e.time_range.start, e.time_range.end))
        d = e.time_range.end - e.time_range.start
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + d, cnt + 1)
        if "hash_pairs" in e.name:
            kernel_us.append(d)
    h2d = sum(m.get("transferTime", 0.0) for name, m in df.metrics()
              if name == "TpuScanExec")
    averages = prof.key_averages()  # one pass over the trace's events
    host = sorted(averages, key=lambda a: -a.self_cpu_time_total)
    out = {"query": query, "rows": tables["lineitem"].num_rows,
           "device": str(session.device), "traced_wall_s": wall,
           "h2d_s": h2d,
           "kernel_launches": sum(a.count for a in averages
                                  if a.key.startswith("cudaLaunch")),
           # a fused region's CUDA graph replays: one call each
           "graph_launches": sum(a.count for a in averages
                                 if a.key.startswith("cudaGraphLaunch")),
           "top_host": [{"name": a.key[:60],
                         "self_ms": a.self_cpu_time_total / 1e3,
                         "count": a.count} for a in host[:top]]}
    if not intervals:
        out["device_busy_s"] = None  # a CPU session: no device to trace
        return out
    busy = _busy_us(intervals) / 1e6
    out["device_busy_s"] = busy
    out["device_busy_share"] = busy / wall
    out["device_events"] = len(intervals)
    out["top_device"] = [
        {"name": n[:90], "ms": t / 1e3, "count": c}
        for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])
        [:top]]
    out["hash_pairs_trace"] = ({
        "launches": len(kernel_us),
        "median_ms": statistics.median(kernel_us) / 1e3,
        "min_ms": min(kernel_us) / 1e3, "max_ms": max(kernel_us) / 1e3,
        "total_ms": sum(kernel_us) / 1e3} if kernel_us else None)
    return out


def trace_kernel(launch, device: torch.device, iters: int = 30) -> Dict:
    """The device durations of the ``hash_pairs`` kernels that
    ``launch()`` starts, as the trace records them: ``cold`` with a
    256 MB write before each call (which evicts the L2 cache and leaves
    it full of dirty lines, which the launch's own traffic then writes
    back), ``cold_clean`` with a 256 MB read instead (clean lines),
    ``warm`` back to back.  Per mode, the launches seen and their median
    milliseconds (None on the CPU).  The trace holds no
    CUDA-event overhead, so it separates the kernel from the floor of
    ``chip_smoke.py``'s event timing."""
    from torch.autograd import DeviceType
    scratch = torch.empty(((256 << 20) // 4,), dtype=torch.int32,
                          device=device)
    launch()
    synchronize(device)
    out = {}
    for mode in ("cold", "cold_clean", "warm"):
        with profile_capture(device) as prof:
            for _ in range(iters):
                if mode == "cold":
                    scratch.zero_()
                elif mode == "cold_clean":
                    scratch.sum()
                launch()
            synchronize(device)
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and "hash_pairs" in e.name]
        out[f"{mode}_launches"] = len(us)
        out[f"{mode}_median_ms"] = (statistics.median(us) / 1e3
                                    if us else None)
    return out


def profile_kernel(n_limbs: int, n: int, device: torch.device,
                   iters: int = 30) -> Dict:
    """``trace_kernel`` of ``cuda_backend.hash_pairs`` on random
    ``int64[n_limbs, n]`` limbs."""
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    limbs = torch.randint(-(1 << 62), 1 << 62, (n_limbs, n),
                          dtype=torch.int64, device=device, generator=gen)
    return {"L": n_limbs, "n": n,
            **trace_kernel(lambda: CB.hash_pairs(limbs), device, iters)}


def main(argv=None) -> int:
    import sys
    from spark_rapids_tpu_torch.sql.session import TpuSession
    queries = list(sys.argv[1:] if argv is None else argv) or tpch.QUERIES
    session = TpuSession()
    tables = tpch.gen_tpch(1.0)
    for q in queries:
        _query(tpch, q, session, tables).toArrow()  # warm
        print("[profile] " + json.dumps(profile_query(session, q, tables)),
              flush=True)
    # the kernel at q1's aggregate shape, the join's shape, and a small one
    for n_limbs, n in ((3, 1 << 20), (1, 1 << 18), (3, 1024)):
        print("[profile kernel] " + json.dumps(
            profile_kernel(n_limbs, n, session.device)), flush=True)
    print(torch.cuda.get_device_name(session.device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
