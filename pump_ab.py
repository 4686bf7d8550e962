#!/usr/bin/env python3
"""The 22 TPC-H queries' warm walls at SF1 on one CUDA card: this
checkout at its default pump (prefetch ``pumpDepth`` 2, pow2 bucketing)
beside this checkout with both planes off (``pumpDepth`` 1, bucketing
off) and, given a directory holding an earlier checkout, beside that.

    mkdir -p build/earlier
    git archive <commit> | tar -x -C build/earlier
    python3 pump_ab.py [build/earlier]

Each turn is a process of its own (``python3 pump_ab.py --turn ROOT
CONF``) that imports the port from ROOT, generates the tables, runs
every query once to stage its scans and then 3 times warm (the device
synchronized around each ``toArrow``), and prints one JSON line of the
per-query warm medians and their sum.  The turns run in the order
earlier, this, planes off, planes off, this, earlier (without the
earlier checkout: this, planes off, planes off, this), so that a drift
of the machine over the call shows as a difference between a turn and
its mirror.  It prints one JSON line per turn, a summary line and the
``nvidia-smi`` line last, and exits non-zero when a turn fails or CUDA
is unavailable.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SF = 1.0
WARM_RUNS = 3
PLANES_OFF = {"spark.rapids.tpu.exec.pumpDepth": 1,
              "spark.rapids.tpu.kernel.bucketing": "off"}


def turn(root: str, conf: dict) -> dict:
    """One turn: the warm medians of the 22 queries of the port under
    ``root``."""
    sys.path.insert(0, root)
    import torch

    from spark_rapids_tpu_torch.sql.session import TpuSession
    from spark_rapids_tpu_torch.utils import tpch
    tables = tpch.gen_tpch(SF)
    session = TpuSession(dict(conf, **{"spark.rapids.sql.test.enabled":
                                       True}))
    out = {}
    for q in tpch.QUERIES:
        tpch.build(q, session, tables).toArrow()  # stages the scans
        walls = []
        for _ in range(WARM_RUNS):
            df = tpch.build(q, session, tables)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df.toArrow()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[q] = statistics.median(walls)
    return {"warm_s": out, "sum_s": sum(out.values())}


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1], json.loads(argv[2]))), flush=True)
        return 0
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("pump_ab: CUDA is unavailable", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    turns = [("this", here, {}), ("planes off", here, PLANES_OFF)]
    turns = turns + turns[::-1]
    if argv:
        earlier = os.path.abspath(argv[0])
        if not os.path.isdir(os.path.join(earlier,
                                          "spark_rapids_tpu_torch")):
            print(f"pump_ab: no checkout under {earlier}", file=sys.stderr)
            return 2
        turns = ([("earlier", earlier, {})] + turns
                 + [("earlier", earlier, {})])
    sums = {}
    for name, root, conf in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", root,
             json.dumps(conf)], capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(f"pump_ab: turn {name} failed:\n{res.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line.update(turn=name, conf=conf)
        sums.setdefault(name, []).append(line["sum_s"])
        print("[pump ab] " + json.dumps(line), flush=True)
    print("[pump ab] sums " + json.dumps(sums), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
