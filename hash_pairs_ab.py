#!/usr/bin/env python3
"""This checkout's ``hash_pairs`` kernel beside an earlier checkout's, in
one process on one CUDA card.

    mkdir -p build/earlier
    git archive <commit> spark_rapids_tpu_torch/kernels | tar -x -C build/earlier
    python3 hash_pairs_ab.py build/earlier

``DIR/spark_rapids_tpu_torch/kernels/cuda_backend.py`` is the earlier
wrapper, whose ``hash_pairs`` takes an ``int64[L, n]`` tensor; it builds
its ``csrc/`` into ``DIR/build/kernels``.  At every row-set shape that
TPC-H q1, q3 and q4 give the kernel at SF1 (``chip_smoke.py``'s
``[main path]`` lines), both kernels are held against the plain version
bit for bit, then timed in turns (earlier, this, this, earlier) by
``chip_smoke.py``'s methods: ``ms`` (cold CUDA events), ``ms_ring``,
``traced_ms`` and ``traced_clean_ms`` (``utils/device_profile.py::
trace_kernel``), and ``from_list_ms`` (separate limbs, as the main path
holds them: this kernel reads them where they lie, the earlier one takes
``torch.stack`` first).  Then the join's two sides (this kernel in one
launch and in two, the earlier in two with their stacks), and each
wrapper's host microseconds per call.  It prints one JSON line per
reading and the ``nvidia-smi`` line last, and exits non-zero when a
kernel differs from the plain version or CUDA is unavailable.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

# the main path's row sets (L, n): q1's aggregate 3 x 2^20 and its merge
# 3 x 2^10; q3's join sides 1 x 2^18 and its aggregate 3 x 2^10 .. 2^19;
# q4's join sides 1 x 2^18 and 1 x 2^16 and its aggregate 3 x 2^16
SHAPES = ((1, 1 << 16), (1, 1 << 18), (3, 1 << 10), (3, 1 << 12),
          (3, 1 << 13), (3, 1 << 14), (3, 1 << 15), (3, 1 << 16),
          (3, 1 << 19), (3, 1 << 20))
TURNS = ("earlier", "this", "this", "earlier")


def load_earlier(path: str):
    """The earlier checkout's ``cuda_backend`` module, built and loaded."""
    src = os.path.join(path, "spark_rapids_tpu_torch", "kernels",
                       "cuda_backend.py")
    if not os.path.isfile(src):
        raise SystemExit(f"hash_pairs_ab: {src} does not exist")
    spec = importlib.util.spec_from_file_location("earlier_cuda_backend",
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._library()
    return mod


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("hash_pairs_ab: CUDA is unavailable", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import chip_smoke as S
    from spark_rapids_tpu_torch.kernels import cuda_backend as CB
    from spark_rapids_tpu_torch.kernels import hash_layout as HL
    from spark_rapids_tpu_torch.utils import profile as PR

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = S.nvidia_smi_line()
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    CB._library()
    old = load_earlier(argv[0])
    timer = S.KernelTimer(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)

    # (hash of an [L, n] tensor, hash of a list of limbs) of each kernel
    impls = {"earlier": (old.hash_pairs,
                         lambda ls: old.hash_pairs(torch.stack(ls))),
             "this": (CB.hash_pairs, lambda ls: HL.hash_limbs(ls, True))}
    for n_limbs, n in SHAPES:
        limbs = S.random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]
        want = CB.hash_pairs_plain(limbs)
        for name, (stacked, from_list) in impls.items():
            S.check(torch.equal(stacked(limbs), want)
                    and torch.equal(from_list(listed), want),
                    f"{name} kernel differs from the plain version at "
                    f"L={n_limbs} n={n}")
        for name in TURNS:
            stacked, from_list = impls[name]
            traced = PR.trace_kernel(lambda: stacked(limbs), dev)
            print("[ab shape] " + json.dumps({
                "L": n_limbs, "n": n, "impl": name,
                "bound_ms": S.kernel_bound_ms(n_limbs, n),
                "ms": timer.cold_ms(lambda: stacked(limbs)),
                "ms_ring": timer.ring_ms(
                    lambda: S.random_limbs(n_limbs, n, gen, dev), stacked,
                    8 * n_limbs * n),
                "traced_ms": traced["cold_median_ms"],
                "traced_clean_ms": traced["cold_clean_median_ms"],
                "from_list_ms": timer.cold_ms(lambda: from_list(listed))}),
                flush=True)
        del limbs, listed

    pairs = {
        "earlier, two launches with their stacks":
            lambda sides: [old.hash_pairs(torch.stack(x)) for x in sides],
        "this, one launch": CB.hash_pairs_multi,
        "this, two launches":
            lambda sides: [CB.hash_pairs(x) for x in sides]}
    for shapes in S.JOIN_PAIRS:

        def make():
            return [list(S.random_limbs(l, n, gen, dev)) for l, n in shapes]

        sides = make()
        want = [CB.hash_pairs_plain(x) for x in sides]
        for name, fn in pairs.items():
            S.check(all(torch.equal(g, w) for g, w in zip(fn(sides), want)),
                    f"{name} differs from the plain version at {shapes}")
        for name in list(pairs) + list(reversed(pairs)):
            fn = pairs[name]
            print("[ab pair] " + json.dumps({
                "sets": [{"L": l, "n": n} for l, n in shapes],
                "impl": name,
                "bound_ms": S.hash_bytes(shapes) / S.H100_BYTES_PER_S * 1e3,
                "ms": timer.cold_ms(lambda: fn(sides)),
                "ms_ring": timer.ring_ms(make, fn,
                                         sum(8 * l * n for l, n in shapes))}),
                flush=True)
        del sides, want

    for n_limbs, n in ((1, 1 << 18), S.MAIN_PATH_SHAPE):
        limbs = S.random_limbs(n_limbs, n, gen, dev)
        listed = [l.clone() for l in limbs]
        calls = {
            "earlier, stacked": lambda: old.hash_pairs(limbs),
            "earlier, from a list (stack + launch)":
                lambda: old.hash_pairs(torch.stack(listed)),
            "this, stacked": lambda: CB.hash_pairs(limbs),
            "this, from a list": lambda: CB.hash_pairs(listed)}
        if n_limbs == 1:
            calls["this, two sets"] = lambda: CB.hash_pairs_multi(
                [listed, listed])
        for name in list(calls) + list(reversed(calls)):
            print("[ab host us per call] " + json.dumps({
                "L": n_limbs, "n": n, "impl": name,
                "us": timer.host_us(calls[name])}), flush=True)
        del limbs, listed
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
