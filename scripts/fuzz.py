#!/usr/bin/env python
"""Fuzzer with input shrinking (re-design of `pa-bin/examples/fuzz.rs:22-60`).

Loops over sizes / error rates / error models with fresh random seeds,
catches cost mismatches or exceptions from the aligner under test, then
shrinks the failing input (halving from both ends, dropping chars) and
prints a minimal reproducer.

Usage:
    python scripts/fuzz.py [--aligner astarpa|astarpa2-simple|astarpa2-full|native|batch|batch-ck|batch-domain|batch-bigband] [--iters N]
"""

from __future__ import annotations

import argparse
import random
import sys
import traceback

# The fuzzer runs the batch modes on the CPU backend (the jnp kernels).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, ".")

from astarpa_tpu import generate, oracle  # noqa: E402


def check(aligner, a: bytes, b: bytes):
    cost, cigar = aligner(a, b)
    expected = oracle.levenshtein(a, b)
    if cost != expected:
        raise AssertionError(f"cost {cost} != oracle {expected}")
    if cigar is not None:
        cigar.verify(a, b)


def shrink(aligner, a: bytes, b: bytes):
    """Greedy shrinking: repeatedly try halving/removal edits that keep the
    failure (`fuzz.rs` shrink loop)."""

    def fails(a, b):
        try:
            check(aligner, a, b)
            return False
        except Exception:
            return True

    changed = True
    while changed:
        changed = False
        for which in (0, 1):
            s = a if which == 0 else b
            # Try removing large chunks first, then single chars.
            step = max(1, len(s) // 2)
            while step >= 1:
                i = 0
                while i < len(s):
                    cand = s[:i] + s[i + step :]
                    na, nb = (cand, b) if which == 0 else (a, cand)
                    if fails(na, nb):
                        a, b = na, nb
                        s = cand
                        changed = True
                    else:
                        i += step
                step //= 2
    return a, b


def build(name: str):
    if name == "astarpa":
        from astarpa_tpu.astar import astarpa

        return astarpa
    if name == "native":
        from astarpa_tpu.native import astarpa_native

        return lambda a, b: astarpa_native(a, b, r=2, k=8)
    if name.startswith("batch"):
        # The batch runtime's full CIGAR path — one pair at a time so
        # shrinking stays meaningful.  Variants pin each product path:
        #   batch        direct whole-pair DT traces (the default path)
        #   batch-ck     checkpoint kernel + staged readback + native
        #                per-segment traces (direct_dt off)
        #   batch-domain per-pair gap-domain ladder (found the SW==S crash)
        #   batch-bigband  checkpoint path at a band near full height
        from astarpa_tpu.parallel.runner import BatchAligner

        kw = dict(band_words=2, lane_multiple=128, domain_mode="off")
        if name == "batch-ck":
            kw["direct_dt"] = False
        elif name == "batch-domain":
            kw.update(domain_mode="gap", domain_min_bp=0, direct_dt=False)
        elif name == "batch-bigband":
            kw.update(band_words=64, direct_dt=False)
        ba = BatchAligner(**kw)
        return lambda a, b: ba.align([(a, b)])[0]
    from astarpa_tpu.aligners.astarpa2 import AstarPa2Params

    params = {
        "astarpa2-simple": AstarPa2Params.simple,
        "astarpa2-full": AstarPa2Params.full,
        "nw": AstarPa2Params.nw,
    }[name]()
    aligner = params.make_aligner(True)
    return aligner.align


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--aligner", default="astarpa")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--max-n", type=int, default=400)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args()

    aligner = build(args.aligner)
    rng = random.Random(args.seed)
    models = list(generate.ErrorModel)
    for it in range(args.iters):
        n = rng.randrange(1, args.max_n)
        e = rng.choice([0.0, 0.01, 0.05, 0.1, 0.3, 0.5, 1.0])
        model = rng.choice(models)
        seed = rng.randrange(1 << 30)
        a, b = generate.generate_model(n, e, model, seed)
        try:
            check(aligner, a, b)
        except Exception:
            print(f"FAILURE at iter {it}: n={n} e={e} model={model} seed={seed}")
            traceback.print_exc()
            a, b = shrink(aligner, a, b)
            print(f"shrunk reproducer:\n  a = {a!r}\n  b = {b!r}")
            return 1
        if (it + 1) % 50 == 0:
            print(f"{it + 1}/{args.iters} ok")
    print("no failures")
    return 0


if __name__ == "__main__":
    sys.exit(main())
