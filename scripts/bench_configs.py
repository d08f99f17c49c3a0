#!/usr/bin/env python
"""BASELINE.json config-matrix benchmarks (one JSON line per config).

Configs (BASELINE.md):
  #1 bitpacked cost-only, 1kbp e=1%   (banded kernel at full height)
  #2 banded cost + CIGAR, 10kbp e=5%  (banded kernel + native traceback)
  #3 SH/GCSH-guided A*, 10kbp e=5%    (native A* runtime, per-core)
  #4 GCSH + pruning, 100kbp e=10%     (batch banded on the device + native A*)
  #5 host streaming, simulated stripes (MultiHostRunner plumbing)

All throughputs oracle-checked on a subsample.  Usage:
    python scripts/bench_configs.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def _oracle_check(pairs, costs, k=4):
    from astarpa_tpu import oracle

    for (a, b), c in list(zip(pairs, costs))[:k]:
        assert c == oracle.levenshtein(a, b), (c, oracle.levenshtein(a, b))


def bench_config1(quick):
    """Cost-only at 1kbp: the batch ladder with a full-height window (the
    band clamps to the profile height, so the first rung is exact)."""
    from astarpa_tpu import generate
    from astarpa_tpu.parallel.runner import BatchAligner

    n, batch = 1000, 1024 if not quick else 128
    pairs = generate.generate_batch(8, n, 0.01, generate.ErrorModel.UNIFORM, 1)
    pairs = pairs * (batch // 8)
    ba = BatchAligner(band_words=n, lane_multiple=batch, domain_mode="off")
    costs = ba.cost(pairs)  # warmup/compile
    _oracle_check(pairs, costs)
    t0 = time.perf_counter()
    ba.cost(pairs)
    dt = time.perf_counter() - t0
    return {
        "config": "#1 cost-only 1kbp e=1%",
        "Gbp_per_s": round(batch * n / dt / 1e9, 3),
        "ms_per_batch": round(dt * 1e3, 2),
        "batch": batch,
    }


def bench_config2(quick):
    from astarpa_tpu import generate, oracle
    from astarpa_tpu.parallel.runner import BatchAligner

    n, batch = 10000, 1024 if not quick else 32
    pairs = generate.generate_batch(8, n, 0.05, generate.ErrorModel.UNIFORM, 2)
    pairs = pairs * (batch // 8)
    ba = BatchAligner(band_words=20, lane_multiple=min(256, batch))
    ba.cost(pairs)  # warmup/compile
    ba.cost(pairs)  # second warm: band hints change the rung sequence
    t0 = time.perf_counter()
    costs = ba.cost(pairs)
    dt_cost = time.perf_counter() - t0
    _oracle_check(pairs, costs)
    k_align = min(512, batch)
    ba2 = BatchAligner(band_words=20, lane_multiple=min(128, k_align))
    ba2.align(pairs[:k_align])  # warmup/compile the ck kernel
    ba2.align(pairs[:k_align])  # second warm (band-hint rung sequence)
    t0 = time.perf_counter()
    res = ba2.align(pairs[:k_align])
    dt_align = (time.perf_counter() - t0) / k_align
    for (a, b), (c, cig) in zip(pairs[:8], res[:8]):
        assert cig.verify(a, b) == c
    return {
        "config": "#2 cost+CIGAR 10kbp e=5%",
        "cost_Gbp_per_s": round(batch * n / dt_cost / 1e9, 3),
        "align_ms_per_pair": round(dt_align * 1e3, 2),
        "align_Mbp_per_s": round(n / dt_align / 1e6, 2),
        "batch": batch,
    }


def bench_config3(quick):
    from astarpa_tpu import generate, oracle
    from astarpa_tpu.native import astarpa_native, available

    if not available():
        return {"config": "#3", "skipped": "no native toolchain"}
    n = 10000
    reps = 2 if quick else 8
    inputs = [generate.uniform_seeded(n, 0.05, s) for s in range(reps)]
    c0, _ = astarpa_native(*inputs[0])
    assert c0 == oracle.levenshtein(*inputs[0])
    t0 = time.perf_counter()
    for a, b in inputs:
        astarpa_native(a, b)
    dt = (time.perf_counter() - t0) / reps
    return {
        "config": "#3 native A* GCSH 10kbp e=5%",
        "ms_per_pair": round(dt * 1e3, 2),
        "Mbp_per_s_core": round(n / dt / 1e6, 3),
    }


def bench_config4(quick):
    from astarpa_tpu import generate
    from astarpa_tpu.native import astarpa_native, available
    from astarpa_tpu.parallel.runner import BatchAligner

    n = 100000
    out = {"config": "#4 100kbp e=10%"}
    if available():
        a, b = generate.uniform_seeded(n, 0.10, 7)
        t0 = time.perf_counter()
        c, g = astarpa_native(a, b)
        dt = time.perf_counter() - t0
        assert g.verify(a, b) == c
        out["native_astar_ms"] = round(dt * 1e3, 1)
    batch = 8 if quick else 128
    pairs = [generate.uniform_seeded(n, 0.10, 100 + s) for s in range(batch)]
    for label, mode in (("plain", "off"), ("gap", "gap"), ("gcsh", "gcsh")):
        ba = BatchAligner(band_words=512, lane_multiple=min(128, batch),
                          domain_mode=mode)
        if mode == "gcsh" and not available():
            continue
        ba.cost(pairs)  # warmup/compile
        ba.cost(pairs)  # second warm (band-hint rung sequence)
        t0 = time.perf_counter()
        costs = ba.cost(pairs)
        dt = time.perf_counter() - t0
        if "native_astar_ms" in out:
            assert int(costs[0]) <= 2 * n
        out[f"batch_Gbp_per_s_{label}"] = round(batch * n / dt / 1e9, 3)
    out["batch"] = batch
    return out


def bench_config5(quick):
    from astarpa_tpu import generate
    from astarpa_tpu.parallel.multihost import MultiHostRunner
    from astarpa_tpu.parallel.runner import BatchAligner

    if quick:
        pairs = [generate.uniform_seeded(5000, 0.1, s) for s in range(16)]
        runner = MultiHostRunner(
            BatchAligner(band_words=8, lane_multiple=8), batch_size=8
        )
    else:
        # The real config #5 shape: 500kbp ONT-like e=15%.  The e=15%
        # distance (~0.13*n) needs ~2048-word bands: starting the ladder
        # there avoids failed rungs.
        pairs = [
            generate.generate_model(
                500_000, 0.15, generate.ErrorModel.NOISY_INSERT, s
            )
            for s in range(4)
        ]
        runner = MultiHostRunner(
            BatchAligner(band_words=2048, lane_multiple=128,
                         domain_mode="off"),
            batch_size=4,
        )
    t0 = time.perf_counter()
    res = runner.run(pairs)
    dt = time.perf_counter() - t0
    return {
        "config": "#5 streaming runner (host stripes)",
        "local_pairs": res.local_pairs,
        "global_bp": res.global_bp,
        "bp_per_s": round(res.local_bp / dt, 1),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--configs", default="1,2,3,4,5")
    args = p.parse_args()
    fns = {
        "1": bench_config1, "2": bench_config2, "3": bench_config3,
        "4": bench_config4, "5": bench_config5,
    }
    for c in args.configs.split(","):
        try:
            print(json.dumps(fns[c](args.quick)))
        except Exception as ex:
            print(json.dumps({"config": f"#{c}", "error": str(ex)[:200]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
