#!/usr/bin/env python
"""The CUDA banded kernel against XLA's plain version of the jnp reference,
on the card, at the two BASELINE shapes; then the streaming runners' host
phases at the same shapes.

- config #2: 4096 pairs of 10 kbp, e = 5%, band 32 words;
- config #5: 128 pairs of 500 kbp, e = 15%, band 2048 words.  The plain
  version takes seconds per hundred columns here, so it is timed on a
  column prefix (PREFIX columns, the CUDA kernel beside it on the same
  prefix) and its full-shape time is extrapolated linearly; the output
  says so.

Every time is host wall clock around calls ending in ``block_until_ready``,
after one warm call.  Prints one JSON line per measurement, each with the
card's ``nvidia-smi`` name and power limit.  Needs a GPU.

    python scripts/bench_kernel_vs_xla.py
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")
# Per-phase host lines of the streaming runners (read at import time).
os.environ.setdefault("ASTARPA_STREAM_PROF", "1")

PREFIX = 256


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t)
    return float(np.median(out))


def main() -> int:
    import jax

    import chip_smoke
    from astarpa_tpu.ops import banded, cuda_banded
    from astarpa_tpu.ops.bitpack import pack_batch_staggered
    from astarpa_tpu.parallel.runner import BatchAligner
    from astarpa_tpu.utils import device

    device.enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    card = device.gpu_name_power().splitlines()[0]
    cuda_banded.load()
    workers = min(16, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        p10 = chip_smoke.generate_pairs(pool, workers, 4096, 10_000, 0.05, 42)
        p5 = chip_smoke.generate_pairs(pool, workers, 128, 500_000, 0.15, 7)

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    for name, pairs, sw, cb in (("config2", p10, 32, 2048),
                                ("config5", p5, 2048, 16384)):
        args, _ = pack_batch_staggered(pairs, lane_multiple=len(pairs))
        n_max = args[0].shape[0]
        # The full shape's diagonal, so a column prefix keeps its schedule.
        diag = (n_max, args[2].shape[0] * 32)
        for mode in ("cost", "ck"):
            if mode == "cost":
                cu = lambda a: cuda_banded.banded_cost_cuda(
                    *a, band_words=sw, diag=diag)
                xla = lambda a: banded.banded_cost(*a, band_words=sw,
                                                   diag=diag)
            else:
                cu = lambda a: cuda_banded.banded_ck_cuda(
                    *a, band_words=sw, col_block=cb, diag=diag)
                xla = lambda a: banded.banded_ck(*a, band_words=sw,
                                                 col_block=cb, diag=diag)
            t_cuda = _time(lambda: cu(args), 3)
            if name == "config2":
                t_xla = _time(lambda: xla(args), 1)
                emit(shape=name, mode=mode, columns=n_max, cuda_s=t_cuda,
                     xla_s=t_xla, speedup=t_xla / t_cuda)
                continue
            pre = (args[0][:PREFIX], args[1][:PREFIX], *args[2:])
            t_cuda_pre = _time(lambda: cu(pre), 3)
            t_xla_pre = _time(lambda: xla(pre), 1)
            emit(shape=name, mode=mode, columns=n_max, cuda_s=t_cuda,
                 prefix_columns=PREFIX, cuda_prefix_s=t_cuda_pre,
                 xla_prefix_s=t_xla_pre,
                 xla_extrapolated_s=t_xla_pre * n_max / PREFIX,
                 speedup_on_prefix=t_xla_pre / t_cuda_pre)

    # The streaming runners at both shapes: per-batch periods (stderr has
    # the per-phase host lines).
    for name, pairs, kw in (("config2", p10, {}),
                            ("config5", p5, dict(band_words=2048,
                                                 domain_mode="off"))):
        for runner in ("cost_iter", "align_iter"):
            ba = BatchAligner(**kw)
            stream = [pairs] * 6
            (ba.cost if runner == "cost_iter" else ba.align)(pairs)  # warm
            marks = [time.perf_counter()]
            for _ in getattr(ba, runner)(iter(stream)):
                marks.append(time.perf_counter())
            per = np.diff(marks)
            # Mid-stream: the first yield pays the pipeline's ramp-in and
            # the last ones only drain it (align_iter yields trail by two).
            mid = per[1:-2]
            bp = sum(len(a) for a, _ in pairs)
            emit(shape=name, runner=runner, periods_s=per.tolist(),
                 mid_median_s=float(np.median(mid)),
                 mbp_per_s_mid=bp / float(np.median(mid)) / 1e6)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    emit(peak_device_bytes=peak)
    return 0


if __name__ == "__main__":
    sys.exit(main())
