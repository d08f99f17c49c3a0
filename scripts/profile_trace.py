"""Profile the native checkpoint traceback (host only).

Computes checkpoints with the jnp checkpoint kernel (``banded.banded_ck``)
on the CPU for several CB values, then times ``native.trace_banded_ck`` —
the DT-burst side of the checkpoint-interval tradeoff, apart from the
device.

Run from the repo root:
    python scripts/profile_trace.py [n_bp] [e] [n_pairs] [band_words]
"""

import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from astarpa_tpu import generate, native
from astarpa_tpu.ops import banded
from astarpa_tpu.ops.bitpack import pack_batch_staggered

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
E = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
NP_ = int(sys.argv[3]) if len(sys.argv) > 3 else 8
SW = int(sys.argv[4]) if len(sys.argv) > 4 else 32

pairs = generate.generate_batch(NP_, N, E, generate.ErrorModel.UNIFORM, seed=3)
(a0, a1, pb0, pb1, ns, ms), B0 = pack_batch_staggered(pairs, lane_multiple=NP_)
n_max, S = a0.shape[0], pb0.shape[0]

shift = banded.shift_at_array(n_max, S, SW)  # shift before column i (0-based)

for CB in (256, 512, 1024, 2048, 4096, 8192, 16384):
    t0 = time.perf_counter()
    costs, ckvp, ckvm, cktv = (np.asarray(x) for x in banded.banded_ck(
        a0, a1, pb0, pb1, ns, ms, band_words=SW, col_block=CB))
    print(f"[banded_ck on CPU, CB={CB}: {time.perf_counter()-t0:.1f}s]",
          flush=True)
    ck_bytes = (ckvp[:, :, 0].nbytes * 2 + cktv[:, 0].nbytes)

    # Warm + verify once.
    for slot in range(B0):
        a, b = pairs[slot]
        cost, cig = native.trace_banded_ck(
            a, b, S, ckvp[:, :, slot], ckvm[:, :, slot], cktv[:, slot],
            shift, SW, CB,
        )
        assert cost == costs[slot], (CB, slot, cost, costs[slot])
        assert cig.verify(a, b) == cost

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        for slot in range(B0):
            a, b = pairs[slot]
            native.trace_banded_ck(
                a, b, S, ckvp[:, :, slot], ckvm[:, :, slot], cktv[:, slot],
                shift, SW, CB, known_cost=int(costs[slot]),
            )
    dt = (time.perf_counter() - t0) / (reps * B0)

    t0 = time.perf_counter()
    for slot in range(B0):
        a, b = pairs[slot]
        native.trace_banded_ck(
            a, b, S, ckvp[:, :, slot], ckvm[:, :, slot], cktv[:, slot],
            shift, SW, CB, use_dt=False,
        )
    dt_nodt = (time.perf_counter() - t0) / B0

    print(
        f"CB={CB:5d}  trace {dt*1e3:7.3f} ms/pair   (stripe-only "
        f"{dt_nodt*1e3:7.3f})   ck {ck_bytes/1024:7.1f} KB/pair",
        flush=True,
    )
