"""Profile the native direct whole-pair DT trace (host only).

Times `native.trace_direct_batch` on N-pair batches at the steady-state
serving shape (10kbp e=5%), with per-phase stats via ASTARPA_TRACE_PROF
on a subsample.  Costs come from the native full-height Myers oracle.

Run from the repo root (CPU only):
    JAX_PLATFORMS=cpu python scripts/profile_direct.py \
        [n_bp] [e] [n_pairs] [xdrop]
"""

import os
import sys
import time

sys.path.insert(0, "/root/repo")
sys.path.insert(0, ".")

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
E = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
NP_ = int(sys.argv[3]) if len(sys.argv) > 3 else 256
if len(sys.argv) > 4:
    os.environ["ASTARPA_XDROP"] = sys.argv[4]

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops import banded
from astarpa_tpu.ops.bitpack import n_words

pairs = generate.generate_batch(NP_, N, E, generate.ErrorModel.UNIFORM,
                                seed=11)
t0 = time.perf_counter()
costs = [oracle.levenshtein_myers(a, b) for a, b in pairs]
print(f"oracle costs: {time.perf_counter()-t0:.1f}s "
      f"(d mean {np.mean(costs):.0f})", flush=True)

from astarpa_tpu.ops.bitpack import pack_batch_staggered

(a0, a1, pb0, pb1, nsj, msj), B0 = pack_batch_staggered(pairs,
                                                        lane_multiple=8)
n_max, S = a0.shape[0], pb0.shape[0]
# The trace needs the BANDED result (== oracle once the band is wide
# enough), not just cost <= threshold: grow until the banded kernel
# reproduces every oracle cost (the runner's ladder does this with
# certificates).
sw = 16
while sw < S:
    bc = np.asarray(banded.banded_cost(a0, a1, pb0, pb1, nsj, msj,
                                       band_words=sw))[:B0]
    if (bc == np.asarray(costs)).all():
        break
    sw *= 2
sw = min(sw, S)
shift = banded.shift_at_array(n_max, S, sw)
print(f"sw={sw} S={S}", flush=True)

for rep in range(4):
    t0 = time.perf_counter()
    res = native.trace_direct_batch(pairs, S, shift, sw, costs)
    dt = time.perf_counter() - t0
    if rep == 0:
        for (a, b), c, (tc, cig) in zip(pairs[:4], costs[:4], res[:4]):
            assert tc == c and cig.verify(a, b) == c
    print(f"rep{rep}: {dt*1e3/NP_:.3f} ms/pair ({dt:.2f}s total)",
          flush=True)
