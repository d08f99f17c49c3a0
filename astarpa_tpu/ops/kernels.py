"""Which banded DP kernel serves a backend: the one dispatch point.

``banded_kernels()`` returns the kernel family for the default backend (or
the named one):

- ``"gpu"``: the CUDA kernel (:mod:`astarpa_tpu.ops.cuda_banded`); raises
  RuntimeError when its library cannot be built or loaded.
- ``"cpu"``: the jnp references (:mod:`astarpa_tpu.ops.banded`), which are
  also what the tests run.
- anything else: RuntimeError.  A device backend never falls back to the
  jnp references.

Every family has the same two entries, with one signature each:

- ``cost(a0, a1, pb0, pb1, n, m, band_words, diag=None, schedule=None)``
  -> (B,) int32 banded costs;
- ``ck(a0, a1, pb0, pb1, n, m, band_words, col_block, diag=None,
  schedule=None)`` -> ``(costs, ck_vp, ck_vm, ck_tv)``;

``schedule`` None is the shared bucket schedule, an (n_max, B) 0/1 array
the per-pair one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class BandedKernels:
    name: str
    cost: Callable
    ck: Callable


def banded_kernels(backend: str | None = None) -> BandedKernels:
    import jax

    if backend is None:
        backend = jax.default_backend()
    if backend == "cpu":
        from . import banded

        return BandedKernels("jnp", banded.banded_cost, banded.banded_ck)
    if backend == "gpu":
        from . import cuda_banded

        cuda_banded.load()
        return BandedKernels(
            "cuda", cuda_banded.banded_cost_cuda, cuda_banded.banded_ck_cuda
        )
    raise RuntimeError(f"no banded DP kernel for backend {backend!r}")
