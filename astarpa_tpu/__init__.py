"""astarpa_tpu — an exact pairwise aligner with a batched GPU path.

A from-scratch JAX/XLA re-design of the capabilities of
A*PA / A*PA2 (`RagnarGrootKoerkamp/astar-pairwise-aligner`): Myers' bitpacked
edit-distance DP and block band-doubling run as batched device kernels, guided
by the seed / gap-chaining seed heuristic, with exact traceback to CIGARs.

Public API (mirroring the reference's top-level functions,
`astarpa2/src/lib.rs:38-53` and `astarpa/src/lib.rs:56-129`):

- :func:`astarpa2_nw`, :func:`astarpa2_simple`, :func:`astarpa2_full` —
  single-pair alignment returning ``(cost, Cigar)``.
- :func:`astarpa` — the default full-strength entry point (block DP with
  GCSH; the A* state-space search of the reference is re-expressed as the
  equivalent band-doubling block DP, which is the device-shaped formulation).
- :class:`BatchAligner` — the batch/streaming device API (the performance
  product: many pairs aligned data-parallel on the device).
"""

from .types import Cigar, CigarElem, CigarOp, Pos
from .generate import ErrorModel, generate_model, uniform_fixed

__version__ = "0.1.0"

__all__ = [
    "Cigar",
    "CigarElem",
    "CigarOp",
    "Pos",
    "ErrorModel",
    "generate_model",
    "uniform_fixed",
    "astarpa",
    "astarpa_gcsh",
    "astarpa2_nw",
    "astarpa2_simple",
    "astarpa2_full",
]


def __getattr__(name):
    # Lazy imports so that `astarpa_tpu.types`/`generate` stay importable
    # without pulling in JAX.
    if name in ("astarpa2_nw", "astarpa2_simple", "astarpa2_full", "astarpa", "astarpa_gcsh"):
        from . import api

        return getattr(api, name)
    if name == "BatchAligner":
        from .parallel.runner import BatchAligner

        return BatchAligner
    if name == "AstarPa":
        from .astar import AstarPa

        return AstarPa
    # NOTE: the semi-global search lives in the `astarpa_tpu.search`
    # module: `from astarpa_tpu.search import search`.
    raise AttributeError(name)
