"""The banded Myers DP on an NVIDIA GPU: a CUDA kernel called through
``jax.ffi`` (source: ``native/cuda/banded_myers.cu``).

Same contract, bit for bit, as the jnp references in
:mod:`astarpa_tpu.ops.banded`: cost or cost plus checkpoints, under the
shared bucket schedule or per-pair schedules, at any band height up to
``MAX_BAND_WORDS`` (16384 words, 524288 rows: a 500 kbp pair at full
height).  One team of warps aligns one pair; lanes hold ``K`` consecutive
window words each (see the source's header).

The library is built with ``nvcc`` for ``sm_90a`` on first use into the
gitignored ``build/`` directory (:mod:`astarpa_tpu.utils.build`), or ahead
of time with ``python -m astarpa_tpu.ops.cuda_banded``.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import build
from .banded import shift_at_array

SOURCE = build.REPO_ROOT / "native" / "cuda" / "banded_myers.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: Words per lane the kernel is instantiated for.
WORDS_PER_LANE = (1, 2, 4, 8, 16, 32)
#: Warps per pair: the team size the plan aims at, and the most any
#: K < 32 instance is compiled for (``MAX_THREADS`` in the source).
TARGET_WARPS = 8
#: Warps per pair at K = 32, whose instance is compiled for 512 threads:
#: 128 registers per lane, of which its 3 * 32 state words take 96.
MAX_WARPS = 16
#: The widest band the kernel serves.
MAX_BAND_WORDS = MAX_WARPS * 32 * WORDS_PER_LANE[-1]

_COST_TARGET = "astarpa_banded_cost"
_CK_TARGET = "astarpa_banded_ck"
_lock = threading.Lock()
_loaded: dict = {}


def plan(band_words: int) -> tuple[int, int]:
    """``(K, NW)``: words per lane and warps per pair for a window of
    ``band_words`` words.  The fewest words per lane that keep the team
    within ``TARGET_WARPS`` warps (more lanes per pair, shorter columns),
    then up to ``MAX_WARPS`` warps of 32 words.  The team covers
    ``NW * 32 * K >= band_words`` slots; slots past the window are padding
    below it."""
    if band_words < 1:
        raise ValueError(f"band_words must be positive, got {band_words}")
    if band_words > MAX_BAND_WORDS:
        raise ValueError(
            f"band of {band_words} words exceeds the CUDA kernel's "
            f"{MAX_BAND_WORDS}-word limit ({MAX_BAND_WORDS * 32} rows)"
        )
    for k in WORDS_PER_LANE:
        nw = -(-band_words // (32 * k))
        if nw <= TARGET_WARPS or k == WORDS_PER_LANE[-1]:
            return k, nw


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not shutil.which(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return nvcc


def library_path() -> tuple:
    """Build (if needed) the kernel library; returns ``(path, seconds)``
    where ``seconds`` is the build time (0.0 when it was already built).
    The key covers JAX's version, whose FFI headers the library compiles
    against."""
    nvcc = _nvcc()
    include = jax.ffi.include_dir()
    key = build.build_key([SOURCE], (*NVCC_FLAGS, jax.__version__),
                          build.tool_version(nvcc))
    seconds = 0.0

    def compile_to(path):
        nonlocal seconds
        t0 = time.perf_counter()
        cmd = [nvcc, *NVCC_FLAGS, "-I", include, "-o", str(path),
               str(SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}"
            )
        seconds = time.perf_counter() - t0

    path = build.build_library("banded_myers", key, compile_to)
    return path, seconds


def load() -> float:
    """Build, load and register the FFI targets once per process; returns
    the build seconds of this call (0.0 if nothing was built).  Raises
    RuntimeError when the library cannot be built or loaded."""
    with _lock:
        if "lib" in _loaded:
            return 0.0
        path, seconds = library_path()
        try:
            lib = ctypes.cdll.LoadLibrary(str(path))
        except OSError as exc:
            raise RuntimeError(f"cannot load {path}: {exc}") from exc
        jax.ffi.register_ffi_target(
            _COST_TARGET, jax.ffi.pycapsule(lib.AstarpaBandedCost),
            platform="CUDA",
        )
        jax.ffi.register_ffi_target(
            _CK_TARGET, jax.ffi.pycapsule(lib.AstarpaBandedCk),
            platform="CUDA",
        )
        _loaded["lib"] = lib
        return seconds


def _call(a0, a1, pb0, pb1, n, m, band_words: int, col_block, diag,
          schedule):
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    k, nw = plan(SW)
    if schedule is None:
        sched = jnp.asarray(shift_at_array(n_max, S, SW, diag))
    else:
        sched = jnp.asarray(schedule).astype(jnp.uint8)
    args = (a0, a1, pb0, pb1, jnp.asarray(n, jnp.int32),
            jnp.asarray(m, jnp.int32), sched)
    attrs = dict(sw=np.int64(SW), k=np.int64(k), nw=np.int64(nw))
    cost = jax.ShapeDtypeStruct((B,), jnp.int32)
    if col_block is None:
        return jax.ffi.ffi_call(_COST_TARGET, cost)(*args, **attrs)
    CB = max(1, min(col_block, n_max))
    n_ck = -(-n_max // CB)
    planes = jax.ShapeDtypeStruct((n_ck, SW, B), jnp.uint32)
    outs = (cost, planes, planes, jax.ShapeDtypeStruct((n_ck, B), jnp.int32))
    return jax.ffi.ffi_call(_CK_TARGET, outs)(*args, cb=np.int64(CB), **attrs)


@functools.partial(jax.jit, static_argnames=("band_words", "diag"))
def banded_cost_cuda(a0, a1, pb0, pb1, n, m, band_words: int, diag=None,
                     schedule=None):
    """Banded costs (B,) int32; contract of ``banded.banded_cost_block``."""
    return _call(a0, a1, pb0, pb1, n, m, band_words, None, diag, schedule)


@functools.partial(jax.jit,
                   static_argnames=("band_words", "col_block", "diag"))
def banded_ck_cuda(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
                   diag=None, schedule=None):
    """Costs + checkpoints; contract of ``banded.banded_ck_block``."""
    return _call(a0, a1, pb0, pb1, n, m, band_words, col_block, diag,
                 schedule)


if __name__ == "__main__":
    print(f"{library_path()[0]}")
