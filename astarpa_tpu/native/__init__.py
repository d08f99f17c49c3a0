"""ctypes bindings to the native C++ A* runtime (``native/``).

The shared library is built on demand by ``native/Makefile`` (``-O3
-march=native``; plain C ABI + ctypes) into ``build/astarpa_native/<key>/``,
keyed on the sources, the flags, the compiler and the host CPU
(:mod:`astarpa_tpu.utils.build`), so a library built on another host is
never loaded.  The Python runtime in
:mod:`astarpa_tpu.astar` is the semantic reference; this is the production
implementation of the same pointer-chasing search (SURVEY.md §3.1 hot loop).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from ..types import Cigar
from ..utils import build

_NATIVE_DIR = build.REPO_ROOT / "native"
_SOURCES = ("astarpa_native.cpp", "astarpa.h", "Makefile")

_lib = None


def library_key() -> str:
    """Build key of the native library on this host."""
    cxx = os.environ.get("CXX", "g++")
    flags = (cxx, os.environ.get("CXXFLAGS", ""))
    return build.build_key(
        [_NATIVE_DIR / f for f in _SOURCES], flags, build.tool_version(cxx),
        build.host_cpu_id(),
    )


def _compile_to(path: Path) -> None:
    subprocess.run(
        ["make", "-s", "-C", str(_NATIVE_DIR), f"OUT={path}"], check=True,
    )


def load():
    """Load (building if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    so = build.build_library("astarpa_native", library_key(), _compile_to)
    lib = ctypes.CDLL(str(so))
    lib.astarpa_align.restype = ctypes.c_int
    lib.astarpa_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.astarpa_free.restype = None
    lib.astarpa_free.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


_PRUNE = {"none": 0, "start": 1, "end": 2, "both": 3}


def astarpa_native(
    a: bytes,
    b: bytes,
    r: int = 2,
    k: int = 15,
    prune: str = "start",
    dt: bool = True,
    use_gap_cost: bool = True,
    with_stats: bool = False,
):
    """Exact alignment via the native A* runtime.

    Returns ``(cost, Cigar)`` (or ``(cost, Cigar, stats_dict)``).
    """
    lib = load()
    cigar_p = ctypes.c_char_p()
    stats = (ctypes.c_int64 * 5)()
    prune_mode = _PRUNE[prune.value if hasattr(prune, "value") else prune]
    cost = lib.astarpa_align(
        a, len(a), b, len(b), r, k, prune_mode, int(dt), int(use_gap_cost),
        ctypes.byref(cigar_p), stats,
    )
    cigar = Cigar.from_string_lazy(cigar_p.value.decode()) if cigar_p.value else Cigar()
    # ctypes copies the value; free the C allocation.
    lib.astarpa_free(cigar_p)
    if with_stats:
        keys = ("expanded", "explored", "extended", "reordered", "pruned")
        return cost, cigar, dict(zip(keys, list(stats)))
    return cost, cigar


def available() -> bool:
    """True if the native library can be built/loaded on this machine.

    Only the CPU backend (tests, host-only use) may run without it: its
    callers then take slower host paths.  On a device backend a build or
    load failure raises, so a device run never degrades silently."""
    try:
        load()
        return True
    except Exception as exc:
        import jax

        backend = jax.default_backend()
        if backend != "cpu":
            raise RuntimeError(
                f"the native runtime failed to build or load on the "
                f"{backend} backend: {exc}"
            ) from exc
        return False


def trace_banded_ck(a: bytes, b: bytes, s_words: int, ck_vp, ck_vm, ck_tv,
                    shift_at, band_words: int, col_block: int,
                    use_dt: bool = True, known_cost: int = -1):
    """CIGAR from per-block banded checkpoints.

    ck_vp/ck_vm: (n_ck, band_words) uint32 for this pair (row 0 = window
    top), the planes ``ops.banded.banded_ck_block`` emits.
    ck_tv: (n_ck,) int32 device top_val at the checkpoints; shift_at:
    (>=n,) int32 bucket schedule.  The inter-checkpoint path comes from
    backward DT bursts (use_dt) with a stripe-recompute fallback.
    known_cost >= 0 skips the target-value recompute (an O(CB*SW) Myers
    fill of the final stripe) by trusting the caller's certified device
    cost — the landing checks against the checkpoint planes still verify
    every burst segment.  Returns (cost, Cigar).
    """
    import numpy as np

    lib = load()
    if not hasattr(lib, "_ck_proto_set"):
        lib.trace_banded_ck_rows.restype = ctypes.c_int
        lib.trace_banded_ck_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib._ck_proto_set = True
    vp = np.ascontiguousarray(ck_vp, dtype=np.uint32)
    vm = np.ascontiguousarray(ck_vm, dtype=np.uint32)
    tv = np.ascontiguousarray(ck_tv, dtype=np.int32)
    sh = np.ascontiguousarray(shift_at, dtype=np.int32)
    cigar_p = ctypes.c_char_p()
    cost = lib.trace_banded_ck_rows(
        a, len(a), b, len(b), s_words,
        vp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vp.shape[0],
        sh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        band_words, col_block, int(use_dt), int(vp.shape[1]),
        int(known_cost),
        ctypes.byref(cigar_p),
    )
    assert cost >= 0, "checkpointed banded traceback failed"
    cigar = Cigar.from_string_lazy(cigar_p.value.decode()) if cigar_p.value else Cigar()
    lib.astarpa_free(cigar_p)
    return cost, cigar


# The backward DT burst's layer budget (astarpa_native.cpp::try_burst
# hard cap, 1 << 14): a whole-pair direct trace is only attempted for
# certified costs at most this, else the burst would fail into a full
# O(n*SW) stripe recompute.  Covers one-burst 100kbp e=10% traces
# (d ~ 8500); the compact layer arena keeps memory at O(d * window).
DIRECT_DT_MAX = 1 << 14


def trace_direct(a: bytes, b: bytes, s_words: int, shift_at,
                 band_words: int, known_cost: int):
    """CIGAR from the certified cost alone — no device checkpoints.

    Runs :func:`trace_banded_ck` with a single synthesized checkpoint at
    column 0 (the all-ones Myers init, whose values are exact:
    value(0, j) = j) and a checkpoint interval spanning the whole pair,
    so ONE backward DT burst recovers the full path.  Valid whenever
    ``known_cost <= DIRECT_DT_MAX``.  Exactness is unchanged: the cost
    is certified by the banded kernel, the burst landing is checked
    against the exact column-0 values, and a pruned burst retries
    unpruned before the banded stripe-recompute fallback (which uses
    ``shift_at``/``band_words``, the certifying rung's schedule).
    """
    import numpy as np

    assert 0 <= known_cost <= DIRECT_DT_MAX, known_cost
    vp = np.full((1, band_words), 0xFFFFFFFF, np.uint32)
    vm = np.zeros((1, band_words), np.uint32)
    tv = np.zeros(1, np.int32)
    return trace_banded_ck(a, b, s_words, vp, vm, tv, shift_at, band_words,
                           col_block=max(len(a), 1), known_cost=known_cost)


def trace_direct_batch(pairs, s_words: int, shift_at, band_words: int,
                       costs, n_threads: int | None = None):
    """Batched :func:`trace_direct`: ONE native call traces every pair of
    ``pairs`` (list of ``(a, b)`` byte pairs) from its certified cost in
    ``costs``, multi-threaded inside C++ with the GIL released for the
    whole batch — the per-pair ctypes/numpy wrapper overhead (which rivals
    the trace itself at 10kbp) is paid once.  All pairs must share one
    rung schedule (``shift_at``/``band_words``).  Returns
    ``[(cost, Cigar), ...]`` in order.
    """
    import os

    import numpy as np

    lib = load()
    if not hasattr(lib, "_direct_batch_proto_set"):
        lib.trace_direct_batch.restype = ctypes.c_int
        lib.trace_direct_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ]
        lib._direct_batch_proto_set = True
    np_ = len(pairs)
    a_off = np.zeros(np_ + 1, np.int32)
    b_off = np.zeros(np_ + 1, np.int32)
    for i, (a, b) in enumerate(pairs):
        a_off[i + 1] = a_off[i] + len(a)
        b_off[i + 1] = b_off[i] + len(b)
    a_buf = b"".join(a for a, _ in pairs)
    b_buf = b"".join(b for _, b in pairs)
    cost_arr = np.ascontiguousarray(costs, dtype=np.int32)
    assert cost_arr.shape == (np_,)
    assert int(cost_arr.max(initial=0)) <= DIRECT_DT_MAX
    sh = np.ascontiguousarray(shift_at, dtype=np.int32)
    cigars = (ctypes.c_char_p * np_)()
    rcs = np.zeros(np_, np.int32)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    rc = lib.trace_direct_batch(
        a_buf, a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_buf, b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np_, s_words,
        sh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), band_words,
        cost_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(n_threads),
        cigars, rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    assert rc == 0, f"batched direct trace failed: rcs={rcs[rcs < 0]}"
    # c_char_p indexing yields a bytes COPY; free the malloc'd originals
    # through the raw pointer view of the same array.
    raw = ctypes.cast(cigars, ctypes.POINTER(ctypes.c_void_p))
    out = []
    for i in range(np_):
        val = cigars[i]
        cig = Cigar.from_string_lazy(val.decode()) if val else Cigar()
        if raw[i]:
            lib.astarpa_free(
                ctypes.cast(ctypes.c_void_p(raw[i]), ctypes.c_char_p)
            )
        out.append((int(rcs[i]), cig))
    return out


def pack_batch_planes(pairs, B: int, n_max: int, S: int,
                      n_threads: int | None = None):
    """Upload-ready 2-bit batch pack (native, GIL-released): returns
    pair-major ``(a4 (B, ceil(n_max/4)) u8, pb0 (B, S) u32, pb1)`` — the
    a-side codes packed 4/byte and the negated b-side bit planes, built
    straight from the pair byte buffers (no (B, n_max) uint8 staging
    matrices, and ~4x fewer bytes to upload than raw codes).  Rows past
    ``len(pairs)`` are padding lanes (a codes 0, b pad char 0xFF -> code
    3), matching
    ``ops.bitpack.pack_batch_staggered``'s numpy layout bit-exactly
    (parity: tests/test_pack.py).
    """
    import os

    import numpy as np

    lib = load()
    if not hasattr(lib, "_pack_proto_set"):
        lib.pack_batch_planes.restype = None
        lib.pack_batch_planes.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
        ]
        lib._pack_proto_set = True
    n4 = (n_max + 3) // 4
    a4 = np.empty((B, n4), np.uint8)
    pb0 = np.empty((B, S), np.uint32)
    pb1 = np.empty((B, S), np.uint32)
    # c_char_p entries point INTO the bytes objects (no copy); `pairs` is
    # held by the caller for the duration of the call.
    a_ptrs = (ctypes.c_char_p * B)()
    b_ptrs = (ctypes.c_char_p * B)()
    a_lens = np.zeros(B, np.int32)
    b_lens = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(pairs):
        a_ptrs[i] = a
        b_ptrs[i] = b
        a_lens[i] = min(len(a), n_max)
        b_lens[i] = min(len(b), S * 32)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.pack_batch_planes(
        a_ptrs, a_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_ptrs, b_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, n_max, S,
        a4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pb0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        pb1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        int(n_threads),
    )
    return a4, pb0, pb1


def gcsh_domain(a: bytes, b: bytes, f_max: int, k: int = 12, r: int = 1,
                step: int = 64):
    """Sampled fwd+rev GCSH domain hull (see astarpa_tpu.domain)."""
    import numpy as np

    from ..domain import PairDomain

    lib = load()
    if not hasattr(lib, "_dom_proto_set"):
        lib.gcsh_domain.restype = ctypes.c_int
        lib.gcsh_domain.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib._dom_proto_set = True
    n, m = len(a), len(b)
    ns = n // step + 2
    lo = np.zeros(ns, np.int32)
    hi = np.zeros(ns, np.int32)
    h0 = ctypes.c_int32()
    rc = lib.gcsh_domain(
        a, n, b, m, k, r, f_max, step,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(h0),
    )
    return PairDomain(n, m, f_max, int(h0.value), step, lo, hi, empty=rc != 0)


class DomainHandle:
    """Cached fwd+rev GCSH instances for one pair; sample the domain hull
    at successive f_max values without rebuilding the matchers."""

    def __init__(self, a: bytes, b: bytes, k: int = 12, r: int = 1):
        import numpy as np

        lib = load()
        if not hasattr(lib, "_domh_proto_set"):
            lib.gcsh_domain_new.restype = ctypes.c_void_p
            lib.gcsh_domain_new.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.gcsh_domain_sample.restype = ctypes.c_int
            lib.gcsh_domain_sample.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.gcsh_domain_del.restype = None
            lib.gcsh_domain_del.argtypes = [ctypes.c_void_p]
            lib._domh_proto_set = True
        self._lib = lib
        self.n, self.m = len(a), len(b)
        h0 = ctypes.c_int32()
        self._h = lib.gcsh_domain_new(a, self.n, b, self.m, k, r, ctypes.byref(h0))
        self.h0 = int(h0.value)
        self._np = np

    def sample(self, f_max: int, step: int = 64):
        """Returns a astarpa_tpu.domain.PairDomain."""
        from ..domain import PairDomain

        np = self._np
        ns = self.n // step + 2
        lo = np.zeros(ns, np.int32)
        hi = np.zeros(ns, np.int32)
        rc = self._lib.gcsh_domain_sample(
            self._h, f_max, step,
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return PairDomain(self.n, self.m, f_max, self.h0, step, lo, hi,
                          empty=rc != 0)

    def close(self):
        if self._h:
            self._lib.gcsh_domain_del(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_U32P = ctypes.POINTER(ctypes.c_uint32)


def _blk_lib():
    lib = load()
    if not hasattr(lib, "_blk_proto_set"):
        lib.block_compute.restype = None
        lib.block_compute.argtypes = [_U32P, _U32P, ctypes.c_int, _U32P,
                                      _U32P, ctypes.c_int, _U32P, _U32P,
                                      _U32P, _U32P]
        lib.block_fill.restype = None
        lib.block_fill.argtypes = [_U32P, _U32P, ctypes.c_int, _U32P, _U32P,
                                   ctypes.c_int, _U32P, _U32P, _U32P, _U32P,
                                   _U32P, _U32P]
        lib._blk_proto_set = True
    return lib


def block_compute(a0, a1, pb0, pb1, vp, vm, hp, hm):
    """Native Myers block DP (astarpa2 backend): mutates vp/vm/hp/hm
    (contiguous uint32 numpy, exact sizes) in place."""
    lib = _blk_lib()
    p = lambda x: x.ctypes.data_as(_U32P)
    lib.block_compute(p(a0), p(a1), len(a0), p(pb0), p(pb1), len(pb0),
                      p(vp), p(vm), p(hp), p(hm))


def block_fill(a0, a1, pb0, pb1, vp, vm, hp, hm, vp_cols, vm_cols):
    """Fill variant: writes (ncols, nwords) planes into vp_cols/vm_cols."""
    lib = _blk_lib()
    p = lambda x: x.ctypes.data_as(_U32P)
    lib.block_fill(p(a0), p(a1), len(a0), p(pb0), p(pb1), len(pb0),
                   p(vp), p(vm), p(hp), p(hm), p(vp_cols), p(vm_cols))
