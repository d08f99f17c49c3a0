"""Banded batched Myers DP: a sliding word-window along the bucket diagonal.

The batched equivalent of the reference's band doubling
(`astarpa2/src/lib.rs:122-175`, `band.rs:100-141`): instead of growing a
per-pair data-dependent band (dynamic shapes), a whole *bucket* of
similarly-sized pairs is aligned with one static band of ``band_words``
uint32 lanes that slides down one word whenever the bucket diagonal crosses
a word boundary (an exact rational schedule — a static function of the
bucket's padded ``(n_max, m_max)``, so XLA sees fully static shapes and
control flow).  Cost per pair is O(n * band_words) instead of O(n * m/32).

Boundary conditions are the standard monotone upper bounds (cf. Ukkonen's
band): +1 horizontal diffs enter at the band top and fresh +1 vertical
words at the band bottom, so the result is an upper bound that equals the
exact distance whenever the optimal path stays inside the band; the
acceptance test :func:`band_threshold` certifies that, and the host doubles
``band_words`` for the pairs that fail (`parallel/runner.py`).

State per pair: the window's v bit-planes, ``top_val`` (the DP value at the
window's top row, absorbed word-by-word as the window slides), and the
captured result at the pair's final column (pairs of different lengths
finish at different columns under per-pair activity masks).

These jnp functions are the reference semantics of the device DP: they
run as the CPU backend's kernels, and the CUDA kernel
(:mod:`astarpa_tpu.ops.cuda_banded`) must match them bit for bit.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .bitpack import W, n_words

U32 = jnp.uint32
_ONES = 0xFFFFFFFF
#: Result sentinel of a pair whose window lost its corner row.
INF32 = 1 << 30


def _popcount(x):
    return jax.lax.population_count(x).astype(jnp.int32)


def _value_to_window(vp, vm, rows):
    """Sum of v diffs of the first ``rows`` rows of the window, per pair.

    vp/vm: (SW, B); rows: (B,) int32 clipped to [0, SW*W].
    """
    SW = vp.shape[0]
    base = jnp.arange(SW, dtype=jnp.int32)[:, None] * W
    full = jnp.clip(rows[None, :] - base, 0, W)
    mask = jnp.where(
        full >= W, U32(_ONES), (U32(1) << full.astype(jnp.uint32)) - U32(1)
    )
    return jnp.sum(_popcount(vp & mask) - _popcount(vm & mask), axis=0)


def shift_schedule(n_max: int, m_max: int, band_words: int) -> tuple[int, int]:
    """Static schedule parameters: the window top word before column ``i`` is
    ``lo(i) = min(lo_max, max(0, floor(i*m_max/n_max/W) - band_words//2))``.

    Returns (lo_max, m_words).  The schedule is exact-rational, so the band
    center tracks the bucket diagonal with < 1 word of drift.
    """
    m_words = n_words(m_max) if m_max else 1
    lo_max = max(0, m_words - band_words)
    return lo_max, m_words


def shift_at_array(n_max: int, s_words: int, band_words: int,
                   diag: tuple[int, int] | None = None) -> np.ndarray:
    """Host-precomputed schedule: shift_at[i] = 1 iff the window slides one
    word down before processing column i.  Shared by the jnp reference and
    the CUDA kernel so both are bit-identical.

    diag: the TRUE bucket diagonal ``(n_top, m_top)`` the window centers
    should track; defaults to the padded ``(n_max, s_words*W)``.  Passing
    the true tops decouples the band certificate from shape padding: a
    geometry-quantized pack (stable compiled shapes across a stream) then
    costs zero extra band, because the schedule never descends into the
    pad rows no pair reaches (`band_threshold`'s dev term measures skew
    against this same diagonal)."""
    SW = min(band_words, s_words)
    lo_max = max(0, s_words - SW)
    half = (SW * W) // 2
    n_top, m_top = diag if diag is not None else (n_max, s_words * W)
    n = max(n_top, 1)
    i = np.arange(n_max, dtype=np.int64)
    center = (2 * np.minimum(i, n - 1) + 1) * m_top // (2 * n)
    desired = np.clip((center - half) // W, 0, lo_max)
    shift = np.diff(np.concatenate([[0], desired])).astype(np.int32)
    # One shift per column max (guaranteed by bucketing: m_max <= W*n_max).
    assert (shift >= 0).all() and (shift <= 1).all(), (
        "bucket too skewed: m_max > W * n_max"
    )
    return shift


def _myers_word(eqw, vpw, vmw, hp0, hm0):
    """One Myers uint32 word step; hp0/hm0 are the 1-bit carries in."""
    vx = eqw | vmw
    eq2 = eqw | hm0
    hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2
    hp = vmw | ~(hx | vpw)
    hm = vpw & hx
    hpw = hp >> (W - 1)
    hmw = hm >> (W - 1)
    hp = (hp << 1) | hp0
    hm = (hm << 1) | hm0
    return hm | ~(vx | hp), hp & vx, hpw, hmw


def _column_body(a0, a1, pb0, pb1, n, m, SW: int, sched, per_pair: bool):
    """One banded column as a loop body over the state
    ``(vp, vm, win0, win1, top_val, lo, result, top_rows)``.

    Shared schedule: ``sched`` is the (n_max,) bucket schedule and ``lo``
    a scalar.  Per-pair: ``sched`` is (n_max, B) and ``lo`` is (B,).  In
    both, the window first slides (absorbing its top word into
    ``top_val``), then one banded Myers column runs for the pairs still
    active, and a pair's result is captured at its final column.
    """
    S = pb0.shape[0]
    B = a0.shape[1]

    def body(i, state):
        vp, vm, win0, win1, top_val, lo, result, top_rows = state
        if per_pair:
            shift = sched[i]
            do_shift = shift > 0
            lo_new = lo + shift
            ent = jnp.minimum(lo_new + SW - 1, S - 1)[None, :]
            nxt0 = jnp.take_along_axis(pb0, ent, axis=0)
            nxt1 = jnp.take_along_axis(pb1, ent, axis=0)
            lo = lo_new
        else:
            do_shift = sched[i] > 0
            lo_new = lo + 1
            nxt0 = jax.lax.dynamic_slice_in_dim(pb0, lo_new + SW - 1, 1, axis=0)
            nxt1 = jax.lax.dynamic_slice_in_dim(pb1, lo_new + SW - 1, 1, axis=0)
            lo = jnp.where(do_shift, lo_new, lo)

        # --- slide the window one word down (<= 1 word per column).
        top_val = jnp.where(
            do_shift, top_val + _popcount(vp[0]) - _popcount(vm[0]), top_val
        )
        top_rows = jnp.where(do_shift, top_rows + W, top_rows)
        shifted = lambda w, nxt: jnp.concatenate([w[1:], nxt], axis=0)
        vp = jnp.where(do_shift, shifted(vp, jnp.full((1, B), _ONES, U32)), vp)
        vm = jnp.where(do_shift, shifted(vm, jnp.zeros((1, B), U32)), vm)
        win0 = jnp.where(do_shift, shifted(win0, nxt0), win0)
        win1 = jnp.where(do_shift, shifted(win1, nxt1), win1)

        # --- one banded column: chain h through the window's words.
        eq = (a0[i][None, :] ^ win0) & (a1[i][None, :] ^ win1)

        def word_step(w, carry):
            vp, vm, hp0, hm0 = carry
            vpw, vmw, hpw, hmw = _myers_word(eq[w], vp[w], vm[w], hp0, hm0)
            return vp.at[w].set(vpw), vm.at[w].set(vmw), hpw, hmw

        ones = jnp.ones((B,), U32)
        zeros = jnp.zeros((B,), U32)
        vp2, vm2, _, _ = jax.lax.fori_loop(0, SW, word_step, (vp, vm, ones, zeros))

        active = i < n
        vp = jnp.where(active, vp2, vp)
        vm = jnp.where(active, vm2, vm)
        top_val = jnp.where(active, top_val + 1, top_val)

        # --- capture the result at each pair's final column; a window that
        # no longer covers the pair's corner row yields INF (rejected, so
        # the host retries with a wider band).
        done = i == n - 1
        res_now = top_val + _value_to_window(vp, vm, m - top_rows)
        covered = (m - top_rows) <= SW * W
        res_now = jnp.where(covered, res_now, jnp.int32(INF32))
        result = jnp.where(done, res_now, result)
        return vp, vm, win0, win1, top_val, lo, result, top_rows

    return body


def _setup(a0, pb0, pb1, n, m, band_words: int, diag, schedule):
    """(SW, n, m, sched, per_pair, initial state) for one bucket."""
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    per_pair = schedule is not None
    if per_pair:
        sched = jnp.asarray(schedule).astype(jnp.int32)
        lo0 = jnp.zeros((B,), jnp.int32)
    else:
        sched = jnp.asarray(shift_at_array(n_max, S, SW, diag))
        lo0 = jnp.int32(0)
    m = m.astype(jnp.int32)
    state = (
        jnp.full((SW, B), _ONES, U32),
        jnp.zeros((SW, B), U32),
        jax.lax.dynamic_slice_in_dim(pb0, 0, SW, axis=0),
        jax.lax.dynamic_slice_in_dim(pb1, 0, SW, axis=0),
        jnp.zeros((B,), jnp.int32),
        lo0,
        m,  # pairs with n == 0 are captured here (cost = m)
        jnp.zeros((B,), jnp.int32),
    )
    return SW, n.astype(jnp.int32), m, sched, per_pair, state


def banded_cost_block(a0, a1, pb0, pb1, n, m, band_words: int,
                      diag: tuple | None = None, schedule=None):
    """Banded edit distances (upper bounds) for one shape bucket.

    Args:
      a0, a1: (n_max, B) uint32 exploded a-char planes.
      pb0, pb1: (S, B) uint32 packed negated b profiles (padded rows read as
        char 'G'; harmless — see ops.bitpack).
      n, m: (B,) int32 true lengths.
      band_words: static window height in uint32 words.
      diag: the shared schedule's true bucket diagonal (see
        :func:`shift_at_array`).
      schedule: optional (n_max, B) 0/1 per-pair schedule — pair p's window
        slides one word down before column i iff ``schedule[i, p]``; None
        is the shared bucket schedule.

    Returns (B,) int32 banded distances; exact where
    ``cost <= band_threshold(...)`` (checked by the caller).
    """
    SW, n, m, sched, per_pair, state = _setup(
        a0, pb0, pb1, n, m, band_words, diag, schedule
    )
    body = _column_body(a0, a1, pb0, pb1, n, m, SW, sched, per_pair)
    return jax.lax.fori_loop(0, a0.shape[0], body, state)[6]


banded_cost = jax.jit(banded_cost_block, static_argnames=("band_words", "diag"))


def banded_fill_block(a0, a1, pb0, pb1, n, m, band_words: int,
                      diag: tuple | None = None, schedule=None):
    """Like :func:`banded_cost_block` but stores the window planes after
    every column, for traceback (`simd::fill` equivalent on the band).

    Returns (costs, vp_cols, vm_cols) with vp_cols shape (n_max, SW, B):
    entry i holds the state after processing column i+1 (column 0's state is
    the all-ones init).  The per-column window offsets are implied by
    :func:`shift_at_array` (shifts apply before the column), or by the
    per-pair ``schedule``.
    """
    SW, n, m, sched, per_pair, state = _setup(
        a0, pb0, pb1, n, m, band_words, diag, schedule
    )
    body = _column_body(a0, a1, pb0, pb1, n, m, SW, sched, per_pair)

    def step(carry, i):
        carry = body(i, carry)
        return carry, (carry[0], carry[1])

    carry, (vp_cols, vm_cols) = jax.lax.scan(
        step, state, jnp.arange(a0.shape[0], dtype=jnp.int32)
    )
    return carry[6], vp_cols, vm_cols


banded_fill = jax.jit(banded_fill_block, static_argnames=("band_words", "diag"))


def banded_ck_block(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
                    diag: tuple | None = None, schedule=None):
    """Banded cost + window checkpoints every ``col_block`` columns.

    Returns ``(costs (B,), ck_vp (n_ck, SW, B), ck_vm, ck_tv (n_ck, B))``
    with ``n_ck = ceil(n_max / col_block)``: checkpoint k is the window
    planes and ``top_val`` entering column ``k * col_block`` (checkpoint 0
    is the all-ones init), the contract native ``trace_banded_ck`` reads.
    Shared or per-pair schedule as in :func:`banded_cost_block`.
    """
    n_max = a0.shape[0]
    SW, n, m, sched, per_pair, state = _setup(
        a0, pb0, pb1, n, m, band_words, diag, schedule
    )
    body = _column_body(a0, a1, pb0, pb1, n, m, SW, sched, per_pair)
    CB = max(1, min(col_block, n_max))

    def block(carry, k):
        ck = (carry[0], carry[1], carry[4])
        lo = k * CB
        carry = jax.lax.fori_loop(lo, jnp.minimum(lo + CB, n_max), body, carry)
        return carry, ck

    n_ck = -(-n_max // CB)
    carry, (ckvp, ckvm, cktv) = jax.lax.scan(
        block, state, jnp.arange(n_ck, dtype=jnp.int32)
    )
    return carry[6], ckvp, ckvm, cktv


banded_ck = jax.jit(banded_ck_block,
                    static_argnames=("band_words", "col_block", "diag"))


#: Per-pair gap schedules only shift at multiples of this column quantum
#: (the certificate's slack below prices the delay).  No kernel needs it:
#: the CUDA kernel and the jnp references read any schedule.  It stays,
#: with its one word of slack, until the benchmark measures whether
#: unquantized schedules narrow the certified bands (ROADMAP S1/S4).
SCHEDULE_Q = 32


def pair_gap_schedule(n, m, band_words: int, n_max: int, s_words: int):
    """Per-pair shift schedules: each window tracks its own pair's
    gap-centered line (row center ``i + (m-n)/2`` — the center of the
    cost-``thr`` parallelogram between the two corner diagonals), so the
    exactness threshold drops to ``SW*W - 6W`` with NO ``|m-n|`` or
    bucket-skew terms (cf. :func:`band_threshold` for the shared bucket
    schedule, which pays both).  The ``6W`` slack covers the word
    quantization of the window top (up to ``W`` rows high of center), the
    SCHEDULE_Q-delayed shifts' bottom deficit (up to one extra word), and
    the ``//2`` center rounding — keep it in sync with ``thr`` below.

    Returns ``(sched (n_max, B) uint8, thr (B,) int64)``; ``thr[p] = -1``
    marks pairs whose parallelogram cannot be entered at <=1 word shift
    per column from lo=0 (|m-n| >= SW*W) — they are never certified at
    this band and retry wider.  The center line has slope exactly 1, so
    the one-shift-per-column kernel constraint holds for ANY length skew.
    """
    n_arr = np.maximum(np.asarray(n, np.int64), 1)
    m_arr = np.asarray(m, np.int64)
    B = n_arr.shape[0]
    SW = min(band_words, s_words)
    half = (SW * W) // 2
    lo_max = np.maximum(0, -(-m_arr // W) - SW)  # window must end over m
    d = m_arr - n_arr
    i = np.arange(n_max, dtype=np.int64)[:, None]
    # Freeze each pair's schedule at its own final column.
    i_eff = np.minimum(i, np.maximum(n_arr, 1)[None, :] - 1)
    center = (2 * i_eff + d[None, :]) // 2
    desired = np.clip((center - half) // W, 0, lo_max[None, :])
    # Quantize to the kernel's group granularity (hold from each group
    # start: shifts only at multiples of SCHEDULE_Q, delayed — the top
    # stays higher, sound; the <= 1-word bottom deficit is in the -6W
    # threshold slack).  The slope is 1/W per column, so group deltas
    # are always <= 1.
    desired = desired[(i[:, 0] // SCHEDULE_Q) * SCHEDULE_Q]
    sched = np.diff(desired, axis=0, prepend=0).astype(np.uint8)
    bad = desired[0] > 0
    sched[:, bad] = 0
    thr = np.full(B, SW * W - 6 * W, np.int64)
    thr[bad] = -1
    assert (sched <= 1).all()
    return sched, thr


def band_threshold(band_words: int, n, m, n_max: int, m_max: int):
    """Largest certified-exact distance for this band (NumPy, per pair).

    The optimal path's row deviation from the *pair* diagonal is at most
    ``(d - |m-n|)/2 + |m-n|``; the band follows the *bucket* diagonal, which
    adds up to ``dev = max_i |i*m_max/n_max - i*m/n|`` rows of skew; word
    granularity and the entering-word boundary cost up to ``2W`` more.
    Solving ``(d-g)/2 + g + dev + 2W <= band_words*W/2`` for d gives the
    threshold below.  Conservative by construction; certified by the oracle
    grid in tests/test_banded.py.
    """
    n = np.maximum(np.asarray(n, np.int64), 1)
    m = np.asarray(m, np.int64)
    g = np.abs(m - n)
    dev = np.abs(m_max * n // max(n_max, 1) - m)
    return band_words * W - 4 * W - g - 2 * dev


def band_for_cost(cost, n, m, n_max: int, m_max: int):
    """Smallest band (words, per pair) whose :func:`band_threshold` admits
    ``cost`` — the threshold inverse.

    A failed rung's banded result is an *upper bound* on the true distance
    (the clamped-boundary band DP solves a restriction of the problem:
    every in-band path keeps its true cost, so the minimum can only rise —
    the standard Ukkonen band argument).  Feeding that bound through this
    inverse lets the ladder jump straight to a band guaranteed to certify:
    one retry instead of log2(final/initial) blind doublings
    (`astarpa2/src/domain.rs:452-455` reuse, re-expressed as rung
    prediction; the f-ladder in `parallel/runner.py::_domain_ladder` does
    the same with f).
    """
    n = np.maximum(np.asarray(n, np.int64), 1)
    m = np.asarray(m, np.int64)
    g = np.abs(m - n)
    dev = np.abs(m_max * n // max(n_max, 1) - m)
    return -(-(np.asarray(cost, np.int64) + 4 * W + g + 2 * dev) // W)
