"""Myers'99 bitpacked DP column updates in JAX (uint32 lanes, W = 32).

This is the portable (any-backend) implementation of the hot kernel of the
reference (`pa-bitpacking/src/myers.rs:27-55` scalar recurrence,
`simd.rs:98-226` block driver), re-derived for 32-bit device words:

- 32 DP cells per uint32 word instead of 64 per u64.
- Columns advance under ``lax.scan`` (sequential DP dependency), words
  within a column chain the horizontal difference ``h`` exactly like the
  reference chains ``h`` between 64-row blocks.
- Fully batchable: every function vmaps over leading batch dimensions, so
  one scan step processes ``batch x words`` words on the device.

The banded kernels (:mod:`astarpa_tpu.ops.banded`, and on the GPU
:mod:`astarpa_tpu.ops.cuda_banded`) compute the same recurrence over a
sliding band; at full profile height they are the full-rectangle DP.

Difference encodings (cf. `pa-bitpacking/src/encoding.rs`):
- vertical: ``(vp, vm)`` uint32 bit-planes; +1 where vp bit set, -1 where vm.
- horizontal: ``(hp, hm)`` single bits carried per column.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bitpack import W

U32 = jnp.uint32
_ONES = jnp.uint32(0xFFFFFFFF)
_TOPBIT = W - 1


def step_word(eq, vp, vm, hp0, hm0):
    """One 32-cell column step of Myers'99 (~20 bit-ops).

    Given the match mask ``eq``, vertical diffs ``(vp, vm)`` of the word and
    incoming horizontal diff bits ``(hp0, hm0)`` (in bit 0, values 0/1),
    returns updated ``(vp, vm)`` and outgoing ``(hpw, hmw)`` bits.

    Elementwise over any shape. Mirrors the recurrence of `myers.rs:27-55`
    including the extension that allows input h = -1 (``eq |= hm0``).
    """
    vx = eq | vm
    eq = eq | hm0
    # The carry-propagating add is the 'folding' step of Myers'99.
    hx = (((eq & vp) + vp) ^ vp) | eq
    hp = vm | ~(hx | vp)
    hm = vp & hx
    hpw = hp >> _TOPBIT
    hmw = hm >> _TOPBIT
    hp = (hp << 1) | hp0
    hm = (hm << 1) | hm0
    vp_new = hm | ~(vx | hp)
    vm_new = hp & vx
    return vp_new, vm_new, hpw, hmw


def eq_cols(a0, a1, pb0, pb1):
    """Match masks for columns x words: eq[i, w] (`profile.rs:141-144`)."""
    return (a0[:, None] ^ pb0[None, :]) & (a1[:, None] ^ pb1[None, :])


def compute_block(a0, a1, pb0, pb1, vp, vm, hp_in, hm_in):
    """Compute a block of ``ncols`` columns over ``nwords`` words.

    Args:
      a0, a1: (ncols,) uint32 exploded bit-planes of the ``a`` slice.
      pb0, pb1: (nwords,) uint32 packed negated profile of the ``b`` slice.
      vp, vm: (nwords,) uint32 vertical diffs at the left edge (updated).
      hp_in, hm_in: (ncols,) uint32 horizontal diff bits at the top edge.

    Returns:
      (vp, vm, hp_out, hm_out): right-edge vertical diffs and bottom-edge
      horizontal diff bits per column.

    Equivalent to the reference's `simd::compute` with h input+output
    (`simd.rs:98-226`); HMode variants (`blocks.rs:729-747`) are expressed
    by what the caller passes/keeps.
    """

    def col_step(v, xs):
        vp, vm = v
        ca0, ca1, hp, hm = xs
        eq = (ca0 ^ pb0) & (ca1 ^ pb1)

        def word_step(h, xs_w):
            hp, hm = h
            eq_w, vp_w, vm_w = xs_w
            vp_w, vm_w, hp, hm = step_word(eq_w, vp_w, vm_w, hp, hm)
            return (hp, hm), (vp_w, vm_w)

        (hp, hm), (vp, vm) = jax.lax.scan(word_step, (hp, hm), (eq, vp, vm))
        return (vp, vm), (hp, hm)

    (vp, vm), (hp_out, hm_out) = jax.lax.scan(
        col_step, (vp, vm), (a0, a1, hp_in, hm_in)
    )
    return vp, vm, hp_out, hm_out


def fill_block(a0, a1, pb0, pb1, vp, vm, hp_in, hm_in):
    """Like :func:`compute_block` but also returns v after *every* column.

    Equivalent to `simd::fill` (`simd.rs:326-437`), used for traceback.
    Returns (vp, vm, hp_out, hm_out, vp_cols, vm_cols) where ``vp_cols`` has
    shape (ncols, nwords).
    """

    def col_step(v, xs):
        vp, vm = v
        ca0, ca1, hp, hm = xs
        eq = (ca0 ^ pb0) & (ca1 ^ pb1)

        def word_step(h, xs_w):
            hp, hm = h
            eq_w, vp_w, vm_w = xs_w
            vp_w, vm_w, hp, hm = step_word(eq_w, vp_w, vm_w, hp, hm)
            return (hp, hm), (vp_w, vm_w)

        (hp, hm), (vp, vm) = jax.lax.scan(word_step, (hp, hm), (eq, vp, vm))
        return (vp, vm), (vp, vm, hp, hm)

    (vp, vm), (vp_cols, vm_cols, hp_out, hm_out) = jax.lax.scan(
        col_step, (vp, vm), (a0, a1, hp_in, hm_in)
    )
    return vp, vm, hp_out, hm_out, vp_cols, vm_cols


def popcount(x):
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def value_to(vp, vm, j):
    """Sum of vertical diffs of rows [0, j) given word planes (device).

    `V::value_to` equivalent (`encoding.rs:54-63`) on (nwords,) arrays.
    """
    nwords = vp.shape[-1]
    rows = jnp.arange(nwords, dtype=jnp.int32) * W
    full = jnp.clip(j - rows, 0, W)
    mask = jnp.where(
        full >= W, _ONES, (U32(1) << full.astype(jnp.uint32)) - U32(1)
    )
    return jnp.sum(popcount(vp & mask) - popcount(vm & mask), axis=-1)


def compute_block_eq(eqs, vp, vm, hp_in, hm_in):
    """Like :func:`compute_block` but over precomputed match masks.

    ``eqs``: (ncols, nwords) uint32 — one mask row per column.  Used by the
    scatter-profile (wildcard) path where eq is a table lookup rather than
    the BitProfile xor trick (cf. `simd/scatter_profile.rs:6-76`).
    """

    def col_step(v, xs):
        vp, vm = v
        eq, hp, hm = xs

        def word_step(h, xs_w):
            hp, hm = h
            eq_w, vp_w, vm_w = xs_w
            vp_w, vm_w, hp, hm = step_word(eq_w, vp_w, vm_w, hp, hm)
            return (hp, hm), (vp_w, vm_w)

        (hp, hm), (vp, vm) = jax.lax.scan(word_step, (hp, hm), (eq, vp, vm))
        return (vp, vm), (hp, hm)

    (vp, vm), (hp_out, hm_out) = jax.lax.scan(col_step, (vp, vm), (eqs, hp_in, hm_in))
    return vp, vm, hp_out, hm_out


def fill_block_eq(eqs, vp, vm, hp_in, hm_in):
    """:func:`fill_block` over precomputed match masks; returns per-column v."""

    def col_step(v, xs):
        vp, vm = v
        eq, hp, hm = xs

        def word_step(h, xs_w):
            hp, hm = h
            eq_w, vp_w, vm_w = xs_w
            vp_w, vm_w, hp, hm = step_word(eq_w, vp_w, vm_w, hp, hm)
            return (hp, hm), (vp_w, vm_w)

        (hp, hm), (vp, vm) = jax.lax.scan(word_step, (hp, hm), (eq, vp, vm))
        return (vp, vm), (vp, vm, hp, hm)

    (vp, vm), (vp_cols, vm_cols, hp_out, hm_out) = jax.lax.scan(
        col_step, (vp, vm), (eqs, hp_in, hm_in)
    )
    return vp, vm, hp_out, hm_out, vp_cols, vm_cols


# --- Batched full-rectangle NW cost (the minimum end-to-end slice) ---------


def row_valid_mask(nwords, m):
    """Per-word uint32 masks with bits set for rows < m."""
    rows = jnp.arange(nwords, dtype=jnp.int32) * W
    full = jnp.clip(m - rows, 0, W)
    return jnp.where(full >= W, _ONES, (U32(1) << full.astype(jnp.uint32)) - U32(1))


def nw_cost_padded(a0, a1, pb0, pb1, n, m):
    """Edit distance of one (padded) pair via full-rectangle bitpacked NW.

    a0/a1: (max_n,) padded with arbitrary chars; pb: (max_words,).
    ``n``/``m`` are the true lengths (traced scalars).

    Columns >= n are skipped by keeping the scan carry unchanged, so the
    final ``(vp, vm)`` is the right edge at column ``n`` and
    ``cost = D[n][m] = n + value_to(v, m)`` (prefix popcount up to row m;
    padded rows below ``m`` are computed but never read).
    """

    def col_step(carry, xs):
        vp, vm, i = carry
        ca0, ca1 = xs
        eq = (ca0 ^ pb0) & (ca1 ^ pb1)

        def word_step(h, xs_w):
            hp, hm = h
            eq_w, vp_w, vm_w = xs_w
            vp_w, vm_w, hp, hm = step_word(eq_w, vp_w, vm_w, hp, hm)
            return (hp, hm), (vp_w, vm_w)

        _, (vp2, vm2) = jax.lax.scan(word_step, (U32(1), U32(0)), (eq, vp, vm))
        active = i < n
        vp = jnp.where(active, vp2, vp)
        vm = jnp.where(active, vm2, vm)
        return (vp, vm, i + 1), None

    nwords = pb0.shape[0]
    vp0 = jnp.full((nwords,), _ONES, dtype=U32)
    vm0 = jnp.zeros((nwords,), dtype=U32)
    (vp, vm, _), _ = jax.lax.scan(col_step, (vp0, vm0, jnp.int32(0)), (a0, a1))
    return n.astype(jnp.int32) + value_to(vp, vm, m)


nw_cost_batch = jax.jit(jax.vmap(nw_cost_padded))
