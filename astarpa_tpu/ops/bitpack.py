"""Bit-profile construction for the Myers bitpacked DP (W = 32).

Re-design of `pa-bitpacking/src/profile.rs`:

- The reference packs 64 rows per machine word (`W=64`, `profile.rs:96-157`).
  The device kernels work on 32-bit words, so this framework uses ``W = 32`` rows per word
  (the algorithm is width-generic, cf. the reference's `small_blocks` W=u8
  feature, `pa-bitpacking/src/lib.rs:40-45`).
- `BitProfile` equality trick (`profile.rs:141-144`): store chars of ``a``
  as two sign-extended bit-planes and chars of ``b`` negated and bit-packed;
  then ``eq = (a0 ^ b0) & (a1 ^ b1)`` gives a 32-row match mask in 2 ops.

Padding: rows past ``len(b)`` are packed as a sentinel that matches nothing
(both negated planes complemented relative to every ``a`` char is not
possible with 2 bits, so instead the padded rows read as char 3; this is
harmless: the block drivers never *read* values at rows > len(b), and DP
values at row j only depend on rows <= j, so garbage below the band can
never corrupt in-band values).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Rows per word. The reference uses 64 (u64); the device kernels use 32-bit words.
W = 32

#: uint32 with all bits set (V::one() positive plane).
ONES = np.uint32(0xFFFFFFFF)


def n_words(m: int) -> int:
    return (m + W - 1) // W


def pack_a(a_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Explode ``a``'s 2-bit codes into sign-extended uint32 bit-planes.

    Returns ``(a0, a1)`` of shape ``(n,)``: ``a0[i]`` is all-ones iff bit 0
    of the code is set, likewise ``a1`` for bit 1
    (cf. `profile.rs:112-123`).
    """
    codes = np.asarray(a_codes, dtype=np.uint32)
    a0 = (np.uint32(0) - (codes & 1)).astype(np.uint32)
    a1 = (np.uint32(0) - ((codes >> 1) & 1)).astype(np.uint32)
    return a0, a1


def pack_b(b_codes: np.ndarray, num_words: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pack ``b``'s 2-bit codes, negated, 32 chars per uint32 word.

    Returns ``(pb0, pb1)`` of shape ``(num_words,)`` where bit ``j % 32`` of
    word ``j // 32`` holds the *complement* of bit 0 / bit 1 of code ``j``
    (cf. `profile.rs:124-132`).  Padded rows read as code 3.
    """
    codes = np.asarray(b_codes, dtype=np.uint32)
    m = len(codes)
    nw = n_words(m) if num_words is None else num_words
    padded = np.full(nw * W, 3, dtype=np.uint32)
    padded[:m] = codes
    bits0 = ((padded & 1) ^ 1).astype(np.uint32)
    bits1 = (((padded >> 1) & 1) ^ 1).astype(np.uint32)
    shifts = np.arange(W, dtype=np.uint32)
    pb0 = (bits0.reshape(nw, W) << shifts).sum(axis=1, dtype=np.uint32)
    pb1 = (bits1.reshape(nw, W) << shifts).sum(axis=1, dtype=np.uint32)
    return pb0, pb1


def eq_mask(a0: int, a1: int, pb0: np.ndarray, pb1: np.ndarray) -> np.ndarray:
    """32-row match mask: bit j set iff a == b_j (`profile.rs:141-144`)."""
    return (a0 ^ pb0) & (a1 ^ pb1)


def popcount32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of uint32 (NumPy host-side)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x - ((x >> 1) & np.uint32(0x55555555))
        x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
        x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
        return ((x * np.uint32(0x01010101)) >> 24).astype(np.int32)


def v_value(vp: np.ndarray, vm: np.ndarray) -> np.ndarray:
    """Word value: popcount(p) - popcount(m) (`encoding.rs:20-22`)."""
    return popcount32(vp) - popcount32(vm)


def v_value_of_prefix(vp: int, vm: int, j: int) -> int:
    """Value of the first ``j`` bits, 0 <= j < W (`encoding.rs:26-30`)."""
    assert 0 <= j < W
    mask = np.uint32((1 << j) - 1)
    return int(popcount32(np.uint32(vp) & mask)) - int(popcount32(np.uint32(vm) & mask))


def v_value_of_suffix(vp: int, vm: int, j: int) -> int:
    """Value of the last ``j`` bits, 0 < j <= W (`encoding.rs:34-38`)."""
    assert 0 < j <= W
    mask = np.uint32(((1 << j) - 1) << (W - j))
    return int(popcount32(np.uint32(vp) & mask)) - int(popcount32(np.uint32(vm) & mask))


def pack_batch_staggered(pairs, lane_multiple: int = 512,
                         shape_quantum: int | None = None):
    """Pack byte pairs into the (n_max, B)/(S, B) layout of the banded
    kernels: returns ``((a0, a1, pb0, pb1, ns, ms), B0)`` with the batch
    padded to a multiple of ``lane_multiple`` (padding lanes are n = m = 1
    pairs whose results are ignored).

    Fully vectorized over the batch (one 2-D codes matrix per side; the
    per-pair python work is just the byte copy) — packing 4096 x 10kbp
    pairs takes ~100ms, not seconds.

    shape_quantum: round the padded column count UP to this multiple and
    set the profile height from a 1/256-quantized bucket-diagonal ratio,
    so a stream of same-sized batches reuses one compiled kernel geometry
    instead of compiling one per batch's slightly different max-m.  The
    shared band schedule's slope is S*W/n_max, so preserving the RATIO
    (not just rounding S) keeps the band_threshold skew penalty bounded by
    ~n/256 extra rows.
    """
    B0 = len(pairs)
    B = max(lane_multiple, -(-B0 // lane_multiple) * lane_multiple)
    ns = np.array([len(a) for a, _ in pairs] + [1] * (B - B0), dtype=np.int32)
    ms = np.array([len(b) for _, b in pairs] + [1] * (B - B0), dtype=np.int32)
    n_max = max(8, int(ns.max()))
    S = max(1, n_words(int(ms.max())))
    if shape_quantum:
        n_q = -(-n_max // shape_quantum) * shape_quantum
        ratio = -(-(S * W * 256) // n_max)  # ceil, 1/256ths
        n_max = n_q
        S = max(S, -(-(n_q * ratio) // (256 * W)))

    from .. import native

    if native.available():
        # Native pack (GIL-released C++): 2-bit codes + b bit planes built
        # straight from the pair buffers — no (B, n_max) uint8 staging and
        # ~4x fewer bytes to upload; the device just unpacks/transposes
        # (bit-identical to the numpy path, tests/test_pack.py).
        a4, pb0pm, pb1pm = native.pack_batch_planes(pairs, B, n_max, S)
        a0, a1, pb0, pb1 = _unpack_planes(
            jnp.asarray(a4), jnp.asarray(pb0pm), jnp.asarray(pb1pm),
            n_max=n_max,
        )
        # ns/ms stay host-resident numpy: the runner reads them per rung
        # (_diag, band_threshold, direct_cap); kernel dispatches upload
        # them.
        return (a0, a1, pb0, pb1, ns, ms), B0

    acodes = np.zeros((B, n_max), dtype=np.uint8)
    bcodes = np.full((B, S * W), 0xFF, dtype=np.uint8)  # pad char
    for idx, (a, b) in enumerate(pairs):
        acodes[idx, : len(a)] = np.frombuffer(a, np.uint8)
        bcodes[idx, : len(b)] = np.frombuffer(b, np.uint8)
    # Bit-plane math runs on device (uint8 codes upload 4x less data than
    # uint32 planes, and the transposes are free there).
    a0, a1, pb0, pb1 = _pack_planes(acodes, bcodes, S)
    return (a0, a1, pb0, pb1, ns, ms), B0


@functools.partial(jax.jit, static_argnames=("n_max",))
def _unpack_planes(a4, pb0pm, pb1pm, n_max: int):
    """Device half of the native pack: unpack 4-per-byte a codes into the
    (n_max, B) sign-mask planes and transpose the pair-major b planes."""
    B = a4.shape[0]
    shifts = (jnp.arange(4, dtype=jnp.uint8) * 2)[None, None, :]
    ac = ((a4[:, :, None] >> shifts) & 3).reshape(B, -1)
    ac = ac[:, :n_max].astype(jnp.uint32)
    a0 = (jnp.uint32(0) - (ac & 1)).T
    a1 = (jnp.uint32(0) - ((ac >> 1) & 1)).T
    return a0, a1, pb0pm.T, pb1pm.T


@functools.partial(jax.jit, static_argnames=("S",))
def _pack_planes(acodes, bcodes, S: int):
    B = acodes.shape[0]
    ac = ((acodes >> 1) & 3).astype(jnp.uint32)
    bc = ((bcodes >> 1) & 3).astype(jnp.uint32)  # pad 0xFF -> code 3
    a0 = (jnp.uint32(0) - (ac & 1)).T
    a1 = (jnp.uint32(0) - ((ac >> 1) & 1)).T
    shifts = jnp.arange(W, dtype=jnp.uint32)
    bits0 = ((bc & 1) ^ 1).reshape(B, S, W)
    bits1 = (((bc >> 1) & 1) ^ 1).reshape(B, S, W)
    pb0 = (bits0 << shifts).sum(axis=2, dtype=jnp.uint32).T
    pb1 = (bits1 << shifts).sum(axis=2, dtype=jnp.uint32).T
    return a0, a1, pb0, pb1
