"""Scalar block-grid traversal orders (host benchmark variants).

Mirror of `pa-bitpacking/src/scalar.rs:9-99`: the word-level Myers step
(:func:`astarpa_tpu.ops.myers.step_word`) sweeps an (n columns) x (nw
word-rows) grid, and the *order* of the sweep is a free choice — each cell
depends only on its left neighbour (through the ``h`` bits) and its upper
neighbour (through the ``v`` word).  The reference keeps col/row/diagonal
orders as scalar benchmark fodder for memory-layout exploration; here they
double as an executable statement of the dependency structure the device
kernels exploit:

- ``col`` / ``col_local_h`` — column-major: the order of the banded
  kernels (`ops/banded.py`, `ops/cuda_banded.py`), which walk columns and
  carry ``v`` in registers.
- ``row`` — row-major: words resident, columns streamed.
- ``diag_ru`` / ``diag_ld`` — anti-diagonal: all cells on one anti-diagonal
  are independent (a staggered wavefront); the two orders differ only in
  sweep direction (and, in numpy, ``diag_*`` vectorize across the
  diagonal).

All five produce bit-identical ``(vp, vm, hp, hm)`` states; the parity test
(`tests/test_extras.py`) asserts that and checks the distance against the
oracle.
"""

from __future__ import annotations

import numpy as np

from .bitpack import ONES, W
from .myers import step_word


def _eq(ca0, ca1, pb0w, pb1w):
    return (ca0 ^ pb0w) & (ca1 ^ pb1w)


def _init(n: int, nw: int):
    vp = np.full(nw, ONES, np.uint32)
    vm = np.zeros(nw, np.uint32)
    hp = np.ones(n, np.uint32)
    hm = np.zeros(n, np.uint32)
    return vp, vm, hp, hm


def col(a0, a1, pb0, pb1):
    """Column by column (`scalar.rs:9-18`)."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw)
    with np.errstate(over="ignore"):
        for i in range(n):
            for w in range(nw):
                vp[w], vm[w], hp[i], hm[i] = step_word(
                    _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], hp[i], hm[i]
                )
    return vp, vm, hp, hm


def col_local_h(a0, a1, pb0, pb1):
    """Column by column with the h bit kept local (`scalar.rs:20-34`);
    valid because the top edge always enters with h = +1."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw)
    with np.errstate(over="ignore"):
        for i in range(n):
            h = (np.uint32(1), np.uint32(0))
            for w in range(nw):
                vp[w], vm[w], *h = step_word(
                    _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], *h
                )
            hp[i], hm[i] = h
    return vp, vm, hp, hm


def row(a0, a1, pb0, pb1):
    """Word-row by word-row (`scalar.rs:36-46`)."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw)
    with np.errstate(over="ignore"):
        for w in range(nw):
            for i in range(n):
                vp[w], vm[w], hp[i], hm[i] = step_word(
                    _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], hp[i], hm[i]
                )
    return vp, vm, hp, hm


def _diag(a0, a1, pb0, pb1, reverse: bool):
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw)
    with np.errstate(over="ignore"):
        for d in range(1, n + nw):
            i0, i1 = max(d - nw, 0), min(d, n)
            ii = np.arange(i0, i1)
            ww = d - 1 - ii  # pairs (i, w) on the anti-diagonal, independent
            if reverse:
                ii, ww = ii[::-1], ww[::-1]
            eq = _eq(a0[ii], a1[ii], pb0[ww], pb1[ww])
            nvp, nvm, nhp, nhm = step_word(eq, vp[ww], vm[ww], hp[ii], hm[ii])
            vp[ww], vm[ww], hp[ii], hm[ii] = nvp, nvm, nhp, nhm
    return vp, vm, hp, hm


def diag_ru(a0, a1, pb0, pb1):
    """Anti-diagonals, each swept right-up (`scalar.rs:48-75`); in numpy the
    independent cells vectorize into one `step_word` call per diagonal."""
    return _diag(a0, a1, pb0, pb1, reverse=False)


def diag_ld(a0, a1, pb0, pb1):
    """Anti-diagonals, each swept left-down (`scalar.rs:77-99`)."""
    return _diag(a0, a1, pb0, pb1, reverse=True)


LAYOUTS = {
    "col": col,
    "col_local_h": col_local_h,
    "row": row,
    "diag_ru": diag_ru,
    "diag_ld": diag_ld,
}


def distance(hp, hm, m_rows: int) -> int:
    """Unit-cost edit distance from the final bottom-edge h bits: value at
    (n, m) = m + sum of bottom horizontal deltas (rows must be word-aligned,
    i.e. ``m_rows == nw * W``)."""
    return int(m_rows + int(hp.astype(np.int64).sum()) - int(hm.astype(np.int64).sum()))
