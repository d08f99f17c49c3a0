"""2-bit q-gram iteration (mirror of `pa-heuristic/src/matches/qgrams.rs`).

Packing: ``(c >> 1) & 3`` => A=0, C=1, T=2, G=3; the first character of a
q-gram sits in the high-order bits (`qgrams.rs:34-42`).  All iterators are
vectorized NumPy (this is the per-host k-mer table build of the batch design).
"""

from __future__ import annotations

import numpy as np

from ..types import seq_to_codes


def qgrams_of(codes: np.ndarray, k: int) -> np.ndarray:
    """All sliding-window q-grams: out[j] = qgram of codes[j:j+k] (int64)."""
    m = len(codes)
    if m < k:
        return np.zeros(0, dtype=np.int64)
    c = codes.astype(np.int64)
    # Rolling via vectorized shifts: sum of c[j+t] << 2*(k-1-t).
    out = np.zeros(m - k + 1, dtype=np.int64)
    for t in range(k):
        out += c[t : m - k + 1 + t] << (2 * (k - 1 - t))
    return out


def a_qgrams(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Disjoint k-mers of ``a``: (starts, qgrams) (`qgrams.rs:44-51`)."""
    n = len(codes)
    starts = np.arange(0, n - k + 1, k, dtype=np.int64)
    if len(starts) == 0:
        return starts, starts
    sliding = qgrams_of(codes, k)
    return starts, sliding[starts]


def to_qgram(codes: np.ndarray) -> int:
    q = 0
    for c in codes:
        q = (q << 2) | int(c)
    return q
