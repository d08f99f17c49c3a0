"""Native batch pack vs the numpy/device reference: bit parity.

The native pack (`native/astarpa_native.cpp::pack_batch_planes`, consumed
via `ops.bitpack.pack_batch_staggered`) must produce the EXACT
(a0, a1, pb0, pb1) planes of the numpy staging path for every geometry —
the kernels' correctness certificates assume one packed layout.
"""

import numpy as np
import pytest

from astarpa_tpu import generate, native
from astarpa_tpu.ops import bitpack

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _numpy_pack(pairs, lane_multiple, shape_quantum=None):
    """The pre-native reference path, forced."""
    B0 = len(pairs)
    B = max(lane_multiple, -(-B0 // lane_multiple) * lane_multiple)
    ns = np.array([len(a) for a, _ in pairs] + [1] * (B - B0), np.int32)
    ms = np.array([len(b) for _, b in pairs] + [1] * (B - B0), np.int32)
    n_max = max(8, int(ns.max()))
    S = max(1, bitpack.n_words(int(ms.max())))
    if shape_quantum:
        n_q = -(-n_max // shape_quantum) * shape_quantum
        ratio = -(-(S * bitpack.W * 256) // n_max)
        n_max = n_q
        S = max(S, -(-(n_q * ratio) // (256 * bitpack.W)))
    acodes = np.zeros((B, n_max), dtype=np.uint8)
    bcodes = np.full((B, S * bitpack.W), 0xFF, dtype=np.uint8)
    for idx, (a, b) in enumerate(pairs):
        acodes[idx, : len(a)] = np.frombuffer(a, np.uint8)
        bcodes[idx, : len(b)] = np.frombuffer(b, np.uint8)
    return bitpack._pack_planes(acodes, bcodes, S), (n_max, S, B)


@pytest.mark.parametrize("quantum", [None, 128])
def test_native_pack_bit_parity(quantum):
    rng = np.random.default_rng(3)
    pairs = []
    for s in range(13):  # odd count -> padding lanes exercised
        n = int(rng.integers(1, 700))
        e = float(rng.choice([0.0, 0.05, 0.3]))
        pairs.append(generate.uniform_seeded(n, e, 500 + s))
    pairs.append((b"", b""))  # empty pair
    pairs.append((b"A" * 5, b"C"))  # tiny skewed

    (ref_a0, ref_a1, ref_pb0, ref_pb1), (n_max, S, B) = _numpy_pack(
        pairs, 16, quantum
    )
    a4, pb0pm, pb1pm = native.pack_batch_planes(pairs, B, n_max, S)
    got = bitpack._unpack_planes(a4, pb0pm, pb1pm, n_max=n_max)
    for ref, g, name in zip(
        (ref_a0, ref_a1, ref_pb0, ref_pb1), got, "a0 a1 pb0 pb1".split()
    ):
        assert np.array_equal(np.asarray(ref), np.asarray(g)), name


def test_pack_batch_staggered_uses_native_and_matches():
    """End-to-end: the public entry gives identical planes whichever path
    it takes (native available here)."""
    pairs = [generate.uniform_seeded(200 + 7 * s, 0.1, 40 + s)
             for s in range(5)]
    (args, B0) = bitpack.pack_batch_staggered(pairs, lane_multiple=8)
    (ref, _), _geo = _numpy_pack(pairs, 8), None
    for r, g in zip(ref, args[:4]):
        assert np.array_equal(np.asarray(r), np.asarray(g))
    assert B0 == 5
    assert np.asarray(args[4]).shape[0] % 8 == 0
