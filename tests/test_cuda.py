"""CUDA banded kernel: the host-side plan and layout (CPU), and its
bit-equality with the jnp references (marker ``gpu``, on the card).

The card tests compare against the jnp references run on the process's
CPU device; ``chip_smoke.py`` repeats the comparison at real widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from astarpa_tpu import generate
from astarpa_tpu.ops import banded, cuda_banded
from astarpa_tpu.ops.bitpack import pack_batch_staggered


@pytest.mark.parametrize("sw", [1, 2, 31, 32, 33, 72, 256, 257, 512, 2048,
                                4096, 8192, 8193, 15626, 15873, 16384])
def test_plan_covers_band(sw):
    """The team covers the band with the fewest words per lane that keep
    it within TARGET_WARPS warps, and wastes less than one warp's slots;
    only K = 32 goes past TARGET_WARPS, up to MAX_WARPS (the register
    budget its instance is compiled for)."""
    k, nw = cuda_banded.plan(sw)
    assert k in cuda_banded.WORDS_PER_LANE
    limit = cuda_banded.TARGET_WARPS if k < 32 else cuda_banded.MAX_WARPS
    assert 1 <= nw <= limit
    assert nw * 32 * k >= sw > (nw - 1) * 32 * k
    smaller = [x for x in cuda_banded.WORDS_PER_LANE if x < k]
    if smaller:
        assert -(-sw // (32 * smaller[-1])) > cuda_banded.TARGET_WARPS
    # The team's two profile rings (one word per row plus one per 32
    # rows) fit in an H100 block's 227 KiB of shared memory.
    rows = nw * 32 * k
    assert 2 * 4 * (rows + rows // 32) <= 227 * 1024


@pytest.mark.parametrize("sw", [0, cuda_banded.MAX_BAND_WORDS + 1])
def test_plan_rejects(sw):
    with pytest.raises(ValueError):
        cuda_banded.plan(sw)


def _specs(n_max, S, B):
    a = jax.ShapeDtypeStruct((n_max, B), jnp.uint32)
    pb = jax.ShapeDtypeStruct((S, B), jnp.uint32)
    v = jax.ShapeDtypeStruct((B,), jnp.int32)
    return a, a, pb, pb, v, v


@pytest.mark.parametrize("per_pair", [False, True])
@pytest.mark.parametrize("n_max,S,B,sw,cb", [
    (100, 20, 16, 8, 30), (100, 20, 5, 64, 100), (4096, 130, 3, 128, 512),
])
def test_wrapper_layout_matches_reference(per_pair, n_max, S, B, sw, cb):
    """The FFI call's result shapes and dtypes (traced on CPU, never run)
    are those of the jnp references, for any batch size (no lane padding)
    and with the band clamped to the profile height."""
    sched = jnp.zeros((n_max, B), jnp.uint8) if per_pair else None
    specs = _specs(n_max, S, B)
    got_ck = jax.eval_shape(
        lambda *x: cuda_banded.banded_ck_cuda(*x, band_words=sw, col_block=cb,
                                              schedule=sched), *specs)
    ref_ck = jax.eval_shape(
        lambda *x: banded.banded_ck(*x, band_words=sw, col_block=cb,
                                    schedule=sched), *specs)
    assert got_ck == ref_ck
    got = jax.eval_shape(
        lambda *x: cuda_banded.banded_cost_cuda(*x, band_words=sw,
                                                schedule=sched), *specs)
    assert got == ref_ck[0]


@pytest.fixture
def gpu():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with ASTARPA_TEST_GPU=1)")
    cuda_banded.load()
    return devs[0]


def _on_cpu(fn, *args, **kw):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        args = [jax.device_put(np.asarray(a), cpu) for a in args]
        return jax.tree.map(np.asarray, fn(*args, **kw))


def _equal(got, ref):
    got = jax.tree.map(np.asarray, got)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.shape == r.shape and (g == r).all()


@pytest.mark.gpu
@pytest.mark.parametrize("sw", [1, 4, 8, 64])
def test_cuda_matches_jnp(gpu, sw):
    pairs = [generate.uniform_seeded(300 + 37 * s % 300, [0.02, 0.1, 0.25][s % 3], s)
             for s in range(64)]
    args, _ = pack_batch_staggered(pairs, lane_multiple=64)
    a0, _a1, pb0, _pb1, n, m = args
    ref = _on_cpu(banded.banded_ck, *args, band_words=sw, col_block=64)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=sw, col_block=64), ref)
    _equal(cuda_banded.banded_cost_cuda(*args, band_words=sw), ref[0])
    sched, _ = banded.pair_gap_schedule(n, m, min(sw, pb0.shape[0]),
                                        a0.shape[0], pb0.shape[0])
    ref = _on_cpu(lambda *x, **k: banded.banded_ck(*x[:6], schedule=x[6], **k),
                  *args, sched, band_words=sw, col_block=100)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=sw, col_block=100,
                                      schedule=sched), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("sw", [33, 300, 515])
def test_cuda_matches_jnp_sliding_multiwarp(gpu, sw):
    """Skewed pairs slide the window every few columns; bands over 256
    words take several warps per pair."""
    rng = np.random.default_rng(5)
    pairs = []
    for s in range(16):
        b, _ = generate.uniform_seeded(15000 + 97 * s, 0.0, 50 + s)
        keep = np.sort(rng.choice(len(b), 600 + 11 * s, replace=False))
        pairs.append((bytes(np.frombuffer(b, np.uint8)[keep]), b))
    args, _ = pack_batch_staggered(pairs, lane_multiple=16)
    a0, pb0 = args[0], args[2]
    ref = _on_cpu(banded.banded_ck, *args, band_words=sw, col_block=128)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=sw, col_block=128), ref)
    shared = np.broadcast_to(
        banded.shift_at_array(a0.shape[0], pb0.shape[0],
                              min(sw, pb0.shape[0]))[:, None],
        a0.shape,
    ).astype(np.uint8)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=sw, col_block=128,
                                      schedule=shared), ref)


def _prefix_pairs(rows: int, cols: int, count: int, seed: int):
    """``count`` pairs of a ``cols``-char ``a`` against a ``rows``-char
    ``b``: a column prefix of a pair with a ``rows``-row profile."""
    rng = np.random.default_rng(seed)
    return [(generate.random_seq(cols, rng), generate.random_seq(rows + 37 * s, rng))
            for s in range(count)]


@pytest.mark.gpu
@pytest.mark.parametrize("sw,rows,cols", [(4096, 140_000, 384),
                                          (8192, 270_000, 256)])
def test_cuda_matches_jnp_wide_band(gpu, sw, rows, cols):
    """16 and 32 words per lane in an 8-warp team, sliding under random
    per-pair schedules all the way down to the profile's last row."""
    pairs = _prefix_pairs(rows, cols, 4, seed=sw)
    args, _ = pack_batch_staggered(pairs, lane_multiple=4)
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S > sw and cuda_banded.plan(sw)[1] == 8
    rng = np.random.default_rng(sw + 1)
    sched = np.zeros((n_max, 4), np.uint8)
    for p in range(4):
        sched[rng.choice(n_max, S - sw, replace=False), p] = 1
    ref = _on_cpu(lambda *x, **k: banded.banded_ck(*x[:6], schedule=x[6], **k),
                  *args, sched, band_words=sw, col_block=64)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=sw, col_block=64,
                                      schedule=sched), ref)
    _equal(cuda_banded.banded_cost_cuda(*args, band_words=sw, schedule=sched),
           ref[0])


@pytest.mark.gpu
def test_cuda_matches_jnp_full_height_500kbp(gpu):
    """A column prefix of 500 kbp pairs at full height: over 15k words,
    a 16-warp team of 32 words per lane."""
    pairs = _prefix_pairs(500_000, 96, 2, seed=3)
    args, _ = pack_batch_staggered(pairs, lane_multiple=2)
    S = args[2].shape[0]
    assert S > 15_000 and cuda_banded.plan(S) == (32, 16)
    ref = _on_cpu(banded.banded_ck, *args, band_words=S, col_block=40)
    _equal(cuda_banded.banded_ck_cuda(*args, band_words=S, col_block=40), ref)
    _equal(cuda_banded.banded_cost_cuda(*args, band_words=S), ref[0])
