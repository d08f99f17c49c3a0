"""Banded batch kernel + BatchAligner tests vs the NumPy oracle."""

import numpy as np
import pytest

from astarpa_tpu import generate, oracle
from astarpa_tpu.ops import banded
from astarpa_tpu.ops.bitpack import pack_batch_staggered
from astarpa_tpu.parallel.runner import BatchAligner


def _mixed_pairs(seed0=0, count=16):
    pairs = []
    models = list(generate.ErrorModel)
    for s in range(count):
        n = 200 + (s * 197) % 900
        e = [0.0, 0.02, 0.08, 0.2][s % 4]
        model = models[s % len(models)]
        pairs.append(generate.generate_model(n, e, model, seed0 + s))
    return pairs


def test_banded_certified_exact():
    """Certified (accepted) results must equal the oracle for every band."""
    pairs = _mixed_pairs(1)
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    expected = [oracle.levenshtein(a, b) for a, b in pairs]
    S = pb0.shape[0]
    accepted_any = np.zeros(B0, dtype=bool)
    for sw in (4, 8, 16, 32, 64):
        sw_eff = min(sw, S)
        got = np.asarray(banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=sw))[:B0]
        if sw_eff >= S:
            ok = np.ones(B0, bool)
        else:
            thr = banded.band_threshold(
                sw_eff, np.asarray(n)[:B0], np.asarray(m)[:B0], a0.shape[0], S * 32
            )
            ok = got <= thr
        for g, e, o in zip(got, expected, ok):
            assert g >= e  # always an upper bound
            if o:
                assert g == e
        accepted_any |= ok
    assert accepted_any.all()


def test_batch_aligner_costs():
    pairs = _mixed_pairs(7, count=24) + [(b"", b""), (b"ACGT", b""), (b"", b"ACGT")]
    ba = BatchAligner(band_words=4, lane_multiple=8)
    costs, stats = ba.cost_with_stats(pairs)
    expected = [oracle.levenshtein(a, b) for a, b in pairs]
    assert list(costs) == expected
    assert stats.pairs == len(pairs)
    assert stats.buckets >= 1


def test_batch_aligner_mixed_lengths():
    rng = np.random.default_rng(3)
    pairs = []
    for s in range(12):
        n = int(rng.integers(1, 2000))
        a, b = generate.uniform_seeded(n, float(rng.uniform(0, 0.3)), 1000 + s)
        pairs.append((a, b))
    # One extremely skewed pair exercising the full-window fallback bucket.
    pairs.append((b"ACG", b"ACGT" * 40))
    ba = BatchAligner(band_words=4, lane_multiple=8)
    costs = ba.cost(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_batch_aligner_extreme_skew():
    """m >> 32*n pairs have no valid shift schedule: the runner must route
    them straight to the always-exact full-height window (advisor finding:
    the singleton bucket used to re-enter the band ladder and assert)."""
    pairs = [
        (b"ACGTACGTACGT", generate.uniform_seeded(1000, 0.0, 5)[0]),
        (b"A" * 3, b"ACGT" * 300),
        (b"ACGT" * 300, b"A" * 3),  # skew in n is fine but covers the path
    ]
    ba = BatchAligner(band_words=4, lane_multiple=8)
    costs = ba.cost(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_batch_aligner_ladder_clamps_to_full_height():
    """Exhausting max_band_doublings clamps to sw = S (always exact) instead
    of raising 'band doubling did not converge'."""
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    b = a[::-1]
    ba = BatchAligner(band_words=2, lane_multiple=8, max_band_doublings=1)
    costs = ba.cost([(a, bytes(b))])
    assert list(costs) == [oracle.levenshtein(a, bytes(b))]


@pytest.mark.slow
def test_batch_aligner_mesh_bigband_ck():
    """Big-band CIGARs ride the mesh: every shard runs the checkpointing
    kernel at a band near full height, with verified CIGARs."""
    import jax
    from jax.sharding import Mesh

    from astarpa_tpu.parallel import runner as rmod

    devs = np.array(jax.devices()[:8])
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(devs, ("batch",))
    pairs = [
        generate.uniform_seeded(300 + 17 * s, 0.06, 40 + s) for s in range(4)
    ]
    ba = BatchAligner(band_words=8, lane_multiple=128, mesh=mesh,
                      domain_mode="off", direct_dt=False)
    res = ba.align(pairs)
    assert rmod.LAST_KERNEL == "jnp-ck-sharded"
    for (a, b), (c, cig) in zip(pairs, res):
        assert c == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == c


@pytest.mark.parametrize("backend,want", [
    ("cpu", "jnp"), ("gpu", RuntimeError), ("rocm", RuntimeError),
    ("metal", RuntimeError),
])
def test_mesh_ck_kind_routing_table(backend, want, monkeypatch):
    """The one dispatch table: cpu -> the jnp references; gpu -> the CUDA
    kernel, which cannot be built here (no nvcc), so it raises instead of
    falling back; any other backend raises."""
    from astarpa_tpu.ops import cuda_banded, kernels

    def no_library():
        raise RuntimeError("no CUDA library")

    monkeypatch.setattr(cuda_banded, "load", no_library)
    if want is RuntimeError:
        with pytest.raises(RuntimeError):
            kernels.banded_kernels(backend)
    else:
        kern = kernels.banded_kernels(backend)
        assert kern.name == want
        assert kern.cost is banded.banded_cost and kern.ck is banded.banded_ck


def test_dispatch_gpu_names_cuda_kernels(monkeypatch):
    """With the library loaded, gpu resolves to the CUDA entry points."""
    from astarpa_tpu.ops import cuda_banded, kernels

    monkeypatch.setattr(cuda_banded, "load", lambda: 0.0)
    kern = kernels.banded_kernels("gpu")
    assert kern.name == "cuda"
    assert kern.cost is cuda_banded.banded_cost_cuda
    assert kern.ck is cuda_banded.banded_ck_cuda


def test_batch_aligner_striped_first_ck():
    """Single-device ck dispatch: with direct traces off every rung runs
    the checkpointing kernel of the backend (labelled per rung), and the
    CIGARs traced from its checkpoints verify."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.uniform_seeded(300 + 17 * s, 0.06, 140 + s) for s in range(4)
    ]
    ba = BatchAligner(band_words=8, lane_multiple=128, domain_mode="off",
                      direct_dt=False)
    res, stats = ba.align_with_stats(pairs)
    assert stats.kernels and set(stats.kernels) == {"jnp-ck"}, stats.kernels
    for (a, b), (c, cig) in zip(pairs, res):
        assert c == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == c


@pytest.mark.slow
def test_shape_quantum_exactness():
    """Geometry-quantized packing (stream-stable compiled shapes) with the
    sticky diag-true schedule stays oracle-exact on a mixed bucket, for
    both the cost and the cost+CIGAR paths."""
    rng = np.random.default_rng(0)
    pairs = []
    for s in range(16):
        n = int(rng.integers(150, 700))
        e = float(rng.choice([0.02, 0.1, 0.25]))
        pairs.append(generate.uniform_seeded(n, e, 1000 + s))
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="off", shape_quantum=128)
    res, stats = ba.align_with_stats(pairs)
    for (a, b), (c, cig) in zip(pairs, res):
        assert c == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == c
    costs = ba.cost(pairs)
    assert all(
        int(c) == oracle.levenshtein(a, b)
        for (a, b), c in zip(pairs, costs)
    )
    # Sticky diag: the second align of the same-shaped batch reuses the
    # remembered aim (one jit entry), and band hints skip the probe rung.
    assert ba._diag_hints and ba._band_hints


def test_align_iter_pipelined_interpret():
    """Streaming align_iter yields per-batch results in order, identical to
    align(); batch k's traces drain while batch k+1 dispatches."""
    ba = BatchAligner(band_words=8, lane_multiple=128,
                      domain_mode="off")
    batches = [
        [generate.uniform_seeded(200 + 13 * s + 50 * k, 0.08, 100 * k + s)
         for s in range(3)]
        for k in range(3)
    ]
    got = list(ba.align_iter(iter(batches)))
    assert len(got) == 3
    for pairs, (res, stats) in zip(batches, got):
        assert stats.pairs == len(pairs)
        for (a, b), (c, cig) in zip(pairs, res):
            assert c == oracle.levenshtein(a, b)
            assert cig.verify(a, b) == c


def test_cost_iter_pipelined_interpret():
    """Streaming cost_iter yields per-batch exact costs in order, with
    batch k+1's pack/dispatch overlapping batch k's in-flight kernel;
    includes a trivial (empty) pair, a mixed bucket, and a retry-prone
    low starting band so the deferred-certification ladder is exercised."""
    ba = BatchAligner(band_words=2, lane_multiple=128,
                      domain_mode="off")
    batches = [
        [generate.uniform_seeded(180 + 11 * s + 40 * k, 0.12, 77 * k + s)
         for s in range(3)]
        for k in range(3)
    ]
    batches[1].append((b"", b"ACGT"))
    got = list(ba.cost_iter(iter(batches)))
    assert len(got) == 3
    for pairs, (costs, stats) in zip(batches, got):
        assert stats.pairs == len(pairs)
        for (a, b), c in zip(pairs, costs):
            assert int(c) == oracle.levenshtein(a, b)
    # Identical to the unpipelined path.
    ba2 = BatchAligner(band_words=2, lane_multiple=128,
                       domain_mode="off")
    for pairs, (costs, _st) in zip(batches, got):
        assert list(map(int, ba2.cost(pairs))) == list(map(int, costs))


def test_align_single_char_pairs_interpret():
    """Regression (found by scripts/fuzz.py --aligner batch): SW == S == 1
    pairs crashed the shared Pallas kernel at trace time — the shift
    branch's ref slices were statically out of bounds even though the
    schedule has no shifts (fixed by the static can_shift flag)."""
    ba = BatchAligner(band_words=2, lane_multiple=128,
                      domain_mode="off")
    pairs = [(b"A", b"A"), (b"A", b"C"), (b"AC", b"A")]
    for (a, b), (c, cig) in zip(pairs, ba.align(pairs)):
        assert c == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == c


def test_domain_auto_policy(monkeypatch):
    """"auto" engages per-pair domain modes only where they pay: gap is
    demoted to the plain shared ladder for UNIFORM buckets (per-pair
    kernels are slower per cell and gap only saves the bucket skew
    terms), kept for skewed buckets; gcsh needs >=8 host cores for the
    builds; explicit modes are never demoted."""
    import os

    from astarpa_tpu import native

    ba = BatchAligner(domain_mode="auto", domain_min_bp=1000)
    uni = [(bytes(2000), bytes(2000)) for _ in range(4)]
    skew = [(bytes(2000), bytes(1000)) for _ in range(4)]
    idx = list(range(4))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert ba._resolve_domain_mode(uni, idx, want_cigars=False) is None
    assert ba._resolve_domain_mode(skew, idx, want_cigars=False) == "gap"
    ba2 = BatchAligner(domain_mode="gap", domain_min_bp=1000)
    assert ba2._resolve_domain_mode(uni, idx, want_cigars=False) == "gap"
    if native.available():
        monkeypatch.setattr(os, "cpu_count", lambda: 64)
        assert ba._resolve_domain_mode(uni, idx, want_cigars=False) == "gcsh"


def test_batch_aligner_mesh():
    """Sharded over an 8-device CPU mesh (the multi-host recipe)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devs, axis_names=("batch",))
    pairs = _mixed_pairs(21, count=16)
    ba = BatchAligner(band_words=8, lane_multiple=8, mesh=mesh)
    costs = ba.cost(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_batch_aligner_mesh_runs_pallas():
    """Under a mesh every shard runs the backend's kernel through
    shard_map (8-device CPU mesh: the jnp cost kernel)."""
    import jax
    from jax.sharding import Mesh

    from astarpa_tpu.parallel import runner as runner_mod

    devs = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devs, axis_names=("batch",))
    pairs = [
        generate.uniform_seeded(40 + s % 17, [0.0, 0.1, 0.3][s % 3], 500 + s)
        for s in range(1024)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=1024, mesh=mesh)
    runner_mod.LAST_KERNEL = None
    costs, stats = ba.cost_with_stats(pairs)
    assert runner_mod.LAST_KERNEL == "jnp-cost-sharded"
    assert set(stats.kernels) == {"jnp-cost-sharded"}
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_batch_aligner_cigars():
    pairs = _mixed_pairs(40, count=6)
    ba = BatchAligner(band_words=8, lane_multiple=8)
    for (a, b), (cost, cigar) in zip(pairs, ba.align(pairs)):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_batch_aligner_cigars_fill_trace():
    """direct_dt=False: CIGARs come from the checkpointing kernel's
    planes (with it on, these small pairs trace directly)."""
    pairs = _mixed_pairs(40, count=6)
    ba = BatchAligner(band_words=8, lane_multiple=8, direct_dt=False)
    for (a, b), (cost, cigar) in zip(pairs, ba.align(pairs)):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_align_combined_ck_interpret():
    """The combined cost+CIGAR ladder (checkpointing kernel + native
    DT-burst traces) end to end on the CPU backend.
    direct_dt=False pins the checkpoint path — with it on, these small
    pairs would take the direct whole-pair DT trace instead."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.uniform_seeded(150 + (s * 41) % 80, [0.02, 0.12][s % 2], 40 + s)
        for s in range(24)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="off", direct_dt=False)
    results, stats = ba.align_with_stats(pairs)
    assert stats.direct_traces == 0
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


@pytest.mark.slow
def test_align_direct_dt_interpret():
    """Direct whole-pair DT traces: rungs whose certification threshold
    fits the native burst budget run the plain cost kernel and trace each
    certified pair from its certified cost alone — no checkpoint planes
    leave the device.  Mixed error rates + models, oracle-exact."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.generate_model(
            120 + (s * 53) % 300, [0.0, 0.05, 0.25][s % 3],
            list(generate.ErrorModel)[s % 4], 70 + s,
        )
        for s in range(24)
    ] + [(b"ACGT" * 30, b"")]  # trivial pair stays off-device
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="off")
    results, stats = ba.align_with_stats(pairs)
    assert stats.direct_traces == 24  # every nontrivial pair went direct
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_align_domain_ladder_ck_interpret():
    """The per-pair domain-ladder CIGAR path (checkpointing kernel with
    per-pair schedules + per-pair-schedule native traces)."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.generate_model(
            500 + 67 * s, [0.05, 0.15][s % 2],
            list(generate.ErrorModel)[s % 4], 900 + s,
        )
        for s in range(6)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="gap", domain_min_bp=0, direct_dt=False)
    results, stats = ba.align_with_stats(pairs)
    assert stats.direct_traces == 0
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


@pytest.mark.slow
def test_align_domain_ladder_direct_interpret():
    """Domain-ladder rounds whose f fits the burst budget run the per-pair
    COST kernel and trace each certified pair directly from its certified
    cost (per-pair schedule only used by the trace's recompute fallback)."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.generate_model(
            500 + 67 * s, [0.05, 0.15][s % 2],
            list(generate.ErrorModel)[s % 4], 950 + s,
        )
        for s in range(6)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="gap", domain_min_bp=0)
    results, stats = ba.align_with_stats(pairs)
    assert stats.direct_traces > 0
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_batch_aligner_mesh_ck_cigars():
    """Mesh parity for the product path: costs + CIGARs ride the sharded
    checkpointing kernel (8-device CPU mesh)."""
    import jax
    from jax.sharding import Mesh

    from astarpa_tpu import native
    from astarpa_tpu.parallel import runner as runner_mod

    if not native.available():
        pytest.skip("no native toolchain")
    devs = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devs, axis_names=("batch",))
    pairs = [
        generate.uniform_seeded(40 + s % 17, [0.0, 0.1, 0.3][s % 3], 800 + s)
        for s in range(48)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128, mesh=mesh,
                      domain_mode="off",
                      direct_dt=False)
    runner_mod.LAST_KERNEL = None
    results = ba.align(pairs)
    assert runner_mod.LAST_KERNEL == "jnp-ck-sharded"
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


@pytest.mark.slow
def test_batch_aligner_mesh_domain_ladder_ck():
    """The per-pair domain ladder also runs under a mesh: schedules shard
    with the pairs; the per-pair checkpointing kernel runs on every shard
    and CIGARs come from the per-pair-schedule native traces."""
    import jax
    from jax.sharding import Mesh

    from astarpa_tpu import native
    from astarpa_tpu.parallel import runner as runner_mod

    if not native.available():
        pytest.skip("no native toolchain")
    devs = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devs, axis_names=("batch",))
    pairs = [
        generate.uniform_seeded(350 + 41 * s, [0.04, 0.12][s % 2], 850 + s)
        for s in range(10)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128, mesh=mesh,
                      domain_mode="gap",
                      domain_min_bp=0, direct_dt=False)
    runner_mod.LAST_KERNEL = None
    results = ba.align(pairs)
    assert runner_mod.LAST_KERNEL in (
        "jnp-ck-pp-sharded", "jnp-ck-sharded"
    ), runner_mod.LAST_KERNEL
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_pallas_banded_parity_interpret():
    """The checkpoint twin's costs are the cost kernel's, bit for bit, at
    small, medium and near-full bands (shared schedule)."""
    pairs = [
        generate.uniform_seeded(300 + (s * 37) % 120, [0.02, 0.08, 0.15][s % 3], s)
        for s in range(32)
    ]
    args, B0 = pack_batch_staggered(pairs, lane_multiple=32)
    for sw in (4, 8, 13):
        ref = np.asarray(banded.banded_cost(*args, band_words=sw))
        got = np.asarray(banded.banded_ck(*args, band_words=sw, col_block=64)[0])
        assert (ref == got).all(), sw


def test_perpair_schedule_matches_shared():
    """A per-pair schedule equal to the bucket schedule must reproduce the
    shared-schedule kernel bit-for-bit (same boundary conditions)."""
    pairs = _mixed_pairs(11, count=12)
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    B = a0.shape[1]
    for sw in (4, 16):
        shared = np.asarray(banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=sw))
        sched = np.broadcast_to(
            banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B)
        ).astype(np.uint8)
        pp = np.asarray(
            banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=sw,
                               schedule=sched)
        )
        assert (shared == pp).all(), sw


def test_pair_gap_schedule_certified_exact():
    """Gap-centered per-pair schedules: accepted results (cost <= SW*W-6W)
    equal the oracle, including length-skewed pairs the shared bucket
    schedule cannot certify."""
    pairs = _mixed_pairs(31, count=12) + [
        (b"ACGT" * 30, b"ACGT" * 60),      # m = 2n skew
        (b"ACGT" * 60, b"ACGT" * 25),      # n > m skew
    ]
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    expected = [oracle.levenshtein(a, b) for a, b in pairs]
    accepted_any = np.zeros(B0, dtype=bool)
    for sw in (4, 8, 16, 32):
        sw = min(sw, S)
        sched, thr = banded.pair_gap_schedule(
            np.asarray(n)[:B0], np.asarray(m)[:B0], sw, n_max, S
        )
        full = np.zeros((n_max, a0.shape[1]), np.uint8)
        full[:, :B0] = sched
        got = np.asarray(
            banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=sw,
                               schedule=full)
        )[:B0]
        ok = got <= thr
        for g, e, o in zip(got, expected, ok):
            assert g >= e
            if o:
                assert g == e
        accepted_any |= ok
    assert accepted_any.all()


@pytest.mark.slow
def test_pallas_perpair_parity_interpret():
    """The per-pair checkpoint twin's costs are the per-pair cost kernel's
    (gap-centered schedules)."""
    pairs = [
        generate.uniform_seeded(200 + (s * 31) % 150, [0.02, 0.1, 0.25][s % 3], 70 + s)
        for s in range(128)
    ]
    args, B0 = pack_batch_staggered(pairs, lane_multiple=128)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    for sw in (4, 8, 16):
        sched, thr = banded.pair_gap_schedule(
            np.asarray(n), np.asarray(m), sw, n_max, S
        )
        ref = np.asarray(
            banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=sw,
                               schedule=sched)
        )
        got = np.asarray(banded.banded_ck(*args, band_words=sw, col_block=96,
                                          schedule=sched)[0])
        assert (ref == got).all(), sw


def test_domain_ladder_gap_mode():
    """The per-pair domain f-ladder (gap domains, no native needed for the
    schedule) produces exact costs via the jnp per-pair kernel on CPU."""
    pairs = [
        generate.generate_model(
            700 + 37 * s, [0.04, 0.15][s % 2],
            list(generate.ErrorModel)[s % 4], 300 + s,
        )
        for s in range(6)
    ] + [(b"ACGT" * 120, b"ACGT" * 250)]  # heavy length skew
    ba = BatchAligner(band_words=4, lane_multiple=8, domain_mode="gap",
                      domain_min_bp=0)
    costs, stats = ba.cost_with_stats(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_domain_ladder_gcsh_mode():
    """The gcsh domain ladder (native fwd+rev GCSH hulls) is exact."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = [
        generate.generate_model(1000 + 61 * s, 0.1, generate.ErrorModel.UNIFORM, s)
        for s in range(4)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=8, domain_mode="gcsh",
                      domain_min_bp=0, domain_k=10, domain_r=2)
    costs, stats = ba.cost_with_stats(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def test_domain_ladder_unservable_band_falls_back(monkeypatch):
    """When no kernel can serve a per-pair band (the CUDA kernel's plan
    raises ValueError past its band limit), the domain ladder breaks to the
    always-converging shared path instead of crashing."""
    from astarpa_tpu.ops import cuda_banded

    with pytest.raises(ValueError):
        cuda_banded.plan(cuda_banded.MAX_BAND_WORDS + 1)
    orig = BatchAligner._dispatch

    def boom(self, stats, args, sw, diag=None, schedule=None, CB=None):
        if schedule is not None:
            raise ValueError("no per-pair kernel fits")
        return orig(self, stats, args, sw, diag, schedule, CB)

    monkeypatch.setattr(BatchAligner, "_dispatch", boom)
    pairs = [generate.uniform_seeded(300 + 17 * s, 0.2, 60 + s)
             for s in range(3)]
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="gap", domain_min_bp=0)
    costs = ba.cost(pairs)
    assert [int(c) for c in costs] == [
        oracle.levenshtein(a, b) for a, b in pairs
    ]


def test_gcsh_prefetch_streaming():
    """Streaming with gcsh domains: the prefetched domain builds (batch
    k+1's handles built during batch k's device waits) are popped by the
    ladder and give exact results for both cost_iter and align_iter."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    batches = [
        [generate.generate_model(900 + 67 * s + 31 * k, 0.1,
                                 generate.ErrorModel.UNIFORM, 10 * k + s)
         for s in range(3)]
        for k in range(3)
    ]
    ba = BatchAligner(band_words=4, lane_multiple=128,
                      domain_mode="gcsh", domain_min_bp=0, domain_k=10,
                      domain_r=2)
    for pairs, (costs, _st) in zip(batches, ba.cost_iter(iter(batches))):
        assert [int(c) for c in costs] == [
            oracle.levenshtein(a, b) for a, b in pairs
        ]
    assert not ba._domain_prefetch, "prefetched futures must be consumed"
    for pairs, (res, _st) in zip(batches, ba.align_iter(iter(batches))):
        for (a, b), (c, cig) in zip(pairs, res):
            assert c == oracle.levenshtein(a, b)
            assert cig.verify(a, b) == c
    assert not ba._domain_prefetch


def test_batch_align_fill_native_trace():
    """Costs + CIGARs on mixed pairs, trivial ones included (skipped when
    no native toolchain)."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    pairs = _mixed_pairs(60, count=10) + [(b"", b"AC"), (b"AC", b""), (b"A", b"A")]
    ba = BatchAligner(band_words=4, lane_multiple=8)
    for (a, b), (cost, cigar) in zip(pairs, ba.align(pairs)):
        assert cost == oracle.levenshtein(a, b)
        assert cigar.verify(a, b) == cost


def test_banded_fill_matches_cost():
    pairs = _mixed_pairs(80, count=8)
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    costs = np.asarray(banded.banded_cost(a0, a1, pb0, pb1, n, m, band_words=8))
    fill_costs, vp_cols, vm_cols = banded.banded_fill(
        a0, a1, pb0, pb1, n, m, band_words=8
    )
    assert (np.asarray(fill_costs) == costs).all()
    assert vp_cols.shape[0] == a0.shape[0]


def _host_checkpoints(vp_cols, vm_cols, shift, n_vec, CB, n_blocks):
    """Derive (ckvp, ckvm, cktv) from the per-column fill, independently of
    the checkpoint kernels:
    checkpoint k = window planes + top_val after column k*CB (checkpoint 0 =
    all-ones init / 0).  Mirrors the kernel's order: absorb-on-shift before
    the column, +1 only while the pair is active."""
    n_max, SW, B = vp_cols.shape
    ckvp = np.zeros((n_blocks, SW, B), np.uint32)
    ckvm = np.zeros((n_blocks, SW, B), np.uint32)
    cktv = np.zeros((n_blocks, B), np.int32)
    ckvp[0] = 0xFFFFFFFF
    for k in range(1, n_blocks):
        ckvp[k] = vp_cols[k * CB - 1]
        ckvm[k] = vm_cols[k * CB - 1]
    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    tv = np.zeros(B, np.int64)
    for i in range(n_max):
        if i % CB == 0:
            cktv[i // CB] = tv
        if shift[i]:
            if i == 0:
                tv += 32
            else:
                tv += popc(vp_cols[i - 1, 0]) - popc(vm_cols[i - 1, 0])
        tv += (i < np.asarray(n_vec)).astype(np.int64)
    return ckvp, ckvm, cktv


@pytest.mark.parametrize("use_dt", [True, False])
def test_trace_banded_ck_cpu(use_dt):
    """Checkpointed native traceback: derive checkpoints from the jnp fill
    (= what the ck kernels emit) and verify exact CIGARs, both via DT
    bursts and via the stripe-recompute fallback."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    CB, SW = 64, 8
    pairs = _mixed_pairs(70, count=10)
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    costs, vp_cols, vm_cols = banded.banded_fill(a0, a1, pb0, pb1, n, m, band_words=SW)
    costs = np.asarray(costs)
    vp_cols = np.asarray(vp_cols)
    vm_cols = np.asarray(vm_cols)
    shift = banded.shift_at_array(n_max, S, SW)
    n_blocks = -(-n_max // CB)
    ckvp, ckvm, cktv = _host_checkpoints(vp_cols, vm_cols, shift, n, CB, n_blocks)
    checked = 0
    for slot, (a, b) in enumerate(pairs):
        thr = banded.band_threshold(SW, len(a), len(b), n_max, S * 32)
        if costs[slot] > thr:
            continue
        cost, cig = native.trace_banded_ck(
            a, b, S, ckvp[:, :, slot], ckvm[:, :, slot], cktv[:, slot],
            shift, SW, CB, use_dt=use_dt,
        )
        assert cost == costs[slot] == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == cost
        checked += 1
    assert checked >= len(pairs) // 2


def test_ck_kernel_interpret_top_val():
    """The checkpoint twin's planes and top_val match the host-derived
    checkpoints of the per-column fill."""
    pairs = [generate.uniform_seeded(200 + 13 * s, 0.1, 900 + s) for s in range(16)]
    args, B0 = pack_batch_staggered(pairs, lane_multiple=16)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    SW, CB = 8, 64
    costs, vp_cols, vm_cols = banded.banded_fill(a0, a1, pb0, pb1, n, m, band_words=SW)
    shift = banded.shift_at_array(n_max, S, SW)
    n_blocks = -(-n_max // CB)
    ckvp, ckvm, cktv = _host_checkpoints(
        np.asarray(vp_cols), np.asarray(vm_cols), shift, n, CB, n_blocks
    )
    got, kvp, kvm, ktv = banded.banded_ck(*args, band_words=SW, col_block=CB)
    assert (np.asarray(got) == np.asarray(costs)).all()
    assert (np.asarray(kvp) == ckvp).all()
    assert (np.asarray(kvm) == ckvm).all()
    assert (np.asarray(ktv) == cktv).all()


@pytest.mark.parametrize("per_pair", [False, True])
@pytest.mark.parametrize("sw,cb", [(2, 16), (4, 64), (8, 50), (13, 1000)])
def test_ck_twin_matches_fill(per_pair, sw, cb):
    """banded_ck's checkpoint k is the fill's state after column k*CB-1
    (k = 0: the all-ones init), and its costs are the cost kernel's, for
    the shared schedule and for per-pair (gap-centered) schedules."""
    pairs = _mixed_pairs(300 + sw, count=8)
    args, B0 = pack_batch_staggered(pairs, lane_multiple=8)
    a0, a1, pb0, pb1, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    SW = min(sw, S)
    sched = None
    if per_pair:
        sched, _thr = banded.pair_gap_schedule(np.asarray(n), np.asarray(m),
                                               SW, n_max, S)
    costs, vpc, vmc = jax_fill(args, SW, sched)
    got, kvp, kvm, ktv = (np.asarray(x) for x in banded.banded_ck(
        *args, band_words=sw, col_block=cb, schedule=sched))
    CB = min(cb, n_max)
    assert kvp.shape == (-(-n_max // CB), SW, a0.shape[1]) == kvm.shape
    assert ktv.shape == (kvp.shape[0], a0.shape[1])
    assert (got == costs).all()
    assert (kvp[0] == 0xFFFFFFFF).all() and (kvm[0] == 0).all()
    assert (ktv[0] == 0).all()
    for k in range(1, kvp.shape[0]):
        assert (kvp[k] == vpc[k * CB - 1]).all(), k
        assert (kvm[k] == vmc[k * CB - 1]).all(), k


def jax_fill(args, sw, sched):
    costs, vpc, vmc = banded.banded_fill(*args, band_words=sw, schedule=sched)
    return np.asarray(costs), np.asarray(vpc), np.asarray(vmc)


def test_ladder_band_jump():
    """A failed rung's banded cost is an upper bound on the true distance,
    so the ladder jumps straight to the certifying band (one retry per
    bucket instead of log2 doublings) — `ops/banded.py::band_for_cost`."""
    from astarpa_tpu.parallel.runner import BatchAligner

    pairs = [generate.uniform_seeded(900, 0.2, 100 + s) for s in range(16)]
    ba = BatchAligner(band_words=2, lane_multiple=16, domain_mode="off")
    costs, stats = ba.cost_with_stats(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    # Same sizes -> one bucket; band 2 fails once, the jump certifies.
    assert stats.band_retries == 1, stats.band_retries


def test_banded_cost_upper_bound():
    """Too-narrow banded costs never under-report the true distance (the
    property the ladder jump relies on)."""
    pairs = [
        generate.uniform_seeded(300 + 41 * s, [0.05, 0.2, 0.4][s % 3], s)
        for s in range(24)
    ]
    args, B0 = pack_batch_staggered(pairs, lane_multiple=24)
    a0, a1, pb0, pb1, n, m = args
    exact = np.array([oracle.levenshtein(a, b) for a, b in pairs])
    for sw in (2, 4, 8):
        costs = np.asarray(
            banded.banded_cost_block(a0, a1, pb0, pb1, n, m, band_words=sw)
        )[:B0]
        assert (costs >= exact).all(), sw
