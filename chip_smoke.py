"""Smoke run of the batch aligner on one NVIDIA GPU (or four with --mesh4).

Drives the main path the way a user does (``BatchAligner.cost_iter`` /
``align_iter``) on the two BASELINE deployments: config #2 (10 kbp pairs,
e = 5%, 4096 pairs per batch) and config #5 (500 kbp pairs, e = 15%, 128
pairs per batch), and checks the CUDA banded kernel bit for bit against
the jnp reference at both deployments' band widths and at wider bands up
to config #5's full height.  Every phase must pass;
the last line of stdout is one JSON object naming the device.

    python chip_smoke.py            # one card
    python chip_smoke.py --mesh4    # the batch-sharded path on four cards

Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N10, E10, B10 = 10_000, 0.05, 4096
N500, E500, B500 = 500_000, 0.15, 128


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


class Clock:
    """Wall time per phase, printed as it goes; set-up (generation,
    compilation, builds) is reported apart from the timed work."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self, what: str, t_start: float) -> float:
        dt = time.perf_counter() - t_start
        print(f"  [{what}] {dt:.3f} s", flush=True)
        return dt


def generate_pairs(pool, workers: int, count: int, n: int, e: float,
                   seed: int):
    """``generate.generate_batch(count, n, e, UNIFORM, seed)``, pair by pair
    on a pool of processes that never import JAX (same pairs: each pair
    has its own seed)."""
    from astarpa_tpu import generate

    seeds = [int(c.generate_state(1)[0])
             for c in np.random.SeedSequence(seed).spawn(count)]
    jobs = [(n, e, generate.ErrorModel.UNIFORM, s) for s in seeds]
    return pool.starmap(generate.generate_model, jobs,
                        chunksize=max(1, count // (4 * workers)))


def device_phase(want_count: int):
    import jax

    from astarpa_tpu.utils import device

    cache = device.enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r}); "
            "this run needs an NVIDIA GPU"
        )
    check(len(devs) >= want_count,
          f"needs {want_count} GPUs, JAX sees {len(devs)}")
    print(f"device: {devs[0].device_kind} x{len(devs)} "
          f"(platform {devs[0].platform}), jax {jax.__version__}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    print(f"nvidia-smi: {device.gpu_name_power()}", flush=True)
    return devs


def build_phase(clock: Clock) -> None:
    from astarpa_tpu import native
    from astarpa_tpu.ops import cuda_banded, kernels

    # Both libraries load here, before any thread uses them: without the
    # native runtime the oracle would fall back to an O(n*m) DP.
    t = time.perf_counter()
    native.load()
    clock.lap("set-up: native runtime build + load", t)
    t = time.perf_counter()
    built = cuda_banded.load()
    print(f"CUDA library: built in {built:.3f} s (0 = already built), "
          f"loaded in {time.perf_counter() - t:.3f} s", flush=True)
    check(kernels.banded_kernels().name == "cuda",
          "the gpu backend does not dispatch to the CUDA kernel")


def _timed(fn, reps: int):
    import jax

    out = jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t)
    return out, times


def _same(got, ref, what: str) -> None:
    import jax

    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g, r = np.asarray(g), np.asarray(r)
        check(g.shape == r.shape, f"{what}: shape {g.shape} != {r.shape}")
        bad = int((g != r).sum())
        check(bad == 0, f"{what}: {bad} of {g.size} values differ")


def skewed_pairs(count: int, n: int, m: int, seed: int):
    """Pairs whose ``a`` is an ordered sample of ``b``: the shared window
    slides down nearly every other column, so a band of ``m/32`` words or
    less is a sliding band."""
    from astarpa_tpu import generate

    rng = np.random.default_rng(seed)
    out = []
    for s in range(count):
        b, _ = generate.uniform_seeded(m + 97 * s, 0.0, seed + s)
        keep = np.sort(rng.choice(len(b), n + 13 * s, replace=False))
        out.append((bytes(np.frombuffer(b, np.uint8)[keep]), b))
    return out


def kernel_phase(clock: Clock, card: str, pairs10):
    """CUDA kernel vs the plain jnp reference, bit for bit."""
    import jax

    from astarpa_tpu.ops import banded, cuda_banded
    from astarpa_tpu.ops.bitpack import pack_batch_staggered

    # 10 kbp x 4096 at SW = 32: costs of every pair, against the jnp
    # reference jitted on the card (XLA's plain version).
    args, _ = pack_batch_staggered(pairs10, lane_multiple=len(pairs10))
    got, t_k = _timed(lambda: cuda_banded.banded_cost_cuda(*args, band_words=32), 5)
    t = time.perf_counter()
    ref = jax.block_until_ready(banded.banded_cost(*args, band_words=32))
    t_first = time.perf_counter() - t
    ref, t_p = _timed(lambda: banded.banded_cost(*args, band_words=32), 1)
    _same(got, ref, "10kbp cost")
    print(f"10kbp x{len(pairs10)} SW=32 cost: CUDA {np.median(t_k)*1e3:.3f} ms "
          f"(median of 5), plain XLA {t_p[0]*1e3:.1f} ms "
          f"(first call {t_first:.2f} s); equal; card {card}", flush=True)
    # Checkpoints for a subset.
    sub = pairs10[:256]
    args, _ = pack_batch_staggered(sub, lane_multiple=len(sub))
    got, t_k = _timed(lambda: cuda_banded.banded_ck_cuda(
        *args, band_words=32, col_block=2048), 3)
    ref, t_p = _timed(lambda: banded.banded_ck(
        *args, band_words=32, col_block=2048), 1)
    _same(got, ref, "10kbp ck")
    print(f"10kbp x{len(sub)} SW=32 ck CB=2048: CUDA "
          f"{np.median(t_k)*1e3:.3f} ms, plain XLA {t_p[0]*1e3:.1f} ms; "
          f"costs + checkpoint planes equal", flush=True)

    # A sliding 2048-word band (S > SW) against the reference on the CPU
    # device; shared schedule and the same schedule given per pair.
    t = time.perf_counter()
    big = skewed_pairs(8, 8000, 70_000, seed=11)
    args, _ = pack_batch_staggered(big, lane_multiple=8)
    S = args[2].shape[0]
    check(S > 2048, f"profile of {S} words does not slide a 2048-word band")
    clock.lap("set-up: sliding-band pairs", t)
    cpu = jax.devices("cpu")[0]
    t = time.perf_counter()
    with jax.default_device(cpu):
        host = [jax.device_put(np.asarray(a), cpu) for a in args]
        ref = jax.block_until_ready(
            banded.banded_ck(*host, band_words=2048, col_block=2048))
    t_ref = time.perf_counter() - t
    got, t_k = _timed(lambda: cuda_banded.banded_ck_cuda(
        *args, band_words=2048, col_block=2048), 3)
    _same(got, ref, "SW=2048 ck (shared)")
    n_max = args[0].shape[0]
    sched = np.broadcast_to(
        banded.shift_at_array(n_max, S, 2048)[:, None], args[0].shape
    ).astype(np.uint8)
    got = cuda_banded.banded_ck_cuda(*args, band_words=2048, col_block=2048,
                                     schedule=sched)
    _same(got, ref, "SW=2048 ck (per-pair)")
    _same(cuda_banded.banded_cost_cuda(*args, band_words=2048), ref[0],
          "SW=2048 cost")
    _same(cuda_banded.banded_cost_cuda(*args, band_words=2048,
                                       schedule=sched), ref[0],
          "SW=2048 cost (per-pair)")
    print(f"sliding band SW=2048 < S={S}, {len(big)} pairs x {n_max} columns, "
          f"CB=2048: CUDA ck {np.median(t_k)*1e3:.3f} ms, jnp reference on "
          f"the CPU {t_ref:.2f} s; costs + checkpoint planes equal (shared "
          f"and per-pair schedule); card {card}", flush=True)


def wide_band_cases(pairs5):
    """Bands past 2048 words, as ``(what, args, band, schedule, CB)``: 4096
    and 8192 words sliding under random per-pair schedules down to the
    profile's last row, and config #5's own pairs at full height (over 15k
    words) on a 96-column prefix."""
    from astarpa_tpu import generate
    from astarpa_tpu.ops.bitpack import pack_batch_staggered

    rng = np.random.default_rng(17)
    cases = []
    for sw, rows, cols in ((4096, 140_000, 384), (8192, 270_000, 256)):
        pairs = [(generate.random_seq(cols, rng),
                  generate.random_seq(rows + 37 * s, rng)) for s in range(4)]
        args, _ = pack_batch_staggered(pairs, lane_multiple=4)
        n_max, S = args[0].shape[0], args[2].shape[0]
        sched = np.zeros((n_max, 4), np.uint8)
        for p in range(4):
            sched[rng.choice(n_max, S - sw, replace=False), p] = 1
        cases.append((f"sliding band SW={sw} < S={S}, 4 pairs x {n_max} "
                      "columns, per-pair schedules", args, sw, sched, 64))
    prefix = [(a[:96], b) for a, b in pairs5[:2]]
    args, _ = pack_batch_staggered(prefix, lane_multiple=2)
    S = args[2].shape[0]
    check(S > 15_000, f"config #5 profile of {S} words")
    cases.append((f"full height SW=S={S}, 2 config #5 pairs, 96-column "
                  "prefix", args, S, None, 40))
    return cases


def wide_band_refs(cases):
    """The jnp reference of every case on the CPU device."""
    import jax

    from astarpa_tpu.ops import banded

    cpu = jax.devices("cpu")[0]
    refs = []
    with jax.default_device(cpu):
        for _, args, sw, sched, cb in cases:
            host = [jax.device_put(np.asarray(a), cpu) for a in args]
            kw = {} if sched is None else {"schedule": jax.device_put(sched, cpu)}
            refs.append(jax.tree.map(np.asarray, banded.banded_ck(
                *host, band_words=sw, col_block=cb, **kw)))
    return refs


def wide_band_phase(card: str, cases, refs) -> None:
    """CUDA kernel vs the jnp reference past 2048 words, bit for bit."""
    from astarpa_tpu.ops import cuda_banded

    for (what, args, sw, sched, cb), ref in zip(cases, refs):
        k, nw = cuda_banded.plan(sw)
        got, t_k = _timed(lambda: cuda_banded.banded_ck_cuda(
            *args, band_words=sw, col_block=cb, schedule=sched), 3)
        _same(got, ref, what)
        _same(cuda_banded.banded_cost_cuda(*args, band_words=sw,
                                           schedule=sched), ref[0],
              f"{what}: cost")
        print(f"{what}: {k} words per lane x {nw} warps, CB={cb}: CUDA ck "
              f"{np.median(t_k)*1e3:.3f} ms; costs + checkpoint planes equal "
              f"the jnp reference on the CPU; card {card}", flush=True)


def _check_results(pairs, results, kernels, oracle_idx, want_prefix="cuda-"):
    from astarpa_tpu import oracle

    check(len(results) == len(pairs), "result count")
    for (a, b), (cost, cig) in zip(pairs, results):
        check(cig.verify(a, b) == cost, "a CIGAR does not verify")
    for i in oracle_idx:
        want = oracle.levenshtein_myers(*pairs[i])
        check(results[i][0] == want,
              f"pair {i}: cost {results[i][0]} != oracle {want}")
    check(kernels and all(k.startswith(want_prefix) for k in kernels),
          f"kernel labels {sorted(set(kernels))}")


def main_path_10k(clock: Clock, pairs10, pairs10b):
    from astarpa_tpu.parallel.runner import BatchAligner

    batches = [pairs10, pairs10b, pairs10, pairs10b, pairs10]
    ba = BatchAligner()
    t = time.perf_counter()
    ba.align(pairs10)
    clock.lap("set-up: 10kbp first align (compiles, band hint)", t)
    marks = [time.perf_counter()]
    outs = []
    for res, stats in ba.align_iter(iter(batches)):
        outs.append((res, stats))
        marks.append(time.perf_counter())
    per = np.diff(marks)
    t = time.perf_counter()
    for k, (pairs, (res, stats)) in enumerate(zip(batches, outs)):
        _check_results(pairs, res, stats.kernels,
                       oracle_idx=range(k, len(pairs), max(1, len(pairs) // 4)))
    kernels = sorted({k for _, st in outs for k in st.kernels})
    clock.lap("checks: every CIGAR verified, 4 oracle pairs per batch", t)
    bp = len(pairs10) * N10
    print(f"10kbp align_iter x{len(batches)} batches of {len(pairs10)}: "
          f"periods {', '.join(f'{p:.3f}' for p in per)} s; mid-stream "
          f"{bp / np.median(per[1:-1]) / 1e6:.1f} Mbp/s; kernels {kernels}",
          flush=True)


def main_path_500k(clock: Clock, pairs5, oracle_futs):
    from astarpa_tpu import generate
    from astarpa_tpu.parallel.runner import BatchAligner

    ba = BatchAligner(band_words=2048, domain_mode="off")
    t = time.perf_counter()
    costs, stats = ba.cost_with_stats(pairs5)
    clock.lap(f"set-up: 500kbp first cost pass (compiles; kernels "
              f"{stats.kernels})", t)
    marks = [time.perf_counter()]
    outs = []
    for c, st in ba.cost_iter(iter([pairs5, pairs5])):
        outs.append((c, st))
        marks.append(time.perf_counter())
    for c, st in outs:
        check(list(map(int, c)) == list(map(int, costs)), "cost_iter drift")
        check(all(k.startswith("cuda-cost") for k in st.kernels),
              f"cost kernels {st.kernels}")
    bp = len(pairs5) * N500
    per = np.diff(marks)
    print(f"500kbp cost_iter x2 batches of {len(pairs5)}: periods "
          f"{', '.join(f'{p:.3f}' for p in per)} s; "
          f"{bp / per.min() / 1e6:.2f} Mbp/s; kernels "
          f"{sorted({k for _, st in outs for k in st.kernels})}", flush=True)

    t = time.perf_counter()
    got = list(ba.align_iter(iter([pairs5])))
    dt = time.perf_counter() - t
    res, st = got[0]
    t = time.perf_counter()
    _check_results(pairs5, res, st.kernels, oracle_idx=[])
    clock.lap("checks: every 500kbp CIGAR verified", t)
    check("cuda-ck" in st.kernels, f"no checkpoint kernel ran: {st.kernels}")
    t = time.perf_counter()
    for i, fut in enumerate(oracle_futs):
        want = fut.result()
        check(int(costs[i]) == want and res[i][0] == want,
              f"500kbp pair {i}: cost {costs[i]} / {res[i][0]} != {want}")
    clock.lap(f"checks: {len(oracle_futs)} pairs equal oracle.levenshtein_myers "
              "(waited for the rest of the oracle)", t)
    print(f"500kbp align_iter 1 batch of {len(pairs5)} (first ck dispatch, "
          f"compile included): {dt:.3f} s, {bp / dt / 1e6:.2f} Mbp/s; "
          f"kernels {st.kernels}", flush=True)

    # Per-pair schedules on the card: a small gap-domain batch.
    gap_pairs = [generate.generate_model(
        30_000, 0.04, list(generate.ErrorModel)[s % 3], 500 + s)
        for s in range(16)]
    gap_pairs += [(a, b[: len(b) * 3 // 4]) for a, b in gap_pairs[:4]]
    bag = BatchAligner(domain_mode="gap", domain_min_bp=0)
    t = time.perf_counter()
    costs_g, st_c = bag.cost_with_stats(gap_pairs)
    res_g, st_a = bag.align_with_stats(gap_pairs)
    clock.lap("gap-domain batch (compile included)", t)
    _check_results(gap_pairs, res_g, st_a.kernels, oracle_idx=[0, 16, 17])
    check(list(map(int, costs_g)) == [r[0] for r in res_g], "gap costs")
    pp = [k for k in st_c.kernels + st_a.kernels if "-pp" in k]
    check(pp and all(k.startswith("cuda-") for k in pp),
          f"no per-pair CUDA kernel ran: {st_c.kernels + st_a.kernels}")
    print(f"gap domains, {len(gap_pairs)} pairs: kernels "
          f"{sorted(set(st_c.kernels + st_a.kernels))}", flush=True)


def mesh_phase(devs, pairs10, pairs5, n_oracle: int = 2, prefix="cuda-"):
    """Config #2 cost + CIGAR and config #5 cost on a 4-device batch mesh,
    against one device in the same process."""
    import jax
    from jax.sharding import Mesh

    from astarpa_tpu.ops.bitpack import pack_batch_staggered
    from astarpa_tpu.parallel.runner import BatchAligner, BatchStats

    mesh = Mesh(np.array(devs[:4]), ("batch",))
    one = BatchAligner()
    four = BatchAligner(mesh=mesh)
    for name, pairs in (("10kbp", pairs10), ("500kbp", pairs5)):
        t = time.perf_counter()
        c1 = one.cost(pairs)
        t1 = time.perf_counter() - t
        t = time.perf_counter()
        c4, st = four.cost_with_stats(pairs)
        t4 = time.perf_counter() - t
        check(list(map(int, c1)) == list(map(int, c4)), f"{name} mesh costs")
        check(st.kernels and all(
            k.startswith(prefix) and k.endswith("-sharded") for k in st.kernels),
            f"{name} mesh kernels {st.kernels}")
        print(f"mesh4 {name} cost x{len(pairs)}: equal to one card; "
              f"kernels {sorted(set(st.kernels))}; first calls (compile "
              f"included) one card {t1:.2f} s, four {t4:.2f} s", flush=True)
    r1 = one.align(pairs10)
    r4, st = four.align_with_stats(pairs10)
    check([c for c, _ in r1] == [c for c, _ in r4], "10kbp mesh CIGAR costs")
    _check_results(pairs10, r4, st.kernels, oracle_idx=range(n_oracle),
                   want_prefix=prefix)
    check(all(k.endswith("-sharded") for k in st.kernels), "mesh align kernels")
    print(f"mesh4 10kbp cost+CIGAR x{len(pairs10)}: costs equal to one card, "
          f"every CIGAR verified; kernels {sorted(set(st.kernels))}", flush=True)
    # The sharded kernel ran on every device: one result shard per card,
    # each equal to the one-card slice.
    args, B0 = pack_batch_staggered(pairs10, lane_multiple=four._pack_multiple())
    sharded = four._shard(args)
    diag = four._diag(args[4], args[5], B0, args[0].shape[0], args[2].shape[0])
    out = four._dispatch(BatchStats(), sharded, 64, diag)
    ref = np.asarray(one._dispatch(BatchStats(), args, 64, diag))
    shards = out.addressable_shards
    check({s.device for s in shards} == set(mesh.devices.flat),
          f"result shards on {[s.device for s in shards]}")
    for s in shards:
        _same(s.data, ref[s.index], f"shard on {s.device}")
    print(f"mesh4: the sharded kernel's {len(shards)} result shards sit on "
          f"{sorted(str(s.device) for s in shards)}, each equal to the "
          f"one-card slice", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the batch-sharded path on four GPUs")
    opts = ap.parse_args(argv)
    clock = Clock()
    devs = device_phase(4 if opts.mesh4 else 1)
    from astarpa_tpu.utils import device

    card = device.gpu_name_power().splitlines()[0]
    build_phase(clock)

    from astarpa_tpu import oracle

    workers = min(16, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        t = time.perf_counter()
        pairs10 = generate_pairs(pool, workers, B10, N10, E10, seed=42)
        pairs10b = (None if opts.mesh4 else
                    generate_pairs(pool, workers, B10, N10, E10, seed=43))
        pairs5 = generate_pairs(pool, workers, B500, N500, E500, seed=7)
        clock.lap(f"set-up: generate {B10} x {N10} bp (x2) and "
                  f"{B500} x {N500} bp", t)
    with ThreadPoolExecutor(3) as ex:
        if opts.mesh4:
            mesh_phase(devs, pairs10, pairs5)
        else:
            # The 500 kbp oracle (full-height native Myers, GIL released)
            # and the wide bands' jnp references run beside the device
            # phases.
            futs = [ex.submit(oracle.levenshtein_myers, *pairs5[i])
                    for i in range(2)]
            t = time.perf_counter()
            wide = wide_band_cases(pairs5)
            wide_refs = ex.submit(wide_band_refs, wide)
            clock.lap("set-up: wide-band cases", t)
            t = time.perf_counter()
            kernel_phase(clock, card, pairs10)
            clock.lap("phase: kernel vs reference", t)
            t = time.perf_counter()
            main_path_10k(clock, pairs10, pairs10b)
            clock.lap("phase: main path 10kbp", t)
            t = time.perf_counter()
            main_path_500k(clock, pairs5, futs)
            clock.lap("phase: main path 500kbp", t)
            t = time.perf_counter()
            refs = wide_refs.result()
            clock.lap("waited for the wide-band references", t)
            t = time.perf_counter()
            wide_band_phase(card, wide, refs)
            clock.lap("phase: wide bands vs reference", t)
    peak = devs[0].memory_stats().get("peak_bytes_in_use", 0)
    print(f"peak device memory: {peak / 2**30:.2f} GiB; total "
          f"{time.perf_counter() - clock.t0:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
