"""Multi-host streaming alignment (SURVEY.md §2.6, BASELINE config #5).

Design: embarrassingly parallel over pairs.  Each host

1. reads its stripe of the input stream (``pairs[process_index::n]`` —
   deterministic, no coordination),
2. aligns its stripe on its local devices via :class:`BatchAligner`
   (bucketing + banded kernel + band doubling),
3. streams ``{cost},{cigar}`` lines to a per-host output shard,
4. merges global stats with one ``psum`` over a global 1-D ``hosts`` mesh
   (the only DCN collective in the pipeline).

`jax.distributed` supplies process identity; on a single process
everything degrades to host 0 of 1 (and tests drive the stripe/merge logic
with a virtual device mesh).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np

from .runner import BatchAligner, BatchStats


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed when multi-process; returns
    (process_index, process_count).  Safe to call single-process."""
    import jax

    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def host_stripe(num_items: int, process_index: int, process_count: int) -> np.ndarray:
    """Deterministic round-robin stripe of input indices for this host."""
    return np.arange(process_index, num_items, process_count)


@dataclass
class MultiHostResult:
    local_pairs: int
    global_pairs: int
    local_bp: int
    global_bp: int
    seconds: float
    stats: BatchStats


class MultiHostRunner:
    """Streams pair batches through the local devices of each host."""

    def __init__(self, aligner: BatchAligner | None = None, batch_size: int = 4096):
        self.aligner = aligner if aligner is not None else BatchAligner()
        self.batch_size = batch_size

    def run(self, pairs, out_path: str | None = None, with_cigars: bool = False,
            process_index: int | None = None, process_count: int | None = None
            ) -> MultiHostResult:
        import jax

        pi = jax.process_index() if process_index is None else process_index
        pc = jax.process_count() if process_count is None else process_count
        stripe = host_stripe(len(pairs), pi, pc)
        local = [pairs[i] for i in stripe]

        t0 = time.perf_counter()
        out = open(out_path, "w") if out_path else None
        stats = BatchStats()

        def _acc(cstats):
            stats.pairs += cstats.pairs
            stats.buckets += cstats.buckets
            stats.band_retries += cstats.band_retries
            stats.cells_computed += cstats.cells_computed
            stats.aligned_bp += cstats.aligned_bp
            stats.direct_traces += cstats.direct_traces
            stats.kernels += cstats.kernels

        try:
            if with_cigars:
                # Pipelined: batch k's traces + checkpoint transfers drain
                # while batch k+1 packs/dispatches (align_iter); output
                # lines stream per batch.
                chunks = (
                    local[lo : lo + self.batch_size]
                    for lo in range(0, len(local), self.batch_size)
                )
                for results, cstats in self.aligner.align_iter(chunks):
                    for cost, cigar in results:
                        if out:
                            out.write(f"{cost},{cigar.to_string()}\n")
                    _acc(cstats)
            else:
                for lo in range(0, len(local), self.batch_size):
                    chunk = local[lo : lo + self.batch_size]
                    costs, cstats = self.aligner.cost_with_stats(chunk)
                    if out:
                        for c in costs:
                            out.write(f"{c},\n")
                    _acc(cstats)
        finally:
            if out:
                out.close()
        dt = time.perf_counter() - t0

        global_pairs, global_bp = _merge_counts(stats.pairs, stats.aligned_bp)
        return MultiHostResult(
            local_pairs=stats.pairs,
            global_pairs=global_pairs,
            local_bp=stats.aligned_bp,
            global_bp=global_bp,
            seconds=dt,
            stats=stats,
        )


_LIMBS = 4  # 4 x 16-bit limbs cover counters up to 2^64


def _merge_counts(*vals: int) -> tuple[int, ...]:
    """Global sum of per-host counters: one all-reduce over a mesh spanning
    all global devices (rides DCN across hosts, ICI within).

    Exact for 64-bit counters: each value is split into 16-bit limbs summed
    in int32 (limb sums stay < 2^31 for up to 2^15 hosts), and only the
    first local device of each host contributes (the rest send zeros), so
    no division/rounding is involved anywhere.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices())
    mesh = Mesh(devs, axis_names=("hosts",))
    ld = jax.local_device_count()
    limbs = np.zeros((ld, len(vals), _LIMBS), np.int32)
    for c, v in enumerate(vals):
        v = int(v)
        assert 0 <= v < 1 << (16 * _LIMBS)
        for l in range(_LIMBS):
            limbs[0, c, l] = (v >> (16 * l)) & 0xFFFF
    sharding = NamedSharding(mesh, P("hosts"))
    if jax.process_count() == 1:
        # Single process owning every device: still one contribution per
        # "host" stripe of ld devices.
        full = np.zeros((len(devs), len(vals), _LIMBS), np.int32)
        full[::ld] = limbs[0]
        arr = jax.device_put(full, sharding)
    else:
        arr = jax.make_array_from_process_local_data(sharding, limbs)
    total = jax.jit(
        lambda x: jnp.sum(x, axis=0), out_shardings=NamedSharding(mesh, P())
    )(arr)
    total = np.asarray(total)
    return tuple(
        sum(int(total[c, l]) << (16 * l) for l in range(_LIMBS))
        for c in range(len(vals))
    )
