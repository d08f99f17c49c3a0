"""Batch/streaming alignment runtime: the performance product.

The reference is single-pair single-threaded; this framework's unit of
scale is a *batch* of independent pairs (SURVEY.md §2.6): pairs are bucketed
by padded shape, packed into device arrays, aligned with the banded batched
kernel (:mod:`astarpa_tpu.ops.banded`), and certified per pair; uncertified
pairs retry with a doubled band — the batch-level re-expression of the
reference's ``exponential_search`` (`astarpa2/src/band.rs:100-141`).

Multi-chip/multi-host: one ``batch`` mesh axis.  Inputs are sharded along
it with ``NamedSharding``; each pair's DP state stays on one device; the
only collectives are the result gather and ``psum``-style stat merges that
XLA inserts at readout.  No TP/PP analog exists — the unit of work is one
pair (SURVEY.md §2.6).

Kernel routing: one dispatch, :func:`astarpa_tpu.ops.kernels.banded_kernels`,
picks the kernel family for the backend, and every rung calls it:

===========  ==================================================================
backend      kernel (cost / cost + checkpoints, shared or per-pair schedule)
===========  ==================================================================
gpu          CUDA banded Myers (`ops/cuda_banded`, `native/cuda/`): labels
             ``cuda-cost``, ``cuda-ck``, ``cuda-cost-pp``, ``cuda-ck-pp``
cpu          jnp references (`ops/banded`): labels ``jnp-...``
other        error
===========  ==================================================================

Under a mesh every shard runs the same kernel via ``shard_map`` and the
label gains ``-sharded``.  Labels are recorded at dispatch, per rung, in
``BatchStats.kernels``.
"""

from __future__ import annotations

import functools
import os
import sys
import time as _time
from dataclasses import dataclass, field

import numpy as np

from ..types import Cigar
from ..ops.bitpack import W, n_words

INF = 1 << 30

#: ASTARPA_STREAM_PROF=1: per-phase stderr lines for the streaming
#: runners (pack / dispatch / certify-sync / stage / flush-wait) — the
#: align_iter sibling of ASTARPA_TRACE_PROF.  Diagnostic only.
_STREAM_PROF = os.environ.get("ASTARPA_STREAM_PROF", "") == "1"


def _sprof(msg: str) -> None:
    if _STREAM_PROF:
        print(f"[sprof {_time.perf_counter():.3f}] {msg}", file=sys.stderr,
              flush=True)

# Certified-cost ceiling for direct whole-pair DT traces — must not exceed
# the native burst budget (native.DIRECT_DT_MAX; trace_direct asserts).
_DIRECT_DT_MAX = 1 << 14


@dataclass
class BatchStats:
    pairs: int = 0
    buckets: int = 0
    band_retries: int = 0
    cells_computed: int = 0
    aligned_bp: int = 0
    # Pairs whose CIGAR came from the direct whole-pair DT trace (no
    # checkpoint kernel, no checkpoint readback).
    direct_traces: int = 0
    # Label of the kernel each device dispatch of this run used, in order
    # (see the module docstring).
    kernels: list = field(default_factory=list)


@dataclass
class BatchAligner:
    """Aligns many pairs data-parallel on the available devices.

    Args:
      band_words: initial band height in uint32 words (doubled on failure).
      lane_multiple: batch padding granularity (the kernels take any
        batch; a fixed multiple keeps a stream's compiled shapes stable).
      mesh: optional ``jax.sharding.Mesh`` with a ``batch`` axis; inputs are
        sharded over it.  None = single default device.
    """

    band_words: int = 8
    lane_multiple: int = 256
    mesh: object = None
    max_band_doublings: int = 8
    # Domain-restricted per-pair bands (the re-expression of the
    # reference's band doubling + A* domain, `astarpa2/src/band.rs:100-141`
    # + `domain.rs:117-235`): buckets of pairs >= domain_min_bp run an f
    # ladder where each pair's window follows its own domain hull:
    #   "gap"  — closed-form cost-f parallelogram (no host work; removes
    #            the bucket-skew and |m-n| certificate penalties),
    #   "gcsh" — fwd+rev GCSH heuristic domain sampled by the native
    #            runtime (much thinner bands at high divergence; costs
    #            ~1-3s of host CPU per 500kbp pair to build, parallel
    #            across pairs on multi-core hosts),
    #   "auto" — gcsh when the native runtime is available and the host
    #            has >= 8 cores to amortize builds; gap otherwise,
    #   "off"  — plain shared-bucket Ukkonen band ladder only.
    domain_mode: str = "auto"
    domain_min_bp: int = 32768
    domain_k: int = 12
    domain_r: int = 2
    max_f_rounds: int = 10
    # Checkpoint interval (columns) for the ck/trace path; None = see _cb.
    # The device->host checkpoint readback shrinks ~1/CB while the native
    # DT-burst trace is ~flat in CB (x-drop live-window bursts; see native
    # trace prof) until very long segments start paying pruned-burst
    # retries.
    ck_col_block: int | None = None
    # Direct whole-pair DT traces: when a rung's certification threshold
    # fits the native backward-burst budget (native.DIRECT_DT_MAX), the
    # rung runs the plain COST kernel and certified pairs are traced
    # host-side from the certified cost alone — zero checkpoint planes
    # read back.  Purely a dispatch choice; exactness is carried by the
    # same certificates either way.
    direct_dt: bool = True
    # Padded-geometry quantum for packing ("auto": none below 4kbp, 512 to
    # 32kbp, 2048 above).  A stream of same-shaped batches then reuses ONE
    # compiled kernel geometry instead of compiling one for every batch's
    # slightly different max-m (see ops.bitpack.pack_batch_staggered).
    shape_quantum: object = "auto"
    # Warm-start band hints: bucket-class -> the tightest band the last
    # bucket of that class NEEDED (band_for_cost of its certified costs).
    # In a stream of similar batches the ladder then
    # starts AT the certifying rung (no probe rung, no extra device sync);
    # distribution drift is caught by the normal certificate + rung
    # prediction.  Purely a starting point — never affects exactness.
    _band_hints: dict = field(default_factory=dict, repr=False)
    # Sticky diagonal aims per packed geometry (see _diag).
    _diag_hints: dict = field(default_factory=dict, repr=False)
    # Prefetched gcsh domain builds: (id(pairs), bucket) -> Future of the
    # handle list, submitted by the streaming runners while the previous
    # batch's kernel is in flight (builds are GIL-released ctypes calls,
    # so they overlap device waits even on one core).
    _domain_prefetch: dict = field(default_factory=dict, repr=False)
    _prefetch_ex: object = field(default=None, repr=False)

    @staticmethod
    def _bucket_class(bucket_pairs) -> int:
        n_top = max(len(a) for a, _ in bucket_pairs)
        ncls, size = 0, 64
        while size < n_top:
            size = int(size * 1.5) + 1
            ncls += 1
        return ncls

    @staticmethod
    def _note_need(need_max: int, costs, slots, n, m, B0: int, diag) -> int:
        """Running max of the TIGHT band the certified pairs actually
        needed (band_for_cost inverse) — what the warm-start hint records.
        Recording the rung band instead would ratchet: one outlier batch
        would inflate the start band for its whole class forever, since a
        too-high start always certifies and re-records itself."""
        if not slots:
            return need_max
        from ..ops import banded

        sel = np.asarray(slots)
        need = banded.band_for_cost(
            np.asarray(costs)[sel], np.asarray(n)[:B0][sel],
            np.asarray(m)[:B0][sel], *diag,
        )
        # Quantize to the ladder's rung grid (pow2 to 64, then multiples
        # of 64): a raw need drifts a few words between batches, and a
        # drifting start band would be a NEW kernel geometry (a recompile)
        # per batch.
        b = int(need.max()) + 1
        if b <= 64:
            p = 4
            while p < b:
                p *= 2
            b = p
        else:
            b = -(-b // 64) * 64
        return max(need_max, b)

    def _shape_quantum(self, bucket_pairs) -> int | None:
        if self.shape_quantum != "auto":
            return self.shape_quantum or None
        n_top = max(len(a) for a, _ in bucket_pairs)
        if n_top <= 4096:
            return None
        return 512 if n_top <= 32768 else 2048

    def _diag(self, n, m, B0: int, n_max: int, S: int) -> tuple:
        """STICKY quantized bucket diagonal for schedules + thresholds: aim
        the shared band at the pairs' real max (n, m) instead of the padded
        plane bottom — shape padding (shape_quantum) then costs zero band
        rows.  The aim is remembered per packed geometry and reused while
        the new batch's max-m sits within a small budget (~n/128) below it,
        because ``diag`` is a static jit arg: every distinct value costs a
        compile, so a stream of similar batches must converge on ONE
        value.  Soundness: band_threshold's dev term
        measures each pair against this same diagonal, so the <=budget
        overshoot is priced into the certificate."""
        n_arr = np.asarray(n)[:B0]
        m_arr = np.asarray(m)[:B0]
        n_top = max(1, int(n_arr.max()))
        m_top = int(m_arr.max())
        cand = -(-(m_top * n_max) // n_top)  # rescale slope to padded cols
        cand = min(-(-cand // 32) * 32, S * W)
        # The aim need not sit above every m — band_threshold's dev term
        # prices |aim - m| in BOTH directions — so reuse symmetrically.
        budget = max(64, n_top >> 7)
        key = (n_max, S)
        prev = self._diag_hints.get(key)
        if prev is not None and abs(cand - prev) <= budget:
            return (n_max, prev)
        self._diag_hints[key] = cand
        return (n_max, cand)

    def _cb(self, sw: int, n_max: int) -> int:
        if self.ck_col_block:
            base = self.ck_col_block
        else:
            # n_max/32 keeps the checkpoint count ~32 regardless of pair
            # length: the device->host readback shrinks 1/CB while the
            # native DT bursts stay flat in CB (x-drop live windows), and
            # the per-segment burst cost is bounded by the band — a
            # certified distance satisfies d <= ~16*sw, so the segment
            # distance d*CB/n <= sw/2 always fits the burst budget.
            # Measured at 500kbp e=15% x128: CB 4096 -> 16384 cut
            # cost+CIGAR from ~0.3 to 0.076 s/pair (readback-bound).
            base = max(4096, sw, n_max // 32)
        # The sw + 8 floor and the 512 rounding are kept as they were
        # tuned for earlier kernels (any CB >= 1 is valid for the ck
        # kernels); re-deriving them on the card is ROADMAP S4.
        cb = max(base, sw + 8)
        cb = -(-cb // 512) * 512
        return min(cb, max(n_max, 1))

    def cost(self, pairs) -> np.ndarray:
        costs, _ = self.cost_with_stats(pairs)
        return costs

    def cost_with_stats(self, pairs) -> tuple[np.ndarray, BatchStats]:
        """Exact edit distances for a list of byte pairs."""
        stats = BatchStats(pairs=len(pairs))
        out = np.full(len(pairs), -1, dtype=np.int64)

        # Trivial pairs never hit the device.
        todo: list[int] = []
        for idx, (a, b) in enumerate(pairs):
            if len(a) == 0 or len(b) == 0:
                out[idx] = len(a) + len(b)
            else:
                todo.append(idx)

        for bucket in _buckets(pairs, todo):
            stats.buckets += 1
            mode = self._resolve_domain_mode(pairs, bucket, want_cigars=False)
            if mode:
                self._domain_ladder(pairs, bucket, out, stats, mode=mode)
            else:
                self._run_bucket(pairs, bucket, out, stats)

        stats.aligned_bp = sum(len(a) for a, _ in pairs)
        assert (out >= 0).all()
        return out, stats

    # -- internals -----------------------------------------------------------

    def _run_bucket(self, pairs, idxs: list[int], out: np.ndarray, stats: BatchStats) -> None:
        rung = self._rung_start(pairs, self._new_ladder(pairs, idxs), stats)
        while rung is not None:
            rung = self._rung_finish(pairs, out, stats, rung)

    def _new_ladder(self, pairs, idxs: list[int]) -> dict:
        """Fresh band-ladder state for one bucket.  The warm-start hint
        REPLACES the configured start band (it is the measured tight need
        of the last same-class bucket, 64-word quantized with margin): a
        large configured band_words would otherwise put a permanent floor
        under the ladder and waste kernel cells forever.  A drifted batch
        that fails the hint rung retries via the normal certificate
        ladder."""
        cls = self._bucket_class([pairs[i] for i in idxs])
        return dict(
            cls=cls,
            band=self._band_hints.get(cls) or self.band_words,
            need_max=1,
            pending=list(idxs),
            attempt=0,
            # (args, B0, members): reused across rungs while the padded
            # batch wouldn't shrink much — repacking costs host time and
            # an upload per rung, extra already-certified lanes only
            # device time (the cheap resource; cf.
            # `astarpa2/src/domain.rs:452-455` reuse).
            packed=None,
        )

    def _rung_start(self, pairs, lad: dict, stats: BatchStats) -> dict:
        """Dispatch ONE band rung: repack if the pending set shrank, pick
        the window, launch the cost kernel ASYNCHRONOUSLY.  The device
        result is not synced here — `cost_iter` packs and dispatches the
        next batch while this rung is in flight; :meth:`_rung_finish`
        certifies."""
        from ..ops.bitpack import pack_batch_staggered

        if lad["packed"] is None or 2 * len(lad["pending"]) <= len(
            lad["packed"][2]
        ):
            bucket_pairs = [pairs[i] for i in lad["pending"]]
            args, B0 = pack_batch_staggered(
                bucket_pairs, self._pack_multiple(),
                shape_quantum=self._shape_quantum(bucket_pairs),
            )
            args = self._shard(args)
            lad["packed"] = (args, B0, list(lad["pending"]))
        args, B0, members = lad["packed"]
        a0, a1, pb0, pb1, n, m = args
        n_max, S = a0.shape[0], pb0.shape[0]
        diag = self._diag(n, m, B0, n_max, S)
        sw = min(lad["band"], S)
        # Skewed buckets (m_max > W * n_max) have no valid <=1-word/column
        # shift schedule; and the last ladder rung clamps to the always-
        # exact full-height window so the ladder converges for any input.
        if S > max(n_max, 1) or lad["attempt"] >= self.max_band_doublings:
            sw = S
        costs_dev = self._dispatch(stats, args, sw, diag)
        stats.cells_computed += n_max * sw * W * len(members)
        return dict(lad=lad, costs_dev=costs_dev, sw=sw, S=S, diag=diag)

    def _rung_finish(self, pairs, out, stats: BatchStats, rung: dict):
        """Sync + certify one in-flight rung; returns the next in-flight
        rung (retry at a wider band) or None when the bucket is done."""
        from ..ops import banded

        lad = rung["lad"]
        args, B0, members = lad["packed"]
        _a0, _a1, _pb0, _pb1, n, m = args
        sw, S, diag = rung["sw"], rung["S"], rung["diag"]
        costs = np.asarray(rung["costs_dev"])[:B0]
        if sw >= S:
            # Full-height window: always exact.
            ok = np.ones(B0, dtype=bool)
        else:
            thr = banded.band_threshold(
                sw, np.asarray(n)[:B0], np.asarray(m)[:B0], *diag
            )
            ok = costs <= thr
        pending_set = set(lad["pending"])
        nxt = []
        fail_slots = []
        ok_slots = []
        for slot, i in enumerate(members):
            if i not in pending_set:
                continue
            if ok[slot]:
                out[i] = int(costs[slot])
                ok_slots.append(slot)
            else:
                nxt.append(i)
                fail_slots.append(slot)
        lad["need_max"] = self._note_need(
            lad["need_max"], costs, ok_slots, n, m, B0, diag
        )
        lad["pending"] = nxt
        if not nxt:
            self._band_hints[lad["cls"]] = lad["need_max"]
            return None
        assert sw < S, "full-height window must certify every pair"
        stats.band_retries += 1
        lad["band"] = self._next_band(lad["band"], costs, fail_slots, n, m,
                                      B0, diag)
        lad["attempt"] += 1
        return self._rung_start(pairs, lad, stats)

    def cost_iter(self, batches):
        """Pipelined streaming costs: yields one ``(costs, stats)`` per
        input batch, in order.  Batch k+1's host pack + first-rung
        dispatch run while batch k's kernel is still in flight on the
        device (jax dispatch is async; the sync happens at
        certification), so in steady state per-batch wall-clock ~= the
        kernel time and the pack rides the device gap — the cost-path
        sibling of :meth:`align_iter` (BASELINE config #5's streaming
        shape).  Domain-mode buckets and band retries are handled
        synchronously at finish time (rare in a hint-warmed stream)."""
        pending = None
        for pairs in batches:
            cur = self._cost_dispatch(pairs)
            if pending is not None:
                yield self._cost_finish(*pending)
            pending = cur
        if pending is not None:
            yield self._cost_finish(*pending)

    def _cost_dispatch(self, pairs):
        stats = BatchStats(pairs=len(pairs))
        out = np.full(len(pairs), -1, dtype=np.int64)
        todo: list[int] = []
        for idx, (a, b) in enumerate(pairs):
            if len(a) == 0 or len(b) == 0:
                out[idx] = len(a) + len(b)
            else:
                todo.append(idx)
        jobs = []
        for bucket in _buckets(pairs, todo):
            stats.buckets += 1
            mode = self._resolve_domain_mode(pairs, bucket, want_cigars=False)
            if mode:
                if mode == "gcsh":
                    # Builds start NOW on the background thread; the
                    # ladder (run at finish time) pops them — they overlap
                    # the next batch's in-flight kernel.
                    self._prefetch_domains(pairs, want_cigars=False)
                jobs.append((mode, bucket, None))
            else:
                rung = self._rung_start(
                    pairs, self._new_ladder(pairs, bucket), stats
                )
                jobs.append((None, bucket, rung))
        return pairs, stats, out, jobs

    def _cost_finish(self, pairs, stats, out, jobs):
        for mode, bucket, rung in jobs:
            if mode:
                self._domain_ladder(pairs, bucket, out, stats, mode=mode)
            else:
                while rung is not None:
                    rung = self._rung_finish(pairs, out, stats, rung)
        stats.aligned_bp = sum(len(a) for a, _ in pairs)
        assert (out >= 0).all()
        return out, stats

    def _next_band(self, band, costs, fail_slots, n, m, B0, diag) -> int:
        """Jump the ladder to the band the failed pairs' banded upper bounds
        certify at (see :func:`ops.banded.band_for_cost`), falling back to
        doubling when a result is the INF sentinel.  A +1 word pad absorbs
        the skew-term drift a repack of the surviving pairs can introduce;
        the certificate re-check keeps correctness either way."""
        from ..ops import banded

        sel = np.asarray(fail_slots)
        c = np.asarray(costs)[sel]
        finite = c < INF // 2
        # Lanes whose band never reached their target row return the INF
        # sentinel — no bound for them, so keep at least the doubling floor.
        floor = band * 2 if not finite.all() else band + 1
        if not finite.any():
            return floor
        sel = sel[finite]
        need = banded.band_for_cost(
            c[finite], np.asarray(n)[:B0][sel], np.asarray(m)[:B0][sel],
            *diag,
        )
        return max(floor, int(need.max()) + 1)

    def _pack_multiple(self) -> int:
        """Batch padding granularity: the configured lane multiple, raised
        under a mesh so every shard gets an equal slice."""
        import math

        lm = self.lane_multiple
        if self.mesh is not None:
            ndev = self.mesh.devices.size
            lm = lm * ndev // math.gcd(lm, ndev)
        return lm

    def _resolve_domain_mode(self, pairs, idxs, want_cigars: bool) -> str | None:
        """Returns "gap"/"gcsh" when the bucket should use the per-pair
        domain ladder, else None (plain shared ladder).

        "auto" policy: per-pair schedules pay a host build (gcsh) or skew
        bookkeeping, so they must SAVE band cells to win; how the two
        kernel forms compare per cell on the GPU is not measured yet.
        gcsh saves via hull thinning (2-5x at e>=10%) — worth the host
        build only on >=8-core hosts.  gap saves only the bucket skew
        terms (per-pair |m-n| + diagonal spread), so a UNIFORM bucket
        gains nothing: auto demotes gap to the plain shared ladder unless
        the skew terms rival the expected band."""
        if self.domain_mode == "off":
            return None
        big = max(len(pairs[i][0]) for i in idxs) >= self.domain_min_bp
        if not big and self.domain_mode == "auto":
            return None
        mode = self.domain_mode
        if mode == "auto":
            import os

            from .. import native

            mode = (
                "gcsh"
                if native.available() and (os.cpu_count() or 1) >= 8
                else "gap"
            )
            if mode == "gap":
                # Bucket skew terms (what per-pair gap bands save) vs a
                # ~6% divergence prior (what any band must cover anyway).
                ns = np.array([len(pairs[i][0]) for i in idxs], np.int64)
                ms = np.array([len(pairs[i][1]) for i in idxs], np.int64)
                n_max = max(int(ns.max()), 1)
                m_max = int(ms.max())
                g = np.abs(ms - ns)
                dev = np.abs(m_max * ns // n_max - ms)
                skew = int((g + 2 * dev).max())
                if skew < (n_max // 16) * 3 // 2:
                    return None
        if mode == "gcsh":
            from .. import native

            if not native.available():
                mode = "gap"
        if want_cigars:
            from .. import native

            # Domain CIGARs are traced by the native runtime.
            if not native.available():
                return None
        return mode

    def _build_gcsh_handles(self, bucket_pairs):
        """Native fwd+rev GCSH domain builds for one bucket (GIL-released
        ctypes; parallel across pairs on multi-core hosts)."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        from .. import native

        workers = min(len(bucket_pairs), os.cpu_count() or 1)
        if workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                return list(
                    ex.map(
                        lambda ab: native.DomainHandle(
                            ab[0], ab[1], k=self.domain_k, r=self.domain_r
                        ),
                        bucket_pairs,
                    )
                )
        return [
            native.DomainHandle(a, b, k=self.domain_k, r=self.domain_r)
            for a, b in bucket_pairs
        ]

    def _prefetch_domains(self, pairs, want_cigars: bool) -> None:
        """Submit gcsh domain builds for ``pairs``' buckets on a background
        thread.  Called by the streaming runners for the batch AFTER the
        one being dispatched: the builds then run during the current
        batch's device waits (both sides release the GIL), so on steady
        state the dominant gcsh host cost rides the kernel gap instead of
        serializing with it.  No-op for buckets that don't resolve to
        gcsh; _domain_ladder pops the matching future."""
        todo = [i for i, (a, b) in enumerate(pairs) if len(a) and len(b)]
        for bucket in _buckets(pairs, todo):
            if self._resolve_domain_mode(pairs, bucket, want_cigars) != "gcsh":
                continue
            key = (id(pairs), tuple(bucket))
            if key in self._domain_prefetch:
                continue
            if self._prefetch_ex is None:
                from concurrent.futures import ThreadPoolExecutor

                self._prefetch_ex = ThreadPoolExecutor(1)
            bucket_pairs = [pairs[i] for i in bucket]
            self._domain_prefetch[key] = self._prefetch_ex.submit(
                self._build_gcsh_handles, bucket_pairs
            )

    def _domain_ladder(self, pairs, idxs, out, stats, results=None,
                       mode: str = "gcsh",
                       trace_jobs: list | None = None) -> None:
        """f ladder over heuristic-restricted per-pair bands (the batched
        re-expression of `astarpa2`'s band doubling + A* domain): sample
        each pair's fwd+rev GCSH domain at its own f, run ONE device pass
        for the bucket with per-pair window schedules, accept pairs whose
        banded result is <= their f (the standard doubling certificate),
        and feed the rejected pairs' banded upper bounds back as the next
        f — so f converges to just above the true distance instead of
        overshooting by the doubling factor.
        """
        from .. import native
        from ..domain import domain_schedule
        from ..ops import banded
        from ..ops.bitpack import pack_batch_staggered

        bucket_pairs = [pairs[i] for i in idxs]
        args, B0 = pack_batch_staggered(
            bucket_pairs, self._pack_multiple(),
            shape_quantum=self._shape_quantum(bucket_pairs),
        )
        args = self._shard(args)
        a0, a1, pb0, pb1, n, m = args
        n_max, S = a0.shape[0], pb0.shape[0]
        B = a0.shape[1]
        step = 64 if n_max <= 200_000 else 128
        if mode == "gcsh":
            # GIL-released ctypes builds: parallel across pairs on real
            # hosts (this is the dominant host cost of the gcsh ladder).
            # A streaming runner may have PREFETCHED this bucket's handles
            # while the previous batch's kernel was in flight (see
            # _prefetch_domains) — the build then costs ~nothing of the
            # steady-state period even on one core.
            fut = self._domain_prefetch.pop((id(pairs), tuple(idxs)), None)
            if fut is not None:
                handles = fut.result()
            else:
                handles = self._build_gcsh_handles(bucket_pairs)
        else:
            handles = [_GapDomainProvider(a, b) for a, b in bucket_pairs]
        flush_here = trace_jobs is None
        if flush_here:
            trace_jobs = []
        try:
            # First-round f: h0 plus a ~25% margin for gcsh (unpruned GCSH
            # underestimates d by ~10-20% at high divergence, so f=h0 almost
            # always fails and pays a second round; the hull at 1.25*h0 is
            # roughly as wide as the exact-f hull, so one padded round beats
            # thin-fail + exact-retry).  Gap domains already carry their own
            # divergence allowance in h0.
            pad = (lambda h0: h0 + h0 // 4) if mode == "gcsh" else (lambda h0: h0)
            f = np.array([max(pad(h.h0), 2 * W) for h in handles], np.int64)
            pending = list(range(B0))
            for _ in range(self.max_f_rounds):
                scheds = {}
                sw_need = 1
                for slot in pending:
                    ps = None
                    while ps is None:
                        dom = handles[slot].sample(int(f[slot]), step)
                        ps = domain_schedule(dom)
                        if ps is None:
                            # Empty domain: certainly dist > f.
                            f[slot] += max(f[slot] // 4, 64)
                    scheds[slot] = ps
                    sw_need = max(sw_need, ps.band_words)
                # Quantize the band so the jit cache sees few distinct
                # kernels (pow2 up to 64, then multiples of 64).
                sw = sw_need
                if sw <= 64:
                    p = 4
                    while p < sw:
                        p *= 2
                    sw = p
                else:
                    sw = -(-sw // 64) * 64
                sw = min(sw, S)
                ck_mode = results is not None
                # Direct round: every pair this round certifies at cost
                # <= f[slot] <= the burst budget, so CIGARs come from
                # direct whole-pair DT traces (per-pair schedules only
                # matter for the trace's recompute fallback) and the
                # round runs the per-pair COST kernel — no checkpoint
                # planes.
                direct_rnd = (
                    ck_mode
                    and self.direct_dt
                    and int(max(f[slot] for slot in pending)) <= _DIRECT_DT_MAX
                )
                if sw >= S:
                    break  # band no longer thin; plain ladder is better
                sched_arr = np.zeros((n_max, B), np.uint8)
                for slot in pending:
                    sc = scheds[slot].sched
                    sched_arr[: len(sc), slot] = sc
                # Idle lanes (padding + already-certified pairs) keep an
                # all-zero schedule; their results are ignored.
                CB = self._cb(sw, n_max) if ck_mode and not direct_rnd else None
                try:
                    got = self._dispatch(stats, args, sw, schedule=sched_arr,
                                         CB=CB)
                except ValueError:
                    # No kernel serves this band (past the CUDA kernel's
                    # band limit): the domain saving is gone, finish on the
                    # always-converging shared-band ladder below.
                    break
                if results is None or direct_rnd:
                    costs = np.asarray(got)[:B0]
                else:
                    costs_dev, ckvp, ckvm, cktv = got
                    costs = np.asarray(costs_dev)[:B0]
                stats.cells_computed += n_max * sw * W * len(pending)
                done = [
                    slot for slot in pending
                    if costs[slot] <= f[slot] and costs[slot] < INF // 2
                ]
                if done and results is not None and direct_rnd:
                    stats.direct_traces += len(done)
                    for slot in done:
                        sc = np.ascontiguousarray(scheds[slot].sched, np.int32)
                        trace_jobs.append(_TraceJob(
                            pair=idxs[slot], slices=None, pos=0, shift=sc,
                            s_words=S, sw=sw, cb=0, want=int(costs[slot]),
                        ))
                elif done and results is not None:
                    sel = np.asarray(done)
                    # Device-side gather of the certified pairs' checkpoints;
                    # the staged async copies stream while later f-rounds and
                    # buckets dispatch, and drain behind the thread-pooled
                    # traces at flush time.
                    chunks = _stage_ck_chunks(
                        ckvp[:, :, sel], ckvm[:, :, sel], cktv[:, sel],
                        len(done),
                    )
                    for pos, slot in enumerate(done):
                        i = idxs[slot]
                        sc = np.ascontiguousarray(scheds[slot].sched, np.int32)
                        c0, sl = _chunk_of(chunks, pos)
                        trace_jobs.append(_TraceJob(
                            pair=i, slices=sl, pos=pos - c0, shift=sc,
                            s_words=S, sw=sw, cb=CB, want=int(costs[slot]),
                        ))
                for slot in done:
                    out[idxs[slot]] = int(costs[slot])
                pending = [s for s in pending if s not in set(done)]
                if not pending:
                    return
                stats.band_retries += 1
                for slot in pending:
                    ub = int(costs[slot])
                    nxt = max(int(f[slot] * 5 // 4) + 1, f[slot] + 64)
                    if ub < INF // 2:
                        nxt = max(nxt, ub)
                    f[slot] = nxt
            # Ladder exhausted / band grew past usefulness: finish the
            # stragglers on the always-converging plain path.
            rest = [idxs[s] for s in pending]
            if results is None:
                self._run_bucket(pairs, rest, out, stats)
            else:
                self._align_bucket_ck(
                    pairs, rest, results, stats, trace_jobs=trace_jobs
                )
                self._flush_traces(trace_jobs, pairs, results)
                for i in rest:
                    out[i] = results[i][0]
        finally:
            if flush_here:
                self._flush_traces(trace_jobs, pairs, results)
            for h in handles:
                h.close()

    def _dispatch(self, stats: BatchStats, args, sw: int, diag=None,
                  schedule=None, CB: int | None = None):
        """Run the backend's banded kernel (:mod:`astarpa_tpu.ops.kernels`)
        on one packed bucket: cost, or cost + checkpoints every ``CB``
        columns; shared schedule (``diag``) or per-pair ``schedule``.
        Single device, or ``shard_map`` over the mesh's batch axis so every
        shard runs the same kernel on its slice of the pairs.  Records the
        kernel label in ``stats.kernels`` and ``LAST_KERNEL``."""
        from ..ops.kernels import banded_kernels

        global LAST_KERNEL
        kern = banded_kernels()
        per_pair = schedule is not None
        label = kern.name + ("-ck" if CB else "-cost") + ("-pp" if per_pair else "")
        if self.mesh is None:
            out = _run_kernel(kern, sw, CB, diag, *args, schedule)
        else:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            label += "-sharded"
            fn = _sharded(self.mesh, kern, sw, CB, diag, per_pair)
            if per_pair:
                schedule = jax.device_put(
                    np.ascontiguousarray(schedule),
                    NamedSharding(self.mesh, P(None, "batch")),
                )
                out = fn(*args, schedule)
            else:
                out = fn(*args)
        LAST_KERNEL = label
        stats.kernels.append(label)
        return out

    def _shard(self, args):
        if self.mesh is None:
            return args
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard_cols = NamedSharding(self.mesh, P(None, "batch"))
        shard_vec = NamedSharding(self.mesh, P("batch"))
        # _pack_multiple makes the batch a multiple of the mesh size.
        a0, a1, pb0, pb1, n, m = args
        return (
            jax.device_put(a0, shard_cols),
            jax.device_put(a1, shard_cols),
            jax.device_put(pb0, shard_cols),
            jax.device_put(pb1, shard_cols),
            jax.device_put(np.asarray(n), shard_vec),
            jax.device_put(np.asarray(m), shard_vec),
        )

    # -- CIGAR path ------------------------------------------------------------

    def align(self, pairs) -> list[tuple[int, Cigar]]:
        return self.align_with_stats(pairs)[0]

    def align_with_stats(self, pairs) -> tuple[list[tuple[int, Cigar]], BatchStats]:
        """Costs + CIGARs in ONE device pass per band-doubling rung: the
        checkpointing kernel runs *inside* the ladder, so certified pairs
        are traced immediately from their certifying rung's checkpoints
        (native DT-burst traceback, `native/astarpa_native.cpp::
        trace_banded_ck`).  Without a native toolchain (allowed on the CPU
        backend only, see :func:`native.available`), costs come from the
        ladder and CIGARs from the host block aligner.
        """
        from .. import native

        if native.available():
            return self._align_combined(pairs)
        costs, stats = self.cost_with_stats(pairs)
        return self._align_host_fallback(pairs, costs), stats

    def _align_combined(self, pairs) -> tuple[list[tuple[int, Cigar]], BatchStats]:
        """Band-doubling ladder over the checkpointing kernel; each rung
        both certifies costs and yields the checkpoints its certified pairs
        are traced from (no second DP pass)."""
        results, stats, trace_jobs = self._align_dispatch(pairs)
        self._flush_traces(trace_jobs, pairs, results)
        return results, stats

    def _align_dispatch(self, pairs):
        """Device half of :meth:`_align_combined`: runs the full ladder and
        stages every certified pair's checkpoint readback (async copies in
        flight), but does NOT drain the traces.  Returns
        ``(results, stats, trace_jobs)``; the caller owns the flush."""
        return self._align_dispatch_finish(self._align_dispatch_start(pairs))

    def _align_dispatch_start(self, pairs):
        """Pack + dispatch the FIRST rung of every non-domain bucket
        asynchronously (cost-vector copies in flight, nothing synced);
        domain-mode buckets defer whole to finish time with their gcsh
        builds prefetched.  ``align_iter`` starts the next batch here
        while the previous batch's rungs are still in flight — the
        align-path sibling of :meth:`_cost_dispatch`."""
        stats = BatchStats(pairs=len(pairs))
        results: list = [None] * len(pairs)
        todo: list[int] = []
        for idx, (a, b) in enumerate(pairs):
            if len(a) == 0 or len(b) == 0:
                results[idx] = (len(a) + len(b), _trivial_cigar(a, b))
            else:
                todo.append(idx)
        # One deferred trace list across ALL buckets: bucket k's traces and
        # chunk transfers drain behind bucket k+1's pack/dispatch instead of
        # blocking it.
        trace_jobs: list = []
        jobs = []
        try:
            for bucket in _buckets(pairs, todo):
                stats.buckets += 1
                mode = self._resolve_domain_mode(pairs, bucket,
                                                 want_cigars=True)
                if mode:
                    if mode == "gcsh":
                        # Builds start NOW on the background thread; the
                        # ladder (run at finish time) pops them.
                        self._prefetch_domains(pairs, want_cigars=True)
                    jobs.append((mode, bucket, None, None))
                else:
                    lad = self._new_align_ladder(pairs, bucket)
                    rung = self._align_rung_start(pairs, lad, stats,
                                                  trace_jobs, results)
                    jobs.append((None, bucket, lad, rung))
        except BaseException:
            self._flush_traces(trace_jobs, pairs, results)
            raise
        return pairs, results, stats, trace_jobs, jobs

    def _align_dispatch_finish(self, state):
        """Certify + stage every in-flight rung from
        :meth:`_align_dispatch_start` (running any retry rungs and
        domain-mode ladders synchronously) and return
        ``(results, stats, trace_jobs)``; the caller owns the flush."""
        pairs, results, stats, trace_jobs, jobs = state
        outc = np.full(len(pairs), -1, dtype=np.int64)
        try:
            for mode, bucket, lad, rung in jobs:
                if mode:
                    self._domain_ladder(
                        pairs, bucket, outc, stats, results=results,
                        mode=mode, trace_jobs=trace_jobs,
                    )
                else:
                    while rung is not None:
                        rung = self._align_rung_finish(
                            pairs, results, stats, lad, rung, trace_jobs
                        )
        except BaseException:
            # Leave no staged-but-undrained jobs behind on the error path.
            self._flush_traces(trace_jobs, pairs, results)
            raise
        stats.aligned_bp = sum(len(a) for a, _ in pairs)
        return results, stats, trace_jobs

    def align_iter(self, batches):
        """Pipelined streaming alignment: yields one ``(results, stats)``
        per input batch, in order.  Batch k's host traces and checkpoint
        transfers drain on a side thread WHILE batch k+1 packs and runs its
        device ladder (the native ctypes calls and the device->host
        transfer waits both release the GIL) — in steady state the link and
        the host trace pool stay busy through the device dispatch gaps,
        which single ``align()`` calls spend idle.

        The production serving shape (SURVEY.md §2.6 streaming runner):
        ``for results, stats in aligner.align_iter(batch_source): ...``.
        Without a native toolchain, runs ``align_with_stats`` per batch.
        """
        from concurrent.futures import ThreadPoolExecutor

        from .. import native

        if not native.available():
            for pairs in batches:
                yield self.align_with_stats(pairs)
            return

        # Three-stage software pipeline: dispatch_start(k+1) runs BEFORE
        # finish(k) syncs — batch k's kernel + cost-vector transfer ride
        # the link while batch k+1 packs (the align-path analog of
        # cost_iter's split-rung ladder) — and flush(k) traces on a side
        # thread under dispatch_start(k+2)/finish(k+1).  Yields trail the
        # input by up to two batches.
        started = None    # (pairs, state) dispatched, not certified
        flushing = None   # (results, stats, fut)
        it = iter(batches)
        sentinel = object()
        with ThreadPoolExecutor(1) as ex:
            nxt = next(it, sentinel)
            while nxt is not sentinel:
                t0 = _time.perf_counter()
                cur = (nxt, self._align_dispatch_start(nxt))
                _sprof(f"align_start {_time.perf_counter()-t0:.3f}s")
                nxt = next(it, sentinel)
                if started is not None:
                    p_pairs, p_state = started
                    t0 = _time.perf_counter()
                    results, stats, trace_jobs = self._align_dispatch_finish(
                        p_state
                    )
                    _sprof(f"align_finish {_time.perf_counter()-t0:.3f}s")
                    if flushing is not None:
                        t0 = _time.perf_counter()
                        flushing[2].result()
                        _sprof(f"flush-wait {_time.perf_counter()-t0:.3f}s")
                        yield flushing[0], flushing[1]
                    flushing = (results, stats, ex.submit(
                        self._flush_traces, trace_jobs, p_pairs, results
                    ))
                started = cur
            if started is not None:
                p_pairs, p_state = started
                results, stats, trace_jobs = self._align_dispatch_finish(
                    p_state
                )
                if flushing is not None:
                    flushing[2].result()
                    yield flushing[0], flushing[1]
                self._flush_traces(trace_jobs, p_pairs, results)
                yield results, stats

    def _align_bucket_ck(self, pairs, idxs, results, stats,
                         trace_jobs: list | None = None) -> None:
        # Caller-owned job list = traces drain after ALL buckets dispatch;
        # local list = drain on return (standalone use).
        flush_here = trace_jobs is None
        if flush_here:
            trace_jobs = []
        try:
            lad = self._new_align_ladder(pairs, idxs)
            rung = self._align_rung_start(pairs, lad, stats, trace_jobs,
                                          results)
            while rung is not None:
                rung = self._align_rung_finish(pairs, results, stats, lad,
                                               rung, trace_jobs)
        finally:
            if flush_here:
                self._flush_traces(trace_jobs, pairs, results)

    def _new_align_ladder(self, pairs, idxs: list[int]) -> dict:
        """Fresh band-ladder state for one CIGAR bucket — the align-path
        sibling of :meth:`_new_ladder` (hint replaces the configured start
        band; ``packed`` is reused across rungs)."""
        cls = self._bucket_class([pairs[i] for i in idxs])
        return dict(
            cls=cls,
            band=self._band_hints.get(cls) or self.band_words,
            need_max=1,
            pending=list(idxs),
            attempt=0,
            packed=None,
        )

    def _align_rung_start(self, pairs, lad: dict, stats: BatchStats,
                          trace_jobs: list, results) -> dict | None:
        """Pack (if the pending set shrank) + dispatch ONE align rung
        ASYNCHRONOUSLY: the cost vector's device->host copy (and, on the
        ck path, the optimistic checkpoint chunk copies) are issued here,
        but nothing syncs — ``align_iter`` packs and dispatches the next
        batch while this rung is in flight; :meth:`_align_rung_finish`
        certifies and stages the traces."""
        from ..ops import banded
        from ..ops.bitpack import pack_batch_staggered

        if lad["packed"] is None or 2 * len(lad["pending"]) <= len(
            lad["packed"][2]
        ):
            t0 = _time.perf_counter()
            bucket_pairs = [pairs[i] for i in lad["pending"]]
            args, B0 = pack_batch_staggered(
                bucket_pairs, self._pack_multiple(),
                shape_quantum=self._shape_quantum(bucket_pairs),
            )
            args = self._shard(args)
            lad["packed"] = (args, B0, list(lad["pending"]))
            _sprof(f"pack B0={B0} {_time.perf_counter()-t0:.3f}s")
        args, B0, members = lad["packed"]
        a0, a1, pb0, pb1, n, m = args
        n_max, S = a0.shape[0], pb0.shape[0]
        diag = self._diag(n, m, B0, n_max, S)
        sw = min(lad["band"], S)
        if S > max(n_max, 1) or lad["attempt"] >= self.max_band_doublings:
            sw = S
        thr = None
        if sw < S:
            thr = banded.band_threshold(
                sw, np.asarray(n)[:B0], np.asarray(m)[:B0], *diag
            )
        # Direct-DT rung: every pair certifying at this rung has cost <=
        # thr <= the native backward-burst budget, so the host trace
        # recovers its whole path from the certified cost alone (one DT
        # burst landing on the exact column-0 values).  The rung then
        # runs the plain COST kernel and zero checkpoint bytes cross the
        # device->host link.  Full-height rungs (thr None) are exact, so
        # n+m bounds their certified costs.
        if thr is not None:
            direct_cap = int(thr.max())
        else:
            direct_cap = int(
                np.asarray(n)[:B0].max() + np.asarray(m)[:B0].max()
            )
        direct = self.direct_dt and direct_cap <= _DIRECT_DT_MAX
        t0 = _time.perf_counter()
        opt_chunks = None
        ckvp = ckvm = cktv = None
        if direct:
            got = self._dispatch(stats, args, sw, diag)
            CB = 0
            # Start the cost vector's copy NOW: the certify sync then
            # costs ~nothing once the next batch's pack has hidden the
            # kernel+link latency.
            copy = getattr(got, "copy_to_host_async", None)
            if copy is not None:
                copy()
        else:
            # DT bursts make long checkpoint intervals cheap, and the
            # device->host readback shrinks with 1/CB.
            CB = self._cb(sw, n_max)
            got, ckvp, ckvm, cktv = self._dispatch(stats, args, sw, diag,
                                                   CB=CB)
            # Optimistic readback: start streaming every member lane's
            # checkpoints BEFORE the certification sync — the transfers
            # hide the cost-readback latency, and the common case (a
            # predicted rung certifies everything) needs them all.  A
            # failed rung wastes at most _OPT_READBACK_BYTES of link.
            lanes = len(members)
            per_lane = 4 * (
                int(ckvp.size) + int(ckvm.size) + int(cktv.size)
            ) // max(1, int(ckvp.shape[2]))
            if per_lane * lanes <= _OPT_READBACK_BYTES:
                # Queue the (tiny) cost vector's copy FIRST so
                # certification isn't stuck behind megabytes of
                # checkpoint bytes on the link.
                copy = getattr(got, "copy_to_host_async", None)
                if copy is not None:
                    copy()
                opt_chunks = _stage_ck_chunks(ckvp, ckvm, cktv, lanes)
        stats.cells_computed += n_max * sw * W * len(members)
        _sprof(f"dispatch sw={sw} direct={direct} "
               f"{_time.perf_counter()-t0:.3f}s")
        return dict(
            got=got, ckvp=ckvp, ckvm=ckvm, cktv=cktv, opt_chunks=opt_chunks,
            direct=direct, sw=sw, S=S, thr=thr, diag=diag, CB=CB,
            n_max=n_max,
        )

    def _align_rung_finish(self, pairs, results, stats: BatchStats,
                           lad: dict, rung: dict,
                           trace_jobs: list) -> dict | None:
        """Sync + certify one in-flight align rung, stage its certified
        pairs' trace jobs, and return the next in-flight rung (retry at a
        wider band) or ``None`` when the bucket is done."""
        from ..ops import banded

        args, B0, members = lad["packed"]
        _a0, _a1, _pb0, _pb1, n, m = args
        sw, S, thr, diag, CB = (rung["sw"], rung["S"], rung["thr"],
                                rung["diag"], rung["CB"])
        direct, opt_chunks, n_max = (rung["direct"], rung["opt_chunks"],
                                     rung["n_max"])
        t0 = _time.perf_counter()
        costs = np.asarray(rung["got"])[:B0]
        _sprof(f"certify-sync {_time.perf_counter()-t0:.3f}s")
        t0 = _time.perf_counter()
        if sw >= S:
            ok = np.ones(B0, dtype=bool)
        else:
            ok = costs <= thr
        pending_set = set(lad["pending"])
        sel = [slot for slot, i in enumerate(members)
               if i in pending_set and ok[slot]]
        fail_slots = [slot for slot, i in enumerate(members)
                      if i in pending_set and not ok[slot]]
        next_pending = [members[slot] for slot in fail_slots]
        if sel and direct:
            shift = banded.shift_at_array(n_max, S, sw, diag)
            stats.direct_traces += len(sel)
            for slot in sel:
                trace_jobs.append(_TraceJob(
                    pair=members[slot], slices=None, pos=0,
                    shift=shift, s_words=S, sw=sw, cb=0,
                    want=int(costs[slot]),
                ))
        elif sel:
            # Defer the traces until the whole ladder has dispatched; the
            # staged chunk copies stream behind the thread-pooled traces
            # at flush time.  When the optimistic copies were not issued
            # (big buffers), gather only certified lanes.
            shift = banded.shift_at_array(n_max, S, sw, diag)
            if opt_chunks is None:
                sel_arr = np.asarray(sel)
                chunks = _stage_ck_chunks(
                    rung["ckvp"][:, :, sel_arr], rung["ckvm"][:, :, sel_arr],
                    rung["cktv"][:, sel_arr], len(sel),
                )
            else:
                chunks = opt_chunks
            for pos, slot in enumerate(sel):
                p = slot if opt_chunks is not None else pos
                c0, sl = _chunk_of(chunks, p)
                trace_jobs.append(_TraceJob(
                    pair=members[slot], slices=sl, pos=p - c0,
                    shift=shift, s_words=S, sw=sw, cb=CB,
                    want=int(costs[slot]),
                ))
        _sprof(f"stage jobs={len(sel)} {_time.perf_counter()-t0:.3f}s")
        lad["need_max"] = self._note_need(lad["need_max"], costs, sel, n, m,
                                          B0, diag)
        lad["pending"] = next_pending
        if not next_pending:
            self._band_hints[lad["cls"]] = lad["need_max"]
            return None
        assert sw < S, "full-height window must certify every pair"
        stats.band_retries += 1
        lad["band"] = self._next_band(lad["band"], costs, fail_slots, n, m,
                                      B0, diag)
        lad["attempt"] += 1
        return self._align_rung_start(pairs, lad, stats, trace_jobs, results)

    def _flush_traces(self, trace_jobs: list, pairs, results) -> None:
        """Drain deferred checkpoint traces.  Every job's chunk already has
        its device->host copy in flight (issued at job creation by
        :func:`_stage_ck_chunks`), so the blocking ``np.asarray`` here
        completes in arrival order while a thread pool traces the chunks
        that already arrived (both the native calls and the transfer wait
        release the GIL).  Clears ``trace_jobs``."""
        if not trace_jobs:
            return
        import os
        from concurrent.futures import ThreadPoolExecutor

        from .. import native

        def run(job: "_TraceJob", vp, vm, tv):
            a, b = pairs[job.pair]
            # known_cost: the device ladder already certified this pair's
            # exact distance, so the trace skips its O(CB*SW) final-stripe
            # recompute of the target value; the per-segment landing checks
            # against the checkpoint planes still verify the path.
            cost, cigar = native.trace_banded_ck(
                a, b, job.s_words, vp[:, :, job.pos], vm[:, :, job.pos],
                tv[:, job.pos], job.shift, job.sw, job.cb,
                known_cost=job.want,
            )
            # cost == want by construction under known_cost; exactness is
            # carried by the per-segment landing checks against the
            # checkpoint planes (a wrong cost fails them -> the wrapper
            # asserts on the negative return) and by cigar.verify in tests.
            return job.pair, cost, cigar

        def run_direct(jobs: list):
            # Whole-pair DT traces from the certified costs: pure host
            # work, ONE multi-threaded native call for the whole rung
            # group (the jobs share a rung schedule by construction).
            res = native.trace_direct_batch(
                [pairs[j.pair] for j in jobs], jobs[0].s_words,
                jobs[0].shift, jobs[0].sw, [j.want for j in jobs],
            )
            return [(j.pair, c, cig) for j, (c, cig) in zip(jobs, res)]

        groups: dict[int, list] = {}
        order: list[int] = []
        for job in trace_jobs:
            # Direct jobs group per rung (shared schedule); checkpoint
            # jobs per staged chunk.
            key = id(job.shift) if job.slices is None else id(job.slices)
            if key not in groups:
                order.append(key)
            groups.setdefault(key, []).append(job)
        workers = max(1, min(len(trace_jobs), os.cpu_count() or 1))
        futures = []
        direct_futs = []
        with ThreadPoolExecutor(workers) as ex:
            for key in order:
                jobs = groups[key]
                if jobs[0].slices is None:
                    direct_futs.append(ex.submit(run_direct, jobs))
                    continue
                vp_d, vm_d, tv_d = jobs[0].slices
                vp = np.asarray(vp_d)
                vm = np.asarray(vm_d)
                tv = np.asarray(tv_d)
                for job in jobs:
                    futures.append(ex.submit(run, job, vp, vm, tv))
            for f in direct_futs:
                for i, cost, cigar in f.result():
                    results[i] = (cost, cigar)
            for f in futures:
                i, cost, cigar = f.result()
                results[i] = (cost, cigar)
        trace_jobs.clear()

    def _align_host_fallback(self, pairs, costs) -> list[tuple[int, Cigar]]:
        from ..aligners.astarpa2 import AstarPa2Params

        aligner = AstarPa2Params.simple().make_aligner(True)
        results = []
        for (a, b), c in zip(pairs, costs):
            cost, cigar = aligner.align(a, b)
            assert cost == c, f"device cost {c} != trace cost {cost}"
            results.append((cost, cigar))
        return results


class _GapDomainProvider:
    """Heuristic-free domain provider: the cost-f parallelogram (closed
    form, no host build cost).  Same interface as native.DomainHandle."""

    def __init__(self, a: bytes, b: bytes):
        self.n, self.m = len(a), len(b)
        # First-round f: the gap bound plus a small divergence allowance
        # (~6%); the feedback ladder converges from either side.
        self.h0 = abs(self.m - self.n) + max(self.n, 1) // 16

    def sample(self, f_max: int, step: int = 64):
        from ..domain import gap_domain

        return gap_domain(self.n, self.m, f_max, step)

    def close(self) -> None:
        pass


def _trivial_cigar(a: bytes, b: bytes) -> Cigar:
    from ..types import CigarOp

    cigar = Cigar()
    if len(a):
        cigar.push(CigarOp.DEL, len(a))
    if len(b):
        cigar.push(CigarOp.INS, len(b))
    return cigar


from dataclasses import dataclass as _dc


@_dc
class _TraceJob:
    """One deferred checkpoint trace: pair index + its column in a staged
    readback chunk (whose device->host copy is already in flight).
    ``slices is None`` marks a *direct* whole-pair DT trace (no device
    checkpoints at all; traced from the certified cost ``want``)."""

    pair: int
    slices: tuple | None  # (ckvp, ckvm, cktv) device arrays of ONE chunk
    pos: int       # this pair's column within the chunk
    shift: np.ndarray
    s_words: int
    sw: int
    cb: int
    want: int


# Checkpoint readback is issued early and in a few chunks, so the traces
# of chunk k overlap the transfer of chunk k+1.
_CHUNK_TARGET_BYTES = 2 * 2**20
# Ceiling for the *optimistic* pre-certification readback (checkpoints of
# every lane stream to the host before the cost vector arrives; a failed
# rung wastes at most this many bytes).
_OPT_READBACK_BYTES = 8 * 2**20


def _stage_ck_chunks(ckvp, ckvm, cktv, lanes: int):
    """Split checkpoint planes into per-lane-range chunks and start an async
    device->host copy for each; returns ``[(c0, c1, (vp, vm, tv)), ...]``.

    Issuing every copy up front pays the per-transfer latency once (the
    copies pipeline behind each other) instead of once per blocking
    ``np.asarray`` at trace time."""
    per_lane = 4 * (
        int(ckvp.size) + int(ckvm.size) + int(cktv.size)
    ) // max(1, int(ckvp.shape[2]))
    n_chunks = int(max(1, min(8, per_lane * lanes // _CHUNK_TARGET_BYTES)))
    step = -(-lanes // n_chunks)
    chunks = []
    for c0 in range(0, lanes, step):
        c1 = min(lanes, c0 + step)
        sl = (ckvp[:, :, c0:c1], ckvm[:, :, c0:c1], cktv[:, c0:c1])
        for x in sl:
            copy = getattr(x, "copy_to_host_async", None)
            if copy is not None:
                copy()
        chunks.append((c0, c1, sl))
    return chunks


def _chunk_of(chunks, p: int):
    for c0, c1, sl in chunks:
        if c0 <= p < c1:
            return c0, sl
    raise AssertionError(f"position {p} outside staged chunks")


def _run_kernel(kern, sw: int, CB, diag, a0, a1, pb0, pb1, n, m,
                schedule=None):
    """One kernel call: cost, or cost + checkpoints every ``CB`` columns."""
    if CB:
        return kern.ck(a0, a1, pb0, pb1, n, m, band_words=sw, col_block=CB,
                       diag=diag, schedule=schedule)
    return kern.cost(a0, a1, pb0, pb1, n, m, band_words=sw, diag=diag,
                     schedule=schedule)


#: Label of the most recent kernel dispatch (see the module docstring);
#: per-run labels are in ``BatchStats.kernels``.
LAST_KERNEL = None


@functools.lru_cache(maxsize=None)
def _sharded(mesh, kern, sw: int, CB, diag, per_pair: bool):
    """``shard_map`` of one kernel over the mesh's batch axis: every shard
    runs ``kern`` on its own pairs; checkpoints come back sharded along
    the pair axis.  Cached per geometry so jit's trace cache holds across
    batches."""
    import jax
    from jax.sharding import PartitionSpec as P

    fn = functools.partial(_run_kernel, kern, sw, CB, diag)
    cols = P(None, "batch")
    vec = P("batch")
    planes = P(None, None, "batch")
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(cols, cols, cols, cols, vec, vec)
            + ((cols,) if per_pair else ()),
            out_specs=(vec, planes, planes, cols) if CB else vec,
            # Kernel outputs carry no vma annotations; the body is purely
            # per-shard (no collectives), so vma checking adds nothing.
            check_vma=False,
        )
    )


def _buckets(pairs, idxs: list[int], growth: float = 1.5) -> list[list[int]]:
    """Group pair indices into shape buckets: geometric n-classes so padding
    waste is bounded by ``growth``; within a class, one bucket (m_max is
    checked against the banded kernel's one-shift-per-column requirement
    m_max <= W * n_max, guaranteed here by splitting skewed pairs off)."""
    by_class: dict[tuple[int, int], list[int]] = {}
    for i in idxs:
        a, b = pairs[i]
        ncls = 0
        size = 64
        while size < len(a):
            size = int(size * growth) + 1
            ncls += 1
        skew = 0 if len(b) <= W * max(1, len(a)) else 1
        by_class.setdefault((ncls, skew), []).append(i)
    out = []
    for (_, skew), members in sorted(by_class.items()):
        if skew:
            # Extremely skewed pairs (m > 32n): full-height window per pair.
            out.extend([[i] for i in members])
        else:
            out.append(members)
    return out
