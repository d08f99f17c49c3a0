"""Sparse block store for the band-doubling DP.

Host-side re-design of `astarpa2/src/block.rs` and `blocks.rs`: each block
stores the vertical difference bit-planes at its right edge for a rounded
row range, plus top/bottom values.  The actual column computation runs on
device through :class:`astarpa_tpu.ops.block_kernel.BlockKernel`; this module
does the bookkeeping (ranges, overlap copies, value reconstruction).

Row ranges are rounded to multiples of ``W = 32`` (the reference rounds to
64, `ranges.rs:71-80`; the lane width is a framework constant here).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import os

from ..ops import bitpack
from ..ops.bitpack import W, ONES
from ..ops.block_kernel import BlockKernel

#: Debug self-check of incremental doubling (`blocks.rs:473-543`): set
#: ASTARPA_DEBUG_ID=1 to recompute every block without ID and assert
#: bit-equality.  Enabled by the test suite.
_DEBUG_ID = os.environ.get("ASTARPA_DEBUG_ID", "") == "1"


def round_out(j_range: tuple[int, int]) -> tuple[int, int]:
    lo, hi = j_range
    return (lo // W) * W, -(-hi // W) * W


def round_in(j_range: tuple[int, int]) -> tuple[int, int]:
    lo, hi = j_range
    return -(-lo // W) * W, (hi // W) * W


def is_empty(j_range: tuple[int, int]) -> bool:
    return j_range[0] > j_range[1]


def union(r1, r2):
    return (min(r1[0], r2[0]), max(r1[1], r2[1]))


def intersection(r1, r2):
    return (max(r1[0], r2[0]), min(r1[1], r2[1]))


def v_range(rounded_j_range: tuple[int, int]) -> tuple[int, int]:
    """Exclusive range of height-W word rows for a rounded row range."""
    lo, hi = rounded_j_range
    assert lo % W == 0 and hi % W == 0, rounded_j_range
    return lo // W, hi // W


@dataclass
class Block:
    """Right-edge vertical diffs for rows ``j_range`` at column ``i_range[1]``.

    Mirror of `block.rs:8-31`.
    """

    vp: np.ndarray
    vm: np.ndarray
    i_range: tuple[int, int]
    original_j_range: tuple[int, int]
    j_range: tuple[int, int]  # rounded out
    fixed_j_range: tuple[int, int] | None
    offset: int
    top_val: int
    bot_val: int
    j_h: int | None = None

    @staticmethod
    def default() -> "Block":
        return Block(
            vp=np.zeros(0, np.uint32),
            vm=np.zeros(0, np.uint32),
            i_range=(-1, 0),
            original_j_range=(-W, -W),
            j_range=(-W, -W),
            fixed_j_range=None,
            offset=0,
            top_val=1 << 30,
            bot_val=1 << 30,
            j_h=None,
        )

    @staticmethod
    def first_col(original_j_range: tuple[int, int], rounded: tuple[int, int]) -> "Block":
        assert rounded[0] == 0
        nwords = (rounded[1] - rounded[0]) // W
        return Block(
            vp=np.full(nwords, ONES, np.uint32),
            vm=np.zeros(nwords, np.uint32),
            i_range=(-1, 0),
            original_j_range=original_j_range,
            j_range=rounded,
            fixed_j_range=original_j_range,
            offset=0,
            top_val=0,
            bot_val=rounded[1] - rounded[0],
            j_h=None,
        )

    def index(self, j: int) -> int:
        """Value at row ``j``; rows past the range assume +1 deltas
        (`block.rs:69-122`)."""
        lo, hi = self.j_range
        assert lo <= j, f"Cannot index block {self.i_range} range {self.j_range} by {j}"
        if j > hi:
            return self.bot_val + (j - hi)
        if j - lo < hi - j:
            val = self.top_val
            j0 = lo
            w = (j0 - self.offset) // W
            while j0 + W <= j:
                val += int(bitpack.v_value(self.vp[w], self.vm[w]))
                j0 += W
                w += 1
            if j > j0:
                val += bitpack.v_value_of_prefix(self.vp[w], self.vm[w], j - j0)
            return val
        val = self.bot_val
        j1 = hi
        while j1 - W > j:
            w = (j1 - W - self.offset) // W
            val -= int(bitpack.v_value(self.vp[w], self.vm[w]))
            j1 -= W
        if j1 > j:
            w = (j1 - W - self.offset) // W
            val -= bitpack.v_value_of_suffix(self.vp[w], self.vm[w], j1 - j)
        return val

    def get(self, j: int) -> int | None:
        if j < self.j_range[0] or j > self.j_range[1]:
            return None
        return self.index(j)

    def get_diff(self, j: int) -> int | None:
        """Vertical difference from row j to j+1 (`block.rs:134-145`)."""
        if j < self.offset:
            return None
        w = (j - self.offset) // W
        if w >= len(self.vp):
            return None
        bit = (j - self.offset) % W
        return int((self.vp[w] >> bit) & 1) - int((self.vm[w] >> bit) & 1)

    def recompute_bot_val(self) -> None:
        """bot_val = top_val + sum of v over the rounded range
        (`block.rs:148-159` identity, used here as the primary accounting)."""
        w0 = (self.j_range[0] - self.offset) // W
        w1 = (self.j_range[1] - self.offset) // W
        self.bot_val = self.top_val + int(
            bitpack.v_value(self.vp[w0:w1], self.vm[w0:w1]).sum()
        )


def init_v_with_overlap(prev_block: Block, next_block: Block) -> None:
    """Fill next_block's v with +1, copying the overlap from prev_block
    (`blocks.rs:753-767`)."""
    assert next_block.offset == next_block.j_range[0]
    assert prev_block.offset == prev_block.j_range[0]
    pw0, pw1 = v_range(prev_block.j_range)
    w0, w1 = v_range(next_block.j_range)
    nwords = w1 - w0
    next_block.vp = np.full(nwords, ONES, np.uint32)
    next_block.vm = np.zeros(nwords, np.uint32)
    o0, o1 = max(w0, pw0), min(w1, pw1)
    if o0 < o1:
        next_block.vp[o0 - w0 : o1 - w0] = prev_block.vp[o0 - pw0 : o1 - pw0]
        next_block.vm[o0 - w0 : o1 - w0] = prev_block.vm[o0 - pw0 : o1 - pw0]


class Blocks:
    """The block store + compute dispatch (mirror of `blocks.rs:87-545`).

    Incremental doubling (`j_h`/HMode machinery) is handled in
    :meth:`compute_next_block` when ``params.incremental_doubling`` is set.
    """

    def __init__(self, kernel: BlockKernel, trace: bool, b_len: int, params):
        self.kernel = kernel
        self.trace = trace
        self.b_len = b_len
        self.params = params
        self.blocks: list[Block] = []
        self.last_block_idx = 0
        self.i_range = (-1, 0)
        # Horizontal diffs at row j_h per column, for incremental doubling
        # (`blocks.rs:103-106`). hp/hm bits per column of a.
        n = len(kernel.a0)
        if params.incremental_doubling:
            self.hp = np.zeros(n, np.uint32)
            self.hm = np.zeros(n, np.uint32)
        self.num_blocks = 0

    def init(self, initial_j_range: tuple[int, int]) -> None:
        assert initial_j_range[0] == 0
        self.last_block_idx = 0
        self.i_range = (-1, 0)
        fixed_j_range = initial_j_range
        if self.blocks:
            initial_j_range = union(initial_j_range, self.blocks[0].j_range)
        rounded = round_out(initial_j_range)
        block = Block.first_col(fixed_j_range, rounded)
        if not self.blocks:
            self.blocks.append(block)
        else:
            self.blocks[0] = block

    def last_block(self) -> Block:
        return self.blocks[self.last_block_idx]

    def next_block_j_range(self) -> tuple[int, int] | None:
        if self.last_block_idx + 1 < len(self.blocks):
            return self.blocks[self.last_block_idx + 1].j_range
        return None

    def set_last_block_fixed_j_range(self, fixed) -> None:
        old = self.blocks[self.last_block_idx].fixed_j_range
        if old is not None and fixed is not None:
            self.blocks[self.last_block_idx].fixed_j_range = union(old, fixed)
        else:
            self.blocks[self.last_block_idx].fixed_j_range = fixed

    def pop_last_block(self) -> None:
        assert self.i_range[1] == self.blocks[self.last_block_idx].i_range[1]
        self.i_range = (self.i_range[0], self.blocks[self.last_block_idx].i_range[0])
        self.last_block_idx -= 1

    def reuse_next_block(self, i_range, j_range) -> None:
        assert self.i_range[1] == i_range[0]
        self.i_range = (self.i_range[0], i_range[1])
        self.last_block_idx += 1
        block = self.blocks[self.last_block_idx]
        assert block.i_range == i_range
        assert block.j_range == round_out(j_range)

    def compute_next_block(self, i_range: tuple[int, int], j_range: tuple[int, int]) -> None:
        """Compute the block for columns ``i_range`` and rows ``j_range``
        (`blocks.rs:205-545`, without the debug recompute)."""
        self.num_blocks += 1
        original_j_range = j_range
        rounded = round_out(j_range)
        w0, w1 = v_range(rounded)

        if self.last_block_idx + 1 < len(self.blocks):
            nb = self.blocks[self.last_block_idx + 1]
            lo, hi = nb.j_range
            assert rounded[0] <= lo and hi <= rounded[1], "j_range must grow"

        assert self.i_range[1] == i_range[0]
        self.i_range = (self.i_range[0], i_range[1])

        prev_block = self.blocks[self.last_block_idx]
        prev_top_val = prev_block.index(rounded[0])
        prev_bot_val = prev_block.index(rounded[1])

        # Append or reuse the next block's slot.
        if self.last_block_idx + 1 == len(self.blocks):
            self.blocks.append(Block.default())
        else:
            assert self.blocks[self.last_block_idx + 1].i_range == i_range
        old_block = self.blocks[self.last_block_idx + 1]
        self.last_block_idx += 1

        next_block = Block(
            vp=np.zeros(0, np.uint32),
            vm=np.zeros(0, np.uint32),
            i_range=i_range,
            original_j_range=original_j_range,
            j_range=rounded,
            fixed_j_range=old_block.fixed_j_range,
            offset=rounded[0],
            top_val=prev_top_val + (i_range[1] - i_range[0]),
            bot_val=prev_bot_val,  # updated below
            j_h=None,
        )
        self.blocks[self.last_block_idx] = next_block

        use_id = (
            self.params.incremental_doubling and prev_block.fixed_j_range is not None
        )
        if not use_id:
            init_v_with_overlap(prev_block, next_block)
            next_block.vp, next_block.vm, _, _ = self.kernel.compute(
                i_range[0], i_range[1], w0, w1, next_block.vp, next_block.vm
            )
            next_block.recompute_bot_val()
            return

        # --- Incremental doubling (`blocks.rs:342-469`) -------------------
        prev_fixed = round_in(prev_block.fixed_j_range)
        old_fixed = old_block.fixed_j_range
        new_j_h = prev_fixed[1]
        next_block.j_h = new_j_h
        i0, i1 = i_range

        if (
            old_block.j_h is not None
            and old_fixed is not None
            and -(-(old_fixed[0] - 1) // W) * W < old_block.j_h
        ):
            old_j_h = old_block.j_h
            init_v_with_overlap_preserve_fixed(prev_block, old_block, next_block)
            # 3-way split: [top, old_fixed.0-1) no h; [old_j_h, new_j_h) h update;
            # [new_j_h, bottom) h input. The fixed stripe between is skipped.
            r0 = v_range(round_out((rounded[0], old_fixed[0] - 1)))
            r1 = v_range((old_j_h, new_j_h))
            r2 = v_range((new_j_h, rounded[1]))
            assert r1[0] <= r1[1], "j_h may only increase"
            self._compute_slice(i0, i1, r0, next_block, hmode="none")
            if r1[0] < r1[1]:
                self._compute_slice(i0, i1, r1, next_block, hmode="update")
            self._compute_slice(i0, i1, r2, next_block, hmode="input")
        else:
            init_v_with_overlap(prev_block, next_block)
            r01 = v_range((rounded[0], new_j_h))
            r2 = v_range((new_j_h, rounded[1]))
            self._compute_slice(i0, i1, r01, next_block, hmode="output")
            self._compute_slice(i0, i1, r2, next_block, hmode="input")
        next_block.recompute_bot_val()

        if _DEBUG_ID:
            # Debug self-check (`blocks.rs:473-543`): recompute the block
            # without incremental doubling and assert bit-equality.
            check = Block.default()
            check.i_range = i_range
            check.j_range = rounded
            check.offset = rounded[0]
            init_v_with_overlap(prev_block, check)
            check.vp, check.vm, _, _ = self.kernel.compute(
                i_range[0], i_range[1], w0, w1, check.vp, check.vm
            )
            assert (np.asarray(check.vp) == np.asarray(next_block.vp)).all(), (
                "incremental doubling v mismatch"
            )
            assert (np.asarray(check.vm) == np.asarray(next_block.vm)).all()

    def _compute_slice(self, i0, i1, wr, block: Block, hmode: str) -> None:
        """Run the kernel on word rows ``wr``; handle the HMode h plumbing
        (`blocks.rs:665-748`)."""
        w0, w1 = wr
        if w0 == w1:
            # No words: h passes through unchanged; OUTPUT mode still must
            # set the +1 top deltas (`blocks.rs:443`).
            if hmode == "output":
                self.hp[i0:i1] = 1
                self.hm[i0:i1] = 0
            return
        off = block.offset // W
        vp = block.vp[w0 - off : w1 - off]
        vm = block.vm[w0 - off : w1 - off]
        ncols = i1 - i0
        if hmode == "none" or hmode == "output":
            hp_in = np.ones(ncols, np.uint32)
            hm_in = np.zeros(ncols, np.uint32)
        else:
            hp_in = self.hp[i0:i1].copy()
            hm_in = self.hm[i0:i1].copy()
        vp_o, vm_o, hp_o, hm_o = self.kernel.compute(i0, i1, w0, w1, vp, vm, hp_in, hm_in)
        block.vp[w0 - off : w1 - off] = vp_o
        block.vm[w0 - off : w1 - off] = vm_o
        if hmode in ("update", "output"):
            self.hp[i0:i1] = hp_o
            self.hm[i0:i1] = hm_o

    # --- Traceback support -------------------------------------------------

    def fill_with_blocks(self, i_range: tuple[int, int], original_j_range) -> None:
        """Store one block per column in ``i_range`` (`blocks.rs:572-662`)."""
        rounded = round_out(original_j_range)
        assert self.i_range[1] == i_range[0]
        self.i_range = (self.i_range[0], i_range[1])
        w0, w1 = v_range(rounded)

        prev_block = self.blocks[self.last_block_idx]
        assert prev_block.i_range[1] == i_range[0]

        template = Block(
            vp=np.zeros(0, np.uint32),
            vm=np.zeros(0, np.uint32),
            i_range=(i_range[0], i_range[0]),
            original_j_range=original_j_range,
            j_range=rounded,
            fixed_j_range=None,
            offset=rounded[0],
            top_val=prev_block.index(rounded[0]),
            bot_val=0,
            j_h=None,
        )
        init_v_with_overlap(prev_block, template)

        vp_cols, vm_cols = self.kernel.fill(
            i_range[0], i_range[1], w0, w1, template.vp, template.vm
        )
        top_val = template.top_val
        for k, i in enumerate(range(i_range[0], i_range[1])):
            top_val += 1
            blk = Block(
                vp=vp_cols[k].copy(),
                vm=vm_cols[k].copy(),
                i_range=(i, i + 1),
                original_j_range=original_j_range,
                j_range=rounded,
                fixed_j_range=None,
                offset=rounded[0],
                top_val=top_val,
                bot_val=0,
                j_h=None,
            )
            blk.recompute_bot_val()
            self.last_block_idx += 1
            if self.last_block_idx == len(self.blocks):
                self.blocks.append(blk)
            else:
                self.blocks[self.last_block_idx] = blk


def init_v_with_overlap_preserve_fixed(
    prev_block: Block, old_block: Block, next_block: Block
) -> None:
    """Overlap init preserving the old block's fixed stripe
    (`blocks.rs:774-831`)."""
    assert prev_block.offset == prev_block.j_range[0]
    assert old_block.offset == old_block.j_range[0]
    assert next_block.offset == next_block.j_range[0]
    nlo, nhi = next_block.j_range
    olo, ohi = old_block.j_range
    assert nlo <= olo and ohi <= nhi

    pw0, pw1 = v_range(prev_block.j_range)
    ow0, ow1 = v_range(old_block.j_range)
    w0, w1 = v_range(next_block.j_range)
    assert pw0 <= w0 <= ow0
    ps, pe = v_range(round_in((old_block.fixed_j_range[0] - 1, old_block.j_h)))
    assert ps < pe

    nwords = w1 - w0
    vp = np.full(nwords, ONES, np.uint32)
    vm = np.zeros(nwords, np.uint32)
    # Preserved fixed stripe from the old block's v.
    vp[ps - w0 : pe - w0] = old_block.vp[ps - ow0 : pe - ow0]
    vm[ps - w0 : pe - w0] = old_block.vm[ps - ow0 : pe - ow0]
    # Prefix and suffix from prev_block.
    vp[: ps - w0] = prev_block.vp[w0 - pw0 : ps - pw0]
    vm[: ps - w0] = prev_block.vm[w0 - pw0 : ps - pw0]
    copy_end = min(w1, pw1)
    if pe < copy_end:
        vp[pe - w0 : copy_end - w0] = prev_block.vp[pe - pw0 : copy_end - pw0]
        vm[pe - w0 : copy_end - w0] = prev_block.vm[pe - pw0 : copy_end - pw0]
    next_block.vp = vp
    next_block.vm = vm
