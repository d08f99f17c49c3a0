"""Visualization layer (re-design of the `pa-vis` crate, SURVEY.md §1 L5).

The aligners accept a visualizer factory with ``build(a, b) -> instance``;
the instance receives the callback stream of `pa-vis/src/lib.rs:26-129`
(``explore``/``expand``/``extend``/``expand_block``/``h_call``/``j_range``/
``new_layer``/``last_frame`` …).  Two implementations:

- :class:`NoVis`: the no-op default.
- :class:`Visualizer`: renders the NW grid (explored / expanded / extended
  states, block fills, the final path) to PNG frames per layer or a single
  last frame — headless (pure stdlib zlib PNG encoder), this repo's stand-in
  for the reference's SDL2 window.  The web/HTML export lives in
  :mod:`astarpa_tpu.vis.html` (pa-web equivalent).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..types import Cigar, Pos
from .canvas import write_png

__all__ = ["NoVis", "Visualizer", "VisConfig", "When"]


class NoVis:
    """No-op visualizer (`pa-vis/src/lib.rs:119-129`)."""

    def build(self, a: bytes, b: bytes) -> "NoVis":
        return self

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *a, **k: None


class When(enum.Enum):
    """When to save a frame (`pa-vis` Config::draw)."""

    NONE = "none"
    LAST = "last"
    LAYERS = "layers"
    ALL = "all"


@dataclass
class VisConfig:
    """Subset of the reference's visualizer Config (`visualizer.rs:85+`)."""

    draw: When = When.LAST
    save: str | None = None  # directory for frames
    cell_size: int = 2
    downscaler: int = 1  # positions per pixel
    filepath_prefix: str = "frame"
    # Extra panels (`visualizer.rs:1265-1281` layer drawing, `:1608`
    # draw_dt, `:1798` draw_f):
    draw_contours: bool = False  # contour layer boundaries + matches
    draw_dt: bool = False        # (diagonal, g) DT-space panel
    draw_f: bool = False         # f-profile along the expansion frontier

    def build(self, a: bytes, b: bytes) -> "VisualizerInstance":
        return VisualizerInstance(a, b, self)


Visualizer = VisConfig  # factory alias mirroring the reference naming


# Colors (RGB)
_BG = (255, 255, 255)
_EXPLORED = (128, 0, 128)
_EXPANDED = (0, 102, 204)
_EXTENDED = (0, 180, 80)
_BLOCK = (210, 225, 245)
_PATH = (0, 0, 0)
_MATCH = (180, 180, 180)


class VisualizerInstance:
    """Records the search state stream and renders PNG frames."""

    def __init__(self, a: bytes, b: bytes, config: VisConfig):
        self.a = a
        self.b = b
        self.config = config
        d = max(1, config.downscaler)
        self.w = len(a) // d + 2
        self.h = len(b) // d + 2
        self.d = d
        self.grid = np.zeros((self.h, self.w), dtype=np.uint8)
        self.frame_idx = 0
        self.layer_idx = 0
        self.path: list[Pos] | None = None
        self.dt_states: list[tuple[int, int]] = []  # (diagonal, g)
        self.f_profile: dict[int, int] = {}  # i // d -> max f seen
        self._h = None  # heuristic instance, captured at last_frame

    # -- state stream (`pa-vis/src/lib.rs:33-112`) -----------------------------

    def _mark(self, pos: Pos, level: int) -> None:
        x, y = pos.i // self.d, pos.j // self.d
        if 0 <= x < self.w and 0 <= y < self.h and self.grid[y, x] < level:
            self.grid[y, x] = level

    def explore(self, pos: Pos, g=0, f=0, h=None) -> None:
        self._mark(pos, 1)
        if self.config.draw == When.ALL:
            self._save_frame()

    def expand(self, pos: Pos, g=0, f=0, h=None) -> None:
        self._mark(pos, 3)
        if self.config.draw_dt:
            self.dt_states.append((pos.i - pos.j, int(g)))
        if self.config.draw_f:
            x = pos.i // self.d
            self.f_profile[x] = max(self.f_profile.get(x, 0), int(f))
        if self.config.draw == When.ALL:
            self._save_frame()

    def extend(self, pos: Pos, g=0, f=0, h=None) -> None:
        self._mark(pos, 2)

    def expand_block(self, pos: Pos, size: Pos, g=0, f=0, h=None) -> None:
        x0, y0 = pos.i // self.d, pos.j // self.d
        x1 = min(self.w, (pos.i + size.i) // self.d + 1)
        y1 = min(self.h, (pos.j + size.j) // self.d + 1)
        block = self.grid[max(0, y0) : y1, max(0, x0) : x1]
        np.maximum(block, 1, out=block)

    def expand_block_trace(self, pos: Pos, size: Pos) -> None:
        self.expand_block(pos, size)

    def expand_trace(self, pos: Pos) -> None:
        self._mark(pos, 3)

    def extend_trace(self, pos: Pos) -> None:
        self._mark(pos, 2)

    def h_call(self, pos: Pos) -> None:
        pass

    def f_call(self, pos: Pos, in_bounds: bool = True, fixed: bool = False) -> None:
        pass

    def j_range(self, start: Pos, end: Pos) -> None:
        pass

    def fixed_j_range(self, start: Pos, end: Pos) -> None:
        pass

    def new_layer(self, h=None) -> None:
        self.layer_idx += 1
        if self.config.draw == When.LAYERS:
            self._save_frame()

    def last_frame(self, cigar: Cigar | None = None, h=None) -> None:
        if cigar is not None:
            self.path = cigar.to_path()
        self._h = h
        if self.config.draw != When.NONE:
            self._save_frame(final=True)

    # -- rendering ----------------------------------------------------------------

    def render(self) -> np.ndarray:
        """RGB image of the current state (+ optional panels)."""
        cs = max(1, self.config.cell_size)
        img = np.empty((self.h, self.w, 3), dtype=np.uint8)
        img[:] = _BG
        img[self.grid == 1] = _EXPLORED
        img[self.grid == 2] = _EXTENDED
        img[self.grid == 3] = _EXPANDED
        if self.config.draw_contours and self._h is not None:
            self._draw_contours(img)
        if self.path is not None:
            for p in self.path:
                x, y = p.i // self.d, p.j // self.d
                if 0 <= x < self.w and 0 <= y < self.h:
                    img[y, x] = _PATH
        panels = [img]
        if self.config.draw_dt and self.dt_states:
            panels.append(self._render_dt(img.shape[1]))
        if self.config.draw_f and self.f_profile:
            panels.append(self._render_f(img.shape[1]))
        if len(panels) > 1:
            width = max(p.shape[1] for p in panels)
            padded = []
            for p in panels:
                if p.shape[1] < width:
                    pad = np.full((p.shape[0], width - p.shape[1], 3), 230, np.uint8)
                    p = np.concatenate([p, pad], axis=1)
                padded.append(p)
                padded.append(np.zeros((2, width, 3), np.uint8))  # separator
            img = np.concatenate(padded[:-1], axis=0)
        if cs > 1:
            img = np.repeat(np.repeat(img, cs, axis=0), cs, axis=1)
        return img

    def _draw_contours(self, img: np.ndarray) -> None:
        """Contour layer boundaries of the heuristic's score function
        (`visualizer.rs:1265-1281`): sample score(T(i, j)) on the grid and
        tint cells where the layer changes; overlay active matches."""
        h = self._h
        if not hasattr(h, "contours") or not hasattr(h, "transform"):
            return
        step = max(1, min(self.w, self.h) // 256) * self.d
        xs = range(0, len(self.a) + 1, step)
        ys = range(0, len(self.b) + 1, step)
        score = np.zeros((len(list(ys)), len(list(xs))), dtype=np.int32)
        for yi, j in enumerate(ys):
            for xi, i in enumerate(xs):
                try:
                    score[yi, xi] = h.contours.score(h.transform(Pos(i, j)))
                except Exception:
                    return
        # Boundary where the layer value changes between neighbors.
        bnd = np.zeros_like(score, dtype=bool)
        bnd[:, 1:] |= score[:, 1:] != score[:, :-1]
        bnd[1:, :] |= score[1:, :] != score[:-1, :]
        for yi, xi in zip(*np.nonzero(bnd)):
            x = xi * step // self.d
            y = yi * step // self.d
            if 0 <= x < self.w and 0 <= y < self.h:
                img[y, x] = (255, 165, 0)  # orange layer boundary
        if hasattr(h, "matches"):
            try:
                for mt in h.matches():
                    for p in (mt.start, mt.end):
                        x, y = p.i // self.d, p.j // self.d
                        if 0 <= x < self.w and 0 <= y < self.h:
                            img[y, x] = (200, 0, 0)
            except Exception:
                pass

    def _render_dt(self, width: int) -> np.ndarray:
        """(diagonal, g) panel of expanded states (`visualizer.rs:1608`)."""
        ds = [d for d, _ in self.dt_states]
        gs = [g for _, g in self.dt_states]
        dmin, dmax = min(ds), max(ds)
        gmax = max(gs)
        hgt = min(200, gmax + 1)
        panel = np.full((hgt, width, 3), 245, np.uint8)
        for d, g in self.dt_states:
            x = int((d - dmin) / max(1, dmax - dmin) * (width - 1))
            y = int(g / max(1, gmax) * (hgt - 1))
            panel[y, x] = _EXPANDED
        return panel

    def _render_f(self, width: int) -> np.ndarray:
        """f-profile along i (`visualizer.rs:1798`)."""
        fmax = max(self.f_profile.values())
        hgt = 100
        panel = np.full((hgt, width, 3), 245, np.uint8)
        for x, f in self.f_profile.items():
            if 0 <= x < width:
                y = hgt - 1 - int(f / max(1, fmax) * (hgt - 1))
                panel[y:, x] = (120, 120, 220)
        return panel

    def _save_frame(self, final: bool = False) -> None:
        if self.config.save is None:
            return
        out = Path(self.config.save)
        out.mkdir(parents=True, exist_ok=True)
        name = (
            f"{self.config.filepath_prefix}-last.png"
            if final
            else f"{self.config.filepath_prefix}-{self.frame_idx:05d}.png"
        )
        write_png(out / name, self.render())
        self.frame_idx += 1
