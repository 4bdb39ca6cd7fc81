"""In-terminal live preview: ANSI truecolor rendering of the film.

Copy of volume_path_tracer_tpu/io/term.py (numpy and the stdlib only). The
reference renderer shows a raylib window redrawn at 5 FPS while workers fill
the film (its main.cpp:89-132). A GPU render typically runs on a headless
host over SSH, so the equivalent interactive surface is the terminal itself:
the film is downsampled and painted with 24-bit ANSI background colors using
half-block characters (two image rows per text row), redrawn in place at
every wave boundary. Enabled by `vpt-torch --live`.

Degrades to a no-op on non-TTY outputs.
"""
from __future__ import annotations

import shutil
import sys

import numpy as np


def _downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Box-average [H, W, 3] u8 -> [out_h, out_w, 3] u8 (pure numpy)."""
    H, W, _ = img.shape
    ys = (np.arange(out_h + 1) * H // out_h).clip(0, H)
    xs = (np.arange(out_w + 1) * W // out_w).clip(0, W)
    out = np.empty((out_h, out_w, 3), np.uint8)
    acc = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    acc = np.pad(acc, ((1, 0), (1, 0), (0, 0)))
    for j in range(out_h):
        y0, y1 = ys[j], max(ys[j + 1], ys[j] + 1)
        a = acc[y1, xs[1:]] - acc[y0, xs[1:]] - acc[y1, xs[:-1]] + acc[y0, xs[:-1]]
        n = (y1 - y0) * np.maximum(xs[1:] - xs[:-1], 1)
        out[j] = (a / n[:, None]).clip(0, 255).astype(np.uint8)
    return out


class TermPreview:
    """Repaints the film as ANSI half-blocks in place (alternate-free)."""

    def __init__(self, max_cols: int = 100, stream=None):
        self._stream = stream if stream is not None else sys.stdout
        self._max_cols = max_cols
        self._rows_drawn = 0
        self._enabled = hasattr(self._stream, "isatty") and self._stream.isatty()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def geometry(self, H: int, W: int):
        """(out_h, out_w) the painter downsamples an [H, W] image to.

        Callers rendering large films can downsample on the device and pass
        the already-small image to draw (which then skips its own
        downsample): the painted image is about 30 kB, whatever the film's
        size.
        """
        cols = min(self._max_cols, shutil.get_terminal_size((80, 24)).columns, W)
        # Terminal cells are ~2x taller than wide; half-blocks give square-ish
        # pixels at 2 image rows per text row.
        rows_img = max(2, (H * cols) // W) & ~1
        return rows_img, cols

    def draw(self, rgb_u8: np.ndarray, status: str = "") -> None:
        """Paint [H, W, 3] uint8 (and a status line) over the previous frame."""
        if not self._enabled:
            return
        H, W, _ = rgb_u8.shape
        rows_img, cols = self.geometry(H, W)
        if (H, W) == (rows_img, cols):
            small = np.asarray(rgb_u8)
        else:
            small = _downsample(np.asarray(rgb_u8), cols, rows_img)
        lines = []
        for y in range(0, rows_img, 2):
            top, bot = small[y], small[y + 1]
            cells = [
                f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                for t, b in zip(top, bot)
            ]
            lines.append("".join(cells) + "\x1b[0m")
        if status:
            lines.append(status[: cols * 2])
        up = f"\x1b[{self._rows_drawn}A" if self._rows_drawn else ""
        self._stream.write(up + "\r" + "\x1b[J" + "\n".join(lines) + "\n")
        self._stream.flush()
        self._rows_drawn = len(lines)

    def finish(self) -> None:
        self._rows_drawn = 0
