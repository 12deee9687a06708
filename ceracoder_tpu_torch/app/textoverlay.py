"""In-video overlay: burn the telemetry line into the luma plane.

The reference's overlay is a GStreamer textoverlay element fed the
debug line every 20 ms tick (reference: src/gst/overlay_ui.c:34-48);
for a live-ops product the on-screen surface is the feature. Here the
line renders host-side into the Y plane before encode with a built-in
5x7 bitmap font (charset = exactly the overlay format's characters).
"""

from __future__ import annotations

import numpy as np

# 5x7 glyphs, rows top->bottom, 5-bit masks (MSB = leftmost column)
_GLYPHS = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    ":": (0x00, 0x04, 0x04, 0x00, 0x04, 0x04, 0x00),
    "/": (0x01, 0x01, 0x02, 0x04, 0x08, 0x10, 0x10),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "b": (0x10, 0x10, 0x1E, 0x11, 0x11, 0x11, 0x1E),
    "r": (0x00, 0x00, 0x16, 0x19, 0x10, 0x10, 0x10),
    "t": (0x08, 0x08, 0x1C, 0x08, 0x08, 0x09, 0x06),
    "s": (0x00, 0x00, 0x0F, 0x10, 0x0E, 0x01, 0x1E),
}

GLYPH_W, GLYPH_H = 6, 8      # cell size incl. 1px spacing


def _glyph_array(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch, _GLYPHS[" "])
    g = np.zeros((GLYPH_H, GLYPH_W), bool)
    for r, bits in enumerate(rows):
        for c in range(5):
            if bits & (1 << (4 - c)):
                g[r, c] = True
    return g


_CACHE: dict[str, np.ndarray] = {}


def render_line(text: str) -> np.ndarray:
    """Boolean bitmap of a text line, (GLYPH_H, len*GLYPH_W)."""
    key = text
    if key not in _CACHE:
        if len(_CACHE) > 256:
            _CACHE.clear()
        _CACHE[key] = np.concatenate(
            [_glyph_array(ch) for ch in text], axis=1)
    return _CACHE[key]


def burn_overlay(y_plane: np.ndarray, text: str, x0: int = 8,
                 y0: int = 8, scale: int = 1) -> np.ndarray:
    """Composite `text` into the luma plane (white glyphs on a dark
    box, the textoverlay look). Returns a modified copy."""
    if not text:
        return y_plane
    bm = render_line(text)
    if scale > 1:
        bm = np.repeat(np.repeat(bm, scale, 0), scale, 1)
    h, w = y_plane.shape
    bh, bw = bm.shape
    bh = min(bh, h - y0)
    bw = min(bw, w - x0)
    if bh <= 0 or bw <= 0:
        return y_plane
    out = np.array(y_plane, copy=True)
    region = out[y0:y0 + bh, x0:x0 + bw]
    region[:] = region // 2 + 16             # dim box
    region[bm[:bh, :bw]] = 235               # white text
    return out
