"""Scene-cut detection ahead of the encoder (the x264-lookahead
analog): a downsampled inter-frame cost spike restarts the prediction
chain with an IDR.

Copy of CutDetector from ceracoder_tpu/control/lookahead.py, the app's
immediate-mode detector. The B-frame `Lookahead` window of that module
goes with the B-frame slice of the port (ROADMAP.md item 10).

Pure host-side numpy on 4x4-pooled luma.
"""

from __future__ import annotations

import numpy as np


class CutDetector:
    """Relative scene-cut detector on 4x4-pooled luma."""

    def __init__(self, ratio: float = 2.0, floor: float = 12.0):
        self.ratio = ratio
        self.floor = floor
        self._prev_small = None
        self._ema: float | None = None

    def cost(self, y) -> float:
        # 4x4 block means: subsampling aliases on texture (any pan
        # reads as a cut) while 8x8 pooling washes out real noise
        # changes; 4x4 separates pan (~6) / noise (~20) / cut (~35)
        a = np.asarray(y).astype(np.int32)
        h, w = a.shape
        a = a[:h // 4 * 4, :w // 4 * 4]
        small = a.reshape(h // 4, 4, -1, 4).mean((1, 3))
        prev = self._prev_small
        self._prev_small = small
        if prev is None or prev.shape != small.shape:
            self._ema = None
            return 0.0
        return float(np.abs(small - prev).mean())

    def feed(self, y) -> tuple[float, bool]:
        """(cost, is_cut) for one frame; trains the EMA on non-cuts."""
        c = self.cost(y)
        cut = (self._ema is not None and c > self.floor
               and c > self.ratio * self._ema)
        if not cut:
            self._ema = (c if self._ema is None
                         else self._ema + 0.3 * (c - self._ema))
        return c, cut
