"""Frame lookahead: sliding-window content analysis ahead of the
encoder (the x264-lookahead analog). Downsampled inter-frame costs
decide, before a frame reaches the encoder:

  - scene-cut IDRs (cost spike => restart the prediction chain), and
  - adaptive B placement (a display pair codes as B+P only when both
    halves of the pair move smoothly; erratic motion falls back to
    P+P, where bi-prediction would have wasted bits): the `allow_b`
    hint that H265DeviceEncoder.push_frame takes.

Copy of ceracoder_tpu/control/lookahead.py: `CutDetector` (also the
app's immediate-mode detector), the `Lookahead` window and its `Plan`s.

Pure host-side numpy on 4x4-pooled luma.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Plan:
    frame: object            # the (y, u, v) planes as pushed
    force_idr: bool = False
    allow_b: bool = False    # this frame may code as the B of a pair


# a cut is a RELATIVE cost spike (> CUT_RATIO x the running EMA and
# above an absolute floor): absolute thresholds misread both calm
# content (real cuts between similar scenes score low) and noisy content
# (every frame scores high)
CUT_RATIO = 2.0
CUT_FLOOR = 12.0
# a display pair codes as B+P only while both of its costs stay below
B_THRESHOLD = 12.0


class CutDetector:
    """Relative scene-cut detector on 4x4-pooled luma (shared by the
    Lookahead window and the app's immediate-mode path)."""

    def __init__(self, ratio: float = CUT_RATIO, floor: float = CUT_FLOOR):
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


class Lookahead:
    def __init__(self, depth: int = 3, bframes: int = 0):
        self.depth = max(2, depth)
        self.bframes = bframes
        self._buf: list[Plan] = []
        self._costs: list[float] = []       # cost[i] = d(i-1 -> i)
        self._det = CutDetector()

    def push(self, frame) -> list[Plan]:
        """Feed one display-order frame; returns the plans released
        from the window (possibly empty)."""
        c, cut = self._det.feed(frame[0])
        self._buf.append(Plan(frame=frame, force_idr=cut))
        self._costs.append(c)
        out: list[Plan] = []
        while len(self._buf) > self.depth:
            out.append(self._release())
        return out

    def flush(self) -> list[Plan]:
        out = []
        while self._buf:
            out.append(self._release())
        return out

    def _release(self) -> Plan:
        p = self._buf.pop(0)
        c_in = self._costs.pop(0)
        # the released frame may code as a B when it and its successor
        # both move smoothly (the successor becomes the forward ref)
        if (self.bframes and not p.force_idr
                and self._costs
                and not self._buf[0].force_idr
                and c_in < B_THRESHOLD
                and self._costs[0] < B_THRESHOLD):
            p.allow_b = True
        return p
