"""PTS fixup: lock jittery capture timestamps to a clean output grid.

Reimplements the reference's ptsfixup pad probe (reference:
src/ceracoder.c:341-423): the first frame locks a nominal period from
the configured framerate; every following frame updates a rolling
average of the observed inter-frame delta with weight 3/1000 (with
rounding), snaps the output PTS forward by a whole number of periods
(incr = (diff/2 + period) // period * period), marks backwards or
duplicate frames droppable, and zeroes DTS.

All timestamps are in 90 kHz ticks (the MPEG-TS clock).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FixedPts:
    pts90: int          # snapped output PTS
    droppable: bool     # backwards/duplicate input frame
    dts90: None = None  # always zeroed (reference :377)


class PtsFixup:
    """Feed per-frame capture timestamps, get grid-locked PTS out."""

    def __init__(self, fps_num: int, fps_den: int = 1):
        # nominal period from the caps framerate (reference :346-368)
        self.period = int(round(90000 * fps_den / max(1, fps_num)))
        self._nominal = self.period
        self._last_in: int | None = None
        self._last_out: int | None = None

    def feed(self, in_pts90: int) -> FixedPts:
        if self._last_in is None:
            self._last_in = in_pts90
            self._last_out = in_pts90
            return FixedPts(pts90=in_pts90, droppable=False)

        delta = in_pts90 - self._last_in
        # backwards or duplicate input: droppable, grid not advanced
        # (reference :408-419)
        if delta <= 0:
            return FixedPts(pts90=self._last_out, droppable=True)
        self._last_in = in_pts90

        # rolling-average period, weight 3/1000 with rounding
        # (reference :392-401); only sane deltas train it
        if 0 < delta < 2 * self._nominal:
            self.period += ((delta - self.period) * 3 + 500) // 1000
            self.period = max(1, self.period)

        # snap to the output grid: advance by the whole number of
        # periods nearest to the input diff (reference :399-407)
        diff = in_pts90 - self._last_out
        incr = (diff // 2 + self.period) // self.period * self.period
        if incr <= 0:
            return FixedPts(pts90=self._last_out, droppable=True)
        self._last_out += incr
        return FixedPts(pts90=self._last_out, droppable=False)
