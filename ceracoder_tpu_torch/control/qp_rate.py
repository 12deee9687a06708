"""Bitrate -> QP actuation.

The reference pushes the balancer's bitrate into the encoder element as a
GObject property and the encoder's internal CBR logic does the rest
(reference: src/gst/encoder_control.c:45-57). Our encoder's knob is
per-frame QP, so this module supplies the missing piece: a rate model
mapping target bits/frame to QP (SURVEY.md §7.3 hard part #6).

Structure (the internal CBR logic the reference's encoders carried):
  - I/P bit allocation: the GOP budget splits as one I share of
    `ratio` P shares (ratio tracked by EMA of observed I/P sizes), so
    an IDR's natural size doesn't read as overshoot;
  - proportional term: damped 6*log2(produced/target) — the quantizer
    step doubles every 6 QP, so this is the model-exact correction;
  - integral term: a virtual buffer of accumulated surplus/deficit
    (VBV analog, capped at half a second) leaks back into QP so the
    delivered *average* converges on the target even when individual
    frames miss.

Deliberately clock-free and stateful so it can be trace-tested
(tests/test_rate_accuracy.py drives the full encoder through it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

MIN_QP = 10
MAX_QP = 51


@dataclass
class QpRateController:
    fps: float = 30.0
    gop: int = 60
    qp: float = 32.0
    min_qp: int = MIN_QP
    max_qp: int = MAX_QP
    gain: float = 2.5        # damping of the 6*log2 correction
    max_step: float = 3.0    # max QP slew per frame
    ratio: float = 4.0       # EMA of I-frame / P-frame size
    buf_bits: float = 0.0    # virtual buffer: + = overshoot so far
    _last_p_bits: float = field(default=0.0, repr=False)

    def target_bits(self, bitrate_bps: int,
                    keyframe: bool = False) -> float:
        """Per-frame bit target under the I/P split: a GOP carries one
        I share of `ratio` P shares."""
        per_gop = bitrate_bps / self.fps * self.gop
        t_p = per_gop / (self.gop - 1 + self.ratio)
        return max(1.0, t_p * self.ratio if keyframe else t_p)

    def update(self, bitrate_bps: int, produced_bits: int,
               keyframe: bool = False) -> int:
        """Account one encoded frame; returns the QP for the next."""
        target = self.target_bits(bitrate_bps, keyframe)
        if keyframe:
            if self._last_p_bits > 0:
                obs = produced_bits / self._last_p_bits
                self.ratio += 0.25 * (min(max(obs, 1.0), 16.0)
                                      - self.ratio)
        else:
            self._last_p_bits = (produced_bits
                                 if self._last_p_bits == 0 else
                                 self._last_p_bits + 0.2 *
                                 (produced_bits - self._last_p_bits))

        # virtual buffer (VBV analog): cap at +-0.5 s worth of bits
        cap = max(1.0, bitrate_bps * 0.5)
        self.buf_bits = min(cap, max(-cap, self.buf_bits
                                     + produced_bits - target))

        err = 6.0 * math.log2(max(produced_bits, 1) / target)
        pressure = 2.0 * self.buf_bits / cap
        step = max(-self.max_step,
                   min(self.max_step, err / self.gain + pressure))
        self.qp = min(float(self.max_qp), max(float(self.min_qp),
                                              self.qp + step))
        return self.current_qp

    @property
    def current_qp(self) -> int:
        return int(round(self.qp))
