"""Frame sources — replace the reference's GStreamer capture elements
(v4l2src / camlink / hdmi / test patterns; SURVEY.md §2.6).

Host sources (numpy planes), copied from ceracoder_tpu/app/source.py:
the procedural test pattern, y4m and raw yuv420p files, MB padding and
a capture-timestamp wrapper. The device source is the port's own: a
moving test pattern generated on the card, so no raw frames cross from
the host. Its planes equal the reference's: colour bars, a scrolling
gradient band, a bouncing high-contrast block, and a per-frame integer
hash texture.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Protocol

import numpy as np
import torch

from ceracoder_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF
_BAR_LUMA = np.array([235, 210, 170, 145, 106, 81, 41, 16], np.int64)
_BAR_CB = np.array([128, 16, 166, 54, 202, 90, 240, 128], np.int64)
_BAR_CR = np.array([128, 146, 16, 34, 222, 240, 110, 128], np.int64)


class FrameSource(Protocol):
    width: int
    height: int
    fps_num: int
    fps_den: int

    def frames(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (y, u, v) uint8 planes in 4:2:0."""
        ...


@dataclass
class TestPatternSource:
    """Procedural moving test pattern (colour bars + scrolling gradient
    + frame counter strip), analog of videotestsrc."""

    __test__ = False  # not a pytest class despite the name

    width: int = 1280
    height: int = 720
    fps_num: int = 30
    fps_den: int = 1
    num_frames: Optional[int] = None   # None = endless

    def frames(self):
        h, w = self.height, self.width
        yy, xx = np.mgrid[0:h, 0:w]
        bar = (xx * 8 // w)
        bar_luma = np.array([235, 210, 170, 145, 106, 81, 41, 16], np.int32)
        base_y = bar_luma[bar]
        bar_cb = np.array([128, 16, 166, 54, 202, 90, 240, 128], np.int32)
        bar_cr = np.array([128, 146, 16, 34, 222, 240, 110, 128], np.int32)
        cs = (slice(None, None, 2), slice(None, None, 2))
        i = 0
        while self.num_frames is None or i < self.num_frames:
            shift = (i * 4) % w
            y = base_y.copy()
            # scrolling gradient band in the middle third
            band = slice(h // 3, 2 * h // 3)
            y[band] = ((xx[band] + shift) * 255 // w)
            # moving block (exercises motion estimation later)
            bx = (i * 7) % (w - 64)
            by = (h * 3 // 4)
            y[by:by + 48, bx:bx + 64] = 255 if i % 2 == 0 else 16
            u = bar_cb[bar][cs].copy()
            v = bar_cr[bar][cs].copy()
            yield (y.astype(np.uint8), u.astype(np.uint8),
                   v.astype(np.uint8))
            i += 1


class DeviceTestPatternSource:
    """Moving test pattern generated on `device` (default ``cuda``;
    raises without a card unless ``device="cpu"``).

    `frame(i)` returns frame i's (y, u, v) uint8 planes on the
    device. The uint32 hash of the reference is computed in int64 and
    masked to 32 bits after every multiply.
    """

    __test__ = False

    def __init__(self, width: int = 1280, height: int = 720,
                 fps_num: int = 30, fps_den: int = 1,
                 num_frames: Optional[int] = None, texture: int = 8,
                 device=None):
        self.width, self.height = width, height
        self.fps_num, self.fps_den = fps_num, fps_den
        self.num_frames = num_frames
        self.texture = texture
        self.device = resolve_device(device)

        h, w = height, width
        dev = self.device
        self._yy = torch.arange(h, device=dev, dtype=torch.int64)[:, None]
        self._xx = torch.arange(w, device=dev, dtype=torch.int64)[None, :]
        bar = self._xx * 8 // w
        self._bars_y = torch.as_tensor(_BAR_LUMA, device=dev)[bar]
        xxc = torch.arange(w // 2, device=dev, dtype=torch.int64)[None, :]
        bar_c = (xxc * 2 * 8 // w).expand(h // 2, w // 2)
        self._u = torch.as_tensor(_BAR_CB, device=dev)[bar_c].to(torch.uint8)
        self._v = torch.as_tensor(_BAR_CR, device=dev)[bar_c].to(torch.uint8)
        # the frame-independent part of the hash
        self._hash_xy = ((self._xx * 374761393 & _M32)
                         + (self._yy * 668265263 & _M32)) & _M32

    def frame(self, i: int):
        """Device (y, u, v) planes for frame index i."""
        h, w = self.height, self.width
        yy, xx = self._yy, self._xx
        y = self._bars_y.expand(h, w)
        shift = (i * 4) % w
        band = (yy >= h // 3) & (yy < 2 * h // 3)
        y = torch.where(band, (xx + shift) * 255 // w, y)
        bx = (i * 7) % (w - 64)
        by = h * 3 // 4
        blk = (yy >= by) & (yy < by + 48) & (xx >= bx) & (xx < bx + 64)
        y = torch.where(blk, 255 if i % 2 == 0 else 16, y)
        if self.texture:
            n = (self._hash_xy + ((((i + 1) & _M32) * 2246822519) & _M32)
                 ) & _M32
            n = ((n ^ (n >> 13)) * 1274126177) & _M32
            t = ((n >> 24) & 0xFF) % (2 * self.texture + 1)
            y = (y + t - self.texture).clamp(0, 255)
        return y.to(torch.uint8), self._u, self._v

    def frames(self):
        i = 0
        while self.num_frames is None or i < self.num_frames:
            yield self.frame(i)
            i += 1


class Y4MFileSource:
    """YUV4MPEG2 file reader (4:2:0 only)."""

    def __init__(self, path: str | Path, loop: bool = False):
        self.path = Path(path)
        self.loop = loop
        with open(self.path, "rb") as f:
            header = f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        self.width = self.height = 0
        self.fps_num, self.fps_den = 30, 1
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                self.fps_num, self.fps_den = int(n), int(d)
            elif tok[0] == "C" and not tok[1:].startswith("420"):
                raise ValueError(f"unsupported chroma format {tok}")
        if not self.width or not self.height:
            raise ValueError("y4m missing dimensions")

    def frames(self):
        w, h = self.width, self.height
        fsz = w * h * 3 // 2
        while True:
            with open(self.path, "rb") as f:
                f.readline()
                while True:
                    line = f.readline()
                    if not line:
                        break
                    if not line.startswith(b"FRAME"):
                        raise ValueError("bad y4m frame marker")
                    raw = f.read(fsz)
                    if len(raw) < fsz:
                        break
                    a = np.frombuffer(raw, np.uint8)
                    yield (a[:w * h].reshape(h, w),
                           a[w * h:w * h + w * h // 4].reshape(h // 2, w // 2),
                           a[w * h + w * h // 4:].reshape(h // 2, w // 2))
            if not self.loop:
                return


class RawYuvSource:
    """Raw planar yuv420p file reader (dimensions supplied)."""

    def __init__(self, path: str | Path, width: int, height: int,
                 fps_num: int = 30, fps_den: int = 1, loop: bool = False):
        self.path = Path(path)
        self.width, self.height = width, height
        self.fps_num, self.fps_den = fps_num, fps_den
        self.loop = loop

    def frames(self):
        w, h = self.width, self.height
        fsz = w * h * 3 // 2
        while True:
            data = np.fromfile(self.path, np.uint8)
            for i in range(data.size // fsz):
                a = data[i * fsz:(i + 1) * fsz]
                yield (a[:w * h].reshape(h, w),
                       a[w * h:w * h + w * h // 4].reshape(h // 2, w // 2),
                       a[w * h + w * h // 4:].reshape(h // 2, w // 2))
            if not self.loop:
                return


def pad_to_mb(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Edge-pad planes to 16-multiple dims (SPS cropping undoes it)."""
    h, w = y.shape
    ph, pw = (-h) % 16, (-w) % 16
    if not ph and not pw:
        return y, u, v
    y = np.pad(y, ((0, ph), (0, pw)), mode="edge")
    u = np.pad(u, ((0, ph // 2), (0, pw // 2)), mode="edge")
    v = np.pad(v, ((0, ph // 2), (0, pw // 2)), mode="edge")
    return y, u, v


class JitteryCaptureSource:
    """Wrap any FrameSource with synthetic capture timestamps (90 kHz)
    carrying jitter, duplicates, and occasional backwards steps — the
    conditions the reference's ptsfixup probe exists for (reference:
    src/ceracoder.c:371-423). Exposes frames_with_pts(), the optional
    source protocol the app feeds through app.ptsfix.PtsFixup."""

    def __init__(self, inner, jitter90: int = 300, dup_every: int = 0,
                 backstep_every: int = 0, seed: int = 0):
        self.inner = inner
        self.width = inner.width
        self.height = inner.height
        self.fps_num = inner.fps_num
        self.fps_den = inner.fps_den
        self.jitter90 = jitter90
        self.dup_every = dup_every
        self.backstep_every = backstep_every
        self.seed = seed

    def frames(self):
        for f, _ in self.frames_with_pts():
            yield f

    def frames_with_pts(self):
        rng = np.random.default_rng(self.seed)
        period = 90000 * self.fps_den / max(1, self.fps_num)
        t = 0.0
        i = 0
        for f in self.inner.frames():
            i += 1
            t += period
            pts = int(t) + int(rng.integers(-self.jitter90,
                                            self.jitter90 + 1))
            if self.backstep_every and i % self.backstep_every == 0:
                pts -= int(2 * self.jitter90 + period)
            yield f, pts
            if self.dup_every and i % self.dup_every == 0:
                yield f, pts            # duplicate frame, same pts
