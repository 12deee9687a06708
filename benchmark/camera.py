"""The seeded camera: a handheld IRL feed made on the device.

Frame i is a function of (seed, i) alone, in integer arithmetic only, so
that the card and the CPU make the same bytes: the reference makes the
frames again on the CPU. What the traffic file fixes sets the statistics
(texture spectrum, pan speed, shake, objects, noise); the seed sets only
phases, directions and placements, so that every seed asks the encoder
for about the same bits.

- A band-limited texture on a torus of the picture's size: per octave,
  hashed white noise under two passes of a circular box blur, scaled to a
  fixed standard deviation, summed about mid-grey. Chroma has textures of
  its own at half size.
- A pan at a fixed speed in 1/16 pel per frame, in a direction drawn from
  the seed, plus a hand shake (a triangle wave in each axis): bilinear
  sampling at sub-pel positions.
- A few discs that carry their own patch of texture and bounce across the
  picture at whole-pel speeds.
- Sensor noise: a triangular distribution of fixed width, hashed from
  (seed, i, y, x).
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
HASH_MUL = 0x45D9F3B
# 16 pan directions, (cos, sin) * 256
DIRS = [(round(256 * math.cos(k * math.pi / 8)),
         round(256 * math.sin(k * math.pi / 8))) for k in range(16)]
# keeps every sampling position positive before the wrap
FAR = 1 << 24


def mix32(*vals: int) -> int:
    """A 32-bit hash of Python integers of any size (seeds go past 2**31)."""
    h = 0x9E3779B9
    for v in vals:
        v &= (1 << 64) - 1
        for part in (v & M32, v >> 32):
            h = ((h ^ part) * 0x01000193) & M32
            h ^= h >> 15
            h = (h * 0x2C1B3C6D) & M32
            h ^= h >> 12
    return h


def _hash_plane(key: int, h: int, w: int, device) -> torch.Tensor:
    """(h, w) int64 hash values in [0, 2**32) from a 32-bit key."""
    k = (torch.arange(h, device=device, dtype=torch.int64)[:, None] * w
         + torch.arange(w, device=device, dtype=torch.int64)[None, :])
    x = k ^ key
    x = ((x >> 16) ^ x) * HASH_MUL & M32
    x = ((x >> 16) ^ x) * HASH_MUL & M32
    return (x >> 16) ^ x


def _box_circular(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sum over a window of 2r+1 along `dim`, wrapping around."""
    n = x.shape[dim]
    idx = torch.arange(-r - 1, n + r, device=x.device) % n
    c = torch.cumsum(x.index_select(dim, idx), dim)
    k = 2 * r + 1
    return c.narrow(dim, k, n) - c.narrow(dim, 0, n)


def texture(key: int, h: int, w: int, octaves, device) -> torch.Tensor:
    """(h, w) int64 texture about 128: per octave (radius, sigma), white
    noise in 0..255 under two circular box blurs of radius `radius`,
    scaled to a standard deviation of `sigma` levels."""
    out = torch.full((h, w), 128, dtype=torch.int64, device=device)
    for j, (r, sigma) in enumerate(octaves):
        noise = _hash_plane(mix32(key, j), h, w, device) & 255
        s = noise
        for _ in range(2):
            s = _box_circular(_box_circular(s, r, 0), r, 1)
        k = 2 * r + 1
        # the blurred sum's mean and standard deviation, for iid
        # uniform 0..255 samples under the two passes
        k4 = k ** 4
        std = math.sqrt((256 ** 2 - 1) / 12) * (k * (2 * k * k + 1) / 3)
        norm = max(1, round(2 * std))
        out += ((2 * s - k4 * 255) * int(sigma)) // norm
    return out


def _tri(t: int, period: int, amp: int) -> int:
    """Triangle wave in [-amp, amp] of integer period."""
    t %= period
    return abs(4 * amp * t // period - 2 * amp) - amp


def _bounce(p0: int, v: int, i: int, lo: int, hi: int) -> int:
    """Position at frame i of a point that starts at p0 with speed v and
    bounces between lo and hi."""
    span = hi - lo
    if span <= 0:
        return lo
    t = (p0 - lo + v * i) % (2 * span)
    return lo + (t if t <= span else 2 * span - t)


class Camera:
    """Frames of a seeded handheld feed at `width` x `height` (4:2:0,
    uint8 planes on `device`). `params` is the traffic file's "camera"
    object; see the module docstring."""

    def __init__(self, width: int, height: int, seed: int, params: dict,
                 device="cpu"):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 needs even sizes")
        self.width, self.height = width, height
        self.seed = int(seed)
        self.device = torch.device(device)
        self.p = params
        scale = height / 1080          # the texture scales with the picture
        octs = [(max(1, round(r * scale)), s) for r, s in params["octaves"]]
        coct = [(max(1, round(r * scale / 2)), s)
                for r, s in params["chroma_octaves"]]
        key = mix32(self.seed, 1)
        self.tex_y = texture(key, height, width, octs, self.device)
        self.tex_u = texture(mix32(key, 2), height // 2, width // 2, coct,
                             self.device)
        self.tex_v = texture(mix32(key, 3), height // 2, width // 2, coct,
                             self.device)
        # per-seed phases and directions
        d = DIRS[mix32(self.seed, 4) % 16]
        speed = int(round(params["pan_q16"] * scale))
        self.v = ((speed * d[0]) // 256, (speed * d[1]) // 256)   # (x, y)
        self.o0 = (FAR + mix32(self.seed, 5) % (16 * width),
                   FAR + mix32(self.seed, 6) % (16 * height))
        self.shake = int(round(params["shake_q16"] * scale))
        self.shake_period = int(params["shake_period"])
        self.shake_ph = (mix32(self.seed, 7) % self.shake_period,
                         mix32(self.seed, 8) % self.shake_period)
        self.radius = max(2, round(params["object_radius"] * scale))
        ospeed = max(1, round(params["object_speed"] * scale))
        self.objects = []
        for j in range(int(params["objects"])):
            h = mix32(self.seed, 9, j)
            dx, dy = DIRS[h % 16]
            vx = (ospeed * dx) // 256 or 1
            vy = (ospeed * dy) // 256 or 1
            self.objects.append({
                "p0": (mix32(h, 1) % width, mix32(h, 2) % height),
                "v": (vx, vy),
                "tex": (mix32(h, 3) % width, mix32(h, 4) % height),
                "gain": int(params["object_gain"][j % len(
                    params["object_gain"])]),
            })
        self.noise = int(params["noise"])
        self._ry = torch.arange(height, device=self.device)
        self._rx = torch.arange(width, device=self.device)
        self._cy = torch.arange(height // 2, device=self.device)
        self._cx = torch.arange(width // 2, device=self.device)

    def _offset(self, i: int, div: int) -> tuple[int, int]:
        """The pan position of frame i in 1/16 pel, (x, y), in a plane
        subsampled by `div`."""
        ox = (self.o0[0] + self.v[0] * i
              + _tri(i + self.shake_ph[0], self.shake_period, self.shake))
        oy = (self.o0[1] + self.v[1] * i
              + _tri(i + self.shake_ph[1], self.shake_period, self.shake))
        return ox // div, oy // div

    @staticmethod
    def _sample(tex, rows, cols, ox: int, oy: int) -> torch.Tensor:
        th, tw = tex.shape
        fx, fy = ox & 15, oy & 15
        r0 = (rows + (oy >> 4)) % th
        c0 = (cols + (ox >> 4)) % tw
        r1, c1 = (r0 + 1) % th, (c0 + 1) % tw
        top = tex.index_select(0, r0)
        bot = tex.index_select(0, r1)
        a = top.index_select(1, c0) * (16 - fx) + top.index_select(1, c1) * fx
        b = bot.index_select(1, c0) * (16 - fx) + bot.index_select(1, c1) * fx
        return (a * (16 - fy) + b * fy + 128) >> 8

    def _objects(self, y: torch.Tensor, i: int) -> None:
        """Paste the discs of frame i into the luma plane y (int64)."""
        h, w = y.shape
        r = self.radius
        tex = self.tex_y
        th, tw = tex.shape
        for ob in self.objects:
            cx = _bounce(ob["p0"][0], ob["v"][0], i, 0, w - 1)
            cy = _bounce(ob["p0"][1], ob["v"][1], i, 0, h - 1)
            y0, y1 = max(0, cy - r), min(h, cy + r + 1)
            x0, x1 = max(0, cx - r), min(w, cx + r + 1)
            ry = self._ry[y0:y1]
            rx = self._rx[x0:x1]
            mask = ((ry[:, None] - cy) ** 2 + (rx[None, :] - cx) ** 2
                    <= r * r)
            patch = tex.index_select(0, (ry - cy + ob["tex"][1]) % th) \
                .index_select(1, (rx - cx + ob["tex"][0]) % tw)
            patch = ((patch - 128) * 3) // 2 + 128 + ob["gain"]
            y[y0:y1, x0:x1] = torch.where(mask, patch, y[y0:y1, x0:x1])

    def _noise(self, i: int, h: int, w: int, amp: int) -> torch.Tensor:
        if amp <= 0:
            return torch.zeros((h, w), dtype=torch.int64, device=self.device)
        x = _hash_plane(mix32(self.seed, 10, i, h), h, w, self.device)
        m = amp + 1
        return (x & 0xFFFF) % m - (x >> 16) % m

    def frame(self, i: int):
        """(y, u, v) uint8 planes of frame i."""
        ox, oy = self._offset(i, 1)
        y = self._sample(self.tex_y, self._ry, self._rx, ox, oy)
        self._objects(y, i)
        y = y + self._noise(i, self.height, self.width, self.noise)
        cox, coy = self._offset(i, 2)
        hc, wc = self.height // 2, self.width // 2
        camp = self.noise // 2
        u = self._sample(self.tex_u, self._cy, self._cx, cox, coy) \
            + self._noise(i + (1 << 40), hc, wc, camp)
        v = self._sample(self.tex_v, self._cy, self._cx, cox, coy) \
            + self._noise(i + (2 << 40), hc, wc, camp)
        return tuple(p.clamp_(0, 255).to(torch.uint8) for p in (y, u, v))
