"""H.264 integer transforms and quantization (spec 8.5; torch, batched).

Port of ceracoder_tpu/ops/transform.py. Every function works on batches
of 4x4 blocks, shape (..., 4, 4), in int32 with add/shift butterflies,
so results are bit-exact (int32 wraps the same way as the reference).
`qp` arguments are host ints: the port dispatches per frame, so QP
changes need no recompilation to stay on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Position classes for quant tables: 0 = (0,0),(0,2),(2,0),(2,2);
# 1 = (1,1),(1,3),(3,1),(3,3); 2 = the rest.
_POS_CLASS = np.array([[0, 2, 0, 2],
                       [2, 1, 2, 1],
                       [0, 2, 0, 2],
                       [2, 1, 2, 1]], dtype=np.int32)

# Encoder quant multipliers MF[qp%6][class]
_MF_CLASS = np.array([[13107, 5243, 8066],
                      [11916, 4660, 7490],
                      [10082, 4194, 6554],
                      [9362, 3647, 5825],
                      [8192, 3355, 5243],
                      [7282, 2893, 4559]], dtype=np.int32)

# Decoder dequant scale V[qp%6][class] (spec normAdjust4x4)
_V_CLASS = np.array([[10, 16, 13],
                     [11, 18, 14],
                     [13, 20, 16],
                     [14, 23, 18],
                     [16, 25, 20],
                     [18, 29, 23]], dtype=np.int32)

MF = _MF_CLASS[:, _POS_CLASS]          # (6, 4, 4)
V = _V_CLASS[:, _POS_CLASS]            # (6, 4, 4)

# Chroma QP mapping (spec table 8-15 / QPc from qPI)
_CHROMA_QP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39]),
]).astype(np.int32)

# 4x4 zigzag scan (spec 8.5.6), as flat indices into a row-major 4x4 block
ZIGZAG4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                     dtype=np.int64)
ZIGZAG4x4_INV = np.argsort(ZIGZAG4x4)       # zigzag place of each sample


def chroma_qp(qp_luma: int, offset: int = 0) -> int:
    qpi = int(np.clip(qp_luma + offset, 0, 51))
    return int(_CHROMA_QP[qpi])


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A constant table of this module on `device`, uploaded once."""
    return torch.as_tensor(globals()[name], device=device)


# ---------------------------------------------------------------------------
# Core 4x4 transform
# ---------------------------------------------------------------------------

def _fdct4_last(x: torch.Tensor) -> torch.Tensor:
    """Apply Cf along the last axis as an add/shift butterfly."""
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0, s3 = x0 + x3, x0 - x3
    s1, s2 = x1 + x2, x1 - x2
    return torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-1)


def fdct4(x: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 core transform: Cf @ X @ Cf.T (exact integer)."""
    t = _fdct4_last(_i32(x).transpose(-1, -2)).transpose(-1, -2)
    return _fdct4_last(t)


def quant4(coef: torch.Tensor, qp: int, intra: bool = True) -> torch.Tensor:
    """Z = sign(W) * ((|W| * MF[qp%6] + f) >> qbits), qbits = 15 + qp/6,
    f = (1<<qbits)/3 intra, /6 inter (JM convention)."""
    qbits = 15 + qp // 6
    mf = _table("MF", coef.device)[qp % 6]
    f = (1 << qbits) // (3 if intra else 6)
    w = _i32(coef)
    mag = (w.abs() * mf + f) >> qbits
    return torch.sign(w) * mag


def dequant4(z: torch.Tensor, qp: int) -> torch.Tensor:
    """d = z * V[qp%6] << (qp/6) (spec 8.5.12.1, flat scaling list)."""
    v = _table("V", z.device)[qp % 6]
    return (_i32(z) * v) << (qp // 6)


def idct4(d: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 core transform with spec-exact butterflies and
    rounding (spec 8.5.12.2)."""
    d = _i32(d)
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


# ---------------------------------------------------------------------------
# Intra_16x16 luma DC path (spec 8.5.10)
# ---------------------------------------------------------------------------

def _had4_last(x: torch.Tensor) -> torch.Tensor:
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    a, b = x0 + x1, x2 + x3
    c, d = x0 - x1, x2 - x3
    return torch.stack([a + b, a - b, c - d, c + d], dim=-1)


def _had4_2d(x: torch.Tensor) -> torch.Tensor:
    """H4 @ X @ H4.T (H4 is symmetric)."""
    return _had4_last(_had4_last(_i32(x).transpose(-1, -2)).transpose(-1, -2))


def hadamard4_fwd(dc: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 Hadamard on the 16 luma DC coefficients, with the
    JM /2 scaling (floor division, as in the reference)."""
    return _had4_2d(dc) // 2


def quant_dc4(wdc: torch.Tensor, qp: int, intra: bool = True) -> torch.Tensor:
    """Quant of Hadamard-transformed luma DC: MF(0,0) and qbits+1."""
    qbits = 15 + qp // 6
    mf00 = int(_MF_CLASS[qp % 6, 0])
    f = ((1 << qbits) // (3 if intra else 6)) * 2
    w = _i32(wdc)
    mag = (w.abs() * mf00 + f) >> (qbits + 1)
    return torch.sign(w) * mag


def dequant_dc4(zdc: torch.Tensor, qp: int) -> torch.Tensor:
    """Decode-side luma DC: inverse Hadamard THEN scaling (spec 8.5.10)."""
    f = _had4_2d(zdc)
    ls = int(_V_CLASS[qp % 6, 0]) * 16
    m = qp // 6
    if m >= 6:
        return (f * ls) << (m - 6)
    return (f * ls + (1 << (5 - m))) >> (6 - m)


# ---------------------------------------------------------------------------
# Chroma DC path (spec 8.5.11), 4:2:0 — 2x2 DC per chroma component
# ---------------------------------------------------------------------------

def _had2_2d(x: torch.Tensor) -> torch.Tensor:
    x = _i32(x)
    a = x[..., 0, :] + x[..., 1, :]
    b = x[..., 0, :] - x[..., 1, :]
    return torch.stack([
        torch.stack([a[..., 0] + a[..., 1], a[..., 0] - a[..., 1]], dim=-1),
        torch.stack([b[..., 0] + b[..., 1], b[..., 0] - b[..., 1]], dim=-1),
    ], dim=-2)


def hadamard2_fwd(dc: torch.Tensor) -> torch.Tensor:
    """Forward 2x2 Hadamard on chroma DC (shape (..., 2, 2))."""
    return _had2_2d(dc)


def quant_dc2(wdc: torch.Tensor, qp: int, intra: bool = True) -> torch.Tensor:
    """Quant of 2x2 chroma DC: MF(0,0), qbits+1 (JM convention)."""
    return quant_dc4(wdc, qp, intra)


def dequant_dc2(zdc: torch.Tensor, qp: int) -> torch.Tensor:
    """dcC = ((f * LevelScale(m,0,0)) << (qp/6)) >> 5 (spec 8.5.11)."""
    f = _had2_2d(zdc)
    ls = int(_V_CLASS[qp % 6, 0]) * 16
    return ((f * ls) << (qp // 6)) >> 5


# ---------------------------------------------------------------------------
# Block (de)composition helpers
# ---------------------------------------------------------------------------

def to_blocks4(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//4, W//4, 4, 4) row-major 4x4 blocks."""
    h, w = plane.shape[-2:]
    x = plane.reshape(*plane.shape[:-2], h // 4, 4, w // 4, 4)
    return x.transpose(-3, -2)


def from_blocks4(blocks: torch.Tensor) -> torch.Tensor:
    """(..., H//4, W//4, 4, 4) -> (..., H, W)."""
    nbh, nbw = blocks.shape[-4], blocks.shape[-3]
    x = blocks.transpose(-3, -2)
    return x.reshape(*blocks.shape[:-4], nbh * 4, nbw * 4)


def zigzag_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 16) in zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 16)
    return flat[..., _table("ZIGZAG4x4", blocks.device)]


def zigzag_unscan(scanned: torch.Tensor) -> torch.Tensor:
    """(..., 16) zigzag order -> (..., 4, 4)."""
    flat = scanned[..., _table("ZIGZAG4x4_INV", scanned.device)]
    return flat.reshape(*scanned.shape[:-1], 4, 4)
