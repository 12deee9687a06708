"""HEVC intra prediction, transforms, and quantization (host reference
implementation; the device formulation is ops/h265.py).

Prediction: planar / DC / horizontal(10) / vertical(26) with reference
sample substitution (spec 8.4.4.2.2), [1 2 1] smoothing (8.4.4.2.3) and
the luma DC/edge boundary filters. Transforms: HEVC core DCT matrices
(tables.T8/T16) with the spec inverse stages (8.6.4: shift 7 + clip16,
then shift 12); dequant per 8.6.3 with flat scaling (m=16). The inverse
path must match libavcodec bit-exactly — the conformance tests compare
reconstructions sample for sample.

Copy of ceracoder_tpu/codec/h265/intra.py: the port keeps its own copy
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.h265.tables import (
    CHROMA_SCALE,
    INV_QUANT_SCALES,
    QUANT_SCALES,
    T4,
    T8,
    T16,
)

PLANAR, DC, HOR, VER = 0, 1, 10, 26
# candidate set: the classic four plus the horizontal-class angular
# modes 2..9 — positive intraPredAngle, so prediction reads only the
# left reference column (the row-slice schedule's available side).
# Order matters: SAD ties keep the earlier candidate, and the device
# op (ops/h265.py) must match it exactly.
CAND_MODES = (PLANAR, DC, HOR, VER, 2, 3, 4, 5, 6, 7, 8, 9)

# intraPredAngle for modes 2..10 (spec Table 8-5)
ANGLES = {2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0}

_T = {4: T4.astype(np.int64), 8: T8.astype(np.int64),
      16: T16.astype(np.int64)}


def chroma_qp(qp_y: int) -> int:
    return int(CHROMA_SCALE[min(max(qp_y, 0), 69)])


# ---------------------------------------------------------------------------
# reference samples
# ---------------------------------------------------------------------------

def ref_samples(recon: np.ndarray, x0: int, y0: int, n: int,
                avail_tr: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """(left[2n], top[2n], corner) with unavailable-sample substitution
    (spec 8.4.4.2.2). recon is the CTB-aligned reconstructed plane;
    below-left is never available under raster CTB order."""
    h, w = recon.shape
    have_left = x0 > 0
    have_top = y0 > 0
    have_corner = have_left and have_top
    have_tr = have_top and avail_tr and x0 + 2 * n <= w

    if not (have_left or have_top):
        full = 128
        left = np.full(2 * n, full, np.int32)
        top = np.full(2 * n, full, np.int32)
        return left, top, full

    left = np.zeros(2 * n, np.int32)
    top = np.zeros(2 * n, np.int32)
    # in substitution scan order: left bottom-up from index 2n-1 -> 0,
    # then corner, then top left -> right
    if have_left:
        left[:n] = recon[y0:y0 + n, x0 - 1]
        left[n:] = left[n - 1]        # below-left: pad from last avail
    if have_top:
        top[:n] = recon[y0 - 1, x0:x0 + n]
        if have_tr:
            top[n:] = recon[y0 - 1, x0 + n:x0 + 2 * n]
        else:
            top[n:] = top[n - 1]
    corner = (int(recon[y0 - 1, x0 - 1]) if have_corner
              else (int(top[0]) if have_top else int(left[0])))
    if not have_left:
        left[:] = corner
    if not have_top:
        top[:] = corner
    return left, top, corner


def smooth_refs(left: np.ndarray, top: np.ndarray, corner: int):
    """[1 2 1] intra reference smoothing (spec 8.4.4.2.3)."""
    n2 = left.shape[0]
    fl = left.copy()
    ft = top.copy()
    fc = (left[0] + 2 * corner + top[0] + 2) >> 2
    ext_l = np.concatenate([[corner], left])
    fl[:-1] = (ext_l[:-2] + 2 * ext_l[1:-1] + ext_l[2:] + 2) >> 2
    fl[-1] = left[-1]
    ext_t = np.concatenate([[corner], top])
    ft[:-1] = (ext_t[:-2] + 2 * ext_t[1:-1] + ext_t[2:] + 2) >> 2
    ft[-1] = top[-1]
    return fl, ft, int(fc)


def _smooth_for(mode: int, n: int, c_idx: int) -> bool:
    """Reference smoothing filterFlag (spec 8.4.4.2.3): luma only;
    DC excluded; planar always (minDistVerHor 10); angular when
    min(|mode-26|, |mode-10|) exceeds the per-size threshold
    (7 for nTbS 8, 1 for 16, 0 for 32)."""
    if c_idx != 0 or mode == DC or n < 8:
        return False
    if mode == PLANAR:
        return True
    thres = {8: 7, 16: 1, 32: 0}[n]
    return min(abs(mode - 26), abs(mode - 10)) > thres


def predict(mode: int, left: np.ndarray, top: np.ndarray, corner: int,
            n: int, c_idx: int) -> np.ndarray:
    """Intra prediction for the supported modes (spec 8.4.4.2.4-.6)."""
    luma = c_idx == 0
    if _smooth_for(mode, n, c_idx):
        left, top, corner = smooth_refs(left, top, corner)
    if 2 <= mode <= 9:
        # horizontal-class angular with positive intraPredAngle
        # (spec 8.4.4.2.6 with the x/y swap for predModeIntra < 18):
        # only the left reference participates
        a = ANGLES[mode]
        refl = np.concatenate([left, left[-1:]])     # [2n+1] guard
        xs = np.arange(n)
        idx = ((xs + 1) * a) >> 5                    # per column
        fact = ((xs + 1) * a) & 31
        ys = np.arange(n)
        i0 = ys[:, None] + idx[None, :]
        pred = ((32 - fact)[None, :] * refl[i0]
                + fact[None, :] * refl[i0 + 1] + 16) >> 5
        return pred.astype(np.int32)
    x = np.arange(n)
    y = np.arange(n)
    if mode == PLANAR:
        log2n = n.bit_length() - 1
        tr = int(top[n])              # p[nTbS][-1]
        bl = int(left[n])             # p[-1][nTbS]
        px = ((n - 1 - x)[None, :] * left[y][:, None]
              + (x + 1)[None, :] * tr
              + (n - 1 - y)[:, None] * top[x][None, :]
              + (y + 1)[:, None] * bl + n) >> (log2n + 1)
        return px.astype(np.int32)
    if mode == DC:
        dc = (int(left[:n].sum()) + int(top[:n].sum()) + n) >> (
            n.bit_length())
        out = np.full((n, n), dc, np.int32)
        if luma and n < 32:
            out[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            out[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            out[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return out
    if mode == HOR:
        out = np.repeat(left[:n][:, None], n, axis=1).astype(np.int32)
        if luma and n < 32:
            out[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1),
                                0, 255)
        return out
    if mode == VER:
        out = np.repeat(top[:n][None, :], n, axis=0).astype(np.int32)
        if luma and n < 32:
            out[:, 0] = np.clip(top[0] + ((left[:n] - corner) >> 1),
                                0, 255)
        return out
    raise ValueError(f"unsupported intra mode {mode}")


# ---------------------------------------------------------------------------
# transform / quant
# ---------------------------------------------------------------------------

def fwd_transform(res: np.ndarray) -> np.ndarray:
    n = res.shape[0]
    t = _T[n]
    log2n = n.bit_length() - 1
    s1 = log2n - 1                   # log2N + bitDepth - 9
    s2 = log2n + 6
    a = (t @ res.astype(np.int64) + (1 << (s1 - 1))) >> s1
    c = (a @ t.T + (1 << (s2 - 1))) >> s2
    return c


def inv_transform(coef: np.ndarray) -> np.ndarray:
    """Spec 8.6.4 two-stage inverse with intermediate clip to 16 bits."""
    n = coef.shape[0]
    t = _T[n]
    a = (t.T @ coef.astype(np.int64) + 64) >> 7
    a = np.clip(a, -32768, 32767)
    r = (a @ t + 2048) >> 12
    return np.clip(r, -32768, 32767)


def quantize(coef: np.ndarray, qp: int,
             intra: bool = True) -> np.ndarray:
    n = coef.shape[0]
    log2n = n.bit_length() - 1
    qbits = 21 + qp // 6 - log2n
    scale = int(QUANT_SCALES[qp % 6])
    # HM rounding offsets: 171/512 intra, 85/512 inter
    off = (171 if intra else 85) << (qbits - 9)
    level = (np.abs(coef) * scale + off) >> qbits
    return (np.sign(coef) * level).astype(np.int64)


def dequantize(level: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.6.3 with flat scaling matrix m = 16."""
    n = level.shape[0]
    log2n = n.bit_length() - 1
    bd_shift = log2n + 3             # BitDepth + log2N - 5
    scale = int(INV_QUANT_SCALES[qp % 6]) * 16
    d = (level.astype(np.int64) * (scale << (qp // 6))
         + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767)
