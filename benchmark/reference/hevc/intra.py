"""HEVC intra prediction, transforms, and quantization (host reference
implementation; the device formulation is ops/h265.py).

Prediction: planar / DC / horizontal(10) / vertical(26) with reference
sample substitution (spec 8.4.4.2.2), [1 2 1] smoothing (8.4.4.2.3) and
the luma DC/edge boundary filters. Transforms: HEVC core DCT matrices
(tables.T8/T16) with the spec inverse stages (8.6.4: shift 7 + clip16,
then shift 12); dequant per 8.6.3 with flat scaling (m=16). The inverse
path must match libavcodec bit-exactly — the conformance tests compare
reconstructions sample for sample.

Frozen copy of ceracoder_tpu_torch/codec/h265/intra.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc.precision import imatmul
from benchmark.reference.hevc.tables import (
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
    a = (imatmul(t, res) + (1 << (s1 - 1))) >> s1
    c = (imatmul(a, t.T) + (1 << (s2 - 1))) >> s2
    return c


def inv_transform(coef: np.ndarray) -> np.ndarray:
    """Spec 8.6.4 two-stage inverse with intermediate clip to 16 bits."""
    n = coef.shape[0]
    t = _T[n]
    a = (imatmul(t.T, coef) + 64) >> 7
    a = np.clip(a, -32768, 32767)
    r = (imatmul(a, t) + 2048) >> 12
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
