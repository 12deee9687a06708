"""HEVC inter prediction: motion search, motion compensation, and the
normative predictor/merge candidate derivations (host reference
implementation; the device formulation is ops/h265.py).

Scope (first lossy P stage): full-pel luma MVs over 16x16 CUs (one
PU, PART_2Nx2N), single reference (the previous picture). Chroma MVs
inherit the luma MV, which lands on 0/half-sample chroma positions —
interpolated with the normative 4-tap DCT-IF (spec 8.5.4.2.2.2,
taps tables.CHROMA_FILTER). AMVP (spec 8.5.3.2.6-7) and merge
(8.5.3.2.3) candidate lists are derived exactly as a decoder will;
with a single same-POC reference the scaling clauses collapse to
identity, which is asserted by the bit-exact oracle tests.

Replaces the ME/MC inside the reference's external HEVC encoder
elements (reference: pipeline/ *h265* pipelines; SURVEY.md §2.2).

Frozen copy of ceracoder_tpu_torch/codec/h265/inter.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc.precision import imatmul
from benchmark.reference.hevc.tables import CHROMA_FILTER, LUMA_FILTER

SEARCH_RANGE = 8          # full-pel reach around (0, 0)
COARSE_RANGE = 4          # half-res exhaustive range (covers +-8)


# ---------------------------------------------------------------------------
# Motion search (hierarchical; twin of ops/h265._motion_luma_dev's
# full-pel stages — array equality enforced by tests/test_h265_device)
# ---------------------------------------------------------------------------

def down2(x: np.ndarray) -> np.ndarray:
    """Half-resolution image: 2x2 mean with +2 >> 2 rounding."""
    x = x.astype(np.int32)
    return (x[0::2, 0::2] + x[0::2, 1::2]
            + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2


def motion_search(cur_y: np.ndarray, ref_y: np.ndarray) -> np.ndarray:
    """Hierarchical full-pel SAD search per 16x16 CU: exhaustive +-4
    at half resolution (center-outward tie order), doubled and clipped
    to +-7, then a +-1 full-pel refine in SUBPEL_OFFS order (earlier
    candidate wins ties). Returns (nch, ncw, 2) int32 full-pel MVs
    with |mv| <= 8.
    """
    h, w = cur_y.shape
    nch, ncw = h // 16, w // 16
    cur = cur_y.astype(np.int32)

    # coarse: half-res exhaustive
    cur_h = down2(cur)
    ref_h_pad = down2(np.pad(ref_y, 8, mode="edge").astype(np.int32))
    rng = COARSE_RANGE
    best_sad = np.full((nch, ncw), 1 << 30, np.int64)
    best_mv = np.zeros((nch, ncw, 2), np.int32)
    offs = sorted(((dy, dx) for dy in range(-rng, rng + 1)
                   for dx in range(-rng, rng + 1)),
                  key=lambda o: (abs(o[0]) + abs(o[1]), abs(o[0])))
    hh, hw = cur_h.shape
    for dy, dx in offs:
        shifted = ref_h_pad[rng + dy:rng + dy + hh,
                            rng + dx:rng + dx + hw]
        sad = (np.abs(cur_h - shifted)
               .reshape(nch, 8, ncw, 8).sum((1, 3), dtype=np.int64))
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best_mv[better] = (dy, dx)
    mv0 = np.clip(2 * best_mv, -7, 7)

    # +-1 full-pel refine at full resolution
    pad = SEARCH_RANGE
    ref_pad = np.pad(ref_y, pad, mode="edge").astype(np.int32)
    curb = cur.reshape(nch, 16, ncw, 16).transpose(0, 2, 1, 3)
    best_sad = np.full((nch, ncw), 1 << 30, np.int64)
    best_d = np.zeros((nch, ncw, 2), np.int32)
    for dy, dx in SUBPEL_OFFS:
        sad = np.zeros((nch, ncw), np.int64)
        for cy in range(nch):
            for cx in range(ncw):
                y0 = cy * 16 + int(mv0[cy, cx, 0]) + dy + pad
                x0 = cx * 16 + int(mv0[cy, cx, 1]) + dx + pad
                blk = ref_pad[y0:y0 + 16, x0:x0 + 16]
                sad[cy, cx] = np.abs(curb[cy, cx]
                                     - blk).sum(dtype=np.int64)
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best_d[better] = (dy, dx)
    return mv0 + best_d


# ---------------------------------------------------------------------------
# Motion compensation
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Quarter-pel motion: interpolation planes + sub-pel refinement
# ---------------------------------------------------------------------------

PLANE_PAD = SEARCH_RANGE + 1     # qpel MVs floor to -(rng+1) integer
LUMA_SRC_PAD = PLANE_PAD + 4     # 8-tap DCT-IF reaches -3..+4

# refinement candidates, fixed evaluation order (ties keep the
# earlier candidate); quarter stage uses the same pattern halved
SUBPEL_OFFS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
               (-1, -1), (-1, 1), (1, -1), (1, 1))


def luma_qpel_planes(ref_y: np.ndarray) -> np.ndarray:
    """All 16 (fy, fx) quarter-sample interpolation planes of a luma
    reference (8-tap DCT-IF, spec 8.5.4.2.2.1), edge-padded by
    PLANE_PAD. plane[fy*4+fx][y+P][x+P] is the prediction sample at
    (y + fy/4, x + fx/4); integer tap positions clip to the picture
    (== filtering the edge-padded source). The unified two-stage
    ladder ((h-sum -> v-sum) + 2048) >> 12 reproduces every spec case
    because LUMA_FILTER[0] is the 64-identity."""

    h, w = ref_y.shape
    pp = PLANE_PAD
    src = np.pad(ref_y, LUMA_SRC_PAD, mode="edge").astype(np.int64)
    wo = w + 2 * pp
    ho = h + 2 * pp
    planes = np.empty((16, ho, wo), np.int32)
    for fx in range(4):
        taps = LUMA_FILTER[fx].astype(np.int64)
        tmp = sum(int(taps[k]) * src[:, 1 + k:1 + k + wo]
                  for k in range(8))                 # (H+2sp, wo)
        for fy in range(4):
            tv = LUMA_FILTER[fy].astype(np.int64)
            acc = sum(int(tv[k]) * tmp[1 + k:1 + k + ho, :]
                      for k in range(8))
            planes[fy * 4 + fx] = np.clip((acc + 2048) >> 12, 0, 255)
    return planes


def mc_luma_qpel(planes: np.ndarray, mv_q: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    """Whole-frame luma MC from the qpel planes; mv_q (nch, ncw, 2)
    per-CU quarter-pel MVs."""
    n = 16
    dyi = np.repeat(np.repeat(mv_q[..., 0] >> 2, n, 0), n, 1)
    dxi = np.repeat(np.repeat(mv_q[..., 1] >> 2, n, 0), n, 1)
    sel = (np.repeat(np.repeat(mv_q[..., 0] & 3, n, 0), n, 1) * 4
           + np.repeat(np.repeat(mv_q[..., 1] & 3, n, 0), n, 1))
    ri = np.arange(h)[:, None] + dyi + PLANE_PAD
    ci = np.arange(w)[None, :] + dxi + PLANE_PAD
    return planes[sel, ri, ci].astype(np.int32)


def mc_chroma_qpel(ref_c: np.ndarray, mv_q: np.ndarray,
                   hc: int, wc: int) -> np.ndarray:
    """Whole-frame chroma MC for arbitrary luma qpel MVs (chroma
    eighth-sample, spec 8.5.4.2.2.2): 4x4 tap window with per-CU
    fraction weights over the edge-padded plane. The unified
    ((h -> v) + 2048) >> 12 ladder covers all 64 fraction combos
    (CHROMA_FILTER[0] is the 64-identity)."""
    n = 8
    pad = SEARCH_RANGE // 2 + 2
    p = np.pad(ref_c, pad, mode="edge").astype(np.int64)
    dyi = np.repeat(np.repeat(mv_q[..., 0] >> 3, n, 0), n, 1)
    dxi = np.repeat(np.repeat(mv_q[..., 1] >> 3, n, 0), n, 1)
    fy = np.repeat(np.repeat(mv_q[..., 0] & 7, n, 0), n, 1)
    fx = np.repeat(np.repeat(mv_q[..., 1] & 7, n, 0), n, 1)
    ty = CHROMA_FILTER[fy].astype(np.int64)         # (hc, wc, 4)
    tx = CHROMA_FILTER[fx].astype(np.int64)
    ri = np.arange(hc)[:, None] + dyi + pad
    ci = np.arange(wc)[None, :] + dxi + pad
    acc = np.zeros((hc, wc), np.int64)
    for k in range(4):
        tmp = np.zeros((hc, wc), np.int64)
        for l in range(4):                          # noqa: E741
            tmp += tx[..., l] * p[ri - 1 + k, ci - 1 + l]
        acc += ty[..., k] * tmp
    return np.clip((acc + 2048) >> 12, 0, 255).astype(np.int32)


def satd8_frame(diff: np.ndarray) -> np.ndarray:
    """Sum of 8x8 Hadamard-transformed absolute differences per 16x16
    CU. diff: (H, W) int. The cost metric for sub-pel refinement
    (SAD cannot rank the low-pass fractional-sample positions)."""
    h, w = diff.shape
    d = diff.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    d = d.astype(np.int64)
    t = imatmul(imatmul(_H8, d), _H8)
    s8 = np.abs(t).sum((-1, -2)) >> 2          # (h/8, w/8)
    return s8.reshape(h // 16, 2, w // 16, 2).sum((1, 3))


def satd8_block(diff: np.ndarray) -> int:
    """8x8 Hadamard SATD of one square residual block (side a
    multiple of 16)."""
    return int(satd8_frame(np.asarray(diff)).sum())


def _hadamard8() -> np.ndarray:
    hm = np.array([[1]])
    while hm.shape[0] < 8:
        hm = np.block([[hm, hm], [hm, -hm]])
    return hm


_H8 = _hadamard8()


def refine_subpel(cur_y: np.ndarray, planes: np.ndarray,
                  mv_full: np.ndarray) -> np.ndarray:
    """Half- then quarter-pel SATD refinement around the full-pel
    winner. Candidate order is SUBPEL_OFFS (scaled by the step);
    strictly-better cost wins, ties keep the earlier candidate.
    Returns (nch, ncw, 2) qpel MVs."""
    h, w = cur_y.shape
    nch, ncw = h // 16, w // 16
    cur = cur_y.astype(np.int64)
    mv_q = mv_full.astype(np.int32) * 4
    for step in (2, 1):
        # quarter step refines over the plus shape only (first 5
        # offsets); diagonals buy <0.05 dB after the 9-way half-pel
        # stage but cost 80% more SATD work on the device twin.
        # (Narrowing the HALF step too costs >2 dB on panning
        # content — measured, do not.)
        offs = SUBPEL_OFFS if step == 2 else SUBPEL_OFFS[:5]
        best_cost = np.full((nch, ncw), 1 << 60, np.int64)
        best_mv = mv_q.copy()
        for dy, dx in offs:
            cand = mv_q + np.array([dy * step, dx * step], np.int32)
            pred = mc_luma_qpel(planes, cand, h, w)
            cost = satd8_frame(cur - pred)
            better = cost < best_cost
            best_cost = np.where(better, cost, best_cost)
            best_mv = np.where(better[..., None], cand, best_mv)
        mv_q = best_mv
    return mv_q


# ---------------------------------------------------------------------------
# Normative candidate derivations (CTB == CU == one 2Nx2N PU)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# MVD syntax (spec 7.3.8.9, binarization 9.3.3)
# ---------------------------------------------------------------------------

def encode_mvd(enc, ctx, off, mvd_x: int, mvd_y: int) -> None:
    """mvd_coding: greater0/greater1 context bins, EG1 remainder and
    sign as bypass. Component order in the stream is x then y — note
    the framework's (dy, dx) convention is flipped at this boundary."""
    comps = (mvd_x, mvd_y)
    gr0 = [1 if c != 0 else 0 for c in comps]
    gr1 = [1 if abs(c) > 1 else 0 for c in comps]
    enc.encode_bin(ctx, off["mvd_gr"] + 0, gr0[0])
    enc.encode_bin(ctx, off["mvd_gr"] + 0, gr0[1])
    if gr0[0]:
        enc.encode_bin(ctx, off["mvd_gr"] + 1, gr1[0])
    if gr0[1]:
        enc.encode_bin(ctx, off["mvd_gr"] + 1, gr1[1])
    for c, g0, g1 in zip(comps, gr0, gr1):
        if not g0:
            continue
        if g1:
            _encode_eg1(enc, abs(c) - 2)
        enc.encode_bypass(1 if c < 0 else 0)


def _encode_eg1(enc, value: int) -> None:
    """1st-order Exp-Golomb, bypass bins (spec 9.3.3.3)."""
    k = 1
    while value >= (1 << k):
        enc.encode_bypass(1)
        value -= 1 << k
        k += 1
    enc.encode_bypass(0)
    for b in range(k - 1, -1, -1):
        enc.encode_bypass((value >> b) & 1)
