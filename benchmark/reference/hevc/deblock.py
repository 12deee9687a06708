"""HEVC in-loop deblocking filter (spec 8.7.2) — numpy reference.

Operating point of the row-slice encoders: CTB == CU == PU == TU ==
16x16, so the only filterable edges are the 16-aligned block
boundaries (the interior 8-aligned positions of the deblock grid never
coincide with a TU/PU edge). Boundary strength is constant along each
CTB edge because all inputs (intra flag, cbf, MV) are per-CTB.

The whole filter is a frame-level post-pass: HEVC intra prediction
references *unfiltered* samples, so the in-frame coding loop is
untouched; the filtered picture becomes the MC reference for the next
frame and the decoder's output (verified bit-exact by the oracle
tests). Vertical edges filter first over the full picture, then
horizontal edges operate on the vertically-filtered samples
(spec 8.7.2.1).

The device implementation in ops/h265.py must match this module bit
for bit. Replaces the in-loop filter of the reference's external HEVC
encoders (reference: pipeline/ *h265*; SURVEY.md §2.2).

Frozen copy of ceracoder_tpu_torch/codec/h265/deblock.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc.tables import CHROMA_SCALE

CTB = 16

# Table 8-12 (8-bit: beta = beta', tc = tc')
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                52, 54, 56, 58, 60, 62, 64], np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
                4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                22, 24], np.int32)


def edge_bs(is_intra: np.ndarray, cbf_l: np.ndarray, mv: np.ndarray):
    """Boundary strengths for vertical and horizontal CTB edges
    (spec 8.7.2.4). Returns (bs_v (nch, ncw-1), bs_h (nch-1, ncw)).

    bs = 2 if either side intra; 1 if either side has nonzero luma
    coefficients or any MV component differs by >= 4 quarter samples;
    else 0. P slices: one reference, one MV per side.
    """
    def pair_bs(ia, ib, ca, cb, ma, mb):
        two = ia | ib
        diff = (np.abs(ma - mb) >= 4).any(-1)
        one = ca | cb | diff
        return np.where(two, 2, np.where(one, 1, 0)).astype(np.int32)

    bs_v = pair_bs(is_intra[:, :-1], is_intra[:, 1:],
                   cbf_l[:, :-1], cbf_l[:, 1:], mv[:, :-1], mv[:, 1:])
    bs_h = pair_bs(is_intra[:-1, :], is_intra[1:, :],
                   cbf_l[:-1, :], cbf_l[1:, :], mv[:-1, :], mv[1:, :])
    return bs_v, bs_h


def _filter_luma_lines(p: np.ndarray, q: np.ndarray, bs: np.ndarray,
                       qp: int):
    """Filter luma across one edge for a batch of lines.

    p: (N, 4) samples p3..p0 (p[:, 3] adjacent to the edge),
    q: (N, 4) samples q0..q3. bs: (N,) per line (0 disables). Lines
    come in groups of 4 (the decision unit). Returns filtered (p, q).
    """
    n = p.shape[0]
    p = p.astype(np.int32)
    q = q.astype(np.int32)
    beta = int(BETA_TABLE[min(max(qp, 0), 51)])
    p3, p2, p1, p0 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

    tc_all = TC_TABLE[np.clip(qp + 2 * (bs - 1), 0, 53)]
    tc_all = np.where(bs > 0, tc_all, 0)

    dp = np.abs(p[:, 1] - 2 * p[:, 2] + p[:, 3])     # |p2 - 2p1 + p0|
    dq = np.abs(q[:, 2] - 2 * q[:, 1] + q[:, 0])     # |q2 - 2q1 + q0|

    g = n // 4
    dp0 = dp[0::4]
    dp3 = dp[3::4]
    dq0 = dq[0::4]
    dq3 = dq[3::4]
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    d = dpq0 + dpq3
    tc_g = tc_all[0::4]
    bs_g = bs[0::4]
    filt = (d < beta) & (bs_g > 0)

    # strong/weak decision on lines 0 and 3 (spec 8.7.2.5.3)
    def dsam(i):
        dpq = dp[i::4] + dq[i::4]
        sap = np.abs(p[i::4, 0] - p[i::4, 3])        # |p3 - p0|
        saq = np.abs(q[i::4, 0] - q[i::4, 3])        # |q0 - q3|
        spq = np.abs(p[i::4, 3] - q[i::4, 0])        # |p0 - q0|
        return ((2 * dpq < (beta >> 2))
                & (sap + saq < (beta >> 3))
                & (spq < ((5 * tc_g + 1) >> 1)))

    strong = filt & dsam(0) & dsam(3)

    # expand group decisions to lines
    filt_l = np.repeat(filt, 4)
    strong_l = np.repeat(strong, 4)
    tc = np.repeat(tc_g, 4)

    # strong filter (spec 8.7.2.5.7 eq. 8-350..8-355), clip +-2tc
    def c2(x, ref):
        return np.clip(x, ref - 2 * tc, ref + 2 * tc)

    sp0 = c2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = c2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = c2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = c2((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = c2((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = c2((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wtake = np.abs(delta) < 10 * tc
    dlt = np.clip(delta, -tc, tc)
    wp0 = np.clip(p0 + dlt, 0, 255)
    wq0 = np.clip(q0 - dlt, 0, 255)
    side_th = (beta + (beta >> 1)) >> 3
    dep = np.repeat(dp0 + dp3 < side_th, 4)
    deq = np.repeat(dq0 + dq3 < side_th, 4)
    tc2 = tc >> 1
    dp1 = np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    wp1 = np.clip(p1 + dp1, 0, 255)
    dq1 = np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wq1 = np.clip(q1 + dq1, 0, 255)

    wk = filt_l & ~strong_l & wtake
    st = filt_l & strong_l
    out_p = p.copy()
    out_q = q.copy()
    out_p[:, 3] = np.where(st, sp0, np.where(wk, wp0, p0))
    out_p[:, 2] = np.where(st, sp1, np.where(wk & dep, wp1, p1))
    out_p[:, 1] = np.where(st, sp2, p2)
    out_q[:, 0] = np.where(st, sq0, np.where(wk, wq0, q0))
    out_q[:, 1] = np.where(st, sq1, np.where(wk & deq, wq1, q1))
    out_q[:, 2] = np.where(st, sq2, q2)
    return out_p, out_q, g


def _filter_chroma_lines(p: np.ndarray, q: np.ndarray, bs: np.ndarray,
                         qp: int):
    """Chroma filter across one edge (bs == 2 only, spec 8.7.2.5.5).
    p: (N, 2) = p1, p0; q: (N, 2) = q0, q1."""
    p = p.astype(np.int32)
    q = q.astype(np.int32)
    # QpC via the chroma mapping of the average luma QP (Table 8-10)
    qpc = int(CHROMA_SCALE[min(max(qp, 0), 69)])
    tc = int(TC_TABLE[min(max(qpc + 2, 0), 53)])
    p1, p0 = p[:, 0], p[:, 1]
    q0, q1 = q[:, 0], q[:, 1]
    delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    f = bs == 2
    out_p = p.copy()
    out_q = q.copy()
    out_p[:, 1] = np.where(f, np.clip(p0 + delta, 0, 255), p0)
    out_q[:, 0] = np.where(f, np.clip(q0 - delta, 0, 255), q0)
    return out_p, out_q


def _seg_bs(ii_a, ii_b, mv_a, mv_b, nz_pair):
    """Boundary strength per 8-sample segment (spec 8.7.2.4): 2 if
    either CU intra; 1 if the adjacent TBs have nonzero coefficients
    or any MV component differs by >= 4 quarter samples; else 0.
    ii/mv are per-CU (repeated x2 to segments); nz_pair per segment."""
    ii = np.repeat(ii_a | ii_b, 2)
    mvd = np.repeat((np.abs(mv_a - mv_b) >= 4).any(-1), 2)
    return np.where(ii, 2,
                    np.where(nz_pair | mvd, 1, 0)).astype(np.int32)


def deblock_frame(rec_y, rec_u, rec_v, is_intra, cbf_l, mv, qp: int):
    """Deblock one reconstructed picture in place semantics (returns
    new arrays). Planes are CTB-aligned int arrays; is_intra/cbf_l/mv
    are the per-CTB arrays of the frame.

    Boundary strengths are per 8-sample edge segment: the intra/MV
    conditions are per CU, the nonzero-TB condition per adjacent
    transform block (one 16x16 TU per CU)."""
    y = rec_y.astype(np.int32).copy()
    u = rec_u.astype(np.int32).copy()
    v = rec_v.astype(np.int32).copy()
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    # the luma TB nonzero flag per 8x8 quadrant (2nch, 2ncw)
    nnz8 = np.repeat(np.repeat(cbf_l != 0, 2, 0), 2, 1)
    bs_v, bs_h = edge_bs(is_intra, cbf_l, mv)

    # --- vertical edges (whole picture first): CU boundaries
    for k in range(1, ncw):
        x = k * CTB
        nz = nnz8[:, 2 * k - 1] | nnz8[:, 2 * k]
        seg = _seg_bs(is_intra[:, k - 1], is_intra[:, k],
                      mv[:, k - 1], mv[:, k], nz)
        bs_col = np.repeat(seg, 8)                    # (h,)
        p, q, _ = _filter_luma_lines(y[:, x - 4:x], y[:, x:x + 4],
                                     bs_col, qp)
        y[:, x - 4:x] = p
        y[:, x:x + 4] = q
        xc = x // 2
        bs_c = np.repeat(bs_v[:, k - 1], CTB // 2)
        for plane in (u, v):
            pc, qc = _filter_chroma_lines(plane[:, xc - 2:xc],
                                          plane[:, xc:xc + 2], bs_c, qp)
            plane[:, xc - 2:xc] = pc
            plane[:, xc:xc + 2] = qc

    # --- horizontal edges on the vertically-filtered picture
    nnz8_t = nnz8.T
    for k in range(1, nch):
        yy = k * CTB
        nz = nnz8_t[:, 2 * k - 1] | nnz8_t[:, 2 * k]
        seg = _seg_bs(is_intra[k - 1, :], is_intra[k, :],
                      mv[k - 1, :], mv[k, :], nz)
        bs_row = np.repeat(seg, 8)
        p, q, _ = _filter_luma_lines(y[yy - 4:yy, :].T,
                                     y[yy:yy + 4, :].T, bs_row, qp)
        y[yy - 4:yy, :] = p.T
        y[yy:yy + 4, :] = q.T
        yc = yy // 2
        bs_c = np.repeat(bs_h[k - 1, :], CTB // 2)
        for plane in (u, v):
            pc, qc = _filter_chroma_lines(plane[yc - 2:yc, :].T,
                                          plane[yc:yc + 2, :].T,
                                          bs_c, qp)
            plane[yc - 2:yc, :] = pc.T
            plane[yc:yc + 2, :] = qc.T

    return y, u, v
