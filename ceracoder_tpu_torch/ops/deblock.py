"""In-loop deblocking filter (H.264 spec 8.7; torch).

Port of ceracoder_tpu/ops/deblock.py. Slice-per-MB-row with
``disable_deblocking_filter_idc == 2``: rows are independent, so each MB
column is one batched step over all MB rows, and the columns run as a
Python loop with a 4-column carry implementing the spec's macroblock
raster order (a vertical MB-boundary edge filters the left MB's columns
AFTER that MB's own horizontal edges; the carry hands those columns
forward and the finalized values are written back into the left MB).

That loop is `deblock_frame_rows_ref`, the plain version of K2
(csrc/h264_deblock.cu: one CTA per MB row with the columns looped
inside and the carry in shared memory). `h264_deblock_rows` launches K2
on a CUDA tensor and runs the loop on a CPU tensor; `compute_bs` stays
in torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceracoder_tpu_torch.utils.device import check_kernel_args

# spec table 8-16 (indexed by indexA / indexB = clipped QP here)
ALPHA = np.array([0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20,
                             22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71,
                             80, 90, 101, 113, 127, 144, 162, 182, 203,
                             226, 255, 255], np.int32)
BETA = np.array([0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8,
                            8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
                            14, 15, 15, 16, 16, 17, 17, 18, 18], np.int32)
# spec table 8-17: tc0 for bS = 1, 2, 3 (rows = indexA 0..51)
TC0 = np.array(
    [[0, 0, 0]] * 17
    + [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
       [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
       [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
       [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
       [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
       [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
       [13, 17, 25]], np.int32)


@functools.lru_cache(maxsize=None)
def _tc0_table(device: torch.device) -> torch.Tensor:
    """TC0 on `device`, uploaded once (so the plain loop makes no host
    copy and can be captured in a CUDA graph)."""
    return torch.as_tensor(TC0, device=device)


def _clip255(x):
    return x.clamp(0, 255)


def _tc0(tc0_row, bs):
    """tc0 for each sample's bS (clipped to 1..3)."""
    return tc0_row[bs.clamp(1, 3) - 1]


def _filter_luma_edge(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha: int,
                      beta: int, tc0_row):
    """One luma edge (spec 8.7.2.3/8.7.2.4) on per-sample tensors.
    Returns new (p2, p1, p0, q0, q1, q2)."""
    ap = (p2 - p0).abs()
    aq = (q2 - q0).abs()
    filt = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta) & (bs > 0))
    ap_b = ap < beta
    aq_b = aq < beta

    # --- bS in 1..3 (8.7.2.3)
    tc0 = _tc0(tc0_row, bs)
    tc = tc0 + ap_b.to(tc0.dtype) + aq_b.to(tc0.dtype)
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip255(p0 + delta)
    nq0 = _clip255(q0 - delta)
    avg = (p0 + q0 + 1) >> 1
    dp1 = torch.clamp((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
    np1 = p1 + torch.where(ap_b, dp1, 0)
    dq1 = torch.clamp((q2 + avg - 2 * q1) >> 1, -tc0, tc0)
    nq1 = q1 + torch.where(aq_b, dq1, 0)

    # --- bS == 4 (8.7.2.4)
    small = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap_b & small
    s4p0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s4p1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s4p2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq_b & small
    s4q0 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s4q1 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    s4q2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    out_p0 = torch.where(filt, torch.where(is4, s4p0, np0), p0)
    out_q0 = torch.where(filt, torch.where(is4, s4q0, nq0), q0)
    out_p1 = torch.where(filt, torch.where(is4, s4p1, np1), p1)
    out_q1 = torch.where(filt, torch.where(is4, s4q1, nq1), q1)
    out_p2 = torch.where(filt & is4, s4p2, p2)
    out_q2 = torch.where(filt & is4, s4q2, q2)
    return out_p2, out_p1, out_p0, out_q0, out_q1, out_q2


def _filter_chroma_edge(p1, p0, q0, q1, bs, alpha: int, beta: int, tc0_row):
    """One chroma edge: only p0/q0 change (spec 8.7.2.3/8.7.2.4)."""
    filt = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta) & (bs > 0))
    tc = _tc0(tc0_row, bs) + 1
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip255(p0 + delta)
    nq0 = _clip255(q0 - delta)
    s4p0 = (2 * p1 + p0 + q1 + 2) >> 2
    s4q0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    out_p0 = torch.where(filt, torch.where(is4, s4p0, np0), p0)
    out_q0 = torch.where(filt, torch.where(is4, s4q0, nq0), q0)
    return out_p0, out_q0


def _deblock_mb_luma(cols, bs_v, bs_h, alpha, beta, tc0_row):
    """One column of 16x16 luma MBs, in place on cols (R, 16, 20):
    columns 0..3 are the left MB's columns 12..15 (already horizontally
    filtered), 4..19 this MB. Vertical edges (incl. the left boundary)
    then internal horizontal edges. bs_v (R,4,4), bs_h (R,3,4)."""
    for e in range(4):
        x = 4 + 4 * e
        bs = bs_v[:, e].repeat_interleave(4, dim=-1)
        args = [cols[:, :, x - 4 + k] for k in range(8)]
        new = _filter_luma_edge(*args, bs, alpha, beta, tc0_row)
        cols[:, :, x - 3:x + 3] = torch.stack(new, dim=-1)
    for e in range(3):
        y = 4 * (e + 1)
        bs = bs_h[:, e].repeat_interleave(4, dim=-1)
        args = [cols[:, y - 4 + k, 4:] for k in range(8)]
        new = _filter_luma_edge(*args, bs, alpha, beta, tc0_row)
        cols[:, y - 3:y + 3, 4:] = torch.stack(new, dim=1)


def _deblock_mb_chroma(cols, bs_v, bs_h, alpha, beta, tc0_row):
    """One column of 8x8 chroma MB components, in place on cols
    (R, 8, 10) (columns 0..1 = left MB's columns 6, 7). Chroma edges take
    the bS of the co-located luma edge (chroma x=0 -> luma x=0, x=4 ->
    luma x=8; chroma sample row r -> luma segment r//2)."""
    for e, luma_e in ((0, 0), (1, 2)):
        x = 2 + 4 * e
        bs = bs_v[:, luma_e].repeat_interleave(2, dim=-1)
        np0, nq0 = _filter_chroma_edge(cols[:, :, x - 2], cols[:, :, x - 1],
                                       cols[:, :, x], cols[:, :, x + 1],
                                       bs, alpha, beta, tc0_row)
        cols[:, :, x - 1] = np0
        cols[:, :, x] = nq0
    # internal horizontal edge at chroma y=4 (luma y=8 -> bs_h index 1)
    bs = bs_h[:, 1].repeat_interleave(2, dim=-1)
    np0, nq0 = _filter_chroma_edge(cols[:, 2, 2:], cols[:, 3, 2:],
                                   cols[:, 4, 2:], cols[:, 5, 2:],
                                   bs, alpha, beta, tc0_row)
    cols[:, 3, 2:] = np0
    cols[:, 4, 2:] = nq0


def compute_bs(nnz44, mv_q, intra_frame: bool, intra_mb=None):
    """Boundary strengths (spec 8.7.2.1) for the slice-row schedule.

    nnz44: (mbh, mbw, 4, 4) nonzero-coefficient flags per luma 4x4.
    mv_q: (mbh, mbw, 2) quarter-pel MVs (ignored for intra frames).
    intra_mb: optional (mbh, mbw) bool — Intra_16x16 MBs inside a P
    frame (intra-in-P): their MB-boundary edges get bS 4 and internal
    edges bS 3 regardless of the inter-side rules.
    Returns (bs_v (mbh, mbw, 4, 4), bs_h (mbh, mbw, 3, 4)) int32.
    """
    mbh, mbw = nnz44.shape[:2]
    dev = nnz44.device
    if intra_frame:
        bs_v = torch.full((mbh, mbw, 4, 4), 3, dtype=torch.int32, device=dev)
        bs_v[:, :, 0, :] = 4
        bs_v[:, 0, 0, :] = 0          # picture-left boundary: never filtered
        bs_h = torch.full((mbh, mbw, 3, 4), 3, dtype=torch.int32, device=dev)
        return bs_v, bs_h

    nz = (nnz44 > 0).to(torch.int32)
    bs_v = torch.zeros((mbh, mbw, 4, 4), dtype=torch.int32, device=dev)
    for e in range(1, 4):
        bs_v[:, :, e, :] = 2 * (nz[:, :, :, e - 1] | nz[:, :, :, e])
    nz_left = torch.roll(nz, 1, dims=1)
    mv_left = torch.roll(mv_q, 1, dims=1)
    mvdiff = ((mv_q - mv_left).abs() >= 4).any(-1)
    pair0 = nz_left[:, :, :, 3] | nz[:, :, :, 0]
    bs0 = torch.where(pair0 > 0, 2, torch.where(mvdiff[..., None], 1, 0))
    bs_v[:, :, 0, :] = bs0.to(torch.int32)

    bs_h = torch.zeros((mbh, mbw, 3, 4), dtype=torch.int32, device=dev)
    for e in range(1, 4):
        bs_h[:, :, e - 1, :] = 2 * (nz[:, :, e - 1, :] | nz[:, :, e, :])

    if intra_mb is not None:
        ii = intra_mb.to(torch.bool)
        il = torch.roll(ii, 1, dims=1)
        il[:, 0] = False
        # MB-boundary vertical edge: either side intra -> 4
        bs_v[:, :, 0, :] = torch.where((ii | il)[..., None], 4,
                                       bs_v[:, :, 0, :])
        # internal edges of an intra MB -> 3
        bs_v[:, :, 1:, :] = torch.where(ii[..., None, None], 3,
                                        bs_v[:, :, 1:, :])
        bs_h = torch.where(ii[..., None, None], 3, bs_h)
    bs_v[:, 0, 0, :] = 0              # picture-left boundary: never filtered
    return bs_v, bs_h


def deblock_frame_rows(y, u, v, nnz44, mv_q, qp: int, qp_c: int,
                       intra_frame: bool, intra_mb=None):
    """Deblock a reconstructed frame under the slice-row schedule.
    Planes uint8; returns the filtered (y, u, v) uint8 planes.
    intra_mb: optional (mbh, mbw) bool mask of Intra_16x16 MBs in a P
    frame (see compute_bs). The bS come from `compute_bs`; the filter
    runs in `h264_deblock_rows` (K2 on a card)."""
    bs_v, bs_h = compute_bs(nnz44, mv_q, intra_frame, intra_mb)
    return h264_deblock_rows(y.contiguous(), u.contiguous(), v.contiguous(),
                             bs_v, bs_h, min(max(int(qp), 0), 51),
                             min(max(int(qp_c), 0), 51))


def deblock_frame_rows_ref(y, u, v, bs_v, bs_h, qp: int, qp_c: int):
    """Plain PyTorch version of K2: the column loop, batched over MB
    rows. y (H, W), u, v (H/2, W/2) uint8; bs_v (mbh, mbw, 4, 4) and
    bs_h (mbh, mbw, 3, 4) int32; qp, qp_c in 0..51. Returns the filtered
    (y, u, v) uint8 planes."""
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    dev = y.device
    alpha, beta = int(ALPHA[qp]), int(BETA[qp])
    alpha_c, beta_c = int(ALPHA[qp_c]), int(BETA[qp_c])
    tc0_row = _tc0_table(dev)[qp]
    tc0_row_c = _tc0_table(dev)[qp_c]

    ymb = y.to(torch.int32).reshape(mbh, 16, mbw, 16).transpose(1, 2)
    umb = u.to(torch.int32).reshape(mbh, 8, mbw, 8).transpose(1, 2)
    vmb = v.to(torch.int32).reshape(mbh, 8, mbw, 8).transpose(1, 2)
    out_y = torch.empty((mbh, mbw, 16, 16), dtype=torch.int32, device=dev)
    out_u = torch.empty((mbh, mbw, 8, 8), dtype=torch.int32, device=dev)
    out_v = torch.empty((mbh, mbw, 8, 8), dtype=torch.int32, device=dev)

    cy = torch.zeros((mbh, 16, 20), dtype=torch.int32, device=dev)
    cu = torch.zeros((mbh, 8, 10), dtype=torch.int32, device=dev)
    cv = torch.zeros((mbh, 8, 10), dtype=torch.int32, device=dev)
    for c in range(mbw):
        cy[:, :, 4:] = ymb[:, c]
        cu[:, :, 2:] = umb[:, c]
        cv[:, :, 2:] = vmb[:, c]
        _deblock_mb_luma(cy, bs_v[:, c], bs_h[:, c], alpha, beta, tc0_row)
        _deblock_mb_chroma(cu, bs_v[:, c], bs_h[:, c], alpha_c, beta_c,
                           tc0_row_c)
        _deblock_mb_chroma(cv, bs_v[:, c], bs_h[:, c], alpha_c, beta_c,
                           tc0_row_c)
        if c > 0:                     # finalize the left MB's right cols
            out_y[:, c - 1, :, 13:] = cy[:, :, 1:4]
            out_u[:, c - 1, :, 7:] = cu[:, :, 1:2]
            out_v[:, c - 1, :, 7:] = cv[:, :, 1:2]
        out_y[:, c] = cy[:, :, 4:]
        out_u[:, c] = cu[:, :, 2:]
        out_v[:, c] = cv[:, :, 2:]
        # carry: this MB's last columns become the next MB's left apron
        cy[:, :, :4] = cy[:, :, 16:]
        cu[:, :, :2] = cu[:, :, 8:]
        cv[:, :, :2] = cv[:, :, 8:]

    def plane(x, mb):
        return (x.transpose(1, 2).reshape(mbh * mb, mbw * mb)
                .clamp(0, 255).to(torch.uint8))

    return plane(out_y, 16), plane(out_u, 8), plane(out_v, 8)


def _check_deblock(y, u, v, bs_v, bs_h, qp: int, qp_c: int) -> None:
    """Raise on what K2 does not take."""
    if y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16 or y.numel() == 0:
        raise ValueError(f"h264_deblock_rows: y {tuple(y.shape)} is not "
                         "(H, W) in whole 16x16 MBs")
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    check_kernel_args("h264_deblock_rows", [
        ("y", y, torch.uint8, (h, w)),
        ("u", u, torch.uint8, (h // 2, w // 2)),
        ("v", v, torch.uint8, (h // 2, w // 2)),
        ("bs_v", bs_v, torch.int32, (mbh, mbw, 4, 4)),
        ("bs_h", bs_h, torch.int32, (mbh, mbw, 3, 4))], (qp, qp_c))


@functools.lru_cache(maxsize=None)
def _launcher():
    """K2's C entry point (built and loaded at first use)."""
    from ceracoder_tpu_torch.utils.cuda_build import load_library

    fn = load_library("h264_deblock").h264_deblock_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def h264_deblock_rows(y, u, v, bs_v, bs_h, qp: int, qp_c: int):
    """The deblocking filter of a frame for given bS (K2).

    On a CUDA tensor this launches the kernel of csrc/h264_deblock.cu
    (one CTA per MB row, the MB columns in a loop) on the current
    stream, or raises; on a CPU tensor it runs `deblock_frame_rows_ref`.
    `h264_deblock_rows.launches` counts kernel launches."""
    qp, qp_c = int(qp), int(qp_c)
    _check_deblock(y, u, v, bs_v, bs_h, qp, qp_c)
    if y.device.type == "cpu":
        return deblock_frame_rows_ref(y, u, v, bs_v, bs_h, qp, qp_c)
    if y.device.type != "cuda":
        raise ValueError(f"h264_deblock_rows: unsupported device {y.device}")
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    out = (torch.empty_like(y), torch.empty_like(u), torch.empty_like(v))
    launch = _launcher()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = launch(y.data_ptr(), u.data_ptr(), v.data_ptr(),
                     bs_v.data_ptr(), bs_h.data_ptr(),
                     *(o.data_ptr() for o in out), mbh, mbw,
                     int(ALPHA[qp]), int(BETA[qp]), *map(int, TC0[qp]),
                     int(ALPHA[qp_c]), int(BETA[qp_c]),
                     *map(int, TC0[qp_c]), stream)
    if err != 0:
        raise RuntimeError(f"h264_deblock_rows kernel launch failed: CUDA "
                           f"error {err}")
    h264_deblock_rows.launches += 1
    return out


h264_deblock_rows.launches = 0
