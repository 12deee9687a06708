"""Inter-frame (P) encoding compute path (torch): motion estimation,
motion compensation and residual coding.

Port of ceracoder_tpu/ops/inter.py. P_L0_16x16, one reference (the
previous recon),
quarter-pel MVs from a coarse search on 4x-pooled planes, a full-pel
refine, and a 49-way sub-pel stage over the spec's half/quarter-sample
planes (spec 8.4.2.2.1); chroma by the spec's eighth-pel bilinear
(8.4.2.2.2). The dense select-warps of the reference are kept as they
are: they give the same candidate order, so `argmin` ties (first
minimum, as in jnp) resolve identically.

With `intra_in_p=True` (the CABAC path's default) P frames also carry
Intra_16x16 fallback MBs (`_intra_fallback`). The JAX package enters
the fallback's column scan only when the frame has an intra MB
(`lax.cond`); torch has no branch on the device, and asking the host
(`bool(is_intra.any())`) would wait for the frame's motion search in
the middle of a run's launches. Every result of the scan is masked by
`is_intra`, so running it always gives the same outputs: the port
always runs it, one launch of K3 (`ops/intra.py:h264_intra16_cols`) per
P frame on a card, and never synchronizes.

The legacy motion helpers (`motion_search_fullpel`, `half_pel_planes`,
`mc_luma_qpel`, `halfpel_refine`, `mc_chroma`) are plain torch: the JAX
package's first per-MB search and half-pel MC, which no encoder path
calls any more. Their windows are taken where `jax.lax.dynamic_slice`
takes them: a negative start counts from the end of its axis, and a
start is clamped to keep the window inside its array.
"""

from __future__ import annotations

import torch

from ceracoder_tpu_torch.ops.intra import h264_intra16_cols
from ceracoder_tpu_torch.ops.transform import (
    dequant4,
    dequant_dc2,
    fdct4,
    from_blocks4,
    hadamard2_fwd,
    idct4,
    quant4,
    quant_dc2,
    to_blocks4,
    zigzag_scan,
)

COARSE_RANGE = 4          # +-4 on the 4x pyramid = +-16 full-pel
REFINE_RANGE = 3          # full-pel refine around the coarse winner


def _mb_view(plane, mb=16):
    h, w = plane.shape
    return plane.reshape(h // mb, mb, w // mb, mb).transpose(1, 2)


def pad_edge(x, m: int):
    """Edge-replicate the last two dims by m on every side (jnp.pad
    mode="edge"), by index clamping so any dtype works."""
    h, w = x.shape[-2:]
    iy = torch.arange(-m, h + m, device=x.device).clamp(0, h - 1)
    ix = torch.arange(-m, w + m, device=x.device).clamp(0, w - 1)
    return x[..., iy, :][..., ix]


def tile_apron(plane, mb: int, margin: int):
    """(H, W) -> (nbh, T, nbw, T), T = mb + 2*margin: tile (i, j)
    covers plane[i*mb-margin : (i+1)*mb+margin] (edge-clamped)."""
    t = mb + 2 * margin
    p = pad_edge(plane, margin)
    return p.unfold(0, t, mb).unfold(1, t, mb).permute(0, 2, 1, 3)


def _pool4(p):
    return p.reshape(p.shape[0] // 4, 4, p.shape[1] // 4, 4).sum((1, 3)) >> 4


def coarse_mv(cur32, ref32, rc: int = COARSE_RANGE):
    """Coarse stage of the motion search: argmin over all (2rc+1)^2
    shifts of 4x average-pooled planes. Returns (mbh, mbw, 2) full-pel
    MVs that are multiples of 4 in [-4rc, 4rc]."""
    h, w = cur32.shape
    mbh, mbw = h // 16, w // 16
    cur_c = _pool4(cur32)
    hc, wc = cur_c.shape
    ref_c_pad = pad_edge(_pool4(ref32), rc)
    n_sh = 2 * rc + 1
    shifted = torch.stack(
        [ref_c_pad[dy:dy + hc, dx:dx + wc]
         for dy in range(n_sh) for dx in range(n_sh)])      # (S, hc, wc)
    diff = (cur_c[None] - shifted).abs()
    sad = diff.reshape(n_sh * n_sh, mbh, 4, mbw, 4).sum((2, 4))
    k = torch.argmin(sad, dim=0)                            # (mbh, mbw)
    cmv = torch.stack([k // n_sh - rc, k % n_sh - rc], dim=-1)
    return (cmv * 4).to(torch.int32)


def _tap6_last(a):
    """Unrounded 6-tap along the last axis; out[k] filters a[k..k+5]."""
    return (a[..., 0:-5] - 5 * a[..., 1:-4] + 20 * a[..., 2:-3]
            + 20 * a[..., 3:-2] - 5 * a[..., 4:-1] + a[..., 5:])


# ---------------------------------------------------------------------------
# legacy motion helpers (no encoder path calls them)
# ---------------------------------------------------------------------------

_PAD = 64  # edge padding for unrestricted MVs (spec clips refs to edge)


def _slice_start(start, size: int, dim: int):
    """jax.lax.dynamic_slice's start index along an axis of length
    `dim`: a negative start counts from the end, then the start is
    clamped so that the slice lies inside the axis."""
    start = start.long()
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def _windows(src, y0, x0, hgt: int, wid: int, sel=None):
    """The (..., hgt, wid) windows of src's last two dims at the start
    indices y0, x0 (integer tensors of one shape), each start taken as
    jax.lax.dynamic_slice takes it (_slice_start); `sel` picks a plane
    of a stacked (P, H, W) src per window."""
    h, w = src.shape[-2:]
    ry = _slice_start(y0, hgt, h)[..., None, None] \
        + torch.arange(hgt, device=src.device)[:, None]
    rx = _slice_start(x0, wid, w)[..., None, None] \
        + torch.arange(wid, device=src.device)[None, :]
    if sel is None:
        return src[ry, rx]
    return src[_slice_start(sel, 1, src.shape[0])[..., None, None], ry, rx]


def _mb_origins(mbh: int, mbw: int, mb: int, device):
    """Each MB's top-left sample: (mbh, 1) rows and (1, mbw) columns."""
    return (torch.arange(mbh, device=device)[:, None] * mb,
            torch.arange(mbw, device=device)[None, :] * mb)


def motion_search_fullpel(cur, ref, coarse_range: int = 4,
                          refine_range: int = 3):
    """Two-stage full-pel 16x16 motion search.

    cur, ref: (H, W) luma. Returns the MVs (mbh, mbw, 2) int32 in
    full-pel units (dy, dx) and the best SAD (mbh, mbw) int32. Stage 1
    (coarse_mv) scans (2*coarse_range+1)^2 shifts of 4x average-pooled
    planes (+-4 coarse = +-16 full-pel); stage 2 refines
    +-refine_range at full resolution around the coarse winner. Ties
    take the first candidate in scan order."""
    h, w = cur.shape
    mbh, mbw = h // 16, w // 16
    cur32, ref32 = cur.to(torch.int32), ref.to(torch.int32)
    cmv = coarse_mv(cur32, ref32, coarse_range)
    rr = refine_range
    n = 2 * rr + 1
    pad = 4 * coarse_range + rr + 16                   # worst-case reach
    by, bx = _mb_origins(mbh, mbw, 16, cur.device)
    win = _windows(pad_edge(ref32, pad), by + cmv[..., 0] - rr + pad,
                   bx + cmv[..., 1] - rr + pad, 16 + 2 * rr, 16 + 2 * rr)
    cand = win.unfold(2, 16, 1).unfold(3, 16, 1)       # (mbh, mbw, n, n, 16, 16)
    sads = (_mb_view(cur32)[:, :, None, None] - cand).abs() \
        .sum((-1, -2), dtype=torch.int32).flatten(2)   # (mbh, mbw, n * n)
    k = torch.argmin(sads, dim=-1)
    off = torch.stack([k // n - rr, k % n - rr], dim=-1)
    sad = sads.gather(-1, k[..., None])[..., 0]
    return (cmv + off).to(torch.int32), sad


def half_pel_planes(ref):
    """Spec 8.4.2.2.1 6-tap half-sample interpolation.

    ref: (H, W) integer luma. Returns four (H+2*_PAD, W+2*_PAD) int32
    planes: integer, half-horizontal (b), half-vertical (h), and
    half-diagonal (j, filtered from unrounded horizontal intermediates).
    Index [y, x] of each plane is the sample at full-pel (y, x) plus
    (0,0) / (0,+1/2) / (+1/2,0) / (+1/2,+1/2).
    """
    p = pad_edge(ref.to(torch.int32), _PAD + 3)
    # p[y + _PAD + 3, x + _PAD + 3] == ref[y, x] (edge-clamped); the
    # half-sample right of x filters ref[x-2..x+3] = tap6 column
    # x+_PAD+1, so the first output column is dropped
    bx = _tap6_last(p)                            # (H+2P+6, W+2P+1)
    b_plane = ((bx[3:-3, 1:] + 16) >> 5).clamp(0, 255)
    hy = _tap6_last(p.T).T                        # (H+2P+1, W+2P+6)
    h_plane = ((hy[1:, 3:-3] + 16) >> 5).clamp(0, 255)
    # j: vertical 6-tap over the unrounded horizontal intermediates
    jxy = _tap6_last(bx[:, 1:].T).T               # (H+2P+1, W+2P)
    j_plane = ((jxy[1:, :] + 512) >> 10).clamp(0, 255)
    return p[3:-3, 3:-3], b_plane, h_plane, j_plane


def _half_pel_blocks(stacked, mv_q):
    """The 16x16 block of each MB at quarter-pel MVs with even
    components from half_pel_planes' planes stacked (4, H', W')."""
    mbh, mbw = mv_q.shape[:2]
    by, bx = _mb_origins(mbh, mbw, 16, mv_q.device)
    m = mv_q.long()
    sel = ((m[..., 0] >> 1) & 1) * 2 + ((m[..., 1] >> 1) & 1)
    return _windows(stacked, by + (m[..., 0] >> 2) + _PAD,
                    bx + (m[..., 1] >> 2) + _PAD, 16, 16, sel=sel)


def mc_luma_qpel(planes, mv):
    """Luma MC for quarter-pel MVs restricted to half-pel positions
    (mv quarter-pel components must be even).

    planes: output of half_pel_planes; mv: (mbh, mbw, 2) quarter-pel.
    Returns (mbh, mbw, 16, 16) int32 predictions.
    """
    return _half_pel_blocks(torch.stack(planes), mv)


# half-pel refinement candidates in quarter-pel units (order = tie order)
_HALF_CANDS = ((0, 0), (0, 2), (0, -2), (2, 0), (-2, 0),
               (2, 2), (2, -2), (-2, 2), (-2, -2))


def halfpel_refine(cur_mb, planes, mv_full):
    """Refine full-pel MVs over the 8 half-pel neighbors by SAD.

    cur_mb: (mbh, mbw, 16, 16) int32; mv_full: (mbh, mbw, 2) full-pel.
    Returns quarter-pel mv (mbh, mbw, 2) with even components; ties
    take the first candidate of _HALF_CANDS.
    """
    mv_q = mv_full.to(torch.int32) * 4
    cands = torch.tensor(_HALF_CANDS, dtype=torch.int32,
                         device=mv_q.device)
    stacked = torch.stack(planes)
    sads = torch.stack([
        (cur_mb - _half_pel_blocks(stacked, mv_q + c)).abs()
        .sum((-1, -2), dtype=torch.int32) for c in cands])   # (9, mbh, mbw)
    return mv_q + cands[torch.argmin(sads, dim=0)]


def mc_chroma(ref_c, mv_q):
    """Chroma MC with eighth-pel bilinear (spec 8.4.2.2.2).

    ref_c: (H/2, W/2); mv_q: (mbh, mbw, 2) in QUARTER-pel luma units,
    which for 4:2:0 are eighth-pel chroma units directly: integer
    chroma offset = mv >> 3, fraction = mv & 7. Returns (mbh, mbw, 8, 8)
    int32 predictions.
    """
    hc, wc = ref_c.shape
    mbh, mbw = hc // 8, wc // 8
    by, bx = _mb_origins(mbh, mbw, 8, ref_c.device)
    m = mv_q.to(torch.int32)
    block = _windows(pad_edge(ref_c.to(torch.int32), _PAD),
                     by + (m[..., 0] >> 3) + _PAD,
                     bx + (m[..., 1] >> 3) + _PAD, 9, 9)
    yf = (m[..., 0] & 7)[..., None, None]            # eighth-pel fractions
    xf = (m[..., 1] & 7)[..., None, None]
    a, b = block[..., :8, :8], block[..., :8, 1:]
    c, d = block[..., 1:, :8], block[..., 1:, 1:]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def _select_warp(src, key, cands, offsets, width, axis):
    """Sum over candidates i of where(key == cands[i], window_i, 0): the
    reference's dense select-warp. axis 1 selects rows of (mbh, T, mbw,
    T') windows, axis 3 columns; window i starts at offsets[i]."""
    out = None
    for c, o in zip(cands, offsets):
        m = (key == c)[:, None, :, None]
        win = src[:, o:o + width] if axis == 1 else src[:, :, :, o:o + width]
        term = torch.where(m, win, 0)
        out = term if out is None else out + term
    return out


def _me_mc_luma(y32, ref32):
    """Dense motion search + sub-pel refine + luma MC.
    Returns (mv_q (mbh,mbw,2), cmv, pred (mbh,mbw,16,16) int16, sad)."""
    h, w = y32.shape
    mbh, mbw = h // 16, w // 16
    rr = REFINE_RANGE
    reach = 4 * COARSE_RANGE
    marg = reach + rr + 4                  # + 6-tap/half-pel margin
    apron = tile_apron(ref32.to(torch.int16), 16, marg)

    cmv = coarse_mv(y32, ref32)            # multiples of 4

    # warp 1: per-MB windows at the coarse MV (separable dy, dx select)
    w1 = 16 + 2 * (rr + 4)
    o1 = marg - (rr + 4)
    coarse = list(range(-reach, reach + 1, 4))
    rows = _select_warp(apron, cmv[..., 0], coarse,
                        [o1 + d for d in coarse], w1, axis=1)
    warped = _select_warp(rows, cmv[..., 1], coarse,
                          [o1 + d for d in coarse], w1, axis=3)

    # full-pel refine: 49 SAD maps over the warped windows
    cur_l = y32.reshape(mbh, 16, mbw, 16).to(torch.int16)
    b1 = rr + 4
    offs = [(dy, dx) for dy in range(-rr, rr + 1)
            for dx in range(-rr, rr + 1)]
    sads = torch.stack([
        (cur_l - warped[:, b1 + dy:b1 + dy + 16, :, b1 + dx:b1 + dx + 16])
        .abs().sum((1, 3), dtype=torch.int32)
        for dy, dx in offs])               # (49, mbh, mbw)
    k = torch.argmin(sads, dim=0)
    sad = sads.amin(dim=0)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=y32.device)
    mv_full = cmv + offs_t[k]

    # warp 2: re-center windows at the refined MV (separable select)
    w2 = 16 + 2 * 4
    nsh = 2 * rr + 1
    ky, kx = k // nsh, k % nsh
    idx = list(range(nsh))
    shifts = [b1 + d - 4 for d in range(-rr, rr + 1)]
    rows2 = _select_warp(warped, ky, idx, shifts, w2, axis=1)
    warped2 = _select_warp(rows2, kx, idx, shifts, w2, axis=3)

    # half-pel planes of the warped windows (spec 8.4.2.2.1 filters and
    # rounding; the filter arithmetic runs in int32)
    w2t = warped2.permute(0, 2, 1, 3)      # (mbh, mbw, 24, 24) int16
    w2t32 = w2t.to(torch.int32)
    bxu = _tap6_last(w2t32)                # b at (y, x=k+2), unrounded
    b_w = ((bxu + 16) >> 5).clamp(0, 255).to(torch.int16)
    hyu = _tap6_last(w2t32.transpose(-1, -2)).transpose(-1, -2)
    h_w = ((hyu + 16) >> 5).clamp(0, 255).to(torch.int16)
    jxy = _tap6_last(bxu.transpose(-1, -2)).transpose(-1, -2)
    j_w = ((jxy + 512) >> 10).clamp(0, 255).to(torch.int16)

    base = 4
    cur_mb = y32.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3).to(torch.int16)

    def plane_win(p_idx, dy, dx):
        """16x16 window of plane {G, b, h, j} at integer offset
        (dy, dx) in [-1, +1] from the warped-window center."""
        iy, ix = base + dy, base + dx
        if p_idx == 0:
            return w2t[..., iy:iy + 16, ix:ix + 16]
        if p_idx == 1:
            return b_w[..., iy:iy + 16, ix - 2:ix - 2 + 16]
        if p_idx == 2:
            return h_w[..., iy - 2:iy - 2 + 16, ix:ix + 16]
        return j_w[..., iy - 2:iy - 2 + 16, ix - 2:ix - 2 + 16]

    # quarter-sample table (spec 8.4.2.2.1 Figure 8-4): every position
    # is the rounding average of two {G, b, h, j} samples
    G, B, HH, J = 0, 1, 2, 3
    qtab = {
        (0, 0): ((G, 0, 0), (G, 0, 0)),
        (0, 1): ((G, 0, 0), (B, 0, 0)),
        (0, 2): ((B, 0, 0), (B, 0, 0)),
        (0, 3): ((B, 0, 0), (G, 0, 1)),
        (1, 0): ((G, 0, 0), (HH, 0, 0)),
        (1, 1): ((B, 0, 0), (HH, 0, 0)),
        (1, 2): ((B, 0, 0), (J, 0, 0)),
        (1, 3): ((B, 0, 0), (HH, 0, 1)),
        (2, 0): ((HH, 0, 0), (HH, 0, 0)),
        (2, 1): ((HH, 0, 0), (J, 0, 0)),
        (2, 2): ((J, 0, 0), (J, 0, 0)),
        (2, 3): ((J, 0, 0), (HH, 0, 1)),
        (3, 0): ((HH, 0, 0), (G, 1, 0)),
        (3, 1): ((HH, 0, 0), (B, 1, 0)),
        (3, 2): ((J, 0, 0), (B, 1, 0)),
        (3, 3): ((B, 1, 0), (HH, 0, 1)),
    }

    def qpred(oy, ox):
        dy, dx = oy >> 2, ox >> 2
        (p1, a1, c1), (p2, a2, c2) = qtab[(oy & 3, ox & 3)]
        s1 = plane_win(p1, dy + a1, dx + c1)
        s2 = plane_win(p2, dy + a2, dx + c2)
        return (s1 + s2 + 1) >> 1

    # one 49-way sub-pel stage (covers full/half/quarter positions)
    q_cands = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]
    preds = torch.stack([qpred(oy, ox) for oy, ox in q_cands])
    qsads = (cur_mb[None] - preds).abs().sum((-1, -2), dtype=torch.int32)
    qk = torch.argmin(qsads, dim=0)                    # (mbh, mbw)
    pred = torch.gather(
        preds, 0, qk[None, :, :, None, None].expand(1, -1, -1, 16, 16))[0]
    qoff = torch.tensor(q_cands, dtype=torch.int32, device=y32.device)
    mv_q = mv_full * 4 + qoff[qk]
    return mv_q, cmv, pred, sad


def _mc_chroma_dense(ref_c32, cmv, mv_q):
    """Chroma MC (spec 8.4.2.2.2 bilinear) via hierarchical dense
    select-warp: coarse chroma shift (= luma cmv / 2), then the small
    residual integer offset, then per-MB-weight bilinear.
    Returns (mbh, mbw, 8, 8) int32."""
    reach_c = 2 * COARSE_RANGE
    marg_c = reach_c + 3
    apron = tile_apron(ref_c32, 8, marg_c)

    wc1 = 8 + 2 * 3
    o1 = marg_c - 3
    ds = list(range(-reach_c, reach_c + 1, 2))
    rows = _select_warp(apron, cmv[..., 0], [2 * d for d in ds],
                        [o1 + d for d in ds], wc1, axis=1)
    warped = _select_warp(rows, cmv[..., 1], [2 * d for d in ds],
                          [o1 + d for d in ds], wc1, axis=3)

    extra = (mv_q >> 3) - (cmv >> 1)       # in [-2, 2]
    es = list(range(-2, 3))
    rows2 = _select_warp(warped, extra[..., 0], es, [3 + e for e in es],
                         9, axis=1)
    warped2 = _select_warp(rows2, extra[..., 1], es, [3 + e for e in es],
                           9, axis=3)

    wt = warped2.permute(0, 2, 1, 3)       # (mbh, mbw, 9, 9)
    a = wt[..., :8, :8]
    b = wt[..., :8, 1:9]
    c = wt[..., 1:9, :8]
    d = wt[..., 1:9, 1:9]
    yf = (mv_q[..., 0] & 7)[..., None, None]
    xf = (mv_q[..., 1] & 7)[..., None, None]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def _encode_frame_p_inter(y, u, v, ref_y, ref_u, ref_v, qp: int,
                         qp_c: int):
    """All-inter P frame core (see encode_frame_p)."""
    h, w = y.shape
    mbh, mbw = h // 16, w // 16

    y32 = y.to(torch.int32)
    mv, cmv, pred_y, sad = _me_mc_luma(y32, ref_y.to(torch.int32))
    res_y = _mb_view(y32) - pred_y
    z = quant4(fdct4(to_blocks4(res_y)), qp, intra=False)
    recon_y = (pred_y + from_blocks4(idct4(dequant4(z, qp)))).clamp(0, 255)
    luma_levels = zigzag_scan(z)                        # (mbh,mbw,4,4,16)

    def chroma_comp(plane, ref_plane):
        pred = _mc_chroma_dense(ref_plane.to(torch.int32), cmv, mv)
        res = _mb_view(plane.to(torch.int32), 8) - pred
        wc = fdct4(to_blocks4(res))                     # (mbh,mbw,2,2,4,4)
        zdc = quant_dc2(hadamard2_fwd(wc[..., 0, 0]), qp_c, intra=False)
        zac = quant4(wc, qp_c, intra=False)
        zac[..., 0, 0] = 0
        dd = dequant4(zac, qp_c)
        dd[..., 0, 0] = dequant_dc2(zdc, qp_c)
        rec = (pred + from_blocks4(idct4(dd))).clamp(0, 255)
        return (zdc.reshape(*zdc.shape[:-2], 4),
                zigzag_scan(zac)[..., 1:], rec)

    dc_u, ac_u, rec_u = chroma_comp(u, ref_u)
    dc_v, ac_v, rec_v = chroma_comp(v, ref_v)

    def unmb(x, mb):
        return x.transpose(1, 2).reshape(mbh * mb, mbw * mb).to(torch.uint8)

    return dict(
        mv=mv.to(torch.int32),
        sad=sad.to(torch.int32),
        luma_levels=luma_levels.to(torch.int16),
        dc_chroma=torch.stack([dc_u, dc_v], dim=2).to(torch.int16),
        ac_chroma=torch.stack([ac_u, ac_v], dim=2).to(torch.int16),
        recon=(unmb(recon_y, 16), unmb(rec_u, 8), unmb(rec_v, 8)),
    )


def _intra_fallback(y, u, v, outs, qp: int, qp_c: int):
    """Add Intra_16x16 fallback MBs to an all-inter P frame.

    Decision (source pixels): an MB goes intra when the best left-only
    intra predictor (H or DC) beats the chosen inter prediction's SAD
    by >= 1/8 (the margin stands in for the intra mode's larger header
    cost). Coding: ops/intra.py's `h264_intra16_cols` (K3) recodes every
    MB, column after column, against the true decoded left columns; the
    carry hands forward the SELECTED
    reconstruction (intra where chosen, the inter recon elsewhere),
    which is the decoder's neighbour state. The loop runs whether or
    not the frame has an intra MB (module docstring); its results count
    only where `is_intra`."""
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    dev = y.device
    y32 = y.to(torch.int32)
    cur = _mb_view(y32)                              # (mbh,mbw,16,16)

    # source-pixel intra estimate: left-neighbour H and DC predictors
    redge = y32[:, 15::16]                           # (h, mbw) right edges
    lcols = torch.cat([torch.full((h, 1), 128, dtype=torch.int32,
                                  device=dev), redge[:, :-1]], dim=1)
    lmb = lcols.reshape(mbh, 16, mbw).transpose(1, 2)  # (mbh,mbw,16)
    sad_h = (cur - lmb[..., :, None]).abs().sum((-1, -2))
    dc = (lmb.sum(-1) + 8) >> 4
    sad_dc = (cur - dc[..., None, None]).abs().sum((-1, -2))
    is_intra = 8 * torch.minimum(sad_h, sad_dc) < 7 * outs["sad"]

    iouts = h264_intra16_cols(y.contiguous(), u.contiguous(),
                              v.contiguous(), qp, qp_c, is_intra,
                              outs["recon"])
    ry_mb = _mb_view(outs["recon"][0])
    ru_mb = _mb_view(outs["recon"][1], 8)
    rv_mb = _mb_view(outs["recon"][2], 8)

    m = is_intra
    m2 = m[..., None, None]

    def unmb(x, mb):
        return x.transpose(1, 2).reshape(mbh * mb, mbw * mb)

    def sel(i, inter, mb):
        return torch.where(m2, _mb_view(iouts["recon"][i], mb), inter)

    keep = (~m).to(torch.int16)
    outs = dict(outs)
    outs["recon"] = (unmb(sel(0, ry_mb, 16), 16), unmb(sel(1, ru_mb, 8), 8),
                     unmb(sel(2, rv_mb, 8), 8))
    outs["mv"] = outs["mv"] * (~m)[..., None]
    outs["luma_levels"] = outs["luma_levels"] * keep[..., None, None, None]
    outs["dc_chroma"] = torch.where(m[..., None, None], iouts["dc_chroma"],
                                    outs["dc_chroma"])
    outs["ac_chroma"] = torch.where(m[..., None, None, None, None],
                                    iouts["ac_chroma"], outs["ac_chroma"])
    outs["is_intra"] = m
    for k in ("mode_luma", "mode_chroma", "dc_luma", "ac_luma"):
        o = iouts[k]
        outs[k] = o * m.reshape(*m.shape, *([1] * (o.dim() - 2)))
    return outs


def encode_frame_p(y, u, v, ref_y, ref_u, ref_v, qp: int, qp_c: int,
                   intra_in_p: bool = False):
    """Encode a P frame (P_L0_16x16 + optional Intra_16x16 fallback,
    quarter-pel MVs, previous-frame reference).

    Returns per-MB arrays with the reference's keys and dtypes: mv
    (mbh,mbw,2) int32 quarter-pel (dy, dx), sad, luma_levels
    (mbh,mbw,4,4,16) int16 (zigzag), dc_chroma (mbh,mbw,2,4), ac_chroma
    (mbh,mbw,2,2,2,15), recon (y, u, v) uint8 planes; with intra_in_p
    also is_intra, mode_luma, mode_chroma, dc_luma and ac_luma (zeroed
    at inter MBs).
    """
    outs = _encode_frame_p_inter(y, u, v, ref_y, ref_u, ref_v, qp, qp_c)
    if not intra_in_p:
        return outs
    return _intra_fallback(y, u, v, outs, qp, qp_c)
