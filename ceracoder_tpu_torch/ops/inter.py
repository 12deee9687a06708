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
always runs it, mbw more `_encode_mb_col` steps per P frame, and never
synchronizes. A persistent kernel per MB row (ROADMAP.md §2) would take
these launches away together with the deblock's and the IDR's.
"""

from __future__ import annotations

import torch

from ceracoder_tpu_torch.ops.intra import _OUT_DTYPES, _encode_mb_col
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
    cost). Coding: a loop over MB columns, batched over MB rows, recodes
    every MB with ops/intra.py's `_encode_mb_col` against the true
    decoded left columns; the carry hands forward the SELECTED
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

    umb = _mb_view(u.to(torch.int32), 8)
    vmb = _mb_view(v.to(torch.int32), 8)
    ry_mb = _mb_view(outs["recon"][0])
    ru_mb = _mb_view(outs["recon"][1], 8)
    rv_mb = _mb_view(outs["recon"][2], 8)

    ly = torch.full((mbh, 16), 128, dtype=torch.int32, device=dev)
    lu = torch.full((mbh, 8), 128, dtype=torch.int32, device=dev)
    lv = torch.full((mbh, 8), 128, dtype=torch.int32, device=dev)
    cols = []
    for c in range(mbw):
        out, (nly, nlu, nlv) = _encode_mb_col(cur[:, c], umb[:, c],
                                              vmb[:, c], ly, lu, lv, qp,
                                              qp_c)
        m1 = is_intra[:, c, None]
        ly = torch.where(m1, nly, ry_mb[:, c, :, 15].to(torch.int32))
        lu = torch.where(m1, nlu, ru_mb[:, c, :, 7].to(torch.int32))
        lv = torch.where(m1, nlv, rv_mb[:, c, :, 7].to(torch.int32))
        cols.append(out)
    iouts = {k: torch.stack([o[k] for o in cols], dim=1) for k in cols[0]}

    m = is_intra
    m2 = m[..., None, None]

    def unmb(x, mb):
        return x.transpose(1, 2).reshape(mbh * mb, mbw * mb)

    def sel(key, inter):
        return torch.where(m2, iouts[key].to(torch.uint8), inter)

    keep = (~m).to(torch.int16)
    outs = dict(outs)
    outs["recon"] = (unmb(sel("recon_y", ry_mb), 16),
                     unmb(sel("recon_u", ru_mb), 8),
                     unmb(sel("recon_v", rv_mb), 8))
    outs["mv"] = outs["mv"] * (~m)[..., None]
    outs["luma_levels"] = outs["luma_levels"] * keep[..., None, None, None]
    dcc = iouts["dc_chroma"].to(torch.int16)
    acc = iouts["ac_chroma"].to(torch.int16)
    outs["dc_chroma"] = torch.where(m[..., None, None], dcc,
                                    outs["dc_chroma"])
    outs["ac_chroma"] = torch.where(m[..., None, None, None, None], acc,
                                    outs["ac_chroma"])
    outs["is_intra"] = m
    for k in ("mode_luma", "mode_chroma", "dc_luma", "ac_luma"):
        o = iouts[k].to(_OUT_DTYPES[k])
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
