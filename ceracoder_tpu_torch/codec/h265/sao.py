"""HEVC Sample Adaptive Offset (spec 8.7.3) — numpy reference.

SAO runs after deblocking as part of the frame post-pass (the filtered
picture is the MC reference and decoder output, so the coding loop is
untouched). Per CTB and component the encoder picks OFF, BAND (4
consecutive 8-wide bands, signed offsets) or EDGE (one of 4 directions,
category offsets with implied signs) by maximizing the integer
distortion gain 2*off*sum - cnt*off^2 computed from (source -
deblocked) statistics — all integer math so the device twin
(ops/h265.py) reproduces the decisions bit for bit.

Constraints kept deliberately simple and row-local:
- chroma: one shared type/class decision estimated from Cb+Cr jointly
  (the syntax requires a single sao_type_idx_chroma), separate offsets
- edge-offset neighbors never cross the CTB boundary (the estimator
  and the filter skip the CTB's border samples), so CTBs filter
  independently — no halo needed in the sharded schedule
- no merge-up (the above CTB row is another slice/tile); merge-left is
  a pure entropy-stage decision (params equality)

Replaces the SAO stage of the reference's external HEVC encoders
(reference: pipeline/ *h265*; SURVEY.md §2.2).

Copy of ceracoder_tpu/codec/h265/sao.py: the port keeps its own copy so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

CTB = 16
N_COMP = 3
# params layout per (ctb, comp): [type, class_or_band, o0, o1, o2, o3]
# type: 0 off, 1 band, 2 edge; offsets signed (band) / category-signed
# magnitudes are stored signed here (edge cat 3/4 negative)
P_TYPE, P_CLS, P_O0 = 0, 1, 2
PARAM_N = 6

# edge-class neighbor offsets: (dy0, dx0, dy1, dx1)
EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0),
                (-1, -1, 1, 1), (-1, 1, 1, -1))


def _eo_category(p, n0, n1):
    """SAO edge categories (spec Table 8-13): 1 local min, 2 concave
    edge, 3 convex edge, 4 local max, 0 none."""
    a = np.sign(p - n0) + np.sign(p - n1)
    cat = np.zeros_like(p)
    cat[a == -2] = 1
    cat[a == -1] = 2
    cat[a == 1] = 3
    cat[a == 2] = 4
    return cat


def _offset_gain(sums, cnts, max_abs=7, force_sign=0):
    """Best integer offset and its distortion gain per category.
    force_sign: +1 / -1 restricts the sign (edge cats), 0 = free."""
    cnts = np.maximum(cnts, 1)
    raw = (2 * np.abs(sums) + cnts) // (2 * cnts)   # round half up
    off = np.minimum(raw, max_abs) * np.sign(sums)
    if force_sign > 0:
        off = np.maximum(off, 0)
    elif force_sign < 0:
        off = np.minimum(off, 0)
    gain = 2 * off * sums - cnts * off * off
    off = np.where(gain > 0, off, 0)
    gain = np.where(gain > 0, gain, 0)
    return off.astype(np.int32), gain.astype(np.int64)


def _ctb_view(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).swapaxes(1, 2)


def _estimate_plane(src, rec, n):
    """Per-CTB best params for one plane: (type, cls, offs (4,),
    gain). Candidate order off(0) < band(1) < edge cls 0..3; strictly
    greater gain wins (ties keep the earlier option)."""
    st = _full_stats(src, rec, n)
    h, w = rec.shape
    nch, ncw = h // n, w // n
    ob, win = st["bo_off"], st["bo_win"]
    band_pos = win.argmax(-1).astype(np.int32)
    bo_gain = np.take_along_axis(win, band_pos[..., None], -1)[..., 0]
    bo_offs = np.stack([
        np.take_along_axis(ob, band_pos[..., None] + i, -1)[..., 0]
        for i in range(4)], -1).astype(np.int32)

    best_gain = np.zeros((nch, ncw), np.int64)
    best_type = np.zeros((nch, ncw), np.int32)
    best_cls = np.zeros((nch, ncw), np.int32)
    best_offs = np.zeros((nch, ncw, 4), np.int32)
    take = bo_gain > best_gain
    best_gain = np.where(take, bo_gain, best_gain)
    best_type = np.where(take, 1, best_type)
    best_cls = np.where(take, band_pos, best_cls)
    best_offs = np.where(take[..., None], bo_offs, best_offs)
    for cls in range(4):
        take = st["eo_gain"][cls] > best_gain
        best_gain = np.where(take, st["eo_gain"][cls], best_gain)
        best_type = np.where(take, 2, best_type)
        best_cls = np.where(take, cls, best_cls)
        best_offs = np.where(take[..., None], st["eo_off"][cls],
                             best_offs)
    return best_type, best_cls, best_offs, best_gain


# integer rate-distortion lambda per QP (HM-style
# 0.57 * 2^((qp-12)/3), scaled by 16) — a table so the numpy and
# device paths share the exact integers
SAO_LAMBDA = tuple(
    max(1, int(0.57 * (2.0 ** ((q - 12) / 3.0)) * 16))
    for q in range(70))


def sao_lambda(qp: int) -> int:
    return SAO_LAMBDA[min(max(qp, 0), 69)]


# approximate syntax cost in bits: type + offsets + class/band/signs.
# Note the structural ceiling: at CTB 16 the largest possible luma
# gain is 256 * 7^2 ~= 12.5k SSD, so past qp ~40 the lambda-scaled
# cost always wins and SAO self-disables — it pays mainly at low/mid
# QP on banded or ringing content.
SAO_BITS_LUMA = 24
SAO_BITS_CHROMA = 34


def sao_estimate(src_planes, rec_planes, qp: int = 32):
    """Choose SAO params for one frame. Returns params
    (nch, ncw, 3, PARAM_N) int32. Chroma shares type/class: the joint
    Cb+Cr decision maximizes the summed gain under a common
    type/class, with per-plane offsets re-estimated for the winner.
    A lambda-scaled bit cost gates each decision so SAO only engages
    where the distortion gain pays for its syntax."""
    y_s, u_s, v_s = src_planes
    y_r, u_r, v_r = rec_planes
    h, w = y_r.shape
    nch, ncw = h // CTB, w // CTB
    params = np.zeros((nch, ncw, N_COMP, PARAM_N), np.int32)
    lam = sao_lambda(qp)
    th_l = (lam * SAO_BITS_LUMA) // 16
    th_c = (lam * SAO_BITS_CHROMA) // 16

    t, c, o, g = _estimate_plane(y_s, y_r, CTB)
    keep = g > th_l
    t = np.where(keep, t, 0)
    c = np.where(keep, c, 0)
    o = np.where(keep[..., None], o, 0)
    params[:, :, 0, P_TYPE] = t
    params[:, :, 0, P_CLS] = c
    params[:, :, 0, P_O0:] = o

    # chroma: band offset only. Edge classes at chroma CTB
    # right-edge columns decode differently in libavcodec than the
    # whole-picture formulation (single-pixel category flips observed
    # on smooth content); band offsets have no neighbor dependence and
    # carry most of the chroma gain.
    nc = CTB // 2
    stats = [_full_stats(p_s, p_r, nc)
             for p_s, p_r in ((u_s, u_r), (v_s, v_r))]
    # joint band window over summed gains
    win = stats[0]["bo_win"] + stats[1]["bo_win"]
    bc = win.argmax(-1).astype(np.int32)
    best_gain = np.take_along_axis(win, bc[..., None], -1)[..., 0]
    bu, bv = (np.stack([
        np.take_along_axis(s["bo_off"], bc[..., None] + i, -1)[..., 0]
        for i in range(4)], -1) for s in stats)
    bt = np.full((nch, ncw), 1, np.int32)
    keep_c = best_gain > th_c
    bt = np.where(keep_c, bt, 0)
    bc = np.where(keep_c, bc, 0)
    bu = np.where(keep_c[..., None], bu, 0)
    bv = np.where(keep_c[..., None], bv, 0)
    for ci, (oc,) in ((1, (bu,)), (2, (bv,))):
        params[:, :, ci, P_TYPE] = bt
        params[:, :, ci, P_CLS] = bc
        params[:, :, ci, P_O0:] = oc
    return params


def _full_stats(src, rec, n):
    """All candidate edge/band statistics for one plane (shared by
    the luma decision and the joint chroma decision)."""
    diff = src.astype(np.int64) - rec.astype(np.int64)
    h, w = rec.shape
    nch, ncw = h // n, w // n
    dv = _ctb_view(diff, n)
    rv = _ctb_view(rec.astype(np.int32), n)
    rpad = rec.astype(np.int32)
    eo_off = np.zeros((4, nch, ncw, 4), np.int32)
    eo_gain = np.zeros((4, nch, ncw), np.int64)
    for cls, (dy0, dx0, dy1, dx1) in enumerate(EO_NEIGHBORS):
        n0 = np.roll(rpad, (-dy0, -dx0), (0, 1))
        n1 = np.roll(rpad, (-dy1, -dx1), (0, 1))
        cat = _eo_category(rpad, n0, n1)
        iy = np.arange(h) % n
        ix = np.arange(w) % n
        interior = ((iy > 0) & (iy < n - 1))[:, None] \
            & ((ix > 0) & (ix < n - 1))[None, :]
        catv = _ctb_view(np.where(interior, cat, 0), n)
        for k in (1, 2, 3, 4):
            m = catv == k
            cnts = m.sum((2, 3))
            sums = np.where(m, dv, 0).sum((2, 3))
            sign = 1 if k <= 2 else -1
            o_, g_ = _offset_gain(sums, cnts, force_sign=sign)
            eo_off[cls, ..., k - 1] = o_
            eo_gain[cls] += g_
    band = rv >> 3
    bo_sums = np.zeros((nch, ncw, 32), np.int64)
    bo_cnts = np.zeros((nch, ncw, 32), np.int64)
    for b in range(32):
        m = band == b
        bo_cnts[..., b] = m.sum((2, 3))
        bo_sums[..., b] = np.where(m, dv, 0).sum((2, 3))
    ob, gb = _offset_gain(bo_sums, bo_cnts)
    win = np.stack([gb[..., s:s + 4].sum(-1) for s in range(29)], -1)
    return {"eo_off": eo_off, "eo_gain": eo_gain, "bo_off": ob,
            "bo_win": win}


def sao_apply(rec_planes, params):
    """Apply SAO params to the deblocked planes (decoder semantics;
    edge offsets skip each CTB's border ring by construction of the
    estimator — offsets there are derived from interior stats but the
    spec applies them everywhere, so the filter must apply to interior
    samples only via the virtual-boundary trick? No: the spec applies
    edge offsets to every sample whose neighbors exist within the
    picture. To stay spec-exact AND halo-free the encoder simply never
    filters border rings — achieved by applying offsets only where the
    *decoder* would compute the same category from within-CTB
    neighbors. For border samples the decoder reads neighbor CTBs, so
    the encoder must reproduce that: we therefore apply the true spec
    filter over the full picture here; the sharded device path
    exchanges 1-sample halos."""
    outs = []
    for ci, rec in enumerate(rec_planes):
        n = CTB if ci == 0 else CTB // 2
        h, w = rec.shape
        nch, ncw = h // n, w // n
        r = rec.astype(np.int32)
        out = r.copy()
        ptype = params[:, :, ci, P_TYPE]
        pcls = params[:, :, ci, P_CLS]
        offs = params[:, :, ci, P_O0:]

        # band offset
        band = r >> 3
        bp = np.repeat(np.repeat(pcls, n, 0), n, 1)
        t_full = np.repeat(np.repeat(ptype, n, 0), n, 1)
        delta = np.zeros_like(r)
        for i in range(4):
            oi = np.repeat(np.repeat(offs[..., i], n, 0), n, 1)
            delta = np.where((t_full == 1) & (band == bp + i),
                             oi, delta)

        # edge offset per class
        for cls, (dy0, dx0, dy1, dx1) in enumerate(EO_NEIGHBORS):
            n0 = np.roll(r, (-dy0, -dx0), (0, 1))
            n1 = np.roll(r, (-dy1, -dx1), (0, 1))
            cat = _eo_category(r, n0, n1)
            # picture-border samples whose neighbors fall outside are
            # not modified (spec 8.7.3: sample location checks)
            ys = np.arange(h)[:, None]
            xs = np.arange(w)[None, :]
            ok = ((ys + dy0 >= 0) & (ys + dy0 < h)
                  & (ys + dy1 >= 0) & (ys + dy1 < h)
                  & (xs + dx0 >= 0) & (xs + dx0 < w)
                  & (xs + dx1 >= 0) & (xs + dx1 < w))
            cm = np.repeat(np.repeat(pcls == cls, n, 0), n, 1)
            sel = (t_full == 2) & cm & ok
            for k in (1, 2, 3, 4):
                oi = np.repeat(np.repeat(offs[..., k - 1], n, 0), n, 1)
                delta = np.where(sel & (cat == k), oi, delta)

        outs.append(np.clip(r + delta, 0, 255))
    return tuple(outs)
