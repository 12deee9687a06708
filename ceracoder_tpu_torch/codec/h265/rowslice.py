"""HEVC row-slice schedule: one slice segment (or one tile) per CTB row.

With every CTB row its own slice or tile, intra prediction, CABAC
contexts and motion candidate derivations never cross rows, so rows
compute independently on the device and the per-row entropy coding
parallelizes on the host.

The module is the executable spec of both halves of the device
encoder (codec/h265/device.py), factored the same way:

  compute_intra_rows / compute_p_rows   numpy spec of the device ops
  / compute_b_rows                      (ops/h265.py must produce
                                        identical arrays)
  entropy_rows                          Python spec of the native C++
                                        entropy stage
                                        (native/src/hevc_entropy.cc,
                                        entropy_rows_native, must
                                        produce identical bytes)

H265RowEncoder chains the two. The device path uses only
`densify_levels` and `entropy_rows_native`: the numpy ops and the
Python coder are specs and test twins, never a fallback. The native
stage is built and loaded by the port's own loader
(utils/host_build.py); a missing or failing library raises.

Copy of ceracoder_tpu/codec/h265/rowslice.py: the port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ceracoder_tpu_torch.codec.bitwriter import emulation_prevent
from ceracoder_tpu_torch.codec.h265 import intra as I
from ceracoder_tpu_torch.codec.h265.cabac import CabacEncoder
from ceracoder_tpu_torch.codec.h265.ctx_tables import build_slice_contexts
from ceracoder_tpu_torch.codec.h265.deblock import deblock_frame
from ceracoder_tpu_torch.codec.h265.encoder import _mpm_list, _pad
from ceracoder_tpu_torch.codec.h265.inter import (
    bi_combine_frame,
    encode_mvd,
    luma_qpel_planes,
    luma_qpel_planes14,
    mc_chroma_qpel,
    mc_chroma_qpel14,
    mc_luma_qpel,
    mc_luma_qpel14,
    motion_search,
    refine_subpel,
    satd8_block,
    uni_from_14,
)
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.codec.h265.residual import encode_residual
from ceracoder_tpu_torch.codec.h265.sao import (
    SAO_LAMBDA,
    sao_apply,
    sao_estimate,
)
from ceracoder_tpu_torch.codec.h265.syntax import (
    NAL_IDR_W_RADL,
    NAL_TRAIL_N,
    NAL_TRAIL_R,
    HevcParams,
    nal_unit,
    slice_header_bits,
    write_pps,
    write_sps,
    write_vps,
)
from ceracoder_tpu_torch.utils.host_build import load_hevc_entropy


CTB = 16

# inter-vs-intra competition bias, matching the raster encoder
# (codec/h265/encoder.py): intra must beat 3/4 of the inter SAD
INTRA_BIAS_NUM, INTRA_BIAS_DEN = 3, 4


def _ref_samples_row(rec_y: np.ndarray, x0: int, y0: int, n: int):
    """Intra reference samples under the row-slice schedule: the above
    CTB row is another slice, so only the left column is available
    (spec 8.4.4.2.2 substitution with have_top = False)."""
    if x0 == 0:
        full = np.full(2 * n, 128, np.int32)
        return full, full.copy(), 128
    left = np.zeros(2 * n, np.int32)
    left[:n] = rec_y[y0:y0 + n, x0 - 1]
    left[n:] = left[n - 1]            # below-left: pad from last avail
    corner = int(left[0])
    top = np.full(2 * n, corner, np.int32)
    return left, top, corner


def compute_intra_rows(y, u, v, qp: int, qp_c: int):
    """Numpy reference of the device intra op. Planes must be
    CTB-aligned. Returns (arrays, recon) where arrays is the flat
    per-CTB representation consumed by the entropy stage:

      mode     (nch, ncw) int32   chosen luma mode (chroma = DM)
      luma_lv  (nch, ncw, 16, 16) int32 quantized levels, raster
      cb_lv    (nch, ncw, 8, 8)   int32
      cr_lv    (nch, ncw, 8, 8)   int32
    """
    y = np.asarray(y).astype(np.int32)
    u = np.asarray(u).astype(np.int32)
    v = np.asarray(v).astype(np.int32)
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    rec_y = np.zeros_like(y)
    rec_u = np.zeros_like(u)
    rec_v = np.zeros_like(v)
    mode = np.zeros((nch, ncw), np.int32)
    luma_lv = np.zeros((nch, ncw, CTB, CTB), np.int32)
    cb_lv = np.zeros((nch, ncw, CTB // 2, CTB // 2), np.int32)
    cr_lv = np.zeros((nch, ncw, CTB // 2, CTB // 2), np.int32)

    for cy in range(nch):
        for cx in range(ncw):
            x0, y0 = cx * CTB, cy * CTB
            lref = _ref_samples_row(rec_y, x0, y0, CTB)
            src = y[y0:y0 + CTB, x0:x0 + CTB]
            best, best_pred, best_sad = None, None, 1 << 30
            for m in I.CAND_MODES:
                pr = I.predict(m, *lref, CTB, 0)
                sad = int(satd8_block(src - pr))
                if sad < best_sad:
                    best, best_pred, best_sad = m, pr, sad
            mode[cy, cx] = best
            _, luma_lv[cy, cx] = _code_tu_pred(
                src, rec_y, best_pred, x0, y0, qp)

            nc = CTB // 2
            cx0, cy0 = x0 // 2, y0 // 2
            for plane, recp, out in ((u, rec_u, cb_lv), (v, rec_v, cr_lv)):
                cref = _ref_samples_row(recp, cx0, cy0, nc)
                pr = I.predict(best, *cref, nc, 1)
                src_c = plane[cy0:cy0 + nc, cx0:cx0 + nc]
                _, out[cy, cx] = _code_tu_pred(
                    src_c, recp, pr, cx0, cy0, qp_c)

    arrays = {"is_intra": np.ones((nch, ncw), bool), "mode": mode,
              "mv": np.zeros((nch, ncw, 2), np.int32),
              "luma_lv": luma_lv, "cb_lv": cb_lv, "cr_lv": cr_lv}
    return arrays, (rec_y, rec_u, rec_v)


# deterministic integer bit-cost proxy for the TU-split decision
# (shared with the device twin; only comparisons matter)
def _tb_bits(lv) -> int:
    a = np.abs(lv)
    nnz = int((a > 0).sum())
    if nnz == 0:
        return 2
    return 24 + 6 * nnz + 2 * int(np.minimum(a, 8).sum())


def _code_inter_tus(src_y, pred_y, src_u, pred_u, src_v, pred_v,
                    qp: int, qp_c: int, lam: int):
    """Code one inter CU's residual both as single TUs (16 luma /
    8 chroma) and split (4x8 luma / 4x4 chroma); pick by
    16*SSD + lambda*bits. Returns (split, lv_y, lv_cb, lv_cr,
    rec_y, rec_u, rec_v) with split-level arrays stored in place
    (quadrant blocks at their spatial positions)."""
    def code(src, pred, n, qpx):
        lv = I.quantize(I.fwd_transform(src - pred), qpx, intra=False)
        if lv.any():
            rec = np.clip(pred + I.inv_transform(
                I.dequantize(lv, qpx)), 0, 255)
        else:
            rec = np.clip(pred, 0, 255)
        return lv.astype(np.int32), rec

    def quads(src, pred, n, qpx):
        lv = np.zeros_like(src, dtype=np.int32)
        rec = np.zeros_like(src)
        h = n // 2
        for by in (0, h):
            for bx in (0, h):
                lq, rq = code(src[by:by + h, bx:bx + h],
                              pred[by:by + h, bx:bx + h], h, qpx)
                lv[by:by + h, bx:bx + h] = lq
                rec[by:by + h, bx:bx + h] = rq
        return lv, rec

    # option A: single TUs
    lvA = [code(src_y, pred_y, 16, qp),
           code(src_u, pred_u, 8, qp_c),
           code(src_v, pred_v, 8, qp_c)]
    # option B: quadrants
    lvB = [quads(src_y, pred_y, 16, qp),
           quads(src_u, pred_u, 8, qp_c),
           quads(src_v, pred_v, 8, qp_c)]

    def cost(opt, split):
        ssd = 0
        bits = 4 if split else 2
        for (lv, rec), src in zip(opt, (src_y, src_u, src_v)):
            ssd += int(((src - rec) ** 2).sum())
            if split:
                h = lv.shape[0] // 2
                for by in (0, h):
                    for bx in (0, h):
                        bits += _tb_bits(lv[by:by + h, bx:bx + h])
            else:
                bits += _tb_bits(lv)
        return 16 * ssd + lam * bits

    if cost(lvB, True) < cost(lvA, False):
        (ly, ry), (lu, ru), (lvv, rv) = lvB
        return True, ly, lu, lvv, ry, ru, rv
    (ly, ry), (lu, ru), (lvv, rv) = lvA
    return False, ly, lu, lvv, ry, ru, rv


def _code_tu_pred(src, recp, pred, x0, y0, qp, intra=True):
    coef = I.quantize(I.fwd_transform(src - pred), qp, intra=intra)
    if coef.any():
        rec = np.clip(pred + I.inv_transform(I.dequantize(coef, qp)),
                      0, 255)
        cbf = 1
    else:
        rec = np.clip(pred, 0, 255)
        cbf = 0
    n = src.shape[0]
    recp[y0:y0 + n, x0:x0 + n] = rec
    return cbf, coef.astype(np.int32)


def _inter_tail_rows(y, u, v, pred_y_all, pred_u_all, pred_v_all,
                     qp: int, qp_c: int, tu_split: bool):
    """Shared P/B tail (numpy twin of ops/h265._inter_frame_tail):
    inter-code every CTB first, then a parallelizable intra fallback
    that is only allowed when the LEFT neighbor codes inter — so each
    intra CTB's left reference column is the left neighbor's inter
    reconstruction, independent of other decisions. The alternation
    rule is use[c] = want[c] and not use[c-1]."""
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    nc = CTB // 2
    lam = SAO_LAMBDA[min(max(qp, 0), 69)]

    rec_y = np.zeros_like(y)
    rec_u = np.zeros_like(u)
    rec_v = np.zeros_like(v)
    mode = np.zeros((nch, ncw), np.int32)
    tsplit = np.zeros((nch, ncw), bool)
    luma_lv = np.zeros((nch, ncw, CTB, CTB), np.int32)
    cb_lv = np.zeros((nch, ncw, nc, nc), np.int32)
    cr_lv = np.zeros((nch, ncw, nc, nc), np.int32)
    inter_sads = np.zeros((nch, ncw), np.int64)

    # pass 1: inter-code every CTB (rec planes = inter recon)
    for cy in range(nch):
        for cx in range(ncw):
            x0, y0 = cx * CTB, cy * CTB
            cx0, cy0 = x0 // 2, y0 // 2
            src = y[y0:y0 + CTB, x0:x0 + CTB]
            pred_y = pred_y_all[y0:y0 + CTB, x0:x0 + CTB]
            inter_sads[cy, cx] = int(satd8_block(src - pred_y))
            pred_u = pred_u_all[cy0:cy0 + nc, cx0:cx0 + nc]
            pred_v = pred_v_all[cy0:cy0 + nc, cx0:cx0 + nc]
            src_u = u[cy0:cy0 + nc, cx0:cx0 + nc]
            src_v = v[cy0:cy0 + nc, cx0:cx0 + nc]
            if tu_split:
                (sp, luma_lv[cy, cx], cb_lv[cy, cx],
                 cr_lv[cy, cx], ry, ru, rv) = _code_inter_tus(
                    src, pred_y, src_u, pred_u, src_v, pred_v,
                    qp, qp_c, lam)
                tsplit[cy, cx] = sp
                rec_y[y0:y0 + CTB, x0:x0 + CTB] = ry
                rec_u[cy0:cy0 + nc, cx0:cx0 + nc] = ru
                rec_v[cy0:cy0 + nc, cx0:cx0 + nc] = rv
            else:
                _, luma_lv[cy, cx] = _code_tu_pred(
                    src, rec_y, pred_y, x0, y0, qp, intra=False)
                _, cb_lv[cy, cx] = _code_tu_pred(
                    src_u, rec_u, pred_u, cx0, cy0, qp_c,
                    intra=False)
                _, cr_lv[cy, cx] = _code_tu_pred(
                    src_v, rec_v, pred_v, cx0, cy0, qp_c,
                    intra=False)

    # pass 2: intra candidates against the inter recon planes +
    # left-must-be-inter alternation rule
    irec_y = rec_y.copy()
    irec_u = rec_u.copy()
    irec_v = rec_v.copy()
    want = np.zeros((nch, ncw), bool)
    cand = {}
    for cy in range(nch):
        for cx in range(ncw):
            x0, y0 = cx * CTB, cy * CTB
            src = y[y0:y0 + CTB, x0:x0 + CTB]
            lref = _ref_samples_row(irec_y, x0, y0, CTB)
            ibest, isad = None, 1 << 30
            for m in I.CAND_MODES:
                pr = I.predict(m, *lref, CTB, 0)
                sad = int(satd8_block(src - pr))
                if sad < isad:
                    ibest, isad = m, sad
            # store only the winning mode; pass 3 recomputes its
            # prediction from irec_y (keeping ~nch*ncw full blocks
            # alive here costs ~2 MB/frame at 1080p for nothing)
            cand[cy, cx] = ibest
            want[cy, cx] = (isad * INTRA_BIAS_DEN
                            < inter_sads[cy, cx] * INTRA_BIAS_NUM)
    is_intra = np.zeros((nch, ncw), bool)
    for cy in range(nch):
        for cx in range(ncw):
            is_intra[cy, cx] = want[cy, cx] and not (
                cx > 0 and is_intra[cy, cx - 1])

    # pass 3: overwrite the chosen intra CTBs (their left neighbor is
    # inter, so prediction references from the inter planes equal the
    # decoder's actual neighbor recon)
    for cy in range(nch):
        for cx in range(ncw):
            if not is_intra[cy, cx]:
                continue
            x0, y0 = cx * CTB, cy * CTB
            cx0, cy0 = x0 // 2, y0 // 2
            ibest = cand[cy, cx]
            ipred = I.predict(ibest,
                              *_ref_samples_row(irec_y, x0, y0, CTB),
                              CTB, 0)
            mode[cy, cx] = ibest
            tsplit[cy, cx] = False
            src = y[y0:y0 + CTB, x0:x0 + CTB]
            _, luma_lv[cy, cx] = _code_tu_pred(
                src, rec_y, ipred, x0, y0, qp)
            for plane, irecp, recp, out in (
                    (u, irec_u, rec_u, cb_lv),
                    (v, irec_v, rec_v, cr_lv)):
                cref = _ref_samples_row(irecp, cx0, cy0, nc)
                pr = I.predict(ibest, *cref, nc, 1)
                src_c = plane[cy0:cy0 + nc, cx0:cx0 + nc]
                _, out[cy, cx] = _code_tu_pred(
                    src_c, recp, pr, cx0, cy0, qp_c)

    arrays = {"is_intra": is_intra, "mode": mode, "tu_split": tsplit,
              "luma_lv": luma_lv, "cb_lv": cb_lv, "cr_lv": cr_lv}
    return arrays, (rec_y, rec_u, rec_v)


def compute_p_rows(y, u, v, ref, qp: int, qp_c: int,
                   tu_split: bool = False):
    """Numpy reference of the device P op. ref = (y, u, v) padded
    recon of the previous picture. Adds to the intra arrays:

      is_intra (nch, ncw) bool    per-CTB intra fallback
      mv       (nch, ncw, 2) int32 (dy, dx) quarter-pel (full-pel *4)
    """
    y = np.asarray(y).astype(np.int32)
    u = np.asarray(u).astype(np.int32)
    v = np.asarray(v).astype(np.int32)
    ref_y, ref_u, ref_v = ref
    h, w = y.shape

    mvs = motion_search(y, ref_y)
    planes = luma_qpel_planes(ref_y)
    mvs_q = refine_subpel(y, planes, mvs)
    pred_y_all = mc_luma_qpel(planes, mvs_q, h, w)
    pred_u_all = mc_chroma_qpel(ref_u, mvs_q, h // 2, w // 2)
    pred_v_all = mc_chroma_qpel(ref_v, mvs_q, h // 2, w // 2)

    arrays, rec = _inter_tail_rows(y, u, v, pred_y_all, pred_u_all,
                                   pred_v_all, qp, qp_c, tu_split)
    arrays["mv"] = np.where(arrays["is_intra"][..., None], 0, mvs_q)
    return arrays, rec


def compute_b_rows(y, u, v, ref0, ref1, qp: int, qp_c: int,
                   tu_split: bool = False):
    """Numpy reference of the device B op: every inter CU bi-predicted
    (list 0 = past reference, list 1 = future), per-list quarter-pel
    motion, 14-bit intermediate combine (spec 8.5.4.2.3.2), per-CTB
    intra fallback. Adds ``mv1`` to the arrays."""
    y = np.asarray(y).astype(np.int32)
    u = np.asarray(u).astype(np.int32)
    v = np.asarray(v).astype(np.int32)
    h, w = y.shape

    p14 = [luma_qpel_planes14(r[0]) for r in (ref0, ref1)]
    mvq = []
    for r, pl in zip((ref0, ref1), p14):
        full = motion_search(y, r[0])
        mvq.append(refine_subpel(y, uni_from_14(pl), full))
    pred_y_all = bi_combine_frame(
        mc_luma_qpel14(p14[0], mvq[0], h, w),
        mc_luma_qpel14(p14[1], mvq[1], h, w))
    hc, wc = h // 2, w // 2
    pred_u_all = bi_combine_frame(
        mc_chroma_qpel14(ref0[1], mvq[0], hc, wc),
        mc_chroma_qpel14(ref1[1], mvq[1], hc, wc))
    pred_v_all = bi_combine_frame(
        mc_chroma_qpel14(ref0[2], mvq[0], hc, wc),
        mc_chroma_qpel14(ref1[2], mvq[1], hc, wc))

    arrays, rec = _inter_tail_rows(y, u, v, pred_y_all, pred_u_all,
                                   pred_v_all, qp, qp_c, tu_split)
    off = arrays["is_intra"][..., None]
    arrays["mv"] = np.where(off, 0, mvq[0])
    arrays["mv1"] = np.where(off, 0, mvq[1])
    return arrays, rec




def densify_levels(counts: np.ndarray, pos: np.ndarray,
                   val: np.ndarray) -> dict:
    """Rebuild dense per-CTB level arrays from the device's sparse
    stream (ops/h265._compact_levels layout: CTB-major, per CTB
    [luma 256 | cb 64 | cr 64], pos = slot within that layout).

    counts may be per-CTB totals (nch, ncw) — the packed-transfer
    format — or per-TU (nch, ncw, 3); the stream is slot-ordered within
    each CTB, so per-CTB totals plus pos fully determine the dense
    layout."""
    if counts.ndim == 3:
        counts = counts.sum(-1)
    nch, ncw = counts.shape
    n_ctb = nch * ncw
    cnt = counts.reshape(n_ctb).astype(np.int64)
    nnz = int(cnt.sum())
    # flat slot index of every entry: CTB base + in-layout position
    ctb_of = np.repeat(np.arange(n_ctb), cnt)
    flat = ctb_of * 384 + pos[:nnz].astype(np.int64)
    dense = np.zeros(n_ctb * 384, np.int32)
    dense[flat] = val[:nnz]
    dense = dense.reshape(n_ctb, 384)
    return {
        "luma_lv": dense[:, :256].reshape(nch, ncw, 16, 16),
        "cb_lv": dense[:, 256:320].reshape(nch, ncw, 8, 8),
        "cr_lv": dense[:, 320:].reshape(nch, ncw, 8, 8),
    }


# ---------------------------------------------------------------------------
# Entropy stage (Python reference of native/src/hevc_entropy.cc)
# ---------------------------------------------------------------------------

def entropy_rows(p: HevcParams, arrays: dict, qp: int, idr: bool,
                 poc: int = 0, ref_poc_delta: int = 1,
                 slice_type: str | None = None,
                 fwd_poc_delta: int = 1) -> list[bytes]:
    """Encode every CTB row as an independent slice segment, or with
    `p.tiles` as one tile of a single slice; returns per-row RBSP bytes
    (the tile slice's as one), which the caller wraps in NAL units. All
    syntax-level
    decisions (MPM, cbf, skip/merge/AMVP) are derived here from the
    flat arrays, exactly as the C++ stage derives them. B slices
    (slice_type="B", arrays carry ``mv1``) code every inter CU
    bi-predicted (inter_pred_idc = PRED_BI, dual AMVP/MVD); merge and
    skip compare the full (mv0, mv1) motion."""
    is_intra = arrays["is_intra"]
    mode = arrays["mode"]
    mv = arrays["mv"]
    luma_lv = arrays["luma_lv"]
    cb_lv = arrays["cb_lv"]
    cr_lv = arrays["cr_lv"]
    st = slice_type or ("I" if idr else "P")
    is_b = st == "B"
    mv1 = arrays["mv1"] if is_b else None
    tu_split_enabled = p.tu_split_inter
    tsplit = arrays.get("tu_split")
    nch, ncw = is_intra.shape
    init_type = 0 if idr else (2 if is_b else 1)
    tiles = p.tiles
    sao = arrays.get("sao") if p.sao else None
    out = []
    for cy in range(nch):
        enc = CabacEncoder()
        if not tiles:                 # the row's slice segment header
            hdr = slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                                    ref_poc_delta=ref_poc_delta,
                                    slice_type=None if idr else st,
                                    fwd_poc_delta=fwd_poc_delta,
                                    ctb_addr=cy * ncw)
            hv, hl = hdr.arrays()
            for val, n in zip(hv.tolist(), hl.tolist()):
                enc.write_raw(int(val), int(n))
        ctx, off = build_slice_contexts(qp, init_type=init_type)

        left_mode = I.DC          # MPM A candidate (DC if unavailable)
        left_is_intra = False
        left_is_inter = False
        left_mv = ((0, 0), (0, 0))    # per list
        left_skip = False
        for cx in range(ncw):
            if sao is not None:
                _code_sao(enc, ctx, off, sao, cy, cx)
            intra_cu = bool(is_intra[cy, cx])
            cbf_l = 1 if luma_lv[cy, cx].any() else 0
            cbf_b = 1 if cb_lv[cy, cx].any() else 0
            cbf_r = 1 if cr_lv[cy, cx].any() else 0
            any_cbf = cbf_l or cbf_b or cbf_r

            if not idr:
                # merge candidates: A1 = left CU if inter (same
                # slice); all B candidates are above the row ->
                # unavailable; zero-MV fill to MaxNumMergeCand = 2.
                # A candidate is its full motion (both lists in B).
                merge = []
                if left_is_inter:
                    merge.append(left_mv)
                while len(merge) < 2:
                    merge.append(((0, 0), (0, 0)))

            if intra_cu:
                if not idr:
                    skip_ctx = off["skip"] + (1 if left_skip else 0)
                    enc.encode_bin(ctx, skip_ctx, 0)
                    enc.encode_bin(ctx, off["pred_mode"], 1)
                m = int(mode[cy, cx])
                enc.encode_bin(ctx, off["part_mode"], 1)   # 2Nx2N
                cand_a = left_mode if left_is_intra else I.DC
                mpm = _mpm_list(cand_a, I.DC)
                if m in mpm:
                    enc.encode_bin(ctx, off["prev_intra"], 1)
                    idx = mpm.index(m)
                    enc.encode_bypass(0 if idx == 0 else 1)
                    if idx:
                        enc.encode_bypass(idx - 1)
                else:
                    enc.encode_bin(ctx, off["prev_intra"], 0)
                    rem = m - sum(1 for x in sorted(mpm) if x < m)
                    enc.encode_bypass_bits(rem, 5)
                enc.encode_bin(ctx, off["chroma_pred"], 0)  # DM
                enc.encode_bin(ctx, off["cbf_chroma"], cbf_b)
                enc.encode_bin(ctx, off["cbf_chroma"], cbf_r)
                enc.encode_bin(ctx, off["cbf_luma"] + 1, cbf_l)
                if cbf_l:
                    encode_residual(enc, ctx, off, luma_lv[cy, cx], 0)
                if cbf_b:
                    encode_residual(enc, ctx, off, cb_lv[cy, cx], 1)
                if cbf_r:
                    encode_residual(enc, ctx, off, cr_lv[cy, cx], 2)
                left_mode, left_is_intra = m, True
                left_is_inter = False
                left_skip = False
            else:
                cu_mv = ((int(mv[cy, cx, 0]), int(mv[cy, cx, 1])),
                         (int(mv1[cy, cx, 0]), int(mv1[cy, cx, 1]))
                         if is_b else (0, 0))
                try:
                    merge_idx = merge.index(cu_mv)
                except ValueError:
                    merge_idx = -1
                skip_ctx = off["skip"] + (1 if left_skip else 0)
                if merge_idx >= 0 and not any_cbf:
                    enc.encode_bin(ctx, skip_ctx, 1)
                    enc.encode_bin(ctx, off["merge_idx"], merge_idx)
                    left_skip = True
                else:
                    enc.encode_bin(ctx, skip_ctx, 0)
                    enc.encode_bin(ctx, off["pred_mode"], 0)
                    enc.encode_bin(ctx, off["part_mode"], 1)
                    if merge_idx >= 0:
                        enc.encode_bin(ctx, off["merge_flag"], 1)
                        enc.encode_bin(ctx, off["merge_idx"], merge_idx)
                    else:
                        enc.encode_bin(ctx, off["merge_flag"], 0)
                        if is_b:
                            # inter_pred_idc = PRED_BI: one bin, ctx
                            # by coding-tree depth (0)
                            enc.encode_bin(
                                ctx, off["inter_pred_idc"], 1)
                        n_lists = 2 if is_b else 1
                        for lx in range(n_lists):
                            mv_q = cu_mv[lx]
                            # AMVP: A = left inter CU's list-lx MV
                            amvp = ([left_mv[lx]] if left_is_inter
                                    else [(0, 0)])
                            amvp.append((0, 0))
                            costs = [abs(mv_q[0] - c[0])
                                     + abs(mv_q[1] - c[1])
                                     for c in amvp]
                            mvp_idx = 0 if costs[0] <= costs[1] else 1
                            mvp = amvp[mvp_idx]
                            encode_mvd(enc, ctx, off,
                                       mv_q[1] - mvp[1],
                                       mv_q[0] - mvp[0])
                            enc.encode_bin(ctx, off["mvp_flag"],
                                           mvp_idx)
                        enc.encode_bin(ctx, off["rqt_root_cbf"],
                                       1 if any_cbf else 0)
                    if any_cbf:
                        split = bool(tsplit[cy, cx]) \
                            if tsplit is not None else False
                        _code_inter_transform_tree(
                            enc, ctx, off, tu_split_enabled, split,
                            luma_lv[cy, cx], cb_lv[cy, cx],
                            cr_lv[cy, cx])
                    left_skip = False
                left_is_intra = False
                left_is_inter = True
                left_mv = cu_mv
            if cx < ncw - 1:
                enc.encode_terminate(0)   # end_of_slice_segment_flag
            elif not tiles or cy == nch - 1:
                enc.encode_terminate(1)   # true slice end
            else:
                # tile end: end_of_slice_segment_flag = 0, then
                # end_of_subset_one_bit = 1 + byte alignment
                enc.encode_terminate(0)
                enc.encode_terminate(1)
        enc.finish()
        enc.align_one()
        out.append(enc.to_bytes())
    if tiles:
        return [_assemble_tiles(p, out, qp, idr, poc, ref_poc_delta,
                                None if idr else st, fwd_poc_delta)]
    return out


def _code_inter_transform_tree(enc, ctx, off, tu_split_enabled: bool,
                               split: bool, luma, cb, cr) -> None:
    """transform_tree for a non-skip inter CU with rqt_root_cbf == 1
    (spec 7.3.8.8): optional depth-0 split into 4x8x8 luma + 4x4
    chroma TUs (z-order children; chroma cbf at both depths)."""
    if tu_split_enabled:
        # split_transform_flag, ctx 5 - log2TrafoSize(4) = 1
        enc.encode_bin(ctx, off["split_tu"] + 1, 1 if split else 0)
    if not split:
        cbf_l = 1 if luma.any() else 0
        cbf_b = 1 if cb.any() else 0
        cbf_r = 1 if cr.any() else 0
        enc.encode_bin(ctx, off["cbf_chroma"], cbf_b)
        enc.encode_bin(ctx, off["cbf_chroma"], cbf_r)
        if cbf_b or cbf_r:
            enc.encode_bin(ctx, off["cbf_luma"] + 1, cbf_l)
        if cbf_l:
            encode_residual(enc, ctx, off, luma, 0)
        if cbf_b:
            encode_residual(enc, ctx, off, cb, 1)
        if cbf_r:
            encode_residual(enc, ctx, off, cr, 2)
        return
    # depth-0 chroma cbf (ctxInc = trafoDepth = 0)
    cb_q = [cb[by:by + 4, bx:bx + 4]
            for by in (0, 4) for bx in (0, 4)]
    cr_q = [cr[by:by + 4, bx:bx + 4]
            for by in (0, 4) for bx in (0, 4)]
    l_q = [luma[by:by + 8, bx:bx + 8]
           for by in (0, 8) for bx in (0, 8)]
    cbf_b0 = 1 if cb.any() else 0
    cbf_r0 = 1 if cr.any() else 0
    enc.encode_bin(ctx, off["cbf_chroma"], cbf_b0)
    enc.encode_bin(ctx, off["cbf_chroma"], cbf_r0)
    for k in range(4):                 # z-order: TL, TR, BL, BR
        cbf_b1 = 1 if cb_q[k].any() else 0
        cbf_r1 = 1 if cr_q[k].any() else 0
        if cbf_b0:
            enc.encode_bin(ctx, off["cbf_chroma"] + 1, cbf_b1)
        if cbf_r0:
            enc.encode_bin(ctx, off["cbf_chroma"] + 1, cbf_r1)
        cbf_l1 = 1 if l_q[k].any() else 0
        # leaf at trafoDepth 1: cbf_luma always coded, ctx 0
        enc.encode_bin(ctx, off["cbf_luma"], cbf_l1)
        if cbf_l1:
            encode_residual(enc, ctx, off, l_q[k], 0)
        if cbf_b0 and cbf_b1:
            encode_residual(enc, ctx, off, cb_q[k], 1)
        if cbf_r0 and cbf_r1:
            encode_residual(enc, ctx, off, cr_q[k], 2)


def _code_sao(enc, ctx, off, sao, cy: int, cx: int) -> None:
    """sao() syntax for one CTB (spec 7.3.8.3): merge-left when the
    params match, else type/offsets/band-or-class per component
    (chroma shares type and class; the above row is another
    slice/tile, so merge-up is never available)."""
    if cx > 0:
        merge = bool((sao[cy, cx] == sao[cy, cx - 1]).all())
        enc.encode_bin(ctx, off["sao_merge"], 1 if merge else 0)
        if merge:
            return
    for ci in range(3):
        t = int(sao[cy, cx, ci, 0])
        cls = int(sao[cy, cx, ci, 1])
        offs = [int(x) for x in sao[cy, cx, ci, 2:6]]
        if ci < 2:
            # sao_type_idx: TR cMax 2 — '0' off, '10' band, '11' edge
            enc.encode_bin(ctx, off["sao_type"], 0 if t == 0 else 1)
            if t:
                enc.encode_bypass(1 if t == 2 else 0)
        if t == 0:
            continue
        for v in offs:
            a = abs(v)
            for _ in range(a):
                enc.encode_bypass(1)
            if a < 7:
                enc.encode_bypass(0)
        if t == 1:
            for v in offs:
                if v:
                    enc.encode_bypass(1 if v < 0 else 0)
            enc.encode_bypass_bits(cls, 5)     # sao_band_position
        elif ci < 2:
            enc.encode_bypass_bits(cls, 2)     # sao_eo_class



def _assemble_tiles(p: HevcParams, bodies: list[bytes], qp: int,
                    idr: bool, poc: int, ref_poc_delta: int,
                    slice_type: str | None, fwd_poc_delta: int = 1) -> bytes:
    """One slice carrying one tile per CTB row: slice header with
    entry-point offsets (coded-domain byte sizes of tiles 0..N-2,
    spec 7.4.7.1 — emulation prevention bytes counted; regions never
    share a zero run because every CABAC flush ends on a nonzero,
    byte-aligned byte) followed by the concatenated tile substreams."""
    coded_sizes = [len(emulation_prevent(b)) for b in bodies[:-1]]
    hdr = slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                            ref_poc_delta=ref_poc_delta,
                            slice_type=slice_type,
                            fwd_poc_delta=fwd_poc_delta,
                            tile_sizes=coded_sizes)
    return hdr.to_bytes() + b"".join(bodies)


# fixed element order of the offsets array passed to the native stage
# (must match the CtxOff enum in native/src/hevc_entropy.cc, which in
# turn matches ctx_tables._LAYOUT)
_NATIVE_OFF_ORDER = (
    "part_mode", "prev_intra", "chroma_pred", "cbf_luma", "cbf_chroma",
    "last_x", "last_y", "csbf", "sig", "gr1", "gr2", "split_cu", "skip",
    "pred_mode", "merge_flag", "merge_idx", "mvp_flag", "mvd_gr",
    "rqt_root_cbf", "inter_pred_idc", "sao_merge", "sao_type",
    "split_tu")


def entropy_rows_native(p: HevcParams, arrays: dict, qp: int, idr: bool,
                        poc: int = 0, ref_poc_delta: int = 1,
                        slice_type: str | None = None,
                        fwd_poc_delta: int = 1) -> list[bytes]:
    """Native (C++) entropy stage of an I, P or (``slice_type="B"``, with
    arrays["mv1"]) B picture, byte-identical to `entropy_rows`: with
    `p.tiles` every CTB row is one tile of a single slice, and the
    slice's RBSP bytes come back as one; else every CTB row is a slice
    segment of its own (a one-row picture: one plain slice), one RBSP
    each. The caller wraps them in NAL units. With `p.sao`,
    arrays["sao"] holds each CTB's (nch, ncw, 3, 6) SAO parameters
    (ops/h265.py: sao_estimate_dev); with `p.tu_split_inter`,
    arrays["tu_split"] each CU's TU split flag."""
    lib = load_hevc_entropy()
    slice_type = None if idr else slice_type
    is_b = slice_type == "B"

    is_intra = np.ascontiguousarray(arrays["is_intra"], np.uint8)
    mode = np.ascontiguousarray(arrays["mode"], np.int32)
    mv = np.ascontiguousarray(arrays["mv"], np.int32)
    mv1 = (np.ascontiguousarray(arrays["mv1"], np.int32) if is_b
           else np.zeros_like(mv))
    luma_lv = np.ascontiguousarray(arrays["luma_lv"], np.int16)
    cb_lv = np.ascontiguousarray(arrays["cb_lv"], np.int16)
    cr_lv = np.ascontiguousarray(arrays["cr_lv"], np.int16)
    nch, ncw = is_intra.shape
    if (mode.shape != (nch, ncw) or mv.shape != (nch, ncw, 2)
            or luma_lv.shape != (nch, ncw, 16, 16)
            or cb_lv.shape != (nch, ncw, 8, 8)
            or cr_lv.shape != cb_lv.shape or mv1.shape != mv.shape):
        raise ValueError("entropy arrays do not share one CTB grid")

    # tile rows are headerless substreams (the slice header is assembled
    # afterwards); else each row's slice segment header goes in front of
    # it, packed at a common stride
    if p.tiles:
        hdr_bytes = np.zeros((nch, 1), np.uint8)
        hdr_bits = np.zeros(nch, np.int32)
    else:
        hdrs = [slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                                  ref_poc_delta=ref_poc_delta,
                                  slice_type=slice_type,
                                  fwd_poc_delta=fwd_poc_delta,
                                  ctb_addr=cy * ncw) for cy in range(nch)]
        rows = [h.to_bytes() for h in hdrs]
        hdr_bytes = np.zeros((nch, max(map(len, rows))), np.uint8)
        for cy, b in enumerate(rows):
            hdr_bytes[cy, :len(b)] = np.frombuffer(b, np.uint8)
        hdr_bits = np.array([h.bit_length for h in hdrs], np.int32)
    stride = hdr_bytes.shape[1]

    ctx, off = build_slice_contexts(qp, init_type=0 if idr else
                                    (2 if is_b else 1))
    offs = np.array([off[k] for k in _NATIVE_OFF_ORDER], np.int32)

    cap = max(1 << 16, nch * ncw * 768 + nch * (stride + 16))
    out = np.zeros(cap, np.uint8)
    row_sizes = np.zeros(nch, np.int32)
    nt = min(nch, os.cpu_count() or 1)
    sao = None
    if p.sao:
        sao = np.ascontiguousarray(arrays["sao"], np.int32)
        if sao.shape != (nch, ncw, 3, 6):
            raise ValueError(f"SAO parameters {sao.shape}, need "
                             f"{(nch, ncw, 3, 6)}")
    split = None
    if p.tu_split_inter and not idr:   # an I slice reads no split flag
        split = np.ascontiguousarray(arrays["tu_split"], np.uint8)
        if split.shape != (nch, ncw):
            raise ValueError(f"TU split flags {split.shape}, need "
                             f"{(nch, ncw)}")
    total = lib.hevc_entropy_rows(
        nch, ncw, int(idr), int(is_b), int(p.tiles),
        int(p.tu_split_inter),
        None if split is None else split.ctypes.data_as(ctypes.c_void_p),
        None if sao is None else sao.ctypes.data_as(ctypes.c_void_p),
        hdr_bytes.ctypes.data_as(ctypes.c_void_p),
        hdr_bits.ctypes.data_as(ctypes.c_void_p), stride,
        ctx.ctypes.data_as(ctypes.c_void_p), len(ctx),
        offs.ctypes.data_as(ctypes.c_void_p),
        is_intra.ctypes.data_as(ctypes.c_void_p),
        mode.ctypes.data_as(ctypes.c_void_p),
        mv.ctypes.data_as(ctypes.c_void_p),
        mv1.ctypes.data_as(ctypes.c_void_p),
        luma_lv.ctypes.data_as(ctypes.c_void_p),
        cb_lv.ctypes.data_as(ctypes.c_void_p),
        cr_lv.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap,
        row_sizes.ctypes.data_as(ctypes.c_void_p), nt)
    if total < 0:
        raise RuntimeError("hevc_entropy_rows: output capacity exceeded")
    res = []
    pos = 0
    for cy in range(nch):
        sz = int(row_sizes[cy])
        res.append(out[pos:pos + sz].tobytes())
        pos += sz
    if p.tiles:
        return [_assemble_tiles(p, res, qp, idr, poc, ref_poc_delta,
                                slice_type, fwd_poc_delta)]
    return res


# ---------------------------------------------------------------------------
# Frame-level orchestration
# ---------------------------------------------------------------------------

class H265RowEncoder:
    """Row-slice HEVC encoder: IDR + P GOPs (optional IBPBP with one
    non-reference B between references), numpy compute and the native
    (``native_entropy``) or Python entropy stage. The slow but exact
    spec of the device encoder; nothing falls back to it."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, native_entropy: bool = True,
                 deblock: bool = True, bframes: int = 0,
                 tile_rows: bool = True, sao: bool = False,
                 tu_split: bool = False):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 requires even dimensions (the "
                             "conformance window crops in 2-sample "
                             "units)")
        self.width, self.height = width, height
        self.qp, self.qp_c = qp, chroma_qp(qp)
        self.gop = max(1, gop)
        self.native_entropy = native_entropy
        self.deblock = deblock
        self.bframes = 1 if bframes else 0
        self.tu_split = tu_split
        self.params = HevcParams(width=width, height=height, qp=qp,
                                 pcm_enabled=False, deblock=deblock,
                                 max_reorder=self.bframes,
                                 max_dpb_minus1=1 + self.bframes,
                                 tile_rows=tile_rows, sao=sao,
                                 tu_split_inter=tu_split)
        self.pw = -(-width // CTB) * CTB
        self.ph = -(-height // CTB) * CTB
        self._ref = None
        self._pending = None      # buffered B candidate (planes, poc)
        self._poc = 0
        self.recon = None

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def resume(self) -> None:
        """Drop all transient state: next frame is a fresh IDR
        (SURVEY.md §5 recovery model)."""
        self._ref = None
        self._pending = None
        self._poc = 0

    def _pad3(self, y, u, v):
        return (_pad(np.asarray(y), self.ph, self.pw),
                _pad(np.asarray(u), self.ph // 2, self.pw // 2),
                _pad(np.asarray(v), self.ph // 2, self.pw // 2))

    def _deblocked(self, arrays, rec):
        cbf_l = arrays["luma_lv"].reshape(
            *arrays["luma_lv"].shape[:2], -1).any(-1)
        return deblock_frame(*rec, arrays["is_intra"], cbf_l,
                             arrays["mv"], self.qp,
                             mv1=arrays.get("mv1"),
                             tu_split=arrays.get("tu_split"),
                             luma_lv=arrays["luma_lv"])

    def _post_filter(self, arrays, rec, planes):
        """Frame post-pass: deblock, then SAO (estimated against the
        source and recorded in the arrays for the entropy stage)."""
        if self.deblock:
            rec = self._deblocked(arrays, rec)
        if self.params.sao:
            params = sao_estimate(planes, rec, self.qp)
            arrays["sao"] = params
            rec = sao_apply(rec, params)
        return rec

    def _crop(self, rec):
        return (rec[0][:self.height, :self.width].astype(np.uint8),
                rec[1][:self.height // 2, :self.width // 2]
                .astype(np.uint8),
                rec[2][:self.height // 2, :self.width // 2]
                .astype(np.uint8))

    def _wrap(self, ntype, rbsps):
        return b"".join(nal_unit(ntype, r, long_start_code=(i == 0))
                        for i, r in enumerate(rbsps))

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False):
        """Low-delay entry (bframes == 0): one frame in, one out."""
        assert self.bframes == 0, "use push_frame/flush with B frames"
        (data, _, kind, _), = self.push_frame(y, u, v, qp=qp,
                                              force_idr=force_idr)
        return data, kind == "I"

    def push_frame(self, y, u, v, qp: int | None = None,
                   force_idr: bool = False, allow_b: bool = True):
        """Feed one display-order frame; returns (data, poc, kind,
        display_recon) tuples in coding order (empty while a B
        candidate waits for its forward reference). allow_b=False (a
        lookahead hint) codes the frame as P instead of holding it as
        a B candidate."""
        if qp is not None:
            self.qp, self.qp_c = qp, chroma_qp(qp)
        planes = self._pad3(y, u, v)

        idr = force_idr or self._ref is None or self._poc >= self.gop
        out = []
        if idr:
            out += self.flush()
            arrays, rec = compute_intra_rows(*planes, self.qp, self.qp_c)
            rec = self._post_filter(arrays, rec, planes)
            rbsps = self._entropy(arrays, idr=True, poc=0)
            self._ref = rec
            self.recon = self._crop(rec)
            self._poc = 1
            out.append((self._wrap(NAL_IDR_W_RADL, rbsps), 0, "I",
                        self.recon))
            return out

        if (self.bframes and self._pending is None and allow_b
                and self._poc <= self.gop - 2):
            self._pending = (planes, self._poc, self.qp, self.qp_c)
            self._poc += 1
            return out

        if self._pending is not None:
            bplanes, bpoc, bqp, bqp_c = self._pending
            self._pending = None
            past = self._ref
            out.append(self._encode_p(planes, poc=self._poc,
                                      ref_delta=2))
            p_rec = self._ref
            out.append(self._encode_b(bplanes, past, p_rec, bpoc,
                                      bqp, bqp_c))
            self._ref = p_rec
            self.recon = out[0][3]
            self._poc += 1
            return out

        out.append(self._encode_p(planes, poc=self._poc, ref_delta=1))
        self._poc += 1
        return out

    def flush(self):
        """Code any buffered B candidate as a trailing P frame."""
        if self._pending is None:
            return []
        planes, poc, qp, qp_c = self._pending
        self._pending = None
        sq, sqc = self.qp, self.qp_c
        self.qp, self.qp_c = qp, qp_c
        res = self._encode_p(planes, poc=poc, ref_delta=1)
        self.qp, self.qp_c = sq, sqc
        return [res]

    def _encode_p(self, planes, poc: int, ref_delta: int):
        arrays, rec = compute_p_rows(*planes, self._ref,
                                     self.qp, self.qp_c,
                                     tu_split=self.tu_split)
        rec = self._post_filter(arrays, rec, planes)
        rbsps = self._entropy(arrays, idr=False, poc=poc,
                              ref_poc_delta=ref_delta)
        self._ref = rec
        self.recon = self._crop(rec)
        return (self._wrap(NAL_TRAIL_R, rbsps), poc, "P", self.recon)

    def _encode_b(self, planes, past, fut, poc: int, qp: int,
                  qp_c: int):
        arrays, rec = compute_b_rows(*planes, past, fut, qp, qp_c,
                                     tu_split=self.tu_split)
        sq = self.qp
        self.qp = qp
        rec = self._post_filter(arrays, rec, planes)
        self.qp = sq
        rbsps = self._entropy(arrays, idr=False, poc=poc,
                              slice_type="B", qp_override=qp)
        return (self._wrap(NAL_TRAIL_N, rbsps), poc, "B",
                self._crop(rec))

    def _entropy(self, arrays: dict, idr: bool, poc: int,
                 ref_poc_delta: int = 1, slice_type: str | None = None,
                 qp_override: int | None = None) -> list[bytes]:
        qp = self.qp if qp_override is None else qp_override
        coder = entropy_rows_native if self.native_entropy else entropy_rows
        return coder(self.params, arrays, qp, idr=idr, poc=poc,
                     ref_poc_delta=ref_poc_delta, slice_type=slice_type)
