"""The reference HEVC encoder: the row-slice schedule's numpy compute and
Python entropy stage, one slice of tiles with one tile per CTB row.

Frozen copy of the spec half of ceracoder_tpu_torch/codec/h265/rowslice.py
(compute_intra_rows, the P tail of compute_p_rows, entropy_rows and their
helpers; only I and P slices, without SAO or the TU split): the
benchmark's reference keeps its own copy so that it imports nothing of the
program it judges. Two changes, neither of the arithmetic: `entropy_rows`
codes a band of CTB rows (`row0`, `nrows`) and can return the tile bodies
unassembled, so that bands.py can spread a frame's rows over processes.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc import intra as I
from benchmark.reference.hevc.bitwriter import emulation_prevent
from benchmark.reference.hevc.cabac import CabacEncoder
from benchmark.reference.hevc.ctx_tables import build_slice_contexts
from benchmark.reference.hevc.inter import encode_mvd, satd8_block
from benchmark.reference.hevc.residual import encode_residual
from benchmark.reference.hevc.syntax import HevcParams, slice_header_bits

CTB = 16


def _mpm_list(cand_a: int, cand_b: int) -> list[int]:
    """Most-probable-mode list (spec 8.4.2)."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [0, 1, 26]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
    mpm = [cand_a, cand_b]
    for m in (0, 1, 26):
        if m not in mpm:
            mpm.append(m)
            break
    return mpm


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
                     qp: int, qp_c: int):
    """Shared P/B tail (numpy twin of ops/h265._inter_frame_tail):
    inter-code every CTB first, then a parallelizable intra fallback
    that is only allowed when the LEFT neighbor codes inter — so each
    intra CTB's left reference column is the left neighbor's inter
    reconstruction, independent of other decisions. The alternation
    rule is use[c] = want[c] and not use[c-1]."""
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    nc = CTB // 2

    rec_y = np.zeros_like(y)
    rec_u = np.zeros_like(u)
    rec_v = np.zeros_like(v)
    mode = np.zeros((nch, ncw), np.int32)
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
            _, luma_lv[cy, cx] = _code_tu_pred(
                src, rec_y, pred_y, x0, y0, qp, intra=False)
            _, cb_lv[cy, cx] = _code_tu_pred(
                src_u, rec_u, pred_u, cx0, cy0, qp_c, intra=False)
            _, cr_lv[cy, cx] = _code_tu_pred(
                src_v, rec_v, pred_v, cx0, cy0, qp_c, intra=False)

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

    arrays = {"is_intra": is_intra, "mode": mode,
              "luma_lv": luma_lv, "cb_lv": cb_lv, "cr_lv": cr_lv}
    return arrays, (rec_y, rec_u, rec_v)


def entropy_rows(p: HevcParams, arrays: dict, qp: int, idr: bool,
                 poc: int = 0, row0: int = 0, nrows: int | None = None,
                 bodies: bool = False) -> list[bytes]:
    """Encode every CTB row as one tile of a single I or P slice; returns
    the slice's RBSP bytes, which the caller wraps in a NAL unit. All
    syntax-level decisions (MPM, cbf, skip/merge/AMVP) are derived here
    from the flat arrays, exactly as the C++ stage derives them.

    The arrays may hold a band of CTB rows that starts at picture row
    `row0` of `nrows`; with `bodies` the tiles come back one per row,
    unassembled (`_assemble_tiles` joins them)."""
    is_intra = arrays["is_intra"]
    mode = arrays["mode"]
    mv = arrays["mv"]
    luma_lv = arrays["luma_lv"]
    cb_lv = arrays["cb_lv"]
    cr_lv = arrays["cr_lv"]
    if not p.tiles or p.sao or p.tu_split_inter:
        raise ValueError("the reference codes one tile per CTB row, "
                         "without SAO or the TU split")
    nch, ncw = is_intra.shape
    nrows = nch if nrows is None else nrows
    init_type = 0 if idr else 1
    out = []
    for cy in range(nch):
        enc = CabacEncoder()
        ctx, off = build_slice_contexts(qp, init_type=init_type)

        left_mode = I.DC          # MPM A candidate (DC if unavailable)
        left_is_intra = False
        left_is_inter = False
        left_mv = (0, 0)
        left_skip = False
        for cx in range(ncw):
            intra_cu = bool(is_intra[cy, cx])
            cbf_l = 1 if luma_lv[cy, cx].any() else 0
            cbf_b = 1 if cb_lv[cy, cx].any() else 0
            cbf_r = 1 if cr_lv[cy, cx].any() else 0
            any_cbf = cbf_l or cbf_b or cbf_r

            if not idr:
                # merge candidates: A1 = left CU if inter (same
                # slice); all B candidates are above the row ->
                # unavailable; zero-MV fill to MaxNumMergeCand = 2
                merge = []
                if left_is_inter:
                    merge.append(left_mv)
                while len(merge) < 2:
                    merge.append((0, 0))
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
                cu_mv = (int(mv[cy, cx, 0]), int(mv[cy, cx, 1]))
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
                        # AMVP: A = left inter CU's MV
                        amvp = [left_mv] if left_is_inter else [(0, 0)]
                        amvp.append((0, 0))
                        costs = [abs(cu_mv[0] - c[0]) + abs(cu_mv[1] - c[1])
                                 for c in amvp]
                        mvp_idx = 0 if costs[0] <= costs[1] else 1
                        mvp = amvp[mvp_idx]
                        encode_mvd(enc, ctx, off, cu_mv[1] - mvp[1],
                                   cu_mv[0] - mvp[0])
                        enc.encode_bin(ctx, off["mvp_flag"], mvp_idx)
                        enc.encode_bin(ctx, off["rqt_root_cbf"],
                                       1 if any_cbf else 0)
                    if any_cbf:
                        _code_inter_transform_tree(
                            enc, ctx, off, luma_lv[cy, cx], cb_lv[cy, cx],
                            cr_lv[cy, cx])
                    left_skip = False
                left_is_intra = False
                left_is_inter = True
                left_mv = cu_mv
            if cx < ncw - 1:
                enc.encode_terminate(0)   # end_of_slice_segment_flag
            elif row0 + cy == nrows - 1:
                enc.encode_terminate(1)   # true slice end
            else:
                # tile end: end_of_slice_segment_flag = 0, then
                # end_of_subset_one_bit = 1 + byte alignment
                enc.encode_terminate(0)
                enc.encode_terminate(1)
        enc.finish()
        enc.align_one()
        out.append(enc.to_bytes())
    if not bodies:
        return [_assemble_tiles(p, out, qp, idr, poc)]
    return out


def _code_inter_transform_tree(enc, ctx, off, luma, cb, cr) -> None:
    """transform_tree for a non-skip inter CU with rqt_root_cbf == 1
    (spec 7.3.8.8): one 16x16 luma and two 8x8 chroma TUs."""
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


def _assemble_tiles(p: HevcParams, bodies: list[bytes], qp: int,
                    idr: bool, poc: int) -> bytes:
    """One slice carrying one tile per CTB row: slice header with
    entry-point offsets (coded-domain byte sizes of tiles 0..N-2,
    spec 7.4.7.1 — emulation prevention bytes counted; regions never
    share a zero run because every CABAC flush ends on a nonzero,
    byte-aligned byte) followed by the concatenated tile substreams."""
    coded_sizes = [len(emulation_prevent(b)) for b in bodies[:-1]]
    hdr = slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                            slice_type=None if idr else "P",
                            tile_sizes=coded_sizes)
    return hdr.to_bytes() + b"".join(bodies)
