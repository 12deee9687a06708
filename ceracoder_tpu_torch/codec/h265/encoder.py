"""HEVC encoder — stage 0: all-PCM intra frames.

The PCM path exercises every structural layer (NAL framing, parameter
sets, slice header, CABAC engine incl. terminate bins, engine re-init
after PCM, alignment) with only ONE context-coded syntax element
(part_mode), and the output decodes losslessly — the independent
libavcodec decoder must return the input samples exactly. This is the
HEVC analog of the H.264 I_PCM stage (codec/h264/ipcm.py) and the
validation anchor that the residual-coding stages build on
(SURVEY.md §7.3 hard part #1).

Mirrors the capability of the reference's external HEVC encoder
elements at their lossless operating point (reference: pipeline/
*h265* pipelines; SURVEY.md §2.2).

Copy of ceracoder_tpu/codec/h265/encoder.py: the port keeps its own copy
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.h265 import intra as I
from ceracoder_tpu_torch.codec.h265.cabac import CabacEncoder, init_context
from ceracoder_tpu_torch.codec.h265.ctx_tables import (
    build_i_slice_contexts,
    build_slice_contexts,
)
from ceracoder_tpu_torch.codec.h265.inter import (
    MotionField,
    bi_combine,
    encode_mvd,
    mc_chroma_block,
    mc_chroma_block14,
    mc_luma_block,
    mc_luma_block14,
    motion_search,
)
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.codec.h265.residual import encode_residual
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

# part_mode ctxIdx 0 initValue for I slices (spec Table 9-12 initType 0)
INIT_PART_MODE_I = 184


class H265PcmEncoder:
    """All-PCM IDR encoder: lossless, one slice per frame, 16x16 CTBs."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.params = HevcParams(width=width, height=height,
                                 pcm_enabled=True, deblock=False,
                                 tile_rows=False)
        ctb = self.params.ctb
        self.pw = -(-width // ctb) * ctb
        self.ph = -(-height // ctb) * ctb

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> bytes:
        """Encode one IDR frame; planes are edge-padded to CTB size."""
        p = self.params
        ctb = p.ctb
        y = _pad(y, self.ph, self.pw)
        u = _pad(u, self.ph // 2, self.pw // 2)
        v = _pad(v, self.ph // 2, self.pw // 2)

        hdr = slice_header_bits(p, idr=True)
        enc = CabacEncoder()
        hv, hl = hdr.arrays()
        for val, n in zip(hv.tolist(), hl.tolist()):
            enc.write_raw(int(val), int(n))

        ctx = np.array([init_context(INIT_PART_MODE_I, p.qp)], np.uint8)
        n_ctb_w = self.pw // ctb
        n_ctb_h = self.ph // ctb
        n_ctbs = n_ctb_w * n_ctb_h
        for i in range(n_ctbs):
            cy, cx = divmod(i, n_ctb_w)
            # coding_unit at CTB==minCB: part_mode (2Nx2N) then pcm_flag
            enc.encode_bin(ctx, 0, 1)          # part_mode: 2Nx2N
            enc.encode_terminate(1)            # pcm_flag = 1
            enc.finish()
            enc.align_one()                    # pcm_alignment (stop+zeros)
            yb = y[cy * ctb:(cy + 1) * ctb, cx * ctb:(cx + 1) * ctb]
            ub = u[cy * ctb // 2:(cy + 1) * ctb // 2,
                   cx * ctb // 2:(cx + 1) * ctb // 2]
            vb = v[cy * ctb // 2:(cy + 1) * ctb // 2,
                   cx * ctb // 2:(cx + 1) * ctb // 2]
            for blk in (yb, ub, vb):
                for byte in blk.reshape(-1).tolist():
                    enc.write_raw(int(byte), 8)
            enc.reset_engine()                 # spec 9.3.1: re-init after PCM
            # end_of_slice_segment_flag
            last = i == n_ctbs - 1
            enc.encode_terminate(1 if last else 0)
        enc.finish()
        enc.align_one()                        # rbsp_slice_segment_trailing
        return nal_unit(NAL_IDR_W_RADL, enc.to_bytes())


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


class H265IntraEncoder:
    """All-intra HEVC encoder: planar/DC/H/V mode decision, 16x16 luma
    TUs + 8x8 chroma TUs, full CABAC residual coding, bit-exact
    reconstruction (deblocking and SAO disabled in the parameter sets,
    so recon must equal the decoder's output sample for sample).

    Replaces the reference's external HEVC encoder elements
    (reference: pipeline/ *h265* pipelines, e.g. rk3588/h265_hdmi_1080p30;
    SURVEY.md §2.2) — first lossy HEVC stage on the path to the
    BASELINE.md 4K60 target.
    """

    def __init__(self, width: int, height: int, qp: int = 32):

        self.width, self.height = width, height
        self.params = HevcParams(width=width, height=height, qp=qp,
                                 pcm_enabled=False, deblock=False,
                                 tile_rows=False)
        self.qp = qp
        self.qp_c = chroma_qp(qp)
        ctb = self.params.ctb
        self.pw = -(-width // ctb) * ctb
        self.ph = -(-height // ctb) * ctb
        self.recon = None

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray, qp: int | None = None) -> bytes:

        p = self.params
        ctb = p.ctb
        if qp is not None:
            self.qp, self.qp_c = qp, I.chroma_qp(qp)
        qp, qp_c = self.qp, self.qp_c
        y = _pad(np.asarray(y), self.ph, self.pw).astype(np.int32)
        u = _pad(np.asarray(u), self.ph // 2, self.pw // 2).astype(np.int32)
        v = _pad(np.asarray(v), self.ph // 2, self.pw // 2).astype(np.int32)

        rec_y = np.zeros_like(y)
        rec_u = np.zeros_like(u)
        rec_v = np.zeros_like(v)

        hdr = slice_header_bits(p, idr=True, qp=qp)
        enc = CabacEncoder()
        hv, hl = hdr.arrays()
        for val, n in zip(hv.tolist(), hl.tolist()):
            enc.write_raw(int(val), int(n))

        ctx, off = build_i_slice_contexts(qp)
        ncw, nch = self.pw // ctb, self.ph // ctb
        left_modes = np.full(nch, I.DC, np.int32)  # per-row left mode

        for ci in range(ncw * nch):
            cy, cx = divmod(ci, ncw)
            cand_a = int(left_modes[cy]) if cx > 0 else I.DC
            mode = _code_intra_cu(enc, ctx, off, y, u, v,
                                  rec_y, rec_u, rec_v,
                                  cx * ctb, cy * ctb, ctb, qp, qp_c,
                                  cand_a)
            left_modes[cy] = mode

            # end_of_slice_segment_flag
            last = ci == ncw * nch - 1
            enc.encode_terminate(1 if last else 0)

        enc.finish()
        enc.align_one()
        self._rec_pad = (rec_y, rec_u, rec_v)
        self.recon = (rec_y[:self.height, :self.width].astype(np.uint8),
                      rec_u[:self.height // 2, :self.width // 2]
                      .astype(np.uint8),
                      rec_v[:self.height // 2, :self.width // 2]
                      .astype(np.uint8))
        return nal_unit(NAL_IDR_W_RADL, enc.to_bytes())


def _code_intra_cu(enc, ctx, off, y, u, v, rec_y, rec_u, rec_v,
                   x0: int, y0: int, ctb: int, qp: int, qp_c: int,
                   cand_a: int, chosen=None) -> int:
    """Code one intra 2Nx2N CU from part_mode onward (mode decision,
    MPM syntax, residual transform tree) and update the recon planes
    in place. cand_a is the left neighbor's luma mode (DC when the
    neighbor is unavailable or not intra). Returns the chosen mode.
    Shared between I-slices and intra CUs inside P-slices — the
    context arrays differ per slice type but the offsets coincide."""

    # --- luma mode decision (SAD over candidate modes); callers that
    # already competed the intra candidates pass the winner in
    src = y[y0:y0 + ctb, x0:x0 + ctb]
    if chosen is not None:
        mode, best_pred = chosen
    else:
        lref = I.ref_samples(rec_y, x0, y0, ctb, avail_tr=True)
        best_mode, best_pred, best_sad = None, None, 1 << 30
        for m in I.CAND_MODES:
            pr = I.predict(m, *lref, ctb, 0)
            sad = int(np.abs(src - pr).sum())
            if sad < best_sad:
                best_mode, best_pred, best_sad = m, pr, sad
        mode = best_mode

    # --- syntax: part_mode, luma mode (MPM), chroma mode (DM)
    enc.encode_bin(ctx, off["part_mode"], 1)    # 2Nx2N
    cand_b = I.DC   # above CU is always in another CTB row
    mpm = _mpm_list(cand_a, cand_b)
    if mode in mpm:
        enc.encode_bin(ctx, off["prev_intra"], 1)
        idx = mpm.index(mode)
        enc.encode_bypass(0 if idx == 0 else 1)
        if idx:
            enc.encode_bypass(idx - 1)
    else:
        enc.encode_bin(ctx, off["prev_intra"], 0)
        rem = mode - sum(1 for m in sorted(mpm) if m < mode)
        enc.encode_bypass_bits(rem, 5)
    enc.encode_bin(ctx, off["chroma_pred"], 0)  # DM mode

    # --- luma residual
    res = src - best_pred
    coef = I.quantize(I.fwd_transform(res), qp)
    cbf_l = 1 if coef.any() else 0
    if cbf_l:
        deq = I.dequantize(coef, qp)
        rconst = I.inv_transform(deq)
        rec = np.clip(best_pred + rconst, 0, 255)
    else:
        rec = np.clip(best_pred, 0, 255)
    rec_y[y0:y0 + ctb, x0:x0 + ctb] = rec

    # --- chroma prediction + residual (DM = luma mode)
    nc = ctb // 2
    cx0, cy0 = x0 // 2, y0 // 2
    ch_out = []
    for plane, recp in ((u, rec_u), (v, rec_v)):
        cref = I.ref_samples(recp, cx0, cy0, nc, avail_tr=True)
        pr = I.predict(mode, *cref, nc, 1)
        srcc = plane[cy0:cy0 + nc, cx0:cx0 + nc]
        coefc = I.quantize(I.fwd_transform(srcc - pr), qp_c)
        cbf = 1 if coefc.any() else 0
        if cbf:
            recc = np.clip(
                pr + I.inv_transform(I.dequantize(coefc, qp_c)),
                0, 255)
        else:
            recc = np.clip(pr, 0, 255)
        recp[cy0:cy0 + nc, cx0:cx0 + nc] = recc
        ch_out.append((cbf, coefc))

    # --- transform tree: cbf_cb, cbf_cr, then TU
    enc.encode_bin(ctx, off["cbf_chroma"], ch_out[0][0])
    enc.encode_bin(ctx, off["cbf_chroma"], ch_out[1][0])
    # cbf_luma ctx 1 (trafoDepth == 0)
    enc.encode_bin(ctx, off["cbf_luma"] + 1, cbf_l)
    if cbf_l:
        encode_residual(enc, ctx, off, coef, 0)
    if ch_out[0][0]:
        encode_residual(enc, ctx, off, ch_out[0][1], 1)
    if ch_out[1][0]:
        encode_residual(enc, ctx, off, ch_out[1][1], 2)
    return mode


# bias applied to the intra SAD when competing against inter: intra
# costs more bits (mode syntax, no MV reuse), so inter wins ties
INTRA_BIAS_NUM, INTRA_BIAS_DEN = 3, 4


class H265GopEncoder:
    """IDR + P-frame HEVC encoder (16x16 CTB/CU/PU, one slice/frame).

    P slices: full-pel motion (inter.motion_search), single reference
    (the previous picture, delta POC 1), skip / merge / AMVP+MVD
    coding decided per CU, intra fallback for scene changes. IDRs are
    coded by the same intra machinery as H265IntraEncoder. The
    reconstruction is the exact decoder output (deblock/SAO disabled),
    validated bit-exact by the libavcodec oracle tests.

    Replaces the reference's external HEVC encoder elements at their
    low-latency P-GOP operating point (reference: pipeline/ *h265*
    pipelines, GOP = 2 s; SURVEY.md §2.2, §2.6).
    """

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, bframes: int = 0):

        self.width, self.height = width, height
        self.bframes = 1 if bframes else 0
        self.params = HevcParams(
            width=width, height=height, qp=qp, pcm_enabled=False,
            deblock=False, tile_rows=False, max_reorder=self.bframes,
            max_dpb_minus1=1 + self.bframes)
        self.qp = qp
        self.qp_c = chroma_qp(qp)
        self.gop = max(1, gop)
        ctb = self.params.ctb
        self.pw = -(-width // ctb) * ctb
        self.ph = -(-height // ctb) * ctb
        self._intra = H265IntraEncoder(width, height, qp=qp)
        # keep the intra coder's parameter sets consistent (reorder/dpb)
        self._intra.params = self.params
        self._ref = None          # previous ref padded recon (y, u, v)
        self._pending = None      # buffered display frame awaiting fwd ref
        self._poc = 0             # next display POC since the last IDR
        self.recon = None

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False):
        """Low-delay entry (bframes == 0): one frame in, one out.
        Returns (data, is_idr)."""
        assert self.bframes == 0, "use push_frame/flush with B frames"
        out = self.push_frame(y, u, v, qp=qp, force_idr=force_idr)
        (data, _, kind, _), = out
        return data, kind == "I"

    def push_frame(self, y, u, v, qp: int | None = None,
                   force_idr: bool = False):
        """Feed one display-order frame; returns a list of
        (data, poc, kind) outputs in coding order (may be empty while
        a B frame waits for its forward reference, or contain two
        entries when a P releases the buffered B)."""

        if qp is not None:
            self.qp, self.qp_c = qp, chroma_qp(qp)
        planes = tuple(np.asarray(p) for p in (y, u, v))

        idr = force_idr or self._ref is None or self._poc >= self.gop
        out = []
        if idr:
            out += self.flush()
            data = self._intra.encode_frame(*planes, qp=self.qp)
            self._ref = self._intra._rec_pad
            self.recon = self._intra.recon
            self._poc = 1
            out.append((data, 0, "I", self.recon))
            return out

        if self.bframes and self._pending is None:
            # buffer the B candidate; coded when its fwd ref exists
            self._pending = (planes, self._poc, self.qp, self.qp_c)
            self._poc += 1
            return out

        if self._pending is not None:
            # this frame is the forward reference: code it as P
            # (ref 2 back), then the buffered B between the two
            bplanes, bpoc, bqp, bqp_c = self._pending
            self._pending = None
            past = self._ref
            data = self._encode_p(*planes, poc=self._poc, ref_delta=2)
            out.append((data, self._poc, "P", self.recon))
            p_recon = self.recon
            bdata, brecon = self._encode_b(*bplanes, ref_past=past,
                                           ref_fut=self._ref, poc=bpoc,
                                           qp=bqp, qp_c=bqp_c)
            out.append((bdata, bpoc, "B", brecon))
            self.recon = p_recon      # last *reference* recon
            self._poc += 1
            return out

        data = self._encode_p(*planes, poc=self._poc, ref_delta=1)
        out.append((data, self._poc, "P", self.recon))
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
        data = self._encode_p(*planes, poc=poc, ref_delta=1)
        self.qp, self.qp_c = sq, sqc
        return [(data, poc, "P", self.recon)]

    def _encode_p(self, y, u, v, poc: int | None = None,
                  ref_delta: int = 1) -> bytes:

        p = self.params
        ctb = p.ctb
        qp, qp_c = self.qp, self.qp_c
        y = _pad(np.asarray(y), self.ph, self.pw).astype(np.int32)
        u = _pad(np.asarray(u), self.ph // 2, self.pw // 2).astype(np.int32)
        v = _pad(np.asarray(v), self.ph // 2, self.pw // 2).astype(np.int32)
        ref_y, ref_u, ref_v = self._ref

        rec_y = np.zeros_like(y)
        rec_u = np.zeros_like(u)
        rec_v = np.zeros_like(v)

        hdr = slice_header_bits(p, idr=False, qp=qp,
                                poc=self._poc if poc is None else poc,
                                ref_poc_delta=ref_delta)
        enc = CabacEncoder()
        hv, hl = hdr.arrays()
        for val, n in zip(hv.tolist(), hl.tolist()):
            enc.write_raw(int(val), int(n))

        ctx, off = build_slice_contexts(qp, init_type=1)
        ncw, nch = self.pw // ctb, self.ph // ctb
        field = MotionField(nch, ncw)
        left_modes = np.full(nch, I.DC, np.int32)   # intra MPM state
        left_intra = np.zeros(nch, bool)

        mvs = motion_search(y, ref_y)               # (nch, ncw, 2) f-pel

        for ci in range(ncw * nch):
            cy, cx = divmod(ci, ncw)
            x0, y0 = cx * ctb, cy * ctb
            src = y[y0:y0 + ctb, x0:x0 + ctb]

            # --- inter candidate: full-pel MV from the frame search
            mv_q = (int(mvs[cy, cx, 0]) * 4, int(mvs[cy, cx, 1]) * 4)
            pred_y = mc_luma_block(ref_y, x0, y0, ctb, mv_q)
            inter_sad = int(np.abs(src - pred_y).sum())

            # --- intra competition (scene-change fallback)
            lref = I.ref_samples(rec_y, x0, y0, ctb, avail_tr=True)
            ibest, ipred, intra_sad = None, None, 1 << 30
            for m in I.CAND_MODES:
                pr = I.predict(m, *lref, ctb, 0)
                sad = int(np.abs(src - pr).sum())
                if sad < intra_sad:
                    ibest, ipred, intra_sad = m, pr, sad
            use_intra = (intra_sad * INTRA_BIAS_DEN
                         < inter_sad * INTRA_BIAS_NUM)

            skip_l = bool(field.skip[cy, cx - 1]) if cx > 0 else False
            skip_a = bool(field.skip[cy - 1, cx]) if cy > 0 else False
            skip_ctx = off["skip"] + int(skip_l) + int(skip_a)

            if use_intra:
                enc.encode_bin(ctx, skip_ctx, 0)    # cu_skip_flag
                enc.encode_bin(ctx, off["pred_mode"], 1)  # MODE_INTRA
                cand_a = (int(left_modes[cy])
                          if cx > 0 and left_intra[cy] else I.DC)
                mode = _code_intra_cu(enc, ctx, off, y, u, v,
                                      rec_y, rec_u, rec_v,
                                      x0, y0, ctb, qp, qp_c, cand_a,
                                      chosen=(ibest, ipred))
                left_modes[cy] = mode
                left_intra[cy] = True
                enc.encode_terminate(0 if ci < ncw * nch - 1 else 1)
                continue

            # --- inter residuals at the chosen MV
            nc = ctb // 2
            cx0, cy0 = x0 // 2, y0 // 2
            pred_u = mc_chroma_block(ref_u, cx0, cy0, nc, mv_q)
            pred_v = mc_chroma_block(ref_v, cx0, cy0, nc, mv_q)
            coef_l = I.quantize(I.fwd_transform(src - pred_y), qp)
            coef_b = I.quantize(I.fwd_transform(
                u[cy0:cy0 + nc, cx0:cx0 + nc] - pred_u), qp_c)
            coef_r = I.quantize(I.fwd_transform(
                v[cy0:cy0 + nc, cx0:cx0 + nc] - pred_v), qp_c)
            cbf_l = 1 if coef_l.any() else 0
            cbf_b = 1 if coef_b.any() else 0
            cbf_r = 1 if coef_r.any() else 0
            any_cbf = cbf_l or cbf_b or cbf_r

            merge = field.merge_list(cy, cx)
            try:
                merge_idx = merge.index(mv_q)
            except ValueError:
                merge_idx = -1

            if merge_idx >= 0 and not any_cbf:
                # --- skip CU
                enc.encode_bin(ctx, skip_ctx, 1)    # cu_skip_flag
                enc.encode_bin(ctx, off["merge_idx"], merge_idx)
                field.skip[cy, cx] = True
            else:
                enc.encode_bin(ctx, skip_ctx, 0)    # cu_skip_flag
                enc.encode_bin(ctx, off["pred_mode"], 0)  # MODE_INTER
                enc.encode_bin(ctx, off["part_mode"], 1)  # 2Nx2N
                if merge_idx >= 0:
                    # merge (rqt_root_cbf inferred 1; any_cbf holds)
                    enc.encode_bin(ctx, off["merge_flag"], 1)
                    enc.encode_bin(ctx, off["merge_idx"], merge_idx)
                else:
                    enc.encode_bin(ctx, off["merge_flag"], 0)
                    # (no inter_pred_idc in P; no ref_idx with 1 ref)
                    amvp = field.amvp_list(cy, cx)
                    costs = [abs(mv_q[0] - c[0]) + abs(mv_q[1] - c[1])
                             for c in amvp]
                    mvp_idx = 0 if costs[0] <= costs[1] else 1
                    mvp = amvp[mvp_idx]
                    encode_mvd(enc, ctx, off,
                               mv_q[1] - mvp[1], mv_q[0] - mvp[0])
                    enc.encode_bin(ctx, off["mvp_flag"], mvp_idx)
                    enc.encode_bin(ctx, off["rqt_root_cbf"],
                                   1 if any_cbf else 0)
                if any_cbf:
                    # transform tree, depth 0, no split
                    enc.encode_bin(ctx, off["cbf_chroma"], cbf_b)
                    enc.encode_bin(ctx, off["cbf_chroma"], cbf_r)
                    if cbf_b or cbf_r:
                        # cbf_luma explicit (else inferred 1)
                        enc.encode_bin(ctx, off["cbf_luma"] + 1, cbf_l)
                    if cbf_l:
                        encode_residual(enc, ctx, off, coef_l, 0)
                    if cbf_b:
                        encode_residual(enc, ctx, off, coef_b, 1)
                    if cbf_r:
                        encode_residual(enc, ctx, off, coef_r, 2)

            # --- reconstruction
            rec = pred_y if not cbf_l else np.clip(
                pred_y + I.inv_transform(I.dequantize(coef_l, qp)),
                0, 255)
            rec_y[y0:y0 + ctb, x0:x0 + ctb] = np.clip(rec, 0, 255)
            rec_u[cy0:cy0 + nc, cx0:cx0 + nc] = np.clip(
                pred_u if not cbf_b else
                pred_u + I.inv_transform(I.dequantize(coef_b, qp_c)),
                0, 255)
            rec_v[cy0:cy0 + nc, cx0:cx0 + nc] = np.clip(
                pred_v if not cbf_r else
                pred_v + I.inv_transform(I.dequantize(coef_r, qp_c)),
                0, 255)

            field.inter[cy, cx] = True
            field.mv[cy, cx] = mv_q
            left_intra[cy] = False

            enc.encode_terminate(0 if ci < ncw * nch - 1 else 1)

        enc.finish()
        enc.align_one()
        self._ref = (rec_y, rec_u, rec_v)
        self.recon = (rec_y[:self.height, :self.width].astype(np.uint8),
                      rec_u[:self.height // 2, :self.width // 2]
                      .astype(np.uint8),
                      rec_v[:self.height // 2, :self.width // 2]
                      .astype(np.uint8))
        return nal_unit(NAL_TRAIL_R, enc.to_bytes())

    def _encode_b(self, y, u, v, ref_past, ref_fut, poc: int,
                  qp: int, qp_c: int):
        """TRAIL_N B-slice: every inter CU bi-predicted (list0 = the
        past reference, list1 = the future one, both POC distance 1),
        explicit dual MVD + AMVP — with every neighbor bi-predicted
        the same-reference AMVP pass always succeeds, so the spec's MV
        scaling clauses never trigger (inter.py module docstring).
        Intra fallback per CU. Returns (nal_bytes, display_recon)."""

        p = self.params
        ctb = p.ctb
        y = _pad(np.asarray(y), self.ph, self.pw).astype(np.int32)
        u = _pad(np.asarray(u), self.ph // 2, self.pw // 2).astype(np.int32)
        v = _pad(np.asarray(v), self.ph // 2, self.pw // 2).astype(np.int32)
        r0y, r0u, r0v = ref_past
        r1y, r1u, r1v = ref_fut

        rec_y = np.zeros_like(y)
        rec_u = np.zeros_like(u)
        rec_v = np.zeros_like(v)

        hdr = slice_header_bits(p, idr=False, qp=qp, poc=poc,
                                slice_type="B", ref_poc_delta=1,
                                fwd_poc_delta=1)
        enc = CabacEncoder()
        hv, hl = hdr.arrays()
        for val, n in zip(hv.tolist(), hl.tolist()):
            enc.write_raw(int(val), int(n))

        ctx, off = build_slice_contexts(qp, init_type=2)
        ncw, nch = self.pw // ctb, self.ph // ctb
        f0 = MotionField(nch, ncw)     # list-0 motion (all CUs BI)
        f1 = MotionField(nch, ncw)     # list-1 motion
        left_modes = np.full(nch, I.DC, np.int32)
        left_intra = np.zeros(nch, bool)

        mv0s = motion_search(y, r0y)
        mv1s = motion_search(y, r1y)

        for ci in range(ncw * nch):
            cy, cx = divmod(ci, ncw)
            x0, y0 = cx * ctb, cy * ctb
            src = y[y0:y0 + ctb, x0:x0 + ctb]
            nc = ctb // 2
            cx0, cy0 = x0 // 2, y0 // 2

            mv0 = (int(mv0s[cy, cx, 0]) * 4, int(mv0s[cy, cx, 1]) * 4)
            mv1 = (int(mv1s[cy, cx, 0]) * 4, int(mv1s[cy, cx, 1]) * 4)
            p0y = mc_luma_block14(r0y, x0, y0, ctb, mv0)
            p1y = mc_luma_block14(r1y, x0, y0, ctb, mv1)
            pred_y = bi_combine(p0y, p1y)
            inter_sad = int(np.abs(src - pred_y).sum())

            lref = I.ref_samples(rec_y, x0, y0, ctb, avail_tr=True)
            ibest, ipred, intra_sad = None, None, 1 << 30
            for m in I.CAND_MODES:
                pr = I.predict(m, *lref, ctb, 0)
                sad = int(np.abs(src - pr).sum())
                if sad < intra_sad:
                    ibest, ipred, intra_sad = m, pr, sad
            use_intra = (intra_sad * INTRA_BIAS_DEN
                         < inter_sad * INTRA_BIAS_NUM)

            # cu_skip ctx from neighbor skip flags (no skips coded)
            skip_ctx = off["skip"]
            enc.encode_bin(ctx, skip_ctx, 0)    # cu_skip_flag

            if use_intra:
                enc.encode_bin(ctx, off["pred_mode"], 1)  # MODE_INTRA
                cand_a = (int(left_modes[cy])
                          if cx > 0 and left_intra[cy] else I.DC)
                mode = _code_intra_cu(enc, ctx, off, y, u, v,
                                      rec_y, rec_u, rec_v,
                                      x0, y0, ctb, qp, qp_c, cand_a,
                                      chosen=(ibest, ipred))
                left_modes[cy] = mode
                left_intra[cy] = True
                enc.encode_terminate(0 if ci < ncw * nch - 1 else 1)
                continue

            pred_u = bi_combine(
                mc_chroma_block14(r0u, cx0, cy0, nc, mv0),
                mc_chroma_block14(r1u, cx0, cy0, nc, mv1))
            pred_v = bi_combine(
                mc_chroma_block14(r0v, cx0, cy0, nc, mv0),
                mc_chroma_block14(r1v, cx0, cy0, nc, mv1))
            coef_l = I.quantize(I.fwd_transform(src - pred_y), qp)
            coef_b = I.quantize(I.fwd_transform(
                u[cy0:cy0 + nc, cx0:cx0 + nc] - pred_u), qp_c)
            coef_r = I.quantize(I.fwd_transform(
                v[cy0:cy0 + nc, cx0:cx0 + nc] - pred_v), qp_c)
            cbf_l = 1 if coef_l.any() else 0
            cbf_b = 1 if coef_b.any() else 0
            cbf_r = 1 if coef_r.any() else 0
            any_cbf = cbf_l or cbf_b or cbf_r

            enc.encode_bin(ctx, off["pred_mode"], 0)  # MODE_INTER
            enc.encode_bin(ctx, off["part_mode"], 1)  # 2Nx2N
            enc.encode_bin(ctx, off["merge_flag"], 0)
            # inter_pred_idc = PRED_BI: bin0 = 1, ctx by CtDepth (0)
            enc.encode_bin(ctx, off["inter_pred_idc"], 1)
            for lx, (mv, field) in enumerate(((mv0, f0), (mv1, f1))):
                amvp = field.amvp_list(cy, cx)
                costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1])
                         for c in amvp]
                mvp_idx = 0 if costs[0] <= costs[1] else 1
                mvp = amvp[mvp_idx]
                encode_mvd(enc, ctx, off,
                           mv[1] - mvp[1], mv[0] - mvp[0])
                enc.encode_bin(ctx, off["mvp_flag"], mvp_idx)
            enc.encode_bin(ctx, off["rqt_root_cbf"],
                           1 if any_cbf else 0)
            if any_cbf:
                enc.encode_bin(ctx, off["cbf_chroma"], cbf_b)
                enc.encode_bin(ctx, off["cbf_chroma"], cbf_r)
                if cbf_b or cbf_r:
                    enc.encode_bin(ctx, off["cbf_luma"] + 1, cbf_l)
                if cbf_l:
                    encode_residual(enc, ctx, off, coef_l, 0)
                if cbf_b:
                    encode_residual(enc, ctx, off, coef_b, 1)
                if cbf_r:
                    encode_residual(enc, ctx, off, coef_r, 2)

            rec_y[y0:y0 + ctb, x0:x0 + ctb] = np.clip(
                pred_y if not cbf_l else
                pred_y + I.inv_transform(I.dequantize(coef_l, qp)),
                0, 255)
            rec_u[cy0:cy0 + nc, cx0:cx0 + nc] = np.clip(
                pred_u if not cbf_b else
                pred_u + I.inv_transform(I.dequantize(coef_b, qp_c)),
                0, 255)
            rec_v[cy0:cy0 + nc, cx0:cx0 + nc] = np.clip(
                pred_v if not cbf_r else
                pred_v + I.inv_transform(I.dequantize(coef_r, qp_c)),
                0, 255)

            f0.inter[cy, cx] = True
            f0.mv[cy, cx] = mv0
            f1.inter[cy, cx] = True
            f1.mv[cy, cx] = mv1
            left_intra[cy] = False

            enc.encode_terminate(0 if ci < ncw * nch - 1 else 1)

        enc.finish()
        enc.align_one()
        recon = (rec_y[:self.height, :self.width].astype(np.uint8),
                 rec_u[:self.height // 2, :self.width // 2]
                 .astype(np.uint8),
                 rec_v[:self.height // 2, :self.width // 2]
                 .astype(np.uint8))
        return nal_unit(NAL_TRAIL_N, enc.to_bytes()), recon


class H265AppEncoder:
    """Adapter matching the H264Encoder surface the app loop drives
    (encode_frame -> EncodedFrame-like with .data/.keyframe/.qp);
    IDR + P GOP structure via H265GopEncoder."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 fps_num: int = 0, fps_den: int = 1, gop: int = 60,
                 **_ignored):
        self._enc = H265GopEncoder(width, height, qp=qp,
                                   gop=max(1, gop))
        self.qp = qp

    def headers(self) -> bytes:
        return self._enc.headers()

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False):
        qp = self.qp if qp is None else qp
        data, idr = self._enc.encode_frame(y, u, v, qp=qp,
                                           force_idr=force_idr)

        class _F:
            pass

        f = _F()
        f.data = data
        f.keyframe = idr
        f.qp = qp
        f.recon = self._enc.recon
        return f


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
