"""H.264 CABAC entropy stage (spec 9.3): context-coded slice data for
the row-slice encoder.

The binary arithmetic engine is shared with HEVC
(codec/h265/cabac.CabacEncoder): H.264 and HEVC use the same M-coder —
identical rangeTabLPS, state machine, renormalization, and termination
(HEVC spec 9.3.4 is the H.264 9.3.4 engine) — only the context
initialization input differs: H.264 supplies (m, n) pairs per ctxIdx
(cabac_init_tables.py, extracted from libavcodec's normative tables)
instead of HEVC's packed initValue. Note libavcodec's .rodata lays the
four init tables out [PB0][PB1][PB2][I] — and the I table stores 0 for
contexts I slices never touch (11..23); the extractor identifies each
block by its mb_skip ctx-11 content, never by position.

Validated two ways against the reference entropy coder: (a) the decode
twin (cabac_dec.H264SliceParser) walks real libx264 streams over the
full MB repertoire to exact byte consumption, and (b) multi-MB,
multi-frame streams from this encoder reconstruct bit-exact through
the libavcodec oracle (tests/test_h264_cabac.py).

Slice model: one slice per MB row (the encoder's schedule, matching
the CAVLC path and HEVC rowslice.py) — so every "above" neighbor is
outside the slice and unavailable by 6.4.9; context derivations
(mb_type condTerm, cbf, mvd sums, skip flags) reduce to the left
neighbor. This is what makes rows independently encodable (SURVEY.md
§2.7 tile-row parallelism).

Covers the encoder's MB repertoire: I slices with Intra_16x16 and
Intra_4x4 luma, P slices with P_L0_16x16 / P_Skip and intra fallback
MBs. Replaces the entropy of the reference's x264enc CABAC mode
(reference: bindings/typescript/src/pipeline/generic-builder.ts:49-55,
`x264enc` with default cabac=true).

Copy of ceracoder_tpu/codec/h264/cabac.py: the port keeps its own copy
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.h264.cabac_init_tables import (
    CABAC_INIT_I,
    CABAC_INIT_PB,
)
from ceracoder_tpu_torch.codec.h264.device_entropy import LUMA_SNAKE
from ceracoder_tpu_torch.codec.h265.tables import LPS_TABLE, NEXT_STATE


class H264ArithEncoder:
    """H.264 arithmetic engine, direct transcription of spec
    9.3.4.3-9.3.4.6 (10-bit codILow register, PutBit with
    bitsOutstanding carry resolution, and the H.264 EncodeFlush).

    The bin coding and renormalization are the same M-coder HEVC
    uses (shared LPS_TABLE / NEXT_STATE), but H.264's FLUSH differs:
    it emits exactly the top 9 window bits plus a forced '1' (the
    rbsp stop bit is part of the flush), where HEVC's HM-style
    finish() dumps the whole pending low. Validated byte-exact
    against libx264 CABAC output."""

    def __init__(self) -> None:
        self.low = 0
        self.range = 510
        self.first = True            # firstBitFlag (9.3.4.4)
        self.outstanding = 0
        self._bits: list[int] = []

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False       # leading bit is discarded
        else:
            self._bits.append(b)
        while self.outstanding:
            self._bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.range <<= 1
            self.low <<= 1

    def encode_bin(self, ctx: np.ndarray, idx: int,
                   binval: int) -> None:
        state = int(ctx[idx])
        ps = state >> 1
        mps = state & 1
        lps = int(LPS_TABLE[ps][(self.range >> 6) & 3])
        self.range -= lps
        if binval != mps:
            self.low += self.range
            self.range = lps
        ctx[idx] = NEXT_STATE[state][binval]
        self._renorm()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.range = 2
        self._renorm()

    def flush(self) -> bytes:
        """Final end_of_slice_flag = 1 plus EncodeFlush (9.3.4.5-6).

        The terminate's interval join (low += range-2) is applied
        without renormalization, the rbsp stop bit is set at the
        window LSB, and the WHOLE 10-bit low window is emitted (with
        carry resolution) — the decoder needs the full window to
        resolve the final terminate; bits after the stop bit within
        the emitted window tail are don't-care (x264 even stuffs a
        watermark pattern there), as is the zero padding to the byte
        boundary. Validated byte-exact (modulo don't-care tail)
        against libx264 output."""
        self.range -= 2
        self.low += self.range
        self.low |= 1
        for k in range(9, -1, -1):
            self._put((self.low >> k) & 1)
        bits = self._bits
        pad = (-len(bits)) % 8
        bits = bits + [0] * pad
        out = bytearray()
        for i in range(0, len(bits), 8):
            acc = 0
            for b in bits[i:i + 8]:
                acc = (acc << 1) | b
            out.append(acc)
        return bytes(out)

# zig-zag scan of a 4x4 block (spec Table 8-13, frame coding)
ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14,
                    15], np.int32)

# ctxBlockCat residual context offsets (Tables 9-40):
#   cat 0 Intra16 DC, 1 Intra16 AC, 2 luma 4x4, 3 chroma DC,
#   cat 4 chroma AC
_CBF_BASE = {0: 85, 1: 89, 2: 93, 3: 97, 4: 101}
_SIG_BASE = {0: 105, 1: 120, 2: 134, 3: 149, 4: 152}
_LAST_BASE = {0: 166, 1: 181, 2: 195, 3: 210, 4: 213}
_ABS_BASE = {0: 227, 1: 237, 2: 247, 3: 257, 4: 266}
_MAXNUMCOEFF = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15}


def init_contexts(slice_qp: int, intra: bool,
                  cabac_init_idc: int = 0) -> np.ndarray:
    """Packed context states for a slice (spec 9.3.1.1)."""
    tab = CABAC_INIT_I if intra else CABAC_INIT_PB[cabac_init_idc]
    qp = min(max(slice_qp, 0), 51)
    ctx = np.empty(1024, np.uint8)
    for i, (m, n) in enumerate(tab):
        pre = min(max(((m * qp) >> 4) + n, 1), 126)
        if pre <= 63:
            ctx[i] = ((63 - pre) << 1) | 0
        else:
            ctx[i] = ((pre - 64) << 1) | 1
    return ctx


class H264RowCabac:
    """CABAC encoder for one MB-row slice.

    Call the mb_* methods in macroblock order, then end_of_slice after
    each MB; finish() returns the slice-data bytes (to append after
    the byte-aligned slice header)."""

    def __init__(self, slice_qp: int, intra_slice: bool,
                 cabac_init_idc: int = 0) -> None:
        self.enc = H264ArithEncoder()
        self.ctx = init_contexts(slice_qp, intra_slice, cabac_init_idc)
        self.intra_slice = intra_slice
        # left-neighbor state (None at row start = unavailable)
        self.left: dict | None = None
        self.prev_qp_delta = 0
        self.prev_skip = False

    # -- helpers ---------------------------------------------------------
    def _bin(self, idx: int, b: int) -> None:
        self.enc.encode_bin(self.ctx, idx, b)

    def _bypass(self, b: int) -> None:
        self.enc.encode_bypass(b)

    def _unary(self, val: int, idx0: int, idx_rest: int,
               idx1: int | None = None) -> None:
        """TU binarization: val ones then a zero; first bin at idx0,
        second at idx1 (defaults to idx_rest), rest at idx_rest."""
        if val == 0:
            self._bin(idx0, 0)
            return
        self._bin(idx0, 1)
        second = idx_rest if idx1 is None else idx1
        for k in range(1, val):
            self._bin(second if k == 1 else idx_rest, 1)
        self._bin(second if val == 1 else idx_rest, 0)

    # -- mb_qp_delta (spec 9.3.2.7 mapping + ctx 60..63) -----------------
    def _qp_delta(self, dqp: int) -> None:
        mapped = 2 * abs(dqp) - (1 if dqp > 0 else 0)
        idx0 = 60 + (1 if self.prev_qp_delta != 0 else 0)
        if mapped == 0:
            self._bin(idx0, 0)
        else:
            self._bin(idx0, 1)
            for k in range(1, mapped):
                self._bin(62 if k == 1 else 63, 1)
            self._bin(62 if mapped == 1 else 63, 0)
        self.prev_qp_delta = dqp

    # -- residual block (spec 9.3.2.6 / residual_block_cabac) ------------
    def _residual(self, cat: int, coeffs: np.ndarray,
                  cbf_ctx_inc: int | None) -> None:
        """coeffs in scan order (DC-first zig-zag already applied by
        the caller), length maxNumCoeff for the category. Writes
        coded_block_flag (unless cat needs none — always coded here),
        significance map, and levels."""
        n = len(coeffs)
        nz = np.nonzero(coeffs)[0]
        if cbf_ctx_inc is not None:
            self._bin(_CBF_BASE[cat] + cbf_ctx_inc, 1 if len(nz) else 0)
            if not len(nz):
                return
        last = int(nz[-1])
        sig_base = _SIG_BASE[cat]
        last_base = _LAST_BASE[cat]
        for i in range(min(last + 1, n - 1)):
            sig = 1 if coeffs[i] else 0
            inc = i if cat != 3 else min(i, 3)
            self._bin(sig_base + inc, sig)
            if sig:
                self._bin(last_base + inc, 1 if i == last else 0)
        # levels in reverse scan order (spec 7.4.5.3.3 parse order);
        # coeff_abs_level_minus1 is UEG0 with uCoff=14 (9.3.2.3)
        gt1_seen = 0   # numDecodAbsLevelGt1
        eq1_seen = 0   # numDecodAbsLevelEq1
        abs_base = _ABS_BASE[cat]
        for i in nz[::-1]:
            lvl = int(coeffs[i])
            v = abs(lvl) - 1
            idx0 = abs_base + (0 if gt1_seen
                               else min(4, 1 + eq1_seen))
            rest_idx = abs_base + 5 + min(
                3 if cat == 3 else 4, gt1_seen)
            if v == 0:
                self._bin(idx0, 0)
                eq1_seen += 1
            else:
                self._bin(idx0, 1)
                if v < 14:
                    for _ in range(v - 1):
                        self._bin(rest_idx, 1)
                    self._bin(rest_idx, 0)
                else:          # 14 prefix ones, no terminator, EG0
                    for _ in range(13):
                        self._bin(rest_idx, 1)
                    self._eg0_bypass(v - 14)
                gt1_seen += 1
            self._bypass(1 if lvl < 0 else 0)

    def _eg0_bypass(self, v: int) -> None:
        """Exp-Golomb order 0 in bypass (UEG0 suffix, 9.3.2.3)."""
        vv = v + 1
        nbits = vv.bit_length()
        for _ in range(nbits - 1):
            self._bypass(1)
        self._bypass(0)
        for i in range(nbits - 2, -1, -1):
            self._bypass((vv >> i) & 1)

    # -- public MB coders ------------------------------------------------
    def mb_i16(self, mode_l: int, mode_c: int, dqp: int,
               cbp_luma: int, cbp_chroma: int,
               dc: np.ndarray, acs: np.ndarray,
               cdc: np.ndarray, cacs: np.ndarray) -> None:
        """Intra_16x16 macroblock. dc (16,) luma DC in scan order;
        acs (16, 15) AC blocks in luma4x4BlkIdx (snake) order;
        cdc (2, 4) chroma DC; cacs (2, 4, 15) chroma AC blocks in
        raster order per component."""
        lt = self.left
        if not self.intra_slice:
            # mb_skip_flag == 0 (ctx 11..13; condTerm = available and
            # not skipped; above row is outside the slice)
            inc = 1 if (lt is not None and not lt["skip"]) else 0
            self._bin(11 + inc, 0)
        # mb_type: prefix for intra-in-P uses ctx 17..24 with fixed
        # suffix contexts; in I slices ctx 3..10 with neighbor ctx
        if self.intra_slice:
            inc = ((1 if (lt is not None and lt["mbt_not_inxn"])
                    else 0)
                   + 0)                         # above: unavailable
            self._bin(3 + inc, 1)               # not I_NxN
            self.enc.encode_terminate(0)        # not I_PCM
            self._bin(6, 1 if cbp_luma else 0)
            if cbp_chroma == 0:
                self._bin(7, 0)
            else:
                self._bin(7, 1)
                self._bin(8, 1 if cbp_chroma == 2 else 0)
            self._bin(9, (mode_l >> 1) & 1)
            self._bin(10, mode_l & 1)
        else:
            self._bin(14, 1)                    # intra prefix in P
            self._bin(17, 1)                    # not I_NxN
            self.enc.encode_terminate(0)        # not I_PCM
            self._bin(18, 1 if cbp_luma else 0)
            if cbp_chroma == 0:
                self._bin(19, 0)
            else:
                self._bin(19, 1)
                self._bin(19, 1 if cbp_chroma == 2 else 0)
            self._bin(20, (mode_l >> 1) & 1)
            self._bin(20, mode_l & 1)
        self._chroma_pred_mode(mode_c)
        self._qp_delta(dqp)

        luma_cbf = np.zeros((4, 4), np.int64)
        # Intra16x16 DC (cat 0): neighbor = left MB's DC cbf when it
        # is also Intra_16x16; unavailable MB + intra current => 1
        if lt is None:
            ca = 1
        elif lt["intra16"]:
            ca = lt["dc_cbf"]
        else:
            ca = 0
        cb = 1                                  # above row: intra MB
        dc_cbf = 1 if (dc != 0).any() else 0
        self._residual(0, dc, ca + 2 * cb)
        if cbp_luma:
            self._luma_blocks(1, acs, luma_cbf, lt, intra=True)
        self._chroma_residual(cbp_chroma, cdc, cacs, lt, intra=True)
        self.left = {
            "skip": False, "intra": True, "intra16": True,
            "mbt_not_inxn": True, "dc_cbf": dc_cbf,
            "luma_cbf": luma_cbf, "mvd": (0, 0),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": self._last_cdc_cbf, "cac_cbf": self._last_cac,
            "chroma_nz": mode_c != 0,
        }

    def mb_i4(self, modes: np.ndarray, pred_flags: np.ndarray,
              mode_c: int, dqp: int, cbp_luma: int, cbp_chroma: int,
              blocks: np.ndarray, cdc: np.ndarray,
              cacs: np.ndarray) -> None:
        """Intra_4x4 macroblock. modes (16,) chosen modes in snake
        order; pred_flags (16,) 1 where prev_intra4x4_pred_mode_flag
        (mode == predicted); blocks (16, 16) full 4x4 residuals in
        snake order."""
        lt = self.left
        if not self.intra_slice:
            inc = 1 if (lt is not None and not lt["skip"]) else 0
            self._bin(11 + inc, 0)
        if self.intra_slice:
            inc = (1 if (lt is not None and lt["mbt_not_inxn"])
                   else 0)
            self._bin(3 + inc, 0)               # I_NxN
        else:
            self._bin(14, 1)
            self._bin(17, 0)                    # I_NxN
        # prev_intra4x4_pred_mode_flag / rem (ctx 68 / 69)
        for b in range(16):
            if pred_flags[b]:
                self._bin(68, 1)
            else:
                self._bin(68, 0)
                rem = int(modes[b])
                self._bin(69, rem & 1)
                self._bin(69, (rem >> 1) & 1)
                self._bin(69, (rem >> 2) & 1)
        self._chroma_pred_mode(mode_c)
        self._cbp(cbp_luma, cbp_chroma, lt)
        if cbp_luma or cbp_chroma:
            self._qp_delta(dqp)
        else:
            self.prev_qp_delta = 0
        luma_cbf = np.zeros((4, 4), np.int64)
        if cbp_luma:
            self._luma_blocks(2, blocks, luma_cbf, lt, intra=True,
                              cbp_luma=cbp_luma)
        self._chroma_residual(cbp_chroma, cdc, cacs, lt, intra=True)
        self.left = {
            "skip": False, "intra": True, "intra16": False,
            "mbt_not_inxn": False, "dc_cbf": 0,
            "luma_cbf": luma_cbf, "mvd": (0, 0),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": self._last_cdc_cbf, "cac_cbf": self._last_cac,
            "chroma_nz": mode_c != 0,
        }

    def mb_p16(self, mvd: tuple, dqp: int, cbp_luma: int,
               cbp_chroma: int, blocks: np.ndarray, cdc: np.ndarray,
               cacs: np.ndarray) -> None:
        """P_L0_16x16 macroblock. mvd (dy, dx) quarter-pel deltas;
        blocks (16, 16) full 4x4 residuals in snake order."""
        lt = self.left
        inc = 1 if (lt is not None and not lt["skip"]) else 0
        self._bin(11 + inc, 0)                  # mb_skip_flag = 0
        self._bin(14, 0)                        # mb_type P_L0_16x16
        self._bin(15, 0)
        self._bin(16, 0)
        # mvd (ctx 40..46 x, 47..53 y), UEG3 uCoff=9: component order
        # x then y in the bitstream (mvd_l0[..][..][0] is x)
        dy, dx = mvd
        self._mvd(dx, 40, 0 if lt is None else abs(lt["mvd"][1]))
        self._mvd(dy, 47, 0 if lt is None else abs(lt["mvd"][0]))
        self._cbp(cbp_luma, cbp_chroma, lt)
        if cbp_luma or cbp_chroma:
            self._qp_delta(dqp)
        else:
            self.prev_qp_delta = 0
        luma_cbf = np.zeros((4, 4), np.int64)
        if cbp_luma:
            self._luma_blocks(2, blocks, luma_cbf, lt, intra=False,
                              cbp_luma=cbp_luma)
        self._chroma_residual(cbp_chroma, cdc, cacs, lt, intra=False)
        self.left = {
            "skip": False, "intra": False, "intra16": False,
            "mbt_not_inxn": True, "dc_cbf": 0,
            "luma_cbf": luma_cbf, "mvd": (dy, dx),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": self._last_cdc_cbf, "cac_cbf": self._last_cac,
            "chroma_nz": False,
        }

    def mb_skip(self) -> None:
        lt = self.left
        inc = 1 if (lt is not None and not lt["skip"]) else 0
        self._bin(11 + inc, 1)
        self.left = {
            "skip": True, "intra": False, "intra16": False,
            "mbt_not_inxn": True, "dc_cbf": 0,
            "luma_cbf": np.zeros((4, 4), np.int64), "mvd": (0, 0),
            "cbp_luma": 0, "cbp_chroma": 0,
            "cdc_cbf": [0, 0],
            "cac_cbf": np.zeros((2, 2, 2), np.int64),
            "chroma_nz": False,
        }
        self.prev_qp_delta = 0

    # -- shared sub-coders ----------------------------------------------
    def _chroma_pred_mode(self, mode_c: int) -> None:
        lt = self.left
        inc = 1 if (lt is not None and lt["intra"]
                    and lt["chroma_nz"]) else 0
        if mode_c == 0:
            self._bin(64 + inc, 0)
        else:
            self._bin(64 + inc, 1)
            if mode_c == 1:
                self._bin(67, 0)
            else:
                self._bin(67, 1)
                self._bin(67, 1 if mode_c == 3 else 0)

    def _mvd(self, v: int, base: int, left_abs: int) -> None:
        """UEG3 with uCoff=9; prefix ctx base..base+6 (9.3.3.1.1.7:
        above row unavailable => absMvdSum = |mvd| of the left MB)."""
        s = left_abs
        inc = 0 if s < 3 else (2 if s > 32 else 1)
        a = abs(v)
        prefix = min(a, 9)
        if prefix == 0:
            self._bin(base + inc, 0)
            return
        self._bin(base + inc, 1)
        for k in range(1, prefix):
            self._bin(base + 2 + min(k, 4), 1)
        if prefix < 9:
            self._bin(base + 2 + min(prefix, 4), 0)
        else:
            # EG3 suffix in bypass
            vv = a - 9
            k = 3
            while vv >= (1 << k):
                self._bypass(1)
                vv -= 1 << k
                k += 1
            self._bypass(0)
            for i in range(k - 1, -1, -1):
                self._bypass((vv >> i) & 1)
        self._bypass(1 if v < 0 else 0)

    def _cbp(self, cbp_luma: int, cbp_chroma: int,
             lt: dict | None) -> None:
        """coded_block_pattern: 4 luma bins (ctx 73..76) + up to 2
        chroma bins (ctx 77..84). condTerm = neighbor 8x8 bit == 0
        (luma) / neighbor cbp_chroma != 0 and == 2 (chroma bins);
        unavailable => 0 (above row always unavailable here)."""
        for b in range(4):
            if b & 1:                           # left 8x8 in same MB
                ca = 1 - ((cbp_luma >> (b - 1)) & 1)
            elif lt is not None:
                ca = 1 - ((lt["cbp_luma"] >> (b + 1)) & 1)
            else:
                ca = 0
            if b >= 2:                          # above 8x8 in same MB
                cb = 1 - ((cbp_luma >> (b - 2)) & 1)
            else:
                cb = 0
            self._bin(73 + ca + 2 * cb, (cbp_luma >> b) & 1)
        ca = 1 if (lt is not None and lt["cbp_chroma"] != 0) else 0
        self._bin(77 + ca, 1 if cbp_chroma else 0)
        if cbp_chroma:
            ca = 1 if (lt is not None and lt["cbp_chroma"] == 2) else 0
            self._bin(81 + ca, 1 if cbp_chroma == 2 else 0)

    def _luma_blocks(self, cat: int, blocks: np.ndarray,
                     luma_cbf: np.ndarray, lt: dict | None,
                     intra: bool, cbp_luma: int = 15) -> None:
        """Luma residual blocks in snake order; cat 1 (AC, 15 coeffs)
        or 2 (full 4x4, 16 coeffs). Fills luma_cbf (4, 4) raster grid
        for the next MB's contexts."""
        for b in range(16):
            r, c = int(LUMA_SNAKE[b][0]), int(LUMA_SNAKE[b][1])
            q = (r // 2) * 2 + (c // 2)
            if not ((cbp_luma >> q) & 1):
                continue
            if c > 0:
                ca = luma_cbf[r, c - 1]
            elif lt is not None:
                ca = lt["luma_cbf"][r, 3]
            else:
                ca = 1 if intra else 0
            if r > 0:
                cb = luma_cbf[r - 1, c]
            else:
                cb = 1 if intra else 0          # above row outside
            coeffs = blocks[b]
            cbf = 1 if (coeffs != 0).any() else 0
            luma_cbf[r, c] = cbf
            self._residual(cat, coeffs, ca + 2 * cb)

    def _chroma_residual(self, cbp_chroma: int, cdc: np.ndarray,
                         cacs: np.ndarray, lt: dict | None,
                         intra: bool) -> None:
        """Chroma DC (cat 3) + AC (cat 4) blocks. cdc (2, 4); cacs
        (2, 4, 15) per-component raster 2x2."""
        self._last_cdc_cbf = [0, 0]
        self._last_cac = np.zeros((2, 2, 2), np.int64)
        if cbp_chroma == 0:
            return
        for comp in range(2):
            if lt is not None:
                ca = lt["cdc_cbf"][comp]
            else:
                ca = 1 if intra else 0
            cb = 1 if intra else 0              # above row outside
            coeffs = cdc[comp]
            self._last_cdc_cbf[comp] = 1 if (coeffs != 0).any() else 0
            self._residual(3, coeffs, ca + 2 * cb)
        if cbp_chroma == 2:
            for comp in range(2):
                for b in range(4):
                    r, c = b // 2, b % 2
                    if c > 0:
                        ca = self._last_cac[comp, r, c - 1]
                    elif lt is not None:
                        ca = lt["cac_cbf"][comp, r, 1]
                    else:
                        ca = 1 if intra else 0
                    if r > 0:
                        cb = self._last_cac[comp, r - 1, c]
                    else:
                        cb = 1 if intra else 0
                    coeffs = cacs[comp, b]
                    cbf = 1 if (coeffs != 0).any() else 0
                    self._last_cac[comp, r, c] = cbf
                    self._residual(4, coeffs, int(ca + 2 * cb))

    def end_of_slice(self, last: bool) -> None:
        """end_of_slice_flag after each MB; the final flag (value 1)
        is folded into the flush (see H264ArithEncoder.flush)."""
        if not last:
            self.enc.encode_terminate(0)

    def finish(self) -> bytes:
        return self.enc.flush()
