"""H.264 CABAC slice-data parser: the decode twin of cabac.py.

Parses CABAC slice data (spec 7.3.4 / 9.3.3.2) for the encoder's MB
repertoire — I_NxN, I_16x16, P_L0_16x16, P_Skip — with the FULL 2D
neighbor context model (left + above within the slice).  The encoder
(H264RowCabac) is the one-slice-per-MB-row specialization where every
above neighbor is outside the slice; this parser handles both our
row-slice streams and libx264's whole-frame slices, which makes it the
ground-truth bridge: if this parser walks a real x264 stream to the
final terminate with a sane MB map, the context model is right, and
the encoder shares it.

Reference for behavior: the reference app delegates H.264 entropy to
x264enc (reference: bindings/typescript/src/pipeline/generic-builder.ts
:49-55); bit-level ground truth here is libx264 output + libavcodec
decode (tools/x264_ref, tools/decode_oracle).

Every decoded bin can be traced via the `trace` hook for divergence
hunting against a known encode.

Copy of ceracoder_tpu/codec/h264/cabac_dec.py: the port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.h264.cabac import (
    _ABS_BASE,
    _CBF_BASE,
    _LAST_BASE,
    _SIG_BASE,
    init_contexts,
)
from ceracoder_tpu_torch.codec.h264.device_entropy import LUMA_SNAKE
from ceracoder_tpu_torch.codec.h265.cabac import CabacDecoder


class ParseError(Exception):
    pass


def _blank_mb(skip: bool) -> dict:
    return {
        "skip": skip, "intra": False, "intra16": False, "pcm": False,
        "mbt_not_inxn": True, "dc_cbf": 0,
        "luma_cbf": np.zeros((4, 4), np.int64), "mvd": (0, 0),
        "cbp_luma": 0, "cbp_chroma": 0, "cdc_cbf": [0, 0],
        "cac_cbf": np.zeros((2, 2, 2), np.int64),
        "chroma_nz": False, "mb_type": "P_Skip" if skip else "?",
    }


class H264SliceParser:
    """Parse one CABAC slice's data bytes (post-header, byte-aligned).

    `mbw`/`mbh` are the picture's MB dimensions; `first_mb` the
    slice's first MB address. Availability = same-slice membership
    (6.4.9 with no FMO: earlier decoding order within the slice).
    """

    def __init__(self, data: bytes, slice_qp: int, intra_slice: bool,
                 mbw: int, mbh: int, first_mb: int = 0,
                 cabac_init_idc: int = 0, trace=None) -> None:
        self.dec = CabacDecoder(data)
        self.ctx = init_contexts(slice_qp, intra_slice, cabac_init_idc)
        self.intra_slice = intra_slice
        self.mbw, self.mbh = mbw, mbh
        self.first_mb = first_mb
        self.mbs: dict[tuple[int, int], dict] = {}
        self.prev_qp_delta = 0
        self.trace = trace
        self._elem = ""

    # -- engine wrappers (traceable) ------------------------------------
    def _bin(self, idx: int) -> int:
        b = self.dec.decode_bin(self.ctx, idx)
        if self.trace is not None:
            self.trace.append((self._elem, idx, b))
        return b

    def _bypass(self) -> int:
        b = self.dec.decode_bypass()
        if self.trace is not None:
            self.trace.append((self._elem, -1, b))
        return b

    def _term(self) -> int:
        b = self.dec.decode_terminate()
        if self.trace is not None:
            self.trace.append((self._elem, 276, b))
        return b

    # -- neighbors ------------------------------------------------------
    def _left(self, row: int, col: int) -> dict | None:
        return self.mbs.get((row, col - 1)) if col > 0 else None

    def _above(self, row: int, col: int) -> dict | None:
        return self.mbs.get((row - 1, col)) if row > 0 else None

    # -- slice data -----------------------------------------------------
    def parse(self, max_mbs: int | None = None) -> list[dict]:
        """Parse MBs until end_of_slice_flag == 1; returns MB records
        in decoding order."""
        out = []
        idx = self.first_mb
        limit = self.mbw * self.mbh if max_mbs is None else \
            self.first_mb + max_mbs
        while True:
            if idx >= self.mbw * self.mbh:
                raise ParseError(f"ran past picture end at mb {idx}")
            row, col = divmod(idx, self.mbw)
            mb = self._parse_mb(row, col)
            mb["addr"] = idx
            self.mbs[(row, col)] = mb
            out.append(mb)
            idx += 1
            self._elem = "end_of_slice"
            if self._term():
                break
            if idx >= limit:
                raise ParseError(f"no end_of_slice by mb {idx}")
        return out

    def consumed_bytes(self) -> int:
        return self.dec.pos + (1 if self.dec.bitpos else 0)

    # -- macroblock_layer ----------------------------------------------
    def _parse_mb(self, row: int, col: int) -> dict:
        lt, ab = self._left(row, col), self._above(row, col)
        if not self.intra_slice:
            self._elem = "mb_skip_flag"
            inc = ((1 if (lt is not None and not lt["skip"]) else 0)
                   + (1 if (ab is not None and not ab["skip"]) else 0))
            if self._bin(11 + inc):
                self.prev_qp_delta = 0
                return _blank_mb(skip=True)
        return self._mb_type(row, col, lt, ab)

    def _mb_type(self, row: int, col: int, lt, ab) -> dict:
        self._elem = "mb_type"
        if self.intra_slice:
            inc = ((1 if (lt is not None and lt["mbt_not_inxn"])
                    else 0)
                   + (1 if (ab is not None and ab["mbt_not_inxn"])
                      else 0))
            if self._bin(3 + inc) == 0:
                return self._mb_i4(lt, ab)
            if self._term():
                raise ParseError("I_PCM not supported by parser")
            cbp_luma = 15 if self._bin(6) else 0
            if self._bin(7):
                cbp_chroma = 2 if self._bin(8) else 1
            else:
                cbp_chroma = 0
            mode_l = (self._bin(9) << 1) | self._bin(10)
            return self._mb_i16(mode_l, cbp_luma, cbp_chroma, lt, ab)
        # P slice
        if self._bin(14) == 0:
            if self._bin(15) == 0:
                if self._bin(16):
                    raise ParseError("P_8x8 not supported")
                return self._mb_p16(lt, ab)
            raise ParseError("P 16x8/8x16 not supported")
        # intra in P: suffix with ctx base 17
        if self._bin(17) == 0:
            return self._mb_i4(lt, ab)
        if self._term():
            raise ParseError("I_PCM not supported by parser")
        cbp_luma = 15 if self._bin(18) else 0
        if self._bin(19):
            cbp_chroma = 2 if self._bin(19) else 1
        else:
            cbp_chroma = 0
        mode_l = (self._bin(20) << 1) | self._bin(20)
        return self._mb_i16(mode_l, cbp_luma, cbp_chroma, lt, ab)

    # -- intra MBs ------------------------------------------------------
    def _mb_i16(self, mode_l: int, cbp_luma: int, cbp_chroma: int,
                lt, ab) -> dict:
        mode_c = self._chroma_pred_mode(lt, ab)
        self._qp_delta()
        self._elem = "i16_dc"
        ca = self._cbf_nbr_dc(lt)
        cb = self._cbf_nbr_dc(ab)
        dc = self._residual(0, 16, ca + 2 * cb)
        dc_cbf = 1 if (dc != 0).any() else 0
        luma_cbf = np.zeros((4, 4), np.int64)
        acs = np.zeros((16, 15), np.int64)
        if cbp_luma:
            self._luma_blocks(1, acs, luma_cbf, lt, ab, intra=True)
        cdc, cacs, cdc_cbf, cac_cbf = self._chroma_residual(
            cbp_chroma, lt, ab, intra=True)
        return {
            "skip": False, "intra": True, "intra16": True,
            "pcm": False, "mbt_not_inxn": True, "dc_cbf": dc_cbf,
            "luma_cbf": luma_cbf, "mvd": (0, 0),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": cdc_cbf, "cac_cbf": cac_cbf,
            "chroma_nz": mode_c != 0, "mb_type": "I_16x16",
            "mode_l": mode_l, "mode_c": mode_c, "dqp": self._dqp,
            "dc": dc, "acs": acs, "cdc": cdc, "cacs": cacs,
        }

    def _mb_i4(self, lt, ab) -> dict:
        self._elem = "i4_modes"
        pred_flags = np.zeros(16, np.int64)
        rems = np.zeros(16, np.int64)
        for b in range(16):
            if self._bin(68):
                pred_flags[b] = 1
            else:
                rems[b] = (self._bin(69) | (self._bin(69) << 1)
                           | (self._bin(69) << 2))
        mode_c = self._chroma_pred_mode(lt, ab)
        cbp_luma, cbp_chroma = self._cbp(lt, ab)
        if cbp_luma or cbp_chroma:
            self._qp_delta()
        else:
            self._dqp = 0
            self.prev_qp_delta = 0
        luma_cbf = np.zeros((4, 4), np.int64)
        blocks = np.zeros((16, 16), np.int64)
        if cbp_luma:
            self._luma_blocks(2, blocks, luma_cbf, lt, ab, intra=True,
                              cbp_luma=cbp_luma)
        cdc, cacs, cdc_cbf, cac_cbf = self._chroma_residual(
            cbp_chroma, lt, ab, intra=True)
        return {
            "skip": False, "intra": True, "intra16": False,
            "pcm": False, "mbt_not_inxn": False, "dc_cbf": 0,
            "luma_cbf": luma_cbf, "mvd": (0, 0),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": cdc_cbf, "cac_cbf": cac_cbf,
            "chroma_nz": mode_c != 0, "mb_type": "I_4x4",
            "pred_flags": pred_flags, "rems": rems, "mode_c": mode_c,
            "dqp": self._dqp, "blocks": blocks, "cdc": cdc,
            "cacs": cacs,
        }

    def _mb_p16(self, lt, ab) -> dict:
        self._elem = "mvd"
        dx = self._mvd(40, (0 if lt is None else abs(lt["mvd"][1]))
                       + (0 if ab is None else abs(ab["mvd"][1])))
        dy = self._mvd(47, (0 if lt is None else abs(lt["mvd"][0]))
                       + (0 if ab is None else abs(ab["mvd"][0])))
        cbp_luma, cbp_chroma = self._cbp(lt, ab)
        if cbp_luma or cbp_chroma:
            self._qp_delta()
        else:
            self._dqp = 0
            self.prev_qp_delta = 0
        luma_cbf = np.zeros((4, 4), np.int64)
        blocks = np.zeros((16, 16), np.int64)
        if cbp_luma:
            self._luma_blocks(2, blocks, luma_cbf, lt, ab, intra=False,
                              cbp_luma=cbp_luma)
        cdc, cacs, cdc_cbf, cac_cbf = self._chroma_residual(
            cbp_chroma, lt, ab, intra=False)
        return {
            "skip": False, "intra": False, "intra16": False,
            "pcm": False, "mbt_not_inxn": True, "dc_cbf": 0,
            "luma_cbf": luma_cbf, "mvd": (dy, dx),
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
            "cdc_cbf": cdc_cbf, "cac_cbf": cac_cbf,
            "chroma_nz": False, "mb_type": "P_16x16",
            "dqp": self._dqp, "blocks": blocks, "cdc": cdc,
            "cacs": cacs,
        }

    # -- sub-parsers -----------------------------------------------------
    def _chroma_pred_mode(self, lt, ab) -> int:
        self._elem = "chroma_pred"
        inc = ((1 if (lt is not None and lt["intra"]
                      and lt["chroma_nz"]) else 0)
               + (1 if (ab is not None and ab["intra"]
                        and ab["chroma_nz"]) else 0))
        if self._bin(64 + inc) == 0:
            return 0
        if self._bin(67) == 0:
            return 1
        return 3 if self._bin(67) else 2

    def _qp_delta(self) -> None:
        self._elem = "mb_qp_delta"
        idx0 = 60 + (1 if self.prev_qp_delta != 0 else 0)
        if self._bin(idx0) == 0:
            mapped = 0
        else:
            mapped = 1
            if self._bin(62):
                mapped = 2
                while self._bin(63):
                    mapped += 1
                    if mapped > 80:
                        raise ParseError("runaway mb_qp_delta")
        dqp = (mapped + 1) // 2 if mapped & 1 else -(mapped // 2)
        self._dqp = dqp
        self.prev_qp_delta = dqp

    def _mvd(self, base: int, abs_sum: int) -> int:
        inc = 0 if abs_sum < 3 else (2 if abs_sum > 32 else 1)
        if self._bin(base + inc) == 0:
            return 0
        a = 1
        while a < 9 and self._bin(base + 2 + min(a, 4)):
            a += 1
        if a == 9:
            k = 3
            while self._bypass():
                a += 1 << k
                k += 1
                if k > 24:
                    raise ParseError("runaway mvd EG3")
            for i in range(k - 1, -1, -1):
                a += self._bypass() << i
        return -a if self._bypass() else a

    def _cbp(self, lt, ab) -> tuple[int, int]:
        self._elem = "cbp"
        cbp_luma = 0
        for b in range(4):
            if b & 1:
                ca = 1 - ((cbp_luma >> (b - 1)) & 1)
            elif lt is not None:
                ca = 1 - ((lt["cbp_luma"] >> (b + 1)) & 1)
            else:
                ca = 0
            if b >= 2:
                cb = 1 - ((cbp_luma >> (b - 2)) & 1)
            elif ab is not None:
                cb = 1 - ((ab["cbp_luma"] >> (b + 2)) & 1)
            else:
                cb = 0
            if self._bin(73 + ca + 2 * cb):
                cbp_luma |= 1 << b
        ca = 1 if (lt is not None and lt["cbp_chroma"] != 0) else 0
        cb = 1 if (ab is not None and ab["cbp_chroma"] != 0) else 0
        cbp_chroma = 0
        if self._bin(77 + ca + 2 * cb):
            ca = 1 if (lt is not None and lt["cbp_chroma"] == 2) else 0
            cb = 1 if (ab is not None and ab["cbp_chroma"] == 2) else 0
            cbp_chroma = 2 if self._bin(81 + ca + 2 * cb) else 1
        return cbp_luma, cbp_chroma

    def _cbf_nbr_dc(self, nb: dict | None) -> int:
        """condTermFlag for the Intra16x16 DC coded_block_flag: the
        neighbor's DC block exists only when it is also Intra_16x16
        (PCM counts as coded)."""
        if nb is None:
            return 1                    # current MB is intra
        if nb["pcm"]:
            return 1
        return nb["dc_cbf"] if nb["intra16"] else 0

    def _residual(self, cat: int, n: int,
                  cbf_inc: int | None) -> np.ndarray:
        self._elem = f"residual_cat{cat}"
        coeffs = np.zeros(n, np.int64)
        if cbf_inc is not None:
            if self._bin(_CBF_BASE[cat] + cbf_inc) == 0:
                return coeffs
        sig_base, last_base = _SIG_BASE[cat], _LAST_BASE[cat]
        sigpos = []
        last_hit = False
        for i in range(n - 1):
            inc = i if cat != 3 else min(i, 2)
            if self._bin(sig_base + inc):
                sigpos.append(i)
                if self._bin(last_base + inc):
                    last_hit = True
                    break
        if not last_hit:
            sigpos.append(n - 1)
        gt1_seen = 0
        eq1_seen = 0
        abs_base = _ABS_BASE[cat]
        for i in sigpos[::-1]:
            idx0 = abs_base + (0 if gt1_seen
                               else min(4, 1 + eq1_seen))
            rest_idx = abs_base + 5 + min(
                3 if cat == 3 else 4, gt1_seen)
            if self._bin(idx0) == 0:
                v = 1
                eq1_seen += 1
            else:
                v = 2
                k = 0
                while k < 13 and self._bin(rest_idx):
                    v += 1
                    k += 1
                if k == 13:
                    # UEG0 suffix in bypass
                    nb = 0
                    while self._bypass():
                        nb += 1
                        if nb > 24:
                            raise ParseError("runaway level EG0")
                    suf = 0
                    for _ in range(nb):
                        suf = (suf << 1) | self._bypass()
                    v = 15 + (1 << nb) - 1 + suf
                gt1_seen += 1
            coeffs[i] = -v if self._bypass() else v
        return coeffs

    def _luma_blocks(self, cat: int, out: np.ndarray,
                     luma_cbf: np.ndarray, lt, ab, intra: bool,
                     cbp_luma: int = 15) -> None:
        ncoef = 15 if cat == 1 else 16
        for b in range(16):
            r, c = int(LUMA_SNAKE[b][0]), int(LUMA_SNAKE[b][1])
            q = (r // 2) * 2 + (c // 2)
            if not ((cbp_luma >> q) & 1):
                continue
            if c > 0:
                ca = luma_cbf[r, c - 1]
            elif lt is not None:
                ca = 1 if lt["pcm"] else lt["luma_cbf"][r, 3]
            else:
                ca = 1 if intra else 0
            if r > 0:
                cb = luma_cbf[r - 1, c]
            elif ab is not None:
                cb = 1 if ab["pcm"] else ab["luma_cbf"][3, c]
            else:
                cb = 1 if intra else 0
            coeffs = self._residual(cat, ncoef, int(ca + 2 * cb))
            luma_cbf[r, c] = 1 if (coeffs != 0).any() else 0
            out[b, :ncoef] = coeffs

    def _chroma_residual(self, cbp_chroma: int, lt, ab, intra: bool):
        cdc = np.zeros((2, 4), np.int64)
        cacs = np.zeros((2, 4, 15), np.int64)
        cdc_cbf = [0, 0]
        cac_cbf = np.zeros((2, 2, 2), np.int64)
        if cbp_chroma == 0:
            return cdc, cacs, cdc_cbf, cac_cbf
        for comp in range(2):
            if lt is None:
                ca = 1 if intra else 0
            else:
                ca = 1 if lt["pcm"] else lt["cdc_cbf"][comp]
            if ab is None:
                cb = 1 if intra else 0
            else:
                cb = 1 if ab["pcm"] else ab["cdc_cbf"][comp]
            cdc[comp] = self._residual(3, 4, int(ca + 2 * cb))
            cdc_cbf[comp] = 1 if (cdc[comp] != 0).any() else 0
        if cbp_chroma == 2:
            for comp in range(2):
                for b in range(4):
                    r, c = b // 2, b % 2
                    if c > 0:
                        ca = cac_cbf[comp, r, c - 1]
                    elif lt is not None:
                        ca = (1 if lt["pcm"]
                              else lt["cac_cbf"][comp, r, 1])
                    else:
                        ca = 1 if intra else 0
                    if r > 0:
                        cb = cac_cbf[comp, r - 1, c]
                    elif ab is not None:
                        cb = (1 if ab["pcm"]
                              else ab["cac_cbf"][comp, 1, c])
                    else:
                        cb = 1 if intra else 0
                    cacs[comp, b] = self._residual(
                        4, 15, int(ca + 2 * cb))
                    cac_cbf[comp, r, c] = \
                        1 if (cacs[comp, b] != 0).any() else 0
        return cdc, cacs, cdc_cbf, cac_cbf
