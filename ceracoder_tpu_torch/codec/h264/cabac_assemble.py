"""H.264 CABAC slice assembly: turns the encoder's per-frame arrays into
CABAC slice NALs, one slice per MB row, through the native row coder
(native/src/h264_cabac.cc, built by utils/host_build.py).

Port of ceracoder_tpu/codec/h264/cabac_assemble.py, with two
deliberate differences:

- No Python row coder. The JAX module falls back to its executable
  spec (cabac.H264RowCabac) when the native library is missing or its
  output buffer is full; the port raises in both cases (a failed build
  raises in host_build, a full buffer here), so a broken build cannot
  hide behind a slow path. The spec, its decoder and the test parser
  stay in the JAX package.
- The slice headers' frame_num field is written with the encoder's
  `log2_max_frame_num` (a parameter of every function here, the SPS
  value); the JAX module's header cache leaves it out of its key and
  always writes the default of 8 bits (ROADMAP.md, F2). With the
  default the bytes are the same.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ceracoder_tpu_torch.codec.bitwriter import nal_unit
from ceracoder_tpu_torch.codec.h264.device_entropy import LUMA_SNAKE
from ceracoder_tpu_torch.codec.h264.syntax import (
    NAL_IDR,
    NAL_SLICE,
    SLICE_I_ALL,
    SLICE_P_ALL,
    SliceConfig,
    write_slice_header,
)
from ceracoder_tpu_torch.utils.host_build import load_h264_cabac


def _row_cfg(row: int, mbw: int, qp: int, pic_init_qp: int,
             deblock: bool, intra: bool, frame_num: int, idr_pic_id: int,
             log2_max_frame_num: int) -> SliceConfig:
    return SliceConfig(
        first_mb=row * mbw,
        slice_type=SLICE_I_ALL if intra else SLICE_P_ALL,
        frame_num=0 if intra else frame_num,
        idr=intra, idr_pic_id=idr_pic_id, qp=qp,
        pic_init_qp=pic_init_qp, log2_max_frame_num=log2_max_frame_num,
        deblock_idc=2 if deblock else 1, cabac=True)


def _hdr_bytes(cfg: SliceConfig) -> bytes:
    w = write_slice_header(cfg)
    # cabac_alignment_one_bit (7.3.4): '1's to the byte boundary
    pad = (-w.bit_length) % 8
    if pad:
        w.u((1 << pad) - 1, pad)
    return w.to_bytes()


@functools.lru_cache(maxsize=1 << 16)
def _row_hdr(row: int, mbw: int, qp: int, pic_init_qp: int,
             deblock: bool, intra: bool, frame_num: int, idr_pic_id: int,
             log2_max_frame_num: int = 8) -> bytes:
    """Memoized per-row slice-header bytes: a frame re-uses one header
    per MB row and the scalar inputs cycle over a small set (qp ladder
    x frame_num), so building them through the Python bitwriter every
    frame is pure overhead on the streaming path."""
    return _hdr_bytes(_row_cfg(row, mbw, qp, pic_init_qp, deblock, intra,
                               frame_num, idr_pic_id, log2_max_frame_num))


def _slice_nal(payload: bytes, idr: bool, first: bool) -> bytes:
    return nal_unit(3 if idr else 2, NAL_IDR if idr else NAL_SLICE,
                    payload, long_start_code=first)


def _native_rows(intra: bool, qp: int, mbh: int, mbw: int,
                 hdrs: list[bytes], arrays: dict) -> list[bytes]:
    """Every MB row's slice (header + CABAC payload) from the native
    row coder, rows coded in parallel threads. Raises RuntimeError when
    the output buffer is too small."""
    lib = load_h264_cabac()
    stride = max(len(h) for h in hdrs)
    hb = np.zeros((mbh, stride), np.uint8)
    hs = np.zeros(mbh, np.int32)
    for r, h in enumerate(hdrs):
        hb[r, :len(h)] = np.frombuffer(h, np.uint8)
        hs[r] = len(h)

    def c16(a):
        return np.ascontiguousarray(a, np.int16)

    def c32(a):
        return np.ascontiguousarray(a, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    cap = max(1 << 16, mbh * mbw * 2048)
    # empty, not zeros: the native coder overwrites what it uses and
    # the caller slices by row size
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(mbh, np.int32)
    nthreads = min(mbh, os.cpu_count() or 1)
    mode_l = mode_c = dc_luma = ac_luma = None
    if intra or arrays.get("mode_l") is not None:
        mode_l, mode_c = c32(arrays["mode_l"]), c32(arrays["mode_c"])
        dc_luma, ac_luma = c16(arrays["dc_luma"]), c16(arrays["ac_luma"])
    dc_chroma = c16(arrays["dc_chroma"])
    ac_chroma = c16(arrays["ac_chroma"])
    skip = mvd = luma_lv = None
    if not intra:
        # kind per MB in `skip`: 0 coded inter, 1 P_Skip, 2 intra-in-P
        skip = np.ascontiguousarray(arrays["skip"], np.uint8)
        mvd = c32(arrays["mvd"])
        luma_lv = c16(arrays["luma_lv"])
    n = lib.h264_cabac_rows(
        mbh, mbw, int(intra), 0, qp, p(hb), p(hs), stride,
        p(mode_l), p(mode_c), p(dc_luma), p(ac_luma),
        p(skip), p(mvd), p(luma_lv),
        p(dc_chroma), p(ac_chroma), p(out), cap, p(sizes), nthreads)
    if n < 0:
        raise RuntimeError(f"h264_cabac_rows: output buffer of {cap} B "
                           f"too small for a {mbw}x{mbh}-MB frame")
    ends = np.cumsum(sizes.astype(np.int64))
    return [out[e - s:e].tobytes() for s, e in zip(sizes.tolist(),
                                                   ends.tolist())]


def assemble_i_cabac(outs: dict, qp: int, idr_pic_id: int, mbh: int,
                     mbw: int, pic_init_qp: int, deblock: bool,
                     log2_max_frame_num: int = 8) -> bytes:
    """I-slice CABAC assembly from the intra op's dense outputs."""
    ac_luma = np.asarray(outs["ac_luma"]).reshape(mbh, mbw, 4, 4, 15)
    sr, sc = LUMA_SNAKE[:, 0], LUMA_SNAKE[:, 1]
    arrays = {
        "mode_l": np.asarray(outs["mode_luma"]).reshape(mbh, mbw),
        "mode_c": np.asarray(outs["mode_chroma"]).reshape(mbh, mbw),
        "dc_luma": np.asarray(outs["dc_luma"]).reshape(mbh, mbw, 16),
        "ac_luma": ac_luma[:, :, sr, sc],          # (mbh, mbw, 16, 15)
        "dc_chroma": np.asarray(outs["dc_chroma"]),
        "ac_chroma": np.asarray(outs["ac_chroma"])
        .reshape(mbh, mbw, 2, 4, 15),
    }
    return assemble_i_snake(arrays, qp, idr_pic_id, mbh, mbw, pic_init_qp,
                            deblock, log2_max_frame_num)


def assemble_i_snake(arrays: dict, qp: int, idr_pic_id: int, mbh: int,
                     mbw: int, pic_init_qp: int, deblock: bool,
                     log2_max_frame_num: int = 8) -> bytes:
    """I-slice CABAC assembly from coding-order arrays: mode_l/mode_c
    (mbh, mbw), dc_luma (mbh, mbw, 16), ac_luma snake (mbh, mbw, 16,
    15), dc_chroma (mbh, mbw, 2, 4), ac_chroma (mbh, mbw, 2, 4, 15) —
    the layout the run path's transfer produces (cabac_run.py)."""
    hdrs = [_row_hdr(r, mbw, qp, pic_init_qp, deblock, True, 0,
                     idr_pic_id, log2_max_frame_num) for r in range(mbh)]
    rows = _native_rows(True, qp, mbh, mbw, hdrs, arrays)
    return b"".join(_slice_nal(rows[r], idr=True, first=(r == 0))
                    for r in range(mbh))


def assemble_p_cabac(outs: dict, qp: int, frame_num: int, mbh: int,
                     mbw: int, pic_init_qp: int, deblock: bool,
                     log2_max_frame_num: int = 8) -> bytes:
    """P-slice CABAC assembly from the inter op's dense outputs (with
    intra-in-P: its is_intra, modes and intra levels)."""
    ll = np.asarray(outs["luma_levels"]).reshape(mbh, mbw, 4, 4, 16)
    sr, sc = LUMA_SNAKE[:, 0], LUMA_SNAKE[:, 1]
    luma_lv = ll[:, :, sr, sc]                     # (mbh, mbw, 16, 16)
    arrays = {
        "mv": np.asarray(outs["mv"]).astype(np.int64),
        "luma_lv": luma_lv,
        "dc_chroma": np.asarray(outs["dc_chroma"]),
        "ac_chroma": np.asarray(outs["ac_chroma"])
        .reshape(mbh, mbw, 2, 4, 15),
    }
    if "is_intra" in outs:
        m = np.asarray(outs["is_intra"]).astype(bool)
        if m.any():
            # intra MBs carry [dc 16 | ac snake 240] in the luma slots
            ac = np.asarray(outs["ac_luma"]).reshape(mbh, mbw, 4, 4, 15)
            intra256 = np.concatenate(
                [np.asarray(outs["dc_luma"]).reshape(mbh, mbw, 16),
                 ac[:, :, sr, sc].reshape(mbh, mbw, 240)], axis=-1)
            luma256 = np.ascontiguousarray(luma_lv) \
                .reshape(mbh, mbw, 256).copy()
            luma256[m] = intra256[m]
            arrays["luma_lv"] = luma256.reshape(mbh, mbw, 16, 16)
        arrays["is_intra"] = m
        arrays["mode_l"] = np.asarray(outs["mode_luma"]).astype(np.int32)
        arrays["mode_c"] = np.asarray(outs["mode_chroma"]).astype(np.int32)
    return assemble_p_snake(arrays, qp, frame_num, mbh, mbw, pic_init_qp,
                            deblock, log2_max_frame_num)


def assemble_p_snake(arrays: dict, qp: int, frame_num: int, mbh: int,
                     mbw: int, pic_init_qp: int, deblock: bool,
                     log2_max_frame_num: int = 8) -> bytes:
    """P-slice CABAC assembly from coding-order arrays: mv (mbh, mbw,
    2) quarter-pel, luma_lv snake (mbh, mbw, 16, 16), dc_chroma (mbh,
    mbw, 2, 4), ac_chroma (mbh, mbw, 2, 4, 15) — the layout the run
    path's transfer produces (cabac_run.py)."""
    mvg = np.asarray(arrays["mv"]).astype(np.int64)
    blocks_all = arrays["luma_lv"]                 # snake order
    dc_chroma = arrays["dc_chroma"]
    ac_chroma = arrays["ac_chroma"]
    is_intra = arrays.get("is_intra")
    if is_intra is None:
        is_intra = np.zeros((mbh, mbw), bool)
    has_intra = bool(is_intra.any())

    # cbp == 0 iff the MB carries no nonzero level at all, so the
    # per-MB nonzero count (on the run path's transfer) decides P_Skip
    # without scanning the dense arrays; the native coder derives the
    # actual cbp itself (h264_cabac.cc)
    if "nnz_mb" in arrays:
        no_resid = arrays["nnz_mb"].reshape(mbh, mbw) == 0
    else:
        no_resid = ~np.logical_or.reduce([
            (blocks_all != 0).reshape(mbh, mbw, -1).any(-1),
            (dc_chroma != 0).reshape(mbh, mbw, -1).any(-1),
            (ac_chroma != 0).reshape(mbh, mbw, -1).any(-1)])

    # MV prediction under the slice-row schedule (left only; an intra
    # left MB is unavailable for prediction, spec 8.4.1.3); P_Skip iff
    # inter, mv == (0, 0) (the skip predictor) and no residual
    pmv = np.zeros_like(mvg)
    pmv[:, 1:] = mvg[:, :-1]
    if has_intra:
        pmv[:, 1:] *= ~is_intra[:, :-1, None]
    mvd = mvg - pmv
    skip = ((mvg[..., 0] == 0) & (mvg[..., 1] == 0) & no_resid
            & ~is_intra)

    native_arrays = {
        "skip": skip.astype(np.uint8) + 2 * is_intra,   # 0/1/2 kinds
        "mvd": mvd, "luma_lv": blocks_all,
        "dc_chroma": dc_chroma,
        "ac_chroma": ac_chroma}
    if has_intra:
        # intra MBs store [dc 16 | ac snake 240] in the 256 luma slots
        luma256 = np.ascontiguousarray(blocks_all).reshape(mbh, mbw, 256)
        native_arrays.update(
            mode_l=arrays["mode_l"], mode_c=arrays["mode_c"],
            dc_luma=luma256[:, :, :16],
            ac_luma=luma256[:, :, 16:].reshape(mbh, mbw, 16, 15))

    hdrs = [_row_hdr(r, mbw, qp, pic_init_qp, deblock, False, frame_num, 0,
                     log2_max_frame_num) for r in range(mbh)]
    rows = _native_rows(False, qp, mbh, mbw, hdrs, native_arrays)
    return b"".join(_slice_nal(rows[r], idr=False, first=(r == 0))
                    for r in range(mbh))
