"""Row-slice HEVC host stage: dense levels from the device's sparse
stream, and the native (C++) entropy coder.

Copy of the parts of ceracoder_tpu/codec/h265/rowslice.py that the
device run path needs on the host, cut to its I/P tile-row pictures:
`densify_levels`, the tile-slice assembly, the native stage's
context-offset order and `entropy_rows_native`, plus the inter/intra
bias that the device's intra fallback uses. The stage is
native/src/hevc_entropy.cc, built and loaded by the port's own loader
(utils/host_build.py). Unlike the JAX package, a missing or failing
library raises: there is no Python entropy fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ceracoder_tpu_torch.codec.bitwriter import emulation_prevent
from ceracoder_tpu_torch.codec.h265.ctx_tables import build_slice_contexts
from ceracoder_tpu_torch.codec.h265.syntax import (
    HevcParams,
    slice_header_bits,
)
from ceracoder_tpu_torch.utils.host_build import load_hevc_entropy

# inter-vs-intra competition bias, matching the raster encoder: intra
# must beat 3/4 of the inter SAD
INTRA_BIAS_NUM, INTRA_BIAS_DEN = 3, 4


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


def _assemble_tiles(p: HevcParams, bodies: list[bytes], qp: int,
                    idr: bool, poc: int, ref_poc_delta: int) -> bytes:
    """One slice carrying one tile per CTB row: slice header with
    entry-point offsets (coded-domain byte sizes of tiles 0..N-2,
    spec 7.4.7.1 — emulation prevention bytes counted; regions never
    share a zero run because every CABAC flush ends on a nonzero,
    byte-aligned byte) followed by the concatenated tile substreams."""
    coded_sizes = [len(emulation_prevent(b)) for b in bodies[:-1]]
    hdr = slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                            ref_poc_delta=ref_poc_delta,
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
                        poc: int = 0, ref_poc_delta: int = 1) -> list[bytes]:
    """Native (C++) entropy stage of an I or P picture: every CTB row is
    one tile of a single slice (a one-row picture: one plain slice);
    returns the slice's RBSP bytes, which the caller wraps in a NAL
    unit. With `p.sao`, arrays["sao"] holds each CTB's (nch, ncw, 3, 6)
    SAO parameters (ops/h265.py: sao_estimate_dev)."""
    lib = load_hevc_entropy()

    is_intra = np.ascontiguousarray(arrays["is_intra"], np.uint8)
    mode = np.ascontiguousarray(arrays["mode"], np.int32)
    mv = np.ascontiguousarray(arrays["mv"], np.int32)
    mv1 = np.zeros_like(mv)                 # no second list (no B)
    luma_lv = np.ascontiguousarray(arrays["luma_lv"], np.int16)
    cb_lv = np.ascontiguousarray(arrays["cb_lv"], np.int16)
    cr_lv = np.ascontiguousarray(arrays["cr_lv"], np.int16)
    nch, ncw = is_intra.shape
    if (mode.shape != (nch, ncw) or mv.shape != (nch, ncw, 2)
            or luma_lv.shape != (nch, ncw, 16, 16)
            or cb_lv.shape != (nch, ncw, 8, 8)
            or cr_lv.shape != cb_lv.shape):
        raise ValueError("entropy arrays do not share one CTB grid")

    # tile rows are headerless substreams (the slice header is assembled
    # afterwards); a one-row picture's slice header goes in front
    if p.tiles:
        hdr_bytes = np.zeros((nch, 1), np.uint8)
        hdr_bits = np.zeros(nch, np.int32)
    else:
        hw = slice_header_bits(p, idr=idr, qp=qp, poc=poc,
                               ref_poc_delta=ref_poc_delta)
        hdr_bytes = np.frombuffer(hw.to_bytes(), np.uint8)[None].copy()
        hdr_bits = np.array([hw.bit_length], np.int32)
    stride = hdr_bytes.shape[1]

    ctx, off = build_slice_contexts(qp, init_type=0 if idr else 1)
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
    total = lib.hevc_entropy_rows(
        nch, ncw, int(idr), 0, int(p.tiles),   # is_b = 0
        0, None,                               # no TU split
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
        return [_assemble_tiles(p, res, qp, idr, poc, ref_poc_delta)]
    return res
