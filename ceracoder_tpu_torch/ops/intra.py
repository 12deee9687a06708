"""Intra-frame encoding compute path (torch).

Port of ceracoder_tpu/ops/intra.py: Intra_16x16 with the
slice-per-MB-row schedule. Rows are independent slices, so each MB
column is one batched step over all MB rows; the columns run as a
Python loop carrying each row's right-edge reconstruction (the JAX
`lax.scan`). Prediction modes per spec 8.3.3 / 8.3.4, restricted to the
left-neighbor modes available in slice-row scanning: Horizontal and DC.

That loop is `_encode_mb_cols_ref`, the plain version of K3, which also
serves the intra-in-P scan of ops/inter.py. K3 (csrc/h264_intra16.cu) is
two kernels: a carry pass, one CTA per MB row, that runs the serial
column chain and keeps only what the next MB needs (the modes, the DC
paths, the right-hand 4x4 blocks), storing each MB's left column in a
scratch buffer; then a code pass, one CTA per MB, that codes every MB
from its stored left column. `h264_intra16_cols` launches both on a CUDA
tensor and runs the loop on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ceracoder_tpu_torch.ops.transform import (
    dequant4,
    dequant_dc2,
    dequant_dc4,
    fdct4,
    from_blocks4,
    hadamard2_fwd,
    hadamard4_fwd,
    idct4,
    quant4,
    quant_dc2,
    quant_dc4,
    to_blocks4,
    zigzag_scan,
)
from ceracoder_tpu_torch.utils.device import check_kernel_args

# Intra16x16PredMode values (spec table 8-4)
LUMA_V, LUMA_H, LUMA_DC, LUMA_PLANE = 0, 1, 2, 3
# intra_chroma_pred_mode values (spec table 8-5)
CHROMA_DC, CHROMA_H, CHROMA_V, CHROMA_PLANE = 0, 1, 2, 3


def _sad(a, b):
    return (a - b).abs().sum((-1, -2))


def _encode_luma_mb(orig, left_col, qp: int):
    """One column of 16x16 luma MBs, batched over rows.

    orig (R, 16, 16) int32; left_col (R, 16) int32 — the left MB's
    reconstructed right column, all-128 for column 0 (which makes DC the
    spec's borderless 128 and lets H lose the strict-< tie).
    Returns (dc_levels (R,16), ac_levels (R,4,4,15), mode (R,),
    recon (R,16,16)).
    """
    pred_h = left_col[:, :, None].expand(-1, 16, 16)
    dc_left = (left_col.sum(-1) + 8) >> 4
    pred_dc = dc_left[:, None, None].expand(-1, 16, 16)

    use_h = _sad(orig, pred_h) < _sad(orig, pred_dc)
    pred = torch.where(use_h[:, None, None], pred_h, pred_dc)
    mode = torch.where(use_h, LUMA_H, LUMA_DC)

    w = fdct4(to_blocks4(orig - pred))              # (R,4,4,4,4)
    zdc = quant_dc4(hadamard4_fwd(w[..., 0, 0]), qp)
    zac = quant4(w, qp)
    zac[..., 0, 0] = 0

    d = dequant4(zac, qp)
    d[..., 0, 0] = dequant_dc4(zdc, qp)
    recon = (pred + from_blocks4(idct4(d))).clamp(0, 255)
    return zigzag_scan(zdc), zigzag_scan(zac)[..., 1:], mode, recon


def _chroma_pred(left):
    """8x8 chroma H and DC predictions (spec 8.3.4), left-only, batched:
    left (R, 8) int32 -> two (R, 8, 8)."""
    pred_h = left[:, :, None].expand(-1, 8, 8)
    tl = (left[:, :4].sum(-1) + 2) >> 2
    bl = (left[:, 4:].sum(-1) + 2) >> 2
    dc_rows = torch.cat([tl[:, None].expand(-1, 4),
                         bl[:, None].expand(-1, 4)], dim=1)
    pred_dc = dc_rows[:, :, None].expand(-1, 8, 8)
    return pred_h, pred_dc


def _encode_chroma_comp(orig, pred, qp_c: int):
    """One column of 8x8 chroma blocks with a chosen prediction.
    Returns (dc_levels (R,4), ac_levels (R,2,2,15), recon (R,8,8))."""
    w = fdct4(to_blocks4(orig - pred))              # (R,2,2,4,4)
    zdc = quant_dc2(hadamard2_fwd(w[..., 0, 0]), qp_c)
    zac = quant4(w, qp_c)
    zac[..., 0, 0] = 0
    d = dequant4(zac, qp_c)
    d[..., 0, 0] = dequant_dc2(zdc, qp_c)
    recon = (pred + from_blocks4(idct4(d))).clamp(0, 255)
    return zdc.reshape(-1, 4), zigzag_scan(zac)[..., 1:], recon


def _encode_mb_col(ymb, umb, vmb, ly, lu, lv, qp: int, qp_c: int):
    """One MB column (all rows). Inputs int32; returns (outputs dict,
    new left columns)."""
    dc_l, ac_l, mode_l, recon_y = _encode_luma_mb(ymb, ly, qp)

    ph_u, pdc_u = _chroma_pred(lu)
    ph_v, pdc_v = _chroma_pred(lv)
    sad_h = _sad(umb, ph_u) + _sad(vmb, ph_v)
    sad_dc = _sad(umb, pdc_u) + _sad(vmb, pdc_v)
    use_h = sad_h < sad_dc
    mode_c = torch.where(use_h, CHROMA_H, CHROMA_DC)
    sel = use_h[:, None, None]
    pred_u = torch.where(sel, ph_u, pdc_u)
    pred_v = torch.where(sel, ph_v, pdc_v)

    dc_u, ac_u, recon_u = _encode_chroma_comp(umb, pred_u, qp_c)
    dc_v, ac_v, recon_v = _encode_chroma_comp(vmb, pred_v, qp_c)

    out = dict(
        dc_luma=dc_l, ac_luma=ac_l, mode_luma=mode_l,
        dc_chroma=torch.stack([dc_u, dc_v], dim=1),
        ac_chroma=torch.stack([ac_u, ac_v], dim=1),
        mode_chroma=mode_c,
        recon_y=recon_y, recon_u=recon_u, recon_v=recon_v,
    )
    return out, (recon_y[:, :, 15], recon_u[:, :, 7], recon_v[:, :, 7])


_OUT_DTYPES = dict(dc_luma=torch.int16, ac_luma=torch.int16,
                   mode_luma=torch.uint8, dc_chroma=torch.int16,
                   ac_chroma=torch.int16, mode_chroma=torch.uint8)


def encode_frame_i16_rows(y, u, v, qp: int, qp_c: int):
    """Encode a frame as Intra_16x16 with one slice per MB row.

    y: (H, W) uint8 with H, W multiples of 16; u, v: (H/2, W/2).
    Returns a dict of per-MB arrays, leading dims (mb_rows, mb_cols),
    with the reference's keys and dtypes, plus "recon" = (y, u, v)
    uint8 planes. The MB columns run in `h264_intra16_cols` (K3 on a
    card).
    """
    return h264_intra16_cols(y.contiguous(), u.contiguous(), v.contiguous(),
                             qp, qp_c)


def _encode_mb_cols_ref(y, u, v, qp: int, qp_c: int, is_intra=None,
                        inter_recon=None):
    """Plain PyTorch version of K3: the column loop over
    `_encode_mb_col`, batched over MB rows, carrying each row's left
    columns. With `is_intra` (mbh, mbw) bool and `inter_recon` (the
    inter (y, u, v) planes) the carry after each MB is the intra
    reconstruction where is_intra is set and the inter one elsewhere
    (the intra-in-P scan); without them it is always the intra one.
    Returns encode_frame_i16_rows' dict (the intra reconstruction)."""
    h, w = y.shape
    mbh, mbw = h // 16, w // 16

    def mbs(x, mb):
        return x.to(torch.int32).reshape(x.shape[0] // mb, mb, mbw,
                                         mb).transpose(1, 2)
    ymb, umb, vmb = mbs(y, 16), mbs(u, 8), mbs(v, 8)
    if is_intra is not None:
        rmb = [mbs(p, mb) for p, mb in zip(inter_recon, (16, 8, 8))]

    ly = torch.full((mbh, 16), 128, dtype=torch.int32, device=y.device)
    lu = torch.full((mbh, 8), 128, dtype=torch.int32, device=y.device)
    lv = torch.full((mbh, 8), 128, dtype=torch.int32, device=y.device)
    cols = []
    for c in range(mbw):
        out, left = _encode_mb_col(ymb[:, c], umb[:, c], vmb[:, c], ly, lu,
                                   lv, qp, qp_c)
        if is_intra is not None:
            m1 = is_intra[:, c, None]
            left = [torch.where(m1, nl, r[:, c, :, -1])
                    for nl, r in zip(left, rmb)]
        ly, lu, lv = left
        cols.append(out)
    outs = {k: torch.stack([o[k] for o in cols], dim=1) for k in cols[0]}

    def plane(x, mb):
        return x.transpose(1, 2).reshape(mbh * mb, mbw * mb).to(torch.uint8)

    recon = (plane(outs.pop("recon_y"), 16), plane(outs.pop("recon_u"), 8),
             plane(outs.pop("recon_v"), 8))
    outs = {k: o.to(_OUT_DTYPES[k]) for k, o in outs.items()}
    outs["recon"] = recon
    return outs


def _check_intra16(y, u, v, qp: int, qp_c: int, is_intra, inter_recon):
    """Raise on what K3 does not take."""
    if (is_intra is None) != (inter_recon is None):
        raise ValueError("h264_intra16_cols: is_intra and inter_recon go "
                         "together")
    if y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16 or y.numel() == 0:
        raise ValueError(f"h264_intra16_cols: y {tuple(y.shape)} is not "
                         "(H, W) in whole 16x16 MBs")
    h, w = y.shape
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    args = [(n, p, torch.uint8, s) for n, p, s in zip("yuv", (y, u, v),
                                                       shapes)]
    if is_intra is not None:
        if len(inter_recon) != 3:
            raise ValueError("h264_intra16_cols: inter_recon is (y, u, v)")
        args.append(("is_intra", is_intra, torch.bool, (h // 16, w // 16)))
        args += [(f"inter_recon[{i}]", p, torch.uint8, s)
                 for i, (p, s) in enumerate(zip(inter_recon, shapes))]
    check_kernel_args("h264_intra16_cols", args, (qp, qp_c))


# bytes per MB of the carry pass's scratch: the left column of 16 luma
# and 8 + 8 chroma samples that the MB was coded with
_SCRATCH = 32


@functools.lru_cache(maxsize=None)
def _launchers():
    """K3's two C entry points, the carry pass and the code pass (built
    and loaded at first use)."""
    from ceracoder_tpu_torch.utils.cuda_build import load_library

    lib = load_library("h264_intra16")
    carry, code = lib.h264_intra16_carry_launch, lib.h264_intra16_code_launch
    carry.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    code.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    carry.restype = code.restype = ctypes.c_int
    return carry, code


def h264_intra16_cols(y, u, v, qp: int, qp_c: int, is_intra=None,
                      inter_recon=None):
    """Intra_16x16 coding of every MB of a frame, column after column
    (K3); arguments and result as `_encode_mb_cols_ref`.

    On a CUDA tensor this launches the two kernels of
    csrc/h264_intra16.cu on the current stream, or raises: the carry
    pass (one CTA per MB row, the MB columns in a loop), which writes
    the modes and each MB's left column to a scratch buffer, then the
    code pass (one CTA per MB). On a CPU tensor it runs
    `_encode_mb_cols_ref`. `h264_intra16_cols.launches` counts calls
    that launched K3, one per frame; each launches both kernels."""
    qp, qp_c = int(qp), int(qp_c)
    _check_intra16(y, u, v, qp, qp_c, is_intra, inter_recon)
    if y.device.type == "cpu":
        return _encode_mb_cols_ref(y, u, v, qp, qp_c, is_intra, inter_recon)
    if y.device.type != "cuda":
        raise ValueError(f"h264_intra16_cols: unsupported device {y.device}")
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    def empty(*shape, dtype=torch.int16):
        return torch.empty((mbh, mbw, *shape), dtype=dtype, device=y.device)
    outs = dict(dc_luma=empty(16), ac_luma=empty(4, 4, 15),
                mode_luma=empty(dtype=torch.uint8), dc_chroma=empty(2, 4),
                ac_chroma=empty(2, 2, 2, 15),
                mode_chroma=empty(dtype=torch.uint8),
                recon=(torch.empty_like(y), torch.empty_like(u),
                       torch.empty_like(v)))
    scratch = empty(_SCRATCH, dtype=torch.uint8)   # not an output
    scan = [None] * 4 if is_intra is None else [
        is_intra.data_ptr(), *(p.data_ptr() for p in inter_recon)]
    planes = (y.data_ptr(), u.data_ptr(), v.data_ptr())
    carry, code = _launchers()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = carry(*planes, *scan, scratch.data_ptr(),
                    outs["mode_luma"].data_ptr(),
                    outs["mode_chroma"].data_ptr(), mbh, mbw, qp, qp_c,
                    stream)
        if err != 0:
            raise RuntimeError(f"h264_intra16_cols carry kernel launch "
                               f"failed: CUDA error {err}")
        err = code(*planes, scratch.data_ptr(),
                   *(outs[k].data_ptr() for k in _OUT_DTYPES),
                   *(p.data_ptr() for p in outs["recon"]), mbh, mbw, qp,
                   qp_c, stream)
        if err != 0:
            raise RuntimeError(f"h264_intra16_cols code kernel launch "
                               f"failed: CUDA error {err}")
    h264_intra16_cols.launches += 1
    return outs


h264_intra16_cols.launches = 0
