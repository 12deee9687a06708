"""HEVC row-slice compute on the device (torch): prediction,
transforms, quantization, motion search and compensation, deblocking,
level compaction and the packed transfer rows.

Port of the run path of ceracoder_tpu/ops/h265.py: IDR, P and (with
one B between references) B frames, with or without the inter TU
split.
Every array equals the JAX function's (tests/test_torch_h265_ops.py);
the native entropy stage (codec/h265/rowslice.py) turns them into the
bitstream. The codec is integer-exact, and so is every op here:

- CUDA has no integer matmul, and a float32 product rounds above 2^24,
  so every matrix product (transforms, Hadamard SATD, the 8-tap qpel
  filters) runs as a float64 matmul of integers (`_imatmul`), exact
  below 2^53. The largest sums here are about 2^26.
- The JAX code's TPU shapes are dropped where the GPU has a direct
  form with the same outputs: the bf16 limb matmuls, the float32
  angular einsum (an integer two-tap gather here), the gather-free
  window canvases and select chains (indexed loads here), the float32
  column-sum dot of the coarse search (an integer reshape-sum), the
  lax.scan plumbing (Python loops) and the three-level compaction (one
  prefix sum).
- Ties keep the JAX order: the first minimum wins (`_argmin_first`),
  over the same candidate tables in the same order.
- Per-CU tensors are CU-leading, (nch, ncw, ...), where the JAX code
  keeps the CU grid trailing for the TPU's lanes.
- QPs are host ints: the port runs frame by frame.

The IDR column loop runs in K4 (`h265_intra_cols`, csrc/h265_intra.cu)
on a card, in its plain version `_i_frame_cols_ref` on the CPU. SAO is
plain torch (statistics by scatter-adds in place of the JAX code's
per-band masked sums).

The inter TU split and B frames are plain torch too: the split's
second transform option (`_code_inter_tus_dev`), the second motion
search of a B frame and the bi-prediction combine (`_b_frame_core`).

The legacy whole-frame motion helpers (`motion_search_dev`,
`_luma_qpel_planes`, `_uni_from_14`, `_mc_luma_qpel`, `_refine_subpel`,
`_mc_chroma_qpel`) are plain torch too. No encoder path calls them: they
are the JAX package's exhaustive +-8 search and whole-frame sub-pel
refine, kept for the profiling tools and held equal to their JAX twins.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceracoder_tpu_torch.codec.h265.rowslice import (
    INTRA_BIAS_DEN,
    INTRA_BIAS_NUM,
)
from ceracoder_tpu_torch.codec.h265.sao import (
    SAO_BITS_CHROMA,
    SAO_BITS_LUMA,
    SAO_LAMBDA,
)
from ceracoder_tpu_torch.codec.h265.tables import (
    BETA_TABLE,
    CHROMA_FILTER,
    CHROMA_SCALE,
    INV_QUANT_SCALES,
    LUMA_FILTER,
    QUANT_SCALES,
    T4,
    T8,
    T16,
    TC_TABLE,
)
from ceracoder_tpu_torch.utils.device import check_kernel_args

CTB = 16
I32 = torch.int32

# candidate modes in decision order: planar, DC, hor, ver, then the
# left-only angular modes 2..9
_MODES = np.array([0, 1, 10, 26, 2, 3, 4, 5, 6, 7, 8, 9], np.int32)
_ANGLES = (32, 26, 21, 17, 13, 9, 5, 2)        # modes 2..9 (Table 8-5)

SEARCH_RANGE = 8                 # the legacy exhaustive search: +-8
# center-outward shift enumeration of the legacy search (order = tie
# order; ties prefer the shorter MV)
_OFFS = sorted(((dy, dx)
                for dy in range(-SEARCH_RANGE, SEARCH_RANGE + 1)
                for dx in range(-SEARCH_RANGE, SEARCH_RANGE + 1)),
               key=lambda o: (abs(o[0]) + abs(o[1]), abs(o[0])))
_OFF_DY = np.array([o[0] for o in _OFFS], np.int32)
_OFF_DX = np.array([o[1] for o in _OFFS], np.int32)

CHROMA_PAD = SEARCH_RANGE // 2 + 2
PLANE_PAD = SEARCH_RANGE + 1     # qpel MVs floor to -(range + 1) integer
LUMA_SRC_PAD = PLANE_PAD + 4     # 8-tap DCT-IF reaches -3..+4

# sub-pel refinement candidates (order = tie order)
_SUB_DY = np.array([0, 0, 0, -1, 1, -1, -1, 1, 1], np.int32)
_SUB_DX = np.array([0, -1, 1, 0, 0, -1, 1, -1, 1], np.int32)

COARSE_RANGE = 4                 # half-res exhaustive range (full +-8)
MV_FULL_MAX = 8                  # |full-pel MV| bound after refine
# center-outward coarse offsets (order = tie order; ties prefer the
# shorter MV)
_C_OFFS = sorted(((dy, dx)
                  for dy in range(-COARSE_RANGE, COARSE_RANGE + 1)
                  for dx in range(-COARSE_RANGE, COARSE_RANGE + 1)),
                 key=lambda o: (abs(o[0]) + abs(o[1]), abs(o[0])))
_C_DY = np.array([o[0] for o in _C_OFFS], np.int32)
_C_DX = np.array([o[1] for o in _C_OFFS], np.int32)

WIN_L = 26                       # luma window (covers +-1 refine+qpel)
WIN_C = 11                       # chroma window (8 + 4-tap reach)

LEVEL_CHUNK = 6144       # sparse-level entries in chunk 0 of a packed row

# edge-offset classes: the two neighbours (dy0, dx0), (dy1, dx1) of a
# sample (horizontal, vertical, 135 and 45 degrees)
_EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0),
                 (-1, -1, 1, 1), (-1, 1, 1, -1))
# edge category by sign(p - n0) + sign(p - n1) + 2: a local minimum is 1,
# a concave corner 2, a convex corner 3, a local maximum 4, the rest 0
_EO_CATEGORY = (1, 2, 0, 3, 4)
# edge categories 1, 2 take offsets >= 0, categories 3, 4 offsets <= 0
_EO_FORCE_SIGN = (1, 1, -1, -1)


def _untimed(name: str, fn):
    """The default stage hook: runs fn(). A profiler passes its own
    hook(name, fn), which times each named stage of the encoder's code
    (profile_hevc.py)."""
    return fn()


def run_frame(kind: str, run, refs):
    """The default frame hook of encode_run_rows and encode_run_pairs:
    run() codes the frame. A profiler passes its own hook(kind, run,
    refs), called once per frame in coding order, which may time the
    call or give run a stage hook, run(stage); kind is "I", "P" or "B"
    and refs the frame's reference planes: none for an IDR, (past,) for
    a P frame, (past, future) for a B frame (chip_smoke.py,
    profile_hevc.py)."""
    return run()


def _band(taps: np.ndarray, n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) matrix M with M[o + k, o] = taps[k]: x @ M applies
    the filter along x's last axis (output o reads inputs o..o+7)."""
    m = np.zeros((n_in, n_out), np.float64)
    for o in range(n_out):
        m[o:o + len(taps), o] = taps
    return m


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """Constant tables on `device`, built once per device."""
    h8 = np.array([[1]])
    while h8.shape[0] < 8:
        h8 = np.block([[h8, h8], [h8, -h8]])
    lf = LUMA_FILTER.astype(np.float64)
    hmat = np.stack([_band(lf[f], 24, 17) for f in range(4)])
    f64 = functools.partial(torch.tensor, dtype=torch.float64,
                            device=device)
    i32 = functools.partial(torch.tensor, dtype=I32, device=device)
    i64 = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return {
        "t16": f64(T16.astype(np.float64)),
        "t8": f64(T8.astype(np.float64)),
        "t4": f64(T4.astype(np.float64)),
        "h8": f64(h8.astype(np.float64)),
        "qpel_h": f64(hmat),                          # (4, 24, 17)
        "qpel_v": f64(hmat.transpose(0, 2, 1).copy()),  # (4, 17, 24)
        "chroma_filter": i32(CHROMA_FILTER.astype(np.int32)),
        "modes": i32(_MODES),
        "sub_dy": i64(_SUB_DY), "sub_dx": i64(_SUB_DX),
        "c_dy": i64(_C_DY), "c_dx": i64(_C_DX),
        "eo_category": i32(_EO_CATEGORY),
        "eo_force_sign": i64(_EO_FORCE_SIGN),
    }


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact a @ b of integer-valued tensors as int32: a float64 matmul
    (CUDA has no integer matmul; float64 is exact below 2^53, and no
    product on the codec path comes near)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(I32)


def _argmin_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first minimum of integer x along dim (jnp.argmin's
    tie rule), from packed (value << 8 | index) keys, so that no
    device's reduction order can pick another of equal minima."""
    m = x.shape[dim]
    if m > 256:
        raise ValueError(f"_argmin_first: {m} candidates, at most 256")
    shape = [1] * x.ndim
    shape[dim] = m
    idx = torch.arange(m, device=x.device).view(shape)
    return (((x.to(torch.int64) << 8) | idx).amin(dim) & 255)


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicating pad of a 2-D plane of any dtype (jnp.pad's
    mode="edge")."""
    h, w = x.shape
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


# ---------------------------------------------------------------------------
# transforms / quant (spec 8.6; int32 values, exact float64 products)
# ---------------------------------------------------------------------------

def _fwd_transform(res, t, log2n: int):
    """res (..., n, n) int32 -> coefficients; t the (n, n) float64
    transform matrix."""
    s1 = log2n - 1
    s2 = log2n + 6
    a = (_imatmul(t, res) + (1 << (s1 - 1))) >> s1
    return (_imatmul(a, t.T) + (1 << (s2 - 1))) >> s2


def _inv_transform(coef, t, log2n: int):
    """coef (dequantized, clipped to +-32767) -> residual."""
    a = ((_imatmul(t.T, coef) + 64) >> 7).clamp(-32768, 32767)
    return ((_imatmul(a, t) + 2048) >> 12).clamp(-32768, 32767)


def _quantize(coef, qp: int, log2n: int, intra: bool = True):
    qbits = 21 + qp // 6 - log2n
    scale = int(QUANT_SCALES[qp % 6])
    # HM rounding offsets: 171/512 intra, 85/512 inter
    off = (171 if intra else 85) << (qbits - 9)
    level = (coef.abs() * scale + off) >> qbits
    return torch.sign(coef) * level


def _dequantize(level, qp: int, log2n: int):
    bd_shift = log2n + 3
    scale = int(INV_QUANT_SCALES[qp % 6]) * 16
    d = (level * (scale << (qp // 6)) + (1 << (bd_shift - 1))) >> bd_shift
    return d.clamp(-32768, 32767)


def _code_tu(src, pred, qp: int, t, log2n: int, intra: bool = True):
    """Quantized levels + reconstruction for one batch of TUs."""
    lv = _quantize(_fwd_transform(src - pred, t, log2n), qp, log2n,
                   intra=intra)
    cbf = (lv != 0).flatten(-2).any(-1)
    rec_res = _inv_transform(_dequantize(lv, qp, log2n), t, log2n)
    rec = (pred + torch.where(cbf[..., None, None], rec_res, 0)).clamp(0, 255)
    return lv, rec


def _quads(x):
    """(..., n, n) -> (..., 4, n/2, n/2), z-order TL/TR/BL/BR."""
    *lead, n, _ = x.shape
    h = n // 2
    return x.reshape(*lead, 2, h, 2, h).transpose(-3, -2).reshape(
        *lead, 4, h, h)


def _unquads(q):
    """Inverse of _quads."""
    *lead, _, h, _ = q.shape
    return q.reshape(*lead, 2, 2, h, h).transpose(-3, -2).reshape(
        *lead, 2 * h, 2 * h)


def _tb_bits_dev(lv):
    """Estimated bits of each TB: (..., n, n) -> (...) int32, 24 + 6 *
    nnz + 2 * sum(min(|l|, 8)), and 2 for a TB without levels."""
    a = lv.abs().flatten(-2)
    nnz = (a > 0).sum(-1, dtype=I32)
    bits = 24 + 6 * nnz + 2 * a.clamp(max=8).sum(-1, dtype=I32)
    return torch.where(nnz == 0, 2, bits)


def _code_inter_tus_dev(sy, su, sv, py, pu, pv, qp: int, qp_c: int,
                        lam: int):
    """Per CU, single TUs (16x16 luma, 8x8 chroma) or the quadrant split
    (four 8x8 luma, four 4x4 chroma TUs, coded independently) by the
    cost 16 * SSD + lam * bits, flag bits 2 and 4; the split only where
    it costs strictly less. Batched over leading dims. Returns (split,
    lv_y, lv_u, lv_v, rec_y, rec_u, rec_v), the split's levels and
    reconstruction stored in place (_unquads)."""
    c = _consts(sy.device)
    single = [_code_tu(sy, py, qp, c["t16"], 4, intra=False),
              _code_tu(su, pu, qp_c, c["t8"], 3, intra=False),
              _code_tu(sv, pv, qp_c, c["t8"], 3, intra=False)]
    quads = []
    for src, pred, t, log2n, q in ((sy, py, c["t8"], 3, qp),
                                   (su, pu, c["t4"], 2, qp_c),
                                   (sv, pv, c["t4"], 2, qp_c)):
        lv, rec = _code_tu(_quads(src), _quads(pred), q, t, log2n,
                           intra=False)
        quads.append((_unquads(lv), _unquads(rec)))

    # int32 as the JAX code (qp <= 51): 16 * SSD <= 16 * (256 + 2 * 64)
    # * 255^2 ~ 4.0e8 and lam * bits <= 74711 * 8740 ~ 6.6e8, so the
    # sum stays below 2^31
    def cost(opt, split: bool):
        ssd = torch.zeros(sy.shape[:-2], dtype=I32, device=sy.device)
        bits = torch.full(sy.shape[:-2], 4 if split else 2, dtype=I32,
                          device=sy.device)
        for (lv, rec), src in zip(opt, (sy, su, sv)):
            d = src.to(I32) - rec
            ssd += (d * d).flatten(-2).sum(-1, dtype=I32)
            bits += (_tb_bits_dev(_quads(lv)).sum(-1, dtype=I32) if split
                     else _tb_bits_dev(lv))
        return 16 * ssd + lam * bits

    split = cost(quads, True) < cost(single, False)
    m = split[..., None, None]
    lvs = [torch.where(m, b, a) for (b, _), (a, _) in zip(quads, single)]
    recs = [torch.where(m, b, a) for (_, b), (_, a) in zip(quads, single)]
    return (split, *lvs, *recs)


# ---------------------------------------------------------------------------
# 8x8 Hadamard SATD
# ---------------------------------------------------------------------------

def _satd8_blocks(d):
    """Sum of the four 8x8 Hadamard SATDs of each 16x16 block:
    d (..., 16, 16) int32 with |d| <= 255 -> (...) int32. Each 8x8 sum
    of |H8 d H8| is shifted right by 2 before the four are added (the
    JAX butterflies `_satd8_blocks_bf` / `_satd8_t` give the same
    values: the abs-sum does not depend on the order of H8's rows)."""
    lead = d.shape[:-2]
    x = d.reshape(*lead, 2, 8, 2, 8).transpose(-3, -2)   # (..., 2, 2, 8, 8)
    h8 = _consts(d.device)["h8"]
    y = torch.matmul(torch.matmul(h8, x.to(torch.float64)), h8)
    s8 = y.abs().sum((-1, -2)).to(I32) >> 2              # (..., 2, 2)
    return s8.sum((-1, -2), dtype=I32)


def _satd8_frame(diff):
    """Per-16x16-CU SATD of a (H, W) int32 difference plane."""
    return _satd8_blocks(_blocks(diff, CTB))


# ---------------------------------------------------------------------------
# intra prediction from a left column (row-slice reference reduction)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _angular_tables(n: int, modes: tuple, device: torch.device):
    """Two-tap tables of the angular modes (spec 8.4.4.2.6): output
    (y, x) of angle a is ((32 - fact) * ref[i0] + fact * ref[i0 + 1]
    + 16) >> 5 with i0 = y + ((x + 1) * a >> 5), fact = (x + 1) * a & 31.
    Returns i0 (M, n, n) int64 and fact (M, 1, n) int32."""
    a = np.array(modes, np.int64)[:, None]
    xs = np.arange(1, n + 1, dtype=np.int64)[None, :]
    idx, fact = (xs * a) >> 5, (xs * a) & 31                 # (M, n)
    i0 = np.arange(n)[None, :, None] + idx[:, None, :]       # (M, n, n)
    return (torch.tensor(i0, device=device),
            torch.tensor(fact[:, None, :].astype(np.int32), device=device))


def _intra_preds(left, n: int, luma: bool):
    """All candidate predictions from the left recon column.

    left: (R, n) int32. In the row-slice schedule the only reference is
    the left column; corner == left[0], the top row and below-left
    substitute to corner / left[-1] (spec 8.4.4.2.2). Returns
    (R, 12, n, n) in `_MODES` order."""
    r = left.shape[0]
    log2n = n.bit_length() - 1
    corner = left[:, :1]                                  # (R, 1)
    xs = torch.arange(n, dtype=I32, device=left.device)
    left2 = torch.cat([left, left[:, -1:].expand(r, n)], dim=1)

    # planar (spec 8.4.4.2.6); luma n>=8 smooths the refs (8.4.4.2.3):
    # with top == corner everywhere only the left column changes
    if luma and n >= 8:
        ext = torch.cat([corner, left2], dim=1)           # (R, 2n+1)
        fl = (ext[:, :-2] + 2 * ext[:, 1:-1] + ext[:, 2:] + 2) >> 2
        fl = torch.cat([fl, left2[:, -1:]], dim=1)
    else:
        fl = left2
    pl_left = fl[:, :n]
    bl = fl[:, n:n + 1]                                   # p[-1][nTbS]
    planar = ((n - 1 - xs)[None, None, :] * pl_left[:, :, None]
              + (xs + 1)[None, None, :] * corner[:, :, None]
              + (n - 1 - xs)[None, :, None] * corner[:, :, None]
              + (xs + 1)[None, :, None] * bl[:, :, None]
              + n) >> (log2n + 1)

    # DC (8.4.4.2.5): top sums to n * corner
    dc = (left.sum(1, keepdim=True, dtype=I32) + n * corner + n) >> (log2n + 1)
    dcp = dc[:, :, None].expand(r, n, n)
    if luma and n < 32:
        dcp = dcp.clone()
        dcp[:, 0, :] = (corner + 3 * dc + 2) >> 2         # top[x] == corner
        dcp[:, :, 0] = (left + 3 * dc + 2) >> 2
        dcp[:, 0, 0] = ((left[:, :1] + 2 * dc + corner + 2) >> 2)[:, 0]

    # horizontal (mode 10): rows replicate left (the luma row-0 filter
    # adds (top - corner) >> 1 == 0)
    hor = left[:, :, None].expand(r, n, n)

    # vertical (mode 26): columns replicate top == corner; luma col-0
    # filter: clip(corner + ((left - corner) >> 1))
    ver = corner[:, :, None].expand(r, n, n)
    if luma and n < 32:
        ver = ver.clone()
        ver[:, :, 0] = (corner + ((left - corner) >> 1)).clamp(0, 255)

    # angular 2..9 (horizontal class: only the left reference takes
    # part). Luma 16x16 smooths the reference for modes 2..8 (minDist
    # > 1), not for mode 9; chroma never.
    if luma and n >= 8:
        groups = ((_ANGLES[:7], fl), (_ANGLES[7:], left2))
    else:
        groups = ((_ANGLES, left2),)
    preds = [torch.stack([planar, dcp, hor, ver], dim=1)]
    for modes, base_ref in groups:
        i0, fact = _angular_tables(n, modes, left.device)
        refl = torch.cat([base_ref, base_ref[:, -1:]], dim=1)  # (R, 2n+1)
        preds.append(((32 - fact) * refl[:, i0] + fact * refl[:, i0 + 1]
                      + 16) >> 5)
    return torch.cat(preds, dim=1)


def _select_cand(preds, midx):
    """Each row's winning candidate: preds (R, M, n, n), midx (R,)."""
    return preds[torch.arange(preds.shape[0], device=preds.device), midx]


# ---------------------------------------------------------------------------
# motion search / compensation
# ---------------------------------------------------------------------------

def _down2_dev(x):
    """Half-resolution image: 2x2 mean with +2 >> 2 rounding."""
    h, w = x.shape
    return (x.reshape(h // 2, 2, w // 2, 2).sum((1, 3), dtype=I32) + 2) >> 2


def _blocks(x, n: int):
    """(H, W) -> (nch, ncw, n, n) row-major tiles."""
    h, w = x.shape
    return x.reshape(h // n, n, w // n, n).transpose(1, 2)


def _unblocks(b):
    """(nch, ncw, n, n) -> (H, W)."""
    nch, ncw, n, _ = b.shape
    return b.transpose(1, 2).reshape(nch * n, ncw * n)


def _coarse_search_dev(cur_h, ref_h_pad):
    """Exhaustive +-4 SAD over 8x8 blocks at half resolution, all 81
    offsets at once; the first minimum in `_C_OFFS` order wins (the
    JAX (sad << 7 | rank) keys). cur_h (h, w); ref_h_pad padded by
    COARSE_RANGE. Returns (h/8, w/8, 2) int32 offsets."""
    h, w = cur_h.shape
    c = _consts(cur_h.device)
    pad = COARSE_RANGE
    rows = torch.arange(h, device=cur_h.device) + pad + c["c_dy"][:, None]
    cols = torch.arange(w, device=cur_h.device) + pad + c["c_dx"][:, None]
    shifted = ref_h_pad[rows[:, :, None], cols[:, None, :]]   # (81, h, w)
    sad = (cur_h - shifted).abs().reshape(-1, h // 8, 8, w // 8, 8).sum(
        (2, 4), dtype=I32)                                    # (81, nbh, nbw)
    rank = _argmin_first(sad, 0)
    return torch.stack([c["c_dy"][rank], c["c_dx"][rank]], dim=-1).to(I32)


def _window_canvas_dev(ref_pad, off_yx, blk: int, win: int, orig: int,
                       pad: int):
    """Per-CU windows by indexed loads:

      E[cy, cx, wy, wx] =
        ref_pad[cy*blk + off_y + wy + orig + pad,
                cx*blk + off_x + wx + orig + pad]

    off_yx (nch, ncw, 2). The JAX canvases (`_window_canvas_dev`,
    `_window_canvas_t`) build the same windows without gathers."""
    nch, ncw = off_yx.shape[:2]
    dev = ref_pad.device
    ar = torch.arange(win, device=dev)
    r0 = (torch.arange(nch, device=dev)[:, None] * blk + off_yx[..., 0]
          + orig + pad)
    c0 = (torch.arange(ncw, device=dev)[None, :] * blk + off_yx[..., 1]
          + orig + pad)
    return ref_pad[(r0[..., None] + ar)[..., :, None],
                   (c0[..., None] + ar)[..., None, :]]


def _crop(x, oy, ox, size: int):
    """Per-element crops x[..., oy:oy+size, ox:ox+size] of x (..., H, W)
    at integer offset tensors oy, ox of shape x.shape[:-2]."""
    ar = torch.arange(size, device=x.device)
    rows = (oy[..., None] + ar)[..., :, None].expand(*oy.shape, size,
                                                     x.shape[-1])
    x = torch.gather(x, -2, rows)
    cols = (ox[..., None] + ar)[..., None, :].expand(*ox.shape, size, size)
    return torch.gather(x, -1, cols)


def _fullpel_refine_dev(cur_b, e):
    """+-1 full-pel SAD refine from the window canvas. cur_b
    (nch, ncw, 16, 16); e (nch, ncw, 26, 26) with the full-pel block
    at rows/cols [5:21]. Tie order = `_SUB_DY`/`_SUB_DX` (earlier
    wins). Returns (d_yx, w24): the chosen offset and the 24x24 window
    re-based at it (origin -4 relative to the refined MV)."""
    c = _consts(cur_b.device)
    blk = torch.stack([e[..., 5 + int(dy):21 + int(dy), 5 + int(dx):21 + int(dx)]
                       for dy, dx in zip(_SUB_DY, _SUB_DX)])
    sad = (cur_b - blk).abs().sum((-1, -2), dtype=I32)      # (9, nch, ncw)
    rank = _argmin_first(sad, 0)
    dy, dx = c["sub_dy"][rank], c["sub_dx"][rank]
    return torch.stack([dy, dx], dim=-1).to(I32), _crop(e, 1 + dy, 1 + dx, 24)


def _window_phases14(w24):
    """All 16 qpel phases of each 24x24 window at 14-bit intermediate
    precision (spec 8.5.4.2.2.1; 8-tap DCT-IF, horizontal then
    vertical, acc >> 6). w24 (..., 24, 24) -> (..., 16, 17, 17) int32,
    phase index fy*4 + fx; output column c is integer offset c - 1
    relative to the window's full-pel MV. Both filter passes are exact
    float64 products with banded tap matrices (sums below 2^22)."""
    c = _consts(w24.device)
    tmp = torch.matmul(w24.to(torch.float64)[..., None, :, :],
                       c["qpel_h"])                          # (..., 4, 24, 17)
    acc = torch.matmul(c["qpel_v"][:, None], tmp[..., None, :, :, :])
    acc = acc.to(I32) >> 6                                   # (..., 4, 4, 17, 17)
    return acc.flatten(-4, -3)


def _pred8_from14(p14):
    return ((p14 + 32) >> 6).clamp(0, 255)


def _phase_blocks(ph14, fy, fx):
    """16x16 prediction blocks at qpel offsets (fy, fx) (integer
    tensors shaped like the CU grid, or with extra leading candidate
    dims) from the phase tensor ph14 (nch, ncw, 16, 17, 17)."""
    p = ((fy & 3) << 2) | (fx & 3)
    grid = ph14.shape[:-3]
    lead = p.shape[:p.ndim - len(grid)]
    ph = torch.gather(ph14.expand(*lead, *ph14.shape), -3,
                      p[..., None, None, None].expand(*p.shape, 1, 17, 17))
    return _crop(ph[..., 0, :, :], (fy >> 2) + 1, (fx >> 2) + 1, 16)


def _subpel_refine_local(cur_b, ph14):
    """Half- then quarter-pel SATD refinement on the per-CU phase
    tensors: 9 half-pel candidates, then the 5 plus-shape quarter-pel
    ones around the winner; strictly better wins, earlier candidate on
    ties. cur_b (nch, ncw, 16, 16); ph14 (nch, ncw, 16, 17, 17). Returns
    (rel_q, pred14): the chosen qpel offset relative to the window's
    full-pel MV (components in [-3, 3]) and the winning 14-bit
    prediction blocks (nch, ncw, 16, 16)."""
    c = _consts(cur_b.device)
    grid = cur_b.shape[:-2]
    cand = (len(_SUB_DY),) + (1,) * len(grid)
    half = _phase_blocks(ph14, (2 * c["sub_dy"]).view(cand).expand(-1, *grid),
                         (2 * c["sub_dx"]).view(cand).expand(-1, *grid))
    rank1 = _argmin_first(_satd8_blocks(cur_b - _pred8_from14(half)), 0)
    hy, hx = 2 * c["sub_dy"][rank1], 2 * c["sub_dx"][rank1]
    q5 = (5,) + (1,) * len(grid)
    fy = hy + c["sub_dy"][:5].view(q5)
    fx = hx + c["sub_dx"][:5].view(q5)
    quarter = _phase_blocks(ph14, fy, fx)                    # (5, ..., 16, 16)
    rank2 = _argmin_first(_satd8_blocks(cur_b - _pred8_from14(quarter)), 0)
    rel = torch.stack([hy + c["sub_dy"][rank2], hx + c["sub_dx"][rank2]],
                      dim=-1).to(I32)
    pred14 = torch.gather(
        quarter, 0, rank2[None, ..., None, None].expand(1, *grid, 16, 16))[0]
    return rel, pred14


def _motion_luma_dev(cur, ref_pad, pad: int, stage=_untimed):
    """Full luma motion pipeline: hierarchical full-pel search +
    window-local subpel refine and MC. cur (H, W) int32; ref_pad int32
    padded by `pad` >= LUMA_SRC_PAD on every side. Returns
    (mv_q (nch, ncw, 2) int32, pred14 blocks (nch, ncw, 16, 16))."""
    h, w = cur.shape
    cur_h, ref_h_pad = stage("down2", lambda: (
        _down2_dev(cur).to(torch.int16),
        _down2_dev(ref_pad[pad - 8:pad + h + 8, pad - 8:pad + w + 8])
        .to(torch.int16)))                                   # half-res pad 4
    mvh = stage("coarse_search", lambda: _coarse_search_dev(cur_h, ref_h_pad))
    mv0 = (2 * mvh).clamp(-(MV_FULL_MAX - 1), MV_FULL_MAX - 1)
    e = stage("window_canvas", lambda: _window_canvas_dev(
        ref_pad, mv0, blk=CTB, win=WIN_L, orig=-5, pad=pad))
    cur_b = _blocks(cur, CTB)
    d_yx, w24 = stage("fullpel_refine", lambda: _fullpel_refine_dev(cur_b, e))
    ph14 = stage("qpel_phases", lambda: _window_phases14(w24))
    rel_q, pred14 = stage("subpel_refine",
                          lambda: _subpel_refine_local(cur_b, ph14))
    return 4 * (mv0 + d_yx) + rel_q, pred14


def _mc_chroma_window(ref_c_pad, mv_q, pad: int, out14: bool = False):
    """Chroma MC from per-CU windows: 4-tap eighth-sample filters
    (spec 8.5.4.2.2.2). ref_c_pad int32 padded by `pad` >= CHROMA_PAD.
    Returns the (hc, wc) prediction plane; with `out14` the 14-bit
    intermediates (acc >> 6) that bi-prediction combines."""
    oy = mv_q[..., 0] >> 3                                   # in [-5, 4]
    ox = mv_q[..., 1] >> 3
    e = _window_canvas_dev(ref_c_pad, torch.stack([oy, ox], dim=-1),
                           blk=CTB // 2, win=WIN_C, orig=-1, pad=pad)
    cf = _consts(mv_q.device)["chroma_filter"]
    ty = cf[(mv_q[..., 0] & 7).long()]                       # (nch, ncw, 4)
    tx = cf[(mv_q[..., 1] & 7).long()]
    n = CTB // 2
    tmp = sum(tx[:, :, None, None, m] * e[..., :, m:m + n]
              for m in range(4))                             # (nch,ncw,11,8)
    acc = sum(ty[:, :, None, None, k] * tmp[..., k:k + n, :]
              for k in range(4))                             # (nch,ncw,8,8)
    if out14:
        return _unblocks(acc >> 6)
    return _unblocks(((acc + 2048) >> 12).clamp(0, 255))


def _bi_combine(p0_14, p1_14):
    """Default bi-prediction combine (spec 8.5.4.2.3.2, 8-bit) of two
    14-bit predictions. Casts to int32 first: the sum of two 14-bit
    values (up to +-61710) would wrap in int16."""
    return ((p0_14.to(I32) + p1_14 + 64) >> 7).clamp(0, 255)


# ---------------------------------------------------------------------------
# legacy whole-frame motion helpers (no encoder path calls them)
# ---------------------------------------------------------------------------

def motion_search_dev(cur, ref=None, ref_pad=None, pad: int | None = None):
    """Exhaustive +-SEARCH_RANGE full-pel SAD search per 16x16 CU,
    reproducing codec/h265/inter.py:motion_search bit for bit: packed
    (sad << 9 | rank) keys, rank the offset's place in `_OFFS`, keep the
    center-outward tie order. Either `ref` (edge-padded here) or
    `ref_pad`, padded by `pad` (default SEARCH_RANGE, at least that) on
    every side. Returns (nch, ncw, 2) int32 full-pel MVs (dy, dx)."""
    h, w = cur.shape
    nch, ncw = h // CTB, w // CTB
    rng = SEARCH_RANGE
    if ref_pad is None:
        ref_pad, pad = _pad_edge(ref, rng, rng, rng, rng), rng
    elif pad is None:
        pad = rng
    if pad < rng:
        raise ValueError(f"reference padded by {pad}, need {rng}")
    cur = cur.to(I32)
    ref_pad = ref_pad.to(I32)
    n = 2 * rng + 1
    rank = np.empty((n, n), np.int32)          # (dy, dx) -> place in _OFFS
    rank[_OFF_DY + rng, _OFF_DX + rng] = np.arange(len(_OFFS))
    rank = torch.from_numpy(rank).to(cur.device)
    best = None
    for dy in range(-rng, rng + 1):
        rows = ref_pad[pad + dy:pad + dy + h, pad - rng:pad + rng + w]
        sh = rows.unfold(1, w, 1)                            # (h, n, w)
        sad = (cur[:, None] - sh).abs().reshape(nch, CTB, n, ncw, CTB) \
            .sum((1, 4), dtype=I32)                          # (nch, n, ncw)
        keys = (sad << 9) | rank[dy + rng][None, :, None]   # sad <= 65280
        keys = keys.amin(1)
        best = keys if best is None else torch.minimum(best, keys)
    k = (best & 511).long()
    off = torch.from_numpy(np.stack([_OFF_DY, _OFF_DX], -1)).to(cur.device)
    return off[k]


def _luma_qpel_planes(ref_y_pad, out14: bool = False):
    """All 16 (fy, fx) quarter-sample planes, index fy * 4 + fx, from a
    LUMA_SRC_PAD-padded reference (8-tap DCT-IF, spec 8.5.4.2.2.1;
    twin of codec/h265/inter.py:luma_qpel_planes). The planes are
    PLANE_PAD-padded. `out14`: the 14-bit intermediates (acc >> 6) that
    bi-prediction combines, instead of the rounded, clipped
    uni-prediction samples. Sums stay below 2^22 in int32."""
    src = ref_y_pad.to(I32)
    hs, ws = src.shape
    ho, wo = hs - 8, ws - 8
    taps = [[int(x) for x in LUMA_FILTER[f]] for f in range(4)]
    tmps = [sum(th[k] * src[:, 1 + k:1 + k + wo] for k in range(8))
            for th in taps]
    planes = []
    for tv in taps:
        for tmp in tmps:
            acc = sum(tv[k] * tmp[1 + k:1 + k + ho] for k in range(8))
            planes.append(acc >> 6 if out14
                          else ((acc + 2048) >> 12).clamp(0, 255))
    return torch.stack(planes)


# the legacy path's name (as in JAX) for the 8-bit uni-prediction samples
# of 14-bit intermediates
_uni_from_14 = _pred8_from14


def _cu_map(x, n: int):
    """Per-CU values (nch, ncw) -> per-sample (nch * n, ncw * n)."""
    return x.repeat_interleave(n, 0).repeat_interleave(n, 1)


def _mc_luma_qpel(planes, mv_q, h: int, w: int):
    """Whole-frame luma MC from the 16 qpel planes (_luma_qpel_planes)
    for per-CU qpel MVs (nch, ncw, 2) within the planes' PLANE_PAD: one
    gather."""
    mv = mv_q.long()
    sel = _cu_map((mv[..., 0] & 3) * 4 + (mv[..., 1] & 3), CTB)
    ri = torch.arange(h, device=mv.device)[:, None] \
        + _cu_map(mv[..., 0] >> 2, CTB) + PLANE_PAD
    ci = torch.arange(w, device=mv.device)[None, :] \
        + _cu_map(mv[..., 1] >> 2, CTB) + PLANE_PAD
    return planes[sel, ri, ci]


def _refine_subpel(cur, planes, mv_full, h: int, w: int):
    """Half- then quarter-pel SATD refinement of full-pel MVs over
    whole-frame MC (twin of codec/h265/inter.py:refine_subpel): 9
    half-pel candidates, then the 5 plus-shape quarter-pel ones around
    the winner; packed (cost << 4 | k) keys keep the strictly-better,
    earlier-candidate-wins order. Returns (nch, ncw, 2) int32 qpel MVs."""
    mv_q = mv_full.to(I32) * 4
    cur = cur.to(I32)
    sub_dy = torch.from_numpy(_SUB_DY).to(cur.device)
    sub_dx = torch.from_numpy(_SUB_DX).to(cur.device)
    for step in (2, 1):
        keys = []
        for k in range(9 if step == 2 else 5):
            cand = mv_q + torch.tensor([int(_SUB_DY[k]) * step,
                                        int(_SUB_DX[k]) * step],
                                       dtype=I32, device=cur.device)
            cost = _satd8_frame(cur - _mc_luma_qpel(planes, cand, h, w))
            keys.append((cost << 4) | k)
        k = (torch.stack(keys).amin(0) & 15).long()
        mv_q = mv_q + torch.stack([sub_dy[k], sub_dx[k]], -1) * step
    return mv_q


def _mc_chroma_qpel(ref_c_pad, mv_q, hc: int, wc: int,
                    out14: bool = False):
    """Whole-frame chroma MC for per-CU luma qpel MVs (eighth-sample
    chroma, spec 8.5.4.2.2.2): the 4x4 tap window of each sample with
    its CU's fraction weights, over the CHROMA_PAD-padded plane (twin
    of codec/h265/inter.py:mc_chroma_qpel / mc_chroma_qpel14). `out14`
    as in _luma_qpel_planes."""
    n = CTB // 2
    p = ref_c_pad.to(I32)
    mv = mv_q.long()
    cf = _consts(p.device)["chroma_filter"]
    ty = cf[_cu_map(mv[..., 0] & 7, n)]                      # (hc, wc, 4)
    tx = cf[_cu_map(mv[..., 1] & 7, n)]
    ri = torch.arange(hc, device=p.device)[:, None] \
        + _cu_map(mv[..., 0] >> 3, n) + CHROMA_PAD
    ci = torch.arange(wc, device=p.device)[None, :] \
        + _cu_map(mv[..., 1] >> 3, n) + CHROMA_PAD
    acc = sum(ty[..., k] * sum(tx[..., m] * p[ri - 1 + k, ci - 1 + m]
                               for m in range(4))
              for k in range(4))
    if out14:
        return acc >> 6
    return ((acc + 2048) >> 12).clamp(0, 255)


# ---------------------------------------------------------------------------
# in-loop deblocking (spec 8.7.2)
# ---------------------------------------------------------------------------

def _mv_diff(ma, mb, m1a=None, m1b=None):
    """Whether two CUs' MVs differ by 4 quarter samples or more in a
    component, in list 0 or (a B frame's m1a, m1b) in list 1."""
    diff = ((ma - mb).abs() >= 4).any(-1)
    if m1a is not None:
        diff = diff | ((m1a - m1b).abs() >= 4).any(-1)
    return diff


def _edge_bs_dev(is_intra, cbf_l, mv, mv1=None):
    """Per-CU-edge strengths (vertical edges, horizontal edges); mv1 a
    B frame's list-1 MVs."""
    def pair(a, b):
        m1 = (None, None) if mv1 is None else (mv1[a], mv1[b])
        diff = _mv_diff(mv[a], mv[b], *m1)
        return torch.where(is_intra[a] | is_intra[b], 2,
                           torch.where(cbf_l[a] | cbf_l[b] | diff, 1, 0)
                           ).to(I32)

    bs_v = pair((slice(None), slice(None, -1)), (slice(None), slice(1, None)))
    bs_h = pair(slice(None, -1), slice(1, None))
    return bs_v, bs_h


def _luma_edge_filter(p, q, bs, qp: int):
    """p: (E, L, 4) p3..p0, q: (E, L, 4) q0..q3, bs: (E, L); L a
    multiple of 4 (decision groups). Spec 8.7.2.5.3 / 8.7.2.5.7."""
    e, li, _ = p.shape
    beta = int(BETA_TABLE[min(max(qp, 0), 51)])
    tc_bs1 = int(TC_TABLE[min(max(qp, 0), 53)])
    tc_bs2 = int(TC_TABLE[min(max(qp + 2, 0), 53)])
    tc_all = torch.where(bs == 2, tc_bs2, torch.where(bs == 1, tc_bs1, 0)
                         ).to(p.dtype)

    p3, p2, p1, p0 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()

    g = li // 4
    dp4 = dp.reshape(e, g, 4)
    dq4 = dq.reshape(e, g, 4)
    d = dp4[..., 0] + dq4[..., 0] + dp4[..., 3] + dq4[..., 3]
    tc_g = tc_all.reshape(e, g, 4)[..., 0]
    bs_g = bs.reshape(e, g, 4)[..., 0]
    filt = (d < beta) & (bs_g > 0)

    def dsam(i):
        dpq = dp4[..., i] + dq4[..., i]
        sap = (p3 - p0).abs().reshape(e, g, 4)[..., i]
        saq = (q0 - q3).abs().reshape(e, g, 4)[..., i]
        spq = (p0 - q0).abs().reshape(e, g, 4)[..., i]
        return ((2 * dpq < (beta >> 2))
                & (sap + saq < (beta >> 3))
                & (spq < ((5 * tc_g + 1) >> 1)))

    strong = filt & dsam(0) & dsam(3)

    def rep(a):
        return a.repeat_interleave(4, dim=1)

    filt_l, strong_l, tc = rep(filt), rep(strong), rep(tc_g)

    def c2(x, ref):
        return torch.minimum(torch.maximum(x, ref - 2 * tc), ref + 2 * tc)

    sp0 = c2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = c2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = c2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = c2((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = c2((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = c2((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wtake = delta.abs() < 10 * tc
    dlt = torch.minimum(torch.maximum(delta, -tc), tc)
    wp0 = (p0 + dlt).clamp(0, 255)
    wq0 = (q0 - dlt).clamp(0, 255)
    side_th = (beta + (beta >> 1)) >> 3
    dep = rep(dp4[..., 0] + dp4[..., 3] < side_th)
    deq = rep(dq4[..., 0] + dq4[..., 3] < side_th)
    tc2 = tc >> 1
    dp1v = torch.minimum(torch.maximum(
        (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2), tc2)
    wp1 = (p1 + dp1v).clamp(0, 255)
    dq1v = torch.minimum(torch.maximum(
        (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2), tc2)
    wq1 = (q1 + dq1v).clamp(0, 255)

    wk = filt_l & ~strong_l & wtake
    st = filt_l & strong_l
    out_p = torch.stack([
        p3,
        torch.where(st, sp2, p2),
        torch.where(st, sp1, torch.where(wk & dep, wp1, p1)),
        torch.where(st, sp0, torch.where(wk, wp0, p0)),
    ], dim=-1)
    out_q = torch.stack([
        torch.where(st, sq0, torch.where(wk, wq0, q0)),
        torch.where(st, sq1, torch.where(wk & deq, wq1, q1)),
        torch.where(st, sq2, q2),
        q3,
    ], dim=-1)
    return out_p, out_q


def _chroma_edge_filter(p, q, bs, qp: int):
    """p: (E, L, 2) p1,p0; q: (E, L, 2) q0,q1; bs == 2 filters
    (spec 8.7.2.5.5)."""
    qpc = int(CHROMA_SCALE[min(max(qp, 0), 69)])
    tc = int(TC_TABLE[min(max(qpc + 2, 0), 53)])
    p1, p0 = p.unbind(-1)
    q0, q1 = q.unbind(-1)
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc, tc)
    f = bs == 2
    out_p = torch.stack(
        [p1, torch.where(f, (p0 + delta).clamp(0, 255), p0)], dim=-1)
    out_q = torch.stack(
        [torch.where(f, (q0 - delta).clamp(0, 255), q0), q1], dim=-1)
    return out_p, out_q


def _nnz8_map_dev(luma_lv, cbf_l, tu_split):
    """Per-8x8-quadrant luma TB nonzero map (2nch, 2ncw): the quadrant
    flag for split CUs, the CU's TB flag otherwise."""
    nch, ncw = cbf_l.shape
    qz = (luma_lv.reshape(nch, ncw, 2, 8, 2, 8) != 0).any(5).any(3)
    cu = (cbf_l != 0)[:, :, None, None].expand(nch, ncw, 2, 2)
    out = torch.where(tu_split[:, :, None, None], qz, cu)
    return out.transpose(1, 2).reshape(2 * nch, 2 * ncw)


def _seg_bs_dev(ii_a, ii_b, mv_a, mv_b, m1a, m1b, nz_pair):
    """Per-8-sample-segment luma strengths: per-CU inputs (nch, E), the
    list-1 MVs m1a, m1b or None, nz_pair per segment (2nch, E); returns
    (2nch, E)."""
    ii = (ii_a | ii_b).repeat_interleave(2, dim=0)
    mvd = _mv_diff(mv_a, mv_b, m1a, m1b).repeat_interleave(2, dim=0)
    return torch.where(ii, 2, torch.where(nz_pair | mvd, 1, 0)).to(I32)


def _deblock_axis(y, u, v, bs, bs_seg, int_bs, qp: int, nblk: int):
    """Filter all vertical edges of one orientation.

    y: (H, W) with CU edges every 16 columns. bs: (nrow_blocks, E)
    per-CTB strengths (chroma; constant along the edge), bs_seg:
    (2*nrow_blocks, E) luma per-8-sample-segment strengths, int_bs:
    (2*nrow_blocks, nblk) interior TU-edge strengths of split CUs (or
    None). CU-boundary and interior filters touch disjoint samples (>= 2
    columns apart), so their order is immaterial."""
    h, w = y.shape
    if nblk > 1:
        yv = y.reshape(h, nblk, CTB).clone()
        p = yv[:, :-1, CTB - 4:].transpose(0, 1)        # (E, H, 4)
        q = yv[:, 1:, :4].transpose(0, 1)
        bs_l = bs_seg.repeat_interleave(8, dim=0).T     # (E, H)
        fp, fq = _luma_edge_filter(p, q, bs_l, qp)
        yv[:, :-1, CTB - 4:] = fp.transpose(0, 1)
        yv[:, 1:, :4] = fq.transpose(0, 1)
        y = yv.reshape(h, w)

        hc, wc = u.shape
        nc = CTB // 2
        bs_c = bs.repeat_interleave(nc, dim=0).T        # (E, Hc)
        outs = []
        for plane in (u, v):
            pv = plane.reshape(hc, nblk, nc).clone()
            pc = pv[:, :-1, nc - 2:].transpose(0, 1)
            qc = pv[:, 1:, :2].transpose(0, 1)
            fpc, fqc = _chroma_edge_filter(pc, qc, bs_c, qp)
            pv[:, :-1, nc - 2:] = fpc.transpose(0, 1)
            pv[:, 1:, :2] = fqc.transpose(0, 1)
            outs.append(pv.reshape(hc, wc))
        u, v = outs
    if int_bs is not None:
        yv = y.reshape(h, nblk, CTB).clone()
        p = yv[:, :, 4:8].transpose(0, 1)               # (nblk, H, 4)
        q = yv[:, :, 8:12].transpose(0, 1)
        bs_i = int_bs.repeat_interleave(8, dim=0).T     # (nblk, H)
        fp, fq = _luma_edge_filter(p, q, bs_i, qp)
        yv[:, :, 4:8] = fp.transpose(0, 1)
        yv[:, :, 8:12] = fq.transpose(0, 1)
        y = yv.reshape(h, w)
    return y, u, v


def deblock_frame_dev(rec_y, rec_u, rec_v, is_intra, cbf_l, mv, qp: int,
                      mv1=None, tu_split=None, luma_lv=None):
    """HEVC deblock post-pass (vertical edges over the whole picture,
    then horizontal edges on the result). mv1 holds a B frame's list-1
    MVs: an edge is bS 1 where either list's MVs differ by 4 quarter
    samples or more. tu_split + luma_lv (both or
    neither) enable per-quadrant boundary strengths and the interior
    8-aligned TU edges of split CUs; without them no CU is split: each
    8x8 quadrant takes its CU's cbf, and the interior pass (which would
    filter nothing) is skipped. Returns uint8 planes."""
    y, u, v = (p.to(I32) for p in (rec_y, rec_u, rec_v))
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    if tu_split is None:
        nnz8 = (cbf_l != 0).repeat_interleave(2, 0).repeat_interleave(2, 1)
    else:
        nnz8 = _nnz8_map_dev(luma_lv, cbf_l, tu_split)
    bs_v, bs_h = _edge_bs_dev(is_intra, cbf_l, mv, mv1)

    def seg_and_int(ii, mvx, m1x, nnz8x, splitx, n):
        if n > 1:
            m1 = ((None, None) if m1x is None
                  else (m1x[:, :-1], m1x[:, 1:]))
            segs = _seg_bs_dev(ii[:, :-1], ii[:, 1:], mvx[:, :-1],
                               mvx[:, 1:], *m1,
                               nnz8x[:, 1:-1:2] | nnz8x[:, 2::2])
        else:
            segs = torch.zeros((2 * ii.shape[0], 0), dtype=I32,
                               device=ii.device)
        if splitx is None:
            return segs, None
        nz_int = nnz8x[:, ::2] | nnz8x[:, 1::2]
        sp2 = splitx.repeat_interleave(2, dim=0)
        return segs, (sp2 & nz_int).to(I32)

    seg_v, int_v = seg_and_int(is_intra, mv, mv1, nnz8, tu_split, ncw)
    y, u, v = _deblock_axis(y, u, v, bs_v, seg_v, int_v, qp, ncw)

    seg_h, int_h = seg_and_int(is_intra.T, mv.transpose(0, 1),
                               None if mv1 is None else mv1.transpose(0, 1),
                               nnz8.T,
                               None if tu_split is None else tu_split.T,
                               nch)
    yt, ut, vt = _deblock_axis(y.T, u.T, v.T, bs_h.T, seg_h, int_h, qp, nch)
    return tuple(p.T.to(torch.uint8).contiguous() for p in (yt, ut, vt))


# ---------------------------------------------------------------------------
# frame ops
# ---------------------------------------------------------------------------

def _col_view(plane, n: int):
    """(H, W) -> (ncols, nrows, n, n) column-major CTB tiles."""
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).permute(2, 0, 1, 3)


def _from_cols(cols):
    """(ncols, nrows, n, n) -> (H, W)."""
    ncw, nch, n, _ = cols.shape
    return cols.permute(1, 2, 0, 3).reshape(nch * n, ncw * n)


def _intra_col(ly, lu, lv, sy, su, sv, qp: int, qp_c: int):
    """One CTB column of intra coding for all rows, from each row's
    left recon columns; returns per-row (mode, levels, recon tiles)."""
    c = _consts(sy.device)
    preds = _intra_preds(ly, CTB, luma=True)             # (R, 12, 16, 16)
    midx = _argmin_first(_satd8_blocks(sy[:, None] - preds), 1)
    lv_y, rec_y = _code_tu(sy, _select_cand(preds, midx), qp, c["t16"], 4)
    pu = _select_cand(_intra_preds(lu, CTB // 2, luma=False), midx)
    pv = _select_cand(_intra_preds(lv, CTB // 2, luma=False), midx)
    lv_u, rec_u = _code_tu(su, pu, qp_c, c["t8"], 3)
    lv_v, rec_v = _code_tu(sv, pv, qp_c, c["t8"], 3)
    return c["modes"][midx], (lv_y, lv_u, lv_v), (rec_y, rec_u, rec_v)


def _i_frame_cols_ref(y, u, v, qp: int, qp_c: int):
    """Plain PyTorch version of K4 (`h265_intra_cols`): a loop over the
    CTB columns, every CTB row at once (rows are independent slices).
    The carry is each row's right recon column, 128 before column 0
    (the spec's no-neighbour value)."""
    y, u, v = (p.to(I32) for p in (y, u, v))
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    dev = y.device
    ys, us, vs = _col_view(y, CTB), _col_view(u, CTB // 2), _col_view(v, CTB // 2)
    left = (torch.full((nch, CTB), 128, dtype=I32, device=dev),
            torch.full((nch, CTB // 2), 128, dtype=I32, device=dev),
            torch.full((nch, CTB // 2), 128, dtype=I32, device=dev))
    cols = []
    for cx in range(ncw):
        mode, lvs, recs = _intra_col(*left, ys[cx], us[cx], vs[cx], qp, qp_c)
        left = tuple(r[:, :, -1] for r in recs)
        cols.append((mode, *lvs, *recs))
    mode, lv_y, lv_u, lv_v, rec_y, rec_u, rec_v = (
        torch.stack(t) for t in zip(*cols))
    return {
        "is_intra": torch.ones((nch, ncw), dtype=torch.bool, device=dev),
        "mode": mode.T,
        "mv": torch.zeros((nch, ncw, 2), dtype=I32, device=dev),
        "tu_split": torch.zeros((nch, ncw), dtype=torch.bool, device=dev),
        "luma_lv": lv_y.transpose(0, 1),
        "cb_lv": lv_u.transpose(0, 1),
        "cr_lv": lv_v.transpose(0, 1),
        "recon": tuple(_from_cols(r).to(torch.uint8)
                       for r in (rec_y, rec_u, rec_v)),
    }


def _check_intra_cols(y, u, v, qp: int, qp_c: int) -> None:
    """Raise on what K4 does not take."""
    if y.dim() != 2 or y.shape[0] % CTB or y.shape[1] % CTB or y.numel() == 0:
        raise ValueError(f"h265_intra_cols: y {tuple(y.shape)} is not "
                         "(H, W) in whole 16x16 CTBs")
    h, w = y.shape
    check_kernel_args("h265_intra_cols", [
        ("y", y, torch.uint8, (h, w)),
        ("u", u, torch.uint8, (h // 2, w // 2)),
        ("v", v, torch.uint8, (h // 2, w // 2))], (qp, qp_c))


# bytes per CTB of the carry pass's scratch: the left columns of 16 luma
# and 8 + 8 chroma samples that the CTB is coded with
_SCRATCH = 32


@functools.lru_cache(maxsize=None)
def _intra_launchers():
    """K4's two C entry points, the carry pass and the code pass (built
    and loaded at first use)."""
    from ceracoder_tpu_torch.utils.cuda_build import load_library

    lib = load_library("h265_intra")
    carry, code = lib.h265_intra_carry_launch, lib.h265_intra_code_launch
    carry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    code.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    carry.restype = code.restype = ctypes.c_int
    return carry, code


def h265_intra_cols(y, u, v, qp: int, qp_c: int) -> dict:
    """HEVC intra coding of every CTB of a frame, column after column
    (K4); arguments and result as `_i_frame_cols_ref`: y (H, W) uint8
    with H, W multiples of 16, u and v (H/2, W/2) uint8, all contiguous.

    On a CUDA tensor this launches the two kernels of csrc/h265_intra.cu
    on the current stream, or raises: the carry pass (one CTA per CTB
    row, the CTB columns in a loop), which writes the modes and each
    CTB's left columns to a scratch buffer, then the code pass (one warp
    per CTB), which writes the levels, the reconstruction and the
    constant is_intra, mv and tu_split. On a CPU tensor it runs
    `_i_frame_cols_ref`. `h265_intra_cols.launches` counts calls that
    launched K4, one per IDR; each launches both kernels."""
    qp, qp_c = int(qp), int(qp_c)
    _check_intra_cols(y, u, v, qp, qp_c)
    if y.device.type == "cpu":
        return _i_frame_cols_ref(y, u, v, qp, qp_c)
    if y.device.type != "cuda":
        raise ValueError(f"h265_intra_cols: unsupported device {y.device}")
    nch, ncw = y.shape[0] // CTB, y.shape[1] // CTB

    def empty(*shape, dtype=I32):
        return torch.empty((nch, ncw, *shape), dtype=dtype, device=y.device)
    out = {"is_intra": empty(dtype=torch.bool), "mode": empty(),
           "mv": empty(2), "tu_split": empty(dtype=torch.bool),
           "luma_lv": empty(CTB, CTB), "cb_lv": empty(CTB // 2, CTB // 2),
           "cr_lv": empty(CTB // 2, CTB // 2),
           "recon": (torch.empty_like(y), torch.empty_like(u),
                     torch.empty_like(v))}
    scratch = empty(_SCRATCH, dtype=torch.uint8)   # not an output
    planes = (y.data_ptr(), u.data_ptr(), v.data_ptr())
    carry, code = _intra_launchers()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = carry(*planes, out["mode"].data_ptr(), scratch.data_ptr(),
                    nch, ncw, qp, qp_c, stream)
        if err != 0:
            raise RuntimeError(f"h265_intra_cols carry kernel launch "
                               f"failed: CUDA error {err}")
        err = code(*planes, scratch.data_ptr(), out["mode"].data_ptr(),
                   *(out[k].data_ptr() for k in ("luma_lv", "cb_lv",
                                                 "cr_lv")),
                   *(p.data_ptr() for p in out["recon"]),
                   *(out[k].data_ptr() for k in ("is_intra", "tu_split",
                                                 "mv")),
                   nch, ncw, qp, qp_c, stream)
        if err != 0:
            raise RuntimeError(f"h265_intra_cols code kernel launch "
                               f"failed: CUDA error {err}")
    h265_intra_cols.launches += 1
    return out


h265_intra_cols.launches = 0


def _i_frame_core(y, u, v, qp: int, qp_c: int) -> dict:
    """Intra frame: every CTB intra-coded from its left neighbour (rows
    are independent slices). The CTB columns run in `h265_intra_cols`
    (K4 on a card, the plain loop on the CPU)."""
    return h265_intra_cols(y.contiguous(), u.contiguous(), v.contiguous(),
                           qp, qp_c)


def compact_slots(flat, cap: int):
    """Sparse-compact (n, 384) int16 slot rows for transfer.

    Keeps only nonzeros, in slot order within each row (row-major
    stream), by one prefix sum and one scatter. Returns
      pos  (cap,) int16  slot index within the row's 384-slot layout
      val  (cap,) int16  level
      nnz  () int32 total (> cap means the buffer overflowed).
    The JAX version compacts in three levels with segment caps; where
    those caps bind it reports cap + 1 for a frame that fits here.
    Both then code the same levels (its exact fallback), so the streams
    agree and only the packed rows differ."""
    n, slots = flat.shape
    mask = (flat != 0).reshape(-1)
    dst = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (dst < cap), dst, cap)
    slot = torch.arange(slots, dtype=torch.int16,
                        device=flat.device).repeat(n)
    zeros = torch.zeros(cap + 1, dtype=torch.int16, device=flat.device)
    pos = zeros.scatter(0, dst, slot)[:cap]
    val = zeros.scatter(0, dst, flat.reshape(-1))[:cap]
    return pos, val, mask.sum(dtype=I32)


def _compact_levels(luma_lv, cb_lv, cr_lv, cap: int):
    """Sparse-compact one frame's quantized levels for transfer: per
    CTB [luma 256 | cb 64 | cr 64] (raster inside each TU), see
    compact_slots. Also returns counts (nch, ncw, 3) int32, the per-TU
    nonzero counts."""
    nch, ncw = luma_lv.shape[:2]
    n_ctb = nch * ncw
    flat = torch.cat([luma_lv.reshape(n_ctb, 256),
                      cb_lv.reshape(n_ctb, 64),
                      cr_lv.reshape(n_ctb, 64)], dim=1).to(torch.int16)
    mask = flat != 0
    counts = torch.stack([mask[:, :256].sum(1, dtype=I32),
                          mask[:, 256:320].sum(1, dtype=I32),
                          mask[:, 320:].sum(1, dtype=I32)], dim=1)
    pos, val, nnz = compact_slots(flat, cap)
    return pos, val, counts.reshape(nch, ncw, 3), nnz


def _pad_ref(ref_y, ref_u, ref_v):
    """The reference planes as int32, edge-padded (== the spec's
    picture-edge clip): luma by LUMA_SRC_PAD, chroma by CHROMA_PAD."""
    pl, pc = LUMA_SRC_PAD, CHROMA_PAD
    return (_pad_edge(ref_y.to(I32), pl, pl, pl, pl),
            _pad_edge(ref_u.to(I32), pc, pc, pc, pc),
            _pad_edge(ref_v.to(I32), pc, pc, pc, pc))


def _p_motion(y, ref_y_pad, ref_u_pad, ref_v_pad, stage=_untimed):
    """A P frame's motion stage over the padded references (_pad_ref):
    luma search + MC, then chroma MC. Returns (mv_q, pred_y, pred_u,
    pred_v)."""
    mv_q, pred14 = _motion_luma_dev(y.to(I32), ref_y_pad, LUMA_SRC_PAD,
                                    stage)
    pred_u, pred_v = stage("chroma_mc", lambda: tuple(
        _mc_chroma_window(r, mv_q, CHROMA_PAD)
        for r in (ref_u_pad, ref_v_pad)))
    return mv_q, _unblocks(_pred8_from14(pred14)), pred_u, pred_v


def _b_motion(y, refs0, refs1, stage=_untimed):
    """A B frame's motion stage over its two padded references (_pad_ref;
    list 0 the past, list 1 the future picture): per list the luma
    search + 14-bit MC and the chroma MC at 14 bits, then the
    bi-prediction combine. Returns (mv0, mv1, pred_y, pred_u, pred_v)."""
    y32 = y.to(I32)
    mvs, p14 = [], []
    for ref_y_pad, ref_u_pad, ref_v_pad in (refs0, refs1):
        mv_q, luma14 = _motion_luma_dev(y32, ref_y_pad, LUMA_SRC_PAD, stage)
        chroma14 = stage("chroma_mc", lambda: tuple(
            _mc_chroma_window(r, mv_q, CHROMA_PAD, out14=True)
            for r in (ref_u_pad, ref_v_pad)))
        mvs.append(mv_q)
        p14.append((_unblocks(luma14), *chroma14))
    preds = stage("bi_combine", lambda: tuple(
        _bi_combine(a, b) for a, b in zip(*p14)))
    return (*mvs, *preds)


def _p_tail(y, u, v, mv_q, pred_y, pred_u, pred_v, qp: int, qp_c: int,
            tu_split: bool = False, mv1=None):
    """An inter frame from its motion stage's output: residuals (with
    `tu_split` the TU split's choice), the intra fallback, and the MVs
    (0 on intra CTBs): "mv", and for a B frame "mv1" from mv1."""
    outs = _inter_frame_tail(y, u, v, pred_y, pred_u, pred_v, qp, qp_c,
                             tu_split)
    intra = outs["is_intra"][..., None]
    outs["mv"] = torch.where(intra, 0, mv_q)
    if mv1 is not None:
        outs["mv1"] = torch.where(intra, 0, mv1)
    return outs


def _p_frame_core(y, u, v, ref_y, ref_u, ref_v, qp: int, qp_c: int,
                  stage=_untimed, tu_split: bool = False):
    """P frame against the (unpadded, uint8) reference planes: stages
    "motion" and "p_tail"."""
    mc = stage("motion", lambda: _p_motion(y, *_pad_ref(ref_y, ref_u,
                                                         ref_v)))
    return stage("p_tail", lambda: _p_tail(y, u, v, *mc, qp, qp_c,
                                           tu_split))


def _b_frame_core(y, u, v, past, fut, qp: int, qp_c: int,
                  stage=_untimed, tu_split: bool = False):
    """B frame bi-predicted from the past (list 0) and future (list 1)
    reference planes (unpadded uint8 triples): stages "motion" (both
    searches and the combine) and "b_tail". Adds "mv1", the list-1 MVs
    (0 on intra CTBs), to the P frame's outputs."""
    mv0, mv1, *preds = stage("motion", lambda: _b_motion(
        y, _pad_ref(*past), _pad_ref(*fut)))
    return stage("b_tail", lambda: _p_tail(y, u, v, mv0, *preds, qp, qp_c,
                                           tu_split, mv1=mv1))


def _inter_frame_tail(y, u, v, pred_y, pred_u, pred_v, qp: int,
                      qp_c: int, tu_split: bool = False):
    """Inter residuals + fully parallel per-CTB intra fallback. The
    source planes may stay uint8: they enter only differences with the
    int32 predictions, which promote them. With `tu_split` each CU's
    inter residual takes the TU split where it costs less
    (_code_inter_tus_dev, lambda SAO_LAMBDA[qp]).

    Intra fallback is only allowed when the left neighbour codes inter
    (an encoder-side choice; the bitstream stays legal), so every intra
    CTB's left reference column is the left neighbour's inter
    reconstruction and the whole frame's intra candidates, mode
    decision and selection run as one batch. The alternation rule
    use[c] = want[c] & ~use[c-1] is the parity of c against the start
    of its run of `want`, found with one cummax."""
    h, w = y.shape
    nch, ncw = h // CTB, w // CTB
    c = _consts(y.device)
    t16, t8 = c["t16"], c["t8"]

    inter_sad = _satd8_frame(y - pred_y)                 # (nch, ncw)
    sy, su, sv = _col_view(y, CTB), _col_view(u, CTB // 2), _col_view(v, CTB // 2)
    inter = (_col_view(pred_y, CTB), _col_view(pred_u, CTB // 2),
             _col_view(pred_v, CTB // 2))
    if tu_split:
        (split_cols, ilv_y, ilv_u, ilv_v, irec_y, irec_u,
         irec_v) = _code_inter_tus_dev(sy, su, sv, *inter, qp, qp_c,
                                       SAO_LAMBDA[min(max(qp, 0), 69)])
    else:
        split_cols = torch.zeros((ncw, nch), dtype=torch.bool,
                                 device=y.device)
        ilv_y, irec_y = _code_tu(sy, inter[0], qp, t16, 4, intra=False)
        ilv_u, irec_u = _code_tu(su, inter[1], qp_c, t8, 3, intra=False)
        ilv_v, irec_v = _code_tu(sv, inter[2], qp_c, t8, 3, intra=False)

    r = ncw * nch
    sy = sy.reshape(r, CTB, CTB)
    su = su.reshape(r, CTB // 2, CTB // 2)
    sv = sv.reshape(r, CTB // 2, CTB // 2)

    # left reference column per CTB = left neighbour's inter recon
    # right column (column 0: the spec's no-neighbour 128)
    def left_cols(irec, n):
        first = torch.full((1, nch, n), 128, dtype=I32, device=y.device)
        return torch.cat([first, irec[:-1, :, :, -1]]).reshape(r, n)

    preds = _intra_preds(left_cols(irec_y, CTB), CTB, luma=True)
    sads = _satd8_blocks(sy[:, None] - preds)            # (R, 12)
    midx = _argmin_first(sads, 1)
    intra_sad = sads.amin(1)
    want = (intra_sad * INTRA_BIAS_DEN
            < inter_sad.T.reshape(r) * INTRA_BIAS_NUM).reshape(ncw, nch)

    cidx = torch.arange(ncw, dtype=I32, device=y.device)[:, None]
    last0 = torch.cummax(torch.where(want, -1, cidx), dim=0).values
    use_cols = want & (((cidx - last0 - 1) & 1) == 0)    # (ncw, nch)
    m = use_cols.reshape(r)[:, None, None]

    alv_y, arec_y = _code_tu(sy, _select_cand(preds, midx), qp, t16, 4)
    pu = _select_cand(_intra_preds(left_cols(irec_u, CTB // 2), CTB // 2,
                                   luma=False), midx)
    pv = _select_cand(_intra_preds(left_cols(irec_v, CTB // 2), CTB // 2,
                                   luma=False), midx)
    alv_u, arec_u = _code_tu(su, pu, qp_c, t8, 3)
    alv_v, arec_v = _code_tu(sv, pv, qp_c, t8, 3)

    def sel(a, b):
        return torch.where(m, a, b.reshape(a.shape)).reshape(
            ncw, nch, *a.shape[1:])

    is_intra = use_cols.T
    mode = c["modes"][midx].reshape(ncw, nch).T
    return {
        "is_intra": is_intra,
        "mode": torch.where(is_intra, mode, 0),
        "tu_split": split_cols.T & ~is_intra,
        "luma_lv": sel(alv_y, ilv_y).transpose(0, 1),
        "cb_lv": sel(alv_u, ilv_u).transpose(0, 1),
        "cr_lv": sel(alv_v, ilv_v).transpose(0, 1),
        "recon": tuple(_from_cols(sel(a, b)).to(torch.uint8)
                       for a, b in ((arec_y, irec_y), (arec_u, irec_u),
                                    (arec_v, irec_v))),
    }


# ---------------------------------------------------------------------------
# SAO (spec 8.7.3): per-CTB offsets after the deblock
# ---------------------------------------------------------------------------

def _eo_category_dev(p, n0, n1):
    lut = _consts(p.device)["eo_category"]
    return lut[(torch.sign(p - n0) + torch.sign(p - n1) + 2).long()]


def _offset_gain_dev(sums, cnts, force_sign=None):
    """Each class's offset (the rounded mean of source - recon, at most
    7 in magnitude, clamped to the sign `force_sign` asks for where it
    is +-1) and its distortion gain 2*off*sum - cnt*off^2; an offset
    that gains nothing is 0, and so is its gain. int64 (sums, cnts),
    force_sign an int tensor broadcast against them, or None."""
    cnts = cnts.clamp(min=1)
    raw = (2 * sums.abs() + cnts) // (2 * cnts)
    off = raw.clamp(max=7) * torch.sign(sums)
    if force_sign is not None:
        off = torch.where(force_sign > 0, off.clamp(min=0),
                          torch.where(force_sign < 0, off.clamp(max=0), off))
    gain = 2 * off * sums - cnts * off * off
    return torch.where(gain > 0, off, 0), gain.clamp(min=0)


@functools.lru_cache(maxsize=None)
def _sao_geometry(h: int, w: int, n: int, device: torch.device):
    """Per-sample tables of an (h, w) plane in n x n CTBs: the CTB index
    (row-major), the CTB-interior mask (the estimator's edge classes
    never read across a CTB border) and, per edge class, where both
    neighbours lie inside the picture (the filter's mask). Outside
    these masks a sample's category is never read, so what lies past
    the picture's edge (the JAX code's jnp.roll wraps, `_eo_categories`
    pads) does not matter."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    ctb = (ys // n) * (w // n) + xs // n
    iy, ix = ys % n, xs % n
    interior = (iy > 0) & (iy < n - 1) & (ix > 0) & (ix < n - 1)
    ok = torch.stack([(ys + dy0 >= 0) & (ys + dy0 < h) & (ys + dy1 >= 0)
                      & (ys + dy1 < h) & (xs + dx0 >= 0) & (xs + dx0 < w)
                      & (xs + dx1 >= 0) & (xs + dx1 < w)
                      for dy0, dx0, dy1, dx1 in _EO_NEIGHBORS])
    return ctb, interior, ok


def _eo_categories(r):
    """(4, H, W) edge category of every int32 sample of r for each edge
    class; neighbours past the picture's edge read a zero pad (masked
    by every caller, see _sao_geometry)."""
    h, w = r.shape
    rp = torch.nn.functional.pad(r, (1, 1, 1, 1))

    def shifted(dy, dx):
        return rp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    n0 = torch.stack([shifted(dy0, dx0) for dy0, dx0, _, _ in _EO_NEIGHBORS])
    n1 = torch.stack([shifted(dy1, dx1) for _, _, dy1, dx1 in _EO_NEIGHBORS])
    return _eo_category_dev(r, n0, n1)


def _plane_categories(rec_planes) -> list:
    return [_eo_categories(p.to(I32)) for p in rec_planes]


def _class_sums(key, diff, nbins: int):
    """Per bin of `key` (int64, shaped like diff): the number of samples
    and the sum of diff (int64, exact in any order of addition)."""
    key = key.reshape(-1)
    zeros = torch.zeros(nbins, dtype=torch.int64, device=key.device)
    cnts = zeros.scatter_add(0, key, torch.ones_like(key))
    sums = zeros.scatter_add(0, key, diff.reshape(-1).to(torch.int64))
    return sums, cnts


def _sao_plane_stats(src, rec, n: int, cats) -> dict:
    """Per-CTB edge-class and band statistics of one plane (cats: its
    `_eo_categories`). Returns eo_off (4, nch, ncw, 4) and eo_gain (4,
    nch, ncw) per edge class, bo_off (nch, ncw, 32) per band and bo_win
    (nch, ncw, 29), the gain of the 4 bands from each start position."""
    r = rec.to(I32)
    diff = src.to(I32) - r
    h, w = r.shape
    nch, ncw = h // n, w // n
    n_ctb = nch * ncw
    ctb, interior, _ = _sao_geometry(h, w, n, r.device)
    # edge classes: samples off the CTB interior count in category 0
    cat = torch.where(interior, cats, 0)
    cls = torch.arange(4, device=r.device)[:, None, None]
    sums, cnts = _class_sums((cls * n_ctb + ctb) * 5 + cat,
                             diff.expand(4, h, w), 4 * n_ctb * 5)
    eo_off, eo_gain = _offset_gain_dev(sums.reshape(4, n_ctb, 5)[..., 1:],
                                       cnts.reshape(4, n_ctb, 5)[..., 1:],
                                       _consts(r.device)["eo_force_sign"])
    # bands of 8 sample values
    sums, cnts = _class_sums(ctb * 32 + (r >> 3), diff, n_ctb * 32)
    bo_off, gb = _offset_gain_dev(sums.reshape(n_ctb, 32),
                                  cnts.reshape(n_ctb, 32))
    acc = torch.nn.functional.pad(torch.cumsum(gb, -1), (1, 0))
    return {"eo_off": eo_off.reshape(4, nch, ncw, 4),
            "eo_gain": eo_gain.sum(-1).reshape(4, nch, ncw),
            "bo_off": bo_off.reshape(nch, ncw, 32),
            "bo_win": (acc[:, 4:] - acc[:, :-4]).reshape(nch, ncw, 29)}


def _sao_pick(stats_list, band_only: bool = False):
    """Choose (type, class, offsets per plane) maximizing the gain
    summed over the planes' stats (one for luma, two for chroma): the
    band offset at the first position of the largest window gain, then
    each edge class in turn where it gains strictly more. Returns (type
    (nch, ncw), class, [offsets (nch, ncw, 4) per plane], gain)."""
    win = sum(s["bo_win"] for s in stats_list)
    bp = _argmin_first(-win, -1)                 # first maximum
    best_gain = win.gather(-1, bp[..., None])[..., 0]      # >= 0
    take = best_gain > 0
    bt = take.to(torch.int64)
    bc = torch.where(take, bp, 0)
    idx = bp[..., None] + torch.arange(4, device=bp.device)
    boffs = [torch.where(take[..., None], s["bo_off"].gather(-1, idx), 0)
             for s in stats_list]
    if not band_only:
        for cls in range(4):
            g = sum(s["eo_gain"][cls] for s in stats_list)
            take = g > best_gain
            best_gain = torch.where(take, g, best_gain)
            bt = torch.where(take, 2, bt)
            bc = torch.where(take, cls, bc)
            boffs = [torch.where(take[..., None], s["eo_off"][cls], o)
                     for s, o in zip(stats_list, boffs)]
    return bt, bc, boffs, best_gain


def sao_estimate_dev(src_planes, rec_planes, qp: int, cats=None):
    """SAO parameters of one frame from its source and deblocked planes:
    luma picks band or edge offsets, chroma band offsets shared by Cb
    and Cr; a component whose gain does not exceed lambda(qp) times its
    syntax bits / 16 stays off. `cats` may hold each plane's
    `_eo_categories` (sao_frame_dev shares them with the filter).
    Returns (nch, ncw, 3, 6) int32: per CTB and component (type, class,
    4 offsets)."""
    lam = SAO_LAMBDA[min(max(int(qp), 0), 69)]
    cats = cats or _plane_categories(rec_planes)
    stats_y = _sao_plane_stats(src_planes[0], rec_planes[0], CTB, cats[0])
    ty, cy, (oy,), gy = _sao_pick([stats_y])
    keep_y = gy > (lam * SAO_BITS_LUMA) // 16
    stats_c = [_sao_plane_stats(s, r, CTB // 2, c)
               for s, r, c in zip(src_planes[1:], rec_planes[1:], cats[1:])]
    tc, cc, (ou, ov), gc = _sao_pick(stats_c, band_only=True)
    keep_c = gc > (lam * SAO_BITS_CHROMA) // 16

    def comp(t, c, offs, keep):
        p = torch.cat([t[..., None], c[..., None], offs], dim=-1)
        return torch.where(keep[..., None], p, 0)
    return torch.stack([comp(ty, cy, oy, keep_y), comp(tc, cc, ou, keep_c),
                        comp(tc, cc, ov, keep_c)], dim=2).to(I32)


def sao_apply_dev(rec_planes, params, cats=None):
    """Apply SAO parameters (sao_estimate_dev) to the deblocked planes:
    band offsets to the 4 bands from the CTB's start band, edge offsets
    by each sample's category in the CTB's class, with neighbours across
    CTB borders but not across the picture's edge (`cats` as for
    sao_estimate_dev). Returns uint8 planes."""
    outs = []
    cats = cats or _plane_categories(rec_planes)
    for ci, rec in enumerate(rec_planes):
        n = CTB if ci == 0 else CTB // 2
        r = rec.to(I32)
        h, w = r.shape
        nch, ncw = h // n, w // n
        # the CTB's (type, class, 4 offsets) at each sample: (H, W, 6)
        full = params[:, None, :, None, ci].expand(nch, n, ncw, n, 6)
        full = full.reshape(h, w, 6)
        t_full, c_full, offs = full[..., 0], full[..., 1].long(), full[..., 2:]
        band = (r >> 3) - c_full
        in_band = (t_full == 1) & (band >= 0) & (band < 4)
        _, _, ok = _sao_geometry(h, w, n, r.device)
        cls = c_full.clamp(0, 3)[None]
        cat = torch.where(ok.gather(0, cls)[0], cats[ci].gather(0, cls)[0],
                          0)
        is_eo = (t_full == 2) & (cat > 0)
        k = torch.where(in_band, band, torch.where(is_eo, cat - 1, 0))
        delta = torch.where(in_band | is_eo,
                            offs.gather(-1, k[..., None].long())[..., 0], 0)
        outs.append((r + delta).clamp(0, 255).to(torch.uint8))
    return tuple(outs)


def sao_frame_dev(src_planes, rec_planes, qp: int):
    """SAO of one frame: (sao_estimate_dev's parameters, sao_apply_dev's
    filtered planes), each plane's edge categories computed once."""
    cats = _plane_categories(rec_planes)
    params = sao_estimate_dev(src_planes, rec_planes, qp, cats)
    return params, sao_apply_dev(rec_planes, params, cats)


# ---------------------------------------------------------------------------
# run loop and the packed transfer rows
# ---------------------------------------------------------------------------

def run_pack_layout(n_ctb: int, chunk: int = LEVEL_CHUNK,
                    with_mv1: bool = False) -> dict:
    """Byte offsets of each section in one frame's packed transfer row
    (_pack_run_streams); `with_mv1` for a B frame's row. Sections are
    padded to 4-byte boundaries so host numpy views land aligned."""
    def pad4(x):
        return -(-x // 4) * 4

    off = {"nnz": 0, "meta": 4}
    off["counts"] = off["meta"] + pad4(n_ctb)
    off["mv"] = off["counts"] + pad4(2 * n_ctb)
    off["lv0"] = off["mv"] + pad4(2 * n_ctb)
    if with_mv1:
        off["mv1"], off["lv0"] = off["lv0"], off["lv0"] + pad4(2 * n_ctb)
    off["total"] = off["lv0"] + 4 * chunk
    return off


def _pack_run_streams(d, n: int, chunk: int = LEVEL_CHUNK) -> dict:
    """One uint8 transfer row per frame, in the JAX package's byte
    layout (run_pack_layout): nnz int32 | meta uint8 (bit7 is_intra,
    bit6 tu_split, low bits intra mode) | per-CTB nonzero level counts
    uint16 | mv int8 pairs | [a B frame's mv1 int8 pairs, where d has
    "mv1"] | level chunk 0 as interleaved (pos, val) int16. d holds the
    frames' stacked arrays (leading axis n). Returns "packed" (n, total)
    uint8 and "lv_rest" (n, cap - chunk, 2) int16, the level entries
    past chunk 0. Multi-byte fields are built in their own signed types
    and reinterpreted as bytes (torch's CPU build has no uint16
    arithmetic)."""
    nch, ncw = d["is_intra"].shape[1:3]
    n_ctb = nch * ncw

    def u8(a):
        return a.contiguous().view(torch.uint8).reshape(n, -1)

    def pad4(a):
        fill = torch.zeros((n, (-a.shape[1]) % 4), dtype=torch.uint8,
                           device=a.device)
        return torch.cat([a, fill], dim=1)

    meta = ((d["is_intra"].to(I32) << 7) | (d["tu_split"].to(I32) << 6)
            | d["mode"].to(I32)).to(torch.uint8)
    counts = d["counts"].reshape(n, n_ctb, -1).sum(-1, dtype=I32)
    pv = torch.stack([d["pos"].reshape(n, -1), d["val"].reshape(n, -1)],
                     dim=-1)                                 # (n, cap, 2)
    mvs = [pad4(u8(d[k].to(torch.int8).reshape(n, -1)))
           for k in ("mv", "mv1") if k in d]
    packed = torch.cat([
        u8(d["nnz"].to(I32).reshape(n, 1)),
        pad4(meta.reshape(n, n_ctb)),
        pad4(u8(counts.to(torch.int16))),
        *mvs,
        u8(pv[:, :chunk])], dim=1)
    return {"packed": packed, "lv_rest": pv[:, chunk:]}


def level_capacity(n_ctb: int, idr: bool,
                   cap: int | None = None) -> tuple[int, int]:
    """(capacity, chunk-0 size) of one frame's sparse levels, as the JAX
    encoder sizes them, so that fallbacks fall on the same frames. A P
    frame holds `cap` entries (default 48 per CTB, at least two chunks)
    rounded up to whole LEVEL_CHUNKs, chunk 0 one LEVEL_CHUNK. An IDR
    frame's chunk 0 holds ~25% of the dense 384 slots per CTB, so that
    a typical all-intra frame needs no extra entries; its capacity is
    at least two such chunks."""
    cap = cap or max(2 * LEVEL_CHUNK, n_ctb * 48)
    cap = -(-cap // LEVEL_CHUNK) * LEVEL_CHUNK
    if not idr:
        return cap, LEVEL_CHUNK
    chunk = -(-(n_ctb * 96) // LEVEL_CHUNK) * LEVEL_CHUNK
    return max(cap, 2 * chunk), chunk


def _pack_frame(o, cap: int, chunk: int) -> dict:
    """One frame's transfer row (_pack_run_streams; with a B frame's
    "mv1") from its core's outputs, and its dense int16 levels (the
    exact fallback)."""
    pos, val, counts, nnz = _compact_levels(o["luma_lv"], o["cb_lv"],
                                            o["cr_lv"], cap)
    row = {k: o[k][None] for k in ("is_intra", "tu_split", "mode", "mv",
                                   "mv1") if k in o}
    row.update(pos=pos[None], val=val[None], counts=counts[None],
               nnz=nnz[None])
    out = _pack_run_streams(row, 1, chunk)
    out["dense_lv"] = tuple(o[k].to(torch.int16)
                            for k in ("luma_lv", "cb_lv", "cr_lv"))
    return out


def encode_frame_row(y, u, v, ref, idr: bool, qp: int, qp_c: int,
                     cap: int, chunk: int, stage=_untimed,
                     sao: bool = False, tu_split: bool = False,
                     fut=None) -> dict:
    """One frame on the device: its core (stage "intra_core"; "motion"
    and "p_tail" against the reference planes `ref`; or, given the
    future reference planes `fut`, a B frame's "motion" and "b_tail"
    against `ref` and `fut`), the deblock ("deblock"), with `sao` the
    SAO estimate and filter ("sao") and its transfer row
    ("compact_pack"). `tu_split` lets the inter frames' CUs take the TU
    split. Returns "packed" (1, total) uint8 and "lv_rest" (see
    _pack_run_streams), "dense_lv" (the frame's luma, cb and cr levels
    as int16, the exact fallback when the sparse stream overflows),
    "recon" (the filtered uint8 planes, a P frame's the next frame's
    reference) and with `sao` "sao", the (nch, ncw, 3, 6) int32 SAO
    parameters."""
    if idr:
        o = stage("intra_core", lambda: _i_frame_core(y, u, v, qp, qp_c))
    elif fut is None:
        o = _p_frame_core(y, u, v, *ref, qp, qp_c, stage=stage,
                          tu_split=tu_split)
    else:
        o = _b_frame_core(y, u, v, ref, fut, qp, qp_c, stage=stage,
                          tu_split=tu_split)
    # an IDR and a frame without the split have no split CU: the deblock
    # then skips the interior TU edges, which it would not filter
    split = ({"tu_split": o["tu_split"], "luma_lv": o["luma_lv"]}
             if tu_split and not idr else {})
    recon = stage("deblock", lambda: deblock_frame_dev(
        *o["recon"], o["is_intra"], (o["luma_lv"] != 0).flatten(2).any(-1),
        o["mv"], qp, mv1=o.get("mv1"), **split))
    if sao:
        params, recon = stage("sao", lambda: sao_frame_dev((y, u, v), recon,
                                                           qp))
    out = stage("compact_pack", lambda: _pack_frame(o, cap, chunk))
    out["recon"] = recon
    if sao:
        out["sao"] = params
    return out


def _frame_run(planes, i: int, ref, idr: bool, qp: int, qp_c: int,
               cap: int, chunk: int, sao: bool, tu_split: bool, fut=None):
    """The run(stage) of frame i of a run (run_frame): its planes
    (stage "source"), then encode_frame_row."""
    def run(stage=_untimed):
        return encode_frame_row(*stage("source", lambda: planes(i)), ref,
                                idr, qp, qp_c, cap, chunk, stage=stage,
                                sao=sao, tu_split=tu_split, fut=fut)
    return run


def encode_run_rows(planes, idr_flags, qps, qpcs, ref, caps, chunks,
                    sao: bool = False, tu_split: bool = False,
                    frame=run_frame) -> list[dict]:
    """Encode a run of frames on the device, in order, carrying the
    filtered reference from frame to frame.

    planes(f) gives frame f's (y, u, v) device planes at the padded
    size; ref is the reference before the run (uint8 planes); per frame
    f: idr_flags[f], qps[f], qpcs[f] and the sparse-level capacity
    caps[f] and chunk-0 size chunks[f] of its packed row; `sao` runs
    the SAO stage after each deblock, `tu_split` lets P frames take the
    TU split; `frame` is the frame hook (run_frame). Returns
    encode_frame_row's dict per frame. Port of the JAX encode_run_rows
    and encode_idr_rows/_idr_tail."""
    outs = []
    for f, idr in enumerate(idr_flags):
        idr = bool(idr)
        out = frame("I" if idr else "P",
                    _frame_run(planes, f, ref, idr, int(qps[f]),
                               int(qpcs[f]), caps[f], chunks[f], sao,
                               tu_split),
                    () if idr else (ref,))
        ref = out["recon"]
        outs.append(out)
    return outs


def encode_run_pairs(planes, npair: int, qps, qpcs, ref, cap: int,
                     sao: bool = False, tu_split: bool = False,
                     frame=run_frame) -> list[tuple[dict, dict]]:
    """Encode an IBPBP segment's (B, P) display pairs on the device.

    planes(i) gives display frame i's (y, u, v) device planes of the
    segment (pair k: the B frame 2k, the P frame 2k + 1), qps[i] and
    qpcs[i] its QPs; ref is the reference before the segment. In each
    pair the P frame codes first against the carried reference, then
    the B frame bi-predicts between that reference and the P frame's
    filtered reconstruction, which is carried on (a B frame is never a
    reference). Both rows hold `cap` sparse levels in LEVEL_CHUNK
    chunks; `frame` is the frame hook (run_frame). Returns (P, B)
    encode_frame_row dicts per pair. Port of the JAX encode_run_pairs
    (a lax.scan there, a loop here)."""
    outs = []
    for k in range(npair):
        ib, ip = 2 * k, 2 * k + 1
        out_p = frame("P", _frame_run(planes, ip, ref, False, int(qps[ip]),
                                      int(qpcs[ip]), cap, LEVEL_CHUNK, sao,
                                      tu_split), (ref,))
        fut = out_p["recon"]
        out_b = frame("B", _frame_run(planes, ib, ref, False, int(qps[ib]),
                                      int(qpcs[ib]), cap, LEVEL_CHUNK, sao,
                                      tu_split, fut=fut), (ref, fut))
        ref = fut
        outs.append((out_p, out_b))
    return outs
