"""The port's HEVC device ops (ceracoder_tpu_torch/ops/h265.py) against
their JAX twins in ceracoder_tpu/ops/h265.py, on the CPU: the same
numpy inputs, made from a seed, through both; every comparison is
exact (the codec is integer-exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceracoder_tpu.ops.h265 as J
import ceracoder_tpu_torch.ops.h265 as T
from ceracoder_tpu.codec.h265.rowslice import densify_levels as j_densify
from ceracoder_tpu.codec.h265.tables import T4, T8, T16
from ceracoder_tpu_torch.codec.h265.rowslice import densify_levels
from tests.test_h265_rows import _panning

W, H = 96, 64


def t(a):
    return torch.as_tensor(np.array(a))


def same(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _f64(m):
    return torch.tensor(np.asarray(m, np.float64))


@pytest.mark.parametrize("t_np,log2n", [(T16, 4), (T8, 3), (T4, 2)])
def test_transforms_extreme_ranges(t_np, log2n):
    """Forward and inverse transforms at random and worst-case operand
    ranges (all-extreme residuals, coefficients on the clip rails)."""
    rng = np.random.default_rng(7)
    n = 1 << log2n
    tj = jnp.asarray(t_np, jnp.int32)
    res = rng.integers(-255, 256, (64, n, n)).astype(np.int32)
    res[0], res[1] = 255, -255
    res[2, :, ::2], res[2, :, 1::2] = 255, -255
    same(T._fwd_transform(t(res), _f64(t_np), log2n),
         J._fwd_transform(jnp.asarray(res), tj, log2n))
    coef = rng.integers(-32768, 32768, (64, n, n)).astype(np.int32)
    coef[0], coef[1] = 32767, -32768
    coef[2, ::2], coef[2, 1::2] = 32767, -32768
    same(T._inv_transform(t(coef), _f64(t_np), log2n),
         J._inv_transform(jnp.asarray(coef), tj, log2n))


@pytest.mark.parametrize("qp", [0, 22, 30, 37, 51])
def test_quant_and_code_tu(qp):
    rng = np.random.default_rng(qp)
    coef = rng.integers(-40000, 40000, (32, 16, 16)).astype(np.int32)
    for intra in (True, False):
        same(T._quantize(t(coef), qp, 4, intra),
             J._quantize(jnp.asarray(coef), qp, 4, intra))
    lv = rng.integers(-3000, 3000, (32, 8, 8)).astype(np.int32)
    same(T._dequantize(t(lv), qp, 3), J._dequantize(jnp.asarray(lv), qp, 3))
    src = rng.integers(0, 256, (40, 16, 16)).astype(np.int32)
    pred = rng.integers(0, 256, (40, 16, 16)).astype(np.int32)
    for tm, n, log2n in ((T16, 16, 4), (T8, 8, 3)):
        s, p = src[:, :n, :n], pred[:, :n, :n]
        for intra in (True, False):
            got = T._code_tu(t(s), t(p), qp, _f64(tm), log2n, intra)
            want = J._code_tu(jnp.asarray(s), jnp.asarray(p), qp,
                              jnp.asarray(tm, jnp.int32), log2n, intra)
            for a, b in zip(got, want):
                same(a, b)


def test_satd_matches_butterflies():
    rng = np.random.default_rng(3)
    d = rng.integers(-255, 256, (6, 5, 16, 16)).astype(np.int32)
    d[0, 0], d[0, 1] = 255, -255
    got = T._satd8_blocks(t(d))
    same(got, J._satd8_blocks_bf(jnp.asarray(d)))
    same(got, J._satd8_t(jnp.asarray(d.transpose(2, 3, 0, 1))))
    plane = rng.integers(-255, 256, (H, W)).astype(np.int32)
    same(T._satd8_frame(t(plane)), J._satd8_frame(jnp.asarray(plane)))


@pytest.mark.parametrize("n,luma", [(16, True), (8, False)])
def test_intra_preds(n, luma):
    rng = np.random.default_rng(n)
    left = rng.integers(0, 256, (50, n)).astype(np.int32)
    left[0] = 0
    left[1] = 255
    same(T._intra_preds(t(left), n, luma),
         J._intra_preds(jnp.asarray(left), n, luma))


def test_argmin_keeps_first_of_tied_minima():
    x = np.array([[5, 3, 3, 9], [2, 2, 2, 2], [7, 1, 4, 1], [0, 8, 0, 0]],
                 np.int32)
    same(T._argmin_first(t(x), 1), jnp.argmin(jnp.asarray(x), axis=1))
    same(T._argmin_first(t(x.T.copy()), 0),
         jnp.argmin(jnp.asarray(x.T), axis=0))
    # a flat picture: every left column is flat, so all 12 candidate
    # modes of every CTB predict the same block, every SATD ties, and
    # both cores pick the first mode (planar) everywhere
    flat = (np.full((H, W), 90, np.uint8), np.full((H // 2, W // 2), 60,
                                                   np.uint8),
            np.full((H // 2, W // 2), 200, np.uint8))
    got = T._i_frame_core(*(t(p) for p in flat), 30, 29)
    _cmp_outs(got, J.encode_frame_i_rows(*flat, 30, 29))
    assert not got["mode"].any()


def _cmp_outs(got, want):
    for k in ("is_intra", "mode", "mv", "tu_split", "luma_lv", "cb_lv",
              "cr_lv"):
        same(got[k], want[k])
    for a, b in zip(got["recon"], want["recon"]):
        assert a.dtype == torch.uint8
        same(a, b)


@pytest.mark.parametrize("qp", [22, 30, 38])
def test_i_frame_core(qp):
    rng = np.random.default_rng(13 + qp)
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    _cmp_outs(T._i_frame_core(t(y), t(u), t(v), qp, qp - 1),
              J.encode_frame_i_rows(y, u, v, qp, qp - 1))


def _ref_frames():
    frames = _panning(3)
    ref = tuple(np.asarray(p) for p in J.encode_frame_i_rows(
        *frames[0], 30, 29)["recon"])
    return frames, ref


def test_motion_chain():
    frames, ref = _ref_frames()
    y = frames[1][0].astype(np.int32)
    pad = J.LUMA_SRC_PAD
    ref_pad = np.pad(ref[0].astype(np.int32), pad, mode="edge")
    cur_h = np.asarray(J._down2_dev(jnp.asarray(y))).astype(np.int16)
    ref_h = np.asarray(J._down2_dev(jnp.asarray(
        ref_pad[pad - 8:pad + H + 8, pad - 8:pad + W + 8]))).astype(np.int16)
    same(T._down2_dev(t(y)), J._down2_dev(jnp.asarray(y)))
    same(T._coarse_search_dev(t(cur_h), t(ref_h)),
         jax.jit(J._coarse_search_dev)(cur_h, ref_h))

    mv_q, pred14 = T._motion_luma_dev(t(y), t(ref_pad), pad)
    jmv, jpred = jax.jit(J._motion_luma_dev, static_argnums=2)(
        y, ref_pad, pad)
    same(mv_q, jmv)
    same(pred14, np.asarray(jpred).transpose(2, 3, 0, 1))
    assert np.abs(np.asarray(jmv)).max() > 0       # real motion

    cpad = J.CHROMA_PAD
    for plane in ref[1:]:
        rc = np.pad(plane, cpad, mode="edge")
        same(T._mc_chroma_window(t(rc.astype(np.int32)), mv_q, cpad),
             jax.jit(J._mc_chroma_window, static_argnums=2)(
                 rc, np.asarray(jmv), cpad))


def test_window_canvas_matches_both_layouts():
    rng = np.random.default_rng(5)
    ref_pad = rng.integers(0, 256, (H + 26, W + 26)).astype(np.int32)
    off = rng.integers(-7, 8, (H // 16, W // 16, 2)).astype(np.int32)
    got = T._window_canvas_dev(t(ref_pad), t(off), 16, 26, -5, 13)
    same(got, J._window_canvas_dev(jnp.asarray(ref_pad), jnp.asarray(off),
                                   16, 26, -5, -7, 7, 13))
    same(got.permute(2, 3, 0, 1),
         J._window_canvas_t(jnp.asarray(ref_pad), jnp.asarray(off), 16, 26,
                            -5, -7, 7, 13))


def test_p_frame_core_motion_and_intra_fallback():
    frames, ref = _ref_frames()
    grad = np.tile(np.linspace(0, 255, W).astype(np.uint8), (H, 1))
    smooth = (grad, np.full((H // 2, W // 2), 90, np.uint8),
              np.full((H // 2, W // 2), 170, np.uint8))
    prev = ref
    intra_seen = False
    for f in (frames[1], frames[2], smooth):
        want = J.encode_frame_p_rows(*f, *prev, 30, 29)
        got = T._p_frame_core(*(t(p) for p in f), *(t(p) for p in prev),
                              30, 29)
        _cmp_outs(got, want)
        intra_seen |= bool(np.asarray(want["is_intra"]).any())
        prev = tuple(np.asarray(p) for p in want["recon"])
    assert intra_seen


@pytest.mark.parametrize("qp", [24, 32, 40])
def test_deblock(qp):
    frames, ref = _ref_frames()
    outs = J.encode_frame_p_rows(*frames[1], *ref, qp, qp - 1)
    cbf = np.asarray(outs["luma_lv"]).reshape(H // 16, W // 16, -1).any(-1)
    args = [np.asarray(p) for p in outs["recon"]] + [
        np.asarray(outs["is_intra"]), cbf, np.asarray(outs["mv"])]
    want = J.deblock_frame_jit(*args, qp)
    got = T.deblock_frame_dev(*(t(a) for a in args), qp)
    for a, b in zip(got, want):
        same(a, b)
    # the interior TU-edge pass (kept for the TU-split slice)
    rng = np.random.default_rng(qp)
    split = rng.random((H // 16, W // 16)) < 0.5
    lv = np.asarray(outs["luma_lv"])
    want = J.deblock_frame_jit(*args, qp, tu_split=split, luma_lv=lv)
    got = T.deblock_frame_dev(*(t(a) for a in args), qp, tu_split=t(split),
                              luma_lv=t(lv))
    for a, b in zip(got, want):
        same(a, b)


def _levels(rng, nch, ncw, density):
    def lv(shape):
        a = rng.integers(-40, 41, shape).astype(np.int32)
        a[rng.random(shape) >= density] = 0
        return a
    return (lv((nch, ncw, 16, 16)), lv((nch, ncw, 8, 8)),
            lv((nch, ncw, 8, 8)))


def _pack_both(levels, cap, chunk, rng):
    nch, ncw = levels[0].shape[:2]
    meta = {"is_intra": rng.random((nch, ncw)) < 0.3,
            "tu_split": np.zeros((nch, ncw), bool),
            "mode": rng.integers(0, 35, (nch, ncw)).astype(np.int32),
            "mv": rng.integers(-35, 36, (nch, ncw, 2)).astype(np.int32)}
    pos, val, counts, nnz = T._compact_levels(*(t(a) for a in levels), cap)
    d = {k: t(a)[None] for k, a in meta.items()}
    d.update(pos=pos[None], val=val[None], counts=counts[None],
             nnz=nnz[None])
    port = T._pack_run_streams(d, 1, chunk)
    jpos, jval, jcounts, jnnz = J._compact_levels(
        *(jnp.asarray(a) for a in levels), cap)
    jd = {k: jnp.asarray(a)[None] for k, a in meta.items()}
    jd["mode"] = jd["mode"].astype(jnp.int8)
    jd["mv"] = jd["mv"].astype(jnp.int8)
    jd.update(pos=jpos[None], val=jval[None],
              counts=jcounts.astype(jnp.uint16)[None], nnz=jnnz[None])
    jax_rows = J._pack_run_streams(jd, 1, chunk=chunk)
    return (pos, val, counts, nnz), (jpos, jval, jcounts, jnnz), port, \
        jax_rows


@pytest.mark.parametrize("density,cap,chunk", [
    (0.05, 12288, 6144),          # fits chunk 0
    (0.3, 12288, 6144),           # spills into extra chunks
    (0.9, 6144, 6144),            # overflows cap (nnz > cap)
])
def test_compaction_and_packed_rows(density, cap, chunk):
    rng = np.random.default_rng(int(density * 100))
    levels = _levels(rng, 4, 6, density)
    (pos, val, counts, nnz), (jpos, jval, jcounts, jnnz), port, jrows = \
        _pack_both(levels, cap, chunk, rng)
    same(pos, jpos)
    same(val, jval)
    same(counts, jcounts)
    same(nnz, jnnz)
    same(port["packed"], jrows["packed"])
    chunks = [np.asarray(c) for c in jrows["lv_chunks"]]
    rest = (np.concatenate(chunks, axis=1) if chunks
            else np.zeros((1, 0, 2), np.int16))
    same(port["lv_rest"], rest)
    if int(nnz) <= cap:
        # the host rebuilds the dense levels from the sparse stream
        n = int(nnz)
        dense = densify_levels(counts.numpy(), pos.numpy()[:n],
                               val.numpy()[:n])
        jdense = j_densify(np.asarray(jcounts), np.asarray(jpos)[:n],
                           np.asarray(jval)[:n])
        for k, a in zip(("luma_lv", "cb_lv", "cr_lv"), levels):
            assert np.array_equal(dense[k], a)
            assert np.array_equal(dense[k], jdense[k])


@pytest.mark.parametrize("grid,density", [
    ((42, 50), 0.004),    # 6300 nonzero 128-slot segments > 6144
    ((24, 30), 0.6),      # more than 16384 nonzero 16-slot subsegments
])
def test_segment_caps_bind_in_jax_only(grid, density):
    """Where the JAX three-level compaction's segment caps bind, it
    reports an overflow (nnz = cap + 1) though the levels fit its cap;
    the port's single prefix sum does not overflow, and its sparse
    stream rebuilds the very levels that the JAX encoder then codes
    from its dense fallback, so both streams are the same."""
    from ceracoder_tpu.codec.h265.rowslice import entropy_rows_native as jent
    from ceracoder_tpu_torch.codec.h265.rowslice import entropy_rows_native
    from ceracoder_tpu_torch.codec.h265.syntax import HevcParams

    rng = np.random.default_rng(11)
    nch, ncw = grid
    levels = _levels(rng, nch, ncw, density)
    if density < 0.01:               # one nonzero in every segment
        levels[0][..., 0, 0] = levels[0][..., 8, 0] = 1
        levels[1][..., 0, 0] = 1
    cap = 1 << 20
    pos, val, counts, nnz = T._compact_levels(*(t(a) for a in levels), cap)
    *_, jnnz = J._compact_levels(*(jnp.asarray(a) for a in levels), cap)
    assert int(jnnz) == cap + 1 and int(nnz) <= cap
    n = int(nnz)
    dense = densify_levels(counts.numpy(), pos.numpy()[:n], val.numpy()[:n])
    arrays = {"is_intra": np.zeros((nch, ncw), bool),
              "mode": np.zeros((nch, ncw), np.int32),
              "mv": rng.integers(-8, 9, (nch, ncw, 2)).astype(np.int32)}
    mine = entropy_rows_native(HevcParams(ncw * 16, nch * 16, qp=30),
                               {**arrays, **dense}, 30, idr=False, poc=1)
    ref = jent(_jparams(ncw * 16, nch * 16), {**arrays, **dict(zip(
        ("luma_lv", "cb_lv", "cr_lv"), levels))}, 30, idr=False, poc=1)
    assert mine == ref


def _jparams(w, h, qp=30):
    """The JAX package's parameters for its H265DeviceEncoder defaults
    (deblocking, tile rows, no PCM, low delay)."""
    from ceracoder_tpu.codec.h265.syntax import HevcParams as JParams
    return JParams(width=w, height=h, qp=qp, pcm_enabled=False,
                   deblock=True, max_reorder=0, max_dpb_minus1=1,
                   tile_rows=True)


@pytest.mark.parametrize("w,h", [(96, 64), (90, 60), (96, 16),
                                 (1920, 1088)])
def test_parameter_sets_match_jax(w, h):
    """VPS, SPS and PPS of the port's cut syntax copy equal the JAX
    writers' at the encoder's operating point (a one-row picture has
    no tiles; 90x60 needs a conformance window)."""
    from ceracoder_tpu.codec.h265 import syntax as js
    from ceracoder_tpu_torch.codec.h265 import syntax as ts

    p, jp = ts.HevcParams(w, h, qp=30), _jparams(w, h)
    for name in ("write_vps", "write_sps", "write_pps"):
        assert getattr(ts, name)(p) == getattr(js, name)(jp), name


@pytest.mark.parametrize("nch,idr", [(1, True), (1, False), (4, True),
                                     (4, False)])
def test_entropy_rows_native_matches_jax(nch, idr):
    """The port's native entropy call (one tile per CTB row, or one
    plain slice for a one-row picture) codes the JAX call's bytes."""
    from ceracoder_tpu.codec.h265.rowslice import entropy_rows_native as jent
    from ceracoder_tpu_torch.codec.h265.rowslice import entropy_rows_native
    from ceracoder_tpu_torch.codec.h265.syntax import HevcParams

    rng = np.random.default_rng(nch * 2 + idr)
    ncw = 6
    levels = _levels(rng, nch, ncw, 0.1)
    arrays = {
        "is_intra": (np.ones((nch, ncw), bool) if idr
                     else rng.random((nch, ncw)) < 0.3),
        "mode": rng.choice(T._MODES, (nch, ncw)).astype(np.int32),
        "mv": (np.zeros((nch, ncw, 2), np.int32) if idr
               else rng.integers(-30, 31, (nch, ncw, 2)).astype(np.int32)),
        **dict(zip(("luma_lv", "cb_lv", "cr_lv"), levels))}
    mine = entropy_rows_native(HevcParams(ncw * 16, nch * 16, qp=30),
                               arrays, 30, idr=idr, poc=0 if idr else 3)
    ref = jent(_jparams(ncw * 16, nch * 16), arrays, 30, idr=idr,
               poc=0 if idr else 3)
    assert mine == ref and len(mine) == 1


@pytest.mark.parametrize("n_ctb,idr,cap,want", [
    (8160, False, None, (393216, 6144)),      # 1080p P: 48/CTB, rounded
    (8160, True, None, (1572864, 786432)),    # 1080p IDR: 96/CTB chunk
    (24, False, None, (12288, 6144)),         # at least two chunks
    (24, True, None, (12288, 6144)),
    (24, False, 6144, (6144, 6144)),          # a caller's cap
    (24, True, 6144, (12288, 6144)),
    (24, False, 7000, (12288, 6144)),
])
def test_level_capacity(n_ctb, idr, cap, want):
    """Sparse-level capacity and chunk 0 of a frame, by the JAX
    encoder's rule (ceracoder_tpu/codec/h265/device.py, encode_run_async:
    cap = max(2 chunks, 48/CTB) in whole chunks; an IDR chunk 0 of 96
    entries per CTB, capacity at least two of them)."""
    assert T.level_capacity(n_ctb, idr, cap) == want


def test_stage_hook_sees_the_encoder_stages():
    """encode_frame_row reports its stages, in order, to a stage hook
    (the profiler's), and a hooked run gives the unhooked run's rows:
    the profile times the encoder's own code."""
    planes = [tuple(t(p) for p in f) for f in _panning(2)]
    ref0 = tuple(torch.zeros_like(p) for p in planes[0])
    seen = []

    def hook(name, fn):
        seen.append(name)
        return fn()

    plain = T.encode_run_rows(lambda f: planes[f], [True, False],
                              [30, 30], [29, 29], ref0, [12288] * 2,
                              [6144] * 2)
    ref = ref0
    for f, idr in enumerate((True, False)):
        out = T.encode_frame_row(*planes[f], ref, idr, 30, 29, 12288, 6144,
                                 stage=hook)
        ref = out["recon"]
        same(out["packed"], plain[f]["packed"])
        for a, b in zip(out["recon"], plain[f]["recon"]):
            same(a, b)
    assert seen == ["intra_core", "deblock", "compact_pack",
                    "motion", "p_tail", "deblock", "compact_pack"]
    seen.clear()
    T._p_motion(planes[1][0], *T._pad_ref(*plain[0]["recon"]), stage=hook)
    assert seen == ["down2", "coarse_search", "window_canvas",
                    "fullpel_refine", "qpel_phases", "subpel_refine",
                    "chroma_mc"]
