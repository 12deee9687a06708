"""The legacy motion helpers of the port against their JAX twins, on the
CPU, exact: the HEVC whole-frame full search and sub-pel refine
(ceracoder_tpu_torch/ops/h265.py: motion_search_dev, _luma_qpel_planes,
_uni_from_14, _mc_luma_qpel, _refine_subpel, _mc_chroma_qpel) and the
H.264 per-MB search and half-pel MC (ceracoder_tpu_torch/ops/inter.py:
motion_search_fullpel, half_pel_planes, mc_luma_qpel, halfpel_refine,
mc_chroma). No encoder path calls them. The JAX references run under
jax.jit; the frames are made from a seed with numpy: a smooth texture
and its copy shifted by (dy, dx), so that the winners sit inside, on
the edge of and beyond the search range, and a flat pair where every
candidate ties."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceracoder_tpu.ops.h265 as JH
import ceracoder_tpu.ops.inter as JI
import ceracoder_tpu_torch.ops.h265 as TH
import ceracoder_tpu_torch.ops.inter as TI

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 96, 64
W264 = 112


@functools.cache
def jit(fn, *static):
    """`fn` under one jax.jit per module (the arguments at the `static`
    positions fixed)."""
    return jax.jit(fn, static_argnums=static)


def same(port, ref):
    a, b = port.numpy(), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def pair(shift, w, h, seed=0):
    """(cur, ref) int32 luma: a smooth random texture with a little noise
    and its copy displaced by `shift` = (dy, dx), or (None) a flat pair
    in which every candidate ties."""
    rng = np.random.default_rng(seed)
    if shift is None:
        return (np.full((h, w), 120, np.int32),) * 2
    dy, dx = shift
    m = 40
    base = rng.integers(0, 256, (h + 2 * m + 4, w + 2 * m + 4))
    base = sum(base[i:i + h + 2 * m, j:j + w + 2 * m]
               for i in range(5) for j in range(5)) // 25
    base = np.clip((base - 128) * 4 + 128, 0, 255)
    cur = base[m:m + h, m:m + w]
    ref = base[m - dy:m - dy + h, m - dx:m - dx + w]
    cur = np.clip(cur + rng.integers(-2, 3, cur.shape), 0, 255)
    return cur.astype(np.int32), ref.astype(np.int32)


def chroma(plane):
    """A half-size plane from a luma plane (2x2 means)."""
    h, w = plane.shape
    return (plane.reshape(h // 2, 2, w // 2, 2).sum((1, 3)) // 4) \
        .astype(np.int32)


# HEVC: the shifts put the winners inside the +-8 range, on its edge
# (8, -8), past it (11, 3: the search clamps at the edge) and on a
# picture edge (the reference's edge replication); None: all ties
SHIFTS = [(3, -5), (8, -8), (11, 3), None]


@pytest.mark.parametrize("shift", SHIFTS)
def test_hevc_motion_search_dev(shift):
    """The exhaustive search's MVs, both from `ref` and from a padded
    plane (the profiling tools pass the qpel planes' integer plane)."""
    cur, ref = pair(shift, W, H)
    got = TH.motion_search_dev(torch.from_numpy(cur), torch.from_numpy(ref))
    same(got, jit(JH.motion_search_dev)(jnp.asarray(cur), jnp.asarray(ref)))
    if shift == (8, -8):
        assert (got.numpy()[1:-1, 1:-1] == [8, -8]).all()
    if shift is None:
        assert not got.numpy().any()
    pad = TH.PLANE_PAD
    ref_pad = np.pad(ref, pad, mode="edge")
    got = TH.motion_search_dev(torch.from_numpy(cur),
                               ref_pad=torch.from_numpy(ref_pad), pad=pad)
    want = jit(lambda c, r: JH.motion_search_dev(c, ref_pad=r, pad=pad))(
        jnp.asarray(cur), jnp.asarray(ref_pad))
    same(got, want)


@pytest.mark.parametrize("out14", [False, True])
def test_hevc_qpel_planes_and_mc(out14):
    """The 16 qpel planes, whole-frame luma MC from them at MVs out to
    the planes' padding, the uni-prediction rounding, and chroma MC."""
    rng = np.random.default_rng(1 + out14)
    _, ref = pair((2, 1), W, H, seed=3)
    ref_pad = np.pad(ref, TH.LUMA_SRC_PAD, mode="edge")
    planes = TH._luma_qpel_planes(torch.from_numpy(ref_pad), out14)
    jplanes = jit(JH._luma_qpel_planes, 1)(jnp.asarray(ref_pad), out14)
    same(planes, jplanes)
    lim = 4 * TH.PLANE_PAD - 1
    mv_q = rng.integers(-lim, lim + 1, (H // 16, W // 16, 2)).astype(np.int32)
    mv_q[0, 0] = (-lim, -lim)
    mv_q[-1, -1] = (lim, lim)
    mc = TH._mc_luma_qpel(planes, torch.from_numpy(mv_q), H, W)
    same(mc, jit(JH._mc_luma_qpel, 2, 3)(jplanes, jnp.asarray(mv_q), H, W))
    if out14:
        same(TH._uni_from_14(mc), jit(JH._uni_from_14)(
            jit(JH._mc_luma_qpel, 2, 3)(jplanes, jnp.asarray(mv_q), H, W)))
    ref_c = np.pad(chroma(ref), TH.CHROMA_PAD, mode="edge")
    clim = 8 * (TH.CHROMA_PAD - 2)
    mv_c = rng.integers(-clim, clim, (H // 16, W // 16, 2)).astype(np.int32)
    same(TH._mc_chroma_qpel(torch.from_numpy(ref_c), torch.from_numpy(mv_c),
                            H // 2, W // 2, out14),
         jit(JH._mc_chroma_qpel, 2, 3, 4)(jnp.asarray(ref_c),
                                          jnp.asarray(mv_c), H // 2, W // 2,
                                          out14))


@pytest.mark.parametrize("shift", SHIFTS)
def test_hevc_refine_subpel(shift):
    """Half- then quarter-pel refinement from the search's own MVs and
    from MVs on the range's corners (the planes' farthest reach)."""
    cur, ref = pair(shift, W, H, seed=5)
    ref_pad = np.pad(ref, TH.LUMA_SRC_PAD, mode="edge")
    planes = TH._luma_qpel_planes(torch.from_numpy(ref_pad))
    jplanes = jit(JH._luma_qpel_planes, 1)(jnp.asarray(ref_pad), False)
    mv = TH.motion_search_dev(torch.from_numpy(cur), torch.from_numpy(ref))
    corners = np.array([[-8, -8], [8, 8], [-8, 8], [8, -8]], np.int32)
    edge = corners[np.arange(mv.shape[0] * mv.shape[1]) % 4].reshape(mv.shape)
    for full in (mv.numpy(), edge):
        same(TH._refine_subpel(torch.from_numpy(cur), planes,
                               torch.from_numpy(full), H, W),
             jit(JH._refine_subpel, 3, 4)(jnp.asarray(cur), jplanes,
                                          jnp.asarray(full), H, W))


# H.264: coarse +-16 and refine +-3 reach +-19; (19, -19) sits on that
# edge, (25, 0) past it
SHIFTS_264 = [(5, -9), (19, -19), (25, 0), None]


@pytest.mark.parametrize("shift", SHIFTS_264)
def test_h264_motion_search_fullpel(shift):
    cur, ref = pair(shift, W264, H, seed=7)
    mv, sad = TI.motion_search_fullpel(torch.from_numpy(cur),
                                       torch.from_numpy(ref))
    jmv, jsad = jit(JI.motion_search_fullpel)(jnp.asarray(cur),
                                              jnp.asarray(ref))
    same(mv, jmv)
    same(sad, jsad)
    assert mv.dtype == sad.dtype == torch.int32
    if shift == (19, -19):
        assert (mv.numpy()[1:-1, 1:-1] == [19, -19]).any()
    if shift is None:      # ties: each stage's first (raster) candidate
        assert (mv.numpy() == -4 * 4 - 3).all() and not sad.numpy().any()


@pytest.mark.parametrize("shift", [(5, -9), None])
def test_h264_half_pel_mc(shift):
    """The four 6-tap planes, MC at half-pel MVs (some far enough out
    that jax.lax.dynamic_slice clamps the window's start, or takes a
    negative start from the end), the half-pel refine from the search's
    MVs and chroma MC."""
    rng = np.random.default_rng(11)
    cur, ref = pair(shift, W264, H, seed=9)
    planes = TI.half_pel_planes(torch.from_numpy(ref))
    jplanes = jit(JI.half_pel_planes)(jnp.asarray(ref))
    for a, b in zip(planes, jplanes):
        same(a, b)
    mbh, mbw = H // 16, W264 // 16
    mv = 2 * rng.integers(-130, 131, (mbh, mbw, 2)).astype(np.int32)
    mv[0, 0], mv[-1, -1] = (-400, -400), (400, 400)
    pred = TI.mc_luma_qpel(planes, torch.from_numpy(mv))
    same(pred, jit(JI.mc_luma_qpel)(jplanes, jnp.asarray(mv)))
    assert pred.shape == (mbh, mbw, 16, 16) and pred.dtype == torch.int32
    full, _ = TI.motion_search_fullpel(torch.from_numpy(cur),
                                       torch.from_numpy(ref))
    cur_mb = TI._mb_view(torch.from_numpy(cur))
    got = TI.halfpel_refine(cur_mb, planes, full)
    same(got, jit(JI.halfpel_refine)(JI._mb_view(jnp.asarray(cur)), jplanes,
                                     jnp.asarray(full.numpy())))
    if shift is None:      # ties: the first candidate, no offset
        assert (got.numpy() == 4 * full.numpy()).all()
    ref_c = chroma(ref)
    mv_c = rng.integers(-300, 301, (mbh, mbw, 2)).astype(np.int32)
    mv_c[0, 0], mv_c[-1, -1] = (-600, -600), (600, 600)
    pc = TI.mc_chroma(torch.from_numpy(ref_c), torch.from_numpy(mv_c))
    same(pc, jit(JI.mc_chroma)(jnp.asarray(ref_c), jnp.asarray(mv_c)))
    assert pc.shape == (mbh, mbw, 8, 8) and pc.dtype == torch.int32
