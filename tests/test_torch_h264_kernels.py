"""K2 (ops/deblock.py:h264_deblock_rows, csrc/h264_deblock.cu) and K3
(ops/intra.py:h264_intra16_cols, csrc/h264_intra16.cu): the plain
versions against the JAX package on chip_smoke.py's edge cases (bS 0-4,
qp and qp_c at 0, 17, 28, 51 and mixed, is_intra masks random, all true
and all false), the public functions on CPU tensors against the plain
versions, the wrappers' input checks and a failed build, and — on a
card — each kernel against its plain version on the same cases.

All at chip_smoke.py's EDGE_W x EDGE_H (112x48: 7 MB columns, for
which the JAX scans compile one column per step), exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceracoder_tpu.ops.deblock import deblock_frame_rows as j_deblock
from ceracoder_tpu.ops.inter import _intra_fallback as j_intra_fallback
from ceracoder_tpu.ops.intra import encode_frame_i16_rows as j_encode_i
from ceracoder_tpu_torch.ops.deblock import (
    compute_bs,
    deblock_frame_rows,
    deblock_frame_rows_ref,
    h264_deblock_rows,
)
from ceracoder_tpu_torch.ops.inter import _intra_fallback
from ceracoder_tpu_torch.ops.intra import (
    _encode_mb_cols_ref,
    encode_frame_i16_rows,
    h264_intra16_cols,
)
from chip_smoke import EDGE_H, EDGE_W, deblock_edge_cases, intra16_edge_cases

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

DEBLOCK_CASES = deblock_edge_cases()
INTRA16_CASES = intra16_edge_cases()
I16 = [k for k, c in INTRA16_CASES.items() if c[5] is None]
SCAN = [k for k, c in INTRA16_CASES.items() if c[5] is not None]
MBH, MBW = EDGE_H // 16, EDGE_W // 16


def _t(x):
    if x is None or isinstance(x, (int, bool)):
        return x
    if isinstance(x, tuple):
        return tuple(_t(p) for p in x)
    return torch.as_tensor(np.ascontiguousarray(x))


def _j(x):
    if x is None or isinstance(x, (int, bool)):
        return x
    if isinstance(x, tuple):
        return tuple(_j(p) for p in x)
    return jnp.asarray(x)


def _assert_equal(got, want, key=""):
    """Port tensors against JAX arrays: same shapes, dtypes, values."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_equal(got[k], want[k], k)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _assert_equal(g, w, key)
        return
    w, g = np.asarray(want), got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, key
    assert np.array_equal(g, w), key


def test_edge_cases_cover_every_bs_and_mask():
    bs = set()
    for y, u, v, nnz, mv, qp, qp_c, intra, imb in DEBLOCK_CASES.values():
        bs_v, bs_h = compute_bs(_t(nnz), _t(mv), intra, _t(imb))
        bs |= set(bs_v.unique().tolist()) | set(bs_h.unique().tolist())
    assert bs == {0, 1, 2, 3, 4}
    masks = {(bool(c[5].all()), bool(c[5].any())) for c in
             (INTRA16_CASES[k] for k in SCAN)}
    assert masks == {(True, True), (False, True), (False, False)}
    qps = {c[3:5] for c in INTRA16_CASES.values()}
    assert {q for pair in qps for q in pair} == {0, 17, 28, 51}


@pytest.mark.parametrize("name", list(DEBLOCK_CASES))
def test_deblock_edge_case_matches_jax(name):
    y, u, v, nnz, mv, qp, qp_c, intra, imb = DEBLOCK_CASES[name]
    want = j_deblock(*_j((y, u, v, nnz, mv)), qp, qp_c, intra_frame=intra,
                     intra_mb=_j(imb))
    got = deblock_frame_rows(*_t((y, u, v, nnz, mv)), qp, qp_c,
                             intra_frame=intra, intra_mb=_t(imb))
    _assert_equal(got, want)


@pytest.mark.parametrize("name", I16)
def test_intra16_edge_case_matches_jax(name):
    y, u, v, qp, qp_c, _, _ = INTRA16_CASES[name]
    _assert_equal(encode_frame_i16_rows(*_t((y, u, v)), qp, qp_c),
                  j_encode_i(*_j((y, u, v)), qp, qp_c))


def _inter_outs(seed, mask, recon):
    """An all-inter P frame's outputs whose SADs make `mask` the intra
    decision (0: never intra; 2^20: always, above any 16x16 SAD)."""
    rng = np.random.default_rng(seed)
    return dict(
        sad=np.where(mask, 1 << 20, 0).astype(np.int32),
        recon=recon,
        mv=rng.integers(-40, 40, (MBH, MBW, 2)).astype(np.int32),
        luma_levels=rng.integers(-9, 9, (MBH, MBW, 4, 4, 16)).astype(
            np.int16),
        dc_chroma=rng.integers(-9, 9, (MBH, MBW, 2, 4)).astype(np.int16),
        ac_chroma=rng.integers(-9, 9, (MBH, MBW, 2, 2, 2, 15)).astype(
            np.int16))


@pytest.fixture(scope="module")
def j_fallback():
    """JAX's intra-in-P fallback as one executable (qp traced)."""
    return jax.jit(j_intra_fallback)


@pytest.mark.parametrize("name", SCAN)
def test_intra_fallback_edge_case_matches_jax(name, j_fallback):
    y, u, v, qp, qp_c, mask, recon = INTRA16_CASES[name]
    outs = _inter_outs(qp * 64 + qp_c, mask, recon)
    want = j_fallback(*_j((y, u, v)), {k: _j(a) for k, a in outs.items()},
                      qp, qp_c)
    got = _intra_fallback(*_t((y, u, v)),
                          {k: _t(a) for k, a in outs.items()}, qp, qp_c)
    assert np.array_equal(got["is_intra"].numpy(), mask)
    _assert_equal(got, want)


def test_public_functions_run_the_plain_versions_on_cpu():
    y, u, v, nnz, mv, qp, qp_c, intra, imb = DEBLOCK_CASES[
        "p_intra_mb_qp28_qpc28"]
    args = _t((y, u, v))
    bs = compute_bs(_t(nnz), _t(mv), intra, _t(imb))
    want = deblock_frame_rows_ref(*args, *bs, qp, qp_c)
    for got in (deblock_frame_rows(*args, _t(nnz), _t(mv), qp, qp_c,
                                   intra_frame=intra, intra_mb=_t(imb)),
                h264_deblock_rows(*args, *bs, qp, qp_c)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    y, u, v, qp, qp_c, mask, recon = INTRA16_CASES["scan_random_qp28_qpc28"]
    args = (*_t((y, u, v)), qp, qp_c)
    for extra in ((), (_t(mask), _t(recon))):
        want = _encode_mb_cols_ref(*args, *extra)
        got = h264_intra16_cols(*args, *extra)
        if not extra:
            _assert_equal(encode_frame_i16_rows(*args), {
                k: (tuple(p.numpy() for p in w) if k == "recon"
                    else w.numpy()) for k, w in want.items()})
        _assert_equal(got, {k: (tuple(p.numpy() for p in w)
                                if k == "recon" else w.numpy())
                            for k, w in want.items()})


def _deblock_args():
    y, u, v, nnz, mv, qp, qp_c, intra, imb = DEBLOCK_CASES[
        "p_intra_mb_qp17_qpc17"]
    return [*_t((y, u, v)), *compute_bs(_t(nnz), _t(mv), intra, _t(imb)),
            qp, qp_c]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int32)), TypeError),
    (lambda a: a.__setitem__(3, a[3].to(torch.int64)), TypeError),
    (lambda a: a.__setitem__(0, a[0].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(0, a[0][:40]), ValueError),
    (lambda a: a.__setitem__(1, a[1][:, :16].contiguous()), ValueError),
    (lambda a: a.__setitem__(4, a[4][:, :, :2].contiguous()), ValueError),
    (lambda a: a.__setitem__(5, 52), ValueError),
    (lambda a: a.__setitem__(6, -1), ValueError),
    (lambda a: a.__setitem__(1, a[1].to("meta")), ValueError),
], ids=["y_int32", "bs_v_int64", "y_not_contiguous", "y_not_whole_mbs",
        "u_shape", "bs_h_shape", "qp_52", "qp_c_negative", "u_device"])
def test_deblock_wrapper_rejects(bad, err):
    args = _deblock_args()
    bad(args)
    with pytest.raises(err):
        h264_deblock_rows(*args)


def _intra16_args():
    y, u, v, qp, qp_c, mask, recon = INTRA16_CASES["scan_random_qp17_qpc17"]
    return [*_t((y, u, v)), qp, qp_c, _t(mask), _t(recon)]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int32)), TypeError),
    (lambda a: a.__setitem__(5, a[5].to(torch.uint8)), TypeError),
    (lambda a: a.__setitem__(6, (a[6][0].to(torch.int16), *a[6][1:])),
     TypeError),
    (lambda a: a.__setitem__(2, a[2].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(0, a[0][:, :56].contiguous()), ValueError),
    (lambda a: a.__setitem__(5, a[5][:, :2].contiguous()), ValueError),
    (lambda a: a.__setitem__(6, a[6][:2]), ValueError),
    (lambda a: a.__setitem__(6, None), ValueError),
    (lambda a: a.__setitem__(3, 60), ValueError),
], ids=["y_int32", "mask_uint8", "inter_recon_int16", "v_not_contiguous",
        "y_not_whole_mbs", "mask_shape", "inter_recon_two_planes",
        "mask_without_inter_recon", "qp_60"])
def test_intra16_wrapper_rejects(bad, err):
    args = _intra16_args()
    bad(args)
    with pytest.raises(err):
        h264_intra16_cols(*args)


@pytest.mark.parametrize("name", ["h264_deblock", "h264_intra16"])
def test_failed_build_raises(name, tmp_path, monkeypatch):
    """A kernel whose nvcc fails raises, and nothing is loaded."""
    import ceracoder_tpu_torch.utils.cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cb, "nvcc_path", lambda: "false")
    cb.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=f"nvcc failed for {name}"):
            cb.load_library(name)
    finally:
        cb.load_library.cache_clear()
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["deblock", "intra16"])
def test_cuda_kernels_match_plain_versions(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); chip_smoke.py runs these cases on the card")
    from chip_smoke import _cuda, deblock_case_args, h264_kernel_err

    if kind == "deblock":
        for case in DEBLOCK_CASES.values():
            assert h264_kernel_err(h264_deblock_rows, deblock_frame_rows_ref,
                                   deblock_case_args(case)) == 0
    else:
        for case in INTRA16_CASES.values():
            assert h264_kernel_err(h264_intra16_cols, _encode_mb_cols_ref,
                                   _cuda(case)) == 0
