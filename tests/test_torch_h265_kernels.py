"""K4 (ops/h265.py:h265_intra_cols, csrc/h265_intra.cu): its plain
version `_i_frame_cols_ref` against the JAX package's IDR core
(`_i_core_jit`, qp traced: one compile serves every case) on
chip_smoke.py's `h265_intra_edge_cases` (flat planes, noise, stripes at
each angle of modes 2..9, ramps; qp / qp_c from 0 to 51), the public
`_i_frame_core` on CPU tensors against the plain version, the wrapper's
input checks and a failed build, a plain-torch model of the kernel's
carry pass (`_carry_model`: the shortcuts it takes) against the plain
loop, and — on a card — the kernel against its plain version on the
same cases.

All at chip_smoke.py's EDGE_W x EDGE_H (112x48: 7 CTB columns, for
which JAX's scan takes one column per step), exact."""

import numpy as np
import pytest
import torch

from ceracoder_tpu.ops.h265 import _i_core_jit
from ceracoder_tpu_torch.codec.h265.tables import T8, T16
from ceracoder_tpu_torch.ops.h265 import (
    _MODES,
    _argmin_first,
    _dequantize,
    _i_frame_cols_ref,
    _i_frame_core,
    _intra_preds,
    _quantize,
    _select_cand,
    h265_intra_cols,
)
from chip_smoke import H265_INTRA_QPS, h265_intra_edge_cases

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

CASES = h265_intra_edge_cases()
KEYS = ("is_intra", "mode", "mv", "tu_split", "luma_lv", "cb_lv", "cr_lv")


def _t(planes):
    return tuple(torch.as_tensor(np.ascontiguousarray(p)) for p in planes)


def _assert_equal(got, want):
    """Port outputs against JAX's (or another port dict): same keys,
    shapes, dtypes and values."""
    assert set(got) == set(want)
    pairs = [(got[k], want[k]) for k in KEYS]
    pairs += list(zip(got["recon"], want["recon"], strict=True))
    for g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax(name):
    y, u, v, qp, qp_c = CASES[name]
    want = _i_core_jit(y, u, v, qp, qp_c)
    _assert_equal(_i_frame_cols_ref(*_t((y, u, v)), qp, qp_c), want)


def test_edge_cases_cover_every_mode_and_qp():
    """Each of the 12 candidate modes wins some CTB across the cases."""
    won = set()
    for y, u, v, qp, qp_c in CASES.values():
        won |= set(_i_frame_cols_ref(*_t((y, u, v)), qp, qp_c)["mode"]
                   .unique().tolist())
    assert won == set(_MODES.tolist())
    assert {c[3:] for c in CASES.values()} == set(H265_INTRA_QPS)


def test_public_functions_run_the_plain_version_on_cpu():
    y, u, v, qp, qp_c = CASES["noise_qp30_qpc29"]
    args = _t((y, u, v))
    want = _i_frame_cols_ref(*args, qp, qp_c)
    _assert_equal(h265_intra_cols(*args, qp, qp_c), want)
    # _i_frame_core takes views too (it makes them contiguous)
    wide = tuple(torch.cat([p, p], dim=1)[:, :p.shape[1]] for p in args)
    assert not wide[0].is_contiguous()
    _assert_equal(_i_frame_core(*wide, qp, qp_c), want)


# the 8-point Walsh-Hadamard matrix in natural order, W[u][r] =
# (-1)^popcount(u & r), as the kernel's butterflies give it
W8 = torch.tensor([[(-1) ** bin(u & r).count("1") for r in range(8)]
                   for u in range(8)], dtype=torch.int64)


def _blocks8(x):
    """(..., 16, 16) -> (..., 2, 2, 8, 8): the four 8x8 blocks (by, bx)."""
    return x.reshape(*x.shape[:-2], 2, 8, 2, 8).transpose(-3, -2)


def _tail(src, pred, qp: int, t, log2n: int):
    """The carry pass's TU tail: stage 1 as T . src less T . pred, stage 2,
    quant and dequant, the inverse stage 1 in full and the inverse stage 2
    for the last column only; returns that column of the reconstruction,
    (R, n)."""
    s1, s2 = log2n - 1, log2n + 6
    a = (t @ src - t @ pred + (1 << (s1 - 1))) >> s1
    coef = (a @ t.T + (1 << (s2 - 1))) >> s2
    dq = _dequantize(_quantize(coef, qp, log2n), qp, log2n)
    a2 = ((t.T @ dq + 64) >> 7).clamp(-32768, 32767)
    res = ((a2 @ t[:, -1] + 2048) >> 12).clamp(-32768, 32767)
    return (pred[:, :, -1] + res).clamp(0, 255)


def _carry_model(y, u, v, qp: int, qp_c: int):
    """A plain-torch model of K4's carry pass: per CTB column, batched over
    CTB rows, the SATDs as sum |H(src) - H(pred)| (the source's Hadamards
    taken apart from the candidates', as the kernel's producers do), the
    first minimum, then only the last column of each reconstruction
    (`_tail`). Returns the left columns each CTB is coded with ((nch, ncw,
    16), (nch, ncw, 8) u and v) and the modes."""
    i64 = torch.int64
    nch, ncw = y.shape[0] // 16, y.shape[1] // 16
    t16, t8 = torch.tensor(T16, dtype=i64), torch.tensor(T8, dtype=i64)

    def ctbs(x, n):
        return x.to(i64).reshape(nch, n, ncw, n).transpose(1, 2)
    ys, us, vs = ctbs(y, 16), ctbs(u, 8), ctbs(v, 8)
    left = [torch.full((nch, n), 128, dtype=i64) for n in (16, 8, 8)]
    lefts, modes = [], []
    for c in range(ncw):
        lefts.append(left)
        ly, lu, lv = left
        src = ys[:, c]
        hs = W8 @ _blocks8(src) @ W8
        preds = _intra_preds(ly, 16, luma=True)             # (R, 12, 16, 16)
        hp = W8 @ _blocks8(preds) @ W8                      # (R, 12, 2, 2, 8, 8)
        satd = ((hs[:, None] - hp).abs().sum((-1, -2)) >> 2).sum((-1, -2))
        midx = _argmin_first(satd, 1)
        new = [_tail(src, _select_cand(preds, midx), qp, t16, 4)]
        for cs, lc in ((us, lu), (vs, lv)):
            pc = _select_cand(_intra_preds(lc, 8, luma=False), midx)
            new.append(_tail(cs[:, c], pc, qp_c, t8, 3))
        left = new
        modes.append(torch.as_tensor(_MODES, dtype=i64)[midx])
    return ([torch.stack([lf[k] for lf in lefts], 1) for k in range(3)],
            torch.stack(modes, 1))


@pytest.mark.parametrize("name", list(CASES))
def test_carry_model_matches_plain_loop(name):
    """K4's split is sound: the carry pass's shortcuts give every CTB the
    mode and the left columns that the plain loop codes it with."""
    y, u, v, qp, qp_c = CASES[name]
    args = _t((y, u, v))
    want = _i_frame_cols_ref(*args, qp, qp_c)
    lefts, mode = _carry_model(*args, qp, qp_c)
    assert torch.equal(mode, want["mode"].to(torch.int64))
    for got, rec, n in zip(lefts, want["recon"], (16, 8, 8)):
        nch, ncw = got.shape[:2]
        right = rec.to(torch.int64).reshape(nch, n, ncw, n)[..., -1]
        right = right.transpose(1, 2)                       # (nch, ncw, n)
        assert torch.equal(got[:, 0], torch.full_like(got[:, 0], 128))
        assert torch.equal(got[:, 1:], right[:, :-1])


def _args():
    y, u, v, qp, qp_c = CASES["noise_qp22_qpc22"]
    return [*_t((y, u, v)), qp, qp_c]


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int32)), TypeError),
    (lambda a: a.__setitem__(2, a[2].to(torch.int16)), TypeError),
    (lambda a: a.__setitem__(1, a[1].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(0, a[0][:40]), ValueError),
    (lambda a: a.__setitem__(0, a[0][:, :100].contiguous()), ValueError),
    (lambda a: a.__setitem__(1, a[1][:, :16].contiguous()), ValueError),
    (lambda a: a.__setitem__(0, a[0][0]), ValueError),
    (lambda a: a.__setitem__(3, 52), ValueError),
    (lambda a: a.__setitem__(4, -1), ValueError),
    (lambda a: a.__setitem__(2, a[2].to("meta")), ValueError),
], ids=["y_int32", "v_int16", "u_not_contiguous", "y_not_whole_ctbs",
        "y_width_not_whole_ctbs", "u_shape", "y_one_dim", "qp_52",
        "qp_c_negative", "v_device"])
def test_wrapper_rejects(bad, err):
    args = _args()
    bad(args)
    with pytest.raises(err):
        h265_intra_cols(*args)


def test_failed_build_raises(tmp_path, monkeypatch):
    """K4's nvcc failing raises, and nothing is loaded."""
    import ceracoder_tpu_torch.utils.cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cb, "nvcc_path", lambda: "false")
    cb.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed for h265_intra"):
            cb.load_library("h265_intra")
    finally:
        cb.load_library.cache_clear()
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); chip_smoke.py runs these cases on the card")
    from chip_smoke import _cuda, kernel_err

    for case in CASES.values():
        assert kernel_err(h265_intra_cols, _i_frame_cols_ref,
                          _cuda(case)) == 0
