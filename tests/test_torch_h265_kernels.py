"""K4 (ops/h265.py:h265_intra_cols, csrc/h265_intra.cu): its plain
version `_i_frame_cols_ref` against the JAX package's IDR core
(`_i_core_jit`, qp traced: one compile serves every case) on
chip_smoke.py's `h265_intra_edge_cases` (flat planes, noise, stripes at
each angle of modes 2..9, ramps; qp / qp_c from 0 to 51), the public
`_i_frame_core` on CPU tensors against the plain version, the wrapper's
input checks and a failed build, and — on a card — the kernel against
its plain version on the same cases.

All at chip_smoke.py's EDGE_W x EDGE_H (112x48: 7 CTB columns, for
which JAX's scan takes one column per step), exact."""

import numpy as np
import pytest
import torch

from ceracoder_tpu.ops.h265 import _i_core_jit
from ceracoder_tpu_torch.ops.h265 import (
    _MODES,
    _i_frame_cols_ref,
    _i_frame_core,
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
