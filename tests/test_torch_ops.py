"""Port device ops against the JAX reference at 112x48: every output
array of encode_frame_i16_rows, encode_frame_p and deblock_frame_rows
must be equal (exact: the codec is integer-exact). 7 MB columns: the
JAX column scans compile one column per step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceracoder_tpu.ops.deblock import deblock_frame_rows as j_deblock
from ceracoder_tpu.ops.inter import encode_frame_p as j_encode_p
from ceracoder_tpu.ops.intra import encode_frame_i16_rows as j_encode_i
from ceracoder_tpu_torch.ops.deblock import deblock_frame_rows as t_deblock
from ceracoder_tpu_torch.ops.inter import encode_frame_p as t_encode_p
from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows as t_encode_i

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 112, 48


def _planes(rng, shift=(0, 0), base=None):
    """Smooth content with texture, optionally a shifted copy of base."""
    if base is None:
        yy, xx = np.mgrid[0:H, 0:W]
        y = (((xx * 3 + yy * 2) % 180) + 30
             + rng.integers(-12, 13, (H, W))).clip(0, 255)
        y[10:26, 20:44] = 235
        u = ((xx[::2, ::2] * 5) % 200 + rng.integers(0, 20, (H // 2, W // 2)))
        v = ((yy[::2, ::2] * 7) % 200 + rng.integers(0, 20, (H // 2, W // 2)))
        return tuple(p.clip(0, 255).astype(np.uint8) for p in (y, u, v))
    dy, dx = shift
    y = np.roll(base[0], (dy, dx), (0, 1)).astype(np.int32)
    y = (y + rng.integers(-3, 4, y.shape)).clip(0, 255)
    u = np.roll(base[1], (dy // 2, dx // 2), (0, 1))
    v = np.roll(base[2], (dy // 2, dx // 2), (0, 1))
    return y.astype(np.uint8), u, v


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _assert_outs_equal(jo, to):
    assert set(jo) == set(to)
    for k in jo:
        if k == "recon":
            for a, b in zip(jo[k], to[k]):
                assert np.array_equal(np.asarray(a), b.numpy()), k
            continue
        a, b = np.asarray(jo[k]), to[k].numpy()
        assert a.shape == b.shape, k
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("qp", [12, 30, 45])
def test_encode_frame_i16_rows_matches(qp):
    rng = np.random.default_rng(qp)
    y, u, v = _planes(rng)
    from ceracoder_tpu.ops.transform import chroma_qp
    qpc = chroma_qp(qp)
    jo = j_encode_i(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), qp, qpc)
    to = t_encode_i(_t(y), _t(u), _t(v), qp, qpc)
    _assert_outs_equal(jo, to)


@pytest.mark.parametrize("qp,shift", [(22, (2, -3)), (34, (-5, 6))])
def test_encode_frame_p_matches(qp, shift):
    rng = np.random.default_rng(7)
    ref = _planes(rng)
    cur = _planes(rng, shift, ref)
    jo = j_encode_p(*(jnp.asarray(p) for p in cur),
                    *(jnp.asarray(p) for p in ref), qp, qp)
    to = t_encode_p(*(_t(p) for p in cur), *(_t(p) for p in ref), qp, qp)
    _assert_outs_equal(jo, to)
    assert np.abs(to["mv"].numpy()).max() > 0      # motion was found


@pytest.mark.parametrize("intra_frame", [True, False])
@pytest.mark.parametrize("qp", [20, 38, 51])
def test_deblock_frame_rows_matches(intra_frame, qp):
    rng = np.random.default_rng(qp + intra_frame)
    y, u, v = _planes(rng)
    mbh, mbw = H // 16, W // 16
    nnz44 = rng.integers(0, 2, (mbh, mbw, 4, 4)).astype(np.int32)
    mv = rng.integers(-9, 10, (mbh, mbw, 2)).astype(np.int32)
    qpc = max(qp - 3, 0)
    jr = j_deblock(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                   jnp.asarray(nnz44), jnp.asarray(mv), qp, qpc,
                   intra_frame=intra_frame)
    tr = t_deblock(_t(y), _t(u), _t(v), _t(nnz44), _t(mv), qp, qpc,
                   intra_frame=intra_frame)
    for a, b in zip(jr, tr):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert not np.array_equal(tr[0].numpy(), y)   # the filter did work
