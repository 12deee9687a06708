"""Port transforms (ceracoder_tpu_torch.ops.transform) against the JAX
reference (ceracoder_tpu.ops.transform): exact equality, the codec is
integer-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceracoder_tpu.ops import transform as J
from ceracoder_tpu_torch.ops import transform as P

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(11)
    x = rng.integers(-255, 256, (40, 4, 4)).astype(np.int32)
    x[0] = 255
    x[1] = -255
    return x


def test_chroma_qp_table():
    for qp in range(0, 52):
        for off in (-12, -3, 0, 5, 12):
            assert P.chroma_qp(qp, off) == J.chroma_qp(qp, off)


def test_fdct_idct_match(blocks):
    _eq(J.fdct4(jnp.asarray(blocks)), P.fdct4(torch.as_tensor(blocks)))
    _eq(J.idct4(jnp.asarray(blocks * 40)),
        P.idct4(torch.as_tensor(blocks * 40)))


@pytest.mark.parametrize("qp", [0, 5, 17, 28, 36, 51])
@pytest.mark.parametrize("intra", [True, False])
def test_quant_dequant_match(blocks, qp, intra):
    coef = np.array(J.fdct4(jnp.asarray(blocks)))
    # extreme levels: the largest 4x4 coefficients 8-bit residuals give
    coef[2] = 9180
    coef[3] = -9180
    zj = J.quant4(jnp.asarray(coef), qp, intra=intra)
    zp = P.quant4(torch.as_tensor(coef), qp, intra=intra)
    _eq(zj, zp)
    _eq(J.dequant4(zj, qp), P.dequant4(zp, qp))


@pytest.mark.parametrize("qp", [0, 11, 28, 36, 42, 51])
def test_dc_paths_match(blocks, qp):
    dc = blocks[:, :, :] * 16
    dc[0] = 4080
    dc[1] = -4080
    hj = J.hadamard4_fwd(jnp.asarray(dc))
    hp = P.hadamard4_fwd(torch.as_tensor(dc))
    _eq(hj, hp)
    zj = J.quant_dc4(hj, qp)
    zp = P.quant_dc4(hp, qp)
    _eq(zj, zp)
    _eq(J.dequant_dc4(zj, qp), P.dequant_dc4(zp, qp))

    dc2 = dc[:, :2, :2]
    h2j = J.hadamard2_fwd(jnp.asarray(dc2))
    h2p = P.hadamard2_fwd(torch.as_tensor(dc2))
    _eq(h2j, h2p)
    for intra in (True, False):
        z2j = J.quant_dc2(h2j, qp, intra=intra)
        z2p = P.quant_dc2(h2p, qp, intra=intra)
        _eq(z2j, z2p)
        _eq(J.dequant_dc2(z2j, qp), P.dequant_dc2(z2p, qp))


def test_block_helpers_match():
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (2, 16, 24)).astype(np.int32)
    bj = J.to_blocks4(jnp.asarray(plane))
    bp = P.to_blocks4(torch.as_tensor(plane))
    _eq(bj, bp)
    _eq(J.from_blocks4(bj), P.from_blocks4(bp))
    _eq(J.zigzag_scan(bj), P.zigzag_scan(bp))


def test_zigzag_unscan(blocks):
    """zigzag_unscan against JAX's, and as the inverse of zigzag_scan,
    on 4x4 blocks and on leading dimensions."""
    scanned = blocks.reshape(10, 4, 16)
    _eq(J.zigzag_unscan(jnp.asarray(scanned)),
        P.zigzag_unscan(torch.as_tensor(scanned)))
    x = torch.as_tensor(blocks)
    assert torch.equal(P.zigzag_unscan(P.zigzag_scan(x)), x)
