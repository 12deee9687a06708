"""Port device entropy stage (CAVLC symbols, nC, bit packer) against
the JAX reference and the host packer: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ceracoder_tpu.codec.h264.device_entropy as J
from ceracoder_tpu.codec.bitwriter import pack_bits
from ceracoder_tpu_torch.codec.h264.device_entropy import (
    encode_blocks,
    finalize_rows,
    neighbor_nc,
    pack_rows,
)
from ceracoder_tpu_torch.ops.bitpack import i32_to_u32

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

# the JAX references under jax.jit, as the JAX encoder runs them: called
# eagerly, each primitive compiles at each shape apart
encode_blocks_jax = jax.jit(J.encode_blocks_jax, static_argnums=2)
neighbor_nc_jax = jax.jit(J.neighbor_nc_jax, static_argnums=1)
j_pack_rows = jax.jit(J.pack_rows, static_argnums=2)


@pytest.mark.parametrize("max_coeff", [16, 15, 4])
def test_encode_blocks_match_jax(max_coeff):
    rng = np.random.default_rng(max_coeff)
    n = 600
    lv = (rng.integers(-40, 41, (n, max_coeff))
          * (rng.random((n, max_coeff)) < 0.3))
    lv[:30] = rng.integers(-3000, 3000, (30, max_coeff))  # escape regime
    lv[30:40] = 0
    lv[40:50] = rng.choice([-1, 1], (10, max_coeff))      # trailing ones
    nc = rng.integers(0, 20, n)
    if max_coeff == 4:
        nc[:] = -1
    v0, l0, t0 = encode_blocks_jax(jnp.asarray(lv), jnp.asarray(nc),
                                   max_coeff)
    v1, l1, t1 = encode_blocks(torch.as_tensor(lv), torch.as_tensor(nc),
                               max_coeff)
    assert np.array_equal(np.asarray(v0).astype(np.int64), v1.numpy())
    assert np.array_equal(np.asarray(l0).astype(np.int64), l1.numpy())
    assert np.array_equal(np.asarray(t0).astype(np.int64), t1.numpy())


def test_neighbor_nc_matches_jax():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 17, (24, 36))
    for rpm in (4, 2):
        a = np.asarray(neighbor_nc_jax(jnp.asarray(g), rpm))
        b = neighbor_nc(torch.as_tensor(g), rpm).numpy()
        assert np.array_equal(a, b)


def _random_symbols(rng, r, t, density):
    lens = (rng.integers(0, 33, (r, t))
            * (rng.random((r, t)) < density)).astype(np.int64)
    lens[:, -1] = 0                     # stop slot
    vals = np.zeros((r, t), np.int64)
    mask = lens > 0
    widths = np.where(mask, lens, 1)
    vals[mask] = (rng.integers(0, 1 << 62, mask.sum())
                  % (1 << widths[mask]))
    return vals, lens


def test_pack_rows_matches_jax_and_host():
    # density mirrors real CAVLC slot streams (~99% zero-width)
    rng = np.random.default_rng(1)
    r, t, capw = 4, 6000, 2048
    vals, lens = _random_symbols(rng, r, t, 0.02)
    vt, lt = finalize_rows(torch.as_tensor(vals), torch.as_tensor(lens))
    words, total = pack_rows(vt, lt, capw)
    words = i32_to_u32(words).numpy().astype(np.uint32)
    total = total.numpy()

    jw, jt = j_pack_rows(jnp.asarray(vt.numpy().astype(np.uint32)),
                         jnp.asarray(lt.numpy().astype(np.int32)), capw)
    jw, jt = np.asarray(jw), np.asarray(jt)
    assert np.array_equal(jt, total)
    assert np.array_equal(jw, words)
    vn, ln = vt.numpy(), lt.numpy()
    for i in range(r):
        tb = int(total[i])
        assert tb % 8 == 0
        ref = pack_bits(vn[i].astype(np.uint32), ln[i].astype(np.int32))
        assert words[i].astype(">u4").tobytes()[:tb // 8] == ref


def test_pack_rows_flags_window_overflow():
    """A chunk denser than the merge window must inflate the row's bit
    count past any capacity so the caller falls back (exactly)."""
    rng = np.random.default_rng(2)
    r, t = 3, 4000
    vals, lens = _random_symbols(rng, r, t, 0.9)
    vt, lt = finalize_rows(torch.as_tensor(vals), torch.as_tensor(lens))
    capw = 4096
    _, total = pack_rows(vt, lt, capw)
    _, jt = j_pack_rows(jnp.asarray(vt.numpy().astype(np.uint32)),
                        jnp.asarray(lt.numpy().astype(np.int32)), capw)
    assert (total.numpy() > capw * 32).all()
    assert np.array_equal(np.asarray(jt), total.numpy())
