"""The port's H.264 CABAC packed rows and slice headers
(codec/h264/cabac_run.py, codec/h264/cabac_assemble.py) against the JAX
package on the CPU: the same pack layout, the same packed bytes and
level chunks from compact_slots, the same unpacked syntax, the row
header's cache key (ROADMAP.md F2), the Main-profile SPS, and
profile_h264's op count. None of these compiles the JAX encoder's
executables (tests/test_torch_h264_cabac.py), so they run apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceracoder_tpu.codec.h264.cabac_run as j_run
import ceracoder_tpu_torch.codec.h264.cabac_run as t_run
from ceracoder_tpu.codec.h264.cabac_assemble import _row_hdr as j_row_hdr
from ceracoder_tpu.codec.h264.encoder import H264Encoder as JEncoder
from ceracoder_tpu.ops.h265 import compact_slots as j_compact
from ceracoder_tpu_torch.codec.h264.cabac_assemble import _row_hdr
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
from ceracoder_tpu_torch.ops.h265 import compact_slots
from tests.test_torch_h264_cabac import MBH, MBW, W, H, _frames

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)


@pytest.mark.parametrize("n_mb,intra,chunk", [
    (48, True, t_run.CHUNK), (48, False, t_run.CHUNK),
    (8160, True, 786432), (8160, False, t_run.CHUNK), (5, False, 96)])
def test_pack_layout_matches_jax(n_mb, intra, chunk):
    assert t_run.pack_layout(n_mb, intra, chunk) == \
        j_run.pack_layout(n_mb, intra, chunk)


@pytest.mark.parametrize("intra", [True, False])
def test_pack_rows_and_unpack_match_jax(intra):
    """The port's packed row and level chunks are JAX's bytes for the
    same arrays, and both unpack_syntax read them alike (three level
    chunks, so the extra chunks are read too)."""
    rng = np.random.default_rng(1 + intra)
    n, chunk, cap = MBH * MBW, 256, 1024
    flat = ((rng.random((n, 384)) < 0.04)
            * rng.integers(-300, 300, (n, 384))).astype(np.int16)
    meta = rng.integers(0, 16, n).astype(np.uint8)
    mv = None if intra else rng.integers(-90, 90, (n, 2)).astype(np.int16)
    pos, val, nnz = compact_slots(torch.as_tensor(flat), cap)
    jpos, jval, jnnz = j_compact(jnp.asarray(flat), cap)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert np.array_equal(val.numpy(), np.asarray(jval))
    assert int(nnz) == int(jnnz) and chunk < int(nnz) <= cap
    counts = (flat != 0).sum(1)
    packed, rest = t_run._pack_rows(
        torch.as_tensor(meta)[None], torch.as_tensor(counts)[None],
        None if mv is None else torch.as_tensor(mv)[None],
        pos[None], val[None], nnz[None], chunk)
    jpacked, jchunks = j_run._pack_rows(
        jnp.asarray(meta)[None], jnp.asarray(counts.astype(np.uint16))[None],
        None if mv is None else jnp.asarray(mv)[None],
        jpos[None], jval[None], jnnz[None], chunk)
    row = packed.numpy()[0]
    assert np.array_equal(row, np.asarray(jpacked)[0])
    assert row.size == t_run.pack_layout(n, intra, chunk)["total"]
    for c, jc in enumerate(jchunks):
        assert np.array_equal(rest[:, c * chunk:(c + 1) * chunk].numpy(),
                              np.asarray(jc))

    def get_chunk(c):
        return rest[:, c * chunk:(c + 1) * chunk].numpy()
    got = t_run.unpack_syntax(row, get_chunk, 0, MBH, MBW, intra, cap, chunk)
    want = j_run.unpack_syntax(row, get_chunk, 0, MBH, MBW, intra, cap,
                               chunk)
    assert got[0] == want[0] == int(nnz)
    assert set(got[1]) == set(want[1])
    for k, a in want[1].items():
        assert got[1][k].dtype == a.dtype and np.array_equal(got[1][k], a), k
    dense = t_run.densify384(counts, pos.numpy(), val.numpy(), int(nnz))
    assert np.array_equal(dense, flat)


@pytest.mark.parametrize("intra", [True, False])
def test_row_header_follows_log2_max_frame_num(intra):
    """The port's slice-header cache keys on log2_max_frame_num (the
    JAX cache does not, ROADMAP.md F2); at the default of 8 its bytes
    are JAX's."""
    args = (2, MBW, 30, 26, True, intra, 5, 3)
    assert _row_hdr(*args) == _row_hdr(*args, 8) == j_row_hdr(*args)
    assert _row_hdr(*args, 10) != _row_hdr(*args, 8)
    enc = H264Encoder(W, H, gop=4, device="cpu")
    enc.sps.log2_max_frame_num = 10
    idr, p = (f.result().data
              for f in enc.encode_run_async(_frames(2, seed=5)))
    assert idr[5:].startswith(_row_hdr(0, MBW, 28, 26, True, True, 0, 0,
                                       10))
    assert p[5:].startswith(_row_hdr(0, MBW, 28, 26, True, False, 1, 0,
                                     10))


def test_cabac_stream_is_main_profile():
    enc = H264Encoder(W, H, device="cpu")
    hdr = enc.headers()
    sps = hdr[hdr.index(b"\x00\x00\x00\x01\x67") + 5:]
    assert sps[0] == 77
    assert hdr == JEncoder(W, H, cabac=True).headers()


def test_op_count_is_linear_in_mb_columns():
    """profile_h264 --count-ops extrapolates op counts linearly in the
    MB columns: each added column adds the same ops to every stage."""
    from ceracoder_tpu_torch.profile_h264 import count_cabac_ops

    a, b, c = (count_cabac_ops(w, 32) for w in (96, 128, 160))
    assert set(a) == {"intra", "deblock", "compact_pack", "inter",
                      "intra_fallback"}
    for name in a:
        assert [y - x for x, y in zip(a[name], b[name])] == \
            [z - y for y, z in zip(b[name], c[name])], name
    assert b["intra_fallback"][0] > a["intra_fallback"][0]
    assert b["deblock"] == [n + (b["deblock"][0] - a["deblock"][0])
                            for n in a["deblock"]]
