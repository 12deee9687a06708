"""The port's H.264 CABAC path (ceracoder_tpu_torch: ops/inter.py's
intra fallback, ops/deblock.py's intra_mb, codec/h264/cabac_run.py,
codec/h264/cabac_assemble.py and the CABAC H264Encoder) against the JAX
package on the CPU: equal arrays, equal packed bytes and byte-identical
streams, and an oracle decode equal to the port's reconstruction.

The JAX side runs its dense host path (H264Encoder(cabac=True,
device_entropy=False)), which its own suite holds byte-identical to its
fused-run path (tests/test_h264_cabac_run.py) and whose CPU compile is
far cheaper. One frame size (144x96) throughout, so that the JAX
executables compile once per file (9 MB columns: JAX's column scans
unroll 3 per step, 8 would unroll 8); reference runs are shared through
a module-scoped cache. The packed rows, the slice headers and the op
count are tests/test_torch_h264_cabac_rows.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceracoder_tpu_torch.codec.h264.cabac_run as t_run
import ceracoder_tpu_torch.codec.h264.encoder as t_enc
from ceracoder_tpu.app.source import DeviceTestPatternSource as JSource
from ceracoder_tpu.codec.h264.encoder import H264Encoder as JEncoder
from ceracoder_tpu.ops.deblock import deblock_frame_rows as j_deblock
from ceracoder_tpu.ops.inter import encode_frame_p as j_encode_p
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
from ceracoder_tpu_torch.ops.deblock import deblock_frame_rows
from ceracoder_tpu_torch.ops.inter import encode_frame_p
from tests.test_h264_conformance import ORACLE, oracle_decode

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 144, 96
MBH, MBW = H // 16, W // 16


def _frames(n, seed=0):
    """A gradient with a bright box that moves, and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        y = ((xx + 2 * yy + t * 5) % 180 + 30
             + rng.integers(-5, 6, (H, W))).clip(0, 255).astype(np.uint8)
        y[10 + 2 * t:42 + 2 * t, 8 + 3 * t:48 + 3 * t] = 220
        u = ((xx[::2, ::2] + 2 * t) % 70 + 90).astype(np.uint8)
        v = ((yy[::2, ::2] + t) % 50 + 100).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _uncover_frames(n, seed=8):
    """Content change mid-clip: the bottom half switches to smooth new
    content from frame 2, so inter prediction fails there while
    left-only intra predicts well (intra MBs in P slices)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 220, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for i in range(n):
        y = base * 0.5 + 40 + i * 2
        if i >= 2:
            y[H // 2:] = 180 + xx[H // 2:] * 0.1 + yy[H // 2:] * 0.05
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = rng.integers(80, 170, (H // 2, W // 2)).astype(np.uint8)
        v = rng.integers(80, 170, (H // 2, W // 2)).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _jax_stream(frames, qps=None, **kw):
    enc = JEncoder(W, H, cabac=True, device_entropy=False, **kw)
    qps = qps or [None] * len(frames)
    return enc.headers() + b"".join(enc.encode_frame(*f, qp=q).data
                                    for f, q in zip(frames, qps))


def _run(enc, runs, qps=None):
    """The port's stream through encode_run_async, run by run."""
    data, i = enc.headers(), 0
    for frames in runs:
        q = None if qps is None else qps[i:i + len(frames)]
        data += b"".join(p.result().data
                         for p in enc.encode_run_async(frames, qps=q))
        i += len(frames)
    return data


@pytest.fixture(scope="module")
def p_frame():
    """One P frame with intra MBs, coded by both packages."""
    frames = _uncover_frames(3)
    cur, ref = frames[2], frames[1]
    j = j_encode_p(*(jnp.asarray(p) for p in cur),
                   *(jnp.asarray(p) for p in ref), 28, 28, intra_in_p=True)
    t = encode_frame_p(*(torch.as_tensor(p) for p in cur),
                       *(torch.as_tensor(p) for p in ref), 28, 28,
                       intra_in_p=True)
    return j, t


def test_encode_frame_p_intra_in_p_matches_jax(p_frame):
    j, t = p_frame
    assert set(t) == set(j)
    for k in j:
        if k == "recon":
            pairs = zip(j[k], t[k])
        else:
            pairs = [(j[k], t[k])]
        for a, b in pairs:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, k
            assert np.array_equal(b.numpy(), a), k
    n_intra = int(t["is_intra"].sum())
    assert 0 < n_intra < MBH * MBW
    # intra MBs carry no inter levels or MV
    assert not t["luma_levels"][t["is_intra"]].any()
    assert not t["mv"][t["is_intra"]].any()


def test_deblock_with_intra_mb_matches_jax(p_frame):
    j, t = p_frame
    jn = (j["luma_levels"] != 0).any(-1).astype(jnp.int32)
    tn = (t["luma_levels"] != 0).any(-1).to(torch.int32)
    want = j_deblock(*j["recon"], jn, j["mv"], 28, 28, intra_frame=False,
                     intra_mb=j["is_intra"])
    got = deblock_frame_rows(*t["recon"], tn, t["mv"], 28, 28,
                             intra_frame=False, intra_mb=t["is_intra"])
    plain = deblock_frame_rows(*t["recon"], tn, t["mv"], 28, 28,
                               intra_frame=False)
    for a, b in zip(want, got):
        assert np.array_equal(b.numpy(), np.asarray(a))
    # the intra MBs' stronger edges change the filtered picture
    assert not torch.equal(plain[0], got[0])


def test_run_through_idr_boundary_matches_jax():
    """Runs of 5 and 2 frames at gop 3: each run holds an IDR between P
    frames, which the port splits as JAX does."""
    frames = _frames(7, seed=1)
    enc = H264Encoder(W, H, qp=30, gop=3, device="cpu")
    got = _run(enc, [frames[:5], frames[5:]])
    assert enc.fallback_frames == 0
    assert enc.frames_launched == 7
    assert got == _jax_stream(frames, qp=30, gop=3)


def test_per_frame_async_matches_jax():
    frames = _frames(4, seed=2)
    enc = H264Encoder(W, H, qp=28, gop=2, device="cpu")
    pend = [enc.encode_frame_async(*f) for f in frames]
    got = enc.headers() + b"".join(p.result().data for p in pend)
    assert got == _jax_stream(frames, qp=28, gop=2)
    assert [p.keyframe for p in pend] == [True, False, True, False]


def test_per_frame_qps_match_jax():
    frames = _frames(5, seed=3)
    qps = [30, 32, 28, 34, 30]
    enc = H264Encoder(W, H, qp=30, gop=8, device="cpu")
    got = _run(enc, [frames], qps)
    assert got == _jax_stream(frames, qps, qp=30, gop=8)
    assert [p.qp for p in enc.encode_run_async(frames[:2], qps=[31, 33])] \
        == [31, 33]


def test_device_source_matches_jax():
    src = DeviceTestPatternSource(W, H, texture=4, device="cpu")
    jsrc = JSource(W, H, texture=4)
    enc = H264Encoder(W, H, qp=29, gop=4, device="cpu")
    got = enc.headers() + b"".join(
        p.result().data for p in enc.encode_run_async(source=src,
                                                      indices=range(5)))
    planes = [tuple(np.asarray(p) for p in jsrc.frame(i)) for i in range(5)]
    assert got == _jax_stream(planes, qp=29, gop=4)


@pytest.fixture(scope="module")
def intra_run():
    """The port's stream of the uncover clip at gop 6 in one run, with
    the intra MBs each P frame codes (read off the unpacked rows)."""
    frames = _uncover_frames(6)
    seen = []
    real = t_enc.assemble_p_snake

    def spy(arrays, *a):
        seen.append(int(arrays["is_intra"].sum()))
        return real(arrays, *a)
    enc = H264Encoder(W, H, qp=28, gop=6, device="cpu")
    assert enc.intra_in_p
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_enc, "assemble_p_snake", spy)
        got = [p.result() for p in enc.encode_run_async(frames=frames)]
    return frames, enc, got, seen


def test_intra_in_p_matches_jax(intra_run):
    frames, enc, got, seen = intra_run
    data = enc.headers() + b"".join(g.data for g in got)
    assert data == _jax_stream(frames, qp=28, gop=6)
    assert len(seen) == 5 and sum(seen[1:]) > 0      # intra MBs coded


@pytest.mark.skipif(not ORACLE.exists(), reason="tools/decode_oracle "
                    "not built")
def test_oracle_decodes_intra_in_p_stream(intra_run, tmp_path):
    frames, enc, got, _ = intra_run
    data = enc.headers() + b"".join(g.data for g in got)
    dec = oracle_decode(str(ORACLE), data, W, H, tmp_path)
    assert len(dec) == len(frames)
    for df, g in zip(dec, got):
        for dp, rp in zip(df, g.recon):
            assert np.array_equal(dp, rp)


def test_forced_overflow_falls_back_exactly():
    """Capacities shrunk so that every frame overflows: each is redone
    on the exact host path, with the same bytes, and counted."""
    frames = _frames(5, seed=11)
    enc = H264Encoder(W, H, qp=12, gop=3, device="cpu")
    enc._cabac_cap = t_run.CHUNK // 64
    enc._cabac_idr_chunk = t_run.CHUNK // 64
    got = _run(enc, [frames])
    assert enc.fallback_frames == 5
    assert got == _jax_stream(frames, qp=12, gop=3)


def test_load_state_from_jax_encoder_mid_gop():
    frames = _frames(6, seed=4)
    jenc = JEncoder(W, H, qp=27, gop=4, cabac=True, device_entropy=False)
    for f in frames[:2]:
        jenc.encode_frame(*f)
    enc = H264Encoder(W, H, qp=27, gop=4, device="cpu")
    enc.load_state(*(np.asarray(p) for p in jenc._ref), jenc._gop_pos,
                   jenc.frame_num, jenc.idr_pic_id, jenc.frame_idx)
    got = b"".join(p.result().data for p in enc.encode_run_async(frames[2:]))
    want = b"".join(jenc.encode_frame(*f).data for f in frames[2:])
    assert got == want
    assert enc.frame_idx == jenc.frame_idx
