"""The port's H.264 CAVLC encoder (device compute + device bit-packer)
against the JAX H264Encoder(cabac=False): byte-identical streams.

The JAX side runs its exact host-entropy path (device_entropy=False),
which its own suite holds byte-identical to its device packer
(tests/test_device_entropy.py); that path compiles far faster on the
CPU, which keeps these tests small."""

import numpy as np
import pytest
import torch

from ceracoder_tpu.app.source import DeviceTestPatternSource as JSource
from ceracoder_tpu.codec.h264.encoder import H264Encoder as JEncoder
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 112, 64      # 7 MB columns: JAX's column scans compile one per step


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n):
        y = ((xx * 2 + yy + t * 7) % 200 + 20
             + rng.integers(-6, 7, (H, W))).clip(0, 255).astype(np.uint8)
        y[8 + t * 2:40 + t * 2, 4 + t * 3:36 + t * 3] = 230
        u = ((xx[::2, ::2] + t) % 90 + 80).astype(np.uint8)
        v = np.full((H // 2, W // 2), 140, np.uint8)
        frames.append((y, u, v))
    return frames


def _jax(**kw):
    return JEncoder(W, H, cabac=False, device_entropy=False, **kw)


def _torch(**kw):
    return H264Encoder(W, H, cabac=False, device="cpu", **kw)


def _run(enc, runs, qps=None):
    """Encode runs (lists of frames) through encode_run_async."""
    data = enc.headers()
    i = 0
    for frames in runs:
        q = None if qps is None else qps[i:i + len(frames)]
        data += b"".join(p.result().data
                         for p in enc.encode_run_async(frames, qps=q))
        i += len(frames)
    return data


@pytest.mark.parametrize("qp", [20, 27, 35])
def test_stream_identical(qp):
    frames = _frames(5, seed=qp)
    a = _run(_torch(qp=qp, gop=3), [frames])
    b = _run(_jax(qp=qp, gop=3), [frames])
    assert a == b


def test_run_boundary_and_per_frame_qps():
    frames = _frames(6, seed=1)
    qps = [28, 28, 30, 30, 27, 27]
    runs = [frames[:3], frames[3:]]
    enc = _torch(qp=28, gop=4)
    a = _run(enc, runs, qps)
    assert enc.fallback_frames == 0
    assert a == _run(_jax(qp=28, gop=4), runs, qps)


def test_overflow_falls_back_exactly():
    frames = _frames(4, seed=2)
    enc = _torch(qp=26, gop=2, row_capacity_bytes=16)
    a = _run(enc, [frames])
    assert enc.fallback_frames == 4
    assert a == _run(_jax(qp=26, gop=2), [frames])


def test_device_source_matches():
    src = DeviceTestPatternSource(W, H, texture=4, device="cpu")
    jsrc = JSource(W, H, texture=4)
    planes = []
    for i in range(4):
        mine = [p.numpy() for p in src.frame(i)]
        ref = [np.asarray(p) for p in jsrc.frame(i)]
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        planes.append(tuple(ref))
    enc = _torch(qp=29, gop=8)
    a = enc.headers() + b"".join(
        p.result().data for p in enc.encode_run_async(source=src,
                                                      indices=range(4)))
    assert a == _run(_jax(qp=29, gop=8), [planes])


def test_load_state_from_jax_encoder_mid_gop():
    frames = _frames(5, seed=4)
    jenc = _jax(qp=27, gop=4)
    _run(jenc, [frames[:2]])
    enc = _torch(qp=27, gop=4)
    enc.load_state(*(np.asarray(p) for p in jenc._ref), jenc._gop_pos,
                   jenc.frame_num, jenc.idr_pic_id, jenc.frame_idx)
    a = b"".join(p.result().data for p in enc.encode_run_async(frames[2:]))
    b = b"".join(p.result().data for p in jenc.encode_run_async(frames[2:]))
    assert a == b
    assert enc.frame_idx == jenc.frame_idx


def test_per_frame_async_api_matches():
    """encode_frame_async with several frames in flight (each a run of
    one) gives the reference's per-frame stream."""
    frames = _frames(4, seed=5)
    enc = _torch(qp=30, gop=3)
    pend = [enc.encode_frame_async(*f) for f in frames]
    a = enc.headers() + b"".join(p.result().data for p in pend)
    jenc = _jax(qp=30, gop=3)
    b = jenc.headers() + b"".join(jenc.encode_frame(*f).data for f in frames)
    assert a == b
    rec = pend[-1].result().recon
    assert np.array_equal(rec[0], np.asarray(jenc._ref[0]))
