"""The port's HEVC encoder (ceracoder_tpu_torch/codec/h265/device.py)
against the JAX package's H265DeviceEncoder.encode_run_async on the
CPU: byte-identical streams across run boundaries, per-frame QPs and
an IDR inside a run, with the device source, in the overflow case;
against the numpy H265RowEncoder; and through the libavcodec oracle
(tools/decode_oracle), which must decode the port's reconstruction
bit-exactly. Sizes stay at 96x64: the JAX run executables compile
slowly on the CPU."""

import numpy as np
import pytest
import torch

from ceracoder_tpu.app.source import DeviceTestPatternSource as JSource
from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEncoder
from ceracoder_tpu.codec.h265.rowslice import H265RowEncoder
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.ops.h265 import LEVEL_CHUNK
from tests.test_h265_rows import _panning, decode

W, H = 96, 64
QPS = [30, 30, 33, 33, 28, 28]


def _torch(**kw):
    return H265DeviceEncoder(W, H, device="cpu", **kw)


def _run(enc, runs, qps=None, **kw):
    """Headers + every frame of `runs` (lists of frames) encoded through
    encode_run_async, and the pending frames' results."""
    data, results, i = enc.headers(), [], 0
    for frames in runs:
        q = None if qps is None else qps[i:i + len(frames)]
        results += [p.result() for p in enc.encode_run_async(frames, qps=q,
                                                             **kw)]
        i += len(frames)
    return data + b"".join(r.data for r in results), results


def test_runs_with_per_frame_qps_match_jax_and_decode(tmp_path):
    """Two runs, per-frame QPs, gop 4: the IDR at frame 4 falls inside
    the second run. Same bytes as the JAX encoder; the oracle decodes
    every frame to the port's reconstruction."""
    frames = _panning(6)
    runs = [frames[:3], frames[3:]]
    enc = _torch(qp=30, gop=4)
    a, results = _run(enc, runs, QPS)
    b, _ = _run(JEncoder(W, H, qp=30, gop=4), runs, QPS)
    assert a == b
    assert [r.keyframe for r in results] == [True, False, False, False,
                                             True, False]
    assert enc.fallback_frames == 0
    path = tmp_path / "run.265"
    path.write_bytes(a)
    for i, (dec, r) in enumerate(zip(decode(path, W, H, 6), results)):
        for name, dp, rp in zip("yuv", dec, r.recon):
            hh, ww = dp.shape
            assert np.array_equal(dp, rp[:hh, :ww]), f"frame {i} {name}"
    ry, ru, rv = enc.recon
    assert np.array_equal(ry, results[-1].recon[0][:H, :W])
    assert np.array_equal(rv, results[-1].recon[2][:H // 2, :W // 2])


def test_device_source_matches_jax():
    src = DeviceTestPatternSource(W, H, texture=4, device="cpu")
    jsrc = JSource(W, H, texture=4)
    enc = _torch(qp=30, gop=8)
    a = enc.headers() + b"".join(
        p.result().data for p in enc.encode_run_async(source=src,
                                                      indices=range(4)))
    jenc = JEncoder(W, H, qp=30, gop=8)
    b = jenc.headers() + b"".join(
        p.result().data for p in jenc.encode_run_async(source=jsrc,
                                                       indices=range(4)))
    assert a == b


def test_overflow_codes_dense_levels_exactly():
    """Noise at qp 22 with the capacity cut to one chunk: the P frames'
    sparse levels overflow, the port codes them from the dense levels
    it kept on the device, and the bytes equal the JAX encoder's exact
    host fallback."""
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (H, W)).astype(np.uint8),
               rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
               rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))
              for _ in range(3)]
    enc = _torch(qp=22, gop=8)
    a, _ = _run(enc, [frames], cap=LEVEL_CHUNK)
    assert enc.fallback_frames >= 1
    b, _ = _run(JEncoder(W, H, qp=22, gop=8), [frames], cap=LEVEL_CHUNK)
    assert a == b


def test_matches_row_encoder_stream():
    frames = _panning(3)
    enc = _torch(qp=30, gop=50)
    row = H265RowEncoder(W, H, qp=30, gop=50)
    a, _ = _run(enc, [frames])
    b = row.headers() + b"".join(row.encode_frame(*f)[0] for f in frames)
    assert a == b


def test_load_state_continues_a_jax_encoder():
    frames = _panning(6)
    jenc = JEncoder(W, H, qp=30, gop=4)
    _run(jenc, [frames[:3]], QPS)
    enc = _torch(qp=30, gop=4)
    enc.load_state(*(np.asarray(p) for p in jenc._ref), jenc._poc)
    a = b"".join(p.result().data
                 for p in enc.encode_run_async(frames[3:], qps=QPS[3:]))
    b = b"".join(p.result().data
                 for p in jenc.encode_run_async(frames[3:], qps=QPS[3:]))
    assert a == b
    with pytest.raises(ValueError, match="do not match"):
        enc.load_state(np.zeros((H, W), np.uint8),
                       np.zeros((H // 2, W // 2), np.uint8),
                       np.zeros((H, W), np.uint8), 1)


def test_odd_size_pads_like_jax():
    """A 90x60 picture is edge-padded to the CTB grid on the device."""
    frames = [tuple(p[:60, :90] if i == 0 else p[:30, :45]
                    for i, p in enumerate(f)) for f in _panning(3)]
    a, _ = _run(H265DeviceEncoder(90, 60, qp=31, gop=8, device="cpu"),
                [frames])
    b, _ = _run(JEncoder(90, 60, qp=31, gop=8), [frames])
    assert a == b


@pytest.mark.cuda
def test_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    frames = _panning(6)
    runs = [frames[:3], frames[3:]]
    gpu, results = _run(H265DeviceEncoder(W, H, qp=30, gop=4), runs, QPS)
    cpu, _ = _run(_torch(qp=30, gop=4), runs, QPS)
    assert gpu == cpu
    src = DeviceTestPatternSource(W, H, texture=4)
    csrc = DeviceTestPatternSource(W, H, texture=4, device="cpu")
    a = b"".join(p.result().data for p in H265DeviceEncoder(
        W, H, qp=30, gop=8).encode_run_async(source=src, indices=range(4)))
    b = b"".join(p.result().data for p in _torch(
        qp=30, gop=8).encode_run_async(source=csrc, indices=range(4)))
    assert a == b
    assert results[0]._recon_dev[0].device.type == "cuda"
