"""SAO in the port (ops/h265.py: sao_estimate_dev, sao_apply_dev;
H265DeviceEncoder(sao=True)) against the JAX package on the CPU: the
estimator's parameters and the filtered planes against
`sao_estimate_jit` / `sao_apply_jit` on real deblocked IDR and P
reconstructions and on made-up planes, at qp 22, 30, 34 and 51; a
4-frame stream byte-identical to the JAX encoder's with SAO on, which
the libavcodec oracle (tools/decode_oracle) decodes to the port's
reconstruction bit-exactly; and the parameter sets. All at 112x64,
exact."""

import numpy as np
import pytest
import torch

import ceracoder_tpu_torch.codec.h265.device as device
from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEncoder
from ceracoder_tpu.ops.h265 import sao_apply_jit, sao_estimate_jit
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.ops.h265 import (
    encode_frame_row,
    level_capacity,
    sao_apply_dev,
    sao_estimate_dev,
    sao_frame_dev,
)
from tests.test_h265_rows import _panning, decode

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 112, 64
QPS = (22, 30, 34, 51)


def _t(planes):
    return tuple(torch.as_tensor(np.ascontiguousarray(p)) for p in planes)


def _deblocked(qp: int):
    """The port's deblocked IDR and P reconstructions of two panning
    frames at qp (SAO off), with their source planes."""
    frames = [_t(f) for f in _panning(2, W, H)]
    cap, chunk = level_capacity((H // 16) * (W // 16), True)
    idr = encode_frame_row(*frames[0], None, True, qp, chroma_qp(qp), cap,
                           chunk)["recon"]
    cap, chunk = level_capacity((H // 16) * (W // 16), False)
    p = encode_frame_row(*frames[1], idr, False, qp, chroma_qp(qp), cap,
                         chunk)["recon"]
    return {"idr": (frames[0], idr), "p": (frames[1], p)}


def _made_up(kind: str):
    """Source and 'reconstruction' planes: a band error (a darkened
    region, which band offsets repair), ringing around edges (edge
    offsets) and unrelated noise."""
    rng = np.random.default_rng(len(kind))
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    src = [rng.integers(60, 200, s) for s in shapes]
    if kind == "band":
        rec = [s.copy() for s in src]
        for r in rec:
            r[:16, :32] -= 5
    elif kind == "ringing":
        src = [np.where((np.arange(s[1]) // 4) % 2, 180, 70)
               * np.ones(s, int) for s in shapes]
        rec = [s + np.where(s > 100, 3, -3) * (rng.random(s.shape) < 0.6)
               for s in src]
    else:
        rec = [rng.integers(0, 256, s) for s in shapes]
    return (tuple(np.clip(p, 0, 255).astype(np.uint8) for p in src),
            tuple(np.clip(p, 0, 255).astype(np.uint8) for p in rec))


CASES = [(kind, qp) for kind in ("idr", "p", "band", "ringing", "noise")
         for qp in QPS]


@pytest.fixture(scope="module")
def deblocked():
    return {qp: _deblocked(qp) for qp in QPS}


def _inputs(kind, qp, deblocked):
    if kind in ("idr", "p"):
        return deblocked[qp][kind]
    src, rec = _made_up(kind)
    return _t(src), _t(rec)


@pytest.mark.parametrize("kind,qp", CASES)
def test_estimate_and_apply_match_jax(kind, qp, deblocked):
    src, rec = _inputs(kind, qp, deblocked)
    params = sao_estimate_dev(src, rec, qp)
    want = np.asarray(sao_estimate_jit(tuple(p.numpy() for p in src),
                                       tuple(p.numpy() for p in rec), qp))
    assert params.dtype == torch.int32 and params.shape == want.shape
    assert np.array_equal(params.numpy(), want)
    got = sao_apply_dev(rec, params)
    for g, w in zip(got, sao_apply_jit(tuple(p.numpy() for p in rec), want),
                    strict=True):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the encoder's stage: both in one, the edge categories shared
    params2, got2 = sao_frame_dev(src, rec, qp)
    assert torch.equal(params2, params)
    assert all(torch.equal(a, b) for a, b in zip(got2, got, strict=True))


def test_sao_engages(deblocked):
    """Over the cases, luma takes band and edge offsets and chroma band
    offsets somewhere, on the real reconstructions and the made-up
    errors alike."""
    engaged = set()
    for kind, qp in CASES:
        types = sao_estimate_dev(*_inputs(kind, qp, deblocked), qp)[..., 0]
        engaged |= {(kind, c, int(t)) for c in range(3)
                    for t in types[..., c].unique().tolist() if t}
    assert {(c, t) for _, c, t in engaged} >= {(0, 1), (0, 2), (1, 1),
                                               (2, 1)}
    assert {k for k, _, _ in engaged} >= {"idr", "p", "band", "ringing"}


def test_stream_matches_jax_and_decodes(tmp_path, monkeypatch):
    """IDR + 3 P frames at qp 34 with SAO: the same bytes as the JAX
    encoder's, SAO taken on some CTBs, and the oracle decodes every
    frame to the port's (SAO-filtered) reconstruction."""
    sao_types = []
    entropy = device.entropy_rows_native

    def spy(p, arrays, *a, **kw):
        sao_types.append(arrays["sao"][:, :, :, 0].copy())
        return entropy(p, arrays, *a, **kw)
    monkeypatch.setattr(device, "entropy_rows_native", spy)
    frames = _panning(4, W, H)
    enc = H265DeviceEncoder(W, H, qp=34, gop=8, sao=True, device="cpu")
    results = [p.result() for p in enc.encode_run_async(frames)]
    data = enc.headers() + b"".join(r.data for r in results)
    jenc = JEncoder(W, H, qp=34, gop=8, sao=True)
    want = jenc.headers() + b"".join(jenc.encode_frame(*f).data
                                     for f in frames)
    assert data == want
    assert [r.keyframe for r in results] == [True, False, False, False]
    assert len(sao_types) == 4 and all(t.any() for t in sao_types)
    path = tmp_path / "sao.265"
    path.write_bytes(data)
    for i, (dec, r) in enumerate(zip(decode(path, W, H, 4), results)):
        for name, dp, rp in zip("yuv", dec, r.recon):
            assert np.array_equal(dp, rp), f"frame {i} {name}"


def test_parameter_sets_match_jax():
    for sao in (False, True):
        got = H265DeviceEncoder(W, H, qp=34, sao=sao, device="cpu").headers()
        assert got == JEncoder(W, H, qp=34, sao=sao).headers()
    assert (H265DeviceEncoder(W, H, sao=True, device="cpu").headers()
            != H265DeviceEncoder(W, H, device="cpu").headers())
