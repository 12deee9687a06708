"""The reference: bands of CTB rows over processes give the bytes of the
whole picture; it equals the program at a small size; the control's lower
precision changes the bytes."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.camera import Camera
from benchmark.reference.hevc import precision
from benchmark.reference.hevc.bands import BandedEncoder

W, H, QP = 320, 192, 30
PARAMS = harness.load_json(harness.BENCH / "traffic" / "live.json")["camera"]


def _frames(n, seed=9):
    cam = Camera(W, H, seed, PARAMS)
    return [tuple(p.numpy() for p in cam.frame(i)) for i in range(n)]


def _code(workers, frames):
    out = []
    with BandedEncoder(W, H, QP, workers=workers) as ref:
        rec = None
        for k, f in enumerate(frames):
            data, rec = ref.encode(ref.pad(*f), QP, ref=rec, poc=k)
            out.append((data, rec))
    return out


def _same(a, b):
    return a[0] == b[0] and all(np.array_equal(x, y)
                                for x, y in zip(a[1], b[1]))


def test_bands_equal_the_whole_picture():
    frames = _frames(3)
    whole = _code(1, frames)
    assert all(_same(a, b) for a, b in zip(whole, _code(4, frames)))


def test_reference_equals_the_program_on_the_cpu():
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    torch.set_num_threads(1)
    frames = _frames(3, seed=2**31 + 1)
    enc = H265DeviceEncoder(W, H, qp=QP, gop=120, device="cpu")
    got = [pf.result() for pf in enc.encode_run_async(
        frames=[tuple(torch.from_numpy(p) for p in f) for f in frames])]
    ref = _code(3, frames)
    for fr, (data, rec) in zip(got, ref):
        assert fr.data == data
        assert all(np.array_equal(p.numpy(), r)
                   for p, r in zip(fr._recon_dev, rec))


@pytest.mark.parametrize("mode, differs", [("tf32", True),
                                           ("float32", False)])
def test_control_precision(mode, differs):
    """TF32 products change the first IDR and P frame; float32 ones do
    not at these sums (below 2**24), so float32 is no control here."""
    frames = _frames(2)
    exact = _code(2, frames)
    precision.set_mode(mode)
    try:
        low = _code(2, frames)
    finally:
        precision.set_mode("exact")
    assert any(not _same(a, b) for a, b in zip(exact, low)) == differs


def test_precision_modes():
    a = np.arange(16, dtype=np.int64).reshape(4, 4) * 1000 + 1
    assert np.array_equal(precision.imatmul(a, a), a @ a)
    with pytest.raises(ValueError):
        precision.set_mode("bf16")
