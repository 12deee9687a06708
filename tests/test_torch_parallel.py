"""The port's row-banded H.264 intra step (ceracoder_tpu_torch/parallel/
mesh.py) on lists of CPU devices: equal to the single-device
encode_frame_i16_rows for every mesh of the JAX test
(tests/test_parallel.py) and for a band count that does not divide the
MB rows, equal to the JAX encode_sharded on its 8-device CPU mesh, the
summed nonzero counts, and the mesh's checks."""

import jax
import numpy as np
import pytest
import torch

from ceracoder_tpu.parallel.mesh import encode_sharded as j_encode_sharded
from ceracoder_tpu.parallel.mesh import make_mesh as j_make_mesh
from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows
from ceracoder_tpu_torch.parallel.mesh import (
    band_bounds,
    encode_sharded,
    make_mesh,
)

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = ("dc_luma", "ac_luma", "mode_luma", "dc_chroma", "ac_chroma",
        "mode_chroma")


@pytest.fixture(scope="module")
def frames():
    """The JAX test's frames: 2 streams of random 128x64 planes."""
    rng = np.random.default_rng(0)
    s, h, w = 2, 128, 64
    return (rng.integers(0, 256, (s, h, w)).astype(np.uint8),
            rng.integers(0, 256, (s, h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (s, h // 2, w // 2)).astype(np.uint8))


@pytest.fixture(scope="module")
def single(frames):
    """encode_frame_i16_rows per stream, on the whole frame."""
    return [encode_frame_i16_rows(*(torch.from_numpy(p[s]) for p in frames),
                                  28, 28) for s in range(2)]


def _nonzero(ref) -> int:
    return sum(int((ref[k] != 0).sum())
               for k in ("dc_luma", "ac_luma", "dc_chroma", "ac_chroma"))


@pytest.mark.parametrize("n_streams,n_rows",
                         [(2, 4), (1, 8), (2, 2), (1, 1), (2, 3)])
def test_sharded_matches_single_device(frames, single, n_streams, n_rows):
    """(2, 3): 8 MB rows in bands of 3, 3 and 2."""
    mesh = make_mesh(n_streams, n_rows, [CPU] * 8)
    outs, nz = encode_sharded(mesh, 28, 28)(*frames)
    assert nz.shape == (2,) and nz.dtype == torch.int32
    for s, ref in enumerate(single):
        for k in KEYS:
            assert outs[k].dtype == ref[k].dtype, k
            assert torch.equal(outs[k][s], ref[k]), (n_streams, n_rows, s, k)
        for got, want in zip(outs["recon"], ref["recon"]):
            assert torch.equal(got[s], want)
        assert int(nz[s]) == _nonzero(ref)


def test_sharded_matches_jax(frames):
    """The port's and the JAX step on a 2x4 mesh (JAX: its 8 virtual
    CPU devices; the port: 8 CPU device entries): the same arrays, of
    the same dtypes and shapes, and the same summed nonzero counts."""
    assert len(jax.devices()) == 8
    want, want_nz = j_encode_sharded(j_make_mesh(2, 4), 28, 28)(*frames)
    got, nz = encode_sharded(make_mesh(2, 4, [CPU] * 8), 28, 28)(*frames)
    for k in KEYS:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k
    for g, w in zip(got["recon"], want["recon"]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(nz.numpy(), np.asarray(want_nz))


def test_nonzero_count_sums_the_bands(frames, single):
    """One stream over 4 bands: the count is the whole frame's."""
    _, nz = encode_sharded(make_mesh(1, 4, [CPU] * 4), 28, 28)(*frames)
    assert nz.tolist() == [_nonzero(ref) for ref in single]


def test_mesh_checks():
    mesh = make_mesh(2, 4, [CPU] * 8)
    assert mesh.shape == {"streams": 2, "rows": 4}
    assert make_mesh(2, devices=[CPU] * 6).shape == {"streams": 2,
                                                    "rows": 3}
    with pytest.raises(ValueError, match="needs 8 devices, have 7"):
        make_mesh(2, 4, [CPU] * 7)
    with pytest.raises(ValueError, match="3 streams do not split"):
        encode_sharded(mesh, 28, 28)(*(np.zeros((3, 64, 32), np.uint8),
                                       np.zeros((3, 32, 16), np.uint8),
                                       np.zeros((3, 32, 16), np.uint8)))
    assert band_bounds(68, 3) == [(0, 23), (23, 46), (46, 68)]
    assert band_bounds(136, 8)[-1] == (119, 136)
    with pytest.raises(ValueError, match="5 rows do not split into 6"):
        band_bounds(5, 6)


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1, 1, ["cuda"])
