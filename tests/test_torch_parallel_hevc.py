"""The port's banded HEVC encode (ceracoder_tpu_torch/parallel/hevc.py)
and GOP-parallel encoders (parallel/gop.py) on lists of CPU devices:
the sharded step against the JAX package's single-device ops and the
port's (band counts that do not divide the CTB rows, motion across the
seams, the TU split), the halos at the picture's edges, the banded
encoder's bytes against the port's and the JAX single-device encoder,
the reference's fault F9 (the JAX banded encoder codes padding rows),
and the GOP-parallel streams against a single-device encode and the
oracle.

The JAX references are its single-device ops and encoder at one size,
96x64, whose executables compile once per module and serve every test
here (tests/test_parallel_hevc.py holds the JAX sharded step equal to
them); compiling the JAX sharded step or encoder costs 40 test-seconds
each under the tier-1 command's six workers. The JAX banded encoder
runs once, for F9, on one IDR. The HEVC P path needs widths in whole
32-px blocks."""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEncoder
from ceracoder_tpu.ops.h265 import (
    deblock_frame_jit,
    encode_frame_i_rows,
    encode_frame_p_rows,
)
from ceracoder_tpu.parallel.hevc import ShardedH265Encoder as JSharded
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.ops import h265 as T
from ceracoder_tpu_torch.parallel.gop import (
    GopParallelEncoder,
    gop_throughput_scaling,
)
from ceracoder_tpu_torch.parallel.hevc import (
    KEYS,
    GopParallelStreamEncoder,
    ShardedH265Encoder,
    _halo_rows,
    hevc_sharded_step,
)
from ceracoder_tpu_torch.parallel.mesh import band_bounds, make_mesh
from tests.test_parallel_hevc import _content, _vert_pan_content

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
ORACLE = Path(__file__).resolve().parents[1] / "tools" / "decode_oracle"


def _single(y, u, v, ref, qp, qp_c, idr, tu_split=False):
    """One stream's frame through the port's single-device ops, as
    ops/h265.py:encode_frame_row runs them: the core, then the deblock."""
    y, u, v = (torch.as_tensor(p) for p in (y, u, v))
    if idr:
        o = T._i_frame_core(y, u, v, qp, qp_c)
    else:
        o = T._p_frame_core(y, u, v, *ref, qp, qp_c, tu_split=tu_split)
    split = ({"tu_split": o["tu_split"], "luma_lv": o["luma_lv"]}
             if tu_split and not idr else {})
    o["recon"] = T.deblock_frame_dev(
        *o["recon"], o["is_intra"], (o["luma_lv"] != 0).flatten(2).any(-1),
        o["mv"], qp, **split)
    return o


def _assert_equal(got, want, tag):
    for k in KEYS:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), \
            f"{tag} {k}"
    for i in range(3):
        assert np.array_equal(np.asarray(got["recon"][i]),
                              np.asarray(want["recon"][i])), f"{tag} recon {i}"


def _jax_single(y, u, v, ref, qp, qp_c, idr):
    """One stream's frame through the JAX single-device ops, as its
    H265DeviceEncoder's per-frame path calls them (the same executables)."""
    if idr:
        o = dict(encode_frame_i_rows(y, u, v, qp, qp_c))
    else:
        o = dict(encode_frame_p_rows(y, u, v, *ref, qp, qp_c,
                                     tu_split=False))
    cbf = o["luma_lv"].reshape(*o["luma_lv"].shape[:2], -1).any(-1)
    o["recon"] = deblock_frame_jit(*o["recon"], o["is_intra"], cbf, o["mv"],
                                   qp, None, tu_split=o["tu_split"],
                                   luma_lv=o["luma_lv"])
    return {k: np.asarray(v) for k, v in o.items() if k != "recon"} | {
        "recon": [np.asarray(r) for r in o["recon"]]}


def test_step_matches_jax():
    """2 streams of 64x96 on a 2x4 mesh (the JAX test's), IDR then P:
    every per-CTB array, the deblocked reconstruction and the summed
    nonzero counts equal the JAX single-device ops per stream."""
    s, h, w = 2, 64, 96
    qp, qp_c = 30, 29
    frame = _content(s, h, w)
    mesh = make_mesh(2, 4, [CPU] * 8)
    y0, u0, v0 = frame(0)
    zeros = [np.zeros_like(p) for p in (y0, u0, v0)]
    got_i, _ = hevc_sharded_step(mesh, qp, qp_c, idr=True)(y0, u0, v0,
                                                            *zeros)
    y1, u1, v1 = frame(1)
    got_p, nz = hevc_sharded_step(mesh, qp, qp_c)(y1, u1, v1,
                                                  *got_i["recon"])
    for st in range(s):
        want_i = _jax_single(y0[st], u0[st], v0[st], None, qp, qp_c, True)
        want_p = _jax_single(y1[st], u1[st], v1[st], want_i["recon"], qp,
                             qp_c, False)
        for tag, got, want in (("I", got_i, want_i), ("P", got_p, want_p)):
            _assert_equal({k: got[k][st] for k in KEYS}
                          | {"recon": [r[st] for r in got["recon"]]},
                          want, f"{tag} s{st}")
        assert int(nz[st]) == sum(int((want_p[k] != 0).sum())
                                  for k in ("luma_lv", "cb_lv", "cr_lv"))
    assert (got_p["mv"] != 0).any() and not got_p["is_intra"].all()


@pytest.mark.parametrize("n_rows,h,w,shift,tu_split", [
    (3, 80, 96, 7, True),      # 5 CTB rows: bands of 2, 2, 1
    (3, 80, 96, 6, False),
    (8, 384, 96, 6, False),    # 8 bands of 48 rows (1080p's ratio)
    (2, 32, 64, 7, True),      # bands of one CTB row
])
def test_step_matches_single_device(n_rows, h, w, shift, tu_split):
    """Vertical pan at the halo's reach: MVs cross every seam. IDR then
    P over the bands equal the single-device ops on the whole frame."""
    qp, qp_c = 30, 29
    mesh = make_mesh(1, n_rows, [CPU] * n_rows)
    frame = _vert_pan_content(h, w, shift)
    y0, u0, v0 = frame(0)
    zeros = [np.zeros_like(p) for p in (y0, u0, v0)]
    got_i, _ = hevc_sharded_step(mesh, qp, qp_c, idr=True)(y0, u0, v0,
                                                            *zeros)
    want_i = _single(y0[0], u0[0], v0[0], None, qp, qp_c, True)
    _assert_equal({k: got_i[k][0] for k in KEYS}
                  | {"recon": [r[0] for r in got_i["recon"]]}, want_i, "I")
    y1, u1, v1 = frame(1)
    got_p, nz = hevc_sharded_step(mesh, qp, qp_c, tu_split=tu_split)(
        y1, u1, v1, *got_i["recon"])
    want_p = _single(y1[0], u1[0], v1[0], want_i["recon"], qp, qp_c, False,
                     tu_split)
    _assert_equal({k: got_p[k][0] for k in KEYS}
                  | {"recon": [r[0] for r in got_p["recon"]]}, want_p, "P")
    assert int(nz[0]) == sum(int((want_p[k] != 0).sum())
                             for k in ("luma_lv", "cb_lv", "cr_lv"))
    mvs, counts = torch.unique(got_p["mv"][0].reshape(-1, 2), dim=0,
                               return_counts=True)
    assert mvs[counts.argmax()].tolist() == [4 * shift, 0]
    if tu_split:
        assert got_p["tu_split"].any()


def test_step_without_deblock():
    """deblock=False: each band's reconstruction is its core's, unfiltered
    (IDR, then a P frame against that reference)."""
    mesh = make_mesh(1, 2, [CPU] * 2)
    frame = _vert_pan_content(48, 64, 7)
    y0, u0, v0 = frame(0)
    zeros = [np.zeros_like(p) for p in (y0, u0, v0)]
    got_i, _ = hevc_sharded_step(mesh, 30, 29, idr=True, deblock=False)(
        y0, u0, v0, *zeros)
    want_i = T._i_frame_core(*(torch.from_numpy(p[0]) for p in (y0, u0, v0)),
                             30, 29)
    y1, u1, v1 = frame(1)
    got_p, _ = hevc_sharded_step(mesh, 30, 29, deblock=False)(
        y1, u1, v1, *got_i["recon"])
    want_p = T._p_frame_core(*(torch.from_numpy(p[0]) for p in (y1, u1, v1)),
                             *want_i["recon"], 30, 29)
    for tag, got, want in (("I", got_i, want_i), ("P", got_p, want_p)):
        _assert_equal({k: got[k][0] for k in KEYS}
                      | {"recon": [r[0] for r in got["recon"]]}, want, tag)


@pytest.mark.parametrize("k", [T.LUMA_SRC_PAD, T.CHROMA_PAD])
def test_halo_rows_at_picture_edges(k):
    """Each band extended by k rows: the neighbours' rows inside the
    picture, the border row replicated above the first band and below
    the last, so the bands tile the edge-padded plane."""
    plane = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (5 * 16, 24)).astype(np.uint8))
    padded = T._pad_edge(plane, k, k, 0, 0)
    bounds = band_bounds(5, 3)
    bands = [plane[16 * r0:16 * r1] for r0, r1 in bounds]
    for (r0, r1), got in zip(bounds, _halo_rows(bands, k)):
        assert torch.equal(got, padded[16 * r0:16 * r1 + 2 * k])


def _clip(n, w, h, seed=3):
    frame = _content(1, h, w, seed=seed)
    return [tuple(p[0] for p in frame(i)) for i in range(n)]


QPS = [31, 31, 34, 34, 28, 31, 31, 31]


def _frames_bytes(enc, frames, idr_at=None):
    return enc.headers() + b"".join(
        enc.encode_frame(*f, qp=q, force_idr=i == idr_at).data
        for i, (f, q) in enumerate(zip(frames, QPS)))


@pytest.fixture(scope="module")
def single_96x64():
    frames = _clip(8, 96, 64)
    enc = H265DeviceEncoder(96, 64, qp=31, gop=4, device="cpu")
    return frames, _frames_bytes(enc, frames, idr_at=6), enc.recon


@pytest.mark.parametrize("n_bands", [2, 4])
def test_encoder_matches_single_device(single_96x64, n_bands):
    """8 frames at 96x64, gop 4, per-frame QPs and an IDR forced at
    frame 6: the bytes and the reconstruction of the single-device
    encode_frame."""
    frames, want, recon = single_96x64
    enc = ShardedH265Encoder(96, 64, qp=31, gop=4, n_bands=n_bands,
                             devices=[CPU] * n_bands)
    assert enc.bframes == 0
    assert _frames_bytes(enc, frames, idr_at=6) == want
    assert enc.frames_launched == 8
    for a, b in zip(enc.recon, recon):
        assert np.array_equal(a, b)
    enc.resume()
    assert enc.encode_frame(*frames[1]).keyframe


def test_encoder_matches_jax(single_96x64):
    """The same 8 frames in 2 bands: the JAX single-device encoder's
    bytes (its banded encoder equals it where no padding row is added,
    tests/test_app_parallel.py)."""
    frames, want, _ = single_96x64
    got = ShardedH265Encoder(96, 64, qp=31, gop=4, n_bands=2,
                             devices=[CPU] * 2)
    assert _frames_bytes(got, frames, idr_at=6) == want
    assert _frames_bytes(JEncoder(96, 64, qp=31, gop=4), frames,
                         idr_at=6) == want


def test_f9_jax_banded_encoder_codes_padding_rows(single_96x64):
    """The reference's fault F9: at 96x64 (4 CTB rows) in 3 bands the JAX
    ShardedH265Encoder rounds the picture up to 6 CTB rows and codes
    the extra rows, so its stream differs from its own single-device
    encoder's from the IDR on (one frame keeps its compile short). The
    port's bands take 2, 1 and 1 rows: its banded bytes equal its
    single-device bytes and the JAX single-device encoder's."""
    frames, _, _ = single_96x64
    frames = frames[:1]
    banded = _frames_bytes(ShardedH265Encoder(96, 64, qp=31, gop=4,
                                              n_bands=3,
                                              devices=[CPU] * 3), frames)
    single = _frames_bytes(H265DeviceEncoder(96, 64, qp=31, gop=4,
                                             device="cpu"), frames)
    jax_single = _frames_bytes(JEncoder(96, 64, qp=31, gop=4), frames)
    j_banded = JSharded(96, 64, qp=31, gop=4, n_bands=3)
    assert j_banded.ph == 96
    jax_banded = _frames_bytes(j_banded, frames)
    assert banded == single == jax_single
    assert jax_banded != jax_single


def _oracle_frames(data: bytes, tmp_path) -> int:
    path = tmp_path / "g.265"
    path.write_bytes(data)
    r = subprocess.run([str(ORACLE), str(path), str(path) + ".yuv"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return int(r.stderr.split("frames=")[1].split()[0])


def test_gop_parallel_matches_single_device(single_96x64, tmp_path):
    """Closed GOPs of 4 round-robin over [cpu, cpu] (encode_clip from
    frames and from the device source, and the app's stream encoder run
    by run): the single-device stream at gop 4, which the oracle
    decodes."""
    frames, _, _ = single_96x64
    se = H265DeviceEncoder(96, 64, qp=31, gop=4, device="cpu")
    want = se.headers() + b"".join(se.encode_frame(*f).data for f in frames)
    ge = GopParallelEncoder(96, 64, qp=31, gop=4, devices=[CPU] * 2)
    assert ge.headers() + b"".join(ge.encode_clip(frames)) == want
    stream = GopParallelStreamEncoder(96, 64, qp=31, gop=4,
                                      devices=[CPU] * 2)
    runs = [stream.encode_run_async(frames[i:i + 4]) for i in (0, 4)]
    assert stream.headers() + b"".join(
        p.result().data for run in runs for p in run) == want
    assert stream.frames_launched == 8
    assert [e.frames_launched for e in stream.encoders] == [4, 4]
    assert _oracle_frames(want, tmp_path) == 8

    src = DeviceTestPatternSource(96, 64, texture=6, device="cpu")
    se = H265DeviceEncoder(96, 64, qp=31, gop=4, device="cpu")
    want = b"".join(p.result().data for p in se.encode_run_async(
        source=src, indices=range(6)))
    assert b"".join(ge.encode_clip(source=src, n_frames=6)) == want


def test_gop_throughput_scaling_on_cpu():
    fps_1, fps_n, n = gop_throughput_scaling(
        64, 32, _clip(4, 64, 32), gop=2, devices=[CPU] * 2)
    assert n == 2 and fps_1 > 0 and fps_n > 0


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ShardedH265Encoder(64, 48),
                 lambda: GopParallelStreamEncoder(64, 48),
                 lambda: GopParallelEncoder(64, 48)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(ValueError, match="3 rows do not split into 4"):
        ShardedH265Encoder(64, 48, n_bands=4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ShardedH265Encoder(64, 48, devices=[CPU])
