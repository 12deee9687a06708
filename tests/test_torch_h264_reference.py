"""The port's H.264 host reference codec (ceracoder_tpu_torch: the CABAC
init tables, the arithmetic coder and H264RowCabac, the decode twin
H264SliceParser, the stream walker and the I_PCM encoder) against the
JAX package's twins on the CPU. Everything is integer host code, so
every comparison is exact: equal tables and contexts, equal bytes, and
parser records equal to JAX's with each slice's payload consumed to
within 2 bytes. Inputs are small and seeded; nothing compiles JAX."""

import subprocess
from dataclasses import asdict

import numpy as np
import pytest
import torch

import ceracoder_tpu.codec.h264.cabac as j_cabac
import ceracoder_tpu.codec.h264.cabac_init_tables as j_init
import ceracoder_tpu_torch.codec.h264.cabac as t_cabac
import ceracoder_tpu_torch.codec.h264.cabac_init_tables as t_init
from ceracoder_tpu.codec.bitwriter import BitReader as JReader
from ceracoder_tpu.codec.bitwriter import strip_emulation as j_strip
from ceracoder_tpu.codec.h264.cabac_dec import H264SliceParser as JParser
from ceracoder_tpu.codec.h264.ipcm import encode_ipcm_stream as j_ipcm
from ceracoder_tpu.codec.h264.parse import split_nals as j_split
from ceracoder_tpu.codec.h264.parse import walk_stream as j_walk
from ceracoder_tpu_torch.codec.bitwriter import BitReader, strip_emulation
from ceracoder_tpu_torch.codec.h264.cabac_dec import H264SliceParser
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
from ceracoder_tpu_torch.codec.h264.ipcm import encode_ipcm_stream
from ceracoder_tpu_torch.codec.h264.parse import split_nals, walk_stream
from ceracoder_tpu_torch.codec.h265.cabac import CabacDecoder
from tests.test_h264_cabac import X264_PARAMS, X264_REF
from tests.test_h264_conformance import ORACLE, oracle_decode

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

W, H = 144, 96


def _rec(mb: dict) -> dict:
    """A parser record with its arrays as lists, for equality."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in mb.items()}


def _parse_all(data: bytes, mbw: int, mbh: int):
    """Every slice of an Annex-B CABAC stream through the port's walker
    and parser and through JAX's: the slice headers, the payloads and
    the MB records must agree, and each payload is consumed to within
    2 bytes. Returns the port's records, per slice."""
    mine = list(walk_stream(data))
    ref = list(j_walk(data))
    assert len(mine) == len(ref) > 0
    out = []
    for (sh, pl, pps), (jsh, jpl, jpps) in zip(mine, ref):
        assert asdict(sh) == asdict(jsh) and pl == jpl
        args = (sh.qp, sh.slice_type == 2, mbw, mbh)
        kw = dict(first_mb=sh.first_mb, cabac_init_idc=sh.cabac_init_idc)
        p = H264SliceParser(pl, *args, **kw)
        mbs = p.parse()
        jp = JParser(jpl, *args, **kw)
        assert [_rec(m) for m in mbs] == [_rec(m) for m in jp.parse()]
        assert p.consumed_bytes() == jp.consumed_bytes()
        assert 0 <= len(pl) - p.consumed_bytes() <= 2
        out.append((sh, mbs))
    return out


# ---------------------------------------------------------------------------
# tables, contexts, the arithmetic coder
# ---------------------------------------------------------------------------

def test_init_tables_equal():
    assert t_init.CABAC_INIT_I == j_init.CABAC_INIT_I
    assert t_init.CABAC_INIT_PB == j_init.CABAC_INIT_PB
    assert tuple(t_init.CABAC_INIT_PB[0][11]) == (23, 33)


@pytest.mark.parametrize("qp", [0, 1, 17, 26, 38, 51, 60])
@pytest.mark.parametrize("intra,idc", [(True, 0), (False, 0), (False, 1),
                                       (False, 2)])
def test_init_contexts_equal(qp, intra, idc):
    assert np.array_equal(t_cabac.init_contexts(qp, intra, idc),
                          j_cabac.init_contexts(qp, intra, idc))


def _random_bins(rng, n):
    """(kind, ctx index, bin) ops: context-coded, bypass, terminate 0."""
    ops = []
    for _ in range(n):
        k = rng.random()
        kind = "ctx" if k < 0.6 else "byp" if k < 0.95 else "term"
        ops.append((kind, int(rng.integers(0, 8)),
                    0 if kind == "term" else int(rng.integers(0, 2))))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_arith_encoder_bytes(seed):
    """H264ArithEncoder's bytes equal JAX's on random bin sequences
    (skewed bins exercise the outstanding-bit carries), and the shared
    M-decoder reads every bin back."""
    rng = np.random.default_rng(seed)
    ops = _random_bins(rng, int(rng.integers(1, 3000)))
    if seed % 2:
        ops = [(k, i, 1 if k == "ctx" else b) for k, i, b in ops]
    ctx0 = t_cabac.init_contexts(int(rng.integers(0, 52)), bool(seed % 3))
    outs = []
    for mod in (t_cabac, j_cabac):
        enc, ctx = mod.H264ArithEncoder(), ctx0.copy()
        for kind, i, b in ops:
            if kind == "ctx":
                enc.encode_bin(ctx, i, b)
            elif kind == "byp":
                enc.encode_bypass(b)
            else:
                enc.encode_terminate(0)
        outs.append(enc.flush())
    assert outs[0] == outs[1]
    dec, ctx = CabacDecoder(outs[0]), ctx0.copy()
    for kind, i, b in ops:
        got = (dec.decode_bin(ctx, i) if kind == "ctx"
               else dec.decode_bypass() if kind == "byp"
               else dec.decode_terminate())
        assert got == b
    assert dec.decode_terminate() == 1


# ---------------------------------------------------------------------------
# H264RowCabac rows and the decode twin
# ---------------------------------------------------------------------------

def _levels(rng, shape, density):
    lv = rng.integers(-20, 21, shape)
    lv[rng.random(shape) > density] = 0
    if rng.random() < 0.2:        # a large level: the UEG0 escape
        lv.flat[int(rng.integers(0, lv.size))] = int(rng.integers(15, 600))
    return lv.astype(np.int64)


def _random_mb(rng, intra_slice):
    kinds = ["i16", "i4"] if intra_slice else ["p16", "skip", "i16", "i4"]
    kind = kinds[int(rng.integers(0, len(kinds)))]
    dens = float(rng.choice([0.0, 0.1, 0.5]))
    cbp_c = int(rng.integers(0, 3))
    cdc = _levels(rng, (2, 4), dens) if cbp_c else np.zeros((2, 4), np.int64)
    cacs = (_levels(rng, (2, 4, 15), dens) if cbp_c == 2
            else np.zeros((2, 4, 15), np.int64))
    dqp = int(rng.integers(-3, 4))
    if kind == "skip":
        return kind, ()
    if kind == "i16":
        cbp_l = 15 if rng.random() < 0.5 else 0
        acs = (_levels(rng, (16, 15), dens) if cbp_l
               else np.zeros((16, 15), np.int64))
        return kind, (int(rng.integers(0, 4)), int(rng.integers(0, 4)), dqp,
                      cbp_l, cbp_c, _levels(rng, 16, dens), acs, cdc, cacs)
    cbp_l = int(rng.integers(0, 16))
    blocks = _levels(rng, (16, 16), dens)
    if kind == "i4":
        return kind, (rng.integers(0, 8, 16), rng.integers(0, 2, 16),
                      int(rng.integers(0, 4)), dqp, cbp_l, cbp_c, blocks,
                      cdc, cacs)
    mvd = (int(rng.integers(-70, 71)), int(rng.integers(-70, 71)))
    return kind, (mvd, dqp, cbp_l, cbp_c, blocks, cdc, cacs)


def _code_row(mod, qp, intra_slice, mbs):
    cab = mod.H264RowCabac(qp, intra_slice)
    for i, (kind, args) in enumerate(mbs):
        {"i16": cab.mb_i16, "i4": cab.mb_i4, "p16": cab.mb_p16,
         "skip": cab.mb_skip}[kind](*args)
        cab.end_of_slice(i == len(mbs) - 1)
    return cab.finish()


@pytest.mark.parametrize("seed", range(12))
def test_row_cabac_rows(seed):
    """A row of random MBs (every MB kind, random levels and mvds):
    the port's H264RowCabac bytes equal JAX's, and the port's parser
    reads back the coded MB kinds, with records equal to JAX's
    parser's."""
    rng = np.random.default_rng(100 + seed)
    intra_slice = seed % 3 == 0
    qp = int(rng.integers(10, 52))
    mbs = [_random_mb(rng, intra_slice)
           for _ in range(int(rng.integers(1, 12)))]
    data = _code_row(t_cabac, qp, intra_slice, mbs)
    assert data == _code_row(j_cabac, qp, intra_slice, mbs)
    p = H264SliceParser(data, qp, intra_slice, len(mbs), 1)
    recs = p.parse()
    jp = JParser(data, qp, intra_slice, len(mbs), 1)
    assert [_rec(m) for m in recs] == [_rec(m) for m in jp.parse()]
    assert 0 <= len(data) - p.consumed_bytes() <= 2
    want = {"i16": "I_16x16", "i4": "I_4x4", "p16": "P_16x16",
            "skip": "P_Skip"}
    assert [m["mb_type"] for m in recs] == [want[k] for k, _ in mbs]
    for m, (kind, args) in zip(recs, mbs):
        if kind == "p16":
            assert m["mvd"] == args[0]


# ---------------------------------------------------------------------------
# the port's own CABAC streams through the walker and the decode twin
# ---------------------------------------------------------------------------

def _clip(n, seed, uncover=False):
    """A gradient with a moving box; with `uncover` the bottom half
    turns to new smooth content from frame 2 (intra MBs in P slices)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        y = ((xx + 2 * yy + t * 5) % 180 + 30
             + rng.integers(-5, 6, (H, W))).clip(0, 255)
        y[10 + 2 * t:42 + 2 * t, 8 + 3 * t:48 + 3 * t] = 220
        if uncover and t >= 2:
            y[H // 2:] = 150 + xx[H // 2:] // 5 + yy[H // 2:] // 10
        u = (xx[::2, ::2] + 2 * t) % 70 + 90
        v = (yy[::2, ::2] + t) % 50 + 100
        frames.append(tuple(p.astype(np.uint8) for p in (y, u, v)))
    return frames


_STREAMS = {}


def _port_stream(qp, uncover):
    """Headers + 3 frames (IDR, P, P) of the port's CPU CABAC encoder,
    and its recon; shared within the module."""
    key = (qp, uncover)
    if key not in _STREAMS:
        enc = H264Encoder(W, H, qp=qp, gop=60, device="cpu")
        frames = _clip(3, qp, uncover)
        data = enc.headers() + b"".join(enc.encode_frame(*f).data
                                        for f in frames)
        _STREAMS[key] = data
    return _STREAMS[key]


@pytest.mark.parametrize("qp,uncover", [(28, False), (28, True), (18, False),
                                        (44, True)])
def test_parser_on_port_stream(qp, uncover):
    """The port's CABAC encoder stream (one slice per MB row, IDR + 2 P)
    walks and parses to the picture's MBs; IDR MBs are intra, P slices
    code P MBs, and with new content intra MBs in P slices."""
    data = _port_stream(qp, uncover)
    slices = _parse_all(data, W // 16, H // 16)
    assert len(slices) == 3 * (H // 16)
    per_frame = [[], [], []]
    for i, (sh, mbs) in enumerate(slices):
        assert sh.first_mb == (i % (H // 16)) * (W // 16)
        assert len(mbs) == W // 16
        per_frame[i // (H // 16)] += mbs
    assert all(m["intra"] for m in per_frame[0])
    types = {m["mb_type"] for f in per_frame[1:] for m in f}
    assert types & {"P_16x16", "P_Skip"}
    if uncover:
        assert any(m["intra"] for m in per_frame[2])


@pytest.mark.parametrize("qp,uncover", [(28, False), (28, True)])
def test_walk_stream_headers(qp, uncover):
    """split_nals and walk_stream's SPS, PPS and slice headers equal
    JAX's on the port's stream."""
    data = _port_stream(qp, uncover)
    assert split_nals(data) == j_split(data)
    mine, ref = list(walk_stream(data)), list(j_walk(data))
    assert asdict(mine[0][2]) == asdict(ref[0][2])
    assert [asdict(s) for s, _, _ in mine] == [asdict(s) for s, _, _ in ref]
    assert [s.idr for s, _, _ in mine] == [True] * (H // 16) + [False] * (
        2 * (H // 16))
    assert {s.qp for s, _, _ in mine} == {qp}


@pytest.mark.parametrize("seed", range(4))
def test_bit_reader_and_emulation(seed):
    """BitReader's fields and strip_emulation equal JAX's."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 4, 400).astype(np.uint8).tobytes()
    assert strip_emulation(raw) == j_strip(raw)
    raw = rng.integers(0, 256, 400).astype(np.uint8).tobytes()
    r, jr = BitReader(raw), JReader(raw)
    while jr.remaining > 40:
        n = int(rng.integers(0, 9))
        assert (r.u(n), r.ue(), r.se(), r.peek(5), r.flag()) == (
            jr.u(n), jr.ue(), jr.se(), jr.peek(5), jr.flag())
    assert r.pos == jr.pos


# ---------------------------------------------------------------------------
# I_PCM
# ---------------------------------------------------------------------------

def _pcm_frames(w, h, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("w,h,n", [(16, 16, 1), (64, 48, 2), (48, 96, 3)])
def test_ipcm_stream_bytes(w, h, n):
    frames = _pcm_frames(w, h, n, w + h)
    assert encode_ipcm_stream(frames, w, h) == j_ipcm(frames, w, h)


@pytest.mark.skipif(not ORACLE.exists(), reason="decode_oracle not built")
def test_ipcm_decodes_losslessly(tmp_path):
    frames = _pcm_frames(64, 48, 2, 5)
    dec = oracle_decode(str(ORACLE), encode_ipcm_stream(frames, 64, 48),
                        64, 48, tmp_path)
    assert len(dec) == 2
    for got, want in zip(dec, frames):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# libx264 streams
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not X264_REF.exists(), reason="x264_ref not built")
@pytest.mark.parametrize("kind,qp", [("flat", 30), ("grad", 22),
                                     ("texture", 30), ("blocks", 38)])
def test_parser_walks_x264_streams(tmp_path, kind, qp):
    """The decode twin walks every slice of a real libx264 stream (I + P,
    I_16x16 / I_4x4 / P_16x16 / P_Skip, residuals, mvds, per-MB dqp)
    to its last byte, with JAX's records."""
    from tools.h264_cabac_trace import gen_clip

    w, h = 96, 64
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.264"
    yuv.write_bytes(gen_clip(w, h, 4, kind).tobytes())
    r = subprocess.run([str(X264_REF), str(yuv), str(w), str(h), "30",
                        str(out), "medium", f"qp:{qp}", X264_PARAMS],
                       capture_output=True)
    if r.returncode != 0:
        pytest.skip("libx264 unavailable")
    slices = _parse_all(out.read_bytes(), w // 16, h // 16)
    assert sum(len(m) for _, m in slices) == 4 * (w // 16) * (h // 16)
