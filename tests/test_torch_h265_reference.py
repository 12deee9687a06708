"""The port's HEVC host reference codec (ceracoder_tpu_torch/codec/h265:
the tables, the CABAC engine, intra prediction and the transforms,
residual coding, inter search and motion compensation, deblocking, SAO,
the encoders of encoder.py and rowslice.py's numpy spec, Python entropy
stage and H265RowEncoder) against the JAX package's twins on the CPU.
Everything is integer host code, so every comparison is exact: equal
arrays and byte-identical NAL units. The Python entropy stage must also
equal the port's native one (entropy_rows_native). Inputs are small and
seeded (64x48 to 96x64, 2-4 frames); nothing compiles JAX."""

import numpy as np
import pytest
import torch

import ceracoder_tpu.codec.h265.cabac as j_cabac
import ceracoder_tpu.codec.h265.deblock as j_deblock
import ceracoder_tpu.codec.h265.encoder as j_encoder
import ceracoder_tpu.codec.h265.inter as j_inter
import ceracoder_tpu.codec.h265.intra as j_intra
import ceracoder_tpu.codec.h265.residual as j_residual
import ceracoder_tpu.codec.h265.rowslice as j_rows
import ceracoder_tpu.codec.h265.sao as j_sao
import ceracoder_tpu.codec.h265.tables as j_tables
import ceracoder_tpu_torch.codec.h265.cabac as t_cabac
import ceracoder_tpu_torch.codec.h265.deblock as t_deblock
import ceracoder_tpu_torch.codec.h265.encoder as t_encoder
import ceracoder_tpu_torch.codec.h265.inter as t_inter
import ceracoder_tpu_torch.codec.h265.intra as t_intra
import ceracoder_tpu_torch.codec.h265.residual as t_residual
import ceracoder_tpu_torch.codec.h265.rowslice as t_rows
import ceracoder_tpu_torch.codec.h265.sao as t_sao
import ceracoder_tpu_torch.codec.h265.tables as t_tables
from ceracoder_tpu.codec.h265.ctx_tables import build_slice_contexts as j_ctx
from ceracoder_tpu.codec.h265.syntax import HevcParams as JParams
from ceracoder_tpu_torch.codec.h265.ctx_tables import build_slice_contexts
from ceracoder_tpu_torch.codec.h265.syntax import HevcParams
from tests.test_h265 import TOOLS
from tests.test_h265 import decode as oracle_decode

needs_oracle = pytest.mark.skipif(not (TOOLS / "decode_oracle").exists(),
                                  reason="decode_oracle not built")

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

W, H = 64, 48


def _eq(a, b):
    """Equal nested results: arrays, tuples, lists and dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _panning(n, w=W, h=H, seed=11, flat_patch=False):
    """Noise panning 3 and 5 samples a frame (odd frames with a flat
    patch: CTBs that code intra in P and B frames)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (3 * h, 3 * w)).astype(np.uint8)
    frames = []
    for i in range(n):
        dy, dx = 3 * i - n, 5 * i - n
        y = base[h + dy:2 * h + dy, w + dx:2 * w + dx].copy()
        if flat_patch and i % 2:
            y[16:32, 16:48] = 90 + 10 * i
        u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
        v = (y[1::2, 1::2] // 3 + 80).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _smooth(n, w=W, h=H, seed=3):
    """A smooth moving gradient with mild noise (SAO and intra pay)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (60 + 40 * np.sin((xx + 3 * t) / 9) + yy * 1.5
             + rng.integers(-3, 4, (h, w))).clip(0, 255).astype(np.uint8)
        u = (y[::2, ::2] // 3 + 70).astype(np.uint8)
        v = (140 - y[1::2, 1::2] // 4).astype(np.uint8)
        frames.append((y, u, v))
    return frames


# ---------------------------------------------------------------------------
# tables and the CABAC engine
# ---------------------------------------------------------------------------

_TABLES = sorted(k for k, v in vars(j_tables).items()
                 if isinstance(v, np.ndarray))


@pytest.mark.parametrize("name", _TABLES)
def test_tables_equal(name):
    a, b = getattr(t_tables, name), getattr(j_tables, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_context_equal():
    got = [t_cabac.init_context(v, qp) for v in range(256)
           for qp in range(52)]
    assert got == [j_cabac.init_context(v, qp) for v in range(256)
                   for qp in range(52)]


@pytest.mark.parametrize("seed", range(6))
def test_cabac_engine_bytes(seed):
    """CabacEncoder's bytes equal JAX's on random context, bypass,
    terminate and raw operations (skewed bins carry into buffered
    0xFF runs), and CabacDecoder reads them back."""
    rng = np.random.default_rng(seed)
    ctx0 = np.array([t_cabac.init_context(int(v), int(rng.integers(0, 52)))
                     for v in rng.integers(0, 256, 8)], np.uint8)
    ops = []
    for _ in range(int(rng.integers(1, 2500))):
        k = rng.random()
        kind = ("ctx" if k < 0.6 else "byp" if k < 0.85
                else "bits" if k < 0.95 else "term")
        ops.append((kind, int(rng.integers(0, 8)),
                    int(rng.integers(0, 256)) if kind == "bits"
                    else 0 if kind == "term"
                    else 1 if seed % 2 else int(rng.integers(0, 2))))
    outs = []
    for mod in (t_cabac, j_cabac):
        enc, ctx = mod.CabacEncoder(), ctx0.copy()
        enc.write_raw(0x5A, 8)
        for kind, i, b in ops:
            if kind == "ctx":
                enc.encode_bin(ctx, i, b)
            elif kind == "byp":
                enc.encode_bypass(b)
            elif kind == "bits":
                enc.encode_bypass_bits(b, 8)
            else:
                enc.encode_terminate(0)
        enc.encode_terminate(1)
        enc.finish()
        enc.align_one()
        outs.append((enc.to_bytes(), enc.bit_length))
    assert outs[0] == outs[1]
    dec, ctx = t_cabac.CabacDecoder(outs[0][0][1:]), ctx0.copy()
    for kind, i, b in ops:
        got = (dec.decode_bin(ctx, i) if kind == "ctx"
               else dec.decode_bypass() if kind == "byp"
               else dec.decode_bypass_bits(8) if kind == "bits"
               else dec.decode_terminate())
        assert got == b
    assert dec.decode_terminate() == 1


# ---------------------------------------------------------------------------
# intra prediction, transforms and quantisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", range(35))
def test_intra_predict_all_modes(mode):
    """Each of the 35 modes, luma and chroma, 4x4 to 32x32, on random
    references (smoothing, boundary filters, angular ladders). The host
    predictor covers planar, DC and angular 2-10 and 26 (the encoders'
    candidates); for the other modes both raise."""
    rng = np.random.default_rng(mode)
    for n in (4, 8, 16, 32):
        for c_idx in (0, 1):
            left = rng.integers(0, 256, 2 * n).astype(np.int32)
            top = rng.integers(0, 256, 2 * n).astype(np.int32)
            corner = int(rng.integers(0, 256))
            args = (mode, left, top, corner, n, c_idx)
            if mode <= 10 or mode == 26:
                _eq(t_intra.predict(*args), j_intra.predict(*args))
            else:
                for m in (t_intra, j_intra):
                    with pytest.raises(ValueError, match="unsupported"):
                        m.predict(*args)
    assert set(t_intra.CAND_MODES) <= set(range(11)) | {26}


@pytest.mark.parametrize("seed", range(4))
def test_intra_reference_samples(seed):
    """ref_samples' substitution at the picture's edges and inside, with
    and without the top-right, and smooth_refs."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (64, 96)).astype(np.int32)
    for n in (4, 8, 16):
        for x0, y0 in ((0, 0), (0, 16), (16, 0), (32, 32), (96 - n, 16)):
            for tr in (False, True):
                got = t_intra.ref_samples(rec, x0, y0, n, tr)
                _eq(got, j_intra.ref_samples(rec, x0, y0, n, tr))
                _eq(t_intra.smooth_refs(*got), j_intra.smooth_refs(*got))


@pytest.mark.parametrize("n", [4, 8, 16])
def test_transforms_and_quantisers_at_extremes(n):
    """The forward and inverse transforms (the 16-bit intermediate clip)
    and the quantisers (qp 0 and 51, intra and inter rounding) on
    random, all-±255 and alternating residuals and ±32767 levels."""
    rng = np.random.default_rng(n)
    res = [rng.integers(-255, 256, (n, n)), np.full((n, n), 255),
           np.full((n, n), -255), 255 * (-1) ** np.add.outer(
               np.arange(n), np.arange(n))]
    for r in res:
        c = t_intra.fwd_transform(r)
        _eq(c, j_intra.fwd_transform(r))
        for qp in (0, 1, 26, 50, 51):
            for intra in (True, False):
                lv = t_intra.quantize(c, qp, intra=intra)
                _eq(lv, j_intra.quantize(c, qp, intra=intra))
                _eq(t_intra.dequantize(lv, qp), j_intra.dequantize(lv, qp))
    for lv in (np.full((n, n), 32767), np.full((n, n), -32768),
               rng.integers(-32768, 32768, (n, n))):
        _eq(t_intra.inv_transform(lv), j_intra.inv_transform(lv))
        for qp in (0, 51):
            _eq(t_intra.dequantize(lv, qp), j_intra.dequantize(lv, qp))


# ---------------------------------------------------------------------------
# residual coding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("c_idx", [0, 1])
def test_encode_residual(n, c_idx):
    """Random sparse and dense TUs (large levels: the Rice escape)
    through encode_residual, into I and P slice contexts."""
    outs = []
    for mod, cabac, ctxf in ((t_residual, t_cabac, build_slice_contexts),
                             (j_residual, j_cabac, j_ctx)):
        r = np.random.default_rng(n * 2 + c_idx)
        enc = cabac.CabacEncoder()
        for init_type in (0, 1):
            ctx, off = ctxf(int(r.integers(0, 52)), init_type)
            for dens in (0.02, 0.2, 0.9):
                lv = r.integers(-40, 41, (n, n))
                lv[r.random((n, n)) > dens] = 0
                lv[int(r.integers(0, n)), int(r.integers(0, n))] = int(
                    r.integers(200, 3000))
                mod.encode_residual(enc, ctx, off, lv, c_idx)
        enc.finish()
        enc.align_one()
        outs.append(enc.to_bytes())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# inter search, motion compensation, deblocking, SAO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_inter_search_and_mc(seed):
    """Full-pel search, the qpel and 14-bit planes, sub-pel refine, frame
    and block MC (luma and chroma, uni and bi), SATD."""
    cur, ref = (f for f in _panning(2, seed=seed)[::-1])
    ry, ru, rv = (p.astype(np.int32) for p in ref)
    y = cur[0].astype(np.int32)
    out = {}
    for tag, m in (("t", t_inter), ("j", j_inter)):
        full = m.motion_search(y, ry)
        planes = m.luma_qpel_planes(ry)
        q = m.refine_subpel(y, planes, full)
        p14 = m.luma_qpel_planes14(ry)
        q14 = m.refine_subpel(y, m.uni_from_14(p14), full)
        mv = (q + np.random.default_rng(seed).integers(-3, 4, q.shape)
              ).clip(-32, 32)
        out[tag] = (
            full, planes, q, p14, q14,
            m.mc_luma_qpel(planes, mv, H, W),
            m.mc_chroma_qpel(ru, mv, H // 2, W // 2),
            m.bi_combine_frame(m.mc_luma_qpel14(p14, q, H, W),
                               m.mc_luma_qpel14(p14, mv, H, W)),
            m.bi_combine_frame(m.mc_chroma_qpel14(ru, q, H // 2, W // 2),
                               m.mc_chroma_qpel14(rv, mv, H // 2, W // 2)),
            m.satd8_frame(y - ry), m.satd8_block(y[:16, :16] - ry[:16, :16]),
            [m.mc_luma_block(ry, 16, 16, 16, (4 * a, -4 * a))
             for a in (-9, 0, 3)],
            [m.mc_chroma_block(ru, 8, 8, 8, (4 * a, -4 * a))
             for a in range(-5, 6)],
            [m.bi_combine(m.mc_luma_block14(ry, 0, 16, 16, (4 * a, 0)),
                          m.mc_chroma_block14(ru, 0, 0, 16,
                                              (4 * a, 4 * (3 - a))))
             for a in range(-3, 4)])
    _eq(out["t"], out["j"])


def test_motion_field_and_mvd():
    """AMVP and merge candidate lists of a random motion field, and the
    MVD binarization's bytes."""
    rng = np.random.default_rng(5)
    inter, mv = rng.random((4, 6)) < 0.7, rng.integers(-40, 41, (4, 6, 2))
    fields = []
    for m in (t_inter, j_inter):
        f = m.MotionField(4, 6)
        f.inter[:], f.mv[:] = inter, mv
        fields.append([(f.amvp_list(cy, cx), f.merge_list(cy, cx))
                       for cy in range(4) for cx in range(6)])
    assert fields[0] == fields[1]
    outs = []
    for m, cabac, ctxf in ((t_inter, t_cabac, build_slice_contexts),
                           (j_inter, j_cabac, j_ctx)):
        enc = cabac.CabacEncoder()
        ctx, off = ctxf(30, 1)
        for a in range(-300, 301, 7):
            m.encode_mvd(enc, ctx, off, a, -a // 3)
        enc.finish()
        enc.align_one()
        outs.append(enc.to_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["intra", "p", "p_split", "b"])
def test_deblock_frame(case):
    rng = np.random.default_rng(len(case))
    nch, ncw = H // 16, W // 16
    rec = (rng.integers(40, 200, (H, W)), rng.integers(40, 200, (H // 2,
                                                                  W // 2)),
           rng.integers(40, 200, (H // 2, W // 2)))
    is_intra = (np.ones((nch, ncw), bool) if case == "intra"
                else rng.random((nch, ncw)) < 0.3)
    luma_lv = rng.integers(-2, 3, (nch, ncw, 16, 16))
    luma_lv[rng.random((nch, ncw)) < 0.5] = 0
    cbf = luma_lv.reshape(nch, ncw, -1).any(-1)
    mv = rng.integers(-8, 9, (nch, ncw, 2))
    kw = {}
    if case == "b":
        kw["mv1"] = rng.integers(-8, 9, (nch, ncw, 2))
    if case == "p_split":
        kw.update(tu_split=rng.random((nch, ncw)) < 0.5, luma_lv=luma_lv)
    for qp in (22, 37, 51):
        _eq(t_deblock.deblock_frame(*rec, is_intra, cbf, mv, qp, **kw),
            j_deblock.deblock_frame(*rec, is_intra, cbf, mv, qp, **kw))
    _eq(t_deblock.edge_bs(is_intra, cbf, mv, kw.get("mv1")),
        j_deblock.edge_bs(is_intra, cbf, mv, kw.get("mv1")))


@pytest.mark.parametrize("qp", [12, 22, 32, 42])
def test_sao_estimate_and_apply(qp):
    rng = np.random.default_rng(qp)
    src = _smooth(1, seed=qp)[0]
    rec = tuple((p.astype(np.int32) + rng.integers(-6, 7, p.shape)).clip(
        0, 255) for p in src)
    params = t_sao.sao_estimate(src, rec, qp)
    _eq(params, j_sao.sao_estimate(src, rec, qp))
    _eq(t_sao.sao_apply(rec, params), j_sao.sao_apply(rec, params))
    if qp <= 22:
        assert params[..., 0].any()


# ---------------------------------------------------------------------------
# the encoders of encoder.py
# ---------------------------------------------------------------------------

def _stream(enc, frames, push=False, **kw):
    out = enc.headers()
    for f in frames:
        if push:
            out += b"".join(r[0] for r in enc.push_frame(*f, **kw))
        else:
            r = enc.encode_frame(*f, **kw)
            out += r if isinstance(r, bytes) else (
                r[0] if isinstance(r, tuple) else r.data)
    if push:
        out += b"".join(r[0] for r in enc.flush())
    return out


@pytest.mark.parametrize("name,kw,push", [
    ("H265PcmEncoder", {}, False),
    ("H265IntraEncoder", {"qp": 30}, False),
    ("H265GopEncoder", {"qp": 30, "gop": 3}, False),
    ("H265GopEncoder", {"qp": 34, "gop": 8, "bframes": 1}, True),
    ("H265AppEncoder", {"qp": 28, "gop": 2}, False),
])
def test_encoder_py_bytes(name, kw, push):
    frames = _panning(3, w=48, h=32, flat_patch=True)
    mine = _stream(getattr(t_encoder, name)(48, 32, **kw), frames, push)
    assert mine == _stream(getattr(j_encoder, name)(48, 32, **kw), frames,
                           push)


@needs_oracle
def test_pcm_stream_decodes_losslessly(tmp_path):
    frames = _panning(2, w=40, h=24)
    enc = t_encoder.H265PcmEncoder(40, 24)
    path = tmp_path / "pcm.265"
    path.write_bytes(enc.headers() + b"".join(enc.encode_frame(*f)
                                              for f in frames))
    for got, want in zip(oracle_decode(path, 40, 24, 2), frames):
        _eq(got, want)


# ---------------------------------------------------------------------------
# rowslice.py: the numpy spec, the Python entropy stage, H265RowEncoder
# ---------------------------------------------------------------------------

def _padded(f):
    return tuple(p.astype(np.int32) for p in f)


@pytest.mark.parametrize("tu_split", [False, True])
def test_compute_rows(tu_split):
    """compute_intra_rows, compute_p_rows and compute_b_rows: every
    array and reconstruction equal to JAX's."""
    f0, f1, f2 = (_padded(f) for f in _panning(3, flat_patch=True))
    qp, qpc = 30, t_intra.chroma_qp(30)
    res = {}
    for tag, m in (("t", t_rows), ("j", j_rows)):
        a0, r0 = m.compute_intra_rows(*f0, qp, qpc)
        a2, r2 = m.compute_p_rows(*f2, r0, qp, qpc, tu_split=tu_split)
        a1, r1 = m.compute_b_rows(*f1, r0, r2, qp, qpc, tu_split=tu_split)
        res[tag] = (a0, r0, a2, r2, a1, r1)
    _eq(res["t"], res["j"])
    a2, a1 = res["t"][2], res["t"][4]
    assert a2["is_intra"].any() or a1["is_intra"].any()
    assert (a1["mv1"] != a1["mv"]).any()


def _entropy_arrays(rng, kind, nch, ncw, sao, split):
    a = {"is_intra": (np.ones((nch, ncw), bool) if kind == "I"
                      else rng.random((nch, ncw)) < 0.25),
         "mode": rng.integers(0, 35, (nch, ncw)).astype(np.int32),
         "mv": rng.integers(-20, 21, (nch, ncw, 2)).astype(np.int32)}
    if kind != "I":
        a["mv"][rng.random((nch, ncw)) < 0.3] = 0
    for k, n in (("luma_lv", 16), ("cb_lv", 8), ("cr_lv", 8)):
        lv = rng.integers(-6, 7, (nch, ncw, n, n))
        lv[rng.random((nch, ncw, n, n)) < 0.8] = 0
        lv[rng.random((nch, ncw)) < 0.3] = 0
        a[k] = lv.astype(np.int32)
    if kind == "B":
        a["mv1"] = rng.integers(-20, 21, (nch, ncw, 2)).astype(np.int32)
    if sao:
        s = np.zeros((nch, ncw, 3, 6), np.int32)
        s[..., 0] = rng.integers(0, 3, (nch, ncw, 3))
        s[..., 1] = rng.integers(0, 4, (nch, ncw, 3))
        s[..., 2:] = rng.integers(-7, 8, (nch, ncw, 3, 4))
        s[..., 2, :2] = s[..., 1, :2]       # chroma shares type and class
        a["sao"] = s
    if split:
        a["tu_split"] = rng.random((nch, ncw)) < 0.5
    return a


@pytest.mark.parametrize("kind", ["I", "P", "B"])
@pytest.mark.parametrize("nch,sao,split", [(3, False, False),
                                           (1, False, False),
                                           (3, True, True),
                                           (1, True, True)])
def test_entropy_rows(kind, nch, sao, split):
    """The Python entropy stage equals JAX's and the port's native stage
    (tile rows, a one-row picture's plain slice, one slice segment per
    row, SAO parameters, TU split flags)."""
    rng = np.random.default_rng("IPB".index(kind) * 8 + nch * 4 + sao * 2
                                + split)
    ncw = 4
    arrays = _entropy_arrays(rng, kind, nch, ncw, sao, split)
    pk = dict(deblock=True, tile_rows=True, sao=sao, tu_split_inter=split,
              max_reorder=1, max_dpb_minus1=2)
    p = HevcParams(16 * ncw, 16 * nch, qp=31, **pk)
    jp = JParams(16 * ncw, 16 * nch, qp=31, pcm_enabled=False, **pk)
    kw = dict(idr=kind == "I", poc=0 if kind == "I" else 3,
              ref_poc_delta=2 if kind == "P" else 1,
              slice_type="B" if kind == "B" else None)
    mine = t_rows.entropy_rows(p, arrays, 31, **kw)
    assert mine == j_rows.entropy_rows(jp, arrays, 31, **kw)
    assert mine == t_rows.entropy_rows_native(p, arrays, 31, **kw)
    assert len(mine) == 1
    if nch > 1:     # one slice segment per CTB row
        p.tile_rows = jp.tile_rows = False
        rows = t_rows.entropy_rows(p, arrays, 31, **kw)
        assert rows == j_rows.entropy_rows(jp, arrays, 31, **kw)
        assert rows == t_rows.entropy_rows_native(p, arrays, 31, **kw)
        assert len(rows) == nch


_ROW_CASES = {
    "plain": {},
    "no_deblock": {"deblock": False},
    "sao": {"sao": True},
    "tu_split": {"tu_split": True},
    "bframes": {"bframes": 1},
    "all": {"bframes": 1, "sao": True, "tu_split": True},
}


@pytest.mark.parametrize("case", sorted(_ROW_CASES))
def test_row_encoder_bytes(case):
    """H265RowEncoder with the Python and with the native entropy stage:
    every frame's NAL bytes and reconstruction equal JAX's (its Python
    stage), through an IDR, P (B) frames and a second GOP."""
    kw = _ROW_CASES[case]
    frames = (_smooth(4) if kw.get("sao") and not kw.get("tu_split")
              else _panning(4, flat_patch=True))
    outs = []
    for cls, native in ((j_rows.H265RowEncoder, False),
                        (t_rows.H265RowEncoder, False),
                        (t_rows.H265RowEncoder, True)):
        enc = cls(W, H, qp=30, gop=3, native_entropy=native, **kw)
        out = [enc.headers()]
        for f in frames:
            out += [(d, poc, kind, rec) for d, poc, kind, rec in
                    enc.push_frame(*f)]
        out += enc.flush()
        outs.append(out)
    _eq(outs[1], outs[0])
    _eq(outs[2], outs[0])
    kinds = "".join(k for _, _, k, _ in outs[0][1:])
    assert kinds == ("IPBI" if kw.get("bframes") else "IPPI")


@needs_oracle
def test_row_encoder_decodes_to_its_recon(tmp_path):
    """The port's row encoder stream (B frames, SAO, TU split) decodes
    through tools/decode_oracle to its own reconstructions."""
    enc = t_rows.H265RowEncoder(W, H, qp=30, gop=8, native_entropy=False,
                                bframes=1, sao=True, tu_split=True)
    data, recons = enc.headers(), {}
    for f in _panning(4, flat_patch=True):
        for d, poc, _, rec in enc.push_frame(*f):
            data, recons[poc] = data + d, rec
    for d, poc, _, rec in enc.flush():
        data, recons[poc] = data + d, rec
    path = tmp_path / "rows.265"
    path.write_bytes(data)
    for i, got in enumerate(oracle_decode(path, W, H, 4)):
        _eq(got, recons[i])


