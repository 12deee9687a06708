"""The port's inter TU split and B frames (ceracoder_tpu_torch: ops/h265.py,
codec/h265/) against the JAX package on the CPU: the ops exactly, on
the same seeded numpy inputs; the B and TU-split P frame cores against
the JAX jits; the packed B row, the B and TU-split slices' entropy and
the parameter sets; and the whole slice, the push_frame/flush stream of
H265DeviceEncoder(bframes=1, tu_split=True), byte for byte against the
JAX encoder's. Cheaper references hold the rest: the numpy
H265RowEncoder, the port's own push path for encode_run_b_async, and
the libavcodec oracle (tools/decode_oracle).

One frame size (112x64), so that the JAX module-level jits
(encode_frame_i_rows, encode_frame_p_rows(tu_split=True),
encode_frame_b_rows(tu_split=True), deblock_frame_jit) compile once per
worker; never the JAX fused scans (encode_run_pairs, encode_run_rows),
which take minutes to compile on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceracoder_tpu.ops.h265 as J
import ceracoder_tpu_torch.ops.h265 as T
from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEncoder
from ceracoder_tpu.codec.h265.rowslice import H265RowEncoder
from ceracoder_tpu.codec.h265.rowslice import entropy_rows_native as j_entropy
from ceracoder_tpu.codec.h265.syntax import HevcParams as JParams
from ceracoder_tpu.codec.h265.tables import T4, T8, T16
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h265 import device as t_device
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.codec.h265.rowslice import entropy_rows_native
from ceracoder_tpu_torch.codec.h265.syntax import HevcParams
from ceracoder_tpu_torch.ops.h265 import LEVEL_CHUNK
from tests.test_h265_rows import _panning, decode

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 112, 64
NCH, NCW = H // 16, W // 16
QP = 30


def t(a):
    return torch.as_tensor(np.array(a))


def same(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _clip(n):
    """`_panning` frames, with a flat patch in every odd display frame:
    content that neither neighbour holds, so that a B frame there codes
    some CTBs intra."""
    frames = []
    for i, (y, u, v) in enumerate(_panning(n, W, H)):
        y = y.copy()
        if i % 2:
            y[16:48, 32:64] = 40 * i % 256
        frames.append((y, u, v))
    return frames


def _push(enc, frames):
    """Every frame through push_frame, then flush: the coded tuples."""
    coded = []
    for f in frames:
        coded += enc.push_frame(*f)
    return coded + enc.flush()


class EntropySpy:
    """The arrays each frame's entropy call gets in the port's encoder
    (codec/h265/device.py), by slice type."""

    def __init__(self, monkeypatch):
        self.frames = []
        real = t_device.entropy_rows_native

        def spy(p, arrays, qp, idr, *a, slice_type=None, **kw):
            self.frames.append((slice_type or ("I" if idr else "P"),
                                {k: np.array(v) for k, v in arrays.items()}))
            return real(p, arrays, qp, idr, *a, slice_type=slice_type, **kw)
        monkeypatch.setattr(t_device, "entropy_rows_native", spy)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

_j_inter_tus = jax.jit(J._code_inter_tus_dev)
# the small JAX references under jax.jit too: called eagerly, each
# primitive compiles at each shape apart
_j_tb_bits = jax.jit(J._tb_bits_dev)
_j_bi_combine = jax.jit(J._bi_combine)
_j_pack = jax.jit(J._pack_run_streams, static_argnums=(1, 2, 3))


def _inter_tu_inputs(seed: int, r: int = 24):
    """Sources and predictions of r CUs: random, near (small residuals,
    where the single TU tends to win), and one quadrant off (where the
    split does)."""
    rng = np.random.default_rng(seed)

    def plane(n):
        src = rng.integers(0, 256, (r, n, n)).astype(np.int32)
        pred = np.clip(src + rng.integers(-6, 7, src.shape), 0, 255)
        pred[: r // 3] = rng.integers(0, 256, (r // 3, n, n))
        h = n // 2
        pred[r // 3: 2 * r // 3, :h, :h] = rng.integers(
            0, 256, (r // 3, h, h))
        return src, pred.astype(np.int32)
    (sy, py), (su, pu), (sv, pv) = plane(16), plane(8), plane(8)
    return sy, su, sv, py, pu, pv


@pytest.mark.parametrize("qp", [0, 22, 30, 37, 51])
def test_tb_bits_and_inter_tus_match_jax(qp):
    """`_tb_bits_dev` and `_code_inter_tus_dev` against the JAX twins:
    both options' levels, reconstructions and the split choice, which
    goes both ways on these inputs."""
    ins = _inter_tu_inputs(qp)
    qp_c = min(qp, 51)
    lam = J.SAO_LAMBDA[qp]
    got = T._code_inter_tus_dev(*(t(a) for a in ins), qp, qp_c, lam)
    want = _j_inter_tus(*(jnp.asarray(a) for a in ins), qp, qp_c, lam,
                        *(jnp.asarray(m, jnp.int32) for m in (T16, T8, T4)))
    for a, b in zip(got, want):
        same(a, b)
    if qp in (22, 30):
        assert 0 < int(got[0].sum()) < len(got[0])
    rng = np.random.default_rng(qp + 1)
    lv = rng.integers(-20, 21, (40, 8, 8))
    lv[rng.random(lv.shape) < 0.7] = 0
    lv[0] = 0
    same(T._tb_bits_dev(t(lv)), _j_tb_bits(jnp.asarray(lv)))
    same(T._unquads(T._quads(t(lv[:4]))), lv[:4])


def test_inter_tus_tie_keeps_the_single_tu():
    """Equal costs keep the single TU: with lambda 0 and a prediction
    equal to the source both options cost 0, and no CU splits."""
    sy, su, sv, *_ = _inter_tu_inputs(5)
    ins = (sy, su, sv, sy, su, sv)
    got = T._code_inter_tus_dev(*(t(a) for a in ins), QP, 29, 0)
    want = _j_inter_tus(*(jnp.asarray(a) for a in ins), QP, 29, 0,
                        *(jnp.asarray(m, jnp.int32) for m in (T16, T8, T4)))
    assert not got[0].any()
    for a, b in zip(got, want):
        same(a, b)


def test_bi_combine_at_the_extremes():
    """The combine of two 14-bit predictions, int16 as they may arrive,
    up to the sum of +-61,710 that would wrap in int16."""
    ext = np.array([-30855, -8192, -64, -1, 0, 1, 63, 64, 8191, 16320,
                    30855], np.int16)
    a, b = np.meshgrid(ext, ext)
    same(T._bi_combine(t(a), t(b)), _j_bi_combine(jnp.asarray(a),
                                                  jnp.asarray(b)))
    same(T._bi_combine(t(a.astype(np.int32)), t(b.astype(np.int32))),
         _j_bi_combine(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)))


@pytest.mark.parametrize("qp", [24, 32, 40])
def test_deblock_with_mv1_and_split_map(qp):
    """The deblock of a B frame (list-1 MVs in the boundary strength)
    with a real TU split map, against the JAX jit."""
    rng = np.random.default_rng(qp)
    rec = (rng.integers(60, 200, (H, W)).astype(np.uint8),
           rng.integers(60, 200, (H // 2, W // 2)).astype(np.uint8),
           rng.integers(60, 200, (H // 2, W // 2)).astype(np.uint8))
    is_intra = rng.random((NCH, NCW)) < 0.15
    lv = rng.integers(-2, 3, (NCH, NCW, 16, 16)).astype(np.int32)
    lv[rng.random(lv.shape) < 0.97] = 0
    lv[rng.random((NCH, NCW)) < 0.6] = 0          # CUs without levels
    cbf = lv.reshape(NCH, NCW, -1).any(-1)
    # list 0 nearly still, list 1 moving on some CUs
    mv = rng.integers(-2, 3, (NCH, NCW, 2)).astype(np.int32)
    mv1 = np.where(rng.random((NCH, NCW, 1)) < 0.5, mv,
                   rng.integers(-9, 10, (NCH, NCW, 2))).astype(np.int32)
    split = (rng.random((NCH, NCW)) < 0.5) & ~is_intra
    got = T.deblock_frame_dev(*(t(a) for a in rec), t(is_intra), t(cbf),
                              t(mv), qp, mv1=t(mv1), tu_split=t(split),
                              luma_lv=t(lv))
    want = J.deblock_frame_jit(*rec, is_intra, cbf, mv, qp, mv1,
                               tu_split=split, luma_lv=lv)
    for a, b in zip(got, want):
        same(a, b)
    # list 1 alone sets bS 1 where list 0 agrees
    bs_v, _ = T._edge_bs_dev(t(is_intra), t(cbf), t(mv), t(mv1))
    bs_v0, _ = T._edge_bs_dev(t(is_intra), t(cbf), t(mv))
    assert (bs_v > bs_v0).any()


@pytest.fixture(scope="module")
def cores():
    """The port's and the JAX jits' P (TU split) and B frame cores on
    frames 0-2 of the clip: P frame 2 against frame 0, B frame 1 between
    frames 0 and 2."""
    f = _clip(3)
    past, b, fut = f
    return {
        "p": (T._p_frame_core(*(t(a) for a in fut), *(t(a) for a in past),
                              QP, 29, tu_split=True),
              J.encode_frame_p_rows(*fut, *past, QP, 29, tu_split=True)),
        "b": (T._b_frame_core(*(t(a) for a in b),
                              tuple(t(a) for a in past),
                              tuple(t(a) for a in fut), QP, 29,
                              tu_split=True),
              J.encode_frame_b_rows(*b, *past, *fut, QP, 29,
                                    tu_split=True)),
    }


@pytest.mark.parametrize("kind", ["p", "b"])
def test_frame_cores_match_jax_jits(cores, kind):
    got, want = cores[kind]
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "recon":
            for a, b in zip(got[k], want[k]):
                same(a, b)
        else:
            same(got[k], want[k])
    assert got["tu_split"].any() and not got["tu_split"].all()
    if kind == "b":
        assert got["is_intra"].any()
        assert (got["mv1"] != got["mv"]).any()


@pytest.mark.parametrize("n_ctb,chunk", [(28, 6144), (8160, 6144),
                                         (33, 1024)])
def test_packed_b_row_matches_jax_layout(n_ctb, chunk):
    """A B frame's packed row carries mv1 after mv, in the JAX layout;
    P and IDR rows keep theirs."""
    for with_mv1 in (False, True):
        assert T.run_pack_layout(n_ctb, chunk, with_mv1=with_mv1) == \
            J.run_pack_layout(n_ctb, with_mv1=with_mv1, chunk=chunk)
    rng = np.random.default_rng(n_ctb)
    nch, ncw = 1, n_ctb
    shape = (1, nch, ncw)
    meta = {"is_intra": rng.random(shape) < 0.3,
            "tu_split": rng.random(shape) < 0.3,
            "mode": rng.integers(0, 35, shape).astype(np.int32),
            "mv": rng.integers(-35, 36, shape + (2,)).astype(np.int32),
            "mv1": rng.integers(-35, 36, shape + (2,)).astype(np.int32)}
    cap = chunk + 512
    pos = rng.integers(0, 384, (1, cap)).astype(np.int16)
    val = rng.integers(-300, 300, (1, cap)).astype(np.int16)
    counts = rng.integers(0, 30, shape + (3,)).astype(np.int32)
    nnz = np.array([cap - 7], np.int32)
    port = T._pack_run_streams(
        {**{k: t(a) for k, a in meta.items()}, "pos": t(pos), "val": t(val),
         "counts": t(counts), "nnz": t(nnz)}, 1, chunk)
    jd = {k: jnp.asarray(a) for k, a in meta.items()}
    for k in ("mode", "mv", "mv1"):
        jd[k] = jd[k].astype(jnp.int8)
    jd.update(pos=jnp.asarray(pos), val=jnp.asarray(val),
              counts=jnp.asarray(counts, jnp.uint16), nnz=jnp.asarray(nnz))
    jax_rows = _j_pack(jd, 1, True, chunk)
    same(port["packed"], jax_rows["packed"])
    same(port["lv_rest"], jax_rows["lv_chunks"][0][:, :512])


def _slice_arrays(rng, nch: int, ncw: int) -> dict:
    is_intra = rng.random((nch, ncw)) < 0.2
    lv = [rng.integers(-9, 10, (nch, ncw, n, n)).astype(np.int32)
          for n in (16, 8, 8)]
    for a in lv:
        a[rng.random(a.shape) < 0.85] = 0
    return {"is_intra": is_intra,
            "mode": np.where(is_intra, rng.choice(
                [0, 1, 10, 26, 2, 5, 9], (nch, ncw)), 0).astype(np.int32),
            "mv": rng.integers(-35, 36, (nch, ncw, 2)).astype(np.int32),
            "mv1": rng.integers(-35, 36, (nch, ncw, 2)).astype(np.int32),
            "tu_split": (rng.random((nch, ncw)) < 0.4) & ~is_intra,
            "luma_lv": lv[0], "cb_lv": lv[1], "cr_lv": lv[2]}


@pytest.mark.parametrize("slice_type,nch,tu_split", [
    ("B", 4, True), ("B", 1, True), ("B", 4, False), ("P", 4, True),
    ("P", 1, True)])
def test_entropy_rows_native_matches_jax(slice_type, nch, tu_split):
    """The slice of a B frame and of a TU-split P frame (tile rows, and
    a one-row picture's plain slice), with the P frame of a pair two
    POCs back, against the JAX function."""
    rng = np.random.default_rng(nch * 10 + tu_split)
    arrays = _slice_arrays(rng, nch, NCW)
    kw = dict(qp=31, idr=False, poc=5,
              ref_poc_delta=2 if slice_type == "P" else 1,
              slice_type=slice_type if slice_type == "B" else None)
    p = HevcParams(W, 16 * nch, qp=QP, pcm_enabled=False, deblock=True,
                   max_reorder=1, max_dpb_minus1=2, tile_rows=True,
                   tu_split_inter=tu_split)
    jp = JParams(W, 16 * nch, qp=QP, pcm_enabled=False, deblock=True,
                 max_reorder=1, max_dpb_minus1=2, tile_rows=True,
                 tu_split_inter=tu_split)
    got = entropy_rows_native(p, arrays, **kw)
    assert got == j_entropy(jp, arrays, **kw)
    # the flags and list-1 MVs reach the coder
    flip = dict(arrays, mv1=arrays["mv1"] + 4,
                tu_split=arrays["tu_split"] ^ ~arrays["is_intra"])
    assert (entropy_rows_native(p, flip, **kw) != got) == (
        slice_type == "B" or tu_split)


@pytest.mark.parametrize("bframes,tu_split", [(0, False), (0, True),
                                              (1, False), (1, True)])
@pytest.mark.parametrize("w,h", [(112, 64), (90, 60)])
def test_parameter_sets_match_jax(w, h, bframes, tu_split):
    kw = dict(qp=QP, gop=50, bframes=bframes, tu_split=tu_split)
    assert (H265DeviceEncoder(w, h, device="cpu", **kw).headers()
            == JEncoder(w, h, **kw).headers())


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_push():
    """The JAX encoder's push_frame/flush stream of six frames of the
    clip (I, P, B, P, B and the flushed P), headers first, and each
    coded frame's reconstruction."""
    enc = JEncoder(W, H, qp=QP, gop=50, bframes=1, tu_split=True)
    coded = _push(enc, _clip(6))
    return (enc.headers() + b"".join(c[0] for c in coded),
            [tuple(np.asarray(p) for p in c[3]) for c in coded])


def test_push_stream_matches_jax_and_decodes(jax_push, monkeypatch,
                                             tmp_path):
    """The port's push_frame/flush stream and reconstructions equal the
    JAX encoder's; split and unsplit CTBs in P and B frames, intra CTBs
    in a B frame and list-1 MVs unlike list 0 all occur; the oracle
    decodes the stream to the port's reconstructions in display
    order."""
    spy = EntropySpy(monkeypatch)
    enc = H265DeviceEncoder(W, H, qp=QP, gop=50, bframes=1, tu_split=True,
                            device="cpu")
    coded = _push(enc, _clip(6))
    stream = enc.headers() + b"".join(c[0] for c in coded)
    assert stream == jax_push[0]
    for c, want in zip(coded, jax_push[1]):
        for a, b in zip(c[3], want):
            same(a, b)
    assert [(c[1], c[2]) for c in coded] == [
        (0, "I"), (2, "P"), (1, "B"), (4, "P"), (3, "B"), (5, "P")]
    assert [(c[0][4] >> 1) & 0x3F for c in coded] == [19, 1, 0, 1, 0, 1]
    for kind in ("P", "B"):
        split = np.stack([a["tu_split"] for k, a in spy.frames if k == kind])
        assert split.any() and not split.all(), kind
    bs = [a for k, a in spy.frames if k == "B"]
    assert any(a["is_intra"].any() for a in bs)
    assert any((a["mv1"] != a["mv"]).any() for a in bs)
    assert all(c[3][0].device.type == "cpu" for c in coded)

    path = tmp_path / "b.265"
    path.write_bytes(stream)
    disp = sorted(coded, key=lambda c: c[1])
    for i, dec in enumerate(decode(path, W, H, len(coded))):
        for name, dp, rp in zip("yuv", dec, disp[i][3]):
            hh, ww = dp.shape
            assert np.array_equal(dp, rp.numpy()[:hh, :ww]), (i, name)


def test_push_hints_match_jax():
    """push_frame's hints and per-frame QPs as the JAX encoder takes
    them: a frame refused as B (allow_b=False, a lookahead's erratic
    motion), a held-back candidate flushed as P before a forced IDR, a
    B frame coded at its own QP."""
    frames = _clip(8)
    plans = [(30, False, True), (32, False, True), (29, False, True),
             (30, False, False), (31, False, True), (33, True, True),
             (30, False, True), (28, False, True)]

    def stream(enc):
        coded = []
        for f, (qp, idr, allow_b) in zip(frames, plans):
            coded += enc.push_frame(*f, qp=qp, force_idr=idr,
                                    allow_b=allow_b)
        coded += enc.flush()
        return [(c[0], c[1], c[2]) for c in coded]
    kw = dict(qp=QP, gop=50, bframes=1, tu_split=True)
    got = stream(H265DeviceEncoder(W, H, device="cpu", **kw))
    assert got == stream(JEncoder(W, H, **kw))
    assert [(poc, kind) for _, poc, kind in got] == [
        (0, "I"), (2, "P"), (1, "B"), (3, "P"), (4, "P"), (0, "I"),
        (2, "P"), (1, "B")]


@pytest.mark.parametrize("bframes,tu_split,sao", [
    (1, True, False), (1, False, False), (0, True, False), (1, True, True)])
def test_matches_row_encoder(bframes, tu_split, sao):
    """The numpy H265RowEncoder with the same options codes the same
    bytes (push_frame/flush with B frames, encode_frame without; with
    SAO on every frame, B frames too)."""
    frames = _clip(7)
    kw = dict(qp=QP, gop=50, bframes=bframes, tu_split=tu_split, sao=sao)
    enc = H265DeviceEncoder(W, H, device="cpu", **kw)
    row = H265RowEncoder(W, H, **kw)
    if bframes:
        a = b"".join(c[0] for c in _push(enc, frames))
        b = b"".join(c[0] for c in _push(row, frames))
    else:
        a = b"".join(enc.encode_frame(*f).data for f in frames)
        b = b"".join(row.encode_frame(*f)[0] for f in frames)
    assert a == b


def test_test_pattern_matches_row_encoder():
    """The content of chip_smoke.py's 1080p B cell at a CPU size: the
    device test pattern (texture 6: its band pans 4 and its block 7
    full samples a frame, the block flips between white and black every
    frame, and the noise is drawn anew each frame) at 320x192, IDR and
    first pair, codes the numpy H265RowEncoder's bytes."""
    src = DeviceTestPatternSource(320, 192, texture=6, device="cpu")
    frames = [tuple(p.numpy() for p in src.frame(i)) for i in range(3)]
    kw = dict(qp=QP, gop=60, bframes=1, tu_split=True)
    enc = H265DeviceEncoder(320, 192, device="cpu", **kw)
    row = H265RowEncoder(320, 192, **kw)
    a = _push(enc, frames)
    assert [c[2] for c in a] == ["I", "P", "B"]
    assert [c[0] for c in a] == [c[0] for c in _push(row, frames)]


def test_frame_hook_sees_each_frame_in_coding_order():
    """encode_run_b_async hands each frame's device work to its frame
    hook in coding order, with the frame's references (a P frame the
    carried reference; a B frame that and its P frame's
    reconstruction), and the hooked run codes the plain run's bytes:
    the profiles (chip_smoke.py, profile_hevc.py) see the encoder's own
    schedule."""
    frames = _clip(6)

    def enc():
        return H265DeviceEncoder(W, H, qp=QP, gop=50, bframes=1,
                                 tu_split=True, device="cpu")
    want = [p.result().data for p, _, _ in enc().encode_run_b_async(frames)]
    seen = []

    def hook(kind, run, refs):
        stages = []

        def stage(name, fn):
            stages.append(name)
            return fn()
        out = run(stage)
        seen.append((kind, refs, out["recon"], stages[0]))
        return out
    got = enc().encode_run_b_async(frames, frame_hook=hook)
    assert [p.result().data for p, _, _ in got] == want
    assert [k for k, *_ in seen] == ["I", "P", "B", "P", "B", "P"]
    assert {s for *_, s in seen} == {"source"}
    rec = [r for _, _, r, _ in seen]
    assert seen[0][1] == ()
    for f, refs in ((1, (0,)), (2, (0, 1)), (3, (1,)), (4, (1, 3)),
                    (5, (3,))):
        assert len(seen[f][1]) == len(refs)
        assert all(a is rec[r] for a, r in zip(seen[f][1], refs)), f


@pytest.mark.parametrize("source", [False, True])
def test_b_run_matches_push_path(source, tmp_path):
    """encode_run_b_async over gop 6 and 9 frames (an IDR and an odd
    tail fall inside the run) equals the push path's stream, with host
    frames and with the device source; the oracle decodes it to the
    run's reconstructions."""
    if source:
        src = DeviceTestPatternSource(W, H, texture=4, device="cpu")
        frames = [tuple(p.numpy() for p in src.frame(i)) for i in range(9)]
        run_kw = {"source": src, "indices": range(9)}
    else:
        frames = _clip(9)
        run_kw = {"frames": frames}

    def enc():
        return H265DeviceEncoder(W, H, qp=QP, gop=6, bframes=1,
                                 tu_split=True, device="cpu")
    push = enc()
    want = push.headers() + b"".join(c[0] for c in _push(push, frames))
    run = enc()
    items = [(p.result(), poc, kind)
             for p, poc, kind in run.encode_run_b_async(**run_kw)]
    assert run.headers() + b"".join(f.data for f, _, _ in items) == want
    assert [(poc, kind) for _, poc, kind in items] == [
        (0, "I"), (2, "P"), (1, "B"), (4, "P"), (3, "B"), (5, "P"),
        (0, "I"), (2, "P"), (1, "B")]
    assert run.fallback_frames == 0
    path = tmp_path / "run.265"
    path.write_bytes(want)
    disp = sorted(items[:6], key=lambda x: x[1]) + sorted(
        items[6:], key=lambda x: x[1])
    for i, dec in enumerate(decode(path, W, H, 9)):
        for dp, rp in zip(dec, disp[i][0].recon):
            hh, ww = dp.shape
            assert np.array_equal(dp, rp[:hh, :ww]), i


def test_pair_overflow_codes_dense_levels():
    """Noise at qp 22 with the capacity cut to one chunk: both frames of
    each pair overflow their sparse levels and are coded from the dense
    levels kept on the device, to the push path's bytes."""
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (H, W)).astype(np.uint8),
               rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
               rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))
              for _ in range(5)]

    def enc():
        return H265DeviceEncoder(W, H, qp=22, gop=50, bframes=1,
                                 tu_split=True, device="cpu")
    push = enc()
    want = b"".join(c[0] for c in _push(push, frames))
    assert push.fallback_frames == 0
    run = enc()
    items = run.encode_run_b_async(frames, cap=LEVEL_CHUNK)
    assert [kind for _, _, kind in items] == ["I", "P", "B", "P", "B"]
    assert b"".join(p.result().data for p, _, _ in items) == want
    assert run.fallback_frames == 4        # every P and B of both pairs


def test_low_delay_tu_split_matches_jax_per_frame():
    """encode_run_async with the TU split, runs across an IDR and
    per-frame QPs, equals the JAX encoder's per-frame path."""
    frames = _clip(5)
    qps = [30, 30, 33, 28, 28]
    enc = H265DeviceEncoder(W, H, qp=QP, gop=4, tu_split=True, device="cpu")
    a = enc.headers()
    for run in (range(0, 3), range(3, 5)):
        a += b"".join(p.result().data for p in enc.encode_run_async(
            [frames[i] for i in run], qps=[qps[i] for i in run]))
    jenc = JEncoder(W, H, qp=QP, gop=4, tu_split=True)
    b = jenc.headers() + b"".join(
        jenc.encode_frame(*f, qp=q).data for f, q in zip(frames, qps))
    assert a == b


def test_b_entry_points_refuse_the_low_delay_call():
    enc = H265DeviceEncoder(W, H, bframes=1, device="cpu")
    with pytest.raises(RuntimeError, match="push_frame"):
        enc.encode_frame(*_clip(1)[0])
    with pytest.raises(RuntimeError, match="bframes=1"):
        H265DeviceEncoder(W, H, device="cpu").encode_run_b_async(_clip(2))
