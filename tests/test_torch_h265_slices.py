"""The port's HEVC parameters and its one-slice-per-CTB-row mode
(`tile_rows=False`), against the JAX package on the CPU, exact:

- `HevcParams` has JAX's fields and defaults: the VPS, SPS, PPS and
  slice segment headers of the same parameters are the same bytes
  (slice segment addresses and forward POC deltas included);
- in slice mode the Python and the native entropy stage code each CTB
  row as its own slice segment, as JAX's entropy_rows does;
- H265RowEncoder(tile_rows=False) codes JAX's bytes over I, P and B,
  with and without the deblock and SAO, and tools/decode_oracle decodes
  them to the port's reconstructions;
- the device encoder's rows, coded in slice mode, are JAX's
  H265RowEncoder(tile_rows=False) bytes.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import ceracoder_tpu.codec.h265.rowslice as j_rows
import ceracoder_tpu.codec.h265.syntax as js
import ceracoder_tpu_torch.codec.h265.rowslice as t_rows
import ceracoder_tpu_torch.codec.h265.syntax as ts
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from tests.test_h265 import TOOLS
from tests.test_h265 import decode as oracle_decode
from tests.test_torch_h265_reference import _entropy_arrays, _panning, _smooth

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

W, H = 96, 64

# each field the port once set apart from JAX's default, and the
# operating points of the encoders
_FIELDS = {
    "default": {},
    "no_pcm": {"pcm_enabled": False},
    "pcm_8_16": {"log2_min_pcm": 3, "log2_max_pcm": 4},
    "fps": {"fps_num": 30, "fps_den": 1},
    "deblock": {"deblock": True},
    "tile_rows": {"tile_rows": True},
    "device": {"pcm_enabled": False, "deblock": True, "tile_rows": True},
    "sao_b": {"pcm_enabled": False, "sao": True, "max_reorder": 1,
              "max_dpb_minus1": 2, "tu_split_inter": True},
}


@pytest.mark.parametrize("w,h", [(96, 64), (90, 60), (96, 16)])
@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_parameter_sets_and_headers_match_jax(field, w, h):
    """VPS, SPS, PPS and slice segment headers (I, P, B; the picture's
    first slice and later rows' slices; forward POC deltas; entry
    points) of the same HevcParams in both packages."""
    kw = _FIELDS[field]
    p, jp = ts.HevcParams(w, h, **kw), js.HevcParams(w, h, **kw)
    assert p == ts.HevcParams(**vars(jp))
    for name in ("write_vps", "write_sps", "write_pps"):
        assert getattr(ts, name)(p) == getattr(js, name)(jp), name
    nch, ncw = p.pic_height_ctbs, p.pic_width_ctbs
    heads = [dict(), dict(idr=False, poc=3, ref_poc_delta=2),
             dict(idr=False, poc=5, slice_type="B", fwd_poc_delta=3)]
    for hk in heads:
        for addr in sorted({0, ncw * (nch // 2), ncw * (nch - 1)}):
            for sizes in (None, [37, 300]):
                a = ts.slice_header_bits(p, qp=31, ctb_addr=addr,
                                         tile_sizes=sizes, **hk)
                b = js.slice_header_bits(jp, qp=31, ctb_addr=addr,
                                         tile_sizes=sizes, **hk)
                assert a.to_bytes() == b.to_bytes(), (hk, addr, sizes)


@pytest.mark.parametrize("tiles", [False, True])
@pytest.mark.parametrize("kind", ["I", "P", "B"])
@pytest.mark.parametrize("sao,split", [(False, False), (True, True)])
def test_entropy_rows_slice_mode(kind, sao, split, tiles):
    """The Python entropy stage equals JAX's, and the native one equals
    both: one slice segment per CTB row (tile_rows=False) or one tile
    per row, with a B frame's forward POC delta."""
    rng = np.random.default_rng("IPB".index(kind) * 8 + sao * 4
                                + split * 2 + tiles)
    nch, ncw = 3, 4
    arrays = _entropy_arrays(rng, kind, nch, ncw, sao, split)
    pk = dict(pcm_enabled=False, deblock=True, tile_rows=tiles, sao=sao,
              tu_split_inter=split, max_reorder=1, max_dpb_minus1=2)
    p = ts.HevcParams(16 * ncw, 16 * nch, qp=31, **pk)
    jp = js.HevcParams(16 * ncw, 16 * nch, qp=31, **pk)
    kw = dict(idr=kind == "I", poc=0 if kind == "I" else 3,
              ref_poc_delta=2 if kind == "P" else 1,
              slice_type="B" if kind == "B" else None,
              fwd_poc_delta=3 if kind == "B" else 1)
    mine = t_rows.entropy_rows(p, arrays, 31, **kw)
    assert mine == j_rows.entropy_rows(jp, arrays, 31, **kw)
    assert mine == t_rows.entropy_rows_native(p, arrays, 31, **kw)
    assert len(mine) == (1 if tiles else nch)


def _row_stream(cls, frames, **kw):
    """(data, poc, kind, recon) of every frame through push_frame and
    flush, after the parameter sets."""
    enc = cls(W, H, qp=30, gop=3, **kw)
    out = [enc.headers()]
    for f in frames:
        out += list(enc.push_frame(*f))
    return out + list(enc.flush())


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, bytes):
            assert x == y
            continue
        assert x[:3] == y[:3]
        for p, q in zip(x[3], y[3]):
            assert np.array_equal(np.asarray(p), np.asarray(q))


def _oracle_check(path, ref, frames):
    """tools/decode_oracle decodes the stream at `path` to the
    reconstructions `frames` (coding order; `ref` the JAX stream that
    gives each frame's POC and kind)."""
    if not (TOOLS / "decode_oracle").exists():
        return
    # display order: a GOP's frames by POC
    n = len(frames)
    gop_of = np.cumsum([k == "I" for _, _, k, _ in ref[1:]])
    order = sorted(range(n), key=lambda i: (gop_of[i], ref[1 + i][1]))
    for got, i in zip(oracle_decode(path, W, H, n), order):
        for p, q in zip(got, frames[i]):
            q = np.asarray(q)
            assert np.array_equal(p, q[:p.shape[0], :p.shape[1]])


# the row encoder's options in slice mode; SAO pays on the smooth clip
_ROW = {
    "plain": {"bframes": 1},
    "all": {"bframes": 1, "sao": True, "tu_split": True, "deblock": False},
    "p_only": {},
    "no_deblock": {"deblock": False},
    "no_deblock_sao": {"deblock": False, "sao": True},
}


@pytest.mark.parametrize("case", sorted(_ROW))
def test_row_encoder_slice_mode(case, tmp_path):
    """H265RowEncoder(tile_rows=False) with the Python and the native
    entropy stage: every NAL unit and reconstruction equal to JAX's over
    an IDR, P (and B) frames and a second GOP; one slice NAL per CTB
    row; the oracle decodes the port's stream to its reconstructions."""
    kw = _ROW[case]
    frames = (_smooth(4, W, H) if kw.get("sao")
              else _panning(4, W, H, flat_patch=True))
    ref = _row_stream(j_rows.H265RowEncoder, frames, tile_rows=False,
                      native_entropy=False, **kw)
    for native in (False, True):
        mine = _row_stream(t_rows.H265RowEncoder, frames, tile_rows=False,
                           native_entropy=native, **kw)
        _same(mine, ref)
    want = "IPBI" if kw.get("bframes") else "IPPI"
    assert "".join(k for _, _, k, _ in ref[1:]) == want
    assert all(d.count(b"\x00\x00\x01") == H // 16 for d, *_ in ref[1:])
    path = tmp_path / f"{case}.265"
    path.write_bytes(b"".join(x if isinstance(x, bytes) else x[0]
                              for x in mine))
    _oracle_check(path, ref, [x[3] for x in mine[1:]])


def _device_stream(frames, bframes):
    """(headers, [(data, kind, recon)]) in coding order from the port's
    device encoder on the CPU with one slice segment per CTB row:
    encode_run_async, or encode_run_b_async with B frames, in two runs.
    The encoder takes no slice-mode option; its entropy stage follows
    its `params`, so tile_rows is turned off there."""
    enc = H265DeviceEncoder(W, H, qp=30, gop=3, device="cpu",
                            bframes=bframes, tu_split=bool(bframes))
    enc.params = replace(enc.params, tile_rows=False)
    out = []
    for run in (frames[:3], frames[3:]):
        if enc.bframes:
            coded = [(p.result(), kind)
                     for p, _, kind in enc.encode_run_b_async(run)]
        else:
            coded = [(p.result(), None) for p in enc.encode_run_async(run)]
        out += [(f.data, kind or "IP"[not f.keyframe], f.recon)
                for f, kind in coded]
    return enc.headers(), out


@pytest.mark.parametrize("bframes", [0, 1])
def test_device_rows_in_slice_mode_match_jax(bframes, tmp_path):
    """The device encoder's rows coded one slice segment per CTB row:
    the bytes and reconstructions of JAX's H265RowEncoder(tile_rows=
    False) frame for frame; the oracle decodes them to the port's
    reconstructions."""
    frames = _panning(4, W, H)
    headers, mine = _device_stream(frames, bframes)
    ref = _row_stream(j_rows.H265RowEncoder, frames, native_entropy=False,
                      tile_rows=False, bframes=bframes,
                      tu_split=bool(bframes))
    assert headers == ref[0] and len(mine) == len(ref) - 1 == 4
    for (d, kind, rec), (rd, _, rkind, rrec) in zip(mine, ref[1:]):
        assert (d, kind) == (rd, rkind)
        for p, q in zip(rec, rrec):
            assert np.array_equal(p[:q.shape[0], :q.shape[1]], q)
    assert [d.count(b"\x00\x00\x01") for d, _, _ in mine] == [H // 16] * 4
    path = tmp_path / "device.265"
    path.write_bytes(headers + b"".join(d for d, _, _ in mine))
    _oracle_check(path, ref, [r for _, _, r in mine])
