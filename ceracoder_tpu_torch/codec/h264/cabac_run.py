"""H.264 CABAC run path (torch): device compute per frame, the syntax
elements sparse-compacted into one packed transfer row per frame, and
the native CABAC row coder on the host (codec/h264/cabac_assemble.py).

Port of ceracoder_tpu/codec/h264/cabac_run.py. The CABAC row coder is
bit-serial and runs on the host; shipping the dense levels it reads
would cost ~6 MB per 1080p frame, so per frame the device compacts its
nonzero levels (ops/h265.py: compact_slots, shared with the HEVC run
path) and the transfer is one packed row

  nnz | meta | per-MB counts | [mv] | (pos, val) level chunk 0

plus only those further level chunks that the frame's nnz needs.

Per-MB 384-slot level layout (slot = pos within the MB's stream):
  I: [dc_luma 16 | ac_luma snake 16x15 | dc_chroma 2x4 | ac_chroma 2x4x15]
  P: [luma snake 16x16          | dc_chroma 2x4 | ac_chroma 2x4x15]
Luma blocks are stored in coding (snake) order so that the host hands
the dense views straight to the entropy stage. An Intra_16x16 MB in a
P frame stores [dc 16 | ac snake 240] in its 256 luma slots.

Where JAX runs one `lax.scan` per run of P frames, the port runs a
Python loop over the frames that carries the deblocked reference (the
frames are enqueued on the device one after another). The byte layout
of the packed rows is JAX's; multi-byte fields are built in their own
signed types and viewed as bytes (torch's CPU build has no uint16
shifts). JAX compacts in three levels with segment caps and reports an
overflow where they bind; the port's single prefix sum does not, so on
such a frame the packed rows differ while the streams agree (JAX codes
it on its exact fallback).
"""

from __future__ import annotations

import numpy as np
import torch

from ceracoder_tpu_torch.codec.h264.device_entropy import _snake
from ceracoder_tpu_torch.ops.deblock import deblock_frame_rows
from ceracoder_tpu_torch.ops.h265 import _untimed, compact_slots
from ceracoder_tpu_torch.ops.inter import _encode_frame_p_inter, _intra_fallback
from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows

CHUNK = 6144              # sparse (pos, val) entries per transfer chunk


def pack_layout(n_mb: int, intra: bool, chunk: int = CHUNK) -> dict:
    """Byte offsets of each section in one frame's packed row.

    Sections are padded to 4-byte boundaries so host numpy views land
    aligned (mirrors ops/h265.run_pack_layout)."""
    def pad4(x):
        return -(-x // 4) * 4

    off = {"nnz": 0}
    o = 4
    # uint8 per MB. IDR frame: mode_l | mode_c << 2. P frame: bit0
    # is_intra (Intra_16x16 fallback MB), then mode_l << 1 | mode_c
    # << 3 for intra MBs.
    off["meta"] = o
    o += pad4(n_mb)
    off["counts"] = o             # uint16 per-MB nonzero level count
    o += pad4(2 * n_mb)
    if not intra:
        off["mv"] = o             # int16 (dy, dx) quarter-pel per MB
        o += pad4(4 * n_mb)
    off["lv0"] = o                # (pos, val) int16 interleaved
    o += 4 * chunk
    off["total"] = o
    return off


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def _flat384_i(outs, mbh: int, mbw: int):
    n = mbh * mbw
    ac_snake = _snake(outs["ac_luma"].to(torch.int16))     # (mbh,mbw,16,15)
    return torch.cat([
        outs["dc_luma"].reshape(n, 16).to(torch.int16),
        ac_snake.reshape(n, 240),
        outs["dc_chroma"].reshape(n, 8).to(torch.int16),
        outs["ac_chroma"].reshape(n, 120).to(torch.int16)], dim=1)


def _flat384_p(outs, mbh: int, mbw: int):
    n = mbh * mbw
    luma256 = _snake(outs["luma_levels"].to(torch.int16)).reshape(n, 256)
    if "is_intra" in outs:
        # intra-in-P MBs store [dc 16 | ac snake 240] in the same 256
        # luma slots (their inter levels are zeroed by the op)
        intra256 = torch.cat([
            outs["dc_luma"].reshape(n, 16).to(torch.int16),
            _snake(outs["ac_luma"].to(torch.int16)).reshape(n, 240)], dim=1)
        luma256 = torch.where(outs["is_intra"].reshape(n, 1), intra256,
                              luma256)
    return torch.cat([
        luma256,
        outs["dc_chroma"].reshape(n, 8).to(torch.int16),
        outs["ac_chroma"].reshape(n, 120).to(torch.int16)], dim=1)


def _pack_rows(meta, counts, mv, pos, val, nnz, chunk: int):
    """Fuse the transfer arrays of n frames into one uint8 row per
    frame, in pack_layout's byte layout. All inputs carry a leading
    frame axis n; meta and mv may be None. Returns (packed (n, L)
    uint8, rest (n, cap - chunk, 2) int16: the (pos, val) entries past
    chunk 0, whose c-th chunk is rest[:, c*chunk:(c+1)*chunk])."""
    n = counts.shape[0]

    def u8(a):
        return a.contiguous().view(torch.uint8).reshape(n, -1)

    def pad4(a):
        fill = torch.zeros((n, (-a.shape[1]) % 4), dtype=torch.uint8,
                           device=a.device)
        return torch.cat([a, fill], dim=1)

    parts = [u8(nnz.to(torch.int32).reshape(n, 1))]
    if meta is not None:
        parts.append(pad4(meta.to(torch.uint8).reshape(n, -1)))
    # per-MB counts are at most 384: int16 bytes == uint16 bytes
    parts.append(pad4(u8(counts.to(torch.int16))))
    if mv is not None:
        parts.append(pad4(u8(mv.to(torch.int16).reshape(n, -1))))
    pv = torch.stack([pos.reshape(n, -1), val.reshape(n, -1)], dim=-1)
    parts.append(u8(pv[:, :chunk]))
    return torch.cat(parts, dim=1), pv[:, chunk:]


def _syntax_row(flat, meta, mv, cap: int, chunk: int):
    """One frame's packed row from its 384-slot level matrix."""
    pos, val, nnz = compact_slots(flat, cap)
    counts = (flat != 0).sum(1, dtype=torch.int32)
    return _pack_rows(meta[None], counts[None],
                      None if mv is None else mv[None],
                      pos[None], val[None], nnz[None], chunk)


def encode_idr_syntax(y, u, v, qp: int, qp_c: int, cap: int, chunk: int,
                      deblock: bool, stage=_untimed):
    """One IDR frame: intra encode (stage "intra"), deblock ("deblock")
    and the syntax compaction + packed row ("compact_pack").

    Returns (packed (1, L) uint8, rest (1, cap - chunk, 2) int16,
    recon plane tuple)."""
    outs = stage("intra", lambda: encode_frame_i16_rows(y, u, v, qp, qp_c))
    recon = outs["recon"]
    mbh, mbw = outs["mode_luma"].shape
    if deblock:
        zero_nnz = torch.zeros((mbh, mbw, 4, 4), dtype=torch.int32,
                               device=y.device)
        zero_mv = torch.zeros((mbh, mbw, 2), dtype=torch.int32,
                              device=y.device)
        recon = stage("deblock", lambda: deblock_frame_rows(
            *recon, zero_nnz, zero_mv, qp, qp_c, intra_frame=True))

    def pack():
        meta = (outs["mode_luma"].to(torch.uint8)
                | (outs["mode_chroma"].to(torch.uint8) << 2))
        return _syntax_row(_flat384_i(outs, mbh, mbw), meta.reshape(-1),
                           None, cap, chunk)
    packed, rest = stage("compact_pack", pack)
    return packed, rest, recon


def encode_p_syntax(y, u, v, ref, qp: int, qp_c: int, cap: int,
                    chunk: int, deblock: bool, intra_in_p: bool,
                    stage=_untimed):
    """One P frame against the reference planes `ref`: the inter stage
    ("inter"), the Intra_16x16 fallback ("intra_fallback", with
    intra_in_p), deblock ("deblock") and the packed row
    ("compact_pack"). Returns (packed (1, L), rest, recon)."""
    outs = stage("inter", lambda: _encode_frame_p_inter(y, u, v, *ref, qp,
                                                        qp_c))
    if intra_in_p:
        outs = stage("intra_fallback", lambda: _intra_fallback(
            y, u, v, outs, qp, qp_c))
    recon = outs["recon"]
    mbh, mbw = outs["mv"].shape[:2]
    if deblock:
        nnz44 = (outs["luma_levels"] != 0).any(-1).to(torch.int32)
        recon = stage("deblock", lambda: deblock_frame_rows(
            *recon, nnz44, outs["mv"], qp, qp_c, intra_frame=False,
            intra_mb=outs.get("is_intra")))

    def pack():
        if intra_in_p:
            meta = (outs["is_intra"].to(torch.uint8)
                    | (outs["mode_luma"].to(torch.uint8) << 1)
                    | (outs["mode_chroma"].to(torch.uint8) << 3))
        else:
            meta = torch.zeros((mbh, mbw), dtype=torch.uint8,
                               device=y.device)
        return _syntax_row(_flat384_p(outs, mbh, mbw), meta.reshape(-1),
                           outs["mv"], cap, chunk)
    packed, rest = stage("compact_pack", pack)
    return packed, rest, recon


def encode_run_syntax_p(planes, qps, qp_cs, ref, cap: int, chunk: int,
                        deblock: bool, intra_in_p: bool = False):
    """Encode F consecutive P frames, carrying the deblocked reference.

    planes: callable f -> (y, u, v) device planes of the run's frame f.
    qps, qp_cs: host sequences of length F. ref: the (y, u, v)
    reference entering the run. Returns (packed (F, L) uint8, rest
    (F, cap - chunk, 2) int16, recons: list of F per-frame recon
    tuples)."""
    packed, rest, recons = [], [], []
    for f in range(len(qps)):
        y, u, v = planes(f)
        p, r, ref = encode_p_syntax(y, u, v, ref, int(qps[f]),
                                    int(qp_cs[f]), cap, chunk, deblock,
                                    intra_in_p)
        packed.append(p)
        rest.append(r)
        recons.append(ref)
    return torch.cat(packed), torch.cat(rest), recons


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def densify384(counts: np.ndarray, pos: np.ndarray, val: np.ndarray,
               nnz: int) -> np.ndarray:
    """Rebuild the dense (n_mb, 384) slot matrix from the sparse
    stream (MB-major, pos = slot within the MB's layout)."""
    cnt = counts.astype(np.int64)
    mb_of = np.repeat(np.arange(cnt.size), cnt)
    flat = mb_of * 384 + pos[:nnz].astype(np.int64)
    dense = np.zeros(cnt.size * 384, np.int16)
    dense[flat] = val[:nnz]
    return dense.reshape(cnt.size, 384)


def unpack_syntax(row: np.ndarray, get_chunk, f: int, mbh: int,
                  mbw: int, intra: bool, cap: int,
                  chunk: int = CHUNK):
    """Decode one frame's packed row into entropy-stage arrays.

    get_chunk(c) must return the c-th extra level chunk array
    ((F, chunk, 2) int16). Returns (nnz, arrays) — arrays is None when
    nnz overflowed cap and the frame must be redone on the host path."""
    n_mb = mbh * mbw
    lay = pack_layout(n_mb, intra, chunk)
    nnz = int(row[lay["nnz"]:lay["nnz"] + 4].view(np.int32)[0])
    if nnz > cap:
        return nnz, None
    counts = row[lay["counts"]:lay["counts"] + 2 * n_mb].view(np.uint16)
    pv0 = row[lay["lv0"]:lay["lv0"] + 4 * chunk] \
        .view(np.int16).reshape(chunk, 2)
    pos, val = pv0[:, 0], pv0[:, 1]
    nextra = max(0, -(-nnz // chunk) - 1)
    if nextra:
        ext = [np.asarray(get_chunk(c)[f]) for c in range(nextra)]
        pos = np.concatenate([pos] + [e[:, 0] for e in ext])
        val = np.concatenate([val] + [e[:, 1] for e in ext])
    dense = densify384(counts, pos, val, nnz)
    # slot layout differs per kind (see module docstring)
    if intra:
        meta = row[lay["meta"]:lay["meta"] + n_mb]
        arrays = {
            "mode_l": (meta & 3).astype(np.int32).reshape(mbh, mbw),
            "mode_c": ((meta >> 2) & 3).astype(np.int32)
            .reshape(mbh, mbw),
            "dc_luma": dense[:, :16].reshape(mbh, mbw, 16),
            "ac_luma": dense[:, 16:256].reshape(mbh, mbw, 16, 15),
            "dc_chroma": dense[:, 256:264].reshape(mbh, mbw, 2, 4),
            "ac_chroma": dense[:, 264:].reshape(mbh, mbw, 2, 4, 15),
        }
    else:
        mv = row[lay["mv"]:lay["mv"] + 4 * n_mb].view(np.int16)
        meta = row[lay["meta"]:lay["meta"] + n_mb]
        arrays = {
            "mv": mv.reshape(mbh, mbw, 2).astype(np.int64),
            "nnz_mb": counts.reshape(mbh, mbw),
            "is_intra": (meta & 1).astype(bool).reshape(mbh, mbw),
            "mode_l": ((meta >> 1) & 3).astype(np.int32)
            .reshape(mbh, mbw),
            "mode_c": ((meta >> 3) & 3).astype(np.int32)
            .reshape(mbh, mbw),
            "luma_lv": dense[:, :256].reshape(mbh, mbw, 16, 16),
            "dc_chroma": dense[:, 256:264].reshape(mbh, mbw, 2, 4),
            "ac_chroma": dense[:, 264:].reshape(mbh, mbw, 2, 4, 15),
        }
    return nnz, arrays
