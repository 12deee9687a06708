"""HEVC device encoder: torch compute on the card + native C++ entropy.

Port of ceracoder_tpu/codec/h265/device.py: IDR + low-delay-P runs
and, with `bframes=1`, IBPBP (one non-reference B frame between
references), with or without the inter TU split (`tu_split`). Per
frame, the device (ops/h265.py) produces the per-CTB
decisions, the quantized levels (sparse-compacted into one packed
transfer row) and the deblocked reconstruction, which stays on the
device as the next reference. Each row goes to a pinned host buffer by
a non-blocking copy; the native CABAC stage (codec/h265/rowslice.py)
emits the slice data. A frame whose sparse levels overflow their
capacity is coded from its dense levels, kept on the device until the
run's results are read: the same arrays, so the same bytes as the JAX
encoder's exact fallback.

With `sao=True` each frame's deblocked reconstruction also goes
through SAO on the device (ops/h265.py: sao_estimate_dev,
sao_apply_dev); the filtered planes are the next reference, and the
per-CTB parameters reach the host in the same pinned buffer as the
packed rows.

The per-frame entry points (`encode_frame`, `encode_frame_async`, the
app's low-delay loop) are runs of one frame. With B frames,
`push_frame`/`flush` take display-order frames one at a time and
`encode_run_b_async` takes a run of them; both hold a frame back as the
B of a (B, P) display pair, code the P frame first (two POCs back from
its reference) and then the B frame, bi-predicted between that
reference and the P frame's filtered reconstruction (ops/h265.py:
encode_run_pairs). A pair's overflowing P or B frame is coded from its
dense levels like any other frame; the JAX encoder's host recompute of
such a frame is not ported.

Not ported (ROADMAP.md): the JAX encoder's `deblock=False`,
`tile_rows=False` and `native_entropy=False`. No caller sets the first
two, so the encoder always deblocks and codes one tile per CTB row (the
spec layer, codec/h265/rowslice.py: H265RowEncoder, entropy_rows and
entropy_rows_native, takes both modes); the third codes with the Python
entropy spec (entropy_rows), which stays off every production path.
"""

from __future__ import annotations

import numpy as np
import torch

from ceracoder_tpu_torch.codec.h264.encoder import EncodedFrame, PendingFrame
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.codec.h265.rowslice import (
    densify_levels,
    entropy_rows_native,
)
from ceracoder_tpu_torch.codec.h265.syntax import (
    NAL_IDR_W_RADL,
    NAL_TRAIL_N,
    NAL_TRAIL_R,
    HevcParams,
    nal_unit,
    write_pps,
    write_sps,
    write_vps,
)
from ceracoder_tpu_torch.ops.h265 import (
    _pad_edge,
    encode_run_pairs,
    encode_run_rows,
    level_capacity,
    run_frame,
    run_pack_layout,
)
from ceracoder_tpu_torch.utils.device import resolve_device, upload

CTB = 16
LEVEL_KEYS = ("luma_lv", "cb_lv", "cr_lv")
NAL_TYPES = {"I": NAL_IDR_W_RADL, "P": NAL_TRAIL_R, "B": NAL_TRAIL_N}


class H265DeviceEncoder:
    """HEVC encoder, device compute + native entropy, byte-identical to
    the JAX package's H265DeviceEncoder with in-loop deblocking on, one
    tile per CTB row and native entropy, with or without SAO (`sao`),
    the inter TU split (`tu_split`) and B frames (`bframes=1`: IBPBP
    through push_frame/flush or encode_run_b_async).

    Runs on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``). `fallback_frames` counts frames whose sparse
    levels overflowed and were coded from their dense levels;
    `frames_launched` frames whose device work has started (the app's
    stall watchdog reads it).
    """

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, device=None, sao: bool = False,
                 tu_split: bool = False, bframes: int = 0):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 requires even dimensions (the "
                             "conformance window crops in 2-sample "
                             "units)")
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.qp = qp
        self.gop = max(1, gop)
        self.sao = sao
        self.tu_split = tu_split
        self.bframes = 1 if bframes else 0
        self.params = HevcParams(width=width, height=height, qp=qp,
                                 pcm_enabled=False, deblock=True,
                                 max_reorder=self.bframes,
                                 max_dpb_minus1=1 + self.bframes,
                                 tile_rows=True, sao=sao,
                                 tu_split_inter=tu_split)
        self.pw = -(-width // CTB) * CTB
        self.ph = -(-height // CTB) * CTB
        self._ref = None              # device recon planes (padded size)
        self._pending = None          # the held-back B candidate
        self._poc = 0
        self.fallback_frames = 0
        self.frames_launched = 0

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def resume(self) -> None:
        """Drop all transient state (reference, held-back B candidate,
        GOP position): the next frame codes as a fresh IDR."""
        self._ref = None
        self._pending = None
        self._poc = 0

    def load_state(self, ref_y, ref_u, ref_v, poc: int) -> None:
        """Carry over an encoder's state (this system's weights are its
        reference chain): the reference planes at the padded size
        (numpy uint8 arrays, e.g. read off a JAX `H265DeviceEncoder._ref`)
        and the POC of the next frame. After it, this encoder emits the
        same bytes for the same next frames as the encoder the state
        came from."""
        shapes = ((self.ph, self.pw), (self.ph // 2, self.pw // 2),
                  (self.ph // 2, self.pw // 2))
        ref = tuple(np.asarray(p) for p in (ref_y, ref_u, ref_v))
        if tuple(p.shape for p in ref) != shapes:
            raise ValueError(f"reference planes {[p.shape for p in ref]} "
                             f"do not match {list(shapes)}")
        self._ref = tuple(torch.as_tensor(p.astype(np.uint8),
                                          device=self.device) for p in ref)
        self._pending = None
        self._poc = int(poc)

    def _pad(self, plane, h: int, w: int) -> torch.Tensor:
        """A plane on the device, edge-padded on the bottom/right to
        (h, w)."""
        plane = upload(plane, self.device)
        ph, pw = plane.shape
        if (ph, pw) == (h, w):
            return plane
        return _pad_edge(plane, 0, h - ph, 0, w - pw)

    def _planes_fn(self, frames, source, indices):
        """f -> frame f's padded (y, u, v) device planes: uploaded from
        `frames`, or generated on the device by `source`."""
        if frames is not None:
            def get(f):
                return frames[f]
        else:
            idx = [int(i) for i in indices]

            def get(f):
                return source.frame(idx[f])

        def planes(f):
            self.frames_launched += 1
            y, u, v = get(f)
            return (self._pad(y, self.ph, self.pw),
                    self._pad(u, self.ph // 2, self.pw // 2),
                    self._pad(v, self.ph // 2, self.pw // 2))
        return planes

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False) -> EncodedFrame:
        if self.bframes:
            raise RuntimeError("with B frames, use push_frame/flush or "
                               "encode_run_b_async")
        return self.encode_frame_async(y, u, v, qp, force_idr).result()

    def encode_frame_async(self, y, u, v, qp: int | None = None,
                           force_idr: bool = False) -> PendingFrame:
        """One frame, as a run of one: the same device arrays as the
        JAX encoder's per-frame path, so the same bytes."""
        return self.encode_run_async(frames=[(y, u, v)], qp=qp,
                                     force_idr=force_idr)[0]

    def encode_run_async(self, frames=None, qp: int | None = None,
                         qps=None, source=None, indices=None,
                         force_idr: bool = False, cap: int | None = None,
                         frame_hook=run_frame) -> list[PendingFrame]:
        """Encode a run of consecutive frames as I and P frames.

        Either `frames` (list of (y, u, v) planes) or `source` +
        `indices` (a device source whose `frame(i)` makes planes on the
        device). The frames go to the device one after another, carrying
        the deblocked reference; GOP scheduling (IDR placement, POCs)
        follows the JAX encoder's. Levels transfer sparse-compacted:
        `cap` entries for a P frame, more for an IDR frame, as the JAX
        encoder sizes them (ops/h265.py: level_capacity). `frame_hook`
        sees each frame's device work (ops/h265.py: run_frame)."""
        nf = len(frames) if frames is not None else len(indices)
        if nf == 0:
            return []
        idr_flags, qp_arr, pocs = [], [], []
        have_ref = self._ref is not None
        for f in range(nf):
            qp_f = (qps[f] if qps is not None
                    else (self.qp if qp is None else qp))
            idr = ((force_idr and f == 0) or not have_ref
                   or self._poc >= self.gop)
            idr_flags.append(idr)
            qp_arr.append(int(qp_f))
            pocs.append(0 if idr else self._poc)
            self._poc = 1 if idr else self._poc + 1
            have_ref = True
        return self._launch(self._planes_fn(frames, source, indices),
                            idr_flags, qp_arr, pocs, cap, frame_hook)

    def _launch(self, planes, idr_flags, qps, pocs, cap: int | None,
                frame_hook=run_frame) -> list[PendingFrame]:
        """Start a run of I and P frames on the device (ops/h265.py:
        encode_run_rows) from the current reference; frame f is an IDR
        where idr_flags[f], else a P frame referencing the frame before
        it, coded at qps[f] with POC pocs[f]. Returns one PendingFrame
        per frame."""
        n_ctb = (self.ph // CTB) * (self.pw // CTB)
        caps, chunks = zip(*(level_capacity(n_ctb, bool(i), cap)
                             for i in idr_flags))
        outs = encode_run_rows(planes, idr_flags, qps,
                               [chroma_qp(q) for q in qps],
                               self._ref_or_blank(), caps, chunks,
                               sao=self.sao, tu_split=self.tu_split,
                               frame=frame_hook)
        self._ref = outs[-1]["recon"]
        rows = self._rows_to_host(outs)
        return [self._make_run_pending(
            outs[f], rows, f, "I" if idr_flags[f] else "P", qps[f], pocs[f],
            caps[f], chunks[f]) for f in range(len(outs))]

    def _ref_or_blank(self) -> tuple:
        """The reference planes, or zero planes before the first IDR
        (which reads none)."""
        if self._ref is not None:
            return self._ref
        return tuple(torch.zeros(s, dtype=torch.uint8, device=self.device)
                     for s in ((self.ph, self.pw),
                               (self.ph // 2, self.pw // 2),
                               (self.ph // 2, self.pw // 2)))

    # -- B frames (IBPBP) ---------------------------------------------------

    def push_frame(self, y, u, v, qp: int | None = None,
                   force_idr: bool = False, allow_b: bool = True) -> list:
        """Feed one display-order frame; returns (data, poc, kind,
        display recon) tuples in coding order, kind "I", "P" or "B",
        the reconstruction as the padded device planes (empty while a B
        candidate waits for its forward reference). With `bframes=1`
        the frame is held back as the B of a pair while its POC leaves
        room before the GOP's end; `allow_b=False` (a lookahead hint:
        erratic motion) codes it as P instead."""
        qp = self.qp if qp is None else qp
        idr = force_idr or self._ref is None or self._poc >= self.gop
        out = []
        if idr:
            out += self.flush()
            fr = self.encode_frame_async(y, u, v, qp=qp,
                                         force_idr=True).result()
            out.append((fr.data, 0, "I", self._ref))
            return out
        if (self.bframes and self._pending is None and allow_b
                and self._poc <= self.gop - 2):
            self._pending = ((y, u, v), self._poc, qp)
            self._poc += 1
            return out
        if self._pending is not None:
            bplanes, bpoc, bqp = self._pending
            self._pending = None
            pair = self._launch_pairs(
                self._planes_fn([bplanes, (y, u, v)], None, None),
                [bqp, qp], bpoc, None)
            for pf, poc, kind in pair:
                fr = pf.result()
                out.append((fr.data, poc, kind, fr._recon_dev))
            self._poc += 1
            return out
        fr = self._encode_px((y, u, v), qp, self._poc)
        out.append((fr.data, self._poc, "P", self._ref))
        self._poc += 1
        return out

    def flush(self) -> list:
        """Code any held-back B candidate as a trailing P frame."""
        if self._pending is None:
            return []
        planes, poc, qp = self._pending
        self._pending = None
        fr = self._encode_px(planes, qp, poc)
        # _poc already advanced when the frame was held back
        return [(fr.data, poc, "P", self._ref)]

    def _encode_px(self, planes, qp: int, poc: int) -> EncodedFrame:
        """A P frame at an explicit POC."""
        return self._launch(self._planes_fn([planes], None, None), [False],
                            [int(qp)], [poc], None)[0].result()

    def encode_run_b_async(self, frames=None, qp: int | None = None,
                           source=None, indices=None,
                           cap: int | None = None,
                           frame_hook=run_frame) -> list:
        """Encode display-order frames with the IBPBP structure (needs
        `bframes=1`): (B, P) pairs up to the GOP's end in one pass over
        the device (ops/h265.py: encode_run_pairs), an IDR where the GOP
        ends, and a frame that finds no partner (an odd tail, or a GOP
        with one slot left) as a plain P. Frames as in encode_run_async.
        `frame_hook` sees each frame's device work (ops/h265.py:
        run_frame). Returns (PendingFrame, poc, kind) tuples in coding
        order; the stream equals push_frame/flush's over the same
        frames."""
        if not self.bframes:
            raise RuntimeError("encode_run_b_async needs bframes=1")
        nf = len(frames) if frames is not None else len(indices)
        qp = int(self.qp if qp is None else qp)
        planes = self._planes_fn(frames, source, indices)
        out = []
        i = 0
        while i < nf:
            if self._ref is None or self._poc >= self.gop:
                (pf,) = self._launch(lambda _, i=i: planes(i), [True], [qp],
                                     [0], cap, frame_hook)
                out.append((pf, 0, "I"))
                self._poc = 1
                i += 1
                continue
            # a pair's B sits at poc0 + 2k and its P at poc0 + 2k + 1,
            # which must stay below the IDR trigger (poc >= gop)
            npair, poc0 = 0, self._poc
            while (i + 2 * (npair + 1) <= nf
                   and poc0 + 2 * npair <= self.gop - 2):
                npair += 1
            if npair == 0:
                (pf,) = self._launch(lambda _, i=i: planes(i), [False],
                                     [qp], [poc0], cap, frame_hook)
                out.append((pf, poc0, "P"))
                self._poc += 1
                i += 1
                continue
            out += self._launch_pairs(lambda j, i=i: planes(i + j),
                                      [qp] * 2 * npair, poc0, cap,
                                      frame_hook)
            i += 2 * npair
            self._poc += 2 * npair
        return out

    def _launch_pairs(self, planes, qps, poc0: int, cap: int | None,
                      frame_hook=run_frame) -> list:
        """Start (B, P) display pairs from the current reference:
        planes(j) and qps[j] are display frame j of the pairs, the first
        B frame at POC poc0. Returns the (P, B) (PendingFrame, poc, kind)
        tuples of each pair in coding order."""
        npair = len(qps) // 2
        n_ctb = (self.ph // CTB) * (self.pw // CTB)
        cap, chunk = level_capacity(n_ctb, False, cap)
        pairs = encode_run_pairs(planes, npair, qps,
                                 [chroma_qp(q) for q in qps], self._ref,
                                 cap, sao=self.sao, tu_split=self.tu_split,
                                 frame=frame_hook)
        self._ref = pairs[-1][0]["recon"]
        outs = [o for pair in pairs for o in pair]       # P0, B0, P1, ...
        rows = self._rows_to_host(outs)
        res = []
        for k in range(npair):
            poc_b = poc0 + 2 * k
            for f, kind, poc, ref_delta, qp in (
                    (2 * k, "P", poc_b + 1, 2, qps[2 * k + 1]),
                    (2 * k + 1, "B", poc_b, 1, qps[2 * k])):
                res.append((self._make_run_pending(
                    outs[f], rows, f, kind, qp, poc, cap, chunk, ref_delta),
                    poc, kind))
        return res

    def _rows_to_host(self, outs: list[dict]):
        """Start the copy of every frame's packed row, and with SAO its
        parameters, into one pinned host buffer (non-blocking, on the
        current stream); return a function that waits for it and yields
        (row, SAO parameters or None) per frame."""
        nch, ncw = self.ph // CTB, self.pw // CTB
        parts = [o["packed"][0] for o in outs]
        if self.sao:
            parts += [o["sao"].reshape(-1).view(torch.uint8) for o in outs]
        nf = len(outs)
        if self.device.type != "cuda":
            host, done = [p.numpy() for p in parts], None
        else:
            sizes = [p.shape[0] for p in parts]
            buf = torch.empty(sum(sizes), dtype=torch.uint8,
                              pin_memory=True)
            starts = np.concatenate([[0], np.cumsum(sizes)])
            for p, s0, s1 in zip(parts, starts, starts[1:]):
                buf[s0:s1].copy_(p, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            # the views keep the pinned buffer alive
            host = [buf.numpy()[s0:s1] for s0, s1 in zip(starts, starts[1:])]

        def get():
            if done is not None:
                done.synchronize()
            sao = ([p.view(np.int32).reshape(nch, ncw, 3, 6)
                    for p in host[nf:]] if self.sao else [None] * nf)
            return list(zip(host[:nf], sao))
        return get

    def _unpack_row(self, row: np.ndarray, cap: int, chunk: int, extra,
                    dense, with_mv1: bool = False):
        """Decode one frame's packed transfer row (ops/h265.py:
        run_pack_layout; `with_mv1` a B frame's) into the entropy-stage
        arrays. `extra(n)` gives the (pos, val) level entries past chunk
        0 as host arrays; `dense()` the frame's dense levels, used when
        nnz overflowed cap. Returns (nnz, arrays)."""
        nch, ncw = self.ph // CTB, self.pw // CTB
        n_ctb = nch * ncw
        lay = run_pack_layout(n_ctb, chunk=chunk, with_mv1=with_mv1)
        nnz = int(row[lay["nnz"]:lay["nnz"] + 4].view(np.int32)[0])
        meta = row[lay["meta"]:lay["meta"] + n_ctb].reshape(nch, ncw)
        arrays = {
            "is_intra": (meta & 0x80) != 0,
            "tu_split": (meta & 0x40) != 0,
            "mode": (meta & 0x3F).astype(np.int32),
            "mv": row[lay["mv"]:lay["mv"] + 2 * n_ctb]
            .view(np.int8).reshape(nch, ncw, 2).astype(np.int32),
        }
        if with_mv1:
            arrays["mv1"] = row[lay["mv1"]:lay["mv1"] + 2 * n_ctb] \
                .view(np.int8).reshape(nch, ncw, 2).astype(np.int32)
        if nnz > cap:
            arrays.update(dense())
            return nnz, arrays
        counts = row[lay["counts"]:lay["counts"] + 2 * n_ctb] \
            .view(np.uint16).reshape(nch, ncw)
        pv0 = row[lay["lv0"]:lay["lv0"] + 4 * chunk] \
            .view(np.int16).reshape(chunk, 2)
        pos, val = pv0[:, 0], pv0[:, 1]
        if nnz > chunk:
            ext = extra(nnz - chunk)
            pos = np.concatenate([pos, ext[:, 0]])
            val = np.concatenate([val, ext[:, 1]])
        arrays.update(densify_levels(counts, pos, val))
        return nnz, arrays

    def _make_run_pending(self, out, rows, f, kind: str, qp: int, poc: int,
                          cap: int, chunk: int,
                          ref_delta: int = 1) -> PendingFrame:
        """Frame f of a run's host rows (`rows()`, _rows_to_host), coded
        as `kind` ("I", "P" or "B") at POC `poc`, a P frame referencing
        ref_delta POCs back, a B frame one back and one ahead."""
        idr, is_b = kind == "I", kind == "B"

        def extra(n):
            return out["lv_rest"][0, :n].cpu().numpy()

        def dense():
            self.fallback_frames += 1
            return {k: a.cpu().numpy().astype(np.int32)
                    for k, a in zip(LEVEL_KEYS, out["dense_lv"])}

        def finish() -> EncodedFrame:
            row, sao = rows()[f]
            _, arrays = self._unpack_row(row, cap, chunk, extra, dense,
                                         with_mv1=is_b)
            if sao is not None:
                arrays["sao"] = sao
            rbsps = entropy_rows_native(
                self.params, arrays, qp, idr=idr, poc=poc,
                ref_poc_delta=ref_delta, slice_type="B" if is_b else None)
            data = b"".join(
                nal_unit(NAL_TYPES[kind], r, long_start_code=(i == 0))
                for i, r in enumerate(rbsps))
            return EncodedFrame(data=data, keyframe=idr, qp=qp,
                                _recon_dev=out["recon"])

        return PendingFrame(finish, idr, qp)

    @property
    def recon(self):
        """Cropped reconstruction of the last encoded frame (host)."""
        if self._ref is None:
            return None
        ry, ru, rv = (p.cpu().numpy() for p in self._ref)
        return (ry[:self.height, :self.width],
                ru[:self.height // 2, :self.width // 2],
                rv[:self.height // 2, :self.width // 2])
