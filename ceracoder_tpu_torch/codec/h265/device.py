"""HEVC device encoder: torch compute on the card + native C++ entropy.

Port of ceracoder_tpu/codec/h265/device.py for the IDR + low-delay-P
run path. Per frame, the device (ops/h265.py) produces the per-CTB
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
app's low-delay loop) are runs of one frame.

Not ported yet (ROADMAP.md): the inter TU split, B frames
(`push_frame`, `flush`) and the Python entropy spec.
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
    NAL_TRAIL_R,
    HevcParams,
    nal_unit,
    write_pps,
    write_sps,
    write_vps,
)
from ceracoder_tpu_torch.ops.h265 import (
    _pad_edge,
    encode_run_rows,
    level_capacity,
    run_pack_layout,
)
from ceracoder_tpu_torch.utils.device import resolve_device, upload

CTB = 16
LEVEL_KEYS = ("luma_lv", "cb_lv", "cr_lv")


class H265DeviceEncoder:
    """IDR + low-delay-P HEVC encoder, device compute + native entropy,
    byte-identical to the JAX package's H265DeviceEncoder with in-loop
    deblocking on, one tile per CTB row and native entropy, with or
    without SAO (`sao`); no inter TU split or B frames (later slices of
    the port, ROADMAP.md).

    Runs on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``). `fallback_frames` counts frames whose sparse
    levels overflowed and were coded from their dense levels;
    `frames_launched` frames whose device work has started (the app's
    stall watchdog reads it).
    """

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, device=None, sao: bool = False):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 requires even dimensions (the "
                             "conformance window crops in 2-sample "
                             "units)")
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.qp = qp
        self.gop = max(1, gop)
        self.sao = sao
        self.params = HevcParams(width=width, height=height, qp=qp, sao=sao)
        self.pw = -(-width // CTB) * CTB
        self.ph = -(-height // CTB) * CTB
        self._ref = None              # device recon planes (padded size)
        self._poc = 0
        self.fallback_frames = 0
        self.frames_launched = 0

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def resume(self) -> None:
        """Drop all transient state (reference, GOP position): the next
        frame codes as a fresh IDR."""
        self._ref = None
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
        return self.encode_frame_async(y, u, v, qp, force_idr).result()

    def encode_frame_async(self, y, u, v, qp: int | None = None,
                           force_idr: bool = False) -> PendingFrame:
        """One frame, as a run of one: the same device arrays as the
        JAX encoder's per-frame path, so the same bytes."""
        return self.encode_run_async(frames=[(y, u, v)], qp=qp,
                                     force_idr=force_idr)[0]

    def encode_run_async(self, frames=None, qp: int | None = None,
                         qps=None, source=None, indices=None,
                         force_idr: bool = False,
                         cap: int | None = None) -> list[PendingFrame]:
        """Encode a run of consecutive frames.

        Either `frames` (list of (y, u, v) planes) or `source` +
        `indices` (a device source whose `frame(i)` makes planes on the
        device). The frames go to the device one after another, carrying
        the deblocked reference; GOP scheduling (IDR placement, POCs)
        follows the JAX encoder's. Levels transfer sparse-compacted:
        `cap` entries for a P frame, more for an IDR frame, as the JAX
        encoder sizes them (ops/h265.py: level_capacity)."""
        nf = len(frames) if frames is not None else len(indices)
        if nf == 0:
            return []

        n_ctb = (self.ph // CTB) * (self.pw // CTB)
        idr_flags = np.zeros(nf, bool)
        qp_arr = np.zeros(nf, np.int32)
        qpc_arr = np.zeros(nf, np.int32)
        pocs = np.zeros(nf, np.int32)
        have_ref = self._ref is not None
        for f in range(nf):
            qp_f = (qps[f] if qps is not None
                    else (self.qp if qp is None else qp))
            idr = ((force_idr and f == 0) or not have_ref
                   or self._poc >= self.gop)
            idr_flags[f] = idr
            qp_arr[f] = qp_f
            qpc_arr[f] = chroma_qp(int(qp_f))
            pocs[f] = 0 if idr else self._poc
            self._poc = 1 if idr else self._poc + 1
            have_ref = True
        caps, chunks = zip(*(level_capacity(n_ctb, bool(i), cap)
                             for i in idr_flags))

        prev_ref = self._ref
        if prev_ref is None:
            prev_ref = tuple(
                torch.zeros(s, dtype=torch.uint8, device=self.device)
                for s in ((self.ph, self.pw), (self.ph // 2, self.pw // 2),
                          (self.ph // 2, self.pw // 2)))
        outs = encode_run_rows(self._planes_fn(frames, source, indices),
                               idr_flags, qp_arr, qpc_arr, prev_ref, caps,
                               chunks, sao=self.sao)
        self._ref = outs[-1]["recon"]
        rows = self._rows_to_host(outs)
        return [self._make_run_pending(
            outs[f], rows, f, bool(idr_flags[f]), int(qp_arr[f]),
            int(pocs[f]), caps[f], chunks[f]) for f in range(nf)]

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
                    dense):
        """Decode one frame's packed transfer row (ops/h265.py:
        run_pack_layout) into the entropy-stage arrays. `extra(n)` gives
        the (pos, val) level entries past chunk 0 as host arrays;
        `dense()` the frame's dense levels, used when nnz overflowed
        cap. Returns (nnz, arrays)."""
        nch, ncw = self.ph // CTB, self.pw // CTB
        n_ctb = nch * ncw
        lay = run_pack_layout(n_ctb, chunk=chunk)
        nnz = int(row[lay["nnz"]:lay["nnz"] + 4].view(np.int32)[0])
        meta = row[lay["meta"]:lay["meta"] + n_ctb].reshape(nch, ncw)
        arrays = {
            "is_intra": (meta & 0x80) != 0,
            "tu_split": (meta & 0x40) != 0,
            "mode": (meta & 0x3F).astype(np.int32),
            "mv": row[lay["mv"]:lay["mv"] + 2 * n_ctb]
            .view(np.int8).reshape(nch, ncw, 2).astype(np.int32),
        }
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

    def _make_run_pending(self, out, rows, f, idr, qp, poc, cap,
                          chunk) -> PendingFrame:
        def extra(n):
            return out["lv_rest"][0, :n].cpu().numpy()

        def dense():
            self.fallback_frames += 1
            return {k: a.cpu().numpy().astype(np.int32)
                    for k, a in zip(LEVEL_KEYS, out["dense_lv"])}

        def finish() -> EncodedFrame:
            row, sao = rows()[f]
            _, arrays = self._unpack_row(row, cap, chunk, extra, dense)
            if sao is not None:
                arrays["sao"] = sao
            rbsps = self._entropy(arrays, idr=idr, poc=poc, qp=qp)
            ntype = NAL_IDR_W_RADL if idr else NAL_TRAIL_R
            data = b"".join(
                nal_unit(ntype, r, long_start_code=(i == 0))
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

    def _entropy(self, arrays, idr: bool, poc: int, qp: int):
        return entropy_rows_native(self.params, arrays, qp, idr=idr,
                                   poc=poc, ref_poc_delta=1)
