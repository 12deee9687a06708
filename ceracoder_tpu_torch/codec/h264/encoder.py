"""H.264 encoder: device compute + CABAC (default) or CAVLC entropy.

Port of ceracoder_tpu/codec/h264/encoder.py. Per frame, the device
runs prediction / transform / quant / recon (ops/intra.py, ops/inter.py)
and deblocking (ops/deblock.py); one slice per MB row.

- CABAC (`cabac=True`, the default; Main profile), with Intra_16x16
  fallback MBs in P slices (`intra_in_p`, on with CABAC): the device
  sparse-compacts each frame's syntax into one packed row
  (codec/h264/cabac_run.py); the host copies the rows of a run, then
  only the level chunks each frame used, and the native row coder
  (codec/h264/cabac_assemble.py, native/src/h264_cabac.cc) writes the
  slices on `.result()`. A run is split at its IDR frames: an IDR
  frame goes alone, a P span as one loop over its frames.
- CAVLC (`cabac=False`, Baseline profile): the whole entropy stage with
  the K1 window merge runs on the device (codec/h264/device_entropy.py);
  the host splits one compact buffer per run into NAL units.

A frame whose compacted syntax or packed rows overflow their capacity is
redone on the exact host path (device compute, dense arrays, host
entropy) against the in-run reference, and counted in
`fallback_frames`. The JAX encoder's `device_entropy=False` mode and its
transfer prefetch hints are not ported: the host path serves only as
that fallback, and the port copies exactly what each frame used.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ceracoder_tpu_torch.codec.bitwriter import (
    nal_unit,
    pack_bits,
    se_code,
    ue_code,
)
from ceracoder_tpu_torch.codec.h264 import cabac_run, cavlc
from ceracoder_tpu_torch.codec.h264.cabac_assemble import (
    assemble_i_cabac,
    assemble_i_snake,
    assemble_p_cabac,
    assemble_p_snake,
)
from ceracoder_tpu_torch.codec.h264.cavlc_tables import CBP_INTER_TO_CODE
from ceracoder_tpu_torch.codec.h264.device_entropy import (
    CHUNK_WORDS,
    HDR_SLOTS,
    LUMA_SNAKE,
    MB_SLOTS_I,
    MB_SLOTS_P,
    encode_run_packed,
)
from ceracoder_tpu_torch.codec.h264.syntax import (
    NAL_IDR,
    NAL_SLICE,
    SLICE_I_ALL,
    SLICE_P_ALL,
    PpsConfig,
    SliceConfig,
    SpsConfig,
    write_pps,
    write_slice_header,
    write_sps,
)
from ceracoder_tpu_torch.ops.deblock import deblock_frame_rows
from ceracoder_tpu_torch.ops.inter import encode_frame_p
from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows
from ceracoder_tpu_torch.ops.transform import chroma_qp
from ceracoder_tpu_torch.utils.device import resolve_device, upload

S = cavlc.BLOCK_SLOTS


def _neighbor_nc(nnz: np.ndarray, rows_per_mb: int,
                 same_row_only: bool) -> np.ndarray:
    """nC for every 4x4 block from neighbor TotalCoeffs (spec 9.2.1).

    nnz: (BH, BW) per-4x4-block TotalCoeff over the whole frame grid.
    rows_per_mb: block rows per MB row (4 luma / 2 chroma 4:2:0).
    same_row_only: True for slice-per-MB-row — a top neighbor in a
    different MB row is in another slice and thus unavailable.
    """
    bh, bw = nnz.shape
    left = np.zeros_like(nnz)
    left[:, 1:] = nnz[:, :-1]
    left_avail = np.zeros((bh, bw), bool)
    left_avail[:, 1:] = True

    top = np.zeros_like(nnz)
    top[1:, :] = nnz[:-1, :]
    top_avail = np.zeros((bh, bw), bool)
    top_avail[1:, :] = True
    if same_row_only:
        # blocks whose top neighbor is in the previous MB row
        edge = (np.arange(bh) % rows_per_mb) == 0
        top_avail[edge, :] = False

    both = left_avail & top_avail
    nc = np.where(both, (left + top + 1) >> 1,
                  np.where(left_avail, left, np.where(top_avail, top, 0)))
    return nc


@dataclass
class EncodedFrame:
    data: bytes
    keyframe: bool
    qp: int
    _recon_dev: tuple = field(default=None, repr=False)
    _recon_np: tuple | None = field(default=None, repr=False)

    @property
    def recon(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reconstructed (y, u, v) planes, copied to the host on first
        access (the streaming path never touches them)."""
        if self._recon_np is None:
            self._recon_np = tuple(p.cpu().numpy() for p in self._recon_dev)
        return self._recon_np


class PendingFrame:
    """A frame in flight: device work enqueued, host bytes not yet
    materialized; .result() waits for the run's host copy."""

    def __init__(self, finish, keyframe: bool, qp: int):
        self._finish = finish
        self._frame: EncodedFrame | None = None
        self.keyframe = keyframe
        self.qp = qp

    def result(self) -> EncodedFrame:
        if self._frame is None:
            self._frame = self._finish()
            self._finish = None
        return self._frame


class H264Encoder:
    """H.264 encoder: I (Intra_16x16) + P (P_L0_16x16/P_Skip, and
    Intra_16x16 with `intra_in_p`) slices, one slice per MB row; CABAC
    (Main profile) by default, CAVLC packed on the device with
    `cabac=False` (Baseline profile).

    Runs on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``). `fallback_frames` counts frames that overflowed
    their transfer capacity and were redone on the exact host path;
    `frames_launched` frames whose device work has started (the app's
    stall watchdog reads it).
    """

    def __init__(self, width: int, height: int, qp: int = 28,
                 fps_num: int = 0, fps_den: int = 1,
                 chroma_qp_offset: int = 0, gop: int = 1,
                 deblock: bool = True,
                 row_capacity_bytes: int | None = None,
                 frame_capacity_bytes: int | None = None,
                 cabac: bool = True, intra_in_p: bool | None = None,
                 device=None):
        if width % 16 or height % 16:
            raise ValueError("dimensions must be multiples of 16 "
                             "(use padding + SPS cropping upstream)")
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.mbw, self.mbh = width // 16, height // 16
        self.qp = qp
        self.gop = max(1, gop)          # 1 = all-intra
        self.deblock = deblock
        self.cabac = cabac
        # Intra_16x16 fallback MBs in P slices: on by default with CABAC;
        # the CAVLC device bit-packer codes all-inter P slices
        if intra_in_p and not cabac:
            raise ValueError("intra_in_p requires cabac=True (the "
                             "CAVLC device bit-packer codes all-inter "
                             "P slices)")
        self.intra_in_p = cabac if intra_in_p is None else intra_in_p
        # per-row packed capacity in 32-bit words; overflow falls back to
        # the host entropy path for that frame (detected exactly)
        cap = row_capacity_bytes or max(2048, self.mbw * 192)
        self._capw = (cap + 3) // 4
        totcap = frame_capacity_bytes or max(1 << 16, width * height // 6)
        chunk_bytes = CHUNK_WORDS * 4
        self._totcap = -(-totcap // chunk_bytes) * chunk_bytes
        # CABAC sparse-level capacities (entries, multiples of
        # cabac_run.CHUNK), as the JAX encoder sizes them: P frames
        # transfer in CHUNK-sized pieces; the IDR chunk holds a typical
        # all-intra frame in one piece
        n_mb = self.mbw * self.mbh
        chunk = cabac_run.CHUNK
        self._cabac_cap = -(-max(2 * chunk, n_mb * 48) // chunk) * chunk
        self._cabac_idr_chunk = -(-(n_mb * 96) // chunk) * chunk
        self.chroma_qp_offset = chroma_qp_offset
        self.sps = SpsConfig(width=width, height=height,
                             fps_num=fps_num, fps_den=fps_den,
                             profile_idc=77 if cabac else 66)
        self.pps = PpsConfig(pic_init_qp=26,
                             chroma_qp_index_offset=chroma_qp_offset,
                             cabac=cabac)
        self.frame_idx = 0
        self.idr_pic_id = 0
        self.frame_num = 0              # reference-frame counter
        self._gop_pos = 0
        self._ref = None                # previous recon, device tensors
        self.fallback_frames = 0
        self.frames_launched = 0

    def headers(self) -> bytes:
        return write_sps(self.sps) + write_pps(self.pps)

    def resume(self) -> None:
        """Drop all transient state (reference chain, GOP position):
        the next frame codes as a fresh IDR."""
        self._ref = None
        self._gop_pos = 0

    def load_state(self, ref_y, ref_u, ref_v, gop_pos: int, frame_num: int,
                   idr_pic_id: int, frame_idx: int) -> None:
        """Carry over an encoder's state (this system's weights are its
        reference chain): the reference planes (numpy uint8 arrays, e.g.
        read off a JAX `H264Encoder._ref`) and the GOP counters. After
        it, this encoder emits the same bytes for the same next frames
        as the encoder the state came from."""
        shapes = ((self.height, self.width),
                  (self.height // 2, self.width // 2),
                  (self.height // 2, self.width // 2))
        ref = tuple(np.asarray(p) for p in (ref_y, ref_u, ref_v))
        if tuple(p.shape for p in ref) != shapes:
            raise ValueError(f"reference planes {[p.shape for p in ref]} "
                             f"do not match {list(shapes)}")
        self._ref = tuple(torch.as_tensor(p.astype(np.uint8),
                                          device=self.device) for p in ref)
        self._gop_pos = int(gop_pos)
        self.frame_num = int(frame_num)
        self.idr_pic_id = int(idr_pic_id)
        self.frame_idx = int(frame_idx)

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False) -> EncodedFrame:
        return self.encode_frame_async(y, u, v, qp, force_idr).result()

    def encode_frame_async(self, y, u, v, qp: int | None = None,
                           force_idr: bool = False) -> PendingFrame:
        """Enqueue one frame (a run of one) and return immediately."""
        return self.encode_run_async(frames=[(y, u, v)], qp=qp,
                                     force_idr=force_idr)[0]

    def _hdr_arrays(self, idr: bool, qp: int, frame_num: int,
                    idr_pic_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-row slice-header symbols as fixed (mbh, HDR_SLOTS) arrays
        for the device packer."""
        hv = np.zeros((self.mbh, HDR_SLOTS), np.int64)
        hl = np.zeros((self.mbh, HDR_SLOTS), np.int64)
        for row in range(self.mbh):
            hdr = write_slice_header(SliceConfig(
                first_mb=row * self.mbw,
                slice_type=SLICE_I_ALL if idr else SLICE_P_ALL,
                frame_num=frame_num, idr=idr, idr_pic_id=idr_pic_id,
                qp=qp, pic_init_qp=self.pps.pic_init_qp,
                deblock_idc=2 if self.deblock else 1))
            v, ln = hdr.arrays()
            if v.size > HDR_SLOTS:
                raise AssertionError("HDR_SLOTS too small")
            hv[row, :v.size] = v
            hl[row, :ln.size] = ln
        return hv, hl

    def _planes_fn(self, frames, source, indices):
        """f -> (y, u, v) device planes of the run's frame f: uploaded
        from the host frames, or generated on the device by `source`."""
        if frames is not None:
            def planes(f):
                return tuple(upload(p, self.device) for p in frames[f])
            return planes
        idx = [int(i) for i in indices]

        def planes(f):
            return source.frame(idx[f])
        return planes

    def _launching(self, planes):
        """planes, counting each frame in `frames_launched` as its device
        work starts (the exact fallback's second call is not counted)."""
        def launch(f):
            self.frames_launched += 1
            return planes(f)
        return launch

    def encode_run_async(self, frames=None, qp: int | None = None,
                         qps=None, source=None, indices=None,
                         force_idr: bool = False) -> list[PendingFrame]:
        """Encode a run of consecutive frames.

        Either `frames` (list of (y, u, v) planes) or `source` +
        `indices` (a device source whose `frame(i)` produces planes on
        the device — no pixels cross from the host). The frames are
        enqueued on the device one after another, carrying the
        reconstruction; GOP scheduling (IDR placement) follows the
        reference's state machine. CABAC: see _encode_run_cabac.
        CAVLC: the row byte counts of the whole run, then each frame's
        used stream words, go to one pinned host buffer with
        non-blocking copies; the first .result() of the run waits on
        the recorded events, and each splits its frame into NAL units.
        """
        if self.cabac:
            return self._encode_run_cabac(frames, qp, qps, source, indices,
                                          force_idr)
        nf = len(frames) if frames is not None else len(indices)
        if nf == 0:
            return []

        idr_flags = np.zeros(nf, bool)
        qp_arr = np.zeros(nf, np.int64)
        qpc_arr = np.zeros(nf, np.int64)
        hvs = np.zeros((nf, self.mbh, HDR_SLOTS), np.int64)
        hls = np.zeros((nf, self.mbh, HDR_SLOTS), np.int64)
        frame_nums = np.zeros(nf, np.int64)
        idr_ids = np.zeros(nf, np.int64)
        have_ref = self._ref is not None
        for f in range(nf):
            qp_f = (qps[f] if qps is not None
                    else (self.qp if qp is None else qp))
            idr = ((force_idr and f == 0) or not have_ref
                   or self._gop_pos >= self.gop)
            frame_num = 0 if idr else self.frame_num
            idr_flags[f] = idr
            qp_arr[f] = qp_f
            qpc_arr[f] = chroma_qp(int(qp_f), self.chroma_qp_offset)
            frame_nums[f] = frame_num
            idr_ids[f] = self.idr_pic_id
            hvs[f], hls[f] = self._hdr_arrays(idr, int(qp_f), frame_num,
                                              self.idr_pic_id)
            self._advance_state(idr)
            self.frame_idx += 1
            have_ref = True

        prev_ref = self._ref
        if prev_ref is None:
            prev_ref = (
                torch.zeros((self.height, self.width), dtype=torch.uint8,
                            device=self.device),
                torch.zeros((self.height // 2, self.width // 2),
                            dtype=torch.uint8, device=self.device),
                torch.zeros((self.height // 2, self.width // 2),
                            dtype=torch.uint8, device=self.device))
        planes = self._planes_fn(frames, source, indices)
        row_bytes, streams, recons = encode_run_packed(
            self._launching(planes), idr_flags, qp_arr, qpc_arr,
            torch.as_tensor(hvs, device=self.device),
            torch.as_tensor(hls, device=self.device),
            prev_ref, capw=self._capw, totcap=self._totcap,
            deblock=self.deblock)
        self._ref = recons[-1]
        get_host = self._to_host(row_bytes, streams)

        return [self._make_run_pending(
            f, bool(idr_flags[f]), int(qp_arr[f]), int(qpc_arr[f]),
            int(frame_nums[f]), int(idr_ids[f]), get_host, recons,
            prev_ref, planes) for f in range(nf)]

    def _to_host(self, row_bytes: torch.Tensor, streams: torch.Tensor):
        """Start the run's device->host copy of the row byte counts;
        return a function that waits for it, copies each frame's used
        stream words (its rows' padded words, at most W = totcap/4)
        behind it, waits for those, and yields (row_bytes (F, R) int64,
        streams (F, W) uint32 numpy arrays; words past a frame's used
        count are not copied). Later calls return the same arrays."""
        nf, r = row_bytes.shape
        if self.device.type != "cuda":
            rb, st = row_bytes.numpy(), streams.numpy().view(np.uint32)
            return lambda: (rb, st)
        w = streams.shape[1]
        # one pinned buffer: F*R row byte counts, then F*W stream words
        host = torch.empty(nf * r + nf * w, dtype=torch.int32,
                           pin_memory=True)
        host[:nf * r].view(nf, r).copy_(row_bytes.to(torch.int32),
                                        non_blocking=True)
        counts_done = torch.cuda.Event()
        counts_done.record()
        got = []

        def get():
            if not got:
                counts_done.synchronize()
                a = host.numpy()
                rb = a[:nf * r].reshape(nf, r).astype(np.int64)
                used = np.minimum(((rb + 3) >> 2).sum(1), w)
                words = host[nf * r:].view(nf, w)
                for f, n in enumerate(used.tolist()):
                    words[f, :n].copy_(streams[f, :n], non_blocking=True)
                words_done = torch.cuda.Event()
                words_done.record()
                words_done.synchronize()
                got.append((rb, a[nf * r:].reshape(nf, w).view(np.uint32)))
            return got[0]
        return get

    def _make_run_pending(self, f, idr, qp, qp_c, frame_num, idr_pic_id,
                          get_host, recons, run_ref, planes) -> PendingFrame:
        def finish() -> EncodedFrame:
            rb_all, st_all = get_host()
            row_bytes = rb_all[f]
            row_words = (row_bytes + 3) >> 2
            used = int(row_words.sum())
            recon_f = recons[f]
            if (used > self._totcap // 4
                    or int(row_bytes.max()) > self._capw * 4):
                # capacity overflow: redo this frame on the exact host
                # entropy path, referencing the in-run reconstruction
                self.fallback_frames += 1
                ref = run_ref if f == 0 else recons[f - 1]
                data, _ = self._encode_host_path(
                    *planes(f), qp, qp_c, idr, frame_num, idr_pic_id, ref)
                return EncodedFrame(data=data, keyframe=idr, qp=qp,
                                    _recon_dev=recon_f)
            # device words are MSB-first byte containers
            stream = st_all[f, :used].astype(">u4").tobytes()
            nals = []
            off = 0
            ref_idc, ntype = (3, NAL_IDR) if idr else (2, NAL_SLICE)
            for row in range(self.mbh):
                rb = int(row_bytes[row])
                nals.append(nal_unit(ref_idc, ntype, stream[off:off + rb],
                                     long_start_code=(row == 0)))
                off += int(row_words[row]) * 4
            return EncodedFrame(data=b"".join(nals), keyframe=idr, qp=qp,
                                _recon_dev=recon_f)

        return PendingFrame(finish, idr, qp)

    def _encode_run_cabac(self, frames, qp, qps, source, indices,
                          force_idr: bool) -> list[PendingFrame]:
        """CABAC run scheduler: an IDR frame goes alone through
        encode_idr_syntax, a P span as one loop through
        encode_run_syntax_p (the JAX split); each span's packed rows go
        to the host in one pinned buffer, and the native row coder
        finishes each frame on .result()."""
        nf = len(frames) if frames is not None else len(indices)
        if nf == 0:
            return []

        # split mixed runs at IDR boundaries
        sim_pos, sim_have = self._gop_pos, self._ref is not None
        flags = []
        for f in range(nf):
            idr = ((force_idr and f == 0) or not sim_have
                   or sim_pos >= self.gop)
            flags.append(idr)
            sim_pos = 1 if idr else sim_pos + 1
            sim_have = True
        if any(flags) and nf > 1:
            cuts = [f for f in range(nf) if flags[f]]
            bounds = sorted({0, nf} | set(cuts) | {c + 1 for c in cuts})
            pend: list[PendingFrame] = []
            for a, b in zip(bounds, bounds[1:]):
                pend += self._encode_run_cabac(
                    None if frames is None else frames[a:b],
                    qp,
                    None if qps is None else qps[a:b],
                    source,
                    None if indices is None else list(indices)[a:b],
                    flags[a])
            return pend
        idr_run = bool(flags[0])        # single IDR, or pure-P span

        qp_a = np.zeros(nf, np.int64)
        qpc_a = np.zeros(nf, np.int64)
        fnum_a = np.zeros(nf, np.int64)
        ipid_a = np.zeros(nf, np.int64)
        for f in range(nf):
            qp_f = (qps[f] if qps is not None
                    else (self.qp if qp is None else qp))
            qp_a[f] = qp_f
            qpc_a[f] = chroma_qp(int(qp_f), self.chroma_qp_offset)
            fnum_a[f] = 0 if flags[f] else self.frame_num
            ipid_a[f] = self.idr_pic_id
            self._advance_state(flags[f])
            self.frame_idx += 1

        prev_ref = self._ref
        planes = self._planes_fn(frames, source, indices)
        launch = self._launching(planes)
        if idr_run:
            chunk = self._cabac_idr_chunk
            cap = max(self._cabac_cap, 2 * chunk)
            packed, rest, recon = cabac_run.encode_idr_syntax(
                *launch(0), int(qp_a[0]), int(qpc_a[0]), cap=cap,
                chunk=chunk, deblock=self.deblock)
            recons = [recon]
        else:
            chunk = cabac_run.CHUNK
            cap = self._cabac_cap
            if prev_ref is None:      # unreachable: flags[0] would be IDR
                raise AssertionError("P run without a reference")
            packed, rest, recons = cabac_run.encode_run_syntax_p(
                launch, qp_a, qpc_a, prev_ref, cap=cap, chunk=chunk,
                deblock=self.deblock, intra_in_p=self.intra_in_p)
        self._ref = recons[-1]
        get_host = self._cabac_to_host(packed, rest, cap, chunk)
        return [self._make_cabac_pending(
            f, bool(flags[f]), int(qp_a[f]), int(qpc_a[f]), int(fnum_a[f]),
            int(ipid_a[f]), get_host, cap, chunk, recons, prev_ref, planes)
            for f in range(nf)]

    def _cabac_to_host(self, packed: torch.Tensor, rest: torch.Tensor,
                       cap: int, chunk: int):
        """Start the copy of a run's packed rows into one pinned host
        buffer (non-blocking); return a function that waits for it
        once, then copies behind it, into the same buffer, only the
        level chunks past chunk 0 that each frame's nnz needs (none for
        a frame that overflowed cap), waits for those, and yields (rows
        (F, L) uint8, get_chunk) for cabac_run.unpack_syntax."""
        nf, length = packed.shape
        extra = rest.shape[1]

        def chunks(lv):
            return lambda c: lv[:, c * chunk:(c + 1) * chunk]
        if self.device.type != "cuda":
            rows, lv = packed.numpy(), rest.numpy()
            return lambda: (rows, chunks(lv))
        host = torch.empty(nf * length + nf * extra * 4, dtype=torch.uint8,
                           pin_memory=True)
        host[:nf * length].view(nf, length).copy_(packed, non_blocking=True)
        rows_done = torch.cuda.Event()
        rows_done.record()
        lv_host = host[nf * length:].view(torch.int16).view(nf, extra, 2)
        got = []

        def get():
            if not got:
                rows_done.synchronize()
                rows = host[:nf * length].numpy().reshape(nf, length)
                nnz = rows[:, :4].copy().view(np.int32)[:, 0]
                for f, n in enumerate(nnz.tolist()):
                    used = (0 if n > cap
                            else max(0, -(-n // chunk) - 1) * chunk)
                    if used:
                        lv_host[f, :used].copy_(rest[f, :used],
                                                non_blocking=True)
                lv_done = torch.cuda.Event()
                lv_done.record()
                lv_done.synchronize()
                got.append((rows, chunks(lv_host.numpy())))
            return got[0]
        return get

    def _make_cabac_pending(self, f, idr, qp, qp_c, frame_num, idr_pic_id,
                            get_host, cap, chunk, recons, run_ref,
                            planes) -> PendingFrame:
        def finish() -> EncodedFrame:
            rows, get_chunk = get_host()
            _, arrays = cabac_run.unpack_syntax(rows[f], get_chunk, f,
                                                self.mbh, self.mbw, idr,
                                                cap, chunk)
            if arrays is None:
                # capacity overflow: redo this frame on the exact dense
                # host path, referencing the in-run reconstruction
                self.fallback_frames += 1
                ref = run_ref if f == 0 else recons[f - 1]
                data, _ = self._encode_host_path(
                    *planes(f), qp, qp_c, idr, frame_num, idr_pic_id, ref)
            elif idr:
                data = assemble_i_snake(
                    arrays, qp, idr_pic_id, self.mbh, self.mbw,
                    self.pps.pic_init_qp, self.deblock,
                    self.sps.log2_max_frame_num)
            else:
                data = assemble_p_snake(
                    arrays, qp, frame_num, self.mbh, self.mbw,
                    self.pps.pic_init_qp, self.deblock,
                    self.sps.log2_max_frame_num)
            return EncodedFrame(data=data, keyframe=idr, qp=qp,
                                _recon_dev=recons[f])

        return PendingFrame(finish, idr, qp)

    def _advance_state(self, idr: bool) -> None:
        if idr:
            self.frame_num = 1          # IDR was frame_num 0
            self._gop_pos = 1
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        else:
            self.frame_num = (self.frame_num + 1) % (
                1 << self.sps.log2_max_frame_num)
            self._gop_pos += 1

    def _encode_host_path(self, y, u, v, qp: int, qp_c: int, idr: bool,
                          frame_num: int, idr_pic_id: int, prev_ref):
        """Exact host-entropy path: device compute, dense arrays on the
        host, host CABAC (native row coder) or CAVLC. Does not touch
        self._ref (later frames may already be in flight)."""
        if idr:
            outs = encode_frame_i16_rows(y, u, v, qp, qp_c)
            recon = outs["recon"]
            if self.deblock:
                zero_nnz = torch.zeros((self.mbh, self.mbw, 4, 4),
                                       dtype=torch.int32, device=y.device)
                zero_mv = torch.zeros((self.mbh, self.mbw, 2),
                                      dtype=torch.int32, device=y.device)
                recon = deblock_frame_rows(*recon, zero_nnz, zero_mv,
                                           qp, qp_c, intra_frame=True)
        else:
            outs = encode_frame_p(y, u, v, *prev_ref, qp, qp_c,
                                  intra_in_p=self.intra_in_p)
            recon = outs["recon"]
            if self.deblock:
                nnz44 = (outs["luma_levels"] != 0).any(-1).to(torch.int32)
                recon = deblock_frame_rows(*recon, nnz44, outs["mv"],
                                           qp, qp_c, intra_frame=False,
                                           intra_mb=outs.get("is_intra"))
        outs_np = {k: o.cpu().numpy() for k, o in outs.items()
                   if not isinstance(o, tuple)}
        hdr = (self.mbh, self.mbw, self.pps.pic_init_qp, self.deblock,
               self.sps.log2_max_frame_num)
        if idr and self.cabac:
            data = assemble_i_cabac(outs_np, qp, idr_pic_id, *hdr)
        elif self.cabac:
            data = assemble_p_cabac(outs_np, qp, frame_num, *hdr)
        elif idr:
            data = self._assemble(outs_np, qp, idr_pic_id)
        else:
            data = self._assemble_p(outs_np, qp, frame_num)
        return data, recon

    # ------------------------------------------------------------------
    def _assemble(self, outs: dict, qp: int,
                  idr_pic_id: int) -> bytes:
        mbh, mbw = self.mbh, self.mbw
        n = mbh * mbw

        ac_luma = outs["ac_luma"].reshape(mbh, mbw, 4, 4, 15)
        dc_luma = outs["dc_luma"].reshape(n, 16)
        dc_chroma = outs["dc_chroma"]          # (mbh, mbw, 2, 4)
        ac_chroma = outs["ac_chroma"]          # (mbh, mbw, 2, 2, 2, 15)

        # --- coded block patterns
        cbp_luma = (ac_luma.reshape(n, -1) != 0).any(axis=1).astype(np.int64) * 15
        any_cac = (ac_chroma.reshape(n, -1) != 0).any(axis=1)
        any_cdc = (dc_chroma.reshape(n, -1) != 0).any(axis=1)
        cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0))

        # --- nC derivation from per-4x4 TotalCoeff grids
        # luma: (mbh*4, mbw*4) grid of AC-token TotalCoeffs
        luma_nnz = (ac_luma != 0).sum(axis=-1)             # (mbh,mbw,4,4)
        luma_nnz = luma_nnz.swapaxes(1, 2).reshape(mbh * 4, mbw * 4)
        nc_luma = _neighbor_nc(luma_nnz, 4, same_row_only=True)
        # luma DC block uses the nC of block (0,0) of the MB
        nc_dc = nc_luma[::4, ::4].reshape(n)

        chroma_nnz = (ac_chroma != 0).sum(axis=-1)         # (mbh,mbw,2,2,2)
        nc_chroma = np.empty((2, mbh * 2, mbw * 2), np.int64)
        for comp in range(2):
            g = chroma_nnz[:, :, comp].swapaxes(1, 2).reshape(mbh * 2, mbw * 2)
            nc_chroma[comp] = _neighbor_nc(g, 2, same_row_only=True)

        # --- CAVLC symbol generation (all blocks of the frame at once)
        v_dc, l_dc, _ = cavlc.encode_blocks(dc_luma, nc_dc, 16)

        # luma AC in snake order with matching nC
        snake_r, snake_c = LUMA_SNAKE[:, 0], LUMA_SNAKE[:, 1]
        ac_snake = ac_luma[:, :, snake_r, snake_c].reshape(n * 16, 15)
        nc_grid = nc_luma.reshape(mbh, 4, mbw, 4).swapaxes(1, 2)
        nc_ac = nc_grid[:, :, snake_r, snake_c].reshape(n * 16)
        v_ac, l_ac, _ = cavlc.encode_blocks(ac_snake, nc_ac, 15)
        # mask out AC blocks when cbp_luma == 0
        l_ac = l_ac.reshape(n, 16, S) * (cbp_luma > 0)[:, None, None]

        cdc = dc_chroma.reshape(n * 2, 4)
        v_cdc, l_cdc, _ = cavlc.encode_blocks(cdc, np.full(n * 2, -1), 4)
        l_cdc = l_cdc.reshape(n, 2, S) * (cbp_chroma > 0)[:, None, None]

        # chroma AC: per comp, raster order within the 8x8
        cac = ac_chroma.reshape(n, 2, 4, 15).reshape(n * 8, 15)
        nc_cac = np.empty((2, mbh, mbw, 2, 2), np.int64)
        for comp in range(2):
            nc_cac[comp] = (nc_chroma[comp]
                            .reshape(mbh, 2, mbw, 2).swapaxes(1, 2))
        # order: MB-major, then comp, then 4 blocks raster
        nc_cac = nc_cac.transpose(1, 2, 0, 3, 4).reshape(n * 8)
        v_cac, l_cac, _ = cavlc.encode_blocks(cac, nc_cac, 15)
        l_cac = l_cac.reshape(n, 8, S) * (cbp_chroma == 2)[:, None, None]

        # --- MB header symbols
        mode_l = outs["mode_luma"].reshape(n).astype(np.int64)
        mode_c = outs["mode_chroma"].reshape(n).astype(np.int64)
        mb_type = 1 + mode_l + 4 * cbp_chroma + 12 * (cbp_luma == 15)
        v_mt, l_mt = ue_code(mb_type)
        v_cm, l_cm = ue_code(mode_c)
        # mb_qp_delta == 0 for constant-QP slices: se(0) -> ue(0)
        v_qpd = np.ones(n, np.uint32)
        l_qpd = np.ones(n, np.int32)

        # --- assemble fixed-slot symbol matrix per MB
        vals = np.zeros((n, MB_SLOTS_I), np.uint32)
        lens = np.zeros((n, MB_SLOTS_I), np.int32)
        vals[:, 0], lens[:, 0] = v_mt, l_mt
        vals[:, 1], lens[:, 1] = v_cm, l_cm
        vals[:, 2], lens[:, 2] = v_qpd, l_qpd
        o = 3
        vals[:, o:o + S], lens[:, o:o + S] = v_dc, l_dc
        o += S
        vals[:, o:o + 16 * S] = v_ac.reshape(n, 16 * S)
        lens[:, o:o + 16 * S] = l_ac.reshape(n, 16 * S)
        o += 16 * S
        vals[:, o:o + 2 * S] = v_cdc.reshape(n, 2 * S)
        lens[:, o:o + 2 * S] = l_cdc.reshape(n, 2 * S)
        o += 2 * S
        vals[:, o:o + 8 * S] = v_cac.reshape(n, 8 * S)
        lens[:, o:o + 8 * S] = l_cac.reshape(n, 8 * S)

        vals = vals.reshape(mbh, mbw * MB_SLOTS_I)
        lens = lens.reshape(mbh, mbw * MB_SLOTS_I)

        # --- one slice per MB row
        nals = []
        for row in range(mbh):
            hdr = write_slice_header(SliceConfig(
                first_mb=row * mbw, slice_type=SLICE_I_ALL, frame_num=0,
                idr=True, idr_pic_id=idr_pic_id, qp=qp,
                pic_init_qp=self.pps.pic_init_qp,
                deblock_idc=2 if self.deblock else 1))
            hv, hl = hdr.arrays()
            rv = np.concatenate([hv.astype(np.uint32), vals[row]])
            rl = np.concatenate([hl, lens[row]])
            # rbsp stop bit + alignment
            total = int(rl.sum())
            pad = (-(total + 1)) % 8
            stop_v = np.array([1 << pad], np.uint32)
            stop_l = np.array([1 + pad], np.int32)
            payload = pack_bits(np.concatenate([rv, stop_v]),
                                np.concatenate([rl, stop_l]))
            nals.append(nal_unit(3, NAL_IDR, payload,
                                 long_start_code=(row == 0)))
        return b"".join(nals)

    # ------------------------------------------------------------------
    def _assemble_p(self, outs: dict, qp: int, frame_num: int) -> bytes:
        """P-slice assembly: P_L0_16x16 + P_Skip, one slice per MB row
        (spec 7.3.4/7.4.4; MV prediction 8.4.1.3 under slice-row
        neighbor availability)."""
        mbh, mbw = self.mbh, self.mbw
        n = mbh * mbw

        mvg = outs["mv"].astype(np.int64)               # (mbh, mbw, 2) dy,dx
        ll = outs["luma_levels"].reshape(mbh, mbw, 4, 4, 16)
        dc_chroma = outs["dc_chroma"]                   # (mbh, mbw, 2, 4)
        ac_chroma = outs["ac_chroma"]                   # (mbh, mbw, 2, 2, 2, 15)

        # --- coded block pattern
        nz44 = (ll != 0).any(-1)                        # (mbh, mbw, 4, 4)
        qbits = np.zeros((mbh, mbw, 4), np.int64)
        for q in range(4):
            r0, c0 = 2 * (q // 2), 2 * (q % 2)
            qbits[..., q] = nz44[:, :, r0:r0 + 2, c0:c0 + 2].any((-1, -2))
        cbp_luma = (qbits << np.arange(4)).sum(-1)      # (mbh, mbw)
        any_cac = (ac_chroma != 0).reshape(mbh, mbw, -1).any(-1)
        any_cdc = (dc_chroma != 0).reshape(mbh, mbw, -1).any(-1)
        cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0))
        cbp = cbp_luma | (cbp_chroma << 4)

        # --- MV prediction (slice-row: top/topright unavailable =>
        # pmv = left MB's mv, 0 for the first MB; spec 8.4.1.3.1)
        pmv = np.zeros_like(mvg)
        pmv[:, 1:] = mvg[:, :-1]
        # mv/mvd are in quarter-pel units throughout (spec 7.4.5.1)
        mvd = mvg - pmv

        # --- P_Skip: mv equals the skip predictor (always (0,0) with the
        # top row unavailable, spec 8.4.1.1) and cbp == 0
        skip = (mvg[..., 0] == 0) & (mvg[..., 1] == 0) & (cbp == 0)

        # mb_skip_run before each non-skip MB (per slice = per row)
        run_val = np.zeros((mbh, mbw), np.int64)
        trailing = np.zeros(mbh, np.int64)
        for r in range(mbh):
            idx = np.nonzero(~skip[r])[0]
            prev = np.concatenate([[-1], idx[:-1]])
            run_val[r, idx] = idx - prev - 1
            trailing[r] = mbw - 1 - (idx[-1] if idx.size else -1)

        coded = ~skip.reshape(n)

        # --- nC from 16-coeff TotalCoeffs
        nnz = (ll != 0).sum(-1)                         # (mbh, mbw, 4, 4)
        grid = nnz.swapaxes(1, 2).reshape(mbh * 4, mbw * 4)
        nc_luma = _neighbor_nc(grid, 4, same_row_only=True)
        nc_grid = nc_luma.reshape(mbh, 4, mbw, 4).swapaxes(1, 2)

        snake_r, snake_c = LUMA_SNAKE[:, 0], LUMA_SNAKE[:, 1]
        blocks = ll[:, :, snake_r, snake_c].reshape(n * 16, 16)
        nc_blk = nc_grid[:, :, snake_r, snake_c].reshape(n * 16)
        v_l, l_l, _ = cavlc.encode_blocks(blocks, nc_blk, 16)
        # mask: block coded iff its quadrant bit set and MB not skipped
        blk_q = np.arange(16) // 4                      # snake: 4 per 8x8
        blk_coded = (qbits.reshape(n, 4)[:, blk_q] > 0) & coded[:, None]
        l_l = l_l.reshape(n, 16, S) * blk_coded[:, :, None]

        cdc = dc_chroma.reshape(n * 2, 4)
        v_cdc, l_cdc, _ = cavlc.encode_blocks(cdc, np.full(n * 2, -1), 4)
        l_cdc = (l_cdc.reshape(n, 2, S)
                 * ((cbp_chroma.reshape(n) > 0) & coded)[:, None, None])

        chroma_nnz = (ac_chroma != 0).sum(-1)
        nc_cac = np.empty((2, mbh * 2, mbw * 2), np.int64)
        for comp in range(2):
            g = chroma_nnz[:, :, comp].swapaxes(1, 2).reshape(mbh * 2, mbw * 2)
            nc_cac[comp] = _neighbor_nc(g, 2, same_row_only=True)
        nc_cac_g = np.stack([nc_cac[c].reshape(mbh, 2, mbw, 2).swapaxes(1, 2)
                             for c in range(2)])
        nc_cac_flat = nc_cac_g.transpose(1, 2, 0, 3, 4).reshape(n * 8)
        cac = ac_chroma.reshape(n * 8, 15)
        v_cac, l_cac, _ = cavlc.encode_blocks(cac, nc_cac_flat, 15)
        l_cac = (l_cac.reshape(n, 8, S)
                 * ((cbp_chroma.reshape(n) == 2) & coded)[:, None, None])

        # --- header symbols
        v_run, l_run = ue_code(run_val.reshape(n))
        v_mt, l_mt = ue_code(np.zeros(n, np.int64))     # P_L0_16x16
        v_mvx, l_mvx = se_code(mvd[..., 1].reshape(n))  # x first
        v_mvy, l_mvy = se_code(mvd[..., 0].reshape(n))
        cbp_code = CBP_INTER_TO_CODE[cbp.reshape(n)]
        v_cbp, l_cbp = ue_code(cbp_code)
        has_qpd = (cbp.reshape(n) > 0)

        vals = np.zeros((n, MB_SLOTS_P), np.uint32)
        lens = np.zeros((n, MB_SLOTS_P), np.int32)
        vals[:, 0], lens[:, 0] = v_run, l_run * coded
        vals[:, 1], lens[:, 1] = v_mt, l_mt * coded
        vals[:, 2], lens[:, 2] = v_mvx, l_mvx * coded
        vals[:, 3], lens[:, 3] = v_mvy, l_mvy * coded
        vals[:, 4], lens[:, 4] = v_cbp, l_cbp * coded
        vals[:, 5] = 1                                  # se(0)
        lens[:, 5] = (has_qpd & coded).astype(np.int32)
        o = 6
        vals[:, o:o + 16 * S] = v_l.reshape(n, 16 * S)
        lens[:, o:o + 16 * S] = l_l.reshape(n, 16 * S)
        o += 16 * S
        vals[:, o:o + 2 * S] = v_cdc.reshape(n, 2 * S)
        lens[:, o:o + 2 * S] = l_cdc.reshape(n, 2 * S)
        o += 2 * S
        vals[:, o:o + 8 * S] = v_cac.reshape(n, 8 * S)
        lens[:, o:o + 8 * S] = l_cac.reshape(n, 8 * S)

        vals = vals.reshape(mbh, mbw * MB_SLOTS_P)
        lens = lens.reshape(mbh, mbw * MB_SLOTS_P)

        nals = []
        for row in range(mbh):
            hdr = write_slice_header(SliceConfig(
                first_mb=row * mbw, slice_type=SLICE_P_ALL,
                frame_num=frame_num, idr=False, qp=qp,
                pic_init_qp=self.pps.pic_init_qp,
                deblock_idc=2 if self.deblock else 1))
            hv, hl = hdr.arrays()
            parts_v = [hv.astype(np.uint32), vals[row]]
            parts_l = [hl, lens[row]]
            if trailing[row] > 0:
                tv, tl = ue_code(np.array([trailing[row]]))
                parts_v.append(tv)
                parts_l.append(tl)
            rv = np.concatenate(parts_v)
            rl = np.concatenate(parts_l)
            total = int(rl.sum())
            pad = (-(total + 1)) % 8
            rv = np.concatenate([rv, np.array([1 << pad], np.uint32)])
            rl = np.concatenate([rl, np.array([1 + pad], np.int32)])
            payload = pack_bits(rv, rl)
            nals.append(nal_unit(2, NAL_SLICE, payload,
                                 long_start_code=(row == 0)))
        return b"".join(nals)
