"""Sharded HEVC encode: streams x CTB-row bands over a device mesh, with
halo exchange; and the GOP-parallel stream encoder.

Port of ceracoder_tpu/parallel/hevc.py. The JAX package runs one
`shard_map` program per band and trades halos with `ppermute`; the port
runs in one process and launches each band on its own device in turn
(parallel/mesh.py), copying a halo to the band's device with a
non-blocking `.to`. The tile-row coding schedule makes the bands'
coding independent; what crosses a seam is what the codec reads:

- motion search and compensation read LUMA_SRC_PAD reference rows (luma)
  and CHROMA_PAD rows (chroma) past the band (`_halo_rows`);
- the deblock reads up to 4 rows across a seam (`_deblock_banded`).

Outputs equal the single-device ops for any split of the CTB rows into
bands, so the gathered per-CTB arrays feed the same native entropy
stage. Unlike the JAX `ShardedH265Encoder`, the port's does not round
the CTB rows up to a multiple of the band count (that codes extra rows
and breaks its stream's identity with a single-device encode): bands
take whole CTB rows, their counts differing by at most one
(parallel/mesh.py: band_bounds).
"""

from __future__ import annotations

import contextlib

import torch

from ceracoder_tpu_torch.codec.h264.encoder import EncodedFrame
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.codec.h265.rowslice import entropy_rows_native
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
    CHROMA_PAD,
    CTB,
    I32,
    LUMA_SRC_PAD,
    _i_frame_core,
    _p_motion,
    _p_tail,
    _pad_edge,
    deblock_frame_dev,
)
from ceracoder_tpu_torch.parallel.mesh import (
    available_devices,
    band_bounds,
    make_mesh,
    stream_devices,
)
from ceracoder_tpu_torch.utils.device import upload

# the per-CTB arrays of a frame, in the JAX step's order
KEYS = ("is_intra", "mode", "mv", "tu_split", "luma_lv", "cb_lv", "cr_lv")
# per plane (y, u, v): its rows in a CTB row, and the reference rows that
# a P frame's motion reads past a band's edge
CTB_ROWS = (CTB, CTB // 2, CTB // 2)
HALO = (LUMA_SRC_PAD, CHROMA_PAD, CHROMA_PAD)


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device (a no-op for the CPU), so that
    work without an explicit device, such as a kernel wrapper's current
    stream, goes to it."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _with_neighbours(parts: list, i: int, n: int) -> torch.Tensor:
    """parts[i] (leading axis: rows) with the last n rows of parts[i - 1]
    above it and the first n rows of parts[i + 1] below it, where those
    bands exist, copied to parts[i]'s device."""
    x = parts[i]
    seq = [x]
    if i > 0:
        seq.insert(0, parts[i - 1][-n:].to(x.device, non_blocking=True))
    if i < len(parts) - 1:
        seq.append(parts[i + 1][:n].to(x.device, non_blocking=True))
    return torch.cat(seq)


def _halo_rows(bands: list, k: int) -> list:
    """The row bands of one (H, W) plane, top to bottom, each extended by
    k rows above and below: the neighbour band's rows, copied to the
    band's device; the outermost bands replicate their border row (==
    the single-device picture-edge padding). k must not exceed a
    neighbour's height."""
    n = len(bands)
    return [_pad_edge(_with_neighbours(bands, i, k), k if i == 0 else 0,
                      k if i == n - 1 else 0, 0, 0) for i in range(n)]


def _deblock_banded(outs: list, qp: int, tu_split: bool) -> list:
    """Deblock each band's reconstruction (outs[b]["recon"], with its
    per-CTB arrays) as deblock_frame_dev deblocks the whole picture.

    The band is extended by the neighbours' adjacent CTB row (their
    unfiltered reconstruction and per-CTB arrays, copied to its device),
    filtered by deblock_frame_dev, and cropped back. The vertical edges
    are row-local, so the halo rows come out of the first pass as they
    do in the whole picture; the seam's horizontal edge then sees the
    same 4 rows on each side, and no edge that the crop keeps reaches
    past the halo. With `tu_split` the split CUs' interior TU edges are
    filtered too (a P frame's options as encode_frame_row passes them).
    Returns per band the filtered uint8 (y, u, v)."""
    cbf = [(o["luma_lv"] != 0).flatten(2).any(-1) for o in outs]
    res = []
    for b, o in enumerate(outs):
        with on_device(o["is_intra"].device):
            rec = [_with_neighbours([p["recon"][i] for p in outs], b, n)
                   for i, n in enumerate(CTB_ROWS)]

            def meta(k):
                return _with_neighbours([p[k] for p in outs], b, 1)
            split = ({"tu_split": meta("tu_split"), "luma_lv": meta("luma_lv")}
                     if tu_split else {})
            filt = deblock_frame_dev(*rec, meta("is_intra"),
                                     _with_neighbours(cbf, b, 1), meta("mv"),
                                     qp, **split)
        top = 1 if b > 0 else 0
        nch = o["is_intra"].shape[0]
        res.append(tuple(p[top * n:(top + nch) * n]
                         for p, n in zip(filt, CTB_ROWS)))
    return res


def _encode_bands(planes: list, refs: list | None, qp: int, qp_c: int,
                  idr: bool, deblock: bool = True,
                  tu_split: bool = False) -> list:
    """One frame of one stream over its CTB-row bands: planes[b] band b's
    (y, u, v) uint8 on its device, refs[b] the reference's band (None for
    an IDR). A band's IDR is _i_frame_core (K4 on a card), its P frame
    _p_motion over the halo-extended, edge-padded reference and then
    _p_tail. Returns per band the core's per-CTB arrays and "recon",
    deblocked where `deblock` (the TU split's interior edges with
    `tu_split`)."""
    if not idr:
        halos = [_halo_rows([r[i] for r in refs], k)
                 for i, k in enumerate(HALO)]
    outs = []
    for b, (y, u, v) in enumerate(planes):
        with on_device(y.device):
            if idr:
                o = _i_frame_core(y, u, v, qp, qp_c)
            else:
                ref_pad = [_pad_edge(h[b].to(I32), 0, 0, k, k)
                           for h, k in zip(halos, HALO)]
                o = _p_tail(y, u, v, *_p_motion(y, *ref_pad), qp, qp_c,
                            tu_split)
        outs.append(o)
    if deblock:
        for o, rec in zip(outs, _deblock_banded(outs, qp,
                                                tu_split and not idr)):
            o["recon"] = rec
    return outs


def _nonzero(o: dict) -> torch.Tensor:
    """A band's count of nonzero levels (int32 scalar)."""
    return sum((o[k] != 0).sum(dtype=torch.int32)
               for k in ("luma_lv", "cb_lv", "cr_lv"))


def _split_bands(planes, bounds, devices) -> list:
    """(y, u, v) of one frame -> per band its rows on its device."""
    return [tuple(p[r0 * n:r1 * n].to(dev, non_blocking=True)
                  for p, n in zip(planes, CTB_ROWS))
            for (r0, r1), dev in zip(bounds, devices)]


def hevc_sharded_step_t(mesh, idr: bool = False, deblock: bool = True,
                        tu_split: bool = False):
    """Build the sharded HEVC encode step over the mesh's (streams,
    rows), QP given per call.

    Inputs: y (S, H, W), u, v (S, H/2, W/2) uint8 planes and the
    previous deblocked reconstruction (same shapes; read by P frames
    only), tensors or arrays, then qp, qp_c. The streams split over the
    mesh's (stream_devices), the CTB rows into its row bands
    (band_bounds). Returns the per-CTB arrays (KEYS) and "recon",
    gathered on the mesh's first device with a leading stream axis, and
    the per-stream count of nonzero levels summed over the bands, (S,)
    int32. Equal to the single-device ops for any band split."""
    n_rows = mesh.shape["rows"]
    home = mesh.devices[0][0]

    def step(y, u, v, ry, ru, rv, qp: int, qp_c: int):
        y, u, v, ry, ru, rv = (torch.as_tensor(p)
                               for p in (y, u, v, ry, ru, rv))
        bounds = band_bounds(y.shape[1] // CTB, n_rows)
        streams, nz = [], []
        for s, devs in enumerate(stream_devices(mesh, y.shape[0])):
            refs = None if idr else _split_bands((ry[s], ru[s], rv[s]),
                                                 bounds, devs)
            outs = _encode_bands(_split_bands((y[s], u[s], v[s]), bounds,
                                              devs),
                                 refs, int(qp), int(qp_c), idr, deblock,
                                 tu_split)
            streams.append(_gather(outs, home))
            nz.append(sum(_nonzero(o).to(home) for o in outs))
        res = {k: torch.stack([st[k] for st in streams]) for k in KEYS}
        res["recon"] = tuple(torch.stack([st["recon"][i] for st in streams])
                             for i in range(3))
        return res, torch.stack(nz)

    return step


def hevc_sharded_step(mesh, qp: int, qp_c: int, idr: bool = False,
                      deblock: bool = True, tu_split: bool = False):
    """hevc_sharded_step_t with a fixed QP: step(y, u, v, ry, ru, rv)."""
    fn = hevc_sharded_step_t(mesh, idr=idr, deblock=deblock,
                             tu_split=tu_split)

    def call(y, u, v, ry, ru, rv):
        return fn(y, u, v, ry, ru, rv, qp, qp_c)

    return call


def _gather(outs: list, home: torch.device) -> dict:
    """Per-band outputs -> whole-frame arrays (KEYS, "recon") on `home`."""
    res = {k: torch.cat([o[k].to(home) for o in outs]) for k in KEYS}
    res["recon"] = tuple(torch.cat([o["recon"][i].to(home) for o in outs])
                         for i in range(3))
    return res


class ShardedH265Encoder:
    """App-facing banded encoder: one frame's CTB-row bands across
    devices with halo exchange, the H265DeviceEncoder surface (headers,
    encode_frame, resume, recon) over _encode_bands, feeding the same
    native entropy stage. Byte-identical to the single-device
    H265DeviceEncoder.encode_frame for any band count from 1 to the
    number of CTB rows.

    `devices` (default: every CUDA device, which raises without a card)
    lists at least n_bands devices; band b runs on devices[b], and a
    device listed more than once runs its bands one after another.
    `frames_launched` counts frames whose device work has started (the
    app's stall watchdog reads it)."""

    bframes = 0

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, n_bands: int = 2, devices=None):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 requires even dimensions (the "
                             "conformance window crops in 2-sample "
                             "units)")
        self.width, self.height = width, height
        self.qp = qp
        self.gop = max(1, gop)
        self.devices = make_mesh(1, n_bands, devices).devices[0]
        self.pw = -(-width // CTB) * CTB
        self.ph = -(-height // CTB) * CTB
        self.bounds = band_bounds(self.ph // CTB, n_bands)
        self.params = HevcParams(width=width, height=height, qp=qp,
                                 pcm_enabled=False, deblock=True,
                                 tile_rows=True)
        self._ref = None              # per band: its reference planes
        self._poc = 0
        self.frames_launched = 0

    def headers(self) -> bytes:
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def resume(self) -> None:
        """Drop the reference and GOP position: the next frame codes as
        a fresh IDR."""
        self._ref = None
        self._poc = 0

    def _pad(self, plane, h: int, w: int) -> torch.Tensor:
        """A plane on the first band's device, edge-padded on the
        bottom/right to (h, w)."""
        plane = upload(plane, self.devices[0])
        ph, pw = plane.shape
        if (ph, pw) == (h, w):
            return plane
        return _pad_edge(plane, 0, h - ph, 0, w - pw)

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False) -> EncodedFrame:
        qp = self.qp if qp is None else qp
        idr = force_idr or self._ref is None or self._poc >= self.gop
        poc = 0 if idr else self._poc
        self._poc = 1 if idr else self._poc + 1
        self.frames_launched += 1

        planes = (self._pad(y, self.ph, self.pw),
                  self._pad(u, self.ph // 2, self.pw // 2),
                  self._pad(v, self.ph // 2, self.pw // 2))
        outs = _encode_bands(_split_bands(planes, self.bounds, self.devices),
                             self._ref, qp, chroma_qp(qp), idr)
        self._ref = [o["recon"] for o in outs]
        whole = _gather(outs, self.devices[0])
        # levels as int16 (the entropy stage's type) halve the copy
        arrays = {k: whole[k].to(torch.int16 if k.endswith("_lv")
                                 else whole[k].dtype).cpu().numpy()
                  for k in KEYS}
        rbsps = entropy_rows_native(self.params, arrays, qp, idr=idr, poc=poc)
        ntype = NAL_IDR_W_RADL if idr else NAL_TRAIL_R
        data = b"".join(nal_unit(ntype, r, long_start_code=(i == 0))
                        for i, r in enumerate(rbsps))
        return EncodedFrame(data=data, keyframe=idr, qp=qp,
                            _recon_dev=whole["recon"])

    @property
    def recon(self):
        """Cropped reconstruction of the last encoded frame (host)."""
        if self._ref is None:
            return None
        ry, ru, rv = (torch.cat([r[i].cpu() for r in self._ref]).numpy()
                      for i in range(3))
        return (ry[:self.height, :self.width],
                ru[:self.height // 2, :self.width // 2],
                rv[:self.height // 2, :self.width // 2])


class GopParallelStreamEncoder:
    """App-facing GOP-parallel encoder: each encode_run_async batch is a
    closed GOP, dispatched round-robin across devices, each with its own
    H265DeviceEncoder (the app's run loop drains run N while run N + 1
    computes on the next device). Byte-identical to a single-device
    encode at the same GOP length, because every GOP is closed.

    `devices` defaults to every CUDA device (raises without a card)."""

    bframes = 0

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, devices=None):
        self.devices = available_devices(devices)
        self.gop = max(1, gop)
        self.qp = qp
        self.encoders = [H265DeviceEncoder(width, height, qp=qp,
                                           gop=self.gop, device=dev)
                         for dev in self.devices]
        self._slot = 0

    @property
    def frames_launched(self) -> int:
        return sum(e.frames_launched for e in self.encoders)

    def headers(self) -> bytes:
        return self.encoders[0].headers()

    def resume(self) -> None:
        for e in self.encoders:
            e.resume()
        self._slot = 0

    def encode_run_async(self, frames=None, qp: int | None = None,
                         force_idr: bool = False, **kw):
        """The run as a closed GOP (an IDR first, whatever `force_idr`)
        on the next device."""
        enc = self.encoders[self._slot]
        self._slot = (self._slot + 1) % len(self.encoders)
        enc.resume()
        with on_device(enc.device):
            return enc.encode_run_async(frames=frames, qp=qp,
                                        force_idr=True, **kw)

    def encode_frame(self, y, u, v, qp: int | None = None,
                     force_idr: bool = False) -> EncodedFrame:
        """The per-frame path is the single-device encode on the first
        device."""
        with on_device(self.encoders[0].device):
            return self.encoders[0].encode_frame(y, u, v, qp=qp,
                                                 force_idr=force_idr)
