"""GOP-parallel encoding: closed GOPs across devices.

Port of ceracoder_tpu/parallel/gop.py. Every GOP starts with an IDR, so
GOPs share no state: whole GOPs go round-robin to devices, each running
its own H265DeviceEncoder (parallel/hevc.py: GopParallelStreamEncoder)
against its own reference chain. Nothing crosses devices. N devices
encode N GOPs at once; the output is re-serialized in display order.
This is the throughput schedule (offline transcode, or a latency of one
GOP); the banded encoder (parallel/hevc.py) is the latency-oriented one.
"""

from __future__ import annotations

import time
from collections import deque

from ceracoder_tpu_torch.parallel.hevc import GopParallelStreamEncoder
from ceracoder_tpu_torch.parallel.mesh import available_devices


class GopParallelEncoder:
    """Encode a clip with whole GOPs distributed across devices.

    GOP g goes to device g % D (a GopParallelStreamEncoder's slots), and
    every GOP's device work is launched before an earlier GOP's results
    are read, so the devices run concurrently. The bitstream is
    byte-identical to a single-device encode with the same GOP length,
    because every GOP is closed. `devices` defaults to every CUDA device
    (raises without a card); a device listed more than once runs its
    GOPs one after another."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 gop: int = 60, devices=None):
        self.stream = GopParallelStreamEncoder(width, height, qp=qp, gop=gop,
                                               devices=devices)
        self.gop = self.stream.gop
        self.devices = self.stream.devices

    def headers(self) -> bytes:
        return self.stream.headers()

    def encode_clip(self, frames=None, source=None, n_frames=None,
                    qp: int | None = None) -> list[bytes]:
        """Encode display-order frames (`frames`, or `n_frames` frames of
        the device source `source`); returns per-frame bitstreams in
        display order. At most one GOP per device is in flight (the
        pending reconstructions and levels are O(devices x gop), not
        O(clip)): a slot's previous GOP is read before it takes the
        next."""
        if frames is None and n_frames is None:
            raise ValueError("source input requires n_frames")
        nf = len(frames) if frames is not None else n_frames
        self.stream.resume()
        in_flight: deque = deque()      # pending runs, in GOP order
        out = []
        for g0 in range(0, nf, self.gop):
            if len(in_flight) >= len(self.devices):
                out.extend(p.result().data for p in in_flight.popleft())
            idx = range(g0, min(g0 + self.gop, nf))
            if frames is not None:
                run = self.stream.encode_run_async([frames[i] for i in idx],
                                                   qp=qp)
            else:
                run = self.stream.encode_run_async(source=source, indices=idx,
                                                   qp=qp)
            in_flight.append(run)
        while in_flight:
            out.extend(p.result().data for p in in_flight.popleft())
        return out


def gop_throughput_scaling(width, height, frames, gop, qp=32, devices=None):
    """Frames/s of encode_clip on one device and on all of `devices`
    (default every CUDA device), each after a warm-up pass over the same
    frames. Returns (fps_1, fps_n, n)."""
    devs = available_devices(devices)
    fps = {}
    for nd in sorted({1, len(devs)}):
        enc = GopParallelEncoder(width, height, qp=qp, gop=gop,
                                 devices=devs[:nd])
        enc.encode_clip(frames)        # warm-up: kernel builds, caches
        t0 = time.perf_counter()
        enc.encode_clip(frames)
        fps[nd] = len(frames) / (time.perf_counter() - t0)
    return fps[1], fps[len(devs)], len(devs)
