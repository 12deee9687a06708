"""The camera app (traffic kind "camera_app"): the product path, from the
camera to the wire.

Set-up: the seeded camera's frames, `ring_gops` whole GOPs, made on the
device and copied to the host as a capture card delivers them; one warm
run of `run` frames through a first encoder; a UDP receiver on loopback
at a port the OS assigns; the port's CeracoderApp (app/main.py) on a job
written from the configuration (its `[source]` at the offered rate, its
`[encode]` GOP and run), sending to that receiver. The job's raw source is
replaced from outside by the camera, which releases frame i at
t0 + i / fps and not before: the app's `_loop_pipelined` takes it, with
its scene-cut IDRs, runs of `run`, TS mux, 1316 B packing, UDP send, its
20 ms housekeeping ticks and its stall watchdog armed.

The window opens at t0, when the app asks for its first frame, and holds
the frames released in the next `--seconds`; the camera goes on for
`tail` frames more, so that the window's last frames leave the packer.
A frame's latency runs from its release until the send call that hands
its last TS packet to the socket returns. `correct` compares what the
receiver got, demuxed, with the reference: a sampled GOP's IDR access
unit (parameter sets and slice), first P frame and P frames drawn from
the seed, each at the QP its slice header states (the app's rate control
sets it; see benchmark/stream.py).
"""

from __future__ import annotations

import math
import shutil
import signal
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchmark.camera import Camera
from benchmark.check import Sample, checks, compare
from benchmark.harness import Run
from benchmark.stream import (
    NAL_IDR_W_RADL,
    nal_type,
    nal_units,
    slice_qp,
    video_access_units,
)
from benchmark.trace import Spans, Tracer


class _Receiver:
    """Datagrams from loopback, kept in order, on a thread of its own."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32 << 20)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.05)
        self.port = self.sock.getsockname()[1]
        self.chunks: list[bytes] = []
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            try:
                self.chunks.append(self.sock.recv(65536))
            except socket.timeout:
                if self._stop:
                    return

    def close(self) -> bytes:
        self._stop = True
        self._thread.join()
        self.sock.close()
        return b"".join(self.chunks)


class _Camera:
    """The app's source: host frames of the ring, frame i released at
    t0 + i / fps, t0 being when the app first asks for a frame."""

    def __init__(self, ring, width, height, fps, total, spans, on_open):
        self.width, self.height = width, height
        self.fps_num, self.fps_den = fps, 1
        self.ring, self.total, self.spans = ring, total, spans
        self.on_open = on_open
        self.t0 = None

    def frames(self):
        self.t0 = time.time()
        self.on_open(self.t0)
        for i in range(self.total):
            wait = self.t0 + i / self.fps_num - time.time()
            if wait > 0:
                with self.spans.span("source", 0):
                    time.sleep(wait)
            yield self.ring[i % len(self.ring)]


def _host_ring(cam: Camera, n: int):
    """n frames of the camera as host numpy planes, copied in bulk."""
    frames = [cam.frame(i) for i in range(n)]
    planes = [torch.stack([f[k] for f in frames]).cpu().numpy()
              for k in range(3)]
    return [tuple(p[i] for p in planes) for i in range(n)]


def _job(cfg: dict, tr: dict, path: Path) -> Path:
    path.write_text(
        "[source]\nkind = raw\npath = camera.yuv\n"
        f"width = {cfg['width']}\nheight = {cfg['height']}\n"
        f"fps = {int(tr['fps'])}\n\n[encode]\ncodec = {cfg['codec']}\n"
        f"gop = {cfg['gop']}\nrun = {int(tr['run'])}\n")
    return path


def run(cell, codec, seed: int, seconds: float, trace: bool, t_start: float,
        device, workers: int | None = None) -> Run:
    from ceracoder_tpu_torch.app.cli import CliOptions
    from ceracoder_tpu_torch.app.main import CeracoderApp
    from ceracoder_tpu_torch.app.source import pad_to_mb

    cfg, tr = cell.config, cell.traffic
    fps, run_len = int(tr["fps"]), int(tr["run"])
    gop = int(cfg["gop"])
    ring_len = int(tr["ring_gops"]) * gop
    ring = _host_ring(Camera(cfg["width"], cfg["height"], seed,
                             tr["camera"], device), ring_len)

    warm = codec.make_encoder(cfg, int(tr["warm_qp"]), device)
    for pf in warm.encode_run_async(
            frames=[pad_to_mb(*f) for f in ring[:run_len]]):
        pf.result()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del warm

    n_win = math.ceil(seconds * fps)
    total = n_win + int(tr["tail"])
    extra = max(1, int(tr["check_area"]) // math.prod(codec.coded_size(cfg)))
    sample = Sample(seed, gop, run_len, extra)
    spans = Spans(enabled=trace)
    tracer = Tracer(trace, seconds, device)
    undo = codec.install_spans(spans) if trace else None
    recv = _Receiver()
    tmp = Path(tempfile.mkdtemp(prefix="camera_app."))
    opts = CliOptions(job_file=str(_job(cfg, tr, tmp / "job.ini")),
                      addr="udp", port=recv.port)
    app = CeracoderApp(opts, device=device)
    cam = _Camera(ring, cfg["width"], cfg["height"], fps, total, spans,
                  lambda t0: tracer.begin())
    app.source = cam

    # the harness's view of the product path, wrapped from outside
    dispatch_at: dict[int, float] = {}
    got_recon: dict[int, tuple] = {}
    counts = {"submitted": 0, "failed": 0, "last_idr": 0, "muxed": 0,
              "sent": 0}
    ts_end: list[int] = []
    sent_at: list[float] = []
    enc = app.encoder
    enc_run = enc.encode_run_async

    class Pending:
        def __init__(self, pf, i):
            self.pf, self.i = pf, i

        def result(self):
            try:
                with spans.span("result"):
                    fr = self.pf.result()
            except Exception as e:           # a frame that raised is lost
                counts["failed"] += 1
                print(f"frame {self.i} raised {e!r}", file=sys.stderr)
                raise
            if fr.keyframe:
                counts["last_idr"] = self.i
            if (self.i < n_win and
                    (self.i - counts["last_idr"]) in sample.recon_pos):
                got_recon[self.i] = fr._recon_dev
            return fr

    def encode_run_async(frames=None, **kw):
        first, t = counts["submitted"], time.time()
        with spans.span("launch", len(frames)):
            pend = enc_run(frames=frames, **kw)
        for k in range(len(frames)):
            dispatch_at[first + k] = t
            if trace and cam.t0 is not None:
                c = cam.t0 + (first + k) / fps
                spans.rows.append(("wait", int(c * 1e9), int(t * 1e9), 1))
        counts["submitted"] += len(frames)
        return [Pending(pf, first + k) for k, pf in enumerate(pend)]

    mux_video, pack, send = (app.mux.mux_video, app.packer.feed,
                             app.transport.send)

    def mux_wrapped(*a, **kw):
        with spans.span("send", 1):
            out = mux_video(*a, **kw)
        counts["muxed"] += len(out)
        ts_end.append(counts["muxed"])
        return out

    def pack_wrapped(data):
        with spans.span("send", 0):
            return pack(data)

    def send_wrapped(payload):
        with spans.span("send", 0):
            ok = send(payload)
        now = time.time()
        counts["sent"] += len(payload)
        while len(sent_at) < len(ts_end) and \
                ts_end[len(sent_at)] <= counts["sent"]:
            sent_at.append(now)
        return ok

    enc.encode_run_async = encode_run_async
    app.mux.mux_video = mux_wrapped
    app.packer.feed = pack_wrapped
    app.transport.send = send_wrapped
    watchdogs = []
    start_watchdog = app._start_stall_watchdog
    app._start_stall_watchdog = lambda: watchdogs.append(start_watchdog())
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGHUP, signal.SIGTERM, signal.SIGINT)}

    tracer.start()
    try:
        rc = app.run()
    finally:
        app.state.quit = True            # the watchdog's thread ends
        for t in watchdogs:
            t.join()
        for s, h in handlers.items():
            signal.signal(s, h)
        tracer.stop()
        if tracer.t1 is not None and cam.t0 is not None:
            # the traced window is the measured one
            tracer.t1 = min(tracer.t1, int((cam.t0 + seconds) * 1e9))
        wire = recv.close()
        shutil.rmtree(tmp, ignore_errors=True)
        if undo:
            undo()
    t0 = cam.t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got_recon = {i: tuple(p.cpu().numpy() for p in r)
                 for i, r in got_recon.items()}
    del app, enc, ring
    if device.type == "cuda":
        torch.cuda.empty_cache()
    data = tracer.data(spans, codec.context(cfg))
    if data is not None:
        print(data.summary(), file=sys.stderr)

    # latency of every frame of the window; one never sent is over any
    # limit
    lat = [(sent_at[i] - (t0 + i / fps)) * 1e3 if i < len(sent_at)
           else math.inf for i in range(n_win)]
    srt = sorted(lat)
    p95 = srt[math.ceil(0.95 * n_win) - 1]
    waits = [dispatch_at[i] - (t0 + i / fps) for i in range(n_win)
             if i in dispatch_at]
    print(f"app rc {rc} frames in window {n_win} sent {min(len(sent_at), n_win)}"
          f" latency samples {n_win} p50 {srt[n_win // 2]:.3f} p95 "
          f"{p95:.3f} max {srt[-1]:.3f} ms; capture to dispatch mean "
          f"{1e3 * sum(waits) / max(1, len(waits)):.3f} ms", file=sys.stderr)
    bins = [sorted(lat[i] for i in range(n_win) if int(i / fps // 5) == b)
            for b in range(math.ceil(n_win / fps / 5))]
    print("latency median by 5 s of capture (ms) "
          f"{[round(b[len(b) // 2], 1) for b in bins if b]}", file=sys.stderr)

    # what the receiver got
    t_ref = time.time()
    aus, bad_ts = video_access_units(wire)
    missing = counts["failed"] + max(0, n_win - len(aus))
    idr = [nal_type(nal_units(au)[-1]) == NAL_IDR_W_RADL for au in aus]
    need = max(sample.byte_pos) + 1
    starts = [k for k in range(min(n_win, len(aus))) if idr[k]]
    whole = [k for k in starts if k + need <= n_win
             and not any(idr[k + 1:k + need])]
    if whole:
        base = sample.rng.choice(whole)
        positions = sorted(sample.byte_pos)
    else:
        base = starts[0] if starts else 0
        positions = [k for k in sorted(sample.byte_pos)
                     if base + k < min(n_win, len(aus))]
    got_bytes = {base + k: aus[base + k] for k in positions}
    qps = {i: slice_qp(nal_units(au)[-1]) for i, au in got_bytes.items()}
    ref_cam = Camera(cfg["width"], cfg["height"], seed, tr["camera"], "cpu")
    got = compare(codec, cfg, ref_cam, ring_len, qps, int(tr["warm_qp"]),
                  base, positions, got_bytes, got_recon, workers,
                  headers=True)
    print(f"reference gop at {base} positions {positions} qps "
          f"{[qps[base + k] for k in positions]} seconds "
          f"{time.time() - t_ref:.3f} access units {len(aus)} ts faults "
          f"{bad_ts} IDRs in window {len(starts)}", file=sys.stderr)
    e2e = {"setup_s": t0 - t_start}
    if math.isfinite(p95):
        e2e["latency_p95_ms"] = p95
    return Run(end_to_end=e2e, attempted=n_win, failed=missing,
               memory_peak_bytes=peak, trace=data,
               checks=checks(missing, got, positions)
               + [("ts_faults", bad_ts, 0, bad_ts == 0)])
