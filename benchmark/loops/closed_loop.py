"""The closed loop (traffic kind "closed_loop"): bench.py's protocol in
PyTorch, on the seeded camera.

Set-up: the camera's frames, `ring_gops` whole GOPs of them, made on the
device (frame i of the window is camera frame i modulo the ring, so the
ring wraps on a GOP boundary, where an IDR starts afresh); one warm run of
`run` frames (an IDR and P frames) through a first encoder, then a fresh
encoder. The window then submits runs of `run` consecutive frames through
`encode_run_async(frames=...)`, keeps `max(1, depth_area // coded area)`
runs in flight beyond the newest, and calls `result()` on the oldest
run's frames. The loop is in its steady state when the window opens:
set-up has launched the first `depth` runs, the first of them the GOP's
IDR run, so the first frame the window can deliver is frame 0, an IDR on
a GOP boundary. `fps` counts every frame whose NAL bytes reached the host
before the window closed, over the window's seconds; the runs still in
flight then are collected after it and judged with the rest.
"""

from __future__ import annotations

import sys
import time
from collections import deque

import torch

from benchmark.camera import Camera
from benchmark.check import Sample, checks, compare
from benchmark.harness import Run
from benchmark.trace import Spans, Tracer


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, codec, seed: int, seconds: float, trace: bool, t_start: float,
        device, workers: int | None = None) -> Run:
    cfg, tr = cell.config, cell.traffic
    qp, run_len = int(tr["qp"]), int(tr["run"])
    cw, ch = codec.coded_size(cfg)
    depth = max(1, int(tr["depth_area"]) // (cw * ch))
    cam = Camera(cfg["width"], cfg["height"], seed, tr["camera"], device)
    ring_len = int(tr["ring_gops"]) * int(cfg["gop"])
    ring = [cam.frame(i) for i in range(ring_len)]
    del cam

    warm = codec.make_encoder(cfg, qp, device)
    for pf in warm.encode_run_async(frames=ring[:run_len], qp=qp):
        pf.result()
    _sync(device)
    del warm

    # P frames checked from the program's state: fewer at larger sizes,
    # so that the reference's time stays near the window's
    extra = max(1, int(tr["check_area"]) // (cw * ch))
    sample = Sample(seed, int(cfg["gop"]), run_len, extra)
    spans = Spans(enabled=trace)
    undo = codec.install_spans(spans) if trace else None
    tracer = Tracer(trace, float(tr["trace_seconds"]), device)
    tracer.start()
    enc = codec.make_encoder(cfg, qp, device)
    got_bytes, got_recon = {}, {}
    counts = {"in_window": 0, "failed": 0, "bytes": 0}
    done_at: list[float] = []
    q: deque = deque()

    def collect(idx, pend, t_end):
        counts["failed"] += max(0, len(idx) - len(pend))
        for i, pf in zip(idx, pend):
            try:
                with spans.span("result"):
                    fr = pf.result()
            except Exception as e:           # a frame that raised is lost
                counts["failed"] += 1
                print(f"frame {i} raised {e!r}", file=sys.stderr)
                continue
            now = time.time()
            done_at.append(now)
            if now <= t_end:
                counts["in_window"] += 1
                counts["bytes"] += len(fr.data)
            if sample.keeps_bytes(i):
                got_bytes[i] = fr.data
            if sample.keeps_recon(i):
                got_recon[i] = fr._recon_dev

    submitted = 0
    pend = frames = None
    t_end = float("inf")

    def launch():
        nonlocal submitted, pend, frames
        idx = range(submitted, submitted + run_len)
        frames = [ring[i % ring_len] for i in idx]
        with spans.span("launch", run_len):
            pend = enc.encode_run_async(frames=frames, qp=qp)
        submitted += run_len
        q.append((idx, pend))

    # the loop's steady state before the window: `depth` runs in flight,
    # the first of them the GOP's IDR run, so that frame 0 is the first
    # that the window can deliver
    for _ in range(depth):
        launch()
    t0 = time.time()
    t_end = t0 + seconds
    tracer.begin()
    while time.time() < t_end:
        launch()
        collect(*q.popleft(), t_end)
        tracer.maybe_stop()
    tracer.stop()
    while q:
        collect(*q.popleft(), t_end)
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got_recon = {i: tuple(p.cpu().numpy() for p in r)
                 for i, r in got_recon.items()}
    del enc, pend, frames, ring
    if undo:
        undo()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    data = tracer.data(spans, codec.context(cfg))
    if data is not None:
        print(data.summary(), file=sys.stderr)

    bins = [0] * max(1, int(seconds // 5))
    for t in done_at:
        if t0 <= t < t0 + 5 * len(bins):
            bins[int((t - t0) // 5)] += 1
    print(f"frames done by 5 s of the window {bins}", file=sys.stderr)
    t_ref = time.time()
    gop_index, positions = sample.choose(submitted)
    ref_cam = Camera(cfg["width"], cfg["height"], seed, tr["camera"], "cpu")
    got = compare(codec, cfg, ref_cam, ring_len, qp, qp,
                  gop_index * int(cfg["gop"]), positions, got_bytes,
                  got_recon, workers)
    print(f"reference gop {gop_index} positions {positions} seconds "
          f"{time.time() - t_ref:.3f} frames submitted {submitted} "
          f"in window {counts['in_window']} depth {depth} bytes a frame "
          f"{counts['bytes'] / max(1, counts['in_window']):.1f}",
          file=sys.stderr)
    return Run(end_to_end={"fps": counts["in_window"] / seconds,
                           "setup_s": t0 - t_start},
               attempted=submitted, failed=counts["failed"],
               memory_peak_bytes=peak, trace=data,
               checks=checks(counts["failed"], got, positions))
