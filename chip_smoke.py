#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (ceracoder_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. device: the card's name, power limit and count;
2. build: every hand-written kernel from csrc/, one nvcc per source,
   all started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   on random inputs, on edge cases (`merge_edge_cases`,
   `deblock_edge_cases`, `intra16_edge_cases`, `h265_intra_edge_cases`)
   and on the real inputs of a 1080p IDR and P frame (K4: the 1080p IDR
   and one 3840x2160 IDR of the device source; K2 and K3 also on random
   planes of an odd number of MB columns, ODD_W x ODD_H), bit-equal;
   timed (torch.profiler device time per call over 5 windows: K3's and
   K4's calls are two kernels each, each one's mean event summed; and
   CUDA events) beside
   the plain version, one-call PyTorch yardsticks where there are any
   (K1), the CUDA-graph replay of the plain loop (K2-K4) and the bytes
   and operations bound;
4. main path: H264Encoder(1920, 1088, qp=28, gop=60, cabac=False) on
   DeviceTestPatternSource(1920, 1088, texture=6), 3 runs of 10 frames
   through encode_run_async; kernel launch counts are set to 0 just
   before and read just after (K1 once per frame, K2 once per frame,
   K3 once per IDR); every main-path phase below does the same; prints
   each run's seconds, split into encode_run_async, the results and
   the last synchronization;
5. GPU equals CPU: the same port at 320x192 (6 frames, gop 4, two
   runs) on cuda and cpu gives byte-identical streams, and so do the
   first IDR and P frame at 1080p;
6. HEVC main path: H265DeviceEncoder(1920, 1088, qp=30, gop=60)
   (deblocking, tile rows, native entropy) on the same source, 3 runs
   of 10 frames through encode_run_async; checks the GOP structure
   (1 IDR, then P), the NAL types (IDR_W_RADL, then TRAIL_R), the
   start codes and the recon shapes; kernel launch counts are set to 0
   just before and read just after (K4 once per IDR, no other kernel);
   one more P frame and one more IDR under torch.profiler, the IDR under
   1,000 CUDA launches; prints frames/s, seconds per run, bytes per IDR
   and mean P frame, fallback frames, peak device memory and those
   launches and device ms;
7. HEVC GPU equals CPU: 320x192 (6 frames, gop 4, two runs) and the
   first 1080p IDR + P frame, byte-identical;
8. the product loop: CeracoderApp (python -m ceracoder_tpu_torch) on a
   devtest 1920x1088 job at 60 frames/s, hevc, gop 60, runs of 10, tone
   audio where the AAC encoder builds, the fixed balancer, latency
   2000 ms, realtime pacing, sending to a loopback SRT listener (UDP
   where libsrt does not load); 40 warm-up frames, then 120 timed.
   Checks every payload (1316 B of 188 B TS packets, sync bytes,
   unbroken continuity counters), the keyframes (frames 0, 60, 120),
   that K4 is launched once per keyframe and no other kernel at all, and
   that the longest time the stall watchdog's position stood still is
   at most its 1 s check (the watchdog itself stays off, as in
   bench.py); prints emit-to-emit frames/s and the host seconds in
   encode_run_async, PendingFrame.result() and mux + pack + send, timed
   by wrapping those calls here, not in the app;
9. app GPU equals CPU: one 320x192 job through CeracoderApp on cuda and
   on cpu gives identical TS bytes, for the host-source run loop (run =
   4), the per-frame loop (run = 1) and the device-source run loop, for
   codec = hevc and codec = h264;
10. H.264 CABAC main path: H264Encoder(1920, 1088, qp=28, gop=60) with
   its defaults (CABAC, intra-in-P) on the device test pattern, 3 runs
   of 10 frames through encode_run_async; checks the GOP structure, one
   NAL unit per MB row, the recon shapes, that K1 is launched 0 times
   and K2 and K3 once per frame, and that one more P frame and one more
   IDR each launch fewer than 3,000 CUDA kernels (torch.profiler);
   prints frames/s, bytes per IDR and mean P frame, intra MBs per P
   frame (read off the unpacked rows), fallback frames, peak device
   memory, and those launches and device ms;
11. CABAC GPU equals CPU: 320x192 on the device source (6 frames, gop
   4, two runs) and on host frames whose bottom half changes to new
   content mid-clip (so both code intra MBs in P slices, which is
   checked), and the first 1080p IDR + P frame, byte-identical;
12. the H.264 product loop: CeracoderApp on jobs/h264_test_1080p30 (host
   test pattern 1920x1080, burn-in, codec h264, gop 60, runs of 8), the
   fixed balancer, loopback SRT (UDP where libsrt does not load), the
   stall watchdog off; 8 warm-up frames, then 120 timed. Checks the
   payloads, continuity, keyframes (frames 0, 60, 120), that K1 is
   launched 0 times and K2 and K3 once per frame, and that the longest
   time the watchdog's position stood still is at most the watchdog's
   1 s check (a live job would exit above it); prints emit-to-emit
   frames/s, the host seconds as phase 8 and that time;
13. HEVC with SAO: bench.py's `CERACODER_BENCH_SAO=1` cell,
   H265DeviceEncoder(1920, 1088, qp=30, gop=60, sao=True) on the device
   test pattern, 3 runs of 10 frames; the checks of phase 6 (K4 once per
   IDR, the IDR under 1,500 launches with SAO's), the share of CTBs
   that take SAO
   (above 0), then GPU == CPU as phase 7 with SAO on;
14. HEVC B frames + TU split: H265DeviceEncoder(1920, 1088, qp=30,
   gop=60, bframes=1, tu_split=True) on the device test pattern, 3 runs
   of 10 frames through encode_run_b_async (the first run an IDR, 4
   (B, P) pairs and a P tail, the next two 5 pairs each); checks the
   coding order, kinds and POCs, the NAL types (IDR_W_RADL, TRAIL_R,
   TRAIL_N), the recon shapes, that K4 is launched once per IDR and no
   other kernel, and, off the unpacked rows, that P and B frames take
   the TU split and B frames carry list-1 MVs unlike list 0; one more
   pair under torch.profiler (launches and device ms of its TU-split P
   and of its B frame); prints frames/s, bytes per I, P and B frame,
   fallback frames and peak device memory; then GPU == CPU at 320x192
   (6 frames, gop 4) for push_frame/flush and for encode_run_b_async
   in two runs, and for the first 1080p IDR and pair;
15. parallel encoders (parallel/), the bands, GOP slots and mesh cells
   spread over every card (one card takes them all, one after another):
   ShardedH265Encoder(1920, 1088, qp=30, gop=60, n_bands=4)
   through encode_frame for 1 IDR + 9 P frames of the device test
   pattern, then n_bands=3 (23 + 23 + 22 CTB rows) for 1 IDR + 2 P, then
   3840x2160 in 8 bands (7 of 17 CTB rows and one of 16) for 1 IDR + 2
   P, each frame's bytes equal to the single-device encode_frame's at
   the same size and K4 once per band per IDR (no other hand kernel);
   K4 on the first and last 4K band's IDR inputs (17 and 16 CTB rows)
   against its plain version; GopParallelStreamEncoder(1920, 1088,
   qp=30, gop=10, two slots) for 3 runs of 10, equal to a single-device
   encode_run_async at gop 10, K4 once per GOP; encode_sharded(
   make_mesh(2, 4), 28, 28) on 2 streams of 1920x1088, equal to
   encode_frame_i16_rows per stream, K3 8 times, and one (stream, band)
   equal to encode_frame_i16_rows on the CPU (K3's plain version) at the
   band's shape. Prints the 4-band run's P frames/s after one warm P
   frame, host ms per frame, and one more banded and single-device P
   frame's launches and device ms (torch.profiler); the 3-frame runs
   print no rate;
16. the supervisor (bindings/), native TS and per-stream control:
   (a) the port's app as a supervised process: the bindings write the
   job (JobBuilder: test source, 1080p, 30 frames/s, hevc, i.e.
   jobs/hevc_test_1080p30) and the config (build_run_artifacts: fixed
   balancer, latency 2000 ms), `spawn` starts `python -m
   ceracoder_tpu_torch` (or an installed ceracoder-tpu-torch; checked)
   with PYTHONUNBUFFERED, its stall watchdog armed, sending UDP to a
   listener here; after the first payload (deadline 120 s) about 5 s
   of streaming, then a lower max_bitrate written and `send_hup`: the
   child must print `Config reloaded: <min> - <max> Kbps` within 5 s;
   about 3 s more, then `send_term`: exit code 0 within 3 s (the
   app's SIGALRM teardown forces an exit, also 0, at 3 s), not
   running; every payload 1316 B of TS with sync bytes and unbroken
   continuity, a keyframe, no `Pipeline stall detected`. Prints the
   seconds to the first payload, payloads/s, SIGHUP to the reload line
   and SIGTERM to exit. (c) BASELINE.md config (4): two
   H265DeviceEncoder(1920, 1088, qp=32, gop=60) streams on the card,
   each with its own BondedLink (one modem of 8 Mbps; one of 2 Mbps),
   adaptive BalancerRunner and QpRateController(fps=30), two 20 ms
   ticks a frame for 60 frames of the device test pattern; the weak
   stream must end at a higher mean QP over its last 10 frames and a
   lower bitrate, K4 once per IDR per stream and no other hand kernel.
   (b) the first 10 access units of (c)'s healthy stream through
   NativeTsMuxer + NativeTsPacker and the Python TsMuxer + TsPacker,
   byte for byte; NativeSrtClient refuses with "libsrt unavailable"
   where libsrt does not load, else sends to a loopback listener;
17. the host reference codec on the card's streams: (a) phase 10's
   H264Encoder codes 1 IDR + 9 P frames of the device test pattern at
   1920x1088 (K2 and K3 every frame); the port's walk_stream and
   H264SliceParser parse every slice, each one MB row consumed to
   within 2 bytes; every frame has 8,160 MBs, every IDR MB is intra,
   and each P frame's parsed intra MBs equal the encoder's own count
   (IntraCount); prints the MB types per frame type and the parse
   seconds. (b) phase 6's H265DeviceEncoder codes the first IDR and P
   frame (K4 once); the numpy H265RowEncoder(native_entropy=False),
   i.e. compute_intra_rows / compute_p_rows and the Python CABAC
   entropy_rows, codes the same frames copied to the host to the same
   parameter sets and NAL bytes; prints those stages' seconds;
18. one slice per CTB row, the deblock's share and the legacy motion
   helpers: (a) H265DeviceEncoder(1920, 1088, qp=30, gop=60) with tile
   rows and with tile_rows turned off in its params (slice mode; the
   encoder takes no such option) on the same 10 frames of the device
   test pattern through encode_run_async: every reconstruction equal,
   68 slice NAL units a slice-mode frame, K4 once per IDR; the Python
   entropy_rows and entropy_rows_native in slice mode, on the numpy
   spec's arrays that phase 17 (b) kept for the first IDR and P frame,
   equal the card's slice-mode IDR and P byte for byte; prints the
   bytes per frame in both modes. (b) phase 6 with ops/h265.py's
   deblock_frame_dev patched to return its input (the work of JAX's
   deblock=False; 3 runs of 10 frames, the same checks): frames/s,
   launches and device ms of one more P frame beside phase 6's of this
   call and the deblock's share of the launches and device ms; then
   host ms per P frame with the deblock on and patched out in turns
   (10 pairs of runs of 10 P frames, the order alternating). (c) the
   legacy motion helpers (ops/h265.py:
   motion_search_dev, _luma_qpel_planes, _refine_subpel, _mc_luma_qpel,
   _uni_from_14, _mc_chroma_qpel; ops/inter.py: motion_search_fullpel,
   half_pel_planes, halfpel_refine, mc_luma_qpel, mc_chroma; no encoder
   path calls them) GPU == CPU on frames 0 and 1 of the device test
   pattern at 320x192, exact, and each at 1920x1088, the median of 7
   calls timed alone.

The native libraries (native/src: the HEVC entropy stage, the H.264
CABAC row coder, the balancer core, the TS muxer and packer, the SRT
client and, where the libavcodec headers are, the audio shim; g++) are
built in phase 2 beside the kernels.

The last lines are the nvidia-smi line, a JSON line of kernel numbers
and the result line {"ok": true, "device": {...}}. It prints no result
and exits non-zero without CUDA or without the repository beside it.

    python3 chip_smoke.py --compare-h264 DIR
    python3 chip_smoke.py --compare-h265 DIR

run only phase 3's K2 and K3 part, phase 10 and phase 12 (H.264), or
phase 3's K4 part, phase 6 and phase 8 (HEVC), of the tree in DIR (e.g.
the parent commit from `git archive`, unpacked under build/) and of this
one, in turns DIR, this, this, DIR, each in its own process on the same
card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

# csrc source -> (wrapper, what it replaces on the TPU, route)
KERNELS = {
    "merge_windows": ("merge_windows", "ceracoder_tpu/ops/bitpack.py:112",
                      "cuda"),
    "h264_deblock": ("h264_deblock_rows",
                     "ceracoder_tpu/ops/deblock.py:213", "cuda"),
    "h264_intra16": ("h264_intra16_cols", "ceracoder_tpu/ops/intra.py:152",
                     "cuda"),
    "h265_intra": ("h265_intra_cols", "ceracoder_tpu/ops/h265.py:1282",
                   "cuda"),
}
ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # non-tensor 32-bit rate (fp32 figure)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, windows: int = 5, warmup: int = 5,
              max_windows: int = 10) -> dict:
    """Device milliseconds per call of fn(): the CUDA kernel time that
    torch.profiler records, in windows of `iters` calls each. Unlike
    time_cuda, host launch gaps do not count.

    fn launches a whole number k of kernels per call: k*iters events
    per window, k taken from the window that recorded the most. The
    profiler sometimes loses events, some of a window's or all of them.
    A window that lost at most 1% of its k*iters events is scaled up by
    the share it lost (`lost_events` counts them); one that lost more
    is set aside (`dropped_windows`) and another is taken. The check
    fails if no window records a kernel, or unless `windows` windows
    are kept within `max_windows`. Returns the median of the kept
    windows, their [min, max] and k."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen: list[tuple[int, float]] = []
    for taken in range(1, max_windows + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        seen.append((len(kernels), sum(e.time_range.elapsed_us()
                                       for e in kernels) / 1e3))
        k = round(max(n for n, _ in seen) / iters)
        want = k * iters
        kept = [(n, ms) for n, ms in seen
                if k and want - max(1, want // 100) <= n <= want]
        if len(kept) >= windows:
            break
    check(k > 0, f"no profiler window of {iters} calls recorded a kernel")
    check(len(kept) >= windows,
          f"kernel events per window of {iters} calls: "
          f"{[n for n, _ in seen]}, want {want} in {windows} windows")
    per_call = [ms * want / n / iters for n, ms in kept]
    return {"ms": statistics.median(per_call),
            "spread": [min(per_call), max(per_call)],
            "kernels_per_call": k,
            "dropped_windows": taken - len(kept),
            "lost_events": sum(want - n for n, _ in kept)}


def kernel_event_ms(fn, kernel: str, iters: int, kernels: int = 1,
                    windows: int = 5, max_windows: int = 10) -> dict:
    """Device milliseconds per call of fn(), which launches `kernels`
    different kernels once each (their names contain `kernel`): the mean
    duration of each kernel's events that torch.profiler records in a
    window of `iters` calls, summed over the kernels; median of
    `windows` windows after 3 warm-up calls. For kernels that run for a
    few tenths of a millisecond the profiler records fewer events than
    launches (F6); a kernel's mean over the events it records does not
    depend on how many it lost, which are counted (`lost_events`), while
    a sum over all events divided by their count would weight the
    kernels by what was lost. A window that lost every event of one
    kernel is set aside (`dropped_windows`) and another is taken. The
    check fails on any kernel whose name lacks `kernel`, on more than
    `kernels` kernels, or unless `windows` windows are kept within
    `max_windows`. `per_kernel` has each kernel's median ms, keyed by
    the part of its name after `kernel`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per, lost, dropped, by_kernel = [], 0, 0, {}
    for _ in range(max_windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        check(all(kernel in e.name for e in events),
              f"window of {iters} calls recorded {[e.name for e in events]}")
        by_name: dict[str, list[float]] = {}
        for e in events:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        check(len(by_name) <= kernels,
              f"window of {iters} calls recorded kernels {sorted(by_name)}, "
              f"want {kernels}")
        if len(by_name) < kernels:
            dropped += 1
            continue
        means = {name: statistics.fmean(us) / 1e3
                 for name, us in by_name.items()}
        per.append(sum(means.values()))
        for name, ms in means.items():
            short = name.split(kernel, 1)[1].split("(", 1)[0]
            by_kernel.setdefault(short, []).append(ms)
        lost += kernels * iters - len(events)
        if len(per) == windows:
            break
    check(len(per) == windows,
          f"{len(per)} of {max_windows} windows of {iters} calls recorded "
          f"every one of the {kernels} kernel(s), want {windows}")
    return {"ms": statistics.median(per), "spread": [min(per), max(per)],
            "lost_events": lost, "dropped_windows": dropped,
            "per_kernel": {k: statistics.median(v)
                           for k, v in by_kernel.items()}}


def build_kernels(tag: str) -> None:
    from ceracoder_tpu_torch.utils import host_build
    from ceracoder_tpu_torch.utils.cuda_build import build_library

    native_libs = ["hevc_entropy", "h264_cabac", "balancer", "mpegts",
                   "srt_client"]
    if host_build.have_avcodec():
        native_libs.append("audio_enc")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(
            max_workers=len(KERNELS) + len(native_libs)) as pool:
        futs = {name: pool.submit(build_library, name) for name in KERNELS}
        native = {name: pool.submit(host_build.build_library, name)
                  for name in native_libs}
        results = {name: f.result() for name, f in futs.items()}
        native_paths = {name: f.result() for name, f in native.items()}
    secs = time.perf_counter() - t0
    for name, (path, log) in results.items():
        print(f"build {name}: {path.name}")
        for line in log.strip().splitlines():
            print(f"  ptxas {name}: {line.strip()}")
    for name, path in native_paths.items():
        print(f"build native {name} (g++): {path.name}")
    if "audio_enc" not in native_paths:
        print("no libavcodec headers: the audio shim is not built")
    print(f"{tag} build seconds (all kernels, parallel nvcc, and the "
          f"native libraries): {secs:.2f}")


# ---------------------------------------------------------------------------
# K1: merge_windows
# ---------------------------------------------------------------------------

def random_merge_case(gen: torch.Generator, rows: int, nch: int,
                      capw_pad: int, max_span: int = 63):
    """Random chunk starts anywhere in their 128-word block (so also at
    in-block offsets above 64, where the TPU kernel wraps), spans up to
    max_span words, some starts past capw_pad (dropped words)."""
    from ceracoder_tpu_torch.ops.bitpack import WIN, u32_to_i32

    spans = torch.randint(0, max_span + 1, (rows, nch), generator=gen)
    sw = torch.cumsum(spans, dim=1) - spans
    sw = sw + torch.randint(0, 128, (rows, 1), generator=gen)
    partials = torch.randint(0, 1 << 32, (rows, nch, WIN), generator=gen,
                             dtype=torch.int64)
    partials[torch.rand((rows, nch, WIN), generator=gen) < 0.5] = 0
    return (sw.to(torch.int32).cuda(), u32_to_i32(partials).cuda(),
            capw_pad)


def merge_edge_cases(seed: int = 7) -> dict:
    """K1 edge cases as CPU tensors, name -> (sw, partials, capw_pad),
    made with numpy from `seed`: one chunk and a few; a chunk count that
    is no multiple of the 16 vectors a window spans; rows whose chunks
    take two and three load rounds of the kernel, with densely
    overlapping windows across every boundary of threads and rounds
    (ops/bitpack.py:merge_geometry); unsorted starts; all-zero partials;
    negative starts and starts at or past capw_pad (int32 extremes
    included); capw_pad 256, 16384 and one that is no multiple of 4."""
    from ceracoder_tpu_torch.ops.bitpack import (
        MERGE_THREADS, MERGE_VECS, WIN, u32_to_i32)

    rng = np.random.default_rng(seed)

    def words(rows, nch):           # uint32 words, about half of them 0
        p = rng.integers(0, 1 << 32, (rows, nch, WIN), dtype=np.uint64)
        p[rng.random(p.shape) < 0.5] = 0
        return p

    def starts(rows, nch, capw_pad):
        return np.sort(rng.integers(0, capw_pad, (rows, nch)), axis=1)

    per_round = MERGE_THREADS * MERGE_VECS // (WIN // 4)    # chunks
    nch2 = per_round + 9
    dense = np.cumsum(rng.integers(0, 9, (2, nch2)), axis=1)
    edges = np.array([[-(1 << 31), -WIN - 3, -WIN + 1, -1, 0, 200,
                       512 - WIN + 2, 511, 512, 600, (1 << 31) - 11,
                       (1 << 31) - 1]])
    nch3 = 2 * per_round + 5
    cases = {
        "one_chunk": (starts(2, 1, 256), words(2, 1), 256),
        "few_chunks": (starts(3, 5, 256), words(3, 5), 256),
        "nch_21": (starts(4, 21, 1024), words(4, 21), 1024),
        "overlapping_windows_two_rounds": (dense, words(2, nch2), 4096),
        "three_rounds": (starts(2, nch3, 8192), words(2, nch3), 8192),
        "unsorted_starts": (rng.integers(0, 2048, (5, 40)), words(5, 40),
                            2048),
        "all_zero_partials": (starts(4, 30, 1024),
                              np.zeros((4, 30, WIN), np.uint64), 1024),
        "starts_out_of_range": (np.repeat(edges, 3, axis=0),
                                words(3, edges.shape[1]), 512),
        "capw_pad_256": (starts(2, 9, 256), words(2, 9), 256),
        "capw_pad_16384": (starts(3, 40, 16384), words(3, 40), 16384),
        "capw_pad_not_multiple_of_4": (starts(3, 20, 1001), words(3, 20),
                                       1001),
    }
    return {name: (torch.as_tensor(sw.astype(np.int32)),
                   u32_to_i32(torch.as_tensor(p.astype(np.int64))), capw)
            for name, (sw, p, capw) in cases.items()}


def capture_merge_inputs(width: int, height: int, texture: int):
    """sw / partials / capw_pad that the slice hands the merge for
    frame 0 (IDR) and frame 1 (P) of the device source."""
    import ceracoder_tpu_torch.codec.h264.device_entropy as de
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    captured = []
    real = de.merge_windows

    def capture(sw, partials, capw_pad):
        captured.append((sw.clone(), partials.clone(), capw_pad))
        return real(sw, partials, capw_pad)

    de.merge_windows = capture
    try:
        src = DeviceTestPatternSource(width, height, texture=texture)
        enc = H264Encoder(width, height, qp=28, gop=60, cabac=False)
        for p in enc.encode_run_async(source=src, indices=range(2)):
            p.result()
    finally:
        de.merge_windows = real
    check(len(captured) == 2, f"captured {len(captured)} merges, want 2")
    return captured


def merge_err(case) -> int:
    """Largest difference between K1 and its plain version on case."""
    from ceracoder_tpu_torch.ops.bitpack import (
        i32_to_u32, merge_windows, merge_windows_ref)

    got = merge_windows(*case)
    want = merge_windows_ref(*case)
    torch.cuda.synchronize()
    return int((i32_to_u32(got) - i32_to_u32(want)).abs().max())


def merge_numbers(case, iters: int = 200):
    """Equality and timings of K1 on one input."""
    from ceracoder_tpu_torch.ops.bitpack import (
        WIN, i32_to_u32, merge_windows, merge_windows_ref)

    sw, partials, capw_pad = case
    out = {"max_abs_err": merge_err(case)}
    rows, nch = sw.shape
    # one-call yardsticks: a single scatter_add_ with prepared indices,
    # on int64 values and on the same int32 bit patterns (which adds
    # mod 2^32 as K1 does, moving half the bytes)
    idx = (sw.to(torch.int64)[:, :, None]
           + torch.arange(WIN, device=sw.device))
    idx = torch.where((idx >= 0) & (idx < capw_pad), idx, capw_pad)
    idx = idx.reshape(rows, -1)
    src64 = i32_to_u32(partials).reshape(rows, -1)
    src32 = partials.reshape(rows, -1)
    buf64 = torch.zeros((rows, capw_pad + 1), dtype=torch.int64,
                        device=sw.device)
    buf32 = torch.zeros((rows, capw_pad + 1), dtype=torch.int32,
                        device=sw.device)
    buf32.scatter_add_(1, idx, src32)
    check(torch.equal(buf32[:, :capw_pad],
                      merge_windows(sw, partials, capw_pad)),
          "int32 scatter_add_ yardstick differs from K1")
    nbytes = (sw.numel() * 4 + partials.numel() * 4 + rows * capw_pad * 4)
    ops = partials.numel()
    fns = {"ms": lambda: merge_windows(sw, partials, capw_pad),
           "plain_ms": lambda: merge_windows_ref(sw, partials, capw_pad),
           "library_i64_ms": lambda: buf64.scatter_add_(1, idx, src64),
           "library_i32_ms": lambda: buf32.scatter_add_(1, idx, src32)}
    for key, fn in fns.items():
        # device time (profiler); the CUDA-event time per call also
        # counts host launch gaps
        out["event_" + key] = time_cuda(fn, iters)
        dev = device_ms(fn, iters)
        out[key] = dev["ms"]
        out[key.replace("ms", "spread")] = dev["spread"]
        out[key.replace("ms", "kernels")] = dev["kernels_per_call"]
        out[key.replace("ms", "dropped")] = dev["dropped_windows"]
        out[key.replace("ms", "lost")] = dev["lost_events"]
    out["library_ms"] = min(out["library_i64_ms"], out["library_i32_ms"])
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    return {
        **out,
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops / INT32_OPS_PER_S else "operations"),
        "bound_share": bound_ms / out["ms"],
        "bytes": nbytes,
        "shape": [rows, nch, capw_pad],
    }


def phase_kernels(tag: str) -> dict:
    from ceracoder_tpu_torch.ops.bitpack import merge_geometry, merge_windows

    gen = torch.Generator().manual_seed(2024)
    errs = []
    for rows, nch, capw_pad in ((68, 223, 5888), (7, 50, 1024),
                                (3, 9, 256), (135, 223, 16384)):
        case = random_merge_case(gen, rows, nch, capw_pad)
        errs.append(merge_err(case))
        dev = device_ms(lambda: merge_windows(*case), 200)
        print(f"{tag} K1 random {rows}x{nch} capw_pad={capw_pad}: "
              f"max_abs_err={errs[-1]}; device ms {dev['ms']:.6f} "
              f"{dev['spread']}")
    for name, (sw, partials, capw_pad) in merge_edge_cases().items():
        errs.append(merge_err((sw.cuda(), partials.cuda(), capw_pad)))
        print(f"{tag} K1 edge case {name} {tuple(sw.shape)} "
              f"capw_pad={capw_pad}: max_abs_err={errs[-1]}")
    check(max(errs) == 0, "K1 differs from its plain version")
    real = capture_merge_inputs(1920, 1088, 6)
    numbers = {"max_abs_err": max(errs)}
    for kind, case in zip(("IDR", "P"), real):
        n = merge_numbers(case)
        numbers[kind] = n
        geo = merge_geometry(*n["shape"])
        print(f"{tag} K1 1080p {kind} frame {n['shape']} {geo}: "
              f"max_abs_err={n['max_abs_err']}; device ms (profiler, "
              f"median [min, max] of 5 windows, kernels/call): "
              f"K1 {n['ms']:.6f} {n['spread']} x{n['kernels']}, "
              f"plain {n['plain_ms']:.6f} {n['plain_spread']} "
              f"x{n['plain_kernels']}, scatter_add_ int64 "
              f"{n['library_i64_ms']:.6f} {n['library_i64_spread']} "
              f"x{n['library_i64_kernels']}, scatter_add_ int32 "
              f"{n['library_i32_ms']:.6f} {n['library_i32_spread']} "
              f"x{n['library_i32_kernels']}; CUDA-event ms per call: "
              f"K1 {n['event_ms']:.6f} plain {n['event_plain_ms']:.6f} "
              f"int64 {n['event_library_i64_ms']:.6f} int32 "
              f"{n['event_library_i32_ms']:.6f}; profiler windows set "
              f"aside (lost events) K1/plain/int64/int32: {n['dropped']}/"
              f"{n['plain_dropped']}/{n['library_i64_dropped']}/"
              f"{n['library_i32_dropped']}; events lost in kept windows "
              f"(scaled) K1/plain/int64/int32: {n['lost']}/"
              f"{n['plain_lost']}/{n['library_i64_lost']}/"
              f"{n['library_i32_lost']}; bound_ms="
              f"{n['bound_ms']:.6f} ({n['bound_by']}, {n['bytes']} B), "
              f"share of bound {n['bound_share']:.4f}; K1 below the "
              f"library call: {n['ms'] < n['library_ms']}")
        check(n["max_abs_err"] == 0, f"K1 differs on the {kind} frame")
    merge_windows.launches = 0
    return numbers


# ---------------------------------------------------------------------------
# K2 (h264_deblock_rows) and K3 (h264_intra16_cols)
# ---------------------------------------------------------------------------

EDGE_W, EDGE_H = 112, 48    # 7 MB columns: one unrolled step in JAX's scans
# an odd number of MB columns (53): chroma rows only 8-byte aligned, and
# a ragged last chunk of K2's and K3's row rings
ODD_W, ODD_H = 848, 480
EDGE_QPS = ((0, 0), (17, 17), (28, 28), (51, 51), (51, 17), (0, 28))


def edge_planes(rng, w: int, h: int, smooth: bool = True):
    """uint8 (y, u, v): a gradient with mild noise, so that the filters'
    conditions hold at many edges (or, with smooth=False, uniform noise,
    the largest residuals), with a region of 0, a region near 255 and
    scattered samples of 0 and 255."""
    def plane(ph, pw, k):
        yy, xx = np.mgrid[0:ph, 0:pw]
        if smooth:
            p = (xx * k + yy * 2) % 200 + 20 + rng.integers(-3, 4, (ph, pw))
        else:
            p = rng.integers(0, 256, (ph, pw))
        p[:ph // 4, :pw // 4] = 0
        p[ph // 2:, pw // 2:] = 255 - rng.integers(0, 3, p[ph // 2:,
                                                            pw // 2:].shape)
        spots = rng.random((ph, pw)) < 0.03
        p = np.where(spots, rng.choice([0, 255], (ph, pw)), p)
        return p.clip(0, 255).astype(np.uint8)
    return plane(h, w, 3), plane(h // 2, w // 2, 5), plane(h // 2, w // 2, 7)


def deblock_edge_cases(seed: int = 11) -> dict:
    """K2 edge cases as numpy arrays at EDGE_W x EDGE_H, made from `seed`:
    name -> (y, u, v, nnz44, mv_q, qp, qp_c, intra_frame, intra_mb), the
    arguments of deblock_frame_rows. Intra frames (bS 0, 3, 4), P frames
    (bS 0, 1, 2 from the nnz flags and MV steps of 4 quarter-pels and
    more) and P frames with Intra_16x16 MBs (bS 0-4), each at qp / qp_c
    0, 17, 28, 51 and mixed."""
    rng = np.random.default_rng(seed)
    mbh, mbw = EDGE_H // 16, EDGE_W // 16
    cases = {}
    for qp, qp_c in EDGE_QPS:
        for kind in ("intra", "p", "p_intra_mb"):
            y, u, v = edge_planes(rng, EDGE_W, EDGE_H)
            nnz = (rng.random((mbh, mbw, 4, 4)) < 0.3).astype(np.int32)
            mv = rng.integers(-9, 10, (mbh, mbw, 2)).astype(np.int32)
            imb = None
            if kind == "p_intra_mb":
                imb = rng.random((mbh, mbw)) < 0.35
            cases[f"{kind}_qp{qp}_qpc{qp_c}"] = (
                y, u, v, nnz, mv, qp, qp_c, kind == "intra", imb)
    return cases


def intra16_edge_cases(seed: int = 12) -> dict:
    """K3 edge cases as numpy arrays at EDGE_W x EDGE_H, made from `seed`:
    name -> (y, u, v, qp, qp_c, is_intra, inter_recon), the arguments of
    h264_intra16_cols. Without a mask (the IDR loop) on noise (the
    largest levels) and on smooth planes; with random, all-true and
    all-false masks and an inter reconstruction (the intra-in-P scan);
    each at qp / qp_c 0, 17, 28, 51 and mixed."""
    rng = np.random.default_rng(seed)
    mbh, mbw = EDGE_H // 16, EDGE_W // 16
    cases = {}
    for qp, qp_c in EDGE_QPS:
        for kind in ("noise", "smooth", "scan_random", "scan_all_true",
                     "scan_all_false"):
            planes = edge_planes(rng, EDGE_W, EDGE_H, kind != "noise")
            mask, recon = None, None
            if kind.startswith("scan"):
                mask = {"scan_random": rng.random((mbh, mbw)) < 0.5,
                        "scan_all_true": np.ones((mbh, mbw), bool),
                        "scan_all_false": np.zeros((mbh, mbw), bool)}[kind]
                recon = edge_planes(rng, EDGE_W, EDGE_H)
            cases[f"{kind}_qp{qp}_qpc{qp_c}"] = (*planes, qp, qp_c, mask,
                                                 recon)
    return cases


H265_INTRA_QPS = ((0, 0), (22, 22), (30, 29), (51, 39), (51, 51))
H265_ANGLES = (32, 26, 21, 17, 13, 9, 5, 2)      # HEVC modes 2..9


def h265_intra_patterns(w: int, h: int, seed: int = 13) -> dict:
    """K4 input planes at w x h, name -> (y, u, v) uint8, made from
    `seed`: flat 0, 128 and 255 (every candidate ties: planar wins),
    uniform noise (the largest coefficients, levels on their clamps),
    stripes along each angle of modes 2..9 (constant along y + x*a/32,
    which the left-only angular candidate of that angle predicts) and
    horizontal and vertical ramps."""
    rng = np.random.default_rng(seed)

    def planes(fn):
        return tuple(fn(*np.mgrid[0:ph, 0:pw]).clip(0, 255).astype(np.uint8)
                     for ph, pw in ((h, w), (h // 2, w // 2),
                                    (h // 2, w // 2)))
    pats = {f"flat_{k}": planes(lambda yy, xx, k=k: np.full(yy.shape, k))
            for k in (0, 128, 255)}
    pats["noise"] = planes(lambda yy, xx: rng.integers(0, 256, yy.shape))
    for a in H265_ANGLES:
        pats[f"stripes_a{a}"] = planes(
            lambda yy, xx, a=a: 128 + 100 * np.sin(
                2 * np.pi * (yy + xx * a / 32) / 7.3))
    pats["ramp_horizontal"] = planes(lambda yy, xx: 20 + 2 * xx)
    pats["ramp_vertical"] = planes(lambda yy, xx: 30 + 4 * yy)
    return pats


def h265_intra_edge_cases() -> dict:
    """K4 edge cases as numpy arrays at EDGE_W x EDGE_H: name -> (y, u,
    v, qp, qp_c), the arguments of h265_intra_cols; every pattern of
    h265_intra_patterns at every qp / qp_c of H265_INTRA_QPS."""
    return {f"{name}_qp{qp}_qpc{qp_c}": (*planes, qp, qp_c)
            for name, planes in h265_intra_patterns(EDGE_W, EDGE_H).items()
            for qp, qp_c in H265_INTRA_QPS}


def _cuda(x):
    """numpy arrays (also inside tuples) as tensors on the card; other
    values as they are."""
    if isinstance(x, tuple):
        return tuple(_cuda(p) for p in x)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(x)).cuda()
    return x


def deblock_case_args(case) -> tuple:
    """h264_deblock_rows' arguments on the card for a deblock_edge_cases
    entry (bS from compute_bs on the card)."""
    from ceracoder_tpu_torch.ops.deblock import compute_bs

    y, u, v, nnz, mv, qp, qp_c, intra_frame, imb = case
    bs_v, bs_h = compute_bs(_cuda(nnz), _cuda(mv), intra_frame, _cuda(imb))
    return (_cuda(y), _cuda(u), _cuda(v), bs_v, bs_h, qp, qp_c)


def random_deblock_args(gen: np.random.Generator, w: int, h: int, qp: int,
                        qp_c: int) -> tuple:
    """K2 arguments on the card with every bS drawn from 0..4, also on
    the picture's left edge (compute_bs would give 0 there)."""
    mbh, mbw = h // 16, w // 16
    planes = _cuda(edge_planes(gen, w, h))
    bs_v = _cuda(gen.integers(0, 5, (mbh, mbw, 4, 4)).astype(np.int32))
    bs_h = _cuda(gen.integers(0, 5, (mbh, mbw, 3, 4)).astype(np.int32))
    return (*planes, bs_v, bs_h, qp, qp_c)


def random_intra16_args(gen: np.random.Generator, w: int, h: int, qp: int,
                        qp_c: int, scan: bool) -> tuple:
    mbh, mbw = h // 16, w // 16
    planes = _cuda(edge_planes(gen, w, h, smooth=False))
    if not scan:
        return (*planes, qp, qp_c, None, None)
    return (*planes, qp, qp_c, _cuda(gen.random((mbh, mbw)) < 0.5),
            _cuda(edge_planes(gen, w, h)))


def _flat_outputs(out) -> list:
    """Every tensor a K2-K4 call returns, in one order."""
    if isinstance(out, dict):
        return [*(out[k] for k in sorted(out) if k != "recon"),
                *out["recon"]]
    return list(out)


def kernel_err(kernel, plain, args) -> int:
    """Largest difference between a kernel's and its plain version's
    outputs on `args` (shapes and dtypes must agree)."""
    got = _flat_outputs(kernel(*args))
    want = _flat_outputs(plain(*args))
    torch.cuda.synchronize()
    check(len(got) == len(want), "output count")
    err = 0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"output {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0)
    return err


def capture_h264_kernel_inputs(width: int, height: int, texture: int):
    """The arguments that the CABAC encoder (H264Encoder's defaults)
    hands K2 and K3 for frame 0 (IDR) and frame 1 (P) of the device
    source: {"h264_deblock_rows": [IDR, P], "h264_intra16_cols": [IDR,
    P]}."""
    import ceracoder_tpu_torch.ops.deblock as deblock
    import ceracoder_tpu_torch.ops.inter as inter
    import ceracoder_tpu_torch.ops.intra as intra
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    captured = {"h264_deblock_rows": [], "h264_intra16_cols": []}
    slots = [(deblock, "h264_deblock_rows"), (intra, "h264_intra16_cols"),
             (inter, "h264_intra16_cols")]
    reals = [getattr(mod, name) for mod, name in slots]

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, tuple):
            return tuple(clone(p) for p in a)
        return a

    def spy(name, real):
        def run(*args):
            captured[name].append(tuple(clone(a) for a in args))
            return real(*args)
        run.launches = 0        # the wrapper counts on its module's name
        return run
    for (mod, name), real in zip(slots, reals):
        setattr(mod, name, spy(name, real))
    try:
        src = DeviceTestPatternSource(width, height, texture=texture)
        enc = H264Encoder(width, height, qp=28, gop=60)
        for p in enc.encode_run_async(source=src, indices=range(2)):
            p.result()
    finally:
        for (mod, name), real in zip(slots, reals):
            setattr(mod, name, real)
    for name, got in captured.items():
        check(len(got) == 2, f"captured {len(got)} {name} calls, want 2")
    check(captured["h264_intra16_cols"][1][5] is not None,
          "the P frame's K3 call is not the intra-in-P scan")
    return captured


def graph_replay_ms(fn, iters: int = 3) -> float:
    """CUDA-event milliseconds per replay of fn() captured in one CUDA
    graph: the launch-free yardstick for a loop of small kernels (it
    keeps each kernel's device cost and the gaps between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                          # warm-up: tables, allocator
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_cuda(graph.replay, iters, warmup=1)
    del graph
    torch.cuda.synchronize()
    return ms


# integer operations per MB that the work needs (the operations bound):
# K2 evaluates each edge's conditions and filter on every sample line,
# about 60 operations for a luma line (16 per edge, 4 vertical and 3
# horizontal edges) and 30 for a chroma one (8 per edge, 3 edges, two
# components). K3 per MB: the SADs of two candidates (3 per sample,
# 384 samples), the residual (1 each), the forward and the inverse
# butterflies (64 and 96 per 4x4 block, 24 blocks), quant (6 per
# coefficient), dequant (2) and the clamped reconstruction (3), and the
# DC Hadamards, their quant and scaling (about 400).
DEBLOCK_OPS_PER_MB = 60 * 16 * 7 + 30 * 8 * 3 * 2
INTRA16_OPS_PER_MB = (3 * 2 * 384 + 384 + (64 + 96) * 24 + (6 + 2 + 3) * 384
                      + 400)
# K4 per CTB: the 12 luma candidates (about 6 operations a sample) and
# their differences (1); the 48 8x8 Hadamards (24 adds per 8-sample
# vector, 16 vectors, and 128 for |.| and the sum); the 16x16 forward
# and inverse transforms (two stages each way, 16 multiply-adds per
# coefficient and stage); quant and dequant (10 per coefficient) and
# the clamped reconstruction (3); chroma's candidate (6 a sample), its
# residual (1), its 8x8 transform chain (8 multiply-adds per stage),
# quant, dequant and reconstruction (13).
H265_INTRA_OPS_PER_CTB = (12 * 256 * (6 + 1) + 48 * (16 * 24 + 128)
                          + 4 * 2 * 16 * 256 + (10 + 3) * 256
                          + 128 * (6 + 1 + 4 * 2 * 8 + 13))


# kernels that one call of a wrapper launches (K3 and K4: a carry pass
# and a code pass), where not 1
KERNELS_PER_CALL = {"h264_intra16_cols": 2, "h265_intra_cols": 2}


def kernel_numbers(name: str, kernel, plain, args, ops: int) -> dict:
    """Equality and timings of a column-loop kernel (K2-K4) on one
    input: the kernel's device time per call (torch.profiler, median of
    5 windows), the plain loop's device time and launches
    (torch.profiler, one call after a warm-up) and its CUDA-event time
    per call, and the CUDA-graph replay of the plain loop (the
    yardstick, ROADMAP.md §2). The bound counts the call's inputs and
    outputs, not a wrapper's scratch."""
    iters = 20
    out = {"max_abs_err": kernel_err(kernel, plain, args)}
    dev = kernel_event_ms(lambda: kernel(*args), name.rsplit("_", 1)[0],
                          iters, KERNELS_PER_CALL.get(name, 1))
    out.update(ms=dev["ms"], spread=dev["spread"], lost=dev["lost_events"],
               dropped=dev["dropped_windows"], per_kernel=dev["per_kernel"],
               kernels_per_call=KERNELS_PER_CALL.get(name, 1))
    out["event_ms"] = time_cuda(lambda: kernel(*args), iters)
    plain(*args)
    out["plain_launches"], out["plain_ms"] = kernel_launches(
        lambda: plain(*args))
    out["event_plain_ms"] = time_cuda(lambda: plain(*args), 1, warmup=0)
    out["graph_ms"] = graph_replay_ms(lambda: plain(*args))
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    tensors += [p for a in args if isinstance(a, tuple) for p in a]
    outs = _flat_outputs(kernel(*args))
    nbytes = sum(t.numel() * t.element_size() for t in tensors + outs)
    y = args[0]
    nops = ops * (y.shape[0] // 16) * (y.shape[1] // 16)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S) * 1e3
    out.update(
        bound_ms=bound_ms,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= nops / INT32_OPS_PER_S else "operations"),
        bound_share=bound_ms / out["ms"], bytes=nbytes, ops=nops,
        library_ms=None, shape=list(y.shape))
    return out


def print_kernel_numbers(tag: str, label: str, n: dict) -> None:
    k = n["kernels_per_call"]
    split = ""
    if k > 1:
        split = " = " + " + ".join(f"{ms:.6f} ({name})" for name, ms
                                   in n["per_kernel"].items())
    print(f"{tag} {label} {n['shape']}: max_abs_err={n['max_abs_err']}; "
          f"device ms per call, {k} kernel(s) (profiler, median [min, max] "
          f"of 5 windows of 20 calls) {n['ms']:.6f}{split} {n['spread']} "
          f"(events not recorded {n['lost']} of {100 * k}; windows set "
          f"aside for losing all of a kernel's events {n['dropped']}), "
          f"CUDA-event ms per call {n['event_ms']:.6f}; plain loop: "
          f"{n['plain_launches']} launches, device ms {n['plain_ms']:.6f}, "
          f"CUDA-event ms {n['event_plain_ms']:.3f}; CUDA-graph replay of "
          f"the plain loop {n['graph_ms']:.6f} ms; bound_ms="
          f"{n['bound_ms']:.6f} ({n['bound_by']}, {n['bytes']} B, "
          f"{n['ops']} ops), share of bound {n['bound_share']:.4f}; "
          f"kernel below the graph replay: {n['ms'] < n['graph_ms']}")


def phase_h264_kernels(tag: str) -> dict:
    """K2 and K3 against their plain versions: the edge cases, random
    1080p inputs and the real 1080p IDR and P inputs (equal element for
    element), then timed on the real inputs."""
    from ceracoder_tpu_torch.ops.deblock import (
        deblock_frame_rows_ref, h264_deblock_rows)
    from ceracoder_tpu_torch.ops.intra import (
        _encode_mb_cols_ref, h264_intra16_cols)

    pairs = {"h264_deblock_rows": (h264_deblock_rows,
                                   deblock_frame_rows_ref),
             "h264_intra16_cols": (h264_intra16_cols, _encode_mb_cols_ref)}
    errs = {name: [] for name in pairs}
    for name, case in deblock_edge_cases().items():
        errs["h264_deblock_rows"].append(kernel_err(
            *pairs["h264_deblock_rows"], deblock_case_args(case)))
    for name, case in intra16_edge_cases().items():
        errs["h264_intra16_cols"].append(kernel_err(
            *pairs["h264_intra16_cols"], _cuda(case)))
    print(f"{tag} K2 edge cases ({len(errs['h264_deblock_rows'])}, "
          f"{EDGE_W}x{EDGE_H}, bS 0-4, qp / qp_c {list(EDGE_QPS)}): "
          f"max_abs_err={max(errs['h264_deblock_rows'])}; K3 edge cases "
          f"({len(errs['h264_intra16_cols'])}: noise, smooth, masks random"
          f" / all true / all false): max_abs_err="
          f"{max(errs['h264_intra16_cols'])}")
    gen = np.random.default_rng(2027)
    for w, h in ((EDGE_W, EDGE_H), (ODD_W, ODD_H), (1920, 1088)):
        for qp, qp_c in ((0, 0), (51, 51), (28, 28)):
            a = random_deblock_args(gen, w, h, qp, qp_c)
            errs["h264_deblock_rows"].append(
                kernel_err(*pairs["h264_deblock_rows"], a))
            for scan in (False, True):
                a = random_intra16_args(gen, w, h, qp, qp_c, scan)
                errs["h264_intra16_cols"].append(
                    kernel_err(*pairs["h264_intra16_cols"], a))
    print(f"{tag} K2 / K3 on random planes {EDGE_W}x{EDGE_H}, "
          f"{ODD_W}x{ODD_H} ({ODD_W // 16} MB columns) and 1920x1088 (bS "
          f"drawn from 0..4 everywhere; K3 with and without a random mask), "
          f"qp / qp_c 0, 51, 28: max_abs_err "
          f"{max(errs['h264_deblock_rows'][-9:])} / "
          f"{max(errs['h264_intra16_cols'][-18:])}")
    real = capture_h264_kernel_inputs(1920, 1088, 6)
    ops = {"h264_deblock_rows": DEBLOCK_OPS_PER_MB,
           "h264_intra16_cols": INTRA16_OPS_PER_MB}
    numbers = {}
    for name, (kernel, plain) in pairs.items():
        numbers[name] = {}
        for kind, args in zip(("IDR", "P"), real[name]):
            n = kernel_numbers(name, kernel, plain, args, ops[name])
            numbers[name][kind] = n
            errs[name].append(n["max_abs_err"])
            label = {"h264_deblock_rows": "K2 deblock",
                     "h264_intra16_cols": "K3 Intra_16x16 "
                     + ("IDR loop" if kind == "IDR" else "intra-in-P scan")
                     }[name]
            print_kernel_numbers(tag, f"{label}, 1080p {kind} frame",
                                      n)
        numbers[name]["max_abs_err"] = max(errs[name])
        check(max(errs[name]) == 0, f"{name} differs from its plain version")
        kernel.launches = 0
    return numbers


def capture_k4_calls(run) -> list:
    """The arguments (cloned) of every K4 call that run() makes."""
    import ceracoder_tpu_torch.ops.h265 as h265

    captured, real = [], h265.h265_intra_cols

    def spy(*args):
        captured.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args))
        return real(*args)
    spy.launches = 0            # the wrapper counts on its module's name
    h265.h265_intra_cols = spy
    try:
        run()
    finally:
        h265.h265_intra_cols = real
    return captured


def capture_h265_intra_inputs(width: int, height: int, texture: int):
    """The arguments that H265DeviceEncoder(qp=30) hands K4 for frame 0
    (the IDR) of the device source."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    src = DeviceTestPatternSource(width, height, texture=texture)
    enc = H265DeviceEncoder(width, height, qp=30, gop=60)
    captured = capture_k4_calls(lambda: enc.encode_run_async(
        source=src, indices=range(1))[0].result())
    check(len(captured) == 1, f"captured {len(captured)} K4 calls, want 1")
    return captured[0]


def phase_h265_kernels(tag: str) -> dict:
    """K4 against its plain version: the edge cases, random planes at
    112x48 and 1080p at random QPs, the real 1080p IDR and one 4K IDR of
    the device source (equal element for element), then timed on the
    real 1080p and 4K inputs."""
    from ceracoder_tpu_torch.ops.h265 import _i_frame_cols_ref, h265_intra_cols

    pair = (h265_intra_cols, _i_frame_cols_ref)
    errs = [kernel_err(*pair, _cuda(case))
            for case in h265_intra_edge_cases().values()]
    print(f"{tag} K4 edge cases ({len(errs)}, {EDGE_W}x{EDGE_H}: flat, "
          f"noise, stripes at the 8 angles, ramps; qp / qp_c "
          f"{list(H265_INTRA_QPS)}): max_abs_err={max(errs)}")
    gen = np.random.default_rng(2028)
    for w, h in ((EDGE_W, EDGE_H), (1920, 1088)):
        for smooth in (False, True):
            qp, qp_c = (int(q) for q in gen.integers(0, 52, 2))
            errs.append(kernel_err(*pair, (*_cuda(edge_planes(gen, w, h,
                                                              smooth)),
                                           qp, qp_c)))
    print(f"{tag} K4 on random planes {EDGE_W}x{EDGE_H} and 1920x1088 "
          f"(noise and smooth, random qp / qp_c): max_abs_err "
          f"{max(errs[-4:])}")
    numbers = {}
    for kind, (w, h) in (("1080p", (1920, 1088)), ("4K", (3840, 2160))):
        n = kernel_numbers("h265_intra_cols", *pair,
                           capture_h265_intra_inputs(w, h, 6),
                           H265_INTRA_OPS_PER_CTB)
        numbers[kind] = n
        errs.append(n["max_abs_err"])
        print_kernel_numbers(tag, f"K4 HEVC intra loop, {kind} IDR of the "
                             "device source", n)
    numbers["max_abs_err"] = max(errs)
    check(max(errs) == 0, "h265_intra_cols differs from its plain version")
    h265_intra_cols.launches = 0
    return numbers


def _kernel_wrappers() -> tuple:
    from ceracoder_tpu_torch.ops.bitpack import merge_windows
    from ceracoder_tpu_torch.ops.deblock import h264_deblock_rows
    from ceracoder_tpu_torch.ops.h265 import h265_intra_cols
    from ceracoder_tpu_torch.ops.intra import h264_intra16_cols

    return (merge_windows, h264_deblock_rows, h264_intra16_cols,
            h265_intra_cols)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _kernel_wrappers():
        fn.launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _kernel_wrappers()}


# ---------------------------------------------------------------------------
# Main path and GPU-vs-CPU
# ---------------------------------------------------------------------------

def check_stream(data: bytes, mbh: int) -> None:
    check(data.startswith(b"\x00\x00\x00\x01"), "frame lacks a start code")
    nals = data.count(b"\x00\x00\x01")
    check(nals == mbh, f"{nals} NAL units, want one per MB row ({mbh})")


def phase_main_path(tag: str) -> dict:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H264Encoder(w, h, qp=28, gop=60, cabac=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, run_secs, run_split = [], [], []
    t0 = time.perf_counter()
    for r in range(runs):
        t = time.perf_counter()
        pend = enc.encode_run_async(
            source=src, indices=range(r * run_len, (r + 1) * run_len))
        t_launch = time.perf_counter()
        frames += [p.result() for p in pend]
        t_result = time.perf_counter()
        torch.cuda.synchronize()
        run_secs.append(time.perf_counter() - t)
        run_split.append((t_launch - t, t_result - t_launch,
                          time.perf_counter() - t_result))
    secs = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["merge_windows"]
    nf = runs * run_len
    check(len(frames) == nf, "frame count")
    check([f.keyframe for f in frames] == [True] + [False] * (nf - 1),
          "GOP structure (1 IDR + P frames)")
    for f in frames:
        check_stream(f.data, h // 16)
    rec = frames[-1].recon
    check(rec[0].shape == (h, w) and rec[1].shape == (h // 2, w // 2),
          "recon shapes")
    check(launches >= nf, f"K1 launched {launches} times for {nf} frames")
    check(counts["h264_deblock_rows"] >= nf,
          f"K2 launched {counts['h264_deblock_rows']} times for {nf} frames")
    check(counts["h264_intra16_cols"] >= 1, "K3 not launched for the IDR")
    sizes = [len(f.data) for f in frames]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs, "run_launch_result_sync_seconds": run_split,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "fallback_frames": enc.fallback_frames, "k1_launches": launches,
        "launches": counts,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} main path 1080p CAVLC: {nf} frames in {secs:.3f} s "
          f"= {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s; of each, "
          f"encode_run_async / the results / the last sync: "
          f"{'; '.join(' / '.join(f'{x:.3f}' for x in r) for r in run_split)}"
          f" s)")
    print(f"{tag} main path bytes/frame: IDR {out['bytes_idr']}, P mean "
          f"{out['bytes_p_mean']:.1f}; fallback frames "
          f"{out['fallback_frames']}; kernel launches {counts}; peak device "
          f"memory {out['peak_mem_bytes']} B")
    return out


def encode_stream(device: str, w: int, h: int, runs, gop: int, qp: int,
                  texture: int, cabac: bool = False, frames=None) -> bytes:
    """H.264 runs of the device test pattern, or of host `frames`."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    src = DeviceTestPatternSource(w, h, texture=texture, device=device)
    enc = H264Encoder(w, h, qp=qp, gop=gop, cabac=cabac, device=device)
    data = enc.headers()
    for idx in runs:
        if frames is None:
            pend = enc.encode_run_async(source=src, indices=idx)
        else:
            pend = enc.encode_run_async([frames[i] for i in idx])
        data += b"".join(p.result().data for p in pend)
    return data


def phase_gpu_equals_cpu(tag: str, main: dict) -> None:
    runs = [range(0, 3), range(3, 6)]
    t = time.perf_counter()
    gpu = encode_stream("cuda", 320, 192, runs, 4, 30, 6)
    cpu = encode_stream("cpu", 320, 192, runs, 4, 30, 6)
    check(gpu == cpu, "320x192 GPU and CPU streams differ")
    print(f"{tag} GPU == CPU at 320x192, 6 frames, gop 4, 2 runs: "
          f"{len(gpu)} B identical ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    src = DeviceTestPatternSource(1920, 1088, texture=6, device="cpu")
    enc = H264Encoder(1920, 1088, qp=28, gop=60, cabac=False, device="cpu")
    cpu2 = b"".join(p.result().data
                    for p in enc.encode_run_async(source=src,
                                                  indices=range(2)))
    check(cpu2 == main["first_two"],
          "1080p IDR + P frame: GPU and CPU bytes differ")
    print(f"{tag} GPU == CPU at 1920x1088, first IDR + P frame: "
          f"{len(cpu2)} B identical (CPU run {time.perf_counter() - t:.2f} s)")


# ---------------------------------------------------------------------------
# HEVC main path and GPU-vs-CPU
# ---------------------------------------------------------------------------

NAL_IDR_W_RADL, NAL_TRAIL_R, NAL_TRAIL_N = 19, 1, 0


def check_hevc_frame(data: bytes, idr: bool, kind: str | None = None,
                     nals: int = 1) -> None:
    """One frame: `nals` NAL units (by default one: one slice, a tile per
    CTB row; in slice mode one per CTB row) behind a 4-byte start code,
    of the frame's NAL type (by `kind`, "I", "P" or "B", where given)."""
    check(data.startswith(b"\x00\x00\x00\x01"), "frame lacks a start code")
    got_nals = data.count(b"\x00\x00\x01")
    check(got_nals == nals, f"{got_nals} NAL units, want {nals}")
    want = ({"I": NAL_IDR_W_RADL, "P": NAL_TRAIL_R, "B": NAL_TRAIL_N}[kind]
            if kind else NAL_IDR_W_RADL if idr else NAL_TRAIL_R)
    got = (data[4] >> 1) & 0x3F
    check(got == want, f"NAL type {got}, want {want}")


def phase_hevc_main_path(tag: str, label: str = "HEVC main path") -> dict:
    """Phase 6 (and phase 18 (b) with the deblock patched out)."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H265DeviceEncoder(w, h, qp=30, gop=60)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, run_secs = [], []
    t0 = time.perf_counter()
    for r in range(runs):
        t = time.perf_counter()
        pend = enc.encode_run_async(
            source=src, indices=range(r * run_len, (r + 1) * run_len))
        frames += [p.result() for p in pend]
        torch.cuda.synchronize()
        run_secs.append(time.perf_counter() - t)
    secs = time.perf_counter() - t0
    launches = read_launches()
    nf = runs * run_len
    check(len(frames) == nf, "frame count")
    check([f.keyframe for f in frames] == [True] + [False] * (nf - 1),
          "GOP structure (1 IDR + P frames)")
    for f in frames:
        check_hevc_frame(f.data, f.keyframe)
    rec = frames[-1].recon
    check(rec[0].shape == (h, w) and rec[1].shape == (h // 2, w // 2)
          and rec[2].shape == (h // 2, w // 2), "recon shapes")
    check(all(f._recon_dev[0].device.type == "cuda" for f in frames),
          "recon not on the card")
    check_hevc_launches(launches, 1)
    peak = torch.cuda.max_memory_allocated()
    frame_launches = hevc_frame_launches(enc, src, nf)
    sizes = [len(f.data) for f in frames]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "fallback_frames": enc.fallback_frames, "launches": launches,
        **frame_launches, "peak_mem_bytes": peak,
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} {label} 1080p: {nf} frames in {secs:.3f} s "
          f"= {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} {label} bytes/frame: IDR {out['bytes_idr']}, P "
          f"mean {out['bytes_p_mean']:.1f}; fallback frames "
          f"{out['fallback_frames']}; hand-kernel launches {launches}; "
          f"peak device memory {peak} B; {describe_frame_launches(out)}")
    return out


def check_hevc_launches(launches: dict, idrs: int) -> None:
    """An HEVC run launches K4 once per IDR and no other hand kernel."""
    want = {name: idrs if name == "h265_intra_cols" else 0
            for name in launches}
    check(launches == want, f"hand-kernel launches {launches} on the HEVC "
          f"path, want {want}")


def hevc_frame_launches(enc, src, n: int, idr_limit: int = 1000) -> dict:
    """CUDA launches and device ms of one more P frame and one more IDR
    of `enc` (frames n, n + 1 of `src`; torch.profiler). Checks that the
    IDR stays under `idr_limit` launches (its column loop is K4: the
    plain loop alone launches about 33,000 at 1080p)."""
    p_launches, p_ms = kernel_launches(
        lambda: enc.encode_run_async(source=src, indices=[n])[0].result())
    idr_launches, idr_ms = kernel_launches(
        lambda: enc.encode_run_async(source=src, indices=[n + 1],
                                     force_idr=True)[0].result())
    check(idr_launches < idr_limit,
          f"{idr_launches} CUDA launches for an HEVC IDR: the column loop "
          "is not in K4")
    return {"launches_per_p_frame": p_launches,
            "device_ms_per_p_frame": p_ms,
            "launches_per_idr": idr_launches, "device_ms_per_idr": idr_ms}


def describe_frame_launches(out: dict) -> str:
    return (f"one more P frame: {out['launches_per_p_frame']} CUDA "
            f"launches, {out['device_ms_per_p_frame']:.3f} device ms; one "
            f"more IDR: {out['launches_per_idr']} CUDA launches, "
            f"{out['device_ms_per_idr']:.3f} device ms")


def encode_hevc_stream(device: str, w: int, h: int, runs, gop: int,
                       qp: int, texture: int, sao: bool = False) -> bytes:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    src = DeviceTestPatternSource(w, h, texture=texture, device=device)
    enc = H265DeviceEncoder(w, h, qp=qp, gop=gop, device=device, sao=sao)
    data = enc.headers()
    for idx in runs:
        data += b"".join(p.result().data
                         for p in enc.encode_run_async(source=src,
                                                       indices=idx))
    return data


def phase_hevc_gpu_equals_cpu(tag: str, main: dict,
                              sao: bool = False) -> None:
    label = "HEVC with SAO" if sao else "HEVC"
    runs = [range(0, 3), range(3, 6)]
    t = time.perf_counter()
    gpu = encode_hevc_stream("cuda", 320, 192, runs, 4, 30, 6, sao)
    cpu = encode_hevc_stream("cpu", 320, 192, runs, 4, 30, 6, sao)
    check(gpu == cpu, f"{label} 320x192 GPU and CPU streams differ")
    print(f"{tag} {label} GPU == CPU at 320x192, 6 frames, gop 4, 2 runs: "
          f"{len(gpu)} B identical ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    cpu2 = encode_hevc_stream("cpu", 1920, 1088, [range(2)], 60, 30, 6, sao)
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    hdr = H265DeviceEncoder(1920, 1088, qp=30, gop=60, device="cpu",
                            sao=sao).headers()
    check(cpu2 == hdr + main["first_two"],
          f"{label} 1080p IDR + P frame: GPU and CPU bytes differ")
    print(f"{tag} {label} GPU == CPU at 1920x1088, first IDR + P frame: "
          f"{len(main['first_two'])} B identical (CPU run "
          f"{time.perf_counter() - t:.2f} s)")


class SaoCount:
    """The SAO types of each frame that H265DeviceEncoder codes, by
    wrapping the entropy stage's call in codec/h265/device.py."""

    def __init__(self):
        import ceracoder_tpu_torch.codec.h265.device as device

        self.mod, self.real = device, device.entropy_rows_native
        self.types = []

        def entropy(p, arrays, *a, **kw):
            self.types.append(arrays["sao"][:, :, :, 0].copy())
            return self.real(p, arrays, *a, **kw)
        device.entropy_rows_native = entropy

    def close(self):
        self.mod.entropy_rows_native = self.real


def phase_hevc_sao(tag: str) -> dict:
    """bench.py's SAO cell: H265DeviceEncoder(1920, 1088, qp=30, gop=60,
    sao=True) on the device test pattern, 3 runs of 10 frames."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H265DeviceEncoder(w, h, qp=30, gop=60, sao=True)
    count = SaoCount()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, run_secs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(runs):
            t = time.perf_counter()
            pend = enc.encode_run_async(
                source=src, indices=range(r * run_len, (r + 1) * run_len))
            frames += [p.result() for p in pend]
            torch.cuda.synchronize()
            run_secs.append(time.perf_counter() - t)
        secs = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        types = np.stack(count.types)                 # (frames, nch, ncw, 3)
    finally:
        count.close()
    nf = runs * run_len
    check(len(frames) == nf and len(types) == nf, "frame count")
    check([f.keyframe for f in frames] == [True] + [False] * (nf - 1),
          "GOP structure (1 IDR + P frames)")
    for f in frames:
        check_hevc_frame(f.data, f.keyframe)
    rec = frames[-1].recon
    check(rec[0].shape == (h, w) and rec[2].shape == (h // 2, w // 2),
          "recon shapes")
    check_hevc_launches(launches, 1)
    on = {"luma": int((types[..., 0] != 0).sum()),
          "luma_band": int((types[..., 0] == 1).sum()),
          "luma_edge": int((types[..., 0] == 2).sum()),
          "chroma": int((types[..., 1] != 0).sum()), "of": types[..., 0].size}
    check(on["luma"] + on["chroma"] > 0,
          "SAO taken on no CTB of the 1080p run")
    # SAO's plain-torch stage adds about 400 launches to each frame
    frame_launches = hevc_frame_launches(enc, src, nf, idr_limit=1500)
    sizes = [len(f.data) for f in frames]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "sao_ctbs_on": on, "fallback_frames": enc.fallback_frames,
        "launches": launches, **frame_launches, "peak_mem_bytes": peak,
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} HEVC with SAO 1080p: {nf} frames in {secs:.3f} s = "
          f"{out['fps']:.3f} frames/s (runs 2-3: {out['fps_runs_2_3']:.3f} "
          f"frames/s; per run {', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} HEVC with SAO bytes/frame: IDR {out['bytes_idr']}, P mean "
          f"{out['bytes_p_mean']:.1f}; CTBs with SAO on, of {on['of']} in "
          f"{nf} frames: luma {on['luma']} (band {on['luma_band']}, edge "
          f"{on['luma_edge']}), chroma {on['chroma']}; "
          f"fallback frames {out['fallback_frames']}; hand-kernel launches "
          f"{launches}; peak device memory {peak} B; "
          f"{describe_frame_launches(out)}")
    return out


class RowCount:
    """Per frame that H265DeviceEncoder codes, its slice type, its slice
    bytes (RBSP) and a copy of its unpacked rows' per-CTB arrays (not
    the levels), by wrapping the entropy stage's call in
    codec/h265/device.py; the statistics are taken afterwards, outside
    the timed runs. totals() counts the CTBs that take the TU split,
    code intra, (B) carry list-1 MVs unlike list 0, could merge (inter,
    every list's MV the left inter neighbour's or zero: the native
    coder's merge candidates) and hold a sub-pel MV component;
    level_free_bytes() codes the same frames again with every level
    zeroed: the bytes of the CU syntax alone (skip/merge, modes, MVDs,
    SAO), the rest being the residual's."""

    def __init__(self):
        import ceracoder_tpu_torch.codec.h265.device as device

        self.mod, self.real = device, device.entropy_rows_native
        self.calls = []

        def entropy(p, arrays, qp, idr, *a, slice_type=None, **kw):
            rbsps = self.real(p, arrays, qp, idr, *a, slice_type=slice_type,
                              **kw)
            ctb = {k: np.array(v) for k, v in arrays.items()
                   if not k.endswith("_lv")}
            self.calls.append((slice_type or ("I" if idr else "P"),
                               sum(len(r) for r in rbsps),
                               (p, ctb, qp, idr, *a), slice_type, kw))
            return rbsps
        device.entropy_rows_native = entropy

    @staticmethod
    def _stats(ctb: dict, is_b: bool) -> dict:
        mv = ctb["mv"]
        mv1 = ctb["mv1"] if is_b else np.zeros_like(mv)
        inter = ~ctb["is_intra"]
        mvs = np.concatenate([mv, mv1], -1)
        left = np.zeros_like(inter)
        left[:, 1:] = inter[:, :-1] & (mvs[:, 1:] == mvs[:, :-1]).all(-1)
        return {"split": int(ctb["tu_split"].sum()),
                "intra": int(ctb["is_intra"].sum()),
                "mv1_differs": int((mv1 != mv).any(-1).sum()) if is_b else 0,
                "merge": int((inter & (left | (mvs == 0).all(-1))).sum()),
                "subpel": int((inter & (mvs % 4 != 0).any(-1)).sum())}

    def totals(self, kind: str) -> dict:
        out = {"frames": 0, "bytes": 0}
        for k, size, args, _, _ in self.calls:
            if k != kind:
                continue
            out["frames"] += 1
            out["bytes"] += size
            for name, n in self._stats(args[1], kind == "B").items():
                out[name] = out.get(name, 0) + n
        return out

    def level_free_bytes(self, kind: str) -> int:
        """The summed slice bytes of the `kind` frames coded again with
        every level zeroed."""
        total = 0
        for k, _, (p, ctb, *rest), slice_type, kw in self.calls:
            if k == kind:
                nch, ncw = ctb["is_intra"].shape
                zeros = {"luma_lv": np.zeros((nch, ncw, 16, 16), np.int16),
                         "cb_lv": np.zeros((nch, ncw, 8, 8), np.int16),
                         "cr_lv": np.zeros((nch, ncw, 8, 8), np.int16)}
                total += sum(len(r) for r in self.real(
                    p, ctb | zeros, *rest, slice_type=slice_type, **kw))
        return total

    def close(self):
        self.mod.entropy_rows_native = self.real


def b_coding_order(runs: int, run_len: int, gop: int) -> list:
    """(poc, kind) of every frame that encode_run_b_async codes from
    `runs` runs of `run_len` display frames (H265DeviceEncoder's
    schedule: an IDR where the GOP ends, (B, P) pairs with the P first,
    a frame without a partner as P)."""
    order, poc, have_ref = [], 0, False
    for _ in range(runs):
        i = 0
        while i < run_len:
            if not have_ref or poc >= gop:
                order.append((0, "I"))
                poc, have_ref, i = 1, True, i + 1
                continue
            npair = 0
            while (i + 2 * (npair + 1) <= run_len
                   and poc + 2 * npair <= gop - 2):
                npair += 1
            if not npair:
                order.append((poc, "P"))
                poc, i = poc + 1, i + 1
                continue
            for k in range(npair):
                order += [(poc + 2 * k + 1, "P"), (poc + 2 * k, "B")]
            poc, i = poc + 2 * npair, i + 2 * npair
    return order


def pair_frame_launches(enc, src, n: int) -> dict:
    """CUDA launches and device ms (torch.profiler) of one more (B, P)
    pair of `enc` (display frames n, n + 1 of `src`), frame by frame:
    the TU-split P frame, then the B frame between the old reference
    and the P frame's, each as encode_run_b_async codes it (its frame
    hook, ops/h265.py: run_frame, wraps each frame's device work in the
    profiler); then the pair's host rows and entropy stage."""
    got = {}

    def hook(kind, run, refs):
        out = []
        got[kind] = kernel_launches(lambda: out.append(run()))
        return out[0]

    run = enc.encode_run_b_async(source=src, indices=[n, n + 1],
                                 frame_hook=hook)
    for pf, _, _ in run:
        pf.result()
    check([kind for _, _, kind in run] == ["P", "B"] and len(got) == 2,
          f"one more pair coded as {[kind for _, _, kind in run]}")
    (p_launches, p_ms), (b_launches, b_ms) = got["P"], got["B"]
    return {"launches_per_split_p_frame": p_launches,
            "device_ms_per_split_p_frame": p_ms,
            "launches_per_b_frame": b_launches, "device_ms_per_b_frame": b_ms}


def phase_hevc_bframes(tag: str, w: int = 1920, h: int = 1088) -> dict:
    """HEVC B frames + TU split: H265DeviceEncoder(w, h, qp=30, gop=60,
    bframes=1, tu_split=True) on the device test pattern, 3 runs of 10
    frames through encode_run_b_async."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    runs, run_len, gop = 3, 10, 60
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H265DeviceEncoder(w, h, qp=30, gop=gop, bframes=1, tu_split=True)
    count = RowCount()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    items, run_secs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(runs):
            t = time.perf_counter()
            run = enc.encode_run_b_async(
                source=src, indices=range(r * run_len, (r + 1) * run_len))
            items += [(p.result(), poc, kind) for p, poc, kind in run]
            torch.cuda.synchronize()
            run_secs.append(time.perf_counter() - t)
        secs = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        count.close()
    nf = runs * run_len
    order = [(poc, kind) for _, poc, kind in items]
    check(order == b_coding_order(runs, run_len, gop),
          f"coding order {order}")
    check(order[:10] == [(0, "I"), (2, "P"), (1, "B"), (4, "P"), (3, "B"),
                         (6, "P"), (5, "B"), (8, "P"), (7, "B"), (9, "P")],
          "run 1: I, 4 pairs, a P tail")
    for f, _, kind in items:
        check_hevc_frame(f.data, kind == "I", kind)
        check(f.keyframe == (kind == "I"), "keyframe flag")
    rec = items[-1][0].recon
    check(rec[0].shape == (h, w) and rec[1].shape == (h // 2, w // 2)
          and rec[2].shape == (h // 2, w // 2), "recon shapes")
    check(all(f._recon_dev[0].device.type == "cuda" for f, _, _ in items),
          "recon not on the card")
    check_hevc_launches(launches, 1)
    used = {k: count.totals(k) for k in ("P", "B")}
    check(used["P"]["split"] > 0 and used["B"]["split"] > 0,
          f"the TU split is taken in no P or no B frame: {used}")
    check(used["B"]["mv1_differs"] > 0, f"list-1 MVs equal list 0: {used}")
    frame_launches = pair_frame_launches(enc, src, nf)
    sizes = {k: [len(f.data) for f, _, kind in items if kind == k]
             for k in "IPB"}
    # the slice bytes of the CU syntax alone (levels zeroed) and of the
    # residual, mean per P and per B frame
    bits = {k: {"slice": used[k]["bytes"] / used[k]["frames"],
                "cu_syntax": count.level_free_bytes(k) / used[k]["frames"]}
            for k in used}
    for b in bits.values():
        b["residual"] = b["slice"] - b["cu_syntax"]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs, "bytes_idr": sizes["I"][0],
        "bytes_p_mean": sum(sizes["P"]) / len(sizes["P"]),
        "bytes_b_mean": sum(sizes["B"]) / len(sizes["B"]),
        "ctbs": {k: used[k] | {"of": used[k]["frames"] * (h // 16)
                               * (w // 16)} for k in used},
        "slice_bytes": bits, "fallback_frames": enc.fallback_frames,
        "launches": launches,
        **frame_launches, "peak_mem_bytes": peak,
        "first_three": b"".join(f.data for f, _, _ in items[:3]),
    }
    print(f"{tag} HEVC B frames + TU split {w}x{h}: {nf} frames in {secs:.3f} "
          f"s = {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} HEVC B frames + TU split bytes/frame: IDR "
          f"{out['bytes_idr']}, P mean {out['bytes_p_mean']:.1f}, B mean "
          f"{out['bytes_b_mean']:.1f}; CTBs (split / intra / list-1 MV "
          f"unlike list 0 / merge candidate / sub-pel MV; "
          f"slice bytes) {out['ctbs']}; mean slice bytes per frame (CU "
          f"syntax alone, levels zeroed / residual) {bits}; fallback frames "
          f"{out['fallback_frames']}; hand-kernel launches {launches}; peak "
          f"device memory {peak} B; one more pair: TU-split P frame "
          f"{out['launches_per_split_p_frame']} CUDA launches, "
          f"{out['device_ms_per_split_p_frame']:.3f} device ms, B frame "
          f"{out['launches_per_b_frame']} CUDA launches, "
          f"{out['device_ms_per_b_frame']:.3f} device ms")
    return out


def hevc_b_streams(device: str, w: int, h: int, runs, gop: int,
                   texture: int = 6) -> tuple[bytes, bytes]:
    """H265DeviceEncoder(bframes=1, tu_split=True) at qp 30 on the device
    test pattern: the push_frame/flush stream of the frames of `runs`,
    and the encode_run_b_async stream of those runs."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    src = DeviceTestPatternSource(w, h, texture=texture, device=device)

    def enc():
        return H265DeviceEncoder(w, h, qp=30, gop=gop, bframes=1,
                                 tu_split=True, device=device)
    push = enc()
    pushed = push.headers()
    for i in (i for idx in runs for i in idx):
        pushed += b"".join(c[0] for c in push.push_frame(*src.frame(i)))
    pushed += b"".join(c[0] for c in push.flush())
    run = enc()
    ran = run.headers()
    for idx in runs:
        ran += b"".join(p.result().data for p, _, _ in
                        run.encode_run_b_async(source=src, indices=idx))
    return pushed, ran


def phase_hevc_bframes_gpu_equals_cpu(tag: str, main: dict) -> None:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    runs = [range(0, 3), range(3, 6)]
    t = time.perf_counter()
    gpu = hevc_b_streams("cuda", 320, 192, runs, 4)
    cpu = hevc_b_streams("cpu", 320, 192, runs, 4)
    check(gpu[0] == cpu[0], "HEVC B 320x192 push_frame: GPU and CPU differ")
    check(gpu[1] == cpu[1],
          "HEVC B 320x192 encode_run_b_async: GPU and CPU differ")
    print(f"{tag} HEVC B frames + TU split GPU == CPU at 320x192, 6 frames, "
          f"gop 4: push_frame {len(gpu[0])} B, encode_run_b_async (2 runs) "
          f"{len(gpu[1])} B identical ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    src = DeviceTestPatternSource(1920, 1088, texture=6, device="cpu")
    enc = H265DeviceEncoder(1920, 1088, qp=30, gop=60, bframes=1,
                            tu_split=True, device="cpu")
    cpu2 = b"".join(p.result().data for p, _, _ in
                    enc.encode_run_b_async(source=src, indices=range(3)))
    check(cpu2 == main["first_three"],
          "HEVC B 1080p IDR + first pair: GPU and CPU bytes differ")
    print(f"{tag} HEVC B frames + TU split GPU == CPU at 1920x1088, first "
          f"IDR + pair: {len(cpu2)} B identical (CPU run "
          f"{time.perf_counter() - t:.2f} s)")


# ---------------------------------------------------------------------------
# Parallel encoders (phase 15): bands, GOPs and the H.264 mesh on one card
# ---------------------------------------------------------------------------

def frames_by_encode_frame(enc, src, n: int) -> tuple[list, list]:
    """encode_frame on frames 0..n-1 of `src`: each frame's bytes and its
    host ms (each call returns the coded bytes, so the frame's device
    work is done when it returns)."""
    data, host_ms = [], []
    for i in range(n):
        t = time.perf_counter()
        data.append(enc.encode_frame(*src.frame(i)).data)
        host_ms.append(1e3 * (time.perf_counter() - t))
    return data, host_ms


def spread(devices: list, n: int) -> list:
    """n slots over `devices`, round-robin (one card takes them all)."""
    return [devices[i % len(devices)] for i in range(n)]


def banded_run(tag: str, src, n_bands: int, n: int, single: list,
               devices: list, profile_p: bool = False,
               plain_bands: tuple = ()) -> dict:
    """ShardedH265Encoder(qp=30, gop=60, n_bands, the bands spread over
    `devices`) through encode_frame on frames 0..n-1 of `src` (1 IDR,
    then P):
    each frame's bytes must equal `single` (the single-device
    encode_frame's), and K4 must run once per band on the IDR and no
    other hand kernel run. With `profile_p`, the P frames/s of frames
    2..n-1 (after one warm P frame) and one more P frame under
    torch.profiler. For each band in `plain_bands`, K4 on that band's
    inputs of one more IDR against its plain version, at the band's
    shape."""
    from ceracoder_tpu_torch.ops.h265 import _i_frame_cols_ref, h265_intra_cols
    from ceracoder_tpu_torch.parallel.hevc import ShardedH265Encoder

    w, h = src.width, src.height
    enc = ShardedH265Encoder(w, h, qp=30, gop=60, n_bands=n_bands,
                             devices=spread(devices, n_bands))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    data, host_ms = frames_by_encode_frame(enc, src, n)
    secs = time.perf_counter() - t0
    launches = read_launches()
    check_hevc_launches(launches, n_bands)
    for i, d in enumerate(data):
        check_hevc_frame(d, i == 0)
    check(data == single[:n], f"{w}x{h} in {n_bands} bands: the bytes differ "
          "from the single-device encode_frame's")
    rows = [r1 - r0 for r0, r1 in enc.bounds]
    out = {"size": [w, h], "bands": n_bands, "ctb_rows_per_band": rows,
           "frames": n, "seconds": secs, "host_ms": host_ms,
           "launches": launches, "bytes": [len(d) for d in data]}
    note = ""
    if profile_p:
        out["p_fps_warm"] = (n - 2) / (1e-3 * sum(host_ms[2:]))
        p_launches, p_ms = kernel_launches(
            lambda: enc.encode_frame(*src.frame(n)))
        out.update(launches_per_p_frame=p_launches,
                   device_ms_per_p_frame=p_ms)
        note += (f"; P frames 2-{n - 1}: {out['p_fps_warm']:.3f} frames/s; "
                 f"one more P frame: {p_launches} CUDA launches, "
                 f"{p_ms:.3f} device ms")
    if plain_bands:
        calls = capture_k4_calls(
            lambda: enc.encode_frame(*src.frame(0), force_idr=True))
        check(len(calls) == n_bands, f"{len(calls)} K4 calls on a banded "
              f"IDR, want {n_bands}")
        errs = {}
        for b in plain_bands:
            with torch.cuda.device(calls[b][0].device):
                errs[b] = kernel_err(h265_intra_cols, _i_frame_cols_ref,
                                     calls[b])
            check(errs[b] == 0, f"K4 on band {b} of the {w}x{h} IDR "
                  f"({tuple(calls[b][0].shape)}) differs from its plain "
                  "version")
        out["k4_plain_bands"] = {str(b): {"shape": list(calls[b][0].shape),
                                          "max_abs_err": errs[b]}
                                 for b in plain_bands}
        out["max_abs_err"] = max(errs.values())
        note += "; K4 against its plain version on the IDR of band " + \
            ", ".join(f"{b} {tuple(calls[b][0].shape)}: max_abs_err="
                      f"{errs[b]}" for b in plain_bands)
        h265_intra_cols.launches = 0
    print(f"{tag} HEVC {w}x{h} in {n_bands} bands ({rows} CTB rows) on "
          f"{len(set(enc.devices))} card(s): {n} frames, "
          f"host ms per frame {', '.join(f'{x:.1f}' for x in host_ms)}; "
          f"bytes equal to the single-device encode_frame's "
          f"({sum(out['bytes'])} B); hand-kernel launches {launches}"
          + note)
    return out


def single_run(src, n: int, profile_p: bool = False) -> dict:
    """The single-device H265DeviceEncoder(qp=30, gop=60).encode_frame on
    frames 0..n-1 of `src`: bytes, host ms per frame and (`profile_p`)
    one more P frame's launches and device ms."""
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    enc = H265DeviceEncoder(src.width, src.height, qp=30, gop=60)
    data, host_ms = frames_by_encode_frame(enc, src, n)
    out = {"data": data, "host_ms": host_ms}
    if profile_p:
        out["launches_per_p_frame"], out["device_ms_per_p_frame"] = \
            kernel_launches(lambda: enc.encode_frame(*src.frame(n)))
    return out


def gop_parallel_run(tag: str, src, runs: int, run_len: int,
                     devices: list) -> dict:
    """GopParallelStreamEncoder(qp=30, gop=run_len, two slots spread over
    `devices`)
    for `runs` runs of `run_len` frames through encode_run_async, run N's
    results read after run N + 1 is launched (as the app's run loop):
    the bytes must equal a single-device encode_run_async at the same
    gop, and K4 must run once per GOP."""
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    from ceracoder_tpu_torch.parallel.hevc import GopParallelStreamEncoder

    w, h = src.width, src.height
    enc = GopParallelStreamEncoder(w, h, qp=30, gop=run_len,
                                   devices=spread(devices, 2))
    torch.cuda.synchronize()
    reset_launches()
    data, pending = [], []
    t0 = time.perf_counter()
    for r in range(runs):
        pend = enc.encode_run_async(
            source=src, indices=range(r * run_len, (r + 1) * run_len))
        data += [p.result().data for p in pending]
        pending = pend
    data += [p.result().data for p in pending]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    check_hevc_launches(launches, runs)
    single = H265DeviceEncoder(w, h, qp=30, gop=run_len)
    want = [p.result().data for r in range(runs)
            for p in single.encode_run_async(
                source=src, indices=range(r * run_len, (r + 1) * run_len))]
    check(data == want, "GOP-parallel bytes differ from the single-device "
          "encode_run_async's")
    n = runs * run_len
    out = {"size": [w, h], "gop": run_len, "slots": 2, "frames": n,
           "seconds": secs, "fps": n / secs, "launches": launches,
           "bytes": sum(len(d) for d in data)}
    print(f"{tag} HEVC GOP-parallel {w}x{h}, gop {run_len}, 2 slots on "
          f"{len(set(enc.devices))} card(s): {n} frames in {secs:.3f} s = "
          f"{out['fps']:.3f} frames/s; "
          f"bytes equal to the single-device encode_run_async's "
          f"({out['bytes']} B); hand-kernel launches {launches}")
    return out


def h264_mesh_run(tag: str, src, devices: list) -> dict:
    """encode_sharded(make_mesh(2, 4), 28, 28), its 8 cells spread over
    `devices`, on 2 streams
    (frames 0 and 1 of `src`): every array must equal
    encode_frame_i16_rows per stream on the card, and K3 must run 8 times
    (once per stream and band) and no other hand kernel."""
    from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows
    from ceracoder_tpu_torch.parallel.mesh import (
        band_bounds,
        encode_sharded,
        make_mesh,
    )

    planes = [torch.stack(p) for p in zip(src.frame(0), src.frame(1))]
    step = encode_sharded(make_mesh(2, 4, spread(devices, 8)), 28, 28)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs, nz = step(*planes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    want = {name: 8 if name == "h264_intra16_cols" else 0
            for name in launches}
    check(launches == want, f"hand-kernel launches {launches} on the H.264 "
          f"mesh, want {want}")
    for s in range(2):
        ref = encode_frame_i16_rows(*(p[s] for p in planes), 28, 28)
        for k, v in ref.items():
            got = outs[k]
            if k == "recon":
                check(all(torch.equal(a[s], b) for a, b in zip(got, v)),
                      f"H.264 mesh stream {s}: recon differs")
            else:
                check(torch.equal(got[s], v),
                      f"H.264 mesh stream {s}: {k} differs")
        nz_want = sum(int((ref[k] != 0).sum()) for k in
                      ("dc_luma", "ac_luma", "dc_chroma", "ac_chroma"))
        check(int(nz[s]) == nz_want, f"H.264 mesh stream {s}: nonzero count "
              f"{int(nz[s])}, want {nz_want}")
    # stream 1's last band against encode_frame_i16_rows on the CPU,
    # where K3's wrapper runs its plain version, at the band's shape
    s, (r0, r1) = 1, band_bounds(src.height // 16, 4)[-1]
    band = [p[s, n * r0:n * r1].cpu() for p, n in zip(planes, (16, 8, 8))]
    plain = encode_frame_i16_rows(*band, 28, 28)
    err = 0
    for k, v in plain.items():
        pairs = ([(g[s, n * r0:n * r1], b) for g, b, n
                  in zip(outs[k], v, (16, 8, 8), strict=True)]
                 if k == "recon" else [(outs[k][s, r0:r1], v)])
        for a, b in pairs:
            a = a.cpu()
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"H.264 mesh band {k}: {tuple(a.shape)} {a.dtype} vs "
                  f"{tuple(b.shape)} {b.dtype}")
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    check(err == 0, f"H.264 mesh stream {s}, MB rows {r0}-{r1 - 1}: K3 on "
          f"the card differs from its plain version on the CPU by {err}")
    out = {"size": [src.width, src.height], "mesh": [2, 4],
           "seconds": secs, "launches": launches,
           "nonzero": nz.tolist(),
           "plain_band": {"stream": s, "mb_rows": [r0, r1],
                          "shape": list(band[0].shape)},
           "max_abs_err": err}
    print(f"{tag} H.264 intra mesh 2x4 (2 streams of {src.width}x"
          f"{src.height}) on {len(set(devices))} card(s): {secs:.3f} s; "
          f"arrays equal to encode_frame_i16_rows per stream; stream {s}'s "
          f"band of MB rows {r0}-{r1 - 1} {tuple(band[0].shape)} against "
          f"the CPU (K3's plain version): max_abs_err={err}; hand-kernel "
          f"launches {launches}")
    return out


def phase_parallel(tag: str, devices: list) -> dict:
    """Phase 15: the parallel encoders (parallel/), their bands, GOP
    slots and mesh cells spread over `devices` (every card; one card
    takes them all); the single-device references on cuda:0."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource

    t0 = time.perf_counter()
    src = DeviceTestPatternSource(1920, 1088, texture=6)
    single = single_run(src, 10, profile_p=True)
    out = {"single_1080p": {k: v for k, v in single.items() if k != "data"}}
    out["bands_1080p_4"] = banded_run(tag, src, 4, 10, single["data"],
                                      devices, profile_p=True)
    out["bands_1080p_3"] = banded_run(tag, src, 3, 3, single["data"],
                                      devices)
    print(f"{tag} HEVC {src.width}x{src.height} single-device encode_frame: "
          f"host ms per frame "
          f"{', '.join(f'{x:.1f}' for x in single['host_ms'])}; one more P "
          f"frame: {single['launches_per_p_frame']} CUDA launches, "
          f"{single['device_ms_per_p_frame']:.3f} device ms")
    src4k = DeviceTestPatternSource(3840, 2160, texture=6)
    single4k = single_run(src4k, 3)
    out["single_4k"] = {"host_ms": single4k["host_ms"],
                        "bytes": [len(d) for d in single4k["data"]]}
    out["bands_4k_8"] = banded_run(tag, src4k, 8, 3, single4k["data"],
                                   devices, plain_bands=(0, 7))
    del src4k
    out["gop_parallel"] = gop_parallel_run(tag, src, 3, 10, devices)
    out["h264_mesh"] = h264_mesh_run(tag, src, devices)
    out["cards"] = len(devices)
    out["seconds"] = time.perf_counter() - t0
    print(f"{tag} phase 15 (parallel encoders) took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# H.264 CABAC main path and GPU-vs-CPU
# ---------------------------------------------------------------------------

class IntraCount:
    """Counts the intra MBs of each P frame that the CABAC encoder codes
    from its transfer rows, by wrapping cabac_run.unpack_syntax."""

    def __init__(self):
        from ceracoder_tpu_torch.codec.h264 import cabac_run

        self.mod, self.real = cabac_run, cabac_run.unpack_syntax
        self.per_p = []

        def unpack(row, get_chunk, f, mbh, mbw, intra, *a):
            nnz, arrays = self.real(row, get_chunk, f, mbh, mbw, intra, *a)
            if not intra and arrays is not None:
                self.per_p.append(int(arrays["is_intra"].sum()))
            return nnz, arrays
        cabac_run.unpack_syntax = unpack

    def close(self):
        self.mod.unpack_syntax = self.real


def kernel_launches(fn) -> tuple[int, float]:
    """CUDA kernel launches and their device ms in one call of fn()
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def phase_cabac_main_path(tag: str) -> dict:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H264Encoder(w, h, qp=28, gop=60)
    check(enc.cabac and enc.intra_in_p, "H264Encoder defaults")
    intra = IntraCount()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, run_secs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(runs):
            t = time.perf_counter()
            pend = enc.encode_run_async(
                source=src, indices=range(r * run_len, (r + 1) * run_len))
            frames += [p.result() for p in pend]
            torch.cuda.synchronize()
            run_secs.append(time.perf_counter() - t)
        secs = time.perf_counter() - t0
        counts = read_launches()
        launches = counts["merge_windows"]
        peak = torch.cuda.max_memory_allocated()
        # one more P frame and one more IDR, under the profiler: their
        # kernel launches
        n = runs * run_len
        p_launches, p_device_ms = kernel_launches(
            lambda: enc.encode_run_async(source=src,
                                         indices=[n])[0].result())
        idr_launches, idr_device_ms = kernel_launches(
            lambda: enc.encode_run_async(source=src, indices=[n + 1],
                                         force_idr=True)[0].result())
    finally:
        intra.close()
    nf = runs * run_len
    check(len(frames) == nf, "frame count")
    check([f.keyframe for f in frames] == [True] + [False] * (nf - 1),
          "GOP structure (1 IDR + P frames)")
    for f in frames:
        check_stream(f.data, h // 16)
    rec = frames[-1].recon
    check(rec[0].shape == (h, w) and rec[1].shape == (h // 2, w // 2)
          and rec[2].shape == (h // 2, w // 2), "recon shapes")
    check(launches == 0, f"K1 launched {launches} times on the CABAC path")
    check(counts["h264_deblock_rows"] >= nf
          and counts["h264_intra16_cols"] >= nf,
          f"K2 / K3 launched {counts} times for {nf} CABAC frames (the IDR "
          "loop, the intra-in-P scan and the deblock of every frame)")
    check(p_launches < 3000 and idr_launches < 3000,
          f"{p_launches} CUDA launches for a P frame and {idr_launches} for "
          "an IDR: the column loops are not in their kernels")
    check(len(intra.per_p) >= nf - 1 - enc.fallback_frames,
          "intra MB counts of the P frames")
    sizes = [len(f.data) for f in frames]
    per_p = intra.per_p[:nf - 1]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "intra_mbs_per_p_mean": sum(per_p) / max(1, len(per_p)),
        "intra_mbs_per_p_min": min(per_p, default=0),
        "intra_mbs_per_p_max": max(per_p, default=0),
        "fallback_frames": enc.fallback_frames, "k1_launches": launches,
        "launches": counts,
        "launches_per_p_frame": p_launches,
        "device_ms_per_p_frame": p_device_ms,
        "launches_per_idr": idr_launches,
        "device_ms_per_idr": idr_device_ms,
        "peak_mem_bytes": peak,
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} CABAC main path 1080p: {nf} frames in {secs:.3f} s "
          f"= {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} CABAC main path bytes/frame: IDR {out['bytes_idr']}, P "
          f"mean {out['bytes_p_mean']:.1f}; intra MBs per P frame mean "
          f"{out['intra_mbs_per_p_mean']:.2f}, min "
          f"{out['intra_mbs_per_p_min']}, max "
          f"{out['intra_mbs_per_p_max']} (of {(h // 16) * (w // 16)}); "
          f"fallback frames {out['fallback_frames']}; kernel launches "
          f"{counts}; peak device memory {peak} B; one more P frame: "
          f"{p_launches} CUDA launches, {p_device_ms:.3f} device ms; one "
          f"more IDR: {idr_launches} CUDA launches, {idr_device_ms:.3f} "
          f"device ms")
    return out


def uncover_frames(w: int, h: int, n: int, seed: int = 8):
    """Host frames of 8x8 blocks of random grey that brighten slowly,
    whose bottom half switches to a smooth new gradient from frame 2:
    inter prediction fails there and left-only intra predicts well, so
    P slices code intra MBs (the idea of the JAX suite's
    _uncover_frames, with content sparse enough for the compacted
    transfer)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(30, 220, (h // 8, w // 8)).astype(np.float32)
    base = np.kron(blocks, np.ones((8, 8), np.float32))
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = base * 0.5 + 40 + i * 2
        if i >= 2:
            y[h // 2:] = 150 + xx[h // 2:] * 0.2 + yy[h // 2:] * 0.1
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = ((xx[::2, ::2] + yy[::2, ::2]) % 60 + 100).astype(np.uint8)
        v = np.full((h // 2, w // 2), 120 + i, np.uint8)
        frames.append((y, u, v))
    return frames


def phase_cabac_gpu_equals_cpu(tag: str, main: dict) -> None:
    runs = [range(0, 3), range(3, 6)]
    t = time.perf_counter()
    gpu = encode_stream("cuda", 320, 192, runs, 4, 30, 6, cabac=True)
    cpu = encode_stream("cpu", 320, 192, runs, 4, 30, 6, cabac=True)
    check(gpu == cpu, "CABAC 320x192 GPU and CPU streams differ")
    print(f"{tag} CABAC GPU == CPU at 320x192, device source, 6 frames, "
          f"gop 4, 2 runs: {len(gpu)} B identical "
          f"({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    frames = uncover_frames(320, 192, 6)
    counts = {}
    for device in ("cuda", "cpu"):
        intra = IntraCount()
        try:
            counts[device] = (encode_stream(device, 320, 192, runs, 6, 28,
                                            6, cabac=True, frames=frames),
                              intra.per_p)
        finally:
            intra.close()
    check(counts["cuda"] == counts["cpu"],
          "CABAC 320x192 host frames with intra MBs: GPU and CPU differ")
    check(sum(counts["cuda"][1]) > 0, "no intra MB coded in a P slice")
    print(f"{tag} CABAC GPU == CPU at 320x192, host frames with new "
          f"content, 6 frames, gop 6, 2 runs: {len(counts['cuda'][0])} B "
          f"identical, intra MBs per P frame {counts['cuda'][1]} "
          f"({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    cpu2 = encode_stream("cpu", 1920, 1088, [range(2)], 60, 28, 6,
                         cabac=True)
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
    hdr = H264Encoder(1920, 1088, qp=28, gop=60, device="cpu").headers()
    check(cpu2 == hdr + main["first_two"],
          "CABAC 1080p IDR + P frame: GPU and CPU bytes differ")
    print(f"{tag} CABAC GPU == CPU at 1920x1088, first IDR + P frame: "
          f"{len(main['first_two'])} B identical (CPU run "
          f"{time.perf_counter() - t:.2f} s)")


# ---------------------------------------------------------------------------
# The product loop (CeracoderApp) and app GPU-vs-CPU
# ---------------------------------------------------------------------------

APP_W, APP_H, APP_FPS, APP_GOP, APP_RUN = 1920, 1088, 60, 60, 10
APP_WARM, APP_TIMED = 40, 120


def check_ts_payloads(payloads: list, pkt_size: int = 1316) -> int:
    """Every payload pkt_size bytes of 188 B TS packets with sync bytes,
    and the continuity counter of each PID unbroken across them (every
    packet the muxer writes carries payload). Returns packets seen."""
    check(all(len(p) == pkt_size for p in payloads),
          f"payload sizes {sorted({len(p) for p in payloads})}, want "
          f"{pkt_size}")
    data = np.frombuffer(b"".join(payloads), np.uint8).reshape(-1, 188)
    check(bool((data[:, 0] == 0x47).all()), "TS sync byte missing")
    pid = (data[:, 1].astype(np.int64) & 0x1F) << 8 | data[:, 2]
    cc = data[:, 3] & 0x0F
    check(bool(((data[:, 3] >> 4) & 1).all()), "TS packet without payload")
    for p in np.unique(pid):
        seq = cc[pid == p].astype(np.int64)
        check(bool((np.diff(seq) % 16 == 1).all()),
              f"continuity counter broken on PID {int(p)}")
    return data.shape[0]


class LoopbackListener:
    """The stream's receiver on this host: an SRT listener where libsrt
    loads (as bench.py's full loop), else a UDP socket. Counts the
    bytes and payloads it receives on a daemon thread."""

    def __init__(self):
        import socket
        import threading

        from ceracoder_tpu_torch.transport.srt import srt_available

        self.nbytes = 0
        self.sizes = set()
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.bind(("127.0.0.1", 0))
        self.port = probe.getsockname()[1]
        if srt_available():
            from ceracoder_tpu_torch.transport.srt import (
                SRTO_RCVLATENCY, SrtSocket)
            probe.close()
            self.kind, self.addr = "srt", "127.0.0.1"
            self.sock = SrtSocket()
            self.sock.set_int(SRTO_RCVLATENCY, 120)
            self.sock.bind("127.0.0.1", self.port)
            self.sock.listen()
            target = self._serve_srt
        else:
            self.kind, self.addr = "udp", "udp"
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
            probe.settimeout(0.5)
            self.sock = probe
            target = self._serve_udp
        self._stop = threading.Event()
        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()

    def _count(self, data: bytes) -> None:
        self.nbytes += len(data)
        self.sizes.add(len(data))

    def _serve_udp(self):
        import socket
        while not self._stop.is_set():
            try:
                self._count(self.sock.recv(65536))
            except socket.timeout:
                continue
            except OSError:
                return

    def _serve_srt(self):
        from ceracoder_tpu_torch.transport.srt import SrtError
        try:
            peer = self.sock.accept()
        except SrtError:
            return
        try:
            while not self._stop.is_set():
                data = peer.recv(2000)
                if not data:
                    break
                self._count(data)
        except SrtError:
            pass
        finally:
            peer.close()

    def close(self):
        self._stop.set()
        self.sock.close()
        self.thread.join(timeout=5)


def watchdog_gap(app, stop) -> tuple[float, dict]:
    """The longest time the stall watchdog's position stood still after
    its first move, sampled every 5 ms until `stop`, and where it
    began (frames collected, launched and sent). The watchdog arms at
    the first move and fires when two checks 1 s apart see the same
    position, so a gap over 1 s can trip it."""
    def where():
        return {"collected": app.frames_collected,
                "launched": app.encoder.frames_launched,
                "sent": app.frames_sent}
    last, since, longest, at, start = app._position(), None, 0.0, {}, {}
    while not stop.is_set():
        time.sleep(0.005)
        pos, now = app._position(), time.perf_counter()
        if pos != last:
            if since is not None and now - since > longest:
                longest, at = now - since, start
            last, since, start = pos, now, where()
    return longest, at


class Timed:
    """Host seconds spent inside wrapped calls, counted while `on`."""

    def __init__(self):
        self.on = False
        self.secs: dict = {}

    def wrap(self, key: str, fn):
        self.secs.setdefault(key, 0.0)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self.on:
                    self.secs[key] += time.perf_counter() - t
        return timed


def run_app_loop(job, warm: int, timed_frames: int, want_keys: list,
                 kernels: dict):
    """CeracoderApp on `job`, fixed balancer, latency 2000 ms, realtime,
    to a loopback listener, the stall watchdog off; `warm` frames, then
    `timed_frames` timed emit to emit. Checks that each hand kernel
    named in `kernels` was launched as it says (wrapper name -> "frame":
    once per frame at least, "idr": once per keyframe) and the others
    not at all; returns the numbers phases 8 and 12 print."""
    from ceracoder_tpu_torch.app.cli import CliOptions
    from ceracoder_tpu_torch.app.main import CeracoderApp

    listener = LoopbackListener()
    opts = CliOptions(job_file=str(job), addr=listener.addr,
                      port=listener.port, latency=2000, balancer="fixed")
    total = warm + timed_frames
    app = CeracoderApp(opts, max_frames=total, realtime=True)
    # as bench.py's full loop: the stall watchdog would read the first
    # 1080p IDR run (seconds of launches, no frame sent) as a wedge
    app._start_stall_watchdog = lambda: None
    timed = Timed()
    emits, keys, payloads = [], [], []
    run_async = timed.wrap("encode_run_async", app.encoder.encode_run_async)

    def encode_run_async(*a, **kw):
        pend = run_async(*a, **kw)
        for pf in pend:
            pf.result = timed.wrap("result", pf.result)
        return pend
    app.encoder.encode_run_async = encode_run_async
    app.mux.mux_video = timed.wrap("mux_pack_send", app.mux.mux_video)
    app.mux.mux_audio = timed.wrap("mux_pack_send", app.mux.mux_audio)
    app.packer.feed = timed.wrap("mux_pack_send", app.packer.feed)
    send = app.transport.send

    def send_and_keep(payload):
        payloads.append(payload)
        return send(payload)
    app.transport.send = timed.wrap("mux_pack_send", send_and_keep)
    if app.audio is not None:
        app.audio.feed = timed.wrap("audio_encode", app.audio.feed)
    emit = app._emit_frame

    def emit_and_time(frame, fpts, pacer):
        keys.append(frame.keyframe)
        emit(frame, fpts, pacer)
        emits.append(time.perf_counter())
        timed.on = len(emits) >= warm
    app._emit_frame = emit_and_time

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stop = threading.Event()
    with ThreadPoolExecutor(max_workers=1) as pool:
        watch = pool.submit(watchdog_gap, app, stop)
        try:
            rc = app.run()
        finally:
            stop.set()
            listener.close()
        gap, gap_at = watch.result()
    secs = time.perf_counter() - t0
    launches = read_launches()
    check(rc == 0, f"app exited {rc}")
    check(len(emits) == total, f"{len(emits)} frames emitted, want {total}")
    window = emits[-1] - emits[warm - 1]
    packets = check_ts_payloads(payloads)
    check([i for i, k in enumerate(keys) if k] == want_keys,
          f"keyframes at {[i for i, k in enumerate(keys) if k]}, want "
          f"{want_keys}")
    for name, n in launches.items():
        per = kernels.get(name)
        ok = {"frame": n >= total, "idr": n == len(want_keys),
              None: n == 0}[per]
        check(ok, f"{name} launched {n} times in {total} frames of the app "
              f"loop ({per or 'never'} wanted)")
    check(listener.nbytes > 0 or listener.kind == "srt",
          "the UDP listener received nothing")
    check(listener.sizes <= {1316}, f"received sizes {listener.sizes}")
    return {
        "frames": total, "timed_frames": timed_frames,
        "fps": timed_frames / window, "timed_seconds": window,
        "seconds_total": secs,
        "host_seconds": {k: v for k, v in timed.secs.items()},
        "longest_watchdog_gap_s": gap, "longest_gap_began_at": gap_at,
        "bytes_sent": sum(map(len, payloads)), "payloads": len(payloads),
        "ts_packets": packets, "bytes_received": listener.nbytes,
        "transport": listener.kind, "audio": app.audio is not None,
        "fallback_frames": app.encoder.fallback_frames,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }


def print_app_loop(tag: str, label: str, out: dict) -> None:
    print(f"{tag} {label} over {out['transport']} (audio "
          f"{'AAC tone' if out['audio'] else 'off'}): "
          f"{out['timed_frames']} timed frames at {out['fps']:.3f} "
          f"frames/s emit to emit ({out['timed_seconds']:.3f} s; "
          f"{out['seconds_total']:.3f} s for all {out['frames']}); host s "
          f"in the window: " + ", ".join(
              f"{k} {v:.3f}" for k, v in out["host_seconds"].items()))
    print(f"{tag} {label} sent {out['bytes_sent']} B in {out['payloads']} "
          f"payloads of 1316 B ({out['ts_packets']} TS packets, continuity "
          f"unbroken), received {out['bytes_received']} B; fallback frames "
          f"{out['fallback_frames']}; kernel launches {out['launches']}; "
          f"peak device memory {out['peak_mem_bytes']} B; longest time "
          f"the stall watchdog's position stood still after it moved: "
          f"{out['longest_watchdog_gap_s']:.3f} s, from frames "
          f"{out['longest_gap_began_at']}")


def phase_app_loop(tag: str, tmpdir) -> dict:
    job = tmpdir / "app_1080p60.ini"
    job.write_text(f"[source]\nkind = devtest\nwidth = {APP_W}\n"
                   f"height = {APP_H}\nfps = {APP_FPS}\n\n[encode]\n"
                   f"codec = hevc\ngop = {APP_GOP}\nrun = {APP_RUN}\n\n"
                   "[audio]\nkind = tone\nbitrate = 128\n")
    from ceracoder_tpu_torch.app.main import STALL_CHECK_S

    out = run_app_loop(job, APP_WARM, APP_TIMED, [0, 60, 120],
                       {"h265_intra_cols": "idr"})
    out["job"] = {"kind": "devtest", "width": APP_W, "height": APP_H,
                  "fps": APP_FPS, "codec": "hevc", "gop": APP_GOP,
                  "run": APP_RUN, "audio": "tone 128 kbps",
                  "balancer": "fixed", "latency_ms": 2000,
                  "realtime": True}
    print_app_loop(tag, f"app loop {APP_W}x{APP_H} at {APP_FPS} frames/s, "
                   "HEVC (keyframes 0, 60, 120)", out)
    check(out["longest_watchdog_gap_s"] <= STALL_CHECK_S,
          f"the stall watchdog's position stood still "
          f"{out['longest_watchdog_gap_s']:.3f} s: a live job would exit")
    return out


H264_APP_JOB = ROOT / "jobs" / "h264_test_1080p30"
H264_APP_WARM, H264_APP_TIMED = 8, 120


def phase_h264_app_loop(tag: str) -> dict:
    from ceracoder_tpu_torch.app.main import STALL_CHECK_S

    out = run_app_loop(H264_APP_JOB, H264_APP_WARM, H264_APP_TIMED, [0, 60, 120],
                       {"h264_deblock_rows": "frame",
                        "h264_intra16_cols": "frame"})
    out["job"] = {"file": "jobs/h264_test_1080p30",
                  "text": H264_APP_JOB.read_text(), "run": 8,
                  "balancer": "fixed", "latency_ms": 2000,
                  "realtime": True}
    print_app_loop(tag, "H.264 app loop, jobs/h264_test_1080p30 (test "
                   "pattern 1920x1080 at 30 frames/s, CABAC, gop 60, "
                   "runs of 8; keyframes 0, 60, 120)", out)
    check(out["longest_watchdog_gap_s"] <= STALL_CHECK_S,
          f"the stall watchdog's position stood still "
          f"{out['longest_watchdog_gap_s']:.3f} s: a live job would exit")
    return out


def app_ts(device: str, job, out) -> bytes:
    from ceracoder_tpu_torch.app.cli import CliOptions
    from ceracoder_tpu_torch.app.main import CeracoderApp

    opts = CliOptions(job_file=str(job), addr=str(out), port=0)
    app = CeracoderApp(opts, max_frames=12, realtime=False, device=device)
    check(app.run() == 0 and app.frames_sent == 12, "app run")
    return out.read_bytes()


def phase_app_gpu_equals_cpu(tag: str, tmpdir) -> None:
    for codec in ("hevc", "h264"):
        for kind, run in (("test", 4), ("test", 1), ("devtest", 4)):
            job = tmpdir / f"app_{codec}_{kind}_{run}.ini"
            job.write_text(f"[source]\nkind = {kind}\nwidth = 320\n"
                           "height = 192\nfps = 30\n\n[encode]\n"
                           f"codec = {codec}\ngop = 8\nrun = {run}\n")
            t = time.perf_counter()
            gpu = app_ts("cuda", job, tmpdir / "gpu.ts")
            cpu = app_ts("cpu", job, tmpdir / "cpu.ts")
            check(gpu == cpu,
                  f"app {codec} {kind} run={run}: GPU and CPU TS differ")
            print(f"{tag} app GPU == CPU, {codec}, 320x192 {kind} source, "
                  f"run = {run}, 12 frames: {len(gpu)} B of TS identical "
                  f"({time.perf_counter() - t:.2f} s)")


# ---------------------------------------------------------------------------
# Phase 16: the supervisor bindings, native TS and per-stream control
# ---------------------------------------------------------------------------

SUPERVISED_JOB = dict(source="test", resolution="1080p", fps=30,
                      codec="hevc")          # jobs/hevc_test_1080p30
SUPERVISED_FIRST_S = 120.0    # deadline for the first payload
SUPERVISED_STREAM_S = 5.0     # streaming before the SIGHUP
SUPERVISED_RELOAD_S = 5.0     # deadline for the reload line
SUPERVISED_TAIL_S = 3.0       # streaming after the reload
SUPERVISED_TERM_S = 10.0      # send_term's wait
RELOAD_MAX_KBPS = 3000
FORCED_EXIT_S = 3.0           # app/main.py:stop's SIGALRM teardown


class UdpSink:
    """The supervised app's receiver: a UDP socket on 127.0.0.1 whose
    daemon thread keeps every payload and its host time; `close` drains
    it until 0.2 s pass without one."""

    def __init__(self):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.times, self.payloads = [], []
        self._draining = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import socket
        while True:
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                if self._draining.is_set():
                    return
                continue
            self.times.append(time.perf_counter())
            self.payloads.append(data)

    def close(self):
        self._draining.set()
        self.thread.join(timeout=10)
        self.sock.close()


class LineLog:
    """A child's merged stdout and stderr, line by line with host times,
    read on a daemon thread."""

    def __init__(self, stream):
        self.lines: list = []
        self.thread = threading.Thread(target=self._read, args=(stream,),
                                       daemon=True)
        self.thread.start()

    def _read(self, stream):
        for line in stream:
            self.lines.append((time.perf_counter(), line.rstrip("\n")))

    def first(self, text: str, since: float = 0.0):
        return next((t for t, line in list(self.lines)
                     if t >= since and text in line), None)

    def tail(self, n: int = 30) -> str:
        return "\n".join(line for _, line in self.lines[-n:])


def ts_video_summary(payloads: list) -> dict:
    """Keyframes (the muxer writes PAT + PMT before each keyframe and
    nowhere else), access units (PES starts on the video PID) and
    whether an HEVC IDR_W_RADL NAL unit header is in the video
    elementary stream."""
    data = np.frombuffer(b"".join(payloads), np.uint8).reshape(-1, 188)
    pid = (data[:, 1].astype(np.int64) & 0x1F) << 8 | data[:, 2]
    video = data[pid == 0x0100]
    es = b"".join(p[5 + int(p[4]) if p[3] & 0x20 else 4:].tobytes()
                  for p in video)
    return {"keyframes": int((pid == 0).sum()),
            "access_units": int(((video[:, 1] >> 6) & 1).sum()),
            "idr_nal": b"\x00\x00\x01\x26\x01" in es}


def phase_supervised_app(tag: str, tmpdir: Path) -> dict:
    """Phase 16 (a): the port's app as CERALIVE's supervisor runs it,
    through the port's bindings: job and config written, the process
    spawned with its stall watchdog armed, a SIGHUP reload of a lower
    max_bitrate, a SIGTERM stop."""
    import os

    from ceracoder_tpu_torch.bindings import (
        JobBuilder, build_run_artifacts, find_executable, is_running,
        send_hup, send_term, spawn, write_config, write_jobspec)
    from ceracoder_tpu_torch.bindings.cli import RunOptions
    from ceracoder_tpu_torch.bindings.jobs import JobRequest

    job = tmpdir / "hevc_test_1080p30"
    job_text = JobBuilder().build(JobRequest(**SUPERVISED_JOB))
    write_jobspec(job, job_text)
    cfg_path = tmpdir / "ceracoder.conf"
    sink = UdpSink()
    opts = RunOptions(str(job), "udp", sink.port, config_path=str(cfg_path),
                      balancer="fixed", latency=2000)
    art = build_run_artifacts(opts)
    write_config(cfg_path, art.ini)
    prefix = find_executable()
    check(prefix[-2:] == ["-m", "ceracoder_tpu_torch"]
          or Path(prefix[0]).name == "ceracoder-tpu-torch",
          f"the bindings would launch {prefix}, not the port's app")
    # the child makes its own CUDA context: the parent's work is done
    torch.cuda.synchronize()
    env = {**os.environ, "PYTHONUNBUFFERED": "1",
           "PYTHONPATH": os.pathsep.join(
               filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    proc = spawn(art.args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                 stderr=subprocess.STDOUT, text=True)
    log = LineLog(proc.stdout)
    try:
        while not sink.payloads and time.perf_counter() - t0 < \
                SUPERVISED_FIRST_S:
            check(is_running(proc), f"the app exited {proc.returncode} "
                  f"before its first payload:\n{log.tail()}")
            time.sleep(0.05)
        check(bool(sink.payloads), f"no payload within "
              f"{SUPERVISED_FIRST_S:.0f} s:\n{log.tail()}")
        t_first = sink.times[0]
        time.sleep(SUPERVISED_STREAM_S)
        art2 = build_run_artifacts(
            opts, overrides={"max_bitrate": RELOAD_MAX_KBPS})
        write_config(cfg_path, art2.ini)
        t_hup = time.perf_counter()
        check(send_hup(proc), "the app was not running at the SIGHUP")
        want = (f"Config reloaded: {art2.config.min_bitrate} - "
                f"{RELOAD_MAX_KBPS} Kbps")
        while log.first(want, t_hup) is None and \
                time.perf_counter() - t_hup < SUPERVISED_RELOAD_S:
            time.sleep(0.01)
        t_reload = log.first(want, t_hup)
        check(t_reload is not None, f"no '{want}' within "
              f"{SUPERVISED_RELOAD_S:.0f} s of the SIGHUP:\n{log.tail()}")
        time.sleep(SUPERVISED_TAIL_S)
        check(is_running(proc), f"the app exited {proc.returncode} before "
              f"the SIGTERM:\n{log.tail()}")
        t_term = time.perf_counter()
        stopped = send_term(proc, wait_s=SUPERVISED_TERM_S)
        term_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.thread.join(timeout=10)
        sink.close()
    check(stopped, f"the app did not stop within {SUPERVISED_TERM_S:.0f} s "
          "of the SIGTERM")
    check(proc.returncode == 0, f"the app exited {proc.returncode}:\n"
          f"{log.tail()}")
    check(not is_running(proc), "the app still runs after send_term")
    # a forced teardown (SIGALRM) also exits 0, silently, FORCED_EXIT_S
    # after the stop: a clean stop is one that comes before it
    check(term_s < FORCED_EXIT_S, f"the app took {term_s:.3f} s to exit "
          f"after the SIGTERM: its {FORCED_EXIT_S:.0f} s forced teardown")
    stalls = [line for _, line in log.lines if "Pipeline stall" in line]
    check(not stalls, f"the stall watchdog fired: {stalls}")
    packets = check_ts_payloads(sink.payloads)
    video = ts_video_summary(sink.payloads)
    check(video["keyframes"] >= 1 and video["idr_nal"],
          f"no keyframe in the stream: {video}")
    window = t_term - t_first
    in_window = [t for t in sink.times if t_first <= t <= t_term]
    out = {
        "job": job_text,
        "argv": prefix + art.args, "config": art.ini,
        "seconds_to_first_payload": t_first - t0,
        "payloads": len(sink.payloads), "ts_packets": packets,
        "payloads_per_s": len(in_window) / window,
        "mbps": len(in_window) * 1316 * 8 / window / 1e6,
        "window_s": window, **video,
        "hup_to_reload_line_s": t_reload - t_hup,
        "term_to_exit_s": term_s, "exit_code": proc.returncode,
        "log_tail": [line for _, line in log.lines[-8:]],
    }
    print(f"{tag} phase 16 (a) supervised app ({' '.join(prefix[-2:])}, "
          f"watchdog armed): first payload "
          f"{out['seconds_to_first_payload']:.3f} s after spawn; "
          f"{out['payloads_per_s']:.2f} payloads/s "
          f"({out['mbps']:.3f} Mbps) over {window:.3f} s; "
          f"{video['access_units']} access units, {video['keyframes']} "
          f"keyframe(s); SIGHUP to '{want}' {out['hup_to_reload_line_s']:.3f}"
          f" s; SIGTERM to exit {term_s:.3f} s, code {proc.returncode}; "
          f"{len(sink.payloads)} payloads of 1316 B ({packets} TS packets, "
          "continuity unbroken), no stall")
    return out


def native_srt_loopback() -> dict:
    """NativeSrtClient to an in-process SRT listener (the port's Python
    socket): 10 payloads sent, received and equal."""
    import socket

    from ceracoder_tpu_torch.native import NativeSrtClient
    from ceracoder_tpu_torch.transport.srt import (
        SRTO_RCVLATENCY, SrtError, SrtSocket)

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    sock = SrtSocket()
    sock.set_int(SRTO_RCVLATENCY, 120)
    sock.bind("127.0.0.1", port)
    sock.listen()
    received, peers = [], []

    def serve():
        try:
            peers.append(sock.accept())
            while len(received) < 10:
                data = peers[0].recv(2000)
                if not data:
                    return
                received.append(data)
        except SrtError:
            pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    cli = NativeSrtClient()
    payload = bytes([0x47]) + bytes(1315)
    try:
        cli.connect("127.0.0.1", port, latency_ms=300)
        sent = [cli.send(payload) for _ in range(10)]
        th.join(timeout=5)
        stats = cli.get_stats()
    finally:
        cli.close()
        for p in peers:
            p.close()
        sock.close()
    check(sent == [1316] * 10 and received == [payload] * 10,
          f"SRT loopback: sent {sent}, received {len(received)}")
    return {"sent": 10, "received": len(received), "rtt_ms": stats.msRTT,
            "negotiated_latency_ms": cli.negotiated_latency}


def phase_native_ts(tag: str, aus: list) -> dict:
    """Phase 16 (b): HEVC access units (Annex B, parameter sets before
    each keyframe, as the app muxes them) through NativeTsMuxer +
    NativeTsPacker and through the port's Python TsMuxer + TsPacker,
    byte for byte; the native SRT client where libsrt loads, else its
    refusal."""
    from ceracoder_tpu_torch.native import (
        NativeSrtClient, NativeTsMuxer, NativeTsPacker, load_srt_client)
    from ceracoder_tpu_torch.transport.mpegts import (
        STREAM_TYPE_HEVC, TsMuxer, TsPacker)

    sides = {"native": (NativeTsMuxer(video_stream_type=STREAM_TYPE_HEVC),
                        NativeTsPacker(1316)),
             "python": (TsMuxer(video_stream_type=STREAM_TYPE_HEVC),
                        TsPacker(1316))}
    out, secs = {}, {}
    for name, (mux, packer) in sides.items():
        t = time.perf_counter()
        payloads = []
        for i, (au, key) in enumerate(aus):
            payloads += packer.feed(mux.mux_video(au, 3000 * i + 9000,
                                                  keyframe=key))
        out[name] = (payloads, packer.flush())
        secs[name] = time.perf_counter() - t
    check(out["native"] == out["python"],
          "native and Python TS bytes differ")
    payloads, tail = out["native"]
    check_ts_payloads(payloads)
    res = {"access_units": len(aus), "payloads": len(payloads),
           "bytes": sum(map(len, payloads)) + len(tail),
           "host_ms_per_au": {k: v * 1000 / len(aus) for k, v in secs.items()}}
    if load_srt_client().cc_srt_available():
        res["srt"] = native_srt_loopback()
    else:
        try:
            NativeSrtClient()
        except RuntimeError as e:
            check(str(e) == "libsrt unavailable", f"NativeSrtClient: {e}")
            res["srt"] = "libsrt unavailable (refused as JAX's client is)"
        else:
            check(False, "NativeSrtClient built without libsrt")
    print(f"{tag} phase 16 (b) native TS: {len(aus)} HEVC 1080p access "
          f"units, {res['bytes']} B ({res['payloads']} payloads and the "
          f"flushed tail), native "
          f"== Python byte for byte (host ms per access unit: native "
          f"{res['host_ms_per_au']['native']:.3f}, Python "
          f"{res['host_ms_per_au']['python']:.3f}); SRT: {res['srt']}")
    return res


CONTROL_LINKS_BPS = (8e6, 2e6)
CONTROL_FRAMES = 60


def phase_per_stream_control(tag: str) -> tuple[dict, list]:
    """Phase 16 (c): BASELINE.md config (4), two 1080p streams on one
    card, each with its own encoder, bonded link, adaptive balancer and
    QP rate controller (tests/test_multistream.py's stack): two 20 ms
    ticks a frame, the link fed the balancer's bitrate."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    from ceracoder_tpu_torch.control import BalancerRunner, CeracoderConfig
    from ceracoder_tpu_torch.control.qp_rate import QpRateController
    from ceracoder_tpu_torch.transport.linksim import BondedLink, Modem

    src = DeviceTestPatternSource(1920, 1088, texture=6)
    links = [BondedLink(modems=[Modem(bps)]) for bps in CONTROL_LINKS_BPS]
    runners = [BalancerRunner(CeracoderConfig(), "adaptive",
                              srt_latency=2000, quiet=True)
               for _ in links]
    encs = [H265DeviceEncoder(1920, 1088, qp=32, gop=60) for _ in links]
    rates = [QpRateController(fps=30.0, qp=32.0) for _ in links]
    bitrate = [r.config.max_bitrate for r in runners]
    qp = [32, 32]
    hist = [{"qp": [], "bytes": [], "bitrate": [], "host_ms": []}
            for _ in links]
    keys, aus = 0, []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(CONTROL_FRAMES):
        y, u, v = src.frame(i)
        for k in range(len(links)):
            t = time.perf_counter()
            fr = encs[k].encode_frame(y, u, v, qp=int(qp[k]))
            hist[k]["host_ms"].append((time.perf_counter() - t) * 1000)
            keys += fr.keyframe
            if k == 0 and len(aus) < 10:
                aus.append(((encs[k].headers() if fr.keyframe else b"")
                            + fr.data, fr.keyframe))
            for _ in range(2):   # ~two 20 ms ticks per frame
                stats = links[k].tick(bitrate[k])
                bitrate[k] = runners[k].step(stats).new_bitrate
            qp[k] = rates[k].update(bitrate[k], len(fr.data) * 8,
                                    keyframe=fr.keyframe)
            for key, val in (("qp", qp[k]), ("bytes", len(fr.data)),
                             ("bitrate", bitrate[k])):
                hist[k][key].append(val)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    check(keys == len(links), f"{keys} keyframes in two streams of "
          f"{CONTROL_FRAMES} frames at gop 60, want one each")
    for name, n in launches.items():
        want = keys if name == "h265_intra_cols" else 0
        check(n == want, f"{name} launched {n} times in the two streams, "
              f"want {want}")
    q = [float(np.mean(h["qp"][-10:])) for h in hist]
    check(q[1] > q[0], f"the weak-link stream's QP {q[1]:.2f} is not above "
          f"the healthy one's {q[0]:.2f} over the last 10 frames")
    check(bitrate[1] < bitrate[0], f"the weak-link stream's bitrate "
          f"{bitrate[1]} is not below the healthy one's {bitrate[0]}")
    out = {"frames_per_stream": CONTROL_FRAMES, "seconds": secs,
           "links_bps": list(CONTROL_LINKS_BPS), "launches": launches,
           "streams": [{
               "link_mbps": bps / 1e6, "final_qp": h["qp"][-1],
               "mean_qp_last_10": qm, "final_bitrate": b,
               "mean_bytes_p": float(np.mean(h["bytes"][1:])),
               "host_ms_per_frame": float(np.mean(h["host_ms"])),
               "host_ms_per_p_frame": float(np.mean(h["host_ms"][1:])),
               "qp_every_10": h["qp"][::10],
               "bitrate_every_10": h["bitrate"][::10]}
               for bps, h, qm, b in zip(CONTROL_LINKS_BPS, hist, q, bitrate)]}
    for s in out["streams"]:
        print(f"{tag} phase 16 (c) stream on a {s['link_mbps']:g} Mbps link: "
              f"final QP {s['final_qp']}, mean QP of the last 10 frames "
              f"{s['mean_qp_last_10']:.2f}, final bitrate "
              f"{s['final_bitrate']} bps, mean P frame {s['mean_bytes_p']:.1f}"
              f" B, host ms per frame {s['host_ms_per_frame']:.3f} (P "
              f"{s['host_ms_per_p_frame']:.3f})")
    print(f"{tag} phase 16 (c) two 1080p streams x {CONTROL_FRAMES} frames "
          f"in {secs:.3f} s; kernel launches {launches}")
    return out, aus


def phase_supervisor(tag: str) -> dict:
    """Phase 16: (a) the app spawned, reloaded and stopped through the
    bindings, (c) per-stream control at 1080p, (b) native TS on (c)'s
    first 10 access units."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out = {"supervised_app": phase_supervised_app(tag, Path(d))}
    out["per_stream_control"], aus = phase_per_stream_control(tag)
    out["native_ts"] = phase_native_ts(tag, aus)
    out["seconds"] = time.perf_counter() - t0
    print(f"{tag} phase 16 (supervisor, native TS, per-stream control) "
          f"took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the host reference codec checks the card's 1080p streams
# ---------------------------------------------------------------------------

# the parser's MB type names, as the H.264 spec names them
MB_TYPE_NAMES = {"I_16x16": "I_16x16", "I_4x4": "I_NxN",
                 "P_16x16": "P_L0_16x16", "P_Skip": "P_Skip"}


def parse_h264_frames(data: bytes, mbw: int, mbh: int) -> list:
    """Every slice of an Annex-B CABAC stream through the port's walker
    and decode twin; each slice must be one MB row whose payload the
    parser consumes to within 2 bytes (the bound of the JAX suite's
    x264 walk). Returns per frame its IDR flag and MB records."""
    from ceracoder_tpu_torch.codec.h264.cabac_dec import H264SliceParser
    from ceracoder_tpu_torch.codec.h264.parse import walk_stream

    frames = []
    for sh, payload, _ in walk_stream(data):
        if sh.first_mb == 0:
            frames.append({"idr": sh.idr, "mbs": []})
        check(bool(frames) and sh.first_mb == len(frames[-1]["mbs"]),
              f"slice at MB {sh.first_mb} out of order")
        parser = H264SliceParser(payload, sh.qp, sh.slice_type == 2, mbw,
                                 mbh, first_mb=sh.first_mb,
                                 cabac_init_idc=sh.cabac_init_idc)
        mbs = parser.parse()
        left = len(payload) - parser.consumed_bytes()
        check(0 <= left <= 2, f"frame {len(frames) - 1}, slice at MB "
              f"{sh.first_mb}: {left} of {len(payload)} payload bytes left "
              "after the parse")
        check(len(mbs) == mbw, f"slice at MB {sh.first_mb} holds "
              f"{len(mbs)} MBs, want one row of {mbw}")
        frames[-1]["mbs"] += mbs
    return frames


def reference_h264(tag: str, w: int = 1920, h: int = 1088) -> dict:
    """(a) Phase 10's CABAC encoder codes 1 IDR + 9 P frames at 1080p on
    the card; the port's stream walker and decode twin parse every
    slice. Every frame has all its MBs, every IDR MB is intra, and each
    P frame's parsed intra MBs are the encoder's own count."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    n = 10
    mbw, mbh = w // 16, h // 16
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H264Encoder(w, h, qp=28, gop=60)
    intra = IntraCount()
    reset_launches()
    t = time.perf_counter()
    try:
        coded = [p.result() for p in enc.encode_run_async(
            source=src, indices=range(n))]
        torch.cuda.synchronize()
    finally:
        intra.close()
    encode_s = time.perf_counter() - t
    launches = read_launches()
    check([f.keyframe for f in coded] == [True] + [False] * (n - 1),
          "GOP structure (1 IDR + 9 P)")
    check(launches["merge_windows"] == 0
          and launches["h264_deblock_rows"] >= n
          and launches["h264_intra16_cols"] >= n,
          f"kernel launches {launches} for {n} CABAC frames")
    check(len(intra.per_p) == n - 1, f"intra MB counts of {len(intra.per_p)}"
          f" P frames, want {n - 1}")
    data = enc.headers() + b"".join(f.data for f in coded)
    t = time.perf_counter()
    frames = parse_h264_frames(data, mbw, mbh)
    parse_s = time.perf_counter() - t
    check(len(frames) == n, f"{len(frames)} frames parsed, want {n}")
    check([f["idr"] for f in frames] == [True] + [False] * (n - 1),
          "parsed IDR flags")
    types = {"I": {}, "P": {}}
    parsed_intra = []
    for i, f in enumerate(frames):
        mbs = f["mbs"]
        check(len(mbs) == mbw * mbh, f"frame {i}: {len(mbs)} MBs, want "
              f"{mbw * mbh}")
        n_intra = sum(1 for m in mbs if m["intra"])
        if f["idr"]:
            check(n_intra == mbw * mbh, f"IDR: {n_intra} intra MBs")
        else:
            parsed_intra.append(n_intra)
        kind = types["I" if f["idr"] else "P"]
        for m in mbs:
            name = MB_TYPE_NAMES.get(m["mb_type"], m["mb_type"])
            kind[name] = kind.get(name, 0) + 1
    check(parsed_intra == intra.per_p, f"parsed intra MBs per P frame "
          f"{parsed_intra}, the encoder's {intra.per_p}")
    out = {"frames": n, "bytes": len(data), "slices": n * mbh,
           "mbs_per_frame": mbw * mbh, "mb_types": types,
           "intra_mbs_per_p": parsed_intra, "encode_seconds": encode_s,
           "parse_seconds": parse_s, "launches": launches}
    print(f"{tag} phase 17 (a) H.264 CABAC {w}x{h}, {n} frames ({len(data)} "
          f"B, {n * mbh} slices) parsed by the port's walker and decode "
          f"twin in {parse_s:.3f} s, every payload to within 2 bytes: MB "
          f"types I frame {types['I']}, P frames {types['P']}; intra MBs "
          f"per P frame {parsed_intra} (= the encoder's); encode "
          f"{encode_s:.3f} s; kernel launches {launches}")
    return out


def reference_hevc(tag: str, w: int = 1920,
                   h: int = 1088) -> tuple[dict, list]:
    """(b) Phase 6's encoder codes the first IDR and P frame of the
    device test pattern on the card; the numpy row encoder with the
    Python CABAC codes the same frames, copied to the host, to the same
    NAL bytes. Returns the readings and, per frame, the (arrays, qp,
    keywords) that the spec handed its entropy stage (phase 18 (a)
    codes them again in slice mode)."""
    import ceracoder_tpu_torch.codec.h265.rowslice as rows
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H265DeviceEncoder(w, h, qp=30, gop=60)
    reset_launches()
    coded = [p.result() for p in enc.encode_run_async(source=src,
                                                      indices=range(2))]
    torch.cuda.synchronize()
    launches = read_launches()
    check_hevc_launches(launches, 1)
    planes = [tuple(p.cpu().numpy() for p in src.frame(i)) for i in range(2)]
    spec = rows.H265RowEncoder(w, h, qp=30, gop=60, native_entropy=False)
    check(spec.headers() == enc.headers(), "HEVC parameter sets differ")
    timed = Timed()
    names = ("compute_intra_rows", "compute_p_rows", "entropy_rows")
    real = {k: getattr(rows, k) for k in names}
    entropy_inputs = []

    def keep_inputs(p, arrays, qp, **kw):
        entropy_inputs.append((dict(arrays), qp, kw))
        return real["entropy_rows"](p, arrays, qp, **kw)
    for k in names:
        setattr(rows, k, timed.wrap(k, keep_inputs if k == "entropy_rows"
                                    else real[k]))
    timed.on = True
    t = time.perf_counter()
    try:
        for i, (f, d) in enumerate(zip(planes, coded)):
            data, idr = spec.encode_frame(*f)
            check(idr == d.keyframe, f"frame {i}: IDR flags differ")
            if data != d.data:
                at = next((j for j, (a, b) in enumerate(zip(data, d.data))
                           if a != b), min(len(data), len(d.data)))
                check(False, f"frame {i}: the numpy spec's {len(data)} B "
                      f"and the card's {len(d.data)} B differ from byte "
                      f"{at}")
    finally:
        for k in names:
            setattr(rows, k, real[k])
    spec_s = time.perf_counter() - t
    out = {"bytes": [len(d.data) for d in coded], "spec_seconds": spec_s,
           **{f"{k}_seconds": timed.secs[k] for k in names},
           "launches": launches}
    print(f"{tag} phase 17 (b) HEVC {w}x{h} IDR + P: the numpy row encoder "
          f"with the Python CABAC equals the card's NAL bytes "
          f"({out['bytes']} B); compute_intra_rows "
          f"{timed.secs['compute_intra_rows']:.3f} s, compute_p_rows "
          f"{timed.secs['compute_p_rows']:.3f} s, entropy_rows "
          f"{timed.secs['entropy_rows']:.3f} s (both frames), the spec "
          f"{spec_s:.3f} s in all; kernel launches {launches}")
    return out, entropy_inputs


def phase_reference_codec(tag: str) -> tuple[dict, list]:
    """Phase 17: (a) the H.264 CABAC stream parsed, (b) the HEVC numpy
    spec against the card's bytes. Returns the readings and (b)'s
    entropy-stage inputs."""
    t0 = time.perf_counter()
    out = {"h264": reference_h264(tag)}
    out["hevc"], entropy_inputs = reference_hevc(tag)
    out["seconds"] = time.perf_counter() - t0
    print(f"{tag} phase 17 (the host reference codec) took "
          f"{out['seconds']:.1f} s")
    return out, entropy_inputs


# ---------------------------------------------------------------------------
# Phase 18: one slice per CTB row, deblock off, the legacy motion helpers
# ---------------------------------------------------------------------------

def hevc_slice_mode(tag: str, entropy_inputs: list) -> dict:
    """(a) Phase 6's encoder with tile rows and in slice mode (one slice
    segment per CTB row) on the same 10 frames: the same
    reconstructions, 68 slice NAL units a slice-mode frame, K4 once per
    IDR; the first IDR and P frame of the slice-mode run equal, byte for
    byte, the Python and the native entropy stage in slice mode on the
    numpy spec's arrays of phase 17 (b). The device encoder takes no
    slice-mode option (the spec layer, rowslice.py, has the mode); its
    entropy stage follows its `params`, so tile_rows is turned off
    there."""
    from dataclasses import replace

    import ceracoder_tpu_torch.codec.h265.rowslice as rows
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    from ceracoder_tpu_torch.codec.h265.syntax import nal_unit

    w, h, n = 1920, 1088, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    runs = {}
    for mode in ("tiles", "slices"):
        enc = H265DeviceEncoder(w, h, qp=30, gop=60)
        if mode == "slices":
            enc.params = replace(enc.params, tile_rows=False)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        frames = [p.result() for p in enc.encode_run_async(
            source=src, indices=range(n))]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read_launches()
        check_hevc_launches(launches, 1)
        check([f.keyframe for f in frames] == [True] + [False] * (n - 1),
              f"{mode}: GOP structure (1 IDR + P frames)")
        for f in frames:
            check_hevc_frame(f.data, f.keyframe,
                             nals=1 if mode == "tiles" else h // 16)
        runs[mode] = {"enc": enc, "frames": frames, "seconds": secs,
                      "launches": launches}
    tiles, slices = runs["tiles"]["frames"], runs["slices"]["frames"]
    for i, (a, b) in enumerate(zip(tiles, slices)):
        check(all(torch.equal(x, y) for x, y in zip(a._recon_dev,
                                                    b._recon_dev)),
              f"frame {i}: the slice-mode reconstruction differs from the "
              "tile-rows one")
    check(len(entropy_inputs) == 2, "phase 17 (b) kept no entropy inputs")
    params = runs["slices"]["enc"].params
    spec_s = {}
    for coder in (rows.entropy_rows, rows.entropy_rows_native):
        t = time.perf_counter()
        for i, (arrays, qp, kw) in enumerate(entropy_inputs):
            rbsps = coder(params, arrays, qp, **kw)
            ntype = NAL_IDR_W_RADL if kw["idr"] else NAL_TRAIL_R
            data = b"".join(nal_unit(ntype, r, long_start_code=(j == 0))
                            for j, r in enumerate(rbsps))
            check(data == slices[i].data,
                  f"frame {i}: {coder.__name__} in slice mode on the "
                  f"numpy spec's arrays ({len(data)} B) differs from the "
                  f"card's ({len(slices[i].data)} B)")
        spec_s[coder.__name__] = time.perf_counter() - t

    def sizes(frames):
        b = [len(f.data) for f in frames]
        return {"bytes_idr": b[0], "bytes_p_mean": sum(b[1:]) / (n - 1),
                "bytes": b}
    out = {mode: {"seconds": r["seconds"], "launches": r["launches"],
                  **sizes(r["frames"])} for mode, r in runs.items()}
    out["entropy_seconds_idr_p"] = spec_s
    print(f"{tag} phase 18 (a) HEVC {w}x{h} one slice per CTB row: {n} "
          f"frames of {h // 16} slice NAL units each, reconstructions equal "
          f"to tile rows'; bytes/frame tile rows IDR "
          f"{out['tiles']['bytes_idr']}, P mean "
          f"{out['tiles']['bytes_p_mean']:.1f}; slices IDR "
          f"{out['slices']['bytes_idr']}, P mean "
          f"{out['slices']['bytes_p_mean']:.1f}; entropy_rows and "
          f"entropy_rows_native in slice mode on phase 17's spec arrays "
          f"equal the card's IDR and P ({spec_s['entropy_rows']:.3f} s, "
          f"{spec_s['entropy_rows_native']:.3f} s); run seconds tile rows "
          f"{out['tiles']['seconds']:.3f}, slices "
          f"{out['slices']['seconds']:.3f}; kernel launches "
          f"{out['slices']['launches']}")
    return out


@contextmanager
def deblock_patched_out():
    """ops/h265.py's deblock_frame_dev returns its input planes: the work
    of the JAX encoder's deblock=False (SAO, where on, reads the
    unfiltered reconstruction). For measurement only: the parameter
    sets still announce the deblock, so the stream does not decode to
    the reconstruction."""
    import ceracoder_tpu_torch.ops.h265 as ops

    real = ops.deblock_frame_dev
    ops.deblock_frame_dev = lambda y, u, v, *args, **kw: (y, u, v)
    try:
        yield
    finally:
        ops.deblock_frame_dev = real


def deblock_in_turns(pairs: int = 10, run_len: int = 10) -> dict:
    """Host ms per P frame of phase 6's encoder with the deblock on and
    patched out (deblock_patched_out), in turns on the same card: after
    a warm-up run each (the IDR and first-call costs), `pairs` pairs of
    runs of `run_len` P frames, the order within a pair alternating
    (on, off), (off, on), ... Each run is timed from its launch to its
    last result and synchronize."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    w, h = 1920, 1088
    src = DeviceTestPatternSource(w, h, texture=6)
    gop = 120
    encs = {on: H265DeviceEncoder(w, h, qp=30, gop=gop)
            for on in (True, False)}
    check(run_len * (pairs + 1) <= gop, "the runs must stay in one GOP")
    start = {True: 0, False: 0}

    def run(on: bool) -> float:
        idx = range(start[on], start[on] + run_len)
        start[on] += run_len
        with nullcontext() if on else deblock_patched_out():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for p in encs[on].encode_run_async(source=src, indices=idx):
                p.result()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / run_len

    run(True)
    run(False)
    ms = {True: [], False: []}
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            ms[on].append(run(on))
    med = {on: statistics.median(v) for on, v in ms.items()}
    return {"host_ms_per_p_frame_on": ms[True],
            "host_ms_per_p_frame_off": ms[False],
            "median_on": med[True], "median_off": med[False],
            "share": 1 - med[False] / med[True],
            "off_faster_pairs": sum(a > b for a, b in zip(ms[True],
                                                          ms[False]))}


def hevc_no_deblock(tag: str, hevc: dict) -> dict:
    """(b) Phase 6 with the deblock patched out (deblock_patched_out):
    its 3 runs of 10 frames, with phase 6's checks, beside phase 6's own
    figures of this call, and the deblock's share of the launches and
    device ms of one more P frame; then host ms per P frame with the
    deblock on and off in turns (deblock_in_turns), the one host share
    this phase reports."""
    with deblock_patched_out():
        off = phase_hevc_main_path(tag, label="HEVC deblock patched out")
    off.pop("first_two")
    keys = ("fps", "fps_runs_2_3", "launches_per_p_frame",
            "device_ms_per_p_frame", "bytes_idr", "bytes_p_mean")
    rows = {name: {k: r[k] for k in keys}
            for name, r in (("deblock_on_phase_6", hevc),
                            ("deblock_off", off))}
    on_, off_ = rows["deblock_on_phase_6"], rows["deblock_off"]
    share = {k: 1 - off_[k] / on_[k] for k in (
        "launches_per_p_frame", "device_ms_per_p_frame")}
    print(f"{tag} phase 18 (b) HEVC 1920x1088 deblock on (phase 6) / "
          f"patched out: frames/s {on_['fps']:.3f} / {off_['fps']:.3f} "
          f"(runs 2-3 {on_['fps_runs_2_3']:.3f} / "
          f"{off_['fps_runs_2_3']:.3f}); one more P frame "
          f"{on_['launches_per_p_frame']} / {off_['launches_per_p_frame']} "
          f"CUDA launches, {on_['device_ms_per_p_frame']:.3f} / "
          f"{off_['device_ms_per_p_frame']:.3f} device ms; the deblock's "
          f"share: launches {share['launches_per_p_frame']:.3f}, device "
          f"{share['device_ms_per_p_frame']:.3f}")
    check(share["launches_per_p_frame"] > 0,
          "the deblock patched out saved no launch")
    turns = deblock_in_turns()
    n = len(turns["host_ms_per_p_frame_on"])
    print(f"{tag} phase 18 (b) HEVC 1920x1088 deblock on / patched out in "
          f"turns, host ms per P frame over runs of 10: on "
          f"{', '.join(f'{x:.3f}' for x in turns['host_ms_per_p_frame_on'])}"
          f"; off "
          f"{', '.join(f'{x:.3f}' for x in turns['host_ms_per_p_frame_off'])}"
          f"; medians {turns['median_on']:.3f} / {turns['median_off']:.3f}, "
          f"the deblock's host share {turns['share']:.3f}; off faster in "
          f"{turns['off_faster_pairs']} of {n} pairs")
    return {**rows, "share": share, "in_turns": turns,
            "launches": off["launches"], "deblock_off_main_path": off}


def legacy_motion_outputs(cur, ref, ref_c) -> dict:
    """Every legacy motion helper on one frame pair (luma cur and ref,
    the reference's chroma plane), as the profiling tools chain them:
    name -> (callable, its output)."""
    import ceracoder_tpu_torch.ops.h265 as H
    import ceracoder_tpu_torch.ops.inter as I

    h, w = cur.shape
    pad, cpad = H.LUMA_SRC_PAD, H.CHROMA_PAD
    steps = {}

    def step(name, fn):
        steps[name] = (fn, fn())
        return steps[name][1]

    mv = step("h265 motion_search_dev", lambda: H.motion_search_dev(cur, ref))
    ref_pad = H._pad_edge(ref, pad, pad, pad, pad)
    planes = step("h265 _luma_qpel_planes",
                  lambda: H._luma_qpel_planes(ref_pad))
    planes14 = step("h265 _luma_qpel_planes out14",
                    lambda: H._luma_qpel_planes(ref_pad, True))
    mvq = step("h265 _refine_subpel",
               lambda: H._refine_subpel(cur, planes, mv, h, w))
    step("h265 _mc_luma_qpel", lambda: H._mc_luma_qpel(planes, mvq, h, w))
    step("h265 _uni_from_14 of _mc_luma_qpel out14", lambda: H._uni_from_14(
        H._mc_luma_qpel(planes14, mvq, h, w)))
    ref_c_pad = H._pad_edge(ref_c, cpad, cpad, cpad, cpad)
    step("h265 _mc_chroma_qpel",
         lambda: H._mc_chroma_qpel(ref_c_pad, mvq, h // 2, w // 2))
    step("h265 _mc_chroma_qpel out14",
         lambda: H._mc_chroma_qpel(ref_c_pad, mvq, h // 2, w // 2, True))
    full, _ = step("h264 motion_search_fullpel",
                   lambda: I.motion_search_fullpel(cur, ref))
    hp = step("h264 half_pel_planes", lambda: I.half_pel_planes(ref))
    cur_mb = I._mb_view(cur.to(torch.int32))
    mvh = step("h264 halfpel_refine",
               lambda: I.halfpel_refine(cur_mb, hp, full))
    step("h264 mc_luma_qpel", lambda: I.mc_luma_qpel(hp, mvh))
    step("h264 mc_chroma", lambda: I.mc_chroma(ref_c, mvh))
    return steps


def _flat_tensors(x) -> list:
    return ([x] if isinstance(x, torch.Tensor)
            else [t for y in x for t in _flat_tensors(y)])


def legacy_motion(tag: str) -> dict:
    """(c) The legacy motion helpers (HEVC ops/h265.py, H.264
    ops/inter.py; no encoder path calls them): GPU == CPU on frames 0
    and 1 of the device test pattern at 320x192, exact, then each at
    1920x1088: the median of 7 calls, each timed alone by CUDA events,
    after 2 warm-up calls."""
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource

    def frames(w, h, device):
        src = DeviceTestPatternSource(w, h, texture=6, device=device)
        (cur, _, _), (ref, ref_u, _) = src.frame(1), src.frame(0)
        return cur, ref, ref_u

    t = time.perf_counter()
    gpu = legacy_motion_outputs(*frames(320, 192, "cuda"))
    cpu = legacy_motion_outputs(*frames(320, 192, "cpu"))
    for name, (_, out) in gpu.items():
        a, b = _flat_tensors(out), _flat_tensors(cpu[name][1])
        check(len(a) == len(b) and all(
            x.shape == y.shape and torch.equal(x.cpu(), y)
            for x, y in zip(a, b)), f"legacy {name}: GPU and CPU differ")
    mv = cpu["h265 motion_search_dev"][1]
    check(bool(mv.any()), "legacy search found no motion on the pattern")
    print(f"{tag} phase 18 (c) legacy motion helpers GPU == CPU at "
          f"320x192: {len(gpu)} outputs identical "
          f"({time.perf_counter() - t:.2f} s)")
    steps = legacy_motion_outputs(*frames(1920, 1088, "cuda"))
    calls = {name: [time_cuda(fn, iters=1, warmup=2 if i == 0 else 0)
                    for i in range(7)]
             for name, (fn, _) in steps.items()}
    ms = {name: statistics.median(v) for name, v in calls.items()}
    print(f"{tag} phase 18 (c) legacy motion helpers at 1920x1088, ms per "
          f"call (median of 7 calls, CUDA events; min-max): " + ", ".join(
              f"{k} {ms[k]:.3f} ({min(v):.3f}-{max(v):.3f})"
              for k, v in calls.items()))
    return {"ms_1080p": ms, "ms_1080p_calls": calls}


def phase_slices_deblock_legacy(tag: str, hevc: dict,
                                entropy_inputs: list) -> dict:
    """Phase 18: (a) one slice per CTB row, (b) the deblock's share of a
    P frame, (c) the legacy motion helpers."""
    t0 = time.perf_counter()
    out = {"slices": hevc_slice_mode(tag, entropy_inputs),
           "no_deblock": hevc_no_deblock(tag, hevc),
           "legacy_motion": legacy_motion(tag)}
    out["seconds"] = time.perf_counter() - t0
    print(f"{tag} phase 18 (slices, deblock share, legacy motion) took "
          f"{out['seconds']:.1f} s")
    return out


DESIGNS = {
    "h264_deblock": "one-cta-per-mb-row, luma and chroma warps, "
                    "cp.async chunk ring",
    "h264_intra16": "carry pass one-cta-per-mb-row (chains on shuffles, "
                    "producer warps), then code pass one-warp-per-mb",
    "h265_intra": "carry pass one-cta-per-ctb-row (a warp per candidate, "
                  "one luma-tail warp, chroma off the chain, producer warps; "
                  "int8 mma.sync products), then code pass one-warp-per-ctb",
}

# Run in another tree's directory by `--compare-h264` / `--compare-h265`:
# that tree's own build, then its phases, their numbers as one line. Both
# trees' kernels are timed by this file's kernel_event_ms (argv[1]), so
# one method of reading the profiler measures both.
_TREE_PRELUDE = """
import importlib.util, json, sys, tempfile
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke as c
spec = importlib.util.spec_from_file_location("timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
c.kernel_event_ms = timing.kernel_event_ms
tag = "[" + c.nvidia_smi_line() + "]"
c.build_kernels(tag)
"""
_TREE_PHASES = {
    # phase 3 for K2 and K3, phase 10, phase 12
    "H264": """
n = c.phase_h264_kernels(tag)
cabac = c.phase_cabac_main_path(tag)
app = c.phase_h264_app_loop(tag)
print("H264_KERNELS " + json.dumps({
    "kernels": n, "cabac_main_path": {
        k: v for k, v in cabac.items() if k != "first_two"},
    "h264_app_loop": app}))
""",
    # phase 3 for K4, phase 6, phase 8
    "H265": """
n = c.phase_h265_kernels(tag)
hevc = c.phase_hevc_main_path(tag)
with tempfile.TemporaryDirectory(dir=c.ROOT / "build") as d:
    app = c.phase_app_loop(tag, Path(d))
print("H265_KERNELS " + json.dumps({
    "kernels": n, "hevc_main_path": {
        k: v for k, v in hevc.items() if k != "first_two"},
    "app_loop": app}))
""",
}


def compare_trees(other: Path, codec: str, summarize) -> list:
    """Run `_TREE_PHASES[codec]` of another tree (e.g. the parent commit
    unpacked with git archive) and of this one on the same card, each in
    its own process, in turns other, this, this, other. Returns each
    run's row, `summarize(numbers, tree)` with the tree's name; each
    run's full output goes to build/compare/ (compare_<i>_<tree>.log for
    H.264, compare_h265_<i>_<tree>.log for HEVC)."""
    logs = ROOT / "build" / "compare"
    logs.mkdir(parents=True, exist_ok=True)
    prefix = "compare" if codec == "H264" else "compare_h265"
    runs = []
    for i, tree in enumerate((other, ROOT, ROOT, other)):
        which = "this" if tree == ROOT else "other"
        proc = subprocess.run(
            [sys.executable, "-c", _TREE_PRELUDE + _TREE_PHASES[codec],
             str(Path(__file__).resolve())], cwd=tree, capture_output=True,
            text=True, timeout=900)
        (logs / f"{prefix}_{i}_{which}.log").write_text(proc.stdout
                                                        + proc.stderr)
        check(proc.returncode == 0,
              f"the {codec} phases of {tree} failed:\n{proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(f"{codec}_KERNELS ")][-1]
        row = {"tree": which,
               **summarize(json.loads(line.split(" ", 1)[1]), tree)}
        runs.append(row)
        print(f"compare run {i} ({which}, {tree}): " + json.dumps(row))
    return runs


def compare_h264(other: Path) -> dict:
    """K2 and K3 and the H.264 paths that run them, of another tree
    against this one's (compare_trees): each tree's phase 3 for K2 and
    K3, phase 10 (CABAC main path) and phase 12 (H.264 app loop). Each
    run's row: device ms per call on the real 1080p IDR and P inputs,
    phase 10's frames/s and device ms per frame and phase 12's frames/s
    and watchdog gap."""
    def summarize(numbers, tree):
        row = {}
        for name in ("h264_deblock_rows", "h264_intra16_cols"):
            for kind in ("IDR", "P"):
                n = numbers["kernels"][name][kind]
                row[f"{name} {kind}"] = n["ms"]
                row[f"{name} {kind} event_ms"] = n["event_ms"]
            check(numbers["kernels"][name]["max_abs_err"] == 0,
                  f"{name} of {tree} differs from its plain version")
        cabac, app = numbers["cabac_main_path"], numbers["h264_app_loop"]
        row.update({
            "phase 10 fps": cabac["fps"],
            "phase 10 fps runs 2-3": cabac["fps_runs_2_3"],
            "phase 10 device ms per P": cabac["device_ms_per_p_frame"],
            "phase 10 device ms per IDR": cabac["device_ms_per_idr"],
            "phase 10 bytes IDR / P": [cabac["bytes_idr"],
                                       cabac["bytes_p_mean"]],
            "phase 12 fps": app["fps"],
            "phase 12 watchdog gap s": app["longest_watchdog_gap_s"]})
        return row
    return {"runs": compare_trees(other, "H264", summarize)}


def compare_h265(other: Path) -> dict:
    """K4 and the HEVC paths that run it, of another tree against this
    one's (compare_trees): each tree's phase 3 for K4, phase 6 (HEVC main
    path) and phase 8 (HEVC app loop). Each run's row: device ms per
    call (and per kernel, where the call launches more than one) on the
    real 1080p and 4K IDR inputs, phase 6's frames/s, bytes and device
    ms and launches per IDR, and phase 8's frames/s and watchdog gap."""
    def summarize(numbers, tree):
        k = numbers["kernels"]
        check(k["max_abs_err"] == 0,
              f"h265_intra_cols of {tree} differs from its plain version")
        row = {}
        for kind in ("1080p", "4K"):
            row[f"K4 {kind}"] = k[kind]["ms"]
            row[f"K4 {kind} spread"] = k[kind]["spread"]
            row[f"K4 {kind} per kernel"] = k[kind]["per_kernel"]
            row[f"K4 {kind} event_ms"] = k[kind]["event_ms"]
        hevc, app = numbers["hevc_main_path"], numbers["app_loop"]
        row.update({
            "phase 6 fps": hevc["fps"],
            "phase 6 fps runs 2-3": hevc["fps_runs_2_3"],
            "phase 6 bytes IDR / P": [hevc["bytes_idr"],
                                      hevc["bytes_p_mean"]],
            "phase 6 device ms per IDR": hevc["device_ms_per_idr"],
            "phase 6 launches per IDR": hevc["launches_per_idr"],
            "phase 8 fps": app["fps"],
            "phase 8 watchdog gap s": app["longest_watchdog_gap_s"]})
        return row
    return {"runs": compare_trees(other, "H265", summarize)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import ceracoder_tpu_torch  # noqa: F401  (fails outside the repo)

    compares = {"--compare-h264": compare_h264, "--compare-h265": compare_h265}
    if sys.argv[1:2] and sys.argv[1] in compares:
        print(nvidia_smi_line())
        print(json.dumps({sys.argv[1][2:].replace("-", "_"): compares[
            sys.argv[1]](Path(sys.argv[2]).resolve())}))
        return 0
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tag = f"[{smi}]"
    print(f"device: {kind}, count {count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    build_kernels(tag)
    k1 = phase_kernels(tag)
    h264k = phase_h264_kernels(tag)
    h265k = phase_h265_kernels(tag)
    main_out = phase_main_path(tag)
    phase_gpu_equals_cpu(tag, main_out)
    hevc = phase_hevc_main_path(tag)
    phase_hevc_gpu_equals_cpu(tag, hevc)
    print(json.dumps({"hevc_main_path": {
        k: v for k, v in hevc.items() if k != "first_two"}}))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        app = phase_app_loop(tag, Path(d))
        print(json.dumps({"app_loop": app}))
        phase_app_gpu_equals_cpu(tag, Path(d))
    cabac = phase_cabac_main_path(tag)
    phase_cabac_gpu_equals_cpu(tag, cabac)
    print(json.dumps({"cabac_main_path": {
        k: v for k, v in cabac.items() if k != "first_two"}}))
    h264_app = phase_h264_app_loop(tag)
    print(json.dumps({"h264_app_loop": h264_app}))
    sao = phase_hevc_sao(tag)
    phase_hevc_gpu_equals_cpu(tag, sao, sao=True)
    print(json.dumps({"hevc_sao_path": {
        k: v for k, v in sao.items() if k != "first_two"}}))
    bpath = phase_hevc_bframes(tag)
    phase_hevc_bframes_gpu_equals_cpu(tag, bpath)
    print(json.dumps({"hevc_bframes_path": {
        k: v for k, v in bpath.items() if k != "first_three"}}))
    par = phase_parallel(tag, [torch.device("cuda", i)
                               for i in range(count)])
    print(json.dumps({"parallel_path": par}))
    sup = phase_supervisor(tag)
    print(json.dumps({"supervisor_path": sup}))
    ref, entropy_inputs = phase_reference_codec(tag)
    print(json.dumps({"reference_codec": ref}))
    p18 = phase_slices_deblock_legacy(tag, hevc, entropy_inputs)
    print(json.dumps({"slices_deblock_legacy": p18}))

    def launches(name):
        return {"launches_cavlc_path": main_out["launches"][name],
                "launches_hevc_path": hevc["launches"][name],
                "launches_app_loop": app["launches"][name],
                "launches_cabac_path": cabac["launches"][name],
                "launches_h264_app_loop": h264_app["launches"][name],
                "launches_hevc_sao_path": sao["launches"][name],
                "launches_hevc_bframes_path": bpath["launches"][name],
                "launches_hevc_banded_path":
                    par["bands_1080p_4"]["launches"][name],
                "launches_gop_parallel_path":
                    par["gop_parallel"]["launches"][name],
                "launches_h264_sharded_path":
                    par["h264_mesh"]["launches"][name],
                "launches_per_stream_control":
                    sup["per_stream_control"]["launches"][name],
                "launches_hevc_slices_path":
                    p18["slices"]["slices"]["launches"][name],
                "launches_hevc_no_deblock_path":
                    p18["no_deblock"]["launches"][name]}
    p = k1["P"]
    kernels = [{
        "name": "merge_windows", "route": KERNELS["merge_windows"][2],
        "source": "ceracoder_tpu_torch/csrc/merge_windows.cu",
        "replaces": KERNELS["merge_windows"][1],
        "launches": main_out["launches"]["merge_windows"],
        "max_abs_err": max(k1["max_abs_err"], k1["IDR"]["max_abs_err"],
                           p["max_abs_err"]),
        "ms": p["ms"], "ms_spread": p["spread"], "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "bound_share": p["bound_share"], "library_ms": p["library_ms"],
        "library_i32_ms": p["library_i32_ms"], "design": "one-cta-per-row",
        **launches("merge_windows"),
    }]
    # K2 and K3 run on the CABAC path (the jobspec default), also on
    # the CAVLC path and in the H.264 app loop
    for src in ("h264_deblock", "h264_intra16"):
        name, replaces, route = KERNELS[src]
        n, idr = h264k[name]["P"], h264k[name]["IDR"]
        kernels.append({
            "name": name, "route": route,
            "source": f"ceracoder_tpu_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": cabac["launches"][name],
            "max_abs_err": max(h264k[name]["max_abs_err"],
                               par["h264_mesh"]["max_abs_err"]
                               if name == "h264_intra16_cols" else 0),
            "ms": n["ms"], "ms_spread": n["spread"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"], "bound_share": n["bound_share"],
            "library_ms": None, "graph_replay_ms": n["graph_ms"],
            "plain_launches": n["plain_launches"],
            "ms_idr": idr["ms"], "plain_ms_idr": idr["plain_ms"],
            "graph_replay_ms_idr": idr["graph_ms"],
            "bound_ms_idr": idr["bound_ms"],
            "kernels_per_call": n["kernels_per_call"],
            "ms_per_kernel": n["per_kernel"],
            "ms_per_kernel_idr": idr["per_kernel"],
            "design": DESIGNS[src], **launches(name),
        })
    # K4 runs on every HEVC IDR: the HEVC path (bench.py's default), the
    # HEVC app loop, the SAO path and the B-frame path
    name, replaces, route = KERNELS["h265_intra"]
    n, n4k = h265k["1080p"], h265k["4K"]
    kernels.append({
        "name": name, "route": route,
        "source": "ceracoder_tpu_torch/csrc/h265_intra.cu",
        "replaces": replaces, "launches": hevc["launches"][name],
        "max_abs_err": max(h265k["max_abs_err"],
                           par["bands_4k_8"]["max_abs_err"]),
        "ms": n["ms"], "ms_spread": n["spread"], "plain_ms": n["plain_ms"],
        "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
        "bound_share": n["bound_share"], "library_ms": None,
        "graph_replay_ms": n["graph_ms"],
        "plain_launches": n["plain_launches"],
        "ms_4k": n4k["ms"], "plain_ms_4k": n4k["plain_ms"],
        "graph_replay_ms_4k": n4k["graph_ms"], "bound_ms_4k": n4k["bound_ms"],
        "kernels_per_call": n["kernels_per_call"],
        "ms_per_kernel": n["per_kernel"],
        "ms_per_kernel_4k": n4k["per_kernel"],
        "design": DESIGNS["h265_intra"], **launches(name),
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
