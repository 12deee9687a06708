#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (ceracoder_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. device: the card's name, power limit and count;
2. build: every hand-written kernel from csrc/, one nvcc per source,
   all started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   on random inputs, on edge cases (`merge_edge_cases`) and on the real
   inputs of a 1080p IDR and P frame, bit-equal; timed (torch.profiler
   device time over 5 windows, and CUDA events) beside the plain
   version, one-call PyTorch yardsticks and the memory bound;
4. main path: H264Encoder(1920, 1088, qp=28, gop=60, cabac=False) on
   DeviceTestPatternSource(1920, 1088, texture=6), 3 runs of 10 frames
   through encode_run_async; kernel launch counts are set to 0 just
   before and read just after;
5. GPU equals CPU: the same port at 320x192 (6 frames, gop 4, two
   runs) on cuda and cpu gives byte-identical streams, and so do the
   first IDR and P frame at 1080p;
6. HEVC main path: H265DeviceEncoder(1920, 1088, qp=30, gop=60)
   (deblocking, tile rows, native entropy) on the same source, 3 runs
   of 10 frames through encode_run_async; checks the GOP structure
   (1 IDR, then P), the NAL types (IDR_W_RADL, then TRAIL_R), the
   start codes and the recon shapes; kernel launch counts are set to 0
   just before and read just after (the HEVC path runs no hand-written
   kernel: K1 must stay at 0); prints frames/s, seconds per run, bytes
   per IDR and mean P frame, fallback frames and peak device memory;
7. HEVC GPU equals CPU: 320x192 (6 frames, gop 4, two runs) and the
   first 1080p IDR + P frame, byte-identical;
8. the product loop: CeracoderApp (python -m ceracoder_tpu_torch) on a
   devtest 1920x1088 job at 60 frames/s, hevc, gop 60, runs of 10, tone
   audio where the AAC encoder builds, the fixed balancer, latency
   2000 ms, realtime pacing, sending to a loopback SRT listener (UDP
   where libsrt does not load); 40 warm-up frames, then 120 timed.
   Checks every payload (1316 B of 188 B TS packets, sync bytes,
   unbroken continuity counters), the keyframes (frames 0, 60, 120) and
   that K1 is launched 0 times; prints emit-to-emit frames/s and the
   host seconds in encode_run_async, PendingFrame.result() and mux +
   pack + send, timed by wrapping those calls here, not in the app;
9. app GPU equals CPU: one 320x192 job through CeracoderApp on cuda and
   on cpu gives identical TS bytes, for the host-source run loop (run =
   4), the per-frame loop (run = 1) and the device-source run loop, for
   codec = hevc and codec = h264;
10. H.264 CABAC main path: H264Encoder(1920, 1088, qp=28, gop=60) with
   its defaults (CABAC, intra-in-P) on the device test pattern, 3 runs
   of 10 frames through encode_run_async; checks the GOP structure, one
   NAL unit per MB row, the recon shapes and that K1 is launched 0
   times; prints frames/s, bytes per IDR and mean P frame, intra MBs per
   P frame (read off the unpacked rows), fallback frames, peak device
   memory, and the CUDA launches and device ms of one more P frame
   (torch.profiler);
11. CABAC GPU equals CPU: 320x192 on the device source (6 frames, gop
   4, two runs) and on host frames whose bottom half changes to new
   content mid-clip (so both code intra MBs in P slices, which is
   checked), and the first 1080p IDR + P frame, byte-identical;
12. the H.264 product loop: CeracoderApp on jobs/h264_test_1080p30 (host
   test pattern 1920x1080, burn-in, codec h264, gop 60, runs of 8), the
   fixed balancer, loopback SRT (UDP where libsrt does not load), the
   stall watchdog off; 8 warm-up frames, then 16 timed. Checks the
   payloads, continuity, keyframes and that K1 is launched 0 times;
   prints emit-to-emit frames/s, the host seconds as phase 8 and the
   longest time the watchdog's position stood still.

The native libraries (native/src: the HEVC entropy stage, the H.264
CABAC row coder, the balancer core and, where the libavcodec headers
are, the audio shim; g++) are built in phase 2 beside the kernels.

The last lines are the nvidia-smi line, a JSON line of kernel numbers
and the result line {"ok": true, "device": {...}}. It prints no result
and exits non-zero without CUDA or without the repository beside it.
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
from pathlib import Path

import numpy as np
import torch

# kernel name -> (TPU kernel it replaces, route)
KERNELS = {
    "merge_windows": ("ceracoder_tpu/ops/bitpack.py:112", "cuda"),
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


def build_kernels(tag: str) -> None:
    from ceracoder_tpu_torch.utils import host_build
    from ceracoder_tpu_torch.utils.cuda_build import build_library

    native_libs = ["hevc_entropy", "h264_cabac", "balancer"]
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
# Main path and GPU-vs-CPU
# ---------------------------------------------------------------------------

def check_stream(data: bytes, mbh: int) -> None:
    check(data.startswith(b"\x00\x00\x00\x01"), "frame lacks a start code")
    nals = data.count(b"\x00\x00\x01")
    check(nals == mbh, f"{nals} NAL units, want one per MB row ({mbh})")


def phase_main_path(tag: str) -> dict:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
    from ceracoder_tpu_torch.ops.bitpack import merge_windows

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H264Encoder(w, h, qp=28, gop=60, cabac=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_windows.launches = 0
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
    launches = merge_windows.launches
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
    sizes = [len(f.data) for f in frames]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "fallback_frames": enc.fallback_frames, "k1_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} main path 1080p CAVLC: {nf} frames in {secs:.3f} s "
          f"= {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} main path bytes/frame: IDR {out['bytes_idr']}, P mean "
          f"{out['bytes_p_mean']:.1f}; fallback frames "
          f"{out['fallback_frames']}; K1 launches {launches}; peak device "
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

NAL_IDR_W_RADL, NAL_TRAIL_R = 19, 1


def check_hevc_frame(data: bytes, idr: bool) -> None:
    """One frame: a single NAL unit (one slice, a tile per CTB row)
    behind a 4-byte start code, of the frame's NAL type."""
    check(data.startswith(b"\x00\x00\x00\x01"), "frame lacks a start code")
    nals = data.count(b"\x00\x00\x01")
    check(nals == 1, f"{nals} NAL units, want 1 (tile rows, one slice)")
    want = NAL_IDR_W_RADL if idr else NAL_TRAIL_R
    got = (data[4] >> 1) & 0x3F
    check(got == want, f"NAL type {got}, want {want}")


def phase_hevc_main_path(tag: str) -> dict:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    from ceracoder_tpu_torch.ops.bitpack import merge_windows

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H265DeviceEncoder(w, h, qp=30, gop=60)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_windows.launches = 0
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
    launches = {"merge_windows": merge_windows.launches}
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
    check(launches["merge_windows"] == 0,
          "K1 launched on the HEVC path, which runs no hand kernel")
    sizes = [len(f.data) for f in frames]
    out = {
        "frames": nf, "seconds": secs, "fps": nf / secs,
        "fps_runs_2_3": 2 * run_len / sum(run_secs[1:]),
        "run_seconds": run_secs,
        "bytes_idr": sizes[0], "bytes_p_mean": sum(sizes[1:]) / (nf - 1),
        "fallback_frames": enc.fallback_frames, "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "first_two": b"".join(f.data for f in frames[:2]),
    }
    print(f"{tag} HEVC main path 1080p: {nf} frames in {secs:.3f} s "
          f"= {out['fps']:.3f} frames/s (runs 2-3: "
          f"{out['fps_runs_2_3']:.3f} frames/s; per run "
          f"{', '.join(f'{s:.3f}' for s in run_secs)} s)")
    print(f"{tag} HEVC main path bytes/frame: IDR {out['bytes_idr']}, P "
          f"mean {out['bytes_p_mean']:.1f}; fallback frames "
          f"{out['fallback_frames']}; hand-kernel launches {launches}; "
          f"peak device memory {out['peak_mem_bytes']} B")
    return out


def encode_hevc_stream(device: str, w: int, h: int, runs, gop: int,
                       qp: int, texture: int) -> bytes:
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    src = DeviceTestPatternSource(w, h, texture=texture, device=device)
    enc = H265DeviceEncoder(w, h, qp=qp, gop=gop, device=device)
    data = enc.headers()
    for idx in runs:
        data += b"".join(p.result().data
                         for p in enc.encode_run_async(source=src,
                                                       indices=idx))
    return data


def phase_hevc_gpu_equals_cpu(tag: str, main: dict) -> None:
    runs = [range(0, 3), range(3, 6)]
    t = time.perf_counter()
    gpu = encode_hevc_stream("cuda", 320, 192, runs, 4, 30, 6)
    cpu = encode_hevc_stream("cpu", 320, 192, runs, 4, 30, 6)
    check(gpu == cpu, "HEVC 320x192 GPU and CPU streams differ")
    print(f"{tag} HEVC GPU == CPU at 320x192, 6 frames, gop 4, 2 runs: "
          f"{len(gpu)} B identical ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    cpu2 = encode_hevc_stream("cpu", 1920, 1088, [range(2)], 60, 30, 6)
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    hdr = H265DeviceEncoder(1920, 1088, qp=30, gop=60,
                            device="cpu").headers()
    check(cpu2 == hdr + main["first_two"],
          "HEVC 1080p IDR + P frame: GPU and CPU bytes differ")
    print(f"{tag} HEVC GPU == CPU at 1920x1088, first IDR + P frame: "
          f"{len(main['first_two'])} B identical (CPU run "
          f"{time.perf_counter() - t:.2f} s)")


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
    from ceracoder_tpu_torch.ops.bitpack import merge_windows

    w, h, runs, run_len = 1920, 1088, 3, 10
    src = DeviceTestPatternSource(w, h, texture=6)
    enc = H264Encoder(w, h, qp=28, gop=60)
    check(enc.cabac and enc.intra_in_p, "H264Encoder defaults")
    intra = IntraCount()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_windows.launches = 0
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
        launches = merge_windows.launches
        peak = torch.cuda.max_memory_allocated()
        # one more P frame, under the profiler: its kernel launches
        n = runs * run_len
        p_launches, p_device_ms = kernel_launches(
            lambda: enc.encode_run_async(source=src,
                                         indices=[n])[0].result())
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
        "launches_per_p_frame": p_launches,
        "device_ms_per_p_frame": p_device_ms,
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
          f"fallback frames {out['fallback_frames']}; K1 launches "
          f"{launches}; peak device memory {peak} B; one more P frame: "
          f"{p_launches} CUDA launches, {p_device_ms:.3f} device ms")
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


def run_app_loop(job, warm: int, timed_frames: int, want_keys: list):
    """CeracoderApp on `job`, fixed balancer, latency 2000 ms, realtime,
    to a loopback listener, the stall watchdog off; `warm` frames, then
    `timed_frames` timed emit to emit. Checks and returns the numbers
    phases 8 and 12 print."""
    from ceracoder_tpu_torch.app.cli import CliOptions
    from ceracoder_tpu_torch.app.main import CeracoderApp
    from ceracoder_tpu_torch.ops.bitpack import merge_windows

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
    merge_windows.launches = 0
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
    launches = merge_windows.launches
    check(rc == 0, f"app exited {rc}")
    check(len(emits) == total, f"{len(emits)} frames emitted, want {total}")
    window = emits[-1] - emits[warm - 1]
    packets = check_ts_payloads(payloads)
    check([i for i, k in enumerate(keys) if k] == want_keys,
          f"keyframes at {[i for i, k in enumerate(keys) if k]}, want "
          f"{want_keys}")
    check(launches == 0, f"K1 launched {launches} times in the app loop")
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
        "k1_launches": launches,
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
          f"{out['fallback_frames']}; K1 launches {out['k1_launches']}; "
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
    out = run_app_loop(job, APP_WARM, APP_TIMED, [0, 60, 120])
    out["job"] = {"kind": "devtest", "width": APP_W, "height": APP_H,
                  "fps": APP_FPS, "codec": "hevc", "gop": APP_GOP,
                  "run": APP_RUN, "audio": "tone 128 kbps",
                  "balancer": "fixed", "latency_ms": 2000,
                  "realtime": True}
    print_app_loop(tag, f"app loop {APP_W}x{APP_H} at {APP_FPS} frames/s, "
                   "HEVC (keyframes 0, 60, 120)", out)
    return out


H264_APP_JOB = ROOT / "jobs" / "h264_test_1080p30"
H264_APP_WARM, H264_APP_TIMED = 8, 16


def phase_h264_app_loop(tag: str) -> dict:
    out = run_app_loop(H264_APP_JOB, H264_APP_WARM, H264_APP_TIMED, [0])
    out["job"] = {"file": "jobs/h264_test_1080p30",
                  "text": H264_APP_JOB.read_text(), "run": 8,
                  "balancer": "fixed", "latency_ms": 2000,
                  "realtime": True}
    print_app_loop(tag, "H.264 app loop, jobs/h264_test_1080p30 (test "
                   "pattern 1920x1080 at 30 frames/s, CABAC, gop 60, "
                   "runs of 8; keyframe 0)", out)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import ceracoder_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tag = f"[{smi}]"
    print(f"device: {kind}, count {count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    build_kernels(tag)
    k1 = phase_kernels(tag)
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

    p = k1["P"]
    kernels = [{
        "name": "merge_windows", "route": KERNELS["merge_windows"][1],
        "source": "ceracoder_tpu_torch/csrc/merge_windows.cu",
        "replaces": KERNELS["merge_windows"][0],
        "launches": main_out["k1_launches"],
        "max_abs_err": max(k1["max_abs_err"], k1["IDR"]["max_abs_err"],
                           p["max_abs_err"]),
        "ms": p["ms"], "ms_spread": p["spread"], "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "bound_share": p["bound_share"], "library_ms": p["library_ms"],
        "library_i32_ms": p["library_i32_ms"], "design": "one-cta-per-row",
        "launches_app_loop": app["k1_launches"],
        "launches_cabac_path": cabac["k1_launches"],
        "launches_h264_app_loop": h264_app["k1_launches"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
