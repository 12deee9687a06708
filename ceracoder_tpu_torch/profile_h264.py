"""Stage breakdown of the H.264 encoder on the GPU.

    python3 -m ceracoder_tpu_torch.profile_h264 [--width 1920]
        [--height 1088] [--p-frames 3] [--cavlc]

Encodes one IDR and `--p-frames` P frames of the device test pattern
(texture 6, qp 28, gop 60) stage by stage, with a
`torch.cuda.synchronize()` around each stage, and prints one JSON line
per frame: host-clock milliseconds, CUDA kernel launches and device
kernel milliseconds (torch.profiler) per stage, and the device's idle
share of the frame (1 - device ms / host ms).

By default the encoder's default path, CABAC with intra-in-P, after an
unreported warm-up IDR + P frame, through the encoder's own per-frame
code (codec/h264/cabac_run.py: encode_idr_syntax / encode_p_syntax with
a stage hook), then one line with the mean of the P frames. Stages:
source, intra (IDR) or inter + intra fallback (P), deblock, syntax
compaction + packed row, D2H copy (the packed rows, then the level
chunks used), native entropy (unpack, densify, native CABAC rows, NAL
framing; host only). P lines also give the frame's intra MBs.

`--cavlc`: the CAVLC path (`cabac=False`): source, intra or inter,
deblock, slot assembly, packing (finalize + pack_rows with K1 +
compact), host copy.

`--count-ops` needs no card: it counts the torch ops each CABAC stage
dispatches (views not counted; about one kernel launch each on the
card) for an IDR and a P frame on the CPU at 320x192 and 640x192, and
extrapolates them linearly in the MB columns to `--width` (the column
loops are batched over MB rows, so rows do not add launches).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h264 import cabac_run
from ceracoder_tpu_torch.codec.h264 import device_entropy as de
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
from ceracoder_tpu_torch.ops.deblock import deblock_frame_rows
from ceracoder_tpu_torch.ops.inter import encode_frame_p
from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows
from ceracoder_tpu_torch.ops.transform import chroma_qp


def time_stage(name, fn, out):
    """Run fn() (a pure stage) twice: once timed on the host clock
    between synchronizations, once under torch.profiler to count its
    kernel launches and their device time; record into out[name]."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.events() if e.device_time_total > 0]
    out[name] = {"host_ms": host_ms, "launches": len(evts),
                 "device_ms": sum(e.device_time_total for e in evts) / 1e3}
    return res


STAT_KEYS = ("host_ms", "launches", "device_ms")


def stage_total(st: dict) -> dict:
    """Sum of the stages' numbers, and the device's idle share."""
    total = {k: sum(s[k] for s in st.values()) for k in STAT_KEYS}
    total["device_idle_share"] = 1 - total["device_ms"] / total["host_ms"]
    return total


def profile_cabac(width: int, height: int, p_frames: int) -> list[dict]:
    n = 1 + p_frames
    src = DeviceTestPatternSource(width, height, texture=6)
    enc = H264Encoder(width, height, qp=28, gop=60)
    qp, qpc = 28, chroma_qp(28)
    planes = enc._planes_fn(None, src, range(n))
    n_mb = enc.mbh * enc.mbw
    rows, ref = [], None
    for i in range(n):
        idr = i == 0
        st: dict = {}

        def timer(name, fn):
            return time_stage(name, fn, st)
        y, u, v = timer("source", lambda: planes(i))
        if idr:
            chunk = enc._cabac_idr_chunk
            cap = max(enc._cabac_cap, 2 * chunk)
            packed, rest, ref = cabac_run.encode_idr_syntax(
                y, u, v, qp, qpc, cap, chunk, enc.deblock, stage=timer)
        else:
            chunk, cap = cabac_run.CHUNK, enc._cabac_cap
            packed, rest, ref = cabac_run.encode_p_syntax(
                y, u, v, ref, qp, qpc, cap, chunk, enc.deblock,
                enc.intra_in_p, stage=timer)
        host = timer("d2h_copy", lambda: enc._cabac_to_host(
            packed, rest, cap, chunk)())
        frame = timer("entropy", lambda: enc._make_cabac_pending(
            0, idr, qp, qpc, 0 if idr else i, 0, lambda: host, cap, chunk,
            [ref], None, planes).result())
        row = {"frame": i, "type": "IDR" if idr else "P",
               "bytes": len(frame.data), "stages": st, "total": stage_total(st)}
        if not idr:
            lay = cabac_run.pack_layout(n_mb, False, chunk)
            meta = host[0][0, lay["meta"]:lay["meta"] + n_mb]
            row["intra_mbs"] = int((meta & 1).sum())
        rows.append(row)
    return rows


def mean_p(rows: list[dict]) -> dict:
    """The mean of the P frames' rows, stage by stage."""
    ps = [r for r in rows if r["type"] == "P"]
    stages = {name: {k: sum(r["stages"][name][k] for r in ps) / len(ps)
                     for k in STAT_KEYS} for name in ps[0]["stages"]}
    return {"frame": "mean", "type": f"P (mean of {len(ps)})",
            "bytes": sum(r["bytes"] for r in ps) / len(ps),
            "intra_mbs": sum(r["intra_mbs"] for r in ps) / len(ps),
            "stages": stages, "total": stage_total(stages)}


VIEW_OPS = {"view", "reshape", "_unsafe_view", "transpose", "permute",
            "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
            "detach", "t", "as_strided", "unfold", "split", "unbind",
            "lift_fresh"}


class _OpCount(TorchDispatchMode):
    """Counts the non-view torch ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEW_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count_cabac_ops(width: int, height: int) -> dict:
    """Ops per stage of an IDR and a P frame of the device test pattern
    on the CPU (stage name -> [IDR or P count])."""
    enc = H264Encoder(width, height, qp=28, gop=60, device="cpu")
    src = DeviceTestPatternSource(width, height, texture=6, device="cpu")
    qp, qpc = 28, chroma_qp(28)
    counts: dict = {}

    def counter(name, fn):
        with _OpCount() as c:
            res = fn()
        counts.setdefault(name, []).append(c.n)
        return res
    chunk = enc._cabac_idr_chunk
    _, _, ref = cabac_run.encode_idr_syntax(
        *src.frame(0), qp, qpc, max(enc._cabac_cap, 2 * chunk), chunk,
        enc.deblock, stage=counter)
    cabac_run.encode_p_syntax(*src.frame(1), ref, qp, qpc, enc._cabac_cap,
                              cabac_run.CHUNK, enc.deblock, enc.intra_in_p,
                              stage=counter)
    return counts


def extrapolate_ops(width: int) -> dict:
    """count_cabac_ops at 320x192 and 640x192, linear in MB columns:
    stage -> {"per_mb_column", "constant", "at_width"} (lists: IDR, P
    where the stage runs on both)."""
    a, b = count_cabac_ops(320, 192), count_cabac_ops(640, 192)
    out = {}
    for name in a:
        per_col = [(nb - na) / 20 for na, nb in zip(a[name], b[name])]
        const = [na - pc * 20 for na, pc in zip(a[name], per_col)]
        out[name] = {"per_mb_column": per_col, "constant": const,
                     "at_width": [c + pc * (width // 16)
                                  for c, pc in zip(const, per_col)]}
    return out


def profile_cavlc(width: int, height: int, p_frames: int) -> list[dict]:
    src = DeviceTestPatternSource(width, height, texture=6)
    enc = H264Encoder(width, height, qp=28, gop=60, cabac=False)
    qp, qpc = 28, chroma_qp(28)
    mbh, mbw = height // 16, width // 16
    dev = enc.device
    rows = []
    ref = None
    for i in range(1 + p_frames):
        idr = i == 0
        hv, hl = enc._hdr_arrays(idr, qp, 0 if idr else i, 0)
        hv = torch.as_tensor(hv, device=dev)
        hl = torch.as_tensor(hl, device=dev)
        st: dict = {}
        y, u, v = time_stage("source", lambda: src.frame(i), st)
        if idr:
            outs = time_stage("intra", lambda: encode_frame_i16_rows(
                y, u, v, qp, qpc), st)
            nnz = torch.zeros((mbh, mbw, 4, 4), dtype=torch.int32,
                              device=dev)
            mv = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
        else:
            outs = time_stage("inter", lambda: encode_frame_p(
                y, u, v, *ref, qp, qpc), st)
            nnz = (outs["luma_levels"] != 0).any(-1).to(torch.int32)
            mv = outs["mv"]
        ref = time_stage("deblock", lambda: deblock_frame_rows(
            *outs["recon"], nnz, mv, qp, qpc, intra_frame=idr), st)
        assemble = de.assemble_i_slots if idr else de.assemble_p_slots
        mb_vals, mb_lens = time_stage("assemble", lambda: assemble(outs), st)
        row_bytes, stream = time_stage("pack", lambda: de.pack_frame(
            hv, hl, mb_vals, mb_lens, enc._capw, enc._totcap), st)
        time_stage("host_copy", lambda: (row_bytes.cpu(), stream.cpu()), st)
        total = {k: sum(s[k] for s in st.values())
                 for k in ("host_ms", "launches", "device_ms")}
        rows.append({"frame": i, "type": "IDR" if idr else "P",
                     "stages": st, "total": total})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--p-frames", type=int, default=3)
    ap.add_argument("--cavlc", action="store_true",
                    help="profile the CAVLC path (cabac=False)")
    ap.add_argument("--count-ops", action="store_true",
                    help="count the CABAC stages' ops on the CPU")
    args = ap.parse_args()
    if args.count_ops:
        print(json.dumps(extrapolate_ops(args.width)))
        return
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.cavlc:
        rows = profile_cavlc(args.width, args.height, args.p_frames)
    else:
        # a first IDR + P pass loads the library and warms the
        # allocator; not reported
        profile_cabac(args.width, args.height, 1)
        rows = profile_cabac(args.width, args.height, args.p_frames)
        rows.append(mean_p(rows))
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
