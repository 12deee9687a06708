"""Stage breakdown of the HEVC run path on the GPU.

    python3 -m ceracoder_tpu_torch.profile_hevc [--width 1920]
        [--height 1088] [--p-frames 3] [--sao]

After an unreported warm-up IDR + P frame, encodes one IDR and
`--p-frames` P frames of the device test pattern with
`H265DeviceEncoder(1920, 1088, qp=30, gop=60)` (texture 6; deblocking,
tile rows, native entropy; with `--sao` also SAO), through the
encoder's own per-frame code (ops/h265.py: encode_frame_row, given a
stage hook that wraps each stage in `torch.cuda.synchronize()`), and
prints one JSON line per frame, then one with the mean of the P
frames: host-clock milliseconds, CUDA kernel launches and device
kernel milliseconds (torch.profiler) per stage, and the device's idle
share of the frame (1 - device ms / host ms). Stages follow the
encoder's order: source, intra core (IDR; K4) or motion + P tail (P),
deblock, SAO (with `--sao`), compaction + pack, D2H copy, entropy
(unpack, densify, native CABAC and NAL framing; host only). P frames
also carry the motion stage split into its steps ("motion_detail").
"""

from __future__ import annotations

import argparse
import json

import torch

from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.codec.h265.intra import chroma_qp
from ceracoder_tpu_torch.ops import h265 as ops
from ceracoder_tpu_torch.profile_h264 import STAT_KEYS, stage_total, time_stage


def _timer(st: dict):
    """A stage hook for ops.h265 that times each stage into st."""
    return lambda name, fn: time_stage(name, fn, st)


def _motion_detail(y, ref) -> dict:
    """The encoder's motion stage again, step by step (not part of the
    frame's total): padding, half-resolution planes, the 81-offset
    coarse search, the window canvas, the full-pel refine, the 16 qpel
    phases, the SATD sub-pel refine and the chroma MC."""
    st: dict = {}
    pads = time_stage("pad", lambda: ops._pad_ref(*ref), st)
    ops._p_motion(y, *pads, stage=_timer(st))
    return st


def profile_frames(width: int, height: int, p_frames: int,
                   sao: bool = False) -> list[dict]:
    n = 1 + p_frames
    src = DeviceTestPatternSource(width, height, texture=6)
    enc = H265DeviceEncoder(width, height, qp=30, gop=60, sao=sao)
    qp, qpc = 30, chroma_qp(30)
    n_ctb = (enc.ph // 16) * (enc.pw // 16)
    planes = enc._planes_fn(None, src, range(n))
    rows, ref = [], None
    for i in range(n):
        idr = i == 0
        st: dict = {}
        y, u, v = time_stage("source", lambda: planes(i), st)
        if not idr:
            detail = _motion_detail(y, ref)
        cap, chunk = ops.level_capacity(n_ctb, idr)
        out = ops.encode_frame_row(y, u, v, ref, idr, qp, qpc, cap, chunk,
                                   stage=_timer(st), sao=sao)
        ref = out["recon"]
        host = time_stage("d2h_copy", lambda: enc._rows_to_host([out])(), st)
        frame = time_stage("entropy", lambda: enc._make_run_pending(
            out, lambda: host, 0, idr, qp, i, cap, chunk).result(), st)
        rows.append({"frame": i, "type": "IDR" if idr else "P",
                     "bytes": len(frame.data), "stages": st,
                     "total": stage_total(st)})
        if not idr:
            rows[-1]["motion_detail"] = detail
    return rows


def mean_p(rows: list[dict]) -> dict:
    """The mean of the P frames' rows, stage by stage."""
    ps = [r for r in rows if r["type"] == "P"]
    def mean(key):
        return {name: {k: sum(r[key][name][k] for r in ps) / len(ps)
                       for k in STAT_KEYS} for name in ps[0][key]}

    stages = mean("stages")
    return {"frame": "mean", "type": f"P (mean of {len(ps)})",
            "bytes": sum(r["bytes"] for r in ps) / len(ps),
            "stages": stages, "total": stage_total(stages),
            "motion_detail": mean("motion_detail")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--p-frames", type=int, default=3)
    ap.add_argument("--sao", action="store_true",
                    help="encode with SAO (H265DeviceEncoder(sao=True))")
    args = ap.parse_args()
    print(f"device: {torch.cuda.get_device_name(0)}")
    # a first IDR + P pass loads the libraries and kernels; not reported
    profile_frames(args.width, args.height, 1, args.sao)
    rows = profile_frames(args.width, args.height, args.p_frames, args.sao)
    for row in rows + [mean_p(rows)]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
