"""Stage breakdown of the HEVC run path on the GPU.

    python3 -m ceracoder_tpu_torch.profile_hevc [--width 1920]
        [--height 1088] [--p-frames 4] [--sao] [--tu-split] [--bframes]

After an unreported warm-up, encodes one IDR and `--p-frames` more
frames of the device test pattern with `H265DeviceEncoder(1920, 1088,
qp=30, gop=60)` (texture 6; deblocking, tile rows, native entropy; with
`--sao` also SAO, with `--tu-split` the inter TU split, with
`--bframes` IBPBP: the frames after the IDR as (B, P) display pairs,
each P coded first, two POCs back, then its B between the two
references), as one run of the encoder's (`encode_run_async`, or
`encode_run_b_async` with `--bframes`) whose frame hook (ops/h265.py:
run_frame) gives each frame a stage hook that wraps each stage in
`torch.cuda.synchronize()`, and prints one JSON line per frame in
coding order, then one with the mean of the P frames (and of the B
frames): host-clock milliseconds, CUDA kernel launches and device
kernel milliseconds (torch.profiler) per stage, and the device's idle
share of the frame (1 - device ms / host ms). Stages follow the
encoder's order: source, intra core (IDR; K4), motion + P tail (P) or
motion + B tail (B: both searches and the bi-prediction combine),
deblock, SAO (with `--sao`), compaction + pack, D2H copy, entropy
(unpack, densify, native CABAC and NAL framing; host only). P and B
frames also carry the motion stage split into its steps
("motion_detail"; a B frame's list-1 steps end in "_l1").
"""

from __future__ import annotations

import argparse
import json

import torch

from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.ops import h265 as ops
from ceracoder_tpu_torch.profile_h264 import STAT_KEYS, stage_total, time_stage


def _timer(st: dict):
    """A stage hook for ops.h265 that times each stage into st; a name
    met a second time (a B frame's list-1 search) gets "_l1"."""
    return lambda name, fn: time_stage(
        name + "_l1" if name in st else name, fn, st)


def _motion_detail(y, ref, fut=None) -> dict:
    """The encoder's motion stage again, step by step (not part of the
    frame's total): padding, half-resolution planes, the 81-offset
    coarse search, the window canvas, the full-pel refine, the 16 qpel
    phases, the SATD sub-pel refine and the chroma MC; for a B frame
    (future reference `fut`) those of both lists and the combine."""
    st: dict = {}
    pads = time_stage("pad", lambda: ops._pad_ref(*ref), st)
    if fut is None:
        ops._p_motion(y, *pads, stage=_timer(st))
    else:
        fpads = time_stage("pad_l1", lambda: ops._pad_ref(*fut), st)
        ops._b_motion(y, pads, fpads, stage=_timer(st))
    return st


def profile_frames(width: int, height: int, p_frames: int,
                   sao: bool = False, tu_split: bool = False,
                   bframes: bool = False) -> list[dict]:
    n = 1 + p_frames
    src = DeviceTestPatternSource(width, height, texture=6)
    enc = H265DeviceEncoder(width, height, qp=30, gop=60, sao=sao,
                            tu_split=tu_split, bframes=int(bframes))
    rows = []

    def frame(kind, run, refs):
        # the run's frame hook (ops/h265.py: run_frame): each stage of
        # the frame timed, its motion stage again step by step, and the
        # copy of its transfer row
        st: dict = {}
        planes = []

        def stage(name, fn):
            res = _timer(st)(name, fn)
            if name == "source":
                planes.append(res)
            return res
        out = run(stage)
        time_stage("d2h_copy", lambda: enc._rows_to_host([out])(), st)
        rows.append({"type": "IDR" if kind == "I" else kind, "stages": st})
        if refs:
            rows[-1]["motion_detail"] = _motion_detail(planes[0][0], *refs)
        return out

    if bframes:
        coded = enc.encode_run_b_async(source=src, indices=range(n),
                                       frame_hook=frame)
    else:
        coded = [(pf, i, None) for i, pf in enumerate(enc.encode_run_async(
            source=src, indices=range(n), frame_hook=frame))]
    for row, (pf, poc, _) in zip(rows, coded):
        fr = time_stage("entropy", pf.result, row["stages"])
        row.update(frame=poc, bytes=len(fr.data),
                   total=stage_total(row["stages"]))
    return rows


def mean_of(rows: list[dict], kind: str) -> dict:
    """The mean of the rows of one frame type ("P" or "B"), stage by
    stage."""
    ps = [r for r in rows if r["type"] == kind]
    def mean(key):
        return {name: {k: sum(r[key][name][k] for r in ps) / len(ps)
                       for k in STAT_KEYS} for name in ps[0][key]}

    stages = mean("stages")
    return {"frame": "mean", "type": f"{kind} (mean of {len(ps)})",
            "bytes": sum(r["bytes"] for r in ps) / len(ps),
            "stages": stages, "total": stage_total(stages),
            "motion_detail": mean("motion_detail")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--p-frames", type=int, default=4,
                    help="frames after the IDR (with --bframes, an even "
                    "number: the pairs' P and B frames)")
    ap.add_argument("--sao", action="store_true",
                    help="encode with SAO (H265DeviceEncoder(sao=True))")
    ap.add_argument("--tu-split", action="store_true",
                    help="with the inter TU split (tu_split=True)")
    ap.add_argument("--bframes", action="store_true",
                    help="IBPBP (bframes=1)")
    args = ap.parse_args()
    if args.bframes and (args.p_frames % 2 or not args.p_frames):
        ap.error("--bframes needs an even, nonzero --p-frames")
    print(f"device: {torch.cuda.get_device_name(0)}")
    opts = dict(sao=args.sao, tu_split=args.tu_split, bframes=args.bframes)
    # a first pass loads the libraries and kernels; not reported
    profile_frames(args.width, args.height, 2, **opts)
    rows = profile_frames(args.width, args.height, args.p_frames, **opts)
    kinds = ("P", "B") if args.bframes else ("P",)
    for row in rows + [mean_of(rows, k) for k in kinds]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
