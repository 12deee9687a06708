"""Stage breakdown of the H.264 CAVLC slice on the GPU.

    python3 -m ceracoder_tpu_torch.profile_h264 [--width 1920]
        [--height 1088] [--p-frames 3]

Encodes one IDR and `--p-frames` P frames of the device test pattern
(texture 6, qp 28) stage by stage, with a `torch.cuda.synchronize()`
around each stage, and prints one JSON line per frame: host-clock
milliseconds, CUDA kernel launches and device kernel milliseconds
(torch.profiler) per stage. Stages follow the encoder's order: source,
intra or inter, deblock, slot assembly, packing (finalize + pack_rows
with K1 + compact), host copy.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
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


def profile_frames(width: int, height: int, p_frames: int) -> list[dict]:
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
    args = ap.parse_args()
    print(f"device: {torch.cuda.get_device_name(0)}")
    for row in profile_frames(args.width, args.height, args.p_frames):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
