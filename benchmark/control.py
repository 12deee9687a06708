"""The control of `correct`: the reference put in the program's place at a
lower precision, judged by the harness's own comparison.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--mode tf32] [--qp <n>]

For each seed it codes the first IDR and P frame of the cell's seeded
camera with the reference in the control's precision (see
benchmark/reference/hevc/precision.py), hands their bytes and
reconstructions to check.compare as the program's, at the cell's own size
and QP (or --qp), and prints the result's line that run.py would print
for them, with the numbers compared last on standard error. A sound
control comes out not correct. The benchmark's own runs never run it; it
needs no card (numpy on the host's cores).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_run(cell, codec, seed: int, mode: str, qp: int | None = None,
                workers: int | None = None):
    """A harness Run whose frames are the reference's in `mode`."""
    from benchmark.camera import Camera
    from benchmark.check import checks, compare
    from benchmark.harness import Run
    from benchmark.reference.hevc import precision

    cfg = cell.config
    if qp is None:
        if "qp" not in cell.traffic:
            raise ValueError(f"{cell.workload['name']}'s traffic states no "
                             f"QP (its rate control sets it): give one")
        qp = cell.traffic["qp"]
    qp = int(qp)
    cam = Camera(cfg["width"], cfg["height"], seed,
                 cell.traffic["camera"], "cpu")
    got_bytes, got_recon = {}, {}
    with codec.reference(cfg, qp, workers) as ref:
        precision.set_mode(mode)
        try:
            rec = None
            for i in (0, 1):
                planes = ref.pad(*(p.numpy() for p in cam.frame(i)))
                got_bytes[i], rec = ref.encode(planes, qp, ref=rec, poc=i)
                got_recon[i] = rec
        finally:
            precision.set_mode("exact")
    positions = [0, 1]
    got = compare(codec, cfg, cam, 2 * int(cfg["gop"]), qp, qp, 0,
                  positions, got_bytes, got_recon, workers)
    return Run(end_to_end={}, attempted=2, failed=0, memory_peak_bytes=0,
               checks=checks(0, got, positions))


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="tf32")
    ap.add_argument("--qp", type=int, default=None)
    args = ap.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    codec = harness.load_module("codecs", cell.config["codec"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        run = control_run(cell, codec, seed, args.mode, args.qp)
        line = harness.result_line(cell, run, {"platform": "cpu"}, False)
        line = {"workload": args.workload, "seed": seed, "mode": args.mode,
                "seconds": time.time() - t, **line}
        print(json.dumps(line), flush=True)
        print("\n".join(harness.check_lines(run)), file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
