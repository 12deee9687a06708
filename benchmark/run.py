"""Run one cell of the benchmark once and print its result's line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix and metrics come from BENCHMARK.json
and the files it names (benchmark/harness.py). With --trace 0 the line
holds the cell's end-to-end metrics; with --trace 1 its per-layer metrics,
read from a traced run. The last line on standard output is the result's
JSON object; the last lines on standard error are the numbers that decide
`correct`, each with its limit. Exits non-zero, with no result, where
CUDA or the cards the cell asks for are missing, where the program fails,
or where a banned module (JAX or the JAX package) was loaded.

Only the standard library is imported at the top: the reference's worker
processes start from this file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness
    t_start = harness.process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell.load(args.workload)
    harness.set_cache_dirs()
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)           # one process, few threads: steady runs
    device = torch.device("cuda", 0)
    codec = harness.load_module("codecs", cell.config["codec"])
    loop = harness.load_module("loops", cell.traffic["kind"])
    run = loop.run(cell, codec, args.seed, args.seconds, bool(args.trace),
                   t_start, device)
    bad = harness.banned_modules()
    if bad:
        print(f"banned modules loaded: {bad}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = harness.result_line(cell, run, info, bool(args.trace))
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(harness.check_lines(run)) + "\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
