"""One run of each cell as run.py runs it, on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(workload, cuda_card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
