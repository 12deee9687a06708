"""The benchmark's own tests (CPU, small sizes; `cuda`-marked ones need
the card and skip without it):

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import pytest
import torch

from benchmark import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def small_cell(workload: str, width: int = 320, height: int = 192,
               gop: int = 20, run: int = 5) -> harness.Cell:
    """A cell of BENCHMARK.json at a size the CPU runs in seconds: the
    same files, with the picture, the GOP and the run cut, one run in
    flight and every P frame from the program's state a run start or
    drawn from the seed."""
    cell = harness.Cell.load(workload)
    cell.config.update(width=width, height=height, gop=gop)
    cell.traffic.update(run=run, depth_area=width * height,
                        check_area=3 * width * height, trace_seconds=1.0)
    return cell


def rehearse(cell: harness.Cell, seed: int = 2**31 + 11,
             seconds: float = 1.5, trace: bool = False):
    """Drive the cell's loop on the CPU as run.py drives it on the card,
    less the look for a card; returns (result line, Run)."""
    torch.set_num_threads(1)
    codec = harness.load_module("codecs", cell.config["codec"])
    loop = harness.load_module("loops", cell.traffic["kind"])
    run = loop.run(cell, codec, seed, seconds, trace, 0.0,
                   torch.device("cpu"), workers=2)
    return harness.result_line(cell, run, {"platform": "cpu"}, trace), run
