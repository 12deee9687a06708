"""The control through the harness's own comparison: the reference in the
program's place comes out correct at its exact precision and not correct
in TF32, the control's."""

import pytest

from benchmark import harness
from benchmark.control import control_run
from benchmark.tests.conftest import small_cell


@pytest.mark.parametrize("mode, correct", [("exact", True), ("tf32", False)])
def test_control_is_judged_by_the_harness(mode, correct):
    cell = small_cell("hevc_1080p60.live")
    codec = harness.load_module("codecs", cell.config["codec"])
    run = control_run(cell, codec, 2**31 + 5, mode, workers=2)
    line = harness.result_line(cell, run, {"platform": "cpu"}, False)
    assert line["correct"] is correct, line["checks"]
    assert line["checks"]["frames_checked"]["value"] == 2
    if not correct:
        assert line["checks"]["bytes_differ"]["value"] >= 1
