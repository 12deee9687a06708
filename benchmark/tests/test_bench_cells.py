"""Rehearsals of the cells on the CPU at 320x192: the whole run less the
look for a card. A sound run is correct; each fault that a cell can
have, planted under the timed path, makes `correct` false."""

import pytest

import ceracoder_tpu_torch.codec.h265.device as dev
from benchmark import harness
from benchmark.tests.conftest import rehearse, small_cell

# the program's own functions, before any test patches them
RUN_ROWS = dev.encode_run_rows
ASYNC = dev.H265DeviceEncoder.encode_run_async
ENTROPY = dev.entropy_rows_native

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]
# one cell of each loop, for the traced rehearsal and the faults
KINDS = ["hevc_1080p60.live", "hevc_1080p60.app"]


def _rehearse(workload: str, trace: bool = False):
    """The cell at 320x192: the app's camera at 4 frames/s, which the CPU
    keeps up with, for long enough to hold a whole GOP of 20."""
    cell = small_cell(workload)
    seconds = 1.5
    if cell.traffic["kind"] == "camera_app":
        cell.traffic.update(fps=4, tail=11)
        seconds = 5.5
    return cell, *rehearse(cell, seconds=seconds, trace=trace)


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct(workload):
    cell, line, run = _rehearse(workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 10
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("workload, span_metric", [
    ("hevc_1080p60.live", "launch_ms_per_frame"),
    ("hevc_1080p60.app", "run_wait_ms.app")])
def test_traced_rehearsal_reads_spans(workload, span_metric):
    cell, line, run = _rehearse(workload, trace=True)
    assert line["correct"]
    assert span_metric in line["metrics"]
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "breakdown" in line and line["device"]["window_s"] > 0


def _frozen_state(planes, idr_flags, qps, qpcs, ref, *args, **kw):
    """encode_run_rows with the carried reference never updated: every
    frame of a run predicts from the reference the run started with."""
    outs = []
    for f in range(len(idr_flags)):
        outs += RUN_ROWS(lambda _, f=f: planes(f), idr_flags[f:f + 1],
                         qps[f:f + 1], qpcs[f:f + 1], ref,
                         *[a[f:f + 1] for a in args[:2]], **kw)
    return outs


def _half_runs(self, *args, **kwargs):
    pend = ASYNC(self, *args, **kwargs)
    return pend[:len(pend) // 2]


def _altered(*args, **kwargs):
    rbsps = ENTROPY(*args, **kwargs)
    last = bytearray(rbsps[-1])
    last[len(last) // 2] ^= 0x10
    return rbsps[:-1] + [bytes(last)]


@pytest.mark.parametrize("workload", KINDS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "token_altered"])
def test_fault_is_not_correct(fault, workload, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(dev, "encode_run_rows", _frozen_state)
    elif fault == "half_left_out":
        monkeypatch.setattr(dev.H265DeviceEncoder, "encode_run_async",
                            _half_runs)
    else:
        monkeypatch.setattr(dev, "entropy_rows_native", _altered)
    _, line, _ = _rehearse(workload)
    assert line["correct"] is False, line["checks"]
