"""The `[parallel]` knobs in the port's app (counterpart of
tests/test_app_parallel.py): with the app's device list patched to four
CPU entries, `bands` routes through ShardedH265Encoder and
`gop_parallel` through GopParallelStreamEncoder; both streams equal the
single-device app's, and the oracle (tools/decode_oracle) decodes
them. 96x64, 8 frames, the host test pattern."""

import re
import subprocess
from pathlib import Path

import pytest
import torch

import ceracoder_tpu_torch.app.main as t_main
from ceracoder_tpu_torch.app.cli import CliOptions
from ceracoder_tpu_torch.parallel.hevc import (
    GopParallelStreamEncoder,
    ShardedH265Encoder,
)

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parents[1] / "tools" / "decode_oracle"


@pytest.fixture(autouse=True)
def four_devices(monkeypatch):
    monkeypatch.setattr(t_main, "_app_devices",
                        lambda device: [torch.device("cpu")] * 4)


def _write_job(tmp_path, extra: str, run=4, name="job.ini") -> str:
    job = tmp_path / name
    job.write_text("[source]\nkind = test\nwidth = 96\nheight = 64\n"
                   f"fps = 30\n\n[encode]\ncodec = hevc\ngop = 4\n"
                   f"run = {run}\n\n[audio]\nkind = none\n" + extra)
    return str(job)


def _app(tmp_path, job, name):
    out = tmp_path / name
    opts = CliOptions(job_file=job, addr=str(out), port=0)
    return t_main.CeracoderApp(opts, max_frames=8, realtime=False,
                               device="cpu"), out


def _run(app, out) -> bytes:
    assert app.run() == 0
    assert app.frames_sent == 8
    return out.read_bytes()


def _oracle_frames(ts_path) -> int:
    r = subprocess.run([str(ORACLE), str(ts_path), str(ts_path) + ".yuv",
                        "hevc"], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return int(re.search(r"frames=(\d+)", r.stderr).group(1))


@pytest.fixture(scope="module")
def single_run1(tmp_path_factory):
    """The single-device app's stream at run = 1 (the per-frame loop)."""
    tmp = tmp_path_factory.mktemp("single")
    return _run(*_app(tmp, _write_job(tmp, "", run=1), "single.ts"))


@pytest.mark.parametrize("bands", [2, 4])
def test_bands_knob_routes_sharded_and_decodes(tmp_path, single_run1,
                                               bands):
    """4 CTB rows in 2 or 4 bands: the banded encoder has no run path,
    so the app takes the per-frame loop, whose stream is the
    single-device app's at run = 1."""
    job = _write_job(tmp_path, f"\n[parallel]\nbands = {bands}\n")
    app, out = _app(tmp_path, job, "banded.ts")
    assert isinstance(app.encoder, ShardedH265Encoder)
    assert _run(app, out) == single_run1
    assert app.encoder.frames_launched == 8
    assert _oracle_frames(out) == 8


def test_gop_parallel_knob_matches_single_device(tmp_path):
    """gop_parallel = 2: closed GOPs of 4 alternating over two devices;
    run == gop == 4, so the single-device app's runs line up with
    them."""
    app, out = _app(tmp_path,
                    _write_job(tmp_path, "\n[parallel]\ngop_parallel = 2\n"),
                    "gop.ts")
    assert isinstance(app.encoder, GopParallelStreamEncoder)
    got = _run(app, out)
    assert [e.frames_launched for e in app.encoder.encoders] == [4, 4]
    single, s_out = _app(tmp_path, _write_job(tmp_path, "", name="js.ini"),
                         "single.ts")
    assert _run(single, s_out) == got
    assert _oracle_frames(out) == 8
