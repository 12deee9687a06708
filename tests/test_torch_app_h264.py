"""The port's live encoder app on `codec = h264` jobs
(ceracoder_tpu_torch/app/main.py with the CABAC H264Encoder) against
the JAX package's CeracoderApp on the CPU: identical TS bytes and tick
logs for the host-source run loop with its scene cut under one scripted
clock and SRT trace, and the native libraries an H.264 job builds at
construction. The helpers, the frame size and the job files are
tests/test_torch_app.py's; the JAX app's H.264 executables are not
shared with that module's HEVC ones, so the two files run apart."""

import torch

from pathlib import Path

import ceracoder_tpu.app.main as j_main
import ceracoder_tpu_torch.app.main as t_main
from tests.test_torch_app import (  # noqa: F401  (jobs is a fixture)
    CUT,
    N_HOST,
    _builds_at_construction,
    _check_ts,
    jobs,
    run_app,
)

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)


def test_h264_job_matches_jax_under_scripted_clock(jobs, tmp_path,
                                                  monkeypatch):
    """`codec = h264`: the host-source run loop with its scene cut under
    the scripted clock and SRT trace, coded with CABAC and intra-in-P.
    The JAX app runs its H.264 encoder on the dense host path, whose
    bytes its suite holds equal to the fused run's and whose CPU
    compile is far cheaper."""
    import functools

    from ceracoder_tpu.codec.h264.encoder import H264Encoder as JH264

    job = tmp_path / "h264.ini"
    job.write_text(Path(jobs["host"]).read_text().replace("hevc", "h264"))
    monkeypatch.setattr(j_main, "H264Encoder",
                        functools.partial(JH264, device_entropy=False))
    data, ticks, keys = run_app(t_main, str(job), tmp_path / "port.ts",
                                N_HOST, control=True)
    want, want_ticks, want_keys = run_app(j_main, str(job),
                                          tmp_path / "jax.ts", N_HOST,
                                          control=True)
    assert ticks == want_ticks and len(ticks) >= N_HOST - 1
    assert keys == want_keys
    assert [i for i, k in enumerate(keys) if k] == [0, CUT]
    assert data == want
    _check_ts(data)
    assert b"\x00\x00\x00\x01\x67\x4d" in data    # Main-profile SPS


def test_h264_native_builds_happen_before_run(jobs, monkeypatch, tmp_path):
    """An H.264 job builds the CABAC row coder at construction instead
    of the HEVC entropy library."""
    import ceracoder_tpu_torch.audio as audio

    text = Path(jobs["per_frame"]).read_text().replace("hevc", "h264")
    built, app = _builds_at_construction(text, monkeypatch, tmp_path)
    want = {"h264_cabac", "balancer"}
    if audio.aac_available():
        want.add("audio_enc")
    assert built == want
    assert app.video_stream_type == 0x1B
