"""The port's supervisor bindings (ceracoder_tpu_torch/bindings) against
the JAX package's, case for case with tests/test_bindings.py: the argv,
the job-spec text and its validation, the resolution map and the run
artifacts (config INI and argv) are equal; the process helpers drive a
real child; and every way of resolving the executable launches the
port's app, never the JAX one."""

import os
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import ceracoder_tpu.bindings as jb
import ceracoder_tpu.bindings.constants as jconst
import ceracoder_tpu_torch.bindings as tb
import ceracoder_tpu_torch.bindings.constants as tconst
import ceracoder_tpu_torch.bindings.process as tproc
from ceracoder_tpu.app.jobspec import parse_jobspec as j_parse_jobspec
from ceracoder_tpu.bindings.cli import RunOptions as JRunOptions
from ceracoder_tpu.bindings.jobs import JobRequest as JJobRequest
from ceracoder_tpu.bindings.jobs import JobValidationError as JJobError
from ceracoder_tpu.bindings.run import RunValidationError as JRunError
from ceracoder_tpu_torch.app.jobspec import parse_jobspec
from ceracoder_tpu_torch.bindings.cli import RunOptions
from ceracoder_tpu_torch.bindings.jobs import JobRequest, JobValidationError
from ceracoder_tpu_torch.bindings.run import RunValidationError

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JOBS = sorted((ROOT / "jobs").iterdir())

RUN_OPTIONS = [
    dict(job_file="job.ini", addr="host", port=5000),
    dict(job_file="j", addr="h", port=1, config_path="c.conf", av_delay=-100,
         stream_id="sid", latency=1500, reduced_pkt_size=True,
         balancer="aimd"),
    dict(job_file="j", addr="udp", port=9000, av_delay=0, stream_id="",
         latency=None, balancer="fixed"),
    dict(job_file="/a/b.ini", addr="out.ts", port=0, latency=2000,
         reduced_pkt_size=True),
]


@pytest.mark.parametrize("kw", RUN_OPTIONS)
def test_build_args_equal_to_jax(kw):
    assert tb.build_args(RunOptions(**kw)) == jb.build_args(JRunOptions(**kw))


def test_build_args_minimal_and_full():
    assert tb.build_args(RunOptions("job.ini", "host", 5000)) == [
        "job.ini", "host", "5000", "-c", "/tmp/ceracoder.conf"]
    assert tb.build_args(RunOptions(**RUN_OPTIONS[1])) == [
        "j", "h", "1", "-c", "c.conf", "-d", "-100", "-s", "sid", "-l",
        "1500", "-r", "-a", "aimd"]


JOB_REQUESTS = [
    dict(resolution="1080p", fps=60),
    dict(fps=30, gop=30),
    dict(source="test", resolution="1080p", fps=30, codec="hevc"),
    dict(source="y4m", path="clip.y4m", resolution="480p", fps=25),
    dict(source="raw", path="/x.yuv", resolution="4k", fps=60, codec="hevc",
         extra={"run": 10, "overlay": "off"}),
    dict(resolution="540p", fps=240),
    dict(resolution="1440p", fps=1, codec="hevc", gop=7),
]


@pytest.mark.parametrize("kw", JOB_REQUESTS)
def test_job_builder_text_equal_to_jax(kw, tmp_path):
    text = tb.JobBuilder().build(JobRequest(**kw))
    assert text == jb.JobBuilder().build(JJobRequest(**kw))
    # the text is a job the port's app reads as the request says
    job = tmp_path / "job.ini"
    tproc.write_jobspec(job, text)
    spec = parse_jobspec(job)
    req = JobRequest(**kw)
    assert (spec.width, spec.height) == tb.RESOLUTIONS[req.resolution]
    assert (spec.kind, spec.codec, spec.fps_num) == (req.source, req.codec,
                                                     req.fps)
    assert spec.gop_frames == (req.gop or 2 * req.fps)


def test_job_builder_structure():
    text = tb.JobBuilder().build(JobRequest(resolution="1080p", fps=60))
    assert "[source]" in text and "[encode]" in text
    assert "width = 1920" in text and "height = 1080" in text
    assert "gop = 120" in text  # 2 s at 60 fps


BAD_JOBS = [
    dict(source="v4l2"),
    dict(resolution="123p"),
    dict(codec="av1"),
    dict(source="y4m"),          # path required
    dict(fps=0),
    dict(fps=241),
]


@pytest.mark.parametrize("kw", BAD_JOBS)
def test_job_builder_validation(kw):
    with pytest.raises(JobValidationError) as port:
        tb.JobBuilder().build(JobRequest(**kw))
    with pytest.raises(JJobError) as ref:
        jb.JobBuilder().build(JJobRequest(**kw))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("token", ["[source]", "[encode]", "kind =",
                                   "codec ="])
def test_job_validate_requires_each_section(token):
    text = jb.JobBuilder().build(JJobRequest()).replace(token, "")
    with pytest.raises(JobValidationError, match="missing"):
        tb.JobBuilder.validate(text)
    with pytest.raises(JJobError, match="missing"):
        jb.JobBuilder.validate(text)


def test_resolutions_and_constants_equal_to_jax():
    assert tb.RESOLUTIONS == jb.RESOLUTIONS
    assert tb.RESOLUTIONS["720p"] == (1280, 720)
    assert tb.RESOLUTIONS["4k"] == (3840, 2160)
    names = [n for n in dir(jconst) if n.isupper()]
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        if n != "DEFAULT_EXECUTABLE":
            assert getattr(tconst, n) == getattr(jconst, n), n
    # the one difference: the installed executable is the port's app
    assert tconst.DEFAULT_EXECUTABLE == "/usr/bin/ceracoder-tpu-torch"
    assert tb.__all__ == jb.__all__


OVERRIDES = [
    {"max_bitrate": 7000, "aimd.decr_mult": 0.6},
    {"balancer": "aimd", "min_bitrate": 500},
    {"adaptive.incr_step": 45, "srt_latency": 900},
    {},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_run_artifacts_equal_to_jax(tmp_path, overrides):
    cfgp = tmp_path / "c.conf"
    tb.write_config(cfgp, "[general]\nmin_bitrate = 800\n"
                          "max_bitrate = 5000\nbalancer = adaptive\n")
    kw = dict(job_file="job.ini", addr="host", port=9000,
              config_path=str(cfgp), latency=1200, balancer="fixed")
    port = tb.build_run_artifacts(RunOptions(**kw), overrides=overrides)
    ref = jb.build_run_artifacts(JRunOptions(**kw), overrides=overrides)
    assert port.ini == ref.ini
    assert port.args == ref.args
    assert port.config.min_bitrate == ref.config.min_bitrate
    assert port.config.max_bitrate == ref.config.max_bitrate
    assert port.config.balancer == ref.config.balancer
    assert vars(port.config.adaptive) == vars(ref.config.adaptive)
    assert vars(port.config.aimd) == vars(ref.config.aimd)


def test_run_artifacts_merge_and_validate(tmp_path):
    cfgp = tmp_path / "c.conf"
    tb.write_config(cfgp, "[general]\nmin_bitrate = 800\nmax_bitrate = 5000\n")
    opts = RunOptions("job.ini", "host", 9000, config_path=str(cfgp))
    art = tb.build_run_artifacts(opts, overrides={"max_bitrate": 7000,
                                                  "aimd.decr_mult": 0.6})
    assert art.config.min_bitrate == 800       # from file
    assert art.config.max_bitrate == 7000      # override wins
    assert art.config.aimd.decr_mult == 0.6
    assert "max_bitrate = 7000" in art.ini
    assert art.args[0] == "job.ini"


@pytest.mark.parametrize("overrides", [
    {"min_bitrate": 1},                 # below abs min
    {"max_bitrate": 99999},             # above abs max
    {"min_bitrate": 5000, "max_bitrate": 1000},
    {"balancer": "bogus"},
    {"nonsense": 1},
    {"srt_latency": 50},
])
def test_run_artifacts_rejects_invalid(tmp_path, overrides):
    path = str(tmp_path / "none.conf")
    with pytest.raises(RunValidationError) as port:
        tb.build_run_artifacts(RunOptions("j", "h", 1, config_path=path),
                               overrides=overrides)
    with pytest.raises(JRunError) as ref:
        jb.build_run_artifacts(JRunOptions("j", "h", 1, config_path=path),
                               overrides=overrides)
    assert str(port.value) == str(ref.value)


def _fake_exe(path: Path) -> Path:
    path.write_text("#!/bin/sh\nexit 0\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return path


def test_find_executable_resolves_the_port(tmp_path, monkeypatch):
    """Explicit path > `ceracoder-tpu-torch` on PATH > the default
    install path > `python -m ceracoder_tpu_torch`; a JAX executable
    on PATH or at the JAX install path is never taken."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _fake_exe(bin_dir / "ceracoder-tpu")
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(tproc, "DEFAULT_EXECUTABLE",
                        str(tmp_path / "missing" / "ceracoder-tpu-torch"))
    assert tb.find_executable() == [sys.executable, "-m",
                                    "ceracoder_tpu_torch"]
    assert tb.find_executable("/opt/x") == ["/opt/x"]
    default = _fake_exe(tmp_path / "ceracoder-tpu")
    monkeypatch.setattr(tproc, "DEFAULT_EXECUTABLE",
                        str(tmp_path / "ceracoder-tpu-torch"))
    assert tb.find_executable()[-1] == "ceracoder_tpu_torch"
    default = _fake_exe(tmp_path / "ceracoder-tpu-torch")
    assert tb.find_executable() == [str(default)]
    port = _fake_exe(bin_dir / "ceracoder-tpu-torch")
    assert tb.find_executable() == [str(port)]
    for argv in (tb.find_executable(), tproc.find_executable()):
        assert "ceracoder_tpu" not in argv
        assert not any(Path(a).name == "ceracoder-tpu" for a in argv)


def test_spawn_starts_the_port_app():
    """The fallback argv runs this package's app: its `-v` names it."""
    proc = tb.spawn(["-v"], cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert out.split() == ["ceracoder-tpu-torch", "0.1.0"]
    assert proc.args[-3:] == ["-m", "ceracoder_tpu_torch", "-v"]


def test_process_lifecycle():
    """spawn/is_running/send_hup/send_term against a real child process
    (a stand-in sleeper, to keep the test hermetic and fast)."""
    proc = tb.spawn(
        ["-u", "-c",
         "import signal, time;"
         "signal.signal(signal.SIGHUP, lambda *a: print('hup', flush=True));"
         "print('ready', flush=True);"
         "time.sleep(30)"],
        executable=sys.executable, stdout=subprocess.PIPE)
    try:
        assert proc.stdout.readline().strip() == b"ready"
        assert tb.is_running(proc)
        assert tb.send_hup(proc)
        assert proc.stdout.readline().strip() == b"hup"
        assert tb.is_running(proc)       # HUP did not kill it
        assert tb.send_term(proc)
        assert not tb.is_running(proc)
        assert proc.returncode == -15
        assert not tb.send_hup(proc)     # nothing to signal
        assert tb.send_term(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


def test_send_term_reports_a_child_that_does_not_stop():
    proc = tb.spawn(
        ["-u", "-c",
         "import signal, time;"
         "signal.signal(signal.SIGTERM, signal.SIG_IGN);"
         "print('ready', flush=True);"
         "time.sleep(30)"],
        executable=sys.executable, stdout=subprocess.PIPE)
    try:
        assert proc.stdout.readline().strip() == b"ready"
        t = time.perf_counter()
        assert not tb.send_term(proc, wait_s=0.3)
        assert time.perf_counter() - t < 5
        assert tb.is_running(proc)
    finally:
        proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()


def test_write_helpers_make_parent_dirs(tmp_path):
    cfg = tmp_path / "a" / "b" / "c.conf"
    job = tmp_path / "d" / "job.ini"
    tb.write_config(cfg, "[general]\n")
    tb.write_jobspec(job, "[source]\n")
    assert cfg.read_text() == "[general]\n"
    assert job.read_text() == "[source]\n"
    assert os.path.isdir(tmp_path / "a" / "b")


@pytest.mark.parametrize("path", JOBS, ids=[p.name for p in JOBS])
def test_job_corpus_parses_as_jax(path):
    """Each file of the jobs/ template corpus parses through the port's
    jobspec loader to the JAX loader's spec, with the fields its name
    states (the reference's pipeline/ directory, README.md:236-244)."""
    spec = parse_jobspec(str(path))
    assert vars(spec) == vars(j_parse_jobspec(str(path)))
    if path.name == "audio_only":
        return
    codec, src, point = path.name.split("_")
    assert (spec.codec, spec.kind) == (codec, src)
    res = point.rstrip("0123456789")
    fps = int(point[len(res):])
    assert (spec.width, spec.height) == tb.RESOLUTIONS[res]
    assert spec.fps_num == fps
    # GOP policy: 2 s of frames (reference common.ts:104-107)
    assert spec.gop_frames == 2 * fps


def test_job_corpus_size():
    assert len(JOBS) >= 60
