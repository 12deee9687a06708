"""The port's live encoder app (ceracoder_tpu_torch/app/main.py, HEVC)
against the JAX package's CeracoderApp on the CPU: identical TS bytes
for the host-source run loop (with a scene cut that opens an IDR), the
per-frame loop with PTS fixup, and the 20 ms control loop under one
scripted clock and one scripted SRT trace, whose tick logs must match
too. Also the per-frame encoder entry points, the oracle decode of the
port's stream, the errors the port raises where the JAX app has paths
it lacks, and the stall watchdog. The device-source run loop is
tests/test_torch_app_devtest.py.

One frame size (96x64) and one run length (4) for the run loop, and
each JAX reference run once per module: the JAX run executables compile
slowly on the CPU."""

import itertools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ceracoder_tpu.app.main as j_main
import ceracoder_tpu_torch.app.main as t_main
from ceracoder_tpu.app.cli import CliOptions as JOptions
from ceracoder_tpu.app.source import JitteryCaptureSource as JJittery
from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEncoder
from ceracoder_tpu_torch.app.cli import CliOptions as TOptions
from ceracoder_tpu_torch.app.source import (
    JitteryCaptureSource,
    TestPatternSource,
)
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

ROOT = Path(__file__).resolve().parents[1]
ORACLE = ROOT / "tools" / "decode_oracle"
W, H = 96, 64
N_HOST = 12         # host-source run loop: cut at frame 6
CUT = 6
N_PF = 10


def _write_cut_y4m(path: Path) -> None:
    """A slow pan over a smooth texture that cuts hard to another one
    at frame CUT."""
    rng = np.random.default_rng(12)

    def texture(lo, hi):
        t = rng.integers(lo, hi, (H // 8, W // 8 + 2)).astype(np.uint8)
        return np.kron(t, np.ones((8, 8), np.uint8))

    scenes = (texture(60, 110), texture(160, 210))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420\n".encode())
        for i in range(N_HOST):
            y = scenes[i >= CUT][:, i:i + W]
            uv = np.full((H // 2, W // 2), 100 + 40 * (i >= CUT), np.uint8)
            f.write(b"FRAME\n" + y.tobytes() + uv.tobytes() + uv.tobytes())


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jobs")
    _write_cut_y4m(d / "cut.y4m")
    encode = "\n[encode]\ncodec = hevc\ngop = 8\nrun = {run}\n"
    specs = {
        "host": (f"[source]\nkind = y4m\npath = {d / 'cut.y4m'}\n"
                 "loop = 0\n" + encode.format(run=4)),
        "per_frame": (f"[source]\nkind = y4m\npath = {d / 'cut.y4m'}\n"
                      "loop = 0\n" + encode.format(run=1)),
    }
    out = {"dir": d}
    for name, text in specs.items():
        (d / f"{name}.ini").write_text(text)
        out[name] = str(d / f"{name}.ini")
    return out


def scripted_clock(step_ms: int):
    """getms for both apps: advances `step_ms` per call."""
    ticks = itertools.count(10_000, step_ms)
    return lambda: next(ticks)


def scripted_link():
    """Transport.stats for both apps: an SRT link whose RTT ramps up,
    whose send buffer grows and then drains, with loss and
    retransmissions in the middle; ACKs advance on every read."""
    reads = itertools.count()

    def stats(_transport):
        i = next(reads)
        rtt = 40.0 + 60.0 * min(i, 12) - 50.0 * max(0, i - 16)
        bs = 5 + 40 * min(i, 10) - 30 * max(0, i - 14)
        lossy = 8 <= i < 16
        return SimpleNamespace(
            ms_rtt=max(rtt, 30.0), mbps_send_rate=4.0 - 0.2 * min(i, 10),
            pkt_snd_loss_total=3 * max(0, min(i, 16) - 8) if lossy else 0,
            pkt_retrans_total=5 * max(0, min(i, 16) - 8),
            pkt_recv_ack_total=i + 1), max(bs, 0)
    return stats


def run_app(mod, job: str, out: Path, max_frames: int, wrap=None,
            control: bool = False):
    """Run one package's CeracoderApp on `job` into `out` (file output,
    realtime off); `wrap` replaces the source; `control` patches the
    scripted clock and SRT trace into that package's app module.
    Returns (TS bytes, tick logs, keyframe flags of the frames sent)."""
    port = mod is t_main
    opts = (TOptions if port else JOptions)(job_file=job, addr=str(out),
                                            port=0)
    kw = {"device": "cpu"} if port else {}
    with pytest.MonkeyPatch.context() as mp:
        if control:
            mp.setattr(mod, "getms", scripted_clock(120))
            mp.setattr(mod.Transport, "stats", scripted_link())
        app = mod.CeracoderApp(opts, keep_ticks=control,
                               max_frames=max_frames, realtime=False, **kw)
        if wrap is not None:
            app.source = wrap(app.source)
        keys = []
        emit = app._emit_frame

        def spy(frame, *a):
            keys.append(frame.keyframe)
            emit(frame, *a)
        mp.setattr(app, "_emit_frame", spy)
        assert app.run() == 0
    assert app.frames_sent == max_frames
    return out.read_bytes(), app.state.ticks, keys


def _jitter(cls):
    return lambda src: cls(src, jitter90=400, dup_every=4,
                           backstep_every=7, seed=3)


@pytest.fixture(scope="module")
def jax_ref(jobs):
    """The JAX app's outputs, each run once per module."""
    d, cache = jobs["dir"], {}

    def get(case):
        if case not in cache:
            if case == "host":
                args = (jobs["host"], N_HOST)
                kw = {}
            elif case == "control":
                args, kw = (jobs["host"], N_HOST), {"control": True}
            else:
                args, kw = (jobs["per_frame"], N_PF), {"wrap":
                                                       _jitter(JJittery)}
            cache[case] = run_app(j_main, args[0], d / f"jax_{case}.ts",
                                  args[1], **kw)
        return cache[case]
    return get


def _check_ts(data: bytes) -> None:
    assert data and len(data) % 188 == 0
    assert data[::188] == b"\x47" * (len(data) // 188)


def test_host_run_loop_matches_jax_with_scene_cut(jobs, jax_ref):
    out = jobs["dir"] / "port_host.ts"
    data, _, keys = run_app(t_main, jobs["host"], out, N_HOST)
    want, _, want_keys = jax_ref("host")
    assert data == want
    _check_ts(data)
    # the hard cut opens an IDR mid-GOP; nothing else is an IDR
    assert keys == want_keys
    assert [i for i, k in enumerate(keys) if k] == [0, CUT]


def test_per_frame_loop_with_pts_fixup_matches_jax(jobs, jax_ref):
    out = jobs["dir"] / "port_pf.ts"
    data, _, keys = run_app(t_main, jobs["per_frame"], out, N_PF,
                            wrap=_jitter(JitteryCaptureSource))
    want, _, want_keys = jax_ref("per_frame")
    assert data == want
    _check_ts(data)
    # frame 0 and the cut are the IDRs; the fixup drops the duplicated
    # frames the source repeats, not the frames around them
    assert keys == want_keys
    assert [i for i, k in enumerate(keys) if k] == [0, CUT]


def test_control_loop_matches_jax_under_scripted_clock(jobs, jax_ref):
    """The 20 ms tick under one scripted clock and SRT trace: the same
    balancer outputs, QPs and overlay burn-in, so the same tick logs
    and TS bytes."""
    out = jobs["dir"] / "port_control.ts"
    data, ticks, _ = run_app(t_main, jobs["host"], out, N_HOST,
                             control=True)
    want, want_ticks, _ = jax_ref("control")
    assert ticks == want_ticks
    assert len(ticks) >= N_HOST - 1
    assert len({t["bitrate"] for t in ticks}) > 2      # the loop moved
    assert len({t["qp"] for t in ticks}) > 1
    assert data == want
    assert data != jax_ref("host")[0]                  # overlay, QPs


@pytest.mark.skipif(not ORACLE.exists(), reason="tools/decode_oracle "
                    "not built")
def test_oracle_decodes_port_ts(jobs, jax_ref, tmp_path):
    out = jobs["dir"] / "port_host.ts"
    if not out.exists():
        run_app(t_main, jobs["host"], out, N_HOST)
    r = subprocess.run([str(ORACLE), str(out), str(tmp_path / "o.yuv")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert f"frames={N_HOST} width={W} height={H}" in r.stderr
    raw = np.fromfile(tmp_path / "o.yuv", np.uint8)
    assert raw.size == N_HOST * W * H * 3 // 2


def test_encode_frame_matches_jax():
    """The per-frame entry point: QP changes between frames and an IDR
    forced mid-GOP, the same bytes and reconstruction as JAX's."""
    frames = list(TestPatternSource(W, H, num_frames=6).frames())
    qps = [30, 33, 33, 27, 31, 31]
    port = H265DeviceEncoder(W, H, qp=30, gop=8, device="cpu")
    ref = JEncoder(W, H, qp=30, gop=8)
    keys = []
    for i, ((y, u, v), qp) in enumerate(zip(frames, qps)):
        got = port.encode_frame(y, u, v, qp=qp, force_idr=i == 3)
        want = ref.encode_frame(y, u, v, qp=qp, force_idr=i == 3)
        assert got.data == want.data, i
        assert (got.keyframe, got.qp) == (want.keyframe, want.qp)
        keys.append(got.keyframe)
    assert keys == [True, False, False, True, False, False]
    for a, b in zip(port.recon, ref.recon):
        assert np.array_equal(a, np.asarray(b))


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


@pytest.mark.parametrize("knob", ["bands", "gop_parallel"])
def test_parallel_knobs_raise_with_devices(jobs, tmp_path, monkeypatch,
                                          capsys, knob):
    """With two devices there, bands = 2 / gop_parallel = 2 would run
    the parallel encoders, which are not ported: raise. With one device
    (the CPU) they are ignored, as in the JAX app."""
    job = tmp_path / "par.ini"
    job.write_text(Path(jobs["per_frame"]).read_text()
                   + f"\n[parallel]\n{knob} = 2\n")
    opts = TOptions(job_file=str(job), addr=str(tmp_path / "o.ts"), port=0)
    app = t_main.CeracoderApp(opts, device="cpu")
    assert type(app.encoder) is H265DeviceEncoder
    assert "parallel knobs ignored: 1 device(s)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 14"):
        t_main.CeracoderApp(opts)


def _builds_at_construction(job_text, monkeypatch, tmp_path):
    """The native libraries built while CeracoderApp is constructed on
    `job_text`, and the app."""
    import ceracoder_tpu_torch.audio as audio
    import ceracoder_tpu_torch.native as native
    import ceracoder_tpu_torch.utils.host_build as hb

    built, real = [], hb.build_library

    def record(name):
        built.append(name)
        return real(name)
    for mod in (hb, native, audio):
        monkeypatch.setattr(mod, "build_library", record)
    loaders = (hb.load_hevc_entropy, hb.load_h264_cabac,
               native.load_balancer, audio.load_audio)
    for load in loaders:
        load.cache_clear()
    try:
        job = tmp_path / "audio.ini"
        job.write_text(job_text + "\n[audio]\nkind = tone\n")
        app = t_main.CeracoderApp(
            TOptions(job_file=str(job), addr=str(tmp_path / "o.ts"), port=0),
            device="cpu")
    finally:
        for load in loaders:
            load.cache_clear()
    return set(built), app


def test_native_builds_happen_before_run(jobs, monkeypatch, tmp_path):
    """Every native library the app uses is built while the app is
    constructed, before run() can arm the stall watchdog: a first g++
    build takes seconds with no frame sent."""
    import ceracoder_tpu_torch.audio as audio

    built, app = _builds_at_construction(
        Path(jobs["per_frame"]).read_text(), monkeypatch, tmp_path)
    want = {"hevc_entropy", "balancer"}
    if audio.aac_available():
        want.add("audio_enc")
    assert built == want
    assert (app.audio is not None) == audio.aac_available()


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


def test_watchdog_position_counts_launched_frames(jobs, tmp_path):
    """The stall watchdog's position moves as each frame's device work
    starts, not only when a whole run is collected or sent."""
    app = t_main.CeracoderApp(TOptions(job_file=jobs["host"],
                                       addr=str(tmp_path / "o.ts"), port=0),
                              device="cpu")
    frames = list(TestPatternSource(W, H, num_frames=3).frames())
    seen = []
    real = app.encoder._pad

    def pad(*a):
        seen.append(app._position())
        return real(*a)
    app.encoder._pad = pad
    app.encoder.encode_run_async(frames=frames)
    assert app._position() == app.encoder.frames_launched == 3
    assert seen[::3] == [1, 2, 3]       # one step per frame, 3 planes each


WEDGED = r"""
import sys, time
sys.path.insert(0, %r)
import numpy as np
import ceracoder_tpu_torch.app.main as m
from ceracoder_tpu_torch.app.cli import CliOptions
m.STALL_CHECK_S = 0.2

class WedgeSource:
    width, height, fps_num, fps_den = 64, 48, 30, 1
    def frames(self):
        f = (np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8),
             np.zeros((24, 32), np.uint8))
        for _ in range(3):
            yield f
        time.sleep(60)       # wedged source

app = m.CeracoderApp(CliOptions(job_file=%r, addr="-", port=0),
                     realtime=True, device="cpu")
app.source = WedgeSource()
sys.exit(app.run())
"""


def test_stall_watchdog_exits_wedged_process(tmp_path):
    job = tmp_path / "job.ini"
    job.write_text("[source]\nkind = test\nwidth = 64\nheight = 48\n"
                   "fps = 30\n\n[encode]\ncodec = hevc\ngop = 30\nrun = 1\n")
    p = subprocess.run([sys.executable, "-c", WEDGED % (str(ROOT), str(job))],
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                       timeout=90, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert b"stall detected" in p.stderr.lower()
