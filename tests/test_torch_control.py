"""The port's control loop and transport against the JAX package's:
balancers (Python and native) step by step, config, registry, QP rate
control, scene cuts, PTS fixup, the overlay burn-in, the TS muxer and
the 1316 B packer. All pure host code: exact equality throughout."""

import dataclasses

import numpy as np
import pytest

import ceracoder_tpu.app.overlay as j_overlay
import ceracoder_tpu.app.ptsfix as j_ptsfix
import ceracoder_tpu.app.textoverlay as j_text
import ceracoder_tpu.control as j_control
import ceracoder_tpu.control.config as j_config
import ceracoder_tpu.control.lookahead as j_look
import ceracoder_tpu.control.qp_rate as j_qp
import ceracoder_tpu.control.registry as j_registry
import ceracoder_tpu.transport.mpegts as j_ts
import ceracoder_tpu_torch.app.overlay as t_overlay
import ceracoder_tpu_torch.app.ptsfix as t_ptsfix
import ceracoder_tpu_torch.app.textoverlay as t_text
import ceracoder_tpu_torch.control as t_control
import ceracoder_tpu_torch.control.config as t_config
import ceracoder_tpu_torch.control.lookahead as t_look
import ceracoder_tpu_torch.control.qp_rate as t_qp
import ceracoder_tpu_torch.control.registry as t_registry
import ceracoder_tpu_torch.transport.mpegts as t_ts

CONFIG_INI = """\
# bonded-modem style config
min_bitrate = 800
max_bitrate = 5500
balancer = aimd

[srt]
latency = 1500

[adaptive]
incr_step = 40
decr_step = 150
incr_interval = 400
decr_interval = 150

[aimd]
incr_step = 75
decr_mult = 0.8
incr_interval = 300 ; trailing comment
decr_interval = 250
"""


def congestion_trace(n: int = 1500, seed: int = 11):
    """A 20 ms-tick SRT trace (as BalancerInput fields): a clean link,
    an RTT ramp with send-buffer growth, a loss burst, an emergency
    stretch and a slow recovery, with jitter from `seed`."""
    rng = np.random.default_rng(seed)
    loss = retrans = 0
    out = []
    for i in range(n):
        t = i * 20
        phase = i / n
        if phase < 0.2:
            rtt, bs, rate = 40.0, 4, 5.5
        elif phase < 0.45:
            k = (phase - 0.2) / 0.25
            rtt, bs, rate = 40.0 + 500.0 * k, int(4 + 300 * k), 5.0 - 3 * k
        elif phase < 0.55:
            rtt, bs, rate = 900.0, 600, 1.0
            loss += int(rng.integers(0, 4))
            retrans += int(rng.integers(0, 6))
        elif phase < 0.6:
            rtt, bs, rate = 2500.0, 2000, 0.4
        else:
            rtt, bs, rate = 60.0, 10, 4.0
        out.append(dict(
            buffer_size=max(0, bs + int(rng.integers(-3, 4))),
            rtt=rtt + float(rng.normal(0.0, 4.0)),
            send_rate_mbps=max(0.0, rate + float(rng.normal(0.0, 0.2))),
            timestamp=t, pkt_loss_total=loss, pkt_retrans_total=retrans))
    return out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("algo", ["fixed", "adaptive", "aimd"])
def test_balancer_step_equal_to_jax(algo, native):
    """The port's runner (Python or native core) against the JAX
    package's Python balancer, the executable spec, on one congestion
    trace, with a SIGHUP-style bounds update mid-trace."""
    cfg_j = j_control.CeracoderConfig(min_bitrate=500, max_bitrate=6000,
                                      balancer=algo)
    cfg_t = t_control.CeracoderConfig(min_bitrate=500, max_bitrate=6000,
                                      balancer=algo)
    ref = j_control.BalancerRunner(cfg_j, srt_latency=1800, quiet=True,
                                   prefer_native=False)
    port = t_control.BalancerRunner(cfg_t, srt_latency=1800, quiet=True,
                                    prefer_native=native)
    assert (type(port.state).__name__ == "NativeBalancer") == native
    trace = congestion_trace()
    rates = set()
    for i, fields in enumerate(trace):
        if i == len(trace) // 2:
            ref.update_bounds(900_000, 4_000_000)
            port.update_bounds(900_000, 4_000_000)
        want = ref.step(j_control.BalancerInput(**fields))
        got = port.step(t_control.BalancerInput(**fields))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), i
        rates.add(got.new_bitrate)
    # the trace drives the controller through decreases and recovery
    assert len(rates) > (1 if algo == "fixed" else 10)
    assert port.config == t_control.BalancerConfig(
        **dataclasses.asdict(ref.config))


def test_failed_balancer_build_raises(monkeypatch):
    """A native balancer that cannot be built stops the runner; it does
    not fall back to the Python algorithm."""
    import ceracoder_tpu_torch.native as native

    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cc")

    native.load_balancer.cache_clear()
    monkeypatch.setattr(native, "build_library", broken)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            t_control.BalancerRunner(t_control.CeracoderConfig(), quiet=True)
        runner = t_control.BalancerRunner(t_control.CeracoderConfig(),
                                          quiet=True, prefer_native=False)
        assert type(runner.state).__name__ == "AdaptiveBalancer"
    finally:
        native.load_balancer.cache_clear()


def test_config_load_and_serialize_equal(tmp_path):
    path = tmp_path / "ceracoder.conf"
    path.write_text(CONFIG_INI)
    got = t_config.config_load(path)
    want = j_config.config_load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.aimd.decr_mult == 0.8 and got.srt_latency == 1500
    for balancer in ("adaptive", "aimd", "fixed"):
        got.balancer = want.balancer = balancer
        assert (t_config.config_serialize(got)
                == j_config.config_serialize(want))


def test_registry_text_equal():
    assert (t_registry.balancer_available_text()
            == j_registry.balancer_available_text())
    assert ([b.name for b in t_registry.balancer_list_all()]
            == [b.name for b in j_registry.balancer_list_all()])
    assert t_registry.balancer_find("nope") is None


def test_qp_rate_controller_sequence_equal():
    rng = np.random.default_rng(5)
    ref = j_qp.QpRateController(fps=30.0, gop=12)
    port = t_qp.QpRateController(fps=30.0, gop=12)
    for i in range(200):
        bitrate = int(rng.integers(300_000, 6_000_000))
        key = i % 12 == 0
        bits = int(rng.integers(1, 600_000)) * (4 if key else 1)
        assert (port.update(bitrate, bits, keyframe=key)
                == ref.update(bitrate, bits, keyframe=key))
        assert port.qp == ref.qp and port.buf_bits == ref.buf_bits
        assert port.ratio == ref.ratio


def test_cut_detector_equal():
    rng = np.random.default_rng(8)
    base = rng.integers(0, 120, (64, 96)).astype(np.uint8)
    other = rng.integers(130, 256, (64, 96)).astype(np.uint8)
    ref, port = j_look.CutDetector(), t_look.CutDetector()
    cuts = []
    for i in range(24):
        y = base if (i // 8) % 2 == 0 else other
        y = np.clip(y.astype(np.int32) + rng.integers(-3, 4, y.shape),
                    0, 255).astype(np.uint8)
        got, want = port.feed(y), ref.feed(y)
        assert got == want
        cuts.append(got[1])
    assert cuts.count(True) == 2          # the cuts at frames 8 and 16


def test_pts_fixup_equal():
    rng = np.random.default_rng(1)
    ref, port = j_ptsfix.PtsFixup(30000, 1001), t_ptsfix.PtsFixup(30000,
                                                                 1001)
    t = 0
    for i in range(300):
        t += 3003 + int(rng.integers(-400, 401))
        if i % 17 == 0:
            t -= 7000                     # backwards step
        pts = t if i % 11 else t - 3003   # duplicate-ish
        assert (dataclasses.asdict(port.feed(pts))
                == dataclasses.asdict(ref.feed(pts)))


def test_overlay_text_and_burn_in_equal():
    out_j = j_control.BalancerOutput(
        new_bitrate=4_800_000, throughput=4812.5, rtt=35, rtt_th_min=30,
        rtt_th_max=60, bs=5, bs_th1=50, bs_th2=99, bs_th3=200)
    out_t = t_control.BalancerOutput(**dataclasses.asdict(out_j))
    line = t_overlay.overlay_text(out_t)
    assert line == j_overlay.overlay_text(out_j)
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (72, 400)).astype(np.uint8)
    for text in (line, "~~unknown~~", ""):
        assert np.array_equal(t_text.burn_overlay(y, text),
                              j_text.burn_overlay(y, text))
    tick = dict(t_ms=20, bitrate=1, qp=30, throughput=1.5, rtt=2,
                rtt_th_min=3, rtt_th_max=4, bs=5, bs_th1=6, bs_th2=7,
                bs_th3=8)
    assert (t_overlay.TickLog(**tick).as_dict()
            == j_overlay.TickLog(**tick).as_dict())


def _access_units(seed: int, n: int):
    """Annex-B-looking video access units of varied sizes (one past a
    PES packet's 16-bit length, several under one TS payload)."""
    rng = np.random.default_rng(seed)
    sizes = [5, 183, 184, 70_000, 1, 2_000] + list(
        rng.integers(1, 20_000, n - 6))
    return [b"\x00\x00\x00\x01" + rng.integers(0, 256, s, np.uint8).tobytes()
            for s in sizes]


@pytest.mark.parametrize("audio", [None, "aac", "opus"])
def test_ts_mux_and_packer_byte_equal(audio):
    from ceracoder_tpu_torch.audio import aac_available

    aus = _access_units(4, 24)
    adts = []
    if audio is not None:
        if not aac_available():
            pytest.skip("libavcodec headers missing: no audio encoder")
        from ceracoder_tpu.audio import AudioPipeline as JPipe
        from ceracoder_tpu_torch.audio import AudioPipeline as TPipe
        from ceracoder_tpu_torch.audio import ToneSource

        pipe_t, pipe_j = TPipe(codec=audio), JPipe(codec=audio)
        tone = ToneSource()
        for _ in aus:
            pcm = tone.read(1600)
            frames_t, frames_j = pipe_t.feed(pcm), pipe_j.feed(pcm)
            assert ([(f.adts, f.pts90) for f in frames_t]
                    == [(f.adts, f.pts90) for f in frames_j])
            adts.append(frames_t)
        assert sum(map(len, adts)) > 0
    kw = dict(video_stream_type=0x24, with_audio=audio is not None,
              audio_kind=audio or "aac", audio_channels=2)
    mux_j, mux_t = j_ts.TsMuxer(**kw), t_ts.TsMuxer(**kw)
    pack_j, pack_t = j_ts.TsPacker(1316), t_ts.TsPacker(1316)
    stream = b""
    for i, au in enumerate(aus):
        key = i % 8 == 0
        ts_j = mux_j.mux_video(au, pts90=i * 1500, keyframe=key)
        ts_t = mux_t.mux_video(au, pts90=i * 1500, keyframe=key)
        for f in (adts[i] if adts else []):
            ts_j += mux_j.mux_audio(f.adts, f.pts90)
            ts_t += mux_t.mux_audio(f.adts, f.pts90)
        assert ts_t == ts_j
        got, want = pack_t.feed(ts_t), pack_j.feed(ts_j)
        assert got == want and all(len(p) == 1316 for p in got)
        stream += b"".join(got)
    assert pack_t.residue == pack_j.residue
    tail = pack_t.flush()
    assert tail == pack_j.flush()
    stream += tail
    assert len(stream) % 188 == 0
    assert stream[::188] == b"\x47" * (len(stream) // 188)


def test_ts_packer_reduced_size_equal():
    data = b"".join(_access_units(9, 10))[:188 * 61]
    pack_j, pack_t = j_ts.TsPacker(1128), t_ts.TsPacker(1128)
    for k in range(0, len(data), 188 * 5):
        chunk = data[k:k + 188 * 5]
        assert pack_t.feed(chunk) == pack_j.feed(chunk)
    assert pack_t.flush() == pack_j.flush()
    with pytest.raises(ValueError):
        t_ts.TsPacker(1000)
