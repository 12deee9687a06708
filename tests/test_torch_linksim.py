"""The port's bonded-link emulator (ceracoder_tpu_torch/transport/
linksim.py) against the JAX package's, in the scenarios of
tests/test_multistream.py (BASELINE.md config[4]: concurrent streams
with per-stream adaptive control over emulated srtla bonded links with
modem dropouts): every tick's BalancerInput and every balancer output
equal JAX's, the control assertions hold, and the per-stream QP case
runs on the port's CPU encoder with JAX's assertions."""

import dataclasses

import numpy as np
import pytest
import torch

from ceracoder_tpu.control.config import CeracoderConfig as JConfig
from ceracoder_tpu.control.runner import BalancerRunner as JRunner
from ceracoder_tpu.transport import linksim as jlink
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.control.config import CeracoderConfig
from ceracoder_tpu_torch.control.qp_rate import QpRateController
from ceracoder_tpu_torch.control.runner import BalancerRunner
from ceracoder_tpu_torch.transport import linksim
from ceracoder_tpu_torch.transport.linksim import (
    BondedLink,
    Modem,
    two_modem_dropout,
)

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

TICK_MS = 20


def make_runner(max_kbps=10000, min_kbps=500, latency=2000):
    cfg = CeracoderConfig()
    cfg.min_bitrate = min_kbps
    cfg.max_bitrate = max_kbps
    return BalancerRunner(cfg, "adaptive", srt_latency=latency, quiet=True)


def make_jax_runner(max_kbps=10000, min_kbps=500, latency=2000):
    """The JAX runner on its Python algorithms, the executable spec (the
    port's runner runs the native core)."""
    cfg = JConfig()
    cfg.min_bitrate = min_kbps
    cfg.max_bitrate = max_kbps
    return JRunner(cfg, "adaptive", srt_latency=latency, quiet=True,
                   prefer_native=False)


def drive(link, runner, seconds, record_every=50):
    """Run the 20 ms control loop against the emulated link; the
    offered rate follows the balancer's bitrate (the encoder obeys).
    Returns the sampled trajectory and every tick's (input, output)."""
    bitrate = runner.config.max_bitrate
    traj, ticks = [], []
    for i in range(int(seconds * 1000 / TICK_MS)):
        stats = link.tick(bitrate)
        out = runner.step(stats)
        bitrate = out.new_bitrate
        ticks.append((dataclasses.asdict(stats), dataclasses.asdict(out)))
        if i % record_every == 0:
            traj.append(bitrate)
    return traj, ticks


def _dropout(mod):
    return mod.two_modem_dropout(cap_each_mbps=6.0, drop_at_ms=20000,
                                 back_at_ms=40000)


def _blackout(mod):
    return mod.BondedLink(modems=[
        mod.Modem(6e6, schedule=[(10000, False), (12000, True)])])


def _lossy(mod):
    """A short latency budget when the fast modem drops: TLPKTDROP
    fires."""
    return mod.BondedLink(modems=[mod.Modem(0.5e6),
                                  mod.Modem(6e6, [(2000, False)])],
                          latency_ms=100, base_rtt_ms=35.0, pkt_size=1128)


SCENARIOS = {
    # name: (link, runner kwargs, seconds, record_every)
    "dropout": (_dropout, dict(max_kbps=10000), 60, 50),
    "blackout": (_blackout, dict(max_kbps=8000), 20, 10),
    "lossy": (_lossy, dict(max_kbps=6000, min_kbps=300, latency=300), 10, 5),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ticks_and_trajectory_equal_to_jax(name):
    make, kw, secs, every = SCENARIOS[name]
    traj, ticks = drive(make(linksim), make_runner(**kw), secs, every)
    jtraj, jticks = drive(make(jlink), make_jax_runner(**kw), secs, every)
    for i, (a, b) in enumerate(zip(ticks, jticks)):
        assert a == b, f"{name}: tick {i} differs"
    assert len(ticks) == len(jticks) and traj == jtraj
    assert len(set(traj)) > 1          # the link moved the controller
    if name != "dropout":              # the latency budget dropped data
        assert ticks[-1][0]["pkt_loss_total"] > 0


def test_four_streams_ticks_equal_to_jax():
    links = [two_modem_dropout(6.0, drop_at_ms=10000 + 8000 * s,
                               back_at_ms=14000 + 8000 * s)
             for s in range(4)]
    jlinks = [jlink.two_modem_dropout(6.0, drop_at_ms=10000 + 8000 * s,
                                      back_at_ms=14000 + 8000 * s)
              for s in range(4)]
    for s in range(4):
        traj, ticks = drive(links[s], make_runner(), 50)
        jtraj, jticks = drive(jlinks[s], make_jax_runner(), 50)
        assert ticks == jticks and traj == jtraj, s


@pytest.mark.parametrize("t_ms", [0, 19999, 20000, 39999, 40000, 60000])
def test_modem_schedule_equal_to_jax(t_ms):
    sched = [(20000, False), (40000, True)]
    assert Modem(1e6, sched).up(t_ms) == jlink.Modem(1e6, sched).up(t_ms)
    link, jl = two_modem_dropout(), jlink.two_modem_dropout()
    link.t_ms = jl.t_ms = t_ms
    assert link.capacity_bps() == jl.capacity_bps()


def test_dropout_throttles_and_recovers():
    link = two_modem_dropout(cap_each_mbps=6.0, drop_at_ms=20000,
                             back_at_ms=40000)
    runner = make_runner(max_kbps=10000)
    traj, _ = drive(link, runner, seconds=60)
    # phase averages (1 s samples): full capacity, dropout, return
    full = np.mean(traj[10:19])
    dropped = np.mean(traj[25:39])
    recovered = np.mean(traj[50:])
    assert full > 8e6            # rides near max on 12 Mbps agg
    assert dropped < full * 0.75  # throttles on 6 Mbps
    assert recovered > dropped * 1.2   # climbs back
    lo = runner.config.min_bitrate
    hi = runner.config.max_bitrate
    assert all(lo <= b <= hi for b in traj)


def test_total_loss_blackout_drops_to_min():
    link = BondedLink(modems=[
        Modem(6e6, schedule=[(10000, False), (12000, True)]),
    ])
    runner = make_runner(max_kbps=8000)
    traj, _ = drive(link, runner, seconds=20, record_every=10)
    # during the 2 s blackout the emergency path reaches min
    black = traj[len(traj) * 10 // 20: len(traj) * 13 // 20]
    assert min(black) <= runner.config.min_bitrate * 2


def test_four_streams_independent_control():
    """4 concurrent streams, staggered dropouts: each stream's
    controller reacts to its own link only."""
    links = [two_modem_dropout(6.0, drop_at_ms=10000 + 8000 * s,
                               back_at_ms=14000 + 8000 * s)
             for s in range(4)]
    runners = [make_runner(max_kbps=10000) for _ in range(4)]
    bitrates = [r.config.max_bitrate for r in runners]
    minima = [[] for _ in range(4)]
    for i in range(int(50 * 1000 / TICK_MS)):
        t = (i + 1) * TICK_MS
        for s in range(4):
            stats = links[s].tick(bitrates[s])
            bitrates[s] = runners[s].step(stats).new_bitrate
            minima[s].append((t, bitrates[s]))
    for s in range(4):
        during = [b for t, b in minima[s]
                  if 10000 + 8000 * s + 2000 < t < 14000 + 8000 * s]
        outside_other = [b for t, b in minima[s]
                         if t < 10000 + 8000 * s - 1000]
        assert min(during) < np.mean(outside_other) * 0.8, s


def test_per_stream_qp_follows_link_quality():
    """Two streams with independent encoders, links, balancers, and QP
    rate controllers (the app's control stack end to end) on the port's
    encoder: the stream on the weak link must settle at a higher QP
    (coarser) and a lower bitrate than the healthy one."""
    w, h = 96, 64
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.uint8)

    links = [BondedLink(modems=[Modem(3e6)]),
             BondedLink(modems=[Modem(0.4e6)])]
    runners = [make_runner(max_kbps=3000, min_kbps=300, latency=2000)
               for _ in range(2)]
    encs = [H265DeviceEncoder(w, h, qp=32, gop=30, device="cpu")
            for _ in range(2)]
    rates = [QpRateController(fps=30.0, qp=32.0) for _ in range(2)]
    bitrate = [r.config.max_bitrate for r in runners]
    qp = [32, 32]
    qps_hist = [[], []]

    for i in range(45):
        y = base[i % 16:i % 16 + h, (2 * i) % 16:(2 * i) % 16 + w]
        u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
        v = (y[1::2, 1::2] // 3 + 70).astype(np.uint8)
        for k in range(2):
            fr = encs[k].encode_frame(y, u, v, qp=int(qp[k]))
            produced = len(fr.data) * 8
            for _ in range(2):   # ~two 20 ms ticks per frame
                stats = links[k].tick(bitrate[k])
                bitrate[k] = runners[k].step(stats).new_bitrate
            qp[k] = rates[k].update(bitrate[k], produced)
            qps_hist[k].append(qp[k])
    # steady state: weak-link stream coarser and slower
    q0 = np.mean(qps_hist[0][-10:])
    q1 = np.mean(qps_hist[1][-10:])
    assert q1 > q0 + 2, (q0, q1)
    assert bitrate[1] < bitrate[0]
