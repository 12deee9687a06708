"""Balancer interface types (reference: src/balancer.h:28-94)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

# Global bitrate limits (reference: src/core/bitrate_control.h:30-32)
MIN_BITRATE = 300 * 1000
ABS_MAX_BITRATE = 30 * 1000 * 1000
DEF_BITRATE = 6 * 1000 * 1000

# Controller poll period in ms (reference: src/core/bitrate_control.h:35)
BITRATE_UPDATE_INT = 20


@dataclass
class BalancerConfig:
    """Configuration handed to a balancer at init
    (reference: src/balancer.h:28-45). Bitrates in bps, intervals in ms."""

    min_bitrate: int = MIN_BITRATE
    max_bitrate: int = DEF_BITRATE
    srt_latency: int = 2000
    srt_pkt_size: int = 1316

    # adaptive tuning (0 = use algorithm default)
    adaptive_incr_step: int = 0
    adaptive_decr_step: int = 0
    adaptive_incr_interval: int = 0
    adaptive_decr_interval: int = 0

    # aimd tuning (0 = use algorithm default)
    aimd_incr_step: int = 0
    aimd_decr_mult: float = 0.0
    aimd_incr_interval: int = 0
    aimd_decr_interval: int = 0


@dataclass
class BalancerInput:
    """Per-tick link statistics (reference: src/balancer.h:50-57)."""

    buffer_size: int = 0        # SRT send-buffer occupancy, packets
    rtt: float = 0.0            # round-trip time, ms
    send_rate_mbps: float = 0.0
    timestamp: int = 0          # ms (injected clock)
    pkt_loss_total: int = 0     # cumulative
    pkt_retrans_total: int = 0  # cumulative


@dataclass
class BalancerOutput:
    """Step result incl. overlay/debug info (reference: src/balancer.h:62-72)."""

    new_bitrate: int = 0        # bps, rounded down to 100 Kbps
    throughput: float = 0.0
    rtt: int = 0
    rtt_th_min: int = 0
    rtt_th_max: int = 0
    bs: int = 0
    bs_th1: int = 0
    bs_th2: int = 0
    bs_th3: int = 0


class Balancer(Protocol):
    """A balancer algorithm: construct with config, step per tick.

    The construct/step split mirrors the reference's init/step/cleanup
    vtable (src/balancer.h:82-94); Python GC subsumes cleanup.
    """

    name: str
    description: str

    def __init__(self, config: BalancerConfig) -> None: ...

    def step(self, inp: BalancerInput) -> BalancerOutput: ...


def round_100k(bps: int) -> int:
    """Round down to 100 Kbps (reference: src/core/bitrate_control.c:206)."""
    return bps // (100 * 1000) * (100 * 1000)
