"""Balancer runner — algorithm resolution + lifecycle
(reference: src/core/balancer_runner.c)."""

from __future__ import annotations

import sys
from typing import Optional

from ceracoder_tpu_torch.control.config import CeracoderConfig, bitrate_bps
from ceracoder_tpu_torch.control.registry import (
    balancer_available_text,
    balancer_find,
    balancer_get_default,
)
from ceracoder_tpu_torch.control.types import (
    BalancerConfig,
    BalancerInput,
    BalancerOutput,
)
from ceracoder_tpu_torch.native import NativeBalancer


class UnknownBalancerError(ValueError):
    pass


class BalancerRunner:
    """Resolves the algorithm (CLI override > config > default), translates
    the Kbps-based user config into the bps-based BalancerConfig, and owns
    the algorithm instance (reference: balancer_runner_init,
    balancer_runner.c:24-76).

    With `prefer_native` (the default) the algorithm runs in the C++
    core, native/src/balancer.cc, built alone by utils/host_build.py;
    `prefer_native=False` runs the Python algorithms, its executable
    spec. Unlike ceracoder_tpu's runner, which silently falls back to
    Python when the native library cannot be built or loaded, a failed
    build raises here: the two are step-equal, so a fallback would hide
    a broken build behind a slower controller without a trace in the
    output."""

    def __init__(self, cfg: CeracoderConfig,
                 algo_name_override: Optional[str] = None,
                 srt_latency: int = 2000, srt_pkt_size: int = 1316,
                 quiet: bool = False, prefer_native: bool = True) -> None:
        name = algo_name_override if algo_name_override else cfg.balancer
        algo = balancer_find(name)
        if algo is None:
            if algo_name_override is not None:
                raise UnknownBalancerError(
                    f"Unknown balancer algorithm: {algo_name_override}\n\n"
                    + balancer_available_text())
            algo = balancer_get_default()
        self.algo = algo
        self._native = prefer_native

        self.config = BalancerConfig(
            min_bitrate=bitrate_bps(cfg.min_bitrate),
            max_bitrate=bitrate_bps(cfg.max_bitrate),
            srt_latency=srt_latency,
            srt_pkt_size=srt_pkt_size,
            adaptive_incr_step=bitrate_bps(cfg.adaptive.incr_step),
            adaptive_decr_step=bitrate_bps(cfg.adaptive.decr_step),
            adaptive_incr_interval=cfg.adaptive.incr_interval,
            adaptive_decr_interval=cfg.adaptive.decr_interval,
            aimd_incr_step=bitrate_bps(cfg.aimd.incr_step),
            aimd_decr_mult=cfg.aimd.decr_mult,
            aimd_incr_interval=cfg.aimd.incr_interval,
            aimd_decr_interval=cfg.aimd.decr_interval,
        )
        self.state = self._make_state()
        if not quiet:
            impl = "native" if self._native else "python"
            print(f"Balancer: {self.algo.name} ({impl})", file=sys.stderr)
            print(f"Bitrate range: {self.config.min_bitrate // 1000} - "
                  f"{self.config.max_bitrate // 1000} Kbps", file=sys.stderr)

    def _make_state(self):
        if self._native:
            return NativeBalancer(self.algo.name, self.config)
        return self.algo(self.config)

    @property
    def name(self) -> str:
        return self.algo.name

    def step(self, inp: BalancerInput) -> BalancerOutput:
        return self.state.step(inp)

    def update_bounds(self, min_bitrate: int, max_bitrate: int) -> None:
        """SIGHUP-style bounds update: re-inits the algorithm, deliberately
        losing accumulated state (reference: balancer_runner.c:80-89)."""
        self.config.min_bitrate = min_bitrate
        self.config.max_bitrate = max_bitrate
        self.state = self._make_state()
