"""Fixed balancer — constant bitrate, ignores network conditions
(reference: src/core/balancer_fixed.c)."""

from __future__ import annotations

from ceracoder_tpu_torch.control.types import (
    BalancerConfig,
    BalancerInput,
    BalancerOutput,
    round_100k,
)


class FixedBalancer:
    name = "fixed"
    description = "Constant bitrate, no adaptation"

    def __init__(self, config: BalancerConfig) -> None:
        # max_bitrate rounded to 100 Kbps once at init (:44-54)
        self.fixed_bitrate = round_100k(config.max_bitrate)

    def step(self, inp: BalancerInput) -> BalancerOutput:
        return BalancerOutput(
            new_bitrate=self.fixed_bitrate,
            throughput=0.0,
            rtt=int(inp.rtt),
            rtt_th_min=0,
            rtt_th_max=0,
            bs=inp.buffer_size,
            bs_th1=0,
            bs_th2=0,
            bs_th3=0,
        )
