"""AIMD balancer — TCP-style additive increase / multiplicative decrease
(reference: src/core/balancer_aimd.c)."""

from __future__ import annotations

from ceracoder_tpu_torch.control.types import (
    BalancerConfig,
    BalancerInput,
    BalancerOutput,
    round_100k,
)

# Defaults (reference: balancer_aimd.c:36-39)
AIMD_DEF_INCR_RATE = 50 * 1000
AIMD_DEF_DECR_MULT = 0.75
AIMD_DEF_INCR_INTERVAL = 500
AIMD_DEF_DECR_INTERVAL = 200

# Congestion detection (reference: balancer_aimd.c:42-44)
AIMD_RTT_MULT = 1.5
AIMD_RTT_BASELINE_EMA = 0.95
AIMD_BS_THRESHOLD = 100


class AimdBalancer:
    name = "aimd"
    description = "Additive Increase Multiplicative Decrease (TCP-style)"

    def __init__(self, config: BalancerConfig) -> None:
        self.min_bitrate = config.min_bitrate
        self.max_bitrate = config.max_bitrate
        self.cur_bitrate = config.max_bitrate  # start optimistic
        self.srt_latency = config.srt_latency

        c = config
        self.incr_step = c.aimd_incr_step if c.aimd_incr_step > 0 else AIMD_DEF_INCR_RATE
        self.decr_mult = c.aimd_decr_mult if c.aimd_decr_mult > 0.0 else AIMD_DEF_DECR_MULT
        self.incr_interval = (c.aimd_incr_interval if c.aimd_incr_interval > 0
                              else AIMD_DEF_INCR_INTERVAL)
        self.decr_interval = (c.aimd_decr_interval if c.aimd_decr_interval > 0
                              else AIMD_DEF_DECR_INTERVAL)

        self.rtt_baseline = 0.0
        self.next_incr = 0
        self.next_decr = 0

    def step(self, inp: BalancerInput) -> BalancerOutput:
        # (reference: aimd_step, balancer_aimd.c:103-163)
        rtt = inp.rtt
        ts = inp.timestamp

        # RTT baseline: fast down, slow EMA drift up (:107-116)
        if self.rtt_baseline == 0.0:
            self.rtt_baseline = rtt
        elif rtt < self.rtt_baseline:
            self.rtt_baseline = rtt
        else:
            self.rtt_baseline = (self.rtt_baseline * AIMD_RTT_BASELINE_EMA
                                 + rtt * (1.0 - AIMD_RTT_BASELINE_EMA))

        congested = False
        rtt_threshold = int(self.rtt_baseline * AIMD_RTT_MULT)

        if rtt >= self.srt_latency // 3:
            # emergency: straight to minimum (:123-127)
            self.cur_bitrate = self.min_bitrate
            self.next_decr = ts + self.decr_interval
            congested = True
        elif rtt > rtt_threshold or inp.buffer_size > AIMD_BS_THRESHOLD:
            congested = True

        if congested and ts > self.next_decr:
            self.cur_bitrate = int(self.cur_bitrate * self.decr_mult)
            self.next_decr = ts + self.decr_interval
        elif not congested and ts > self.next_incr:
            self.cur_bitrate += self.incr_step
            self.next_incr = ts + self.incr_interval

        self.cur_bitrate = max(self.min_bitrate,
                               min(self.max_bitrate, self.cur_bitrate))
        rounded = round_100k(self.cur_bitrate)

        return BalancerOutput(
            new_bitrate=rounded,
            throughput=0.0,
            rtt=int(rtt),
            rtt_th_min=int(self.rtt_baseline),
            rtt_th_max=rtt_threshold,
            bs=inp.buffer_size,
            bs_th1=AIMD_BS_THRESHOLD,
            bs_th2=AIMD_BS_THRESHOLD,
            bs_th3=AIMD_BS_THRESHOLD,
        )
