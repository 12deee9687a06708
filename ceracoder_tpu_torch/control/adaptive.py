"""Adaptive balancer — the flagship controller.

Behavioral contract cloned from the reference's pure-C core
(src/core/bitrate_control.c:81-222, constants src/core/bitrate_control.h:29-68,
plugin wrapper src/core/balancer_adaptive.c). Every EMA coefficient,
threshold formula, integer truncation, and cooldown rule is kept identical
so step responses match the C implementation tick for tick.
"""

from __future__ import annotations

from ceracoder_tpu_torch.control.types import (
    BalancerConfig,
    BalancerInput,
    BalancerOutput,
    round_100k,
)

# Adjustment steps/intervals (reference: bitrate_control.h:36-44)
BITRATE_INCR_INT = 500
BITRATE_DECR_INT = 200
BITRATE_DECR_FAST_INT = 250
BITRATE_INCR_MIN = 30 * 1000
BITRATE_INCR_SCALE = 30
BITRATE_DECR_MIN = 100 * 1000
BITRATE_DECR_SCALE = 10

# EMA smoothing (reference: bitrate_control.h:47-52)
EMA_SLOW = 0.99
EMA_FAST = 0.01
EMA_RTT_DELTA = 0.8
EMA_RTT_DELTA_NEW = 0.2
EMA_THROUGHPUT = 0.97
EMA_THROUGHPUT_NEW = 0.03

# RTT tracking (reference: bitrate_control.h:55-58)
RTT_MIN_DRIFT = 1.001
RTT_IGNORE_VALUE = 100
RTT_INITIAL = 300
RTT_MIN_INITIAL = 200.0

# Congestion thresholds (reference: bitrate_control.h:61-68)
BS_TH3_MULT = 4
BS_TH2_JITTER_MULT = 3.0
BS_TH1_JITTER_MULT = 2.5
BS_TH_MIN = 50
RTT_JITTER_MULT = 4
RTT_AVG_PERCENT = 15
RTT_STABLE_DELTA = 0.01
RTT_MIN_JITTER = 1

# Loss detection (reference: bitrate_control.c:77-79)
LOSS_RATE_THRESHOLD = 0.5
EMA_LOSS = 0.9
EMA_LOSS_NEW = 0.1


class AdaptiveBalancer:
    name = "adaptive"
    description = "RTT and buffer-based control, reacts to congestion"

    def __init__(self, config: BalancerConfig) -> None:
        # (reference: bitrate_context_init, bitrate_control.c:31-74)
        self.min_bitrate = config.min_bitrate
        self.max_bitrate = config.max_bitrate
        self.srt_latency = config.srt_latency
        self.srt_pkt_size = config.srt_pkt_size

        c = config
        self.incr_step = c.adaptive_incr_step if c.adaptive_incr_step > 0 else BITRATE_INCR_MIN
        self.decr_step = c.adaptive_decr_step if c.adaptive_decr_step > 0 else BITRATE_DECR_MIN
        self.incr_interval = (c.adaptive_incr_interval if c.adaptive_incr_interval > 0
                              else BITRATE_INCR_INT)
        self.decr_interval = (c.adaptive_decr_interval if c.adaptive_decr_interval > 0
                              else BITRATE_DECR_INT)
        self.decr_fast_interval = BITRATE_DECR_FAST_INT

        self.cur_bitrate = config.max_bitrate  # start at max

        self.bs_avg = 0.0
        self.bs_jitter = 0.0
        self.prev_bs = 0

        self.rtt_avg = 0.0
        self.rtt_min = RTT_MIN_INITIAL
        self.rtt_jitter = 0.0
        self.rtt_avg_delta = 0.0
        self.prev_rtt = RTT_INITIAL

        self.throughput = 0.0

        self.prev_pkt_loss = 0
        self.prev_pkt_retrans = 0
        self.loss_rate = 0.0

        self.next_bitrate_incr = 0
        self.next_bitrate_decr = 0

    def _rtt_to_bs(self, rtt_ms: int) -> float:
        # expected send-buffer packets for a given delay at current
        # throughput (reference: bitrate_control.c:29)
        return (self.throughput / 8) * rtt_ms / self.srt_pkt_size

    def step(self, inp: BalancerInput) -> BalancerOutput:
        # (reference: bitrate_update, bitrate_control.c:81-222)
        bs = inp.buffer_size
        rtt = inp.rtt
        rtt_int = int(rtt)
        ts = inp.timestamp

        # --- packet loss tracking (:91-105)
        loss_delta = inp.pkt_loss_total - self.prev_pkt_loss
        retrans_delta = inp.pkt_retrans_total - self.prev_pkt_retrans
        self.prev_pkt_loss = inp.pkt_loss_total
        self.prev_pkt_retrans = inp.pkt_retrans_total
        if loss_delta > 0 or retrans_delta > 0:
            self.loss_rate = (self.loss_rate * EMA_LOSS
                              + float(loss_delta + retrans_delta) * EMA_LOSS_NEW)
        else:
            self.loss_rate *= EMA_LOSS
        pkt_loss_congestion = self.loss_rate > LOSS_RATE_THRESHOLD

        # --- send-buffer stats (:111-119)
        self.bs_avg = self.bs_avg * EMA_SLOW + float(bs) * EMA_FAST
        self.bs_jitter = EMA_SLOW * self.bs_jitter
        delta_bs = bs - self.prev_bs
        if delta_bs > self.bs_jitter:
            self.bs_jitter = float(delta_bs)
        self.prev_bs = bs

        # --- RTT stats (:125-146)
        if self.rtt_avg == 0.0:
            self.rtt_avg = rtt
        else:
            self.rtt_avg = self.rtt_avg * EMA_SLOW + EMA_FAST * rtt
        delta_rtt = rtt - float(self.prev_rtt)
        self.rtt_avg_delta = (self.rtt_avg_delta * EMA_RTT_DELTA
                              + delta_rtt * EMA_RTT_DELTA_NEW)
        self.prev_rtt = rtt_int
        self.rtt_min *= RTT_MIN_DRIFT
        if (rtt_int != RTT_IGNORE_VALUE and rtt < self.rtt_min
                and self.rtt_avg_delta < 1.0):
            self.rtt_min = rtt
        self.rtt_jitter *= EMA_SLOW
        if delta_rtt > self.rtt_jitter:
            self.rtt_jitter = delta_rtt

        # --- throughput EMA, Mbps -> Kibit-style units (:151-152)
        self.throughput *= EMA_THROUGHPUT
        self.throughput += (inp.send_rate_mbps * 1000.0 * 1000.0 / 1024.0) * EMA_THROUGHPUT_NEW

        # --- thresholds (:157-162); int() truncation mirrors C int casts
        bs_th3 = int((self.bs_avg + self.bs_jitter) * BS_TH3_MULT)
        bs_th2 = int(max(BS_TH_MIN,
                         self.bs_avg + max(self.bs_jitter * BS_TH2_JITTER_MULT,
                                           self.bs_avg)))
        bs_th2 = min(bs_th2, int(self._rtt_to_bs(self.srt_latency // 2)))
        bs_th1 = int(max(BS_TH_MIN, self.bs_avg + self.bs_jitter * BS_TH1_JITTER_MULT))
        rtt_th_max = int(self.rtt_avg + max(self.rtt_jitter * RTT_JITTER_MULT,
                                            self.rtt_avg * RTT_AVG_PERCENT / 100))
        rtt_th_min = int(self.rtt_min + max(RTT_MIN_JITTER, self.rtt_jitter * 2))

        # --- decision ladder (:174-199)
        bitrate = self.cur_bitrate
        if bitrate > self.min_bitrate and (
                rtt_int >= self.srt_latency // 3 or bs > bs_th3):
            # emergency: drop to minimum
            bitrate = self.min_bitrate
            self.next_bitrate_decr = ts + self.decr_interval
        elif ts > self.next_bitrate_decr and (
                rtt_int > self.srt_latency // 5 or bs > bs_th2
                or pkt_loss_congestion):
            # heavy congestion: fast decrease
            bitrate -= self.decr_step + bitrate // BITRATE_DECR_SCALE
            self.next_bitrate_decr = ts + self.decr_fast_interval
        elif ts > self.next_bitrate_decr and (rtt_int > rtt_th_max or bs > bs_th1):
            # light congestion: slow decrease
            bitrate -= self.decr_step
            self.next_bitrate_decr = ts + self.decr_interval
        elif (ts > self.next_bitrate_incr and rtt_int < rtt_th_min
              and self.rtt_avg_delta < RTT_STABLE_DELTA
              and not pkt_loss_congestion):
            # stable: increase
            bitrate += self.incr_step + bitrate // BITRATE_INCR_SCALE
            self.next_bitrate_incr = ts + self.incr_interval

        # clamp; keep unrounded internal state (:202-206)
        bitrate = max(min(bitrate, self.max_bitrate), self.min_bitrate)
        self.cur_bitrate = bitrate
        rounded = round_100k(bitrate)

        return BalancerOutput(
            new_bitrate=rounded,
            throughput=self.throughput,
            rtt=rtt_int,
            rtt_th_min=rtt_th_min,
            rtt_th_max=rtt_th_max,
            bs=bs,
            bs_th1=bs_th1,
            bs_th2=bs_th2,
            bs_th3=bs_th3,
        )
