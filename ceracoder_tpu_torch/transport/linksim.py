"""Bonded-link emulator: srtla-style aggregate capacity with modem
dropouts, producing the SRT statistics the balancer consumes.

The reference deliberately sees one SRT socket whose capacity is the
*aggregate* of bonded modems (srtla below it; reference README.md:33-79
via SURVEY.md §1). Its tests script synthetic stat traces
(tests/test_balancer.c:303-331); this module is the reusable version:
a small queue model that turns (offered bitrate, per-modem capacity
schedule) into the BalancerInput fields — send-buffer occupancy, RTT
inflation, send rate, cumulative loss — so multi-stream control tests
and the app can replay bonded-link scenarios (BASELINE.md config[4]:
modem-dropout trace, per-stream control) without a network.

Model, per 20 ms tick (the reference's poll interval):
- capacity(t) = sum of per-modem up/down capacities
- the send buffer drains at capacity and fills at the offered rate;
  occupancy converts to packets (srt_pkt_size)
- RTT = base + queueing delay (buffer / capacity)
- drops: when occupancy exceeds the latency budget, the tail is
  dropped and counted as loss (SRT TLPKTDROP behavior)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceracoder_tpu_torch.control.types import BalancerInput

TICK_MS = 20


@dataclass
class Modem:
    """One bonded link: capacity in bps and an up/down schedule of
    (t_ms, up) events (sorted; initial state = up)."""

    capacity_bps: float
    schedule: list = field(default_factory=list)

    def up(self, t_ms: int) -> bool:
        state = True
        for ts, up in self.schedule:
            if t_ms >= ts:
                state = up
            else:
                break
        return state


@dataclass
class BondedLink:
    """Aggregate of modems + queue model producing SRT stats."""

    modems: list
    base_rtt_ms: float = 60.0
    latency_ms: int = 2000
    pkt_size: int = 1316
    t_ms: int = 0
    backlog_bits: float = 0.0
    loss_total: int = 0
    retrans_total: int = 0
    sent_bits_window: float = 0.0

    def capacity_bps(self) -> float:
        return sum(m.capacity_bps for m in self.modems
                   if m.up(self.t_ms))

    def tick(self, offered_bps: float) -> BalancerInput:
        """Advance one 20 ms tick with the given offered bitrate and
        return the stats the balancer would poll."""
        self.t_ms += TICK_MS
        cap = self.capacity_bps()
        dt = TICK_MS / 1000.0
        inflow = offered_bps * dt
        drain = cap * dt
        self.backlog_bits = max(0.0, self.backlog_bits + inflow - drain)

        # TLPKTDROP: data older than the latency budget is dropped
        budget_bits = max(cap, 1.0) * (self.latency_ms / 1000.0)
        if self.backlog_bits > budget_bits:
            dropped = self.backlog_bits - budget_bits
            self.loss_total += int(dropped / (self.pkt_size * 8)) + 1
            self.retrans_total += int(dropped / (self.pkt_size * 8) / 2)
            self.backlog_bits = budget_bits

        send_rate = min(offered_bps, cap) if cap > 0 else 0.0
        queue_delay_ms = (self.backlog_bits / cap * 1000.0
                          if cap > 0 else self.latency_ms)
        rtt = self.base_rtt_ms + queue_delay_ms
        buffer_pkts = int(self.backlog_bits / 8 / self.pkt_size)
        return BalancerInput(
            buffer_size=buffer_pkts,
            rtt=min(rtt, 10000.0),
            send_rate_mbps=send_rate / 1e6,
            timestamp=self.t_ms,
            pkt_loss_total=self.loss_total,
            pkt_retrans_total=self.retrans_total,
        )


def two_modem_dropout(cap_each_mbps: float = 6.0,
                      drop_at_ms: int = 20000,
                      back_at_ms: int = 40000) -> BondedLink:
    """The classic 2x4G scenario: one modem drops mid-stream and
    returns later (reference README.md:84 operating point)."""
    return BondedLink(modems=[
        Modem(cap_each_mbps * 1e6),
        Modem(cap_each_mbps * 1e6,
              schedule=[(drop_at_ms, False), (back_at_ms, True)]),
    ])
