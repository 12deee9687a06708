"""Live telemetry line — structured version of the reference's on-video
overlay (reference: src/gst/overlay_ui.c:34-48, format documented in
docs/bitrate-control.md:314-331)."""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ceracoder_tpu_torch.control.types import BalancerOutput


def overlay_text(out: BalancerOutput) -> str:
    """Byte-identical format to the reference overlay string."""
    return ("  b: %5d/%5.0f rtt: %3d/%3d/%3d bs: %3d/%3d/%3d/%3d" % (
        out.new_bitrate // 1000, out.throughput,
        out.rtt, out.rtt_th_min, out.rtt_th_max,
        out.bs, out.bs_th1, out.bs_th2, out.bs_th3))


@dataclass
class TickLog:
    """One 20 ms controller tick, as a structured record (the new
    framework's addition over the reference: machine-readable telemetry,
    SURVEY.md §5 'tracing')."""

    t_ms: int
    bitrate: int
    qp: int
    throughput: float
    rtt: int
    rtt_th_min: int
    rtt_th_max: int
    bs: int
    bs_th1: int
    bs_th2: int
    bs_th3: int

    def as_dict(self):
        return asdict(self)
