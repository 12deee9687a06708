"""The system under test for `"codec": "hevc"` configurations: the port's
HEVC device encoder (ceracoder_tpu_torch/codec/h265/device.py), and the
reference that judges its frames (benchmark/reference/hevc/)."""

from __future__ import annotations

CTB = 16
# K4, the IDR column kernel (ceracoder_tpu_torch/csrc/h265_intra.cu): its
# two kernels, by the start of their names in the profiler
K4_KERNELS = ("h265_intra_carry_kernel", "h265_intra_code_kernel")


def coded_size(cfg: dict) -> tuple[int, int]:
    return (-(-cfg["width"] // CTB) * CTB, -(-cfg["height"] // CTB) * CTB)


def _settings(cfg: dict) -> dict:
    s = {"sao": bool(cfg.get("sao", False)),
         "tu_split": bool(cfg.get("tu_split", False)),
         "bframes": int(cfg.get("bframes", 0))}
    if any(s.values()):
        raise ValueError(f"the HEVC reference codes neither SAO, the TU "
                         f"split nor B frames; config asks {s}")
    return s


def make_encoder(cfg: dict, qp: int, device):
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
    return H265DeviceEncoder(cfg["width"], cfg["height"], qp=qp,
                             gop=cfg["gop"], device=device, **_settings(cfg))


def install_spans(spans):
    """Wrap the native entropy stage (rowslice.entropy_rows_native, as the
    device encoder imported it) in an "entropy" span; returns the undo."""
    import ceracoder_tpu_torch.codec.h265.device as dev
    orig = dev.entropy_rows_native
    dev.entropy_rows_native = spans.wrap("entropy", orig)

    def undo():
        dev.entropy_rows_native = orig
    return undo


def reference(cfg: dict, pps_qp: int, workers: int | None = None):
    from benchmark.reference.hevc.bands import BandedEncoder
    _settings(cfg)
    return BandedEncoder(cfg["width"], cfg["height"], pps_qp, workers)


def context(cfg: dict) -> dict:
    """What the metric readers need to know of the cell."""
    return {"coded_size": coded_size(cfg), "k4_kernels": K4_KERNELS}
