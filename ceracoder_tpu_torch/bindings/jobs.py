"""Job builder — the PipelineBuilder analog
(reference: bindings/typescript/src/pipeline/index.ts:36-150).

Where the reference generates per-hardware GStreamer launch strings
(jetson/rk3588/n100/generic builders), the TPU framework generates
encode-job specs; the "hardware" axis becomes the TPU deployment shape
(single chip / host / multi-host mesh) and the source axis matches the
reference's source kinds where they make sense off-device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# Resolution map (reference: bindings/typescript/src/pipeline/types.ts:76-83)
RESOLUTIONS = {
    "480p": (854, 480),
    "540p": (960, 540),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "1440p": (2560, 1440),
    "4k": (3840, 2160),
}

SOURCE_KINDS = ("test", "y4m", "raw")
CODECS = ("h264", "hevc")


class JobValidationError(ValueError):
    pass


@dataclass
class JobRequest:
    source: str = "test"
    path: str = ""
    resolution: str = "720p"
    fps: int = 30
    codec: str = "h264"
    gop: Optional[int] = None     # None = 2 s of frames
    extra: dict = field(default_factory=dict)


class JobBuilder:
    """Build a validated job-spec INI string."""

    def build(self, req: JobRequest) -> str:
        if req.source not in SOURCE_KINDS:
            raise JobValidationError(f"unknown source {req.source!r}")
        if req.resolution not in RESOLUTIONS:
            raise JobValidationError(f"unknown resolution {req.resolution!r}")
        if req.codec not in CODECS:
            raise JobValidationError(f"unknown codec {req.codec!r}")
        if req.source in ("y4m", "raw") and not req.path:
            raise JobValidationError(f"source {req.source!r} requires path")
        if not 1 <= req.fps <= 240:
            raise JobValidationError(f"fps out of range: {req.fps}")
        w, h = RESOLUTIONS[req.resolution]
        # GOP = 2 s of frames (reference common.ts:104-107)
        gop = req.gop if req.gop else 2 * req.fps
        lines = [
            "[source]",
            f"kind = {req.source}",
        ]
        if req.path:
            lines.append(f"path = {req.path}")
        lines += [
            f"width = {w}",
            f"height = {h}",
            f"fps = {req.fps}",
            "",
            "[encode]",
            f"codec = {req.codec}",
            f"gop = {gop}",
        ]
        for k, v in req.extra.items():
            lines.append(f"{k} = {v}")
        text = "\n".join(lines) + "\n"
        self.validate(text)
        return text

    @staticmethod
    def validate(text: str) -> None:
        """Structural validation, the analog of the reference's
        required-element check (index.ts:139-149)."""
        required = ("[source]", "[encode]", "kind =", "codec =")
        for token in required:
            if token not in text:
                raise JobValidationError(f"jobspec missing {token!r}")
