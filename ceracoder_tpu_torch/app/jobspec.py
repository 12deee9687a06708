"""Encode-job specification files.

The reference's positional PIPELINE_FILE argument is a GStreamer launch
string (reference: src/io/pipeline_loader.c); here it is reinterpreted as
an INI job spec describing source + encoder (SURVEY.md §7.1 step 7).
Copy of ceracoder_tpu/app/jobspec.py; `devtest` opens the port's
device source.

Example::

    [source]
    kind = test            # test | devtest | y4m | raw
    # path = clip.y4m      # for y4m/raw
    width = 1280
    height = 720
    fps = 30

    [encode]
    codec = hevc           # hevc | h264
    gop = 60               # frames between IDRs (2 s of frames default)

    [audio]
    kind = tone            # none | tone | wav
    # path = in.wav        # for wav
    bitrate = 128          # Kbps (reference default: common.ts 128 kbps)
    delay_ms = 0           # a_delay analog (reference: cb_delay)
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ceracoder_tpu_torch.app.source import (
    DeviceTestPatternSource,
    FrameSource,
    RawYuvSource,
    TestPatternSource,
    Y4MFileSource,
)


@dataclass
class JobSpec:
    kind: str = "test"
    path: str = ""
    width: int = 1280
    height: int = 720
    fps_num: int = 30
    fps_den: int = 1
    codec: str = "h264"
    gop: int = 0          # 0 = 2 s of frames (reference GOP policy)
    run: int = 8          # frames per encode run (1 = per-frame loop)
    overlay: bool = True  # burn the telemetry line into the video
    # [parallel] (SURVEY.md §2.7 axes as product knobs; hevc only):
    bands: int = 1        # CTB-row bands of each frame across devices
    gop_parallel: int = 1  # closed GOPs round-robined across devices
    loop: bool = True
    audio_kind: str = "none"      # none | tone | wav
    audio_path: str = ""
    audio_codec: str = "aac"      # aac | opus (reference common.ts:71-87)
    audio_bitrate: int = 128      # Kbps
    audio_delay_ms: int = 0       # a_delay analog

    @property
    def fps(self) -> float:
        return self.fps_num / self.fps_den

    @property
    def gop_frames(self) -> int:
        # 2 s of frames, the reference's GOP policy
        # (bindings/typescript/src/pipeline/common.ts:104-107)
        return self.gop if self.gop > 0 else max(1, round(2 * self.fps))


def parse_jobspec(path: str | Path) -> JobSpec:
    spec = JobSpec()
    section = ""
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            section = line.strip("[] ").lower()
            continue
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip().lower(), val.split("#")[0].strip()
        if section == "source":
            if key == "kind":
                spec.kind = val
            elif key == "path":
                spec.path = val
            elif key == "width":
                spec.width = int(val)
            elif key == "height":
                spec.height = int(val)
            elif key == "fps":
                if ":" in val or "/" in val:
                    n, d = val.replace("/", ":").split(":")
                    spec.fps_num, spec.fps_den = int(n), int(d)
                else:
                    spec.fps_num, spec.fps_den = int(float(val)), 1
            elif key == "loop":
                spec.loop = val.lower() in ("1", "true", "yes")
        elif section == "encode":
            if key == "codec":
                spec.codec = val
            elif key == "gop":
                spec.gop = int(val)
            elif key == "run":
                spec.run = max(1, int(val))
            elif key == "overlay":
                spec.overlay = val.lower() in ("1", "true", "yes", "on")
        elif section == "parallel":
            if key == "bands":
                spec.bands = max(1, int(val))
            elif key == "gop_parallel":
                spec.gop_parallel = max(1, int(val))
        elif section == "audio":
            if key == "kind":
                spec.audio_kind = val
            elif key == "path":
                spec.audio_path = val
            elif key == "codec":
                spec.audio_codec = val
            elif key == "bitrate":
                spec.audio_bitrate = int(val)
            elif key == "delay_ms":
                spec.audio_delay_ms = int(val)
    return spec


def open_source(spec: JobSpec, device=None) -> FrameSource:
    """The frame source a job names; a device source (`devtest`) lives
    on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""
    if spec.kind == "test":
        return TestPatternSource(width=spec.width, height=spec.height,
                                 fps_num=spec.fps_num, fps_den=spec.fps_den)
    if spec.kind == "devtest":
        # device-side test pattern: frames are generated on the card
        # inside the encode run, so no raw pixels cross from the host
        # (the analog of the reference's test-pattern pipelines,
        # reference: pipeline/jetson/h265_test_pattern). Dims round up
        # to whole macroblocks — the generated pattern fills the
        # padding, no crop needed.
        return DeviceTestPatternSource(
            width=-(-spec.width // 16) * 16,
            height=-(-spec.height // 16) * 16,
            fps_num=spec.fps_num, fps_den=spec.fps_den, device=device)
    if spec.kind == "y4m":
        return Y4MFileSource(spec.path, loop=spec.loop)
    if spec.kind == "raw":
        return RawYuvSource(spec.path, spec.width, spec.height,
                            spec.fps_num, spec.fps_den, loop=spec.loop)
    raise ValueError(f"unknown source kind: {spec.kind}")
