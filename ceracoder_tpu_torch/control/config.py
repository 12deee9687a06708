"""INI configuration (reference: src/core/config.c, config.h).

Same file format, sections, keys, defaults, and units convention
(Kbps / ms in the file, bps internal). The serializer mirrors the
TypeScript bindings' behavior of only emitting the section for the
active balancer (reference: bindings/typescript/src/config.ts:33-46).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

# Defaults (reference: src/core/config.c:26-43)
DEF_MIN_BITRATE = 300      # Kbps
DEF_MAX_BITRATE = 6000     # Kbps
DEF_SRT_LATENCY = 2000     # ms
DEF_BALANCER = "adaptive"

DEF_ADAPTIVE_INCR_STEP = 30
DEF_ADAPTIVE_DECR_STEP = 100
DEF_ADAPTIVE_INCR_INT = 500
DEF_ADAPTIVE_DECR_INT = 200
DEF_ADAPTIVE_LOSS_TH = 0.5

DEF_AIMD_INCR_STEP = 50
DEF_AIMD_DECR_MULT = 0.75
DEF_AIMD_INCR_INT = 500
DEF_AIMD_DECR_INT = 200


@dataclass
class AdaptiveConfig:
    incr_step: int = DEF_ADAPTIVE_INCR_STEP       # Kbps
    decr_step: int = DEF_ADAPTIVE_DECR_STEP       # Kbps
    incr_interval: int = DEF_ADAPTIVE_INCR_INT    # ms
    decr_interval: int = DEF_ADAPTIVE_DECR_INT    # ms
    loss_threshold: float = DEF_ADAPTIVE_LOSS_TH


@dataclass
class AimdConfig:
    incr_step: int = DEF_AIMD_INCR_STEP           # Kbps
    decr_mult: float = DEF_AIMD_DECR_MULT
    incr_interval: int = DEF_AIMD_INCR_INT        # ms
    decr_interval: int = DEF_AIMD_DECR_INT        # ms


@dataclass
class CeracoderConfig:
    min_bitrate: int = DEF_MIN_BITRATE            # Kbps
    max_bitrate: int = DEF_MAX_BITRATE            # Kbps
    balancer: str = DEF_BALANCER
    srt_latency: int = DEF_SRT_LATENCY            # ms
    adaptive: AdaptiveConfig = field(default_factory=AdaptiveConfig)
    aimd: AimdConfig = field(default_factory=AimdConfig)


def bitrate_bps(kbps: int) -> int:
    """Kbps -> bps (reference: src/core/config.h:79-81)."""
    return kbps * 1000


def _parse_line(cfg: CeracoderConfig, section: str, key: str, value: str) -> None:
    # (reference: src/core/config.c:83-128)
    def _int(v: str) -> int:
        # atoi semantics: leading int, 0 on garbage
        try:
            return int(v.strip().split()[0])
        except (ValueError, IndexError):
            return 0

    def _float(v: str) -> float:
        try:
            return float(v.strip().split()[0])
        except (ValueError, IndexError):
            return 0.0

    if section == "general":
        if key == "min_bitrate":
            cfg.min_bitrate = _int(value)
        elif key == "max_bitrate":
            cfg.max_bitrate = _int(value)
        elif key == "balancer":
            cfg.balancer = value[:31]
    elif section == "srt":
        if key == "latency":
            cfg.srt_latency = _int(value)
    elif section == "adaptive":
        if key == "incr_step":
            cfg.adaptive.incr_step = _int(value)
        elif key == "decr_step":
            cfg.adaptive.decr_step = _int(value)
        elif key == "incr_interval":
            cfg.adaptive.incr_interval = _int(value)
        elif key == "decr_interval":
            cfg.adaptive.decr_interval = _int(value)
        elif key == "loss_threshold":
            cfg.adaptive.loss_threshold = _float(value)
    elif section == "aimd":
        if key == "incr_step":
            cfg.aimd.incr_step = _int(value)
        elif key == "decr_mult":
            cfg.aimd.decr_mult = _float(value)
        elif key == "incr_interval":
            cfg.aimd.incr_interval = _int(value)
        elif key == "decr_interval":
            cfg.aimd.decr_interval = _int(value)


def config_load(path: str | Path,
                cfg: CeracoderConfig | None = None) -> CeracoderConfig:
    """Parse an INI file into a config, starting from defaults.

    Unknown sections/keys are ignored; '#' and ';' start comments;
    lines before any section header belong to [general]
    (reference: src/core/config.c:130-169).
    """
    if cfg is None:
        cfg = CeracoderConfig()
    text = Path(path).read_text()
    section = "general"
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            end = line.find("]")
            if end != -1:
                section = line[1:end][:63]
            continue
        eq = line.find("=")
        if eq != -1:
            key = line[:eq].strip()
            # strip trailing inline comments the way atoi tolerates them
            value = line[eq + 1:].strip()
            _parse_line(cfg, section, key, value)
    return cfg


def config_serialize(cfg: CeracoderConfig) -> str:
    """Emit INI text; only the active balancer's tuning section is written
    (matches bindings/typescript/src/config.ts:33-46)."""
    lines = [
        "[general]",
        f"min_bitrate = {cfg.min_bitrate}",
        f"max_bitrate = {cfg.max_bitrate}",
        f"balancer = {cfg.balancer}",
        "",
        "[srt]",
        f"latency = {cfg.srt_latency}",
    ]
    if cfg.balancer == "adaptive":
        lines += [
            "",
            "[adaptive]",
            f"incr_step = {cfg.adaptive.incr_step}",
            f"decr_step = {cfg.adaptive.decr_step}",
            f"incr_interval = {cfg.adaptive.incr_interval}",
            f"decr_interval = {cfg.adaptive.decr_interval}",
        ]
    elif cfg.balancer == "aimd":
        lines += [
            "",
            "[aimd]",
            f"incr_step = {cfg.aimd.incr_step}",
            f"decr_mult = {cfg.aimd.decr_mult}",
            f"incr_interval = {cfg.aimd.incr_interval}",
            f"decr_interval = {cfg.aimd.decr_interval}",
        ]
    return "\n".join(lines) + "\n"
