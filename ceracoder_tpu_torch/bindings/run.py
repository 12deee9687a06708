"""Run-artifact assembly (reference: bindings/typescript/src/run.ts:34-104):
read + merge an existing config file, validate, and produce the
{config, ini, args} bundle a supervisor needs to (re)launch the app."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ceracoder_tpu_torch.bindings.cli import RunOptions, build_args
from ceracoder_tpu_torch.control.config import (
    CeracoderConfig,
    config_load,
    config_serialize,
)
from ceracoder_tpu_torch.control.registry import balancer_find
from ceracoder_tpu_torch.control.types import ABS_MAX_BITRATE, MIN_BITRATE


class RunValidationError(ValueError):
    pass


@dataclass
class RunArtifacts:
    config: CeracoderConfig
    ini: str
    args: list[str]


def _validate(cfg: CeracoderConfig) -> None:
    min_bps, max_bps = cfg.min_bitrate * 1000, cfg.max_bitrate * 1000
    if not (MIN_BITRATE <= min_bps <= ABS_MAX_BITRATE):
        raise RunValidationError(f"min_bitrate out of range: {cfg.min_bitrate}")
    if not (MIN_BITRATE <= max_bps <= ABS_MAX_BITRATE):
        raise RunValidationError(f"max_bitrate out of range: {cfg.max_bitrate}")
    if min_bps > max_bps:
        raise RunValidationError("min_bitrate > max_bitrate")
    if balancer_find(cfg.balancer) is None:
        raise RunValidationError(f"unknown balancer: {cfg.balancer}")
    if not 100 <= cfg.srt_latency <= 10000:
        raise RunValidationError(f"latency out of range: {cfg.srt_latency}")


def build_run_artifacts(opts: RunOptions,
                        overrides: Optional[dict] = None) -> RunArtifacts:
    """Merge (existing config file) <- overrides, validate, emit."""
    cfg = CeracoderConfig()
    path = Path(opts.config_path)
    if path.exists():
        config_load(path, cfg)
    for key, val in (overrides or {}).items():
        if key in ("min_bitrate", "max_bitrate", "balancer", "srt_latency"):
            setattr(cfg, key, val)
        elif key.startswith("adaptive."):
            setattr(cfg.adaptive, key.split(".", 1)[1], val)
        elif key.startswith("aimd."):
            setattr(cfg.aimd, key.split(".", 1)[1], val)
        else:
            raise RunValidationError(f"unknown config key: {key}")
    _validate(cfg)
    return RunArtifacts(config=cfg, ini=config_serialize(cfg),
                        args=build_args(opts))
