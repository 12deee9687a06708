"""CLI argument builder (reference: bindings/typescript/src/cli.ts).

Builds the argv for the encoder app from validated options; always uses
`-c` (the legacy `-b` path is not emitted, matching the TS bindings —
reference bindings/typescript/README.md:8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ceracoder_tpu_torch.bindings.constants import DEFAULT_CONFIG_PATH


@dataclass
class RunOptions:
    job_file: str
    addr: str
    port: int
    config_path: str = DEFAULT_CONFIG_PATH
    av_delay: Optional[int] = None
    stream_id: Optional[str] = None
    latency: Optional[int] = None
    reduced_pkt_size: bool = False
    balancer: Optional[str] = None


def build_args(opts: RunOptions) -> list[str]:
    args = [opts.job_file, opts.addr, str(opts.port), "-c", opts.config_path]
    if opts.av_delay is not None:
        args += ["-d", str(opts.av_delay)]
    if opts.stream_id:
        args += ["-s", opts.stream_id]
    if opts.latency is not None:
        args += ["-l", str(opts.latency)]
    if opts.reduced_pkt_size:
        args += ["-r"]
    if opts.balancer:
        args += ["-a", opts.balancer]
    return args
