"""CLI options — mirrors the reference's flag surface
(reference: src/io/cli_options.c:58-132): JOB_FILE ADDR PORT plus
-v -c -d -s -l -r -b -a, with the PIPELINE_FILE positional reinterpreted
as an encode-job spec (SURVEY.md §7.1 step 7)."""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

from ceracoder_tpu_torch import __version__
from ceracoder_tpu_torch.control.registry import balancer_available_text

MIN_LATENCY = 100
MAX_LATENCY = 10000


@dataclass
class CliOptions:
    job_file: str = ""
    addr: str = ""
    port: int = 0
    config_file: Optional[str] = None
    av_delay: int = 0
    stream_id: Optional[str] = None
    latency: Optional[int] = None
    reduced_pkt_size: bool = False
    bitrate_file: Optional[str] = None
    balancer: Optional[str] = None
    stats_file: Optional[str] = None


def usage() -> str:
    return f"""Syntax: ceracoder-tpu-torch JOB_FILE ADDR PORT [options]

Options:
  -v                  Print the version and exit
  -c <config file>    Configuration file (INI format)
  -d <delay>          Audio-video delay in milliseconds
  -s <streamid>       SRT stream ID
  -t <file>           Write per-tick controller state as JSON lines
  -l <latency>        SRT latency in milliseconds
  -r                  Reduced SRT packet size
  -b <bitrate file>   Bitrate settings file (legacy, use -c instead)
  -a <algorithm>      Bitrate balancer algorithm (overrides config)

JOB_FILE is an encode-job spec (see ceracoder_tpu_torch/app/jobspec.py).
ADDR may be an SRT host, `udp` for plain UDP, or a .ts output path.

Send SIGHUP to reload configuration while running.

{balancer_available_text()}
"""


class CliError(SystemExit):
    def __init__(self, msg: str):
        print(msg, file=sys.stderr)
        super().__init__(2)


def parse_args(argv: list[str]) -> CliOptions:
    opts = CliOptions()
    positional = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-v":
            print(f"ceracoder-tpu-torch {__version__}")
            raise SystemExit(0)
        elif a == "-r":
            opts.reduced_pkt_size = True
        elif a in ("-c", "-d", "-s", "-l", "-b", "-a", "-t"):
            if i + 1 >= len(argv):
                raise CliError(f"missing argument for {a}\n\n" + usage())
            val = argv[i + 1]
            i += 1
            if a == "-t":
                opts.stats_file = val
            elif a == "-c":
                opts.config_file = val
            elif a == "-d":
                try:
                    opts.av_delay = int(val)
                except ValueError:
                    raise CliError(f"invalid delay: {val}")
                if not -10000 <= opts.av_delay <= 10000:
                    raise CliError(f"delay out of range: {val}")
            elif a == "-s":
                opts.stream_id = val
            elif a == "-l":
                try:
                    opts.latency = int(val)
                except ValueError:
                    raise CliError(f"invalid latency: {val}")
                if not MIN_LATENCY <= opts.latency <= MAX_LATENCY:
                    raise CliError(
                        f"latency must be {MIN_LATENCY}-{MAX_LATENCY} ms")
            elif a == "-b":
                opts.bitrate_file = val
            elif a == "-a":
                opts.balancer = val
        elif a in ("-h", "--help"):
            print(usage(), file=sys.stderr)
            raise SystemExit(0)
        elif a.startswith("-"):
            raise CliError(f"unknown option {a}\n\n" + usage())
        else:
            positional.append(a)
        i += 1

    if len(positional) != 3:
        raise CliError(usage())
    opts.job_file, opts.addr = positional[0], positional[1]
    try:
        opts.port = int(positional[2])
    except ValueError:
        raise CliError(f"invalid port: {positional[2]}")
    return opts
