"""Defaults mirrored between core and bindings
(reference: bindings/typescript/src/constants.ts).

The values of ceracoder_tpu/bindings/constants.py, except the installed
executable, which is this package's app."""

DEFAULT_MIN_BITRATE = 300      # Kbps
DEFAULT_MAX_BITRATE = 6000     # Kbps
DEFAULT_SRT_LATENCY = 2000     # ms

DEFAULT_ADAPTIVE = dict(incr_step=30, decr_step=100,
                        incr_interval=500, decr_interval=200)
DEFAULT_AIMD = dict(incr_step=50, decr_mult=0.75,
                    incr_interval=500, decr_interval=200)

BALANCERS = ("adaptive", "fixed", "aimd")

DEFAULT_JOBS_DIR = "/usr/share/ceracoder-tpu/jobs"
DEFAULT_CONFIG_PATH = "/tmp/ceracoder.conf"
DEFAULT_EXECUTABLE = "/usr/bin/ceracoder-tpu-torch"
