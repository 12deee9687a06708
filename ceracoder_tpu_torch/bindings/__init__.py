"""Host-application bindings — the analog of the reference's
`@ceralive/ceracoder` TypeScript package (reference: bindings/typescript/,
SURVEY.md §2.5): validated config building, CLI argument construction,
run-artifact assembly, process management, and job (pipeline) building.

Copy of ceracoder_tpu/bindings; the process helpers launch this
package's app (`ceracoder-tpu-torch`, else `python -m
ceracoder_tpu_torch`), never the JAX one.
"""

from ceracoder_tpu_torch.bindings.cli import build_args
from ceracoder_tpu_torch.bindings.jobs import JobBuilder, RESOLUTIONS
from ceracoder_tpu_torch.bindings.process import (
    find_executable,
    is_running,
    send_hup,
    send_term,
    spawn,
    write_config,
    write_jobspec,
)
from ceracoder_tpu_torch.bindings.run import build_run_artifacts

__all__ = [
    "build_args", "JobBuilder", "RESOLUTIONS", "find_executable",
    "is_running", "send_hup", "send_term", "spawn", "write_config",
    "write_jobspec", "build_run_artifacts",
]
