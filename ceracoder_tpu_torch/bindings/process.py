"""Process management (reference: bindings/typescript/src/process.ts).

Exec resolution (explicit path > PATH lookup > default install path),
spawn, SIGHUP config reload, SIGTERM, liveness — without shelling out to
killall/pgrep: we track PIDs directly.

Every step of the resolution names this package's app
(`ceracoder-tpu-torch`, `python -m ceracoder_tpu_torch`); none can
reach the JAX app's `ceracoder-tpu` or `-m ceracoder_tpu`.
"""

from __future__ import annotations

import shutil
import signal
import subprocess
import sys
from pathlib import Path
from typing import Optional

from ceracoder_tpu_torch.bindings.constants import DEFAULT_EXECUTABLE


def find_executable(explicit: Optional[str] = None) -> list[str]:
    """Resolve how to launch the encoder app
    (reference: process.ts:66-99). Returns an argv prefix."""
    if explicit:
        return [explicit]
    found = shutil.which("ceracoder-tpu-torch")
    if found:
        return [found]
    if Path(DEFAULT_EXECUTABLE).exists():
        return [DEFAULT_EXECUTABLE]
    # fallback: run the module with this interpreter
    return [sys.executable, "-m", "ceracoder_tpu_torch"]


def spawn(args: list[str], executable: Optional[str] = None,
          **popen_kwargs) -> subprocess.Popen:
    """Launch the encoder (reference: spawnCeracoder, process.ts:129)."""
    return subprocess.Popen(find_executable(executable) + args,
                            **popen_kwargs)


def send_hup(proc: subprocess.Popen) -> bool:
    """Config reload (reference: sendHup, process.ts:152)."""
    if proc.poll() is not None:
        return False
    proc.send_signal(signal.SIGHUP)
    return True


def send_term(proc: subprocess.Popen, wait_s: float = 5.0) -> bool:
    """Graceful stop (reference: sendTerm, process.ts:175)."""
    if proc.poll() is not None:
        return True
    proc.terminate()
    try:
        proc.wait(timeout=wait_s)
        return True
    except subprocess.TimeoutExpired:
        return False


def is_running(proc: subprocess.Popen) -> bool:
    """Liveness (reference: isRunning, process.ts:195)."""
    return proc.poll() is None


def write_config(path: str | Path, ini_text: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(ini_text)


def write_jobspec(path: str | Path, jobspec_text: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(jobspec_text)
