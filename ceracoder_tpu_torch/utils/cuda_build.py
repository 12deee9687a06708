"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source file ``ceracoder_tpu_torch/csrc/<name>.cu``
with a plain C entry point. It is compiled with nvcc for ``sm_90a``
into ``build/`` at the repository root (listed in .gitignore) at first
use, keyed by a hash of the nvcc flags, the headers under ``csrc/`` and
the source (``library_path``), and loaded with ctypes.
Nothing is built or imported while a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu is built: named by a hash of everything
    that shapes the library (the nvcc flags, every csrc/*.cuh header
    and the source), so a change to any of them builds anew."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in [*sorted(CSRC_DIR.glob("*.cuh")), CSRC_DIR / f"{name}.cu"]:
        h.update(b"\0" + src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless `library_path(name)` exists.
    Returns (shared library path, compiler output: ptxas register and
    shared-memory report; empty when nothing was compiled)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    path, _ = build_library(name)
    return ctypes.CDLL(str(path))
