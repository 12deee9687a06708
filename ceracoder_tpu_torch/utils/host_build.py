"""Build and load the native HEVC entropy stage for the port.

The stage is repository code outside the JAX package:
``native/src/hevc_entropy.cc`` with its table include
``native/src/hevc_tables.inc``. It is compiled in place, alone, with
g++ into ``build/`` at the repository root (listed in .gitignore) at
first use, keyed by a hash of the compiler flags, the include and the
source (``library_path``), and loaded with ctypes under the port's own
declaration of ``hevc_entropy_rows``. Concurrent builders (test
workers) are serialized by a file lock. Nothing is built while a
module is imported, and a build that fails raises: the port has no
Python entropy fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("hevc_entropy.cc", "hevc_tables.inc")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]


def library_path() -> Path:
    """Where hevc_entropy.cc is built: named by a hash of the flags, the
    source and its include, so a change to any of them builds anew."""
    h = hashlib.sha256("\0".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(b"\0" + name.encode() + b"\0"
                 + (NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"libhevc_entropy-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile hevc_entropy.cc unless `library_path()` exists; raise
    RuntimeError with the compiler's output if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".hevc_entropy.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():             # another process built it meanwhile
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               str(NATIVE_SRC / "hevc_entropy.cc")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for hevc_entropy.cc "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_hevc_entropy() -> ctypes.CDLL:
    """Build (if needed) and load the HEVC entropy library, once per
    process, with `hevc_entropy_rows` declared (signature of
    native/src/hevc_entropy.cc)."""
    lib = ctypes.CDLL(str(build_library()))
    lib.hevc_entropy_rows.restype = ctypes.c_int64
    lib.hevc_entropy_rows.argtypes = [
        ctypes.c_int, ctypes.c_int,                    # nch, ncw
        ctypes.c_int, ctypes.c_int, ctypes.c_int,      # idr, is_b, tiles
        ctypes.c_int, ctypes.c_void_p,                 # tu split en/flags
        ctypes.c_void_p,                               # sao params
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # hdr b/bits/stride
        ctypes.c_void_p, ctypes.c_int,                 # ctx_init, n_ctx
        ctypes.c_void_p,                               # offsets
        ctypes.c_void_p, ctypes.c_void_p,              # intra/mode
        ctypes.c_void_p, ctypes.c_void_p,              # mv, mv1
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # levels y/cb/cr
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # out/cap/sizes
        ctypes.c_int,                                  # n_threads
    ]
    return lib
