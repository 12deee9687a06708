"""Build and load the port's native host libraries.

The C++ is repository code outside the JAX package, in ``native/src``.
Each library the port needs is compiled in place, alone, with g++ into
``build/`` at the repository root (listed in .gitignore) at first use:

- ``hevc_entropy``: the HEVC entropy stage (``hevc_entropy.cc`` with its
  table include ``hevc_tables.inc``);
- ``h264_cabac``: the H.264 CABAC row coder (``h264_cabac.cc``, which
  includes ``hevc_tables.inc`` for the shared arithmetic-coder tables
  and ``h264_tables.inc`` for its context tables);
- ``balancer``: the rate-control core (``balancer.cc``);
- ``audio_enc``: the AAC / Opus encoder shim (``audio_enc.cc``, with
  ``mpegts.cc`` for the output buffer it writes into), linked with
  libavcodec and built only where its headers are (``have_avcodec``,
  the ``HAVE_AVCODEC`` test of native/Makefile);
- ``mpegts``: the native TS muxer and SRT payload packer
  (``mpegts.cc``);
- ``srt_client``: the native SRT client (``srt_client.cc``), linked
  with ``-ldl``: it ``dlopen``s libsrt when first asked, so it builds
  where libsrt is missing too.

A build is keyed by a hash of the compiler flags, its link flags and
every file it compiles or includes (``library_path``), and concurrent
builds (test workers) are serialized by a file lock per library.
Callers load a library under the port's own ctypes declarations; it
never loads ``native/libceracoder_native.so``. Nothing is built while a
module is imported, and a build that fails raises: the port has no
Python fallback for a library it asked for.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]


@dataclass(frozen=True)
class NativeLib:
    """A library built from native/src: the sources compiled, the files
    they only include, and the libraries linked."""

    sources: tuple[str, ...]
    includes: tuple[str, ...] = ()
    link: tuple[str, ...] = ()

    @property
    def files(self) -> tuple[str, ...]:
        return self.sources + self.includes


LIBRARIES = {
    "hevc_entropy": NativeLib(("hevc_entropy.cc",), ("hevc_tables.inc",)),
    "h264_cabac": NativeLib(("h264_cabac.cc",),
                            ("hevc_tables.inc", "h264_tables.inc")),
    "balancer": NativeLib(("balancer.cc",)),
    "audio_enc": NativeLib(("audio_enc.cc", "mpegts.cc"),
                           link=("-lavcodec", "-lavutil")),
    "mpegts": NativeLib(("mpegts.cc",)),
    "srt_client": NativeLib(("srt_client.cc",), link=("-ldl",)),
}


def library_path(name: str) -> Path:
    """Where library `name` is built: named by a hash of the flags, its
    link flags and its files, so a change to any of them builds anew."""
    lib = LIBRARIES[name]
    h = hashlib.sha256("\0".join([*CXX_FLAGS, *lib.link]).encode())
    for f in lib.files:
        h.update(b"\0" + f.encode() + b"\0" + (NATIVE_SRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile library `name` unless `library_path(name)` exists; raise
    RuntimeError with the compiler's output if g++ fails."""
    out = library_path(name)
    if out.exists():
        return out
    lib = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():             # another process built it meanwhile
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               *(str(NATIVE_SRC / s) for s in lib.sources), *lib.link]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {', '.join(lib.sources)} "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def have_avcodec() -> bool:
    """Whether g++ finds the libavcodec headers (native/Makefile's
    HAVE_AVCODEC test); without them the audio library is not built."""
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                          input="#include <libavcodec/avcodec.h>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


@functools.lru_cache(maxsize=None)
def load_hevc_entropy() -> ctypes.CDLL:
    """Build (if needed) and load the HEVC entropy library, once per
    process, with `hevc_entropy_rows` declared (signature of
    native/src/hevc_entropy.cc)."""
    lib = ctypes.CDLL(str(build_library("hevc_entropy")))
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


@functools.lru_cache(maxsize=None)
def load_h264_cabac() -> ctypes.CDLL:
    """Build (if needed) and load the H.264 CABAC row coder, once per
    process, with `h264_cabac_rows` declared (signature of
    native/src/h264_cabac.cc)."""
    lib = ctypes.CDLL(str(build_library("h264_cabac")))
    lib.h264_cabac_rows.restype = ctypes.c_int64
    lib.h264_cabac_rows.argtypes = [
        ctypes.c_int, ctypes.c_int,                    # mbh, mbw
        ctypes.c_int, ctypes.c_int, ctypes.c_int,      # intra, idc, qp
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # hdr b/sz/stride
        ctypes.c_void_p, ctypes.c_void_p,              # mode_l, mode_c
        ctypes.c_void_p, ctypes.c_void_p,              # dc_luma, ac_luma
        ctypes.c_void_p, ctypes.c_void_p,              # skip, mvd
        ctypes.c_void_p,                               # luma_lv
        ctypes.c_void_p, ctypes.c_void_p,              # dc/ac chroma
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # out/cap/sizes
        ctypes.c_int,                                  # n_threads
    ]
    return lib
