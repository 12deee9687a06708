"""Variable-length bitstream window merging (K1).

The entropy stage (codec/h264/device_entropy.py) reduces each row's
symbol stream to per-chunk word-window partials: chunk c's symbols
contribute bit-disjoint values to a WIN-word window starting at the
chunk's first word sw[c]. What remains is the merge

    words[r, sw[r,c] : sw[r,c]+WIN] += partials[r,c]   for every chunk

at data-dependent offsets — a scatter. On the TPU this was the Pallas
kernel ceracoder_tpu/ops/bitpack.py:merge_windows (production used its
jnp twin `tree_merge`). Here it is the CUDA kernel
csrc/merge_windows.cu (one CTA per row, its loads all in flight at
once; launch geometry from `merge_geometry`), with `merge_windows_ref`
as its plain PyTorch version. Both are an exact scatter-add mod 2^32
that drops words at or past capw_pad (and before 0); on every row
whose words reach the bitstream (no chunk wider than WIN-1 words,
total within capacity) that equals `tree_merge`. Neither wraps words
around a 128-lane window as the Pallas kernel does.

Words travel as int32 tensors holding uint32 bit patterns (torch's
uint32 lacks shifts on the CPU); `u32_to_i32` / `i32_to_u32` convert
exactly to and from int64 values in [0, 2^32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

WIN = 64                    # partial window width (words)
MAX_SMEM_BYTES = 232448     # dynamic shared memory one CTA can use (H100)
M32 = 0xFFFFFFFF
MERGE_THREADS = 1024        # threads per CTA of the K1 kernel
MERGE_VECS = 4              # 16-byte partial vectors a thread loads at once


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def merge_windows_ref(sw: torch.Tensor, partials: torch.Tensor,
                      capw_pad: int) -> torch.Tensor:
    """Plain PyTorch version of K1.

    sw: (R, nch) int32 window start words; partials: (R, nch, WIN)
    int32 (uint32 bit patterns). Returns (R, capw_pad) int32 words: an
    int64 scatter-add of every partial word at sw + k, mod 2^32, with
    words at or past capw_pad (or before 0) dropped."""
    r, nch = sw.shape
    k = torch.arange(WIN, device=sw.device)
    idx = sw.to(torch.int64)[:, :, None] + k
    idx = torch.where((idx >= 0) & (idx < capw_pad), idx, capw_pad)
    buf = torch.zeros((r, capw_pad + 1), dtype=torch.int64, device=sw.device)
    buf.scatter_add_(1, idx.reshape(r, nch * WIN),
                     i32_to_u32(partials).reshape(r, nch * WIN))
    return u32_to_i32(buf[:, :capw_pad] & M32)


class MergeGeometry(NamedTuple):
    """Launch geometry of the K1 kernel for one (rows, nch, capw_pad)."""
    grid: int            # CTAs: one per row
    rounds: int          # load rounds of MERGE_THREADS * MERGE_VECS vectors
    smem_bytes: int      # dynamic shared memory per CTA


def merge_geometry(rows: int, nch: int, capw_pad: int) -> MergeGeometry:
    """The CTA of row r takes all of the row's nch * 16 partial vectors
    (thread t of round j loads vectors j*T*V + k*T + t, k < V, with
    T = MERGE_THREADS and V = MERGE_VECS) and owns all of its capw_pad
    words, held in shared memory as whole 16-byte vectors
    (csrc/merge_windows.cu)."""
    per_round = MERGE_THREADS * MERGE_VECS
    rounds = max(1, -(-nch * (WIN // 4) // per_round))
    return MergeGeometry(rows, rounds, -(-capw_pad // 4) * 16)


def _check(sw: torch.Tensor, partials: torch.Tensor,
           capw_pad: int) -> MergeGeometry:
    """Raise on what the kernel does not take; return its geometry."""
    if sw.dtype != torch.int32 or partials.dtype != torch.int32:
        raise TypeError("merge_windows takes int32 sw and partials, got "
                        f"{sw.dtype} and {partials.dtype}")
    if sw.dim() != 2 or partials.shape != (*sw.shape, WIN):
        raise ValueError(f"shapes {tuple(sw.shape)} / "
                         f"{tuple(partials.shape)}: need (R, nch) and "
                         f"(R, nch, {WIN})")
    if sw.device != partials.device:
        raise ValueError("sw and partials lie on different devices")
    if not (sw.is_contiguous() and partials.is_contiguous()):
        raise ValueError("merge_windows needs contiguous inputs")
    if capw_pad <= 0:
        raise ValueError(f"capw_pad={capw_pad}: need at least one word")
    geo = merge_geometry(*sw.shape, capw_pad)
    if geo.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"capw_pad={capw_pad} words do not fit one "
                         f"CTA's shared memory ({MAX_SMEM_BYTES} bytes)")
    # the kernel loads partials as 16-byte vectors
    if partials.data_ptr() % 16:
        raise ValueError("merge_windows needs partials 16-byte aligned")
    return geo


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point (built and loaded at first use)."""
    from ceracoder_tpu_torch.utils.cuda_build import load_library

    fn = load_library("merge_windows").merge_windows_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def merge_windows(sw: torch.Tensor, partials: torch.Tensor,
                  capw_pad: int) -> torch.Tensor:
    """words[r, sw[r,c]+k] += partials[r,c,k] (K1).

    On a CUDA tensor this launches the kernel of csrc/merge_windows.cu
    on the current stream (or raises); on a CPU tensor it runs
    `merge_windows_ref`. `merge_windows.launches` counts kernel
    launches."""
    geo = _check(sw, partials, capw_pad)
    if sw.device.type == "cpu":
        return merge_windows_ref(sw, partials, capw_pad)
    if sw.device.type != "cuda":
        raise ValueError(f"merge_windows: unsupported device {sw.device}")
    r, nch = sw.shape
    out = torch.empty((r, capw_pad), dtype=torch.int32, device=sw.device)
    if r == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(sw.device):
        stream = torch.cuda.current_stream(sw.device).cuda_stream
        err = launch(sw.data_ptr(), partials.data_ptr(), out.data_ptr(),
                     r, nch, capw_pad, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"merge_windows kernel launch failed: CUDA "
                           f"error {err}")
    merge_windows.launches += 1
    return out


merge_windows.launches = 0
