"""Peaks of one NVIDIA H100 and the least time a kernel's work can take.

Copied from chip_smoke.py (HBM_BYTES_PER_S and INT32_OPS_PER_S at lines
233-234; H265_INTRA_OPS_PER_CTB and the bound of `kernel_numbers` at lines
865-930), so that the yardstick stays with the benchmark.

The bound of one call is the larger of its bytes over the memory rate and
its integer operations over the 32-bit rate. The bytes count the call's
inputs and outputs once each (not a wrapper's scratch, nor what the kernel
reads again); the operations count what these inputs need, per CTB.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # non-tensor 32-bit rate (fp32 figure)

# K4 per CTB: the 12 luma candidates (about 6 operations a sample) and
# their differences (1); the 48 8x8 Hadamards (24 adds per 8-sample
# vector, 16 vectors, and 128 for |.| and the sum); the 16x16 forward
# and inverse transforms (two stages each way, 16 multiply-adds per
# coefficient and stage); quant and dequant (10 per coefficient) and
# the clamped reconstruction (3); chroma's candidate (6 a sample), its
# residual (1), its 8x8 transform chain (8 multiply-adds per stage),
# quant, dequant and reconstruction (13).
H265_INTRA_OPS_PER_CTB = (12 * 256 * (6 + 1) + 48 * (16 * 24 + 128)
                          + 4 * 2 * 16 * 256 + (10 + 3) * 256
                          + 128 * (6 + 1 + 4 * 2 * 8 + 13))

# K4's inputs and outputs per CTB, in bytes, as ops/h265.py:
# h265_intra_cols takes and returns them: the source planes (uint8 y, u,
# v), then is_intra (bool), mode (int32), mv (2 int32), tu_split (bool),
# the levels (int32: 16x16 luma, two 8x8 chroma) and the reconstruction
# (uint8 y, u, v).
H265_INTRA_BYTES_PER_CTB = ((256 + 64 + 64)
                            + 1 + 4 + 8 + 1 + 4 * (256 + 64 + 64)
                            + (256 + 64 + 64))


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations", whichever bounds)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def h265_intra_bound_s(coded_width: int, coded_height: int):
    """K4's bound for one IDR picture at the coded size."""
    n_ctb = (coded_width // 16) * (coded_height // 16)
    return bound_s(n_ctb * H265_INTRA_BYTES_PER_CTB,
                   n_ctb * H265_INTRA_OPS_PER_CTB)
