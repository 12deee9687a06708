"""The reference's matrix products of integers, and the lower-precision
products of the control.

The configuration states integer-exact transforms: the program computes
every matrix product of the codec (transforms, Hadamard SATD) as a
float64 product of integers, exact below 2**53. The reference computes
them in int64. `set_mode` puts the control's precision in their place:
"float32" (exact wherever the sums stay below 2**24) or "tf32" (inputs
rounded to 10 mantissa bits, as a tensor core takes them, float32 sums).
"""

from __future__ import annotations

import numpy as np

MODES = ("exact", "float32", "tf32")
_mode = "exact"


def set_mode(mode: str) -> None:
    global _mode
    if mode not in MODES:
        raise ValueError(f"precision mode {mode!r} not in {MODES}")
    _mode = mode


def mode() -> str:
    return _mode


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest (ties to even) at 10 mantissa
    bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def imatmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b of integer arrays as int64, in the current mode."""
    if _mode == "exact":
        return np.asarray(a, np.int64) @ np.asarray(b, np.int64)
    fa = np.asarray(a, np.float32)
    fb = np.asarray(b, np.float32)
    if _mode == "tf32":
        fa, fb = _tf32(fa), _tf32(fb)
    return np.rint(fa @ fb).astype(np.int64)
