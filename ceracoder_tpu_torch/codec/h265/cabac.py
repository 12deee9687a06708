"""HEVC CABAC context initialisation (spec 9.3.2.2).

Copy of `init_context` from ceracoder_tpu/codec/h265/cabac.py, the only
part of the CABAC engine the port needs: the native entropy stage
(native/src/hevc_entropy.cc) codes the bins, and the host builds its
initial context states (codec/h265/ctx_tables.py). The state packing
follows x265: c = (pStateIdx << 1) | valMps.
"""

from __future__ import annotations


def init_context(init_value: int, qp: int) -> int:
    """Packed context state from an initValue (spec 9.3.2.2)."""
    qp = min(max(qp, 0), 51)
    m = (init_value >> 4) * 5 - 45
    n = ((init_value & 15) << 3) - 16
    pre = min(max(((m * qp) >> 4) + n, 1), 126)
    if pre <= 63:
        return ((63 - pre) << 1) | 0       # valMps = 0
    return ((pre - 64) << 1) | 1           # valMps = 1
