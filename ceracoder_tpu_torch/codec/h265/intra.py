"""HEVC chroma QP mapping (spec Table 8-10).

Copy of `chroma_qp` from ceracoder_tpu/codec/h265/intra.py; the intra
prediction itself runs on the device (ops/h265.py).
"""

from __future__ import annotations

from ceracoder_tpu_torch.codec.h265.tables import CHROMA_SCALE


def chroma_qp(qp_y: int) -> int:
    return int(CHROMA_SCALE[min(max(qp_y, 0), 69)])
