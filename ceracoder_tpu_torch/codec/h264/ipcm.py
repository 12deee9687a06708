"""I_PCM encoder — stage-0 of the codec bring-up.

Emits spec-conformant H.264 streams where every macroblock is I_PCM (raw
samples, spec 7.3.5 mb_type 25 in I slices). Lossless and trivially
parallel; exists to validate the NAL/SPS/PPS/slice-header layers against
a reference decoder before the transform/CAVLC path lands
(SURVEY.md §7.2 "minimum end-to-end slice", step 0).

Copy of ceracoder_tpu/codec/h264/ipcm.py: the port keeps its own copy so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.bitwriter import nal_unit
from ceracoder_tpu_torch.codec.h264.syntax import (
    NAL_IDR,
    NAL_SLICE,
    SLICE_I_ALL,
    PpsConfig,
    SliceConfig,
    SpsConfig,
    write_pps,
    write_slice_header,
    write_sps,
)

MB_TYPE_I_PCM = 25


def encode_ipcm_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      frame_num: int = 0, idr: bool = True,
                      idr_pic_id: int = 0) -> bytes:
    """Encode one 4:2:0 frame as an all-I_PCM slice NAL (no parameter
    sets — prepend write_sps/write_pps for a decodable stream)."""
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError("I_PCM path requires mb-aligned dimensions")
    mbw, mbh = w // 16, h // 16

    wtr = write_slice_header(SliceConfig(
        first_mb=0, slice_type=SLICE_I_ALL, frame_num=frame_num, idr=idr,
        idr_pic_id=idr_pic_id))
    for mby in range(mbh):
        for mbx in range(mbw):
            wtr.ue(MB_TYPE_I_PCM)
            wtr.byte_align_zero()      # pcm_alignment_zero_bit(s)
            yb = y[mby * 16:(mby + 1) * 16, mbx * 16:(mbx + 1) * 16]
            ub = u[mby * 8:(mby + 1) * 8, mbx * 8:(mbx + 1) * 8]
            vb = v[mby * 8:(mby + 1) * 8, mbx * 8:(mbx + 1) * 8]
            for samp in (yb, ub, vb):
                for byte in np.asarray(samp, np.uint8).reshape(-1).tolist():
                    wtr.u(int(byte), 8)
    wtr.rbsp_trailing_bits()
    nal_type = NAL_IDR if idr else NAL_SLICE
    return nal_unit(3, nal_type, wtr.to_bytes())


def encode_ipcm_stream(frames, width: int, height: int) -> bytes:
    """SPS + PPS + one I_PCM IDR per frame; `frames` yields (y, u, v)."""
    out = [write_sps(SpsConfig(width=width, height=height)),
           write_pps(PpsConfig())]
    for i, (y, u, v) in enumerate(frames):
        out.append(encode_ipcm_frame(y, u, v, frame_num=0, idr=True,
                                     idr_pic_id=i % 2))
    return b"".join(out)
