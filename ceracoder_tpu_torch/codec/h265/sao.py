"""HEVC Sample Adaptive Offset (spec 8.7.3): the encoder's integer
rate constants.

Copy of the constants of ceracoder_tpu/codec/h265/sao.py that the
device estimator (ops/h265.py: sao_estimate_dev) reads; the port keeps
its own copy so that it imports nothing of the JAX package. The
estimator keeps a CTB's offsets when their distortion gain (an integer
sum of squared differences) exceeds lambda * bits / 16.
"""

from __future__ import annotations

# integer rate-distortion lambda per QP (HM-style
# 0.57 * 2^((qp-12)/3), scaled by 16), a table so that every path
# shares the exact integers
SAO_LAMBDA = tuple(
    max(1, int(0.57 * (2.0 ** ((q - 12) / 3.0)) * 16))
    for q in range(70))

# approximate syntax cost in bits: type + offsets + class/band/signs.
# At CTB 16 the largest possible luma gain is 256 * 7^2 ~= 12.5k SSD,
# so past qp ~40 the lambda-scaled cost always wins and SAO turns
# itself off: it pays mainly at low and middle QPs on banded or ringing
# content.
SAO_BITS_LUMA = 24
SAO_BITS_CHROMA = 34
