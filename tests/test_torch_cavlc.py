"""The port's scalar CAVLC block decoder (ceracoder_tpu_torch/codec/h264/
cavlc.py: decode_block) as the decode twin of its vectorized encoder
(encode_blocks), on the port's own pack_bits and BitReader: the cases of
tests/test_cavlc.py, each a case of one parametrised test. Every decoded
block must equal the block coded (clamped to MAX_LEVEL) and the JAX
decoder's reading of the same bytes."""

import numpy as np
import pytest
import torch

from ceracoder_tpu.codec.bitwriter import BitReader as JReader
from ceracoder_tpu.codec.h264.cavlc import decode_block as j_decode
from ceracoder_tpu_torch.codec.bitwriter import BitReader, pack_bits
from ceracoder_tpu_torch.codec.h264.cavlc import (
    MAX_LEVEL,
    decode_block,
    encode_blocks,
)

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)


def sparse_blocks(rng, n, c, density, mag):
    lv = rng.integers(-mag, mag + 1, size=(n, c))
    mask = rng.random((n, c)) < density
    return (lv * mask).astype(np.int64)


def _luma(nc, density):
    rng = np.random.default_rng(nc * 100 + int(density * 10))
    return [(sparse_blocks(rng, 200, 16, density, 8), np.full(200, nc), 16)]


def _ac15(density):
    rng = np.random.default_rng(int(density * 100))
    return [(sparse_blocks(rng, 200, 15, density, 5),
             rng.integers(0, 20, 200), 15)]


def _chroma_dc():
    rng = np.random.default_rng(7)
    return [(sparse_blocks(rng, 300, 4, 0.5, 6), np.full(300, -1), 4)]


def _large_levels():
    """Levels large enough to exercise every escape regime."""
    lv = np.zeros((6, 16), np.int64)
    lv[0, 0] = 500
    lv[1, 0] = -2000
    lv[2, :4] = [900, -900, 800, -700]
    lv[3, :3] = [7, -25, 100]          # suffix growth chain
    lv[4, :16] = 1                     # all trailing ones territory
    lv[5, 0] = 16
    return [(lv, np.zeros(6), 16)]


def _level_clamp():
    lv = np.zeros((2, 16), np.int64)
    lv[0, 0] = 100000                  # beyond MAX_LEVEL: clamped
    lv[1, 3] = -100000
    return [(lv, np.zeros(2), 16)]


def _empty_and_single():
    lv = np.zeros((4, 16), np.int64)
    lv[1, 0] = 1
    lv[2, 15] = -1
    lv[3, 7] = 3
    return [(lv, np.array([0, 1, 5, 9]), 16)]


def _mixed():
    """A stream mixing block kinds, like a real MB layer: one 16-block,
    then one chroma DC block, per MB."""
    rng = np.random.default_rng(42)
    return [(sparse_blocks(rng, 50, 16, 0.3, 10), rng.integers(0, 12, 50),
             16),
            (sparse_blocks(rng, 50, 4, 0.6, 4), np.full(50, -1), 4)]


CASES = {
    **{f"luma_nc{nc}_d{d}": (_luma, (nc, d))
       for nc in (0, 1, 2, 3, 4, 7, 8, 16) for d in (0.05, 0.2, 0.5, 0.95)},
    **{f"ac15_d{d}": (_ac15, (d,)) for d in (0.1, 0.5, 0.9)},
    "chroma_dc": (_chroma_dc, ()),
    "large_levels": (_large_levels, ()),
    "level_clamp": (_level_clamp, ()),
    "empty_and_single": (_empty_and_single, ()),
    "mixed_nc_stream": (_mixed, ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_block_roundtrip(case):
    make, args = CASES[case]
    groups = make(*args)
    coded = [encode_blocks(lv, np.asarray(nc), c) for lv, nc, c in groups]
    # interleave the groups block by block (MB order)
    vals = np.stack([v for v, _, _ in coded], 1).reshape(-1)
    lens = np.stack([n for _, n, _ in coded], 1).reshape(-1)
    data = pack_bits(vals, lens)
    reader, jreader = BitReader(data), JReader(data)
    n = len(groups[0][0])
    for i in range(n):
        for lv, nc, c in groups:
            got = decode_block(reader, int(nc[i]), c)
            assert np.array_equal(got, np.clip(lv[i], -MAX_LEVEL, MAX_LEVEL))
            assert np.array_equal(got, j_decode(jreader, int(nc[i]), c))
    assert reader.pos == jreader.pos == int(lens.sum())
    if case == "empty_and_single":
        assert coded[0][2].tolist() == [0, 1, 1, 1]
