"""CAVLC residual coding (H.264 spec 9.2) — fully vectorized.

The encoder maps every 4x4 residual block to a fixed-width slot array of
(value, nbits) VLC symbols (zero-width = absent), computed with numpy
array ops across ALL blocks of a frame at once — the per-block sequential
structure of CAVLC (suffix-length adaptation, run_before state) is turned
into a fixed 16-step loop over coefficient index, vectorized across
blocks. Downstream, `bitwriter.pack_bits` concatenates the symbol streams
with a prefix-sum scatter. No per-block Python loops anywhere.

Copy of ceracoder_tpu/codec/h264/cavlc.py: the encoder is the port's
exact host fallback for frames that overflow the device packer; the
scalar decoder (`decode_block`) is its independent twin for round-trip
tests, off every production path.
"""

from __future__ import annotations

import numpy as np

from ceracoder_tpu_torch.codec.h264.cavlc_tables import (
    CHROMA_DC_COEFF_TOKEN_BITS,
    CHROMA_DC_COEFF_TOKEN_LEN,
    CHROMA_DC_TOTAL_ZEROS_BITS,
    CHROMA_DC_TOTAL_ZEROS_LEN,
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    RUN_BEFORE_BITS,
    RUN_BEFORE_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_LEN,
)

# Symbol slots per residual block:
# 1 coeff_token + 3 T1 signs + 16 levels + 1 total_zeros + 14 run_before
BLOCK_SLOTS = 35

# Levels are clamped so level_prefix 15 escapes always suffice (real
# encoders clamp similarly; |level| beyond this only occurs for
# adversarial inputs at QP ~0).
MAX_LEVEL = 2063


def encode_blocks(levels: np.ndarray, nc: np.ndarray,
                  max_coeff: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CAVLC-encode N residual blocks.

    levels: (N, C) int — scan-ordered coefficients, C == max_coeff
            (16 = full 4x4, 15 = AC-only, 4 = chroma DC).
    nc:     (N,) int — nC per block; -1 selects the chroma-DC tables.
    Returns (values, nbits, total_coeff): (N, BLOCK_SLOTS) symbol arrays
    plus per-block TotalCoeff (the decoder-visible nnz used for
    neighboring blocks' nC derivation).
    """
    levels = np.clip(np.asarray(levels, np.int64), -MAX_LEVEL, MAX_LEVEL)
    n, c = levels.shape
    assert c == max_coeff
    nc = np.asarray(nc, np.int64)

    vals = np.zeros((n, BLOCK_SLOTS), np.uint32)
    lens = np.zeros((n, BLOCK_SLOTS), np.int32)

    nz = levels != 0
    total_coeff = nz.sum(axis=1)

    # reverse-scan ordering of the nonzero coefficients:
    # order[:, k] = position of the k-th nonzero counting from the
    # highest frequency downwards
    pos = np.arange(c)
    key = np.where(nz, pos, -1)
    order = np.argsort(-key, axis=1, kind="stable")
    lev_rev = np.take_along_axis(levels, order, axis=1)
    pos_rev = np.take_along_axis(key, order, axis=1)

    # trailing ones: leading run (in reverse order) of |level| == 1, max 3
    is_one = np.abs(lev_rev[:, :3]) == 1
    in_range = pos[None, :3] < total_coeff[:, None]
    run = np.cumprod(is_one & in_range, axis=1)
    t1 = run.sum(axis=1)

    # --- coeff_token
    cls = np.select([nc < 0, nc < 2, nc < 4, nc < 8], [ -1, 0, 1, 2], 3)
    reg = cls >= 0
    ct_len = np.where(
        reg,
        COEFF_TOKEN_LEN[np.maximum(cls, 0), total_coeff, t1],
        CHROMA_DC_COEFF_TOKEN_LEN[np.minimum(total_coeff, 4), t1])
    ct_bits = np.where(
        reg,
        COEFF_TOKEN_BITS[np.maximum(cls, 0), total_coeff, t1],
        CHROMA_DC_COEFF_TOKEN_BITS[np.minimum(total_coeff, 4), t1])
    vals[:, 0] = ct_bits
    lens[:, 0] = ct_len

    # --- trailing-one sign flags (1 bit each: 1 = negative)
    for k in range(3):
        active = k < t1
        vals[:, 1 + k] = np.where(active, (lev_rev[:, k] < 0).astype(np.uint32), 0)
        lens[:, 1 + k] = np.where(active, 1, 0)

    # --- remaining levels, reverse order, adaptive suffix length
    suffix_len = np.where((total_coeff > 10) & (t1 < 3), 1, 0).astype(np.int64)
    for k in range(min(16, c)):
        active = (k >= t1) & (k < total_coeff)
        v = lev_rev[:, k]
        # the first non-T1 level with t1 < 3 has |v| >= 2 guaranteed;
        # bias it down so levelCode is contiguous (spec 9.2.2.1 inverse)
        adj = (k == t1) & (t1 < 3)
        v = v - np.where(adj, np.sign(v), 0)
        level_code = np.where(v > 0, 2 * v - 2, -2 * v - 1)

        sl0 = suffix_len == 0
        # regime 1: plain prefix (suffix_len == 0, code < 14)
        r1 = sl0 & (level_code < 14)
        # regime 2: prefix 14 + 4-bit suffix (suffix_len == 0, code < 30)
        r2 = sl0 & (level_code >= 14) & (level_code < 30)
        # regime 3: suffix_len > 0, prefix < 15
        r3 = ~sl0 & (level_code < (15 << suffix_len))
        # regime 4: escape — prefix 15 + 12-bit suffix
        esc_base = np.where(sl0, 30, 15 << suffix_len)

        sym_val = np.select(
            [r1, r2, r3],
            [np.ones_like(level_code),
             (1 << 4) | (level_code - 14),
             (np.int64(1) << suffix_len) | (level_code & ((np.int64(1) << suffix_len) - 1))],
            (1 << 12) | (level_code - esc_base),
        )
        sym_len = np.select(
            [r1, r2, r3],
            [level_code + 1,
             15 + 4,
             (level_code >> suffix_len) + 1 + suffix_len],
            16 + 12,
        )
        vals[:, 4 + k] = np.where(active, sym_val, 0).astype(np.uint32)
        lens[:, 4 + k] = np.where(active, sym_len, 0)

        # suffix-length adaptation (uses the unadjusted |level|)
        grew = active & (suffix_len == 0)
        suffix_len = np.where(grew, 1, suffix_len)
        bump = active & (np.abs(lev_rev[:, k]) > (3 << (suffix_len - 1))) & (suffix_len < 6)
        suffix_len = np.where(bump, suffix_len + 1, suffix_len)

    # --- total_zeros (only when 0 < TotalCoeff < max_coeff)
    highest = pos_rev[:, 0]
    total_zeros = np.where(total_coeff > 0, highest + 1 - total_coeff, 0)
    has_tz = (total_coeff > 0) & (total_coeff < max_coeff)
    tz_idx = np.clip(total_coeff - 1, 0, 14)
    tz_val = np.clip(total_zeros, 0, 15)
    if max_coeff == 4:
        tzl = CHROMA_DC_TOTAL_ZEROS_LEN[np.clip(tz_idx, 0, 2), np.clip(tz_val, 0, 3)]
        tzb = CHROMA_DC_TOTAL_ZEROS_BITS[np.clip(tz_idx, 0, 2), np.clip(tz_val, 0, 3)]
    else:
        tzl = TOTAL_ZEROS_LEN[tz_idx, tz_val]
        tzb = TOTAL_ZEROS_BITS[tz_idx, tz_val]
    vals[:, 20] = np.where(has_tz, tzb, 0)
    lens[:, 20] = np.where(has_tz, tzl, 0)

    # --- run_before for coefficients 0..tc-2 (reverse order)
    zeros_left = total_zeros.copy()
    for k in range(min(14, c - 1)):
        active = (k < total_coeff - 1) & (zeros_left > 0)
        run_k = np.where(k + 1 < c,
                         pos_rev[:, k] - pos_rev[:, np.minimum(k + 1, c - 1)] - 1,
                         0)
        run_k = np.clip(run_k, 0, 14)
        tbl = np.clip(np.minimum(zeros_left, 7) - 1, 0, 6)
        vals[:, 21 + k] = np.where(active, RUN_BEFORE_BITS[tbl, run_k], 0).astype(np.uint32)
        lens[:, 21 + k] = np.where(active, RUN_BEFORE_LEN[tbl, run_k], 0)
        zeros_left = np.where(active, zeros_left - run_k, zeros_left)

    return vals, lens, total_coeff


# ---------------------------------------------------------------------------
# Reference scalar decoder (for round-trip tests and the verification
# decoder) — deliberately independent code path from the encoder.
# ---------------------------------------------------------------------------

def _read_vlc(reader, len_tbl, bits_tbl):
    """Read one code from a (len, bits) table pair; returns flat index."""
    lens = np.asarray(len_tbl).reshape(-1)
    bits = np.asarray(bits_tbl).reshape(-1)
    code = 0
    nbits = 0
    for _ in range(32):
        code = (code << 1) | reader.u(1)
        nbits += 1
        matches = np.nonzero((lens == nbits) & (bits == code))[0]
        if matches.size:
            return int(matches[0])
    raise ValueError("invalid VLC code")


def decode_block(reader, nc: int, max_coeff: int) -> np.ndarray:
    """Decode one CAVLC residual block (spec 9.2) — scalar reference."""
    if nc < 0:
        idx = _read_vlc(reader, CHROMA_DC_COEFF_TOKEN_LEN,
                        CHROMA_DC_COEFF_TOKEN_BITS)
        tc, t1 = divmod(idx, 4)
    else:
        cls = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        if cls == 3:
            code = reader.u(6)
            if code == 3:
                tc, t1 = 0, 0
            else:
                tc, t1 = code // 4 + 1, code % 4
        else:
            idx = _read_vlc(reader, COEFF_TOKEN_LEN[cls], COEFF_TOKEN_BITS[cls])
            tc, t1 = divmod(idx, 4)

    out = np.zeros(max_coeff, np.int64)
    if tc == 0:
        return out

    levels = []
    for _ in range(t1):
        levels.append(-1 if reader.u(1) else 1)
    suffix_len = 1 if tc > 10 and t1 < 3 else 0
    for i in range(t1, tc):
        prefix = 0
        while reader.u(1) == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("bad level prefix")
        if suffix_len == 0 and prefix == 14:
            suffix_size = 4
        elif prefix >= 15:
            suffix_size = prefix - 3
        else:
            suffix_size = suffix_len
        suffix = reader.u(suffix_size) if suffix_size else 0
        level_code = (min(15, prefix) << suffix_len) + suffix
        if prefix >= 15 and suffix_len == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == t1 and t1 < 3:
            level_code += 2
        val = (level_code + 2) >> 1 if level_code % 2 == 0 else -((level_code + 1) >> 1)
        levels.append(val)
        if suffix_len == 0:
            suffix_len = 1
        if abs(val) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if tc < max_coeff:
        if max_coeff == 4:
            idx = _read_vlc(reader, CHROMA_DC_TOTAL_ZEROS_LEN[tc - 1],
                            CHROMA_DC_TOTAL_ZEROS_BITS[tc - 1])
        else:
            idx = _read_vlc(reader, TOTAL_ZEROS_LEN[tc - 1],
                            TOTAL_ZEROS_BITS[tc - 1])
        total_zeros = idx
    else:
        total_zeros = 0

    runs = []
    zeros_left = total_zeros
    for i in range(tc - 1):
        if zeros_left > 0:
            tbl = min(zeros_left, 7) - 1
            run = _read_vlc(reader, RUN_BEFORE_LEN[tbl], RUN_BEFORE_BITS[tbl])
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)

    pos = -1 + tc + total_zeros  # position of highest-frequency coeff
    for i in range(tc):
        out[pos] = levels[i]
        if i < tc - 1:
            pos -= runs[i] + 1
    return out
