"""HEVC residual_coding syntax (spec 7.3.8.11) for square TUs.

Encodes one TU's quantized coefficients: last-significant position,
coded_sub_block_flags, sig_coeff_flags, greater1/greater2 flags, signs
and Golomb-Rice remainders, with the full context-index derivations of
spec 9.3.4.2.3-9.3.4.2.7. Diagonal scan only (the framework's coding
config never selects the horizontal/vertical scans: luma TUs are 16x16
and chroma TUs 8x8 with cIdx > 0, spec 7.4.9.11).

Validated end to end by libavcodec decoding full intra streams
bit-exactly (tests/test_h265.py) — any wrong context index or
binarization breaks the arithmetic decode loudly.

Frozen copy of ceracoder_tpu_torch/codec/h265/residual.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc.ctx_tables import SIG_CTX_MAP_4x4

# last-significant-coefficient binarization tables (spec 9.3.3.1.2)
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], np.int32)


def diag_scan(n: int) -> np.ndarray:
    """Up-right diagonal scan order for an n x n block: array of
    (x, y) in scan order (spec 6.5.3)."""
    order = []
    for d in range(2 * n - 1):
        # diagonal d: x + y == d, traversed from bottom-left upward
        for x in range(max(0, d - n + 1), min(d, n - 1) + 1):
            y = d - x
            if y < n:
                order.append((x, y))
    return np.array(order, np.int32)


SCAN_4 = diag_scan(4)                 # within a 4x4 sub-block
_SUB_SCANS = {1: diag_scan(1), 2: diag_scan(2), 4: diag_scan(4),
              8: diag_scan(8)}


def sig_ctx_inc(xc: int, yc: int, log2_size: int, c_idx: int,
                csbf_right: int, csbf_below: int) -> int:
    """sig_coeff_flag ctxInc (spec 9.3.4.2.5), diagonal scan."""
    if log2_size == 2:
        sig = int(SIG_CTX_MAP_4x4[(yc << 2) + xc])
    elif xc + yc == 0:
        sig = 0
    else:
        prev = csbf_right + 2 * csbf_below
        xp, yp = xc & 3, yc & 3
        if prev == 0:
            s = xp + yp
            sig = 2 if s == 0 else (1 if s < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (xc >> 2) + (yc >> 2) > 0:
                sig += 3
            sig += 9 if log2_size == 3 else 21   # diag scan
        else:
            sig += 9 if log2_size == 3 else 12
    return sig


def encode_residual(enc, ctx, off, coeffs: np.ndarray, c_idx: int) -> None:
    """Encode one TU's coefficients (n x n int array, raster [y][x]).

    enc: CabacEncoder; ctx: packed context array; off: context layout
    offsets from ctx_tables.build_i_slice_contexts. Must only be called
    when at least one coefficient is nonzero (cbf == 1).
    """
    n = coeffs.shape[0]
    log2n = n.bit_length() - 1
    nsb = n // 4                      # sub-blocks per side
    sub_scan = _SUB_SCANS[nsb]        # sub-block scan order
    n_subs = nsb * nsb

    # full scan position of every coefficient: sub-block scan major,
    # in-sub-block 4x4 scan minor
    # find last significant coefficient in scan order
    last_pos = -1
    last_xy = None
    for si in range(n_subs):
        sx, sy = int(sub_scan[si][0]), int(sub_scan[si][1])
        for pi in range(16):
            x = sx * 4 + int(SCAN_4[pi][0])
            y = sy * 4 + int(SCAN_4[pi][1])
            if coeffs[y][x]:
                last_pos = si * 16 + pi
                last_xy = (x, y)
    assert last_pos >= 0, "cbf must be 0 for all-zero TUs"
    last_x, last_y = last_xy

    # --- last_sig_coeff_{x,y}_prefix/suffix (spec 9.3.4.2.3)
    if c_idx == 0:
        ctx_offset = 3 * (log2n - 2) + ((log2n - 1) >> 2)
        ctx_shift = (log2n + 1) >> 2
    else:
        ctx_offset = 15
        ctx_shift = log2n - 2
    gx = int(GROUP_IDX[last_x])
    gy = int(GROUP_IDX[last_y])
    cmax = (log2n << 1) - 1
    for base, g in (("last_x", gx), ("last_y", gy)):
        for b in range(g):
            enc.encode_bin(ctx, off[base] + (b >> ctx_shift) + ctx_offset, 1)
        if g < cmax:
            enc.encode_bin(ctx, off[base] + (g >> ctx_shift) + ctx_offset, 0)
    if gx > 3:
        nbits = (gx >> 1) - 1
        enc.encode_bypass_bits(last_x - int(MIN_IN_GROUP[gx]), nbits)
    if gy > 3:
        nbits = (gy >> 1) - 1
        enc.encode_bypass_bits(last_y - int(MIN_IN_GROUP[gy]), nbits)

    last_sb = last_pos >> 4
    last_in_sb = last_pos & 15

    # --- coded_sub_block_flag map
    csbf = np.zeros((nsb, nsb), np.int32)
    for si in range(last_sb + 1):
        sx, sy = int(sub_scan[si][0]), int(sub_scan[si][1])
        blk = coeffs[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
        csbf[sy, sx] = 1 if blk.any() else 0
    csbf[int(sub_scan[0][1]), int(sub_scan[0][0])] = 1
    csbf[int(sub_scan[last_sb][1]), int(sub_scan[last_sb][0])] = 1

    gr1_ctx_set_carry = 0     # 1 if previous coded subset ended with ctx 0

    for si in range(last_sb, -1, -1):
        sx, sy = int(sub_scan[si][0]), int(sub_scan[si][1])
        right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
        below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0

        signaled = 0 < si < last_sb
        if signaled:
            ctx_inc = (1 if (right or below) else 0) + (2 if c_idx else 0)
            enc.encode_bin(ctx, off["csbf"] + ctx_inc, int(csbf[sy, sx]))
        if not csbf[sy, sx]:
            continue
        infer_dc = bool(signaled)

        # --- sig_coeff_flag
        start = last_in_sb - 1 if si == last_sb else 15
        sig_list = []                 # scan positions with sig == 1
        if si == last_sb:
            sig_list.append(last_in_sb)
        for pi in range(start, -1, -1):
            x = sx * 4 + int(SCAN_4[pi][0])
            y = sy * 4 + int(SCAN_4[pi][1])
            sig = 1 if coeffs[y][x] else 0
            if pi == 0 and infer_dc and not _any_sig_above(
                    coeffs, sub_scan, si, sx, sy, start):
                # DC inferred significant (spec: inferSbDcSigCoeffFlag)
                sig_list.append(pi)
                break
            base = off["sig"] + (0 if c_idx == 0 else 27)
            inc = sig_ctx_inc(x, y, log2n, c_idx, right, below)
            enc.encode_bin(ctx, base + inc, sig)
            if sig:
                sig_list.append(pi)

        # coefficients of this subset in scan order (descending freq)
        levels = []
        for pi in sig_list:
            x = sx * 4 + int(SCAN_4[pi][0])
            y = sy * 4 + int(SCAN_4[pi][1])
            levels.append(int(coeffs[y][x]))

        # --- greater1 flags (first 8 coeffs)
        ctx_set = (0 if (si == 0 or c_idx > 0) else 2) + gr1_ctx_set_carry
        gr1_base = off["gr1"] + (16 if c_idx else 0) + ctx_set * 4
        gr1_ctx = 1
        first_gr1_pos = -1
        for k, lv in enumerate(levels[:8]):
            flag = 1 if abs(lv) > 1 else 0
            enc.encode_bin(ctx, gr1_base + min(3, gr1_ctx), flag)
            if flag:
                gr1_ctx = 0
                if first_gr1_pos < 0:
                    first_gr1_pos = k
            elif gr1_ctx > 0:
                gr1_ctx += 1
        gr1_ctx_set_carry = 1 if gr1_ctx == 0 else 0

        # --- greater2 flag (first coeff with gr1 == 1)
        gr2_flag = 0
        if first_gr1_pos >= 0:
            gr2_flag = 1 if abs(levels[first_gr1_pos]) > 2 else 0
            gr2_idx = off["gr2"] + (4 if c_idx else 0) + ctx_set
            enc.encode_bin(ctx, gr2_idx, gr2_flag)

        # --- signs (no sign data hiding)
        for lv in levels:
            enc.encode_bypass(1 if lv < 0 else 0)

        # --- abs_level_remaining: presence follows from which flags
        # were coded — k >= 8: always (rem = |lv|-1); k < 8 with
        # gr1 == 1: always unless this is the gr2 coeff with gr2 == 0
        # (rem = |lv|-2, or |lv|-3 after gr2 == 1); k < 8 with
        # gr1 == 0: never (|lv| == 1 exactly).
        rice = 0
        for k, lv in enumerate(levels):
            a = abs(lv)
            if k >= 8:
                present, base_level = True, 1
            elif a > 1:                        # gr1 flag was 1
                if k == first_gr1_pos:
                    present = gr2_flag == 1
                    base_level = 3
                else:
                    present, base_level = True, 2
            else:
                present = False
                base_level = 1
            if present:
                _write_remaining(enc, a - base_level, rice)
                if a > (3 << rice):
                    rice = min(rice + 1, 4)


def _any_sig_above(coeffs, sub_scan, si, sx, sy, start) -> bool:
    """True if any coefficient at scan positions 1..start of this
    sub-block is nonzero (determines DC significance inference)."""
    for pi in range(start, 0, -1):
        x = sx * 4 + int(SCAN_4[pi][0])
        y = sy * 4 + int(SCAN_4[pi][1])
        if coeffs[y][x]:
            return True
    return False



def _write_remaining(enc, sym: int, rice: int) -> None:
    """coeff_abs_level_remaining binarization (spec 9.3.3.10):
    Golomb-Rice with TR prefix up to 3, then exp-Golomb escape."""
    if sym < (3 << rice):
        q = sym >> rice
        enc.encode_bypass_bits((1 << (q + 1)) - 2, q + 1)  # q ones + 0
        if rice:
            enc.encode_bypass_bits(sym & ((1 << rice) - 1), rice)
    else:
        length = rice
        sym -= 3 << rice
        while sym >= (1 << length):
            sym -= 1 << length
            length += 1
        n_ones = 3 + length + 1 - rice
        enc.encode_bypass_bits((1 << n_ones) - 2, n_ones)
        if length:
            enc.encode_bypass_bits(sym, length)
