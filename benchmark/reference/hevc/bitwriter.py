"""Bitstream writing primitives.

Two writing paths:

- :class:`BitWriter` — a scalar, append-oriented writer for low-volume,
  irregular syntax (NAL headers, SPS/PPS, slice headers).
- :func:`pack_bits` — a fully vectorized variable-length-code packer: given
  parallel arrays ``(values, lengths)`` (one entry per symbol, in stream
  order, ``length == 0`` entries are skipped), produces the packed byte
  string with a prefix-sum + scatter, no Python-level per-symbol loop.
  This is what makes entropy coding (CAVLC symbol streams for ~200k
  4x4 blocks per 1080p frame) fast without native code: the per-symbol
  work is O(1) numpy-vectorized, and bit packing is O(total_bits) in
  numpy.

Also: RBSP emulation prevention (00 00 0x -> 00 00 03 0x) and Annex-B NAL
framing.

Reference behavior being replicated: the bitstream layers that ceracoder
delegated to x264/GStreamer (reference repo has no bitstream writer of its
own; see SURVEY.md §2.2).

Frozen copy of ceracoder_tpu_torch/codec/bitwriter.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

_MAX_CODE_BITS = 32


class BitWriter:
    """MSB-first bit accumulator for headers and other scalar syntax."""

    def __init__(self) -> None:
        self._bits: list[tuple[int, int]] = []  # (value, nbits)
        self._nbits = 0

    @property
    def bit_length(self) -> int:
        return self._nbits

    def u(self, value: int, nbits: int) -> "BitWriter":
        """Write an unsigned fixed-width field, MSB first."""
        if nbits < 0 or (nbits < _MAX_CODE_BITS and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        if value < 0:
            raise ValueError("u() takes non-negative values")
        self._bits.append((value, nbits))
        self._nbits += nbits
        return self

    def flag(self, b: bool | int) -> "BitWriter":
        return self.u(1 if b else 0, 1)

    def ue(self, v: int) -> "BitWriter":
        """Unsigned exp-Golomb (H.264 spec 9.1)."""
        if v < 0:
            raise ValueError("ue() takes non-negative values")
        code = v + 1
        nbits = 2 * (code.bit_length() - 1) + 1
        return self.u(code, nbits)

    def se(self, v: int) -> "BitWriter":
        """Signed exp-Golomb (spec 9.1.1): v>0 -> 2v-1, v<=0 -> -2v."""
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp_trailing_bits(self) -> "BitWriter":
        """stop bit + zero padding to byte boundary (spec 7.3.2.11)."""
        self.u(1, 1)
        pad = (-self._nbits) % 8
        if pad:
            self.u(0, pad)
        return self

    def byte_align_zero(self) -> "BitWriter":
        pad = (-self._nbits) % 8
        if pad:
            self.u(0, pad)
        return self

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (values, lengths) arrays suitable for pack_bits."""
        if not self._bits:
            return (np.zeros(0, np.uint32), np.zeros(0, np.int32))
        vals = np.array([b[0] for b in self._bits], dtype=np.uint64)
        lens = np.array([b[1] for b in self._bits], dtype=np.int32)
        return vals.astype(np.uint32), lens

    def to_bytes(self) -> bytes:
        if self._nbits % 8:
            raise ValueError("bitstream not byte aligned; "
                             "call rbsp_trailing_bits() first")
        vals, lens = self.arrays()
        return pack_bits(vals, lens)


def pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Pack variable-length codes into a byte string, MSB-first.

    values[i] holds the code for symbol i right-aligned; lengths[i] is its
    width in bits (0 = symbol absent, skipped). Purely vectorized.
    """
    if values.shape != lengths.shape:
        raise ValueError("values/lengths shape mismatch")
    if lengths.size == 0:
        return b""
    # drop absent symbols first — in CAVLC slot streams the huge majority
    # of entries are zero-length, and the expansion below is O(n * maxlen)
    keep = lengths > 0
    values = np.ascontiguousarray(values[keep]).astype(np.uint32, copy=False)
    lengths = np.ascontiguousarray(lengths[keep]).astype(np.int32, copy=False)
    if lengths.size == 0:
        return b""
    nbits_max = int(lengths.max())
    if nbits_max > _MAX_CODE_BITS:
        raise ValueError("codes wider than 32 bits not supported")

    ends = np.cumsum(lengths)
    total = int(ends[-1])
    starts = ends - lengths

    # bit k of symbol i (k = 0 is the MSB of that symbol's code)
    k = np.arange(nbits_max, dtype=np.int32)
    shift = lengths[:, None] - 1 - k[None, :]
    valid = shift >= 0
    bits = ((values[:, None] >> np.where(valid, shift, 0)) & 1).astype(np.uint8)
    positions = starts[:, None] + k[None, :]

    bitarr = np.zeros((total + 7) // 8 * 8, dtype=np.uint8)
    bitarr[positions[valid]] = bits[valid]
    return np.packbits(bitarr).tobytes()


def emulation_prevent(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.1.1).

    Any 00 00 followed by a byte <= 03 gets 03 inserted between.
    Vectorized detection; insertion via np.insert (rare in real streams).
    """
    arr = np.frombuffer(rbsp, dtype=np.uint8)
    if arr.size < 3:
        return rbsp
    # candidate positions p: arr[p-2] == 0 and arr[p-1] == 0 and arr[p] <= 3.
    # After an insertion, the zero-run is broken, so scan left-to-right
    # over candidates, skipping ones invalidated by a previous insertion.
    zz = (arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] <= 3)
    cand = np.nonzero(zz)[0] + 2
    if cand.size == 0:
        return rbsp
    keep: list[int] = []
    last = -3
    for p in cand.tolist():
        # overlapping pair 00 00 00 0x: inserting at the first breaks the
        # second only if they share a zero byte (p - last < 2)
        if p - last >= 2:
            keep.append(p)
            last = p
    return np.insert(arr, keep, 3).tobytes()


