"""HEVC CABAC arithmetic coding engine (spec 9.3.4).

The encoder side of the binary arithmetic engine (the port's host spec
also has the decoder, which the benchmark needs not).

Engine tables (rangeTabLps, state transitions) come from
codec/h265/tables.py (normative constants, extracted from the system
libx265 and anchor-validated). The state representation follows x265's
packing: an 8-bit context value c = (pStateIdx << 1) | valMps, with
NEXT_STATE[c][bin] giving the updated packed state.

Replaces the entropy stage of the reference's external HEVC encoders
(reference: pipeline/ *h265* elements; SURVEY.md §2.2, §7.3 hard part
#1: "wrong by one bin = undecodable stream").

Frozen copy of ceracoder_tpu_torch/codec/h265/cabac.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hevc.tables import LPS_TABLE, NEXT_STATE


def init_context(init_value: int, qp: int) -> int:
    """Packed context state from an initValue (spec 9.3.2.2)."""
    qp = min(max(qp, 0), 51)
    m = (init_value >> 4) * 5 - 45
    n = ((init_value & 15) << 3) - 16
    pre = min(max(((m * qp) >> 4) + n, 1), 126)
    if pre <= 63:
        return ((63 - pre) << 1) | 0       # valMps = 0
    return ((pre - 64) << 1) | 1           # valMps = 1


class CabacEncoder:
    """Binary arithmetic encoder (spec 9.3.4.3) with HM-style
    low/bits-left carry handling. Output is bit-granular so the PCM
    path can interleave raw aligned bytes with arithmetic segments."""

    def __init__(self) -> None:
        self._bits: list[tuple[int, int]] = []   # (value, nbits)
        self._nbits = 0
        self.reset_engine()

    def reset_engine(self) -> None:
        """(Re)initialize the arithmetic engine, keeping written output
        and context states (spec 9.3.2.5 — used after PCM samples)."""
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    # -- bit-level output -----------------------------------------------
    def _emit(self, value: int, nbits: int) -> None:
        self._bits.append((value, nbits))
        self._nbits += nbits

    def to_bytes(self) -> bytes:
        if self._nbits % 8:
            raise ValueError("stream not byte-aligned")
        acc = 0
        for v, n in self._bits:
            acc = (acc << n) | (v & ((1 << n) - 1))
        return acc.to_bytes(self._nbits // 8, "big") if self._nbits else b""

    # -- byte output with carry resolution ------------------------------
    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.low &= (1 << (24 - self.bits_left)) - 1
        self.bits_left += 8
        if lead < 0xFF:
            if self.num_buffered > 0:
                self._emit(self.buffered_byte, 8)
                for _ in range(self.num_buffered - 1):
                    self._emit(0xFF, 8)
            self.buffered_byte = lead
            self.num_buffered = 1
        elif lead > 0xFF:
            # carry into buffered bytes
            self._emit(self.buffered_byte + 1, 8)
            for _ in range(self.num_buffered - 1):
                self._emit(0x00, 8)
            self.buffered_byte = lead & 0xFF
            self.num_buffered = 1
        else:  # lead == 0xFF: defer, may still carry
            self.num_buffered += 1

    def _renorm(self) -> None:
        while self.range < 256:
            self.range <<= 1
            self.low <<= 1
            self.bits_left -= 1
            if self.bits_left < 12:
                self._write_out()

    # -- bin coders -----------------------------------------------------
    def encode_bin(self, ctx: np.ndarray, idx: int, binval: int) -> None:
        """Context-coded bin; ctx is a mutable uint8 array of packed
        states, idx the context index."""
        state = int(ctx[idx])
        ps = state >> 1
        mps = state & 1
        lps = int(LPS_TABLE[ps][(self.range >> 6) & 3])
        self.range -= lps
        if binval != mps:
            self.low += self.range
            self.range = lps
        ctx[idx] = NEXT_STATE[state][binval]
        self._renorm()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bypass_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, binval: int) -> None:
        """end_of_slice_segment_flag / pcm_flag (spec 9.3.4.3.5)."""
        self.range -= 2
        if binval:
            self.low += self.range
            self.range = 2
        self._renorm()

    def finish(self) -> None:
        """Flush the engine's pending interval bits (HM finish()):
        resolves carry, emits the buffered bytes and the remaining
        (24 - bits_left) bits of low. Does NOT write a stop bit —
        callers append stop/alignment per the syntax location."""
        if self.low >> (32 - self.bits_left):
            # carry
            self._emit(self.buffered_byte + 1, 8)
            for _ in range(self.num_buffered - 1):
                self._emit(0x00, 8)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self._emit(self.buffered_byte, 8)
                for _ in range(self.num_buffered - 1):
                    self._emit(0xFF, 8)
        self.num_buffered = 0
        pend = 24 - self.bits_left
        if pend:
            self._emit((self.low >> 8) & ((1 << pend) - 1), pend)

    def align_one(self) -> None:
        """Write a '1' then zero bits to the next byte boundary (HM
        encodePCMAlignBits / rbsp stop+align)."""
        self._emit(1, 1)
        pad = (-self._nbits) % 8
        if pad:
            self._emit(0, pad)


