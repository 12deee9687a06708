"""MPEG-TS muxer (ISO 13818-1) for H.264/HEVC elementary streams + AAC.

Replaces the reference's `mpegtsmux` GStreamer element (SURVEY.md §2.2).
Produces 188-byte TS packets: PAT + PMT on every keyframe, PES with PTS
(and DTS when they differ), PCR on access-unit starts, per-PID
continuity counters. Packetization is numpy-sliced, not a per-packet
Python loop.
"""

from __future__ import annotations

import numpy as np

TS_PACKET = 188
TS_SYNC = 0x47

PAT_PID = 0x0000
PMT_PID = 0x1000
VIDEO_PID = 0x0100
AUDIO_PID = 0x0101

STREAM_TYPE_H264 = 0x1B
STREAM_TYPE_HEVC = 0x24
STREAM_TYPE_AAC_ADTS = 0x0F
STREAM_TYPE_PRIVATE = 0x06     # Opus rides private PES (TS draft)
PES_PRIVATE_SID = 0xBD         # private_stream_1 (Opus)

PES_VIDEO_SID = 0xE0
PES_AUDIO_SID = 0xC0

_CRC_TABLE = None


def _crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 (poly 0x04C11DB7, init 0xFFFFFFFF, no reflection)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i << 24)
            for _ in range(8):
                c = np.uint32((c << 1) ^ 0x04C11DB7) if c & 0x80000000 \
                    else np.uint32(c << 1)
            tbl[i] = c
        _CRC_TABLE = tbl
    crc = np.uint32(0xFFFFFFFF)
    for b in data:
        crc = np.uint32((crc << 8) ^ _CRC_TABLE[(crc >> 24) ^ b])
    return int(crc)


def _psi_packet(pid: int, table: bytes, cc: int) -> bytes:
    """One TS packet carrying a PSI section (pointer_field = 0)."""
    payload = b"\x00" + table
    header = bytes([TS_SYNC, 0x40 | (pid >> 8), pid & 0xFF, 0x10 | cc])
    pad = TS_PACKET - 4 - len(payload)
    return header + payload + b"\xff" * pad


def _pat_section() -> bytes:
    body = bytes([
        0x00,              # table_id: PAT
    ])
    data = (b"\x00\x01"    # transport_stream_id
            b"\xc1"        # version 0, current_next = 1
            b"\x00\x00"    # section_number, last_section_number
            b"\x00\x01"    # program_number 1
            + bytes([0xE0 | (PMT_PID >> 8), PMT_PID & 0xFF]))
    length = len(data) + 4  # + CRC
    sec = body + bytes([0xB0 | (length >> 8), length & 0xFF]) + data
    return sec + _crc32_mpeg(sec).to_bytes(4, "big")


def _pmt_section(video_stream_type: int, with_audio: bool,
                 audio_kind: str = "aac",
                 audio_channels: int = 2) -> bytes:
    streams = bytes([video_stream_type,
                     0xE0 | (VIDEO_PID >> 8), VIDEO_PID & 0xFF,
                     0xF0, 0x00])
    if with_audio and audio_kind == "opus":
        # Opus-in-TS: private stream_type + 'Opus' registration and
        # the DVB extension descriptor (0x7F ext 0x80,
        # channel_config_code: 1 = mono, 2 = stereo)
        desc = (bytes([0x05, 4]) + b"Opus"
                + bytes([0x7F, 2, 0x80, audio_channels & 0xFF]))
        streams += bytes([STREAM_TYPE_PRIVATE,
                          0xE0 | (AUDIO_PID >> 8), AUDIO_PID & 0xFF,
                          0xF0 | (len(desc) >> 8), len(desc) & 0xFF])             + desc
    elif with_audio:
        streams += bytes([STREAM_TYPE_AAC_ADTS,
                          0xE0 | (AUDIO_PID >> 8), AUDIO_PID & 0xFF,
                          0xF0, 0x00])
    data = (b"\x00\x01"    # program_number
            b"\xc1\x00\x00"
            + bytes([0xE0 | (VIDEO_PID >> 8), VIDEO_PID & 0xFF])  # PCR PID
            + b"\xf0\x00"  # program_info_length 0
            + streams)
    length = len(data) + 4
    sec = bytes([0x02, 0xB0 | (length >> 8), length & 0xFF]) + data
    return sec + _crc32_mpeg(sec).to_bytes(4, "big")


def _pes_header(stream_id: int, pts90: int, dts90: int | None,
                payload_len: int) -> bytes:
    def ts_33(v, tag):
        v &= (1 << 33) - 1
        return bytes([
            (tag << 4) | (((v >> 30) & 7) << 1) | 1,
            (v >> 22) & 0xFF,
            (((v >> 15) & 0x7F) << 1) | 1,
            (v >> 7) & 0xFF,
            ((v & 0x7F) << 1) | 1,
        ])

    has_dts = dts90 is not None and dts90 != pts90
    flags = 0xC0 if has_dts else 0x80
    hdata = ts_33(pts90, 3 if has_dts else 2)
    if has_dts:
        hdata += ts_33(dts90, 1)
    # PES_packet_length: 0 allowed for video; set exact for audio
    plen = 0 if stream_id == PES_VIDEO_SID else 3 + len(hdata) + payload_len
    if plen > 0xFFFF:
        plen = 0
    return (b"\x00\x00\x01" + bytes([stream_id])
            + plen.to_bytes(2, "big")
            + bytes([0x80, flags, len(hdata)]) + hdata)


class TsMuxer:
    """Stateful TS muxer for one program (video + optional AAC audio)."""

    def __init__(self, video_stream_type: int = STREAM_TYPE_H264,
                 with_audio: bool = False, audio_kind: str = "aac",
                 audio_channels: int = 2):
        self.video_stream_type = video_stream_type
        self.with_audio = with_audio
        self.audio_kind = audio_kind
        self.audio_channels = audio_channels
        self._cc = {PAT_PID: 0, PMT_PID: 0, VIDEO_PID: 0, AUDIO_PID: 0}

    def _bump_cc(self, pid: int, n: int) -> np.ndarray:
        start = self._cc[pid]
        self._cc[pid] = (start + n) % 16
        return (start + np.arange(n)) % 16

    def _packetize(self, pid: int, pes: bytes, pcr90: int | None) -> bytes:
        """Split one PES packet into TS packets (numpy-sliced)."""
        data = np.frombuffer(pes, np.uint8)
        # first packet may carry a PCR adaptation field (8 bytes)
        first_cap = TS_PACKET - 4 - (8 if pcr90 is not None else 0)
        rest = max(0, data.size - first_cap)
        n_rest = (rest + 183) // 184
        n = 1 + n_rest
        out = np.full((n, TS_PACKET), 0xFF, np.uint8)
        cc = self._bump_cc(pid, n)

        out[:, 0] = TS_SYNC
        out[:, 1] = pid >> 8
        out[0, 1] |= 0x40                      # PUSI on first
        out[:, 2] = pid & 0xFF
        out[:, 3] = 0x10 | cc                  # payload only (patched below)

        # first packet
        if pcr90 is not None:
            pcr_base = pcr90 & ((1 << 33) - 1)
            out[0, 3] = 0x30 | cc[0]           # adaptation + payload
            out[0, 4] = 7                      # adaptation_field_length
            out[0, 5] = 0x10                   # PCR flag
            out[0, 6] = (pcr_base >> 25) & 0xFF
            out[0, 7] = (pcr_base >> 17) & 0xFF
            out[0, 8] = (pcr_base >> 9) & 0xFF
            out[0, 9] = (pcr_base >> 1) & 0xFF
            out[0, 10] = ((pcr_base & 1) << 7) | 0x7E
            out[0, 11] = 0
            head = 12
        else:
            head = 4
        take0 = min(data.size, TS_PACKET - head)
        out[0, head:head + take0] = data[:take0]
        if take0 < TS_PACKET - head:
            # short PES: pad first packet via enlarged adaptation field.
            # Rebuild: adaptation with stuffing before payload.
            out[0] = self._pad_packet(pid, cc[0], data, pcr90)

        # middle/full packets
        pos = take0
        for i in range(1, n):
            chunk = data[pos:pos + 184]
            pos += chunk.size
            if chunk.size == 184:
                out[i, 4:] = chunk
            else:
                # last short chunk: adaptation-field stuffing
                af_len = 184 - chunk.size - 1
                out[i, 3] = 0x30 | cc[i]
                out[i, 4] = af_len
                if af_len > 0:
                    out[i, 5] = 0x00
                    out[i, 6:5 + af_len] = 0xFF
                out[i, 188 - chunk.size:] = chunk
        return out.tobytes()

    @staticmethod
    def _pad_packet(pid: int, cc: int, data: np.ndarray,
                    pcr90: int | None) -> np.ndarray:
        """Single TS packet with PUSI + (PCR) + stuffing + short payload."""
        out = np.full(TS_PACKET, 0xFF, np.uint8)
        out[0] = TS_SYNC
        out[1] = 0x40 | (pid >> 8)
        out[2] = pid & 0xFF
        out[3] = 0x30 | cc
        af_len = TS_PACKET - 4 - 1 - data.size
        out[4] = af_len
        if af_len > 0:
            out[5] = 0x10 if pcr90 is not None else 0x00
            out[6:5 + af_len] = 0xFF
        if pcr90 is not None:
            pcr_base = pcr90 & ((1 << 33) - 1)
            out[6] = (pcr_base >> 25) & 0xFF
            out[7] = (pcr_base >> 17) & 0xFF
            out[8] = (pcr_base >> 9) & 0xFF
            out[9] = (pcr_base >> 1) & 0xFF
            out[10] = ((pcr_base & 1) << 7) | 0x7E
            out[11] = 0
            out[12:4 + 1 + af_len] = 0xFF
        out[TS_PACKET - data.size:] = data
        return out

    def psi(self) -> bytes:
        """PAT + PMT packets (send at stream start / before keyframes)."""
        pat = _psi_packet(PAT_PID, _pat_section(),
                          int(self._bump_cc(PAT_PID, 1)[0]))
        pmt = _psi_packet(PMT_PID, _pmt_section(self.video_stream_type,
                                                self.with_audio,
                                                self.audio_kind,
                                                self.audio_channels),
                          int(self._bump_cc(PMT_PID, 1)[0]))
        return pat + pmt

    def mux_video(self, annexb: bytes, pts90: int,
                  dts90: int | None = None, keyframe: bool = False) -> bytes:
        """Mux one video access unit; emits PSI before keyframes."""
        out = self.psi() if keyframe else b""
        pes = _pes_header(PES_VIDEO_SID, pts90, dts90, len(annexb)) + annexb
        out += self._packetize(VIDEO_PID, pes, pcr90=pts90 if dts90 is None
                               else dts90)
        return out

    def mux_audio(self, adts: bytes, pts90: int) -> bytes:
        """adts: self-framed audio ES — ADTS frames (AAC) or
        control-header-prefixed access units (Opus)."""
        sid = PES_PRIVATE_SID if self.audio_kind == "opus" \
            else PES_AUDIO_SID
        pes = _pes_header(sid, pts90, None, len(adts)) + adts
        return self._packetize(AUDIO_PID, pes, pcr90=None)


class TsPacker:
    """SRT payload packer: accumulates TS packets into fixed-size
    payloads, splitting/merging across feed boundaries with residue
    carry (reference: new_buf_cb, src/ceracoder.c:297-339)."""

    def __init__(self, pkt_size: int = 1316):
        if pkt_size % TS_PACKET:
            raise ValueError("pkt_size must be a multiple of 188")
        self.pkt_size = pkt_size
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self._buf += data
        out = []
        while len(self._buf) >= self.pkt_size:
            out.append(bytes(self._buf[:self.pkt_size]))
            del self._buf[:self.pkt_size]
        return out

    @property
    def residue(self) -> int:
        return len(self._buf)

    def flush(self) -> bytes:
        """Remaining partial payload (pad with TS null packets)."""
        if not self._buf:
            return b""
        n_null = (self.pkt_size - len(self._buf)) // TS_PACKET
        null_pkt = bytes([TS_SYNC, 0x1F, 0xFF, 0x10]) + b"\xff" * 184
        out = bytes(self._buf) + null_pkt * n_null
        self._buf.clear()
        return out
