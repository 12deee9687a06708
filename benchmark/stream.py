"""What a receiver reads from the wire: MPEG-TS packets back to the video
access units, and of an HEVC access unit its NAL unit types and its slice
QP. Written from ISO 13818-1 and H.265 (7.3.1, 7.3.6.1) for the stream
that benchmark/reference/hevc/syntax.py describes (one slice of tiles, no
SAO, PPS init_qp 26); it imports nothing of the program.
"""

from __future__ import annotations

TS_PACKET = 188
PAT_PID = 0
NAL_IDR_W_RADL = 19


def _pmt_video_pid(section: bytes) -> int | None:
    """The first elementary stream's PID in a PMT section."""
    info_len = ((section[10] & 0x0F) << 8) | section[11]
    pos = 12 + info_len
    end = 3 + (((section[1] & 0x0F) << 8) | section[2]) - 4
    while pos + 5 <= end:
        stype, pid = section[pos], ((section[pos + 1] & 0x1F) << 8) | section[pos + 2]
        es_len = ((section[pos + 3] & 0x0F) << 8) | section[pos + 4]
        if stype in (0x1B, 0x24):            # H.264, HEVC
            return pid
        pos += 5 + es_len
    return None


def video_access_units(ts: bytes) -> tuple[list[bytes], int]:
    """The video PES payloads in order, and the count of TS packets that
    were malformed (bad sync byte) or out of continuity on the video PID.
    The last access unit is left out unless a later one began: a receiver
    cannot know that it is whole."""
    aus: list[bytes] = []
    cur: bytearray | None = None
    pmt_pid = video_pid = None
    bad = 0
    cc_next = None
    for off in range(0, len(ts) - TS_PACKET + 1, TS_PACKET):
        pkt = ts[off:off + TS_PACKET]
        if pkt[0] != 0x47:
            bad += 1
            continue
        pusi = pkt[1] & 0x40
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        afc = (pkt[3] >> 4) & 3
        pos = 4 + (1 + pkt[4] if afc & 2 else 0)
        if not afc & 1:
            continue
        payload = pkt[pos:]
        if pid == PAT_PID and pusi:
            sec = payload[1 + payload[0]:]
            pmt_pid = ((sec[10] & 0x1F) << 8) | sec[11]
        elif pid == pmt_pid and pusi:
            video_pid = _pmt_video_pid(payload[1 + payload[0]:])
        elif pid == video_pid:
            cc = pkt[3] & 0x0F
            if cc_next is not None and cc != cc_next:
                bad += 1
            cc_next = (cc + 1) % 16
            if pusi:
                if cur is not None:
                    aus.append(bytes(cur))
                hdr_len = payload[8]
                cur = bytearray(payload[9 + hdr_len:])
            elif cur is not None:
                cur += payload
    return aus, bad


def nal_units(au: bytes) -> list[bytes]:
    """The NAL units of an Annex-B access unit, start codes removed."""
    starts = []
    i = 0
    while True:
        i = au.find(b"\x00\x00\x01", i)
        if i < 0:
            break
        starts.append(i + 3)
        i += 3
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(au)
        nal = au[s:e]
        if k + 1 < len(starts) and nal.endswith(b"\x00"):
            nal = nal[:-1]                    # a 4-byte start code's zero
        out.append(nal)
    return out


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


class _Bits:
    def __init__(self, rbsp: bytes):
        self.data, self.pos = rbsp, 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _rbsp(nal: bytes, n: int = 64) -> bytes:
    """The first n bytes of the NAL unit's payload, emulation prevention
    removed."""
    out = bytearray()
    zeros = 0
    for b in nal[2:2 + n + n // 2]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out[:n])


def slice_qp(nal: bytes) -> int:
    """SliceQpY of the first slice segment of an I or P picture coded as
    syntax.py writes it (H.265 7.3.6.1; PPS init_qp_minus26 = 0)."""
    r = _Bits(_rbsp(nal))
    idr = nal_type(nal) == NAL_IDR_W_RADL
    if not r.u(1):
        raise ValueError("not the picture's first slice segment")
    if idr:
        r.u(1)                     # no_output_of_prior_pics_flag
    r.ue()                         # slice_pic_parameter_set_id
    r.ue()                         # slice_type
    if not idr:
        r.u(8)                     # slice_pic_order_cnt_lsb
        if r.u(1):                 # short_term_ref_pic_set_sps_flag
            raise ValueError("SPS reference picture sets are not written")
        n_neg, n_pos = r.ue(), r.ue()
        for _ in range(n_neg + n_pos):
            r.ue()                 # delta_poc_sX_minus1
            r.u(1)                 # used_by_curr_pic_sX_flag
        if r.u(1):                 # num_ref_idx_active_override_flag
            r.ue()
        r.ue()                     # five_minus_max_num_merge_cand
    return 26 + r.se()
