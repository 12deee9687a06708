"""H.264 Annex-B stream walker: SPS/PPS/slice-header parsing.

Covers the syntax subset libx264 and our own encoder emit for
progressive 4:2:0 frame-coded streams (spec 7.3.2.1/7.3.2.2/7.3.3) —
enough to locate each slice's CABAC/CAVLC data and its decode
parameters. Used by conformance tests to drive H264SliceParser over
real libx264 output (the entropy ground truth the reference relied on
via x264enc — reference: bindings/typescript/src/pipeline/
generic-builder.ts:49-55).

Copy of ceracoder_tpu/codec/h264/parse.py: the port keeps its own copy
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceracoder_tpu_torch.codec.bitwriter import BitReader, strip_emulation


def split_nals(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL units (no start codes)."""
    out = []
    i = 0
    n = len(data)
    while i < n:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        j += 3
        k = data.find(b"\x00\x00\x01", j)
        end = n if k < 0 else (k - 1 if k > 0 and data[k - 1] == 0
                               else k)
        # trim trailing zero_byte runs before the next start code
        while end > j and data[end - 1] == 0 and k >= 0:
            end -= 1
        out.append(data[j:end])
        i = j
    return out


@dataclass
class Sps:
    profile_idc: int = 0
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    mbw: int = 0
    mbh: int = 0
    frame_mbs_only: bool = True


@dataclass
class Pps:
    cabac: bool = True
    pic_init_qp: int = 26
    deblock_control: bool = True
    num_ref_idx_l0: int = 1
    weighted_pred: bool = False
    sps: Sps = field(default_factory=Sps)


@dataclass
class SliceHeader:
    first_mb: int
    slice_type: int           # mod 5: 0=P, 1=B, 2=I
    frame_num: int
    qp: int
    cabac_init_idc: int
    data_offset_bits: int     # bit offset of slice data in the RBSP
    idr: bool


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(strip_emulation(rbsp))
    r.u(8)                                   # nal header
    s = Sps()
    s.profile_idc = r.u(8)
    r.u(8)                                   # constraint flags
    r.u(8)                                   # level
    r.ue()                                   # sps id
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)
        r.ue()                               # bit_depth_luma_minus8
        r.ue()                               # bit_depth_chroma_minus8
        r.u(1)                               # qpprime_y_zero
        if r.u(1):                           # seq_scaling_matrix
            raise NotImplementedError("scaling matrices")
    s.log2_max_frame_num = r.ue() + 4
    s.poc_type = r.ue()
    if s.poc_type == 0:
        s.log2_max_poc_lsb = r.ue() + 4
    elif s.poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()                                   # max_num_ref_frames
    r.u(1)                                   # gaps_in_frame_num
    s.mbw = r.ue() + 1
    mbh = r.ue() + 1
    s.frame_mbs_only = bool(r.u(1))
    s.mbh = mbh if s.frame_mbs_only else 2 * mbh
    return s


def parse_pps(rbsp: bytes, sps: Sps) -> Pps:
    r = BitReader(strip_emulation(rbsp))
    r.u(8)
    p = Pps(sps=sps)
    r.ue()                                   # pps id
    r.ue()                                   # sps id
    p.cabac = bool(r.u(1))
    r.u(1)                                   # bottom_field_pic_order
    if r.ue() != 0:
        raise NotImplementedError("slice groups")
    p.num_ref_idx_l0 = r.ue() + 1
    r.ue()                                   # num_ref_idx_l1
    p.weighted_pred = bool(r.u(1))
    r.u(2)                                   # weighted_bipred_idc
    p.pic_init_qp = r.se() + 26
    r.se()                                   # pic_init_qs
    r.se()                                   # chroma_qp_index_offset
    p.deblock_control = bool(r.u(1))
    r.u(1)                                   # constrained_intra_pred
    r.u(1)                                   # redundant_pic_cnt
    return p


def parse_slice_header(nal: bytes, pps: Pps) -> SliceHeader:
    rbsp = strip_emulation(nal)
    r = BitReader(rbsp)
    hdr = r.u(8)
    nal_type = hdr & 0x1F
    nal_ref_idc = (hdr >> 5) & 3
    idr = nal_type == 5
    first_mb = r.ue()
    slice_type = r.ue() % 5
    r.ue()                                   # pps id
    frame_num = r.u(pps.sps.log2_max_frame_num)
    if idr:
        r.ue()                               # idr_pic_id
    if pps.sps.poc_type == 0:
        r.u(pps.sps.log2_max_poc_lsb)
    if slice_type == 0:                      # P
        if r.u(1):                           # num_ref_idx_override
            r.ue()
        if r.u(1):                           # ref_pic_list_modification
            raise NotImplementedError("ref list modification")
        if pps.weighted_pred:
            raise NotImplementedError("weighted prediction")
    if nal_ref_idc:
        if idr:
            r.u(1)                           # no_output_of_prior_pics
            r.u(1)                           # long_term_reference
        else:
            if r.u(1):                       # adaptive_ref_pic_marking
                raise NotImplementedError("MMCO")
    cabac_init_idc = 0
    if pps.cabac and slice_type != 2:
        cabac_init_idc = r.ue()
    qp = pps.pic_init_qp + r.se()
    if pps.deblock_control:
        didc = r.ue()
        if didc != 1:
            r.se()
            r.se()
    pos = r.pos
    if pps.cabac:
        pad = (-pos) % 8                     # cabac_alignment_one_bit
        for _ in range(pad):
            if r.u(1) != 1:
                raise ValueError("bad cabac alignment bits")
        pos = r.pos
    return SliceHeader(first_mb, slice_type, frame_num, qp,
                       cabac_init_idc, pos, idr)


def walk_stream(data: bytes):
    """Yield (SliceHeader, slice_data_bytes, Pps) per coded slice.

    slice_data_bytes is the de-escaped RBSP from the (byte-aligned,
    CABAC) data offset to the end of the NAL."""
    sps = None
    pps = None
    for nal in split_nals(data):
        t = nal[0] & 0x1F
        if t == 7:
            sps = parse_sps(nal)
        elif t == 8:
            if sps is None:
                raise ValueError("PPS before SPS")
            pps = parse_pps(nal, sps)
        elif t in (1, 5):
            if pps is None:
                raise ValueError("slice before PPS")
            sh = parse_slice_header(nal, pps)
            rbsp = strip_emulation(nal)
            assert sh.data_offset_bits % 8 == 0
            yield sh, rbsp[sh.data_offset_bits // 8:], pps
