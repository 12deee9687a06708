"""HEVC (H.265 / ISO 23008-2) high-level syntax writers.

NAL framing (spec 7.3.1.2: 2-byte header), profile_tier_level, VPS /
SPS / PPS, and the slice segment header for IDR I-slices. Configured
for the framework's minimal-but-legal all-intra operating point first
(Main profile, 4:2:0 8-bit, PCM enabled), widened as residual coding
lands. Replaces the parameter-set generation inside the reference's
external HEVC encoder elements (reference: pipeline/ *h265*;
SURVEY.md §2.2).

Copy of ceracoder_tpu/codec/h265/syntax.py, cut to the port's one
operating point: the port keeps its own copy so that it imports nothing
of the JAX package. That point is low-delay I/P (no reordering, one
reference), no PCM, no inter TU split, in-loop deblocking on, SAO
optional, and one tile per CTB row in a single slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from ceracoder_tpu_torch.codec.bitwriter import BitWriter, emulation_prevent

# NAL unit types (spec Table 7-1)
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34


def nal_unit(nal_type: int, rbsp: bytes, long_start_code: bool = True,
             temporal_id: int = 0) -> bytes:
    """Annex-B framed HEVC NAL unit (2-byte header, spec 7.3.1.2)."""
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    hdr = bytes([(nal_type << 1), 1 + temporal_id])
    return start + hdr + emulation_prevent(rbsp)


def profile_tier_level(w: BitWriter, level_idc: int = 120) -> None:
    """general PTL, Main profile (spec 7.3.3)."""
    w.u(0, 2)       # general_profile_space
    w.flag(0)       # general_tier_flag
    w.u(1, 5)       # general_profile_idc: Main
    for i in range(32):
        w.flag(i == 1)  # compatibility: Main
    w.flag(1)       # general_progressive_source_flag
    w.flag(0)       # general_interlaced_source_flag
    w.flag(1)       # general_non_packed_constraint_flag
    w.flag(1)       # general_frame_only_constraint_flag
    w.u(0, 32)      # general_reserved_zero_43bits...
    w.u(0, 11)
    w.flag(0)       # general_reserved / inbld
    w.u(level_idc, 8)


@dataclass
class HevcParams:
    # 4:2:0: dimensions must be even (the conformance window crops in
    # SubWidthC/SubHeightC = 2-sample units; encoders validate)
    width: int
    height: int
    qp: int = 32
    # coding structure: CTB == min CB (no split flags in the CQT)
    log2_ctb: int = 4            # 16x16 CTBs
    log2_min_cb: int = 4
    log2_min_tb: int = 2
    log2_max_tb: int = 4
    # sample adaptive offset (frame post-pass after deblocking)
    sao: bool = False

    @property
    def tiles(self) -> bool:
        """One tile per CTB row in a single slice (entry-point offsets
        instead of per-row slice headers: the same row independence,
        ~10 bytes/row less overhead); a one-row picture is one plain
        slice."""
        return self.pic_height_ctbs > 1

    @property
    def ctb(self) -> int:
        return 1 << self.log2_ctb

    @property
    def pic_width_ctbs(self) -> int:
        return -(-self.width // self.ctb)

    @property
    def pic_height_ctbs(self) -> int:
        return -(-self.height // self.ctb)


def write_vps(p: HevcParams) -> bytes:
    w = BitWriter()
    w.u(0, 4)       # vps_video_parameter_set_id
    w.u(3, 2)       # vps_base_layer_internal/available (reserved 11)
    w.u(0, 6)       # vps_max_layers_minus1
    w.u(0, 3)       # vps_max_sub_layers_minus1
    w.flag(1)       # vps_temporal_id_nesting_flag
    w.u(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    profile_tier_level(w)
    w.flag(1)       # vps_sub_layer_ordering_info_present_flag
    w.ue(1)         # vps_max_dec_pic_buffering_minus1[0]
    w.ue(0)         # vps_max_num_reorder_pics[0]
    w.ue(0)         # vps_max_latency_increase_plus1[0]
    w.u(0, 6)       # vps_max_layer_id
    w.ue(0)         # vps_num_layer_sets_minus1
    w.flag(0)       # vps_timing_info_present_flag
    w.flag(0)       # vps_extension_flag
    w.rbsp_trailing_bits()
    return nal_unit(NAL_VPS, w.to_bytes())


def write_sps(p: HevcParams) -> bytes:
    w = BitWriter()
    w.u(0, 4)       # sps_video_parameter_set_id
    w.u(0, 3)       # sps_max_sub_layers_minus1
    w.flag(1)       # sps_temporal_id_nesting_flag
    profile_tier_level(w)
    w.ue(0)         # sps_seq_parameter_set_id
    w.ue(1)         # chroma_format_idc: 4:2:0
    ctb = p.ctb
    pw = -(-p.width // ctb) * ctb
    ph = -(-p.height // ctb) * ctb
    w.ue(pw)        # pic_width_in_luma_samples (CTB-aligned)
    w.ue(ph)
    if pw != p.width or ph != p.height:
        w.flag(1)   # conformance_window_flag
        w.ue(0)                             # left offset
        w.ue((pw - p.width) // 2)           # right (chroma units)
        w.ue(0)
        w.ue((ph - p.height) // 2)          # bottom
    else:
        w.flag(0)
    w.ue(0)         # bit_depth_luma_minus8
    w.ue(0)         # bit_depth_chroma_minus8
    w.ue(4)         # log2_max_pic_order_cnt_lsb_minus4 (POC 8 bits)
    w.flag(1)       # sps_sub_layer_ordering_info_present_flag
    w.ue(1)         # sps_max_dec_pic_buffering_minus1[0]
    w.ue(0)         # sps_max_num_reorder_pics[0]
    w.ue(0)         # sps_max_latency_increase_plus1[0]
    w.ue(p.log2_min_cb - 3)                 # log2_min_luma_cb_size_minus3
    w.ue(p.log2_ctb - p.log2_min_cb)        # log2_diff_max_min_cb
    w.ue(p.log2_min_tb - 2)                 # log2_min_tb_size_minus2
    w.ue(p.log2_max_tb - p.log2_min_tb)     # log2_diff_max_min_tb
    w.ue(0)         # max_transform_hierarchy_depth_inter
    w.ue(0)         # max_transform_hierarchy_depth_intra
    w.flag(0)       # scaling_list_enabled_flag
    w.flag(0)       # amp_enabled_flag
    w.flag(p.sao)   # sample_adaptive_offset_enabled_flag
    w.flag(0)       # pcm_enabled_flag
    w.ue(0)         # num_short_term_ref_pic_sets
    w.flag(0)       # long_term_ref_pics_present_flag
    w.flag(0)       # sps_temporal_mvp_enabled_flag
    w.flag(0)       # strong_intra_smoothing_enabled_flag
    w.flag(0)       # vui_parameters_present_flag
    w.flag(0)       # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return nal_unit(NAL_SPS, w.to_bytes())


def write_pps(p: HevcParams) -> bytes:
    w = BitWriter()
    w.ue(0)         # pps_pic_parameter_set_id
    w.ue(0)         # pps_seq_parameter_set_id
    w.flag(0)       # dependent_slice_segments_enabled_flag
    w.flag(0)       # output_flag_present_flag
    w.u(0, 3)       # num_extra_slice_header_bits
    w.flag(0)       # sign_data_hiding_enabled_flag
    w.flag(0)       # cabac_init_present_flag
    w.ue(0)         # num_ref_idx_l0_default_active_minus1
    w.ue(0)         # num_ref_idx_l1_default_active_minus1
    w.se(0)         # init_qp_minus26
    w.flag(0)       # constrained_intra_pred_flag
    w.flag(0)       # transform_skip_enabled_flag
    w.flag(0)       # cu_qp_delta_enabled_flag
    w.se(0)         # pps_cb_qp_offset
    w.se(0)         # pps_cr_qp_offset
    w.flag(0)       # pps_slice_chroma_qp_offsets_present_flag
    w.flag(0)       # weighted_pred_flag
    w.flag(0)       # weighted_bipred_flag
    w.flag(0)       # transquant_bypass_enabled_flag
    w.flag(p.tiles)  # tiles_enabled_flag
    w.flag(0)       # entropy_coding_sync_enabled_flag
    if p.tiles:
        w.ue(0)                         # num_tile_columns_minus1
        w.ue(p.pic_height_ctbs - 1)     # num_tile_rows_minus1
        w.flag(1)                       # uniform_spacing_flag
        w.flag(1)   # loop_filter_across_tiles_enabled_flag
    w.flag(1)       # pps_loop_filter_across_slices_enabled_flag
    w.flag(1)       # deblocking_filter_control_present_flag
    w.flag(0)       # deblocking_filter_override_enabled_flag
    w.flag(0)       # pps_deblocking_filter_disabled_flag
    w.se(0)         # pps_beta_offset_div2
    w.se(0)         # pps_tc_offset_div2
    w.flag(0)       # pps_scaling_list_data_present_flag
    w.flag(0)       # lists_modification_present_flag
    w.ue(0)         # log2_parallel_merge_level_minus2
    w.flag(0)       # slice_segment_header_extension_present_flag
    w.flag(0)       # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return nal_unit(NAL_PPS, w.to_bytes())


def slice_header_bits(p: HevcParams, idr: bool = True,
                      qp: int | None = None, poc: int = 0,
                      ref_poc_delta: int = 1,
                      tile_sizes=None) -> BitWriter:
    """The picture's slice segment header (spec 7.3.6.1) for an IDR
    I-slice or a TRAIL_R P-slice referencing ``ref_poc_delta`` back;
    ``tile_sizes`` are the coded sizes of tiles 0..N-2 (entry points).
    The caller appends the CABAC slice data."""
    qp = p.qp if qp is None else qp
    w = BitWriter()
    w.flag(1)       # first_slice_segment_in_pic_flag
    if idr:
        w.flag(0)   # no_output_of_prior_pics_flag
    w.ue(0)         # slice_pic_parameter_set_id
    w.ue(2 if idr else 1)   # slice_type: I / P
    if not idr:
        # log2_max_pic_order_cnt_lsb_minus4 = 4 in the SPS -> 8 bits
        w.u(poc & 0xFF, 8)  # slice_pic_order_cnt_lsb
        w.flag(0)           # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): one past reference
        w.ue(1)             # num_negative_pics
        w.ue(0)             # num_positive_pics
        w.ue(ref_poc_delta - 1)   # delta_poc_s0_minus1[0]
        w.flag(1)           # used_by_curr_pic_s0_flag[0]
        # (no temporal MVP flag: sps_temporal_mvp_enabled_flag = 0)
    if p.sao:
        w.flag(1)           # slice_sao_luma_flag
        w.flag(1)           # slice_sao_chroma_flag
    if not idr:
        w.flag(0)           # num_ref_idx_active_override_flag
        w.ue(3)             # five_minus_max_num_merge_cand -> 2 cands
    # (no deblocking override)
    w.se(qp - 26)   # slice_qp_delta
    # present when the PPS enables cross-slice filtering and SAO is on
    # or deblocking is not disabled (spec 7.3.6.1): deblocking is always
    # on here, so `p.deblock or p.sao` always holds
    w.flag(1)       # slice_loop_filter_across_slices_enabled_flag
    if p.tiles:
        # entry points of tiles 2..N (spec 7.4.7.1): sizes of the
        # coded substreams INCLUDING emulation prevention bytes
        sizes = tile_sizes or ()
        w.ue(len(sizes))                # num_entry_point_offsets
        if sizes:
            max_off = max(sizes)
            nbits = max(1, (max_off - 1).bit_length())
            w.ue(nbits - 1)             # offset_len_minus1
            for s in sizes:
                w.u(s - 1, nbits)       # entry_point_offset_minus1
    # byte_alignment()
    w.u(1, 1)
    pad = (-w.bit_length) % 8
    if pad:
        w.u(0, pad)
    return w
