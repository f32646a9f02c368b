# Copied from libhm_tpu/hostdec/params.py
"""VPS/SPS/PPS and slice-segment-header parsing (Rec. H.265 clause 7.3).

Rebuild of the reference's fixed/Exp-Golomb high-level-syntax parser
(reference: source/Lib/TLibDecoder/TDecCAVLC.cpp:568 parseSPS, parsePPS,
parseSliceHeader:895) as plain dataclass-producing Python.  Only decoded
fields that drive reconstruction are retained; everything else is parsed
for bit-position correctness and discarded.
"""
import math
from dataclasses import dataclass, field
from .bitstream import BitReader
from . import nal as nalmod


@dataclass
class ProfileTierLevel:
    """general_* PTL fields (Rec. 7.3.3; reference ProfileTierLevel,
    TComSlice.h:181)."""
    general_profile_space: int = 0
    general_tier_flag: int = 0
    general_profile_idc: int = 1
    general_level_idc: int = 0


def _parse_ptl(r: BitReader, max_sub_layers_minus1: int):
    p = ProfileTierLevel()
    p.general_profile_space = r.u(2)
    p.general_tier_flag = r.u(1)
    p.general_profile_idc = r.u(5)
    r.u(32)  # profile_compatibility_flags
    r.u(4)   # progressive/interlaced/non_packed/frame_only
    r.u(32); r.u(12)  # 44 bits: constraint flags / reserved
    p.general_level_idc = r.u(8)
    sub_profile = []
    sub_level = []
    for _ in range(max_sub_layers_minus1):
        sub_profile.append(r.flag())
        sub_level.append(r.flag())
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            r.u(2)  # reserved_zero_2bits
    for i in range(max_sub_layers_minus1):
        if sub_profile[i]:
            r.u(2); r.u(1); r.u(5); r.u(32); r.u(4); r.u(32); r.u(12)
        if sub_level[i]:
            r.u(8)
    return p


@dataclass
class ShortTermRPS:
    num_negative: int = 0
    num_positive: int = 0
    delta_poc: list = field(default_factory=list)   # S0 (negative, decreasing) then S1
    used: list = field(default_factory=list)

    @property
    def num_pics(self):
        return self.num_negative + self.num_positive


def _parse_st_rps(r: BitReader, idx: int, rps_list, num_st_rps: int) -> ShortTermRPS:
    """short_term_ref_pic_set(idx); rps_list holds previously parsed sets."""
    rps = ShortTermRPS()
    inter_pred = r.flag() if idx != 0 else 0
    if inter_pred:
        delta_idx = (r.ue() + 1) if idx == num_st_rps else 1
        ref = rps_list[idx - delta_idx]
        sign = r.flag()
        abs_delta = r.ue() + 1
        delta_rps = -abs_delta if sign else abs_delta
        use = []
        for j in range(ref.num_pics + 1):
            used_by_curr = r.flag()
            use_delta = 1
            if not used_by_curr:
                use_delta = r.flag()
            use.append((used_by_curr, use_delta))
        # derive (spec 7.4.8)
        neg, pos = [], []
        ref_pocs = ref.delta_poc + [0]
        # i iterates S1 of ref in reverse then 0 then S0 — build negative list
        for j in range(ref.num_positive - 1, -1, -1):
            dpoc = ref.delta_poc[ref.num_negative + j] + delta_rps
            if dpoc < 0 and use[ref.num_negative + j][1]:
                neg.append((dpoc, use[ref.num_negative + j][0]))
        if delta_rps < 0 and use[ref.num_pics][1]:
            neg.append((delta_rps, use[ref.num_pics][0]))
        for j in range(ref.num_negative):
            dpoc = ref.delta_poc[j] + delta_rps
            if dpoc < 0 and use[j][1]:
                neg.append((dpoc, use[j][0]))
        for j in range(ref.num_negative - 1, -1, -1):
            dpoc = ref.delta_poc[j] + delta_rps
            if dpoc > 0 and use[j][1]:
                pos.append((dpoc, use[j][0]))
        if delta_rps > 0 and use[ref.num_pics][1]:
            pos.append((delta_rps, use[ref.num_pics][0]))
        for j in range(ref.num_positive):
            dpoc = ref.delta_poc[ref.num_negative + j] + delta_rps
            if dpoc > 0 and use[ref.num_negative + j][1]:
                pos.append((dpoc, use[ref.num_negative + j][0]))
        rps.num_negative = len(neg)
        rps.num_positive = len(pos)
        rps.delta_poc = [d for d, _ in neg] + [d for d, _ in pos]
        rps.used = [u for _, u in neg] + [u for _, u in pos]
        del ref_pocs
    else:
        rps.num_negative = r.ue()
        rps.num_positive = r.ue()
        prev = 0
        for _ in range(rps.num_negative):
            prev -= r.ue() + 1
            rps.delta_poc.append(prev)
            rps.used.append(r.flag())
        prev = 0
        for _ in range(rps.num_positive):
            prev += r.ue() + 1
            rps.delta_poc.append(prev)
            rps.used.append(r.flag())
    return rps


def parse_scaling_list_data(r: BitReader):
    """scaling_list_data() — returns {(sizeId, matrixId): (list, dc)}."""
    from .tables import default_scaling_list
    out = {}
    for size_id in range(4):
        matrix_step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, matrix_step):
            pred_mode = r.flag()
            if not pred_mode:
                delta = r.ue() * matrix_step
                if delta == 0:
                    lst, dc = default_scaling_list(size_id, matrix_id)
                else:
                    lst, dc = out[(size_id, matrix_id - delta)]
                out[(size_id, matrix_id)] = (list(lst), dc)
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                dc = 8
                if size_id > 1:
                    dc = r.se() + 8
                    next_coef = dc
                lst = []
                for _ in range(coef_num):
                    next_coef = (next_coef + r.se() + 256) % 256
                    lst.append(next_coef)
                # deltas arrive in up-right diagonal scan order; store raster
                # (reference TDecCAVLC xDecodeScalingList writes dst[scan[i]])
                from .tables import scan_order, SCAN_DIAG
                base = 4 if size_id == 0 else 8
                raster = [0] * (base * base)
                for i, (sx, sy) in enumerate(scan_order(base, base, SCAN_DIAG)):
                    raster[sy * base + sx] = lst[i]
                out[(size_id, matrix_id)] = (raster, dc)
    return out


@dataclass
class HRD:
    """hrd_parameters() (Rec. E.2.2; reference TComHRD, TComSlice.h:181)."""
    nal_hrd: int = 0
    vcl_hrd: int = 0
    sub_pic: int = 0
    tick_divisor_minus2: int = 0
    du_cpb_removal_delay_length: int = 24   # length_minus1 + 1
    sub_pic_cpb_params_in_pic_timing: int = 0
    dpb_output_delay_du_length: int = 24
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    cpb_size_du_scale: int = 0
    initial_cpb_removal_delay_length: int = 24
    au_cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24
    # per sub-layer: (fixed_rate, elemental_duration_tc, low_delay, cpb_cnt,
    #   nal_cpb [(bitrate, size, cbr)], vcl_cpb [...])
    sub_layers: list = field(default_factory=list)


@dataclass
class VUI:
    """vui_parameters() (Rec. E.2.1; reference TComVUI, TComSlice.h:542)."""
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate: int = -1
    video_format: int = 5
    video_full_range: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    chroma_loc_top: int = 0
    chroma_loc_bottom: int = 0
    neutral_chroma_indication: int = 0
    field_seq: int = 0
    frame_field_info_present: int = 0
    default_display_window: tuple = (0, 0, 0, 0)
    timing_info_present: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    poc_proportional_to_timing: int = 0
    num_ticks_poc_diff_one: int = 0
    hrd: HRD = None
    bitstream_restriction: int = 0
    tiles_fixed_structure: int = 0
    mv_over_pic_boundaries: int = 1
    restricted_ref_pic_lists: int = 0
    min_spatial_segmentation_idc: int = 0
    max_bytes_per_pic_denom: int = 2
    max_bits_per_min_cu_denom: int = 1
    log2_max_mv_length_h: int = 15
    log2_max_mv_length_v: int = 15


def _parse_vui(r: BitReader, sps):
    v = VUI()
    sps.vui = v
    if r.flag():  # aspect_ratio_info_present
        v.aspect_ratio_idc = r.u(8)
        if v.aspect_ratio_idc == 255:
            v.sar_width = r.u(16)
            v.sar_height = r.u(16)
    if r.flag():  # overscan_info_present
        v.overscan_appropriate = r.flag()
    if r.flag():  # video_signal_type_present
        v.video_format = r.u(3)
        v.video_full_range = r.flag()
        if r.flag():  # colour_description_present
            v.colour_primaries = r.u(8)
            v.transfer_characteristics = r.u(8)
            v.matrix_coeffs = r.u(8)
    if r.flag():  # chroma_loc_info_present
        v.chroma_loc_top = r.ue()
        v.chroma_loc_bottom = r.ue()
    v.neutral_chroma_indication = r.flag()
    v.field_seq = r.flag()
    v.frame_field_info_present = r.flag()
    if r.flag():  # default_display_window
        v.default_display_window = (r.ue(), r.ue(), r.ue(), r.ue())
    v.timing_info_present = r.flag()
    if v.timing_info_present:
        v.num_units_in_tick = r.u(32)
        v.time_scale = r.u(32)
        v.poc_proportional_to_timing = r.flag()
        if v.poc_proportional_to_timing:
            v.num_ticks_poc_diff_one = r.ue() + 1
        if r.flag():  # hrd_parameters_present
            v.hrd = _parse_hrd(r, True, sps.max_sub_layers_minus1)
    v.bitstream_restriction = r.flag()
    if v.bitstream_restriction:
        v.tiles_fixed_structure = r.flag()
        v.mv_over_pic_boundaries = r.flag()
        v.restricted_ref_pic_lists = r.flag()
        v.min_spatial_segmentation_idc = r.ue()
        v.max_bytes_per_pic_denom = r.ue()
        v.max_bits_per_min_cu_denom = r.ue()
        v.log2_max_mv_length_h = r.ue()
        v.log2_max_mv_length_v = r.ue()


def _parse_hrd(r: BitReader, common_inf: bool, max_sub_layers_minus1: int):
    h = HRD()
    if common_inf:
        h.nal_hrd = r.flag()
        h.vcl_hrd = r.flag()
        if h.nal_hrd or h.vcl_hrd:
            h.sub_pic = r.flag()
            if h.sub_pic:
                h.tick_divisor_minus2 = r.u(8)
                h.du_cpb_removal_delay_length = r.u(5) + 1
                h.sub_pic_cpb_params_in_pic_timing = r.flag()
                h.dpb_output_delay_du_length = r.u(5) + 1
            h.bit_rate_scale = r.u(4)
            h.cpb_size_scale = r.u(4)
            if h.sub_pic:
                h.cpb_size_du_scale = r.u(4)
            h.initial_cpb_removal_delay_length = r.u(5) + 1
            h.au_cpb_removal_delay_length = r.u(5) + 1
            h.dpb_output_delay_length = r.u(5) + 1
    for _ in range(max_sub_layers_minus1 + 1):
        fixed_rate = r.flag()
        if not fixed_rate:
            fixed_rate = r.flag()
        low_delay = 0
        duration = 0
        if fixed_rate:
            duration = r.ue() + 1
        else:
            low_delay = r.flag()
        cpb_cnt = 1 if low_delay else r.ue() + 1
        cpbs = [[], []]
        for li, hrd_on in enumerate((h.nal_hrd, h.vcl_hrd)):
            if hrd_on:
                for _ in range(cpb_cnt):
                    br, sz = r.ue(), r.ue()
                    if h.sub_pic:
                        r.ue(); r.ue()
                    cbr = r.flag()
                    cpbs[li].append((br, sz, cbr))
        h.sub_layers.append((fixed_rate, duration, low_delay, cpb_cnt,
                             cpbs[0], cpbs[1]))
    return h


@dataclass
class VPS:
    """Video parameter set (Rec. 7.3.2.1; reference TComVPS,
    TComSlice.h:427, parsed by TDecCAVLC::parseVPS TDecCAVLC.cpp:804)."""
    vps_id: int = 0
    max_layers_minus1: int = 0
    max_sub_layers_minus1: int = 0
    temporal_id_nesting: int = 0
    max_dec_pic_buffering: list = field(default_factory=lambda: [0] * 7)
    num_reorder_pics: list = field(default_factory=lambda: [0] * 7)
    max_latency_increase: list = field(default_factory=lambda: [0] * 7)
    max_layer_id: int = 0
    num_layer_sets_minus1: int = 0
    timing_info_present: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    poc_proportional_to_timing: int = 0
    num_ticks_poc_diff_one: int = 0
    hrd_list: list = field(default_factory=list)  # (layer_set_idx, HRD)


def parse_vps(rbsp: bytes) -> VPS:
    r = BitReader(rbsp)
    v = VPS()
    v.vps_id = r.u(4)
    r.u(2)   # vps_reserved_three_2bits
    v.max_layers_minus1 = r.u(6)
    v.max_sub_layers_minus1 = r.u(3)
    v.temporal_id_nesting = r.flag()
    r.u(16)  # vps_reserved_0xffff_16bits
    _parse_ptl(r, v.max_sub_layers_minus1)
    sub_layer_ordering = r.flag()
    lo = 0 if sub_layer_ordering else v.max_sub_layers_minus1
    for i in range(lo, v.max_sub_layers_minus1 + 1):
        v.max_dec_pic_buffering[i] = r.ue() + 1
        v.num_reorder_pics[i] = r.ue()
        v.max_latency_increase[i] = r.ue()
    v.max_layer_id = r.u(6)
    v.num_layer_sets_minus1 = r.ue()
    for _ in range(v.num_layer_sets_minus1):
        for _ in range(v.max_layer_id + 1):
            r.flag()  # layer_id_included_flag
    v.timing_info_present = r.flag()
    if v.timing_info_present:
        v.num_units_in_tick = r.u(32)
        v.time_scale = r.u(32)
        v.poc_proportional_to_timing = r.flag()
        if v.poc_proportional_to_timing:
            v.num_ticks_poc_diff_one = r.ue() + 1
        for i in range(r.ue()):  # vps_num_hrd_parameters
            idx = r.ue()
            common = 1 if i == 0 else r.flag()
            v.hrd_list.append((idx, _parse_hrd(r, bool(common),
                                               v.max_sub_layers_minus1)))
    return v


@dataclass
class SPS:
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    width: int = 0
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)   # left, right, top, bottom (in chroma units)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: list = field(default_factory=lambda: [0] * 7)
    num_reorder_pics: list = field(default_factory=lambda: [0] * 7)
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_tr_hierarchy_inter: int = 0
    max_tr_hierarchy_intra: int = 0
    scaling_list_enabled: int = 0
    scaling_list_data: dict = None
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_ipcm_cb: int = 3
    log2_max_ipcm_cb: int = 3
    pcm_loop_filter_disabled: int = 0
    st_rps: list = field(default_factory=list)
    long_term_ref_pics_present: int = 0
    num_long_term_ref_pics_sps: int = 0
    lt_ref_poc_lsb_sps: list = field(default_factory=list)
    lt_used_by_curr_sps: list = field(default_factory=list)
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    max_sub_layers_minus1: int = 0
    # range extension flags
    transform_skip_rotation: int = 0
    transform_skip_context: int = 0
    implicit_rdpcm: int = 0
    explicit_rdpcm: int = 0
    extended_precision: int = 0
    intra_smoothing_disabled: int = 0
    high_precision_offsets: int = 0
    persistent_rice_adaptation: int = 0
    cabac_bypass_alignment: int = 0
    vui: object = None               # VUI when vui_parameters_present

    # ---- derived geometry ----
    @property
    def ctb_size(self):
        return 1 << self.log2_ctb

    @property
    def pic_width_ctbs(self):
        return (self.width + self.ctb_size - 1) >> self.log2_ctb

    @property
    def pic_height_ctbs(self):
        return (self.height + self.ctb_size - 1) >> self.log2_ctb

    @property
    def pic_size_ctbs(self):
        return self.pic_width_ctbs * self.pic_height_ctbs

    @property
    def max_cu_depth(self):
        return self.log2_ctb - self.log2_min_cb

    def chroma_shift_x(self):
        return 1 if self.chroma_format_idc in (1, 2) else 0

    def chroma_shift_y(self):
        return 1 if self.chroma_format_idc == 1 else 0


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    sps = SPS()
    r.u(4)  # sps_video_parameter_set_id
    sps.max_sub_layers_minus1 = r.u(3)
    r.flag()  # temporal_id_nesting
    sps.ptl = _parse_ptl(r, sps.max_sub_layers_minus1)
    sps.sps_id = r.ue()
    sps.chroma_format_idc = r.ue()
    if sps.chroma_format_idc == 3:
        sps.separate_colour_plane = r.flag()
    sps.width = r.ue()
    sps.height = r.ue()
    if r.flag():
        sps.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    sps.bit_depth_luma = 8 + r.ue()
    sps.bit_depth_chroma = 8 + r.ue()
    sps.log2_max_poc_lsb = 4 + r.ue()
    sub_layer_ordering = r.flag()
    lo = 0 if sub_layer_ordering else sps.max_sub_layers_minus1
    for i in range(lo, sps.max_sub_layers_minus1 + 1):
        sps.max_dec_pic_buffering[i] = r.ue() + 1
        sps.num_reorder_pics[i] = r.ue()
        r.ue()  # max_latency_increase_plus1
    if not sub_layer_ordering:
        for i in range(sps.max_sub_layers_minus1):
            sps.max_dec_pic_buffering[i] = sps.max_dec_pic_buffering[sps.max_sub_layers_minus1]
            sps.num_reorder_pics[i] = sps.num_reorder_pics[sps.max_sub_layers_minus1]
    sps.log2_min_cb = 3 + r.ue()
    sps.log2_ctb = sps.log2_min_cb + r.ue()
    sps.log2_min_tb = 2 + r.ue()
    sps.log2_max_tb = sps.log2_min_tb + r.ue()
    sps.max_tr_hierarchy_inter = r.ue()
    sps.max_tr_hierarchy_intra = r.ue()
    sps.scaling_list_enabled = r.flag()
    if sps.scaling_list_enabled:
        if r.flag():
            sps.scaling_list_data = parse_scaling_list_data(r)
    sps.amp_enabled = r.flag()
    sps.sao_enabled = r.flag()
    sps.pcm_enabled = r.flag()
    if sps.pcm_enabled:
        sps.pcm_bit_depth_luma = r.u(4) + 1
        sps.pcm_bit_depth_chroma = r.u(4) + 1
        sps.log2_min_ipcm_cb = 3 + r.ue()
        sps.log2_max_ipcm_cb = sps.log2_min_ipcm_cb + r.ue()
        sps.pcm_loop_filter_disabled = r.flag()
    num_st = r.ue()
    for i in range(num_st):
        sps.st_rps.append(_parse_st_rps(r, i, sps.st_rps, num_st))
    sps.long_term_ref_pics_present = r.flag()
    if sps.long_term_ref_pics_present:
        sps.num_long_term_ref_pics_sps = r.ue()
        for _ in range(sps.num_long_term_ref_pics_sps):
            sps.lt_ref_poc_lsb_sps.append(r.u(sps.log2_max_poc_lsb))
            sps.lt_used_by_curr_sps.append(r.flag())
    sps.temporal_mvp_enabled = r.flag()
    sps.strong_intra_smoothing = r.flag()
    if r.flag():  # vui_parameters_present
        _parse_vui(r, sps)
    if r.flag():  # sps_extension_present
        range_ext = r.flag()
        r.flag(); r.flag()  # multilayer, 3d
        r.u(5)  # sps_extension_5bits
        if range_ext:
            sps.transform_skip_rotation = r.flag()
            sps.transform_skip_context = r.flag()
            sps.implicit_rdpcm = r.flag()
            sps.explicit_rdpcm = r.flag()
            sps.extended_precision = r.flag()
            sps.intra_smoothing_disabled = r.flag()
            sps.high_precision_offsets = r.flag()
            sps.persistent_rice_adaptation = r.flag()
            sps.cabac_bypass_alignment = r.flag()
    return sps


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_l0_default: int = 1
    num_ref_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync: int = 0
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    tile_col_widths: list = None     # explicit widths in CTBs (len = cols)
    tile_row_heights: list = None
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 0
    deblocking_override_enabled: int = 0
    deblocking_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    scaling_list_data: dict = None
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_header_extension_present: int = 0
    # range extension
    log2_max_transform_skip_size: int = 2
    cross_component_prediction: int = 0
    chroma_qp_offset_list_enabled: int = 0
    diff_cu_chroma_qp_offset_depth: int = 0
    chroma_qp_offset_list: list = None  # [(cb, cr)]
    sao_offset_scale_luma: int = 0
    sao_offset_scale_chroma: int = 0


def parse_pps(rbsp: bytes) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    p.dependent_slice_segments_enabled = r.flag()
    p.output_flag_present = r.flag()
    p.num_extra_slice_header_bits = r.u(3)
    p.sign_data_hiding = r.flag()
    p.cabac_init_present = r.flag()
    p.num_ref_l0_default = r.ue() + 1
    p.num_ref_l1_default = r.ue() + 1
    p.init_qp = 26 + r.se()
    p.constrained_intra_pred = r.flag()
    p.transform_skip_enabled = r.flag()
    p.cu_qp_delta_enabled = r.flag()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = r.flag()
    p.weighted_pred = r.flag()
    p.weighted_bipred = r.flag()
    p.transquant_bypass_enabled = r.flag()
    p.tiles_enabled = r.flag()
    p.entropy_coding_sync = r.flag()
    if p.tiles_enabled:
        p.num_tile_cols = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.uniform_spacing = r.flag()
        if not p.uniform_spacing:
            p.tile_col_widths = [r.ue() + 1 for _ in range(p.num_tile_cols - 1)]
            p.tile_row_heights = [r.ue() + 1 for _ in range(p.num_tile_rows - 1)]
        p.loop_filter_across_tiles = r.flag()
    p.loop_filter_across_slices = r.flag()
    if r.flag():  # deblocking_filter_control_present
        p.deblocking_override_enabled = r.flag()
        p.deblocking_disabled = r.flag()
        if not p.deblocking_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.flag():  # pps_scaling_list_data_present
        p.scaling_list_data = parse_scaling_list_data(r)
    p.lists_modification_present = r.flag()
    p.log2_parallel_merge_level = 2 + r.ue()
    p.slice_header_extension_present = r.flag()
    if r.flag():  # pps_extension_present
        range_ext = r.flag()
        r.flag(); r.flag()
        r.u(5)
        if range_ext:
            if p.transform_skip_enabled:
                p.log2_max_transform_skip_size = 2 + r.ue()
            p.cross_component_prediction = r.flag()
            p.chroma_qp_offset_list_enabled = r.flag()
            if p.chroma_qp_offset_list_enabled:
                p.diff_cu_chroma_qp_offset_depth = r.ue()
                n = r.ue() + 1
                p.chroma_qp_offset_list = [(r.se(), r.se()) for _ in range(n)]
            p.sao_offset_scale_luma = r.ue()
            p.sao_offset_scale_chroma = r.ue()
    return p


B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


@dataclass
class SliceHeader:
    nal_type: int = 0
    temporal_id: int = 0
    first_slice_in_pic: int = 0
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent: int = 0
    segment_address: int = 0
    slice_type: int = I_SLICE
    pic_output_flag: int = 1
    poc_lsb: int = 0
    poc: int = 0
    rps: ShortTermRPS = None
    lt_poc: list = field(default_factory=list)       # long-term POCs (full, derived later)
    lt_used: list = field(default_factory=list)
    lt_poc_lsb: list = field(default_factory=list)
    lt_msb_present: list = field(default_factory=list)
    lt_delta_poc_msb: list = field(default_factory=list)
    temporal_mvp: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx: list = field(default_factory=lambda: [0, 0])
    ref_pic_list_modification: list = None           # [listL0 or None, listL1 or None]
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    wp_luma: list = None     # per list, per ref: (flag, weight, offset)
    wp_chroma: list = None   # per list, per ref: (flag, (wCb,oCb),(wCr,oCr))
    wp_log2_denom_luma: int = 0
    wp_log2_denom_chroma: int = 0
    max_num_merge_cand: int = 5
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    cu_chroma_qp_offset_enabled: int = 0
    deblocking_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: int = 0
    entry_points: list = field(default_factory=list)
    data_bit_offset: int = 0      # bit offset of slice data start in RBSP


def parse_slice_header(rbsp: bytes, nal_type: int, temporal_id: int,
                       sps_map, pps_map) -> SliceHeader:
    r = BitReader(rbsp)
    sh = SliceHeader(nal_type=nal_type, temporal_id=temporal_id)
    sh.first_slice_in_pic = r.flag()
    if nalmod.is_irap(nal_type):
        sh.no_output_of_prior_pics = r.flag()
    sh.pps_id = r.ue()
    pps = pps_map[sh.pps_id]
    sps = sps_map[pps.sps_id]
    if not sh.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            sh.dependent = r.flag()
        addr_bits = max(1, math.ceil(math.log2(sps.pic_size_ctbs)))
        sh.segment_address = r.u(addr_bits)
    if not sh.dependent:
        for _ in range(pps.num_extra_slice_header_bits):
            r.flag()
        sh.slice_type = r.ue()
        if pps.output_flag_present:
            sh.pic_output_flag = r.flag()
        if sps.separate_colour_plane:
            r.u(2)
        if not nalmod.is_idr(nal_type):
            sh.poc_lsb = r.u(sps.log2_max_poc_lsb)
            st_sps_flag = r.flag()
            if not st_sps_flag:
                sh.rps = _parse_st_rps(r, len(sps.st_rps), sps.st_rps, len(sps.st_rps))
            else:
                idx = 0
                if len(sps.st_rps) > 1:
                    idx = r.u(max(1, math.ceil(math.log2(len(sps.st_rps)))))
                sh.rps = sps.st_rps[idx]
            if sps.long_term_ref_pics_present:
                num_lt_sps = r.ue() if sps.num_long_term_ref_pics_sps > 0 else 0
                num_lt_pics = r.ue()
                prev_delta_msb = 0
                for i in range(num_lt_sps + num_lt_pics):
                    if i < num_lt_sps:
                        lt_idx = 0
                        if sps.num_long_term_ref_pics_sps > 1:
                            lt_idx = r.u(math.ceil(math.log2(sps.num_long_term_ref_pics_sps)))
                        sh.lt_poc_lsb.append(sps.lt_ref_poc_lsb_sps[lt_idx])
                        sh.lt_used.append(sps.lt_used_by_curr_sps[lt_idx])
                    else:
                        sh.lt_poc_lsb.append(r.u(sps.log2_max_poc_lsb))
                        sh.lt_used.append(r.flag())
                    msb_present = r.flag()
                    sh.lt_msb_present.append(msb_present)
                    if msb_present:
                        delta = r.ue()
                        if i not in (0, num_lt_sps):
                            delta += prev_delta_msb
                        sh.lt_delta_poc_msb.append(delta)
                        prev_delta_msb = delta
                    else:
                        sh.lt_delta_poc_msb.append(0)
            if sps.temporal_mvp_enabled:
                sh.temporal_mvp = r.flag()
        else:
            sh.rps = ShortTermRPS()
        if sps.sao_enabled:
            sh.sao_luma = r.flag()
            if sps.chroma_format_idc != 0:
                sh.sao_chroma = r.flag()
        if sh.slice_type in (P_SLICE, B_SLICE):
            sh.num_ref_idx = [pps.num_ref_l0_default, pps.num_ref_l1_default]
            if r.flag():  # num_ref_idx_active_override
                sh.num_ref_idx[0] = r.ue() + 1
                if sh.slice_type == B_SLICE:
                    sh.num_ref_idx[1] = r.ue() + 1
            if sh.slice_type != B_SLICE:
                sh.num_ref_idx[1] = 0
            num_pic_total_curr = 0
            if sh.rps is not None:
                num_pic_total_curr = sum(sh.rps.used) + sum(sh.lt_used)
            if pps.lists_modification_present and num_pic_total_curr > 1:
                nbits = math.ceil(math.log2(num_pic_total_curr))
                mods = [None, None]
                if r.flag():
                    mods[0] = [r.u(nbits) for _ in range(sh.num_ref_idx[0])]
                if sh.slice_type == B_SLICE and r.flag():
                    mods[1] = [r.u(nbits) for _ in range(sh.num_ref_idx[1])]
                sh.ref_pic_list_modification = mods
            if sh.slice_type == B_SLICE:
                sh.mvd_l1_zero = r.flag()
            if pps.cabac_init_present:
                sh.cabac_init_flag = r.flag()
            if sh.temporal_mvp:
                if sh.slice_type == B_SLICE:
                    sh.collocated_from_l0 = r.flag()
                if ((sh.collocated_from_l0 and sh.num_ref_idx[0] > 1) or
                        (not sh.collocated_from_l0 and sh.num_ref_idx[1] > 1)):
                    sh.collocated_ref_idx = r.ue()
            if ((pps.weighted_pred and sh.slice_type == P_SLICE) or
                    (pps.weighted_bipred and sh.slice_type == B_SLICE)):
                _parse_pred_weight_table(r, sh, sps)
            sh.max_num_merge_cand = 5 - r.ue()
        sh.qp = pps.init_qp + r.se()
        if pps.slice_chroma_qp_offsets_present:
            sh.cb_qp_offset = r.se()
            sh.cr_qp_offset = r.se()
        if pps.chroma_qp_offset_list_enabled:
            sh.cu_chroma_qp_offset_enabled = r.flag()
        deblocking_override = 0
        sh.deblocking_disabled = pps.deblocking_disabled
        sh.beta_offset_div2 = pps.beta_offset_div2
        sh.tc_offset_div2 = pps.tc_offset_div2
        if pps.deblocking_override_enabled:
            deblocking_override = r.flag()
        if deblocking_override:
            sh.deblocking_disabled = r.flag()
            if not sh.deblocking_disabled:
                sh.beta_offset_div2 = r.se()
                sh.tc_offset_div2 = r.se()
        sh.loop_filter_across_slices = pps.loop_filter_across_slices
        if pps.loop_filter_across_slices and (
                sh.sao_luma or sh.sao_chroma or not sh.deblocking_disabled):
            sh.loop_filter_across_slices = r.flag()
    if pps.tiles_enabled or pps.entropy_coding_sync:
        num_entry_points = r.ue()
        if num_entry_points > 0:
            offset_len = r.ue() + 1
            sh.entry_points = [r.u(offset_len) + 1 for _ in range(num_entry_points)]
    if pps.slice_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.u(8)
    # byte_alignment(): one alignment_bit_equal_to_one, then zero pad —
    # consumed even when already aligned (Rec. H.265 7.3.2.8)
    r.flag()
    r.byte_align()
    sh.data_bit_offset = r.pos
    return sh


def _parse_pred_weight_table(r: BitReader, sh: SliceHeader, sps: SPS):
    """pred_weight_table() — spec 7.3.6.3; reference TDecCAVLC xParsePredWeightTable."""
    sh.wp_log2_denom_luma = r.ue()
    has_chroma = sps.chroma_format_idc != 0
    if has_chroma:
        sh.wp_log2_denom_chroma = sh.wp_log2_denom_luma + r.se()
    num_lists = 2 if sh.slice_type == B_SLICE else 1
    sh.wp_luma = [[None] * sh.num_ref_idx[l] for l in range(2)]
    sh.wp_chroma = [[None] * sh.num_ref_idx[l] for l in range(2)]
    for l in range(num_lists):
        luma_flags = [r.flag() for _ in range(sh.num_ref_idx[l])]
        chroma_flags = [0] * sh.num_ref_idx[l]
        if has_chroma:
            chroma_flags = [r.flag() for _ in range(sh.num_ref_idx[l])]
        for i in range(sh.num_ref_idx[l]):
            denom_l = 1 << sh.wp_log2_denom_luma
            if luma_flags[i]:
                w = denom_l + r.se()
                o = r.se()
                sh.wp_luma[l][i] = (1, w, o)
            else:
                sh.wp_luma[l][i] = (0, denom_l, 0)
            denom_c = 1 << sh.wp_log2_denom_chroma
            if chroma_flags[i]:
                # offset derives from the weight (Rec. 7.4.7.3 ChromaOffsetL;
                # reference TDecCAVLC xParsePredWeightTable)
                rng = (1 << (sps.bit_depth_chroma - 1)) \
                    if sps.high_precision_offsets else 128
                pairs = []
                for _ in range(2):
                    w = denom_c + r.se()
                    delta_o = r.se()
                    pred = rng - ((rng * w) >> sh.wp_log2_denom_chroma)
                    o = min(max(delta_o + pred, -rng), rng - 1)
                    pairs.append((w, o))
                sh.wp_chroma[l][i] = (1, pairs[0], pairs[1])
            else:
                sh.wp_chroma[l][i] = (0, (denom_c, 0), (denom_c, 0))
