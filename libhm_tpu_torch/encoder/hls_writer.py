# Copied from libhm_tpu/encoder/hls_writer.py
"""High-level syntax writing: SPS/PPS/slice headers, NAL/EBSP, hash SEI.

Rebuild of the reference's TEncCavlc / NALwrite / SEIwrite
(source/Lib/TLibEncoder/TEncCavlc.cpp, NALwrite.cpp, SEIwrite.cpp) for the
encoder's minimal-feature profile; extended as encoder tools land.
"""
import hashlib

from .cabac_enc import BitWriter


def epb_positions(rbsp: bytes):
    """RBSP indices p where add_emulation_prevention inserts a 0x03 byte
    immediately BEFORE rbsp[p] (for EBSP-domain entry point offsets)."""
    out = []
    zeros = 0
    for i, b in enumerate(rbsp):
        if zeros >= 2 and b <= 3:
            out.append(i)
            zeros = 0
        zeros = zeros + 1 if b == 0 else 0
    return out


def add_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    hdr = bytes([(nal_type << 1) & 0x7E, 1 + temporal_id])
    return b"\x00\x00\x00\x01" + add_emulation_prevention(hdr + rbsp)


def _level_idc(cfg):
    """general_level_idc = 30 * level (Rec. A.4); cfg 'Level' strings like
    '4', '4.1', '6.2' (reference TAppEncCfg Level option)."""
    try:
        return int(round(float(getattr(cfg, "level", "4") or "4") * 30))
    except (TypeError, ValueError):
        return 120


def write_ptl(w: BitWriter, profile_idc=1, cfg=None):
    # profile_idc: 1 = Main, 2 = Main10, 4 = RExt
    high_tier = cfg is not None and \
        str(getattr(cfg, "tier", "main")).lower() == "high"
    w.put_bits(0, 2)            # profile_space
    w.put(1 if high_tier else 0)   # tier
    w.put_bits(profile_idc, 5)
    for i in range(32):
        w.put(1 if i == profile_idc else 0)
    w.put(1)                    # progressive_source
    w.put(0)                    # interlaced
    w.put(1)                    # non_packed
    w.put(1)                    # frame_only
    if profile_idc == 4 and cfg is not None:
        # RExt constraint flags (Rec. A.3.5): max bit depth / chroma format
        bd = cfg.bit_depth
        fmt = cfg.chroma_format_idc
        w.put(1 if bd <= 12 else 0)   # max_12bit
        w.put(1 if bd <= 10 else 0)   # max_10bit
        w.put(1 if bd <= 8 else 0)    # max_8bit
        w.put(1 if fmt <= 2 else 0)   # max_422chroma
        w.put(1 if fmt <= 1 else 0)   # max_420chroma
        w.put(1 if fmt == 0 else 0)   # max_monochrome
        w.put(1 if getattr(cfg, "intra_constraint", False) else 0)
        w.put(0)                      # one_picture_only
        w.put(0)                      # lower_bit_rate
        w.put_bits(0, 32)
        w.put_bits(0, 3)              # remaining reserved (44 - 9 - 32)
    else:
        w.put_bits(0, 32)
        w.put_bits(0, 12)             # 44 reserved bits
    w.put_bits(_level_idc(cfg) if cfg is not None else 120, 8)


def _profile_idc(cfg):
    if cfg.chroma_format_idc != 1:
        return 4  # Format-range extensions
    return 2 if cfg.bit_depth > 8 else 1


def write_vps(cfg) -> bytes:
    w = BitWriter()
    w.put_bits(0, 4)    # vps id
    w.put_bits(3, 2)    # reserved_three
    w.put_bits(0, 6)    # reserved zero
    w.put_bits(0, 3)    # max_sub_layers_minus1
    w.put(1)            # temporal_id_nesting
    w.put_bits(0xFFFF, 16)
    write_ptl(w, _profile_idc(cfg), cfg)
    w.put(0)            # sub_layer_ordering_info_present
    w.ue(cfg.max_dec_pic_buffering - 1)
    w.ue(cfg.num_reorder_pics)
    w.ue(0)             # max_latency
    w.put_bits(0, 6)    # max_layer_id
    w.ue(0)             # num_layer_sets_minus1
    w.put(0)            # timing_info_present
    w.put(0)            # extension
    w.byte_align_one()
    return w.data()


def write_scaling_list_data(w, data):
    """scaling_list_data() syntax (Rec. 7.3.4; reference TEncCavlc::
    codeScalingList/xCodeScalingList TEncCavlc.cpp:1470-1532): explicit
    DPCM lists in up-right diagonal scan for the matrices present in
    `data` ({(size_id, matrix_id): (raster_list, dc)}), default-pred for
    the rest.  Mirrors hostdec.params.parse_scaling_list_data."""
    from ..hostdec.tables import scan_order, SCAN_DIAG
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for matrix_id in range(0, 6, step):
            entry = data.get((size_id, matrix_id))
            if entry is None:
                w.put(0)            # scaling_list_pred_mode: from ref
                w.ue(0)            # delta 0 -> default list
                continue
            raster, dc = entry
            w.put(1)                # explicit list
            base = 4 if size_id == 0 else 8
            next_coef = 8
            if size_id > 1:
                w.se(dc - 8)
                next_coef = dc
            for (sx, sy) in scan_order(base, base, SCAN_DIAG):
                c = raster[sy * base + sx]
                d = c - next_coef
                if d > 127:
                    d -= 256
                elif d < -128:
                    d += 256
                w.se(d)
                next_coef = c


def write_sps(cfg) -> bytes:
    w = BitWriter()
    w.put_bits(0, 4)    # vps id
    w.put_bits(0, 3)    # max_sub_layers_minus1
    w.put(1)            # temporal_id_nesting
    write_ptl(w, _profile_idc(cfg), cfg)
    w.ue(0)             # sps id
    w.ue(cfg.chroma_format_idc)
    if cfg.chroma_format_idc == 3:
        w.put(0)        # separate_colour_plane_flag
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.put(0)            # conformance_window
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.log2_max_poc_lsb - 4)
    w.put(1)            # sub_layer_ordering_info_present
    w.ue(cfg.max_dec_pic_buffering - 1)
    w.ue(cfg.num_reorder_pics)
    w.ue(0)
    w.ue(cfg.log2_min_cb - 3)
    w.ue(cfg.log2_ctb - cfg.log2_min_cb)
    w.ue(cfg.log2_min_tb - 2)
    w.ue(cfg.log2_max_tb - cfg.log2_min_tb)
    w.ue(cfg.max_tr_hierarchy_inter)
    w.ue(cfg.max_tr_hierarchy_intra)
    if getattr(cfg, "scaling_list", False):
        w.put(1)        # scaling_list_enabled
        data = getattr(cfg, "scaling_list_data", None)
        if data:
            w.put(1)    # sps_scaling_list_data_present
            write_scaling_list_data(w, data)
        else:
            w.put(0)    # default lists
    else:
        w.put(0)        # scaling_list_enabled
    w.put(1 if getattr(cfg, "amp", False) else 0)  # amp_enabled
    w.put(1 if cfg.sao else 0)
    if getattr(cfg, "pcm_enabled", False):
        w.put(1)        # pcm_enabled
        w.put_bits(cfg.bit_depth - 1, 4)  # pcm_sample_bit_depth_luma_minus1
        w.put_bits(cfg.bit_depth - 1, 4)  # ..._chroma_minus1
        w.ue(getattr(cfg, "log2_min_ipcm", 3) - 3)
        w.ue(getattr(cfg, "log2_max_ipcm", 5) -
             getattr(cfg, "log2_min_ipcm", 3))
        # filters apply normally unless the cfg disables them over PCM
        w.put(1 if getattr(cfg, "pcm_filter_disabled", False) else 0)
    else:
        w.put(0)        # pcm_enabled
    w.ue(len(cfg.st_rps))   # num_short_term_ref_pic_sets
    # candidate sets the slice headers reference by index (reference
    # TEncTop::xInitRPS builds one per GOP entry; TEncCavlc::codeShortTermRefPicSet).
    # Each entry is (neg_deltas, pos_deltas) with used_by_curr=1, matching
    # the explicit slice-header form below; a bare list means neg-only.
    for i, rps in enumerate(cfg.st_rps):
        if i != 0:
            w.put(0)    # inter_ref_pic_set_prediction_flag
        negs, poss = (rps, []) if not isinstance(rps, tuple) else rps[:2]
        w.ue(len(negs))
        w.ue(len(poss))
        prev = 0
        for dp in sorted(negs, reverse=True):   # closest first
            w.ue(prev - dp - 1)
            prev = dp
            w.put(1)    # used_by_curr
        prev = 0
        for dp in sorted(poss):
            w.ue(dp - prev - 1)
            prev = dp
            w.put(1)    # used_by_curr
    w.put(0)            # long_term_ref_pics_present
    w.put(1 if cfg.tmvp else 0)
    w.put(1 if cfg.strong_intra_smoothing else 0)
    if getattr(cfg, "vui_enabled", False):
        w.put(1)        # vui_parameters_present
        _write_vui(w, cfg)
    else:
        w.put(0)        # vui
    w.put(0)            # sps_extension
    w.byte_align_one()
    return w.data()


def _write_vui(w: BitWriter, cfg):
    """vui_parameters() with timing info + (optionally) HRD parameters
    (reference TEncCavlc::codeVUI / codeHrdParameters; Rec. E.2.1-E.2.2).
    Mirrors hostdec.params._parse_vui."""
    w.put(0)            # aspect_ratio_info_present
    w.put(0)            # overscan_info_present
    w.put(0)            # video_signal_type_present
    w.put(0)            # chroma_loc_info_present
    w.put(0)            # neutral_chroma_indication
    w.put(1 if getattr(cfg, "field_coding", False) else 0)  # field_seq
    w.put(1)            # frame_field_info_present
    w.put(0)            # default_display_window
    w.put(1)            # vui_timing_info_present
    fps = getattr(cfg, "fps", 30.0)
    w.put_bits(1000, 32)                      # num_units_in_tick
    w.put_bits(int(round(fps * 1000)), 32)    # time_scale
    w.put(0)            # poc_proportional_to_timing
    hrd = getattr(cfg, "hrd_enabled", False)
    w.put(1 if hrd else 0)                    # hrd_parameters_present
    if hrd:
        _write_hrd(w, cfg)
    w.put(0)            # bitstream_restriction
    cfg.vui_written = True


def _write_hrd(w: BitWriter, cfg):
    """hrd_parameters(): NAL HRD, one CPB, 24-bit delay fields."""
    w.put(1)            # nal_hrd_parameters_present
    w.put(0)            # vcl_hrd_parameters_present
    w.put(0)            # sub_pic_hrd_params_present
    w.put_bits(0, 4)    # bit_rate_scale
    w.put_bits(0, 4)    # cpb_size_scale
    w.put_bits(23, 5)   # initial_cpb_removal_delay_length_minus1
    w.put_bits(23, 5)   # au_cpb_removal_delay_length_minus1
    w.put_bits(23, 5)   # dpb_output_delay_length_minus1
    # one sub-layer (max_sub_layers_minus1 == 0)
    w.put(0)            # fixed_pic_rate_general
    w.put(0)            # fixed_pic_rate_within_cvs
    w.put(0)            # low_delay_hrd
    w.ue(0)             # cpb_cnt_minus1
    rate = getattr(cfg, "rate_kbps", None) or 1000
    w.ue(max(0, rate * 1000 // 400 - 1))     # bit_rate_value_minus1
    w.ue(max(0, rate * 2000 // 1024 - 1))    # cpb_size_value_minus1
    w.put(1)            # cbr_flag


def write_pps(cfg) -> bytes:
    w = BitWriter()
    w.ue(0)             # pps id
    w.ue(0)             # sps id
    w.put(1 if getattr(cfg, "dependent_slices", False) else 0)
    # ^ dependent_slice_segments_enabled
    w.put(0)            # output_flag_present
    w.put_bits(0, 3)    # extra slice header bits
    w.put(1 if getattr(cfg, "sign_hiding", False) else 0)  # sign_data_hiding
    # cabac_init_present_flag is always on (reference TEncTop.cpp:761
    # CABAC_INIT_PRESENT_FLAG): P/B slices signal per-slice which init
    # table the encoder's adaptive selection chose
    w.put(1)
    w.ue(cfg.num_ref_l0 - 1)
    w.ue(cfg.num_ref_l1 - 1)
    w.se(cfg.qp - 26)   # init_qp_minus26
    w.put(0)            # constrained_intra_pred
    w.put(1 if getattr(cfg, "transform_skip", False) else 0)  # transform_skip
    if getattr(cfg, "adaptive_qp", False) or \
            (getattr(cfg, "rate_kbps", None) and
             getattr(cfg, "rate_ctu_level", True)):
        w.put(1)        # cu_qp_delta_enabled (AQ / per-LCU rate control)
        w.ue(0)         # diff_cu_qp_delta_depth (QG = CTU)
    else:
        w.put(0)        # cu_qp_delta
    w.se(0)             # cb_qp_offset
    w.se(0)             # cr_qp_offset
    w.put(0)            # slice_chroma_qp_offsets_present
    w.put(1 if getattr(cfg, "weighted_pred", False) else 0)
    w.put(1 if getattr(cfg, "weighted_bipred", False) else 0)
    w.put(1 if getattr(cfg, "lossless", False) else 0)  # transquant_bypass
    tile_cols = getattr(cfg, "tile_cols", 1)
    tile_rows = getattr(cfg, "tile_rows", 1)
    tiles = tile_cols > 1 or tile_rows > 1
    w.put(1 if tiles else 0)                       # tiles_enabled
    w.put(1 if getattr(cfg, "wpp", False) else 0)  # entropy_coding_sync
    if tiles:
        w.ue(tile_cols - 1)
        w.ue(tile_rows - 1)
        w.put(1)        # uniform_spacing
        w.put(1 if getattr(cfg, "lf_cross_tiles", True) else 0)
    w.put(1 if getattr(cfg, "lf_cross_slices", True) else 0)
    w.put(1)            # deblocking_filter_control_present
    w.put(0)            # deblocking_override_enabled
    w.put(0 if cfg.deblock else 1)  # pps_deblocking_disabled
    if cfg.deblock:
        w.se(0)
        w.se(0)
    w.put(0)            # pps_scaling_list
    w.put(0)            # lists_modification_present
    w.ue(0)             # log2_parallel_merge_level_minus2
    w.put(0)            # slice_header_extension
    w.put(0)            # pps_extension
    w.byte_align_one()
    return w.data()


def _write_pred_weight_table(w, cfg, wp, wp_l1=None):
    """pred_weight_table() (Rec. 7.3.6.3; reference TEncCAVLC
    xCodePredWeightTable).  wp/wp_l1: per-active-ref entries for L0/L1,
    each None or {'w': [wY,wCb,wCr], 'o': [oY,oCb,oCr], 'denom': d}.
    Chroma offsets are coded as deltas from the weight-derived predictor."""
    both = list(wp) + list(wp_l1 or [])
    denom = next(e["denom"] for e in both if e) if any(both) else 6
    has_chroma = cfg.chroma_format_idc != 0
    w.ue(denom)                      # luma_log2_weight_denom
    if has_chroma:
        w.se(0)                      # delta_chroma_log2_weight_denom

    def one_list(entries):
        for e in entries:
            w.put(1 if e else 0)     # luma_weight_lX_flag
        if has_chroma:
            for e in entries:
                w.put(1 if e else 0)  # chroma_weight_lX_flag
        rng = 128                    # high_precision_offsets off
        for e in entries:
            if not e:
                continue
            w.se(e["w"][0] - (1 << denom))
            w.se(e["o"][0])
            if has_chroma:
                for j in (1, 2):
                    w.se(e["w"][j] - (1 << denom))
                    pred = rng - ((rng * e["w"][j]) >> denom)
                    w.se(e["o"][j] - pred)
    one_list(wp)
    if wp_l1 is not None:
        one_list(wp_l1)


def write_slice_header(cfg, nal_type, poc, slice_type, slice_qp,
                       rps_idx=0, rps=None, wp=None, segment_address=0,
                       entry_points=None, wp_l1=None,
                       dependent=False, sao_flags=None,
                       num_ref=None, cabac_init_flag=0,
                       mvd_l1_zero=0, col_from_l0=1) -> BitWriter:
    """Returns the writer positioned after the header (byte-aligned).

    rps: optional explicit (neg_deltas, pos_deltas) short-term RPS written
    in the slice header (short_term_ref_pic_set with sps_flag=0); deltas
    are used_by_curr=1. Otherwise the SPS set rps_idx is referenced.
    wp: optional pred_weight_table entries (P slices with weighted_pred).
    segment_address: CTU address of this slice segment (0 = first slice).
    entry_points: EBSP-domain substream byte lengths (WPP rows / tiles).
    """
    w = BitWriter()
    w.put(1 if segment_address == 0 else 0)  # first_slice_segment_in_pic
    if 16 <= nal_type <= 23:
        w.put(0)        # no_output_of_prior_pics
    w.ue(0)             # pps id
    if segment_address:
        if getattr(cfg, "dependent_slices", False):
            w.put(1 if dependent else 0)  # dependent_slice_segment_flag
        ctb = 1 << cfg.log2_ctb
        nctb = ((cfg.width + ctb - 1) >> cfg.log2_ctb) * \
               ((cfg.height + ctb - 1) >> cfg.log2_ctb)
        w.put_bits(segment_address, max(1, (nctb - 1).bit_length()))
    if dependent:
        # dependent segments carry only the address (+ entry points)
        tiles_d = getattr(cfg, "tile_cols", 1) > 1 or \
            getattr(cfg, "tile_rows", 1) > 1
        if tiles_d or getattr(cfg, "wpp", False):
            eps = entry_points or []
            w.ue(len(eps))
            if eps:
                olen = max(1, max(e - 1 for e in eps).bit_length())
                w.ue(olen - 1)
                for e in eps:
                    w.put_bits(e - 1, olen)
        w.byte_align_one()
        return w
    w.ue(slice_type)    # 0=B 1=P 2=I
    if nal_type not in (19, 20):
        w.put_bits(poc & ((1 << cfg.log2_max_poc_lsb) - 1), cfg.log2_max_poc_lsb)
        if rps is not None:
            w.put(0)    # short_term_ref_pic_set_sps_flag: explicit
            if len(cfg.st_rps) > 0:
                w.put(0)  # inter_ref_pic_set_prediction_flag
            negs, poss = rps[0], rps[1]
            # CRA slice headers retain pictures for the RASL leading
            # pictures with used_by_curr = 0 (NumPocTotalCurr must be 0)
            used = 1 if (len(rps) < 3 or rps[2]) else 0
            w.ue(len(negs))
            w.ue(len(poss))
            prev = 0
            for dp in sorted(negs, reverse=True):   # closest first
                w.ue(prev - dp - 1)
                prev = dp
                w.put(used)
            prev = 0
            for dp in sorted(poss):
                w.ue(dp - prev - 1)
                prev = dp
                w.put(used)
        else:
            w.put(1)    # short_term_ref_pic_set_sps_flag
            import math
            if len(cfg.st_rps) > 1:
                w.put_bits(rps_idx, max(1, math.ceil(math.log2(len(cfg.st_rps)))))
        if cfg.tmvp:
            w.put(1)    # slice_temporal_mvp_enabled
    if cfg.sao:
        sl, sc = (1, 1) if sao_flags is None else sao_flags
        w.put(1 if sl else 0)       # slice_sao_luma_flag
        if cfg.chroma_format_idc != 0:
            w.put(1 if sc else 0)   # slice_sao_chroma_flag
    if slice_type in (0, 1):
        # per-slice active ref counts (GOP-entry #ref_pics_active); the
        # PPS carries cfg.num_ref_l0/l1 as defaults
        n0 = num_ref[0] if num_ref else cfg.num_ref_l0
        n1 = (num_ref[1] if num_ref else cfg.num_ref_l1) \
            if slice_type == 0 else 0
        override = n0 != cfg.num_ref_l0 or \
            (slice_type == 0 and n1 != cfg.num_ref_l1)
        w.put(1 if override else 0)  # num_ref_idx_active_override
        if override:
            w.ue(n0 - 1)
            if slice_type == 0:
                w.ue(n1 - 1)
        if slice_type == 0:
            w.put(mvd_l1_zero)  # mvd_l1_zero_flag (GPB, TEncGOP.cpp:1053)
        w.put(cabac_init_flag)  # cabac_init_flag (P/B init table swap)
        if cfg.tmvp:
            if slice_type == 0:
                # collocated direction per HM's closest-ref QP rule
                # (TEncGOP.cpp:648-689: col pic from L1 unless the
                # closest future ref has a lower GOP QP offset)
                w.put(col_from_l0)
            n_col = n0 if (slice_type == 1 or col_from_l0) else n1
            if n_col > 1:
                w.ue(0)             # collocated_ref_idx
        if getattr(cfg, "weighted_pred", False) and slice_type == 1:
            _write_pred_weight_table(w, cfg, wp or [None] * n0)
        elif getattr(cfg, "weighted_bipred", False) and slice_type == 0:
            _write_pred_weight_table(w, cfg, wp or [None] * n0,
                                     wp_l1 or [None] * n1)
        w.ue(5 - cfg.max_merge_cand)  # five_minus_max_num_merge_cand
    w.se(slice_qp - cfg.qp)
    # deblocking control (none: pps says disabled/enabled w/o override)
    # loop_filter_across_slices present iff sao or deblock on (and only
    # when the PPS default says 1: slice_loop_filter_across_slices is
    # conditioned on pps_loop_filter_across_slices_enabled_flag)
    if (cfg.sao or cfg.deblock) and getattr(cfg, "lf_cross_slices", True):
        w.put(1)
    tiles = getattr(cfg, "tile_cols", 1) > 1 or \
        getattr(cfg, "tile_rows", 1) > 1
    if tiles or getattr(cfg, "wpp", False):
        eps = entry_points or []
        w.ue(len(eps))
        if eps:
            olen = max(1, max(e - 1 for e in eps).bit_length())
            w.ue(olen - 1)
            for e in eps:
                w.put_bits(e - 1, olen)
    w.byte_align_one()
    return w


def hash_sei_md5(planes, bit_depth) -> bytes:
    """decoded_picture_hash SEI with MD5 (reference TComPicYuvMD5 packing)."""
    payload = bytearray()
    payload.append(0)  # hash_type = MD5
    for p in planes:
        md5 = hashlib.md5()
        if bit_depth <= 8:
            md5.update(p.astype("uint8").tobytes())
        else:
            md5.update(p.astype("<u2").tobytes())
        payload += md5.digest()
    sei = bytearray()
    sei.append(132)          # payload_type = decoded_picture_hash
    sei.append(len(payload))
    sei += payload
    sei.append(0x80)         # rbsp trailing
    return bytes(sei)
