# Copied from libhm_tpu/hostdec/sei.py
"""SEI message parsing (reference SEIread.cpp / SEI.h).

Round-1 scope: the payloads the decoder acts on — decoded_picture_hash
(the conformance oracle), plus generic payload enumeration so callers can
inspect any SEI (type, raw bytes) like the reference's SEI list.
"""
import hashlib

# payload types (Rec. H.265 Annex D; reference SEI.h:55-86)
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_PAN_SCAN_RECT = 2
SEI_FILLER_PAYLOAD = 3
SEI_USER_DATA_REGISTERED_ITU_T_T35 = 4
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_SCENE_INFO = 9
SEI_TONE_MAPPING_INFO = 23
SEI_KNEE_FUNCTION_INFO = 24
SEI_FRAME_PACKING = 45
SEI_DISPLAY_ORIENTATION = 47
SEI_SOP_DESCRIPTION = 128
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_DECODING_UNIT_INFO = 130
SEI_TEMPORAL_LEVEL0_INDEX = 131
SEI_DECODED_PICTURE_HASH = 132
SEI_SCALABLE_NESTING = 133
SEI_REGION_REFRESH_INFO = 134
SEI_NO_DISPLAY = 135
SEI_TIME_CODE = 136
SEI_MASTERING_DISPLAY = 137
SEI_SEGM_RECT_FRAME_PACKING = 138
SEI_TEMP_MOTION_CONSTRAINED_TILE_SETS = 139
SEI_CHROMA_SAMPLING_FILTER_HINT = 140

SEI_NAMES = {
    0: "Buffering period", 1: "Picture timing", 2: "Pan-scan rectangle",
    3: "Filler payload", 4: "User data registered", 5: "User data unregistered",
    6: "Recovery point", 9: "Scene information", 23: "Tone mapping info",
    24: "Knee function info", 45: "Frame packing arrangement",
    47: "Display orientation", 128: "Structure of pictures info",
    129: "Active parameter sets", 130: "Decoding unit info",
    131: "Temporal sub-layer zero index", 132: "Decoded picture hash",
    133: "Scalable nesting", 134: "Region refresh info", 135: "No display",
    136: "Time code", 137: "Mastering display colour volume",
    138: "Segmented rect frame packing", 139: "Temporal motion constrained tile sets",
    140: "Chroma sampling filter hint",
}

HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2


def parse_sei_rbsp(rbsp: bytes):
    """Returns [(payload_type, payload_bytes)] for one SEI NAL's RBSP."""
    out = []
    i = 0
    n = len(rbsp)
    while i < n:
        if rbsp[i] == 0x80 and i == n - 1:  # rbsp trailing
            break
        ptype = 0
        while i < n and rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        if i >= n:
            break
        ptype += rbsp[i]
        i += 1
        size = 0
        while i < n and rbsp[i] == 0xFF:
            size += 255
            i += 1
        if i >= n:
            break
        size += rbsp[i]
        i += 1
        out.append((ptype, bytes(rbsp[i:i + size])))
        i += size
    return out


class DecodedPictureHash:
    def __init__(self, payload: bytes, sps=None):
        self.method = payload[0]
        step = {HASH_MD5: 16, HASH_CRC: 2, HASH_CHECKSUM: 4}[self.method]
        self.digests = [payload[1 + i * step:1 + (i + 1) * step]
                        for i in range((len(payload) - 1) // step)]


def _plane_bytes(plane, bit_depth):
    if bit_depth <= 8:
        return plane.astype("uint8").tobytes()
    return plane.astype("<u2").tobytes()


def _crc(data: bytes) -> bytes:
    # reference TComPicYuvMD5 calcCRC (x^16 + x^12 + x^5 + 1, bit-serial)
    crc = 0xFFFF
    for byte in data:
        for bit in range(7, -1, -1):
            crcmsb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) + \
                ((crcmsb ^ ((byte >> bit) & 1)) * 0x1021 if
                 (crcmsb ^ ((byte >> bit) & 1)) else 0)
    for _ in range(16):
        crcmsb = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) + (0x1021 if crcmsb else 0)
    return bytes([(crc >> 8) & 0xFF, crc & 0xFF])


def _checksum(plane, bit_depth) -> bytes:
    # reference calcChecksum: xor of sample bytes with position mask
    h, w = plane.shape
    s = 0
    p = plane
    for y in range(h):
        row = p[y]
        for x in range(w):
            xor_mask = (x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)
            v = int(row[x])
            s = (s + ((v & 0xFF) ^ xor_mask)) & 0xFFFFFFFF
            if bit_depth > 8:
                s = (s + ((v >> 8) ^ xor_mask)) & 0xFFFFFFFF
    return s.to_bytes(4, "big")


def verify_picture_hash(planes, bit_depths, dph: DecodedPictureHash) -> bool:
    """planes: coded-size component arrays; returns True when all match."""
    for i, plane in enumerate(planes):
        bd = bit_depths[i]
        if dph.method == HASH_MD5:
            got = hashlib.md5(_plane_bytes(plane, bd)).digest()
        elif dph.method == HASH_CRC:
            got = _crc(_plane_bytes(plane, bd))
        else:
            got = _checksum(plane, bd)
        if i >= len(dph.digests) or got != dph.digests[i]:
            return False
    return True


# ---------------------------------------------------------------------------
# Typed payload decoders (reference SEIread.cpp xParseSEIxxx) for the
# payloads the reference decoder consumes; others stay available as raw
# (type, bytes) from parse_sei_rbsp.
class _Bits:
    def __init__(self, data):
        self.d = data
        self.p = 0

    def u(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1)
            self.p += 1
        return v

    def ue(self):
        z = 0
        while self.u(1) == 0 and self.p < len(self.d) * 8:
            z += 1
        return (1 << z) - 1 + (self.u(z) if z else 0)

    def se(self):
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)


class RecoveryPoint:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.recovery_poc_cnt = b.se()
        self.exact_match = b.u(1)
        self.broken_link = b.u(1)


class ActiveParameterSets:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.active_video_parameter_set_id = b.u(4)
        self.self_contained_cvs = b.u(1)
        self.no_parameter_set_update = b.u(1)
        self.num_sps_ids_minus1 = b.ue()
        self.active_seq_parameter_set_id = [
            b.ue() for _ in range(self.num_sps_ids_minus1 + 1)]


class UserDataUnregistered:
    def __init__(self, payload, sps=None):
        self.uuid = payload[:16]
        self.data = payload[16:]


class UserDataRegisteredT35:
    """Rec. D.2.6 / reference SEIread.cpp xParseSEIUserDataRegistered."""

    def __init__(self, payload, sps=None):
        self.country_code = payload[0]
        if self.country_code == 0xFF:
            self.country_code_extension = payload[1]
            self.data = payload[2:]
        else:
            self.country_code_extension = None
            self.data = payload[1:]


class PanScanRect:
    """Rec. D.2.4 / reference SEIread.cpp xParseSEIPanScanRect."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.rect_id = b.ue()
        self.cancel = b.u(1)
        self.rects = []
        self.persistence = None
        if not self.cancel:
            cnt = b.ue() + 1
            self.rects = [(b.se(), b.se(), b.se(), b.se())
                          for _ in range(cnt)]  # left, right, top, bottom
            self.persistence = b.u(1)


class MasteringDisplayColourVolume:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.primaries = [(b.u(16), b.u(16)) for _ in range(3)]
        self.white_point = (b.u(16), b.u(16))
        self.max_luminance = b.u(32)
        self.min_luminance = b.u(32)


class TimeCode:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.num_clock_ts = b.u(2)
        self.clock_ts = []
        for _ in range(self.num_clock_ts):
            ts = {}
            if b.u(1):  # clock_timestamp_flag
                ts["units_field_based"] = b.u(1)
                ts["counting_type"] = b.u(5)
                full = b.u(1)
                ts["discontinuity"] = b.u(1)
                ts["cnt_dropped"] = b.u(1)
                ts["n_frames"] = b.u(9)
                if full:
                    ts["seconds"] = b.u(6)
                    ts["minutes"] = b.u(6)
                    ts["hours"] = b.u(5)
            self.clock_ts.append(ts)


class BufferingPeriod:
    """Rec. D.2.2 / reference SEIread.cpp xParseSEIBufferingPeriod.
    Needs the active SPS's HRD parameters for field lengths."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.bp_seq_parameter_set_id = b.ue()
        hrd = sps.vui.hrd if sps is not None and sps.vui else None
        if hrd is None:
            self.raw = payload
            return
        if not hrd.sub_pic:
            self.irap_cpb_params_present = b.u(1)
        else:
            self.irap_cpb_params_present = 0
        L = hrd.initial_cpb_removal_delay_length
        if self.irap_cpb_params_present:
            self.cpb_delay_offset = b.u(hrd.au_cpb_removal_delay_length)
            self.dpb_delay_offset = b.u(hrd.dpb_output_delay_length)
        self.concatenation = b.u(1)
        self.au_cpb_removal_delay_delta = b.u(
            hrd.au_cpb_removal_delay_length) + 1
        self.nal_cpb, self.vcl_cpb = [], []
        nal_cnt = len(hrd.sub_layers[0][4])
        vcl_cnt = len(hrd.sub_layers[0][5])
        for lst, cnt in ((self.nal_cpb, nal_cnt), (self.vcl_cpb, vcl_cnt)):
            for _ in range(cnt):
                e = {"delay": b.u(L), "offset": b.u(L)}
                if hrd.sub_pic or self.irap_cpb_params_present:
                    e["alt_delay"] = b.u(L)
                    e["alt_offset"] = b.u(L)
                lst.append(e)


class PictureTiming:
    """Rec. D.2.3 / reference SEIread.cpp xParseSEIPictureTiming."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        vui = sps.vui if sps is not None else None
        if vui is None:
            self.raw = payload
            return
        if vui.frame_field_info_present:
            self.pic_struct = b.u(4)
            self.source_scan_type = b.u(2)
            self.duplicate_flag = b.u(1)
        hrd = vui.hrd
        if hrd is None or not (hrd.nal_hrd or hrd.vcl_hrd):
            return
        self.au_cpb_removal_delay = b.u(hrd.au_cpb_removal_delay_length) + 1
        self.pic_dpb_output_delay = b.u(hrd.dpb_output_delay_length)
        if hrd.sub_pic:
            self.pic_dpb_output_du_delay = b.u(hrd.dpb_output_delay_du_length)
            if hrd.sub_pic_cpb_params_in_pic_timing:
                self.num_decoding_units = b.ue() + 1
                self.du_common_cpb_removal_delay_flag = b.u(1)
                if self.du_common_cpb_removal_delay_flag:
                    self.du_common_cpb_removal_delay = b.u(
                        hrd.du_cpb_removal_delay_length) + 1
                self.num_nalus_in_du = []
                self.du_cpb_removal_delay = []
                for i in range(self.num_decoding_units):
                    self.num_nalus_in_du.append(b.ue() + 1)
                    if not self.du_common_cpb_removal_delay_flag and \
                            i < self.num_decoding_units - 1:
                        self.du_cpb_removal_delay.append(
                            b.u(hrd.du_cpb_removal_delay_length) + 1)


class DecodingUnitInfo:
    """Rec. D.2.21 / reference xParseSEIDecodingUnitInfo."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.decoding_unit_idx = b.ue()
        hrd = sps.vui.hrd if sps is not None and sps.vui else None
        if hrd is None:
            self.raw = payload
            return
        if not hrd.sub_pic_cpb_params_in_pic_timing:
            self.du_spt_cpb_removal_delay = b.u(
                hrd.du_cpb_removal_delay_length)
        self.dpb_output_du_delay_present = b.u(1)
        if self.dpb_output_du_delay_present:
            self.pic_spt_dpb_output_du_delay = b.u(
                hrd.dpb_output_delay_du_length)


class FramePacking:
    """Rec. D.2.16 / reference xParseSEIFramePacking."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.arrangement_id = b.ue()
        self.arrangement_cancel = b.u(1)
        if not self.arrangement_cancel:
            self.arrangement_type = b.u(7)
            self.quincunx_sampling = b.u(1)
            self.content_interpretation_type = b.u(6)
            self.spatial_flipping = b.u(1)
            self.frame0_flipped = b.u(1)
            self.field_views = b.u(1)
            self.current_frame_is_frame0 = b.u(1)
            self.frame0_self_contained = b.u(1)
            self.frame1_self_contained = b.u(1)
            if not self.quincunx_sampling and self.arrangement_type != 5:
                self.frame0_grid_x = b.u(4)
                self.frame0_grid_y = b.u(4)
                self.frame1_grid_x = b.u(4)
                self.frame1_grid_y = b.u(4)
            b.u(8)  # frame_packing_arrangement_reserved_byte
            self.arrangement_persistence = b.u(1)
        self.upsampled_aspect_ratio = b.u(1)


class SegmentedRectFramePacking:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.cancel = b.u(1)
        if not self.cancel:
            self.content_interpretation_type = b.u(2)
            self.persistence = b.u(1)


class DisplayOrientation:
    """Rec. D.2.17 / reference xParseSEIDisplayOrientation."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.cancel = b.u(1)
        if not self.cancel:
            self.hor_flip = b.u(1)
            self.ver_flip = b.u(1)
            self.anticlockwise_rotation = b.u(16)
            self.persistence = b.u(1)


class TemporalLevel0Index:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.tl0_idx = b.u(8)
        self.rap_idx = b.u(8)


class RegionRefreshInfo:
    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.refreshed_region_flag = b.u(1)


class NoDisplay:
    def __init__(self, payload, sps=None):
        pass


class ToneMappingInfo:
    """Rec. D.2.15 / reference xParseSEIToneMappingInfo."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.tone_map_id = b.ue()
        self.cancel = b.u(1)
        if self.cancel:
            return
        self.persistence = b.u(1)
        self.coded_data_bit_depth = b.u(8)
        self.target_bit_depth = b.u(8)
        self.model_id = b.ue()
        if self.model_id == 0:
            self.min_value = b.u(32)
            self.max_value = b.u(32)
        elif self.model_id == 1:
            self.sigmoid_midpoint = b.u(32)
            self.sigmoid_width = b.u(32)
        elif self.model_id == 2:
            n = 1 << self.target_bit_depth
            c = (self.coded_data_bit_depth + 7) >> 3
            self.start_of_coded_interval = [b.u(c * 8) for _ in range(n)]
        elif self.model_id == 3:
            self.num_pivots = b.u(16)
            c = (self.coded_data_bit_depth + 7) >> 3
            t = (self.target_bit_depth + 7) >> 3
            self.pivots = [(b.u(c * 8), b.u(t * 8))
                           for _ in range(self.num_pivots)]
        elif self.model_id == 4:
            self.camera_iso_speed_idc = b.u(8)
            if self.camera_iso_speed_idc == 255:
                self.camera_iso_speed_value = b.u(32)
            self.exposure_index_idc = b.u(8)
            if self.exposure_index_idc == 255:
                self.exposure_index_value = b.u(32)
            self.exposure_compensation_sign = b.u(1)
            self.exposure_compensation_numerator = b.u(16)
            self.exposure_compensation_denom_idc = b.u(16)
            self.ref_screen_luminance_white = b.u(32)
            self.extended_range_white_level = b.u(32)
            self.nominal_black_level_code = b.u(16)
            self.nominal_white_level_code = b.u(16)
            self.extended_white_level_code = b.u(16)


class SopDescription:
    """Rec. D.2.24 / reference xParseSEISOPDescription."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.sop_seq_parameter_set_id = b.ue()
        self.num_entries = b.ue() + 1
        self.entries = []
        for i in range(self.num_entries):
            e = {"vcl_nut": b.u(6), "temporal_id": b.u(3)}
            if e["vcl_nut"] != 19 and e["vcl_nut"] != 20:  # non-IDR
                e["st_rps_idx"] = b.ue()
            if i > 0:
                e["poc_delta"] = b.se()
            self.entries.append(e)


class ScalableNesting:
    """Rec. D.2.27 / reference xParseSEIScalableNesting: recursive."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.bitstream_subset = b.u(1)
        self.nesting_op_flag = b.u(1)
        if self.nesting_op_flag:
            self.default_op = b.u(1)
            if not self.default_op:
                n = b.ue() + 1
                self.ops = [(b.u(3), b.u(6)) for _ in range(n)]
        else:
            self.all_layers = b.u(1)
            if not self.all_layers:
                self.nesting_no_op_max_temporal_id_plus1 = b.u(3)
                n = b.ue()
                self.layer_ids = [b.u(6) for _ in range(n + 1)]
        # byte-align then nested SEI messages
        while b.p & 7:
            b.u(1)
        self.nested = decode_sei_payloads(payload[b.p >> 3:], sps)


class TempMotionConstrainedTileSets:
    """Rec. D.2.29 / reference xParseSEITempMotionConstraintsTileSets."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.mc_all_tiles_exact_sample_value_match = b.u(1)
        self.each_tile_one_tile_set = b.u(1)
        if not self.each_tile_one_tile_set:
            self.limited_tile_set_display = b.u(1)
            self.num_sets = b.ue() + 1
            self.sets = []
            for _ in range(self.num_sets):
                s = {"mcts_id": b.ue()}
                if self.limited_tile_set_display:
                    s["display"] = b.u(1)
                nrects = b.ue() + 1
                s["rects"] = [(b.ue(), b.ue()) for _ in range(nrects)]
                if self.mc_all_tiles_exact_sample_value_match == 0:
                    s["exact_match"] = b.u(1)
                self.sets.append(s)
        else:
            self.max_mcs_tier_level_idc_present = b.u(1)
            if self.max_mcs_tier_level_idc_present:
                self.mcts_max_tier = b.u(1)
                self.mcts_max_level = b.u(8)


class ChromaSamplingFilterHint:
    """Rec. D.2.30 / reference xParseSEIChromaSamplingFilterHint."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.ver_chroma_filter_idc = b.u(8)
        self.hor_chroma_filter_idc = b.u(8)
        self.ver_filtering_process = b.u(1)
        if self.ver_chroma_filter_idc == 1 or self.hor_chroma_filter_idc == 1:
            self.target_format_idc = b.ue()
            if self.ver_chroma_filter_idc == 1:
                n = b.ue() + 1
                self.ver_filters = [[b.se() for _ in range(b.ue() + 1)]
                                    for _ in range(n)]
            if self.hor_chroma_filter_idc == 1:
                n = b.ue() + 1
                self.hor_filters = [[b.se() for _ in range(b.ue() + 1)]
                                    for _ in range(n)]


class KneeFunctionInfo:
    """Rec. D.2.32 / reference xParseSEIKneeFunctionInfo."""

    def __init__(self, payload, sps=None):
        b = _Bits(payload)
        self.knee_id = b.ue()
        self.cancel = b.u(1)
        if not self.cancel:
            self.persistence = b.u(1)
            self.input_d_range = b.u(32)
            self.input_disp_luminance = b.u(32)
            self.output_d_range = b.u(32)
            self.output_disp_luminance = b.u(32)
            self.num_knee_points = b.ue() + 1
            self.points = [(b.u(10), b.u(10))
                           for _ in range(self.num_knee_points)]


_PAYLOAD_CLASSES = {
    SEI_BUFFERING_PERIOD: BufferingPeriod,
    SEI_PIC_TIMING: PictureTiming,
    SEI_DECODING_UNIT_INFO: DecodingUnitInfo,
    SEI_DECODED_PICTURE_HASH: DecodedPictureHash,
    SEI_RECOVERY_POINT: RecoveryPoint,
    SEI_ACTIVE_PARAMETER_SETS: ActiveParameterSets,
    SEI_USER_DATA_UNREGISTERED: UserDataUnregistered,
    SEI_USER_DATA_REGISTERED_ITU_T_T35: UserDataRegisteredT35,
    SEI_PAN_SCAN_RECT: PanScanRect,
    SEI_MASTERING_DISPLAY: MasteringDisplayColourVolume,
    SEI_TIME_CODE: TimeCode,
    SEI_FRAME_PACKING: FramePacking,
    SEI_SEGM_RECT_FRAME_PACKING: SegmentedRectFramePacking,
    SEI_DISPLAY_ORIENTATION: DisplayOrientation,
    SEI_TEMPORAL_LEVEL0_INDEX: TemporalLevel0Index,
    SEI_REGION_REFRESH_INFO: RegionRefreshInfo,
    SEI_NO_DISPLAY: NoDisplay,
    SEI_TONE_MAPPING_INFO: ToneMappingInfo,
    SEI_SOP_DESCRIPTION: SopDescription,
    SEI_SCALABLE_NESTING: ScalableNesting,
    SEI_TEMP_MOTION_CONSTRAINED_TILE_SETS: TempMotionConstrainedTileSets,
    SEI_CHROMA_SAMPLING_FILTER_HINT: ChromaSamplingFilterHint,
    SEI_KNEE_FUNCTION_INFO: KneeFunctionInfo,
}


def decode_sei_payloads(rbsp: bytes, sps=None):
    """Typed SEI decode: [(payload_type, object-or-raw-bytes)].

    sps: the active SPS, needed for HRD-dependent payloads
    (buffering period, picture timing, decoding unit info).
    """
    out = []
    for ptype, payload in parse_sei_rbsp(rbsp):
        cls = _PAYLOAD_CLASSES.get(ptype)
        if cls is not None and (payload or ptype == SEI_NO_DISPLAY):
            try:
                out.append((ptype, cls(payload, sps)))
                continue
            except (IndexError, KeyError):
                pass
        out.append((ptype, payload))
    return out
