# Copied from libhm_tpu/encoder/sei_writer.py
"""SEI message writers (reference SEIwrite.cpp:56-120 xWriteSEIpayloadData).

Each writer returns the raw payload bytes for one SEI message; sei_rbsp()
frames one or more (type, payload) pairs into an SEI NAL's RBSP with the
0xFF-extended type/size codes and rbsp trailing bits.  Payload syntax
follows Rec. H.265 Annex D; the decode-side mirrors live in
hostdec/sei.py (round-tripped in tests/test_sei.py).
"""
from .cabac_enc import BitWriter
from ..hostdec import sei as S


def _payload_align(w: BitWriter):
    """payload_bit_equal_to_one + zero pad (Rec. D.2.1)."""
    w.put(1)
    while w.nbits:
        w.put(0)


def _bits_payload(fill) -> bytes:
    w = BitWriter()
    fill(w)
    if w.nbits:
        _payload_align(w)
    return bytes(w.buf)


# ---------------------------------------------------------------------------
def sei_rbsp(messages) -> bytes:
    """messages: [(payload_type, payload_bytes)] -> SEI RBSP."""
    out = bytearray()
    for ptype, payload in messages:
        t = ptype
        while t >= 255:
            out.append(255)
            t -= 255
        out.append(t)
        n = len(payload)
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)
        out += payload
    out.append(0x80)  # rbsp trailing
    return bytes(out)


# ---------------------------------------------------------------------------
def active_parameter_sets(vps_id=0, self_contained=1, no_update=1,
                          sps_ids=(0,)) -> bytes:
    def fill(w):
        w.put_bits(vps_id, 4)
        w.put(self_contained)
        w.put(no_update)
        w.ue(len(sps_ids) - 1)
        for s in sps_ids:
            w.ue(s)
    return _bits_payload(fill)


def recovery_point(recovery_poc_cnt=0, exact_match=1, broken_link=0) -> bytes:
    def fill(w):
        w.se(recovery_poc_cnt)
        w.put(exact_match)
        w.put(broken_link)
    return _bits_payload(fill)


def user_data_unregistered(uuid: bytes, data: bytes) -> bytes:
    assert len(uuid) == 16
    return uuid + data


def user_data_registered_t35(country_code: int, data: bytes,
                             country_code_extension=None) -> bytes:
    """Rec. D.2.6 (reference SEIwrite.cpp xWriteSEIuserDataRegistered)."""
    head = bytes([country_code])
    if country_code == 0xFF:
        head += bytes([country_code_extension or 0])
    return head + data


def pan_scan_rect(rect_id=0, cancel=0, rects=(), persistence=1) -> bytes:
    """Rec. D.2.4; rects = [(left, right, top, bottom) se(v) offsets]."""
    def fill(w):
        w.ue(rect_id)
        w.put(cancel)
        if not cancel:
            w.ue(len(rects) - 1)
            for (l, r, t, b) in rects:
                w.se(l), w.se(r), w.se(t), w.se(b)
            w.put(persistence)
    return _bits_payload(fill)


def mastering_display(primaries, white_point, max_lum, min_lum) -> bytes:
    def fill(w):
        for gx, gy in primaries:
            w.put_bits(gx, 16)
            w.put_bits(gy, 16)
        w.put_bits(white_point[0], 16)
        w.put_bits(white_point[1], 16)
        w.put_bits(max_lum, 32)
        w.put_bits(min_lum, 32)
    return _bits_payload(fill)


def time_code(clock_ts) -> bytes:
    """clock_ts: list of dicts ({} = clock_timestamp_flag 0; keys
    units_field_based, counting_type, discontinuity, cnt_dropped, n_frames
    and optional seconds/minutes/hours)."""
    def fill(w):
        w.put_bits(len(clock_ts), 2)
        for ts in clock_ts:
            w.put(1 if ts else 0)
            if ts:
                w.put(ts.get("units_field_based", 0))
                w.put_bits(ts.get("counting_type", 0), 5)
                full = int("seconds" in ts)
                w.put(full)
                w.put(ts.get("discontinuity", 0))
                w.put(ts.get("cnt_dropped", 0))
                w.put_bits(ts.get("n_frames", 0), 9)
                if full:
                    w.put_bits(ts["seconds"], 6)
                    w.put_bits(ts["minutes"], 6)
                    w.put_bits(ts["hours"], 5)
    return _bits_payload(fill)


def display_orientation(hor_flip=0, ver_flip=0, rotation=0,
                        persistence=1, cancel=0) -> bytes:
    def fill(w):
        w.put(cancel)
        if not cancel:
            w.put(hor_flip)
            w.put(ver_flip)
            w.put_bits(rotation, 16)
            w.put(persistence)
    return _bits_payload(fill)


def frame_packing(arrangement_type=3, quincunx=0, content_interp=1,
                  arrangement_id=0, persistence=1) -> bytes:
    def fill(w):
        w.ue(arrangement_id)
        w.put(0)  # cancel
        w.put_bits(arrangement_type, 7)
        w.put(quincunx)
        w.put_bits(content_interp, 6)
        w.put(0)  # spatial_flipping
        w.put(0)  # frame0_flipped
        w.put(0)  # field_views
        w.put(0)  # current_frame_is_frame0
        w.put(0)  # frame0_self_contained
        w.put(0)  # frame1_self_contained
        if not quincunx and arrangement_type != 5:
            for _ in range(4):
                w.put_bits(0, 4)
        w.put_bits(0, 8)  # reserved byte
        w.put(persistence)
        w.put(0)  # upsampled_aspect_ratio
    return _bits_payload(fill)


def temporal_level0_index(tl0_idx, rap_idx) -> bytes:
    def fill(w):
        w.put_bits(tl0_idx, 8)
        w.put_bits(rap_idx, 8)
    return _bits_payload(fill)


def region_refresh_info(refreshed=1) -> bytes:
    def fill(w):
        w.put(refreshed)
    return _bits_payload(fill)


def no_display() -> bytes:
    return b""


def segm_rect_frame_packing(content_interp=1, persistence=1,
                            cancel=0) -> bytes:
    def fill(w):
        w.put(cancel)
        if not cancel:
            w.put_bits(content_interp, 2)
            w.put(persistence)
    return _bits_payload(fill)


def sop_description(entries, sps_id=0) -> bytes:
    """entries: [{vcl_nut, temporal_id, st_rps_idx?, poc_delta?}]."""
    def fill(w):
        w.ue(sps_id)
        w.ue(len(entries) - 1)
        for i, e in enumerate(entries):
            w.put_bits(e["vcl_nut"], 6)
            w.put_bits(e["temporal_id"], 3)
            if e["vcl_nut"] not in (19, 20):
                w.ue(e.get("st_rps_idx", 0))
            if i > 0:
                w.se(e.get("poc_delta", 1))
    return _bits_payload(fill)


def buffering_period(hrd, cpb_delay=1000, cpb_offset=0,
                     concatenation=0, sps_id=0) -> bytes:
    """hrd: hostdec.params.HRD (the one written into the SPS VUI)."""
    def fill(w):
        w.ue(sps_id)
        if not hrd.sub_pic:
            w.put(0)  # irap_cpb_params_present
        w.put(concatenation)
        w.put_bits(0, hrd.au_cpb_removal_delay_length)  # delta_minus1
        L = hrd.initial_cpb_removal_delay_length
        for cpbs in (hrd.sub_layers[0][4], hrd.sub_layers[0][5]):
            for _ in cpbs:
                w.put_bits(cpb_delay, L)
                w.put_bits(cpb_offset, L)
    return _bits_payload(fill)


def pic_timing(vui, pic_struct=0, source_scan=0, cpb_removal_delay=1,
               dpb_output_delay=0) -> bytes:
    """vui: hostdec.params.VUI with hrd set."""
    def fill(w):
        if vui.frame_field_info_present:
            w.put_bits(pic_struct, 4)
            w.put_bits(source_scan, 2)
            w.put(0)  # duplicate
        hrd = vui.hrd
        if hrd is not None and (hrd.nal_hrd or hrd.vcl_hrd):
            w.put_bits(cpb_removal_delay - 1, hrd.au_cpb_removal_delay_length)
            w.put_bits(dpb_output_delay, hrd.dpb_output_delay_length)
    return _bits_payload(fill)


def scalable_nesting(nested_messages, all_layers=True,
                     max_temporal_id_plus1=7) -> bytes:
    """nested_messages: [(type, payload)] wrapped for all layers."""
    def fill(w):
        w.put(0)  # bitstream_subset
        w.put(0)  # nesting_op_flag
        w.put(1 if all_layers else 0)
        if not all_layers:
            w.put_bits(max_temporal_id_plus1, 3)
            w.ue(0)
            w.put_bits(0, 6)
        _payload_align(w)
    head = _bits_payload(fill)
    # nested sei messages follow (without the outer rbsp trailing byte)
    body = sei_rbsp(nested_messages)[:-1]
    return head + body


def decoded_picture_hash(digests, method=S.HASH_MD5) -> bytes:
    out = bytearray([method])
    for d in digests:
        out += d
    return bytes(out)
