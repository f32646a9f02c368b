# Copied from libhm_tpu/hostdec/nal.py
"""Annex-B byte stream splitting and NAL unit headers.

Rebuild of reference source/Lib/TLibDecoder/AnnexBread.cpp:62-199 (start-code
scanning) and NALread.cpp:105 (nal_unit_header) as plain Python generators.
"""
from dataclasses import dataclass
from .bitstream import strip_emulation_prevention_pos

# NAL unit types (Rec. H.265 Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def is_vcl(nal_type: int) -> bool:
    return nal_type < 32


def is_irap(nal_type: int) -> bool:
    return NAL_BLA_W_LP <= nal_type <= 23


def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_bla(nal_type: int) -> bool:
    return nal_type in (NAL_BLA_W_LP, NAL_BLA_W_RADL, NAL_BLA_N_LP)


def is_rasl(nal_type: int) -> bool:
    return nal_type in (NAL_RASL_N, NAL_RASL_R)


def is_radl(nal_type: int) -> bool:
    return nal_type in (NAL_RADL_N, NAL_RADL_R)


def is_sublayer_non_ref(nal_type: int) -> bool:
    """nuh-type is *_N (sub-layer non-reference)."""
    return nal_type in (NAL_TRAIL_N, NAL_TSA_N, NAL_STSA_N, NAL_RADL_N,
                        NAL_RASL_N, 10, 12, 14)


@dataclass
class NalUnit:
    nal_type: int
    layer_id: int
    temporal_id: int       # nuh_temporal_id_plus1 - 1
    rbsp: bytes            # emulation-prevention stripped payload (after 2-byte header)
    ebsp: bytes = b""      # raw NAL bytes incl. 2-byte header (for native feed)
    epb_positions: tuple = ()  # rbsp indices following removed 00 00 03 bytes


def parse_nal(ebsp: bytes) -> NalUnit:
    """Parse a NAL unit from its EBSP bytes (no start code)."""
    if len(ebsp) < 2:
        raise ValueError("NAL too short")
    b0, b1 = ebsp[0], ebsp[1]
    nal_type = (b0 >> 1) & 0x3F
    layer_id = ((b0 & 1) << 5) | (b1 >> 3)
    temporal_id = (b1 & 7) - 1
    rbsp, epb = strip_emulation_prevention_pos(ebsp[2:])
    return NalUnit(nal_type, layer_id, temporal_id, rbsp, bytes(ebsp),
                   tuple(epb))


def split_annexb(data: bytes):
    """Yield EBSP NAL payloads from an Annex-B byte stream."""
    n = len(data)
    i = 0
    starts = []
    # find all start codes (00 00 01)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trailing zeros before the next start code belong to no NAL
        while e > s and data[e - 1] == 0:
            e -= 1
        if e > s:
            yield data[s:e]
