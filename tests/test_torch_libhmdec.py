"""The port's libHMDec C ABI (libhm_tpu_torch/hostdec/native/libhmdec.so).

The library is built from the port's own copy of the native sources and
driven through the reference protocol (tests/libhmdec_abi.py): push each
NAL unit, push it again when bNewPicture is set, drain
libHMDec_get_picture when bCheckPicture is set.  The pictures' planes,
joined in output order, must give each golden's MD5 in
testdata/golden.json, and the library's own check of the MD5 SEIs must
pass.  Above 12 bits (the streams of testdata/port_streams.json, made
by the port's encoder) the planes come as short* and are read back as
uint16: samples of 2^15 and up at 16 bits.
"""
import json
import os

import pytest

import libhmdec_abi as ABI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
PORT = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))


@pytest.fixture(scope="module")
def lib():
    return ABI.load(ABI.build())


@pytest.mark.parametrize("name", ["intra_416x240",
                                  "randomaccess_main10_416x240",
                                  "tids4_ra_160x96"])
def test_push_protocol_md5(lib, name):
    """An intra stream, the 10-bit RA twin of the bench stream and a
    stream of four temporal layers, each to its golden MD5."""
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    pics, hash_ok = ABI.decode(lib, data)
    pocs = [poc for poc, _ in pics]
    assert pocs == sorted(pocs), "output must be in increasing POC order"
    assert len(pics) == GOLD[name]["frames"]
    assert ABI.md5_of(pics, GOLD[name].get("bitdepth", 8)) == \
        GOLD[name]["decoded_yuv_md5"]
    assert hash_ok == 1, "the library's MD5 SEI check failed"


@pytest.mark.parametrize("name", ["rext444_16b_intra_160x96",
                                  "main14_intra_160x96", "mono16_ra_160x96",
                                  "main14_ra_160x96",
                                  "rext444_16b_intra_1080p",
                                  "mono16_ra_1080p"])
def test_push_protocol_above_12_bits(lib, name):
    """16-bit 4:4:4 intra, 14-bit intra, Monochrome 16 random access and
    14-bit random access with weighted prediction (and the 16-bit 1080p
    streams, intra and random access), each to its MD5 with
    the library's MD5 SEI check passing, in the output order of the
    Python decoder.  Each of the intra streams' pictures is an IDR picture
    of POC 0, and main14_ra_160x96 holds two coded video sequences, of 3
    and of 5 pictures: every picture of a sequence comes out before any
    of the next."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    e = PORT[name]
    data = open(os.path.join(ROOT, "testdata", e["bitstream"]), "rb").read()
    pics, hash_ok = ABI.decode(lib, data)
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    pocs = [dp.poc for dp in dec.output_records]
    assert [poc for poc, _ in pics] == pocs
    if name == "main14_ra_160x96":
        assert pocs == [0, 1, 2] + list(range(5))
    assert ABI.md5_of(pics, e["bitdepth"]) == e["decoded_yuv_md5"]
    assert hash_ok == 1, "the library's MD5 SEI check failed"
    if e["bitdepth"] == 16:
        assert max(int(p.max()) for _, pl in pics for p in pl) >= 1 << 15


def test_version_string(lib):
    assert lib.libHMDec_get_version() == b"16.0"
