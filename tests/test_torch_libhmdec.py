"""The port's libHMDec C ABI (libhm_tpu_torch/hostdec/native/libhmdec.so).

The library is built from the port's own copy of the native sources and
driven through the reference protocol (tests/libhmdec_abi.py): push each
NAL unit, push it again when bNewPicture is set, drain
libHMDec_get_picture when bCheckPicture is set.  The pictures' planes,
joined in output order, must give each golden's MD5 in
testdata/golden.json, and the library's own check of the MD5 SEIs must
pass.
"""
import json
import os

import pytest

import libhmdec_abi as ABI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))


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


def test_version_string(lib):
    assert lib.libHMDec_get_version() == b"16.0"
