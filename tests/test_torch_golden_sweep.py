"""The golden sweep of the port: goldens that no other port test decodes,
through decode_batch(device="cpu") (the plain versions of every kernel)
and through the per-picture path, Decoder(parse="native", recon="torch",
device="cpu"), against their HM MD5s in testdata/golden.json.

The 4K golden runs only under HEVC_SLOW_TESTS, as in test_dag_decode.py.
"""
import hashlib
import json
import os

import pytest
import torch

from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.parallel.dag_decode import decode_batch
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
SWEEP = ("intra_qp22_416x240", "intra_nofilt_416x240", "intra_nosao_416x240",
         "dqp_intra_416x240", "chromaqp_ra_160x96",
         "cra_randomaccess_416x240", "randomaccess_416x240")


def _md5_of(name, per_picture=False):
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    if per_picture:
        outs = Decoder(parse="native", recon="torch",
                       device="cpu").decode_annexb(data)
    else:
        outs = decode_batch(data, device=torch.device("cpu"))
    assert len(outs) == GOLD[name]["frames"]
    return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                for p in pic)).hexdigest()


@pytest.mark.parametrize("name", SWEEP)
def test_golden(name):
    assert _md5_of(name) == GOLD[name]["decoded_yuv_md5"]


@pytest.mark.parametrize("name", SWEEP)
def test_golden_per_picture(name):
    assert _md5_of(name, per_picture=True) == GOLD[name]["decoded_yuv_md5"]


def test_golden_4k():
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 4K Main10 golden")
    name = "lowdelayP_main10_4k"
    assert _md5_of(name) == GOLD[name]["decoded_yuv_md5"]
