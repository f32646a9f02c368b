"""The port's inter decode end to end on the CPU (plain torch versions).

- decode_batch(device="cpu") matches the HM golden MD5 of random-access,
  low-delay B, weighted-prediction P and constrained-intra RA streams, and
  equals the JAX decode_batch plane by plane on a small RA stream;
- decode_batch_device(device="cpu") gives the checksum that the JAX
  package's cropped_checksum gives of the golden-matching pictures, and
  downloads nothing but those 4 bytes.

The 1080p RA stream runs only under HEVC_SLOW_TESTS.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import dag_decode as DD
from libhm_tpu_torch.utils import xfer
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                for p in pic)).hexdigest()


_OUTS = {}


def _decode(name):
    """decode_batch on the CPU, once per stream and worker."""
    if name not in _OUTS:
        _OUTS[name] = DD.decode_batch(_data(name), device=CPU)
    return _OUTS[name]


@pytest.mark.parametrize("name", ["randomaccess_main10_416x240",
                                  "wp_lowdelayP_416x240",
                                  "lowdelayB_416x240", "cip_ra_160x96"])
def test_inter_decode_matches_golden(name):
    assert _md5(_decode(name)) == GOLD[name]["decoded_yuv_md5"]


def test_inter_decode_equals_jax():
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    name = "tids4_ra_160x96"
    outs = _decode(name)
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]
    want = jax_decode(_data(name))
    assert len(outs) == len(want)
    for pic_t, pic_j in zip(outs, want):
        assert len(pic_t) == len(pic_j) == 3
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_decode_batch_device_checksum():
    from libhm_tpu.parallel.dag_decode import cropped_checksum
    name = "randomaccess_main10_416x240"
    outs = _decode(name)
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]
    xfer.reset()
    parse_s, compute_s, csum, npics = DD.decode_batch_device(_data(name),
                                                             device=CPU)
    assert xfer.D2H == 4
    assert npics == GOLD[name]["frames"] == len(outs)
    assert parse_s > 0 and compute_s > 0
    assert csum == cropped_checksum(outs) == DD.cropped_checksum(outs)


def test_reference_planes_stay_on_device():
    """Every picture keeps its filtered planes as device views, and a later
    level reads them instead of uploading host planes."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(_data("cip_ra_160x96"))
    xfer.reset()
    pending = DD._recon_levels(dec.collected, [CPU], download=False)
    assert "ref" not in xfer.BY_TAG and xfer.BY_TAG["mc"] > 0
    for dp, _, small in pending:
        assert small == []
        assert sorted(dp._device_planes) == [(0, 96, 160), (1, 48, 80),
                                             (2, 48, 80)]


def test_inter_decode_1080p_golden():
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 1080p Main10 RA stream")
    name = "randomaccess_main10_1080p"
    assert _md5(DD.decode_batch(_data(name), device=CPU)) == \
        GOLD[name]["decoded_yuv_md5"]
