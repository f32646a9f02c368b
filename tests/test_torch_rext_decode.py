"""The port's decode of the RExt goldens on the CPU (plain torch).

- decode_batch(device="cpu") matches the HM golden MD5 of every stream
  with a chroma format other than 4:2:0 (4:2:2, 4:4:4 with and without
  cross-component prediction, 4:0:0) or 12-bit samples, one case each;
- decode_batch_device's checksum on a 4:0:0 and a 4:2:2 stream (one
  plane, and a conformance window cropped per axis);
- decode_streams merges independent streams of one geometry into shared
  launches and hands each its own pictures;
- testdata/port_streams.json's Main 4:2:2 10 1080p stream (the repo's own
  encoder) runs only under HEVC_SLOW_TESTS, as the other 1080p tests.

Plane equality with the JAX package is in test_torch_rext_jax.py.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import dag_decode as DD
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
PORT = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))
CPU = torch.device("cpu")

REXT_GOLDENS = ["rext422_intra_416x240", "rext422_lowdelayP_416x240",
                "rext422_noRdoq_160x96", "wpp422_ra_160x96",
                "intra_rext444_416x240", "rext444_randomaccess_416x240",
                "ccp444_lowdelay_160x96", "ht_rext444_intra_160x96",
                "mono_intra_416x240", "mono_lowdelay_160x96",
                "main12_intra_416x240", "intra_rext444_nofilt",
                "intra_rext444_nosao"]


def _data(name, table=GOLD):
    return open(os.path.join(ROOT, "testdata", table[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(np.asarray(p).tobytes() for pic in outs
                                for p in pic)).hexdigest()


@pytest.mark.parametrize("name", REXT_GOLDENS)
def test_rext_golden(name):
    outs = DD.decode_batch(_data(name), device=CPU)
    assert len(outs) == GOLD[name]["frames"]
    ncomp = 1 if GOLD[name]["chroma"] == "400" else 3
    assert all(len(pic) == ncomp for pic in outs)
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]


@pytest.mark.parametrize("name", ["mono_lowdelay_160x96",
                                  "rext422_noRdoq_160x96"])
def test_rext_decode_batch_device_checksum(name):
    """The device checksum covers one plane in 4:0:0 and the per-axis
    crop of 4:2:2 chroma: it equals that of the decoded pictures."""
    data = _data(name)
    outs = DD.decode_batch(data, device=CPU)
    _, _, csum, n = DD.decode_batch_device(data, device=CPU)
    assert n == len(outs)
    assert csum == DD.cropped_checksum(outs)


def test_decode_streams_multi():
    """Two streams of one geometry and bit depth, one of them twice,
    through one merged reconstruction: each gets its golden pictures."""
    names = ["tids4_ra_160x96", "cip_ra_160x96", "tids4_ra_160x96"]
    outs = DD.decode_streams([_data(n) for n in names], device=CPU,
                             threads=2)
    assert len(outs) == len(names)
    for n, o in zip(names, outs):
        assert len(o) == GOLD[n]["frames"]
        assert _md5(o) == GOLD[n]["decoded_yuv_md5"]




def test_decode_streams_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DD.decode_streams([_data("mono_lowdelay_160x96")])


def test_rext422_stream_1080p():
    """Hash SEI OK on every picture, and the native, JAX and port decodes
    give the MD5 of testdata/port_streams.json."""
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 1080p Main 4:2:2 10 "
                    "stream")
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "rext422_main10_1080p"
    data = _data(name, PORT)
    want = PORT[name]["decoded_yuv_md5"]
    frames = PORT[name]["frames"]
    dec = JaxDecoder(parse="native", recon="native", check_sei_hash=True)
    assert _md5(dec.decode_annexb(data)) == want
    assert [dp.hash_status for dp in dec.output_records] == ["OK"] * frames
    assert _md5(jax_decode(data)) == want
    dec = Decoder(parse="native", recon="collect", check_sei_hash=True)
    dec.decode_annexb(data)
    pending = DD._recon_levels(dec.collected, [CPU])
    outs = DD._materialize(dec, pending, True)
    assert [dp.hash_status for dp, _, _ in pending] == ["OK"] * frames
    assert _md5(outs) == want
