"""The port's decode_batch end to end on the CPU (plain torch versions).

Each all-intra stream must match its HM golden MD5 and equal the JAX
decode_batch plane by plane (exact).  The 1080p stream runs only under
HEVC_SLOW_TESTS, as in test_dag_decode.py.  Streams outside the ported
slice raise NotImplementedError; the entry point runs on the card unless
the CPU is asked for.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import dag_decode as DD
from libhm_tpu_torch.parallel.dag_decode import decode_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                for p in pic)).hexdigest()


@pytest.mark.parametrize("name", ["intra_main10_416x240", "intra_416x240"])
def test_decode_matches_golden_and_jax(name):
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    data = _data(name)
    outs = decode_batch(data, device=CPU)
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]
    want = jax_decode(data)
    assert len(outs) == len(want)
    for pic_t, pic_j in zip(outs, want):
        assert len(pic_t) == len(pic_j) == 3
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_decode_1080p_golden():
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 1080p Main10 stream")
    name = "intra_main10_1080p"
    assert _md5(decode_batch(_data(name), device=CPU)) == \
        GOLD[name]["decoded_yuv_md5"]


def test_sei_hash_check():
    """The control plane's decoded-picture-hash SEI check passes on the
    port's pixels."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect", check_sei_hash=True)
    dec.decode_annexb(_data("intra_main10_416x240"))
    pending = DD._recon_levels(dec.collected, CPU)
    DD._materialize(dec, pending, True)
    statuses = [dp.hash_status for dp, _, _ in pending]
    assert statuses and all(s == "OK" for s in statuses), statuses


def test_inter_stream_raises():
    """An inter stream outside the slice (4:2:2) is refused by name."""
    with pytest.raises(NotImplementedError, match="chroma format 2"):
        decode_batch(_data("rext422_lowdelayP_416x240"), device=CPU)


def test_tiles_stream_raises():
    with pytest.raises(NotImplementedError, match="tiles"):
        decode_batch(_data("tiles_832x480"), device=CPU)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_batch(_data("intra_416x240"), device="cuda")


def test_default_device_is_cuda():
    """Both entry points run on the card unless the CPU is asked for:
    without a card they refuse rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_batch(_data("intra_416x240"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DD.decode_batch_device(_data("intra_416x240"))
