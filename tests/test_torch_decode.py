"""The port's decode_batch end to end on the CPU (plain torch versions).

Each all-intra stream must match its HM golden MD5 and equal the JAX
decode_batch plane by plane (exact).  The 1080p stream runs only under
HEVC_SLOW_TESTS, as in test_dag_decode.py.  A stream with extended
precision forced, and a CCP stream read at unequal luma and chroma bit
depths, decode as the numpy decoder does under the same SPS; the entry
point runs on the card unless the CPU is asked for.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import dag_decode as DD
from libhm_tpu_torch.parallel.dag_decode import decode_batch
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
    pending = DD._recon_levels(dec.collected, [CPU])
    DD._materialize(dec, pending, True)
    statuses = [dp.hash_status for dp, _, _ in pending]
    assert statuses and all(s == "OK" for s in statuses), statuses


def _forced_sps(monkeypatch, **fields):
    """Every SPS the port's control plane parses reads `fields`.  The
    native slice parse reads its own SPS, so coefficients parse as coded,
    and the reconstructions of the port and of the numpy decoder follow
    the fields."""
    from libhm_tpu_torch.hostdec import decoder as D
    real = D.parse_sps

    def forced(rbsp):
        sps = real(rbsp)
        for k, v in fields.items():
            setattr(sps, k, v)
        return sps
    monkeypatch.setattr(D, "parse_sps", forced)


def _forced_extprec(monkeypatch):
    """Every SPS reads extended_precision_processing_flag = 1."""
    _forced_sps(monkeypatch, extended_precision=1)


def test_inter_stream_raises(monkeypatch):
    """Extended precision was refused here by name; it is ported now.  The
    10-bit 4:2:2 inter stream with the flag forced (max_dyn_range 16)
    decodes through decode_batch to what the numpy decoder gives under the
    same flag, which is not the golden."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "rext422_noRdoq_160x96"
    _forced_extprec(monkeypatch)
    got = _md5(decode_batch(_data(name), device=CPU))
    want = _md5(Decoder(parse="native", recon="numpy")
                .decode_annexb(_data(name)))
    assert got == want != GOLD[name]["decoded_yuv_md5"]


def test_tiles_stream_raises(monkeypatch):
    """Tiles, cross-component prediction, bit depths up to 16 and extended
    precision are ported, and since CCP scales the luma residual by the
    two bit depths (H.265 8.6.6, ROADMAP C4) nothing is refused: the CCP
    stream (low-delay B) with every SPS read as 8-bit luma, 12-bit chroma
    and extended precision decodes through decode_batch to what the numpy
    decoder gives under the same SPS, which is not the golden.  (Above 12
    bits the numpy decoder's bi-prediction average has a negative shift,
    ROADMAP C11.)"""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "ccp444_lowdelay_160x96"
    _forced_sps(monkeypatch, bit_depth_luma=8, bit_depth_chroma=12,
                extended_precision=1)
    got = _md5(decode_batch(_data(name), device=CPU))
    want = _md5(Decoder(parse="native", recon="numpy")
                .decode_annexb(_data(name)))
    assert got == want != GOLD[name]["decoded_yuv_md5"]


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
