"""The port's decode of the coding-tool goldens on the CPU (plain torch).

- decode_batch(device="cpu") matches the HM golden MD5 of every 4:2:0
  stream with several slices or tiles per picture, WPP or dependent
  slices, PCM enabled (with a reduced PCM bit depth), lossless CUs
  (transquant bypass with rotation and implicit or explicit RDPCM),
  transform skip above 4x4, chroma QP adjustment, or scaling lists (SPS
  defaults and a PPS list);
- testdata/port_streams.json holds streams made by the repo's own encoder,
  whose oracle is their hash SEI and the agreement of the decoders:
  pcm_port_416x240 has PCM CUs (the PCM goldens enable PCM but code
  none), and PCM blocks are left to the PCM scatter (K9): no intra block
  covers one; the 1080p tool stream runs only under HEVC_SLOW_TESTS, as
  the other 1080p tests.

Plane equality with the JAX decode_batch is in test_torch_tools_jax.py.
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

TOOL_GOLDENS = ["slices_416x240", "depslices_416x240", "wpp_416x240",
                "tiles_832x480", "tiles_nolfcross_512x128",
                "pcm_intra_416x240", "pcm_reduceddepth_160x96",
                "lossless_intra_416x240", "scaling_intra_416x240",
                "customsl_lowdelay_160x96", "wppdep_lowdelay_160x96",
                "mixed_lossless_rdpcm_160x96", "bigts_lowdelay_160x96",
                "chromaqpadj_parmrg_160x96"]


def _data(name, table=GOLD):
    return open(os.path.join(ROOT, "testdata", table[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(np.asarray(p).tobytes() for pic in outs
                                for p in pic)).hexdigest()


@pytest.mark.parametrize("name", TOOL_GOLDENS)
def test_tool_golden(name):
    outs = DD.decode_batch(_data(name), device=CPU)
    assert len(outs) == GOLD[name]["frames"]
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]


def test_pcm_stream_hash_and_md5():
    """The PCM stream: every picture's hash SEI checks OK on the port's
    pixels, and the MD5 is that of port_streams.json."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "pcm_port_416x240"
    dec = Decoder(parse="native", recon="collect", check_sei_hash=True)
    dec.decode_annexb(_data(name, PORT))
    pending = DD._recon_levels(dec.collected, [CPU])
    outs = DD._materialize(dec, pending, True)
    assert [dp.hash_status for dp, _, _ in pending] == ["OK"]
    assert _md5(outs) == PORT[name]["decoded_yuv_md5"]


def test_pcm_blocks_are_not_intra_blocks():
    """The intra wavefront (K2) never predicts a PCM block: the parser
    keeps PCM CUs out of intra_list, as the JAX path assumes."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(_data("pcm_port_416x240", PORT))
    n_pcm = 0
    for it in dec.collected:
        pcm = {(c, x, y) for (c, x, y, *_rest) in it["pic"].pcm_list}
        n_pcm += len(pcm)
        intra = {(b.comp, b.x, b.y) for b in it["pic"].intra_list}
        assert not pcm & intra
    assert n_pcm > 0


def test_tool_decode_batch_device_checksum():
    """decode_batch_device on a tiled stream and on a lossless one: the
    checksum equals that of the golden pictures."""
    for name in ("tiles_nolfcross_512x128", "lossless_intra_416x240"):
        outs = DD.decode_batch(_data(name), device=CPU)
        assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]
        csum = DD.decode_batch_device(_data(name), device=CPU)[2]
        assert csum == DD.cropped_checksum(outs)


def test_tool_stream_1080p():
    """Hash SEI OK on every picture, and the native, JAX and port decodes
    give the MD5 of testdata/port_streams.json."""
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 1080p Main10 tool stream")
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "tools_main10_1080p"
    data = _data(name, PORT)
    want = PORT[name]["decoded_yuv_md5"]
    dec = JaxDecoder(parse="native", recon="native", check_sei_hash=True)
    assert _md5(dec.decode_annexb(data)) == want
    assert [dp.hash_status for dp in dec.output_records] == ["OK"] * 3
    assert _md5(jax_decode(data)) == want
    dec = Decoder(parse="native", recon="collect", check_sei_hash=True)
    dec.decode_annexb(data)
    pending = DD._recon_levels(dec.collected, [CPU])
    outs = DD._materialize(dec, pending, True)
    assert [dp.hash_status for dp, _, _ in pending] == ["OK"] * 3
    assert _md5(outs) == want
