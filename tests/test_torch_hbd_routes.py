"""Inter pictures at 13-16 bits through every decode route of the port on
the CPU, and the 8-12-bit outputs that must not move.

- The random-access streams of testdata/port_streams.json (the port's
  encoder made them from the cfgs beside them): mono16_ra_160x96
  (Monochrome 16), main14_ra_160x96 (14-bit 4:2:0; explicit weighted
  prediction in its first coded video sequence, none in its second) and
  mono16_ra_1080p.  Each holds default-weighted bi PUs and PUs whose
  every MV is whole-sample (their 14-bit intermediates are the sample <<
  Max(2, 14 - bd)), counted from the parse; main14_ra_160x96 also uni and
  bi PUs with explicit weights.
- The two 160x96 streams through Decoder(parse="python", recon="numpy"),
  Decoder(parse="native", recon="numpy"), Decoder(parse="native",
  recon="native") (the native C++ recon, whose samples are 16-bit
  unsigned), decode_batch(device="cpu"), the per-picture
  Decoder(recon="torch", device="cpu") and decode_batch_device's
  checksum, and the 1080p streams at 16 bits (mono16_ra_1080p,
  rext444_16b_intra_1080p) through the native recon: each at its MD5 with
  every hash SEI OK.  libhmdec.so is in tests/test_torch_libhmdec.py.
- The port's encoder codes random-access B pictures at 13 and 16 bits
  (4:2:0, bi PUs among them); decode_batch, whose K5 follows H.265,
  checks every hash SEI of the stream.
- Regression guard: every golden of testdata/golden.json (8-12 bits)
  through Decoder(parse="native", recon="native") at its MD5, alone and
  in turns with the JAX package's native recon in one process (the two
  libraries share no static object: the port's builds with
  -fno-gnu-unique, and its ReconCtx has another layout).
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.parallel import dag_decode as DD

import enc_cases as E
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")
PROXIES = ["mono16_ra_160x96", "main14_ra_160x96"]
STREAMS = PROXIES + ["mono16_ra_1080p"]


def _data(entry):
    return open(os.path.join(ROOT, "testdata", entry["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(np.asarray(p).tobytes() for pic in outs
                                for p in pic)).hexdigest()


def pu_kinds(pics):
    """Counts of the inter PUs of parsed pictures: default-weighted bi,
    whole-sample (every MV it uses whole in both components), and with
    explicit weights, uni and bi."""
    n = dict.fromkeys(("bi", "whole", "wp_uni", "wp_bi"), 0)
    for pic in pics:
        for pu in pic.inter_list:
            wp = getattr(pu, "wp", None) is not None
            bi = pu.inter_dir == 3
            n["bi"] += bi and not wp
            n["wp_uni"] += wp and not bi
            n["wp_bi"] += wp and bi
            n["whole"] += all(pu.mv[l][0] & 3 == 0 and pu.mv[l][1] & 3 == 0
                              for l in range(2) if pu.inter_dir >> l & 1)
    return n


@pytest.mark.parametrize("name", STREAMS)
def test_pu_kinds(name):
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(_data(PORT[name]))
    n = pu_kinds([it["pic"] for it in dec.collected])
    assert n["bi"] > 0 and n["whole"] > 0, n
    assert PORT[name]["bitdepth"] > 12
    if name == "main14_ra_160x96":
        assert n["wp_uni"] > 0 and n["wp_bi"] > 0, n


ROUTES = [(name, route) for name in PROXIES
          for route in ("python/numpy", "native/numpy", "native/native")]
# the native recon decodes the 1080p streams in about a second
ROUTES += [(name, "native/native") for name in ("mono16_ra_1080p",
                                                "rext444_16b_intra_1080p")]


@pytest.mark.parametrize("name,route", ROUTES)
def test_host_routes(name, route):
    parse, recon = route.split("/")
    dec = Decoder(parse=parse, recon=recon, check_sei_hash=True)
    outs = dec.decode_annexb(_data(PORT[name]))
    assert len(outs) == PORT[name]["frames"]
    assert _md5(outs) == PORT[name]["decoded_yuv_md5"]
    assert [dp.hash_status for dp in dec.output_records] == \
        ["OK"] * PORT[name]["frames"]
    if PORT[name]["bitdepth"] == 16:
        assert max(int(np.asarray(p).max()) for pic in outs
                   for p in pic) >= 1 << 15


@pytest.mark.parametrize("name", PROXIES)
def test_port_entry_points(name):
    data, md5, n = (_data(PORT[name]), PORT[name]["decoded_yuv_md5"],
                    PORT[name]["frames"])
    outs, statuses = E.decode_statuses(data, CPU)
    assert _md5(outs) == md5 and statuses == ["OK"] * n
    dec = Decoder(parse="native", recon="torch", device=CPU,
                  check_sei_hash=True)
    assert _md5(dec.decode_annexb(data)) == md5
    assert [dp.hash_status for dp in dec.output_records] == ["OK"] * n
    _, _, csum, got = DD.decode_batch_device(data, device=CPU)
    assert got == n and csum == DD.cropped_checksum(outs)


@pytest.mark.parametrize("bd", [13, 16])
def test_encoder_codes_b_pictures(bd):
    """ROADMAP C9: the port's encoder's default bi average shifts by
    Max(3, 15 - bd), as the decoders do."""
    from libhm_tpu_torch.encoder import encoder as ENC
    cfg = ENC.EncoderConfig(64, 48, qp=27, gop="randomaccess", bit_depth=bd)
    enc = ENC.IntraEncoder(cfg, device=CPU)
    data = enc.encode_stream(E.frames(64, 48, 3, bd=bd, seed=bd))
    outs, statuses = E.decode_statuses(data, CPU)
    assert len(outs) == 3 and statuses == ["OK"] * 3
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    assert pu_kinds([it["pic"] for it in dec.collected])["bi"] > 0


@pytest.mark.parametrize("name", sorted(GOLD))
def test_native_recon_goldens(name):
    data = _data(GOLD[name])
    outs = Decoder(parse="native", recon="native").decode_annexb(data)
    assert GOLD[name].get("bitdepth", 8) <= 12
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]


def test_native_recon_beside_the_jax_build():
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    for name in sorted(GOLD):
        data = _data(GOLD[name])
        for make in (JaxDecoder, Decoder):
            outs = make(parse="native", recon="native").decode_annexb(data)
            assert _md5(outs) == GOLD[name]["decoded_yuv_md5"], \
                (name, make.__module__)
