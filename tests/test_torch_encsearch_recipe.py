"""mono16_ra_160x96's recipe (testdata/mono16_ra_160x96.cfg: Monochrome
16, random access, search range 64) through the port's encoder on the CPU
with its native motion search, whose int32 form runs above 12 bits
(ROADMAP C14):

- the stream's bytes have the MD5 that the encoder writes with its two
  motion searches on their Python path (tests/enc_cases.py `RA16_MD5`);
- the stream decodes with every hash SEI OK, to one MD5, through every
  route of tests/test_torch_hbd_routes.py: Decoder(parse="python",
  recon="numpy"), Decoder(parse="native", recon="numpy"),
  Decoder(parse="native", recon="native"), decode_batch(device="cpu"),
  the per-picture Decoder(recon="torch", device="cpu") and
  decode_batch_device's checksum.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.encoder import encoder as ENC
from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.hostdec.native_bridge import try_load
from libhm_tpu_torch.parallel import dag_decode as DD

import enc_cases as E
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _md5(outs):
    return hashlib.md5(b"".join(np.asarray(p).tobytes() for pic in outs
                                for p in pic)).hexdigest()


@pytest.fixture(scope="module")
def encoded():
    """(stream, pictures, MD5 of the encoder's reconstructions in output
    order) of the recipe, encoded with the native search."""
    if try_load() is None:
        pytest.skip("native toolchain unavailable")
    cfg, pics = E.recipe_input(os.path.join(ROOT, "testdata",
                                            f"{E.RA16}.cfg"))
    enc = ENC.IntraEncoder(cfg, device=CPU)
    assert enc._enc_native() is not None
    data = enc.encode_stream(pics)
    recon = [[p.astype(np.uint16) for p in s[3]]
             for s in sorted(enc.stats, key=lambda s: s[2])]
    return data, len(pics), _md5(recon)


def test_recipe_bytes_equal_python_search(encoded):
    data, _, _ = encoded
    assert hashlib.md5(data).hexdigest() == E.RA16_MD5
    committed = open(os.path.join(ROOT, "testdata", f"{E.RA16}.bin"),
                     "rb").read()
    assert len(data) < len(committed)


@pytest.mark.parametrize("route", ["python/numpy", "native/numpy",
                                   "native/native", "torch"])
def test_recipe_decoders(encoded, route):
    data, n, md5 = encoded
    if route == "torch":
        dec = Decoder(parse="native", recon="torch", device=CPU,
                      check_sei_hash=True)
    else:
        parse, recon = route.split("/")
        dec = Decoder(parse=parse, recon=recon, check_sei_hash=True)
    assert _md5(dec.decode_annexb(data)) == md5
    assert [dp.hash_status for dp in dec.output_records] == ["OK"] * n


def test_recipe_batch_entry_points(encoded):
    data, n, md5 = encoded
    outs, statuses = E.decode_statuses(data, CPU)
    assert _md5(outs) == md5 and statuses == ["OK"] * n
    _, _, csum, got = DD.decode_batch_device(data, device=CPU)
    assert got == n and csum == DD.cropped_checksum(outs)
