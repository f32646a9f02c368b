"""The port's per-picture decode and its entry points on the CPU (plain
torch versions of the kernels).

- Decoder(parse="native", recon="torch", device="cpu") at the golden MD5
  of intra, random-access, weighted-prediction, tile, 4:4:4 CCP, 4:0:0,
  12-bit and CRA-start (RASL skipping) streams, and every hash SEI OK on
  field_ra_160x96; after each decode no picture outside the DPB, and no
  picture unused for reference, holds device planes, and no reference
  plane was uploaded from the host;
- the libHMDec push/re-feed protocol of libhm_tpu_torch.api, its SEI
  check and internal info;
- decode_intra_batch, dec_app and the refusals (CUDA asked for on a host
  without it, inter pictures in decode_intra_batch); a stream with
  extended precision forced decodes as the numpy decoder does.
"""
import hashlib
import json
import os

import pytest
import torch

from libhm_tpu_torch.utils import xfer
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def _md5(pics):
    return hashlib.md5(b"".join(p.tobytes() for pic in pics
                                for p in pic)).hexdigest()


def _decode(name, **kw):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="torch", device=CPU, **kw)
    xfer.reset()
    outs = dec.decode_annexb(_data(name))
    in_dpb = {id(p) for p in dec.dpb}
    held = [p.poc for p in dec.output_records
            if (id(p) not in in_dpb or not p.is_reference)
            and hasattr(p, "_device_planes")]
    assert not held, held
    assert all(hasattr(p, "_device_planes") for p in dec.dpb
               if p.is_reference)
    assert "ref" not in xfer.BY_TAG, xfer.BY_TAG
    return dec, outs


@pytest.mark.parametrize("name", ["intra_64x64", "tids4_ra_160x96",
                                  "wp_lowdelayP_416x240",
                                  "tiles_nolfcross_512x128",
                                  "ccp444_lowdelay_160x96",
                                  "mono_lowdelay_160x96",
                                  "main12_intra_416x240",
                                  "cra_start_416x240"])
def test_picture_decode_matches_golden(name):
    dec, outs = _decode(name)
    assert len(outs) == GOLD[name]["frames"]
    assert _md5(outs) == GOLD[name]["decoded_yuv_md5"]


def test_field_stream_hash_seis():
    dec, outs = _decode("field_ra_160x96", check_sei_hash=True)
    assert len(outs) == GOLD["field_ra_160x96"]["frames"]
    assert [r.hash_status for r in dec.output_records] == ["OK"] * len(outs)


def test_device_planes_released_after_every_nal():
    """NAL by NAL: after each one, every reference picture of the DPB
    holds device planes and no other picture does, including one the
    new picture's RPS has just marked unused for reference."""
    from libhm_tpu_torch.hostdec import nal as N
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "tids4_ra_160x96"
    dec = Decoder(parse="native", recon="torch", device=CPU)
    xfer.reset()

    def check():
        for p in dec.output_records + dec.dpb:
            keep = p.is_reference and any(p is q for q in dec.dpb)
            assert hasattr(p, "_device_planes") == keep, p.poc
    for ebsp in N.split_annexb(_data(name)):
        dec.decode_nal(N.parse_nal(ebsp))
        check()
    dec.flush()
    check()
    assert _md5(dec.outputs) == GOLD[name]["decoded_yuv_md5"]
    assert "ref" not in xfer.BY_TAG


def _push_all(dec, data):
    """Drive the libHMDec protocol: re-push on a new picture, drain the
    output queue whenever it says so."""
    from libhm_tpu_torch.hostdec import nal as N
    pics = []
    nals = list(N.split_annexb(data))
    i = 0
    while i < len(nals):
        new_pic, check = dec.push_nal_unit(nals[i], i == len(nals) - 1)
        if check:
            while True:
                p = dec.get_picture()
                if p is None:
                    break
                pics.append(p)
        if not new_pic:
            i += 1
    return pics


def test_push_nal_protocol():
    from libhm_tpu_torch import api
    name = "lowdelayP_416x240"
    dec = api.new_decoder(device="cpu")
    assert (dec._core.parse, dec._core.recon) == ("native", "torch")
    pics = _push_all(dec, _data(name))
    assert len(pics) == GOLD[name]["frames"]
    assert _md5(p.planes for p in pics) == GOLD[name]["decoded_yuv_md5"]
    info = dec.get_internal_info(pics[1], api.PU_MV_0)
    assert info and len(info[0]) == 6
    assert pics[1].get_bit_depth(0) == 8 and pics[1].get_width(0) == 416


def test_push_sei_hash_check():
    from libhm_tpu_torch import api
    dec = api.new_decoder(device="cpu")
    dec.set_sei_check(True)
    pics = _push_all(dec, _data("intra_64x64"))
    assert pics and all(p.hash_status == "OK" for p in pics)


def test_decode_intra_batch():
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    name = "intra_416x240"
    dps = decode_intra_batch(_data(name), device="cpu", check_sei_hash=True)
    assert _md5(dp.cropped() for dp in dps) == GOLD[name]["decoded_yuv_md5"]
    assert [dp.hash_status for dp in dps] == ["OK"] * GOLD[name]["frames"]
    assert not any(hasattr(dp, "_device_planes") for dp in dps)
    with pytest.raises(ValueError, match="inter pictures"):
        decode_intra_batch(_data("lowdelayP_416x240"), device="cpu")


def test_dec_app_writes_golden_yuv(tmp_path, capsys):
    from libhm_tpu_torch.apps import dec_app
    name = "lowdelayP_416x240"
    out = tmp_path / "out.yuv"
    assert dec_app.main(["-b", os.path.join(ROOT, "testdata",
                                            GOLD[name]["bitstream"]),
                         "-o", str(out), "--device", "cpu",
                         "--sei-check"]) == 0
    assert hashlib.md5(out.read_bytes()).hexdigest() == \
        GOLD[name]["decoded_yuv_md5"]
    assert "[OK]" in capsys.readouterr().out


def test_cuda_requested_without_gpu_raises(monkeypatch):
    from libhm_tpu_torch import api, entry
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Decoder(parse="native", recon="torch"),
                 lambda: api.HmDecoder(),
                 lambda: api.new_decoder(device="cuda"),
                 lambda: decode_intra_batch(_data("intra_64x64")),
                 lambda: entry.entry()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the host backends need no device
    assert api.HmDecoder(recon="numpy")._core.recon == "numpy"


def test_extended_precision_refused(monkeypatch):
    """Extended precision was refused here by name; it is ported now.  The
    per-picture path decodes the 10-bit 4:4:4 CCP stream with the flag
    forced in every SPS (max_dyn_range 16, CCP unclipped) to what the
    numpy decoder gives under the same flag, which is not the golden."""
    from libhm_tpu_torch.hostdec import decoder as D
    real = D.parse_sps

    def forced(rbsp):
        sps = real(rbsp)
        sps.extended_precision = 1
        return sps
    monkeypatch.setattr(D, "parse_sps", forced)
    name = "ccp444_lowdelay_160x96"
    _, outs = _decode(name)
    want = D.Decoder(parse="native", recon="numpy").decode_annexb(
        _data(name))
    assert _md5(outs) == _md5(want) != GOLD[name]["decoded_yuv_md5"]
