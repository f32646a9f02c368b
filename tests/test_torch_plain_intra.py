"""The benchmark's plain reference of intra reconstruction
(hevc_bench/plain_intra.py, H.265 8.4.4.2 block after block in decoding
order) against the port's intra path on the CPU: prepare_component ->
intra_table / intra_meta -> ops.intra.intra_wavefront, whose CPU path is
intra_wavefront_plain.

- seeded random layouts (tests/intra_layouts.py): a random quadtree over
  a few CTUs, modes 0..34, residuals zero, small or across the whole
  range, at 8, 10 and 16 bits; 4:4:4 chroma (filtered, no edge filters);
  lossless CUs under implicit RDPCM (no edge filters of modes 10, 26);
- the I pictures of intra_main10_416x240 and randomaccess_main10_416x240
  from the native parse, each component, with K1's residual planes
  (tools/check_intra_reference.py item_reference, which makes the same
  comparison on the card for the 4K stream's I picture).

Sample values are integers: exact equality (tolerance 0).
"""
import json
import os

import pytest
import torch

import intra_layouts as LY
from libhm_tpu_torch.parallel import batch_decode as TB
from tools.check_intra_reference import item_reference
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bd", [8, 10, 16])
def test_random_layout(bd, seed):
    W, H = 200, 136                 # 4 x 3 CTUs, the last ones cut
    blocks = LY.random_layout(1000 * bd + seed, W, H, bd)
    got, _ = LY.port_reconstruct(blocks, W, H, bd, CPU)
    want = LY.reference(blocks, W, H, bd)
    assert int(want.min()) == 0 and int(want.max()) == (1 << bd) - 1
    assert torch.equal(got.to(torch.int64), want), \
        int((got.to(torch.int64) != want).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_random_layout_444_chroma(seed):
    W, H = 136, 72
    blocks = LY.random_layout(77 + seed, W, H, 10, log2_ctb=5)
    got, _ = LY.port_reconstruct(blocks, W, H, 10, CPU, comp=1, log2_ctb=5)
    want = LY.reference(blocks, W, H, 10, comp=1)
    assert torch.equal(got.to(torch.int64), want)


def test_random_layout_lossless_implicit_rdpcm():
    W, H, bd = 128, 64, 10
    blocks = LY.random_layout(6, W, H, bd, bypass=True)
    assert any(b[3] in (10, 26) and b[5] and b[2] < 32 for b in blocks)
    got, table = LY.port_reconstruct(blocks, W, H, bd, CPU,
                                     implicit_rdpcm=True)
    assert ((table["rows"]["nf"] >> 4) & 4).any()       # dbf set somewhere
    want = LY.reference(blocks, W, H, bd, implicit_rdpcm=True)
    assert torch.equal(got.to(torch.int64), want)
    # the flag matters: without it the reference differs
    assert not torch.equal(LY.reference(blocks, W, H, bd), want)


def _first_picture(name):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    it = dec.collected[0]
    assert not it["pic"].inter_list        # an I picture
    return it


@pytest.mark.parametrize("comp", [0, 1, 2])
@pytest.mark.parametrize("name", ["intra_main10_416x240",
                                  "randomaccess_main10_416x240"])
def test_stream_i_picture(name, comp):
    it = _first_picture(name)
    sps = it["sps"]
    res = TB._residual_planes_batch_device([it], 1, CPU)[comp]
    plane = TB._intra_batch([it], comp, torch.zeros_like(res), res, CPU)
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    W, H = sps.width >> sx, sps.height >> sy
    want = item_reference(it, comp, res[0].to(torch.int64))
    got = plane[0, :H, :W].to(torch.int64)
    assert torch.equal(got, want), int((got != want).sum())


def test_check_tool_on_the_cpu(tmp_path, capsys):
    """tools/check_intra_reference.py, rehearsed on the CPU: decode_batch
    with K2's inputs and output kept on the I picture, the reference on
    every component, the decode's MD5 against HM's."""
    from tools import check_intra_reference as tool
    out = tmp_path / "ref.json"
    assert tool.main([os.path.join(ROOT, "testdata",
                                   "intra_main10_416x240.bin"),
                      "--device", "cpu", "--json", str(out)]) == 0
    line = json.loads(out.read_text())
    assert line == json.loads(capsys.readouterr().out)
    assert line["ok"] and line["md5"] == line["md5_golden"]
    assert sorted(line["components"]) == ["0", "1", "2"]
    for c in line["components"].values():
        assert c["samples_wrong"] == 0 and c["blocks"] > 0
        assert c["plane_blocks"] == 0 and c["lattice"] is None
