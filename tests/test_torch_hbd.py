"""Bit depths 13 to 16 through the port on the CPU (plain torch versions).

Each plain version against its JAX function at bit depths 13, 14 and 16,
on numpy-seeded inputs shared by both sides, with array equality:

- K1: dequant (flat and scaled), inverse DCT 4-32 and DST 4, transform
  skip (its shift 15 - bd - log2n negative from 14 bits on a 4x4) and
  bypass, through `residual_scatter` against the JAX transform functions;
- K2: `intra_wavefront` against the JAX `_intra_batch` on real pictures;
- the loop filter: `device_filters.filter_level` against the JAX
  `filter_level` (`_filter_fn`: deblocking with the int16 chroma tc, SAO
  with the band shift bd - 5 and an offset scale of bd - 10);
- K5 and K6: `mc_grid_plain` and `mc_weighted_plain` against the JAX
  `_mc_phase_grid_fn` and `_mc_scatter_fn`, uni, bi and weighted.  The
  JAX default bi-prediction average shifts by 15 - bd, H.265's version 1
  value, which is wrong at 13 and 14 bits and a negative shift above;
  the port uses Rec. 8.5.3.3.4.2's Max(3, 15 - bitDepth), so JAX runs
  here with that one function replaced by the spec's (the same as the
  JAX one up to 12 bits, held below);
- K7: the uint32 checksum against jnp.sum(..., uint32) on samples of
  2^15 and more;
- K9: `pcm_level_plain` against the JAX per-block scatters at a PCM bit
  depth of 16, samples of 2^15 and more (zero-extended, not sign-extended).

Then the download (16-bit samples of 2^15 and more come back as they
are), the two CPU proxies of testdata/port_streams.json (Main 4:4:4 16
Intra 160x96 and 14-bit 4:2:0) through decode_batch (planes equal to the
JAX decode_batch), decode_intra_batch, decode_batch_device (checksum) and
Decoder(recon="torch"), each at its MD5 with every hash SEI OK, and the
1080p 16-bit stream under HEVC_SLOW_TESTS.  Weighted prediction with
high_precision_offsets_enabled_flag is in test_torch_conformance.py.
"""
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import interp as JI
from libhm_tpu.ops import transform as JT
from libhm_tpu.parallel import dag_decode as JD
from libhm_tpu_torch.ops import checksum as CK
from libhm_tpu_torch.ops import interp as MK
from libhm_tpu_torch.ops import pcm as PK
from libhm_tpu_torch.ops import transform as TT
from libhm_tpu_torch.parallel import dag_decode as DD

from lf_cases import smooth_planes
from mc_cases import block_table, pu_maps
from pcm_cases import pcm_blocks, plane_shapes
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))
CPU = torch.device("cpu")
PROXIES = ["rext444_16b_intra_160x96", "main14_intra_160x96"]


def _data(name):
    return open(os.path.join(ROOT, "testdata", PORT[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(np.asarray(p).tobytes() for pic in outs
                                for p in pic)).hexdigest()


def _items(name, bd=None):
    """The port's and the JAX package's collect items of a stream, with
    both bit depths set to `bd` when given."""
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = _data(name)
    out = []
    for make in (Decoder, JaxDecoder):
        dec = make(parse="native", recon="collect")
        dec.decode_annexb(data)
        if bd is not None:
            for it in dec.collected:
                it["sps"].bit_depth_luma = it["sps"].bit_depth_chroma = bd
        out.append(dec.collected)
    return out


# ---------------------------------------------------------------------------
# K1
# (n, path, dst, scaled): every row kind of K1's table
K1_BUCKETS = [(4, "itx", True, False), (8, "itx", False, False),
              (16, "itx", False, True), (32, "itx", False, False),
              (4, "tskip", False, False), (8, "tskip", False, False),
              (4, "tskip", False, True), (4, "bypass", False, False)]


@pytest.mark.parametrize("bd", [13, 14, 16])
def test_residual_plain_equals_jax(bd):
    rng = np.random.default_rng(1300 + bd)
    P = 6
    for n, path, dst, scaled in K1_BUCKETS:
        log2n = n.bit_length() - 1
        big = rng.integers(-32768, 32768, (P, n, n))
        small = rng.integers(-64, 65, (P, n, n))
        coeffs = np.where(rng.random((P, 1, 1)) < 0.5, big,
                          small).astype(np.int16)
        qp = rng.integers(0, 52 + 6 * (bd - 8), P).astype(np.int32)
        mats = rng.integers(1, 256, (2, n, n)).astype(np.uint8)
        midx = rng.integers(0, 2, P).astype(np.uint8)
        c = jnp.asarray(coeffs.astype(np.int32))
        if path == "bypass":
            want = np.asarray(c)
        else:
            if scaled:
                deq = JT.dequant_batch_scaling(
                    c, jnp.asarray(qp), jnp.asarray(mats[midx], jnp.int32),
                    bd, log2n)
            else:
                deq = JT.dequant_batch(c, jnp.asarray(qp), bd, log2n)
            want = np.asarray(
                JT.inverse_transform_skip_batch(deq, bd, log2n)
                if path == "tskip" else
                JT.inverse_transform_batch(deq, n, dst, bd))
        planes = torch.zeros((1, n, P * n), dtype=torch.int32)
        ar = torch.arange(P, dtype=torch.int32)
        TT.residual_scatter(
            planes, torch.from_numpy(coeffs),
            None if path == "bypass" else torch.from_numpy(qp).to(torch.int8),
            torch.zeros(P, dtype=torch.int32),
            torch.zeros(P, dtype=torch.int32), ar * n, n=n, use_dst=dst, tskip=path == "tskip", bd=bd,
            bypass=path == "bypass",
            mats=torch.from_numpy(mats) if scaled else None,
            midx=torch.from_numpy(midx) if scaled else None)
        got = planes.numpy()[0].reshape(n, P, n).transpose(1, 0, 2)
        assert want.any()
        np.testing.assert_array_equal(got, want, err_msg=f"{n} {path}")


# ---------------------------------------------------------------------------
# K2 and the loop filter, on real pictures with seeded planes
# (stream, component, bit depth set on both sides)
REAL = {13: ("main14_intra_160x96", 0), 14: ("main14_intra_160x96", 1),
        16: ("rext444_16b_intra_160x96", 1)}


@pytest.mark.parametrize("bd", sorted(REAL))
def test_intra_wavefront_plain_equals_jax(bd):
    from libhm_tpu.parallel.batch_decode import _intra_batch
    from libhm_tpu_torch.ops import intra as TI
    from libhm_tpu_torch.parallel import batch_decode as TB
    name, comp = REAL[bd]
    items, items_j = _items(name, bd)
    sps = items[0]["sps"]
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    Hp = (sps.pic_height_ctbs << sps.log2_ctb) >> sy
    Wp = (sps.pic_width_ctbs << sps.log2_ctb) >> sx
    rng = np.random.default_rng(bd)
    shape = (len(items), Hp, Wp)
    base = smooth_planes(rng, shape, bd)
    res = rng.integers(-(1 << (bd - 3)), 1 << (bd - 3), shape).astype(
        np.int32)
    got = TI.intra_wavefront(
        torch.from_numpy(base.copy()), torch.from_numpy(res),
        TB.intra_meta(items, comp, CPU), is_luma=comp == 0, bd=bd,
        W=sps.width >> sx, H=sps.height >> sy)
    want = np.asarray(_intra_batch(items_j, comp, None, None,
                                   stacked=jnp.asarray(base),
                                   res_stacked=jnp.asarray(res)))
    assert not np.array_equal(want, base)
    assert (want >= 1 << (bd - 1)).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", sorted(REAL))
def test_filter_level_equals_jax(bd):
    """Both pictures of the stream as one level, at the SAO offset scale
    bd - 10, the largest the PPS range extension allows, with every other
    CTB's SAO made a band offset (the encoder picks edge offsets here) at
    bands the seeded planes reach."""
    from libhm_tpu.parallel.device_filters import filter_level as jax_level
    from libhm_tpu_torch.parallel import device_filters as DF
    name, _ = REAL[bd]
    items, items_j = _items(name, bd)
    for it in items + items_j:
        it["pps"].sao_offset_scale_luma = bd - 10
        it["pps"].sao_offset_scale_chroma = bd - 10
        pic = it["pic"]
        k = np.arange(len(pic.sao_type))
        pic.sao_type[k % 2 == 0] = 0
        pic.sao_band_pos[k % 2 == 0] = (12 + k[k % 2 == 0] % 5)[:, None]
    it = items[0]
    maps = DF.prepare_filter_maps(it["pic"], it["sps"], it["pps"],
                                  it["tile_map"])
    assert maps["ctc_v"].dtype == np.int16           # chroma tc above 11 bits
    assert (maps["sao_t"] == 0).any()                # band offsets
    sps = items[0]["sps"]
    rng = np.random.default_rng(20 + bd)
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    sx, sy = sps.chroma_shift_x(), sps.chroma_shift_y()
    planes = [smooth_planes(rng, (len(items), Hp >> (sy if c else 0),
                                  Wp >> (sx if c else 0)), bd)
              for c in range(3)]
    got = DF.filter_level(items, [torch.from_numpy(p) for p in planes], sps,
                          CPU)
    want = jax_level(items_j, [jnp.asarray(p) for p in planes],
                     items_j[0]["sps"])
    for c in range(3):
        w = np.asarray(want[c])
        assert not np.array_equal(w, planes[c]), c
        np.testing.assert_array_equal(got[c].numpy(), w, err_msg=str(c))


# ---------------------------------------------------------------------------
# K5 and K6
def spec_bi_average(p0, p1, bd):
    """Rec. 8.5.3.3.4.2 default weighted prediction of two lists: shift2 =
    Max(3, 15 - bitDepth) on the 14-bit intermediates (less IF_OFFS)."""
    shift = max(3, 15 - bd)
    return jnp.clip((p0 + p1 + (1 << (shift - 1)) + 2 * JI.IF_OFFS) >> shift,
                    0, (1 << bd) - 1)


def test_bi_average_is_jax_up_to_12_bits_and_spec_above():
    rng = np.random.default_rng(7)
    for bd in range(8, 17):
        p0, p1 = (rng.integers(-(1 << 14), 1 << 19, 4096).astype(np.int32)
                  for _ in range(2))
        spec = np.asarray(spec_bi_average(jnp.asarray(p0), jnp.asarray(p1),
                                          bd))
        got = MK.bi_average(torch.from_numpy(p0), torch.from_numpy(p1), bd)
        np.testing.assert_array_equal(got.numpy(), spec, err_msg=str(bd))
        if bd <= 12:
            np.testing.assert_array_equal(np.asarray(JI.bi_average(
                jnp.asarray(p0), jnp.asarray(p1), bd)), spec)


MC_CASES = {13: (True, 0, 0), 14: (False, 1, 1), 16: (True, 0, 0)}
B, R = 2, 3
HP, WP, H, W = 64, 96, 60, 88          # luma: padded plane, picture


@pytest.mark.parametrize("bd", sorted(MC_CASES))
def test_mc_grid_plain_equals_jax(bd, monkeypatch):
    monkeypatch.setattr(JI, "bi_average", spec_bi_average)
    is_luma, sx, sy = MC_CASES[bd]
    rng = np.random.default_rng(500 + bd)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    hp, wp, h, w = HP >> sy, WP >> sx, H >> sy, W >> sx
    h4, w4 = HP // 4, WP // 4
    mv = rng.integers(-96, 97, (B, h4, w4, 2, 2)).astype(np.int16)
    dirm = rng.integers(0, 4, (B, h4, w4)).astype(np.int8)
    sel = rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    stacked = rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)
    res = rng.integers(-(1 << bd) // 2, (1 << bd) // 2,
                       (B, hp, wp)).astype(np.int32)
    build, fn = JD._mc_phase_grid_fn.__wrapped__(sx, sy, taps, fbx, fby, bd,
                                                 h4, w4, w, h)
    want = np.asarray(fn(jnp.asarray(stacked), jnp.asarray(res),
                         build(jnp.asarray(refs)), jnp.asarray(mv),
                         jnp.asarray(dirm), jnp.asarray(sel)))
    got = MK.mc_grid_plain(torch.from_numpy(stacked.copy()),
                           torch.from_numpy(res), torch.from_numpy(refs),
                           torch.from_numpy(mv), torch.from_numpy(dirm),
                           torch.from_numpy(sel), is_luma=is_luma, sx=sx,
                           sy=sy, bd=bd, W=w, H=h)
    assert (want != stacked).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", sorted(MC_CASES))
def test_mc_weighted_plain_equals_jax(bd, monkeypatch):
    monkeypatch.setattr(JI, "bi_average", spec_bi_average)
    is_luma, sx, sy = MC_CASES[bd]
    rng = np.random.default_rng(600 + bd)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    hp, wp, h, w = HP >> sy, WP >> sx, H >> sy, W >> sx
    blk = block_table(pu_maps(rng, B, R, HP, WP), sx, sy, bd)
    assert (blk[:, 3] == 3).any() and (blk[:, 3] == 1).any()
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    stacked = rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)
    res = rng.integers(-(1 << bd) // 2, (1 << bd) // 2,
                       (B, hp, wp)).astype(np.int32)
    args = [jnp.asarray(a) for a in (
        blk[:, 8], blk[:, 9], blk[:, 0], blk[:, 1], blk[:, 2],
        blk[:, 4:8].reshape(-1, 2, 2), blk[:, 3], blk[:, 10:12],
        blk[:, 12:14])]
    for epi, denom in (("plain", 0), ("wp", 0), ("wp", 7)):
        fn = JD._mc_scatter_fn.__wrapped__(4 >> sx, 4 >> sy, taps, fbx, fby,
                                           bd, epi)
        want = np.asarray(fn(jnp.asarray(stacked), jnp.asarray(res),
                             jnp.asarray(refs), *args, denom, w, h))
        got = torch.from_numpy(stacked.copy())
        MK.mc_weighted(got, torch.from_numpy(res), torch.from_numpy(refs),
                       torch.from_numpy(blk), is_luma=is_luma, sx=sx, sy=sy,
                       bd=bd, wp=epi == "wp", denom=denom, W=w, H=h)
        assert (want != stacked).any()
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{epi} {denom}")


# ---------------------------------------------------------------------------
# K7, K9 and the download
def test_checksum_plain_equals_jax_above_2_15():
    rng = np.random.default_rng(16)
    planes = [rng.integers(0, 1 << 16, (2, 70, 90)).astype(np.int32)
              for _ in range(3)]
    crops = [p[b, 1 + b:67 - b, 3:87 + b] for p in planes for b in range(2)]
    crops += [np.full((1024, 1024), 65535, np.int32)]
    assert max(int(c.max()) for c in crops) >= 1 << 15
    want = int(jnp.sum(jnp.stack([jnp.sum(jnp.asarray(c).astype(jnp.uint32))
                                  for c in crops])))
    got = CK.plane_checksum([torch.from_numpy(c) for c in crops])
    assert int(got.item()) == want


@pytest.mark.parametrize("fmt", [1, 3])
def test_pcm_level_plain_equals_jax_at_16_bits(fmt):
    """PCM samples of 16 bits (shift 0) and of 14 bits shifted by 2, as
    the JAX package scatters them into int32 planes."""
    blocks = pcm_blocks(np.random.default_rng(160 + fmt), fmt, 2, 64, 96,
                        shifts=(0, 2), bd=16)
    assert max(int(s.max()) for *_, s in blocks) >= 1 << 15
    shapes = plane_shapes(fmt, 2, 64, 96)
    want = [jnp.zeros(s, jnp.int32) for s in shapes]
    for c, b, x, y, w, h, shift, s in blocks:
        blk = np.asarray(s, np.int32).reshape(h, w) << shift
        want[c] = want[c].at[b, y:y + h, x:x + w].set(jnp.asarray(blk))
    buf, counts = PK.pcm_pack(blocks)
    planes = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    PK.pcm_level(planes, PK.pcm_table(torch.from_numpy(buf), counts))
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_download_keeps_samples_above_2_15():
    """_recon_shard narrows each plane to two bytes a sample on the device;
    _download gives back the samples of the device planes, 2^15 and above
    included."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.utils import xfer
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(_data("rext444_16b_intra_160x96"))
    xfer.reset()
    pending = DD._recon_levels(dec.collected, [CPU])
    for dp, _, small in pending:
        assert all(s.dtype == torch.int16 for s in small)
        got = DD._download(small)
        for c, (key, dev) in enumerate(sorted(dp._device_planes.items())):
            assert key[0] == c
            h, w = dev.shape
            np.testing.assert_array_equal(got[c][:h, :w], dev.numpy())
        assert max(int(p.max()) for p in got) >= 1 << 15
    assert xfer.D2H == sum(2 * s.numel() for _, _, sm in pending
                                 for s in sm)


# ---------------------------------------------------------------------------
# whole streams
@pytest.mark.parametrize("name", PROXIES)
def test_proxy_decode_batch_equals_jax(name):
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    data = _data(name)
    outs = DD.decode_batch(data, device=CPU)
    assert _md5(outs) == PORT[name]["decoded_yuv_md5"]
    want = jax_decode(data, parse="native")
    assert len(outs) == len(want) == PORT[name]["frames"]
    for pic_t, pic_j in zip(outs, want):
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", PROXIES)
def test_proxy_entry_points(name):
    """decode_intra_batch (decode_batch's reconstruction and download, with
    the hash SEI check), the per-picture Decoder(recon="torch") and
    decode_batch_device's checksum."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    data, md5 = _data(name), PORT[name]["decoded_yuv_md5"]
    dps = decode_intra_batch(data, device=CPU, check_sei_hash=True)
    assert [dp.hash_status for dp in dps] == ["OK"] * 2
    assert _md5([dp.cropped() for dp in dps]) == md5
    dec = Decoder(parse="native", recon="torch", device=CPU,
                  check_sei_hash=True)
    outs = dec.decode_annexb(data)
    assert _md5(outs) == md5
    assert [dp.hash_status for dp in dec.output_records] == ["OK"] * 2
    _, _, csum, n = DD.decode_batch_device(data, device=CPU)
    assert n == 2 and csum == DD.cropped_checksum(outs)


def test_1080p_16bit_stream():
    if not os.environ.get("HEVC_SLOW_TESTS"):
        pytest.skip("set HEVC_SLOW_TESTS=1 for the 1080p 16-bit stream")
    name = "rext444_16b_intra_1080p"
    data = _data(name)
    outs = DD.decode_batch(data, device=CPU, check_sei_hash=True)
    assert _md5(outs) == PORT[name]["decoded_yuv_md5"]
    _, _, csum, _ = DD.decode_batch_device(data, device=CPU)
    assert csum == DD.cropped_checksum(outs)
