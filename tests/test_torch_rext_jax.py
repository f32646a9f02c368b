"""The port's RExt pieces equal the JAX package's, exactly, on the CPU.

- ccp_apply's plain version (CCP, K1's epilogue on the card) against JAX
  _ccp_fn on seeded planes:
  every TU size and alpha, TUs touching the plane's right and bottom
  edges, values driven into the int16 clip;
- the residual planes of ccp444_lowdelay_160x96 (cross-component
  prediction on RDPCM and rotated residuals) against JAX
  _residual_planes_batch_device;
- K3 chroma's plain version with the int16 tc map of 12-bit chroma
  against JAX deblock_chroma_vertical, gathered as the JAX _filter_fn
  gathers it, for 4:2:0 and 4:2:2 grids, both directions;
- K5's plain version against JAX _mc_grid_fn (the chunked window-gather
  form of the grid MC, which has no caller in the JAX package) for luma
  and 4:2:2 chroma;
- the full decode of ccp444_lowdelay_160x96 and rext422_noRdoq_160x96
  against JAX decode_batch, plane by plane.
Kept apart from test_torch_rext_decode.py because the JAX functions
compile on the CPU.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")
ALPHAS = (-8, -4, -2, -1, 1, 2, 4, 8)


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def test_ccp_plain_equals_jax():
    import jax.numpy as jnp
    from libhm_tpu.parallel.batch_decode import _ccp_fn
    from libhm_tpu_torch.ops import ccp as CK
    rng = np.random.default_rng(11)
    B, H, W = 2, 128, 256
    res_c = rng.integers(-32768, 32768, (B, H, W)).astype(np.int32)
    res_l = rng.integers(-32768, 32768, (B, H, W)).astype(np.int32)
    # one TU per 32x32 cell, in the cell's bottom-right corner: the last
    # row and column of cells touch the plane's edges
    cells = [(b, y, x) for b in range(B) for y in range(0, H, 32)
             for x in range(0, W, 32)]
    pick = rng.permutation(len(cells))
    rows = []
    for k, (n, a) in enumerate((n, a) for n in (4, 8, 16, 32)
                               for a in ALPHAS):
        b, y, x = cells[pick[k]]
        rows.append((b, y + 32 - n, x + 32 - n, n, a))
    assert any(y + n == H for _, y, _, n, _ in rows)
    assert any(x + n == W for _, _, x, n, _ in rows)
    tus = np.asarray(rows, np.int32)
    got = CK.ccp_apply(torch.from_numpy(res_c.copy()),
                       torch.from_numpy(res_l), torch.from_numpy(tus))
    want = jnp.asarray(res_c)
    for n in (4, 8, 16, 32):
        t = tus[tus[:, 3] == n]
        want = _ccp_fn(n)(want, jnp.asarray(res_l), jnp.asarray(t[:, 0]),
                          jnp.asarray(t[:, 1]), jnp.asarray(t[:, 2]),
                          jnp.asarray(t[:, 4]))
    want = np.asarray(want)
    assert np.array_equal(got.numpy(), want)
    assert (np.abs(want) == 32767).sum() + (want == -32768).sum() > \
        (np.abs(res_c) == 32767).sum() + (res_c == -32768).sum()


def test_ccp_residual_planes_equal_jax():
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu.parallel import batch_decode as JB
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    data = _data("ccp444_lowdelay_160x96")
    dec_t = Decoder(parse="native", recon="collect")
    dec_t.decode_annexb(data)
    dec_j = JaxDecoder(parse="native", recon="collect")
    dec_j.decode_annexb(data)
    items_t, items_j = dec_t.collected, dec_j.collected
    assert any(tu.comp and tu.cross_comp_alpha
               for it in items_t for tu in it["pic"].tu_list)
    B = len(items_t)
    n0 = TK._K1_CCP.launches
    got = TB._residual_planes_batch_device(items_t, B, CPU)
    assert TK._K1_CCP.launches == n0       # the plain version on the CPU
    want = JB._residual_planes_batch_device(items_j, B)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _chroma_maps(rng, h4, w4, bd):
    """bsn and the table-mapped tc of a 12-bit chroma component."""
    from libhm_tpu_torch.ops.deblock import TC_TABLE
    bs = rng.integers(0, 3, (h4, w4)).astype(np.uint8)
    nop = (rng.random((h4, w4)) < 0.1).astype(np.uint8)
    noq = (rng.random((h4, w4)) < 0.1).astype(np.uint8)
    idx = rng.integers(0, 54, (h4, w4))
    tc = np.where(bs == 2, np.asarray(TC_TABLE)[idx] << (bd - 8), 0)
    return bs | (nop << 4) | (noq << 5), tc.astype(np.int16)


@pytest.mark.parametrize("ssx,ssy", [(1, 1), (1, 0)])
def test_chroma_deblock_int16_tc_equals_jax(ssx, ssy):
    import jax.numpy as jnp
    from libhm_tpu.ops import deblock as JD
    from libhm_tpu_torch.ops import deblock as DK
    rng = np.random.default_rng(12 + ssy)
    bd, Hl, Wl = 12, 64, 128
    h4, w4 = Hl // 4, Wl // 4
    Hc, Wc = Hl >> ssy, Wl >> ssx
    plane = rng.integers(1800, 2300, (Hc, Wc)).astype(np.int32)
    for vertical in (True, False):
        bsn, ctc = _chroma_maps(rng, h4, w4, bd)
        assert ctc.max() > 255
        got = DK.deblock_chroma(torch.from_numpy(plane[None].copy()),
                                torch.from_numpy(ctc[None]),
                                torch.from_numpy(bsn[None]),
                                vertical=vertical, bd=bd, ssx=ssx, ssy=ssy)
        # the gather of libhm_tpu/parallel/device_filters.py _filter_fn
        cpl = plane if vertical else plane.T
        Hx, Wx = cpl.shape
        ri = np.arange(Hx) >> (2 - (ssy if vertical else ssx))
        ci = np.arange(Wx // 8) << (1 + (ssx if vertical else ssy))
        sel = (ri[:, None], ci[None, :]) if vertical else \
            (ci[None, :], ri[:, None])
        tcc, m = ctc[sel].astype(np.int32), bsn[sel]
        out = np.asarray(JD.deblock_chroma_vertical(
            jnp.asarray(cpl), jnp.asarray(tcc), jnp.asarray(tcc != 0),
            jnp.asarray((m & 16) != 0), jnp.asarray((m & 32) != 0), bd))
        want = out if vertical else out.T
        assert not np.array_equal(want, plane)
        assert np.array_equal(got[0].numpy(), want)
        plane = want


@pytest.mark.parametrize("is_luma,sx,sy", [(True, 0, 0), (False, 1, 0)])
def test_mc_grid_plain_equals_jax_mc_grid_fn(is_luma, sx, sy):
    """Queue B row 9: K5 computes what JAX _mc_grid_fn computes."""
    import jax.numpy as jnp
    from libhm_tpu.parallel.dag_decode import _mc_grid_fn
    from libhm_tpu_torch.ops import interp as MK
    rng = np.random.default_rng(13 + sx)
    B, R, bd = 2, 3, 10
    Hl, Wl = 64, 96                      # the luma picture
    h4, w4 = Hl // 4, Wl // 4
    H, W = Hl >> sy, Wl >> sx
    Hp, Wp = H + (16 >> sy), W + (16 >> sx)   # CTB padding
    stacked = rng.integers(0, 1 << bd, (B, Hp, Wp)).astype(np.int32)
    res = rng.integers(-256, 257, (B, Hp, Wp)).astype(np.int32)
    refs = rng.integers(0, 1 << bd, (R, H, W)).astype(np.int32)
    mv = rng.integers(-160, 161, (B, h4, w4, 2, 2)).astype(np.int16)
    dirm = rng.integers(0, 4, (B, h4, w4)).astype(np.int8)
    sel = rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    got = MK.mc_grid(torch.from_numpy(stacked.copy()), torch.from_numpy(res),
                     torch.from_numpy(refs), torch.from_numpy(mv),
                     torch.from_numpy(dirm), torch.from_numpy(sel),
                     is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=W, H=H)
    fn = _mc_grid_fn(4 >> sx, 4 >> sy, taps, fbx, fby, bd, sx, sy, h4, w4,
                     W, H)
    want = np.asarray(fn(jnp.asarray(stacked), jnp.asarray(res),
                         jnp.asarray(refs), jnp.asarray(mv),
                         jnp.asarray(dirm), jnp.asarray(sel)))
    assert not np.array_equal(want, stacked)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["ccp444_lowdelay_160x96",
                                  "rext422_noRdoq_160x96"])
def test_rext_decode_equals_jax(name):
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    from libhm_tpu_torch.parallel import dag_decode as DD
    data = _data(name)
    outs = DD.decode_batch(data, device=CPU)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    want = jax_decode(data)
    assert len(outs) == len(want)
    for pic_t, pic_j in zip(outs, want):
        assert len(pic_t) == len(pic_j) == 3
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
