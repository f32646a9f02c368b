"""Port parity: libhm_tpu_torch.ops.{deblock,sao,pcm} vs libhm_tpu.

The luma and chroma deblocking passes, the port's map-driven wrappers in
both edge directions (against the JAX _filter_fn layout), sao_component
for band offset and the four edge-offset classes and in its multi-slice/
tile form, and the plain versions of the restore (K8) and PCM level (K9)
kernels against their JAX formulations.  Integer arithmetic throughout:
exact equality (tolerance 0).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import deblock as JD
from libhm_tpu.ops import sao as JS
from libhm_tpu_torch.ops import deblock as TD
from libhm_tpu_torch.ops import pcm as PS
from libhm_tpu_torch.ops import sao as TS
import torch_threads  # noqa: F401


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    assert (a == b).all(), int((a != b).sum())


def _smooth_plane(rng, H, W, bd):
    """Piecewise-flat picture with small noise: flat, weak and strong
    deblocking decisions all occur."""
    base = rng.randint(0, 1 << bd, size=(H // 4 + 1, W // 4 + 1)) >> 3
    base += (1 << (bd - 1)) - (1 << (bd - 4))
    plane = np.repeat(np.repeat(base, 4, 0), 4, 1)[:H, :W]
    plane = plane + rng.randint(-2, 3, size=(H, W))
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int32)


def _luma_maps(rng, h4, w4):
    bs = rng.randint(0, 3, size=(h4, w4)).astype(np.uint8)
    bs[:, 0] = 0
    bs[0, :] = 0
    nop = (rng.rand(h4, w4) < 0.1).astype(np.uint8)
    noq = (rng.rand(h4, w4) < 0.1).astype(np.uint8)
    bsn = bs | (nop << 4) | (noq << 5)
    qp = rng.randint(15, 52, size=(h4, w4)).astype(np.int8)
    bo = (2 * rng.randint(-3, 4, size=(h4, w4))).astype(np.int8)
    to = (2 * rng.randint(-3, 4, size=(h4, w4))).astype(np.int8)
    return bsn, qp, bo, to


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_vertical(bd):
    rng = np.random.RandomState(bd)
    H, W = 64, 96
    plane = _smooth_plane(rng, H, W, bd)
    bs = rng.randint(0, 3, size=(H // 4, W // 8)).astype(np.int32)
    bs[:, 0] = 0
    qp = rng.randint(15, 52, size=bs.shape).astype(np.int32)
    bo = (2 * rng.randint(-3, 4, size=bs.shape)).astype(np.int32)
    to = (2 * rng.randint(-3, 4, size=bs.shape)).astype(np.int32)
    nop = rng.rand(*bs.shape) < 0.1
    noq = rng.rand(*bs.shape) < 0.1
    args = (plane, bs, qp, bo, to, nop, noq)
    want = jax.jit(functools.partial(JD.deblock_luma_vertical, bit_depth=bd))(
        *map(jnp.asarray, args))
    got = TD.deblock_luma_vertical(*map(torch.from_numpy, args), bd)
    assert (np.asarray(want) != plane).sum() > 100   # edges really filtered
    _eq(want, got)


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_chroma_vertical(bd):
    rng = np.random.RandomState(10 + bd)
    H, W = 32, 48
    plane = _smooth_plane(rng, H, W, bd)
    tc = rng.randint(0, 25, size=(H, W // 8)).astype(np.int32) << (bd - 8)
    filt = tc != 0
    nop = rng.rand(H, W // 8) < 0.1
    noq = rng.rand(H, W // 8) < 0.1
    args = (plane, tc, filt, nop, noq)
    want = jax.jit(functools.partial(JD.deblock_chroma_vertical,
                                     bit_depth=bd))(*map(jnp.asarray, args))
    got = TD.deblock_chroma_vertical(*map(torch.from_numpy, args), bd)
    _eq(want, got)


@pytest.mark.parametrize("vertical", [True, False])
def test_deblock_wrappers_match_filter_fn(vertical):
    """The port's map-driven wrappers (the kernels' plain path) equal the
    JAX pass as libhm_tpu/parallel/device_filters._filter_fn drives it: the
    H direction on the transposed plane with transposed segment maps."""
    bd, ssx, ssy = 10, 1, 1
    rng = np.random.RandomState(3 + vertical)
    H, W = 64, 128
    h4, w4 = H // 4, W // 4
    luma = _smooth_plane(rng, H, W, bd)
    chroma = _smooth_plane(rng, H // 2, W // 2, bd)
    bsn, qp, bo, to = _luma_maps(rng, h4, w4)
    ctc = np.where((bsn & 3) == 2, rng.randint(1, 25, size=(h4, w4)) << 2,
                   0).astype(np.uint8)

    # JAX reference, as in _filter_fn
    pl = luma if vertical else luma.T
    nsy, nsx = pl.shape[0] // 4, pl.shape[1] // 8

    def sb(a):
        a = a[:, ::2] if vertical else a[::2, :].T
        return jnp.asarray(a[:nsy, :nsx])
    m = sb(bsn)
    want = jax.jit(functools.partial(JD.deblock_luma_vertical, bit_depth=bd))(
        jnp.asarray(pl), (m & 3).astype(jnp.int32), sb(qp).astype(jnp.int32),
        sb(bo).astype(jnp.int32), sb(to).astype(jnp.int32), (m & 16) != 0,
        (m & 32) != 0)
    want_l = np.asarray(want) if vertical else np.asarray(want).T
    cpl = chroma if vertical else chroma.T
    ri = np.arange(cpl.shape[0]) >> (2 - (ssy if vertical else ssx))
    ci = np.arange(cpl.shape[1] // 8) << (1 + (ssx if vertical else ssy))
    if vertical:
        g = lambda a: jnp.asarray(a[ri[:, None], ci[None, :]])  # noqa: E731
    else:
        g = lambda a: jnp.asarray(a[ci[None, :], ri[:, None]])  # noqa: E731
    tcc = g(ctc).astype(jnp.int32)
    mc = g(bsn)
    want = jax.jit(functools.partial(JD.deblock_chroma_vertical,
                                     bit_depth=bd))(
        jnp.asarray(cpl), tcc, tcc != 0, (mc & 16) != 0, (mc & 32) != 0)
    want_c = np.asarray(want) if vertical else np.asarray(want).T

    t = lambda a: torch.from_numpy(np.array(a)[None])  # noqa: E731 (a copy)
    got_l = TD.deblock_luma(t(luma), t(bsn), t(qp), t(bo), t(to),
                            vertical=vertical, bd=bd)[0]
    got_c = TD.deblock_chroma(t(chroma), t(ctc), t(bsn), vertical=vertical,
                              bd=bd, ssx=ssx, ssy=ssy)[0]
    assert (want_l != luma).sum() > 100 and (want_c != chroma).sum() > 10
    _eq(want_l, got_l)
    _eq(want_c, got_c)


@pytest.mark.parametrize("sao_type", [-2, 0, 1, 2, 3, 4])
def test_sao_component(sao_type):
    """BO (0), the four EO classes (1..4), and a mix of all types with
    SAO-off CTBs (-2), at Main10 on a picture cropped inside its CTB grid."""
    bd, log2c = 10, 4
    rng = np.random.RandomState(20 + sao_type)
    Hp, Wp, H, W = 48, 64, 44, 60
    hc, wc = Hp >> log2c, Wp >> log2c
    plane = _smooth_plane(rng, Hp, Wp, bd)
    if sao_type == -2:
        t = rng.randint(-1, 5, size=(hc, wc)).astype(np.int32)
    else:
        t = np.full((hc, wc), sao_type, np.int32)
    band = rng.randint(0, 32, size=(hc, wc)).astype(np.int32)
    band[0, 0] = (plane[0, 0] >> (bd - 5))     # some samples in-band
    offs = rng.randint(-31, 32, size=(hc, wc, 4)).astype(np.int32)
    vm = np.ones((Hp, Wp), bool)
    fn = jax.jit(lambda p, v, a, b, o: JS.sao_component(
        p, v, a, b, o, log2c, bd, 1, W, H))
    want = fn(*map(jnp.asarray, (plane, vm, t, band, offs)))
    got = TS.sao_component(*map(torch.from_numpy, (plane, vm, t, band, offs)),
                           log2c, bd, 1, W, H)
    assert (np.asarray(want) != plane).sum() > 0
    _eq(want, got)
    got_wrapper = TS.sao(
        torch.from_numpy(plane)[None], torch.from_numpy(t.astype(np.int8))[None],
        torch.from_numpy(band.astype(np.int8))[None],
        torch.from_numpy(offs.astype(np.int8))[None],
        torch.ones(1, dtype=torch.int32), log2cx=log2c, log2cy=log2c, bd=bd,
        W=W, H=H)[0]
    _eq(want, got_wrapper)


def test_sao_multi_slice_form_raises():
    """The multi-slice form is ported; it refuses maps whose shape is not
    the plane's (the JAX gather would clamp the indices silently)."""
    plane = torch.zeros((16, 16), dtype=torch.int32)
    t = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="plane's shape"):
        TS.sao_component(plane, None, t, t, torch.zeros((1, 1, 4)), 4, 8, 0,
                         16, 16, slice_map=t)


def _multi_maps(rng, h4, w4, hc, wc):
    """Seeded luma-grid maps: 3 slices in raster order, 2 tile columns,
    loop filtering across slices on in one slice and off in the others."""
    s4 = np.zeros((h4, w4), np.int16)
    cut = sorted(rng.choice(np.arange(1, h4 * w4), 2, replace=False))
    s4.reshape(-1)[cut[0]:] = 1
    s4.reshape(-1)[cut[1]:] = 2
    lf4 = (s4 == 1).astype(np.uint8)
    tm = np.zeros((hc, wc), np.int16)
    tm[:, wc // 2:] = 1
    return s4, lf4, tm


@pytest.mark.parametrize("lf_tiles", [True, False])
@pytest.mark.parametrize("comp", ["luma", "chroma"])
def test_sao_component_multi(comp, lf_tiles):
    """The multi-slice/tile form: the port's sao_component and the plain
    sao_multi wrapper (luma-grid maps, clamped index arithmetic) equal the
    JAX sao_component as _filter_fn drives it, on a cropped picture."""
    bd, log2_ctb = 10, 5
    sx = sy = 1 if comp == "chroma" else 0
    rng = np.random.RandomState(40 + 2 * (comp == "chroma") + lf_tiles)
    HpL, WpL = 96, 128                        # luma CTB grid 3 x 4
    h4, w4, hc, wc = HpL // 4, WpL // 4, HpL >> log2_ctb, WpL >> log2_ctb
    Hp, Wp = HpL >> sy, WpL >> sx
    H, W = (88 >> sy), (120 >> sx)
    log2c = log2_ctb - sx
    plane = _smooth_plane(rng, Hp, Wp, bd)
    t = rng.randint(-1, 5, size=(hc, wc)).astype(np.int32)
    t[t == 0] = 2                             # mostly edge offsets
    band = rng.randint(0, 32, size=(hc, wc)).astype(np.int32)
    offs = rng.randint(-31, 32, size=(hc, wc, 4)).astype(np.int32)
    s4, lf4, tm = _multi_maps(rng, h4, w4, hc, wc)
    # JAX: the per-sample maps of device_filters._filter_fn
    ysi = np.minimum((np.arange(Hp) << sy) >> 2, h4 - 1)
    xsi = np.minimum((np.arange(Wp) << sx) >> 2, w4 - 1)
    tyc = np.minimum((np.arange(Hp) << sy) >> log2_ctb, hc - 1)
    txc = np.minimum((np.arange(Wp) << sx) >> log2_ctb, wc - 1)
    sm = s4[ysi[:, None], xsi[None, :]].astype(np.int32)
    lf = lf4[ysi[:, None], xsi[None, :]] != 0
    tmm = tm[tyc[:, None], txc[None, :]].astype(np.int32)
    fn = jax.jit(lambda p, a, b, o, s, f, m, x: JS.sao_component(
        p, None, a, b, o, log2c, bd, 1, W, H, slice_map=s, lf_map=f,
        tile_map=m, lf_across_tiles=x))
    want = fn(*map(jnp.asarray, (plane, t, band, offs, sm, lf, tmm)),
              jnp.asarray(lf_tiles))
    single = JS.sao_component(*map(jnp.asarray, (
        plane, np.ones((Hp, Wp), bool), t, band, offs)), log2c, bd, 1, W, H)
    assert (np.asarray(want) != np.asarray(single)).sum() > 0  # rules bite
    got = TS.sao_component(
        *map(torch.from_numpy, (plane, np.ones((Hp, Wp), bool), t, band,
                                offs)), log2c, bd, 1, W, H,
        slice_map=torch.from_numpy(sm), lf_map=torch.from_numpy(lf),
        tile_map=torch.from_numpy(tmm), lf_across_tiles=lf_tiles)
    _eq(want, got)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)[None])  # noqa
    got_wrapper = TS.sao_multi(
        T(plane), T(t.astype(np.int8)), T(band.astype(np.int8)),
        T(offs.astype(np.int8)), torch.ones(1, dtype=torch.int32), T(s4),
        T(lf4), T(tm), torch.tensor([lf_tiles], dtype=torch.uint8),
        log2cx=log2c, log2cy=log2c, bd=bd, W=W, H=H, sx=sx, sy=sy,
        log2_ctb=log2_ctb)[0]
    _eq(want, got_wrapper)


@pytest.mark.parametrize("sx,sy", [(0, 0), (1, 1)])
def test_restore_unfiltered_plain(sx, sy):
    """K8's plain version == the restore branch of the JAX _filter_fn
    (jnp.where over the whole padded plane, mask rows and columns
    clamped to the 4x4 grid)."""
    rng = np.random.RandomState(50 + sx)
    B, h4, w4 = 2, 17, 30                     # 1080p-like: 68 rows padded
    Hp, Wp = (h4 * 4 + 4) >> sy, (w4 * 4) >> sx
    planes = rng.randint(0, 1024, size=(B, Hp, Wp)).astype(np.int32)
    pre = rng.randint(0, 1024, size=(B, Hp, Wp)).astype(np.int32)
    rmask = (rng.rand(B, h4, w4) < 0.3).astype(np.uint8)

    def jax_restore(planes, pre, rm):
        ysi = jnp.minimum((jnp.arange(Hp) << sy) >> 2, h4 - 1)
        xsi = jnp.minimum((jnp.arange(Wp) << sx) >> 2, w4 - 1)
        mask = rm[ysi[:, None], xsi[None, :]] != 0
        return jnp.where(mask, pre, planes)
    want = jax.jit(jax.vmap(jax_restore))(
        *map(jnp.asarray, (planes, pre, rmask)))
    got = PS.restore_unfiltered(                # in place: on a copy
        *map(torch.from_numpy, (planes.copy(), pre, rmask)), sx=sx, sy=sy)
    assert (np.asarray(want) != planes).sum() > 0
    _eq(want, got)


def test_pcm_scatter_plain():
    """K9's plain version, through the one-launch level entry point
    (pcm_pack, pcm_level) == the JAX per-block scatters of
    dag_decode._recon_levels, including a reduced PCM bit depth (a nonzero
    shift).  The blocks sit in distinct 32x32 cells: PCM blocks of a
    picture never overlap, and the kernel writes them in no order."""
    rng = np.random.RandomState(60)
    B, Hp, Wp = 2, 64, 96
    cells = rng.permutation(B * (Hp // 32) * (Wp // 32))
    blocks = []
    for k in range(9):
        n = (8, 16, 32)[k % 3] >> (k % 2)     # 4..32
        cell = cells[k]
        b, y, x = cell // 6, cell % 6 // 3 * 32, cell % 3 * 32
        bits = (8, 5)[k % 2]
        blocks.append((0, b, x, y, n, n, 8 - bits,
                       rng.randint(0, 1 << bits, size=n * n)))
    stacked = jnp.zeros((B, Hp, Wp), jnp.int32)
    for _, b, x, y, w, h, shift, s in blocks:
        blk = np.asarray(s, np.int32).reshape(h, w) << shift
        stacked = stacked.at[b, y:y + h, x:x + w].set(jnp.asarray(blk))
    buf, counts = PS.pcm_pack(blocks)
    got, = PS.pcm_level([torch.zeros((B, Hp, Wp), dtype=torch.int32)],
                        PS.pcm_table(torch.from_numpy(buf), counts))
    assert np.asarray(stacked).any()
    _eq(stacked, got)
