"""K6's tile grouping and the forms of its luma kernel, on the CPU.

csrc/mc.cu mc_weighted_luma_kernel takes a block table grouped by
16x16-sample tile (ops/interp.py tile_groups) and picks a form per tile:
(a) one shared window a list when every row shares one PU, (b) one window
a cell and list, (c) direct prediction.  Chroma's kernel takes the rows in
any order.  Here:

- tile_groups orders the rows by (picture, tile, y, x) exactly as
  np.lexsort does, each row once, with one run per tile, for rows in
  raster order and in PU order, luma and chroma, on tensors and on numpy
  arrays alike (rows past the plane too);
- mc_weighted_plain (K6's plain version) on the grouped table equals JAX
  dag_decode._mc_scatter_fn on the rows in raster order, and on the rows
  shuffled (blocks do not overlap, so order cannot matter): luma, 4:2:0
  and 4:2:2 chroma, the plain and the weighted epilogues with denominators
  0, 3 and 7 at bit depths 8 and 10, on levels whose luma tiles take all
  three forms, tiles with intra holes, MVs 300 samples past every picture
  edge and rows past the plane;
- an emulation of the luma kernel's staged forms (the window copied with
  each coordinate clamped, junk where the kernel copies nothing, the
  horizontal pass, then the vertical one) equals per-sample prediction for
  16x16 tile windows and 4x4 cell windows at bit depths 8 to 12.

Inputs are numpy-seeded and shared by both sides; equality is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhm_tpu.parallel import dag_decode as JD
from libhm_tpu_torch.ops import interp as MK

from mc_cases import FAR, block_table, kernel_form, pu_maps
import torch_threads  # noqa: F401

B, R = 2, 3
HP, WP, H, W = 64, 96, 60, 88          # luma: padded plane, picture


GEOMS = [(True, 0, 0), (False, 1, 1), (False, 1, 0)]


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("order", ["raster", "pu"])
def test_tile_groups_runs_in_lexsort_order(order, kind):
    def group(blk, **kw):
        rows, groups = MK.tile_groups(
            blk if kind == "numpy" else torch.from_numpy(blk), **kw)
        assert isinstance(rows, np.ndarray) == (kind == "numpy")
        return np.asarray(rows), np.asarray(groups)
    rng = np.random.default_rng(21)
    maps = pu_maps(rng, B, R, HP, WP)
    for is_luma, sx, sy in GEOMS:
        blk = block_table(maps, sx, sy, 8, order, past=False)
        rows, groups = group(blk, B=B, Hp=HP >> sy, Wp=WP >> sx)
        b, x, y = blk[:, 0], blk[:, 1], blk[:, 2]
        np.testing.assert_array_equal(
            rows, blk[np.lexsort((x, y, x >> 4, y >> 4, b))])
        tile = np.stack([rows[:, 0], rows[:, 2] >> 4, rows[:, 1] >> 4], 1)
        new = np.r_[True, (tile[1:] != tile[:-1]).any(1)]
        assert groups.dtype == np.int32
        np.testing.assert_array_equal(groups[:-1], np.flatnonzero(new))
        assert groups[-1] == len(blk)
        if order == "pu":
            # the order the rows came in changes nothing
            again = group(block_table(maps, sx, sy, 8, past=False), B=B,
                          Hp=HP >> sy, Wp=WP >> sx)
            np.testing.assert_array_equal(again[0], rows)
    # rows past the plane come out once each, in the same runs either way
    blk = block_table(maps, 0, 0, 8)
    rows, groups = group(blk, B=B, Hp=HP, Wp=WP)
    np.testing.assert_array_equal(np.sort(rows, 0), np.sort(blk, 0))
    assert groups[-1] == len(blk)
    other = MK.tile_groups(torch.from_numpy(blk) if kind == "numpy" else blk,
                           B=B, Hp=HP, Wp=WP)
    np.testing.assert_array_equal(np.asarray(other[0]), rows)
    np.testing.assert_array_equal(np.asarray(other[1]), groups)
    empty = group(blk[:0], B=B, Hp=HP, Wp=WP)
    assert empty[0].shape == (0, blk.shape[1]) and list(empty[1]) == [0]


@pytest.mark.parametrize("geom,bd,epi", [
    (0, 8, "wp"), (0, 10, "plain"), (1, 10, "wp"), (1, 8, "plain"),
    (2, 8, "wp"), (2, 10, "plain")],
    ids=["luma8_wp", "luma10_plain", "chroma420_10_wp", "chroma420_8_plain",
         "chroma422_8_wp", "chroma422_10_plain"])
def test_mc_weighted_plain_on_tiles_equals_jax(geom, bd, epi):
    is_luma, sx, sy = GEOMS[geom]
    rng = np.random.default_rng(30 + bd + geom)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    hp, wp, h, w = HP >> sy, WP >> sx, H >> sy, W >> sx
    blkx, blky = 4 >> sx, 4 >> sy
    blk = block_table(pu_maps(rng, B, R, HP, WP), sx, sy, bd)
    for v, edge in ((blk[:, 4], -FAR), (blk[:, 4], FAR + 3),
                    (blk[:, 5], -FAR), (blk[:, 5], FAR + 3)):
        assert (v == edge).any()
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    stacked = rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)
    res = rng.integers(-(1 << bd) // 2, (1 << bd) // 2,
                       (B, hp, wp)).astype(np.int32)
    rows, groups = MK.tile_groups(torch.from_numpy(blk), B=B, Hp=hp, Wp=wp)
    if is_luma:
        g = groups.numpy()
        forms = {kernel_form(rows.numpy()[g[i]:g[i + 1]], epi == "wp")
                 for i in range(len(g) - 1)}
        assert {"a", "b", "c", "rows"} <= forms, forms
    fn = JD._mc_scatter_fn(blkx, blky, taps, fbx, fby, bd, epi)
    shuffled = torch.from_numpy(blk[rng.permutation(len(blk))])
    for denom in ((0, 3, 7) if epi == "wp" else (0,)):
        want = np.asarray(fn(
            jnp.asarray(stacked), jnp.asarray(res), jnp.asarray(refs),
            jnp.asarray(blk[:, 8]), jnp.asarray(blk[:, 9]),
            jnp.asarray(blk[:, 0]), jnp.asarray(blk[:, 1]),
            jnp.asarray(blk[:, 2]), jnp.asarray(blk[:, 4:8].reshape(-1, 2, 2)),
            jnp.asarray(blk[:, 3]), jnp.asarray(blk[:, 10:12]),
            jnp.asarray(blk[:, 12:14]), denom, w, h))
        assert (want != stacked).any()
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, wp=epi == "wp",
                  denom=denom, W=w, H=h)
        for table in (rows, shuffled):
            got = torch.from_numpy(stacked.copy())
            MK.mc_weighted(got, torch.from_numpy(res), torch.from_numpy(refs),
                           table, groups=groups, **kw)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=str(denom))


def staged(refs, sel, y0, x0, mvx, mvy, h, w, bd, rng):
    """csrc/mc.cu stage + horizontal + vertical for one luma list of one
    slot of h x w samples at (y0, x0): the window at the integer position
    less half, each coordinate clamped at the copy, junk where the kernel
    copies nothing (the apron of a direction whose fraction is 0); the
    horizontal pass to 14 bits (or the raw samples); the vertical pass with
    the four cases of predict."""
    _, hh, ww = refs.shape
    taps, half = 8, 3
    tab = np.asarray(MK.LUMA_FILTER)
    fx, fy = mvx & 3, mvy & 3
    iy = y0 + (mvy >> 2) - half + np.arange(h + taps - 1)
    ix = x0 + (mvx >> 2) - half + np.arange(w + taps - 1)
    win = refs[sel][np.clip(iy, 0, hh - 1)][:, np.clip(ix, 0, ww - 1)]
    win = win.astype(np.int64)
    junk = rng.integers(-1 << 20, 1 << 20, win.shape)
    if not fx:
        win[:, :half], win[:, half + w:] = junk[:, :half], junk[:, half + w:]
    if not fy:
        win[:half], win[half + h:] = junk[:half], junk[half + h:]
    headroom = max(2, MK.IF_PREC - bd)
    s1, o1 = 6 - headroom, -(MK.IF_OFFS << (6 - headroom))
    hor = ((sum(tab[fx][j] * win[:, j:j + w] for j in range(taps)) + o1)
           >> s1) if fx else win[:, half:half + w]
    if fy:
        acc = sum(tab[fy][j] * hor[j:j + h] for j in range(taps))
        return acc >> 6 if fx else (acc + o1) >> s1
    v = hor[half:half + h]
    return v if fx else (v << headroom) - MK.IF_OFFS


@pytest.mark.parametrize("bd", [8, 10, 11, 12])
def test_staged_windows_equal_direct_prediction(bd):
    rng = np.random.default_rng(40 + bd)
    taps, fbx, fby = MK._filter_args(True, 0, 0)
    h, w = H, W
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    cases = 0
    for sh, sw in ((16, 16), (4, 4)):                   # tile, cell
        for fx in range(1 << fbx):
            for fy in range(1 << fby):
                for far in (0, -FAR, FAR + 3):
                    y0 = int(rng.integers(0, h // sh)) * sh
                    x0 = int(rng.integers(0, w // sw)) * sw
                    mvx = int(rng.integers(-40, 40)) * (1 << fbx) + fx + \
                        far * (cases % 2)
                    mvy = int(rng.integers(-40, 40)) * (1 << fby) + fy + \
                        far * (1 - cases % 2)
                    sel = int(rng.integers(0, R))
                    got = staged(refs, sel, y0, x0, mvx, mvy, sh, sw, bd,
                                 rng)
                    ys, xs = np.mgrid[y0:y0 + sh, x0:x0 + sw]
                    n = ys.size
                    want = MK.predict(
                        torch.from_numpy(refs), torch.full((n,), sel),
                        torch.from_numpy(ys.ravel()),
                        torch.from_numpy(xs.ravel()),
                        torch.full((n,), mvx), torch.full((n,), mvy), 1, 1,
                        taps=taps, fbx=fbx, fby=fby, bd=bd)
                    np.testing.assert_array_equal(
                        got, want.numpy().reshape(sh, sw),
                        err_msg=f"{sh}x{sw} mv {mvx},{mvy}")
                    cases += 1
    assert cases == 2 * 3 * (1 << fbx) * (1 << fby)


def test_decode_lists_luma_blocks_in_tile_order():
    """dag_decode._tile_nonzero lists each inter 4x4 once, tile by tile, so
    tile_groups finds the decode's luma rows already in order."""
    from libhm_tpu_torch.parallel.dag_decode import _tile_nonzero
    rng = np.random.default_rng(50)
    for h4, w4 in ((15, 26), (270, 480), (7, 5)):
        mask = rng.random((B, h4, w4)) < 0.4
        ys4, xs4 = zip(*(_tile_nonzero(m) for m in mask))
        for b in range(B):
            np.testing.assert_array_equal(
                np.sort(ys4[b] * w4 + xs4[b]),
                np.flatnonzero(mask[b].ravel()))
        blk = np.zeros((sum(map(len, ys4)), len(MK.BLK_FIELDS)), np.int32)
        blk[:, 0] = np.repeat(np.arange(B), list(map(len, ys4)))
        blk[:, 1], blk[:, 2] = np.concatenate(xs4) * 4, np.concatenate(ys4) * 4
        rows, _ = MK.tile_groups(blk, B=B, Hp=h4 * 4, Wp=w4 * 4)
        np.testing.assert_array_equal(rows, blk)
