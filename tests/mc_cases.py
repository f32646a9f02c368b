"""Seeded K6 block tables for the tiled MC kernel's checks.

`pu_maps` cuts pictures into PUs of 4x4 to 32x32 luma samples (with an
intra hole, integer horizontal MVs in some 4x4-PU blocks, MVs far past
every picture edge) so that a block table from `block_table` holds tiles
of every form csrc/mc.cu mc_weighted_luma_kernel takes; `kernel_form`
says which form the kernel takes for a run of grouped rows.  Imports
neither JAX nor the JAX package, so the GPU tests can use it.
"""
import numpy as np

FAR = 4 * 300                          # quarter-pels


def pu_maps(rng, B, R, HP, WP, sizes=(8, 4, 2, 1)):
    """Per-4x4 maps of B >= 2 luma pictures of HP x WP samples cut into
    PUs: each block of sizes[0] x sizes[0] 4x4 cells (HP and WP multiples
    of it, HP >= 64) is cut into square PUs of one of `sizes` (by default
    32x32 down to 4x4 samples; PUs of the smallest size have integer
    horizontal MVs in every other block, so that no cell there filters both
    ways; the first two blocks of picture 0 hold PUs of the smallest size
    and the third is one PU); one PU in eight is intra, and so is a 32x32 hole
    of picture 1; one MV component in ten points 300 samples past a
    picture edge; R references.  Returns (dirm, mv, sel, wpw, wpo, PU
    origin y, x), each per cell."""
    h4, w4, top = HP // 4, WP // 4, sizes[0]
    size = np.asarray(sizes)[rng.integers(0, len(sizes),
                                          (B, h4 // top, w4 // top))]
    size[0, 0, :3] = sizes[-1], sizes[-1], top
    size = np.repeat(np.repeat(size, top, 1), top, 2)
    cy, cx = np.mgrid[:h4, :w4]
    oy, ox = cy // size * size, cx // size * size
    bb = np.arange(B)[:, None, None]

    def per_pu(a):
        return a[bb, oy, ox]
    dirm = per_pu(np.where(rng.random((B, h4, w4)) < 0.125, 0,
                           rng.integers(1, 4, (B, h4, w4))))
    mv = rng.integers(-96, 97, (B, h4, w4, 2, 2))
    far = rng.random(mv.shape) < 0.1
    mv = per_pu(np.where(far, rng.choice([-FAR, FAR + 3], mv.shape), mv))
    whole = (size == sizes[-1]) & ((cy // top + cx // top) % 2 == 0)
    mv[..., 0] = np.where(whole[..., None], mv[..., 0] & ~7, mv[..., 0])
    dirm[1, 8:16, 0:8] = 0                # a hole for an off-grid block
    sel = per_pu(rng.integers(0, R, (B, h4, w4, 2)))
    wpw = per_pu(rng.integers(-128, 256, (B, h4, w4, 2)))
    wpo = per_pu(rng.integers(-128, 128, (B, h4, w4, 2)))
    return dirm, mv, sel, wpw, wpo, oy + 0 * bb, ox + 0 * bb


def block_table(maps, sx, sy, bd, order="raster", past=True):
    """The rows of every inter 4x4 (BLK_FIELDS), in raster order or PU by
    PU, and (past) one block off the cell grid, in pu_maps' hole, and
    three rows the kernel drops: a picture past the stack, blocks below and
    right of the padded plane."""
    dirm, mv, sel, wpw, wpo, oy, ox = maps
    B, h4, w4 = dirm.shape
    HP, WP = 4 * h4, 4 * w4
    b, ys4, xs4 = np.nonzero(dirm)
    if order == "pu":
        i = np.lexsort((xs4, ys4, ox[b, ys4, xs4], oy[b, ys4, xs4], b))
        b, ys4, xs4 = b[i], ys4[i], xs4[i]
    blk = np.stack([b, (xs4 << 2) >> sx, (ys4 << 2) >> sy, dirm[b, ys4, xs4]]
                   + list(mv[b, ys4, xs4].reshape(-1, 4).T)
                   + list(sel[b, ys4, xs4].T) + list(wpw[b, ys4, xs4].T)
                   + list((wpo[b, ys4, xs4] << (bd - 8)).T), 1)
    if past:
        extra = blk[:4].copy()
        extra[0, 0] = B
        extra[1, 2] = HP >> sy
        extra[2, 1] = (WP >> sx) + 4
        extra[3, :3] = 1, (8 >> sx) + 1, (40 >> sy) + 1
        blk = np.concatenate([blk, extra])
    return blk.astype(np.int32)


def kernel_form(run, wp):
    """The form csrc/mc.cu's luma kernel takes for one run of grouped rows
    (one chunk): 'a', 'b', 'c', or 'rows' (off the tile's cell grid)."""
    cw = ch = 4
    frac = 3
    q0 = run[0]
    ty0, tx0 = q0[2] >> 4 << 4, q0[1] >> 4 << 4
    cy, cx = run[:, 2] - ty0, run[:, 1] - tx0
    if not ((run[:, 0] == q0[0]) & (cy >= 0) & (cy < 16) & (cx >= 0) &
            (cx < 16) & (cy % ch == 0) & (cx % cw == 0)).all():
        return "rows"
    same, hv = run[:, 3] == q0[3], 0
    for l in range(2):
        used = (run[:, 3] == 3) | (run[:, 3] == 1 if l == 0 else
                                   run[:, 3] != 1)
        cols = [4 + 2 * l, 5 + 2 * l, 8 + l] + ([10 + l, 12 + l] if wp
                                                 else [])
        same &= ~used | (run[:, cols] == q0[cols]).all(1)
        hv = hv | (used & (run[:, 4 + 2 * l] & frac != 0) &
                   (run[:, 5 + 2 * l] & frac != 0))
    if same.all():
        return "a"
    return "b" if hv.sum() >= 4 else "c"
