"""K5's plain version against the JAX grid MC on the tile kinds that the
tiled kernel (csrc/mc.cu mc_grid_kernel) treats apart, on the CPU.

mc_grid_plain == libhm_tpu/parallel/dag_decode.py _mc_phase_grid_fn
(build + fn) on per-4x4 maps holding 16x16 tiles with no inter cell,
tiles whose inter cells all share one PU's direction, MVs and references
(the kernel's one-window path), tiles with one MV a cell, and MVs that
reach far past all four picture edges (each tap's coordinate clamped),
for luma and for 4:2:0 and 4:2:2 chroma.  Inputs are numpy-seeded and
shared by both sides; equality is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhm_tpu.parallel import dag_decode as JD
from libhm_tpu_torch.ops import interp as MK
import torch_threads  # noqa: F401

B, R = 2, 3
HP, WP, H, W = 64, 96, 56, 88          # luma: padded plane, picture


def tile_maps(rng):
    """Per-4x4 maps [B, HP/4, WP/4] with every kind of 16x16 tile."""
    h4, w4 = HP // 4, WP // 4
    mv = rng.integers(-96, 97, (B, h4, w4, 2, 2))
    dirm = rng.integers(0, 4, (B, h4, w4))
    sel = rng.integers(0, R, (B, h4, w4, 2))
    dirm[0, 0:4, 4:8] = 0                               # no inter cell
    far = 4 * 300                                       # quarter-pels
    mv[1, 0:2, :, :, 1] = -far                          # above the top
    mv[1, -2:, 4:, :, 1] = far                          # below the bottom
    mv[0, :, 0:2, :, 0] = -far                          # left of the left
    mv[0, :, -2:, :, 0] = far + 3                       # right of the right
    for b, ys, xs, d in ((0, slice(0, 4), slice(0, 4), 3),
                         (1, slice(4, 12), slice(8, 16), 1),
                         (0, slice(8, 12), slice(16, 20), 2)):
        mv[b, ys, xs] = mv[b, ys.start, xs.start]       # one PU per tile
        sel[b, ys, xs] = sel[b, ys.start, xs.start]
        dirm[b, ys, xs] = d
    dirm[1, 12:16, 0:4] = np.where(np.arange(4)[:, None] == 1, 0, 3)
    mv[1, 12:16, 0:4] = mv[1, 12, 0]                    # shared, one gap
    sel[1, 12:16, 0:4] = sel[1, 12, 0]
    return mv, dirm, sel


@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (False, 10, 1, 1),
                                              (False, 12, 1, 0)],
                         ids=["luma8", "chroma420_10", "chroma422_12"])
def test_mc_grid_plain_equals_jax_on_tiles(is_luma, bd, sx, sy):
    rng = np.random.default_rng(50 + bd)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    hp, wp, h, w = HP >> sy, WP >> sx, H >> sy, W >> sx
    mv, dirm, sel = (a.astype(t) for a, t in zip(
        tile_maps(rng), (np.int16, np.int8, np.int16)))
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    stacked = rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)
    res = rng.integers(-(1 << bd) // 2, (1 << bd) // 2,
                       (B, hp, wp)).astype(np.int32)
    build, fn = JD._mc_phase_grid_fn(sx, sy, taps, fbx, fby, bd, HP // 4,
                                     WP // 4, w, h)
    want = np.asarray(fn(jnp.asarray(stacked), jnp.asarray(res),
                         build(jnp.asarray(refs)), jnp.asarray(mv),
                         jnp.asarray(dirm), jnp.asarray(sel)))
    got = MK.mc_grid_plain(torch.from_numpy(stacked.copy()),
                           torch.from_numpy(res), torch.from_numpy(refs),
                           torch.from_numpy(mv), torch.from_numpy(dirm),
                           torch.from_numpy(sel), is_luma=is_luma, sx=sx,
                           sy=sy, bd=bd, W=w, H=h)
    np.testing.assert_array_equal(got.numpy(), want)
    # the no-inter tile is untouched, the shared-MV tiles are predicted
    cy, cx = 16 >> sy, 16 >> sx
    assert (want[0, :cy, cx:2 * cx] == stacked[0, :cy, cx:2 * cx]).all()
    assert (want[0, :cy, :cx] != stacked[0, :cy, :cx]).any()
