"""The port's plain MC functions against the JAX package, on the CPU.

- mc_grid_plain (K5's plain version) == dag_decode._mc_phase_grid_fn's
  build + fn, for luma at 8 and 10 bits and for 4:2:0 chroma, with MVs
  large enough that taps fall beyond the phase planes' MC_MARGIN apron;
- mc_weighted_plain (K6's plain version) == dag_decode._mc_scatter_fn with
  the weighted ("wp") and the default ("plain") epilogue, over every
  denominator, with negative weights and offsets;
- plane_checksum_plain (K7's plain version) == the numpy uint32 sum.

Inputs are numpy-seeded and shared by both sides; equality is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhm_tpu.parallel import dag_decode as JD
from libhm_tpu_torch.ops import checksum as CK
from libhm_tpu_torch.ops import interp as MK

B, R = 2, 3
HP = WP = 64                 # padded luma plane
H, W = 48, 64                # luma picture size
H4, W4 = HP // 4, WP // 4

# (is_luma, bd, sx, sy)
CASES = [(True, 8, 0, 0), (True, 10, 0, 0), (False, 8, 1, 1),
         (False, 10, 1, 1)]
IDS = ["luma8", "luma10", "chroma420_8", "chroma420_10"]


def _geometry(is_luma, sx, sy):
    taps = 8 if is_luma else 4
    return taps, 2 + sx, 2 + sy, HP >> sy, WP >> sx, H >> sy, W >> sx


def _planes(rng, bd, hp, wp, h, w):
    refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
    stacked = rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)
    res = rng.integers(-(1 << bd) // 2, (1 << bd) // 2,
                       (B, hp, wp)).astype(np.int32)
    return refs, stacked, res


@pytest.mark.parametrize("is_luma,bd,sx,sy", CASES, ids=IDS)
def test_mc_grid_plain_equals_phase_grid(is_luma, bd, sx, sy):
    rng = np.random.default_rng(7 + bd + sx)
    taps, fbx, fby, hp, wp, h, w = _geometry(is_luma, sx, sy)
    refs, stacked, res = _planes(rng, bd, hp, wp, h, w)
    # +-200 quarter-pels reach 50 luma samples past the edge: far beyond
    # the MC_MARGIN (8) apron of the phase planes
    mv = rng.integers(-200, 201, (B, H4, W4, 2, 2)).astype(np.int16)
    dirm = rng.integers(0, 4, (B, H4, W4)).astype(np.int8)
    sel = rng.integers(0, R, (B, H4, W4, 2)).astype(np.int16)
    assert set(np.unique(dirm)) == {0, 1, 2, 3}
    assert set(np.unique(mv & ((1 << fbx) - 1))) == set(range(1 << fbx))
    assert np.abs(mv).max() >> fbx > 8 + taps

    build, fn = JD._mc_phase_grid_fn(sx, sy, taps, fbx, fby, bd, H4, W4, w,
                                     h)
    want = np.asarray(fn(jnp.asarray(stacked), jnp.asarray(res),
                         build(jnp.asarray(refs)), jnp.asarray(mv),
                         jnp.asarray(dirm), jnp.asarray(sel)))
    got = torch.from_numpy(stacked.copy())
    out = MK.mc_grid(got, torch.from_numpy(res), torch.from_numpy(refs),
                     torch.from_numpy(mv), torch.from_numpy(dirm),
                     torch.from_numpy(sel), is_luma=is_luma, sx=sx, sy=sy,
                     bd=bd, W=w, H=h)
    assert out is got                                   # in place
    np.testing.assert_array_equal(got.numpy(), want)
    # non-inter samples are untouched
    assert (got.numpy() != stacked).any()


@pytest.mark.parametrize("epi", ["wp", "plain"])
@pytest.mark.parametrize("is_luma,bd,sx,sy", CASES, ids=IDS)
def test_mc_weighted_plain_equals_scatter(is_luma, bd, sx, sy, epi):
    rng = np.random.default_rng(11 + bd + sx + (epi == "wp"))
    taps, fbx, fby, hp, wp, h, w = _geometry(is_luma, sx, sy)
    refs, stacked, res = _planes(rng, bd, hp, wp, h, w)
    blkx, blky = 4 >> sx, 4 >> sy
    N = 96
    cell = rng.choice(B * H4 * W4, N, replace=False)
    bidx = (cell // (H4 * W4)).astype(np.int32)
    by = (((cell // W4) % H4) << 2 >> sy).astype(np.int32)
    bx = ((cell % W4) << 2 >> sx).astype(np.int32)
    mv = rng.integers(-200, 201, (N, 2, 2)).astype(np.int32)
    dirm = rng.integers(1, 4, N).astype(np.int32)
    sel = rng.integers(0, R, (N, 2)).astype(np.int32)
    wpw = rng.integers(-128, 256, (N, 2)).astype(np.int32)
    wpo = (rng.integers(-128, 128, (N, 2)) << (bd - 8)).astype(np.int32)
    assert (wpw < 0).any() and (wpo < 0).any()
    blk = np.stack([bidx, bx, by, dirm, mv[:, 0, 0], mv[:, 0, 1],
                    mv[:, 1, 0], mv[:, 1, 1], sel[:, 0], sel[:, 1],
                    wpw[:, 0], wpw[:, 1], wpo[:, 0], wpo[:, 1]], 1)
    assert blk.shape[1] == len(MK.BLK_FIELDS)
    fn = JD._mc_scatter_fn(blkx, blky, taps, fbx, fby, bd, epi)
    for denom in (range(8) if epi == "wp" else [0]):
        want = np.asarray(fn(
            jnp.asarray(stacked), jnp.asarray(res), jnp.asarray(refs),
            jnp.asarray(sel[:, 0]), jnp.asarray(sel[:, 1]),
            jnp.asarray(bidx), jnp.asarray(bx), jnp.asarray(by),
            jnp.asarray(mv), jnp.asarray(dirm), jnp.asarray(wpw),
            jnp.asarray(wpo), denom, w, h))
        got = torch.from_numpy(stacked.copy())
        MK.mc_weighted(got, torch.from_numpy(res), torch.from_numpy(refs),
                       torch.from_numpy(blk), is_luma=is_luma, sx=sx, sy=sy,
                       bd=bd, wp=epi == "wp", denom=denom, W=w, H=h)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(denom))


def test_plane_checksum_plain_wraps_and_crops():
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 4096, (3, 72, 96)).astype(np.int32)
              for _ in range(4)]
    views = [torch.from_numpy(p)[b, 2:70, 4:90]
             for p in planes for b in range(3)]
    assert not views[0].is_contiguous()
    want = sum(int(v.numpy().astype(np.uint64).sum()) for v in views)
    # three full 4095-valued megapixel planes push the sum past 2^32
    big = torch.full((1024, 1024), 4095, dtype=torch.int32)
    views += [big] * 3
    want += 3 * 4095 * 1024 * 1024
    got = CK.plane_checksum(views)
    assert got.shape == (1,) and got.device.type == "cpu"
    assert int(got.item()) == (want & 0xFFFFFFFF)
    assert want > 1 << 32
