"""Port parity: libhm_tpu_torch.ops.intra vs libhm_tpu.ops.intra.

substitute, filter_refs and predict over all 35 modes x 4 sizes, luma and
chroma, on numpy-seeded borders; the wavefront metadata unpack on real
levels.  Integer arithmetic throughout: exact equality (tolerance 0).
One jitted JAX program per function and case.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import intra as JI
from libhm_tpu_torch.ops import intra as TI
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    assert (a == b).all(), int((a != b).sum())


def _borders(rng, B, n, bd):
    """Smooth-ish border rows (so the strong-filter test fires) with
    random availability, including fully unavailable rows."""
    T = 4 * n + 1
    base = rng.randint(0, 1 << bd, size=(B, 1))
    ramp = np.cumsum(rng.randint(-2, 3, size=(B, T)), axis=1)
    g = np.clip(base + ramp, 0, (1 << bd) - 1).astype(np.int32)
    noisy = rng.rand(B) < 0.3
    g[noisy] = rng.randint(0, 1 << bd, size=(int(noisy.sum()), T))
    avail = rng.rand(B, T) < 0.7
    avail[::7] = False
    avail[1::9] = True
    return g, avail


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("luma", [True, False])
def test_substitute_filter_predict(n, luma):
    bd = 10
    rng = np.random.RandomState(n + 100 * luma)
    B = 35 * 4
    g, avail = _borders(rng, B, n, bd)
    mode = np.tile(np.arange(35, dtype=np.int32), 4)
    filt = rng.rand(B) < 0.6
    strong = np.full(B, luma and n == 32)
    dbf = rng.rand(B) < 0.3

    vals_j = jax.jit(functools.partial(JI.substitute, bit_depth=bd))(
        jnp.asarray(g), jnp.asarray(avail))
    vals_t = TI.substitute(torch.from_numpy(g), torch.from_numpy(avail), bd)
    _eq(vals_j, vals_t)

    f_j = jax.jit(functools.partial(JI.filter_refs, n=n, bit_depth=bd))(
        vals_j, filter_flag=jnp.asarray(filt), strong_flag=jnp.asarray(strong))
    f_t = TI.filter_refs(vals_t, n, bd, torch.from_numpy(filt),
                         torch.from_numpy(strong))
    _eq(f_j, f_t)

    p_j = jax.jit(functools.partial(JI.predict, n=n, comp_is_luma=luma,
                                    bit_depth=bd))(
        f_j, jnp.asarray(mode), disable_bf=jnp.asarray(dbf))
    p_t = TI.predict(f_t, torch.from_numpy(mode), n, luma, bd,
                     torch.from_numpy(dbf))
    _eq(p_j, p_t)


@pytest.mark.parametrize("n", [4, 32])
def test_border_coords(n):
    rng = np.random.RandomState(n)
    x = rng.randint(0, 400, size=11).astype(np.int32)
    y = rng.randint(0, 230, size=11).astype(np.int32)
    cx_j, cy_j = JI.border_coords(jnp.asarray(x), jnp.asarray(y), n, 416, 240)
    cx_t, cy_t = TI.border_coords(torch.from_numpy(x), torch.from_numpy(y),
                                  n, 416, 240)
    _eq(cx_j, cx_t)
    _eq(cy_j, cy_t)


def test_unpack_block_meta():
    """The port's unpack of the compact slot layout equals the JAX one on
    real prepare_component output of a Main10 picture."""
    from libhm_tpu.hostdec.decoder import Decoder
    from libhm_tpu.parallel.intra_wavefront import (
        prepare_component, unpack_block_meta as j_unpack)
    from libhm_tpu_torch.parallel import intra_wavefront as TW
    name = "intra_main10_416x240"
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    it = dec.collected[0]
    levels, L = prepare_component(it["sps"], it["pic"], it["zmap"],
                                  it["tile_map"], 0, None, False)
    levels_t, L_t = TW.prepare_component(it["sps"], it["pic"], it["zmap"],
                                         it["tile_map"], 0, None, False)
    assert L == L_t
    for n in (4, 16):
        for k in levels[n]:
            assert (levels[n][k] == levels_t[n][k]).all()
        want = j_unpack({k: jnp.asarray(v) for k, v in levels[n].items()}, n)
        got = TW.unpack_block_meta(
            {k: torch.from_numpy(v) for k, v in levels_t[n].items()}, n)
        for a, b in zip(want, got):
            _eq(a, b)


@pytest.mark.parametrize("name,comp", [("intra_main10_416x240", 0),
                                       ("rext422_intra_416x240", 1)])
def test_intra_level_plain_equals_jax_scan(name, comp):
    """intra_level_plain (K2's yardstick), run for every block size of a
    level as the port's decode runs it, equals one level of the JAX
    batched scan (`_scan_fn_batched`, residuals gathered from a plane)
    after every level of a real picture, levels with no block of a size
    included: a Main10 luma plane and a 4:2:2 chroma plane."""
    from libhm_tpu.hostdec.decoder import Decoder
    from libhm_tpu.parallel.batch_decode import _scan_fn_batched
    from libhm_tpu.parallel.intra_wavefront import prepare_component
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    it = dec.collected[0]
    sps = it["sps"]
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    W, H = sps.width >> sx, sps.height >> sy
    bd = sps.bit_depth_chroma if comp else sps.bit_depth_luma
    levels, L = prepare_component(sps, it["pic"], it["zmap"], it["tile_map"],
                                  comp, None, False)
    sizes = tuple(sorted(levels))
    keys = ("xs", "ys", "mode", "flags", "av")
    shape = (1, (sps.pic_height_ctbs << sps.log2_ctb) >> sy,
             (sps.pic_width_ctbs << sps.log2_ctb) >> sx)
    rng = np.random.default_rng(11 + comp)
    base = rng.integers(0, 1 << bd, shape).astype(np.int32)
    res = rng.integers(-64, 65, shape).astype(np.int32)
    scan = _scan_fn_batched(sizes, comp == 0, bd, W, H, res_gather=True)
    res_j = jnp.asarray(res)
    want = jnp.asarray(base)
    got, res_t = torch.from_numpy(base.copy()), torch.from_numpy(res)
    meta = {n: {k: torch.from_numpy(levels[n][k][None]) for k in keys}
            for n in sizes}
    for level in range(L):
        one = {n: {k: jnp.asarray(levels[n][k][None, level:level + 1])
                   for k in keys} for n in sizes}
        want = scan(want, res_j, one)
        for n in sizes:
            TI.intra_level_plain(got, res_t, meta[n], level, n=n,
                                 is_luma=comp == 0, bd=bd, W=W, H=H)
        _eq(want, got)
