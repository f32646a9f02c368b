"""The flat intra wavefront (K2's table and plain version) and the restore
of unfiltered samples (K8's plain version) on the CPU.

- the flat block table (batch_decode.intra_table): sorted by level, every
  producer of an available border sample at a lower level, the level
  counts summing to the component's intra blocks, and exactly the real
  slots of prepare_component;
- intra_wavefront_plain equals the JAX batched scan
  (`_scan_fn_batched(res_gather=True)`, through the JAX `_intra_batch`)
  bit for bit: a two-picture batch, 4:2:2 chroma (mode map), constrained
  intra, implicit RDPCM, and lossless CUs (the dbf flag);
- restore_unfiltered_plain equals the JAX restore formula (jnp.where on
  the clamped luma-grid indices) at 4:2:0, 4:2:2 and 4:4:4 on planes
  padded past 4 * h4, so the clamp acts.

Integer arithmetic throughout: exact equality (tolerance 0).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu_torch.ops import intra as TI
from libhm_tpu_torch.ops import pcm as PK
from libhm_tpu_torch.parallel import batch_decode as TB
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))

# (stream, pictures in decode order, component)
CASES = {"batch2": ("intra_main10_416x240", (0, 1), 0),
         "chroma422": ("rext422_intra_416x240", (0, 1), 1),
         "constrained": ("cip_ra_160x96", (0, 2), 0),
         "implicit_rdpcm": ("mixed_lossless_rdpcm_160x96", (0, 1), 0),
         "lossless": ("lossless_intra_416x240", (0,), 0)}


def _items(name, pics, jax_too=False):
    """The port's (and the JAX package's) collect items of `pics`."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = [dec.collected[i] for i in pics]
    if not jax_too:
        return items
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    dec_j = JaxDecoder(parse="native", recon="collect")
    dec_j.decode_annexb(data)
    return items, [dec_j.collected[i] for i in pics]


def _geometry(sps, comp):
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    Hp = (sps.pic_height_ctbs << sps.log2_ctb) >> sy
    Wp = (sps.pic_width_ctbs << sps.log2_ctb) >> sx
    bd = sps.bit_depth_chroma if comp else sps.bit_depth_luma
    return sps.width >> sx, sps.height >> sy, Hp, Wp, bd


@pytest.mark.parametrize("case", ["batch2", "chroma422", "constrained"])
def test_flat_table(case):
    from libhm_tpu_torch.parallel.intra_wavefront import prepare_component
    name, pics, comp = CASES[case]
    items = _items(name, pics)
    W, H, _, _, _ = _geometry(items[0]["sps"], comp)
    rows, count = TB.intra_table(items, comp)
    level = rows["level"]
    log2n = rows["nf"] & 15
    # sorted by level, dense, with the level counts of the rows
    assert (np.diff(level) >= 0).all()
    assert (count > 0).all() and count.sum() == len(rows)
    assert (np.bincount(level) == count).all()
    assert len(rows) == sum(1 for it in items for blk in it["pic"].intra_list
                            if blk.comp == comp)
    # exactly the real slots of prepare_component, none lost or duplicated
    want, levels_seen = [], []
    for b, it in enumerate(items):
        lv, _ = prepare_component(it["sps"], it["pic"], it["zmap"],
                                  it["tile_map"], comp, None,
                                  bool(it["pps"].constrained_intra_pred))
        for n, d in lv.items():
            for li, ki in zip(*np.nonzero(d["xs"] < W)):
                av = np.zeros(TI.AV_BYTES, np.uint8)
                av[:d["av"].shape[2]] = d["av"][li, ki]
                want.append((b, int(d["xs"][li, ki]), int(d["ys"][li, ki]),
                             n, int(d["mode"][li, ki]),
                             int(d["flags"][li, ki]), int(li), av.tobytes()))
                levels_seen.append(int(li))
    dense = {li: k for k, li in enumerate(sorted(set(levels_seen)))}
    want = sorted(w[:6] + (dense[w[6]],) + w[7:] for w in want)
    got = sorted((int(r["b"]), int(r["x"]), int(r["y"]), 1 << int(r["nf"] & 15),
                  int(r["mode"]), int(r["nf"] >> 4), int(r["level"]),
                  r["av"].tobytes()) for r in rows)
    assert got == want and len(set(got)) == len(got)
    # every available border sample comes from a block of a lower level
    # (or from before the wavefront: MC, outside every intra block)
    for b in range(len(items)):
        owner = np.full((H, W), -1, np.int64)
        sel = np.nonzero(rows["b"] == b)[0]
        for i in sel:
            n = 1 << int(log2n[i])
            x, y = int(rows["x"][i]), int(rows["y"][i])
            owner[y:y + n, x:x + n] = level[i]
        for i in sel:
            n = 1 << int(log2n[i])
            offx, offy = TI._border_offsets(n)
            bits = np.unpackbits(rows["av"][i], bitorder="little")[:4 * n + 1]
            av = bits != 0
            cx = int(rows["x"][i]) + offx[av]
            cy = int(rows["y"][i]) + offy[av]
            assert ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)).all()
            assert (owner[cy, cx] < level[i]).all(), (b, i)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_plain_equals_jax_scan(case):
    """intra_wavefront_plain from seeded planes and residuals equals the
    JAX `_intra_batch` with device residual planes (one vmapped lax.scan
    of `_scan_fn_batched(res_gather=True)` over the same pictures)."""
    from libhm_tpu.parallel.batch_decode import _intra_batch
    name, pics, comp = CASES[case]
    items, items_j = _items(name, pics, jax_too=True)
    W, H, Hp, Wp, bd = _geometry(items[0]["sps"], comp)
    rng = np.random.default_rng(sum(map(ord, case)))
    shape = (len(pics), Hp, Wp)
    base = rng.integers(0, 1 << bd, shape).astype(np.int32)
    res = rng.integers(-64, 65, shape).astype(np.int32)
    table = TB.intra_meta(items, comp, torch.device("cpu"))
    if case == "lossless":
        rows = TI.block_rows(table)
        assert ((rows["nf"] >> 4) & 4).any()          # dbf set somewhere
    got = TI.intra_wavefront(torch.from_numpy(base.copy()),
                             torch.from_numpy(res), table,
                             is_luma=comp == 0, bd=bd, W=W, H=H)
    want = _intra_batch(items_j, comp, None, None, stacked=jnp.asarray(base),
                        res_stacked=jnp.asarray(res))
    want = np.asarray(want)
    assert not np.array_equal(want, base)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())


@pytest.mark.parametrize("sx,sy", [(1, 1), (1, 0), (0, 0)])
def test_restore_plain_equals_jax_formula(sx, sy):
    """The planes reach past the mask grid (4 * h4 rows, 4 * w4 columns of
    luma) by 12 and 20 samples, so their last rows and columns read the
    clamped last mask row and column."""
    rng = np.random.default_rng(7 + 2 * sx + sy)
    B, h4, w4 = 2, 9, 11
    Hp, Wp = (4 * h4 + 12) >> sy, (4 * w4 + 20) >> sx
    rmask = (rng.random((B, h4, w4)) < 0.3).astype(np.uint8)
    rmask[:, -1, :] = 1                        # the clamped row is set
    planes = rng.integers(0, 1024, (B, Hp, Wp)).astype(np.int32)
    pre = rng.integers(0, 1024, (B, Hp, Wp)).astype(np.int32)
    got = PK.restore_unfiltered(torch.from_numpy(planes.copy()),
                                torch.from_numpy(pre),
                                torch.from_numpy(rmask), sx=sx, sy=sy)
    # libhm_tpu/parallel/device_filters.py _filter_fn, restore branch
    ysi = jnp.minimum((jnp.arange(Hp) << sy) >> 2, h4 - 1)
    xsi = jnp.minimum((jnp.arange(Wp) << sx) >> 2, w4 - 1)
    want = [np.asarray(jnp.where(jnp.asarray(rmask[b])[ysi[:, None],
                                                       xsi[None, :]] != 0,
                                 pre[b], planes[b])) for b in range(B)]
    want = np.stack(want)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want[:, -1], planes[:, -1])  # clamp exercised
