"""The flat intra wavefront (K2's table and plain version) and the restore
of unfiltered samples (K8's plain version) on the CPU.

- the flat block table (batch_decode.intra_table): sorted by (picture,
  CTU row, level), every producer of an available border sample at a
  lower level, the work units covering the component's intra blocks, and
  exactly the real slots of prepare_component;
- what K2's one-CTA-a-CTU-row design relies on, on eight streams (tiles,
  slices, 4:2:2, 4:4:4, 12 bits, constrained intra, a 64x64 picture) and
  each component: every available border sample was produced in the
  block's own CTU row at a lower level or, for an F_CROSS block's top row
  and corner, in the row above at a lower level, or before the wavefront,
  never in the row below; the row starts, F_CROSS and the rows / steps /
  cross_steps counts and the chunk marks agree with the table; and a
  row-after-row walk (what one CTA does) equals the level-after-level
  plain version;
- intra_wavefront_plain equals the JAX batched scan
  (`_scan_fn_batched(res_gather=True)`, through the JAX `_intra_batch`)
  bit for bit: a two-picture batch, 4:2:2 chroma (mode map), constrained
  intra, implicit RDPCM, and lossless CUs (the dbf flag);
- restore_unfiltered_plain equals the JAX restore formula (jnp.where on
  the clamped luma-grid indices) at 4:2:0, 4:2:2 and 4:4:4 on planes
  padded past 4 * h4, so the clamp acts.

Integer arithmetic throughout: exact equality (tolerance 0).
"""
import functools
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
    rows, row_start, _, _ = TB.intra_table(items, comp)
    level = rows["level"]
    log2n = rows["nf"] & 15
    # sorted by (picture, CTU row, level), the levels dense over the table
    log2h = items[0]["sps"].log2_ctb - (
        items[0]["sps"].chroma_shift_y() if comp else 0)
    key = np.stack([rows["b"], rows["y"] >> log2h, level], axis=1)
    assert (np.lexsort(key.T[::-1]) == np.arange(len(rows))).all()
    assert (np.unique(level) == np.arange(level.max() + 1)).all()
    assert row_start[0] == 0 and row_start[-1] == len(rows)
    assert (np.diff(row_start) > 0).all()
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
                  int(r["mode"]), int(r["nf"] >> 4) & ~TI.F_CROSS,
                  int(r["level"]), r["av"].tobytes()) for r in rows)
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


# K2's row units on every picture of these streams, each component
ROW_STREAMS = ("intra_main10_416x240", "tiles_832x480", "slices_416x240",
               "rext422_intra_416x240", "intra_rext444_416x240",
               "main12_intra_416x240", "cip_ra_160x96", "intra_64x64")


@functools.lru_cache(maxsize=None)
def _stream_items(name):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    return dec.collected


@pytest.mark.parametrize("comp", [0, 1, 2])
@pytest.mark.parametrize("name", ROW_STREAMS)
def test_row_units(name, comp):
    """The invariant of one CTA a CTU row (csrc/intra.cu): a block reads
    only its own CTU row and, through its top row and corner, the row
    above; what it reads there was made at a lower level; F_CROSS marks
    exactly the top-edge blocks whose row above is a unit of the launch,
    the unit just before theirs; and the table's work counts."""
    items = _stream_items(name)
    sps = items[0]["sps"]
    W, H, _, _, _ = _geometry(sps, comp)
    rows, row_start, log2h, work = TB.intra_table(items, comp)
    assert log2h == sps.log2_ctb - (sps.chroma_shift_y() if comp else 0)
    b, x, y = (rows[k].astype(np.int64) for k in ("b", "x", "y"))
    level = rows["level"].astype(np.int64)
    log2n = (rows["nf"] & 15).astype(np.int64)
    cross = ((rows["nf"] >> 4) & TI.F_CROSS) != 0
    crow = y >> log2h
    # one unit per (picture, CTU row), in that order, levels rising inside
    U = len(row_start) - 1
    unit = np.repeat(np.arange(U), np.diff(row_start))
    ukey = [(int(b[s]), int(crow[s])) for s in row_start[:-1]]
    assert ukey == sorted(set(ukey))
    for u in range(U):
        sl = slice(row_start[u], row_start[u + 1])
        assert (b[sl] == ukey[u][0]).all() and (crow[sl] == ukey[u][1]).all()
        assert (np.diff(level[sl]) >= 0).all()
    # F_CROSS: a top-edge block whose row above is the unit before
    above = np.array([u > 0 and ukey[u - 1] == (ukey[u][0], ukey[u][1] - 1)
                      for u in range(U)], bool)
    assert (cross == (((y & ((1 << log2h) - 1)) == 0) & above[unit])).all()
    # the counts, from the (unit, level) pairs
    steps = set(zip(unit.tolist(), level.tolist()))
    xsteps = set(zip(unit[cross].tolist(), level[cross].tolist()))
    assert work == {"rows": U, "steps": len(steps),
                    "cross_steps": len(xsteps)}
    assert 0 < work["steps"] <= len(rows)
    # chunks: consecutive blocks of one step, at most CHUNK_BLOCKS and
    # CHUNK_SAMPLES, covering every row once
    heads = np.flatnonzero(rows["chunk"])
    nb = rows["chunk"][heads].astype(np.int64)
    assert heads[0] == 0 and (heads + nb == np.r_[heads[1:], len(rows)]).all()
    assert (nb <= TI.CHUNK_BLOCKS).all()
    size = 1 << (2 * log2n)
    for h, k in zip(heads, nb):
        assert size[h:h + k].sum() <= TI.CHUNK_SAMPLES
        assert len(set(zip(unit[h:h + k], level[h:h + k]))) == 1
    assert len(heads) >= len(steps)
    # every available border sample: its producer's level and CTU row
    for p in np.unique(b):
        owner = np.full((H, W), -1, np.int64)
        sel = np.flatnonzero(b == p)
        for i in sel:
            n = 1 << int(log2n[i])
            owner[y[i]:y[i] + n, x[i]:x[i] + n] = level[i]
        for i in sel:
            n = 1 << int(log2n[i])
            offx, offy = TI._border_offsets(n)
            av = np.unpackbits(rows["av"][i], bitorder="little")[:4 * n + 1]
            t = np.flatnonzero(av)
            cx, cy = x[i] + offx[t], y[i] + offy[t]
            assert ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)).all()
            srow = cy >> log2h
            # never the row below, never two rows up
            assert ((srow == crow[i]) | (srow == crow[i] - 1)).all(), i
            up = srow < crow[i]
            # the row above: only the top row and corner of a top-edge block
            assert (t[up] >= 2 * n).all() and (not up.any() or
                                               y[i] % (1 << log2h) == 0)
            made = owner[cy, cx]
            assert (made < level[i]).all(), i
            # made by another CTA in this launch: the block waits (F_CROSS)
            assert cross[i] or not (up & (made >= 0)).any(), i


@pytest.mark.parametrize("name,comp", [("cip_ra_160x96", 0),
                                       ("slices_416x240", 1),
                                       ("intra_64x64", 0)])
def test_row_walk_equals_level_walk(name, comp):
    """Reconstructing unit after unit, each unit level by level (one CTA
    doing every row, `_ctas=1`), gives the plain version's planes; and
    intra_wavefront adds the table's work, its blocks, no plane blocks
    (the CPU has no lattice), its pictures' chain terms and its one
    component to TI.WORK."""
    items = _stream_items(name)
    sps = items[0]["sps"]
    W, H, Hp, Wp, bd = _geometry(sps, comp)
    rng = np.random.default_rng(len(name) + comp)
    shape = (len(items), Hp, Wp)
    base = rng.integers(0, 1 << bd, shape).astype(np.int32)
    res = torch.from_numpy(rng.integers(-64, 65, shape).astype(np.int32))
    table = TB.intra_meta(items, comp, torch.device("cpu"))
    before = dict(TI.WORK)
    want = TI.intra_wavefront(torch.from_numpy(base.copy()), res, table,
                              is_luma=comp == 0, bd=bd, W=W, H=H)
    assert {k: TI.WORK[k] - before[k] for k in before} == {
        **table["work"], "blocks": len(table["rows"]), "plane_blocks": 0,
        "levels": sum(L for L, _ in table["chain"]),
        "handovers": sum(R for _, R in table["chain"]), "components": 1}
    rows = TI.block_rows(table)
    got = torch.from_numpy(base.copy())
    starts = table["row_start"].tolist()
    for u in range(len(starts) - 1):
        unit = rows[starts[u]:starts[u + 1]]
        for lv in np.split(unit, np.flatnonzero(np.diff(unit["level"])) + 1):
            sub = {"blocks": torch.from_numpy(
                np.ascontiguousarray(lv).view(np.uint8).reshape(len(lv), -1))}
            TI.intra_wavefront_plain(got, res, sub, is_luma=comp == 0,
                                     bd=bd, W=W, H=H)
    assert not np.array_equal(want.numpy(), base)
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("comp", [0, 1, 2])
@pytest.mark.parametrize("name", ROW_STREAMS)
def test_chain_terms(name, comp):
    """TI.chain gives each picture of the table, in order, the levels
    prepare_component gave its blocks and the number of its units whose
    row above is a unit too; TI.plane_blocks counts the blocks reaching a
    column."""
    from libhm_tpu_torch.parallel.intra_wavefront import prepare_component
    items = _stream_items(name)
    sps = items[0]["sps"]
    W, _, _, _, _ = _geometry(sps, comp)
    rows, row_start, log2h, _ = TB.intra_table(items, comp)
    want = []
    for it in items:
        lv, _ = prepare_component(it["sps"], it["pic"], it["zmap"],
                                  it["tile_map"], comp, None,
                                  bool(it["pps"].constrained_intra_pred))
        if lv is None:
            continue
        levels = 1 + max(int(np.nonzero(d["xs"] < W)[0].max(initial=-1))
                         for d in lv.values())
        ys = {blk.y >> log2h for blk in it["pic"].intra_list
              if blk.comp == comp}
        want.append((levels, sum(1 for r in ys if r - 1 in ys)))
    assert TI.chain(rows, row_start, log2h) == want
    n = 1 << (rows["nf"] & 15).astype(np.int64)
    right = rows["x"].astype(np.int64) + n
    assert TI.plane_blocks(rows, W) == 0
    assert TI.plane_blocks(rows, 0) == len(rows)
    for col in (4, W // 2, W - 4):
        assert TI.plane_blocks(rows, col) == sum(
            1 for r in right.tolist() if r > col)
