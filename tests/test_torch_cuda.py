"""The port's CUDA kernels against their plain torch versions, on a GPU.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
check happens inside the fixture, never at import).  On a GPU host:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Inputs are numpy-seeded; all arithmetic is integer, so equality is exact.
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _items(name):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(open(os.path.join(ROOT, "testdata",
                                        GOLD[name]["bitstream"]), "rb").read())
    return dec.collected


def test_residual_kernel(gpu):
    from libhm_tpu_torch.ops import transform as TK
    rng = np.random.default_rng(1)
    for n, use_dst, tskip in ((4, True, False), (4, True, True),
                              (8, False, False), (16, False, False),
                              (32, False, False)):
        P = 64
        coeffs = torch.from_numpy(rng.integers(-32768, 32768, (P, n, n))
                                  .astype(np.int16)).to(gpu)
        qp = torch.from_numpy(rng.integers(0, 64, P).astype(np.int8)).to(gpu)
        # distinct 32x32 slots of 2 pictures; picture index 2 is padding
        slot = rng.choice(3 * 64, P, replace=False)
        bsel, ysel, xsel = (torch.from_numpy(a.astype(np.int32)).to(gpu)
                            for a in (slot // 64, slot // 8 % 8 * 32,
                                      slot % 8 * 32))
        kw = dict(n=n, use_dst=use_dst, tskip=tskip, bd=10)
        got = torch.zeros((2, 256, 256), dtype=torch.int32, device=gpu)
        want = got.clone()
        TK.residual_scatter(got, coeffs, qp, bsel, ysel, xsel, **kw)
        TK.residual_scatter_plain(want, coeffs, qp, bsel, ysel, xsel, **kw)
        assert torch.equal(got, want), (n, use_dst, tskip)


def _mixed_tu_table(rng, gpu, B=2, H=250, W=296):
    """One TU table of every size and mode: flat DCT, DST, transform skip
    (rotated at 4x4), bypass (rotated at 4x4), scaled, RDPCM in both
    directions, rows of a padding picture (-1 and B), TUs across the
    plane's bottom and right edges, and one TU whose coefficients start 2
    bytes past a 4-byte boundary.  Returns (TuTable, mats, plane shape)."""
    from libhm_tpu_torch.hostdec.tables import build_scaling_matrices
    from libhm_tpu_torch.ops import transform as TK
    sm = build_scaling_matrices(None)
    mats = {n: torch.from_numpy(np.stack(
        [sm[(n.bit_length() - 3, m)] for m in range(6)]).astype(np.uint8))
        .to(gpu) for n in TK.SIZES}
    modes = (0, TK.F_DST, TK.F_TSKIP, TK.F_TSKIP | TK.F_ROTATE, TK.F_BYPASS,
             TK.F_BYPASS | TK.F_ROTATE, TK.F_SCALED,
             TK.F_SCALED | TK.F_TSKIP)
    ny, nx = -(-H // 32), -(-W // 32)          # 32x32 slots, edge ones cut
    slots = rng.permutation(B * ny * nx + 8)
    rows, blocks, off, k = [], [], 0, 0
    for log2n, count in ((2, 70), (3, 40), (4, 20), (5, 9)):
        n = 1 << log2n
        for i in range(count):
            fl = modes[i % len(modes)]
            if n > 4:
                fl &= ~(TK.F_DST | TK.F_ROTATE)
                if fl & TK.F_TSKIP:
                    fl &= ~TK.F_SCALED
            sl = slots[k]
            k += 1
            b = sl // (ny * nx) if sl < B * ny * nx else (-1, B)[sl % 2]
            y = sl % (ny * nx) // nx * 32 + int(rng.integers(0, 33 - n)) // 4 * 4
            x = sl % nx * 32 + int(rng.integers(0, 33 - n)) // 4 * 4
            if log2n == 4 and i == 5:
                off += 1                       # the misaligned TU
            rd = int(rng.integers(0, 3)) if fl & (TK.F_TSKIP | TK.F_BYPASS) \
                else 0
            rows.append((off, b, y, x, log2n, int(rng.integers(0, 64)), fl, rd,
                         int(rng.integers(0, 6)), (8, 10, 12)[i % 3]))
            blocks.append((off, rng.integers(-3000, 3000, n * n)))
            off += n * n
            if log2n == 4 and i == 5:
                off += 7                       # back on a 16-byte boundary
    t = np.zeros(len(rows), TK.TU_DTYPE)
    for j, name in enumerate(TK.TU_DTYPE.names):
        t[name] = [r[j] for r in rows]
    coeffs = np.zeros(off, np.int16)
    for o, c in blocks:
        coeffs[o:o + len(c)] = c
    table = TK.TuTable(
        torch.from_numpy(t.view(np.uint8).reshape(-1, 16)).to(gpu),
        torch.from_numpy(coeffs).to(gpu), (70, 40, 20, 9),
        int(np.bitwise_or.reduce(t["flags"])))
    assert any(r[0] % 2 for r in rows)
    return table, mats, (B, H, W)


def test_residual_table_kernel(gpu):
    """K1 over one mixed table (every size and mode, edges, padding rows, a
    misaligned coefficient offset) in ONE launch == its plain version, 20
    times bit-identical."""
    from libhm_tpu_torch.ops import transform as TK
    table, mats, shape = _mixed_tu_table(np.random.default_rng(21), gpu)
    want = TK.residual_table_plain(
        torch.zeros(shape, dtype=torch.int32, device=gpu), table, mats)
    assert want.any()
    n0 = (TK._K1.launches, TK._K1_SCAL.launches, TK._K1_BYPASS.launches)
    for _ in range(20):
        got = TK.residual_table(
            torch.zeros(shape, dtype=torch.int32, device=gpu), table, mats)
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())
    assert (TK._K1.launches, TK._K1_SCAL.launches, TK._K1_BYPASS.launches) \
        == tuple(v + 20 for v in n0)


@pytest.mark.parametrize("bd", [10, 12, 14, 16])
@pytest.mark.parametrize("plain_share", [0.0, 0.5], ids=["ext", "mixed"])
def test_residual_table_ext_kernel(gpu, bd, plain_share):
    """K1's wide form (a table with F_EXT rows: int32 coefficients, 64-bit
    sums) over a seeded table of every mode, levels over [-2^M, 2^M - 1]
    (tests/ext_cases.py), CCP rows in a second launch, and the same with
    half the rows without F_EXT == its plain version, 20 launches
    bit-identical, each counted in _K1 and _K1_EXT."""
    from ext_cases import ext_level
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    rng = np.random.default_rng(bd)
    shape = (2, 136, 248)
    for chroma in (False, True):
        rows, coeffs, counts, flags, mats, _ = ext_level(
            rng, bd, *shape, chroma=chroma, plain_share=plain_share)
        table = TB.upload_tables([(rows, coeffs, counts, flags)], gpu)[0]
        assert table.coeffs.dtype == torch.int32
        m = {n: torch.from_numpy(v).to(gpu) for n, v in mats.items()}
        res_l = torch.from_numpy(rng.integers(
            -(1 << (bd + 5)), 1 << (bd + 5), shape).astype(np.int32)).to(gpu) \
            if chroma else None
        want = TK.residual_table_plain(
            torch.zeros(shape, dtype=torch.int32, device=gpu), table, m,
            res_l)
        n0 = (TK._K1.launches, TK._K1_EXT.launches)
        for _ in range(20):
            got = TK.residual_table(
                torch.zeros(shape, dtype=torch.int32, device=gpu), table, m,
                res_l)
            torch.cuda.synchronize()
            assert torch.equal(got, want), int((got != want).sum())
        assert (TK._K1.launches, TK._K1_EXT.launches) == \
            (n0[0] + 20, n0[1] + 20)
        if bd == 16:
            assert want.abs().max() > 32767


@pytest.mark.parametrize("name", ["randomaccess_main10_416x240",
                                  "customsl_lowdelay_160x96",
                                  "lossless_intra_416x240"])
def test_residual_level_one_launch_per_component(gpu, name):
    """A level's residual planes through K1: one launch per component,
    equal to the same tables through the plain version on the CPU."""
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.parallel.dag_decode import reference_levels
    for level in reference_levels(_items(name))[:3]:
        tables, _ = TB.residual_tables(level)
        n0 = TK._K1.launches
        got = TB._residual_planes_batch_device(level, len(level), gpu)
        torch.cuda.synchronize()
        assert TK._K1.launches - n0 == sum(len(t[0]) > 0 for t in tables)
        assert len(got) == 3 and len(tables[0][0])
        want = TB._residual_planes_batch_device(level, len(level),
                                                torch.device("cpu"))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _mc_tile_inputs(rng, bd, sx, sy, B=2, R=3, HpL=96, WpL=128, HL=88,
                    WL=120):
    """Per-4x4 maps that hold every kind of 16x16 tile: no inter cell,
    every inter cell on one MV (8x8 and larger PUs, bi and uni), every cell
    its own MV, and windows past each of the four picture edges."""
    h4, w4 = HpL // 4, WpL // 4
    mv = rng.integers(-96, 97, (B, h4, w4, 2, 2))
    dirm = rng.integers(0, 4, (B, h4, w4))
    sel = rng.integers(0, R + 1, (B, h4, w4, 2))      # R: clamped
    dirm[0, 0:4, 4:8] = 0                             # no inter cell
    far = 4 * 600                                     # quarter-pels
    mv[1, 0:2, :, :, 1] = -far                        # above the top edge
    mv[1, -4:, :, :, 1] = far                         # below the bottom
    mv[0, :, 0:2, :, 0] = -far                        # left of the left
    mv[0, :, -4:, :, 0] = far + 3                     # right of the right
    for b, ys, xs, d in ((0, slice(0, 4), slice(0, 4), 3),
                         (1, slice(4, 12), slice(8, 16), 1),
                         (0, slice(8, 12), slice(16, 20), 2)):
        mv[b, ys, xs] = mv[b, ys.start, xs.start]     # one PU per tile
        sel[b, ys, xs] = sel[b, ys.start, xs.start]
        dirm[b, ys, xs] = d
    dirm[1, 12:16, 0:4] = np.where(np.arange(4)[:, None] == 1, 0, 3)
    mv[1, 12:16, 0:4] = mv[1, 12, 0]                  # shared, one gap
    sel[1, 12:16, 0:4] = sel[1, 12, 0]
    hp, wp, h, w = HpL >> sy, WpL >> sx, HL >> sy, WL >> sx
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt))  # noqa
    return dict(
        stacked=t(rng.integers(0, 1 << bd, (B, hp, wp)), np.int32),
        res=t(rng.integers(-512, 512, (B, hp, wp)), np.int32),
        refs=t(rng.integers(0, 1 << bd, (R, h, w)), np.int32),
        mv=t(mv, np.int16), dirm=t(dirm, np.int8), sel=t(sel, np.int16),
        W=w, H=h)


@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (True, 12, 0, 0),
                                              (False, 8, 1, 1),
                                              (False, 12, 1, 0),
                                              (False, 10, 0, 0)])
def test_mc_grid_tiles(gpu, is_luma, bd, sx, sy):
    """K5 == mc_grid_plain on every kind of tile (none inter, one shared
    MV, one MV a cell, windows past all four edges), luma and 4:2:0,
    4:2:2, 4:4:4 chroma at 8-12 bits, 20 times bit-identical."""
    from libhm_tpu_torch.ops import interp as MK
    a = _mc_tile_inputs(np.random.default_rng(30 + bd + 2 * sx + sy), bd,
                        sx, sy)
    args = [a[k].to(gpu) for k in ("stacked", "res", "refs", "mv", "dirm",
                                   "sel")]
    kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=a["W"], H=a["H"])
    want = MK.mc_grid_plain(args[0].clone(), *args[1:], **kw)
    assert not torch.equal(want, args[0])
    n0 = MK._K5.launches
    for _ in range(20):
        got = MK.mc_grid(args[0].clone(), *args[1:], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())
    assert MK._K5.launches == n0 + 20


def _single_pass_filters():
    """The single-pass K3/K4 entry points, off the decode paths."""
    from libhm_tpu_torch.ops import deblock as DK
    from libhm_tpu_torch.ops import sao as SK
    return (DK._K3_LUMA, DK._K3_CHROMA, DK._K3_CHROMA16, SK._K4,
            SK._K4_MULTI)


def _dag_levels(name):
    """The reference-DAG levels of a golden: K2 launches at most once per
    component in each."""
    from libhm_tpu_torch.parallel.dag_decode import reference_levels
    return len(reference_levels(_items(name)))


@pytest.mark.parametrize("name", ["intra_main10_416x240", "intra_416x240",
                                  "tiles_832x480"])
def test_decode_on_gpu(gpu, name):
    """Every kernel launches, K2 at most once per component and DAG level,
    the loop-filter kernel once per level (and no single-pass K3/K4 entry
    point), and the picture MD5 matches the golden one."""
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    kernels = (TK._K1, IK._K2, LF._LF) + _single_pass_filters()
    for k in kernels:
        k.launches = 0
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    outs = decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert all(k.launches > 0 for k in kernels[:3])
    assert not any(k.launches for k in kernels[3:])
    assert IK._K2.launches <= 3 * _dag_levels(name)
    assert LF._LF.launches == _dag_levels(name)


@pytest.mark.parametrize("name", ["randomaccess_main10_416x240",
                                  "intra_416x240", "rext422_intra_416x240",
                                  "mono_intra_416x240"])
def test_k2_one_launch_a_level(gpu, name):
    """decode_batch makes exactly one K2 launch per DAG level with an
    intra block, over every component that holds one there, and the
    picture MD5 matches the golden one."""
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel.dag_decode import (decode_batch,
                                                     reference_levels)
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    levels = reference_levels(_items(name))
    IK._K2.launches = 0
    outs = decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert IK._K2.launches == sum(any(it["pic"].intra_list for it in lv)
                                  for lv in levels) > 0


# K2's streams: tiles, slices, 4:2:2, 4:4:4, 12 bits, constrained intra
# (inter pictures around the intra blocks) and a one-CTU-row picture
K2_STREAMS = ("intra_main10_416x240", "tiles_832x480", "slices_416x240",
              "rext422_intra_416x240", "intra_rext444_416x240",
              "main12_intra_416x240", "cip_ra_160x96", "intra_64x64")


@pytest.mark.parametrize("comp", [0, 1, 2])
@pytest.mark.parametrize("name", K2_STREAMS)
def test_intra_wavefront_kernel(gpu, name, comp):
    """K2 == its plain version over the whole wavefront of picture 0 and of
    every picture of the stream as one batch, 20 times in a row (a race
    shows as a rare mismatch), and once each with grids of one and two
    CTAs (the ticket order alone orders the rows; a row waits on another
    CTA's)."""
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel.batch_decode import intra_meta
    items = _items(name)
    sps = items[0]["sps"]
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    bd = sps.bit_depth_chroma if comp else sps.bit_depth_luma
    shape = (len(items), (sps.pic_height_ctbs << sps.log2_ctb) >> sy,
             (sps.pic_width_ctbs << sps.log2_ctb) >> sx)
    kw = dict(is_luma=comp == 0, bd=bd, W=sps.width >> sx,
              H=sps.height >> sy)
    rng = np.random.default_rng(2 + comp + len(name))
    base = torch.from_numpy(rng.integers(0, 1 << bd, shape)
                            .astype(np.int32)).to(gpu)
    res = torch.from_numpy(rng.integers(-64, 65, shape)
                           .astype(np.int32)).to(gpu)
    for pics in ([0], list(range(len(items)))):
        table = intra_meta([items[b] for b in pics], comp, gpu)
        assert table is not None
        b0, r0 = base[pics].contiguous(), res[pics].contiguous()
        want = IK.intra_wavefront_plain(b0.clone(), r0, table, **kw)
        assert not torch.equal(want, b0)
        n0 = IK._K2.launches
        for _ in range(20):
            got = IK.intra_wavefront(b0.clone(), r0, table, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (pics, int((got != want).sum()))
        assert IK._K2.launches == n0 + 20
        for ctas in (1, 2):
            got = IK.intra_wavefront(b0.clone(), r0, table, _ctas=ctas, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (pics, ctas)


def _mc_inputs(rng, bd, B=3, R=4, Hp=96, Wp=128, H=88, W=120, sx=0, sy=0):
    """Seeded planes and per-4x4 maps; MVs reach far past the picture."""
    hp, wp, h, w = Hp >> sy, Wp >> sx, H >> sy, W >> sx
    h4, w4 = Hp // 4, Wp // 4
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return dict(
        stacked=t(rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)),
        res=t(rng.integers(-512, 512, (B, hp, wp)).astype(np.int32)),
        refs=t(rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)),
        mv=t(rng.integers(-400, 401, (B, h4, w4, 2, 2)).astype(np.int16)),
        dirm=t(rng.integers(0, 4, (B, h4, w4)).astype(np.int8)),
        sel=t(rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)),
        W=w, H=h)


@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (True, 10, 0, 0),
                                              (False, 10, 1, 1),
                                              (False, 10, 1, 0),
                                              (False, 12, 0, 0)])
def test_mc_grid_kernel(gpu, is_luma, bd, sx, sy):
    from libhm_tpu_torch.ops import interp as MK
    a = _mc_inputs(np.random.default_rng(3 + bd), bd, sx=sx, sy=sy)
    args = [a[k].to(gpu) for k in ("stacked", "res", "refs", "mv", "dirm",
                                   "sel")]
    kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=a["W"], H=a["H"])
    want = args[0].clone()
    MK.mc_grid_plain(want, *args[1:], **kw)
    n0 = MK._K5.launches
    MK.mc_grid(*args, **kw)
    torch.cuda.synchronize()
    assert MK._K5.launches == n0 + 1
    assert torch.equal(args[0], want)


@pytest.mark.parametrize("wp", [True, False])
@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (False, 10, 1, 1),
                                              (False, 8, 1, 0),
                                              (False, 12, 0, 0)])
def test_mc_weighted_kernel(gpu, is_luma, bd, sx, sy, wp):
    """K6 on a PU-shaped level (mc_cases: luma tiles of every form, rows
    off the cell grid and past the plane, MVs far past every edge): rows
    in raster order (luma grouped on the device), grouped on the host, a
    one-CTA grid, a one-tile table and a one-row table, each 20 launches
    bit-identical to the plain version; luma refuses runs that hold no
    row."""
    from mc_cases import block_table, pu_maps
    from libhm_tpu_torch.ops import interp as MK
    rng = np.random.default_rng(4 + bd)
    a = _mc_inputs(rng, bd, sx=sx, sy=sy)
    B, hp, wpad = a["stacked"].shape
    blk = block_table(pu_maps(rng, B, 4, 96, 128), sx, sy, bd)
    rows, groups = MK.tile_groups(torch.from_numpy(blk), B=B, Hp=hp, Wp=wpad)
    one_tile = rows[:int(groups[1])]
    args = [a[k].to(gpu) for k in ("stacked", "res", "refs")]
    for denom in ((0, 3, 7) if wp else (0,)):
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, wp=wp, denom=denom,
                  W=a["W"], H=a["H"])
        cases = [(torch.from_numpy(blk), None, 0), (rows, groups, 0),
                 (rows, groups, 1), (torch.from_numpy(blk), None, 1),
                 (one_tile, None, 0), (rows[5:6], None, 0)]
        for table, grp, ctas in cases:
            table = table.to(gpu)
            want = args[0].clone()
            MK.mc_weighted_plain(want, args[1], args[2], table, **kw)
            n0 = MK._K6.launches
            for _ in range(20):
                got = args[0].clone()
                MK.mc_weighted(got, args[1], args[2], table,
                               groups=None if grp is None else grp.to(gpu),
                               _ctas=ctas, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (denom, ctas, len(table))
            assert MK._K6.launches == n0 + 20
    if is_luma:
        with pytest.raises(ValueError, match="no run"):
            MK.mc_weighted(args[0].clone(), args[1], args[2],
                           rows.to(gpu), groups=groups[:1].to(gpu), **kw)


@pytest.mark.parametrize("n", [1, 51, 65, 130])
def test_checksum_kernel(gpu, n):
    """K7 over n crops of 1088x1920 planes at every column offset mod 4
    (misaligned rows), with an empty crop among them, one launch per
    MAX_VIEWS views; the sum passes 2^32 from 2 views on."""
    from libhm_tpu_torch.ops import checksum as CK
    rng = np.random.default_rng(6 + n)
    planes = torch.from_numpy(rng.integers(0, 4096, (3, 1088, 1920))
                              .astype(np.int32)).to(gpu)
    views = [planes[i % 3, i % 5:1084 - i % 7, i % 4:1913 + i % 3]
             for i in range(n)]
    views.insert(n // 2, planes[0, 7:7, 3:9])
    want = int(CK.plane_checksum_plain(views).item())
    for _ in range(20):
        n0 = CK._K7.launches
        got = int(CK.plane_checksum(views).item()) & 0xFFFFFFFF
        assert CK._K7.launches == n0 + -(-n // CK.MAX_VIEWS)
        assert got == want


@pytest.mark.parametrize("name,kernel", [
    ("randomaccess_main10_416x240", "_K5"), ("wp_lowdelayP_416x240", "_K6")])
def test_inter_decode_on_gpu(gpu, name, kernel):
    """Golden MD5 through the MC kernels; the device checksum equals the
    checksum of the downloaded pictures."""
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel import dag_decode as DD
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    k = getattr(MK, kernel)
    k.launches = IK._K2.launches = 0
    outs = DD.decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert k.launches > 0
    assert 0 < IK._K2.launches <= 3 * _dag_levels(name)
    CK._K7.launches = 0
    csum = DD.decode_batch_device(data, device=gpu)[2]
    assert CK._K7.launches == 1
    assert csum == DD.cropped_checksum(outs)


@pytest.mark.parametrize("mode", ["scaled", "bypass"])
def test_residual_kernel_modes(gpu, mode):
    """K1's scaled and bypass modes, with rotation (4x4) and RDPCM in
    every direction, == their plain versions."""
    from libhm_tpu_torch.hostdec.tables import build_scaling_matrices
    from libhm_tpu_torch.ops import transform as TK
    rng = np.random.default_rng(7)
    mats = build_scaling_matrices(None)
    for n, use_dst, tskip, rotate in ((4, True, False, False),
                                      (4, False, True, True),
                                      (8, False, False, False),
                                      (16, False, False, False),
                                      (32, False, True, False)):
        P = 64
        coeffs = torch.from_numpy(rng.integers(-32768, 32768, (P, n, n))
                                  .astype(np.int16)).to(gpu)
        qp = torch.from_numpy(rng.integers(0, 64, P).astype(np.int8)).to(gpu)
        rdpcm = torch.from_numpy(rng.integers(0, 3, P).astype(np.int8)).to(gpu)
        slot = rng.choice(3 * 64, P, replace=False)
        bsel, ysel, xsel = (torch.from_numpy(a.astype(np.int32)).to(gpu)
                            for a in (slot // 64, slot // 8 % 8 * 32,
                                      slot % 8 * 32))
        kw = dict(n=n, use_dst=use_dst, tskip=tskip, bd=10, rotate=rotate,
                  rdpcm=rdpcm)
        if mode == "bypass":
            kw.update(bypass=True)
        else:
            table = np.stack([mats[(n.bit_length() - 3, m)] for m in range(6)])
            kw.update(mats=torch.from_numpy(table.astype(np.uint8)).to(gpu),
                      midx=torch.from_numpy(rng.integers(0, 6, P)
                                            .astype(np.uint8)).to(gpu))
        got = torch.zeros((2, 256, 256), dtype=torch.int32, device=gpu)
        want = got.clone()
        TK.residual_scatter(got, coeffs, qp, bsel, ysel, xsel, **kw)
        TK.residual_scatter_plain(want, coeffs, qp, bsel, ysel, xsel, **kw)
        assert torch.equal(got, want), (mode, n, use_dst, tskip, rotate)


@pytest.mark.parametrize("lft", [0, 1])
@pytest.mark.parametrize("sh", [0, 1])
def test_sao_multi_kernel(gpu, sh, lft):
    """K4's multi form == its plain version: 3 slices, 2 tiles, mixed
    loop filtering across slices, a picture cropped inside its CTB grid
    (so the map rows and columns clamp at the padded bottom and right)."""
    from libhm_tpu_torch.ops import sao as SK
    rng = np.random.default_rng(8 + sh + 2 * lft)
    B, log2_ctb, HpL, WpL = 2, 5, 96, 128
    h4, w4, hc, wc = HpL // 4, WpL // 4, HpL >> log2_ctb, WpL >> log2_ctb
    Hp, Wp, H, W = HpL >> sh, WpL >> sh, 84 >> sh, 120 >> sh
    s4 = np.zeros((B, h4, w4), np.int16)
    s4.reshape(B, -1)[:, 200:] = 1
    s4.reshape(B, -1)[:, 500:] = 2
    lf4 = (s4 != 1).astype(np.uint8)
    tm = np.zeros((B, hc, wc), np.int16)
    tm[:, :, wc // 2:] = 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    args = (t(rng.integers(0, 1024, (B, Hp, Wp)).astype(np.int32)),
            t(rng.integers(-1, 5, (B, hc, wc)).astype(np.int8)),
            t(rng.integers(0, 32, (B, hc, wc)).astype(np.int8)),
            t(rng.integers(-31, 32, (B, hc, wc, 4)).astype(np.int8)),
            t(np.array([0, 1], np.int32)), t(s4), t(lf4), t(tm),
            t(np.full(B, lft, np.uint8)))
    kw = dict(log2cx=log2_ctb - sh, log2cy=log2_ctb - sh, bd=10, W=W, H=H,
              sx=sh, sy=sh, log2_ctb=log2_ctb)
    n0 = SK._K4_MULTI.launches
    got = SK.sao_multi(*args, **kw)
    want = SK.sao_multi_plain(*args, **kw)
    torch.cuda.synchronize()
    assert SK._K4_MULTI.launches == n0 + 1
    assert torch.equal(got, want)


def test_restore_and_pcm_kernels(gpu):
    """K8 == its plain version (luma and 4:2:0 chroma grids); K9 writes a
    4:2:0 level's luma and both chroma planes in ONE launch, and a 4:2:2
    level's (w x 2w chroma blocks) in one more, each equal to its plain
    version, 20 times bit-identical."""
    from libhm_tpu_torch.ops import pcm as PK
    from pcm_cases import pcm_blocks, plane_shapes
    rng = np.random.default_rng(9)
    B, h4, w4 = 2, 34, 60
    rmask = torch.from_numpy((rng.random((B, h4, w4)) < 0.2)
                             .astype(np.uint8)).to(gpu)
    for sh in (0, 1):
        Hp, Wp = (h4 * 4) >> sh, (w4 * 4) >> sh
        planes = torch.from_numpy(rng.integers(0, 1024, (B, Hp, Wp))
                                  .astype(np.int32)).to(gpu)
        pre = torch.from_numpy(rng.integers(0, 1024, (B, Hp, Wp))
                               .astype(np.int32)).to(gpu)
        got, want = planes.clone(), planes.clone()
        PK.restore_unfiltered(got, pre, rmask, sx=sh, sy=sh)
        PK.restore_unfiltered_plain(want, pre, rmask, sx=sh, sy=sh)
        assert torch.equal(got, want) and not torch.equal(got, planes)
    for fmt in (1, 2):
        # blocks over a 136 x 240 grid, planes of 128 x 232: the edge
        # blocks reach past them (4:2:0 chroma rows of 116 samples end
        # inside a 16-byte store)
        shapes = plane_shapes(fmt, 3, 128, 232)
        blocks = pcm_blocks(rng, fmt, 3, 136, 240, share=0.4)
        blocks.append((0, 3, 0, 0, 8, 8, 0, np.ones((8, 8))))  # padding
        buf, counts = PK.pcm_pack(blocks)
        table = PK.pcm_table(torch.from_numpy(buf).to(gpu), counts)
        want = PK.pcm_level_plain(
            [torch.zeros(s, dtype=torch.int32, device=gpu) for s in shapes],
            table)
        assert all(w.any() for w in want)
        n0 = PK._K9.launches
        for _ in range(20):
            got = PK.pcm_level([torch.zeros(s, dtype=torch.int32, device=gpu)
                                for s in shapes], table)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), fmt
        assert PK._K9.launches == n0 + 20


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sx,sy", [(1, 1), (1, 0), (0, 0)])
def test_restore_kernel_geometries(gpu, sx, sy, aligned):
    """K8 == its plain version at 4:2:0, 4:2:2 and 4:4:4 on planes that
    reach past the mask grid and end inside a tile (the edge tiles, the
    clamped last mask row and column), with the 16/8-byte row copies
    (aligned) and the sample-by-sample ones (planes 4 bytes off)."""
    from libhm_tpu_torch.ops import pcm as PK
    rng = np.random.default_rng(10 + 4 * sx + 2 * sy + aligned)
    B, h4, w4 = 3, 37, 45              # 45 cells: a tile and a half wide
    Hp, Wp = (4 * h4 + 12) >> sy, (4 * w4 + 20) >> sx
    rmask = (rng.random((B, h4, w4)) < 0.1).astype(np.uint8)
    rmask[0, :8] = 0                   # whole tiles with no cell set
    rmask[1, -1, :] = rmask[2, :, -1] = 1
    rmask = torch.from_numpy(rmask).to(gpu)

    def planes_on_card():
        a = rng.integers(0, 1024, (B, Hp, Wp)).astype(np.int32)
        t = torch.from_numpy(a).to(gpu)
        if aligned:
            return t
        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=gpu)
        out = flat[1:].view(B, Hp, Wp)
        out.copy_(t)
        return out
    planes, pre = planes_on_card(), planes_on_card()
    assert (planes.data_ptr() % 16 == 0) == aligned
    want = PK.restore_unfiltered_plain(planes.clone(), pre, rmask, sx=sx,
                                       sy=sy)
    n0 = PK._K8.launches
    got = PK.restore_unfiltered(planes, pre, rmask, sx=sx, sy=sy)
    torch.cuda.synchronize()
    assert PK._K8.launches == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(want[1, -1], pre[1, -1])        # clamped last row
    assert torch.equal(want[2, :, -1], pre[2, :, -1])  # clamped last column


@pytest.mark.parametrize("name,kernel", [
    ("tiles_nolfcross_512x128", "multi"),
    ("lossless_intra_416x240", "_K1_BYPASS"),
    ("customsl_lowdelay_160x96", "_K1_SCAL"),
    ("pcm_port_416x240", "_K9")])
def test_tool_decode_on_gpu(gpu, name, kernel):
    """The coding-tool streams match their MD5 through the new modes (the
    loop-filter kernel's multi-slice/tile SAO form for "multi")."""
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import pcm as PK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import dag_decode as DD
    table = json.load(open(os.path.join(ROOT, "testdata",
                                        "port_streams.json")))
    if name in GOLD:
        table = GOLD
    k = LF.FORMS.get(kernel) or next(getattr(m, kernel) for m in (TK, PK)
                                     if hasattr(m, kernel))
    k.launches = 0
    data = open(os.path.join(ROOT, "testdata", table[name]["bitstream"]),
                "rb").read()
    outs = DD.decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == table[name]["decoded_yuv_md5"]
    assert k.launches > 0


def test_ccp_kernel(gpu):
    """K1's CCP epilogue == its plain version and == the table without
    alphas then ccp_apply_plain: every TU size, alpha and mode, CCP-only
    rows, TUs past the plane's edges, values at the int16 clip, with the
    luma residual aligned (16-byte loads) and 4 bytes off (scalar loads),
    20 launches bit-identical each."""
    from ccp_cases import ccp_level
    from libhm_tpu_torch.ops import ccp as CK
    from libhm_tpu_torch.ops import transform as TK
    B, H, W = 2, 136, 248
    lv = ccp_level(np.random.default_rng(10), TK.TU_DTYPE, B, H, W,
                   share=0.5)
    rows = lv["rows"].copy()
    rows["rdpcm"] |= TK.ccp_bits(lv["alpha"])
    rows["flags"] |= np.where(lv["alpha"] != 0, TK.F_CCP, 0).astype(np.uint8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    table = TK.TuTable(t(rows.view(np.uint8).reshape(-1, 16)),
                       t(lv["coeffs"]), lv["counts"],
                       int(np.bitwise_or.reduce(rows["flags"])))
    bare = TK.TuTable(t(lv["rows"].view(np.uint8).reshape(-1, 16)),
                      t(lv["coeffs"]), lv["counts"], lv["flags"])

    def zeros():
        return torch.zeros((B, H, W), dtype=torch.int32, device=gpu)
    for aligned in (True, False):
        res_l = t(lv["res_l"])
        if not aligned:
            flat = torch.empty(res_l.numel() + 1, dtype=torch.int32,
                               device=gpu)
            res_l = flat[1:].view(B, H, W)
            res_l.copy_(t(lv["res_l"]))
        want = TK.residual_table_plain(zeros(), table, res_l=res_l)
        two = CK.ccp_apply_plain(TK.residual_table_plain(zeros(), bare),
                                 res_l, t(lv["tus"]))
        assert torch.equal(want, two)
        assert not torch.equal(want, TK.residual_table_plain(zeros(), bare))
        n0 = (TK._K1.launches, TK._K1_CCP.launches)
        for _ in range(20):
            got = TK.residual_table(zeros(), table, res_l=res_l)
            torch.cuda.synchronize()
            assert torch.equal(got, want), int((got != want).sum())
        assert (TK._K1.launches, TK._K1_CCP.launches) == \
            (n0[0] + 20, n0[1] + 20)
    with pytest.raises(ValueError, match="epilogue of K1"):
        CK.ccp_apply(zeros(), res_l, t(lv["tus"]))


@pytest.mark.parametrize("bdy,bdc", [(8, 10), (10, 8), (8, 12), (12, 8),
                                     (16, 8), (8, 16)])
def test_ccp_kernel_unequal_depths(gpu, bdy, bdc):
    """K1's CCP epilogue with the luma residual scaled by H.265 8.6.6,
    (rY << BitDepthC) >> BitDepthY: equal to its plain version, 20
    launches bit-identical, and unlike the unscaled formula."""
    from ccp_cases import ccp_level
    from libhm_tpu_torch.ops import transform as TK
    B, H, W = 2, 136, 248
    lv = ccp_level(np.random.default_rng(bdy + 3 * bdc), TK.TU_DTYPE, B, H,
                   W, share=0.5, bd=bdc)
    rows = lv["rows"].copy()
    rows["rdpcm"] |= TK.ccp_bits(lv["alpha"])
    rows["flags"] |= np.where(lv["alpha"] != 0, TK.F_CCP, 0).astype(np.uint8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    table = TK.TuTable(t(rows.view(np.uint8).reshape(-1, 16)),
                       t(lv["coeffs"]), lv["counts"],
                       int(np.bitwise_or.reduce(rows["flags"])))
    res_l = t(lv["res_l"])

    def zeros():
        return torch.zeros((B, H, W), dtype=torch.int32, device=gpu)
    want = TK.residual_table_plain(zeros(), table, res_l=res_l,
                                   ccp_bd=(bdy, bdc))
    assert not torch.equal(want, TK.residual_table_plain(zeros(), table,
                                                         res_l=res_l))
    for _ in range(20):
        got = TK.residual_table(zeros(), table, res_l=res_l,
                                ccp_bd=(bdy, bdc))
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("bd,ssx,ssy", [(12, 1, 1), (12, 1, 0), (12, 0, 0),
                                         (10, 1, 0), (10, 0, 0)])
def test_deblock_chroma_kernel(gpu, bd, ssx, ssy):
    """K3 chroma == its plain version, both directions, on the 4:2:0,
    4:2:2 and 4:4:4 grids: the int16-tc entry point at 12 bits, the
    uint8 one at 10."""
    from libhm_tpu_torch.ops import deblock as DK
    rng = np.random.default_rng(bd + 2 * ssx + ssy)
    Hl, Wl = 128, 256
    h4, w4 = Hl // 4, Wl // 4
    bs = rng.integers(0, 3, (1, h4, w4)).astype(np.uint8)
    bsn = torch.from_numpy(bs | ((rng.random(bs.shape) < 0.1)
                                 .astype(np.uint8) << 4)).to(gpu)
    wide = bd > 11
    ctc = np.where(bs == 2, rng.integers(0, 25, bs.shape) << (bd - 8), 0)
    ctc = torch.from_numpy(ctc.astype(np.int16 if wide else np.uint8)).to(gpu)
    mid = 1 << (bd - 1)
    plane = torch.from_numpy(rng.integers(mid - (mid >> 3), mid + (mid >> 3),
                                          (1, Hl >> ssy, Wl >> ssx))
                             .astype(np.int32)).to(gpu)
    k = DK._K3_CHROMA16 if wide else DK._K3_CHROMA
    for vertical in (True, False):
        kw = dict(vertical=vertical, bd=bd, ssx=ssx, ssy=ssy)
        got, want = plane.clone(), plane.clone()
        n0 = k.launches
        DK.deblock_chroma(got, ctc, bsn, **kw)
        DK.deblock_chroma_plain(want, ctc, bsn, **kw)
        torch.cuda.synchronize()
        assert k.launches == n0 + 1
        assert torch.equal(got, want) and not torch.equal(got, plane)


@pytest.mark.parametrize("sx,sy", [(1, 0), (0, 0)])
def test_sao_kernel_rext(gpu, sx, sy):
    """K4 == its plain version on 4:2:2 chroma (16x32 chroma CTBs of 32x32
    luma CTBs: log2cx != log2cy) and 4:4:4 chroma, 12 bits with an offset
    scale, the picture cropped inside its CTB grid."""
    from libhm_tpu_torch.ops import sao as SK
    rng = np.random.default_rng(40 + 2 * sx + sy)
    B, log2_ctb, HpL, WpL = 2, 5, 96, 128
    hc, wc = HpL >> log2_ctb, WpL >> log2_ctb
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    args = (t(rng.integers(0, 4096, (B, HpL >> sy, WpL >> sx))
              .astype(np.int32)),
            t(rng.integers(-1, 5, (B, hc, wc)).astype(np.int8)),
            t(rng.integers(0, 32, (B, hc, wc)).astype(np.int8)),
            t(rng.integers(-31, 32, (B, hc, wc, 4)).astype(np.int8)),
            t(np.array([0, 2], np.int32)))
    kw = dict(log2cx=log2_ctb - sx, log2cy=log2_ctb - sy, bd=12,
              W=120 >> sx, H=84 >> sy)
    n0 = SK._K4.launches
    got = SK.sao(*args, **kw)
    want = SK.sao_plain(*args, **kw)
    torch.cuda.synchronize()
    assert SK._K4.launches == n0 + 1
    assert torch.equal(got, want) and not torch.equal(got, args[0])


@pytest.mark.parametrize("name,kernel", [
    ("ccp444_lowdelay_160x96", "_K1_CCP"),
    ("main12_intra_416x240", "ctc16"),
    ("rext422_lowdelayP_416x240", "_K5"),
    ("mono_lowdelay_160x96", "_K5")])
def test_rext_decode_on_gpu(gpu, name, kernel):
    """The RExt goldens match their MD5 through the kernels of their
    chroma format and bit depth (the loop-filter kernel's int16-tc form
    for "ctc16")."""
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import dag_decode as DD
    k = LF.FORMS.get(kernel) or next(getattr(m, kernel) for m in (TK, MK)
                                     if hasattr(m, kernel))
    k.launches = 0
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    outs = DD.decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert k.launches > 0


@pytest.mark.parametrize("name,kernel", [("tids4_ra_160x96", "_K5"),
                                         ("wp_lowdelayP_416x240", "_K6")])
def test_picture_decode_on_gpu(gpu, name, kernel):
    """Decoder(recon="torch") on the card, NAL by NAL: the golden MD5
    through the MC kernel of the stream, every reference picture's planes
    on the card, and after every NAL no picture outside the DPB, and no
    picture the RPS marked unused for reference, holding any."""
    from libhm_tpu_torch.hostdec import nal as N
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.utils import xfer
    k = getattr(MK, kernel)
    k.launches = 0
    xfer.reset()
    dec = Decoder(parse="native", recon="torch", device=gpu)

    def check():
        in_dpb = {id(p) for p in dec.dpb}
        assert not [p.poc for p in dec.output_records + dec.dpb
                    if (id(p) not in in_dpb or not p.is_reference)
                    and hasattr(p, "_device_planes")]
        assert all(t.is_cuda for p in dec.dpb if p.is_reference
                   for t in p._device_planes.values())
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    for ebsp in N.split_annexb(data):
        dec.decode_nal(N.parse_nal(ebsp))
        check()
    dec.flush()
    check()
    buf = b"".join(p.tobytes() for pic in dec.outputs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert k.launches > 0 and "ref" not in xfer.BY_TAG
    assert len(dec.output_records) > len(dec.dpb)    # some were released


def test_fused_step_on_gpu(gpu):
    """entry(): the fused step through K1, K6, the loop-filter kernel (V
    luma edges and SAO in one launch) and K7 equals its plain version at
    1080p, the wrapped int32 sum and the frame."""
    from libhm_tpu_torch import entry as E
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    kernels = (TK._K1, MK._K6, LF._LF, CK._K7)
    fn, args = E.entry(device=gpu)
    before = [k.launches for k in kernels]
    s, f = fn(*args)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 1, 1, 1]
    s_p, f_p = E.fused_recon_step_plain(*args)
    assert int(s) == int(s_p) and torch.equal(f, f_p)
    assert not torch.equal(f, args[4])


def test_decode_intra_batch_on_gpu(gpu):
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    kernels = (TK._K1, IK._K2, LF._LF)
    for k in kernels:
        k.launches = 0
    name = "intra_416x240"
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dps = decode_intra_batch(data, device=gpu, check_sei_hash=True)
    buf = b"".join(p.tobytes() for dp in dps for p in dp.cropped())
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert [dp.hash_status for dp in dps] == ["OK"] * len(dps)
    assert all(k.launches > 0 for k in kernels)
    assert IK._K2.launches <= 3 * _dag_levels(name)
    assert LF._LF.launches == _dag_levels(name) == 1


def test_multidevice_mixed_decode_on_gpu(gpu):
    """decode_batch(devices=["cuda:0", "cpu"]): every level of two or more
    pictures splits over the card and the host, so references cross
    devices as counted peer copies; the golden MD5, kernels on the card's
    shards."""
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    name = "tids4_ra_160x96"
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    LF._LF.launches = 0
    xfer.reset()
    outs = DD.decode_batch(data, devices=["cuda:0", "cpu"])
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert xfer.UPLOADS.get("peer", 0) > 0 and "peer" in xfer.BY_TAG
    # one launch per level on the card: the card holds the first shard
    assert LF._LF.launches == _dag_levels(name)


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (this host has "
                    f"{torch.cuda.device_count()})")
    return torch.device("cuda", 1)


def test_wrapper_refuses_tensor_off_current_device(gpu):
    """A kernel wrapper given tensors on a card other than the current
    one raises (its launch would go to the current card's stream), and
    runs with that card made current."""
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import pcm as PK
    other = _second_card()
    rng = np.random.default_rng(11)
    planes = torch.from_numpy(rng.integers(0, 1024, (1, 64, 64))
                              .astype(np.int32)).to(other)
    pre = planes.clone()
    rmask = torch.zeros((1, 16, 16), dtype=torch.uint8, device=other)
    with torch.cuda.device(0):
        with pytest.raises(ValueError, match="current device"):
            CK.plane_checksum([planes[0]])
        with pytest.raises(ValueError, match="current device"):
            PK.restore_unfiltered(planes, pre, rmask, sx=0, sy=0)
    with torch.cuda.device(other):
        got = CK.plane_checksum([planes[0]])
        assert int(got.item()) & 0xFFFFFFFF == \
            int(CK.plane_checksum_plain([planes[0]]).item())


def test_multidevice_decode_across_cards(gpu):
    """One list entry per card: the golden MD5 with peer copies between
    the cards, and the dry run over every card."""
    from libhm_tpu_torch import entry
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    _second_card()
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    name = "randomaccess_416x240"
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    xfer.reset()
    outs = DD.decode_batch(data, devices=cards)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert xfer.UPLOADS.get("peer", 0) > 0
    assert entry.dryrun_multidevice(len(cards)) == cards


# the loop-filter kernel's level cases: (lf_cases.level_case arguments)
LF_CASES = {
    "level_1080p": dict(B=3, Hp=1088, Wp=1920, H=1080, W=1920, bd_l=10,
                        log2_ctb=6),
    "chroma12": dict(Hp=256, Wp=448, H=240, W=416, bd_l=12, log2_ctb=6),
    "rext422": dict(B=2, Hp=128, Wp=192, H=120, W=184, chroma=2, bd_l=10,
                    log2_ctb=5),
    "rext444": dict(B=2, Hp=128, Wp=192, H=120, W=184, chroma=3, bd_l=10,
                    log2_ctb=4),
    "sao_off": dict(B=2, Hp=128, Wp=192, H=124, W=180, sao=False,
                    offsets=False),
    "multi": dict(B=2, Hp=128, Wp=256, H=120, W=248, bd_l=10, log2_ctb=5,
                  multi=True),
    "one_cta": dict(Hp=32, Wp=32, H=28, W=24, chroma=0, log2_ctb=5)}


@pytest.mark.parametrize("case", sorted(LF_CASES))
def test_loop_filter_level_kernel(gpu, case):
    """The loop-filter kernel == loop_filter_level_plain (V, H and SAO of
    every component of the level in one launch), 20 launches
    bit-identical, the input planes untouched."""
    from lf_cases import level_case
    from libhm_tpu_torch.ops import loopfilter as LF
    rng = np.random.default_rng(sorted(LF_CASES).index(case))
    planes, maps, kw = level_case(rng, device=gpu, **LF_CASES[case])
    keep = [p.clone() for p in planes]
    want = LF.loop_filter_level_plain(planes, maps, **kw)
    n0 = LF._LF.launches
    for _ in range(20):
        got = LF.loop_filter_level(planes, maps, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert LF._LF.launches == n0 + 20
    assert all(torch.equal(p, k) for p, k in zip(planes, keep))
    assert any(not torch.equal(w, k) for w, k in zip(want, keep))


@pytest.mark.parametrize("name", ["slices_tiles", "sao_no_deblock",
                                  "pcm_restore", "rext422_10b", "one_pass"])
def test_encoder_on_gpu(gpu, name):
    """The encoder with its in-loop filter on the card writes the bytes and
    reconstructions of the encode on the CPU, launching the loop-filter
    kernel once per pass group of each picture (and K8 where PCM samples
    are restored)."""
    from enc_cases import CASES, encode
    from libhm_tpu_torch.encoder import encoder as EN
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import pcm as PK
    n, attrs, masks = (CASES[name][k] for k in (2, 5, 7))
    want, cenc = encode(EN, name, device="cpu")
    LF._LF.launches = PK._K8.launches = 0
    got, genc = encode(EN, name, device=gpu)
    assert got == want
    for a, b in zip(cenc.stats, genc.stats):
        assert a[:3] == b[:3]
        for p, q in zip(a[3], b[3]):
            np.testing.assert_array_equal(q, p)
    assert LF._LF.launches == len(masks) * n
    assert PK._K8.launches == (3 if attrs.get("pcm_filter_disabled") else 0)
