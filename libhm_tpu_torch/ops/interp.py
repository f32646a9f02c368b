"""Motion-compensated prediction, and the MC kernels (K5, K6).

Port of libhm_tpu/ops/interp.py.  The JAX package predicts through phase
planes (every fractional phase of every reference plane filtered ahead,
then one gather per sample) or through per-block source windows; both
exist to suit the TPU.  Here each prediction is computed directly from the
reference planes: the separable 8-tap (luma) or 4-tap (chroma) filter at
the sample's integer position plus the integer part of the MV, each tap's
coordinate clamped into the picture (Rec. 8.5.3.3.3).  That equals the
phase-plane gather, whose MC_MARGIN apron is what per-tap clamping gives.

    mc_grid      every inter sample of one component of a level, driven by
                 per-4x4 MV / direction / reference maps (K5, csrc/mc.cu)
    mc_weighted  a list of 4x4 blocks with the plain or the weighted
                 (WP) uni/bi epilogue (K6, csrc/mc.cu), its luma rows
                 grouped by 16x16-sample tile (tile_groups)

Both write the predicted-plus-residual samples into the stacked planes in
place: csrc/mc.cu for CUDA planes, the plain torch versions for CPU planes.
Integer arithmetic throughout; signed `>>` is arithmetic, as in JAX.
"""
import numpy as np
import torch

from ..hostdec.motion import mc_headroom as _headroom
from ..kernels.build import I, P, Kernel, check, ptr

IF_PREC = 14
IF_OFFS = 1 << (IF_PREC - 1)

LUMA_FILTER = [
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]]

CHROMA_FILTER = [
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]]

# per-block record of mc_weighted: one int32 row per 4x4 block
BLK_FIELDS = ("b", "x", "y", "dir", "mv0x", "mv0y", "mv1x", "mv1y",
              "sel0", "sel1", "w0", "w1", "o0", "o1")


def predict(refs, sel, y0, x0, mvx, mvy, bh, bw, *, taps, fbx, fby, bd):
    """14-bit (is_last=False) prediction of one list for N blocks of
    bh x bw samples with one MV each, plain torch.

    refs: [R, H, W] int32 reference planes of one component; sel, y0, x0,
    mvx, mvy: [N] integer tensors (reference index, block origin, MV in
    1/(1<<fb) units).  Returns [N, bh, bw] int32.  The four cases of
    mc_blocks (copy, h only, v only, h then v) with its shifts and offsets,
    each tap's coordinate clamped into the picture.
    """
    R, H, W = refs.shape
    dev = refs.device
    half = taps // 2 - 1
    headroom = _headroom(bd)
    tab = torch.tensor(LUMA_FILTER if taps == 8 else CHROMA_FILTER,
                       dtype=torch.int32, device=dev)
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    fx = mvx & ((1 << fbx) - 1)
    fy = mvy & ((1 << fby) - 1)
    if taps == 4:
        # the chroma table is eighth-pel (TComInterpolationFilter.cpp:346)
        fx = fx << (3 - fbx)
        fy = fy << (3 - fby)
    ix = x0.to(torch.int32) + (mvx >> fbx)
    iy = y0.to(torch.int32) + (mvy >> fby)
    base = torch.clamp(sel.long(), 0, R - 1) * (H * W)
    flat = refs.reshape(-1)
    s1 = 6 - headroom
    o1 = -(IF_OFFS << s1)
    out = torch.empty((ix.shape[0], bh, bw), dtype=torch.int32, device=dev)
    ary = torch.arange(bh + taps - 1, device=dev) - half
    arx = torch.arange(bw + taps - 1, device=dev) - half
    # each case (copy, h only, v only, h then v) on its own blocks only,
    # from one gather of each block's tap window
    fxb, fyb = fx != 0, fy != 0
    for hx, vy in ((False, False), (True, False), (False, True),
                   (True, True)):
        i = torch.nonzero((fxb == hx) & (fyb == vy)).squeeze(1)
        if not i.numel():
            continue
        ry = ary if vy else ary[half:half + bh]
        rx = arx if hx else arx[half:half + bw]
        rows = base[i, None] + \
            torch.clamp(iy[i, None] + ry, 0, H - 1).long() * W
        cols = torch.clamp(ix[i, None] + rx, 0, W - 1).long()
        win = flat[rows[:, :, None] + cols[:, None, :]].long()   # [n, r, c]
        if hx:
            cf = tab[fx[i].long()][:, None, None, :]
            h = ((win.unfold(2, taps, 1) * cf).sum(-1) + o1) >> s1
        else:
            h = win                                                # [n, r, bw]
        if vy:
            cf = tab[fy[i].long()][:, None, None, :]
            v = (h.unfold(1, taps, 1) * cf).sum(-1)
            v = v >> 6 if hx else (v + o1) >> s1
        elif hx:
            v = h
        else:
            v = (h << headroom) - IF_OFFS
        out[i] = v.to(torch.int32)
    return out


def uni_round(p, bd):
    """Default uni-prediction epilogue: 14-bit -> samples."""
    headroom = _headroom(bd)
    off = 1 << (headroom - 1)
    return torch.clamp((p + IF_OFFS + off) >> headroom, 0, (1 << bd) - 1)


def bi_average(p0, p1, bd):
    """Default bi-prediction: shift2 = Max(3, 15 - bitDepth) (Rec.
    8.5.3.3.4.2), the headroom plus one.  The JAX package's 15 - bd is
    the same up to 12 bits and wrong above."""
    shift = _headroom(bd) + 1
    off = (1 << (shift - 1)) + 2 * IF_OFFS
    return torch.clamp((p0 + p1 + off) >> shift, 0, (1 << bd) - 1)


def weighted_uni(p, w, o, log2d, bd):
    """p: 14-bit samples; w, o broadcast against p (o already at the
    sample's scale: shifted left by WpOffsetBdShift, bd - 8 or 0 under
    high_precision_offsets_enabled_flag)."""
    shift = log2d + _headroom(bd)
    rnd = (1 << (shift - 1)) if shift > 0 else 0
    val = ((w * (p + IF_OFFS) + rnd) >> shift) + o
    return torch.clamp(val, 0, (1 << bd) - 1)


def weighted_bi(p0, p1, w0, o0, w1, o1, log2d, bd):
    shift = (log2d + 1) + _headroom(bd)
    rnd = 1 << (shift - 1)
    val = (w0 * (p0 + IF_OFFS) + w1 * (p1 + IF_OFFS) + rnd +
           (o0 + o1) * (1 << (shift - 1))) >> shift
    return torch.clamp(val, 0, (1 << bd) - 1)


def _filter_args(is_luma, sx, sy):
    """(taps, fbx, fby) of a component: luma quarter-pel, chroma 1/(4<<s)."""
    if is_luma:
        return 8, 2, 2
    return 4, 2 + sx, 2 + sy


# ---------------------------------------------------------------------------
# K5: MC of every 4x4 of a level from per-4x4 maps
_K5 = Kernel("mc_grid", [P, P, P, P, P, P] + [I] * 14)


def mc_grid_plain(stacked, res, refs, mv, dirm, sel, *, is_luma, sx, sy, bd,
                  W, H):
    """Plain torch version of mc_grid (any device), in place.

    Computes what libhm_tpu/parallel/dag_decode.py _mc_phase_grid_fn
    computes, with the direct per-tap-clamped filter instead of phase
    planes.
    """
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    dev = stacked.device
    bh, bw = 4 >> sy, 4 >> sx
    # one block of the component per inter luma 4x4, and for each list only
    # the blocks that use it
    bc, cy, cx = torch.nonzero(dirm > 0, as_tuple=True)
    dd = dirm[bc, cy, cx].to(torch.int32)[:, None, None]
    y0 = ((cy << 2) >> sy).to(torch.int32)
    x0 = ((cx << 2) >> sx).to(torch.int32)
    preds = []
    for l in range(2):
        p = torch.zeros((bc.shape[0], bh, bw), dtype=torch.int32, device=dev)
        u = torch.nonzero(dd[:, 0, 0] & (1 << l)).squeeze(1)
        if u.numel():
            mvl = mv[bc[u], cy[u], cx[u], l]                     # [n, 2]
            p[u] = predict(refs, sel[bc[u], cy[u], cx[u], l], y0[u], x0[u],
                           mvl[:, 0], mvl[:, 1], bh, bw, taps=taps, fbx=fbx,
                           fby=fby, bd=bd)
        preds.append(p)
    p0, p1 = preds
    pred = torch.where(dd == 3, bi_average(p0, p1, bd), torch.where(
        dd == 1, uni_round(p0, bd), uni_round(p1, bd)))
    b = bc[:, None, None].expand(pred.shape)
    y = (y0[:, None, None] + torch.arange(bh, device=dev)[:, None]).long() \
        .expand(pred.shape)
    x = (x0[:, None, None] + torch.arange(bw, device=dev)[None, :]).long() \
        .expand(pred.shape)
    # padding rows/cols beyond the component size never code inter
    keep = (y < H) & (x < W)
    b, y, x = b[keep], y[keep], x[keep]
    stacked[b, y, x] = torch.clamp(pred[keep] + res[b, y, x], 0,
                                   (1 << bd) - 1).to(stacked.dtype)
    return stacked


def mc_grid(stacked, res, refs, mv, dirm, sel, *, is_luma, sx, sy, bd, W,
            H):
    """MC + residual add for every inter sample of one component, in place.

    stacked, res: [B, Hp, Wp] int32 planes and residual planes; refs:
    [R, H, W] int32 reference planes; mv: [B, h4, w4, 2, 2] int16 (list,
    x/y) in luma 4x4 cells; dirm: [B, h4, w4] int8 inter direction (0 not
    inter, 1 L0, 2 L1, 3 bi); sel: [B, h4, w4, 2] int16 index into refs.
    sx, sy: the component's chroma shifts; W, H its picture size.
    """
    if not stacked.is_cuda:
        return mc_grid_plain(stacked, res, refs, mv, dirm, sel,
                             is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=W, H=H)
    dev = stacked.device
    check(stacked, "stacked", torch.int32, 3)
    check(res, "res", torch.int32, 3, dev)
    check(refs, "refs", torch.int32, 3, dev)
    check(mv, "mv", torch.int16, 5, dev)
    check(dirm, "dirm", torch.int8, 3, dev)
    check(sel, "sel", torch.int16, 4, dev)
    B, Hp, Wp = stacked.shape
    R = refs.shape[0]
    _, h4, w4 = dirm.shape
    if res.shape != stacked.shape or tuple(refs.shape[1:]) != (H, W) or \
            R < 1 or mv.shape != (B, h4, w4, 2, 2) or \
            sel.shape != (B, h4, w4, 2) or dirm.shape[0] != B or \
            H > Hp or W > Wp or not 8 <= bd <= 16:
        raise ValueError("mc_grid: inconsistent plane/map shapes")
    if mv.data_ptr() % 8 or sel.data_ptr() % 4:
        raise ValueError("mc_grid: mv must be 8-byte and sel 4-byte aligned")
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    _K5(ptr(stacked), ptr(res), ptr(refs), ptr(mv), ptr(dirm), ptr(sel),
        B, Hp, Wp, R, H, W, h4, w4, sx, sy, taps, fbx, fby, bd)
    return stacked


# ---------------------------------------------------------------------------
# K6: MC of a list of 4x4 blocks, plain or weighted epilogue
_K6 = Kernel("mc_weighted", [P, P, P, P, P] + [I] * 15)
TILE = 16                     # samples a side of K6's tiles (csrc/mc.cu kTile)


def tile_groups(blk, *, B, Hp, Wp):
    """K6's grouping of a block table by 16x16-sample tile of the
    component: (rows, groups).

    blk: a tensor, grouped on its device, or a numpy array (the decode's
    host tables: numpy's sort is cheaper there than torch's CPU one); rows
    and groups come back as the same kind.  rows: blk's rows ordered by
    (picture, tile row, tile column, y, x); groups: int32, the first row of
    each tile's run, then N: [G + 1] for numpy arrays and CPU tensors,
    [N + 1] padded with N for CUDA ones (counting the runs would wait for
    the device).  Rows of pictures or tiles beyond the plane (blocks the
    kernel drops) share border runs.  Index preparation only.
    """
    N = blk.shape[0]
    host = isinstance(blk, np.ndarray)
    if N == 0:
        return blk, np.zeros(1, np.int32) if host else \
            torch.zeros(1, dtype=torch.int32, device=blk.device)
    b, x, y = (blk[:, i].astype(np.int64) if host else blk[:, i].long()
               for i in range(3))
    clip = np.clip if host else torch.clamp
    nty = (Hp + TILE - 1) // TILE + 2
    ntx = (Wp + TILE - 1) // TILE + 2
    tile = ((clip(b, -1, B) + 1) * nty + clip(y // TILE, -1, nty - 2) +
            1) * ntx + clip(x // TILE, -1, ntx - 2) + 1
    key = (tile * TILE + y % TILE) * TILE + x % TILE
    if host:
        order = np.argsort(key, kind="stable")
        tile = tile[order]
        starts = np.flatnonzero(np.r_[True, tile[1:] != tile[:-1]])
        return blk[order], np.r_[starts, N].astype(np.int32)
    dev = blk.device
    key, order = torch.sort(key, stable=True)
    tile = key // (TILE * TILE)
    start = torch.ones(N, dtype=torch.bool, device=dev)
    start[1:] = tile[1:] != tile[:-1]
    run = torch.cumsum(start, 0) - 1
    groups = torch.full((N + 1,), N, dtype=torch.int64, device=dev)
    groups.scatter_reduce_(0, run, torch.arange(N, device=dev), "amin")
    if not blk.is_cuda:
        groups = groups[:int(run[-1]) + 2]
    return blk[order], groups.to(torch.int32)


def mc_weighted_plain(stacked, res, refs, blk, *, is_luma, sx, sy, bd, wp,
                      denom, W, H, groups=None):
    """Plain torch version of mc_weighted (any device), in place.

    Computes what libhm_tpu/parallel/dag_decode.py _mc_scatter_fn computes
    (epi "wp" when wp, else "plain").  Blocks do not overlap, so neither
    the order of the rows nor their runs (`groups`, not read) matter.
    """
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    dev = stacked.device
    B, Hp, Wp = stacked.shape
    blkw, blkh = 4 >> sx, 4 >> sy
    p0, p1 = (predict(refs, blk[:, 8 + l], blk[:, 2], blk[:, 1],
                      blk[:, 4 + 2 * l], blk[:, 5 + 2 * l], blkh, blkw,
                      taps=taps, fbx=fbx, fby=fby, bd=bd) for l in range(2))
    f = {k: blk[:, i][:, None, None] for i, k in enumerate(BLK_FIELDS)}
    y = f["y"] + torch.arange(blkh, device=dev, dtype=torch.int32)[:, None]
    x = f["x"] + torch.arange(blkw, device=dev, dtype=torch.int32)[None, :]
    if wp:
        uni0 = weighted_uni(p0, f["w0"], f["o0"], denom, bd)
        uni1 = weighted_uni(p1, f["w1"], f["o1"], denom, bd)
        bi = weighted_bi(p0, p1, f["w0"], f["o0"], f["w1"], f["o1"], denom,
                         bd)
    else:
        uni0, uni1, bi = uni_round(p0, bd), uni_round(p1, bd), \
            bi_average(p0, p1, bd)
    d = f["dir"]
    pred = torch.where(d == 3, bi, torch.where(d == 1, uni0, uni1))
    b = f["b"].expand(pred.shape).long()
    y = y.expand(pred.shape).long()
    x = x.expand(pred.shape).long()
    # blocks past the plane are dropped, as the JAX scatter's mode="drop"
    keep = (b >= 0) & (b < B) & (y >= 0) & (y < Hp) & (x >= 0) & (x < Wp)
    b, y, x = b[keep], y[keep], x[keep]
    out = torch.clamp(pred[keep] + res[b, y, x], 0, (1 << bd) - 1)
    stacked[b, y, x] = out.to(stacked.dtype)
    return stacked


def mc_weighted(stacked, res, refs, blk, *, is_luma, sx, sy, bd, wp, denom,
                W, H, groups=None, _ctas=0):
    """MC + residual add for a list of 4x4 blocks of one component, in
    place.

    stacked, res: [B, Hp, Wp] int32; refs: [R, H, W] int32; blk: [N, 14]
    int32 rows of BLK_FIELDS (picture, block position in the component,
    direction, MVs, reference indices, WP weights and offsets, the offsets
    already at the sample's scale, << WpOffsetBdShift).  wp: weighted
    epilogue with log2 denominator `denom`, else the default one.  The
    component picks the kernel: luma takes its rows in runs (groups: int32
    starts of runs of consecutive rows, then N; any partition of the rows is
    right, and runs of one 16x16 tile each, as tile_groups makes them, are
    what its shared-memory forms need; None groups the rows by tile here, on
    their device); chroma takes one thread a sample of the rows in any order
    and reads no groups.  _ctas > 0 caps the luma kernel's grid (a test of
    its grid-stride walk).
    """
    if not stacked.is_cuda:
        return mc_weighted_plain(stacked, res, refs, blk, is_luma=is_luma,
                                 sx=sx, sy=sy, bd=bd, wp=wp, denom=denom,
                                 W=W, H=H)
    dev = stacked.device
    check(stacked, "stacked", torch.int32, 3)
    check(res, "res", torch.int32, 3, dev)
    check(refs, "refs", torch.int32, 3, dev)
    check(blk, "blk", torch.int32, 2, dev)
    B, Hp, Wp = stacked.shape
    R = refs.shape[0]
    if res.shape != stacked.shape or tuple(refs.shape[1:]) != (H, W) or \
            R < 1 or blk.shape[1] != len(BLK_FIELDS) or \
            not 8 <= bd <= 16 or not 0 <= denom <= 7:
        raise ValueError("mc_weighted: inconsistent shapes")
    if not is_luma:
        groups = None
    elif groups is None:
        blk, groups = tile_groups(blk, B=B, Hp=Hp, Wp=Wp)
    else:
        check(groups, "groups", torch.int32, 1, dev)
        if blk.shape[0] and groups.shape[0] < 2:
            raise ValueError("mc_weighted: groups holds no run")
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    _K6(ptr(stacked), ptr(res), ptr(refs), ptr(blk), ptr(groups),
        blk.shape[0], 0 if groups is None else groups.shape[0] - 1, B, Hp,
        Wp, R, H, W, taps, fbx, fby, bd, int(wp), denom, _ctas)
    return stacked
