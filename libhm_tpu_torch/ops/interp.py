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
                 (WP) uni/bi epilogue (K6, csrc/mc.cu)

Both write the predicted-plus-residual samples into the stacked planes in
place: csrc/mc.cu for CUDA planes, the plain torch versions for CPU planes.
Integer arithmetic throughout; signed `>>` is arithmetic, as in JAX.
"""
import torch

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


def _headroom(bd):
    return max(2, IF_PREC - bd)


def predict(refs, sel, y, x, mvx, mvy, *, taps, fbx, fby, bd):
    """14-bit (is_last=False) prediction of one list, plain torch.

    refs: [R, H, W] int32 reference planes of one component; sel, y, x,
    mvx, mvy: broadcastable integer tensors per output sample (reference
    index, sample position, MV in 1/(1<<fb) units).  The four cases of
    mc_blocks (copy, h only, v only, h then v) with its shifts and offsets.
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
    ix = x + (mvx >> fbx)
    iy = y + (mvy >> fby)
    base = torch.clamp(sel.long(), 0, R - 1) * (H * W)
    flat = refs.reshape(-1)
    cols = [torch.clamp(ix + k - half, 0, W - 1).long() for k in range(taps)]
    rows = [base + torch.clamp(iy + k - half, 0, H - 1).long() * W
            for k in range(taps)]
    cfx = tab[fx.long()]
    cfy = tab[fy.long()]
    s1 = 6 - headroom
    o1 = -(IF_OFFS << s1)

    def hrow(k):
        acc = sum(cfx[..., j] * flat[rows[k] + cols[j]] for j in range(taps))
        return (acc + o1) >> s1
    copy = (flat[rows[half] + cols[half]] << headroom) - IF_OFFS
    h_only = hrow(half)
    v_only = (sum(cfy[..., k] * flat[rows[k] + cols[half]]
                  for k in range(taps)) + o1) >> s1
    hv = sum(cfy[..., k] * hrow(k) for k in range(taps)) >> 6
    fxb, fyb = fx != 0, fy != 0
    return torch.where(fxb & fyb, hv, torch.where(
        fxb, h_only, torch.where(fyb, v_only, copy)))


def uni_round(p, bd):
    """Default uni-prediction epilogue: 14-bit -> samples."""
    headroom = _headroom(bd)
    off = 1 << (headroom - 1)
    return torch.clamp((p + IF_OFFS + off) >> headroom, 0, (1 << bd) - 1)


def bi_average(p0, p1, bd):
    shift = IF_PREC + 1 - bd
    off = (1 << (shift - 1)) + 2 * IF_OFFS
    return torch.clamp((p0 + p1 + off) >> shift, 0, (1 << bd) - 1)


def weighted_uni(p, w, o, log2d, bd):
    """p: 14-bit samples; w, o broadcast against p (o already scaled by
    1 << (bd - 8))."""
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
    B, Hp, Wp = stacked.shape
    h4, w4 = dirm.shape[1:]
    py = torch.arange(Hp, device=dev, dtype=torch.int32)
    px = torch.arange(Wp, device=dev, dtype=torch.int32)
    cy = torch.clamp((py << sy) >> 2, max=h4 - 1).long()[:, None]
    cx = torch.clamp((px << sx) >> 2, max=w4 - 1).long()[None, :]
    d = dirm.to(torch.int32)[:, cy, cx]                      # [B, Hp, Wp]
    # padding rows/cols beyond the component size never code inter
    valid = (py[:, None] < H) & (px[None, :] < W)
    d = torch.where(valid[None], d, 0)
    y = py[None, :, None]
    x = px[None, None, :]
    preds = []
    for l in range(2):
        mvl = mv[:, cy, cx, l]                               # [B, Hp, Wp, 2]
        preds.append(predict(refs, sel[:, cy, cx, l], y, x, mvl[..., 0],
                             mvl[..., 1], taps=taps, fbx=fbx, fby=fby, bd=bd))
    p0, p1 = preds
    pred = torch.where(d == 3, bi_average(p0, p1, bd), torch.where(
        d == 1, uni_round(p0, bd), uni_round(p1, bd)))
    out = torch.clamp(pred + res, 0, (1 << bd) - 1)
    stacked.copy_(torch.where(d > 0, out, stacked))
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
            H > Hp or W > Wp or not 8 <= bd <= 12:
        raise ValueError("mc_grid: inconsistent plane/map shapes")
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    _K5(ptr(stacked), ptr(res), ptr(refs), ptr(mv), ptr(dirm), ptr(sel),
        B, Hp, Wp, R, H, W, h4, w4, sx, sy, taps, fbx, fby, bd)
    return stacked


# ---------------------------------------------------------------------------
# K6: MC of a list of 4x4 blocks, plain or weighted epilogue
_K6 = Kernel("mc_weighted", [P, P, P, P] + [I] * 13)


def mc_weighted_plain(stacked, res, refs, blk, *, is_luma, sx, sy, bd, wp,
                      denom, W, H):
    """Plain torch version of mc_weighted (any device), in place.

    Computes what libhm_tpu/parallel/dag_decode.py _mc_scatter_fn computes
    (epi "wp" when wp, else "plain").
    """
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    dev = stacked.device
    B, Hp, Wp = stacked.shape
    blkw, blkh = 4 >> sx, 4 >> sy
    f = {k: blk[:, i][:, None, None] for i, k in enumerate(BLK_FIELDS)}
    y = f["y"] + torch.arange(blkh, device=dev, dtype=torch.int32)[:, None]
    x = f["x"] + torch.arange(blkw, device=dev, dtype=torch.int32)[None, :]
    p0 = predict(refs, f["sel0"], y, x, f["mv0x"], f["mv0y"], taps=taps,
                 fbx=fbx, fby=fby, bd=bd)
    p1 = predict(refs, f["sel1"], y, x, f["mv1x"], f["mv1y"], taps=taps,
                 fbx=fbx, fby=fby, bd=bd)
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
                W, H):
    """MC + residual add for a list of 4x4 blocks of one component, in
    place.

    stacked, res: [B, Hp, Wp] int32; refs: [R, H, W] int32; blk: [N, 14]
    int32 rows of BLK_FIELDS (picture, block position in the component,
    direction, MVs, reference indices, WP weights and offsets, the offsets
    already scaled by 1 << (bd - 8)).  wp: weighted epilogue with log2
    denominator `denom`, else the default one.
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
            not 8 <= bd <= 12 or not 0 <= denom <= 7:
        raise ValueError("mc_weighted: inconsistent shapes")
    taps, fbx, fby = _filter_args(is_luma, sx, sy)
    _K6(ptr(stacked), ptr(res), ptr(refs), ptr(blk), blk.shape[0], B, Hp,
        Wp, R, H, W, taps, fbx, fby, bd, int(wp), denom)
    return stacked
