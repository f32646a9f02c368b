"""Plain reference of HEVC intra reconstruction: one component of one
intra picture, block after block in decoding order, in plain torch
(int64), after Rec. ITU-T H.265 8.4.4.2 (general intra sample
prediction) and 8.6.7 (picture construction).

    plane = reconstruct(blocks, width=W, height=H, bit_depth=10, c_idx=0)

`blocks` lists the component's transform blocks in decoding order, each
a Block: its top-left sample (x, y) in the component's plane, its size
n (nTbS), the intra prediction mode it predicts with (0 planar, 1 DC,
2..34 angular), its residual (n x n, the output of scaling and
transformation, resSamples) and its cu_transquant_bypass_flag.  For each
block:

1. the 4n + 1 neighbouring samples p[-1][y] (y = -1..2n-1) and p[x][-1]
   (x = 0..2n-1), their availability, and the substitution of those not
   available (8.4.4.2.2);
2. filterFlag and the [1 2 1] or strong (biIntFlag) filter (8.4.4.2.3);
3. planar (8.4.4.2.4), DC with its edge filter (8.4.4.2.5) or angular
   with the edge filters of modes 10 and 26 (8.4.4.2.6);
4. recSamples = Clip1(predSamples + resSamples) (8.6.7).

Departures from the text, each noted where it acts:
- availability (6.4.1) compares z-scan addresses of minimum transform
  blocks; here a neighbouring sample is available when it lies in the
  picture, in the current block's slice and tile, was reconstructed by
  an earlier block of the list (and, with constrained_intra_pred_flag,
  lies in an intra-coded block).  For blocks given in decoding order,
  reconstructed earlier is earlier in z-scan order;
- the mode is the one the block predicts with: for 4:2:2 chroma, after
  the mapping of Table 8-3 (8.4.3), which the caller applies;
- the DC edge filter applies whatever disableIntraBoundaryFilter, as HM's
  decoder does (xDCPredFiltering); the edge filters of modes 10 and 26
  follow it.

This file holds no levels, tables or lattice, and imports nothing of the
program.
"""
from collections import namedtuple

import torch

Block = namedtuple("Block", "x y n mode residual bypass",
                   defaults=(False,))

# Table 8-4: intraPredAngle of modes 2..34
INTRA_PRED_ANGLE = dict(zip(range(2, 35), (
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32)))
# Table 8-5: invAngle of modes 11..25
INV_ANGLE = dict(zip(range(11, 26), (
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482,
    -630, -910, -1638, -4096)))
# 8.4.4.2.3: intraHorVerDistThres[nTbS]
DIST_THRES = {8: 7, 16: 1, 32: 0}

I64 = torch.int64


def reconstruct(blocks, *, width, height, bit_depth, c_idx,
                chroma_array_type=1, strong_intra_smoothing=False,
                intra_smoothing_disabled=False, implicit_rdpcm=False,
                constrained_intra_pred=False, slice_id=None, tile_id=None,
                intra=None, plane=None):
    """The component's plane [height, width] (int64) after the blocks.

    slice_id, tile_id: [height, width] integer maps of the slice
    (SliceAddrRs) and tile of each sample of the component, or None for
    one slice and one tile; intra: [height, width] bool map of the samples
    in intra-coded blocks (read with constrained_intra_pred; None: every
    sample); plane: the samples before the blocks (None: zeros)."""
    shape = (height, width)
    plane = torch.zeros(shape, dtype=I64) if plane is None else \
        torch.as_tensor(plane, dtype=I64).clone()
    done = torch.zeros(shape, dtype=torch.bool)
    maxv = (1 << bit_depth) - 1
    for blk in blocks:
        n = blk.n
        x0, y0 = blk.x, blk.y
        left, top = _neighbours(plane, done, blk, bit_depth, slice_id,
                                tile_id, intra if constrained_intra_pred
                                else None)
        if _filter_flag(blk.mode, n, c_idx, chroma_array_type,
                        intra_smoothing_disabled):
            left, top = _filtered(left, top, n, bit_depth,
                                  strong_intra_smoothing and c_idx == 0)
        # 8.4.4.2.6: disableIntraBoundaryFilter
        no_edge = implicit_rdpcm and blk.bypass
        pred = _predict(left, top, n, blk.mode, c_idx, maxv, no_edge)
        res = torch.as_tensor(blk.residual, dtype=I64)
        plane[y0:y0 + n, x0:x0 + n] = torch.clamp(pred + res, 0, maxv)
        done[y0:y0 + n, x0:x0 + n] = True
    return plane


def _neighbours(plane, done, blk, bit_depth, slice_id, tile_id, intra):
    """8.4.4.2.2: left[k] = p[-1][k - 1] (k = 0..2n) and top[k] = p[k -
    1][-1] (k = 0..2n), both starting at the corner p[-1][-1], after
    substitution."""
    n, x0, y0 = blk.n, blk.x, blk.y
    H, W = plane.shape
    k = torch.arange(2 * n, dtype=I64)
    # the order of the substitution's search: p[-1][2n-1] up to p[-1][-1],
    # then p[0][-1] to p[2n-1][-1]
    xs = torch.cat([torch.full((2 * n + 1,), x0 - 1, dtype=I64), x0 + k])
    ys = torch.cat([y0 + 2 * n - 1 - k, torch.tensor([y0 - 1]),
                    torch.full((2 * n,), y0 - 1, dtype=I64)])
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    xc, yc = xs.clamp(0, W - 1), ys.clamp(0, H - 1)
    avail = inside & done[yc, xc]
    if slice_id is not None:
        avail &= slice_id[yc, xc] == slice_id[y0, x0]
    if tile_id is not None:
        avail &= tile_id[yc, xc] == tile_id[y0, x0]
    if intra is not None:
        avail &= intra[yc, xc]
    if not bool(avail.any()):
        p = torch.full((4 * n + 1,), 1 << (bit_depth - 1), dtype=I64)
    else:
        # p[-1][2n-1] missing: the first available in the search order;
        # every other missing one: the one before it in that order
        order = torch.arange(4 * n + 1, dtype=I64)
        last = torch.cummax(torch.where(avail, order, -1), dim=0).values
        first = int(torch.nonzero(avail)[0, 0])
        p = plane[yc, xc][torch.where(last < 0, first, last)]
    return torch.flip(p[:2 * n + 1], (0,)), p[2 * n:]


def _filter_flag(mode, n, c_idx, chroma_array_type, smoothing_disabled):
    """8.4.4.2.3 (invoked when intra_smoothing_disabled_flag is 0 and
    cIdx is 0 or ChromaArrayType is 3): filterFlag."""
    if smoothing_disabled or (c_idx != 0 and chroma_array_type != 3):
        return False
    if mode == 1 or n == 4:
        return False
    return min(abs(mode - 26), abs(mode - 10)) > DIST_THRES[n]


def _filtered(left, top, n, bit_depth, strong_enabled):
    """8.4.4.2.3: pF, by the bi-linear (biIntFlag) or the [1 2 1] filter.
    strong_enabled: strong_intra_smoothing_enabled_flag and cIdx 0."""
    corner = left[0]
    if strong_enabled and n == 32:
        thr = 1 << (bit_depth - 5)
        bi_int = bool(abs(corner + top[2 * n] - 2 * top[n]) < thr) and \
            bool(abs(corner + left[2 * n] - 2 * left[n]) < thr)
        if bi_int:
            y = torch.arange(63, dtype=I64)
            lf, tf = left.clone(), top.clone()
            lf[1:64] = ((63 - y) * corner + (y + 1) * left[64] + 32) >> 6
            tf[1:64] = ((63 - y) * corner + (y + 1) * top[64] + 32) >> 6
            return lf, tf
    lf, tf = left.clone(), top.clone()
    c = (left[1] + 2 * corner + top[1] + 2) >> 2
    lf[1:2 * n] = (left[2:] + 2 * left[1:2 * n] + left[:2 * n - 1] + 2) >> 2
    tf[1:2 * n] = (top[2:] + 2 * top[1:2 * n] + top[:2 * n - 1] + 2) >> 2
    lf[0] = tf[0] = c
    return lf, tf


def _predict(left, top, n, mode, c_idx, maxv, no_edge):
    """predSamples[y][x] (rows y, columns x) of one block."""
    log2n = n.bit_length() - 1
    i = torch.arange(n, dtype=I64)
    y, x = i[:, None], i[None, :]
    if mode == 0:                                   # 8.4.4.2.4
        return ((n - 1 - x) * left[1 + y] + (x + 1) * top[n + 1] +
                (n - 1 - y) * top[1 + x] + (y + 1) * left[n + 1] + n) >> \
            (log2n + 1)
    if mode == 1:                                   # 8.4.4.2.5
        dc = (top[1:n + 1].sum() + left[1:n + 1].sum() + n) >> (log2n + 1)
        pred = torch.full((n, n), int(dc), dtype=I64)
        if c_idx == 0 and n < 32:
            pred[0, 0] = (left[1] + 2 * dc + top[1] + 2) >> 2
            pred[0, 1:] = (top[2:n + 1] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[2:n + 1] + 3 * dc + 2) >> 2
        return pred
    # 8.4.4.2.6: ref[m] at ref[n + m], m = -n..2n
    angle = INTRA_PRED_ANGLE[mode]
    main, side = (top, left) if mode >= 18 else (left, top)
    ref = torch.zeros(3 * n + 1, dtype=I64)
    ref[n:2 * n + 1] = main[:n + 1]
    if angle < 0:
        if (n * angle) >> 5 < -1:
            for m in range((n * angle) >> 5, 0):
                ref[n + m] = side[(m * INV_ANGLE[mode] + 128) >> 8]
    else:
        ref[2 * n + 1:] = main[n + 1:2 * n + 1]
    # along the prediction: rows y for modes 18..34, columns x for 2..17
    along, across = (y, x) if mode >= 18 else (x, y)
    idx = ((along + 1) * angle) >> 5
    fact = ((along + 1) * angle) & 31
    a = ref[n + across + idx + 1]
    b = ref[(n + across + idx + 2).clamp(max=3 * n)]
    pred = torch.where(fact != 0, ((32 - fact) * a + fact * b + 16) >> 5, a)
    if c_idx == 0 and n < 32 and not no_edge:
        if mode == 26:
            pred[:, 0] = torch.clamp(top[1] + ((left[1:n + 1] - left[0]) >> 1),
                                     0, maxv)
        elif mode == 10:
            pred[0, :] = torch.clamp(left[1] + ((top[1:n + 1] - top[0]) >> 1),
                                     0, maxv)
    return pred
