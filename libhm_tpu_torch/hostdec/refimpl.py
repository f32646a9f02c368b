# Copied from libhm_tpu/hostdec/refimpl.py
"""Numpy reference reconstruction — bit-exact scalar oracle.

Each function mirrors one dense stage of the reference decoder:
  dequant            <- TComTrQuant::xDeQuant (TComTrQuant.cpp:1203)
  inverse_transform  <- xITrMxN / partialButterflyInverse* (TComTrQuant.cpp:387-944)
  intra predict      <- TComPrediction::predIntraAng/Planar/DC (TComPrediction.cpp:245-845)
  fill_reference     <- TComPattern::fillReferenceSamples (TComPattern.cpp:310)

The JAX/Pallas kernels in libhm_tpu/ops are verified against these on real
bitstreams; these in turn are verified against the HM binaries via the
decoded-picture-hash oracle.

Extended precision (max_dyn_range > 15) follows H.265 8.6.2-8.6.4: the
dequant's input clip and the stage-1 clip are to +-2^max_dyn_range (HM's
build with a 64-bit intermediate, which decodes such streams), and the
residual, transform skip and RDPCM are not clipped to int16.
"""
import numpy as np
from .tables import DCT, DST4, INV_QUANT_SCALES

I16MIN, I16MAX = -32768, 32767


def dequant(coeffs, qp, log2_size, bit_depth, scaling=None,
            transform_skip_flat_shift=False, max_dyn_range=15):
    """Inverse quantisation, int32 in/out. qp includes bit-depth offset."""
    per, rem = qp // 6, qp % 6
    tshift = max_dyn_range - bit_depth - log2_size
    tmin, tmax = -(1 << max_dyn_range), (1 << max_dyn_range) - 1
    c = coeffs.astype(np.int64)
    if scaling is None:
        scale = int(INV_QUANT_SCALES[rem])
        right = 6 - (tshift + per)
        target_bits = min(max_dyn_range + 1, 32 + right - 7) \
            if max_dyn_range == 15 else max_dyn_range + 1
        lo, hi = -(1 << (target_bits - 1)), (1 << (target_bits - 1)) - 1
        c = np.clip(c, lo, hi)
        if right > 0:
            q = (c * scale + (1 << (right - 1))) >> right
        else:
            q = (c * scale) << (-right)
    else:
        # scaling-list path: dequantCoef = listCoef * invQuantScale[rem]
        right = 6 - (tshift + per) + 4  # + LOG2_SCALING_LIST_NEUTRAL_VALUE
        dq = scaling.astype(np.int64) * int(INV_QUANT_SCALES[rem])
        # dequantCoefBits = 1 + IQUANT_SHIFT + SCALING_LIST_BITS = 15
        target_bits = min(max_dyn_range + 1, 32 + right - 15) \
            if max_dyn_range == 15 else max_dyn_range + 1
        lo, hi = -(1 << (target_bits - 1)), (1 << (target_bits - 1)) - 1
        c = np.clip(c, lo, hi)
        if right > 0:
            q = (c * dq + (1 << (right - 1))) >> right
        else:
            q = (c * dq) << (-right)
    return np.clip(q, tmin, tmax).astype(np.int32)


def inverse_transform(coeffs, use_dst, bit_depth, max_dyn_range=15):
    """2-D inverse core transform; int32 [h, w] -> int16-range residual
    (stage 1 clipped to +-2^max_dyn_range and no clip after stage 2 when
    max_dyn_range > 15)."""
    h, w = coeffs.shape
    ty = DST4 if (use_dst and h == 4) else DCT[h]
    tx = DST4 if (use_dst and w == 4) else DCT[w]
    shift1 = 7
    shift2 = 20 - bit_depth if max_dyn_range == 15 else \
        (6 + max_dyn_range - 1) - bit_depth
    c = coeffs.astype(np.int64)
    # stage 1: columns (vertical inverse)
    t1 = (ty.T.astype(np.int64) @ c + (1 << (shift1 - 1))) >> shift1
    if max_dyn_range == 15:
        t1 = np.clip(t1, I16MIN, I16MAX)
    else:
        t1 = np.clip(t1, -(1 << max_dyn_range), (1 << max_dyn_range) - 1)
    # stage 2: rows (horizontal inverse)
    t2 = (t1 @ tx.astype(np.int64) + (1 << (shift2 - 1))) >> shift2
    if max_dyn_range == 15:
        t2 = np.clip(t2, I16MIN, I16MAX)
    return t2.astype(np.int32)


def inverse_transform_skip(coeffs, bit_depth, log2w, max_dyn_range=15,
                           rotate=False):
    """Transform-skip rescaling (reference xITransformSkip)."""
    tshift = max_dyn_range - bit_depth - log2w
    c = coeffs.astype(np.int64)
    if rotate:
        c = c[::-1, ::-1]
    # inverse of the forward '<< tshift' scaling (reference xITransformSkip)
    if tshift >= 0:
        off = 0 if tshift == 0 else (1 << (tshift - 1))
        r = (c + off) >> tshift
    else:
        r = c << (-tshift)
    if max_dyn_range == 15:
        r = np.clip(r, I16MIN, I16MAX)
    return r.astype(np.int32)


def inverse_rdpcm(res, mode, clip=True):
    """Residual DPCM accumulation (reference invRdpcmNxN); clip: to int16
    (H.265 has none: extended precision passes False)."""
    out = res.astype(np.int64)
    if mode == 1:  # horizontal
        out = np.cumsum(out, axis=1)
    elif mode == 2:  # vertical
        out = np.cumsum(out, axis=0)
    if clip:
        out = np.clip(out, I16MIN, I16MAX)
    return out.astype(np.int32)


def residual_for_tu(tu, sps, scaling_lists=None, is_intra=True):
    """Full dequant + inverse transform for one TransformUnit.

    is_intra: residual rotation applies only to intra 4x4 blocks
    (reference TComTU::isNonTransformedResidualRotated, TComTU.cpp:227).
    """
    bd = sps.bit_depth_luma if tu.comp == 0 else sps.bit_depth_chroma
    max_dyn = 15 if not sps.extended_precision else max(15, bd + 6)
    log2w = tu.w.bit_length() - 1
    do_rotate = bool(sps.transform_skip_rotation) and tu.w == 4 and is_intra
    if tu.tq_bypass:
        res = tu.coeffs.copy()
        if do_rotate:
            res = res[::-1, ::-1]
        if tu.rdpcm_mode:
            res = inverse_rdpcm(res, tu.rdpcm_mode, max_dyn == 15)
        return res
    scaling = None
    if scaling_lists is not None:
        scaling = scaling_lists.get(tu, None)
    deq = dequant(tu.coeffs, tu.qp, log2w, bd, scaling, max_dyn_range=max_dyn)
    if tu.transform_skip:
        res = inverse_transform_skip(deq, bd, log2w, max_dyn, do_rotate)
        if tu.rdpcm_mode:
            res = inverse_rdpcm(res, tu.rdpcm_mode, max_dyn == 15)
        return res
    return inverse_transform(deq, tu.use_dst, bd, max_dyn)


# ---------------------------------------------------------------------------
# Intra prediction
# ---------------------------------------------------------------------------
ANG_TABLE = [0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
             -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21,
             26, 32]
INV_ANG_TABLE = [0, 0, 256, 315, 390, 482, 630, 910, 1638, 4096]  # 8192/angle


def fill_reference_samples(recon, avail_map, x, y, size, bit_depth):
    """Reference sample array for an intra block (Rec. H.265 8.4.4.2.2).

    recon: component plane being reconstructed (int32)
    avail_map: callable(unit_x, unit_y) -> bool at 1-sample granularity for
      the border positions; units handled by caller at 4-sample granularity.
    Returns (top_row[2*size+1], left_col[2*size+1]) where index 0 is the
    corner sample shared by both.
    """
    n = size
    total = 4 * n + 1
    # border coordinates in order: bottom-left (x-1, y+2n-1) .. up .. corner
    # (x-1, y-1) .. right .. (x+2n-1, y-1)
    coords = [(x - 1, y + 2 * n - 1 - i) for i in range(2 * n)] + \
             [(x - 1, y - 1)] + \
             [(x + i, y - 1) for i in range(2 * n)]
    avail = np.array([avail_map(cx, cy) for (cx, cy) in coords], dtype=bool)
    vals = np.zeros(total, np.int32)
    dc = 1 << (bit_depth - 1)
    if not avail.any():
        vals[:] = dc
    else:
        # copy available
        for i, (cx, cy) in enumerate(coords):
            if avail[i]:
                vals[i] = recon[cy, cx]
        # substitution: scan from index 0 upward (spec: from bottom-left)
        if not avail[0]:
            j = 1
            while j < total and not avail[j]:
                j += 1
            vals[0] = vals[j]
        for i in range(1, total):
            if not avail[i]:
                vals[i] = vals[i - 1]
    left = vals[:2 * n + 1][::-1]   # left[0] = corner, left[1..2n] downwards
    top = vals[2 * n:]              # top[0] = corner, top[1..2n] rightwards
    return top, left


def filter_reference_samples(top, left, size, mode, bit_depth,
                             strong_smoothing_enabled):
    """[1 2 1] smoothing + optional strong bilinear filter (Rec. 8.4.4.2.3)."""
    n = size
    corner = top[0]
    full = np.concatenate([left[1:][::-1], [corner], top[1:]]).astype(np.int32)
    if strong_smoothing_enabled and n == 32:
        bd = bit_depth
        thr = 1 << (bd - 5)
        flag1 = abs(int(corner) + int(top[2 * n]) - 2 * int(top[n])) < thr
        flag2 = abs(int(corner) + int(left[2 * n]) - 2 * int(left[n])) < thr
        if flag1 and flag2:
            out = np.empty_like(full)
            # bilinear: left column then top row
            bl = int(left[2 * n])
            tr = int(top[2 * n])
            c = int(corner)
            lcol = np.array([((2 * n - 1 - i) * c + (i + 1) * bl + n) >> 6
                             for i in range(2 * n)], np.int32)
            trow = np.array([((2 * n - 1 - i) * c + (i + 1) * tr + n) >> 6
                             for i in range(2 * n)], np.int32)
            new_left = np.concatenate([[c], lcol])
            new_top = np.concatenate([[c], trow])
            new_left[2 * n] = bl
            new_top[2 * n] = tr
            return new_top, new_left
    # [1 2 1]
    sm = np.empty_like(full)
    sm[0] = full[0]
    sm[-1] = full[-1]
    sm[1:-1] = (full[:-2] + 2 * full[1:-1] + full[2:] + 2) >> 2
    new_left = np.concatenate([[sm[2 * n]], sm[:2 * n][::-1]])
    new_top = sm[2 * n:]
    return new_top, new_left


def use_filtered_refs(comp, size, mode, sps):
    """Reference-smoothing decision (reference TComPattern / spec 8.4.4.2.3)."""
    if sps.intra_smoothing_disabled:
        return False
    if comp != 0 and sps.chroma_format_idc != 3:
        return False
    if mode == 1 or size == 4:  # DC or 4x4
        return False
    if mode == 0:  # planar: filtered when size >= 8
        return size >= 8
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thr = {8: 7, 16: 1, 32: 0, 64: 0}.get(size, 10)
    return min_dist > thr


def predict_intra(top, left, size, mode, comp, bit_depth, sps,
                  disable_boundary_filters=False):
    """Intra sample prediction (Rec. H.265 8.4.4.2.4-6)."""
    n = size
    maxv = (1 << bit_depth) - 1
    if mode == 0:  # PLANAR
        t = top[1:n + 1].astype(np.int64)
        l = left[1:n + 1].astype(np.int64)
        tr = int(top[n + 1])
        bl = int(left[n + 1])
        xx = np.arange(n, dtype=np.int64)
        yy = np.arange(n, dtype=np.int64)
        hor = (n - 1 - xx)[None, :] * l[:, None] + (xx + 1)[None, :] * tr
        ver = (n - 1 - yy)[:, None] * t[None, :] + (yy + 1)[:, None] * bl
        log2n = n.bit_length() - 1
        return ((hor + ver + n) >> (log2n + 1)).astype(np.int32)
    if mode == 1:  # DC
        dc = (int(top[1:n + 1].sum()) + int(left[1:n + 1].sum()) + n) >> \
            (n.bit_length() - 1 + 1)
        pred = np.full((n, n), dc, np.int32)
        # DC boundary filtering is NOT gated by the RDPCM/lossless edge-filter
        # disable (reference xDCPredFiltering is called unconditionally,
        # TComPrediction.cpp:485)
        if comp == 0 and n < 32:
            pred[0, 0] = (int(left[1]) + 2 * dc + int(top[1]) + 2) >> 2
            pred[0, 1:] = (top[2:n + 1] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[2:n + 1] + 3 * dc + 2) >> 2
        return pred
    # angular
    ang = ANG_TABLE[mode]
    vertical = mode >= 18
    main = top if vertical else left
    side = left if vertical else top
    if ang < 0:
        inv = INV_ANG_TABLE[abs(ANG_TABLE[mode]) // 2 if False else 0]
        # invAngle indexed by mode distance; use table by |angle|
        inv_map = {-2: 4096, -5: 1638, -9: 910, -13: 630, -17: 482,
                   -21: 390, -26: 315, -32: 256}
        inv = inv_map[ang]
        ref = np.zeros(2 * n + 1, np.int32)
        ref[n:] = main[0:n + 1]  # ref[n + i] = main[i], i in 0..n
        # projected side samples for negative indices
        lo = (n * ang) >> 5
        for i in range(-1, lo - 1, -1):
            ref[n + i] = side[min((-i * inv + 128) >> 8, 2 * n)]
        base_idx = n
    else:
        ref = main.copy()  # ref[i] = main[i], need up to 2n
        base_idx = 0
    pred = np.zeros((n, n), np.int32)
    for j in range(n):
        pos = (j + 1) * ang
        int_off = pos >> 5
        frac = pos & 31
        idx = base_idx + 1 + int_off
        row = ref[idx: idx + n]
        if frac:
            row2 = ref[idx + 1: idx + n + 1]
            vals = ((32 - frac) * row.astype(np.int64) +
                    frac * row2.astype(np.int64) + 16) >> 5
        else:
            vals = row.astype(np.int64)
        if vertical:
            pred[j, :] = vals
        else:
            pred[:, j] = vals
    # boundary filter for exactly horizontal/vertical
    if comp == 0 and n < 32 and not disable_boundary_filters:
        if mode == 26:  # vertical: filter first column
            delta = ((left[1:n + 1].astype(np.int64) - int(top[0])) >> 1)
            pred[:, 0] = np.clip(top[1] + delta, 0, maxv)
        elif mode == 10:  # horizontal: filter first row
            delta = ((top[1:n + 1].astype(np.int64) - int(left[0])) >> 1)
            pred[0, :] = np.clip(left[1] + delta, 0, maxv)
    return pred.astype(np.int32)
