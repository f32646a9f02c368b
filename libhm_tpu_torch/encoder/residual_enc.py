# Copied from libhm_tpu/encoder/residual_enc.py
"""residual_coding() syntax writing — mirror of hostdec/residual.py.

Rebuild of the reference's TEncSbac::codeCoeffNxN (source/Lib/TLibEncoder/
TEncSbac.cpp) for the encoder's tool profile (no sign hiding, no transform
skip, no RExt adaptations — extended as tools land).
"""
import numpy as np

from ..hostdec.tables import (scan_xy, SCAN_DIAG, SCAN_HOR, SCAN_VER,
                              MIN_IN_GROUP, GROUP_IDX)
from ..hostdec.residual import (grouped_scan, CTX_IND_MAP_4x4, SIG_SET_START,
                                NON_DIAG_8x8_OFFSET, NOT_FIRST_GROUP_OFFSET,
                                COEF_REMAIN_BIN_REDUCTION, C1FLAG_NUMBER)


def encode_last_sig_xy(enc, bank, pos_x, pos_y, w, h, is_chroma, scan_type):
    if scan_type == SCAN_VER:
        pos_x, pos_y = pos_y, pos_x
        w, h = h, w
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if is_chroma:
        off_x, off_y = 15, 15
        shift_x, shift_y = log2w - 2, log2h - 2
    else:
        off_x = 3 * (log2w - 2) + ((log2w - 1) >> 2)
        off_y = 3 * (log2h - 2) + ((log2h - 1) >> 2)
        shift_x, shift_y = (log2w + 1) >> 2, (log2h + 1) >> 2
    gx, gy = int(GROUP_IDX[pos_x]), int(GROUP_IDX[pos_y])
    ctx_x, ctx_y = bank["last_x"], bank["last_y"]
    for i in range(gx):
        enc.encode_bin(ctx_x, off_x + (i >> shift_x), 1)
    if gx < GROUP_IDX[w - 1]:
        enc.encode_bin(ctx_x, off_x + (gx >> shift_x), 0)
    for i in range(gy):
        enc.encode_bin(ctx_y, off_y + (i >> shift_y), 1)
    if gy < GROUP_IDX[h - 1]:
        enc.encode_bin(ctx_y, off_y + (gy >> shift_y), 0)
    if gx > 3:
        n = (gx - 2) >> 1
        enc.encode_bypass_bins(pos_x - int(MIN_IN_GROUP[gx]), n)
    if gy > 3:
        n = (gy - 2) >> 1
        enc.encode_bypass_bins(pos_y - int(MIN_IN_GROUP[gy]), n)


def encode_coef_remain(enc, v, rice):
    """Inverse of read_coef_remain (non-limited path)."""
    if (v >> rice) < COEF_REMAIN_BIN_REDUCTION:
        prefix = v >> rice
        for _ in range(prefix):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        enc.encode_bypass_bins(v & ((1 << rice) - 1), rice)
    else:
        # decoder: prefix of (3+L) ones, then (L+rice) suffix bits with
        # v = ((2^L + 2) << rice) + suffix
        vr = v >> rice
        L = (vr - 2).bit_length() - 1
        for _ in range(COEF_REMAIN_BIN_REDUCTION + L):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        suffix = v - (((1 << L) + COEF_REMAIN_BIN_REDUCTION - 1) << rice)
        enc.encode_bypass_bins(suffix, L + rice)


SBH_THRESHOLD = 4


def apply_sign_hiding(lev, coef, qp, log2n, bit_depth, scan_type,
                      max_dyn_range=15):
    """Parity fix-up for sign-data-hiding (reference signBitHidingHDQ):
    for every 4x4 coefficient group whose nonzero spread is >= 4, the
    decoder derives the sign of the lowest-scan-position coefficient from
    the parity of the absolute sum — adjust one level by +-1 when the
    parity disagrees, choosing the RD-optimal adjustment by the signed
    deltaU rounding-error cost (reference xSignBitHidingHDQ).  Modifies
    lev in place and returns it."""
    h, w = lev.shape
    flat = lev.ravel()
    cflat = coef.ravel()
    scan = grouped_scan(w, h, scan_type)
    per, rem = qp // 6, qp % 6
    from ..hostdec.tables import QUANT_SCALES
    qbits = 14 + per + (max_dyn_range - bit_depth - log2n)
    scale = int(QUANT_SCALES[rem])
    nz_all = np.nonzero(flat[scan])[0]
    last_sub = (int(nz_all[-1]) >> 4) if len(nz_all) else -1
    for sub in range(len(scan) // 16):
        idxs = scan[sub * 16:(sub + 1) * 16]
        levels = flat[idxs]
        nzp = np.nonzero(levels)[0]
        if len(nzp) == 0:
            continue
        first, last = int(nzp[0]), int(nzp[-1])
        if last - first < SBH_THRESHOLD:
            continue
        abs_sum = int(np.abs(levels).sum())
        signbit = 1 if flat[idxs[first]] < 0 else 0
        if signbit == (abs_sum & 1):
            continue
        # RD-optimal +-1 adjustment (reference xSignBitHidingHDQ,
        # TComTrQuant.cpp): deltaU = rounding error of the chosen level
        # in (qbits-8)-shifted levelDouble units; incrementing an
        # under-quantized coefficient (deltaU > 0) GAINS quality, so
        # curCost can be negative.  Zero coefficients may be promoted to
        # +-1; below the first nonzero only when the source sign matches
        # the parity-implied hidden sign (the promoted coefficient
        # becomes the new hidden-sign carrier); in the last coded group
        # never beyond the last position (it would move last_sig).
        min_cost, min_pos, final_change = None, -1, 0
        top = last if sub == last_sub else 15
        for j in range(top, -1, -1):
            blk = int(idxs[j])
            l = int(flat[blk])
            du = (abs(int(cflat[blk])) * scale - (abs(l) << qbits)) \
                >> (qbits - 8)
            if l != 0:
                if du > 0:
                    cur_cost, cur_change = -du, 1
                elif j == first and abs(l) == 1:
                    continue    # never zero the hidden-sign coefficient
                else:
                    cur_cost, cur_change = du, -1
            else:
                if j < first:
                    src_sign = 0 if int(cflat[blk]) >= 0 else 1
                    if src_sign != signbit:
                        continue
                cur_cost, cur_change = -du, 1
            if min_cost is None or cur_cost < min_cost:
                min_cost, min_pos, final_change = cur_cost, blk, cur_change
        if min_pos < 0:
            continue
        l = int(flat[min_pos])
        if l in (32767, -32768):
            final_change = -1
        if int(cflat[min_pos]) >= 0:
            flat[min_pos] = l + final_change
        else:
            flat[min_pos] = l - final_change
    return lev


def encode_residual(enc, bank, coeffs, comp, scan_type, sign_hiding=False,
                    ts=None):
    """Encode one residual block.

    coeffs: [h, w] int32 with at least one nonzero.  With sign_hiding the
    sign of each group's lowest-scan coefficient is omitted when the
    nonzero spread is >= 4 (caller must have parity-fixed the levels via
    apply_sign_hiding).  ts: transform_skip_flag (0/1) when the PPS
    enables the tool and the TU carries the flag (4x4), else None.
    """
    h, w = coeffs.shape
    if ts is not None:
        enc.encode_bin(bank["transform_skip"], 0 if comp == 0 else 1, ts)
    log2w = w.bit_length() - 1
    is_chroma = comp > 0
    ch = 1 if is_chroma else 0
    flat = coeffs.ravel()
    scan = grouped_scan(w, h, scan_type)
    nz_scan = np.nonzero(flat[scan] != 0)[0]
    scan_pos_last = int(nz_scan[-1])
    blk_last = int(scan[scan_pos_last])
    pos_y, pos_x = divmod(blk_last, w)
    encode_last_sig_xy(enc, bank, pos_x, pos_y, w, h, is_chroma, scan_type)

    wg, hg = w >> 2, h >> 2
    scan_cg = scan_xy(wg, hg, scan_type)
    if w == 4 and h == 4:
        first_sig_ctx = SIG_SET_START[ch][0]
    elif w == 8 and h == 8:
        first_sig_ctx = SIG_SET_START[ch][1]
        if scan_type != SCAN_DIAG:
            first_sig_ctx += NON_DIAG_8x8_OFFSET[ch]
    else:
        first_sig_ctx = SIG_SET_START[ch][2]
    sig_base = 0 if not is_chroma else 28
    sig_arr, cg_arr = bank["sig"], bank["sig_cg"]
    gt1_arr, gt2_arr = bank["gt1"], bank["gt2"]

    last_scan_set = scan_pos_last >> 4
    c1 = 1
    sig_cg = np.zeros(wg * hg, np.int32)
    # precompute which CGs have coefficients
    for s in range(last_scan_set + 1):
        sub = flat[scan[s * 16:(s + 1) * 16]]
        cgx, cgy = int(scan_cg[s][0]), int(scan_cg[s][1])
        sig_cg[cgy * wg + cgx] = 1 if (sub != 0).any() else 0
    # the first and last coefficient groups are inferred significant
    sig_cg[int(scan_cg[0][1]) * wg + int(scan_cg[0][0])] = 1
    sig_cg[int(scan_cg[last_scan_set][1]) * wg + int(scan_cg[last_scan_set][0])] = 1

    scan_pos = scan_pos_last
    for subset in range(last_scan_set, -1, -1):
        sub_pos = subset << 4
        go_rice = 0
        cgx, cgy = int(scan_cg[subset][0]), int(scan_cg[subset][1])
        cg_blk = cgy * wg + cgx
        num_nz = 0
        pos_list = []
        if scan_pos == scan_pos_last:
            pos_list.append(blk_last)
            num_nz = 1
            scan_pos -= 1
        if subset == last_scan_set or subset == 0:
            pass  # inferred 1
        else:
            right = int(sig_cg[cg_blk + 1]) if cgx < wg - 1 else 0
            below = int(sig_cg[cg_blk + wg]) if cgy < hg - 1 else 0
            ctx = 1 if (right or below) else 0
            enc.encode_bin(cg_arr, 2 * ch + ctx, int(sig_cg[cg_blk]))
        if wg <= 1 and hg <= 1:
            pattern = 0
        else:
            right = int(sig_cg[cg_blk + 1]) if cgx < wg - 1 else 0
            below = int(sig_cg[cg_blk + wg]) if cgy < hg - 1 else 0
            pattern = right + (below << 1)
        while scan_pos >= sub_pos:
            blk = int(scan[scan_pos])
            sig = 1 if flat[blk] else 0
            if sig_cg[cg_blk]:
                if scan_pos > sub_pos or subset == 0 or num_nz:
                    py = blk >> log2w
                    px = blk - (py << log2w)
                    if px + py == 0:
                        ctx = 0
                    elif w == 4 and h == 4:
                        ctx = first_sig_ctx + CTX_IND_MAP_4x4[4 * py + px]
                    else:
                        xin, yin = px & 3, py & 3
                        if pattern == 0:
                            t = xin + yin
                            cnt = 0 if t >= 3 else (1 if t >= 1 else 2)
                        elif pattern == 1:
                            cnt = 0 if yin >= 2 else (1 if yin >= 1 else 2)
                        elif pattern == 2:
                            cnt = 0 if xin >= 2 else (1 if xin >= 1 else 2)
                        else:
                            cnt = 2
                        not_first = ((px >> 2) + (py >> 2)) > 0
                        ctx = first_sig_ctx + cnt + \
                            (NOT_FIRST_GROUP_OFFSET[ch] if not_first else 0)
                    enc.encode_bin(sig_arr, sig_base + ctx, sig)
                # else inferred 1 (last coeff of first CG when rest were 0)
            if sig:
                pos_list.append(blk)
                num_nz += 1
            scan_pos -= 1
        if num_nz == 0:
            continue
        if is_chroma:
            ctx_set = 4 + (1 if c1 == 0 else 0)
        else:
            ctx_set = (2 if subset > 0 else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        base_gt1 = 4 * ctx_set
        abs_vals = [abs(int(flat[p])) for p in pos_list]
        num_c1 = min(num_nz, C1FLAG_NUMBER)
        first_c2 = -1
        for idx in range(num_c1):
            b = 1 if abs_vals[idx] > 1 else 0
            enc.encode_bin(gt1_arr, base_gt1 + c1, b)
            if b:
                c1 = 0
                if first_c2 == -1:
                    first_c2 = idx
            elif 0 < c1 < 3:
                c1 += 1
        if c1 == 0 and first_c2 != -1:
            b = 1 if abs_vals[first_c2] > 2 else 0
            enc.encode_bin(gt2_arr, ctx_set, b)
        # signs (the lowest-scan one is hidden when the spread allows)
        hide = False
        if sign_hiding and num_nz:
            rel = [sp for sp in range(sub_pos, min(sub_pos + 16, len(scan)))
                   if flat[int(scan[sp])]]
            hide = (rel[-1] - rel[0]) >= SBH_THRESHOLD
        sign_list = pos_list[:-1] if hide else pos_list
        for p in sign_list:
            enc.encode_bypass(1 if flat[p] < 0 else 0)
        # remaining levels
        first_coeff2 = 1
        for idx in range(num_nz):
            base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
            if abs_vals[idx] >= base_level:
                level = abs_vals[idx] - base_level
                encode_coef_remain(enc, level, go_rice)
                if abs_vals[idx] > (3 << go_rice):
                    go_rice = min(go_rice + 1, 4)
            if abs_vals[idx] >= 2:
                first_coeff2 = 0
