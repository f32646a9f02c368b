# Copied from libhm_tpu/hostdec/residual.py
"""residual_coding() syntax parsing (Rec. H.265 7.3.8.11 / 9.3.4.2-3).

Rebuild of the reference's parseCoeffNxN / parseLastSignificantXY /
xReadCoefRemainExGolomb (reference: source/Lib/TLibDecoder/TDecSbac.cpp:1253,
and context derivations in TComTrQuant.cpp getSigCtxInc/calcPatternSigCtx).
Outputs a dense int32 [h, w] coefficient array in raster order.
"""
import numpy as np
from .tables import (scan_xy, SCAN_DIAG, SCAN_HOR, SCAN_VER,
                     MIN_IN_GROUP, GROUP_IDX)

# 4x4 significance context map (Rec. H.265 Table 9-39 upper part)
CTX_IND_MAP_4x4 = [0, 1, 4, 5,
                   2, 3, 4, 5,
                   6, 6, 8, 8,
                   7, 7, 8, 8]

COEF_REMAIN_BIN_REDUCTION = 3
SBH_THRESHOLD = 4
C1FLAG_NUMBER = 8

# significance context set layout (reference: ContextTables.h:85)
SIG_SET_START = {0: (0, 9, 21, 27), 1: (0, 9, 12, 15)}  # 4x4, 8x8, NxN, single
NON_DIAG_8x8_OFFSET = (6, 0)
NOT_FIRST_GROUP_OFFSET = (3, 0)


class RiceStats:
    """Persistent Golomb-Rice statistics (RExt sps.persistent_rice_adaptation).

    Reference: TDecSbac m_golombRiceAdaptationStatistics, index by
    2*isTransformSkipOrBypass + isChroma (rTu.getGolombRiceStatisticsIndex).
    """
    __slots__ = ("vals",)

    def __init__(self):
        self.vals = [0, 0, 0, 0]


def _grouped_scan(w, h, kind):
    """Scan position -> raster blk position, 4x4-grouped (HM SCAN_GROUPED_4x4)."""
    wg, hg = w >> 2, h >> 2
    cg = scan_xy(wg, hg, kind)
    inner = scan_xy(4, 4, kind)
    out = np.empty(w * h, np.int32)
    i = 0
    for gx, gy in cg:
        for px, py in inner:
            out[i] = (gy * 4 + py) * w + gx * 4 + px
            i += 1
    return out


_gs_cache = {}


def grouped_scan(w, h, kind):
    key = (w, h, kind)
    if key not in _gs_cache:
        _gs_cache[key] = _grouped_scan(w, h, kind)
    return _gs_cache[key]


def parse_last_sig_xy(d, bank, w, h, is_chroma, scan_type):
    if scan_type == SCAN_VER:
        w, h = h, w
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if is_chroma:
        off_x, off_y = 15, 15
        shift_x, shift_y = log2w - 2, log2h - 2
    else:
        off_x = 3 * (log2w - 2) + ((log2w - 1) >> 2)
        off_y = 3 * (log2h - 2) + ((log2h - 1) >> 2)
        shift_x, shift_y = (log2w + 1) >> 2, (log2h + 1) >> 2
    ctx_x, ctx_y = bank["last_x"], bank["last_y"]
    pos_x = 0
    while pos_x < GROUP_IDX[w - 1] and d.decode_bin(ctx_x, off_x + (pos_x >> shift_x)):
        pos_x += 1
    pos_y = 0
    while pos_y < GROUP_IDX[h - 1] and d.decode_bin(ctx_y, off_y + (pos_y >> shift_y)):
        pos_y += 1
    if pos_x > 3:
        n = (pos_x - 2) >> 1
        pos_x = int(MIN_IN_GROUP[pos_x]) + d.decode_bypass_bins(n)
    if pos_y > 3:
        n = (pos_y - 2) >> 1
        pos_y = int(MIN_IN_GROUP[pos_y]) + d.decode_bypass_bins(n)
    if scan_type == SCAN_VER:
        pos_x, pos_y = pos_y, pos_x
    return pos_x, pos_y


def _sig_ctx(pattern, scan, pos, log2w, first_ctx, is_chroma, single_ctx):
    if single_ctx:
        return first_ctx
    blk = scan[pos]
    py = blk >> log2w
    px = blk - (py << log2w)
    if px + py == 0:
        return 0
    if first_ctx == 0 or (not is_chroma and first_ctx == 0):
        pass
    # 4x4 blocks are signalled by first_ctx == start-of-4x4-set (0)
    return -1  # handled by caller for non-4x4


def read_coef_remain(d, rice, use_limited_prefix, max_log2_dyn_range):
    prefix = 0
    while True:
        prefix += 1
        bit = d.decode_bypass()
        if not bit:
            break
        if use_limited_prefix and prefix >= (32 - (COEF_REMAIN_BIN_REDUCTION + max_log2_dyn_range)) + COEF_REMAIN_BIN_REDUCTION:
            bit = 1
            break
    prefix -= 1 - bit
    if prefix < COEF_REMAIN_BIN_REDUCTION:
        suffix = d.decode_bypass_bins(rice)
        return (prefix << rice) + suffix
    if use_limited_prefix:
        max_prefix_len = 32 - (COEF_REMAIN_BIN_REDUCTION + max_log2_dyn_range)
        prefix_len = prefix - COEF_REMAIN_BIN_REDUCTION
        suffix_len = (max_log2_dyn_range - rice) if prefix_len == max_prefix_len else prefix_len
        suffix = d.decode_bypass_bins(suffix_len + rice)
        return suffix + ((((1 << prefix_len) - 1) + COEF_REMAIN_BIN_REDUCTION) << rice)
    suffix = d.decode_bypass_bins(prefix - COEF_REMAIN_BIN_REDUCTION + rice)
    return (((1 << (prefix - COEF_REMAIN_BIN_REDUCTION)) + COEF_REMAIN_BIN_REDUCTION - 1) << rice) + suffix


def residual_coding(d, bank, w, h, comp, scan_type, *,
                    sign_hiding_valid, single_ctx_mode,
                    rice_stats=None, rice_stats_idx=0,
                    use_rice_adaptation=False,
                    extended_precision=False, max_log2_dyn_range=15,
                    align_before_bypass=False):
    """Parse one residual block; returns np.int32 [h, w].

    d: CabacDecoder; bank: context bank.
    comp: 0 luma / 1,2 chroma.
    sign_hiding_valid: PPS sign hiding and not disabled by bypass/RDPCM.
    single_ctx_mode: RExt transform-skip-context single-ctx significance mode.
    """
    is_chroma = comp > 0
    ch = 1 if is_chroma else 0
    log2w = w.bit_length() - 1
    coeffs = np.zeros(h * w, np.int32)

    pos_x, pos_y = parse_last_sig_xy(d, bank, w, h, is_chroma, scan_type)
    blk_last = pos_x + (pos_y << log2w)

    scan = grouped_scan(w, h, scan_type)
    wg, hg = w >> 2, h >> 2
    scan_cg = scan_xy(wg, hg, scan_type)

    # find scan position of last coeff
    scan_pos_last = int(np.nonzero(scan == blk_last)[0][0])

    # significance map context parameters
    sig_base = 0 if not is_chroma else 28
    if single_ctx_mode:
        first_sig_ctx = SIG_SET_START[ch][3]
    elif w == 4 and h == 4:
        first_sig_ctx = SIG_SET_START[ch][0]
    elif w == 8 and h == 8:
        first_sig_ctx = SIG_SET_START[ch][1]
        if scan_type != SCAN_DIAG:
            first_sig_ctx += NON_DIAG_8x8_OFFSET[ch]
    else:
        first_sig_ctx = SIG_SET_START[ch][2]

    last_scan_set = scan_pos_last >> 4
    c1 = 1
    sig_cg_flags = np.zeros(wg * hg, np.int32)
    sig_ctx_arr = bank["sig"]
    cg_ctx_arr = bank["sig_cg"]
    gt1_arr = bank["gt1"]
    gt2_arr = bank["gt2"]

    go_rice_stat = rice_stats.vals if rice_stats is not None else None

    scan_pos_sig = scan_pos_last
    for subset in range(last_scan_set, -1, -1):
        sub_pos = subset << 4
        if use_rice_adaptation and go_rice_stat is not None:
            go_rice = go_rice_stat[rice_stats_idx] // 4
        else:
            go_rice = 0
        update_rice_stats = use_rice_adaptation
        num_nonzero = 0
        last_nz = -1
        first_nz = 16
        escape_present = False
        pos = []

        if scan_pos_sig == scan_pos_last:
            last_nz = first_nz = scan_pos_sig
            scan_pos_sig -= 1
            pos.append(blk_last)
            num_nonzero = 1

        cgx, cgy = int(scan_cg[subset][0]), int(scan_cg[subset][1])
        cg_blk = cgy * wg + cgx
        if subset == last_scan_set or subset == 0:
            sig_cg_flags[cg_blk] = 1
        else:
            right = int(sig_cg_flags[cg_blk + 1]) if cgx < wg - 1 else 0
            below = int(sig_cg_flags[cg_blk + wg]) if cgy < hg - 1 else 0
            ctx = 1 if (right or below) else 0
            sig_cg_flags[cg_blk] = d.decode_bin(cg_ctx_arr, 2 * ch + ctx)

        # pattern for sig ctx
        if wg <= 1 and hg <= 1:
            pattern = 0
        else:
            right = int(sig_cg_flags[cg_blk + 1]) if cgx < wg - 1 else 0
            below = int(sig_cg_flags[cg_blk + wg]) if cgy < hg - 1 else 0
            pattern = right + (below << 1)

        while scan_pos_sig >= sub_pos:
            blk = int(scan[scan_pos_sig])
            sig = 0
            if sig_cg_flags[cg_blk]:
                if scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                    # context derivation (TComTrQuant::getSigCtxInc)
                    if single_ctx_mode:
                        ctx = first_sig_ctx
                    else:
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
                    sig = d.decode_bin(sig_ctx_arr, sig_base + ctx)
                else:
                    sig = 1
            if sig:
                pos.append(blk)
                num_nonzero += 1
                if last_nz == -1:
                    last_nz = scan_pos_sig
                first_nz = scan_pos_sig
            scan_pos_sig -= 1

        if num_nonzero <= 0:
            continue

        sign_hidden = (last_nz - first_nz) >= SBH_THRESHOLD

        # context set selection (TDecSbac getContextSetIndex)
        if is_chroma:
            ctx_set = 4 + (1 if c1 == 0 else 0)
        else:
            ctx_set = (2 if subset > 0 else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        base_gt1 = 4 * ctx_set

        abs_coeff = [1] * num_nonzero
        num_c1 = min(num_nonzero, C1FLAG_NUMBER)
        first_c2_idx = -1
        for idx in range(num_c1):
            b = d.decode_bin(gt1_arr, base_gt1 + c1)
            if b:
                c1 = 0
                if first_c2_idx == -1:
                    first_c2_idx = idx
                else:
                    escape_present = True
            elif 0 < c1 < 3:
                c1 += 1
            abs_coeff[idx] = b + 1

        if c1 == 0 and first_c2_idx != -1:
            b = d.decode_bin(gt2_arr, ctx_set)
            abs_coeff[first_c2_idx] = b + 2
            if b:
                escape_present = True

        escape_present = escape_present or (num_nonzero > C1FLAG_NUMBER)
        if escape_present and align_before_bypass:
            d.align_range()

        nsign = num_nonzero - 1 if (sign_hidden and sign_hiding_valid) else num_nonzero
        coeff_signs = d.decode_bypass_bins(nsign) << (32 - nsign) if nsign else 0

        first_coeff2 = 1
        if escape_present:
            for idx in range(num_nonzero):
                base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                if abs_coeff[idx] == base_level:
                    level = read_coef_remain(d, go_rice, extended_precision,
                                             max_log2_dyn_range)
                    abs_coeff[idx] = level + base_level
                    if abs_coeff[idx] > (3 << go_rice):
                        go_rice = go_rice + 1 if use_rice_adaptation \
                            else min(go_rice + 1, 4)
                    if update_rice_stats:
                        init_rice = go_rice_stat[rice_stats_idx] // 4
                        if level >= (3 << init_rice):
                            go_rice_stat[rice_stats_idx] += 1
                        elif 2 * level < (1 << init_rice) and go_rice_stat[rice_stats_idx] > 0:
                            go_rice_stat[rice_stats_idx] -= 1
                        update_rice_stats = False
                if abs_coeff[idx] >= 2:
                    first_coeff2 = 0

        abs_sum = sum(abs_coeff)
        for idx in range(num_nonzero):
            blk = pos[idx]
            v = abs_coeff[idx]
            if idx == num_nonzero - 1 and sign_hidden and sign_hiding_valid:
                if abs_sum & 1:
                    v = -v
            else:
                if (coeff_signs >> 31) & 1:
                    v = -v
                coeff_signs = (coeff_signs << 1) & 0xFFFFFFFF
            coeffs[blk] = v

    return coeffs.reshape(h, w)
