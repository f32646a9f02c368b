# Copied from libhm_tpu/encoder/rdoq.py
"""Rate-distortion optimized quantization (RDOQ).

Rebuild of the reference's TComTrQuant::xRateDistOptQuant
(source/Lib/TLibCommon/TComTrQuant.cpp, the RDOQ path of xQuant) for this
encoder's tool profile: flat scaling lists, no sign-data-hiding, no
transform skip.  The algorithm walks the coefficient groups in coding
(reverse-scan) order, choosing each |level| from {maxAbs, maxAbs-1, 0} by
minimizing D + lambda*R with fractional-bit rate estimates from the live
CABAC context states, then zeroes whole 4x4 coefficient groups when the
group flag pays for itself, and finally re-optimizes the last-significant
position (the reference's d64BestCost sweep).

Rate estimates model the REAL renormalized arithmetic coder (the
reference's corrected FAST_BIT_EST table, ContextModel.cpp:106-118):
coding a symbol that shrinks the 9-bit range R to R' costs log2(R/R')
bits, averaged over the coder's asymptotic log-uniform range
distribution (density 1/R on [256,510]).  This reproduces the reference
table to within 0.0015 bit per entry; the earlier pure -log2(p) state
model was off by up to 1.75 bits at confident states, which skews every
RD decision toward improbable bins (measured: +14% intra-mode
signalling bits vs HM on noisy content).  Bits are in 1/32768 units
like the reference's 15-bit fixed point.

NOTE: the loop below must stay OPERATION-IDENTICAL to the native
EstBits constructor (native/rdoq.cpp) — both paths price RD decisions
with these doubles and byte-identity requires bit-equal tables.
"""
import math

import numpy as np

from ..hostdec.tables import (scan_xy, SCAN_DIAG, SCAN_VER, MIN_IN_GROUP,
                              GROUP_IDX, QUANT_SCALES, LPS_TABLE)
from ..hostdec.residual import (grouped_scan, CTX_IND_MAP_4x4, SIG_SET_START,
                                NON_DIAG_8x8_OFFSET, NOT_FIRST_GROUP_OFFSET,
                                COEF_REMAIN_BIN_REDUCTION, C1FLAG_NUMBER)

FRAC = 32768.0  # one bit

# entropy-bit tables per (pState 0..62, bin==MPS?)
_EST_LPS = np.empty(64)
_EST_MPS = np.empty(64)
_wsum = 0.0
for _r in range(256, 511):
    _wsum += 1.0 / _r
for _i in range(64):
    _em = 0.0
    _el = 0.0
    for _r in range(256, 511):
        _w = (1.0 / _r) / _wsum
        _rl = float(LPS_TABLE[_i][(_r >> 6) & 3])
        _em += _w * math.log2(_r / (_r - _rl))
        _el += _w * math.log2(_r / _rl)
    _EST_MPS[_i] = _em * FRAC
    _EST_LPS[_i] = _el * FRAC


def _bits(ctx_arr, idx, binval):
    state = int(ctx_arr[idx])
    mps = state & 1
    ps = state >> 1
    return _EST_MPS[ps] if binval == mps else _EST_LPS[ps]


def _rate_abs_level(abs_level, c1_ctx, ctx_set, c1_idx, c2_idx, go_rice,
                    gt1_arr, gt2_arr):
    """Fractional bits for |level| >= 1 given the running per-CG state
    (reference xGetICRateCost)."""
    rate = FRAC  # sign bypass
    base_gt1 = 4 * ctx_set
    if c1_idx < C1FLAG_NUMBER:
        if abs_level == 1:
            return rate + _bits(gt1_arr, base_gt1 + c1_ctx, 0)
        rate += _bits(gt1_arr, base_gt1 + c1_ctx, 1)
        if c2_idx == 0:
            if abs_level == 2:
                return rate + _bits(gt2_arr, ctx_set, 0)
            rate += _bits(gt2_arr, ctx_set, 1)
            base = 3
        else:
            base = 2
    else:
        base = 1
    # coeff_abs_level_remaining, Golomb-Rice / EG(rice) bypass bits
    sym = abs_level - base
    if (sym >> go_rice) < COEF_REMAIN_BIN_REDUCTION:
        length = (sym >> go_rice) + 1 + go_rice
    else:
        length = COEF_REMAIN_BIN_REDUCTION + go_rice
        sym2 = sym - (COEF_REMAIN_BIN_REDUCTION << go_rice)
        while sym2 >= (1 << length - COEF_REMAIN_BIN_REDUCTION - go_rice):
            length += 1
            if length > 64:
                break
        # escape: prefix ones + 0 + suffix
        L = length - COEF_REMAIN_BIN_REDUCTION - go_rice
        length = COEF_REMAIN_BIN_REDUCTION + L + 1 + L + go_rice
    return rate + length * FRAC


def _rate_last(pos_x, pos_y, w, h, is_chroma, scan_type, bank):
    """Fractional bits of last_sig_coeff_x/y (mirror of
    encode_last_sig_xy)."""
    if scan_type == SCAN_VER:
        pos_x, pos_y = pos_y, pos_x
        w, h = h, w
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if is_chroma:
        off_x = off_y = 15
        shift_x, shift_y = log2w - 2, log2h - 2
    else:
        off_x = 3 * (log2w - 2) + ((log2w - 1) >> 2)
        off_y = 3 * (log2h - 2) + ((log2h - 1) >> 2)
        shift_x, shift_y = (log2w + 1) >> 2, (log2h + 1) >> 2
    gx, gy = int(GROUP_IDX[pos_x]), int(GROUP_IDX[pos_y])
    cx, cy = bank["last_x"], bank["last_y"]
    r = 0.0
    for i in range(gx):
        r += _bits(cx, off_x + (i >> shift_x), 1)
    if gx < GROUP_IDX[w - 1]:
        r += _bits(cx, off_x + (gx >> shift_x), 0)
    for i in range(gy):
        r += _bits(cy, off_y + (i >> shift_y), 1)
    if gy < GROUP_IDX[h - 1]:
        r += _bits(cy, off_y + (gy >> shift_y), 0)
    if gx > 3:
        r += ((gx - 2) >> 1) * FRAC
    if gy > 3:
        r += ((gy - 2) >> 1) * FRAC
    return r


_NATIVE = ("unset",)


def _native():
    global _NATIVE
    if _NATIVE == ("unset",):
        from ..hostdec.native_bridge import try_load
        _NATIVE = (try_load(),)
    return _NATIVE[0]


_ADDR_CACHE = {}


def _addr(arr):
    """Cached data pointer of a long-lived contiguous int32 array (the
    context-bank arrays are mutated in place but never reallocated)."""
    key = id(arr)
    hit = _ADDR_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        return hit[1]
    assert arr.dtype == np.int32 and arr.flags.c_contiguous
    if len(_ADDR_CACHE) > 1024:  # banks are per-slice; don't grow unbounded
        _ADDR_CACHE.clear()
    a = arr.ctypes.data
    _ADDR_CACHE[key] = (arr, a)
    return a


def residual_bits(bank, coeffs, comp, scan_type, sign_hiding, ts,
                  start=0.0):
    """Estimated fractional bits of residual_coding() for one TU, in
    FRAC-scaled raw units, continuing the accumulation `start` — the
    bits-only native mirror of residual_enc.encode_residual followed by
    the recorded-ops pricing loop (encoder._est_ops_bits), accumulated in
    the same order so the result is bit-identical.  Returns None when the
    native library is unavailable (caller falls back to recording)."""
    lib = _native()
    if lib is None:
        return None
    h, w = coeffs.shape
    c32 = np.ascontiguousarray(coeffs, np.int32)
    return lib.enc_residual_bits(
        c32.ctypes.data, w, h, comp, scan_type,
        1 if sign_hiding else 0, -1 if ts is None else int(ts),
        _addr(bank["sig"]), _addr(bank["sig_cg"]), _addr(bank["gt1"]),
        _addr(bank["gt2"]), _addr(bank["last_x"]), _addr(bank["last_y"]),
        _addr(bank["transform_skip"]), float(start))


def rdoq(coef, qp, log2_size, bit_depth, comp, scan_type, bank, lam,
         max_dyn_range=15):
    """RDO-quantize one square TU.  Returns int32 levels, same shape.

    coef: transform coefficients [n, n] int32; bank: live context bank
    (read-only: only probabilities are consulted); lam: SSE lambda in the
    8-bit pixel domain.

    Dispatches to the native mirror (native/rdoq.cpp, bit-exact — see
    tests/test_encsearch.py) when the toolchain is available; the Python
    body below is the reference implementation and fallback.
    """
    lib = _native()
    if lib is not None:
        n = 1 << log2_size
        c32 = np.ascontiguousarray(coef, np.int32)
        out = np.zeros((n, n), np.int32)
        lib.enc_rdoq(c32.ctypes.data, qp, log2_size,
                     bit_depth, 1 if comp > 0 else 0, scan_type,
                     _addr(bank["sig"]), _addr(bank["sig_cg"]),
                     _addr(bank["gt1"]), _addr(bank["gt2"]),
                     _addr(bank["last_x"]), _addr(bank["last_y"]),
                     float(lam), max_dyn_range, out.ctypes.data)
        return out
    return _rdoq_py(coef, qp, log2_size, bit_depth, comp, scan_type, bank,
                    lam, max_dyn_range)


def _rdoq_py(coef, qp, log2_size, bit_depth, comp, scan_type, bank, lam,
             max_dyn_range=15):
    """Pure-Python RDOQ (the native kernel's reference mirror)."""
    n = 1 << log2_size
    per, rem = qp // 6, qp % 6
    tshift = max_dyn_range - bit_depth - log2_size
    qbits = 14 + per + tshift
    scale = int(QUANT_SCALES[rem])
    err_scale = (2.0 ** (-2.0 * tshift)) / (scale * scale) \
        / (1 << (2 * (bit_depth - 8)))
    lam_bits = lam / FRAC  # cost per 1/32768-bit unit

    w = h = n
    log2w = log2_size
    is_chroma = comp > 0
    ch = 1 if is_chroma else 0
    flat = coef.ravel()
    scan = grouped_scan(w, h, scan_type)
    cs = flat[scan].astype(np.int64)          # signed, scan order
    ld = np.abs(cs) * scale                   # levelDouble
    max_abs = ((ld + (1 << (qbits - 1))) >> qbits).astype(np.int64)
    nz = np.nonzero(max_abs)[0]
    out = np.zeros_like(flat)
    if len(nz) == 0:
        return out.reshape(h, w)
    last_scan_pos = int(nz[-1])

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

    wg, hg = w >> 2, h >> 2
    scan_cg = scan_xy(wg, hg, scan_type)
    last_cg = last_scan_pos >> 4

    n2 = w * h
    level = np.zeros(n2, np.int64)            # scan order decisions
    cost_coeff = np.zeros(n2)                 # D + lam*(rate incl. sig)
    cost_coeff0 = (ld.astype(np.float64) ** 2) * err_scale  # uncoded D
    cost_sig = np.zeros(n2)                   # lam * sig-flag bits spent
    sig_cg = np.zeros(wg * hg, np.int64)

    base_cost = 0.0
    c1 = 1
    for subset in range(last_cg, -1, -1):
        sub_pos = subset << 4
        cgx, cgy = int(scan_cg[subset][0]), int(scan_cg[subset][1])
        cg_blk = cgy * wg + cgx
        right = int(sig_cg[cg_blk + 1]) if cgx < wg - 1 else 0
        below = int(sig_cg[cg_blk + wg]) if cgy < hg - 1 else 0
        pattern = 0 if (wg <= 1 and hg <= 1) else right + (below << 1)

        if is_chroma:
            ctx_set = 4 + (1 if c1 == 0 else 0)
        else:
            ctx_set = (2 if subset > 0 else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        c1_idx = 0
        c2_idx = 0
        go_rice = 0
        cg_cost = 0.0          # cost of this CG as coded
        cg_cost_zero = 0.0     # distortion if the whole CG is zeroed
        cg_sig_cost_total = 0.0
        top = min(last_scan_pos, sub_pos + 15)
        for sp in range(top, sub_pos - 1, -1):
            blk = int(scan[sp])
            py = blk >> log2w
            px = blk - (py << log2w)
            # sig ctx (mirror of encode_residual)
            if px + py == 0:
                sctx = 0
            elif w == 4 and h == 4:
                sctx = first_sig_ctx + CTX_IND_MAP_4x4[4 * py + px]
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
                sctx = first_sig_ctx + cnt + \
                    (NOT_FIRST_GROUP_OFFSET[ch] if not_first else 0)
            sig1 = lam_bits * _bits(sig_arr, sig_base + sctx, 1)
            sig0 = lam_bits * _bits(sig_arr, sig_base + sctx, 0)
            is_last = sp == last_scan_pos

            ma = int(max_abs[sp])
            best_cost = None
            best_lvl = 0
            if not is_last:
                best_cost = cost_coeff0[sp] + sig0
                best_sig = 0.0
            lo = max(1, ma - 1)
            for l in range(ma, lo - 1, -1):
                d = float(ld[sp] - (l << qbits)) ** 2 * err_scale
                r = _rate_abs_level(l, c1, ctx_set, c1_idx, c2_idx, go_rice,
                                    gt1_arr, gt2_arr)
                c = d + lam_bits * r + (0.0 if is_last else sig1)
                if best_cost is None or c < best_cost:
                    best_cost = c
                    best_lvl = l
                    best_sig = 0.0 if is_last else sig1
            level[sp] = best_lvl
            cost_coeff[sp] = best_cost
            cost_sig[sp] = best_sig
            cg_cost += best_cost
            cg_cost_zero += cost_coeff0[sp]
            if not is_last:
                cg_sig_cost_total += sig1 if best_lvl else sig0
            # advance the per-CG entropy state with the decision
            if best_lvl:
                sig_cg[cg_blk] = 1
                if c1_idx < C1FLAG_NUMBER:
                    if best_lvl > 1:
                        if c2_idx == 0:
                            c2_idx = 1
                        c1 = 0
                    elif 0 < c1 < 3:
                        c1 += 1
                    c1_idx += 1
                base_lvl = (2 + (1 if c2_idx else 0)) \
                    if c1_idx <= C1FLAG_NUMBER else 1
                if best_lvl >= base_lvl and best_lvl > (3 << go_rice):
                    go_rice = min(go_rice + 1, 4)

        # coefficient-group significance decision
        if subset == last_cg or subset == 0:
            sig_cg[cg_blk] = 1 if subset == last_cg else sig_cg[cg_blk]
            if subset == 0:
                sig_cg[cg_blk] = 1  # inferred
            base_cost += cg_cost
        else:
            ctxg = 2 * ch + (1 if (right or below) else 0)
            bit1 = lam_bits * _bits(cg_arr, ctxg, 1)
            bit0 = lam_bits * _bits(cg_arr, ctxg, 0)
            if sig_cg[cg_blk]:
                coded = cg_cost + bit1
                zeroed = cg_cost_zero + bit0
                if zeroed < coded:
                    sig_cg[cg_blk] = 0
                    for sp in range(sub_pos, min(sub_pos + 16, n2)):
                        level[sp] = 0
                        cost_coeff[sp] = cost_coeff0[sp]
                        cost_sig[sp] = 0.0
                    base_cost += zeroed
                    c1 = 1  # zeroed group leaves the c1 carry untouched
                else:
                    base_cost += coded
            else:
                base_cost += cg_cost_zero + bit0

    # last-position sweep (reference d64BestCost loop).  The all-zero cost
    # accumulates sequentially (not np.sum's pairwise order) so the native
    # mirror is bit-identical.
    best_cost = 0.0
    for _sp in range(last_scan_pos + 1):
        best_cost += float(cost_coeff0[_sp])
    best_last_p1 = 0
    for sp in range(last_scan_pos, -1, -1):
        if level[sp] > 0:
            blk = int(scan[sp])
            py = blk >> log2w
            px = blk - (py << log2w)
            rlast = lam_bits * _rate_last(px, py, w, h, is_chroma,
                                          scan_type, bank)
            total = base_cost - cost_sig[sp] + rlast
            if total < best_cost:
                best_cost = total
                best_last_p1 = sp + 1
            if level[sp] > 1:
                break
            base_cost -= cost_coeff[sp]
            base_cost += cost_coeff0[sp]
        else:
            base_cost -= cost_sig[sp]

    for sp in range(best_last_p1, last_scan_pos + 1):
        level[sp] = 0
    sign = np.sign(cs)
    out[scan] = (sign * np.minimum(level, 32767)).astype(np.int32)
    return out.reshape(h, w)
