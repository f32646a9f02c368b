# Copied from libhm_tpu/encoder/sao_enc.py
"""SAO parameter estimation + syntax writing (encoder side).

Rebuild of the reference TEncSampleAdaptiveOffset (getStatistics /
deriveOffsets / deriveModeNewRDO / deriveModeMergeRDO,
TEncSampleAdaptiveOffset.cpp:312-662): per CTU and component collect
(error-sum, count) statistics per band / edge category, derive
lambda-optimal offsets with the iterative magnitude shrink
(estIterOffset), then RD-compare OFF / new-type / merge-left / merge-up
at the CTU level.  The chosen parameters go into the same PicSyntax
sao_* arrays the decoder fills, so applying them reuses the validated
loopfilter_np.sao_picture.

Syntax mirrors hostdec.slicedec._parse_sao_ctu exactly.
"""
import numpy as np

# offset signs per EO category as stored in pic.sao_offsets:
# [cat -2, cat -1, cat +1, cat +2] -> [>=0, >=0, <=0, <=0]
EO_NEIGHBORS = {
    1: ((0, -1), (0, 1)),
    2: ((-1, 0), (1, 0)),
    3: ((-1, -1), (1, 1)),
    4: ((-1, 1), (1, -1)),
}


def _gain(e, n, off):
    # SSE reduction when adding `off` to n samples with error sum e
    return 2 * off * e - off * off * n


def _iter_offset(e, n, maxq, positive, lam, sign_bit):
    """Lambda-optimal offset magnitude: start from the statistical
    optimum round(e/n) and shrink toward zero, keeping the best
    gain - lam * bits (reference estIterOffset; TU bits = |off| + 1,
    plus a sign bypass for BO when nonzero)."""
    if n == 0:
        return 0, 0.0
    off = int(round(e / n))
    off = max(0, min(maxq, off)) if positive else min(0, max(-maxq, off))
    best_off, best_c = 0, 0.0
    step = 1 if off >= 0 else -1
    for o in range(off, 0, -step):
        c = _gain(e, n, o) - lam * (abs(o) + 1 + sign_bit)
        if c > best_c:
            best_off, best_c = o, c
    return best_off, best_c


def sao_stats(orig, dbf, x0, y0, x1, y1, bd):
    """Per-category SAO statistics for one CTU region of one component:
    {"bo": (e[32], n[32]), "eo<k>": (e[4], n[4])} with the EO categories
    ordered [-2, -1, +1, +2] (decoder storage layout)."""
    o = orig[y0:y1, x0:x1].astype(np.int64)
    d = dbf[y0:y1, x0:x1].astype(np.int64)
    diff = o - d
    out = {}

    bands = (d >> (bd - 5)).astype(np.int64)
    e = np.zeros(32)
    n = np.zeros(32)
    np.add.at(e, bands.ravel(), diff.ravel())
    np.add.at(n, bands.ravel(), 1)
    out["bo"] = (e, n)

    H, W = dbf.shape
    for t in range(1, 5):
        (dy1, dx1), (dy2, dx2) = EO_NEIGHBORS[t]
        yy0 = max(y0, max(0, -min(dy1, dy2)))
        yy1 = min(y1, H - max(0, max(dy1, dy2)))
        xx0 = max(x0, max(0, -min(dx1, dx2)))
        xx1 = min(x1, W - max(0, max(dx1, dx2)))
        if yy1 <= yy0 or xx1 <= xx0:
            out[f"eo{t-1}"] = (np.zeros(4), np.zeros(4))
            continue
        v = dbf[yy0:yy1, xx0:xx1].astype(np.int64)
        n1 = dbf[yy0 + dy1:yy1 + dy1, xx0 + dx1:xx1 + dx1].astype(np.int64)
        n2 = dbf[yy0 + dy2:yy1 + dy2, xx0 + dx2:xx1 + dx2].astype(np.int64)
        et = np.sign(v - n1) + np.sign(v - n2)
        dd = (orig[yy0:yy1, xx0:xx1].astype(np.int64) - v)
        ee = np.zeros(4)
        nn = np.zeros(4)
        for ci, cat in enumerate((-2, -1, 1, 2)):
            m = et == cat
            ee[ci] = float(dd[m].sum())
            nn[ci] = int(m.sum())
        out[f"eo{t-1}"] = (ee, nn)
    return out


def derive_candidates(stats, bd, lam):
    """Lambda-optimal new-type candidates from one component's stats.

    Returns {"bo": (band_pos, offsets, net_gain),
             "eo<k>": (offsets, net_gain)}; net gains are SSE reduction
    minus lam * offset-payload bits (type/class header bits are charged
    by the CTU-level decision, which knows the component layout)."""
    maxq = (1 << (min(bd, 10) - 5)) - 1
    out = {}

    e, n = stats["bo"]
    offs = np.zeros(32, np.int64)
    gains = np.zeros(32)
    for b in range(32):
        offs[b], gains[b] = _iter_offset(e[b], n[b], maxq,
                                         e[b] >= 0, lam, 1)
    best_bo = (0, [0, 0, 0, 0], -1e18)
    for pos in range(32):
        idx = [(pos + i) % 32 for i in range(4)]
        ov = [int(offs[i]) for i in idx]
        g = float(gains[idx].sum()) - lam * 5   # band position bits
        if g > best_bo[2]:
            best_bo = (pos, ov, g)
    out["bo"] = best_bo

    for t in range(4):
        ee, nn = stats[f"eo{t}"]
        ov = [0, 0, 0, 0]
        g = 0.0
        for ci, positive in enumerate((True, True, False, False)):
            off, gn = _iter_offset(ee[ci], nn[ci], maxq, positive, lam, 0)
            ov[ci] = off
            g += gn
        out[f"eo{t}"] = (ov, g - lam * 2)       # eo class bits
    return out


def params_gain(stats, t, band_pos, offsets):
    """SSE reduction of applying a GIVEN param set (merge candidate) to
    the CTU whose stats these are (reference deriveModeMergeRDO)."""
    if t < 0:
        return 0.0
    if t == 0:
        e, n = stats["bo"]
        return sum(_gain(e[(band_pos + i) % 32], n[(band_pos + i) % 32],
                         int(offsets[i])) for i in range(4))
    ee, nn = stats[f"eo{t-1}"]
    return sum(_gain(ee[i], nn[i], int(offsets[i])) for i in range(4))


def write_sao_ctu(enc, bank, pic, addr, wc, enabled, sps, avail=None,
                  counts=None):
    """Mirror of _parse_sao_ctu for one CTU's chosen parameters.

    avail(other_addr): extra availability predicate for the merge
    neighbours (same slice + tile, mirrored from the decode side); None
    means everything in-picture is available (single slice/tile).
    counts: optional {name: array} per-context coded-bin counters
    (ContextModel::getBinsCoded parity for determineCabacInitIdx — SAO
    bins are coded here in the emit pass, outside the recorded op
    stream).
    """
    def params_equal(a, b):
        return all(
            pic.sao_type[a, c] == pic.sao_type[b, c] and
            pic.sao_band_pos[a, c] == pic.sao_band_pos[b, c] and
            (pic.sao_offsets[a, c] == pic.sao_offsets[b, c]).all()
            for c in range(3) if enabled[c])

    can_left = addr % wc > 0 and (avail is None or avail(addr - 1))
    can_up = addr // wc > 0 and (avail is None or avail(addr - wc))
    merge_left = can_left and params_equal(addr, addr - 1)
    if can_left:
        enc.encode_bin(bank["sao_merge"], 0, 1 if merge_left else 0)
        if counts is not None:
            counts["sao_merge"][0] += 1
    if merge_left:
        return
    merge_up = can_up and params_equal(addr, addr - wc)
    if can_up:
        enc.encode_bin(bank["sao_merge"], 0, 1 if merge_up else 0)
        if counts is not None:
            counts["sao_merge"][0] += 1
    if merge_up:
        return

    max_q_l = (1 << (min(sps.bit_depth_luma, 10) - 5)) - 1
    max_q_c = (1 << (min(sps.bit_depth_chroma, 10) - 5)) - 1
    for c in range(3):
        if not enabled[c]:
            continue
        t = int(pic.sao_type[addr, c])
        if c <= 1:
            enc.encode_bin(bank["sao_type"], 0, 0 if t < 0 else 1)
            if counts is not None:
                counts["sao_type"][0] += 1
            if t >= 0:
                enc.encode_bypass(0 if t == 0 else 1)
        if t < 0:
            continue
        maxq = max_q_l if c == 0 else max_q_c
        offs = [int(v) for v in pic.sao_offsets[addr, c]]
        mags = [abs(v) for v in offs]
        for m in mags:
            # truncated unary, max maxq
            for k in range(m):
                enc.encode_bypass(1)
            if m < maxq:
                enc.encode_bypass(0)
        if t == 0:  # BO: signs then band position
            for i in range(4):
                if mags[i]:
                    enc.encode_bypass(1 if offs[i] < 0 else 0)
            enc.encode_bypass_bins(int(pic.sao_band_pos[addr, c]), 5)
        else:       # EO: class for luma / first chroma only
            if c <= 1:
                enc.encode_bypass_bins(t - 1, 2)
