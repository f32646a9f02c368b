# Copied from libhm_tpu/encoder/wp_analysis.py
"""Weighted-prediction analysis for the encoder.

Rebuild of the reference's WP pre-analysis
(source/Lib/TLibEncoder/WeightPredAnalysis.cpp): per picture and per
reference, match the mean (DC) and mean absolute deviation (AC) of the
current picture to the reference via w = AC_cur/AC_ref at a fixed log2
denominator, derive the offset from the DC difference, then keep WP only
when the weighted SAD actually beats the unweighted SAD (xSelectWP).

Offsets are expressed in 8-bit units (the decoder scales them by
1 << (bit_depth - 8), reference TComWeightPrediction), and the weight is
clipped so delta_luma_weight stays within the spec's [-128, 127].
"""
import numpy as np

LOG2_DENOM = 6  # reference default (TEncSlice initializes denom.iDC = 6)


def calc_acdc(plane):
    """(DC sum, AC = sum |p - mean|) of one component plane
    (reference WeightPredAnalysis::xCalcACDCParamSlice)."""
    p = plane.astype(np.int64)
    dc = int(p.sum())
    avg = dc // p.size
    ac = int(np.abs(p - avg).sum())
    return dc, ac


def estimate_wp(cur_planes, ref_planes, bit_depth, denom=LOG2_DENOM):
    """Per-component (weight, offset) or None (unity) for one reference
    (reference xUpdatingWPParameters)."""
    out = []
    shift = bit_depth - 8
    for c in range(len(cur_planes)):
        dc_c, ac_c = calc_acdc(cur_planes[c])
        dc_r, ac_r = calc_acdc(ref_planes[c])
        n = cur_planes[c].size
        default_w = 1 << denom
        if ac_r == 0:
            out.append((default_w, 0))
            continue
        w = int(round(float(ac_c) * (1 << denom) / float(ac_r)))
        # delta_luma_weight in [-128, 127] and the reference's own clip
        w = max(default_w - 128, min(min(default_w + 127, 127), w))
        o = (dc_c - ((w * dc_r) >> denom)) / n
        o = int(round(o / (1 << shift))) if shift else int(round(o))
        o = max(-128, min(127, o))
        out.append((w, o))
    return out


def select_wp(cur_luma, ref_luma, w, o, bit_depth, denom=LOG2_DENOM):
    """True when weighting the reference lowers luma SAD
    (reference WeightPredAnalysis::xSelectWP)."""
    cur = cur_luma.astype(np.int64)
    ref = ref_luma.astype(np.int64)
    maxv = (1 << bit_depth) - 1
    off = o << (bit_depth - 8)
    rnd = 1 << (denom - 1)
    wref = np.clip(((w * ref + rnd) >> denom) + off, 0, maxv)
    sad_plain = int(np.abs(cur - ref).sum())
    sad_wp = int(np.abs(cur - wref).sum())
    return sad_wp < sad_plain


def analyse_picture(orig_planes, ref_list, bit_depth):
    """WP tables for one P picture: per active-reference entry, either None
    (no weighting) or {'w': [wY,wCb,wCr], 'o': [...], 'denom': LOG2_DENOM}.

    Returns None when no reference benefits (the slice then omits WP
    syntax values by signalling all flags zero)."""
    table = []
    any_wp = False
    for ref in ref_list:
        cur = [p for p in orig_planes]
        refp = [p for p in ref.planes]
        wo = estimate_wp(cur, refp, bit_depth)
        wY, oY = wo[0]
        if (wY, oY) != (1 << LOG2_DENOM, 0) and \
                select_wp(cur[0], refp[0], wY, oY, bit_depth):
            table.append({"w": [c[0] for c in wo], "o": [c[1] for c in wo],
                          "denom": LOG2_DENOM})
            any_wp = True
        else:
            table.append(None)
    return table if any_wp else None
