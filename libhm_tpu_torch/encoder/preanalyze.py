# Copied from libhm_tpu/encoder/preanalyze.py
"""Adaptive-QP preanalysis (reference TEncPreanalyzer.cpp: TM5 step 3).

Per CTU-sized AQ unit: activity = 1 + min variance of the four quadrant
sub-blocks; the QP offset follows the TM5 normalization
dQP = round(6 * log2((2a + A) / (a + 2A))) clipped to the adaptation
range, where A is the picture-average activity."""
import math

import numpy as np


def ctu_activities(luma, ctb, width, height):
    """Per-CTU activity over the real picture area (padded planes ok)."""
    acts = []
    for y in range(0, height, ctb):
        for x in range(0, width, ctb):
            blk = luma[y:min(y + ctb, height), x:min(x + ctb, width)]
            h, w = blk.shape
            hh, hw = max(1, h // 2), max(1, w // 2)
            quads = [blk[:hh, :hw], blk[:hh, hw:], blk[hh:, :hw], blk[hh:, hw:]]
            v = min(float(np.var(q.astype(np.float64))) for q in quads if q.size)
            acts.append(1.0 + v)
    return acts


def qp_offsets(luma, ctb, width, height, aq_range=6):
    """Per-CTU QP offsets in CTU raster order."""
    acts = ctu_activities(luma, ctb, width, height)
    avg = sum(acts) / len(acts)
    out = []
    for a in acts:
        d = 6.0 * math.log2((2.0 * a + avg) / (a + 2.0 * avg))
        out.append(max(-aq_range, min(aq_range, int(round(d)))))
    return out
