# Copied from libhm_tpu/encoder/intra_search.py
"""Batched 35-mode intra prediction for the encoder's SATD mode search.

Replaces 35 separate refimpl.predict_intra calls per PU (the reference's
per-mode loop in TEncSearch::estIntraPredQT) with ONE reference-sample
fill + one vectorized all-modes prediction using the same static gather
tables the TPU intra kernel uses (ops/intra._ang_tables).  Used for the
mode DECISION only — the chosen mode's final reconstruction still goes
through refimpl.predict_intra, so any search-side simplification (the
n<32 edge filters are skipped here) only influences RD choices, never
conformance.
"""
import numpy as np

from ..hostdec import refimpl
from ..ops.intra import _ang_tables


def predict_all_modes(top_u, left_u, top_f, left_f, n, comp, bd, sps):
    """Returns [35, n, n] int32 predictions (planar, DC, 33 angular)."""
    def mk_vals(top, left):
        v = np.empty(4 * n + 1, np.int64)
        v[:2 * n + 1] = left[::-1]
        v[2 * n:] = top
        return v

    vu = mk_vals(top_u, left_u)
    vf = mk_vals(top_f, left_f) if top_f is not None else vu
    filt = np.array([refimpl.use_filtered_refs(comp, n, m, sps)
                     for m in range(35)])
    V = np.where(filt[:, None], vf[None, :], vu[None, :])    # [35, 4n+1]
    ext_t, row_t, frac_t, vert_t = _ang_tables(n)
    ext = np.take_along_axis(V, ext_t.astype(np.int64), axis=1)
    xx = np.arange(n)
    gidx = row_t[:, :, None].astype(np.int64) + xx[None, None, :]
    E = ext.shape[1]
    a = np.take_along_axis(ext, gidx.reshape(35, -1), axis=1) \
        .reshape(35, n, n)
    b = np.take_along_axis(ext, np.minimum(gidx + 1, E - 1)
                           .reshape(35, -1), axis=1).reshape(35, n, n)
    f = frac_t[:, :, None].astype(np.int64)
    pred = ((32 - f) * a + f * b + 16) >> 5
    pred = np.where(vert_t[:, None, None], pred,
                    np.swapaxes(pred, 1, 2))
    log2n = n.bit_length() - 1
    # planar (8.4.4.2.4)
    v0 = V[0]
    t1n = v0[2 * n + 1:3 * n + 1]
    l1n = v0[n:2 * n][::-1]
    tr, bl = v0[3 * n + 1], v0[n - 1]
    hor = (n - 1 - xx)[None, :] * l1n[:, None] + (xx + 1)[None, :] * tr
    ver = (n - 1 - xx)[:, None] * t1n[None, :] + (xx + 1)[:, None] * bl
    pred[0] = (hor + ver + n) >> (log2n + 1)
    # DC (8.4.4.2.5, boundary filter skipped for the search)
    v1 = V[1]
    dc = (int(v1[2 * n + 1:3 * n + 1].sum()) +
          int(v1[n:2 * n].sum()) + n) >> (log2n + 1)
    pred[1] = dc
    return pred.astype(np.int32)
