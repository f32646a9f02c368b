# Copied from libhm_tpu/hostdec/deblock_maps.py
"""Vectorized boundary-strength / deblock parameter maps (host side).

numpy translation of loopfilter_np.compute_bs (itself mirroring reference
TComLoopFilter xGetBoundaryStrengthSingle) producing the per-edge tensors
consumed by the TPU deblocking kernel: BS, average QP, beta/tc offsets and
no-filter masks at 4x4-edge granularity for both passes.
"""
import numpy as np
from .picture import MODE_INTRA
from .slicedec import (EDGE_TU_LEFT, EDGE_TU_TOP, EDGE_PU_LEFT, EDGE_PU_TOP,
                       EDGE_CU_LEFT, EDGE_CU_TOP)


def _mv_bs_vec(pic, py4, px4, qy4, qx4):
    """Vectorized BS=1 motion test for arrays of block pairs."""
    pdir = pic.inter_dir[py4, px4].astype(np.int32)
    qdir = pic.inter_dir[qy4, qx4].astype(np.int32)
    pmv = pic.mv[py4, px4]          # [N, 2, 2]
    qmv = pic.mv[qy4, qx4]
    ppoc = pic.ref_poc[py4, px4]    # [N, 2]
    qpoc = pic.ref_poc[qy4, qx4]

    def far(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    p_n = ((pdir & 1) != 0).astype(np.int32) + ((pdir & 2) != 0).astype(np.int32)
    q_n = ((qdir & 1) != 0).astype(np.int32) + ((qdir & 2) != 0).astype(np.int32)
    bs = np.zeros(pdir.shape, np.int8)
    diff_count = p_n != q_n
    bs[diff_count] = 1

    # uni-pred pairs: the single used list per side
    uni = (~diff_count) & (p_n == 1)
    pl = np.where((pdir & 1) != 0, 0, 1)
    ql = np.where((qdir & 1) != 0, 0, 1)
    idx = np.arange(pdir.shape[0])
    pr = ppoc[idx, pl]
    qr = qpoc[idx, ql]
    pm = pmv[idx, pl]
    qm = qmv[idx, ql]
    uni_bs = (pr != qr) | far(pm, qm)
    bs[uni & uni_bs] = 1

    # bi-pred pairs
    bi = (~diff_count) & (p_n == 2)
    if bi.any():
        p0, p1 = ppoc[:, 0], ppoc[:, 1]
        q0, q1 = qpoc[:, 0], qpoc[:, 1]
        refs_differ = ~(((p0 == q0) & (p1 == q1)) | ((p0 == q1) & (p1 == q0)))
        same_both = p0 == p1
        f00 = far(pmv[:, 0], qmv[:, 0])
        f11 = far(pmv[:, 1], qmv[:, 1])
        f01 = far(pmv[:, 0], qmv[:, 1])
        f10 = far(pmv[:, 1], qmv[:, 0])
        bs_same = (f00 | f11) & (f01 | f10)
        match0 = p0 == q0
        bs_diff = np.where(match0, f00 | f11, f01 | f10)
        bi_bs = np.where(refs_differ, True,
                         np.where(same_both, bs_same, bs_diff))
        bs[bi & bi_bs] = 1
    return bs


def compute_bs_maps(pic, sps, pps, tile_map, vertical):
    """Returns (bs, qp_l, beta_off, tc_off, no_p, no_q) at [h4, w4] with
    entries only on the 8-pel grid (bs=0 elsewhere)."""
    h4, w4 = pic.depth.shape
    ef = pic.edge_flags
    if vertical:
        edge_mask = EDGE_CU_LEFT | EDGE_PU_LEFT | EDGE_TU_LEFT
        tu_bit, pu_bit = EDGE_TU_LEFT, EDGE_PU_LEFT
        grid = np.zeros((h4, w4), bool)
        grid[:, 2::2] = True
        grid[:, 0] = False
        off = (0, -1)
    else:
        edge_mask = EDGE_CU_TOP | EDGE_PU_TOP | EDGE_TU_TOP
        tu_bit, pu_bit = EDGE_TU_TOP, EDGE_PU_TOP
        grid = np.zeros((h4, w4), bool)
        grid[2::2, :] = True
        grid[0, :] = False
        off = (-1, 0)

    has_edge = grid & ((ef & edge_mask) != 0) & (pic.deblock_disable == 0)
    qy4, qx4 = np.nonzero(has_edge)
    py4, px4 = qy4 + off[0], qx4 + off[1]

    # slice / tile permission
    wc = sps.pic_width_ctbs
    s = sps.log2_ctb - 2
    same_slice = pic.slice_idx[qy4, qx4] == pic.slice_idx[py4, px4]
    lf_ok = (pic.loopfilter_across_slice[qy4, qx4] != 0) & \
            (pic.loopfilter_across_slice[py4, px4] != 0)
    ok = same_slice | lf_ok
    tq = tile_map[(qy4 >> s) * wc + (qx4 >> s)]
    tp = tile_map[(py4 >> s) * wc + (px4 >> s)]
    ok &= (tq == tp) | bool(pps.loop_filter_across_tiles)
    qy4, qx4, py4, px4 = qy4[ok], qx4[ok], py4[ok], px4[ok]

    bs_full = np.zeros((h4, w4), np.int8)
    intra_edge = (pic.pred_mode[qy4, qx4] == MODE_INTRA) | \
                 (pic.pred_mode[py4, px4] == MODE_INTRA)
    flags = ef[qy4, qx4]
    tu_edge = (flags & tu_bit) != 0
    cbf_edge = tu_edge & ((pic.cbf_y[qy4, qx4] != 0) | (pic.cbf_y[py4, px4] != 0))
    mv_candidates = (~intra_edge) & (~cbf_edge) & \
                    ((flags & (pu_bit | tu_bit)) != 0)
    bs_v = np.zeros(len(qy4), np.int8)
    bs_v[intra_edge] = 2
    bs_v[(~intra_edge) & cbf_edge] = 1
    if mv_candidates.any():
        mi = np.nonzero(mv_candidates)[0]
        bs_v[mi] = _mv_bs_vec(pic, py4[mi], px4[mi], qy4[mi], qx4[mi])
    bs_full[qy4, qx4] = bs_v

    qp_l = np.zeros((h4, w4), np.int32)
    qp_l[qy4, qx4] = (pic.qp[py4, px4].astype(np.int32) +
                      pic.qp[qy4, qx4].astype(np.int32) + 1) >> 1
    beta_off = np.zeros((h4, w4), np.int32)
    beta_off[qy4, qx4] = pic.beta_offset[qy4, qx4]
    tc_off = np.zeros((h4, w4), np.int32)
    tc_off[qy4, qx4] = pic.tc_offset[qy4, qx4]

    def nofilt(y4, x4):
        v = pic.tq_bypass[y4, x4] != 0
        if sps.pcm_enabled and sps.pcm_loop_filter_disabled:
            v |= pic.pcm[y4, x4] != 0
        return v
    no_p = np.zeros((h4, w4), bool)
    no_q = np.zeros((h4, w4), bool)
    no_p[qy4, qx4] = nofilt(py4, px4)
    no_q[qy4, qx4] = nofilt(qy4, qx4)
    return bs_full, qp_l, beta_off, tc_off, no_p, no_q
