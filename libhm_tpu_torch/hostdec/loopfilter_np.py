# Copied from libhm_tpu/hostdec/loopfilter_np.py
"""Deblocking filter and SAO — numpy oracle.

Rebuild of reference TComLoopFilter (source/Lib/TLibCommon/TComLoopFilter.cpp:
130-923: V-pass then H-pass whole picture, boundary-strength derivation
xGetBoundaryStrengthSingle:411, per-pixel filters xPelFilterLuma/Chroma:800,870)
and TComSampleAdaptiveOffset (TComSampleAdaptiveOffset.cpp:375-810 offsetBlock,
PCM/lossless restoration xPCMRestoration).
"""
import numpy as np
from .picture import MODE_INTRA
from .tables import CHROMA_QP_SCALE
from .slicedec import (EDGE_TU_LEFT, EDGE_TU_TOP, EDGE_PU_LEFT, EDGE_PU_TOP,
                       EDGE_CU_LEFT, EDGE_CU_TOP)

# Rec. H.265 Table 8-12
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    13, 14, 16, 18, 20, 22, 24], np.int32)


def _mv_bs(pic, py4, px4, qy4, qx4):
    """BS=1 motion test between two 4x4 blocks (Rec. 8.7.2.4 / reference
    xGetBoundaryStrengthSingle)."""
    pdir = pic.inter_dir[py4, px4]
    qdir = pic.inter_dir[qy4, qx4]
    p_refs = []
    q_refs = []
    p_mvs = []
    q_mvs = []
    for l in range(2):
        if pdir & (1 << l):
            p_refs.append(int(pic.ref_poc[py4, px4, l]))
            p_mvs.append(pic.mv[py4, px4, l])
        if qdir & (1 << l):
            q_refs.append(int(pic.ref_poc[qy4, qx4, l]))
            q_mvs.append(pic.mv[qy4, qx4, l])
    if len(p_refs) != len(q_refs):
        return 1
    def far(a, b):
        return abs(int(a[0]) - int(b[0])) >= 4 or abs(int(a[1]) - int(b[1])) >= 4
    if len(p_refs) == 1:
        if p_refs[0] != q_refs[0]:
            return 1
        return 1 if far(p_mvs[0], q_mvs[0]) else 0
    # bi-prediction
    if sorted(p_refs) != sorted(q_refs):
        return 1
    if p_refs[0] == p_refs[1]:
        # same picture in both lists: both pairings must be "close"
        if (far(p_mvs[0], q_mvs[0]) or far(p_mvs[1], q_mvs[1])) and \
           (far(p_mvs[0], q_mvs[1]) or far(p_mvs[1], q_mvs[0])):
            return 1
        return 0
    # different pictures: match by reference
    if p_refs[0] == q_refs[0]:
        return 1 if (far(p_mvs[0], q_mvs[0]) or far(p_mvs[1], q_mvs[1])) else 0
    return 1 if (far(p_mvs[0], q_mvs[1]) or far(p_mvs[1], q_mvs[0])) else 0


def _no_filter(pic, sps, y4, x4):
    """Sample-side exclusion: PCM w/ pcm_loop_filter_disabled or lossless."""
    if pic.tq_bypass[y4, x4]:
        return True
    if sps.pcm_enabled and sps.pcm_loop_filter_disabled and pic.pcm[y4, x4]:
        return True
    return False


def _edge_allowed(pic, tile_map, sps, pps, qy4, qx4, py4, px4):
    """Cross-slice / cross-tile filtering permission."""
    if pic.slice_idx[qy4, qx4] != pic.slice_idx[py4, px4]:
        if not pic.loopfilter_across_slice[qy4, qx4] or \
           not pic.loopfilter_across_slice[py4, px4]:
            return False
    wc = sps.pic_width_ctbs
    s = sps.log2_ctb - 2
    tq = tile_map[(qy4 >> s) * wc + (qx4 >> s)]
    tp = tile_map[(py4 >> s) * wc + (px4 >> s)]
    if tq != tp and not pps.loop_filter_across_tiles:
        return False
    return True


def compute_bs(pic, sps, pps, tile_map, vertical):
    """BS per 4x4 block edge on the 8(x4) grid; 0 where no filtering."""
    h4, w4 = pic.depth.shape
    bs = np.zeros((h4, w4), np.int8)
    ef = pic.edge_flags
    if vertical:
        edge_mask = (EDGE_CU_LEFT | EDGE_PU_LEFT | EDGE_TU_LEFT)
        tu_bit, pu_bit = EDGE_TU_LEFT, EDGE_PU_LEFT
    else:
        edge_mask = (EDGE_CU_TOP | EDGE_PU_TOP | EDGE_TU_TOP)
        tu_bit, pu_bit = EDGE_TU_TOP, EDGE_PU_TOP
    for y4 in range(h4):
        for x4 in range(w4):
            if vertical:
                if x4 == 0 or (x4 & 1):  # 8-pel grid
                    continue
                py4, px4 = y4, x4 - 1
            else:
                if y4 == 0 or (y4 & 1):
                    continue
                py4, px4 = y4 - 1, x4
            flags = ef[y4, x4]
            if not (flags & edge_mask):
                continue
            if pic.deblock_disable[y4, x4]:
                continue
            if not _edge_allowed(pic, tile_map, sps, pps, y4, x4, py4, px4):
                continue
            if pic.pred_mode[y4, x4] == MODE_INTRA or \
               pic.pred_mode[py4, px4] == MODE_INTRA:
                bs[y4, x4] = 2
            elif (flags & tu_bit) and (pic.cbf_y[y4, x4] or pic.cbf_y[py4, px4]):
                bs[y4, x4] = 1
            elif flags & (pu_bit | tu_bit):
                bs[y4, x4] = _mv_bs(pic, py4, px4, y4, x4)
    return bs


def _filter_luma_line(src, offs, pos, tc, beta, no_p, no_q, maxv):
    """Filter one 4-row segment of a vertical edge (or transposed horizontal).

    src: plane; offs: step between p and q (1 for vertical edges);
    pos: (y, x) of q0 of the first of 4 lines; works on rows y..y+3.
    Mirrors reference xEdgeFilterLuma/xPelFilterLuma.
    """
    y, x = pos
    d_rows = []
    for i in (0, 3):
        p0 = int(src[y + i, x - 1]); p1 = int(src[y + i, x - 2]); p2 = int(src[y + i, x - 3])
        q0 = int(src[y + i, x]); q1 = int(src[y + i, x + 1]); q2 = int(src[y + i, x + 2])
        dp = abs(p2 - 2 * p1 + p0)
        dq = abs(q2 - 2 * q1 + q0)
        d_rows.append((dp, dq))
    dp0, dq0 = d_rows[0]
    dp3, dq3 = d_rows[1]
    d0, d3 = dp0 + dq0, dp3 + dq3
    d = d0 + d3
    if d >= beta:
        return
    # strong/weak decision using lines 0 and 3
    def strong(i, di):
        p0 = int(src[y + i, x - 1]); p3 = int(src[y + i, x - 4])
        q0 = int(src[y + i, x]); q3 = int(src[y + i, x + 3])
        return (2 * di < (beta >> 2)) and (abs(p3 - p0) + abs(q0 - q3) < (beta >> 3)) \
            and (abs(p0 - q0) < ((tc * 5 + 1) >> 1))
    sw = strong(0, d0) and strong(3, d3)
    for i in range(4):
        p = [int(src[y + i, x - 1 - k]) for k in range(4)]
        q = [int(src[y + i, x + k]) for k in range(4)]
        if sw:
            tc2 = 2 * tc
            if not no_p:
                src[y + i, x - 1] = np.clip((p[2] + 2 * p[1] + 2 * p[0] + 2 * q[0] + q[1] + 4) >> 3, p[0] - tc2, p[0] + tc2)
                src[y + i, x - 2] = np.clip((p[2] + p[1] + p[0] + q[0] + 2) >> 2, p[1] - tc2, p[1] + tc2)
                src[y + i, x - 3] = np.clip((2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3, p[2] - tc2, p[2] + tc2)
            if not no_q:
                src[y + i, x] = np.clip((q[2] + 2 * q[1] + 2 * q[0] + 2 * p[0] + p[1] + 4) >> 3, q[0] - tc2, q[0] + tc2)
                src[y + i, x + 1] = np.clip((q[2] + q[1] + q[0] + p[0] + 2) >> 2, q[1] - tc2, q[1] + tc2)
                src[y + i, x + 2] = np.clip((2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3, q[2] - tc2, q[2] + tc2)
        else:
            delta = (9 * (q[0] - p[0]) - 3 * (q[1] - p[1]) + 8) >> 4
            if abs(delta) < tc * 10:
                delta = int(np.clip(delta, -tc, tc))
                if not no_p:
                    src[y + i, x - 1] = np.clip(p[0] + delta, 0, maxv)
                if not no_q:
                    src[y + i, x] = np.clip(q[0] - delta, 0, maxv)
                side_thr = beta + (beta >> 1)
                if (dp0 + dp3) < (side_thr >> 3) and not no_p:
                    d2 = np.clip((((p[2] + p[0] + 1) >> 1) - p[1] + delta) >> 1,
                                 -(tc >> 1), tc >> 1)
                    src[y + i, x - 2] = np.clip(p[1] + d2, 0, maxv)
                if (dq0 + dq3) < (side_thr >> 3) and not no_q:
                    d2 = np.clip((((q[2] + q[0] + 1) >> 1) - q[1] - delta) >> 1,
                                 -(tc >> 1), tc >> 1)
                    src[y + i, x + 1] = np.clip(q[1] + d2, 0, maxv)


def deblock_picture(planes, pic, sps, pps):
    """In-place deblocking, V pass then H pass (reference loopFilterPic).

    Fully vectorized over edge segments: HEVC deblock edges sit on an
    8-pel grid and the luma filter reads <=4 / writes <=3 samples per
    side, so segments within one pass never overlap and all of them can
    be gathered, decided and scattered at once.
    """
    from .deblock_maps import compute_bs_maps
    tile_map = _tile_map(pic, sps, pps)
    for vertical in (True, False):
        bs, qp_l, beta_off, tc_off, no_p, no_q = \
            compute_bs_maps(pic, sps, pps, tile_map, vertical)
        _deblock_pass_vec(planes, pic, sps, pps, bs, qp_l, beta_off, tc_off,
                          no_p, no_q, vertical)


def deblock_picture_oracle(planes, pic, sps, pps):
    """Scalar reference implementation (kept as the test oracle)."""
    tile_map = _tile_map(pic, sps, pps)
    for vertical in (True, False):
        bs = compute_bs(pic, sps, pps, tile_map, vertical)
        _deblock_pass(planes, pic, sps, pps, bs, vertical)


def _deblock_pass_vec(planes, pic, sps, pps, bs_m, qp_m, boff_m, toff_m,
                      nop_m, noq_m, vertical):
    """One direction of deblocking, vectorized over 4-line edge segments.

    Mirrors reference TComLoopFilter::xEdgeFilterLuma/xPelFilterLuma and
    xEdgeFilterChroma/xPelFilterChroma semantics exactly (decisions from
    segment lines 0 and 3, per-line weak deltas, +-2*tc strong clips).
    """
    ys, xs = np.nonzero(bs_m)
    if len(ys) == 0:
        return
    b = bs_m[ys, xs].astype(np.int64)
    qp_l = qp_m[ys, xs].astype(np.int64)
    boff = boff_m[ys, xs].astype(np.int64)
    toff = toff_m[ys, xs].astype(np.int64)
    no_p = nop_m[ys, xs].astype(bool)
    no_q = noq_m[ys, xs].astype(bool)
    bd_shift = sps.bit_depth_luma - 8
    maxv_l = (1 << sps.bit_depth_luma) - 1
    beta = BETA_TABLE[np.clip(qp_l + boff, 0, 51)].astype(np.int64) << bd_shift
    tc = TC_TABLE[np.clip(qp_l + 2 * (b - 1) + toff, 0, 53)].astype(np.int64) \
        << bd_shift

    luma = planes[0] if vertical else planes[0].T
    if vertical:
        rows, cols = ys << 2, xs << 2
    else:
        rows, cols = xs << 2, ys << 2

    lsel = beta > 0
    if lsel.any():
        r = rows[lsel][:, None, None] + np.arange(4)[None, :, None]
        c = cols[lsel][:, None, None] + (np.arange(8) - 4)[None, None, :]
        W = luma[r, c].astype(np.int64)          # [n, 4, 8] p3..p0 q0..q3
        tcs = tc[lsel][:, None]
        betas = beta[lsel][:, None]
        nop = no_p[lsel][:, None]
        noq = no_q[lsel][:, None]
        p3, p2, p1, p0 = W[:, :, 0], W[:, :, 1], W[:, :, 2], W[:, :, 3]
        q0, q1, q2, q3 = W[:, :, 4], W[:, :, 5], W[:, :, 6], W[:, :, 7]
        dp = np.abs(p2 - 2 * p1 + p0)            # [n, 4]
        dq = np.abs(q2 - 2 * q1 + q0)
        d0 = dp[:, 0] + dq[:, 0]
        d3 = dp[:, 3] + dq[:, 3]
        d = (d0 + d3)[:, None]
        filt = d < betas                          # [n, 1]

        def strong_line(i, di):
            return (2 * di < (betas[:, 0] >> 2)) & \
                   (np.abs(p3[:, i] - p0[:, i]) + np.abs(q0[:, i] - q3[:, i])
                    < (betas[:, 0] >> 3)) & \
                   (np.abs(p0[:, i] - q0[:, i]) < ((tcs[:, 0] * 5 + 1) >> 1))
        sw = (strong_line(0, d0) & strong_line(3, d3))[:, None]

        out = W.copy()
        # strong filter (writes p2..q2, clipped to +-2*tc)
        tc2 = 2 * tcs
        sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      p0 - tc2, p0 + tc2)
        sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2)
        sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                      p2 - tc2, p2 + tc2)
        sq0 = np.clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      q0 - tc2, q0 + tc2)
        sq1 = np.clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - tc2, q1 + tc2)
        sq2 = np.clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                      q2 - tc2, q2 + tc2)
        # weak filter
        delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        wk_on = np.abs(delta) < tcs * 10          # [n, 4] per line
        dlt = np.clip(delta, -tcs, tcs)
        wp0 = np.clip(p0 + dlt, 0, maxv_l)
        wq0 = np.clip(q0 - dlt, 0, maxv_l)
        side_thr = (betas + (betas >> 1)) >> 3
        dEp = ((dp[:, 0] + dp[:, 3])[:, None] < side_thr)
        dEq = ((dq[:, 0] + dq[:, 3])[:, None] < side_thr)
        tch = tcs >> 1
        wp1 = np.clip(p1 + np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                   -tch, tch), 0, maxv_l)
        wq1 = np.clip(q1 + np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                   -tch, tch), 0, maxv_l)

        st = filt & sw
        wf = filt & ~sw & wk_on
        wrp = ~nop
        wrq = ~noq
        out[:, :, 1] = np.where(st & wrp, sp2, out[:, :, 1])
        out[:, :, 2] = np.where(st & wrp, sp1,
                                np.where(wf & wrp & dEp, wp1, out[:, :, 2]))
        out[:, :, 3] = np.where(st & wrp, sp0,
                                np.where(wf & wrp, wp0, out[:, :, 3]))
        out[:, :, 4] = np.where(st & wrq, sq0,
                                np.where(wf & wrq, wq0, out[:, :, 4]))
        out[:, :, 5] = np.where(st & wrq, sq1,
                                np.where(wf & wrq & dEq, wq1, out[:, :, 5]))
        out[:, :, 6] = np.where(st & wrq, sq2, out[:, :, 6])
        luma[r, c] = out.astype(luma.dtype)

    # chroma: BS==2 edges on the chroma 8-pel grid
    if sps.chroma_format_idc == 0:
        return
    ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
    grid = 8 << (ssx if vertical else ssy)
    coord = (xs << 2) if vertical else (ys << 2)
    csel = (b == 2) & (coord % grid == 0)
    if not csel.any():
        return
    maxv_c = (1 << sps.bit_depth_chroma) - 1
    bd_c = sps.bit_depth_chroma - 8
    qp_c = qp_l[csel]
    toff_c = toff[csel]
    nop_c = no_p[csel][:, None]
    noq_c = no_q[csel][:, None]
    if vertical:
        crow = (ys[csel] << 2) >> ssy
        ccol = (xs[csel] << 2) >> ssx
        nlines = 4 >> ssy
    else:
        crow = (xs[csel] << 2) >> ssx
        ccol = (ys[csel] << 2) >> ssy
        nlines = 4 >> ssx
    for comp in (1, 2):
        plane = planes[comp] if vertical else planes[comp].T
        qp_off = pps.cb_qp_offset if comp == 1 else pps.cr_qp_offset
        qpi = np.clip(qp_c + qp_off, 0, 57)
        qpc = np.asarray(CHROMA_QP_SCALE[sps.chroma_format_idc])[qpi]
        tcc = TC_TABLE[np.clip(qpc + 2 + toff_c, 0, 53)].astype(np.int64) \
            << bd_c
        sel = tcc > 0
        if not sel.any():
            continue
        r = crow[sel][:, None, None] + np.arange(nlines)[None, :, None]
        c = ccol[sel][:, None, None] + (np.arange(4) - 2)[None, None, :]
        W = plane[r, c].astype(np.int64)         # [m, nlines, 4] p1 p0 q0 q1
        p1, p0, q0, q1 = W[:, :, 0], W[:, :, 1], W[:, :, 2], W[:, :, 3]
        delta = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3,
                        -tcc[sel][:, None], tcc[sel][:, None])
        out = W.copy()
        out[:, :, 1] = np.where(~nop_c[sel],
                                np.clip(p0 + delta, 0, maxv_c), out[:, :, 1])
        out[:, :, 2] = np.where(~noq_c[sel],
                                np.clip(q0 - delta, 0, maxv_c), out[:, :, 2])
        plane[r, c] = out.astype(plane.dtype)


def _tile_map(pic, sps, pps):
    # reconstruct the tile map the parser used (kept on PicSyntax would be
    # cleaner; recomputed to keep PicSyntax lean)
    from .slicedec import SliceDecoder
    if not pps.tiles_enabled:
        return np.zeros(sps.pic_width_ctbs * sps.pic_height_ctbs, np.int32)
    sd = SliceDecoder.__new__(SliceDecoder)
    sd.sps, sd.pps = sps, pps
    sd.pic_w_ctbs = sps.pic_width_ctbs
    return SliceDecoder._build_tile_map(sd)


def _deblock_pass(planes, pic, sps, pps, bs, vertical):
    h4, w4 = bs.shape
    maxv_l = (1 << sps.bit_depth_luma) - 1
    maxv_c = (1 << sps.bit_depth_chroma) - 1
    luma = planes[0]
    if not vertical:
        luma = luma.T  # filter columns as rows via transpose view
    ys, xs = np.nonzero(bs)
    for y4, x4 in zip(ys, xs):
        b = bs[y4, x4]
        if vertical:
            qy4, qx4, py4, px4 = y4, x4, y4, x4 - 1
        else:
            qy4, qx4, py4, px4 = y4, x4, y4 - 1, x4
        qp_p = int(pic.qp[py4, px4])
        qp_q = int(pic.qp[qy4, qx4])
        qp_l = (qp_p + qp_q + 1) >> 1
        beta_off = int(pic.beta_offset[qy4, qx4])
        tc_off = int(pic.tc_offset[qy4, qx4])
        idx_b = min(max(qp_l + beta_off, 0), 51)
        idx_t = min(max(qp_l + 2 * (b - 1) + tc_off, 0), 53)
        bd_shift = sps.bit_depth_luma - 8
        beta = int(BETA_TABLE[idx_b]) << bd_shift
        tc = int(TC_TABLE[idx_t]) << bd_shift
        if tc == 0 and beta == 0:
            continue
        no_p = _no_filter(pic, sps, py4, px4)
        no_q = _no_filter(pic, sps, qy4, qx4)
        if beta:
            if vertical:
                pos = (y4 << 2, x4 << 2)
            else:
                pos = (x4 << 2, y4 << 2)  # transposed
            _filter_luma_line(luma, 1, pos, tc, beta, no_p, no_q, maxv_l)
        # chroma on BS==2, 16-luma-pel grid for 4:2:0
        if b == 2 and sps.chroma_format_idc != 0:
            self_ssx = sps.chroma_shift_x()
            self_ssy = sps.chroma_shift_y()
            grid = 8 << (self_ssx if vertical else self_ssy)
            coord = (x4 << 2) if vertical else (y4 << 2)
            if coord % grid:
                continue
            for c in (1, 2):
                plane = planes[c]
                if not vertical:
                    plane = plane.T
                qp_off = pps.cb_qp_offset if c == 1 else pps.cr_qp_offset
                qpi = min(max(qp_l + qp_off, 0), 57)
                qpc = CHROMA_QP_SCALE[sps.chroma_format_idc][qpi]
                idx_tc = min(max(qpc + 2 + tc_off, 0), 53)
                tcc = int(TC_TABLE[idx_tc]) << (sps.bit_depth_chroma - 8)
                if tcc == 0:
                    continue
                if vertical:
                    cy, cx = (y4 << 2) >> self_ssy, (x4 << 2) >> self_ssx
                    nlines = 4 >> self_ssy
                else:
                    cy, cx = (x4 << 2) >> self_ssx, (y4 << 2) >> self_ssy
                    nlines = 4 >> self_ssx
                for i in range(nlines):
                    p1 = int(plane[cy + i, cx - 2]); p0 = int(plane[cy + i, cx - 1])
                    q0 = int(plane[cy + i, cx]); q1 = int(plane[cy + i, cx + 1])
                    delta = int(np.clip(((((q0 - p0) * 4) + p1 - q1 + 4) >> 3),
                                        -tcc, tcc))
                    if not no_p:
                        plane[cy + i, cx - 1] = min(max(p0 + delta, 0), maxv_c)
                    if not no_q:
                        plane[cy + i, cx] = min(max(q0 - delta, 0), maxv_c)


# ---------------------------------------------------------------------------
# SAO
# ---------------------------------------------------------------------------
EO_NEIGHBORS = {
    1: ((0, -1), (0, 1)),     # EO 0 deg
    2: ((-1, 0), (1, 0)),     # EO 90
    3: ((-1, -1), (1, 1)),    # EO 135
    4: ((-1, 1), (1, -1)),    # EO 45
}


def sao_picture(planes, pic, sps, pps):
    """Whole-picture SAO (reads deblocked copy, writes in place)."""
    ncomp = 3 if sps.chroma_format_idc else 1
    srcs = [p.copy() for p in planes]
    wc, hc = sps.pic_width_ctbs, sps.pic_height_ctbs
    tile_map = _tile_map(pic, sps, pps)
    for addr in range(wc * hc):
        cx = (addr % wc) << sps.log2_ctb
        cy = (addr // wc) << sps.log2_ctb
        for c in range(ncomp):
            t = int(pic.sao_type[addr, c])
            if t < 0:
                continue
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            W, H = sps.width >> sx, sps.height >> sy
            x0, y0 = cx >> sx, cy >> sy
            x1 = min(x0 + (sps.ctb_size >> sx), W)
            y1 = min(y0 + (sps.ctb_size >> sy), H)
            scale = pps.sao_offset_scale_luma if c == 0 else \
                pps.sao_offset_scale_chroma
            offs = [int(v) << scale for v in pic.sao_offsets[addr, c]]
            src, dst = srcs[c], planes[c]
            if t == 0:  # band offset
                band_shift = bd - 5
                band_pos = int(pic.sao_band_pos[addr, c])
                lut = np.zeros(32, np.int32)
                for i in range(4):
                    lut[(band_pos + i) % 32] = offs[i]
                blk = src[y0:y1, x0:x1]
                dst[y0:y1, x0:x1] = np.clip(
                    blk + lut[blk >> band_shift], 0, (1 << bd) - 1)
            else:  # edge offset
                (dy1, dx1), (dy2, dx2) = EO_NEIGHBORS[t]
                blk = src[y0:y1, x0:x1].astype(np.int64)
                n1 = src[max(0, y0 + dy1):y1 + dy1, max(0, x0 + dx1):x1 + dx1]
                # build padded neighbor views with edge validity masks
                out = dst[y0:y1, x0:x1]
                h, w = blk.shape
                yy, xx = np.mgrid[y0:y1, x0:x1]
                ny1, nx1 = yy + dy1, xx + dx1
                ny2, nx2 = yy + dy2, xx + dx2
                valid = (ny1 >= 0) & (ny1 < H) & (nx1 >= 0) & (nx1 < W) & \
                        (ny2 >= 0) & (ny2 < H) & (nx2 >= 0) & (nx2 < W)
                valid &= _sao_cross_ok(pic, sps, pps, tile_map, yy, xx,
                                       ny1, nx1, sx, sy)
                valid &= _sao_cross_ok(pic, sps, pps, tile_map, yy, xx,
                                       ny2, nx2, sx, sy)
                n1 = src[np.clip(ny1, 0, H - 1), np.clip(nx1, 0, W - 1)].astype(np.int64)
                n2 = src[np.clip(ny2, 0, H - 1), np.clip(nx2, 0, W - 1)].astype(np.int64)
                sign1 = np.sign(blk - n1).astype(np.int64)
                sign2 = np.sign(blk - n2).astype(np.int64)
                etype = sign1 + sign2
                lut = np.zeros(5, np.int64)
                lut[0] = offs[0]  # -2
                lut[1] = offs[1]  # -1
                lut[3] = offs[2]  # +1
                lut[4] = offs[3]  # +2
                delta = lut[(etype + 2)]
                res = np.where(valid, np.clip(blk + delta, 0, (1 << bd) - 1), blk)
                out[:, :] = res.astype(np.int32)
    _restore_unfiltered(planes, srcs, pic, sps)


def _sao_cross_ok(pic, sps, pps, tile_map, yy, xx, ny, nx, sx, sy):
    """Slice/tile crossing validity for SAO neighbor samples."""
    ly, lx = yy << sy, xx << sx
    lny = np.clip(ny << sy, 0, (pic.h4 << 2) - 1)
    lnx = np.clip(nx << sx, 0, (pic.w4 << 2) - 1)
    cur_slice = pic.slice_idx[ly >> 2, lx >> 2]
    nb_slice = pic.slice_idx[lny >> 2, lnx >> 2]
    ok_slice = (cur_slice == nb_slice) | \
        (pic.loopfilter_across_slice[ly >> 2, lx >> 2].astype(bool) &
         pic.loopfilter_across_slice[lny >> 2, lnx >> 2].astype(bool))
    wc = sps.pic_width_ctbs
    cur_tile = tile_map[(ly >> sps.log2_ctb) * wc + (lx >> sps.log2_ctb)]
    nb_tile = tile_map[(lny >> sps.log2_ctb) * wc + (lnx >> sps.log2_ctb)]
    ok_tile = (cur_tile == nb_tile) | bool(pps.loop_filter_across_tiles)
    return ok_slice & ok_tile


def _restore_unfiltered(planes, pre_sao, pic, sps):
    """PCM / transquant-bypass restoration (reference xPCMRestoration).

    Restores the pre-loop-filter reconstruction for PCM CUs (when
    pcm_loop_filter_disabled) and lossless CUs.  Requires the pre-filter
    planes, which the caller tracks on pic as `prefilter_planes`.
    """
    pre = getattr(pic, "prefilter_planes", None)
    if pre is None:
        return
    mask4 = pic.tq_bypass.astype(bool)
    if sps.pcm_enabled and sps.pcm_loop_filter_disabled:
        mask4 |= pic.pcm.astype(bool)
    if not mask4.any():
        return
    ncomp = 3 if sps.chroma_format_idc else 1
    for c in range(ncomp):
        sx = sps.chroma_shift_x() if c else 0
        sy = sps.chroma_shift_y() if c else 0
        mask = np.kron(mask4, np.ones((4 >> sy, 4 >> sx), bool))
        h, w = planes[c].shape
        mask = mask[:h, :w]
        planes[c][mask] = pre[c][mask]
