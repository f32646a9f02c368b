# Copied from libhm_tpu/hostdec/motion.py
"""Motion derivation (merge / AMVP / TMVP) and motion compensation.

Rebuild of reference TComDataCU::getInterMergeCandidates / fillMvpCand
(source/Lib/TLibCommon/TComDataCU.cpp), the temporal MV derivation with
compressed 16x16 motion (TComPic compressMotion), and
TComPrediction::motionCompensation with TComInterpolationFilter's 8/4-tap
separable filters and TComYuv::addAvg / TComWeightPrediction epilogues
(TComPrediction.cpp:514-716, TComInterpolationFilter.cpp:57-250,
TComWeightPrediction.cpp:44-150).

Derivation runs at parse time on the host (it feeds subsequent syntax
contexts); compensation is the numpy oracle mirrored by the TPU kernel in
libhm_tpu/ops/interp.py.
"""
import numpy as np

from .picture import (InterPU, MODE_INTER, MODE_INTRA, SIZE_2Nx2N, SIZE_2NxN,
                      SIZE_Nx2N, SIZE_NxN, SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N,
                      SIZE_nRx2N)

IF_INTERNAL_PREC = 14
IF_OFFS = 1 << (IF_INTERNAL_PREC - 1)

LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int64)

CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], np.int64)


def mc_headroom(bd):
    """shift3 of H.265 8.5.3.3.3.1, Max(2, 14 - bitDepth): the left shift
    of a full-sample prediction onto the 14-bit intermediate scale, and
    the right shift of the default uni-prediction epilogue.  The default
    bi-prediction average shifts by one more, Max(3, 15 - bitDepth)
    (8.5.3.3.4.2), and the first filter pass by 6 - mc_headroom(bd),
    Min(4, bitDepth - 8).  Version 1's 14 - bitDepth is the same up to
    12 bits."""
    return max(2, IF_INTERNAL_PREC - bd)


def bi_average(p0, p1, bd):
    """Default weighted prediction of two lists (8.5.3.3.4.2): the 14-bit
    intermediates summed, shifted by shift2 = Max(3, 15 - bitDepth) and
    clipped to the sample range."""
    shift = mc_headroom(bd) + 1
    off = (1 << (shift - 1)) + 2 * IF_OFFS
    return np.clip((p0 + p1 + off) >> shift, 0, (1 << bd) - 1)


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def mv_scale(mv, tb, td):
    """Temporal MV scaling (Rec. 8.5.3.2.8 eq. 8-183..186)."""
    if tb == td:
        return mv
    tb = _clip3(-128, 127, tb)
    td = _clip3(-128, 127, td)
    tx = (16384 + (abs(td) >> 1)) // td
    dsf = _clip3(-4096, 4095, (tb * tx + 32) >> 6)
    mx = _clip3(-32768, 32767, (dsf * mv[0] + 127 + (1 if dsf * mv[0] < 0 else 0)) >> 8)
    my = _clip3(-32768, 32767, (dsf * mv[1] + 127 + (1 if dsf * mv[1] < 0 else 0)) >> 8)
    return (mx, my)


class Cand:
    __slots__ = ("inter_dir", "mv", "ref_idx")

    def __init__(self, inter_dir=0, mv=((0, 0), (0, 0)), ref_idx=(-1, -1)):
        self.inter_dir = inter_dir
        self.mv = [tuple(mv[0]), tuple(mv[1])]
        self.ref_idx = list(ref_idx)

    def same_motion(self, o):
        if self.inter_dir != o.inter_dir:
            return False
        for l in range(2):
            if self.inter_dir & (1 << l):
                if self.mv[l] != o.mv[l] or self.ref_idx[l] != o.ref_idx[l]:
                    return False
        return True


class MotionDeriver:
    """Per-slice motion derivation + final MV map writing."""

    def __init__(self, slicedec, sh, ref_lists):
        self.sd = slicedec
        self.sh = sh
        self.ref_lists = ref_lists   # [list0, list1] of DecodedPicture
        self.poc = sh.poc
        # low-delay check: every reference POC <= current POC
        self.all_refs_before = all(
            p is not None and p.poc <= sh.poc
            for lst in ref_lists for p in lst)
        col_list = 1 - sh.collocated_from_l0
        self.col_pic = None
        if sh.temporal_mvp and len(ref_lists[col_list]) > sh.collocated_ref_idx:
            self.col_pic = ref_lists[col_list][sh.collocated_ref_idx]

    # -- helpers over the current picture's 4x4 maps ----------------------
    def _blk(self, x, y, cur_x, cur_y, check_z=True):
        """Returns (inter_dir, mv, ref_idx, ref_poc, ref_lt) or None."""
        sd = self.sd
        if not sd.available(x, y, cur_x, cur_y, check_z):
            return None
        pic = sd.pic
        x4, y4 = x >> 2, y >> 2
        if pic.pred_mode[y4, x4] != MODE_INTER:
            return None
        return (int(pic.inter_dir[y4, x4]),
                [tuple(pic.mv[y4, x4, 0]), tuple(pic.mv[y4, x4, 1])],
                [int(pic.ref_idx[y4, x4, 0]), int(pic.ref_idx[y4, x4, 1])],
                [int(pic.ref_poc[y4, x4, 0]), int(pic.ref_poc[y4, x4, 1])],
                [int(pic.ref_is_lt[y4, x4, 0]), int(pic.ref_is_lt[y4, x4, 1])])

    def _ref_poc(self, l, idx):
        p = self.ref_lists[l][idx]
        return p.poc if p is not None else 0

    def _ref_lt(self, l, idx):
        p = self.ref_lists[l][idx]
        return p.is_long_term if p is not None else False

    # ------------------------------------------------------------------
    # merge (Rec. 8.5.3.2.3 / reference getInterMergeCandidates)
    def merge_candidates(self, x, y, w, h, cx, cy, cu_size, pu_idx, part_size,
                         merge_idx):
        return self.merge_candidate_list(x, y, w, h, cx, cy, cu_size,
                                         pu_idx, part_size)[merge_idx]

    def merge_candidate_list(self, x, y, w, h, cx, cy, cu_size, pu_idx,
                             part_size):
        """The full padded candidate list (derive once; the per-index
        accessor above re-derives every call, which the encoder's
        candidate sweep should avoid)."""
        sd, sh = self.sd, self.sh
        plevel = sd.pps.log2_parallel_merge_level
        single_mcl = plevel > 2 and cu_size == 8
        if single_mcl:
            x, y, w, h = cx, cy, cu_size, cu_size
            pu_idx = 0
            part_size = SIZE_2Nx2N

        def par_ok(nx, ny):
            return (x >> plevel != nx >> plevel) or (y >> plevel != ny >> plevel)

        cands = []
        # A1
        a1 = None
        if not (pu_idx == 1 and part_size in (SIZE_Nx2N, SIZE_nLx2N, SIZE_nRx2N)):
            nx, ny = x - 1, y + h - 1
            if par_ok(nx, ny):
                a1 = self._blk(nx, ny, x, y, check_z=False)
        if a1:
            cands.append(Cand(a1[0], a1[1], a1[2]))
        # B1
        b1 = None
        if not (pu_idx == 1 and part_size in (SIZE_2NxN, SIZE_2NxnU, SIZE_2NxnD)):
            nx, ny = x + w - 1, y - 1
            if par_ok(nx, ny):
                b1 = self._blk(nx, ny, x, y, check_z=False)
        if b1 and not (a1 and Cand(b1[0], b1[1], b1[2]).same_motion(Cand(a1[0], a1[1], a1[2]))):
            cands.append(Cand(b1[0], b1[1], b1[2]))
        else:
            b1 = None if not b1 else b1  # keep for B0/B2 pruning reference
        # B0
        nx, ny = x + w, y - 1
        b0 = self._blk(nx, ny, x, y) if par_ok(nx, ny) else None
        if b0 and not (b1 and Cand(b0[0], b0[1], b0[2]).same_motion(Cand(b1[0], b1[1], b1[2]))):
            cands.append(Cand(b0[0], b0[1], b0[2]))
        # A0
        nx, ny = x - 1, y + h
        a0 = self._blk(nx, ny, x, y) if par_ok(nx, ny) else None
        if a0 and not (a1 and Cand(a0[0], a0[1], a0[2]).same_motion(Cand(a1[0], a1[1], a1[2]))):
            cands.append(Cand(a0[0], a0[1], a0[2]))
        # B2 (only if fewer than 4 so far)
        if len(cands) < 4:
            nx, ny = x - 1, y - 1
            b2 = self._blk(nx, ny, x, y) if par_ok(nx, ny) else None
            if b2:
                c2 = Cand(b2[0], b2[1], b2[2])
                if not (a1 and c2.same_motion(Cand(a1[0], a1[1], a1[2]))) and \
                   not (b1 and c2.same_motion(Cand(b1[0], b1[1], b1[2]))):
                    cands.append(c2)

        max_cand = sh.max_num_merge_cand
        # TMVP
        if sh.temporal_mvp and len(cands) < max_cand and self.col_pic is not None:
            dir_ = 0
            mvs = [(0, 0), (0, 0)]
            refs = [-1, -1]
            mv0 = self._tmvp(x, y, w, h, 0, 0)
            if mv0 is not None:
                dir_ |= 1
                mvs[0] = mv0
                refs[0] = 0
            if sh.slice_type == 0:  # B
                mv1 = self._tmvp(x, y, w, h, 1, 0)
                if mv1 is not None:
                    dir_ |= 2
                    mvs[1] = mv1
                    refs[1] = 0
            if dir_:
                cands.append(Cand(dir_, mvs, refs))

        # combined bi-predictive (B slices)
        if sh.slice_type == 0 and len(cands) > 1 and len(cands) < max_cand:
            pairs = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                     (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
            norig = len(cands)
            for (i, j) in pairs:
                if len(cands) >= max_cand:
                    break
                if i >= norig or j >= norig:
                    break
                ci, cj = cands[i], cands[j]
                if not (ci.inter_dir & 1) or not (cj.inter_dir & 2):
                    continue
                if self._ref_poc(0, ci.ref_idx[0]) == self._ref_poc(1, cj.ref_idx[1]) \
                        and ci.mv[0] == cj.mv[1]:
                    continue
                cands.append(Cand(3, [ci.mv[0], cj.mv[1]],
                                  [ci.ref_idx[0], cj.ref_idx[1]]))

        # zero candidates
        nref = min(self.sh.num_ref_idx[0],
                   self.sh.num_ref_idx[1]) if sh.slice_type == 0 \
            else self.sh.num_ref_idx[0]
        zero_idx = 0
        while len(cands) < max_cand:
            r = zero_idx if zero_idx < nref else 0
            if sh.slice_type == 0:
                cands.append(Cand(3, [(0, 0), (0, 0)], [r, r]))
            else:
                cands.append(Cand(1, [(0, 0), (0, 0)], [r, -1]))
            zero_idx += 1
        return cands

    # ------------------------------------------------------------------
    def _tmvp(self, x, y, w, h, target_list, target_ref_idx):
        """Temporal MV for merge/AMVP (Rec. 8.5.3.2.8)."""
        col = self.col_pic
        if col is None or col.pic_syntax is None:
            return None
        sd = self.sd
        # bottom-right, constrained to the same CTU row and picture
        cand_pos = []
        br_x, br_y = x + w, y + h
        if (br_y >> sd.log2_ctb) == (y >> sd.log2_ctb) and \
                br_y < sd.H and br_x < sd.W:
            cand_pos.append(((br_x >> 4) << 4, (br_y >> 4) << 4))
        cand_pos.append((((x + (w >> 1)) >> 4) << 4, ((y + (h >> 1)) >> 4) << 4))
        tgt_poc = self._ref_poc(target_list, target_ref_idx)
        tgt_lt = self._ref_lt(target_list, target_ref_idx)
        cp = col.pic_syntax
        for (cxp, cyp) in cand_pos:
            x4, y4 = cxp >> 2, cyp >> 2
            if x4 >= cp.w4 or y4 >= cp.h4:
                continue
            if cp.pred_mode[y4, x4] != MODE_INTER:
                continue
            cdir = int(cp.inter_dir[y4, x4])
            if cdir == 0:
                continue
            # select the col list (Rec. 8.5.3.2.9)
            if not (cdir & 1):
                use = 1
            elif not (cdir & 2):
                use = 0
            else:
                if self.all_refs_before:
                    use = target_list
                else:
                    # Rec. 8.5.3.2.9: listCol = L[collocated_from_l0_flag]
                    use = self.sh.collocated_from_l0
            col_mv = tuple(int(v) for v in cp.mv[y4, x4, use])
            col_ref_poc = int(cp.ref_poc[y4, x4, use])
            col_ref_lt = bool(cp.ref_is_lt[y4, x4, use])
            if col_ref_lt != bool(tgt_lt):
                continue
            if tgt_lt:
                return col_mv
            tb = self.poc - tgt_poc
            td = col.poc - col_ref_poc
            if td == 0:
                return col_mv
            return mv_scale(col_mv, tb, td)
        return None

    # ------------------------------------------------------------------
    # AMVP (Rec. 8.5.3.2.6-7 / reference fillMvpCand)
    def amvp_candidates(self, x, y, w, h, target_list, target_ref_idx):
        tgt_poc = self._ref_poc(target_list, target_ref_idx)
        tgt_lt = bool(self._ref_lt(target_list, target_ref_idx))

        a0 = self._blk(x - 1, y + h, x, y)
        a1 = self._blk(x - 1, y + h - 1, x, y, check_z=False)
        is_scaled = (a0 is not None) or (a1 is not None)

        def match_unscaled(blk):
            if blk is None:
                return None
            dir_, mvs, refs, pocs, lts = blk
            for l in (target_list, 1 - target_list):
                if (dir_ & (1 << l)) and pocs[l] == tgt_poc and \
                        bool(lts[l]) == tgt_lt:
                    return mvs[l]
            return None

        def match_scaled(blk):
            if blk is None:
                return None
            dir_, mvs, refs, pocs, lts = blk
            for l in (target_list, 1 - target_list):
                if (dir_ & (1 << l)) and bool(lts[l]) == tgt_lt:
                    if tgt_lt:
                        return mvs[l]
                    return mv_scale(mvs[l], self.poc - tgt_poc,
                                    self.poc - pocs[l])
            return None

        mv_a = None
        for blk in (a0, a1):
            mv_a = match_unscaled(blk)
            if mv_a is not None:
                break
        if mv_a is None:
            for blk in (a0, a1):
                mv_a = match_scaled(blk)
                if mv_a is not None:
                    break

        b0 = self._blk(x + w, y - 1, x, y)
        b1 = self._blk(x + w - 1, y - 1, x, y, check_z=False)
        b2 = self._blk(x - 1, y - 1, x, y)
        mv_b = None
        for blk in (b0, b1, b2):
            mv_b = match_unscaled(blk)
            if mv_b is not None:
                break
        if not is_scaled:
            if mv_a is None:
                mv_a = mv_b
                mv_b = None
            if mv_b is None or True:
                # re-derive B with scaling
                mv_b = None
                for blk in (b0, b1, b2):
                    mv_b = match_scaled(blk)
                    if mv_b is not None:
                        break
        cands = []
        if mv_a is not None:
            cands.append(mv_a)
        if mv_b is not None and mv_b != mv_a:
            cands.append(mv_b)
        if len(cands) < 2 and self.sh.temporal_mvp and self.col_pic is not None:
            tmv = self._tmvp(x, y, w, h, target_list, target_ref_idx)
            if tmv is not None:
                cands.append(tmv)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands

    # ------------------------------------------------------------------
    # entry points called from the slice parser
    def apply_merge(self, sd, x, y, w, h, merge_idx, cx, cy, cu_size, pu_idx):
        part_size = int(sd.pic.part_size[cy >> 2, cx >> 2])
        cand = self.merge_candidates(x, y, w, h, cx, cy, cu_size, pu_idx,
                                     part_size, merge_idx)
        dir_ = cand.inter_dir
        # clamp to available lists (P slice: L0 only)
        if self.sh.num_ref_idx[1] == 0:
            dir_ &= 1
        # bi-prediction restriction for 8x4/4x8 PUs (Rec. 8.5.3.2.2:
        # nPbW + nPbH == 12 forces the candidate to L0)
        if w + h == 12 and dir_ == 3:
            dir_ = 1
            cand.ref_idx[1] = -1
            cand.mv[1] = (0, 0)
        self._write_pu(x, y, w, h, dir_, cand.mv, cand.ref_idx,
                       merge=1, merge_idx=merge_idx)

    def apply_amvp(self, sd, x, y, w, h, inter_dir, ref_idx, mvd, mvp_idx,
                   cx, cy, cu_size, pu_idx, part_size):
        mvs = [(0, 0), (0, 0)]
        for l in range(2):
            if inter_dir & (1 << l):
                cands = self.amvp_candidates(x, y, w, h, l, ref_idx[l])
                p = cands[mvp_idx[l]]
                mvs[l] = (p[0] + mvd[l][0], p[1] + mvd[l][1])
        self._write_pu(x, y, w, h, inter_dir, mvs, ref_idx)

    def _write_pu(self, x, y, w, h, inter_dir, mvs, ref_idx, merge=0,
                  merge_idx=-1):
        pic = self.sd.pic
        sl = np.s_[y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2]
        pic.inter_dir[sl] = inter_dir
        ref_pics = [None, None]
        for l in range(2):
            if inter_dir & (1 << l):
                pic.mv[sl + (l,)] = mvs[l]
                pic.ref_idx[sl + (l,)] = ref_idx[l]
                rp = self.ref_lists[l][ref_idx[l]]
                ref_pics[l] = rp
                pic.ref_poc[sl + (l,)] = rp.poc if rp else 0
                pic.ref_is_lt[sl + (l,)] = (1 if (rp and rp.is_long_term) else 0)
            else:
                pic.ref_idx[sl + (l,)] = -1
        pu = InterPU(x, y, w, h, inter_dir,
                     [tuple(mvs[0]), tuple(mvs[1])], list(ref_idx), None)
        pu.merge = merge
        pu.merge_idx = merge_idx
        pu.ref_poc = ref_pics  # store picture objects for MC
        if self.sh.wp_luma is not None:
            # resolved per-PU weights: {denom_l, denom_c, w[l][c], o[l][c]}
            ww = [[0, 0, 0], [0, 0, 0]]
            oo = [[0, 0, 0], [0, 0, 0]]
            for l in range(2):
                ri = ref_idx[l] if ref_idx[l] >= 0 else 0
                _, wl, ol = self.sh.wp_luma[l][ri] if self.sh.wp_luma[l] and ri < len(self.sh.wp_luma[l]) and self.sh.wp_luma[l][ri] else (0, 0, 0)
                ww[l][0], oo[l][0] = wl, ol
                if self.sh.wp_chroma is not None and self.sh.wp_chroma[l] and ri < len(self.sh.wp_chroma[l]) and self.sh.wp_chroma[l][ri]:
                    _, cb, cr = self.sh.wp_chroma[l][ri]
                    ww[l][1], oo[l][1] = cb
                    ww[l][2], oo[l][2] = cr
            pu.wp = {"denom_l": self.sh.wp_log2_denom_luma,
                     "denom_c": self.sh.wp_log2_denom_chroma,
                     "w": ww, "o": oo}
        pic.inter_list.append(pu)


# ---------------------------------------------------------------------------
# Motion compensation (numpy oracle)
# ---------------------------------------------------------------------------
def _fetch_block(plane, x0, y0, w, h):
    """Gather with edge clamp (equivalent to reference border extension)."""
    H, W = plane.shape
    if 0 <= x0 and x0 + w <= W and 0 <= y0 and y0 + h <= H:
        # fully interior block: plain slice (the overwhelmingly common case)
        return plane[y0:y0 + h, x0:x0 + w].astype(np.int32)
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def _interp(plane, x, y, w, h, mvx, mvy, frac_bits_x, frac_bits_y, taps,
            filt_table, bd, is_last):
    """Separable MC interpolation for one block/component.

    The chroma filter table is eighth-pel; for 4:4:4 and the vertical axis
    of 4:2:2 the fractional phase indexes it scaled by 2 (reference
    TComInterpolationFilter.cpp:346 'frac << (1 - cs)').
    """
    ts_x = (3 - frac_bits_x) if taps == 4 else 0
    ts_y = (3 - frac_bits_y) if taps == 4 else 0
    fx = (mvx & ((1 << frac_bits_x) - 1)) << ts_x
    fy = (mvy & ((1 << frac_bits_y) - 1)) << ts_y
    ix = x + (mvx >> frac_bits_x)
    iy = y + (mvy >> frac_bits_y)
    headroom = mc_headroom(bd)
    half = taps // 2 - 1
    if fx == 0 and fy == 0:
        blk = _fetch_block(plane, ix, iy, w, h)
        if is_last:
            return blk
        return (blk << headroom) - IF_OFFS
    if fy == 0:
        src = _fetch_block(plane, ix - half, iy, w + taps - 1, h)
        return _filt_h(src, filt_table[fx], taps, w, bd, True, is_last)
    if fx == 0:
        src = _fetch_block(plane, ix, iy - half, w, h + taps - 1)
        return _filt_v(src, filt_table[fy], taps, h, bd, True, is_last)
    src = _fetch_block(plane, ix - half, iy - half, w + taps - 1, h + taps - 1)
    tmp = _filt_h(src, filt_table[fx], taps, w, bd, True, False)
    return _filt_v(tmp, filt_table[fy], taps, h, bd, False, is_last)


def _filt_params(bd, is_first, is_last):
    headroom = mc_headroom(bd)
    shift = 6
    if is_last:
        shift += 0 if is_first else headroom
        offset = (1 << (shift - 1)) + (0 if is_first else (IF_OFFS << 6))
    else:
        shift -= headroom if is_first else 0
        offset = (-IF_OFFS << shift) if is_first else 0
    return shift, offset


def _filt_h(src, coefs, taps, w, bd, is_first, is_last):
    shift, offset = _filt_params(bd, is_first, is_last)
    acc = np.zeros((src.shape[0], w), np.int32)
    for i in range(taps):
        c = int(coefs[i])
        if c:
            acc += c * src[:, i:i + w]
    val = (acc + offset) >> shift
    if is_last:
        return np.clip(val, 0, (1 << bd) - 1)
    return val


def _filt_v(src, coefs, taps, h, bd, is_first, is_last):
    shift, offset = _filt_params(bd, is_first, is_last)
    acc = np.zeros((h, src.shape[1]), np.int32)
    for i in range(taps):
        c = int(coefs[i])
        if c:
            acc += c * src[i:i + h, :]
    val = (acc + offset) >> shift
    if is_last:
        return np.clip(val, 0, (1 << bd) - 1)
    return val


def motion_compensate_np_vec(recon, ref_pics_unused, residuals):
    """Vectorized MC over PUs grouped by (w, h).

    PUs are the atomic MC units, so grouping by size (HEVC has ~20 distinct
    PU shapes) batches the separable interpolation with minimal gather
    overdraw (a 16x16 PU reads a 23x23 window: 2.1x, vs 7.6x for a 4x4
    rasterization).  Per-block filter taps come from the phase table, so no
    per-phase grouping is needed.

    Bit-exact with the scalar oracle below: the only case where blanket
    H-then-V two-stage filtering is NOT exact is (fx!=0, fy==0, unidir
    final) at bit depths > 8 -- the oracle applies a single H stage with
    shift 6 while an identity V stage would re-round.  That case runs as a
    separate batch with the stages swapped (identity V first), which
    reproduces (sum(c*x) + 32) >> 6 exactly.
    """
    pic, sps = recon.pic, recon.sps
    if not pic.inter_list:
        return
    pocs = {}
    for pu in pic.inter_list:
        for l in range(2):
            rp = pu.ref_poc[l]
            if rp is not None and rp.poc not in pocs:
                pocs[rp.poc] = rp
    poc_list = sorted(pocs)
    poc_index = {q: i for i, q in enumerate(poc_list)}

    groups = {}
    for pu in pic.inter_list:
        groups.setdefault((pu.w, pu.h), []).append(pu)

    rsps = next(iter(pocs.values())).sps
    ref_cache = [None] * recon.ncomp

    def ref_stack(c, Hc, Wc):
        if ref_cache[c] is None:
            def mc_plane(rp):
                cache = getattr(rp, "_mc_cache", None)
                if cache is None:
                    cache = rp._mc_cache = {}
                if c not in cache:
                    cache[c] = np.ascontiguousarray(rp.planes[c][:Hc, :Wc],
                                                    dtype=np.int32)
                return cache[c]
            ref_cache[c] = np.stack([mc_plane(pocs[q]) for q in poc_list])
        return ref_cache[c]

    for (pw, ph), pus in groups.items():
        n = len(pus)
        dirm = np.array([pu.inter_dir for pu in pus], np.int32)
        mv = np.array([pu.mv for pu in pus], np.int64)          # [n, 2, 2]
        px = np.array([pu.x for pu in pus], np.int64)
        py = np.array([pu.y for pu in pus], np.int64)
        sel = np.zeros((n, 2), np.int32)
        for i, pu in enumerate(pus):
            for l in range(2):
                if pu.inter_dir & (1 << l):
                    sel[i, l] = poc_index[pu.ref_poc[l].poc]
        wp_blk = np.array([getattr(pu, "wp", None) is not None for pu in pus])
        has_wp = wp_blk.any()
        bi = dirm == 3
        uni = ~bi
        uni_l = dirm == 1
        is_last_blk = uni & ~wp_blk

        for c in range(recon.ncomp):
            ssx = sps.chroma_shift_x() if c else 0
            ssy = sps.chroma_shift_y() if c else 0
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            taps = 8 if c == 0 else 4
            half = taps // 2 - 1
            ftab = np.asarray(LUMA_FILTER if c == 0 else CHROMA_FILTER,
                              np.int32)
            fbx = 2 + (ssx if c else 0)
            fby = 2 + (ssy if c else 0)
            blkx, blky = pw >> ssx, ph >> ssy
            Wc, Hc = rsps.width >> ssx, rsps.height >> ssy
            refs = ref_stack(c, Hc, Wc)
            bx = px >> ssx
            by = py >> ssy
            hr = mc_headroom(bd)
            maxv = (1 << bd) - 1
            preds = np.zeros((n, 2, blky, blkx), np.int32)
            chunk = max(1, (1 << 22) // ((blky + taps) * (blkx + taps)))
            for l in range(2):
                lm = (dirm & (1 << l)) != 0
                if not lm.any():
                    continue
                mvx = mv[:, l, 0]
                mvy = mv[:, l, 1]
                # chroma table is eighth-pel: scale the phase for
                # non-subsampled axes (TComInterpolationFilter.cpp:346)
                ts_x = (3 - fbx) if taps == 4 else 0
                ts_y = (3 - fby) if taps == 4 else 0
                fx = (mvx & ((1 << fbx) - 1)) << ts_x
                fy = (mvy & ((1 << fby) - 1)) << ts_y
                ix = bx + (mvx >> fbx)
                iy = by + (mvy >> fby)
                caseB = lm & is_last_blk & (fx != 0) & (fy == 0)
                batches = (
                    (lm & is_last_blk & ~caseB, True, False),
                    (lm & ~is_last_blk, False, False),
                    (caseB, True, True),
                )
                for mask, last, swapped in batches:
                    idx = np.nonzero(mask)[0]
                    if len(idx) == 0:
                        continue
                    for s0 in range(0, len(idx), chunk):
                        ii = idx[s0:s0 + chunk]
                        ch = ftab[fx[ii]]            # [m, taps]
                        cv = ftab[fy[ii]]
                        if swapped:
                            rows = np.clip(iy[ii][:, None] + np.arange(blky),
                                           0, Hc - 1)
                            cols = np.clip(ix[ii][:, None] +
                                           np.arange(blkx + taps - 1) - half,
                                           0, Wc - 1)
                            W = refs[sel[ii, l][:, None, None],
                                     rows[:, :, None], cols[:, None, :]]
                            t = (W << hr) - IF_OFFS   # int32; |t| < 2**18
                            sh2 = 6 + hr
                            off2 = (1 << (sh2 - 1)) + (IF_OFFS << 6)
                            acc = ch[:, 0, None, None] * t[:, :, 0:blkx]
                            for k in range(1, taps):
                                acc += ch[:, k, None, None] * t[:, :, k:k + blkx]
                            out = np.clip((acc + off2) >> sh2, 0, maxv)
                        else:
                            rows = np.clip(iy[ii][:, None] +
                                           np.arange(blky + taps - 1) - half,
                                           0, Hc - 1)
                            cols = np.clip(ix[ii][:, None] +
                                           np.arange(blkx + taps - 1) - half,
                                           0, Wc - 1)
                            W = refs[sel[ii, l][:, None, None],
                                     rows[:, :, None], cols[:, None, :]]
                            sh1 = 6 - hr
                            off1 = -(IF_OFFS << sh1)
                            acc = ch[:, 0, None, None] * W[:, :, 0:blkx]
                            for k in range(1, taps):
                                acc += ch[:, k, None, None] * W[:, :, k:k + blkx]
                            t = (acc + off1) >> sh1   # int32; |t| < 2**19
                            if last:
                                sh2 = 6 + hr
                                off2 = (1 << (sh2 - 1)) + (IF_OFFS << 6)
                            else:
                                sh2, off2 = 6, 0
                            acc2 = cv[:, 0, None, None] * t[:, 0:blky, :]
                            for k in range(1, taps):
                                acc2 += cv[:, k, None, None] * t[:, k:k + blky, :]
                            out = (acc2 + off2) >> sh2  # |acc2| < 2**26
                            if last:
                                out = np.clip(out, 0, maxv)
                        preds[ii, l] = out
            # epilogue
            final = np.zeros((n, blky, blkx), np.int64)
            p0 = preds[:, 0].astype(np.int64)
            p1 = preds[:, 1].astype(np.int64)
            m = is_last_blk
            final[m & uni_l] = p0[m & uni_l]
            final[m & ~uni_l & uni] = p1[m & ~uni_l & uni]
            mb = bi & ~wp_blk
            if mb.any():
                final[mb] = bi_average(p0[mb], p1[mb], bd)
            if has_wp:
                scale = 1 << wp_offset_shift(sps, bd)
                wv = np.zeros((n, 2), np.int64)
                ov = np.zeros((n, 2), np.int64)
                denoms = np.zeros(n, np.int64)
                for i, pu in enumerate(pus):
                    if getattr(pu, "wp", None) is None:
                        continue
                    for l in range(2):
                        wv[i, l] = pu.wp["w"][l][c]
                        ov[i, l] = pu.wp["o"][l][c] * scale
                    denoms[i] = pu.wp["denom_l"] if c == 0 else pu.wp["denom_c"]
                wu = wp_blk & uni
                if wu.any():
                    pv = np.where(uni_l[:, None, None], p0, p1)
                    l_arr = np.where(uni_l, 0, 1)
                    wl = np.take_along_axis(wv, l_arr[:, None], 1)[:, 0]
                    ol = np.take_along_axis(ov, l_arr[:, None], 1)[:, 0]
                    shift = denoms + hr
                    rnd = np.where(shift > 0, 1 << np.maximum(shift - 1, 0), 0)
                    val = ((wl[:, None, None] * (pv + IF_OFFS) +
                            rnd[:, None, None]) >> shift[:, None, None]) + \
                        ol[:, None, None]
                    final[wu] = np.clip(val, 0, maxv)[wu]
                wb = wp_blk & bi
                if wb.any():
                    shift = (denoms + 1) + hr
                    rnd = (1 << np.maximum(shift - 1, 0))
                    offv = (ov[:, 0] + ov[:, 1])[:, None, None]
                    sh3 = shift[:, None, None]
                    val = (wv[:, 0, None, None] * (p0 + IF_OFFS) +
                           wv[:, 1, None, None] * (p1 + IF_OFFS) +
                           rnd[:, None, None] + (offv << (sh3 - 1))) >> sh3
                    final[wb] = np.clip(val, 0, maxv)[wb]
            # scatter (PUs never overlap)
            iy0 = by[:, None, None] + np.arange(blky)[None, :, None]
            ix0 = bx[:, None, None] + np.arange(blkx)[None, None, :]
            iy0 = np.broadcast_to(iy0, (n, blky, blkx))
            ix0 = np.broadcast_to(ix0, (n, blky, blkx))
            plane = recon.planes[c]
            plane[iy0, ix0] = final.astype(plane.dtype)

    _add_inter_residuals(recon, residuals)


def _add_inter_residuals(recon, residuals):
    pic, sps = recon.pic, recon.sps
    pm = pic.pred_mode
    for i, tu in enumerate(pic.tu_list):
        ssx = sps.chroma_shift_x() if tu.comp else 0
        ssy = sps.chroma_shift_y() if tu.comp else 0
        ly, lx = (tu.y << ssy) >> 2, (tu.x << ssx) >> 2
        if pm[ly, lx] != MODE_INTER:
            continue
        bd = sps.bit_depth_luma if tu.comp == 0 else sps.bit_depth_chroma
        pl = recon.planes[tu.comp]
        blk = pl[tu.y:tu.y + tu.h, tu.x:tu.x + tu.w] + residuals[i]
        pl[tu.y:tu.y + tu.h, tu.x:tu.x + tu.w] = np.clip(blk, 0, (1 << bd) - 1)


def motion_compensate_np(recon, ref_pics_unused, residuals):
    """MC + residual add for all inter PUs of the picture (decode-order free)."""
    pic, sps = recon.pic, recon.sps
    ncomp = recon.ncomp
    # index residual TUs by component for the inter overlay
    for pu in pic.inter_list:
        bi = pu.inter_dir == 3
        use_wp = getattr(pu, "wp", None) is not None
        for c in range(ncomp):
            ssx = sps.chroma_shift_x() if c else 0
            ssy = sps.chroma_shift_y() if c else 0
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            x, y = pu.x >> ssx, pu.y >> ssy
            w, h = pu.w >> ssx, pu.h >> ssy
            taps = 8 if c == 0 else 4
            ftab = LUMA_FILTER if c == 0 else CHROMA_FILTER
            fbits_x = 2 + ssx if c else 2
            fbits_y = 2 + ssy if c else 2
            preds = []
            for l in range(2):
                if not (pu.inter_dir & (1 << l)):
                    preds.append(None)
                    continue
                refpic = pu.ref_poc[l]
                # restrict to the coded picture area: reference border
                # extension replicates the picture edge, not the CTU padding
                rsps = refpic.sps
                rw = rsps.width >> ssx
                rh = rsps.height >> ssy
                plane = refpic.planes[c][:rh, :rw]
                mvx, mvy = pu.mv[l]
                preds.append(_interp(plane, x, y, w, h, mvx, mvy,
                                     fbits_x, fbits_y, taps, ftab, bd,
                                     is_last=(not bi and not use_wp)))
            if bi:
                if use_wp:
                    pred = _weighted_bi(preds[0], preds[1], pu, c, bd,
                                        wp_offset_shift(sps, bd))
                else:
                    pred = bi_average(preds[0], preds[1], bd)
            else:
                p = preds[0] if preds[0] is not None else preds[1]
                l = 0 if preds[0] is not None else 1
                if use_wp:
                    pred = _weighted_uni(p, pu, l, c, bd,
                                         wp_offset_shift(sps, bd))
                else:
                    pred = p
            recon.planes[c][y:y + h, x:x + w] = pred

    # add inter residuals (TUs belonging to inter CUs)
    pm = pic.pred_mode
    for i, tu in enumerate(pic.tu_list):
        ssx = sps.chroma_shift_x() if tu.comp else 0
        ssy = sps.chroma_shift_y() if tu.comp else 0
        ly, lx = (tu.y << ssy) >> 2, (tu.x << ssx) >> 2
        if pm[ly, lx] != MODE_INTER:
            continue
        bd = sps.bit_depth_luma if tu.comp == 0 else sps.bit_depth_chroma
        pl = recon.planes[tu.comp]
        blk = pl[tu.y:tu.y + tu.h, tu.x:tu.x + tu.w] + residuals[i]
        pl[tu.y:tu.y + tu.h, tu.x:tu.x + tu.w] = np.clip(blk, 0, (1 << bd) - 1)


def wp_offset_shift(sps, bd):
    """WpOffsetBdShiftY / WpOffsetBdShiftC (H.265 7.4.7.3) of a component
    at bit depth bd: 0 under high_precision_offsets_enabled_flag, whose
    offsets are coded at the sample's own scale, else bd - 8."""
    return 0 if sps.high_precision_offsets else bd - 8


def _wp_params(pu, l, c):
    wp = pu.wp
    denom = wp["denom_l"] if c == 0 else wp["denom_c"]
    return wp["w"][l][c], wp["o"][l][c], denom


def _weighted_uni(p, pu, l, c, bd, oshift):
    w, o, log2d = _wp_params(pu, l, c)
    o = o * (1 << oshift)
    shift = log2d + mc_headroom(bd)
    rnd = (1 << (shift - 1)) if shift > 0 else 0
    val = ((w * (p + IF_OFFS) + rnd) >> shift) + o
    return np.clip(val, 0, (1 << bd) - 1)


def _weighted_bi(p0, p1, pu, c, bd, oshift):
    w0, o0, log2d = _wp_params(pu, 0, c)
    w1, o1, _ = _wp_params(pu, 1, c)
    scale = 1 << oshift
    o0, o1 = o0 * scale, o1 * scale
    shift = (log2d + 1) + mc_headroom(bd)
    rnd = 1 << (shift - 1)
    off = o0 + o1
    val = (w0 * (p0 + IF_OFFS) + w1 * (p1 + IF_OFFS) + rnd +
           (off << (shift - 1))) >> shift
    return np.clip(val, 0, (1 << bd) - 1)
