# Copied from libhm_tpu/hostdec/slicedec.py
"""Slice-data (CTU / CU / TU) CABAC syntax parsing.

Rebuild of the reference decode plane: TDecSlice::decompressSlice CTU loop
(reference: source/Lib/TLibDecoder/TDecSlice.cpp:108-360), TDecCu::xDecodeCU
quadtree recursion (TDecCu.cpp:202), TDecEntropy::xDecodeTransform residual
quadtree (TDecEntropy.cpp:371) and the TDecSbac::parseXxx syntax readers
(TDecSbac.cpp:390-1250) — re-architected to emit whole-picture flat tensors
(PicSyntax) instead of reconstructing CU-by-CU, so that every dense stage can
run batched on the TPU.

Python here is the correctness oracle; the throughput parser is the C++
implementation under libhm_tpu/hostdec/native.
"""
import numpy as np

from .cabac import CabacDecoder
from .tables import make_context_bank, CHROMA_QP_SCALE
from .residual import residual_coding, RiceStats
from .params import B_SLICE, P_SLICE, I_SLICE
from .picture import (PicSyntax, TransformUnit, IntraBlock, MODE_INTER,
                      MODE_INTRA, SIZE_2Nx2N, SIZE_2NxN, SIZE_Nx2N, SIZE_NxN,
                      SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N, SIZE_nRx2N)

PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX = 0, 1, 10, 26
DM_CHROMA_IDX = 36

# 4:2:2 intra angle remap (Rec. H.265 Table 8-3 process)
CHROMA422_ANGLE_MAP = [0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18,
                       19, 20, 21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28,
                       28, 29, 29, 30, 31, DM_CHROMA_IDX]

# edge flag bits
EDGE_TU_LEFT, EDGE_TU_TOP = 1, 2
EDGE_PU_LEFT, EDGE_PU_TOP = 4, 8
EDGE_CU_LEFT, EDGE_CU_TOP = 16, 32


def pu_partitions(part_size, size):
    """PU rectangles (dx, dy, w, h) for a CU of given size."""
    s, q = size, size >> 2
    h = size >> 1
    if part_size == SIZE_2Nx2N:
        return [(0, 0, s, s)]
    if part_size == SIZE_2NxN:
        return [(0, 0, s, h), (0, h, s, h)]
    if part_size == SIZE_Nx2N:
        return [(0, 0, h, s), (h, 0, h, s)]
    if part_size == SIZE_NxN:
        return [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)]
    if part_size == SIZE_2NxnU:
        return [(0, 0, s, q), (0, q, s, s - q)]
    if part_size == SIZE_2NxnD:
        return [(0, 0, s, s - q), (0, s - q, s, q)]
    if part_size == SIZE_nLx2N:
        return [(0, 0, q, s), (q, 0, s - q, s)]
    if part_size == SIZE_nRx2N:
        return [(0, 0, s - q, s), (s - q, 0, q, s)]
    raise ValueError(part_size)


class SliceDecoder:
    """Parses one coded picture's slices into a PicSyntax."""

    def __init__(self, sps, pps, pic: PicSyntax, motion=None):
        self.sps = sps
        self.pps = pps
        self.pic = pic
        self.motion = motion   # MotionDeriver for P/B slices
        self.W = sps.width
        self.H = sps.height
        self.ctb = sps.ctb_size
        self.log2_ctb = sps.log2_ctb
        self.pic_w_ctbs = sps.pic_width_ctbs
        # z-scan order index per 4x4 within picture for availability checks
        self._zmap = self._build_zscan_map()
        # tile map per CTU (single tile unless PPS tiles enabled)
        self.tile_map = self._build_tile_map()
        # WPP storage
        self._wpp_saved = None

    # ------------------------------------------------------------------
    _zmap_cache = {}

    def _build_zscan_map(self):
        key = (self.log2_ctb, self.pic.h4, self.pic.w4, self.pic_w_ctbs)
        cached = self._zmap_cache.get(key)
        if cached is not None:
            return cached
        n = self.log2_ctb - 2
        m = 1 << n
        z_in_ctu = np.zeros((m, m), np.int64)
        for yy in range(m):
            for xx in range(m):
                z = 0
                for b in range(n):
                    z |= ((xx >> b) & 1) << (2 * b + 1 - 1)
                    z |= ((yy >> b) & 1) << (2 * b + 1)
                z_in_ctu[yy, xx] = z
        h4, w4 = self.pic.h4, self.pic.w4
        zmap = np.zeros((h4, w4), np.int64)
        parts = m * m
        for cy in range(0, h4, m):
            for cx in range(0, w4, m):
                ctu_idx = (cy // m) * self.pic_w_ctbs + (cx // m)
                zmap[cy:cy + m, cx:cx + m] = ctu_idx * parts + z_in_ctu
        self._zmap_cache[key] = zmap
        return zmap

    def _build_tile_map(self):
        """tile index per CTU address (raster)."""
        pps = self.pps
        wc, hc = self.pic_w_ctbs, self.sps.pic_height_ctbs
        tmap = np.zeros(wc * hc, np.int32)
        if not pps.tiles_enabled:
            return tmap
        nc, nr = pps.num_tile_cols, pps.num_tile_rows
        if pps.uniform_spacing:
            col_bounds = [(i * wc) // nc for i in range(nc + 1)]
            row_bounds = [(i * hc) // nr for i in range(nr + 1)]
        else:
            cw = pps.tile_col_widths + [wc - sum(pps.tile_col_widths)]
            rh = pps.tile_row_heights + [hc - sum(pps.tile_row_heights)]
            col_bounds = np.concatenate([[0], np.cumsum(cw)]).tolist()
            row_bounds = np.concatenate([[0], np.cumsum(rh)]).tolist()
        self.tile_col_bounds, self.tile_row_bounds = col_bounds, row_bounds
        for y in range(hc):
            tr = next(i for i in range(nr) if row_bounds[i] <= y < row_bounds[i + 1])
            for x in range(wc):
                tc = next(i for i in range(nc) if col_bounds[i] <= x < col_bounds[i + 1])
                tmap[y * wc + x] = tr * nc + tc
        return tmap

    def ctu_scan_order(self):
        """CTU addresses in decoding (tile-scan) order."""
        wc, hc = self.pic_w_ctbs, self.sps.pic_height_ctbs
        if not self.pps.tiles_enabled:
            return list(range(wc * hc))
        order = []
        ntiles = self.tile_map.max() + 1
        for t in range(ntiles):
            addrs = np.nonzero(self.tile_map == t)[0]
            order.extend(sorted(addrs.tolist()))
        return order

    # ------------------------------------------------------------------
    # neighbour availability (z-scan + slice + tile; reference
    # TComDataCU::getPULeft/getPUAbove semantics)
    def available(self, x, y, cur_x, cur_y, check_z=True):
        """check_z=False mirrors the reference's getPULeft/getPUAbove, which
        trust direct left/above neighbours without a z-scan comparison (needed
        for same-CU AMP PU neighbours whose raw z index is higher)."""
        if x < 0 or y < 0 or x >= self.W or y >= self.H:
            return False
        x4, y4, cx4, cy4 = x >> 2, y >> 2, cur_x >> 2, cur_y >> 2
        if check_z and self._zmap[y4, x4] >= self._zmap[cy4, cx4]:
            return False
        if self.pic.slice_idx[y4, x4] != self.pic.slice_idx[cy4, cx4]:
            # dependent slice segments share parse state but availability is
            # by slice (not segment); slice_idx stores the slice id
            return False
        if self.tile_map[(y >> self.log2_ctb) * self.pic_w_ctbs + (x >> self.log2_ctb)] != \
           self.tile_map[(cur_y >> self.log2_ctb) * self.pic_w_ctbs + (cur_x >> self.log2_ctb)]:
            return False
        return True

    # ------------------------------------------------------------------
    def decode_slice(self, rbsp, sh, slice_idx):
        sps, pps, pic = self.sps, self.pps, self.pic
        self.sh = sh
        self.slice_idx = slice_idx
        pic.slice_headers.append(sh)
        qp = sh.qp
        if sh.dependent and getattr(self, "_dep_saved_ctx", None) is not None:
            # dependent slice segment: CABAC contexts, Rice statistics and
            # the QP predictor continue from the end of the previous segment
            # (reference TDecSlice CTXMem[0]; Rec. 9.3.1 / 8.6.1)
            bank, rice_vals, last_qp, qp_pred = self._dep_saved_ctx
            self.bank = {k: v.copy() for k, v in bank.items()}
            self.rice = RiceStats()
            self.rice.vals = list(rice_vals)
            self.last_qp = last_qp
            self.qp_pred = qp_pred
        else:
            self.bank = make_context_bank(sh.slice_type, qp, sh.cabac_init_flag)
            self.rice = RiceStats()
            self.last_qp = qp
            self.qp_pred = qp
        self.cu_qp_delta = 0
        self.is_qp_delta_coded = False
        self.chroma_qp_adj = 0
        self.is_chroma_qp_adj_coded = False

        # substreams: entry points split the slice data after the header.
        # The signalled offsets count EBSP bytes (Rec. 7.4.7.1); convert to
        # RBSP spans using the NAL's emulation-prevention byte positions
        # (reference TDecCAVLC parseSliceHeader subtracts located EPBs).
        start_byte = sh.data_bit_offset >> 3
        epb = sorted(getattr(sh, "epb_positions", ()) or ())

        def advance(a, ebsp_len):
            b = a + ebsp_len
            while True:
                k = sum(1 for p in epb if a < p <= b)
                nb = a + ebsp_len - k
                if nb == b:
                    return b
                b = nb
        offs = [start_byte]
        for ep in sh.entry_points:
            offs.append(advance(offs[-1], ep))
        self.substreams = offs
        self.cur_substream = 0
        d = CabacDecoder(rbsp, sh.data_bit_offset)
        self.d = d

        wc = self.pic_w_ctbs
        scan = self.ctu_scan_order()
        start_pos = scan.index(sh.segment_address) if sh.segment_address else 0
        wpp = pps.entropy_coding_sync
        m4 = self.ctb >> 2

        for pos in range(start_pos, len(scan)):
            addr = scan[pos]
            cx, cy = (addr % wc) << self.log2_ctb, (addr // wc) << self.log2_ctb
            col = addr % wc
            tile = self.tile_map[addr]

            # tile / WPP substream + context management.  A dependent
            # segment whose first CTU sits at a tile boundary or a WPP row
            # start takes the init / sync path, overriding the continued
            # contexts (reference TDecSlice::decompressSlice CTXMem rules)
            seg_first = pos == start_pos
            if pos > start_pos or (seg_first and sh.dependent and pos > 0):
                prev_tile = self.tile_map[scan[pos - 1]]
                if tile != prev_tile:
                    # new tile: reset contexts, next substream if entry points
                    self.bank = make_context_bank(sh.slice_type, qp, sh.cabac_init_flag)
                    self.rice = RiceStats()
                    self.last_qp = qp
                    if not seg_first:
                        self._next_substream(rbsp)
                elif wpp and col == self._tile_first_col(addr):
                    # new CTU row: next substream; sync contexts from the
                    # snapshot taken after the 2nd CTU of the row above if the
                    # above-right CTU exists in the same slice and tile
                    if not seg_first:
                        self._next_substream(rbsp)
                    abv_right_ok = (
                        self._wpp_saved is not None and cy > 0 and
                        col + 1 < wc and
                        self.tile_map[addr - wc + 1] == tile and
                        self.pic.slice_idx[(cy - 4) >> 2, (cx + self.ctb) >> 2]
                        == slice_idx)
                    if abv_right_ok:
                        self.bank = {k: v.copy() for k, v in self._wpp_saved[0].items()}
                        self.rice = RiceStats()
                        self.rice.vals = list(self._wpp_saved[1])
                    else:
                        self.bank = make_context_bank(sh.slice_type, qp,
                                                      sh.cabac_init_flag)
                        self.rice = RiceStats()

            # mark slice id for this CTU before parsing (availability checks)
            x4hi = min((cx + self.ctb) >> 2, pic.w4)
            y4hi = min((cy + self.ctb) >> 2, pic.h4)
            pic.slice_idx[cy >> 2:y4hi, cx >> 2:x4hi] = slice_idx
            # Per-CTU re-init of conditionally-written maps (reference
            # TComDataCU::initCtu zero-fills every array before each CTU
            # parse).  Matters when a later slice re-parses CTUs an earlier
            # slice's substream already covered (HM's SliceMode encodings
            # entropy-code each slice to the picture end): skip CUs never
            # write cbf, non-PCM CUs never write pcm, edge flags OR-accumulate.
            for arr in (pic.cbf_y, pic.pcm, pic.edge_flags, pic.skip):
                arr[cy >> 2:y4hi, cx >> 2:x4hi] = 0

            if sps.sao_enabled:
                self._parse_sao_ctu(addr, cx, cy)

            self._set_deblock_ctu(cx, cy, sh)
            self.parse_cqt(cx, cy, self.log2_ctb, 0)

            # row snapshot (Rec. 9.3.2.3 storage): taken whenever the 2nd
            # CTU of a row finishes, even if the slice segment ends here --
            # a following dependent segment's rows sync from it
            if wpp and col == self._tile_first_col(addr) + 1:
                self._wpp_saved = ({k: v.copy() for k, v in self.bank.items()},
                                   list(self.rice.vals))
            is_last = self.d.decode_terminate()
            if is_last:
                if self.pps.dependent_slice_segments_enabled:
                    self._dep_saved_ctx = (
                        {k: v.copy() for k, v in self.bank.items()},
                        list(self.rice.vals), self.last_qp, self.qp_pred)
                break
            if wpp and col == self._tile_last_col(addr):
                one = self.d.decode_terminate()  # end_of_subset_one_bit
                assert one
        return pic

    def _next_substream(self, rbsp):
        self.cur_substream += 1
        off = self.substreams[self.cur_substream]
        self.d = CabacDecoder(rbsp, off * 8)

    def _tile_first_col(self, addr):
        if not self.pps.tiles_enabled:
            return 0
        col = addr % self.pic_w_ctbs
        t = self.tile_map[addr] % self.pps.num_tile_cols
        return self.tile_col_bounds[t]

    def _tile_last_col(self, addr):
        if not self.pps.tiles_enabled:
            return self.pic_w_ctbs - 1
        t = self.tile_map[addr] % self.pps.num_tile_cols
        return self.tile_col_bounds[t + 1] - 1

    # ------------------------------------------------------------------
    def _set_deblock_ctu(self, cx, cy, sh):
        pic = self.pic
        x4hi = min((cx + self.ctb) >> 2, pic.w4)
        y4hi = min((cy + self.ctb) >> 2, pic.h4)
        sl = np.s_[cy >> 2:y4hi, cx >> 2:x4hi]
        pic.deblock_disable[sl] = sh.deblocking_disabled
        pic.beta_offset[sl] = sh.beta_offset_div2 * 2
        pic.tc_offset[sl] = sh.tc_offset_div2 * 2
        pic.loopfilter_across_slice[sl] = sh.loop_filter_across_slices

    # ------------------------------------------------------------------
    def _parse_sao_ctu(self, addr, cx, cy):
        d, bank, sh, pic = self.d, self.bank, self.sh, self.pic
        enabled = [sh.sao_luma, sh.sao_chroma, sh.sao_chroma]
        if self.sps.chroma_format_idc == 0:
            enabled = [sh.sao_luma, 0, 0]
        if not any(enabled):
            return
        wc = self.pic_w_ctbs
        merge_left = merge_up = 0
        if addr % wc > 0 and self.available(cx - 1, cy, cx, cy):
            merge_left = d.decode_bin(bank["sao_merge"], 0)
        if not merge_left and addr // wc > 0 and self.available(cx, cy - 1, cx, cy):
            merge_up = d.decode_bin(bank["sao_merge"], 0)
        if merge_left or merge_up:
            src = addr - 1 if merge_left else addr - wc
            for c in range(3):
                if enabled[c]:
                    pic.sao_type[addr, c] = pic.sao_type[src, c]
                    pic.sao_band_pos[addr, c] = pic.sao_band_pos[src, c]
                    pic.sao_offsets[addr, c] = pic.sao_offsets[src, c]
            return
        max_qval_luma = (1 << (min(self.sps.bit_depth_luma, 10) - 5)) - 1
        max_qval_chroma = (1 << (min(self.sps.bit_depth_chroma, 10) - 5)) - 1
        for c in range(3):
            if not enabled[c]:
                continue
            if c <= 1:
                # sao_type_idx_luma / _chroma: ctx bin then bypass
                t = d.decode_bin(bank["sao_type"], 0)
                if t == 0:
                    type_idc = -1
                else:
                    type_idc = 0 if d.decode_bypass() == 0 else 1  # 0 BO, 1 EO
                if c == 1:
                    self._sao_chroma_type = type_idc
            else:
                type_idc = self._sao_chroma_type
            if type_idc < 0:
                pic.sao_type[addr, c] = -1
                continue
            maxq = max_qval_luma if c == 0 else max_qval_chroma
            offs = []
            for i in range(4):
                v = 0
                while v < maxq and d.decode_bypass():
                    v += 1
                offs.append(v)
            if type_idc == 0:  # BO
                for i in range(4):
                    if offs[i] and d.decode_bypass():
                        offs[i] = -offs[i]
                band = d.decode_bypass_bins(5)
                pic.sao_type[addr, c] = 0
                pic.sao_band_pos[addr, c] = band
                pic.sao_offsets[addr, c] = offs
            else:  # EO
                if c <= 1:
                    eo_class = d.decode_bypass_bins(2)
                    if c == 1:
                        self._sao_chroma_eo = eo_class
                else:
                    eo_class = self._sao_chroma_eo
                pic.sao_type[addr, c] = 1 + eo_class
                pic.sao_offsets[addr, c] = [offs[0], offs[1], -offs[2], -offs[3]]

    # ------------------------------------------------------------------
    # coding quadtree
    def parse_cqt(self, x, y, log2size, depth):
        sps, pps, d, bank = self.sps, self.pps, self.d, self.bank
        size = 1 << log2size
        inside = (x + size <= self.W) and (y + size <= self.H)
        if pps.cu_qp_delta_enabled and \
                log2size >= self.log2_ctb - pps.diff_cu_qp_delta_depth:
            self.is_qp_delta_coded = False
            self.cu_qp_delta = 0
            self.qp_pred = self._predict_qp(x, y)
        if self.sh.cu_chroma_qp_offset_enabled and \
                log2size >= self.log2_ctb - pps.diff_cu_chroma_qp_offset_depth:
            self.is_chroma_qp_adj_coded = False
            self.chroma_qp_adj = 0
        if inside and log2size > sps.log2_min_cb:
            ctx = 0
            if self.available(x - 1, y, x, y) and \
                    self.pic.depth[y >> 2, (x - 1) >> 2] > depth:
                ctx += 1
            if self.available(x, y - 1, x, y) and \
                    self.pic.depth[(y - 1) >> 2, x >> 2] > depth:
                ctx += 1
            split = d.decode_bin(bank["split_cu"], ctx)
        else:
            split = 1 if log2size > sps.log2_min_cb else 0
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                nx, ny = x + dx, y + dy
                if nx < self.W and ny < self.H:
                    self.parse_cqt(nx, ny, log2size - 1, depth + 1)
            return
        self.parse_cu(x, y, log2size, depth)

    # ------------------------------------------------------------------
    def _predict_qp(self, x, y):
        """qPY_PRED for the quantization group at (x, y) (Rec. H.265 8.6.1)."""
        pic = self.pic
        qg_log2 = self.log2_ctb - self.pps.diff_cu_qp_delta_depth
        xq = (x >> qg_log2) << qg_log2
        yq = (y >> qg_log2) << qg_log2
        prev = self.last_qp
        # availability constrained to same CTB
        def samectb(nx, ny):
            return (nx >> self.log2_ctb) == (xq >> self.log2_ctb) and \
                   (ny >> self.log2_ctb) == (yq >> self.log2_ctb)
        qa = prev
        if xq > 0 and samectb(xq - 1, yq) and self.available(xq - 1, yq, xq, yq):
            qa = int(pic.qp[yq >> 2, (xq - 1) >> 2])
        qb = prev
        if yq > 0 and samectb(xq, yq - 1) and self.available(xq, yq - 1, xq, yq):
            qb = int(pic.qp[(yq - 1) >> 2, xq >> 2])
        return (qa + qb + 1) >> 1

    def _final_qp(self):
        if self.cu_qp_delta:
            return ((self.qp_pred + self.cu_qp_delta + 52) % 52)
        return self.qp_pred

    # ------------------------------------------------------------------
    def parse_cu(self, x, y, log2size, depth):
        sps, pps, d, bank, pic, sh = self.sps, self.pps, self.d, self.bank, \
            self.pic, self.sh
        size = 1 << log2size
        pic.set_rect(pic.depth, x, y, size, size, depth)
        self.cu_chroma_mode_is_dm = True
        self._cross_comp_alpha = 0

        tq_bypass = 0
        if pps.transquant_bypass_enabled:
            tq_bypass = d.decode_bin(bank["transquant_bypass"], 0)
        pic.set_rect(pic.tq_bypass, x, y, size, size, tq_bypass)
        self.cu_tq_bypass = tq_bypass

        skip = 0
        if sh.slice_type != I_SLICE:
            ctx = 0
            if self.available(x - 1, y, x, y) and self.pic.skip[y >> 2, (x - 1) >> 2]:
                ctx += 1
            if self.available(x, y - 1, x, y) and self.pic.skip[(y - 1) >> 2, x >> 2]:
                ctx += 1
            skip = d.decode_bin(bank["skip"], ctx)
        if not skip:
            # Clear any stale value: with multiple slices per picture, HM
            # parses slice N's substream to the end of the picture (garbage
            # past the real slice boundary, TDecCu.cpp:172 reads terminate
            # per CTU and the flag stays 0) and slice N+1 re-parses its CTUs,
            # overwriting in z-order.  Context reads (left/above skip) must
            # therefore see the re-parsed value, so non-skip must write 0.
            pic.set_rect(pic.skip, x, y, size, size, 0)
        if skip:
            pic.set_rect(pic.skip, x, y, size, size, 1)
            pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTER)
            pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)
            merge_idx = self._parse_merge_idx()
            self.motion.apply_merge(self, x, y, size, size, merge_idx,
                                    x, y, size, 0)
            self._mark_cu_edges(x, y, size)
            self._finish_cu(x, y, size)
            return

        pred_mode = MODE_INTRA
        if sh.slice_type != I_SLICE:
            pred_mode = MODE_INTRA if d.decode_bin(bank["pred_mode"], 0) else MODE_INTER
        pic.set_rect(pic.pred_mode, x, y, size, size, pred_mode)

        # part size
        if pred_mode == MODE_INTRA:
            part_size = SIZE_2Nx2N
            if log2size == sps.log2_min_cb:
                if not d.decode_bin(bank["part_size"], 0):
                    part_size = SIZE_NxN
        else:
            part_size = self._parse_inter_part_size(log2size, depth)
        pic.set_rect(pic.part_size, x, y, size, size, part_size)
        self._mark_cu_edges(x, y, size)

        if pred_mode == MODE_INTRA:
            if part_size == SIZE_2Nx2N and sps.pcm_enabled and \
                    sps.log2_min_ipcm_cb <= log2size <= sps.log2_max_ipcm_cb:
                if d.decode_terminate():
                    self._parse_pcm(x, y, log2size)
                    self._finish_cu(x, y, size)
                    return
            self._parse_intra_pred_info(x, y, log2size, part_size)
            self._parse_transform_tree_root(x, y, log2size, depth, part_size,
                                            MODE_INTRA, merge_2nx2n=False)
        else:
            self._parse_inter_pred_info(x, y, log2size, depth, part_size)
            merge_2nx2n = (part_size == SIZE_2Nx2N and self._last_pu_merge)
            self._parse_transform_tree_root(x, y, log2size, depth, part_size,
                                            MODE_INTER, merge_2nx2n=merge_2nx2n)
        self._finish_cu(x, y, size)

    def _finish_cu(self, x, y, size):
        qp = self._final_qp() if self.pps.cu_qp_delta_enabled else self.sh.qp
        self.pic.set_rect(self.pic.qp, x, y, size, size, qp)
        self.last_qp = qp

    def _mark_cu_edges(self, x, y, size):
        ef = self.pic.edge_flags
        ef[y >> 2:(y + size) >> 2, x >> 2] |= EDGE_CU_LEFT | EDGE_PU_LEFT | EDGE_TU_LEFT
        ef[y >> 2, x >> 2:(x + size) >> 2] |= EDGE_CU_TOP | EDGE_PU_TOP | EDGE_TU_TOP

    # ------------------------------------------------------------------
    def _parse_inter_part_size(self, log2size, depth):
        d, bank, sps = self.d, self.bank, self.sps
        max_bits = 2
        at_min = log2size == sps.log2_min_cb
        if at_min and (1 << log2size) != 8:
            max_bits = 3
        mode = 0
        for i in range(max_bits):
            if d.decode_bin(bank["part_size"], i):
                break
            mode += 1
        part = mode  # 0:2Nx2N 1:2NxN 2:Nx2N 3:NxN
        # AMP (only when enabled and not at minimum depth)
        if sps.amp_enabled and not at_min:
            if part == SIZE_2NxN:
                if not d.decode_bin(bank["part_size"], 3):
                    part = SIZE_2NxnU if d.decode_bypass() == 0 else SIZE_2NxnD
            elif part == SIZE_Nx2N:
                if not d.decode_bin(bank["part_size"], 3):
                    part = SIZE_nLx2N if d.decode_bypass() == 0 else SIZE_nRx2N
        return part

    # ------------------------------------------------------------------
    def _parse_merge_idx(self):
        d, bank = self.d, self.bank
        n = self.sh.max_num_merge_cand
        idx = 0
        if n > 1 and d.decode_bin(bank["merge_idx"], 0):
            idx = 1
            while idx < n - 1 and d.decode_bypass():
                idx += 1
        return idx

    # ------------------------------------------------------------------
    def _parse_intra_pred_info(self, x, y, log2size, part_size):
        d, bank, pic = self.d, self.bank, self.pic
        size = 1 << log2size
        npu = 4 if part_size == SIZE_NxN else 1
        half = size >> 1
        pu_pos = [(x, y)] if npu == 1 else \
            [(x, y), (x + half, y), (x, y + half), (x + half, y + half)]
        pu_size = size if npu == 1 else half
        mpm_flags = [d.decode_bin(bank["intra_luma_mpm"], 0) for _ in range(npu)]
        modes = []
        for j in range(npu):
            px, py = pu_pos[j]
            preds = self._intra_mpm(px, py)
            if mpm_flags[j]:
                if d.decode_bypass():
                    mode = preds[1 + d.decode_bypass()]
                else:
                    mode = preds[0]
            else:
                mode = d.decode_bypass_bins(5)
                sp = sorted(preds)
                for p in sp:
                    mode += (mode >= p)
            modes.append(mode)
            pic.set_rect(pic.intra_y, px, py, pu_size, pu_size, mode)
        # chroma direction: one per CU, except 4:4:4 NxN which carries one per
        # PU (reference TDecEntropy::decodePredInfo enable4ChromaPUsInIntraNxNCU)
        if self.sps.chroma_format_idc != 0:
            n_chroma = npu if (self.sps.chroma_format_idc == 3 and npu == 4) else 1
            for j in range(n_chroma):
                px, py = pu_pos[j]
                csize = pu_size if n_chroma == 4 else size
                if d.decode_bin(bank["intra_chroma_mode"], 0) == 0:
                    cmode = DM_CHROMA_IDX
                else:
                    idx = d.decode_bypass_bins(2)
                    allowed = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX]
                    luma_mode = modes[j]
                    for i in range(4):
                        if allowed[i] == luma_mode:
                            allowed[i] = 34
                            break
                    cmode = allowed[idx]
                real_c = modes[j] if cmode == DM_CHROMA_IDX else cmode
                pic.set_rect(pic.intra_c, px, py, csize, csize, real_c)
                pic.set_rect(pic.chroma_dm, px, py, csize, csize,
                             1 if cmode == DM_CHROMA_IDX else 0)

    def _intra_mpm(self, x, y):
        """3 most-probable luma modes for PU at (x, y) (Rec. H.265 8.4.2)."""
        pic = self.pic
        left = DC_IDX
        if self.available(x - 1, y, x, y) and \
                pic.pred_mode[y >> 2, (x - 1) >> 2] == MODE_INTRA and \
                not pic.pcm[y >> 2, (x - 1) >> 2]:
            left = int(pic.intra_y[y >> 2, (x - 1) >> 2])
        above = DC_IDX
        if y % self.ctb != 0 and self.available(x, y - 1, x, y) and \
                pic.pred_mode[(y - 1) >> 2, x >> 2] == MODE_INTRA and \
                not pic.pcm[(y - 1) >> 2, x >> 2]:
            above = int(pic.intra_y[(y - 1) >> 2, x >> 2])
        if left == above:
            if left > 1:
                return [left, ((left + 29) % 32) + 2, ((left - 1) % 32) + 2]
            return [PLANAR_IDX, DC_IDX, VER_IDX]
        preds = [left, above]
        if PLANAR_IDX not in preds:
            preds.append(PLANAR_IDX)
        elif DC_IDX not in preds:
            preds.append(DC_IDX)
        else:
            preds.append(VER_IDX)
        return preds

    # ------------------------------------------------------------------
    def _parse_inter_pred_info(self, x, y, log2size, depth, part_size):
        size = 1 << log2size
        self._last_pu_merge = False
        parts = pu_partitions(part_size, size)
        for pu_idx, (dx, dy, w, h) in enumerate(parts):
            px, py = x + dx, y + dy
            self._parse_pu(px, py, w, h, x, y, size, depth, part_size, pu_idx)
            ef = self.pic.edge_flags
            ef[py >> 2:(py + h) >> 2, px >> 2] |= EDGE_PU_LEFT
            ef[py >> 2, px >> 2:(px + w) >> 2] |= EDGE_PU_TOP

    def _parse_pu(self, px, py, w, h, cx, cy, cu_size, depth, part_size, pu_idx):
        d, bank, sh = self.d, self.bank, self.sh
        merge = d.decode_bin(bank["merge_flag"], 0)
        self._last_pu_merge = bool(merge)
        if merge:
            merge_idx = self._parse_merge_idx()
            self.motion.apply_merge(self, px, py, w, h, merge_idx,
                                    cx, cy, cu_size, pu_idx)
            return
        # AMVP mode
        inter_dir = 1  # P slice: L0
        if sh.slice_type == B_SLICE:
            inter_dir = self._parse_inter_dir(cu_size, depth, part_size)
        mvd = [(0, 0), (0, 0)]
        ref_idx = [-1, -1]
        mvp_idx = [0, 0]
        for l in range(2):
            use = (inter_dir == 3) or (inter_dir == l + 1)
            if not use or sh.num_ref_idx[l] == 0:
                continue
            ref_idx[l] = self._parse_ref_idx(l)
            if sh.mvd_l1_zero and l == 1 and inter_dir == 3:
                mvd[l] = (0, 0)
            else:
                mvd[l] = self._parse_mvd()
            mvp_idx[l] = d.decode_bin(bank["mvp_idx"], 0)
        self.motion.apply_amvp(self, px, py, w, h, inter_dir, ref_idx, mvd,
                               mvp_idx, cx, cy, cu_size, pu_idx, part_size)

    def _parse_inter_dir(self, cu_size, depth, part_size):
        # first bin skipped only for non-2Nx2N PUs of 8x8 CUs (reference
        # parseInterDir uses the CU height, not the PU height)
        d, bank = self.d, self.bank
        sym = 0
        if part_size == SIZE_2Nx2N or cu_size != 8:
            sym = d.decode_bin(bank["inter_dir"], depth)
        if sym:
            return 3
        return 1 + d.decode_bin(bank["inter_dir"], 4)

    def _parse_ref_idx(self, l):
        d, bank = self.d, self.bank
        if self.sh.num_ref_idx[l] <= 1:
            return 0
        if not d.decode_bin(bank["ref_idx"], 0):
            return 0
        nref = self.sh.num_ref_idx[l] - 2
        i = 0
        while i < nref:
            if i == 0:
                b = d.decode_bin(bank["ref_idx"], 1)
            else:
                b = d.decode_bypass()
            if not b:
                break
            i += 1
        return i + 1

    def _parse_mvd(self):
        d, bank = self.d, self.bank
        gr0_x = d.decode_bin(bank["mvd"], 0)
        gr0_y = d.decode_bin(bank["mvd"], 0)
        ax, ay = gr0_x, gr0_y
        if gr0_x:
            ax += d.decode_bin(bank["mvd"], 1)
        if gr0_y:
            ay += d.decode_bin(bank["mvd"], 1)
        if gr0_x:
            if ax == 2:
                ax += d.decode_eg_k(1)
            if d.decode_bypass():
                ax = -ax
        if gr0_y:
            if ay == 2:
                ay += d.decode_eg_k(1)
            if d.decode_bypass():
                ay = -ay
        return (ax, ay)

    # ------------------------------------------------------------------
    def _parse_pcm(self, x, y, log2size):
        d, pic, sps = self.d, self.pic, self.sps
        size = 1 << log2size
        pic.set_rect(pic.pcm, x, y, size, size, 1)
        pic.set_rect(pic.intra_y, x, y, size, size, DC_IDX)
        pic.set_rect(pic.intra_c, x, y, size, size, DC_IDX)
        # the engine has read 9 bits at its start and one a renormalising
        # shift, so after pcm_flag's terminate bin its position is just past
        # the last bit of the encoder's flush (the 1 of H.265 9.3.4.3.5's
        # WriteBits(((ivlLow >> 7) & 3) | 1, 2)); pcm_alignment_zero_bits
        # follow only while that is not byte-aligned, so the samples start
        # at the next byte boundary at or after the position
        d.pos = (d.pos + 7) & ~7
        ncomp = 3 if sps.chroma_format_idc else 1
        for c in range(ncomp):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            w, h = size >> sx, size >> sy
            bits = sps.pcm_bit_depth_luma if c == 0 else sps.pcm_bit_depth_chroma
            samples = np.zeros((h, w), np.int32)
            for yy in range(h):
                for xx in range(w):
                    samples[yy, xx] = d._read_bits(bits)
            pic.pcm_list.append((c, x >> sx, y >> sy, w, h, samples, bits))
        # reinitialise the arithmetic engine
        d.range = 510
        d.offset = d._read_bits(9)

    # ------------------------------------------------------------------
    # transform tree
    def _parse_transform_tree_root(self, x, y, log2size, depth, part_size,
                                   pred_mode, merge_2nx2n):
        d, bank = self.d, self.bank
        if pred_mode == MODE_INTER:
            if merge_2nx2n:
                root_cbf = 1
            else:
                root_cbf = d.decode_bin(bank["qt_root_cbf"], 0)
            if not root_cbf:
                # no residual at all
                return
        sps = self.sps
        # the syntax element max_transform_hierarchy_depth_* is the reference's
        # QuadtreeTUMaxDepth minus one (TDecCAVLC parseSPS stores uiCode+1)
        max_tr_depth = 1 + (sps.max_tr_hierarchy_intra if pred_mode == MODE_INTRA
                            else sps.max_tr_hierarchy_inter)
        intra_split = 1 if (pred_mode == MODE_INTRA and part_size == SIZE_NxN) else 0
        inter_split = 1 if (sps.max_tr_hierarchy_inter == 0 and
                            pred_mode == MODE_INTER and
                            part_size != SIZE_2Nx2N) else 0
        if log2size < sps.log2_min_tb + max_tr_depth - 1 + inter_split + intra_split:
            min_tu_log2 = sps.log2_min_tb
        else:
            min_tu_log2 = min(log2size - (max_tr_depth - 1 + inter_split + intra_split),
                              sps.log2_max_tb)
        self.cu_x, self.cu_y, self.cu_log2 = x, y, log2size
        self.cu_pred_mode = pred_mode
        self.cu_part_size = part_size
        self._tt(x, y, log2size, 0, min_tu_log2, parent_cbf_cb=[1, 1],
                 parent_cbf_cr=[1, 1], blk_idx=0)

    def _chroma_shift(self):
        return self.sps.chroma_shift_x(), self.sps.chroma_shift_y()

    def _tt(self, x, y, log2size, tr_depth, min_tu_log2, parent_cbf_cb,
            parent_cbf_cr, blk_idx):
        """transform_tree (Rec. H.265 7.3.8.8 / reference xDecodeTransform)."""
        d, bank, sps, pps = self.d, self.bank, self.sps, self.pps
        pred_mode = self.cu_pred_mode
        cu_depth_log2 = self.cu_log2
        intra_nxn_root = (pred_mode == MODE_INTRA and
                          self.cu_part_size == SIZE_NxN and
                          log2size == cu_depth_log2)
        inter_forced = (sps.max_tr_hierarchy_inter == 0 and pred_mode == MODE_INTER
                        and self.cu_part_size != SIZE_2Nx2N
                        and log2size == cu_depth_log2)
        if intra_nxn_root:
            subdiv = 1
        elif inter_forced:
            subdiv = 1 if log2size > min_tu_log2 else 0
        elif log2size > sps.log2_max_tb:
            subdiv = 1
        elif log2size == sps.log2_min_tb or log2size == min_tu_log2:
            subdiv = 0
        else:
            subdiv = d.decode_bin(bank["trans_subdiv"], 5 - log2size)

        # chroma CBFs at this level (Rec. 7.3.8.8: parsed at every node with
        # log2TrafoSize > 2, or always for 4:4:4; 4x4 luma nodes inherit)
        ssx, ssy = self._chroma_shift()
        has_chroma = sps.chroma_format_idc != 0
        cbf_cb = list(parent_cbf_cb)
        cbf_cr = list(parent_cbf_cr)
        is422 = sps.chroma_format_idc == 2
        if has_chroma and (log2size > 2 or sps.chroma_format_idc == 3):
            first = tr_depth == 0
            lowest = subdiv == 0
            if first or (parent_cbf_cb[0] or parent_cbf_cb[1]):
                cbf_cb = self._parse_cbf_chroma(log2size, tr_depth, is422,
                                                lowest)
            else:
                cbf_cb = [0, 0]
            if first or (parent_cbf_cr[0] or parent_cbf_cr[1]):
                cbf_cr = self._parse_cbf_chroma(log2size, tr_depth, is422,
                                                lowest)
            else:
                cbf_cr = [0, 0]

        if subdiv:
            h = 1 << (log2size - 1)
            for i, (dx, dy) in enumerate(((0, 0), (h, 0), (0, h), (h, h))):
                self._tt(x + dx, y + dy, log2size - 1, tr_depth + 1,
                         min_tu_log2, cbf_cb, cbf_cr, i)
            return

        # leaf: cbf_luma
        if pred_mode == MODE_INTRA or tr_depth > 0 or \
                (has_chroma and (cbf_cb[0] or cbf_cb[1] or cbf_cr[0] or cbf_cr[1])):
            ctx = 1 if tr_depth == 0 else 0
            cbf_y = d.decode_bin(bank["qt_cbf"], ctx)
        else:
            cbf_y = 1

        size = 1 << log2size
        self.pic.set_rect(self.pic.cbf_y, x, y, size, size, cbf_y)
        ef = self.pic.edge_flags
        ef[y >> 2:(y + size) >> 2, x >> 2] |= EDGE_TU_LEFT
        ef[y >> 2, x >> 2:(x + size) >> 2] |= EDGE_TU_TOP

        # register intra luma block (prediction needed even with zero cbf)
        self._emit_tu(x, y, log2size, tr_depth, blk_idx, cbf_y, cbf_cb, cbf_cr)

    def _parse_cbf_chroma(self, log2size, tr_depth, is422, lowest):
        """Returns [cbf_first_sub, cbf_second_sub] (second only for 4:2:2).

        4:2:2 chroma TUs are non-square; the two square sub-TU CBFs are
        coded only at the lowest TU level, or at the parent when the chroma
        block cannot quad-split any further (reference TDecSbac::parseQtCbf
        'sub-TUs inherit their parent CBF' note).  Higher levels code one
        combined bin.
        """
        d, bank = self.d, self.bank
        ctx = 5 + tr_depth  # chroma context base 5
        if not is422:
            v = d.decode_bin(bank["qt_cbf"], ctx)
            return [v, v]
        can_quad_split = (log2size - 1) >= 3  # chroma width >= 2*MIN_TU
        if lowest or not can_quad_split:
            v0 = d.decode_bin(bank["qt_cbf"], ctx)
            v1 = d.decode_bin(bank["qt_cbf"], ctx)
            return [v0, v1]
        v = d.decode_bin(bank["qt_cbf"], ctx)
        return [v, v]

    # ------------------------------------------------------------------
    def _qp_for_comp(self, comp):
        """Final Qp' (incl. bit-depth offset) used by dequant (Rec. 8.6.1)."""
        sps, pps, sh = self.sps, self.pps, self.sh
        qp_y = self._final_qp() if pps.cu_qp_delta_enabled else self.sh.qp
        if comp == 0:
            return qp_y + 6 * (sps.bit_depth_luma - 8)
        off_bd = 6 * (sps.bit_depth_chroma - 8)
        off = (pps.cb_qp_offset + sh.cb_qp_offset) if comp == 1 else \
              (pps.cr_qp_offset + sh.cr_qp_offset)
        if self.chroma_qp_adj and pps.chroma_qp_offset_list:
            pair = pps.chroma_qp_offset_list[self.chroma_qp_adj - 1]
            off += pair[comp - 1]
        qpi = max(-off_bd, min(57, qp_y + off))
        if qpi >= 0:
            qpi = CHROMA_QP_SCALE[sps.chroma_format_idc][qpi]
        return qpi + off_bd

    def _emit_tu(self, x, y, log2size, tr_depth, blk_idx, cbf_y, cbf_cb, cbf_cr):
        """transform_unit (Rec. H.265 7.3.8.10 / reference decodeCoeff leaf)."""
        d, bank, sps, pps, pic = self.d, self.bank, self.sps, self.pps, self.pic
        size = 1 << log2size
        ssx, ssy = self._chroma_shift()
        has_chroma = sps.chroma_format_idc != 0
        chroma_here = has_chroma and (log2size - ssx >= 2)
        chroma_last = has_chroma and not chroma_here and blk_idx == 3

        # dQP/chroma-QP-adj gating counts the chroma cbf values stored at
        # this part even when the chroma blocks are coded at the parent node
        # (reference TDecEntropy.cpp:505 reads getCbf per component at every
        # leaf; parent-coded chroma cbfs propagate to the sub-parts)
        any_cbf = cbf_y or cbf_cb[0] or cbf_cb[1] or cbf_cr[0] or cbf_cr[1]

        if any_cbf:
            if pps.cu_qp_delta_enabled and not self.is_qp_delta_coded:
                self._parse_cu_qp_delta()
                self.is_qp_delta_coded = True
            # like dQP, the gate counts the PROPAGATED chroma cbf at this
            # part -- so the adjustment parses at the first 4x4 sub-TU of
            # a split 8x8 even though its chroma coded at the parent
            # (reference TDecEntropy.cpp:530 validChromaCbf via getCbf)
            chroma_cbf_present = \
                cbf_cb[0] or cbf_cb[1] or cbf_cr[0] or cbf_cr[1]
            if self.sh.cu_chroma_qp_offset_enabled and chroma_cbf_present and \
                    not self.cu_tq_bypass and not self.is_chroma_qp_adj_coded:
                self._parse_chroma_qp_adj()
                self.is_chroma_qp_adj_coded = True

        # intra prediction blocks are emitted regardless of cbf
        if self.cu_pred_mode == MODE_INTRA:
            mode = int(pic.intra_y[y >> 2, x >> 2])
            tu_idx = -1
            if cbf_y:
                tu_idx = len(pic.tu_list)
            pic.intra_list.append(IntraBlock(0, x, y, size, size, mode, 0, tu_idx))

        if cbf_y:
            self._parse_residual(0, x, y, log2size, log2size, tr_depth)

        # chroma
        if chroma_here or chroma_last:
            if chroma_last:
                # chroma sits at the parent (8x8-luma-aligned) position
                px, py = x & ~((size << 1) - 1), y & ~((size << 1) - 1)
                clog2 = log2size + 1 - ssx
                cpx, cpy = px >> ssx, py >> ssy
            else:
                clog2 = log2size - ssx
                cpx, cpy = x >> ssx, y >> ssy
            # 4:2:2 chroma blocks are two square sub-TUs stacked vertically;
            # each sub-TU has its own residual and its own square intra
            # prediction (reference xIntraRecQT iterates TComTU sections,
            # the lower sub-block predicting from the upper one's recon)
            n_sub = 2 if sps.chroma_format_idc == 2 else 1
            cs = 1 << clog2
            for comp, cbf in ((1, cbf_cb), (2, cbf_cr)):
                alpha = 0
                if pps.cross_component_prediction and cbf_y and \
                        (self.cu_pred_mode == MODE_INTER or
                         pic.chroma_dm[y >> 2, x >> 2]):
                    alpha = self._parse_cross_comp(comp)
                for s in range(n_sub):
                    sy = cpy + s * cs
                    tu_idx = -1
                    if cbf[s]:
                        tu_idx = len(pic.tu_list)
                        self._parse_residual(comp, cpx, sy, clog2, clog2,
                                             tr_depth,
                                             chroma_parent=chroma_last)
                    elif alpha:
                        # CCP applies even with no coded chroma residual
                        # (reference TDecCu xIntraRecBlk/xReconInter:
                        # residual buffer zeroed, then CCP)
                        tu_idx = len(pic.tu_list)
                        pic.tu_list.append(TransformUnit(
                            comp, cpx, sy, cs, cs, np.zeros((cs, cs), np.int32),
                            self._qp_for_comp(comp), False, 0, 0, 0, alpha))
                        self._cross_comp_alpha = 0
                    if self.cu_pred_mode == MODE_INTRA:
                        cmode = int(pic.intra_c[y >> 2, x >> 2])
                        pic.intra_list.append(IntraBlock(
                            comp, cpx, sy, cs, cs, cmode, 0, tu_idx))

    def _parse_cu_qp_delta(self):
        d, bank = self.d, self.bank
        v = 0
        if d.decode_bin(bank["dqp"], 0):
            v = 1
            while v < 5 and d.decode_bin(bank["dqp"], 1):
                v += 1
        if v == 5:
            v += d.decode_eg_k(0)
        if v > 0:
            if d.decode_bypass():
                v = -v
        self.cu_qp_delta = v

    def _unary_max(self, arr, idx0, idx_rest, max_symbol):
        """Truncated unary (reference TDecSbac::xReadUnaryMaxSymbol)."""
        d = self.d
        if max_symbol == 0 or not d.decode_bin(arr, idx0):
            return 0
        if max_symbol == 1:
            return 1
        symbol = 0
        cont = 1
        while True:
            cont = d.decode_bin(arr, idx_rest)
            symbol += 1
            if not cont or symbol >= max_symbol - 1:
                break
        if cont and symbol == max_symbol - 1:
            symbol += 1
        return symbol

    def _parse_chroma_qp_adj(self):
        d, bank, pps = self.d, self.bank, self.pps
        v = d.decode_bin(bank["chroma_qp_adj_flag"], 0)
        tbl = len(pps.chroma_qp_offset_list or [(0, 0)])
        if v and tbl > 1:
            v = self._unary_max(bank["chroma_qp_adj_idc"], 0, 0, tbl - 1) + 1
        self.chroma_qp_adj = v

    def _parse_cross_comp(self, comp):
        """log2_res_scale_abs / sign (reference parseCrossComponentPrediction)."""
        d, bank = self.d, self.bank
        base = 5 if comp == 2 else 0
        alpha = 0
        if d.decode_bin(bank["cross_comp"], base + 0):
            sym = 0
            if d.decode_bin(bank["cross_comp"], base + 1):
                s = 0
                if d.decode_bin(bank["cross_comp"], base + 2):
                    s = 1
                    if d.decode_bin(bank["cross_comp"], base + 3):
                        s = 2
                sym = s + 1
            sign = d.decode_bin(bank["cross_comp"], base + 4)
            alpha = -(1 << sym) if sign else (1 << sym)
        self._cross_comp_alpha = alpha
        return alpha

    # ------------------------------------------------------------------
    def _parse_residual(self, comp, x, y, log2w, log2h, tr_depth,
                        chroma_parent=False):
        d, bank, sps, pps, pic = self.d, self.bank, self.sps, self.pps, self.pic
        w, h = 1 << log2w, 1 << log2h
        sign_hiding = pps.sign_data_hiding and not self.cu_tq_bypass
        rdpcm_mode = 0

        transform_skip = 0
        if pps.transform_skip_enabled and not self.cu_tq_bypass and \
                log2w <= pps.log2_max_transform_skip_size and \
                log2h <= pps.log2_max_transform_skip_size:
            transform_skip = d.decode_bin(bank["transform_skip"],
                                          0 if comp == 0 else 1)
        is_intra = self.cu_pred_mode == MODE_INTRA
        if self.cu_tq_bypass and not is_intra and sps.explicit_rdpcm:
            rdpcm_mode = self._parse_rdpcm(comp)
            if rdpcm_mode:
                sign_hiding = False
        elif transform_skip and not is_intra and sps.explicit_rdpcm:
            rdpcm_mode = self._parse_rdpcm(comp)
            if rdpcm_mode:
                sign_hiding = False
        # implicit RDPCM (intra, hor/ver mode with TS/bypass)
        intra_mode = -1
        if is_intra:
            # (x, y) are component-plane coords; map back to luma for the map
            lx = x << (self.sps.chroma_shift_x() if comp else 0)
            ly = y << (self.sps.chroma_shift_y() if comp else 0)
            intra_mode = int((pic.intra_y if comp == 0 else pic.intra_c)[
                ly >> 2, lx >> 2])
            if comp and sps.chroma_format_idc == 2:
                intra_mode = CHROMA422_ANGLE_MAP[intra_mode]
            if sps.implicit_rdpcm and (transform_skip or self.cu_tq_bypass) and \
                    intra_mode in (HOR_IDX, VER_IDX):
                sign_hiding = False
                rdpcm_mode = 1 if intra_mode == HOR_IDX else 2

        # scan selection (MDCS; reference TComDataCU::getCoefScanIdx:
        # intra only, TU within 8x8 luma / correspondingly scaled chroma)
        from .tables import SCAN_DIAG, SCAN_HOR, SCAN_VER
        scan_type = SCAN_DIAG
        if is_intra:
            max_w = 8 >> (self.sps.chroma_shift_x() if comp else 0)
            max_h = 8 >> (self.sps.chroma_shift_y() if comp else 0)
            if w <= max_w and h <= max_h:
                if abs(intra_mode - VER_IDX) <= 4:
                    scan_type = SCAN_HOR
                elif abs(intra_mode - HOR_IDX) <= 4:
                    scan_type = SCAN_VER

        single_ctx = sps.transform_skip_context and \
            (transform_skip or self.cu_tq_bypass)
        rice_idx = 2 * (1 if (transform_skip or self.cu_tq_bypass) else 0) + \
            (1 if comp else 0)
        max_dyn = 15 if not sps.extended_precision else \
            max(15, (sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma) + 6)

        coeffs = residual_coding(
            d, bank, w, h, comp, scan_type,
            sign_hiding_valid=sign_hiding,
            single_ctx_mode=single_ctx,
            rice_stats=self.rice, rice_stats_idx=rice_idx,
            use_rice_adaptation=bool(sps.persistent_rice_adaptation),
            extended_precision=bool(sps.extended_precision),
            max_log2_dyn_range=max_dyn,
            align_before_bypass=bool(sps.cabac_bypass_alignment))

        qp = self._qp_for_comp(comp)
        use_dst = (comp == 0 and is_intra and w == 4 and h == 4)
        alpha = getattr(self, "_cross_comp_alpha", 0) if comp else 0
        pic.tu_list.append(TransformUnit(
            comp, x, y, w, h, coeffs, qp, use_dst, transform_skip,
            self.cu_tq_bypass, rdpcm_mode, alpha, intra_mode))
        self._cross_comp_alpha = 0

    def _parse_rdpcm(self, comp):
        d, bank = self.d, self.bank
        ch = 1 if comp else 0
        if not d.decode_bin(bank["rdpcm_flag"], ch):
            return 0
        return 1 + d.decode_bin(bank["rdpcm_dir"], ch)
