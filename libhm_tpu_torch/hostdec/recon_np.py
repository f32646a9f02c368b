# Copied from libhm_tpu/hostdec/recon_np.py
"""Whole-picture reconstruction from PicSyntax — numpy backend.

Correctness oracle mirroring TDecCu::decompressCU (reference: source/Lib/
TLibDecoder/TDecCu.cpp:373-795): residual synthesis for every TU, motion
compensation for inter PUs, and z-scan-ordered intra prediction.  The TPU
backend (libhm_tpu/ops + libhm_tpu/decoder_tpu.py) produces identical planes.
"""
import numpy as np
from . import refimpl
from .picture import MODE_INTRA


class PictureRecon:
    def __init__(self, sps, pic_syntax, zmap, tile_map):
        self.sps = sps
        self.pic = pic_syntax
        self.zmap = zmap
        self.tile_map = tile_map
        ncomp = 3 if sps.chroma_format_idc else 1
        self.ncomp = ncomp
        # padded to CTU multiples like the reference picture buffers; the
        # conformance crop happens at output time
        self.Wp = sps.pic_width_ctbs << sps.log2_ctb
        self.Hp = sps.pic_height_ctbs << sps.log2_ctb
        self.planes = []
        for c in range(ncomp):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            self.planes.append(np.zeros((self.Hp >> sy, self.Wp >> sx), np.int32))

    def comp_dims(self, c):
        sps = self.sps
        sx = sps.chroma_shift_x() if c else 0
        sy = sps.chroma_shift_y() if c else 0
        return sps.width >> sx, sps.height >> sy

    def _scaling_lookup(self):
        """Per-TU dequant scaling matrix (None when flat / disabled).

        Active when sps.scaling_list_enabled; PPS data overrides SPS data,
        default lists otherwise.  Transform-skip blocks larger than 4x4 use
        flat scaling (reference TComTrQuant::getUseScalingList).
        """
        sps, pic = self.sps, self.pic
        if not sps.scaling_list_enabled:
            return None
        pps = pic.pps
        data = getattr(pps, "scaling_list_data", None)
        if data is None:
            data = sps.scaling_list_data
        from .tables import build_scaling_matrices
        mats = build_scaling_matrices(data)
        pm = pic.pred_mode

        class _SL:
            def get(sl, tu, default=None):
                if tu.transform_skip and tu.w > 4:
                    return None
                ssx = sps.chroma_shift_x() if tu.comp else 0
                ssy = sps.chroma_shift_y() if tu.comp else 0
                intra = pm[(tu.y << ssy) >> 2, (tu.x << ssx) >> 2] == MODE_INTRA
                size_id = tu.w.bit_length() - 3
                return mats[(size_id, (0 if intra else 3) + tu.comp)]
        return _SL()

    _dump_fh = None

    def _debug_hooks(self, residuals):
        """EnvVar-driven debug output (reference Debug.h:97-110
        DebugOptionList: DebugRQT / DebugPred / DEBUG_STRING dumps)."""
        from ..utils import envvar as EV
        pic = self.pic
        poc = getattr(pic, "poc", "?")
        if EV.DEBUG_RQT.is_set():
            for i, tu in enumerate(pic.tu_list):
                print(f"RQT poc={poc} tu={i} c={tu.comp} x={tu.x} y={tu.y} "
                      f"n={tu.w} ts={int(bool(tu.transform_skip))} "
                      f"qp={tu.qp} nz={int(np.count_nonzero(tu.coeffs))}")
        if EV.DEBUG_PRED.is_set():
            for blk in pic.intra_list:
                print(f"PRED poc={poc} intra c={blk.comp} x={blk.x} "
                      f"y={blk.y} n={blk.w} mode={blk.mode}")
            for pu in pic.inter_list:
                mvs = " ".join(
                    f"L{l}=({pu.mv[l][0]},{pu.mv[l][1]})" for l in range(2)
                    if pu.ref_poc[l] is not None)
                print(f"PRED poc={poc} inter x={pu.x} y={pu.y} "
                      f"w={pu.w} h={pu.h} {mvs}")
        path = EV.DUMP_BLOCKS.get_str()
        self._dump_fh = open(path, "a") if path else None

    def _dump_block(self, blk, mode, pred, res, reco):
        fh = self._dump_fh
        poc = getattr(self.pic, "poc", "?")
        print(f"BLK poc={poc} c={blk.comp} x={blk.x} y={blk.y} "
              f"n={blk.w} mode={mode}", file=fh)
        for tag, a in (("pred", pred), ("resi", res), ("reco", reco)):
            rows = np.asarray(a, np.int64).reshape(blk.h, -1) \
                if np.ndim(a) else np.zeros((1, 1), np.int64)
            print(f" {tag}: " + ";".join(
                ",".join(str(v) for v in row) for row in rows), file=fh)

    def reconstruct(self, ref_pics=None, mc_fn=None):
        sps, pic = self.sps, self.pic
        # 1. residuals for every TU
        sl = self._scaling_lookup()

        def tu_intra(tu):
            sx = sps.chroma_shift_x() if tu.comp else 0
            sy = sps.chroma_shift_y() if tu.comp else 0
            return pic.pred_mode[(tu.y << sy) >> 2, (tu.x << sx) >> 2] == \
                MODE_INTRA
        residuals = [refimpl.residual_for_tu(tu, sps, sl, tu_intra(tu))
                     for tu in pic.tu_list]
        # cross-component prediction (RExt 4:4:4)
        self._apply_cross_component(residuals)
        self._debug_hooks(residuals)
        # 2. inter blocks: MC + residual add (decode-order independent)
        if pic.inter_list:
            mc_fn(self, ref_pics, residuals)
        # 3. PCM blocks
        for (c, x, y, w, h, samples, bits) in pic.pcm_list:
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            self.planes[c][y:y + h, x:x + w] = samples << (bd - bits)
        # 4. intra blocks in decode order
        for blk in pic.intra_list:
            self._recon_intra_block(blk, residuals)
        if self._dump_fh is not None:
            self._dump_fh.close()
            self._dump_fh = None
        return self.planes

    # ------------------------------------------------------------------
    def _apply_cross_component(self, residuals):
        pic = self.pic
        if not self.sps.chroma_format_idc == 3:
            return
        luma_res = {}
        for i, tu in enumerate(pic.tu_list):
            if tu.comp == 0:
                luma_res[(tu.x, tu.y, tu.w)] = i
        for i, tu in enumerate(pic.tu_list):
            if tu.comp and tu.cross_comp_alpha:
                j = luma_res.get((tu.x, tu.y, tu.w))
                if j is None:
                    continue
                # the luma residual scaled as H.265 8.6.6 says,
                # (rY << BitDepthC) >> BitDepthY
                lr = residuals[j].astype(np.int64)
                up = self.sps.bit_depth_chroma - self.sps.bit_depth_luma
                lr = lr << up if up >= 0 else lr >> -up
                r = residuals[i].astype(np.int64)
                r += (tu.cross_comp_alpha * lr) >> 3
                # no clip under extended precision (H.265 8.6.6)
                if not (self.sps.extended_precision and
                        self.sps.bit_depth_chroma + 6 > 15):
                    r = np.clip(r, refimpl.I16MIN, refimpl.I16MAX)
                residuals[i] = r.astype(np.int32)

    # ------------------------------------------------------------------
    def _avail_fn(self, blk):
        """Reference-sample availability for one intra block."""
        sps, pic = self.sps, self.pic
        ssx = sps.chroma_shift_x() if blk.comp else 0
        ssy = sps.chroma_shift_y() if blk.comp else 0
        lx_anchor, ly_anchor = blk.x << ssx, blk.y << ssy
        z_cur = self.zmap[ly_anchor >> 2, lx_anchor >> 2]
        slice_cur = pic.slice_idx[ly_anchor >> 2, lx_anchor >> 2]
        tile_cur = self.tile_map[(ly_anchor >> sps.log2_ctb if False else
                                  ly_anchor >> sps.log2_ctb) *
                                 sps.pic_width_ctbs + (lx_anchor >> sps.log2_ctb)]
        W, H = self.comp_dims(blk.comp)
        constrained = self.constrained_intra
        log2_ctb, wctbs = sps.log2_ctb, sps.pic_width_ctbs

        def avail(cx, cy):
            if cx < 0 or cy < 0 or cx >= W or cy >= H:
                return False
            lx, ly = cx << ssx, cy << ssy
            if self.zmap[ly >> 2, lx >> 2] >= z_cur:
                return False
            if pic.slice_idx[ly >> 2, lx >> 2] != slice_cur:
                return False
            if self.tile_map[(ly >> log2_ctb) * wctbs + (lx >> log2_ctb)] != tile_cur:
                return False
            if constrained and pic.pred_mode[ly >> 2, lx >> 2] != MODE_INTRA:
                return False
            return True
        return avail

    def _recon_intra_block(self, blk, residuals):
        sps = self.sps
        bd = sps.bit_depth_luma if blk.comp == 0 else sps.bit_depth_chroma
        plane = self.planes[blk.comp]
        mode = blk.mode
        if blk.comp and sps.chroma_format_idc == 2:
            from .slicedec import CHROMA422_ANGLE_MAP
            mode = CHROMA422_ANGLE_MAP[mode]
        avail = self._avail_fn(blk)
        top, left = refimpl.fill_reference_samples(plane, avail, blk.x, blk.y,
                                                   blk.w, bd)
        if refimpl.use_filtered_refs(blk.comp, blk.w, mode, sps):
            # strong bilinear smoothing is luma-only (reference TComPattern)
            strong = bool(sps.strong_intra_smoothing) and blk.comp == 0
            top, left = refimpl.filter_reference_samples(
                top, left, blk.w, mode, bd, strong)
        ssx2 = sps.chroma_shift_x() if blk.comp else 0
        ssy2 = sps.chroma_shift_y() if blk.comp else 0
        bypass = bool(self.pic.tq_bypass[(blk.y << ssy2) >> 2,
                                         (blk.x << ssx2) >> 2])
        disable_bf = bool(sps.implicit_rdpcm) and bypass
        pred = refimpl.predict_intra(top, left, blk.w, mode, blk.comp, bd, sps,
                                     disable_boundary_filters=disable_bf)
        if blk.tu_index >= 0:
            pred = pred + residuals[blk.tu_index]
        reco = np.clip(pred, 0, (1 << bd) - 1)
        plane[blk.y:blk.y + blk.h, blk.x:blk.x + blk.w] = reco
        if self._dump_fh is not None:
            res = residuals[blk.tu_index] if blk.tu_index >= 0 else 0
            self._dump_block(blk, mode, pred - res, res, reco)
