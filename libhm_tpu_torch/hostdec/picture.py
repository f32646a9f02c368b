# Copied from libhm_tpu/hostdec/picture.py
"""Per-picture syntax state: flat structure-of-arrays at 4x4 granularity.

TPU-native re-design of the reference's per-CTU TComDataCU structure-of-arrays
(reference: source/Lib/TLibCommon/TComDataCU.h:78) — instead of per-CTU
arrays indexed by z-scan part index, we keep whole-picture numpy maps indexed
by (y4, x4) = (y >> 2, x >> 2).  These maps are exactly the mode/MV tensors
shipped to the TPU reconstruction kernels.
"""
import numpy as np

MODE_INTER, MODE_INTRA = 0, 1

# part sizes (HM enum order, reference TComRom / TypeDef.h PartSize)
SIZE_2Nx2N, SIZE_2NxN, SIZE_Nx2N, SIZE_NxN = 0, 1, 2, 3
SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N, SIZE_nRx2N = 4, 5, 6, 7


class TransformUnit:
    """One residual block (one component) ready for dequant + inverse transform."""
    __slots__ = ("comp", "x", "y", "w", "h", "coeffs", "qp", "use_dst",
                 "transform_skip", "tq_bypass", "rdpcm_mode", "cross_comp_alpha",
                 "scaling_size_id", "scaling_matrix_id", "intra_mode")

    def __init__(self, comp, x, y, w, h, coeffs, qp, use_dst, transform_skip,
                 tq_bypass, rdpcm_mode, cross_comp_alpha=0, intra_mode=-1):
        self.comp = comp          # 0=Y 1=Cb 2=Cr
        self.x = x                # position in the component plane
        self.y = y
        self.w = w
        self.h = h
        self.coeffs = coeffs      # np.int32 [h, w] raster
        self.qp = qp              # component QP (chroma-mapped, incl. offsets)
        self.use_dst = use_dst
        self.transform_skip = transform_skip
        self.tq_bypass = tq_bypass
        self.rdpcm_mode = rdpcm_mode  # 0 off, 1 hor, 2 ver
        self.cross_comp_alpha = cross_comp_alpha
        self.intra_mode = intra_mode


class IntraBlock:
    """One intra-predicted block (one component), in decode order."""
    __slots__ = ("comp", "x", "y", "w", "h", "mode", "filter_edge", "tu_index")

    def __init__(self, comp, x, y, w, h, mode, filter_edge, tu_index):
        self.comp = comp
        self.x = x
        self.y = y
        self.w = w
        self.h = h
        self.mode = mode          # 0 planar, 1 DC, 2..34 angular
        self.filter_edge = filter_edge  # ref-smoothing decision precomputed
        self.tu_index = tu_index  # index into tu_list or -1 (no residual)


class InterPU:
    """One inter prediction unit ready for motion compensation."""
    __slots__ = ("x", "y", "w", "h", "inter_dir", "mv", "ref_idx",
                 "ref_poc", "wp", "merge", "merge_idx")

    def __init__(self, x, y, w, h, inter_dir, mv, ref_idx, ref_poc):
        self.x = x
        self.y = y
        self.w = w
        self.h = h
        self.inter_dir = inter_dir  # 1=L0, 2=L1, 3=bi
        self.mv = mv                # [(mvx, mvy)] * 2
        self.ref_idx = ref_idx      # [refIdxL0, refIdxL1] (-1 unused)
        self.ref_poc = ref_poc      # DecodedPicture refs (resolved at parse)
        self.wp = None
        self.merge = 0              # merge_flag / merge_idx (internals API)
        self.merge_idx = -1


class PicSyntax:
    """Everything the reconstruction stages need for one picture."""

    def __init__(self, sps, pps, alloc_maps=True):
        self.sps = sps
        self.pps = pps
        w4 = (sps.pic_width_ctbs << sps.log2_ctb) >> 2
        h4 = (sps.pic_height_ctbs << sps.log2_ctb) >> 2
        self.w4, self.h4 = w4, h4
        if not alloc_maps:
            # parse="native" placeholder: the native parser's materialized
            # PicSyntax replaces this object at _finish_picture, so the map
            # tensors (several MB at 1080p) are never read
            self.tu_list, self.intra_list = [], []
            self.inter_list, self.pcm_list = [], []
            self.slice_headers = []
            return
        shape = (h4, w4)
        self.depth = np.zeros(shape, np.int8)
        self.pred_mode = np.full(shape, MODE_INTRA, np.int8)
        self.part_size = np.zeros(shape, np.int8)
        self.skip = np.zeros(shape, np.int8)
        self.pcm = np.zeros(shape, np.int8)
        self.tq_bypass = np.zeros(shape, np.int8)
        self.intra_y = np.full(shape, 1, np.int8)       # DC default
        self.intra_c = np.full(shape, 1, np.int8)
        self.chroma_dm = np.zeros(shape, np.int8)   # chroma dir was DM
        self.qp = np.zeros(shape, np.int8)
        self.cbf_y = np.zeros(shape, np.int8)           # cbf of containing TU
        self.mv = np.zeros(shape + (2, 2), np.int32)    # [list][x,y] quarter-pel
        self.ref_idx = np.full(shape + (2,), -1, np.int8)
        self.ref_poc = np.zeros(shape + (2,), np.int32)
        self.ref_is_lt = np.zeros(shape + (2,), np.int8)  # long-term flags
        self.inter_dir = np.zeros(shape, np.int8)
        self.slice_idx = np.full(shape, -1, np.int32)   # slice id per 4x4
        # edge flags for deblocking: bit0 = TU edge at left, bit1 = TU edge at top,
        # bit2 = PU edge at left, bit3 = PU edge at top, bit4/5 = CU edges
        self.edge_flags = np.zeros(shape, np.uint8)
        # filtering toggles per 4x4 (slice-level deblock disable)
        self.deblock_disable = np.zeros(shape, np.int8)
        self.beta_offset = np.zeros(shape, np.int8)
        self.tc_offset = np.zeros(shape, np.int8)
        self.loopfilter_across_slice = np.ones(shape, np.int8)
        nctu = sps.pic_size_ctbs
        # SAO: [nctu, 3comp] type (-1 off, 0 BO, 1..4 EO class idx+1 layout below)
        self.sao_type = np.full((nctu, 3), -1, np.int8)
        self.sao_band_pos = np.zeros((nctu, 3), np.int8)
        self.sao_offsets = np.zeros((nctu, 3, 4), np.int32)
        self.tu_list = []      # TransformUnit, decode order
        self.intra_list = []   # IntraBlock, decode order
        self.inter_list = []   # InterPU
        self.pcm_list = []     # (comp, x, y, w, h, np samples at pcm bitdepth shifted)
        self.slice_headers = []

    def set_rect(self, arr, x, y, w, h, val):
        arr[y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2] = val

    def drop_products_from_ctu(self, first_ctu, scan_pos=None):
        """Drop parse products at CTU raster addresses >= first_ctu.

        HM's SliceMode=1 encoder entropy-codes every slice's substream from
        its start address to the END of the picture (TEncCu.cpp:937 only
        terminates at the real end address; end_of_slice stays 0 at the
        nominal slice boundary), and HM's decoder parses each substream to
        the picture end and lets the next slice's re-parse overwrite the
        overlap in z-order (TDecCu.cpp:157 xDecodeSliceEnd).  Our map-style
        tensors get overwritten naturally, but the append-only product lists
        (TUs / intra blocks / inter PUs / PCM) would keep the earlier pass's
        overlap entries, so when slice N+1 starts we discard products of
        CTUs it is about to re-parse.  IntraBlock.tu_index is remapped.
        """
        sps = self.sps
        lg, wc = sps.log2_ctb, sps.pic_width_ctbs
        ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
        # comparisons are in DECODE (tile-scan) order: with tiles, a later
        # slice's raster addresses can precede an earlier slice's
        if scan_pos is None:
            def pos(addr):
                return addr
        else:
            def pos(addr):
                return scan_pos[addr]
        first_pos = pos(first_ctu)

        def keep(x, y, comp):
            lx = x << (ssx if comp else 0)
            ly = y << (ssy if comp else 0)
            return pos((ly >> lg) * wc + (lx >> lg)) < first_pos

        remap = {}
        new_tus = []
        for i, t in enumerate(self.tu_list):
            if keep(t.x, t.y, t.comp):
                remap[i] = len(new_tus)
                new_tus.append(t)
        self.tu_list = new_tus
        kept_intra = []
        for b in self.intra_list:
            if keep(b.x, b.y, b.comp):
                if b.tu_index >= 0:
                    b.tu_index = remap[b.tu_index]
                kept_intra.append(b)
        self.intra_list = kept_intra
        self.inter_list = [p for p in self.inter_list if keep(p.x, p.y, 0)]
        self.pcm_list = [p for p in self.pcm_list if keep(p[1], p[2], p[0])]
        # Stale map state (cbf/pcm/edge flags/skip) is handled by the
        # per-CTU re-init in SliceDecoder.decode_slice — the two entropy
        # codings of the overlap come from separate encoder RDO passes, so
        # the CU/TU trees can genuinely differ.
