# Copied from libhm_tpu/encoder/encoder.py
"""HEVC encoder — all-intra baseline (v1 of the encoder subsystem).

Rebuild of the reference encoder's skeleton (TEncTop/TEncSlice/TEncCu —
source/Lib/TLibEncoder) with a deliberately simple tool profile this round:
fixed-QP all-intra, SAD mode decision over all 35 modes, fixed CU size with
boundary splitting, DM chroma, no RDOQ/SAO/deblock.  The output is a
conformant Main/Main10 bitstream carrying a decoded-picture-hash SEI; both
this framework's decoder and the HM reference binary verify it bit-exact.

The heavy parts (mode search SAD, forward transforms) are numpy here and
move onto the TPU ops as the encoder widens (see libhm_tpu/ops/transform).
"""
import os

import numpy as np

from ..hostdec import refimpl
from ..hostdec import params as hls
from ..hostdec.picture import PicSyntax, MODE_INTRA
from ..hostdec.slicedec import SliceDecoder
from ..hostdec.tables import (make_context_bank, CHROMA_QP_SCALE,
                              NEXT_STATE_MPS, NEXT_STATE_LPS)
from .cabac_enc import BitWriter, CabacEncoder
from .hls_writer import (write_vps, write_sps, write_pps, write_slice_header,
                         hash_sei_md5, nal_unit)
from .residual_enc import encode_residual
from .transforms import forward_transform, quantize
from .rd_cost import satd
from .rdoq import (FRAC, _EST_MPS, _EST_LPS, _addr, residual_bits,
                   rdoq as _rdoq_fn)
from ..hostdec.picture import (SIZE_2Nx2N, SIZE_NxN, SIZE_2NxN, SIZE_Nx2N,
                               SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N,
                               SIZE_nRx2N, MODE_INTER)
from ..hostdec.slicedec import (pu_partitions, EDGE_PU_LEFT, EDGE_PU_TOP,
                                EDGE_TU_LEFT, EDGE_TU_TOP, EDGE_CU_LEFT,
                                EDGE_CU_TOP, CHROMA422_ANGLE_MAP,
                                PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX)
from ..hostdec.tables import (SCAN_DIAG, SCAN_HOR, SCAN_VER,
                              build_scaling_matrices)
from ..hostdec.motion import (_interp, LUMA_FILTER, CHROMA_FILTER,
                              MotionDeriver, IF_OFFS, bi_average,
                              mc_headroom)
_SD, _SH, _SV = SCAN_DIAG, SCAN_HOR, SCAN_VER


from .rate_ctrl import RateControl  # noqa: E402  (full R-lambda model)
from ..ops import loopfilter as LF  # noqa: E402
from ..parallel.dag_decode import _check_device  # noqa: E402
from ..parallel.device_filters import PictureFilter  # noqa: E402


class _RecordingCabac:
    """Captures the CU symbol stream of the decision pass so the final
    bitstream pass can interleave SAO syntax (the HM compressSlice /
    encodeSlice two-pass split). Decisions never read CABAC state, so
    replaying (context-array, index, value) tuples through a fresh engine
    is exact.

    Trial-coder semantics (reference TEncBinCABACCounter + the per-depth
    RD SBAC coders, TEncTop m_pppcRDSbacCoder): recording a context bin
    ADAPTS the shared context state immediately, so every later rate
    estimate — including RDOQ's estBits view of the live bank — prices
    bins at the probabilities the real coder will actually have.  Each
    op carries its pre-adaptation state, which makes rejection exact:
    truncate() walks the discarded ops backwards restoring the states,
    and reinstate() re-advances them when a saved trial is accepted.
    Without this, every estimate prices at the slice-init state and RDOQ
    systematically over-kills coefficients in large CUs (the contexts
    have long since adapted toward "significant"), which shows up as
    intra over-splitting and a real BD-rate gap vs the reference."""

    def __init__(self):
        self.ops = []
        self.marks = []

    def mark(self):
        self.marks.append(len(self.ops))

    def encode_bin(self, ctx, idx, v):
        state = int(ctx[idx])
        ctx[idx] = NEXT_STATE_MPS[state] if v == (state & 1) \
            else NEXT_STATE_LPS[state]
        self.ops.append(("b", ctx, idx, v, state))

    def truncate(self, lo):
        """Discard ops[lo:], rolling the context states back to where
        they were before those ops were recorded."""
        ops = self.ops
        for i in range(len(ops) - 1, lo - 1, -1):
            op = ops[i]
            if op[0] == "b":
                op[1][op[2]] = op[4]
        del ops[lo:]

    def reinstate(self, saved):
        """Re-append previously recorded (then truncated) ops, advancing
        the context states through them again.  The caller guarantees
        the bank is in the same state it was when `saved` was first
        recorded, so the carried pre-states stay valid."""
        for op in saved:
            if op[0] == "b":
                ctx, idx, v = op[1], op[2], op[3]
                state = int(ctx[idx])
                ctx[idx] = NEXT_STATE_MPS[state] if v == (state & 1) \
                    else NEXT_STATE_LPS[state]
        self.ops.extend(saved)

    def encode_bypass(self, v):
        self.ops.append(("p", v))

    def encode_bypass_bins(self, v, n):
        self.ops.append(("pn", v, n))

    def encode_eg_k(self, v, k):
        self.ops.append(("eg", v, k))

    def encode_terminate(self, v):
        # slice/substream terminates are written by the emit pass directly;
        # in-CU terminates (pcm_flag) are recorded and replayed
        self.ops.append(("t", v))

    def pcm_payload(self, bits):
        self.ops.append(("pcm", bits))

    def bins_coded(self, bank, lo=0, hi=None):
        """Per-context coded-bin counts of the accepted op stream
        (optionally an op range — one slice's span), keyed like `bank`
        (reference ContextModel::getBinsCoded feeding
        TEncSbac::determineCabacInitIdx)."""
        idmap = {id(arr): name for name, arr in bank.items()}
        counts = {name: np.zeros(len(arr), np.int64)
                  for name, arr in bank.items()}
        for op in self.ops[lo:hi]:
            if op[0] == "b":
                nm = idmap.get(id(op[1]))
                if nm is not None:
                    counts[nm][op[2]] += 1
        return counts

    def replay(self, enc, lo, hi):
        for op in self.ops[lo:hi]:
            kind = op[0]
            if kind == "b":
                enc.encode_bin(op[1], op[2], op[3])
            elif kind == "p":
                enc.encode_bypass(op[1])
            elif kind == "pn":
                enc.encode_bypass_bins(op[1], op[2])
            elif kind == "t":
                enc.encode_terminate(op[1])
            elif kind == "pcm":
                enc.pcm_payload(op[1])
            else:
                enc.encode_eg_k(op[1], op[2])


# context-bank key order shared with the native CTU compressor
# (native/encctu.cpp BankSet) — op 'b' entries carry (set_id << 8) | idx
_NATIVE_BANK_KEYS = (
    "transquant_bypass", "split_cu", "skip", "merge_flag", "merge_idx",
    "part_size", "pred_mode", "intra_luma_mpm", "intra_chroma_mode",
    "inter_dir", "mvd", "ref_idx", "dqp", "qt_cbf", "qt_root_cbf",
    "sig_cg", "sig", "gt1", "gt2", "mvp_idx", "trans_subdiv",
    "transform_skip", "last_x", "last_y")


class _NativeRecOps:
    """CU symbol stream recorded by the native CTU compressor
    (hostdec/native/encctu.cpp), exposing the same marks/replay surface
    the emission pass uses on _RecordingCabac."""

    def __init__(self, kind, a, b, marks, banks):
        self.kind = kind
        self.a = a
        self.b = b
        self.marks = marks
        self._banks = banks

    def bins_coded(self, bank, lo=0, hi=None):
        """Per-context coded-bin counts from the native op arrays (ctx
        ops carry (set_id << 8) | idx in `a`), optionally over one
        slice's op range."""
        kind = self.kind[lo:hi]
        sel = kind == 0
        hist = np.bincount(np.asarray(self.a[lo:hi])[sel],
                           minlength=len(_NATIVE_BANK_KEYS) << 8)
        counts = {name: np.zeros(len(arr), np.int64)
                  for name, arr in bank.items()}
        for set_id, name in enumerate(_NATIVE_BANK_KEYS):
            dst = counts.get(name)
            if dst is not None:
                n = min(len(dst), 256)
                dst[:n] += hist[set_id << 8:(set_id << 8) + n]
        return counts

    def replay(self, enc, lo, hi):
        kind, a, b, banks = self.kind, self.a, self.b, self._banks
        for i in range(lo, hi):
            k = kind[i]
            if k == 0:
                ai = int(a[i])
                enc.encode_bin(banks[ai >> 8], ai & 255, int(b[i]))
            elif k == 1:
                enc.encode_bypass(int(b[i]))
            elif k == 2:
                enc.encode_bypass_bins(int(b[i]), int(a[i]))
            elif k == 4:
                enc.encode_terminate(int(b[i]))
            else:
                enc.encode_eg_k(int(b[i]), int(a[i]))


class _RefPic:
    """Reference picture entry in the encoder DPB."""
    def __init__(self, poc, planes, sps, pic_syntax=None):
        self.poc = poc
        self.planes = planes
        self.sps = sps
        self.pic_syntax = pic_syntax   # maps for TMVP derivation
        self.is_long_term = False


class _PSliceHeader:
    """Slice-header view the shared MotionDeriver expects (P or GPB-B)."""
    def __init__(self, poc, cfg, slice_type=1):
        self.poc = poc
        self.slice_type = slice_type  # 1=P 0=B
        self.num_ref_idx = [cfg.num_ref_l0,
                            cfg.num_ref_l1 if slice_type == 0 else 0]
        self.temporal_mvp = cfg.tmvp
        self.collocated_from_l0 = 1
        self.collocated_ref_idx = 0
        self.mvd_l1_zero = 0
        self.max_num_merge_cand = cfg.max_merge_cand
        self.wp_luma = None
        self.wp_chroma = None
        self.wp_log2_denom_luma = 0
        self.wp_log2_denom_chroma = 0


class EncoderConfig:
    def __init__(self, width, height, qp=32, bit_depth=8, cu_size=32,
                 gop="intra", search_range=8, rate_kbps=None, fps=30.0,
                 chroma_format_idc=1, weighted_pred=False, rdoq=True,
                 rdo_cu=True, sign_hiding=True, adaptive_qp=False,
                 amp=True):
        self.width = width
        self.height = height
        self.qp = qp
        self.bit_depth = bit_depth
        self.chroma_format_idc = chroma_format_idc
        self.log2_ctb = 6
        self.log2_min_cb = 3
        self.log2_min_tb = 2
        self.log2_max_tb = 5
        self.max_tr_hierarchy_inter = 0
        self.max_tr_hierarchy_intra = 0
        self.log2_max_poc_lsb = 8
        self.max_dec_pic_buffering = 2
        self.num_reorder_pics = 0
        self.sao = 1
        self.deblock = True
        self.tmvp = 0
        self.strong_intra_smoothing = 0
        self.num_ref_l0 = 1
        self.num_ref_l1 = 1
        self.max_merge_cand = 5
        self.st_rps = []
        self.cu_size = cu_size
        self.gop = gop
        self.search_range = search_range
        self.rate_kbps = rate_kbps  # per-picture R-lambda rate control
        self.fps = fps
        self.weighted_pred = weighted_pred  # P-slice WP analysis
        self.rdoq = rdoq  # rate-distortion optimized quantization
        self.rdo_cu = rdo_cu  # RDO quadtree depth + NxN intra decisions
        self.sign_hiding = sign_hiding  # sign-data-hiding (SBH)
        self.adaptive_qp = adaptive_qp  # TM5 preanalysis + cu_qp_delta
        self.amp = amp  # asymmetric motion partitions
        self.wpp = False          # entropy_coding_sync (one substream/row)
        self.tile_cols = 1        # uniform tile grid
        self.tile_rows = 1
        self.slice_ctus = 0       # SliceMode=1: CTUs per slice (0 = one)
        if gop in ("lowdelayP", "lowdelayB"):
            self.tmvp = 1
            self.st_rps = []          # explicit per-slice RPS
            self.num_ref_l0 = 2
            self.num_ref_l1 = 2 if gop == "lowdelayB" else 1
            self.max_dec_pic_buffering = 4
            self.num_reorder_pics = 0
        elif gop == "randomaccess":
            self.tmvp = 1
            self.st_rps = []
            self.max_dec_pic_buffering = 6
            self.num_reorder_pics = 3


def _mk_sps_pps(cfg):
    sps = hls.SPS()
    sps.width, sps.height = cfg.width, cfg.height
    sps.bit_depth_luma = sps.bit_depth_chroma = cfg.bit_depth
    sps.chroma_format_idc = cfg.chroma_format_idc
    sps.log2_ctb = cfg.log2_ctb
    sps.log2_min_cb = cfg.log2_min_cb
    sps.log2_min_tb = cfg.log2_min_tb
    sps.log2_max_tb = cfg.log2_max_tb
    sps.max_tr_hierarchy_intra = cfg.max_tr_hierarchy_intra
    sps.max_tr_hierarchy_inter = cfg.max_tr_hierarchy_inter
    sps.strong_intra_smoothing = cfg.strong_intra_smoothing
    sps.amp_enabled = 1 if getattr(cfg, "amp", False) else 0
    sps.sao_enabled = cfg.sao
    pps = hls.PPS()
    pps.init_qp = cfg.qp
    pps.deblocking_disabled = 0 if cfg.deblock else 1
    # parallel tools (mirrored into the written PPS by hls_writer)
    pps.entropy_coding_sync = 1 if getattr(cfg, "wpp", False) else 0
    tc = getattr(cfg, "tile_cols", 1)
    tr = getattr(cfg, "tile_rows", 1)
    if tc > 1 or tr > 1:
        pps.tiles_enabled = 1
        pps.num_tile_cols = tc
        pps.num_tile_rows = tr
        pps.uniform_spacing = 1
        pps.loop_filter_across_tiles = \
            1 if getattr(cfg, "lf_cross_tiles", True) else 0
    pps.loop_filter_across_slices = \
        1 if getattr(cfg, "lf_cross_slices", True) else 0
    return sps, pps


def _rough_level_bits(lev):
    """Cheap residual-coding bit estimate for trial comparisons: sig /
    gt1-ish cost per nonzero, EG0-ish cost per magnitude, plus the
    coded-sub-block and last-position overhead of every touched 4x4 CG."""
    a = np.abs(lev)
    nzy, nzx = np.nonzero(a)
    if len(nzy) == 0:
        return 0.0
    mags = a[nzy, nzx].astype(np.float64)
    bits = 1.5 * len(nzy) + float((2 * np.ceil(np.log2(mags + 1))).sum())
    ncg = len(set(zip(nzy >> 2, nzx >> 2)))
    return bits + 2.0 * ncg + 8.0


def _hm_col_from_l0(entries, gop_size, gi):
    """collocated_from_l0_flag for a B GOP entry (reference
    TEncGOP.cpp:644-689): default col pic from L1 (uiColDir=1); switch to
    L0 when the closest FUTURE reference's GOP QP offset is lower than
    the closest past one's (its motion field is better quantized)."""
    e = entries[gi]
    close_l, close_r = 1, -1
    for d in e.ref_pics:
        if d > 0 and (close_r == -1 or d < close_r):
            close_r = d
        elif d < 0 and (close_l == 1 or d > close_l):
            close_l = d
    if close_r > -1:
        close_r = close_r + e.poc - 1
    if close_l < 1:
        close_l = close_l + e.poc - 1
        while close_l < 0:
            close_l += gop_size
    lq = rq = 0
    for e2 in entries:
        if e2.poc == (close_l % gop_size) + 1:
            lq = e2.qp_offset
        if close_r > -1 and e2.poc == (close_r % gop_size) + 1:
            rq = e2.qp_offset
    col_dir = 0 if (close_r > -1 and rq < lq) else 1
    return 1 - col_dir


def _hm_gop_depth(poc, gop_size):
    """Hierarchy depth of a picture within its GOP (reference
    TEncSlice::initEncSlice depth computation, TEncSlice.cpp:227-264)."""
    p = poc % gop_size
    if p == 0:
        return 0
    depth = 0
    step = gop_size
    i = step >> 1
    while i >= 1:
        found = any(j == p for j in range(i, gop_size, step))
        step >>= 1
        depth += 1
        if found:
            break
        i >>= 1
    return depth


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig, device=None):
        """device: where the in-loop filter runs (the card unless the
        caller asks for "cpu", where the loop-filter kernel's plain version
        runs); a missing card raises."""
        self.device = _check_device("cuda" if device is None else device,
                                    "IntraEncoder")
        if getattr(cfg, "lossless", False):
            # CUTransquantBypassFlagForce: every CU bypasses transform/
            # quant; SDH doesn't apply and in-loop filters are no-ops on
            # bypass samples (reference lossless configuration)
            cfg.sign_hiding = False
            cfg.sao = 0
            cfg.deblock = False
        self.cfg = cfg
        self.sps, self.pps = _mk_sps_pps(cfg)
        self.slice_type = 2
        self._prev_ref = None

    # ------------------------------------------------------------------
    def encode_stream(self, frames):
        """frames: list of (Y, U, V) uint arrays. Returns Annex-B bytes."""
        cfg = self.cfg
        if getattr(cfg, "field_coding", False) and \
                not getattr(self, "_fields_split", False):
            # field coding (reference TEncGOP isField paths): each frame
            # becomes a top + bottom field coded as its own picture; the
            # SPS VUI signals field_seq_flag / frame_field_info and the
            # picture timing SEI carries pic_struct when HRD is on
            split = []
            for (fy, fu, fv) in frames:
                split.append((fy[0::2], fu[0::2], fv[0::2]))   # top field
                split.append((fy[1::2], fu[1::2], fv[1::2]))   # bottom
            frames = split
            self._fields_split = True
            cfg.height //= 2
            cfg.vui_enabled = True
            self.sps, self.pps = _mk_sps_pps(cfg)
        out = bytearray()
        # SPS short-term-RPS candidate sets: one per GOP-table entry, so
        # steady-state slice headers reference them by index (~4 bits)
        # instead of writing an explicit RPS (~25-40 bits) per slice
        # (reference TEncTop::xInitRPS, TEncCavlc::codeShortTermRefPicSet;
        # pictures whose availability-filtered RPS differs — leading
        # pictures, the first GOP — still write an explicit set).
        self._st_rps_lookup = {}
        if cfg.gop == "table" and getattr(cfg, "gop_entries", None):
            cand = []
            for e in cfg.gop_entries:
                key = (tuple(sorted(d for d in e.ref_pics if d < 0)),
                       tuple(sorted(d for d in e.ref_pics if d > 0)))
                if key not in self._st_rps_lookup and \
                        (key[0] or key[1]):
                    self._st_rps_lookup[key] = len(cand)
                    cand.append((list(key[0]), list(key[1])))
            cfg.st_rps = cand
        out += nal_unit(32, write_vps(cfg))
        out += nal_unit(33, write_sps(cfg))
        out += nal_unit(34, write_pps(cfg))
        self._pics_since_bp = 0
        self.stats = []   # (slice_type, bits, poc, recon) for Analyze
        self._prev_ref = None
        self._dpb = {}
        self._rc = None
        self._rc_pic_lambda = None
        if cfg.rate_kbps:
            self._rc = RateControl(
                getattr(cfg, "rate_bps", 0) or cfg.rate_kbps * 1000,
                cfg.fps, cfg.width, cfg.height, len(frames),
                gop_entries=getattr(cfg, "gop_entries", None),
                gop_size=getattr(cfg, "gop_size", 1) or 1,
                ctb=cfg.cu_size, bit_depth=cfg.bit_depth,
                keep_hier=getattr(cfg, "rc_keep_hier", 0),
                lcu_rc=bool(getattr(cfg, "rc_lcu_level", True)),
                lcu_separate=bool(getattr(cfg, "rc_lcu_separate", True)),
                initial_qp=getattr(cfg, "rc_initial_qp", 0),
                force_intra_qp=bool(getattr(cfg, "rc_force_intra_qp",
                                            False)),
                intra_period=getattr(cfg, "intra_period", -1))
        if cfg.gop in ("randomaccess", "table"):
            schedule = self._table_schedule(len(frames)) \
                if cfg.gop == "table" else self._ra_schedule(len(frames))
            for item in schedule:
                poc, nal_type, slice_type, l0, l1, rps = item[:6]
                pic_qp = item[6] if len(item) > 6 else None
                tid = item[7] if len(item) > 7 else 0
                # idr_base: POC-domain origin (DecodingRefreshType 2 IDRs
                # reset the signalled POC; deltas are domain-invariant)
                idr_base = item[8] if len(item) > 8 else 0
                self._ref_lists_pics = [[self._dpb[p] for p in l0],
                                        [self._dpb[p] for p in l1]]
                if l0:
                    self._prev_ref = self._ref_lists_pics[0][0]
                if self._rc:
                    gid = item[11] if len(item) > 11 else 0
                    self.cur_qp, self._rc_pic_lambda = \
                        self._rc.start_picture(gid, slice_type == 2,
                                               frames[poc][0])
                elif pic_qp is not None:
                    self.cur_qp = pic_qp
                self.cur_qp_factor = item[9] if len(item) > 9 else None
                # GOP-entry #ref_pics_active (TEncSlice::initEncSlice
                # clips to the RPS picture count per slice)
                self.cur_num_active = item[10] if len(item) > 10 else None
                self.cur_col_from_l0 = _hm_col_from_l0(
                    cfg.gop_entries, cfg.gop_size or len(cfg.gop_entries),
                    item[11]) if len(item) > 11 else 1
                slices, recon = self.encode_picture(
                    frames[poc], poc - idr_base, nal_type, slice_type,
                    rps=rps)
                nbits = sum(len(s) for s in slices) * 8
                if self._rc:
                    self._rc.end_picture(
                        getattr(self, "_hdr_bits_last", 0), nbits)
                    self._rc_pic_lambda = None
                self.stats.append((slice_type, nbits, poc, recon))
                out += self._prefix_sei(nal_type, tid)
                for slice_rbsp in slices:
                    out += nal_unit(nal_type, slice_rbsp, tid)
                if getattr(cfg, "hash_sei", True):
                    out += nal_unit(40, hash_sei_md5(recon, cfg.bit_depth),
                                    tid)
                if nal_type in (19, 20) and poc > 0:
                    self._dpb.clear()    # IDR empties the decoder's DPB
                self._dpb[poc] = _RefPic(poc - idr_base,
                                         [r.copy() for r in self.recon],
                                         self.sps, self.pic)
                if rps is not None:
                    keep = {poc} | {poc + d for d in rps[0] + rps[1]}
                    self._dpb = {p: r for p, r in self._dpb.items()
                                 if p in keep}
            return bytes(out)
        inter_gop = cfg.gop in ("lowdelayP", "lowdelayB")
        self.cur_qp_factor = None
        self.cur_num_active = None
        # lowdelay B: no future refs -> HM's default uiColDir=1 keeps
        # the collocated picture in L1 (same pictures as L0 under GPB)
        self.cur_col_from_l0 = 0 if cfg.gop == "lowdelayB" else 1
        refs = []                                # newest first
        for src_idx, frame in enumerate(frames):
            poc = src_idx
            rps = None
            if inter_gop and poc > 0:
                nal_type = 1                     # TRAIL_R
                slice_type = 1 if cfg.gop == "lowdelayP" else 0  # P / B
                rps = ([r.poc - poc for r in refs], [])
                l0 = list(refs)
                self._ref_lists_pics = [
                    l0, l0 if slice_type == 0 else []]
                self._prev_ref = refs[0]
            else:
                nal_type, slice_type = 19, 2     # IDR_W_RADL, I
                poc = poc if inter_gop else 0
            if self._rc:
                gid = 0 if slice_type == 2 else \
                    (poc - 1) % self._rc.seq.gop_size
                self.cur_qp, self._rc_pic_lambda = \
                    self._rc.start_picture(gid, slice_type == 2, frame[0])
            slices, recon = self.encode_picture(frame, poc, nal_type,
                                                slice_type, rps=rps)
            nbits = sum(len(s) for s in slices) * 8
            if self._rc:
                self._rc.end_picture(
                    getattr(self, "_hdr_bits_last", 0), nbits)
                self._rc_pic_lambda = None
            # stats carry the SOURCE index, not the signalled POC (all-
            # intra IDRs all have POC 0 — keying the Analyze source
            # lookup by POC would compare every recon against frame 0)
            self.stats.append((slice_type, nbits, src_idx, recon))
            out += self._prefix_sei(nal_type)
            for slice_rbsp in slices:
                out += nal_unit(nal_type, slice_rbsp)
            if getattr(cfg, "hash_sei", True):
                out += nal_unit(40, hash_sei_md5(recon, cfg.bit_depth))
            if inter_gop:
                refs.insert(0, _RefPic(poc, [r.copy() for r in self.recon],
                                       self.sps, self.pic))
                del refs[cfg.num_ref_l0:]
        return bytes(out)

    def _cabac_init(self):
        """cabac_init_flag for the current slice.

        Reference behavior (cabac_init_present_flag is ALWAYS on,
        TEncTop.cpp:761): each P/B slice initialises its contexts from
        the table type the previous picture's determineCabacInitIdx
        found cheapest, and signals cabac_init_flag when that type
        differs from its own slice type.  cfg.cabac_init=True keeps the
        legacy always-swap override."""
        if self.slice_type == 2:
            return 0
        if getattr(self.cfg, "cabac_init", False):
            return 1
        ti = getattr(self, "_enc_cabac_table_idx", 2)
        return 1 if ti in (0, 1) and ti != self.slice_type else 0

    def _update_cabac_table_idx(self, rec, qp_slice, lo=0, hi=None,
                                sao_counts=None):
        """Post-slice adaptive init-table selection (reference
        TEncSlice.cpp:1249-1252 + TEncSbac::determineCabacInitIdx).

        Called per slice from the emit pass with that slice's op range,
        the post-slice emit bank states (self.bank — reset/adapted in
        place by _emit_slices, including SAO context adaptation) and the
        slice's real SAO bin counts; the chosen table feeds the NEXT
        slice, as in the reference."""
        if self.slice_type == 2:
            self._enc_cabac_table_idx = 2
            return
        if getattr(self.cfg, "dependent_slices", False):
            # reference: with dependent slices the table idx is pinned
            # to the slice type (TEncSlice.cpp:1249)
            self._enc_cabac_table_idx = self.slice_type
            return
        counts = rec.bins_coded(self.bank, lo, hi)
        if sao_counts:
            for k, v in sao_counts.items():
                if k in counts:
                    counts[k] += v
        from .cabac_enc import determine_cabac_init_idx
        self._enc_cabac_table_idx = determine_cabac_init_idx(
            self.bank, counts, qp_slice)

    # ------------------------------------------------------------------
    def _prefix_sei(self, nal_type, tid=0):
        """Prefix SEI NALs for one access unit: active parameter sets +
        buffering period at IRAPs, picture timing per picture (reference
        TEncGOP HRD/timing SEI emission, SEIwrite.cpp).  Enabled by
        cfg.hrd_enabled (SPS VUI must carry HRD parameters)."""
        cfg = self.cfg
        if not getattr(cfg, "hrd_enabled", False):
            return b""
        from . import sei_writer as SW
        from ..hostdec import sei as S
        from ..hostdec.params import HRD, VUI
        hrd = HRD(nal_hrd=1, initial_cpb_removal_delay_length=24,
                  au_cpb_removal_delay_length=24, dpb_output_delay_length=24,
                  sub_layers=[(0, 0, 0, 1, [(0, 0, 1)], [])])
        vui = VUI(timing_info_present=1, frame_field_info_present=1, hrd=hrd)
        msgs = []
        irap = 16 <= nal_type <= 21
        if irap:
            msgs.append((S.SEI_ACTIVE_PARAMETER_SETS,
                         SW.active_parameter_sets()))
            msgs.append((S.SEI_BUFFERING_PERIOD,
                         SW.buffering_period(hrd, cpb_delay=90000)))
            if nal_type == 21:
                msgs.append((S.SEI_RECOVERY_POINT, SW.recovery_point(0)))
            self._pics_since_bp = 0
        self._pics_since_bp += 1
        ps = 0
        if getattr(cfg, "field_coding", False):
            # pic_struct 1 = top field, 2 = bottom field (Rec. D.3.3)
            self._field_parity = getattr(self, "_field_parity", 1)
            ps = self._field_parity
            self._field_parity = 3 - self._field_parity
        msgs.append((S.SEI_PIC_TIMING, SW.pic_timing(
            vui, pic_struct=ps, cpb_removal_delay=self._pics_since_bp,
            dpb_output_delay=cfg.num_reorder_pics + 1)))
        return nal_unit(39, SW.sei_rbsp(msgs), tid)

    # ------------------------------------------------------------------
    def _ra_schedule(self, n):
        """Hierarchical-B GOP-4 coding schedule.

        Yields (poc, nal_type, slice_type, l0_pocs, l1_pocs, rps) in coding
        order. Anchors reference the previous anchor (GPB); middle Bs
        reference nearest past/future. The explicit RPS lists exactly the
        pictures the decoder must retain (everything else retires,
        mirroring Rec. 8.3.2).
        """
        yield (0, 19, 2, [], [], None)           # IDR
        b = 0
        while b + 1 < n:
            a = min(b + 4, n - 1)
            if a == b:
                break
            # anchor (GPB: both lists = previous anchor)
            yield (a, 1, 0, [b], [b], ([b - a], []))
            if a - b >= 2:
                m = b + (a - b) // 2
                yield (m, 1, 0, [b], [a], ([b - m], [a - m]))
                if m - b >= 2:
                    yield (b + 1, 1, 0, [b], [m],
                           ([-1], [m - b - 1, a - b - 1]))
                if a - m >= 2:
                    yield (m + 1, 1, 0, [m], [a], ([-1], [a - m - 1]))
            b = a

    # ------------------------------------------------------------------
    def _table_schedule(self, n):
        """GOP-table coding schedule from cfg.gop_entries (the cfg-file
        FrameN DSL; reference TEncGOP::compressGOP ordering + TEncTop
        selectReferencePictureSet availability rules).

        Yields (poc, nal_type, slice_type, l0, l1, rps, qp, temporal_id,
        idr_base) in coding order.  IntraPeriod inserts CRA
        (DecodingRefreshType 1) or IDR + POC reset (DecodingRefreshType 2:
        the boundary closes the GOP -- in-between pictures are coded first
        referencing only the past, then IDR_N_LP resets the POC domain);
        pictures coded after a CRA with smaller POC are RASL; trailing
        pictures never reference across the last IRAP.
        """
        cfg = self.cfg
        entries = cfg.gop_entries
        gop_size = cfg.gop_size or len(entries)
        ip = cfg.intra_period
        refresh = cfg.refresh_type
        if refresh == 2 and ip > 0 and ip % gop_size:
            # same constraint the reference enforces for IDR refreshes
            raise ValueError("DecodingRefreshType 2 needs IntraPeriod to "
                             "be a multiple of GOPSize")
        coded = set()
        yield (0, 19, 2, [], [], None, cfg.qp, 0, 0)   # IDR_W_RADL
        coded.add(0)
        last_irap = 0
        lead_floor = 0     # oldest POC the current IRAP's RPS retains
        idr_base = 0
        base = 0
        while base + 1 < n:
            pending_idr = None
            for gi, e in enumerate(entries):
                poc = base + e.poc
                if poc >= n or poc in coded:
                    continue
                is_irap = ip > 0 and refresh > 0 and poc % ip == 0
                if is_irap and refresh == 2:
                    # defer the IDR until the GOP's earlier pictures are
                    # coded (closed GOP: no leading pictures allowed)
                    pending_idr = poc
                    continue
                coded.add(poc)
                if is_irap:
                    # CRA (open GOP).  Its slice header still signals the
                    # GOP entry's RPS so the pictures the following RASL
                    # leading pictures reference survive in the DPB
                    # (reference TEncTop::selectReferencePictureSet).  The
                    # retained pictures are marked used_by_curr = 0: a CRA
                    # must have NumPocTotalCurr == 0 (Rec. 7.4.7.2; the
                    # reference asserts it in TComSlice::setRefPicList)
                    # retention must not reach across the PREVIOUS IRAP
                    # (TComSlice::checkCRA: every RPS entry of a picture
                    # following a CRA is >= that CRA's POC)
                    lead_floor = last_irap
                    last_irap = poc
                    refs = [poc + d for d in e.ref_pics]
                    past = sorted((r for r in refs if 0 <= r < poc
                                   and r in coded and r >= lead_floor),
                                  reverse=True)
                    rps = (sorted(r - poc for r in past), [], False)
                    yield (poc, 21, 2, [], [], rps,
                           cfg.qp + e.qp_offset, 0, idr_base)
                    continue
                # reference availability: in the DPB AND not across the
                # last IRAP for trailing pictures (leading pictures may
                # reference across -- they become RASL)
                leading = poc < last_irap
                def ok(rp):
                    if rp < 0 or rp not in coded:
                        return False
                    if not leading and poc > last_irap and rp < last_irap:
                        return False
                    if leading and rp < lead_floor:
                        # only pictures the CRA's RPS retained survive in
                        # the DPB for the leading pictures
                        return False
                    return True
                refs = [poc + d for d in e.ref_pics]
                past = sorted((r for r in refs if r < poc and ok(r)),
                              reverse=True)
                fut = sorted(r for r in refs if r > poc and ok(r))
                # the decoder builds default lists from the RPS (closest-
                # past-first for L0, future-first for L1) and repeats to
                # num_ref_idx_active; pass the full default order so both
                # sides agree on every refidx
                l0 = past + fut
                l1 = fut + past
                if not l0:
                    continue  # unencodable slot (start of sequence)
                stype = {"I": 2, "P": 1, "B": 0}[e.slice_type]
                rps = (sorted(set(r - poc for r in past + fut if r < poc)),
                       sorted(set(r - poc for r in past + fut if r > poc)))
                nal = 9 if leading else 1   # RASL_R / TRAIL_R (the _R
                # variants: leading pictures reference each other)
                yield (poc, nal, stype, l0, l1 if stype == 0 else [],
                       rps, cfg.qp + e.qp_offset, e.temporal_id, idr_base,
                       e.qp_factor, e.num_ref_pics_active, gi)
            if pending_idr is not None:
                coded.add(pending_idr)
                last_irap = idr_base = pending_idr
                # IDR_N_LP: nothing precedes it in output order among the
                # pictures that follow it in coding order
                yield (pending_idr, 20, 2, [], [], None, cfg.qp, 0,
                       pending_idr)
            base += gop_size

    # ------------------------------------------------------------------
    def encode_picture(self, frame, poc=0, nal_type=19, slice_type=2,
                       rps=None):
        cfg, sps, pps = self.cfg, self.sps, self.pps
        self._dbg_poc = poc
        Wp = sps.pic_width_ctbs << sps.log2_ctb
        Hp = sps.pic_height_ctbs << sps.log2_ctb
        self.pic = PicSyntax(sps, pps)
        self.sd = SliceDecoder(sps, pps, self.pic)
        # CTU decode order (tile scan when tiles are on) + slice partition
        scan = self.sd.ctu_scan_order()
        slice_ctus = getattr(cfg, "slice_ctus", 0) or len(scan)
        slice_starts = list(range(0, len(scan), slice_ctus))
        wc = sps.pic_width_ctbs
        m4 = sps.ctb_size >> 2
        dep_slices = bool(getattr(cfg, "dependent_slices", False))
        for pos, addr in enumerate(scan):
            cx4, cy4 = (addr % wc) * m4, (addr // wc) * m4
            # dependent slice segments all belong to ONE slice
            self.pic.slice_idx[cy4:cy4 + m4, cx4:cx4 + m4] = \
                0 if dep_slices else pos // slice_ctus
        if not getattr(cfg, "lf_cross_slices", True):
            # the shared loop filters key slice-crossing off this per-4x4
            # map, same as the decode side
            self.pic.loopfilter_across_slice[:] = 0
        self.recon = []
        self.orig = []
        self.ncomp = 3 if sps.chroma_format_idc else 1
        for c in range(self.ncomp):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            pl = np.zeros((Hp >> sy, Wp >> sx), np.int32)
            src = frame[c].astype(np.int32)
            h, w = src.shape
            pl[:h, :w] = src
            # edge padding of the source so boundary CUs predict sensibly
            pl[h:, :w] = src[-1:, :]
            pl[:h, w:] = src[:, -1:]
            pl[h:, w:] = src[-1, -1]
            self.orig.append(pl)
            self.recon.append(np.zeros_like(pl))

        self.slice_type = slice_type
        self._ts_flags = {}
        self._padded_cache = {}
        self._refplane_cache = {}
        self._wplane_cache = {}   # per-picture: WP weights change per slice
        self._i16ref_cache = {}   # int16 ref-plane copies (native inter)
        qp_pic = getattr(self, "cur_qp", None)
        if qp_pic is None:
            qp_pic = cfg.qp
        self.cur_qp = qp_pic
        # SSE lambda in the 8-bit domain — the reference TEncSlice lambda
        # model (TEncSlice.cpp:355-416): GOP-entry QPfactor, the I-slice
        # 0.57*(1-0.05*NumberBFrames) scale, and the hierarchy-depth
        # multiplier Clip3(2,4,qp_temp/6) for depth>0 pictures.
        gop_size = max(1, getattr(cfg, "gop_size", None) or
                       len(getattr(cfg, "gop_entries", None) or []) or 1)
        qp_temp = qp_pic - 12
        if slice_type == 2:
            scale = 1.0 - min(0.5, max(0.0, 0.05 * (gop_size - 1)))
            factor = 0.57 * scale
        else:
            factor = getattr(self, "cur_qp_factor", None) or 0.57
        lam = factor * 2.0 ** (qp_temp / 3.0)
        if gop_size > 1 and _hm_gop_depth(poc, gop_size) > 0:
            lam *= min(4.0, max(2.0, qp_temp / 6.0))
        if getattr(self, "_rc_pic_lambda", None) is not None:
            # rate control drives the slice lambda directly (reference
            # TEncSlice::resetQP from TEncGOP.cpp:1117)
            lam = self._rc_pic_lambda
        self.rd_lambda = lam
        # sqrt-lambda for SAD/SATD-domain costs (reference TComRdCost
        # m_dLambdaMotionSAD / setCbDistortionWeight)
        self._lam_motion = lam ** 0.5
        # chroma distortion weights (TEncSlice::setUpLambda): chroma SSE is
        # weighted by 2^((qp-qpc)/3) in RD decisions; RDOQ uses
        # lambda/weight for chroma
        self.chroma_weight = [1.0, 1.0, 1.0]
        if sps.chroma_format_idc:
            for c in (1, 2):
                qpi = max(0, min(57, qp_pic))
                qpc = CHROMA_QP_SCALE[sps.chroma_format_idc][qpi]
                self.chroma_weight[c] = 2.0 ** ((qp_pic - qpc) / 3.0)
        self.cur_wp = None
        if slice_type in (0, 1):
            self.sh = _PSliceHeader(poc, cfg, slice_type)
            if slice_type == 0:
                self.sh.collocated_from_l0 = \
                    getattr(self, "cur_col_from_l0", 1)
            if getattr(self, "_ref_lists_pics", None) is not None:
                lists = self._ref_lists_pics
            else:
                lists = [[self._prev_ref],
                         [self._prev_ref] if slice_type == 0 else []]
            # per-picture num_ref_idx_active from the GOP entry, clipped to
            # the RPS picture count (TEncSlice::initEncSlice:
            # min(m_numRefPicsActive, RPS->getNumberOfPictures())) — the
            # reference does NOT search/signal the whole RPS as active refs
            na = getattr(self, "cur_num_active", None)
            if na:
                n_rps = (len(rps[0]) + len(rps[1])) if rps else \
                    max(len(lists[0]), 1)
                n_act = max(1, min(na, n_rps))
                self.sh.num_ref_idx[0] = n_act
                if self.sh.num_ref_idx[1]:
                    self.sh.num_ref_idx[1] = n_act
            # the decoder's default list construction repeats entries up to
            # num_ref_idx_active (def[i % len]); mirror that
            full = []
            for l in range(2):
                n_active = self.sh.num_ref_idx[l]
                src_list = lists[l]
                if src_list:
                    full.append([src_list[i % len(src_list)]
                                 for i in range(n_active)])
                else:
                    full.append([])
            lists = full
            self.ref_pics = lists
            # GPB check (reference TEncGOP.cpp:1035-1058): a B slice whose
            # active L0 and L1 hold the same pictures sets mvd_l1_zero —
            # bi PUs then code no L1 MVD and the search pins the L1 MV to
            # its AMVP predictor (TEncSearch.cpp:3312-3339)
            if slice_type == 0 and lists[1] and \
                    len(lists[0]) == len(lists[1]) and \
                    all(a.poc == b.poc for a, b in zip(lists[0], lists[1])):
                self.sh.mvd_l1_zero = 1
            self.sd.sh = self.sh
            self.motion = MotionDeriver(self.sd, self.sh, lists)
            wp_p = cfg.weighted_pred and slice_type == 1
            wp_b = getattr(cfg, "weighted_bipred", False) and slice_type == 0
            self.cur_wp_l1 = None
            if (wp_p or wp_b) and lists[0]:
                from .wp_analysis import analyse_picture
                crops = []
                for c in range(3 if sps.chroma_format_idc else 1):
                    sx = sps.chroma_shift_x() if c else 0
                    sy = sps.chroma_shift_y() if c else 0
                    crops.append(self.orig[c][:sps.height >> sy,
                                              :sps.width >> sx])

                class _CropRef:
                    pass

                def croplist(refs):
                    rl = []
                    for r in refs:
                        cr = _CropRef()
                        cr.planes = [
                            r.planes[c][:sps.height >>
                                        (sps.chroma_shift_y() if c else 0),
                                        :sps.width >>
                                        (sps.chroma_shift_x() if c else 0)]
                            for c in range(len(crops))]
                        rl.append(cr)
                    return rl
                self.cur_wp = analyse_picture(crops, croplist(lists[0]),
                                              cfg.bit_depth)
                if wp_b and lists[1]:
                    self.cur_wp_l1 = analyse_picture(
                        crops, croplist(lists[1]), cfg.bit_depth)
        nr = (self.sh.num_ref_idx[0], self.sh.num_ref_idx[1]) \
            if slice_type in (0, 1) else None
        # reference the SPS candidate RPS by index when this picture's
        # set matches one (used_by_curr=1 sets only; CRA retention sets
        # with used=0 stay explicit)
        self._cur_rps_hdr, self._cur_rps_idx = rps, 0
        if rps is not None and (len(rps) < 3 or rps[2]) and \
                getattr(self, "_st_rps_lookup", None):
            key = (tuple(sorted(rps[0])), tuple(sorted(rps[1])))
            idx = self._st_rps_lookup.get(key)
            if idx is not None:
                self._cur_rps_hdr, self._cur_rps_idx = None, idx
        w = write_slice_header(cfg, nal_type, poc, slice_type, qp_pic,
                               rps=self._cur_rps_hdr,
                               rps_idx=self._cur_rps_idx, wp=self.cur_wp,
                               wp_l1=getattr(self, "cur_wp_l1", None),
                               num_ref=nr,
                               cabac_init_flag=self._cabac_init(),
                               mvd_l1_zero=getattr(self.sh, "mvd_l1_zero", 0)
                               if slice_type in (0, 1) else 0,
                               col_from_l0=getattr(
                                   self.sh, "collocated_from_l0", 1)
                               if slice_type in (0, 1) else 1)
        # slice-header bits for the rate controller's header-bit model
        # (TEncRCPic::xEstPicHeaderBits averages these per frame level)
        self._hdr_bits_last = len(w.buf) * 8 + w.nbits
        self.enc = CabacEncoder(w)
        self.bank = make_context_bank(slice_type, qp_pic, self._cabac_init())

        nctu_x = sps.pic_width_ctbs
        nctu_y = sps.pic_height_ctbs
        nctu = nctu_x * nctu_y
        last = nctu - 1
        qp_base = self.cur_qp
        self._qp_map = None
        self._last_qp_enc = qp_base
        self._qp_pred_enc = qp_base
        self._dqp_coded = True
        self._cu_delta_enc = 0
        rc = getattr(self, "_rc", None)
        lcu_rc = rc is not None and getattr(rc, "lcu_level", False) and \
            getattr(rc, "lcu_rc", True)
        self._dqp_enabled = bool(cfg.adaptive_qp or lcu_rc)
        if cfg.adaptive_qp:
            from .preanalyze import qp_offsets
            offs = qp_offsets(self.orig[0], 1 << sps.log2_ctb,
                              sps.width, sps.height)
            self._qp_map = [max(0, min(51, qp_base + o)) for o in offs]

        ctu_counter = [0]
        # per-LCU rate control state (TEncSlice.cpp:873-975: estimate
        # lambda/QP before each LCU, update the model with its actual
        # bits after); lambda is restored to the slice value afterwards
        rc_prev = {"addr": None, "qp": 0, "lam": None, "lo": 0}
        pic_lambda = self.rd_lambda
        pic_lam_motion = self._lam_motion
        m4c = sps.ctb_size >> 2

        def _rc_lcu_close():
            if rc_prev["addr"] is None:
                return
            if isinstance(self.enc, CabacEncoder):
                bits = len(self.enc.bw.buf) * 8 - rc_prev["lo"]
            else:
                bits = int(self._est_ops_bits(rc_prev["lo"]) + 0.5)
            addr = rc_prev["addr"]
            x4 = (addr % nctu_x) * m4c
            y4 = (addr // nctu_x) * m4c
            sk = self.pic.skip[y4:y4 + m4c, x4:x4 + m4c]
            effective = bool((sk == 0).any())
            lam = rc_prev["lam"] if rc_prev["lam"] is not None \
                else pic_lambda
            self._rc.lcu_end(max(1, bits), rc_prev["qp"], lam, effective)
            rc_prev["addr"] = None

        def ctu_qg_start(addr):
            # quantization-group reset (diff_cu_qp_delta_depth == 0: one
            # group per CTU; predictor degenerates to the previous CU QP)
            if cfg.adaptive_qp:
                self.cur_qp = self._qp_map[addr]
            elif lcu_rc:
                _rc_lcu_close()
                qp, lam = self._rc.lcu_start(
                    forced_fixed=(slice_type == 2 and
                                  self._rc.force_intra_qp))
                self.cur_qp = qp
                if lam is not None:
                    self.rd_lambda = lam
                    self._lam_motion = lam ** 0.5
                rc_prev["addr"] = addr
                rc_prev["qp"] = qp
                rc_prev["lam"] = lam
                rc_prev["lo"] = len(self.enc.bw.buf) * 8 \
                    if isinstance(self.enc, CabacEncoder) \
                    else len(self.enc.ops)
                ctu_counter[0] += 1
            else:
                return
            self._qp_pred_enc = self._last_qp_enc
            self._dqp_coded = False
            self._cu_delta_enc = 0
        # The record+replay two-pass structure is what enables every
        # full-RD trial (live-adapting trial CABAC with rollback); the
        # direct single-pass emission below prices nothing and exists only
        # as a debug escape hatch (HEVC_ENC_1PASS=1).  It used to be the
        # default for SAO-less configs, which silently degraded them to
        # SATD-only decisions (-23% rate efficiency on the AI ladder).
        multi = os.environ.get("HEVC_ENC_1PASS", "0") != "1"
        if multi and self._native_ctu_eligible():
            # native CTU compressor (hostdec/native/encctu.cpp): the whole
            # decide+record pass runs in C++, byte-identical to the Python
            # path below (tests/test_enc_native.py)
            rec = self._native_compress(scan)
            self.enc = rec
            self._loop_filter(poc)
            payloads = self._emit_slices(rec, scan, slice_starts, nal_type,
                                         poc, slice_type, qp_base, rps)
        elif multi:
            # pass 1: decide + record the CU symbol stream in decode order
            rec = _RecordingCabac()
            self.enc = rec
            for pos, addr in enumerate(scan):
                rec.mark()
                if pos in slice_starts and (pos == 0 or
                                            not getattr(cfg, "dependent_slices",
                                                        False)):
                    # QP predictor resets at independent slice starts
                    # (dependent segments continue the predictor)
                    self._last_qp_enc = qp_base
                ctu_qg_start(addr)
                cx = (addr % nctu_x) << sps.log2_ctb
                cy = (addr // nctu_x) << sps.log2_ctb
                self.encode_cqt(cx, cy, sps.log2_ctb, 0)
            rec.mark()
            if lcu_rc:
                _rc_lcu_close()
                self.rd_lambda = pic_lambda
                self._lam_motion = pic_lam_motion
            self._loop_filter(poc, pcm_nofilt=getattr(
                cfg, "pcm_filter_disabled", False) and getattr(
                cfg, "pcm_enabled", False))
            payloads = self._emit_slices(rec, scan, slice_starts, nal_type,
                                         poc, slice_type, qp_base, rps)
        else:
            self._enc_cabac_table_idx = slice_type   # 1-pass debug path
            for addr in range(nctu):
                ctu_qg_start(addr)
                cx = (addr % nctu_x) << sps.log2_ctb
                cy = (addr // nctu_x) << sps.log2_ctb
                self.encode_cqt(cx, cy, sps.log2_ctb, 0)
                self.enc.encode_terminate(1 if addr == last else 0)
            if lcu_rc:
                _rc_lcu_close()
                self.rd_lambda = pic_lambda
                self._lam_motion = pic_lam_motion
            # the CABAC flush's final bit doubles as the rbsp stop bit
            w.align_zero()
            if cfg.deblock:
                # in-loop deblocking on the encoder recon (the filter the
                # decoder runs; no SAO: this path writes no SAO syntax)
                PictureFilter(self.recon, self.pic, sps, pps,
                              self.device).run(LF.PASS_V | LF.PASS_H)
            payloads = [w.data()]
        self.cur_qp = qp_base   # per-CTU AQ mutations must not leak out
        W, H = sps.width, sps.height
        crop = []
        for c in range(self.ncomp):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            crop.append(self.recon[c][:H >> sy, :W >> sx])
        return payloads, crop

    def _loop_filter(self, poc, pcm_nofilt=False):
        """In-loop deblocking and SAO of the picture's reconstruction, in
        place: one launch of the loop-filter kernel (K3 + K4) for the
        deblocking, then, once the SAO parameters are decided on the
        deblocked samples, one for SAO, on self.device.  pcm_nofilt
        (pcm_loop_filter_disabled): PCM samples then take back their value
        from before the filters (Rec. 8.7; K8, as the decode side's
        restore)."""
        cfg = self.cfg
        if not (cfg.deblock or cfg.sao):
            return
        lf = PictureFilter(self.recon, self.pic, self.sps, self.pps,
                           self.device)
        if cfg.deblock:
            lf.run(LF.PASS_V | LF.PASS_H)
        if cfg.sao:
            self._sao_decide_pic_enabled(poc)
            self._estimate_sao()
            lf.run(LF.PASS_SAO)
        if pcm_nofilt:
            lf.restore(np.asarray(self.pic.pcm) != 0)

    # ------------------------------------------------------------------
    def _emit_slices(self, rec, scan, slice_starts, nal_type, poc,
                     slice_type, qp_pic, rps):
        """Pass 2: replay the recorded CU symbols into per-slice NAL
        payloads with WPP / tile substreams + entry points (reference
        TEncSlice::encodeSlice TEncSlice.cpp:1011, WPP context propagation
        :738-844, TEncGOP xAttachSliceDataToNalUnit)."""
        cfg, sps, pps = self.cfg, self.sps, self.pps
        from .sao_enc import write_sao_ctu
        wc = sps.pic_width_ctbs
        wpp = bool(getattr(cfg, "wpp", False))
        sd = self.sd
        sl_en = getattr(self, "_sao_slice_enabled", None)
        if sl_en is None:
            sl_en = [True, True, True]
        if sps.chroma_format_idc:
            enabled = [1 if sl_en[c] else 0 for c in range(3)]
        else:
            enabled = [1 if sl_en[0] else 0, 0, 0]
        pos_of = {a: i for i, a in enumerate(scan)}
        payloads = []
        bank = self.bank   # the recorded ops reference these arrays:
        # every reset/restore below must write IN PLACE

        def bank_reset():
            fresh = make_context_bank(slice_type, qp_pic, self._cabac_init())
            for k in bank:
                bank[k][:] = fresh[k]

        def bank_restore(saved):
            for k in bank:
                bank[k][:] = saved[k]

        dep = bool(getattr(cfg, "dependent_slices", False))
        # the WPP row snapshot spans dependent-segment boundaries (the
        # decoder's storage persists per picture); cross-slice sync is
        # already rejected by the slice_idx availability check below
        wpp_saved = None
        for si, start in enumerate(slice_starts):
            end = slice_starts[si + 1] if si + 1 < len(slice_starts) \
                else len(scan)
            if si == 0 or not dep:
                bank_reset()
            # dependent segments continue the previous segment's contexts
            sao_counts = {"sao_merge": np.zeros(len(bank["sao_merge"]),
                                                np.int64),
                          "sao_type": np.zeros(len(bank["sao_type"]),
                                               np.int64)} \
                if "sao_merge" in bank else None
            subs = []
            bw = BitWriter()
            enc = CabacEncoder(bw)
            for pos in range(start, end):
                addr = scan[pos]
                col = addr % wc
                tile = sd.tile_map[addr]
                cx = col << sps.log2_ctb
                cy = (addr // wc) << sps.log2_ctb
                # a dependent segment starting at a tile boundary or WPP
                # row start takes the init / sync path instead of the
                # continued contexts (mirrors slicedec.decode_slice)
                seg_first = pos == start
                if pos > start or (seg_first and dep and pos > 0):
                    prev_tile = sd.tile_map[scan[pos - 1]]
                    new_tile = tile != prev_tile
                    new_row = wpp and not new_tile and \
                        col == sd._tile_first_col(addr)
                    if new_tile or new_row:
                        if not seg_first:
                            # previous CTU ended with end_of_subset_one_bit
                            # + CABAC flush; byte-align, open new substream
                            bw.align_zero()
                            subs.append(bw.data())
                            bw = BitWriter()
                            enc = CabacEncoder(bw)
                        if new_tile:
                            bank_reset()
                        else:
                            # WPP: sync from the snapshot after the 2nd CTU
                            # of the row above when the above-right CTU is
                            # in the same slice and tile (mirrors
                            # slicedec.decode_slice)
                            ok = (wpp_saved is not None and cy > 0 and
                                  col + 1 < wc and
                                  sd.tile_map[addr - wc + 1] == tile and
                                  self.pic.slice_idx[(cy - 4) >> 2,
                                                     (cx + sps.ctb_size) >> 2]
                                  == (0 if dep else si))
                            if ok:
                                bank_restore(wpp_saved)
                            else:
                                bank_reset()
                if cfg.sao and (enabled[0] or enabled[1]):
                    # merge availability is per SLICE: dependent segments
                    # share the slice, independent slices do not
                    lo = 0 if dep else start
                    hi = len(scan) if dep else end
                    write_sao_ctu(
                        enc, bank, self.pic, addr, wc, enabled, sps,
                        avail=lambda other, _t=tile, _lo=lo, _hi=hi: (
                            sd.tile_map[other] == _t and
                            _lo <= pos_of[other] < _hi),
                        counts=sao_counts)
                rec.replay(enc, rec.marks[pos], rec.marks[pos + 1])
                last_of_slice = pos == end - 1
                enc.encode_terminate(1 if last_of_slice else 0)
                if not last_of_slice:
                    nxt = scan[pos + 1]
                    boundary = sd.tile_map[nxt] != tile or \
                        (wpp and (nxt % wc) == sd._tile_first_col(nxt))
                    if boundary:
                        enc.encode_terminate(1)  # end_of_subset_one_bit
                if wpp and col == sd._tile_first_col(addr) + 1:
                    wpp_saved = {k: v.copy() for k, v in bank.items()}
            bw.align_zero()
            subs.append(bw.data())
            data = b"".join(subs)
            rbsp_offs = [len(s) for s in subs[:-1]]
            # header + EBSP-domain entry point offsets (Rec. 7.4.7.1 counts
            # emulation-prevention bytes; iterate because the header length
            # feeds back into the escape positions)
            eps = list(rbsp_offs)
            for _ in range(4):
                hdr = write_slice_header(
                    cfg, nal_type, poc, slice_type, qp_pic,
                    rps=getattr(self, "_cur_rps_hdr", rps),
                    rps_idx=getattr(self, "_cur_rps_idx", 0),
                    wp=self.cur_wp,
                    wp_l1=getattr(self, "cur_wp_l1", None),
                    segment_address=scan[start] if start
                    else 0, entry_points=eps if rbsp_offs else None,
                    dependent=dep and start > 0,
                    sao_flags=(enabled[0], enabled[1]),
                    num_ref=(self.sh.num_ref_idx[0], self.sh.num_ref_idx[1])
                    if slice_type in (0, 1) else None,
                    cabac_init_flag=self._cabac_init(),
                    mvd_l1_zero=getattr(self.sh, "mvd_l1_zero", 0)
                    if slice_type in (0, 1) else 0,
                    col_from_l0=getattr(self.sh, "collocated_from_l0", 1)
                    if slice_type in (0, 1) else 1).data()
                from .hls_writer import epb_positions
                epb = epb_positions(hdr + data)
                new_eps = []
                a = len(hdr)
                for span in rbsp_offs:
                    b = a + span
                    k = sum(1 for p in epb if a < p <= b)
                    new_eps.append(span + k)
                    a = b
                if new_eps == eps:
                    break
                eps = new_eps
            payloads.append(hdr + data)
            # per-slice adaptive init-table selection: this slice's op
            # range + its post-slice bank feed the NEXT slice's choice
            # (reference TEncSlice.cpp:1249-1252)
            self._update_cabac_table_idx(rec, qp_pic, rec.marks[start],
                                         rec.marks[end],
                                         sao_counts=sao_counts)
        return payloads

    # ------------------------------------------------------------------
    _ENC_NATIVE = ("unset",)
    _tufwd_cache = None  # per-bank enc_tu_fwd argument cache (_tu_fwd)

    def _enc_native(self):
        """ctypes handle to the native search kernels, or None."""
        if IntraEncoder._ENC_NATIVE == ("unset",):
            from ..hostdec.native_bridge import try_load
            IntraEncoder._ENC_NATIVE = (try_load(),)
        return IntraEncoder._ENC_NATIVE[0]

    def _native_ctu_eligible(self):
        """True when the per-CTU compress pass can run in the native CTU
        compressor (encctu.cpp) — the standard Main-profile toolset the
        port covers; anything else falls back to the Python reference
        path (which stays the oracle for byte-identity tests)."""
        cfg, sps = self.cfg, self.sps
        if os.environ.get("HEVC_ENC_NATIVE", "1") == "0":
            return False
        if self.slice_type != 2 and not self._native_inter_eligible():
            return False
        if sps.chroma_format_idc != 1:
            return False
        if getattr(cfg, "lossless", False) or \
                getattr(cfg, "pcm_enabled", False):
            return False
        if getattr(cfg, "scaling_list", False):
            lib = self._enc_native()
            if lib is None or not hasattr(lib, "enc_ctu_set_scaling"):
                return False
        if cfg.bit_depth > 12:
            return False
        if getattr(sps, "extended_precision", 0):
            return False
        for v in ("HEVC_FORCE_LUMA_MODE", "HEVC_FORCE_CHROMA_MODE",
                  "HEVC_FORCE_PART", "HEVC_DEBUG_RQT", "HEVC_DEBUG_PRED",
                  "HEVC_DUMP_BLOCKS", "HEVC_DBG_SKIPRD", "HEVC_TT_PROBE"):
            if os.environ.get(v):
                return False
        lib = self._enc_native()
        return lib is not None and hasattr(lib, "enc_ctu_create")

    def _native_inter_eligible(self):
        """Extra gates for P/B pictures on the native CTU compressor:
        complete reference lists and the col-pic TMVP maps when temporal
        MVP is on.  WP slices are native: the ME runs on the same
        pre-weighted planes as the Python path and predFromCand applies
        the exact weighted uni/bi epilogues."""
        sh = getattr(self, "sh", None)
        if sh is None or getattr(sh, "wp_luma", None) is not None:
            return False
        if (getattr(self, "cur_wp", None) or
                getattr(self, "cur_wp_l1", None)):
            lib = self._enc_native()
            if lib is None or not hasattr(lib, "enc_ctu_set_wp"):
                return False
        ref_pics = getattr(self, "ref_pics", None)
        if not ref_pics:
            return False
        for l in range(2):
            n = sh.num_ref_idx[l]
            if n > 16:
                return False
            if n > 0 and (not ref_pics[l] or
                          any(p is None for p in ref_pics[l])):
                return False
        lib = self._enc_native()
        return lib is not None and hasattr(lib, "enc_ctu_set_ref")

    def _native_compress(self, scan):
        """Run the whole decide+record pass in native code; returns a
        _NativeRecOps with per-CTU marks for the emission pass."""
        lib = self._enc_native()
        sps, cfg, pic, sd = self.sps, self.cfg, self.pic, self.sd
        inter = self.slice_type in (0, 1)
        sh = getattr(self, "sh", None) if inter else None
        all_before = 1
        if inter and getattr(self, "ref_pics", None):
            all_before = 1 if all(
                p is not None and p.poc <= sh.poc
                for lst in self.ref_pics for p in lst) else 0
        ia = np.array([
            sps.width, sps.height, cfg.bit_depth, sps.chroma_format_idc,
            sps.log2_ctb, sps.log2_min_cb, sps.log2_min_tb, sps.log2_max_tb,
            sps.max_tr_hierarchy_intra, sps.max_tr_hierarchy_inter,
            1 if sps.amp_enabled else 0,
            1 if sps.strong_intra_smoothing else 0,
            1 if getattr(sps, "intra_smoothing_disabled", 0) else 0,
            1 if cfg.sign_hiding else 0, 1 if cfg.rdoq else 0,
            1 if getattr(cfg, "transform_skip", False) else 0,
            self.slice_type, self.cur_qp,
            sh.num_ref_idx[0] if inter else 0,
            sh.num_ref_idx[1] if inter else 0,
            cfg.max_merge_cand, cfg.search_range,
            1 if getattr(cfg, "fast_search", 1) else 0,
            sh.temporal_mvp if inter else 0,
            sh.collocated_from_l0 if inter else 1,
            sh.collocated_ref_idx if inter else 0,
            sh.poc if inter else 0,
            1 if cfg.rdo_cu else 0, cfg.cu_size,
            int(os.environ.get("HEVC_INTRA_RD_CANDS", "2")),
            int(os.environ.get("HEVC_RD_PARTS", "0")),
            0 if os.environ.get("HEVC_RD_UNI", "1") == "0" else 1,
            pic.depth.shape[1], pic.depth.shape[0],
            sps.pic_width_ctbs, all_before,
            getattr(sd.pps, "log2_parallel_merge_level", 2),
            getattr(sh, "mvd_l1_zero", 0) if inter else 0,
            1 if getattr(cfg, "fast_enc", False) else 0,
            1 if getattr(self, "_dqp_enabled", False) else 0],
            np.int64)
        da = np.array([self.rd_lambda, self._lam_motion,
                       self.rd_lambda ** 0.5, self.chroma_weight[1],
                       self.chroma_weight[2]], np.float64)
        from ..hostdec.tables import NEXT_STATE_MPS as _NM, \
            NEXT_STATE_LPS as _NL
        ncomp = self.ncomp
        mp = np.array([
            pic.depth.ctypes.data, pic.pred_mode.ctypes.data,
            pic.part_size.ctypes.data, pic.skip.ctypes.data,
            pic.pcm.ctypes.data, pic.intra_y.ctypes.data,
            pic.intra_c.ctypes.data, pic.chroma_dm.ctypes.data,
            pic.qp.ctypes.data, pic.cbf_y.ctypes.data,
            pic.edge_flags.ctypes.data, pic.inter_dir.ctypes.data,
            pic.mv.ctypes.data, pic.ref_idx.ctypes.data,
            pic.ref_poc.ctypes.data, pic.ref_is_lt.ctypes.data,
            pic.slice_idx.ctypes.data, sd._zmap.ctypes.data,
            sd.tile_map.ctypes.data,
            self.orig[0].ctypes.data,
            self.orig[1].ctypes.data if ncomp > 1 else 0,
            self.orig[2].ctypes.data if ncomp > 1 else 0,
            self.recon[0].ctypes.data,
            self.recon[1].ctypes.data if ncomp > 1 else 0,
            self.recon[2].ctypes.data if ncomp > 1 else 0,
            _NM.ctypes.data, _NL.ctypes.data,
            self.recon[0].shape[1], self.recon[0].shape[0],
            self.recon[1].shape[1] if ncomp > 1 else 0,
            self.recon[1].shape[0] if ncomp > 1 else 0],
            np.int64)
        bp = np.array([_addr(self.bank[k]) for k in _NATIVE_BANK_KEYS],
                      np.int64)
        h = lib.enc_ctu_create(ia.ctypes.data, da.ctypes.data,
                               mp.ctypes.data, bp.ctypes.data)
        if getattr(cfg, "scaling_list", False):
            # build + pin the dequant matrices; the Python _tu_fwd path
            # uses the same tables, so both passes fold identically
            self._scaling_matrix(2, 0, True)
            for size_id in range(4):
                for matrix_id in range(6):
                    m = self._scal_mats[(size_id, matrix_id)]
                    lib.enc_ctu_set_scaling(h, size_id, matrix_id,
                                            m.ctypes.data)
        keep = []   # pin int16 ref copies + padded planes for the call
        if inter:
            R = cfg.search_range
            plane_ids = {}
            i16cache = self._i16ref_cache
            wp_any = bool(getattr(self, "cur_wp", None) or
                          getattr(self, "cur_wp_l1", None))
            for l in range(2):
                for r in range(sh.num_ref_idx[l]):
                    luma = self._ref_plane(0, l, r)
                    # plane dedup keys on the UNWEIGHTED picture plane,
                    # mirroring _pu_me_lists' plane_cache
                    pid = plane_ids.setdefault(id(luma), len(plane_ids))
                    planes16 = []
                    for c in range(self.ncomp):
                        pl = self._ref_plane(c, l, r)
                        hit = i16cache.get(id(pl))
                        if hit is None or hit[0] is not pl:
                            hit = (pl, np.ascontiguousarray(pl, np.int16))
                            i16cache[id(pl)] = hit
                        planes16.append(hit[1])
                    while len(planes16) < 3:
                        planes16.append(None)
                    # ME runs on the pre-weighted plane under WP (the
                    # exact plane _motion_search_rect would pad)
                    padded = self._padded(self._search_plane(l, r), R,
                                          np.int16)
                    if wp_any:
                        tab = self.cur_wp if l == 0 else \
                            getattr(self, "cur_wp_l1", None)
                        wp = tab[min(r, len(tab) - 1)] if tab else None
                        if wp is not None:
                            ws = (list(wp["w"]) + [0, 0])[:3]
                            os_ = (list(wp["o"]) + [0, 0])[:3]
                            lib.enc_ctu_set_wp(
                                h, l, r, int(ws[0]), int(ws[1]),
                                int(ws[2]), int(os_[0]), int(os_[1]),
                                int(os_[2]), int(wp["denom"]), 1)
                    rp = self.ref_pics[l][min(r,
                                              len(self.ref_pics[l]) - 1)]
                    lib.enc_ctu_set_ref(
                        h, l, r, planes16[0].ctypes.data,
                        planes16[1].ctypes.data
                        if planes16[1] is not None else 0,
                        planes16[2].ctypes.data
                        if planes16[2] is not None else 0,
                        padded.ctypes.data, padded.shape[1],
                        padded.shape[0], pid, rp.poc,
                        1 if getattr(rp, "is_long_term", False) else 0)
                    keep.append((planes16, padded))
            col = getattr(self.motion, "col_pic", None) \
                if sh.temporal_mvp else None
            cp = getattr(col, "pic_syntax", None) if col is not None \
                else None
            if cp is not None:
                lib.enc_ctu_set_col(
                    h, cp.pred_mode.ctypes.data, cp.inter_dir.ctypes.data,
                    cp.mv.ctypes.data, cp.ref_poc.ctypes.data,
                    cp.ref_is_lt.ctypes.data, cp.w4, cp.h4, col.poc)
        try:
            marks = [0]
            wc = sps.pic_width_ctbs
            # dqp (adaptive QP / per-LCU rate control): mirror the Python
            # path's ctu_qg_start/_rc_lcu_close around each native CTU
            dqp_en = getattr(self, "_dqp_enabled", False)
            rc = getattr(self, "_rc", None)
            lcu_rc = (not cfg.adaptive_qp and rc is not None and
                      getattr(rc, "lcu_level", False) and
                      getattr(rc, "lcu_rc", True))
            m4c = sps.ctb_size >> 2
            nctu_x = sps.pic_width_ctbs
            rc_prev = None     # (addr, qp, lam, ops_lo)

            def _rc_close():
                if rc_prev is None:
                    return
                addr0, qp0, lam0, lo0 = rc_prev
                bits = int(lib.enc_ctu_est_bits(h, lo0) + 0.5)
                x4 = (addr0 % nctu_x) * m4c
                y4 = (addr0 // nctu_x) * m4c
                sk = pic.skip[y4:y4 + m4c, x4:x4 + m4c]
                rc.lcu_end(max(1, bits), qp0,
                           lam0 if lam0 is not None else self.rd_lambda,
                           bool((sk == 0).any()))
            for addr in scan:
                cx = (addr % wc) << sps.log2_ctb
                cy = (addr // wc) << sps.log2_ctb
                if dqp_en:
                    if cfg.adaptive_qp:
                        lib.enc_ctu_qg_start(h, int(self._qp_map[addr]),
                                             0.0, 0.0, 0.0)
                    elif lcu_rc:
                        _rc_close()
                        qp, lam = rc.lcu_start(
                            forced_fixed=(self.slice_type == 2 and
                                          rc.force_intra_qp))
                        if lam is not None:
                            lib.enc_ctu_qg_start(h, qp, lam, lam ** 0.5,
                                                 lam ** 0.5)
                        else:
                            lib.enc_ctu_qg_start(h, qp, 0.0, 0.0, 0.0)
                        rc_prev = (addr, qp, lam, marks[-1])
                marks.append(int(lib.enc_ctu_compress(h, cx, cy)))
            if dqp_en and lcu_rc:
                _rc_close()
            n = marks[-1]
            kind = np.empty(n, np.uint8)
            a = np.empty(n, np.int32)
            b = np.empty(n, np.int32)
            if n:
                lib.enc_ctu_fetch_ops(h, kind.ctypes.data, a.ctypes.data,
                                      b.ctypes.data)
        finally:
            lib.enc_ctu_destroy(h)
        banks = [self.bank[k] for k in _NATIVE_BANK_KEYS]
        return _NativeRecOps(kind, a, b, marks, banks)

    def _padded(self, plane, R, dtype):
        """Edge-padded copy of a reference plane (pad = R + 8) in dtype,
        cached per plane object and dtype for the current picture."""
        cache = getattr(self, "_padded_cache", None)
        if cache is None:
            cache = self._padded_cache = {}
        key = (id(plane), np.dtype(dtype).str)
        hit = cache.get(key)
        if hit is not None and hit[0] is plane and hit[1] == R:
            return hit[2]
        padded = np.ascontiguousarray(
            np.pad(plane, R + 8, mode="edge"), dtype)
        cache[key] = (plane, R, padded)
        return padded

    def _native_search(self, lib, name):
        """(entry point, sample type) of encsearch.cpp's `name`: the int16
        form up to 12 bits, where it holds every sample and intermediate,
        and the int32 form (`name`32) above."""
        if self.cfg.bit_depth > 12:
            return getattr(lib, name + "32"), np.int32
        return getattr(lib, name), np.int16

    def _ref_plane(self, comp, l, ref_idx=0):
        # cached per picture so the returned slice has a stable identity —
        # the padded-plane caches downstream key on id(plane)
        cache = getattr(self, "_refplane_cache", None)
        if cache is None:
            cache = self._refplane_cache = {}
        key = (comp, l, ref_idx)
        hit = cache.get(key)
        if hit is not None:
            return hit
        sps = self.sps
        ssx = sps.chroma_shift_x() if comp else 0
        ssy = sps.chroma_shift_y() if comp else 0
        if getattr(self, "ref_pics", None) and self.ref_pics[l]:
            rp = self.ref_pics[l][min(ref_idx, len(self.ref_pics[l]) - 1)]
        else:
            rp = self._prev_ref
        plane = rp.planes[comp][:sps.height >> ssy, :sps.width >> ssx]
        cache[key] = plane
        return plane

    def _search_plane(self, l, r):
        """Luma reference plane for motion search, pre-weighted under WP
        (reference TComRdCostWeightPrediction xGetSADw weights candidate
        pixels; weighting the plane once hoists the same affine map out of
        the search loop).  Cached per (plane, list, ref)."""
        plane = self._ref_plane(0, l, r)
        tab = self.cur_wp if l == 0 else getattr(self, "cur_wp_l1", None)
        wp = tab[min(r, len(tab) - 1)] if tab else None
        if wp is None:
            return plane
        bd = self.cfg.bit_depth
        cache = getattr(self, "_wplane_cache", None)
        if cache is None:
            cache = self._wplane_cache = {}
        key = (id(plane), l, r)
        hit = cache.get(key)
        if hit is not None and hit[0] is plane:
            return hit[1]
        wgt, dn = wp["w"][0], wp["denom"]
        off = wp["o"][0] * (1 << (bd - 8))
        rnd = (1 << (dn - 1)) if dn > 0 else 0
        wpl = np.clip(((wgt * plane.astype(np.int64) + rnd)
                       >> dn) + off, 0, (1 << bd) - 1)
        wpl = wpl.astype(plane.dtype)
        cache[key] = (plane, wpl)
        return wpl

    def _pred_from_cand(self, comp, x, y, w, h, dir_, mvs, ref_idx=(0, 0)):
        """Prediction for a merge candidate (uni L0/L1 or bi)."""
        sps = self.sps
        ssx = sps.chroma_shift_x() if comp else 0
        ssy = sps.chroma_shift_y() if comp else 0
        bd = sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma
        taps = 8 if comp == 0 else 4
        ftab = LUMA_FILTER if comp == 0 else CHROMA_FILTER
        fbx = 2 + (ssx if comp else 0)
        fby = 2 + (ssy if comp else 0)
        def wp_of(l, ri):
            tab = self.cur_wp if l == 0 else getattr(self, "cur_wp_l1", None)
            if not tab:
                return None
            return tab[min(ri, len(tab) - 1)]
        if dir_ != 3:
            l = 0 if dir_ == 1 else 1
            ri = max(0, ref_idx[l])
            wp = wp_of(l, ri) if getattr(self, "cur_wp", None) else None
            if wp is None:
                return _interp(self._ref_plane(comp, l, ri),
                               x >> ssx, y >> ssy,
                               w >> ssx, h >> ssy,
                               int(mvs[l][0]), int(mvs[l][1]),
                               fbx, fby, taps, ftab, bd, is_last=True)
            # weighted uni-prediction on IF-precision samples, matching the
            # decoder's _weighted_uni (reference TComWeightPrediction
            # addWeightUni)
            pred = _interp(self._ref_plane(comp, l, ri),
                           x >> ssx, y >> ssy,
                           w >> ssx, h >> ssy,
                           int(mvs[l][0]), int(mvs[l][1]),
                           fbx, fby, taps, ftab, bd, is_last=False)
            wgt, off = wp["w"][comp], wp["o"][comp] * (1 << (bd - 8))
            shift = wp["denom"] + mc_headroom(bd)
            rnd = (1 << (shift - 1)) if shift > 0 else 0
            return np.clip(((wgt * (pred + IF_OFFS) + rnd) >> shift) + off,
                           0, (1 << bd) - 1)
        preds = [
            _interp(self._ref_plane(comp, l, max(0, ref_idx[l])),
                    x >> ssx, y >> ssy,
                    w >> ssx, h >> ssy, int(mvs[l][0]), int(mvs[l][1]),
                    fbx, fby, taps, ftab, bd, is_last=False)
            for l in range(2)]
        wp0 = wp_of(0, max(0, ref_idx[0]))
        wp1 = wp_of(1, max(0, ref_idx[1]))
        if (wp0 is None) != (wp1 is None):
            # flag-0 references carry identity weights (w = 1<<denom, o=0)
            # and still go through the weighted rounding path on the
            # decoder side — substitute the identity entry
            d = (wp0 or wp1)["denom"]
            ident = {"w": [1 << d] * 3, "o": [0] * 3, "denom": d}
            wp0 = wp0 or ident
            wp1 = wp1 or ident
        if wp0 is not None and wp1 is not None:
            # explicit bi WP (decoder _weighted_bi / reference addWeightBi)
            scale = 1 << (bd - 8)
            o0 = wp0["o"][comp] * scale
            o1 = wp1["o"][comp] * scale
            shift = (wp0["denom"] + 1) + mc_headroom(bd)
            rnd = 1 << (shift - 1)
            val = (wp0["w"][comp] * (preds[0] + IF_OFFS) +
                   wp1["w"][comp] * (preds[1] + IF_OFFS) + rnd +
                   ((o0 + o1) << (shift - 1))) >> shift
            return np.clip(val, 0, (1 << bd) - 1)
        return bi_average(preds[0], preds[1], bd)

    def _inter_pred(self, comp, x, y, w, h, mv):
        """Uni-L0 MC prediction block (final samples)."""
        return self._pred_from_cand(comp, x, y, w, h, 1, [mv, (0, 0)])

    # ------------------------------------------------------------------
    def _sao_decide_pic_enabled(self, poc):
        """Picture-level SAO on/off per component (reference
        TEncSampleAdaptiveOffset::decidePicParams, SAO_ENCODING_CHOICE):
        for hierarchy-depth > 0 pictures a component is disabled when the
        previous depth layer's SAO-off CTU rate exceeded 0.75 (luma) /
        0.5 (chroma).  Sets self._sao_slice_enabled, consumed by
        _estimate_sao, the slice-header writer and the emission pass."""
        gop_size = max(1, getattr(self.cfg, "gop_size", None) or
                       len(getattr(self.cfg, "gop_entries", None) or []) or 1)
        depth = _hm_gop_depth(poc, gop_size) if gop_size > 1 else 0
        rates = getattr(self, "_sao_disabled_rate", None)
        if rates is None:
            rates = self._sao_disabled_rate = {}
        en = [True, True, True]
        if depth > 0:
            for c in range(3):
                thr = 0.75 if c == 0 else 0.5
                if rates.get((c, depth - 1), 0.0) > thr:
                    en[c] = False
        self._sao_depth = depth
        self._sao_slice_enabled = en

    def _estimate_sao(self):
        """Fill pic.sao_* per CTU: derive lambda-optimal new-type
        candidates from category statistics, then RD-compare
        off / new / merge-left / merge-up jointly over the components
        (reference TEncSampleAdaptiveOffset::decideBlkParams,
        deriveModeNewRDO / deriveModeMergeRDO).  Distortion terms use the
        slice lambda with the chroma SSE weights, the same currency as
        every other RD decision this slice made."""
        from .sao_enc import sao_stats, derive_candidates, params_gain
        sps, cfg, pic = self.sps, self.cfg, self.pic
        lam = self.rd_lambda
        cw = getattr(self, "chroma_weight", [1.0, 1.0, 1.0])
        ncomp = 3 if sps.chroma_format_idc else 1
        en = getattr(self, "_sao_slice_enabled", None)
        if en is None:
            en = [True, True, True]
        luma_on = en[0]
        chroma_on = ncomp == 3 and en[1]
        nctu_x = sps.pic_width_ctbs
        bd = cfg.bit_depth
        if not luma_on and not chroma_on:
            pic.sao_type[:, :] = -1
            pic.sao_band_pos[:, :] = 0
            pic.sao_offsets[:, :, :] = 0
            self._sao_update_disabled_rate(ncomp)
            return
        for addr in range(sps.pic_size_ctbs):
            cx = (addr % nctu_x) << sps.log2_ctb
            cy = (addr // nctu_x) << sps.log2_ctb
            stats, cands = [], []
            for c in range(ncomp):
                if not en[c]:
                    stats.append(None)
                    cands.append(None)
                    continue
                ssx = sps.chroma_shift_x() if c else 0
                ssy = sps.chroma_shift_y() if c else 0
                W, H = sps.width >> ssx, sps.height >> ssy
                x0, y0 = cx >> ssx, cy >> ssy
                x1 = min(x0 + (sps.ctb_size >> ssx), W)
                y1 = min(y0 + (sps.ctb_size >> ssy), H)
                st = sao_stats(self.orig[c][:H, :W],
                               self.recon[c][:H, :W], x0, y0, x1, y1, bd)
                stats.append(st)
                # per-component lambda so the weighted net is w*gain-l*bits
                cands.append(derive_candidates(st, bd, lam / cw[c]))

            # --- best NEW params per signal group (luma; chroma pair) ---
            new_par = [(-1, 0, [0, 0, 0, 0]) for _ in range(ncomp)]
            luma_best, luma_net = None, 0.0     # vs luma-off (1 type bin)
            if luma_on:
                for t in ["bo"] + [f"eo{k}" for k in range(4)]:
                    net = cands[0][t][-1] - lam  # extra on-vs-off type bin
                    if net > luma_net:
                        luma_best, luma_net = t, net
            if luma_best == "bo":
                pos, ov, _ = cands[0]["bo"]
                new_par[0] = (0, pos, ov)
            elif luma_best is not None:
                k = int(luma_best[2:])
                new_par[0] = (1 + k, 0, cands[0][luma_best][0])
            chroma_net = 0.0
            if chroma_on:
                chroma_best = None
                for t in ["bo"] + [f"eo{k}" for k in range(4)]:
                    net = (cw[1] * cands[1][t][-1] +
                           cw[2] * cands[2][t][-1] - lam)
                    if net > chroma_net:
                        chroma_best, chroma_net = t, net
                if chroma_best == "bo":
                    for c in (1, 2):
                        pos, ov, _ = cands[c]["bo"]
                        new_par[c] = (0, pos, ov)
                elif chroma_best is not None:
                    k = int(chroma_best[2:])
                    for c in (1, 2):
                        new_par[c] = (1 + k, 0, cands[c][chroma_best][0])

            # --- merge candidates: copy the already-decided neighbour ---
            # scores are RELATIVE to the all-off option, which pays the
            # zero-valued merge bins (nskip) plus one type bin per signal
            # group; "new" pays the same merge bins (cancels), merges pay
            # neither the merge-zero bins nor the type bins
            can_left = addr % nctu_x > 0
            can_up = addr >= nctu_x
            nskip = (1 if can_left else 0) + (1 if can_up else 0)
            off_bits = (1 if luma_on else 0) + (1 if chroma_on else 0)
            options = [("new", luma_net + chroma_net)]
            for name, ok, other, bins in (("left", can_left, addr - 1, 1),
                                          ("up", can_up, addr - nctu_x, 2)):
                if not ok:
                    continue
                g = 0.0
                for c in range(ncomp):
                    if not en[c]:
                        continue
                    g += cw[c] * params_gain(
                        stats[c], int(pic.sao_type[other, c]),
                        int(pic.sao_band_pos[other, c]),
                        pic.sao_offsets[other, c])
                g += lam * (nskip + off_bits - bins)
                options.append((name, g))
            options.sort(key=lambda o: -o[1])
            choice = options[0][0] if options[0][1] > 0 else "off"

            if choice in ("left", "up"):
                other = addr - 1 if choice == "left" else addr - nctu_x
                for c in range(ncomp):
                    pic.sao_type[addr, c] = pic.sao_type[other, c]
                    pic.sao_band_pos[addr, c] = pic.sao_band_pos[other, c]
                    pic.sao_offsets[addr, c] = pic.sao_offsets[other, c]
            elif choice == "off":
                for c in range(ncomp):
                    pic.sao_type[addr, c] = -1
                    pic.sao_band_pos[addr, c] = 0
                    pic.sao_offsets[addr, c] = 0
            else:
                for c in range(ncomp):
                    t, pos, ov = new_par[c]
                    pic.sao_type[addr, c] = t
                    pic.sao_band_pos[addr, c] = pos
                    pic.sao_offsets[addr, c] = ov
        self._sao_update_disabled_rate(ncomp)

    def _sao_update_disabled_rate(self, ncomp):
        """Record this picture's SAO-off CTU rate per component at its
        hierarchy depth (reference TEncSampleAdaptiveOffset::
        decideBlkParams tail, m_saoDisabledRate update) — feeds the next
        pictures' decidePicParams gating."""
        rates = getattr(self, "_sao_disabled_rate", None)
        if rates is None:
            rates = self._sao_disabled_rate = {}
        depth = getattr(self, "_sao_depth", 0)
        nctu = self.sps.pic_size_ctbs
        for c in range(ncomp):
            off = int(np.count_nonzero(self.pic.sao_type[:, c] == -1))
            rates[(c, depth)] = off / nctu

    def _motion_search(self, x, y, size, pred_mv):
        return self._motion_search_rect(x, y, size, size, pred_mv)

    # TZ search (reference TEncSearch xPatternSearchFast / xTZSearch,
    # TEncSearch.cpp:337-678, 4170): start from the predictor and zero,
    # expanding 8-point diamond, raster fallback when the best point is
    # far, then star refinement around each new best until convergence.
    _TZ_DIAMOND = ((0, -1), (0, 1), (-1, 0), (1, 0),
                   (-1, -1), (1, -1), (-1, 1), (1, 1))

    def _me_subshift(self, h):
        """FEN subsampled-SAD row shift for integer ME (reference
        TEncSearch.cpp:351/4127: every other row when rows > 8)."""
        return 1 if getattr(self.cfg, "fast_enc", False) and h > 8 else 0

    def _tz_integer(self, orig, plane, px, py, w, h, pred_int, R,
                    pred_mv=(0, 0)):
        # edge-padded reference (cached per plane): SAD windows become
        # contiguous slices instead of clipped fancy-index gathers
        pad = R + 8
        cache_key = (id(plane), pad)
        pc = getattr(self, "_pad_cache", None)
        if pc is None or pc[0] != cache_key or pc[1] is not plane:
            padded = np.pad(plane, pad, mode="edge")
            self._pad_cache = (cache_key, plane, padded)
        padded = self._pad_cache[2]
        cache = {}
        lam_m = self._lam_motion
        dsh = self.cfg.bit_depth - 8

        sub = self._me_subshift(h)
        step = 1 << sub
        orig_s = orig[::step]

        def sad(d):
            # SAD + sqrt-lambda * MV bits vs the AMVP predictor (reference
            # xGetCost inside xTZSearch); FEN subsamples rows
            if d in cache:
                return cache[d]
            dx, dy = d
            y0, x0 = py + dy + pad, px + dx + pad
            c = ((int(np.abs(padded[y0:y0 + h:step, x0:x0 + w]
                             - orig_s).sum()) << sub)
                 >> dsh) + lam_m * self._mv_bits((dx << 2) - pred_mv[0],
                                                 (dy << 2) - pred_mv[1])
            cache[d] = c
            return c

        def clampmv(v):
            return (min(max(v[0], -R), R), min(max(v[1], -R), R))

        best_mv = (0, 0)
        best = sad(best_mv)
        for cand in (clampmv(pred_int),):
            c = sad(cand)
            if c < best:
                best, best_mv = c, cand

        def diamond(center, dist):
            nonlocal best, best_mv, best_dist
            for ox, oy in self._TZ_DIAMOND:
                mv = (center[0] + ox * dist, center[1] + oy * dist)
                if abs(mv[0]) > R or abs(mv[1]) > R:
                    continue
                c = sad(mv)
                if c < best:
                    best, best_mv, best_dist = c, mv, dist

        # first search: expanding diamond around the start point
        start = best_mv
        best_dist = 0
        d = 1
        while d <= R:
            diamond(start, d)
            d <<= 1
        # raster when the best match is far from the start (iRaster == 5)
        if best_dist > 5:
            for dy in range(-R, R + 1, 5):
                for dx in range(-R, R + 1, 5):
                    c = sad((dx, dy))
                    if c < best:
                        best, best_mv, best_dist = c, (dx, dy), 5
        # star refinement: re-center until a full round finds nothing
        while best_dist:
            center = best_mv
            best_dist = 0
            d = 1
            while d <= R:
                diamond(center, d)
                d <<= 1
        return best_mv, best

    def _bi_window_search(self, px, py, w, h, target, start_mv, pred_mv,
                          l, r):
        """One bi-refinement pass: integer SAD scan over HM's
        bipredSearchRange (+-4) around the current MV against the
        2*orig - predOther template, then HAD fractional refine
        (xMotionEstimation with bBi, TEncSearch.cpp:4003-4021).
        Returns (quarter-pel MV, template-domain HAD distortion)."""
        plane = self._search_plane(l, r)
        cfg = self.cfg
        lib = self._enc_native()
        if lib is not None:
            # native window SAD + HAD frac refine (encsearch.cpp biRefine)
            R = cfg.search_range
            refine, dt = self._native_search(lib, "enc_bi_refine")
            padded = self._padded(plane, R, dt)
            tmpl = np.ascontiguousarray(target, dt)
            out = np.zeros(3, np.int64)
            refine(
                padded.ctypes.data, padded.shape[1], padded.shape[0],
                R + 8, tmpl.ctypes.data, px, py, w, h, R,
                int(pred_mv[0]), int(pred_mv[1]),
                float(self._lam_motion), cfg.bit_depth,
                int(start_mv[0]), int(start_mv[1]),
                self._me_subshift(h), out.ctypes.data)
            return (int(out[0]), int(out[1])), int(out[2])
        H, W = plane.shape
        lam_m = self._lam_motion
        dsh = self.cfg.bit_depth - 8
        cx, cy = start_mv[0] >> 2, start_mv[1] >> 2
        t32 = target.astype(np.int32)
        sub = self._me_subshift(h)
        step = 1 << sub
        best, bmv = None, (cx, cy)
        for dy in range(-4, 5):
            ys = np.clip(np.arange(py + cy + dy, py + cy + dy + h, step),
                         0, H - 1)
            rows = plane[ys]
            for dx in range(-4, 5):
                xs = np.clip(np.arange(px + cx + dx, px + cx + dx + w),
                             0, W - 1)
                sad = (int(np.abs(rows[:, xs].astype(np.int32)
                                  - t32[::step]).sum()) << sub) >> dsh
                mvq = ((cx + dx) << 2, (cy + dy) << 2)
                c = sad + lam_m * self._mv_bits(mvq[0] - pred_mv[0],
                                                mvq[1] - pred_mv[1])
                if best is None or c < best:
                    best, bmv = c, (cx + dx, cy + dy)
        mv, dist = self._frac_refine((bmv[0] << 2, bmv[1] << 2), px, py,
                                     w, h, t32, pred_mv, l, r)
        return mv, dist

    def _frac_refine(self, best_mv, px, py, w, h, orig, pred_mv, l, r):
        """Two-stage half- then quarter-pel refinement over the 8
        neighbours of the running best, Hadamard-costed (reference
        xPatternSearchFracDIF, TEncSearch.cpp:4563, which uses HAD for
        the fractional stage).  Returns (mv, pure SATD distortion)."""
        lam_m = self._lam_motion
        dsh = self.cfg.bit_depth - 8
        mvs = [(0, 0), (0, 0)]
        ref_idx = [-1, -1]
        ref_idx[l] = r

        def had(mv):
            mvs[l] = mv
            pred = self._pred_from_cand(0, px, py, w, h, l + 1, mvs, ref_idx)
            return satd(pred, orig) >> dsh

        best_dist = had(best_mv)
        best = best_dist + lam_m * self._mv_bits(best_mv[0] - pred_mv[0],
                                                 best_mv[1] - pred_mv[1])
        for step in (2, 1):
            center = best_mv
            for ox, oy in self._TZ_DIAMOND:
                mv = (center[0] + ox * step, center[1] + oy * step)
                d = had(mv)
                cost = d + lam_m * self._mv_bits(mv[0] - pred_mv[0],
                                                 mv[1] - pred_mv[1])
                if cost < best:
                    best, best_mv, best_dist = cost, mv, d
        return best_mv, best_dist

    def _write_merge_idx(self, idx):
        enc, bank = self.enc, self.bank
        n = self.cfg.max_merge_cand
        if n > 1:
            enc.encode_bin(bank["merge_idx"], 0, 1 if idx > 0 else 0)
            if idx > 0:
                for k in range(1, idx):
                    enc.encode_bypass(1)
                if idx < n - 1:
                    enc.encode_bypass(0)

    def _write_mvd(self, mvd):
        enc, bank = self.enc, self.bank
        ax, ay = abs(mvd[0]), abs(mvd[1])
        enc.encode_bin(bank["mvd"], 0, 1 if ax else 0)
        enc.encode_bin(bank["mvd"], 0, 1 if ay else 0)
        if ax:
            enc.encode_bin(bank["mvd"], 1, 1 if ax > 1 else 0)
        if ay:
            enc.encode_bin(bank["mvd"], 1, 1 if ay > 1 else 0)
        if ax:
            if ax > 1:
                enc.encode_eg_k(ax - 2, 1)
            enc.encode_bypass(1 if mvd[0] < 0 else 0)
        if ay:
            if ay > 1:
                enc.encode_eg_k(ay - 2, 1)
            enc.encode_bypass(1 if mvd[1] < 0 else 0)

    def _write_bypass_flag(self, x, y, size):
        """cu_transquant_bypass_flag (first bin of coding_unit(), Rec.
        7.3.8.5) — always 1 under CUTransquantBypassFlagForce."""
        if getattr(self.cfg, "lossless", False):
            self.enc.encode_bin(self.bank["transquant_bypass"], 0, 1)
            self.pic.set_rect(self.pic.tq_bypass, x, y, size, size, 1)

    def _skip_ctx(self, x, y):
        pic, sd = self.pic, self.sd
        ctx = 0
        if sd.available(x - 1, y, x, y, False) and pic.skip[y >> 2, (x - 1) >> 2]:
            ctx += 1
        if sd.available(x, y - 1, x, y, False) and pic.skip[(y - 1) >> 2, x >> 2]:
            ctx += 1
        return ctx

    def _snapshot_motion(self, x, y, size):
        pic = self.pic
        sl = np.s_[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2]
        return (pic.inter_dir[sl].copy(), pic.mv[sl].copy(),
                pic.ref_idx[sl].copy(), pic.ref_poc[sl].copy(),
                pic.ref_is_lt[sl].copy(), len(pic.inter_list))

    def _restore_motion(self, x, y, size, snap):
        pic = self.pic
        sl = np.s_[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2]
        (pic.inter_dir[sl], pic.mv[sl], pic.ref_idx[sl], pic.ref_poc[sl],
         pic.ref_is_lt[sl]) = (snap[0], snap[1], snap[2], snap[3], snap[4])
        del pic.inter_list[snap[5]:]

    @staticmethod
    def _mv_bits(dx, dy):
        """Signed-EG0 bit length of an MVD (reference TComRdCost
        xGetComponentBits: motion-cost bit table)."""
        b = 0
        for v in (int(dx), int(dy)):
            n = (abs(v) << 1) + (1 if v <= 0 else 0)
            b += 2 * (n.bit_length() - 1) + 1
        return b

    @staticmethod
    def _ref_bits(r, nref):
        """Unary ref_idx bin count (truncated at nref-1)."""
        if nref <= 1:
            return 0
        return min(r + 1, nref - 1)

    @staticmethod
    def _blk_bits(part, p_slice, pu_idx, last_mode):
        """Inter-mode signalling bit estimate [uniL0, uniL1, bi] for the
        motion-cost model (reference TEncSearch::xGetBlkBits,
        TEncSearch.cpp:3823-3870)."""
        if part in (SIZE_2Nx2N, SIZE_NxN):
            return (1, 3, 5) if p_slice else (3, 3, 5)
        if p_slice:
            return (3, 0, 0)
        if part in (SIZE_2NxN, SIZE_2NxnU, SIZE_2NxnD):   # horizontal
            tab = (((0, 0, 3), (0, 0, 0), (0, 0, 0)),
                   ((5, 7, 7), (7, 5, 7), (6, 6, 6)))
        else:                                             # vertical
            tab = (((0, 2, 3), (0, 0, 0), (0, 0, 0)),
                   ((5, 7, 7), (5, 5, 7), (6, 6, 6)))
        return tab[min(pu_idx, 1)][last_mode]

    def _pu_me_lists(self, px, py, w, h, orig, part_size=None, pu_idx=0):
        """Per-list / per-ref AMVP motion estimation + one bi-prediction
        refinement round (reference TEncSearch::predInterSearch
        TEncSearch.cpp:3079-3500: uni ME over every ref of both lists,
        then iterative bi-pred with the 2*orig - predOther template).

        Returns a list of (cost, ("amvp", dir, ref_idx, mv, mvd, mvp_idx))
        candidates: best uni per list + the bi candidate.  Costs are
        SATD (8-bit domain) + sqrt-lambda * motion bits, with the
        reference's xGetBlkBits mode-bit charges.
        """
        lam_m = self._lam_motion
        dshift = 2 * (self.cfg.bit_depth - 8)
        nl = 2 if (self.slice_type == 0 and self.sh.num_ref_idx[1]) else 1
        blk = self._blk_bits(SIZE_2Nx2N if part_size is None else part_size,
                             nl == 1, pu_idx,
                             getattr(self, "_pu_last_mode", 0))
        mvdl1zero = nl == 2 and bool(getattr(self.sh, "mvd_l1_zero", 0))
        fen = bool(getattr(self.cfg, "fast_enc", False))
        best_bip = None          # (dist, mvp_idx, ref) for mvd_l1_zero L1
        best_uni = [None, None]  # per list: (cost, r, mv, mvd, mvp_idx, amvp)
        uni_rec = {}             # (l, r) -> [mv, amvp, mvp_idx] for bi passes
        plane_cache = {}
        for l in range(nl):
            for r in range(self.sh.num_ref_idx[l]):
                amvp = self.motion.amvp_candidates(px, py, w, h, l, r)
                if mvdl1zero and l == 1:
                    # bestBiPRefIdxL1/bestBiPMvpL1 (TEncSearch.cpp:3214):
                    # cheapest L1 (ref, AMVP cand) when the candidate IS
                    # the motion vector (no MVD coded)
                    for mi, cand in enumerate(amvp):
                        p = self._pred_from_cand(
                            0, px, py, w, h, 2, [(0, 0), cand], [-1, r])
                        d = satd(p, orig) >> dshift
                        if best_bip is None or d < best_bip[0]:
                            best_bip = (d, mi, r)
                plane = self._ref_plane(0, l, r)
                key = id(plane)
                if key in plane_cache:
                    # same physical picture already searched from the other
                    # list/ref slot (GPB duplicate lists): reuse the MV
                    mv, pcost = plane_cache[key]
                else:
                    mv, pcost = self._motion_search_rect(
                        px, py, w, h, amvp[0], l, r, orig)
                    plane_cache[key] = (mv, pcost)
                best = None
                for mi, cand in enumerate(amvp):
                    mvd = (mv[0] - cand[0], mv[1] - cand[1])
                    bits = blk[l] + self._mv_bits(*mvd) + 1 + \
                        self._ref_bits(r, self.sh.num_ref_idx[l])
                    c = pcost + lam_m * bits
                    if best is None or c < best[0]:
                        best = (c, r, mv, mvd, mi)
                uni_rec[(l, r)] = [mv, amvp, best[4]]
                if best_uni[l] is None or best[0] < best_uni[l][0]:
                    best_uni[l] = best + (amvp,)
        out = []
        for l in range(nl):
            if best_uni[l] is None:
                continue
            c, r, mv, mvd, mi, _ = best_uni[l]
            ref_idx = [-1, -1]
            mvs = [(0, 0), (0, 0)]
            mvds = [(0, 0), (0, 0)]
            mvps = [0, 0]
            ref_idx[l] = r
            mvs[l] = mv
            mvds[l] = mvd
            mvps[l] = mi
            out.append((c, ("amvp", l + 1, ref_idx, mvs, mvds, mvps)))
        # bi-prediction refinement (B slices, 8x4/4x8 PUs excluded)
        if nl == 2 and best_uni[0] and best_uni[1] and w + h != 12:
            u0, u1 = best_uni[0], best_uni[1]
            refs = [u0[1], u1[1]]
            mvs = [u0[2], u1[2]]
            mvds = [u0[3], u1[3]]
            mvps = [u0[4], u1[4]]
            # iterative per-ref template refinement (TEncSearch.cpp:
            # 3349-3436): up to 4 passes alternating lists (list 0
            # first); each pass re-searches EVERY ref index of the
            # active list against 2*orig - predOther from the current
            # committed motion (window = HM's bipredSearchRange +-4
            # around that ref's running MV, cMvTemp), re-picks the AMVP
            # candidate for the refined MV (xCheckBestMVP), and keeps
            # the (ref, mv, mvp) minimizing 0.5*templateDist +
            # lambda * (mbBits[2] + motBits[other] + ref/mvp/mvd bits)
            # — xMotionEstimation's fWeight=0.5 final cost.  Stops when
            # a full pass changes nothing.
            nref = (self.sh.num_ref_idx[0], self.sh.num_ref_idx[1])
            if mvdl1zero and best_bip is not None:
                # L1 pinned to its best AMVP candidate (TEncSearch.cpp:
                # 3312-3339): no L1 MVD is coded; mot_bits[1] keeps HM's
                # uiMbBits[1] charge plus ref + mvp-idx bits
                _, bmi, br = best_bip
                refs[1] = br
                amvp1 = self.motion.amvp_candidates(px, py, w, h, 1, br)
                mvs[1] = amvp1[bmi]
                mvds[1] = (0, 0)
                mvps[1] = bmi
                uni_rec[(1, br)][0] = mvs[1]     # cMvTemp[1][bestRef]
                uni_rec[(1, br)][2] = bmi
                mot_bits = [
                    self._mv_bits(*u0[3]) + 1 +
                    self._ref_bits(refs[0], nref[0]),
                    blk[1] + 1 + self._ref_bits(br, nref[1]),
                ]
            else:
                mot_bits = [
                    self._mv_bits(*u0[3]) + 1 +
                    self._ref_bits(refs[0], nref[0]),
                    self._mv_bits(*u1[3]) + 1 +
                    self._ref_bits(refs[1], nref[1]),
                ]
            # iteration policy (TEncSearch.cpp:3345-3380): 4 alternating
            # passes starting with L0; FEN or mvd_l1_zero run ONE pass —
            # FEN refines the weaker list, mvd_l1_zero always list 0
            n_iter = 1 if (fen or mvdl1zero) else 4
            cost_bi = None
            for it in range(n_iter):
                if mvdl1zero:
                    l = 0
                elif fen:
                    l = 1 if u0[0] <= u1[0] else 0
                else:
                    l = it % 2
                other = 1 - l
                p_other = self._pred_from_cand(
                    0, px, py, w, h, other + 1, mvs, refs).astype(np.int32)
                target = 2 * orig - p_other
                changed = False
                for r in range(nref[l]):
                    rec = uni_rec[(l, r)]
                    pred_mv = rec[1][rec[2]]
                    mv2, dist = self._bi_window_search(
                        px, py, w, h, target, rec[0], pred_mv, l, r)
                    rec[0] = mv2    # cMvTemp[l][r] updates in place
                    mi2 = min(range(len(rec[1])),
                              key=lambda i: self._mv_bits(
                                  mv2[0] - rec[1][i][0],
                                  mv2[1] - rec[1][i][1]))
                    rec[2] = mi2
                    mvd2 = (mv2[0] - rec[1][mi2][0], mv2[1] - rec[1][mi2][1])
                    bits = (blk[2] + mot_bits[other] + 1 +
                            self._ref_bits(r, nref[l]) +
                            self._mv_bits(*mvd2))
                    c = (dist >> 1) + lam_m * bits
                    if cost_bi is None or c < cost_bi:
                        changed = True
                        cost_bi = c
                        refs[l] = r
                        mvs[l] = mv2
                        mvds[l] = mvd2
                        mvps[l] = mi2
                        mot_bits[l] = bits - blk[2] - mot_bits[other]
                if not changed:
                    break
            pred_bi = self._pred_from_cand(0, px, py, w, h, 3, mvs, refs)
            if mvdl1zero:
                # HM prices bi with uiBits[2] = mbBits[2] + motBits[0] +
                # motBits[1] — no L1 MVD bits (none are coded)
                bits = blk[2] + mot_bits[0] + mot_bits[1]
            else:
                bits = (blk[2] +
                        self._mv_bits(*mvds[0]) + self._mv_bits(*mvds[1]) +
                        2 +
                        self._ref_bits(refs[0], self.sh.num_ref_idx[0]) +
                        self._ref_bits(refs[1], self.sh.num_ref_idx[1]))
            c = (satd(pred_bi, orig) >> dshift) + lam_m * bits
            out.append((c, ("amvp", 3, refs, mvs, mvds, mvps)))
        self._pu_me_all = out
        return out

    def _best_pu_motion(self, px, py, w, h, cx, cy, cu_size, pu_idx,
                        part_size, lam):
        """Decide one PU: best merge candidate vs per-list/per-ref ME.

        Returns (cost, desc) where desc = ("merge", idx, cand, dir) or
        ("amvp", dir, ref_idx[2], mv[2], mvd[2], mvp_idx[2]).  Does NOT
        write the motion maps.
        """
        orig = self.orig[0][py:py + h, px:px + w].astype(np.int32)
        lam_m = self._lam_motion
        dshift = 2 * (self.cfg.bit_depth - 8)
        best = None
        clist = self.motion.merge_candidate_list(px, py, w, h, cx, cy,
                                                 cu_size, pu_idx, part_size)
        best_ac = None
        self._pu_merge_cands = []  # all valid (deduped) merge candidates
        seen_motion = set()
        for mi in range(self.cfg.max_merge_cand):
            cand = clist[mi]
            dir_ = cand.inter_dir
            if self.sh.num_ref_idx[1] == 0:
                dir_ &= 1
            if w + h == 12 and dir_ == 3:
                dir_ = 1
            if not dir_:
                continue
            mkey = (dir_,) + tuple(
                (tuple(cand.mv[l]), cand.ref_idx[l])
                for l in range(2) if dir_ & (l + 1))
            if mkey not in seen_motion:
                seen_motion.add(mkey)
                self._pu_merge_cands.append(("merge", mi, cand, dir_))
            pred = self._pred_from_cand(0, px, py, w, h, dir_, cand.mv,
                                        cand.ref_idx)
            cost = (satd(pred, orig) >> dshift) + lam_m * (mi + 2)
            if best is None or cost < best[0]:
                best = (cost, ("merge", mi, cand, dir_))
            # AC-SATD ranking: a constant (DC) residual is one cheap
            # coefficient, but Hadamard charges it full price — rank a
            # second champion with the residual mean removed so the
            # CU-level full-RD arbitration sees the transform-cheap
            # candidate too (reference xCheckRDCostMerge2Nx2N full-RD
            # codes EVERY merge index, TEncCu.cpp, which covers this)
            dc = int(np.round((orig - pred).mean()))
            cost_ac = (satd(pred + dc, orig) >> dshift) + lam_m * (mi + 2)
            if best_ac is None or cost_ac < best_ac[0]:
                best_ac = (cost_ac, ("merge", mi, cand, dir_))
        # best merge-only candidates, for the caller's CU-level full-RD
        # arbitration against the ME result
        self._pu_best_merge = best[1] if best is not None else None
        self._pu_best_merge_ac = best_ac[1] if best_ac is not None and \
            (best is None or best_ac[1][1] != best[1][1]) else None
        for cost, desc in self._pu_me_lists(px, py, w, h, orig,
                                            part_size, pu_idx):
            if best is None or cost < best[0]:
                best = (cost, desc)
        # uiLastMode for the second PU's xGetBlkBits row
        d = best[1]
        if d[0] == "amvp":
            self._pu_last_mode = 2 if d[1] == 3 else d[1] - 1
        else:
            self._pu_last_mode = 2 if d[3] == 3 else d[3] - 1
        return best

    def _apply_pu(self, desc, px, py, w, h, cx, cy, cu_size, pu_idx,
                  part_size):
        if desc[0] == "merge":
            self.motion.apply_merge(self.sd, px, py, w, h, desc[1],
                                    cx, cy, cu_size, pu_idx)
        else:
            _, dir_, ref_idx, _, mvds, mvps = desc
            self.motion.apply_amvp(self.sd, px, py, w, h, dir_,
                                   list(ref_idx), list(mvds), list(mvps),
                                   cx, cy, cu_size, pu_idx, part_size)

    def _write_ref_idx(self, l, r):
        enc, bank = self.enc, self.bank
        nref = self.sh.num_ref_idx[l]
        if nref <= 1:
            return
        enc.encode_bin(bank["ref_idx"], 0, 1 if r > 0 else 0)
        if r > 0:
            nrem = nref - 2
            for i in range(r - 1):
                if i == 0:
                    enc.encode_bin(bank["ref_idx"], 1, 1)
                else:
                    enc.encode_bypass(1)
            if r - 1 < nrem:
                if r - 1 == 0:
                    enc.encode_bin(bank["ref_idx"], 1, 0)
                else:
                    enc.encode_bypass(0)

    def _write_pu_syntax(self, desc, cu_size=None, part_size=None):
        enc, bank = self.enc, self.bank
        if desc[0] == "merge":
            enc.encode_bin(bank["merge_flag"], 0, 1)
            self._write_merge_idx(desc[1])
            return
        _, dir_, ref_idx, _, mvds, mvps = desc
        enc.encode_bin(bank["merge_flag"], 0, 0)
        if self.slice_type == 0:
            # inter_pred_idc (mirror of _parse_inter_dir)
            if part_size == SIZE_2Nx2N or cu_size != 8:
                enc.encode_bin(bank["inter_dir"], self._cur_depth,
                               1 if dir_ == 3 else 0)
            if dir_ != 3:
                enc.encode_bin(bank["inter_dir"], 4, dir_ - 1)
        for l in range(2):
            use = (dir_ == 3) or (dir_ == l + 1)
            if not use or self.sh.num_ref_idx[l] == 0:
                continue
            self._write_ref_idx(l, ref_idx[l])
            if not (l == 1 and dir_ == 3 and
                    getattr(self.sh, "mvd_l1_zero", 0)):
                # mvd_l1_zero_flag: bi PUs code no L1 MVD (Rec. 7.3.8.6;
                # decode side slicedec.py:682)
                self._write_mvd(mvds[l])
            enc.encode_bin(bank["mvp_idx"], 0, mvps[l])

    def _motion_search_rect(self, px, py, w, h, pred_mv, l=0, r=0,
                            target=None):
        """TZ integer search + two-stage Hadamard fractional refine for
        one (list, ref).  target overrides the source block (the bi-pred
        template 2*orig - predOther).  FastSearch=0 (full search) falls
        back to an exhaustive scan like reference xPatternSearch.
        Returns (mv, pure SATD distortion at mv)."""
        cfg = self.cfg
        orig = target if target is not None else \
            self.orig[0][py:py + h, px:px + w].astype(np.int32)
        plane = self._search_plane(l, r)
        H, W = plane.shape
        R = cfg.search_range
        lib = self._enc_native()
        if lib is not None:
            # native TZ + HAD frac (encsearch.cpp), exact mirror of the
            # Python fallback below.  WP searches run on a pre-weighted
            # reference plane (see _search_plane) — interpolation is linear
            # and the 8-tap kernels sum to 64, so the affine map passes
            # through the fractional stages unchanged up to rounding.
            search, dt = self._native_search(lib, "enc_me_search")
            padded = self._padded(plane, R, dt)
            blk = np.ascontiguousarray(orig, dt)
            out = np.zeros(3, np.int64)
            search(
                padded.ctypes.data, padded.shape[1],
                padded.shape[0], R + 8, blk.ctypes.data,
                px, py, w, h, R, int(pred_mv[0]), int(pred_mv[1]),
                float(self._lam_motion), cfg.bit_depth,
                1 if getattr(cfg, "fast_search", 1) else 0,
                self._me_subshift(h), out.ctypes.data)
            return (int(out[0]), int(out[1])), int(out[2])
        pred_int = ((pred_mv[0] + 2) >> 2, (pred_mv[1] + 2) >> 2)
        if getattr(cfg, "fast_search", 1):
            imv, _ = self._tz_integer(orig, plane, px, py, w, h,
                                      pred_int, R, pred_mv)
        else:
            # full search (reference xPatternSearch, TEncSearch.cpp:4109)
            lam_m = self._lam_motion
            dsh = cfg.bit_depth - 8
            best, imv = float("inf"), (0, 0)
            sub = self._me_subshift(h)
            stp = 1 << sub
            for dy in range(-R, R + 1):
                ys0 = np.clip(np.arange(py + dy, py + dy + h, stp), 0, H - 1)
                for dx in range(-R, R + 1):
                    xs0 = np.clip(np.arange(px + dx, px + dx + w), 0, W - 1)
                    c = ((int(np.abs(plane[np.ix_(ys0, xs0)]
                                     - orig[::stp]).sum()) << sub)
                         >> dsh) + lam_m * self._mv_bits(
                             (dx << 2) - pred_mv[0], (dy << 2) - pred_mv[1])
                    if c < best:
                        best, imv = c, (dx, dy)
        bmv = (imv[0] << 2, imv[1] << 2)
        return self._frac_refine(bmv, px, py, w, h, orig, pred_mv, l, r)

    def encode_cu_inter(self, x, y, log2size, depth):
        """Inter-slice CU: partition (2Nx2N / 2NxN / Nx2N) + per-PU
        merge/skip/AMVP + intra fallback, then residual coding.

        Mirrors the decode-side syntax exactly (slicedec.parse_cu /
        _parse_pu / _parse_tt_root); motion candidates come from the SAME
        MotionDeriver the decoder uses, so the streams round-trip.
        """
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        self._cur_depth = depth
        pic.set_rect(pic.depth, x, y, size, size, depth)
        self._mark_edges(x, y, size)
        orig = self.orig[0][y:y + size, x:x + size].astype(np.int32)
        lam = self._lam_motion

        # ---- partition trials (PU1 candidates depend on PU0's motion, so
        # each trial applies motion to the maps and restores afterwards)
        parts = [SIZE_2Nx2N]
        if log2size >= 4:
            parts += [SIZE_2NxN, SIZE_Nx2N]
            if cfg.amp and log2size > sps.log2_min_cb:
                parts += [SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N, SIZE_nRx2N]
        best_part = None
        merge_2nx2n_all = []
        me_2nx2n = []
        part_trials = []
        pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTER)
        pic.set_rect(pic.skip, x, y, size, size, 0)
        for part in parts:
            pic.set_rect(pic.part_size, x, y, size, size, part)
            snap = self._snapshot_motion(x, y, size)
            descs, total = [], lam * (1 if part == SIZE_2Nx2N else 2)
            self._pu_last_mode = 0
            for pu_idx, (dx, dy, w, h) in enumerate(pu_partitions(part, size)):
                cost, desc = self._best_pu_motion(x + dx, y + dy, w, h,
                                                  x, y, size, pu_idx, part,
                                                  lam)
                total += cost
                descs.append(desc)
                self._apply_pu(desc, x + dx, y + dy, w, h, x, y, size,
                               pu_idx, part)
            if part == SIZE_2Nx2N:
                merge_2nx2n_all = self._pu_merge_cands
                me_2nx2n = list(getattr(self, "_pu_me_all", []))
            self._restore_motion(x, y, size, snap)
            part_trials.append((total, part, descs))
            if best_part is None or total < best_part[0]:
                best_part = (total, part, descs)

        # ---- intra candidate (SATD preselect; full-RD arbitrated below)
        all_preds = self._intra_all_preds(0, x, y, size)
        costs = np.abs(all_preds - orig[None]).sum(axis=(1, 2))
        best_mode = int(np.argmin(costs))
        best_icost = satd(all_preds[best_mode], orig) >> (cfg.bit_depth - 8)

        def emit_intra():
            pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)
            self._write_bypass_flag(x, y, size)
            enc.encode_bin(bank["skip"], self._skip_ctx(x, y), 0)
            pic.set_rect(pic.skip, x, y, size, size, 0)
            enc.encode_bin(bank["pred_mode"], 0, 1)
            self.encode_cu(x, y, log2size, depth, _from_inter=True)

        def apply_and_preds(part, cur_descs):
            """Write maps + PU edge flags, return per-comp predictions."""
            pus = pu_partitions(part, size)
            for pu_idx, (dx, dy, w, h) in enumerate(pus):
                self._apply_pu(cur_descs[pu_idx], x + dx, y + dy, w, h,
                               x, y, size, pu_idx, part)
                ef = pic.edge_flags
                ef[(y + dy) >> 2:(y + dy + h) >> 2,
                   (x + dx) >> 2] |= EDGE_PU_LEFT
                ef[(y + dy) >> 2,
                   (x + dx) >> 2:(x + dx + w) >> 2] |= EDGE_PU_TOP
            out = []
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                buf = np.zeros((size >> ssy, size >> ssx), np.int32)
                for pu_idx, (dx, dy, w, h) in enumerate(pus):
                    desc = cur_descs[pu_idx]
                    if desc[0] == "merge":
                        cand, dir_ = desc[2], desc[3]
                        mvs, ridx = cand.mv, cand.ref_idx
                    else:
                        _, dir_, ridx, mvs, _, _ = desc
                    buf[dy >> ssy:(dy + h) >> ssy,
                        dx >> ssx:(dx + w) >> ssx] = self._pred_from_cand(
                            comp, x + dx, y + dy, w, h, dir_, mvs, ridx)
                out.append(buf)
            return out

        def emit_inter(part, cur_descs):
            pic.set_rect(pic.part_size, x, y, size, size, part)
            preds = apply_and_preds(part, cur_descs)
            if part == SIZE_2Nx2N:
                self._inter_2nx2n_rd(x, y, log2size, cur_descs[0], preds)
            elif sps.max_tr_hierarchy_inter > 0:
                self._encode_inter_res_part_tree(x, y, log2size, cur_descs,
                                                 part, preds)
            else:
                self._encode_inter_res_split(x, y, log2size, cur_descs,
                                             part, preds)

        if not isinstance(enc, _RecordingCabac):
            # single-pass emission: SATD decides (no trial machinery)
            if best_icost + lam * 24 < best_part[0]:
                emit_intra()
            else:
                emit_inter(best_part[1], best_part[2])
            return

        # ---- full-RD CU-mode arbitration (reference TEncCu::xCompressCU:
        # every candidate — merge/skip, each inter partition, intra — is
        # coded for real and compared by SSE + lambda*bits.  SATD alone
        # ranks backwards on transform-cheap residuals, e.g. the constant
        # DC offset a zero MV leaves on a translating gradient.)  SATD
        # preselects: top-2 partitions + 2Nx2N ME + best 2Nx2N merge +
        # gated intra.
        cands = []  # (emit_callable, dedup_key)
        nfull = int(os.environ.get("HEVC_RD_PARTS", "0")) or len(part_trials)
        ranked = sorted(part_trials, key=lambda t: t[0])[:nfull]
        have = set()
        for _, part, descs in ranked:
            cands.append((lambda p=part, d=descs: emit_inter(p, d), part))
            have.add(part)
        if SIZE_2Nx2N not in have:
            t2n = next(t for t in part_trials if t[1] == SIZE_2Nx2N)
            cands.append((lambda d=t2n[2]: emit_inter(SIZE_2Nx2N, d),
                          SIZE_2Nx2N))
        # every (deduped) 2Nx2N merge candidate gets a full-RD trial, each
        # skip-vs-residual arbitrated inside _inter_2nx2n_rd (reference
        # TEncCu::xCheckRDCostMerge2Nx2N codes EVERY merge index both ways;
        # SATD preselection ranks transform-cheap residuals backwards)
        twon = next(t for t in part_trials if t[1] == SIZE_2Nx2N)
        for mdesc in merge_2nx2n_all:
            if twon[2][0][0] == "merge" and twon[2][0][1] == mdesc[1]:
                continue  # already covered by the 2Nx2N partition trial
            cands.append((lambda d=[mdesc]:
                          emit_inter(SIZE_2Nx2N, d), ("merge2n", mdesc[1])))
        # 2Nx2N uni-ME champions also get full-RD trials: bi-prediction's
        # averaging suppresses high-frequency content, so Hadamard
        # preselection over-picks bi on noisy sources; the coded cost of
        # the uni candidate frequently wins where SATD said otherwise
        # (top-temporal-layer B pictures especially)
        if os.environ.get("HEVC_RD_UNI", "1") != "0":
            t2d = twon[2][0]
            for mc, mdesc in me_2nx2n:
                if mdesc[1] == 3 or (t2d[0] == "amvp" and
                                     t2d[1] == mdesc[1]):
                    continue  # bi, or already the 2Nx2N trial itself
                cands.append((lambda d=[mdesc]:
                              emit_inter(SIZE_2Nx2N, d),
                              ("uni2n", mdesc[1])))
        # gate the (expensive) full intra RDO trial on SATD plausibility;
        # the generous margin keeps the transform-cheap cases (where inter
        # SATD is inflated by a DC offset) inside the trial set — measured
        # on the RA ladder, a tighter 1.25x margin costs ~0.6% BD-rate for
        # no meaningful encode-time win
        if best_icost < 2 * best_part[0] + lam * 48:
            cands.append((emit_intra, "intra"))
        best = None
        for emitfn, _key in cands:
            st = self._save_cu_state(x, y, size)
            mark = len(enc.ops)
            emitfn()
            cost = self._cu_rd_cost(x, y, size, mark)
            if best is None or cost < best[0]:
                best = (cost, emitfn)
            self._restore_cu_state(x, y, size, st)
        best[1]()

    def _emit_skip_cu(self, x, y, log2size, desc, preds):
        """Forced SKIP emission for a merge 2Nx2N CU: skip_flag=1 +
        merge_idx, reconstruction = prediction, no residual syntax."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        self._write_bypass_flag(x, y, size)
        enc.encode_bin(bank["skip"], self._skip_ctx(x, y), 1)
        pic.set_rect(pic.skip, x, y, size, size, 1)
        pic.set_rect(pic.cbf_y, x, y, size, size, 0)
        self._write_merge_idx(desc[1])
        bd = cfg.bit_depth
        for comp in range(self.ncomp):
            ssx = sps.chroma_shift_x() if comp else 0
            ssy = sps.chroma_shift_y() if comp else 0
            nx, ny = size >> ssx, size >> ssy
            self.recon[comp][y >> ssy:(y >> ssy) + ny,
                             x >> ssx:(x >> ssx) + nx] = np.clip(
                preds[comp], 0, (1 << bd) - 1)
        self._finish_cu_qp(x, y, size)

    def _inter_2nx2n_rd(self, x, y, log2size, desc, preds):
        """Merge 2Nx2N CUs: RD-compare the forced SKIP against the
        coded-residual CU (reference TEncCu::xCheckRDCostMerge2Nx2N
        evaluates each merge candidate both with residual and as skip;
        quantize-to-zero alone misses the cases where coding the residual
        is RD-worse than eating the distortion)."""
        if desc[0] != "merge" or not isinstance(self.enc, _RecordingCabac):
            return self._encode_inter_res_2nx2n(x, y, log2size, desc, preds)
        size = 1 << log2size
        st = self._save_cu_state(x, y, size)
        mark = len(self.enc.ops)
        self._emit_skip_cu(x, y, log2size, desc, preds)
        cost_skip = self._cu_rd_cost(x, y, size, mark)
        self._restore_cu_state(x, y, size, st)
        self._encode_inter_res_2nx2n(x, y, log2size, desc, preds)
        cost_full = self._cu_rd_cost(x, y, size, mark)
        dbg = os.environ.get("HEVC_DBG_SKIPRD")
        if dbg:
            with open(dbg, "a") as f:
                f.write(f"{getattr(self, '_dbg_poc', -1)} {x} {y} {size} "
                        f"{cost_skip:.1f} {cost_full:.1f}\n")
        if cost_skip < cost_full:
            self._restore_cu_state(x, y, size, st)
            self._emit_skip_cu(x, y, log2size, desc, preds)

    # ------------------------------------------------------------------
    def _encode_inter_res_2nx2n(self, x, y, log2size, desc, preds):
        """2Nx2N: single TU (the skip path lives here too)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        use_merge = desc[0] == "merge"
        is422 = sps.chroma_format_idc == 2
        if log2size > sps.log2_max_tb:
            # 64x64 CU: root split forced; the tree search continues
            # below it (any chroma format)
            return self._encode_inter_res_2nx2n_tree(x, y, log2size,
                                                     desc, preds)
        if sps.max_tr_hierarchy_inter > 0 and \
                log2size - 1 >= sps.log2_min_tb:
            return self._encode_inter_res_2nx2n_tree(x, y, log2size,
                                                     desc, preds)
        resids, rec_resids, cbfs = [], [], []  # per comp, over square sub-TUs
        for comp in range(self.ncomp):
            ssx = sps.chroma_shift_x() if comp else 0
            ssy = sps.chroma_shift_y() if comp else 0
            n = size >> ssx
            n_sub = 2 if (comp and is422) else 1
            cxp, cyp = x >> ssx, y >> ssy
            bd = cfg.bit_depth
            levs, rec_levs, cbf_subs = [], [], []
            for s in range(n_sub):
                orig_c = self.orig[comp][cyp + s * n:cyp + (s + 1) * n,
                                         cxp:cxp + n].astype(np.int32)
                resi = orig_c - preds[comp][s * n:(s + 1) * n]
                lev, rec_r, cbf = self._tu_fwd(resi, False, comp, SCAN_DIAG,
                                               False)
                levs.append(lev)
                rec_levs.append(rec_r)
                cbf_subs.append(cbf)
            resids.append(levs)
            rec_resids.append(rec_levs)
            cbfs.append(cbf_subs)
        while len(cbfs) < 3:        # mono: chroma emission sites no-op
            resids.append([])
            rec_resids.append([])
            cbfs.append([])
        any_cbf = any(any(c) for c in cbfs)
        pic.set_rect(pic.cbf_y, x, y, size, size, cbfs[0][0])

        is_skip = use_merge and not any_cbf
        self._write_bypass_flag(x, y, size)
        enc.encode_bin(bank["skip"], self._skip_ctx(x, y), 1 if is_skip else 0)
        pic.set_rect(pic.skip, x, y, size, size, 1 if is_skip else 0)
        if is_skip:
            self._write_merge_idx(desc[1])
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                nx, ny = size >> ssx, size >> ssy
                self.recon[comp][y >> ssy:(y >> ssy) + ny,
                                 x >> ssx:(x >> ssx) + nx] = preds[comp]
            self._finish_cu_qp(x, y, size)
            return

        enc.encode_bin(bank["pred_mode"], 0, 0)
        enc.encode_bin(bank["part_size"], 0, 1)          # 2Nx2N
        self._write_pu_syntax(desc, size, SIZE_2Nx2N)
        if not use_merge:
            enc.encode_bin(bank["qt_root_cbf"], 0, 1 if any_cbf else 0)
        min_tu_i = self._tt_min_tu(log2size, False)
        if any_cbf:
            if sps.max_tr_hierarchy_inter > 0:
                self._maybe_write_subdiv(log2size, 0, min_tu=min_tu_i)
            for v in cbfs[1]:
                enc.encode_bin(bank["qt_cbf"], 5, v)
            for v in cbfs[2]:
                enc.encode_bin(bank["qt_cbf"], 5, v)
            if any(cbfs[1]) or any(cbfs[2]):
                enc.encode_bin(bank["qt_cbf"], 1, cbfs[0][0])
            self._maybe_write_dqp(True)
            for comp in range(self.ncomp):
                for s, lev in enumerate(resids[comp]):
                    if cbfs[comp][s]:
                        encode_residual(self.enc, bank, lev, comp, SCAN_DIAG,
                                        self.cfg.sign_hiding,
                                        ts=self._ts_of(lev))
        for comp in range(self.ncomp):
            ssx = sps.chroma_shift_x() if comp else 0
            ssy = sps.chroma_shift_y() if comp else 0
            n = size >> ssx
            cxp, cyp = x >> ssx, y >> ssy
            bd = cfg.bit_depth
            for s, lev in enumerate(resids[comp]):
                rec_resi = rec_resids[comp][s] if cbfs[comp][s] else 0
                self.recon[comp][cyp + s * n:cyp + (s + 1) * n,
                                 cxp:cxp + n] = np.clip(
                    preds[comp][s * n:(s + 1) * n] + rec_resi,
                    0, (1 << bd) - 1)
        self._finish_cu_qp(x, y, size)

    def _encode_inter_res_2nx2n_tree(self, x, y, log2size, desc, preds):
        """2Nx2N inter with an RD-searched transform tree (the skip
        decision rides on the tree's total cbf)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        use_merge = desc[0] == "merge"
        bd = cfg.bit_depth
        orig_l = self.orig[0][y:y + size, x:x + size].astype(np.int32)
        resi_l = orig_l - preds[0]
        min_tu = self._tt_min_tu(log2size, False)
        mark = len(enc.ops)
        tree = self._inter_tt_decide(x, y, log2size, 0, min_tu, resi_l,
                                     0, 0)
        enc.truncate(mark)          # luma-only trial syntax
        self._inter_tt_chroma(tree, preds, x, y)
        any_cbf = bool(self._inter_tt_any_luma(tree) or any(tree["cb"]) or
                       any(tree["cr"]))
        is_skip = use_merge and not any_cbf
        self._write_bypass_flag(x, y, size)
        enc.encode_bin(bank["skip"], self._skip_ctx(x, y),
                       1 if is_skip else 0)
        pic.set_rect(pic.skip, x, y, size, size, 1 if is_skip else 0)

        def pred_recon():
            pic.set_rect(pic.cbf_y, x, y, size, size, 0)
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                nx, ny = size >> ssx, size >> ssy
                self.recon[comp][y >> ssy:(y >> ssy) + ny,
                                 x >> ssx:(x >> ssx) + nx] = np.clip(
                    preds[comp], 0, (1 << bd) - 1)

        if is_skip:
            self._write_merge_idx(desc[1])
            pred_recon()
            self._finish_cu_qp(x, y, size)
            return
        enc.encode_bin(bank["pred_mode"], 0, 0)
        enc.encode_bin(bank["part_size"], 0, 1)          # 2Nx2N
        self._write_pu_syntax(desc, size, SIZE_2Nx2N)
        if not use_merge:
            enc.encode_bin(bank["qt_root_cbf"], 0, 1 if any_cbf else 0)
        if any_cbf:
            self._inter_tt_emit(tree, min_tu, (0, 0), (0, 0), 0, None,
                                preds, x, y)
        else:
            pred_recon()
        self._finish_cu_qp(x, y, size)

    # ------------------------------------------------------------------
    # Multi-level inter RQT (QuadtreeTUMaxDepthInter > 1; reference
    # TEncSearch::xEstimateInterResidualQT).  Same three phases as the
    # intra tree; the prediction is fixed so the decide phase is a pure
    # residual-partitioning search.  4:2:0 only.
    def _inter_tt_decide(self, x, y, l2, depth, min_tu, resi_l, ox, oy):
        """RD-choose the luma transform tree over one inter residual.
        Trial syntax (subdiv + cbf_luma + coeffs) is recorded for bit
        estimation and discarded by the caller; no picture state is
        touched."""
        sps, enc, bank = self.sps, self.enc, self.bank
        size = 1 << l2
        sub = resi_l[oy:oy + size, ox:ox + size]

        def leaf_try():
            lev, rec, cbf = self._tu_fwd(sub, False, 0, SCAN_DIAG, False)
            if self._subdiv_coded(l2, min_tu):
                enc.encode_bin(bank["trans_subdiv"], 5 - l2, 0)
            enc.encode_bin(bank["qt_cbf"], 1 if depth == 0 else 0, cbf)
            if cbf:
                encode_residual(enc, bank, lev, 0, SCAN_DIAG,
                                self.cfg.sign_hiding, ts=self._ts_of(lev))
            return {"split": False, "l2": l2, "x": x, "y": y,
                    "depth": depth, "lev": lev, "cbf": cbf, "rec": rec}

        def split_try():
            if self._subdiv_coded(l2, min_tu):
                enc.encode_bin(bank["trans_subdiv"], 5 - l2, 1)
            h = size >> 1
            kids = [self._inter_tt_decide(x + dx, y + dy, l2 - 1, depth + 1,
                                          min_tu, resi_l, ox + dx2, oy + dy2)
                    for (dx, dy), (dx2, dy2) in
                    zip(((0, 0), (h, 0), (0, h), (h, h)),
                        ((0, 0), (h, 0), (0, h), (h, h)))]
            return {"split": True, "l2": l2, "x": x, "y": y,
                    "depth": depth, "kids": kids}

        def tree_sse(node, o_x, o_y):
            if node["split"]:
                hh = 1 << (node["l2"] - 1)
                return sum(tree_sse(k, o_x + dx, o_y + dy)
                           for k, (dx, dy) in
                           zip(node["kids"],
                               ((0, 0), (hh, 0), (0, hh), (hh, hh))))
            n = 1 << node["l2"]
            r = resi_l[o_y:o_y + n, o_x:o_x + n]
            d = r - node["rec"] if node["cbf"] else r
            return float((d.astype(np.int64) ** 2).sum())

        if l2 > sps.log2_max_tb:
            return split_try()
        if not (l2 > min_tu and l2 > sps.log2_min_tb):
            return leaf_try()
        if os.environ.get("HEVC_TT_PROBE") == "split":
            return split_try()
        mark = len(enc.ops)
        leaf = leaf_try()
        norm = 1 << (2 * (self.cfg.bit_depth - 8))
        cost_leaf = tree_sse(leaf, ox, oy) / norm + \
            self.rd_lambda * self._est_ops_bits(mark)
        leaf_ops = list(enc.ops[mark:])
        enc.truncate(mark)
        split = split_try()
        cost_split = tree_sse(split, ox, oy) / norm + \
            self.rd_lambda * self._est_ops_bits(mark)
        if cost_leaf <= cost_split:
            enc.truncate(mark)
            enc.reinstate(leaf_ops)
            return leaf
        return split

    def _inter_tt_chroma(self, node, preds, cu_x, cu_y):
        """Chroma TUs on the decided inter luma tree (Rec. 7.3.8.8
        placement rules, as in the intra tree), any chroma format."""
        sps = self.sps
        idc = sps.chroma_format_idc
        l2 = node["l2"]
        if idc == 0:
            node["cb"] = node["cr"] = [0, 0]
            if node["split"]:
                for k in node["kids"]:
                    self._inter_tt_chroma(k, preds, cu_x, cu_y)
            return
        if node["split"] and (idc == 3 or l2 > 3):
            for k in node["kids"]:
                self._inter_tt_chroma(k, preds, cu_x, cu_y)
            for key in ("cb", "cr"):
                v = 1 if any(any(k[key]) for k in node["kids"]) else 0
                node[key] = [v, v]
            return
        x, y = node["x"], node["y"]
        ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
        cn = 1 << (l2 - ssx)
        n_sub = 2 if idc == 2 else 1
        cx = x >> ssx
        cy0 = y >> ssy
        px0 = (x - cu_x) >> ssx
        py0 = (y - cu_y) >> ssy
        ch = {}
        for comp in (1, 2):
            subs = []
            for s in range(n_sub):
                cy = cy0 + s * cn
                oc = self.orig[comp][cy:cy + cn, cx:cx + cn].astype(np.int32)
                pc = preds[comp][py0 + s * cn:py0 + (s + 1) * cn,
                                 px0:px0 + cn]
                clev, crec, ccbf = self._tu_fwd(oc - pc, False, comp,
                                                SCAN_DIAG, False)
                subs.append((clev, crec, ccbf, pc))
            ch[comp] = subs
        node["chroma"] = ch
        node["cb"] = [ch[1][0][2], ch[1][-1][2]]
        node["cr"] = [ch[2][0][2], ch[2][-1][2]]
        if node["split"]:
            for k in node["kids"]:
                k["cb"] = k["cr"] = [0, 0]

    def _inter_tt_any_luma(self, node):
        if node["split"]:
            return any(self._inter_tt_any_luma(k) for k in node["kids"])
        return bool(node["cbf"])

    def _inter_tt_emit(self, node, min_tu, parent_cb, parent_cr, blk_idx,
                       parent_chroma, preds, cu_x, cu_y):
        """Write one inter transform_tree node in decoder order and
        reconstruct as it goes."""
        enc, bank, sps, pic = self.enc, self.bank, self.sps, self.pic
        idc = sps.chroma_format_idc
        l2, depth = node["l2"], node["depth"]
        subdiv = node["split"]
        bd = self.cfg.bit_depth
        if self._subdiv_coded(l2, min_tu):
            enc.encode_bin(bank["trans_subdiv"], 5 - l2, 1 if subdiv else 0)
        cb, cr = list(parent_cb), list(parent_cr)
        if idc != 0 and (l2 > 2 or idc == 3):
            cb = node["cb"]
            cr = node["cr"]
            lowest = 0 if subdiv else 1
            if depth == 0 or parent_cb[0] or parent_cb[1]:
                self._write_cbf_chroma(l2, depth, (cb[0], cb[1], lowest))
            else:
                cb = [0, 0]
            if depth == 0 or parent_cr[0] or parent_cr[1]:
                self._write_cbf_chroma(l2, depth, (cr[0], cr[1], lowest))
            else:
                cr = [0, 0]
        if subdiv:
            held = node.get("chroma")
            for i, k in enumerate(node["kids"]):
                self._inter_tt_emit(k, min_tu, cb, cr, i, held,
                                    preds, cu_x, cu_y)
            if held:
                self._inter_tt_chroma_recon(node, held, bd)
            return
        x, y = node["x"], node["y"]
        size = 1 << l2
        cbf = node["cbf"]
        if depth > 0 or cb[0] or cb[1] or cr[0] or cr[1]:
            enc.encode_bin(bank["qt_cbf"], 1 if depth == 0 else 0, cbf)
        self._maybe_write_dqp(cbf or cb[0] or cb[1] or cr[0] or cr[1])
        if cbf:
            encode_residual(enc, bank, node["lev"], 0, SCAN_DIAG,
                            self.cfg.sign_hiding, ts=self._ts_of(node["lev"]))
        rec_r = node["rec"] if cbf else 0
        self.recon[0][y:y + size, x:x + size] = np.clip(
            preds[0][y - cu_y:y - cu_y + size,
                     x - cu_x:x - cu_x + size] + rec_r, 0, (1 << bd) - 1)
        pic.set_rect(pic.cbf_y, x, y, size, size, cbf)
        ef = pic.edge_flags
        ef[y >> 2:(y + size) >> 2, x >> 2] |= EDGE_TU_LEFT
        ef[y >> 2, x >> 2:(x + size) >> 2] |= EDGE_TU_TOP
        chroma_here = idc != 0 and (l2 - sps.chroma_shift_x()) >= 2
        ch = node.get("chroma") if chroma_here else \
            (parent_chroma if (idc != 0 and blk_idx == 3) else None)
        if ch:
            for comp in (1, 2):
                for clev, crec, ccbf, pc in ch[comp]:
                    if ccbf:
                        encode_residual(enc, bank, clev, comp, SCAN_DIAG,
                                        self.cfg.sign_hiding,
                                        ts=self._ts_of(clev))
            if chroma_here:
                self._inter_tt_chroma_recon(node, ch, bd)

    def _inter_tt_chroma_recon(self, node, ch, bd):
        sps = self.sps
        ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
        cn = 1 << (node["l2"] - ssx)
        cx = node["x"] >> ssx
        cy0 = node["y"] >> ssy
        for comp in (1, 2):
            for s, (clev, crec, ccbf, pc) in enumerate(ch[comp]):
                cy = cy0 + s * cn
                self.recon[comp][cy:cy + cn, cx:cx + cn] = np.clip(
                    pc + (crec if ccbf else 0), 0, (1 << bd) - 1)

    def _write_inter_part_size(self, part, log2size):
        """part_mode bins for an inter CU (mirror of the decoder's
        _parse_inter_part_size incl. the AMP refinement bins)."""
        enc, bank, sps = self.enc, self.bank, self.sps
        at_min = log2size == sps.log2_min_cb
        base = part
        amp_bin = None
        if part in (SIZE_2NxnU, SIZE_2NxnD):
            base = SIZE_2NxN
            amp_bin = (0, 0 if part == SIZE_2NxnU else 1)
        elif part in (SIZE_nLx2N, SIZE_nRx2N):
            base = SIZE_Nx2N
            amp_bin = (0, 0 if part == SIZE_nLx2N else 1)
        max_bits = 3 if (at_min and (1 << log2size) != 8) else 2
        for i in range(min(base, max_bits)):
            enc.encode_bin(bank["part_size"], i, 0)
        if base < max_bits:
            enc.encode_bin(bank["part_size"], base, 1)
        if sps.amp_enabled and not at_min and base in (SIZE_2NxN, SIZE_Nx2N):
            if amp_bin is None:
                enc.encode_bin(bank["part_size"], 3, 1)
            else:
                enc.encode_bin(bank["part_size"], 3, 0)
                enc.encode_bypass(amp_bin[1])

    def _encode_inter_res_part_tree(self, x, y, log2size, descs, part,
                                    preds):
        """Non-2Nx2N with transform hierarchy > 0: full RD-searched
        transform tree over the whole-CU residual, exactly like the
        2Nx2N path (inter TUs may span PU boundaries, Rec. 7.3.8.8; the
        reference searches the complete tree in
        TEncSearch::xEstimateInterResidualQT, TEncSearch.cpp:4612+ --
        a one-level forced split here cost ~4% BD-rate on RA)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        bd = cfg.bit_depth
        orig_l = self.orig[0][y:y + size, x:x + size].astype(np.int32)
        resi_l = orig_l - preds[0]
        min_tu = self._tt_min_tu(log2size, False)
        mark = len(enc.ops)
        tree = self._inter_tt_decide(x, y, log2size, 0, min_tu, resi_l,
                                     0, 0)
        enc.truncate(mark)          # luma-only trial syntax
        self._inter_tt_chroma(tree, preds, x, y)
        any_cbf = bool(self._inter_tt_any_luma(tree) or any(tree["cb"]) or
                       any(tree["cr"]))
        self._write_bypass_flag(x, y, size)
        enc.encode_bin(bank["skip"], self._skip_ctx(x, y), 0)
        pic.set_rect(pic.skip, x, y, size, size, 0)
        enc.encode_bin(bank["pred_mode"], 0, 0)
        self._write_inter_part_size(part, log2size)
        for desc in descs:
            self._write_pu_syntax(desc, size, part)
        # rqt_root_cbf always coded for non-2Nx2N (spec 7.3.8.5)
        enc.encode_bin(bank["qt_root_cbf"], 0, 1 if any_cbf else 0)
        if any_cbf:
            self._inter_tt_emit(tree, min_tu, (0, 0), (0, 0), 0, None,
                                preds, x, y)
        else:
            pic.set_rect(pic.cbf_y, x, y, size, size, 0)
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                nx, ny = size >> ssx, size >> ssy
                self.recon[comp][y >> ssy:(y >> ssy) + ny,
                                 x >> ssx:(x >> ssx) + nx] = np.clip(
                    preds[comp], 0, (1 << bd) - 1)
        self._finish_cu_qp(x, y, size)

    def _encode_inter_res_split(self, x, y, log2size, descs, part, preds):
        """Non-2Nx2N: forced TU quadtree (max_tr_hierarchy_inter == 0 --
        the root splits into four leaves, reference xDecodeTransform's
        interSplitFlag).  Requires CU size >= 16."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        half = size >> 1
        bd = cfg.bit_depth
        is422 = sps.chroma_format_idc == 2
        # per-child levels: [child][comp][sub] (4:2:2 chroma TUs split into
        # two square sub-TUs stacked vertically)
        child_lev = []
        child_rec = []
        child_cbf = []
        for ci, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                       (half, half))):
            levs, recs, cbfs = [], [], []
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                n = half >> ssx
                n_sub = 2 if (comp and is422) else 1
                ox = (x + dx) >> ssx
                oy = (y + dy) >> ssy
                sub_lev, sub_rec, sub_cbf = [], [], []
                for s in range(n_sub):
                    orig_c = self.orig[comp][oy + s * n:oy + (s + 1) * n,
                                             ox:ox + n].astype(np.int32)
                    pred_c = preds[comp][
                        (dy >> ssy) + s * n:(dy >> ssy) + (s + 1) * n,
                        dx >> ssx:(dx >> ssx) + n]
                    lev, rec_r, cbf = self._tu_fwd(
                        (orig_c - pred_c).astype(np.int32), False, comp,
                        SCAN_DIAG, False)
                    sub_lev.append(lev)
                    sub_rec.append(rec_r)
                    sub_cbf.append(cbf)
                levs.append(sub_lev)
                recs.append(sub_rec)
                cbfs.append(sub_cbf)
            while len(cbfs) < 3:    # mono: chroma emission sites no-op
                levs.append([])
                recs.append([])
                cbfs.append([])
            child_lev.append(levs)
            child_rec.append(recs)
            child_cbf.append(cbfs)
        root_cb = 1 if any(any(c[1]) for c in child_cbf) else 0
        root_cr = 1 if any(any(c[2]) for c in child_cbf) else 0
        any_cbf = root_cb or root_cr or any(c[0][0] for c in child_cbf)

        self._write_bypass_flag(x, y, size)
        enc.encode_bin(bank["skip"], self._skip_ctx(x, y), 0)
        pic.set_rect(pic.skip, x, y, size, size, 0)
        enc.encode_bin(bank["pred_mode"], 0, 0)
        self._write_inter_part_size(part, log2size)
        for desc in descs:
            self._write_pu_syntax(desc, size, part)
        # rqt_root_cbf always coded for non-2Nx2N (spec 7.3.8.5)
        enc.encode_bin(bank["qt_root_cbf"], 0, 1 if any_cbf else 0)
        if any_cbf:
            # root (tr_depth 0): with max_transform_hierarchy_depth_inter
            # == 0 the split is forced/inferred for non-2Nx2N parts; with
            # hierarchy > 0 the subdiv flag is coded.  The root chroma
            # block can still quad-split, so 4:2:2 codes ONE combined bin
            # here and two sub-TU bins at the leaves (_parse_cbf_chroma)
            min_tu_i = self._tt_min_tu(log2size, False)
            if sps.max_tr_hierarchy_inter > 0:
                self._maybe_write_subdiv(log2size, 1, min_tu=min_tu_i)
            if sps.chroma_format_idc:
                enc.encode_bin(bank["qt_cbf"], 5, root_cb)
                enc.encode_bin(bank["qt_cbf"], 5, root_cr)
            for ci, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                           (half, half))):
                cbfs = child_cbf[ci]
                if sps.max_tr_hierarchy_inter > 0 and \
                        log2size - 1 != sps.log2_min_tb and \
                        log2size - 1 != min_tu_i and \
                        log2size - 1 <= sps.log2_max_tb:
                    enc.encode_bin(bank["trans_subdiv"],
                                   5 - (log2size - 1), 0)
                if root_cb:
                    for v in cbfs[1]:
                        enc.encode_bin(bank["qt_cbf"], 6, v)
                if root_cr:
                    for v in cbfs[2]:
                        enc.encode_bin(bank["qt_cbf"], 6, v)
                enc.encode_bin(bank["qt_cbf"], 0, cbfs[0][0])  # tr_depth 1
                self._maybe_write_dqp(
                    cbfs[0][0] or (root_cb and any(cbfs[1])) or
                    (root_cr and any(cbfs[2])))
                for comp in range(self.ncomp):
                    if comp and not (root_cb if comp == 1 else root_cr):
                        continue
                    for s, lev in enumerate(child_lev[ci][comp]):
                        if cbfs[comp][s]:
                            encode_residual(self.enc, bank, lev, comp,
                                            SCAN_DIAG, self.cfg.sign_hiding,
                                            ts=self._ts_of(lev))
        # recon + cbf map + TU edge flags per child
        ef = pic.edge_flags
        for ci, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                       (half, half))):
            cx0, cy0 = x + dx, y + dy
            ef[cy0 >> 2:(cy0 + half) >> 2, cx0 >> 2] |= EDGE_TU_LEFT
            ef[cy0 >> 2, cx0 >> 2:(cx0 + half) >> 2] |= EDGE_TU_TOP
            pic.set_rect(pic.cbf_y, cx0, cy0, half, half, child_cbf[ci][0][0])
            for comp in range(self.ncomp):
                ssx = sps.chroma_shift_x() if comp else 0
                ssy = sps.chroma_shift_y() if comp else 0
                n = half >> ssx
                ox, oy = cx0 >> ssx, cy0 >> ssy
                for s, lev in enumerate(child_lev[ci][comp]):
                    cbf_ok = child_cbf[ci][comp][s] and \
                        (comp == 0 or (root_cb if comp == 1 else root_cr))
                    pred_c = preds[comp][
                        (dy >> ssy) + s * n:(dy >> ssy) + (s + 1) * n,
                        dx >> ssx:(dx >> ssx) + n]
                    rec_resi = child_rec[ci][comp][s] if cbf_ok else 0
                    self.recon[comp][oy + s * n:oy + (s + 1) * n,
                                     ox:ox + n] = np.clip(
                        pred_c + rec_resi, 0, (1 << bd) - 1)
        self._finish_cu_qp(x, y, size)

    def encode_cqt(self, x, y, log2size, depth):
        sps, pic, enc, bank = self.sps, self.pic, self.enc, self.bank
        size = 1 << log2size
        inside = (x + size <= sps.width) and (y + size <= sps.height)
        target_log2 = max(sps.log2_min_cb,
                          min(log2size,
                              (self.cfg.cu_size).bit_length() - 1))
        want_split = log2size > target_log2

        def split_ctx():
            ctx = 0
            if self.sd.available(x - 1, y, x, y, False) and \
                    pic.depth[y >> 2, (x - 1) >> 2] > depth:
                ctx += 1
            if self.sd.available(x, y - 1, x, y, False) and \
                    pic.depth[(y - 1) >> 2, x >> 2] > depth:
                ctx += 1
            return ctx

        def encode_leaf():
            if self.slice_type in (0, 1):
                self.encode_cu_inter(x, y, log2size, depth)
            else:
                self.encode_cu(x, y, log2size, depth)

        def encode_split():
            h2 = size >> 1
            for (dx, dy) in ((0, 0), (h2, 0), (0, h2), (h2, h2)):
                nx, ny = x + dx, y + dy
                if nx < sps.width and ny < sps.height:
                    self.encode_cqt(nx, ny, log2size - 1, depth + 1)

        # RDO quadtree (reference TEncCu::xCompressCU): trial-encode the
        # leaf and the split, keep the cheaper Lagrangian
        if inside and not want_split and log2size > sps.log2_min_cb and \
                self.cfg.rdo_cu and isinstance(self.enc, _RecordingCabac):
            st = self._save_cu_state(x, y, size)
            enc.encode_bin(bank["split_cu"], split_ctx(), 0)
            encode_leaf()
            cost_leaf = self._cu_rd_cost(x, y, size, st[3])
            leaf_state = self._save_cu_state(x, y, size)
            leaf_ops = self.enc.ops[st[3]:]
            leaf_products = pic.inter_list[st[4]:]
            self._restore_cu_state(x, y, size, st)
            enc.encode_bin(bank["split_cu"], split_ctx(), 1)
            encode_split()
            cost_split = self._cu_rd_cost(x, y, size, st[3])
            if cost_leaf <= cost_split:
                # reinstate the recorded leaf trial instead of re-encoding
                self._restore_cu_state(x, y, size, st)
                self.enc.reinstate(leaf_ops)
                pic.inter_list.extend(leaf_products)
                (self._last_qp_enc, self._qp_pred_enc, self._dqp_coded,
                 self._cu_delta_enc) = leaf_state[5]
                sl, maps, recs = leaf_state[0], leaf_state[1], leaf_state[2]
                for m, v in maps.items():
                    getattr(pic, m)[sl] = v
                for c in range(len(recs)):
                    ssx = sps.chroma_shift_x() if c else 0
                    ssy = sps.chroma_shift_y() if c else 0
                    self.recon[c][y >> ssy:(y + size) >> ssy,
                                  x >> ssx:(x + size) >> ssx] = recs[c]
            return
        if inside and log2size > sps.log2_min_cb:
            enc.encode_bin(bank["split_cu"], split_ctx(),
                           1 if want_split else 0)
            split = want_split
        else:
            split = log2size > sps.log2_min_cb  # forced at boundary
        if split:
            h = size >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                nx, ny = x + dx, y + dy
                if nx < sps.width and ny < sps.height:
                    self.encode_cqt(nx, ny, log2size - 1, depth + 1)
            return
        if self.slice_type in (0, 1):
            self.encode_cu_inter(x, y, log2size, depth)
        else:
            self.encode_cu(x, y, log2size, depth)

    # ------------------------------------------------------------------
    def _intra_pred(self, comp, x, y, n, mode):
        sps = self.sps
        bd = sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma
        plane = self.recon[comp]
        sd, pic = self.sd, self.pic
        ssx = sps.chroma_shift_x() if comp else 0
        ssy = sps.chroma_shift_y() if comp else 0
        W = sps.width >> ssx
        H = sps.height >> ssy
        lx_anchor, ly_anchor = x << ssx, y << ssy
        z_cur = sd._zmap[ly_anchor >> 2, lx_anchor >> 2]
        slice_cur = pic.slice_idx[ly_anchor >> 2, lx_anchor >> 2]
        log2_ctb, wctbs = sps.log2_ctb, sps.pic_width_ctbs
        tile_cur = sd.tile_map[(ly_anchor >> log2_ctb) * wctbs +
                               (lx_anchor >> log2_ctb)]

        def avail(cx, cy):
            if cx < 0 or cy < 0 or cx >= W or cy >= H:
                return False
            lx, ly = cx << ssx, cy << ssy
            if sd._zmap[ly >> 2, lx >> 2] >= z_cur:
                return False
            if pic.slice_idx[ly >> 2, lx >> 2] != slice_cur:
                return False
            return sd.tile_map[(ly >> log2_ctb) * wctbs +
                               (lx >> log2_ctb)] == tile_cur
        top, left = refimpl.fill_reference_samples(plane, avail, x, y, n, bd)
        if refimpl.use_filtered_refs(comp, n, mode, sps):
            strong = bool(sps.strong_intra_smoothing) and comp == 0
            top, left = refimpl.filter_reference_samples(top, left, n, mode,
                                                         bd, strong)
        return refimpl.predict_intra(top, left, n, mode, comp, bd, sps)

    def _intra_all_preds(self, comp, x, y, n):
        """[35, n, n] predictions for the SATD mode search: one reference
        fill + one vectorized all-modes predict (encoder/intra_search)."""
        sps = self.sps
        bd = sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma
        plane = self.recon[comp]
        sd, pic = self.sd, self.pic
        ssx = sps.chroma_shift_x() if comp else 0
        ssy = sps.chroma_shift_y() if comp else 0
        W = sps.width >> ssx
        H = sps.height >> ssy
        lx_anchor, ly_anchor = x << ssx, y << ssy
        z_cur = sd._zmap[ly_anchor >> 2, lx_anchor >> 2]
        slice_cur = pic.slice_idx[ly_anchor >> 2, lx_anchor >> 2]
        log2_ctb, wctbs = sps.log2_ctb, sps.pic_width_ctbs
        tile_cur = sd.tile_map[(ly_anchor >> log2_ctb) * wctbs +
                               (lx_anchor >> log2_ctb)]

        def avail(cx, cy):
            if cx < 0 or cy < 0 or cx >= W or cy >= H:
                return False
            lx, ly = cx << ssx, cy << ssy
            if sd._zmap[ly >> 2, lx >> 2] >= z_cur:
                return False
            if pic.slice_idx[ly >> 2, lx >> 2] != slice_cur:
                return False
            return sd.tile_map[(ly >> log2_ctb) * wctbs +
                               (lx >> log2_ctb)] == tile_cur
        top_u, left_u = refimpl.fill_reference_samples(plane, avail, x, y,
                                                       n, bd)
        top_f = left_f = None
        if not sps.intra_smoothing_disabled and \
                (comp == 0 or sps.chroma_format_idc == 3) and n > 4:
            strong = bool(sps.strong_intra_smoothing) and comp == 0
            top_f, left_f = refimpl.filter_reference_samples(
                top_u, left_u, n, 2, bd, strong)
        from .intra_search import predict_all_modes
        return predict_all_modes(top_u, left_u, top_f, left_f, n, comp, bd,
                                 sps)

    def _mark_edges(self, x, y, size):
        ef = self.pic.edge_flags
        ef[y >> 2:(y + size) >> 2, x >> 2] |= \
            EDGE_CU_LEFT | EDGE_PU_LEFT | EDGE_TU_LEFT
        ef[y >> 2, x >> 2:(x + size) >> 2] |= \
            EDGE_CU_TOP | EDGE_PU_TOP | EDGE_TU_TOP

    def encode_cu(self, x, y, log2size, depth, _from_inter=False):
        sps, pic = self.sps, self.pic
        size = 1 << log2size
        if not _from_inter:
            self._write_bypass_flag(x, y, size)
        if self._pcm_eligible(log2size) and \
                isinstance(self.enc, _RecordingCabac):
            # IPCM decision (reference TEncSearch::IPCMSearch,
            # TEncSearch.cpp:2913): code the CU normally, and when the
            # estimated bits exceed the raw sample cost re-emit as PCM
            st = self._save_cu_state(x, y, size)
            self._encode_cu_intra_body(x, y, log2size, depth)
            bits = self._est_ops_bits(st[3])
            if bits > self._pcm_raw_bits(size):
                self._restore_cu_state(x, y, size, st)
                self._encode_cu_pcm(x, y, log2size, depth)
            return
        self._encode_cu_intra_body(x, y, log2size, depth)

    def _pcm_eligible(self, log2size):
        cfg = self.cfg
        return getattr(cfg, "pcm_enabled", False) and \
            not getattr(cfg, "lossless", False) and \
            getattr(cfg, "log2_min_ipcm", 3) <= log2size <= \
            getattr(cfg, "log2_max_ipcm", 5)

    def _pcm_raw_bits(self, size):
        sps = self.sps
        bits = size * size * self.cfg.bit_depth
        if sps.chroma_format_idc:
            sx, sy = sps.chroma_shift_x(), sps.chroma_shift_y()
            bits += 2 * (size >> sx) * (size >> sy) * self.cfg.bit_depth
        return bits + 8

    def _encode_cu_pcm(self, x, y, log2size, depth):
        """pcm_flag = 1: raw samples, reconstruction = source (PCM bit
        depth == internal bit depth here)."""
        sps, pic, enc, bank = self.sps, self.pic, self.enc, self.bank
        size = 1 << log2size
        pic.set_rect(pic.depth, x, y, size, size, depth)
        pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTRA)
        pic.set_rect(pic.skip, x, y, size, size, 0)
        pic.set_rect(pic.pcm, x, y, size, size, 1)
        pic.set_rect(pic.intra_y, x, y, size, size, 1)   # DC
        pic.set_rect(pic.intra_c, x, y, size, size, 1)
        pic.set_rect(pic.cbf_y, x, y, size, size, 0)
        pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)
        self._mark_edges(x, y, size)
        if log2size == sps.log2_min_cb:
            enc.encode_bin(bank["part_size"], 0, 1)  # 2Nx2N
        enc.encode_terminate(1)                      # pcm_flag
        bd = self.cfg.bit_depth
        bits = []
        for c in range(3 if sps.chroma_format_idc else 1):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            blk = self.orig[c][y >> sy:(y + size) >> sy,
                               x >> sx:(x + size) >> sx]
            for v in blk.ravel():
                bits.append((int(v), bd))
            self.recon[c][y >> sy:(y + size) >> sy,
                          x >> sx:(x + size) >> sx] = blk
        enc.pcm_payload(bits)
        self._finish_cu_qp(x, y, size)

    def _encode_cu_intra_body(self, x, y, log2size, depth):
        sps, pic = self.sps, self.pic
        size = 1 << log2size
        pic.set_rect(pic.depth, x, y, size, size, depth)
        pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTRA)
        pic.set_rect(pic.skip, x, y, size, size, 0)
        self._mark_edges(x, y, size)
        # NxN trial at the minimum CB size (reference TEncCu checks
        # SIZE_NxN only at the final depth); 4:4:4 NxN (per-PU chroma)
        # not implemented yet
        if log2size == sps.log2_min_cb and self.cfg.rdo_cu and \
                sps.chroma_format_idc != 3 and \
                isinstance(self.enc, _RecordingCabac):
            force = os.environ.get("HEVC_FORCE_PART")   # debug A/B knob
            if force == "nxn":
                self._encode_cu_intra_nxn(x, y, log2size)
                return
            if force == "2nx2n":
                self._encode_cu_intra_2nx2n(x, y, log2size)
                return
            st = self._save_cu_state(x, y, size)
            self._encode_cu_intra_2nx2n(x, y, log2size)
            cost_2n = self._cu_rd_cost(x, y, size, st[3])
            self._restore_cu_state(x, y, size, st)
            self._encode_cu_intra_nxn(x, y, log2size)
            cost_nn = self._cu_rd_cost(x, y, size, st[3])
            if cost_2n <= cost_nn:
                self._restore_cu_state(x, y, size, st)
                self._encode_cu_intra_2nx2n(x, y, log2size)
            return
        self._encode_cu_intra_2nx2n(x, y, log2size)

    def _encode_cu_intra_nxn(self, x, y, log2size):
        """Intra NxN at the minimum CB: four luma PUs with their own modes,
        sequentially reconstructed (each predicts from the previous PU's
        recon), DM chroma from PU0, forced 4-leaf transform tree
        (reference TEncSearch xRecurIntraCodingLumaQT with IntraSplit)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        half = size >> 1
        bd = cfg.bit_depth
        is422 = sps.chroma_format_idc == 2
        lam_pred = self.rd_lambda ** 0.5
        pu_pos = [(x, y), (x + half, y), (x, y + half), (x + half, y + half)]
        pic.set_rect(pic.part_size, x, y, size, size, SIZE_NxN)
        enc.encode_bin(bank["part_size"], 0, 0)   # NxN

        def pick_scan(n, mode, sx, sy):
            if n <= (8 >> sx) and n <= (8 >> sy):
                if abs(mode - 26) <= 4:
                    return SCAN_HOR
                if abs(mode - 10) <= 4:
                    return SCAN_VER
            return SCAN_DIAG

        modes, mpms, lum = [], [], []
        for (px, py) in pu_pos:
            orig = self.orig[0][py:py + half, px:px + half]
            preds_mpm = self.sd._intra_mpm(px, py)
            all_preds = self._intra_all_preds(0, px, py, half)
            mode = self._select_intra_luma_mode(px, py, half, preds_mpm,
                                                all_preds)
            pic.set_rect(pic.intra_y, px, py, half, half, mode)
            # reconstruct this PU now: the next PU predicts from it
            pred = self._intra_pred(0, px, py, half, mode)
            resi = (orig - pred).astype(np.int32)
            use_dst = half == 4
            scan = pick_scan(half, mode, 0, 0)
            lev, rec, cbf = self._tu_fwd(resi, use_dst, 0, scan, True)
            self.recon[0][py:py + half, px:px + half] = np.clip(
                pred + rec, 0, (1 << bd) - 1)
            pic.set_rect(pic.cbf_y, px, py, half, half, cbf)
            ef = pic.edge_flags
            ef[py >> 2:(py + half) >> 2, px >> 2] |= EDGE_TU_LEFT
            ef[py >> 2, px >> 2:(px + half) >> 2] |= EDGE_TU_TOP
            modes.append(mode)
            mpms.append(preds_mpm)
            lum.append((lev, cbf, scan))

        # intra pred info: all four MPM flags, then the four payloads,
        # then one chroma direction (DM) — Rec. 7.3.8.5 order
        for j in range(4):
            enc.encode_bin(bank["intra_luma_mpm"], 0,
                           1 if modes[j] in mpms[j] else 0)
        for j in range(4):
            mode, preds = modes[j], mpms[j]
            if mode in preds:
                idx = preds.index(mode)
                if idx == 0:
                    enc.encode_bypass(0)
                else:
                    enc.encode_bypass(1)
                    enc.encode_bypass(idx - 1)
            else:
                rem = mode
                for pm in sorted(preds, reverse=True):
                    if rem > pm:
                        rem -= 1
                enc.encode_bypass_bins(rem, 5)
        has_chroma = sps.chroma_format_idc != 0
        if has_chroma:
            c_real, c_dm, c_idx = self._select_chroma_intra_mode(
                x, y, size, modes[0])
            self._write_chroma_mode(x, y, size, modes[0], c_real, c_dm,
                                    c_idx)

        # chroma transform + recon (single TU at the 8x8 parent; 4:2:2
        # splits into two square sub-TUs with the DM angle remapped)
        c_levs = {1: [], 2: []}
        c_cbfs = {1: [], 2: []}
        c_scan = SCAN_DIAG
        if has_chroma:
            ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
            n = size >> ssx
            n_sub = 2 if is422 else 1
            cmode = CHROMA422_ANGLE_MAP[c_real] if is422 else c_real
            c_scan = pick_scan(n, cmode, ssx, ssy)
            cx, cy0 = x >> ssx, y >> ssy
            for comp in (1, 2):
                for s in range(n_sub):
                    cy = cy0 + s * n
                    pred = self._intra_pred(comp, cx, cy, n, cmode)
                    orig_c = self.orig[comp][cy:cy + n, cx:cx + n]
                    resi = (orig_c - pred).astype(np.int32)
                    lev, rec, cbf = self._tu_fwd(resi, False, comp, c_scan,
                                                 True)
                    self.recon[comp][cy:cy + n, cx:cx + n] = np.clip(
                        pred + rec, 0, (1 << bd) - 1)
                    c_levs[comp].append(lev)
                    c_cbfs[comp].append(cbf)

        # transform tree: root chroma cbfs (one bin each for 4:2:0; two for
        # 4:2:2 since the chroma block cannot quad-split), then per leaf:
        # cbf_luma (tr_depth 1 -> ctx 0) + luma residual; the 4th leaf
        # carries the chroma residuals (_emit_tu chroma_last)
        if has_chroma:
            for comp in (1, 2):
                for v in c_cbfs[comp]:
                    enc.encode_bin(bank["qt_cbf"], 5 + 0, v)
        for j in range(4):
            lev, cbf, scan = lum[j]
            enc.encode_bin(bank["qt_cbf"], 0, cbf)
            self._maybe_write_dqp(cbf or any(c_cbfs[1]) or any(c_cbfs[2]))
            if cbf:
                encode_residual(enc, bank, lev, 0, scan,
                                self.cfg.sign_hiding, ts=self._ts_of(lev))
            if j == 3 and has_chroma:
                for comp in (1, 2):
                    for s, clev in enumerate(c_levs[comp]):
                        if c_cbfs[comp][s]:
                            encode_residual(enc, bank, clev, comp, c_scan,
                                            self.cfg.sign_hiding,
                                            ts=self._ts_of(clev))
        self._finish_cu_qp(x, y, size)

    def _intra_rqt_eligible(self, log2size):
        """RD-search the TU split tree below the CU (QuadtreeTUMaxDepthIntra
        > 1; reference xRecurIntraCodingQT), any chroma format."""
        sps = self.sps
        return (sps.max_tr_hierarchy_intra > 0 and
                log2size - 1 >= sps.log2_min_tb and
                log2size <= sps.log2_max_tb)

    def _intra_min_tu_log2(self, log2size, intra_split=0):
        return self._tt_min_tu(log2size, True, intra_split)

    def _tt_min_tu(self, log2size, is_intra, extra_split=0):
        """minTuLog2 of the transform tree (decode-side
        _parse_transform_tree_root arithmetic)."""
        sps = self.sps
        hier = sps.max_tr_hierarchy_intra if is_intra else \
            sps.max_tr_hierarchy_inter
        max_tr_depth = 1 + hier
        lo = sps.log2_min_tb + max_tr_depth - 1 + extra_split
        if log2size < lo:
            return sps.log2_min_tb
        return min(log2size - (max_tr_depth - 1 + extra_split),
                   sps.log2_max_tb)

    def _maybe_write_subdiv(self, log2size, value, min_tu=None):
        """split_transform_flag when it is coded (not inferred), mirroring
        the decode-side _tt conditions for a 2Nx2N root/child."""
        sps = self.sps
        if min_tu is None:
            min_tu = self._intra_min_tu_log2(self.cu_log2_for_tt)
        if log2size > sps.log2_max_tb:
            return  # inferred 1
        if log2size == sps.log2_min_tb or log2size == min_tu:
            return  # inferred 0
        self.enc.encode_bin(self.bank["trans_subdiv"], 5 - log2size, value)

    def _encode_cu_intra_2nx2n(self, x, y, log2size, _forced=None):
        if log2size > self.sps.log2_max_tb:
            # CU larger than the maximum TB (64x64 CUs): the transform
            # tree split is forced/inferred (no subdiv bin).  In RD mode
            # the general RQT path handles the forced root split (and
            # searches the tree below the 32x32 children); the manual
            # single-level emitter stays as the fast non-RD path.
            if isinstance(self.enc, _RecordingCabac):
                return self._encode_cu_intra_2nx2n_rqt(x, y, log2size)
            return self._encode_cu_intra_rqt_split(x, y, log2size)
        if _forced is None and self._intra_rqt_eligible(log2size) and \
                isinstance(self.enc, _RecordingCabac):
            return self._encode_cu_intra_2nx2n_rqt(x, y, log2size)
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, self.bank
        size = 1 << log2size
        pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)

        # --- luma mode decision: Hadamard preselection + full-RD over the
        # candidate list (reference TEncSearch::estIntraPredQT) ---
        preds_mpm = self.sd._intra_mpm(x, y)
        all_preds = self._intra_all_preds(0, x, y, size)
        mode = self._select_intra_luma_mode(x, y, size, preds_mpm, all_preds)
        pic.set_rect(pic.intra_y, x, y, size, size, mode)

        if log2size == sps.log2_min_cb:
            enc.encode_bin(bank["part_size"], 0, 1)  # 2Nx2N
        if self._pcm_eligible(log2size):
            enc.encode_terminate(0)   # pcm_flag = 0
        # intra luma mode: MPM flag + bins
        preds = self.sd._intra_mpm(x, y)
        if mode in preds:
            idx = preds.index(mode)
            enc.encode_bin(bank["intra_luma_mpm"], 0, 1)
            if idx == 0:
                enc.encode_bypass(0)
            else:
                enc.encode_bypass(1)
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(bank["intra_luma_mpm"], 0, 0)
            rem = mode
            for p in sorted(preds, reverse=True):
                if rem > p:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        # chroma direction: RD over DM + the allowed list
        c_real, c_dm, c_idx = self._select_chroma_intra_mode(x, y, size,
                                                             mode)
        self._write_chroma_mode(x, y, size, mode, c_real, c_dm, c_idx)

        # --- transform + recon per component ---
        # TU log2: luma TU == CU (within maxTB); chroma scaled.  4:2:2
        # chroma TUs are two square sub-TUs stacked vertically, predicted
        # sequentially (the lower one from the upper one's recon) with the
        # DM angle remapped (reference TComTU sections + TComPrediction's
        # g_chroma422IntraAngleMappingTable)
        is422 = sps.chroma_format_idc == 2
        resids = []   # per comp: list of sub-TU level arrays
        cbfs = []     # per comp: list of sub-TU cbfs
        for comp in range(self.ncomp):
            ssx = sps.chroma_shift_x() if comp else 0
            ssy = sps.chroma_shift_y() if comp else 0
            n = size >> ssx
            n_sub = 2 if (comp and is422) else 1
            cx = x >> ssx
            cmode = mode if comp == 0 else c_real
            if comp and is422:
                cmode = CHROMA422_ANGLE_MAP[c_real]
            bd = cfg.bit_depth
            levs, cbf_subs = [], []
            tu_scan = _SD
            if n <= (8 >> ssx) and n <= (8 >> ssy):
                if abs(cmode - 26) <= 4:
                    tu_scan = _SH
                elif abs(cmode - 10) <= 4:
                    tu_scan = _SV
            for s in range(n_sub):
                cy = (y >> ssy) + s * n
                pred = self._intra_pred(comp, cx, cy, n, cmode)
                orig_c = self.orig[comp][cy:cy + n, cx:cx + n]
                resi = (orig_c - pred).astype(np.int32)
                use_dst = comp == 0 and n == 4
                lev, rec_resi, cbf = self._tu_fwd(resi, use_dst, comp,
                                                  tu_scan, True)
                self.recon[comp][cy:cy + n, cx:cx + n] = np.clip(
                    pred + rec_resi, 0, (1 << bd) - 1)
                levs.append(lev)
                cbf_subs.append(cbf)
            resids.append(levs)
            cbfs.append(cbf_subs)
        while len(cbfs) < 3:        # mono: chroma emission sites no-op
            resids.append([])
            cbfs.append([])

        # --- TT syntax: split_transform_flag = 0 when it is coded
        # (QuadtreeTUMaxDepthIntra > 1), then cbfs and residuals
        # (4:2:2 codes both sub-TU cbfs at the lowest level, mirroring
        # _parse_cbf_chroma)
        self.cu_log2_for_tt = log2size
        self._maybe_write_subdiv(log2size, 0)
        for v in cbfs[1]:
            enc.encode_bin(bank["qt_cbf"], 5 + 0, v)
        for v in cbfs[2]:
            enc.encode_bin(bank["qt_cbf"], 5 + 0, v)
        enc.encode_bin(bank["qt_cbf"], 1, cbfs[0][0])
        self._maybe_write_dqp(cbfs[0][0] or any(cbfs[1]) or any(cbfs[2]))
        for comp in range(self.ncomp):
            ssx = sps.chroma_shift_x() if comp else 0
            ssy = sps.chroma_shift_y() if comp else 0
            smode = mode if comp == 0 else c_real
            if comp and is422:
                smode = CHROMA422_ANGLE_MAP[c_real]
            for s, lev in enumerate(resids[comp]):
                if not cbfs[comp][s]:
                    continue
                n = lev.shape[0]
                scan = SCAN_DIAG
                if n <= (8 >> ssx) and n <= (8 >> ssy):
                    if abs(smode - 26) <= 4:
                        scan = SCAN_HOR
                    elif abs(smode - 10) <= 4:
                        scan = SCAN_VER
                encode_residual(enc, bank, lev, comp, scan,
                                self.cfg.sign_hiding,
                                ts=self._ts_of(lev))
        self._finish_cu_qp(x, y, size)

    def _encode_cu_intra_rqt_split(self, x, y, log2size):
        """Intra 2Nx2N with a one-level TU split (split_transform_flag = 1):
        four luma quarter-TUs reconstructed sequentially with one shared
        mode; chroma follows the tree (at the children when the child
        chroma TB is >= 4x4, else held at the CU like the NxN case).
        Chroma-format general: 4:2:2 children carry two stacked square
        sub-TUs with the DM angle remapped; the root codes one combined
        chroma bin per component (mirroring _parse_cbf_chroma), the
        leaves code the per-sub-TU bins.  Used for 64x64 CUs (forced
        split, subdiv inferred) in every chroma format.
        Mirrors the decode-side _tt / _emit_tu (Rec. 7.3.8.8/7.3.8.10)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)
        pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTRA)

        def mdcs(n, m, c):
            sx = sps.chroma_shift_x() if c else 0
            if n <= (8 >> sx):
                if abs(m - 26) <= 4:
                    return SCAN_HOR
                if abs(m - 10) <= 4:
                    return SCAN_VER
            return SCAN_DIAG

        # whole-CU mode decision (same criterion as the no-split path)
        preds_mpm = self.sd._intra_mpm(x, y)
        all_preds = self._intra_all_preds(0, x, y, size)
        mode = self._select_intra_luma_mode(x, y, size, preds_mpm, all_preds)
        pic.set_rect(pic.intra_y, x, y, size, size, mode)
        pic.set_rect(pic.intra_c, x, y, size, size, mode)
        self._mark_edges(x, y, size)

        if log2size == sps.log2_min_cb:
            enc.encode_bin(bank["part_size"], 0, 1)   # 2Nx2N
        if self._pcm_eligible(log2size):
            enc.encode_terminate(0)                    # pcm_flag = 0
        # intra pred info: one PU
        if mode in preds_mpm:
            idx = preds_mpm.index(mode)
            enc.encode_bin(bank["intra_luma_mpm"], 0, 1)
            if idx == 0:
                enc.encode_bypass(0)
            else:
                enc.encode_bypass(1)
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(bank["intra_luma_mpm"], 0, 0)
            rem = mode
            for pm in sorted(preds_mpm, reverse=True):
                if rem > pm:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        has_c = sps.chroma_format_idc != 0
        c_real, c_dm, c_idx = self._select_chroma_intra_mode(x, y, size,
                                                             mode)
        self._write_chroma_mode(x, y, size, mode, c_real, c_dm, c_idx)

        self.cu_log2_for_tt = log2size
        self._maybe_write_subdiv(log2size, 1)
        half = size >> 1
        l2 = log2size - 1
        children = ((0, 0), (half, 0), (0, half), (half, half))
        ssx = sps.chroma_shift_x() if has_c else 0
        ssy = sps.chroma_shift_y() if has_c else 0
        is422 = sps.chroma_format_idc == 2
        n_sub = 2 if is422 else 1
        cmode = CHROMA422_ANGLE_MAP[c_real] if is422 else c_real
        chroma_at_children = has_c and (l2 - ssx) >= 2
        min_tu = self._intra_min_tu_log2(log2size)
        bd = cfg.bit_depth
        ef = pic.edge_flags

        def chroma_tus(bx, by, n):
            """Code the two components' sub-TUs of one chroma-holding
            node at (bx, by) luma coords, luma node size n.  Returns
            {comp: [(lev, cbf, scan), ...]} and writes the recon."""
            out = {}
            cn = n >> ssx
            for comp in (1, 2):
                subs = []
                for s in range(n_sub):
                    cyp = (by >> ssy) + s * cn
                    cxp = bx >> ssx
                    cpred = self._intra_pred(comp, cxp, cyp, cn, cmode)
                    cres = (self.orig[comp][cyp:cyp + cn, cxp:cxp + cn] -
                            cpred).astype(np.int32)
                    cscan = mdcs(cn, cmode, comp)
                    clev, crec, ccbf = self._tu_fwd(cres, False, comp,
                                                    cscan, True)
                    self.recon[comp][cyp:cyp + cn, cxp:cxp + cn] = np.clip(
                        cpred + crec, 0, (1 << bd) - 1)
                    subs.append((clev, ccbf, cscan))
                out[comp] = subs
            return out

        leaves = []
        for (dx, dy) in children:
            lx, ly = x + dx, y + dy
            pred = self._intra_pred(0, lx, ly, half, mode)
            resi = (self.orig[0][ly:ly + half, lx:lx + half] -
                    pred).astype(np.int32)
            scan = mdcs(half, mode, 0)
            lev, rec, cbf = self._tu_fwd(resi, half == 4, 0, scan, True)
            self.recon[0][ly:ly + half, lx:lx + half] = np.clip(
                pred + rec, 0, (1 << bd) - 1)
            pic.set_rect(pic.cbf_y, lx, ly, half, half, cbf)
            ef[ly >> 2:(ly + half) >> 2, lx >> 2] |= EDGE_TU_LEFT
            ef[ly >> 2, lx >> 2:(lx + half) >> 2] |= EDGE_TU_TOP
            c_entry = chroma_tus(lx, ly, half) if chroma_at_children else {}
            leaves.append((lev, cbf, scan, c_entry))

        c_single = None
        if chroma_at_children:
            root_cb = 1 if any(s[1] for lv in leaves
                               for s in lv[3][1]) else 0
            root_cr = 1 if any(s[1] for lv in leaves
                               for s in lv[3][2]) else 0
            enc.encode_bin(bank["qt_cbf"], 5, root_cb)
            enc.encode_bin(bank["qt_cbf"], 5, root_cr)
        elif has_c:
            # chroma held at the CU (single chroma TB per component)
            c_single = chroma_tus(x, y, size)
            for comp in (1, 2):
                for (_, scbf, _) in c_single[comp]:
                    enc.encode_bin(bank["qt_cbf"], 5, scbf)
            root_cb = 1 if any(s[1] for s in c_single[1]) else 0
            root_cr = 1 if any(s[1] for s in c_single[2]) else 0
        else:
            root_cb = root_cr = 0

        for j, (lev, cbf, scan, c_entry) in enumerate(leaves):
            # child subdiv = 0 when it is coded at this level
            if l2 != sps.log2_min_tb and l2 != min_tu and \
                    l2 <= sps.log2_max_tb:
                enc.encode_bin(bank["trans_subdiv"], 5 - l2, 0)
            if chroma_at_children:
                for comp, root in ((1, root_cb), (2, root_cr)):
                    if root:
                        for (_, scbf, _) in c_entry[comp]:
                            enc.encode_bin(bank["qt_cbf"], 6, scbf)
            enc.encode_bin(bank["qt_cbf"], 0, cbf)
            if chroma_at_children:
                any_cbf = cbf or \
                    (root_cb and any(s[1] for s in c_entry[1])) or \
                    (root_cr and any(s[1] for s in c_entry[2]))
            else:
                any_cbf = cbf or root_cb or root_cr
            self._maybe_write_dqp(any_cbf)
            if cbf:
                encode_residual(enc, bank, lev, 0, scan,
                                self.cfg.sign_hiding, ts=self._ts_of(lev))
            if chroma_at_children:
                for comp, root in ((1, root_cb), (2, root_cr)):
                    if not root:
                        continue
                    for (clev, scbf, cscan) in c_entry[comp]:
                        if scbf:
                            encode_residual(enc, bank, clev, comp, cscan,
                                            self.cfg.sign_hiding,
                                            ts=self._ts_of(clev))
            elif j == 3 and has_c:
                for comp in (1, 2):
                    for (clev, scbf, cscan) in c_single[comp]:
                        if scbf:
                            encode_residual(enc, bank, clev, comp, cscan,
                                            self.cfg.sign_hiding,
                                            ts=self._ts_of(clev))
        self._finish_cu_qp(x, y, size)

    def _mdcs_scan(self, n, mode, comp):
        """Mode-dependent coefficient scan (Rec. 8.4.4.2.1 MDCS)."""
        sx = self.sps.chroma_shift_x() if comp else 0
        if n <= (8 >> sx):
            if abs(mode - 26) <= 4:
                return SCAN_HOR
            if abs(mode - 10) <= 4:
                return SCAN_VER
        return SCAN_DIAG

    def _intra_mode_rd_trial(self, x, y, size, mode, preds_mpm, pred):
        """Luma-only RD cost of one intra candidate mode at the unsplit TU
        (reference TEncSearch::estIntraPredQT full-RD evaluation of the
        Hadamard-preselected candidate list)."""
        enc, bank, cfg = self.enc, self.bank, self.cfg
        from .residual_enc import encode_residual
        mark = len(enc.ops)
        if mode in preds_mpm:
            idx = preds_mpm.index(mode)
            enc.encode_bin(bank["intra_luma_mpm"], 0, 1)
            if idx == 0:
                enc.encode_bypass(0)
            else:
                enc.encode_bypass(1)
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(bank["intra_luma_mpm"], 0, 0)
            rem = mode
            for p in sorted(preds_mpm, reverse=True):
                if rem > p:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        orig = self.orig[0][y:y + size, x:x + size]
        resi = (orig - pred).astype(np.int32)
        scan = self._mdcs_scan(size, mode, 0)
        lev, rec_resi, cbf = self._tu_fwd(resi, size == 4, 0, scan, True)
        enc.encode_bin(bank["qt_cbf"], 1, cbf)
        if cbf:
            bits = self._residual_trial_bits(lev, 0, scan, mark)
        else:
            bits = self._est_ops_bits(mark)
        rec = np.clip(pred + rec_resi, 0, (1 << cfg.bit_depth) - 1)
        norm = 1 << (2 * (cfg.bit_depth - 8))
        sse = float(((orig.astype(np.int64) - rec) ** 2).sum()) / norm
        cost = sse + self.rd_lambda * bits
        enc.truncate(mark)
        return cost

    def _residual_trial_bits(self, lev, comp, scan, mark, ts="auto"):
        """Estimated bits of ops[mark:] plus one residual block that is
        NOT recorded (trial-only syntax): native bits-only pricer when
        available, falling back to record-then-price.  Bit-identical to
        recording encode_residual and pricing everything with
        _est_ops_bits (same accumulation order)."""
        if ts == "auto":
            ts = self._ts_of(lev)
        sh = self.cfg.sign_hiding
        nb = residual_bits(self.bank, lev, comp, scan, sh, ts,
                           start=self._est_ops_raw(mark))
        if nb is None:
            encode_residual(self.enc, self.bank, lev, comp, scan, sh, ts=ts)
            nb = self._est_ops_raw(mark)
        return nb / FRAC

    def _intra_mode_rd_trial_bits(self, mode, preds_mpm):
        """Record just the luma-mode signalling bins (MPM flag + index or
        5-bit escape) into the live recorder, for trial pricing."""
        enc, bank = self.enc, self.bank
        if mode in preds_mpm:
            idx = preds_mpm.index(mode)
            enc.encode_bin(bank["intra_luma_mpm"], 0, 1)
            if idx == 0:
                enc.encode_bypass(0)
            else:
                enc.encode_bypass(1)
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(bank["intra_luma_mpm"], 0, 0)
            rem = mode
            for p in sorted(preds_mpm, reverse=True):
                if rem > p:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)

    def _select_intra_luma_mode(self, x, y, size, preds_mpm, all_preds,
                                tree_min_tu=None):
        """Hadamard preselection + full-RD candidate pass (reference
        estIntraPredQT: 8 candidates for 4x4/8x8, 3 for larger, plus the
        MPMs), optionally followed by a joint (mode, tree) RD pass over
        the top candidates when the CU carries a multi-level RQT
        (tree_min_tu set).  Returns the chosen mode."""
        from ..utils.envvar import FORCE_LUMA_MODE
        forced = FORCE_LUMA_MODE.get_int()
        if forced is not None and 0 <= forced <= 34:
            return forced           # Debug.h ForceLumaMode equivalent
        orig = self.orig[0][y:y + size, x:x + size]
        lam_pred = self.rd_lambda ** 0.5
        ranked = []
        for m in range(35):
            bits = (2 if preds_mpm.index(m) == 0 else 3) \
                if m in preds_mpm else 6
            ranked.append((satd(all_preds[m], orig) + lam_pred * bits, m))
        ranked.sort()
        if not isinstance(self.enc, _RecordingCabac):
            return ranked[0][1]
        if size > (1 << self.sps.log2_max_tb):
            if tree_min_tu is None:
                return ranked[0][1]
            # CU larger than the max TB: no unsplit trial exists (the
            # root TT split is forced), so the joint (mode, tree) RD
            # below ranks the SATD candidates + MPMs directly
            # (reference estIntraPredQT runs xRecurIntraCodingQT per
            # candidate at 64x64 too, TEncSearch.cpp)
            scored = [(float(c), m) for c, m in ranked[:3]]
            for m in preds_mpm:
                if m not in [mm for _, mm in scored]:
                    scored.append((float("inf"), m))
        else:
            cand = [m for _, m in ranked[:8 if size <= 8 else 3]]
            for m in preds_mpm:
                if m not in cand:
                    cand.append(m)
            scored = []
            for m in cand:
                c = self._intra_mode_rd_trial(x, y, size, m, preds_mpm,
                                              all_preds[m])
                scored.append((c, m))
            scored.sort()
            if tree_min_tu is None or len(scored) < 2:
                return scored[0][1]
        # stage 3: joint (mode, transform-tree) RD over the top unsplit-RD
        # candidates — the reference's estIntraPredQT runs the full
        # xRecurIntraCodingQT per candidate, so a mode that only wins with
        # a split tree (or only wins unsplit) is ranked by its real cost
        enc = self.enc
        log2size = size.bit_length() - 1
        best_mode, best_cost = None, float("inf")
        ncand = int(os.environ.get("HEVC_INTRA_RD_CANDS", "2"))
        if size > (1 << self.sps.log2_max_tb):
            ncand = len(scored)    # no stage-2 preselection ran
        for _, m in scored[:ncand]:
            st = self._save_cu_state(x, y, size)
            mark = len(enc.ops)
            self._intra_mode_rd_trial_bits(m, preds_mpm)
            self.cu_log2_for_tt = log2size
            self._intra_tt_decide(x, y, log2size, 0, m, tree_min_tu)
            c = self._luma_rd_cost(x, y, size, mark)
            self._restore_cu_state(x, y, size, st)
            if c < best_cost:
                best_cost, best_mode = c, m
        return best_mode

    def _select_chroma_intra_mode(self, x, y, size, luma_mode):
        """RD-choose intra_chroma_pred_mode for one intra CU (reference
        TEncSearch::estIntraPredChromaQT): DM plus the 4-entry allowed
        list (planar/ver/hor/DC, the luma-colliding entry replaced by
        angular-34, Rec. 8.4.3), each fully coded at the CU-level chroma
        TB; cost = chroma-weighted SSE + lambda * (signal + residual)
        bits.  Returns (real_mode, dm_flag, list_idx)."""
        sps, cfg, enc, bank = self.sps, self.cfg, self.enc, self.bank
        if sps.chroma_format_idc == 0 or \
                not isinstance(enc, _RecordingCabac):
            return luma_mode, True, 0
        allowed = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX]
        for i in range(4):
            if allowed[i] == luma_mode:
                allowed[i] = 34
                break
        from ..utils.envvar import FORCE_CHROMA_MODE
        if FORCE_CHROMA_MODE.is_set():
            # Debug.h ForceChromaMode equivalent: DM or a listed mode
            want = FORCE_CHROMA_MODE.get_str()
            if want.upper() != "DM":
                m = FORCE_CHROMA_MODE.get_int()
                if m is not None and m in allowed:
                    return m, False, allowed.index(m)
            return luma_mode, True, 0
        is422 = sps.chroma_format_idc == 2
        ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
        n = size >> ssx
        n_sub = 2 if is422 else 1
        cx, cy0 = x >> ssx, y >> ssy
        bd = cfg.bit_depth
        norm = 1 << (2 * (bd - 8))
        snaps = [self.recon[c][cy0:cy0 + n_sub * n, cx:cx + n].copy()
                 for c in (1, 2)]
        mark = len(enc.ops)
        best, best_cost = (luma_mode, True, 0), float("inf")
        for k, cand in enumerate([luma_mode] + allowed):
            dm = k == 0
            if not dm and cand == luma_mode:
                continue                      # identical to the DM trial
            cmode = CHROMA422_ANGLE_MAP[cand] if is422 else cand
            enc.encode_bin(bank["intra_chroma_mode"], 0, 0 if dm else 1)
            if not dm:
                enc.encode_bypass_bins(k - 1, 2)
            cost = 0.0
            # a chroma TB larger than the max TB (4:4:4 64x64 CUs) is
            # coded as four quadrant TBs — evaluate the same structure
            tb = min(n, 1 << self.sps.log2_max_tb)
            for comp in (1, 2):
                for s in range(n_sub):
                    for qy in range(0, n, tb):
                        for qx in range(0, n, tb):
                            cy = cy0 + s * n + qy
                            cxq = cx + qx
                            pred = self._intra_pred(comp, cxq, cy, tb,
                                                    cmode)
                            orig_c = self.orig[comp][cy:cy + tb,
                                                     cxq:cxq + tb]
                            resi = (orig_c - pred).astype(np.int32)
                            cscan = self._mdcs_scan(tb, cmode, comp)
                            lev, rec_resi, cbf = self._tu_fwd(
                                resi, False, comp, cscan, True)
                            rec = np.clip(pred + rec_resi, 0,
                                          (1 << bd) - 1)
                            self.recon[comp][cy:cy + tb, cxq:cxq + tb] = rec
                            sse = float(((orig_c.astype(np.int64) - rec)
                                         ** 2).sum()) / norm
                            bits = self._residual_trial_bits(
                                lev, comp, cscan,
                                len(enc.ops)) if cbf else 0
                            cost += self.chroma_weight[comp] * sse + \
                                self.rd_lambda * bits
            cost += self.rd_lambda * self._est_ops_bits(mark)
            enc.truncate(mark)
            if cost < best_cost:
                best_cost = cost
                best = (cand, dm, 0 if dm else k - 1)
        for ci, c in enumerate((1, 2)):
            self.recon[c][cy0:cy0 + n_sub * n, cx:cx + n] = snaps[ci]
        return best

    def _write_chroma_mode(self, x, y, size, luma_mode, cmode, dm, idx):
        """Emit intra_chroma_pred_mode and fill the chroma maps the
        decoder derives from (slicedec parse: intra_c = real mode,
        chroma_dm flag gates CCP)."""
        enc, bank, pic = self.enc, self.bank, self.pic
        if self.sps.chroma_format_idc == 0:
            return                  # 4:0:0: no intra_chroma_pred_mode
        enc.encode_bin(bank["intra_chroma_mode"], 0, 0 if dm else 1)
        if not dm:
            enc.encode_bypass_bins(idx, 2)
        real = luma_mode if dm else cmode
        pic.set_rect(pic.intra_c, x, y, size, size, real)
        if getattr(pic, "chroma_dm", None) is not None:
            pic.set_rect(pic.chroma_dm, x, y, size, size, 1 if dm else 0)

    def _luma_rd_cost(self, x, y, size, ops_lo):
        cfg = self.cfg
        norm = 1 << (2 * (cfg.bit_depth - 8))
        o = self.orig[0][y:y + size, x:x + size].astype(np.int64)
        r = self.recon[0][y:y + size, x:x + size].astype(np.int64)
        sse = float(((o - r) ** 2).sum()) / norm
        return sse + self.rd_lambda * self._est_ops_bits(ops_lo)

    def _subdiv_coded(self, l2, min_tu):
        sps = self.sps
        return (l2 <= sps.log2_max_tb and l2 != sps.log2_min_tb and
                l2 != min_tu)

    def _intra_tt_decide(self, x, y, l2, depth, mode, min_tu):
        """RD-choose the luma transform tree below one intra 2Nx2N CU.
        Trial syntax (subdiv + cbf_luma + luma coeffs only) is recorded
        for bit estimation and later discarded by the caller; on return
        the luma recon / cbf_y / edge maps hold the chosen tree."""
        sps, enc, bank = self.sps, self.enc, self.bank
        size = 1 << l2

        def leaf_try():
            pred = self._intra_pred(0, x, y, size, mode)
            resi = (self.orig[0][y:y + size, x:x + size] -
                    pred).astype(np.int32)
            scan = self._mdcs_scan(size, mode, 0)
            lev, rec, cbf = self._tu_fwd(resi, size == 4, 0, scan, True)
            self.recon[0][y:y + size, x:x + size] = np.clip(
                pred + rec, 0, (1 << self.cfg.bit_depth) - 1)
            self.pic.set_rect(self.pic.cbf_y, x, y, size, size, cbf)
            ef = self.pic.edge_flags
            ef[y >> 2:(y + size) >> 2, x >> 2] |= EDGE_TU_LEFT
            ef[y >> 2, x >> 2:(x + size) >> 2] |= EDGE_TU_TOP
            if self._subdiv_coded(l2, min_tu):
                enc.encode_bin(bank["trans_subdiv"], 5 - l2, 0)
            enc.encode_bin(bank["qt_cbf"], 1 if depth == 0 else 0, cbf)
            if cbf:
                encode_residual(enc, bank, lev, 0, scan,
                                self.cfg.sign_hiding, ts=self._ts_of(lev))
            return {"split": False, "l2": l2, "x": x, "y": y,
                    "depth": depth, "lev": lev, "cbf": cbf, "scan": scan}

        def split_try():
            if self._subdiv_coded(l2, min_tu):
                enc.encode_bin(bank["trans_subdiv"], 5 - l2, 1)
            h = size >> 1
            kids = [self._intra_tt_decide(x + dx, y + dy, l2 - 1,
                                          depth + 1, mode, min_tu)
                    for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h))]
            return {"split": True, "l2": l2, "x": x, "y": y,
                    "depth": depth, "kids": kids}

        if l2 > sps.log2_max_tb:
            return split_try()
        if not (l2 > min_tu and l2 > sps.log2_min_tb):
            return leaf_try()
        st = self._save_cu_state(x, y, size)
        mark = st[3]
        leaf = leaf_try()
        cost_leaf = self._luma_rd_cost(x, y, size, mark)
        leaf_state = self._save_cu_state(x, y, size)
        leaf_ops = list(enc.ops[mark:])
        self._restore_cu_state(x, y, size, st)
        split = split_try()
        cost_split = self._luma_rd_cost(x, y, size, mark)
        if cost_leaf <= cost_split:
            enc.truncate(mark)   # roll the split ops' states back first
            self._restore_cu_state(x, y, size, leaf_state)
            enc.reinstate(leaf_ops)
            return leaf
        return split

    def _intra_tt_chroma(self, node, mode):
        """Compute chroma on the decided luma tree, z-order, for any
        chroma format.  420/422: the chroma TB lives at a leaf with luma
        >= 8x8, or is held at an 8x8 node that splits into 4x4 lumas
        (children inherit; Rec. 7.3.8.8); 4:2:2 codes two square sub-TUs
        stacked vertically with the DM angle remapped.  4:4:4: chroma
        follows every luma split (same-size TBs at every leaf)."""
        sps = self.sps
        idc = sps.chroma_format_idc
        l2 = node["l2"]
        if idc == 0:
            node["cb"] = node["cr"] = [0, 0]
            if node["split"]:
                for k in node["kids"]:
                    self._intra_tt_chroma(k, mode)
            return
        if node["split"] and (idc == 3 or l2 > 3):
            for k in node["kids"]:
                self._intra_tt_chroma(k, mode)
            for key in ("cb", "cr"):
                v = 1 if any(any(k[key]) for k in node["kids"]) else 0
                node[key] = [v, v]
            return
        x, y, bd = node["x"], node["y"], self.cfg.bit_depth
        ssx, ssy = sps.chroma_shift_x(), sps.chroma_shift_y()
        cn = 1 << (l2 - ssx)
        n_sub = 2 if idc == 2 else 1
        cx = x >> ssx
        cy0 = y >> ssy
        cmode = CHROMA422_ANGLE_MAP[mode] if idc == 2 else mode
        ch = {}
        for comp in (1, 2):
            subs = []
            for s in range(n_sub):
                cy = cy0 + s * cn
                pred = self._intra_pred(comp, cx, cy, cn, cmode)
                res = (self.orig[comp][cy:cy + cn, cx:cx + cn] -
                       pred).astype(np.int32)
                cscan = self._mdcs_scan(cn, cmode, comp)
                clev, crec, ccbf = self._tu_fwd(res, False, comp, cscan,
                                                True)
                self.recon[comp][cy:cy + cn, cx:cx + cn] = np.clip(
                    pred + crec, 0, (1 << bd) - 1)
                subs.append((clev, ccbf, cscan))
            ch[comp] = subs
        node["chroma"] = ch
        node["cb"] = [ch[1][0][1], ch[1][-1][1]]
        node["cr"] = [ch[2][0][1], ch[2][-1][1]]
        if node["split"]:
            # 4x4 luma children below an 8x8 chroma-holding node (420/422)
            for k in node["kids"]:
                k["cb"] = k["cr"] = [0, 0]

    def _write_cbf_chroma(self, log2size, tr_depth, vals):
        """Mirror of the decode-side _parse_cbf_chroma: one combined bin,
        except 4:2:2 at the lowest level (or when the chroma block cannot
        quad-split further) which codes both square sub-TU CBFs."""
        enc, bank = self.enc, self.bank
        ctx = 5 + tr_depth
        if self.sps.chroma_format_idc != 2:
            enc.encode_bin(bank["qt_cbf"], ctx, vals[0])
            return
        can_quad = (log2size - 1) >= 3
        if vals[2] or not can_quad:     # vals[2] = lowest
            enc.encode_bin(bank["qt_cbf"], ctx, vals[0])
            enc.encode_bin(bank["qt_cbf"], ctx, vals[1])
        else:
            enc.encode_bin(bank["qt_cbf"], ctx, vals[0])

    def _intra_tt_emit(self, node, min_tu, parent_cb, parent_cr, blk_idx,
                       parent_chroma):
        """Write one transform_tree node in decoder syntax order (mirror
        of slicedec._tt for an intra 2Nx2N CU, all chroma formats)."""
        enc, bank, sps = self.enc, self.bank, self.sps
        idc = sps.chroma_format_idc
        l2, depth = node["l2"], node["depth"]
        subdiv = node["split"]
        if self._subdiv_coded(l2, min_tu):
            enc.encode_bin(bank["trans_subdiv"], 5 - l2, 1 if subdiv else 0)
        cb, cr = list(parent_cb), list(parent_cr)
        if idc != 0 and (l2 > 2 or idc == 3):
            cb = node["cb"]
            cr = node["cr"]
            lowest = 0 if subdiv else 1
            if depth == 0 or parent_cb[0] or parent_cb[1]:
                self._write_cbf_chroma(l2, depth, (cb[0], cb[1], lowest))
            else:
                cb = [0, 0]
            if depth == 0 or parent_cr[0] or parent_cr[1]:
                self._write_cbf_chroma(l2, depth, (cr[0], cr[1], lowest))
            else:
                cr = [0, 0]
        if subdiv:
            held = node.get("chroma")   # 8x8 node holding the chroma TB
            for i, k in enumerate(node["kids"]):
                self._intra_tt_emit(k, min_tu, cb, cr, i, held)
            return
        cbf = node["cbf"]
        enc.encode_bin(bank["qt_cbf"], 1 if depth == 0 else 0, cbf)
        self._maybe_write_dqp(cbf or cb[0] or cb[1] or cr[0] or cr[1])
        if cbf:
            encode_residual(enc, bank, node["lev"], 0, node["scan"],
                            self.cfg.sign_hiding, ts=self._ts_of(node["lev"]))
        chroma_here = idc != 0 and (l2 - sps.chroma_shift_x()) >= 2
        ch = node.get("chroma") if chroma_here else \
            (parent_chroma if (idc != 0 and blk_idx == 3) else None)
        if ch:
            for comp in (1, 2):
                for clev, ccbf, cscan in ch[comp]:
                    if ccbf:
                        encode_residual(enc, bank, clev, comp, cscan,
                                        self.cfg.sign_hiding,
                                        ts=self._ts_of(clev))

    def _encode_cu_intra_2nx2n_rqt(self, x, y, log2size):
        """Intra 2Nx2N with a full RD-searched transform tree
        (QuadtreeTUMaxDepthIntra levels; reference xRecurIntraCodingQT)."""
        sps, cfg, pic, enc, bank = self.sps, self.cfg, self.pic, self.enc, \
            self.bank
        size = 1 << log2size
        pic.set_rect(pic.part_size, x, y, size, size, SIZE_2Nx2N)
        pic.set_rect(pic.pred_mode, x, y, size, size, MODE_INTRA)

        # whole-CU mode decision (shared mode for the tree), ranked with
        # the transform tree in the loop for the final candidates
        preds_mpm = self.sd._intra_mpm(x, y)
        all_preds = self._intra_all_preds(0, x, y, size)
        self.cu_log2_for_tt = log2size
        mode = self._select_intra_luma_mode(
            x, y, size, preds_mpm, all_preds,
            tree_min_tu=self._intra_min_tu_log2(log2size))
        pic.set_rect(pic.intra_y, x, y, size, size, mode)
        pic.set_rect(pic.intra_c, x, y, size, size, mode)
        self._mark_edges(x, y, size)

        if log2size == sps.log2_min_cb:
            enc.encode_bin(bank["part_size"], 0, 1)   # 2Nx2N
        if self._pcm_eligible(log2size):
            enc.encode_terminate(0)                    # pcm_flag = 0
        if mode in preds_mpm:
            idx = preds_mpm.index(mode)
            enc.encode_bin(bank["intra_luma_mpm"], 0, 1)
            if idx == 0:
                enc.encode_bypass(0)
            else:
                enc.encode_bypass(1)
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(bank["intra_luma_mpm"], 0, 0)
            rem = mode
            for pm in sorted(preds_mpm, reverse=True):
                if rem > pm:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        c_real, c_dm, c_idx = self._select_chroma_intra_mode(x, y, size,
                                                             mode)
        self._write_chroma_mode(x, y, size, mode, c_real, c_dm, c_idx)

        self.cu_log2_for_tt = log2size
        min_tu = self._intra_min_tu_log2(log2size)
        mark = len(enc.ops)
        tree = self._intra_tt_decide(x, y, log2size, 0, mode, min_tu)
        enc.truncate(mark)            # luma-only trial syntax
        self._intra_tt_chroma(tree, c_real)
        self._intra_tt_emit(tree, min_tu, (0, 0), (0, 0), 0, None)
        self._finish_cu_qp(x, y, size)

    # "pcm" too: a PCM trial that loses must not leave its mark, which
    # pcm_loop_filter_disabled's restore (_loop_filter) reads
    _CU_MAPS = ("depth", "pred_mode", "part_size", "skip", "pcm", "intra_y",
                "intra_c", "chroma_dm", "qp", "cbf_y", "edge_flags",
                "inter_dir", "mv", "ref_idx", "ref_poc", "ref_is_lt")

    def _save_cu_state(self, x, y, size):
        """Snapshot everything a trial encode of one CU can touch."""
        pic, sps = self.pic, self.sps
        sl = np.s_[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2]
        maps = {m: getattr(pic, m)[sl].copy() for m in self._CU_MAPS
                if getattr(pic, m, None) is not None}
        recs = []
        for c in range(3 if sps.chroma_format_idc else 1):
            ssx = sps.chroma_shift_x() if c else 0
            ssy = sps.chroma_shift_y() if c else 0
            recs.append(self.recon[c][y >> ssy:(y + size) >> ssy,
                                      x >> ssx:(x + size) >> ssx].copy())
        nops = len(self.enc.ops)
        dqp = (getattr(self, "_last_qp_enc", 0),
               getattr(self, "_qp_pred_enc", 0),
               getattr(self, "_dqp_coded", True),
               getattr(self, "_cu_delta_enc", 0))
        return (sl, maps, recs, nops, len(pic.inter_list), dqp)

    def _restore_cu_state(self, x, y, size, st):
        pic, sps = self.pic, self.sps
        sl, maps, recs, nops, ninter, dqp = st
        (self._last_qp_enc, self._qp_pred_enc, self._dqp_coded,
         self._cu_delta_enc) = dqp
        for m, v in maps.items():
            getattr(pic, m)[sl] = v
        for c in range(len(recs)):
            ssx = sps.chroma_shift_x() if c else 0
            ssy = sps.chroma_shift_y() if c else 0
            self.recon[c][y >> ssy:(y + size) >> ssy,
                          x >> ssx:(x + size) >> ssx] = recs[c]
        self.enc.truncate(nops)
        del pic.inter_list[ninter:]

    def _est_ops_bits(self, lo):
        """Estimated bits of recorded CABAC ops [lo:] using the live
        context probabilities (reference RD uses the same fractional-bit
        model)."""
        return self._est_ops_raw(lo) / FRAC

    def _est_ops_raw(self, lo):
        """FRAC-scaled raw accumulation of _est_ops_bits (the unit the
        native residual pricer continues from).  Context bins are priced
        at the per-op PRE-adaptation state each op carries (trial-coder
        semantics: the state each bin was actually coded at, reference
        TEncBinCABACCounter fractional-bit accumulation)."""
        tot = 0.0
        for op in self.enc.ops[lo:]:
            k = op[0]
            if k == "b":
                state = op[4]
                tot += _EST_MPS[state >> 1] if op[3] == (state & 1) \
                    else _EST_LPS[state >> 1]
            elif k == "p":
                tot += FRAC
            elif k == "pn":
                tot += op[2] * FRAC
            elif k == "t":
                tot += FRAC
            elif k == "pcm":
                tot += (sum(n for _, n in op[1]) + 16) * FRAC
            else:
                tot += (2 * ((int(op[1]) >> op[2]) + 1).bit_length() - 1 +
                        op[2]) * FRAC
        return tot

    def _cu_rd_cost(self, x, y, size, ops_lo):
        """SSE (8-bit domain) + lambda * estimated bits for one CU."""
        sps, cfg = self.sps, self.cfg
        norm = 1 << (2 * (cfg.bit_depth - 8))
        sse = 0.0
        for c in range(3 if sps.chroma_format_idc else 1):
            ssx = sps.chroma_shift_x() if c else 0
            ssy = sps.chroma_shift_y() if c else 0
            o = self.orig[c][y >> ssy:(y + size) >> ssy,
                             x >> ssx:(x + size) >> ssx].astype(np.int64)
            r = self.recon[c][y >> ssy:(y + size) >> ssy,
                              x >> ssx:(x + size) >> ssx].astype(np.int64)
            sse += self.chroma_weight[c] * \
                float(((o - r) ** 2).sum()) / norm
        return sse + self.rd_lambda * self._est_ops_bits(ops_lo)

    def _tu_fwd(self, resi, use_dst, comp, scan, is_intra):
        """One TU forward path -> (levels, reconstructed residual, cbf).

        Lossless (cu_transquant_bypass): identity — the coded levels ARE
        the residual (reference TComTrQuant transformSkip/bypass path).
        """
        bd = self.cfg.bit_depth
        n = resi.shape[1]
        if getattr(self.cfg, "lossless", False):
            lev = resi.astype(np.int32)
            cbf = 1 if lev.any() else 0
            return lev, (lev if cbf else np.zeros_like(lev)), cbf
        qp = self._qp_for_comp(comp)
        log2n = n.bit_length() - 1
        mat = self._scaling_matrix(log2n, comp, is_intra)
        if resi.shape[0] == n:
            lib = self._enc_native()
            if lib is not None:
                # native whole-TU forward path (enc_tu_fwd, bit-identical
                # mirror of the Python body below — tests/test_encsearch.py).
                # The 6 context-bank addresses and per-(comp, lambda)
                # constants are cached: this is the hottest encoder call
                # site (hundreds of thousands of TU trials per picture).
                cfg, bank = self.cfg, self.bank
                ent = self._tufwd_cache
                if ent is None or ent[0] is not bank:
                    ent = self._tufwd_cache = (
                        bank, _addr(bank["sig"]), _addr(bank["sig_cg"]),
                        _addr(bank["gt1"]), _addr(bank["gt2"]),
                        _addr(bank["last_x"]), _addr(bank["last_y"]),
                        1 if cfg.rdoq else 0,
                        1 if cfg.sign_hiding else 0,
                        1 if getattr(cfg, "transform_skip", False) else 0,
                        1 << (2 * (bd - 8)))
                ts_en = ent[9] if n == 4 else 0
                lam = self.rd_lambda / self.chroma_weight[comp]
                r32 = np.ascontiguousarray(resi, np.int32)
                lev = np.empty((n, n), np.int32)
                rec = np.empty((n, n), np.int32)
                flags = lib.enc_tu_fwd(
                    r32.ctypes.data, n, 1 if use_dst else 0,
                    1 if comp > 0 else 0, qp, bd, 1 if is_intra else 0,
                    int(scan), ent[7], lam, ent[8], ts_en, lam * ent[10],
                    ent[1], ent[2], ent[3], ent[4], ent[5], ent[6],
                    lev.ctypes.data, rec.ctypes.data,
                    mat.ctypes.data if mat is not None else 0)
                cbf = flags & 1
                ts = (flags >> 1) - 1
                if ts >= 0:
                    self._ts_flags[id(lev)] = (lev, ts)
                return lev, rec, cbf
        coef = forward_transform(resi, use_dst, bd)
        if mat is not None:
            # fold the default scaling list into the forward quantiser
            # (reference xSetScalingListEnc quantCoef = scale*16/list);
            # the recon dequant below applies the exact spec matrix path
            coef = np.sign(coef) * ((np.abs(coef.astype(np.int64)) * 16)
                                    // mat)
            coef = coef.astype(np.int32)
        lev = self._quant(coef, qp, log2n, is_intra, comp, scan)
        cbf = 1 if lev.any() else 0
        if cbf:
            deq = refimpl.dequant(lev, qp, log2n, bd, scaling=mat)
            rec = refimpl.inverse_transform(deq, use_dst, bd)
        else:
            rec = np.zeros_like(resi)
        if getattr(self.cfg, "transform_skip", False) and n == 4:
            # transform-skip trial (reference TEncSearch transformSkip RD):
            # forward = resi << tshift, same quantiser, pick by residual SSE
            tshift = 15 - bd - log2n
            coef_ts = (resi << tshift) if tshift >= 0 else                 (resi >> -tshift)
            lev_ts = self._quant(coef_ts.astype(np.int32), qp, log2n,
                                 is_intra, comp, scan)
            if lev_ts.any():
                deq = refimpl.dequant(lev_ts, qp, log2n, bd, scaling=mat)
                rec_ts = refimpl.inverse_transform_skip(deq, bd, log2n)
            else:
                rec_ts = np.zeros_like(resi)
            # RD choice with a rate estimate (the reference tries both in
            # full RD, TEncSearch xIntraCodingTUBlock; a pure-SSE pick
            # chooses spatial-domain levels that scatter across every
            # coefficient group and explode the residual bit cost)
            norm = 1 << (2 * (bd - 8))
            lam = self.rd_lambda / self.chroma_weight[comp] * norm
            cost_d = float(((resi - rec) ** 2).sum()) + \
                lam * _rough_level_bits(lev)
            cost_t = float(((resi - rec_ts) ** 2).sum()) + \
                lam * _rough_level_bits(lev_ts)
            ts = 1 if cost_t < cost_d else 0
            if ts:
                lev, rec = lev_ts, rec_ts
                cbf = 1 if lev.any() else 0
            # keep the array reference: id() reuse after GC would
            # alias a discarded trial's flag onto a new block
            self._ts_flags[id(lev)] = (lev, ts)
        return lev, rec, cbf

    def _scaling_matrix(self, log2n, comp, is_intra):
        """Default dequant scaling matrix (ScalingList: 1 with no explicit
        data -> default lists, reference TComScalingList) or None."""
        if not getattr(self.cfg, "scaling_list", False) or log2n < 2:
            return None
        if not hasattr(self, "_scal_mats"):
            self._scal_mats = build_scaling_matrices(
                getattr(self.cfg, "scaling_list_data", None))
        return self._scal_mats[(log2n - 2, (0 if is_intra else 3) + comp)]

    def _ts_of(self, lev):
        """transform_skip_flag for this coded block, or None when the
        residual_coding syntax carries no flag (tool off / TU > 4x4)."""
        if not getattr(self.cfg, "transform_skip", False):
            return None
        entry = self._ts_flags.get(id(lev))
        if entry is None or entry[0] is not lev:
            return None
        return entry[1]

    def _quant(self, coef, qp, log2n, is_intra, comp, scan_type):
        """Quantize one TU: RDOQ when enabled, else plain xQuant; then the
        sign-data-hiding parity fix-up when SDH is on."""
        bd = self.cfg.bit_depth
        if self.cfg.rdoq:
            # RDOQ chroma lambda = lambda / distortion weight
            # (RDOQ_CHROMA_LAMBDA, TEncSlice::setUpLambda)
            lam = self.rd_lambda / self.chroma_weight[comp]
            lev = _rdoq_fn(coef, qp, log2n, bd, comp, scan_type, self.bank,
                       lam)
        else:
            lev = quantize(coef, qp, log2n, bd, is_intra)
        if self.cfg.sign_hiding and lev.any():
            from .residual_enc import apply_sign_hiding
            lev = apply_sign_hiding(lev, coef, qp, log2n, bd, scan_type)
        return lev

    def _maybe_write_dqp(self, any_cbf):
        """cu_qp_delta_abs/sign at the first coded leaf of the quantization
        group (mirror of the decoder's _parse_cu_qp_delta call site)."""
        if not getattr(self, "_dqp_enabled", False) or self._dqp_coded \
                or not any_cbf:
            return
        enc, bank = self.enc, self.bank
        v = self.cur_qp - self._qp_pred_enc
        m = abs(v)
        enc.encode_bin(bank["dqp"], 0, 1 if m else 0)
        if m:
            k = 1
            while k < 5 and k < m:
                enc.encode_bin(bank["dqp"], 1, 1)
                k += 1
            if m < 5:
                enc.encode_bin(bank["dqp"], 1, 0)
            else:
                enc.encode_eg_k(m - 5, 0)
            enc.encode_bypass(1 if v < 0 else 0)
        self._cu_delta_enc = v
        self._dqp_coded = True

    def _finish_cu_qp(self, x, y, size):
        """CU-final QP map entry + predictor state (decoder _finish_cu)."""
        if getattr(self, "_dqp_enabled", False):
            if self._cu_delta_enc:
                qp = (self._qp_pred_enc + self._cu_delta_enc + 52) % 52
            else:
                qp = self._qp_pred_enc
        else:
            qp = self.cur_qp
        self.pic.set_rect(self.pic.qp, x, y, size, size, qp)
        self._last_qp_enc = qp

    def _qp_for_comp(self, comp):
        cfg, sps = self.cfg, self.sps
        qp = self.cur_qp
        if comp == 0:
            return qp + 6 * (cfg.bit_depth - 8)
        off_bd = 6 * (cfg.bit_depth - 8)
        qpi = max(-off_bd, min(57, qp))
        if qpi >= 0:
            qpi = CHROMA_QP_SCALE[sps.chroma_format_idc][qpi]
        return qpi + off_bd
