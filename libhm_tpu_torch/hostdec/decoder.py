# Copied from libhm_tpu/hostdec/decoder.py
"""Top-level HEVC decoder: NAL dispatch, POC, DPB, output bumping.

Rebuild of the reference decoder control plane: TDecTop::decode NAL switch
(reference: source/Lib/TLibDecoder/TDecTop.cpp:729-857), POC derivation and
RPS application (TDecTop.cpp:351-669), and the output-order bumping of the
decoder app / library wrapper (TAppDecTop.cpp:324 xWriteOutput,
libHMDecoder.cpp:255-339) which implements Rec. H.265 Annex C.5.2.2.
"""
import numpy as np

from . import nal as N
from .params import parse_sps, parse_pps, parse_vps, parse_slice_header, \
    I_SLICE
from .picture import PicSyntax
from .slicedec import SliceDecoder
from .recon_np import PictureRecon
from ..utils import obs


class DecodedPicture:
    def __init__(self, poc, planes, sps, temporal_id, output_flag):
        self.poc = poc
        self.planes = planes             # padded int32 planes
        self.sps = sps
        self.temporal_id = temporal_id
        self.needed_for_output = bool(output_flag)
        self.is_reference = True
        self.is_long_term = False
        self.pic_syntax = None           # kept while needed for TMVP

    def cropped(self):
        """Conformance-cropped planes at native bit depth (uint8/uint16)."""
        if getattr(self, "cropped_planes", None) is not None:
            return self.cropped_planes
        sps = self.sps
        cl, cr, ct, cb = sps.conf_win
        out = []
        for c, p in enumerate(self.planes):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            w = (sps.width >> sx)
            h = (sps.height >> sy)
            # conformance window offsets are in chroma units scaled by SubWidthC
            mulx = 1 if c else (1 << sps.chroma_shift_x())
            muly = 1 if c else (1 << sps.chroma_shift_y())
            x0, x1 = cl * mulx, w - cr * mulx
            y0, y1 = ct * muly, h - cb * muly
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            dt = np.uint8 if bd == 8 else np.uint16
            out.append(p[y0:y1, x0:x1].astype(dt))
        return out


class Decoder:
    """Full-stream decoder with the numpy reconstruction backend by default.

    recon_backend: factory(sps, pic_syntax, zmap, tile_map) -> object with
    .reconstruct(ref_pics, mc_fn) -> planes.

    recon="torch" reconstructs each picture on `device` (the card unless
    the caller asks for the CPU) as soon as the control plane finishes it
    (recon_torch.reconstruct_picture); reference pictures keep their planes
    on the device while they are in the DPB.
    """

    def __init__(self, recon_backend=None, parse="python", recon="numpy",
                 check_sei_hash=False, device="cuda"):
        if recon == "tpu":
            raise ValueError("recon='tpu' is the JAX package's backend; "
                             "the port's device backend is recon='torch'")
        if recon == "torch":
            from ..parallel.dag_decode import _check_device
            device = _check_device(device, "Decoder(recon='torch')")
        self.device = device
        self._resident = []             # pictures holding device planes
        self.parse = parse
        self.recon = recon
        # decoded-picture-hash SEI verification (reference TDecGop
        # calcAndPrintHashStatus; libHMDec_set_SEI_Check)
        self.check_sei_hash = check_sei_hash
        self._pending_hash = None
        self._native_queue = None
        self._native_pos = 0
        self._native_stream = None      # incremental NAL-push native parser
        self._native_whole = False      # whole-stream pre-parse mode
        self.max_temporal_layer = -1    # -1 = decode all sub-layers
        self.sps_map = {}
        self.pps_map = {}
        self.vps_map = {}
        self._pending_prefix_sei = []   # prefix SEI for the next picture
        self.sei_log = []               # (is_suffix, type, payload) stream log
        self.dpb = []
        self.outputs = []               # cropped pictures in output order
        self.output_records = []        # DecodedPicture per output
        self.prev_tid0_poc = 0
        self.first_slice_of_seq = True
        self.cur = None                 # (sh, PicSyntax, SliceDecoder)
        self.slice_count = 0
        self.no_rasl_output = False
        self.poc_cra = 0
        self.assoc_irap_type = N.NAL_IDR_W_RADL
        self.recon_backend = recon_backend or PictureRecon
        self.new_sequence = True

    # ------------------------------------------------------------------
    def decode_annexb(self, data: bytes):
        with obs.span("parse"):
            if self.parse == "native":
                from . import native_bridge
                self._native_queue = list(native_bridge.parse_stream(
                    data, recon=(self.recon == "native")))
                self._native_pos = 0
                self._native_whole = True
            with obs.span("parse.control") as s:
                for ebsp in N.split_annexb(data):
                    self.decode_nal(N.parse_nal(ebsp))
                    s.n += 1
                self.flush()
        return self.outputs

    def decode_nal(self, nalu):
        t = nalu.nal_type
        if 0 <= self.max_temporal_layer < nalu.temporal_id and N.is_vcl(t):
            return  # temporal sub-layer dropped (libHMDec_set_max_temporal_layer)
        if self.parse == "native" and not self._native_whole and nalu.ebsp:
            # incremental NAL-push mode (libHMDec protocol): mirror every NAL
            # into the native parser; completed native pictures queue up in
            # lock-step with the Python HLS/DPB layer
            if self._native_stream is None:
                from . import native_bridge
                self._native_stream = native_bridge.NativeStream(
                    recon=(self.recon == "native"))
                self._native_queue = []
            self._native_queue.extend(self._native_stream.feed(nalu.ebsp))
        if t == N.NAL_SPS:
            sps = parse_sps(nalu.rbsp)
            self.sps_map[sps.sps_id] = sps
        elif t == N.NAL_PPS:
            pps = parse_pps(nalu.rbsp)
            self.pps_map[pps.pps_id] = pps
        elif t == N.NAL_VPS:
            vps = parse_vps(nalu.rbsp)
            self.vps_map[vps.vps_id] = vps
        elif t == N.NAL_SUFFIX_SEI:
            from . import sei
            for ptype, payload in sei.parse_sei_rbsp(nalu.rbsp):
                if ptype == sei.SEI_DECODED_PICTURE_HASH and payload and \
                        self.check_sei_hash:
                    self._pending_hash = sei.DecodedPictureHash(payload)
            self.sei_log.extend(
                (1, t2, p) for t2, p in sei.decode_sei_payloads(
                    nalu.rbsp, self._any_sps()))
        elif t == N.NAL_PREFIX_SEI:
            # typed decode of prefix SEI; payloads attach to the NEXT
            # picture (reference TDecTop keeps m_SEIs per access unit)
            from . import sei
            payloads = sei.decode_sei_payloads(nalu.rbsp, self._any_sps())
            self._pending_prefix_sei.extend(payloads)
            self.sei_log.extend((0, t2, p) for t2, p in payloads)
        elif t in (N.NAL_AUD, N.NAL_FD):
            pass
        elif t == N.NAL_EOS:
            self._finish_picture()
            self.new_sequence = True
        elif N.is_vcl(t):
            self._decode_slice_nal(nalu)

    def _any_sps(self):
        """Best-effort active SPS for HRD-dependent SEI field lengths."""
        if self.cur is not None:
            sh = self.cur[0]
            return self.sps_map[self.pps_map[sh.pps_id].sps_id]
        for sps in reversed(list(self.sps_map.values())):
            return sps
        return None

    # ------------------------------------------------------------------
    def _decode_slice_nal(self, nalu):
        sh = parse_slice_header(nalu.rbsp, nalu.nal_type, nalu.temporal_id,
                                self.sps_map, self.pps_map)
        if sh.dependent:
            # dependent slice segments inherit everything (incl. poc_lsb for
            # the POC derivation below) but the segment address / entry
            # points (Rec. 7.4.7.1)
            import copy
            base = copy.copy(self._last_indep_sh)
            base.dependent = 1
            base.first_slice_in_pic = 0
            base.segment_address = sh.segment_address
            base.entry_points = sh.entry_points
            base.data_bit_offset = sh.data_bit_offset
            sh = base
        else:
            self._last_indep_sh = sh
        pps = self.pps_map[sh.pps_id]
        sps = self.sps_map[pps.sps_id]

        if sh.first_slice_in_pic:
            self._finish_picture()

        # POC derivation (Rec. H.265 8.3.1)
        if N.is_idr(nalu.nal_type):
            poc = 0
        else:
            max_lsb = 1 << sps.log2_max_poc_lsb
            prev_lsb = self.prev_tid0_poc & (max_lsb - 1)
            prev_msb = self.prev_tid0_poc - prev_lsb
            if N.is_bla(nalu.nal_type) or (N.is_irap(nalu.nal_type) and
                                           self.new_sequence):
                msb = 0
                poc = sh.poc_lsb
            else:
                if sh.poc_lsb < prev_lsb and prev_lsb - sh.poc_lsb >= max_lsb // 2:
                    msb = prev_msb + max_lsb
                elif sh.poc_lsb > prev_lsb and sh.poc_lsb - prev_lsb > max_lsb // 2:
                    msb = prev_msb - max_lsb
                else:
                    msb = prev_msb
                poc = msb + sh.poc_lsb
        sh.poc = poc
        if nalu.temporal_id == 0 and not N.is_rasl(nalu.nal_type) and \
                not N.is_radl(nalu.nal_type) and \
                not N.is_sublayer_non_ref(nalu.nal_type):
            self.prev_tid0_poc = poc

        # RASL skip after CRA that starts the sequence / after BLA
        if N.is_irap(nalu.nal_type):
            self.no_rasl_output = N.is_idr(nalu.nal_type) or \
                N.is_bla(nalu.nal_type) or self.new_sequence
            if sh.first_slice_in_pic:
                self.assoc_irap_type = nalu.nal_type
                self.assoc_irap_no_rasl_output = self.no_rasl_output
        if N.is_rasl(nalu.nal_type) and getattr(self, "assoc_irap_no_rasl_output", False):
            return  # skipped RASL picture

        if sh.first_slice_in_pic:
            # start new picture
            if N.is_irap(nalu.nal_type) and self.no_rasl_output:
                # NoOutputOfPriorPicsFlag: inferred 1 for CRA w/ NoRaslOutput
                no_output = sh.no_output_of_prior_pics or \
                    nalu.nal_type == N.NAL_CRA
                self._flush_dpb_for_irap(no_output)
            self._apply_rps_retirement(sh, sps)
            self._release_device_planes()
            pic = PicSyntax(sps, pps, alloc_maps=(self.parse != "native"))
            sd = SliceDecoder(sps, pps, pic)
            if sh.slice_type != I_SLICE:
                from .motion import MotionDeriver
                sd.motion = MotionDeriver(sd, sh, self._build_ref_lists(sh, sps))
            self.cur = (sh, pic, sd, nalu)
            self.new_sequence = False
            self.slice_count = 0
            self._cur_slice_id = 0
            # prefix SEI received since the previous picture belongs to
            # this access unit
            self._cur_sei = self._pending_prefix_sei
            self._pending_prefix_sei = []
        sh_first = self.cur[0]
        pic, sd = self.cur[1], self.cur[2]
        if self.parse == "native":
            self.slice_count += 1
            return
        if not sh.first_slice_in_pic and sh.slice_type != I_SLICE:
            from .motion import MotionDeriver
            sd.motion = MotionDeriver(sd, sh, self._build_ref_lists(sh, sps))
        if not sh.first_slice_in_pic:
            scan_pos = None
            if self.pps_map[sh.pps_id].tiles_enabled:
                scan_pos = {a: i for i, a in enumerate(sd.ctu_scan_order())}
            pic.drop_products_from_ctu(sh.segment_address, scan_pos)
        sh.epb_positions = nalu.epb_positions  # entry-point EBSP adjust
        if sh.dependent:
            # dependent segments share their slice's id for availability
            # (a CHAIN of dependent segments keeps the same id)
            sd.decode_slice(nalu.rbsp, sh, self._cur_slice_id)
        else:
            self._cur_slice_id = self.slice_count
            sd.decode_slice(nalu.rbsp, sh, self.slice_count)
            self.slice_count += 1

    # ------------------------------------------------------------------
    def _build_ref_lists(self, sh, sps):
        """Apply the RPS and construct RefPicList0/1 (Rec. 8.3.2-8.3.4)."""
        poc = sh.poc
        st_curr_before, st_curr_after, lt_curr = [], [], []
        rps = sh.rps
        for i in range(rps.num_pics):
            ref_poc = poc + rps.delta_poc[i]
            p = self._find_dpb(ref_poc)
            if rps.used[i]:
                if rps.delta_poc[i] < 0:
                    st_curr_before.append(p)
                else:
                    st_curr_after.append(p)
        max_lsb = 1 << sps.log2_max_poc_lsb
        for i in range(len(sh.lt_poc_lsb)):
            if sh.lt_msb_present[i]:
                ref_poc = sh.lt_poc_lsb[i] + poc - (poc & (max_lsb - 1)) - \
                    sh.lt_delta_poc_msb[i] * max_lsb
                p = self._find_dpb(ref_poc)
            else:
                p = self._find_dpb_lsb(sh.lt_poc_lsb[i], max_lsb)
            if p is not None:
                p.is_long_term = True
            if sh.lt_used[i]:
                lt_curr.append(p)
        # default order
        l0 = st_curr_before + st_curr_after + lt_curr
        l1 = st_curr_after + st_curr_before + lt_curr
        lists = []
        for li, (default, n_active) in enumerate(((l0, sh.num_ref_idx[0]),
                                                  (l1, sh.num_ref_idx[1]))):
            if not default:
                lists.append([])
                continue
            full = (default * ((n_active // max(1, len(default))) + 1))
            mods = sh.ref_pic_list_modification
            if mods and mods[li] is not None:
                sel = [default[j] for j in mods[li]]
            else:
                sel = full[:n_active]
            lists.append(sel)
        return lists

    def _find_dpb(self, poc):
        for p in self.dpb:
            if p.poc == poc and p.is_reference:
                return p
        # lost reference: fabricate by copying closest POC
        # (reference TDecTop::xCreateLostPicture)
        if self.dpb:
            best = min(self.dpb, key=lambda p: abs(p.poc - poc))
            return best
        return None

    def _find_dpb_lsb(self, lsb, max_lsb):
        for p in self.dpb:
            if (p.poc & (max_lsb - 1)) == lsb and p.is_reference:
                return p
        return None

    # ------------------------------------------------------------------
    def _verify_hash(self, dp):
        if self._pending_hash is None:
            return
        dph, self._pending_hash = self._pending_hash, None
        sps = dp.sps
        bds = [sps.bit_depth_luma] + [sps.bit_depth_chroma] * 2
        if dp.planes is not None:
            planes = []
            for c, p in enumerate(dp.planes):
                sx = sps.chroma_shift_x() if c else 0
                sy = sps.chroma_shift_y() if c else 0
                planes.append(p[:sps.height >> sy, :sps.width >> sx])
        elif sum(sps.conf_win) == 0:
            planes = dp.cropped_planes
        else:
            return  # native-recon planes are cropped; skip when cropped
        from . import sei
        dp.hash_status = "OK" if sei.verify_picture_hash(planes, bds, dph) \
            else "MISMATCH"

    def _finish_picture(self):
        if self.cur is None:
            return
        sh, pic, sd, nalu = self.cur
        self.cur = None
        sps = self.sps_map[self.pps_map[sh.pps_id].sps_id]

        if self.parse == "native":
            if self._native_pos >= len(self._native_queue) and \
                    self._native_stream is not None:
                # Python side decided to finish before the native parser saw
                # the next picture's first slice (API bump / EOF): flush it
                self._native_queue.extend(self._native_stream.flush())
            meta, npic = self._native_queue[self._native_pos]
            self._native_pos += 1
            assert meta["poc"] == sh.poc, (meta["poc"], sh.poc)
            if self.recon != "native":
                # resolve per-PU reference POCs to DecodedPicture objects
                for pu in npic.inter_list:
                    refs = [None, None]
                    for l in range(2):
                        if pu.inter_dir & (1 << l):
                            refs[l] = self._find_dpb(int(pu.ref_poc[l]))
                    pu.ref_poc = refs
            npic.sps = sps
            npic.pps = self.pps_map[sh.pps_id]
            pic = npic

        pps = self.pps_map[sh.pps_id]
        if self.recon == "native":
            assert self.parse == "native", "recon='native' needs parse='native'"
            planes = None
        elif self.recon in ("collect", "torch"):
            # collect: defer reconstruction, stash the parse products so a
            # batched backend (parallel/batch_decode) can run all pictures
            # in one device program; torch: the same item, reconstructed
            # on the device below, once its DecodedPicture exists
            planes = None
            item = dict(
                sps=sps, pps=pps, pic=pic, zmap=sd._zmap,
                tile_map=sd.tile_map, poc=sh.poc,
                temporal_id=nalu.temporal_id,
                output_flag=sh.pic_output_flag,
                pending_hash=self._pending_hash)
            if self.recon == "collect":
                if not hasattr(self, "collected"):
                    self.collected = []
                self.collected.append(item)
                self._pending_hash = None
        else:
            recon = self.recon_backend(sps, pic, sd._zmap, sd.tile_map)
            recon.constrained_intra = bool(pps.constrained_intra_pred)
            if pic.inter_list:
                from .motion import motion_compensate_np_vec
                planes = recon.reconstruct(None, motion_compensate_np_vec)
            else:
                planes = recon.reconstruct()

            # in-loop filters
            from .loopfilter_np import deblock_picture, sao_picture
            if pps.transquant_bypass_enabled or \
                    (sps.pcm_enabled and sps.pcm_loop_filter_disabled):
                pic.prefilter_planes = [p.copy() for p in planes]
            deblock_picture(planes, pic, sps, pps)
            if sps.sao_enabled:
                sao_picture(planes, pic, sps, pps)
            from .loopfilter_np import _restore_unfiltered
            _restore_unfiltered(planes, None, pic, sps)

        dp = DecodedPicture(sh.poc, planes, sps, nalu.temporal_id,
                            sh.pic_output_flag)
        dp.sei = getattr(self, "_cur_sei", [])
        self._cur_sei = []
        if self.recon == "native":
            dp.cropped_planes = meta["cropped"]
        elif self.recon == "collect":
            dp.cropped_planes = []   # real planes come from the batch recon
        dp.pic_syntax = pic
        dp.hash_status = None
        if self.recon == "collect":
            # batched backends fill dp.planes after DAG-ordered recon
            self.collected[-1]["dp"] = dp
        elif self.recon == "torch":
            # the hash check and the bumping below read the downloaded
            # planes; the device copies stay for later pictures' MC
            from ..recon_torch import reconstruct_picture
            item["dp"] = dp
            dp.planes = reconstruct_picture(item, self.device)
            self._resident.append(dp)
        if self.check_sei_hash:
            self._verify_hash(dp)
        self.dpb.append(dp)
        self._bump_outputs(sps, nalu.temporal_id)
        self._release_device_planes()

    def _release_device_planes(self):
        """Drop the device planes of pictures that left the DPB or that the
        RPS marked unused for reference: no later picture reads them for
        MC, and their host planes serve output.  A DPB picture may hold
        planes without being resident when a lost reference was made from
        it (recon_torch._device_plane uploads it), so the DPB is scanned
        too."""
        in_dpb = {id(p) for p in self.dpb}
        held = {id(p): p for p in self._resident + self.dpb
                if hasattr(p, "_device_planes")}
        self._resident = []
        for p in held.values():
            if p.is_reference and id(p) in in_dpb:
                self._resident.append(p)
            else:
                del p._device_planes

    def _apply_rps_retirement(self, sh, sps):
        """Unmark DPB pictures not present in the current RPS (Rec. 8.3.2)."""
        if N.is_idr(sh.nal_type) or N.is_bla(sh.nal_type):
            for p in self.dpb:
                p.is_reference = False
            return
        if sh.rps is None:
            return
        keep = set()
        for i in range(sh.rps.num_pics):
            keep.add(sh.poc + sh.rps.delta_poc[i])
        max_lsb = 1 << sps.log2_max_poc_lsb
        for i in range(len(sh.lt_poc_lsb)):
            if sh.lt_msb_present[i]:
                keep.add(sh.lt_poc_lsb[i] + sh.poc - (sh.poc & (max_lsb - 1)) -
                         sh.lt_delta_poc_msb[i] * max_lsb)
            else:
                for p in self.dpb:
                    if (p.poc & (max_lsb - 1)) == sh.lt_poc_lsb[i]:
                        keep.add(p.poc)
        for p in self.dpb:
            if p.poc not in keep:
                p.is_reference = False

    # ------------------------------------------------------------------
    def _flush_dpb_for_irap(self, no_output):
        """At an IRAP with NoRaslOutputFlag: bump or drop prior pictures."""
        if no_output:
            for p in self.dpb:
                p.needed_for_output = False
        self._output_all()

    def _output_all(self):
        for p in sorted(self.dpb, key=lambda q: q.poc):
            if p.needed_for_output:
                self.outputs.append(p.cropped())
                self.output_records.append(p)
                p.needed_for_output = False
        self.dpb = [p for p in self.dpb if p.is_reference]

    def _bump_outputs(self, sps, tid):
        """C.5.2.2-style bumping mirroring TAppDecTop::xWriteOutput."""
        num_reorder = sps.num_reorder_pics[sps.max_sub_layers_minus1]
        max_dpb = sps.max_dec_pic_buffering[sps.max_sub_layers_minus1]
        while True:
            not_displayed = sum(1 for p in self.dpb if p.needed_for_output)
            if not_displayed > num_reorder or len(self.dpb) >= max_dpb + 1:
                cands = [p for p in self.dpb if p.needed_for_output]
                if not cands:
                    # evict a non-output non-reference picture
                    self.dpb = [p for p in self.dpb
                                if p.is_reference or p.needed_for_output]
                    break
                p = min(cands, key=lambda q: q.poc)
                self.outputs.append(p.cropped())
                self.output_records.append(p)
                p.needed_for_output = False
                self.dpb = [q for q in self.dpb
                            if q.is_reference or q.needed_for_output]
            else:
                break

    def flush(self):
        self._finish_picture()
        self._output_all()
        self._release_device_planes()
