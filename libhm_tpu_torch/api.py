# Copied from libhm_tpu/api.py
"""libHMDec-compatible decoding API.

Rebuild of the reference fork's C wrapper (reference: source/App/
libHMDecoder/libHMDecoder.h:111-298 and .cpp) with the same call protocol:

  dec = new_decoder()                      <- libHMDec_new_decoder
  push_nal_unit(dec, nal, eof)             <- libHMDec_push_nal_unit
      returns (new_picture, check_output); on new_picture=True the SAME NAL
      must be pushed again (the reference's re-feed contract,
      libHMDecoder.cpp:112-180)
  get_picture(dec)                         <- libHMDec_get_picture
      returns the next output picture or None (C.5.2 bumping,
      libHMDecoder.cpp:255-339)
  get_internal_info(dec, pic, type)        <- libHMDEC_get_internal_info
      per-block coding metadata (pred mode, MVs, ...) as (x, y, w, h,
      value, value2) tuples, from the parse-plane tensors.

The reference wrapper exists so GUI tools (YUView) can inspect streams;
this module exposes the identical information from the flat tensors.

Pictures reconstruct on the card by default (recon="torch", device="cuda":
each picture as soon as the control plane finishes it, its reference
planes kept on the device); recon="numpy" and recon="native" are the host
backends.  A CUDA device that is absent raises; nothing falls back.
"""
import numpy as np

from .hostdec import nal as N
from .hostdec.decoder import Decoder as _CoreDecoder


class Picture:
    def __init__(self, dp, pic_syntax):
        self._dp = dp
        self._syntax = pic_syntax
        self.planes = dp.cropped()
        self.hash_status = getattr(dp, "hash_status", None)

    @property
    def poc(self):
        return self._dp.poc

    def get_width(self, channel=0):
        return self.planes[channel].shape[1]

    def get_height(self, channel=0):
        return self.planes[channel].shape[0]

    def get_plane(self, channel):
        return self.planes[channel]

    def get_bit_depth(self, channel=0):
        sps = self._dp.sps
        return sps.bit_depth_luma if channel == 0 else sps.bit_depth_chroma

    def get_chroma_format(self):
        return self._dp.sps.chroma_format_idc


# internal info types (mirror libHMDec_info_type, libHMDecoder.h:254-280)
CU_PREDICTION_MODE = "cu_prediction_mode"
CU_TRANSQUANT_BYPASS = "cu_transquant_bypass"
CU_SKIP_FLAG = "cu_skip_flag"
CU_PART_MODE = "cu_part_mode"
CU_INTRA_MODE_LUMA = "cu_intra_mode_luma"
CU_INTRA_MODE_CHROMA = "cu_intra_mode_chroma"
CTU_SLICE_INDEX = "ctu_slice_index"
PU_MERGE_FLAG = "pu_merge_flag"
PU_MERGE_INDEX = "pu_merge_index"
PU_UNI_BI_PREDICTION = "pu_uni_bi"
PU_REFERENCE_POC_0 = "pu_ref_poc_0"
PU_MV_0 = "pu_mv_0"
PU_REFERENCE_POC_1 = "pu_ref_poc_1"
PU_MV_1 = "pu_mv_1"
TU_CBF_Y = "tu_cbf_y"
TU_CBF_CB = "tu_cbf_cb"
TU_CBF_CR = "tu_cbf_cr"
TU_TRANSFORM_SKIP_Y = "tu_transform_skip_y"
TU_TRANSFORM_SKIP_CB = "tu_transform_skip_cb"
TU_TRANSFORM_SKIP_CR = "tu_transform_skip_cr"
TU_COEFF_ENERGY_Y = "tu_coeff_energy_y"
TU_COEFF_ENERGY_CB = "tu_coeff_energy_cb"
TU_COEFF_ENERGY_CR = "tu_coeff_energy_cr"


class HmDecoder:
    """Stateful NAL-push decoder preserving the libHMDec protocol."""

    def __init__(self, parse="native", recon="torch", device="cuda"):
        if recon == "native" and parse != "native":
            # native recon consumes the native parser's picture tensors
            parse = "native"
        self._core = _CoreDecoder(parse=parse, recon=recon, device=device)
        self._out_queue = []
        self._out_pos = 0
        self._pending_syntax = {}

    # ------------------------------------------------------------------
    def push_nal_unit(self, nal_bytes: bytes, eof: bool = False):
        """Push one NAL (with or without start code).

        Returns (is_new_picture, check_output_pictures).  When
        is_new_picture is True the caller must push the same NAL again —
        the reference wrapper's re-feed contract.
        """
        data = nal_bytes
        for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
            if data.startswith(sc):
                data = data[len(sc):]
                break
        nalu = N.parse_nal(data)
        core = self._core
        n_before = len(core.outputs)
        # detect "new picture": a VCL NAL with first_slice flag while a
        # picture is open.  Mirror the reference contract: finish/bump the
        # open picture, do NOT consume this NAL, and require a re-push
        # (TDecTop returns bNewPicture=true; TAppDecTop seeks back).
        if N.is_vcl(nalu.nal_type) and core.cur is not None and len(data) > 2:
            if (data[2] >> 7) & 1:
                core._finish_picture()
                return True, len(core.outputs) > n_before
        core.decode_nal(nalu)
        if eof:
            core.flush()
        check_output = len(core.outputs) > n_before or eof
        return False, check_output

    def flush(self):
        self._core.flush()

    def get_picture(self):
        """Next output picture in display order, or None."""
        core = self._core
        if self._out_pos < len(core.outputs):
            planes = core.outputs[self._out_pos]
            dp = core.output_records[self._out_pos] \
                if hasattr(core, "output_records") else None
            self._out_pos += 1
            p = Picture.__new__(Picture)
            p.planes = planes
            p._dp = dp
            p._syntax = dp.pic_syntax if dp is not None else None
            p.hash_status = getattr(dp, "hash_status", None)
            return p
        return None

    def set_sei_check(self, enable: bool):
        # decoded-picture-hash SEI verification (libHMDec_set_SEI_Check);
        # per-picture status exposed as HmPicture.hash_status
        self._sei_check = enable
        self._core.check_sei_hash = enable

    def set_max_temporal_layer(self, layer: int):
        self._core.max_temporal_layer = layer

    # ------------------------------------------------------------------
    def get_internal_info(self, picture, info_type):
        """Per-block metadata as (x, y, w, h, value, value2) tuples.

        CU types are emitted at CU-rectangle granularity (anchors from the
        depth map, mirroring libHMDecoder.cpp:451-715's quadtree walk), PU
        types per inter PU, TU types per coded transform block.
        """
        syn = picture._syntax
        if syn is None:
            return []
        sps = picture._dp.sps
        out = []
        if info_type == CTU_SLICE_INDEX:
            ctb = 1 << sps.log2_ctb
            s4 = np.asarray(syn.slice_idx)
            for cy in range(sps.pic_height_ctbs):
                for cx in range(sps.pic_width_ctbs):
                    out.append((cx * ctb, cy * ctb, ctb, ctb,
                                int(s4[cy * (ctb >> 2), cx * (ctb >> 2)]), 0))
            return out
        m = {
            CU_PREDICTION_MODE: syn.pred_mode,
            CU_TRANSQUANT_BYPASS: syn.tq_bypass,
            CU_SKIP_FLAG: syn.skip,
            CU_PART_MODE: syn.part_size,
            CU_INTRA_MODE_LUMA: syn.intra_y,
            CU_INTRA_MODE_CHROMA: syn.intra_c,
        }
        if info_type in m:
            arr = np.asarray(m[info_type])
            depth = np.asarray(syn.depth)
            s4 = np.asarray(syn.slice_idx)
            ctb4 = (1 << sps.log2_ctb) >> 2
            h4, w4 = arr.shape
            intra_only = info_type in (CU_INTRA_MODE_LUMA,
                                       CU_INTRA_MODE_CHROMA)
            pm = np.asarray(syn.pred_mode)
            for y4 in range(h4):
                for x4 in range(w4):
                    if s4[y4, x4] < 0:
                        continue  # outside the coded picture
                    size4 = max(1, ctb4 >> int(depth[y4, x4]))
                    if x4 % size4 or y4 % size4:
                        continue  # not the CU anchor
                    if intra_only and pm[y4, x4] != 1:
                        continue
                    out.append((x4 * 4, y4 * 4, size4 * 4, size4 * 4,
                                int(arr[y4, x4]), 0))
            return out
        if info_type in (PU_UNI_BI_PREDICTION, PU_MERGE_FLAG, PU_MERGE_INDEX,
                         PU_REFERENCE_POC_0, PU_MV_0,
                         PU_REFERENCE_POC_1, PU_MV_1):
            for pu in syn.inter_list:
                if info_type == PU_UNI_BI_PREDICTION:
                    out.append((pu.x, pu.y, pu.w, pu.h, pu.inter_dir, 0))
                elif info_type == PU_MERGE_FLAG:
                    out.append((pu.x, pu.y, pu.w, pu.h,
                                int(getattr(pu, "merge", 0)), 0))
                elif info_type == PU_MERGE_INDEX:
                    if getattr(pu, "merge", 0):
                        out.append((pu.x, pu.y, pu.w, pu.h,
                                    int(pu.merge_idx), 0))
                elif info_type == PU_MV_0:
                    out.append((pu.x, pu.y, pu.w, pu.h,
                                int(pu.mv[0][0]), int(pu.mv[0][1])))
                elif info_type == PU_MV_1:
                    out.append((pu.x, pu.y, pu.w, pu.h,
                                int(pu.mv[1][0]), int(pu.mv[1][1])))
                elif info_type == PU_REFERENCE_POC_0:
                    rp = pu.ref_poc[0]
                    out.append((pu.x, pu.y, pu.w, pu.h,
                                rp.poc if hasattr(rp, "poc") and rp else -1, 0))
                elif info_type == PU_REFERENCE_POC_1:
                    rp = pu.ref_poc[1]
                    out.append((pu.x, pu.y, pu.w, pu.h,
                                rp.poc if hasattr(rp, "poc") and rp else -1, 0))
            return out
        tu_types = {
            TU_CBF_Y: 0, TU_CBF_CB: 1, TU_CBF_CR: 2,
            TU_TRANSFORM_SKIP_Y: 0, TU_TRANSFORM_SKIP_CB: 1,
            TU_TRANSFORM_SKIP_CR: 2,
            TU_COEFF_ENERGY_Y: 0, TU_COEFF_ENERGY_CB: 1,
            TU_COEFF_ENERGY_CR: 2,
        }
        if info_type in tu_types:
            comp = tu_types[info_type]
            sx = sps.chroma_shift_x() if comp else 0
            sy = sps.chroma_shift_y() if comp else 0
            for tu in syn.tu_list:
                if tu.comp != comp:
                    continue
                lx, ly = tu.x << sx, tu.y << sy
                lw, lh = tu.w << sx, tu.h << sy
                if info_type in (TU_CBF_Y, TU_CBF_CB, TU_CBF_CR):
                    out.append((lx, ly, lw, lh, 1, 0))
                elif info_type in (TU_TRANSFORM_SKIP_Y, TU_TRANSFORM_SKIP_CB,
                                   TU_TRANSFORM_SKIP_CR):
                    out.append((lx, ly, lw, lh, int(tu.transform_skip), 0))
                else:
                    e = int(np.minimum(
                        (np.asarray(tu.coeffs, np.int64) ** 2).sum(),
                        2 ** 31 - 1))
                    out.append((lx, ly, lw, lh, e, 0))
            return out
        raise ValueError(info_type)


def new_decoder(**kw):
    return HmDecoder(**kw)
