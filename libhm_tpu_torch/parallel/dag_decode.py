"""Reference-DAG batched, device-resident decode (PyTorch/CUDA port).

Port of libhm_tpu/parallel/dag_decode.py: the host Decoder runs its normal
control plane in collect mode (parse, DPB, bumping, hashes); this module
fills in the pixels.  Pictures are grouped by reference-chain depth ("DAG
level"); every level reconstructs in shared device launches and its pixels
stay on the device:

    coeff buckets --upload--> residual planes          (K1 per bucket)
    MC + residual add from the per-4x4 maps            (K5 per component,
                                                        K6 for WP levels)
    intra wavefront, levels x sizes                    (K2 per launch)
    deblock V/H + SAO, fed by int8 syntax maps          (K3, K4)
    filtered planes --(stay on device)--> next level's reference planes
    final planes --int16 download--> output pictures    (decode_batch)
    or a uint32 checksum of them --4 bytes-->           (K7, decode_batch_device)

Streams outside the slice raise NotImplementedError naming the missing
piece; nothing falls back to another backend.
"""
import numpy as np
import torch

from ..hostdec.picture import MODE_INTER
from ..ops import checksum as CK
from ..ops import interp as IK
from ..recon_torch import _device_plane
from ..utils import xfer


# ---------------------------------------------------------------------------
def reference_levels(items):
    """Group decode-order collect items into reference-DAG levels.

    Copied from libhm_tpu/parallel/dag_decode.py (reference_levels).
    Dependency = the set of DecodedPicture objects this picture's PUs
    gather from (object identity, so repeated POCs after an IDR are
    distinct).  Returns a list of lists of items.
    """
    level_of = {}
    levels = []
    for it in items:
        deps = set()
        for pu in it["pic"].inter_list:
            for l in range(2):
                rp = pu.ref_poc[l]
                if rp is not None:
                    deps.add(id(rp))
        lv = 0
        for d in deps:
            lv = max(lv, level_of.get(d, -1) + 1)
        level_of[id(it["dp"])] = lv
        while len(levels) <= lv:
            levels.append([])
        levels[lv].append(it)
    return levels


def _check_slice(items):
    """Raise NotImplementedError for coding tools the port lacks."""
    for it in items:
        sps, pps, pic = it["sps"], it["pps"], it["pic"]
        missing = []
        if pic.pcm_list or (sps.pcm_enabled and
                            sps.pcm_loop_filter_disabled):
            missing.append("PCM")
        if pps.transquant_bypass_enabled:
            missing.append("transquant bypass")
        if sps.scaling_list_enabled:
            missing.append("scaling lists")
        if pps.cross_component_prediction:
            missing.append("cross-component prediction")
        if np.asarray(pic.slice_idx).max() > 0:
            missing.append("several slices per picture")
        if pps.tiles_enabled:
            missing.append("tiles")
        if sps.chroma_format_idc != 1:
            missing.append(f"chroma format {sps.chroma_format_idc} "
                           "(only 4:2:0)")
        if sps.extended_precision or sps.implicit_rdpcm or \
                sps.explicit_rdpcm or sps.transform_skip_rotation:
            missing.append("RExt residual tools (extended precision, "
                           "RDPCM, transform-skip rotation)")
        if max(sps.bit_depth_luma, sps.bit_depth_chroma) > 12:
            missing.append("bit depths above 12")
        if missing:
            raise NotImplementedError(
                "libhm_tpu_torch decode_batch: not ported: " +
                ", ".join(missing))


def _check_geometry(items, what):
    sps0 = items[0]["sps"]
    for it in items:
        if (it["sps"].width, it["sps"].height,
                it["sps"].chroma_format_idc) != \
                (sps0.width, sps0.height, sps0.chroma_format_idc):
            raise ValueError(f"{what}: mixed picture geometry")


# ---------------------------------------------------------------------------
def _level_refs(items):
    """Reference pictures of a level, by object identity (POCs repeat
    across IRAPs), and each picture's {poc: DecodedPicture}.

    Copied from the host map building of libhm_tpu/parallel/dag_decode.py
    (_inter_level_grid, _inter_level_gathered).
    """
    ref_index = {}
    ref_objs = []
    per_pic = []
    for it in items:
        pocs = {}
        for pu in it["pic"].inter_list:
            for l in range(2):
                rp = pu.ref_poc[l]
                if rp is not None and rp.poc not in pocs:
                    pocs[rp.poc] = rp
        for rp in pocs.values():
            if id(rp) not in ref_index:
                ref_index[id(rp)] = len(ref_objs)
                ref_objs.append(rp)
        per_pic.append(pocs)
    return ref_index, ref_objs, per_pic


def _ref_stack(ref_objs, c, H, W, device):
    """[R, H, W] int32 reference planes of component c (no pow2 padding
    of R: nothing here is keyed by shape)."""
    return torch.stack([_device_plane(rp, c, H, W, device)
                        for rp in ref_objs])


def _comp_geometry(sps, c):
    sx = sps.chroma_shift_x() if c else 0
    sy = sps.chroma_shift_y() if c else 0
    bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
    return sx, sy, bd, sps.width >> sx, sps.height >> sy


def _inter_level_grid(items, stacked_all, res_all, device):
    """Map-driven MC for a level with no weighted prediction (K5).

    Port of libhm_tpu/parallel/dag_decode.py _inter_level_grid; the host
    map building is copied from it.
    """
    sps0 = items[0]["sps"]
    ncomp = 3 if sps0.chroma_format_idc else 1
    Bp = int(stacked_all[0].shape[0])
    pic0 = items[0]["pic"]
    h4, w4 = pic0.h4, pic0.w4

    ref_index, ref_objs, per_pic = _level_refs(items)
    mv_maps = np.zeros((Bp, h4, w4, 2, 2), np.int16)
    dir_maps = np.zeros((Bp, h4, w4), np.int8)
    sel_maps = np.zeros((Bp, h4, w4, 2), np.int16)
    any_inter = False
    for b, it in enumerate(items):
        pic = it["pic"]
        if not pic.inter_list:
            continue
        dirm = np.where(np.asarray(pic.pred_mode) == MODE_INTER,
                        np.asarray(pic.inter_dir), 0)
        if not dirm.any():
            continue
        any_inter = True
        pocs = per_pic[b]
        mv_maps[b] = np.asarray(pic.mv).astype(np.int16)
        dir_maps[b] = dirm
        local = np.asarray(sorted(pocs), np.int64)
        l2g = np.asarray([ref_index[id(pocs[int(p)])] for p in local],
                         np.int16)
        rpm = np.asarray(pic.ref_poc)
        posn = np.clip(np.searchsorted(local, rpm), 0, len(local) - 1)
        sel_maps[b] = l2g[posn]
    if not any_inter:
        return

    # one upload of the per-4x4 syntax maps, shared by all components
    mv_dev = xfer.up(mv_maps, "mc", device)
    dir_dev = xfer.up(dir_maps, "mc", device)
    sel_dev = xfer.up(sel_maps, "mc", device)
    for c in range(ncomp):
        sx, sy, bd, W, H = _comp_geometry(sps0, c)
        IK.mc_grid(stacked_all[c], res_all[c],
                   _ref_stack(ref_objs, c, H, W, device), mv_dev, dir_dev,
                   sel_dev, is_luma=c == 0, sx=sx, sy=sy, bd=bd, W=W, H=H)


def _inter_level(items, stacked_all, res_all, device):
    """Batched MC + residual add for every inter block of one DAG level.

    Port of libhm_tpu/parallel/dag_decode.py _inter_level.
    stacked_all: list per component of device [Bp, H, W] planes (updated
    in place); res_all: list per component of device residual planes.
    Levels without weighted prediction take the map-driven full-grid path
    (K5); WP levels take per-block arrays with the WP epilogue (K6).
    """
    if not any(getattr(pu, "wp", None) is not None
               for it in items for pu in it["pic"].inter_list):
        return _inter_level_grid(items, stacked_all, res_all, device)
    return _inter_level_gathered(items, stacked_all, res_all, device)


def _inter_level_gathered(items, stacked_all, res_all, device):
    """Per-block MC for a level with weighted prediction (K6).

    Port of libhm_tpu/parallel/dag_decode.py _inter_level_gathered; the
    host map building is copied from it.  Blocks go in one launch per
    (component, epilogue, denominator) group, as the JAX dispatch groups.
    """
    sps0 = items[0]["sps"]
    ncomp = 3 if sps0.chroma_format_idc else 1

    ref_index, ref_objs, pocs_of = _level_refs(items)
    per_pic = []
    for b, it in enumerate(items):
        pic = it["pic"]
        inter4 = np.asarray(pic.pred_mode) == MODE_INTER
        if not inter4.any():
            per_pic.append(None)
            continue
        pocs = pocs_of[b]
        ys4, xs4 = np.nonzero(inter4)
        dirm = np.asarray(pic.inter_dir)[ys4, xs4].astype(np.int32)
        mv = np.asarray(pic.mv)[ys4, xs4].astype(np.int32)
        refpoc = np.asarray(pic.ref_poc)[ys4, xs4]
        sel = np.zeros((len(ys4), 2), np.int32)
        for l in range(2):
            used = (dirm & (1 << l)) != 0
            sel[used, l] = [ref_index[id(pocs[p])] for p in refpoc[used, l]]
        # weighted prediction maps
        has_wp = any(getattr(pu, "wp", None) is not None
                     for pu in pic.inter_list)
        wpw = wpo = None
        denom_l = denom_c = 0
        if has_wp:
            wpw = np.zeros((pic.h4, pic.w4, 2, 3), np.int32)
            wpo = np.zeros((pic.h4, pic.w4, 2, 3), np.int32)
            for pu in pic.inter_list:
                if pu.wp is None:
                    continue
                sl = np.s_[pu.y >> 2:(pu.y + pu.h) >> 2,
                           pu.x >> 2:(pu.x + pu.w) >> 2]
                wpw[sl] = np.asarray(pu.wp["w"])
                wpo[sl] = np.asarray(pu.wp["o"])
                denom_l = pu.wp["denom_l"]
                denom_c = pu.wp["denom_c"]
        per_pic.append(dict(ys4=ys4, xs4=xs4, dirm=dirm, mv=mv, sel=sel,
                            has_wp=has_wp, wpw=wpw, wpo=wpo,
                            denom_l=denom_l, denom_c=denom_c))
    if not ref_objs:
        return

    for c in range(ncomp):
        sx, sy, bd, W, H = _comp_geometry(sps0, c)
        refs = _ref_stack(ref_objs, c, H, W, device)
        # dispatch groups keyed by WP epilogue + denom (per-slice values)
        groups = {}
        for b, pp in enumerate(per_pic):
            if pp is None:
                continue
            denom = (pp["denom_l"] if c == 0 else pp["denom_c"])
            key = ("wp", denom) if pp["has_wp"] else ("plain", 0)
            groups.setdefault(key, []).append(b)
        for (epi, denom), bs in groups.items():
            def cat(k):
                return np.concatenate([per_pic[b][k] for b in bs])
            ys4, xs4 = cat("ys4"), cat("xs4")
            N = len(ys4)
            blk = np.zeros((N, len(IK.BLK_FIELDS)), np.int32)
            blk[:, 0] = np.concatenate(
                [np.full(len(per_pic[b]["ys4"]), b, np.int32) for b in bs])
            blk[:, 1] = (xs4 << 2) >> sx
            blk[:, 2] = (ys4 << 2) >> sy
            blk[:, 3] = cat("dirm")
            blk[:, 4:8] = cat("mv").reshape(N, 4)
            blk[:, 8:10] = cat("sel")
            if epi == "wp":
                blk[:, 10:12] = np.concatenate(
                    [per_pic[b]["wpw"][per_pic[b]["ys4"],
                                       per_pic[b]["xs4"]][:, :, c]
                     for b in bs])
                blk[:, 12:14] = np.concatenate(
                    [per_pic[b]["wpo"][per_pic[b]["ys4"],
                                       per_pic[b]["xs4"]][:, :, c]
                     for b in bs]) * (1 << (bd - 8))
            IK.mc_weighted(stacked_all[c], res_all[c], refs,
                           xfer.up(blk, "mc", device), is_luma=c == 0,
                           sx=sx, sy=sy, bd=bd, wp=epi == "wp", denom=denom,
                           W=W, H=H)


# ---------------------------------------------------------------------------
def _recon_levels(items, device, download=True):
    """Device-resident reconstruction of collect items grouped into
    reference-DAG levels.  Returns [(dp, item, small_planes)] where
    small_planes are the padded output planes narrowed to int16 on the
    device (downloaded by _materialize).

    Each picture's filtered planes stay on the device as
    dp._device_planes[(c, H, W)] (views of the level's planes): later
    levels predict from them with no host round trip.  download=False
    makes no narrow copies (small_planes empty): decode_batch_device reads
    the pixels through dp._device_planes.
    """
    from .batch_decode import _intra_batch, _residual_planes_batch_device
    from .device_filters import filter_level

    _check_slice(items)
    sps0 = items[0]["sps"]
    ncomp = 3 if sps0.chroma_format_idc else 1
    pending = []
    for lv_items in reference_levels(items):
        B = len(lv_items)
        res_stacked = _residual_planes_batch_device(lv_items, B, device)
        stacked = [torch.zeros_like(r) for r in res_stacked]
        # MC first: intra blocks of inter pictures predict from
        # MC-reconstructed neighbours
        _inter_level(lv_items, stacked, res_stacked, device)
        for c in range(ncomp):
            stacked[c] = _intra_batch(lv_items, c, stacked[c],
                                      res_stacked[c], device)
        stacked = filter_level(lv_items, stacked, sps0, device)
        for b, it in enumerate(lv_items):
            sps = it["sps"]
            cache = {}
            small = []
            for c in range(ncomp):
                sx, sy, _, Wc, Hc = _comp_geometry(sps, c)
                cache[(c, Hc, Wc)] = stacked[c][b, :Hc, :Wc]
                if download:
                    # samples are < 2^12, so int16 holds them (torch's
                    # uint16 support is thin); _materialize widens back
                    small.append(stacked[c][b].to(torch.int16))
            it["dp"]._device_planes = cache
            pending.append((it["dp"], it, small))
    return pending


def _materialize(dec, pending, check_sei_hash):
    """Download pending planes, run hash checks, rebuild dec.outputs."""
    for dp, it, small in pending:
        planes = []
        for s in small:
            a = s.cpu().numpy()
            xfer.count_d2h(a.nbytes)
            planes.append(a.astype(np.int32))
        dp.planes = planes
        dp.cropped_planes = None
        if check_sei_hash and it["pending_hash"] is not None:
            dec._pending_hash = it["pending_hash"]
            dec._verify_hash(dp)
    # rebuild the output list now that pixels exist (bumping order was
    # already decided by the control plane during parsing)
    dec.outputs = [dp.cropped() for dp in dec.output_records]
    return dec.outputs


def _check_device(device, what):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA device requested but "
                           "torch.cuda.is_available() is false")
    return device


def decode_batch(data, *, device="cuda", parse="native",
                 check_sei_hash=False):
    """Decode an Annex-B stream with reference-DAG cross-picture batching
    and a device-resident pixel path on `device` (the card by default; the
    CPU runs the plain torch versions of the kernels).

    Bit-exact vs the JAX decode_batch / the HM hash oracle.  Returns the
    cropped pictures in output order (Decoder.outputs shape).
    """
    from ..hostdec.decoder import Decoder

    device = _check_device(device, "decode_batch")
    dec = Decoder(parse=parse, recon="collect",
                  check_sei_hash=check_sei_hash)
    dec.decode_annexb(data)
    items = getattr(dec, "collected", [])
    if not items:
        return []
    _check_geometry(items, "decode_batch")
    pending = _recon_levels(items, device)
    return _materialize(dec, pending, check_sei_hash)


def decode_batch_device(data, *, device="cuda", parse="native"):
    """Device-compute decode: host parse + device-resident reconstruction,
    downloading nothing but one uint32 checksum (K7).

    Port of libhm_tpu/parallel/dag_decode.py decode_batch_device.  The
    decoded pictures stay on the device, as a device-resident consumer
    would use them; the checksum (every conformance-cropped output sample,
    mod 2^32, in DecodedPicture.cropped() geometry, over the bumped output
    list) lets the caller check the run against cropped_checksum of a
    decode of the same stream.

    Returns (parse_seconds, compute_seconds, checksum_int, n_pictures).
    """
    import time

    from ..hostdec.decoder import Decoder

    device = _check_device(device, "decode_batch_device")
    dec = Decoder(parse=parse, recon="collect")
    t0 = time.monotonic()
    dec.decode_annexb(data)
    t1 = time.monotonic()
    items = getattr(dec, "collected", [])
    if not items:
        return t1 - t0, 0.0, 0, 0
    _check_geometry(items, "decode_batch_device")
    pending = _recon_levels(items, device, download=False)
    views = []
    # sum over the bumped output list so the checksum covers exactly the
    # pictures (and geometry) that cropped_checksum(Decoder.outputs) sees
    for dp in dec.output_records:
        sps = dp.sps
        ncomp = 3 if sps.chroma_format_idc else 1
        cl, cr, ct, cb = sps.conf_win
        for c in range(ncomp):
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            w = sps.width >> sx
            h = sps.height >> sy
            mulx = 1 if c else (1 << sps.chroma_shift_x())
            muly = 1 if c else (1 << sps.chroma_shift_y())
            view = dp._device_planes[(c, h, w)]
            views.append(view[ct * muly:h - cb * muly,
                              cl * mulx:w - cr * mulx])
    csum = 0
    if views:
        acc = CK.plane_checksum(views)
        csum = int(acc.cpu().item()) & 0xFFFFFFFF
        xfer.count_d2h(4)
    t2 = time.monotonic()
    return t1 - t0, t2 - t1, csum, len(pending)


def cropped_checksum(outs):
    """Host-side counterpart of decode_batch_device's checksum: uint32 sum
    of every sample of a list of cropped pictures (Decoder.outputs).

    Copied from libhm_tpu/parallel/dag_decode.py (cropped_checksum).
    """
    tot = 0
    for pic in outs:
        for p in pic:
            tot = (tot + int(np.asarray(p, np.uint64).sum())) & 0xFFFFFFFF
    return tot
