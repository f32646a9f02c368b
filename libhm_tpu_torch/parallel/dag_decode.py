"""Reference-DAG batched, device-resident decode (PyTorch/CUDA port).

Port of libhm_tpu/parallel/dag_decode.py: the host Decoder runs its normal
control plane in collect mode (parse, DPB, bumping, hashes); this module
fills in the pixels.  Pictures are grouped by reference-chain depth ("DAG
level"); every level reconstructs in shared device launches and its pixels
stay on the device:

    coeff buckets --upload--> residual planes          (K1 per bucket)
    cross-component prediction (4:4:4)                 (K10 per chroma
                                                        component)
    PCM samples into the zeroed planes                 (K9 per component)
    MC + residual add from the per-4x4 maps            (K5 per component,
                                                        K6 for WP levels)
    intra wavefront, levels x sizes                    (K2 per launch)
    deblock V/H + SAO, fed by int8 syntax maps          (K3, K4)
    PCM / lossless samples back to their pre-deblock    (K8)
    values
    filtered planes --(stay on device)--> next level's reference planes
    final planes --16-bit download--> output pictures   (decode_batch)
    or a uint32 checksum of them --4 bytes-->           (K7, decode_batch_device)

Chroma formats 4:0:0 (one plane), 4:2:0, 4:2:2 and 4:4:4 and bit depths
8 to 16 decode; `decode_streams` merges the levels of several streams of
one geometry into the same launches.  With a `devices=` list, each level's
pictures split into contiguous shards over the listed devices (the picture
axis of the JAX `mesh=`), and each device runs the whole pipeline above on
its shard; a reference made on another device comes over as a counted
peer copy (xfer.peer).  Where the JAX package departs from H.265 the
port follows H.265: cross-component prediction scales the luma residual
by the two bit depths (8.6.6), and weighted prediction under
high_precision_offsets_enabled_flag takes its offsets unshifted
(7.4.7.3).  Nothing falls back to another backend.

Each entry point is one request of the span recorder (utils/obs.py):
`decode` holds `parse` (its parts `parse.native`, `parse.export`,
`parse.control`), `recon` with one `recon.level` a level and shard (the
host preparation `prep.residual`, `prep.pcm`, `prep.inter`,
`prep.intra`, `prep.filter`, the copies `upload.<tag>`, the narrowing
copies `recon.narrow`), and a `download` a picture.
"""
import contextlib
import contextvars

import numpy as np
import torch

from ..hostdec.motion import wp_offset_shift
from ..hostdec.picture import MODE_INTER
from ..ops import checksum as CK
from ..ops import interp as IK
from ..ops import pcm as PK
from ..recon_torch import _device_plane
from ..utils import obs, xfer


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
    """[R, H, W] int32 reference planes of component c on `device` (no
    pow2 padding of R: nothing here is keyed by shape).  A plane that
    another device holds comes over as a peer copy, which lives only as
    long as this stack: nothing caches it on the picture."""
    return torch.stack([xfer.peer(_device_plane(rp, c, H, W, device), device)
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
    with obs.span("prep.inter", sum(
            int(np.count_nonzero(np.asarray(it["pic"].pred_mode) ==
                                 MODE_INTER)) for it in items)):
        if not any(getattr(pu, "wp", None) is not None
                   for it in items for pu in it["pic"].inter_list):
            return _inter_level_grid(items, stacked_all, res_all, device)
        return _inter_level_gathered(items, stacked_all, res_all, device)


def _tile_nonzero(mask):
    """np.nonzero of a per-4x4 map, in the order of K6's luma tiles (16x16
    samples, then raster inside each), so that IK.tile_groups finds a
    level's luma rows already sorted (any order is right; this one makes
    the host's sort a linear pass)."""
    n = IK.TILE // 4
    h4, w4 = mask.shape
    m = np.zeros((-(-h4 // n) * n, -(-w4 // n) * n), bool)
    m[:h4, :w4] = mask
    m = m.reshape(m.shape[0] // n, n, m.shape[1] // n, n)
    ty, tx, y, x = np.nonzero(m.transpose(0, 2, 1, 3))
    return ty * n + y, tx * n + x


def _inter_level_gathered(items, stacked_all, res_all, device):
    """Per-block MC for a level with weighted prediction (K6).

    Port of libhm_tpu/parallel/dag_decode.py _inter_level_gathered; the
    host map building is copied from it.  Blocks go in one launch per
    (component, epilogue, denominator) group, as the JAX dispatch groups;
    the blocks listed tile by tile (_tile_nonzero), luma's rows grouped by
    16x16 tile with the tile runs appended to the same upload
    (IK.tile_groups).
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
        ys4, xs4 = _tile_nonzero(inter4)
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
                # offsets at the sample's scale: << WpOffsetBdShift
                # (H.265 7.4.7.3), 0 under high_precision_offsets
                blk[:, 12:14] = np.concatenate(
                    [per_pic[b]["wpo"][per_pic[b]["ys4"],
                                       per_pic[b]["xs4"]][:, :, c]
                     << wp_offset_shift(items[b]["sps"], bd) for b in bs])
            if c == 0:
                # luma's kernel reads the rows in tile runs; chroma's takes
                # them in any order
                Bp, Hp, Wp = stacked_all[c].shape
                rows, runs = IK.tile_groups(blk, B=Bp, Hp=Hp, Wp=Wp)
                buf = xfer.up(np.concatenate([rows.ravel(), runs]), "mc",
                              device)
                table, runs = buf[:blk.size].view(blk.shape), buf[blk.size:]
            else:
                table, runs = xfer.up(blk, "mc", device), None
            IK.mc_weighted(stacked_all[c], res_all[c], refs, table,
                           groups=runs, is_luma=c == 0, sx=sx, sy=sy,
                           bd=bd, wp=epi == "wp", denom=denom, W=W, H=H)


def _pcm_level(items, stacked, device):
    """PCM samples of a level into its zeroed planes, before MC: one packed
    upload and one K9 launch for every component's blocks."""
    with obs.span("prep.pcm") as span:
        blocks = []
        for b, it in enumerate(items):
            sps = it["sps"]
            for (c, x, y, w, h, samples, bits) in it["pic"].pcm_list:
                bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
                blocks.append((c, b, x, y, w, h, bd - bits, samples))
        span.n = len(blocks)
        if blocks:
            buf, counts = PK.pcm_pack(blocks)
    if blocks:
        PK.pcm_level(stacked, PK.pcm_table(xfer.up(buf, "pcm", device),
                                           counts))


# ---------------------------------------------------------------------------
def _shards(lv_items, n):
    """Contiguous shards of ceil(B / n) pictures of one level's B pictures,
    as (k, items) for the k-th of n devices; devices past the last shard
    get none.  This is how the JAX mesh lays a level's picture axis out
    over its devices (NamedSharding over axis 0), without the padding."""
    per = -(-len(lv_items) // n)
    return [(k, lv_items[k * per:(k + 1) * per]) for k in range(n)
            if k * per < len(lv_items)]


def _on(device):
    """The context that makes a CUDA `device` current (kernels launch on
    the current device's stream); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else \
        contextlib.nullcontext()


def _recon_levels(items, devices, download=True):
    """Device-resident reconstruction of collect items grouped into
    reference-DAG levels.  Returns [(dp, item, small_planes)] where
    small_planes are the padded output planes narrowed to two bytes a
    sample on the device (downloaded by _materialize).

    devices: a list of devices: each level's pictures split into
    contiguous shards (_shards), shard k reconstructed on devices[k] (with
    that device current), every shard of a level enqueued before the next
    level starts; item["device_index"] records k.  The pictures of a level
    are independent, so the outputs do not depend on the split.

    Each picture's filtered planes stay on its device as
    dp._device_planes[(c, H, W)] (views of the shard's planes): later
    levels predict from them with no host round trip, through a peer copy
    when they run on another device.  download=False makes no narrow
    copies (small_planes empty): decode_batch_device reads the pixels
    through dp._device_planes.
    """
    devices = [_as_device(d) for d in devices]
    sps0 = items[0]["sps"]
    pending = []
    with obs.span("recon", len(items)):
        for lv_items in reference_levels(items):
            for k, shard in _shards(lv_items, len(devices)):
                with _on(devices[k]), obs.span("recon.level", len(shard)):
                    pending += _recon_shard(shard, sps0, devices[k],
                                            download)
                for it in shard:
                    it["device_index"] = k
    return pending


def _recon_shard(items, sps0, device, download):
    """One level's pictures `items` through the whole pipeline on `device`:
    residuals (K1, CCP), PCM (K9), MC (K5 / K6), intra (K2), the loop
    filter and restore (K8).  sps0: the decode's first SPS, which sets the
    filters' level-wide parameters."""
    from .batch_decode import _intra_level, _residual_planes_batch_device
    from .device_filters import filter_level

    ncomp = 3 if sps0.chroma_format_idc else 1
    B = len(items)
    res_stacked = _residual_planes_batch_device(items, B, device)
    stacked = [torch.zeros_like(r) for r in res_stacked]
    _pcm_level(items, stacked, device)
    # MC first: intra blocks of inter pictures predict from MC-reconstructed
    # neighbours
    _inter_level(items, stacked, res_stacked, device)
    # every component's intra wavefront in one launch: no component's
    # prediction reads another's samples
    _intra_level(items, stacked, res_stacked, device)
    stacked = filter_level(items, stacked, sps0, device)
    pending = []
    with obs.span("recon.narrow", B if download else 0):
        for b, it in enumerate(items):
            sps = it["sps"]
            cache = {}
            small = []
            for c in range(ncomp):
                sx, sy, _, Wc, Hc = _comp_geometry(sps, c)
                cache[(c, Hc, Wc)] = stacked[c][b, :Hc, :Wc]
                if download:
                    # two bytes a sample: the low 16 bits of samples of up
                    # to 16 bits, in an int16 (torch's uint16 support is
                    # thin); _download reads them back unsigned
                    small.append(stacked[c][b].to(torch.int16))
            it["dp"]._device_planes = cache
            pending.append((it["dp"], it, small))
    return pending


def _download(small):
    """Host int32 planes of one picture's int16 device planes, whose bits
    are uint16 samples (D2H counted)."""
    planes = []
    with obs.span("download") as span:
        for s in small:
            a = s.cpu().numpy()
            xfer.count_d2h(a.nbytes)
            span.n += a.nbytes
            planes.append(a.view(np.uint16).astype(np.int32))
    return planes


def _materialize(dec, pending, check_sei_hash):
    """Download pending planes, run hash checks, rebuild dec.outputs."""
    for dp, it, small in pending:
        dp.planes = _download(small)
        dp.cropped_planes = None
        if check_sei_hash and it["pending_hash"] is not None:
            dec._pending_hash = it["pending_hash"]
            dec._verify_hash(dp)
    # rebuild the output list now that pixels exist (bumping order was
    # already decided by the control plane during parsing)
    dec.outputs = [dp.cropped() for dp in dec.output_records]
    return dec.outputs


def _as_device(device):
    """torch.device(device) as tensors report it: no index on the CPU, the
    current device's index for a bare "cuda" where CUDA runs."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type == "cuda" and device.index is None and \
            torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_device(device, what):
    """_as_device(device); RuntimeError for a CUDA device that the host
    does not have."""
    device = _as_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: CUDA device requested but "
                               "torch.cuda.is_available() is false")
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"{what}: {device} requested, the host has "
                               f"{torch.cuda.device_count()} CUDA devices")
    return device


def _check_devices(device, devices, what):
    """The device list of an entry point: `devices` when given, else
    [device], with `device` None read as "cuda"; each entry through
    _check_device.  ValueError for an empty list or a `device` other than
    devices[0]."""
    if devices is None:
        devices = ["cuda" if device is None else device]
    devices = [_as_device(d) for d in devices]
    if not devices:
        raise ValueError(f"{what}: devices is an empty list")
    if device is not None and _as_device(device) != devices[0]:
        raise ValueError(f"{what}: device={device} is not devices[0] = "
                         f"{devices[0]}")
    return [_check_device(d, what) for d in devices]


def decode_batch(data, *, device=None, devices=None, parse="native",
                 check_sei_hash=False):
    """Decode an Annex-B stream with reference-DAG cross-picture batching
    and a device-resident pixel path on `device` (the card by default; the
    CPU runs the plain torch versions of the kernels), or with each level's
    pictures split over the list `devices` (_recon_levels).

    Bit-exact vs the JAX decode_batch / the HM hash oracle.  Returns the
    cropped pictures in output order (Decoder.outputs shape).
    """
    from ..hostdec.decoder import Decoder

    devices = _check_devices(device, devices, "decode_batch")
    with obs.request() as call:
        dec = Decoder(parse=parse, recon="collect",
                      check_sei_hash=check_sei_hash)
        dec.decode_annexb(data)
        items = getattr(dec, "collected", [])
        if not items:
            return []
        _check_geometry(items, "decode_batch")
        pending = _recon_levels(items, devices)
        outs = _materialize(dec, pending, check_sei_hash)
        call.n = len(outs)
    return outs


def decode_batch_device(data, *, device=None, devices=None, parse="native"):
    """Device-compute decode: host parse + device-resident reconstruction,
    downloading nothing but one uint32 checksum (K7) per device.

    Port of libhm_tpu/parallel/dag_decode.py decode_batch_device.  The
    decoded pictures stay on the device, as a device-resident consumer
    would use them; the checksum (every conformance-cropped output sample,
    mod 2^32, in DecodedPicture.cropped() geometry, over the bumped output
    list) lets the caller check the run against cropped_checksum of a
    decode of the same stream.  With a `devices` list, K7 runs once on
    each device over the pictures it reconstructed, and the host adds the
    partial sums mod 2^32 (4 bytes down per device that holds a picture).

    Returns (parse_seconds, compute_seconds, checksum_int, n_pictures),
    the seconds on time.perf_counter(), the clock of the spans (obs).
    """
    import time

    from ..hostdec.decoder import Decoder

    devices = _check_devices(device, devices, "decode_batch_device")
    with obs.request() as call:
        dec = Decoder(parse=parse, recon="collect")
        t0 = time.perf_counter()
        dec.decode_annexb(data)
        t1 = time.perf_counter()
        items = getattr(dec, "collected", [])
        if not items:
            return t1 - t0, 0.0, 0, 0
        _check_geometry(items, "decode_batch_device")
        pending = _recon_levels(items, devices, download=False)
        owner = {id(dp): it["device_index"] for dp, it, _ in pending}
        views = [[] for _ in devices]
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
                views[owner[id(dp)]].append(view[ct * muly:h - cb * muly,
                                                 cl * mulx:w - cr * mulx])
        # every device's launch first, then the reads
        accs = []
        for dev, vs in zip(devices, views):
            if vs:
                with _on(dev):
                    accs.append(CK.plane_checksum(vs))
        csum = 0
        with obs.span("download", 4 * len(accs)):
            for acc in accs:
                csum = (csum + int(acc.cpu().item())) & 0xFFFFFFFF
                xfer.count_d2h(4)
        t2 = time.perf_counter()
        call.n = len(pending)
        return t1 - t0, t2 - t1, csum, len(pending)


def decode_streams(datas, *, device=None, devices=None, parse="native",
                   check_sei_hash=False, threads=0):
    """Decode several independent Annex-B streams of one picture geometry
    with their pictures batched into shared launches on `device`, or split
    over the list `devices` as decode_batch splits them.

    Port of libhm_tpu/parallel/dag_decode.py decode_streams.  The control
    planes parse independently (in `threads` host threads when > 0), each
    checking its pictures' hash SEIs when `check_sei_hash` (the statuses
    in each DecodedPicture's hash_status); reconstruction merges every
    stream's reference-DAG levels, so level i of all streams reconstructs
    in one set of launches per device.  Returns a list of per-stream
    output lists (each = decode_batch(data)).
    """
    from ..hostdec.decoder import Decoder

    devices = _check_devices(device, devices, "decode_streams")
    with obs.request() as call:
        decs = [Decoder(parse=parse, recon="collect",
                        check_sei_hash=check_sei_hash) for _ in datas]
        if threads and len(datas) > 1:
            from concurrent.futures import ThreadPoolExecutor
            # each parse runs in a copy of this context, so that its spans
            # carry the call's request id
            with ThreadPoolExecutor(max_workers=threads) as ex:
                list(ex.map(lambda p: p[2].run(p[0].decode_annexb, p[1]),
                            zip(decs, datas, [contextvars.copy_context()
                                              for _ in datas])))
        else:
            for dec, data in zip(decs, datas):
                dec.decode_annexb(data)
        items_all = [it for dec in decs
                     for it in getattr(dec, "collected", [])]
        if not items_all:
            return [[] for _ in datas]
        _check_geometry(items_all, "decode_streams")
        pending = _recon_levels(items_all, devices)
        # split the pending downloads back to their owning stream
        own = {id(it["dp"]): si for si, dec in enumerate(decs)
               for it in getattr(dec, "collected", [])}
        per_stream = [[] for _ in decs]
        for entry in pending:
            per_stream[own[id(entry[0])]].append(entry)
        outs = [_materialize(dec, pend, check_sei_hash)
                for dec, pend in zip(decs, per_stream)]
        call.n = sum(len(o) for o in outs)
    return outs


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
