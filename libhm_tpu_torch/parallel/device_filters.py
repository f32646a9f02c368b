"""Device-resident in-loop filters for a reference-DAG level.

Port of libhm_tpu/parallel/device_filters.py.  The host packs the compact
per-4x4 and per-CTB syntax maps (int8 / uint8 / int16) of every picture
of the level into one buffer, uploads it once, and the stacked planes
never leave the device:

    deblock V -> deblock H -> SAO, every component of every picture, in
    ONE launch of the loop-filter kernel (K3 + K4, csrc/loopfilter.cu;
    int16 tc above 11-bit chroma; SAO's multi form where a picture of the
    level has several slices or tiles)
    -> restore (K8 x3, where PCM without loop filter or transquant bypass
       is enabled): masked samples take back their pre-deblock value, read
       from the kernel's input planes

Boundary-strength derivation stays host-side numpy
(hostdec/deblock_maps.compute_bs_maps).
"""
import numpy as np
import torch

from ..hostdec.deblock_maps import compute_bs_maps
from ..hostdec.loopfilter_np import _tile_map
from ..hostdec.tables import CHROMA_QP_SCALE

from ..ops import deblock as DK
from ..ops import loopfilter as LF
from ..ops import pcm as PK
from ..utils import obs, xfer

_TC_NP = np.asarray(DK.TC_TABLE)


# ---------------------------------------------------------------------------
# host-side map preparation (per picture)
def prepare_filter_maps(pic, sps, pps, tile_map):
    """Compact numpy maps driving the device filters for one picture.

    Copied from libhm_tpu/parallel/device_filters.py (prepare_filter_maps).
    """
    ncomp = 3 if sps.chroma_format_idc else 1
    m = {}
    for tag, vertical in (("v", True), ("h", False)):
        bs, qp_l, boff, toff, no_p, no_q = compute_bs_maps(
            pic, sps, pps, tile_map, vertical)
        # bs (2 bits) + no_p/no_q (2 bits) packed into one byte per 4x4
        m[f"bsn_{tag}"] = (bs.astype(np.uint8) |
                           (no_p.astype(np.uint8) << 4) |
                           (no_q.astype(np.uint8) << 5))
        m[f"qp_{tag}"] = qp_l.astype(np.int8)
        # beta/tc offsets are usually all-zero (slice header defaults):
        # only ship them when some 4x4 actually carries one
        if boff.any():
            m[f"bo_{tag}"] = boff.astype(np.int8)
        if toff.any():
            m[f"to_{tag}"] = toff.astype(np.int8)
        if ncomp > 1:
            # per-chroma-component tc (already table-mapped + shifted);
            # 0 = edge not filtered, so no separate mask is needed
            bd_c = sps.bit_depth_chroma
            qscale = np.asarray(CHROMA_QP_SCALE[sps.chroma_format_idc])
            ctc_dt = np.uint8 if bd_c <= 11 else np.int16
            tcs = []
            for c in (1, 2):
                qp_off = pps.cb_qp_offset if c == 1 else pps.cr_qp_offset
                qpi = np.clip(qp_l + qp_off, 0, 57)
                idx = np.clip(qscale[qpi] + 2 + toff, 0, 53)
                tcs.append(np.where(bs == 2,
                                    _TC_NP[idx] << (bd_c - 8),
                                    0).astype(ctc_dt))
            m[f"ctc_{tag}"] = np.stack(tcs)
    if sps.sao_enabled:
        m.update(sao_maps(pic, sps))
    m["s4"] = np.asarray(pic.slice_idx).astype(np.int16)
    m["lf4"] = np.asarray(pic.loopfilter_across_slice).astype(bool)
    m["tm"] = np.asarray(tile_map).astype(np.int16).reshape(-1)
    mask4 = np.asarray(pic.tq_bypass).astype(bool)
    if sps.pcm_enabled and sps.pcm_loop_filter_disabled:
        mask4 |= np.asarray(pic.pcm).astype(bool)
    m["rmask"] = mask4.astype(np.uint8)
    return m


def sao_maps(pic, sps):
    """The per-CTB SAO maps of one picture (prepare_filter_maps' sao_t,
    sao_b, sao_o)."""
    nctu = sps.pic_size_ctbs
    return {"sao_t": np.asarray(pic.sao_type).reshape(nctu, 3).astype(np.int8),
            "sao_b": np.asarray(pic.sao_band_pos).reshape(nctu, 3)
            .astype(np.int8),
            "sao_o": np.asarray(pic.sao_offsets).reshape(nctu, 3, 4)
            .astype(np.int8)}


def picture_filter_flags(items):
    """(multi, restore, sao_on) level-wide static flags.

    Copied from libhm_tpu/parallel/device_filters.py (picture_filter_flags).
    """
    multi = any((np.asarray(it["pic"].slice_idx).max() > 0) or
                it["pps"].tiles_enabled for it in items)
    restore = any(it["pps"].transquant_bypass_enabled or
                  (it["sps"].pcm_enabled and
                   it["sps"].pcm_loop_filter_disabled) for it in items)
    sao_on = bool(items[0]["sps"].sao_enabled)
    return multi, restore, sao_on


# ---------------------------------------------------------------------------
# one packed upload of a level's maps
def _map_order(keys):
    """The level's map names in the order the loop-filter kernel reads
    them: per direction bsn, qp, bo, to, ctc; the SAO maps; the slice/tile
    maps; the offset scales; the restore mask."""
    order = [f"{k}_{t}" for t in "vh" for k in ("bsn", "qp", "bo", "to",
                                                 "ctc")]
    order += ["sao_t", "sao_b", "sao_o", "s4", "lf4", "tm", "lft",
              "sao_scale_l", "sao_scale_c", "rmask"]
    return [k for k in order if k in keys]


def pack_filter_maps(items, maps, Bp, skip=()):
    """One host byte buffer holding every map the level's filters read.

    maps: prepare_filter_maps of each item (picture b = its index); each
    map is stacked over the Bp pictures (zeros where a picture lacks it;
    bool maps as uint8), plus the per-picture SAO offset scales
    (sao_scale_l, sao_scale_c: int32) and, where the slice/tile maps are
    kept, loop_filter_across_tiles (lft: uint8).  Each part starts at a
    16-byte boundary.  Returns (buf, layout) with layout[name] = (offset,
    numpy dtype, shape).
    """
    arrays = {}
    for k in {k for mp in maps for k in mp} - set(skip):
        proto = next(mp[k] for mp in maps if k in mp)
        a = np.zeros((Bp,) + proto.shape,
                     np.uint8 if proto.dtype == bool else proto.dtype)
        for b, mp in enumerate(maps):
            if k in mp:
                a[b] = mp[k]
        arrays[k] = a
    for k, attr in (("sao_scale_l", "sao_offset_scale_luma"),
                    ("sao_scale_c", "sao_offset_scale_chroma")):
        a = np.zeros(Bp, np.int32)
        a[:len(items)] = [int(getattr(it["pps"], attr, 0)) for it in items]
        arrays[k] = a
    if "tm" in arrays:
        a = np.zeros(Bp, np.uint8)
        a[:len(items)] = [bool(it["pps"].loop_filter_across_tiles)
                          for it in items]
        arrays["lft"] = a
    parts, layout, o = [], {}, 0
    for k in _map_order(arrays):
        a = arrays[k]
        layout[k] = (o, a.dtype, a.shape)
        pad = -a.nbytes % 16
        parts += [a.reshape(-1).view(np.uint8), np.zeros(pad, np.uint8)]
        o += a.nbytes + pad
    return np.concatenate(parts), layout


def unpack_filter_maps(buf, layout):
    """Views of the uploaded buffer, one per map of `layout`."""
    out = {}
    for k, (o, dt, shape) in layout.items():
        n = int(np.prod(shape)) * dt.itemsize
        out[k] = buf[o:o + n].view(torch.from_numpy(np.zeros(0, dt)).dtype) \
            .view(shape)
    return out


# ---------------------------------------------------------------------------
def level_maps(items, sps, Bp, device):
    """Every map the level's filters read, packed and uploaded in ONE
    transfer, as views by name (pack_filter_maps), with the keyword
    arguments of ops/loopfilter.py loop_filter_level for the level.
    Returns (maps, kwargs, restore)."""
    multi, restore, sao_on = picture_filter_flags(items)
    maps = [prepare_filter_maps(it["pic"], it["sps"], it["pps"],
                                it["tile_map"]) for it in items]
    # the slice/tile maps and the restore mask only where they are read,
    # as the JAX `skip` set
    skip = set()
    if not (sao_on and multi):
        skip |= {"s4", "lf4", "tm"}
    if not restore:
        skip.add("rmask")
    buf, layout = pack_filter_maps(items, maps, Bp, skip)
    mb = unpack_filter_maps(xfer.up(buf, "filter", device), layout)
    ncomp = 3 if sps.chroma_format_idc else 1
    kw = dict(mask=LF.PASS_V | LF.PASS_H | (LF.PASS_SAO if sao_on else 0),
              bd_l=sps.bit_depth_luma, bd_c=sps.bit_depth_chroma,
              sx=sps.chroma_shift_x() if ncomp > 1 else 0,
              sy=sps.chroma_shift_y() if ncomp > 1 else 0,
              log2_ctb=sps.log2_ctb, hc=sps.pic_height_ctbs,
              wc=sps.pic_width_ctbs, W=sps.width, H=sps.height,
              multi=sao_on and multi)
    return mb, kw, restore


def filter_level(items, stacked, sps, device):
    """Deblock (V, then H), SAO and restore a level's stacked device planes.

    items: the level's collect items; stacked: list per component of
    [Bp, Hp, Wp] int32 device planes (not written).  Every map goes up in
    one upload (level_maps); deblocking and SAO of every component are ONE
    launch of the loop-filter kernel (ops/loopfilter.py loop_filter_level)
    on CUDA planes, its plain version on CPU planes; then the restore
    (K8), which reads the unfiltered input planes.  Returns the filtered
    planes.
    """
    with obs.span("prep.filter", len(items)):
        mb, kw, restore = level_maps(items, sps, int(stacked[0].shape[0]),
                                     device)
    out = LF.loop_filter_level(stacked, mb, **kw)
    # ---- PCM / transquant-bypass restoration ----
    if restore:
        for c in range(len(out)):
            PK.restore_unfiltered(out[c], stacked[c], mb["rmask"],
                                  sx=kw["sx"] if c else 0,
                                  sy=kw["sy"] if c else 0)
    return out


# ---------------------------------------------------------------------------
# the maps each pass of the loop-filter kernel reads
_PASS_MAPS = {LF.PASS_V: ("bsn_v", "qp_v", "bo_v", "to_v", "ctc_v"),
              LF.PASS_H: ("bsn_h", "qp_h", "bo_h", "to_h", "ctc_h"),
              LF.PASS_SAO: ("sao_t", "sao_b", "sao_o", "s4", "lf4", "tm")}


class PictureFilter:
    """The in-loop filter of one picture that an encoder reconstructs in
    host planes.

    The host planes (per component [Hp >> sy, Wp >> sx] int32, padded to
    whole CTBs) go up once.  Each `run(mask)` is one launch of the
    loop-filter kernel (ops/loopfilter.py loop_filter_level: K3 + K4 on
    CUDA planes, its plain version on CPU planes) with the passes `mask`
    names, on the planes the previous run left on the device, reading
    only the maps of those passes (one packed upload); the deblocking maps
    are taken at the first run, the SAO maps from `pic` at each SAO run.
    The result's picture area is written back into the host planes; the
    padding is never written.  `restore(mask4)` (K8) gives the samples of
    a luma-grid 4x4 mask back their value from before the first run.
    """

    def __init__(self, planes, pic, sps, pps, device):
        self.host, self.pic, self.sps, self.pps = planes, pic, sps, pps
        self.device = device
        # a copy: on the CPU the upload would share the host planes' memory
        self.pre = [xfer.up(np.array(p[None]), "recon", device)
                    for p in planes]
        self.cur = self.pre
        self.maps = None
        self.items = [{"pic": pic, "sps": sps, "pps": pps}]
        multi, _, sao_on = picture_filter_flags(self.items)
        self.multi = sao_on and multi
        ncomp = len(planes)
        self.kw = dict(bd_l=sps.bit_depth_luma, bd_c=sps.bit_depth_chroma,
                       sx=sps.chroma_shift_x() if ncomp > 1 else 0,
                       sy=sps.chroma_shift_y() if ncomp > 1 else 0,
                       log2_ctb=sps.log2_ctb, hc=sps.pic_height_ctbs,
                       wc=sps.pic_width_ctbs, W=sps.width, H=sps.height)

    def run(self, mask):
        if self.maps is None:
            self.maps = prepare_filter_maps(
                self.pic, self.sps, self.pps,
                _tile_map(self.pic, self.sps, self.pps))
        multi = self.multi and bool(mask & LF.PASS_SAO)
        if mask & LF.PASS_SAO:
            self.maps.update(sao_maps(self.pic, self.sps))
        read = {k for bit, keys in _PASS_MAPS.items() if mask & bit
                for k in keys}
        if not multi:
            read -= {"s4", "lf4", "tm"}
        buf, layout = pack_filter_maps(self.items, [self.maps], 1,
                                       set(self.maps) - read)
        mb = unpack_filter_maps(xfer.up(buf, "filter", self.device), layout)
        self.cur = LF.loop_filter_level(self.cur, mb, mask=mask, multi=multi,
                                        **self.kw)
        self._download()

    def restore(self, mask4):
        rmask = xfer.up(np.ascontiguousarray(mask4, np.uint8)[None],
                        "filter", self.device)
        for c in range(len(self.cur)):
            PK.restore_unfiltered(self.cur[c], self.pre[c], rmask,
                                  sx=self.kw["sx"] if c else 0,
                                  sy=self.kw["sy"] if c else 0)
        self._download()

    def _download(self):
        for c, (h, d) in enumerate(zip(self.host, self.cur)):
            s = (self.kw["sx"], self.kw["sy"]) if c else (0, 0)
            a = d[0, :self.kw["H"] >> s[1], :self.kw["W"] >> s[0]].cpu() \
                .numpy()
            xfer.count_d2h(a.nbytes)
            h[:a.shape[0], :a.shape[1]] = a
