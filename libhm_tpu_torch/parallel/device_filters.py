"""Device-resident in-loop filters for a reference-DAG level.

Port of libhm_tpu/parallel/device_filters.py.  The host uploads compact
per-4x4 syntax maps (int8 / uint8 / int16) and the stacked planes never
leave the device:

    deblock V (luma K3, chroma K3 x2; its int16-tc form above 11-bit
    chroma) -> deblock H (same)
    -> SAO (K4 x3; its multi form where a picture of the level has
       several slices or tiles)
    -> restore (K8 x3, where PCM without loop filter or transquant bypass
       is enabled): masked samples take back their pre-deblock value

Boundary-strength derivation stays host-side numpy
(hostdec/deblock_maps.compute_bs_maps).
"""
import numpy as np
import torch

from ..hostdec.deblock_maps import compute_bs_maps
from ..hostdec.tables import CHROMA_QP_SCALE

from ..ops import deblock as DK
from ..ops import pcm as PK
from ..ops import sao as SK
from ..utils import xfer

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
        nctu = sps.pic_size_ctbs
        m["sao_t"] = np.asarray(pic.sao_type).reshape(nctu, 3).astype(np.int8)
        m["sao_b"] = np.asarray(pic.sao_band_pos).reshape(nctu, 3).astype(np.int8)
        m["sao_o"] = np.asarray(pic.sao_offsets).reshape(nctu, 3, 4).astype(np.int8)
    m["s4"] = np.asarray(pic.slice_idx).astype(np.int16)
    m["lf4"] = np.asarray(pic.loopfilter_across_slice).astype(bool)
    m["tm"] = np.asarray(tile_map).astype(np.int16).reshape(-1)
    mask4 = np.asarray(pic.tq_bypass).astype(bool)
    if sps.pcm_enabled and sps.pcm_loop_filter_disabled:
        mask4 |= np.asarray(pic.pcm).astype(bool)
    m["rmask"] = mask4.astype(np.uint8)
    return m


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
def filter_level(items, stacked, sps, device):
    """Deblock (V, then H), SAO and restore a level's stacked device planes.

    items: the level's collect items; stacked: list per component of
    [Bp, Hp, Wp] int32 device planes.  Deblocking updates them in place;
    returns the filtered planes.
    """
    multi, restore, sao_on = picture_filter_flags(items)
    ncomp = 3 if sps.chroma_format_idc else 1
    ssx = sps.chroma_shift_x() if ncomp > 1 else 0
    ssy = sps.chroma_shift_y() if ncomp > 1 else 0
    maps = [prepare_filter_maps(it["pic"], it["sps"], it["pps"],
                                it["tile_map"]) for it in items]
    B = len(items)
    Bp = int(stacked[0].shape[0])

    def up(k):
        proto = next(mp[k] for mp in maps if k in mp)
        # bool maps (lf4) go up as uint8
        a = np.zeros((Bp,) + proto.shape,
                     np.uint8 if proto.dtype == bool else proto.dtype)
        for b, mp in enumerate(maps):
            if k in mp:
                a[b] = mp[k]
        return xfer.up(a, "filter", device)
    # the slice/tile maps and the restore mask only where they are read,
    # as the JAX `skip` set
    skip = set()
    if not (sao_on and multi):
        skip |= {"s4", "lf4", "tm"}
    if not restore:
        skip.add("rmask")
    keys = {k for mp in maps for k in mp} - skip
    mb = {k: up(k) for k in sorted(keys)}
    # pre-deblock copies of the planes (restore writes them back)
    pre = [p.clone() for p in stacked] if restore else None

    # ---- deblocking: V pass then H pass (spec order) ----
    for tag, vertical in (("v", True), ("h", False)):
        DK.deblock_luma(stacked[0], mb[f"bsn_{tag}"], mb[f"qp_{tag}"],
                        mb.get(f"bo_{tag}"), mb.get(f"to_{tag}"),
                        vertical=vertical, bd=sps.bit_depth_luma)
        for c in range(1, ncomp):
            ctc = mb[f"ctc_{tag}"][:, c - 1].contiguous()
            DK.deblock_chroma(stacked[c], ctc, mb[f"bsn_{tag}"],
                              vertical=vertical, bd=sps.bit_depth_chroma,
                              ssx=ssx, ssy=ssy)

    # ---- SAO ----
    out = stacked
    if sao_on:
        out = _sao_level(items, stacked, sps, mb, multi, Bp, device)

    # ---- PCM / transquant-bypass restoration ----
    if restore:
        for c in range(ncomp):
            PK.restore_unfiltered(out[c], pre[c], mb["rmask"],
                                  sx=ssx if c else 0, sy=ssy if c else 0)
    return out


def _sao_level(items, stacked, sps, mb, multi, Bp, device):
    """SAO of every component (K4, its multi form when `multi`)."""
    B = len(items)
    ncomp = len(stacked)
    ssx = sps.chroma_shift_x() if ncomp > 1 else 0
    ssy = sps.chroma_shift_y() if ncomp > 1 else 0
    hc, wc = sps.pic_height_ctbs, sps.pic_width_ctbs
    scales = []
    for key in ("sao_offset_scale_luma", "sao_offset_scale_chroma"):
        s = np.zeros(Bp, np.int32)
        s[:B] = [int(getattr(it["pps"], key, 0)) for it in items]
        scales.append(xfer.up(s, "filter", device))
    if multi:
        lft = np.zeros(Bp, np.uint8)
        lft[:B] = [bool(it["pps"].loop_filter_across_tiles) for it in items]
        lft = xfer.up(lft, "filter", device)
        tm = mb["tm"].reshape(Bp, hc, wc)
    out = []
    for c in range(ncomp):
        sx = ssx if c else 0
        sy = ssy if c else 0
        args = (stacked[c],
                mb["sao_t"][:, :, c].reshape(Bp, hc, wc).contiguous(),
                mb["sao_b"][:, :, c].reshape(Bp, hc, wc).contiguous(),
                mb["sao_o"][:, :, c].reshape(Bp, hc, wc, 4).contiguous(),
                scales[0] if c == 0 else scales[1])
        kw = dict(log2cx=sps.log2_ctb - sx, log2cy=sps.log2_ctb - sy,
                  bd=sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma,
                  W=sps.width >> sx, H=sps.height >> sy)
        if multi:
            out.append(SK.sao_multi(*args, mb["s4"], mb["lf4"], tm, lft, sx=sx,
                                    sy=sy, log2_ctb=sps.log2_ctb, **kw))
        else:
            out.append(SK.sao(*args, **kw))
    return out
