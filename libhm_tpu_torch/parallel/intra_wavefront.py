"""Host levelization of intra blocks for the device wavefront.

Port of the host half of libhm_tpu/parallel/intra_wavefront.py.  The
reference reconstructs intra blocks one at a time in z-scan order; here
the host assigns every intra block a *dependency level* (1 + max level of
any block that produced one of its available border samples), and the
device reconstructs one level at a time: all blocks of a level are
data-independent (ops/intra.py intra_level).

Availability (Rec. 8.4.4.2.2: picture bounds, z-order, slice, tile,
constrained-intra) is static parse metadata, precomputed here on the host
as a bit-packed [4n+1] mask per block.
"""
import numpy as np
import torch

from ..hostdec import refimpl
from ..hostdec.picture import MODE_INTRA

from ..ops.intra import _border_offsets


def _pow2(n, lo=1):
    p = lo
    while p < n:
        p <<= 1
    return p


def prepare_component(sps, pic, zmap, tile_map, comp, res_planes,
                      constrained):
    """Levelize the intra blocks of one component.

    Copied from libhm_tpu/parallel/intra_wavefront.py (prepare_component).
    Returns (levels_data, n_levels) where levels_data maps block size n ->
    dict of stacked per-level arrays, or None if the component has no
    intra blocks.
    """
    blocks = [b for b in pic.intra_list if b.comp == comp]
    if not blocks:
        return None, 0
    ssx = sps.chroma_shift_x() if comp else 0
    ssy = sps.chroma_shift_y() if comp else 0
    W = sps.width >> ssx
    H = sps.height >> ssy
    log2_ctb, wctbs = sps.log2_ctb, sps.pic_width_ctbs
    tile_map = np.asarray(tile_map).reshape(-1)
    zmap = np.asarray(zmap)
    slice_idx = np.asarray(pic.slice_idx)
    pred_mode = np.asarray(pic.pred_mode)
    tq_bypass = np.asarray(pic.tq_bypass)

    if comp and sps.chroma_format_idc == 2:
        from ..hostdec.slicedec import CHROMA422_ANGLE_MAP
        mode_map = np.asarray(CHROMA422_ANGLE_MAP)
    else:
        mode_map = None

    # level map at sample granularity for this component plane
    lvl_map = np.zeros((H, W), np.int32)

    per_size = {}
    n_levels = 0
    for blk in blocks:
        n = blk.w
        offx, offy = _border_offsets(n)
        cx = blk.x + offx
        cy = blk.y + offy
        inb = (cx >= 0) & (cy >= 0) & (cx < W) & (cy < H)
        cxc = np.clip(cx, 0, W - 1)
        cyc = np.clip(cy, 0, H - 1)
        lx = cxc << ssx
        ly = cyc << ssy
        i4y, i4x = ly >> 2, lx >> 2
        lx_a, ly_a = blk.x << ssx, blk.y << ssy
        z_cur = zmap[ly_a >> 2, lx_a >> 2]
        av = inb & (zmap[i4y, i4x] < z_cur)
        av &= slice_idx[i4y, i4x] == slice_idx[ly_a >> 2, lx_a >> 2]
        tcur = tile_map[(ly_a >> log2_ctb) * wctbs + (lx_a >> log2_ctb)]
        av &= tile_map[(cyc >> (log2_ctb - ssy)) * wctbs +
                       (cxc >> (log2_ctb - ssx))] == tcur
        if constrained:
            av &= pred_mode[i4y, i4x] == MODE_INTRA

        if av.any():
            lvl = 1 + int(lvl_map[cyc[av], cxc[av]].max())
        else:
            lvl = 1
        lvl_map[blk.y:blk.y + n, blk.x:blk.x + n] = lvl
        n_levels = max(n_levels, lvl)

        mode = blk.mode if mode_map is None else int(mode_map[blk.mode])
        filt = refimpl.use_filtered_refs(comp, n, mode, sps)
        strong = bool(sps.strong_intra_smoothing) and comp == 0 and n == 32
        bypass = bool(tq_bypass[ly_a >> 2, lx_a >> 2])
        dbf = bool(sps.implicit_rdpcm) and bypass
        if res_planes is None:
            res = None      # device-resident: gathered from the res plane
        elif blk.tu_index >= 0:
            res = res_planes[comp][blk.y:blk.y + n, blk.x:blk.x + n]
        else:
            res = np.zeros((n, n), np.int32)
        per_size.setdefault(n, []).append(
            (lvl, blk.x, blk.y, mode, filt, strong, dbf, res, av))

    # pack into [L, K] slots per size.  Shapes are pow2-bucketed with
    # floors, and every size in {4..32} gets a (possibly empty) entry, so
    # the jitted scan's cache key is shared across pictures and streams
    # instead of recompiling per picture geometry.
    L = _pow2(n_levels, lo=8)
    _K_FLOOR = {4: 256, 8: 64, 16: 16, 32: 8}
    for n in (4, 8, 16, 32):
        per_size.setdefault(n, [])
    levels_data = {}
    for n, items in per_size.items():
        counts = np.zeros(L + 1, np.int64)
        for it in items:
            counts[it[0]] += 1
        K = _pow2(int(counts.max()), lo=_K_FLOOR.get(n, 1))
        T = 4 * n + 1
        # compact upload layout: int16 coords, int8 mode, bit-packed
        # filter flags and availability (unpacked on device)
        xs = np.full((L, K), W + 1024, np.int16)   # dummy: scatter-dropped
        ys = np.full((L, K), H + 1024, np.int16)
        mode = np.ones((L, K), np.int8)
        flags = np.zeros((L, K), np.uint8)         # 1 filt, 2 strong, 4 dbf
        res = None if res_planes is None else \
            np.zeros((L, K, n, n), np.int32)
        av = np.zeros((L, K, T), bool)
        fill = np.zeros(L + 1, np.int64)
        for (lvl, x, y, m, f, s, d, r, a) in items:
            li, ki = lvl - 1, int(fill[lvl])
            fill[lvl] += 1
            xs[li, ki] = x
            ys[li, ki] = y
            mode[li, ki] = m
            flags[li, ki] = (1 if f else 0) | (2 if s else 0) | (4 if d else 0)
            if res is not None:
                res[li, ki] = r
            av[li, ki] = a
        levels_data[n] = dict(xs=xs, ys=ys, mode=mode, flags=flags,
                              av=np.packbits(av, axis=-1, bitorder="little"))
        if res is not None:
            levels_data[n]["res"] = res
    return levels_data, L


def unpack_block_meta(d, n):
    """Unpack the compact upload layout (plain torch).

    Port of libhm_tpu/parallel/intra_wavefront.py unpack_block_meta.
    """
    xs = d["xs"].to(torch.int32)
    ys = d["ys"].to(torch.int32)
    mode = d["mode"].to(torch.int32)
    flags = d["flags"]
    filt = (flags & 1) != 0
    strong = (flags & 2) != 0
    dbf = (flags & 4) != 0
    T = 4 * n + 1
    t = torch.arange(T, device=xs.device)
    av = ((d["av"][..., t >> 3] >> (t & 7).to(torch.uint8)) & 1) != 0
    return xs, ys, mode, filt, strong, dbf, av
