"""Whole-picture SAO, and the SAO kernel (K4).

Port of libhm_tpu/ops/sao.py: edge-offset neighbours are limited by the
picture bounds and either `valid_mask` (the single-slice form) or the
pairwise slice/tile rules of the multi-slice form (`slice_map`, `lf_map`,
`tile_map`, `lf_across_tiles`).  `sao` and `sao_multi` are the kernel
wrappers over stacked [B, Hp, Wp] planes: for CUDA planes one launch of
the loop-filter kernel (csrc/loopfilter.cu, ops/loopfilter.py) with the
SAO mask, through an entry point of each form; `sao_component` per
picture for CPU planes.
"""
import torch

from ..kernels.build import I, P, Kernel, check
from . import loopfilter as LF

# EO class neighbour offsets (dy1, dx1, dy2, dx2), indexed by type-1
EO_NB = [[0, -1, 0, 1],
         [-1, 0, 1, 0],
         [-1, -1, 1, 1],
         [-1, 1, 1, -1]]


def sao_component(plane, valid_mask, ctu_type, ctu_band, ctu_offsets,
                  log2_ctb_c, bit_depth, offset_scale, W, H,
                  log2_ctb_cy=None, slice_map=None, lf_map=None,
                  tile_map=None, lf_across_tiles=True):
    """Apply SAO to one component plane.

    plane: [Hp, Wp] int32 (deblocked)
    valid_mask: [Hp, Wp] bool or None (all true) — neighbour validity for EO
      (ignored when slice_map is given)
    ctu_type: [hc, wc] int32 (-1 off, 0 BO, 1..4 EO)
    ctu_band: [hc, wc] int32
    ctu_offsets: [hc, wc, 4] int32
    log2_ctb_c: CTB width log2 in this component's units; log2_ctb_cy the
      height log2 when different (4:2:2 chroma CTBs are 32x64)
    slice_map / lf_map / tile_map: [Hp, Wp] slice index, loop filter
      across slices (bool) and tile index per sample; a neighbour is usable
      iff it is in the same slice or both samples filter across slices,
      and in the same tile or lf_across_tiles is set
    Returns the new plane.
    """
    if slice_map is not None and any(
            m is None or tuple(m.shape) != tuple(plane.shape)
            for m in (slice_map, lf_map) +
            (() if tile_map is None else (tile_map,))):
        raise ValueError("sao_component: the slice, loop-filter and tile "
                         "maps must have the plane's shape")
    if log2_ctb_cy is None:
        log2_ctb_cy = log2_ctb_c
    dev = plane.device
    Hp, Wp = plane.shape
    maxv = (1 << bit_depth) - 1
    # only the samples inside the picture whose CTB has SAO on change
    yy = (torch.arange(Hp, device=dev) >> log2_ctb_cy)[:, None]
    xx = (torch.arange(Wp, device=dev) >> log2_ctb_c)[None, :]
    inside = (torch.arange(Hp, device=dev)[:, None] < H) & \
        (torch.arange(Wp, device=dev)[None, :] < W)
    ys, xs = torch.nonzero(inside & (ctu_type[yy, xx] >= 0), as_tuple=True)
    cty, ctx = ys >> log2_ctb_cy, xs >> log2_ctb_c
    ptype = ctu_type[cty, ctx]
    pband = ctu_band[cty, ctx]
    offs = ctu_offsets[cty, ctx] * (1 << offset_scale)           # [n, 4]
    src = plane[ys, xs]

    # band offset
    rel = ((src >> (bit_depth - 5)) - pband) & 31
    bo = torch.gather(offs, 1, torch.clamp(rel, max=3)[:, None].long())[:, 0]
    bo = torch.where(rel < 4, bo, 0)

    # edge offset
    nb = torch.as_tensor(EO_NB, device=dev)
    eo_idx = torch.clamp(ptype - 1, 0, 3).long()
    n1y, n1x = ys + nb[:, 0][eo_idx], xs + nb[:, 1][eo_idx]
    n2y, n2x = ys + nb[:, 2][eo_idx], xs + nb[:, 3][eo_idx]
    inb = (n1y >= 0) & (n1y < H) & (n1x >= 0) & (n1x < W) & \
          (n2y >= 0) & (n2y < H) & (n2x >= 0) & (n2x < W)
    n1yc, n1xc = torch.clamp(n1y, 0, Hp - 1), torch.clamp(n1x, 0, Wp - 1)
    n2yc, n2xc = torch.clamp(n2y, 0, Hp - 1), torch.clamp(n2x, 0, Wp - 1)
    ok = inb
    if slice_map is not None:
        # pairwise slice/tile crossing rules (Rec. 8.7.3)
        def pair_ok(nyc, nxc):
            r = (slice_map[ys, xs] == slice_map[nyc, nxc]) | \
                (lf_map[ys, xs] & lf_map[nyc, nxc])
            if tile_map is not None:
                r = r & ((tile_map[ys, xs] == tile_map[nyc, nxc]) |
                         bool(lf_across_tiles))
            return r
        ok = ok & pair_ok(n1yc, n1xc) & pair_ok(n2yc, n2xc)
    elif valid_mask is not None:
        ok = ok & valid_mask[n1yc, n1xc] & valid_mask[n2yc, n2xc]
    cat = torch.sign(src - plane[n1yc, n1xc]) + \
        torch.sign(src - plane[n2yc, n2xc]) + 2
    # category 0, 1, (2: none), 3, 4 -> offsets 0, 1, 2, 3
    slot = torch.where(cat < 2, cat, cat - 1)
    eo = torch.gather(offs, 1, torch.clamp(slot, 0, 3)[:, None].long())[:, 0]
    eo = torch.where(ok & (cat != 2), eo, 0)

    delta = torch.where(ptype == 0, bo, eo)
    out = plane.to(torch.int32).clone()
    out[ys, xs] = torch.clamp(src + delta, 0, maxv).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# K4: the SAO entry points of the loop-filter kernel (reads the deblocked
# planes, writes new ones); the multi-slice/tile form is its own entry
# point with its own launch count
_K4 = Kernel("sao_apply", [P, I])
_K4_MULTI = Kernel("sao_apply_multi", [P, I])


def _launch_sao(kernel, planes, sao_t, sao_b, sao_o, scale, *, log2cx,
                log2cy, bd, W, H, sx=0, sy=0, extra=None, **geo):
    """One plane's SAO through the loop-filter kernel: the per-CTB maps
    as [B, hc * wc, 1] views (one component column)."""
    B, Hp, Wp = planes.shape
    _, hc, wc = sao_t.shape
    out = torch.empty_like(planes)
    maps = {"sao_t": sao_t.view(B, hc * wc, 1),
            "sao_b": sao_b.view(B, hc * wc, 1),
            "sao_o": sao_o.view(B, hc * wc, 1, 4)}
    maps.update(extra or {})
    LF.launch(kernel, [{"in": planes, "out": out, "Hp": Hp, "Wp": Wp,
                        "W": W, "H": H, "sx": sx, "sy": sy, "bd": bd,
                        "log2cx": log2cx, "log2cy": log2cy,
                        "scale": scale}],
              maps, mask=LF.PASS_SAO, hc=hc, wc=wc, **geo)
    return out


def sao_plain(planes, sao_t, sao_b, sao_o, scale, *, log2cx, log2cy, bd, W,
              H):
    """Plain torch version of sao (any device)."""
    out = torch.empty_like(planes)
    for b in range(planes.shape[0]):
        out[b] = sao_component(
            planes[b], None, sao_t[b].to(torch.int32),
            sao_b[b].to(torch.int32), sao_o[b].to(torch.int32), log2cx, bd,
            int(scale[b]), W, H, log2_ctb_cy=log2cy)
    return out


def sao(planes, sao_t, sao_b, sao_o, scale, *, log2cx, log2cy, bd, W, H):
    """SAO of one component of every picture; returns new planes.

    planes: [B, Hp, Wp] int32 (deblocked); sao_t/sao_b: [B, hc, wc] int8
    type (-1 off, 0 BO, 1..4 EO) and band position; sao_o: [B, hc, wc, 4]
    int8 offsets; scale: [B] int32 offset shift (sao_offset_scale).
    W, H: the component's picture size; CTBs of at least 8 samples each
    way (log2cx, log2cy >= 3).
    """
    if not planes.is_cuda:
        return sao_plain(planes, sao_t, sao_b, sao_o, scale, log2cx=log2cx,
                         log2cy=log2cy, bd=bd, W=W, H=H)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(sao_t, "sao_t", torch.int8, 3, dev)
    check(sao_b, "sao_b", torch.int8, 3, dev)
    check(sao_o, "sao_o", torch.int8, 4, dev)
    check(scale, "scale", torch.int32, 1, dev)
    B, Hp, Wp = planes.shape
    _, hc, wc = sao_t.shape
    if sao_t.shape[0] != B or sao_b.shape != sao_t.shape or \
            sao_o.shape != (B, hc, wc, 4) or scale.shape[0] != B or \
            (hc << log2cy) < Hp or (wc << log2cx) < Wp or \
            W > Wp or H > Hp or not 8 <= bd <= 16 or \
            min(log2cx, log2cy) < 3:
        raise ValueError("sao: inconsistent plane/map shapes")
    return _launch_sao(_K4, planes, sao_t, sao_b, sao_o, scale,
                       log2cx=log2cx, log2cy=log2cy, bd=bd, W=W, H=H)


def sample_maps(s4, lf4, tm, Hp, Wp, sx, sy, log2_ctb):
    """Per-sample slice, loop-filter-across and tile maps of one picture's
    component plane from its luma-grid maps, as the JAX _filter_fn builds
    them (libhm_tpu/parallel/device_filters.py:169-179): the 4x4 row is
    (y << sy) >> 2 clamped to h4 - 1, the CTB row (y << sy) >> log2_ctb
    clamped to hc - 1, the same for columns.

    s4: [h4, w4] int16; lf4: [h4, w4] uint8/bool; tm: [hc, wc] int16.
    """
    dev = s4.device
    h4, w4 = s4.shape
    hc, wc = tm.shape
    ys = torch.arange(Hp, device=dev) << sy
    xs = torch.arange(Wp, device=dev) << sx
    y4 = torch.clamp(ys >> 2, max=h4 - 1)[:, None]
    x4 = torch.clamp(xs >> 2, max=w4 - 1)[None, :]
    yc = torch.clamp(ys >> log2_ctb, max=hc - 1)[:, None]
    xc = torch.clamp(xs >> log2_ctb, max=wc - 1)[None, :]
    return (s4[y4, x4].to(torch.int32), lf4[y4, x4] != 0,
            tm[yc, xc].to(torch.int32))


def sao_multi_plain(planes, sao_t, sao_b, sao_o, scale, s4, lf4, tm, lft, *,
                    log2cx, log2cy, bd, W, H, sx, sy, log2_ctb):
    """Plain torch version of sao_multi (any device)."""
    out = torch.empty_like(planes)
    Hp, Wp = planes.shape[1:]
    for b in range(planes.shape[0]):
        sm, lf, tmm = sample_maps(s4[b], lf4[b], tm[b], Hp, Wp, sx, sy,
                                  log2_ctb)
        out[b] = sao_component(
            planes[b], None, sao_t[b].to(torch.int32),
            sao_b[b].to(torch.int32), sao_o[b].to(torch.int32), log2cx, bd,
            int(scale[b]), W, H, log2_ctb_cy=log2cy, slice_map=sm,
            lf_map=lf, tile_map=tmm, lf_across_tiles=bool(lft[b]))
    return out


def sao_multi(planes, sao_t, sao_b, sao_o, scale, s4, lf4, tm, lft, *,
              log2cx, log2cy, bd, W, H, sx, sy, log2_ctb):
    """SAO of one component of every picture under the multi-slice/tile
    rules; returns new planes.

    As `sao`, plus the luma-grid maps of prepare_filter_maps: s4 [B, h4,
    w4] int16 slice index and lf4 [B, h4, w4] uint8 loop filter across
    slices per 4x4; tm [B, hc, wc] int16 tile index per CTB; lft [B] uint8
    loop_filter_across_tiles per picture.  sx, sy: this component's
    subsampling shifts; log2_ctb: the luma CTB size log2.
    """
    if not planes.is_cuda:
        return sao_multi_plain(planes, sao_t, sao_b, sao_o, scale, s4, lf4,
                               tm, lft, log2cx=log2cx, log2cy=log2cy, bd=bd,
                               W=W, H=H, sx=sx, sy=sy, log2_ctb=log2_ctb)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(sao_t, "sao_t", torch.int8, 3, dev)
    check(sao_b, "sao_b", torch.int8, 3, dev)
    check(sao_o, "sao_o", torch.int8, 4, dev)
    check(scale, "scale", torch.int32, 1, dev)
    check(s4, "s4", torch.int16, 3, dev)
    check(lf4, "lf4", torch.uint8, 3, dev)
    check(tm, "tm", torch.int16, 3, dev)
    check(lft, "lft", torch.uint8, 1, dev)
    B, Hp, Wp = planes.shape
    _, hc, wc = sao_t.shape
    _, h4, w4 = s4.shape
    if sao_t.shape[0] != B or sao_b.shape != sao_t.shape or \
            sao_o.shape != (B, hc, wc, 4) or scale.shape[0] != B or \
            (hc << log2cy) < Hp or (wc << log2cx) < Wp or \
            W > Wp or H > Hp or not 8 <= bd <= 16 or \
            min(log2cx, log2cy) < 3 or \
            s4.shape[0] != B or lf4.shape != s4.shape or \
            tm.shape != (B, hc, wc) or lft.shape[0] != B:
        raise ValueError("sao_multi: inconsistent plane/map shapes")
    return _launch_sao(_K4_MULTI, planes, sao_t, sao_b, sao_o, scale,
                       log2cx=log2cx, log2cy=log2cy, bd=bd, W=W, H=H, sx=sx,
                       sy=sy, extra={"s4": s4, "lf4": lf4, "tm": tm,
                                     "lft": lft},
                       h4=h4, w4=w4, log2_ctb=log2_ctb, multi=True)
