"""The in-loop filter kernel: deblocking and SAO of a level in one launch.

csrc/loopfilter.cu holds one kernel for K3 (deblocking) and K4 (SAO): one
CTA per 32x32 tile of one component plane of one picture, over a flat tile
list of every component and picture; it stages the tile's 40x40 window in
shared memory, runs the passes its mask names (V edges, H edges, SAO) there
and writes the tile once to a new plane.

- `loop_filter_level`: the level kernel (one launch for the whole level)
  for CUDA planes, `loop_filter_level_plain` for CPU planes;
- `launch`: builds the kernel's descriptor and launches it through one of
  its entry points.  The single-pass wrappers of ops/deblock.py and
  ops/sao.py launch it with a one-pass mask, each through its own entry
  point and launch count.

The descriptor is a host int64 array (array.array) in the order of
DESC_FIELDS (the `Desc` struct of the source): pointers as integers (0 =
absent), so the maps are read in place wherever they lie, e.g. at their
offsets in the level's one packed upload.
"""
import array

import torch

from ..kernels.build import I, P, Kernel, on_current

PASS_V, PASS_H, PASS_SAO = 1, 2, 4   # mask bits: V edges, H edges, SAO

_COMP_FIELDS = ("in", "out", "Hp", "Wp", "W", "H", "sx", "sy", "luma", "bd",
                "log2cx", "log2cy", "ctc_off", "sao_off", "scale")
_GLOBAL_FIELDS = (
    "ncomp", "B", "mask", "multi", "ctc16", "h4", "w4", "hc", "wc",
    "log2_ctb", "bsn_v", "bsn_h", "qp_v", "qp_h", "bo_v", "bo_h", "to_v",
    "to_h", "ctc_v", "ctc_h", "ctc_pic", "sao_t", "sao_b", "sao_o",
    "sao_pic", "sao_ctu", "s4", "lf4", "tm", "lft")
DESC_FIELDS = _GLOBAL_FIELDS + tuple(
    f"{f}{c}" for c in range(3) for f in _COMP_FIELDS)

_LF = Kernel("loop_filter_level", [P, I])


class Form:
    """Launches of the level kernel in one of its forms (a subset of
    _LF's launches), counted where _LF counts them."""

    def __init__(self):
        self.launches = 0


FORMS = {"multi": Form(), "ctc16": Form()}


def _ptr(t):
    """A tensor's device pointer, 0 for None."""
    return 0 if t is None else t.data_ptr()


def launch(kernel, comps, maps, *, mask, h4=0, w4=0, hc=0, wc=0,
           log2_ctb=0, multi=False):
    """Launch the loop-filter kernel through `kernel` (a Kernel of one of
    its entry points).

    comps: per plane, a dict of the _COMP_FIELDS ("in" and "out" are
    [B, Hp, Wp] int32 CUDA tensors, "scale" a [B] int32 tensor or None;
    absent fields are 0); maps: the tensors the mask reads, by DESC_FIELDS
    name (None or absent = not read); their strides give ctc_pic, sao_pic
    and sao_ctu.  The caller has checked every tensor.
    """
    ctc = maps.get("ctc_v")
    ctc = maps.get("ctc_h") if ctc is None else ctc
    sao_t = maps.get("sao_t")
    g = {"ncomp": len(comps), "B": comps[0]["in"].shape[0], "mask": mask,
         "multi": int(multi),
         "ctc16": int(ctc is not None and ctc.dtype == torch.int16),
         "h4": h4, "w4": w4, "hc": hc, "wc": wc, "log2_ctb": log2_ctb,
         "ctc_pic": 0 if ctc is None else ctc.stride(0),
         "sao_pic": 0 if sao_t is None else sao_t.stride(0),
         "sao_ctu": 0 if sao_t is None else sao_t.stride(1)}
    vals = [g[k] if k in g else _ptr(maps.get(k)) for k in _GLOBAL_FIELDS]
    for comp in comps:
        vals += [comp["in"].data_ptr(), comp["out"].data_ptr()]
        vals += [comp.get(f, 0) for f in _COMP_FIELDS[2:-1]]
        vals.append(_ptr(comp.get("scale")))
    vals += [0] * (len(DESC_FIELDS) - len(vals))
    desc = array.array("q", vals)
    kernel(desc.buffer_info()[0], len(desc))


def _check_maps(maps, spec, dev):
    """Raise unless each map of spec [(name, dtype, shape)] is a contiguous
    tensor of that dtype and shape on `dev`."""
    for name, dtype, shape in spec:
        t = maps.get(name)
        if t is None or t.dtype != dtype or t.shape != shape or \
                t.device != dev or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"loop_filter_level: {name} is {got}, expected "
                             f"a contiguous {dtype} {shape} on {dev}")


def loop_filter_level(planes, maps, *, mask, bd_l, bd_c, sx, sy, log2_ctb,
                      hc, wc, W, H, multi=False):
    """Deblocking (V, then H) and SAO of every component of a level's
    pictures, as the passes of `mask` name; returns new planes (the inputs
    are not written).

    planes: per component (luma first), [B, Hp, Wp] int32; maps: the
    level's maps by name, as filter_level packs them: bsn_v/h [B, h4, w4]
    uint8 (bs in bits 0-1, no_p bit 4, no_q bit 5), qp_v/h int8 and,
    where present, bo_v/h and to_v/h int8; ctc_v/h [B, ncomp - 1, h4, w4]
    chroma tc (uint8, int16 above 11-bit chroma); sao_t/sao_b [B, hc * wc,
    n] int8 and sao_o [B, hc * wc, n, 4] int8 (component c in column c);
    sao_scale_l/sao_scale_c [B] int32; multi: s4 [B, h4, w4] int16, lf4
    uint8, tm [B, hc * wc] int16, lft [B] uint8.  sx, sy: the chroma
    shifts; W, H: the luma picture size.  On CUDA planes the outputs are
    views of one allocation.
    """
    if not planes[0].is_cuda:
        return loop_filter_level_plain(
            planes, maps, mask=mask, bd_l=bd_l, bd_c=bd_c, sx=sx, sy=sy,
            log2_ctb=log2_ctb, hc=hc, wc=wc, W=W, H=H, multi=multi)
    ncomp = len(planes)
    dev = planes[0].device
    on_current(planes[0], "loop_filter_level: planes[0]")
    B = planes[0].shape[0]
    edges = mask & (PASS_V | PASS_H)
    sao = mask & PASS_SAO
    bsn = maps.get("bsn_v" if mask & PASS_V else "bsn_h")
    h4, w4 = (bsn.shape[1:] if edges and bsn is not None else
              maps["s4"].shape[1:] if sao and multi else (0, 0))
    if not 1 <= ncomp <= 3 or not (8 <= bd_l <= 16 and 8 <= bd_c <= 16) or \
            (sao and log2_ctb - max(sx, sy) < 3):
        raise ValueError("loop_filter_level: 1 to 3 planes of 8 to 16 bits, "
                         "CTBs of at least 8 samples")
    spec = []
    geo = []
    for c, p in enumerate(planes):
        s = (sx, sy) if c else (0, 0)
        Hp, Wp = p.shape[1:] if p.dim() == 3 else (0, 0)
        spec.append((c, torch.int32, (B, Hp, Wp)))
        if edges and (Hp % 8 or Wp % 8 or ((Hp - 1) << s[1] >> 2) >= h4 or
                      ((Wp - 1) << s[0] >> 2) >= w4) or \
                sao and ((hc << log2_ctb >> s[1]) < Hp or
                         (wc << log2_ctb >> s[0]) < Wp) or \
                max(Hp, Wp) > 65535:
            raise ValueError("loop_filter_level: plane/map shapes")
        geo.append((Hp, Wp, s))
    _check_maps(dict(enumerate(planes)), spec, dev)
    spec = []
    for tag, bit in (("v", PASS_V), ("h", PASS_H)):
        if mask & bit:
            spec += [(f"bsn_{tag}", torch.uint8, (B, h4, w4)),
                     (f"qp_{tag}", torch.int8, (B, h4, w4))]
            spec += [(f"{k}_{tag}", torch.int8, (B, h4, w4))
                     for k in ("bo", "to") if maps.get(f"{k}_{tag}")
                     is not None]
            if ncomp > 1:
                spec.append((f"ctc_{tag}", torch.int16 if bd_c > 11
                             else torch.uint8, (B, ncomp - 1, h4, w4)))
    if sao:
        n = maps["sao_t"].shape[-1]
        spec += [("sao_t", torch.int8, (B, hc * wc, n)),
                 ("sao_b", torch.int8, (B, hc * wc, n)),
                 ("sao_o", torch.int8, (B, hc * wc, n, 4)),
                 ("sao_scale_l", torch.int32, (B,))]
        if ncomp > 1:
            spec.append(("sao_scale_c", torch.int32, (B,)))
        if n < ncomp:
            raise ValueError("loop_filter_level: SAO maps of too few "
                             "components")
        if multi:
            spec += [("s4", torch.int16, (B, h4, w4)),
                     ("lf4", torch.uint8, (B, h4, w4)),
                     ("tm", torch.int16, (B, hc * wc)),
                     ("lft", torch.uint8, (B,))]
    _check_maps(maps, spec, dev)
    flat = torch.empty(sum(B * Hp * Wp for Hp, Wp, _ in geo),
                       dtype=torch.int32, device=dev)
    outs, comps, o = [], [], 0
    for c, (p, (Hp, Wp, s)) in enumerate(zip(planes, geo)):
        outs.append(flat[o:o + B * Hp * Wp].view(B, Hp, Wp))
        o += B * Hp * Wp
        comps.append({
            "in": p, "out": outs[c], "Hp": Hp, "Wp": Wp, "W": W >> s[0],
            "H": H >> s[1], "sx": s[0], "sy": s[1], "luma": int(c == 0),
            "bd": bd_c if c else bd_l, "log2cx": log2_ctb - s[0],
            "log2cy": log2_ctb - s[1], "ctc_off": (c - 1) * h4 * w4 if c
            else 0, "sao_off": c,
            "scale": maps.get("sao_scale_c" if c else "sao_scale_l")
            if sao else None})
    launch(_LF, comps, {k: maps.get(k) for k, _, _ in spec}, mask=mask,
           h4=h4, w4=w4, hc=hc, wc=wc, log2_ctb=log2_ctb, multi=multi)
    if multi and sao:
        FORMS["multi"].launches += 1
    if ncomp > 1 and edges and bd_c > 11:
        FORMS["ctc16"].launches += 1
    return outs


def loop_filter_level_plain(planes, maps, *, mask, bd_l, bd_c, sx, sy,
                            log2_ctb, hc, wc, W, H, multi=False):
    """Plain torch version of loop_filter_level (any device): the plain
    deblocking passes in spec order (luma and chroma V, then H), then SAO
    of each component, single or multi form."""
    from . import deblock as DK
    from . import sao as SK
    out = [p.clone() for p in planes]
    B = planes[0].shape[0]
    for tag, vertical, bit in (("v", True, PASS_V), ("h", False, PASS_H)):
        if not mask & bit:
            continue
        DK.deblock_luma_plain(out[0], maps[f"bsn_{tag}"], maps[f"qp_{tag}"],
                              maps.get(f"bo_{tag}"), maps.get(f"to_{tag}"),
                              vertical=vertical, bd=bd_l)
        for c in range(1, len(out)):
            DK.deblock_chroma_plain(out[c], maps[f"ctc_{tag}"][:, c - 1],
                                    maps[f"bsn_{tag}"], vertical=vertical,
                                    bd=bd_c, ssx=sx, ssy=sy)
    if not mask & PASS_SAO:
        return out
    for c in range(len(out)):
        s = (sx, sy) if c else (0, 0)
        args = (out[c], maps["sao_t"][:, :, c].reshape(B, hc, wc),
                maps["sao_b"][:, :, c].reshape(B, hc, wc),
                maps["sao_o"][:, :, c].reshape(B, hc, wc, 4),
                maps["sao_scale_c" if c else "sao_scale_l"])
        kw = dict(log2cx=log2_ctb - s[0], log2cy=log2_ctb - s[1],
                  bd=bd_c if c else bd_l, W=W >> s[0], H=H >> s[1])
        if multi:
            out[c] = SK.sao_multi_plain(
                *args, maps["s4"], maps["lf4"],
                maps["tm"].reshape(B, hc, wc), maps["lft"], sx=s[0],
                sy=s[1], log2_ctb=log2_ctb, **kw)
        else:
            out[c] = SK.sao_plain(*args, **kw)
    return out
