"""Whole-picture deblocking filter, and the deblocking kernel (K3).

Port of libhm_tpu/ops/deblock.py.  The plain `deblock_luma_vertical` and
`deblock_chroma_vertical` keep the JAX formulation (segment maps, the H
pass on the transposed plane).  `deblock_luma` / `deblock_chroma` are the
single-pass kernel wrappers: they take the stacked [B, H, W] planes and
the per-4x4 maps of prepare_filter_maps plus the edge direction, and
update the planes in place: for CUDA planes one launch of the loop-filter
kernel (csrc/loopfilter.cu, ops/loopfilter.py) with a one-pass mask,
into a new plane that is then copied back; for CPU planes the plain
functions.
"""
import torch

from ..hostdec.loopfilter_np import BETA_TABLE, TC_TABLE

from ..kernels.build import I, P, Kernel, check
from . import loopfilter as LF


def deblock_luma_vertical(plane, bs, qp_l, beta_off, tc_off, no_p, no_q,
                          bit_depth):
    """One whole-frame vertical-edge luma pass.

    plane: [H, W] int32 (H multiple of 4, W multiple of 8)
    bs: [H/4, W/8] int32 boundary strength for the edge left of column 8*j
        (bs[:, 0] must be 0 — picture edge)
    qp_l: [H/4, W/8] int32 average QP per segment
    beta_off/tc_off: [H/4, W/8] int32
    no_p/no_q: [H/4, W/8] bool (PCM/lossless exclusions)
    Returns the filtered plane.
    """
    dev = plane.device
    H, W = plane.shape
    ns_y, ns_x = H // 4, W // 8
    maxv = (1 << bit_depth) - 1
    bd_shift = bit_depth - 8

    # seg[s_y, s_x, 4, 8] with columns (8x-4 .. 8x+3), clamped at the left
    cols = (torch.arange(ns_x, device=dev)[:, None] * 8 - 4 +
            torch.arange(8, device=dev)[None, :])
    cols = torch.clamp(cols, 0, W - 1)                       # [ns_x, 8]
    seg = plane.reshape(ns_y, 4, W)[:, :, cols]              # [ns_y, 4, ns_x, 8]
    seg = seg.permute(0, 2, 1, 3)                            # [ns_y, ns_x, 4, 8]
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]

    beta_t = torch.as_tensor(BETA_TABLE, dtype=torch.int32, device=dev)
    tc_t = torch.as_tensor(TC_TABLE, dtype=torch.int32, device=dev)
    idx_b = torch.clamp(qp_l + beta_off, 0, 51).long()
    idx_t = torch.clamp(qp_l + 2 * (bs - 1) + tc_off, 0, 53).long()
    beta = beta_t[idx_b] << bd_shift                         # [ns_y, ns_x]
    tc = tc_t[idx_t] << bd_shift

    dp_r = torch.abs(p2 - 2 * p1 + p0)                       # [ns_y, ns_x, 4]
    dq_r = torch.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dp_r[..., 0], dp_r[..., 3]
    dq0, dq3 = dq_r[..., 0], dq_r[..., 3]
    d0, d3 = dp0 + dq0, dp3 + dq3
    filt = (bs > 0) & (d0 + d3 < beta)

    def strong_row(i, di):
        return (2 * di < (beta >> 2)) & \
               (torch.abs(p3[..., i] - p0[..., i]) +
                torch.abs(q0[..., i] - q3[..., i]) < (beta >> 3)) & \
               (torch.abs(p0[..., i] - q0[..., i]) < ((tc * 5 + 1) >> 1))
    sw = strong_row(0, d0) & strong_row(3, d3)

    tc_b = tc[..., None]

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)
    # strong filter
    sp0 = clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
               p0 - 2 * tc_b, p0 + 2 * tc_b)
    sp1 = clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc_b, p1 + 2 * tc_b)
    sp2 = clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
               p2 - 2 * tc_b, p2 + 2 * tc_b)
    sq0 = clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
               q0 - 2 * tc_b, q0 + 2 * tc_b)
    sq1 = clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc_b, q1 + 2 * tc_b)
    sq2 = clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
               q2 - 2 * tc_b, q2 + 2 * tc_b)
    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = torch.abs(delta) < 10 * tc_b
    dlt = clip(delta, -tc_b, tc_b)
    wp0 = torch.clamp(p0 + dlt, 0, maxv)
    wq0 = torch.clamp(q0 - dlt, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    filt_p2 = ((dp0 + dp3) < side_thr)[..., None]
    filt_q2 = ((dq0 + dq3) < side_thr)[..., None]
    tc2 = tc_b >> 1
    dp1v = clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1v = clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = torch.clamp(p1 + dp1v, 0, maxv)
    wq1 = torch.clamp(q1 + dq1v, 0, maxv)

    filt_b = filt[..., None]
    sw_b = sw[..., None]

    def sel(strong, weak, orig, weak_en, no):
        v = torch.where(sw_b, strong,
                        torch.where(weak_en & weak_on, weak, orig))
        return torch.where(filt_b & ~no[..., None], v, orig)
    false_b = torch.zeros_like(filt_b)
    true_b = torch.ones_like(filt_b)
    out_seg = torch.stack([
        p3,
        sel(sp2, p2, p2, false_b, no_p),
        sel(sp1, wp1, p1, filt_p2, no_p),
        sel(sp0, wp0, p0, true_b, no_p),
        sel(sq0, wq0, q0, true_b, no_q),
        sel(sq1, wq1, q1, filt_q2, no_q),
        sel(sq2, q2, q2, false_b, no_q),
        q3], dim=-1)
    # column c belongs to segment (c+4)//8 at offset (c+4)%8; the last 4
    # columns (right of the last edge) keep their input values
    out = out_seg.permute(0, 2, 1, 3).reshape(H, ns_x * 8)
    res = torch.roll(out, -4, dims=1)
    res[:, W - 4:] = plane[:, W - 4:]
    return res.to(torch.int32)


def deblock_chroma_vertical(plane, tc_c, filt, no_p, no_q, bit_depth):
    """Vertical chroma pass at 8-chroma-sample edges.

    plane: [Hc, Wc] int32 (Wc multiple of 8)
    tc_c: [Hc, Wc/8] int32 per-row(!) tc (expanded from segments by caller)
    filt: [Hc, Wc/8] bool
    """
    dev = plane.device
    Hc, Wc = plane.shape
    ns = Wc // 8
    maxv = (1 << bit_depth) - 1
    cols = (torch.arange(ns, device=dev)[:, None] * 8 - 2 +
            torch.arange(4, device=dev)[None, :])
    cols = torch.clamp(cols, 0, Wc - 1)
    seg = plane[:, cols]                                     # [Hc, ns, 4]
    p1, p0, q0, q1 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc_c), tc_c)
    np0 = torch.clamp(p0 + delta, 0, maxv)
    nq0 = torch.clamp(q0 - delta, 0, maxv)
    o_p0 = torch.where(filt & ~no_p, np0, p0)
    o_q0 = torch.where(filt & ~no_q, nq0, q0)
    out = plane.clone()
    xs = torch.arange(ns, device=dev) * 8
    out[:, xs[1:] - 1] = o_p0[:, 1:].to(torch.int32)        # p0 left of edge
    out[:, xs] = o_q0.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# K3: the single-pass entry points of the loop-filter kernel (one edge
# direction of one plane per launch); the int16-tc form (chroma above 11
# bits) is its own entry point
_K3_LUMA = Kernel("deblock_luma", [P, I])
_K3_CHROMA = Kernel("deblock_chroma", [P, I])
_K3_CHROMA16 = Kernel("deblock_chroma16", [P, I])


def _seg(a, vertical, nsy, nsx):
    """[h4, w4] per-4x4 map -> [nsy, nsx] per-segment map (JAX layout)."""
    a = a[:, ::2] if vertical else a[::2, :].T
    return a[:nsy, :nsx]


def deblock_luma_plain(planes, bsn, qp, bo, to, *, vertical, bd):
    """Plain torch version of deblock_luma (any device), in place."""
    for b in range(planes.shape[0]):
        pl = planes[b] if vertical else planes[b].T
        nsy, nsx = pl.shape[0] // 4, pl.shape[1] // 8

        def sb(a):
            return _seg(a[b], vertical, nsy, nsx).to(torch.int32)
        m = _seg(bsn[b], vertical, nsy, nsx)
        zero = torch.zeros((nsy, nsx), dtype=torch.int32, device=pl.device)
        out = deblock_luma_vertical(
            pl, (m & 3).to(torch.int32), sb(qp),
            zero if bo is None else sb(bo), zero if to is None else sb(to),
            (m & 16) != 0, (m & 32) != 0, bd)
        planes[b] = out if vertical else out.T
    return planes


def deblock_chroma_plain(planes, ctc, bsn, *, vertical, bd, ssx, ssy):
    """Plain torch version of deblock_chroma (any device), in place."""
    dev = planes.device
    for b in range(planes.shape[0]):
        cpl = planes[b] if vertical else planes[b].T
        nr, ns = cpl.shape[0], cpl.shape[1] // 8
        ri = torch.arange(nr, device=dev) >> (2 - (ssy if vertical else ssx))
        ci = torch.arange(ns, device=dev) << (1 + (ssx if vertical else ssy))
        if vertical:
            rows, cols = ri[:, None], ci[None, :]
        else:
            rows, cols = ci[None, :], ri[:, None]
        tcc = ctc[b][rows, cols].to(torch.int32)
        m = bsn[b][rows, cols]
        out = deblock_chroma_vertical(cpl, tcc, tcc != 0, (m & 16) != 0,
                                      (m & 32) != 0, bd)
        planes[b] = out if vertical else out.T
    return planes


def deblock_luma(planes, bsn, qp, bo, to, *, vertical, bd):
    """Luma deblocking of every picture for one edge direction, in place.

    planes: [B, H, W] int32; bsn: [B, h4, w4] uint8 (bs in bits 0-1, no_p
    bit 4, no_q bit 5); qp: [B, h4, w4] int8; bo/to: [B, h4, w4] int8 beta
    and tc offsets, or None when all zero.
    """
    if not planes.is_cuda:
        return deblock_luma_plain(planes, bsn, qp, bo, to, vertical=vertical,
                                  bd=bd)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(bsn, "bsn", torch.uint8, 3, dev)
    check(qp, "qp", torch.int8, 3, dev)
    for t, name in ((bo, "bo"), (to, "to")):
        if t is not None:
            check(t, name, torch.int8, 3, dev)
    B, H, W = planes.shape
    _, h4, w4 = bsn.shape
    if bsn.shape[0] != B or h4 * 4 < H or w4 * 4 < W or H % 8 or W % 8 or \
            any(t is not None and t.shape != bsn.shape for t in (qp, bo, to)):
        raise ValueError("deblock_luma: inconsistent plane/map shapes")
    tag = "v" if vertical else "h"
    out = torch.empty_like(planes)
    LF.launch(_K3_LUMA, [{"in": planes, "out": out, "Hp": H, "Wp": W,
                          "luma": 1, "bd": bd}],
              {f"bsn_{tag}": bsn, f"qp_{tag}": qp, f"bo_{tag}": bo,
               f"to_{tag}": to},
              mask=LF.PASS_V if vertical else LF.PASS_H, h4=h4, w4=w4)
    return planes.copy_(out)


def deblock_chroma(planes, ctc, bsn, *, vertical, bd, ssx, ssy):
    """Chroma deblocking of one component for one edge direction, in place.

    planes: [B, Hc, Wc] int32; ctc: [B, h4, w4] tc per luma 4x4 (0 = edge
    not filtered), uint8 up to 11-bit chroma and int16 above (its own
    entry point and launch count); bsn: [B, h4, w4] uint8 (no_p bit 4,
    no_q bit 5).
    """
    if not planes.is_cuda:
        return deblock_chroma_plain(planes, ctc, bsn, vertical=vertical,
                                    bd=bd, ssx=ssx, ssy=ssy)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    wide = ctc.dtype == torch.int16
    check(ctc, "ctc", torch.int16 if wide else torch.uint8, 3, dev)
    check(bsn, "bsn", torch.uint8, 3, dev)
    B, H, W = planes.shape
    _, h4, w4 = bsn.shape
    if bsn.shape[0] != B or ctc.shape != bsn.shape or H % 8 or W % 8 or \
            ((H - 1) >> (2 - ssy)) >= h4 or ((W - 1) >> (2 - ssx)) >= w4:
        raise ValueError("deblock_chroma: inconsistent plane/map shapes")
    tag = "v" if vertical else "h"
    out = torch.empty_like(planes)
    LF.launch(_K3_CHROMA16 if wide else _K3_CHROMA,
              [{"in": planes, "out": out, "Hp": H, "Wp": W, "sx": ssx,
                "sy": ssy, "luma": 0, "bd": bd}],
              {f"bsn_{tag}": bsn, f"ctc_{tag}": ctc},
              mask=LF.PASS_V if vertical else LF.PASS_H, h4=h4, w4=w4)
    return planes.copy_(out)
