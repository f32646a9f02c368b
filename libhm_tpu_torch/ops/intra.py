"""Batched intra prediction, and the intra wavefront-level kernel (K2).

Port of libhm_tpu/ops/intra.py.  The 4n+1 border samples of a block live
in one "vals" row in spec scan order (bottom-left .. corner .. top-right,
Rec. H.265 8.4.4.2.2): left[k] = vals[2n-k], top[k] = vals[2n+k].  The
plain functions keep the JAX semantics on int32 tensors; `intra_level` is
the kernel wrapper that reconstructs every block of one dependency level
(gather -> substitute -> filter -> predict -> + residual -> clip -> store)
as one CUDA launch (csrc/intra.cu) for CUDA planes, and through the plain
functions for CPU planes.
"""
import functools

import numpy as np
import torch

from ..hostdec.refimpl import ANG_TABLE

from ..kernels.build import I, P, Kernel, check, ptr

_INV_ANGLE = {-2: 4096, -5: 1638, -9: 910, -13: 630, -17: 482,
              -21: 390, -26: 315, -32: 256}


# ---------------------------------------------------------------------------
# static tables
@functools.lru_cache(maxsize=None)
def _border_offsets(n):
    """vals-scan-order border coordinates relative to the block origin.

    Copied from libhm_tpu/ops/intra.py (_border_offsets).
    """
    T = 4 * n + 1
    offx = np.empty(T, np.int32)
    offy = np.empty(T, np.int32)
    for i in range(2 * n):
        offx[i], offy[i] = -1, 2 * n - 1 - i
    offx[2 * n], offy[2 * n] = -1, -1
    for i in range(2 * n):
        offx[2 * n + 1 + i], offy[2 * n + 1 + i] = i, -1
    return offx, offy


@functools.lru_cache(maxsize=None)
def _ang_tables(n):
    """Per-mode static gather tables for angular prediction at size n.

    Copied from libhm_tpu/ops/intra.py (_ang_tables).
    EXT_IDX[35, 3n+2]: vals index for extended-ref position p (ref index
      p - n); unused slots clamp to 2n (the corner).
    ROW[35, n], FRAC[35, n]: per-row base position into EXT and the 1/32
      interpolation fraction.
    VERT[35]: mode >= 18.
    """
    E = 3 * n + 2
    ext = np.full((35, E), 2 * n, np.int32)
    row = np.zeros((35, n), np.int32)
    frac = np.zeros((35, n), np.int32)
    vert = np.zeros(35, bool)
    for m in range(2, 35):
        ang = ANG_TABLE[m]
        vertical = m >= 18
        vert[m] = vertical

        def main_idx(i):       # main[i] -> vals index
            return 2 * n + i if vertical else 2 * n - i

        def side_idx(i):       # side[i] -> vals index
            return 2 * n - i if vertical else 2 * n + i

        if ang < 0:
            inv = _INV_ANGLE[ang]
            lo = (n * ang) >> 5
            for r in range(0, n + 1):
                ext[m, n + r] = main_idx(r)
            for r in range(-1, lo - 1, -1):
                ext[m, n + r] = side_idx(min((-r * inv + 128) >> 8, 2 * n))
        else:
            for r in range(0, 2 * n + 1):
                ext[m, n + r] = main_idx(r)
        for j in range(n):
            pos = (j + 1) * ang
            row[m, j] = n + 1 + (pos >> 5)
            frac[m, j] = pos & 31
    return ext, row, frac, vert


@functools.lru_cache(maxsize=None)
def _strong_weights(n):
    """Static weight vectors for the strong bilinear filter (n=32 only).

    Copied from libhm_tpu/ops/intra.py (_strong_weights).
    """
    T = 4 * n + 1
    wc = np.empty(T, np.int32)   # weight of the corner
    we = np.empty(T, np.int32)   # weight of the far edge (bl / tr)
    for p in range(T):
        if p <= 2 * n:
            wc[p], we[p] = p, 2 * n - p
        else:
            wc[p], we[p] = 4 * n - p, p - 2 * n
    return wc, we


def _t(a, device):
    return torch.as_tensor(a, device=device)


# ---------------------------------------------------------------------------
def border_coords(x, y, n, W, H):
    """Clamped border gather coordinates for blocks at (x, y) [B]."""
    offx, offy = _border_offsets(n)
    cx = x[:, None] + _t(offx, x.device)[None, :]
    cy = y[:, None] + _t(offy, y.device)[None, :]
    return torch.clamp(cx, 0, W - 1), torch.clamp(cy, 0, H - 1)


def substitute(gathered, avail, bit_depth):
    """Reference-sample substitution (Rec. 8.4.4.2.2).

    gathered, avail: [B, T]; forward-fills unavailable samples from the
    nearest available one at a lower scan index; leading gap backfills
    from the first available; all-unavailable -> DC default.
    """
    B, T = gathered.shape
    pos = torch.arange(T, dtype=torch.int32, device=gathered.device)[None, :]
    idx = torch.where(avail, pos, -1)
    src = torch.cummax(idx, dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1).to(torch.int32)
    src = torch.where(src < 0, first[:, None], src)
    vals = torch.gather(gathered, 1, src.long())
    dc = 1 << (bit_depth - 1)
    return torch.where(avail.any(dim=1)[:, None], vals, dc).to(torch.int32)


def filter_refs(vals, n, bit_depth, filter_flag, strong_flag):
    """[1 2 1] smoothing + strong bilinear filter (Rec. 8.4.4.2.3).

    vals: [B, 4n+1]; filter_flag: [B] use_filtered_refs decision;
    strong_flag: [B] strong smoothing allowed (sps flag & luma & n==32) —
    the value-dependent threshold test happens here.
    """
    sm = torch.cat([
        vals[:, :1],
        (vals[:, :-2] + 2 * vals[:, 1:-1] + vals[:, 2:] + 2) >> 2,
        vals[:, -1:],
    ], dim=1)
    out = sm
    if n == 32:
        c = vals[:, 2 * n]
        bl = vals[:, 0]
        tr = vals[:, 4 * n]
        thr = 1 << (bit_depth - 5)
        f1 = torch.abs(c + tr - 2 * vals[:, 3 * n]) < thr
        f2 = torch.abs(c + bl - 2 * vals[:, n]) < thr
        wc, we = (_t(w, vals.device) for w in _strong_weights(n))
        pos = torch.arange(4 * n + 1, device=vals.device)[None, :]
        edge = torch.where(pos <= 2 * n, bl[:, None], tr[:, None])
        strong = (wc[None, :] * c[:, None] + we[None, :] * edge + n) >> 6
        out = torch.where((strong_flag & f1 & f2)[:, None], strong, sm)
    return torch.where(filter_flag[:, None], out, vals).to(torch.int32)


def predict(vals, mode, n, comp_is_luma, bit_depth, disable_bf):
    """Batched intra prediction (Rec. 8.4.4.2.4-6).

    vals: [B, 4n+1] (already substituted + filtered); mode: [B] int32
    (after any 4:2:2 angle mapping); disable_bf: [B] bool (implicit-RDPCM
    lossless edge-filter disable — gates mode 10/26 filters, not DC's).
    Returns [B, n, n] int32.
    """
    dev = vals.device
    B = vals.shape[0]
    maxv = (1 << bit_depth) - 1
    log2n = n.bit_length() - 1
    t1n = vals[:, 2 * n + 1:3 * n + 1]                       # top[1..n]
    l1n = torch.flip(vals[:, n:2 * n], (1,))                 # left[1..n]
    # planar (8.4.4.2.4)
    tr = vals[:, 3 * n + 1]
    bl = vals[:, n - 1]
    xx = torch.arange(n, dtype=torch.int32, device=dev)
    hor = ((n - 1 - xx)[None, None, :] * l1n[:, :, None] +
           (xx + 1)[None, None, :] * tr[:, None, None])
    ver = ((n - 1 - xx)[None, :, None] * t1n[:, None, :] +
           (xx + 1)[None, :, None] * bl[:, None, None])
    planar = (hor + ver + n) >> (log2n + 1)
    # DC (8.4.4.2.5); boundary filter unconditional for luma n<32
    dc = ((t1n.sum(dim=1) + l1n.sum(dim=1) + n) >> (log2n + 1)).to(torch.int32)
    dcp = dc[:, None, None].expand(B, n, n).clone()
    if comp_is_luma and n < 32:
        dcp[:, 0, :] = (t1n + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (l1n + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (vals[:, 2 * n - 1] + 2 * dc + vals[:, 2 * n + 1] + 2) >> 2
    # angular (8.4.4.2.6)
    ext_t, row_t, frac_t, vert_t = (_t(a, dev) for a in _ang_tables(n))
    ml = mode.long()
    ext = torch.gather(vals, 1, ext_t[ml].long())            # [B, 3n+2]
    rowb = row_t[ml]                                         # [B, n]
    frac = frac_t[ml]                                        # [B, n]
    gidx = (rowb[:, :, None] + xx[None, None, :]).reshape(B, -1).long()
    E = ext.shape[1]
    a = torch.gather(ext, 1, gidx).reshape(B, n, n)
    b = torch.gather(ext, 1, torch.clamp(gidx + 1, max=E - 1)).reshape(B, n, n)
    f = frac[:, :, None]
    ang = ((32 - f) * a + f * b + 16) >> 5
    vert = vert_t[ml]
    ang = torch.where(vert[:, None, None], ang, ang.transpose(1, 2))
    if comp_is_luma and n < 32:
        # exactly-vertical/-horizontal boundary filters
        corner = vals[:, 2 * n]
        v26 = torch.clamp(vals[:, 2 * n + 1][:, None] +
                          ((l1n - corner[:, None]) >> 1), 0, maxv)
        h10 = torch.clamp(vals[:, 2 * n - 1][:, None] +
                          ((t1n - corner[:, None]) >> 1), 0, maxv)
        use26 = ((mode == 26) & ~disable_bf)[:, None]
        use10 = ((mode == 10) & ~disable_bf)[:, None]
        ang = ang.clone()
        ang[:, :, 0] = torch.where(use26, v26, ang[:, :, 0])
        ang[:, 0, :] = torch.where(use10, h10, ang[:, 0, :])
    m = mode[:, None, None]
    return torch.where(m == 0, planar,
                       torch.where(m == 1, dcp, ang)).to(torch.int32)


def intra_level_plain(plane, res_plane, meta, level, *, n, is_luma, bd, W,
                      H):
    """Plain torch version of intra_level (any device)."""
    # imported here: parallel.intra_wavefront imports this module
    from ..parallel.intra_wavefront import unpack_block_meta
    Bp, _, K = meta["xs"].shape
    d = {k: v[:, level].reshape((Bp * K,) + v.shape[3:])
         for k, v in meta.items()}
    # real slots only (dummy slots have x = W + 1024)
    keep = torch.nonzero(d["xs"] < W).squeeze(1)
    if not keep.numel():
        return plane
    xs, ys, mode, filt, strong, dbf, av = unpack_block_meta(
        {k: v[keep] for k, v in d.items()}, n)
    bidx = torch.div(keep, K, rounding_mode="floor")
    cx, cy = border_coords(xs, ys, n, W, H)
    g = plane[bidx[:, None], cy.long(), cx.long()]
    vals = substitute(g, av, bd)
    vals = filter_refs(vals, n, bd, filt, strong)
    pred = predict(vals, mode, n, is_luma, bd, dbf)
    ar = torch.arange(n, device=plane.device)
    iy = (ys[:, None, None] + ar[None, :, None]).long()
    ix = (xs[:, None, None] + ar[None, None, :]).long()
    ib = bidx[:, None, None]
    out = torch.clamp(pred + res_plane[ib, iy, ix], 0, (1 << bd) - 1)
    shp = out.shape
    plane[ib.expand(shp), iy.expand(shp), ix.expand(shp)] = out
    return plane


# ---------------------------------------------------------------------------
# K2: one dependency level of one block size, all pictures
_K2 = Kernel("intra_level", [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                             I, I, I, I])


def intra_level(plane, res_plane, meta, level, *, n, is_luma, bd, W, H):
    """Reconstruct the size-n blocks of dependency level `level`, in place.

    plane, res_plane: [Bp, Hc, Wc] int32 (plane updated).
    meta: dict of per-size slot arrays over [Bp, L, K]: xs/ys int16
    (dummy x = W+1024), mode int8, flags uint8 (1 filt, 2 strong, 4 dbf),
    av uint8 [Bp, L, K, ceil((4n+1)/8)] little-endian availability bits.
    W, H: the component's picture size (border clamp; x >= W is a dummy).
    """
    if not plane.is_cuda:
        return intra_level_plain(plane, res_plane, meta, level, n=n,
                                 is_luma=is_luma, bd=bd, W=W, H=H)
    dev = plane.device
    check(plane, "plane", torch.int32, 3)
    check(res_plane, "res_plane", torch.int32, 3, dev)
    if res_plane.shape != plane.shape:
        raise ValueError("intra_level: plane/res_plane shapes differ")
    for k, dt in (("xs", torch.int16), ("ys", torch.int16),
                  ("mode", torch.int8), ("flags", torch.uint8)):
        check(meta[k], k, dt, 3, dev)
    check(meta["av"], "av", torch.uint8, 4, dev)
    Bp, Hc, Wc = plane.shape
    Bm, L, K = meta["xs"].shape
    nb = (4 * n + 8) >> 3
    if Bm != Bp or meta["av"].shape != (Bp, L, K, nb) or \
            any(meta[k].shape != (Bp, L, K) for k in ("ys", "mode", "flags")):
        raise ValueError("intra_level: inconsistent slot shapes")
    if n not in (4, 8, 16, 32) or not 0 <= level < L or \
            not 8 <= bd <= 12 or W > Wc or H > Hc:
        raise ValueError(f"intra_level: unsupported n={n} level={level} "
                         f"bd={bd} W={W} H={H}")
    _K2(ptr(plane), ptr(res_plane), ptr(meta["xs"]), ptr(meta["ys"]),
        ptr(meta["mode"]), ptr(meta["flags"]), ptr(meta["av"]),
        Bp, L, K, level, n, int(is_luma), bd, W, H, Hc, Wc, nb)
    return plane
