"""Batched dequant + inverse transform, and the fused residual kernel (K1).

Port of libhm_tpu/ops/transform.py.  The plain functions keep the JAX
semantics on [N, n, n] int32 tensors; the TPU's int8-limb matmul split is
dropped (an int64 matmul is exact here).  `residual_table` is the kernel
wrapper: every TU of one component of a level, from a flat table of
TU_DTYPE rows sorted by size and a packed coefficient buffer (int16, or
int32 for a table with extended-precision rows), dequantized (flat, or
with scaling matrices) -> inverse DCT/DST or
transform skip (or, for transquant-bypass TUs, the coefficients as they
are) -> RDPCM -> cross-component prediction (4:4:4 chroma rows with an
alpha, from the level's finished luma residual) -> written into the
stacked residual planes; one CUDA launch (csrc/residual.cu) for a CUDA
tensor, `residual_table_plain` for a CPU tensor.  Rows with F_EXT (RExt
extended_precision_processing_flag) follow H.265 at max_dyn_range
max(15, bd + 6), exactly (`residual_blocks(..., ext=True)`), where the
JAX package's functions are exact only while every value fits in int16.
`residual_scatter` keeps the per-bucket signature: it builds a one-size
table and goes through `residual_table`.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..hostdec.tables import DCT, DST4, INV_QUANT_SCALES

from ..kernels.build import I, P, Kernel, check, ptr
from .ccp import ccp_apply_plain

I16MIN, I16MAX = -32768, 32767
# max_dyn_range of the JAX package's functions, which these mirror; rows
# with F_EXT take residual_blocks(..., ext=True) instead
MAX_DYN = 15


def dequant_batch(coeffs, qp, bit_depth, log2_size):
    """coeffs: [N, n, n] int32; qp: [N] int32 (incl. bit-depth offset)."""
    per = torch.div(qp, 6, rounding_mode="floor")
    rem = qp % 6
    scale = torch.as_tensor(INV_QUANT_SCALES, device=qp.device)[rem.long()]
    tshift = MAX_DYN - bit_depth - log2_size
    right = (6 - (tshift + per))[:, None, None]                # [N,1,1]
    target_bits = torch.clamp(32 + right - 7, max=MAX_DYN + 1)
    hi = (1 << (target_bits - 1).long()) - 1
    c = torch.maximum(torch.minimum(coeffs.long(), hi), -hi - 1)
    prod = c * scale.long()[:, None, None]
    rp = torch.clamp(right, min=0).long()
    rn = torch.clamp(-right, min=0).long()
    add = torch.where(right > 0, 1 << torch.clamp(rp - 1, min=0), 0)
    q = torch.where(right > 0, (prod + add) >> rp, prod << rn)
    return torch.clamp(q, I16MIN, I16MAX).to(torch.int32)


def dequant_batch_scaling(coeffs, qp, mat, bit_depth, log2_size):
    """Dequant with per-TU scaling matrices (Rec. 8.6.3 with m[x][y]).

    coeffs: [N, n, n] int32; qp: [N]; mat: [N, n, n] scaling factors.
    """
    per = torch.div(qp, 6, rounding_mode="floor")
    rem = qp % 6
    scale = torch.as_tensor(INV_QUANT_SCALES, device=qp.device)[rem.long()]
    tshift = MAX_DYN - bit_depth - log2_size
    right = (6 - (tshift + per) + 4)[:, None, None]  # + log2(16), the neutral
    target_bits = torch.clamp(32 + right - 15, max=MAX_DYN + 1)
    hi = (1 << (target_bits - 1).long()) - 1
    c = torch.maximum(torch.minimum(coeffs.long(), hi), -hi - 1)
    prod = c * (mat.long() * scale.long()[:, None, None])
    rp = torch.clamp(right, min=0).long()
    rn = torch.clamp(-right, min=0).long()
    add = torch.where(right > 0, 1 << torch.clamp(rp - 1, min=0), 0)
    q = torch.where(right > 0, (prod + add) >> rp, prod << rn)
    return torch.clamp(q, I16MIN, I16MAX).to(torch.int32)


def _matrix(n, use_dst, device):
    m = DST4 if (use_dst and n == 4) else DCT[n]
    return torch.as_tensor(m, dtype=torch.float64, device=device)


def inverse_transform_batch(coeffs, n, use_dst, bit_depth):
    """coeffs: [N, n, n] int32 dequantized -> residual [N, n, n] int32.

    Two-stage exact integer transform; both stages clip to int16 range.
    """
    t = _matrix(n, use_dst, coeffs.device)
    shift1 = 7
    shift2 = (6 + MAX_DYN - 1) - bit_depth
    # float64 products are exact: every partial sum is an integer below
    # 32768 * 90 * 32 < 2^53 (and CUDA has no integer matmul)
    s1 = torch.matmul(t.T, coeffs.double()).long()             # T^T @ C
    s1 = torch.clamp((s1 + (1 << (shift1 - 1))) >> shift1, I16MIN, I16MAX)
    s2 = torch.matmul(s1.double(), t).long()                   # S1 @ T
    s2 = torch.clamp((s2 + (1 << (shift2 - 1))) >> shift2, I16MIN, I16MAX)
    return s2.to(torch.int32)


def inverse_transform_skip_batch(coeffs, bit_depth, log2_size, rotate=False):
    tshift = MAX_DYN - bit_depth - log2_size
    c = coeffs.long()
    if rotate:
        c = torch.flip(c, (1, 2))
    if tshift >= 0:
        off = 0 if tshift == 0 else (1 << (tshift - 1))
        r = (c + off) >> tshift
    else:
        r = c << (-tshift)
    return torch.clamp(r, I16MIN, I16MAX).to(torch.int32)


def inverse_rdpcm_batch(res, mode, clip=True):
    """mode: [N] int32 (0 off, 1 hor, 2 ver).  clip: to int16, as the JAX
    package does (H.265 8.6.8 has no clip: extended-precision rows pass
    False)."""
    h = torch.cumsum(res, dim=2)
    v = torch.cumsum(res, dim=1)
    m = mode[:, None, None]
    out = torch.where(m == 1, h, torch.where(m == 2, v, res.long()))
    if clip:
        out = torch.clamp(out, I16MIN, I16MAX)
    return out.to(torch.int32)


def bypass_blocks(coeffs, rotate=False, clip=True):
    """Transquant-bypass residual: the coefficients, clipped to int16 as
    the JAX package does (extended-precision rows pass clip=False)."""
    res = coeffs.to(torch.int32)
    if rotate:
        res = torch.flip(res, (1, 2))
    return torch.clamp(res, I16MIN, I16MAX) if clip else res


def residual_blocks(coeffs, qp, n, use_dst, tskip, bd, rotate=False,
                    mat=None, ext=False):
    """Plain dequant (with scaling matrices `mat` [N, n, n] when given) +
    (transform skip | inverse DCT/DST) of one bucket: the JAX package's
    arithmetic at max_dyn_range 15, or with `ext` (extended precision,
    F_EXT rows) `_residual_ext`."""
    if ext:
        return _residual_ext(coeffs, qp, n, use_dst, tskip, bd, rotate, mat)
    log2n = n.bit_length() - 1
    if mat is None:
        deq = dequant_batch(coeffs.to(torch.int32), qp.to(torch.int32), bd,
                            log2n)
    else:
        deq = dequant_batch_scaling(coeffs.to(torch.int32),
                                    qp.to(torch.int32), mat, bd, log2n)
    if tskip:
        return inverse_transform_skip_batch(deq, bd, log2n, rotate)
    return inverse_transform_batch(deq, n, use_dst, bd)


def _residual_ext(coeffs, qp, n, use_dst, tskip, bd, rotate, mat):
    """Residual blocks [N, n, n] int32 of extended-precision TUs, exact in
    int64: H.265 8.6.2-8.6.4 at max_dyn_range M = max(15, bd + 6).

    The dequant (8.6.3): Clip3(-2^M, 2^M - 1, (c * m * levelScale <<
    qp / 6 + (1 << bdShift - 1)) >> bdShift), bdShift = bd + log2n + 10 - M,
    m 16 or the scaling factor `mat`, after HM's input clip of the level to
    [-2^M, 2^M - 1] (its build with a 64-bit intermediate, which decodes
    extended precision; a conforming level lies there already).  Then
    transform skip, rotated, shifted right by max(M - bd - log2n, 0) with
    rounding (HM's xITransformSkip under the flag; H.265's
    (d << tsShift) >> bdShift with tsShift = 5 + log2n is the same shift
    here), or the inverse DCT/DST: columns, (e + 64) >> 7 clipped to
    [-2^M, 2^M - 1], then rows, rounded by max(20 - bd, 11).  Neither the
    residual nor the transform-skip output is clipped: H.265 has no clip
    there, where the JAX package clips to int16 (ROADMAP C12)."""
    log2n = n.bit_length() - 1
    M = max(15, bd + 6)
    lo, hi = -(1 << M), (1 << M) - 1
    c = torch.clamp(coeffs.long(), lo, hi)
    qp = qp.long()
    per = torch.div(qp, 6, rounding_mode="floor")[:, None, None]
    scale = torch.as_tensor(INV_QUANT_SCALES, device=c.device)[qp % 6]
    m = 16 if mat is None else mat.long()
    bd_shift = bd + log2n + 10 - M
    d = torch.clamp(((c * m * scale[:, None, None]) << per) +
                    (1 << (bd_shift - 1)) >> bd_shift, lo, hi)
    if tskip:
        ts = max(M - bd - log2n, 0)
        if rotate:
            d = torch.flip(d, (1, 2))
        return ((d + ((1 << ts) >> 1)) >> ts).to(torch.int32)
    t = _matrix(n, use_dst, c.device)
    # float64 products are exact: every partial sum is an integer below
    # 2^22 * 90 * 32 < 2^53
    e = torch.matmul(t.T, d.double()).long()
    g = torch.clamp((e + 64) >> 7, lo, hi)
    r = torch.matmul(g.double(), t).long()
    shift2 = max(20 - bd, 11)
    return ((r + (1 << (shift2 - 1))) >> shift2).to(torch.int32)


# ---------------------------------------------------------------------------
# K1: one launch per (level, component) over a flat table of TUs

# one row of the TU table (csrc/residual.cu TuRow), 16 bytes: the first
# coefficient of the TU in the packed coefficient buffer, picture, sample
# origin, log2 size, qp (incl. the bit-depth offset), mode flags, RDPCM
# direction (0 off, 1 horizontal, 2 vertical) in bits 0-1 of `rdpcm` and
# the CCP alpha of F_CCP rows in its bits 4-7 (ccp_bits), scaling-matrix
# row, bit depth
TU_DTYPE = np.dtype([("off", "<u4"), ("b", "<i2"), ("y", "<u2"),
                     ("x", "<u2"), ("log2n", "u1"), ("qp", "i1"),
                     ("flags", "u1"), ("rdpcm", "u1"), ("midx", "u1"),
                     ("bd", "u1")])
F_DST, F_TSKIP, F_BYPASS, F_ROTATE, F_SCALED, F_CCP = 1, 2, 4, 8, 16, 32
# extended precision: the row's max_dyn_range is max(15, bd + 6)
# (residual_blocks(..., ext=True)); a table with such a row has int32
# coefficients
F_EXT = 64
SIZES = (4, 8, 16, 32)


def ccp_bits(alpha):
    """The high bits of the `rdpcm` byte that carry CCP alphas (numpy
    array of 0, +-1, +-2, +-4, +-8): log2|alpha| + 1 in bits 4-6, the sign
    in bit 7, 0 for no alpha."""
    a = np.asarray(alpha, np.int64)
    mag = np.abs(a)
    if not np.isin(mag, (0, 1, 2, 4, 8)).all():
        raise ValueError("CCP alpha outside 0, +-1, +-2, +-4, +-8")
    code = np.where(mag > 0, np.log2(np.maximum(mag, 1)).astype(np.int64)
                    + 1, 0)
    return ((code << 4) | ((a < 0) << 7)).astype(np.uint8)


class TuTable(NamedTuple):
    """The TUs of one component of one level, as K1 takes them."""
    rows: torch.Tensor      # uint8 [N, 16]: TU_DTYPE rows sorted by size
    coeffs: torch.Tensor    # [K] the packed coefficients: int16, or int32
                            # (coeff_dtype) when a row has F_EXT
    counts: tuple           # rows of each size in SIZES
    flags: int              # OR of every row's flags


def coeff_dtype(flags):
    """The coefficient dtype of a table whose rows' flags OR to `flags`."""
    return torch.int32 if flags & F_EXT else torch.int16


def _fields(rows):
    """The TU_DTYPE fields of uint8 [N, 16] rows, as int64 tensors."""
    w = rows.view(torch.int32).long() & 0xFFFFFFFF           # [N, 4]
    sext = lambda v, bits: (v ^ (1 << (bits - 1))) - (1 << (bits - 1))  # noqa
    code = (w[:, 3] >> 12) & 7
    alpha = torch.where(code > 0, 1 << torch.clamp(code - 1, min=0), 0) * \
        (1 - 2 * ((w[:, 3] >> 15) & 1))
    return {"off": w[:, 0], "b": sext(w[:, 1] & 0xFFFF, 16),
            "y": w[:, 1] >> 16, "x": w[:, 2] & 0xFFFF,
            "log2n": (w[:, 2] >> 16) & 0xFF, "qp": sext(w[:, 2] >> 24, 8),
            "flags": w[:, 3] & 0xFF, "rdpcm": (w[:, 3] >> 8) & 3,
            "alpha": alpha * ((w[:, 3] & F_CCP) != 0),
            "midx": (w[:, 3] >> 16) & 0xFF,
            "bd": w[:, 3] >> 24}


def _check_ccp(planes, table, res_l, ccp_bd):
    if table.flags & F_CCP and (res_l is None or
                                res_l.shape != planes.shape):
        raise ValueError("residual_table: CCP rows need the luma residual "
                         "res_l, of the chroma planes' shape (4:4:4)")
    if ccp_bd is not None and not all(8 <= int(d) <= 16 for d in ccp_bd):
        raise ValueError(f"residual_table: CCP bit depths {ccp_bd} outside "
                         "8-16")


def residual_table_plain(planes, table, mats=None, res_l=None, ccp_bd=None):
    """Plain torch version of residual_table (any device), in place."""
    _check_ccp(planes, table, res_l, ccp_bd)
    f = _fields(table.rows)
    dev = planes.device
    want = torch.repeat_interleave(
        torch.arange(2, 6, device=dev),
        torch.tensor(table.counts, device=dev))
    if not torch.equal(f["log2n"], want):
        raise ValueError("residual_table: rows not sorted by size as the "
                         "counts say")
    Bp, H, W = planes.shape
    key = f["log2n"] | (f["flags"] << 3) | (f["bd"] << 10)
    for k in torch.unique(key).tolist():
        i = torch.nonzero(key == k).squeeze(1)
        log2n, flags, bd = k & 7, (k >> 3) & 127, k >> 10
        n = 1 << log2n
        idx = f["off"][i, None] + torch.arange(n * n, device=dev)
        c = table.coeffs[idx].view(-1, n, n)
        rotate = bool(flags & F_ROTATE)
        ext = bool(flags & F_EXT)
        if flags & F_BYPASS:
            res = bypass_blocks(c, rotate, clip=not ext)
        else:
            mat = mats[n][f["midx"][i]] if flags & F_SCALED else None
            res = residual_blocks(c, f["qp"][i], n, bool(flags & F_DST),
                                  bool(flags & F_TSKIP), bd, rotate=rotate,
                                  mat=mat, ext=ext)
        rd = f["rdpcm"][i]
        if rd.any():
            res = inverse_rdpcm_batch(res, rd.to(torch.int32), clip=not ext)
        # rows of pictures outside [0, Bp) and samples outside the plane
        # are not written
        keep = (f["b"][i] >= 0) & (f["b"][i] < Bp)
        b, y, x, res = f["b"][i][keep], f["y"][i][keep], f["x"][i][keep], \
            res[keep]
        ar = torch.arange(n, device=dev)
        iy = (y[:, None, None] + ar[None, :, None]).expand(res.shape)
        ix = (x[:, None, None] + ar[None, None, :]).expand(res.shape)
        m = (iy < H) & (ix < W)
        planes[b[:, None, None].expand(res.shape)[m], iy[m], ix[m]] = res[m]
    # cross-component prediction once every row's residual is in place, as
    # the JAX package runs _ccp_fn after its scatters (TUs never overlap);
    # F_EXT rows unclipped; the luma residual scaled by the bit depths
    # (H.265 8.6.6)
    for ext in (0, F_EXT):
        i = torch.nonzero((f["flags"] & (F_CCP | F_EXT)) ==
                          F_CCP | ext).squeeze(1)
        if len(i):
            ccp_apply_plain(planes, res_l, torch.stack(
                [f["b"][i], f["y"][i], f["x"][i], 1 << f["log2n"][i],
                 f["alpha"][i]], 1), clip=not ext, ccp_bd=ccp_bd)
    return planes


class _ModeCount:
    """Launches of K1 whose table holds rows of one mode (a count only:
    every mode runs in the one kernel)."""

    def __init__(self, name):
        self.name = name
        self.launches = 0


_K1 = Kernel("residual_table", [P] * 6 + [I] * 4 + [P, P] + [I] * 6)
_K1_SCAL = _ModeCount("residual_table with scaled rows")
_K1_BYPASS = _ModeCount("residual_table with bypass rows")
_K1_CCP = _ModeCount("residual_table with CCP rows")
_K1_EXT = _ModeCount("residual_table, wide form (F_EXT rows)")


def residual_table(planes, table, mats=None, res_l=None, ccp_bd=None):
    """Residuals of every TU of `table` written into the stacked planes,
    in place: one K1 launch.

    planes: [Bp, Hc, Wc] int32 residual planes of one component (updated).
    table: a TuTable (rows sorted by size; rows of pictures outside
    [0, Bp) are skipped, samples outside the plane not written).  mats:
    {n: uint8 [M, n, n]} the level's scaling matrices per size, which the
    scaled rows index by their `midx`.  res_l: the level's finished luma
    residual planes, of the shape of `planes` (4:4:4), which F_CCP rows
    (cross-component prediction) read: res += (alpha * rY) >> 3, clipped
    to int16 outside F_EXT rows, rY = (res_l << BitDepthC) >> BitDepthY
    (H.265 8.6.6); needed when the table has such rows.  ccp_bd:
    (BitDepthY, BitDepthC), None when the two are equal (rY = res_l).  Bit
    depths 8-16 outside bypass rows.  A table with F_EXT rows
    (extended precision) has int32 coefficients and launches K1's wide
    form (counted in _K1_EXT as well as _K1).
    """
    if not planes.is_cuda:
        return residual_table_plain(planes, table, mats, res_l, ccp_bd)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    _check_ccp(planes, table, res_l, ccp_bd)
    ccp = bool(table.flags & F_CCP)
    if ccp:
        check(res_l, "res_l", torch.int32, 3, dev)
    check(table.rows, "rows", torch.uint8, 2, dev)
    wide = bool(table.flags & F_EXT)
    check(table.coeffs, "coeffs", coeff_dtype(table.flags), 1, dev)
    counts = tuple(int(c) for c in table.counts)
    N = table.rows.shape[0]
    if table.rows.shape[1] != TU_DTYPE.itemsize or len(counts) != 4 or \
            min(counts) < 0 or sum(counts) != N or \
            table.rows.data_ptr() % 16:
        raise ValueError("residual_table: rows must be 16-byte aligned "
                         "TU_DTYPE rows, as many as the counts")
    mp = []
    for n in SIZES:
        m = (mats or {}).get(n)
        if m is not None:
            check(m, f"mats[{n}]", torch.uint8, 3, dev)
            if m.shape[1:] != (n, n):
                raise ValueError("residual_table: inconsistent matrix shapes")
        elif table.flags & F_SCALED and counts[SIZES.index(n)]:
            raise ValueError(f"residual_table: scaled rows need mats[{n}]")
        mp.append(ptr(m))
    Bp, H, W = planes.shape
    if Bp > 32767:
        raise ValueError("residual_table: more pictures than an int16 holds")
    if N == 0:
        return planes
    _K1(ptr(table.rows), ptr(table.coeffs), *mp, *counts, ptr(planes),
        ptr(res_l) if ccp else None, Bp, H, W, int(wide),
        *(map(int, ccp_bd) if ccp_bd is not None else (8, 8)))
    if table.flags & F_SCALED:
        _K1_SCAL.launches += 1
    if table.flags & F_BYPASS:
        _K1_BYPASS.launches += 1
    if ccp:
        _K1_CCP.launches += 1
    if wide:
        _K1_EXT.launches += 1
    return planes


def _bucket_table(planes, coeffs, qp, bsel, ysel, xsel, n, use_dst, tskip,
                  bd, bypass, mats, midx, rotate, rdpcm):
    """residual_scatter's checks, and its bucket as a one-size TuTable
    built on the tensors' device (entries with bsel outside [0, Bp) get
    picture -1), with the matrices as residual_table takes them."""
    P = coeffs.shape[0]
    if coeffs.dim() != 3 or coeffs.shape[1:] != (n, n) or \
            coeffs.dtype != torch.int16 or not (
                bsel.shape[0] == ysel.shape[0] == xsel.shape[0] == P):
        raise ValueError("residual_scatter: inconsistent bucket shapes")
    for t in (qp, midx, rdpcm):
        if t is not None and t.shape[0] != P:
            raise ValueError("residual_scatter: inconsistent bucket shapes")
    if n not in SIZES or (rotate and n != 4):
        raise ValueError(f"residual_scatter: unsupported n={n} "
                         f"rotate={rotate}")
    if bypass:
        if mats is not None:
            raise ValueError("residual_scatter: bypass TUs take no matrix")
    elif qp is None or (use_dst and n != 4) or not 8 <= bd <= 16:
        raise ValueError(f"residual_scatter: unsupported n={n} "
                         f"use_dst={use_dst} tskip={tskip} bd={bd}")
    if mats is not None and (midx is None or mats.shape[1:] != (n, n)):
        raise ValueError("residual_scatter: inconsistent matrix shapes")
    dev = coeffs.device
    flags = (F_BYPASS if bypass else
             (F_TSKIP if tskip else F_DST * bool(use_dst)) |
             F_SCALED * (mats is not None)) | F_ROTATE * bool(rotate)
    z = torch.zeros(P, dtype=torch.int64, device=dev)
    b = bsel.long()
    b = torch.where((b >= 0) & (b < planes.shape[0]), b, -1)
    w = torch.stack([
        torch.arange(P, device=dev) * (n * n),
        (b & 0xFFFF) | (ysel.long() << 16),
        xsel.long() | ((n.bit_length() - 1) << 16) |
        ((z if qp is None else qp.long() & 0xFF) << 24),
        flags | ((z if rdpcm is None else rdpcm.long()) << 8) |
        ((z if midx is None else midx.long()) << 16) | (bd << 24)], 1)
    rows = ((w + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32) \
        .view(torch.uint8)
    counts = tuple(P if s == n else 0 for s in SIZES)
    return (TuTable(rows, coeffs.contiguous().reshape(-1), counts, flags),
            None if mats is None else {n: mats})


def residual_scatter_plain(planes, coeffs, qp, bsel, ysel, xsel, *, n,
                           use_dst, tskip, bd, bypass=False, mats=None,
                           midx=None, rotate=False, rdpcm=None):
    """Plain torch version of residual_scatter (any device)."""
    table, m = _bucket_table(planes, coeffs, qp, bsel, ysel, xsel, n,
                             use_dst, tskip, bd, bypass, mats, midx, rotate,
                             rdpcm)
    return residual_table_plain(planes, table, m)


def residual_scatter(planes, coeffs, qp, bsel, ysel, xsel, *, n, use_dst,
                     tskip, bd, bypass=False, mats=None, midx=None,
                     rotate=False, rdpcm=None):
    """Residuals of one TU bucket written into the stacked planes, in place:
    a one-size TU table through residual_table, one K1 launch.

    planes: [Bp, Hc, Wc] int32 residual planes of one component (updated).
    coeffs: [P, n, n] int16 coefficient levels; qp: [P] int8 (incl. the
    bit-depth offset); bsel/ysel/xsel: [P] int32 picture index and sample
    origin of each TU (below 65536).  Entries with bsel >= Bp (padding)
    are skipped.  Three modes: flat dequant (the default); scaling lists, with `mats`
    [M, n, n] uint8 the level's matrices of this size and `midx` [P] uint8
    each TU's row of it; `bypass` (transquant bypass: qp, use_dst and tskip
    unused, the coefficients are the residual).  `rotate`: the bucket's
    transform-skip rotation; `rdpcm`: [P] int8 RDPCM direction per TU
    (0 off, 1 horizontal, 2 vertical) or None.  Non-extended precision
    (max_dyn_range 15): residual_table takes F_EXT rows.
    """
    table, m = _bucket_table(planes, coeffs, qp, bsel, ysel, xsel, n,
                             use_dst, tskip, bd, bypass, mats, midx, rotate,
                             rdpcm)
    return residual_table(planes, table, m)
