"""Batched dequant + inverse transform, and the fused residual kernel (K1).

Port of libhm_tpu/ops/transform.py.  The plain functions keep the JAX
semantics on [N, n, n] int32 tensors; the TPU's int8-limb matmul split is
dropped (an int64 matmul is exact here).  `residual_scatter` is the
kernel wrapper: dequant -> inverse DCT/DST or transform skip -> write into
the stacked residual planes, as one CUDA kernel (csrc/residual.cu) for a
CUDA tensor and as the plain functions for a CPU tensor.
"""
import torch

from ..hostdec.tables import DCT, DST4, INV_QUANT_SCALES

from ..kernels.build import I, P, Kernel, check, ptr

I16MIN, I16MAX = -32768, 32767


def dequant_batch(coeffs, qp, bit_depth, log2_size, max_dyn_range=15):
    """coeffs: [N, n, n] int32; qp: [N] int32 (incl. bit-depth offset)."""
    per = torch.div(qp, 6, rounding_mode="floor")
    rem = qp % 6
    scale = torch.as_tensor(INV_QUANT_SCALES, device=qp.device)[rem.long()]
    tshift = max_dyn_range - bit_depth - log2_size
    right = (6 - (tshift + per))[:, None, None]                # [N,1,1]
    target_bits = torch.clamp(32 + right - 7, max=max_dyn_range + 1)
    hi = (1 << (target_bits - 1).long()) - 1
    c = torch.maximum(torch.minimum(coeffs.long(), hi), -hi - 1)
    prod = c * scale.long()[:, None, None]
    rp = torch.clamp(right, min=0).long()
    rn = torch.clamp(-right, min=0).long()
    add = torch.where(right > 0, 1 << torch.clamp(rp - 1, min=0), 0)
    q = torch.where(right > 0, (prod + add) >> rp, prod << rn)
    tmin, tmax = -(1 << max_dyn_range), (1 << max_dyn_range) - 1
    return torch.clamp(q, tmin, tmax).to(torch.int32)


def _matrix(n, use_dst, device):
    m = DST4 if (use_dst and n == 4) else DCT[n]
    return torch.as_tensor(m, dtype=torch.float64, device=device)


def inverse_transform_batch(coeffs, n, use_dst, bit_depth, max_dyn_range=15):
    """coeffs: [N, n, n] int32 dequantized -> residual [N, n, n] int32.

    Two-stage exact integer transform; both stages clip to int16 range.
    """
    t = _matrix(n, use_dst, coeffs.device)
    shift1 = 7
    shift2 = (6 + max_dyn_range - 1) - bit_depth
    # float64 products are exact: every partial sum is an integer below
    # 32768 * 90 * 32 < 2^53 (and CUDA has no integer matmul)
    s1 = torch.matmul(t.T, coeffs.double()).long()             # T^T @ C
    s1 = torch.clamp((s1 + (1 << (shift1 - 1))) >> shift1, I16MIN, I16MAX)
    s2 = torch.matmul(s1.double(), t).long()                   # S1 @ T
    s2 = torch.clamp((s2 + (1 << (shift2 - 1))) >> shift2, I16MIN, I16MAX)
    return s2.to(torch.int32)


def inverse_transform_skip_batch(coeffs, bit_depth, log2_size,
                                 max_dyn_range=15, rotate=False):
    tshift = max_dyn_range - bit_depth - log2_size
    c = coeffs.long()
    if rotate:
        c = torch.flip(c, (1, 2))
    if tshift >= 0:
        off = 0 if tshift == 0 else (1 << (tshift - 1))
        r = (c + off) >> tshift
    else:
        r = c << (-tshift)
    return torch.clamp(r, I16MIN, I16MAX).to(torch.int32)


def inverse_rdpcm_batch(res, mode):
    """mode: [N] int32 (0 off, 1 hor, 2 ver)."""
    h = torch.cumsum(res, dim=2)
    v = torch.cumsum(res, dim=1)
    m = mode[:, None, None]
    out = torch.where(m == 1, h, torch.where(m == 2, v, res.long()))
    return torch.clamp(out, I16MIN, I16MAX).to(torch.int32)


def residual_blocks(coeffs, qp, n, use_dst, tskip, bd, max_dyn_range=15,
                    rotate=False):
    """Plain dequant + (transform skip | inverse DCT/DST) of one bucket."""
    log2n = n.bit_length() - 1
    deq = dequant_batch(coeffs.to(torch.int32), qp.to(torch.int32), bd, log2n,
                        max_dyn_range)
    if tskip:
        return inverse_transform_skip_batch(deq, bd, log2n, max_dyn_range,
                                            rotate)
    return inverse_transform_batch(deq, n, use_dst, bd, max_dyn_range)


def residual_scatter_plain(planes, coeffs, qp, bsel, ysel, xsel, *, n,
                           use_dst, tskip, bd):
    """Plain torch version of residual_scatter (any device)."""
    res = residual_blocks(coeffs, qp, n, use_dst, tskip, bd)
    keep = bsel < planes.shape[0]
    res, b, y, x = res[keep], bsel[keep].long(), ysel[keep].long(), \
        xsel[keep].long()
    ar = torch.arange(n, device=planes.device)
    iy = (y[:, None, None] + ar[None, :, None]).expand(res.shape)
    ix = (x[:, None, None] + ar[None, None, :]).expand(res.shape)
    planes[b[:, None, None].expand(res.shape), iy, ix] = res
    return planes


# ---------------------------------------------------------------------------
# K1: fused residual kernel
_K1 = Kernel("residual_scatter", [P, P, P, P, P, I, I, I, I, I, P, I, I, I])


def residual_scatter(planes, coeffs, qp, bsel, ysel, xsel, *, n, use_dst,
                     tskip, bd):
    """Residuals of one TU bucket written into the stacked planes, in place.

    planes: [Bp, Hc, Wc] int32 residual planes of one component (updated).
    coeffs: [P, n, n] int16 coefficient levels; qp: [P] int8 (incl. the
    bit-depth offset); bsel/ysel/xsel: [P] int32 picture index and sample
    origin of each TU.  Entries with bsel >= Bp (padding) are skipped.
    Non-extended precision only (max_dyn_range 15), no scaling lists.
    """
    if not planes.is_cuda:
        return residual_scatter_plain(planes, coeffs, qp, bsel, ysel, xsel,
                                      n=n, use_dst=use_dst, tskip=tskip,
                                      bd=bd)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(coeffs, "coeffs", torch.int16, 3, dev)
    check(qp, "qp", torch.int8, 1, dev)
    for t, name in ((bsel, "bsel"), (ysel, "ysel"), (xsel, "xsel")):
        check(t, name, torch.int32, 1, dev)
    npad = coeffs.shape[0]
    if coeffs.shape[1:] != (n, n) or not (
            qp.shape[0] == bsel.shape[0] == ysel.shape[0] == xsel.shape[0]
            == npad):
        raise ValueError("residual_scatter: inconsistent bucket shapes")
    if n not in (4, 8, 16, 32) or (use_dst and n != 4) or \
            not 8 <= bd <= 12:
        raise ValueError(f"residual_scatter: unsupported n={n} "
                         f"use_dst={use_dst} tskip={tskip} bd={bd}")
    if npad == 0:
        return planes
    Bp, H, W = planes.shape
    _K1(ptr(coeffs), ptr(qp), ptr(bsel), ptr(ysel), ptr(xsel), npad, n,
        int(use_dst and not tskip), int(tskip), bd, ptr(planes), Bp, H, W)
    return planes
