"""Cross-component prediction on the residual planes (K10).

Port of libhm_tpu/parallel/batch_decode.py _ccp_fn: in 4:4:4, a chroma TU
with a cross-component alpha adds (alpha * luma residual) >> 3 to its
residual, clipped to int16.  `ccp_apply` is the kernel wrapper: one launch
of csrc/ccp.cu per (component, level) over a table of that level's CCP
TUs, of any size, for CUDA planes; the plain version for CPU planes.
"""
import torch

from ..kernels.build import I, P, Kernel, check, ptr

# TU table columns of ccp_apply
CCP_FIELDS = ("b", "y", "x", "n", "alpha")

_K10 = Kernel("ccp_apply", [P, P, P, I, I, I, I])


def ccp_apply_plain(res_c, res_l, tus):
    """Plain torch version of ccp_apply (any device), in place: one
    gather/scatter per TU size, as the JAX _ccp_fn is keyed by it."""
    Bp, H, W = res_c.shape
    tus = tus.long()
    for n in torch.unique(tus[:, 3]).tolist():
        t = tus[tus[:, 3] == n]
        ar = torch.arange(n, device=res_c.device)
        shp = (t.shape[0], n, n)
        ib = t[:, 0, None, None].expand(shp)
        iy = (t[:, 1, None, None] + ar[None, :, None]).expand(shp)
        ix = (t[:, 2, None, None] + ar[None, None, :]).expand(shp)
        # samples past the plane are dropped, as the JAX scatter's
        # mode="drop"
        keep = (ib >= 0) & (ib < Bp) & (iy >= 0) & (iy < H) & (ix >= 0) & \
            (ix < W)
        ib, iy, ix = ib[keep], iy[keep], ix[keep]
        alpha = t[:, 4, None, None].expand(shp)[keep]
        r = res_c[ib, iy, ix].long() + ((alpha * res_l[ib, iy, ix].long())
                                        >> 3)
        res_c[ib, iy, ix] = torch.clamp(r, -32768, 32767).to(res_c.dtype)
    return res_c


def ccp_apply(res_c, res_l, tus):
    """Cross-component prediction of one chroma component, in place:
    res_c[b, y + i, x + j] = clip(res_c + ((alpha * res_l[b, y + i, x + j])
    >> 3), -32768, 32767) over each listed TU's n x n samples.

    res_c, res_l: [Bp, H, W] int32 chroma and luma residual planes (4:4:4,
    so of one size); tus: [M, 5] int32 rows of CCP_FIELDS, alpha in
    {+-1, +-2, +-4, +-8}, n in {4, 8, 16, 32}.  TUs must not overlap.
    """
    if not res_c.is_cuda:
        return ccp_apply_plain(res_c, res_l, tus)
    dev = res_c.device
    check(res_c, "res_c", torch.int32, 3)
    check(res_l, "res_l", torch.int32, 3, dev)
    check(tus, "tus", torch.int32, 2, dev)
    if res_l.shape != res_c.shape or tus.shape[1] != len(CCP_FIELDS):
        raise ValueError("ccp_apply: inconsistent shapes")
    Bp, H, W = res_c.shape
    M = tus.shape[0]
    if M:
        _K10(ptr(res_c), ptr(res_l), ptr(tus), M, Bp, H, W)
    return res_c
