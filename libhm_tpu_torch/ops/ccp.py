"""Cross-component prediction on the residual planes (row 11 of the kernel
table).

Port of libhm_tpu/parallel/batch_decode.py _ccp_fn, by H.265 8.6.6: in
4:4:4, a chroma TU with a cross-component alpha adds
(alpha * ((rY << BitDepthC) >> BitDepthY)) >> 3 to its residual, rY the
luma residual, clipped to int16.  The JAX _ccp_fn adds (alpha * rY) >> 3,
which is the same only at equal bit depths (ROADMAP C4); the port follows
H.265.  On the card this is an epilogue of K1's
chroma launch (csrc/residual.cu: F_CCP rows of the TU table, through
ops/transform.py residual_table), which adds it to each TU's residual
before the one store, so no pass of its own reads the chroma residual
back.  `ccp_apply_plain` is the plain version, which
`residual_table_plain` runs after its scatters.
"""
import torch

# TU table columns of ccp_apply
CCP_FIELDS = ("b", "y", "x", "n", "alpha")


def luma_scale(r, ccp_bd):
    """(r << BitDepthC) >> BitDepthY of H.265 8.6.6 on an int64 tensor of
    luma residuals, for ccp_bd = (BitDepthY, BitDepthC); None: one depth,
    so r itself.  A shift left or an arithmetic shift right by the depths'
    difference, which is the same value."""
    if ccp_bd is None:
        return r
    bdy, bdc = ccp_bd
    return r << (bdc - bdy) if bdc >= bdy else r >> (bdy - bdc)


def ccp_apply_plain(res_c, res_l, tus, clip=True, ccp_bd=None):
    """Plain torch version of cross-component prediction (any device), in
    place: one gather/scatter per TU size, as the JAX _ccp_fn is keyed by
    it.  clip: to int16, as the JAX package does (H.265 8.6.6 has no clip:
    extended-precision TUs pass False).  ccp_bd: (BitDepthY, BitDepthC),
    None when they are equal."""
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
        rl = luma_scale(res_l[ib, iy, ix].long(), ccp_bd)
        r = res_c[ib, iy, ix].long() + ((alpha * rl) >> 3)
        if clip:
            r = torch.clamp(r, -32768, 32767)
        res_c[ib, iy, ix] = r.to(res_c.dtype)
    return res_c


def ccp_apply(res_c, res_l, tus, ccp_bd=None):
    """Cross-component prediction of one chroma component, in place:
    res_c[b, y + i, x + j] = clip(res_c + ((alpha * rY) >> 3), -32768,
    32767) over each listed TU's n x n samples, rY = (res_l[b, y + i, x + j]
    << BitDepthC) >> BitDepthY for ccp_bd = (BitDepthY, BitDepthC) (None:
    equal depths, rY = res_l).

    res_c, res_l: [Bp, H, W] int32 chroma and luma residual planes (4:4:4,
    so of one size); tus: [M, 5] int32 rows of CCP_FIELDS, alpha in
    {+-1, +-2, +-4, +-8}, n in {4, 8, 16, 32}.  TUs must not overlap.
    CPU tensors only: on the card CCP runs inside K1's chroma launch.
    """
    if res_c.is_cuda:
        raise ValueError("ccp_apply: on the card, cross-component prediction "
                         "is the epilogue of K1's chroma launch (F_CCP rows "
                         "through ops/transform.py residual_table)")
    return ccp_apply_plain(res_c, res_l, tus, ccp_bd=ccp_bd)
