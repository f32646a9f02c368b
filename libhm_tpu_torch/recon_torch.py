"""Residual composition and reference planes of the batched decode path.

Port of the parts of libhm_tpu/recon_tpu.py that the reference-DAG decode
uses: the `_residual_fn` composition (dequant -> inverse transform or
transform skip -> RDPCM), here a plain function on tensors instead of a
cached jitted closure, and `_device_plane`.  `_pad_pow2` is not ported:
its pow2 buckets only let XLA reuse compiled programs.
"""
import numpy as np
import torch

from .ops import transform as TK
from .utils import xfer


def _device_plane(dp, c, H, W, device):
    """Device copy of a reference picture's component plane.

    Port of libhm_tpu/recon_tpu.py _device_plane.  A picture reconstructed
    by this decode already holds its filtered plane on the device
    (dag_decode._recon_levels); otherwise (a reference generated for a
    missing picture) its host plane is uploaded once and cached.
    """
    cache = getattr(dp, "_device_planes", None)
    if cache is None:
        cache = {}
        dp._device_planes = cache
    key = (c, H, W)
    if key not in cache:
        cache[key] = xfer.up(np.ascontiguousarray(dp.planes[c][:H, :W]),
                             "ref", device)
    return cache[key]


def _residual_fn(coeffs, qp, rdpcm, *, n, use_dst, path, bd, max_dyn,
                 rotate=False, mat=None):
    """Residual blocks [P, n, n] int32 of one TU bucket (plain torch);
    `mat` [P, n, n] holds each TU's scaling matrix (the JAX `scaling`
    closure flag is `mat is not None` here)."""
    if path == "bypass":
        res = TK.bypass_blocks(coeffs, rotate)
    else:
        res = TK.residual_blocks(coeffs, qp, n, use_dst, path == "tskip", bd,
                                 max_dyn, rotate, mat=mat)
    return TK.inverse_rdpcm_batch(res, rdpcm.to(torch.int32))
