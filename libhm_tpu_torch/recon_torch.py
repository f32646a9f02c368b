"""Per-picture reconstruction, residual composition and reference planes.

Port of the parts of libhm_tpu/recon_tpu.py that the port's decode paths
use: the per-picture backend (`reconstruct_picture`, the counterpart of
TpuPictureRecon.reconstruct + deblock_picture_tpu + sao_picture_tpu +
_restore_unfiltered), the `_residual_fn` composition (dequant -> inverse
transform or transform skip -> RDPCM), here a plain function on tensors
instead of a cached jitted closure, and `_device_plane`.  `_pad_pow2` is
not ported: its pow2 buckets only let XLA reuse compiled programs.
"""
import numpy as np
import torch

from .ops import transform as TK
from .utils import xfer


def reconstruct_picture(item, device):
    """Reconstruct one picture on `device`; returns its padded int32 host
    planes (downloaded at two bytes a sample, D2H counted).  The filtered
    planes stay on the device as item["dp"]._device_planes for later
    pictures' MC.

    item: a collect-mode item (hostdec.decoder) with its "dp".  The picture
    is one reference-DAG level of one picture, so it runs the DAG path's
    stages (dag_decode._recon_levels), whose kernels compute what the JAX
    per-picture device programs compute:

        intra_wavefront._scan_fn          -> K2 (intra_wavefront), through
                                             batch_decode._intra_level
                                             with one picture (every
                                             component in one launch)
        recon_tpu._mc_fn                  -> K5 (mc_grid, plain epilogue)
                                             or K6 (mc_weighted, WP)
        recon_tpu._deblock_v_fn /         -> K3 + K4 in one launch of the
          _deblock_cv_fn /                   loop-filter kernel
          _sao_fn / _sao_fn_multi            (ops/loopfilter.py
                                             loop_filter_level: V, H and
                                             SAO of every component; int16
                                             tc above 11-bit chroma; the
                                             multi-slice/tile SAO form)
        recon_tpu._residual_fn            -> K1
        host CCP, PCM write, restore      -> K10, K9, K8

    TpuPictureRecon's own host preparation (_residual_planes with its pow4
    buckets, _inter_stage with pow2 reference stacks, _deblock_pass_tpu's
    chroma tc loop and _seg_maps transposes) is not copied: it builds, in
    layouts shaped for the TPU's compiled programs, the same inputs that
    the DAG path's host preparation builds for the kernels.
    """
    from .parallel.dag_decode import _download, _recon_levels
    (_, _, small), = _recon_levels([item], [device])
    return _download(small)


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


def _residual_fn(coeffs, qp, rdpcm, *, n, use_dst, path, bd, rotate=False,
                 mat=None):
    """Residual blocks [P, n, n] int32 of one TU bucket (plain torch) at
    the JAX function's max_dyn 15; `mat` [P, n, n] holds each TU's scaling
    matrix (the JAX `scaling` closure flag is `mat is not None` here)."""
    if path == "bypass":
        res = TK.bypass_blocks(coeffs, rotate)
    else:
        res = TK.residual_blocks(coeffs, qp, n, use_dst, path == "tskip", bd,
                                 rotate, mat=mat)
    return TK.inverse_rdpcm_batch(res, rdpcm.to(torch.int32))
