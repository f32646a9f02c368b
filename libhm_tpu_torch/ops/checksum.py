"""Checksum of device-resident planes, and its kernel (K7).

The uint32 sum (mod 2^32) of a set of cropped 2-D int32 views: what
libhm_tpu/parallel/dag_decode.py decode_batch_device computes on the device
so that only 4 bytes come back.  `plane_checksum` runs csrc/checksum.cu for
CUDA views and the plain int64 sum for CPU views; either way it returns a
one-element tensor on the views' device, still to be downloaded.
"""
import numpy as np
import torch

from ..kernels.build import I, P, Kernel
from ..utils import xfer

_K7 = Kernel("plane_checksum", [P, P, I, I])
_BLOCKS_PER_VIEW = 64


def plane_checksum_plain(views):
    """Plain torch version of plane_checksum (any device)."""
    total = torch.zeros((), dtype=torch.int64, device=views[0].device)
    for v in views:
        total = total + v.sum(dtype=torch.int64)
    return (total & 0xFFFFFFFF).reshape(1)


def plane_checksum(views):
    """uint32 sum of every sample of `views` (2-D int32 tensors with unit
    column stride, e.g. crops of stacked planes), as a one-element tensor
    on their device: int64 for CPU views, int32 holding the uint32 bits
    for CUDA views (read it as `int(t.item()) & 0xFFFFFFFF`).
    """
    if not views:
        raise ValueError("plane_checksum: no views")
    if not views[0].is_cuda:
        return plane_checksum_plain(views)
    dev = views[0].device
    table = []
    for v in views:
        if not v.is_cuda or v.device != dev or v.dtype != torch.int32 or \
                v.dim() != 2 or (v.numel() and v.stride(1) != 1):
            raise ValueError("plane_checksum: views must be 2-D int32 CUDA "
                             "tensors on one device with unit column stride")
        table.append([v.data_ptr(), v.stride(0), v.shape[0], v.shape[1]])
    table = xfer.up(np.asarray(table, np.int64), "checksum", dev)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    _K7(table.data_ptr(), acc.data_ptr(), len(views), _BLOCKS_PER_VIEW)
    return acc
