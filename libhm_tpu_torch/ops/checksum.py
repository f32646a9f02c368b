"""Checksum of device-resident planes, and its kernel (K7).

The uint32 sum (mod 2^32) of a set of cropped 2-D int32 views: what
libhm_tpu/parallel/dag_decode.py decode_batch_device computes on the device
so that only 4 bytes come back.  `plane_checksum` runs csrc/checksum.cu for
CUDA views and the plain int64 sum for CPU views; either way it returns a
one-element tensor on the views' device, still to be downloaded.  The
kernel takes its view table as a launch parameter, MAX_VIEWS views a
launch: nothing is uploaded.
"""
import numpy as np
import torch

from ..kernels.build import I, P, Kernel, on_current

_K7 = Kernel("plane_checksum", [P, I, P, I])
MAX_VIEWS = 64                # views one launch takes (csrc/checksum.cu)


def plane_checksum_plain(views):
    """Plain torch version of plane_checksum (any device)."""
    total = torch.zeros((), dtype=torch.int64, device=views[0].device)
    for v in views:
        total = total + v.sum(dtype=torch.int64)
    return (total & 0xFFFFFFFF).reshape(1)


def view_chunks(views):
    """The launches' view tables: the {pointer, row stride, rows, cols} of
    every view that holds a sample, in order, as host int64 arrays of at
    most MAX_VIEWS rows each.  Raises unless every view is a 2-D int32
    tensor with unit column stride on the first one's device."""
    dev = views[0].get_device()
    rows = []
    for v in views:
        if v.dtype is not torch.int32 or v.dim() != 2 or \
                v.get_device() != dev:
            raise ValueError("plane_checksum: views must be 2-D int32 "
                             "tensors on one device")
        h, w = v.shape
        if h and w:
            stride = v.stride()
            if stride[1] != 1:
                raise ValueError("plane_checksum: views need unit column "
                                 "stride")
            rows.append((v.data_ptr(), stride[0], h, w))
    table = np.array(rows, np.int64).reshape(-1, 4)
    return [table[i:i + MAX_VIEWS] for i in range(0, len(table), MAX_VIEWS)]


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
    on_current(views[0], "plane_checksum: views[0]")
    chunks = view_chunks(views)
    acc = torch.empty(1, dtype=torch.int32, device=views[0].device)
    if not chunks:
        return acc.zero_()
    # the first launch zeroes the word, every launch adds to it
    for i, table in enumerate(chunks):
        _K7(table.ctypes.data, len(table), acc.data_ptr(), int(i == 0))
    return acc
