# Copied from libhm_tpu/encoder/rd_cost.py
"""RD cost functions for encoder decisions (reference TComRdCost).

SATD via batched 2D Walsh-Hadamard tiles (reference xCalcHADs8x8 /
xCalcHADs4x4: the butterfly network computes the same transform; the sum
of absolute coefficients is invariant to the row ordering, so a plain
Hadamard matrix product gives identical costs).  Blocks are tiled 8x8
when both dimensions allow, else 4x4.
"""
import numpy as np


def _hadamard(n):
    h = np.array([[1]], np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H4 = _hadamard(4)
_H8 = _hadamard(8)


_NATIVE = ("unset",)


def _native():
    global _NATIVE
    if _NATIVE == ("unset",):
        from ..hostdec.native_bridge import try_load
        _NATIVE = (try_load(),)
    return _NATIVE[0]


def satd(a, b):
    """Sum of absolute Hadamard-transformed differences (HM normalization)."""
    lib = _native()
    if lib is not None and a.shape == b.shape and a.ndim == 2:
        if a.dtype == np.int32 and b.dtype == np.int32 and \
                a.flags.c_contiguous and b.flags.c_contiguous:
            h, w = a.shape
            return int(lib.enc_satd32(a.ctypes.data, b.ctypes.data, w, h))
        a16 = np.ascontiguousarray(a, np.int16)
        b16 = np.ascontiguousarray(b, np.int16)
        # int16 narrowing is lossless for every encoder caller (Pel-range
        # predictions and sources); guard anyway for generic inputs
        if (a16 == a).all() and (b16 == b).all():
            h, w = a.shape
            return int(lib.enc_satd(a16.ctypes.data, b16.ctypes.data, w, h))
    diff = a.astype(np.int64) - b.astype(np.int64)
    h, w = diff.shape
    if h % 8 == 0 and w % 8 == 0:
        t, H, rsh, add = 8, _H8, 2, 2
    elif h % 4 == 0 and w % 4 == 0:
        t, H, rsh, add = 4, _H4, 1, 1
    else:
        return int(np.abs(diff).sum())
    v = diff.reshape(h // t, t, w // t, t).transpose(0, 2, 1, 3) \
            .reshape(-1, t, t)
    had = np.matmul(np.matmul(H, v), H)
    s = np.abs(had).sum(axis=(1, 2))
    return int(((s + add) >> rsh).sum())
