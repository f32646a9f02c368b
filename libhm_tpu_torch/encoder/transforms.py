# Copied from libhm_tpu/encoder/transforms.py
"""Forward transform + quantisation (encoder side).

Rebuild of the reference's partialButterfly{4..32} forward path and xQuant
(source/Lib/TLibCommon/TComTrQuant.cpp:387-944, 1203) as numpy matrix ops.
The JAX/MXU batched version shares the int8-split scheme of ops/transform.py.
"""
import numpy as np

from ..hostdec.tables import DCT, DST4, QUANT_SCALES


def forward_transform(resi: np.ndarray, use_dst: bool, bit_depth: int,
                      max_dyn_range: int = 15) -> np.ndarray:
    """resi: [n, n] int32 -> coefficients [n, n] int32 (exact HM scaling)."""
    n = resi.shape[0]
    t = DST4 if (use_dst and n == 4) else DCT[n]
    log2n = n.bit_length() - 1
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    tmp = (t.astype(np.int64) @ resi.astype(np.int64) +
           (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    out = (tmp @ t.T.astype(np.int64) + (1 << (shift2 - 1))) >> shift2
    return np.clip(out, -32768, 32767).astype(np.int32)


def quantize(coef: np.ndarray, qp: int, log2_size: int, bit_depth: int,
             is_intra: bool, max_dyn_range: int = 15) -> np.ndarray:
    """Scalar quantisation (reference xQuant, no RDOQ)."""
    per, rem = qp // 6, qp % 6
    tshift = max_dyn_range - bit_depth - log2_size
    qbits = 14 + per + tshift
    scale = int(QUANT_SCALES[rem])
    offset = (171 if is_intra else 85) << (qbits - 9)
    c = coef.astype(np.int64)
    level = (np.abs(c) * scale + offset) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int32)
