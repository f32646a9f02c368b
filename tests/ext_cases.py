"""Seeded K1 tables of extended-precision (F_EXT) rows, shared by
tests/test_torch_extprec.py, tests/test_torch_cuda.py and chip_smoke.py's
extprec phase.

ext_level tiles B pictures of H x W with TUs: each 32x32 slot holds TUs of
one size (4, 8, 16 or 32), every mode drawn per TU: DCT, DST (4x4), transform
skip (rotated at 4x4), bypass (rotated at 4x4), scaled (flat at transform
skip above 4x4, as the decoder marks them), RDPCM in both directions on
transform-skip and bypass rows, and in chroma tables a CCP alpha.
Coefficient levels are drawn log-uniformly over the whole range an
extended-precision stream allows, [-2^M, 2^M - 1] with M = bd + 6, so that
dequantized and stage-1 values fill it; qp over 0 .. 51 + 6 (bd - 8).
"""
import numpy as np

from libhm_tpu_torch.ops import transform as TK

ALPHAS = np.array([0, 1, -1, 2, -2, 4, -4, 8, -8])
MODES = np.array([0, TK.F_DST, TK.F_TSKIP, TK.F_BYPASS, TK.F_SCALED,
                  TK.F_SCALED | TK.F_TSKIP])


def draw_levels(rng, M, size):
    """Levels in [-2^M, 2^M - 1]: a log-uniform magnitude below 2^M and a
    random sign, a fifth of them 0 and a fiftieth at either end."""
    mag = np.floor(np.exp2(rng.random(size) * M)).astype(np.int64) - 1
    mag = np.where(rng.random(size) < 0.2, 0, mag)
    v = np.where(rng.random(size) < 0.5, -mag, mag)
    end = rng.random(size)
    return np.where(end < 0.01, -(1 << M),
                    np.where(end < 0.02, (1 << M) - 1, v))


def ext_level(rng, bd, B=2, H=96, W=160, chroma=False, plain_share=0.0):
    """(rows, coeffs, counts, flags, mats, alphas) of one K1 table in
    residual_tables' form: TU_DTYPE rows sorted by size, int32
    coefficients at 16-element offsets, the rows of each size, the OR of
    the flags; the scaling matrices {n: uint8 [6, n, n]} (1..255, so
    factors of 1 occur); and each row's CCP alpha (nonzero on chroma rows
    only, and there F_CCP).  plain_share of the rows lack F_EXT (levels in
    the int16 range), to hold a mixed table."""
    M = max(15, bd + 6)
    sb, sy, sx = np.meshgrid(np.arange(B), np.arange(0, H, 32),
                             np.arange(0, W, 32), indexing="ij")
    sb, sy, sx = sb.ravel(), sy.ravel(), sx.ravel()
    slot_n = rng.choice((4, 8, 16, 32), len(sb))
    parts = []
    for n in (4, 8, 16, 32):
        k = slot_n == n
        dy, dx = np.meshgrid(np.arange(0, 32, n), np.arange(0, 32, n),
                             indexing="ij")
        b = np.repeat(sb[k], dy.size)
        y = (sy[k][:, None] + dy.ravel()[None]).ravel()
        x = (sx[k][:, None] + dx.ravel()[None]).ravel()
        keep = (y < H) & (x < W)
        parts.append((n, b[keep], y[keep], x[keep]))
    N = sum(len(p[1]) for p in parts)
    rows = np.zeros(N, TK.TU_DTYPE)
    rows["b"] = np.concatenate([p[1] for p in parts])
    rows["y"] = np.concatenate([p[2] for p in parts])
    rows["x"] = np.concatenate([p[3] for p in parts])
    n = np.concatenate([np.full(len(p[1]), p[0]) for p in parts])
    rows["log2n"] = np.log2(n).astype(np.uint8)
    fl = MODES[rng.integers(0, len(MODES), N)]
    big = n > 4
    fl = np.where(big, fl & ~TK.F_DST, fl)
    fl = np.where(big & (fl & TK.F_TSKIP != 0), fl & ~TK.F_SCALED, fl)
    skip = (fl & (TK.F_TSKIP | TK.F_BYPASS)) != 0
    fl = fl | np.where(~big & skip & (rng.random(N) < 0.5), TK.F_ROTATE, 0)
    ext = rng.random(N) >= plain_share
    fl = fl | np.where(ext, TK.F_EXT, 0)
    alphas = ALPHAS[rng.integers(0, len(ALPHAS), N)] if chroma else \
        np.zeros(N, np.int64)
    fl = fl | np.where(alphas != 0, TK.F_CCP, 0)
    rows["flags"] = fl
    rows["rdpcm"] = np.where(skip, rng.integers(0, 3, N), 0) | \
        TK.ccp_bits(alphas)
    rows["qp"] = rng.integers(0, 52 + 6 * (bd - 8), N)
    rows["midx"] = rng.integers(0, 6, N)
    rows["bd"] = bd
    sizes = n * n
    rows["off"] = np.cumsum(sizes) - sizes
    lv = draw_levels(rng, M, int(sizes.sum()))
    lv = np.where(np.repeat(ext, sizes), lv, np.clip(lv, -32768, 32767))
    counts = tuple(len(p[1]) for p in parts)
    mats = {m: rng.integers(1, 256, (6, m, m)).astype(np.uint8)
            for m in TK.SIZES}
    return (rows, lv.astype(np.int32), counts,
            int(np.bitwise_or.reduce(rows["flags"], initial=0)), mats,
            alphas)
