"""Seeded 4:4:4 chroma TU tables with cross-component prediction, for the
CCP epilogue of K1 (tests/test_torch_ccp_epilogue.py, the CUDA test,
chip_smoke.py's check_k10 and tools/port_ab.py).

`ccp_level` tiles B pictures of H x W chroma samples with 32x32 cells,
each cell with TUs of one size (4, 8, 16 and 32 in turn), every TU in one
of MODES (flat dequant with an inverse DCT, transform skip and bypass
with a seeded RDPCM direction and the rotation at 4x4, and CCP-only TUs
with zero coefficients, as the parser lists them), and gives a `share` of
the cells a cross-component alpha on every TU (all of +-1, +-2, +-4, +-8
in turn).  Cells on the right and bottom reach past the plane when H or W
is not a multiple of 32.  The luma residual covers the whole int16 range,
so the int16 clip acts.  Nothing here knows how the port stores the alpha
in a row: the rows come without it, and the alphas beside them.
"""
import numpy as np

ALPHAS = (-8, -4, -2, -1, 1, 2, 4, 8)
SIZES = (4, 8, 16, 32)
# (flags, RDPCM allowed, zero coefficients) with the bits of
# libhm_tpu_torch/ops/transform.py: F_TSKIP 2, F_BYPASS 4, F_ROTATE 8
MODES = ((0, False, False), (2, True, False), (2 | 8, True, False),
         (4, True, False), (4 | 8, True, False), (0, False, True))


def ccp_level(rng, TU_DTYPE, B, H, W, share=0.3, bd=10):
    """Returns dict(rows=TU_DTYPE rows sorted by size, without alphas,
    coeffs=int16 coefficients (each TU at a multiple of 16), counts=rows
    of each size, flags=OR of the rows' flags, alpha=int64 [N] (0: no
    CCP), res_l=int32 [B, H, W] luma residual, tus=int32 [M, 5] (b, y, x,
    n, alpha) of the CCP rows)."""
    ny, nx = -(-H // 32), -(-W // 32)
    cells = rng.permutation(B * ny * nx)
    n_ccp = int(round(share * len(cells)))
    parts = {n: [] for n in SIZES}
    for k, cell in enumerate(cells):
        b, cy, cx = cell // (ny * nx), cell % (ny * nx) // nx, cell % nx
        n = SIZES[k % 4]
        for i, (y, x) in enumerate((cy * 32 + y, cx * 32 + x)
                                   for y in range(0, 32, n)
                                   for x in range(0, 32, n)):
            fl, rd_ok, zero = MODES[(i + k) % len(MODES)]
            if n > 4:
                fl &= ~8
            if zero:
                c = np.zeros(n * n, np.int64)
            elif fl & 4:
                c = rng.integers(-32768, 32768, n * n)
            else:
                c = rng.integers(-3000, 3001, n * n)
            alpha = ALPHAS[(i + k) % 8] if k < n_ccp else 0
            parts[n].append(((b, y, x, n.bit_length() - 1,
                              int(rng.integers(0, 52 + 6 * (bd - 8))), fl,
                              int(rng.integers(0, 3)) if rd_ok else 0, 0,
                              bd), alpha, c))
    entries = [e for n in SIZES for e in parts[n]]
    rows = np.zeros(len(entries), TU_DTYPE)
    for j, name in enumerate(("b", "y", "x", "log2n", "qp", "flags", "rdpcm",
                              "midx", "bd")):
        rows[name] = [e[0][j] for e in entries]
    sizes = np.asarray([len(e[2]) for e in entries], np.int64)
    rows["off"] = np.cumsum(sizes) - sizes
    coeffs = np.concatenate([e[2] for e in entries]).astype(np.int16)
    alpha = np.asarray([e[1] for e in entries], np.int64)
    sel = np.nonzero(alpha)[0]
    tus = np.stack([rows["b"][sel], rows["y"][sel], rows["x"][sel],
                    1 << rows["log2n"][sel].astype(np.int64), alpha[sel]],
                   1).astype(np.int32)
    return dict(rows=rows, coeffs=coeffs,
                counts=tuple(len(parts[n]) for n in SIZES),
                flags=int(np.bitwise_or.reduce(rows["flags"], initial=0)),
                alpha=alpha, tus=tus,
                res_l=rng.integers(-32768, 32768, (B, H, W)).astype(np.int32))
