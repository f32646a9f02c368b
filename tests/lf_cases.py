"""Seeded loop-filter levels for the loop-filter kernel's checks.

`level_case` makes one level's input planes and maps in the layout that
device_filters.filter_level hands ops/loopfilter.py loop_filter_level:
smooth planes (flat, weak and strong edges), random per-4x4 deblocking
maps with PCM/lossless exclusions, random SAO parameters of every type
(and type 5, which takes EO class 3), and, for the multi form, random
slice, loop-filter-across and tile maps.  Imports neither JAX nor the JAX
package, so the GPU tests and chip_smoke.py can use it.
"""
import numpy as np
import torch


def smooth_planes(rng, shape, bd):
    """[B, H, W] int32: 4x4-flat blocks with small noise."""
    B, H, W = shape
    base = rng.integers(0, 1 << bd, (B, H // 4 + 1, W // 4 + 1))
    base = (base >> 3) + (1 << (bd - 1)) - (1 << (bd - 4))
    plane = np.repeat(np.repeat(base, 4, 1), 4, 2)[:, :H, :W]
    plane = plane + rng.integers(-2, 3, (B, H, W))
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int32)


def level_case(rng, *, B=1, Hp=64, Wp=96, H=None, W=None, chroma=1,
               bd_l=8, bd_c=None, log2_ctb=4, multi=False, sao=True,
               offsets=True, device="cpu"):
    """(planes, maps, kw): the planes per component, the maps by name and
    the keyword arguments of loop_filter_level, on `device`.  chroma: the
    chroma_format_idc (0 = luma only)."""
    from libhm_tpu_torch.ops import loopfilter as LF
    bd_c = bd_l if bd_c is None else bd_c
    H = Hp if H is None else H
    W = Wp if W is None else W
    sx, sy = {0: (0, 0), 1: (1, 1), 2: (1, 0), 3: (0, 0)}[chroma]
    ncomp = 3 if chroma else 1
    h4, w4 = Hp // 4, Wp // 4
    hc, wc = -(-Hp >> log2_ctb), -(-Wp >> log2_ctb)
    planes = [smooth_planes(rng, (B, Hp, Wp), bd_l)]
    planes += [smooth_planes(rng, (B, Hp >> sy, Wp >> sx), bd_c)
               for _ in range(ncomp - 1)]
    m = {}
    for tag in "vh":
        bs = rng.integers(0, 3, (B, h4, w4)).astype(np.uint8)
        nop = (rng.random((B, h4, w4)) < 0.05).astype(np.uint8)
        noq = (rng.random((B, h4, w4)) < 0.05).astype(np.uint8)
        m[f"bsn_{tag}"] = bs | nop << 4 | noq << 5
        m[f"qp_{tag}"] = rng.integers(20, 52, (B, h4, w4)).astype(np.int8)
        if offsets:
            for k in ("bo", "to"):
                m[f"{k}_{tag}"] = (2 * rng.integers(-3, 4, (B, h4, w4))) \
                    .astype(np.int8)
        if ncomp > 1:
            tc = rng.integers(0, 25, (B, 2, h4, w4)) << (bd_c - 8)
            m[f"ctc_{tag}"] = np.where(bs[:, None] == 2, tc, 0).astype(
                np.int16 if bd_c > 11 else np.uint8)
    if sao:
        n = hc * wc
        m["sao_t"] = rng.integers(-1, 6, (B, n, 3)).astype(np.int8)
        m["sao_b"] = rng.integers(0, 32, (B, n, 3)).astype(np.int8)
        m["sao_o"] = rng.integers(-31, 32, (B, n, 3, 4)).astype(np.int8)
        m["sao_scale_l"] = rng.integers(0, 3, B).astype(np.int32)
        m["sao_scale_c"] = rng.integers(0, 3, B).astype(np.int32)
    if sao and multi:
        # slices and tiles as runs of CTBs; a slice's flag per slice
        ctb = np.arange(n).reshape(hc, wc)
        cuts = np.sort(rng.choice(np.arange(1, n), min(3, n - 1), False))
        sl = np.searchsorted(cuts, ctb, side="right")
        lf = rng.integers(0, 2, 4)
        up = np.kron(sl, np.ones((1 << log2_ctb >> 2,) * 2, np.int64))
        up = up[:h4, :w4]
        m["s4"] = np.repeat(up[None], B, 0).astype(np.int16)
        m["lf4"] = np.repeat(lf[up][None], B, 0).astype(np.uint8)
        tcol = (np.arange(wc) >= wc // 2).astype(np.int16)
        m["tm"] = np.repeat(np.tile(tcol, hc)[None], B, 0)
        m["lft"] = rng.integers(0, 2, B).astype(np.uint8)
    maps = {k: torch.from_numpy(v).to(device) for k, v in m.items()}
    planes = [torch.from_numpy(p).to(device) for p in planes]
    mask = LF.PASS_V | LF.PASS_H | (LF.PASS_SAO if sao else 0)
    kw = dict(mask=mask, bd_l=bd_l, bd_c=bd_c, sx=sx, sy=sy,
              log2_ctb=log2_ctb, hc=hc, wc=wc, W=W, H=H,
              multi=bool(sao and multi))
    return planes, maps, kw
