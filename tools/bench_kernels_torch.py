#!/usr/bin/env python3
"""Kernel throughput of the PyTorch/CUDA port against the card's peaks.

Port of tools/bench_kernels.py.  Times the port's kernels that compute
what that harness's jits compute, at its batch shapes:

 - K1 (ops/transform.py residual_table, csrc/residual.cu): one flat TU
   table of N DCT TUs of n x n, (n, N) in K1_SHAPES, laid without overlap
   into one int32 plane; coefficients uniform in [-100, 100), QP 32, 8
   bits.  K1 fuses dequant and the inverse transform in one launch, so
   each shape is one row where the JAX harness has two (dequant, idct).
 - K6 (ops/interp.py mc_weighted, csrc/mc.cu): N luma blocks of blk x blk,
   (blk, N) in K6_SHAPES, each as its 4x4 rows with one MV, plain
   epilogue, list 0 only, zero residual.  4 random reference planes of
   1088x1920; each block a random reference and source position and the
   fraction (5, 7) in quarter samples; destinations on a grid of 1088x1920
   pictures, so that the block at each grid position predicts from its
   source position (the MV is the offset between the two plus the
   fraction).  Rows grouped by 16x16 tile on the host, as the decode
   hands them.

Each row: ms from CUDA events over 20 warmed launches (the enqueue rate
for launches shorter than their enqueue) and the device time of 20
launches queued behind a sleeping kernel (libhm_tpu_torch/utils/
timing.py, as chip_smoke.py times its kernels; launch after launch on
the same inputs, so K1's 7-13 MB stay in the 50 MB L2); Gsamp/s of
output samples at the device time; the bytes (each input read once, each
output written once) and integer operations (a multiply-add counts two)
that the row's data needs; the bound (the larger of bytes at the HBM
peak and operations at the int32 peak) and its share of the device time;
max_abs_err against the plain version at that shape (must be 0), and
the plain version's ms.  A card with no entry in PEAKS prints no bound
or share; on the CPU (--device cpu, the tests) only the counts and the
error (the wrapper runs the plain version there) are printed.

Usage: python3 tools/bench_kernels_torch.py [--device cuda|cpu]
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K1_SHAPES = ((4, 65536), (8, 32768), (16, 8192), (32, 2048))
K6_SHAPES = ((16, 8192), (8, 16384))
PLANE_W = 2048               # K1's plane: TUs row by row, 2048 samples wide
QP, BD = 32, 8
H, W, REFS = 1088, 1920, 4   # K6's reference and destination pictures
MV_FRAC = (5, 7)             # quarter-sample MV fraction of every block
REPS = 20

# Peaks by the name torch.cuda.get_device_name reports.  HBM rates: the
# NVIDIA H100 Tensor Core GPU data sheet (SXM5 3.35 TB/s, PCIe 2.0 TB/s).
# The data sheet gives no int32 rate: it is derived at run time from the
# card (libhm_tpu_torch/utils/timing.py int32_ops_per_s: 64 INT32 lanes an
# SM, the H100 white paper, x 2 for a multiply-add x SMs x the maximum SM
# clock).
PEAKS = {"H100 80GB HBM3": {"hbm_bps": 3.35e12},
         "H100 PCIe": {"hbm_bps": 2.0e12}}


def peaks(device=0):
    """{"hbm_bps", "int32_ops"} of card `device` (an index), or None when
    PEAKS has no entry for it."""
    import torch
    from libhm_tpu_torch.utils.timing import int32_ops_per_s
    name = torch.cuda.get_device_name(device)
    for key, v in PEAKS.items():
        if key in name:
            return dict(v, int32_ops=int32_ops_per_s(device))
    return None


# ---------------------------------------------------------------------------
# K1: a flat table of N DCT TUs of n x n
def k1_case(n, N, rng):
    """(TU_DTYPE rows, int16 coefficients [N, n, n], plane shape): TU i at
    row i // cols, column i % cols of a PLANE_W-wide grid of n x n cells
    of picture 0."""
    from libhm_tpu_torch.ops import transform as TK
    cols = PLANE_W // n
    i = np.arange(N)
    rows = np.zeros(N, TK.TU_DTYPE)
    rows["off"] = i * n * n
    rows["y"] = i // cols * n
    rows["x"] = i % cols * n
    rows["log2n"] = n.bit_length() - 1
    rows["qp"] = QP
    rows["bd"] = BD
    coeffs = rng.integers(-100, 100, (N, n, n)).astype(np.int16)
    return rows, coeffs, (1, -(-N // cols) * n, cols * n)


def k1_table(rows, coeffs, device):
    """The TuTable of k1_case's rows on `device`."""
    import torch
    from libhm_tpu_torch.ops import transform as TK
    n = 1 << int(rows["log2n"][0])
    return TK.TuTable(
        torch.from_numpy(rows.view(np.uint8).reshape(len(rows), 16)).to(
            device),
        torch.from_numpy(coeffs.reshape(-1)).to(device),
        tuple(len(rows) if s == n else 0 for s in TK.SIZES), 0)


def k1_work(n, N):
    """(bytes, operations): each row (16 bytes), its int16 coefficients
    and its int32 residual samples written once; the butterflies'
    multiply-adds (each 1-D pass 1.5 n per 4 samples, two operations
    each) and ~5 operations a sample of dequant, as chip_smoke.py counts
    K1's DCT rows."""
    return N * (16 + n * n * 6), N * (2 * 2 * n * n * (3 * n // 8) +
                                      5 * n * n)


# ---------------------------------------------------------------------------
# K6: N luma blocks of blk x blk, one MV each, plain epilogue
def k6_case(blk, N, rng):
    """(refs int32 [REFS, H, W], per-block (sel, sx, sy, b, dx, dy) int64
    arrays, blk rows int32 [N * (blk / 4)^2, 14] of BLK_FIELDS, B): block k
    predicts list 0 from reference sel[k] at source (sx, sy) + (1, 1)
    with the fraction MV_FRAC, as the JAX harness's mc_blocks(bx=sx,
    by=sy, mvx=5, mvy=7) does, into picture b[k] at (dx, dy)."""
    from libhm_tpu_torch.ops import interp as MK
    refs = rng.integers(0, 1 << BD, (REFS, H, W)).astype(np.int32)
    sel = rng.integers(0, REFS, N)
    sx = rng.integers(0, W - blk, N)
    sy = rng.integers(0, H - blk, N)
    cols = W // blk
    per_pic = (H // blk) * cols
    k = np.arange(N)
    b, cell = k // per_pic, k % per_pic
    dy, dx = cell // cols * blk, cell % cols * blk
    q = blk // 4                      # 4x4 rows a side of a block
    j = np.arange(q * q)
    rows = np.zeros((N, q * q, len(MK.BLK_FIELDS)), np.int32)
    rows[..., 0] = b[:, None]
    rows[..., 1] = dx[:, None] + 4 * (j % q)
    rows[..., 2] = dy[:, None] + 4 * (j // q)
    rows[..., 3] = 1                  # list 0 only
    rows[..., 4] = ((sx - dx) * 4 + MV_FRAC[0])[:, None]
    rows[..., 5] = ((sy - dy) * 4 + MV_FRAC[1])[:, None]
    rows[..., 8] = sel[:, None]
    return refs, (sel, sx, sy, b, dx, dy), \
        rows.reshape(-1, len(MK.BLK_FIELDS)), -(-N // per_pic)


def k6_work(blk, blocks, refs):
    """(bytes, operations): the reference samples the blocks' 8-tap
    windows cover (each once), each 4x4 row (14 int32) and its tile-run
    start, the residual read and the prediction written (int32); the
    separable filter's multiply-adds ((blk + 7) rows filtered across,
    then blk down, 8 taps, as tools/bench_kernels.py counts them; two
    operations each) and ~6 epilogue operations a sample (offset, shift,
    residual add, clip)."""
    sel, sx, sy = blocks[:3]
    N = len(sel)
    seen = np.zeros(refs.shape, bool)
    x0 = sx + (MV_FRAC[0] >> 2) - 3
    y0 = sy + (MV_FRAC[1] >> 2) - 3
    for s, y, x in zip(sel, y0, x0):
        seen[s, max(y, 0):y + blk + 7, max(x, 0):x + blk + 7] = True
    samples = N * blk * blk
    rows = samples // 16
    nbytes = int(seen.sum()) * 4 + rows * (14 * 4 + 4) + samples * 8
    macs = N * (blk * (blk + 7) * 8 + blk * blk * 8)
    return nbytes, 2 * macs + 6 * samples


# ---------------------------------------------------------------------------
def _row(kernel, shape, samples, nbytes, ops, err, run, plain, on_card,
         peak):
    """One printed row: times on the card, counts, bound and share."""
    from libhm_tpu_torch.utils.timing import cuda_ms, device_ms
    row = {"kernel": kernel, "shape": shape, "samples": samples,
           "bytes": nbytes, "ops": ops, "max_abs_err": err, "ms": None,
           "device_ms": None, "plain_ms": None, "gsamp_s": None,
           "bound_ms": None, "bound_by": None, "share": None}
    if not on_card:
        return row
    ms, dms = cuda_ms(run, REPS), device_ms(run, REPS)
    row.update(ms=round(ms, 4), device_ms=round(dms, 4),
               plain_ms=round(cuda_ms(plain, 2), 4),
               gsamp_s=round(samples / dms / 1e6, 2))
    if peak:
        tb = nbytes / peak["hbm_bps"] * 1e3
        to = ops / peak["int32_ops"] * 1e3
        row.update(bound_ms=float(f"{max(tb, to):.4g}"),
                   bound_by="bytes" if tb >= to else "operations",
                   share=round(max(tb, to) / dms, 4))
    return row


def measure(device="cuda", k1_shapes=K1_SHAPES, k6_shapes=K6_SHAPES):
    """The rows of K1 at k1_shapes and K6 at k6_shapes on `device`."""
    import torch
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import transform as TK
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("bench_kernels_torch: no card; pass --device cpu "
                           "for the plain versions")
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    peak = peaks(dev.index) if on_card else None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(2024)
    out = []
    for n, N in k1_shapes:
        rows, coeffs, shape = k1_case(n, N, rng)
        table = k1_table(rows, coeffs, dev)
        got = torch.zeros(shape, dtype=torch.int32, device=dev)
        want = got.clone()
        TK.residual_table(got, table)
        TK.residual_table_plain(want, table)
        sync()
        err = int((got.long() - want.long()).abs().max())
        out.append(_row("K1 residual_table", f"{n}x{n} x{N}", N * n * n,
                        *k1_work(n, N), err,
                        lambda: TK.residual_table(got, table),
                        lambda: TK.residual_table_plain(want, table),
                        on_card, peak))
    for blk, N in k6_shapes:
        refs_np, blocks, rows, B = k6_case(blk, N, rng)
        rows, groups = MK.tile_groups(rows, B=B, Hp=H, Wp=W)
        refs = torch.from_numpy(refs_np).to(dev)
        table = torch.from_numpy(rows).to(dev)
        grp = torch.from_numpy(groups).to(dev)
        res = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
        got = torch.zeros_like(res)
        want = torch.zeros_like(res)
        kw = dict(is_luma=True, sx=0, sy=0, bd=BD, wp=False, denom=0, W=W,
                  H=H)
        MK.mc_weighted(got, res, refs, table, groups=grp, **kw)
        MK.mc_weighted_plain(want, res, refs, table, **kw)
        sync()
        err = int((got.long() - want.long()).abs().max())
        out.append(_row("K6 mc_weighted", f"{blk}x{blk} x{N}",
                        N * blk * blk, *k6_work(blk, blocks, refs_np), err,
                        lambda: MK.mc_weighted(got, res, refs, table,
                                               groups=grp, **kw),
                        lambda: MK.mc_weighted_plain(want, res, refs, table,
                                                     **kw),
                        on_card, peak))
    return out


def header(device="cuda"):
    """The card, its power limit and the peaks the rows are held to."""
    import torch
    from libhm_tpu_torch.utils.timing import INT32_LANES_PER_SM, card_name
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"device: {dev} (counts and errors only)"
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    card = card_name(dev.index)
    p = peaks(dev.index)
    if p is None:
        return f"device: {card} (no entry in PEAKS: no bound or share)"
    return (f"device: {card}; peaks: HBM {p['hbm_bps'] / 1e12:.2f} TB/s, "
            f"int32 {p['int32_ops'] / 1e12:.2f} T ops/s "
            f"({INT32_LANES_PER_SM} lanes x 2 x "
            f"{torch.cuda.get_device_properties(dev).multi_processor_count}"
            f" SMs x the maximum SM clock)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(header(a.device), flush=True)
    for row in measure(a.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
