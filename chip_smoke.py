#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libhm_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is then non-zero and the
result line is not printed):

 1. card name and power limit (nvidia-smi); CUDA must be available;
 2. build the port's native host parser (libhm_tpu_torch/hostdec/native)
    and every kernel of csrc/ (one nvcc per source), all at once, timed;
 3. K1-K7 against their plain torch versions on the card, at the shapes of
    the 1080p main path, on seeded inputs: exact equality, with both times,
    the bound (bytes or operations at the card's peak rates) and, for K7,
    the time of the library call that computes the same sum;
 4. the main paths, each with the launch counters reset just before it and
    read just after:
    - testdata/randomaccess_main10_1080p.bin through
      parallel.dag_decode.decode_batch(device="cuda"): golden MD5, K1-K5
      launched;
    - testdata/wp_lowdelayP_416x240.bin the same way: golden MD5, K6;
    - decode_batch_device on the 1080p RA stream: its checksum equals
      cropped_checksum of the decoded pictures, K7 launched, 4 bytes down;
    - the all-intra 1080p and 416x240 streams: golden MD5, K1-K4;
 5. a timed run and a breakdown (cProfile, torch.profiler) of the RA
    stream;
 6. one JSON line of per-kernel results, then the result line
    {"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
STREAM = "randomaccess_main10_1080p"      # the main path: timed, broken down
INTRA = "intra_main10_1080p"              # the all-intra path of PR 1
SMALL = ("intra_main10_416x240", "intra_416x240")
WP = "wp_lowdelayP_416x240"               # the only weighted-prediction golden

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# CUDA-core rate (67 TFLOP/s float32 outside the tensor cores; the table
# has no int32 entry, so integer operations are held against it too)
HBM_BPS = 3.35e12
CORE_OPS = 67e12


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over `reps` runs (warmed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


class Result:
    """What phase 3 measured for one kernel entry point, summed over its
    checks: max error, kernel / plain / library ms, bytes and operations."""

    def __init__(self):
        self.err = 0
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        self.bytes = self.ops = 0

    def add(self, err, ms, plain_ms, nbytes, ops):
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bytes += int(nbytes)
        self.ops += int(ops)

    def bound(self):
        """(ms, 'bytes' or 'operations'): the least time for this work."""
        tb = self.bytes / HBM_BPS * 1e3
        to = self.ops / CORE_OPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")


def check_k1(items, card, rng):
    """K1 on every TU bucket of the stream (seeded coefficients)."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel.batch_decode import _tu_bucket_entries
    sps = items[0]["sps"]
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    B = len(items)
    r = Result()
    for (n, use_dst, path, bd, _, _, _), entries in sorted(
            _tu_bucket_entries(items).items()):
        for c in range(3):
            sel = [(b, i) for b, i, _ in entries
                   if items[b]["pic"].tu_list[i].comp == c]
            if not sel:
                continue
            tus = [items[b]["pic"].tu_list[i] for b, i in sel]
            P = len(sel)
            dev = DEV
            coeffs = torch.from_numpy(rng.integers(
                -2048, 2048, (P, n, n)).astype(np.int16)).to(dev)
            qp = torch.from_numpy(rng.integers(
                0, 52 + 6 * (bd - 8), P).astype(np.int8)).to(dev)
            bsel = torch.tensor([b for b, _ in sel], dtype=torch.int32,
                                device=dev)
            ysel = torch.tensor([t.y for t in tus], dtype=torch.int32,
                                device=dev)
            xsel = torch.tensor([t.x for t in tus], dtype=torch.int32,
                                device=dev)
            shape = (B, Hp >> (1 if c else 0), Wp >> (1 if c else 0))
            kw = dict(n=n, use_dst=use_dst, tskip=path == "tskip", bd=bd)
            got = torch.zeros(shape, dtype=torch.int32, device=dev)
            want = torch.zeros(shape, dtype=torch.int32, device=dev)
            args = (coeffs, qp, bsel, ysel, xsel)
            TK.residual_scatter(got, *args, **kw)
            TK.residual_scatter_plain(want, *args, **kw)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            bms = cuda_ms(lambda: TK.residual_scatter(got, *args, **kw), 20)
            pms = cuda_ms(lambda: TK.residual_scatter_plain(want, *args, **kw),
                          5)
            log(f"K1 residual_scatter n={n} {path}{' dst' if use_dst else ''}"
                f" comp={c} TUs={P}: mismatches={int((got != want).sum())} "
                f"kernel {bms:.4f} ms, plain {pms:.4f} ms ({card})")
            # int16 coefficients + qp + 3 int32 indices in, n*n int32 out;
            # dequant, then two n-point matrix stages (2 n^3 MACs)
            nbytes = P * (n * n * 2 + 1 + 12 + n * n * 4)
            ops = P * (n * n * 6 if path == "tskip" else 4 * n ** 3 +
                       n * n * 4)
            r.add(e, bms, pms, nbytes, ops)
    return r


def check_k2(items, card, rng):
    """K2 on the fullest real level of picture 0, per block size."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel.intra_wavefront import prepare_component
    it = items[0]
    sps = it["sps"]
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    bd = sps.bit_depth_luma
    levels, _ = prepare_component(sps, it["pic"], it["zmap"], it["tile_map"],
                                  0, None, False)
    plane0 = torch.from_numpy(rng.integers(
        0, 1 << bd, (1, Hp, Wp)).astype(np.int32)).to(DEV)
    res = torch.from_numpy(rng.integers(
        -64, 65, (1, Hp, Wp)).astype(np.int32)).to(DEV)
    r = Result()
    for n in (4, 8, 16, 32):
        real = levels[n]["xs"] < sps.width
        if not real.any():
            continue
        level = int(real.sum(axis=1).argmax())
        meta = {k: torch.from_numpy(v[None]).to(DEV)
                for k, v in levels[n].items()}
        kw = dict(n=n, is_luma=True, bd=bd, W=sps.width, H=sps.height)
        got, want = plane0.clone(), plane0.clone()
        IK.intra_level(got, res, meta, level, **kw)
        IK.intra_level_plain(want, res, meta, level, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: IK.intra_level(got, res, meta, level, **kw), 20)
        pms = cuda_ms(lambda: IK.intra_level_plain(want, res, meta, level,
                                                   **kw), 5)
        nblk = int(real[level].sum())
        log(f"K2 intra_level n={n} level={level} blocks={nblk}"
            f": mismatches={int((got != want).sum())} kernel {bms:.4f} ms, "
            f"plain {pms:.4f} ms ({card})")
        # per block: 4n+1 border samples and n*n residuals in, n*n out
        # (int32), the slot's metadata; ~10 operations per predicted sample
        T = 4 * n + 1
        r.add(e, bms, pms, nblk * (T * 4 + n * n * 8 + 6 + (T + 7) // 8),
              nblk * n * n * 10)
    return r


def _smooth_plane(rng, shape, bd):
    """Piecewise-flat picture with small noise, so that deblocking sees
    flat, weak and strong edges."""
    import numpy as np
    H, W = shape
    base = rng.integers(0, 1 << bd, (H // 4 + 1, W // 4 + 1))
    base = (base >> 3) + (1 << (bd - 1)) - (1 << (bd - 4))
    plane = np.repeat(np.repeat(base, 4, 0), 4, 1)[:H, :W]
    plane = plane + rng.integers(-2, 3, (H, W))
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int32)[None]


def check_k3(card, rng, bd=10):
    """K3 luma on 1920x1088 and chroma on 960x544, V and H."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import deblock as DK
    H, W = 1088, 1920
    h4, w4 = H // 4, W // 4
    bs = rng.integers(0, 3, (1, h4, w4)).astype(np.uint8)
    nop = (rng.random((1, h4, w4)) < 0.05).astype(np.uint8)
    noq = (rng.random((1, h4, w4)) < 0.05).astype(np.uint8)
    bsn_np = bs | (nop << 4) | (noq << 5)
    qp = torch.from_numpy(rng.integers(20, 52, (1, h4, w4)).astype(np.int8)).to(DEV)
    bo = torch.from_numpy((2 * rng.integers(-3, 4, (1, h4, w4))).astype(np.int8)).to(DEV)
    to = torch.from_numpy((2 * rng.integers(-3, 4, (1, h4, w4))).astype(np.int8)).to(DEV)
    ctc = rng.integers(0, 25, (1, h4, w4)) << (bd - 8)
    ctc = torch.from_numpy(np.where(bs == 2, ctc, 0).astype(np.uint8)).to(DEV)
    luma = torch.from_numpy(_smooth_plane(rng, (H, W), bd)).to(DEV)
    chroma = torch.from_numpy(_smooth_plane(rng, (H // 2, W // 2), bd)).to(DEV)
    out = {"deblock_luma": Result(), "deblock_chroma": Result()}
    for vertical in (True, False):
        d = "V" if vertical else "H"
        m = bsn_np.copy()
        # picture-edge entries carry bs 0, as compute_bs_maps leaves them
        if vertical:
            m[:, :, 0] &= ~np.uint8(3)
        else:
            m[:, 0, :] &= ~np.uint8(3)
        bsn = torch.from_numpy(m).to(DEV)
        for name, plane, run, plain, nmap in (
                ("deblock_luma", luma,
                 lambda p: DK.deblock_luma(p, bsn, qp, bo, to,
                                           vertical=vertical, bd=bd),
                 lambda p: DK.deblock_luma_plain(p, bsn, qp, bo, to,
                                                 vertical=vertical, bd=bd),
                 4),
                ("deblock_chroma", chroma,
                 lambda p: DK.deblock_chroma(p, ctc, bsn, vertical=vertical,
                                             bd=bd, ssx=1, ssy=1),
                 lambda p: DK.deblock_chroma_plain(p, ctc, bsn,
                                                   vertical=vertical, bd=bd,
                                                   ssx=1, ssy=1),
                 2)):
            got, want = plane.clone(), plane.clone()
            run(got)
            plain(want)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            changed = int((want != plane).sum())
            scratch = plane.clone()
            bms = cuda_ms(lambda: run(scratch), 20)
            pms = cuda_ms(lambda: plain(scratch), 3)
            log(f"K3 {name} {d} {tuple(plane.shape[1:])}: mismatches="
                f"{int((got != want).sum())} (samples changed {changed}) "
                f"kernel {bms:.4f} ms, plain {pms:.4f} ms ({card})")
            # the plane read and written in place (int32), the int8 maps;
            # ~16 operations per sample for the decisions and filters
            n = plane.numel()
            out[name].add(e, bms, pms, n * 8 + h4 * w4 * nmap, n * 16)
    return out


def check_k4(card, rng, bd=10):
    """K4 on 1920x1088 luma and 960x544 chroma planes."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import sao as SK
    r = Result()
    for (Hp, Wp, H, W, log2c) in ((1088, 1920, 1080, 1920, 6),
                                  (544, 960, 540, 960, 5)):
        hc, wc = (Hp + (1 << log2c) - 1) >> log2c, (Wp + (1 << log2c) - 1) >> log2c
        plane = torch.from_numpy(rng.integers(
            0, 1 << bd, (1, Hp, Wp)).astype(np.int32)).to(DEV)
        t = torch.from_numpy(rng.integers(-1, 5, (1, hc, wc)).astype(np.int8)).to(DEV)
        b = torch.from_numpy(rng.integers(0, 32, (1, hc, wc)).astype(np.int8)).to(DEV)
        o = torch.from_numpy(rng.integers(-31, 32, (1, hc, wc, 4)).astype(np.int8)).to(DEV)
        scale = torch.zeros(1, dtype=torch.int32, device=DEV)
        kw = dict(log2cx=log2c, log2cy=log2c, bd=bd, W=W, H=H)
        got = SK.sao(plane, t, b, o, scale, **kw)
        want = SK.sao_plain(plane, t, b, o, scale, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: SK.sao(plane, t, b, o, scale, **kw), 20)
        pms = cuda_ms(lambda: SK.sao_plain(plane, t, b, o, scale, **kw), 3)
        log(f"K4 sao_apply {(Hp, Wp)}: mismatches={int((got != want).sum())} "
            f"kernel {bms:.4f} ms, plain {pms:.4f} ms ({card})")
        # the plane in and a new plane out (int32), 6 bytes of map per CTB;
        # ~20 operations per sample
        r.add(e, bms, pms, plane.numel() * 8 + hc * wc * 6,
              plane.numel() * 20)
    return r


def _mc_list_ops(frac_x, frac_y, used, taps):
    """Integer operations of one list's 14-bit prediction per sample:
    2 per multiply-add of its filter case (copy, h or v only, h then v)
    plus the shifts and offsets; 0 where the list is unused."""
    import torch
    macs = torch.where(frac_x & frac_y, taps * taps + taps,
                       torch.where(frac_x | frac_y, taps, 0))
    return torch.where(used, 2 * macs + 4, 0)


# 1080p level shapes of the RA stream: 3 pictures, 4 reference pictures
LEVEL_B, LEVEL_R = 3, 4
COMPS = ((True, 0, 0, 1088, 1920, 1080, 1920),      # is_luma, sx, sy, Hp,
         (False, 1, 1, 544, 960, 540, 960))         # Wp, H, W


def _mc_inputs(rng, bd, Hp, Wp, H, W):
    """Seeded level inputs: planes, references, per-4x4 maps.  One MV in
    twenty points far outside the picture (up to 1000 luma samples)."""
    import numpy as np
    import torch
    B, R = LEVEL_B, LEVEL_R
    h4, w4 = COMPS[0][3] // 4, COMPS[0][4] // 4
    mv = rng.integers(-64, 65, (B, h4, w4, 2, 2))
    far = rng.random((B, h4, w4, 2, 2)) < 0.05
    mv = np.where(far, rng.integers(-4000, 4001, mv.shape), mv)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    return (t(rng.integers(0, 1 << bd, (B, Hp, Wp)).astype(np.int32)),
            t(rng.integers(-256, 257, (B, Hp, Wp)).astype(np.int32)),
            t(rng.integers(0, 1 << bd, (R, H, W)).astype(np.int32)),
            t(mv.astype(np.int16)),
            t(rng.integers(0, 4, (B, h4, w4)).astype(np.int8)),
            t(rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)))


def check_k5(card, rng, bd=10):
    """K5 on a 1080p level: luma 1920x1088 and chroma 960x544 planes."""
    import torch
    from libhm_tpu_torch.ops import interp as MK
    r = Result()
    for is_luma, sx, sy, Hp, Wp, H, W in COMPS:
        stacked, res, refs, mv, dirm, sel = _mc_inputs(rng, bd, Hp, Wp, H, W)
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=W, H=H)
        got, want = stacked.clone(), stacked.clone()
        MK.mc_grid(got, res, refs, mv, dirm, sel, **kw)
        MK.mc_grid_plain(want, res, refs, mv, dirm, sel, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: MK.mc_grid(got, res, refs, mv, dirm, sel,
                                         **kw), 20)
        pms = cuda_ms(lambda: MK.mc_grid_plain(want, res, refs, mv, dirm,
                                               sel, **kw), 2)
        # what this data needs: the R reference planes, the residual read
        # and the output written at inter samples (int32), the maps
        lh4, lw4 = COMPS[0][5] // 4, COMPS[0][6] // 4      # picture cells
        d = dirm[:, :lh4, :lw4].long()
        per_cell = (4 >> sx) * (4 >> sy)
        inter = int((d > 0).sum()) * per_cell
        taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
        mvc = mv[:, :lh4, :lw4].long()
        fx = (mvc[..., 0] & ((1 << fbx) - 1)) != 0
        fy = (mvc[..., 1] & ((1 << fby) - 1)) != 0
        ops = sum(_mc_list_ops(fx[..., l], fy[..., l],
                               (d & (1 << l)) != 0, taps)
                  for l in range(2)) + torch.where(d > 0, 8, 0)
        nbytes = refs.numel() * 4 + inter * 8 + dirm.numel() * 13
        log(f"K5 mc_grid {'luma' if is_luma else 'chroma'} {(Hp, Wp)} "
            f"B={LEVEL_B} R={LEVEL_R} inter samples={inter}: mismatches="
            f"{int((got != want).sum())} kernel {bms:.4f} ms, plain "
            f"{pms:.4f} ms ({card})")
        r.add(e, bms, pms, nbytes, int(ops.sum()) * per_cell)
    return r


def check_k6(card, rng, bd=10, denom=6):
    """K6 (weighted epilogue) on every inter 4x4 of a 1080p level."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import interp as MK
    r = Result()
    for is_luma, sx, sy, Hp, Wp, H, W in COMPS:
        stacked, res, refs, mv, dirm, sel = _mc_inputs(rng, bd, Hp, Wp, H, W)
        d = dirm[:, :COMPS[0][5] // 4, :COMPS[0][6] // 4].cpu().numpy()
        b, ys4, xs4 = np.nonzero(d)
        N = len(b)
        mvn = mv.cpu().numpy()[b, ys4, xs4].reshape(N, 4)
        sn = sel.cpu().numpy()[b, ys4, xs4]
        blk = np.zeros((N, len(MK.BLK_FIELDS)), np.int32)
        blk[:, 0], blk[:, 1], blk[:, 2] = b, (xs4 << 2) >> sx, (ys4 << 2) >> sy
        blk[:, 3] = d[b, ys4, xs4]
        blk[:, 4:8], blk[:, 8:10] = mvn, sn
        blk[:, 10:12] = rng.integers(-128, 256, (N, 2))
        blk[:, 12:14] = rng.integers(-128, 128, (N, 2)) << (bd - 8)
        blk_dev = torch.from_numpy(blk).to(DEV)
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, wp=True, denom=denom,
                  W=W, H=H)
        got, want = stacked.clone(), stacked.clone()
        MK.mc_weighted(got, res, refs, blk_dev, **kw)
        MK.mc_weighted_plain(want, res, refs, blk_dev, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: MK.mc_weighted(got, res, refs, blk_dev, **kw),
                      20)
        pms = cuda_ms(lambda: MK.mc_weighted_plain(want, res, refs, blk_dev,
                                                   **kw), 2)
        per_blk = (4 >> sx) * (4 >> sy)
        taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
        t = torch.from_numpy(blk).long()
        ops = sum(_mc_list_ops((t[:, 4 + 2 * l] & ((1 << fbx) - 1)) != 0,
                               (t[:, 5 + 2 * l] & ((1 << fby) - 1)) != 0,
                               (t[:, 3] & (1 << l)) != 0, taps)
                  for l in range(2)) + 10
        nbytes = refs.numel() * 4 + N * per_blk * 8 + blk.nbytes
        log(f"K6 mc_weighted {'luma' if is_luma else 'chroma'} {(Hp, Wp)} "
            f"blocks={N} denom={denom}: mismatches="
            f"{int((got != want).sum())} kernel {bms:.4f} ms, plain "
            f"{pms:.4f} ms ({card})")
        r.add(e, bms, pms, nbytes, int(ops.sum()) * per_blk)
    return r


def check_k7(card, rng, npics=17, bd=10):
    """K7 over the cropped output planes of a 17-picture 1080p stream,
    against its plain version and the library sum."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import checksum as CK
    r = Result()
    views = []
    for Hp, Wp, H, W in ((1088, 1920, 1080, 1920), (544, 960, 540, 960),
                         (544, 960, 540, 960)):
        planes = torch.from_numpy(rng.integers(
            0, 1 << bd, (npics, Hp, Wp)).astype(np.int32)).to(DEV)
        views += [planes[b, :H, :W] for b in range(npics)]
    got = int(CK.plane_checksum(views).item()) & 0xFFFFFFFF
    want = int(CK.plane_checksum_plain(views).item())
    lib = [v.sum(dtype=torch.int64) for v in views]
    lib = int(sum(int(s.item()) for s in lib)) & 0xFFFFFFFF
    bms = cuda_ms(lambda: CK.plane_checksum(views), 20)
    pms = cuda_ms(lambda: CK.plane_checksum_plain(views), 5)
    r.library_ms = cuda_ms(
        lambda: [v.sum(dtype=torch.int64) for v in views], 5)
    n = sum(v.numel() for v in views)
    log(f"K7 plane_checksum {len(views)} views, {n} samples: kernel {got}, "
        f"plain {want}, library {lib}; kernel {bms:.4f} ms, plain {pms:.4f} "
        f"ms, view.sum(dtype=torch.int64) per view {r.library_ms:.4f} ms "
        f"({card})")
    r.add(abs(got - want) + abs(got - lib), bms, pms, n * 4 + len(views) * 32,
          n)
    return r


def breakdown(data, card):
    """Where the RA recon time goes: host functions (cProfile) and the
    device kernel time and busy share (torch.profiler), one run each."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import dag_decode as DD
    cuda = torch.device("cuda")

    def items():
        dec = Decoder(parse="native", recon="collect")
        dec.decode_annexb(data)
        return dec.collected
    its = items()
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prof.enable()
    DD._recon_levels(its, cuda)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.monotonic() - t0
    log(f"breakdown ({card}): recon under cProfile {wall:.3f} s; "
        "cumulative host seconds per function (calls):")
    names = {"prepare_component", "_bucket_inputs", "_tu_bucket_entries",
             "_residual_planes_batch_device", "_intra_batch", "filter_level",
             "prepare_filter_maps", "compute_bs_maps", "residual_scatter",
             "intra_level", "deblock_luma", "deblock_chroma", "sao", "up",
             "__call__", "_inter_level", "_inter_level_grid",
             "_inter_level_gathered", "_level_refs", "_ref_stack", "mc_grid",
             "mc_weighted", "reference_levels", "_recon_levels"}
    rows = [(ct, f"{os.path.basename(f)}:{fn}", nc)
            for (f, _, fn), (_, nc, _, ct, _)
            in pstats.Stats(prof).stats.items()
            if fn in names and "libhm_tpu_torch" in f]
    for ct, fn, nc in sorted(rows, reverse=True):
        log(f"  {fn:44s} {ct:8.3f} s  ({nc})")

    its = items()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        DD._recon_levels(its, cuda)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    dev = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            dev[e.key] = (us, e.count)
    total = sum(us for us, _ in dev.values())
    log(f"breakdown ({card}): recon under torch.profiler {wall:.3f} s; "
        f"device time {total / 1e3:.3f} ms, busy share "
        f"{(total / 1e6) / wall:.2%}" if total else
        "device time: not measured (the profiler saw no device activity)")
    for key, (us, cnt) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {key[:60]:60s} {us / 1e3:9.3f} ms  ({cnt})")


def decode_md5(name, gold):
    import torch
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    data = open(os.path.join(ROOT, "testdata", gold[name]["bitstream"]),
                "rb").read()
    outs = decode_batch(data, device=torch.device("cuda"))
    torch.cuda.synchronize()
    for pic in outs:
        for p in pic:
            if p.ndim != 2 or not p.size:
                raise AssertionError(f"{name}: bad output plane {p.shape}")
    if len(outs) != gold[name]["frames"]:
        raise AssertionError(f"{name}: {len(outs)} pictures, expected "
                             f"{gold[name]['frames']}")
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    got = hashlib.md5(buf).hexdigest()
    want = gold[name]["decoded_yuv_md5"]
    if got != want:
        raise AssertionError(f"{name}: MD5 {got} != golden {want}")
    return len(outs), outs


def main():
    if not os.path.isdir(os.path.join(ROOT, "libhm_tpu_torch")) or \
            not os.path.isdir(os.path.join(ROOT, "testdata")):
        sys.exit("chip_smoke: run from the root of a checkout of the repo")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ---- build: the host parser and the kernels at once ----
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.kernels import build as KB
    t0 = time.monotonic()
    native = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from libhm_tpu_torch.hostdec import native_bridge as nb;"
         " nb.build()", ROOT])
    ptxas = KB.build(verbose=True)
    KB.library()
    log(f"kernel build (nvcc, {len(KB._sources())} sources in parallel): "
        f"{time.monotonic() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "Used" in line:
            log("  " + line.strip())
    if native.wait() != 0:
        raise RuntimeError("native host parser build failed")
    native_bridge.build()
    log(f"native host parser build (alongside): "
        f"{time.monotonic() - t0:.1f} s")

    # ---- kernels vs plain versions at main-path shapes ----
    from libhm_tpu_torch.hostdec.decoder import Decoder
    gold = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
    intra_data = open(os.path.join(ROOT, "testdata",
                                   gold[INTRA]["bitstream"]), "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(intra_data)
    items = dec.collected
    log(f"{INTRA}: intra blocks per picture "
        f"{[len(it['pic'].intra_list) for it in items]}")
    rng = np.random.default_rng(2024)
    results = {}
    results["residual_scatter"] = check_k1(items, card, rng)
    results["intra_level"] = check_k2(items, card, rng)
    results.update(check_k3(card, rng))
    results["sao_apply"] = check_k4(card, rng)
    results["mc_grid"] = check_k5(card, rng)
    results["mc_weighted"] = check_k6(card, rng)
    results["plane_checksum"] = check_k7(card, rng)
    bad = {k: v.err for k, v in results.items() if v.err != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- the main paths, counters reset just before each ----
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import deblock as DK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import sao as SK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    kernels = {"residual_scatter": TK._K1, "intra_level": IK._K2,
               "deblock_luma": DK._K3_LUMA, "deblock_chroma": DK._K3_CHROMA,
               "sao_apply": SK._K4, "mc_grid": MK._K5,
               "mc_weighted": MK._K6, "plane_checksum": CK._K7}
    k1_k4 = ["residual_scatter", "intra_level", "deblock_luma",
             "deblock_chroma", "sao_apply"]

    def run_path(label, fn, needed):
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {nm: k.launches for nm, k in kernels.items()}
        idle = [nm for nm in needed if counts[nm] == 0]
        if idle:
            raise AssertionError(f"{label}: kernels never launched: {idle}")
        log(f"{label}: launches {counts}")
        return out, counts

    launches = {}
    (npics, ra_outs), counts = run_path(
        f"{STREAM} decode_batch", lambda: decode_md5(STREAM, gold),
        k1_k4 + ["mc_grid"])
    log(f"{STREAM}: {npics} pictures, MD5 matches golden")
    launches.update({k: counts[k] for k in k1_k4 + ["mc_grid"]})
    (n, _), counts = run_path(f"{WP} decode_batch",
                              lambda: decode_md5(WP, gold), ["mc_weighted"])
    log(f"{WP}: {n} pictures, MD5 matches golden")
    launches["mc_weighted"] = counts["mc_weighted"]

    data = open(os.path.join(ROOT, "testdata", gold[STREAM]["bitstream"]),
                "rb").read()
    xfer.reset()
    (parse_s, comp_s, csum, n), counts = run_path(
        f"{STREAM} decode_batch_device",
        lambda: DD.decode_batch_device(data, device="cuda"),
        k1_k4 + ["mc_grid", "plane_checksum"])
    want = DD.cropped_checksum(ra_outs)
    if csum != want or n != npics or xfer.D2H != 4:
        raise AssertionError(f"decode_batch_device: checksum {csum} vs "
                             f"{want}, {n} pictures, {xfer.D2H} bytes down")
    launches["plane_checksum"] = counts["plane_checksum"]
    log(f"decode_batch_device {STREAM} ({card}): checksum {csum} equals "
        f"cropped_checksum; parse {parse_s:.3f} s, device recon + checksum "
        f"{comp_s:.3f} s, {n / (parse_s + comp_s):.2f} fps, D2H "
        f"{xfer.D2H} bytes, H2D {xfer.H2D / n / 1e6:.3f} MB/picture")
    del ra_outs

    for name in (INTRA,) + SMALL:
        (n, _), _ = run_path(f"{name} decode_batch",
                             lambda: decode_md5(name, gold), k1_k4)
        log(f"{name}: {n} pictures, MD5 matches golden")

    # ---- timed run of the RA stream: parse and device phases ----
    xfer.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    t1 = time.monotonic()
    pending = DD._recon_levels(dec.collected, torch.device("cuda"))
    torch.cuda.synchronize()
    t2 = time.monotonic()
    outs = DD._materialize(dec, pending, False)
    t3 = time.monotonic()
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    if hashlib.md5(buf).hexdigest() != gold[STREAM]["decoded_yuv_md5"]:
        raise AssertionError("timed run: MD5 mismatch")
    log(f"{STREAM}: intra blocks per picture (decode order) "
        f"{[len(it['pic'].intra_list) for it in dec.collected]}")
    log(f"timed {STREAM} ({card}): parse {t1 - t0:.3f} s, device recon "
        f"{t2 - t1:.3f} s (host prep + launches), download {t3 - t2:.3f} s, "
        f"{len(outs) / (t3 - t0):.2f} fps end to end; H2D "
        f"{xfer.H2D / len(outs) / 1e6:.3f} MB/picture, D2H "
        f"{xfer.D2H / len(outs) / 1e6:.3f} MB/picture; H2D by tag (MB) "
        f"{ {k: round(v / 1e6, 3) for k, v in sorted(xfer.BY_TAG.items())} }")
    del outs, pending, dec

    breakdown(data, card)

    src = {"residual_scatter": ("libhm_tpu_torch/csrc/residual.cu",
                                "libhm_tpu/recon_tpu.py:60"),
           "intra_level": ("libhm_tpu_torch/csrc/intra.cu",
                           "libhm_tpu/parallel/batch_decode.py:266"),
           "deblock_luma": ("libhm_tpu_torch/csrc/deblock.cu",
                            "libhm_tpu/ops/deblock.py:28"),
           "deblock_chroma": ("libhm_tpu_torch/csrc/deblock.cu",
                              "libhm_tpu/ops/deblock.py:136"),
           "sao_apply": ("libhm_tpu_torch/csrc/sao.cu",
                         "libhm_tpu/ops/sao.py:19"),
           "mc_grid": ("libhm_tpu_torch/csrc/mc.cu",
                       "libhm_tpu/parallel/dag_decode.py:190"),
           "mc_weighted": ("libhm_tpu_torch/csrc/mc.cu",
                           "libhm_tpu/parallel/dag_decode.py:73"),
           "plane_checksum": ("libhm_tpu_torch/csrc/checksum.cu",
                              "libhm_tpu/parallel/dag_decode.py:620")}
    rows = []
    for name in kernels:
        r = results[name]
        bound_ms, bound_by = r.bound()
        rows.append({"name": name, "route": "cuda", "source": src[name][0],
                     "replaces": src[name][1], "launches": launches[name],
                     "max_abs_err": r.err, "ms": round(r.ms, 4),
                     "plain_ms": round(r.plain_ms, 4),
                     "bound_ms": float(f"{bound_ms:.4g}"),
                     "bound_by": bound_by,
                     "library_ms": None if r.library_ms is None
                     else round(r.library_ms, 4)})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
