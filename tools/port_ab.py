#!/usr/bin/env python3
"""A/B device times of the port's K6 (mc_weighted) and K7 (plane_checksum)
between two checkouts of the repo, on one GPU.

    python3 tools/port_ab.py OLD_ROOT NEW_ROOT

Both packages are named libhm_tpu_torch, so each run loads one checkout's
package in a child process (`--child ROOT`), which builds that checkout's
kernels and native parser, makes the same seeded inputs and prints one
JSON line:

- K6's device time (queued behind a sleep, as chip_smoke.py's device_ms)
  on a 1080p level of random per-4x4 MVs, on a PU-shaped 1080p level
  (NEW_ROOT/tests/mc_cases.py, 8x8 to 64x64 PUs) and on the fused step's
  4096 rows, luma and 4:2:0 chroma, and K5's (mc_grid, which shares K6's
  window staging) on the random level's per-4x4 maps;
- K6's launches and device time summed over a decode of
  wp_lowdelayP_416x240 (torch.profiler, kernel events only), and the host
  ms of dag_decode._inter_level_gathered (the block tables, their tile
  grouping, upload and K6's enqueue) summed over that decode, the
  smallest of five decodes;
- K7's enqueue rate and device time over the 51 cropped planes of a
  17-picture 1080p stream, and what its wrapper uploads.

The runs go old, new, new, old, and the parent prints their lines after
the card's name and power limit.  A checkout whose mc_weighted takes
`groups` gets its rows grouped by tile beforehand (tile_groups; the fused
step's rows one run per 16x16 block), as its decode and its entry step
hand them; an older one gets them as they come.  Needs one card.
"""
import json
import os
import subprocess
import sys
import time

DEV = "cuda"
LEVEL = (3, 4, 1088, 1920, 1080, 1920)         # B, R, Hp, Wp, H, W (luma)
WP = "wp_lowdelayP_416x240"


def device_ms(fn, reps=20):
    """Mean device ms of fn() over `reps` runs queued behind a sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 1000000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps=20):
    """Mean ms of fn() over `reps` back-to-back runs (the host's rate)."""
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


def child(root, cases):
    sys.path[:0] = [root, cases]
    import inspect

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libhm_tpu_torch import entry as E
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.kernels import build as KB
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    from mc_cases import block_table, pu_maps
    KB.library()
    native_bridge.build()
    grouped = "groups" in inspect.signature(MK.mc_weighted).parameters
    rng = np.random.default_rng(9)
    B, R, Hp, Wp, H, W = LEVEL
    out = {"root": root, "grouped": grouped}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    def k6(blk, planes, runs=None, **kw):
        stacked, res, refs = planes
        blk = t(blk)
        extra = {}
        if grouped:
            if runs is None:
                blk, runs = MK.tile_groups(blk, B=stacked.shape[0],
                                           Hp=stacked.shape[1],
                                           Wp=stacked.shape[2])
            extra["groups"] = t(runs) if isinstance(runs, np.ndarray) \
                else runs
        got = stacked.clone()
        return device_ms(lambda: MK.mc_weighted(got, res, refs, blk, **extra,
                                                **kw))

    maps = pu_maps(rng, B, R, Hp, Wp, sizes=(16, 8, 4, 2))
    h4, w4 = H // 4, W // 4
    for comp, sx, sy in (("luma", 0, 0), ("chroma", 1, 1)):
        hp, wp, h, w = Hp >> sy, Wp >> sx, H >> sy, W >> sx
        planes = (t(rng.integers(0, 1024, (B, hp, wp)).astype(np.int32)),
                  t(rng.integers(-256, 257, (B, hp, wp)).astype(np.int32)),
                  t(rng.integers(0, 1024, (R, h, w)).astype(np.int32)))
        kw = dict(is_luma=comp == "luma", sx=sx, sy=sy, bd=10, wp=True,
                  denom=6, W=w, H=h)
        # random per-4x4 MVs, one in twenty up to 1000 samples out
        d = rng.integers(0, 4, (B, h4, w4))
        b, ys4, xs4 = np.nonzero(d)
        N = len(b)
        mv = rng.integers(-64, 65, (N, 4))
        mv = np.where(rng.random((N, 4)) < 0.05,
                      rng.integers(-4000, 4001, (N, 4)), mv)
        blk = np.concatenate(
            [np.stack([b, (xs4 << 2) >> sx, (ys4 << 2) >> sy, d[b, ys4, xs4]],
                      1), mv, rng.integers(0, R, (N, 2)),
             rng.integers(-128, 256, (N, 2)),
             rng.integers(-128, 128, (N, 2)) << 2], 1).astype(np.int32)
        out[f"k6_random_{comp}_ms"] = k6(blk, planes, **kw)
        mvm = np.zeros((B, Hp // 4, Wp // 4, 2, 2), np.int16)
        dm = np.zeros((B, Hp // 4, Wp // 4), np.int8)
        sm = np.zeros((B, Hp // 4, Wp // 4, 2), np.int16)
        mvm[b, ys4, xs4] = mv.reshape(N, 2, 2)
        dm[b, ys4, xs4] = d[b, ys4, xs4]
        sm[b, ys4, xs4] = blk[:, 8:10]
        got = planes[0].clone()
        mvm, dm, sm = t(mvm), t(dm), t(sm)
        kw5 = {k: v for k, v in kw.items() if k not in ("wp", "denom")}
        out[f"k5_random_{comp}_ms"] = device_ms(lambda: MK.mc_grid(
            got, planes[1], planes[2], mvm, dm, sm, **kw5))
        out[f"k6_pu_{comp}_ms"] = k6(
            block_table(maps, sx, sy, 10, past=False), planes, **kw)

    # the fused step's MC: 256 bi-predicted 16x16 blocks as 4096 rows
    a = E.make_inputs()
    nb16 = len(a["bx"])
    off = np.arange(0, 16, 4)
    blk = np.zeros((nb16, 4, 4, len(MK.BLK_FIELDS)), np.int32)
    blk[..., 1] = a["bx"][:, None, None] + off[None, None, :]
    blk[..., 2] = a["by"][:, None, None] + off[None, :, None]
    blk[..., 3] = 3
    blk[..., 4:8] = a["mv"].reshape(nb16, 1, 1, 4)
    blk[..., 8] = blk[..., 9] = a["sel"][:, None, None]
    fH, fW = a["frame"].shape
    out["k6_fused_ms"] = k6(
        blk.reshape(-1, blk.shape[-1]),
        (t(a["frame"].reshape(1, fH, fW)), t(np.zeros((1, fH, fW), np.int32)),
         t(a["refs"])), runs=np.arange(0, 16 * nb16 + 1, 16, dtype=np.int32),
        is_luma=True, sx=0, sy=0, bd=E.BD, wp=False, denom=0, W=fW, H=fH)

    # K6 over the WP golden's decode
    gold = json.load(open(os.path.join(root, "testdata", "golden.json")))
    data = open(os.path.join(root, "testdata", gold[WP]["bitstream"]),
                "rb").read()
    DD.decode_batch(data, device=DEV)
    n0 = MK._K6.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        DD.decode_batch(data, device=DEV)
        torch.cuda.synchronize()
    hits = [(getattr(e, "self_device_time_total", 0), e.count)
            for e in p.key_averages() if "mc_weighted" in e.key and
            str(getattr(e, "device_type", "")).endswith("CUDA")]
    out["k6_wp_launches"] = MK._K6.launches - n0
    out["k6_wp_device_ms"] = sum(us for us, _ in hits) / 1e3
    out["k6_wp_kernels_seen"] = sum(n for _, n in hits)
    inner, spent = DD._inter_level_gathered, []

    def timed(*args):
        t0 = time.perf_counter()
        got = inner(*args)
        spent[-1] += time.perf_counter() - t0
        return got
    DD._inter_level_gathered = timed
    for _ in range(5):
        spent.append(0.0)
        DD.decode_batch(data, device=DEV)
        torch.cuda.synchronize()
    DD._inter_level_gathered = inner
    out["wp_inter_level_host_ms"] = min(spent) * 1e3

    # K7 over the cropped planes of a 17-picture 1080p stream
    views = []
    for hp, wp, h, w in ((1088, 1920, 1080, 1920), (544, 960, 540, 960),
                         (544, 960, 540, 960)):
        planes = t(rng.integers(0, 1024, (17, hp, wp)).astype(np.int32))
        views += [planes[i, :h, :w] for i in range(17)]
    xfer.reset()
    want = int(CK.plane_checksum_plain(views).item())
    got = int(CK.plane_checksum(views).item()) & 0xFFFFFFFF
    if got != want:
        raise AssertionError(f"K7 {got} != plain {want}")
    out["k7_uploads"] = dict(xfer.BY_TAG)
    out["k7_enqueue_ms"] = enqueue_ms(lambda: CK.plane_checksum(views))
    out["k7_device_ms"] = device_ms(lambda: CK.plane_checksum(views))
    print(json.dumps(out))


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        return child(sys.argv[2], sys.argv[4])
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    old, new = (os.path.abspath(r) for r in sys.argv[1:])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--cases",
                            os.path.join(new, "tests")],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            sys.exit(f"{label} run failed:\n{r.stdout[-3000:]}"
                     f"{r.stderr[-3000:]}")
        print(label, r.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
