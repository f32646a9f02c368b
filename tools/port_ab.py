#!/usr/bin/env python3
"""A/B of the port's cross-component prediction (K1 + K10, or K1 with its
CCP epilogue), PCM level (K9) and K1's int16 form between two checkouts of
the repo, on one GPU.

    python3 tools/port_ab.py OLD_ROOT NEW_ROOT

Both packages are named libhm_tpu_torch, so each run loads one checkout's
package in a child process (`--child ROOT`), which builds that checkout's
kernels and native parser, makes the same seeded inputs (from
NEW_ROOT/tests: ccp_cases.py, pcm_cases.py) and prints one JSON line:

- CCP on a seeded 1080p 4:4:4 chroma level (two pictures, every 32x32
  cell tiled with TUs, an alpha on 30% of them): the device time (queued
  behind a sleep) and the enqueue rate of a checkout's whole CCP residual
  build of the component: K1 on the table without alphas then K10
  (`ccp_apply`) where the checkout has it, else K1 with the alphas in its
  rows; K1 on the table without alphas alone; the MD5 of the result;
- K9 on a seeded 1080p 4:2:0 level (a PCM CU in about a third of the
  32x32 cells): the launches' device time and enqueue rate (one
  `pcm_scatter` per component, or one `pcm_level`), the host ms of the
  checkout's dag_decode._pcm_level (packing, uploads, launches; least of
  20 runs), its uploads, and the MD5 of the planes;
- K1 on the TU tables of every level of randomaccess_main10_1080p (the
  decode's own coefficients and modes, one table per component and
  level): the device time and enqueue rate summed over the tables, and
  the MD5 of the residual planes;
- K1's build: the `-Xptxas -v` registers and spill bytes of each
  instantiation of residual_table_kernel;
- rext444_randomaccess_416x240 through decode_batch: K1 launches, the
  launches that carry CCP (K10, or K1 with CCP rows) and the H2D uploads;
  pcm_port_416x240 through decode_batch and through the per-picture
  decoder: K9 launches and `pcm` uploads.

The runs go old, new, new, old, and the parent prints their lines after
the card's name and power limit.  Needs one card.
"""
import hashlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

DEV = "cuda"


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


def md5(planes):
    return hashlib.md5(b"".join(p.cpu().numpy().tobytes()
                                for p in planes)).hexdigest()


def k1_ptxas(log):
    """K1's lines of an `nvcc -Xptxas -v` log: for each instantiation of
    residual_table_kernel (by its mangled name from the kernel's name on),
    its registers and its stack and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1]
            name = m[m.index("residual_table_kernel"):] \
                if "residual_table_kernel" in m else None
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def child(root, cases):
    sys.path[:0] = [root, cases]
    import numpy as np
    import torch

    from ccp_cases import ccp_level
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.kernels import build as KB
    from libhm_tpu_torch.ops import ccp as CK
    from libhm_tpu_torch.ops import pcm as PK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    from pcm_cases import pcm_blocks, plane_shapes
    ptxas = KB.build(verbose=True)
    KB.library()
    native_bridge.build()
    epilogue = hasattr(TK, "F_CCP")
    out = {"root": root, "ccp": "K1 epilogue" if epilogue else "K1 + K10",
           "k1_ptxas": k1_ptxas(ptxas)}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa

    # CCP on a seeded 1080p 4:4:4 chroma level
    B, H, W = 2, 1088, 1920
    lv = ccp_level(np.random.default_rng(9), TK.TU_DTYPE, B, H, W, share=0.3)
    bare, = TB.upload_tables([(lv["rows"], lv["coeffs"], lv["counts"],
                               lv["flags"])], DEV)
    res_l, tus = t(lv["res_l"]), t(lv["tus"])
    got = torch.zeros((B, H, W), dtype=torch.int32, device=DEV)
    if epilogue:
        rows = lv["rows"].copy()
        rows["rdpcm"] |= TK.ccp_bits(lv["alpha"])
        rows["flags"] |= np.where(lv["alpha"] != 0, TK.F_CCP,
                                  0).astype(np.uint8)
        table, = TB.upload_tables([(rows, lv["coeffs"], lv["counts"],
                                    int(np.bitwise_or.reduce(rows["flags"])))],
                                  DEV)

        def ccp():
            TK.residual_table(got, table, res_l=res_l)
    else:
        def ccp():
            TK.residual_table(got, bare)
            CK.ccp_apply(got, res_l, tus)
    ccp()
    out["ccp_md5"] = md5([got])
    out["ccp_device_ms"] = device_ms(ccp)
    out["ccp_enqueue_ms"] = enqueue_ms(ccp)
    out["k1_without_alphas_device_ms"] = device_ms(
        lambda: TK.residual_table(got, bare))

    # K9 on a seeded 1080p 4:2:0 level
    blocks = pcm_blocks(np.random.default_rng(10), 1, 1, 1088, 1920,
                        share=1 / 3)
    shapes = plane_shapes(1, 1, 1088, 1920)
    planes = [torch.zeros(s, dtype=torch.int32, device=DEV) for s in shapes]
    if hasattr(PK, "pcm_level"):
        buf, counts = PK.pcm_pack(blocks)
        table = PK.pcm_table(t(buf), counts)

        def k9():
            PK.pcm_level(planes, table)
    else:
        args = []
        for c in range(3):
            mine = [blk for blk in blocks if blk[0] == c]
            sizes = [w * h for _, _, _, _, w, h, _, _ in mine]
            args.append((
                t(np.asarray([(b, x, y, w, h, sh)
                              for _, b, x, y, w, h, sh, _ in mine], np.int32)),
                t(np.concatenate([s.reshape(-1) for *_, s in mine])
                  .astype(np.int16)),
                t((np.cumsum(sizes) - sizes).astype(np.int32))))

        def k9():
            for c in range(3):
                PK.pcm_scatter(planes[c], *args[c])
    k9()
    out["k9_md5"] = md5(planes)
    out["k9_device_ms"] = device_ms(k9)
    out["k9_enqueue_ms"] = enqueue_ms(k9)
    bd = 10
    item = {"sps": SimpleNamespace(bit_depth_luma=bd, bit_depth_chroma=bd),
            "pic": SimpleNamespace(pcm_list=[
                (c, x, y, w, h, s, bd - sh)
                for c, b, x, y, w, h, sh, s in blocks])}
    spent = []
    for _ in range(20):
        torch.cuda.synchronize()
        xfer.reset()
        t0 = time.perf_counter()
        DD._pcm_level([item], planes, torch.device(DEV))
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
    out["pcm_level_host_ms"] = min(spent) * 1e3
    out["pcm_level_uploads_bytes"] = dict(xfer.BY_TAG)

    # K1 on the RA 1080p stream's own tables, level by level
    gold = json.load(open(os.path.join(root, "testdata", "golden.json")))
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(open(os.path.join(root, "testdata", gold[
        "randomaccess_main10_1080p"]["bitstream"]), "rb").read())
    runs, res = [], []
    for items in DD.reference_levels(dec.collected):
        sps = items[0]["sps"]
        Hp, Wp = sps.pic_height_ctbs << sps.log2_ctb, \
            sps.pic_width_ctbs << sps.log2_ctb
        tables, lists = TB.residual_tables(items)
        mats = TB._MatrixTable(lists, DEV).tables
        for c, table in enumerate(TB.upload_tables(tables, DEV)):
            plane = torch.zeros((len(items), Hp >> (c > 0), Wp >> (c > 0)),
                                dtype=torch.int32, device=DEV)
            runs.append(lambda p=plane, tb=table, m=mats:
                        TK.residual_table(p, tb, m))
            res.append(plane)
    for f in runs:
        f()
    out["k1_ra_tables"] = len(runs)
    out["k1_ra_md5"] = md5(res)
    out["k1_ra_device_ms"] = sum(device_ms(f) for f in runs)
    out["k1_ra_enqueue_ms"] = sum(enqueue_ms(f) for f in runs)

    # launches and uploads on two decodes
    ports = json.load(open(os.path.join(root, "testdata",
                                        "port_streams.json")))
    copies = {}
    real_up = xfer.up

    def counted(a, tag, device):
        copies[tag] = copies.get(tag, 0) + 1
        return real_up(a, tag, device)
    xfer.up = counted
    ccp_k = TK._K1_CCP if epilogue else CK._K10
    data = open(os.path.join(root, "testdata", gold[
        "rext444_randomaccess_416x240"]["bitstream"]), "rb").read()
    copies.clear()
    TK._K1.launches = ccp_k.launches = 0
    DD.decode_batch(data, device=DEV)
    out["rext444_ra"] = {"k1": TK._K1.launches, "ccp": ccp_k.launches,
                         "uploads": sum(copies.values()),
                         "by_tag": dict(copies)}
    data = open(os.path.join(root, "testdata", ports[
        "pcm_port_416x240"]["bitstream"]), "rb").read()
    for path in ("decode_batch", "per_picture"):
        copies.clear()
        PK._K9.launches = 0
        if path == "decode_batch":
            DD.decode_batch(data, device=DEV)
        else:
            Decoder(parse="native", recon="torch",
                    device=torch.device(DEV)).decode_annexb(data)
        torch.cuda.synchronize()
        out[f"pcm_port_{path}"] = {"k9": PK._K9.launches,
                                   "pcm_uploads": copies.get("pcm", 0),
                                   "uploads": sum(copies.values())}
    xfer.up = real_up
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
