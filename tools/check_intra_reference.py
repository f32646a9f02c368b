"""K2's output on a stream's I picture, as the card's decode_batch made
it, against the plain reference of intra reconstruction
(hevc_bench/plain_intra.py): every sample of every component equal.

    python3 tools/check_intra_reference.py STREAM [--json OUT]
        [--device cpu]

decode_batch(STREAM, device="cuda") runs (on the CPU with --device cpu,
the kernels' plain versions: a rehearsal at a small size) with
libhm_tpu_torch.parallel.batch_decode._intra_level wrapped: on the first
reference-DAG level whose pictures are all intra, each component's plane
before and after K2 (one launch over every component) and the residual
plane K1 wrote are kept, with the K2 counts the launch recorded for each
component (utils/obs.py: the lattice's width, the blocks past it).  The reference then reconstructs each component of the
level's first picture from the timed path's own parse (its intra blocks
in decoding order, its slice, tile and prediction-mode maps), from the
plane before K2, with K1's residual.  Prints one JSON line (also written
to OUT): per component the blocks, the samples that differ, the lattice
and plane blocks, and the reference's seconds; and the decode's MD5
beside testdata/golden.json's where the stream is listed there.  Exit
status 0 when every component is equal (and the MD5 matches), else 1.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain_intra():
    """hevc_bench/plain_intra.py, loaded from its file (the benchmark's
    directory is not put on sys.path: its module names are generic)."""
    path = os.path.join(ROOT, "hevc_bench", "plain_intra.py")
    spec = importlib.util.spec_from_file_location("hevc_bench_plain_intra",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def item_reference(it, comp, res, plane=None):
    """plain_intra on component `comp` of the collect item `it` of an
    intra picture, with the residual plane `res` (indexed [y, x] on the
    component's grid) and the samples before the blocks `plane`: the
    parse's blocks in decoding order, its slice, tile and intra maps on
    the component's grid.  Raises unless the blocks cover the picture
    once."""
    from libhm_tpu_torch.hostdec.picture import MODE_INTRA
    P = plain_intra()
    sps, pps, pic = it["sps"], it["pps"], it["pic"]
    if comp and sps.chroma_format_idc not in (1, 3):
        raise ValueError("4:2:2 chroma needs Table 8-3's mode mapping")
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    W, H = sps.width >> sx, sps.height >> sy
    yl = (np.arange(H) << sy)[:, None]
    xl = (np.arange(W) << sx)[None, :]
    tiles = np.asarray(it["tile_map"]).reshape(-1)
    ctb = sps.log2_ctb
    maps = dict(
        slice_id=torch.from_numpy(np.asarray(pic.slice_idx)[yl >> 2,
                                                            xl >> 2]),
        tile_id=torch.from_numpy(tiles[(yl >> ctb) * sps.pic_width_ctbs +
                                       (xl >> ctb)]),
        intra=torch.from_numpy(np.asarray(pic.pred_mode)[yl >> 2, xl >> 2]
                               == MODE_INTRA))
    tq = np.asarray(pic.tq_bypass)
    blocks = []
    cover = np.zeros((H, W), np.int64)
    for b in pic.intra_list:
        if b.comp != comp:
            continue
        n = b.w
        cover[b.y:b.y + n, b.x:b.x + n] += 1
        blocks.append(P.Block(b.x, b.y, n, b.mode,
                              res[b.y:b.y + n, b.x:b.x + n],
                              bool(tq[(b.y << sy) >> 2, (b.x << sx) >> 2])))
    if not (cover == 1).all():
        raise ValueError("the intra blocks do not cover the picture once")
    return P.reconstruct(
        blocks, width=W, height=H,
        bit_depth=sps.bit_depth_chroma if comp else sps.bit_depth_luma,
        c_idx=comp, chroma_array_type=sps.chroma_format_idc,
        strong_intra_smoothing=bool(sps.strong_intra_smoothing),
        intra_smoothing_disabled=bool(sps.intra_smoothing_disabled),
        implicit_rdpcm=bool(sps.implicit_rdpcm),
        constrained_intra_pred=bool(pps.constrained_intra_pred),
        plane=plane, **maps)


def capture(data, device):
    """decode_batch on `device`, keeping K2's inputs and output on the
    first all-intra level: (pictures, {comp: record})."""
    from libhm_tpu_torch.parallel import batch_decode
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    from libhm_tpu_torch.utils import obs
    inner = batch_decode._intra_level
    kept = {}

    def wrapped(items, stacked, res_stacked, device):
        take = not kept and not any(it["pic"].inter_list for it in items)
        if take:
            before = [s[0].to("cpu", copy=True) for s in stacked]
            t0 = time.perf_counter()
        out = inner(items, stacked, res_stacked, device)
        if take:
            # the launch's counts, one a component in its order (luma
            # first; the components with an intra block)
            counts = [s for s in obs.spans(since=t0)
                      if s.name.startswith("k2.")]

            def of(name):
                return [s.n for s in counts if s.name == name]
            comps = [c for c in range(len(stacked))
                     if any(b.comp == c for it in items
                            for b in it["pic"].intra_list)]
            lattice, plane = of("k2.lattice"), of("k2.plane_blocks")
            for i, c in enumerate(comps):
                kept[c] = {"item": items[0], "before": before[c],
                           "res": res_stacked[c][0].cpu(),
                           "after": out[c][0].cpu(),
                           "blocks": sum(b.comp == c for it in items
                                         for b in it["pic"].intra_list),
                           "lattice": lattice[i] if lattice else None,
                           "plane_blocks": plane[i]}
        return out

    batch_decode._intra_level = wrapped
    try:
        pictures = decode_batch(data, device=device)
    finally:
        batch_decode._intra_level = inner
    return pictures, kept


def md5_of(pictures, bit_depth):
    dtype = "<u2" if bit_depth > 8 else "u1"
    h = hashlib.md5()
    for pic in pictures:
        for plane in pic:
            h.update(np.ascontiguousarray(np.asarray(plane),
                                          dtype=dtype).tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stream")
    ap.add_argument("--json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_intra_reference: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    with open(args.stream, "rb") as f:
        data = f.read()
    t = time.perf_counter()
    pictures, kept = capture(data, args.device)
    out = {"stream": os.path.basename(args.stream),
           "device": torch.cuda.get_device_name(0)
           if args.device == "cuda" else args.device,
           "decode_s": time.perf_counter() - t, "components": {}}
    ok = bool(kept)
    for comp, k in sorted(kept.items()):
        sps = k["item"]["sps"]
        sx = sps.chroma_shift_x() if comp else 0
        sy = sps.chroma_shift_y() if comp else 0
        W, H = sps.width >> sx, sps.height >> sy
        t = time.perf_counter()
        want = item_reference(k["item"], comp, k["res"].to(torch.int64),
                              plane=k["before"][:H, :W])
        got = k["after"][:H, :W].to(torch.int64)
        wrong = int((got != want).sum())
        ok &= wrong == 0
        out["components"][comp] = {
            "blocks": k["blocks"], "samples": H * W,
            "samples_wrong": wrong, "lattice": k["lattice"], "width": W,
            "plane_blocks": k["plane_blocks"],
            "reference_s": time.perf_counter() - t}
    with open(os.path.join(ROOT, "testdata", "golden.json")) as f:
        gold = {g["bitstream"]: g for g in json.load(f).values()}
    entry = gold.get(os.path.basename(args.stream))
    if entry is not None:
        out["md5"] = md5_of(pictures, entry["bitdepth"])
        out["md5_golden"] = entry["decoded_yuv_md5"]
        ok &= out["md5"] == out["md5_golden"]
    out["ok"] = ok
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
