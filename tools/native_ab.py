#!/usr/bin/env python3
"""A/B of the port's native C++ decoder (libhm_tpu_torch/hostdec/native)
between two checkouts of the repo, on the CPU of the host it runs on.

    python3 tools/native_ab.py OLD_ROOT NEW_ROOT [--runs N]

Both packages are named libhm_tpu_torch, so each run loads one checkout's
package in a child process (`--child ROOT`), which builds that checkout's
native libraries (native_bridge.build(), not timed) and prints one JSON
line:

- `native_fps`: bench_torch.py's host half, Decoder(parse="native",
  recon="native") over randomaccess_main10_1080p repeated 3 times (51
  pictures), the median of N runs, every repetition at its golden MD5;
- `parse_fps`: the C++ parse alone over the same bytes, the median of N;
- `runs_s` and `parse_runs_s`: every run's seconds;
- `hbd`: where the checkout holds testdata/mono16_ra_1080p.bin, the same
  native decode of it (Monochrome 16, 3 pictures): pictures per second,
  the median of N, and whether the output equals its MD5 in
  testdata/port_streams.json with every hash SEI OK.

The runs go old, new, new, old, and the parent prints their lines after
the host's CPU model and, where there is one, the card's name and power
limit.  Then `--pairs N` pairs (default 15) of the C++ decode alone
(hevcdec_decode with the native recon enabled, no Python on the timed
path) of the same 51 pictures through each checkout's libhevcdec.so, one
child process a side (`--cxx ROOT`: a warm-up, then 3 timed decodes, the
median kept), the order within a pair alternating: one JSON line with
every side's seconds, the median of the new over old ratios of the pairs
and the pairs the new library won.  Needs no card.
"""
import ctypes as C
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import time

HBD = "mono16_ra_1080p"


def child(root, runs):
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import bench_torch as B
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.hostdec.decoder import Decoder
    native_bridge.build()
    times, outs = [], None
    for _ in range(runs):
        dt, outs = B._run_ours_once()
        times.append(dt)
    B._check_exact(outs)
    n = B.NFRAMES * B.REPEAT
    parse = []
    for _ in range(runs):
        t0 = time.monotonic()
        B.bench_parse_only(runs=1)
        parse.append(time.monotonic() - t0)
    line = {"root": root, "native_fps": n / statistics.median(times),
            "parse_fps": n / statistics.median(parse),
            "runs_s": times, "parse_runs_s": parse}
    ports = json.load(open(os.path.join(root, "testdata",
                                        "port_streams.json")))
    if HBD in ports:
        data = open(os.path.join(root, "testdata",
                                 ports[HBD]["bitstream"]), "rb").read()
        secs, ok = [], True
        for _ in range(runs):
            dec = Decoder(parse="native", recon="native",
                          check_sei_hash=True)
            t0 = time.monotonic()
            pics = dec.decode_annexb(data)
            secs.append(time.monotonic() - t0)
            md5 = hashlib.md5(b"".join(np.asarray(p).tobytes()
                                       for pic in pics
                                       for p in pic)).hexdigest()
            ok &= md5 == ports[HBD]["decoded_yuv_md5"] and all(
                dp.hash_status == "OK" for dp in dec.output_records)
        line["hbd"] = {"stream": HBD, "fps": len(pics) /
                       statistics.median(secs), "runs_s": secs,
                       "md5_and_hash_sei_ok": ok}
    print(json.dumps(line), flush=True)


def cxx(root):
    """Seconds of the C++ decode of bench_torch.py's 51 pictures through
    root's libhevcdec.so: the median of 3 after a warm-up."""
    sys.path.insert(0, root)
    import bench_torch as B
    data = B._data()
    lib = C.CDLL(os.path.join(root, "libhm_tpu_torch", "hostdec", "native",
                              "libhevcdec.so"))
    lib.hevcdec_create.restype = C.c_void_p
    lib.hevcdec_enable_recon.argtypes = [C.c_void_p, C.c_int]
    lib.hevcdec_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.hevcdec_destroy.argtypes = [C.c_void_p]
    secs = []
    for _ in range(4):
        t0 = time.monotonic()
        h = lib.hevcdec_create()
        lib.hevcdec_enable_recon(h, 1)
        n = lib.hevcdec_decode(h, data, len(data))
        lib.hevcdec_destroy(h)
        secs.append(time.monotonic() - t0)
        if n != B.NFRAMES * B.REPEAT:
            sys.exit(f"{root}: {n} pictures")
    print(json.dumps(statistics.median(secs[1:])), flush=True)


def interleaved(old, new, pairs):
    """(old seconds, new seconds) of `pairs` alternating pairs of cxx()."""
    secs = ([], [])
    for i in range(pairs):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--cxx", (old, new)[k]], capture_output=True,
                               text=True, timeout=300, check=True)
            secs[k].append(json.loads(r.stdout.strip().splitlines()[-1]))
    return secs


def main():
    args = sys.argv[1:]
    runs, pairs = 5, 15
    for flag in ("--runs", "--pairs"):
        if flag in args:
            i = args.index(flag)
            if flag == "--runs":
                runs = int(args[i + 1])
            else:
                pairs = int(args[i + 1])
            del args[i:i + 2]
    if len(args) == 2 and args[0] == "--child":
        return child(args[1], runs)
    if len(args) == 2 and args[0] == "--cxx":
        return cxx(args[1])
    if len(args) != 2:
        sys.exit(__doc__)
    old, new = (os.path.abspath(r) for r in args)
    cpu = platform.processor() or platform.machine()
    try:
        cpu = next(line.split(":", 1)[1].strip()
                   for line in open("/proc/cpuinfo")
                   if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    print(f"host CPU: {cpu}, {os.cpu_count()} cores", flush=True)
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    except (OSError, subprocess.CalledProcessError):
        print("no card", flush=True)
    for label, root in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--runs", str(runs)],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            sys.exit(f"{label} run failed:\n{r.stdout[-3000:]}"
                     f"{r.stderr[-3000:]}")
        print(label, r.stdout.strip().splitlines()[-1], flush=True)
    o, n = interleaved(old, new, pairs)
    ratios = [b / a for a, b in zip(o, n)]
    print("interleaved " + json.dumps({
        "pairs": pairs, "old_s": o, "new_s": n,
        "old_median_s": statistics.median(o),
        "new_median_s": statistics.median(n),
        "new_over_old_median": statistics.median(ratios),
        "new_faster_pairs": sum(r < 1 for r in ratios)}), flush=True)


if __name__ == "__main__":
    main()
