"""Decode benchmark of libhm_tpu_torch, the PyTorch and CUDA HEVC decoder.

Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 hevc_bench/run.py --workload main10_ra_1080p.batch \
        --seed 12345 --seconds 10 --trace 0

It sets up (the program's builds where stale, the card, a small warm-up
decode), decodes for --seconds, compares every delivered file with HM's
decode of the stream, and prints one JSON line as the last line of
standard output: the cell's end-to-end metrics with --trace 0 (set-up
on the host clock, the card's kernel time from torch.profiler), its
per-layer metrics (torch.profiler and spans) with --trace 1.  The numbers
compared and their limits are the last lines of standard error and the
line's last key, "checks".  Exit status: 0 with a result; 2 for a bad
cell or no card; 3 when a JAX module was loaded; 1 when the program
failed.  harness.py says how cells, configurations, traffic mixes and
metrics are found by name.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None):
    args = parse_args(argv)
    import harness
    try:
        spec = harness.load_cell(ROOT, BENCH, args.workload)
    except harness.BenchError as e:
        say(f"hevc_bench: {e}")
        return 2
    os.environ.update(harness.thread_env(spec))
    t = time.perf_counter()
    import torch
    torch_import_s = time.perf_counter() - t
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        say(f"hevc_bench: {args.workload} needs {spec['chips']} CUDA "
            f"device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() is "
            f"{torch.cuda.device_count()}")
        return 2
    sys.path.insert(0, ROOT)
    try:
        line, checks, notes = harness.run_cell(
            spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except Exception:
        import traceback
        say(traceback.format_exc())
        return 1
    bad = harness.forbidden_modules()
    if bad:
        say(f"hevc_bench: modules loaded that the benchmark must not load: "
            f"{', '.join(bad)}")
        return 3
    notes["torch_import_s"] = torch_import_s
    say("hevc_bench notes: " + json.dumps(notes, default=str))
    for name, c in checks.items():
        say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
