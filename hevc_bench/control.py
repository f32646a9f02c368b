"""The control of the comparison that decides `correct`, and the program's
readings beside it, on the card at a cell's own size.

    python3 hevc_bench/control.py --workload main10_ra_1080p.batch \
        --seeds 11,12,13 --seconds 1

One set-up, then for each seed a short window of the cell's traffic (at
least one whole request) and two readings of the same delivered files:
the program's (reference.compare) and the control's, the files judged
after every sample is rounded to 8 bits (reference.to_8_bits, the nearest
precision below the configuration's 10).  Prints one JSON line per seed.
The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def readings(spec, seeds, seconds, device, t0):
    """[(seed, program numbers, control numbers, pictures)] for each seed."""
    import harness
    import reference
    harness.set_torch_threads(spec)
    ctx, driver, data, _ = harness.setup(spec, device, seeds[0], t0)
    config = spec["config"]
    out = []
    for seed in seeds:
        ctx.rng = harness.seeded_rng(seed)
        run = harness.window(ctx, driver, data, seconds, trace=False)
        if run.errors:
            raise RuntimeError(run.errors[0])
        program = reference.compare(run.files, config["reference"],
                                    config["geometry"])
        control = reference.compare(run.files, config["reference"],
                                    config["geometry"], reference.to_8_bits)
        out.append((seed, program, control, run.pictures))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import harness
    spec = harness.load_cell(ROOT, BENCH, args.workload)
    os.environ.update(harness.thread_env(spec))
    sys.path.insert(0, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, program, control, pictures in readings(
            spec, seeds, args.seconds, "cuda", T0):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "pictures": pictures, "program": program,
                          "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
