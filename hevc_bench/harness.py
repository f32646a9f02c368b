"""The benchmark's harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:

    BENCHMARK.json                    cells and metrics
    hevc_bench/configs/<config>.json  the deployment: stream, HM's decode
                                      of it (the reference), geometry,
                                      warm-up stream, host thread counts
    hevc_bench/traffic/<mix>.json     the traffic's parameters; its "kind"
                                      names the driver
    hevc_bench/drivers/<kind>.py      decode(ctx, data) -> (files, extras):
                                      one request through the program's
                                      entry point
    hevc_bench/metrics/<metric>.py    read(run) -> number or None, for
                                      every metric, end to end or per layer

A run: set-up (imports, the program's two builds where stale, the card,
one warm-up decode of a small stream of the same coding tools through
the same entry point), then requests back to back for `seconds`; the
request running when the window ends is allowed to finish and counts.
After the window every delivered file is compared with HM's decode
(reference.py).  On the card the window runs under torch.profiler
(devtrace.py) in every run; with trace on, the program's layer
boundaries are wrapped as well (spans.py), and the per-layer metrics are
read from both.
"""
import gc
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import traceback

import reference

FORBIDDEN = ("jax", "jaxlib", "flax", "libhm_tpu")
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
              "HEVC_PARSE_THREADS")


class BenchError(Exception):
    """A cell, configuration, mix or metric that cannot be found or read."""


def _load_json(path, what):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise BenchError(f"{what}: cannot read {path}: {e}") from None


def _applies(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root, bench_dir, workload):
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    traffic mix, driver file and the metric files of every metric that
    applies to it.  Reads JSON only (no numpy, no torch), so that the
    thread counts can be set before those load."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"), "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise BenchError(f"{workload}: no config {cell['config']!r}")
    entry = configs[cell["config"]]
    config = _load_json(os.path.join(root, entry["file"]),
                        f"config {entry['name']}")
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      cell["traffic"] + ".json"),
                         f"traffic {cell['traffic']}")
    driver = os.path.join(bench_dir, "drivers", traffic["kind"] + ".py")
    metrics = {}
    for group in ("end_to_end", "per_layer"):
        metrics[group] = [m for m in bench[group] if _applies(m, workload)]
        for m in metrics[group]:
            m["_file"] = os.path.join(bench_dir, "metrics", m["name"] + ".py")
    for path in [driver] + [m["_file"] for g in metrics.values() for m in g]:
        if not os.path.isfile(path):
            raise BenchError(f"{workload}: missing {path}")
    return {"cell": cell, "config": config, "traffic": traffic,
            "driver": driver, "bench_dir": bench_dir,
            "chips": int(cell["chips"]), **metrics}


def thread_env(spec):
    """The environment variables of the configuration's host thread
    counts (set before numpy and torch load)."""
    threads = spec["config"].get("host_threads", {})
    return {k: str(threads[k]) for k in THREAD_ENV if k in threads}


def set_torch_threads(spec):
    import torch
    threads = spec["config"].get("host_threads", {})
    if "torch_intra_op" in threads:
        torch.set_num_threads(int(threads["torch_intra_op"]))
    if "torch_inter_op" in threads:
        try:
            torch.set_num_interop_threads(int(threads["torch_inter_op"]))
        except RuntimeError:
            pass        # set once per process (a test that runs twice)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared as whole names (libhm_tpu_torch is not libhm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def port_kernel_names():
    """Names of the program's CUDA kernels (__global__ functions of
    libhm_tpu_torch/csrc), as the device trace names them."""
    import libhm_tpu_torch
    csrc = os.path.join(os.path.dirname(libhm_tpu_torch.__file__), "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return names


def card(device):
    """The card's name (torch) and power limit (nvidia-smi)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={index}"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "power_limit": limit}


def seeded_rng(seed):
    import numpy as np
    return np.random.default_rng(seed % (1 << 64))


class Ctx:
    """What a driver sees: the device, the mix's parameters and the seeded
    generator."""

    def __init__(self, device, traffic, seed):
        self.device = device
        self.traffic = traffic
        self.rng = seeded_rng(seed)


class Run:
    """What a metric reader sees (see metrics/*.py)."""


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _read(bench_dir, rel):
    with open(os.path.join(bench_dir, rel), "rb") as f:
        return f.read()


def setup(spec, device, seed, t0):
    """Set-up, timed from t0: the program's builds, the card, one warm-up
    decode.  Returns (ctx, driver, data, notes)."""
    import torch
    notes = {}
    t = time.perf_counter()
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.kernels import build as kbuild
    notes["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    native_bridge.build()
    notes["parser_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        kbuild.library()
        torch.empty(1, device=device)
    notes["kernels_and_card_s"] = time.perf_counter() - t
    config, bench_dir = spec["config"], spec["bench_dir"]
    ctx = Ctx(device, spec["traffic"], seed)
    driver = load_module(spec["driver"], "hevc_bench_driver_" +
                         spec["traffic"]["kind"])
    data = _read(bench_dir, config["stream"])
    warm = config.get("warmup")
    if warm:
        t = time.perf_counter()
        files, _ = driver.decode(ctx, _read(bench_dir, warm["stream"]))
        _sync(device)
        notes["warmup_s"] = time.perf_counter() - t
        notes["warmup_checks"] = reference.compare(
            files, warm, {**config["geometry"], "width": warm["width"],
                          "height": warm["height"]})
    # which of its builds the parser chose to load (it times them)
    notes["parser_library"] = os.path.basename(
        getattr(native_bridge._LIB, "_name", None) or "not loaded")
    notes["setup_s"] = time.perf_counter() - t0
    return ctx, driver, data, notes


def window(ctx, driver, data, seconds, trace):
    """Requests back to back for `seconds`; the last one finishes.
    Returns the Run record, without the comparison."""
    import torch
    from libhm_tpu_torch.utils import xfer
    cuda = torch.device(ctx.device).type == "cuda"
    run = Run()
    run.spans, run.missing_targets, run.ops = [], [], []
    run.process_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    xfer.reset()
    gc.collect()
    recorder = prof = None
    if trace:
        import spans
        recorder = spans.Recorder()
        run.missing_targets = recorder.missing
    if cuda:        # every run: sm_ms_per_picture reads the device trace
        import devtrace
        prof = devtrace.Profile()
    run.files, run.extras, run.errors, run.calls_s = [], [], [], []
    start = prof.mark() if prof is not None else time.perf_counter()
    try:
        while (t := time.perf_counter()) - start < seconds:
            try:
                files, extras = driver.decode(ctx, data)
            except Exception:       # the program failed a request
                run.errors.append(traceback.format_exc())
                break
            run.files += files
            run.extras.append(extras)
            run.calls_s.append(time.perf_counter() - t)
        _sync(ctx.device)
        end = time.perf_counter()
    finally:
        if recorder is not None:
            recorder.unwrap()
            run.spans = recorder.spans
        if prof is not None:
            run.ops = prof.stop()
    run.t_start, run.t_end, run.window_s = start, end, end - start
    run.attempted = len(run.files) + len(run.errors)
    run.pictures = sum(len(f) for f in run.files)
    run.h2d_bytes, run.d2h_bytes = xfer.H2D, xfer.D2H
    run.peak_window_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    return run


def run_cell(spec, seed, seconds, trace, device, t0):
    """One run of the cell.  Returns (line, checks, notes): the result's
    JSON object, the numbers compared with their limits, and set-up
    notes for standard error."""
    set_torch_threads(spec)
    ctx, driver, data, notes = setup(spec, device, seed, t0)
    run = window(ctx, driver, data, seconds, trace)
    info = card(device)
    run.setup_s = notes["setup_s"]
    run.config, run.device_name = spec["config"], info["kind"]
    run.port_kernels = port_kernel_names()
    metrics = {}
    group = "per_layer" if trace else "end_to_end"
    for m in spec[group]:
        reader = load_module(m["_file"], "hevc_bench_metric_" + m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            notes.setdefault("metrics_not_read", []).append(m["name"])
    numbers = reference.compare(run.files, spec["config"]["reference"],
                                spec["config"]["geometry"])
    failed = len(run.errors) + numbers["files_wrong"]
    correct = bool(run.files) and not run.errors and \
        reference.within_limits(numbers)
    device_info = {"platform": info["platform"], "kind": info["kind"],
                   "count": spec["chips"],
                   "memory_peak_bytes": max(run.process_peak_bytes,
                                            run.peak_window_bytes),
                   "power_limit": info["power_limit"]}
    line = {"correct": correct, "attempted": run.attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace:
        import devtrace
        intervals = [(op.t0, op.t1) for op in run.ops]
        device_info["busy_s"] = devtrace.busy_seconds(intervals, run.t_start,
                                                      run.t_end)
        device_info["window_s"] = run.window_s
        idle = devtrace.gaps(intervals, run.t_start, run.t_end)
        line["breakdown"] = {
            "device_ops": devtrace.top_ops(run.ops),
            "idle_gaps": devtrace.idle_by_host(idle, run.spans)}
        if run.missing_targets:
            notes["span_targets_missing"] = run.missing_targets
    checks = {k: {"value": v, "limit": reference.LIMITS[k]}
              for k, v in numbers.items()}
    line["checks"] = checks
    notes.update(seed=seed, files=len(run.files), pictures=run.pictures,
                 window_s=run.window_s, calls_s=run.calls_s,
                 errors=run.errors[:2])
    return line, checks, notes
