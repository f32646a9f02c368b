"""Timing on the card, and what the card is: the helpers that chip_smoke.py,
bench_torch.py and tools/bench_kernels_torch.py share.

Numbers from these helpers are device numbers only when the work ran on
a card; each caller names the card beside them (card_name).
"""
import subprocess

import torch

# Hopper's SM has 64 INT32 lanes beside its 128 FP32 lanes (NVIDIA H100
# Tensor Core GPU Architecture white paper): the data sheet's 67 TFLOP/s
# float32 rate is no bound for integer work
INT32_LANES_PER_SM = 64


def _smi(query, device=0):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         f"--id={device}"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_name(device=0):
    """The card's name and power limit, as nvidia-smi reports them."""
    return _smi("name,power.limit", device)


def int32_ops_per_s(device=0):
    """The card's int32 rate: INT32 lanes x 2 (a multiply-add counts two
    operations, as the repo's operation counts do) x SMs
    (multi_processor_count) x the maximum SM clock (nvidia-smi
    clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(_smi("clocks.max.sm", device).split()[0])
    return INT32_LANES_PER_SM * 2 * sms * mhz * 1e6


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over `reps` runs (warmed)."""
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


def device_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` runs queued behind a
    sleeping kernel (~0.5 ms a run), so that the host enqueues them all
    before the first starts: for launches shorter than their enqueue,
    which cuda_ms would time at the host's rate."""
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
