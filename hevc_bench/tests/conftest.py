"""Shared pieces of the benchmark's CPU tests.

    python -m pytest hevc_bench/tests -q              # on the CPU, ~3 min
    python -m pytest hevc_bench/tests -q -m cuda      # the card test

The cells run here at a size a test run holds: the configuration's
warm-up stream (the same coding tools at 416x240) takes the 1080p
stream's place, with HM's decode of it as the reference, on the CPU,
where the program runs the plain torch versions of its kernels.
"""
import os
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)

import harness  # noqa: E402

CELLS = ("main10_ra_1080p.batch", "main10_intra_1080p.batch")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips, with its reason, "
        "where torch.cuda.is_available() is false)")


def small(spec):
    """The spec with its configuration's warm-up stream as the stream."""
    c = spec["config"]
    w = c["warmup"]
    c["stream"] = w["stream"]
    c["reference"] = {"decoded_yuv_md5": w["decoded_yuv_md5"],
                      "frames": w["frames"]}
    c["geometry"] = {**c["geometry"], "width": w["width"],
                     "height": w["height"]}
    return spec


def small_spec(cell, root=ROOT, bench=BENCH):
    return small(harness.load_cell(root, bench, cell))


def run_small(spec, trace=False, seconds=0.1, seed=2 ** 31 + 5):
    """One run of `spec` on the CPU: (line, checks, notes)."""
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")
