"""One cell for a few seconds on the card, as the benchmark's command runs
it.  Marked cuda: skips, with its reason, where there is no card.

    python -m pytest hevc_bench/tests/test_hevcbench_cuda.py -q -m cuda
"""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

pytestmark = pytest.mark.cuda


def test_batch_cell_on_the_card(gpu):
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "main10_ra_1080p.batch", "--seed",
                        str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["sm_ms_per_picture"]["value"] > 0
    assert line["metrics"]["setup_s"]["value"] > 0
