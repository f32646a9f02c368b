"""The result's last line: its keys, in the contract's order, the numbers
compared beside their limits as the line's last key and as the last
lines of standard error, and the exit status without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, run_small, small, small_spec
import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def lines():
    spec = small_spec("main10_ra_1080p.batch")
    return {trace: run_small(spec, trace=trace)[0] for trace in (0, 1)}


def test_untraced_line(lines):
    line = lines[0]
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # sm_ms_per_picture reads the card's trace: not read on the CPU
    assert set(line["metrics"]) == {"setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert DEVICE_KEYS <= set(line["device"])
    assert line["checks"] == {"files_wrong": {"value": 0, "limit": 0},
                              "pictures_missing": {"value": 0, "limit": 0}}


def test_traced_line(lines):
    line = lines[1]
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # the host's own metrics are read on the CPU too; the device's are not
    assert {"decode_fps_traced", "parse_ms_per_picture",
            "host_prep_ms_per_picture", "h2d_mb_per_picture",
            "d2h_mb_per_picture"} <= \
        set(line["metrics"])
    assert "loopfilter_roofline_pct" not in line["metrics"]


def test_main_prints_checks_last(monkeypatch, capsys):
    """run.main with the card check satisfied and the run moved to the
    CPU: the JSON line is the last line of standard output, the checks
    the last lines of standard error."""
    import run
    real = harness.run_cell

    def on_cpu(spec, seed, seconds, trace, device, t0):
        return real(small(spec), seed, 0.1, trace, "cpu", t0)

    for k in harness.THREAD_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    rc = run.main(["--workload", "main10_intra_1080p.batch", "--seed",
                   str(2 ** 31 + 99), "--seconds", "45", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-2:] == [
        "check files_wrong 0 limit 0", "check pictures_missing 0 limit 0"]


def test_no_card_no_result():
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "main10_ra_1080p.batch", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs 1 CUDA device" in r.stderr


def test_unknown_cell_exits_without_result():
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "nope", "--seed", "1", "--seconds",
                        "1"], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 2 and r.stdout.strip() == ""
