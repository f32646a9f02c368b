"""Cells, configurations, traffic mixes and metrics are found by name, and
a new one is added as new files: a throwaway configuration, mix, driver
and metric dropped into a copy of the benchmark are found and run with
no file that is there edited (BENCHMARK.json lists them)."""
import hashlib
import json
import os
import shutil

import pytest

from conftest import BENCH, CELLS, ROOT, run_small, small
import harness


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads(cell):
    spec = harness.load_cell(ROOT, BENCH, cell)
    assert spec["cell"]["name"] == cell
    assert os.path.isfile(spec["driver"])
    assert {m["name"] for m in spec["end_to_end"]} == {
        "sm_ms_per_picture", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "decode_fps_traced", "parse_ms_per_picture",
        "host_prep_ms_per_picture", "h2d_mb_per_picture",
        "d2h_mb_per_picture", "kernel_ms_per_picture",
        "loopfilter_roofline_pct", "device_idle_pct", "peak_device_mb"}
    for stream in (spec["config"]["stream"],
                   spec["config"]["warmup"]["stream"]):
        assert os.path.isfile(os.path.join(BENCH, stream))


def test_unknown_names_refused():
    with pytest.raises(harness.BenchError):
        harness.load_cell(ROOT, BENCH, "no_such_cell")


def test_every_listed_file_is_under_paths():
    b = _bench()
    assert b["paths"] == ["hevc_bench"]
    for c in b["configs"]:
        assert c["file"].startswith("hevc_bench/")
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def _digests(tree):
    out = {}
    for d, _, files in os.walk(tree):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, tree)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_mix_driver_and_metric_are_new_files(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "hevc_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    b = _bench()
    before = _digests(bench)
    # the new files: a configuration, a traffic mix of a new kind with its
    # driver, and an end-to-end metric read only in the new cell
    ra = json.load(open(bench / "configs" / "main10_ra_1080p.json"))
    ra["name"] = "tiny_ra"
    (bench / "configs" / "tiny_ra.json").write_text(json.dumps(ra))
    (bench / "traffic" / "twice.json").write_text(json.dumps(
        {"kind": "batch_twice", "why": "two files a call"}))
    (bench / "drivers" / "batch_twice.py").write_text(
        "def decode(ctx, data):\n"
        "    from libhm_tpu_torch.parallel.dag_decode import decode_batch\n"
        "    f = [[list(p) for p in decode_batch(data, device=ctx.device)]]\n"
        "    return f + [[list(p) for p in decode_batch(data, "
        "device=ctx.device)]], {}\n")
    (bench / "metrics" / "files_delivered.py").write_text(
        "def read(run):\n    return float(len(run.files))\n")
    b["configs"].append({"name": "tiny_ra", "source": "test",
                         "file": "hevc_bench/configs/tiny_ra.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny_ra.twice", "config": "tiny_ra",
                           "traffic": "twice", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "files_delivered", "unit": "files",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny_ra.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = small(harness.load_cell(str(root), str(bench), "tiny_ra.twice"))
    line, _, _ = run_small(spec)
    assert line["correct"] is True
    assert line["metrics"]["files_delivered"]["value"] >= 2
    assert set(line["metrics"]) == {"setup_s", "files_delivered"}
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/tiny_ra.json", "traffic/twice.json",
        "drivers/batch_twice.py", "metrics/files_delivered.py"}
    # the cells that were there do not report the new metric
    old = harness.load_cell(str(root), str(bench), CELLS[0])
    assert "files_delivered" not in {m["name"] for m in old["end_to_end"]}

