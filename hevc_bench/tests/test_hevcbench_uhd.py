"""The UHD low-delay P cell (main10_ldp_4k.batch) and K2's two metrics.

- the cell loads with the end-to-end metrics and exactly its two
  per-layer metrics, intra_plane_block_pct and intra_chain_roofline_pct;
  the 1080p cells take the chain share too;
- its stream is a byte copy of testdata's, and its reference MD5 and
  picture count are HM's (testdata/golden.json);
- roofline_intra.py's chain bound of a 1080p luma launch (L 1730, R 16)
  is 1730 x 0.087 + 16 x 0.285 us;
- on synthetic spans: the launches of the window with their counts, the
  plane share, the chain share against the kernel's traced time; None
  where the program records no spans, and where the window holds no K2
  launch;
- the cell at the size a test run holds (its warm-up stream), traced, on
  the CPU: correct, the plane share read (0: the CPU has no lattice).
"""
import hashlib
import json
import os
from types import SimpleNamespace

import pytest

import devtrace
import harness
import program_spans
import roofline_intra
from conftest import BENCH, ROOT, run_small, small_spec

CELL = "main10_ldp_4k.batch"
NEW = {"intra_plane_block_pct", "intra_chain_roofline_pct"}


def reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "hevc_bench_metric_" + name)


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def test_the_cell_loads_with_its_metrics():
    spec = harness.load_cell(ROOT, BENCH, CELL)
    assert spec["chips"] == 1 and spec["traffic"]["kind"] == "batch"
    assert {m["name"] for m in spec["end_to_end"]} == {
        "sm_ms_per_picture", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == NEW
    for cell in ("main10_ra_1080p.batch", "main10_intra_1080p.batch"):
        names = {m["name"] for m in harness.load_cell(
            ROOT, BENCH, cell)["per_layer"]}
        assert "intra_chain_roofline_pct" in names
        assert "intra_plane_block_pct" not in names


def test_the_stream_and_reference_are_hms():
    config = harness.load_cell(ROOT, BENCH, CELL)["config"]
    gold = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
    entry = gold["lowdelayP_main10_4k"]
    assert _md5(os.path.join(BENCH, config["stream"])) == _md5(
        os.path.join(ROOT, "testdata", entry["bitstream"])) == \
        "db1eca20633bfe8eea22b936e9d1e673"
    assert config["reference"]["decoded_yuv_md5"] == \
        entry["decoded_yuv_md5"] == "53418d9e3f3fc2288b86f85a35ec843e"
    assert config["reference"]["frames"] == entry["frames"] == 3
    assert config["geometry"] == {"width": entry["w"], "height": entry["h"],
                                  "chroma_format": entry["chroma"],
                                  "bit_depth": entry["bitdepth"]}
    warm = config["warmup"]
    assert warm["decoded_yuv_md5"] == gold["randomaccess_main10_416x240"][
        "decoded_yuv_md5"]
    assert _md5(os.path.join(BENCH, warm["stream"])) == _md5(os.path.join(
        ROOT, "testdata", "randomaccess_main10_416x240.bin"))


def test_the_chain_bound_of_a_1080p_luma_launch():
    assert roofline_intra.launch_bound_us([(1730, 16)]) == \
        pytest.approx(155.07)
    # a launch takes its slowest picture's chain
    assert roofline_intra.launch_bound_us([(10, 0), (1730, 16), (5, 3)]) == \
        pytest.approx(155.07)
    assert roofline_intra.launch_bound_us([]) == 0.0


def span(id, name, t0, t1, parent=None, n=0):
    return SimpleNamespace(id=id, parent=parent, request=1, name=name,
                           t0=t0, t1=t1, thread=1, n=n)


# the window [10, 20] holds two launches (the second one of two pictures)
# and a third launch after it; a launch before the window
K2_SPANS = [
    span(1, "k2.lattice", 5.0, 5.0, parent=2, n=2800),
    span(2, "k2", 4.9, 5.1, n=50),
    span(3, "k2.lattice", 11.0, 11.0, parent=5, n=2800),
    span(4, "k2.plane_blocks", 11.0, 11.0, parent=5, n=25),
    span(6, "k2.levels", 11.0, 11.0, parent=5, n=1730),
    span(7, "k2.handovers", 11.0, 11.0, parent=5, n=16),
    span(5, "k2", 10.9, 11.1, parent=9, n=100),
    span(10, "k2.lattice", 12.0, 12.0, parent=14, n=960),
    span(11, "k2.plane_blocks", 12.0, 12.0, parent=14, n=0),
    span(12, "k2.levels", 12.0, 12.0, parent=14, n=10),
    span(13, "k2.handovers", 12.0, 12.0, parent=14, n=1),
    span(15, "k2.levels", 12.0, 12.0, parent=14, n=100),
    span(16, "k2.handovers", 12.0, 12.0, parent=14, n=2),
    span(14, "k2", 11.9, 12.1, parent=9, n=300),
    span(9, "decode", 10.5, 19.5, n=2),
    span(17, "k2", 21.0, 21.1, n=7),
]


def _run(monkeypatch, spans, ops=()):
    fake = SimpleNamespace(dropped=0, spans=lambda: list(spans))
    monkeypatch.setattr(program_spans, "_obs", lambda: fake)
    return SimpleNamespace(t_start=10.0, t_end=20.0, pictures=2,
                           ops=list(ops))


def test_the_launches_of_the_window(monkeypatch):
    run = _run(monkeypatch, K2_SPANS)
    assert roofline_intra.launches(run) == [
        {"blocks": 100, "plane_blocks": 25, "lattice": 2800,
         "chain": [(1730, 16)]},
        {"blocks": 300, "plane_blocks": 0, "lattice": 960,
         "chain": [(10, 1), (100, 2)]}]


def test_the_two_metrics_on_synthetic_spans(monkeypatch):
    ops = [devtrace.DeviceOp("intra_wavefront_kernel", "kernel", 11.0,
                             11.0 + 2e-3),
           devtrace.DeviceOp("intra_wavefront_kernel", "kernel", 12.0,
                             12.0 + 1e-3),
           devtrace.DeviceOp("loop_filter_kernel", "kernel", 12.5, 13.0)]
    run = _run(monkeypatch, K2_SPANS, ops)
    assert reader("intra_plane_block_pct").read(run) == \
        pytest.approx(100.0 * 25 / 400)
    bound_us = 1730 * 0.087 + 16 * 0.285 + 100 * 0.087 + 2 * 0.285
    assert reader("intra_chain_roofline_pct").read(run) == \
        pytest.approx(100.0 * bound_us * 1e-6 / 3e-3)


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_counters_or_launches(monkeypatch, name):
    ops = [devtrace.DeviceOp("intra_wavefront_kernel", "kernel", 11.0, 12.0)]
    # a program without the recorder
    monkeypatch.setattr(program_spans, "_obs", lambda: None)
    run = SimpleNamespace(t_start=10.0, t_end=20.0, pictures=2, ops=ops)
    assert reader(name).read(run) is None
    # a program that records spans but no K2 counts (a checkout from before
    # them), and a window without a K2 launch
    others = [span(2, "prep.intra", 11.0, 11.5, parent=1, n=300),
              span(1, "decode", 10.5, 19.5, n=2)]
    for spans in (others, others + [span(3, "k2", 21.0, 21.1, n=9)]):
        assert reader(name).read(_run(monkeypatch, spans, ops)) is None


def test_the_cell_small_traced_on_the_cpu():
    line, checks, notes = run_small(small_spec(CELL), trace=True)
    assert line["correct"] is True and not notes["errors"]
    assert line["metrics"]["intra_plane_block_pct"]["value"] == 0.0
    # the CPU has no device trace: no chain share
    assert "intra_chain_roofline_pct" in notes["metrics_not_read"]
