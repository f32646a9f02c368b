"""The readers of the program's own spans (program_spans.py and the six
metrics that read it) on synthetic runs: the window's spans, self time
less the union of the children, work items from the spans' counts, the
set-up span before the window, idle time put down to stages, and no
number where the program has no recorder or lost a span of the window."""
import os
from types import SimpleNamespace

import pytest

import devtrace
import harness
import program_spans
from conftest import BENCH


def span(id, name, t0, t1, parent=None, n=0, request=1):
    return SimpleNamespace(id=id, parent=parent, request=request, name=name,
                           t0=t0, t1=t1, thread=1, n=n)


def reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "hevc_bench_metric_" + name)


# one call in the window [10, 20]: a parse with its three parts, a level
# whose intra prep (two components) holds an upload, and a download; the
# load of the parser before the window, and a span after it
SPANS = [
    span(1, "parser.load", 1.0, 1.5, request=None),
    span(3, "parse.native", 11.0, 11.5, parent=2, n=4),
    span(4, "parse.export", 11.5, 13.5, parent=2, n=4),
    span(5, "parse.control", 13.5, 14.0, parent=2, n=9),
    span(2, "parse", 11.0, 14.5, parent=9),
    span(8, "upload.intra_blocks", 15.0, 15.5, parent=7, n=1000),
    span(7, "prep.intra", 14.6, 16.6, parent=6, n=300),
    span(10, "prep.intra", 16.6, 16.9, parent=6, n=100),
    span(11, "prep.residual", 16.9, 17.1, parent=6, n=400),
    span(6, "recon.level", 14.6, 18.0, parent=9, n=4),
    span(12, "download", 18.0, 19.0, parent=9, n=2000),
    span(9, "decode", 10.5, 19.5, n=4),
    span(13, "parse", 21.0, 22.0, request=2),
]


@pytest.fixture
def run(monkeypatch):
    fake = SimpleNamespace(dropped=0, spans=lambda: list(SPANS))
    monkeypatch.setattr(program_spans, "_obs", lambda: fake)
    # the card idles in [10.5, 12] and [17.5, 19.5] inside the call
    ops = [devtrace.DeviceOp("k", "kernel", 12.0, 17.5)]
    return SimpleNamespace(t_start=10.0, t_end=20.0, pictures=4, ops=ops,
                           obs=fake)


def test_the_window_and_self_time(run):
    inside = program_spans.recorded(run)
    assert [s.id for s in inside] == [3, 4, 5, 2, 8, 7, 10, 11, 6, 12, 9]
    assert [s.id for s in program_spans.recorded(run, before=True)] == [1]
    assert program_spans.self_seconds(inside, "parse") == pytest.approx(0.5)
    assert program_spans.self_seconds(inside, "prep.intra") == \
        pytest.approx(1.5 + 0.3)
    assert program_spans.self_seconds(inside, "recon.level") == \
        pytest.approx(3.4 - 2.5)


def test_overlapping_children_count_once():
    spans = [span(1, "decode", 0.0, 10.0), span(2, "parse", 1.0, 5.0, 1),
             span(3, "parse", 2.0, 6.0, 1), span(4, "recon", 8.0, 9.0, 1)]
    assert program_spans.self_seconds(spans, "decode") == pytest.approx(4.0)
    assert program_spans.intersect([(0, 2), (3, 5)], [(1, 4)]) == \
        [(1, 2), (3, 4)]


@pytest.mark.parametrize("metric,value", [
    ("parse_native_ms_per_picture", 1e3 * 0.5 / 4),
    ("parse_export_ms_per_picture", 1e3 * 2.0 / 4),
    ("intra_prep_us_per_block", 1e6 * 1.8 / 400),
    ("residual_prep_us_per_tu", 1e6 * 0.2 / 400),
    ("parser_load_s", 0.5),
    # idle inside the call: [10.5, 12] and [17.5, 19.5], 3.5 s; the
    # stages cover [11, 12] of the first and [18, 19] of the second
    ("idle_unattributed_pct", 100.0 * (0.5 + 0.5 + 0.5) / 3.5),
])
def test_readers(run, metric, value):
    assert reader(metric).read(run) == pytest.approx(value)


@pytest.mark.parametrize("metric", [
    "parse_native_ms_per_picture", "parse_export_ms_per_picture",
    "intra_prep_us_per_block", "residual_prep_us_per_tu", "parser_load_s",
    "idle_unattributed_pct"])
def test_no_number_without_the_spans(run, monkeypatch, metric):
    read = reader(metric).read
    # a ring that pushed out a span that ended in the window
    run.obs.dropped = 3
    monkeypatch.setattr(run.obs, "spans", lambda: SPANS[4:])
    assert read(run) is None
    # a ring that dropped only spans from before the window reads
    monkeypatch.setattr(run.obs, "spans", lambda: SPANS)
    assert read(run) is not None
    # a program without the recorder (the parent of this benchmark change)
    monkeypatch.setattr(program_spans, "_obs", lambda: None)
    assert read(run) is None


def test_no_number_from_an_empty_window(run):
    run.t_start, run.t_end = 30.0, 40.0
    for metric in ("parse_native_ms_per_picture", "intra_prep_us_per_block",
                   "idle_unattributed_pct"):
        assert reader(metric).read(run) is None
    run.pictures = 0
    assert reader("parse_export_ms_per_picture").read(run) is None

