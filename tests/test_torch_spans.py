"""The port's span recorder (libhm_tpu_torch/utils/obs.py) and the spans
of a real decode on the CPU.

The recorder: nesting gives each span its parent and request ids, and a
parent's duration holds its children's; the ring keeps CAPACITY entries
and counts the rest in `dropped`; enable(False) records nothing;
decode_streams' parse threads carry the call's request id.  The decode:
cip_ra_160x96 through decode_batch(device="cpu") records every stage
span under one `decode`, and the work the spans count equals the
program's own counts: TUs and intra blocks of the parse, bytes of
xfer.H2D and xfer.D2H.
"""
import os
import time

import pytest

from libhm_tpu_torch.hostdec import native_bridge
from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.parallel.dag_decode import (decode_batch, decode_streams,
                                                 reference_levels)
from libhm_tpu_torch.utils import obs, xfer
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = {"parse", "parse.native", "parse.export", "parse.control", "recon",
          "recon.level", "prep.residual", "prep.intra", "prep.inter",
          "prep.filter", "prep.pcm", "recon.narrow", "download"}


def _data(name):
    with open(os.path.join(ROOT, "testdata", name), "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def recorder():
    obs.reset()
    obs.enable(True)
    yield
    obs.enable(True)


def test_nesting_ids_and_self_time():
    with obs.request(n=2) as call:
        with obs.span("outer", 7):
            time.sleep(0.02)
            with obs.span("inner") as inner:
                time.sleep(0.01)
                inner.n = 3
        with obs.span("sibling"):
            pass
    with obs.span("alone"):
        pass
    by = {s.name: s for s in obs.spans()}
    assert [s.name for s in obs.spans()] == ["inner", "outer", "sibling",
                                            "decode", "alone"]
    assert by["decode"].parent is None and by["decode"].request == call.id
    assert by["outer"].parent == by["decode"].id
    assert by["sibling"].parent == by["decode"].id
    assert by["inner"].parent == by["outer"].id
    assert {by[k].request for k in ("outer", "inner", "sibling")} == \
        {by["decode"].request}
    assert by["alone"].parent is None and by["alone"].request is None
    assert (by["decode"].n, by["outer"].n, by["inner"].n) == (2, 7, 3)
    for child, parent in (("inner", "outer"), ("outer", "decode"),
                          ("sibling", "decode")):
        assert by[parent].t0 <= by[child].t0 <= by[child].t1 <= \
            by[parent].t1
    outer, inner = by["outer"], by["inner"]
    self_s = (outer.t1 - outer.t0) - (inner.t1 - inner.t0)
    assert inner.t1 - inner.t0 >= 0.01 and self_s >= 0.02
    # a window of time keeps the spans inside it
    assert [s.name for s in obs.spans(since=outer.t0, until=outer.t1)] == \
        ["inner", "outer"]


def test_ring_bound_and_dropped():
    for i in range(obs.CAPACITY + 10):
        with obs.span("s", i):
            pass
    kept = obs.spans()
    assert len(kept) == obs.CAPACITY and obs.dropped == 10
    assert kept[0].n == 10 and kept[-1].n == obs.CAPACITY + 9
    obs.reset()
    assert obs.spans() == [] and obs.dropped == 0


def test_disabled_records_nothing():
    obs.enable(False)
    with obs.request() as call, obs.span("x") as s:
        s.n = 5
    call.n = 1
    decode_batch(_data("intra_64x64.bin"), device="cpu")
    assert obs.spans() == []
    obs.enable(True)
    with obs.span("y"):
        pass
    assert [s.name for s in obs.spans()] == ["y"]


def test_stream_threads_carry_the_request():
    data = _data("intra_64x64.bin")
    outs = decode_streams([data, data], device="cpu", threads=2)
    spans = obs.spans()
    calls = [s for s in spans if s.name == "decode"]
    assert len(calls) == 1 and calls[0].n == sum(len(o) for o in outs)
    parses = [s for s in spans if s.name == "parse"]
    assert len(parses) == 2
    assert {s.request for s in parses} == {calls[0].request}
    assert {s.parent for s in parses} == {calls[0].id}
    assert all(s.request == calls[0].request for s in spans)


@pytest.fixture(scope="module")
def decoded():
    """(spans, H2D, D2H, pictures, parse) of one decode_batch of
    cip_ra_160x96 on the CPU, and the parse's own products."""
    data = _data("cip_ra_160x96.bin")
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    obs.reset()
    xfer.reset()
    outs = decode_batch(data, device="cpu")
    return obs.spans(), xfer.H2D, xfer.D2H, outs, dec.collected


def test_a_decode_records_every_stage(decoded):
    spans, _, _, outs, items = decoded
    calls = [s for s in spans if s.name == "decode"]
    assert len(calls) == 1 and calls[0].n == len(outs) == len(items)
    assert {s.request for s in spans} == {calls[0].request}
    names = {s.name for s in spans}
    assert STAGES <= names
    assert {"upload.coeff", "upload.intra_blocks", "upload.mc",
            "upload.filter"} <= names
    byid = {s.id: s for s in spans}
    for s in spans:
        if s.name != "decode":
            assert s.parent in byid
            p = byid[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    assert len(spans) <= 500


def test_span_counts_equal_the_program_counts(decoded):
    spans, h2d, d2h, outs, items = decoded

    def total(name):
        return sum(s.n for s in spans if s.name == name)

    assert total("prep.residual") == sum(len(it["pic"].tu_list)
                                         for it in items)
    assert total("prep.intra") == sum(len(it["pic"].intra_list)
                                      for it in items)
    assert total("prep.pcm") == sum(len(it["pic"].pcm_list) for it in items)
    assert sum(s.n for s in spans if s.name.startswith("upload.")) == h2d
    assert total("download") == d2h > 0
    assert total("parse.native") == total("parse.export") == len(items)
    assert total("recon") == total("recon.level") == len(items)


def test_the_parser_load_is_one_span(monkeypatch):
    native_bridge._load()
    monkeypatch.setattr(native_bridge, "_LIB", None)
    # the load without timing the two builds in subprocesses
    monkeypatch.setattr(native_bridge, "_pick_variant", lambda so: so)
    native_bridge._load()
    native_bridge._load()
    loads = [s for s in obs.spans() if s.name == "parser.load"]
    assert len(loads) == 1 and loads[0].t1 > loads[0].t0


def test_a_count_is_an_entry_of_no_duration():
    with obs.span("outer"):
        obs.count("inside", 5)
    obs.count("loose", 2)
    obs.enable(False)
    obs.count("off", 1)
    obs.enable(True)
    by = {s.name: s for s in obs.spans()}
    assert set(by) == {"outer", "inside", "loose"}
    inside, outer = by["inside"], by["outer"]
    assert inside.parent == outer.id and inside.n == 5
    assert outer.t0 <= inside.t0 == inside.t1 <= outer.t1
    assert by["loose"].parent is None and by["loose"].n == 2


def test_k2_records_each_launch(decoded):
    """Every K2 call is a span "k2" whose n is its blocks, holding the
    components it covers, each component's plane blocks (0 on the CPU,
    and no lattice width) and then each (picture, component) chain's
    levels and hand-overs, in that order; one call a DAG level covers
    every component with an intra block there."""
    spans, _, _, _, items = decoded
    k2 = [s for s in spans if s.name == "k2"]
    assert sum(s.n for s in k2) == sum(len(it["pic"].intra_list)
                                       for it in items)
    assert len(k2) == sum(any(it["pic"].intra_list for it in lv)
                          for lv in reference_levels(items))
    for s in k2:
        kids = sorted((c for c in spans if c.parent == s.id),
                      key=lambda c: c.id)
        names = [c.name for c in kids]
        comps = kids[0].n
        assert names[0] == "k2.components" and 1 <= comps <= 3
        assert names[1:1 + comps] == ["k2.plane_blocks"] * comps
        chains = (len(names) - 1 - comps) // 2
        assert chains >= comps
        assert names[1 + comps:] == ["k2.levels", "k2.handovers"] * chains
        assert all(c.n == 0 for c in kids[1:1 + comps])
        assert all(c.n >= 1 for c in kids[1 + comps::2])
        assert all(c.n >= 0 for c in kids[2 + comps::2])
        assert all(s.t0 <= c.t0 == c.t1 <= s.t1 for c in kids)
