"""The port's copies of the utility apps and of the CABAC statistics.

libhm_tpu_torch.apps.{annexb_bytecount, bitrate_targeting,
convert_bitdepth} and libhm_tpu_torch.hostdec.stats run the cases of
tests/test_utils.py that cover their sources, and give what the JAX
package's modules give on the same input: the same byte-count lines, the
same converted bytes and the same statistics tables.  The statistics wrap
the port's own parse (hostdec.cabac, residual, slicedec and Decoder, on
the host: Decoder's defaults parse="python", recon="numpy" need no card).
"""
import io
import json
import os

import numpy as np
import pytest

from libhm_tpu.apps import annexb_bytecount as J_bytecount
from libhm_tpu.apps import bitrate_targeting as J_bitrate
from libhm_tpu.apps import convert_bitdepth as J_convert
from libhm_tpu.hostdec import stats as J_stats
from libhm_tpu_torch.apps import annexb_bytecount, convert_bitdepth
from libhm_tpu_torch.apps import bitrate_targeting
from libhm_tpu_torch.hostdec import stats
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))

LOG = """\
POC    0 TId: 0 ( I-SLICE, nQP 32 QP 32 ) 100000 bits
POC    1 TId: 0 ( P-SLICE, nQP 33 QP 33 ) 4000 bits
POC    2 TId: 0 ( P-SLICE, nQP 34 QP 34 ) 2000 bits
POC    3 TId: 0 ( P-SLICE, nQP 33 QP 33 ) 6000 bits
"""


def _stream(name):
    return os.path.join(ROOT, "testdata", GOLD[name]["bitstream"])


def test_extract_bitrates_and_guess():
    rates = bitrate_targeting.extract_bitrates(LOG)
    assert rates == [5000.0, 2000.0]  # I-slice excluded, averaged per layer
    meta = bitrate_targeting.parse_meta_log("-LM0 1.0 -LM1 1.0;5000 2000\n")
    lms = bitrate_targeting.guess_lambda_modifiers(0.5, [4000.0, 1800.0],
                                                   meta)
    assert len(lms) == 2 and all(v > 0 for v in lms)
    # the dampening keeps the guess within a band around the previous value
    assert all(0.25 < v < 4.0 for v in lms)


# one meta-log point, two points, two points of which one layer repeats its
# LambdaModifier (the one-point rule again), and three points (the last two
# are used)
META = {"one": "-LM0 1.0 -LM1 1.0;5000 2000\n",
        "two": "-LM0 1.0 -LM1 1.0;5000 2000\n"
               "-LM0 0.8 -LM1 1.3;5600 1700\n",
        "repeat": "-LM0 1.0 -LM1 1.0;5000 2000\n"
                  "-LM0 1.0 -LM1 0.7;5000 2600\n",
        "three": "-LM0 1.0 -LM1 1.0 -LM2 1.0;5000 2000 900\n"
                 "-LM0 0.9 -LM1 1.2 -LM2 0.5;5300 1800 1400\n\n"
                 "-LM0 0.95 -LM1 1.1 -LM2 0.75;5150 1910 1050\n"}
TARGETS = {"one": [4000.0, 1800.0], "two": [5300.0, 1900.0],
           "repeat": [4200.0, 2300.0], "three": [5200.0, 1850.0, 1000.0]}


@pytest.mark.parametrize("name", list(META))
@pytest.mark.parametrize("adj", [0.5, 1.0])
def test_bitrate_targeting_equals_jax(name, adj):
    """parse_meta_log and guess_lambda_modifiers of the copy give the JAX
    package's numbers exactly, on one-, two- and three-point meta-logs;
    guess_lambda_modifier too, at three inter dampenings."""
    meta = bitrate_targeting.parse_meta_log(META[name])
    assert meta == J_bitrate.parse_meta_log(META[name])
    assert len(meta) == META[name].count(";")
    got = bitrate_targeting.guess_lambda_modifiers(adj, TARGETS[name], meta)
    assert got == J_bitrate.guess_lambda_modifiers(adj, TARGETS[name], meta)
    assert len(got) == len(TARGETS[name]) and all(v > 0 for v in got)
    pts = [(e[0][0], e[1][0]) for e in meta[-2:]]
    for damp in (1.0, 0.25, 3.0):
        assert bitrate_targeting.guess_lambda_modifier(
            adj, TARGETS[name][0], pts, damp) == \
            J_bitrate.guess_lambda_modifier(adj, TARGETS[name][0], pts, damp)


@pytest.mark.parametrize("frame_rate", [None, 30.0])
def test_extract_bitrates_equals_jax(frame_rate):
    """extract_bitrates of the copy equals the JAX package's, and both
    refuse a log whose QP indices have a gap."""
    got = bitrate_targeting.extract_bitrates(LOG, frame_rate)
    assert got == J_bitrate.extract_bitrates(LOG, frame_rate)
    assert got == [r * (frame_rate or 1.0) for r in (5000.0, 2000.0)]
    gap = LOG + "POC    4 TId: 0 ( B-SLICE, nQP 36 QP 36 ) 10 bits\n"
    for mod in (bitrate_targeting, J_bitrate):
        with pytest.raises(ValueError):
            mod.extract_bitrates(gap, frame_rate)


@pytest.mark.parametrize("argv,stdin", [
    (["extract"], LOG), (["guess", "0.5", "4000 1800"], META["one"]),
    (["guess", "1.0", "5300 1900"], META["two"]), ([], ""), (["x"], "")])
def test_bitrate_targeting_cli(argv, stdin, monkeypatch, capsys):
    """main reads the log on stdin and prints what the JAX package's main
    prints; with no or an unknown command it prints its usage and returns
    2."""
    outs = []
    for mod in (J_bitrate, bitrate_targeting):
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        assert mod.main(argv) == (0 if argv[:1] in (["extract"], ["guess"])
                                  else 2)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    want = {"extract": "5000 2000", "guess": "-LM0 "}.get(
        argv[0] if argv else None, "bitrate_targeting extract < enc.log")
    assert want in outs[1]


@pytest.mark.parametrize("name", ["intra_64x64", "tids4_ra_160x96"])
def test_annexb_bytecount_equals_jax(name, capsys):
    """The same lines as the JAX package's app, with SPS and PPS rows, and
    the bytes of every NAL unit type sum to the stream less its start
    codes."""
    assert J_bytecount.main([_stream(name)]) == 0
    want = capsys.readouterr().out
    assert annexb_bytecount.main([_stream(name)]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "SPS" in got and "PPS" in got
    data = open(_stream(name), "rb").read()
    nbytes = sum(int(line.split()[-1]) for line in got.splitlines())
    assert 0 < nbytes < len(data)


def _convert(mod, src, dst, d_in, d_out):
    assert mod.main(["-i", str(src), "-o", str(dst), "--in-depth",
                     str(d_in), "--out-depth", str(d_out)]) == 0
    return dst.read_bytes()


@pytest.mark.parametrize("depths", [(8, 10), (10, 8)])
def test_convert_bitdepth_equals_jax(depths, tmp_path):
    """Seeded random samples of the input depth: the port's file equals
    the JAX package's byte for byte; 8 -> 10 shifts each sample up by two
    bits, and converting back gives the input again where no bits were
    dropped (8 -> 10 -> 8) and the input rounded to its top eight bits
    where they were (10 -> 8 -> 10)."""
    d_in, d_out = depths
    rng = np.random.default_rng(5)
    dt = np.uint8 if d_in <= 8 else np.uint16
    src = tmp_path / "in.yuv"
    data = rng.integers(0, 1 << d_in, 3 * 64 * 48 // 2).astype(dt)
    data.tofile(src)
    outs = [_convert(mod, src, tmp_path / f"{mod.__name__}.yuv", d_in, d_out)
            for mod in (J_convert, convert_bitdepth)]
    assert outs[0] == outs[1]
    assert len(outs[1]) == data.size * (1 if d_out <= 8 else 2)
    back = np.frombuffer(_convert(
        convert_bitdepth, tmp_path / f"{convert_bitdepth.__name__}.yuv",
        tmp_path / "back.yuv", d_out, d_in), dt)
    if d_in < d_out:
        assert (np.frombuffer(outs[1], np.uint16) ==
                data.astype(np.uint16) << (d_out - d_in)).all()
        np.testing.assert_array_equal(back, data)
    else:
        s = d_in - d_out
        np.testing.assert_array_equal(
            back, np.minimum((data + (1 << (s - 1))) >> s,
                             (1 << d_out) - 1) << s)


def test_coding_statistics():
    data = open(_stream("intra_64x64"), "rb").read()
    table = stats.collect(data)
    assert table["__total__"]["bins"] > 1000
    assert "sig" in table and table["sig"]["bins"] > 0


@pytest.mark.parametrize("name", ["tids4_ra_160x96", "wpp_416x240",
                                  "tiles_832x480"])
def test_bit_statistics_exact(name):
    """Exact bit counts per syntax element whose total (NAL headers, start
    codes, emulation prevention, non-VCL payloads, slice headers and the
    per-engine CABAC init/rounding residue included) equals the stream's
    bytes x 8, with the residue at the scale of the 9-bit preload."""
    data = open(_stream(name), "rb").read()
    t = stats.collect_bits(data, per_component=True, per_tu_size=True)
    n_eng = t.pop("__n_engines__")
    total = t.pop("__total__")
    assert sum(t.values()) == total == len(data) * 8
    fudge = t["cabac_init_and_rounding"]
    assert 0 < fudge <= 32 * n_eng, (fudge, n_eng)
    # per-component and per-TU-size residual rows
    assert any(k.startswith("sig:") and ":c" in k for k in t)
    assert any(":n4" in k or ":n8" in k for k in t)


@pytest.mark.parametrize("name", ["intra_64x64", "tids4_ra_160x96"])
def test_statistics_equal_jax(name):
    """collect and collect_bits of the port's parse give the JAX package's
    tables, entry for entry."""
    data = open(_stream(name), "rb").read()
    assert stats.collect(data, per_component=True) == \
        J_stats.collect(data, per_component=True)
    got = stats.collect_bits(data, per_component=True, per_tu_size=True)
    assert got == J_stats.collect_bits(data, per_component=True,
                                       per_tu_size=True)
    assert got["__total__"] == len(data) * 8


@pytest.mark.parametrize("argv,want", [
    ([], "python -m libhm_tpu_torch.hostdec.stats"),
    (["{path}"], "TOTAL"),
    (["--bits", "{path}"], "TOTAL (== stream bits)")])
def test_statistics_cli(argv, want, capsys):
    """The usage names the port's module; both tables end with their
    total line, the bit table's equal to the stream's bits."""
    path = _stream("intra_64x64")
    rc = stats.main([a.format(path=path) for a in argv])
    assert rc == (0 if argv else 2)
    out = capsys.readouterr().out
    assert want in out
    if argv[:1] == ["--bits"]:
        last = out.strip().splitlines()[-1]
        bits = len(open(path, "rb").read()) * 8
        assert float(last.split()[-1]) == bits
