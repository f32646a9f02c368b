"""K1's flat TU table on the CPU: residual_tables and the plain table
function against the JAX package, and against the per-bucket wrapper.

- batch_decode.residual_tables + upload_tables + residual_table_plain
  give planes equal to JAX libhm_tpu/parallel/batch_decode.py
  _residual_planes_batch_device on real collect items of three streams:
  randomaccess_main10_416x240 (flat dequant, DST, transform skip),
  customsl_lowdelay_160x96 (scaling lists) and lossless_intra_416x240
  (bypass, rotation, RDPCM);
- the per-bucket wrapper (residual_scatter, one call per size, mode and
  bit depth) writes the same planes as the table;
- a level that mixes TUs of all four sizes and every mode builds one
  table per component, and its residual build uploads once (twice with
  scaling lists) and calls K1 once per component.

Integer arithmetic throughout: equality is exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.ops import transform as TK
from libhm_tpu_torch.parallel import batch_decode as TB
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")
# each stream, and the row flags its first pictures must hold
STREAMS = {"randomaccess_main10_416x240": TK.F_DST | TK.F_TSKIP,
           "customsl_lowdelay_160x96": TK.F_SCALED,
           "lossless_intra_416x240": TK.F_BYPASS | TK.F_ROTATE}


def _items(name, parse="native"):
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse=parse, recon="collect")
    dec.decode_annexb(data)
    return dec.collected


def _planes(items):
    sps = items[0]["sps"]
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    return [torch.zeros((len(items), Hp >> (sh and sps.chroma_shift_y()),
                         Wp >> (sh and sps.chroma_shift_x())),
                        dtype=torch.int32) for sh in range(3)]


def _table_planes(items):
    tables, lists = TB.residual_tables(items)
    mats = TB._MatrixTable(lists, CPU).tables
    planes = _planes(items)
    for p, t in zip(planes, TB.upload_tables(tables, CPU)):
        TK.residual_table_plain(p, t, mats)
    return planes, tables, mats


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_table_plain_equals_jax(name):
    """residual_tables -> residual_table_plain == the JAX planes."""
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu.parallel import batch_decode as JB
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = JaxDecoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected[:3]
    got, tables, _ = _table_planes(items)
    flags = 0
    for rows, coeffs, counts, fl in tables:
        assert list(rows["log2n"]) == sorted(rows["log2n"])
        assert counts == tuple(int((rows["log2n"] == l).sum())
                               for l in range(2, 6))
        assert (rows["off"] % 16 == 0).all() and coeffs.dtype == np.int16
        flags |= fl
    assert flags & STREAMS[name] == STREAMS[name], bin(flags)
    want = JB._residual_planes_batch_device(items, len(items))
    assert len(want) == 3
    for w, g in zip(want, got):
        assert np.asarray(w).any()
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_per_bucket_wrapper_equals_table(name):
    """residual_scatter over the table's rows split into buckets writes
    the planes of the one-table path."""
    items = _items(name)[:3]
    want, tables, mats = _table_planes(items)
    for (rows, coeffs, _, _), plane, ref in zip(tables, _planes(items),
                                                want):
        key = rows["log2n"].astype(np.int64) | \
            rows["flags"].astype(np.int64) << 3 | \
            rows["bd"].astype(np.int64) << 8
        for k in np.unique(key):
            r = rows[key == k]
            n, fl = 1 << int(r["log2n"][0]), int(r["flags"][0])
            scaled = bool(fl & TK.F_SCALED)
            TK.residual_scatter(
                plane, torch.from_numpy(np.stack(
                    [coeffs[o:o + n * n] for o in r["off"]])
                    .reshape(-1, n, n)),
                torch.from_numpy(r["qp"].copy()),
                *(torch.from_numpy(r[f].astype(np.int32))
                  for f in ("b", "y", "x")),
                n=n, use_dst=bool(fl & TK.F_DST),
                tskip=bool(fl & TK.F_TSKIP), bd=int(r["bd"][0]),
                bypass=bool(fl & TK.F_BYPASS), rotate=bool(fl & TK.F_ROTATE),
                mats=mats[n] if scaled else None,
                midx=torch.from_numpy(r["midx"].copy()) if scaled else None,
                rdpcm=torch.from_numpy(r["rdpcm"].astype(np.int8)))
        assert torch.equal(plane, ref)


def test_mixed_level_builds_one_table_per_component(monkeypatch):
    """TUs of all four sizes and every mode in one level: one table per
    component; the level's residual build uploads its tables in one
    buffer (and the scaling matrices in one more) and calls K1 once per
    component."""
    items = _items("lossless_intra_416x240")[:1] + \
        _items("customsl_lowdelay_160x96")[:2] + \
        _items("randomaccess_main10_416x240")[:2]
    tables, lists = TB.residual_tables(items)
    assert len(tables) == 3 and len(lists) == 1
    every = TK.F_DST | TK.F_TSKIP | TK.F_BYPASS | TK.F_ROTATE | TK.F_SCALED
    assert tables[0][3] == every
    assert all(c > 0 for c in tables[0][2])               # all four sizes
    assert any((rows["rdpcm"] > 0).any() for rows, _, _, _ in tables)
    ups, calls = [], []
    real_up, real_k1 = TB.xfer.up, TK.residual_table
    monkeypatch.setattr(TB.xfer, "up",
                        lambda a, tag, dev: ups.append(tag) or
                        real_up(a, tag, dev))
    monkeypatch.setattr(TK, "residual_table",
                        lambda p, t, m=None, r=None: calls.append(t.counts)
                        or real_k1(p, t, m, r))
    level = _items("customsl_lowdelay_160x96")[:3]
    TB._residual_planes_batch_device(level, len(level), CPU)
    assert ups == ["coeff", "coeff"] and len(calls) == 3
