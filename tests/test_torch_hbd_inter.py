"""Inter prediction at bit depths 8-16 in the port's host decoders, held
against K5/K6's plain versions and against the JAX decode.

- The numpy decoder's MC (`hostdec/motion.py`: `_interp`, which the port's
  encoder also predicts with, its default bi average `bi_average` and its
  weighted epilogues `_weighted_uni` / `_weighted_bi`) against
  `ops/interp.py`'s `predict`, `uni_round`, `bi_average`, `weighted_uni`
  and `weighted_bi` (what K5 and K6 compute), at bit depths 8, 10, 12,
  13, 14 and 16: seeded planes of samples up to 2^bd - 1 (2^15 and up at
  16 bits), blocks at and past the picture's edges, every fraction case
  (whole-sample, horizontal only, vertical only, both) with the luma
  8-tap filter and the chroma 4-tap one at 4:2:0 and 4:4:4 phases.  Both
  follow H.265 8.5.3.3.3.1 and 8.5.3.3.4.2-3: shift1 Min(4, bd - 8),
  shift2 6, shift3 Max(2, 14 - bd), the bi shift Max(3, 15 - bd).
- The two CPU proxies of the random-access streams at 13-16 bits
  (testdata/port_streams.json: mono16_ra_160x96, Monochrome 16;
  main14_ra_160x96, 14-bit 4:2:0 with explicit weighted prediction in
  its first coded video sequence) through the port's decode_batch, plane
  by plane against the JAX decode_batch, whose default bi average (15 -
  bd, version 1's shift) is replaced here by H.265's, as in
  tests/test_torch_hbd.py.
"""
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import interp as JI
from libhm_tpu.parallel import dag_decode as JD
from libhm_tpu_torch.hostdec import motion as HM
from libhm_tpu_torch.ops import interp as MK
from libhm_tpu_torch.parallel import dag_decode as DD

import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))
CPU = torch.device("cpu")
BDS = [8, 10, 12, 13, 14, 16]
# (taps, fbx, fby): luma quarter-pel, chroma eighth-pel (4:2:0) and
# chroma quarter-pel phases of an eighth-pel table (4:4:4)
FILTERS = [(8, 2, 2), (4, 3, 3), (4, 2, 2)]
H, W = 36, 44
SIZES = [(4, 4), (8, 4), (16, 8)]     # (w, h)
N = 12                                # blocks of a size, fraction case


def _blocks(rng, taps, fbx, fby, w, h):
    """N blocks of each fraction case: origins and MVs, some windows past
    the picture's edges."""
    out = []
    for hx in (False, True):
        for vy in (False, True):
            fx = rng.integers(1, 1 << fbx, N) if hx else np.zeros(N, int)
            fy = rng.integers(1, 1 << fby, N) if vy else np.zeros(N, int)
            x = rng.integers(-6, W - w + 6, N)
            y = rng.integers(-6, H - h + 6, N)
            mvx = (rng.integers(-4, 5, N) << fbx) + fx
            mvy = (rng.integers(-4, 5, N) << fby) + fy
            out.append((x, y, mvx, mvy))
    return [np.concatenate(a) for a in zip(*out)]


def _numpy_preds(plane, x, y, mvx, mvy, w, h, taps, fbx, fby, bd, last):
    ftab = HM.LUMA_FILTER if taps == 8 else HM.CHROMA_FILTER
    return np.stack([HM._interp(plane, int(x[i]), int(y[i]), w, h,
                                int(mvx[i]), int(mvy[i]), fbx, fby, taps,
                                ftab, bd, is_last=last)
                     for i in range(len(x))]).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bd", BDS)
def test_host_mc_equals_plain_versions(bd):
    rng = np.random.default_rng(1800 + bd)
    plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    if bd == 16:
        assert (plane >= 1 << 15).mean() > 0.4
    refs = _t(plane[None])
    for taps, fbx, fby in FILTERS:
        for w, h in SIZES:
            x, y, mvx, mvy = _blocks(rng, taps, fbx, fby, w, h)
            got = _numpy_preds(plane, x, y, mvx, mvy, w, h, taps, fbx, fby,
                               bd, False)
            want = MK.predict(refs, _t(np.zeros(len(x), np.int32)), _t(y),
                              _t(x), _t(mvx), _t(mvy), h, w, taps=taps,
                              fbx=fbx, fby=fby, bd=bd)
            what = f"{bd} bits, {taps} taps, {w}x{h}"
            np.testing.assert_array_equal(got, want.numpy(), err_msg=what)
            # uni-prediction: _interp's final samples, uni_round of the
            # 14-bit ones
            last = _numpy_preds(plane, x, y, mvx, mvy, w, h, taps, fbx, fby,
                                bd, True)
            np.testing.assert_array_equal(
                last, MK.uni_round(want.long(), bd).numpy(), err_msg=what)
            # default bi average of two lists
            q = rng.permutation(len(x))
            np.testing.assert_array_equal(
                HM.bi_average(got, got[q], bd),
                MK.bi_average(want.long(), want[q].long(), bd).numpy(),
                err_msg=what)
            assert last.max() <= (1 << bd) - 1 and last.min() >= 0


@pytest.mark.parametrize("bd", BDS)
def test_host_weighted_epilogues_equal_plain_versions(bd):
    """_weighted_uni and _weighted_bi on 14-bit intermediates over their
    whole range, weights and offsets at their syntax limits, denominators
    0-7, offsets shifted by bd - 8 and (high_precision_offsets) by 0."""
    rng = np.random.default_rng(1900 + bd)
    lo, hi = -(1 << 14), (1 << 14) + ((1 << bd) << HM.mc_headroom(bd))
    for hpo in (False, True):
        oshift = 0 if hpo else bd - 8
        orange = (1 << (bd - 1)) if hpo else 128
        for denom in range(8):
            p0, p1 = (rng.integers(lo, hi, (8, 8)) for _ in range(2))
            w = rng.integers(-128, 128, (2, 3))
            o = rng.integers(-orange, orange, (2, 3))
            c = int(rng.integers(0, 3))
            pu = SimpleNamespace(wp={"denom_l": denom, "denom_c": denom,
                                     "w": w.tolist(), "o": o.tolist()})
            off = o << oshift
            what = f"{bd} bits, denom {denom}, hpo {hpo}"
            for l, p in ((0, p0), (1, p1)):
                np.testing.assert_array_equal(
                    HM._weighted_uni(p, pu, l, c, bd, oshift),
                    MK.weighted_uni(_t(p), int(w[l, c]), int(off[l, c]),
                                    denom, bd).numpy(), err_msg=what)
            np.testing.assert_array_equal(
                HM._weighted_bi(p0, p1, pu, c, bd, oshift),
                MK.weighted_bi(_t(p0), _t(p1), int(w[0, c]), int(off[0, c]),
                               int(w[1, c]), int(off[1, c]), denom,
                               bd).numpy(), err_msg=what)


def test_bi_shift_is_version_1_up_to_12_bits_only():
    """H.265's Max(3, 15 - bd) is version 1's 15 - bd up to 12 bits."""
    for bd in range(8, 17):
        assert HM.mc_headroom(bd) + 1 == max(3, 15 - bd)
        assert (HM.mc_headroom(bd) + 1 == 15 - bd) == (bd <= 12)


def _spec_bi_average(p0, p1, bd):
    shift = max(3, 15 - bd)
    return jnp.clip((p0 + p1 + (1 << (shift - 1)) + 2 * JI.IF_OFFS) >> shift,
                    0, (1 << bd) - 1)


@pytest.fixture
def jax_spec_bi(monkeypatch):
    """The JAX package with H.265's default bi average, its jitted MC
    programs built afresh for it and dropped after."""
    fns = (JD._mc_scatter_fn, JD._mc_grid_fn, JD._mc_phase_grid_fn)
    for f in fns:
        f.cache_clear()
    monkeypatch.setattr(JI, "bi_average", _spec_bi_average)
    yield
    for f in fns:
        f.cache_clear()


@pytest.mark.parametrize("name", ["mono16_ra_160x96", "main14_ra_160x96"])
def test_proxy_decode_batch_equals_jax(name, jax_spec_bi):
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    data = open(os.path.join(ROOT, "testdata", PORT[name]["bitstream"]),
                "rb").read()
    outs = DD.decode_batch(data, device=CPU)
    want = jax_decode(data, parse="native")
    assert len(outs) == len(want) == PORT[name]["frames"]
    for pic_t, pic_j in zip(outs, want):
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
