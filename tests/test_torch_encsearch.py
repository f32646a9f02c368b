"""The port's native motion search (libhm_tpu_torch/hostdec/native/
encsearch.cpp) against the Python search it mirrors, at 8-16 bits
(ROADMAP C14):

- `enc_interp_luma32`, the int32 form of the luma qpel interpolator,
  equals hostdec/motion.py `_interp` for all 16 phases, is_last both ways,
  at bit depths 8, 10, 12, 13, 14, 15 and 16, on planes of 0/max noise;
  the int16 `enc_interp_luma` equals it at 8-12 bits, and differs on the
  same planes from 13 bits on, where the first stage passes 2^15;
- during a random-access encode at 13, 14, 15 and 16 bits of pictures
  with hard edges (tests/enc_cases.py `edge_frames`), sampled native
  results of `_motion_search_rect` and `_bi_window_search` (MV and
  distortion) equal the Python path's on the same encoder state (the
  sampling of tests/test_encsearch.py::test_me_search_matches_python),
  and the stream decodes with every hash SEI OK.
"""
import ctypes as ct

import numpy as np
import pytest
import torch

from libhm_tpu_torch.encoder import encoder as ENC
from libhm_tpu_torch.hostdec.motion import LUMA_FILTER, _interp
from libhm_tpu_torch.hostdec.native_bridge import try_load

import enc_cases as E
import torch_threads  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lib():
    lib = try_load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


# (x, y, w, h) of the blocks: inside the plane (the int16 form's AVX2 rows)
# and across its edges (clamped gathers)
BLOCKS = [(16, 12, 16, 16), (4, 28, 8, 4), (-3, -2, 8, 8), (58, 42, 8, 8)]


def _interp_cases(bd, seed):
    """(plane, [(x, y, w, h, mvx, mvy, is_last, want)]) of a 48x64 plane of
    seeded 0/max noise: every block of BLOCKS at every qpel phase, its
    whole-sample part seeded, through _interp."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 2, (48, 64)).astype(np.int32) * ((1 << bd) - 1)
    cases = []
    for x, y, w, h in BLOCKS:
        for fy in range(4):
            for fx in range(4):
                mvx = 4 * int(rng.integers(-3, 4)) + fx
                mvy = 4 * int(rng.integers(-3, 4)) + fy
                for is_last in (True, False):
                    want = _interp(plane, x, y, w, h, mvx, mvy, 2, 2, 8,
                                   LUMA_FILTER, bd, is_last=is_last)
                    cases.append((x, y, w, h, mvx, mvy, is_last, want))
    return plane, cases


def _native(fn, plane, dtype, case, bd):
    x, y, w, h, mvx, mvy, is_last, _ = case
    p = np.ascontiguousarray(plane, dtype)
    dst = np.empty((h, w), dtype)
    fn(p.ctypes.data_as(ct.c_void_p), p.shape[1], p.shape[0], p.shape[1],
       x, y, w, h, mvx, mvy, bd, 1 if is_last else 0,
       dst.ctypes.data_as(ct.c_void_p))
    return dst.astype(np.int64)


@pytest.mark.parametrize("bd", [8, 10, 12, 13, 14, 15, 16])
def test_interp_luma32_matches_interp(lib, bd):
    plane, cases = _interp_cases(bd, seed=bd)
    for case in cases:
        got = _native(lib.enc_interp_luma32, plane, np.int32, case, bd)
        assert (got == case[-1]).all(), (bd, case[:7])


@pytest.mark.parametrize("bd", [8, 10, 12, 13, 14, 15, 16])
def test_interp_luma16_up_to_12_bits(lib, bd):
    """The int16 form equals _interp up to 12 bits; above, the same planes
    carry intermediates past 2^15, so it differs on some cases (what the
    int32 form is for)."""
    plane, cases = _interp_cases(bd, seed=bd)
    wrong = sum(not (_native(lib.enc_interp_luma, plane, np.int16, case,
                             bd) == case[-1]).all() for case in cases)
    assert wrong == 0 if bd <= 12 else wrong > 0, (bd, wrong, len(cases))


def _sampled(lib, counts, name, every, R):
    """A wrapper of IntraEncoder.`name` that recomputes every `every`-th
    call (from the first, at most 25) on the Python path, on the same
    encoder state, and asserts the two results equal.  It also checks each
    of _bi_window_search's calls (at most 25) whose window is centred past
    the search range R, where the MV drifted over repeated template
    passes."""
    real = getattr(ENC.IntraEncoder, name)

    def run(self, *a, **k):
        res = real(self, *a, **k)
        counts[name] += 1
        past = name == "_bi_window_search" and \
            max(abs(a[5][0] >> 2), abs(a[5][1] >> 2)) > R
        if past and counts["past_checked"] < 25:
            counts["past_checked"] += 1
        elif not (counts[name] % every == 1 and
                  counts[name + "_checked"] < 25):
            return res
        else:
            counts[name + "_checked"] += 1
        ENC.IntraEncoder._ENC_NATIVE = (None,)
        try:
            want = real(self, *a, **k)
        finally:
            ENC.IntraEncoder._ENC_NATIVE = (lib,)
        assert res == want, (name, a)
        return res
    return run


@pytest.mark.parametrize("bd,R", [(13, 8), (14, 8), (15, 8), (16, 8),
                                  (16, 2)])
def test_search_matches_python(lib, bd, R, monkeypatch):
    counts = dict.fromkeys(("_motion_search_rect", "_bi_window_search",
                            "_motion_search_rect_checked",
                            "_bi_window_search_checked", "past_checked"), 0)
    for name in ("_motion_search_rect", "_bi_window_search"):
        monkeypatch.setattr(ENC.IntraEncoder, name,
                            _sampled(lib, counts, name, 37, R))
    monkeypatch.setattr(ENC.IntraEncoder, "_ENC_NATIVE", (lib,))
    cfg = ENC.EncoderConfig(64, 48, qp=27, gop="randomaccess", bit_depth=bd,
                            search_range=R)
    enc = ENC.IntraEncoder(cfg, device=CPU)
    data = enc.encode_stream(E.edge_frames(64, 48, 3, bd=bd, seed=bd))
    assert counts["_motion_search_rect_checked"] >= 10, counts
    assert counts["_bi_window_search_checked"] >= 10, counts
    if R == 2:
        assert counts["past_checked"] >= 5, counts
    outs, statuses = E.decode_statuses(data, CPU)
    assert len(outs) == 3 and statuses == ["OK"] * 3
