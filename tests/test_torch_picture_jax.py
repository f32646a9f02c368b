"""The port's per-picture decode equals the JAX per-picture device programs
(queue B rows 14-16), exactly, on the CPU.

- row 14, `_scan_fn`: batch_decode._intra_batch with one picture against
  intra_wavefront.intra_reconstruct_tpu on picture 0 of intra_416x240,
  luma and one chroma component, from the same pre-intra planes and
  residuals;
- row 15, `_mc_fn`: dag_decode._inter_level (K5's plain version; K6's with
  weighted prediction) against TpuPictureRecon._inter_stage on one inter
  picture of randomaccess_main10_416x240 and of wp_lowdelayP_416x240, from
  the same reference planes; the residual planes against
  TpuPictureRecon._residual_planes on the way;
- row 15, `_deblock_v_fn` / `_deblock_cv_fn` / `_sao_fn` / `_sao_fn_multi`:
  device_filters.filter_level against deblock_picture_tpu +
  sao_picture_tpu on picture 0 of tiles_nolfcross_512x128 (the multi-slice
  SAO program) and of main12_intra_416x240 (12-bit chroma deblocking);
- end to end: the port's Decoder(recon="torch", device="cpu") against the
  JAX Decoder(recon="tpu") on tids4_ra_160x96, plane by plane; the JAX
  side runs in a child interpreter, because XLA's CPU backend can crash
  once enough programs pile up in one process (tests/test_recon_tpu.py);
- row 16, `_fused_recon_step`: entry.fused_recon_step (CPU: the plain
  versions) against the JAX step at 128x256 with 16 16x16 and 64 4x4
  blocks, and at 1088x1920 on inputs whose int32 sum wraps past 2^31.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def _collected(name):
    """The port's and the JAX package's collect items of one stream."""
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec_t = Decoder(parse="native", recon="collect")
    dec_t.decode_annexb(_data(name))
    dec_j = JaxDecoder(parse="native", recon="collect")
    dec_j.decode_annexb(_data(name))
    assert len(dec_t.collected) == len(dec_j.collected)
    return dec_t, dec_j


def _pre_filter(it):
    """One picture through the port's stages before the loop filters:
    residual (K1), PCM (K9), MC (K5/K6), intra (K2); plain versions."""
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.parallel import dag_decode as DD
    res = TB._residual_planes_batch_device([it], 1, CPU)
    stacked = [torch.zeros_like(r) for r in res]
    DD._pcm_level([it], stacked, CPU)
    DD._inter_level([it], stacked, res, CPU)
    for c in range(len(stacked)):
        stacked[c] = TB._intra_batch([it], c, stacked[c], res[c], CPU)
    return res, stacked


def test_row14_intra_picture_equals_scan_fn():
    from libhm_tpu.parallel.intra_wavefront import intra_reconstruct_tpu
    from libhm_tpu_torch.parallel import batch_decode as TB
    dec_t, dec_j = _collected("intra_416x240")
    it, ij = dec_t.collected[0], dec_j.collected[0]
    res = TB._residual_planes_batch_device([it], 1, CPU)
    res_np = [r[0].numpy() for r in res]
    for comp in (0, 2):
        got = TB._intra_batch([it], comp, torch.zeros_like(res[comp]),
                              res[comp], CPU)[0].numpy()
        want = np.zeros_like(res_np[comp])
        intra_reconstruct_tpu(ij["sps"], ij["pic"], ij["zmap"],
                              ij["tile_map"], comp, want, res_np,
                              bool(ij["pps"].constrained_intra_pred))
        assert want.any()
        assert np.array_equal(got, want), comp


@pytest.mark.parametrize("name", ["randomaccess_main10_416x240",
                                  "wp_lowdelayP_416x240"])
def test_row15_mc_picture_equals_mc_fn(name):
    """K5 plain (no WP) or K6 plain (WP) on the first inter picture in
    decode order, against _mc_fn through TpuPictureRecon._inter_stage,
    over the same references: the port's decode of the pictures before
    it."""
    from libhm_tpu.recon_tpu import TpuPictureRecon
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.parallel import dag_decode as DD
    dec_t, dec_j = _collected(name)
    k = next(i for i, it in enumerate(dec_t.collected)
             if it["pic"].inter_list)
    before = dec_t.collected[:k]
    assert {id(pu.ref_poc[l]) for pu in dec_t.collected[k]["pic"].inter_list
            for l in range(2) if pu.ref_poc[l] is not None} <= \
        {id(b["dp"]) for b in before}
    index = {id(b["dp"]): i for i, b in enumerate(before)}
    for dp, _, small in DD._recon_levels(before, [CPU]):
        dec_j.collected[index[id(dp)]]["dp"].planes = DD._download(small)
    it, ij = dec_t.collected[k], dec_j.collected[k]
    wp = any(getattr(pu, "wp", None) is not None
             for pu in it["pic"].inter_list)
    assert wp == (name == "wp_lowdelayP_416x240")
    rec = TpuPictureRecon(ij["sps"], ij["pic"], ij["zmap"], ij["tile_map"])
    res_j = rec._residual_planes()
    rec._inter_stage(res_j)
    res = TB._residual_planes_batch_device([it], 1, CPU)
    stacked = [torch.zeros_like(r) for r in res]
    n5, n6 = MK._K5.launches, MK._K6.launches
    DD._inter_level([it], stacked, res, CPU)
    assert (MK._K5.launches, MK._K6.launches) == (n5, n6)   # plain on CPU
    for c in range(3):
        assert np.array_equal(res[c][0].numpy(), res_j[c]), c
        assert rec.planes[c].any()
        assert np.array_equal(stacked[c][0].numpy(), rec.planes[c]), c


@pytest.mark.parametrize("name", ["tiles_nolfcross_512x128",
                                  "main12_intra_416x240"])
def test_row15_filters_equal_picture_programs(name):
    from libhm_tpu.recon_tpu import deblock_picture_tpu, sao_picture_tpu
    from libhm_tpu_torch.parallel.device_filters import (filter_level,
                                                         picture_filter_flags)
    dec_t, dec_j = _collected(name)
    it, ij = dec_t.collected[0], dec_j.collected[0]
    multi, restore, sao_on = picture_filter_flags([it])
    assert sao_on and not restore
    assert multi == (name == "tiles_nolfcross_512x128")
    assert (it["sps"].bit_depth_chroma == 12) == (name ==
                                                  "main12_intra_416x240")
    _, stacked = _pre_filter(it)
    planes = [s[0].numpy().copy() for s in stacked]
    got = filter_level([it], stacked, it["sps"], CPU)
    deblock_picture_tpu(planes, ij["pic"], ij["sps"], ij["pps"],
                        ij["tile_map"])
    sao_picture_tpu(planes, ij["pic"], ij["sps"], ij["pps"], ij["tile_map"])
    for c in range(3):
        assert np.array_equal(got[c][0].numpy(), planes[c]), c


_CHILD = """
import os, pickle, sys
if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {root!r})
from libhm_tpu.hostdec.decoder import Decoder
data = open({path!r}, "rb").read()
outs = Decoder(parse="native", recon="tpu").decode_annexb(data)
pickle.dump([list(pic) for pic in outs], open({out!r}, "wb"))
"""


def test_picture_decode_equals_jax_recon_tpu(tmp_path):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    name = "tids4_ra_160x96"
    out = str(tmp_path / "jax.pkl")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            root=ROOT, out=out,
            path=os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]))],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    want = pickle.load(open(out, "rb"))
    got = Decoder(parse="native", recon="torch",
                  device="cpu").decode_annexb(_data(name))
    assert len(got) == len(want) == GOLD[name]["frames"]
    for pic_t, pic_j in zip(got, want):
        assert len(pic_t) == len(pic_j) == 3
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def _fused_inputs(case):
    from libhm_tpu_torch import entry as E
    if case == "reduced":
        return E.make_inputs(H=128, W=256, nb16=16, nb4=64)
    # a near-white 1080p frame and 4096 DC-only 4x4 blocks at high QP:
    # the frame alone sums to ~2.13e9, the residuals push it past 2^31
    d = E.make_inputs(seed=1, H=1088, W=1920, nb16=16, nb4=4096)
    rng = np.random.RandomState(1)
    d["frame"] = rng.randint(1016, 1024, d["frame"].shape).astype(np.int32)
    d["coeffs4"][:] = 0
    d["coeffs4"][:, 0, 0] = rng.randint(1024, 2048, len(d["coeffs4"]))
    d["qp4"] = rng.randint(40, 63, len(d["qp4"])).astype(np.int32)
    return d


@pytest.mark.parametrize("case", ["reduced", "wraps"])
def test_row16_fused_step_equals_jax(case):
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _fused_recon_step
    # imported before the trace, as the JAX entry() does: imported under
    # it, their module-level jnp constants would hold tracers
    from libhm_tpu.ops import deblock, interp, sao  # noqa: F401
    from libhm_tpu.ops import transform as JT
    from libhm_tpu_torch import entry as E
    d = _fused_inputs(case)
    frame0 = d["frame"].copy()
    args = [d[k] for k in E.ARGS]
    s_j, f_j = jax.jit(_fused_recon_step)(*[jnp.asarray(a) for a in args])
    f_j = np.asarray(f_j)
    for fn in (E.fused_recon_step, E.fused_recon_step_plain):
        s_t, f_t = fn(*[torch.from_numpy(a) for a in args])
        assert s_t.dtype == torch.int32 and s_t.shape == ()
        assert int(s_t) == int(s_j)
        assert np.array_equal(f_t.numpy(), f_j)
        assert np.array_equal(d["frame"], frame0)   # inputs left as given
    assert not np.array_equal(f_j, frame0)
    r4 = np.asarray(JT.inverse_transform_batch(
        JT.dequant_batch(jnp.asarray(d["coeffs4"]), jnp.asarray(d["qp4"]),
                         10, 2), 4, True, 10))
    exact = int(f_j.astype(np.int64).sum() + r4.astype(np.int64).sum())
    assert (exact >= 1 << 31) == (case == "wraps")
    assert int(s_j) == (exact + (1 << 31)) % (1 << 32) - (1 << 31)
