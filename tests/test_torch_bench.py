"""The port's benchmark harness on the CPU, against the JAX package.

- tools/bench_kernels_torch.py: its K1 table (N DCT TUs of n x n in one
  plane) through residual_table_plain equals JAX dequant_batch then
  inverse_transform_batch (libhm_tpu/ops/transform.py) at each TU's
  position, n = 4-32; its K6 rows (blocks of 8x8 and 16x16 as 4x4 rows
  with one MV) through mc_weighted_plain equal JAX mc_blocks
  (libhm_tpu/ops/interp.py) at each block's destination; its rows on the
  CPU carry counts and errors and no time;
- bench_torch.py's device child on the CPU over tids4_ra_160x96 prints
  every measurement line, its checksum equals cropped_checksum of the
  native decode and the JAX decode_batch_device's, and its checks are
  live: a wrong expected checksum gives device_checksum_ok false, a wrong
  golden MD5 gives no cuda_fps and a failing exit.
Seeded numpy inputs, exact equality.
"""
import importlib.util
import json
import os
import subprocess
import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import interp as JM
from libhm_tpu.ops import transform as JT
from libhm_tpu.parallel.dag_decode import decode_batch_device as \
    jax_decode_batch_device
from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.ops import interp as MK
from libhm_tpu_torch.ops import transform as TK
from libhm_tpu_torch.parallel.dag_decode import cropped_checksum
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch as BT  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "bench_kernels_torch", os.path.join(ROOT, "tools",
                                        "bench_kernels_torch.py"))
BK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(BK)

SMALL = "tids4_ra_160x96"
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))


@pytest.mark.parametrize("n", (4, 8, 16, 32))
def test_k1_table_equals_jax(n):
    N = 64
    rows, coeffs, shape = BK.k1_case(n, N, np.random.default_rng(n))
    plane = torch.zeros(shape, dtype=torch.int32)
    TK.residual_table_plain(plane, BK.k1_table(rows, coeffs, "cpu"))
    log2n = n.bit_length() - 1
    deq = jax.jit(partial(JT.dequant_batch, bit_depth=BK.BD,
                          log2_size=log2n))(
        jnp.asarray(coeffs.astype(np.int32)),
        jnp.full((N,), BK.QP, jnp.int32))
    want = np.asarray(jax.jit(partial(JT.inverse_transform_batch, n=n,
                                      use_dst=False, bit_depth=BK.BD))(deq))
    got = np.stack([plane[0, y:y + n, x:x + n].numpy()
                    for y, x in zip(rows["y"], rows["x"])])
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("blk", (8, 16))
def test_k6_rows_equal_jax(blk):
    N = 64
    refs, (sel, sx, sy, b, dx, dy), rows, B = BK.k6_case(
        blk, N, np.random.default_rng(blk))
    H, W = BK.H, BK.W
    stacked = torch.zeros((B, H, W), dtype=torch.int32)
    MK.mc_weighted_plain(stacked, torch.zeros_like(stacked),
                         torch.from_numpy(refs), torch.from_numpy(rows),
                         is_luma=True, sx=0, sy=0, bd=BK.BD, wp=False,
                         denom=0, W=W, H=H)
    i32 = lambda a: jnp.asarray(a.astype(np.int32))  # noqa: E731
    want = np.asarray(jax.jit(partial(
        JM.mc_blocks, blk=blk, taps=8, frac_bits_x=2, frac_bits_y=2,
        bd=BK.BD, is_last=True, W=W, H=H))(
        jnp.asarray(refs), i32(sel), i32(sx), i32(sy),
        jnp.full((N,), BK.MV_FRAC[0], jnp.int32),
        jnp.full((N,), BK.MV_FRAC[1], jnp.int32)))
    got = np.stack([stacked[p, y:y + blk, x:x + blk].numpy()
                    for p, y, x in zip(b, dy, dx)])
    np.testing.assert_array_equal(got, want)
    # the grid holds every block, and nothing else was written
    assert int((stacked != 0).sum()) <= N * blk * blk
    assert len(rows) == N * (blk // 4) ** 2


def test_kernel_rows_on_cpu():
    out = BK.measure("cpu", k1_shapes=((4, 32), (32, 4)),
                     k6_shapes=((8, 16),))
    assert [r["kernel"] for r in out] == ["K1 residual_table"] * 2 + \
        ["K6 mc_weighted"]
    assert (out[0]["bytes"], out[0]["ops"]) == BK.k1_work(4, 32)
    for r in out:
        assert r["max_abs_err"] == 0 and r["bytes"] > 0 and r["ops"] > 0
        assert r["ms"] is None and r["device_ms"] is None and \
            r["share"] is None
    assert BK.header("cpu").startswith("device: cpu")


CHILD = ["--name", SMALL, "--repeat", "2", "--runs", "1", "--streams", "2",
         "--device", "cpu", "--budget", "600"]


def test_device_child_on_cpu():
    """The child as bench_torch.py runs it: every line, checks passed."""
    data = open(os.path.join(ROOT, "testdata", GOLD[SMALL]["bitstream"]),
                "rb").read()
    native = cropped_checksum(Decoder(parse="native", recon="native")
                              .decode_annexb(data))
    child = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"),
         "--device-child", "--expect-csum", str(native)] + CHILD,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax_out = {}
    # the JAX decode (mostly its compiles) runs while the child decodes
    t = threading.Thread(target=lambda: jax_out.update(
        r=jax_decode_batch_device(data, parse="native")))
    t.start()
    out, err = child.communicate(timeout=300)
    t.join(timeout=300)
    assert child.returncode == 0, err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert [next(iter(ln)) for ln in lines] == [
        "device", "h2d_mbps", "device_compute_fps", "cuda_fps",
        "multistream_fps"]
    got = BT.merge_lines(out)
    assert got["device"] == "cpu" and got["h2d_mbps"] is None
    assert got["device_checksum_ok"] is True
    assert got["device_checksum"] == native == jax_out["r"][2]
    assert got["device_compute_frames"] == jax_out["r"][3] == 5
    assert got["cuda_frames"] == 10 and got["cuda_fps"] > 0
    assert got["h2d_mb_per_frame"] > 0 and got["d2h_mb_per_frame"] > 0
    assert list(got["multistream_fps"]) == ["2"]
    assert not any(k.startswith("skipped") for k in got)


def test_device_child_checks_are_live(tmp_path, monkeypatch, capsys):
    """A wrong expected checksum and a wrong golden MD5 are caught."""
    gold = dict(GOLD)
    gold[SMALL] = dict(GOLD[SMALL], decoded_yuv_md5="0" * 32)
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(gold))
    monkeypatch.setattr(BT, "GOLDEN", str(path))
    ok = BT.device_child(600, 1, name=SMALL, repeat=2, runs=1, streams="2",
                         device="cpu")
    got = BT.merge_lines(capsys.readouterr().out)
    assert ok is False
    assert got["device_checksum_ok"] is False
    assert "cuda_fps" not in got and "multistream_fps" not in got
    assert "not bit-exact" in got["skipped_cuda_full"]
