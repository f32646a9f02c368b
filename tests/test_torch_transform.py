"""Port parity: libhm_tpu_torch.ops.transform vs libhm_tpu.ops.transform.

Same numpy-seeded integers through the JAX function and the port's plain
torch version; all arithmetic is integer, so equality is exact (tolerance
0).  Each JAX function runs as one jitted program per case: the XLA CPU
JIT is kept to few programs per process (see test_recon_tpu.py).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libhm_tpu.ops import transform as JT
from libhm_tpu_torch.ops import transform as TT
from libhm_tpu_torch import recon_torch
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    assert (a == b).all(), int((a != b).sum())


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("bd", [8, 10])
def test_dequant(log2, bd):
    n = 1 << log2
    rng = np.random.RandomState(100 * log2 + bd)
    coeffs = rng.randint(-32768, 32768, size=(17, n, n)).astype(np.int32)
    qps = rng.randint(0, 52 + 6 * (bd - 8), size=(17,)).astype(np.int32)
    fn = jax.jit(functools.partial(JT.dequant_batch, bit_depth=bd,
                                   log2_size=log2))
    _eq(fn(jnp.asarray(coeffs), jnp.asarray(qps)),
        TT.dequant_batch(torch.from_numpy(coeffs), torch.from_numpy(qps), bd,
                         log2))


@pytest.mark.parametrize("n,use_dst", [(4, False), (4, True), (8, False),
                                       (16, False), (32, False)])
@pytest.mark.parametrize("bd", [8, 10])
def test_inverse_transform(n, use_dst, bd):
    rng = np.random.RandomState(n * bd + use_dst)
    coeffs = rng.randint(-32768, 32768, size=(13, n, n)).astype(np.int32)
    fn = jax.jit(functools.partial(JT.inverse_transform_batch, n=n,
                                   use_dst=use_dst, bit_depth=bd))
    _eq(fn(jnp.asarray(coeffs)),
        TT.inverse_transform_batch(torch.from_numpy(coeffs), n, use_dst, bd))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("bd", [8, 10])
def test_transform_skip(log2, bd):
    n = 1 << log2
    rng = np.random.RandomState(7 * log2 + bd)
    coeffs = rng.randint(-32768, 32768, size=(9, n, n)).astype(np.int32)
    fn = jax.jit(functools.partial(JT.inverse_transform_skip_batch,
                                   bit_depth=bd, log2_size=log2))
    _eq(fn(jnp.asarray(coeffs)),
        TT.inverse_transform_skip_batch(torch.from_numpy(coeffs), bd, log2))


def test_inverse_rdpcm():
    rng = np.random.RandomState(11)
    res = rng.randint(-32768, 32768, size=(9, 8, 8)).astype(np.int32)
    modes = np.array([0, 1, 2, 1, 0, 2, 2, 1, 0], np.int32)
    _eq(jax.jit(JT.inverse_rdpcm_batch)(jnp.asarray(res), jnp.asarray(modes)),
        TT.inverse_rdpcm_batch(torch.from_numpy(res), torch.from_numpy(modes)))


@pytest.mark.parametrize("n,use_dst,path", [(4, True, "itx"),
                                            (4, True, "tskip"),
                                            (8, False, "itx"),
                                            (32, False, "itx")])
def test_residual_fn_composition(n, use_dst, path):
    """recon_torch._residual_fn == recon_tpu._residual_fn (dequant + ITX or
    transform skip + RDPCM) at Main10."""
    from libhm_tpu.recon_tpu import _residual_fn
    rng = np.random.RandomState(n + len(path))
    P = 16
    coeffs = rng.randint(-3000, 3000, size=(P, n, n)).astype(np.int32)
    qp = rng.randint(0, 64, size=P).astype(np.int32)
    rdpcm = np.zeros(P, np.int32)
    mat = np.zeros((1, 1, 1), np.int32)
    want = _residual_fn(n, use_dst, path, 10, 15, False)(
        jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(rdpcm),
        jnp.asarray(mat))
    got = recon_torch._residual_fn(
        torch.from_numpy(coeffs), torch.from_numpy(qp),
        torch.from_numpy(rdpcm), n=n, use_dst=use_dst, path=path, bd=10)
    _eq(want, got)


def test_residual_planes_match_jax():
    """The port's stacked residual planes (K1's plain path on the CPU) equal
    the JAX _residual_fn + _scatter_tu_fn planes on real collect items."""
    from libhm_tpu.hostdec.decoder import Decoder
    from libhm_tpu.parallel import batch_decode as JB
    from libhm_tpu_torch.parallel import batch_decode as TB
    name = "intra_main10_416x240"
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected[:2]
    want = JB._residual_planes_batch_device(items, len(items))
    got = TB._residual_planes_batch_device(items, len(items),
                                           torch.device("cpu"))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        _eq(w, g)


def _scaling_mats(kind, seed=0):
    """The default scaling matrices, or those of one seeded custom list
    (every (size_id, matrix_id) coded, values 1..255, its own DC)."""
    from libhm_tpu_torch.hostdec.tables import build_scaling_matrices
    if kind == "default":
        return build_scaling_matrices(None)
    rng = np.random.RandomState(seed)
    data = {}
    for size_id in range(4):
        base = min(8, 4 << size_id)
        for matrix_id in range(0, 6, 3 if size_id == 3 else 1):
            data[(size_id, matrix_id)] = (
                rng.randint(1, 256, size=base * base).tolist(),
                int(rng.randint(1, 256)))
    return build_scaling_matrices(data)


@pytest.mark.parametrize("kind", ["default", "custom"])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("bd", [8, 10])
def test_dequant_scaling(kind, log2, bd):
    """dequant_batch_scaling on every matrix of the size, intra and inter,
    at every qp: exact."""
    n = 1 << log2
    mats = _scaling_mats(kind, seed=log2 + bd)
    rng = np.random.RandomState(200 * log2 + bd)
    P = 24
    coeffs = rng.randint(-32768, 32768, size=(P, n, n)).astype(np.int32)
    qps = rng.randint(0, 52 + 6 * (bd - 8), size=P).astype(np.int32)
    mat = np.stack([mats[(log2 - 2, k % 6)] for k in range(P)]).astype(
        np.int32)
    fn = jax.jit(functools.partial(JT.dequant_batch_scaling, bit_depth=bd,
                                   log2_size=log2))
    _eq(fn(jnp.asarray(coeffs), jnp.asarray(qps), jnp.asarray(mat)),
        TT.dequant_batch_scaling(torch.from_numpy(coeffs),
                                 torch.from_numpy(qps),
                                 torch.from_numpy(mat), bd, log2))


@pytest.mark.parametrize("n,rotate", [(4, False), (4, True), (8, False),
                                      (16, False), (32, False)])
@pytest.mark.parametrize("bd", [8, 10])
def test_bypass_residual(n, rotate, bd):
    """The bypass branch of recon_tpu._residual_fn (with rotation and
    RDPCM in every direction) == recon_torch._residual_fn, and K1's plain
    scatter of it writes the same blocks."""
    from libhm_tpu.recon_tpu import _residual_fn
    rng = np.random.RandomState(n + 3 * rotate + bd)
    P = 12
    coeffs = rng.randint(-40000, 40000, size=(P, n, n)).astype(np.int32)
    qp = np.zeros(P, np.int32)
    rdpcm = (np.arange(P) % 3).astype(np.int32)
    want = _residual_fn(n, False, "bypass", bd, 15, rotate)(
        jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(rdpcm),
        jnp.zeros((1, 1, 1), jnp.int32))
    got = recon_torch._residual_fn(
        torch.from_numpy(coeffs), torch.from_numpy(qp),
        torch.from_numpy(rdpcm), n=n, use_dst=False, path="bypass", bd=bd,
        rotate=rotate)
    _eq(want, got)
    # K1's plain path on int16 levels, one TU per slot of a 2-picture plane
    c16 = np.clip(coeffs, -32768, 32767).astype(np.int16)
    want = np.asarray(_residual_fn(n, False, "bypass", bd, 15, rotate)(
        jnp.asarray(c16.astype(np.int32)), jnp.asarray(qp),
        jnp.asarray(rdpcm), jnp.zeros((1, 1, 1), jnp.int32)))
    planes = torch.zeros((2, 2 * n, 3 * n), dtype=torch.int32)
    slot = np.arange(P)
    TT.residual_scatter(
        planes, torch.from_numpy(c16), None,
        torch.from_numpy((slot // 6).astype(np.int32)),
        torch.from_numpy((slot // 3 % 2 * n).astype(np.int32)),
        torch.from_numpy((slot % 3 * n).astype(np.int32)), n=n,
        use_dst=False, tskip=False, bd=bd, bypass=True, rotate=rotate,
        rdpcm=torch.from_numpy(rdpcm.astype(np.int8)))
    for k in range(P):
        b, y, x = k // 6, k // 3 % 2 * n, k % 3 * n
        assert np.array_equal(planes[b, y:y + n, x:x + n].numpy(), want[k])


@pytest.mark.parametrize("n,use_dst,path,rotate", [
    (4, True, "itx", False), (4, False, "tskip", True),
    (8, False, "itx", False), (32, False, "itx", False)])
def test_residual_fn_scaling(n, use_dst, path, rotate):
    """recon_torch._residual_fn == recon_tpu._residual_fn with a custom
    scaling list, transform-skip rotation and RDPCM, at Main10; and K1's
    plain scatter with the matrix table and one-byte rows equals it."""
    from libhm_tpu.recon_tpu import _residual_fn
    rng = np.random.RandomState(7 * n + len(path))
    mats = _scaling_mats("custom", seed=n)
    P = 16
    coeffs = rng.randint(-3000, 3000, size=(P, n, n)).astype(np.int32)
    qp = rng.randint(0, 64, size=P).astype(np.int32)
    rdpcm = (np.arange(P) % 3 if path == "tskip" else np.zeros(P)) \
        .astype(np.int32)
    rows = (np.arange(P) * 5) % 6
    mat = np.stack([mats[(n.bit_length() - 3, r)] for r in rows]) \
        .astype(np.int32)
    want = np.asarray(_residual_fn(n, use_dst, path, 10, 15, rotate, True)(
        jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(rdpcm),
        jnp.asarray(mat)))
    got = recon_torch._residual_fn(
        torch.from_numpy(coeffs), torch.from_numpy(qp),
        torch.from_numpy(rdpcm), n=n, use_dst=use_dst, path=path, bd=10,
        rotate=rotate, mat=torch.from_numpy(mat))
    _eq(want, got)
    table = np.stack([mats[(n.bit_length() - 3, m)] for m in range(6)])
    planes = torch.zeros((1, 4 * n, 4 * n), dtype=torch.int32)
    slot = np.arange(P)
    TT.residual_scatter(
        planes, torch.from_numpy(coeffs.astype(np.int16)),
        torch.from_numpy(qp.astype(np.int8)),
        torch.zeros(P, dtype=torch.int32),
        torch.from_numpy((slot // 4 * n).astype(np.int32)),
        torch.from_numpy((slot % 4 * n).astype(np.int32)), n=n,
        use_dst=use_dst, tskip=path == "tskip", bd=10,
        mats=torch.from_numpy(table.astype(np.uint8)),
        midx=torch.from_numpy(rows.astype(np.uint8)), rotate=rotate,
        rdpcm=torch.from_numpy(rdpcm.astype(np.int8)))
    for k in range(P):
        y, x = k // 4 * n, k % 4 * n
        assert np.array_equal(planes[0, y:y + n, x:x + n].numpy(), want[k])


@pytest.mark.parametrize("name", ["scaling_intra_416x240",
                                  "customsl_lowdelay_160x96",
                                  "lossless_intra_416x240"])
def test_residual_planes_tools_match_jax(name):
    """The stacked residual planes of a scaling-list (SPS or PPS list) or
    lossless stream (K1's scaled and bypass plain paths, with rotation and
    RDPCM) equal the JAX _residual_fn + _scatter_tu_fn planes."""
    from libhm_tpu.hostdec.decoder import Decoder
    from libhm_tpu.parallel import batch_decode as JB
    from libhm_tpu_torch.parallel import batch_decode as TB
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected[:2]
    want = JB._residual_planes_batch_device(items, len(items))
    got = TB._residual_planes_batch_device(items, len(items),
                                           torch.device("cpu"))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        assert np.asarray(w).any()
        _eq(w, g)
