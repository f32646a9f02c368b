"""The port's CUDA kernels against their plain torch versions, on a GPU.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
check happens inside the fixture, never at import).  On a GPU host:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Inputs are numpy-seeded; all arithmetic is integer, so equality is exact.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _items(name):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(open(os.path.join(ROOT, "testdata",
                                        GOLD[name]["bitstream"]), "rb").read())
    return dec.collected


def test_residual_kernel(gpu):
    from libhm_tpu_torch.ops import transform as TK
    rng = np.random.default_rng(1)
    for n, use_dst, tskip in ((4, True, False), (4, True, True),
                              (8, False, False), (16, False, False),
                              (32, False, False)):
        P = 64
        coeffs = torch.from_numpy(rng.integers(-32768, 32768, (P, n, n))
                                  .astype(np.int16)).to(gpu)
        qp = torch.from_numpy(rng.integers(0, 64, P).astype(np.int8)).to(gpu)
        # distinct 32x32 slots of 2 pictures; picture index 2 is padding
        slot = rng.choice(3 * 64, P, replace=False)
        bsel, ysel, xsel = (torch.from_numpy(a.astype(np.int32)).to(gpu)
                            for a in (slot // 64, slot // 8 % 8 * 32,
                                      slot % 8 * 32))
        kw = dict(n=n, use_dst=use_dst, tskip=tskip, bd=10)
        got = torch.zeros((2, 256, 256), dtype=torch.int32, device=gpu)
        want = got.clone()
        TK.residual_scatter(got, coeffs, qp, bsel, ysel, xsel, **kw)
        TK.residual_scatter_plain(want, coeffs, qp, bsel, ysel, xsel, **kw)
        assert torch.equal(got, want), (n, use_dst, tskip)


@pytest.mark.parametrize("name", ["intra_main10_416x240", "intra_416x240"])
def test_decode_on_gpu(gpu, name):
    """Every kernel launches, and the picture MD5 matches the golden one."""
    from libhm_tpu_torch.ops import deblock as DK
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import sao as SK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    kernels = (TK._K1, IK._K2, DK._K3_LUMA, DK._K3_CHROMA, SK._K4)
    for k in kernels:
        k.launches = 0
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    outs = decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert all(k.launches > 0 for k in kernels)


def test_intra_kernel_every_level(gpu):
    """K2 == its plain version on every level of a real picture."""
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel.intra_wavefront import prepare_component
    it = _items("intra_main10_416x240")[0]
    sps = it["sps"]
    levels, _ = prepare_component(sps, it["pic"], it["zmap"], it["tile_map"],
                                  0, None, False)
    rng = np.random.default_rng(2)
    shape = (1, 256, 448)
    base = torch.from_numpy(rng.integers(0, 1024, shape).astype(np.int32)).to(gpu)
    res = torch.from_numpy(rng.integers(-64, 65, shape).astype(np.int32)).to(gpu)
    got, want = base.clone(), base.clone()
    for n in (4, 8, 16, 32):
        meta = {k: torch.from_numpy(v[None]).to(gpu)
                for k, v in levels[n].items()}
        kw = dict(n=n, is_luma=True, bd=10, W=sps.width, H=sps.height)
        for level in range(levels[n]["xs"].shape[0]):
            IK.intra_level(got, res, meta, level, **kw)
            IK.intra_level_plain(want, res, meta, level, **kw)
    assert torch.equal(got, want)


def _mc_inputs(rng, bd, B=3, R=4, Hp=96, Wp=128, H=88, W=120, sx=0, sy=0):
    """Seeded planes and per-4x4 maps; MVs reach far past the picture."""
    hp, wp, h, w = Hp >> sy, Wp >> sx, H >> sy, W >> sx
    h4, w4 = Hp // 4, Wp // 4
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return dict(
        stacked=t(rng.integers(0, 1 << bd, (B, hp, wp)).astype(np.int32)),
        res=t(rng.integers(-512, 512, (B, hp, wp)).astype(np.int32)),
        refs=t(rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)),
        mv=t(rng.integers(-400, 401, (B, h4, w4, 2, 2)).astype(np.int16)),
        dirm=t(rng.integers(0, 4, (B, h4, w4)).astype(np.int8)),
        sel=t(rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)),
        W=w, H=h)


@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (True, 10, 0, 0),
                                              (False, 10, 1, 1)])
def test_mc_grid_kernel(gpu, is_luma, bd, sx, sy):
    from libhm_tpu_torch.ops import interp as MK
    a = _mc_inputs(np.random.default_rng(3 + bd), bd, sx=sx, sy=sy)
    args = [a[k].to(gpu) for k in ("stacked", "res", "refs", "mv", "dirm",
                                   "sel")]
    kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=a["W"], H=a["H"])
    want = args[0].clone()
    MK.mc_grid_plain(want, *args[1:], **kw)
    n0 = MK._K5.launches
    MK.mc_grid(*args, **kw)
    torch.cuda.synchronize()
    assert MK._K5.launches == n0 + 1
    assert torch.equal(args[0], want)


@pytest.mark.parametrize("wp", [True, False])
@pytest.mark.parametrize("is_luma,bd,sx,sy", [(True, 8, 0, 0),
                                              (False, 10, 1, 1)])
def test_mc_weighted_kernel(gpu, is_luma, bd, sx, sy, wp):
    from libhm_tpu_torch.ops import interp as MK
    rng = np.random.default_rng(4 + bd)
    a = _mc_inputs(rng, bd, sx=sx, sy=sy)
    B, hp, wpad = a["stacked"].shape
    N = 200
    blk = np.zeros((N, len(MK.BLK_FIELDS)), np.int32)
    cell = rng.choice(B * (96 // 4) * (128 // 4), N, replace=False)
    blk[:, 0] = cell // (24 * 32)
    blk[:, 1] = ((cell % 32) << 2) >> sx
    blk[:, 2] = (((cell // 32) % 24) << 2) >> sy
    blk[:, 3] = rng.integers(1, 4, N)
    blk[:, 4:8] = rng.integers(-400, 401, (N, 4))
    blk[:, 8:10] = rng.integers(0, 4, (N, 2))
    blk[:, 10:12] = rng.integers(-128, 256, (N, 2))
    blk[:, 12:14] = rng.integers(-128, 128, (N, 2)) << (bd - 8)
    args = [a[k].to(gpu) for k in ("stacked", "res", "refs")] + \
        [torch.from_numpy(blk).to(gpu)]
    for denom in (0, 3, 7):
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, wp=wp, denom=denom,
                  W=a["W"], H=a["H"])
        got, want = args[0].clone(), args[0].clone()
        MK.mc_weighted_plain(want, *args[1:], **kw)
        MK.mc_weighted(got, *args[1:], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), denom


def test_checksum_kernel(gpu):
    from libhm_tpu_torch.ops import checksum as CK
    rng = np.random.default_rng(6)
    planes = torch.from_numpy(rng.integers(0, 4096, (3, 1088, 1920))
                              .astype(np.int32)).to(gpu)
    views = [planes[b, 4:1084, 8:1912] for b in range(3)] * 300
    want = int(CK.plane_checksum_plain(views).item())
    n0 = CK._K7.launches
    got = int(CK.plane_checksum(views).item()) & 0xFFFFFFFF
    assert CK._K7.launches == n0 + 1
    assert got == want


@pytest.mark.parametrize("name,kernel", [
    ("randomaccess_main10_416x240", "_K5"), ("wp_lowdelayP_416x240", "_K6")])
def test_inter_decode_on_gpu(gpu, name, kernel):
    """Golden MD5 through the MC kernels; the device checksum equals the
    checksum of the downloaded pictures."""
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.parallel import dag_decode as DD
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    k = getattr(MK, kernel)
    k.launches = 0
    outs = DD.decode_batch(data, device=gpu)
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    assert k.launches > 0
    CK._K7.launches = 0
    csum = DD.decode_batch_device(data, device=gpu)[2]
    assert CK._K7.launches == 1
    assert csum == DD.cropped_checksum(outs)
