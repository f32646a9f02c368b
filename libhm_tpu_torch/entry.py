"""Driver entry point of the port: the fused recon step on the card.

Port of __graft_entry__.py entry() and _fused_recon_step: one step of the
decode's device stages on representative 1080p Main10 shapes, built from
the port's kernels:

    16x16 DCT and 4x4 DST residual buckets     K1 residual_scatter
    16x16 bi-predicted MC + residual, clipped  K6 mc_weighted (plain
                                               epilogue, 4x4 blocks in
                                               one run per 16x16 block)
    one vertical luma deblocking pass, then    K3 + K4 loop_filter_level
    SAO of the frame (BO and the EO classes)   (one launch, mask V + SAO)
    int32 sum of the 4x4 residuals and frame   K7 plane_checksum

`fused_recon_step` runs the kernels for CUDA tensors and their plain
versions for CPU tensors (the wrappers choose); `fused_recon_step_plain`
runs the plain versions on any device.  The arguments are the JAX step's,
as int32 tensors; the step converts them to the kernels' types and
layouts (index glue, no sample arithmetic) and leaves them unchanged.
`dryrun_multidevice` ports the multi-device dry run of __graft_entry__.py
(_dryrun_impl / dryrun_multichip): a golden random-access stream decoded
with each DAG level's pictures split over a list of devices, asserted
against its HM MD5.
"""
import hashlib
import json
import os

import numpy as np
import torch

from .ops import checksum as CK
from .ops import interp as MK
from .ops import loopfilter as LF
from .ops import transform as TK

BD = 10
LOG2_CTB = 6
R4_COLS = 32            # 4x4 residual blocks per row of the scratch plane

_KERNELS = dict(residual=TK.residual_scatter, mc=MK.mc_weighted,
                filter=LF.loop_filter_level, checksum=CK.plane_checksum)
_PLAIN = dict(residual=TK.residual_scatter_plain, mc=MK.mc_weighted_plain,
              filter=LF.loop_filter_level_plain,
              checksum=CK.plane_checksum_plain)


def make_inputs(seed=0, H=1088, W=1920, nb16=256, nb4=1024):
    """The step's inputs as numpy int32 arrays, in the JAX entry's order
    and ranges, drawn from RandomState(seed).

    One difference: the 16x16 block positions are distinct cells of the
    ((W - 16) // 16) x ((H - 16) // 16) grid, drawn without replacement.
    The JAX entry draws x and y apart with randint, so positions repeat
    (2 of 256 under seed 0), and where blocks overlap its scatter leaves
    the winner to XLA: no port could be held exactly against that frame.
    """
    rng = np.random.RandomState(seed)
    hc, wc = H // 64, W // 64
    gx, gy = (W - 16) // 16, (H - 16) // 16
    ns_y, ns_x = H // 4, W // 8
    d = dict(
        coeffs16=rng.randint(-2048, 2048, (nb16, 16, 16)),
        qp16=rng.randint(0, 63, (nb16,)),
        coeffs4=rng.randint(-2048, 2048, (nb4, 4, 4)),
        qp4=rng.randint(0, 63, (nb4,)),
        frame=rng.randint(0, 1024, (H, W)),
        refs=rng.randint(0, 1024, (2, H, W)),
        sel=rng.randint(0, 2, (nb16,)))
    pos = rng.choice(gx * gy, nb16, replace=False)
    d.update(
        bx=pos % gx * 16, by=pos // gx * 16,
        mv=rng.randint(-128, 128, (nb16, 2, 2)),
        bs=rng.randint(0, 3, (ns_y, ns_x)),
        qpmap=rng.randint(20, 40, (ns_y, ns_x)),
        zeros8=np.zeros((ns_y, ns_x)),
        sao_type=rng.randint(0, 6, (hc, wc)),
        sao_band=rng.randint(0, 28, (hc, wc)),
        sao_off=rng.randint(-7, 8, (hc, wc, 4)))
    return {k: v.astype(np.int32) for k, v in d.items()}


ARGS = ("coeffs16", "qp16", "coeffs4", "qp4", "frame", "refs", "sel", "bx",
        "by", "mv", "bs", "qpmap", "zeros8", "sao_type", "sao_band",
        "sao_off")


def entry(device="cuda"):
    """Returns (fn, args): fused_recon_step and its 1080p Main10 inputs as
    int32 tensors on `device` (the card unless the caller asks for the
    CPU; a CUDA device that is absent raises)."""
    from .parallel.dag_decode import _check_device
    device = _check_device(device, "entry")
    d = make_inputs()
    return fused_recon_step, tuple(torch.from_numpy(d[k]).to(device)
                                   for k in ARGS)


def fused_recon_step(*args):
    """The fused step through the kernel wrappers.  Returns (the int32 sum
    of the 4x4 residuals and the output frame, wrapped as JAX's int32 sum
    wraps; the output frame [H, W] int32)."""
    return _step(_KERNELS, *args)


def fused_recon_step_plain(*args):
    """The fused step through the kernels' plain torch versions."""
    return _step(_PLAIN, *args)


def _wrap_int32(acc):
    """A uint32 checksum (any integer dtype holding its bits) as int32."""
    v = acc.reshape(()).to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _step(k, coeffs16, qp16, coeffs4, qp4, frame, refs, sel, bx, by, mv, bs,
          qpmap, zeros8, sao_type, sao_band, sao_off):
    dev = frame.device
    H, W = frame.shape
    i32 = dict(dtype=torch.int32, device=dev)
    nb16, nb4 = coeffs16.shape[0], coeffs4.shape[0]
    if zeros8.any():
        raise ValueError("fused_recon_step: the deblocking offsets and the "
                         "PCM/lossless exclusions are zero in this step")
    # 16x16 residuals at the MC blocks' positions of a residual plane
    res16 = torch.zeros((1, H, W), **i32)
    k["residual"](res16, coeffs16.to(torch.int16), qp16.to(torch.int8),
                  torch.zeros(nb16, **i32), by.to(torch.int32),
                  bx.to(torch.int32), n=16, use_dst=False, tskip=False, bd=BD)
    # 4x4 DST residuals on a tiling of a scratch plane, only summed
    rows = -(-nb4 // R4_COLS)
    res4 = torch.zeros((1, 4 * rows, 4 * R4_COLS), **i32)
    j = torch.arange(nb4, device=dev, dtype=torch.int32)
    k["residual"](res4, coeffs4.to(torch.int16), qp4.to(torch.int8),
                  torch.zeros(nb4, **i32), j // R4_COLS * 4, j % R4_COLS * 4,
                  n=4, use_dst=True, tskip=False, bd=BD)
    # bi-prediction of each 16x16 block as its sixteen 4x4 blocks (every
    # sample is predicted from its own position, so the split changes
    # nothing), both lists on `sel`, + residual, clipped, into the frame;
    # each 16x16 block's rows are one run (one tile of K6 where the block
    # sits on the 16-sample grid, as make_inputs puts it)
    out = frame.to(torch.int32).clone().reshape(1, H, W)
    off = torch.arange(0, 16, 4, device=dev, dtype=torch.int32)
    blk = torch.zeros((nb16, 4, 4, len(MK.BLK_FIELDS)), **i32)
    blk[..., 1] = bx.to(torch.int32)[:, None, None] + off[None, None, :]
    blk[..., 2] = by.to(torch.int32)[:, None, None] + off[None, :, None]
    blk[..., 3] = 3
    blk[..., 4:8] = mv.to(torch.int32).reshape(nb16, 1, 1, 4)
    blk[..., 8] = blk[..., 9] = sel.to(torch.int32)[:, None, None]
    k["mc"](out, res16, refs.to(torch.int32), blk.reshape(-1, blk.shape[-1]),
            is_luma=True, sx=0, sy=0, bd=BD, wp=False, denom=0, W=W, H=H,
            groups=torch.arange(0, 16 * nb16 + 1, 16, **i32))
    # vertical luma deblocking: each segment's bs and qp on the even 4x4
    # columns of the per-4x4 maps (the odd ones hold no vertical edge)
    bsn = torch.zeros((1, H // 4, W // 4), dtype=torch.uint8, device=dev)
    bsn[0, :, 0::2] = bs.to(torch.uint8)
    qp = torch.zeros((1, H // 4, W // 4), dtype=torch.int8, device=dev)
    qp[0, :, 0::2] = qpmap.to(torch.int8)
    # then SAO in the same launch: the per-CTB maps as one component
    # column of [1, hc * wc, 1]
    hc, wc = sao_type.shape
    out, = k["filter"](
        [out], {"bsn_v": bsn, "qp_v": qp,
                "sao_t": sao_type.to(torch.int8).reshape(1, -1, 1),
                "sao_b": sao_band.to(torch.int8).reshape(1, -1, 1),
                "sao_o": sao_off.to(torch.int8).reshape(1, -1, 1, 4),
                "sao_scale_l": torch.zeros(1, **i32)},
        mask=LF.PASS_V | LF.PASS_SAO, bd_l=BD, bd_c=BD, sx=0, sy=0,
        log2_ctb=LOG2_CTB, hc=hc, wc=wc, W=W, H=H)
    total = k["checksum"]([out[0], res4[0]])
    return _wrap_int32(total), out[0]


DRYRUN_STREAM = "tids4_ra_160x96"   # random access, 4 temporal layers


def dryrun_multidevice(n_devices, device="cuda"):
    """Decode DRYRUN_STREAM through decode_batch, and two copies of it
    through decode_streams, with the picture axis split over `n_devices`
    list entries, asserting each output's MD5 against testdata/golden.json.

    device="cpu": n_devices entries of "cpu"; "cuda": cuda:{i % count} for
    i < n_devices over the host's `count` cards (a missing card raises
    RuntimeError).  Prints the mapping; returns the device list.
    """
    from .parallel.dag_decode import (_check_device, decode_batch,
                                      decode_streams)
    kind = _check_device(device, "dryrun_multidevice").type
    if n_devices < 1:
        raise ValueError("dryrun_multidevice: n_devices must be positive")
    if kind == "cuda":
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
    else:
        devices = [kind] * n_devices
    print(f"dryrun_multidevice: {n_devices} entries -> {devices}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "testdata", "golden.json")) as f:
        gold = json.load(f)[DRYRUN_STREAM]
    with open(os.path.join(root, "testdata", gold["bitstream"]), "rb") as f:
        data = f.read()

    def md5(outs):
        return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                    for p in pic)).hexdigest()
    got = md5(decode_batch(data, devices=devices))
    if got != gold["decoded_yuv_md5"]:
        raise AssertionError(f"multi-device decode of {DRYRUN_STREAM} not "
                             f"bit-exact: {got} != {gold['decoded_yuv_md5']}")
    for outs in decode_streams([data, data], devices=devices):
        if md5(outs) != gold["decoded_yuv_md5"]:
            raise AssertionError("multi-stream multi-device decode of "
                                 f"{DRYRUN_STREAM} not bit-exact")
    return devices
