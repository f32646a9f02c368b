"""Seeded random intra layouts, and the plain reference of intra
reconstruction (hevc_bench/plain_intra.py) beside the port's own prep and
K2 entry, for tests/test_torch_plain_intra.py (CPU) and
tests/test_torch_intra_plane.py (the card).

A layout is one picture of one component (luma, or 4:4:4 chroma on the
luma grid): a quadtree over each CTU in raster order, split where a node
crosses the picture's edge or exceeds 32 samples and at random below,
leaves of 4..32 samples; each leaf a random mode 0..34, a residual that
is zero, small or drawn across the bit depth's whole range, and (where
asked) a random cu_transquant_bypass_flag.  The port gets it as the
parse would hand it over (IntraBlock, the 4x4 maps, the z-scan map) and
reconstructs it through prepare_component -> intra_table / intra_meta ->
ops.intra.intra_wavefront; the reference gets the blocks in decoding
order.
"""
from types import SimpleNamespace

import numpy as np
import torch

from libhm_tpu_torch.hostdec.picture import MODE_INTRA, IntraBlock
from libhm_tpu_torch.ops import intra as IK
from libhm_tpu_torch.parallel import batch_decode as TB
from tools.check_intra_reference import plain_intra


def _leaves(rng, x, y, size, W, H):
    if x >= W or y >= H:
        return []
    crosses = x + size > W or y + size > H
    if size > 32 or crosses or (size > 4 and rng.random() < 0.55):
        h = size // 2
        return [leaf for dy in (0, h) for dx in (0, h)
                for leaf in _leaves(rng, x + dx, y + dy, h, W, H)]
    return [(x, y, size)]


def random_layout(seed, W, H, bd, log2_ctb=6, bypass=False):
    """The blocks of a random layout in decoding order: [(x, y, n, mode,
    residual int32 [n, n], bypass)].  W and H are multiples of 8."""
    rng = np.random.default_rng(seed)
    ctb = 1 << log2_ctb
    out = []
    for cy in range(0, H, ctb):
        for cx in range(0, W, ctb):
            for x, y, n in _leaves(rng, cx, cy, ctb, W, H):
                kind = rng.random()
                if kind < 0.3:
                    res = np.zeros((n, n), np.int32)
                elif kind < 0.6:
                    res = rng.integers(-4, 5, (n, n)).astype(np.int32)
                else:
                    lim = (1 << bd) - 1
                    res = rng.integers(-lim, lim + 1, (n, n)).astype(np.int32)
                out.append((x, y, n, int(rng.integers(0, 35)), res,
                            bool(bypass and rng.random() < 0.5)))
    return out


def _zscan(log2_ctb, h4, w4, wctbs):
    """The z-scan order of each 4x4 luma block, CTUs in raster order."""
    yy, xx = np.mgrid[0:h4, 0:w4]
    m = log2_ctb - 2
    z = np.zeros((h4, w4), np.int64)
    for b in range(m):
        z |= ((xx >> b) & 1) << (2 * b)
        z |= ((yy >> b) & 1) << (2 * b + 1)
    ctu = (yy >> m) * wctbs + (xx >> m)
    return ctu * (1 << (2 * m)) + z


def port_items(blocks, W, H, bd, comp=0, log2_ctb=6, implicit_rdpcm=False):
    """The collect item of one picture holding the layout `blocks` as the
    intra blocks of component `comp` (4:4:4 when comp > 0)."""
    ctb = 1 << log2_ctb
    wctbs, hctbs = -(-W // ctb), -(-H // ctb)
    fmt = 3 if comp else 1
    sps = SimpleNamespace(
        width=W, height=H, log2_ctb=log2_ctb, pic_width_ctbs=wctbs,
        pic_height_ctbs=hctbs, chroma_format_idc=fmt,
        chroma_shift_x=lambda: 0 if fmt == 3 else 1,
        chroma_shift_y=lambda: 0 if fmt == 3 else 1,
        strong_intra_smoothing=True, implicit_rdpcm=implicit_rdpcm,
        intra_smoothing_disabled=False, bit_depth_luma=bd,
        bit_depth_chroma=bd)
    h4, w4 = (hctbs * ctb) >> 2, (wctbs * ctb) >> 2
    tq = np.zeros((h4, w4), np.int8)
    for x, y, n, _, _, byp in blocks:
        tq[y >> 2:(y + n) >> 2, x >> 2:(x + n) >> 2] = byp
    pic = SimpleNamespace(
        intra_list=[IntraBlock(comp, x, y, n, n, mode, False, -1)
                    for x, y, n, mode, _, _ in blocks],
        slice_idx=np.zeros((h4, w4), np.int32),
        pred_mode=np.full((h4, w4), MODE_INTRA, np.int8), tq_bypass=tq)
    return {"sps": sps, "pic": pic, "pps": SimpleNamespace(
                constrained_intra_pred=0),
            "zmap": _zscan(log2_ctb, h4, w4, wctbs),
            "tile_map": np.zeros(wctbs * hctbs, np.int32)}


def port_items_420(seed, W, H, bd, log2_ctb=6):
    """The collect item of one 4:2:0 picture whose three components hold
    seeded random layouts: luma W x H, each chroma component W/2 x H/2 in
    CTUs of half the luma CTU's size.  Returns (item, {comp: blocks})."""
    luma = random_layout(seed, W, H, bd, log2_ctb)
    item = port_items(luma, W, H, bd, 0, log2_ctb)
    blocks = {0: luma}
    for c in (1, 2):
        blocks[c] = random_layout(seed + c, W // 2, H // 2, bd, log2_ctb - 1)
        item["pic"].intra_list += [IntraBlock(c, x, y, n, n, mode, False, -1)
                                   for x, y, n, mode, _, _ in blocks[c]]
    return item, blocks


def port_reconstruct(blocks, W, H, bd, device, comp=0, log2_ctb=6,
                     implicit_rdpcm=False, ctas=0):
    """The port's reconstruction of the layout on `device`: (plane [H, W]
    on the host, the table intra_meta built)."""
    item = port_items(blocks, W, H, bd, comp, log2_ctb,
                      implicit_rdpcm=implicit_rdpcm)
    sps = item["sps"]
    shape = (1, sps.pic_height_ctbs << log2_ctb, sps.pic_width_ctbs << log2_ctb)
    res = np.zeros(shape, np.int32)
    for x, y, n, _, r, _ in blocks:
        res[0, y:y + n, x:x + n] = r
    table = TB.intra_meta([item], comp, device)
    plane = torch.zeros(shape, dtype=torch.int32, device=device)
    IK.intra_wavefront(plane, torch.from_numpy(res).to(device), table,
                       is_luma=comp == 0, bd=bd, W=W, H=H, _ctas=ctas)
    return plane[0, :H, :W].cpu(), table


def reference(blocks, W, H, bd, comp=0, implicit_rdpcm=False):
    """plain_intra's reconstruction of the layout: [H, W] int64."""
    P = plain_intra()
    return P.reconstruct(
        [P.Block(x, y, n, mode, torch.from_numpy(r), byp)
         for x, y, n, mode, r, byp in blocks],
        width=W, height=H, bit_depth=bd, c_idx=comp,
        chroma_array_type=3 if comp else 1, strong_intra_smoothing=True,
        implicit_rdpcm=implicit_rdpcm)
