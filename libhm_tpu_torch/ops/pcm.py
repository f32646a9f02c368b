"""PCM samples of a level (K9) and the restore of unfiltered samples (K8).

- `pcm_level`: every PCM block of a level, of every component, written
  into the zeroed stacked planes before MC, each sample
  `<< (bd - pcm_bits)`: the per-block device scatters of
  libhm_tpu/parallel/dag_decode.py _recon_levels (lines 482-489), here
  one launch per level over one packed upload (`pcm_pack`, `pcm_table`).
- `restore_unfiltered`: the restore branch of the JAX _filter_fn
  (libhm_tpu/parallel/device_filters.py:191-201): after deblocking and
  SAO, samples of PCM blocks with pcm_loop_filter_disabled and of
  transquant-bypass CUs take back their pre-deblock value.

Each wrapper runs csrc/pcm.cu for CUDA tensors and its plain version for
CPU tensors.
"""
import struct
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.build import I, P, Kernel, check, ptr

# one row of the PCM block table (csrc/pcm.cu PcmRow), 16 bytes: the first
# sample of the block in the sample part, picture, sample origin,
# component, log2 width and height, left shift (bit depth - PCM bit depth)
PCM_DTYPE = np.dtype([("off", "<u4"), ("b", "<i2"), ("x", "<u2"),
                      ("y", "<u2"), ("comp", "u1"), ("log2w", "u1"),
                      ("log2h", "u1"), ("shift", "u1"), ("pad", "<u2")])
# area classes, log2(w * h) = 4 .. 10 (4x4 .. 32x32, 4:2:2 w x 2w between)
LOG2_AREAS = tuple(range(4, 11))

_K8 = Kernel("restore_unfiltered", [P, P, P, I, I, I, I, I, I, I])
_K9 = Kernel("pcm_level", [P, P, P, I, I])
# csrc/pcm.cu PcmArgs: 3 plane pointers, 3 heights, 3 widths, the rows of
# each area class, padded to 80 bytes
_ARGS = struct.Struct("<3Q13i4x")


class PcmTable(NamedTuple):
    """The PCM blocks of one level, as K9 takes them."""
    rows: torch.Tensor      # uint8 [N, 16]: PCM_DTYPE rows sorted by area
    samples: torch.Tensor   # int16 [K]: each row's w * h samples, in order,
                            # the bits of uint16 values (read zero-extended)
    counts: tuple           # rows of each area class of LOG2_AREAS


def restore_unfiltered_plain(planes, pre, rmask, *, sx, sy):
    """Plain torch version of restore_unfiltered (any device)."""
    _, Hp, Wp = planes.shape
    _, h4, w4 = rmask.shape
    dev = planes.device
    ys = torch.clamp((torch.arange(Hp, device=dev) << sy) >> 2, max=h4 - 1)
    xs = torch.clamp((torch.arange(Wp, device=dev) << sx) >> 2, max=w4 - 1)
    mask = rmask[:, ys[:, None], xs[None, :]] != 0
    planes.copy_(torch.where(mask, pre, planes))
    return planes


def restore_unfiltered(planes, pre, rmask, *, sx, sy):
    """planes[b, y, x] = pre[b, y, x] wherever the picture's 4x4 restore
    mask is set at (min((y << sy) >> 2, h4 - 1), min((x << sx) >> 2,
    w4 - 1)), over the whole padded plane, in place.

    planes, pre: [B, Hp, Wp] int32 (filtered, pre-deblock); rmask:
    [B, h4, w4] uint8 (prepare_filter_maps' "rmask", on the luma grid);
    sx, sy: the component's subsampling shifts.
    """
    if not planes.is_cuda:
        return restore_unfiltered_plain(planes, pre, rmask, sx=sx, sy=sy)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(pre, "pre", torch.int32, 3, dev)
    check(rmask, "rmask", torch.uint8, 3, dev)
    B, Hp, Wp = planes.shape
    _, h4, w4 = rmask.shape
    if pre.shape != planes.shape or rmask.shape[0] != B or \
            max(Hp, B) > 65535:
        raise ValueError("restore_unfiltered: inconsistent shapes")
    if B * Hp * Wp:
        _K8(ptr(planes), ptr(pre), ptr(rmask), B, Hp, Wp, h4, w4, sx, sy)
    return planes


def pcm_pack(blocks):
    """One level's PCM blocks as one host buffer for a single upload.

    blocks: (comp, b, x, y, w, h, shift, samples) each, w and h powers of
    two in 4..32, samples w * h values in row order.  Returns (buf, counts):
    buf a uint8 numpy array, the PCM_DTYPE rows sorted stably by area and
    then the uint16 samples in row order (the part starts at byte 16 * N, a
    16-byte boundary; each block's offset is a multiple of 16 samples);
    counts the rows of each area class.  `pcm_table` makes the views.
    """
    blocks = list(blocks)
    rows = np.zeros(len(blocks), PCM_DTYPE)
    for name, j in (("comp", 0), ("b", 1), ("x", 2), ("y", 3),
                    ("shift", 6)):
        rows[name] = [blk[j] for blk in blocks]
    w = np.asarray([blk[4] for blk in blocks], np.int64)
    h = np.asarray([blk[5] for blk in blocks], np.int64)
    rows["log2w"] = np.log2(np.maximum(w, 1)).astype(np.int64)
    rows["log2h"] = np.log2(np.maximum(h, 1)).astype(np.int64)
    if ((1 << rows["log2w"].astype(np.int64)) != w).any() or \
            ((1 << rows["log2h"].astype(np.int64)) != h).any() or \
            w.min(initial=4) < 4 or h.min(initial=4) < 4 or \
            w.max(initial=32) > 32 or h.max(initial=32) > 32:
        raise ValueError("pcm_pack: block sides must be powers of two in "
                         "4..32")
    for blk, n in zip(blocks, w * h):
        if np.size(blk[7]) != n:
            raise ValueError("pcm_pack: a block's samples are not w * h")
    area = rows["log2w"].astype(np.int64) + rows["log2h"]
    order = np.argsort(area, kind="stable")
    rows = rows[order]
    sizes = (w * h)[order]
    rows["off"] = np.cumsum(sizes) - sizes
    samples = np.concatenate(
        [np.asarray(blocks[k][7]).reshape(-1) for k in order]
        or [np.zeros(0)]).astype(np.uint16)
    counts = tuple(int(c) for c in np.bincount(
        area - LOG2_AREAS[0], minlength=len(LOG2_AREAS)))
    return np.concatenate([rows.view(np.uint8).reshape(-1),
                           samples.view(np.uint8)]), counts


def pcm_table(buf, counts):
    """The PcmTable views of a buffer `pcm_pack` made (a uint8 tensor on
    any device)."""
    n = 16 * sum(counts)
    return PcmTable(buf[:n].view(-1, 16), buf[n:].view(torch.int16),
                    tuple(counts))


def _pcm_fields(rows):
    """The PCM_DTYPE fields of uint8 [N, 16] rows, as int64 tensors."""
    w = rows.view(torch.int32).long() & 0xFFFFFFFF           # [N, 4]
    b = w[:, 1] & 0xFFFF
    return {"off": w[:, 0], "b": (b ^ 0x8000) - 0x8000, "x": w[:, 1] >> 16,
            "y": w[:, 2] & 0xFFFF, "comp": (w[:, 2] >> 16) & 0xFF,
            "log2w": w[:, 2] >> 24, "log2h": w[:, 3] & 0xFF,
            "shift": (w[:, 3] >> 8) & 0xFF}


def _check_table(planes, table):
    if not 1 <= len(planes) <= 3 or \
            len({p.shape[0] for p in planes}) != 1 or \
            len(table.counts) != len(LOG2_AREAS) or \
            min(table.counts) < 0 or \
            sum(table.counts) != table.rows.shape[0] or \
            table.rows.dim() != 2 or table.rows.shape[1] != 16:
        raise ValueError("pcm_level: 1-3 planes of one picture count, and "
                         "16-byte rows as many as the counts")


def pcm_level_plain(planes, table):
    """Plain torch version of pcm_level (any device), in place: one
    scatter per (component, block shape)."""
    _check_table(planes, table)
    f = _pcm_fields(table.rows)
    dev = table.rows.device
    want = torch.repeat_interleave(
        torch.tensor(LOG2_AREAS, device=dev),
        torch.tensor(table.counts, device=dev))
    if not torch.equal(f["log2w"] + f["log2h"], want):
        raise ValueError("pcm_level: rows not sorted by area as the counts "
                         "say")
    Bp = planes[0].shape[0]
    key = f["comp"] | (f["log2w"] << 8) | (f["log2h"] << 16)
    for k in torch.unique(key).tolist():
        c, lw, lh = k & 0xFF, (k >> 8) & 0xFF, k >> 16
        i = torch.nonzero(key == k).squeeze(1)
        i = i[(f["b"][i] >= 0) & (f["b"][i] < Bp)]
        if c >= len(planes) or not len(i):
            continue
        w, h = 1 << lw, 1 << lh
        idx = f["off"][i, None] + torch.arange(w * h, device=dev)
        blk = (table.samples[idx].view(-1, h, w).to(torch.int32) & 0xFFFF) \
            << f["shift"][i, None, None].to(torch.int32)
        _, H, W = planes[c].shape
        iy = (f["y"][i, None, None] + torch.arange(h, device=dev)[:, None]) \
            .expand(blk.shape)
        ix = (f["x"][i, None, None] + torch.arange(w, device=dev)) \
            .expand(blk.shape)
        m = (iy < H) & (ix < W)     # samples past the plane are dropped
        planes[c][f["b"][i, None, None].expand(blk.shape)[m], iy[m],
                  ix[m]] = blk[m]
    return planes


def pcm_level(planes, table):
    """Every PCM block of one level written into its component's stacked
    planes, in place, in one launch: planes[c][b, y + i, x + j] =
    samples[off + i * w + j] << shift.

    planes: the level's [Bp, Hc, Wc] int32 planes, 1 to 3 components;
    table: a PcmTable (rows sorted by area; rows of pictures outside
    [0, Bp) are skipped, samples past the plane dropped).
    """
    if not planes[0].is_cuda:
        return pcm_level_plain(planes, table)
    dev = planes[0].device
    args = [0] * 9                      # _ARGS's pointers, heights, widths
    for c, p in enumerate(planes[:3]):
        check(p, "planes", torch.int32, 3, dev)
        args[c] = p.data_ptr()
        _, args[3 + c], args[6 + c] = p.shape
    check(table.rows, "rows", torch.uint8, 2, dev)
    check(table.samples, "samples", torch.int16, 1, dev)
    _check_table(planes, table)
    Bp = planes[0].shape[0]
    rows, samples = ptr(table.rows), ptr(table.samples)
    if Bp > 32767 or rows % 16 or samples % 8:
        raise ValueError("pcm_level: more pictures than an int16 holds, or "
                         "rows not 16-byte / samples not 8-byte aligned")
    if not table.rows.shape[0]:
        return planes
    _K9(rows, samples, _ARGS.pack(*args, *table.counts), len(planes), Bp)
    return planes
