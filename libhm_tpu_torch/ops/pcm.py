"""PCM sample scatter (K9) and the restore of unfiltered samples (K8).

- `pcm_scatter`: PCM blocks written into the zeroed stacked planes of a
  level before MC, each sample `<< (bd - pcm_bits)`: the per-block device
  scatters of libhm_tpu/parallel/dag_decode.py _recon_levels (lines
  482-489), here one launch per (level, component) over a block table.
- `restore_unfiltered`: the restore branch of the JAX _filter_fn
  (libhm_tpu/parallel/device_filters.py:191-201): after deblocking and
  SAO, samples of PCM blocks with pcm_loop_filter_disabled and of
  transquant-bypass CUs take back their pre-deblock value.

Each wrapper runs csrc/pcm.cu for CUDA tensors and its plain version for
CPU tensors.
"""
import torch

from ..kernels.build import I, P, Kernel, check, ptr

# block table columns of pcm_scatter
PCM_FIELDS = ("b", "x", "y", "w", "h", "shift")

_K8 = Kernel("restore_unfiltered", [P, P, P, I, I, I, I, I, I, I])
_K9 = Kernel("pcm_scatter", [P, P, P, P, I, I, I, I])


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


def pcm_scatter_plain(planes, blocks, samples, offsets):
    """Plain torch version of pcm_scatter (any device)."""
    for k in range(blocks.shape[0]):
        b, x, y, w, h, shift = (int(v) for v in blocks[k])
        o = int(offsets[k])
        blk = samples[o:o + w * h].to(torch.int32).reshape(h, w) << shift
        planes[b, y:y + h, x:x + w] = blk
    return planes


def pcm_scatter(planes, blocks, samples, offsets):
    """PCM blocks of one component written into the stacked planes, in
    place: planes[b, y + i, x + j] = samples[off + i * w + j] << shift.

    planes: [Bp, Hc, Wc] int32; blocks: [N, 6] int32 rows of PCM_FIELDS;
    samples: every block's samples, row-major, concatenated, int16;
    offsets: [N] int32 start of each block in `samples`.
    """
    if not planes.is_cuda:
        return pcm_scatter_plain(planes, blocks, samples, offsets)
    dev = planes.device
    check(planes, "planes", torch.int32, 3)
    check(blocks, "blocks", torch.int32, 2, dev)
    check(samples, "samples", torch.int16, 1, dev)
    check(offsets, "offsets", torch.int32, 1, dev)
    N = blocks.shape[0]
    if blocks.shape[1] != len(PCM_FIELDS) or offsets.shape[0] != N:
        raise ValueError("pcm_scatter: inconsistent block table")
    Bp, H, W = planes.shape
    if N:
        _K9(ptr(planes), ptr(blocks), ptr(samples), ptr(offsets), N, Bp, H,
            W)
    return planes
