"""Cross-picture batched residual planes and intra wavefront.

Port of the device-resident half of libhm_tpu/parallel/batch_decode.py:

 - residual build: TU buckets keyed by (size, path, ...) over the union of
   every picture's tu_list; each (bucket, component) is one K1 launch
   (ops/transform.py residual_scatter) that dequantizes, inverse
   transforms and writes straight into the stacked [Bp, Hc, Wc] planes;
 - intra wavefront: each picture's levelized blocks (intra_wavefront.
   prepare_component) are stacked over the picture axis, and every
   (level, block size) is one K2 launch (ops/intra.py intra_level), in
   the loop order of the JAX scan: levels, then sizes.
"""
import numpy as np
import torch

from ..hostdec.picture import MODE_INTRA

from ..ops import intra as IK
from ..ops import transform as TK
from ..utils import xfer
from .intra_wavefront import prepare_component


# ---------------------------------------------------------------------------
def _tu_bucket_entries(items):
    """Shared TU bucketing over a picture set.

    Copied from libhm_tpu/parallel/batch_decode.py (_tu_bucket_entries).
    Returns {(n, use_dst, path, bd, rotate, scal, max_dyn):
             [(b, i, scal_mats), ...]}.
    """
    from ..hostdec.tables import build_scaling_matrices
    buckets = {}
    mats_cache = {}
    for b, it in enumerate(items):
        sps, pic = it["sps"], it["pic"]
        scal_mats = None
        if sps.scaling_list_enabled:
            data = getattr(it["pps"], "scaling_list_data", None)
            if data is None:
                data = sps.scaling_list_data
            key = id(data)
            if key not in mats_cache:
                mats_cache[key] = build_scaling_matrices(data)
            scal_mats = mats_cache[key]
        pred_mode_map = np.asarray(pic.pred_mode)
        for i, tu in enumerate(pic.tu_list):
            bd = sps.bit_depth_luma if tu.comp == 0 else sps.bit_depth_chroma
            if tu.tq_bypass:
                path = "bypass"
            elif tu.transform_skip:
                path = "tskip"
            else:
                path = "itx"
            sxr = sps.chroma_shift_x() if tu.comp else 0
            syr = sps.chroma_shift_y() if tu.comp else 0
            tu_is_intra = pred_mode_map[(tu.y << syr) >> 2,
                                        (tu.x << sxr) >> 2] == MODE_INTRA
            rotate = bool(sps.transform_skip_rotation) and tu.w == 4 and \
                path in ("tskip", "bypass") and bool(tu_is_intra)
            scal = scal_mats is not None and path != "bypass" and \
                not (tu.transform_skip and tu.w > 4)
            max_dyn = 15 if not sps.extended_precision else max(15, bd + 6)
            key = (tu.w, bool(tu.use_dst), path, bd, rotate, scal, max_dyn)
            buckets.setdefault(key, []).append((b, i, scal_mats))
    return buckets


def _bucket_inputs(items, entries, n, scal, P):
    """Host-side padded input tensors for one TU bucket.

    Copied from libhm_tpu/parallel/batch_decode.py (_bucket_inputs).
    """
    coeffs = np.zeros((P, n, n), np.int32)
    qp = np.zeros(P, np.int32)
    rdpcm = np.zeros(P, np.int32)
    mat = np.ones((P, n, n), np.int32) * 16 if scal else \
        np.zeros((1, 1, 1), np.int32)
    for k, (b, i, scal_mats) in enumerate(entries):
        pic = items[b]["pic"]
        sps = items[b]["sps"]
        tu = pic.tu_list[i]
        coeffs[k] = tu.coeffs
        qp[k] = tu.qp
        rdpcm[k] = tu.rdpcm_mode
        if scal:
            sxr = sps.chroma_shift_x() if tu.comp else 0
            syr = sps.chroma_shift_y() if tu.comp else 0
            intra = np.asarray(pic.pred_mode)[(tu.y << syr) >> 2,
                                              (tu.x << sxr) >> 2] \
                == MODE_INTRA
            size_id = tu.w.bit_length() - 3
            mat[k] = scal_mats[(size_id, (0 if intra else 3) + tu.comp)]
    return coeffs, qp, rdpcm, mat


def _residual_planes_batch_device(items, Bp, device):
    """Device-resident residual build: every TU of every picture written
    into stacked [Bp, Hc, Wc] int32 device planes, one K1 launch per
    (bucket, component).  Only the coefficient buckets are uploaded.
    """
    sps0 = items[0]["sps"]
    Wp = sps0.pic_width_ctbs << sps0.log2_ctb
    Hp = sps0.pic_height_ctbs << sps0.log2_ctb
    ncomp = 3 if sps0.chroma_format_idc else 1
    res_stacked = []
    for c in range(ncomp):
        sx = sps0.chroma_shift_x() if c else 0
        sy = sps0.chroma_shift_y() if c else 0
        res_stacked.append(torch.zeros((Bp, Hp >> sy, Wp >> sx),
                                       dtype=torch.int32, device=device))
    buckets = _tu_bucket_entries(items)
    for (n, use_dst, path, bd, rotate, scal, max_dyn), entries \
            in buckets.items():
        coeffs, qp, rdpcm, _ = _bucket_inputs(items, entries, n, False,
                                              len(entries))
        if path == "bypass" or rotate or scal or max_dyn != 15 or \
                rdpcm.any():
            raise NotImplementedError(
                "transquant bypass, transform-skip rotation, scaling lists, "
                "extended precision and RDPCM are not ported")
        if coeffs.min(initial=0) < -32768 or coeffs.max(initial=0) > 32767:
            raise ValueError("coefficient level outside the int16 range")
        comp_arr = np.asarray([items[b]["pic"].tu_list[i].comp
                               for b, i, _ in entries])
        bsel = np.asarray([b for b, _, _ in entries], np.int32)
        ysel = np.asarray([items[b]["pic"].tu_list[i].y
                           for b, i, _ in entries], np.int32)
        xsel = np.asarray([items[b]["pic"].tu_list[i].x
                           for b, i, _ in entries], np.int32)
        for c in range(ncomp):
            sel = np.nonzero(comp_arr == c)[0]
            if not len(sel):
                continue
            TK.residual_scatter(
                res_stacked[c],
                xfer.up(coeffs[sel].astype(np.int16), "coeff", device),
                xfer.up(qp[sel].astype(np.int8), "coeff", device),
                xfer.up(bsel[sel], "idx", device),
                xfer.up(ysel[sel], "idx", device),
                xfer.up(xsel[sel], "idx", device),
                n=n, use_dst=use_dst, tskip=path == "tskip", bd=bd)
    return res_stacked


# ---------------------------------------------------------------------------
def _intra_batch(items, comp, stacked, res_stacked, device):
    """Batched intra wavefront over all pictures for one component.

    stacked: device [Bp, Hc, Wc] planes (updated in place and returned);
    res_stacked: device [Bp, Hc, Wc] residual planes, read by the kernel.
    One K2 launch per (level, size) that holds at least one real block.
    """
    sps = items[0]["sps"]
    ssx = sps.chroma_shift_x() if comp else 0
    ssy = sps.chroma_shift_y() if comp else 0
    W = sps.width >> ssx
    H = sps.height >> ssy
    bd = sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma
    preps = []
    for it in items:
        constrained = bool(it["pps"].constrained_intra_pred)
        levels, _ = prepare_component(
            it["sps"], it["pic"], it["zmap"], it["tile_map"], comp, None,
            constrained)
        preps.append(levels)
    if all(lv is None for lv in preps):
        return stacked
    Bp = int(stacked.shape[0])
    sizes = sorted({n for lv in preps if lv for n in lv})
    batched = {}
    for n in sizes:
        # real slots form a prefix of every level row: trim the pow2
        # padding of prepare_component to the largest real level count
        real = [lv[n]["xs"] < W for lv in preps if lv and n in lv]
        counts = [r.sum(axis=1) for r in real]
        Ln = max(len(c) for c in counts)
        per_level = np.zeros(Ln, np.int64)
        for cnt in counts:
            per_level[:len(cnt)] = np.maximum(per_level[:len(cnt)], cnt)
        if not per_level.any():
            continue
        L = int(np.nonzero(per_level)[0][-1]) + 1
        K = int(per_level.max())
        T = 4 * n + 1
        d = dict(xs=np.full((Bp, L, K), W + 1024, np.int16),
                 ys=np.full((Bp, L, K), H + 1024, np.int16),
                 mode=np.ones((Bp, L, K), np.int8),
                 flags=np.zeros((Bp, L, K), np.uint8),
                 av=np.zeros((Bp, L, K, (T + 7) >> 3), np.uint8))
        for b, lv in enumerate(preps):
            if not lv or n not in lv:
                continue
            for k, v in lv[n].items():
                l0, k0 = min(L, v.shape[0]), min(K, v.shape[1])
                d[k][b, :l0, :k0] = v[:l0, :k0]
        batched[n] = ({k: xfer.up(v, "intra_" + k, device)
                       for k, v in d.items()}, per_level[:L])
    n_levels = max(len(pl) for _, pl in batched.values())
    for level in range(n_levels):
        for n in sizes:
            if n not in batched:
                continue
            meta, per_level = batched[n]
            if level < len(per_level) and per_level[level]:
                IK.intra_level(stacked, res_stacked, meta, level, n=n,
                               is_luma=comp == 0, bd=bd, W=W, H=H)
    return stacked
