"""Cross-picture batched residual planes and intra wavefront.

Port of the device-resident half of libhm_tpu/parallel/batch_decode.py:

 - residual build: TU buckets keyed by (size, path, ...) over the union of
   every picture's tu_list; each (bucket, component) is one K1 launch
   (ops/transform.py residual_scatter) that dequantizes (with the level's
   scaling matrices where the bucket has them), inverse transforms and
   writes straight into the stacked [Bp, Hc, Wc] planes, or writes the
   coefficients of transquant-bypass TUs as they are; then, in 4:4:4,
   cross-component prediction on the finished luma residual, one K10
   launch per chroma component (ops/ccp.py ccp_apply);
 - intra wavefront: each picture's levelized blocks (intra_wavefront.
   prepare_component) go into one flat table sorted by dependency level,
   every picture and block size mixed, and one K2 launch per component
   (ops/intra.py intra_wavefront) reconstructs them level after level.
"""
import numpy as np
import torch

from ..hostdec.picture import MODE_INTRA

from ..ops import ccp as CK
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


def _bucket_inputs(items, entries, n, mat_row):
    """Host-side input arrays for one TU bucket.

    From libhm_tpu/parallel/batch_decode.py (_bucket_inputs), without the
    pow2 padding and, instead of a [P, n, n] matrix per TU, each TU's row
    of the level's scaling-matrix table: `mat_row(scal_mats, matrix_id)`
    (None when the bucket takes no matrix).
    """
    P = len(entries)
    coeffs = np.zeros((P, n, n), np.int32)
    qp = np.zeros(P, np.int32)
    rdpcm = np.zeros(P, np.int32)
    midx = np.zeros(P, np.uint8) if mat_row else None
    for k, (b, i, scal_mats) in enumerate(entries):
        pic = items[b]["pic"]
        sps = items[b]["sps"]
        tu = pic.tu_list[i]
        coeffs[k] = tu.coeffs
        qp[k] = tu.qp
        rdpcm[k] = tu.rdpcm_mode
        if mat_row:
            sxr = sps.chroma_shift_x() if tu.comp else 0
            syr = sps.chroma_shift_y() if tu.comp else 0
            intra = np.asarray(pic.pred_mode)[(tu.y << syr) >> 2,
                                              (tu.x << sxr) >> 2] \
                == MODE_INTRA
            midx[k] = mat_row(scal_mats, (0 if intra else 3) + tu.comp)
    return coeffs, qp, rdpcm, midx


class _MatrixTable:
    """The level's distinct scaling matrices, uploaded once as one uint8
    table: per size, [L * 6, n, n] rows (list l, matrixId m at l * 6 + m),
    the lists keyed by object as _tu_bucket_entries caches them (a PPS
    list overrides the SPS one)."""

    def __init__(self, buckets, device):
        lists = {}
        for (_, _, _, _, _, scal, _), entries in buckets.items():
            if scal:
                for _, _, mats in entries:
                    lists.setdefault(id(mats), mats)
        if len(lists) * 6 > 256:
            raise ValueError("more scaling lists in a level than a one-byte "
                             "row index holds")
        self.row_of = {k: j for j, k in enumerate(lists)}
        self.tables = {}
        if not lists:
            return
        parts, offs, o = [], {}, 0
        for size_id in range(4):
            t = np.stack([mats[(size_id, m)] for mats in lists.values()
                          for m in range(6)])
            if t.min() < 1 or t.max() > 255:
                raise ValueError("scaling factor outside 1..255")
            parts.append(t.astype(np.uint8).reshape(-1))
            offs[size_id] = (o, t.shape)
            o += t.size
        flat = xfer.up(np.concatenate(parts), "coeff", device)
        for size_id, (o, shape) in offs.items():
            self.tables[4 << size_id] = flat[o:o + int(np.prod(shape))] \
                .view(shape)

    def row(self, mats, matrix_id):
        return self.row_of[id(mats)] * 6 + matrix_id


def _residual_planes_batch_device(items, Bp, device):
    """Device-resident residual build: every TU of every picture written
    into stacked [Bp, Hc, Wc] int32 device planes, one K1 launch per
    (bucket, component): flat dequant, scaling lists (one matrix table per
    level, a one-byte row per TU) or transquant bypass, with the bucket's
    rotation and each TU's RDPCM direction.  Only the coefficient buckets,
    the table and the indices are uploaded.
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
    table = _MatrixTable(buckets, device)
    for (n, use_dst, path, bd, rotate, scal, max_dyn), entries \
            in buckets.items():
        coeffs, qp, rdpcm, midx = _bucket_inputs(
            items, entries, n, table.row if scal else None)
        if max_dyn != 15:
            raise NotImplementedError("not ported: extended precision")
        if coeffs.min(initial=0) < -32768 or coeffs.max(initial=0) > 32767:
            raise ValueError("coefficient level outside the int16 range")
        comp_arr = np.asarray([items[b]["pic"].tu_list[i].comp
                               for b, i, _ in entries])
        bsel = np.asarray([b for b, _, _ in entries], np.int32)
        ysel = np.asarray([items[b]["pic"].tu_list[i].y
                           for b, i, _ in entries], np.int32)
        xsel = np.asarray([items[b]["pic"].tu_list[i].x
                           for b, i, _ in entries], np.int32)
        bypass = path == "bypass"
        for c in range(ncomp):
            sel = np.nonzero(comp_arr == c)[0]
            if not len(sel):
                continue
            TK.residual_scatter(
                res_stacked[c],
                xfer.up(coeffs[sel].astype(np.int16), "coeff", device),
                None if bypass else
                xfer.up(qp[sel].astype(np.int8), "coeff", device),
                xfer.up(bsel[sel], "idx", device),
                xfer.up(ysel[sel], "idx", device),
                xfer.up(xsel[sel], "idx", device),
                n=n, use_dst=use_dst, tskip=path == "tskip", bd=bd,
                bypass=bypass, mats=table.tables[n] if scal else None,
                midx=xfer.up(midx[sel], "idx", device) if scal else None,
                rotate=rotate,
                rdpcm=xfer.up(rdpcm[sel].astype(np.int8), "coeff", device)
                if rdpcm[sel].any() else None)
    # cross-component prediction (4:4:4), once every luma residual of the
    # level is final: one K10 launch per chroma component over its TUs of
    # every size
    ccp = {}
    for b, it in enumerate(items):
        if it["sps"].chroma_format_idc != 3:
            continue
        for tu in it["pic"].tu_list:
            if tu.comp and tu.cross_comp_alpha:
                ccp.setdefault(tu.comp, []).append(
                    (b, tu.y, tu.x, tu.w, tu.cross_comp_alpha))
    for c, rows in sorted(ccp.items()):
        CK.ccp_apply(res_stacked[c], res_stacked[0],
                     xfer.up(np.asarray(rows, np.int32), "idx", device))
    return res_stacked


# ---------------------------------------------------------------------------
def _intra_batch(items, comp, stacked, res_stacked, device):
    """Batched intra wavefront over all pictures for one component.

    stacked: device [Bp, Hc, Wc] planes (updated in place and returned);
    res_stacked: device [Bp, Hc, Wc] residual planes, read by the kernel.
    One K2 launch over every level of every picture.
    """
    sps = items[0]["sps"]
    ssx = sps.chroma_shift_x() if comp else 0
    ssy = sps.chroma_shift_y() if comp else 0
    bd = sps.bit_depth_luma if comp == 0 else sps.bit_depth_chroma
    table = intra_meta(items, comp, device)
    if table is not None:
        IK.intra_wavefront(stacked, res_stacked, table, is_luma=comp == 0,
                           bd=bd, W=sps.width >> ssx, H=sps.height >> ssy)
    return stacked


def intra_table(items, comp):
    """The flat block table of one component's intra wavefront over the
    pictures `items` (picture b = its index): a numpy array of
    IK.BLOCK_DTYPE rows, real blocks only, sorted stably by dependency
    level, the levels renumbered densely from 0, and the block count of
    each level; None when no picture has an intra block."""
    if len(items) > 32767:
        raise ValueError("intra_table: more pictures than an int16 holds")
    sps = items[0]["sps"]
    W = sps.width >> (sps.chroma_shift_x() if comp else 0)
    parts = []
    for b, it in enumerate(items):
        levels, _ = prepare_component(
            it["sps"], it["pic"], it["zmap"], it["tile_map"], comp, None,
            bool(it["pps"].constrained_intra_pred))
        for n, d in sorted((levels or {}).items()):
            li, ki = np.nonzero(d["xs"] < W)         # real slots
            if not len(li):
                continue
            rows = np.zeros(len(li), IK.BLOCK_DTYPE)
            rows["b"] = b
            rows["x"] = d["xs"][li, ki]
            rows["y"] = d["ys"][li, ki]
            rows["mode"] = d["mode"][li, ki]
            rows["nf"] = (n.bit_length() - 1) | (d["flags"][li, ki] << 4)
            rows["level"] = li
            av = d["av"][li, ki]
            rows["av"][:, :av.shape[1]] = av
            parts.append(rows)
    if not parts:
        return None
    rows = np.concatenate(parts)
    # (concatenating and indexing drop the padding of the row layout)
    rows = rows[np.argsort(rows["level"], kind="stable")] \
        .astype(IK.BLOCK_DTYPE)
    _, level, count = np.unique(rows["level"], return_inverse=True,
                                return_counts=True)
    rows["level"] = level.reshape(-1)
    return rows, count.astype(np.int32)


def intra_meta(items, comp, device):
    """The uploaded table of one component's intra wavefront (intra_table):
    {"blocks": uint8 [N, 32], "count": int32 [L]} on `device`, or None."""
    built = intra_table(items, comp)
    if built is None:
        return None
    rows, count = built
    return {"blocks": xfer.up(rows.view(np.uint8).reshape(len(rows), -1),
                              "intra_blocks", device),
            "count": xfer.up(count, "intra_count", device)}


# ---------------------------------------------------------------------------
def decode_intra_batch(data, *, device="cuda", check_sei_hash=False):
    """Decode an all-intra Annex-B stream with every picture in one set of
    launches on `device` (the card by default; the CPU runs the plain torch
    versions of the kernels).

    Port of libhm_tpu/parallel/batch_decode.py decode_intra_batch.  An
    all-intra stream is one reference-DAG level, so this is
    dag_decode._recon_levels on the collected pictures: residuals (K1),
    PCM (K9), the intra wavefront over the picture axis (K2, which gathers
    the residual from the device plane where the JAX host-planes mode ships
    it per slot), deblocking (K3), SAO (K4) and restore (K8).  Returns the
    DecodedPictures in decode (collect) order with host planes and, when
    `check_sei_hash`, their hash_status.  Raises ValueError on a stream
    with inter pictures or with mixed picture geometry.
    """
    from ..hostdec.decoder import Decoder
    from .dag_decode import (_check_device, _check_geometry, _materialize,
                             _recon_levels)

    device = _check_device(device, "decode_intra_batch")
    # the hash SEIs are kept only when the control plane checks them
    dec = Decoder(parse="native", recon="collect",
                  check_sei_hash=check_sei_hash)
    dec.decode_annexb(data)
    items = getattr(dec, "collected", [])
    if not items:
        return []
    for it in items:
        if it["pic"].inter_list:
            raise ValueError("decode_intra_batch: stream has inter "
                             "pictures; batching needs an all-intra stream")
    _check_geometry(items, "decode_intra_batch")
    _materialize(dec, _recon_levels(items, device), check_sei_hash)
    dps = [it["dp"] for it in items]
    for dp in dps:
        # the caller gets host pictures; nothing else reads these planes
        del dp._device_planes
    return dps
