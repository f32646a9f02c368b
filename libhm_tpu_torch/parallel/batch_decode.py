"""Cross-picture batched residual planes and intra wavefront.

Port of the device-resident half of libhm_tpu/parallel/batch_decode.py:

 - residual build: every TU of every picture of the level in one flat
   table per component (residual_tables), uploaded at once, and one K1
   launch per component (ops/transform.py residual_table) that dequantizes
   (with the level's scaling matrices where a TU has them), inverse
   transforms and writes straight into the stacked [Bp, Hc, Wc] planes, or
   writes the coefficients of transquant-bypass TUs as they are; in
   4:4:4, the chroma launches add cross-component prediction from the
   finished luma residual to the TUs that carry an alpha, before their
   one store (K1's epilogue);
 - intra wavefront: each picture's levelized blocks (intra_wavefront.
   prepare_component) go into one flat table per component sorted by
   (picture, CTU row, dependency level), every block size mixed; the
   components' tables join into one (ops/intra.py fuse), and one K2 launch
   (ops/intra.py intra_wavefronts) reconstructs every component, one CTA a
   (picture, component, CTU row) walking its row level by level.
"""
import numpy as np
import torch

from ..hostdec.picture import MODE_INTRA

from ..ops import intra as IK
from ..ops import transform as TK
from ..utils import obs, xfer
from .intra_wavefront import prepare_component


# ---------------------------------------------------------------------------
_ROW_FIELDS = ("b", "y", "x", "log2n", "qp", "flags", "rdpcm", "midx", "bd",
               "alpha")


def residual_tables(items):
    """The flat TU tables of one level: for each component, every TU of
    every picture (picture b = its index in `items`) as one K1 table.

    Replaces the JAX package's bucketing by (size, DST, path, bit depth,
    rotation, scaling) (libhm_tpu/parallel/batch_decode.py
    _tu_bucket_entries / _bucket_inputs, whose per-TU decisions are copied
    here), which only serves XLA's compile cache.  Returns (tables, lists):
    tables[c] = (rows, coeffs, counts, flags) with rows a numpy TU_DTYPE
    array sorted stably by size, coeffs the packed int16 coefficients in
    row order (each TU's offset a multiple of 16; int32 in a table with
    an F_EXT row), counts the rows of each size of TK.SIZES and flags the
    OR of the rows' flags; lists the
    level's distinct scaling lists in the order of their matrix-table rows
    (a scaled row's midx is 6 * list + matrixId), keyed by object as the
    JAX package caches them (a PPS list overrides the SPS one).  A 4:4:4
    chroma TU with a cross-component alpha (coded residual or not: the
    parser lists CCP-only TUs with zero coefficients) gets F_CCP and the
    alpha in its rdpcm byte (TK.ccp_bits).  A TU of a picture whose SPS
    sets extended_precision_processing_flag, at a bit depth where it
    matters (bd + 6 > 15), gets F_EXT.
    """
    from ..hostdec.tables import build_scaling_matrices
    if len(items) > 32767:
        raise ValueError("residual_tables: more pictures than an int16 holds")
    sps0 = items[0]["sps"]
    ncomp = 3 if sps0.chroma_format_idc else 1
    built, lists = {}, {}
    parts = [[([], []) for _ in TK.SIZES] for _ in range(ncomp)]
    for b, it in enumerate(items):
        sps, pic = it["sps"], it["pic"]
        scal_mats = None
        if sps.scaling_list_enabled:
            data = getattr(it["pps"], "scaling_list_data", None)
            if data is None:
                data = sps.scaling_list_data
            if id(data) not in built:
                built[id(data)] = build_scaling_matrices(data)
            scal_mats = built[id(data)]
        pred_mode = np.asarray(pic.pred_mode)
        rotation = bool(sps.transform_skip_rotation)
        ccp = sps.chroma_format_idc == 3
        for tu in pic.tu_list:
            c = tu.comp
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            sx = sps.chroma_shift_x() if c else 0
            sy = sps.chroma_shift_y() if c else 0
            bypass, tskip = bool(tu.tq_bypass), bool(tu.transform_skip)
            if bypass:
                flags = TK.F_BYPASS
            elif not 8 <= bd <= 16 or (tu.use_dst and tu.w != 4 and
                                       not tskip):
                raise ValueError(f"residual_tables: unsupported n={tu.w} "
                                 f"use_dst={tu.use_dst} bd={bd}")
            else:
                flags = TK.F_TSKIP if tskip else TK.F_DST * bool(tu.use_dst)
            if sps.extended_precision and bd + 6 > 15:
                flags |= TK.F_EXT
            rotatable = rotation and tu.w == 4 and (bypass or tskip)
            scaled = scal_mats is not None and not bypass and \
                not (tskip and tu.w > 4)
            intra = (rotatable or scaled) and pred_mode[
                (tu.y << sy) >> 2, (tu.x << sx) >> 2] == MODE_INTRA
            if rotatable and intra:
                flags |= TK.F_ROTATE
            midx = 0
            if scaled:
                j = lists.setdefault(id(scal_mats), (len(lists),
                                                     scal_mats))[0]
                if j * 6 + 5 > 255:
                    raise ValueError("more scaling lists in a level than a "
                                     "one-byte row index holds")
                flags |= TK.F_SCALED
                midx = j * 6 + (0 if intra else 3) + c
            alpha = tu.cross_comp_alpha if ccp and c else 0
            if alpha:
                flags |= TK.F_CCP
            rows, blocks = parts[c][TK.SIZES.index(tu.w)]
            rows.append((b, tu.y, tu.x, tu.w.bit_length() - 1, tu.qp,
                         flags, tu.rdpcm_mode, midx, bd, alpha))
            blocks.append(tu.coeffs)
    tables = []
    for c in range(ncomp):
        row_list = [r for rows, _ in parts[c] for r in rows]
        rows = np.zeros(len(row_list), TK.TU_DTYPE)
        coeffs = np.zeros(0, np.int16)
        flags = 0
        if row_list:
            a = np.asarray(row_list, np.int64)
            for j, name in enumerate(_ROW_FIELDS[:-1]):
                rows[name] = a[:, j]
            rows["rdpcm"] |= TK.ccp_bits(a[:, -1])
            flags = int(np.bitwise_or.reduce(rows["flags"]))
            sizes = np.left_shift(1, 2 * a[:, 3])
            rows["off"] = np.cumsum(sizes) - sizes
            c32 = np.concatenate([blk.reshape(-1) for _, blocks in parts[c]
                                  for blk in blocks]).astype(np.int32)
            if flags & TK.F_EXT:
                coeffs = c32
            elif c32.min() < -32768 or c32.max() > 32767:
                raise ValueError("coefficient level outside the int16 range")
            else:
                coeffs = c32.astype(np.int16)
        tables.append((rows, coeffs, tuple(len(r) for r, _ in parts[c]),
                       flags))
    return tables, [m for _, m in sorted(lists.values(), key=lambda v: v[0])]


def upload_tables(tables, device):
    """The TK.TuTable of each component of residual_tables' tables, from
    ONE upload of every component's rows and coefficients (each part at a
    16-byte boundary of the buffer; int16 coefficients, or int32 where the
    table has an F_EXT row)."""
    parts, spans, o = [], [], 0
    for rows, coeffs, _, _ in tables:
        for a in (rows.view(np.uint8).reshape(-1), coeffs.view(np.uint8)):
            pad = -a.nbytes % 16
            parts += [a, np.zeros(pad, np.uint8)]
            spans.append((o, a.nbytes))
            o += a.nbytes + pad
    buf = xfer.up(np.concatenate(parts), "coeff", device)
    out = []
    for k, (_, _, counts, flags) in enumerate(tables):
        (ro, rn), (co, cn) = spans[2 * k], spans[2 * k + 1]
        # (a component with no TU: empty views of an empty buffer)
        src = buf if rn else buf.new_zeros(0)
        out.append(TK.TuTable(src[ro:ro + rn].view(-1, TK.TU_DTYPE.itemsize),
                              src[co:co + cn].view(TK.coeff_dtype(flags)),
                              counts, flags))
    return out


class _MatrixTable:
    """The level's distinct scaling matrices, uploaded once as one uint8
    table: per size, [L * 6, n, n] rows (list l, matrixId m at l * 6 + m),
    the lists in the order residual_tables gives them."""

    def __init__(self, lists, device):
        self.tables = {}
        if not lists:
            return
        parts, offs, o = [], {}, 0
        for size_id in range(4):
            t = np.stack([mats[(size_id, m)] for mats in lists
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


def _residual_planes_batch_device(items, Bp, device):
    """Device-resident residual build: every TU of every picture written
    into stacked [Bp, Hc, Wc] int32 device planes, one K1 launch per
    component over the level's flat TU table (residual_tables): flat
    dequant, scaling lists (one matrix table per level, a one-byte row per
    TU) or transquant bypass, each TU with its rotation and RDPCM
    direction, and in 4:4:4 the chroma launches with the luma residual for
    their CCP rows.  One upload holds every component's table and
    coefficients, one more the scaling matrices where the level has any.
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
    with obs.span("prep.residual") as span:
        tables, lists = residual_tables(items)
        span.n = sum(len(rows) for rows, _, _, _ in tables)
    mats = _MatrixTable(lists, device).tables
    # luma first: the chroma launches' CCP rows read its finished residual,
    # scaled by the two bit depths (H.265 8.6.6)
    ccp = dict(res_l=res_stacked[0],
               ccp_bd=(sps0.bit_depth_luma, sps0.bit_depth_chroma))
    for c, table in enumerate(upload_tables(tables, device)):
        TK.residual_table(res_stacked[c], table, mats,
                          **(ccp if table.flags & TK.F_CCP else {}))
    return res_stacked


# ---------------------------------------------------------------------------
def _intra_level(items, stacked, res_stacked, device):
    """Batched intra wavefront over all pictures and every component of a
    level: ONE K2 launch over every (picture, component, CTU row) that
    holds an intra block.

    stacked: device [Bp, Hc, Wc] planes of each component (updated in
    place); res_stacked: the residual planes, read by the kernel.
    """
    _intra(items, range(len(stacked)), stacked, res_stacked, device)
    return stacked


def _intra_batch(items, comp, stacked, res_stacked, device):
    """The intra wavefront of one component over all pictures (one K2
    launch): stacked, res_stacked its [Bp, Hc, Wc] planes (stacked updated
    in place and returned)."""
    _intra(items, (comp,), {comp: stacked}, {comp: res_stacked}, device)
    return stacked


def _intra(items, comps, stacked, res_stacked, device):
    """One K2 launch over the components `comps` of the pictures `items`
    (those with an intra block); stacked[c], res_stacked[c]: component
    c's planes."""
    sps = items[0]["sps"]
    table = intra_meta(items, comps, device)
    if table is None:
        return
    es = table["comps"]
    IK.intra_wavefronts(
        [stacked[c] for c in es], [res_stacked[c] for c in es], table,
        is_luma=[c == 0 for c in es],
        bd=[sps.bit_depth_chroma if c else sps.bit_depth_luma for c in es],
        W=[sps.width >> (sps.chroma_shift_x() if c else 0) for c in es],
        H=[sps.height >> (sps.chroma_shift_y() if c else 0) for c in es])


def intra_table(items, comp):
    """The flat block table of one component's intra wavefront over the
    pictures `items` (picture b = its index), as K2 reads it: a numpy
    array of IK.BLOCK_DTYPE rows, real blocks only, sorted by (picture,
    CTU row, dependency level), the levels renumbered densely from 0 over
    the launch; the int32 first row of each work unit (one per (picture,
    CTU row) that holds an intra block) with the row count at the end; log2
    of the CTU row's height, the component's (1 << log2_ctb) >> the
    vertical chroma shift; and the work of the call, IK.work(rows,
    row_start).  A block whose top edge is its CTU row's top edge while the
    row above is a unit of the table gets IK.F_CROSS: it reads samples that
    another CTA writes.  The first row of each chunk carries its block
    count (IK.mark_chunks).  None when no picture has an intra block."""
    if len(items) > 32767:
        raise ValueError("intra_table: more pictures than an int16 holds")
    sps = items[0]["sps"]
    W = sps.width >> (sps.chroma_shift_x() if comp else 0)
    log2h = sps.log2_ctb - (sps.chroma_shift_y() if comp else 0)
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
    _, level = np.unique(rows["level"], return_inverse=True)
    rows["level"] = level.reshape(-1)
    crow = rows["y"].astype(np.int64) >> log2h
    # (concatenating and indexing drop the padding of the row layout)
    order = np.lexsort((rows["level"], crow, rows["b"]))
    rows = rows[order].astype(IK.BLOCK_DTYPE)
    unit = (rows["b"].astype(np.int64) << 16) | crow[order]
    first = np.r_[True, unit[1:] != unit[:-1]]
    starts = np.flatnonzero(first)
    # the unit before a unit is the row above it when its key is one less
    above = np.r_[False, unit[starts][1:] == unit[starts][:-1] + 1]
    top = (rows["y"] & ((1 << log2h) - 1)) == 0
    cross = top & above[np.cumsum(first) - 1]
    rows["nf"] |= np.where(cross, IK.F_CROSS << 4, 0).astype(np.uint8)
    row_start = np.r_[starts, len(rows)].astype(np.int32)
    IK.mark_chunks(rows, row_start)
    return rows, row_start, log2h, IK.work(rows, row_start)


def intra_meta(items, comp, device):
    """The uploaded table of K2's launch over the components `comp` (one
    index, or a sequence of them, luma first) of the pictures `items`:
    each component's intra_table (a span "prep.intra" each), joined into
    one launch's table by IK.fuse over the components that have an intra
    block.  {"blocks": uint8 [N, 32] (one upload, "intra_blocks"),
    "units": int32 [2U + 1], IK.fuse's row_start then above (one upload,
    "intra_rows"), viewed as "row_start" and "above", on `device`;
    "comps": the components in the launch, "log2h": each one's CTU-row
    height; on the host, the rows, the call's "work" (IK.work, summed over
    the components) and "chain" (IK.chain of each component in turn)}, or
    None when no component has an intra block."""
    comps = (comp,) if isinstance(comp, int) else tuple(comp)
    parts = []
    for c in comps:
        with obs.span("prep.intra") as span:
            built = intra_table(items, c)
            span.n = 0 if built is None else len(built[0])
        if built is not None:
            parts.append((c, built))
    if not parts:
        return None
    rows, row_start, above = IK.fuse([(r, s, h) for _, (r, s, h, _)
                                      in parts])
    blocks = xfer.up(rows.view(np.uint8).reshape(len(rows), -1),
                     "intra_blocks", device)
    units = xfer.up(np.r_[row_start, above].astype(np.int32), "intra_rows",
                    device)
    U = len(above)
    work = {k: sum(w[k] for _, (_, _, _, w) in parts)
            for k in parts[0][1][3]}
    return {"blocks": blocks, "units": units, "row_start": units[:U + 1],
            "above": units[U + 1:], "comps": [c for c, _ in parts],
            "log2h": [h for _, (_, _, h, _) in parts], "rows": rows,
            "work": work,
            "chain": [lr for _, (r, s, h, _) in parts
                      for lr in IK.chain(r, s, h)]}


# ---------------------------------------------------------------------------
def decode_intra_batch(data, *, device=None, devices=None,
                       check_sei_hash=False):
    """Decode an all-intra Annex-B stream with every picture in one set of
    launches on `device` (the card by default; the CPU runs the plain torch
    versions of the kernels), or with the pictures split into contiguous
    shards of ceil(B / m) over the m devices of the list `devices`.

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
    from .dag_decode import (_check_devices, _check_geometry, _materialize,
                             _recon_levels)

    devices = _check_devices(device, devices, "decode_intra_batch")
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
    _materialize(dec, _recon_levels(items, devices), check_sei_hash)
    dps = [it["dp"] for it in items]
    for dp in dps:
        # the caller gets host pictures; nothing else reads these planes
        del dp._device_planes
    return dps
