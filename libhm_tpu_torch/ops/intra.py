"""Batched intra prediction, and the intra wavefront kernel (K2).

Port of libhm_tpu/ops/intra.py.  The 4n+1 border samples of a block live
in one "vals" row in spec scan order (bottom-left .. corner .. top-right,
Rec. H.265 8.4.4.2.2): left[k] = vals[2n-k], top[k] = vals[2n+k].  The
plain functions keep the JAX semantics on int32 tensors; `intra_wavefront`
(one component) and `intra_wavefronts` (every component of a level) are
the kernel wrappers that reconstruct every intra block (gather ->
substitute -> filter -> predict -> + residual -> clip -> store) as one
persistent CUDA launch (csrc/intra.cu) for CUDA planes, one CTA a
(picture, component, CTU row) walking its row level by level, and through
the plain functions, component by component and level after level, for
CPU planes.
"""
import ctypes
import functools

import numpy as np
import torch

from ..hostdec.refimpl import ANG_TABLE

from ..kernels.build import I, P, Kernel, check, ptr
from ..utils import obs

_INV_ANGLE = {-2: 4096, -5: 1638, -9: 910, -13: 630, -17: 482,
              -21: 390, -26: 315, -32: 256}


# ---------------------------------------------------------------------------
# static tables
@functools.lru_cache(maxsize=None)
def _border_offsets(n):
    """vals-scan-order border coordinates relative to the block origin.

    Copied from libhm_tpu/ops/intra.py (_border_offsets).
    """
    T = 4 * n + 1
    offx = np.empty(T, np.int32)
    offy = np.empty(T, np.int32)
    for i in range(2 * n):
        offx[i], offy[i] = -1, 2 * n - 1 - i
    offx[2 * n], offy[2 * n] = -1, -1
    for i in range(2 * n):
        offx[2 * n + 1 + i], offy[2 * n + 1 + i] = i, -1
    return offx, offy


@functools.lru_cache(maxsize=None)
def _ang_tables(n):
    """Per-mode static gather tables for angular prediction at size n.

    Copied from libhm_tpu/ops/intra.py (_ang_tables).
    EXT_IDX[35, 3n+2]: vals index for extended-ref position p (ref index
      p - n); unused slots clamp to 2n (the corner).
    ROW[35, n], FRAC[35, n]: per-row base position into EXT and the 1/32
      interpolation fraction.
    VERT[35]: mode >= 18.
    """
    E = 3 * n + 2
    ext = np.full((35, E), 2 * n, np.int32)
    row = np.zeros((35, n), np.int32)
    frac = np.zeros((35, n), np.int32)
    vert = np.zeros(35, bool)
    for m in range(2, 35):
        ang = ANG_TABLE[m]
        vertical = m >= 18
        vert[m] = vertical

        def main_idx(i):       # main[i] -> vals index
            return 2 * n + i if vertical else 2 * n - i

        def side_idx(i):       # side[i] -> vals index
            return 2 * n - i if vertical else 2 * n + i

        if ang < 0:
            inv = _INV_ANGLE[ang]
            lo = (n * ang) >> 5
            for r in range(0, n + 1):
                ext[m, n + r] = main_idx(r)
            for r in range(-1, lo - 1, -1):
                ext[m, n + r] = side_idx(min((-r * inv + 128) >> 8, 2 * n))
        else:
            for r in range(0, 2 * n + 1):
                ext[m, n + r] = main_idx(r)
        for j in range(n):
            pos = (j + 1) * ang
            row[m, j] = n + 1 + (pos >> 5)
            frac[m, j] = pos & 31
    return ext, row, frac, vert


@functools.lru_cache(maxsize=None)
def _strong_weights(n):
    """Static weight vectors for the strong bilinear filter (n=32 only).

    Copied from libhm_tpu/ops/intra.py (_strong_weights).
    """
    T = 4 * n + 1
    wc = np.empty(T, np.int32)   # weight of the corner
    we = np.empty(T, np.int32)   # weight of the far edge (bl / tr)
    for p in range(T):
        if p <= 2 * n:
            wc[p], we[p] = p, 2 * n - p
        else:
            wc[p], we[p] = 4 * n - p, p - 2 * n
    return wc, we


def _t(a, device):
    return torch.as_tensor(a, device=device)


# ---------------------------------------------------------------------------
def border_coords(x, y, n, W, H):
    """Clamped border gather coordinates for blocks at (x, y) [B]."""
    offx, offy = _border_offsets(n)
    cx = x[:, None] + _t(offx, x.device)[None, :]
    cy = y[:, None] + _t(offy, y.device)[None, :]
    return torch.clamp(cx, 0, W - 1), torch.clamp(cy, 0, H - 1)


def substitute(gathered, avail, bit_depth):
    """Reference-sample substitution (Rec. 8.4.4.2.2).

    gathered, avail: [B, T]; forward-fills unavailable samples from the
    nearest available one at a lower scan index; leading gap backfills
    from the first available; all-unavailable -> DC default.
    """
    B, T = gathered.shape
    pos = torch.arange(T, dtype=torch.int32, device=gathered.device)[None, :]
    idx = torch.where(avail, pos, -1)
    src = torch.cummax(idx, dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1).to(torch.int32)
    src = torch.where(src < 0, first[:, None], src)
    vals = torch.gather(gathered, 1, src.long())
    dc = 1 << (bit_depth - 1)
    return torch.where(avail.any(dim=1)[:, None], vals, dc).to(torch.int32)


def filter_refs(vals, n, bit_depth, filter_flag, strong_flag):
    """[1 2 1] smoothing + strong bilinear filter (Rec. 8.4.4.2.3).

    vals: [B, 4n+1]; filter_flag: [B] use_filtered_refs decision;
    strong_flag: [B] strong smoothing allowed (sps flag & luma & n==32) —
    the value-dependent threshold test happens here.
    """
    sm = torch.cat([
        vals[:, :1],
        (vals[:, :-2] + 2 * vals[:, 1:-1] + vals[:, 2:] + 2) >> 2,
        vals[:, -1:],
    ], dim=1)
    out = sm
    if n == 32:
        c = vals[:, 2 * n]
        bl = vals[:, 0]
        tr = vals[:, 4 * n]
        thr = 1 << (bit_depth - 5)
        f1 = torch.abs(c + tr - 2 * vals[:, 3 * n]) < thr
        f2 = torch.abs(c + bl - 2 * vals[:, n]) < thr
        wc, we = (_t(w, vals.device) for w in _strong_weights(n))
        pos = torch.arange(4 * n + 1, device=vals.device)[None, :]
        edge = torch.where(pos <= 2 * n, bl[:, None], tr[:, None])
        strong = (wc[None, :] * c[:, None] + we[None, :] * edge + n) >> 6
        out = torch.where((strong_flag & f1 & f2)[:, None], strong, sm)
    return torch.where(filter_flag[:, None], out, vals).to(torch.int32)


def predict(vals, mode, n, comp_is_luma, bit_depth, disable_bf):
    """Batched intra prediction (Rec. 8.4.4.2.4-6).

    vals: [B, 4n+1] (already substituted + filtered); mode: [B] int32
    (after any 4:2:2 angle mapping); disable_bf: [B] bool (implicit-RDPCM
    lossless edge-filter disable — gates mode 10/26 filters, not DC's).
    Returns [B, n, n] int32.
    """
    dev = vals.device
    B = vals.shape[0]
    maxv = (1 << bit_depth) - 1
    log2n = n.bit_length() - 1
    t1n = vals[:, 2 * n + 1:3 * n + 1]                       # top[1..n]
    l1n = torch.flip(vals[:, n:2 * n], (1,))                 # left[1..n]
    # planar (8.4.4.2.4)
    tr = vals[:, 3 * n + 1]
    bl = vals[:, n - 1]
    xx = torch.arange(n, dtype=torch.int32, device=dev)
    hor = ((n - 1 - xx)[None, None, :] * l1n[:, :, None] +
           (xx + 1)[None, None, :] * tr[:, None, None])
    ver = ((n - 1 - xx)[None, :, None] * t1n[:, None, :] +
           (xx + 1)[None, :, None] * bl[:, None, None])
    planar = (hor + ver + n) >> (log2n + 1)
    # DC (8.4.4.2.5); boundary filter unconditional for luma n<32
    dc = ((t1n.sum(dim=1) + l1n.sum(dim=1) + n) >> (log2n + 1)).to(torch.int32)
    dcp = dc[:, None, None].expand(B, n, n).clone()
    if comp_is_luma and n < 32:
        dcp[:, 0, :] = (t1n + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (l1n + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (vals[:, 2 * n - 1] + 2 * dc + vals[:, 2 * n + 1] + 2) >> 2
    # angular (8.4.4.2.6)
    ext_t, row_t, frac_t, vert_t = (_t(a, dev) for a in _ang_tables(n))
    ml = mode.long()
    ext = torch.gather(vals, 1, ext_t[ml].long())            # [B, 3n+2]
    rowb = row_t[ml]                                         # [B, n]
    frac = frac_t[ml]                                        # [B, n]
    gidx = (rowb[:, :, None] + xx[None, None, :]).reshape(B, -1).long()
    E = ext.shape[1]
    a = torch.gather(ext, 1, gidx).reshape(B, n, n)
    b = torch.gather(ext, 1, torch.clamp(gidx + 1, max=E - 1)).reshape(B, n, n)
    f = frac[:, :, None]
    ang = ((32 - f) * a + f * b + 16) >> 5
    vert = vert_t[ml]
    ang = torch.where(vert[:, None, None], ang, ang.transpose(1, 2))
    if comp_is_luma and n < 32:
        # exactly-vertical/-horizontal boundary filters
        corner = vals[:, 2 * n]
        v26 = torch.clamp(vals[:, 2 * n + 1][:, None] +
                          ((l1n - corner[:, None]) >> 1), 0, maxv)
        h10 = torch.clamp(vals[:, 2 * n - 1][:, None] +
                          ((t1n - corner[:, None]) >> 1), 0, maxv)
        use26 = ((mode == 26) & ~disable_bf)[:, None]
        use10 = ((mode == 10) & ~disable_bf)[:, None]
        ang = ang.clone()
        ang[:, :, 0] = torch.where(use26, v26, ang[:, :, 0])
        ang[:, 0, :] = torch.where(use10, h10, ang[:, 0, :])
    m = mode[:, None, None]
    return torch.where(m == 0, planar,
                       torch.where(m == 1, dcp, ang)).to(torch.int32)


def _reconstruct(plane, res_plane, bidx, xs, ys, mode, filt, strong, dbf,
                 av, *, n, is_luma, bd, W, H):
    """Reconstruct independent size-n blocks of pictures `bidx` at (xs,
    ys) in place: gather, substitute, filter, predict, + residual, clip."""
    cx, cy = border_coords(xs, ys, n, W, H)
    g = plane[bidx[:, None], cy.long(), cx.long()]
    vals = substitute(g, av, bd)
    vals = filter_refs(vals, n, bd, filt, strong)
    pred = predict(vals, mode, n, is_luma, bd, dbf)
    ar = torch.arange(n, device=plane.device)
    iy = (ys[:, None, None] + ar[None, :, None]).long()
    ix = (xs[:, None, None] + ar[None, None, :]).long()
    ib = bidx[:, None, None]
    out = torch.clamp(pred + res_plane[ib, iy, ix], 0, (1 << bd) - 1)
    shp = out.shape
    plane[ib.expand(shp), iy.expand(shp), ix.expand(shp)] = out
    return plane


def intra_level_plain(plane, res_plane, meta, level, *, n, is_luma, bd, W,
                      H):
    """One dependency level of the size-n blocks of the per-size slot
    layout of prepare_component (meta: [Bp, L, K] arrays; dummy slots have
    x = W + 1024), in place: the JAX scan's step for one size."""
    # imported here: parallel.intra_wavefront imports this module
    from ..parallel.intra_wavefront import unpack_block_meta
    Bp, _, K = meta["xs"].shape
    d = {k: v[:, level].reshape((Bp * K,) + v.shape[3:])
         for k, v in meta.items()}
    keep = torch.nonzero(d["xs"] < W).squeeze(1)
    if not keep.numel():
        return plane
    xs, ys, mode, filt, strong, dbf, av = unpack_block_meta(
        {k: v[keep] for k, v in d.items()}, n)
    bidx = torch.div(keep, K, rounding_mode="floor")
    return _reconstruct(plane, res_plane, bidx, xs, ys, mode, filt, strong,
                        dbf, av, n=n, is_luma=is_luma, bd=bd, W=W, H=H)


# ---------------------------------------------------------------------------
# K2: the whole wavefront of every component, every picture, one launch
#
# One row of the flat block table, 32 bytes, as csrc/intra.cu reads it:
# picture, position, intra mode (after any 4:2:2 mapping), log2 of the size
# in the low nibble of `nf` and the flags (1 filt, 2 strong, 4 dbf, 8
# cross: reads the CTU row above, which another CTA writes) in the high
# one, the dependency level (0-based, dense over the component's blocks of
# the launch), the availability bits of the 4n+1 border samples,
# little-endian, padded to (4 * 32 + 8) >> 3 bytes, on the first row of
# each chunk its block count, and the row's component: its index among the
# launch's components.  A work unit is the blocks of one (picture,
# component, CTU row), by level; units follow one another in ticket order
# (`fuse`), `row_start` gives the first row of each and `above` the unit of
# its row above.  A chunk is what the kernel reconstructs at once: the next
# blocks of one level of one unit, at most CHUNK_BLOCKS of them and
# CHUNK_SAMPLES samples.
AV_BYTES = (4 * 32 + 8) >> 3
BLOCK_DTYPE = np.dtype({
    "names": ["b", "x", "y", "mode", "nf", "level", "av", "chunk", "comp"],
    "formats": ["<i2", "<i2", "<i2", "i1", "u1", "<i4", ("u1", AV_BYTES),
                "u1", "u1"],
    "offsets": [0, 2, 4, 6, 7, 8, 12, 29, 30], "itemsize": 32})
F_CROSS = 8
CHUNK_BLOCKS, CHUNK_SAMPLES = 8, 8 * 256     # csrc/intra.cu kWarps, kChunk
MAX_COMPONENTS = 3                           # csrc/intra.cu kComps

_K2 = Kernel("intra_wavefront", [P, I, P, P, P, I, I,
                                 ctypes.POINTER(ctypes.c_int)])
_STRIDE = 32                 # ints between progress counters (csrc/intra.cu)

# K2's work, summed over its calls beside _K2.launches (CPU calls too),
# from the host table (`work`): work units (picture, component, CTU row),
# steps (a level of a unit: a barrier inside an SM) and cross steps (steps
# holding an F_CROSS block: the ones that can wait on another SM); blocks,
# and plane_blocks, those with a sample at or past the lattice's width
# that the launch reported for their component (0 on the CPU, which has
# no lattice); the chain terms (`chain`) summed over (picture, component)
# chains: levels and hand-overs between CTU rows; and components, the
# components each call covers.  Each call also records them per launch
# through utils/obs.py: a span "k2" (n = blocks) around the launch,
# holding the counts "k2.components", then per component in the launch's
# order (luma first) "k2.lattice" (its lattice's columns; CUDA only) and
# "k2.plane_blocks", then per (picture, component) chain in order,
# "k2.levels" then "k2.handovers".
WORK = {"rows": 0, "steps": 0, "cross_steps": 0, "blocks": 0,
        "plane_blocks": 0, "levels": 0, "handovers": 0, "components": 0}


def _steps(rows, row_start):
    """True on the first row of each step (a level of a unit) of a sorted
    table."""
    level = rows["level"]
    first = np.ones(len(rows), bool)
    first[1:] = level[1:] != level[:-1]
    first[row_start[:-1]] = True
    return first


def work(rows, row_start):
    """The work of one K2 call on a sorted table: {"rows": units, "steps":
    distinct levels summed over units, "cross_steps": steps holding an
    F_CROSS block}."""
    first = _steps(rows, row_start)
    sid = np.cumsum(first) - 1
    cross = ((rows["nf"] >> 4) & F_CROSS) != 0
    return {"rows": len(row_start) - 1, "steps": int(first.sum()),
            "cross_steps": len(np.unique(sid[cross]))}


def chain(rows, row_start, log2h):
    """The dependency chain of each picture of a sorted table, in picture
    order: [(L, R)], L its levels (prepare_component's: each picture's
    levels run densely from 0, so L is its highest plus one) and R its
    hand-overs, the units whose row above is a unit too (its CTU rows less
    one where every row holds an intra block)."""
    b = rows["b"]
    L = np.maximum.reduceat(rows["level"],
                            np.flatnonzero(np.r_[True, b[1:] != b[:-1]])) + 1
    ub = b[row_start[:-1]]
    crow = rows["y"][row_start[:-1]].astype(np.int64) >> log2h
    above = np.r_[False, (ub[1:] == ub[:-1]) & (crow[1:] == crow[:-1] + 1)]
    R = np.add.reduceat(above.astype(np.int64),
                        np.flatnonzero(np.r_[True, ub[1:] != ub[:-1]]))
    return list(zip(L.tolist(), R.tolist()))


def plane_blocks(rows, lattice):
    """The blocks of a table with a sample at x >= lattice: they write past
    K2's shared-memory lattice, and their borders there are read from the
    plane."""
    right = rows["x"].astype(np.int64) + \
        (1 << (rows["nf"] & 15).astype(np.int64))
    return int(np.count_nonzero(right > lattice))


def fuse(parts):
    """One launch's table from the tables of its components: parts[i] =
    (rows, row_start, log2h) of component i, each sorted by (picture, CTU
    row, level) with one unit per (picture, CTU row) (as
    batch_decode.intra_table builds them).  Returns (rows, row_start,
    above): the rows with their comp byte set to i, unit after unit in
    ticket order, (component, CTU row, picture); the first row of each
    unit, then the row count; and the unit of each unit's row above (the
    same picture and component, one CTU row up), -1 where there is none.
    Every unit's row above comes earlier (csrc/intra.cu: why it cannot
    deadlock); its levels, chunks and F_CROSS marks are its component
    table's."""
    if not 1 <= len(parts) <= MAX_COMPONENTS:
        raise ValueError(f"fuse: {len(parts)} components, expected 1 to "
                         f"{MAX_COMPONENTS}")
    codes, starts, lens, off = [], [], [], 0
    for i, (rows, row_start, log2h) in enumerate(parts):
        s = row_start[:-1].astype(np.int64)
        crow = rows["y"][s].astype(np.int64) >> log2h
        # (component, CTU row, picture) as one sortable key
        codes.append((i << 48) | (crow << 16) | rows["b"][s].astype(np.int64))
        starts.append(s + off)
        lens.append(np.diff(row_start).astype(np.int64))
        off += len(rows)
    code, start, n = (np.concatenate(a) for a in (codes, starts, lens))
    order = np.argsort(code, kind="stable")
    code, start, n = code[order], start[order], n[order]
    first = np.r_[0, np.cumsum(n)]
    idx = np.repeat(start - first[:-1], n) + np.arange(first[-1])
    # (concatenating and indexing drop the padding of the row layout)
    rows = np.concatenate([r for r, _, _ in parts])
    rows["comp"] = np.repeat(np.arange(len(parts)),
                             [len(r) for r, _, _ in parts])
    rows = rows[idx].astype(BLOCK_DTYPE)
    up = code - (1 << 16)
    j = np.minimum(np.searchsorted(code, up), len(code) - 1)
    above = np.where(code[j] == up, j, -1).astype(np.int32)
    return rows, first.astype(np.int32), above


def _count(table, lattices):
    """Add one call's work to WORK and record it under the open "k2"
    span; lattices: each component's lattice width (None on the CPU)."""
    rows, comps = table["rows"], table["comps"]
    for k, v in table["work"].items():
        WORK[k] += v
    WORK["blocks"] += len(rows)
    WORK["components"] += len(comps)
    obs.count("k2.components", len(comps))
    for i in range(len(comps)):
        plane = 0
        if lattices is not None:
            obs.count("k2.lattice", lattices[i])
            plane = plane_blocks(rows[rows["comp"] == i], lattices[i])
        WORK["plane_blocks"] += plane
        obs.count("k2.plane_blocks", plane)
    for levels, handovers in table["chain"]:
        WORK["levels"] += levels
        WORK["handovers"] += handovers
        obs.count("k2.levels", levels)
        obs.count("k2.handovers", handovers)


def mark_chunks(rows, row_start):
    """Set rows["chunk"]: the block count on the first row of each chunk
    (greedy over each step of each unit), 0 elsewhere."""
    starts = np.flatnonzero(_steps(rows, row_start))
    ends = np.r_[starts[1:], len(rows)]
    size = 1 << (2 * (rows["nf"] & 15).astype(np.int64))
    csum = np.r_[0, np.cumsum(size)]
    chunk = np.zeros(len(rows), np.uint8)
    small = (ends - starts <= CHUNK_BLOCKS) & \
        (csum[ends] - csum[starts] <= CHUNK_SAMPLES)
    chunk[starts[small]] = (ends - starts)[small]
    for s, e in zip(starts[~small], ends[~small]):
        i = s
        while i < e:
            j, tot = i, 0
            while j < e and j - i < CHUNK_BLOCKS and \
                    tot + size[j] <= CHUNK_SAMPLES:
                tot += size[j]
                j += 1
            chunk[i] = j - i
            i = j
    rows["chunk"] = chunk


def block_rows(table):
    """The table's rows as a numpy structured array (BLOCK_DTYPE)."""
    blocks = table["blocks"].cpu().numpy()
    return np.ascontiguousarray(blocks).view(BLOCK_DTYPE).reshape(-1)


def intra_wavefront_plain(plane, res_plane, table, *, is_luma, bd, W, H):
    """Plain torch version of intra_wavefront (any device): the table level
    by level, each level's blocks through the vectorized plain steps, one
    size at a time."""
    rows = block_rows(table)
    rows = rows[np.argsort(rows["level"], kind="stable")]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(plane.device)
    ends = np.flatnonzero(np.diff(rows["level"])) + 1
    for lv in np.split(rows, ends):
        log2n = lv["nf"] & 15
        for l2 in np.unique(log2n):
            n = 1 << int(l2)
            r = lv[log2n == l2]
            fl = r["nf"] >> 4
            av = np.unpackbits(r["av"], axis=1, bitorder="little")
            _reconstruct(plane, res_plane, t(r["b"].astype(np.int64)),
                         t(r["x"].astype(np.int32)),
                         t(r["y"].astype(np.int32)),
                         t(r["mode"].astype(np.int32)), t((fl & 1) != 0),
                         t((fl & 2) != 0), t((fl & 4) != 0),
                         t(av[:, :4 * n + 1] != 0), n=n, is_luma=is_luma,
                         bd=bd, W=W, H=H)
    return plane


def intra_wavefront(plane, res_plane, table, *, is_luma, bd, W, H,
                    _ctas=0):
    """Reconstruct every intra block of one component of every picture, in
    place: intra_wavefronts with one component.

    plane, res_plane: [Bp, Hc, Wc] int32 (plane updated).
    table: batch_decode.intra_meta's table of that component.
    W, H: the component's picture size (the plain version's border clamp;
    the kernel reads available samples only, all inside the picture).
    """
    intra_wavefronts([plane], [res_plane], table, is_luma=[is_luma],
                     bd=[bd], W=[W], H=[H], _ctas=_ctas)
    return plane


def intra_wavefronts(planes, res_planes, table, *, is_luma, bd, W, H,
                     _ctas=0):
    """Reconstruct every intra block of the table's components of every
    picture, in place: one CUDA launch for CUDA planes, in which one CTA
    at a time owns a (picture, component, CTU row) and walks its blocks
    level by level, waiting on the row above only before blocks that read
    it; the plain version, component by component, for CPU planes.

    planes, res_planes, is_luma, bd, W, H: one entry per component of the
    table, in its order (table["comps"]): [Bp, Hc, Wc] int32 planes (each
    updated) and residual planes, luma or not, bit depth and picture size.
    table: batch_decode.intra_meta's {"blocks": uint8 [N, 32] rows of
    BLOCK_DTYPE in unit order (fuse), "units": int32 [2U + 1], the first
    row of each work unit, then N, then the unit of each unit's row above
    (fuse's row_start and above, viewed as "row_start" and "above"), on
    the planes' device; "log2h": log2 of each component's CTU-row height;
    "comps": the components; on the host, "rows": the N rows, "work":
    work() and "chain": chain() of each component, in order}.
    _ctas: the grid's CTAs (0: every CTA the card holds at once); a test
    sets 1 to show that the ticket order alone orders the rows.
    """
    k = len(table["comps"])
    if not all(len(a) == k for a in (planes, res_planes, is_luma, bd, W, H)):
        raise ValueError(f"intra_wavefronts: the table has {k} components")
    with obs.span("k2", len(table["rows"])):
        if not planes[0].is_cuda:
            rows = table["rows"]
            for i in range(k):
                mine = rows[rows["comp"] == i]
                sub = {"blocks": torch.from_numpy(np.ascontiguousarray(mine)
                                                  .view(np.uint8)
                                                  .reshape(len(mine), -1))}
                intra_wavefront_plain(planes[i], res_planes[i], sub,
                                      is_luma=is_luma[i], bd=bd[i], W=W[i],
                                      H=H[i])
            _count(table, None)
        else:
            _count(table, _launch(planes, res_planes, table, is_luma, bd, W,
                                  H, _ctas))
    return planes


def _launch(planes, res_planes, table, is_luma, bd, W, H, ctas):
    """K2 on CUDA planes; returns each component's lattice width, as the
    launch chose it."""
    dev = planes[0].device
    blocks, units = table["blocks"], table["units"]
    check(blocks, "blocks", torch.uint8, 2, dev)
    check(units, "units", torch.int32, 1, dev)
    if blocks.shape[1] != BLOCK_DTYPE.itemsize:
        raise ValueError("intra_wavefront: table rows are not "
                         f"{BLOCK_DTYPE.itemsize} bytes")
    U = (units.shape[0] - 1) // 2
    comps = np.zeros((len(planes), 8), np.int64)
    for i, (plane, res_plane) in enumerate(zip(planes, res_planes)):
        check(plane, "plane", torch.int32, 3, dev)
        check(res_plane, "res_plane", torch.int32, 3, dev)
        if res_plane.shape != plane.shape:
            raise ValueError("intra_wavefront: plane/res_plane shapes differ")
        _, Hc, Wc = plane.shape
        if not 8 <= bd[i] <= 16 or W[i] > Wc or H[i] > Hc or \
                max(Wc, Hc) > 32767:
            raise ValueError(f"intra_wavefront: unsupported bd={bd[i]} "
                             f"W={W[i]} H={H[i]} planes {Hc}x{Wc}")
        comps[i] = (plane.data_ptr(), res_plane.data_ptr(), Hc, Wc,
                    table["log2h"][i], bd[i], int(bool(is_luma[i])), 0)
    lattice = (ctypes.c_int * len(planes))(*[p.shape[2] for p in planes])
    if U > 0:
        # the ticket counter, then one progress counter per unit
        sync = torch.zeros((U + 1) * _STRIDE, dtype=torch.int32, device=dev)
        _K2(comps.ctypes.data, len(planes), ptr(blocks), ptr(units),
            ptr(sync), U, int(ctas), lattice)
    return list(lattice)
