# Copied from libhm_tpu/hostdec/tables.py
"""Standard-mandated constant tables for HEVC decoding (Rec. H.265 clause 9.3
and 8.6) plus derived scan orders.

These replace the reference's ROM layer (reference: source/Lib/TLibCommon/
TComRom.cpp initROM, ContextTables.h, TComCABACTables.cpp) with numpy arrays
generated algorithmically where the standard defines structure (transform
matrices, scan orders) and literal spec-table values elsewhere (CABAC
initialisation / LPS tables — Rec. H.265 Tables 9-46/9-47 and 9-5..9-32).
"""
import numpy as np

CNU = 154  # context never used

# ---------------------------------------------------------------------------
# Core transform matrices (Rec. H.265 8.6.4.2).
# The 32-point integer DCT-II matrix is fully determined by a 32-entry base
# vector via cosine symmetry: M[k][n] = F(k*(2n+1) mod 128) where
# F(i) = base[i] in the first quadrant.  Smaller sizes subsample rows.
# ---------------------------------------------------------------------------
_DCT_BASE = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
             64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4]


def _dct_entry(idx: int) -> int:
    i = idx % 128
    if i < 32:
        return _DCT_BASE[i]
    if i == 32:
        return 0
    if i <= 64:
        return -_DCT_BASE[64 - i]
    if i < 96:
        return -_DCT_BASE[i - 64]
    return _DCT_BASE[128 - i]


def dct_matrix(n: int) -> np.ndarray:
    """NxN integer DCT matrix (forward: rows are basis vectors)."""
    step = 32 // n
    return np.array([[_dct_entry(k * step * (2 * j + 1)) for j in range(n)]
                     for k in range(n)], dtype=np.int32)


# 4x4 DST-VII (Rec. H.265 8.6.4.1)
DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int32)

DCT = {n: dct_matrix(n) for n in (4, 8, 16, 32)}

# Quantisation scales (Rec. H.265 8.6.3)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# Chroma QP mapping (Rec. H.265 Table 8-10), per chroma_format_idc 0..3
_CHROMA_SCALE_420 = list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                       36, 36, 37, 37, 38, 39, 40, 41, 42, 43,
                                       44, 45, 46, 47, 48, 49, 50, 51]
_CHROMA_SCALE_CLIP = [min(i, 51) for i in range(58)]
CHROMA_QP_SCALE = {
    0: [0] * 58,
    1: _CHROMA_SCALE_420,
    2: _CHROMA_SCALE_CLIP,
    3: _CHROMA_SCALE_CLIP,
}

# ---------------------------------------------------------------------------
# Default (flat + JCTVC default) scaling lists (Rec. H.265 7.4.5 / Table 7-5/6)
# ---------------------------------------------------------------------------
_DEF_SL_INTRA_8x8 = [
    16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29, 16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115]
_DEF_SL_INTER_8x8 = [
    16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28, 16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91]


def default_scaling_list(size_id: int, matrix_id: int):
    """Returns (coef_list in RASTER order, dc) — the HM g_quant*Default
    tables are raster (reference TComRom.cpp:648)."""
    if size_id == 0:
        return [16] * 16, 8
    src = _DEF_SL_INTRA_8x8 if matrix_id < 3 else _DEF_SL_INTER_8x8
    return list(src), 16


def build_scaling_matrices(data):
    """Dequant scaling matrices per (size_id, matrix_id).

    data: {(size_id, matrix_id): (raster_list, dc)} from the bitstream
    (params.parse_scaling_list_data) or None for the default lists.
    Mirrors reference TComTrQuant::processScalingListDec: nearest-neighbour
    upsample of the (max 8x8) base list, DC coefficient override at [0][0].
    32x32 chroma maps to the corresponding luma list (only listId 0/3 are
    coded at sizeId 3).
    """
    out = {}
    for size_id in range(4):
        n = 4 << size_id
        base = min(8, n)
        ratio = n // base
        for matrix_id in range(6):
            src_id = (matrix_id // 3) * 3 if size_id == 3 else matrix_id
            if data is not None and (size_id, src_id) in data:
                lst, dc = data[(size_id, src_id)]
            else:
                lst, dc = default_scaling_list(size_id, src_id)
            m = np.array(lst, np.int32).reshape(base, base)
            m = np.repeat(np.repeat(m, ratio, 0), ratio, 1)
            if ratio > 1:
                m[0, 0] = dc
            out[(size_id, matrix_id)] = m
    return out


# ---------------------------------------------------------------------------
# Scan orders (Rec. H.265 6.5.3): generated, not tabulated.
# scan_order(log2w, log2h, kind) -> array [(x, y)] in scan order.
# kind: 0 diag (up-right), 1 horizontal, 2 vertical
# HM's g_scanOrder equivalent (reference: TComRom.cpp initROM / initZscanToRaster)
# ---------------------------------------------------------------------------
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(w, h):
    out = []
    # HM/spec up-right diagonal: start at (0,0); within each anti-diagonal go
    # from bottom-left to top-right.
    for d in range(w + h - 1):
        y = min(d, h - 1)
        x = d - y
        while y >= 0 and x < w:
            out.append((x, y))
            y -= 1
            x += 1
    return out


def scan_order(w: int, h: int, kind: int):
    if kind == SCAN_HOR:
        return [(x, y) for y in range(h) for x in range(w)]
    if kind == SCAN_VER:
        return [(x, y) for x in range(w) for y in range(h)]
    return _diag_scan(w, h)


_scan_cache = {}


def scan_xy(w: int, h: int, kind: int) -> np.ndarray:
    key = (w, h, kind)
    if key not in _scan_cache:
        _scan_cache[key] = np.array(scan_order(w, h, kind), dtype=np.int32)
    return _scan_cache[key]


# ---------------------------------------------------------------------------
# CABAC engine tables (Rec. H.265 Tables 9-46, 9-47), combined-state form:
# state = (pStateIdx << 1) | valMps, as the reference stores it
# (reference: ContextModel.h:60-77, TComCABACTables.cpp).
# ---------------------------------------------------------------------------
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# next combined state after an MPS / LPS decision, indexed by combined state
NEXT_STATE_MPS = np.array([
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113,
    114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 124, 125, 126, 127,
], dtype=np.int32)

NEXT_STATE_LPS = np.array([
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25,
    26, 27, 26, 27, 30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37,
    38, 39, 38, 39, 42, 43, 42, 43, 44, 45, 44, 45, 46, 47, 48, 49,
    48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55, 56, 57, 58, 59,
    58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65, 66, 67,
    66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127,
], dtype=np.int32)


def ctx_init_state(init_value: int, qp: int) -> int:
    """Combined-state initialisation (Rec. H.265 9.3.2.2)."""
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
    if pre <= 63:
        return (63 - pre) << 1          # valMps = 0
    return ((pre - 64) << 1) | 1        # valMps = 1


# ---------------------------------------------------------------------------
# Context initialisation values (Rec. H.265 Tables 9-5..9-32).
# Row order matches the reference's slice-type indexing: [B, P, I]
# (reference: ContextTables.h:165-502).  Our context bank is a flat dict of
# named numpy arrays; offsets within each array follow the spec's ctxIdx maps.
# ---------------------------------------------------------------------------
INIT_VALUES = {
    "transquant_bypass": [[154], [154], [154]],
    "split_cu": [[107, 139, 126], [107, 139, 126], [139, 141, 157]],
    "skip": [[197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]],
    "merge_flag": [[154], [110], [CNU]],
    "merge_idx": [[137], [122], [CNU]],
    "part_size": [[154, 139, 154, 154], [154, 139, 154, 154], [184, CNU, CNU, CNU]],
    "pred_mode": [[134], [149], [CNU]],
    "intra_luma_mpm": [[183], [154], [184]],
    "intra_chroma_mode": [[152, 139], [152, 139], [63, 139]],
    "inter_dir": [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31], [CNU] * 5],
    "mvd": [[169, 198], [140, 198], [CNU, CNU]],
    "ref_idx": [[153, 153], [153, 153], [CNU, CNU]],
    "dqp": [[154, 154, 154]] * 3,
    "chroma_qp_adj_flag": [[154], [154], [154]],
    "chroma_qp_adj_idc": [[154], [154], [154]],
    # cbf: 5 luma then 5 chroma contexts
    "qt_cbf": [[153, 111, CNU, CNU, CNU, 149, 92, 167, 154, 154],
               [153, 111, CNU, CNU, CNU, 149, 107, 167, 154, 154],
               [111, 141, CNU, CNU, CNU, 94, 138, 182, 154, 154]],
    "qt_root_cbf": [[79], [79], [CNU]],
    # last position: 15 luma then 15 chroma (X and Y share values)
    "last": [[125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
              108, 123, 93, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU],
             [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
              108, 123, 108, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU],
             [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79,
              108, 123, 63, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU]],
    "sig_cg": [[121, 140, 61, 154], [121, 140, 61, 154], [91, 171, 134, 141]],
    # significance: 28 luma (ctx 0..26 + single TS ctx 27) then 16 chroma
    "sig": [[170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
             154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
             170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140],
            [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
             154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
             170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140],
            [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
             125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 141,
             140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 111]],
    # greater-1: 16 luma (4 sets x 4) then 8 chroma (2 sets x 4)
    "gt1": [[154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
             136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
            [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
             136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
            [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
             122, 152, 140, 179, 166, 182, 140, 227, 122, 197]],
    # greater-2: 4 luma sets + 2 chroma sets
    "gt2": [[107, 167, 91, 107, 107, 167],
            [107, 167, 91, 122, 107, 167],
            [138, 153, 136, 167, 152, 152]],
    "mvp_idx": [[168], [168], [CNU]],
    "sao_merge": [[153], [153], [153]],
    "sao_type": [[160], [185], [200]],
    "trans_subdiv": [[224, 167, 122], [124, 138, 94], [153, 138, 138]],
    "transform_skip": [[139, 139], [139, 139], [139, 139]],  # [luma, chroma]
    "rdpcm_flag": [[139, 139], [139, 139], [CNU, CNU]],
    "rdpcm_dir": [[139, 139], [139, 139], [CNU, CNU]],
    "cross_comp": [[154] * 10, [154] * 10, [154] * 10],
}

# Slice types (HM enum order: B=0, P=1, I=2)
B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


def make_context_bank(slice_type: int, qp: int, cabac_init_flag: int = 0) -> dict:
    """Build a fresh bank of contexts for a slice (Rec. H.265 9.3.2.1).

    initType selection: I uses I row; P uses B row if cabac_init_flag else P;
    B uses P row if cabac_init_flag else B row.
    """
    if slice_type == I_SLICE:
        row = I_SLICE
    elif slice_type == P_SLICE:
        row = B_SLICE if cabac_init_flag else P_SLICE
    else:
        row = P_SLICE if cabac_init_flag else B_SLICE
    bank = {}
    for name, rows in INIT_VALUES.items():
        bank[name] = np.array([ctx_init_state(v, qp) for v in rows[row]],
                              dtype=np.int32)
    # X and Y last-position coordinates use independent context sets that are
    # initialised from the same values (reference: TDecSbac m_cCuCtxLastX/Y)
    bank["last_x"] = bank.pop("last")
    bank["last_y"] = bank["last_x"].copy()
    return bank


# last-position group tables (Rec. H.265 Table 9-48 binarization support)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     dtype=np.int32)


# Golomb-Rice parameter update (Rec. H.265 9.3.3.13, persistent stats for RExt)
# and the minimum-coefficient group constants used by residual parsing.
MLS_GRP_NUM = 64
MLS_CG_SIZE = 16
