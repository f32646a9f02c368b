// Copied from libhm_tpu/hostdec/native/hevcdec.cpp
// HEVC host decode plane — native implementation (see hevcdec.h).
// Translation of the validated Python parser (libhm_tpu/hostdec/*.py).
#include "hevcdec.h"
#include "tables_gen.h"

#include <algorithm>
#include <cassert>
#include <cmath>
#include <map>

namespace hevc {

// ---------------------------------------------------------------------------
// CABAC engine inlines
inline int Cabac::bin(uint8_t& state) {
  uint32_t lps = kLpsTable[(state >> 1) * 4 + ((range >> 6) & 3)];
  range -= lps;
  int v;
  if (offset >= range) {
    v = 1 - (state & 1);
    offset -= range;
    range = lps;
    state = kNextStateLps[state];
  } else {
    v = state & 1;
    state = kNextStateMps[state];
  }
  if (range < 256) {
    int sh = __builtin_clz(range) - 23;  // doublings to reach >=256
    range <<= sh;
    offset = (offset << sh) | take(sh);
  }
  return v;
}

inline int Cabac::bypass() {
  offset = (offset << 1) | take(1);
  if (offset >= range) { offset -= range; return 1; }
  return 0;
}

inline int Cabac::term() {
  range -= 2;
  if (offset >= range) return 1;
  if (range < 256) {
    range <<= 1;
    offset = (offset << 1) | take(1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Context bank: one flat array; offsets from tables_gen.h, plus last_x/last_y
// (two independently evolving copies of the "last" init values).
struct CtxBank {
  std::vector<uint8_t> st;
  int off_last_x = 0, off_last_y = 0;
  static int initType(int sliceType, int cabacInit) {
    if (sliceType == 2) return 2;           // I
    if (sliceType == 1) return cabacInit ? 0 : 1;  // P
    return cabacInit ? 1 : 0;               // B
  }
  static uint8_t initState(int initVal, int qp) {
    qp = std::min(std::max(qp, 0), 51);
    int slope = (initVal >> 4) * 5 - 45;
    int offs = ((initVal & 15) << 3) - 16;
    int pre = std::min(std::max(1, ((slope * qp) >> 4) + offs), 126);
    if (pre <= 63) return uint8_t((63 - pre) << 1);
    return uint8_t(((pre - 64) << 1) | 1);
  }
  void init(int sliceType, int qp, int cabacInit) {
    int row = initType(sliceType, cabacInit);
    // total contexts = all kCtxInit entries + extra copy of "last"
    int total = int(sizeof(kCtxInit) / 3);
    st.resize(total + CTX_LAST_N);
    for (int i = 0; i < total; i++)
      st[i] = initState(kCtxInit[3 * i + row], qp);
    off_last_x = CTX_LAST;
    off_last_y = total;  // extra copy appended at the end
    for (int i = 0; i < CTX_LAST_N; i++)
      st[off_last_y + i] = st[off_last_x + i];
  }
};

// ---------------------------------------------------------------------------
// scan tables, precomputed eagerly for every (log2w, log2h, type) combo at
// static init: the per-TU lookup is a flat array index, and — unlike the
// former lazily-filled std::map — is safe to read concurrently from the
// WPP row-parallel parse threads.
enum { SCAN_DIAG = 0, SCAN_HOR = 1, SCAN_VER = 2 };
struct ScanTables {
  // grouped scan: scanpos -> raster blk, for TB sizes 4..32 per axis
  std::vector<uint16_t> grouped[4][4][3];
  std::vector<uint16_t> groupedInv[4][4][3];
  std::vector<uint16_t> cgscan[4][4][3];  // cg scanpos -> (cgy<<8)|cgx

  static void diag(int w, int h, std::vector<std::pair<int, int>>& out) {
    for (int d = 0; d < w + h - 1; d++) {
      int y = std::min(d, h - 1);
      int x = d - y;
      while (y >= 0 && x < w) { out.push_back({x, y}); y--; x++; }
    }
  }
  static void order(int w, int h, int kind, std::vector<std::pair<int, int>>& out) {
    out.clear();
    if (kind == SCAN_HOR) {
      for (int y = 0; y < h; y++) for (int x = 0; x < w; x++) out.push_back({x, y});
    } else if (kind == SCAN_VER) {
      for (int x = 0; x < w; x++) for (int y = 0; y < h; y++) out.push_back({x, y});
    } else diag(w, h, out);
  }
  ScanTables() {
    std::vector<std::pair<int, int>> cg, inner;
    for (int lw = 0; lw < 4; lw++)
      for (int lh = 0; lh < 4; lh++)
        for (int kind = 0; kind < 3; kind++) {
          int w = 4 << lw, h = 4 << lh;
          order(w >> 2, h >> 2, kind, cg);
          order(4, 4, kind, inner);
          auto& v = grouped[lw][lh][kind];
          v.reserve(size_t(w) * h);
          for (auto& g : cg)
            for (auto& p : inner)
              v.push_back(uint16_t((g.second * 4 + p.second) * w +
                                   g.first * 4 + p.first));
          auto& inv = groupedInv[lw][lh][kind];
          inv.resize(v.size());
          for (size_t i = 0; i < v.size(); i++) inv[v[i]] = uint16_t(i);
          // cg table indexed by the GROUP grid size (1..8 per axis)
          order(1 << lw, 1 << lh, kind, cg);
          auto& cv = cgscan[lw][lh][kind];
          cv.clear();
          for (auto& g : cg) cv.push_back(uint16_t((g.second << 8) | g.first));
        }
  }
  static int lg2(int v) { return 31 - __builtin_clz(unsigned(v)); }
  const std::vector<uint16_t>& getGrouped(int w, int h, int kind) const {
    return grouped[lg2(w) - 2][lg2(h) - 2][kind];
  }
  const std::vector<uint16_t>& getGroupedInv(int w, int h, int kind) const {
    return groupedInv[lg2(w) - 2][lg2(h) - 2][kind];
  }
  const std::vector<uint16_t>& getCg(int wg, int hg, int kind) const {
    return cgscan[lg2(wg)][lg2(hg)][kind];
  }
};
static const ScanTables g_scans;

static const int kCtxIndMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
static const int kSigSetStart[2][4] = {{0, 9, 21, 27}, {0, 9, 12, 15}};
static const int kNonDiag8x8Off[2] = {6, 0};
static const int kNotFirstGroupOff[2] = {3, 0};
static const int kChroma422Map[36] = {0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13,
                                      15, 17, 18, 19, 20, 21, 22, 23, 23, 24, 24,
                                      25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31, 36};

enum { MODE_INTER = 0, MODE_INTRA = 1 };
enum { SZ_2Nx2N = 0, SZ_2NxN, SZ_Nx2N, SZ_NxN, SZ_2NxnU, SZ_2NxnD, SZ_nLx2N, SZ_nRx2N };
enum { PLANAR = 0, DC = 1, HOR = 10, VER = 26, DM_CHROMA = 36 };
enum {
  EF_TU_L = 1, EF_TU_T = 2, EF_PU_L = 4, EF_PU_T = 8, EF_CU_L = 16, EF_CU_T = 32
};

// ---------------------------------------------------------------------------
// High-level syntax parsing
static void parsePtl(BitReader& r, int maxSub) {
  r.u(2); r.u(1); r.u(5); r.u(32); r.u(4);
  r.u(32); r.u(12);
  r.u(8);
  std::vector<int> sp(maxSub), sl(maxSub);
  for (int i = 0; i < maxSub; i++) { sp[i] = r.bit(); sl[i] = r.bit(); }
  if (maxSub > 0) for (int i = maxSub; i < 8; i++) r.u(2);
  for (int i = 0; i < maxSub; i++) {
    if (sp[i]) { r.u(2); r.u(1); r.u(5); r.u(32); r.u(4); r.u(32); r.u(12); }
    if (sl[i]) r.u(8);
  }
}

static ShortTermRPS parseStRps(BitReader& r, int idx,
                               const std::vector<ShortTermRPS>& list, int numSt) {
  ShortTermRPS rps;
  int interPred = (idx != 0) ? r.bit() : 0;
  if (interPred) {
    int deltaIdx = (idx == numSt) ? int(r.ue()) + 1 : 1;
    // corrupt-stream guard: a junk delta_idx would index out of range
    if (deltaIdx < 1 || deltaIdx > idx || idx > int(list.size()))
      return rps;
    const ShortTermRPS& ref = list[idx - deltaIdx];
    int sign = r.bit();
    int absd = int(r.ue()) + 1;
    int deltaRps = sign ? -absd : absd;
    int n = ref.numPics();
    std::vector<std::pair<int, int>> use(n + 1);
    for (int j = 0; j <= n; j++) {
      int ub = r.bit();
      int ud = ub ? 1 : r.bit();
      use[j] = {ub, ud};
    }
    std::vector<std::pair<int, int>> neg, pos;
    for (int j = ref.num_positive - 1; j >= 0; j--) {
      int dp = ref.delta_poc[ref.num_negative + j] + deltaRps;
      if (dp < 0 && use[ref.num_negative + j].second)
        neg.push_back({dp, use[ref.num_negative + j].first});
    }
    if (deltaRps < 0 && use[n].second) neg.push_back({deltaRps, use[n].first});
    for (int j = 0; j < ref.num_negative; j++) {
      int dp = ref.delta_poc[j] + deltaRps;
      if (dp < 0 && use[j].second) neg.push_back({dp, use[j].first});
    }
    for (int j = ref.num_negative - 1; j >= 0; j--) {
      int dp = ref.delta_poc[j] + deltaRps;
      if (dp > 0 && use[j].second) pos.push_back({dp, use[j].first});
    }
    if (deltaRps > 0 && use[n].second) pos.push_back({deltaRps, use[n].first});
    for (int j = 0; j < ref.num_positive; j++) {
      int dp = ref.delta_poc[ref.num_negative + j] + deltaRps;
      if (dp > 0 && use[ref.num_negative + j].second) pos.push_back({dp, use[ref.num_negative + j].first});
    }
    rps.num_negative = int(neg.size());
    rps.num_positive = int(pos.size());
    for (auto& p : neg) { rps.delta_poc.push_back(p.first); rps.used.push_back(p.second); }
    for (auto& p : pos) { rps.delta_poc.push_back(p.first); rps.used.push_back(p.second); }
  } else {
    // clamp to the spec bound (MAX_NUM_REF_PICS); junk values would
    // otherwise drive unbounded vector growth on corrupt streams
    rps.num_negative = std::min(int(r.ue()), 16);
    rps.num_positive = std::min(int(r.ue()), 16);
    int prev = 0;
    for (int i = 0; i < rps.num_negative; i++) {
      prev -= int(r.ue()) + 1;
      rps.delta_poc.push_back(prev);
      rps.used.push_back(r.bit());
    }
    prev = 0;
    for (int i = 0; i < rps.num_positive; i++) {
      prev += int(r.ue()) + 1;
      rps.delta_poc.push_back(prev);
      rps.used.push_back(r.bit());
    }
  }
  return rps;
}

// default scaling lists (reference TComRom.cpp:648 g_quant*Default8x8),
// raster order
static const uint8_t kDefSlIntra8[64] = {
    16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29, 16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115};
static const uint8_t kDefSlInter8[64] = {
    16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28, 16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91};

static void defaultScalingList(int sizeId, int matrixId, uint8_t* dst,
                               int* dc) {
  if (sizeId == 0) {
    for (int i = 0; i < 16; i++) dst[i] = 16;
    *dc = 8;
    return;
  }
  const uint8_t* s = matrixId < 3 ? kDefSlIntra8 : kDefSlInter8;
  memcpy(dst, s, 64);
  *dc = 16;
}

static void parseScalingListData(BitReader& r, ScalingListData& out) {
  out.present = true;
  for (int sizeId = 0; sizeId < 4; sizeId++) {
    int step = sizeId == 3 ? 3 : 1;
    for (int m = 0; m < 6; m += step) {
      if (!r.bit()) {
        int delta = int(r.ue()) * step;
        if (delta == 0) {
          defaultScalingList(sizeId, m, out.coef[sizeId][m], &out.dc[sizeId][m]);
        } else {
          memcpy(out.coef[sizeId][m], out.coef[sizeId][m - delta], 64);
          out.dc[sizeId][m] = out.dc[sizeId][m - delta];
        }
      } else {
        int coefNum = std::min(64, 1 << (4 + (sizeId << 1)));
        int nextCoef = 8, dc = 8;
        if (sizeId > 1) { dc = r.se() + 8; nextCoef = dc; }
        out.dc[sizeId][m] = dc;
        // up-right diagonal scan -> raster (TDecCAVLC xDecodeScalingList)
        int base = sizeId == 0 ? 4 : 8;
        int x = 0, y = 0, i = 0;
        for (int d = 0; d < 2 * base - 1; d++) {
          y = std::min(d, base - 1);
          x = d - y;
          while (y >= 0 && x < base) {
            nextCoef = (nextCoef + int(r.se()) + 256) % 256;
            out.coef[sizeId][m][y * base + x] = uint8_t(nextCoef);
            y--; x++;
            i++;
            if (i >= coefNum) break;
          }
          if (i >= coefNum) break;
        }
      }
    }
  }
}

static void parseHrd(BitReader& r, bool commonInf, int maxSub) {
  int nal = 0, vcl = 0, sub = 0;
  if (commonInf) {
    nal = r.bit(); vcl = r.bit();
    if (nal || vcl) {
      sub = r.bit();
      if (sub) { r.u(8); r.u(5); r.bit(); r.u(5); }
      r.u(4); r.u(4);
      if (sub) r.u(4);
      r.u(5); r.u(5); r.u(5);
    }
  }
  for (int i = 0; i <= maxSub; i++) {
    int fixed = r.bit();
    if (!fixed) fixed = r.bit();
    int lowDelay = 0;
    if (fixed) r.ue(); else lowDelay = r.bit();
    int cpb = lowDelay ? 1 : int(r.ue()) + 1;
    for (int pass = 0; pass < 2; pass++) {
      int on = pass == 0 ? nal : vcl;
      if (on) for (int c = 0; c < cpb; c++) { r.ue(); r.ue(); if (sub) { r.ue(); r.ue(); } r.bit(); }
    }
  }
}

static void parseVui(BitReader& r, const SPS& sps) {
  if (r.bit()) { int idc = int(r.u(8)); if (idc == 255) { r.u(16); r.u(16); } }
  if (r.bit()) r.bit();
  if (r.bit()) { r.u(3); r.bit(); if (r.bit()) { r.u(8); r.u(8); r.u(8); } }
  if (r.bit()) { r.ue(); r.ue(); }
  r.bit(); r.bit(); r.bit();
  if (r.bit()) { r.ue(); r.ue(); r.ue(); r.ue(); }
  if (r.bit()) {
    r.u(32); r.u(32);
    if (r.bit()) r.ue();
    if (r.bit()) parseHrd(r, true, sps.max_sub_layers_minus1);
  }
  if (r.bit()) {
    r.bit(); r.bit(); r.bit();
    r.ue(); r.ue(); r.ue(); r.ue(); r.ue();
  }
}

SPS parseSps(const uint8_t* rbsp, size_t n) {
  BitReader r; r.init(rbsp, n);
  SPS s;
  r.u(4);
  s.max_sub_layers_minus1 = int(r.u(3));
  r.bit();
  parsePtl(r, s.max_sub_layers_minus1);
  s.sps_id = int(r.ue());
  s.chroma_format_idc = int(r.ue());
  if (s.chroma_format_idc == 3) s.separate_colour_plane = r.bit();
  s.width = int(r.ue());
  s.height = int(r.ue());
  if (r.bit()) for (int i = 0; i < 4; i++) s.conf_win[i] = int(r.ue());
  s.bit_depth_luma = 8 + int(r.ue());
  s.bit_depth_chroma = 8 + int(r.ue());
  s.log2_max_poc_lsb = 4 + int(r.ue());
  int subOrd = r.bit();
  int lo = subOrd ? 0 : s.max_sub_layers_minus1;
  for (int i = lo; i <= s.max_sub_layers_minus1; i++) {
    s.max_dec_pic_buffering[i] = int(r.ue()) + 1;
    s.num_reorder_pics[i] = int(r.ue());
    r.ue();
  }
  if (!subOrd)
    for (int i = 0; i < s.max_sub_layers_minus1; i++) {
      s.max_dec_pic_buffering[i] = s.max_dec_pic_buffering[s.max_sub_layers_minus1];
      s.num_reorder_pics[i] = s.num_reorder_pics[s.max_sub_layers_minus1];
    }
  s.log2_min_cb = 3 + int(r.ue());
  s.log2_ctb = s.log2_min_cb + int(r.ue());
  s.log2_min_tb = 2 + int(r.ue());
  s.log2_max_tb = s.log2_min_tb + int(r.ue());
  s.max_tr_hierarchy_inter = int(r.ue());
  s.max_tr_hierarchy_intra = int(r.ue());
  s.scaling_list_enabled = r.bit();
  if (s.scaling_list_enabled && r.bit()) parseScalingListData(r, s.scaling);
  s.amp_enabled = r.bit();
  s.sao_enabled = r.bit();
  s.pcm_enabled = r.bit();
  if (s.pcm_enabled) {
    s.pcm_bd_luma = int(r.u(4)) + 1;
    s.pcm_bd_chroma = int(r.u(4)) + 1;
    s.log2_min_ipcm = 3 + int(r.ue());
    s.log2_max_ipcm = s.log2_min_ipcm + int(r.ue());
    s.pcm_loop_filter_disabled = r.bit();
  }
  int numSt = std::min(int(r.ue()), 64);   // spec max 64 candidate RPSs
  for (int i = 0; i < numSt; i++)
    s.st_rps.push_back(parseStRps(r, i, s.st_rps, numSt));
  s.long_term_ref_pics_present = r.bit();
  if (s.long_term_ref_pics_present) {
    int nlt = std::min(int(r.ue()), 32);   // spec max 32
    for (int i = 0; i < nlt; i++) {
      s.lt_poc_lsb_sps.push_back(int(r.u(s.log2_max_poc_lsb)));
      s.lt_used_sps.push_back(r.bit());
    }
  }
  s.temporal_mvp_enabled = r.bit();
  s.strong_intra_smoothing = r.bit();
  if (r.bit()) parseVui(r, s);
  if (r.bit()) {
    int rangeExt = r.bit();
    r.bit(); r.bit();
    r.u(5);
    if (rangeExt) {
      s.transform_skip_rotation = r.bit();
      s.transform_skip_context = r.bit();
      s.implicit_rdpcm = r.bit();
      s.explicit_rdpcm = r.bit();
      s.extended_precision = r.bit();
      s.intra_smoothing_disabled = r.bit();
      s.high_precision_offsets = r.bit();
      s.persistent_rice_adaptation = r.bit();
      s.cabac_bypass_alignment = r.bit();
    }
  }
  return s;
}

PPS parsePps(const uint8_t* rbsp, size_t n) {
  BitReader r; r.init(rbsp, n);
  PPS p;
  p.pps_id = int(r.ue());
  p.sps_id = int(r.ue());
  p.dependent_slice_segments_enabled = r.bit();
  p.output_flag_present = r.bit();
  p.num_extra_slice_header_bits = int(r.u(3));
  p.sign_data_hiding = r.bit();
  p.cabac_init_present = r.bit();
  p.num_ref_l0_default = int(r.ue()) + 1;
  p.num_ref_l1_default = int(r.ue()) + 1;
  p.init_qp = 26 + r.se();
  p.constrained_intra_pred = r.bit();
  p.transform_skip_enabled = r.bit();
  p.cu_qp_delta_enabled = r.bit();
  if (p.cu_qp_delta_enabled) p.diff_cu_qp_delta_depth = int(r.ue());
  p.cb_qp_offset = r.se();
  p.cr_qp_offset = r.se();
  p.slice_chroma_qp_offsets_present = r.bit();
  p.weighted_pred = r.bit();
  p.weighted_bipred = r.bit();
  p.transquant_bypass_enabled = r.bit();
  p.tiles_enabled = r.bit();
  p.entropy_coding_sync = r.bit();
  if (p.tiles_enabled) {
    // clamp: junk counts would drive unbounded loops on corrupt input
    p.num_tile_cols = std::min(int(r.ue()), 1022) + 1;
    p.num_tile_rows = std::min(int(r.ue()), 1022) + 1;
    p.uniform_spacing = r.bit();
    if (!p.uniform_spacing) {
      for (int i = 0; i < p.num_tile_cols - 1; i++) p.tile_col_widths.push_back(int(r.ue()) + 1);
      for (int i = 0; i < p.num_tile_rows - 1; i++) p.tile_row_heights.push_back(int(r.ue()) + 1);
    }
    p.loop_filter_across_tiles = r.bit();
  }
  p.loop_filter_across_slices = r.bit();
  if (r.bit()) {
    p.deblocking_override_enabled = r.bit();
    p.deblocking_disabled = r.bit();
    if (!p.deblocking_disabled) {
      p.beta_offset_div2 = r.se();
      p.tc_offset_div2 = r.se();
    }
  }
  if (r.bit()) parseScalingListData(r, p.scaling);
  p.lists_modification_present = r.bit();
  p.log2_parallel_merge_level = 2 + int(r.ue());
  p.slice_header_extension_present = r.bit();
  if (r.bit()) {
    int rangeExt = r.bit();
    r.bit(); r.bit();
    r.u(5);
    if (rangeExt) {
      if (p.transform_skip_enabled) p.log2_max_transform_skip_size = 2 + int(r.ue());
      p.cross_component_prediction = r.bit();
      p.chroma_qp_offset_list_enabled = r.bit();
      if (p.chroma_qp_offset_list_enabled) {
        p.diff_cu_chroma_qp_offset_depth = int(r.ue());
        int nn = std::min(int(r.ue()), 5) + 1;   // spec max 6 entries
        for (int i = 0; i < nn; i++) {
          int cb = r.se(), cr = r.se();
          p.chroma_qp_offset_list.push_back({cb, cr});
        }
      }
      p.sao_offset_scale_luma = int(r.ue());
      p.sao_offset_scale_chroma = int(r.ue());
    }
  }
  return p;
}

static int ceilLog2(int v) {
  int n = 0;
  while ((1 << n) < v) n++;
  return std::max(n, 1);
}

SliceHeader parseSliceHeader(const uint8_t* rbsp, size_t n, int nalType,
                             int tid, const SPS& sps, const PPS& pps) {
  BitReader r; r.init(rbsp, n);
  SliceHeader sh;
  sh.nal_type = nalType;
  sh.temporal_id = tid;
  sh.first_slice_in_pic = r.bit();
  bool irap = nalType >= 16 && nalType <= 23;
  bool idr = nalType == 19 || nalType == 20;
  if (irap) sh.no_output_of_prior_pics = r.bit();
  sh.pps_id = int(r.ue());
  if (!sh.first_slice_in_pic) {
    if (pps.dependent_slice_segments_enabled) sh.dependent = r.bit();
    sh.segment_address = int(r.u(ceilLog2(sps.picSizeCtbs())));
  }
  if (!sh.dependent) {
    for (int i = 0; i < pps.num_extra_slice_header_bits; i++) r.bit();
    sh.slice_type = int(r.ue());
    if (pps.output_flag_present) sh.pic_output_flag = r.bit();
    if (sps.separate_colour_plane) r.u(2);
    if (!idr) {
      sh.poc_lsb = int(r.u(sps.log2_max_poc_lsb));
      int stSps = r.bit();
      if (!stSps) sh.rps = parseStRps(r, int(sps.st_rps.size()), sps.st_rps, int(sps.st_rps.size()));
      else {
        int idx = 0;
        if (sps.st_rps.size() > 1) idx = int(r.u(ceilLog2(int(sps.st_rps.size()))));
        if (idx < int(sps.st_rps.size())) sh.rps = sps.st_rps[idx];
        // (else: junk index into an empty/short SPS RPS list — keep the
        // default empty RPS rather than reading out of range)
      }
      if (sps.long_term_ref_pics_present) {
        int numLtSps = sps.lt_poc_lsb_sps.size() ?
            std::min(int(r.ue()), int(sps.lt_poc_lsb_sps.size())) : 0;
        int numLtPics = std::min(int(r.ue()), 32);
        int prevDelta = 0;
        for (int i = 0; i < numLtSps + numLtPics; i++) {
          if (i < numLtSps) {
            int lt = 0;
            if (sps.lt_poc_lsb_sps.size() > 1) lt = int(r.u(ceilLog2(int(sps.lt_poc_lsb_sps.size()))));
            lt = std::min(lt, int(sps.lt_poc_lsb_sps.size()) - 1);
            sh.lt_poc_lsb.push_back(sps.lt_poc_lsb_sps[lt]);
            sh.lt_used.push_back(sps.lt_used_sps[lt]);
          } else {
            sh.lt_poc_lsb.push_back(int(r.u(sps.log2_max_poc_lsb)));
            sh.lt_used.push_back(r.bit());
          }
          int msb = r.bit();
          sh.lt_msb_present.push_back(msb);
          if (msb) {
            int d = int(r.ue());
            if (i != 0 && i != numLtSps) d += prevDelta;
            sh.lt_delta_poc_msb.push_back(d);
            prevDelta = d;
          } else sh.lt_delta_poc_msb.push_back(0);
        }
      }
      if (sps.temporal_mvp_enabled) sh.temporal_mvp = r.bit();
    }
    if (sps.sao_enabled) {
      sh.sao_luma = r.bit();
      if (sps.chroma_format_idc != 0) sh.sao_chroma = r.bit();
    }
    if (sh.slice_type == 1 || sh.slice_type == 0) {
      sh.num_ref_idx[0] = pps.num_ref_l0_default;
      sh.num_ref_idx[1] = pps.num_ref_l1_default;
      if (r.bit()) {
        sh.num_ref_idx[0] = std::min(int(r.ue()), 15) + 1;
        if (sh.slice_type == 0) sh.num_ref_idx[1] = std::min(int(r.ue()), 15) + 1;
      }
      if (sh.slice_type != 0) sh.num_ref_idx[1] = 0;
      int numPicTotal = 0;
      for (int u : sh.rps.used) numPicTotal += u;
      for (int u : sh.lt_used) numPicTotal += u;
      if (pps.lists_modification_present && numPicTotal > 1) {
        int nb = ceilLog2(numPicTotal);
        if (r.bit()) {
          sh.has_list_mod[0] = 1;
          for (int i = 0; i < sh.num_ref_idx[0]; i++) sh.list_mod[0].push_back(int(r.u(nb)));
        }
        if (sh.slice_type == 0 && r.bit()) {
          sh.has_list_mod[1] = 1;
          for (int i = 0; i < sh.num_ref_idx[1]; i++) sh.list_mod[1].push_back(int(r.u(nb)));
        }
      }
      if (sh.slice_type == 0) sh.mvd_l1_zero = r.bit();
      if (pps.cabac_init_present) sh.cabac_init_flag = r.bit();
      if (sh.temporal_mvp) {
        if (sh.slice_type == 0) sh.collocated_from_l0 = r.bit();
        if ((sh.collocated_from_l0 && sh.num_ref_idx[0] > 1) ||
            (!sh.collocated_from_l0 && sh.num_ref_idx[1] > 1))
          sh.collocated_ref_idx = int(r.ue());
      }
      if ((pps.weighted_pred && sh.slice_type == 1) ||
          (pps.weighted_bipred && sh.slice_type == 0)) {
        sh.has_wp = 1;
        sh.wp_log2_denom_luma = int(r.ue());
        bool hasChroma = sps.chroma_format_idc != 0;
        if (hasChroma) sh.wp_log2_denom_chroma = sh.wp_log2_denom_luma + r.se();
        int numLists = sh.slice_type == 0 ? 2 : 1;
        for (int l = 0; l < numLists; l++) {
          int nr = sh.num_ref_idx[l];
          std::vector<int> lf(nr), cf(nr, 0);
          for (int i = 0; i < nr; i++) lf[i] = r.bit();
          if (hasChroma) for (int i = 0; i < nr; i++) cf[i] = r.bit();
          for (int i = 0; i < nr; i++) {
            int dl = 1 << sh.wp_log2_denom_luma;
            if (lf[i]) { sh.wp[l][i][0].w = dl + r.se(); sh.wp[l][i][0].o = r.se(); }
            else { sh.wp[l][i][0].w = dl; sh.wp[l][i][0].o = 0; }
            int dc = 1 << sh.wp_log2_denom_chroma;
            if (cf[i]) {
              // offset derives from the weight (Rec. 7.4.7.3 ChromaOffsetL)
              int rng = sps.high_precision_offsets
                  ? 1 << (sps.bit_depth_chroma - 1) : 128;
              for (int c = 1; c <= 2; c++) {
                int w = dc + int(r.se());
                int deltaO = int(r.se());
                int pred = rng - ((rng * w) >> sh.wp_log2_denom_chroma);
                int o = deltaO + pred;
                o = o < -rng ? -rng : (o > rng - 1 ? rng - 1 : o);
                sh.wp[l][i][c].w = w;
                sh.wp[l][i][c].o = o;
              }
            } else {
              for (int c = 1; c <= 2; c++) { sh.wp[l][i][c].w = dc; sh.wp[l][i][c].o = 0; }
            }
          }
        }
      } else {
        for (int l = 0; l < 2; l++)
          for (int i = 0; i < 16; i++)
            for (int c = 0; c < 3; c++) { sh.wp[l][i][c].w = 0; sh.wp[l][i][c].o = 0; }
      }
      sh.max_num_merge_cand = 5 - int(r.ue());
    }
    sh.qp = pps.init_qp + r.se();
    if (pps.slice_chroma_qp_offsets_present) {
      sh.cb_qp_offset = r.se();
      sh.cr_qp_offset = r.se();
    }
    if (pps.chroma_qp_offset_list_enabled) sh.cu_chroma_qp_offset_enabled = r.bit();
    sh.deblocking_disabled = pps.deblocking_disabled;
    sh.beta_offset_div2 = pps.beta_offset_div2;
    sh.tc_offset_div2 = pps.tc_offset_div2;
    int ovr = 0;
    if (pps.deblocking_override_enabled) ovr = r.bit();
    if (ovr) {
      sh.deblocking_disabled = r.bit();
      if (!sh.deblocking_disabled) {
        sh.beta_offset_div2 = r.se();
        sh.tc_offset_div2 = r.se();
      }
    }
    sh.loop_filter_across_slices = pps.loop_filter_across_slices;
    if (pps.loop_filter_across_slices &&
        (sh.sao_luma || sh.sao_chroma || !sh.deblocking_disabled))
      sh.loop_filter_across_slices = r.bit();
  }
  if (pps.tiles_enabled || pps.entropy_coding_sync) {
    // bound by the remaining payload: each entry point needs >=1 bit
    int nep = std::min(int(r.ue()), int(r.nbits - std::min(r.pos, r.nbits)));
    if (nep > 0) {
      int len = std::min(int(r.ue()), 31) + 1;
      for (int i = 0; i < nep; i++) sh.entry_points.push_back(int(r.u(len)) + 1);
    }
  }
  if (pps.slice_header_extension_present) {
    int len = std::min(int(r.ue()), 4096);   // spec max 256 bytes
    for (int i = 0; i < len; i++) r.u(8);
  }
  r.bit();       // byte_alignment: alignment_bit_equal_to_one
  r.byteAlign();
  sh.data_bit_offset = r.pos;
  return sh;
}

}  // namespace hevc
