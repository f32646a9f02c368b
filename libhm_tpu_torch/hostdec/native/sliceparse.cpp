// Copied from libhm_tpu/hostdec/native/sliceparse.cpp
// Slice-data CABAC parsing into Picture tensors.
// Translation of libhm_tpu/hostdec/slicedec.py + residual.py + motion.py.
// Compiled as part of api.cpp (single translation unit).
#include "hevcdec.h"
#include <atomic>
#include <memory>
#include <thread>
#include <cstdlib>

namespace hevc {

struct RefPicInfo {       // decoder-side reference picture descriptor
  Picture* pic = nullptr; // for TMVP maps
  int poc = 0;
  bool long_term = false;
};

struct MergeCand {
  int dir = 0;
  int mv[2][2] = {{0, 0}, {0, 0}};
  int ref_idx[2] = {-1, -1};
  bool sameMotion(const MergeCand& o) const {
    if (dir != o.dir) return false;
    for (int l = 0; l < 2; l++)
      if (dir & (1 << l))
        if (mv[l][0] != o.mv[l][0] || mv[l][1] != o.mv[l][1] ||
            ref_idx[l] != o.ref_idx[l]) return false;
    return true;
  }
};

struct SliceParser {
  const SPS* sps;
  const PPS* pps;
  Picture* pic;
  const SliceHeader* sh;
  Cabac d;
  CtxBank bank;
  int riceStats[4];
  const uint8_t* rbsp;
  size_t rbspLen;

  int W, H, ctb, log2Ctb, wCtbs;
  int sliceIdx;
  // z-scan map, shared+cached across parsers of the same geometry (a
  // 1080p zmap is a 1 MB fill per picture otherwise); shared_ptr so a
  // geometry change can't invalidate it under a frame-threaded parser
  std::shared_ptr<const std::vector<int64_t>> zmapP;
  std::vector<int32_t> tileMap;  // per CTU
  std::vector<int> tileColBounds, tileRowBounds;

  // QP state
  int lastQp = 0, cuQpDelta = 0, qpPred = 0;
  bool qpDeltaCoded = false;
  int chromaQpAdj = 0;
  bool chromaQpAdjCoded = false;
  int cuTqBypass = 0;
  int cuPredMode = MODE_INTRA;
  int cuPartSize = SZ_2Nx2N;
  int cuX = 0, cuY = 0, cuLog2 = 0;
  int crossCompAlpha = 0;
  bool lastPuMerge = false;
  // WPP snapshot
  bool wppSavedValid = false;
  CtxBank wppBank;
  int wppRice[4];
  // dependent-slice-segment continuation (reference TDecSlice CTXMem[0])
  bool depSavedValid = false;
  CtxBank depBank;
  int depRice[4];
  int depLastQp = 0, depQpPred = 0;
  std::vector<size_t> substreams;
  size_t curSubstream = 0;
  // list sinks: the sequential path appends straight into the picture;
  // WPP row workers swap in private buffers that are concatenated in row
  // order afterwards, so the lists keep exact sequential parse order
  std::vector<TuMeta>* tuSink = nullptr;
  CoefBuf* coefSink = nullptr;
  // native-recon mode: transform-path slots are only zeroed up to the
  // diagonal-scan row bound (see parseResidual)
  bool noZeroCoefSlots = false;
  std::vector<IntraMeta>* intraSink = nullptr;
  std::vector<PcmMeta>* pcmSink = nullptr;
  std::vector<int32_t>* pcmSampSink = nullptr;
  std::vector<PuMeta>* puSink = nullptr;
  void bindSinks() {
    tuSink = &pic->tu_list; coefSink = &pic->coeffs;
    intraSink = &pic->intra_list; pcmSink = &pic->pcm_list;
    pcmSampSink = &pic->pcm_samples; puSink = &pic->inter_list;
  }
  bool decodeSliceWpp(const uint8_t* data, size_t len,
                      const SliceHeader& hdr, int sidx, int qp);

  // motion derivation context
  std::vector<RefPicInfo> refList[2];
  int poc = 0;
  bool allRefsBefore = true;
  Picture* colPic = nullptr;
  int colPoc = 0;

  int w4() const { return pic->w4; }
  inline int8_t& map8(std::vector<int8_t>& m, int x, int y) { return m[(y >> 2) * w4() + (x >> 2)]; }

  void buildGeometry() {
    W = sps->width; H = sps->height;
    ctb = sps->ctbSize(); log2Ctb = sps->log2_ctb; wCtbs = sps->picWCtbs();
    int n = log2Ctb - 2, m = 1 << n;
    {
      struct ZCache {
        int w4 = -1, h4 = -1, lg = -1;
        std::shared_ptr<const std::vector<int64_t>> map;
      };
      static thread_local ZCache zc;
      if (zc.w4 != pic->w4 || zc.h4 != pic->h4 || zc.lg != log2Ctb) {
        std::vector<int64_t> zInCtu(size_t(m) * m);
        for (int yy = 0; yy < m; yy++)
          for (int xx = 0; xx < m; xx++) {
            int64_t z = 0;
            for (int b = 0; b < n; b++) {
              z |= int64_t((xx >> b) & 1) << (2 * b);
              z |= int64_t((yy >> b) & 1) << (2 * b + 1);
            }
            zInCtu[size_t(yy) * m + xx] = z;
          }
        auto zm = std::make_shared<std::vector<int64_t>>(
            size_t(pic->h4) * pic->w4);
        int64_t parts = int64_t(m) * m;
        for (int cy = 0; cy < pic->h4; cy += m)
          for (int cx = 0; cx < pic->w4; cx += m) {
            int64_t base = (int64_t(cy / m) * wCtbs + cx / m) * parts;
            for (int yy = 0; yy < m; yy++)
              for (int xx = 0; xx < m; xx++)
                (*zm)[size_t(cy + yy) * pic->w4 + cx + xx] =
                    base + zInCtu[size_t(yy) * m + xx];
          }
        zc.w4 = pic->w4; zc.h4 = pic->h4; zc.lg = log2Ctb;
        zc.map = std::move(zm);
      }
      zmapP = zc.map;
    }
    // tiles
    int hCtbs = sps->picHCtbs();
    tileMap.assign(size_t(wCtbs) * hCtbs, 0);
    if (pps->tiles_enabled) {
      int nc = pps->num_tile_cols, nr = pps->num_tile_rows;
      tileColBounds.clear(); tileRowBounds.clear();
      if (pps->uniform_spacing) {
        for (int i = 0; i <= nc; i++) tileColBounds.push_back(i * wCtbs / nc);
        for (int i = 0; i <= nr; i++) tileRowBounds.push_back(i * hCtbs / nr);
      } else {
        tileColBounds.push_back(0);
        for (int v : pps->tile_col_widths) tileColBounds.push_back(tileColBounds.back() + v);
        tileColBounds.push_back(wCtbs);
        tileRowBounds.push_back(0);
        for (int v : pps->tile_row_heights) tileRowBounds.push_back(tileRowBounds.back() + v);
        tileRowBounds.push_back(hCtbs);
      }
      for (int y = 0; y < hCtbs; y++) {
        int tr = 0; while (!(tileRowBounds[tr] <= y && y < tileRowBounds[tr + 1])) tr++;
        for (int x = 0; x < wCtbs; x++) {
          int tc = 0; while (!(tileColBounds[tc] <= x && x < tileColBounds[tc + 1])) tc++;
          tileMap[size_t(y) * wCtbs + x] = tr * pps->num_tile_cols + tc;
        }
      }
    }
  }

  bool available(int x, int y, int cx, int cy, bool checkZ = true) {
    if (x < 0 || y < 0 || x >= W || y >= H) return false;
    int x4 = x >> 2, y4 = y >> 2, cx4 = cx >> 2, cy4 = cy >> 2;
    if (checkZ && (*zmapP)[size_t(y4) * w4() + x4] >=
                      (*zmapP)[size_t(cy4) * w4() + cx4]) return false;
    if (pic->slice_idx[size_t(y4) * w4() + x4] != pic->slice_idx[size_t(cy4) * w4() + cx4]) return false;
    if (tileMap[size_t(y >> log2Ctb) * wCtbs + (x >> log2Ctb)] !=
        tileMap[size_t(cy >> log2Ctb) * wCtbs + (cx >> log2Ctb)]) return false;
    return true;
  }

  // ---------------- decode_slice -------------------------------------
  void decodeSlice(const uint8_t* data, size_t len, const SliceHeader& hdr, int sidx);

  int tileFirstCol(int addr) {
    if (!pps->tiles_enabled) return 0;
    int t = tileMap[addr] % pps->num_tile_cols;
    return tileColBounds[t];
  }
  int tileLastCol(int addr) {
    if (!pps->tiles_enabled) return wCtbs - 1;
    int t = tileMap[addr] % pps->num_tile_cols;
    return tileColBounds[t + 1] - 1;
  }

  void setRect8(std::vector<int8_t>& m, int x, int y, int w, int h, int8_t v) {
    int x0 = x >> 2, nx = ((x + w) >> 2) - x0;
    for (int yy = y >> 2; yy < (y + h) >> 2; yy++)
      memset(&m[size_t(yy) * w4() + x0], v, size_t(nx));
  }

  // ---------------- SAO ------------------------------------------------
  void parseSaoCtu(int addr, int cx, int cy);

  // ---------------- CQT / CU -------------------------------------------
  void parseCqt(int x, int y, int log2size, int depth);
  void parseCu(int x, int y, int log2size, int depth);
  int predictQp(int x, int y);
  int finalQp() const {
    if (cuQpDelta) return (qpPred + cuQpDelta + 52) % 52;
    return qpPred;
  }
  int qpForComp(int comp);
  void finishCu(int x, int y, int size) {
    int q = pps->cu_qp_delta_enabled ? finalQp() : sh->qp;
    setRect8(pic->qp, x, y, size, size, int8_t(q));
    lastQp = q;
  }
  void markCuEdges(int x, int y, int size) {
    for (int yy = y >> 2; yy < (y + size) >> 2; yy++)
      pic->edge_flags[size_t(yy) * w4() + (x >> 2)] |= EF_CU_L | EF_PU_L | EF_TU_L;
    for (int xx = x >> 2; xx < (x + size) >> 2; xx++)
      pic->edge_flags[size_t(y >> 2) * w4() + xx] |= EF_CU_T | EF_PU_T | EF_TU_T;
  }

  int parseInterPartSize(int log2size);
  int parseMergeIdx();
  void parseIntraPredInfo(int x, int y, int log2size, int partSize);
  void intraMpm(int x, int y, int preds[3]);
  void parseInterPredInfo(int x, int y, int log2size, int depth, int partSize);
  void parsePu(int px, int py, int w, int h, int cx, int cy, int cuSize,
               int depth, int partSize, int puIdx);
  int parseInterDir(int cuSize, int depth, int partSize);
  int parseRefIdx(int l);
  void parseMvd(int mv[2]);
  void parsePcm(int x, int y, int log2size);
  int unaryMax(uint8_t* arr, int idx0, int idxRest, int maxSym);

  // transform tree
  void parseTtRoot(int x, int y, int log2size, int partSize, int predMode,
                   bool merge2Nx2N);
  int minTuLog2 = 2;
  void tt(int x, int y, int log2size, int trDepth, int cbfCb[2], int cbfCr[2],
          int blkIdx);
  void parseCbfChroma(int log2size, int trDepth, bool is422, bool lowest,
                      int out[2]);
  void emitTu(int x, int y, int log2size, int trDepth, int blkIdx, int cbfY,
              int cbfCb[2], int cbfCr[2]);
  void parseCuQpDelta();
  void parseChromaQpAdj();
  int parseCrossComp(int comp);
  void parseResidual(int comp, int x, int y, int log2w, int log2h);
  int parseRdpcm(int comp);
  int readCoefRemain(int rice, bool limited, int maxDyn);
  void parseLastSigXY(int w, int h, bool isChroma, int scanType, int& px, int& py);

  // ---------------- motion ---------------------------------------------
  struct Blk {
    bool ok = false;
    int dir = 0;
    int mv[2][2];
    int ref_idx[2];
    int ref_poc[2];
    int ref_lt[2];
  };
  Blk blk(int x, int y, int cx, int cy, bool checkZ = true) {
    Blk b;
    if (!available(x, y, cx, cy, checkZ)) return b;
    size_t i = size_t(y >> 2) * w4() + (x >> 2);
    if (pic->pred_mode[i] != MODE_INTER) return b;
    b.ok = true;
    b.dir = pic->inter_dir[i];
    for (int l = 0; l < 2; l++) {
      b.mv[l][0] = pic->mv[i * 4 + l * 2];
      b.mv[l][1] = pic->mv[i * 4 + l * 2 + 1];
      b.ref_idx[l] = pic->ref_idx[i * 2 + l];
      b.ref_poc[l] = pic->ref_poc[i * 2 + l];
      b.ref_lt[l] = pic->ref_is_lt[i * 2 + l];
    }
    return b;
  }
  static void mvScale(const int in[2], int tb, int td, int out[2]) {
    if (tb == td) { out[0] = in[0]; out[1] = in[1]; return; }
    auto clip3 = [](int lo, int hi, int v) { return std::max(lo, std::min(hi, v)); };
    tb = clip3(-128, 127, tb);
    td = clip3(-128, 127, td);
    int tx = (16384 + (std::abs(td) >> 1)) / td;
    int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    for (int i = 0; i < 2; i++) {
      int64_t p = int64_t(dsf) * in[i];
      out[i] = clip3(-32768, 32767, int((p + 127 + (p < 0 ? 1 : 0)) >> 8));
    }
  }
  bool tmvp(int x, int y, int w, int h, int targetList, int targetRefIdx, int out[2]);
  MergeCand mergeCandidate(int x, int y, int w, int h, int cx, int cy,
                           int cuSize, int puIdx, int partSize, int mergeIdx);
  void amvpCandidates(int x, int y, int w, int h, int targetList,
                      int targetRefIdx, int cands[2][2]);
  void applyMerge(int x, int y, int w, int h, int mergeIdx, int cx, int cy,
                  int cuSize, int puIdx);
  void applyAmvp(int x, int y, int w, int h, int interDir, const int refIdx[2],
                 const int mvd[2][2], const int mvpIdx[2]);
  void writePu(int x, int y, int w, int h, int dir, const int mvs[2][2],
               const int refIdx[2], int merge, int mergeIdx);
};

// ===========================================================================
int SliceParser::unaryMax(uint8_t* arr, int idx0, int idxRest, int maxSym) {
  if (maxSym == 0 || !d.bin(arr[idx0])) return 0;
  if (maxSym == 1) return 1;
  int symbol = 0, cont = 1;
  for (;;) {
    cont = d.bin(arr[idxRest]);
    symbol++;
    if (!cont || symbol >= maxSym - 1) break;
  }
  if (cont && symbol == maxSym - 1) symbol++;
  return symbol;
}

void SliceParser::decodeSlice(const uint8_t* data, size_t len,
                              const SliceHeader& hdr, int sidx) {
  sh = &hdr;
  sliceIdx = sidx;
  rbsp = data;
  rbspLen = len;
  int qp = hdr.qp;
  if (hdr.dependent && depSavedValid) {
    // CABAC contexts, Rice stats and the QP predictor continue across
    // dependent slice segments (Rec. 9.3.1 / 8.6.1)
    bank = depBank;
    for (int i = 0; i < 4; i++) riceStats[i] = depRice[i];
    lastQp = depLastQp; qpPred = depQpPred;
  } else {
    bank.init(hdr.slice_type, qp, hdr.cabac_init_flag);
    for (int i = 0; i < 4; i++) riceStats[i] = 0;
    lastQp = qp; qpPred = qp;
  }
  cuQpDelta = 0; qpDeltaCoded = false;
  chromaQpAdj = 0; chromaQpAdjCoded = false;

  // entry points count EBSP bytes (Rec. 7.4.7.1); convert to RBSP spans
  // via the NAL's emulation-prevention byte positions
  substreams.clear();
  substreams.push_back(hdr.data_bit_offset >> 3);
  for (int ep : hdr.entry_points) {
    size_t a = substreams.back();
    size_t b = a + ep;
    for (;;) {
      int k = 0;
      for (int p : hdr.epb_positions)
        if (size_t(p) > a && size_t(p) <= b) k++;
      size_t nb = a + ep - k;
      if (nb == b) break;
      b = nb;
    }
    substreams.push_back(b);
  }
  curSubstream = 0;
  bindSinks();
  if (decodeSliceWpp(data, len, hdr, sidx, qp)) return;
  d.start(data, len, hdr.data_bit_offset);

  int hCtbs = sps->picHCtbs();
  int nctu = wCtbs * hCtbs;
  // scan order (tile scan)
  std::vector<int> scan;
  if (!pps->tiles_enabled) {
    for (int i = 0; i < nctu; i++) scan.push_back(i);
  } else {
    int ntiles = pps->num_tile_cols * pps->num_tile_rows;
    for (int t = 0; t < ntiles; t++)
      for (int i = 0; i < nctu; i++)
        if (tileMap[i] == t) scan.push_back(i);
  }
  int startPos = 0;
  if (hdr.segment_address)
    for (int i = 0; i < nctu; i++) if (scan[i] == hdr.segment_address) { startPos = i; break; }
  bool wpp = pps->entropy_coding_sync;

  for (int posI = startPos; posI < nctu; posI++) {
    int addr = scan[posI];
    int cx = (addr % wCtbs) << log2Ctb;
    int cy = (addr / wCtbs) << log2Ctb;
    int col = addr % wCtbs;
    int tile = tileMap[addr];
    // A dependent segment whose first CTU sits at a tile boundary or a
    // WPP row start takes the init / sync path, overriding the continued
    // contexts (reference TDecSlice::decompressSlice CTXMem rules)
    bool segFirst = posI == startPos;
    if (posI > startPos || (segFirst && hdr.dependent && posI > 0)) {
      int prevTile = tileMap[scan[posI - 1]];
      if (tile != prevTile) {
        bank.init(hdr.slice_type, qp, hdr.cabac_init_flag);
        for (int i = 0; i < 4; i++) riceStats[i] = 0;
        lastQp = qp;
        if (!segFirst) {
          curSubstream++;
          d.start(data, len, substreams[curSubstream] * 8);
        }
      } else if (wpp && col == tileFirstCol(addr)) {
        if (!segFirst) {
          curSubstream++;
          d.start(data, len, substreams[curSubstream] * 8);
        }
        bool ok = wppSavedValid && cy > 0 && col + 1 < wCtbs &&
                  tileMap[addr - wCtbs + 1] == tile &&
                  pic->slice_idx[size_t((cy - 4) >> 2) * w4() + ((cx + ctb) >> 2)] == sidx;
        if (ok) {
          bank = wppBank;
          for (int i = 0; i < 4; i++) riceStats[i] = wppRice[i];
        } else {
          bank.init(hdr.slice_type, qp, hdr.cabac_init_flag);
          for (int i = 0; i < 4; i++) riceStats[i] = 0;
        }
      }
    }
    // Per-CTU init, row-wise: slice id, re-init of conditionally-written
    // maps (reference TComDataCU::initCtu zero-fills before each CTU parse;
    // needed when a later slice re-parses CTUs an earlier slice's substream
    // already covered, TDecCu.cpp:157), and per-CTU deblock slice params.
    int x4lo = cx >> 2;
    int x4hi = std::min((cx + ctb) >> 2, pic->w4);
    int y4hi = std::min((cy + ctb) >> 2, pic->h4);
    int nx4 = x4hi - x4lo;
    for (int yy = cy >> 2; yy < y4hi; yy++) {
      size_t i = size_t(yy) * w4() + x4lo;
      std::fill_n(&pic->slice_idx[i], nx4, sidx);
      memset(&pic->cbf_y[i], 0, size_t(nx4));
      memset(&pic->pcm[i], 0, size_t(nx4));
      memset(&pic->edge_flags[i], 0, size_t(nx4));
      memset(&pic->skip[i], 0, size_t(nx4));
      memset(&pic->deblock_disable[i], uint8_t(int8_t(hdr.deblocking_disabled)),
             size_t(nx4));
      memset(&pic->beta_offset[i], uint8_t(int8_t(hdr.beta_offset_div2 * 2)),
             size_t(nx4));
      memset(&pic->tc_offset[i], uint8_t(int8_t(hdr.tc_offset_div2 * 2)),
             size_t(nx4));
      memset(&pic->lf_across[i], uint8_t(int8_t(hdr.loop_filter_across_slices)),
             size_t(nx4));
    }
    if (sps->sao_enabled) parseSaoCtu(addr, cx, cy);
    parseCqt(cx, cy, log2Ctb, 0);
    // row snapshot (Rec. 9.3.2.3 storage): taken whenever the 2nd CTU of
    // a row finishes, even if the slice segment ends here -- a following
    // dependent segment's rows sync from it
    if (wpp && col == tileFirstCol(addr) + 1) {
      wppBank = bank;
      for (int i = 0; i < 4; i++) wppRice[i] = riceStats[i];
      wppSavedValid = true;
    }
    int isLast = d.term();
    if (isLast) {
      if (pps->dependent_slice_segments_enabled) {
        depBank = bank;
        for (int i = 0; i < 4; i++) depRice[i] = riceStats[i];
        depLastQp = lastQp; depQpPred = qpPred;
        depSavedValid = true;
      }
      break;
    }
    if (wpp && col == tileLastCol(addr)) {
      d.term();  // end_of_subset_one_bit (asserted 1)
    }
  }
}

// ---------------------------------------------------------------------------
void SliceParser::parseSaoCtu(int addr, int cx, int cy) {
  int enabled[3] = {sh->sao_luma, sh->sao_chroma, sh->sao_chroma};
  if (sps->chroma_format_idc == 0) enabled[1] = enabled[2] = 0;
  if (!enabled[0] && !enabled[1] && !enabled[2]) return;
  int mergeLeft = 0, mergeUp = 0;
  if (addr % wCtbs > 0 && available(cx - 1, cy, cx, cy))
    mergeLeft = d.bin(bank.st[CTX_SAO_MERGE]);
  if (!mergeLeft && addr / wCtbs > 0 && available(cx, cy - 1, cx, cy))
    mergeUp = d.bin(bank.st[CTX_SAO_MERGE]);
  if (mergeLeft || mergeUp) {
    int src = mergeLeft ? addr - 1 : addr - wCtbs;
    for (int c = 0; c < 3; c++)
      if (enabled[c]) {
        pic->sao_type[addr * 3 + c] = pic->sao_type[src * 3 + c];
        pic->sao_band[addr * 3 + c] = pic->sao_band[src * 3 + c];
        for (int i = 0; i < 4; i++)
          pic->sao_offsets[(addr * 3 + c) * 4 + i] = pic->sao_offsets[(src * 3 + c) * 4 + i];
      }
    return;
  }
  int maxqL = (1 << (std::min(sps->bit_depth_luma, 10) - 5)) - 1;
  int maxqC = (1 << (std::min(sps->bit_depth_chroma, 10) - 5)) - 1;
  int chromaType = -1, chromaEo = 0;
  for (int c = 0; c < 3; c++) {
    if (!enabled[c]) continue;
    int typeIdc;
    if (c <= 1) {
      int t = d.bin(bank.st[CTX_SAO_TYPE]);
      typeIdc = (t == 0) ? -1 : (d.bypass() == 0 ? 0 : 1);
      if (c == 1) chromaType = typeIdc;
    } else typeIdc = chromaType;
    if (typeIdc < 0) { pic->sao_type[addr * 3 + c] = -1; continue; }
    int maxq = c == 0 ? maxqL : maxqC;
    int offs[4];
    for (int i = 0; i < 4; i++) {
      int v = 0;
      while (v < maxq && d.bypass()) v++;
      offs[i] = v;
    }
    if (typeIdc == 0) {  // BO
      for (int i = 0; i < 4; i++)
        if (offs[i] && d.bypass()) offs[i] = -offs[i];
      int band = int(d.bypassN(5));
      pic->sao_type[addr * 3 + c] = 0;
      pic->sao_band[addr * 3 + c] = int8_t(band);
      for (int i = 0; i < 4; i++) pic->sao_offsets[(addr * 3 + c) * 4 + i] = offs[i];
    } else {
      int eo;
      if (c <= 1) { eo = int(d.bypassN(2)); if (c == 1) chromaEo = eo; }
      else eo = chromaEo;
      pic->sao_type[addr * 3 + c] = int8_t(1 + eo);
      pic->sao_offsets[(addr * 3 + c) * 4 + 0] = offs[0];
      pic->sao_offsets[(addr * 3 + c) * 4 + 1] = offs[1];
      pic->sao_offsets[(addr * 3 + c) * 4 + 2] = -offs[2];
      pic->sao_offsets[(addr * 3 + c) * 4 + 3] = -offs[3];
    }
  }
}

// ---------------------------------------------------------------------------
int SliceParser::predictQp(int x, int y) {
  int qgLog2 = log2Ctb - pps->diff_cu_qp_delta_depth;
  int xq = (x >> qgLog2) << qgLog2;
  int yq = (y >> qgLog2) << qgLog2;
  int prev = lastQp;
  auto sameCtb = [&](int nx, int ny) {
    return (nx >> log2Ctb) == (xq >> log2Ctb) && (ny >> log2Ctb) == (yq >> log2Ctb);
  };
  int qa = prev, qb = prev;
  if (xq > 0 && sameCtb(xq - 1, yq) && available(xq - 1, yq, xq, yq))
    qa = pic->qp[size_t(yq >> 2) * w4() + ((xq - 1) >> 2)];
  if (yq > 0 && sameCtb(xq, yq - 1) && available(xq, yq - 1, xq, yq))
    qb = pic->qp[size_t((yq - 1) >> 2) * w4() + (xq >> 2)];
  return (qa + qb + 1) >> 1;
}

void SliceParser::parseCqt(int x, int y, int log2size, int depth) {
  int size = 1 << log2size;
  bool inside = (x + size <= W) && (y + size <= H);
  if (pps->cu_qp_delta_enabled && log2size >= log2Ctb - pps->diff_cu_qp_delta_depth) {
    qpDeltaCoded = false;
    cuQpDelta = 0;
    qpPred = predictQp(x, y);
  }
  if (sh->cu_chroma_qp_offset_enabled &&
      log2size >= log2Ctb - pps->diff_cu_chroma_qp_offset_depth) {
    chromaQpAdjCoded = false;
    chromaQpAdj = 0;
  }
  int split;
  if (inside && log2size > sps->log2_min_cb) {
    int ctx = 0;
    if (available(x - 1, y, x, y, false) &&
        pic->depth[size_t(y >> 2) * w4() + ((x - 1) >> 2)] > depth) ctx++;
    if (available(x, y - 1, x, y, false) &&
        pic->depth[size_t((y - 1) >> 2) * w4() + (x >> 2)] > depth) ctx++;
    split = d.bin(bank.st[CTX_SPLIT_CU + ctx]);
  } else split = log2size > sps->log2_min_cb ? 1 : 0;
  if (split) {
    int h = size >> 1;
    const int off[4][2] = {{0, 0}, {h, 0}, {0, h}, {h, h}};
    for (auto& o : off) {
      int nx = x + o[0], ny = y + o[1];
      if (nx < W && ny < H) parseCqt(nx, ny, log2size - 1, depth + 1);
    }
    return;
  }
  parseCu(x, y, log2size, depth);
}

void SliceParser::parseCu(int x, int y, int log2size, int depth) {
  int size = 1 << log2size;
  setRect8(pic->depth, x, y, size, size, int8_t(depth));
  crossCompAlpha = 0;

  cuTqBypass = 0;
  if (pps->transquant_bypass_enabled)
    cuTqBypass = d.bin(bank.st[CTX_TRANSQUANT_BYPASS]);
  setRect8(pic->tq_bypass, x, y, size, size, int8_t(cuTqBypass));

  int skip = 0;
  if (sh->slice_type != 2) {
    int ctx = 0;
    if (available(x - 1, y, x, y, false) && map8(pic->skip, x - 1, y)) ctx++;
    if (available(x, y - 1, x, y, false) && map8(pic->skip, x, y - 1)) ctx++;
    skip = d.bin(bank.st[CTX_SKIP + ctx]);
  }
  if (skip) {
    setRect8(pic->skip, x, y, size, size, 1);
    setRect8(pic->pred_mode, x, y, size, size, MODE_INTER);
    setRect8(pic->part_size, x, y, size, size, SZ_2Nx2N);
    int mergeIdx = parseMergeIdx();
    applyMerge(x, y, size, size, mergeIdx, x, y, size, 0);
    markCuEdges(x, y, size);
    finishCu(x, y, size);
    return;
  }
  setRect8(pic->skip, x, y, size, size, 0);

  int predMode = MODE_INTRA;
  if (sh->slice_type != 2)
    predMode = d.bin(bank.st[CTX_PRED_MODE]) ? MODE_INTRA : MODE_INTER;
  setRect8(pic->pred_mode, x, y, size, size, int8_t(predMode));
  cuPredMode = predMode;

  int partSize;
  if (predMode == MODE_INTRA) {
    partSize = SZ_2Nx2N;
    if (log2size == sps->log2_min_cb)
      if (!d.bin(bank.st[CTX_PART_SIZE])) partSize = SZ_NxN;
  } else partSize = parseInterPartSize(log2size);
  setRect8(pic->part_size, x, y, size, size, int8_t(partSize));
  markCuEdges(x, y, size);

  if (predMode == MODE_INTRA) {
    if (partSize == SZ_2Nx2N && sps->pcm_enabled &&
        log2size >= sps->log2_min_ipcm && log2size <= sps->log2_max_ipcm) {
      if (d.term()) {
        parsePcm(x, y, log2size);
        finishCu(x, y, size);
        return;
      }
    }
    parseIntraPredInfo(x, y, log2size, partSize);
    parseTtRoot(x, y, log2size, partSize, MODE_INTRA, false);
  } else {
    parseInterPredInfo(x, y, log2size, depth, partSize);
    bool merge2N = (partSize == SZ_2Nx2N && lastPuMerge);
    parseTtRoot(x, y, log2size, partSize, MODE_INTER, merge2N);
  }
  finishCu(x, y, size);
}

int SliceParser::parseInterPartSize(int log2size) {
  int maxBits = 2;
  bool atMin = log2size == sps->log2_min_cb;
  if (atMin && (1 << log2size) != 8) maxBits = 3;
  int mode = 0;
  for (int i = 0; i < maxBits; i++) {
    if (d.bin(bank.st[CTX_PART_SIZE + i])) break;
    mode++;
  }
  int part = mode;
  if (sps->amp_enabled && !atMin) {
    if (part == SZ_2NxN) {
      if (!d.bin(bank.st[CTX_PART_SIZE + 3]))
        part = d.bypass() == 0 ? SZ_2NxnU : SZ_2NxnD;
    } else if (part == SZ_Nx2N) {
      if (!d.bin(bank.st[CTX_PART_SIZE + 3]))
        part = d.bypass() == 0 ? SZ_nLx2N : SZ_nRx2N;
    }
  }
  return part;
}

int SliceParser::parseMergeIdx() {
  int n = sh->max_num_merge_cand;
  int idx = 0;
  if (n > 1 && d.bin(bank.st[CTX_MERGE_IDX])) {
    idx = 1;
    while (idx < n - 1 && d.bypass()) idx++;
  }
  return idx;
}

void SliceParser::intraMpm(int x, int y, int preds[3]) {
  int left = DC, above = DC;
  if (available(x - 1, y, x, y, false) &&
      map8(pic->pred_mode, x - 1, y) == MODE_INTRA && !map8(pic->pcm, x - 1, y))
    left = map8(pic->intra_y, x - 1, y);
  if (y % ctb != 0 && available(x, y - 1, x, y, false) &&
      map8(pic->pred_mode, x, y - 1) == MODE_INTRA && !map8(pic->pcm, x, y - 1))
    above = map8(pic->intra_y, x, y - 1);
  if (left == above) {
    if (left > 1) {
      preds[0] = left;
      preds[1] = ((left + 29) % 32) + 2;
      preds[2] = ((left - 1) % 32) + 2;
    } else { preds[0] = PLANAR; preds[1] = DC; preds[2] = VER; }
  } else {
    preds[0] = left; preds[1] = above;
    if (left != PLANAR && above != PLANAR) preds[2] = PLANAR;
    else if (left != DC && above != DC) preds[2] = DC;
    else preds[2] = VER;
  }
}

void SliceParser::parseIntraPredInfo(int x, int y, int log2size, int partSize) {
  int size = 1 << log2size;
  int npu = partSize == SZ_NxN ? 4 : 1;
  int half = size >> 1;
  int puPos[4][2] = {{x, y}, {x + half, y}, {x, y + half}, {x + half, y + half}};
  int puSize = npu == 1 ? size : half;
  int mpmFlags[4];
  for (int j = 0; j < npu; j++) mpmFlags[j] = d.bin(bank.st[CTX_INTRA_LUMA_MPM]);
  int modes[4];
  for (int j = 0; j < npu; j++) {
    int px = puPos[j][0], py = puPos[j][1];
    int preds[3];
    intraMpm(px, py, preds);
    int mode;
    if (mpmFlags[j]) {
      if (d.bypass()) mode = preds[1 + d.bypass()];
      else mode = preds[0];
    } else {
      mode = int(d.bypassN(5));
      int sp[3] = {preds[0], preds[1], preds[2]};
      std::sort(sp, sp + 3);
      for (int i = 0; i < 3; i++) mode += (mode >= sp[i]);
    }
    modes[j] = mode;
    setRect8(pic->intra_y, px, py, puSize, puSize, int8_t(mode));
  }
  if (sps->chroma_format_idc != 0) {
    int nChroma = (sps->chroma_format_idc == 3 && npu == 4) ? npu : 1;
    for (int j = 0; j < nChroma; j++) {
      int px = puPos[j][0], py = puPos[j][1];
      int csize = nChroma == 4 ? puSize : size;
      int cmode;
      if (d.bin(bank.st[CTX_INTRA_CHROMA_MODE]) == 0) cmode = DM_CHROMA;
      else {
        int idx = int(d.bypassN(2));
        int allowed[4] = {PLANAR, VER, HOR, DC};
        for (int i = 0; i < 4; i++)
          if (allowed[i] == modes[j]) { allowed[i] = 34; break; }
        cmode = allowed[idx];
      }
      int realC = cmode == DM_CHROMA ? modes[j] : cmode;
      setRect8(pic->intra_c, px, py, csize, csize, int8_t(realC));
      setRect8(pic->chroma_dm, px, py, csize, csize, cmode == DM_CHROMA ? 1 : 0);
    }
  }
}

void SliceParser::parseInterPredInfo(int x, int y, int log2size, int depth,
                                     int partSize) {
  int size = 1 << log2size;
  lastPuMerge = false;
  int s = size, q = size >> 2, h = size >> 1;
  int parts[4][4];
  int nparts = 1;
  switch (partSize) {
    case SZ_2Nx2N: { int t[4] = {0, 0, s, s}; memcpy(parts[0], t, 16); nparts = 1; break; }
    case SZ_2NxN: { int t0[4] = {0, 0, s, h}, t1[4] = {0, h, s, h}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
    case SZ_Nx2N: { int t0[4] = {0, 0, h, s}, t1[4] = {h, 0, h, s}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
    case SZ_NxN: { int t0[4] = {0, 0, h, h}, t1[4] = {h, 0, h, h}, t2[4] = {0, h, h, h}, t3[4] = {h, h, h, h}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); memcpy(parts[2], t2, 16); memcpy(parts[3], t3, 16); nparts = 4; break; }
    case SZ_2NxnU: { int t0[4] = {0, 0, s, q}, t1[4] = {0, q, s, s - q}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
    case SZ_2NxnD: { int t0[4] = {0, 0, s, s - q}, t1[4] = {0, s - q, s, q}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
    case SZ_nLx2N: { int t0[4] = {0, 0, q, s}, t1[4] = {q, 0, s - q, s}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
    case SZ_nRx2N: { int t0[4] = {0, 0, s - q, s}, t1[4] = {s - q, 0, q, s}; memcpy(parts[0], t0, 16); memcpy(parts[1], t1, 16); nparts = 2; break; }
  }
  for (int pu = 0; pu < nparts; pu++) {
    int px = x + parts[pu][0], py = y + parts[pu][1];
    int w = parts[pu][2], hh = parts[pu][3];
    parsePu(px, py, w, hh, x, y, size, depth, partSize, pu);
    for (int yy = py >> 2; yy < (py + hh) >> 2; yy++)
      pic->edge_flags[size_t(yy) * w4() + (px >> 2)] |= EF_PU_L;
    for (int xx = px >> 2; xx < (px + w) >> 2; xx++)
      pic->edge_flags[size_t(py >> 2) * w4() + xx] |= EF_PU_T;
  }
}

void SliceParser::parsePu(int px, int py, int w, int h, int cx, int cy,
                          int cuSize, int depth, int partSize, int puIdx) {
  int merge = d.bin(bank.st[CTX_MERGE_FLAG]);
  lastPuMerge = merge != 0;
  if (merge) {
    int mergeIdx = parseMergeIdx();
    applyMerge(px, py, w, h, mergeIdx, cx, cy, cuSize, puIdx);
    return;
  }
  int interDir = 1;
  if (sh->slice_type == 0) interDir = parseInterDir(cuSize, depth, partSize);
  int mvd[2][2] = {{0, 0}, {0, 0}};
  int refIdx[2] = {-1, -1};
  int mvpIdx[2] = {0, 0};
  for (int l = 0; l < 2; l++) {
    bool use = (interDir == 3) || (interDir == l + 1);
    if (!use || sh->num_ref_idx[l] == 0) continue;
    refIdx[l] = parseRefIdx(l);
    if (sh->mvd_l1_zero && l == 1 && interDir == 3) { mvd[l][0] = mvd[l][1] = 0; }
    else parseMvd(mvd[l]);
    mvpIdx[l] = d.bin(bank.st[CTX_MVP_IDX]);
  }
  applyAmvp(px, py, w, h, interDir, refIdx, mvd, mvpIdx);
}

int SliceParser::parseInterDir(int cuSize, int depth, int partSize) {
  int sym = 0;
  if (partSize == SZ_2Nx2N || cuSize != 8)
    sym = d.bin(bank.st[CTX_INTER_DIR + depth]);
  if (sym) return 3;
  return 1 + d.bin(bank.st[CTX_INTER_DIR + 4]);
}

int SliceParser::parseRefIdx(int l) {
  if (sh->num_ref_idx[l] <= 1) return 0;
  if (!d.bin(bank.st[CTX_REF_IDX])) return 0;
  int nref = sh->num_ref_idx[l] - 2;
  int i = 0;
  while (i < nref) {
    int b = (i == 0) ? d.bin(bank.st[CTX_REF_IDX + 1]) : d.bypass();
    if (!b) break;
    i++;
  }
  return i + 1;
}

void SliceParser::parseMvd(int mv[2]) {
  int gr0x = d.bin(bank.st[CTX_MVD]);
  int gr0y = d.bin(bank.st[CTX_MVD]);
  int ax = gr0x, ay = gr0y;
  if (gr0x) ax += d.bin(bank.st[CTX_MVD + 1]);
  if (gr0y) ay += d.bin(bank.st[CTX_MVD + 1]);
  if (gr0x) {
    if (ax == 2) ax += d.egk(1);
    if (d.bypass()) ax = -ax;
  }
  if (gr0y) {
    if (ay == 2) ay += d.egk(1);
    if (d.bypass()) ay = -ay;
  }
  mv[0] = ax; mv[1] = ay;
}

void SliceParser::parsePcm(int x, int y, int log2size) {
  int size = 1 << log2size;
  setRect8(pic->pcm, x, y, size, size, 1);
  setRect8(pic->intra_y, x, y, size, size, DC);
  setRect8(pic->intra_c, x, y, size, size, DC);
  // bitPos() is just past the flush's last bit (9 bits read at start, one
  // per renormalising shift); pcm_alignment_zero_bits follow only while it
  // is not byte-aligned, so the samples start at the next byte boundary at
  // or after it
  d.seekBit((d.bitPos() + 7) & ~size_t(7));
  int ncomp = sps->chroma_format_idc ? 3 : 1;
  for (int c = 0; c < ncomp; c++) {
    int sx = c ? sps->ssx() : 0, sy = c ? sps->ssy() : 0;
    int w = size >> sx, h = size >> sy;
    int bits = c == 0 ? sps->pcm_bd_luma : sps->pcm_bd_chroma;
    PcmMeta m{c, x >> sx, y >> sy, w, h, bits, int32_t(pcmSampSink->size())};
    pcmSink->push_back(m);
    for (int i = 0; i < w * h; i++)
      pcmSampSink->push_back(int32_t(d.readBits(bits)));
  }
  d.range = 510;
  d.offset = d.readBits(9);
}

// ---------------------------------------------------------------------------
void SliceParser::parseTtRoot(int x, int y, int log2size, int partSize,
                              int predMode, bool merge2Nx2N) {
  if (predMode == MODE_INTER) {
    int rootCbf = merge2Nx2N ? 1 : d.bin(bank.st[CTX_QT_ROOT_CBF]);
    setRect8(pic->root_cbf, x, y, 1 << log2size, 1 << log2size,
             int8_t(rootCbf));
    if (!rootCbf) return;
  }
  int maxTrDepth = 1 + (predMode == MODE_INTRA ? sps->max_tr_hierarchy_intra
                                               : sps->max_tr_hierarchy_inter);
  int intraSplit = (predMode == MODE_INTRA && partSize == SZ_NxN) ? 1 : 0;
  int interSplit = (sps->max_tr_hierarchy_inter == 0 && predMode == MODE_INTER &&
                    partSize != SZ_2Nx2N) ? 1 : 0;
  if (log2size < sps->log2_min_tb + maxTrDepth - 1 + interSplit + intraSplit)
    minTuLog2 = sps->log2_min_tb;
  else
    minTuLog2 = std::min(log2size - (maxTrDepth - 1 + interSplit + intraSplit),
                         sps->log2_max_tb);
  cuX = x; cuY = y; cuLog2 = log2size;
  cuPredMode = predMode;
  cuPartSize = partSize;
  int cb[2] = {1, 1}, cr[2] = {1, 1};
  tt(x, y, log2size, 0, cb, cr, 0);
}

void SliceParser::parseCbfChroma(int log2size, int trDepth, bool is422,
                                 bool lowest, int out[2]) {
  int ctx = 5 + trDepth;
  if (!is422) {
    int v = d.bin(bank.st[CTX_QT_CBF + ctx]);
    out[0] = out[1] = v;
    return;
  }
  // 4:2:2: the two square sub-TU CBFs are coded only at the lowest TU level
  // or when the chroma block cannot quad-split further (reference
  // TDecSbac::parseQtCbf); higher levels code one combined bin.
  bool canQuadSplit = (log2size - 1) >= 3;
  if (lowest || !canQuadSplit) {
    out[0] = d.bin(bank.st[CTX_QT_CBF + ctx]);
    out[1] = d.bin(bank.st[CTX_QT_CBF + ctx]);
  } else {
    int v = d.bin(bank.st[CTX_QT_CBF + ctx]);
    out[0] = out[1] = v;
  }
}

void SliceParser::tt(int x, int y, int log2size, int trDepth, int parentCb[2],
                     int parentCr[2], int blkIdx) {
  bool intraNxNRoot = (cuPredMode == MODE_INTRA && cuPartSize == SZ_NxN &&
                       log2size == cuLog2);
  bool interForced = (sps->max_tr_hierarchy_inter == 0 && cuPredMode == MODE_INTER &&
                      cuPartSize != SZ_2Nx2N && log2size == cuLog2);
  int subdiv;
  if (intraNxNRoot) subdiv = 1;
  else if (interForced) subdiv = log2size > minTuLog2 ? 1 : 0;
  else if (log2size > sps->log2_max_tb) subdiv = 1;
  else if (log2size == sps->log2_min_tb || log2size == minTuLog2) subdiv = 0;
  else subdiv = d.bin(bank.st[CTX_TRANS_SUBDIV + (5 - log2size)]);

  bool hasChroma = sps->chroma_format_idc != 0;
  bool is422 = sps->chroma_format_idc == 2;
  int cbfCb[2] = {parentCb[0], parentCb[1]};
  int cbfCr[2] = {parentCr[0], parentCr[1]};
  if (hasChroma && (log2size > 2 || sps->chroma_format_idc == 3)) {
    bool first = trDepth == 0;
    bool lowest = subdiv == 0;
    if (first || parentCb[0] || parentCb[1])
      parseCbfChroma(log2size, trDepth, is422, lowest, cbfCb);
    else cbfCb[0] = cbfCb[1] = 0;
    if (first || parentCr[0] || parentCr[1])
      parseCbfChroma(log2size, trDepth, is422, lowest, cbfCr);
    else cbfCr[0] = cbfCr[1] = 0;
  }
  if (subdiv) {
    int h = 1 << (log2size - 1);
    const int off[4][2] = {{0, 0}, {h, 0}, {0, h}, {h, h}};
    for (int i = 0; i < 4; i++)
      tt(x + off[i][0], y + off[i][1], log2size - 1, trDepth + 1, cbfCb, cbfCr, i);
    return;
  }
  int cbfY;
  if (cuPredMode == MODE_INTRA || trDepth > 0 ||
      (hasChroma && (cbfCb[0] || cbfCb[1] || cbfCr[0] || cbfCr[1])))
    cbfY = d.bin(bank.st[CTX_QT_CBF + (trDepth == 0 ? 1 : 0)]);
  else cbfY = 1;

  int size = 1 << log2size;
  setRect8(pic->cbf_y, x, y, size, size, int8_t(cbfY));
  for (int yy = y >> 2; yy < (y + size) >> 2; yy++)
    pic->edge_flags[size_t(yy) * w4() + (x >> 2)] |= EF_TU_L;
  for (int xx = x >> 2; xx < (x + size) >> 2; xx++)
    pic->edge_flags[size_t(y >> 2) * w4() + xx] |= EF_TU_T;

  emitTu(x, y, log2size, trDepth, blkIdx, cbfY, cbfCb, cbfCr);
}

int SliceParser::qpForComp(int comp) {
  int qpY = pps->cu_qp_delta_enabled ? finalQp() : sh->qp;
  if (comp == 0) return qpY + 6 * (sps->bit_depth_luma - 8);
  int offBd = 6 * (sps->bit_depth_chroma - 8);
  int off = comp == 1 ? pps->cb_qp_offset + sh->cb_qp_offset
                      : pps->cr_qp_offset + sh->cr_qp_offset;
  if (chromaQpAdj && !pps->chroma_qp_offset_list.empty())
    off += pps->chroma_qp_offset_list[chromaQpAdj - 1][comp - 1];
  int qpi = std::max(-offBd, std::min(57, qpY + off));
  if (qpi >= 0) {
    if (sps->chroma_format_idc == 1) qpi = kChromaQpScale420[qpi];
    else qpi = kChromaQpScaleClip[qpi];
  }
  return qpi + offBd;
}

void SliceParser::emitTu(int x, int y, int log2size, int trDepth, int blkIdx,
                         int cbfY, int cbfCb[2], int cbfCr[2]) {
  int size = 1 << log2size;
  int ssx = sps->ssx(), ssy = sps->ssy();
  bool hasChroma = sps->chroma_format_idc != 0;
  bool chromaHere = hasChroma && (log2size - ssx >= 2);
  bool chromaLast = hasChroma && !chromaHere && blkIdx == 3;
  // the PROPAGATED chroma cbf gates the chroma-QP adjustment even at 4x4
  // sub-TUs whose chroma coded at the parent (TDecEntropy.cpp:530)
  bool chromaCbf = cbfCb[0] || cbfCb[1] || cbfCr[0] || cbfCr[1];
  // dQP gating counts chroma cbfs stored at this part even when the chroma
  // blocks are coded at the parent node (TDecEntropy.cpp:505)
  bool anyCbf = cbfY || cbfCb[0] || cbfCb[1] || cbfCr[0] || cbfCr[1];

  if (anyCbf) {
    if (pps->cu_qp_delta_enabled && !qpDeltaCoded) {
      parseCuQpDelta();
      qpDeltaCoded = true;
    }
    if (sh->cu_chroma_qp_offset_enabled && chromaCbf && !cuTqBypass &&
        !chromaQpAdjCoded) {
      parseChromaQpAdj();
      chromaQpAdjCoded = true;
    }
  }
  if (cuPredMode == MODE_INTRA) {
    int mode = map8(pic->intra_y, x, y);
    int tuIdx = cbfY ? int(tuSink->size()) : -1;
    intraSink->push_back({0, x, y, size, size, mode, tuIdx});
  }
  if (cbfY) parseResidual(0, x, y, log2size, log2size);

  if (chromaHere || chromaLast) {
    int px, py, clog2, cpx, cpy;
    if (chromaLast) {
      px = x & ~((size << 1) - 1);
      py = y & ~((size << 1) - 1);
      clog2 = log2size + 1 - ssx;
      cpx = px >> ssx; cpy = py >> ssy;
    } else {
      clog2 = log2size - ssx;
      cpx = x >> ssx; cpy = y >> ssy;
    }
    // 4:2:2 chroma blocks are two square sub-TUs stacked vertically; each
    // sub-TU has its own residual and its own square intra prediction
    // (reference xIntraRecQT iterates TComTU sections)
    int nSub = sps->chroma_format_idc == 2 ? 2 : 1;
    int cs = 1 << clog2;
    for (int comp = 1; comp <= 2; comp++) {
      int* cbf = comp == 1 ? cbfCb : cbfCr;
      int alpha = 0;
      if (pps->cross_component_prediction && cbfY &&
          (cuPredMode == MODE_INTER || map8(pic->chroma_dm, x, y)))
        alpha = parseCrossComp(comp);
      for (int s = 0; s < nSub; s++) {
        int sy = cpy + s * cs;
        int tuIdx = -1;
        if (cbf[s]) {
          tuIdx = int(tuSink->size());
          parseResidual(comp, cpx, sy, clog2, clog2);
        } else if (alpha) {
          tuIdx = int(tuSink->size());
          TuMeta m{comp, cpx, sy, cs, cs, qpForComp(comp), 0, 0, 0, 0, alpha,
                   int32_t(coefSink->size())};
          tuSink->push_back(m);
          coefSink->resize(coefSink->size() + size_t(cs) * cs, 0);
          crossCompAlpha = 0;
        }
        if (cuPredMode == MODE_INTRA) {
          int cmode = map8(pic->intra_c, x, y);
          intraSink->push_back({comp, cpx, sy, cs, cs, cmode, tuIdx});
        }
      }
    }
  }
}

void SliceParser::parseCuQpDelta() {
  int v = 0;
  if (d.bin(bank.st[CTX_DQP])) {
    v = 1;
    while (v < 5 && d.bin(bank.st[CTX_DQP + 1])) v++;
  }
  if (v == 5) v += d.egk(0);
  if (v > 0 && d.bypass()) v = -v;
  cuQpDelta = v;
}

void SliceParser::parseChromaQpAdj() {
  int v = d.bin(bank.st[CTX_CHROMA_QP_ADJ_FLAG]);
  int tbl = pps->chroma_qp_offset_list.empty() ? 1 : int(pps->chroma_qp_offset_list.size());
  if (v && tbl > 1)
    v = unaryMax(&bank.st[0], CTX_CHROMA_QP_ADJ_IDC, CTX_CHROMA_QP_ADJ_IDC, tbl - 1) + 1;
  chromaQpAdj = v;
}

int SliceParser::parseCrossComp(int comp) {
  int base = CTX_CROSS_COMP + (comp == 2 ? 5 : 0);
  int alpha = 0;
  if (d.bin(bank.st[base])) {
    int sym = 0;
    if (d.bin(bank.st[base + 1])) {
      int s = 0;
      if (d.bin(bank.st[base + 2])) {
        s = 1;
        if (d.bin(bank.st[base + 3])) s = 2;
      }
      sym = s + 1;
    }
    int sign = d.bin(bank.st[base + 4]);
    alpha = sign ? -(1 << sym) : (1 << sym);
  }
  crossCompAlpha = alpha;
  return alpha;
}

int SliceParser::parseRdpcm(int comp) {
  int ch = comp ? 1 : 0;
  if (!d.bin(bank.st[CTX_RDPCM_FLAG + ch])) return 0;
  return 1 + d.bin(bank.st[CTX_RDPCM_DIR + ch]);
}

int SliceParser::readCoefRemain(int rice, bool limited, int maxDyn) {
  int prefix = 0, bit = 0;
  for (;;) {
    prefix++;
    bit = d.bypass();
    if (!bit) break;
    if (limited && prefix >= (32 - (3 + maxDyn)) + 3) { bit = 1; break; }
  }
  prefix -= 1 - bit;
  if (prefix < 3) return (prefix << rice) + int(d.bypassN(rice));
  if (limited) {
    int maxPre = 32 - (3 + maxDyn);
    int preLen = prefix - 3;
    int sufLen = preLen == maxPre ? (maxDyn - rice) : preLen;
    return int(d.bypassN(sufLen + rice)) + ((((1 << preLen) - 1) + 3) << rice);
  }
  return (((1 << (prefix - 3)) + 3 - 1) << rice) + int(d.bypassN(prefix - 3 + rice));
}

void SliceParser::parseLastSigXY(int w, int h, bool isChroma, int scanType,
                                 int& posX, int& posY) {
  if (scanType == SCAN_VER) std::swap(w, h);
  int log2w = 31 - __builtin_clz(w), log2h = 31 - __builtin_clz(h);
  int offX, offY, shX, shY;
  if (isChroma) {
    offX = offY = 15;
    shX = log2w - 2; shY = log2h - 2;
  } else {
    offX = 3 * (log2w - 2) + ((log2w - 1) >> 2);
    offY = 3 * (log2h - 2) + ((log2h - 1) >> 2);
    shX = (log2w + 1) >> 2; shY = (log2h + 1) >> 2;
  }
  posX = 0;
  while (posX < kGroupIdx[w - 1] && d.bin(bank.st[bank.off_last_x + offX + (posX >> shX)])) posX++;
  posY = 0;
  while (posY < kGroupIdx[h - 1] && d.bin(bank.st[bank.off_last_y + offY + (posY >> shY)])) posY++;
  if (posX > 3) {
    int n = (posX - 2) >> 1;
    posX = kMinInGroup[posX] + int(d.bypassN(n));
  }
  if (posY > 3) {
    int n = (posY - 2) >> 1;
    posY = kMinInGroup[posY] + int(d.bypassN(n));
  }
  if (scanType == SCAN_VER) std::swap(posX, posY);
}

void SliceParser::parseResidual(int comp, int x, int y, int log2w, int log2h) {
  int w = 1 << log2w, h = 1 << log2h;
  bool signHiding = pps->sign_data_hiding && !cuTqBypass;
  int rdpcmMode = 0;

  int tskip = 0;
  if (pps->transform_skip_enabled && !cuTqBypass &&
      log2w <= pps->log2_max_transform_skip_size &&
      log2h <= pps->log2_max_transform_skip_size)
    tskip = d.bin(bank.st[CTX_TRANSFORM_SKIP + (comp ? 1 : 0)]);
  bool isIntra = cuPredMode == MODE_INTRA;
  if (cuTqBypass && !isIntra && sps->explicit_rdpcm) {
    rdpcmMode = parseRdpcm(comp);
    if (rdpcmMode) signHiding = false;
  } else if (tskip && !isIntra && sps->explicit_rdpcm) {
    rdpcmMode = parseRdpcm(comp);
    if (rdpcmMode) signHiding = false;
  }
  int intraMode = -1;
  if (isIntra) {
    int lx = comp ? x << sps->ssx() : x;
    int ly = comp ? y << sps->ssy() : y;
    intraMode = comp == 0 ? map8(pic->intra_y, lx, ly) : map8(pic->intra_c, lx, ly);
    if (comp && sps->chroma_format_idc == 2) intraMode = kChroma422Map[intraMode];
    if (sps->implicit_rdpcm && (tskip || cuTqBypass) &&
        (intraMode == HOR || intraMode == VER)) {
      signHiding = false;
      rdpcmMode = intraMode == HOR ? 1 : 2;
    }
  }
  int scanType = SCAN_DIAG;
  if (isIntra) {
    int maxW = 8 >> (comp ? sps->ssx() : 0);
    int maxH = 8 >> (comp ? sps->ssy() : 0);
    if (w <= maxW && h <= maxH) {
      if (std::abs(intraMode - VER) <= 4) scanType = SCAN_HOR;
      else if (std::abs(intraMode - HOR) <= 4) scanType = SCAN_VER;
    }
  }
  bool singleCtx = sps->transform_skip_context && (tskip || cuTqBypass);
  int riceIdx = 2 * ((tskip || cuTqBypass) ? 1 : 0) + (comp ? 1 : 0);
  int bd = comp == 0 ? sps->bit_depth_luma : sps->bit_depth_chroma;
  int maxDyn = sps->extended_precision ? std::max(15, bd + 6) : 15;

  // ---- residual_coding -------------------------------------------------
  TuMeta meta{comp, x, y, w, h, qpForComp(comp),
              (comp == 0 && isIntra && w == 4 && h == 4) ? 1 : 0,
              tskip, cuTqBypass, rdpcmMode, comp ? crossCompAlpha : 0,
              int32_t(coefSink->size()), 0, 0};
  tuSink->push_back(meta);
  crossCompAlpha = 0;
  size_t coefBase = coefSink->size();
  coefSink->resize(coefBase + size_t(w) * h);  // NoInitAlloc: no zero-fill
  int32_t* coeff = coefSink->data() + coefBase;

  int ch = comp ? 1 : 0;
  int posX, posY;
  parseLastSigXY(w, h, ch, scanType, posX, posY);
  int blkLast = posX + (posY << log2w);

  const auto& scan = g_scans.getGrouped(w, h, scanType);
  int wg = w >> 2, hg = h >> 2;
  const auto& scanCg = g_scans.getCg(wg, hg, scanType);

  int scanPosLast = g_scans.getGroupedInv(w, h, scanType)[blkLast];

  // Zero the slot before scattering nonzero levels into it.  The
  // native-recon path reads only rows 0..last_row of the dominant
  // (transform) path, so there it suffices to zero the rows the scan can
  // touch: >=16-wide TUs always use the grouped diagonal scan, whose CG
  // subsets <= lastScanSet stay within cgy+cgx <= cgxL+cgyL.  Every other
  // consumer (Python/TPU bridge export, transform-skip / bypass rotation,
  // scaling lists, extended precision, internals API) reads the full
  // block and gets a fully zeroed slot.
  bool partialZero = noZeroCoefSlots && w >= 16 && !tskip && !cuTqBypass &&
                     !sps->scaling_list_enabled && !sps->extended_precision;
#if !defined(__AVX2__)
  // the partial-extent contract is honoured by the AVX2 residualFast path;
  // the scalar fallback reads full slots
  partialZero = false;
#endif
  if (partialZero) {
    int cgxL = (posX >> 2) + (posY >> 2);  // max CG diagonal
    int rowBound = std::min(h - 1, 4 * std::min(hg - 1, cgxL) + 3);
    memset(coeff, 0, sizeof(int32_t) * size_t(rowBound + 1) * w);
  } else {
    memset(coeff, 0, sizeof(int32_t) * size_t(w) * h);
  }

  int firstSigCtx;
  if (singleCtx) firstSigCtx = kSigSetStart[ch][3];
  else if (w == 4 && h == 4) firstSigCtx = kSigSetStart[ch][0];
  else if (w == 8 && h == 8) {
    firstSigCtx = kSigSetStart[ch][1];
    if (scanType != SCAN_DIAG) firstSigCtx += kNonDiag8x8Off[ch];
  } else firstSigCtx = kSigSetStart[ch][2];
  int sigBase = CTX_SIG + (ch ? 28 : 0);

  int lastScanSet = scanPosLast >> 4;
  int c1 = 1;
  int maxRow = 0, maxCol = 0;  // exact nonzero extent (for TuMeta)
  uint8_t sigCg[64] = {0};
  bool useRice = sps->persistent_rice_adaptation != 0;
  bool extPrec = sps->extended_precision != 0;
  bool alignBp = sps->cabac_bypass_alignment != 0;

  int scanPosSig = scanPosLast;
  for (int subset = lastScanSet; subset >= 0; subset--) {
    int subPos = subset << 4;
    int goRice = useRice ? riceStats[riceIdx] / 4 : 0;
    bool updateRice = useRice;
    int numNZ = 0, lastNZ = -1, firstNZ = 16;
    bool escape = false;
    int pos[16];
    if (scanPosSig == scanPosLast) {
      lastNZ = firstNZ = scanPosSig;
      scanPosSig--;
      pos[0] = blkLast;
      numNZ = 1;
    }
    int cgx = scanCg[subset] & 0xff, cgy = scanCg[subset] >> 8;
    int cgBlk = cgy * wg + cgx;
    if (subset == lastScanSet || subset == 0) sigCg[cgBlk] = 1;
    else {
      int right = cgx < wg - 1 ? sigCg[cgBlk + 1] : 0;
      int below = cgy < hg - 1 ? sigCg[cgBlk + wg] : 0;
      sigCg[cgBlk] = uint8_t(d.bin(bank.st[CTX_SIG_CG + 2 * ch + ((right || below) ? 1 : 0)]));
    }
    int pattern = 0;
    if (wg > 1 || hg > 1) {
      int right = cgx < wg - 1 ? sigCg[cgBlk + 1] : 0;
      int below = cgy < hg - 1 ? sigCg[cgBlk + wg] : 0;
      pattern = right + (below << 1);
    }
    for (; scanPosSig >= subPos; scanPosSig--) {
      int blkPos = scan[scanPosSig];
      int sig = 0;
      if (sigCg[cgBlk]) {
        if (scanPosSig > subPos || subset == 0 || numNZ) {
          int ctx;
          if (singleCtx) ctx = firstSigCtx;
          else {
            int py = blkPos >> log2w;
            int px = blkPos - (py << log2w);
            if (px + py == 0) ctx = 0;
            else if (w == 4 && h == 4) ctx = firstSigCtx + kCtxIndMap4x4[4 * py + px];
            else {
              int xin = px & 3, yin = py & 3, cnt;
              if (pattern == 0) { int t = xin + yin; cnt = t >= 3 ? 0 : (t >= 1 ? 1 : 2); }
              else if (pattern == 1) cnt = yin >= 2 ? 0 : (yin >= 1 ? 1 : 2);
              else if (pattern == 2) cnt = xin >= 2 ? 0 : (xin >= 1 ? 1 : 2);
              else cnt = 2;
              bool notFirst = ((px >> 2) + (py >> 2)) > 0;
              ctx = firstSigCtx + cnt + (notFirst ? kNotFirstGroupOff[ch] : 0);
            }
          }
          sig = d.bin(bank.st[sigBase + ctx]);
        } else sig = 1;
      }
      if (sig) {
        pos[numNZ++] = blkPos;
        if (lastNZ == -1) lastNZ = scanPosSig;
        firstNZ = scanPosSig;
      }
    }
    if (numNZ <= 0) continue;
    bool signHidden = (lastNZ - firstNZ) >= 4;
    int ctxSet = ch ? 4 + (c1 == 0 ? 1 : 0)
                    : (subset > 0 ? 2 : 0) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    int baseGt1 = CTX_GT1 + 4 * ctxSet;
    int absCoeff[16];
    for (int i = 0; i < numNZ; i++) absCoeff[i] = 1;
    int numC1 = std::min(numNZ, 8);
    int firstC2 = -1;
    for (int idx = 0; idx < numC1; idx++) {
      int b = d.bin(bank.st[baseGt1 + c1]);
      if (b) {
        c1 = 0;
        if (firstC2 == -1) firstC2 = idx;
        else escape = true;
      } else if (c1 < 3 && c1 > 0) c1++;
      absCoeff[idx] = b + 1;
    }
    if (c1 == 0 && firstC2 != -1) {
      int b = d.bin(bank.st[CTX_GT2 + ctxSet]);
      absCoeff[firstC2] = b + 2;
      if (b) escape = true;
    }
    escape = escape || (numNZ > 8);
    if (escape && alignBp) d.alignRange();
    int nsign = (signHidden && signHiding) ? numNZ - 1 : numNZ;
    uint32_t signs = nsign ? (d.bypassN(nsign) << (32 - nsign)) : 0;
    int firstCoeff2 = 1;
    if (escape) {
      for (int idx = 0; idx < numNZ; idx++) {
        int baseLevel = idx < 8 ? 2 + firstCoeff2 : 1;
        if (absCoeff[idx] == baseLevel) {
          int level = readCoefRemain(goRice, extPrec, maxDyn);
          absCoeff[idx] = level + baseLevel;
          if (absCoeff[idx] > (3 << goRice))
            goRice = useRice ? goRice + 1 : std::min(goRice + 1, 4);
          if (updateRice) {
            int initRice = riceStats[riceIdx] / 4;
            if (level >= (3 << initRice)) riceStats[riceIdx]++;
            else if (2 * level < (1 << initRice) && riceStats[riceIdx] > 0)
              riceStats[riceIdx]--;
            updateRice = false;
          }
        }
        if (absCoeff[idx] >= 2) firstCoeff2 = 0;
      }
    }
    int64_t absSum = 0;
    for (int i = 0; i < numNZ; i++) absSum += absCoeff[i];
    for (int idx = 0; idx < numNZ; idx++) {
      int v = absCoeff[idx];
      if (idx == numNZ - 1 && signHidden && signHiding) {
        if (absSum & 1) v = -v;
      } else {
        if (signs & 0x80000000u) v = -v;
        signs <<= 1;
      }
      int p = pos[idx];
      int row = p >> log2w, col = p - (row << log2w);
      if (row > maxRow) maxRow = row;
      if (col > maxCol) maxCol = col;
      coeff[p] = v;
    }
  }
  tuSink->back().last_row = maxRow;
  tuSink->back().last_col = maxCol;
}


// ---------------------------------------------------------------------------
// WPP-parallel slice parse (reference TDecGop.cpp:105-155 allocates one
// CABAC engine per substream; this is the actual concurrent realization).
// One worker per CTU row, each with a private SliceParser clone (own CABAC
// engine, context bank, Rice stats and list buffers).  Row r waits until
// row r-1 has finished col+2 CTUs before parsing col (Rec. 9.3.1 WPP
// ordering), takes its starting contexts from the row-above clone's
// after-2-CTUs snapshot, and appends parse products to private list
// buffers that are concatenated in row order afterwards -- so the result
// is bit- and order-identical to the sequential parse.
bool SliceParser::decodeSliceWpp(const uint8_t* data, size_t len,
                                 const SliceHeader& hdr, int sidx, int qp) {
  int hCtbs = sps->picHCtbs();
  if (!pps->entropy_coding_sync || pps->tiles_enabled || hdr.dependent ||
      hdr.segment_address != 0 || pps->cu_qp_delta_enabled ||
      sh->cu_chroma_qp_offset_enabled ||
      int(substreams.size()) != hCtbs || hCtbs < 2)
    return false;
  unsigned nthreads = std::thread::hardware_concurrency();
  if (const char* e = std::getenv("HEVC_WPP_THREADS")) {
    long v = std::strtol(e, nullptr, 10);
    nthreads = v < 0 ? 0 : unsigned(v);
  }
  if (nthreads < 2) return false;   // nothing to gain; sequential path

  struct Row {
    SliceParser p;                    // clone: own engine/contexts/sinks
    std::vector<TuMeta> tus;
    CoefBuf coefs;
    std::vector<IntraMeta> intras;
    std::vector<PcmMeta> pcms;
    std::vector<int32_t> pcmSamps;
    std::vector<PuMeta> pus;
    std::atomic<int> done{0};         // CTUs finished in this row
  };
  std::vector<std::unique_ptr<Row>> rows;
  for (int r = 0; r < hCtbs; r++) {
    rows.emplace_back(new Row{*this});
    Row& rw = *rows.back();
    rw.p.tuSink = &rw.tus; rw.p.coefSink = &rw.coefs;
    rw.p.intraSink = &rw.intras; rw.p.pcmSink = &rw.pcms;
    rw.p.pcmSampSink = &rw.pcmSamps; rw.p.puSink = &rw.pus;
  }

  auto rowWorker = [&](int r) {
    Row& rw = *rows[r];
    SliceParser& P = rw.p;
    P.d.start(data, len, substreams[size_t(r)] * 8);
    if (r == 0) {
      P.bank.init(hdr.slice_type, qp, hdr.cabac_init_flag);
      for (int i = 0; i < 4; i++) P.riceStats[i] = 0;
    } else {
      Row& up = *rows[r - 1];
      while (up.done.load(std::memory_order_acquire) < 2)
        std::this_thread::yield();
      P.bank = up.p.wppBank;
      for (int i = 0; i < 4; i++) P.riceStats[i] = up.p.wppRice[i];
    }
    P.lastQp = qp; P.qpPred = qp;
    P.cuQpDelta = 0; P.qpDeltaCoded = false;
    P.chromaQpAdj = 0; P.chromaQpAdjCoded = false;
    int ctbL = P.ctb;
    for (int col = 0; col < P.wCtbs; col++) {
      if (r > 0) {
        Row& up = *rows[r - 1];
        int need = std::min(col + 2, P.wCtbs);
        while (up.done.load(std::memory_order_acquire) < need)
          std::this_thread::yield();
      }
      int addr = r * P.wCtbs + col;
      int cx = col << P.log2Ctb;
      int cy = r << P.log2Ctb;
      int x4lo = cx >> 2;
      int x4hi = std::min((cx + ctbL) >> 2, pic->w4);
      int y4hi = std::min((cy + ctbL) >> 2, pic->h4);
      int nx4 = x4hi - x4lo;
      for (int yy = cy >> 2; yy < y4hi; yy++) {
        size_t i = size_t(yy) * P.w4() + x4lo;
        std::fill_n(&pic->slice_idx[i], nx4, sidx);
        memset(&pic->cbf_y[i], 0, size_t(nx4));
        memset(&pic->pcm[i], 0, size_t(nx4));
        memset(&pic->edge_flags[i], 0, size_t(nx4));
        memset(&pic->skip[i], 0, size_t(nx4));
        memset(&pic->deblock_disable[i],
               uint8_t(int8_t(hdr.deblocking_disabled)), size_t(nx4));
        memset(&pic->beta_offset[i],
               uint8_t(int8_t(hdr.beta_offset_div2 * 2)), size_t(nx4));
        memset(&pic->tc_offset[i],
               uint8_t(int8_t(hdr.tc_offset_div2 * 2)), size_t(nx4));
        memset(&pic->lf_across[i],
               uint8_t(int8_t(hdr.loop_filter_across_slices)), size_t(nx4));
      }
      if (sps->sao_enabled) P.parseSaoCtu(addr, cx, cy);
      P.parseCqt(cx, cy, P.log2Ctb, 0);
      if (col == 1) {
        P.wppBank = P.bank;
        for (int i = 0; i < 4; i++) P.wppRice[i] = P.riceStats[i];
        P.wppSavedValid = true;
      }
      rw.done.store(col + 1, std::memory_order_release);
      int isLast = P.d.term();       // end_of_slice_segment_flag
      if (isLast) break;
      if (col == P.wCtbs - 1) P.d.term();  // end_of_subset_one_bit
    }
  };

  // bounded pool: rows must start in order (row r spins on row r-1)
  unsigned pool = std::min<unsigned>(nthreads, unsigned(hCtbs));
  std::atomic<int> nextRow{0};
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < pool; t++)
    threads.emplace_back([&] {
      for (;;) {
        int r = nextRow.fetch_add(1, std::memory_order_relaxed);
        if (r >= hCtbs) return;
        rowWorker(r);
      }
    });
  for (auto& th : threads) th.join();

  // concatenate per-row products in row order with index rebasing
  for (auto& rp : rows) {
    Row& rw = *rp;
    int32_t tuBase = int32_t(pic->tu_list.size());
    int32_t coefBase = int32_t(pic->coeffs.size());
    int32_t sampBase = int32_t(pic->pcm_samples.size());
    for (TuMeta m : rw.tus) {
      m.coeff_off += coefBase;
      pic->tu_list.push_back(m);
    }
    pic->coeffs.insert(pic->coeffs.end(), rw.coefs.begin(), rw.coefs.end());
    for (IntraMeta m : rw.intras) {
      if (m.tu_index >= 0) m.tu_index += tuBase;
      pic->intra_list.push_back(m);
    }
    for (PcmMeta m : rw.pcms) {
      m.sample_off += sampBase;
      pic->pcm_list.push_back(m);
    }
    pic->pcm_samples.insert(pic->pcm_samples.end(), rw.pcmSamps.begin(),
                            rw.pcmSamps.end());
    pic->inter_list.insert(pic->inter_list.end(), rw.pus.begin(),
                           rw.pus.end());
  }
  depSavedValid = false;
  wppSavedValid = false;
  return true;
}

}  // namespace hevc
