// Copied from libhm_tpu/hostdec/native/recon.cpp
// Native reconstruction backend: residual synthesis, intra prediction,
// motion compensation, deblocking and SAO for one parsed Picture.
//
// Port targets (bit-exact):
//   dequant / inverse transform  <- TComTrQuant::xDeQuant, partialButterfly*
//                                   (reference: TLibCommon/TComTrQuant.cpp)
//   intra prediction             <- TComPrediction::predIntraAng/Planar/DC
//                                   (TLibCommon/TComPrediction.cpp:245-845)
//   reference sample fill        <- TComPattern::fillReferenceSamples
//                                   (TLibCommon/TComPattern.cpp:310)
//   MC interpolation             <- TComInterpolationFilter (filter<N>)
//   deblocking                   <- TComLoopFilter::xEdgeFilterLuma/Chroma
//   SAO                          <- TComSampleAdaptiveOffset::offsetBlock
//
// Structure mirrors the validated numpy oracle (hostdec/refimpl.py,
// recon_np.py, loopfilter_np.py): whole-picture flat maps in, planes out.

#include "hevcdec.h"
#include "simd.h"
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <map>
#include <tuple>
#include <cstring>
#include <functional>

namespace hevc {

// ---------------------------------------------------------------------------
// tables
// ---------------------------------------------------------------------------
static const int kDctBase[32] = {
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4};

static int dctEntry(int idx) {
  int i = idx % 128;
  if (i < 32) return kDctBase[i];
  if (i == 32) return 0;
  if (i <= 64) return -kDctBase[64 - i];
  if (i < 96) return -kDctBase[i - 64];
  return kDctBase[128 - i];
}

struct TransformTables {
  // forward matrices M[k][j] (rows are basis vectors); inverse uses M^T
  std::vector<int32_t> dct[6];  // index by log2 size (2..5)
  int32_t dst4[16];
  TransformTables() {
    static const int d4[16] = {29, 55, 74, 84, 74, 74, 0, -74,
                               84, -29, -74, 55, 55, -84, 74, -29};
    memcpy(dst4, d4, sizeof(d4));
    for (int lg = 2; lg <= 5; lg++) {
      int n = 1 << lg, step = 32 / n;
      dct[lg].resize(size_t(n) * n);
      for (int k = 0; k < n; k++)
        for (int j = 0; j < n; j++)
          dct[lg][size_t(k) * n + j] = dctEntry(k * step * (2 * j + 1));
    }
  }
};
static const TransformTables kT;

static const int kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

#if defined(__AVX2__)
// Pair-interleaved int16 transform tables for the vpmaddwd inverse-transform
// kernels (see simd.h for the formulation).  For each size n:
//   pairRows[p][2j+e] = M[2p+e][j]      (stage-2: out = t1 @ M)
//   colPair[i][p]     = M[2p][i] | M[2p+1][i]<<16   (stage-1: t1 = M^T @ c)
struct ItxTables {
  std::vector<int16_t> pairRows[6];
  std::vector<int32_t> colPair[6];
  int16_t dstPairRows[2][8];
  int32_t dstColPair[4][2];
  ItxTables() {
    for (int lg = 2; lg <= 5; lg++) {
      int n = 1 << lg;
      const int32_t* m = kT.dct[lg].data();
      pairRows[lg].resize(size_t(n / 2) * 2 * n);
      colPair[lg].resize(size_t(n) * (n / 2));
      for (int p = 0; p < n / 2; p++)
        for (int j = 0; j < n; j++) {
          pairRows[lg][size_t(p) * 2 * n + 2 * j] = int16_t(m[(2 * p) * n + j]);
          pairRows[lg][size_t(p) * 2 * n + 2 * j + 1] =
              int16_t(m[(2 * p + 1) * n + j]);
        }
      for (int i = 0; i < n; i++)
        for (int p = 0; p < n / 2; p++)
          colPair[lg][size_t(i) * (n / 2) + p] =
              int32_t(uint16_t(int16_t(m[(2 * p) * n + i]))) |
              (int32_t(uint16_t(int16_t(m[(2 * p + 1) * n + i]))) << 16);
    }
    for (int p = 0; p < 2; p++)
      for (int j = 0; j < 4; j++) {
        dstPairRows[p][2 * j] = int16_t(kT.dst4[(2 * p) * 4 + j]);
        dstPairRows[p][2 * j + 1] = int16_t(kT.dst4[(2 * p + 1) * 4 + j]);
      }
    for (int i = 0; i < 4; i++)
      for (int p = 0; p < 2; p++)
        dstColPair[i][p] =
            int32_t(uint16_t(int16_t(kT.dst4[(2 * p) * 4 + i]))) |
            (int32_t(uint16_t(int16_t(kT.dst4[(2 * p + 1) * 4 + i]))) << 16);
  }
};
static const ItxTables kItx;
#endif

static const int kChromaQp420[58] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 33, 33, 34, 34,
    35, 35, 36, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51};

static int chromaQpScale(int fmt, int qpi) {
  if (fmt == 1) return kChromaQp420[qpi];
  if (fmt == 0) return 0;
  return qpi < 51 ? qpi : 51;
}

static const int kBetaTbl[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
static const int kTcTbl[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    13, 14, 16, 18, 20, 22, 24};

static const int kLumaF[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
static const int kChromaF[8][4] = {
    {0, 64, 0, 0},  {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

static const int kAng[35] = {0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5,
                             -9, -13, -17, -21, -26, -32, -26, -21, -17, -13,
                             -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
static int invAngOf(int ang) {
  switch (ang) {
    case -2: return 4096; case -5: return 1638; case -9: return 910;
    case -13: return 630; case -17: return 482; case -21: return 390;
    case -26: return 315; case -32: return 256; default: return 0;
  }
}

static const int kC422Map[36] = {0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13,
                                 15, 17, 18, 19, 20, 21, 22, 23, 23, 24, 24,
                                 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31,
                                 36};

static const int kIfPrec = 14;
static const int kIfOffs = 1 << (kIfPrec - 1);
enum { I16MIN = -32768, I16MAX = 32767 };

static inline int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}


// ---------------------------------------------------------------------------
struct ReconCtx {
  const SPS* sps;
  const PPS* pps;
  Picture* pic;
  std::function<Picture*(int)> findRef;  // poc -> reconstructed Picture

  int ncomp, Wp, Hp, log2Ctb, ctb, wCtbs, hCtbs;
  std::vector<int64_t> zmap;     // [h4*w4]
  std::vector<int32_t> tileMap;  // [nctu]
  std::vector<int16_t> resPool;  // residuals, same layout/offsets as coeffs
                                 // (every residual path clips to int16)
  // geometry caches: the ctx is reused across pictures (thread_local in
  // reconstructPicture), and zmap/tileMap only depend on these keys — a
  // 1080p zmap is a 1 MB fill per picture otherwise
  int zKeyW4 = -1, zKeyH4 = -1, zKeyLg = -1;
  std::vector<int32_t> tKey;     // tile geometry fingerprint

  // per-block scratch.  Members rather than function-level
  // `static thread_local`: the ctx is the single thread_local object, so
  // __tls_get_addr runs once per picture instead of once per block/row
  // (it showed up at ~5% of decode CPU).
  int16_t s_cp[32 * 34] = {}, s_t16[32 * 32] = {};      // itx16
  int16_t s_c16[32 * 33] = {}, s_o16[32 * 32] = {};     // itxAvx2/residualFast
  int32_t s_t32[32 * 32] = {}, s_acc[32 * 32] = {};     // inverseTransform
  int32_t s_arow[32] = {};
  int32_t s_scratch[32 * 32] = {};                      // buildResiduals
  int32_t s_acc32[64 + 16] = {};                        // interpBlockT
  std::vector<int16_t> s_tmp =
      std::vector<int16_t>((64 + 8) * 64);              // interpBlockT 2-stage
  std::vector<int16_t> s_p0 = std::vector<int16_t>(64 * 64);   // interStage
  std::vector<int16_t> s_p1 = std::vector<int16_t>(64 * 64);
  int32_t s_vals[4 * 64 + 1] = {};                      // reconIntraBlock
  uint8_t s_av[4 * 64 + 1] = {};
  int32_t s_leftBuf[2 * 64 + 1] = {}, s_topBuf[2 * 64 + 1] = {};
  int32_t s_nlBuf[2 * 64 + 1] = {}, s_ntBuf[2 * 64 + 1] = {};
  int32_t s_full[4 * 64 + 1] = {}, s_sm[4 * 64 + 1] = {};
  int32_t s_pred[64 * 64] = {};
  int32_t s_refBuf[2 * 64 + 1] = {};
  // dequant scaling matrices [sizeId][matrixId] upsampled to full size
  bool useScaling = false;
  std::vector<int32_t> scalMat[4][6];

  int w4() const { return pic->w4; }

  int compW(int c) const { return c ? sps->width >> sps->ssx() : sps->width; }
  int compH(int c) const { return c ? sps->height >> sps->ssy() : sps->height; }
  int planeW(int c) const { return c ? Wp >> sps->ssx() : Wp; }
  int planeH(int c) const { return c ? Hp >> sps->ssy() : Hp; }
  int bitDepth(int c) const {
    return c ? sps->bit_depth_chroma : sps->bit_depth_luma;
  }

  void buildGeometry() {
    ncomp = sps->chroma_format_idc ? 3 : 1;
    log2Ctb = sps->log2_ctb;
    ctb = 1 << log2Ctb;
    wCtbs = sps->picWCtbs();
    hCtbs = sps->picHCtbs();
    Wp = wCtbs << log2Ctb;
    Hp = hCtbs << log2Ctb;
    int n = log2Ctb - 2, m = 1 << n;
    if (zKeyW4 != pic->w4 || zKeyH4 != pic->h4 || zKeyLg != log2Ctb) {
      zKeyW4 = pic->w4; zKeyH4 = pic->h4; zKeyLg = log2Ctb;
      std::vector<int64_t> zin(size_t(m) * m);
      for (int yy = 0; yy < m; yy++)
        for (int xx = 0; xx < m; xx++) {
          int64_t z = 0;
          for (int b = 0; b < n; b++) {
            z |= int64_t((xx >> b) & 1) << (2 * b);
            z |= int64_t((yy >> b) & 1) << (2 * b + 1);
          }
          zin[size_t(yy) * m + xx] = z;
        }
      zmap.assign(size_t(pic->h4) * pic->w4, 0);
      int64_t parts = int64_t(m) * m;
      for (int cy = 0; cy < pic->h4; cy += m)
        for (int cx = 0; cx < pic->w4; cx += m) {
          int64_t base = (int64_t(cy / m) * wCtbs + cx / m) * parts;
          for (int yy = 0; yy < m; yy++)
            for (int xx = 0; xx < m; xx++)
              zmap[size_t(cy + yy) * pic->w4 + cx + xx] =
                  base + zin[size_t(yy) * m + xx];
        }
    }
    std::vector<int32_t> tk = {wCtbs, hCtbs, pps->tiles_enabled,
                               pps->num_tile_cols, pps->num_tile_rows,
                               pps->uniform_spacing};
    tk.insert(tk.end(), pps->tile_col_widths.begin(),
              pps->tile_col_widths.end());
    tk.insert(tk.end(), pps->tile_row_heights.begin(),
              pps->tile_row_heights.end());
    if (tk == tKey) return;
    tKey = std::move(tk);
    tileMap.assign(size_t(wCtbs) * hCtbs, 0);
    if (pps->tiles_enabled) {
      int nc = pps->num_tile_cols, nr = pps->num_tile_rows;
      std::vector<int> cb, rb;
      if (pps->uniform_spacing) {
        for (int i = 0; i <= nc; i++) cb.push_back(i * wCtbs / nc);
        for (int i = 0; i <= nr; i++) rb.push_back(i * hCtbs / nr);
      } else {
        cb.push_back(0);
        for (int v : pps->tile_col_widths) cb.push_back(cb.back() + v);
        cb.push_back(wCtbs);
        rb.push_back(0);
        for (int v : pps->tile_row_heights) rb.push_back(rb.back() + v);
        rb.push_back(hCtbs);
      }
      for (int y = 0; y < hCtbs; y++) {
        int tr = 0;
        while (!(rb[tr] <= y && y < rb[tr + 1])) tr++;
        for (int x = 0; x < wCtbs; x++) {
          int tc = 0;
          while (!(cb[tc] <= x && x < cb[tc + 1])) tc++;
          tileMap[size_t(y) * wCtbs + x] = tr * nc + tc;
        }
      }
    }
  }

  // -------------------------------------------------------------------------
  // residuals
  // -------------------------------------------------------------------------
  void buildScalingMatrices() {
    useScaling = sps->scaling_list_enabled != 0;
    if (!useScaling) return;
    const ScalingListData* d = nullptr;
    if (pps->scaling.present) d = &pps->scaling;
    else if (sps->scaling.present) d = &sps->scaling;
    for (int sizeId = 0; sizeId < 4; sizeId++) {
      int n = 4 << sizeId, base = std::min(8, n), ratio = n / base;
      for (int m = 0; m < 6; m++) {
        int srcId = sizeId == 3 ? (m / 3) * 3 : m;
        uint8_t lst[64];
        int dc;
        if (d) {
          memcpy(lst, d->coef[sizeId][srcId], 64);
          dc = d->dc[sizeId][srcId];
        } else {
          defaultScalingList(sizeId, srcId, lst, &dc);
        }
        auto& mat = scalMat[sizeId][m];
        mat.resize(size_t(n) * n);
        for (int y = 0; y < n; y++)
          for (int x = 0; x < n; x++)
            mat[size_t(y) * n + x] = lst[(y / ratio) * base + x / ratio];
        if (ratio > 1) mat[0] = dc;
      }
    }
  }

  void dequantTuScaling(const TuMeta& t, int32_t* out) {
    int bd = bitDepth(t.comp);
    int maxDyn = sps->extended_precision ? std::max(15, bd + 6) : 15;
    int log2w = 0;
    while ((1 << log2w) < t.w) log2w++;
    int per = t.qp / 6, rem = t.qp % 6;
    int tshift = maxDyn - bd - log2w;
    int64_t tmin = -(int64_t(1) << maxDyn), tmax = (int64_t(1) << maxDyn) - 1;
    int scale = kInvQuantScales[rem];
    int right = 6 - (tshift + per) + 4;  // + LOG2_SCALING_LIST_NEUTRAL_VALUE
    // dequantCoefBits = 1 + IQUANT_SHIFT + SCALING_LIST_BITS = 15
    int targetBits = std::min(maxDyn + 1, 32 + right - 15);
    int64_t lo = -(int64_t(1) << (targetBits - 1));
    int64_t hi = (int64_t(1) << (targetBits - 1)) - 1;
    size_t ly4 = (size_t(t.y) << (t.comp ? sps->ssy() : 0)) >> 2;
    size_t lx4 = (size_t(t.x) << (t.comp ? sps->ssx() : 0)) >> 2;
    bool intra = pic->pred_mode[ly4 * w4() + lx4] == 1;
    const int32_t* mat =
        scalMat[log2w - 2][(intra ? 0 : 3) + t.comp].data();
    const int32_t* c = &pic->coeffs[t.coeff_off];
    size_t nn = size_t(t.w) * t.h;
    for (size_t i = 0; i < nn; i++) {
      int64_t v = c[i];
      v = v < lo ? lo : (v > hi ? hi : v);
      int64_t dq = int64_t(mat[i]) * scale;
      int64_t q = right > 0 ? (v * dq + (int64_t(1) << (right - 1))) >> right
                            : (v * dq) * (int64_t(1) << (-right));
      out[i] = int32_t(q < tmin ? tmin : (q > tmax ? tmax : q));
    }
  }

  void dequantTu(const TuMeta& t, int32_t* out) {
    if (useScaling && !(t.tskip && t.w > 4)) {
      dequantTuScaling(t, out);
      return;
    }
    int bd = bitDepth(t.comp);
    int maxDyn = sps->extended_precision ? std::max(15, bd + 6) : 15;
    int log2w = 0;
    while ((1 << log2w) < t.w) log2w++;
    int per = t.qp / 6, rem = t.qp % 6;
    int tshift = maxDyn - bd - log2w;
    int64_t tmin = -(int64_t(1) << maxDyn), tmax = (int64_t(1) << maxDyn) - 1;
    int scale = kInvQuantScales[rem];
    int right = 6 - (tshift + per);
    int targetBits = std::min(maxDyn + 1, 32 + right - 7);
    const int32_t* c = &pic->coeffs[t.coeff_off];
    size_t nn = size_t(t.w) * t.h;
    if (maxDyn <= 15 && right > 0) {
      // int32 fast path: |clipped coeff| <= 2^15, scale <= 72 -> the
      // product stays under 2^23, and the result clips to +-2^15
      int32_t lo32 = -(1 << (targetBits - 1));
      int32_t hi32 = (1 << (targetBits - 1)) - 1;
      int32_t add = 1 << (right - 1);
      int32_t t32min = int32_t(tmin), t32max = int32_t(tmax);
      for (size_t i = 0; i < nn; i++) {
        int32_t v = c[i];
        v = v < lo32 ? lo32 : (v > hi32 ? hi32 : v);
        int32_t q = (v * scale + add) >> right;
        out[i] = q < t32min ? t32min : (q > t32max ? t32max : q);
      }
      return;
    }
    int64_t lo = -(int64_t(1) << (targetBits - 1));
    int64_t hi = (int64_t(1) << (targetBits - 1)) - 1;
    for (size_t i = 0; i < nn; i++) {
      int64_t v = c[i];
      v = v < lo ? lo : (v > hi ? hi : v);
      int64_t q = right > 0 ? (v * scale + (int64_t(1) << (right - 1))) >> right
                            : (v * scale) * (int64_t(1) << (-right));
      out[i] = int32_t(q < tmin ? tmin : (q > tmax ? tmax : q));
    }
  }

#if defined(__AVX2__)
  // vpmaddwd inverse transform for the standard dynamic range (coeffs and
  // both stage outputs fit int16; products accumulate exactly in int32).
  // Bit-exact vs the scalar path: stage shifts/rounds/clips are identical,
  // packs_epi32 saturation == the scalar I16MIN/I16MAX clip.
  // c16 must hold zeros above lastRow / right of lastCol (incl. row
  // lastRow+1, read by the pair interleave when lastRow is even).
  void itx16(int h, int w, bool dstY, bool dstX, int shift2,
             const int16_t* c16, int lastRow, int lastCol, int16_t* outp) {
    int lgW = 0; while ((1 << lgW) < w) lgW++;
    int16_t* cp = s_cp; int16_t* t1 = s_t16;
    const int shift1 = 7;
    if (lastRow == 0 && lastCol == 0 && !dstY && !dstX) {
      // DC-only: both stages reduce to scalar constants
      int v1 = (64 * c16[0] + (1 << (shift1 - 1))) >> shift1;
      v1 = v1 < I16MIN ? I16MIN : (v1 > I16MAX ? I16MAX : v1);
      int v2 = (64 * v1 + (1 << (shift2 - 1))) >> shift2;
      v2 = v2 < I16MIN ? I16MIN : (v2 > I16MAX ? I16MAX : v2);
      for (int i = 0; i < h * w; i++) outp[i] = int16_t(v2);
      return;
    }
    int lgH = 0; while ((1 << lgH) < h) lgH++;
    const int32_t* colPairY =
        dstY ? &kItx.dstColPair[0][0] : kItx.colPair[lgH].data();
    const int16_t* pairRowsX =
        dstX ? &kItx.dstPairRows[0][0] : kItx.pairRows[lgW].data();
    int npair1 = (lastRow >> 1) + 1;
    int npair2 = (lastCol >> 1) + 1;
    int hp = h / 2;
    // pre-interleave coeff row pairs: cp[p] = zip(c16 row 2p, row 2p+1)
    for (int p = 0; p < npair1; p++) {
      const int16_t* a = c16 + size_t(2 * p) * w;
      const int16_t* b = c16 + size_t(2 * p + 1) * w;
      int16_t* d = cp + size_t(p) * 2 * w;
      int j = 0;
      for (; j + 16 <= w; j += 16) {
        __m256i va = _mm256_loadu_si256((const __m256i*)(a + j));
        __m256i vb = _mm256_loadu_si256((const __m256i*)(b + j));
        __m256i lo = _mm256_unpacklo_epi16(va, vb);
        __m256i hi = _mm256_unpackhi_epi16(va, vb);
        _mm256_storeu_si256((__m256i*)(d + 2 * j),
                            _mm256_permute2x128_si256(lo, hi, 0x20));
        _mm256_storeu_si256((__m256i*)(d + 2 * j + 16),
                            _mm256_permute2x128_si256(lo, hi, 0x31));
      }
      for (; j < w; j++) { d[2 * j] = a[j]; d[2 * j + 1] = b[j]; }
    }
    // stage 1: t1[i][:] = (sum_p cp[p] madd colPairY[i][p] + r) >> shift1
    __m256i r1 = _mm256_set1_epi32(1 << (shift1 - 1));
    for (int i = 0; i < h; i++) {
      const int32_t* bc = colPairY + size_t(i) * hp;
      int16_t* out = t1 + size_t(i) * w;
      if (w >= 16) {
        for (int j = 0; j < w; j += 16) {
          __m256i a0 = r1, a1 = r1;
          for (int p = 0; p < npair1; p++) {
            __m256i f = _mm256_set1_epi32(bc[p]);
            const int16_t* row = cp + size_t(p) * 2 * w + 2 * j;
            a0 = _mm256_add_epi32(
                a0, _mm256_madd_epi16(
                        _mm256_loadu_si256((const __m256i*)row), f));
            a1 = _mm256_add_epi32(
                a1, _mm256_madd_epi16(
                        _mm256_loadu_si256((const __m256i*)(row + 16)), f));
          }
          a0 = _mm256_srai_epi32(a0, shift1);
          a1 = _mm256_srai_epi32(a1, shift1);
          __m256i pk = _mm256_packs_epi32(a0, a1);
          pk = _mm256_permute4x64_epi64(pk, 0xD8);
          _mm256_storeu_si256((__m256i*)(out + j), pk);
        }
      } else if (w == 8) {
        __m256i a0 = r1;
        for (int p = 0; p < npair1; p++)
          a0 = _mm256_add_epi32(
              a0, _mm256_madd_epi16(
                      _mm256_loadu_si256((const __m256i*)(cp + p * 16)),
                      _mm256_set1_epi32(bc[p])));
        a0 = _mm256_srai_epi32(a0, shift1);
        __m128i pk = _mm_packs_epi32(_mm256_castsi256_si128(a0),
                                     _mm256_extracti128_si256(a0, 1));
        _mm_storeu_si128((__m128i*)out, pk);
      } else {  // w == 4
        __m128i a0 = _mm_set1_epi32(1 << (shift1 - 1));
        for (int p = 0; p < npair1; p++)
          a0 = _mm_add_epi32(
              a0, _mm_madd_epi16(_mm_loadu_si128((const __m128i*)(cp + p * 8)),
                                 _mm_set1_epi32(bc[p])));
        a0 = _mm_srai_epi32(a0, shift1);
        _mm_storel_epi64((__m128i*)out, _mm_packs_epi32(a0, a0));
      }
    }
    // stage 2: out[i][:] = (sum_p pairRowsX[p] madd (t1[i][2p],t1[i][2p+1])
    //                       + r) >> shift2
    __m256i r2 = _mm256_set1_epi32(1 << (shift2 - 1));
    for (int i = 0; i < h; i++) {
      const int16_t* ti = t1 + size_t(i) * w;
      int16_t* out = outp + size_t(i) * w;
      if (w >= 16) {
        for (int j = 0; j < w; j += 16) {
          __m256i a0 = r2, a1 = r2;
          for (int p = 0; p < npair2; p++) {
            __m256i f = _mm256_set1_epi32(
                int32_t(uint16_t(ti[2 * p])) |
                (int32_t(uint16_t(ti[2 * p + 1])) << 16));
            const int16_t* row = pairRowsX + size_t(p) * 2 * w + 2 * j;
            a0 = _mm256_add_epi32(
                a0, _mm256_madd_epi16(
                        _mm256_loadu_si256((const __m256i*)row), f));
            a1 = _mm256_add_epi32(
                a1, _mm256_madd_epi16(
                        _mm256_loadu_si256((const __m256i*)(row + 16)), f));
          }
          a0 = _mm256_srai_epi32(a0, shift2);
          a1 = _mm256_srai_epi32(a1, shift2);
          __m256i pk = _mm256_packs_epi32(a0, a1);
          pk = _mm256_permute4x64_epi64(pk, 0xD8);
          _mm256_storeu_si256((__m256i*)(out + j), pk);
        }
      } else if (w == 8) {
        __m256i a0 = r2;
        for (int p = 0; p < npair2; p++)
          a0 = _mm256_add_epi32(
              a0, _mm256_madd_epi16(
                      _mm256_loadu_si256((const __m256i*)(pairRowsX + p * 16)),
                      _mm256_set1_epi32(
                          int32_t(uint16_t(ti[2 * p])) |
                          (int32_t(uint16_t(ti[2 * p + 1])) << 16))));
        a0 = _mm256_srai_epi32(a0, shift2);
        __m128i pk = _mm_packs_epi32(_mm256_castsi256_si128(a0),
                                     _mm256_extracti128_si256(a0, 1));
        _mm_storeu_si128((__m128i*)out, pk);
      } else {  // w == 4
        __m128i a0 = _mm_set1_epi32(1 << (shift2 - 1));
        for (int p = 0; p < npair2; p++)
          a0 = _mm_add_epi32(
              a0,
              _mm_madd_epi16(
                  _mm_loadu_si128((const __m128i*)(pairRowsX + p * 8)),
                  _mm_set1_epi32(int32_t(uint16_t(ti[2 * p])) |
                                 (int32_t(uint16_t(ti[2 * p + 1])) << 16))));
        a0 = _mm_srai_epi32(a0, shift2);
        _mm_storel_epi64((__m128i*)out, _mm_packs_epi32(a0, a0));
      }
    }
  }

  // int32 interface wrapper (scaling-list dequant path): narrow, transform,
  // widen back
  void itxAvx2(int h, int w, bool dstY, bool dstX, int shift2, int32_t* buf) {
    int16_t* c16 = s_c16; int16_t* o16 = s_o16;
    int lastRow = 0, lastCol = 0;
    for (int i = 0; i < h; i++) {
      bool nz = false;
      for (int j = 0; j < w; j++) {
        int32_t v = buf[size_t(i) * w + j];
        c16[size_t(i) * w + j] = int16_t(v);
        if (v) { nz = true; if (j > lastCol) lastCol = j; }
      }
      if (nz) lastRow = i;
    }
    if (lastRow + 1 < h)
      memset(c16 + size_t(lastRow + 1) * w, 0, size_t(w) * 2);
    itx16(h, w, dstY, dstX, shift2, c16, lastRow, lastCol, o16);
    for (int i = 0; i < h * w; i++) buf[i] = o16[i];
  }

  // dequant (flat scale) + inverse transform straight into the int16
  // residual pool.  Covers the dominant path: no scaling lists, no
  // transform-skip / bypass, standard dynamic range.  Handles both dequant
  // directions: right-shift-with-rounding (low QP / large TU) and the
  // left-shift form (6 - transformShift - qp/6 <= 0, the common case for
  // small TUs at mid/high QP) — scalar semantics per dequantTu: clip input
  // to int16, (v*scale) << lsh, clip to int16 (targetBits stays 16 down to
  // right = -9; the int32 product (v*scale) << lsh < 2^31 there).
  bool residualFast(const TuMeta& t, int16_t* outp) {
    if (t.bypass || t.tskip || useScaling) return false;
    int bd = bitDepth(t.comp);
    if (sps->extended_precision && std::max(15, bd + 6) > 15) return false;
    int w = t.w, h = t.h;
    int log2w = 0; while ((1 << log2w) < w) log2w++;
    int per = t.qp / 6, rem = t.qp % 6;
    int tshift = 15 - bd - log2w;
    int right = 6 - (tshift + per);
    if (right < -9) return false;  // keeps targetBits at 16 / product in i32
    int scale = kInvQuantScales[rem];
    int shift2 = 20 - bd;
    const int32_t* c = &pic->coeffs[t.coeff_off];
    int16_t* c16 = s_c16;
    // exact nonzero extent recorded by the parser (dequant of a nonzero
    // level is never zero: |v|*scale >= 40 survives every legal shift, so
    // the raw extent equals the dequantized extent).  Rows past last_row
    // may be UNINITIALIZED in native-recon mode — never read them.
    int lastRow = t.last_row;
    // dequant rows 0..lastRow into int16
    bool rsh = right > 0;
    int lsh = rsh ? 0 : -right;
    __m256i vscale = _mm256_set1_epi32(scale);
    __m256i vadd = _mm256_set1_epi32(rsh ? 1 << (right - 1) : 0);
    __m256i lo16 = _mm256_set1_epi32(-32768), hi16 = _mm256_set1_epi32(32767);
    for (int i = 0; i <= lastRow; i++) {
      const int32_t* row = c + size_t(i) * w;
      int16_t* dst = c16 + size_t(i) * w;
      if (w >= 8) {
        for (int j = 0; j < w; j += 8) {
          __m256i v = _mm256_loadu_si256((const __m256i*)(row + j));
          v = _mm256_min_epi32(_mm256_max_epi32(v, lo16), hi16);
          v = _mm256_mullo_epi32(v, vscale);
          v = rsh ? _mm256_srai_epi32(_mm256_add_epi32(v, vadd), right)
                  : _mm256_slli_epi32(v, lsh);
          v = _mm256_min_epi32(_mm256_max_epi32(v, lo16), hi16);
          __m128i pk = _mm_packs_epi32(_mm256_castsi256_si128(v),
                                       _mm256_extracti128_si256(v, 1));
          _mm_storeu_si128((__m128i*)(dst + j), pk);
        }
      } else {  // w == 4
        for (int j = 0; j < 4; j++) {
          int32_t v = row[j];
          v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
          int32_t q = rsh ? (v * scale + (1 << (right - 1))) >> right
                          : (v * scale) << lsh;
          q = q < -32768 ? -32768 : (q > 32767 ? 32767 : q);
          dst[j] = int16_t(q);
        }
      }
    }
    if (lastRow + 1 < h)   // itx16's pair interleave reads row lastRow+1
      memset(c16 + size_t(lastRow + 1) * w, 0, size_t(w) * 2);
    itx16(h, w, t.use_dst && h == 4, t.use_dst && w == 4, shift2, c16,
          lastRow, t.last_col, outp);
    return true;
  }
#endif

  void inverseTransform(const TuMeta& t, int32_t* buf) {
    // buf holds dequantized coeffs [h][w]; result written in place
    int h = t.h, w = t.w;
    int bd = bitDepth(t.comp);
    int maxDyn = sps->extended_precision ? std::max(15, bd + 6) : 15;
    int lgH = 0; while ((1 << lgH) < h) lgH++;
    int lgW = 0; while ((1 << lgW) < w) lgW++;
    const int32_t* ty = (t.use_dst && h == 4) ? kT.dst4 : kT.dct[lgH].data();
    const int32_t* tx = (t.use_dst && w == 4) ? kT.dst4 : kT.dct[lgW].data();
    int shift1 = 7;
    int shift2 = maxDyn == 15 ? 20 - bd : (6 + maxDyn - 1) - bd;
#if defined(__AVX2__)
    if (maxDyn <= 15) {
      itxAvx2(h, w, t.use_dst && h == 4, t.use_dst && w == 4, shift2, buf);
      return;
    }
#endif
    // stage 1: t1 = (ty^T @ c + r) >> shift1, clip int16.
    // Coefficients concentrate in the low-frequency rows; skipping all-zero
    // rows mirrors the reference's zo/partial-butterfly fast paths.
    int lastRow = h - 1;
    while (lastRow > 0) {
      bool z = true;
      for (int j = 0; j < w; j++)
        if (buf[size_t(lastRow) * w + j]) { z = false; break; }
      if (!z) break;
      lastRow--;
    }
    int32_t* t1 = s_t32;
    if (maxDyn <= 15) {
      // int32 fast path: |coeff| <= 2^15, |tap| <= 90, <=32 terms -> acc
      // fits int32 (< 2^27.5).  k-outer loops keep the inner j loop
      // contiguous so the compiler vectorizes the multiply-accumulate.
      int32_t* acc = s_acc;
      memset(acc, 0, sizeof(int32_t) * size_t(h) * w);
      for (int k = 0; k <= lastRow; k++) {
        const int32_t* bk = buf + size_t(k) * w;
        const int32_t* tyk = ty + size_t(k) * h;
        for (int i = 0; i < h; i++) {
          int32_t c = tyk[i];
          if (!c) continue;
          int32_t* ai = acc + size_t(i) * w;
          for (int j = 0; j < w; j++) ai[j] += c * bk[j];
        }
      }
      int rnd1 = 1 << (shift1 - 1);
      for (int n = 0; n < h * w; n++) {
        int v = (acc[n] + rnd1) >> shift1;
        t1[n] = v < I16MIN ? I16MIN : (v > I16MAX ? I16MAX : v);
      }
      int rnd2 = 1 << (shift2 - 1);
      int32_t* arow = s_arow;
      for (int i = 0; i < h; i++) {
        memset(arow, 0, sizeof(int32_t) * w);
        const int32_t* ti = t1 + size_t(i) * w;
        for (int k = 0; k < w; k++) {
          int32_t c = ti[k];
          if (!c) continue;
          const int32_t* txk = tx + size_t(k) * w;
          for (int j = 0; j < w; j++) arow[j] += c * txk[j];
        }
        int32_t* bi = buf + size_t(i) * w;
        for (int j = 0; j < w; j++) {
          int v = (arow[j] + rnd2) >> shift2;
          bi[j] = v < I16MIN ? I16MIN : (v > I16MAX ? I16MAX : v);
        }
      }
      return;
    }
    // extended-precision path (maxDyn > 15): int64 accumulation
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int64_t acc = 0;
        for (int k = 0; k <= lastRow; k++)
          acc += int64_t(ty[size_t(k) * h + i]) * buf[size_t(k) * w + j];
        int64_t v = (acc + (1 << (shift1 - 1))) >> shift1;
        t1[size_t(i) * w + j] =
            int32_t(v < I16MIN ? I16MIN : (v > I16MAX ? I16MAX : v));
      }
    // stage 2: t2 = (t1 @ tx + r) >> shift2, clip int16
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int64_t acc = 0;
        for (int k = 0; k < w; k++)
          acc += int64_t(t1[size_t(i) * w + k]) * tx[size_t(k) * w + j];
        int64_t v = (acc + (int64_t(1) << (shift2 - 1))) >> shift2;
        buf[size_t(i) * w + j] =
            int32_t(v < I16MIN ? I16MIN : (v > I16MAX ? I16MAX : v));
      }
  }

  void rdpcm(int32_t* r, int w, int h, int mode) {
    if (mode == 1) {          // horizontal cumsum along rows
      for (int y = 0; y < h; y++) {
        int64_t s = 0;
        for (int x = 0; x < w; x++) {
          s += r[size_t(y) * w + x];
          r[size_t(y) * w + x] =
              int32_t(s < I16MIN ? I16MIN : (s > I16MAX ? I16MAX : s));
        }
      }
    } else if (mode == 2) {   // vertical
      for (int x = 0; x < w; x++) {
        int64_t s = 0;
        for (int y = 0; y < h; y++) {
          s += r[size_t(y) * w + x];
          r[size_t(y) * w + x] =
              int32_t(s < I16MIN ? I16MIN : (s > I16MAX ? I16MAX : s));
        }
      }
    }
  }

  void residualForTu(const TuMeta& t, int32_t* out) {
    int bd = bitDepth(t.comp);
    int maxDyn = sps->extended_precision ? std::max(15, bd + 6) : 15;
    int w = t.w, h = t.h;
    size_t nn = size_t(w) * h;
    // rotation applies only to intra 4x4 blocks (TComTU.cpp:227)
    size_t rly4 = (size_t(t.y) << (t.comp ? sps->ssy() : 0)) >> 2;
    size_t rlx4 = (size_t(t.x) << (t.comp ? sps->ssx() : 0)) >> 2;
    bool tuIntra = pic->pred_mode[rly4 * w4() + rlx4] == 1;
    bool rot = sps->transform_skip_rotation && w == 4 && tuIntra;
    auto reverseInPlace = [&]() {
      for (size_t i = 0, j = nn - 1; i < j; i++, j--)
        std::swap(out[i], out[j]);
    };
    if (t.bypass) {
      memcpy(out, &pic->coeffs[t.coeff_off], nn * 4);
      if (rot) reverseInPlace();
      rdpcm(out, w, h, t.rdpcm);
      return;
    }
    dequantTu(t, out);
    if (t.tskip) {
      int log2w = 0; while ((1 << log2w) < w) log2w++;
      int tshift = maxDyn - bd - log2w;
      if (rot) reverseInPlace();
      for (size_t i = 0; i < nn; i++) {
        int64_t x = out[i];
        int64_t y = tshift >= 0
            ? (x + (tshift == 0 ? 0 : (int64_t(1) << (tshift - 1)))) >> tshift
            : x * (int64_t(1) << (-tshift));
        out[i] = int32_t(y < I16MIN ? I16MIN : (y > I16MAX ? I16MAX : y));
      }
      rdpcm(out, w, h, t.rdpcm);
      return;
    }
    inverseTransform(t, out);
  }

  void buildResiduals() {
    buildScalingMatrices();
    // grow-only: every TU's slot is fully written below before any read,
    // so the zero-fill only ever runs when the pool grows past its
    // high-water mark (the ctx is reused across pictures)
    if (resPool.size() < pic->coeffs.size())
      resPool.resize(pic->coeffs.size());
    int32_t* scratch = s_scratch;
    for (size_t i = 0; i < pic->tu_list.size(); i++) {
      const TuMeta& t = pic->tu_list[i];
#if defined(__AVX2__)
      if (residualFast(t, &resPool[t.coeff_off])) continue;
#endif
      residualForTu(t, scratch);
      int16_t* dst = &resPool[t.coeff_off];
      size_t nn = size_t(t.w) * t.h;
      for (size_t k = 0; k < nn; k++) dst[k] = int16_t(scratch[k]);
    }
    // cross-component prediction (RExt 4:4:4)
    if (sps->chroma_format_idc == 3) {
      std::map<std::tuple<int, int, int>, size_t> lumaRes;
      for (size_t i = 0; i < pic->tu_list.size(); i++) {
        const TuMeta& t = pic->tu_list[i];
        if (t.comp == 0) lumaRes[{t.x, t.y, t.w}] = i;
      }
      for (size_t i = 0; i < pic->tu_list.size(); i++) {
        const TuMeta& t = pic->tu_list[i];
        if (t.comp && t.alpha) {
          auto it = lumaRes.find({t.x, t.y, t.w});
          if (it == lumaRes.end()) continue;
          const int16_t* lr = &resPool[pic->tu_list[it->second].coeff_off];
          int16_t* r = &resPool[t.coeff_off];
          size_t nn = size_t(t.w) * t.h;
          for (size_t k = 0; k < nn; k++) {
            int64_t v = r[k] + ((int64_t(t.alpha) * lr[k]) >> 3);
            r[k] = int16_t(v < I16MIN ? I16MIN : (v > I16MAX ? I16MAX : v));
          }
        }
      }
    }
  }

  // -------------------------------------------------------------------------
  // inter prediction
  // -------------------------------------------------------------------------
  // one block, one list: writes IF-precision (not-last) or final samples
  void interpBlock(const Pel* ref, int refW, int refH, int64_t stride,
                   int x, int y, int w, int h, int mvx, int mvy,
                   int fbx, int fby, int taps, bool isLuma, int bd,
                   bool isLast, int16_t* dst, int dstStride) {
    if (taps == 8) {
      if (isLast)
        interpBlockT<8, true>(ref, refW, refH, stride, x, y, w, h, mvx, mvy,
                              fbx, fby, isLuma, bd, dst, dstStride);
      else
        interpBlockT<8, false>(ref, refW, refH, stride, x, y, w, h, mvx, mvy,
                               fbx, fby, isLuma, bd, dst, dstStride);
    } else {
      if (isLast)
        interpBlockT<4, true>(ref, refW, refH, stride, x, y, w, h, mvx, mvy,
                              fbx, fby, isLuma, bd, dst, dstStride);
      else
        interpBlockT<4, false>(ref, refW, refH, stride, x, y, w, h, mvx, mvy,
                               fbx, fby, isLuma, bd, dst, dstStride);
    }
  }

  static int phaseShift(int taps, int fbits) {
    // chroma table is eighth-pel: scale for non-subsampled axes
    // (TComInterpolationFilter.cpp:346 'frac << (1 - cs)')
    return taps == 4 ? 3 - fbits : 0;
  }

  template <int taps, bool isLast>
  void interpBlockT(const Pel* ref, int refW, int refH, int64_t stride,
                    int x, int y, int w, int h, int mvx, int mvy,
                    int fbx, int fby, bool isLuma, int bd,
                    int16_t* dst, int dstStride) {
    int fx = (mvx & ((1 << fbx) - 1)) << phaseShift(taps, fbx);
    int fy = (mvy & ((1 << fby) - 1)) << phaseShift(taps, fby);
    int ix = x + (mvx >> fbx);
    int iy = y + (mvy >> fby);
    int headroom = kIfPrec - bd;
    int half = taps / 2 - 1;
    int maxv = (1 << bd) - 1;
    auto S = [&](int yy, int xx) -> int {
      yy = clip3(0, refH - 1, yy);
      xx = clip3(0, refW - 1, xx);
      return ref[int64_t(yy) * stride + xx];
    };
    const int* fh = isLuma ? kLumaF[fx] : kChromaF[fx];
    const int* fv = isLuma ? kLumaF[fy] : kChromaF[fy];
    // interior fast test: the full gather window stays inside the plane
    bool interior = ix - half >= 0 && ix + w - 1 + (taps - 1 - half) < refW &&
                    iy - half >= 0 && iy + h - 1 + (taps - 1 - half) < refH;
    if (fx == 0 && fy == 0) {
      if (interior && isLast) {
        for (int j = 0; j < h; j++)
          memcpy(dst + int64_t(j) * dstStride,
                 ref + int64_t(iy + j) * stride + ix, size_t(w) * 2);
        return;
      }
      for (int j = 0; j < h; j++)
        for (int i = 0; i < w; i++) {
          int v = S(iy + j, ix + i);
          dst[int64_t(j) * dstStride + i] =
              int16_t(isLast ? v : (v << headroom) - kIfOffs);
        }
      return;
    }
    int hr = std::max(2, headroom);
    int32_t* acc32 = s_acc32;
    if (fy == 0) {
      // single horizontal stage
      int shift = 6, offset;
      if (isLast) { offset = 1 << (shift - 1); }
      else { shift -= hr; offset = -(kIfOffs << shift); }
      for (int j = 0; j < h; j++) {
        if (interior) {
          const Pel* row = ref + int64_t(iy + j) * stride + ix - half;
#if defined(__AVX2__)
          simd::hfilt<taps>(row, w, fh, acc32);
#else
          for (int i = 0; i < w; i++) {
            int32_t s = 0;
            for (int k = 0; k < taps; k++) s += fh[k] * row[i + k];
            acc32[i] = s;
          }
#endif
          int16_t* drow = dst + int64_t(j) * dstStride;
#if defined(__AVX2__)
          if (isLast) simd::shiftClipStore(acc32, w, offset, shift, maxv, drow);
          else simd::shiftNarrow(acc32, w, offset, shift, drow);
#else
          for (int i = 0; i < w; i++) {
            int v = (acc32[i] + offset) >> shift;
            drow[i] = int16_t(isLast ? clip3(0, maxv, v) : v);
          }
#endif
        } else {
          for (int i = 0; i < w; i++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
              acc += fh[k] * S(iy + j, ix + i + k - half);
            int v = (acc + offset) >> shift;
            dst[int64_t(j) * dstStride + i] =
                int16_t(isLast ? clip3(0, maxv, v) : v);
          }
        }
      }
      return;
    }
    if (fx == 0) {
      int shift = 6, offset;
      if (isLast) { offset = 1 << (shift - 1); }
      else { shift -= hr; offset = -(kIfOffs << shift); }
      for (int j = 0; j < h; j++) {
        if (interior) {
          const Pel* col = ref + int64_t(iy + j - half) * stride + ix;
#if defined(__AVX2__)
          simd::vfilt<taps>(col, stride, w, fv, acc32);
#else
          for (int i = 0; i < w; i++) {
            int32_t s = 0;
            for (int k = 0; k < taps; k++) s += fv[k] * col[k * stride + i];
            acc32[i] = s;
          }
#endif
          int16_t* drow = dst + int64_t(j) * dstStride;
#if defined(__AVX2__)
          if (isLast) simd::shiftClipStore(acc32, w, offset, shift, maxv, drow);
          else simd::shiftNarrow(acc32, w, offset, shift, drow);
#else
          for (int i = 0; i < w; i++) {
            int v = (acc32[i] + offset) >> shift;
            drow[i] = int16_t(isLast ? clip3(0, maxv, v) : v);
          }
#endif
        } else {
          for (int i = 0; i < w; i++) {
            int32_t acc = 0;
            for (int k = 0; k < taps; k++)
              acc += fv[k] * S(iy + j + k - half, ix + i);
            int v = (acc + offset) >> shift;
            dst[int64_t(j) * dstStride + i] =
                int16_t(isLast ? clip3(0, maxv, v) : v);
          }
        }
      }
      return;
    }
    // two stages: H first (is_first, not last), then V.  Intermediates fit
    // int16 (14-bit IF precision minus IF_OFFS, like the reference's Short
    // buffers).
    int sh1 = 6 - hr;
    int32_t off1 = -(kIfOffs << sh1);
    std::vector<int16_t>& tmp = s_tmp;
    for (int j = 0; j < h + taps - 1; j++) {
      if (interior) {
        const Pel* row = ref + int64_t(iy + j - half) * stride + ix - half;
#if defined(__AVX2__)
        simd::hfilt<taps>(row, w, fh, acc32);
        simd::shiftNarrow(acc32, w, off1, sh1, &tmp[size_t(j) * w]);
#else
        for (int i = 0; i < w; i++) {
          int32_t s = 0;
          for (int k = 0; k < taps; k++) s += fh[k] * row[i + k];
          tmp[size_t(j) * w + i] = int16_t((s + off1) >> sh1);
        }
#endif
      } else {
        for (int i = 0; i < w; i++) {
          int32_t acc = 0;
          for (int k = 0; k < taps; k++)
            acc += fh[k] * S(iy + j - half, ix + i + k - half);
          tmp[size_t(j) * w + i] = int16_t((acc + off1) >> sh1);
        }
      }
    }
    int sh2; int32_t off2;
    if (isLast) { sh2 = 6 + hr; off2 = (1 << (sh2 - 1)) + (kIfOffs << 6); }
    else { sh2 = 6; off2 = 0; }
    for (int j = 0; j < h; j++) {
      int16_t* drow = dst + int64_t(j) * dstStride;
#if defined(__AVX2__)
      simd::vfilt<taps>(tmp.data() + size_t(j) * w, w, w, fv, acc32);
      if (isLast) simd::shiftClipStore(acc32, w, off2, sh2, maxv, drow);
      else simd::shiftNarrow(acc32, w, off2, sh2, drow);
#else
      static thread_local int32_t vacc[64];
      const int16_t* t0 = tmp.data() + size_t(j) * w;
      for (int i = 0; i < w; i++) vacc[i] = fv[0] * t0[i];
      for (int k = 1; k < taps; k++) {
        const int16_t* tk = tmp.data() + size_t(j + k) * w;
        int32_t c = fv[k];
        for (int i = 0; i < w; i++) vacc[i] += c * tk[i];
      }
      if (isLast) {
        for (int i = 0; i < w; i++)
          drow[i] = int16_t(clip3(0, maxv, (vacc[i] + off2) >> sh2));
      } else {
        for (int i = 0; i < w; i++)
          drow[i] = int16_t((vacc[i] + off2) >> sh2);
      }
#endif
    }
  }

  void interStage() {
    if (pic->inter_list.empty()) return;
    std::vector<int16_t>& p0 = s_p0; std::vector<int16_t>& p1 = s_p1;
    // flat poc -> picture lookup (avoids the std::function DPB scan per PU)
    std::array<Picture*, 64> refCache{};
    std::array<int, 64> refCachePoc;
    refCachePoc.fill(INT32_MIN);
    auto lookupRef = [&](int poc) -> Picture* {
      unsigned slot = unsigned(poc) & 63;
      if (refCachePoc[slot] != poc) {
        refCache[slot] = findRef(poc);
        refCachePoc[slot] = poc;
      }
      return refCache[slot];
    };
    for (const PuMeta& pu : pic->inter_list) {
      bool bi = pu.dir == 3;
      bool useWp = pu.has_wp != 0;
      for (int c = 0; c < ncomp; c++) {
        int sx = c ? sps->ssx() : 0;
        int sy = c ? sps->ssy() : 0;
        int bd = bitDepth(c);
        int maxv = (1 << bd) - 1;
        int x = pu.x >> sx, y = pu.y >> sy;
        int w = pu.w >> sx, h = pu.h >> sy;
        int taps = c == 0 ? 8 : 4;
        int fbx = c ? 2 + sx : 2;
        int fby = c ? 2 + sy : 2;
        bool isLast = !bi && !useWp;
        int refW = compW(c), refH = compH(c);
        Pel* out = &pic->plane[c][int64_t(y) * planeW(c) + x];
        int64_t ostride = planeW(c);
#if defined(__AVX2__)
        // fused fast path: integer-MV bi-prediction fully inside the plane
        // reduces algebraically to a rounding average of the two ref blocks
        // (the IF copy offset and the bi-average offset cancel exactly)
        if (bi && !useWp) {
          int fx0 = pu.mv[0][0] & ((1 << fbx) - 1);
          int fy0 = pu.mv[0][1] & ((1 << fby) - 1);
          int fx1 = pu.mv[1][0] & ((1 << fbx) - 1);
          int fy1 = pu.mv[1][1] & ((1 << fby) - 1);
          if (!(fx0 | fy0 | fx1 | fy1)) {
            int ix0 = x + (pu.mv[0][0] >> fbx), iy0 = y + (pu.mv[0][1] >> fby);
            int ix1 = x + (pu.mv[1][0] >> fbx), iy1 = y + (pu.mv[1][1] >> fby);
            if (ix0 >= 0 && iy0 >= 0 && ix0 + w <= refW && iy0 + h <= refH &&
                ix1 >= 0 && iy1 >= 0 && ix1 + w <= refW && iy1 + h <= refH) {
              Picture* r0 = lookupRef(pu.ref_poc[0]);
              Picture* r1 = lookupRef(pu.ref_poc[1]);
              if (r0 && r1) {
                const Pel* a = r0->plane[c].data() +
                               int64_t(iy0) * planeW(c) + ix0;
                const Pel* b = r1->plane[c].data() +
                               int64_t(iy1) * planeW(c) + ix1;
                for (int j = 0; j < h; j++)
                  simd::avgRound(a + int64_t(j) * planeW(c),
                                 b + int64_t(j) * planeW(c), w,
                                 out + j * ostride);
                continue;
              }
            }
          }
        }
#endif
        int16_t* preds[2] = {p0.data(), p1.data()};
        bool have[2] = {false, false};
        for (int l = 0; l < 2; l++) {
          if (!(pu.dir & (1 << l))) continue;
          Picture* rp = lookupRef(pu.ref_poc[l]);
          if (!rp) continue;
          const Pel* ref = rp->plane[c].data();
          // single-list final-stage prediction writes straight into the
          // picture plane (skips the staging copy)
          int16_t* d = isLast ? out : preds[l];
          int ds = isLast ? int(ostride) : w;
          interpBlock(ref, refW, refH, planeW(c), x, y, w, h,
                      pu.mv[l][0], pu.mv[l][1], fbx, fby, taps, c == 0, bd,
                      isLast, d, ds);
          have[l] = true;
        }
        if (bi && !useWp) {
          int shift = kIfPrec + 1 - bd;
          int off = (1 << (shift - 1)) + 2 * kIfOffs;
          for (int j = 0; j < h; j++) {
            const int16_t* a = p0.data() + size_t(j) * w;
            const int16_t* b = p1.data() + size_t(j) * w;
            Pel* o = out + j * ostride;
#if defined(__AVX2__)
            simd::biAvg(a, b, w, off, shift, maxv, o);
#else
            for (int i = 0; i < w; i++)
              o[i] = Pel(clip3(0, maxv, (a[i] + b[i] + off) >> shift));
#endif
          }
        } else if (!useWp) {
          // single-list prediction already written straight into the plane
        } else {
          int denom = c == 0 ? pu.wp_denom_l : pu.wp_denom_c;
          int scale = 1 << (bd - 8);
          if (bi) {
            int w0 = pu.wp_w[0][c], w1 = pu.wp_w[1][c];
            int64_t o0 = int64_t(pu.wp_o[0][c]) * scale;
            int64_t o1 = int64_t(pu.wp_o[1][c]) * scale;
            int shift = (denom + 1) + std::max(2, kIfPrec - bd);
            int64_t rnd = int64_t(1) << (shift - 1);
            int64_t off = o0 + o1;
            for (int j = 0; j < h; j++)
              for (int i = 0; i < w; i++) {
                int64_t v = (int64_t(w0) * (p0[size_t(j) * w + i] + kIfOffs) +
                             int64_t(w1) * (p1[size_t(j) * w + i] + kIfOffs) +
                             rnd + (off << (shift - 1))) >> shift;
                out[j * ostride + i] = clip3(0, maxv, int(v));
              }
          } else {
            int l = have[0] ? 0 : 1;
            const int16_t* p = preds[l];
            int wl = pu.wp_w[l][c];
            int64_t ol = int64_t(pu.wp_o[l][c]) * scale;
            int shift = denom + std::max(2, kIfPrec - bd);
            int64_t rnd = shift > 0 ? int64_t(1) << (shift - 1) : 0;
            for (int j = 0; j < h; j++)
              for (int i = 0; i < w; i++) {
                int64_t v = ((int64_t(wl) * (p[size_t(j) * w + i] + kIfOffs) +
                              rnd) >> shift) + ol;
                out[j * ostride + i] = clip3(0, maxv, int(v));
              }
          }
        }
      }
    }
    // add inter residuals
    const int8_t* pm = pic->pred_mode.data();
    for (size_t i = 0; i < pic->tu_list.size(); i++) {
      const TuMeta& t = pic->tu_list[i];
      int sx = t.comp ? sps->ssx() : 0;
      int sy = t.comp ? sps->ssy() : 0;
      int ly4 = (t.y << sy) >> 2, lx4 = (t.x << sx) >> 2;
      if (pm[size_t(ly4) * w4() + lx4] != 0) continue;  // MODE_INTER == 0
      int bd = bitDepth(t.comp);
      int maxv = (1 << bd) - 1;
      Pel* pl = pic->plane[t.comp].data();
      int64_t stride = planeW(t.comp);
      const int16_t* r = &resPool[t.coeff_off];
      for (int j = 0; j < t.h; j++) {
        Pel* row = pl + (int64_t(t.y) + j) * stride + t.x;
        const int16_t* rr = r + size_t(j) * t.w;  // flat pool, TU-local raster
#if defined(__AVX2__)
        simd::addClip(row, rr, t.w, maxv);
#else
        for (int k = 0; k < t.w; k++)
          row[k] = Pel(clip3(0, maxv, row[k] + rr[k]));
#endif
      }
    }
  }

  // -------------------------------------------------------------------------
  // intra prediction
  // -------------------------------------------------------------------------
  bool availAt(int cx, int cy, int sx, int sy, int64_t zCur, int sliceCur,
               int tileCur, int compWv, int compHv, bool constrained) {
    if (cx < 0 || cy < 0 || cx >= compWv || cy >= compHv) return false;
    int lx = cx << sx, ly = cy << sy;
    size_t i4 = size_t(ly >> 2) * w4() + (lx >> 2);
    if (zmap[i4] >= zCur) return false;
    if (pic->slice_idx[i4] != sliceCur) return false;
    if (tileMap[size_t(ly >> log2Ctb) * wCtbs + (lx >> log2Ctb)] != tileCur)
      return false;
    if (constrained && pic->pred_mode[i4] != 1) return false;  // MODE_INTRA==1
    return true;
  }

  void reconIntraBlock(const IntraMeta& blk) {
    int c = blk.comp;
    int sx = c ? sps->ssx() : 0;
    int sy = c ? sps->ssy() : 0;
    int bd = bitDepth(c);
    int maxv = (1 << bd) - 1;
    int mode = blk.mode;
    if (c && sps->chroma_format_idc == 2) mode = kC422Map[mode];
    int n = blk.w;
    Pel* plane = pic->plane[c].data();
    int64_t stride = planeW(c);
    // availability context
    int lx = blk.x << sx, ly = blk.y << sy;
    int64_t zCur = zmap[size_t(ly >> 2) * w4() + (lx >> 2)];
    int sliceCur = pic->slice_idx[size_t(ly >> 2) * w4() + (lx >> 2)];
    int tileCur = tileMap[size_t(ly >> log2Ctb) * wCtbs + (lx >> log2Ctb)];
    bool constrained = pps->constrained_intra_pred != 0;
    int cw = compW(c), chh = compH(c);

    // fill reference samples (Rec. 8.4.4.2.2); fixed thread-local buffers
    // (max n = 64), no per-block heap traffic
    int total = 4 * n + 1;
    int32_t* vals = s_vals;
    uint8_t* av = s_av;
    int x = blk.x, y = blk.y;
    bool anyAvail = false;
    for (int i = 0; i < total; i++) {
      int cx, cy;
      if (i < 2 * n) { cx = x - 1; cy = y + 2 * n - 1 - i; }
      else if (i == 2 * n) { cx = x - 1; cy = y - 1; }
      else { cx = x + (i - 2 * n - 1); cy = y - 1; }
      bool a = availAt(cx, cy, sx, sy, zCur, sliceCur, tileCur, cw, chh,
                       constrained);
      av[i] = a;
      if (a) { vals[i] = plane[int64_t(cy) * stride + cx]; anyAvail = true; }
    }
    if (!anyAvail) {
      int dc = 1 << (bd - 1);
      for (int i = 0; i < total; i++) vals[i] = dc;
    } else {
      if (!av[0]) {
        int j = 1;
        while (j < total && !av[j]) j++;
        vals[0] = vals[j];
      }
      for (int i = 1; i < total; i++)
        if (!av[i]) vals[i] = vals[i - 1];
    }
    // left[0..2n]: corner then downwards; top[0..2n]: corner then rightwards
    int32_t* leftBuf = s_leftBuf; int32_t* topBuf = s_topBuf;
    int32_t* nlBuf = s_nlBuf; int32_t* ntBuf = s_ntBuf;
    int32_t* left = leftBuf;
    int32_t* top = topBuf;
    for (int i = 0; i <= 2 * n; i++) left[i] = vals[2 * n - i];
    for (int i = 0; i <= 2 * n; i++) top[i] = vals[2 * n + i];

    // smoothing decision (Rec. 8.4.4.2.3)
    bool filt = false;
    if (!sps->intra_smoothing_disabled &&
        (c == 0 || sps->chroma_format_idc == 3) && mode != 1 && n != 4) {
      if (mode == 0) filt = n >= 8;
      else {
        int minDist = std::min(std::abs(mode - 26), std::abs(mode - 10));
        int thr = n == 8 ? 7 : n == 16 ? 1 : n == 32 ? 0 : n == 64 ? 0 : 10;
        filt = minDist > thr;
      }
    }
    if (filt) {
      bool strongDone = false;
      if (sps->strong_intra_smoothing && c == 0 && n == 32) {
        int thr = 1 << (bd - 5);
        int corner = top[0];
        bool f1 = std::abs(corner + top[2 * n] - 2 * top[n]) < thr;
        bool f2 = std::abs(corner + left[2 * n] - 2 * left[n]) < thr;
        if (f1 && f2) {
          int bl = left[2 * n], tr = top[2 * n], co = corner;
          int32_t* nl = nlBuf;
          int32_t* nt = ntBuf;
          nl[0] = co; nt[0] = co;
          for (int i = 0; i < 2 * n; i++) {
            nl[i + 1] = ((2 * n - 1 - i) * co + (i + 1) * bl + n) >> 6;
            nt[i + 1] = ((2 * n - 1 - i) * co + (i + 1) * tr + n) >> 6;
          }
          nl[2 * n] = bl; nt[2 * n] = tr;
          left = nl; top = nt;
          strongDone = true;
        }
      }
      if (!strongDone) {
        // [1 2 1] over the full border
        int32_t* full = s_full; int32_t* sm = s_sm;
        for (int i = 0; i < 2 * n; i++) full[i] = left[2 * n - i];
        full[2 * n] = top[0];
        for (int i = 1; i <= 2 * n; i++) full[2 * n + i] = top[i];
        sm[0] = full[0];
        sm[4 * n] = full[4 * n];
        for (int i = 1; i < 4 * n; i++)
          sm[i] = (full[i - 1] + 2 * full[i] + full[i + 1] + 2) >> 2;
        for (int i = 0; i <= 2 * n; i++) left[i] = sm[2 * n - i];
        for (int i = 0; i <= 2 * n; i++) top[i] = sm[2 * n + i];
      }
    }

    // predict (Rec. 8.4.4.2.4-6)
    int32_t* pred = s_pred;
    if (mode == 0) {  // planar
      int tr = top[n + 1], bl = left[n + 1];
      int log2n = 0; while ((1 << log2n) < n) log2n++;
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++) {
          int64_t hor = int64_t(n - 1 - i) * left[j + 1] + int64_t(i + 1) * tr;
          int64_t ver = int64_t(n - 1 - j) * top[i + 1] + int64_t(j + 1) * bl;
          pred[size_t(j) * n + i] = int32_t((hor + ver + n) >> (log2n + 1));
        }
    } else if (mode == 1) {  // DC
      int64_t s = 0;
      for (int i = 1; i <= n; i++) s += top[i] + left[i];
      int log2n = 0; while ((1 << log2n) < n) log2n++;
      int dc = int((s + n) >> (log2n + 1));
      for (int i = 0; i < n * n; i++) pred[i] = dc;
      if (c == 0 && n < 32) {
        pred[0] = (left[1] + 2 * dc + top[1] + 2) >> 2;
        for (int i = 1; i < n; i++) pred[i] = (top[i + 1] + 3 * dc + 2) >> 2;
        for (int j = 1; j < n; j++)
          pred[size_t(j) * n] = (left[j + 1] + 3 * dc + 2) >> 2;
      }
    } else {  // angular
      int ang = kAng[mode];
      bool vertical = mode >= 18;
      const int32_t* main = vertical ? top : left;
      const int32_t* side = vertical ? left : top;
      int32_t* refBuf = s_refBuf;
      const int32_t* ref;
      int baseIdx;
      if (ang < 0) {
        int inv = invAngOf(ang);
        for (int i = 0; i <= n; i++) refBuf[n + i] = main[i];
        int lo = (n * ang) >> 5;
        for (int i = -1; i >= lo; i--)
          refBuf[n + i] = side[std::min((-i * inv + 128) >> 8, 2 * n)];
        // entries below n+lo are never read (min idx = n+1+lo)
        ref = refBuf;
        baseIdx = n;
      } else {
        ref = main;
        baseIdx = 0;
      }
      for (int j = 0; j < n; j++) {
        int pos = (j + 1) * ang;
        int intOff = pos >> 5;
        int frac = pos & 31;
        int idx = baseIdx + 1 + intOff;
        for (int i = 0; i < n; i++) {
          int v;
          if (frac)
            v = int((int64_t(32 - frac) * ref[idx + i] +
                     int64_t(frac) * ref[idx + i + 1] + 16) >> 5);
          else
            v = ref[idx + i];
          if (vertical) pred[size_t(j) * n + i] = v;
          else pred[size_t(i) * n + j] = v;
        }
      }
      // edge (gradient) filters are disabled for implicit-RDPCM lossless
      // CUs (reference TComPrediction.cpp:476 enableEdgeFilters)
      bool edgeFiltOk = !(sps->implicit_rdpcm &&
                          pic->tq_bypass[size_t(ly >> 2) * w4() + (lx >> 2)]);
      if (c == 0 && n < 32 && edgeFiltOk) {
        if (mode == 26) {
          for (int j = 0; j < n; j++) {
            int64_t d = (int64_t(left[j + 1]) - top[0]) >> 1;
            pred[size_t(j) * n] = clip3(0, maxv, int(top[1] + d));
          }
        } else if (mode == 10) {
          for (int i = 0; i < n; i++) {
            int64_t d = (int64_t(top[i + 1]) - left[0]) >> 1;
            pred[i] = clip3(0, maxv, int(left[1] + d));
          }
        }
      }
    }
    // add residual + clip + store
    const int16_t* res = nullptr;
    if (blk.tu_index >= 0)
      res = &resPool[pic->tu_list[blk.tu_index].coeff_off];
    for (int j = 0; j < blk.h; j++)
      for (int i = 0; i < blk.w; i++) {
        int v = pred[size_t(j) * n + i];
        if (res) v += res[size_t(j) * blk.w + i];
        plane[int64_t(blk.y + j) * stride + blk.x + i] =
            Pel(clip3(0, maxv, v));
      }
  }

  // -------------------------------------------------------------------------
  // deblocking (scalar port of the validated numpy oracle)
  // -------------------------------------------------------------------------
  bool noFilterAt(int y4v, int x4v) {
    size_t i = size_t(y4v) * w4() + x4v;
    if (pic->tq_bypass[i]) return true;
    if (sps->pcm_enabled && sps->pcm_loop_filter_disabled && pic->pcm[i])
      return true;
    return false;
  }

  bool edgeAllowed(int qy4, int qx4, int py4, int px4) {
    size_t qi = size_t(qy4) * w4() + qx4;
    size_t pix = size_t(py4) * w4() + px4;
    if (pic->slice_idx[qi] != pic->slice_idx[pix]) {
      if (!pic->lf_across[qi] || !pic->lf_across[pix]) return false;
    }
    int s = log2Ctb - 2;
    int tq = tileMap[size_t(qy4 >> s) * wCtbs + (qx4 >> s)];
    int tp = tileMap[size_t(py4 >> s) * wCtbs + (px4 >> s)];
    if (tq != tp && !pps->loop_filter_across_tiles) return false;
    return true;
  }

  int mvBs(int py4, int px4, int qy4, int qx4) {
    size_t pix = size_t(py4) * w4() + px4;
    size_t qi = size_t(qy4) * w4() + qx4;
    int pdir = pic->inter_dir[pix], qdir = pic->inter_dir[qi];
    int pr[2], qr[2];
    int pmv[2][2], qmv[2][2];
    int np = 0, nq = 0;
    for (int l = 0; l < 2; l++) {
      if (pdir & (1 << l)) {
        pr[np] = pic->ref_poc[pix * 2 + l];
        pmv[np][0] = pic->mv[(pix * 2 + l) * 2];
        pmv[np][1] = pic->mv[(pix * 2 + l) * 2 + 1];
        np++;
      }
      if (qdir & (1 << l)) {
        qr[nq] = pic->ref_poc[qi * 2 + l];
        qmv[nq][0] = pic->mv[(qi * 2 + l) * 2];
        qmv[nq][1] = pic->mv[(qi * 2 + l) * 2 + 1];
        nq++;
      }
    }
    if (np != nq) return 1;
    auto far = [](const int a[2], const int b[2]) {
      return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
    };
    if (np == 1) {
      if (pr[0] != qr[0]) return 1;
      return far(pmv[0], qmv[0]) ? 1 : 0;
    }
    int pl = std::min(pr[0], pr[1]), ph = std::max(pr[0], pr[1]);
    int ql = std::min(qr[0], qr[1]), qh = std::max(qr[0], qr[1]);
    if (pl != ql || ph != qh) return 1;
    if (pr[0] == pr[1]) {
      if ((far(pmv[0], qmv[0]) || far(pmv[1], qmv[1])) &&
          (far(pmv[0], qmv[1]) || far(pmv[1], qmv[0])))
        return 1;
      return 0;
    }
    if (pr[0] == qr[0])
      return (far(pmv[0], qmv[0]) || far(pmv[1], qmv[1])) ? 1 : 0;
    return (far(pmv[0], qmv[1]) || far(pmv[1], qmv[0])) ? 1 : 0;
  }

  void filterLumaSeg(Pel* luma, int64_t stride, bool vertical, int row,
                     int col, int tc, int beta, bool noP, bool noQ, int maxv) {
    // access helper: vertical edges filter along rows; horizontal are the
    // transpose (row<->col)
    auto S = [&](int r, int cix) -> Pel& {
      return vertical ? luma[int64_t(row + r) * stride + col + cix]
                      : luma[int64_t(col + cix) * stride + row + r];
    };
    int dp0, dp3, dq0, dq3;
    {
      int p0 = S(0, -1), p1v = S(0, -2), p2 = S(0, -3);
      int q0 = S(0, 0), q1v = S(0, 1), q2 = S(0, 2);
      dp0 = std::abs(p2 - 2 * p1v + p0);
      dq0 = std::abs(q2 - 2 * q1v + q0);
      p0 = S(3, -1); p1v = S(3, -2); p2 = S(3, -3);
      q0 = S(3, 0); q1v = S(3, 1); q2 = S(3, 2);
      dp3 = std::abs(p2 - 2 * p1v + p0);
      dq3 = std::abs(q2 - 2 * q1v + q0);
    }
    int d0 = dp0 + dq0, d3 = dp3 + dq3;
    int d = d0 + d3;
    if (d >= beta) return;
    auto strongLine = [&](int i, int di) {
      int p0 = S(i, -1), p3 = S(i, -4), q0 = S(i, 0), q3 = S(i, 3);
      return 2 * di < (beta >> 2) &&
             std::abs(p3 - p0) + std::abs(q0 - q3) < (beta >> 3) &&
             std::abs(p0 - q0) < ((tc * 5 + 1) >> 1);
    };
    bool sw = strongLine(0, d0) && strongLine(3, d3);
    for (int i = 0; i < 4; i++) {
      int p[4], q[4];
      for (int k = 0; k < 4; k++) { p[k] = S(i, -1 - k); q[k] = S(i, k); }
      if (sw) {
        int tc2 = 2 * tc;
        if (!noP) {
          S(i, -1) = clip3(p[0] - tc2, p[0] + tc2,
                           (p[2] + 2 * p[1] + 2 * p[0] + 2 * q[0] + q[1] + 4) >> 3);
          S(i, -2) = clip3(p[1] - tc2, p[1] + tc2,
                           (p[2] + p[1] + p[0] + q[0] + 2) >> 2);
          S(i, -3) = clip3(p[2] - tc2, p[2] + tc2,
                           (2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3);
        }
        if (!noQ) {
          S(i, 0) = clip3(q[0] - tc2, q[0] + tc2,
                          (q[2] + 2 * q[1] + 2 * q[0] + 2 * p[0] + p[1] + 4) >> 3);
          S(i, 1) = clip3(q[1] - tc2, q[1] + tc2,
                          (q[2] + q[1] + q[0] + p[0] + 2) >> 2);
          S(i, 2) = clip3(q[2] - tc2, q[2] + tc2,
                          (2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3);
        }
      } else {
        int delta = (9 * (q[0] - p[0]) - 3 * (q[1] - p[1]) + 8) >> 4;
        if (std::abs(delta) < tc * 10) {
          delta = clip3(-tc, tc, delta);
          if (!noP) S(i, -1) = clip3(0, maxv, p[0] + delta);
          if (!noQ) S(i, 0) = clip3(0, maxv, q[0] - delta);
          int sideThr = beta + (beta >> 1);
          if ((dp0 + dp3) < (sideThr >> 3) && !noP) {
            int d2 = clip3(-(tc >> 1), tc >> 1,
                           (((p[2] + p[0] + 1) >> 1) - p[1] + delta) >> 1);
            S(i, -2) = clip3(0, maxv, p[1] + d2);
          }
          if ((dq0 + dq3) < (sideThr >> 3) && !noQ) {
            int d2 = clip3(-(tc >> 1), tc >> 1,
                           (((q[2] + q[0] + 1) >> 1) - q[1] - delta) >> 1);
            S(i, 1) = clip3(0, maxv, q[1] + d2);
          }
        }
      }
    }
  }

  void deblock() {
    int h4 = pic->h4, w4v = pic->w4;
    for (int pass = 0; pass < 2; pass++) {
      bool vertical = pass == 0;
      int edgeMask = vertical ? (1 | 4 | 16) : (2 | 8 | 32);
      int tuBit = vertical ? 1 : 2;
      int puBit = vertical ? 4 : 8;
      for (int y4v = 0; y4v < h4; y4v++)
        for (int x4v = 0; x4v < w4v; x4v++) {
          if (vertical) {
            if (x4v == 0 || (x4v & 1)) continue;
          } else {
            if (y4v == 0 || (y4v & 1)) continue;
          }
          size_t qi = size_t(y4v) * w4v + x4v;
          int flags = pic->edge_flags[qi];
          if (!(flags & edgeMask)) continue;
          if (pic->deblock_disable[qi]) continue;
          int py4 = vertical ? y4v : y4v - 1;
          int px4 = vertical ? x4v - 1 : x4v;
          if (!edgeAllowed(y4v, x4v, py4, px4)) continue;
          size_t piv = size_t(py4) * w4v + px4;
          int b;
          if (pic->pred_mode[qi] == 1 || pic->pred_mode[piv] == 1) b = 2;
          else if ((flags & tuBit) &&
                   (pic->cbf_y[qi] || pic->cbf_y[piv])) b = 1;
          else if (flags & (puBit | tuBit)) b = mvBs(py4, px4, y4v, x4v);
          else b = 0;
          if (!b) continue;
          int qpP = pic->qp[piv], qpQ = pic->qp[qi];
          int qpL = (qpP + qpQ + 1) >> 1;
          int boff = pic->beta_offset[qi], toff = pic->tc_offset[qi];
          int idxB = clip3(0, 51, qpL + boff);
          int idxT = clip3(0, 53, qpL + 2 * (b - 1) + toff);
          int bdShift = sps->bit_depth_luma - 8;
          int beta = kBetaTbl[idxB] << bdShift;
          int tc = kTcTbl[idxT] << bdShift;
          if (tc == 0 && beta == 0) continue;
          bool noP = noFilterAt(py4, px4);
          bool noQ = noFilterAt(y4v, x4v);
          int maxvL = (1 << sps->bit_depth_luma) - 1;
          if (beta) {
            int row = vertical ? y4v << 2 : x4v << 2;
            int col = vertical ? x4v << 2 : y4v << 2;
            filterLumaSeg(pic->plane[0].data(), planeW(0), vertical, row, col,
                          tc, beta, noP, noQ, maxvL);
          }
          if (b == 2 && sps->chroma_format_idc != 0) {
            int sx = sps->ssx(), sy = sps->ssy();
            int grid = 8 << (vertical ? sx : sy);
            int coord = vertical ? x4v << 2 : y4v << 2;
            if (coord % grid) continue;
            for (int c = 1; c < 3; c++) {
              int qpOff = c == 1 ? pps->cb_qp_offset : pps->cr_qp_offset;
              int qpi = clip3(0, 57, qpL + qpOff);
              int qpc = chromaQpScale(sps->chroma_format_idc, qpi);
              int idxTc = clip3(0, 53, qpc + 2 + toff);
              int tcc = kTcTbl[idxTc] << (sps->bit_depth_chroma - 8);
              if (!tcc) continue;
              int maxvC = (1 << sps->bit_depth_chroma) - 1;
              Pel* plane = pic->plane[c].data();
              int64_t stride = planeW(c);
              int cy, cx, nlines;
              if (vertical) {
                cy = (y4v << 2) >> sy; cx = (x4v << 2) >> sx;
                nlines = 4 >> sy;
              } else {
                cy = (x4v << 2) >> sx; cx = (y4v << 2) >> sy;
                nlines = 4 >> sx;
              }
              auto SC = [&](int r, int cix) -> Pel& {
                return vertical ? plane[int64_t(cy + r) * stride + cx + cix]
                                : plane[int64_t(cx + cix) * stride + cy + r];
              };
              for (int i = 0; i < nlines; i++) {
                int p1v = SC(i, -2), p0 = SC(i, -1);
                int q0 = SC(i, 0), q1v = SC(i, 1);
                int delta = clip3(-tcc, tcc,
                                  ((((q0 - p0) * 4) + p1v - q1v + 4) >> 3));
                if (!noP) SC(i, -1) = clip3(0, maxvC, p0 + delta);
                if (!noQ) SC(i, 0) = clip3(0, maxvC, q0 - delta);
              }
            }
          }
        }
    }
  }

  // -------------------------------------------------------------------------
  // SAO
  // -------------------------------------------------------------------------
  bool saoCrossOk(int yy, int xx, int ny, int nx, int sx, int sy) {
    int ly = yy << sy, lx = xx << sx;
    int lny = clip3(0, (pic->h4 << 2) - 1, ny << sy);
    int lnx = clip3(0, (pic->w4 << 2) - 1, nx << sx);
    size_t ci = size_t(ly >> 2) * w4() + (lx >> 2);
    size_t ni = size_t(lny >> 2) * w4() + (lnx >> 2);
    bool okSlice = pic->slice_idx[ci] == pic->slice_idx[ni] ||
                   (pic->lf_across[ci] && pic->lf_across[ni]);
    int curT = tileMap[size_t(ly >> log2Ctb) * wCtbs + (lx >> log2Ctb)];
    int nbT = tileMap[size_t(lny >> log2Ctb) * wCtbs + (lnx >> log2Ctb)];
    bool okTile = curT == nbT || pps->loop_filter_across_tiles;
    return okSlice && okTile;
  }

  void sao() {
    static const int eoDy1[5] = {0, 0, -1, -1, -1};
    static const int eoDx1[5] = {0, -1, 0, -1, 1};
    static const int eoDy2[5] = {0, 0, 1, 1, 1};
    static const int eoDx2[5] = {0, 1, 0, 1, -1};
    // copy of deblocked planes as SAO source (only for components that
    // actually run SAO in this picture)
    PelBuf srcs[3];
    for (int c = 0; c < ncomp; c++) {
      bool any = false;
      for (int addr = 0; addr < wCtbs * hCtbs && !any; addr++)
        any = pic->sao_type[size_t(addr) * 3 + c] >= 0;
      if (any) srcs[c] = pic->plane[c];
    }
    for (int addr = 0; addr < wCtbs * hCtbs; addr++) {
      int cx0 = (addr % wCtbs) << log2Ctb;
      int cy0 = (addr / wCtbs) << log2Ctb;
      for (int c = 0; c < ncomp; c++) {
        int t = pic->sao_type[size_t(addr) * 3 + c];
        if (t < 0) continue;
        int sx = c ? sps->ssx() : 0;
        int sy = c ? sps->ssy() : 0;
        int bd = bitDepth(c);
        int maxv = (1 << bd) - 1;
        int W = compW(c), H = compH(c);
        int x0 = cx0 >> sx, y0 = cy0 >> sy;
        int x1 = std::min(x0 + (ctb >> sx), W);
        int y1 = std::min(y0 + (ctb >> sy), H);
        int scale = c == 0 ? pps->sao_offset_scale_luma
                           : pps->sao_offset_scale_chroma;
        int offs[4];
        for (int i = 0; i < 4; i++)
          offs[i] = pic->sao_offsets[(size_t(addr) * 3 + c) * 4 + i] * (1 << scale);
        const Pel* src = srcs[c].data();
        Pel* dst = pic->plane[c].data();
        int64_t stride = planeW(c);
        if (t == 0) {  // band
          int bandShift = bd - 5;
          int bandPos = pic->sao_band[size_t(addr) * 3 + c];
          int lut[32] = {0};
          for (int i = 0; i < 4; i++) lut[(bandPos + i) & 31] = offs[i];
#if defined(__AVX2__)
          bool fit8 = true;
          int16_t lut16[32];
          for (int i = 0; i < 32; i++) {
            lut16[i] = int16_t(lut[i]);
            if (lut[i] < -128 || lut[i] > 127) fit8 = false;
          }
          if (fit8) {
            for (int yy = y0; yy < y1; yy++)
              simd::saoBandRow(src + yy * stride + x0, x1 - x0, lut16,
                               bandShift, maxv, dst + yy * stride + x0);
            continue;
          }
#endif
          for (int yy = y0; yy < y1; yy++)
            for (int xx = x0; xx < x1; xx++) {
              int v = src[yy * stride + xx];
              dst[yy * stride + xx] = clip3(0, maxv, v + lut[v >> bandShift]);
            }
        } else {  // edge
          int dy1 = eoDy1[t], dx1 = eoDx1[t], dy2 = eoDy2[t], dx2 = eoDx2[t];
          int lut[5] = {offs[0], offs[1], 0, offs[2], offs[3]};
          // interior CTUs away from picture / slice / tile boundaries can
          // skip the per-sample validity tests entirely
          bool fast = x0 + dx1 >= 0 && x1 + dx1 <= W && x0 + dx2 >= 0 &&
                      x1 + dx2 <= W && y0 + dy1 >= 0 && y1 + dy1 <= H &&
                      y0 + dy2 >= 0 && y1 + dy2 <= H;
          if (fast) {
            // neighbours of the CTU's outer ring must be same-slice/tile
            fast = saoCrossOk(y0, x0, y0 + dy1, x0 + dx1, sx, sy) &&
                   saoCrossOk(y0, x0, y0 + dy2, x0 + dx2, sx, sy) &&
                   saoCrossOk(y0, x1 - 1, y0 + dy1, x1 - 1 + dx1, sx, sy) &&
                   saoCrossOk(y0, x1 - 1, y0 + dy2, x1 - 1 + dx2, sx, sy) &&
                   saoCrossOk(y1 - 1, x0, y1 - 1 + dy1, x0 + dx1, sx, sy) &&
                   saoCrossOk(y1 - 1, x0, y1 - 1 + dy2, x0 + dx2, sx, sy) &&
                   saoCrossOk(y1 - 1, x1 - 1, y1 - 1 + dy1, x1 - 1 + dx1, sx, sy) &&
                   saoCrossOk(y1 - 1, x1 - 1, y1 - 1 + dy2, x1 - 1 + dx2, sx, sy);
          }
          if (fast) {
#if defined(__AVX2__)
            int16_t lut16[5] = {int16_t(lut[0]), int16_t(lut[1]), 0,
                                int16_t(lut[3]), int16_t(lut[4])};
            for (int yy = y0; yy < y1; yy++)
              simd::saoEdgeRow(src + yy * stride + x0,
                               src + (yy + dy1) * stride + dx1 + x0,
                               src + (yy + dy2) * stride + dx2 + x0,
                               x1 - x0, lut16, maxv, dst + yy * stride + x0);
#else
            for (int yy = y0; yy < y1; yy++) {
              const Pel* sr = src + yy * stride;
              const Pel* n1r = src + (yy + dy1) * stride + dx1;
              const Pel* n2r = src + (yy + dy2) * stride + dx2;
              Pel* dr = dst + yy * stride;
              for (int xx = x0; xx < x1; xx++) {
                int v = sr[xx];
                int s1 = (v > n1r[xx]) - (v < n1r[xx]);
                int s2 = (v > n2r[xx]) - (v < n2r[xx]);
                dr[xx] = Pel(clip3(0, maxv, v + lut[s1 + s2 + 2]));
              }
            }
#endif
          } else {
            for (int yy = y0; yy < y1; yy++)
              for (int xx = x0; xx < x1; xx++) {
                int ny1 = yy + dy1, nx1 = xx + dx1;
                int ny2 = yy + dy2, nx2 = xx + dx2;
                bool valid = ny1 >= 0 && ny1 < H && nx1 >= 0 && nx1 < W &&
                             ny2 >= 0 && ny2 < H && nx2 >= 0 && nx2 < W;
                if (valid)
                  valid = saoCrossOk(yy, xx, ny1, nx1, sx, sy) &&
                          saoCrossOk(yy, xx, ny2, nx2, sx, sy);
                if (!valid) continue;
                int v = src[yy * stride + xx];
                int a = src[ny1 * stride + nx1], b2 = src[ny2 * stride + nx2];
                int s1 = v > a ? 1 : (v < a ? -1 : 0);
                int s2 = v > b2 ? 1 : (v < b2 ? -1 : 0);
                dst[yy * stride + xx] = clip3(0, maxv, v + lut[s1 + s2 + 2]);
              }
          }
        }
      }
    }
  }

  // -------------------------------------------------------------------------
  void restoreUnfiltered(const PelBuf pre[3]) {
    bool pcmRestore = sps->pcm_enabled && sps->pcm_loop_filter_disabled;
    if (!pps->transquant_bypass_enabled && !pcmRestore) return;
    for (int y4v = 0; y4v < pic->h4; y4v++)
      for (int x4v = 0; x4v < pic->w4; x4v++) {
        size_t i = size_t(y4v) * w4() + x4v;
        bool m = pic->tq_bypass[i] || (pcmRestore && pic->pcm[i]);
        if (!m) continue;
        for (int c = 0; c < ncomp; c++) {
          int sx = c ? sps->ssx() : 0;
          int sy = c ? sps->ssy() : 0;
          int bw = 4 >> sx, bh = 4 >> sy;
          int px = (x4v << 2) >> sx, py = (y4v << 2) >> sy;
          int64_t stride = planeW(c);
          for (int j = 0; j < bh; j++)
            for (int k = 0; k < bw; k++)
              pic->plane[c][(int64_t(py) + j) * stride + px + k] =
                  pre[c][(int64_t(py) + j) * stride + px + k];
        }
      }
  }

  static double now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
  }
  void run() {
    static thread_local double tRes = 0, tInter = 0, tIntra = 0, tDb = 0,
        tSao = 0;
    bool timing = getenv("HEVCDEC_TIMING") != nullptr;
    double t0 = now();
    buildGeometry();
    for (int c = 0; c < ncomp; c++) {
      int64_t pw = planeW(c), ph = planeH(c);
      // NoInitAlloc: no value-init — prediction/PCM writes every sample of
      // the real picture area before anything reads it; zero only the
      // CTU-alignment padding strips (visible through stride-sized rows)
      pic->plane[c].resize(size_t(pw) * ph);
      Pel* pl = pic->plane[c].data();
      int rw = compW(c), rh = compH(c);
      if (rw < pw)
        for (int j = 0; j < rh; j++)
          memset(pl + int64_t(j) * pw + rw, 0, size_t(pw - rw) * sizeof(Pel));
      if (rh < ph)
        memset(pl + int64_t(rh) * pw, 0, size_t((ph - rh) * pw) * sizeof(Pel));
    }
    buildResiduals();
    if (timing) { tRes += now() - t0; t0 = now(); }
    interStage();
    if (timing) { tInter += now() - t0; t0 = now(); }
    for (const PcmMeta& p : pic->pcm_list) {
      int bd = bitDepth(p.comp);
      int64_t stride = planeW(p.comp);
      const int32_t* s = &pic->pcm_samples[p.sample_off];
      for (int j = 0; j < p.h; j++)
        for (int i = 0; i < p.w; i++)
          pic->plane[p.comp][(int64_t(p.y) + j) * stride + p.x + i] =
              s[size_t(j) * p.w + i] << (bd - p.bits);
    }
    for (const IntraMeta& b : pic->intra_list) reconIntraBlock(b);
    if (timing) { tIntra += now() - t0; t0 = now(); }
    // in-loop filters with PCM / lossless restoration
    bool needPre = pps->transquant_bypass_enabled ||
                   (sps->pcm_enabled && sps->pcm_loop_filter_disabled);
    PelBuf pre[3];
    if (needPre)
      for (int c = 0; c < ncomp; c++) pre[c] = pic->plane[c];
    if (!pps->deblocking_disabled || true) {
      // slice-level disable is honoured per 4x4 via deblock_disable
      deblock();
    }
    if (timing) { tDb += now() - t0; t0 = now(); }
    if (sps->sao_enabled) sao();
    if (needPre) restoreUnfiltered(pre);
    if (timing) {
      tSao += now() - t0;
      fprintf(stderr, "recon cum: res %.3f inter %.3f intra %.3f db %.3f sao %.3f\n",
              tRes, tInter, tIntra, tDb, tSao);
    }
  }
};

inline void reconstructPicture(Picture& pic, const SPS& sps, const PPS& pps,
                               std::function<Picture*(int)> findRef) {
  // reused across pictures (per recon thread): keeps resPool at its
  // high-water capacity and the zmap/tileMap geometry caches warm
  static thread_local ReconCtx ctx;
  ctx.sps = &sps;
  ctx.pps = &pps;
  ctx.pic = &pic;
  ctx.findRef = std::move(findRef);
  ctx.run();
  ctx.findRef = nullptr;  // drop the DPB closure; pictures may be freed
}

}  // namespace hevc
