// Copied from libhm_tpu/hostdec/native/encsearch.cpp
// Encoder motion-search kernels: TZ integer search, Hadamard-costed
// fractional refinement, SATD, and a standalone luma MC interpolator.
//
// Mirrors the Python reference implementation in encoder/encoder.py
// (_tz_integer / _frac_refine / _motion_search_rect) and encoder/rd_cost.py
// (satd) exactly, which themselves rebuild reference TEncSearch::xTZSearch
// (TEncSearch.cpp:337-678), xPatternSearchFracDIF (TEncSearch.cpp:4563) and
// TComRdCost xGetSATD / xGetComponentBits.
//
// Compiled into libhevcdec.so via api.cpp (same translation unit as
// recon.cpp, whose kLumaF / kIfPrec / kIfOffs / clip3 it reuses).

namespace hevc {
namespace enc {

// ---------------------------------------------------------------------------
// SATD (sum of absolute Hadamard-transformed differences, HM normalization:
// 8x8 tiles when both dims allow, else 4x4, else plain SAD).
// ---------------------------------------------------------------------------
static inline void fwht8(int32_t* v) {
  for (int half = 1; half < 8; half <<= 1)
    for (int i = 0; i < 8; i += half << 1)
      for (int j = i; j < i + half; j++) {
        int32_t a = v[j], b = v[j + half];
        v[j] = a + b;
        v[j + half] = a - b;
      }
}

static inline void fwht4(int32_t* v) {
  int32_t a = v[0] + v[1], b = v[0] - v[1];
  int32_t c = v[2] + v[3], d = v[2] - v[3];
  v[0] = a + c; v[1] = b + d; v[2] = a - c; v[3] = b - d;
}

#if defined(__AVX2__)
// one 8x8 SATD tile: rows in 8 ymm registers of int32; the column pass is
// register-wise butterflies, the row pass is the same after an 8x8 int32
// transpose.  Exact (all arithmetic int32, same order-independent abs-sum).
static inline long long satd8x8Tile(const int32_t* d, int stride) {
  __m256i r[8];
  for (int i = 0; i < 8; i++)
    r[i] = _mm256_loadu_si256((const __m256i*)(d + (long long)i * stride));
  auto bfly = [](__m256i* v) {
    for (int half = 1; half < 8; half <<= 1)
      for (int i = 0; i < 8; i += half << 1)
        for (int j = i; j < i + half; j++) {
          __m256i a = v[j], b = v[j + half];
          v[j] = _mm256_add_epi32(a, b);
          v[j + half] = _mm256_sub_epi32(a, b);
        }
  };
  bfly(r);           // vertical pass (columns)
  // 8x8 int32 transpose
  __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
  __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
  __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
  __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
  __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
  __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
  __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
  __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
  __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
  __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
  __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
  __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
  __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
  r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
  r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
  r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
  r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
  r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
  r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
  r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
  r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
  bfly(r);           // second pass (the original rows)
  __m256i acc = _mm256_setzero_si256();
  for (int i = 0; i < 8; i++)
    acc = _mm256_add_epi32(acc, _mm256_abs_epi32(r[i]));
  __m128i lo = _mm256_castsi256_si128(acc);
  __m128i hi = _mm256_extracti128_si256(acc, 1);
  __m128i s4 = _mm_add_epi32(lo, hi);
  s4 = _mm_add_epi32(s4, _mm_shuffle_epi32(s4, 0x4E));
  s4 = _mm_add_epi32(s4, _mm_shuffle_epi32(s4, 0xB1));
  long long s = (uint32_t)_mm_cvtsi128_si32(s4);
  return (s + 2) >> 2;
}
#endif

static long long satdBlock(const int32_t* diff, int w, int h) {
  long long total = 0;
  if (w % 8 == 0 && h % 8 == 0) {
    for (int ty = 0; ty < h; ty += 8)
      for (int tx = 0; tx < w; tx += 8) {
#if defined(__AVX2__)
        total += satd8x8Tile(diff + (long long)ty * w + tx, w);
#else
        int32_t m[64];
        for (int r = 0; r < 8; r++) {
          for (int c = 0; c < 8; c++) m[r * 8 + c] = diff[(ty + r) * w + tx + c];
          fwht8(&m[r * 8]);
        }
        long long s = 0;
        for (int c = 0; c < 8; c++) {
          int32_t col[8];
          for (int r = 0; r < 8; r++) col[r] = m[r * 8 + c];
          fwht8(col);
          for (int r = 0; r < 8; r++) s += col[r] < 0 ? -col[r] : col[r];
        }
        total += (s + 2) >> 2;
#endif
      }
    return total;
  }
  if (w % 4 == 0 && h % 4 == 0) {
    for (int ty = 0; ty < h; ty += 4)
      for (int tx = 0; tx < w; tx += 4) {
        int32_t m[16];
        for (int r = 0; r < 4; r++) {
          for (int c = 0; c < 4; c++) m[r * 4 + c] = diff[(ty + r) * w + tx + c];
          fwht4(&m[r * 4]);
        }
        long long s = 0;
        for (int c = 0; c < 4; c++) {
          int32_t col[4] = {m[c], m[4 + c], m[8 + c], m[12 + c]};
          fwht4(col);
          for (int r = 0; r < 4; r++) s += col[r] < 0 ? -col[r] : col[r];
        }
        total += (s + 1) >> 1;
      }
    return total;
  }
  long long s = 0;
  for (int i = 0; i < w * h; i++) s += diff[i] < 0 ? -diff[i] : diff[i];
  return s;
}

// ---------------------------------------------------------------------------
// MVD bit model: signed-EG0 bit length of each component (reference
// TComRdCost::xGetComponentBits bit table).
// ---------------------------------------------------------------------------
static inline int mvBits(int dx, int dy) {
  int b = 0;
  for (int t = 0; t < 2; t++) {
    int v = t ? dy : dx;
    unsigned n = ((unsigned)(v < 0 ? -v : v) << 1) + (v <= 0 ? 1 : 0);
    int bl = 32 - __builtin_clz(n);  // n >= 1 always
    b += 2 * (bl - 1) + 1;
  }
  return b;
}

// ---------------------------------------------------------------------------
// Luma qpel interpolation over an unpadded plane, clamped gathers — exact
// mirror of hostdec/motion.py _interp (taps=8) for is_last both ways.
// dst receives w*h samples of T (clipped Pel when isLast, IF-precision
// intermediates otherwise).  T = int16_t holds them at bit depths up to 12
// (AVX2 rows); T = int32_t at every depth 8-16, on int32 intermediates with
// H.265's shifts (8.5.3.3.3.1: shift1 = 6 - hr = Min(4, bd - 8), shift3 =
// hr = Max(2, 14 - bd)) and scalar loops, as recon.cpp's interpWide: from
// 13 bits on the first stage passes 2^15 on hard edges.
// ---------------------------------------------------------------------------
template <typename T>
static void interpLuma(const T* ref, int W, int H, long long stride,
                       int x, int y, int w, int h, int mvx, int mvy,
                       int bd, bool isLast, T* dst) {
  constexpr bool kWide = std::is_same<T, int32_t>::value;
  int fx = mvx & 3, fy = mvy & 3;
  int ix = x + (mvx >> 2), iy = y + (mvy >> 2);
  int headroom = kIfPrec - bd;
  int hr = headroom < 2 ? 2 : headroom;
  int maxv = (1 << bd) - 1;
  auto S = [&](int yy, int xx) -> int {
    yy = clip3(0, H - 1, yy);
    xx = clip3(0, W - 1, xx);
    return ref[(long long)yy * stride + xx];
  };
  const int* fh = kLumaF[fx];
  const int* fv = kLumaF[fy];
  bool interior = ix - 3 >= 0 && ix + w + 3 < W && iy - 3 >= 0 && iy + h + 3 < H;
  if (fx == 0 && fy == 0) {
    // the int16 form keeps 14 - bd, which equals hr up to 12 bits
    int up = kWide ? hr : headroom;
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int v = S(iy + j, ix + i);
        dst[j * w + i] = (T)(isLast ? v : (v << up) - kIfOffs);
      }
    return;
  }
  static thread_local int32_t acc32[128];
  if (fy == 0) {
    // single horizontal stage (is_first=true)
    int shift = 6, offset;
    if (isLast) offset = 1 << (shift - 1);
    else { shift -= hr; offset = -(kIfOffs << shift); }
    for (int j = 0; j < h; j++) {
      if (interior) {
        const T* row = ref + (long long)(iy + j) * stride + ix - 3;
#if defined(__AVX2__)
        if constexpr (!kWide) {
          hevc::simd::hfilt<8>(row, w, fh, acc32);
          if (isLast)
            hevc::simd::shiftClipStore(acc32, w, offset, shift, maxv,
                                       dst + (long long)j * w);
          else
            hevc::simd::shiftNarrow(acc32, w, offset, shift,
                                    dst + (long long)j * w);
          continue;
        }
#endif
        for (int i = 0; i < w; i++) {
          int acc = 0;
          for (int k = 0; k < 8; k++) acc += fh[k] * row[i + k];
          int v = (acc + offset) >> shift;
          dst[j * w + i] = (T)(isLast ? clip3(0, maxv, v) : v);
        }
      } else {
        for (int i = 0; i < w; i++) {
          int acc = 0;
          for (int k = 0; k < 8; k++) acc += fh[k] * S(iy + j, ix + i + k - 3);
          int v = (acc + offset) >> shift;
          dst[j * w + i] = (T)(isLast ? clip3(0, maxv, v) : v);
        }
      }
    }
    return;
  }
  if (fx == 0) {
    int shift = 6, offset;
    if (isLast) offset = 1 << (shift - 1);
    else { shift -= hr; offset = -(kIfOffs << shift); }
    for (int j = 0; j < h; j++) {
      if (interior) {
        const T* col = ref + (long long)(iy + j - 3) * stride + ix;
#if defined(__AVX2__)
        if constexpr (!kWide) {
          hevc::simd::vfilt<8>(col, stride, w, fv, acc32);
          if (isLast)
            hevc::simd::shiftClipStore(acc32, w, offset, shift, maxv,
                                       dst + (long long)j * w);
          else
            hevc::simd::shiftNarrow(acc32, w, offset, shift,
                                    dst + (long long)j * w);
          continue;
        }
#endif
        for (int i = 0; i < w; i++) {
          int acc = 0;
          for (int k = 0; k < 8; k++) acc += fv[k] * col[k * stride + i];
          int v = (acc + offset) >> shift;
          dst[j * w + i] = (T)(isLast ? clip3(0, maxv, v) : v);
        }
      } else {
        for (int i = 0; i < w; i++) {
          int acc = 0;
          for (int k = 0; k < 8; k++) acc += fv[k] * S(iy + j + k - 3, ix + i);
          int v = (acc + offset) >> shift;
          dst[j * w + i] = (T)(isLast ? clip3(0, maxv, v) : v);
        }
      }
    }
    return;
  }
  // two stages: H (is_first, not last) then V (not first)
  int sh1 = 6 - hr;
  int off1 = -(kIfOffs << sh1);
  static thread_local std::vector<T> tmp;
  tmp.resize((size_t)(h + 7) * w);
  for (int j = 0; j < h + 7; j++) {
    if (interior) {
      const T* row = ref + (long long)(iy + j - 3) * stride + ix - 3;
#if defined(__AVX2__)
      if constexpr (!kWide) {
        hevc::simd::hfilt<8>(row, w, fh, acc32);
        hevc::simd::shiftNarrow(acc32, w, off1, sh1, &tmp[(size_t)j * w]);
        continue;
      }
#endif
      for (int i = 0; i < w; i++) {
        int acc = 0;
        for (int k = 0; k < 8; k++) acc += fh[k] * row[i + k];
        tmp[(size_t)j * w + i] = (T)((acc + off1) >> sh1);
      }
    } else {
      for (int i = 0; i < w; i++) {
        int acc = 0;
        for (int k = 0; k < 8; k++) acc += fh[k] * S(iy + j - 3, ix + i + k - 3);
        tmp[(size_t)j * w + i] = (T)((acc + off1) >> sh1);
      }
    }
  }
  int sh2, off2;
  if (isLast) { sh2 = 6 + hr; off2 = (1 << (sh2 - 1)) + (kIfOffs << 6); }
  else { sh2 = 6; off2 = 0; }
  for (int j = 0; j < h; j++) {
#if defined(__AVX2__)
    if constexpr (!kWide) {
      hevc::simd::vfilt<8>(tmp.data() + (size_t)j * w, w, w, fv, acc32);
      if (isLast)
        hevc::simd::shiftClipStore(acc32, w, off2, sh2, maxv,
                                   dst + (long long)j * w);
      else
        hevc::simd::shiftNarrow(acc32, w, off2, sh2, dst + (long long)j * w);
      continue;
    }
#endif
    for (int i = 0; i < w; i++) {
      int acc = 0;
      for (int k = 0; k < 8; k++) acc += fv[k] * tmp[(size_t)(j + k) * w + i];
      int v = (acc + off2) >> sh2;
      dst[j * w + i] = (T)(isLast ? clip3(0, maxv, v) : v);
    }
  }
}

// ---------------------------------------------------------------------------
// Full PU motion search: TZ integer (SAD + sqrt-lambda*mvbits over an
// edge-padded plane) then two-stage half/quarter refinement (SATD-costed
// predictions through the exact MC interpolator above).
// ---------------------------------------------------------------------------
// T is the sample type of the plane and the block: int16_t up to 12 bits
// (the int16 exports and encctu.cpp), int32_t at 8-16 bits (the *32
// exports).  A template difference is under 2^17 at 16 bits, so a row's
// SAD over 64 samples and satdBlock's int32 sums keep their headroom.
template <typename T>
struct MeArgsT {
  const T* padded;        // (H+2p) x (W+2p) edge-padded reference plane
  int pw, ph, pad;        // padded dims + pad
  const T* orig;          // w*h block (or bi template 2*orig - predOther)
  int px, py, w, h;       // PU position in unpadded coords, size
  int R;                  // integer search range
  int pmx, pmy;           // AMVP predictor (qpel)
  double lam;             // sqrt-lambda motion cost weight
  int bd;                 // bit depth
  int fast;               // 1 = TZ, 0 = exhaustive
  int subShift = 0;       // FEN subsampled SAD: rows stepped 1<<subShift
};
using MeArgs = MeArgsT<int16_t>;

long long g_sadCalls = 0, g_hadCalls = 0, g_meCalls = 0, g_sadPels = 0;
template <typename T>
static long long sadAt(const MeArgsT<T>& a, int dx, int dy) {
  g_sadCalls++; g_sadPels += (long long)a.w * (a.h >> a.subShift);
  int y0 = a.py + dy + a.pad, x0 = a.px + dx + a.pad;
  long long s = 0;
  int step = 1 << a.subShift;   // FEN: every other row for tall blocks
  if (y0 < 0 || x0 < 0 || y0 + a.h > a.ph || x0 + a.w > a.pw) {
    // a window past the padding (biRefine's int32 form): clamped gathers,
    // which read what the Python search's clipped ones read
    for (int j = 0; j < a.h; j += step) {
      const T* row = a.padded + (long long)clip3(0, a.ph - 1, y0 + j) * a.pw;
      const T* o = a.orig + (long long)j * a.w;
      int acc = 0;
      for (int i = 0; i < a.w; i++) {
        int d = row[clip3(0, a.pw - 1, x0 + i)] - o[i];
        acc += d < 0 ? -d : d;
      }
      s += acc;
    }
    return s << a.subShift;
  }
  const T* p = a.padded + (long long)y0 * a.pw + x0;
  for (int j = 0; j < a.h; j += step) {
    const T* row = p + (long long)j * a.pw;
    const T* o = a.orig + (long long)j * a.w;
    int acc = 0;
    for (int i = 0; i < a.w; i++) {
      int d = row[i] - o[i];
      acc += d < 0 ? -d : d;
    }
    s += acc;
  }
  return s << a.subShift;
}

static const int kDiamond[8][2] = {{0, -1}, {0, 1},  {-1, 0}, {1, 0},
                                   {-1, -1}, {1, -1}, {-1, 1}, {1, 1}};

template <typename T>
void meSearch(const MeArgsT<T>& a, int64_t out[3]) {
  g_meCalls++;
  int dsh = a.bd - 8;
  int side = 2 * a.R + 1;
  // generation-stamped cost cache: reassigning the full 129x129 array
  // per call costs ~130 KB of writes per PU search — measurable at
  // ~20k searches/picture
  static thread_local std::vector<double> costCache;
  static thread_local std::vector<uint32_t> costGen;
  static thread_local uint32_t gen = 0;
  if (costCache.size() < (size_t)side * side) {
    costCache.resize((size_t)side * side);
    costGen.assign((size_t)side * side, 0);
    gen = 0;
  }
  if (++gen == 0) {   // wrapped: reset stamps once
    std::fill(costGen.begin(), costGen.end(), 0);
    gen = 1;
  }
  auto cost = [&](int dx, int dy) -> double {
    size_t idx = (size_t)(dy + a.R) * side + (dx + a.R);
    if (costGen[idx] == gen) return costCache[idx];
    double c = (double)(sadAt(a, dx, dy) >> dsh) +
               a.lam * mvBits((dx << 2) - a.pmx, (dy << 2) - a.pmy);
    costCache[idx] = c;
    costGen[idx] = gen;
    return c;
  };

  int bx = 0, by = 0;
  double best;
  if (a.fast) {
    best = cost(0, 0);
    int cx = clip3(-a.R, a.R, (a.pmx + 2) >> 2);
    int cy = clip3(-a.R, a.R, (a.pmy + 2) >> 2);
    {
      double c = cost(cx, cy);
      if (c < best) { best = c; bx = cx; by = cy; }
    }
    int bestDist = 0;
    auto diamond = [&](int ox, int oy, int dist) {
      for (int k = 0; k < 8; k++) {
        int mx = ox + kDiamond[k][0] * dist;
        int my = oy + kDiamond[k][1] * dist;
        if (mx < -a.R || mx > a.R || my < -a.R || my > a.R) continue;
        double c = cost(mx, my);
        if (c < best) { best = c; bx = mx; by = my; bestDist = dist; }
      }
    };
    int sx = bx, sy = by;
    for (int d = 1; d <= a.R; d <<= 1) diamond(sx, sy, d);
    if (bestDist > 5) {
      for (int dy = -a.R; dy <= a.R; dy += 5)
        for (int dx = -a.R; dx <= a.R; dx += 5) {
          double c = cost(dx, dy);
          if (c < best) { best = c; bx = dx; by = dy; bestDist = 5; }
        }
    }
    while (bestDist) {
      int ox = bx, oy = by;
      bestDist = 0;
      for (int d = 1; d <= a.R; d <<= 1) diamond(ox, oy, d);
    }
  } else {
    best = cost(0, 0);
    for (int dy = -a.R; dy <= a.R; dy++)
      for (int dx = -a.R; dx <= a.R; dx++) {
        double c = cost(dx, dy);
        if (c < best) { best = c; bx = dx; by = dy; }
      }
  }

  // fractional refinement, Hadamard-costed.  The padded plane doubles as
  // the reference: every gather stays inside pad = R + 8.
  static thread_local std::vector<T> pred;
  pred.resize((size_t)a.w * a.h);
  static thread_local std::vector<int32_t> diff;
  diff.resize((size_t)a.w * a.h);
  auto had = [&](int mvx, int mvy) -> long long {
    g_hadCalls++;
    interpLuma(a.padded, a.pw, a.ph, a.pw, a.px + a.pad, a.py + a.pad,
               a.w, a.h, mvx, mvy, a.bd, true, pred.data());
    for (int i = 0; i < a.w * a.h; i++)
      diff[i] = (int32_t)pred[i] - (int32_t)a.orig[i];
    return satdBlock(diff.data(), a.w, a.h) >> dsh;
  };
  int mvx = bx << 2, mvy = by << 2;
  long long bestDistHad = had(mvx, mvy);
  double bestC = (double)bestDistHad + a.lam * mvBits(mvx - a.pmx, mvy - a.pmy);
  for (int step = 2; step >= 1; step--) {
    int cx = mvx, cy = mvy;
    for (int k = 0; k < 8; k++) {
      int nx = cx + kDiamond[k][0] * step;
      int ny = cy + kDiamond[k][1] * step;
      long long d = had(nx, ny);
      double c = (double)d + a.lam * mvBits(nx - a.pmx, ny - a.pmy);
      if (c < bestC) { bestC = c; mvx = nx; mvy = ny; bestDistHad = d; }
    }
  }
  out[0] = mvx;
  out[1] = mvy;
  out[2] = bestDistHad;
}

// Bi-prediction refinement pass (reference TEncSearch.cpp:4003-4021 /
// encoder.py _bi_window_search): +-4 integer SAD window around the
// current MV against the 2*orig - predOther template, then the same
// two-stage Hadamard fractional refine as meSearch.  orig holds the
// template, which needs int32 samples above 12 bits.
template <typename T>
void biRefine(const MeArgsT<T>& a, int startMvX, int startMvY,
              int64_t out[3]) {
  int dsh = a.bd - 8;
  // The MV can drift past R over repeated template passes.  The int16 form
  // clamps the window center into +-R, where every window lies inside the
  // padded plane (the 8-12-bit streams' bytes hold that); the int32 form
  // centers it where the Python search does (sadAt clamps its gathers).
  constexpr bool kWide = std::is_same<T, int32_t>::value;
  int cx = kWide ? startMvX >> 2 : clip3(-a.R, a.R, startMvX >> 2);
  int cy = kWide ? startMvY >> 2 : clip3(-a.R, a.R, startMvY >> 2);
  double best = -1.0;
  int bx = cx, by = cy;
  for (int dy = -4; dy <= 4; dy++)
    for (int dx = -4; dx <= 4; dx++) {
      double c = (double)(sadAt(a, cx + dx, cy + dy) >> dsh) +
                 a.lam * mvBits(((cx + dx) << 2) - a.pmx,
                                ((cy + dy) << 2) - a.pmy);
      if (best < 0 || c < best) { best = c; bx = cx + dx; by = cy + dy; }
    }
  static thread_local std::vector<T> pred;
  pred.resize((size_t)a.w * a.h);
  static thread_local std::vector<int32_t> diff;
  diff.resize((size_t)a.w * a.h);
  auto had = [&](int mvx, int mvy) -> long long {
    g_hadCalls++;
    interpLuma(a.padded, a.pw, a.ph, a.pw, a.px + a.pad, a.py + a.pad,
               a.w, a.h, mvx, mvy, a.bd, true, pred.data());
    for (int i = 0; i < a.w * a.h; i++)
      diff[i] = (int32_t)pred[i] - (int32_t)a.orig[i];
    return satdBlock(diff.data(), a.w, a.h) >> dsh;
  };
  int mvx = bx << 2, mvy = by << 2;
  long long bestDist = had(mvx, mvy);
  double bestC = (double)bestDist +
                 a.lam * mvBits(mvx - a.pmx, mvy - a.pmy);
  for (int step = 2; step >= 1; step--) {
    int ccx = mvx, ccy = mvy;
    for (int k = 0; k < 8; k++) {
      int nx = ccx + kDiamond[k][0] * step;
      int ny = ccy + kDiamond[k][1] * step;
      long long d = had(nx, ny);
      double c = (double)d +
                 a.lam * mvBits(nx - a.pmx, ny - a.pmy);
      if (c < bestC) { bestC = c; mvx = nx; mvy = ny; bestDist = d; }
    }
  }
  out[0] = mvx;
  out[1] = mvy;
  out[2] = bestDist;  // template-domain HAD distortion at the chosen MV
}

}  // namespace enc
}  // namespace hevc

extern "C" {

long long enc_satd(const int16_t* a, const int16_t* b, int w, int h) {
  static thread_local std::vector<int32_t> diff;
  diff.resize((size_t)w * h);
  for (int i = 0; i < w * h; i++) diff[i] = (int32_t)a[i] - (int32_t)b[i];
  return hevc::enc::satdBlock(diff.data(), w, h);
}

// int32 entry point (no host-side narrowing/copies needed)
long long enc_satd32(const int32_t* a, const int32_t* b, int w, int h) {
  static thread_local std::vector<int32_t> diff;
  diff.resize((size_t)w * h);
  for (int i = 0; i < w * h; i++) diff[i] = a[i] - b[i];
  return hevc::enc::satdBlock(diff.data(), w, h);
}

void enc_me_search(const int16_t* padded, int pw, int ph, int pad,
                   const int16_t* orig, int px, int py, int w, int h,
                   int R, int pmx, int pmy, double lam, int bd, int fast,
                   int sub, int64_t* out) {
  hevc::enc::MeArgs a{padded, pw, ph, pad, orig, px, py, w, h,
                      R, pmx, pmy, lam, bd, fast, sub};
  hevc::enc::meSearch(a, out);
}

void enc_bi_refine(const int16_t* padded, int pw, int ph, int pad,
                   const int16_t* target, int px, int py, int w, int h,
                   int R, int pmx, int pmy, double lam, int bd,
                   int startMvX, int startMvY, int sub, int64_t* out) {
  hevc::enc::MeArgs a{padded, pw, ph, pad, target, px, py, w, h,
                      R, pmx, pmy, lam, bd, 1, sub};
  hevc::enc::biRefine(a, startMvX, startMvY, out);
}

void enc_interp_luma(const int16_t* plane, int W, int H, long long stride,
                     int x, int y, int w, int h, int mvx, int mvy,
                     int bd, int isLast, int16_t* dst) {
  hevc::enc::interpLuma(plane, W, H, stride, x, y, w, h, mvx, mvy, bd,
                        isLast != 0, dst);
}

// The same search on int32 planes, blocks and templates: exact at 8-16
// bits (the int16 forms above hold samples up to 12 bits).
void enc_me_search32(const int32_t* padded, int pw, int ph, int pad,
                     const int32_t* orig, int px, int py, int w, int h,
                     int R, int pmx, int pmy, double lam, int bd, int fast,
                     int sub, int64_t* out) {
  hevc::enc::MeArgsT<int32_t> a{padded, pw, ph, pad, orig, px, py, w, h,
                                R, pmx, pmy, lam, bd, fast, sub};
  hevc::enc::meSearch(a, out);
}

void enc_bi_refine32(const int32_t* padded, int pw, int ph, int pad,
                     const int32_t* target, int px, int py, int w, int h,
                     int R, int pmx, int pmy, double lam, int bd,
                     int startMvX, int startMvY, int sub, int64_t* out) {
  hevc::enc::MeArgsT<int32_t> a{padded, pw, ph, pad, target, px, py, w, h,
                                R, pmx, pmy, lam, bd, 1, sub};
  hevc::enc::biRefine(a, startMvX, startMvY, out);
}

void enc_interp_luma32(const int32_t* plane, int W, int H, long long stride,
                       int x, int y, int w, int h, int mvx, int mvy,
                       int bd, int isLast, int32_t* dst) {
  hevc::enc::interpLuma(plane, W, H, stride, x, y, w, h, mvx, mvy, bd,
                        isLast != 0, dst);
}

}  // extern "C"
