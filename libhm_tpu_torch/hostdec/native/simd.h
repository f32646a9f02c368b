// Copied from libhm_tpu/hostdec/native/simd.h
// AVX2 kernels for the hot reconstruction loops (bit-exact int16/int32).
//
// The MC interpolation and inverse-transform inner loops are all of the
// form acc32[i] = sum_k tap16[k] * src16[i or k ...]: the densest AVX2
// encoding is vpmaddwd over tap PAIRS (one madd = 16 multiplies + 8 adds),
// ~3x fewer uops than the compiler's vpmovsxwd+vpmulld autovectorization.
// All accumulations stay in int32 with |tap| <= 90 and |src| <= 2^15, so
// every pairwise product sum fits int32 exactly — bit-identical to the
// scalar reference loops (HM TComInterpolationFilter::filter<N>,
// TComTrQuant::partialButterflyInverse*).
#pragma once
#include <cstdint>
#if defined(__AVX2__)
#include <immintrin.h>

namespace hevc {
namespace simd {

// --- horizontal FIR ---------------------------------------------------------
// acc[i] = sum_{k<taps} f[k] * src[i+k], for i in [0,w).  Tail done by caller
// (w assumed multiple of 4 handled here with masked scalar fallback).
//
// Even/odd madd trick: madd(load(src+i+2p), (f2p,f2p+1)) yields the even
// outputs; the +1-shifted load yields the odd outputs; interleave restores
// order.
template <int taps>
static inline void hfilt(const int16_t* src, int w, const int* f,
                         int32_t* acc) {
  __m256i fp[taps / 2];
  for (int p = 0; p < taps / 2; p++)
    fp[p] = _mm256_set1_epi32((uint16_t(f[2 * p])) |
                              (uint32_t(uint16_t(f[2 * p + 1])) << 16));
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i e = _mm256_setzero_si256(), o = _mm256_setzero_si256();
    for (int p = 0; p < taps / 2; p++) {
      e = _mm256_add_epi32(
          e, _mm256_madd_epi16(
                 _mm256_loadu_si256((const __m256i*)(src + i + 2 * p)), fp[p]));
      o = _mm256_add_epi32(
          o, _mm256_madd_epi16(
                 _mm256_loadu_si256((const __m256i*)(src + i + 2 * p + 1)),
                 fp[p]));
    }
    // e = outputs {0,2,..,6 | 8,..,14}, o = {1,3,..,7 | 9,..,15}
    __m256i lo = _mm256_unpacklo_epi32(e, o);   // 0,1,2,3 | 8,9,10,11
    __m256i hi = _mm256_unpackhi_epi32(e, o);   // 4,5,6,7 | 12,13,14,15
    _mm256_storeu_si256((__m256i*)(acc + i),
                        _mm256_permute2x128_si256(lo, hi, 0x20));
    _mm256_storeu_si256((__m256i*)(acc + i + 8),
                        _mm256_permute2x128_si256(lo, hi, 0x31));
  }
  for (; i + 8 <= w; i += 8) {
    __m128i e = _mm_setzero_si128(), o = _mm_setzero_si128();
    for (int p = 0; p < taps / 2; p++) {
      __m128i fpl = _mm256_castsi256_si128(fp[p]);
      e = _mm_add_epi32(
          e, _mm_madd_epi16(_mm_loadu_si128((const __m128i*)(src + i + 2 * p)),
                            fpl));
      o = _mm_add_epi32(
          o, _mm_madd_epi16(
                 _mm_loadu_si128((const __m128i*)(src + i + 2 * p + 1)), fpl));
    }
    _mm_storeu_si128((__m128i*)(acc + i), _mm_unpacklo_epi32(e, o));
    _mm_storeu_si128((__m128i*)(acc + i + 4), _mm_unpackhi_epi32(e, o));
  }
  for (; i < w; i++) {
    int32_t s = 0;
    for (int k = 0; k < taps; k++) s += f[k] * src[i + k];
    acc[i] = s;
  }
}

// --- vertical FIR ------------------------------------------------------------
// acc[i] = sum_{k<taps} f[k] * src[k*stride + i], for i in [0,w).
// Row-pair unpack trick: unpack rows 2p/2p+1 into int16 pairs and madd.
template <int taps>
static inline void vfilt(const int16_t* src, int64_t stride, int w,
                         const int* f, int32_t* acc) {
  __m256i fp[taps / 2];
  for (int p = 0; p < taps / 2; p++)
    fp[p] = _mm256_set1_epi32((uint16_t(f[2 * p])) |
                              (uint32_t(uint16_t(f[2 * p + 1])) << 16));
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i aLo = _mm256_setzero_si256(), aHi = _mm256_setzero_si256();
    for (int p = 0; p < taps / 2; p++) {
      __m256i r0 =
          _mm256_loadu_si256((const __m256i*)(src + 2 * p * stride + i));
      __m256i r1 =
          _mm256_loadu_si256((const __m256i*)(src + (2 * p + 1) * stride + i));
      aLo = _mm256_add_epi32(
          aLo, _mm256_madd_epi16(_mm256_unpacklo_epi16(r0, r1), fp[p]));
      aHi = _mm256_add_epi32(
          aHi, _mm256_madd_epi16(_mm256_unpackhi_epi16(r0, r1), fp[p]));
    }
    // aLo = outputs {0..3 | 8..11}, aHi = {4..7 | 12..15}
    _mm256_storeu_si256((__m256i*)(acc + i),
                        _mm256_permute2x128_si256(aLo, aHi, 0x20));
    _mm256_storeu_si256((__m256i*)(acc + i + 8),
                        _mm256_permute2x128_si256(aLo, aHi, 0x31));
  }
  for (; i + 8 <= w; i += 8) {
    __m128i aLo = _mm_setzero_si128(), aHi = _mm_setzero_si128();
    for (int p = 0; p < taps / 2; p++) {
      __m128i fpl = _mm256_castsi256_si128(fp[p]);
      __m128i r0 = _mm_loadu_si128((const __m128i*)(src + 2 * p * stride + i));
      __m128i r1 =
          _mm_loadu_si128((const __m128i*)(src + (2 * p + 1) * stride + i));
      aLo = _mm_add_epi32(aLo, _mm_madd_epi16(_mm_unpacklo_epi16(r0, r1), fpl));
      aHi = _mm_add_epi32(aHi, _mm_madd_epi16(_mm_unpackhi_epi16(r0, r1), fpl));
    }
    _mm_storeu_si128((__m128i*)(acc + i), aLo);
    _mm_storeu_si128((__m128i*)(acc + i + 4), aHi);
  }
  for (; i < w; i++) {
    int32_t s = 0;
    for (int k = 0; k < taps; k++) s += f[k] * src[k * stride + i];
    acc[i] = s;
  }
}

// --- acc epilogues ------------------------------------------------------------
// dst[i] = int16((acc[i] + off) >> shift)   (no clip; intermediate stage)
static inline void shiftNarrow(const int32_t* acc, int w, int32_t off,
                               int shift, int16_t* dst) {
  __m256i vo = _mm256_set1_epi32(off);
  int i = 0;
  for (; i + 8 <= w; i += 8) {
    __m256i v = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_loadu_si256((const __m256i*)(acc + i)), vo),
        shift);
    // exact int16 truncation of the int32 result (values fit int16 by
    // construction in the IF pipeline)
    __m128i lo = _mm256_castsi256_si128(v);
    __m128i hi = _mm256_extracti128_si256(v, 1);
    _mm_storeu_si128((__m128i*)(dst + i), _mm_packs_epi32(lo, hi));
  }
  for (; i < w; i++) dst[i] = int16_t((acc[i] + off) >> shift);
}

// dst[i] = clip(0, maxv, (acc[i] + off) >> shift)
static inline void shiftClipStore(const int32_t* acc, int w, int32_t off,
                                  int shift, int maxv, int16_t* dst) {
  __m256i vo = _mm256_set1_epi32(off);
  __m256i vmax = _mm256_set1_epi16(int16_t(maxv));
  __m256i vzero = _mm256_setzero_si256();
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i v0 = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_loadu_si256((const __m256i*)(acc + i)), vo),
        shift);
    __m256i v1 = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_loadu_si256((const __m256i*)(acc + i + 8)), vo),
        shift);
    // packs saturates to int16; inputs are within +-2^20 >> shift ranges that
    // exceed int16 only when they'd clip to 0/maxv anyway (shift >= 6 keeps
    // |v| < 2^26-6 = 2^20 ... use 32-bit min/max before packing to be exact)
    v0 = _mm256_max_epi32(v0, vzero);
    v1 = _mm256_max_epi32(v1, vzero);
    __m256i p = _mm256_packus_epi32(v0, v1);  // lanes interleave 128-wise
    p = _mm256_permute4x64_epi64(p, 0xD8);
    p = _mm256_min_epi16(p, vmax);
    _mm256_storeu_si256((__m256i*)(dst + i), p);
  }
  for (; i < w; i++) {
    int v = (acc[i] + off) >> shift;
    dst[i] = int16_t(v < 0 ? 0 : (v > maxv ? maxv : v));
  }
}

// dst[i] = clip(0, maxv, (a[i] + b[i] + off) >> shift)  — bi-pred average
static inline void biAvg(const int16_t* a, const int16_t* b, int w,
                         int32_t off, int shift, int maxv, int16_t* dst) {
  __m256i vo = _mm256_set1_epi32(off);
  __m256i vmax = _mm256_set1_epi16(int16_t(maxv));
  __m256i vzero = _mm256_setzero_si256();
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i va = _mm256_loadu_si256((const __m256i*)(a + i));
    __m256i vb = _mm256_loadu_si256((const __m256i*)(b + i));
    // widen to per-element int32 sums (unpack+srai = exact sign extension;
    // unpack/pack lane interleavings cancel so no final permute is needed)
    __m256i aLo = _mm256_srai_epi32(_mm256_unpacklo_epi16(va, va), 16);
    __m256i aHi = _mm256_srai_epi32(_mm256_unpackhi_epi16(va, va), 16);
    __m256i bLo = _mm256_srai_epi32(_mm256_unpacklo_epi16(vb, vb), 16);
    __m256i bHi = _mm256_srai_epi32(_mm256_unpackhi_epi16(vb, vb), 16);
    __m256i v0 = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_add_epi32(aLo, bLo), vo), shift);
    __m256i v1 = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_add_epi32(aHi, bHi), vo), shift);
    v0 = _mm256_max_epi32(v0, vzero);
    v1 = _mm256_max_epi32(v1, vzero);
    __m256i p = _mm256_packus_epi32(v0, v1);  // {0..3,4..7 order preserved}
    p = _mm256_min_epi16(p, vmax);
    _mm256_storeu_si256((__m256i*)(dst + i), p);
  }
  for (; i < w; i++) {
    int v = (a[i] + b[i] + off) >> shift;
    dst[i] = int16_t(v < 0 ? 0 : (v > maxv ? maxv : v));
  }
}

// dst[i] = clip(0, maxv, dst[i] + r[i])  — residual add (saturating int16 add
// is exact here: dst in [0,maxv<=2^14), r in int16; overflow saturates to
// 32767 which still clips to maxv, underflow cannot pass -32768)
static inline void addClip(int16_t* dst, const int16_t* r, int w, int maxv) {
  __m256i vmax = _mm256_set1_epi16(int16_t(maxv));
  __m256i vzero = _mm256_setzero_si256();
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i v = _mm256_adds_epi16(_mm256_loadu_si256((const __m256i*)(dst + i)),
                                  _mm256_loadu_si256((const __m256i*)(r + i)));
    v = _mm256_min_epi16(_mm256_max_epi16(v, vzero), vmax);
    _mm256_storeu_si256((__m256i*)(dst + i), v);
  }
  for (; i < w; i++) {
    int v = dst[i] + r[i];
    dst[i] = int16_t(v < 0 ? 0 : (v > maxv ? maxv : v));
  }
}

// SAO edge-offset kernel for one row: dst[i] = clip(0, maxv,
//   src[i] + lut[sign(src[i]-n1[i]) + sign(src[i]-n2[i]) + 2])
// lut is 5 int16 entries (lut[2] == 0).
static inline void saoEdgeRow(const int16_t* src, const int16_t* n1,
                              const int16_t* n2, int w, const int16_t lut[5],
                              int maxv, int16_t* dst) {
  __m256i l0 = _mm256_set1_epi16(lut[0]), l1 = _mm256_set1_epi16(lut[1]);
  __m256i l3 = _mm256_set1_epi16(lut[3]), l4 = _mm256_set1_epi16(lut[4]);
  __m256i vmax = _mm256_set1_epi16(int16_t(maxv));
  __m256i vzero = _mm256_setzero_si256();
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i a = _mm256_loadu_si256((const __m256i*)(n1 + i));
    __m256i b = _mm256_loadu_si256((const __m256i*)(n2 + i));
    // s = s1+s2 in {-2..2}: cmpgt(a,v)-cmpgt(v,a) = (v>a) - (v<a) = sign(v-a)
    // because cmpgt yields -1 where true
    __m256i s = _mm256_add_epi16(
        _mm256_sub_epi16(_mm256_cmpgt_epi16(a, v), _mm256_cmpgt_epi16(v, a)),
        _mm256_sub_epi16(_mm256_cmpgt_epi16(b, v), _mm256_cmpgt_epi16(v, b)));
    __m256i off = vzero;  // lut index = s+2; lut[2] == 0
    off = _mm256_blendv_epi8(off, l0, _mm256_cmpeq_epi16(s, _mm256_set1_epi16(-2)));
    off = _mm256_blendv_epi8(off, l1, _mm256_cmpeq_epi16(s, _mm256_set1_epi16(-1)));
    off = _mm256_blendv_epi8(off, l3, _mm256_cmpeq_epi16(s, _mm256_set1_epi16(1)));
    off = _mm256_blendv_epi8(off, l4, _mm256_cmpeq_epi16(s, _mm256_set1_epi16(2)));
    __m256i r = _mm256_adds_epi16(v, off);  // see addClip for saturation proof
    r = _mm256_min_epi16(_mm256_max_epi16(r, vzero), vmax);
    _mm256_storeu_si256((__m256i*)(dst + i), r);
  }
  for (; i < w; i++) {
    int v = src[i];
    int s1 = (v > n1[i]) - (v < n1[i]);
    int s2 = (v > n2[i]) - (v < n2[i]);
    int r = v + lut[s1 + s2 + 2];
    dst[i] = int16_t(r < 0 ? 0 : (r > maxv ? maxv : r));
  }
}

// SAO band-offset kernel: dst[i] = clip(0, maxv, src[i] + lut32[src[i] >>
// bandShift]) where lut32 has 32 int16 entries (only 4 consecutive nonzero).
// Requires every offset to fit int8 (true for bit depths <= 12; the caller
// falls back to scalar otherwise).
static inline void saoBandRow(const int16_t* src, int w, const int16_t* lut32,
                              int bandShift, int maxv, int16_t* dst) {
  int8_t tl[16], th[16];
  for (int k = 0; k < 16; k++) {
    tl[k] = int8_t(lut32[k]);
    th[k] = int8_t(lut32[16 + k]);
  }
  __m256i tlo = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)tl));
  __m256i thi = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)th));
  __m256i vmax = _mm256_set1_epi16(int16_t(maxv));
  __m256i vzero = _mm256_setzero_si256();
  __m256i m15 = _mm256_set1_epi16(15);
  int i = 0;
  for (; i + 16 <= w; i += 16) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i band = _mm256_srai_epi16(v, bandShift);   // 0..31
    __m256i idx = _mm256_and_si256(band, m15);
    // replicate the (byte-sized) index into both bytes of each int16 lane so
    // shuffle_epi8 selects the table byte into both positions
    __m256i idxb = _mm256_or_si256(idx, _mm256_slli_epi16(idx, 8));
    __m256i sLo = _mm256_shuffle_epi8(tlo, idxb);
    __m256i sHi = _mm256_shuffle_epi8(thi, idxb);
    // sign-extend the low byte of each lane
    sLo = _mm256_srai_epi16(_mm256_slli_epi16(sLo, 8), 8);
    sHi = _mm256_srai_epi16(_mm256_slli_epi16(sHi, 8), 8);
    __m256i off = _mm256_blendv_epi8(sLo, sHi, _mm256_cmpgt_epi16(band, m15));
    __m256i r = _mm256_adds_epi16(v, off);
    r = _mm256_min_epi16(_mm256_max_epi16(r, vzero), vmax);
    _mm256_storeu_si256((__m256i*)(dst + i), r);
  }
  for (; i < w; i++) {
    int v = src[i];
    int r = v + lut32[(v >> bandShift) & 31];
    dst[i] = int16_t(r < 0 ? 0 : (r > maxv ? maxv : r));
  }
}

// dst[i] = (a[i] + b[i] + 1) >> 1 — fused integer-MV bi-prediction average.
// Exact: samples are unsigned < 2^14, avg_epu16 computes (a+b+1)>>1, and the
// result never exceeds max(a,b) so the 0..maxv clip is a no-op.
static inline void avgRound(const int16_t* a, const int16_t* b, int w,
                            int16_t* dst) {
  int i = 0;
  for (; i + 16 <= w; i += 16)
    _mm256_storeu_si256(
        (__m256i*)(dst + i),
        _mm256_avg_epu16(_mm256_loadu_si256((const __m256i*)(a + i)),
                         _mm256_loadu_si256((const __m256i*)(b + i))));
  for (; i < w; i++) dst[i] = int16_t((a[i] + b[i] + 1) >> 1);
}

}  // namespace simd
}  // namespace hevc
#endif  // __AVX2__
