// K1: fused dequant + inverse transform + residual-plane scatter, one
// launch per (reference-DAG level, component) over a flat table of TUs.
//
// Replaces: libhm_tpu/recon_tpu.py _residual_fn (ops/transform.py
//   dequant_batch, dequant_batch_scaling, inverse_transform_batch,
//   inverse_transform_skip_batch, inverse_rdpcm_batch, and the bypass
//   branch) followed by libhm_tpu/parallel/batch_decode.py _scatter_tu_fn.
//   The JAX path runs one program per TU bucket (size, DST, path, bit
//   depth, rotation, scaling), a bucketing that only serves XLA's compile
//   cache; here one launch takes every TU of a component of a level.
// What bounds it on the card: bytes.  Each TU reads n*n int16 coefficients
//   and writes n*n int32 residual samples; the butterflies below need
//   ~0.4 n integer MACs a sample for each of the two 1-D passes, far below
//   the card's integer rate, so ~6 bytes a sample set the bound.
// What the design does about it:
//   - the table (ops/transform.py TU_DTYPE, 16 bytes a row) is sorted by
//     size, and each 256-thread CTA takes 1024 samples of one size: one
//     32x32 TU, 4 16x16, 16 8x8 or 64 4x4, so every CTA does equal work
//     and 4x4 TUs no longer run in half-empty warps;
//   - coefficients load as 16-byte vectors (8 int16 a thread) and the
//     residual leaves as 16-byte row stores, coalesced;
//   - the transform is HM's even/odd partial butterfly
//     (TComTrQuant.cpp partialButterflyInverse4..32), split so that each
//     thread computes 4 outputs of one line: outputs q, n/2-1-q, n/2+q and
//     n-1-q from O[q], O[n/2-1-q] (odd inputs), EO[q] (inputs 2 mod 4) and
//     EE[q] (inputs 0 mod 4), 1.5 n MACs for 4 outputs instead of 4 n.  It
//     only reassociates integer sums, so it is exact: in the int16 form
//     each pass's inputs are clipped to int16 (|v| <= 32768, |T| <= 90,
//     n <= 32 keep every partial sum below 2^27, an int accumulates them);
//     in the wide form (below) to +-2^22, and the sums, up to 2^33.5,
//     accumulate in 64 bits;
//   - the CTA's n-point matrix sits in shared memory, where a warp's reads
//     at distinct columns fall in distinct banks; the constant cache would
//     serialize them;
//   - the intermediate blocks live in shared memory with a row stride of
//     n + 1, so that a warp's column reads and row reads fall in distinct
//     banks.
// Row flags (one template for every mode): DST, transform skip, bypass
// (the coefficients are the residual), rotation (4x4 tskip/bypass TUs of
// intra CUs: the block is read back to front), scaled (scaling lists: the
// level's distinct matrices are one uint8 table [M, n, n] per size and the
// row holds its one-byte index), CCP (below).  Each row carries its RDPCM
// direction and bit depth.  Rows whose picture index is outside [0, Bp)
// are skipped, and samples outside the H x W plane are not written.
//
// Cross-component prediction, an epilogue of the chroma launch.
// Replaces: libhm_tpu/parallel/batch_decode.py _ccp_fn (lines 164-178), run
//   after every TU of the level is scattered (lines 239-260): for each 4:4:4
//   chroma TU with an alpha, res_c = clip16(res_c + ((alpha * rY) >> 3))
//   with the shift on the signed product, where rY is the luma residual
//   scaled as H.265 8.6.6 says, (res_l << BitDepthC) >> BitDepthY: here
//   res_l << (bdc - bdy), or res_l >> (bdy - bdc) (arithmetic), with the two
//   depths launch parameters, so no 16-bit shift overflows int32.  At equal
//   depths that is res_l, as the JAX package's _ccp_fn uses it; the JAX
//   package omits the scale, and so is wrong at unequal depths (ROADMAP C4).
// What bounds it: bytes.  A pass of its own reads the chroma residual that
//   this kernel has just stored, reads the luma residual and stores the
//   chroma residual again: 12 bytes a CCP sample, one more launch and one
//   more table upload per component and level.  Here an F_CCP row (alpha in
//   bits 4-7 of its rdpcm byte: log2|alpha| + 1, and the sign in bit 7)
//   loads the luma residual at its own (b, y, x), a 16-byte load beside the
//   16-byte store, and adds the term to the 4 values still in registers:
//   4 extra bytes a CCP sample, no extra launch.  The luma residual is
//   final because the luma launch precedes the chroma ones on the stream.
//   Rows without the flag do not touch res_l, which is NULL for luma.
//
// Extended precision (RExt extended_precision_processing_flag), the wide
// form.  Replaces: libhm_tpu/recon_tpu.py _residual_fn built with
//   max_dyn = max(15, bd + 6) (libhm_tpu/parallel/batch_decode.py:73-74),
//   i.e. ops/transform.py dequant_batch, dequant_batch_scaling,
//   inverse_transform_batch and inverse_transform_skip_batch at a dynamic
//   range of 16-22 bits.  An F_EXT row (flag 64) computes H.265 8.6.2-8.6.4
//   at max_dyn_range M = max(15, bd + 6): the dequantized values and the
//   stage-1 output are clipped to [-2^M, 2^M - 1] (not to int16), stage 2
//   shifts by max(20 - bd, 11), transform skip by max(M - bd - log2n, 0)
//   (HM's xITransformSkip under the flag), and the stage-2 output, RDPCM and
//   CCP are not clipped, as H.265 has no clip there (the JAX package clips
//   to int16: ROADMAP C12).  Its dequant clips the coefficient to
//   [-2^M, 2^M - 1], the input clip of HM's xDeQuant in the build that
//   decodes extended precision (RExt__HIGH_BIT_DEPTH_SUPPORT, a 64-bit
//   Intermediate_Int, where min(M + 1, 64 + right - 15) is M + 1); a
//   conforming stream's levels lie in that range already.  The product of a
//   coefficient, a scaling factor (<= 255) and a level scale (<= 72) reaches
//   2^36, so it is formed in 64 bits.
// What bounds it: bytes, as the int16 form, at 4-byte coefficients: 8
//   bytes a sample.  A table with an F_EXT row carries int32 coefficients
//   for every row, and the C entry takes `wide`: the kernel is a template
//   on the coefficient type and the accumulator, int16/int and
//   int32/long long.  The wide form loads its 8 coefficients a thread as
//   two 16-byte vectors, keeps the clipped values as int in the same
//   shared buffers, and sums both passes in 64 bits; rows without F_EXT in
//   a wide table keep the int16 form's clips (M = 15).  Every wide-only
//   step is `if constexpr`, so the int16 form computes what it did.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Rec. H.265 8.6.4.2 32-point DCT; the n-point matrix is rows 0, 32/n, ...
__device__ const int16_t kDct32[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4, -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90, -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13, 13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89, 89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22, -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87, -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31, 31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38, -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80, -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46, 46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75, 75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54, -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70, -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61, 61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67, -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57, -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73, 73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50, 50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78, -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43, -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82, 82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85, -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25, -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88, 88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18, 18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90, -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9, -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90, 90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4},
};

__device__ const int16_t kDst4[4][4] = {
    {29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

__device__ const int kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

// one row of the TU table (ops/transform.py TU_DTYPE)
struct TuRow {
  uint32_t off;        // first coefficient of the TU in the packed buffer
  int16_t b;           // picture
  uint16_t y, x;       // sample origin in the component plane
  uint8_t log2n;
  int8_t qp;           // incl. the bit-depth offset
  uint8_t flags;       // kDst | kTskip | kBypass | kRotate | kScaled | kCcp
                       // | kExt
  uint8_t rdpcm;       // bits 0-1: 0 off, 1 horizontal, 2 vertical;
                       // kCcp rows: bits 4-6 log2|alpha| + 1, bit 7 sign
  uint8_t midx;        // row of the scaling-matrix table
  uint8_t bd;
};
static_assert(sizeof(TuRow) == 16, "TU_DTYPE is 16 bytes");

enum { kDst = 1, kTskip = 2, kBypass = 4, kRotate = 8, kScaled = 16,
       kCcp = 32, kExt = 64 };

constexpr int kThreads = 256;
constexpr int kBuf = 64 * 4 * 5;              // 64 4x4 TUs, stride n + 1

struct Mats {
  const uint8_t* m[4];                        // [M, n, n] for n = 4 .. 32
};

struct Counts {
  int n[4];                                   // rows of each size
};

template <typename T>
__device__ __forceinline__ T clip3(T lo, T hi, T v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip16(int v) {
  return clip3(-32768, 32767, v);
}

// Outputs q, n/2-1-q, n/2+q, n-1-q of one line of the N-point inverse DCT
// out[k] = sum_i T[i][k] src[i]; t holds T[i][k] for k < N/2 as t[i][N/2].
template <int N, typename Acc>
__device__ __forceinline__ void idct_line(const int* src, int stride,
                                          const int* t, int q, Acc out[4]) {
  constexpr int H = N / 2;
  const int qb = H - 1 - q;
  Acc oa = 0, ob = 0, eo = 0, ee = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Acc v = src[i * stride];
    if (i & 1) {
      oa += t[i * H + q] * v;
      ob += t[i * H + qb] * v;
    } else if (i & 2) {
      eo += t[i * H + q] * v;
    } else {
      ee += t[i * H + q] * v;
    }
  }
  const Acc ea = ee + eo, eb = ee - eo;
  out[0] = ea + oa;
  out[1] = eb + ob;
  out[2] = eb - ob;
  out[3] = ea - oa;
}

// the four output indices of idct_line, in its out[] order
__device__ __forceinline__ int out_index(int n, int q, int j) {
  return j == 0 ? q : j == 1 ? n / 2 - 1 - q : j == 2 ? n / 2 + q : n - 1 - q;
}

// one line (4 outputs) of the 4-point inverse DST: d holds DST[i][k]
template <typename Acc>
__device__ __forceinline__ void idst_line(const int* src, int stride,
                                          const int* d, Acc out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Acc s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += d[i * 4 + k] * (Acc)src[i * stride];
    out[k] = s;
  }
}

// one pass (columns: stage 1, or rows: stage 2) of one line of a TU:
// reads the line from `in` (stride along it `step`), writes the 4 outputs,
// rounded by `shift` and clipped to [lo, hi], into `out` at the same stride
template <typename Acc>
__device__ __forceinline__ void transform_line(int log2n, bool dst,
                                               const int* in, int* out,
                                               int step, const int* t,
                                               int q, int shift, int lo,
                                               int hi) {
  Acc v[4];
  const int n = 1 << log2n;
  switch (log2n) {
    case 2:
      if (dst) idst_line<Acc>(in, step, t + 8, v);
      else idct_line<4, Acc>(in, step, t, q, v);
      break;
    case 3: idct_line<8, Acc>(in, step, t, q, v); break;
    case 4: idct_line<16, Acc>(in, step, t, q, v); break;
    default: idct_line<32, Acc>(in, step, t, q, v); break;
  }
  const Acc rnd = (Acc)1 << (shift - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = dst ? j : out_index(n, q, j);
    out[k * step] = (int)clip3<Acc>(lo, hi, (v[j] + rnd) >> shift);
  }
}

// C: the coefficient type (int16_t, or int32_t for tables with F_EXT rows);
// Acc: the butterflies' accumulator (int, or long long)
template <typename C, typename Acc>
__global__ void __launch_bounds__(kThreads)
residual_table_kernel(const TuRow* __restrict__ rows,
                      const C* __restrict__ coeffs, Mats mats,
                      Counts counts, int32_t* __restrict__ planes,
                      const int32_t* __restrict__ res_l, int Bp, int H,
                      int W, int bdy, int bdc) {
  constexpr bool kWide = sizeof(C) == 4;
  __shared__ int s_a[kBuf];
  __shared__ int s_b[kBuf];
  __shared__ int s_t[32 * 16 + 16];
  __shared__ TuRow s_row[64];

  // the size segment of this CTA: rows are sorted 4x4, 8x8, 16x16, 32x32
  int s = 0, cta0 = 0, row0 = 0;
  for (; s < 3; ++s) {
    const int per = 64 >> (2 * s);
    const int ctas = (counts.n[s] + per - 1) / per;
    if ((int)blockIdx.x < cta0 + ctas) break;
    cta0 += ctas;
    row0 += counts.n[s];
  }
  const int log2n = s + 2, n = 1 << log2n, nn = n * n, ps = n + 1;
  const int per = 64 >> (2 * s);              // TUs in this CTA
  const int first = row0 + ((int)blockIdx.x - cta0) * per;
  const int ntu = min(per, row0 + counts.n[s] - first);
  const int t = threadIdx.x;
  // this CTA's rows and its n-point matrix (and the DST) into shared memory
  if (t < ntu) s_row[t] = rows[first + t];
  for (int e = t; e < n * (n / 2); e += kThreads)
    s_t[e] = kDct32[(e / (n / 2)) * (32 / n)][e % (n / 2)];
  if (n == 4 && t < 16) s_t[8 + t] = kDst4[t / 4][t % 4];
  __syncthreads();

  const int tpt = nn / 4;                     // threads per TU
  const int j = t / tpt, tt = t % tpt;        // TU in the CTA, thread in it
  const bool live = j < ntu && s_row[j].b >= 0 && s_row[j].b < Bp;
  const TuRow r = s_row[min(j, ntu - 1)];
  const int base = j * n * ps;
  const bool skip = r.flags & (kTskip | kBypass);
  // the row's dynamic range M (15, or max(15, bd + 6) for F_EXT rows) and
  // the clip of stage 2, transform skip, bypass, RDPCM and CCP: int16, or
  // none for F_EXT rows
  bool ext = false;
  int mdr = 15;
  if constexpr (kWide) {
    ext = r.flags & kExt;
    if (ext) mdr = max(15, r.bd + 6);
  }
  const int lo1 = -(1 << mdr), hi1 = (1 << mdr) - 1;
  const int lo2 = ext ? INT_MIN : -32768, hi2 = ext ? INT_MAX : 32767;

  // 1. coefficients (16-byte loads, 8 a thread) -> dequantized, clipped to
  //    [-2^M, 2^M - 1], into s_a at row stride n + 1
  if (live && tt < nn / 8) {
    const int p0 = tt * 8;
    const C* src = coeffs + r.off + p0;
    alignas(16) C c[8];
    if (((uintptr_t)src & 15) == 0) {
#pragma unroll
      for (int h = 0; h < (int)sizeof(C) / 2; ++h)
        reinterpret_cast<int4*>(c)[h] =
            __ldg(reinterpret_cast<const int4*>(src) + h);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = src[k];
    }
    int right = 0, hi = 0, scale = 0;
    if (!(r.flags & kBypass)) {
      // dequant (Rec. 8.6.3 at max_dyn_range M)
      const int per6 = r.qp / 6, rem = r.qp % 6;
      const int tshift = mdr - r.bd - log2n;
      right = 6 - (tshift + per6) + ((r.flags & kScaled) ? 4 : 0);
      const int tbits = ext ? mdr + 1
          : min(mdr + 1, 32 + right - ((r.flags & kScaled) ? 15 : 7));
      hi = (1 << (tbits - 1)) - 1;
      scale = kInvQuantScales[rem];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = p0 + k;
      int v = c[k];
      if (!(r.flags & kBypass)) {
        const int m = (r.flags & kScaled)
                          ? (int)mats.m[s][(size_t)r.midx * nn + p] : 1;
        if constexpr (kWide) {
          const long long prod =
              (long long)clip3(-hi - 1, hi, v) * (scale * m);
          v = (int)clip3<long long>(
              lo1, hi1, right > 0 ? (prod + (1LL << (right - 1))) >> right
                                  : prod * (1LL << -right));
        } else {
          const int prod = clip3(-hi - 1, hi, v) * (scale * m);
          // a negative int must not be shifted left: multiply by 1 << -right
          v = clip16(right > 0 ? (prod + (1 << (right - 1))) >> right
                               : prod * (1 << -right));
        }
      } else if constexpr (kWide) {
        v = clip3(lo2, hi2, v);
      }
      s_a[base + (p >> log2n) * ps + (p & (n - 1))] = v;
    }
  }
  __syncthreads();

  // 2. columns (stage 1, shift 7, clipped to [-2^M, 2^M - 1]) into s_b;
  //    transform skip and bypass write their residual into s_b directly
  const int tpl = n / 4, line = tt / tpl, q = tt % tpl;
  if (live) {
    if (!skip) {
      transform_line<Acc>(log2n, r.flags & kDst, s_a + base + line,
                          s_b + base + line, ps, s_t, q, 7, lo1, hi1);
    } else {
      int tshift = mdr - r.bd - log2n;
      if constexpr (kWide) {
        if (ext) tshift = max(tshift, 0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tt * 4 + k;
        // rotation (Rec. 8.6.2): the block is read back to front
        const int sp = (r.flags & kRotate) ? nn - 1 - p : p;
        int v = s_a[base + (sp >> log2n) * ps + (sp & (n - 1))];
        if (r.flags & kTskip) {
          v = tshift >= 0 ? (v + (tshift ? 1 << (tshift - 1) : 0)) >> tshift
                          : v * (1 << -tshift);
          v = clip3(lo2, hi2, v);
        }
        s_b[base + (p >> log2n) * ps + (p & (n - 1))] = v;
      }
    }
  }
  __syncthreads();

  // 3. rows (stage 2, shift 5 + M - bd: 20 - bd, or max(20 - bd, 11))
  //    back into s_a
  if (live && !skip)
    transform_line<Acc>(log2n, r.flags & kDst, s_b + base + line * ps,
                        s_a + base + line * ps, 1, s_t, q, 5 + mdr - r.bd,
                        lo2, hi2);
  __syncthreads();

  // 4. RDPCM (Rec. 8.6.8: a running sum along rows (1) or columns (2),
  //    clipped to int16 outside F_EXT rows), CCP (Rec. 8.6.6) and 16-byte
  //    row stores into the plane
  if (!live) return;
  const int* res = skip ? s_b + base : s_a + base;
  const int p0 = tt * 4, ry = p0 >> log2n, rx = p0 & (n - 1);
  const int rd = r.rdpcm & 3;
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = res[ry * ps + rx + k];
  if (rd == 1) {
    int acc = 0;
    for (int i = 0; i < rx; ++i) acc += res[ry * ps + i];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = clip3(lo2, hi2, acc += v[k]);
  } else if (rd == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int acc = 0;
      for (int i = 0; i <= ry; ++i) acc += res[i * ps + rx + k];
      v[k] = clip3(lo2, hi2, acc);
    }
  }
  const int y = r.y + ry, x = r.x + rx;
  if (y >= H) return;
  const size_t o = ((size_t)r.b * H + y) * W + x;
  int32_t* dst = planes + o;
  const bool vec = x + 3 < W && ((uintptr_t)dst & 15) == 0;
  if (r.flags & kCcp) {
    const int code = (r.rdpcm >> 4) & 7;
    const int mag = code ? 1 << (code - 1) : 0;
    const int alpha = (r.rdpcm & 0x80) ? -mag : mag;
    const int32_t* src = res_l + o;
    int rl[4] = {0, 0, 0, 0};
    if (vec && ((uintptr_t)src & 15) == 0) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(src));
      rl[0] = q.x, rl[1] = q.y, rl[2] = q.z, rl[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < W) rl[k] = __ldg(src + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ry = bdc >= bdy ? rl[k] << (bdc - bdy) : rl[k] >> (bdy - bdc);
      v[k] = clip3(lo2, hi2, v[k] + ((alpha * ry) >> 3));
    }
  }
  if (vec) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x + k < W) dst[k] = v[k];
  }
}

}  // namespace

// rows: [N] TU_DTYPE sorted by size (counts c4 .. c32 rows of each);
// coeffs: the packed coefficients, int16, or int32 when `wide` (a table
// with F_EXT rows); m4 .. m32: the scaling-matrix tables per size (NULL
// where no row of that size is scaled); res_l: the luma residual planes of
// the planes' shape that kCcp rows read (NULL when no row has the flag);
// bdy, bdc: the luma and chroma bit depths that scale it (H.265 8.6.6).
extern "C" int residual_table(const void* rows, const void* coeffs,
                              const void* m4, const void* m8, const void* m16,
                              const void* m32, int c4, int c8, int c16,
                              int c32, void* planes, const void* res_l,
                              int Bp, int H, int W, int wide, int bdy,
                              int bdc, void* stream) {
  const Counts counts = {{c4, c8, c16, c32}};
  const Mats mats = {{(const uint8_t*)m4, (const uint8_t*)m8,
                      (const uint8_t*)m16, (const uint8_t*)m32}};
  long long ctas = 0;
  for (int s = 0; s < 4; ++s) {
    const int per = 64 >> (2 * s);
    if (counts.n[s] < 0) return (int)cudaErrorInvalidValue;
    ctas += (counts.n[s] + per - 1) / per;
  }
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (res_l && (bdy < 8 || bdy > 16 || bdc < 8 || bdc > 16))
    return (int)cudaErrorInvalidValue;
  if (wide)
    residual_table_kernel<int32_t, long long>
        <<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
            (const TuRow*)rows, (const int32_t*)coeffs, mats, counts,
            (int32_t*)planes, (const int32_t*)res_l, Bp, H, W, bdy, bdc);
  else
    residual_table_kernel<int16_t, int>
        <<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
            (const TuRow*)rows, (const int16_t*)coeffs, mats, counts,
            (int32_t*)planes, (const int32_t*)res_l, Bp, H, W, bdy, bdc);
  return (int)cudaGetLastError();
}
