// K1: fused dequant + inverse transform + residual-plane scatter.
//
// Replaces: libhm_tpu/recon_tpu.py _residual_fn (ops/transform.py
//   dequant_batch, dequant_batch_scaling, inverse_transform_batch,
//   inverse_transform_skip_batch, inverse_rdpcm_batch, and the bypass
//   branch) followed by libhm_tpu/parallel/batch_decode.py _scatter_tu_fn.
// What bounds it on the card: bytes.  Each TU reads n*n int16 coefficients
//   and writes n*n int32 residual samples; the arithmetic is at most 2*n
//   integer MACs per sample (two 1-D passes), far below the int32 ALU rate,
//   so the kernel moves ~6 bytes per sample and is limited by DRAM traffic
//   and, at 4x4, by the tiny 16-thread blocks.
// What the design does about it: one thread block per TU and one thread
//   per coefficient; the dequantized block and the stage-1 result live in
//   shared memory, the DCT/DST matrices in __constant__ memory, so every
//   sample is read once and written once straight into the stacked
//   [Bp, Hc, Wc] plane.  The TPU's int8-limb matmul split and the
//   pad-and-drop scatter are gone: entries with bsel >= Bp are skipped.
// Three entry points, one kernel template:
//   residual_scatter         flat dequant (Rec. 8.6.3, m = 16);
//   residual_scatter_scaled  scaling lists: the level's distinct matrices
//     are one small uint8 table [M, n, n] and each TU carries a one-byte
//     row index, instead of the JAX path's [P, n, n] int32 matrix per TU;
//   residual_bypass          transquant bypass: the coefficients are the
//     residual (no dequant, no transform).
// Each takes the per-TU RDPCM direction (NULL: none) and the bucket's
// transform-skip rotation flag (4x4 tskip/bypass TUs of intra CUs).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Rec. H.265 8.6.4.2 32-point DCT; the n-point matrix is rows 0, 32/n, ...
__constant__ int16_t kDct32[32][32] = {
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

__constant__ int16_t kDst4[4][4] = {
    {29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

__constant__ int kInvQuantScales[6] = {40, 45, 51, 57, 64, 72};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int tmat(int use_dst, int n, int k, int c) {
  return use_dst ? kDst4[k][c] : kDct32[k * (32 / n)][c];
}

enum Mode { kFlat = 0, kScaled = 1, kBypass = 2 };

template <int MODE>
__global__ void residual_kernel(
    const int16_t* __restrict__ coeffs, const int8_t* __restrict__ qp,
    const uint8_t* __restrict__ mats, const uint8_t* __restrict__ midx,
    const int8_t* __restrict__ rdpcm, const int32_t* __restrict__ bsel,
    const int32_t* __restrict__ ysel, const int32_t* __restrict__ xsel,
    int n, int log2n, int use_dst, int tskip, int rotate, int bd,
    int32_t* __restrict__ planes, int Bp, int H, int W) {
  const int k = blockIdx.x;
  const int b = bsel[k];
  if (b < 0 || b >= Bp) return;               // padding entry
  __shared__ int s_deq[32 * 32];
  __shared__ int s_st1[32 * 32];
  const int nn = n * n;
  const int t = threadIdx.x;                  // blockDim.x == n * n
  const int r = t / n, c = t % n;
  // rotation (Rec. 8.6.2): the block is read back to front
  const int src = rotate ? nn - 1 - t : t;
  int res;
  if (MODE == kBypass) {
    res = coeffs[(long long)k * nn + src];    // int16: already clipped
  } else {
    // dequant (Rec. 8.6.3, non-extended precision: max_dyn_range 15)
    const int q = qp[k];
    const int per = q / 6, rem = q % 6;
    const int tshift = 15 - bd - log2n;
    int right, tbits, scale;
    if (MODE == kScaled) {
      // m[x][y] from the table; + 4 = log2 of the neutral factor 16
      right = 6 - (tshift + per) + 4;
      tbits = min(16, 32 + right - 15);
      scale = (int)mats[(long long)midx[k] * nn + t] * kInvQuantScales[rem];
    } else {
      right = 6 - (tshift + per);
      tbits = min(16, 32 + right - 7);
      scale = kInvQuantScales[rem];
    }
    const int hi = (1 << (tbits - 1)) - 1, lo = -hi - 1;
    {
      const int cf = clip3(lo, hi, (int)coeffs[(long long)k * nn + t]);
      const int prod = cf * scale;
      // a negative int must not be shifted left: multiply by 1 << -right
      const int v = right > 0 ? (prod + (1 << (right - 1))) >> right
                              : prod * (1 << -right);
      s_deq[t] = clip3(-32768, 32767, v);
    }
    __syncthreads();

    if (tskip) {
      const int v = s_deq[src];
      int o;
      if (tshift >= 0) {
        const int off = tshift == 0 ? 0 : (1 << (tshift - 1));
        o = (v + off) >> tshift;
      } else {
        o = v * (1 << -tshift);
      }
      res = clip3(-32768, 32767, o);
    } else {
      // stage 1: S1 = T^T @ C, shift 7, clip to int16
      int s = 0;
      for (int i = 0; i < n; ++i) s += tmat(use_dst, n, i, r) * s_deq[i * n + c];
      s_st1[t] = clip3(-32768, 32767, (s + 64) >> 7);
      __syncthreads();
      // stage 2: S1 @ T, shift 20 - bd, clip to int16
      const int shift2 = 20 - bd;
      s = 0;
      for (int i = 0; i < n; ++i) s += s_st1[r * n + i] * tmat(use_dst, n, i, c);
      res = clip3(-32768, 32767, (s + (1 << (shift2 - 1))) >> shift2);
    }
  }
  // RDPCM (Rec. 8.6.8): a running sum along rows (1) or columns (2), the
  // direction uniform over the block, clipped to int16 at the end
  const int dir = rdpcm ? rdpcm[k] : 0;
  if (dir) {
    __syncthreads();                          // s_deq reads are done
    s_deq[t] = res;
    __syncthreads();
    int s = 0;
    if (dir == 1) {
      for (int i = 0; i <= c; ++i) s += s_deq[r * n + i];
    } else {
      for (int i = 0; i <= r; ++i) s += s_deq[i * n + c];
    }
    res = clip3(-32768, 32767, s);
  }
  const int y = ysel[k] + r, x = xsel[k] + c;
  if (y < H && x < W) planes[((long long)b * H + y) * W + x] = res;
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <int MODE>
int launch(const void* coeffs, const void* qp, const void* mats,
           const void* midx, const void* rdpcm, const void* bsel,
           const void* ysel, const void* xsel, int P, int n, int use_dst,
           int tskip, int rotate, int bd, void* planes, int Bp, int H, int W,
           void* stream) {
  residual_kernel<MODE><<<P, n * n, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coeffs, (const int8_t*)qp, (const uint8_t*)mats,
      (const uint8_t*)midx, (const int8_t*)rdpcm, (const int32_t*)bsel,
      (const int32_t*)ysel, (const int32_t*)xsel, n, log2_of(n), use_dst,
      tskip, rotate, bd, (int32_t*)planes, Bp, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int residual_scatter(const void* coeffs, const void* qp,
                                const void* rdpcm, const void* bsel,
                                const void* ysel, const void* xsel, int P,
                                int n, int use_dst, int tskip, int rotate,
                                int bd, void* planes, int Bp, int H, int W,
                                void* stream) {
  return launch<kFlat>(coeffs, qp, nullptr, nullptr, rdpcm, bsel, ysel, xsel,
                       P, n, use_dst, tskip, rotate, bd, planes, Bp, H, W,
                       stream);
}

extern "C" int residual_scatter_scaled(
    const void* coeffs, const void* qp, const void* mats, const void* midx,
    const void* rdpcm, const void* bsel, const void* ysel, const void* xsel,
    int P, int n, int use_dst, int tskip, int rotate, int bd, void* planes,
    int Bp, int H, int W, void* stream) {
  return launch<kScaled>(coeffs, qp, mats, midx, rdpcm, bsel, ysel, xsel, P,
                         n, use_dst, tskip, rotate, bd, planes, Bp, H, W,
                         stream);
}

extern "C" int residual_bypass(const void* coeffs, const void* rdpcm,
                               const void* bsel, const void* ysel,
                               const void* xsel, int P, int n, int rotate,
                               void* planes, int Bp, int H, int W,
                               void* stream) {
  return launch<kBypass>(coeffs, nullptr, nullptr, nullptr, rdpcm, bsel, ysel,
                         xsel, P, n, 0, 0, rotate, 8, planes, Bp, H, W,
                         stream);
}
