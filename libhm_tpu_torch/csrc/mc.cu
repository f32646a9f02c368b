// K5 mc_grid and K6 mc_weighted: motion-compensated prediction + residual.
//
// Replaces: K5 libhm_tpu/parallel/dag_decode.py _mc_phase_grid_fn (phase
//   planes of ops/interp.py phase_planes, one mc_phase_gather per sample,
//   the uni/bi epilogue, + residual, only where the 4x4's direction is > 0);
//   K6 libhm_tpu/parallel/dag_decode.py _mc_scatter_fn (ops/interp.py
//   mc_blocks per 4x4 block, the plain or the weighted_uni / weighted_bi
//   epilogue, + residual, scattered into the planes).
// What bounds it on the card: bytes.  A level reads B residual planes and
//   R reference planes and writes B planes, all int32; the arithmetic (at
//   most 2 x 72 multiply-adds a luma sample) is far below the card's integer
//   rate.  The taps re-read neighbouring reference samples many times, and
//   those reads hit L1/L2, not DRAM.
// What the design does about it: one thread per output sample, neighbouring
//   threads on neighbouring samples, so the residual read and the output
//   write are coalesced and the reference taps of a warp overlap in cache
//   (read through the read-only path, __ldg).  Each prediction is computed
//   directly from the reference plane with each tap's coordinate clamped
//   into the picture, which is what the TPU's phase planes and their apron
//   give, without building them: no R x 16 phase planes in device memory.
//   Only the lists that the sample's direction uses are computed.  Samples
//   that are not inter are left untouched (the planes are updated in place).
//   Staging each 4x4's window in shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIfPrec = 14;
constexpr int kIfOffs = 1 << (kIfPrec - 1);

__constant__ int kLumaFilter[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

__constant__ int kChromaFilter[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 14-bit (is_last=False) prediction of one list at sample (y, x) of an
// H x W reference plane: the copy / h only / v only / h then v cases of
// ops/interp.py mc_blocks with their shifts and offsets.
template <int TAPS>
__device__ int predict(const int32_t* __restrict__ ref, int H, int W, int y,
                       int x, int mvx, int mvy, int fbx, int fby,
                       int headroom) {
  constexpr int half = TAPS / 2 - 1;
  int fx = mvx & ((1 << fbx) - 1);
  int fy = mvy & ((1 << fby) - 1);
  const int iy = y + (mvy >> fby);
  const int ix = x + (mvx >> fbx);
  int cx[TAPS], cy[TAPS], xs[TAPS];
  if constexpr (TAPS == 8) {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      cx[k] = kLumaFilter[fx][k];
      cy[k] = kLumaFilter[fy][k];
    }
  } else {
    // the chroma table is eighth-pel (TComInterpolationFilter.cpp:346)
    fx <<= 3 - fbx;
    fy <<= 3 - fby;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      cx[k] = kChromaFilter[fx][k];
      cy[k] = kChromaFilter[fy][k];
    }
  }
#pragma unroll
  for (int k = 0; k < TAPS; ++k) xs[k] = clampi(ix + k - half, 0, W - 1);
  const int s1 = 6 - headroom;
  const int o1 = -(kIfOffs << s1);
  if (fx == 0 && fy == 0)
    return (__ldg(ref + (long long)clampi(iy, 0, H - 1) * W + xs[half])
            << headroom) - kIfOffs;
  if (fy == 0) {
    const int32_t* row = ref + (long long)clampi(iy, 0, H - 1) * W;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) acc += cx[k] * __ldg(row + xs[k]);
    return (acc + o1) >> s1;
  }
  if (fx == 0) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
      acc += cy[k] *
             __ldg(ref + (long long)clampi(iy + k - half, 0, H - 1) * W + xs[half]);
    return (acc + o1) >> s1;
  }
  int acc2 = 0;
#pragma unroll
  for (int r = 0; r < TAPS; ++r) {
    const int32_t* row = ref + (long long)clampi(iy + r - half, 0, H - 1) * W;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) acc += cx[k] * __ldg(row + xs[k]);
    acc2 += cy[r] * ((acc + o1) >> s1);
  }
  return acc2 >> 6;
}

__device__ __forceinline__ int uni_round(int p, int headroom, int maxs) {
  return clampi((p + kIfOffs + (1 << (headroom - 1))) >> headroom, 0, maxs);
}

__device__ __forceinline__ int bi_average(int p0, int p1, int bd, int maxs) {
  const int shift = kIfPrec + 1 - bd;
  return clampi((p0 + p1 + (1 << (shift - 1)) + 2 * kIfOffs) >> shift, 0,
                maxs);
}

template <int TAPS>
__global__ void mc_grid_kernel(int32_t* __restrict__ stacked,
                               const int32_t* __restrict__ res,
                               const int32_t* __restrict__ refs,
                               const int16_t* __restrict__ mv,
                               const int8_t* __restrict__ dir,
                               const int16_t* __restrict__ sel, int B, int Hp,
                               int Wp, int R, int H, int W, int h4, int w4,
                               int sx, int sy, int fbx, int fby, int bd) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * Hp * Wp) return;
  const int x = (int)(gid % Wp);
  const int y = (int)((gid / Wp) % Hp);
  const int b = (int)(gid / ((long long)Hp * Wp));
  // padding rows/cols beyond the component size never code inter
  if (y >= H || x >= W) return;
  const int cy = min((y << sy) >> 2, h4 - 1);
  const int cx = min((x << sx) >> 2, w4 - 1);
  const long long cell = ((long long)b * h4 + cy) * w4 + cx;
  const int d = dir[cell];
  if (d <= 0) return;
  const int headroom = max(2, kIfPrec - bd);
  const int maxs = (1 << bd) - 1;
  const long long plane = (long long)H * W;
  int p[2] = {0, 0};
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (d & (1 << l)) {
      // an index past the stack is clamped, as the JAX gather clamps it
      const int r = clampi(sel[cell * 2 + l], 0, R - 1);
      const int16_t* m = mv + cell * 4 + l * 2;
      p[l] = predict<TAPS>(refs + r * plane, H, W, y, x, m[0], m[1], fbx, fby,
                           headroom);
    }
  }
  const int pred = d == 3 ? bi_average(p[0], p[1], bd, maxs)
                          : uni_round(d == 1 ? p[0] : p[1], headroom, maxs);
  stacked[gid] = clampi(pred + res[gid], 0, maxs);
}

// one row of the block table (ops/interp.py BLK_FIELDS)
enum { kB, kX, kY, kDir, kMv0x, kMv0y, kMv1x, kMv1y, kSel0, kSel1, kW0, kW1,
       kO0, kO1, kFields };

template <int TAPS>
__global__ void mc_weighted_kernel(int32_t* __restrict__ stacked,
                                   const int32_t* __restrict__ res,
                                   const int32_t* __restrict__ refs,
                                   const int32_t* __restrict__ blk, int N,
                                   int B, int Hp, int Wp, int R, int H, int W,
                                   int fbx, int fby, int blkw, int blkh,
                                   int bd, int wp, int denom) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = blkw * blkh;
  if (gid >= (long long)N * per) return;
  const int32_t* q = blk + (gid / per) * kFields;
  const int rem = (int)(gid % per);
  const int b = q[kB];
  const int y = q[kY] + rem / blkw;
  const int x = q[kX] + rem % blkw;
  // blocks past the plane are dropped, as the JAX scatter's mode="drop"
  if (b < 0 || b >= B || y < 0 || y >= Hp || x < 0 || x >= Wp) return;
  const int d = q[kDir];
  const int headroom = max(2, kIfPrec - bd);
  const int maxs = (1 << bd) - 1;
  const long long plane = (long long)H * W;
  int p[2] = {0, 0};
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (d == 3 || d == l + 1) {
      const int r = clampi(q[kSel0 + l], 0, R - 1);
      p[l] = predict<TAPS>(refs + r * plane, H, W, y, x, q[kMv0x + 2 * l],
                           q[kMv0y + 2 * l], fbx, fby, headroom);
    }
  }
  int pred;
  if (!wp) {
    pred = d == 3 ? bi_average(p[0], p[1], bd, maxs)
                  : uni_round(d == 1 ? p[0] : p[1], headroom, maxs);
  } else if (d == 3) {
    // ops/interp.py weighted_bi
    const int shift = denom + 1 + headroom;
    const int v = (q[kW0] * (p[0] + kIfOffs) + q[kW1] * (p[1] + kIfOffs) +
                   (1 << (shift - 1)) + (q[kO0] + q[kO1]) * (1 << (shift - 1)))
                  >> shift;
    pred = clampi(v, 0, maxs);
  } else {
    // ops/interp.py weighted_uni
    const int l = d == 1 ? 0 : 1;
    const int shift = denom + headroom;
    const int v = ((q[kW0 + l] * (p[l] + kIfOffs) + (1 << (shift - 1))) >> shift)
                  + q[kO0 + l];
    pred = clampi(v, 0, maxs);
  }
  const long long o = ((long long)b * Hp + y) * Wp + x;
  stacked[o] = clampi(pred + res[o], 0, maxs);
}

}  // namespace

extern "C" int mc_grid(void* stacked, const void* res, const void* refs,
                       const void* mv, const void* dir, const void* sel, int B,
                       int Hp, int Wp, int R, int H, int W, int h4, int w4,
                       int sx, int sy, int taps, int fbx, int fby, int bd,
                       void* stream) {
  const long long n = (long long)B * Hp * Wp;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto s = (cudaStream_t)stream;
  if (taps == 8)
    mc_grid_kernel<8><<<blocks, threads, 0, s>>>(
        (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
        (const int16_t*)mv, (const int8_t*)dir, (const int16_t*)sel, B, Hp, Wp,
        R, H, W, h4, w4, sx, sy, fbx, fby, bd);
  else if (taps == 4)
    mc_grid_kernel<4><<<blocks, threads, 0, s>>>(
        (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
        (const int16_t*)mv, (const int8_t*)dir, (const int16_t*)sel, B, Hp, Wp,
        R, H, W, h4, w4, sx, sy, fbx, fby, bd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int mc_weighted(void* stacked, const void* res, const void* refs,
                           const void* blk, int N, int B, int Hp, int Wp,
                           int R, int H, int W, int taps, int fbx, int fby,
                           int bd, int wp, int denom, void* stream) {
  const int blkw = 4 >> (fbx - 2), blkh = 4 >> (fby - 2);
  const long long n = (long long)N * blkw * blkh;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto s = (cudaStream_t)stream;
  if (taps == 8)
    mc_weighted_kernel<8><<<blocks, threads, 0, s>>>(
        (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
        (const int32_t*)blk, N, B, Hp, Wp, R, H, W, fbx, fby, blkw, blkh, bd,
        wp, denom);
  else if (taps == 4)
    mc_weighted_kernel<4><<<blocks, threads, 0, s>>>(
        (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
        (const int32_t*)blk, N, B, Hp, Wp, R, H, W, fbx, fby, blkw, blkh, bd,
        wp, denom);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
