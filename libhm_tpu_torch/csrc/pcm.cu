// K8: restore of unfiltered samples, and K9: PCM sample scatter.
//
// K8 restore_unfiltered replaces the restore branch of
//   libhm_tpu/parallel/device_filters.py _filter_fn (lines 191-201): after
//   deblocking and SAO, every sample whose 4x4 restore mask is set (PCM with
//   pcm_loop_filter_disabled, transquant bypass) takes back its pre-deblock
//   value.  The mask is read on the luma 4x4 grid at
//   (min((y << sy) >> 2, h4 - 1), min((x << sx) >> 2, w4 - 1)), over the whole
//   padded plane, exactly as the JAX index arithmetic reads it.
// What bounds it on the card: bytes.  One mask byte per 4x4 (it stays in
//   L1/L2) and, where it is set, one pre-deblock sample read and one sample
//   written; ~8 integer operations per sample.  The design writes in place
//   and touches `pre` and `planes` only at masked samples, so a level with
//   few PCM/lossless CUs costs little more than the mask read; the JAX
//   formulation rewrites every sample of every plane (jnp.where).
//
// K9 pcm_scatter replaces the per-block device scatters of
//   libhm_tpu/parallel/dag_decode.py _recon_levels (lines 482-489): each PCM
//   block's samples, shifted left by (bit depth - PCM bit depth), written
//   into the zeroed stacked planes of the level before MC.
// What bounds it on the card: bytes (an int16 sample in, an int32 sample
//   out), and for the JAX loop the number of uploads and dispatches: one per
//   block.  Here the host packs a level's blocks of one component into one
//   table ([N, 6] int32 b, x, y, w, h, shift), one int16 sample buffer and
//   [N] int32 offsets, and one launch writes them all: a thread block per
//   PCM block, its threads striding over the block's samples.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void restore_kernel(int32_t* __restrict__ planes,
                               const int32_t* __restrict__ pre,
                               const uint8_t* __restrict__ rmask, int Hp,
                               int Wp, int h4, int w4, int sx, int sy) {
  // grid (columns / blockDim.x, rows, pictures): no 64-bit division
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Wp) return;
  const int y = blockIdx.y, b = blockIdx.z;
  const int y4 = min((y << sy) >> 2, h4 - 1);
  const int x4 = min((x << sx) >> 2, w4 - 1);
  if (rmask[((long long)b * h4 + y4) * w4 + x4]) {
    const long long i = ((long long)b * Hp + y) * Wp + x;
    planes[i] = pre[i];
  }
}

__global__ void pcm_kernel(int32_t* __restrict__ planes,
                           const int32_t* __restrict__ blocks,
                           const int16_t* __restrict__ samples,
                           const int32_t* __restrict__ offsets, int Bp, int H,
                           int W) {
  const int32_t* blk = blocks + (long long)blockIdx.x * 6;
  const int b = blk[0], x0 = blk[1], y0 = blk[2], w = blk[3], h = blk[4];
  const int shift = blk[5];
  if (b < 0 || b >= Bp) return;
  const int16_t* src = samples + offsets[blockIdx.x];
  for (int i = threadIdx.x; i < w * h; i += blockDim.x) {
    const int y = y0 + i / w, x = x0 + i % w;
    if (y >= 0 && y < H && x >= 0 && x < W)
      planes[((long long)b * H + y) * W + x] = (int)src[i] << shift;
  }
}

}  // namespace

extern "C" int restore_unfiltered(void* planes, const void* pre,
                                  const void* rmask, int B, int Hp, int Wp,
                                  int h4, int w4, int sx, int sy,
                                  void* stream) {
  if ((long long)B * Hp * Wp == 0) return 0;
  const int threads = 256;
  const dim3 grid((Wp + threads - 1) / threads, Hp, B);
  restore_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)planes, (const int32_t*)pre, (const uint8_t*)rmask, Hp, Wp,
      h4, w4, sx, sy);
  return (int)cudaGetLastError();
}

extern "C" int pcm_scatter(void* planes, const void* blocks,
                           const void* samples, const void* offsets, int N,
                           int Bp, int H, int W, void* stream) {
  if (N == 0) return 0;
  pcm_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)planes, (const int32_t*)blocks, (const int16_t*)samples,
      (const int32_t*)offsets, Bp, H, W);
  return (int)cudaGetLastError();
}
