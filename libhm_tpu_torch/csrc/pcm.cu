// K8: restore of unfiltered samples, and K9: PCM sample scatter.
//
// K8 restore_unfiltered replaces the restore branch of
//   libhm_tpu/parallel/device_filters.py _filter_fn (lines 191-201): after
//   deblocking and SAO, every sample whose 4x4 restore mask is set (PCM with
//   pcm_loop_filter_disabled, transquant bypass) takes back its pre-deblock
//   value.  The mask is read on the luma 4x4 grid at
//   (min((y << sy) >> 2, h4 - 1), min((x << sx) >> 2, w4 - 1)), over the whole
//   padded plane, exactly as the JAX index arithmetic reads it.
// What bounds it on the card: bytes: the mask once, and at masked samples
//   one pre-deblock sample read and one written.  A pass with a thread per
//   sample is bound instead by its thread count and index arithmetic: it
//   reads each 4x4 cell's byte 16 times (luma) and mostly does nothing.
// What the design does about it: a CTA of 32 x 8 threads per tile of 32 x 8
//   cells, a cell being the (4 >> sx) x (4 >> sy) samples of one mask entry
//   (4x4 luma; 2x2, 2x4 or 4x4 chroma at 4:2:0, 4:2:2, 4:4:4).  A thread
//   loads its cell's byte (one coalesced load per warp row), the CTA leaves
//   at once when no byte of the tile is set (__syncthreads_or), and a
//   thread whose byte is set copies its cell row by row, one 16-byte (4
//   samples) or 8-byte (2 samples) load and store a row when the planes are
//   aligned for it.  Cells past the mask grid take its last row or column,
//   so the bottom and right tiles cover the plane's padding as well.
//   In place, touching `pre` and `planes` only at masked samples.
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

constexpr int kTileX = 32, kTileY = 8;   // cells per CTA (one per thread)

template <typename V>
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src) {
  *(V*)dst = *(const V*)src;
}

__global__ void __launch_bounds__(kTileX * kTileY) restore_kernel(
    int32_t* __restrict__ planes, const int32_t* __restrict__ pre,
    const uint8_t* __restrict__ rmask, int Hp, int Wp, int h4, int w4,
    int sx, int sy, int vec) {
  const int cw = 4 >> sx, ch = 4 >> sy;            // samples per cell
  const int cx = blockIdx.x * kTileX + threadIdx.x;
  const int cy = blockIdx.y * kTileY + threadIdx.y;
  const int b = blockIdx.z;
  const int x0 = cx * cw, y0 = cy * ch;
  int m = 0;
  if (x0 < Wp && y0 < Hp)
    m = rmask[((long long)b * h4 + min(cy, h4 - 1)) * w4 + min(cx, w4 - 1)];
  if (!__syncthreads_or(m) || !m) return;
  const long long base = (long long)b * Hp * Wp;
  for (int r = 0; r < ch && y0 + r < Hp; ++r) {
    const long long o = base + (long long)(y0 + r) * Wp + x0;
    if (vec && cw == 4) {
      copy_row<int4>(planes + o, pre + o);
    } else if (vec) {
      copy_row<int2>(planes + o, pre + o);
    } else {
      for (int c = 0; c < cw && x0 + c < Wp; ++c) planes[o + c] = pre[o + c];
    }
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
  const int cw = 4 >> sx, ch = 4 >> sy;
  const int cols = (Wp + cw - 1) / cw, rows = (Hp + ch - 1) / ch;
  // whole rows of cw samples, each on a (4 * cw)-byte boundary
  const uintptr_t align = 4 * cw - 1;
  const int vec = Wp % cw == 0 && ((uintptr_t)planes & align) == 0 &&
                  ((uintptr_t)pre & align) == 0;
  const dim3 grid((cols + kTileX - 1) / kTileX, (rows + kTileY - 1) / kTileY,
                  B);
  restore_kernel<<<grid, dim3(kTileX, kTileY), 0, (cudaStream_t)stream>>>(
      (int32_t*)planes, (const int32_t*)pre, (const uint8_t*)rmask, Hp, Wp,
      h4, w4, sx, sy, vec);
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
