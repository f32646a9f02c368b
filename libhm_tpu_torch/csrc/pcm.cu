// K8: restore of unfiltered samples, and K9: PCM samples of a level.
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
// K9 pcm_level replaces the per-block device scatters of
//   libhm_tpu/parallel/dag_decode.py _recon_levels (lines 482-489): each PCM
//   block's samples, shifted left by (bit depth - PCM bit depth), written
//   into the zeroed stacked planes of the level before MC.
// What bounds it on the card: bytes (a uint16 sample in, an int32 sample
//   out: under a microsecond for a 1080p level), so the launches, uploads
//   and their enqueue set its time: the JAX loop makes one upload and one
//   dispatch per block.
// What the design does about it: one launch per DAG level for every
//   component.  The host packs the level's blocks into ONE upload: 16-byte
//   rows (ops/pcm.py PCM_DTYPE: sample offset, picture, x, y, component,
//   log2 w, log2 h, shift) sorted by block area, then the uint16 samples in
//   row order (each block's at a multiple of 16 samples, the part on a
//   16-byte boundary).  The up-to-three planes' pointers, heights and widths
//   and the rows of each area class travel as a __grid_constant__ kernel
//   parameter, packed by the host (PcmArgs).  Each 256-thread CTA
//   takes 1024 samples of one area class (64 4x4 blocks ... one 32x32; the
//   4:2:2 chroma blocks w x 2w are classes of their own), so every warp is
//   full; a thread takes 4 consecutive samples of one block row: one 8-byte
//   uint16x4 load (zero-extended), the shift, one 16-byte int32 store
//   where the row and the plane allow it, else scalar stores.  w and h are
//   powers of two (4-32), so the addressing is shifts and masks.  Rows
//   whose picture is outside [0, Bp) or whose component has no plane are
//   skipped, and samples past the plane are dropped.
#include <cstdint>
#include <cstring>
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

// one row of the PCM block table (ops/pcm.py PCM_DTYPE)
struct PcmRow {
  uint32_t off;        // first sample of the block in the sample part
  int16_t b;           // picture
  uint16_t x, y;       // sample origin in the component plane
  uint8_t comp, log2w, log2h, shift;
  uint16_t pad;
};
static_assert(sizeof(PcmRow) == 16, "PCM_DTYPE is 16 bytes");

constexpr int kPcmThreads = 256;
constexpr int kClasses = 7;              // block areas 16 .. 1024 samples

// packed by the host (ops/pcm.py _ARGS): the planes, their heights and
// widths (zero past `nplanes`), the rows of each area class
struct PcmArgs {
  int32_t* p[3];
  int H[3], W[3], n[kClasses];
};
static_assert(sizeof(PcmArgs) == 80, "ops/pcm.py _ARGS is 80 bytes");

__global__ void __launch_bounds__(kPcmThreads)
pcm_level_kernel(const PcmRow* __restrict__ rows,
                 const uint16_t* __restrict__ samples,
                 const __grid_constant__ PcmArgs q, int nplanes, int Bp) {
  // the area class of this CTA: rows are sorted by log2(w * h) = 4 .. 10,
  // 64 >> s blocks of 4 << s threads each a CTA
  int s = 0, cta0 = 0, row0 = 0;
  for (; s < kClasses - 1; ++s) {
    const int ctas = (q.n[s] + (64 >> s) - 1) >> (6 - s);
    if ((int)blockIdx.x < cta0 + ctas) break;
    cta0 += ctas;
    row0 += q.n[s];
  }
  const int t = threadIdx.x, lt = s + 2;           // log2 threads a block
  const int j = row0 + (((int)blockIdx.x - cta0) << (6 - s)) + (t >> lt);
  if (j >= row0 + q.n[s]) return;
  const PcmRow r = rows[j];
  if (r.b < 0 || r.b >= Bp || r.comp >= nplanes) return;
  const int p0 = (t & ((1 << lt) - 1)) << 2;       // first of 4 samples
  const int y = r.y + (p0 >> r.log2w);
  const int x = r.x + (p0 & ((1 << r.log2w) - 1));
  const int H = q.H[r.comp], W = q.W[r.comp];
  if (y >= H) return;
  // samples are unsigned (up to 16 bits): zero-extended
  const uint2 raw =
      __ldg(reinterpret_cast<const uint2*>(samples + r.off + p0));
  const int v[4] = {(int)(raw.x & 0xFFFF) << r.shift,
                    (int)(raw.x >> 16) << r.shift,
                    (int)(raw.y & 0xFFFF) << r.shift,
                    (int)(raw.y >> 16) << r.shift};
  int32_t* dst = q.p[r.comp] + ((size_t)r.b * H + y) * W + x;
  if (x + 3 < W && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x + k < W) dst[k] = v[k];
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

// rows: [N] PCM_DTYPE sorted by area (a.n[7] rows of each class,
// log2(w * h) = 4 .. 10); samples: the uint16 samples, 8-byte aligned;
// args: a PcmArgs, the first `nplanes` planes set.
extern "C" int pcm_level(const void* rows, const void* samples,
                         const void* args, int nplanes, int Bp,
                         void* stream) {
  if (nplanes < 1 || nplanes > 3) return (int)cudaErrorInvalidValue;
  PcmArgs a;
  memcpy(&a, args, sizeof a);             // a Python bytes object
  long long ctas = 0;
  for (int s = 0; s < kClasses; ++s) {
    if (a.n[s] < 0) return (int)cudaErrorInvalidValue;
    ctas += (a.n[s] + (64 >> s) - 1) >> (6 - s);
  }
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pcm_level_kernel<<<(unsigned)ctas, kPcmThreads, 0, (cudaStream_t)stream>>>(
      (const PcmRow*)rows, (const uint16_t*)samples, a, nplanes, Bp);
  return (int)cudaGetLastError();
}
