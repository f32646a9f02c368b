// K2: the whole intra wavefront of one component, every picture of a
// reference-DAG level, as ONE persistent launch.
//
// Replaces: libhm_tpu/parallel/batch_decode.py _scan_fn_batched
//   (res_gather=True), i.e. the lax.scan over dependency levels of
//   intra_wavefront.unpack_block_meta -> ops/intra.py border_coords ->
//   substitute -> filter_refs -> predict -> + residual -> clip -> scatter,
//   and libhm_tpu/parallel/intra_wavefront.py _scan_fn (one picture).
// What bounds it on the card: the dependency chain, not bytes or ALU.  A
//   1080p luma wavefront is ~1700 levels of about a dozen blocks each; a
//   block touches 4n+1 border samples and n*n residual and output samples.
//   One launch per (level, size) cost ~40 us of host time each and left
//   the SMs idle between launches.  The least time is the chain depth
//   times one dependent round trip through L2 (acquire the level's
//   counter, gather the border, store, release).
// What the design does about it:
//   - the host sends a flat block table sorted by level (32 bytes a block,
//     real blocks only, all sizes mixed) and the block count of each level;
//   - a grid of at most (SMs x resident CTAs per SM) CTAs of 256 threads
//     takes blocks in table order from a global ticket counter, so blocks
//     are claimed level by level;
//   - before it gathers, the CTA of a level-l block waits until all
//     count[l - 1] blocks of level l - 1 have signalled done[l - 1]: one
//     thread spins with an acquire load at device scope and a __nanosleep
//     backoff of at most 128 ns (512 ns cost ~15% of the time), the rest
//     wait at the barrier.  Every block of a lower level already holds a
//     running CTA (tickets go out in level order) that waits only on still
//     lower levels, so this cannot deadlock, whatever the grid size; no
//     grid barrier, no cooperative launch;
//   - the table row and the block's residuals are loaded before the wait,
//     off the chain;
//   - the border is read past L1 (__ldcg): L1 is not coherent across SMs,
//     and a sample written by another SM earlier in this launch must come
//     from L2;
//   - after its store the CTA meets at a barrier, and one thread releases
//     (fence.acq_rel at device scope) and adds one to done[l].  Every ticketed block signals: there is no early
//     exit between the ticket and the signal;
//   - one block per CTA at a time, whatever its size (4..32): the widest
//     level holds a few dozen blocks and the grid holds hundreds of CTAs,
//     so packing several 4x4 blocks into one CTA would buy parallelism the
//     chain cannot use, at the cost of a second code path;
//   - the done counters sit 128 bytes apart, so CTAs spinning on different
//     levels poll different L2 lines.
//   Blocks of one level, of every size and picture, are independent by
//   construction (prepare_component levels all sizes on one map), so they
//   write the plane in place.  Unavailable border samples may be read
//   while a neighbour of the same level writes them; substitution never
//   uses them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kAng[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,
                             2,   0,   -2,  -5,  -9,  -13, -17, -21, -26,
                             -32, -26, -21, -17, -13, -9,  -5,  -2, 0,
                             2,   5,   9,   13,  17,  21,  26,  32};

__device__ __forceinline__ int inv_angle(int ang) {
  switch (ang) {
    case -2: return 4096;
    case -5: return 1638;
    case -9: return 910;
    case -13: return 630;
    case -17: return 482;
    case -21: return 390;
    case -26: return 315;
    default: return 256;  // -32
  }
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr int kThreads = 256;
constexpr int kMaxT = 4 * 32 + 1;
constexpr int kRes = 32 * 32 / kThreads;  // residuals held per thread
constexpr int kRec = 32;                  // bytes per table row
constexpr int kDoneStride = 32;           // ints between done counters
constexpr int kMaxPolls = 1 << 27;        // > 17 s of 128 ns sleeps

// One row of the block table (ops/intra.py BLOCK_DTYPE, little-endian):
// b int16 @0, x int16 @2, y int16 @4, mode int8 @6, log2n | flags << 4
// uint8 @7 (flags: 1 filt, 2 strong, 4 dbf), level int32 @8, av 17 bytes
// @12 (bit t of the 4n+1 border samples in scan order).

// Extended reference sample r of the angular predictor (Rec. 8.4.4.2.6):
// r >= 0 reads the main side, r < 0 projects onto the other side.
__device__ __forceinline__ int ang_ref(const int* v, int n, int vertical,
                                       int ang, int r) {
  if (r >= 0) return vertical ? v[2 * n + r] : v[2 * n - r];
  const int k = min((-r * inv_angle(ang) + 128) >> 8, 2 * n);
  return vertical ? v[2 * n - k] : v[2 * n + k];
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Release every prior write of the CTA (ordered before this thread by the
// barrier just before it), then add one: the arrive of CUTLASS's
// GenericBarrier.
__device__ __forceinline__ void add_release(int* p) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 [%0], 1;"
               :: "l"(p) : "memory");
}

__global__ void __launch_bounds__(kThreads) intra_wavefront_kernel(
    int32_t* plane, const int32_t* __restrict__ res,
    const uint8_t* __restrict__ table, const int* __restrict__ count,
    int* ticket, int* done, int N, int is_luma, int bd, int W, int H,
    int Hc, int Wc) {
  __shared__ int s_g[kMaxT];                        // gathered border
  __shared__ int s_src[kMaxT];                      // substitution source
  __shared__ int s_v[kMaxT];                        // substituted
  __shared__ int s_f[kMaxT];                        // filtered
  __shared__ uint8_t s_av[17];
  __shared__ int s_dc, s_t;
  const int tid = threadIdx.x;
  const int maxv = (1 << bd) - 1;

  for (;;) {
    if (tid == 0) s_t = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_t;                   // uniform over the CTA
    if (t >= N) return;

    // the table row and the residuals: off the dependency chain
    const uint8_t* row = table + (long long)t * kRec;
    const int b = *(const int16_t*)(row + 0);
    const int x0 = *(const int16_t*)(row + 2);
    const int y0 = *(const int16_t*)(row + 4);
    const int mode = *(const int8_t*)(row + 6);
    const int log2n = row[7] & 15, fl = row[7] >> 4;
    const int level = *(const int32_t*)(row + 8);
    if (tid < 17) s_av[tid] = row[12 + tid];
    const int n = 1 << log2n;
    const int T = 4 * n + 1;
    const long long pbase = (long long)b * Hc * Wc;
    int r[kRes];
#pragma unroll
    for (int k = 0; k < kRes; ++k) {
      const int p = tid + k * kThreads;
      const int yy = y0 + (p >> log2n), xx = x0 + (p & (n - 1));
      r[k] = (p < n * n && yy < Hc && xx < Wc)
                 ? res[pbase + (long long)yy * Wc + xx] : 0;
    }

    // wait for every block of the level below
    if (tid == 0 && level > 0) {
      const int* d = done + (long long)(level - 1) * kDoneStride;
      const int want = count[level - 1];
      unsigned ns = 32;
      for (int polls = 0; ld_acquire(d) < want; ++polls) {
        // a table whose counts disagree with its rows would wait forever:
        // fail the launch instead, after seconds
        if (polls == kMaxPolls) __trap();
        __nanosleep(ns);
        ns = ns < 128 ? 2 * ns : 128;
      }
    }
    __syncthreads();            // the acquire orders the CTA's reads below

    // 1. gather the 4n+1 border samples (clamped to the picture), from L2
    for (int i = tid; i < T; i += kThreads) {
      int ox, oy;
      if (i < 2 * n) { ox = -1; oy = 2 * n - 1 - i; }
      else if (i == 2 * n) { ox = -1; oy = -1; }
      else { ox = i - 2 * n - 1; oy = -1; }
      const int cx = clip3(0, W - 1, x0 + ox), cy = clip3(0, H - 1, y0 + oy);
      s_g[i] = __ldcg(plane + pbase + (long long)cy * Wc + cx);
    }
    __syncthreads();

    // 2. substitution (Rec. 8.4.4.2.2) in warp 0: running max of available
    //    positions; a leading gap takes the first available sample
    if (tid < 32) {
      int carry = -1, first = -1;
      for (int base = 0; base < T; base += 32) {
        const int i = base + tid;
        const int avail = i < T ? (s_av[i >> 3] >> (i & 7)) & 1 : 0;
        int idx = avail ? i : -1;
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, idx, off);
          if (tid >= off) idx = max(idx, o);
        }
        idx = max(idx, carry);
        const unsigned bal = __ballot_sync(0xffffffffu, avail);
        if (first < 0 && bal) first = base + __ffs(bal) - 1;
        carry = __shfl_sync(0xffffffffu, idx, 31);
        if (i < T) s_src[i] = idx;
      }
      __syncwarp();
      for (int i = tid; i < T; i += 32) {
        const int s = s_src[i];
        s_v[i] = first < 0 ? (1 << (bd - 1)) : s_g[s < 0 ? first : s];
      }
    }
    __syncthreads();

    // 3. [1 2 1] smoothing, or the strong bilinear filter (Rec. 8.4.4.2.3)
    const int filt = fl & 1, strong = (fl & 2) && n == 32, dbf = (fl & 4) != 0;
    int use_strong = 0;
    if (filt && strong) {
      const int c = s_v[2 * n], bl = s_v[0], tr = s_v[4 * n];
      const int thr = 1 << (bd - 5);
      use_strong = abs(c + tr - 2 * s_v[3 * n]) < thr &&
                   abs(c + bl - 2 * s_v[n]) < thr;
    }
    for (int i = tid; i < T; i += kThreads) {
      int v = s_v[i];
      if (filt) {
        if (use_strong) {
          const int c = s_v[2 * n];
          v = i <= 2 * n ? (i * c + (2 * n - i) * s_v[0] + n) >> 6
                         : ((4 * n - i) * c + (i - 2 * n) * s_v[4 * n] + n) >> 6;
        } else if (i > 0 && i < T - 1) {
          v = (s_v[i - 1] + 2 * v + s_v[i + 1] + 2) >> 2;
        }
      }
      s_f[i] = v;
    }
    __syncthreads();
    if (mode == 1 && tid == 0) {
      int s = n;
      for (int i = 0; i < n; ++i) s += s_f[2 * n + 1 + i] + s_f[2 * n - 1 - i];
      s_dc = s >> (log2n + 1);
    }
    __syncthreads();

    // 4. predict (Rec. 8.4.4.2.4-6), add the residual, clip, store
    const int* v = s_f;
    const int ang = kAng[mode];
    const int vertical = mode >= 18;
    const int edge = is_luma && n < 32;
#pragma unroll
    for (int k = 0; k < kRes; ++k) {
      const int p = tid + k * kThreads;
      if (p >= n * n) break;
      const int y = p >> log2n, x = p & (n - 1);
      int pred;
      if (mode == 0) {
        pred = ((n - 1 - x) * v[2 * n - 1 - y] + (x + 1) * v[3 * n + 1] +
                (n - 1 - y) * v[2 * n + 1 + x] + (y + 1) * v[n - 1] + n) >>
               (log2n + 1);
      } else if (mode == 1) {
        const int dc = s_dc;
        pred = dc;
        if (edge) {
          if (x == 0 && y == 0)
            pred = (v[2 * n - 1] + 2 * dc + v[2 * n + 1] + 2) >> 2;
          else if (y == 0)
            pred = (v[2 * n + 1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            pred = (v[2 * n - 1 - y] + 3 * dc + 2) >> 2;
        }
      } else {
        const int j = vertical ? y : x;    // row along the main direction
        const int i = vertical ? x : y;    // position within that row
        const int pos = (j + 1) * ang;
        const int f = pos & 31;
        const int ri = i + (pos >> 5) + 1;
        const int a = ang_ref(v, n, vertical, ang, ri);
        const int bb = f ? ang_ref(v, n, vertical, ang, ri + 1) : 0;
        pred = ((32 - f) * a + f * bb + 16) >> 5;
        if (edge && !dbf) {
          if (mode == 26 && x == 0)
            pred = clip3(0, maxv,
                         v[2 * n + 1] + ((v[2 * n - 1 - y] - v[2 * n]) >> 1));
          else if (mode == 10 && y == 0)
            pred = clip3(0, maxv,
                         v[2 * n - 1] + ((v[2 * n + 1 + x] - v[2 * n]) >> 1));
        }
      }
      const int yy = y0 + y, xx = x0 + x;
      if (yy < Hc && xx < Wc)
        plane[pbase + (long long)yy * Wc + xx] = clip3(0, maxv, pred + r[k]);
    }

    // 5. signal: every store of the CTA, then one release and one add
    __syncthreads();
    if (tid == 0) add_release(done + (long long)level * kDoneStride);
  }
}

}  // namespace

// The CTAs the grid holds when `ctas` <= 0: SMs x resident CTAs per SM.
extern "C" int intra_wavefront(void* plane, const void* res,
                               const void* table, const void* count,
                               void* sync, int N, int ctas, int is_luma,
                               int bd, int W, int H, int Hc, int Wc,
                               void* stream) {
  if (N == 0) return 0;
  if (ctas <= 0) {
    static int full = 0;
    if (full == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, intra_wavefront_kernel, kThreads, 0);
      if (e != cudaSuccess) return (int)e;
      full = sms * per_sm;
    }
    ctas = full;
  }
  const int grid = ctas < N ? ctas : N;
  int* s = (int*)sync;               // ticket at 0, done[l] at (l + 1) * 32
  intra_wavefront_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)plane, (const int32_t*)res, (const uint8_t*)table,
      (const int*)count, s, s + kDoneStride, N, is_luma, bd, W, H, Hc, Wc);
  return (int)cudaGetLastError();
}
