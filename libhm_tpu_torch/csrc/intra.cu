// K2: the whole intra wavefront of every component of every picture of a
// reference-DAG level, as ONE persistent launch: one CTA per CTU row.
//
// Replaces: libhm_tpu/parallel/batch_decode.py _scan_fn_batched
//   (res_gather=True), i.e. the lax.scan over dependency levels of
//   intra_wavefront.unpack_block_meta -> ops/intra.py border_coords ->
//   substitute -> filter_refs -> predict -> + residual -> clip -> scatter,
//   and libhm_tpu/parallel/intra_wavefront.py _scan_fn (one picture).
// What bounds it on the card: the dependency chain, not bytes or ALU.  A
//   1080p luma wavefront is ~1700-2600 levels of about a dozen blocks each;
//   a block touches 4n+1 border samples and n*n residual and output
//   samples.  A handshake between SMs through L2 on every level (acquire a
//   level counter, gather from L2, store, fence, release) cost ~2.5 us a
//   level.
// Why a CTU row is the unit: every available border sample of an intra
//   block lies in its own CTU row, in a block of a lower level, or in the
//   CTU row directly above (only blocks whose top edge is the row's top
//   edge read there: their top row and corner).  Below-left samples past
//   the CTU's bottom edge are never available (the next CTU row comes
//   later in decoding order, Rec. 8.4.4.2.2 with CTU raster order; across
//   tiles and slices they are unavailable anyway), so a row depends only
//   on itself and on the row above.  The host marks the blocks that read
//   the row above while it is part of the launch (flag 8, "cross").
// Why the components share a launch: intra prediction of one component
//   reads no sample of another (cross-component prediction acts on the
//   residual, which K1 has finished), so the luma, Cb and Cr chains are
//   independent and run side by side instead of in three launches.  A
//   work unit is a (picture, component, CTU row); the kernel takes one
//   parameter block per component (its planes, size, bit depth, CTU-row
//   height and lattice width) and reads a unit's component from byte 30
//   of the unit's first table row.
// Why it cannot deadlock: CTAs take units from a ticket counter in the
//   order the host lays them out, (component, CTU row, picture): luma's
//   units first.  A unit waits only on the unit of the row above in the
//   same picture and component (the host gives its index, `above`), which
//   sorts earlier, so it was ticketed earlier: it holds a CTA or has
//   finished, and it never waits on a later unit.  So any grid size works;
//   a grid of one CTA finishes each unit before it takes the next.  A row
//   with no intra block in the launch gets no unit; nobody writes it
//   during the launch.
// Why that order keeps the grid busy when units outnumber CTAs (five
//   1080p pictures: 255 units, 132 CTAs): a unit's first level comes about
//   two CTUs after the row above's, so a chain uses its rows one after
//   another.  Luma's chains are the longest (about twice a chroma chain's
//   levels): their units take CTAs first, row by row across the pictures,
//   so every luma chain starts at once; the chroma units fill the CTAs
//   left over and those that luma's first rows free, and finish inside
//   luma's time.  Picture-major would hold the last pictures' luma chains
//   back until the first pictures' rows end, adding most of a chain to
//   the launch (an event model of the five pictures' units at c = 1.27
//   us a chunk: 2.28 ms against 3.18 ms, luma alone 2.28 ms).
// What the design does:
//   - the host sends the flat block table, unit after unit, each unit's
//     blocks by level, 32 bytes a block, the first row of each unit and
//     the unit of its row above, and on the first row of each chunk its
//     block count: a chunk is the next blocks of one level of the unit,
//     at most 8 of them and 2048 samples;
//   - a CTA has 8 compute warps, 4 prepare warps and a publisher warp.
//     The row's own samples that borders read are the columns x = 4k + 3
//     and the rows y = 4k + 3 (every block starts on a multiple of 4): the
//     CTA keeps them in shared memory as uint16 (the lattice), copied from
//     the plane when it takes the row and written as it reconstructs;
//     columns past what shared memory holds (a 4K luma row) are read from
//     the plane, which only this CTA writes (L1 is coherent within an SM).
//     The shared memory is sized by the largest component's lattice; each
//     component's lattice width Wl is what that memory holds of its own
//     rows (a 1080p chroma row whole, a 4K luma row in part), and a unit
//     of a smaller component uses the front of it;
//   - while chunk k runs, the prepare warps prepare chunk k + 1 in the other
//     slot: for each border sample the source after substitution (one warp
//     a block; the availability words and clz, no scan) and where it lives
//     (the lattice, a copy, or the plane), copies (cp.async) of its
//     residuals and of the row above's samples where that row has already
//     released them;
//   - per chunk, the compute warps: one warp a block reads its border,
//     filters it ([1 2 1] or strong, neighbours by shuffle) and sums DC by
//     a warp reduction; a barrier; every compute thread predicts one sample
//     (planar, DC and angular as one weighted sum of four border samples),
//     adds the residual, clips and stores it (and the lattice); the chunk
//     barrier.  Between two chunks of a row: no poll, no device-scope
//     fence, no L2 gather;
//   - each unit has a progress counter, 128 bytes from the next: every
//     level below it is finished in that row (INT_MAX: the whole row).  The
//     publisher warp releases it (fence.acq_rel at device scope + store)
//     whenever the chunk warps hand it a new value through shared memory,
//     off the compute warps' chain.  A cross block's warp waits (one lane,
//     acquire at device scope) only when the row above has not reached its
//     level yet; the CTA keeps the last progress it acquired in shared
//     memory.  The row above's samples are read only after an acquire that
//     saw them released (L1 is not coherent across SMs): past L1 (__ldcg)
//     right after the wait, or copied ahead by the prepare warps once the
//     progress in shared memory covers them.
//   Cost of a call: about max over chains of L*c + R*h (L levels, R rows,
//   c one chunk inside an SM, h one hand-over between SMs), while the
//   units fit the grid.  Blocks of one level are independent by
//   construction (prepare_component levels all sizes on one map), so they
//   write the plane in place; unavailable border samples are never read.
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

constexpr int kWarps = 8;                   // compute warps: borders, then
constexpr int kCompute = kWarps * 32;       //   predictions
constexpr int kPrepWarps = 4;               // warps 8-11: the next chunk
constexpr int kChunkThreads = kCompute + kPrepWarps * 32;
constexpr int kThreads = kChunkThreads + 32;  // + the publisher warp
constexpr int kPer = 8;                     // samples per compute thread
constexpr int kChunk = kCompute * kPer;     // samples a chunk (ops/intra.py)
constexpr int kMaxT = 4 * 32 + 1;
constexpr int kFetch = kWarps * kMaxT;      // border samples a chunk
constexpr int kWin = 256;                   // table rows staged at once
constexpr int kRec = 32;                    // bytes per table row
constexpr int kStride = 32;                 // ints between counters
constexpr int kFinished = 0x7fffffff;
constexpr int kMaxPolls = 1 << 25;          // > 8 s of L2 round trips
constexpr int kCross = 8;                   // table flag: reads the row above
constexpr int kComps = 3;                   // components a launch holds
// flags of a prepared block
constexpr int kFilt = 1, kStrong = 2, kDbf = 4, kWait = 8, kNone = 16;
constexpr int kLdcg = 1 << 29;              // a global source in the row above

// One row of the block table (ops/intra.py BLOCK_DTYPE, little-endian):
// b int16 @0, x int16 @2, y int16 @4, mode int8 @6, log2n | flags << 4
// uint8 @7 (flags: 1 filt, 2 strong, 4 dbf, 8 cross), level int32 @8, av
// 17 bytes @12 (bit t of the 4n+1 border samples in scan order), chunk
// uint8 @29 (on a chunk's first row its block count, else 0), comp uint8
// @30 (the row's component: its index into the launch's Comps).

// One component of a launch: its planes [pictures, Hc, Wc], log2 of its
// CTU row's height, its bit depth, whether it is luma, and the columns
// [0, Wl) of its rows that the lattice holds.
struct Comp {
  int32_t* plane;
  const int32_t* res;
  int Hc, Wc, log2h, bd, is_luma, Wl;
};

struct Comps {
  Comp c[kComps];
};

// A block as the prepare warps leave it for the chunk's other phases.
struct alignas(16) Blk {
  long long base;                 // plane offset of its first sample
  int x0, ly0;                    // column; row from the CTU row's top
  int log2n, mode, ang, inv;
  int flags, level;
};

// A chunk, prepared one chunk ahead: where each border sample comes from
// after substitution (loc >= 0: the lattice; -1 - f: fetch[f], a copy of
// the row above; below -kFetch: the plane at base - Wc - 1 + g, g = -1 -
// kFetch - loc, read past L1 when g & kLdcg), the residuals and the
// blocks.
struct alignas(16) Slot {
  int res[kChunk];                // block after block, row-major
  int fetch[kFetch];              // [block][border sample]
  int loc[kFetch];
  Blk blk[kWarps];
  int off[kWarps + 1];            // first sample of each block; off[nb]: all
  int nb, level;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire_cta(const volatile int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared((const void*)p))
               : "memory");
  return v;
}

// Release every write the CTA made before it handed `v` over (the chunk
// barrier, then __threadfence_block and the shared store this thread
// read), then store: the arrive of CUTLASS's GenericBarrier.
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// compute and prepare warps, at the end of each chunk
__device__ __forceinline__ void chunk_barrier() {
  asm volatile("bar.sync 1, %0;" :: "n"(kChunkThreads) : "memory");
}

// compute warps: borders before predictions
__device__ __forceinline__ void compute_barrier() {
  asm volatile("bar.sync 2, %0;" :: "n"(kCompute) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// global -> shared, asynchronously: a barrier does not wait for it
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ int row_level(const uint8_t* rw) {
  return *(const int32_t*)(rw + 8);
}

__global__ void __launch_bounds__(kThreads) intra_wavefront_kernel(
    const Comps P, const uint8_t* __restrict__ table,
    const int* __restrict__ row_start, const int* __restrict__ above_of,
    int* ticket, int* progress, int U) {
  // the row's lattice: col[ly][x >> 2] holds column x = 4k + 3, row[ly >>
  // 2][x] holds row ly = 4k + 3 (ly from the row's top), for x < Wl: the
  // only samples of the row a border reads, copied from the plane when the
  // CTA takes the row and kept up to date as it writes them
  extern __shared__ __align__(16) uint8_t s_dyn[];
  uint16_t* s_lat = (uint16_t*)s_dyn;
  __shared__ __align__(16) uint8_t s_tab[kWin * kRec];
  __shared__ Slot s_slot[2];
  // filtered border of each block, then its DC value at kMaxT
  __shared__ int s_f[kWarps][kMaxT + 1];
  __shared__ int s_unit;
  __shared__ volatile int s_pub;           // progress handed to publisher
  __shared__ volatile int s_above;         // progress acquired, row above
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (;;) {
    if (tid == 0) {
      s_pub = 0;
      s_above = 0;
      s_unit = atomicAdd(ticket, 1);
    }
    __syncthreads();
    const int u = s_unit;                  // uniform over the CTA
    if (u >= U) return;
    const int beg = row_start[u], end = row_start[u + 1];
    // the unit's component (uniform over the CTA, as is all that follows)
    const int ci = table[(long long)beg * kRec + 30];
    const Comp C = ci == 0 ? P.c[0] : ci == 1 ? P.c[1] : P.c[2];
    int32_t* const plane = C.plane;
    const int32_t* const res = C.res;
    const int Hc = C.Hc, Wc = C.Wc, bd = C.bd, is_luma = C.is_luma;
    const int log2h = C.log2h, Wl = C.Wl, ch = 1 << log2h;
    uint16_t* const s_row = s_lat + ch * (Wl >> 2);
    const int maxv = (1 << bd) - 1;
    const long long plane_sz = (long long)Hc * Wc;

    if (warp == kThreads / 32 - 1) {
      // the publisher: release each progress value the chunk warps hand
      // over, until the row is finished
      if (lane == 0) {
        int last = 0;
        for (;;) {
          int v;
          while ((v = s_pub) == last) {
          }
          store_release(progress + (long long)u * kStride, v);
          last = v;
          if (v == kFinished) break;
        }
      }
      __syncwarp();
    } else {
      const int top = (*(const int16_t*)(table + (long long)beg * kRec + 4) >>
                       log2h) << log2h;   // the row's first sample row
      {
        // the lattice from the plane (the table's first picture of the row)
        const int32_t* pr = plane +
                            *(const int16_t*)(table + (long long)beg * kRec) *
                                plane_sz + (long long)top * Wc;
        const int nc = ch * (Wl >> 2), rows = min(ch, Hc - top);
        for (int q = tid; q < nc; q += kChunkThreads) {
          const int ly = q / (Wl >> 2), cx = ((q - ly * (Wl >> 2)) << 2) + 3;
          if (ly < rows) s_lat[q] = pr[(long long)ly * Wc + cx];
        }
        for (int q = tid; q < (ch >> 2) * Wl; q += kChunkThreads) {
          const int ly = ((q / Wl) << 2) + 3, cx = q - (q / Wl) * Wl;
          if (ly < rows) s_row[q] = pr[(long long)ly * Wc + cx];
        }
      }
      int wbase = 0;                       // staged rows [wbase, wbase+kWin)

      // stage table rows from `from`, and prefetch their residuals to L2
      auto stage = [&](int from) {
        wbase = from;
        const int nrow = min(kWin, end - wbase);
        const uint4* src = (const uint4*)(table + (long long)wbase * kRec);
        for (int q = tid; q < nrow * (kRec / 16); q += kChunkThreads)
          ((uint4*)s_tab)[q] = __ldg(src + q);
        if (tid < nrow) {
          const uint8_t* rw = table + (long long)(wbase + tid) * kRec;
          const int b = *(const int16_t*)rw;
          const int x0 = *(const int16_t*)(rw + 2);
          const int y0 = *(const int16_t*)(rw + 4);
          const int n = 1 << (rw[7] & 7);
          const int32_t* r0 = res + b * plane_sz + (long long)y0 * Wc + x0;
          for (int y = 0; y < n; ++y) prefetch_l2(r0 + (long long)y * Wc);
        }
        chunk_barrier();
      };

      // the prepare warps: the chunk at `at` into slot `sl`, while the
      // chunk before it runs
      auto prepare = [&](int at, int sl) {
        const int pw = warp - kWarps;
        const int pt = tid - kCompute;
        Slot& S = s_slot[sl];
        const uint8_t* t0 = s_tab + (at - wbase) * kRec;
        const int nb = t0[29];
        // offsets: an inclusive scan of the blocks' sizes over lanes < nb
        const int sz = lane < nb ? 1 << (2 * (t0[lane * kRec + 7] & 7)) : 0;
        int inc = sz;
#pragma unroll
        for (int o = 1; o <= kWarps; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += v;
        }
        if (pw == 0 && lane <= nb) S.off[lane] = inc - sz;
        if (pt == 0) {
          S.nb = nb;
          S.level = row_level(t0);
        }
        const int above = ld_acquire_cta(&s_above);
        for (int j = pw; j < nb; j += kPrepWarps) {
          const int off = __shfl_sync(0xffffffffu, inc - sz, j);
          const uint8_t* rw = t0 + j * kRec;
          const int b = *(const int16_t*)rw;
          const int x0 = *(const int16_t*)(rw + 2);
          const int y0 = *(const int16_t*)(rw + 4);
          const int mode = *(const int8_t*)(rw + 6);
          const int log2n = rw[7] & 7, fl = rw[7] >> 4;
          const int level = row_level(rw);
          const int n = 1 << log2n, T = 4 * n + 1;
          const int cross = fl & kCross;
          const int wait = cross && above < level;
          const long long base = b * plane_sz + (long long)y0 * Wc + x0;
          // substitution (8.4.4.2.2): sample i = lane + 32 e lies in word e
          // of the availability bits; its source is the nearest available
          // sample at or below it: in word e at or below the lane, else the
          // last one below word e (h[e - 1]), else the first one
          const uint32_t* aw = (const uint32_t*)(rw + 12);
          uint32_t a[5];
          a[0] = aw[0], a[1] = aw[1], a[2] = aw[2], a[3] = aw[3];
          a[4] = rw[28];
          int h[5];
#pragma unroll
          for (int e = 0; e < 5; ++e)
            h[e] = a[e] ? (e << 5) + 31 - __clz(a[e]) : e ? h[e - 1] : -1;
          int first = -1;
#pragma unroll
          for (int e = 4; e >= 0; --e)
            if (a[e]) first = (e << 5) + __ffs(a[e]) - 1;
          const uint32_t below = 0xffffffffu >> (31 - lane);
#pragma unroll
          for (int e = 0; e < 5; ++e) {
            const int i = lane + (e << 5);
            if (e * 32 >= T) break;
            if (i >= T || first < 0) continue;
            const uint32_t m = a[e] & below;
            int src = m ? (e << 5) + 31 - __clz(m) : e ? h[e - 1] : -1;
            if (src < 0) src = first;
            const int ox = max(src - 2 * n - 1, -1);
            const int oy = max(2 * n - 1 - src, -1);
            const int cx = x0 + ox, ly = y0 + oy - top;
            const int g = (oy + 1) * Wc + ox + 1;     // from base - Wc - 1
            const int f = j * kMaxT + i;
            int L;
            if (ly >= 0) {                // this row: the lattice, or the
              L = cx >= Wl ? -1 - kFetch - g       // plane past it
                  : (cx & 3) == 3 ? ly * (Wl >> 2) + (cx >> 2)
                                  : ch * (Wl >> 2) + (ly >> 2) * Wl + cx;
            } else if (wait) {            // the row above, once it is there
              L = -1 - kFetch - (g | kLdcg);
            } else {                      // the row above: copied now
              copy4(&S.fetch[f], plane + base - Wc - 1 + g);
              L = -1 - f;
            }
            S.loc[f] = L;
          }
          const int32_t* r0 = res + base;
          const int q4 = log2n - 2;          // 16-byte pieces a row: n / 4
          for (int c = lane; c < (n << q4); c += 32) {
            const int y = c >> q4, xq = (c & ((1 << q4) - 1)) << 2;
            copy16(&S.res[off + (y << log2n) + xq],
                   r0 + (long long)y * Wc + xq);
          }
          if (lane == 0) {
            const int ang = kAng[mode];
            S.blk[j] = Blk{base, x0, y0 - top, log2n, mode, ang,
                           ang < 0 ? inv_angle(ang) : 0,
                           (fl & 1 ? kFilt : 0) |
                               ((fl & 2) && n == 32 ? kStrong : 0) |
                               (fl & 4 ? kDbf : 0) | (wait ? kWait : 0) |
                               (first < 0 ? kNone : 0),
                           level};
          }
        }
        copy_commit();
        copy_wait();
      };

      stage(beg);
      if (warp >= kWarps) prepare(beg, 0);
      chunk_barrier();
      int prev = -1;                       // level of the last step
      int sl = 0;
      for (int idx = beg; idx < end; sl ^= 1) {
        Slot& S = s_slot[sl];
        const int nb = S.nb, level = S.level;
        const int nxt = idx + nb;
        if (level != prev) {
          // every level below this one is finished in this row (warp 8
          // stores nothing and its copies are done: its fence is short)
          if (tid == kCompute && prev >= 0) {
            __threadfence_block();
            s_pub = level;
          }
          prev = level;
        }
        if (nxt < end && nxt + kWarps > wbase + kWin) stage(idx);

        if (warp >= kWarps) {
          if (nxt < end) prepare(nxt, sl ^ 1);
        } else {
          // 1. one warp a block: its border (8.4.4.2.2), filtered
          //    (8.4.4.2.3) by shuffle, and its DC sum
          if (warp < nb) {
            const int j = warp;
            Blk& B = S.blk[j];
            const int n = 1 << B.log2n, T = 4 * n + 1, flags = B.flags;
            const int behind = __any_sync(
                0xffffffffu,
                (flags & kWait) && ld_acquire_cta(&s_above) < B.level);
            if (behind) {
              // wait until the row above has finished every level below
              // ours (s_above: the last progress this CTA acquired)
              if (lane == 0) {
                const int* d = progress + (long long)above_of[u] * kStride;
                int seen, polls = 0;
                while ((seen = ld_acquire(d)) < B.level) {
                  // a table whose rows disagree with its units would wait
                  // forever: fail the launch instead, after seconds
                  if (++polls == kMaxPolls) __trap();
                }
                __threadfence_block();
                atomicMax((int*)&s_above, seen);
              }
              __syncwarp();
            }
            const int32_t* pg = plane + B.base - Wc - 1;
            int v[5];
#pragma unroll
            for (int e = 0; e < 5; ++e) {
              const int i = lane + (e << 5);
              v[e] = 1 << (bd - 1);
              if (e * 32 < T && i < T && !(flags & kNone)) {
                const int L = S.loc[j * kMaxT + i];
                if (L >= 0) {
                  v[e] = s_lat[L];
                } else if (L >= -kFetch) {
                  v[e] = S.fetch[-1 - L];
                } else {
                  const int g = -1 - kFetch - L;
                  v[e] = g & kLdcg ? __ldcg(pg + (g ^ kLdcg)) : pg[g];
                }
              }
            }
            const int filt = flags & kFilt;
            int use_strong = 0, c = 0, bl = 0, tr = 0;
            if (flags & kStrong) {
              // samples 0, 32, 64, 96, 128: lane 0 of each word
              bl = __shfl_sync(0xffffffffu, v[0], 0);
              const int l1 = __shfl_sync(0xffffffffu, v[1], 0);
              c = __shfl_sync(0xffffffffu, v[2], 0);
              const int l3 = __shfl_sync(0xffffffffu, v[3], 0);
              tr = __shfl_sync(0xffffffffu, v[4], 0);
              const int thr = 1 << (bd - 5);
              use_strong = filt && abs(c + tr - 2 * l3) < thr &&
                           abs(c + bl - 2 * l1) < thr;
            }
            int* f = s_f[j];
            int dcs = 0;
#pragma unroll
            for (int e = 0; e < 5; ++e) {
              if (e * 32 >= T) break;
              const int i = lane + (e << 5);
              int o = v[e];
              if (filt) {                  // (warp-uniform)
                int up = __shfl_up_sync(0xffffffffu, v[e], 1);
                int dn = __shfl_down_sync(0xffffffffu, v[e], 1);
                const int up31 =
                    __shfl_sync(0xffffffffu, v[e ? e - 1 : 0], 31);
                const int dn0 =
                    __shfl_sync(0xffffffffu, v[e < 4 ? e + 1 : 4], 0);
                if (lane == 0) up = up31;
                if (lane == 31) dn = dn0;
                if (use_strong)
                  o = i <= 2 * n
                          ? (i * c + (2 * n - i) * bl + n) >> 6
                          : ((4 * n - i) * c + (i - 2 * n) * tr + n) >> 6;
                else if (i > 0 && i < T - 1)
                  o = (up + 2 * o + dn + 2) >> 2;
              }
              if (i < T) f[i] = o;
              if (i >= n && i <= 3 * n && i != 2 * n) dcs += o;
            }
            if (B.mode == 1) {             // (warp-uniform)
              const int dc = __reduce_add_sync(0xffffffffu, dcs);
              if (lane == 0) f[kMaxT] = (dc + n) >> (B.log2n + 1);
            }
          }
          compute_barrier();

          // 2. every compute thread: predict (8.4.4.2.4-6), + residual,
          //    clip, store
          const int tot = S.off[nb];
#pragma unroll 1
          for (int p = tid; p < tot; p += kCompute) {
            int k = 0;
            for (int m = 1; m < nb; ++m) k += p >= S.off[m];
            const Blk& B = S.blk[k];
            const int q = p - S.off[k];
            const int log2n = B.log2n, n = 1 << log2n, mode = B.mode;
            const int* v = s_f[k];
            const int y = q >> log2n, x = q & (n - 1);
            const int edge = is_luma && n < 32;
            // pred = (w0 v[i0] + w1 v[i1] + w2 v[i2] + w3 v[i3] + rnd) >> sh,
            // v[kMaxT] being the DC value
            int i0, i1, i2 = kMaxT, i3 = 0, w0, w1, w2 = 0, w3 = 0, rnd, sh;
            if (mode == 0) {               // planar
              i0 = 2 * n - 1 - y, w0 = n - 1 - x;
              i1 = 3 * n + 1, w1 = x + 1;
              i2 = 2 * n + 1 + x, w2 = n - 1 - y;
              i3 = n - 1, w3 = y + 1;
              rnd = n, sh = log2n + 1;
            } else if (mode == 1) {        // DC, with its edges
              const int ex = edge && x == 0, ey = edge && y == 0;
              i0 = ey ? 2 * n + 1 + x : 2 * n - 1 - y, w0 = ex | ey;
              i1 = 2 * n - 1, w1 = 0;
              w2 = ex | ey ? 3 : 4;
              if (ex && ey) i1 = 2 * n - 1, i0 = 2 * n + 1, w1 = 1, w2 = 2;
              rnd = 2, sh = 2;
            } else {                       // angular
              const int vertical = mode >= 18;
              const int jj = vertical ? y : x;  // row along the direction
              const int ii = vertical ? x : y;  // position within that row
              const int pos = (jj + 1) * B.ang;
              const int fr = pos & 31;
              const int ri = ii + (pos >> 5) + 1;
              const int r0 = ri >= 0 ? ri
                                     : -min((-ri * B.inv + 128) >> 8, 2 * n);
              const int r1 = ri + 1 >= 0
                                 ? ri + 1
                                 : -min((-(ri + 1) * B.inv + 128) >> 8, 2 * n);
              i0 = vertical ? 2 * n + r0 : 2 * n - r0, w0 = 32 - fr;
              i1 = vertical ? 2 * n + r1 : 2 * n - r1, w1 = fr;
              i1 = max(min(i1, kMaxT), 0);   // fr = 0 past the ends
              rnd = 16, sh = 5;
            }
            int pred = (w0 * v[i0] + w1 * v[i1] + w2 * v[i2] + w3 * v[i3] +
                        rnd) >> sh;
            if (edge && !(B.flags & kDbf) &&
                ((mode == 26 && x == 0) || (mode == 10 && y == 0))) {
              const int a = mode == 26 ? 2 * n + 1 : 2 * n - 1;
              const int d = mode == 26 ? 2 * n - 1 - y : 2 * n + 1 + x;
              pred = clip3(0, maxv, v[a] + ((v[d] - v[2 * n]) >> 1));
            }
            const int out = clip3(0, maxv, pred + S.res[p]);
            const int xx = B.x0 + x, ly = B.ly0 + y;
            if (top + ly < Hc && xx < Wc)
              plane[B.base + (long long)y * Wc + x] = out;
            if (xx < Wl) {
              if ((xx & 3) == 3) s_lat[ly * (Wl >> 2) + (xx >> 2)] = out;
              if ((ly & 3) == 3) s_row[(ly >> 2) * Wl + xx] = out;
            }
          }
        }
        chunk_barrier();
        idx = nxt;
      }
      // the whole row is finished
      if (tid == kCompute) {
        __threadfence_block();
        s_pub = kFinished;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// comps: ncomp (1-3) host entries of 8 int64 each, in the order of the
// table rows' comp byte: plane, res (device pointers), Hc, Wc, log2h, bd,
// is_luma, 0.  units: row_start [U + 1] (the first table row of each
// unit, then the row count), then above [U] (the unit of each unit's row
// above, -1 where there is none).  Component i's lattice covers columns
// [0, Wl_i): all of them where the CTA's shared memory holds ch_i x Wc_i
// bytes of it, else as many as it holds (the rest of the row is read from
// the plane); lattice[i] receives Wl_i.  The dynamic shared memory is the
// largest ch_i x Wl_i.  The CTAs the grid holds when `ctas` <= 0: SMs x
// resident CTAs per SM at that size.  The shared memory limit is raised
// once on each device.
extern "C" int intra_wavefront(const long long* comps, int ncomp,
                               const void* table, const void* units,
                               void* sync, int U, int ctas, int* lattice,
                               void* stream) {
  if (ncomp < 1 || ncomp > kComps) return (int)cudaErrorInvalidValue;
  if (U == 0) return 0;
  constexpr int kDevices = 64;
  static int sms[kDevices], optin[kDevices], stat[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, intra_wavefront_kernel);
    if (e == cudaSuccess) {
      stat[dev] = (int)fa.sharedSizeBytes;
      e = cudaFuncSetAttribute(intra_wavefront_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin[dev] - stat[dev]);
    }
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int room = optin[dev] - stat[dev] - 64;
  Comps P = {};
  size_t dyn = 0;
  for (int i = 0; i < ncomp; ++i) {
    const long long* c = comps + 8 * i;
    const int Wc = (int)c[3], log2h = (int)c[4], ch = 1 << log2h;
    int Wl = room > 0 ? (room / ch) & ~3 : 0;
    if (Wl > Wc) Wl = Wc;
    lattice[i] = Wl;
    P.c[i] = Comp{(int32_t*)c[0], (const int32_t*)c[1], (int)c[2], Wc,
                  log2h, (int)c[5], (int)c[6], Wl};
    if ((size_t)ch * Wl > dyn) dyn = (size_t)ch * Wl;
  }
  if (ctas <= 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_wavefront_kernel, kThreads, dyn);
    if (e != cudaSuccess) return (int)e;
    ctas = sms[dev] * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = ctas < U ? ctas : U;
  const int* rs = (const int*)units;
  int* s = (int*)sync;           // ticket at 0, progress[u] at (u + 1) * 32
  intra_wavefront_kernel<<<grid, kThreads, dyn, (cudaStream_t)stream>>>(
      P, (const uint8_t*)table, rs, rs + U + 1, s, s + kStride, U);
  return (int)cudaGetLastError();
}
