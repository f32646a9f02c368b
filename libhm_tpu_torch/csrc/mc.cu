// K5 mc_grid and K6 mc_weighted: motion-compensated prediction + residual.
//
// Replaces: K5 libhm_tpu/parallel/dag_decode.py _mc_phase_grid_fn (phase
//   planes of ops/interp.py phase_planes, one mc_phase_gather per sample,
//   the uni/bi epilogue, + residual, only where the 4x4's direction is > 0)
//   and _mc_grid_fn; K6 libhm_tpu/parallel/dag_decode.py _mc_scatter_fn
//   (ops/interp.py mc_blocks per 4x4 block, the plain or the weighted_uni /
//   weighted_bi epilogue, + residual, scattered into the planes).
// What bounds them on the card: bytes.  A level reads B residual planes
//   and R reference planes and writes B planes, all int32; the arithmetic
//   (at most 2 x (8 + 8) multiply-adds a luma sample in separable form) is
//   far below the card's integer rate.
// K5's design: one 256-thread CTA per 16 x 16 output samples.
//   Luma (8 taps): a block-wide vote on the direction map leaves tiles with
//   no inter cell at once.  Where all inter cells of the tile share
//   direction, MVs and references (PUs of 16 x 16 and up), one reference
//   window of (16 + 7)^2 samples per list, each coordinate clamped into
//   the picture (Rec. 8.5.3.3.3, what the TPU's phase planes and their
//   apron give), is copied into shared memory with cp.async; the
//   horizontal pass writes a shared intermediate and the vertical pass
//   reads it (8 + 8 taps a sample instead of 8 x 8 loads and 72 MACs).
//   Tiles whose cells differ take one 11 x 11 window per cell and list the
//   same way when at least kCellsHv cells filter both ways, and predict
//   each sample straight from the reference plane otherwise (the cheaper
//   of the two on such tiles, measured).  Both lists stage in one pass;
//   where a fraction is 0 no apron is loaded in that direction; the taps
//   come from a shared table indexed by the slot's fraction; the geometry
//   is a template, so the index arithmetic divides by constants.
//   Chroma (4 taps, 2 x 2 to 4 x 4 sample cells): each sample is predicted
//   straight from the reference plane; every staged form measured was
//   slower there (PERF.md section 6).  Each thread stores its own sample,
//   coalesced.
// K6's design: the component picks the kernel.  Luma takes the same tiles
//   and forms as K5 over a block table whose rows come grouped by 16 x
//   16-sample tile (ops/interp.py tile_groups: index preparation, on the
//   host for the decode, on the device for rows in any order).  Each CTA
//   walks tile runs with a grid stride and copies the next chunk's rows
//   into shared memory (cp.async) while it filters the current one; one
//   vote says whether the rows sit on the tile's cell grid and share one
//   PU (direction, MVs, references and, when weighted, weights and
//   offsets), and the threads map onto the tile's samples: one window a
//   list for a PU (form a), one a cell and list where enough cells filter
//   both ways (form b), direct prediction otherwise (form c); rows off the
//   grid are predicted directly, one thread a sample.  Chroma takes no
//   shared memory and no runs: one thread a sample of the rows in any
//   order, each field read where it is used; the tiled forms were slower
//   there (PERF.md section 6).  The epilogue's constants are computed once
//   a CTA; nothing divides by a runtime value per sample.
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

// shift2 = Max(3, 15 - bitDepth) (Rec. 8.5.3.3.4.2): 15 - bd up to 12
// bits, one more than the headroom above
__device__ __forceinline__ int bi_average(int p0, int p1, int headroom,
                                          int maxs) {
  const int shift = headroom + 1;
  return clampi((p0 + p1 + (1 << (shift - 1)) + 2 * kIfOffs) >> shift, 0,
                maxs);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

constexpr int kTile = 16;                     // output tile, samples
constexpr int kThreads = kTile * kTile;
// a luma tile takes per-cell windows when at least this many of its cells
// filter a list both horizontally and vertically (else each sample is
// predicted directly); chosen by timing RA 1080p and seeded levels on the
// card (PERF.md section 6)
constexpr int kCellsHv = 4;

// One list's reference window for one slot of a tile (a cell, or the
// whole tile when its inter cells share one PU): window origin (each
// coordinate clamped into the picture at the load), reference index, and
// f = used | fx << 1 | fy << 5 (the filter indices).
struct Slot {
  int iy, ix, ref, f;
};

template <int TAPS, int SW, int SH>
struct Geom {
  static constexpr int half = TAPS / 2 - 1;
  static constexpr int ww = SW + TAPS - 1, wh = SH + TAPS - 1;
  static constexpr int wn = ww * wh;          // window samples
  static constexpr int hn = wh * SW;          // after the horizontal pass
  static constexpr int ns = (kTile / SW) * (kTile / SH);
};

// Copy both lists' windows of every used slot into win[2][ns][wh][ww]
// (cp.async, 4 bytes each); where a slot's fraction is 0 in a direction,
// only the samples that direction's copy reads.  One work item is a part
// of a window row: its source row's address is computed once and each
// column clamped, so the index arithmetic is paid per row part, not per
// sample (the per-sample form was 13% slower for K6's luma and 5% for K5's
// on the card, PERF.md section 6)
template <int TAPS, int SW, int SH, class Get>
__device__ __forceinline__ void stage(Get slot, int* win,
                                      const int32_t* __restrict__ refs,
                                      long long plane, int H, int W) {
  using G = Geom<TAPS, SW, SH>;
  constexpr int kRows = 2 * G::ns * G::wh;
  constexpr int kParts = kRows >= kThreads ? 1 : kThreads / kRows;
  constexpr int kCols = (G::ww + kParts - 1) / kParts;
  for (int it = threadIdx.x; it < kRows * kParts; it += kThreads) {
    const int row = it / kParts, part = it - row * kParts;
    const int k = row / G::wh, r = row - k * G::wh;
    const Slot s = slot(k);
    if (!(s.f & 1) || (!(s.f >> 5) && (r < G::half || r >= G::half + SH)))
      continue;
    const bool hx = (s.f & 0x1e) != 0;
    const int c0 = max(part * kCols, hx ? 0 : G::half);
    const int c1 = min((part + 1) * kCols, hx ? G::ww : G::half + SW);
    const int32_t* src =
        refs + s.ref * plane + (long long)clampi(s.iy + r, 0, H - 1) * W;
    int* dst = win + k * G::wn + r * G::ww;
    for (int c = c0; c < c1; ++c)
      cp_async4(dst + c, src + clampi(s.ix + c, 0, W - 1));
  }
}

// horizontal pass into hor[2][ns][wh][SW]: filtered (14-bit) where the
// slot's horizontal fraction is not 0, else the raw samples; each item is
// up to 4 outputs of one window row, read once into registers
template <int TAPS, int SW, int SH, class Get>
__device__ __forceinline__ void horizontal(Get slot, const int* win, int* hor,
                                           const int* taps, int o1, int s1) {
  using G = Geom<TAPS, SW, SH>;
  constexpr int kOut = SW < 4 ? SW : 4, kChunks = SW / kOut;
  for (int it = threadIdx.x; it < 2 * G::ns * G::wh * kChunks;
       it += kThreads) {
    const int row = it / kChunks, chunk = it - row * kChunks;
    const int k = row / G::wh, r = row - k * G::wh;
    const Slot s = slot(k);
    if (!(s.f & 1) || (!(s.f >> 5) && (r < G::half || r >= G::half + SH)))
      continue;
    const int* src = win + k * G::wn + r * G::ww + chunk * kOut;
    int* dst = hor + k * G::hn + r * SW + chunk * kOut;
    const int fx = (s.f >> 1) & 15;
    if (fx) {
      int v[kOut + TAPS - 1], tp[TAPS];
#pragma unroll
      for (int i = 0; i < kOut + TAPS - 1; ++i) v[i] = src[i];
#pragma unroll
      for (int j = 0; j < TAPS; ++j) tp[j] = taps[fx * TAPS + j];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        int acc = 0;
#pragma unroll
        for (int j = 0; j < TAPS; ++j) acc += tp[j] * v[o + j];
        dst[o] = (acc + o1) >> s1;
      }
    } else {
#pragma unroll
      for (int o = 0; o < kOut; ++o) dst[o] = src[o + G::half];
    }
  }
}

// vertical pass of one sample (ly, lx) of slot k: the four cases of
// predict (copy, h only, v only, h then v) with their shifts
template <int TAPS, int SW, int SH>
__device__ __forceinline__ int vertical(const Slot& s, int k, const int* hor,
                                        int ly, int lx, const int* taps,
                                        int o1, int s1, int headroom) {
  using G = Geom<TAPS, SW, SH>;
  const int* col = hor + k * G::hn + ly * SW + lx;
  const int fx = (s.f >> 1) & 15, fy = s.f >> 5;
  if (fy) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) acc += taps[fy * TAPS + j] * col[j * SW];
    return fx ? acc >> 6 : (acc + o1) >> s1;
  }
  const int v = col[G::half * SW];
  return fx ? v : (v << headroom) - kIfOffs;
}

// K5: one CTA per 16 x 16 output samples of a component whose luma 4x4
// cells are CW x CH samples; taps 8 (luma) or 4 (chroma)
template <int TAPS, int CW, int CH>
__global__ void __launch_bounds__(kThreads, 6)
mc_grid_kernel(int32_t* __restrict__ stacked, const int32_t* __restrict__ res,
               const int32_t* __restrict__ refs,
               const int16_t* __restrict__ mv, const int8_t* __restrict__ dir,
               const int16_t* __restrict__ sel, int Hp, int Wp, int R, int H,
               int W, int h4, int w4, int fbx, int fby, int bd) {
  const int t = threadIdx.x, ty = t / kTile, tx = t % kTile;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int y = y0 + ty, x = x0 + tx;
  // this sample's cell (padding rows/cols beyond the component size never
  // code inter; a cell index past the map takes its last row or column),
  // its direction, MVs (x | y << 16 a list) and references (an index past
  // the stack is clamped, as the JAX gather clamps it)
  const long long cell =
      ((long long)b * h4 + min(y / CH, h4 - 1)) * w4 + min(x / CW, w4 - 1);
  const int d = dir[cell];
  const int2 m = *reinterpret_cast<const int2*>(mv + cell * 4);
  const int sp = *reinterpret_cast<const int*>(sel + cell * 2);
  const int mvp[2] = {m.x, m.y};
  const int ref[2] = {clampi((int16_t)(sp & 0xffff), 0, R - 1),
                      clampi(sp >> 16, 0, R - 1)};
  const bool out = y < H && x < W && d > 0;
  const long long o = ((long long)b * Hp + y) * Wp + x;
  const long long plane = (long long)H * W;
  const int headroom = max(2, kIfPrec - bd);
  const int maxs = (1 << bd) - 1;
  int p[2] = {0, 0};
  auto direct = [&](int l) {
    return predict<TAPS>(refs + ref[l] * plane, H, W, y, x,
                         (int16_t)(mvp[l] & 0xffff), mvp[l] >> 16, fbx, fby,
                         headroom);
  };
  auto finish = [&]() {
    const int pred = d == 3 ? bi_average(p[0], p[1], headroom, maxs)
                            : uni_round(d == 1 ? p[0] : p[1], headroom, maxs);
    stacked[o] = clampi(pred + res[o], 0, maxs);
  };
  if constexpr (TAPS == 4) {
    // chroma: 4 taps on 2 x 2 to 4 x 4 sample cells; predicting each sample
    // from the reference plane beat every staged form timed on the card
    if (!out) return;
#pragma unroll
    for (int l = 0; l < 2; ++l)
      if (d & (1 << l)) p[l] = direct(l);
    finish();
  } else {
    // luma
    using C = Geom<TAPS, CW, CH>;             // one slot a cell
    using T = Geom<TAPS, kTile, kTile>;       // one slot for the tile
    constexpr int half = C::half;
    constexpr int kWin = 2 * (C::ns * C::wn > T::wn ? C::ns * C::wn : T::wn);
    constexpr int kHor = 2 * (C::ns * C::hn > T::hn ? C::ns * C::hn : T::hn);
    __shared__ int s_win[kWin];
    __shared__ int s_hor[kHor];
    __shared__ Slot s_slot[2 * C::ns];
    __shared__ int s_taps[TAPS * 4];          // the filter table
    __shared__ int s_dir[kThreads], s_mv[2][kThreads], s_ref[2][kThreads];
    __shared__ int s_warp[kThreads / 32];
    if (t < TAPS * 4) s_taps[t] = kLumaFilter[t / TAPS][t % TAPS];
    s_dir[t] = d;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      s_mv[l][t] = mvp[l];
      s_ref[l][t] = ref[l];
    }
    const unsigned vote = __ballot_sync(0xffffffffu, out);
    if (t % 32 == 0) s_warp[t / 32] = vote ? t + __ffs(vote) - 1 : kThreads;
    const int ly = ty % CH, lx = tx % CW;
    const int cslot = (ty / CH) * (kTile / CW) + tx / CW;
    bool hv = false;                          // a list filtered both ways
    if (ly == 0 && lx == 0) {
      // the cell's slot, filled by its first sample
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int mx = (int16_t)(mvp[l] & 0xffff), my = mvp[l] >> 16;
        const int fx = mx & ((1 << fbx) - 1), fy = my & ((1 << fby) - 1);
        s_slot[l * C::ns + cslot] = {y + (my >> fby) - half,
                                     x + (mx >> fbx) - half, ref[l],
                                     ((d >> l) & 1) | fx << 1 | fy << 5};
        hv = hv || ((d >> l) & 1 && fx && fy);
      }
    }
    const int cells_hv = __syncthreads_count(hv);
    // a tile with no inter sample leaves at once
    int first = kThreads;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) first = min(first, s_warp[w]);
    if (first == kThreads) return;

    // one window for the tile when every inter cell has the first one's
    // direction, MVs and references
    const int df = s_dir[first];
    bool same = true;
    if (out) {
      same = d == df;
#pragma unroll
      for (int l = 0; l < 2; ++l)
        if (d & (1 << l))
          same = same && mvp[l] == s_mv[l][first] &&
                 ref[l] == s_ref[l][first];
    }
    const int rv = out ? res[o] : 0;          // in flight during the staging
    const bool tile_mv = __syncthreads_and(same);
    const bool cells = !tile_mv && cells_hv >= kCellsHv;
    Slot ts[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int mx = (int16_t)(s_mv[l][first] & 0xffff);
      const int my = s_mv[l][first] >> 16;
      ts[l] = {y0 + (my >> fby) - half, x0 + (mx >> fbx) - half,
               s_ref[l][first],
               ((df >> l) & 1) | (mx & ((1 << fbx) - 1)) << 1 |
                   (my & ((1 << fby) - 1)) << 5};
    }
    auto tile_slot = [&](int k) { return k ? ts[1] : ts[0]; };
    auto cell_slot = [&](int k) { return s_slot[k]; };
    if (tile_mv)
      stage<TAPS, kTile, kTile>(tile_slot, s_win, refs, plane, H, W);
    else if (cells)
      stage<TAPS, CW, CH>(cell_slot, s_win, refs, plane, H, W);
    cp_async_wait_all();
    __syncthreads();
    const int s1 = 6 - headroom, o1 = -(kIfOffs << s1);
    if (tile_mv)
      horizontal<TAPS, kTile, kTile>(tile_slot, s_win, s_hor, s_taps, o1,
                                     s1);
    else if (cells)
      horizontal<TAPS, CW, CH>(cell_slot, s_win, s_hor, s_taps, o1, s1);
    __syncthreads();
    if (!out) return;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (!(d & (1 << l))) continue;
      if (tile_mv)
        p[l] = vertical<TAPS, kTile, kTile>(ts[l], l, s_hor, ty, tx, s_taps,
                                            o1, s1, headroom);
      else if (cells)
        p[l] = vertical<TAPS, CW, CH>(s_slot[l * C::ns + cslot],
                                      l * C::ns + cslot, s_hor, ly, lx,
                                      s_taps, o1, s1, headroom);
      else
        p[l] = direct(l);
    }
    const int pred = d == 3 ? bi_average(p[0], p[1], headroom, maxs)
                            : uni_round(d == 1 ? p[0] : p[1], headroom, maxs);
    stacked[o] = clampi(pred + rv, 0, maxs);
  }
}

template <int TAPS, int CW, int CH>
void launch_grid(dim3 grid, cudaStream_t s, void* stacked, const void* res,
                 const void* refs, const void* mv, const void* dir,
                 const void* sel, int Hp, int Wp, int R, int H, int W, int h4,
                 int w4, int fbx, int fby, int bd) {
  mc_grid_kernel<TAPS, CW, CH><<<grid, kThreads, 0, s>>>(
      (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
      (const int16_t*)mv, (const int8_t*)dir, (const int16_t*)sel, Hp, Wp, R,
      H, W, h4, w4, fbx, fby, bd);
}

// one row of the block table (ops/interp.py BLK_FIELDS)
enum { kB, kX, kY, kDir, kMv0x, kMv0y, kMv1x, kMv1y, kSel0, kSel1, kW0, kW1,
       kO0, kO1, kFields };

// the lists a row's epilogue reads: bi (3) both, 1 list 0, any other
// direction list 1, as the plain version's torch.where picks them
__device__ __forceinline__ bool uses(int d, int l) {
  return l == 0 ? (d == 1 || d == 3) : d != 1;
}

// the plain (uni_round / bi_average) or weighted (ops/interp.py
// weighted_uni / weighted_bi) epilogue of one sample of row q.  int32
// holds the weighted sums at 8-16 bits, also with the offsets of
// high_precision_offsets_enabled_flag (up to +-2^(bd - 1), unshifted):
// |w| <= 255 and |p + kIfOffs| < 2^19 give |w0 p0 + w1 p1| < 2^28, and
// shift <= 7 + 1 + max(2, 14 - bd) gives |(o0 + o1) << (shift - 1)| <= 2^25
// at 16 bits (2^21 with 8-bit offsets shifted to 8-12 bits)
__device__ __forceinline__ int epilogue(const int* q, const int p[2],
                                        int headroom, int maxs, int wp,
                                        int denom) {
  const int d = q[kDir];
  if (!wp)
    return d == 3 ? bi_average(p[0], p[1], headroom, maxs)
                  : uni_round(d == 1 ? p[0] : p[1], headroom, maxs);
  if (d == 3) {
    const int shift = denom + 1 + headroom;
    const int v = (q[kW0] * (p[0] + kIfOffs) + q[kW1] * (p[1] + kIfOffs) +
                   (1 << (shift - 1)) + (q[kO0] + q[kO1]) * (1 << (shift - 1)))
                  >> shift;
    return clampi(v, 0, maxs);
  }
  const int l = d == 1 ? 0 : 1;
  const int shift = denom + headroom;
  const int v = ((q[kW0 + l] * (p[l] + kIfOffs) + (1 << (shift - 1))) >> shift)
                + q[kO0 + l];
  return clampi(v, 0, maxs);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` of the newest committed copy groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// copy rows [c0, c0 + n) of the block table into dst (cp.async)
__device__ __forceinline__ void load_rows(int* dst,
                                          const int32_t* __restrict__ blk,
                                          int c0, int n) {
  for (int e = threadIdx.x; e < n * kFields; e += kThreads)
    cp_async4(dst + e, blk + (long long)c0 * kFields + e);
}

// K6's luma kernel holds 64 registers a thread, four CTAs an SM: two,
// three or six CTAs (128, 80 or 40 registers) were slower on the card
constexpr int kK6Ctas = 4;

// K6 for luma: the rows of a block table grouped by 16 x 16-sample tile
// (ops/interp.py tile_groups: grp[g] is the first row of tile run g, runs
// past the last start at N).  Each CTA takes runs with a grid stride and
// each run in chunks of up to 16 rows, read into shared memory while the
// chunk before is filtered (two buffers).  A chunk whose blocks sit on the
// 4 x 4 grid of its first row's tile maps its threads onto that tile's
// samples and takes one form: (a) every row shares the first one's
// direction, MVs, references and, when weighted, weights and offsets: one
// window per list for the tile; (b) at least kCellsHv rows filter a list
// both ways: one window per cell and list; (c) otherwise each sample
// straight from the reference plane.  Forms (a) and (b) stage with
// cp.async and filter separably, as K5 does.  Any other chunk predicts
// each row's samples directly.
__global__ void __launch_bounds__(kThreads, kK6Ctas)
mc_weighted_luma_kernel(int32_t* __restrict__ stacked,
                        const int32_t* __restrict__ res,
                        const int32_t* __restrict__ refs,
                        const int32_t* __restrict__ blk,
                        const int32_t* __restrict__ grp, int N, int G, int B,
                        int Hp, int Wp, int R, int H, int W, int bd, int wp,
                        int denom) {
  constexpr int TAPS = 8, CW = 4, CH = 4;     // 8 taps on 4 x 4 cells
  constexpr int kFb = 2, kFrac = 3;           // quarter-pel MVs
  using C = Geom<TAPS, CW, CH>;               // one slot a cell
  using T = Geom<TAPS, kTile, kTile>;         // one slot for the tile
  constexpr int half = C::half, per = CW * CH, ns = C::ns;
  static_assert(ns * per == kThreads, "a chunk fills the CTA");
  constexpr int kWin = 2 * (ns * C::wn > T::wn ? ns * C::wn : T::wn);
  constexpr int kHor = 2 * (ns * C::hn > T::hn ? ns * C::hn : T::hn);
  constexpr int kPhases = 4;                  // filter phases
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_win[kWin];
  __shared__ int s_hor[kHor];
  __shared__ Slot s_slot[2 * ns];
  __shared__ int s_row[2][ns * kFields];      // this chunk's, the next's
  __shared__ int s_cell[2][ns];               // tile cell -> chunk row
  __shared__ unsigned s_vote[3][kWarps];
  __shared__ int s_taps[TAPS * kPhases];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t < TAPS * kPhases) s_taps[t] = kLumaFilter[t / TAPS][t % TAPS];
  const int headroom = max(2, kIfPrec - bd), maxs = (1 << bd) - 1;
  const int s1 = 6 - headroom, o1 = -(kIfOffs << s1);
  const long long plane = (long long)H * W;
  // list l's slot for a window at (y0, x0) - half of row q
  auto make_slot = [&](const int* q, int l, int y0, int x0) {
    const int mx = q[kMv0x + 2 * l], my = q[kMv0y + 2 * l];
    return Slot{y0 + (my >> kFb) - half, x0 + (mx >> kFb) - half,
                clampi(q[kSel0 + l], 0, R - 1),
                (int)uses(q[kDir], l) | (mx & kFrac) << 1 | (my & kFrac) << 5};
  };
  auto direct = [&](const int* q, int l, int y, int x) {
    return predict<TAPS>(refs + clampi(q[kSel0 + l], 0, R - 1) * plane, H,
                         W, y, x, q[kMv0x + 2 * l], q[kMv0y + 2 * l], kFb,
                         kFb, headroom);
  };
  int g = blockIdx.x;
  if (g >= G) return;
  int c0 = grp[g], g1 = min(grp[g + 1], N);   // this chunk, its run's end
  if (c0 >= N) return;                        // runs past the last one
  load_rows(s_row[0], blk, c0, min(ns, g1 - c0));
  cp_async_commit();
  for (int buf = 0;; buf ^= 1) {
    const int n = min(ns, g1 - c0);
    // the next chunk: the rest of this run, or the CTA's next run
    int nc0 = c0 + ns, ng1 = g1;
    if (nc0 >= g1) {
      g += gridDim.x;
      nc0 = N;
      if (g < G) {
        nc0 = grp[g];
        ng1 = min(grp[g + 1], N);
      }
    }
    int* cell = s_cell[buf];
    if (t < ns) cell[t] = -1;
    cp_async_wait<0>();
    __syncthreads();          // the rows have landed, the last chunk is done
    const int* rows = s_row[buf];
    const int* q0 = rows;
    const int ty0 = (q0[kY] >> 4) << 4, tx0 = (q0[kX] >> 4) << 4;
    // does this thread's row sit on the tile's cell grid, share the first
    // row's PU, filter a list both ways
    bool fits = true, same = true, hv = false;
    if (t < n) {
      const int* q = rows + t * kFields;
      const int cy = q[kY] - ty0, cx = q[kX] - tx0;
      fits = q[kB] == q0[kB] && cy >= 0 && cy < kTile && cx >= 0 &&
             cx < kTile && cy % CH == 0 && cx % CW == 0;
      if (fits) cell[(cy / CH) * (kTile / CW) + cx / CW] = t;
      same = q[kDir] == q0[kDir];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (!uses(q[kDir], l)) continue;
        same = same && q[kMv0x + 2 * l] == q0[kMv0x + 2 * l] &&
               q[kMv0y + 2 * l] == q0[kMv0y + 2 * l] &&
               q[kSel0 + l] == q0[kSel0 + l] &&
               (!wp || (q[kW0 + l] == q0[kW0 + l] &&
                        q[kO0 + l] == q0[kO0 + l]));
        hv = hv || ((q[kMv0x + 2 * l] & kFrac) && (q[kMv0y + 2 * l] & kFrac));
      }
    }
    {
      const unsigned vf = __ballot_sync(0xffffffffu, fits);
      const unsigned vs = __ballot_sync(0xffffffffu, same);
      const unsigned vh = __ballot_sync(0xffffffffu, hv);
      if (lane == 0) {
        s_vote[0][warp] = vf;
        s_vote[1][warp] = vs;
        s_vote[2][warp] = vh;
      }
    }
    __syncthreads();
    bool tiled = true, tile_pu = true;
    int cells_hv = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tiled = tiled && s_vote[0][w] == 0xffffffffu;
      tile_pu = tile_pu && s_vote[1][w] == 0xffffffffu;
      cells_hv += __popc(s_vote[2][w]);
    }
    tile_pu = tile_pu && tiled;
    const bool cells = tiled && !tile_pu && cells_hv >= kCellsHv;
    // this thread's sample: on the tile's grid, or of its own row
    int r, y, x, k = 0;
    if (tiled) {
      const int ty = t / kTile, tx = t % kTile;
      k = (ty / CH) * (kTile / CW) + tx / CW;
      r = cell[k];
      y = ty0 + ty;
      x = tx0 + tx;
    } else {
      r = t / per < n ? t / per : -1;
      y = rows[max(r, 0) * kFields + kY] + (t % per) / CW;
      x = rows[max(r, 0) * kFields + kX] + (t % per) % CW;
    }
    const int* q = rows + max(r, 0) * kFields;
    const int b = r >= 0 ? q[kB] : -1;
    // samples past the plane are dropped, as the JAX scatter's mode="drop"
    const bool out = b >= 0 && b < B && y >= 0 && y < Hp && x >= 0 &&
                     x < Wp;
    const long long o = ((long long)b * Hp + y) * Wp + x;
    const int rv = out ? res[o] : 0;          // in flight during the staging
    Slot ts[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) ts[l] = make_slot(q0, l, ty0, tx0);
    auto tile_slot = [&](int l) { return l ? ts[1] : ts[0]; };
    auto cell_slot = [&](int j) { return s_slot[j]; };
    if (cells) {
      if (t < 2 * ns) {
        const int cr = cell[t % ns];
        s_slot[t] = cr >= 0 ? make_slot(rows + cr * kFields, t / ns,
                                        rows[cr * kFields + kY],
                                        rows[cr * kFields + kX])
                            : Slot{0, 0, 0, 0};
      }
      __syncthreads();
      stage<TAPS, CW, CH>(cell_slot, s_win, refs, plane, H, W);
    } else if (tile_pu) {
      stage<TAPS, kTile, kTile>(tile_slot, s_win, refs, plane, H, W);
    }
    cp_async_commit();
    // the next chunk's rows load while this one filters
    if (nc0 < N) load_rows(s_row[buf ^ 1], blk, nc0, min(ns, ng1 - nc0));
    cp_async_commit();
    if (tile_pu || cells) {
      cp_async_wait<1>();
      __syncthreads();
      if (tile_pu)
        horizontal<TAPS, kTile, kTile>(tile_slot, s_win, s_hor, s_taps, o1,
                                       s1);
      else
        horizontal<TAPS, CW, CH>(cell_slot, s_win, s_hor, s_taps, o1, s1);
      __syncthreads();
    }
    if (out) {
      int p[2] = {0, 0};
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (!uses(q[kDir], l)) continue;
        if (tile_pu)
          p[l] = vertical<TAPS, kTile, kTile>(ts[l], l, s_hor, y - ty0,
                                              x - tx0, s_taps, o1, s1,
                                              headroom);
        else if (cells)
          p[l] = vertical<TAPS, CW, CH>(s_slot[l * ns + k], l * ns + k, s_hor,
                                        (y - ty0) % CH, (x - tx0) % CW,
                                        s_taps, o1, s1, headroom);
        else
          p[l] = direct(q, l, y, x);
      }
      stacked[o] = clampi(epilogue(q, p, headroom, maxs, wp, denom) + rv,
                          0, maxs);
    }
    if (nc0 >= N) break;
    c0 = nc0;
    g1 = ng1;
  }
}

// K6 for chroma: one thread a sample of the rows, in any order, with no
// shared memory and no barrier; each field of a row is read where it is
// used.  The tiled forms' per-chunk barriers cost more than the 4 taps
// they save (PERF.md section 6).
template <int CW, int CH>
__global__ void __launch_bounds__(kThreads)
mc_weighted_chroma_kernel(int32_t* __restrict__ stacked,
                          const int32_t* __restrict__ res,
                          const int32_t* __restrict__ refs,
                          const int32_t* __restrict__ blk, int N, int B,
                          int Hp, int Wp, int R, int H, int W, int fbx,
                          int fby, int bd, int wp, int denom) {
  constexpr int per = CW * CH;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)N * per) return;
  const int32_t* q = blk + (gid / per) * kFields;
  const int s = (int)(gid % per);
  const int b = q[kB], y = q[kY] + s / CW, x = q[kX] + s % CW;
  // samples past the plane are dropped, as the JAX scatter's mode="drop"
  if (b < 0 || b >= B || y < 0 || y >= Hp || x < 0 || x >= Wp) return;
  const int headroom = max(2, kIfPrec - bd), maxs = (1 << bd) - 1;
  const long long plane = (long long)H * W;
  int p[2] = {0, 0};
#pragma unroll
  for (int l = 0; l < 2; ++l)
    if (uses(q[kDir], l))
      p[l] = predict<4>(refs + clampi(q[kSel0 + l], 0, R - 1) * plane, H, W,
                        y, x, q[kMv0x + 2 * l], q[kMv0y + 2 * l], fbx, fby,
                        headroom);
  const long long o = ((long long)b * Hp + y) * Wp + x;
  stacked[o] = clampi(epilogue(q, p, headroom, maxs, wp, denom) + res[o],
                      0, maxs);
}

template <int CW, int CH>
void launch_chroma(cudaStream_t s, void* stacked, const void* res,
                   const void* refs, const void* blk, int N, int B, int Hp,
                   int Wp, int R, int H, int W, int fbx, int fby, int bd,
                   int wp, int denom) {
  const long long n = (long long)N * CW * CH;
  mc_weighted_chroma_kernel<CW, CH>
      <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
          (const int32_t*)blk, N, B, Hp, Wp, R, H, W, fbx, fby, bd, wp, denom);
}

}  // namespace

extern "C" int mc_grid(void* stacked, const void* res, const void* refs,
                       const void* mv, const void* dir, const void* sel, int B,
                       int Hp, int Wp, int R, int H, int W, int h4, int w4,
                       int sx, int sy, int taps, int fbx, int fby, int bd,
                       void* stream) {
  if ((long long)B * Hp * Wp == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Wp + kTile - 1) / kTile, (Hp + kTile - 1) / kTile, B);
  auto s = (cudaStream_t)stream;
  const auto args = [&](auto fn) {
    fn(grid, s, stacked, res, refs, mv, dir, sel, Hp, Wp, R, H, W, h4, w4,
       fbx, fby, bd);
  };
  if (taps == 8 && sx == 0 && sy == 0)
    args(launch_grid<8, 4, 4>);
  else if (taps == 4 && sx == 1 && sy == 1)
    args(launch_grid<4, 2, 2>);
  else if (taps == 4 && sx == 1 && sy == 0)
    args(launch_grid<4, 2, 4>);
  else if (taps == 4 && sx == 0 && sy == 0)
    args(launch_grid<4, 4, 4>);
  else if (taps == 4 && sx == 0 && sy == 1)
    args(launch_grid<4, 4, 2>);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// blk: N rows of kFields int32.  Luma (taps 8): the rows in tile order
// and grp, G + 1 int32 tile run starts (ops/interp.py tile_groups); a grid
// of at most kCtasPerSm CTAs an SM (or `ctas`, when > 0) walks the runs.
// Chroma (taps 4): one thread a sample of the rows in any order; grp, G and
// ctas unread.
extern "C" int mc_weighted(void* stacked, const void* res, const void* refs,
                           const void* blk, const void* grp, int N, int G,
                           int B, int Hp, int Wp, int R, int H, int W,
                           int taps, int fbx, int fby, int bd, int wp,
                           int denom, int ctas, void* stream) {
  if (N == 0) return 0;
  auto s = (cudaStream_t)stream;
  if (taps == 8) {
    if (fbx != 2 || fby != 2 || G < 1 || grp == nullptr)
      return (int)cudaErrorInvalidValue;
    constexpr int kCtasPerSm = 8;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int most = ctas > 0 ? ctas : kCtasPerSm * max(sms, 1);
    mc_weighted_luma_kernel<<<max(1, min(G, most)), kThreads, 0, s>>>(
        (int32_t*)stacked, (const int32_t*)res, (const int32_t*)refs,
        (const int32_t*)blk, (const int32_t*)grp, N, G, B, Hp, Wp, R, H, W,
        bd, wp, denom);
    return (int)cudaGetLastError();
  }
  const auto args = [&](auto fn) {
    fn(s, stacked, res, refs, blk, N, B, Hp, Wp, R, H, W, fbx, fby, bd, wp,
       denom);
  };
  const int cw = 4 >> (fbx - 2), ch = 4 >> (fby - 2);
  if (taps != 4)
    return (int)cudaErrorInvalidValue;
  else if (cw == 2 && ch == 2)
    args(launch_chroma<2, 2>);
  else if (cw == 2 && ch == 4)
    args(launch_chroma<2, 4>);
  else if (cw == 4 && ch == 4)
    args(launch_chroma<4, 4>);
  else if (cw == 4 && ch == 2)
    args(launch_chroma<4, 2>);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
