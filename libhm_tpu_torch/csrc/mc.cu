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
// K6 computes each sample directly (predict<TAPS>: every tap's coordinate
//   clamped, read through __ldg), one thread per sample of its 4x4 blocks.
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
// only the samples that direction's copy reads.
template <int TAPS, int SW, int SH, class Get>
__device__ __forceinline__ void stage(Get slot, int* win,
                                      const int32_t* __restrict__ refs,
                                      long long plane, int H, int W) {
  using G = Geom<TAPS, SW, SH>;
  for (int e = threadIdx.x; e < 2 * G::ns * G::wn; e += kThreads) {
    const int k = e / G::wn, rem = e - k * G::wn;
    const int r = rem / G::ww, c = rem - r * G::ww;
    const Slot s = slot(k);
    if (!(s.f & 1)) continue;
    if ((!(s.f & 0x1e) && (c < G::half || c >= G::half + SW)) ||
        (!(s.f >> 5) && (r < G::half || r >= G::half + SH)))
      continue;
    const int gy = clampi(s.iy + r, 0, H - 1), gx = clampi(s.ix + c, 0, W - 1);
    cp_async4(win + e, refs + s.ref * plane + (long long)gy * W + gx);
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
    const int pred = d == 3 ? bi_average(p[0], p[1], bd, maxs)
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
    const int pred = d == 3 ? bi_average(p[0], p[1], bd, maxs)
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
