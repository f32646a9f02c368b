// K4: sample adaptive offset, one component.
//
// Replaces: libhm_tpu/ops/sao.py sao_component as
//   libhm_tpu/parallel/device_filters.py _filter_fn runs it: with
//   multi=False (valid_mask all true: only the picture bounds limit edge
//   offsets; entry point sao_apply) and with multi=True (the pairwise
//   slice/tile rules of device_filters.py:169-184; entry point
//   sao_apply_multi).
// What bounds it on the card: bytes.  Each sample is read (plus two
//   neighbours that mostly hit cache) and written once as int32, with ~20
//   integer ops, so the pass streams the plane through DRAM.
// What the design does about it: one thread per sample, neighbouring
//   threads on neighbouring samples (coalesced), the per-CTU parameters read
//   straight from the int8 maps (they stay in L1/L2), and no 5-slot LUT or
//   per-sample parameter planes.  Edge offset reads neighbours, so the
//   kernel reads the deblocked plane and writes a separate output.
//   The multi form reads the slice/tile maps where JAX expands them to
//   per-sample [Hp, Wp] planes: for the sample and each EO neighbour that
//   lies inside the W x H picture, the per-4x4 slice index (int16) and
//   loop-filter-across-slices flag (uint8) at ((y << sy) >> 2, (x << sx)
//   >> 2) and the per-CTB tile index (int16) at ((y << sy) >> log2_ctb,
//   (x << sx) >> log2_ctb), each clamped to its grid, as the JAX index
//   arithmetic clamps them at the padded bottom and right.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// EO class neighbour offsets (dy1, dx1, dy2, dx2), indexed by type - 1
__constant__ int kEoNb[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// The slice/tile maps of one picture (multi form only).
struct Maps {
  const int16_t* s4;    // [B, h4, w4] slice index per 4x4 (luma grid)
  const uint8_t* lf4;   // [B, h4, w4] loop filter across slices
  const int16_t* tm;    // [B, hc, wc] tile index per CTB
  const uint8_t* lft;   // [B] loop_filter_across_tiles
  int h4, w4, sx, sy, log2_ctb;
};

struct Site {
  int s, lf, t;
};

__device__ __forceinline__ Site site(const Maps& m, int b, int hc, int wc,
                                     int y, int x) {
  const int ly = y << m.sy, lx = x << m.sx;
  const int y4 = min(ly >> 2, m.h4 - 1), x4 = min(lx >> 2, m.w4 - 1);
  const int yc = min(ly >> m.log2_ctb, hc - 1);
  const int xc = min(lx >> m.log2_ctb, wc - 1);
  const long long i4 = ((long long)b * m.h4 + y4) * m.w4 + x4;
  return {m.s4[i4], m.lf4[i4],
          m.tm[((long long)b * hc + yc) * wc + xc]};
}

// neighbour usable: same slice or both filter across slices, and same
// tile or loop_filter_across_tiles (Rec. 8.7.3)
__device__ __forceinline__ bool pair_ok(const Site& a, const Site& n,
                                        int lft) {
  return (a.s == n.s || (a.lf && n.lf)) && (a.t == n.t || lft);
}

template <bool MULTI>
__global__ void sao_kernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ out,
                           const int8_t* __restrict__ type,
                           const int8_t* __restrict__ band,
                           const int8_t* __restrict__ offs,
                           const int32_t* __restrict__ scale, Maps maps,
                           int B, int Hp, int Wp, int hc, int wc, int log2cx,
                           int log2cy, int bd, int W, int H) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * Hp * Wp) return;
  const int x = (int)(gid % Wp);
  const int y = (int)((gid / Wp) % Hp);
  const int b = (int)(gid / ((long long)Hp * Wp));
  const int src = in[gid];
  const long long ctu = ((long long)b * hc + (y >> log2cy)) * wc + (x >> log2cx);
  const int t = type[ctu];
  if (y >= H || x >= W || t < 0) {
    out[gid] = src;
    return;
  }
  const int8_t* o = offs + ctu * 4;
  const int mul = 1 << scale[b];
  int delta = 0;
  if (t == 0) {                                   // band offset
    const int rel = ((src >> (bd - 5)) - band[ctu]) & 31;
    if (rel < 4) delta = o[rel] * mul;
  } else {                                        // edge offset, class t-1
    // types above 4 (no stream codes them) take class 3, as the JAX
    // sao_component clamps its EO index
    const int* nb = kEoNb[min(t, 4) - 1];
    const int y1 = y + nb[0], x1 = x + nb[1], y2 = y + nb[2], x2 = x + nb[3];
    // neighbours outside the W x H picture are rejected before any map
    // is read
    bool ok = y1 >= 0 && y1 < H && x1 >= 0 && x1 < W && y2 >= 0 && y2 < H &&
              x2 >= 0 && x2 < W;
    if (MULTI && ok) {
      const Site here = site(maps, b, hc, wc, y, x);
      const int lft = maps.lft[b];
      ok = pair_ok(here, site(maps, b, hc, wc, y1, x1), lft) &&
           pair_ok(here, site(maps, b, hc, wc, y2, x2), lft);
    }
    if (ok) {
      const long long pb = (long long)b * Hp * Wp;
      const int cat = 2 + sgn(src - in[pb + (long long)y1 * Wp + x1]) +
                      sgn(src - in[pb + (long long)y2 * Wp + x2]);
      // category 0, 1, (2: none), 3, 4 -> offsets 0, 1, 2, 3
      if (cat != 2) delta = o[cat < 2 ? cat : cat - 1] * mul;
    }
  }
  const int maxv = (1 << bd) - 1;
  const int v = src + delta;
  out[gid] = v < 0 ? 0 : (v > maxv ? maxv : v);
}

template <bool MULTI>
int launch(const void* in, void* out, const void* type, const void* band,
           const void* offs, const void* scale, const Maps& maps, int B,
           int Hp, int Wp, int hc, int wc, int log2cx, int log2cy, int bd,
           int W, int H, void* stream) {
  const long long n = (long long)B * Hp * Wp;
  if (n == 0) return 0;
  const int threads = 256;
  sao_kernel<MULTI><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (const int8_t*)type,
      (const int8_t*)band, (const int8_t*)offs, (const int32_t*)scale, maps,
      B, Hp, Wp, hc, wc, log2cx, log2cy, bd, W, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sao_apply(const void* in, void* out, const void* type,
                         const void* band, const void* offs, const void* scale,
                         int B, int Hp, int Wp, int hc, int wc, int log2cx,
                         int log2cy, int bd, int W, int H, void* stream) {
  const Maps none = {nullptr, nullptr, nullptr, nullptr, 1, 1, 0, 0, 0};
  return launch<false>(in, out, type, band, offs, scale, none, B, Hp, Wp, hc,
                       wc, log2cx, log2cy, bd, W, H, stream);
}

extern "C" int sao_apply_multi(const void* in, void* out, const void* type,
                               const void* band, const void* offs,
                               const void* scale, const void* s4,
                               const void* lf4, const void* tm,
                               const void* lft, int B, int Hp, int Wp, int hc,
                               int wc, int log2cx, int log2cy, int bd, int W,
                               int H, int h4, int w4, int sx, int sy,
                               int log2_ctb, void* stream) {
  const Maps maps = {(const int16_t*)s4, (const uint8_t*)lf4,
                     (const int16_t*)tm, (const uint8_t*)lft,
                     h4, w4, sx, sy, log2_ctb};
  return launch<true>(in, out, type, band, offs, scale, maps, B, Hp, Wp, hc,
                      wc, log2cx, log2cy, bd, W, H, stream);
}
