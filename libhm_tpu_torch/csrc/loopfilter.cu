// K3 + K4: the in-loop filters of a reference-DAG level in one launch:
// deblocking (V edges, then H edges) and SAO of every component of every
// picture, each CTA on one tile of one plane staged in shared memory.
//
// Replaces: libhm_tpu/parallel/device_filters.py _filter_fn (its deblock
//   and SAO stages), i.e. libhm_tpu/ops/deblock.py deblock_luma_vertical and
//   deblock_chroma_vertical (V pass, then H pass on the transposed plane)
//   and libhm_tpu/ops/sao.py sao_component (single form, and the multi form
//   with the pairwise slice/tile rules of device_filters.py:169-184).
// What bounds it on the card: bytes.  Each sample is read once and written
//   once as int32 with a few dozen integer operations, plus the per-4x4 and
//   per-CTB maps (~1 MB for a 1080p picture).  Run as one pass per filter
//   and direction, the plane went through DRAM six times in nine launches.
// What the design does about it: one CTA per 32x32 output tile of one
//   plane, over a flat list that covers every component and picture of the
//   level (per-component prefix counts, as K1's flat table), so a level is
//   ONE launch.  The CTA copies the 40x40 window around its tile (apron 4)
//   into shared memory, runs the V edges, the H edges and SAO there, and
//   writes its tile once.  The apron suffices: the owned samples and the
//   one-sample SAO border are written only by the V edges at x0 .. x0+32
//   and the H edges at y0 .. y0+32, which read 4 taps on each side, and a
//   luma segment's decisions read its lines 0 and 3, which lie inside the
//   4-aligned window (tests/test_torch_loop_filter.py checks it on the
//   CPU).  Within a pass, edges are 8 apart and touch disjoint samples, so
//   a pass runs in place in shared memory; a luma line's thread reads lines
//   0 and 3 of its segment, so every thread of a pass reads before a
//   barrier and writes after it.  Taps are read in a row from the window;
//   left of and above the picture the window holds copies of column and
//   row 0 (refreshed from the V-filtered row 0 before the H pass), which
//   is what the per-pass kernels' clamp read (only the left/top picture
//   edge ever clamps), and taps outside the plane are never written.  The kernel
//   reads the input planes and writes new ones, so no CTA reads what
//   another wrote, and the input stays the pre-deblock plane that the
//   restore (K8) reads.  The maps are read in place at their offsets in the
//   level's one packed upload, with strides, so no per-component copy is
//   made.  Every global read of a CTA (each thread's V and H edge: bs,
//   qp and offsets or chroma tc; the SAO parameters of the tile's CTBs;
//   the window) is issued before its first shared-memory store, so the
//   CTA waits on one round of reads, not one per pass; registers are
//   held to 40 a thread so that six CTAs share an SM and hide each
//   other's waits.  The single-pass entry points (deblock_luma, deblock_chroma,
//   deblock_chroma16, sao_apply, sao_apply_multi) launch the same kernel
//   with a one-pass mask on one plane.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;               // owned tile side
constexpr int A = 4;                // apron
constexpr int S = T + 2 * A;        // window side
constexpr int LD = S + 1;           // shared row stride (odd: no bank
                                    // conflicts between V-pass lines)
constexpr int NE = T / 8 + 1;       // edges of one direction in a window
constexpr int THREADS = 256;
static_assert(NE * S <= THREADS, "one edge line per thread");

enum { PASS_V = 1, PASS_H = 2, PASS_SAO = 4 };

__constant__ int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,  3,  3,  3,  3,  4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
// EO class neighbour offsets (dy1, dx1, dy2, dx2), indexed by type - 1
__constant__ int kEoNb[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// The host descriptor: int64 fields in the order of ops/loopfilter.py
// DESC_FIELDS (pointers as integers, 0 = absent).
struct DescComp {
  long long in, out, Hp, Wp, W, H, sx, sy, luma, bd, log2cx, log2cy, ctc_off,
      sao_off, scale;
};
struct Desc {
  long long ncomp, B, mask, multi, ctc16, h4, w4, hc, wc, log2_ctb;
  long long bsn[2], qp[2], bo[2], to[2], ctc[2], ctc_pic;
  long long sao_t, sao_b, sao_o, sao_pic, sao_ctu;
  long long s4, lf4, tm, lft;
  DescComp comp[3];
};

struct Comp {
  const int32_t* in;
  int32_t* out;
  int Hp, Wp, W, H, sx, sy, luma, bd, log2cx, log2cy;
  long long ctc_off;
  int sao_off;
  const int32_t* scale;
  int tx, tpp, begin;               // tiles per row, per picture; first CTA
};

template <typename TC>
struct Params {
  Comp comp[3];
  int ncomp, mask, h4, w4, hc, wc, log2_ctb;
  const uint8_t* bsn[2];
  const int8_t* qp[2];
  const int8_t* bo[2];
  const int8_t* to[2];
  const TC* ctc[2];
  long long ctc_pic, sao_pic;
  int sao_ctu;
  const int8_t *sao_t, *sao_b, *sao_o;
  const int16_t* s4;
  const uint8_t* lf4;
  const int16_t* tm;
  const uint8_t* lft;
};

// One thread's line of an edge pass and the map values that decide it,
// fetched before the window load so that every map read of the CTA
// overlaps that one load.  ok: the line lies in the plane and its edge is
// filtered (bs != 0 for luma, tc != 0 for chroma).
struct Edge {
  int ok, line, e, no_p, no_q, bs, qp, bo, to, tc;
};

// The thread's line (a window row for a vertical pass, a window column
// for a horizontal one) and edge (a plane column / row); false if there is
// none.
__device__ __forceinline__ bool edge_of(const Comp& q, int y0, int x0,
                                        bool vertical, int& line, int& gl,
                                        int& e) {
  const int w = threadIdx.x;
  if (w >= NE * S) return false;
  line = w % S;
  gl = (vertical ? y0 : x0) - A + line;
  e = (vertical ? x0 : y0) + 8 * (w / S);
  return gl >= 0 && gl < (vertical ? q.Hp : q.Wp) &&
         e < (vertical ? q.Wp : q.Hp);
}

template <typename TC>
__device__ __forceinline__ Edge fetch_edge(const Params<TC>& p,
                                           const Comp& q, int b, int y0,
                                           int x0, bool vertical) {
  Edge it;
  it.ok = 0;
  int line, gl, e;
  if (!edge_of(q, y0, x0, vertical, line, gl, e)) return it;
  it.line = line;
  it.e = e;
  const int k = e >> 3, d = vertical ? 0 : 1;
  const long long mb = (long long)b * p.h4 * p.w4;
  long long cell;
  if (q.luma) {
    const int m = gl >> 2;
    cell = vertical ? (long long)m * p.w4 + 2 * k
                    : (long long)(2 * k) * p.w4 + m;
  } else {
    // chroma: tc per luma 4x4 of the line's position on the edge
    const int row4 = vertical ? gl >> (2 - q.sy) : k << (1 + q.sy);
    const int col4 = vertical ? k << (1 + q.sx) : gl >> (2 - q.sx);
    cell = (long long)row4 * p.w4 + col4;
  }
  // every read issued at once, none waiting on another
  const int bsn = p.bsn[d][mb + cell];
  if (q.luma) {
    it.qp = p.qp[d][mb + cell];
    it.bo = p.bo[d] ? p.bo[d][mb + cell] : 0;
    it.to = p.to[d] ? p.to[d][mb + cell] : 0;
    it.tc = 0;
  } else {
    it.tc = p.ctc[d][(long long)b * p.ctc_pic + q.ctc_off + cell];
  }
  it.bs = bsn & 3;
  it.no_p = (bsn & 16) != 0;
  it.no_q = (bsn & 32) != 0;
  it.ok = q.luma ? it.bs != 0 : it.tc != 0;
  return it;
}

// One thread's writes of an edge pass, held over the barrier: taps 1..6 of
// the line at base + j * ts (luma p2 .. q2; chroma uses 1 and 2: p0, q0).
struct Pending {
  int base, ts, bits;
  int v[6];
};

// Decisions and filtering of the thread's line of an edge (read phase
// only), from the shared window and the fetched map values.  The taps
// are read in a row from the window: left of and above the picture the
// window holds copies of column / row 0 (the clamped taps), so no tap
// index is clamped here.
template <bool VERT>
__device__ __forceinline__ Pending edge_line(const Comp& q, const Edge& it,
                                             const int32_t* tile, int y0,
                                             int x0) {
  constexpr int ts = VERT ? 1 : LD;             // tap stride in the window
  constexpr int ls = VERT ? LD : 1;             // line stride
  Pending pd;
  pd.bits = 0;
  if (!it.ok) return pd;
  const int line = it.line, e = it.e;
  const int ti = e - (VERT ? x0 : y0);          // window index of tap e - 4
  const int32_t* r = tile + line * ls + ti * ts;
  const int maxv = (1 << q.bd) - 1;
  if (q.luma) {
    const int bd_shift = q.bd - 8;
    const int beta = kBeta[clip3(0, 51, it.qp + it.bo)] << bd_shift;
    const int tc = kTc[clip3(0, 53, it.qp + 2 * (it.bs - 1) + it.to)]
                   << bd_shift;
    // the segment's lines 0 and 3 (decisions), and this line
    const int32_t* r0 = r - (line & 3) * ls;
    const int32_t* r3 = r0 + 3 * ls;
    int s0[8], s3[8], s[8];
    for (int t = 0; t < 8; ++t) {
      s0[t] = r0[t * ts];
      s3[t] = r3[t * ts];
      s[t] = r[t * ts];
    }
    const int dp0 = abs(s0[1] - 2 * s0[2] + s0[3]);
    const int dq0 = abs(s0[6] - 2 * s0[5] + s0[4]);
    const int dp3 = abs(s3[1] - 2 * s3[2] + s3[3]);
    const int dq3 = abs(s3[6] - 2 * s3[5] + s3[4]);
    const int d0 = dp0 + dq0, d3 = dp3 + dq3;
    if (!(d0 + d3 < beta)) return pd;
    auto strong = [&](const int* v, int di) {
      return 2 * di < (beta >> 2) &&
             abs(v[0] - v[3]) + abs(v[4] - v[7]) < (beta >> 3) &&
             abs(v[3] - v[4]) < ((tc * 5 + 1) >> 1);
    };
    const bool sw = strong(s0, d0) && strong(s3, d3);
    const int side_thr = (beta + (beta >> 1)) >> 3;
    const bool filt_p2 = dp0 + dp3 < side_thr;
    const bool filt_q2 = dq0 + dq3 < side_thr;
    const int tc2 = tc >> 1;
    const int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3];
    const int q0 = s[4], q1 = s[5], q2 = s[6], q3 = s[7];
    int o[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
    if (sw) {
      o[3] = clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      o[2] = clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2);
      o[1] = clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      o[4] = clip3(q0 - 2 * tc, q0 + 2 * tc, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
      o[5] = clip3(q1 - 2 * tc, q1 + 2 * tc, (q2 + q1 + q0 + p0 + 2) >> 2);
      o[6] = clip3(q2 - 2 * tc, q2 + 2 * tc, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (!(abs(delta) < 10 * tc)) return pd;
      const int dlt = clip3(-tc, tc, delta);
      o[3] = clip3(0, maxv, p0 + dlt);
      o[4] = clip3(0, maxv, q0 - dlt);
      if (filt_p2)
        o[2] = clip3(0, maxv, p1 + clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
      if (filt_q2)
        o[5] = clip3(0, maxv, q1 + clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1));
    }
    pd.base = line * ls + ti * ts;
    pd.ts = ts;
    for (int t = 1; t < 7; ++t) {
      if ((t < 4 && it.no_p) || (t >= 4 && it.no_q)) continue;
      if (e - 4 + t < 0) continue;             // left of / above the picture
      pd.v[t - 1] = o[t];
      pd.bits |= 1 << t;
    }
    return pd;
  }
  // chroma: one line of an 8-sample edge, taps e-2 .. e+1
  const int tc = it.tc;
  const int p1 = r[2 * ts], p0 = r[3 * ts], q0 = r[4 * ts], q1 = r[5 * ts];
  const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + p1 - q1 + 4) >> 3);
  pd.base = line * ls + (ti + 2) * ts;
  pd.ts = ts;
  if (!it.no_p && e > 0) {
    pd.v[0] = clip3(0, maxv, p0 + delta);
    pd.bits |= 1 << 1;
  }
  if (!it.no_q) {
    pd.v[1] = clip3(0, maxv, q0 - delta);
    pd.bits |= 1 << 2;
  }
  return pd;
}

template <bool VERT>
__device__ __forceinline__ void edge_pass(const Comp& q, const Edge& it,
                                          int32_t* tile, int y0, int x0) {
  const Pending pd = edge_line<VERT>(q, it, tile, y0, x0);
  __syncthreads();                              // every read before a write
  if (pd.bits)
    for (int t = 1; t < 7; ++t)
      if (pd.bits & (1 << t)) tile[pd.base + t * pd.ts] = pd.v[t - 1];
  __syncthreads();
}

// Slice index, loop-filter-across flag and tile index at sample (y, x) of
// a component plane (multi form): the per-4x4 and per-CTB luma-grid maps
// at the sample's luma position, each clamped to its grid.
struct Site {
  int s, lf, t;
};

template <typename TC>
__device__ __forceinline__ Site site(const Params<TC>& p, const Comp& q,
                                     int b, int y, int x) {
  const int ly = y << q.sy, lx = x << q.sx;
  const int y4 = min(ly >> 2, p.h4 - 1), x4 = min(lx >> 2, p.w4 - 1);
  const int yc = min(ly >> p.log2_ctb, p.hc - 1);
  const int xc = min(lx >> p.log2_ctb, p.wc - 1);
  const long long i4 = ((long long)b * p.h4 + y4) * p.w4 + x4;
  return {p.s4[i4], p.lf4[i4], p.tm[((long long)b * p.hc + yc) * p.wc + xc]};
}

// neighbour usable: same slice or both filter across slices, and same
// tile or loop_filter_across_tiles (Rec. 8.7.3)
__device__ __forceinline__ bool pair_ok(const Site& a, const Site& n,
                                        int lft) {
  return (a.s == n.s || (a.lf && n.lf)) && (a.t == n.t || lft);
}

// The SAO parameters of the CTBs a tile covers (at most 4 x 4: a CTB is
// at least 8 samples of a component each way), staged in shared memory
// before the window load.
constexpr int MAXC = T / 8;
struct SaoCtbs {
  int8_t t[MAXC * MAXC], band[MAXC * MAXC], o[MAXC * MAXC][4];
};

// SAO of the sample at window position (ly, lx), plane position (y, x).
template <typename TC, bool MULTI>
__device__ __forceinline__ int sao_sample(const Params<TC>& p, const Comp& q,
                                          const int32_t* tile,
                                          const SaoCtbs& sc, int mul, int b,
                                          int y, int x, int ly, int lx,
                                          int y0, int x0) {
  const int src = tile[ly * LD + lx];
  if (y >= q.H || x >= q.W) return src;
  const int ci = ((y >> q.log2cy) - (y0 >> q.log2cy)) * MAXC +
                 (x >> q.log2cx) - (x0 >> q.log2cx);
  const int t = sc.t[ci];
  if (t < 0) return src;
  const int8_t* o = sc.o[ci];
  int delta = 0;
  if (t == 0) {                                   // band offset
    const int rel = ((src >> (q.bd - 5)) - sc.band[ci]) & 31;
    if (rel < 4) delta = o[rel] * mul;
  } else {                                        // edge offset, class t-1
    // types above 4 (no stream codes them) take class 3, as the JAX
    // sao_component clamps its EO index
    const int* nb = kEoNb[min(t, 4) - 1];
    const int y1 = y + nb[0], x1 = x + nb[1], y2 = y + nb[2], x2 = x + nb[3];
    // neighbours outside the W x H picture are rejected before any map
    // is read
    bool ok = y1 >= 0 && y1 < q.H && x1 >= 0 && x1 < q.W && y2 >= 0 &&
              y2 < q.H && x2 >= 0 && x2 < q.W;
    if (MULTI && ok) {
      const Site here = site(p, q, b, y, x);
      const int lft = p.lft[b];
      ok = pair_ok(here, site(p, q, b, y1, x1), lft) &&
           pair_ok(here, site(p, q, b, y2, x2), lft);
    }
    if (ok) {
      const int cat = 2 + sgn(src - tile[(ly + nb[0]) * LD + lx + nb[1]]) +
                      sgn(src - tile[(ly + nb[2]) * LD + lx + nb[3]]);
      // category 0, 1, (2: none), 3, 4 -> offsets 0, 1, 2, 3
      if (cat != 2) delta = o[cat < 2 ? cat : cat - 1] * mul;
    }
  }
  return clip3(0, (1 << q.bd) - 1, src + delta);
}

template <typename TC, bool MULTI>
__global__ void __launch_bounds__(THREADS, 6)
    loop_filter_kernel(const __grid_constant__ Params<TC> p) {
  __shared__ int32_t tile[S * LD];
  __shared__ SaoCtbs sc;
  const int bid = blockIdx.x;
  int c = 0;
  while (c + 1 < p.ncomp && bid >= p.comp[c + 1].begin) ++c;
  const Comp& q = p.comp[c];
  const int local = bid - q.begin;
  const int b = local / q.tpp, t = local % q.tpp;
  const int y0 = t / q.tx * T, x0 = t % q.tx * T;
  const long long pb = (long long)b * q.Hp * q.Wp;
  // every map read first, then the window (clamped to the plane): all
  // of the CTA's global reads are in flight together
  Edge ev, eh;
  ev.ok = eh.ok = 0;
  if (p.mask & PASS_V) ev = fetch_edge<TC>(p, q, b, y0, x0, true);
  if (p.mask & PASS_H) eh = fetch_edge<TC>(p, q, b, y0, x0, false);
  // the SAO parameters of the tile's CTBs (into registers here, into
  // shared memory once the window's loads are issued)
  int mul = 1, sao_i = -1, st = 0, sb = 0, so[4] = {0, 0, 0, 0};
  if (p.mask & PASS_SAO) {
    const int i = threadIdx.x;
    const int cy = (y0 >> q.log2cy) + i / MAXC;
    const int cx = (x0 >> q.log2cx) + i % MAXC;
    if (i < MAXC * MAXC && cy < p.hc && cx < p.wc) {
      const long long k = (long long)b * p.sao_pic +
          ((long long)cy * p.wc + cx) * p.sao_ctu + q.sao_off;
      sao_i = i;
      st = p.sao_t[k];
      sb = p.sao_b[k];
      for (int j = 0; j < 4; ++j) so[j] = p.sao_o[k * 4 + j];
    }
    mul = 1 << q.scale[b];
  }
  // the window in groups of 4 samples, 16-byte loads where the plane's
  // rows allow them; every load issued before the first store
  constexpr int GROUPS = S * (S / 4);
  constexpr int PER = (GROUPS + THREADS - 1) / THREADS;
  const bool vec = (q.Wp & 3) == 0 && ((uintptr_t)q.in & 15) == 0;
  int4 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i >= GROUPS) break;
    const int ly = i / (S / 4), gx = x0 - A + i % (S / 4) * 4;
    const int32_t* row =
        q.in + pb + (long long)clip3(0, q.Hp - 1, y0 - A + ly) * q.Wp;
    if (vec && gx >= 0 && gx + 3 < q.Wp) {
      v[k] = *reinterpret_cast<const int4*>(row + gx);
    } else {
      v[k].x = row[clip3(0, q.Wp - 1, gx)];
      v[k].y = row[clip3(0, q.Wp - 1, gx + 1)];
      v[k].z = row[clip3(0, q.Wp - 1, gx + 2)];
      v[k].w = row[clip3(0, q.Wp - 1, gx + 3)];
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i >= GROUPS) break;
    int32_t* d = tile + i / (S / 4) * LD + i % (S / 4) * 4;
    d[0] = v[k].x;
    d[1] = v[k].y;
    d[2] = v[k].z;
    d[3] = v[k].w;
  }
  if (sao_i >= 0) {
    sc.t[sao_i] = st;
    sc.band[sao_i] = sb;
    for (int j = 0; j < 4; ++j) sc.o[sao_i][j] = so[j];
  }
  __syncthreads();
  if (p.mask & PASS_V) {
    edge_pass<true>(q, ev, tile, y0, x0);
    // the H pass reads the rows above the picture as copies of the
    // V-filtered row 0
    if (y0 == 0 && (p.mask & PASS_H)) {
      for (int i = threadIdx.x; i < A * S; i += THREADS)
        tile[i / S * LD + i % S] = tile[A * LD + i % S];
      __syncthreads();
    }
  }
  if (p.mask & PASS_H) edge_pass<false>(q, eh, tile, y0, x0);
  // SAO of the owned samples from the deblocked window, one coalesced
  // write of the tile: a warp per row, each thread down one column
  static_assert(T == 32, "a warp per tile row");
  const int ox = threadIdx.x & 31, x = x0 + ox;
  if (x >= q.Wp) return;
  constexpr int ROWS = THREADS / T;
  int32_t* o = q.out + pb + (long long)(y0 + threadIdx.x / T) * q.Wp + x;
  for (int oy = threadIdx.x / T; oy < T; oy += ROWS, o += ROWS * q.Wp) {
    const int y = y0 + oy;
    if (y >= q.Hp) break;
    *o = (p.mask & PASS_SAO)
        ? sao_sample<TC, MULTI>(p, q, tile, sc, mul, b, y, x, oy + A,
                                ox + A, y0, x0)
        : tile[(oy + A) * LD + ox + A];
  }
}

template <typename TC>
int launch_typed(const Desc& d, void* stream) {
  Params<TC> p;
  memset(&p, 0, sizeof p);
  p.ncomp = (int)d.ncomp;
  p.mask = (int)d.mask;
  p.h4 = (int)d.h4;
  p.w4 = (int)d.w4;
  p.hc = (int)d.hc;
  p.wc = (int)d.wc;
  p.log2_ctb = (int)d.log2_ctb;
  for (int i = 0; i < 2; ++i) {
    p.bsn[i] = (const uint8_t*)d.bsn[i];
    p.qp[i] = (const int8_t*)d.qp[i];
    p.bo[i] = (const int8_t*)d.bo[i];
    p.to[i] = (const int8_t*)d.to[i];
    p.ctc[i] = (const TC*)d.ctc[i];
  }
  p.ctc_pic = d.ctc_pic;
  p.sao_pic = d.sao_pic;
  p.sao_ctu = (int)d.sao_ctu;
  p.sao_t = (const int8_t*)d.sao_t;
  p.sao_b = (const int8_t*)d.sao_b;
  p.sao_o = (const int8_t*)d.sao_o;
  p.s4 = (const int16_t*)d.s4;
  p.lf4 = (const uint8_t*)d.lf4;
  p.tm = (const int16_t*)d.tm;
  p.lft = (const uint8_t*)d.lft;
  long long ctas = 0;
  for (int c = 0; c < p.ncomp; ++c) {
    const DescComp& s = d.comp[c];
    Comp& q = p.comp[c];
    q.in = (const int32_t*)s.in;
    q.out = (int32_t*)s.out;
    q.Hp = (int)s.Hp;
    q.Wp = (int)s.Wp;
    q.W = (int)s.W;
    q.H = (int)s.H;
    q.sx = (int)s.sx;
    q.sy = (int)s.sy;
    q.luma = (int)s.luma;
    q.bd = (int)s.bd;
    q.log2cx = (int)s.log2cx;
    q.log2cy = (int)s.log2cy;
    q.ctc_off = s.ctc_off;
    q.sao_off = (int)s.sao_off;
    q.scale = (const int32_t*)s.scale;
    if ((d.mask & PASS_SAO) && (q.log2cx < 3 || q.log2cy < 3))
      return (int)cudaErrorInvalidValue;
    q.tx = (q.Wp + T - 1) / T;
    q.tpp = q.tx * ((q.Hp + T - 1) / T);
    q.begin = (int)ctas;
    ctas += d.B * q.tpp;
  }
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (d.multi)
    loop_filter_kernel<TC, true><<<(unsigned)ctas, THREADS, 0,
                                   (cudaStream_t)stream>>>(p);
  else
    loop_filter_kernel<TC, false><<<(unsigned)ctas, THREADS, 0,
                                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const long long* desc, int n, void* stream) {
  Desc d;
  if (n * sizeof(long long) != sizeof d) return (int)cudaErrorInvalidValue;
  memcpy(&d, desc, sizeof d);
  if (d.ncomp < 1 || d.ncomp > 3) return (int)cudaErrorInvalidValue;
  return d.ctc16 ? launch_typed<int16_t>(d, stream)
                 : launch_typed<uint8_t>(d, stream);
}

}  // namespace

// One entry point per caller, each its own launch count on the Python
// side; all launch the same kernel from the same descriptor.
extern "C" int loop_filter_level(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
extern "C" int deblock_luma(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
extern "C" int deblock_chroma(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
extern "C" int deblock_chroma16(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
extern "C" int sao_apply(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
extern "C" int sao_apply_multi(const long long* desc, int n, void* stream) {
  return launch(desc, n, stream);
}
