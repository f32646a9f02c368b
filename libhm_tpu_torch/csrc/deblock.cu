// K3: deblocking, luma and chroma, one edge direction per launch.
//
// Replaces: libhm_tpu/ops/deblock.py deblock_luma_vertical and
//   deblock_chroma_vertical, as driven by
//   libhm_tpu/parallel/device_filters.py _filter_fn (V pass, then H pass on
//   the transposed plane).
// What bounds it on the card: bytes.  Each edge segment reads 8 samples per
//   line and writes at most 6, with a few dozen integer ops per line, so a
//   pass is a streaming read-modify-write of the plane (~4 MB of int32 luma
//   per 1080p picture) plus the per-4x4 maps.
// What the design does about it: no transpose and no gather copy; the H
//   pass addresses the plane through strides (line stride 1, tap stride
//   W) and the per-4x4 maps are read in place (uint8/int8, no widening).
//   Luma: one thread per 4-line edge segment (its decisions use lines 0 and
//   3).  Chroma: one thread per line of an 8-sample edge; the tc map is
//   uint8 up to 11-bit chroma and int16 above (tc reaches 24 << 4 at 12
//   bits), one template and one entry point per type.  Within a pass,
//   edge k reads taps 8k-4 .. 8k+3 and writes 8k-3 .. 8k+2 (luma; chroma
//   reads 8k-2 .. 8k+1, writes 8k-1 .. 8k), so no two threads touch the
//   same sample and the plane is updated in place.  Taps left of the
//   picture are clamped to 0 and never written, as in the JAX pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,  3,  3,  3,  3,  4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// plane: [B, H, W]; maps: [B, h4, w4].  vertical: edges at columns 8k,
// segments of rows 4m..4m+3, map entry (m, 2k); horizontal: edges at rows
// 8k, segments of columns 4m..4m+3, map entry (2k, m).
__global__ void deblock_luma_kernel(
    int32_t* __restrict__ plane, const uint8_t* __restrict__ bsn,
    const int8_t* __restrict__ qpm, const int8_t* __restrict__ bom,
    const int8_t* __restrict__ tom, int B, int H, int W, int h4, int w4,
    int vertical, int bd) {
  const int nk = vertical ? W / 8 : H / 8;      // edges
  const int nm = vertical ? H / 4 : W / 4;      // segments per edge
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * nk * nm) return;
  const int m = (int)(gid % nm);
  const int k = (int)((gid / nm) % nk);
  const int b = (int)(gid / ((long long)nm * nk));
  const long long mi = (long long)b * h4 * w4 +
                       (vertical ? (long long)m * w4 + 2 * k
                                 : (long long)(2 * k) * w4 + m);
  const int bs = bsn[mi] & 3;
  if (bs == 0) return;
  const int no_p = (bsn[mi] & 16) != 0, no_q = (bsn[mi] & 32) != 0;
  const int qp = qpm[mi];
  const int bo = bom ? bom[mi] : 0, to = tom ? tom[mi] : 0;
  const int bd_shift = bd - 8, maxv = (1 << bd) - 1;
  const int beta = kBeta[clip3(0, 51, qp + bo)] << bd_shift;
  const int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + to)] << bd_shift;

  const long long pb = (long long)b * H * W;
  const int ext = vertical ? W : H;             // extent along the taps
  const long long line_stride = vertical ? W : 1;
  const long long tap_stride = vertical ? 1 : W;
  int s[4][8];
  long long addr[4][8];
  for (int i = 0; i < 4; ++i) {
    const long long lb = pb + (long long)(4 * m + i) * line_stride;
    for (int j = 0; j < 8; ++j) {
      const int tap = clip3(0, ext - 1, 8 * k - 4 + j);
      addr[i][j] = lb + tap * tap_stride;
      s[i][j] = plane[addr[i][j]];
    }
  }
  // taps: p3 p2 p1 p0 | q0 q1 q2 q3 = s[i][0..7]
  int dp[4], dq[4];
  for (int i = 0; i < 4; ++i) {
    dp[i] = abs(s[i][1] - 2 * s[i][2] + s[i][3]);
    dq[i] = abs(s[i][6] - 2 * s[i][5] + s[i][4]);
  }
  const int d0 = dp[0] + dq[0], d3 = dp[3] + dq[3];
  if (!(d0 + d3 < beta)) return;
  auto strong_row = [&](int i, int di) {
    return 2 * di < (beta >> 2) &&
           abs(s[i][0] - s[i][3]) + abs(s[i][4] - s[i][7]) < (beta >> 3) &&
           abs(s[i][3] - s[i][4]) < ((tc * 5 + 1) >> 1);
  };
  const bool sw = strong_row(0, d0) && strong_row(3, d3);
  const int side_thr = (beta + (beta >> 1)) >> 3;
  const bool filt_p2 = dp[0] + dp[3] < side_thr;
  const bool filt_q2 = dq[0] + dq[3] < side_thr;
  const int tc2 = tc >> 1;
  for (int i = 0; i < 4; ++i) {
    const int p3 = s[i][0], p2 = s[i][1], p1 = s[i][2], p0 = s[i][3];
    const int q0 = s[i][4], q1 = s[i][5], q2 = s[i][6], q3 = s[i][7];
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
      if (abs(delta) < 10 * tc) {
        const int dlt = clip3(-tc, tc, delta);
        o[3] = clip3(0, maxv, p0 + dlt);
        o[4] = clip3(0, maxv, q0 - dlt);
        if (filt_p2)
          o[2] = clip3(0, maxv, p1 + clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1));
        if (filt_q2)
          o[5] = clip3(0, maxv, q1 + clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1));
      }
    }
    for (int j = 1; j < 7; ++j) {
      if ((j < 4 && no_p) || (j >= 4 && no_q)) continue;
      if (8 * k - 4 + j < 0) continue;          // left of the picture
      plane[addr[i][j]] = o[j];
    }
  }
}

// plane: [B, Hc, Wc]; ctc: [B, h4, w4] tc per luma 4x4 (0 = not filtered);
// bsn: [B, h4, w4] (no_p bit 16, no_q bit 32).  One thread per line r and
// edge k; vertical: line = row r, edge column 8k; horizontal: line =
// column r, edge row 8k.
template <typename TC>
__global__ void deblock_chroma_kernel(
    int32_t* __restrict__ plane, const TC* __restrict__ ctc,
    const uint8_t* __restrict__ bsn, int B, int H, int W, int h4, int w4,
    int vertical, int ssx, int ssy, int bd) {
  const int nk = vertical ? W / 8 : H / 8;
  const int nr = vertical ? H : W;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * nk * nr) return;
  const int r = (int)(gid % nr);
  const int k = (int)((gid / nr) % nk);
  const int b = (int)(gid / ((long long)nr * nk));
  const int row4 = vertical ? r >> (2 - ssy) : k << (1 + ssy);
  const int col4 = vertical ? k << (1 + ssx) : r >> (2 - ssx);
  const long long mi = (long long)b * h4 * w4 + (long long)row4 * w4 + col4;
  const int tc = ctc[mi];
  if (tc == 0) return;
  const int no_p = (bsn[mi] & 16) != 0, no_q = (bsn[mi] & 32) != 0;
  const int maxv = (1 << bd) - 1;
  const long long pb = (long long)b * H * W;
  const int ext = vertical ? W : H;
  const long long lb = pb + (long long)r * (vertical ? W : 1);
  const long long ts = vertical ? 1 : W;
  auto at = [&](int tap) { return lb + clip3(0, ext - 1, tap) * ts; };
  const int p1 = plane[at(8 * k - 2)], p0 = plane[at(8 * k - 1)];
  const int q0 = plane[at(8 * k)], q1 = plane[at(8 * k + 1)];
  const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + p1 - q1 + 4) >> 3);
  if (!no_p && k > 0) plane[at(8 * k - 1)] = clip3(0, maxv, p0 + delta);
  if (!no_q) plane[at(8 * k)] = clip3(0, maxv, q0 - delta);
}

}  // namespace

extern "C" int deblock_luma(void* plane, const void* bsn, const void* qp,
                            const void* bo, const void* to, int B, int H,
                            int W, int h4, int w4, int vertical, int bd,
                            void* stream) {
  const long long n = (long long)B * (vertical ? (W / 8) * (H / 4)
                                               : (H / 8) * (W / 4));
  if (n == 0) return 0;
  const int threads = 128;
  deblock_luma_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (int32_t*)plane, (const uint8_t*)bsn, (const int8_t*)qp,
      (const int8_t*)bo, (const int8_t*)to, B, H, W, h4, w4, vertical, bd);
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_chroma(void* plane, const void* ctc, const void* bsn, int B, int H,
                  int W, int h4, int w4, int vertical, int ssx, int ssy,
                  int bd, void* stream) {
  const long long n = (long long)B * (vertical ? (W / 8) * H : (H / 8) * W);
  if (n == 0) return 0;
  const int threads = 256;
  deblock_chroma_kernel<TC><<<(unsigned)((n + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)plane, (const TC*)ctc, (const uint8_t*)bsn, B, H, W, h4, w4,
      vertical, ssx, ssy, bd);
  return (int)cudaGetLastError();
}

extern "C" int deblock_chroma(void* plane, const void* ctc, const void* bsn,
                              int B, int H, int W, int h4, int w4,
                              int vertical, int ssx, int ssy, int bd,
                              void* stream) {
  return launch_chroma<uint8_t>(plane, ctc, bsn, B, H, W, h4, w4, vertical,
                                ssx, ssy, bd, stream);
}

extern "C" int deblock_chroma16(void* plane, const void* ctc, const void* bsn,
                                int B, int H, int W, int h4, int w4,
                                int vertical, int ssx, int ssy, int bd,
                                void* stream) {
  return launch_chroma<int16_t>(plane, ctc, bsn, B, H, W, h4, w4, vertical,
                                ssx, ssy, bd, stream);
}
