// K7 plane_checksum: uint32 sum (mod 2^32) of cropped 2-D int32 views.
//
// Replaces: the checksum of libhm_tpu/parallel/dag_decode.py
//   decode_batch_device (a jnp.sum of each cropped output plane as uint32,
//   then a sum of the parts, then one device_get).
// What bounds it on the card: bytes.  Each cropped sample is read once as
//   int32 and added; the sum is one 4-byte word.
// What the design does about it:
//   - the view table (pointer, row stride, rows, columns) travels by value
//     as a __grid_constant__ kernel parameter of up to kMaxViews views, so
//     nothing is uploaded; the C entry zeroes the word with
//     cudaMemsetAsync, and a longer list launches once per kMaxViews views
//     into the same word;
//   - the work items are (view, row), one a warp: the grid (kCtasPerSm
//     CTAs an SM, fewer when there are fewer rows) walks them with a grid
//     stride over its warps, each warp along the rows of the views in
//     order, its lanes along the columns: a scalar head up to the row's
//     first 16-byte boundary (crops may start at any column), 16-byte
//     loads, four in flight a lane, and a scalar tail.  No division on the
//     device;
//   - each CTA reduces its sum with warp shuffles and shared memory and
//     adds it to the word with one atomicAdd.  Unsigned addition wraps mod
//     2^32 and is associative and commutative, so the order of the atomics
//     does not change the result.  Only that word is downloaded.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxViews = 64;       // views a launch takes (ops/checksum.py)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 4;

struct View {
  const int32_t* base;
  long long stride;                 // samples from one row to the next
  int rows, cols;
  int first;                        // the view's first row among all views
  int pad;
};
static_assert(sizeof(View) == 32, "a view is 32 bytes of the parameter");

struct Views {
  View v[kMaxViews];
  int n, rows;
};

__device__ __forceinline__ unsigned sum4(int4 a) {
  return (unsigned)a.x + (unsigned)a.y + (unsigned)a.z + (unsigned)a.w;
}

// this lane's part of the sum of one row of `cols` samples
__device__ __forceinline__ unsigned row_sum(const int32_t* row, int cols,
                                            int lane) {
  const int head = min(cols, (int)((16 - ((uintptr_t)row & 15)) & 15) >> 2);
  unsigned s = lane < head ? (unsigned)__ldg(row + lane) : 0u;
  const int n4 = (cols - head) >> 2;
  const int4* p = reinterpret_cast<const int4*>(row + head);
  int i = lane;
  for (; i + 96 < n4; i += 128) {
    const int4 a = __ldg(p + i), b = __ldg(p + i + 32),
               c = __ldg(p + i + 64), d = __ldg(p + i + 96);
    s += sum4(a) + sum4(b) + sum4(c) + sum4(d);
  }
  for (; i < n4; i += 32) s += sum4(__ldg(p + i));
  const int done = head + (n4 << 2);
  if (lane < cols - done) s += (unsigned)__ldg(row + done + lane);
  return s;
}

__global__ void __launch_bounds__(kThreads)
checksum_kernel(const __grid_constant__ Views t, unsigned* __restrict__ acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned s = 0;
  int k = 0;
  for (int r = blockIdx.x * kWarps + warp; r < t.rows;
       r += gridDim.x * kWarps) {
    // the rows rise with r, and so does their view
    while (k + 1 < t.n && t.v[k + 1].first <= r) ++k;
    const View& v = t.v[k];
    s += row_sum(v.base + (long long)(r - v.first) * v.stride, v.cols, lane);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ unsigned part[kWarps];
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned tot = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) tot += part[i];
    if (tot) atomicAdd(acc, tot);
  }
}

}  // namespace

// table: HOST memory, n_views (at most kMaxViews) x {pointer, row stride,
// rows, cols} as int64, copied into the launch's parameter; acc: one uint32
// word on the device, zeroed first when `zero`, then added to.
extern "C" int plane_checksum(const void* table, int n_views, void* acc,
                              int zero, void* stream) {
  if (n_views < 0 || n_views > kMaxViews) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (zero) {
    const cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
  }
  Views t;
  t.n = n_views;
  const long long* q = (const long long*)table;
  long long rows = 0;
  for (int k = 0; k < n_views; ++k, q += 4) {
    View& v = t.v[k];
    v.base = (const int32_t*)q[0];
    v.stride = q[1];
    v.rows = (int)q[2];
    v.cols = (int)q[3];
    v.first = (int)rows;
    v.pad = 0;
    if (v.rows > 0 && v.cols > 0) rows += v.rows;
  }
  if (rows > (1 << 30)) return (int)cudaErrorInvalidValue;
  t.rows = (int)rows;
  if (rows == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = (long long)kCtasPerSm * std::max(sms, 1);
  const int grid = (int)std::min((rows + kWarps - 1) / kWarps, most);
  checksum_kernel<<<grid, kThreads, 0, s>>>(t, (unsigned*)acc);
  return (int)cudaGetLastError();
}
