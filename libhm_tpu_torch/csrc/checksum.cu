// K7 plane_checksum: uint32 sum (mod 2^32) of cropped 2-D int32 views.
//
// Replaces: the checksum of libhm_tpu/parallel/dag_decode.py
//   decode_batch_device (a jnp.sum of each cropped output plane as uint32,
//   then a sum of the parts, then one device_get).
// What bounds it on the card: bytes.  Each cropped sample is read once as
//   int32 and added; the sum is one 4-byte word.
// What the design does about it: one launch over a small device table of
//   views (pointer, row stride, rows, cols), blockIdx.y picking the view;
//   each thread walks its view with a grid stride (coalesced along rows),
//   sums in a register, the warp reduces with shuffles and lane 0 adds into
//   one device word with atomicAdd.  Unsigned addition wraps mod 2^32 and
//   is associative and commutative, so the order of the atomics does not
//   change the result.  Only that word is downloaded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void checksum_kernel(const long long* __restrict__ table,
                                unsigned int* __restrict__ acc) {
  const long long* v = table + 4 * blockIdx.y;
  const int32_t* base = (const int32_t*)v[0];
  const long long stride = v[1], rows = v[2], cols = v[3];
  const long long n = rows * cols;
  unsigned int s = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    s += (unsigned int)base[(i / cols) * stride + i % cols];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(acc, s);
}

}  // namespace

// table: n_views x {pointer, row stride, rows, cols} as int64 on the
// device; acc: one uint32 word, added to (the caller zeroes it).
extern "C" int plane_checksum(const void* table, void* acc, int n_views,
                              int blocks_per_view, void* stream) {
  if (n_views == 0) return 0;
  const dim3 grid(blocks_per_view, n_views);
  checksum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)table, (unsigned int*)acc);
  return (int)cudaGetLastError();
}
