// Measurement probe, on no decode path: the latency of one dependent round
// trip through L2, the unit of K2's chain-depth bound (chip_smoke.py).
//
// One thread follows a chain of indices, each load issued only when the
// previous one has returned, read past L1 (__ldcg) as K2 reads the border
// samples that other SMs wrote.  The caller times two chain lengths with
// CUDA events; their difference over the extra hops is the round trip.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void l2_chase_kernel(const int* __restrict__ next, int hops,
                                int* __restrict__ out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

extern "C" int l2_chase(const void* next, int hops, void* out,
                        void* stream) {
  l2_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)next, hops, (int*)out);
  return (int)cudaGetLastError();
}
