// K10: cross-component prediction (4:4:4) on the residual planes.
//
// Replaces: libhm_tpu/parallel/batch_decode.py _ccp_fn (lines 164-178), as
//   _residual_planes_batch_device runs it (lines 239-260) once every TU of
//   the level is in its residual plane: for each listed chroma TU
//   (b, y, x, n, alpha) and each of its n x n samples,
//     res_c[b, y+i, x+j] = clip(res_c + ((alpha * res_l[b, y+i, x+j]) >> 3),
//                               -32768, 32767)
//   with the shift arithmetic on the signed product.  The luma residual is
//   used as it is, without the (rY << BitDepthC) >> BitDepthY scale of
//   H.265 8.6.6, as the JAX and numpy decoders do: they agree with the spec
//   when luma and chroma bit depths are equal.
// What bounds it on the card: bytes.  Each listed sample reads one int32 of
//   res_l and of res_c and writes one of res_c, with three integer ops.
// What the design does about it: one launch per (component, level) over a
//   table of every CCP TU of the level, whatever its size (the JAX code
//   launches once per (component, n) because its jit is keyed by shape);
//   one thread block per TU, its threads striding over the TU's samples row
//   by row, so a warp reads and writes contiguous runs of each row.  TUs of
//   one component never overlap, so the plane is updated in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// one row of the TU table (ops/ccp.py CCP_FIELDS)
enum { kB, kY, kX, kN, kAlpha, kFields };

__global__ void ccp_kernel(int32_t* __restrict__ res_c,
                           const int32_t* __restrict__ res_l,
                           const int32_t* __restrict__ tus, int Bp, int H,
                           int W) {
  const int32_t* q = tus + (long long)blockIdx.x * kFields;
  const int b = q[kB], y0 = q[kY], x0 = q[kX], n = q[kN], alpha = q[kAlpha];
  if (b < 0 || b >= Bp || n <= 0) return;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int y = y0 + i / n, x = x0 + i % n;
    // samples past the plane are dropped, as the JAX scatter's mode="drop"
    if (y < 0 || y >= H || x < 0 || x >= W) continue;
    const long long o = ((long long)b * H + y) * W + x;
    const int v = res_c[o] + ((alpha * res_l[o]) >> 3);
    res_c[o] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
  }
}

}  // namespace

extern "C" int ccp_apply(void* res_c, const void* res_l, const void* tus,
                         int M, int Bp, int H, int W, void* stream) {
  if (M == 0) return 0;
  ccp_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)res_c, (const int32_t*)res_l, (const int32_t*)tus, Bp, H, W);
  return (int)cudaGetLastError();
}
