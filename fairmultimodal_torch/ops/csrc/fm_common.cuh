// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel works on float or __nv_bfloat16 io, computes in fp32, and
// rounds to the io dtype exactly where the Pallas kernels it replaces call
// ``.astype(x.dtype)``.  The C entry
// points take the dtype as an int code (FM_F32 / FM_BF16) and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum FmDtype { FM_F32 = 0, FM_BF16 = 1 };

typedef __nv_bfloat16 fm_bf16;

namespace fm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(fm_bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ fm_bf16 from_f32<fm_bf16>(float v) {
  return __float2bfloat16_rn(v);  // round-to-nearest-even, as .astype(bf16)
}

// Value of ``v`` after a round trip through the io dtype.
template <typename T>
__device__ __forceinline__ float round_io(float v) {
  return to_f32(from_f32<T>(v));
}

// Sum / max over the 16 lanes of a half-warp (lanes 0-15 or 16-31).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fm
