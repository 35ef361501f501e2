// Residual add + LayerNorm epilogue of a post-LN half-layer:
//
//     z   = round_io(x + y)                  x [R, H] io dtype, y [R, H] fp32
//     out = (z - mean(z)) * rsqrt(var(z) + eps) * gamma + beta
//
// Replaces the epilogue of both Pallas TPU kernels on the serving path:
// fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_fwd_kernel
// (lines 565-578) and fairmultimodal_tpu/ops/fused_ffn.py::_fwd_ln_kernel
// through _ln_fwd_math (lines 383-394).  y is the fp32 output of the last
// projection (bias included), so z is rounded to the io dtype once, as the
// TPU kernels round it, and the statistics are fp32 two-pass (mean, then the
// mean of squared deviations) from that rounded z.  eps is always passed by
// the caller (1e-5 lab encoder, 1e-12 BERT): the TPU kernels' 1e-6 default
// is never used.
//
// Bound: bytes.  At the lab shape (R = 256*560, H 768, bf16 io) it reads x
// and y and writes out, 0.88 GB, 0.26 ms at 3.35 TB/s.  The TPU kernels do
// this in VMEM on the accumulator they already hold; a fused GEMM epilogue
// (a block owning whole H-wide rows) would remove the fp32 y round trip.
//
// Design: one warp per row, eight rows per 256-thread block; the row is
// re-read from L1/L2 for each of the three passes.
#include "fm_common.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int ROWS_PER_BLOCK = LN_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
add_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ out, int R, int H, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;  // whole warp exits together
  const T* xr = x + (size_t)row * H;
  const float* yr = y + (size_t)row * H;
  T* outr = out + (size_t)row * H;

  float sum = 0.0f;
  for (int i = lane; i < H; i += 32) sum += fm::round_io<T>(fm::to_f32(xr[i]) + yr[i]);
  const float mu = fm::warp_sum(sum) / H;

  float sq = 0.0f;
  for (int i = lane; i < H; i += 32) {
    const float dz = fm::round_io<T>(fm::to_f32(xr[i]) + yr[i]) - mu;
    sq += dz * dz;
  }
  const float rstd = rsqrtf(fm::warp_sum(sq) / H + eps);

  for (int i = lane; i < H; i += 32) {
    const float z = fm::round_io<T>(fm::to_f32(xr[i]) + yr[i]);
    outr[i] = fm::from_f32<T>((z - mu) * rstd * gamma[i] + beta[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* y, const float* gamma, const float* beta,
                   void* out, int R, int H, float eps, cudaStream_t stream) {
  const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  add_layernorm_kernel<T><<<blocks, LN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), y, gamma, beta, static_cast<T*>(out), R, H, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, H] io dtype, y [R, H] fp32, gamma/beta [H] fp32, out [R, H] io dtype.
int fm_add_layernorm(const void* x, const void* y, const void* gamma, const void* beta,
                     void* out, int R, int H, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yy = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (dtype == FM_F32) return launch<float>(x, yy, g, bt, out, R, H, eps, s);
  if (dtype == FM_BF16) return launch<fm_bf16>(x, yy, g, bt, out, R, H, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
