// Tiled GEMM with a fused bias + activation epilogue:
//
//     C[M, N] = act(A[M, K] . W[N, K]^T + bias[N])      act: none | relu | gelu
//
// Replaces the matrix products inside two Pallas TPU kernels:
//   - fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_fwd_kernel
//     (the q/k/v projections, one launch with N = 3H, and the output
//     projection Wo, written in fp32 for the residual + LayerNorm kernel);
//   - fairmultimodal_tpu/ops/fused_ffn.py::_fwd_ln_kernel (x.W1 + b1 with
//     relu or exact gelu, rounded to the io dtype; then a.W2 + b2 in fp32).
// W is in nn.Linear layout [N, K], so both operands stream along K.
//
// Bound at the slice's shapes (bf16 dense peak 989 TFLOP/s, H100 SXM):
//   lab attention half-layer, batch 256 x 560 tokens: projections are
//   8*R*H*H = 6.8e11 of its 9.23e11 FLOP (0.93 ms for the whole half-layer);
//   lab FFN half-layer: 4*R*H*F = 9.02e11 FLOP (0.91 ms);
//   text BERT-base layer at 32 x 512: about 2.6e11 FLOP.
// All are operation-bound: the bytes (activations once, weights once) take
// about a seventh of that time at 3.35 TB/s.
//
// Design (simple and correct first), two kernels with one epilogue:
//   - bf16 with K % 32 == 0 (every serving shape): tensor cores through
//     WMMA.  128x128 output tile per 256-thread block, 32-deep K slices
//     copied with cp.async into a two-stage shared-memory ring, each of the
//     8 warps owning a 64x32 sub-tile as 4x2 16x16x16 bf16 fragments with
//     fp32 accumulators.  The epilogue stages one fragment at a time through
//     shared memory to add the bias and apply the activation in fp32.
//   - fp32: CUDA cores.  Same block tile, 16-deep K slices staged in
//     shared memory, 8x8 outputs per thread with fp32 FMA, so fp32 computes
//     in full fp32 (no TF32) as the TPU kernel's fp32 path does.
// What it leaves on the table: wgmma + TMA (the only way to the full
// tensor-core rate; mma.sync/WMMA tops out well below it), deeper
// pipelining, and the TPU kernels' fusion: q/k/v/o and the [R, F] FFN
// intermediate round-trip device memory between launches.
#include <mma.h>

#include "fm_common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps rows 16-byte aligned, shifts banks

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.0f);
  if (ACT == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  return v;
}

// ---- fp32 CUDA-core kernel ------------------------------------------------------

// Stage a [128 x BK] slice of a K-contiguous fp32 matrix, transposed, into
// tile[BK][128 + PAD]; rows past nrows are zero.
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int nrows, int K,
                                          int r0, int k0, float (*tile)[BM + PAD]) {
  constexpr int VPR = BK / 4;  // float4 vectors per tile row
  for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
    const int row = v / VPR;
    const int kk = (v % VPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < nrows)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * K + k0 + kk);
    tile[kk][row] = x.x;
    tile[kk + 1][row] = x.y;
    tile[kk + 2][row] = x.z;
    tile[kk + 3][row] = x.w;
  }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Ws[BK][BN + PAD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_f32(A, M, K, m0, k0, As);
    stage_f32(W, N, K, n0, k0, Ws);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], w[8];
      *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&w[0]) = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      *reinterpret_cast<float4*>(&w[4]) = *reinterpret_cast<const float4*>(&Ws[k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) C[(size_t)row * N + col] = activate<ACT>(acc[i][j] + bias[col]);
    }
  }
}

// ---- bf16 tensor-core kernel (WMMA) -------------------------------------------

constexpr int TC_BK = 32;
constexpr int TC_LDS = TC_BK + 8;  // smem row pitch in bf16: 80 bytes, 16-byte multiple
constexpr int TC_WM = 64;          // warp tile rows (2 warps down the block)
constexpr int TC_WN = 32;          // warp tile cols (4 warps across)
constexpr int TC_FM = TC_WM / 16;
constexpr int TC_FN = TC_WN / 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copy a [128 x TC_BK] slice of a K-contiguous bf16 matrix into dst[128][TC_LDS];
// rows past nrows are zero-filled.
__device__ __forceinline__ void stage_tc(const fm_bf16* __restrict__ src, int nrows, int K,
                                         int r0, int k0, fm_bf16* dst) {
  constexpr int CPR = TC_BK / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BM * CPR; c += THREADS) {
    const int row = c / CPR;
    const int col = (c % CPR) * 8;
    fm_bf16* d = dst + row * TC_LDS + col;
    if (r0 + row < nrows)
      cp_async16(d, src + (size_t)(r0 + row) * K + k0 + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename TOut, int ACT>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_tc_kernel(const fm_bf16* __restrict__ A, const fm_bf16* __restrict__ W,
                    const float* __restrict__ bias, TOut* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) fm_bf16 As[2][BM * TC_LDS];
  __shared__ __align__(128) fm_bf16 Ws[2][BN * TC_LDS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TC_FM][TC_FN];
#pragma unroll
  for (int i = 0; i < TC_FM; ++i)
#pragma unroll
    for (int j = 0; j < TC_FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = K / TC_BK;
  stage_tc(A, M, K, m0, 0, As[0]);
  stage_tc(W, N, K, n0, 0, Ws[0]);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      stage_tc(A, M, K, m0, (kt + 1) * TC_BK, As[cur ^ 1]);
      stage_tc(W, N, K, n0, (kt + 1) * TC_BK, Ws[cur ^ 1]);
    }
    cp_async_commit();
    cp_async_wait_prev();  // the current stage has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, fm_bf16, wmma::row_major> af[TC_FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, fm_bf16, wmma::col_major> bf[TC_FN];
#pragma unroll
      for (int i = 0; i < TC_FM; ++i)
        wmma::load_matrix_sync(af[i], As[cur] + (wm * TC_WM + i * 16) * TC_LDS + kk, TC_LDS);
#pragma unroll
      for (int j = 0; j < TC_FN; ++j)  // W[n][k] read as the col-major B[k][n]
        wmma::load_matrix_sync(bf[j], Ws[cur] + (wn * TC_WN + j * 16) * TC_LDS + kk, TC_LDS);
#pragma unroll
      for (int i = 0; i < TC_FM; ++i)
#pragma unroll
        for (int j = 0; j < TC_FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // everyone is done with `cur` before it is refilled
  }

  // Epilogue: one 16x16 fp32 fragment at a time through a per-warp slice of
  // the (now idle) A buffer.
  float* st = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < TC_FM; ++i) {
#pragma unroll
    for (int j = 0; j < TC_FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * TC_WM + i * 16;
      const int c0 = n0 + wn * TC_WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + e / 16;
        const int col = c0 + e % 16;
        if (row < M && col < N)
          C[(size_t)row * N + col] = fm::from_f32<TOut>(activate<ACT>(st[e] + bias[col]));
      }
      __syncwarp();
    }
  }
}

template <typename TOut>
cudaError_t launch_tc(const void* A, const void* W, const float* bias, void* C, int M, int N,
                      int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const fm_bf16* a = static_cast<const fm_bf16*>(A);
  const fm_bf16* w = static_cast<const fm_bf16*>(W);
  TOut* c = static_cast<TOut*>(C);
  switch (act) {
    case ACT_NONE:
      gemm_bf16_tc_kernel<TOut, ACT_NONE><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    case ACT_RELU:
      gemm_bf16_tc_kernel<TOut, ACT_RELU><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    case ACT_GELU:
      gemm_bf16_tc_kernel<TOut, ACT_GELU><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* A, const void* W, const float* bias, void* C, int M, int N,
                       int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  float* c = static_cast<float*>(C);
  switch (act) {
    case ACT_NONE:
      gemm_f32_kernel<ACT_NONE><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    case ACT_RELU:
      gemm_f32_kernel<ACT_RELU><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    case ACT_GELU:
      gemm_f32_kernel<ACT_GELU><<<grid, THREADS, 0, stream>>>(a, w, bias, c, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A [M, K], W [N, K] in the io dtype; bias [N] fp32; C [M, N] in the io
// dtype, or fp32 when out_f32 != 0 (fp32 inputs always give fp32).  K must be
// a multiple of 32 and A, W 16-byte aligned (the wrapper checks both).
int fm_gemm_bias_act(const void* A, const void* W, const void* bias, void* C, int M, int N,
                     int K, int dtype, int out_f32, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (K % TC_BK) return cudaErrorInvalidValue;
  if (dtype == FM_F32) return launch_f32(A, W, b, C, M, N, K, act, s);
  if (dtype == FM_BF16) {
    if (out_f32) return launch_tc<float>(A, W, b, C, M, N, K, act, s);
    return launch_tc<fm_bf16>(A, W, b, C, M, N, K, act, s);
  }
  return cudaErrorInvalidValue;
}

const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
