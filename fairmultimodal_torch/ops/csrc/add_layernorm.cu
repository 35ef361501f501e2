// Residual + dropout + LayerNorm epilogue of a post-LN half-layer, forward
// and backward:
//
//   forward   z   = round_io(x + dropout(y))      x [R, H] io, y [R, H] fp32
//             out = (z - mean(z)) * rsqrt(var(z) + eps) * gamma + beta
//   backward  from g = dL/dout, the stored z and gamma (TPU: _ln_bwd_math):
//             dz  = rstd * (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat))
//             da  = round_io(dropout_replay(dz))   (the branch into y)
//             per-block column sums of g*xhat, g and dropout_replay(dz) in
//             fp32 (dgamma, dbeta and the last projection's bias grad),
//             added in a fixed order by fm_colsum: no atomics, so a step
//             gives the same bits every time it runs.
//
// Replaces the epilogues of the Pallas TPU kernels
// fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_fwd_kernel
// (lines 565-578) and ::_mega_ln_bwd_kernel (lines 681-715), and
// fairmultimodal_tpu/ops/fused_ffn.py::_fwd_ln_kernel / _bwd_ln_kernel
// through _ln_fwd_math / _ln_bwd_math (lines 383-411, 537-545).  The
// dropout is the outer stream of the half-layer (philox.cuh), drawn in the
// forward and replayed in the backward at the same flat index row * H + col.
// z is stored rounded to the io dtype and both passes take the statistics
// from it, as the TPU kernels do.
// With the LayerNorm unfolded (fold_ln=False), the same two kernels are the
// dropout + residual + LayerNorm that fairmultimodal_tpu/models/behrt.py
// runs in XLA after the unfolded kernels (nn.Dropout + add + nn.LayerNorm,
// lines 127-130 and 174-176): y is then the kernel's io-dtype output and the
// backward also writes dz in the io dtype (the residual's cotangent).
//
// Bound: bytes.  At the lab shape (R = 256*560, H 768, bf16 io) the
// forward reads x and y and writes out and z, 1.1 GB, 0.33 ms at 3.35 TB/s;
// the backward reads g and z and writes dz (fp32) and da, 1.1 GB.
//
// Design: one warp per row; each lane holds NC chunks of 8 consecutive
// elements in registers (H % 8 == 0, H <= 1024), loaded and stored 16 bytes
// at a time, and draws one Philox block per 4 elements (one call gives the
// 4 words of a counter).  The backward keeps its three column partials in
// registers across the block's 64 rows and reduces the 8 warps through
// shared memory.
#include "fm_common.cuh"
#include "philox.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int WARPS = LN_THREADS / 32;
constexpr int BWD_ROWS = 64;  // rows per backward block (8 per warp)
constexpr int MAX_H = 1024;
constexpr int V = 8;  // elements per chunk

// 8 consecutive values of an io row as fp32 (16 bytes of bf16, 32 of fp32).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const fm_bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const fm_bf16* h = reinterpret_cast<const fm_bf16*>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __bfloat162float(h[k]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(fm_bf16* p, const float* v) {
  uint4 u;
  fm_bf16* h = reinterpret_cast<fm_bf16*>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// v[0..7] at flat index i (i % 4 == 0) through the dropout stream d.
__device__ __forceinline__ void dropout8(const fm::Dropout& d, unsigned long long i, float* v) {
  if (!d.on) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 w = fm::random_words(d.seed, d.stream, (i >> 2) + h);
    const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * h + k] = bits[k] < d.threshold ? v[4 * h + k] * d.inv_keep : 0.0f;
  }
}

template <typename T, typename TY, int NC>
__global__ void __launch_bounds__(LN_THREADS)
add_layernorm_kernel(const T* __restrict__ x, const TY* __restrict__ y,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ out, T* __restrict__ zout, int R, int H, float eps,
                     fm::Dropout drop) {
  fm::load_key(drop);
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;  // whole warp exits together
  const size_t base = (size_t)row * H;
  float v[NC][V];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < H) {
      float xv[V];
      load8(x + base + c, xv);
      load8(y + base + c, v[j]);
      dropout8(drop, base + c, v[j]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[j][k] = fm::round_io<T>(xv[k] + v[j][k]);
        sum += v[j][k];
      }
    }
  }
  const float mu = fm::warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if ((lane + 32 * j) * V < H)
#pragma unroll
      for (int k = 0; k < V; ++k) sq += (v[j][k] - mu) * (v[j][k] - mu);
  const float rstd = rsqrtf(fm::warp_sum(sq) / H + eps);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < H) {
      if (zout) store8(zout + base + c, v[j]);
      float o[V], gm[V], bt[V];
      load8(gamma + c, gm);
      load8(beta + c, bt);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = (v[j][k] - mu) * rstd * gm[k] + bt[k];
      store8(out + base + c, o);
    }
  }
}

template <typename T, typename TDZ, int NC>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ z,
                     const float* __restrict__ gamma, TDZ* __restrict__ dz,
                     T* __restrict__ da, float* __restrict__ part, int R, int H, float eps,
                     fm::Dropout drop) {
  fm::load_key(drop);
  __shared__ float red[WARPS][MAX_H];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float pg[NC][V], pb[NC][V], pd[NC][V];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) pg[j][k] = pb[j][k] = pd[j][k] = 0.0f;

  for (int rr = warp; rr < BWD_ROWS; rr += WARPS) {
    const int row = blockIdx.x * BWD_ROWS + rr;
    if (row >= R) break;  // uniform across the warp
    const size_t base = (size_t)row * H;
    float gv[NC][V], zv[NC][V];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < H) {
        load8(g + base + c, gv[j]);
        load8(z + base + c, zv[j]);
#pragma unroll
        for (int k = 0; k < V; ++k) sum += zv[j][k];
      }
    }
    const float mu = fm::warp_sum(sum) / H;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if ((lane + 32 * j) * V < H)
#pragma unroll
        for (int k = 0; k < V; ++k) sq += (zv[j][k] - mu) * (zv[j][k] - mu);
    const float rstd = rsqrtf(fm::warp_sum(sq) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < H) {
        float gm[V];
        load8(gamma + c, gm);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          zv[j][k] = (zv[j][k] - mu) * rstd;  // xhat
          const float gg = gv[j][k] * gm[k];
          s1 += gg;
          s2 += gg * zv[j][k];
        }
      }
    }
    const float m1 = fm::warp_sum(s1) / H;
    const float m2 = fm::warp_sum(s2) / H;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < H) {
        float gm[V], d[V], a[V];
        load8(gamma + c, gm);
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = d[k] = rstd * (gv[j][k] * gm[k] - m1 - zv[j][k] * m2);
        dropout8(drop, base + c, a);
        store8(dz + base + c, d);
        store8(da + base + c, a);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          pg[j][k] += gv[j][k] * zv[j][k];
          pb[j][k] += gv[j][k];
          pd[j][k] += a[k];
        }
      }
    }
  }

  // Block partials: the 8 warps' sums added in warp order.
  const size_t plane = (size_t)gridDim.x * H;
  auto flush = [&](const float (&p)[NC][V], float* dst) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < H)
#pragma unroll
        for (int k = 0; k < V; ++k) red[warp][c + k] = p[j][k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < H; i += LN_THREADS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][i];
      dst[(size_t)blockIdx.x * H + i] = s;
    }
    __syncthreads();
  };
  flush(pg, part);
  flush(pb, part + plane);
  flush(pd, part + 2 * plane);
}

// NC (chunks of 8 a lane) for a row of H: ceil(H / 256).
#define FM_LN_DISPATCH(H, CALL)               \
  do {                                        \
    switch (((H) + 255) / 256) {              \
      case 1: CALL(1); break;                 \
      case 2: CALL(2); break;                 \
      case 3: CALL(3); break;                 \
      case 4: CALL(4); break;                 \
      default: return cudaErrorInvalidValue;  \
    }                                         \
  } while (0)

template <typename T, typename TY>
cudaError_t launch_fwd(const void* x, const void* y, const float* gamma, const float* beta,
                       void* out, void* z, int R, int H, float eps, const fm::Dropout& d,
                       cudaStream_t s) {
  const int blocks = (R + WARPS - 1) / WARPS;
#define FM_FWD(NC)                                                                        \
  add_layernorm_kernel<T, TY, NC><<<blocks, LN_THREADS, 0, s>>>(                          \
      static_cast<const T*>(x), static_cast<const TY*>(y), gamma, beta,                   \
      static_cast<T*>(out), static_cast<T*>(z), R, H, eps, d)
  FM_LN_DISPATCH(H, FM_FWD);
#undef FM_FWD
  return cudaGetLastError();
}

template <typename T, typename TDZ>
cudaError_t launch_bwd(const void* g, const void* z, const float* gamma, void* dz, void* da,
                       float* part, int R, int H, float eps, const fm::Dropout& d,
                       cudaStream_t s) {
  const int blocks = (R + BWD_ROWS - 1) / BWD_ROWS;
#define FM_BWD(NC)                                                                      \
  layernorm_bwd_kernel<T, TDZ, NC><<<blocks, LN_THREADS, 0, s>>>(                       \
      static_cast<const T*>(g), static_cast<const T*>(z), gamma, static_cast<TDZ*>(dz), \
      static_cast<T*>(da), part, R, H, eps, d)
  FM_LN_DISPATCH(H, FM_BWD);
#undef FM_BWD
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, H] io dtype, y [R, H] fp32 (or io dtype with y_io: the output of an
// unfolded half-layer kernel, Pallas #5 / #7), gamma/beta [H] fp32, out
// [R, H] io; z [R, H] io receives round(x + dropout(y)) when not null.
// H % 8 == 0, H <= 1024, every pointer 16-byte aligned (the wrapper checks).
// key: the dropout stream's seed in device memory (philox.cuh).
int fm_add_layernorm(const void* x, const void* y, const void* gamma, const void* beta,
                     void* out, void* z, int R, int H, float eps, const unsigned long long* key,
                     unsigned int stream_id, unsigned int threshold, float inv_keep,
                     int drop_on, int dtype, int y_io, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fm::Dropout d{0ull, key, stream_id, threshold, inv_keep, drop_on};
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (H > MAX_H || H % V || (drop_on && !key)) return cudaErrorInvalidValue;
  if (dtype == FM_F32) return launch_fwd<float, float>(x, y, gm, bt, out, z, R, H, eps, d, s);
  if (dtype != FM_BF16) return cudaErrorInvalidValue;
  if (y_io) return launch_fwd<fm_bf16, fm_bf16>(x, y, gm, bt, out, z, R, H, eps, d, s);
  return launch_fwd<fm_bf16, float>(x, y, gm, bt, out, z, R, H, eps, d, s);
}

// g, z [R, H] io dtype, gamma [H] fp32 -> dz [R, H] fp32 (or io dtype with
// dz_io: the residual branch's cotangent of an unfolded half-layer), da
// [R, H] io, and part [3, ceil(R/64), H] fp32 block partials of (g*xhat, g,
// dropout(dz)).  H % 8 == 0, H <= 1024.
int fm_layernorm_bwd(const void* g, const void* z, const void* gamma, void* dz, void* da,
                     void* part, int R, int H, float eps, const unsigned long long* key,
                     unsigned int stream_id, unsigned int threshold, float inv_keep,
                     int drop_on, int dtype, int dz_io, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fm::Dropout d{0ull, key, stream_id, threshold, inv_keep, drop_on};
  const float* gm = static_cast<const float*>(gamma);
  float* pp = static_cast<float*>(part);
  if (H > MAX_H || H % V || (drop_on && !key)) return cudaErrorInvalidValue;
  if (dtype == FM_F32) return launch_bwd<float, float>(g, z, gm, dz, da, pp, R, H, eps, d, s);
  if (dtype != FM_BF16) return cudaErrorInvalidValue;
  if (dz_io) return launch_bwd<fm_bf16, fm_bf16>(g, z, gm, dz, da, pp, R, H, eps, d, s);
  return launch_bwd<fm_bf16, float>(g, z, gm, dz, da, pp, R, H, eps, d, s);
}

// Copy `bytes` from pinned host memory to the device, in stream order.  The
// dropout keys reach the card this way: captured into a CUDA graph, the copy
// is a node that reads the host memory again at every replay.
int fm_copy_h2d(void* dst, const void* src, unsigned long long bytes, void* stream) {
  return cudaMemcpyAsync(dst, src, bytes, cudaMemcpyHostToDevice,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
