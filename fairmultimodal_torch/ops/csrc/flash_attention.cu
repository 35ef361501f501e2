// Flash-style masked multi-head attention forward over a packed qkv buffer:
//
//     o[b, s, h*d:(h+1)*d] = softmax(q_h k_h^T * scale + bias) v_h
//     bias[key] = 0 where mask[b, key] > 0, else -1e9 (additive, NOT -inf)
//
// Replaces the softmax-attention core of the Pallas TPU kernel
// fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_fwd_kernel
// (lines 543-550).  The projections before it and the output projection +
// residual + LayerNorm after it are gemm.cu and add_layernorm.cu.
//
// Bound at the slice's shapes: the score and p.v products are 4*B*S*S*H
// FLOP, 2.5e11 for the lab encoder (B 256, S 560, H 768) and 6.4e10 per
// text batch of 32 x 512 -- operation-bound (0.25 ms and 0.07 ms at the
// bf16 dense peak) while q/k/v/o move 0.9 GB and 0.1 GB.
//
// Design.  The TPU kernel holds the whole [S, S] score tile in VMEM; an SM
// has 227 KB, so both kernels here tile the keys (64 at a time).  One
// 256-thread block owns 64 query rows of one (batch, head).  q, k, v are
// read straight from the [B, S, 3H] projection output (head h at column
// offset h*d), so no head split/merge transposes exist.  The head dim is
// padded with zeros to DP, a multiple of 32 (d 96 stays 96): the TPU
// kernel's 96 -> 128 pad was Mosaic's 128-lane rule and buys nothing here.
//   - bf16 (any d <= 128): tensor cores through WMMA, in two passes over
//     the keys.  Pass 1 computes the scores and the exact row max and sum;
//     pass 2 recomputes the scores, forms the NORMALISED p, rounds it to
//     bf16 and accumulates p.v in fp32 WMMA fragments -- the TPU kernel's
//     rounding exactly, and no running rescale of the output fragments.
//     The price is a second q.k^T (1.5x the attention FLOPs).  Tiles load
//     16 bytes at a time when d % 8 == 0 (every serving shape) and one
//     element at a time otherwise.
//   - fp32: CUDA cores, one pass with an online softmax (running max and
//     sum); each thread owns 4 rows x 4 keys of a score tile and 4 rows x
//     DP/16 output columns.  fp32 rounds nothing, so normalising once at
//     the end differs from the TPU kernel only in summation order.
//
// Masking copies the TPU kernel exactly: -1e9 is added to the scaled score,
// so a fully masked row (the pad rows of an encode batch) gets a finite,
// uniform softmax instead of NaN.  Keys past S (the ragged last tile) get
// -inf and weigh exactly zero.
//
// What it leaves on the table: wgmma, K/V double buffering, keeping p in
// registers (mma.sync fragments) instead of staging scores through shared
// memory, and the TPU kernel's fusion -- q/k/v and o round-trip device
// memory.
#include <math.h>
#include <mma.h>

#include "fm_common.cuh"

namespace {

constexpr int FA_BM = 64;       // query rows per block
constexpr int FA_BN = 64;       // keys per tile
constexpr int FA_THREADS = 256;
constexpr int TSTR = FA_BM + 1;  // transposed q/k tile row stride (bank-conflict pad)
constexpr int PSTR = FA_BN + 1;  // p tile row stride

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * TSTR + FA_BN * DP + FA_BM * PSTR + FA_BN);
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_fwd_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ mask,
                          float* __restrict__ out, int S, int nh, int d, float scale) {
  static_assert(DP % 32 == 0 && DP <= 128, "head dim pad");
  constexpr int DC = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [DP][TSTR]   q tile, transposed
  float* Kt = Qt + DP * TSTR;        // [DP][TSTR]   k tile, transposed
  float* Vs = Kt + DP * TSTR;        // [FA_BN][DP]
  float* Ps = Vs + FA_BN * DP;       // [FA_BM][PSTR]
  float* kbias = Ps + FA_BM * PSTR;  // [FA_BN]

  const int tid = threadIdx.x;
  const int r = tid / 16;  // rows r*4 .. r*4+3 of the tile
  const int c = tid % 16;  // keys c + 16*j, output columns c + 16*jj
  const int q0 = blockIdx.x * FA_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * d;
  const size_t rs = 3 * (size_t)H;  // qkv row stride
  const float* qb = qkv + (size_t)b * S * rs + (size_t)h * d;
  const float* kb = qb + H;
  const float* vb = qb + 2 * H;
  const int* mrow = mask + (size_t)b * S;

  for (int i = tid; i < FA_BM * DP; i += FA_THREADS) {
    const int row = i / DP, k = i % DP;
    float v = 0.0f;
    if (q0 + row < S && k < d) v = qb[(size_t)(q0 + row) * rs + k];
    Qt[k * TSTR + row] = v;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += FA_BN) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < FA_BN * DP; i += FA_THREADS) {
      const int key = i / DP, k = i % DP;
      const bool ok = k0 + key < S && k < d;
      const size_t off = (size_t)(k0 + key) * rs + k;
      Kt[k * TSTR + key] = ok ? kb[off] : 0.0f;
      Vs[key * DP + k] = ok ? vb[off] : 0.0f;
    }
    for (int i = tid; i < FA_BN; i += FA_THREADS) {
      const int key = k0 + i;
      kbias[i] = key < S ? (mrow[key] > 0 ? 0.0f : -1e9f) : -INFINITY;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < DP; ++k) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[k * TSTR + r * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[k * TSTR + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + kbias[c + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], fm::half_warp_max(mx));
      const float alpha = expf(m_i[i] - m_new);  // 0 on the first tile
      m_i[i] = m_new;
      l_i[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l_i[i] += p;
        Ps[(r * 4 + i) * PSTR + c + 16 * j] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BN; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r * 4 + i) * PSTR + j];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = Vs[j * DP + c + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

  const size_t orow = (size_t)H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = fm::half_warp_sum(l_i[i]);
    const int row = q0 + r * 4 + i;
    if (row >= S) continue;
    float* dst = out + ((size_t)b * S + row) * orow + (size_t)h * d;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = c + 16 * jj;
      if (col < d) dst[col] = acc[i][jj] / l;
    }
  }
}

// ---- bf16 tensor-core kernel (WMMA, two passes) --------------------------------

constexpr int SLD = FA_BN + 4;  // fp32 score tile pitch
constexpr int PLD = FA_BN + 8;  // bf16 p tile pitch

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

template <int DP>
struct TcSmem {  // byte offsets of the shared-memory regions
  static constexpr int LD = DP + 8;  // bf16 q/k/v tile pitch
  static constexpr int Q = 0;
  static constexpr int K = Q + round128(FA_BM * LD * 2);
  static constexpr int V = K + round128(FA_BN * LD * 2);
  static constexpr int S = V + round128(FA_BN * LD * 2);
  static constexpr int P = S + round128(FA_BM * SLD * 4);
  static constexpr int BIAS = P + round128(FA_BM * PLD * 2);
  static constexpr int BYTES = BIAS + round128(FA_BN * 4);
};

// 64 rows x d columns of one head (row stride rs) -> dst[64][DP + 8], zero padded.
// 16-byte loads when d % 8 == 0 (head offsets and rows are then 16-byte
// aligned), element loads for any other d.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(const fm_bf16* __restrict__ src, size_t rs,
                                               int r0, int S, int d, fm_bf16* dst) {
  constexpr int LD = DP + 8;
  if (d % 8 == 0) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < FA_BM * CPR; c += FA_THREADS) {
      const int row = c / CPR;
      const int col = (c % CPR) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < S && col < d)
        v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * rs + col);
      *reinterpret_cast<uint4*>(dst + row * LD + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < FA_BM * DP; i += FA_THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] = (r0 + row < S && col < d)
                                ? src[(size_t)(r0 + row) * rs + col]
                                : __float2bfloat16_rn(0.0f);
    }
  }
}

// Ss[64][SLD] = Qs . Ks^T in fp32: 16 fragments, two per warp.
template <int DP>
__device__ __forceinline__ void scores_tc(const fm_bf16* Qs, const fm_bf16* Ks, float* Ss) {
  using namespace nvcuda;
  constexpr int LD = DP + 8;
  for (int f = threadIdx.x / 32; f < 16; f += FA_THREADS / 32) {
    const int fr = f / 4, fc = f % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < DP; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, fm_bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, fm_bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + fr * 16 * LD + k, LD);
      wmma::load_matrix_sync(b, Ks + fc * 16 * LD + k, LD);  // k[key][d] as col-major B
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + fr * 16 * SLD + fc * 16, acc, SLD, wmma::mem_row_major);
  }
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_fwd_tc_kernel(const fm_bf16* __restrict__ qkv, const int* __restrict__ mask,
                         fm_bf16* __restrict__ out, int S, int nh, int d, float scale) {
  using namespace nvcuda;
  using L = TcSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int NOF = FA_BM / 16 * (DP / 16);        // output fragments
  constexpr int OPW = (NOF + FA_THREADS / 32 - 1) / (FA_THREADS / 32);  // per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fm_bf16* Qs = reinterpret_cast<fm_bf16*>(smem_raw + L::Q);
  fm_bf16* Ks = reinterpret_cast<fm_bf16*>(smem_raw + L::K);
  fm_bf16* Vs = reinterpret_cast<fm_bf16*>(smem_raw + L::V);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::S);
  fm_bf16* Ps = reinterpret_cast<fm_bf16*>(smem_raw + L::P);
  float* kbias = reinterpret_cast<float*>(smem_raw + L::BIAS);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = tid / 4;  // softmax: four threads per query row ...
  const int q = tid % 4;    // ... each taking keys q, q+4, ..., q+60
  const int q0 = blockIdx.x * FA_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * d;
  const size_t rs = 3 * (size_t)H;
  const fm_bf16* qb = qkv + (size_t)b * S * rs + (size_t)h * d;
  const fm_bf16* kb = qb + H;
  const fm_bf16* vb = qb + 2 * H;
  const int* mrow = mask + (size_t)b * S;

  load_tile_bf16<DP>(qb, rs, q0, S, d, Qs);

  // Pass 1: exact row max m and row sum l of exp(s - m).
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < S; k0 += FA_BN) {
    __syncthreads();
    load_tile_bf16<DP>(kb, rs, k0, S, d, Ks);
    if (tid < FA_BN) {
      const int key = k0 + tid;
      kbias[tid] = key < S ? (mrow[key] > 0 ? 0.0f : -1e9f) : -INFINITY;
    }
    __syncthreads();
    scores_tc<DP>(Qs, Ks, Ss);
    __syncthreads();
    float sv[FA_BN / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_BN / 4; ++j) {
      const int key = q + 4 * j;
      sv[j] = Ss[row * SLD + key] * scale + kbias[key];
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    l *= expf(m - m_new);
#pragma unroll
    for (int j = 0; j < FA_BN / 4; ++j) l += expf(sv[j] - m_new);
    m = m_new;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // Pass 2: p = exp(s - m) / l rounded to bf16, o += p . v in fp32.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[OPW];
#pragma unroll
  for (int i = 0; i < OPW; ++i) wmma::fill_fragment(oacc[i], 0.0f);
  for (int k0 = 0; k0 < S; k0 += FA_BN) {
    __syncthreads();
    load_tile_bf16<DP>(kb, rs, k0, S, d, Ks);
    load_tile_bf16<DP>(vb, rs, k0, S, d, Vs);
    if (tid < FA_BN) {
      const int key = k0 + tid;
      kbias[tid] = key < S ? (mrow[key] > 0 ? 0.0f : -1e9f) : -INFINITY;
    }
    __syncthreads();
    scores_tc<DP>(Qs, Ks, Ss);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FA_BN / 4; ++j) {
      const int key = q + 4 * j;
      const float p = expf(Ss[row * SLD + key] * scale + kbias[key] - m) / l;
      Ps[row * PLD + key] = __float2bfloat16_rn(p);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OPW; ++i) {
      const int f = warp + i * (FA_THREADS / 32);
      if (f >= NOF) break;  // uniform across the warp
      const int fr = f / (DP / 16), fc = f % (DP / 16);
#pragma unroll
      for (int kk = 0; kk < FA_BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, fm_bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, fm_bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + fr * 16 * PLD + kk, PLD);
        wmma::load_matrix_sync(bv, Vs + kk * LD + fc * 16, LD);
        wmma::mma_sync(oacc[i], a, bv, oacc[i]);
      }
    }
  }

  // Epilogue: each output fragment through this warp's slice of the score tile.
  __syncthreads();
  float* st = Ss + warp * 256;
#pragma unroll
  for (int i = 0; i < OPW; ++i) {
    const int f = warp + i * (FA_THREADS / 32);
    if (f >= NOF) break;
    const int fr = f / (DP / 16), fc = f % (DP / 16);
    wmma::store_matrix_sync(st, oacc[i], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = q0 + fr * 16 + e / 16;
      const int c = fc * 16 + e % 16;
      if (r < S && c < d)
        out[((size_t)b * S + r) * H + (size_t)h * d + c] = __float2bfloat16_rn(st[e]);
    }
    __syncwarp();
  }
}

template <int DP>
cudaError_t launch_tc_dp(const void* qkv, const int* mask, void* out, int B, int S, int nh,
                         int d, float scale, cudaStream_t stream) {
  constexpr int bytes = TcSmem<DP>::BYTES;
  // Set on every launch: the attribute belongs to the current device, and
  // the call costs about a microsecond.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + FA_BM - 1) / FA_BM, nh, B);
  flash_attn_fwd_tc_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const fm_bf16*>(qkv), mask, static_cast<fm_bf16*>(out), S, nh, d, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* qkv, const int* mask, void* out, int B, int S, int nh, int d,
                      float scale, cudaStream_t stream) {
  if (d <= 32) return launch_tc_dp<32>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 64) return launch_tc_dp<64>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 96) return launch_tc_dp<96>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 128) return launch_tc_dp<128>(qkv, mask, out, B, S, nh, d, scale, stream);
  return cudaErrorInvalidValue;
}

// ---- fp32 dispatch ---------------------------------------------------------------

template <int DP>
cudaError_t launch_f32_dp(const void* qkv, const int* mask, void* out, int B, int S, int nh,
                          int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_f32_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);  // per device, as above
  if (e != cudaSuccess) return e;
  const dim3 grid((S + FA_BM - 1) / FA_BM, nh, B);
  flash_attn_fwd_f32_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), S, nh, d, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* qkv, const int* mask, void* out, int B, int S, int nh, int d,
                       float scale, cudaStream_t stream) {
  if (d <= 32) return launch_f32_dp<32>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 64) return launch_f32_dp<64>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 96) return launch_f32_dp<96>(qkv, mask, out, B, S, nh, d, scale, stream);
  if (d <= 128) return launch_f32_dp<128>(qkv, mask, out, B, S, nh, d, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qkv [B, S, 3H] (q | k | v column blocks, head h at offset h*d inside each),
// mask [B, S] int32 (1 = attend), out [B, S, H]; d = H / nh <= 128.
int fm_flash_attn_fwd(const void* qkv, const void* mask, void* out, int B, int S, int nh,
                      int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mask);
  if (dtype == FM_F32) return launch_f32(qkv, m, out, B, S, nh, d, scale, s);
  if (dtype == FM_BF16) return launch_tc(qkv, m, out, B, S, nh, d, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
