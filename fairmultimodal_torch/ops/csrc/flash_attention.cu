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

#include <type_traits>

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
                          float* __restrict__ out, float* __restrict__ stats, int S, int nh,
                          int d, float scale) {
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
    if (stats && c == 0) {
      float* st = stats + (((size_t)b * nh + h) * S + row) * 2;
      st[0] = m_i[i];
      st[1] = l;
    }
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
                         fm_bf16* __restrict__ out, float* __restrict__ stats, int S, int nh,
                         int d, float scale) {
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
  if (stats && q == 0 && q0 + row < S) {
    float* st = stats + (((size_t)b * nh + h) * S + q0 + row) * 2;
    st[0] = m;
    st[1] = l;
  }

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
cudaError_t launch_tc_dp(const void* qkv, const int* mask, void* out, float* stats, int B,
                         int S, int nh, int d, float scale, cudaStream_t stream) {
  constexpr int bytes = TcSmem<DP>::BYTES;
  // Set on every launch: the attribute belongs to the current device, and
  // the call costs about a microsecond.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + FA_BM - 1) / FA_BM, nh, B);
  flash_attn_fwd_tc_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const fm_bf16*>(qkv), mask, static_cast<fm_bf16*>(out), stats, S, nh, d,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* qkv, const int* mask, void* out, float* stats, int B, int S,
                  int nh, int d, float scale, cudaStream_t stream) {
  if (d <= 32) return launch_tc_dp<32>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 64) return launch_tc_dp<64>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 96) return launch_tc_dp<96>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 128) return launch_tc_dp<128>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  return cudaErrorInvalidValue;
}

// ---- fp32 dispatch ---------------------------------------------------------------

template <int DP>
cudaError_t launch_f32_dp(const void* qkv, const int* mask, void* out, float* stats, int B,
                          int S, int nh, int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_f32_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);  // per device, as above
  if (e != cudaSuccess) return e;
  const dim3 grid((S + FA_BM - 1) / FA_BM, nh, B);
  flash_attn_fwd_f32_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), stats, S, nh, d, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* qkv, const int* mask, void* out, float* stats, int B, int S,
                  int nh, int d, float scale, cudaStream_t stream) {
  if (d <= 32) return launch_f32_dp<32>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 64) return launch_f32_dp<64>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 96) return launch_f32_dp<96>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  if (d <= 128) return launch_f32_dp<128>(qkv, mask, out, stats, B, S, nh, d, scale, stream);
  return cudaErrorInvalidValue;
}


// ---- backward -------------------------------------------------------------------
//
// Replaces the attention core of the Pallas TPU kernel
// fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_bwd_kernel
// (lines 717-744), which holds the whole [S, S] tile of one (batch, head)
// in VMEM and recomputes P from the stored q and k.  Here two kernels tile
// it, each recomputing p = exp(s * scale + bias - m) / l from the row max
// and sum the forward stored (the same expression as the forward, so p is
// the forward's p bit for bit), and neither uses atomics:
//   - flash_bwd_dq: one block per 64-query tile (32 for fp32); it first
//     writes D_i = rowsum(dO * O) for its rows, then walks the key tiles:
//     dS = P * (dO.V^T - D), dQ += round(dS * scale) . K;
//   - flash_bwd_dkdv: one block per key tile, after flash_bwd_dq (it reads
//     D); it walks the query tiles: dV += round(P)^T . dO and
//     dK += round(dS * scale)^T . Q.
// The TPU kernel takes the softmax-VJP row term as rowsum(dP * P); with P
// normalised that equals dO . O, and D here is computed from the stored o
// (rounded to the io dtype in bf16).  Rounding points are the TPU kernel's:
// dO arrives in the io dtype, p and dS * scale are rounded before their
// products, dq/dk/dv are rounded when written into the [B, S, 3H] dqkv
// buffer (head h at column h*d of each of the q | k | v blocks) while their
// bias grads are column sums of the fp32 values, written as per-tile
// partials [B * ceil(S / tile), 3H] for fm_colsum.
//
// Bound at the lab shape: 8*B*S^2*H = 5.1e11 FLOP of the attention
// backward's products (0.52 ms at the bf16 peak); this design executes
// 1.4x that (the dQ kernel recomputes S and dP).  bf16 runs every product
// on WMMA fragments; the dQ / dK / dV accumulators stay in registers, and
// the scores, dP, p and dS tiles go through shared memory (about 105 KB at
// d 96, two blocks per SM).  fp32 runs the same structure with CUDA-core
// FMA loops and its accumulators in shared memory.

template <typename T>
struct Pad {
  static constexpr int V = 16 / sizeof(T);  // elements per 16 bytes
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ fm_bf16 zero_of<fm_bf16>() { return __float2bfloat16_rn(0.0f); }

// TL rows x d columns of one head (row stride rs) -> dst[TL][LD], zero padded.
template <typename T, int DP, int TL>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, size_t rs, int r0, int S,
                                          int d, T* dst) {
  constexpr int V = Pad<T>::V;
  constexpr int LD = DP + V;
  if (d % V == 0) {
    constexpr int CPR = DP / V;
    for (int c = threadIdx.x; c < TL * CPR; c += FA_THREADS) {
      const int row = c / CPR;
      const int col = (c % CPR) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < S && col < d)
        v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * rs + col);
      *reinterpret_cast<uint4*>(dst + row * LD + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < TL * DP; i += FA_THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] =
          (r0 + row < S && col < d) ? src[(size_t)(r0 + row) * rs + col] : zero_of<T>();
    }
  }
}

// C[M][N] (fp32, pitch ldc) = (acc ? C : 0) + op(A) . op(B) over depth K.
// A element (i, k) is A[i*sa + k], or A[k*sa + i] when AT; B element (k, j)
// is B[k*sb + j], or B[j*sb + k] when BT.
template <int M, int N, bool AT, bool BT>
__device__ __forceinline__ void tile_mm(const fm_bf16* A, int sa, const fm_bf16* B, int sb,
                                        int K, float* C, int ldc, bool acc) {
  using namespace nvcuda;
  using ALay = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLay = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  constexpr int FN = N / 16;
  for (int f = threadIdx.x / 32; f < (M / 16) * FN; f += FA_THREADS / 32) {
    const int i0 = (f / FN) * 16, j0 = (f % FN) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, fm_bf16, ALay> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, fm_bf16, BLay> b;
      wmma::load_matrix_sync(a, AT ? A + k * sa + i0 : A + i0 * sa + k, sa);
      wmma::load_matrix_sync(b, BT ? B + j0 * sb + k : B + k * sb + j0, sb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

template <int M, int N, bool AT, bool BT>
__device__ __forceinline__ void tile_mm(const float* A, int sa, const float* B, int sb, int K,
                                        float* C, int ldc, bool acc) {
  for (int e = threadIdx.x; e < M * N; e += FA_THREADS) {
    const int i = e / N, j = e % N;
    float s = 0.0f;  // fmaf in k order: the fp32 forward's score arithmetic
    for (int k = 0; k < K; ++k)
      s = fmaf(AT ? A[k * sa + i] : A[i * sa + k], BT ? B[j * sb + k] : B[k * sb + j], s);
    C[i * ldc + j] = acc ? C[i * ldc + j] + s : s;
  }
}

template <typename T, int DP, int TL>
struct BwdSmem {  // byte offsets of the shared-memory regions
  static constexpr int LD = DP + Pad<T>::V;  // io tiles [TL][LD]
  static constexpr int LP = TL + Pad<T>::V;  // io p / dS tiles [TL][LP]
  static constexpr int LA = DP + 4;          // fp32 accumulators [TL][LA]
  static constexpr int LS = TL + 4;          // fp32 score tiles [TL][LS]
  static constexpr int T0 = 0;               // four io tiles
  static constexpr int ACC = T0 + 4 * round128(TL * LD * (int)sizeof(T));
  // fp32 keeps its two gradient accumulators here; bf16 keeps them in
  // registers and stages one at a time through S32 / DP32 at the end.
  static constexpr int S32 = ACC + (sizeof(T) == 2 ? 0 : 2 * round128(TL * LA * 4));
  static constexpr int DP32 = S32 + round128(TL * LS * 4);
  static constexpr int PIO = DP32 + round128(TL * LS * 4);
  static constexpr int DSIO = PIO + round128(TL * LP * (int)sizeof(T));
  static constexpr int VEC = DSIO + round128(TL * LP * (int)sizeof(T));  // 4 x [TL] fp32
  static constexpr int BYTES = VEC + round128(4 * TL * 4);
};

// Accumulator of one [TL][DP] gradient tile.  bf16: WMMA fragments in
// registers, warp w owning fragments w, w + 8, ... (no shared-memory round
// trip per product); fp32: a tile in shared memory at ``smem`` (pitch la).
template <typename T, int DP, int TL>
struct GradAcc {
  float* c;
  int la;
  __device__ GradAcc(float* smem, int pitch) : c(smem), la(pitch) {}
  __device__ void zero() {
    for (int e = threadIdx.x; e < TL * la; e += FA_THREADS) c[e] = 0.0f;
  }
  template <bool AT>  // += op(A) . B, B [K][DP] row-major
  __device__ void mma(const float* A, int sa, const float* B, int sb, int K) {
    tile_mm<TL, DP, AT, false>(A, sa, B, sb, K, c, la, true);
  }
  __device__ const float* tile(float*) { return c; }
};

template <int DP, int TL>
struct GradAcc<fm_bf16, DP, TL> {
  static constexpr int FN = DP / 16;
  static constexpr int FPW = (TL / 16) * FN / (FA_THREADS / 32);
  static_assert(FPW * (FA_THREADS / 32) == (TL / 16) * FN, "fragments per warp");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[FPW];
  int la;
  __device__ GradAcc(float*, int pitch) : la(pitch) {}
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FPW; ++i) nvcuda::wmma::fill_fragment(f[i], 0.0f);
  }
  template <bool AT>
  __device__ void mma(const fm_bf16* A, int sa, const fm_bf16* B, int sb, int K) {
    using namespace nvcuda;
    using ALay = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int fi = warp + i * (FA_THREADS / 32);
      const int i0 = (fi / FN) * 16, j0 = (fi % FN) * 16;
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, fm_bf16, ALay> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, fm_bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, AT ? A + k * sa + i0 : A + i0 * sa + k, sa);
        wmma::load_matrix_sync(b, B + k * sb + j0, sb);
        wmma::mma_sync(f[i], a, b, f[i]);
      }
    }
  }
  // The fp32 tile, stored into ``stage`` [TL][la]; read it after a barrier.
  __device__ const float* tile(float* stage) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int fi = warp + i * (FA_THREADS / 32);
      nvcuda::wmma::store_matrix_sync(stage + (fi / FN) * 16 * la + (fi % FN) * 16, f[i], la,
                                      nvcuda::wmma::mem_row_major);
    }
    return stage;
  }
};

// Row max m and sum l of the forward, and D; rows past S get l = inf (so
// p = 0) and D = 0.
__device__ __forceinline__ void load_row_stats(const float* stats, const float* Dg, int r0,
                                               int S, int TL, float* m, float* l, float* D) {
  for (int i = threadIdx.x; i < TL; i += FA_THREADS) {
    const bool ok = r0 + i < S;
    m[i] = ok ? stats[(size_t)(r0 + i) * 2] : 0.0f;
    l[i] = ok ? stats[(size_t)(r0 + i) * 2 + 1] : INFINITY;
    if (Dg) D[i] = ok ? Dg[r0 + i] : 0.0f;
  }
}

__device__ __forceinline__ void load_key_bias(const int* mrow, int k0, int S, int TL,
                                              float* kbias) {
  for (int i = threadIdx.x; i < TL; i += FA_THREADS) {
    const int key = k0 + i;
    kbias[i] = key < S ? (mrow[key] > 0 ? 0.0f : -1e9f) : -INFINITY;
  }
}

// Write rows [r0, r0 + TL) of an fp32 accumulator tile to dqkv (rounded)
// and the column sums of its valid rows to colpart (fp32).
template <typename T, int DP, int TL>
__device__ __forceinline__ void write_grad(const float* acc, int la, T* dst, size_t rs, int r0,
                                           int S, int d, float* colpart) {
  for (int e = threadIdx.x; e < TL * d; e += FA_THREADS) {
    const int i = e / d, c = e % d;
    if (r0 + i < S) dst[(size_t)(r0 + i) * rs + c] = fm::from_f32<T>(acc[i * la + c]);
  }
  for (int c = threadIdx.x; c < d; c += FA_THREADS) {
    float s = 0.0f;
    for (int i = 0; i < TL && r0 + i < S; ++i) s += acc[i * la + c];
    colpart[c] = s;
  }
}

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(FA_THREADS, sizeof(T) == 2 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                    const T* __restrict__ dout, const int* __restrict__ mask,
                    const float* __restrict__ stats, float* __restrict__ Dg,
                    T* __restrict__ dqkv, float* __restrict__ colpart, int S, int nh, int d,
                    float scale) {
  using L = BwdSmem<T, DP, TL>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw + L::T0);
  T* dOs = Qs + TL * L::LD;
  T* Ks = dOs + TL * L::LD;
  T* Vs = Ks + TL * L::LD;
  GradAcc<T, DP, TL> dQ(reinterpret_cast<float*>(smem_raw + L::ACC), L::LA);
  float* S32 = reinterpret_cast<float*>(smem_raw + L::S32);
  float* dP32 = reinterpret_cast<float*>(smem_raw + L::DP32);
  T* dSio = reinterpret_cast<T*>(smem_raw + L::DSIO);
  float* m_s = reinterpret_cast<float*>(smem_raw + L::VEC);
  float* l_s = m_s + TL;
  float* D_s = l_s + TL;
  float* kbias = D_s + TL;

  const int q0 = blockIdx.x * TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * d;
  const size_t rs = 3 * (size_t)H;
  const T* qb = qkv + (size_t)b * S * rs + (size_t)h * d;
  const T* kb = qb + H;
  const T* vb = qb + 2 * H;
  const size_t ho = (size_t)b * S * H + (size_t)h * d;  // head offset in [B, S, H]
  const int* mrow = mask + (size_t)b * S;
  const size_t srow = ((size_t)b * nh + h) * S;  // row offset into stats / D

  load_rows<T, DP, TL>(qb, rs, q0, S, d, Qs);
  load_rows<T, DP, TL>(dout + ho, H, q0, S, d, dOs);
  load_row_stats(stats + srow * 2, nullptr, q0, S, TL, m_s, l_s, D_s);
  // D_i = rowsum(dO * O), one warp per row.
  for (int i = threadIdx.x / 32; i < TL; i += FA_THREADS / 32) {
    float s = 0.0f;
    if (q0 + i < S)
      for (int c = threadIdx.x % 32; c < d; c += 32)
        s += fm::to_f32(dout[ho + (size_t)(q0 + i) * H + c]) *
             fm::to_f32(o[ho + (size_t)(q0 + i) * H + c]);
    s = fm::warp_sum(s);
    if (threadIdx.x % 32 == 0) {
      D_s[i] = s;
      if (q0 + i < S) Dg[srow + q0 + i] = s;
    }
  }

  dQ.zero();
  for (int k0 = 0; k0 < S; k0 += TL) {
    __syncthreads();  // previous tile fully consumed; D_s, Qs, dOs ready
    load_rows<T, DP, TL>(kb, rs, k0, S, d, Ks);
    load_rows<T, DP, TL>(vb, rs, k0, S, d, Vs);
    load_key_bias(mrow, k0, S, TL, kbias);
    __syncthreads();
    tile_mm<TL, TL, false, true>(Qs, L::LD, Ks, L::LD, DP, S32, L::LS, false);
    tile_mm<TL, TL, false, true>(dOs, L::LD, Vs, L::LD, DP, dP32, L::LS, false);
    __syncthreads();
    for (int e = threadIdx.x; e < TL * TL; e += FA_THREADS) {
      const int i = e / TL, j = e % TL;
      const float p = expf(S32[i * L::LS + j] * scale + kbias[j] - m_s[i]) / l_s[i];
      const float ds = p * (dP32[i * L::LS + j] - D_s[i]);
      dSio[i * L::LP + j] = fm::from_f32<T>(ds * scale);
    }
    __syncthreads();
    dQ.template mma<false>(dSio, L::LP, Ks, L::LD, TL);
  }
  __syncthreads();
  const float* dq = dQ.tile(S32);
  __syncthreads();
  const int ntiles = gridDim.x;
  write_grad<T, DP, TL>(dq, L::LA, dqkv + (size_t)b * S * rs + (size_t)h * d, rs, q0, S, d,
                        colpart + ((size_t)b * ntiles + blockIdx.x) * rs + (size_t)h * d);
}

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(FA_THREADS, sizeof(T) == 2 ? 2 : 1)
flash_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      const int* __restrict__ mask, const float* __restrict__ stats,
                      const float* __restrict__ Dg, T* __restrict__ dqkv,
                      float* __restrict__ colpart, int S, int nh, int d, float scale) {
  using L = BwdSmem<T, DP, TL>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw + L::T0);
  T* Vs = Ks + TL * L::LD;
  T* Qs = Vs + TL * L::LD;
  T* dOs = Qs + TL * L::LD;
  GradAcc<T, DP, TL> dK(reinterpret_cast<float*>(smem_raw + L::ACC), L::LA);
  GradAcc<T, DP, TL> dV(reinterpret_cast<float*>(smem_raw + L::ACC) + TL * L::LA, L::LA);
  float* S32 = reinterpret_cast<float*>(smem_raw + L::S32);
  float* dP32 = reinterpret_cast<float*>(smem_raw + L::DP32);
  T* Pio = reinterpret_cast<T*>(smem_raw + L::PIO);
  T* dSio = reinterpret_cast<T*>(smem_raw + L::DSIO);
  float* m_s = reinterpret_cast<float*>(smem_raw + L::VEC);
  float* l_s = m_s + TL;
  float* D_s = l_s + TL;
  float* kbias = D_s + TL;

  const int k0 = blockIdx.x * TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * d;
  const size_t rs = 3 * (size_t)H;
  const T* qb = qkv + (size_t)b * S * rs + (size_t)h * d;
  const T* kb = qb + H;
  const T* vb = qb + 2 * H;
  const size_t ho = (size_t)b * S * H + (size_t)h * d;
  const size_t srow = ((size_t)b * nh + h) * S;

  load_rows<T, DP, TL>(kb, rs, k0, S, d, Ks);
  load_rows<T, DP, TL>(vb, rs, k0, S, d, Vs);
  load_key_bias(mask + (size_t)b * S, k0, S, TL, kbias);
  dK.zero();
  dV.zero();

  for (int q0 = 0; q0 < S; q0 += TL) {
    __syncthreads();  // previous tile fully consumed
    load_rows<T, DP, TL>(qb, rs, q0, S, d, Qs);
    load_rows<T, DP, TL>(dout + ho, H, q0, S, d, dOs);
    load_row_stats(stats + srow * 2, Dg + srow, q0, S, TL, m_s, l_s, D_s);
    __syncthreads();
    tile_mm<TL, TL, false, true>(Qs, L::LD, Ks, L::LD, DP, S32, L::LS, false);
    tile_mm<TL, TL, false, true>(dOs, L::LD, Vs, L::LD, DP, dP32, L::LS, false);
    __syncthreads();
    for (int e = threadIdx.x; e < TL * TL; e += FA_THREADS) {
      const int i = e / TL, j = e % TL;  // query i, key j
      const float p = expf(S32[i * L::LS + j] * scale + kbias[j] - m_s[i]) / l_s[i];
      const float ds = p * (dP32[i * L::LS + j] - D_s[i]);
      Pio[i * L::LP + j] = fm::from_f32<T>(p);
      dSio[i * L::LP + j] = fm::from_f32<T>(ds * scale);
    }
    __syncthreads();
    dV.template mma<true>(Pio, L::LP, dOs, L::LD, TL);
    dK.template mma<true>(dSio, L::LP, Qs, L::LD, TL);
  }
  __syncthreads();
  const int ntiles = gridDim.x;
  T* gb = dqkv + (size_t)b * S * rs + (size_t)h * d;
  float* cp = colpart + ((size_t)b * ntiles + blockIdx.x) * rs + (size_t)h * d;
  const float* dk = dK.tile(S32);
  __syncthreads();
  write_grad<T, DP, TL>(dk, L::LA, gb + H, rs, k0, S, d, cp + H);
  __syncthreads();
  const float* dv = dV.tile(S32);
  __syncthreads();
  write_grad<T, DP, TL>(dv, L::LA, gb + 2 * H, rs, k0, S, d, cp + 2 * H);
}

template <typename T, int DP>
cudaError_t launch_bwd_dp(const void* qkv, const void* o, const void* dout, const int* mask,
                          const float* stats, float* D, void* dqkv, float* colpart, int B,
                          int S, int nh, int d, float scale, cudaStream_t s) {
  constexpr int TL = sizeof(T) == 2 ? 64 : 32;
  constexpr int bytes = BwdSmem<T, DP, TL>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, TL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP, TL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + TL - 1) / TL, nh, B);
  flash_bwd_dq_kernel<T, DP, TL><<<grid, FA_THREADS, bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(o), static_cast<const T*>(dout), mask,
      stats, D, static_cast<T*>(dqkv), colpart, S, nh, d, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, DP, TL><<<grid, FA_THREADS, bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), mask, stats, D,
      static_cast<T*>(dqkv), colpart, S, nh, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* qkv, const void* o, const void* dout, const int* mask,
                       const float* stats, float* D, void* dqkv, float* colpart, int B, int S,
                       int nh, int d, float scale, cudaStream_t s) {
  if (d <= 32)
    return launch_bwd_dp<T, 32>(qkv, o, dout, mask, stats, D, dqkv, colpart, B, S, nh, d, scale, s);
  if (d <= 64)
    return launch_bwd_dp<T, 64>(qkv, o, dout, mask, stats, D, dqkv, colpart, B, S, nh, d, scale, s);
  if (d <= 96)
    return launch_bwd_dp<T, 96>(qkv, o, dout, mask, stats, D, dqkv, colpart, B, S, nh, d, scale, s);
  if (d <= 128)
    return launch_bwd_dp<T, 128>(qkv, o, dout, mask, stats, D, dqkv, colpart, B, S, nh, d, scale,
                                 s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qkv [B, S, 3H] (q | k | v column blocks, head h at offset h*d inside each),
// mask [B, S] int32 (1 = attend), out [B, S, H]; d = H / nh <= 128.  stats
// [B, nh, S, 2] fp32 receives each row's softmax max and sum (the backward's
// residual) when not null.
int fm_flash_attn_fwd(const void* qkv, const void* mask, void* out, void* stats, int B, int S,
                      int nh, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mask);
  float* st = static_cast<float*>(stats);
  if (dtype == FM_F32) return launch_f32(qkv, m, out, st, B, S, nh, d, scale, s);
  if (dtype == FM_BF16) return launch_tc(qkv, m, out, st, B, S, nh, d, scale, s);
  return cudaErrorInvalidValue;
}

// Backward of the attention core: qkv [B, S, 3H] and o [B, S, H] from the
// forward, dout [B, S, H] (dO, io dtype), mask [B, S] int32, stats [B, nh,
// S, 2] from fm_flash_attn_fwd.  Writes D [B, nh, S] fp32 (scratch), dqkv
// [B, S, 3H] (io dtype) and colpart [B * ceil(S / tile), 3H] fp32 column
// partials of the fp32 dq | dk | dv, tile = 64 (bf16) or 32 (fp32).
int fm_flash_attn_bwd(const void* qkv, const void* o, const void* dout, const void* mask,
                      const void* stats, void* D, void* dqkv, void* colpart, int B, int S,
                      int nh, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mask);
  const float* st = static_cast<const float*>(stats);
  float* dd = static_cast<float*>(D);
  float* cp = static_cast<float*>(colpart);
  if (dtype == FM_F32)
    return launch_bwd<float>(qkv, o, dout, m, st, dd, dqkv, cp, B, S, nh, d, scale, s);
  if (dtype == FM_BF16)
    return launch_bwd<fm_bf16>(qkv, o, dout, m, st, dd, dqkv, cp, B, S, nh, d, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
