// Flash-style masked multi-head attention, forward and backward, over strided
// [B, heads, S, d] operands:
//
//     o[b, h] = softmax(q[b, h] k[b, h]^T * scale + bias[b]) v[b, h]
//     bias[b, key] = 0 where mask[b, key] > 0, else -1e9 (additive, NOT -inf);
//     no mask: every key attends
//
// Replaces two Pallas TPU kernels and the attention cores of four more:
//   - fairmultimodal_tpu/ops/flash_attention.py::_fwd_kernel (#9) and
//     ::_bwd_kernel (#10), which take q, k, v as separate [B, heads, S, D]
//     arrays and an optional [B, S] mask;
//   - the softmax-attention core of fused_attention_block.py::
//     _mega_ln_fwd_kernel / _mega_fwd_kernel (#1 / #5) and of
//     _mega_ln_bwd_kernel / _mega_bwd_kernel (#3 / #6), whose q, k, v sit in
//     one packed [B, S, 3H] projection buffer.
//
// Every operand is a base pointer plus batch, head and row strides in
// elements, the last dim contiguous (element (b, h, r, c) at
// p[b*sb + h*sh + r*sr + c]).  The packed layout is one case (q, k, v at
// column offsets 0, H, 2H, row stride 3H, head stride d), three [B, S, H]
// Dense outputs viewed as heads another (row stride H), a contiguous
// [B, heads, S, d] tensor a third (row stride d, head stride S*d): no head
// split or merge is ever materialised.  Tiles load 16 bytes at a time when
// d, the row stride and the head's base pointer allow it, and one element
// at a time otherwise.
//
// Bound at the lab shape (B 256, S 560, 8 heads x 96): the score and p.v
// products are 4*B*S*S*H = 2.5e11 FLOP (0.25 ms at the bf16 dense peak)
// while q/k/v/o move 0.9 GB (0.26 ms at 3.35 TB/s); the backward's five
// products 10*B*S*S*H = 6.2e11 (0.62 ms).
//
// Forward design.  The TPU kernel holds the whole [S, S] score tile in VMEM;
// an SM has 227 KB, so both kernels here tile the keys (64 at a time).  One
// 256-thread block owns 64 query rows of one (batch, head).  The head dim is
// padded with zeros to DP, a multiple of 32 (d 96 stays 96): the TPU
// kernel's 96 -> 128 pad was Mosaic's 128-lane rule and buys nothing here.
//   - bf16 (any d <= 128): tensor cores through WMMA, in two passes over
//     the keys.  Pass 1 computes the scores and the exact row max and sum;
//     pass 2 recomputes the scores, forms the NORMALISED p, rounds it to
//     bf16 and accumulates p.v in fp32 WMMA fragments -- the TPU kernel's
//     rounding exactly (flash_attention.py:62), and no running rescale of
//     the output fragments.  The price is a second q.k^T (1.5x the FLOPs).
//   - fp32: CUDA cores, one pass with an online softmax (running max and
//     sum); each thread owns 4 rows x 4 keys of a score tile and 4 rows x
//     DP/16 output columns.  fp32 rounds nothing, so normalising once at
//     the end differs from the TPU kernel only in summation order.
// Each row's max and sum are written to stats [B, heads, S, 2] when the
// backward will need them.
//
// Masking copies the TPU kernels exactly: -1e9 is added to the scaled score,
// so a fully masked row (the pad rows of an encode batch) gets a finite,
// uniform softmax instead of NaN.  Keys past S (the ragged last tile) get
// -inf and weigh exactly zero.
//
// What it leaves on the table: wgmma, K/V double buffering, keeping p in
// registers (mma.sync fragments) instead of staging scores through shared
// memory.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "fm_common.cuh"

namespace {

constexpr int FA_BM = 64;       // query rows per block
constexpr int FA_BN = 64;       // keys per tile
constexpr int FA_THREADS = 256;
constexpr int TSTR = FA_BM + 1;  // transposed q/k tile row stride (bank-conflict pad)
constexpr int PSTR = FA_BN + 1;  // p tile row stride

// One strided [B, heads, S, d] operand (last dim contiguous).
template <typename T>
struct Mat {
  T* p;
  long long sb, sh, sr;  // batch, head and row strides, in elements
  __device__ __forceinline__ T* head(int b, int h) const { return p + b * sb + h * sh; }
};

// The [B, S] key mask (int32, 1 = attend) and its batch stride; null: every
// key attends.
struct Mask {
  const int* p;
  long long sb;
  __device__ __forceinline__ const int* row(int b) const { return p ? p + b * sb : nullptr; }
};

// Additive bias of one key: 0 (attend), -1e9 (masked), -inf (past S).
__device__ __forceinline__ float key_bias(const int* mrow, int key, int S) {
  if (key >= S) return -INFINITY;
  return (mrow == nullptr || mrow[key] > 0) ? 0.0f : -1e9f;
}

// Whether rows of ``d`` elements of T at ``src`` + r * rs can be read 16
// bytes at a time.
template <typename T>
__device__ __forceinline__ bool vec16(const T* src, long long rs, int d) {
  constexpr int V = 16 / sizeof(T);
  return d % V == 0 && rs % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * TSTR + FA_BN * DP + FA_BM * PSTR + FA_BN);
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_fwd_f32_kernel(Mat<const float> Q, Mat<const float> K, Mat<const float> V, Mask mask,
                          Mat<float> O, float* __restrict__ stats, int S, int nh, int d,
                          float scale) {
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
  const float* qb = Q.head(b, h);
  const float* kb = K.head(b, h);
  const float* vb = V.head(b, h);
  const int* mrow = mask.row(b);

  for (int i = tid; i < FA_BM * DP; i += FA_THREADS) {
    const int row = i / DP, k = i % DP;
    float v = 0.0f;
    if (q0 + row < S && k < d) v = qb[(q0 + row) * Q.sr + k];
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
      Kt[k * TSTR + key] = ok ? kb[(k0 + key) * K.sr + k] : 0.0f;
      Vs[key * DP + k] = ok ? vb[(k0 + key) * V.sr + k] : 0.0f;
    }
    for (int i = tid; i < FA_BN; i += FA_THREADS) kbias[i] = key_bias(mrow, k0 + i, S);
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

  float* ob = O.head(b, h);
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
    float* dst = ob + row * O.sr;
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
template <int DP>
__device__ __forceinline__ void load_tile_bf16(const fm_bf16* __restrict__ src, long long rs,
                                               int r0, int S, int d, fm_bf16* dst) {
  constexpr int LD = DP + 8;
  if (vec16(src, rs, d)) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < FA_BM * CPR; c += FA_THREADS) {
      const int row = c / CPR;
      const int col = (c % CPR) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < S && col < d)
        v = *reinterpret_cast<const uint4*>(src + (r0 + row) * rs + col);
      *reinterpret_cast<uint4*>(dst + row * LD + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < FA_BM * DP; i += FA_THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] = (r0 + row < S && col < d) ? src[(r0 + row) * rs + col]
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
flash_attn_fwd_tc_kernel(Mat<const fm_bf16> Q, Mat<const fm_bf16> K, Mat<const fm_bf16> V,
                         Mask mask, Mat<fm_bf16> O, float* __restrict__ stats, int S, int nh,
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
  const fm_bf16* qb = Q.head(b, h);
  const fm_bf16* kb = K.head(b, h);
  const fm_bf16* vb = V.head(b, h);
  const int* mrow = mask.row(b);

  load_tile_bf16<DP>(qb, Q.sr, q0, S, d, Qs);

  // Pass 1: exact row max m and row sum l of exp(s - m).
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < S; k0 += FA_BN) {
    __syncthreads();
    load_tile_bf16<DP>(kb, K.sr, k0, S, d, Ks);
    if (tid < FA_BN) kbias[tid] = key_bias(mrow, k0 + tid, S);
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
    load_tile_bf16<DP>(kb, K.sr, k0, S, d, Ks);
    load_tile_bf16<DP>(vb, V.sr, k0, S, d, Vs);
    if (tid < FA_BN) kbias[tid] = key_bias(mrow, k0 + tid, S);
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
  fm_bf16* ob = O.head(b, h);
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
      if (r < S && c < d) ob[r * O.sr + c] = __float2bfloat16_rn(st[e]);
    }
    __syncwarp();
  }
}

// ---- host-side operands and the forward dispatch ----------------------------------

struct Op {  // a strided operand as the C entries take it
  const void* p;
  long long sb, sh, sr;
};

template <typename T>
Mat<T> as_mat(const Op& o) {
  return Mat<T>{(T*)o.p, o.sb, o.sh, o.sr};
}

struct FwdArgs {
  Op q, k, v, o;
  Mask mask;
  float* stats;
  int B, S, nh, d;
  float scale;
};

// The padded head dim of d (0 when d is outside 1..128).
int head_pad(int d) {
  if (d < 1 || d > 128) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
}

template <int DP>
cudaError_t launch_tc_dp(const FwdArgs& a, cudaStream_t stream) {
  constexpr int bytes = TcSmem<DP>::BYTES;
  // Set on every launch: the attribute belongs to the current device, and
  // the call costs about a microsecond.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + FA_BM - 1) / FA_BM, a.nh, a.B);
  flash_attn_fwd_tc_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      as_mat<const fm_bf16>(a.q), as_mat<const fm_bf16>(a.k), as_mat<const fm_bf16>(a.v),
      a.mask, as_mat<fm_bf16>(a.o), a.stats, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_dp(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_f32_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);  // per device, as above
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + FA_BM - 1) / FA_BM, a.nh, a.B);
  flash_attn_fwd_f32_kernel<DP><<<grid, FA_THREADS, bytes, stream>>>(
      as_mat<const float>(a.q), as_mat<const float>(a.k), as_mat<const float>(a.v), a.mask,
      as_mat<float>(a.o), a.stats, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const FwdArgs& a, int dtype, cudaStream_t s) {
  const bool bf16 = dtype == FM_BF16;
  if (!bf16 && dtype != FM_F32) return cudaErrorInvalidValue;
  switch (head_pad(a.d)) {
    case 32: return bf16 ? launch_tc_dp<32>(a, s) : launch_f32_dp<32>(a, s);
    case 64: return bf16 ? launch_tc_dp<64>(a, s) : launch_f32_dp<64>(a, s);
    case 96: return bf16 ? launch_tc_dp<96>(a, s) : launch_f32_dp<96>(a, s);
    case 128: return bf16 ? launch_tc_dp<128>(a, s) : launch_f32_dp<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- backward -------------------------------------------------------------------
//
// Replaces fairmultimodal_tpu/ops/flash_attention.py::_bwd_kernel (#10) and
// the attention core of fused_attention_block.py::_mega_ln_bwd_kernel
// (lines 717-744) / _mega_bwd_kernel.  The TPU kernels hold the whole
// [S, S] tile of one (batch, head) in VMEM and recompute P from the stored
// q and k.  Here two kernels tile it, each recomputing
// p = exp(s * scale + bias - m) / l from the row max and sum the forward
// stored (the same expression as the forward, so p is the forward's p bit
// for bit), and neither uses atomics:
//   - flash_bwd_dq: one block per 64-query tile (32 for fp32); it first
//     writes D_i = rowsum(dO * O) for its rows, then walks the key tiles:
//     dS = P * (dO.V^T - D), dQ += round(dS * scale) . K;
//   - flash_bwd_dkdv: one block per key tile, after flash_bwd_dq (it reads
//     D); it walks the query tiles: dV += round(P)^T . dO and
//     dK += round(dS * scale)^T . Q.
// The TPU kernels take the softmax-VJP row term as rowsum(dP * P)
// (flash_attention.py:93); with P normalised that equals dO . O, which is
// kept here (one pass over the keys instead of two), computed from the
// stored o (rounded to the io dtype in bf16, as is p before p.v), so in
// bf16 the two differ by about one bf16 rounding of D.  Rounding points
// are the TPU kernels': dO arrives in the io dtype, p and dS * scale are
// rounded before their products (:87, :94), dq/dk/dv are rounded when
// written.  With ``colpart`` (the dbqkv sums #3 / #6 need) the column sums
// of the fp32 dq | dk | dv over each tile's rows are written as partials
// [B * ceil(S / tile), 3 * heads * d] for fm_colsum; #10 passes null.
//
// Bound at the lab shape: 10*B*S^2*H = 6.2e11 FLOP of the TPU kernel's
// products (0.62 ms at the bf16 peak); this design executes 1.4x the
// four backward products (the dQ kernel recomputes S and dP).  bf16 runs
// every product on WMMA fragments; the dQ / dK / dV accumulators stay in
// registers, and the scores, dP, p and dS tiles go through shared memory
// (about 105 KB at d 96, two blocks per SM).  fp32 runs the same structure
// with CUDA-core FMA loops and its accumulators in shared memory.

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
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long rs, int r0, int S,
                                          int d, T* dst) {
  constexpr int V = Pad<T>::V;
  constexpr int LD = DP + V;
  if (vec16(src, rs, d)) {
    constexpr int CPR = DP / V;
    for (int c = threadIdx.x; c < TL * CPR; c += FA_THREADS) {
      const int row = c / CPR;
      const int col = (c % CPR) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < S && col < d)
        v = *reinterpret_cast<const uint4*>(src + (r0 + row) * rs + col);
      *reinterpret_cast<uint4*>(dst + row * LD + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < TL * DP; i += FA_THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] =
          (r0 + row < S && col < d) ? src[(r0 + row) * rs + col] : zero_of<T>();
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
  for (int i = threadIdx.x; i < TL; i += FA_THREADS) kbias[i] = key_bias(mrow, k0 + i, S);
}

// Write rows [r0, r0 + TL) of an fp32 accumulator tile to dst (row stride
// rs, rounded) and, when colpart is not null, the column sums of its valid
// rows to colpart (fp32).
template <typename T, int DP, int TL>
__device__ __forceinline__ void write_grad(const float* acc, int la, T* dst, long long rs,
                                           int r0, int S, int d, float* colpart) {
  for (int e = threadIdx.x; e < TL * d; e += FA_THREADS) {
    const int i = e / d, c = e % d;
    if (r0 + i < S) dst[(r0 + i) * rs + c] = fm::from_f32<T>(acc[i * la + c]);
  }
  if (!colpart) return;
  for (int c = threadIdx.x; c < d; c += FA_THREADS) {
    float s = 0.0f;
    for (int i = 0; i < TL && r0 + i < S; ++i) s += acc[i * la + c];
    colpart[c] = s;
  }
}

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(FA_THREADS, sizeof(T) == 2 ? 2 : 1)
flash_bwd_dq_kernel(Mat<const T> Q, Mat<const T> K, Mat<const T> V, Mat<const T> O,
                    Mat<const T> dO, Mask mask, const float* __restrict__ stats,
                    float* __restrict__ Dg, Mat<T> dQg, float* __restrict__ colpart, int S,
                    int nh, int d, float scale) {
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
  const T* qb = Q.head(b, h);
  const T* kb = K.head(b, h);
  const T* vb = V.head(b, h);
  const T* ob = O.head(b, h);
  const T* gb = dO.head(b, h);
  const int* mrow = mask.row(b);
  const size_t srow = ((size_t)b * nh + h) * S;  // row offset into stats / D

  load_rows<T, DP, TL>(qb, Q.sr, q0, S, d, Qs);
  load_rows<T, DP, TL>(gb, dO.sr, q0, S, d, dOs);
  load_row_stats(stats + srow * 2, nullptr, q0, S, TL, m_s, l_s, D_s);
  // D_i = rowsum(dO * O), one warp per row.
  for (int i = threadIdx.x / 32; i < TL; i += FA_THREADS / 32) {
    float s = 0.0f;
    if (q0 + i < S)
      for (int c = threadIdx.x % 32; c < d; c += 32)
        s += fm::to_f32(gb[(q0 + i) * dO.sr + c]) * fm::to_f32(ob[(q0 + i) * O.sr + c]);
    s = fm::warp_sum(s);
    if (threadIdx.x % 32 == 0) {
      D_s[i] = s;
      if (q0 + i < S) Dg[srow + q0 + i] = s;
    }
  }

  dQ.zero();
  for (int k0 = 0; k0 < S; k0 += TL) {
    __syncthreads();  // previous tile fully consumed; D_s, Qs, dOs ready
    load_rows<T, DP, TL>(kb, K.sr, k0, S, d, Ks);
    load_rows<T, DP, TL>(vb, V.sr, k0, S, d, Vs);
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
  const long long cps = 3LL * nh * d;  // colpart row: dq | dk | dv, head h at h*d
  write_grad<T, DP, TL>(dq, L::LA, dQg.head(b, h), dQg.sr, q0, S, d,
                        colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps +
                                      (size_t)h * d
                                : nullptr);
}

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(FA_THREADS, sizeof(T) == 2 ? 2 : 1)
flash_bwd_dkdv_kernel(Mat<const T> Q, Mat<const T> K, Mat<const T> V, Mat<const T> dO,
                      Mask mask, const float* __restrict__ stats, const float* __restrict__ Dg,
                      Mat<T> dKg, Mat<T> dVg, float* __restrict__ colpart, int S, int nh, int d,
                      float scale) {
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
  const T* qb = Q.head(b, h);
  const T* gb = dO.head(b, h);
  const size_t srow = ((size_t)b * nh + h) * S;

  load_rows<T, DP, TL>(K.head(b, h), K.sr, k0, S, d, Ks);
  load_rows<T, DP, TL>(V.head(b, h), V.sr, k0, S, d, Vs);
  load_key_bias(mask.row(b), k0, S, TL, kbias);
  dK.zero();
  dV.zero();

  for (int q0 = 0; q0 < S; q0 += TL) {
    __syncthreads();  // previous tile fully consumed
    load_rows<T, DP, TL>(qb, Q.sr, q0, S, d, Qs);
    load_rows<T, DP, TL>(gb, dO.sr, q0, S, d, dOs);
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
  const long long cps = 3LL * nh * d;
  const long long H = (long long)nh * d;
  float* cp = colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d
                      : nullptr;
  const float* dk = dK.tile(S32);
  __syncthreads();
  write_grad<T, DP, TL>(dk, L::LA, dKg.head(b, h), dKg.sr, k0, S, d, cp ? cp + H : nullptr);
  __syncthreads();
  const float* dv = dV.tile(S32);
  __syncthreads();
  write_grad<T, DP, TL>(dv, L::LA, dVg.head(b, h), dVg.sr, k0, S, d, cp ? cp + 2 * H : nullptr);
}

struct BwdArgs {
  Op q, k, v, o, dout, dq, dk, dv;
  Mask mask;
  const float* stats;
  float* D;
  float* colpart;
  int B, S, nh, d;
  float scale;
};

template <typename T, int DP>
cudaError_t launch_bwd_dp(const BwdArgs& a, cudaStream_t s) {
  constexpr int TL = sizeof(T) == 2 ? 64 : 32;
  constexpr int bytes = BwdSmem<T, DP, TL>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, TL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP, TL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + TL - 1) / TL, a.nh, a.B);
  flash_bwd_dq_kernel<T, DP, TL><<<grid, FA_THREADS, bytes, s>>>(
      as_mat<const T>(a.q), as_mat<const T>(a.k), as_mat<const T>(a.v), as_mat<const T>(a.o),
      as_mat<const T>(a.dout), a.mask, a.stats, a.D, as_mat<T>(a.dq), a.colpart, a.S, a.nh,
      a.d, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, DP, TL><<<grid, FA_THREADS, bytes, s>>>(
      as_mat<const T>(a.q), as_mat<const T>(a.k), as_mat<const T>(a.v),
      as_mat<const T>(a.dout), a.mask, a.stats, a.D, as_mat<T>(a.dk), as_mat<T>(a.dv),
      a.colpart, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_t(const BwdArgs& a, cudaStream_t s) {
  switch (head_pad(a.d)) {
    case 32: return launch_bwd_dp<T, 32>(a, s);
    case 64: return launch_bwd_dp<T, 64>(a, s);
    case 96: return launch_bwd_dp<T, 96>(a, s);
    case 128: return launch_bwd_dp<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == FM_F32) return launch_bwd_t<float>(a, s);
  if (dtype == FM_BF16) return launch_bwd_t<fm_bf16>(a, s);
  return cudaErrorInvalidValue;
}

Op strided(const void* p, const long long* s) { return Op{p, s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// Strided flash attention forward: Pallas #9, and the attention core of #1 /
// #5, whose packed [B, S, 3H] buffer the wrapper passes as head views.
// q, k, v, o: [B, nh, S, d] operands, each with its (batch, head, row)
// strides in elements at qs / ks / vs / os (three int64 values each; last
// dim contiguous); mask [B, S] int32 with batch stride mask_sb and key
// stride 1, or null (every key attends); d <= 128.  stats [B, nh, S, 2]
// fp32 (contiguous) receives each row's softmax max and sum when not null.
int fm_flash_attention_fwd(const void* q, const long long* qs, const void* k,
                           const long long* ks, const void* v, const long long* vs,
                           const void* mask, long long mask_sb, void* o, const long long* os,
                           void* stats, int B, int S, int nh, int d, float scale, int dtype,
                           void* stream) {
  const FwdArgs a{strided(q, qs), strided(k, ks), strided(v, vs), strided(o, os),
                  Mask{static_cast<const int*>(mask), mask_sb}, static_cast<float*>(stats),
                  B, S, nh, d, scale};
  return launch_fwd(a, dtype, static_cast<cudaStream_t>(stream));
}

// Strided flash attention backward (Pallas #10, and the attention core of
// #3 / #6 with colpart), two launches: q, k, v, o,
// dout (dO, io dtype) as in fm_flash_attention_fwd, stats from it; D
// [B, nh, S] fp32 scratch; writes dq, dk, dv (strided, io dtype) and, when
// colpart is not null, the column partials [B * ceil(S / tile), 3 * nh * d]
// fp32 of the fp32 dq | dk | dv, tile = 64 (bf16) or 32 (fp32).
int fm_flash_attention_bwd(const void* q, const long long* qs, const void* k,
                           const long long* ks, const void* v, const long long* vs,
                           const void* o, const long long* os, const void* dout,
                           const long long* dos, const void* mask, long long mask_sb,
                           const void* stats, void* D, void* dq, const long long* dqs, void* dk,
                           const long long* dks, void* dv, const long long* dvs, void* colpart,
                           int B, int S, int nh, int d, float scale, int dtype, void* stream) {
  const BwdArgs a{strided(q, qs), strided(k, ks), strided(v, vs), strided(o, os),
                  strided(dout, dos), strided(dq, dqs), strided(dk, dks), strided(dv, dvs),
                  Mask{static_cast<const int*>(mask), mask_sb},
                  static_cast<const float*>(stats), static_cast<float*>(D),
                  static_cast<float*>(colpart), B, S, nh, d, scale};
  return launch_bwd(a, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
