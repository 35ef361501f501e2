// Tiled GEMM with a fused epilogue, in the three layouts the two half-layers
// need forward and backward:
//
//     "nt"  C[M, N] = A[M, K] . B[N, K]^T    B in nn.Linear layout (forward)
//     "nn"  C[M, N] = A[M, K] . B[K, N]      dX = dY . W (backward)
//     "tn"  C[M, N] = A[K, M]^T . B[K, N]    dW = dY^T . X, K = the R rows
//
// Epilogue, per element v of the fp32 accumulator (each step optional):
//     v += bias[col]; aux = round(v) (a pre-activation residual);
//     v = act(v) (none | relu | exact gelu); v = dropout(v) (Philox, the
//     FFN's inner stream); v *= gate'(gate[row, col]) where gate' is
//     1[gate > 0] * scale (relu; scale = 1/keep) or dgelu(gate) (gelu, and
//     then aux = round(gelu(gate))); v += resid[row, col] (fp32);
//     column sums of v over the block's rows -> colpart[blockIdx.y, col];
//     C = v in the io dtype or fp32.
//
// Replaces the matrix products inside eight Pallas TPU kernels:
//   - fairmultimodal_tpu/ops/fused_attention_block.py::_mega_ln_fwd_kernel
//     (q/k/v projections as one "nt" launch with N = 3H; Wo into fp32) and
//     ::_mega_ln_bwd_kernel (dO = da.Wo and dx = dz + dqkv.Wqkv as "nn",
//     dWo and dWqkv as "tn");
//   - fairmultimodal_tpu/ops/fused_ffn.py::_fwd_ln_kernel (x.W1 + b1 with
//     relu + inner dropout or gelu, a.W2 + b2 in fp32) and ::_bwd_ln_kernel
//     (dh = (dy.W2) * mask or dgelu, dx = dz + dh.W1, dW1, dW2);
//   - the unfolded pairs ::_mega_fwd_kernel / ::_mega_bwd_kernel and
//     fused_ffn.py::_fwd_kernel / ::_bwd_kernel: the same products, with
//     Wo and W2 rounded to the io dtype after the bias (their `out`), dO
//     and dh taken from the cotangent g, and dx stored plain (no residual).
//     row_block_sums_kernel + colsum_kernel give their dbo and db2 = sum g.
//
// Bound at the lab shapes (bf16 dense peak 989 TFLOP/s, H100 SXM): every
// product here is operation-bound; the FFN's four backward products are
// 8*R*H*F = 1.8e12 FLOP (1.82 ms), the attention backward's projections
// 16*R*H^2 = 1.35e12.  The bytes (operands once) take about a seventh.
//
// Design.  What bounds a bf16 product is the tensor cores' rate, and only
// wgmma reaches it.
//   - bf16, every layout: gemm_wgmma_kernel, a 128 x 256 tile per block of
//     two consumer warpgroups (m64n256k16 wgmma from shared memory) and a
//     producer warpgroup whose one thread keeps four 64-deep K stages of A
//     and B in flight by TMA (128-byte swizzle, full / empty mbarriers).
//     Each operand is K-major (the "nt" forward's A and B, the "nn" dY) or
//     MN-major (the "nn" weight, both "tn" operands): an MN-major operand
//     comes in 64-wide boxes, gets its own descriptor (leading offset one
//     box, a 2048-byte step per 16 of K) and sets the wgmma's transpose
//     immediate, so no operand is ever transposed in memory.  At 128 x 256
//     a tile needs about 11 TB/s of L2 traffic for the peak rate, so L2
//     rather than the tensor cores may bound it.
//   - fp32 (any layout): CUDA-core FMA with 8x8 outputs per thread (full
//     fp32, no TF32); it serves the card-vs-CPU checks, not the main path.
// The epilogue is chosen at compile time (Mode) and works on groups of 8
// (bf16) or 4 (fp32) consecutive columns: 16-byte loads and stores and one
// Philox call per 4 elements, so at K = 768 it stays small next to the
// main loop.
// "tn" reduces over R = 143360 rows: it splits K over gridDim.z and writes
// fp32 partials [splits, M, N] that fm_colsum adds in a fixed order, so the
// sum is the same bits every run (no atomics anywhere).  Column sums for
// the bias grads are per row-block partials, also added by fm_colsum.
// What it leaves on the table: a persistent schedule (the epilogue does not
// overlap the next tile's loads), TMA multicast across a cluster (L2
// traffic), a split-K "tn" whose partials stay in the cluster, and the TPU
// kernels' fusion (q/k/v/o, the [R, F] intermediate and dz round-trip HBM).
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "fm_common.cuh"
#include "philox.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps rows 16-byte aligned, shifts banks

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };
enum Gate { GATE_NONE = 0, GATE_RELU = 1, GATE_DGELU = 2 };
// Which epilogue a launch runs, fixed at compile time so that each kernel
// carries only its own steps: the forward's bias + activation (+ dropout,
// + pre-activation copy), the backward's plain store (dO, weight grads),
// its gated store (dh, with the bias-grad column sums) and its residual add
// (dx).
enum Mode { EPI_STORE = 0, EPI_BIAS_ACT = 1, EPI_GATE = 2, EPI_RESID = 3 };

struct Epi {
  const float* bias;
  int act;
  fm::Dropout drop;
  void* aux;
  const void* gate;
  int gate_kind;
  float gate_scale;
  const float* resid;
  float* colpart;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float dgelu(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * 0.3989422804014327f * expf(-0.5f * u * u);
}

// G consecutive values (G = 4 or 8) as fp32, 16 bytes at a time.
template <int G>
__device__ __forceinline__ void load_group(const float* p, float* v) {
#pragma unroll
  for (int h = 0; h < G / 4; ++h) {
    const float4 a = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = a.x; v[4 * h + 1] = a.y; v[4 * h + 2] = a.z; v[4 * h + 3] = a.w;
  }
}
template <int G>
__device__ __forceinline__ void load_group(const fm_bf16* p, float* v) {
  static_assert(G == 8, "bf16 groups are 16 bytes");
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const fm_bf16* h = reinterpret_cast<const fm_bf16*>(&u);
#pragma unroll
  for (int k = 0; k < G; ++k) v[k] = __bfloat162float(h[k]);
}
template <int G>
__device__ __forceinline__ void store_group(float* p, const float* v) {
#pragma unroll
  for (int h = 0; h < G / 4; ++h)
    reinterpret_cast<float4*>(p)[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}
template <int G>
__device__ __forceinline__ void store_group(fm_bf16* p, const float* v) {
  static_assert(G == 8, "bf16 groups are 16 bytes");
  uint4 u;
  fm_bf16* h = reinterpret_cast<fm_bf16*>(&u);
#pragma unroll
  for (int k = 0; k < G; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The epilogue of the G consecutive elements v[0..G) of row `row` from
// column `col` (a multiple of G) into C, adding each stored value to csum
// (EPI_GATE).  T is the io dtype of aux and gate.  Whole groups inside a
// row whose length is a multiple of G take 16-byte loads and stores and one
// Philox call per 4 elements; a ragged group goes element by element.  Every
// loop runs over all G with constant indices (the ragged one skips k >= n),
// so v and t stay in registers.
template <int MODE, int G, typename T, typename TOut>
__device__ __forceinline__ void epilogue_group(const Epi& e, int row, int col, int N, float* v,
                                               TOut* __restrict__ C, float* csum) {
  const size_t off = (size_t)row * N + col;
  const bool vec = N % G == 0;  // then every group is whole (col % G == 0)
  const int n = vec ? G : min(G, N - col);
  float t[G];
#pragma unroll
  for (int k = 0; k < G; ++k) t[k] = 0.0f;
  if (MODE == EPI_BIAS_ACT) {
    if (e.bias) {
      if (vec) load_group<G>(e.bias + col, t);
      else {
#pragma unroll
        for (int k = 0; k < G; ++k) if (k < n) t[k] = e.bias[col + k];
      }
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] += t[k];
    }
    if (e.aux) {  // the pre-activation, the gelu backward's residual
      T* aux = static_cast<T*>(e.aux) + off;
      if (vec) store_group<G>(aux, v);
      else {
#pragma unroll
        for (int k = 0; k < G; ++k) if (k < n) aux[k] = fm::from_f32<T>(v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k)
      v[k] = e.act == ACT_RELU ? fmaxf(v[k], 0.0f) : (e.act == ACT_GELU ? gelu(v[k]) : v[k]);
    if (e.drop.on) {
      if (vec) {
#pragma unroll
        for (int h = 0; h < G / 4; ++h) {
          const uint4 w = fm::random_words(e.drop.seed, e.drop.stream, (off >> 2) + h);
          const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[4 * h + k] = bits[k] < e.drop.threshold ? v[4 * h + k] * e.drop.inv_keep : 0.0f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < G; ++k)
          if (k < n) v[k] = fm::apply_dropout(e.drop, v[k], off + k);
      }
    }
  } else if (MODE == EPI_GATE) {
    const T* gate = static_cast<const T*>(e.gate) + off;
    if (vec) load_group<G>(gate, t);
    else {
#pragma unroll
      for (int k = 0; k < G; ++k) if (k < n) t[k] = fm::to_f32(gate[k]);
    }
    if (e.gate_kind == GATE_RELU) {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] *= t[k] > 0.0f ? e.gate_scale : 0.0f;
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] *= dgelu(t[k]);
      if (e.aux) {  // a = round(gelu(hd)), the dW2 operand
        T* aux = static_cast<T*>(e.aux) + off;
#pragma unroll
        for (int k = 0; k < G; ++k) t[k] = gelu(t[k]);
        if (vec) store_group<G>(aux, t);
        else {
#pragma unroll
          for (int k = 0; k < G; ++k) if (k < n) aux[k] = fm::from_f32<T>(t[k]);
        }
      }
    }
  } else if (MODE == EPI_RESID) {
    if (vec) load_group<G>(e.resid + off, t);
    else {
#pragma unroll
      for (int k = 0; k < G; ++k) if (k < n) t[k] = e.resid[off + k];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] += t[k];
  }
  if (MODE == EPI_GATE) {
#pragma unroll
    for (int k = 0; k < G; ++k) if (k < n) csum[k] += v[k];
  }
  if (vec) store_group<G>(C + off, v);
  else {
#pragma unroll
    for (int k = 0; k < G; ++k) if (k < n) C[off + k] = fm::from_f32<TOut>(v[k]);
  }
}

// ---- fp32 CUDA-core kernel ------------------------------------------------------

// Stage a [128 x BK] slice into tile[BK][128 + PAD] from a matrix whose
// rows are the tile's 128 rows and which is contiguous along K ([rows, K]);
// rows past nrows are zero.
__device__ __forceinline__ void stage_f32_rows(const float* __restrict__ src, int nrows, int K,
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

// The same slice from a matrix stored [K, ncols] (contiguous along the
// tile's 128 columns); ncols % 4 == 0, rows from kend on are zero.
__device__ __forceinline__ void stage_f32_cols(const float* __restrict__ src, int ncols,
                                               int c0, int k0, int kend,
                                               float (*tile)[BM + PAD]) {
  constexpr int VPR = BM / 4;
  for (int v = threadIdx.x; v < BK * VPR; v += THREADS) {
    const int kk = v / VPR;
    const int c = (v % VPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + c < ncols && k0 + kk < kend)
      x = *reinterpret_cast<const float4*>(src + (size_t)(k0 + kk) * ncols + c0 + c);
    *reinterpret_cast<float4*>(&tile[kk][c]) = x;
  }
}

template <int AT, int BT, int MODE>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                int M, int N, int K, int Kc, Epi e) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float colsum[16][BN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * Kc;
  const int kend = min(kb + Kc, K);
  C += (size_t)blockIdx.z * M * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = kb; k0 < kend; k0 += BK) {
    if (AT) stage_f32_cols(A, M, m0, k0, kend, As); else stage_f32_rows(A, M, K, m0, k0, As);
    if (BT) stage_f32_cols(B, N, n0, k0, kend, Bs); else stage_f32_rows(B, N, K, n0, k0, Bs);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], w[8];
      *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&w[0]) = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      *reinterpret_cast<float4*>(&w[4]) = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each thread owns rows ty*4.. and 64+ty*4.. and the 4-column
  // groups tx*4.. and 64+tx*4...
  float csum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) csum[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + tx * 4;
      if (col < N)
        epilogue_group<MODE, 4, float, float>(e, row, col, N, &acc[i][4 * h], C, &csum[4 * h]);
    }
  }
  if (MODE == EPI_GATE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[ty][j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4] = csum[j];
    __syncthreads();
    if (threadIdx.x < BN && n0 + threadIdx.x < N) {
      float s = 0.0f;
      for (int t = 0; t < 16; ++t) s += colsum[t][threadIdx.x];
      e.colpart[(size_t)blockIdx.y * N + n0 + threadIdx.x] = s;
    }
  }
}

// ---- bf16 kernel: wgmma fed by TMA, warp-specialised, every layout ----------------
//
// C[M, N] = epilogue(op(A) . op(B)) with each operand K-major or MN-major
// (AT / BT): "nt" (K, K), "nn" (K, MN), "tn" (MN, MN).  A 128 x 256 output
// tile per block of three warpgroups: warpgroup 2 is the producer (one
// thread issues the TMA copies of each 64-deep K slice of A and B into a ring
// of WG_STAGES stages, after the stage's "empty" mbarrier says both consumers
// released it); warpgroups 0 and 1 each own 64 rows and run one m64n256k16
// wgmma per 16 of K from shared memory, their fp32 accumulators (128 a
// thread) in registers.  setmaxnreg moves registers from the producer (40)
// to the consumers (232).  TMA's 128-byte swizzle is the layout the wgmma
// descriptors name, and its zero fill takes the ragged edges of M, N and K.
// A K-major operand arrives as one [rows, 64 K] box (rows 128-byte lines);
// an MN-major one, stored [K, MN] with MN contiguous, as [64 K, 64 MN] boxes
// (one 128-byte line per K row, each 8 KB), 2 for A's 128 rows and 4 for
// B's 256 columns, and the wgmma's transpose immediate for that operand is
// set.  "tn" splits K over gridDim.z (Kc rows each, a multiple of 64) into
// fp32 partials [splits, M, N].  Epilogue: after both consumers leave the
// main loop the ring is idle; each stages its 64 x 256 fp32 tile there and
// runs epilogue_group over groups of 8 columns (MODE: the forward's bias,
// activation, aux and Philox dropout at (row * N + col) >> 2; the
// backward's plain store, fp32 residual add, or gate with the column sums of
// its 128 rows, added over the 16 rows of each of the 8 consumer warps and
// then over the warps in order, so colpart is the same bits every run).

// _build.WGMMA_TILE repeats WG_BM x WG_BN (the split-K counts are sized from it).
constexpr int WG_BM = 128;
constexpr int WG_BN = 256;
constexpr int WG_BK = 64;  // one 128-byte swizzle line of bf16
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;
constexpr int WG_BOX = 64 * WG_BK * 2;  // one MN-major [64 K][64 MN] box, bytes
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_BN * WG_BK * 2;
constexpr int WG_RING = WG_STAGES * WG_STAGE_BYTES;
constexpr int WG_CPITCH = WG_BN + 8;  // fp32 staging pitch: the float2 stores take 2 wavefronts
constexpr int WG_CSUM = 2 * 64 * WG_CPITCH * 4;  // ring offset of the [8][256] column sums
constexpr int WG_SMEM = WG_RING + 2 * WG_STAGES * 8 + 1024;  // + mbarriers + 1024-byte alignment
static_assert(WG_CSUM + 8 * WG_BN * 4 <= WG_RING, "the fp32 staging tiles and sums fit the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of ``map`` at coordinates (c0 innermost, c1) into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor (start >> 4, leading byte offset >> 4 at bit 16, stride
// byte offset >> 4 at bit 32, 128-byte swizzle) of the 16-deep K slice kk of
// a tile whose base is 1024-byte aligned.
//   K-major: rows are 128-byte lines of K, 8-row groups 1024 bytes apart
//     (stride); the leading offset is unused (1); a K slice starts 32 bytes on.
//   MN-major: [64 K][64 MN] boxes, a 128-byte line of MN per K row; 8-row K
//     groups 1024 bytes apart (stride), successive 64-wide MN blocks one box
//     (8 KB) apart (leading); a K slice starts 16 lines (2048 bytes) on.
// (The canonical layouts of CUTLASS's make_gmma_desc for Major::K / MN with
// SW128.)
template <int MN_MAJOR>
__device__ __forceinline__ uint64_t wg_desc(uint32_t base, int kk) {
  const uint32_t addr = base + (MN_MAJOR ? 2048 * kk : 32 * kk);
  const uint64_t lead = MN_MAJOR ? WG_BOX >> 4 : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lead << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[0..128) += op(A) . op(B) over 16 of K: one m64n256k16 wgmma from shared
// memory; TA / TB are the transpose immediates (1: that operand is MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// Keep the compiler from moving reads of d across the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename TOut, int AT, int BT, int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                  TOut* __restrict__ C, int M, int N, int K, int Kc, Epi e) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_RING);
  uint64_t* empty = full + WG_STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * WG_BM;
  const int n0 = blockIdx.x * WG_BN;
  const int kb = blockIdx.z * Kc;  // this split's K rows [kb, kend)
  const int kend = min(kb + Kc, K);
  const int nk = kend > kb ? (kend - kb + WG_BK - 1) / WG_BK : 0;
  C += (size_t)blockIdx.z * M * N;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the copies' bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: the roles never meet at a block-wide barrier again
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        const int k = kb + kt * WG_BK;
        mbar_wait(&empty[s], ((kt / WG_STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        unsigned char* a = ring + s * WG_STAGE_BYTES;
        unsigned char* b = a + WG_A_BYTES;
        if (AT) {
          tma_load(a, &tmA, m0, k, &full[s]);
          tma_load(a + WG_BOX, &tmA, m0 + 64, k, &full[s]);
        } else {
          tma_load(a, &tmA, k, m0, &full[s]);
        }
        if (BT) {
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j) tma_load(b + j * WG_BOX, &tmB, n0 + 64 * j, k, &full[s]);
        } else {
          tma_load(b, &tmB, k, n0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES;
      mbar_wait(&full[s], (kt / WG_STAGES) & 1);
      // This consumer's 64 rows of A: the second half of a K-major [128][64]
      // box, or the second MN-major box; 8 KB on either way.
      const uint32_t a = smem_u32(ring + s * WG_STAGE_BYTES) + wg * 64 * WG_BK * 2;
      const uint32_t b = smem_u32(ring + s * WG_STAGE_BYTES + WG_A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_m64n256k16<AT, BT>(acc, wg_desc<AT>(a, kk), wg_desc<BT>(b, kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }

    // Both consumers are out of the main loop (so no wgmma reads the ring);
    // each stages its 64 rows: thread (warp w, lane l) holds rows 16w + l/4
    // and + 8, columns 8i + 2(l % 4) + {0, 1} of acc[4i .. 4i + 3].
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* stage = reinterpret_cast<float*>(ring) + wg * 64 * WG_CPITCH;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int r = warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      *reinterpret_cast<float2*>(stage + r * WG_CPITCH + c) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(stage + (r + 8) * WG_CPITCH + c) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    // Warp w runs the epilogue over its 16 staged rows, lane l over the 8
    // columns from 8l: 16-byte loads and stores, one Philox call per 4.
    const int col = n0 + lane * 8;
    float csum[8];  // EPI_GATE: this lane's column sums over the warp's rows
#pragma unroll
    for (int k = 0; k < 8; ++k) csum[k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int lr = warp * 16 + i;
      const int row = m0 + wg * 64 + lr;
      if (row < M && col < N) {
        float v[8];
        load_group<8>(stage + lr * WG_CPITCH + lane * 8, v);
        epilogue_group<MODE, 8, fm_bf16, TOut>(e, row, col, N, v, C, csum);
      }
    }
    if (MODE == EPI_GATE) {  // the 8 warps' sums, added in warp order
      float* sums = reinterpret_cast<float*>(ring + WG_CSUM);
#pragma unroll
      for (int k = 0; k < 8; ++k) sums[(wg * 4 + warp) * WG_BN + lane * 8 + k] = csum[k];
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int c = threadIdx.x;  // 0 .. 255
      if (n0 + c < N) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += sums[w * WG_BN + c];
        e.colpart[(size_t)blockIdx.y * N + n0 + c] = s;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links no libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of a row-major bf16 matrix [outer, inner] read in
// [box_outer, box_inner] boxes, 128-byte swizzle; reads past its edges give
// zeros.
bool bf16_map(CUtensorMap* map, const void* p, int outer, int inner, int box_outer,
              int box_inner) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The map of one operand with ``mn`` rows or columns: K-major [mn, K] in
// [box_mn, 64] boxes, or MN-major [K, mn] in [64, 64] boxes.
bool operand_map(CUtensorMap* map, const void* p, int mn, int K, bool mn_major, int box_mn) {
  return mn_major ? bf16_map(map, p, K, mn, WG_BK, 64) : bf16_map(map, p, mn, K, box_mn, WG_BK);
}

template <typename TOut, int AT, int BT, int MODE>
cudaError_t launch_wgmma(const void* A, const void* B, void* C, int M, int N, int K, int splits,
                         int Kc, const Epi& e, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, A, M, K, AT, WG_BM) || !operand_map(&tb, B, N, K, BT, WG_BN))
    return cudaErrorInvalidValue;
  // Per launch, as the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_kernel<TOut, AT, BT, MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM, splits);
  gemm_wgmma_kernel<TOut, AT, BT, MODE><<<grid, WG_THREADS, WG_SMEM, s>>>(
      ta, tb, static_cast<TOut*>(C), M, N, K, Kc, e);
  return cudaGetLastError();
}

// fp32 runs on CUDA cores in every layout, bf16 on the wgmma kernel.
template <int AT, int BT, int MODE>
cudaError_t launch(const void* A, const void* B, void* C, int M, int N, int K, int splits,
                   int dtype, int out_f32, const Epi& e, cudaStream_t s) {
  // K per split, a multiple of the wgmma kernel's K slice; the last split may be short.
  const int Kc = ((K + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK;
  if (dtype == FM_F32) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    gemm_f32_kernel<AT, BT, MODE><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), static_cast<float*>(C),
        M, N, K, Kc, e);
    return cudaGetLastError();
  }
  return out_f32 ? launch_wgmma<float, AT, BT, MODE>(A, B, C, M, N, K, splits, Kc, e, s)
                 : launch_wgmma<fm_bf16, AT, BT, MODE>(A, B, C, M, N, K, splits, Kc, e, s);
}

// ---- deterministic column sums ---------------------------------------------------

// out[n] = sum over m of x[m, n], fp32, in a fixed order: thread (c, r) of a
// 32 x 8 block sums rows r, r+8, ... of column c, then the 8 partial sums
// are added in order.  Used for the bias / LayerNorm grads from per-block
// partials and for the split-K partials of "tn".
template <typename TOut>
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ x, TOut* __restrict__ out, int M, int N) {
  __shared__ float part[8][33];
  const int c = threadIdx.x % 32;
  const int r = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + c;
  float s = 0.0f;
  if (col < N)
    for (int m = r; m < M; m += 8) s += x[(size_t)m * N + col];
  part[r][c] = s;
  __syncthreads();
  if (r == 0 && col < N) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][c];
    out[col] = fm::from_f32<TOut>(t);
  }
}

// part[blockIdx.y, n] = sum of x[m, n] over the block's SUM_ROWS rows, in a
// fixed order, x in the io dtype.  The first pass of a column sum over an
// io-dtype [R, N] matrix (the bias grads dbo and db2 from an autograd
// cotangent, Pallas #6 and #8); colsum_kernel adds the partials.  Lane l of
// warp w reads columns 8l .. 8l+7 of the block's 256 (16 bytes of bf16) in
// rows w, w+8, ...; the 8 warps' sums are then added in warp order.
constexpr int SUM_ROWS = 128;

template <typename T>
__global__ void __launch_bounds__(256)
row_block_sums_kernel(const T* __restrict__ x, float* __restrict__ part, int M, int N) {
  __shared__ float red[8][256];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int col = blockIdx.x * 256 + lane * 8;
  const int r0 = blockIdx.y * SUM_ROWS;
  const int rend = min(r0 + SUM_ROWS, M);
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  if (col < N)
    for (int m = r0 + w; m < rend; m += 8) {
      float v[8];
      load_group<8>(x + (size_t)m * N + col, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += v[k];
    }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[w][lane * 8 + k] = s[k];
  __syncthreads();
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c < N) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    part[(size_t)blockIdx.y * N + c] = t;
  }
}

}  // namespace

extern "C" {

// C = epilogue(op(A) . op(B)); layout 0 = "nt", 1 = "nn", 2 = "tn" (see the
// top of this file).  A, B in the io dtype (dtype), C in the io dtype or fp32
// (out_f32; fp32 io always gives fp32).  For "nt" and "nn" K % 32 == 0 and
// splits == 1, for "nn" N % 8 == 0; for "tn" any K, M % 8 == 0 and N % 8 ==
// 0 (the wrapper checks; TMA needs 16-byte row strides).  With splits > 1
// ("tn" only), C is [splits, M, N] fp32 partials.  bias [N] fp32, aux/gate
// [M, N] io dtype, resid [M, N] fp32, colpart [ceil(M/128), N] fp32: each
// may be null.
int fm_gemm(const void* A, const void* B, void* C, int M, int N, int K, int layout, int splits,
            int dtype, int out_f32, const void* bias, int act, unsigned long long seed,
            unsigned int stream_id, unsigned int threshold, float inv_keep, int drop_on,
            void* aux, const void* gate, int gate_kind, float gate_scale, const void* resid,
            void* colpart, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (dtype != FM_F32 && dtype != FM_BF16) ||
      (layout != 2 && (K % 32 || splits != 1)))
    return cudaErrorInvalidValue;
  Epi e;
  e.bias = static_cast<const float*>(bias);
  e.act = act;
  e.drop = fm::Dropout{seed, stream_id, threshold, inv_keep, drop_on};
  e.aux = aux;
  e.gate = gate;
  e.gate_kind = gate_kind;
  e.gate_scale = gate_scale;
  e.resid = static_cast<const float*>(resid);
  e.colpart = static_cast<float*>(colpart);
  // "nt" runs the forward epilogue; "nn" stores, gates or adds a residual;
  // "tn" stores.  Any other combination of operands is refused.
  const int mode = layout == 0 ? EPI_BIAS_ACT : (gate ? EPI_GATE : (resid ? EPI_RESID : EPI_STORE));
  if ((layout != 0 && (bias || act != ACT_NONE || drop_on)) || (layout == 0 && (gate || resid)) ||
      (layout == 2 && (gate || resid || aux)) || ((colpart != nullptr) != (mode == EPI_GATE)) ||
      (mode == EPI_GATE && gate_kind == GATE_NONE) ||
      (layout == 1 && aux && !(mode == EPI_GATE && gate_kind == GATE_DGELU)))
    return cudaErrorInvalidValue;
  if (layout == 0) return launch<0, 0, EPI_BIAS_ACT>(A, B, C, M, N, K, splits, dtype, out_f32, e, s);
  if (layout == 2) return launch<1, 1, EPI_STORE>(A, B, C, M, N, K, splits, dtype, out_f32, e, s);
  if (layout != 1) return cudaErrorInvalidValue;
  switch (mode) {
    case EPI_GATE: return launch<0, 1, EPI_GATE>(A, B, C, M, N, K, splits, dtype, out_f32, e, s);
    case EPI_RESID: return launch<0, 1, EPI_RESID>(A, B, C, M, N, K, splits, dtype, out_f32, e, s);
    default: return launch<0, 1, EPI_STORE>(A, B, C, M, N, K, splits, dtype, out_f32, e, s);
  }
}

// out[N] = column sums of x [M, N] fp32, written fp32 or bf16 (out_bf16).
int fm_colsum(const void* x, void* out, int M, int N, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 31) / 32);
  if (out_bf16)
    colsum_kernel<fm_bf16><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<fm_bf16*>(out), M, N);
  else
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<float*>(out), M, N);
  return cudaGetLastError();
}

// part [ceil(M / 128), N] fp32 = per-128-row-block column sums of x [M, N]
// in the io dtype (dtype); N % 8 == 0 and 16-byte alignment (the wrapper
// checks).
int fm_row_block_sums(const void* x, void* part, int M, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 8) return cudaErrorInvalidValue;
  const dim3 grid((N + 255) / 256, (M + SUM_ROWS - 1) / SUM_ROWS);
  if (dtype == FM_F32)
    row_block_sums_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<float*>(part), M, N);
  else if (dtype == FM_BF16)
    row_block_sums_kernel<fm_bf16><<<grid, 256, 0, s>>>(static_cast<const fm_bf16*>(x),
                                                         static_cast<float*>(part), M, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
