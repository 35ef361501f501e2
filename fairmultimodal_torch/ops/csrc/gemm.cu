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
//     column sums of v over each 128 rows -> colpart[row / 128, col];
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
// wgmma reaches it.  Which kernel runs which layout:
//   - bf16 "nt" (every forward product: QKV, Wo, W1, W2 of Pallas #1, #2,
//     #5, #7 and the note encoder): gemm_bf16_nt_kernel, persistent (one
//     block per SM walks 128 x 256 tiles in a fixed order), its epilogue
//     run on the fragments and staged through rows of its own so the
//     producer fills the ring with the next tile under it, the Philox keep
//     bits drawn by idle warps a tile ahead, one wgmma batch kept in flight.
//   - bf16 "nn" and "tn" (every backward product): gemm_bf16_nn_tn_kernel,
//     the same block and persistence over (tile, K split) units, its
//     epilogue (plain store, fp32 residual add, or relu / dgelu gate with the
//     bias grad's column partials) on the fragments, the gate or residual
//     brought by TMA into two set buffers whose rows are then the consumer
//     warps' staging rows.  Each operand is K-major (the "nn"
//     dY) or MN-major (the "nn" weight, both "tn" operands): an MN-major
//     operand comes in 64-wide boxes, gets its own descriptor (leading offset
//     one box, a 2048-byte step per 16 of K) and sets the wgmma's transpose
//     immediate, so no operand is ever transposed in memory.
//   Both bf16 kernels take 128 x 256 tiles of two m64n256k16 consumers: the
//   tile needs about 11 TB/s of L2 traffic at the peak rate, so L2 rather
//   than the tensor cores may bound it, and a narrower tile needs more.
//   - fp32: register-blocked FFMA on the CUDA cores (full IEEE fp32, no
//     TF32), on two persistent kernels of one shape: a block of 384 threads
//     per SM, two consumer warpgroups each fed by its own producer warp
//     through a TMA ring of 32-deep K slices (128-byte swizzle) that it reads
//     where they land, 128 x 64 output tiles taken in a fixed order.  "nt"
//     runs gemm_f32_nt_kernel (both operands K-major), "nn" and "tn"
//     gemm_f32_nn_tn_kernel (B MN-major, and A too for "tn").  fp32 is the
//     main path of every fp32 run: `fame` and every baseline build their
//     models in fp32 unless --bf16 is given, so a default run trains through
//     them.  What bounds them is the CUDA cores' fp32 rate (67 TFLOP/s on an
//     H100 SXM): each lab product at batch 16 needs 10x or more the time of
//     its bytes.
// The epilogue is chosen at compile time (Mode).  The fp32 kernels run
// epilogue_group on groups of 4 consecutive columns (16-byte loads and
// stores, one Philox call per 4 elements); the bf16 kernels run the same
// arithmetic on the wgmma fragments and store through staging rows.
// "tn" reduces over R = 143360 rows: it splits K over the persistent
// kernels' work units (a unit is a tile over one split) and writes fp32 partials
// [splits, M, N] that fm_colsum adds in a fixed order, so the sum is the same
// bits every run (no atomics anywhere).  Column sums for the bias grads are
// per row-block partials, also added by fm_colsum.
// What it leaves on the table: the epilogues still run on both consumers at
// once while the tensor cores wait (a consumer per tile, ping-pong, needs 256
// accumulators a thread at this tile), TMA multicast across a cluster (L2
// traffic), a split-K "tn" whose partials stay in the cluster, a stream-K
// tail for launches of under two waves of tiles, and the TPU kernels' fusion
// (q/k/v/o, the [R, F] intermediate and dz round-trip HBM).
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "fm_common.cuh"
#include "fm_hopper.cuh"
#include "philox.cuh"

namespace {

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
// (EPI_GATE).  T is the io dtype of aux and gate; `pre`, where given, holds
// the group's gate or residual as fp32, read beforehand.  Whole groups inside a
// row whose length is a multiple of G take 16-byte loads and stores and one
// Philox call per 4 elements; a ragged group goes element by element.  Every
// loop runs over all G with constant indices (the ragged one skips k >= n),
// so v and t stay in registers.
template <int MODE, int G, typename T, typename TOut>
__device__ __forceinline__ void epilogue_group(const Epi& e, int row, int col, int N, float* v,
                                               TOut* __restrict__ C, float* csum,
                                               const float* pre = nullptr) {
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
    if (pre) {
#pragma unroll
      for (int k = 0; k < G; ++k) t[k] = pre[k];
    } else if (vec) load_group<G>(gate, t);
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
    if (pre) {
#pragma unroll
      for (int k = 0; k < G; ++k) t[k] = pre[k];
    } else if (vec) load_group<G>(e.resid + off, t);
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

// ---- bf16 wgmma building blocks (both bf16 kernels) --------------------------------

constexpr int WG_BK = 64;  // a K slice: one 128-byte swizzle line of bf16
constexpr int WG_BOX = 64 * WG_BK * 2;  // one MN-major [64 K][64 MN] box, bytes

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
  return wgmma_desc(base + (MN_MAJOR ? 2048 * kk : 32 * kk), MN_MAJOR ? WG_BOX : 16, 1024, 1);
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

// ---- bf16 "nt" kernel: persistent, the epilogue off the ring -------------------------
//
// C[M, N] = epilogue(A[M, K] . B[N, K]^T), both operands K-major, for every
// bf16 forward product (Pallas #1 / #5's QKV and Wo, #2 / #7's W1 and W2, the
// note encoder's LN-fused _infer variants), with the forward epilogue: bias,
// aux = round(pre-activation), none / relu / exact gelu, the FFN's inner
// Philox dropout, bf16 or fp32 out.  It replaces the "nt" form of a
// one-block-a-tile wgmma kernel, which lost to one cuBLAS call (QKV at R 143360: 1.10 ms against
// 0.80; W1 with dropout and aux 1.29 against 0.94 plain) for four reasons
// this design answers:
//   - Persistent: grid = min(SMs, tiles), one block of WN_THREADS per SM.
//     Tiles of WN_BM x WN_BN are numbered N-fastest (t = mt * tiles_n + nt,
//     as gemm_f32_nt_kernel: the blocks in flight share a band of A rows
//     against the whole weight, which stays in L2) and block b runs t = b,
//     b + grid, ...  Each tile is a function of the tile alone, so a run
//     gives the same bits every time.  The ring no longer fills from empty
//     and drains at every 12-slice tile (K 768).
//   - The epilogue off the ring, on the fragments: each consumer warp runs
//     bias, aux, activation and dropout on its accumulators in registers (the
//     fragment of lane (rq, q): rows rq, rq + 8 of its 16, columns 8 i + 2 q,
//     + 1), then passes the finished values through 16 staging rows of 128
//     bytes of its own (WN_CSTAGE), so the producer refills the ring with the
//     next tile's slices meanwhile.  A pass is 64 columns of bf16 (32 of
//     fp32): the fragment pairs go in as 4 (8) bytes, and lane l stores word
//     l % 8 of rows l / 8 + 4 j, so 8 lanes write a row's 128-byte line with
//     16-byte stores.  Word k of staging row r sits at k ^ swz(r), swz(r) =
//     2 (r & 3) + ((r >> 2) & 1): a warp's pair writes and its row reads
//     each take one wavefront per 128 bytes.  The tile's bias is loaded into
//     registers as the tile starts (lane l: columns 8 l ..) and staged in the
//     warp's WN_BIAS copy after the main loop.  At the lab shape (R 143360,
//     NVIDIA H100 80GB HBM3, 700 W) QKV took 1.15 ms with bias loads from
//     global memory in each pass, 1.01 with the staged bias and fp32 staging
//     rows of 32 columns, 0.93 so; 0.67 with no epilogue at all.
//   - Philox off the critical path: the dropout keep bits of a tile (one bit
//     per element, WN_MASK bytes, row-major, word w = row w / 8, columns 32
//     (w % 8) ..) at counter (row * N + col) >> 2 and word (row * N + col) &
//     3 (keep_word: a word is 8 whole counters where N % 4 == 0, 32 flat
//     indices otherwise), so the masks are
//     utils/rng.py::dropout_mask's.  The producer warpgroup's warps 9-11,
//     which the TMA thread leaves idle, draw rows 0-7 of each consumer warp's
//     16 a tile ahead into two buffers (mfull / mempty mbarriers); each
//     consumer warp draws its own rows 8-15 (two words a lane) while its last
//     slices run, so a __syncwarp orders them.  Philox (20 wide multiplies
//     a call) is what costs: all of W1's draws on the three warps took 1.33
//     ms against 0.80 with none (they keep up with no more than half), all on
//     the consumers inside the main loop 1.56, half and half 1.13; a word's 8
//     counters run round by round together were no faster than 4 calls
//     unrolled.
//   - wgmma kept in flight: a slice's four m64n256k16 are committed as one
//     group and the consumer waits with wgmma.wait_group 1, releasing the
//     previous slice's stage, so the next batch is issued while this one runs.
// Shape: WN_THREADS = 384, two consumer warpgroups of 64 rows (m64n256k16
// from shared memory, 128 fp32 accumulators a thread) and a producer
// warpgroup (warp 8's lane 0 issues the TMA copies of A [128][64 K] and B
// [256][64 K], 128-byte swizzle, into WN_STAGES stages; warps 9-11 draw keep
// bits); setmaxnreg 56 / 224 (the mask warps' unrolled Philox calls need more
// than 40).  Four stages: at three the main loop alone took 0.77 ms of QKV against
// 0.67.  What is left is the epilogue itself (0.25 ms of QKV's 0.93): both
// consumers run it at once while the tensor cores wait, and its stores share
// the SM's port with the ring's refill.
// Order: each output is 0 + the K-ascending sum of 16-deep m64n256k16 steps,
// the instruction, operand layout and order that kernel ran on this
// form, and the epilogue's arithmetic is epilogue_group's, so the outputs
// keep its bits.  Ragged edges: TMA zero-fills past M, N and K (K % 32 ==
// 0, the wrapper's rule); the epilogue skips rows and columns past M and N,
// element by element where N % 8 != 0.
// The tile: 128 x 256 at every shape.  At B 16 (R 8784) Wo / W2 have 69 x 3
// = 207 tiles on 132 SMs, two on the busiest against 1.57 on average.  In
// 128 x 256 tiles' work the busiest SM would run 2.0 at 128 x 128 or 64 x
// 256, 2.25 at 128 x 192, and 1.875 / 1.75 only at 128 x 96 / 128 x 64, which
// read 1.56x / 2x the L2 bytes per FLOP of a tile whose own L2 traffic may
// bound it; so the tail waits for a stream-K split
// (tests/test_torch_gemm_bf16_nt.py models the choice).
// Bound: the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM); W1's aux
// doubles its stores, 0.42 ms of bytes at the lab shape under ~0.46 of math.

// _build.WGMMA_NT repeats these.
constexpr int WN_BM = 128;  // the block's output tile, WN_BM x WN_BN: 64 rows a consumer
constexpr int WN_BN = 256;
constexpr int WN_BK = 64;   // one 128-byte swizzle line of bf16
constexpr int WN_STAGES = 4;
constexpr int WN_CONSUMERS = 2;
constexpr int WN_THREADS = (WN_CONSUMERS + 1) * 128;  // + the producer's warpgroup
constexpr int WN_A_BYTES = WN_BM * WN_BK * 2;
constexpr int WN_STAGE_BYTES = WN_A_BYTES + WN_BN * WN_BK * 2;
constexpr int WN_RING = WN_STAGES * WN_STAGE_BYTES;
constexpr int WN_CHUNK = 64;                    // columns of the epilogue's pass over a warp's rows
constexpr int WN_CSTAGE = 16 * 128;             // a consumer warp's staging rows: 16 x 128 bytes
constexpr int WN_MASK = WN_BM * WN_BN / 8;      // a tile's dropout keep bits, bytes
constexpr int WN_MASK_THREADS = 96;             // warps 9-11
constexpr int WN_BIAS = WN_BN * 4;              // a consumer warp's copy of the tile's bias, bytes
constexpr int WN_BARS = 2 * WN_STAGES + 4;      // full, empty; mfull, mempty of two masks
// Ring, chunk and bias buffers, two masks, mbarriers, 1024-byte alignment.
constexpr int WN_SMEM = WN_RING + 4 * WN_CONSUMERS * (WN_CSTAGE + WN_BIAS) + 2 * WN_MASK +
                        WN_BARS * 8 + 1024;
static_assert(WN_SMEM <= 232448, "a block's shared memory fits the SM's 227 KB");
static_assert(WN_STAGE_BYTES % 1024 == 0, "swizzle atoms stay aligned");

// Byte offset of 16-byte word k of row r of a consumer warp's staging rows
// (16 x 128 bytes): word k of row r at k ^ swz(r), swz(r) = 2 (r & 3) + ((r >>
// 2) & 1), so a warp's fragment writes and its row reads take one wavefront
// per 128 bytes.
__device__ __forceinline__ int wn_stage_off(int r, int k) {
  return r * 128 + ((k ^ (2 * (r & 3) + ((r >> 2) & 1))) << 4);
}

// The staged rows to C (elements of T from column col0 of the tile's row
// row0 on): lane l takes word l % 8 of rows l / 8 + 4 j, so 8 lanes store a
// row's 128 bytes as 16-byte stores; ragged edges element by element.
template <typename T>
__device__ __forceinline__ void wn_flush(const unsigned char* st, T* __restrict__ out, int row0,
                                         int col0, int M, int N, int lane) {
  constexpr int E = 16 / sizeof(T);
  const int k = lane % 8, col = col0 + k * E;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = lane / 8 + 4 * j, row = row0 + r;
    const uint4 u = *reinterpret_cast<const uint4*>(st + wn_stage_off(r, k));
    if (row >= M || col >= N) continue;
    T* p = out + (size_t)row * N + col;
    if (N % E == 0) *reinterpret_cast<uint4*>(p) = u;
    else {
      const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < E; ++x) if (col + x < N) p[x] = h[x];
    }
  }
}

// Fragment pair (row r, columns c, c + 1 of a pass) into the staging rows.
__device__ __forceinline__ void wn_stage(unsigned char* st, int r, int c, float a, float b,
                                         fm_bf16*) {
  __nv_bfloat162 h;
  h.x = __float2bfloat16_rn(a);
  h.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(st + wn_stage_off(r, c / 8) + (c % 8) * 2) = h;
}
__device__ __forceinline__ void wn_stage(unsigned char* st, int r, int c, float a, float b,
                                         float*) {
  *reinterpret_cast<float2*>(st + wn_stage_off(r, c / 4) + (c % 4) * 4) = make_float2(a, b);
}

// Bit b: whether dropout keeps element (row, col0 + b), col0 % 32 == 0 (the
// bits fm::apply_dropout draws there).  0 for a row past M.
__device__ __forceinline__ uint32_t keep_word(const fm::Dropout& d, int row, int col0, int M,
                                              int N) {
  if (row >= M) return 0u;
  const unsigned long long base = (unsigned long long)row * N + col0;
  uint32_t w = 0u;
  if (N % 4 == 0) {  // base % 4 == 0: counter base / 4 + h holds columns 4 h .. 4 h + 3
#pragma unroll 4
    for (int h = 0; h < 8; ++h) {
      const uint4 r = fm::random_words(d.seed, d.stream, (base >> 2) + h);
      w |= ((uint32_t)(r.x < d.threshold) | (uint32_t)(r.y < d.threshold) << 1 |
            (uint32_t)(r.z < d.threshold) << 2 | (uint32_t)(r.w < d.threshold) << 3)
           << (4 * h);
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < 32; ++b)
      w |= (uint32_t)(fm::random_bits(d.seed, d.stream, base + b) < d.threshold) << b;
  }
  return w;
}

template <typename TOut>
__global__ void __launch_bounds__(WN_THREADS, 1)
gemm_bf16_nt_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, TOut* __restrict__ C, int M, int N,
                    int K, Epi e) {
  fm::load_key(e.drop);  // before any thread draws
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* chunks = ring + WN_RING;
  float* biases = reinterpret_cast<float*>(ring + WN_RING + 4 * WN_CONSUMERS * WN_CSTAGE);
  unsigned char* masks = ring + WN_RING + 4 * WN_CONSUMERS * (WN_CSTAGE + WN_BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(masks + 2 * WN_MASK);
  uint64_t* empty = full + WN_STAGES;
  uint64_t* mfull = empty + WN_STAGES;  // mask b drawn: one arrive per mask thread
  uint64_t* mempty = mfull + 2;         // mask b read: one arrive per consumer thread
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (N + WN_BN - 1) / WN_BN;
  const int tiles = (M + WN_BM - 1) / WN_BM * tiles_n;
  const int nk = (K + WN_BK - 1) / WN_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WN_STAGES; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive, plus the copies' bytes
      mbar_init(&empty[s], WN_CONSUMERS);  // one arrive per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&mfull[b], WN_MASK_THREADS);
      mbar_init(&mempty[b], WN_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WN_CONSUMERS) {  // the producer warpgroup: no block-wide barrier again
    setmaxnreg_dec<56>();
    if (warp == 4 * WN_CONSUMERS) {
      if (lane == 0) {
        int q = 0;  // slices issued, over all of this block's tiles
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = t / tiles_n * WN_BM, n0 = t % tiles_n * WN_BN;
          for (int kt = 0; kt < nk; ++kt, ++q) {
            const int s = q % WN_STAGES;
            mbar_wait(&empty[s], ((q / WN_STAGES) & 1) ^ 1);  // the first round passes at once
            mbar_expect_tx(&full[s], WN_STAGE_BYTES);
            unsigned char* a = ring + s * WN_STAGE_BYTES;
            tma_load(a, &tmA, kt * WN_BK, m0, &full[s]);
            tma_load(a + WN_A_BYTES, &tmB, kt * WN_BK, n0, &full[s]);
          }
        }
      }
    } else if (e.drop.on) {  // warps 9-11: tile j's keep bits into mask j % 2
      const int mt = threadIdx.x - (4 * WN_CONSUMERS + 1) * 32;
      int j = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        const int m0 = t / tiles_n * WN_BM, n0 = t % tiles_n * WN_BN;
        mbar_wait(&mempty[j & 1], ((j >> 1) & 1) ^ 1);  // the first two pass at once
        uint32_t* bits = reinterpret_cast<uint32_t*>(masks + (j & 1) * WN_MASK);
        // Rows 16 b .. 16 b + 7 of each consumer warp b's 16: word x % 64 of
        // block x / 64 (the consumers draw the other 8 rows themselves).
        for (int x = mt; x < WN_MASK / 8; x += WN_MASK_THREADS) {
          const int w = x / 64 * 128 + x % 64;
          bits[w] = keep_word(e.drop, m0 + w / (WN_BN / 32), n0 + 32 * (w % (WN_BN / 32)), M,
                              N);
        }
        mbar_arrive(&mfull[j & 1]);
      }
    }
    return;
  }
  setmaxnreg_inc<224>();

  const int wg = warp / 4;
  const int rq = lane / 4, q = lane % 4;       // fragment rows rq, rq + 8; columns 8 i + 2 q
  const int lr = wg * 64 + (warp % 4) * 16;    // the warp's first row in the tile
  unsigned char* chunk = chunks + warp * WN_CSTAGE;  // this warp's staging rows
  float* bias_s = biases + warp * WN_BN;  // the tile's bias, columns n0 ..
  int qs = 0;  // slices consumed, over all of this block's tiles
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int m0 = t / tiles_n * WN_BM, n0 = t % tiles_n * WN_BN;
    // Lane l's 8 bias terms of columns n0 + 8 l ..: loaded here, under the
    // main loop, and staged for the epilogue after it.
    float bl[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) bl[k] = 0.0f;
    if (e.bias) {
      const int c0 = n0 + 8 * lane;
      if (N % 8 == 0 && c0 < N) load_group<8>(e.bias + c0, bl);
      else {
#pragma unroll
        for (int k = 0; k < 8; ++k) if (c0 + k < N) bl[k] = e.bias[c0 + k];
      }
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    for (int kt = 0; kt < nk; ++kt, ++qs) {
      const int s = qs % WN_STAGES;
      mbar_wait(&full[s], (qs / WN_STAGES) & 1);
      // This consumer's 64 rows of A: the second half of the [128][64] box.
      const uint32_t a = smem_u32(ring + s * WN_STAGE_BYTES) + wg * 64 * WN_BK * 2;
      const uint32_t b = smem_u32(ring + s * WN_STAGE_BYTES + WN_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WN_BK / 16; ++kk)
        wgmma_m64n256k16<0, 0>(acc, wg_desc<0>(a, kk), wg_desc<0>(b, kk));
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // slice kt - 1 is done
      fence_regs(acc);
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WN_STAGES]);
    }
    // The keep bits of this warp's rows lr + 8 .. lr + 15, drawn while the
    // last slices run: lane (rq, q) words q and q + 4 of row lr + 8 + rq.
    if (e.drop.on) {
      uint32_t* mine = reinterpret_cast<uint32_t*>(masks + (j & 1) * WN_MASK) +
                       (lr + 8 + rq) * (WN_BN / 32);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mine[q + 4 * u] = keep_word(e.drop, m0 + lr + 8 + rq, n0 + 32 * (q + 4 * u), M, N);
    }
    wgmma_wait_all();
    fence_regs(acc);
    if (nk > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WN_STAGES]);

    // Epilogue: once this tile's keep bits are in the mask and the warp's
    // copy of the bias is staged, four passes of 64 columns.
    const unsigned char* keep = nullptr;
    if (e.drop.on) {
      mbar_wait(&mfull[j & 1], (j >> 1) & 1);
      keep = masks + (j & 1) * WN_MASK;
      __syncwarp();  // the warp's own words
    }
    store_group<8>(bias_s + 8 * lane, bl);
    __syncwarp();
    // Pass ch: the warp's 16 rows x columns 64 ch .. 64 ch + 63, fragment
    // groups i = 8 ch + g (columns 8 i + 2 q, + 1; rows rq, rq + 8 as acc[4 i
    // .. 4 i + 3]), through bias, aux, activation and dropout in registers.
#pragma unroll
    for (int ch = 0; ch < WN_BN / WN_CHUNK; ++ch) {
      float v[WN_CHUNK / 8][4];
#pragma unroll
      for (int g = 0; g < WN_CHUNK / 8; ++g) {
        const int i = ch * (WN_CHUNK / 8) + g;
        const float2 b = *reinterpret_cast<const float2*>(bias_s + 8 * i + 2 * q);
#pragma unroll
        for (int x = 0; x < 4; ++x) v[g][x] = e.bias ? acc[4 * i + x] + (x & 1 ? b.y : b.x)
                                                     : acc[4 * i + x];
      }
      const int col0 = n0 + ch * WN_CHUNK;
      if (e.aux) {  // the pre-activation, the gelu backward's residual
#pragma unroll
        for (int g = 0; g < WN_CHUNK / 8; ++g) {
          wn_stage(chunk, rq, 8 * g + 2 * q, v[g][0], v[g][1], (fm_bf16*)nullptr);
          wn_stage(chunk, rq + 8, 8 * g + 2 * q, v[g][2], v[g][3], (fm_bf16*)nullptr);
        }
        __syncwarp();
        wn_flush(chunk, static_cast<fm_bf16*>(e.aux), m0 + lr, col0, M, N, lane);
        __syncwarp();
      }
      // This pass's keep bits of rows rq and rq + 8: byte g of each holds
      // columns 8 g .. 8 g + 7.
      unsigned long long kb[2] = {~0ull, ~0ull};
      if (keep) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          kb[h] = *reinterpret_cast<const unsigned long long*>(
              keep + (lr + rq + 8 * h) * (WN_BN / 8) + ch * (WN_CHUNK / 8));
      }
#pragma unroll
      for (int g = 0; g < WN_CHUNK / 8; ++g)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float t = v[g][x];
          t = e.act == ACT_RELU ? fmaxf(t, 0.0f) : (e.act == ACT_GELU ? gelu(t) : t);
          if (keep)
            t = (kb[x >> 1] >> (8 * g + 2 * q + (x & 1))) & 1ull ? t * e.drop.inv_keep : 0.0f;
          v[g][x] = t;
        }
      // C: one pass of 128-byte rows for bf16, two for fp32.
      constexpr int PER = 128 / sizeof(TOut) / 8;  // fragment groups a staged row holds
#pragma unroll
      for (int p = 0; p < WN_CHUNK / 8 / PER; ++p) {
#pragma unroll
        for (int g = p * PER; g < (p + 1) * PER; ++g) {
          const int c = 8 * (g - p * PER) + 2 * q;
          wn_stage(chunk, rq, c, v[g][0], v[g][1], (TOut*)nullptr);
          wn_stage(chunk, rq + 8, c, v[g][2], v[g][3], (TOut*)nullptr);
        }
        __syncwarp();
        wn_flush(chunk, C, m0 + lr, col0 + p * PER * 8, M, N, lane);
        __syncwarp();
      }
    }
    if (keep) mbar_arrive(&mempty[j & 1]);
  }
}

template <typename TOut>
cudaError_t launch_bf16_nt(const void* A, const void* B, void* C, int M, int N, int K,
                           const Epi& e, cudaStream_t s) {
  const int tiles = (M + WN_BM - 1) / WN_BM * ((N + WN_BN - 1) / WN_BN);
  if (tiles == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  CUtensorMap ta{}, tb{};  // K == 0 loads nothing
  if (K > 0 && (!tma_map(&ta, A, false, M, K, WN_BM, WN_BK) ||
                !tma_map(&tb, B, false, N, K, WN_BN, WN_BK)))
    return cudaErrorInvalidValue;
  // Per launch, as the attribute belongs to the current device.
  err = cudaFuncSetAttribute(gemm_bf16_nt_kernel<TOut>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WN_SMEM);
  if (err != cudaSuccess) return err;
  gemm_bf16_nt_kernel<TOut><<<sms < tiles ? sms : tiles, WN_THREADS, WN_SMEM, s>>>(
      ta, tb, static_cast<TOut*>(C), M, N, K, e);
  return cudaGetLastError();
}

// ---- bf16 "nn" / "tn" kernel: persistent, the gate and residual brought by TMA ------
//
// C[M, N] = epilogue(op(A) . B[K, N]) for every bf16 backward product: "nn"
// (A [M, K] K-major: dO = da.Wo, dx = dz + dqkv.Wqkv, dh = (dy.W2) * gate',
// dx = dz + dh.W1 of Pallas #3, #4, #6 and #8) and "tn" (A [K, M] MN-major:
// the split-K weight grads dWo, dWqkv, dW1, dW2, K = the R rows).  B is always
// MN-major.  The block is gemm_bf16_nt_kernel's; what differs is the
// MN-major operands, the K splits and the backward's epilogue.  It replaces
// a one-block-a-tile kernel of the same tile and arithmetic, which filled and
// drained its ring at every tile, waited for each slice's wgmma batch before
// it released the stage, and ran its epilogue through the ring after both
// consumers left the main loop, reading the gate or residual from global
// memory row by row while the tensor cores and the ring sat idle.  Here:
//   - Persistent: grid = min(SMs, units), one block of WG_THREADS per SM.  A
//     unit is one 128 x 256 tile over one K split, u = split * tiles + t with
//     tiles numbered N-fastest (as gemm_f32_nn_tn_kernel), and block b runs
//     u = b, b + grid, ...  Warp 8's lane 0 fills the ring with the next
//     unit's slices while the consumers finish this one.
//   - One wgmma batch in flight: a slice's four m64n256k16 are committed as
//     one group and the consumer waits with wgmma.wait_group 1, releasing the
//     previous slice's stage (as gemm_bf16_nt_kernel).
//   - The gate or residual by TMA, off the registers: warp 9's lane 0 brings
//     each unit's gate (bf16) or residual (fp32) in sets of the tile's 128
//     rows x 128 bytes (64 gate or 32 residual columns, 128-byte swizzle) into
//     two set buffers (sfull / sempty mbarriers, one release per consumer
//     warp).  A buffer is released as soon as its set is read, so a unit's
//     first two sets land under its main loop and each later one two sets
//     ahead.  A tile's gate (64 KB) or residual (128 KB) does not fit beside
//     the 4-stage ring (192 KB of the 227), nor a third set buffer.
//   - The epilogue on the fragments: four passes of 64 columns, each a
//     template instance (every index into the 128 accumulators a constant).
//     Lane (rq, q) reads its pairs of the set where TMA put them (rows rq, rq
//     + 8 of the warp's 16, columns 8 i + 2 q, + 1: one wavefront a bf16 pair
//     read, two an fp32 one), then uses its warp's 16 rows of that buffer as
//     staging rows (wn_stage_off's swizzle), so every store to C is a whole
//     128-byte line of 16-byte stores and the ring stays free; where no set
//     comes, buffer 0's rows stage C.  The dgelu gate's aux = round(gelu(hd))
//     is stored from the set as it lies, whole lines, in a rolled loop.
//   - The gated dh's column partials keep their order: per column, the 16
//     rows of a warp summed in row order from 0 (rows past M skipped), then
//     the 8 warps in order.  On the fragments a column's 16 rows sit in 8
//     lanes, so each half pass stages the gated fp32 values and lane l sums
//     column l down the 16 staged rows; at the end of the pass each warp
//     leaves its 64 sums in its rows and, between two named barriers of the
//     256 consumer threads, thread c < 64 adds the 8 warps' in order into
//     colpart[m0 / 128, col0 + c].
//   - The gate's kind (relu or dgelu) is a kernel of its own (GK), so the
//     relu kernel carries none of dgelu's code.  384 threads compile to 168
//     registers a thread and the accumulators take 128, so the epilogue
//     takes threadIdx.x where it uses it (thread_x: its addresses are not
//     held across the main loop), reads a pass's gate pairs from one base
//     register (a0 ^ 16 g) and keeps at most a group's pairs and four rows'
//     sums in flight (fence_smem); without these ptxas spilled 8-40 bytes.
// Order: each output is 0 + the K-ascending sum of 16-deep m64n256k16 steps
// over its split's rows; the splits and their 64-row boundaries are the ones
// _build.GEMM_SCHEDULE[bfloat16] gives fused_attention_block._splits and
// _build.split_rows, and fm_colsum adds the split partials in a fixed order;
// the epilogue's arithmetic is epilogue_group's (v * gate', or v + resid,
// then the store's rounding).  So every output keeps the one-block-a-tile
// kernel's bits.  Ragged edges: TMA zero-fills past M, N and K, and the
// stores skip rows and columns past them ("nn" and "tn" take N % 8 == 0, so
// every 16-byte word is whole).
// Bound: the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM).  What is
// left is the epilogue, which both consumers run at once while the tensor
// cores wait.  At the lab shape (compare_kernels.py in turns with the
// one-block-a-tile kernel, NVIDIA H100 80GB HBM3, 700 W) the gated dh takes
// 0.92-0.95 ms [1.41-1.47] against 0.65-0.66 for the same product stored
// plain (its gate and its column sums' fp32 staging take the difference), dx
// + resid 0.74-0.75 [0.88] against 0.65-0.66, and the weight grads 0.28-0.78
// [0.30-0.84].  Tried in turns on the H100 and dropped:
// the gate or residual loaded by the consumers in 16-byte words three sets
// ahead in registers (the 168-register cap spilled, and the residual pass
// stayed slower than with TMA), a prefetch of the unit's tile into L2 (by
// TMA at the unit's start, by TMA for the later sets, or by the consumers'
// prefetch instructions some slices before the end: none faster, the
// residual slower), the column sums kept in registers to the tile's end
// (no faster, and they spilled), and dgelu called rather than inlined
// (slower).

// _build.WGMMA_NN_TN repeats these; _build.WGMMA_TILE is WG_BM x WG_BN, from
// which fused_attention_block._splits sizes the "tn" splits.
constexpr int WG_BM = 128;  // the block's output tile, WG_BM x WG_BN: 64 rows a consumer
constexpr int WG_BN = 256;
constexpr int WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = (WG_CONSUMERS + 1) * 128;  // + the producer's warpgroup
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_BN * WG_BK * 2;
constexpr int WG_RING = WG_STAGES * WG_STAGE_BYTES;
constexpr int WG_CHUNK = 64;             // columns of an epilogue pass
constexpr int WG_SET = WG_BM * 128;      // a set: the tile's rows x 128 bytes of gate or residual
constexpr int WG_BUFS = 2;               // set buffers
constexpr int WG_SLICE = 16 * 128;       // a consumer warp's 16 rows of a set buffer, bytes
constexpr int WG_BARS = 2 * WG_STAGES + 2 * WG_BUFS;  // full, empty; sfull, sempty
// Shared memory of a block, of the 232,448 bytes it may take: the ring 196,608,
// two set buffers 32,768 (each also the consumer warps' staging rows), the
// mbarriers 96, and 1,024 for the ring's 1024-byte alignment: 230,496.  A
// tile's gate (64 KB) or residual (128 KB) does not fit beside the ring, hence
// sets of 128 bytes a row, two in flight.
constexpr int WG_SMEM = WG_RING + WG_BUFS * WG_SET + WG_BARS * 8 + 1024;
static_assert(WG_SMEM <= 232448, "a block's shared memory fits the SM's 227 KB");
static_assert(WG_STAGE_BYTES % 1024 == 0 && WG_BOX % 1024 == 0 && WG_SET % 1024 == 0,
              "swizzle atoms stay aligned");

// Unit u of a bf16 "nn" / "tn" launch: tile u % tiles (numbered N-fastest) over
// split u / tiles, whose K rows [kb, kend = min(kb + Kc, K)) come in nk slices.
struct WgUnit {
  int m0, n0, split, kb, kend, nk;
};
__device__ __forceinline__ WgUnit wg_unit(int u, int tiles, int tiles_n, int K, int Kc) {
  const int t = u % tiles;
  WgUnit r;
  r.split = u / tiles;
  r.m0 = t / tiles_n * WG_BM;
  r.n0 = t % tiles_n * WG_BN;
  r.kb = r.split * Kc;
  r.kend = min(r.kb + Kc, K);
  r.nk = r.kend > r.kb ? (r.kend - r.kb + WG_BK - 1) / WG_BK : 0;
  return r;
}

// Sets of a tile: 64 bf16 gate columns or 32 fp32 residual columns each.
template <int MODE>
__host__ __device__ constexpr int wg_sets() {
  return MODE == EPI_GATE ? WG_BN / 64 : MODE == EPI_RESID ? WG_BN / 32 : 0;
}

// threadIdx.x, read where it is used: the epilogue's addresses derive from it,
// and ptxas would otherwise keep them all in registers across the main loop
// (384 threads compile to 168 registers a thread, 128 of them accumulators).
__device__ __forceinline__ int thread_x() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(x));
  return x;
}

// Keep the compiler from hoisting shared-memory loads above this point, so
// that few are in flight in registers beside the 128 accumulators.
__device__ __forceinline__ void fence_smem() { asm volatile("" ::: "memory"); }

// Byte offset of 16-byte word k of row r of a set as TMA's 128-byte swizzle
// lays it: word k ^ (r & 7).
__device__ __forceinline__ int wg_set_off(int r, int k) { return r * 128 + ((k ^ (r & 7)) << 4); }

// The dgelu gate's aux = round(gelu(hd)) of a warp's 16 rows of gate set s
// (columns n0 + 64 s ..), from the set as it lies: lane l word l % 8 of rows l
// / 8 + 4 j, whole 128-byte lines.
__device__ __noinline__ void wg_aux(const unsigned char* set, fm_bf16* __restrict__ aux, int row0,
                                    int r0, int col0, int M, int N, int lane) {
  const int col = col0 + (lane % 8) * 8;
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const int r = lane / 8 + 4 * j, row = row0 + r;
    const uint4 v = *reinterpret_cast<const uint4*>(set + wg_set_off(r0 + r, lane % 8));
    if (row >= M || col >= N) continue;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float g[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)  // bf16 k of the word: its bits are the fp32's top half
      g[k] = gelu(__uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16));
    store_group<8>(aux + (size_t)row * N + col, g);
  }
}

// Epilogue pass CH of a consumer warp: its 16 rows (lr ..) x columns 64 CH ..
// 64 CH + 63 of the tile, fragment groups i = 8 CH + g (columns 8 i + 2 q, +
// 1; rows rq, rq + 8 as acc[4 i .. 4 i + 3]).  A template, so that every index
// into acc is a constant.  gs counts the sets taken (their buffers alternate).
template <int CH, int MODE, int GK, typename TOut>
__device__ __forceinline__ void wg_pass(float (&acc)[128], const Epi& e,
                                        const WgUnit& t, TOut* __restrict__ out,
                                        unsigned char* bufs, uint64_t* sfull, uint64_t* sempty,
                                        int& gs, int M, int N) {
  const int tid = thread_x();
  const int lane = tid % 32, warp = tid / 32;  // consumer warp 0 .. 7
  const int lr = warp * 16;                    // its first row in the tile
  const int rq = lane / 4, q = lane % 4;
  const int col0 = t.n0 + CH * WG_CHUNK;
  unsigned char* st;         // this pass's staging rows: the warp's slice of a set buffer
  float cs[2];               // EPI_GATE: columns col0 + lane, + 32 summed over the warp's rows
  if constexpr (MODE == EPI_GATE) {
    // Row lr + rq's word 0 with its swizzle (bits 4-6) and byte 4 q: word g of
    // row + 8 h is at (a0 + 1024 h) ^ 16 g, one register for the pass's pairs.
    const int a0 = wg_set_off(lr + rq, 0) + q * 4;
    // The pass's gate: set CH, read where it landed.
    const int b = gs % WG_BUFS;
    mbar_wait(&sfull[b], (gs / WG_BUFS) & 1);
    const unsigned char* set = bufs + b * WG_SET;
    if (GK == GATE_DGELU && e.aux)  // a = round(gelu(hd)), the dW2 operand
      wg_aux(set, static_cast<fm_bf16*>(e.aux), t.m0 + lr, lr, col0, M, N, lane);
#pragma unroll
    for (int g = 0; g < WG_CHUNK / 8; ++g) {
      const int i = CH * (WG_CHUNK / 8) + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // wg_set_off(lr + rq + 8 h, g) + 4 q
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
            set + (a0 + 1024 * h ^ 16 * g));
        const float t0 = __bfloat162float(p.x), t1 = __bfloat162float(p.y);
        if constexpr (GK == GATE_RELU) {
          acc[4 * i + 2 * h] *= t0 > 0.0f ? e.gate_scale : 0.0f;
          acc[4 * i + 2 * h + 1] *= t1 > 0.0f ? e.gate_scale : 0.0f;
        } else {
          acc[4 * i + 2 * h] *= dgelu(t0);
          acc[4 * i + 2 * h + 1] *= dgelu(t1);
        }
      }
      fence_smem();  // a group's pairs at a time: the registers stay within the 168
    }
    __syncwarp();
    st = bufs + b * WG_SET + warp * WG_SLICE;
    // The column sums of the warp's 16 rows: each half pass staged in fp32,
    // and lane l adds column l down the rows in order.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int g = 4 * hf; g < 4 * hf + 4; ++g) {
        const int i = CH * (WG_CHUNK / 8) + g, c = 8 * (g - 4 * hf) + 2 * q;
        wn_stage(st, rq, c, acc[4 * i], acc[4 * i + 1], (float*)nullptr);
        wn_stage(st, rq + 8, c, acc[4 * i + 2], acc[4 * i + 3], (float*)nullptr);
      }
      __syncwarp();
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {  // rows past M: acc and gate are TMA's zeros, adding +0
        s += *reinterpret_cast<const float*>(st + wn_stage_off(r, lane / 4) + (lane % 4) * 4);
        if (r % 4 == 3) fence_smem();  // four rows' loads in flight at a time
      }
      cs[hf] = s;
      __syncwarp();
    }
  } else if constexpr (MODE == EPI_RESID) {
    // The pass's residual: sets 2 CH and 2 CH + 1 (32 columns each), read
    // where they landed and added; the first buffer goes back at once.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int b = gs % WG_BUFS;
      mbar_wait(&sfull[b], (gs / WG_BUFS) & 1);
      const unsigned char* set = bufs + b * WG_SET;
#pragma unroll
      for (int g = 4 * hf; g < 4 * hf + 4; ++g) {
        const int i = CH * (WG_CHUNK / 8) + g, c = 8 * (g - 4 * hf) + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 r = *reinterpret_cast<const float2*>(
              set + wg_set_off(lr + rq + 8 * h, c / 4) + (c % 4) * 4);
          acc[4 * i + 2 * h] += r.x;
          acc[4 * i + 2 * h + 1] += r.y;
        }
        fence_smem();
      }
      __syncwarp();
      if (hf == 0) {
        if (lane == 0) mbar_arrive(&sempty[b]);
        ++gs;
      } else {
        st = bufs + b * WG_SET + warp * WG_SLICE;
      }
    }
  } else {
    st = bufs + warp * WG_SLICE;  // no sets: buffer 0's rows stage C
  }
  // C: one staged set of 128-byte rows for bf16, two for fp32.
  constexpr int PER = 128 / sizeof(TOut) / 8;  // fragment groups a staged row holds
#pragma unroll
  for (int p = 0; p < WG_CHUNK / 8 / PER; ++p) {
#pragma unroll
    for (int g = p * PER; g < (p + 1) * PER; ++g) {
      const int i = CH * (WG_CHUNK / 8) + g, c = 8 * (g - p * PER) + 2 * q;
      wn_stage(st, rq, c, acc[4 * i], acc[4 * i + 1], (TOut*)nullptr);
      wn_stage(st, rq + 8, c, acc[4 * i + 2], acc[4 * i + 3], (TOut*)nullptr);
    }
    __syncwarp();
    wn_flush(st, out, t.m0 + lr, col0 + p * PER * 8, M, N, lane);
    __syncwarp();
  }
  if constexpr (MODE == EPI_GATE) {
    // The 8 warps' column sums through their rows of the set buffer, added in
    // warp order into colpart[m0 / 128, col0 ..], between two barriers of the
    // 256 consumer threads.
    const unsigned char* buf = bufs + (gs % WG_BUFS) * WG_SET;
    reinterpret_cast<float*>(st)[lane] = cs[0];
    reinterpret_cast<float*>(st)[32 + lane] = cs[1];
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS * 128) : "memory");
    const int c = thread_x();
    if (c < WG_CHUNK && col0 + c < N) {
      float s = 0.0f;
#pragma unroll 1
      for (int w = 0; w < 4 * WG_CONSUMERS; ++w)
        s += reinterpret_cast<const float*>(buf + w * WG_SLICE)[c];
      e.colpart[(size_t)(t.m0 / WG_BM) * N + col0 + c] = s;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS * 128) : "memory");
  }
  if constexpr (MODE == EPI_GATE || MODE == EPI_RESID) {  // the set buffer goes back
    if (lane == 0) mbar_arrive(&sempty[gs % WG_BUFS]);
    ++gs;
  }
}

template <typename TOut, int AT, int MODE, int GK>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_bf16_nn_tn_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB,
                       const __grid_constant__ CUtensorMap tmE, TOut* __restrict__ C, int M,
                       int N, int K, int Kc, int splits, Epi e) {
  constexpr bool FETCH = MODE == EPI_GATE || MODE == EPI_RESID;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bufs = ring + WG_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + WG_BUFS * WG_SET);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* sfull = empty + WG_STAGES;  // set buffer b landed
  uint64_t* sempty = sfull + WG_BUFS;   // set buffer b read: one arrive per consumer warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (N + WG_BN - 1) / WG_BN;
  const int tiles = (M + WG_BM - 1) / WG_BM * tiles_n;
  const int units = tiles * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive, plus the copies' bytes
      mbar_init(&empty[s], WG_CONSUMERS);  // one arrive per consumer warpgroup
    }
    for (int b = 0; b < WG_BUFS; ++b) {
      mbar_init(&sfull[b], 1);
      mbar_init(&sempty[b], 4 * WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG_CONSUMERS) {  // the producer warpgroup: no block-wide barrier again
    setmaxnreg_dec<40>();
    if (warp == 4 * WG_CONSUMERS && lane == 0) {  // the ring
      int q = 0;  // slices issued, over all of this block's units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const WgUnit t = wg_unit(u, tiles, tiles_n, K, Kc);
        for (int kt = 0; kt < t.nk; ++kt, ++q) {
          const int s = q % WG_STAGES, k = t.kb + kt * WG_BK;
          mbar_wait(&empty[s], ((q / WG_STAGES) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&full[s], WG_STAGE_BYTES);
          unsigned char* a = ring + s * WG_STAGE_BYTES;
          if (AT) {
            tma_load(a, &tmA, t.m0, k, &full[s]);
            tma_load(a + WG_BOX, &tmA, t.m0 + 64, k, &full[s]);
          } else {
            tma_load(a, &tmA, k, t.m0, &full[s]);
          }
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j)
            tma_load(a + WG_A_BYTES + j * WG_BOX, &tmB, t.n0 + 64 * j, k, &full[s]);
        }
      }
    } else if (FETCH && warp == 4 * WG_CONSUMERS + 1 && lane == 0) {  // the gate / residual
      int gs = 0;  // sets issued, over all of this block's units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const WgUnit t = wg_unit(u, tiles, tiles_n, K, Kc);
        for (int x = 0; x < wg_sets<MODE>(); ++x, ++gs) {
          const int b = gs % WG_BUFS;
          mbar_wait(&sempty[b], ((gs / WG_BUFS) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&sfull[b], WG_SET);
          tma_load(bufs + b * WG_SET, &tmE, t.n0 + x * (WG_BN / wg_sets<MODE>()), t.m0,
                   &sfull[b]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int wg = warp / 4;
  int qs = 0;  // slices consumed, over all of this block's units
  int gs = 0;  // sets taken, over all of this block's units
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const WgUnit t = wg_unit(u, tiles, tiles_n, K, Kc);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    for (int kt = 0; kt < t.nk; ++kt, ++qs) {
      const int s = qs % WG_STAGES;
      mbar_wait(&full[s], (qs / WG_STAGES) & 1);
      // This consumer's 64 rows of A: the second half of a K-major [128][64]
      // box, or the second MN-major box; 8 KB on either way.
      const uint32_t a = smem_u32(ring + s * WG_STAGE_BYTES) + wg * 64 * WG_BK * 2;
      const uint32_t b = smem_u32(ring + s * WG_STAGE_BYTES + WG_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_m64n256k16<AT, 1>(acc, wg_desc<AT>(a, kk), wg_desc<1>(b, kk));
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // slice kt - 1 is done
      fence_regs(acc);
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WG_STAGES]);
    }
    wgmma_wait_all();
    fence_regs(acc);
    if (t.nk > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WG_STAGES]);

    TOut* out = C + (size_t)t.split * M * N;
    static_assert(WG_BN / WG_CHUNK == 4, "four epilogue passes");
    wg_pass<0, MODE, GK>(acc, e, t, out, bufs, sfull, sempty, gs, M, N);
    wg_pass<1, MODE, GK>(acc, e, t, out, bufs, sfull, sempty, gs, M, N);
    wg_pass<2, MODE, GK>(acc, e, t, out, bufs, sfull, sempty, gs, M, N);
    wg_pass<3, MODE, GK>(acc, e, t, out, bufs, sfull, sempty, gs, M, N);
  }
}

// The map of one bf16 operand with ``mn`` rows or columns: K-major [mn, K] in
// [box_mn, 64] boxes, or MN-major [K, mn] in [64, 64] boxes.
bool operand_map(CUtensorMap* map, const void* p, int mn, int K, bool mn_major, int box_mn) {
  return mn_major ? tma_map(map, p, false, K, mn, WG_BK, 64)
                  : tma_map(map, p, false, mn, K, box_mn, WG_BK);
}

template <typename TOut, int AT, int MODE>
cudaError_t launch_bf16_nn_tn(const void* A, const void* B, void* C, int M, int N, int K,
                              int splits, const Epi& e, cudaStream_t s) {
  const long long units =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN) * splits;
  if (units == 0) return cudaSuccess;
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  // K rows per split, a multiple of the K slice; the last split may be short (or empty).
  const int Kc = ((K + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK;
  CUtensorMap ta{}, tb{}, te{};  // K == 0 loads nothing
  if (K > 0 && (!operand_map(&ta, A, M, K, AT, WG_BM) || !operand_map(&tb, B, N, K, true, WG_BN)))
    return cudaErrorInvalidValue;
  // The gate [M, N] bf16 or residual [M, N] fp32 in sets of [WG_BM rows][128 bytes].
  if ((MODE == EPI_GATE && !tma_map(&te, e.gate, false, M, N, WG_BM, 64)) ||
      (MODE == EPI_RESID && !tma_map(&te, e.resid, true, M, N, WG_BM, 32)))
    return cudaErrorInvalidValue;
  // The gate's kind is a kernel of its own, so each carries only its own code.
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, TOut*, int, int, int, int, int, Epi);
  if constexpr (MODE == EPI_GATE)
    kernel = e.gate_kind == GATE_RELU ? gemm_bf16_nn_tn_kernel<TOut, AT, MODE, GATE_RELU>
                                      : gemm_bf16_nn_tn_kernel<TOut, AT, MODE, GATE_DGELU>;
  else
    kernel = gemm_bf16_nn_tn_kernel<TOut, AT, MODE, GATE_NONE>;
  // Per launch, as the attribute belongs to the current device.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = units < sms ? (int)units : sms;
  kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(ta, tb, te, static_cast<TOut*>(C), M, N, K, Kc, splits,
                                            e);
  return cudaGetLastError();
}

// ---- fp32 "nt" kernel: persistent, TMA-fed, warp-specialised --------------------
//
// C[M, N] = epilogue(A[M, K] . B[N, K]^T) in full IEEE fp32 on the CUDA cores,
// for every fp32 forward product (Pallas #1 / #5's QKV and Wo, #2 / #7's W1
// and W2, the text encoder's).  Both operands are K-major, which is what held
// the cp.async kernel it replaced (gemm_f32_kernel, which also ran "nn" and
// "tn" before gemm_f32_nn_tn_kernel) back on this form: each K slice went through registers and was
// stored back transposed by every thread.  Here nothing is staged or
// transposed.
//   - A block of NT_THREADS = 384 holds NT_CONSUMERS = 2 consumer
//     warpgroups (warps 0-3 and 4-7), each with its own producer warp (warps
//     8, 9 of the third warpgroup, whose warps 10 and 11 idle), its own ring
//     of NT_STAGES K slices and its own sequence of output tiles.  The
//     producer's one thread brings each 32-deep slice of A [128 rows][32 K]
//     and B [64 rows][32 K] by TMA (a 128-byte line of K per row, 128-byte
//     swizzle: the 16-byte chunk ch of row r lands at chunk ch ^ (r & 7)),
//     completing on the stage's "full" mbarrier; the consumer's four warps
//     release it on "empty" (one arrive each).  The register file is split
//     four ways, a warp of each warpgroup on each quarter, so 384 threads
//     start at 168 registers; setmaxnreg then moves them from the producer
//     warpgroup (40) to the consumers (232), whose 64 accumulators and 16
//     float4 of operands a chunk then fit without spilling.
//   - Persistent: grid = min(SMs, tiles), one block per SM (222 KB of
//     shared memory).  Output tiles of NT_BM x NT_BN are numbered N-fastest
//     (t = mt * tiles_n + nt); tile t belongs to block t % grid, and the
//     block's consumers take its tiles in turn (consumer c: t = blockIdx.x +
//     grid * (2 i + c)).  So every SM gets floor or ceil(tiles / grid) tiles,
//     the fixed order gives the same bits every run, and while a consumer
//     runs a tile's epilogue its producer already fills the ring with the
//     next tile's slices (and the other consumer computes).  N-fastest keeps
//     the tiles in flight on a band of A rows (8 to 22 of the 70 row blocks
//     at batch 16) against the whole weight, which stays in L2: W2's A at
//     batch 16 is 73 MB, more than L2, and an M-fastest order would stream
//     it once per 64 columns.
//   - Consumer thread map, designed with the swizzle: warp w of a consumer,
//     lane l = 8 rq + cq, owns rows r0 + 8 i (i < 8, r0 = 64 (w / 2) +
//     4 (w % 2) + rq) and columns cq + 8 j (j < 8), an 8 x 8 micro-tile.  Per
//     16-byte chunk ch of K (4 consecutive k) it reads its 8 A rows and 8 B
//     rows as float4 where TMA put them: every row of a thread has the same
//     row & 7, so one offset off ^ (ch << 4) serves all eight and the rest
//     are immediates (8 rows = 1024 bytes on).  A warp's A read covers 4
//     consecutive rows (4 chunks, distinct swizzled positions), its B read 8
//     consecutive rows (8 chunks, 8 positions): each is one wavefront.
//     The lane-per-row K-major reads tried on gemm_f32_kernel (13% slower)
//     were unswizzled: rows 4 apart, 64 bytes long, fall on one bank
//     quad.  Here the swizzle spreads rows of distinct r & 7, and this map
//     reads only such rows together.
//   - Order: each accumulator is one fmaf chain over k = 0, 1, ... (the 4 k
//     of a chunk in order, chunks and slices in order), the same chain
//     gemm_f32_kernel ran on this form, so the two give the same bits.
//   - Epilogue: the micro-tile's columns are 8 apart, so the consumer stages
//     its 128 x 64 accumulators in its own buffer (pitch NT_CPITCH = 72: a
//     warp's scalar stores, 4 rows x 8 columns, land on 32 banks) and reads
//     them back as 4 consecutive columns for epilogue_group: bias, aux,
//     relu / gelu, Philox inner dropout at (row * N + col) >> 2, 16-byte
//     stores; two named barriers of the consumer's 128 threads a tile.
//   - Ragged edges: TMA zero-fills rows past M and N (K % 32 == 0, the
//     wrapper's rule); the epilogue skips them.
// Bound: the CUDA cores' fp32 rate (67 TFLOP/s).  At batch 16 on the
// H100 (700 W, compare_kernels.py --fp32 in turns with gemm_f32_kernel): W1
// with relu, dropout and aux 0.701-0.721 ms (39-40 TFLOP/s) against
// 0.835-0.857, W2 0.728-0.742 against 0.827-0.886, QKV 0.761-0.801 against
// 0.878-0.880; cuBLAS (F.linear, TF32 off) 0.675-0.721, 0.708-0.775,
// 0.673-0.735.  Tried in turns:
//   - 320 threads (a producer warp per consumer, no third warpgroup): ptxas
//     held them to 168 registers and spilled 40 bytes, and __maxnreg__(200)
//     was refused at launch (10 warps put 3 on one quarter of the register
//     file: 3 x 32 x 200 > 16384); hence the producers' warpgroup and
//     setmaxnreg.
//   - The chunk loop unrolled by 8 (one 2048-FFMA body a slice): W1
//     0.688-0.695 ms, W2 0.731-0.733, text W2 (K 3072) 0.556-0.580, against
//     0.672, 0.692-0.704, 0.468-0.505 rolled; by 2 or 4 within the spread of
//     rolled.  So it stays rolled (#pragma unroll 1).
//   - Tiles M-fastest (unrolled): W2 0.743 ms, text W2 0.573, against 0.731
//     and 0.556 N-fastest.

// _build.SGEMM_NT repeats these.
constexpr int NT_BM = 128;  // a consumer's output tile, NT_BM x NT_BN
constexpr int NT_BN = 64;
constexpr int NT_BK = 32;  // one 128-byte swizzle line of fp32
constexpr int NT_STAGES = 3;
constexpr int NT_CONSUMERS = 2;
constexpr int NT_THREADS = (NT_CONSUMERS + 1) * 128;  // + the producers' warpgroup
constexpr int NT_A_BYTES = NT_BM * NT_BK * 4;
constexpr int NT_STAGE_BYTES = NT_A_BYTES + NT_BN * NT_BK * 4;
constexpr int NT_RING = NT_STAGES * NT_STAGE_BYTES;
constexpr int NT_CPITCH = NT_BN + 8;  // fp32 staging pitch (floats)
constexpr int NT_CSTAGE = NT_BM * NT_CPITCH * 4;
// Rings, staging tiles, mbarriers (full and empty per stage), 1024-byte alignment.
constexpr int NT_SMEM = NT_CONSUMERS * (NT_RING + NT_CSTAGE + 2 * NT_STAGES * 8) + 1024;
static_assert(NT_SMEM <= 232448, "a block's shared memory fits the SM's 227 KB");
static_assert(NT_STAGE_BYTES % 1024 == 0 && NT_CSTAGE % 1024 == 0, "swizzle atoms stay aligned");

__global__ void __launch_bounds__(NT_THREADS, 1)
gemm_f32_nt_kernel(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmB, float* __restrict__ C, int M, int N,
                   int K, Epi e) {
  fm::load_key(e.drop);  // before any thread draws
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = warp < 4 * NT_CONSUMERS ? warp / 4 : warp - 4 * NT_CONSUMERS;  // consumer
  unsigned char* ring = base + c * NT_RING;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + NT_CONSUMERS * (NT_RING + NT_CSTAGE)) + c * 2 * NT_STAGES;
  uint64_t* empty = full + NT_STAGES;
  const int tiles_n = (N + NT_BN - 1) / NT_BN;
  const int tiles = (M + NT_BM - 1) / NT_BM * tiles_n;
  const int nk = K / NT_BK;
  const int first = blockIdx.x + gridDim.x * c, step = gridDim.x * NT_CONSUMERS;
  if (threadIdx.x < NT_CONSUMERS * NT_STAGES) {
    uint64_t* f = reinterpret_cast<uint64_t*>(base + NT_CONSUMERS * (NT_RING + NT_CSTAGE)) +
                  threadIdx.x / NT_STAGES * 2 * NT_STAGES + threadIdx.x % NT_STAGES;
    mbar_init(f, 1);               // the producer's arrive, plus the copies' bytes
    mbar_init(f + NT_STAGES, 4);   // one arrive per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NT_CONSUMERS) {  // the producers' warpgroup; warp 8 + c feeds consumer c
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (c < NT_CONSUMERS && lane == 0) {
      int q = 0;  // slices issued, over all of this consumer's tiles
      for (int t = first; t < tiles; t += step) {
        const int m0 = t / tiles_n * NT_BM, n0 = t % tiles_n * NT_BN;
        for (int kt = 0; kt < nk; ++kt, ++q) {
          const int s = q % NT_STAGES;
          mbar_wait(&empty[s], ((q / NT_STAGES) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&full[s], NT_STAGE_BYTES);
          unsigned char* a = ring + s * NT_STAGE_BYTES;
          tma_load(a, &tmA, kt * NT_BK, m0, &full[s]);
          tma_load(a + NT_A_BYTES, &tmB, kt * NT_BK, n0, &full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int tid = threadIdx.x % 128, w = tid / 32;
  const int rq = lane / 8, cq = lane % 8;
  const int r0 = (w / 2) * 64 + (w % 2) * 4 + rq;
  // Byte offsets in a stage of the thread's first A and B row, their swizzle
  // (row & 7) in bits 4-6: chunk ch of that row is at off ^ (ch << 4).
  const uint32_t offa = r0 * 128 + ((r0 & 7) << 4);
  const uint32_t offb = NT_A_BYTES + cq * 128 + (cq << 4);
  float* stage = reinterpret_cast<float*>(base + NT_CONSUMERS * NT_RING + c * NT_CSTAGE);
  int q = 0;
  for (int t = first; t < tiles; t += step) {
    const int m0 = t / tiles_n * NT_BM, n0 = t % tiles_n * NT_BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++q) {
      const int s = q % NT_STAGES;
      mbar_wait(&full[s], (q / NT_STAGES) & 1);
      const unsigned char* st = ring + s * NT_STAGE_BYTES;
#pragma unroll 1
      for (int ch = 0; ch < NT_BK / 4; ++ch) {
        const float4* pa = reinterpret_cast<const float4*>(st + (offa ^ (ch << 4)));
        const float4* pb = reinterpret_cast<const float4*>(st + (offb ^ (ch << 4)));
        float4 a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = pa[64 * i];  // rows 8 apart: 1024 bytes
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = pb[64 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue through the staging tile: the consumer's last reads of it are
    // done, then its 128 x 64 accumulators go in, then groups of 4 columns
    // come out.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) stage[(r0 + 8 * i) * NT_CPITCH + cq + 8 * j] = acc[i][j];
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll 4
    for (int u = 0; u < NT_BM * NT_BN / 4 / 128; ++u) {
      const int g = u * 128 + tid;  // 16 groups a row: a warp stores two 256-byte rows
      const int lr = g / (NT_BN / 4), col = n0 + 4 * (g % (NT_BN / 4));
      if (m0 + lr < M && col < N) {
        float v[4];
        load_group<4>(stage + lr * NT_CPITCH + 4 * (g % (NT_BN / 4)), v);
        epilogue_group<EPI_BIAS_ACT, 4, float, float>(e, m0 + lr, col, N, v, C, nullptr);
      }
    }
  }
}

cudaError_t launch_f32_nt(const void* A, const void* B, void* C, int M, int N, int K, const Epi& e,
                          cudaStream_t s) {
  const int tiles = (M + NT_BM - 1) / NT_BM * ((N + NT_BN - 1) / NT_BN);
  if (tiles == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  CUtensorMap ta{}, tb{};  // K == 0 loads nothing
  if (K > 0 && (!tma_map(&ta, A, true, M, K, NT_BM, NT_BK) ||
                !tma_map(&tb, B, true, N, K, NT_BN, NT_BK)))
    return cudaErrorInvalidValue;
  // Per launch, as the attribute belongs to the current device.
  err = cudaFuncSetAttribute(gemm_f32_nt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             NT_SMEM);
  if (err != cudaSuccess) return err;
  gemm_f32_nt_kernel<<<sms < tiles ? sms : tiles, NT_THREADS, NT_SMEM, s>>>(
      ta, tb, static_cast<float*>(C), M, N, K, e);
  return cudaGetLastError();
}

// ---- fp32 "nn" / "tn" kernel: persistent, TMA-fed, warp-specialised -------------
//
// C[M, N] = epilogue(op(A) . B[K, N]) in full IEEE fp32 on the CUDA cores, for
// every fp32 backward product: "nn" (A [M, K] K-major: dO = da.Wo, dx =
// dqkv.Wqkv (+ dz), dh = (dy.W2) * gate, dx = dh.W1 (+ dz) of Pallas #3, #4,
// #6 and #8) and "tn" (A [K, M] MN-major: the weight grads dWo, dWqkv, dW1,
// dW2, K = the R rows).  B is always MN-major.  The shape is
// gemm_f32_nt_kernel's (above); what differs is the MN-major operand and the
// thread map, split-K and epilogue that come with it.
//   - A block of MN_THREADS = 384: two consumer warpgroups (warps 0-3,
//     4-7), each with its own producer warp (8, 9; 10 and 11 idle), its own
//     ring of MN_STAGES = 4 slices (no staging tile, so its room holds a
//     fourth stage) and its own units of work; setmaxnreg 40 / 232 as there.
//     Each 32-deep K slice arrives by TMA with the 128-byte swizzle: a
//     K-major operand as one [rows][32 K] box (a 128-byte line of K per row,
//     chunk ch of row r at ch ^ (r & 7)), an MN-major one as [32 K][32 MN]
//     boxes of 4 KB (a 128-byte line of 32 columns per k, the 4-column chunk
//     g of line k at g ^ (k & 7)): B's 64 columns in two boxes, "tn"'s A's
//     128 rows in four.
//   - Persistent: a unit is one 128 x 64 output tile over one K split; unit
//     u = split * tiles + t, tiles numbered N-fastest (as "nt"), so the units
//     in flight share a split's rows of A and B in L2.  grid = min(SMs,
//     units); unit u belongs to block u % grid and the block's consumers take
//     its units in turn (consumer c: u = blockIdx.x + grid * (2 i + c)).
//     "nn" is one split (K % 32 == 0); "tn" splits its R rows into
//     fused_attention_block._splits' count of Kc rows, the count and the
//     16-row boundaries (MN_KSTEP) the cp.async kernel had (a slice that
//     crosses a boundary stops its chunks there; the last split may be short
//     or empty, TMA zero-fills past K), and writes fp32 partials [splits, M,
//     N] that fm_colsum adds in split order.  Split-K over units fills the
//     card where a weight grad has fewer tiles than the 264 consumers (dWqkv
//     216 at 128 x 64), and a persistent schedule leaves no wave tail for a
//     narrower tile to trim: the cp.async kernel's 128 x 64 narrow tile (four
//     blocks an SM, "nn" at N <= 768) went with it.
//   - Consumer thread map, designed with the swizzle: warp w, lane l = 8 rq
//     + cq owns columns 4 cq + {0..3} and 32 + 4 cq + {0..3} (j = 4 h + e:
//     box h, chunk cq), and rows r0 + 8 i ("nn", r0 = 64 (w / 2) + 4 (w % 2)
//     + rq, the nt kernel's rows) or 4 ga + {0..3} and 64 + 4 ga + {0..3}
//     ("tn", ga = 4 w + rq: box w / 2 (+ 2), chunk 4 (w % 2) + rq).  Per
//     chunk of 4 k it reads 16 float4: for "nn" the 8 A rows' 4 k each at
//     offa ^ (ch << 4) + 1024 i, as "nt"; for each k its B float4 of 4
//     columns in both boxes (and for "tn" its two A float4 of 4 rows), at
//     (off + 512 ch) ^ ((k & 7) << 4) + 128 (k & 3).  A warp's B read is 8
//     chunks of one 128-byte line, its MN-major A read 4, its K-major A read
//     4 rows of distinct r & 7: one wavefront each.  Then 256 FFMA, each row
//     i's 8 columns in serpentine order (CUTLASS's SIMT order: the operand of
//     the turn is reused), the chunk loop unrolled by 2.
//   - Order: each accumulator is one fmaf chain over its split's k in
//     increasing order, as in gemm_f32_kernel, over the same splits, and the
//     gate's column sums are added in its order (below): every output is the
//     bits it gave.  fp32 training is chaotic at the rounding level (AdamW
//     turns a rounding-level grad into a +-lr move), so other bits would move
//     every fp32 run's trajectory and each check held to an order drift.
//   - Epilogue, straight from the registers: a thread's 8 columns are two
//     groups of 4, so epilogue_group runs on them in place (no staging tile,
//     no barrier), and a warp's 16-byte stores cover 4 rows x 128 whole
//     bytes.  EPI_RESID / EPI_GATE first read all 16 residual or gate groups
//     of the thread (N % 8 == 0), so their loads overlap rather than wait
//     one by one behind the stores.  EPI_GATE's column sums take
//     gemm_f32_kernel's order: its 16 groups of 8 rows each summed in a
//     chain of shuffles across the 4 lanes that hold them, then through the
//     consumer's MN_CSUM buffer into colpart[m0 / 128, col] in group order,
//     behind a named barrier before (the last tile's sums are read) and after
//     (all are written).  Ragged edges: TMA zero-fills past M, N and K; the
//     epilogue skips rows and columns past M and N.
// Bound: the CUDA cores' fp32 rate (67 TFLOP/s).  The cp.async kernel it
// replaced (gemm_f32_kernel: 128 x 128 tiles, two blocks of 256 an SM, a
// register-staged transpose of a K-major A) reached 30-37 TFLOP/s; without
// its global loads 42-45, which is why this one takes its slices by TMA.
// Tried there, none faster: a 16-wide warp layout, unswizzled lane-per-row
// K-major reads (13% slower), 8 x 16 micro-tiles on 128 threads (255
// registers).  Tried here in turns on the H100 (the B 16 stages, PERF.md
// section 6): the next chunk's operands read into a second
// register set while this one's FMAs run (no faster); the epilogue's loads
// one group at a time (the gated dh and dx + resid 4-7% slower); three
// consumers of 12 warps at setmaxnreg 160 (spills 24-192 bytes, 2-10%
// slower); the chunk loop rolled (dO 0.30-0.34 ms against 0.29).

// _build.SGEMM_NN_TN repeats these.
constexpr int MN_BM = 128;  // a consumer's output tile, MN_BM x MN_BN
constexpr int MN_BN = 64;
constexpr int MN_BK = 32;   // one 128-byte swizzle line of fp32: K slice depth and box width
constexpr int MN_KSTEP = 16;  // "tn" split boundaries fall on multiples of 16 rows
constexpr int MN_STAGES = 4;
constexpr int MN_CONSUMERS = 2;
constexpr int MN_THREADS = (MN_CONSUMERS + 1) * 128;  // + the producers' warpgroup
constexpr int MN_BOX = MN_BK * MN_BK * 4;  // an MN-major [32 K][32 MN] box, bytes
constexpr int MN_A_BYTES = MN_BM * MN_BK * 4;
constexpr int MN_STAGE_BYTES = MN_A_BYTES + MN_BN * MN_BK * 4;
constexpr int MN_RING = MN_STAGES * MN_STAGE_BYTES;
constexpr int MN_CSUM = 16 * MN_BN * 4;  // EPI_GATE: the 16 thread rows' column sums
// Rings, column sums, mbarriers (full and empty per stage), 1024-byte alignment.
constexpr int MN_SMEM = MN_CONSUMERS * (MN_RING + MN_CSUM + 2 * MN_STAGES * 8) + 1024;
static_assert(MN_SMEM <= 232448, "a block's shared memory fits the SM's 227 KB");
static_assert(MN_BOX % 1024 == 0 && MN_STAGE_BYTES % 1024 == 0 && MN_RING % 1024 == 0,
              "swizzle atoms stay aligned");

// Unit u of a launch: tile u % tiles (numbered N-fastest) over split u / tiles,
// whose K rows [kb, kend = min(kb + Kc, K)) come in nk slices.
struct Unit {
  int m0, n0, split, kb, kend, nk;
};
__device__ __forceinline__ Unit mn_unit(int u, int tiles, int tiles_n, int K, int Kc) {
  const int t = u % tiles;
  Unit r;
  r.split = u / tiles;
  r.m0 = t / tiles_n * MN_BM;
  r.n0 = t % tiles_n * MN_BN;
  r.kb = r.split * Kc;
  r.kend = min(r.kb + Kc, K);
  r.nk = r.kend > r.kb ? (r.kend - r.kb + MN_BK - 1) / MN_BK : 0;
  return r;
}

template <int AT, int MODE>
__global__ void __launch_bounds__(MN_THREADS, 1)
gemm_f32_nn_tn_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB, float* __restrict__ C, int M,
                      int N, int K, int Kc, int splits, Epi e) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = warp < 4 * MN_CONSUMERS ? warp / 4 : warp - 4 * MN_CONSUMERS;  // consumer
  unsigned char* ring = base + c * MN_RING;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + MN_CONSUMERS * (MN_RING + MN_CSUM));
  uint64_t* full = bars + c * 2 * MN_STAGES;
  uint64_t* empty = full + MN_STAGES;
  const int tiles_n = (N + MN_BN - 1) / MN_BN;
  const int tiles = (M + MN_BM - 1) / MN_BM * tiles_n;
  const int units = tiles * splits;
  const int first = blockIdx.x + gridDim.x * c, step = gridDim.x * MN_CONSUMERS;
  if (threadIdx.x < MN_CONSUMERS * MN_STAGES) {
    uint64_t* f = bars + threadIdx.x / MN_STAGES * 2 * MN_STAGES + threadIdx.x % MN_STAGES;
    mbar_init(f, 1);              // the producer's arrive, plus the copies' bytes
    mbar_init(f + MN_STAGES, 4);  // one arrive per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * MN_CONSUMERS) {  // the producers' warpgroup; warp 8 + c feeds consumer c
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (c < MN_CONSUMERS && lane == 0) {
      int q = 0;  // slices issued, over all of this consumer's units
      for (int u = first; u < units; u += step) {
        const Unit t = mn_unit(u, tiles, tiles_n, K, Kc);
        for (int kt = 0; kt < t.nk; ++kt, ++q) {
          const int s = q % MN_STAGES, k = t.kb + kt * MN_BK;
          mbar_wait(&empty[s], ((q / MN_STAGES) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&full[s], MN_STAGE_BYTES);
          unsigned char* a = ring + s * MN_STAGE_BYTES;
          if (AT) {
#pragma unroll
            for (int j = 0; j < MN_BM / 32; ++j)
              tma_load(a + j * MN_BOX, &tmA, t.m0 + 32 * j, k, &full[s]);
          } else {
            tma_load(a, &tmA, k, t.m0, &full[s]);
          }
#pragma unroll
          for (int h = 0; h < MN_BN / 32; ++h)
            tma_load(a + MN_A_BYTES + h * MN_BOX, &tmB, t.n0 + 32 * h, k, &full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int tid = threadIdx.x % 128, w = tid / 32;
  const int rq = lane / 8, cq = lane % 8;
  const int r0 = (w / 2) * 64 + (w % 2) * 4 + rq;  // "nn": rows r0 + 8 i
  const int ga = 4 * w + rq;                        // "tn": rows 4 ga + {0..3}, + 64
  // Byte offsets in a stage: a K-major A's first row with its swizzle (row &
  // 7) in bits 4-6, or an MN-major A's chunk ga % 8 in box ga / 8; B's chunk
  // cq in box 0.  For k = 4 ch + kk of an MN-major operand, (off + 512 ch) ^
  // ((k & 7) << 4), + 128 kk.
  const uint32_t offa = AT ? (w / 2) * MN_BOX + ((4 * (w % 2) + rq) << 4)
                           : r0 * 128 + ((r0 & 7) << 4);
  const uint32_t offb = MN_A_BYTES + (cq << 4);
  float* sums = reinterpret_cast<float*>(base + MN_CONSUMERS * MN_RING + c * MN_CSUM);
  int q = 0;
  for (int u = first; u < units; u += step) {
    const Unit t = mn_unit(u, tiles, tiles_n, K, Kc);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < t.nk; ++kt, ++q) {
      const int s = q % MN_STAGES;
      // The slice's chunks of this split: a split that ends before K ends on a
      // 16-row boundary, maybe half-way into the slice, whose other half is
      // the next split's; past K, TMA's zeros add 0 * 0.
      const int k0 = t.kb + kt * MN_BK;
      const int nch = (t.kend < K ? min(MN_BK, t.kend - k0) : MN_BK) / 4;
      mbar_wait(&full[s], (q / MN_STAGES) & 1);
      const unsigned char* st = ring + s * MN_STAGE_BYTES;
#pragma unroll 2
      for (int ch = 0; ch < nch; ++ch) {  // k = 4 ch + kk
        float a[4][8], b[4][8];                  // [kk][row i], [kk][column j]
        const uint32_t xb = (offb + 512 * ch) ^ ((ch & 1) << 6);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* p = reinterpret_cast<const float4*>(st + ((xb ^ (kk << 4)) + 128 * kk));
          *reinterpret_cast<float4*>(&b[kk][0]) = p[0];
          *reinterpret_cast<float4*>(&b[kk][4]) = p[MN_BOX / 16];  // box 1: columns + 32
        }
        if (AT) {
          const uint32_t xa = (offa + 512 * ch) ^ ((ch & 1) << 6);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4* p = reinterpret_cast<const float4*>(st + ((xa ^ (kk << 4)) + 128 * kk));
            *reinterpret_cast<float4*>(&a[kk][0]) = p[0];
            *reinterpret_cast<float4*>(&a[kk][4]) = p[2 * MN_BOX / 16];  // boxes + 2: rows + 64
          }
        } else {
          const float4* pa = reinterpret_cast<const float4*>(st + (offa ^ (ch << 4)));
#pragma unroll
          for (int i = 0; i < 8; ++i) {  // rows 8 apart: 1024 bytes; .x .. .w are kk = 0 .. 3
            const float4 r = pa[64 * i];
            a[0][i] = r.x; a[1][i] = r.y; a[2][i] = r.z; a[3][i] = r.w;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = (i & 1) ? 7 - jj : jj;  // serpentine: a[i], b[j] reused at the turns
              acc[i][j] = fmaf(a[kk][i], b[kk][j], acc[i][j]);
            }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue in place: row i of the thread, its 4-column groups h = 0, 1.
    float* out = C + (size_t)t.split * M * N;
    float csum[8];  // epilogue_group's own column sums go unused: EPI_GATE's are below
#pragma unroll
    for (int j = 0; j < 8; ++j) csum[j] = 0.0f;
    // EPI_GATE / EPI_RESID: every gate or residual group of the thread read
    // before the first store, so the 16 loads overlap (N % 8 == 0: whole groups).
    float pre[8][8];
    if (MODE == EPI_GATE || MODE == EPI_RESID) {
      const float* src = MODE == EPI_GATE ? static_cast<const float*>(e.gate) : e.resid;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = t.m0 + (AT ? 4 * ga + (i & 3) + 64 * (i >> 2) : r0 + 8 * i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = t.n0 + 4 * cq + 32 * h;
          if (row < M && col < N)
            *reinterpret_cast<float4*>(&pre[i][4 * h]) =
                *reinterpret_cast<const float4*>(src + (size_t)row * N + col);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = t.m0 + (AT ? 4 * ga + (i & 3) + 64 * (i >> 2) : r0 + 8 * i);
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t.n0 + 4 * cq + 32 * h;
        if (col < N)
          epilogue_group<MODE, 4, float, float>(e, row, col, N, &acc[i][4 * h], out, &csum[4 * h],
                                                MODE == EPI_GATE || MODE == EPI_RESID
                                                    ? &pre[i][4 * h] : nullptr);
      }
    }
    if (MODE == EPI_GATE) {
      // The column sums in the order gemm_f32_kernel took them: 16 groups tr
      // of 8 rows, 32 (tr / 4) + 4 (tr % 4) + {0..3, 16..19}, each summed in
      // that order from 0, then the groups in order.  Warp w holds the four
      // groups tr = 4 (2 (w / 2) + a) + w % 2 + 2 b, rows r0 + 8 i at i = 4 a +
      // b (+ 2) of its lanes rq = 0..3: a group's running sum steps from lane
      // rq to rq + 1, each adding its own row (0 past M), and ends in rq 3.
      float p[4][8];  // [group 2 a + b][column j]
#pragma unroll
      for (int hop = 0; hop < 8; ++hop) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int i = 4 * (g >> 1) + (g & 1) + (hop < 4 ? 0 : 2);
          const bool in = t.m0 + r0 + 8 * i < M;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (hop > 0) p[g][j] = __shfl_sync(0xffffffffu, p[g][j], (lane + 24) % 32);
            p[g][j] = (hop > 0 ? p[g][j] : 0.0f) + (in ? acc[i][j] : 0.0f);
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // the last sums are read
      if (rq == 3) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int tr = 4 * (2 * (w / 2) + (g >> 1)) + w % 2 + 2 * (g & 1);
#pragma unroll
          for (int j = 0; j < 8; ++j) sums[tr * MN_BN + 4 * cq + (j & 3) + 32 * (j >> 2)] = p[g][j];
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (tid < MN_BN && t.n0 + tid < N) {
        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < 16; ++r) sum += sums[r * MN_BN + tid];
        e.colpart[(size_t)(t.m0 / MN_BM) * N + t.n0 + tid] = sum;
      }
    }
  }
}

template <int AT, int MODE>
cudaError_t launch_f32_nn_tn(const void* A, const void* B, void* C, int M, int N, int K,
                             int splits, const Epi& e, cudaStream_t s) {
  const long long units = (long long)((M + MN_BM - 1) / MN_BM) * ((N + MN_BN - 1) / MN_BN) * splits;
  if (units == 0) return cudaSuccess;
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  // K rows per split, a multiple of MN_KSTEP; the last split may be short (or empty).
  const int Kc = ((K + splits - 1) / splits + MN_KSTEP - 1) / MN_KSTEP * MN_KSTEP;
  CUtensorMap ta{}, tb{};  // K == 0 loads nothing
  if (K > 0 && (!(AT ? tma_map(&ta, A, true, K, M, MN_BK, MN_BK)
                     : tma_map(&ta, A, true, M, K, MN_BM, MN_BK)) ||
                !tma_map(&tb, B, true, K, N, MN_BK, MN_BK)))
    return cudaErrorInvalidValue;
  // Per launch, as the attribute belongs to the current device.
  err = cudaFuncSetAttribute(gemm_f32_nn_tn_kernel<AT, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MN_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = units < sms ? (int)units : sms;
  gemm_f32_nn_tn_kernel<AT, MODE><<<grid, MN_THREADS, MN_SMEM, s>>>(
      ta, tb, static_cast<float*>(C), M, N, K, Kc, splits, e);
  return cudaGetLastError();
}

// fp32 runs on the CUDA cores ("nt" on its own kernel, "nn" / "tn" on the
// MN-major one); bf16 "nt" (both operands K-major) on the persistent
// gemm_bf16_nt_kernel, "nn" / "tn" (B MN-major) on the persistent
// gemm_bf16_nn_tn_kernel.
template <int AT, int BT, int MODE>
cudaError_t launch(const void* A, const void* B, void* C, int M, int N, int K, int splits,
                   int dtype, int out_f32, const Epi& e, cudaStream_t s) {
  if (dtype == FM_F32) {
    if constexpr (!AT && !BT) return launch_f32_nt(A, B, C, M, N, K, e, s);
    else return launch_f32_nn_tn<AT, MODE>(A, B, C, M, N, K, splits, e, s);  // B MN-major
  }
  if constexpr (!AT && !BT) {
    return out_f32 ? launch_bf16_nt<float>(A, B, C, M, N, K, e, s)
                   : launch_bf16_nt<fm_bf16>(A, B, C, M, N, K, e, s);
  } else {
    return out_f32 ? launch_bf16_nn_tn<float, AT, MODE>(A, B, C, M, N, K, splits, e, s)
                   : launch_bf16_nn_tn<fm_bf16, AT, MODE>(A, B, C, M, N, K, splits, e, s);
  }
}

// ---- deterministic column sums ---------------------------------------------------

// out[n] = sum over m of x[m, n], fp32, in a fixed order: chain r = 0..7
// sums rows r, r + 8, ... of column n in order, starting from +0, and then
// the 8 chain sums are added in chain order, from +0.  Used for the bias /
// LayerNorm grads from per-block partials and for the split-K partials of
// "tn".  A chain started at +0 is never -0 (in round-to-nearest a sum is -0
// only when both terms are), so a +0 added to it changes no bit: rows past
// M may be read as +0.
//
// Bound: bytes (x read once; 20.6 MB for the three [2240, 768] LayerNorm
// planes of the bf16 lab step, 6.2 us at 3.35 TB/s).  The parent ran one
// 32 x 8 block per 32 columns (24 blocks at H 768) whose threads each
// walked their chain one dependent load at a time.  Two layouts of the same
// chains now, picked by M (COLSUM_WIDE_ROWS):
//   - tall (the LayerNorm, bias and flash partials, M in the tens to
//     thousands, N ~ 768-3072): a block of 8 columns x 8 chains (64
//     threads), so H 768 gives 96 blocks a plane.  The block streams tiles
//     of COLSUM_TILE rows x 8 columns (a 32-byte sector a row) through a
//     ring of COLSUM_STAGES tiles in shared memory by 16-byte cp.async, with
//     COLSUM_STAGES - 1 tiles in flight while each chain adds its rows of
//     the tile that has landed, in order; rows past M land as +0.
//   - wide (the split-K partials: M = splits <= 32, N = m * n ~ 0.6-1.8M):
//     a thread takes four neighbouring columns (16 bytes a row; one where N
//     % 4 != 0), holds their 8 chains in registers and loads 8 rows at a
//     time, neighbouring threads on neighbouring columns.
// gridDim.y = planes: plane p sums x + p * M * N into out.p[p] (fp32, or
// bf16 where bit p of out.bf16 is set), so the three LayerNorm partial planes
// of a backward are one launch.
constexpr int COLSUM_COLS = 8;        // columns a tall block
constexpr int COLSUM_CHAINS = 8;      // chains a column: fixes the order
constexpr int COLSUM_TILE = 256;      // rows a tall tile (8 KB)
constexpr int COLSUM_STAGES = 5;      // tiles in a tall block's ring (40 KB)
constexpr int COLSUM_WIDE_ROWS = 32;  // M at or under which the wide layout runs
constexpr int COLSUM_WIDE_THREADS = 256;
constexpr int COLSUM_MAX_PLANES = 3;
constexpr int COLSUM_TALL_THREADS = COLSUM_COLS * COLSUM_CHAINS;

struct ColsumOut {
  void* p0;
  void* p1;
  void* p2;
  int bf16;  // bit p: plane p is written in bf16
};

__device__ __forceinline__ void colsum_store(const ColsumOut& out, int plane, int col, float t) {
  // Picked by value: an index into a parameter array would go through the stack.
  void* o = plane == 0 ? out.p0 : plane == 1 ? out.p1 : out.p2;
  if ((out.bf16 >> plane) & 1)
    static_cast<fm_bf16*>(o)[col] = __float2bfloat16_rn(t);
  else
    static_cast<float*>(o)[col] = t;
}

// cp.async of `bytes` (4 or 16) into shared dst, the first `src_bytes` from
// src and the rest +0.
template <int BYTES>
__device__ __forceinline__ void colsum_cp_async(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

// Tile i of a tall block (rows i * COLSUM_TILE.., columns col0..col0 + 7)
// into dst [COLSUM_TILE][COLSUM_COLS]: 16-byte pieces where N % 4 == 0 and
// x is 16-byte aligned (vec), else 4-byte ones; out-of-range values land +0.
__device__ __forceinline__ void colsum_tile(float* dst, const float* x, int M, int N, int col0,
                                            int i, bool vec) {
  const int m0 = i * COLSUM_TILE;
  if (vec) {
    constexpr int PIECES = COLSUM_COLS / 4;  // 16-byte pieces a tile row
    for (int q = threadIdx.x; q < COLSUM_TILE * PIECES; q += COLSUM_TALL_THREADS) {
      const int row = m0 + q / PIECES, col = col0 + (q % PIECES) * 4;
      const bool in = row < M && col < N;
      colsum_cp_async<16>(dst + q * 4, in ? x + (size_t)row * N + col : x, in ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < COLSUM_TILE * COLSUM_COLS; q += COLSUM_TALL_THREADS) {
      const int row = m0 + q / COLSUM_COLS, col = col0 + q % COLSUM_COLS;
      const bool in = row < M && col < N;
      colsum_cp_async<4>(dst + q, in ? x + (size_t)row * N + col : x, in ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? COLSUM_WIDE_THREADS : COLSUM_TALL_THREADS)
colsum_kernel(const float* __restrict__ x, ColsumOut out, int M, int N) {
  const int plane = blockIdx.y;
  x += (size_t)plane * M * N;
  if constexpr (WIDE) {
    // Four neighbouring columns a thread, 16 bytes a row, where N % 4 == 0
    // and x is 16-byte aligned (the launcher's grid says which); else one.
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int per = vec ? 4 : 1;
    const int col = (blockIdx.x * COLSUM_WIDE_THREADS + threadIdx.x) * per;
    if (col >= N) return;
    float s[COLSUM_CHAINS][4];
#pragma unroll
    for (int r = 0; r < COLSUM_CHAINS; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.0f;
    for (int m0 = 0; m0 < M; m0 += COLSUM_CHAINS) {
      float4 v[COLSUM_CHAINS];
#pragma unroll
      for (int r = 0; r < COLSUM_CHAINS; ++r) {
        const float* p = x + (size_t)(m0 + r) * N + col;
        v[r] = m0 + r >= M ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
               : vec      ? *reinterpret_cast<const float4*>(p)
                          : make_float4(*p, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int r = 0; r < COLSUM_CHAINS; ++r) {
        s[r][0] = __fadd_rn(s[r][0], v[r].x);
        s[r][1] = __fadd_rn(s[r][1], v[r].y);
        s[r][2] = __fadd_rn(s[r][2], v[r].z);
        s[r][3] = __fadd_rn(s[r][3], v[r].w);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= per) break;
      float t = 0.0f;
#pragma unroll
      for (int r = 0; r < COLSUM_CHAINS; ++r) t = __fadd_rn(t, s[r][k]);
      colsum_store(out, plane, col + k, t);
    }
  } else {
    __shared__ __align__(16) float ring[COLSUM_STAGES][COLSUM_TILE * COLSUM_COLS];
    __shared__ float part[COLSUM_CHAINS][COLSUM_COLS + 1];
    const int c = threadIdx.x % COLSUM_COLS;
    const int r = threadIdx.x / COLSUM_COLS;
    const int col0 = blockIdx.x * COLSUM_COLS;
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int tiles = (M + COLSUM_TILE - 1) / COLSUM_TILE;
#pragma unroll
    for (int i = 0; i < COLSUM_STAGES - 1; ++i)
      if (i < tiles) colsum_tile(ring[i], x, M, N, col0, i, vec);
      else asm volatile("cp.async.commit_group;\n" ::);
    float s = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      // Tile i has landed for every thread, and every chain is done with
      // the slot that tile i + STAGES - 1 refills.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(COLSUM_STAGES - 2) : "memory");
      __syncthreads();
      const int next = i + COLSUM_STAGES - 1;
      if (next < tiles) colsum_tile(ring[next % COLSUM_STAGES], x, M, N, col0, next, vec);
      else asm volatile("cp.async.commit_group;\n" ::);
      const float* tile = ring[i % COLSUM_STAGES] + r * COLSUM_COLS + c;
#pragma unroll 8
      for (int k = 0; k < COLSUM_TILE / COLSUM_CHAINS; ++k)
        s = __fadd_rn(s, tile[k * COLSUM_CHAINS * COLSUM_COLS]);
    }
    part[r][c] = s;
    __syncthreads();
    if (r == 0 && col0 + c < N) {
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < COLSUM_CHAINS; ++i) t = __fadd_rn(t, part[i][c]);
      colsum_store(out, plane, col0 + c, t);
    }
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
            int dtype, int out_f32, const void* bias, int act, const unsigned long long* key,
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
  e.drop = fm::Dropout{0ull, key, stream_id, threshold, inv_keep, drop_on};
  e.aux = aux;
  e.gate = gate;
  e.gate_kind = gate_kind;
  e.gate_scale = gate_scale;
  e.resid = static_cast<const float*>(resid);
  e.colpart = static_cast<float*>(colpart);
  // "nt" runs the forward epilogue; "nn" stores, gates or adds a residual;
  // "tn" stores.  Any other combination of operands is refused.
  const int mode = layout == 0 ? EPI_BIAS_ACT : (gate ? EPI_GATE : (resid ? EPI_RESID : EPI_STORE));
  if ((drop_on && !key) || (layout != 0 && (bias || act != ACT_NONE || drop_on)) || (layout == 0 && (gate || resid)) ||
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

// out_p[N] = column sums of plane p of x [planes, M, N] fp32, for p <
// planes (1..3), each written fp32, or bf16 where bit p of bf16_mask is set.
int fm_colsum(const void* x, void* out0, void* out1, void* out2, int M, int N, int planes,
              int bf16_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || planes > COLSUM_MAX_PLANES || M < 0 || N < 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const ColsumOut out{out0, out1, out2, bf16_mask};
  const float* xs = static_cast<const float*>(x);
  if (M <= COLSUM_WIDE_ROWS) {
    const int per = N % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 ? 4 : 1;
    const int cols = (N + per - 1) / per;
    colsum_kernel<true><<<dim3((cols + COLSUM_WIDE_THREADS - 1) / COLSUM_WIDE_THREADS, planes),
                          COLSUM_WIDE_THREADS, 0, s>>>(xs, out, M, N);
  }
  else
    colsum_kernel<false><<<dim3((N + COLSUM_COLS - 1) / COLSUM_COLS, planes),
                           COLSUM_TALL_THREADS, 0, s>>>(xs, out, M, N);
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
