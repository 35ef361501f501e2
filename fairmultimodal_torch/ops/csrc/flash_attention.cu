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
// an SM has 227 KB, so both kernels here tile the keys (64 at a time) with
// an online softmax (running row max and sum, the output rescaled when the
// max grows).  The head dim is padded with zeros to DP, a multiple of 32 (d
// 96 stays 96): the TPU kernel's 96 -> 128 pad was Mosaic's 128-lane rule and
// buys nothing here.
//   - bf16 (any d <= 128): what bounds it is the tensor cores' issue rate,
//     so the design keeps everything between the products in registers
//     (FlashAttention-2 on mma.sync m16n8k16).  A block owns 128 query rows
//     of one (batch, head), 4 warps of 32 rows: two m16 row tiles per warp
//     share every k / v fragment it loads (half the ldmatrix traffic per
//     product) and give it two independent chains of products.  k / v tiles
//     and their key bias come by 16-byte cp.async into a two-stage ring, the
//     next tile's copy running under the current tile's products; q
//     fragments are read (ldmatrix) from the q tile; scores are fp32 C
//     fragments, scaled, biased and soft-maxed in registers with quad
//     shuffles, and become the bf16 A fragments of p.v directly (v read with
//     ldmatrix.trans).  One pass: the products are the TPU kernel's.
//     ROUNDING (the one change of contract): the TPU kernel rounds the
//     NORMALISED p to bf16 before p.v (flash_attention.py:62); this kernel
//     rounds the unnormalised exp(s - m_running), sums the fp32 values, and
//     divides o by that sum once at the end.  The two differ by at most one
//     bf16 rounding of each p, inside the bf16 forward limits that
//     chip_smoke.py phase 3d holds it to (FLASH_BF16_FWD = 2^-6 of max-abs,
//     mean TRAIN_BF16_MEAN = 2^-10); tests/test_torch_flash_forward_contract
//     .py emulates this order on the CPU against the Pallas kernel.
//   - fp32: CUDA cores, one pass with the same online softmax; each thread
//     owns 4 rows x 4 keys of a score tile and 4 rows x DP/16 output
//     columns.  fp32 rounds nothing, so normalising once at the end differs
//     from the TPU kernel only in summation order.
// Each row's max m (of s * scale + bias, natural-log units) and sum l (of
// exp(s * scale + bias - m), fp32) are written to stats [B, heads, S, 2]
// when the backward will need them; it recomputes p from them.
//
// Masking copies the TPU kernels exactly: -1e9 is added to the scaled score,
// so a fully masked row (the pad rows of an encode batch) gets a finite,
// uniform softmax instead of NaN.  Keys past S (the ragged last tile) get
// -inf and weigh exactly zero.
//
// What the bf16 forward still leaves out: wgmma (the operands are strided
// head views whose 192-byte rows at d 96 exceed a 128-byte swizzle atom, so
// TMA boxes would need a split head dim), a warp-specialised producer, and
// a row tiling that fits S 560 (128-row blocks compute 640 rows, 14% of them
// padding); at d 96 it uses all 255 registers and spills 24 bytes.
#include <math.h>
#include <stdint.h>

#include "fm_common.cuh"

namespace {

constexpr int FA_BM = 64;       // query rows per block
constexpr int FA_BN = 64;       // keys per tile
constexpr int FA_THREADS = 256;  // the fp32 forward and backward kernels
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

// ---- bf16 tensor-core kernel (mma.sync m16n8k16, one pass, register-resident) ------

constexpr int FWD_BM = 128;  // query rows per block
constexpr int FWD_WARPS = 4;  // each owns 32 rows: two m16 row tiles sharing every k / v fragment
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct FwdSmem {  // byte offsets of the shared-memory regions
  // bf16 tile pitch: DP + 8 puts the 8 rows an ldmatrix phase reads on 8
  // distinct 16-byte bank groups for every DP in {32, 64, 96, 128}.
  static constexpr int LD = DP + 8;
  static constexpr int KV_TILE = FA_BN * LD * 2;    // one [64][LD] bf16 k or v tile
  static constexpr int Q = 0;                       // the q tile, then the output staging tile
  static constexpr int KV = FWD_BM * LD * 2;        // ring of two stages, each a k and a v tile
  static constexpr int BIAS = KV + 4 * KV_TILE;     // each stage's [64] fp32 key bias
  static constexpr int BYTES = BIAS + 2 * FA_BN * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero fill when !ok (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) x d columns of one head (row stride rs) -> dst[ROWS][DP + 8],
// zero filled past S and past d: 16-byte cp.async copies when ``vec``, else
// element loads and stores (visible after the next barrier either way).
template <int DP, int ROWS, int NT = FWD_THREADS>
__device__ __forceinline__ void load_tile(const fm_bf16* __restrict__ src, long long rs, int r0,
                                          int S, int d, bool vec, fm_bf16* dst) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
      const int row = c / CPR;
      const int col = (c % CPR) * 8;
      const bool ok = r0 + row < S && col < d;
      cp_async16(smem_u32(dst + row * LD + col), ok ? src + (r0 + row) * rs + col : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] = (r0 + row < S && col < d) ? src[(r0 + row) * rs + col]
                                                      : __float2bfloat16_rn(0.0f);
    }
  }
}

// One block: 128 query rows of one (batch, head), 4 warps of 32 rows (two
// m16 row tiles, which share every k / v fragment a warp loads and give it
// two independent chains of products).  Each 64-key tile of k and v, and its
// key bias, arrives by cp.async into a two-stage ring while the previous tile
// is multiplied.  Scores, p and the output live in mma fragments: the m16n8 C
// layout of a score tile is the A layout of p.v, so no score or p touches
// shared memory.  q fragments are read from the q tile each key tile (the
// registers go to the accumulators).
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS, 2)
flash_attn_fwd_mma_kernel(Mat<const fm_bf16> Q, Mat<const fm_bf16> K, Mat<const fm_bf16> V,
                          Mask mask, Mat<fm_bf16> O, float* __restrict__ stats, int S, int nh,
                          int d, float scale) {
  using L = FwdSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int KD = DP / 16;     // k16 steps of q.k^T
  constexpr int ND = DP / 8;      // n8 tiles of the output
  constexpr int NS = FA_BN / 8;   // n8 tiles of a score tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fm_bf16* Qs = reinterpret_cast<fm_bf16*>(smem_raw + L::Q);
  fm_bf16* ring = reinterpret_cast<fm_bf16*>(smem_raw + L::KV);  // stage st: k at 2st, v at 2st+1
  float* kbias = reinterpret_cast<float*>(smem_raw + L::BIAS);   // stage st at st * FA_BN

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row g (and g + 8), columns 2t, 2t + 1
  const int q0 = blockIdx.x * FWD_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const fm_bf16* qb = Q.head(b, h);
  const fm_bf16* kb = K.head(b, h);
  const fm_bf16* vb = V.head(b, h);
  const int* mrow = mask.row(b);
  const bool kv_vec = vec16(kb, K.sr, d) && vec16(vb, V.sr, d);
  auto stage = [&](int st, int which) { return ring + (2 * st + which) * FA_BN * LD; };
  auto load_kv = [&](int k0, int st) {
    load_tile<DP, FA_BN>(kb, K.sr, k0, S, d, kv_vec, stage(st, 0));
    load_tile<DP, FA_BN>(vb, V.sr, k0, S, d, kv_vec, stage(st, 1));
    if (threadIdx.x < FA_BN) kbias[st * FA_BN + threadIdx.x] = key_bias(mrow, k0 + threadIdx.x, S);
  };

  load_tile<DP, FWD_BM>(qb, Q.sr, q0, S, d, vec16(qb, Q.sr, d), Qs);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qaddr[2];  // ldmatrix row address of this lane in each row tile
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
    qaddr[rt] = smem_u32(Qs + (warp * 32 + rt * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                         lane / 16 * 8);
  float o[2][ND][4];
  float m_r[2][2], l_r[2][2];  // per row tile: running max of rows g, g + 8 (natural-log
                               // units) and this thread's share of their running sums
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int j = 0; j < ND; ++j) o[rt][j][0] = o[rt][j][1] = o[rt][j][2] = o[rt][j][3] = 0.0f;
    m_r[rt][0] = m_r[rt][1] = -INFINITY;
    l_r[rt][0] = l_r[rt][1] = 0.0f;
  }

  const int ntiles = (S + FA_BN - 1) / FA_BN;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) load_kv((it + 1) * FA_BN, st ^ 1);  // lands under this tile's products
    cp_async_commit();

    // s = q . k^T: k rows are keys, so a plain ldmatrix gives the B fragments.
    float s[2][NS][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[rt][j][0] = s[rt][j][1] = s[rt][j][2] = s[rt][j][3] = 0.0f;
    const fm_bf16* ks = stage(st, 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[2][4];
      ldsm_x4(qaddr[0] + kk * 32, qa[0]);
      ldsm_x4(qaddr[1] + kk * 32, qa[1]);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(smem_u32(ks + (jp * 16 + lane % 8 + lane / 16 * 8) * LD + kk * 16 +
                         (lane / 8) % 2 * 8),
                bk);
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          mma_bf16(s[rt][2 * jp], qa[rt], bk[0], bk[1]);
          mma_bf16(s[rt][2 * jp + 1], qa[rt], bk[2], bk[3]);
        }
      }
    }

    // Scale and key bias as the TPU kernel adds them, then the online softmax:
    // the quad of lanes sharing a row reduces its max by shuffles.  p = exp(s
    // - m) is summed in fp32 and rounded to bf16 as the A fragments of p.v (C
    // fragment pair 2kk, 2kk + 1 -> A fragment kk).
    const float* kbs = kbias + st * FA_BN;
    uint32_t pf[2][FA_BN / 16][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 kbj = *reinterpret_cast<const float2*>(kbs + j * 8 + 2 * t);
        s[rt][j][0] = s[rt][j][0] * scale + kbj.x;
        s[rt][j][1] = s[rt][j][1] * scale + kbj.y;
        s[rt][j][2] = s[rt][j][2] * scale + kbj.x;
        s[rt][j][3] = s[rt][j][3] * scale + kbj.y;
        mx[0] = fmaxf(mx[0], fmaxf(s[rt][j][0], s[rt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[rt][j][2], s[rt][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[rt][r], mx[r]);  // finite: every tile holds a key < S
        const float alpha = exp2f((m_r[rt][r] - m_new) * LOG2E);  // 0 on the first tile
        m_r[rt][r] = m_new;
        l_r[rt][r] *= alpha;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[rt][j][2 * r] *= alpha;
          o[rt][j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f((s[rt][j][0] - m_r[rt][0]) * LOG2E);
        const float p1 = exp2f((s[rt][j][1] - m_r[rt][0]) * LOG2E);
        const float p2 = exp2f((s[rt][j][2] - m_r[rt][1]) * LOG2E);
        const float p3 = exp2f((s[rt][j][3] - m_r[rt][1]) * LOG2E);
        l_r[rt][0] += p0 + p1;
        l_r[rt][1] += p2 + p3;
        pf[rt][j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pf[rt][j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
    }

    // o += p . v: v rows are keys, so ldmatrix.trans gives the B fragments.
    const fm_bf16* vs = stage(st, 1);
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_u32(vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD + jp * 16 +
                               lane / 16 * 8),
                      bv);
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          mma_bf16(o[rt][2 * jp], pf[rt][kk], bv[0], bv[1]);
          mma_bf16(o[rt][2 * jp + 1], pf[rt][kk], bv[2], bv[3]);
        }
      }

    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one
  }

  // o / l, rounded to bf16 once, staged through this warp's 32 rows of the q
  // tile (read by this warp only) and stored 16 bytes at a time.
  fm_bf16* so = Qs + warp * 32 * LD;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[rt][r] += __shfl_xor_sync(0xffffffffu, l_r[rt][r], 1);
      l_r[rt][r] += __shfl_xor_sync(0xffffffffu, l_r[rt][r], 2);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(so + (rt * 16 + g) * LD + col) =
          __floats2bfloat162_rn(o[rt][j][0] / l_r[rt][0], o[rt][j][1] / l_r[rt][0]);
      *reinterpret_cast<__nv_bfloat162*>(so + (rt * 16 + g + 8) * LD + col) =
          __floats2bfloat162_rn(o[rt][j][2] / l_r[rt][1], o[rt][j][3] / l_r[rt][1]);
    }
  }
  __syncwarp();
  fm_bf16* ob = O.head(b, h);
  const int r0 = q0 + warp * 32;
  if (vec16(ob, O.sr, d)) {
    constexpr int CPR = DP / 8;
    for (int c = lane; c < 32 * CPR; c += 32) {
      const int row = c / CPR, col = (c % CPR) * 8;
      if (r0 + row < S && col < d)
        *reinterpret_cast<uint4*>(ob + (r0 + row) * O.sr + col) =
            *reinterpret_cast<const uint4*>(so + row * LD + col);
    }
  } else {
    for (int i = lane; i < 32 * DP; i += 32) {
      const int row = i / DP, col = i % DP;
      if (r0 + row < S && col < d) ob[(r0 + row) * O.sr + col] = so[row * LD + col];
    }
  }
  if (stats && t == 0) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + rt * 16 + g + 8 * r;
        if (row < S) {
          float* sp = stats + (((size_t)b * nh + h) * S + row) * 2;
          sp[0] = m_r[rt][r];
          sp[1] = l_r[rt][r];
        }
      }
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
cudaError_t launch_mma_dp(const FwdArgs& a, cudaStream_t stream) {
  constexpr int bytes = FwdSmem<DP>::BYTES;
  // Set on every launch: the attribute belongs to the current device, and
  // the call costs about a microsecond.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_mma_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + FWD_BM - 1) / FWD_BM, a.nh, a.B);
  flash_attn_fwd_mma_kernel<DP><<<grid, FWD_THREADS, bytes, stream>>>(
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
    case 32: return bf16 ? launch_mma_dp<32>(a, s) : launch_f32_dp<32>(a, s);
    case 64: return bf16 ? launch_mma_dp<64>(a, s) : launch_f32_dp<64>(a, s);
    case 96: return bf16 ? launch_mma_dp<96>(a, s) : launch_f32_dp<96>(a, s);
    case 128: return bf16 ? launch_mma_dp<128>(a, s) : launch_f32_dp<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- backward -------------------------------------------------------------------
//
// Replaces fairmultimodal_tpu/ops/flash_attention.py::_bwd_kernel (#10) and
// the attention core of fused_attention_block.py::_mega_ln_bwd_kernel
// (lines 717-744) / _mega_bwd_kernel.  The TPU kernels hold the whole
// [S, S] tile of one (batch, head) in VMEM and recompute P from the stored
// q and k.  Here two kernels tile it, each recomputing p from the row max m
// and sum l the forward stored, and neither uses atomics:
//   - flash_bwd_dq: one block per query tile; it first writes D_i =
//     rowsum(dO * O) for its rows, then walks the key tiles:
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
// [B * ceil(S / tile), 3 * heads * d] for fm_colsum; #10 passes null.  dQ
// keeps its own pass: per-key-tile partials of dQ would move 2-4 GB at the
// lab shape, and float atomics would make the sums differ run to run.
//
// Bound at the lab shape: 10*B*S^2*H = 6.2e11 FLOP of the TPU kernel's
// products (0.62 ms at the bf16 peak); this design executes 1.4x them (the
// dQ kernel recomputes S and dP: seven [S, S, d] products, 8.6e11 FLOP).
//
// bf16 design (FlashAttention-2 on mma.sync m16n8k16; what bounds it is the
// tensor cores' issue rate, so everything between the products stays in
// registers).  A block owns BWD_TILE = 64 rows (4 warps x 16) and walks
// the other operand in 64-row tiles.  Why 64 at S 560 (= 7 x 80 = 8 x 64 +
// 48): 80-row blocks of 5 warps would leave no owned row as padding, but five
// warps cannot be spread evenly over the SM's four schedulers, so two blocks
// per SM cap a thread at 168 registers, and the dK / dV kernel, whose warp
// holds dK and dV (2 x 16 x d fp32, 96 registers at d 96) beside its S and
// dP tiles (64 registers), spilled 360 bytes at d 96.  With 4 warps two blocks
// per SM leave 255 registers and nothing spills; in one compare_kernels.py
// call on the H100, 64-row tiles took 5.01 ms at the lab shape against 5.22
// and 5.33 for 80-row ones (3% padding rows included), and 0.73 against 0.78
// and 0.76 at the text shape (S 512 = 8 x 64).  A warp owning 32 rows (two
// m16 row tiles sharing each B fragment, as the forward does) would need
// twice the accumulators, more than 255 registers.  The walked tiles and
// their per-row vectors come by 16-byte cp.async into a two-stage ring
// (pitch d + 8, so ldmatrix's 8 rows fall on 8 bank groups), the next
// tile's copy running under this tile's products; the owned tiles stay in
// shared memory and are read by ldmatrix.  The C layout
// of an m16n8 product is the A layout of the next one, so S -> P and dP ->
// dS never leave registers (no fp32 score or dP tile in shared memory); the
// walked rows are the depth of dQ += dS . K, dV += P^T . dO and
// dK += dS^T . Q, so their B fragments come by ldmatrix.trans.  p is the
// forward's expression, exp2((s * scale + bias - m) * log2 e), times 1 / l:
// the forward's unnormalised p of each element divided by its row sum.
// The column partials are added over the 16 rows of a warp by shuffles and
// over the 4 warps in warp order through shared memory: fixed order, the
// same bits every run.
//
// fp32 runs the same two-kernel structure on CUDA cores (32-row tiles,
// FMA loops, its accumulators and the score / dP tiles in shared memory,
// p = exp(s * scale + bias - m) / l as the fp32 forward's expf); it serves
// the card-vs-CPU checks.

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

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

// ---- bf16 backward kernels (mma.sync m16n8k16) ---------------------------------------

// _build.FLASH_BWD_TILE repeats BWD_TILE and F32_TL (the column partials' rows).
constexpr int BWD_TILE = 64;                 // rows a block owns (4 warps x 16)
constexpr int BWD_WARPS = BWD_TILE / 16;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int BWD_WALK = 64;                 // rows of each walked tile

template <int DP>
struct BwdSmem {  // byte offsets of the shared-memory regions
  static constexpr int LD = DP + 8;                               // bf16 tile pitch
  static constexpr int OWN = 0;                                   // two owned [64][LD] tiles
  static constexpr int RING = OWN + 2 * BWD_TILE * LD * 2;        // 2 stages x 2 walked [64][LD]
  static constexpr int VEC = RING + 4 * BWD_WALK * LD * 2;        // 2 stages x [3][64] fp32
  static constexpr int CSUM = VEC + 2 * 3 * BWD_WALK * 4;         // [4][DP] fp32 column sums
  static constexpr int BYTES = CSUM + BWD_WARPS * DP * 4;
};

// Launch bounds: two blocks per SM where the shared memory allows it (d <= 96).
template <int DP>
constexpr int bwd_min_blocks() { return DP <= 96 ? 2 : 1; }

// The four A-fragment registers of rows row0 .. row0 + 15 of a [rows][LD]
// bf16 tile at depth 16 kk are ldmatrix'd from this lane's address + 32 kk.
template <int LD>
__device__ __forceinline__ uint32_t a_frag_addr(const fm_bf16* tile, int row0, int lane) {
  return smem_u32(tile + (row0 + lane % 8 + (lane / 8) % 2 * 8) * LD + lane / 16 * 8);
}
// B fragments of n8 tiles 2 jp, 2 jp + 1 at depth 16 kk from a tile whose
// rows are the n dim (plain ldmatrix) ...
template <int LD>
__device__ __forceinline__ void b_frag_rows(const fm_bf16* tile, int jp, int kk, int lane,
                                            uint32_t (&r)[4]) {
  ldsm_x4(smem_u32(tile + (jp * 16 + lane % 8 + lane / 16 * 8) * LD + kk * 16 + (lane / 8) % 2 * 8),
          r);
}
// ... and from a tile whose rows are the depth (ldmatrix.trans).
template <int LD>
__device__ __forceinline__ void b_frag_trans(const fm_bf16* tile, int jp, int kk, int lane,
                                             uint32_t (&r)[4]) {
  ldsm_x4_trans(
      smem_u32(tile + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD + jp * 16 + lane / 16 * 8), r);
}

// Column sums of one warp's fp32 [16 x DP] accumulator over its 16 rows
// (shuffles over the 8 row groups, a fixed order) into csum[warp][DP].
template <int ND>
__device__ __forceinline__ void warp_col_sums(const float (&acc)[ND][4], int warp, int lane,
                                              float* csum) {
  constexpr int DP = ND * 8;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    float c0 = acc[j][0] + acc[j][2], c1 = acc[j][1] + acc[j][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (lane < 4) {
      csum[warp * DP + j * 8 + 2 * lane] = c0;
      csum[warp * DP + j * 8 + 2 * lane + 1] = c1;
    }
  }
}

// After a barrier: dst[c] = the warps' column sums added in warp order.
template <int DP>
__device__ __forceinline__ void block_col_sums(const float* csum, int d, float* dst) {
  for (int c = threadIdx.x; c < d; c += BWD_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) s += csum[w * DP + c];
    dst[c] = s;
  }
}

// A warp's fp32 [16 x DP] accumulator rounded to bf16 into rows row0 .. +15
// of the [rows][LD] tile ``stage`` (rows this warp alone reads), then stored
// to rows r0 .. r0 + 15 of the head (row stride rs), 16 bytes at a time when
// the layout allows it.
template <int DP>
__device__ __forceinline__ void store_warp_rows(const float (&acc)[DP / 8][4], fm_bf16* stage,
                                                fm_bf16* dst, long long rs, int r0, int S, int d,
                                                int lane) {
  constexpr int LD = DP + 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + j * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  if (vec16(dst, rs, d)) {
    constexpr int CPR = DP / 8;
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int row = c / CPR, col = (c % CPR) * 8;
      if (r0 + row < S && col < d)
        *reinterpret_cast<uint4*>(dst + (r0 + row) * rs + col) =
            *reinterpret_cast<const uint4*>(stage + row * LD + col);
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int row = i / DP, col = i % DP;
      if (r0 + row < S && col < d) dst[(r0 + row) * rs + col] = stage[row * LD + col];
    }
  }
}

// dQ of 64 query rows of one (batch, head), and D of those rows.
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, bwd_min_blocks<DP>())
flash_bwd_dq_mma_kernel(Mat<const fm_bf16> Q, Mat<const fm_bf16> K, Mat<const fm_bf16> V,
                        Mat<const fm_bf16> O, Mat<const fm_bf16> dO, Mask mask,
                        const float* __restrict__ stats, float* __restrict__ Dg,
                        Mat<fm_bf16> dQg, float* __restrict__ colpart, int S, int nh, int d,
                        float scale) {
  using L = BwdSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int KD = DP / 16;       // k16 steps of the S and dP products
  constexpr int ND = DP / 8;        // n8 tiles of dQ
  constexpr int NS = BWD_WALK / 8;  // n8 tiles of S and dP
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fm_bf16* Qs = reinterpret_cast<fm_bf16*>(smem_raw + L::OWN);
  fm_bf16* dOs = Qs + BWD_TILE * LD;
  fm_bf16* ring = reinterpret_cast<fm_bf16*>(smem_raw + L::RING);  // stage st: k, v at 2st, 2st+1
  float* kbias = reinterpret_cast<float*>(smem_raw + L::VEC);      // stage st at st * 3 * 64
  float* csum = reinterpret_cast<float*>(smem_raw + L::CSUM);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment rows g, g + 8; columns 2t, 2t + 1
  const int q0 = blockIdx.x * BWD_TILE;
  const int r0 = q0 + warp * 16;         // this warp's first row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const fm_bf16* qb = Q.head(b, h);
  const fm_bf16* kb = K.head(b, h);
  const fm_bf16* vb = V.head(b, h);
  const fm_bf16* ob = O.head(b, h);
  const fm_bf16* gb = dO.head(b, h);
  const int* mrow = mask.row(b);
  const size_t srow = ((size_t)b * nh + h) * S;  // row offset into stats / D
  const bool kv_vec = vec16(kb, K.sr, d) && vec16(vb, V.sr, d);
  auto stage = [&](int st, int which) { return ring + (2 * st + which) * BWD_WALK * LD; };
  auto load_kv = [&](int k0, int st) {
    load_tile<DP, BWD_WALK, BWD_THREADS>(kb, K.sr, k0, S, d, kv_vec, stage(st, 0));
    load_tile<DP, BWD_WALK, BWD_THREADS>(vb, V.sr, k0, S, d, kv_vec, stage(st, 1));
  };

  load_tile<DP, BWD_TILE, BWD_THREADS>(qb, Q.sr, q0, S, d, vec16(qb, Q.sr, d), Qs);
  load_tile<DP, BWD_TILE, BWD_THREADS>(gb, dO.sr, q0, S, d, vec16(gb, dO.sr, d), dOs);
  load_kv(0, 0);
  cp_async_commit();
  if (threadIdx.x < BWD_WALK) kbias[threadIdx.x] = key_bias(mrow, threadIdx.x, S);
  // m and 1 / l of rows g, g + 8 (0 past S: then p = 0).
  float m_r[2], il_r[2], D_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    m_r[r] = row < S ? stats[(srow + row) * 2] : 0.0f;
    il_r[r] = row < S ? 1.0f / stats[(srow + row) * 2 + 1] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // D = rowsum(dO * O): lane l sums row l / 2 of the warp's 16 over every
  // other 8 (or 1) columns; the pair is added, then each lane takes the D of
  // its fragment rows.
  {
    const int lr = lane / 2, row = r0 + lr;
    float s = 0.0f;
    if (row < S) {
      const fm_bf16* orow = ob + row * O.sr;
      const fm_bf16* grow = dOs + (warp * 16 + lr) * LD;
      if (vec16(ob, O.sr, d)) {
        for (int c = (lane % 2) * 8; c < d; c += 16) {
          const uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 gu = *reinterpret_cast<const uint4*>(grow + c);
          const fm_bf16* o8 = reinterpret_cast<const fm_bf16*>(&ou);
          const fm_bf16* g8 = reinterpret_cast<const fm_bf16*>(&gu);
#pragma unroll
          for (int k = 0; k < 8; ++k) s += __bfloat162float(g8[k]) * __bfloat162float(o8[k]);
        }
      } else {
        for (int c = lane % 2; c < d; c += 2)
          s += __bfloat162float(grow[c]) * __bfloat162float(orow[c]);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (lane % 2 == 0 && row < S) Dg[srow + row] = s;
    D_r[0] = __shfl_sync(0xffffffffu, s, 2 * g);
    D_r[1] = __shfl_sync(0xffffffffu, s, 2 * (g + 8));
  }

  const uint32_t qaddr = a_frag_addr<LD>(Qs, warp * 16, lane);
  const uint32_t gaddr = a_frag_addr<LD>(dOs, warp * 16, lane);
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;

  const int ntiles = (S + BWD_WALK - 1) / BWD_WALK;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const bool next = it + 1 < ntiles;
    float nbias = 0.0f;  // the next tile's key bias, stored after this tile's products
    if (next) {
      load_kv((it + 1) * BWD_WALK, st ^ 1);
      if (threadIdx.x < BWD_WALK) nbias = key_bias(mrow, (it + 1) * BWD_WALK + threadIdx.x, S);
    }
    cp_async_commit();

    // s = q . k^T and dp = dO . v^T: k and v rows are keys (the n dim).
    const fm_bf16* ks = stage(st, 0);
    const fm_bf16* vs = stage(st, 1);
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qaddr + kk * 32, qa);
      ldsm_x4(gaddr + kk * 32, ga);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4], bv[4];
        b_frag_rows<LD>(ks, jp, kk, lane, bk);
        b_frag_rows<LD>(vs, jp, kk, lane, bv);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], ga, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], ga, bv[2], bv[3]);
      }
    }

    // p = exp2((s * scale + bias - m) * log2 e) / l, ds = p * (dp - D);
    // round(ds * scale) as the A fragments of ds . k.
    const float* kbs = kbias + st * 3 * BWD_WALK;
    uint32_t dsf[BWD_WALK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 kbj = *reinterpret_cast<const float2*>(kbs + j * 8 + 2 * t);
      const float p0 = exp2f((s[j][0] * scale + kbj.x - m_r[0]) * LOG2E) * il_r[0];
      const float p1 = exp2f((s[j][1] * scale + kbj.y - m_r[0]) * LOG2E) * il_r[0];
      const float p2 = exp2f((s[j][2] * scale + kbj.x - m_r[1]) * LOG2E) * il_r[1];
      const float p3 = exp2f((s[j][3] * scale + kbj.y - m_r[1]) * LOG2E) * il_r[1];
      dsf[j / 2][(j % 2) * 2] =
          pack_bf16(p0 * (dp[j][0] - D_r[0]) * scale, p1 * (dp[j][1] - D_r[0]) * scale);
      dsf[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dp[j][2] - D_r[1]) * scale, p3 * (dp[j][3] - D_r[1]) * scale);
    }

    // dq += ds . k: k rows are the depth, so ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BWD_WALK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        uint32_t bk[4];
        b_frag_trans<LD>(ks, jp, kk, lane, bk);
        mma_bf16(dq[2 * jp], dsf[kk], bk[0], bk[1]);
        mma_bf16(dq[2 * jp + 1], dsf[kk], bk[2], bk[3]);
      }

    if (next && threadIdx.x < BWD_WALK) kbias[(st ^ 1) * 3 * BWD_WALK + threadIdx.x] = nbias;
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one
  }

  const long long cps = 3LL * nh * d;  // colpart row: dq | dk | dv, head h at h*d
  if (colpart) warp_col_sums<ND>(dq, warp, lane, csum);
  store_warp_rows<DP>(dq, Qs + warp * 16 * LD, dQg.head(b, h), dQg.sr, r0, S, d, lane);
  if (colpart) {
    __syncthreads();
    block_col_sums<DP>(csum, d,
                       colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d);
  }
}

// dK and dV of 64 key rows of one (batch, head), after flash_bwd_dq_mma_kernel.
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, bwd_min_blocks<DP>())
flash_bwd_dkdv_mma_kernel(Mat<const fm_bf16> Q, Mat<const fm_bf16> K, Mat<const fm_bf16> V,
                          Mat<const fm_bf16> dO, Mask mask, const float* __restrict__ stats,
                          const float* __restrict__ Dg, Mat<fm_bf16> dKg, Mat<fm_bf16> dVg,
                          float* __restrict__ colpart, int S, int nh, int d, float scale) {
  using L = BwdSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int NS = BWD_WALK / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fm_bf16* Ks = reinterpret_cast<fm_bf16*>(smem_raw + L::OWN);
  fm_bf16* Vs = Ks + BWD_TILE * LD;
  fm_bf16* ring = reinterpret_cast<fm_bf16*>(smem_raw + L::RING);  // stage st: q, dO at 2st, 2st+1
  float* vecs = reinterpret_cast<float*>(smem_raw + L::VEC);  // stage st: m, 1 / l, D of 64 rows
  float* csum = reinterpret_cast<float*>(smem_raw + L::CSUM);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BWD_TILE;
  const int r0 = k0 + warp * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const fm_bf16* qb = Q.head(b, h);
  const fm_bf16* gb = dO.head(b, h);
  const int* mrow = mask.row(b);
  const size_t srow = ((size_t)b * nh + h) * S;
  const bool qg_vec = vec16(qb, Q.sr, d) && vec16(gb, dO.sr, d);
  auto stage = [&](int st, int which) { return ring + (2 * st + which) * BWD_WALK * LD; };
  auto load_qg = [&](int q0, int st) {
    load_tile<DP, BWD_WALK, BWD_THREADS>(qb, Q.sr, q0, S, d, qg_vec, stage(st, 0));
    load_tile<DP, BWD_WALK, BWD_THREADS>(gb, dO.sr, q0, S, d, qg_vec, stage(st, 1));
  };
  // m, 1 / l and D of query row q (0, 0, 0 past S: then p = 0 and ds = 0).
  auto row_vec = [&](int q, float& m, float& il, float& D) {
    const bool ok = q < S;
    m = ok ? stats[(srow + q) * 2] : 0.0f;
    il = ok ? 1.0f / stats[(srow + q) * 2 + 1] : 0.0f;
    D = ok ? Dg[srow + q] : 0.0f;
  };
  auto put_vec = [&](int st, float m, float il, float D) {
    float* v = vecs + st * 3 * BWD_WALK;
    v[threadIdx.x] = m;
    v[BWD_WALK + threadIdx.x] = il;
    v[2 * BWD_WALK + threadIdx.x] = D;
  };

  const fm_bf16* kbh = K.head(b, h);
  const fm_bf16* vbh = V.head(b, h);
  load_tile<DP, BWD_TILE, BWD_THREADS>(kbh, K.sr, k0, S, d, vec16(kbh, K.sr, d), Ks);
  load_tile<DP, BWD_TILE, BWD_THREADS>(vbh, V.sr, k0, S, d, vec16(vbh, V.sr, d), Vs);
  load_qg(0, 0);
  cp_async_commit();
  if (threadIdx.x < BWD_WALK) {
    float m, il, D;
    row_vec(threadIdx.x, m, il, D);
    put_vec(0, m, il, D);
  }
  const float kb_r[2] = {key_bias(mrow, r0 + g, S), key_bias(mrow, r0 + g + 8, S)};
  cp_async_wait_all();
  __syncthreads();

  const uint32_t kaddr = a_frag_addr<LD>(Ks, warp * 16, lane);
  const uint32_t vaddr = a_frag_addr<LD>(Vs, warp * 16, lane);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
  }

  const int ntiles = (S + BWD_WALK - 1) / BWD_WALK;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const bool next = it + 1 < ntiles;
    float nm = 0.0f, nil = 0.0f, nD = 0.0f;  // the next tile's row vectors, stored after the products
    if (next) {
      load_qg((it + 1) * BWD_WALK, st ^ 1);
      if (threadIdx.x < BWD_WALK) row_vec((it + 1) * BWD_WALK + threadIdx.x, nm, nil, nD);
    }
    cp_async_commit();

    // s^T = k . q^T and dp^T = v . dO^T: rows are keys, columns queries.
    const fm_bf16* qs = stage(st, 0);
    const fm_bf16* gs = stage(st, 1);
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(kaddr + kk * 32, ka);
      ldsm_x4(vaddr + kk * 32, va);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bq[4], bg[4];
        b_frag_rows<LD>(qs, jp, kk, lane, bq);
        b_frag_rows<LD>(gs, jp, kk, lane, bg);
        mma_bf16(s[2 * jp], ka, bq[0], bq[1]);
        mma_bf16(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * jp], va, bg[0], bg[1]);
        mma_bf16(dp[2 * jp + 1], va, bg[2], bg[3]);
      }
    }

    // p^T and ds^T: the query's m, 1 / l and D from the stage's vectors, the
    // key's bias from registers; round(p) and round(ds * scale) as A fragments.
    const float* vm = vecs + st * 3 * BWD_WALK;
    uint32_t pf[BWD_WALK / 16][4], dsf[BWD_WALK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 m2 = *reinterpret_cast<const float2*>(vm + c);
      const float2 l2 = *reinterpret_cast<const float2*>(vm + BWD_WALK + c);
      const float2 D2 = *reinterpret_cast<const float2*>(vm + 2 * BWD_WALK + c);
      const float p0 = exp2f((s[j][0] * scale + kb_r[0] - m2.x) * LOG2E) * l2.x;
      const float p1 = exp2f((s[j][1] * scale + kb_r[0] - m2.y) * LOG2E) * l2.y;
      const float p2 = exp2f((s[j][2] * scale + kb_r[1] - m2.x) * LOG2E) * l2.x;
      const float p3 = exp2f((s[j][3] * scale + kb_r[1] - m2.y) * LOG2E) * l2.y;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      dsf[j / 2][(j % 2) * 2] =
          pack_bf16(p0 * (dp[j][0] - D2.x) * scale, p1 * (dp[j][1] - D2.y) * scale);
      dsf[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(p2 * (dp[j][2] - D2.x) * scale, p3 * (dp[j][3] - D2.y) * scale);
    }

    // dv += p^T . dO and dk += ds^T . q: the walked rows are the depth.
#pragma unroll
    for (int kk = 0; kk < BWD_WALK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        uint32_t bg[4], bq[4];
        b_frag_trans<LD>(gs, jp, kk, lane, bg);
        mma_bf16(dv[2 * jp], pf[kk], bg[0], bg[1]);
        mma_bf16(dv[2 * jp + 1], pf[kk], bg[2], bg[3]);
        b_frag_trans<LD>(qs, jp, kk, lane, bq);
        mma_bf16(dk[2 * jp], dsf[kk], bq[0], bq[1]);
        mma_bf16(dk[2 * jp + 1], dsf[kk], bq[2], bq[3]);
      }

    if (next && threadIdx.x < BWD_WALK) put_vec(st ^ 1, nm, nil, nD);
    cp_async_wait_all();
    __syncthreads();
  }

  const long long cps = 3LL * nh * d;
  const long long H = (long long)nh * d;
  float* cp = colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d
                      : nullptr;
  if (cp) warp_col_sums<ND>(dk, warp, lane, csum);
  store_warp_rows<DP>(dk, Ks + warp * 16 * LD, dKg.head(b, h), dKg.sr, r0, S, d, lane);
  if (cp) {
    __syncthreads();
    block_col_sums<DP>(csum, d, cp + H);
    __syncthreads();
    warp_col_sums<ND>(dv, warp, lane, csum);
  }
  store_warp_rows<DP>(dv, Vs + warp * 16 * LD, dVg.head(b, h), dVg.sr, r0, S, d, lane);
  if (cp) {
    __syncthreads();
    block_col_sums<DP>(csum, d, cp + 2 * H);
  }
}

// ---- fp32 backward kernels (CUDA cores) ---------------------------------------------

constexpr int F32_TL = 32;  // rows of an fp32 backward tile

// TL rows x d columns of one head (row stride rs) -> dst[TL][LD], zero padded.
template <int DP, int TL>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, long long rs, int r0,
                                          int S, int d, float* dst) {
  constexpr int LD = DP + 4;
  if (vec16(src, rs, d)) {
    constexpr int CPR = DP / 4;
    for (int c = threadIdx.x; c < TL * CPR; c += FA_THREADS) {
      const int row = c / CPR;
      const int col = (c % CPR) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + row < S && col < d)
        v = *reinterpret_cast<const float4*>(src + (r0 + row) * rs + col);
      *reinterpret_cast<float4*>(dst + row * LD + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < TL * DP; i += FA_THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] = (r0 + row < S && col < d) ? src[(r0 + row) * rs + col] : 0.0f;
    }
  }
}

// C[M][N] (pitch ldc) = (acc ? C : 0) + op(A) . op(B) over depth K.
// A element (i, k) is A[i*sa + k], or A[k*sa + i] when AT; B element (k, j)
// is B[k*sb + j], or B[j*sb + k] when BT.
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

template <int DP>
struct BwdF32Smem {  // byte offsets of the shared-memory regions
  static constexpr int TL = F32_TL;
  static constexpr int LD = DP + 4;  // io tiles [TL][LD]
  static constexpr int LP = TL + 4;  // p / dS tiles [TL][LP]
  static constexpr int LS = TL + 4;  // score tiles [TL][LS]
  static constexpr int T0 = 0;       // four io tiles
  static constexpr int ACC = T0 + 4 * round128(TL * LD * 4);   // two gradient accumulators [TL][LD]
  static constexpr int S32 = ACC + 2 * round128(TL * LD * 4);
  static constexpr int DP32 = S32 + round128(TL * LS * 4);
  static constexpr int PIO = DP32 + round128(TL * LS * 4);
  static constexpr int DSIO = PIO + round128(TL * LP * 4);
  static constexpr int VEC = DSIO + round128(TL * LP * 4);      // 4 x [TL] fp32
  static constexpr int BYTES = VEC + round128(4 * TL * 4);
};

__device__ __forceinline__ void load_key_bias(const int* mrow, int k0, int S, int TL,
                                              float* kbias) {
  for (int i = threadIdx.x; i < TL; i += FA_THREADS) kbias[i] = key_bias(mrow, k0 + i, S);
}

// Write rows [r0, r0 + TL) of an fp32 accumulator tile to dst (row stride
// rs) and, when colpart is not null, the column sums of its valid rows to
// colpart.
template <int TL>
__device__ __forceinline__ void write_grad(const float* acc, int la, float* dst, long long rs,
                                           int r0, int S, int d, float* colpart) {
  for (int e = threadIdx.x; e < TL * d; e += FA_THREADS) {
    const int i = e / d, c = e % d;
    if (r0 + i < S) dst[(r0 + i) * rs + c] = acc[i * la + c];
  }
  if (!colpart) return;
  for (int c = threadIdx.x; c < d; c += FA_THREADS) {
    float s = 0.0f;
    for (int i = 0; i < TL && r0 + i < S; ++i) s += acc[i * la + c];
    colpart[c] = s;
  }
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_f32_kernel(Mat<const float> Q, Mat<const float> K, Mat<const float> V,
                        Mat<const float> O, Mat<const float> dO, Mask mask,
                        const float* __restrict__ stats, float* __restrict__ Dg, Mat<float> dQg,
                        float* __restrict__ colpart, int S, int nh, int d, float scale) {
  using L = BwdF32Smem<DP>;
  constexpr int TL = L::TL;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + L::T0);
  float* dOs = Qs + TL * L::LD;
  float* Ks = dOs + TL * L::LD;
  float* Vs = Ks + TL * L::LD;
  float* dQ = reinterpret_cast<float*>(smem_raw + L::ACC);
  float* S32 = reinterpret_cast<float*>(smem_raw + L::S32);
  float* dP32 = reinterpret_cast<float*>(smem_raw + L::DP32);
  float* dS = reinterpret_cast<float*>(smem_raw + L::DSIO);
  float* m_s = reinterpret_cast<float*>(smem_raw + L::VEC);
  float* l_s = m_s + TL;
  float* D_s = l_s + TL;
  float* kbias = D_s + TL;

  const int q0 = blockIdx.x * TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* ob = O.head(b, h);
  const float* gb = dO.head(b, h);
  const int* mrow = mask.row(b);
  const size_t srow = ((size_t)b * nh + h) * S;  // row offset into stats / D

  load_rows<DP, TL>(Q.head(b, h), Q.sr, q0, S, d, Qs);
  load_rows<DP, TL>(gb, dO.sr, q0, S, d, dOs);
  load_row_stats(stats + srow * 2, nullptr, q0, S, TL, m_s, l_s, D_s);
  // D_i = rowsum(dO * O), one warp per row.
  for (int i = threadIdx.x / 32; i < TL; i += FA_THREADS / 32) {
    float s = 0.0f;
    if (q0 + i < S)
      for (int c = threadIdx.x % 32; c < d; c += 32) s += gb[(q0 + i) * dO.sr + c] * ob[(q0 + i) * O.sr + c];
    s = fm::warp_sum(s);
    if (threadIdx.x % 32 == 0) {
      D_s[i] = s;
      if (q0 + i < S) Dg[srow + q0 + i] = s;
    }
  }
  for (int e = threadIdx.x; e < TL * L::LD; e += FA_THREADS) dQ[e] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += TL) {
    __syncthreads();  // previous tile fully consumed; D_s, Qs, dOs ready
    load_rows<DP, TL>(K.head(b, h), K.sr, k0, S, d, Ks);
    load_rows<DP, TL>(V.head(b, h), V.sr, k0, S, d, Vs);
    load_key_bias(mrow, k0, S, TL, kbias);
    __syncthreads();
    tile_mm<TL, TL, false, true>(Qs, L::LD, Ks, L::LD, DP, S32, L::LS, false);
    tile_mm<TL, TL, false, true>(dOs, L::LD, Vs, L::LD, DP, dP32, L::LS, false);
    __syncthreads();
    for (int e = threadIdx.x; e < TL * TL; e += FA_THREADS) {
      const int i = e / TL, j = e % TL;
      const float p = expf(S32[i * L::LS + j] * scale + kbias[j] - m_s[i]) / l_s[i];
      dS[i * L::LP + j] = p * (dP32[i * L::LS + j] - D_s[i]) * scale;
    }
    __syncthreads();
    tile_mm<TL, DP, false, false>(dS, L::LP, Ks, L::LD, TL, dQ, L::LD, true);
  }
  __syncthreads();
  const long long cps = 3LL * nh * d;  // colpart row: dq | dk | dv, head h at h*d
  write_grad<TL>(dQ, L::LD, dQg.head(b, h), dQg.sr, q0, S, d,
                 colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d
                         : nullptr);
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkdv_f32_kernel(Mat<const float> Q, Mat<const float> K, Mat<const float> V,
                          Mat<const float> dO, Mask mask, const float* __restrict__ stats,
                          const float* __restrict__ Dg, Mat<float> dKg, Mat<float> dVg,
                          float* __restrict__ colpart, int S, int nh, int d, float scale) {
  using L = BwdF32Smem<DP>;
  constexpr int TL = L::TL;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw + L::T0);
  float* Vs = Ks + TL * L::LD;
  float* Qs = Vs + TL * L::LD;
  float* dOs = Qs + TL * L::LD;
  float* dK = reinterpret_cast<float*>(smem_raw + L::ACC);
  float* dV = dK + TL * L::LD;
  float* S32 = reinterpret_cast<float*>(smem_raw + L::S32);
  float* dP32 = reinterpret_cast<float*>(smem_raw + L::DP32);
  float* P = reinterpret_cast<float*>(smem_raw + L::PIO);
  float* dS = reinterpret_cast<float*>(smem_raw + L::DSIO);
  float* m_s = reinterpret_cast<float*>(smem_raw + L::VEC);
  float* l_s = m_s + TL;
  float* D_s = l_s + TL;
  float* kbias = D_s + TL;

  const int k0 = blockIdx.x * TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t srow = ((size_t)b * nh + h) * S;

  load_rows<DP, TL>(K.head(b, h), K.sr, k0, S, d, Ks);
  load_rows<DP, TL>(V.head(b, h), V.sr, k0, S, d, Vs);
  load_key_bias(mask.row(b), k0, S, TL, kbias);
  for (int e = threadIdx.x; e < 2 * TL * L::LD; e += FA_THREADS) dK[e] = 0.0f;

  for (int q0 = 0; q0 < S; q0 += TL) {
    __syncthreads();  // previous tile fully consumed
    load_rows<DP, TL>(Q.head(b, h), Q.sr, q0, S, d, Qs);
    load_rows<DP, TL>(dO.head(b, h), dO.sr, q0, S, d, dOs);
    load_row_stats(stats + srow * 2, Dg + srow, q0, S, TL, m_s, l_s, D_s);
    __syncthreads();
    tile_mm<TL, TL, false, true>(Qs, L::LD, Ks, L::LD, DP, S32, L::LS, false);
    tile_mm<TL, TL, false, true>(dOs, L::LD, Vs, L::LD, DP, dP32, L::LS, false);
    __syncthreads();
    for (int e = threadIdx.x; e < TL * TL; e += FA_THREADS) {
      const int i = e / TL, j = e % TL;  // query i, key j
      const float p = expf(S32[i * L::LS + j] * scale + kbias[j] - m_s[i]) / l_s[i];
      P[i * L::LP + j] = p;
      dS[i * L::LP + j] = p * (dP32[i * L::LS + j] - D_s[i]) * scale;
    }
    __syncthreads();
    tile_mm<TL, DP, true, false>(P, L::LP, dOs, L::LD, TL, dV, L::LD, true);
    tile_mm<TL, DP, true, false>(dS, L::LP, Qs, L::LD, TL, dK, L::LD, true);
  }
  __syncthreads();
  const long long cps = 3LL * nh * d;
  const long long H = (long long)nh * d;
  float* cp = colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d
                      : nullptr;
  write_grad<TL>(dK, L::LD, dKg.head(b, h), dKg.sr, k0, S, d, cp ? cp + H : nullptr);
  write_grad<TL>(dV, L::LD, dVg.head(b, h), dVg.sr, k0, S, d, cp ? cp + 2 * H : nullptr);
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

// Both backward kernels in order: the dQ kernel writes D, the dK / dV kernel
// reads it.
template <int DP>
cudaError_t launch_bwd_mma(const BwdArgs& a, cudaStream_t s) {
  constexpr int bytes = BwdSmem<DP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + BWD_TILE - 1) / BWD_TILE, a.nh, a.B);
  flash_bwd_dq_mma_kernel<DP><<<grid, BWD_THREADS, bytes, s>>>(
      as_mat<const fm_bf16>(a.q), as_mat<const fm_bf16>(a.k), as_mat<const fm_bf16>(a.v),
      as_mat<const fm_bf16>(a.o), as_mat<const fm_bf16>(a.dout), a.mask, a.stats, a.D,
      as_mat<fm_bf16>(a.dq), a.colpart, a.S, a.nh, a.d, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_mma_kernel<DP><<<grid, BWD_THREADS, bytes, s>>>(
      as_mat<const fm_bf16>(a.q), as_mat<const fm_bf16>(a.k), as_mat<const fm_bf16>(a.v),
      as_mat<const fm_bf16>(a.dout), a.mask, a.stats, a.D, as_mat<fm_bf16>(a.dk),
      as_mat<fm_bf16>(a.dv), a.colpart, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t s) {
  constexpr int bytes = BwdF32Smem<DP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + F32_TL - 1) / F32_TL, a.nh, a.B);
  flash_bwd_dq_f32_kernel<DP><<<grid, FA_THREADS, bytes, s>>>(
      as_mat<const float>(a.q), as_mat<const float>(a.k), as_mat<const float>(a.v),
      as_mat<const float>(a.o), as_mat<const float>(a.dout), a.mask, a.stats, a.D,
      as_mat<float>(a.dq), a.colpart, a.S, a.nh, a.d, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32_kernel<DP><<<grid, FA_THREADS, bytes, s>>>(
      as_mat<const float>(a.q), as_mat<const float>(a.k), as_mat<const float>(a.v),
      as_mat<const float>(a.dout), a.mask, a.stats, a.D, as_mat<float>(a.dk),
      as_mat<float>(a.dv), a.colpart, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int dtype, cudaStream_t s) {
  const bool bf16 = dtype == FM_BF16;
  if (!bf16 && dtype != FM_F32) return cudaErrorInvalidValue;
  switch (head_pad(a.d)) {
    case 32: return bf16 ? launch_bwd_mma<32>(a, s) : launch_bwd_f32<32>(a, s);
    case 64: return bf16 ? launch_bwd_mma<64>(a, s) : launch_bwd_f32<64>(a, s);
    case 96: return bf16 ? launch_bwd_mma<96>(a, s) : launch_bwd_f32<96>(a, s);
    case 128: return bf16 ? launch_bwd_mma<128>(a, s) : launch_bwd_f32<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
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
