// Flash-style masked multi-head attention, forward and backward, over strided
// [B, heads, S, d] operands:
//
//     o[b, h] = softmax(q[b, h] k[b, h]^T * scale + bias[b]) v[b, h]
//     bias[b, key] = 0 where mask[b, key] > 0, else -1e9 (additive, NOT -inf);
//     no mask: every key attends
//
// Replaces two Pallas TPU kernels and the attention cores of four more:
//   - fairmultimodal_tpu/ops/flash_attention.py::_fwd_kernel (#9, :44) and
//     ::_bwd_kernel (#10, :67), which take q, k, v as separate
//     [B, heads, S, D] arrays and an optional [B, S] mask;
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
// split or merge is ever materialised.
//
// Bound at the lab shape (B 256, S 560, 8 heads x 96): the score and p.v
// products are 4*B*S*S*H = 2.5e11 FLOP (0.25 ms at the bf16 dense peak)
// while q/k/v/o move 0.9 GB (0.26 ms at 3.35 TB/s); the backward's five
// products 10*B*S*S*H = 6.2e11 (0.62 ms).
//
// Forward design.  The TPU kernel holds the whole [S, S] score tile in VMEM;
// an SM has 227 KB, so both kernels here tile the keys with an online
// softmax (running row max and sum, the output rescaled when the max grows).
// The head dim is padded with zeros to DP, a multiple of 32 (d 96 stays 96):
// the TPU kernel's 96 -> 128 pad was Mosaic's 128-lane rule and buys nothing
// here.
//   - bf16 (any d <= 128): what bounds it is the tensor cores' rate (and the
//     bytes, at the lab shape), and only wgmma reaches that rate, so
//     flash_attn_fwd_wgmma_kernel is FlashAttention-3's shape: a persistent
//     block per SM of two consumer warpgroups, each owning 64 query rows of
//     a 128-row (batch, head, row block) item, and a producer warp that
//     keeps TMA copies in flight.  Every operand tile arrives by
//     cp.async.bulk.tensor through a rank-4 tensor map (d, S, heads, B) over
//     the operand's own strides, so a row past S inside the head is zero
//     filled and the next head is never read; d / 32 boxes of [rows][32]
//     with the 64-byte swizzle cover d 32, 64, 96 and 128 with one rule (a
//     192-byte row at d 96 does not fit one 128-byte swizzle line).  s =
//     q.k^T is an SS wgmma (both K-major over d); the fp32 scores are
//     scaled, biased and soft-maxed in registers (quad shuffles), rounded to
//     bf16 and repacked as the register A operand of o += p.v, whose B = v
//     is MN-major over d (the descriptor's transpose bit).  Keys come in
//     tiles of BN = 112 where that pads S to fewer keys than 128 (S 560 =
//     5 x 112), else 128 (S 512 = 4 x 128), through a ring of 2-3 stages of
//     (k, v, key bias); the producer gives its registers up (setmaxnreg 40 /
//     232).  The q tile of the next item is loaded as soon as both
//     consumers' last q.k^T has completed, under this item's last p.v and
//     output stores.  Rows: 128-row items, a warpgroup whose 64 rows all
//     lie past S (the last item at S 560) waits and releases its stages
//     without a product, so 576 rows are computed for S 560.
//     ROUNDING (the one change of contract): the TPU kernel rounds the
//     NORMALISED p to bf16 before p.v (flash_attention.py:62); this kernel
//     rounds the unnormalised exp(s - m_running), m_running the row max over
//     the key tiles so far, sums the fp32 values, and divides o by that sum
//     once at the end.  The two differ by at most one bf16 rounding of each
//     p, inside the bf16 forward limits that chip_smoke.py phase 3d holds it
//     to (FLASH_BF16_FWD = 2^-6 of max-abs, mean TRAIN_BF16_MEAN = 2^-10);
//     tests/test_torch_flash_forward_contract.py emulates this order, at the
//     kernel's key tile, on the CPU against the Pallas kernel.
//   - fp32: CUDA cores, one pass with the same online softmax, register
//     micro-tiles fed by float4 shared-memory reads and a cp.async ring (its
//     own note, below).  fp32 rounds nothing, so normalising once at the end
//     differs from the TPU kernel only in summation order.
// Each row's max m (of s * scale + bias, natural-log units) and sum l (of
// exp(s * scale + bias - m), fp32) are written to stats [B, heads, S, 2]
// when the backward will need them; it recomputes p from them.
//
// Masking copies the TPU kernels exactly: -1e9 is added to the scaled score,
// so a fully masked row (the pad rows of an encode batch) gets a finite,
// uniform softmax instead of NaN.  Keys past S (the ragged last tile) get
// -inf and weigh exactly zero.
//
// TMA needs a 16-byte aligned base and strides of a multiple of 16 bytes;
// the wrapper (_build.tma_operand) copies an operand that lacks them into a
// contiguous buffer whose rows are padded to a multiple of 8 elements.
// Outputs are stored from registers through a swizzled staging tile, 16
// bytes at a time where the layout allows it.
//
// Each consumer warpgroup issues its products and waits for them; the two
// warpgroups overlap only as the warp schedulers interleave them.  Measured
// in turns on an H100 (80GB HBM3, 700 W) at the lab shape and not kept:
// FlashAttention-3's ping-pong, the two warpgroups taking turns to issue
// through named barriers (forward 1.14 ms against 0.89, dQ 1.59 against 1.08,
// dK / dV 2.18 against 1.57 of device time), and issuing the next tile's
// q.k^T under this tile's p.v (0.92 against 0.89); the dQ kernel keeps the
// latter (1.02-1.03 ms against 1.08).
#include <math.h>
#include <stdint.h>

#include "fm_common.cuh"
#include "fm_hopper.cuh"

namespace {

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

constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes global -> shared, asynchronously; zero fill when !ok (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Two fp32 values rounded to bf16 and packed, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- bf16 kernels: wgmma fed by TMA, warp-specialised ---------------------------------

constexpr int FA_ROWS = 64;        // rows a consumer warpgroup owns (one wgmma M)
constexpr int FA_CONSUMERS = 2;    // consumer warpgroups a block: 128 owned rows
constexpr int FA_THREADS = (FA_CONSUMERS + 1) * 128;  // + the producer's warpgroup
constexpr int FA_SMEM_MAX = 232448;                   // a block's shared memory on an H100
// _build.FLASH_FWD_KEYS repeats the forward's key tiles (_build.flash_fwd_bf16_keys
// the rule between them).
constexpr int FWD_BN_NARROW = 112;
constexpr int FWD_BN_WIDE = 128;
// _build.FLASH_BWD_TILE repeats BWD_TILE and F32_TL (the column partials' rows).
constexpr int BWD_TILE = 64;       // rows a consumer warpgroup of the backward owns
constexpr int BWD_WALK = 64;       // rows of each walked tile
static_assert(BWD_TILE == FA_ROWS, "a backward warpgroup owns one wgmma M of rows");

// Keys per tile of the bf16 forward at S: 112 where that pads S to fewer keys
// than 128, else 128.
int fwd_bn(int S) {
  return (S + FWD_BN_NARROW - 1) / FWD_BN_NARROW * FWD_BN_NARROW <
                 (S + FWD_BN_WIDE - 1) / FWD_BN_WIDE * FWD_BN_WIDE
             ? FWD_BN_NARROW
             : FWD_BN_WIDE;
}

// A [R][DP] bf16 tile in shared memory is DP / 32 TMA boxes of [R][32]: 64-byte
// rows with the 64-byte swizzle (16-byte chunk index XOR (row / 2) % 4), each
// box R * 64 bytes and 512-byte aligned.  Byte offset of element (r, c):
template <int R>
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (c >> 5) * (R * 64) + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2;
}
// wgmma descriptors of such a tile (the canonical 64-byte-swizzle layouts of
// CUTLASS's make_gmma_desc).  K-major (its rows are M or N, the head dim is
// K): the 16-deep slice kk is in box kk / 2, 32 bytes on for odd kk; 8-row
// groups 512 bytes apart (stride), the leading offset unused.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return wgmma_desc(tile + (kk >> 1) * (R * 64) + (kk & 1) * 32, 16, 512, 2);
}
// MN-major (its rows are K, the head dim is N): slice kk is 16 rows (1024
// bytes) on; 32-wide N blocks one box apart (leading), 8-row K groups 512
// bytes apart (stride).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return wgmma_desc(tile + kk * 1024, R * 64, 512, 2);
}

// d[0 .. N/2) (+)= A . B^T over 16 of K, both from shared memory and K-major
// (scale_d 0: d = A . B^T).  Accumulator layout (m64nN, fp32): thread (warp w
// of the warpgroup, lane l) holds rows 16w + l/4 (d[4i], d[4i + 1]) and + 8
// (d[4i + 2], d[4i + 3]), columns 8i + 2(l % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// d[0 .. N/2) += A . B over 16 of K, A from registers (the accumulator layout
// of columns 16kk .. 16kk + 15 packed to bf16 pairs: rows l/4 and + 8 of
// columns 2(l % 4), then of columns 8 + 2(l % 4)), B from shared memory and
// MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The named barrier of consumer warpgroup ``wg`` (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A warpgroup's fp32 [64 x DP] accumulator (its rows r0 .. r0 + 63 of one
// head, row stride rs), rows l/4 divided by div0 and rows l/4 + 8 by div1,
// rounded to bf16, staged in the swizzled tile ``stage``
// (this warpgroup's alone) and stored, 16 bytes at a time when the layout
// allows it; rows past S and columns past d are not written.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], float div0, float div1,
                                           unsigned char* stage, fm_bf16* dst, long long rs,
                                           int r0, int S, int d, int wg) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;
  wg_sync(wg);  // the staging tile's previous readers are done
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(stage + sw64<FA_ROWS>(row, col)) =
        __floats2bfloat162_rn(acc[4 * i] / div0, acc[4 * i + 1] / div0);
    *reinterpret_cast<__nv_bfloat162*>(stage + sw64<FA_ROWS>(row + 8, col)) =
        __floats2bfloat162_rn(acc[4 * i + 2] / div1, acc[4 * i + 3] / div1);
  }
  wg_sync(wg);
  if (vec16(dst, rs, d)) {
    constexpr int CPR = DP / 8;
    for (int c = tid; c < FA_ROWS * CPR; c += 128) {
      const int r = c / CPR, col = (c % CPR) * 8;
      if (r0 + r < S && col < d)
        *reinterpret_cast<uint4*>(dst + (r0 + r) * rs + col) =
            *reinterpret_cast<const uint4*>(stage + sw64<FA_ROWS>(r, col));
    }
  } else {
    for (int i = tid; i < FA_ROWS * DP; i += 128) {
      const int r = i / DP, col = i % DP;
      if (r0 + r < S && col < d)
        dst[(r0 + r) * rs + col] = *reinterpret_cast<const fm_bf16*>(stage + sw64<FA_ROWS>(r, col));
    }
  }
}

// Column sums of a warpgroup's fp32 [64 x DP] accumulator over its 64 rows:
// the 16 rows of each warp by shuffles (a fixed order), then the 4 warps in
// order through csum [4][DP] (this warpgroup's), into dst[0 .. d).
template <int DP>
__device__ __forceinline__ void col_sums(const float (&acc)[DP / 2], float* csum, int d, int wg,
                                         float* dst) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    float c0 = acc[4 * i] + acc[4 * i + 2], c1 = acc[4 * i + 1] + acc[4 * i + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (lane < 4) {
      csum[warp * DP + 8 * i + 2 * lane] = c0;
      csum[warp * DP + 8 * i + 2 * lane + 1] = c1;
    }
  }
  wg_sync(wg);
  for (int c = tid; c < d; c += 128) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += csum[w * DP + c];
    dst[c] = s;
  }
  wg_sync(wg);  // csum is free again
}

// Shared memory of the forward (byte offsets from a 1024-byte aligned base).
template <int DP, int BN>
struct FwdLayout {
  static constexpr int Q_TILE = FA_ROWS * DP * 2;  // one consumer's q (or output staging) tile
  static constexpr int KV_TILE = BN * DP * 2;      // one k or v tile
  static constexpr int STAGE = 2 * KV_TILE + BN * 4;
  static constexpr int Q = 0;                                  // the consumers' q tiles
  static constexpr int OST = Q + FA_CONSUMERS * Q_TILE;        // their output staging tiles
  static constexpr int RING = OST + FA_CONSUMERS * Q_TILE;     // stages of (k, v)
  static constexpr int STAGES = RING + 3 * STAGE + 1024 + 128 <= FA_SMEM_MAX ? 3 : 2;
  static constexpr int BIAS = RING + STAGES * 2 * KV_TILE;     // stages x [BN] key bias
  static constexpr int BAR = BIAS + STAGES * BN * 4;           // full, empty, q full, q empty
  static constexpr int BYTES = BAR + (2 * STAGES + 2) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= FA_SMEM_MAX, "the forward's shared memory fits an SM");
  static_assert(KV_TILE % 512 == 0 && Q_TILE % 1024 == 0, "boxes stay 512-byte aligned");
};

// Persistent: block i takes items i, i + grid, ...; item = (b, h, row block
// rb) with rb fastest, so the blocks working on one head at a time share its
// k and v in L2.  Warpgroups 0 and 1 own rows rb*128 + 64 wg .. + 63; the
// first warp of warpgroup 2 is the producer.
template <int DP, int BN>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                            const __grid_constant__ CUtensorMap tmK,
                            const __grid_constant__ CUtensorMap tmV, Mask mask, Mat<fm_bf16> O,
                            float* __restrict__ stats, int S, int nh, int d, float scale, int nrb,
                            int items) {
  using L = FwdLayout<DP, BN>;
  constexpr int ST = L::STAGES;
  constexpr int KD = DP / 16;  // 16-deep slices of q.k^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* kbias = reinterpret_cast<float*>(sm + L::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + 1;
  const int wg = threadIdx.x / 128;
  const int ntiles = (S + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);            // the producer warp's lanes (key bias), plus the copies
      mbar_init(&empty[s], FA_CONSUMERS);  // one arrive per consumer warpgroup
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, FA_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == FA_CONSUMERS) {  // producer: the roles never meet at a block-wide barrier again
    setmaxnreg_dec<40>();
    if (threadIdx.x / 32 != FA_CONSUMERS * 4) return;
    const int lane = threadIdx.x % 32;
    int it = 0;  // key tiles loaded so far, over every item
    int n = 0;   // items so far
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int rb = item % nrb, h = item / nrb % nh, b = item / nrb / nh;
      if (lane == 0) {
        mbar_wait(qempty, (n & 1) ^ 1);  // both consumers issued their last q.k^T
        mbar_expect_tx(qfull, FA_CONSUMERS * L::Q_TILE);
        for (int w = 0; w < FA_CONSUMERS; ++w)
          for (int c = 0; c < DP / 32; ++c)
            tma_load_4d(sm + L::Q + w * L::Q_TILE + c * FA_ROWS * 64, &tmQ, 32 * c,
                        rb * FA_CONSUMERS * FA_ROWS + w * FA_ROWS, h, b, qfull);
      }
      const int* mrow = mask.row(b);
      for (int j = 0; j < ntiles; ++j, ++it) {
        const int s = it % ST;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);  // the first round passes at once
        for (int i = lane; i < BN; i += 32) kbias[s * BN + i] = key_bias(mrow, j * BN + i, S);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::KV_TILE);
          unsigned char* kt = sm + L::RING + s * 2 * L::KV_TILE;
          for (int c = 0; c < DP / 32; ++c) {
            tma_load_4d(kt + c * BN * 64, &tmK, 32 * c, j * BN, h, b, &full[s]);
            tma_load_4d(kt + L::KV_TILE + c * BN * 64, &tmV, 32 * c, j * BN, h, b, &full[s]);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const uint32_t qtile = smem_u32(sm + L::Q + wg * L::Q_TILE);
  unsigned char* ostage = sm + L::OST + wg * L::Q_TILE;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int rb = item % nrb, h = item / nrb % nh, b = item / nrb / nh;
    const int r0 = rb * FA_CONSUMERS * FA_ROWS + wg * FA_ROWS;  // this warpgroup's first row
    const bool active = r0 < S;
    float o[DP / 2];
    float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows l/4, + 8 (natural-log units)
    float l_r[2] = {0.0f, 0.0f};            // this thread's share of their running sums
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    mbar_wait(qfull, n & 1);
    for (int j = 0; j < ntiles; ++j, ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      if (active) {
        const uint32_t kt = smem_u32(sm + L::RING + s * 2 * L::KV_TILE);
        // s = q . k^T: both K-major over the head dim.
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          wgmma_ss<BN>(sc, desc_k<FA_ROWS>(qtile, kk), desc_k<BN>(kt, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (j == ntiles - 1 && tid == 0) mbar_arrive(qempty);

        // Scale and key bias as the TPU kernel adds them, then the online
        // softmax: the quad of lanes sharing a row reduces its max by
        // shuffles.  p = exp(s - m) is summed in fp32 and rounded to bf16 as
        // the A operand of p.v (accumulator columns 16kk .. 16kk + 15 -> slice kk).
        const float* kbs = kbias + s * BN;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float2 kb = *reinterpret_cast<const float2*>(kbs + 8 * i + 2 * t);
          sc[4 * i] = sc[4 * i] * scale + kb.x;
          sc[4 * i + 1] = sc[4 * i + 1] * scale + kb.y;
          sc[4 * i + 2] = sc[4 * i + 2] * scale + kb.x;
          sc[4 * i + 3] = sc[4 * i + 3] * scale + kb.y;
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);  // finite: every tile holds a key < S
          alpha[r] = exp2f((m_r[r] - m_new) * LOG2E);  // 0 on the first tile
          m_r[r] = m_new;
          l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          o[4 * i] *= alpha[0];
          o[4 * i + 1] *= alpha[0];
          o[4 * i + 2] *= alpha[1];
          o[4 * i + 3] *= alpha[1];
        }
        uint32_t pf[BN / 16][4];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float p0 = exp2f((sc[4 * i] - m_r[0]) * LOG2E);
          const float p1 = exp2f((sc[4 * i + 1] - m_r[0]) * LOG2E);
          const float p2 = exp2f((sc[4 * i + 2] - m_r[1]) * LOG2E);
          const float p3 = exp2f((sc[4 * i + 3] - m_r[1]) * LOG2E);
          l_r[0] += p0 + p1;
          l_r[1] += p2 + p3;
          pf[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
          pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
        }

        // o += p . v: v rows are keys (the depth), the head dim is N (MN-major).
        const uint32_t vt = kt + L::KV_TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<DP>(o, pf[kk], desc_mn<BN>(vt, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      } else if (j == ntiles - 1 && tid == 0) {
        mbar_arrive(qempty);
      }
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    if (!active) continue;

    // o / l, rounded to bf16 once; each row's m and l to stats.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    store_rows<DP>(o, l_r[0], l_r[1], ostage, O.head(b, h), O.sr, r0, S, d, wg);
    if (stats && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + lane / 4 + 8 * r;
        if (row < S) {
          float* sp = stats + (((size_t)b * nh + h) * S + row) * 2;
          sp[0] = m_r[r];
          sp[1] = l_r[r];
        }
      }
    }
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
//   - flash_bwd_dq: one block per 128 query rows; it first writes D_i =
//     rowsum(dO * O) for its rows, then walks the key tiles:
//     dS = P * (dO.V^T - D), dQ += round(dS * scale) . K;
//   - flash_bwd_dkdv: one block per 128 key rows, after flash_bwd_dq (it
//     reads D); it walks the query tiles: dV += round(P)^T . dO and
//     dK += round(dS * scale)^T . Q.
// The TPU kernels take the softmax-VJP row term as rowsum(dP * P)
// (flash_attention.py:93); with P normalised that equals dO . O, which is
// kept here (one pass over the keys instead of two), computed from the
// stored o (rounded to the io dtype in bf16, as is p before p.v), so in
// bf16 the two differ by about one bf16 rounding of D.  Rounding points
// are the TPU kernels': dO arrives in the io dtype, p and dS * scale are
// rounded before their products (:87, :94), dq/dk/dv are rounded when
// written.  With ``colpart`` (the dbqkv sums #3 / #6 need) the column sums
// of the fp32 dq | dk | dv over each 64-row tile are written as partials
// [B * ceil(S / 64), 3 * heads * d] for fm_colsum; #10 passes null.  dQ
// keeps its own pass: per-key-tile partials of dQ would move 2-4 GB at the
// lab shape, and float atomics would make the sums differ run to run.
//
// Bound at the lab shape: 10*B*S^2*H = 6.2e11 FLOP of the TPU kernel's
// products (0.62 ms at the bf16 peak); this design executes 1.4x them (the
// dQ kernel recomputes S and dP: seven [S, S, d] products, 8.6e11 FLOP).
//
// bf16 design (flash_bwd_dq_wgmma_kernel, flash_bwd_dkdv_wgmma_kernel; what
// bounds them is the tensor cores' rate, and only wgmma reaches it): the
// forward's block shape, not persistent.  Two consumer warpgroups own 64
// rows each (BWD_TILE: one wgmma M, one column-partial row) of a 128-row
// block; the producer warp loads the owned tiles once (q, dO and o for dQ;
// k and v for dK / dV) and walks the other operand in 64-row tiles through a
// ring of 2-3 stages, all by TMA over the forward's rank-4 maps, with the
// walked rows' vectors (the key bias for dQ; m, 1 / l and D for dK / dV)
// written beside each stage by its lanes; the dQ kernel issues the next
// tile's S and dP under this tile's dQ product, one wait for the three.  S =
// Q.K^T and dP = dO.V^T (or
// S^T = K.Q^T and dP^T = V.dO^T) are SS wgmmas over d; p and round(dS *
// scale) (and round(p)) become the register A operands of dQ += dS . K (dV
// += P^T . dO, dK += dS^T . Q), whose B (the walked tile: rows are the
// depth) is MN-major over d.  Nothing between the products leaves
// registers.  p is the forward's expression, exp2((s * scale + bias - m) *
// log2 e), times 1 / l: the forward's unnormalised p of each element
// divided by its row sum.  The column partials are added over the 16 rows of
// a warp by shuffles and over the 4 warps in order through shared memory:
// a fixed order, the same bits every run.
//
// fp32 runs the same two-kernel structure on the CUDA cores with register
// micro-tiles (its own note, below): it is the main path of every fp32 run,
// which `fame` and every baseline make unless --bf16 is given.

// Shared memory of a backward kernel with NOWN owned tiles per consumer.
template <int DP, int NOWN>
struct BwdLayout {
  static constexpr int TILE = BWD_TILE * DP * 2;  // one [64][DP] bf16 tile
  static constexpr int VEC_STAGE = 3 * BWD_WALK * 4;  // a stage's [3][64] fp32 row vectors
  static constexpr int OWN = 0;                                  // the consumers' owned tiles
  static constexpr int RING = OWN + FA_CONSUMERS * NOWN * TILE;  // stages of two walked tiles
  static constexpr int CSUM_BYTES = FA_CONSUMERS * 4 * DP * 4;   // [consumer][warp][DP] fp32
  static constexpr int STAGES =
      RING + 3 * (2 * TILE + VEC_STAGE) + CSUM_BYTES + 1024 + 128 <= FA_SMEM_MAX ? 3 : 2;
  static constexpr int VEC = RING + STAGES * 2 * TILE;
  static constexpr int CSUM = VEC + STAGES * VEC_STAGE;
  static constexpr int BAR = CSUM + CSUM_BYTES;  // full, empty, owned
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= FA_SMEM_MAX, "the backward's shared memory fits an SM");
  static_assert(TILE % 1024 == 0, "boxes stay 1024-byte aligned");
};

// The barriers of a backward kernel: a full and an empty one per stage, one
// for the owned tiles.
struct BwdSync {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* owned;
};

template <int ST>
__device__ __forceinline__ BwdSync bwd_init(unsigned char* bar) {
  BwdSync b{reinterpret_cast<uint64_t*>(bar), reinterpret_cast<uint64_t*>(bar) + ST,
            reinterpret_cast<uint64_t*>(bar) + 2 * ST};
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&b.full[s], 32);            // the producer warp's lanes, plus the copies
      mbar_init(&b.empty[s], FA_CONSUMERS);  // one arrive per consumer warpgroup
    }
    mbar_init(b.owned, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return b;
}

// s = a0 . w0^T and dp = a1 . w1^T over the head dim into sc and dp (all
// K-major: owned tiles a0, a1 of BWD_TILE rows, walked tiles w0, w1 of
// BWD_WALK rows), issued and not waited for.
template <int DP>
__device__ __forceinline__ void issue_pair(float (&sc)[BWD_WALK / 2], float (&dp)[BWD_WALK / 2],
                                           uint32_t a0, uint32_t a1, uint32_t w0, uint32_t w1) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BWD_WALK>(sc, desc_k<BWD_TILE>(a0, kk), desc_k<BWD_WALK>(w0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BWD_WALK>(dp, desc_k<BWD_TILE>(a1, kk), desc_k<BWD_WALK>(w1, kk), kk > 0);
}

// dQ of 128 query rows of one (batch, head), and D of those rows.
template <int DP>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const __grid_constant__ CUtensorMap tmO,
                          const __grid_constant__ CUtensorMap tmG, Mask mask,
                          const float* __restrict__ stats, float* __restrict__ Dg,
                          Mat<fm_bf16> dQg, float* __restrict__ colpart, int S, int nh, int d,
                          float scale) {
  using L = BwdLayout<DP, 3>;
  constexpr int ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vecs = reinterpret_cast<float*>(sm + L::VEC);  // stage s: [64] key bias at s * 3 * 64
  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * FA_CONSUMERS * BWD_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nwalk = (S + BWD_WALK - 1) / BWD_WALK;
  const BwdSync sy = bwd_init<ST>(sm + L::BAR);
  // Owned tiles of consumer w: q, dO, o at (3w + 0, 1, 2) * TILE.
  auto own_tile = [&](int w, int which) { return sm + L::OWN + (3 * w + which) * L::TILE; };

  if (wg == FA_CONSUMERS) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x / 32 != FA_CONSUMERS * 4) return;
    const int* mrow = mask.row(b);
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(sy.owned, FA_CONSUMERS * 3 * L::TILE);
      for (int w = 0; w < FA_CONSUMERS; ++w)
        for (int c = 0; c < DP / 32; ++c) {
          const int r = q0 + w * BWD_TILE;
          tma_load_4d(own_tile(w, 0) + c * BWD_TILE * 64, &tmQ, 32 * c, r, h, b, sy.owned);
          tma_load_4d(own_tile(w, 1) + c * BWD_TILE * 64, &tmG, 32 * c, r, h, b, sy.owned);
          tma_load_4d(own_tile(w, 2) + c * BWD_TILE * 64, &tmO, 32 * c, r, h, b, sy.owned);
        }
    }
    for (int j = 0; j < nwalk; ++j) {
      const int s = j % ST;
      mbar_wait(&sy.empty[s], ((j / ST) & 1) ^ 1);  // the first round passes at once
      for (int i = lane; i < BWD_WALK; i += 32)
        vecs[s * 3 * BWD_WALK + i] = key_bias(mrow, j * BWD_WALK + i, S);
      if (lane == 0) {
        mbar_expect_tx(&sy.full[s], 2 * L::TILE);
        unsigned char* kt = sm + L::RING + s * 2 * L::TILE;
        for (int c = 0; c < DP / 32; ++c) {
          tma_load_4d(kt + c * BWD_WALK * 64, &tmK, 32 * c, j * BWD_WALK, h, b, &sy.full[s]);
          tma_load_4d(kt + L::TILE + c * BWD_WALK * 64, &tmV, 32 * c, j * BWD_WALK, h, b,
                      &sy.full[s]);
        }
      } else {
        mbar_arrive(&sy.full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator rows g, g + 8; columns 8i + 2t, + 1
  const int r0 = q0 + wg * BWD_TILE;     // this warpgroup's first row
  const bool active = r0 < S;
  const size_t srow = ((size_t)b * nh + h) * S;  // row offset into stats / D
  // m and 1 / l of rows g, g + 8 (0 past S: then p = 0).
  float m_r[2], il_r[2], D_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    m_r[r] = row < S ? stats[(srow + row) * 2] : 0.0f;
    il_r[r] = row < S ? 1.0f / stats[(srow + row) * 2 + 1] : 0.0f;
  }
  const uint32_t qs = smem_u32(own_tile(wg, 0));
  const uint32_t gs = smem_u32(own_tile(wg, 1));
  mbar_wait(sy.owned, 0);

  // D = rowsum(dO * O): the quad sharing a row takes every 4th 8-column
  // chunk of it, then adds its 4 sums by shuffles.
  if (active) {
    const unsigned char* go = own_tile(wg, 1);
    const unsigned char* oo = own_tile(wg, 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      float s = 0.0f;
      for (int ch = t; ch < DP / 8; ch += 4) {
        const uint4 gu = *reinterpret_cast<const uint4*>(go + sw64<BWD_TILE>(row, 8 * ch));
        const uint4 ou = *reinterpret_cast<const uint4*>(oo + sw64<BWD_TILE>(row, 8 * ch));
        const fm_bf16* g8 = reinterpret_cast<const fm_bf16*>(&gu);
        const fm_bf16* o8 = reinterpret_cast<const fm_bf16*>(&ou);
#pragma unroll
        for (int k = 0; k < 8; ++k) s += __bfloat162float(g8[k]) * __bfloat162float(o8[k]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      D_r[r] = s;
      if (t == 0 && r0 + row < S) Dg[srow + r0 + row] = s;
    }
  }

  if (!active) {  // every row past S: release each stage without a product
    for (int j = 0; j < nwalk; ++j) {
      mbar_wait(&sy.full[j % ST], (j / ST) & 1);
      if (tid == 0) mbar_arrive(&sy.empty[j % ST]);
    }
    return;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
  // s = q . k^T and dp = dO . v^T: k and v rows are keys (N), K-major over d.
  float sc[BWD_WALK / 2], dp[BWD_WALK / 2];
  const uint32_t ring = smem_u32(sm + L::RING);  // stage s: k at 2s, v at 2s + 1 tiles
  mbar_wait(&sy.full[0], 0);
  wgmma_fence();
  issue_pair<DP>(sc, dp, qs, gs, ring, ring + L::TILE);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);
  for (int j = 0; j < nwalk; ++j) {
    const int s = j % ST;
    const uint32_t kt = ring + s * 2 * L::TILE;
    // p = exp2((s * scale + bias - m) * log2 e) / l, ds = p * (dp - D);
    // round(ds * scale) as the A operand of ds . k.
    const float* kbs = vecs + s * 3 * BWD_WALK;
    uint32_t dsf[BWD_WALK / 16][4];
#pragma unroll
    for (int i = 0; i < BWD_WALK / 8; ++i) {
      const float2 kb = *reinterpret_cast<const float2*>(kbs + 8 * i + 2 * t);
      const float p0 = exp2f((sc[4 * i] * scale + kb.x - m_r[0]) * LOG2E) * il_r[0];
      const float p1 = exp2f((sc[4 * i + 1] * scale + kb.y - m_r[0]) * LOG2E) * il_r[0];
      const float p2 = exp2f((sc[4 * i + 2] * scale + kb.x - m_r[1]) * LOG2E) * il_r[1];
      const float p3 = exp2f((sc[4 * i + 3] * scale + kb.y - m_r[1]) * LOG2E) * il_r[1];
      dsf[i / 2][(i % 2) * 2] = pack_bf16(p0 * (dp[4 * i] - D_r[0]) * scale,
                                          p1 * (dp[4 * i + 1] - D_r[0]) * scale);
      dsf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2 * (dp[4 * i + 2] - D_r[1]) * scale,
                                              p3 * (dp[4 * i + 3] - D_r[1]) * scale);
    }

    // dq += ds . k (k rows are the depth, the head dim is N: MN-major), then
    // the next tile's s and dp into sc and dp (free once ds is packed): one
    // wait for the three.
    const uint32_t nt = ring + (j + 1) % ST * 2 * L::TILE;
    if (j + 1 < nwalk) mbar_wait(&sy.full[(j + 1) % ST], ((j + 1) / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_WALK / 16; ++kk) wgmma_rs<DP>(dq, dsf[kk], desc_mn<BWD_WALK>(kt, kk));
    if (j + 1 < nwalk) issue_pair<DP>(sc, dp, qs, gs, nt, nt + L::TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(sc);
    fence_regs(dp);
    if (tid == 0) mbar_arrive(&sy.empty[s]);
  }

  // Column partials of the fp32 dq, then dq rounded to bf16 through the o
  // tile (read only by this warpgroup, for D, above).
  const long long cps = 3LL * nh * d;  // colpart row: dq | dk | dv, head h at h*d
  float* csum = reinterpret_cast<float*>(sm + L::CSUM) + wg * 4 * DP;
  if (colpart) {
    const int tile = r0 / BWD_TILE, ntile = (S + BWD_TILE - 1) / BWD_TILE;
    col_sums<DP>(dq, csum, d, wg, colpart + ((size_t)b * ntile + tile) * cps + (size_t)h * d);
  }
  store_rows<DP>(dq, 1.0f, 1.0f, own_tile(wg, 2), dQg.head(b, h), dQg.sr, r0, S, d, wg);
}

// dK and dV of 128 key rows of one (batch, head), after flash_bwd_dq_wgmma_kernel.
template <int DP>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                            const __grid_constant__ CUtensorMap tmK,
                            const __grid_constant__ CUtensorMap tmV,
                            const __grid_constant__ CUtensorMap tmG, Mask mask,
                            const float* __restrict__ stats, const float* __restrict__ Dg,
                            Mat<fm_bf16> dKg, Mat<fm_bf16> dVg, float* __restrict__ colpart,
                            int S, int nh, int d, float scale) {
  using L = BwdLayout<DP, 2>;
  constexpr int ST = L::STAGES;
  constexpr int KD = DP / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vecs = reinterpret_cast<float*>(sm + L::VEC);  // stage s: m, 1 / l, D of 64 rows
  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * FA_CONSUMERS * BWD_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nwalk = (S + BWD_WALK - 1) / BWD_WALK;
  const size_t srow = ((size_t)b * nh + h) * S;
  const BwdSync sy = bwd_init<ST>(sm + L::BAR);
  // Owned tiles of consumer w: k, v at (2w + 0, 1) * TILE.
  auto own_tile = [&](int w, int which) { return sm + L::OWN + (2 * w + which) * L::TILE; };

  if (wg == FA_CONSUMERS) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x / 32 != FA_CONSUMERS * 4) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(sy.owned, FA_CONSUMERS * 2 * L::TILE);
      for (int w = 0; w < FA_CONSUMERS; ++w)
        for (int c = 0; c < DP / 32; ++c) {
          const int r = k0 + w * BWD_TILE;
          tma_load_4d(own_tile(w, 0) + c * BWD_TILE * 64, &tmK, 32 * c, r, h, b, sy.owned);
          tma_load_4d(own_tile(w, 1) + c * BWD_TILE * 64, &tmV, 32 * c, r, h, b, sy.owned);
        }
    }
    for (int j = 0; j < nwalk; ++j) {
      const int s = j % ST;
      mbar_wait(&sy.empty[s], ((j / ST) & 1) ^ 1);
      // m, 1 / l and D of query row q (0, 0, 0 past S: then p = 0 and ds = 0).
      float* v = vecs + s * 3 * BWD_WALK;
      for (int i = lane; i < BWD_WALK; i += 32) {
        const int q = j * BWD_WALK + i;
        const bool ok = q < S;
        v[i] = ok ? stats[(srow + q) * 2] : 0.0f;
        v[BWD_WALK + i] = ok ? 1.0f / stats[(srow + q) * 2 + 1] : 0.0f;
        v[2 * BWD_WALK + i] = ok ? Dg[srow + q] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&sy.full[s], 2 * L::TILE);
        unsigned char* qt = sm + L::RING + s * 2 * L::TILE;
        for (int c = 0; c < DP / 32; ++c) {
          tma_load_4d(qt + c * BWD_WALK * 64, &tmQ, 32 * c, j * BWD_WALK, h, b, &sy.full[s]);
          tma_load_4d(qt + L::TILE + c * BWD_WALK * 64, &tmG, 32 * c, j * BWD_WALK, h, b,
                      &sy.full[s]);
        }
      } else {
        mbar_arrive(&sy.full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = k0 + wg * BWD_TILE;
  const bool active = r0 < S;
  const int* mrow = mask.row(b);
  // The key bias of rows g, g + 8 (-inf past S: then p = 0).
  const float kb_r[2] = {key_bias(mrow, r0 + warp * 16 + g, S),
                         key_bias(mrow, r0 + warp * 16 + g + 8, S)};
  const uint32_t ks = smem_u32(own_tile(wg, 0));
  const uint32_t vs = smem_u32(own_tile(wg, 1));
  mbar_wait(sy.owned, 0);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  for (int j = 0; j < nwalk; ++j) {
    const int s = j % ST;
    mbar_wait(&sy.full[s], (j / ST) & 1);
    if (active) {
      const uint32_t qt = smem_u32(sm + L::RING + s * 2 * L::TILE);
      const uint32_t gt = qt + L::TILE;
      // s^T = k . q^T and dp^T = v . dO^T: rows are keys, columns queries.
      float sc[BWD_WALK / 2], dp[BWD_WALK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        wgmma_ss<BWD_WALK>(sc, desc_k<BWD_TILE>(ks, kk), desc_k<BWD_WALK>(qt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        wgmma_ss<BWD_WALK>(dp, desc_k<BWD_TILE>(vs, kk), desc_k<BWD_WALK>(gt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // p^T and ds^T: the query's m, 1 / l and D from the stage's vectors, the
      // key's bias from registers; round(p) and round(ds * scale) as A operands.
      const float* vm = vecs + s * 3 * BWD_WALK;
      uint32_t pf[BWD_WALK / 16][4], dsf[BWD_WALK / 16][4];
#pragma unroll
      for (int i = 0; i < BWD_WALK / 8; ++i) {
        const int c = 8 * i + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(vm + c);
        const float2 l2 = *reinterpret_cast<const float2*>(vm + BWD_WALK + c);
        const float2 D2 = *reinterpret_cast<const float2*>(vm + 2 * BWD_WALK + c);
        const float p0 = exp2f((sc[4 * i] * scale + kb_r[0] - m2.x) * LOG2E) * l2.x;
        const float p1 = exp2f((sc[4 * i + 1] * scale + kb_r[0] - m2.y) * LOG2E) * l2.y;
        const float p2 = exp2f((sc[4 * i + 2] * scale + kb_r[1] - m2.x) * LOG2E) * l2.x;
        const float p3 = exp2f((sc[4 * i + 3] * scale + kb_r[1] - m2.y) * LOG2E) * l2.y;
        pf[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
        pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
        dsf[i / 2][(i % 2) * 2] = pack_bf16(p0 * (dp[4 * i] - D2.x) * scale,
                                            p1 * (dp[4 * i + 1] - D2.y) * scale);
        dsf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2 * (dp[4 * i + 2] - D2.x) * scale,
                                                p3 * (dp[4 * i + 3] - D2.y) * scale);
      }

      // dv += p^T . dO and dk += ds^T . q: the walked rows are the depth.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_WALK / 16; ++kk)
        wgmma_rs<DP>(dv, pf[kk], desc_mn<BWD_WALK>(gt, kk));
#pragma unroll
      for (int kk = 0; kk < BWD_WALK / 16; ++kk)
        wgmma_rs<DP>(dk, dsf[kk], desc_mn<BWD_WALK>(qt, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    if (tid == 0) mbar_arrive(&sy.empty[s]);
  }
  if (!active) return;

  // dK through the k tile and dV through the v tile (read only by this
  // warpgroup's products, which have completed), with their column partials.
  const long long cps = 3LL * nh * d;
  const long long H = (long long)nh * d;
  float* csum = reinterpret_cast<float*>(sm + L::CSUM) + wg * 4 * DP;
  float* cp = nullptr;
  if (colpart) {
    const int tile = r0 / BWD_TILE, ntile = (S + BWD_TILE - 1) / BWD_TILE;
    cp = colpart + ((size_t)b * ntile + tile) * cps + (size_t)h * d;
    col_sums<DP>(dk, csum, d, wg, cp + H);
    col_sums<DP>(dv, csum, d, wg, cp + 2 * H);
  }
  store_rows<DP>(dk, 1.0f, 1.0f, own_tile(wg, 0), dKg.head(b, h), dKg.sr, r0, S, d, wg);
  store_rows<DP>(dv, 1.0f, 1.0f, own_tile(wg, 1), dVg.head(b, h), dVg.sr, r0, S, d, wg);
}

// ---- fp32 backward kernels (CUDA cores) ---------------------------------------------
//
// What bounds them is the CUDA cores' fp32 rate (67 TFLOP/s on an H100 SXM):
// at B 16 x S 560 x 8 x 96 the function's five [S, S, d] products (s, dp, dv,
// dk, dq) are 3.85e10 FLOP (0.575 ms) against 0.2 GB of operands.  Three
// launches do each product once:
//   1. flash_bwd_rowterm_f32_kernel: D = rowsum(dO * O) of every row (a pass of
//      its own: each dK / dV block walks every query row of its head, and o
//      beside the walked tiles would not fit its shared memory);
//   2. flash_bwd_dkdv_f32_kernel: a block owns F32_TL = 64 key rows and walks
//      the query rows in tiles of TW (64; 32 at d 128, where two 64-row stages
//      do not fit beside the owned tiles), forms s^T, dp^T, p and ds, sums
//      dv += p^T . dO and dk += ds^T . q, and stores each ds * scale it forms
//      to a [B, heads, S, SP] fp32 scratch (SP = S rounded up to 64, the
//      owned tiles' reach; 165 MB at B 16 x S 560 x 8);
//   3. flash_bwd_dq_f32_kernel: a block of 128 threads owns 64 query rows and
//      walks the stored ds with k in tiles of F32_DQ_WALK keys: dq += ds . k.
// The dQ kernel before this design recomputed s and dp (seven products, 5.4e10
// FLOP); the ds it formed is the same expression of the same operands as the
// dK / dV kernel's, so dq keeps its bits (below).
// In the dK / dV kernel thread (r, c) of the 16 x 16 grid (warp w, lane l: r =
// 4 (w / 2) + l / 8, c = 8 (w % 2) + l % 8) owns, of each S / dP tile, rows
// r + 16 i (i < 4) and walked columns c + 16 j (a 4 x TW/16 register
// micro-tile), and of the dK and dV accumulators rows r + 16 i and columns 2c +
// 32 jj + {0, 1} in registers for the whole walk; in the dQ kernel thread (g,
// c) of an 8 x 16 grid owns dq rows g + 8 i (i < 8) and the same columns, 8
// float4 ds reads and 3 float2 k reads a key step for 48 FMAs (against 4 and 3
// for 24 at 4 rows), and stages its dq in shared memory so that the column
// partials keep the 16 x 16 grid's order.  S = own0 . walk0^T and dP = own1 . walk1^T
// run in one sweep over d (float4 reads along d of 4 owned and 8 walked rows
// per warp, at an odd 16-byte pitch LD = d + 4: one wavefront each); p and ds
// go to shared memory only as operands of the next products, row-major
// [64][TW + 8] (the pitch puts a warp's 4 rows 8 banks apart), written
// conflict-free and read as float4 along the walked rows, beside float2 reads
// of the walked tile (one wavefront each); ds also goes from registers to the
// scratch with streaming stores (16 bytes of 4 keys per query row and warp;
// the rows of one 32-byte sector are completed by the warp two on).  The walked tiles come by 16-byte
// cp.async into a two-stage ring, the next tile's copy running under this
// tile's FMAs.  The dK / dV kernel is one block per SM (194 KB of shared
// memory at d 96, 216 registers), 8 warps; the dQ kernel holds only the ds and
// k tiles (45 KB at d 96, 167 registers) and runs three blocks per SM.  At B 16
// x S 560 x 8 x 96 on an H100 (80GB HBM3, 700 W; in turns, from the profiler):
// D 0.028 ms, dK/dV 1.096-1.103 (28 TFLOP/s of its four products; the parent's
// 1.087 had no ds stores), dQ 0.236-0.238 (33 TFLOP/s), 1.36-1.37 ms in all
// against the recomputing parent's 0.886 + 1.087 (0.575 ms bound).  Measured
// in turns and not kept: this dQ kernel as 256 threads of 4 rows each over
// 64-key tiles, two blocks per SM (0.250 ms; 0.249 at one block), and at four
// blocks per SM (128 registers: 40 bytes of spill at d 128); plain ds stores
// (dK/dV 1.112-1.126).  Before, the recomputing pair replaced a 32-row design
// at 2.87 + 3.88 ms; halving the owned-row loads of the S / dP sweep moved the
// dK / dV kernel by under 3%, so shared memory is not what holds it, as in the
// SGEMM (gemm.cu); also not kept then: the first layout (a warp reading 2
// owned and 16 walked rows, two wavefronts a walked read), fully unrolled
// loops, and a recomputing dQ kernel of two blocks per SM (32-row walk; 128
// registers, 128 bytes of spill): all within 3%.
// Numerics (the fp32 forward's): s is the fmaf chain over k in order,
// p = expf(s * scale + bias - m) / l, ds = p * (dp - D) * scale with D =
// rowsum(dO * O) (4 threads a row over every 4th column, then two shuffles),
// bias -1e9 (masked) / -inf (past S); dq, dk, dv are fmaf chains over the
// walked rows in order; the column partials sum each thread's 4 rows, then
// the 16 thread rows in order; no float atomics.  fmaf(a, b, c) = fmaf(b, a,
// c), so the dK / dV kernel's s^T and dp^T are the dQ kernel's s and dp bit
// for bit, and so is ds.  dq's chain runs over the keys up to SP, past the
// recomputing kernel's last key tile: those keys have k = 0 and ds = +-0, and
// an fmaf chain started at +0 is never -0, so each such term leaves it as it
// was.

constexpr int F32_TL = 64;            // rows a block owns
constexpr int F32_BWD_THREADS = 256;  // a 16 x 16 grid
constexpr int F32_DQ_WALK = 32;       // keys per walked tile of the dQ kernel
constexpr int F32_DQ_THREADS = 128;   // the dQ kernel's 8 x 16 grid
constexpr int F32_DQ_BLOCKS = 3;      // dQ blocks resident per SM

// The ds scratch's row pitch: S rounded up to the owned tiles (so a multiple
// of F32_DQ_WALK too).
__host__ __device__ __forceinline__ int f32_ds_pitch(int S) {
  return (S + F32_TL - 1) / F32_TL * F32_TL;
}

template <int DP>
struct BwdF32Smem {  // byte offsets of the dK / dV kernel's shared-memory regions
  static constexpr int TW = DP == 128 ? 32 : 64;  // walked rows per tile
  static constexpr int LD = DP + 4;               // io tile pitch (floats)
  static constexpr int LP = TW + 8;               // p / ds tile pitch
  static constexpr int OWN = 0;                                // two owned [64][LD] tiles
  static constexpr int RING = OWN + 2 * F32_TL * LD * 4;       // 2 stages x 2 walked [TW][LD]
  static constexpr int PT = RING + 4 * TW * LD * 4;            // p and ds [64][LP]
  static constexpr int VEC = PT + 2 * F32_TL * LP * 4;         // 2 stages x [3][TW] fp32
  static constexpr int RED = VEC + 2 * 3 * TW * 4;             // [16][DP] column sums
  static constexpr int BYTES = RED + 16 * DP * 4;
};

template <int DP>
struct DqF32Smem {  // byte offsets of the dQ kernel's shared-memory regions
  static constexpr int TW = F32_DQ_WALK;          // keys per walked tile
  static constexpr int LD = DP + 4;               // k tile pitch (floats)
  static constexpr int LP = TW + 8;               // ds tile pitch
  static constexpr int DS = 0;                                 // 2 stages x ds [64][LP]
  static constexpr int KT = DS + 2 * F32_TL * LP * 4;          // 2 stages x k [TW][LD]
  static constexpr int BYTES = KT + 2 * TW * LD * 4;           // then dq [64][DP] for the sums
  static_assert(BYTES >= F32_TL * DP * 4, "the dq tile must fit in the ring");
};

// Rows [r0, r0 + ROWS) x d columns of one head (row stride rs) ->
// dst[ROWS][DP + 4], zero filled past S and past d: 16-byte cp.async copies
// when ``vec``, else element loads and stores (visible after the next
// barrier either way).
template <int DP, int ROWS, int THREADS = F32_BWD_THREADS>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src, long long rs, int r0,
                                              int S, int d, bool vec, float* dst) {
  constexpr int LD = DP + 4;
  if (vec) {
    constexpr int CPR = DP / 4;
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
      const int row = c / CPR, col = (c % CPR) * 4;
      const bool ok = r0 + row < S && col < d;
      cp_async16(smem_u32(dst + row * LD + col), ok ? src + (r0 + row) * rs + col : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int row = i / DP, col = i % DP;
      dst[row * LD + col] = (r0 + row < S && col < d) ? src[(r0 + row) * rs + col] : 0.0f;
    }
  }
}

// s[i][j] = own0[r + 16 i] . walk0[c + 16 j] and dp[i][j] = own1[r + 16 i] .
// walk1[c + 16 j] over the padded head dim, each an fmaf chain in k order.
template <int DP, int NJ>
__device__ __forceinline__ void scores_f32(const float* own0, const float* own1,
                                           const float* walk0, const float* walk1, int r, int c,
                                           float (&s)[4][NJ], float (&dp)[4][NJ]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < DP; k += 4) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* own = pass ? own1 : own0;
      const float* walk = pass ? walk1 : walk0;
      float4 a[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(own + (r + 16 * i) * LD + k);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        w[j] = *reinterpret_cast<const float4*>(walk + (c + 16 * j) * LD + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float& t = pass ? dp[i][j] : s[i][j];
          t = fmaf(a[i].x, w[j].x, t);
          t = fmaf(a[i].y, w[j].y, t);
          t = fmaf(a[i].z, w[j].z, t);
          t = fmaf(a[i].w, w[j].w, t);
        }
    }
  }
}

// acc[i][jj][h] += sum over walked rows t of X[r + RS i][t] * W[t][2c + 32 jj + h]
// (i < RI), in t order: X a [64][TW + 8] p / ds tile, W a walked [TW][DP + 4] tile.
template <int DP, int TW, int RI = 4, int RS = 16>
__device__ __forceinline__ void accum_f32(const float* X, const float* W, int r, int c,
                                          float (&acc)[RI][DP / 32][2]) {
  constexpr int LD = DP + 4, LP = TW + 8, NC = DP / 32;
#pragma unroll 2
  for (int t = 0; t < TW; t += 4) {
    float4 x4[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) x4[i] = *reinterpret_cast<const float4*>(X + (r + RS * i) * LP + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float2 w = *reinterpret_cast<const float2*>(W + (t + u) * LD + 2 * c + 32 * jj);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float x = u == 0 ? x4[i].x : u == 1 ? x4[i].y : u == 2 ? x4[i].z : x4[i].w;
          acc[i][jj][0] = fmaf(x, w.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(x, w.y, acc[i][jj][1]);
        }
      }
    }
  }
}

// Rows r0 + r + 16 i (< S), columns < d of a thread's accumulator into one head
// (row stride rs) and, with dst_sum, the column sums over the tile's valid
// rows: each thread's 4 rows, then the 16 thread rows in order (red [16][DP]).
template <int NC>
__device__ __forceinline__ void write_grad_f32(const float (&acc)[4][NC][2], float* dst,
                                               long long rs, int r0, int S, int d, int r, int c,
                                               float* red, float* dst_sum) {
  constexpr int DP = NC * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + r + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 2 * c + 32 * jj + h;
        if (col < d) dst[row * rs + col] = acc[i][jj][h];
      }
  }
  if (!dst_sum) return;
  __syncthreads();  // red is free (a previous call's readers are done)
#pragma unroll
  for (int jj = 0; jj < NC; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + r + 16 * i < S) s += acc[i][jj][h];
      red[r * DP + 2 * c + 32 * jj + h] = s;
    }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += F32_BWD_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 16; ++w) s += red[w * DP + col];
    dst_sum[col] = s;
  }
}

// D = rowsum(dO * O) of 64 rows of one (batch, head): 4 threads a row over
// every 4th column, then two shuffles.
__global__ void __launch_bounds__(F32_BWD_THREADS)
flash_bwd_rowterm_f32_kernel(Mat<const float> O, Mat<const float> dO, float* __restrict__ Dg,
                             int S, int nh, int d) {
  const int lr = threadIdx.x / 4, row = blockIdx.x * F32_TL + lr;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* ob = O.head(b, h);
  const float* gb = dO.head(b, h);
  float s = 0.0f;
  if (row < S)
    for (int col = threadIdx.x % 4; col < d; col += 4)
      s += gb[row * dO.sr + col] * ob[row * O.sr + col];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (threadIdx.x % 4 == 0 && row < S) Dg[((size_t)b * nh + h) * S + row] = s;
}

// dQ of 64 query rows of one (batch, head) from the ds * scale the dK / dV
// kernel stored (dsg [B, nh, S, SP]): dq += ds . k over the keys in order.
// Thread (g, c) of the 8 x 16 grid (g = tid / 16, c = tid % 16) owns rows
// g + 8 i (i < 8) and columns 2c + 32 jj + {0, 1}; the column partials go
// through a [64][DP] tile in the 16 x 16 kernels' order.
template <int DP>
__global__ void __launch_bounds__(F32_DQ_THREADS, F32_DQ_BLOCKS)
flash_bwd_dq_f32_kernel(const float* __restrict__ dsg, Mat<const float> K, Mat<float> dQg,
                        float* __restrict__ colpart, int S, int SP, int nh, int d) {
  using L = DqF32Smem<DP>;
  constexpr int TW = L::TW, LD = L::LD, LP = L::LP, NC = DP / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* dss = reinterpret_cast<float*>(smem_raw + L::DS);   // stage st at st * 64 * LP
  float* kts = reinterpret_cast<float*>(smem_raw + L::KT);   // stage st at st * TW * LD

  const int g = threadIdx.x / 16;
  const int c = threadIdx.x % 16;
  const int q0 = blockIdx.x * F32_TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = K.head(b, h);
  const float* dsb = dsg + ((size_t)b * nh + h) * S * SP;
  const bool k_vec = vec16(kb, K.sr, d);
  // The ds rows [q0, q0 + 64) x keys [k0, k0 + TW), zero past S, and the k tile.
  auto load = [&](int k0, int st) {
    float* dst = dss + st * F32_TL * LP;
    for (int i = threadIdx.x; i < F32_TL * (TW / 4); i += F32_DQ_THREADS) {
      const int row = i / (TW / 4), col = i % (TW / 4) * 4;
      const bool ok = q0 + row < S;
      const float* src = ok ? dsb + (size_t)(q0 + row) * SP + k0 + col : dsb;
      cp_async16(smem_u32(dst + row * LP + col), src, ok);
    }
    load_tile_f32<DP, TW, F32_DQ_THREADS>(kb, K.sr, k0, S, d, k_vec, kts + st * TW * LD);
  };

  load(0, 0);
  cp_async_commit();
  float dq[8][NC][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) dq[i][jj][0] = dq[i][jj][1] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  const int ntiles = SP / TW;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) load((it + 1) * TW, st ^ 1);
    cp_async_commit();
    accum_f32<DP, TW, 8, 8>(dss + st * F32_TL * LP, kts + st * TW * LD, g, c, dq);  // += ds . k
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one
  }

  float* dqb = dQg.head(b, h);
  float* T = reinterpret_cast<float*>(smem_raw);  // dq [64][DP], over the ring
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + g + 8 * i;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 2 * c + 32 * jj + hh;
        if (row < S && col < d) dqb[row * dQg.sr + col] = dq[i][jj][hh];
        T[(g + 8 * i) * DP + col] = dq[i][jj][hh];
      }
  }
  if (!colpart) return;
  __syncthreads();
  // Each thread row r's rows r + 16 i (i < 4) summed, then r = 0..15 in order.
  float* dst = colpart + ((size_t)b * gridDim.x + blockIdx.x) * (3LL * nh * d) + (size_t)h * d;
  for (int col = threadIdx.x; col < d; col += F32_DQ_THREADS) {
    float total = 0.0f;
    for (int r = 0; r < 16; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q0 + r + 16 * i < S) s += T[(r + 16 * i) * DP + col];
      total += s;
    }
    dst[col] = total;
  }
}

// dK and dV of 64 key rows of one (batch, head), after flash_bwd_rowterm_f32_kernel
// (D); stores ds * scale of those keys and every query row to dsg [B, nh, S, SP].
template <int DP>
__global__ void __launch_bounds__(F32_BWD_THREADS, 1)
flash_bwd_dkdv_f32_kernel(Mat<const float> Q, Mat<const float> K, Mat<const float> V,
                          Mat<const float> dO, Mask mask, const float* __restrict__ stats,
                          const float* __restrict__ Dg, Mat<float> dKg, Mat<float> dVg,
                          float* __restrict__ dsg, float* __restrict__ colpart, int S, int SP,
                          int nh, int d, float scale) {
  using L = BwdF32Smem<DP>;
  constexpr int TW = L::TW, LD = L::LD, LP = L::LP, NJ = TW / 16, NC = DP / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw + L::OWN);
  float* Vs = Ks + F32_TL * LD;
  float* ring = reinterpret_cast<float*>(smem_raw + L::RING);  // stage st: q, dO at 2st, 2st+1
  float* Ps = reinterpret_cast<float*>(smem_raw + L::PT);
  float* dSs = Ps + F32_TL * LP;
  float* vecs = reinterpret_cast<float*>(smem_raw + L::VEC);   // stage st: m, l, D of TW rows
  float* red = reinterpret_cast<float*>(smem_raw + L::RED);

  const int r = threadIdx.x / 64 * 4 + threadIdx.x % 32 / 8;
  const int c = threadIdx.x / 32 % 2 * 8 + threadIdx.x % 8;
  const int k0 = blockIdx.x * F32_TL;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = Q.head(b, h);
  const float* gb = dO.head(b, h);
  const float* kh = K.head(b, h);
  const float* vh = V.head(b, h);
  const int* mrow = mask.row(b);
  const size_t srow = ((size_t)b * nh + h) * S;
  float* dsb = dsg + srow * SP + k0;  // this head's ds rows, from key k0
  const bool qg_vec = vec16(qb, Q.sr, d) && vec16(gb, dO.sr, d);
  auto stage = [&](int st, int which) { return ring + (2 * st + which) * TW * LD; };
  auto load_qg = [&](int q0, int st) {
    load_tile_f32<DP, TW>(qb, Q.sr, q0, S, d, qg_vec, stage(st, 0));
    load_tile_f32<DP, TW>(gb, dO.sr, q0, S, d, qg_vec, stage(st, 1));
  };
  // m, l and D of query row q (0, inf, 0 past S: then p = 0 and ds = 0).
  auto row_vec = [&](int q, float& m, float& l, float& D) {
    const bool ok = q < S;
    m = ok ? stats[(srow + q) * 2] : 0.0f;
    l = ok ? stats[(srow + q) * 2 + 1] : INFINITY;
    D = ok ? Dg[srow + q] : 0.0f;
  };
  auto put_vec = [&](int st, float m, float l, float D) {
    float* v = vecs + st * 3 * TW;
    v[threadIdx.x] = m;
    v[TW + threadIdx.x] = l;
    v[2 * TW + threadIdx.x] = D;
  };

  load_tile_f32<DP, F32_TL>(kh, K.sr, k0, S, d, vec16(kh, K.sr, d), Ks);
  load_tile_f32<DP, F32_TL>(vh, V.sr, k0, S, d, vec16(vh, V.sr, d), Vs);
  load_qg(0, 0);
  cp_async_commit();
  if (threadIdx.x < TW) {
    float m, l, D;
    row_vec(threadIdx.x, m, l, D);
    put_vec(0, m, l, D);
  }
  float kb_r[4];  // the key bias of this thread's 4 key rows
#pragma unroll
  for (int i = 0; i < 4; ++i) kb_r[i] = key_bias(mrow, k0 + r + 16 * i, S);
  cp_async_wait_all();
  __syncthreads();

  float dk[4][NC][2], dv[4][NC][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) dk[i][jj][0] = dk[i][jj][1] = dv[i][jj][0] = dv[i][jj][1] = 0.0f;

  const int ntiles = (S + TW - 1) / TW;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const bool next = it + 1 < ntiles;
    float nm = 0.0f, nl = 0.0f, nD = 0.0f;  // the next tile's row vectors, stored after the products
    if (next) {
      load_qg((it + 1) * TW, st ^ 1);
      if (threadIdx.x < TW) row_vec((it + 1) * TW + threadIdx.x, nm, nl, nD);
    }
    cp_async_commit();

    // s^T = k . q^T and dp^T = v . dO^T: rows are keys, columns queries.
    const float* qs = stage(st, 0);
    const float* gs = stage(st, 1);
    float s[4][NJ], dp[4][NJ];
    scores_f32<DP, NJ>(Ks, Vs, qs, gs, r, c, s, dp);
    const float* vm = vecs + st * 3 * TW;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int q = c + 16 * j;
      const float m = vm[q], l = vm[TW + q], D = vm[2 * TW + q];
      const bool keep = it * TW + q < S;  // the scratch has S query rows
      float* dsq = dsb + (size_t)(keep ? it * TW + q : 0) * SP + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][j] * scale + kb_r[i] - m) / l;
        const float ds = p * (dp[i][j] - D) * scale;
        Ps[(r + 16 * i) * LP + q] = p;
        dSs[(r + 16 * i) * LP + q] = ds;
        if (keep) __stcs(dsq + 16 * i, ds);  // read once, by the dQ kernel
      }
    }
    __syncthreads();  // the p and ds tiles are whole
    accum_f32<DP, TW>(Ps, gs, r, c, dv);   // dv += p^T . dO
    accum_f32<DP, TW>(dSs, qs, r, c, dk);  // dk += ds^T . q

    if (next && threadIdx.x < TW) put_vec(st ^ 1, nm, nl, nD);
    cp_async_wait_all();
    __syncthreads();
  }

  const long long cps = 3LL * nh * d;
  const long long H = (long long)nh * d;
  float* cp = colpart ? colpart + ((size_t)b * gridDim.x + blockIdx.x) * cps + (size_t)h * d
                      : nullptr;
  write_grad_f32<NC>(dk, dKg.head(b, h), dKg.sr, k0, S, d, r, c, red, cp ? cp + H : nullptr);
  write_grad_f32<NC>(dv, dVg.head(b, h), dVg.sr, k0, S, d, r, c, red, cp ? cp + 2 * H : nullptr);
}

// ---- fp32 forward kernel (CUDA cores) ---------------------------------------------
//
// What bounds it is the CUDA cores' fp32 rate (67 TFLOP/s on an H100 SXM): at
// B 16 x S 560 x 8 x 96 its two [S, S, d] products are 1.5e10 FLOP (0.23 ms)
// against 0.1 GB of q, k, v and o.  So, as in the fp32 backward, the design
// keeps the FMA pipes fed from registers.  A block of 256 threads owns BM =
// 16 TM query rows of one (batch, head) and walks the keys in tiles of BN
// (64; 32 at d 128, where two 64-key stages do not fit beside the q tile).
// Thread (r, c) (warp w, lane l: r = 2 w + l / 16, c = l % 16; the 16 lanes
// of a half-warp share r) owns rows r + 16 i (i < TM): of each score tile
// the keys c + 16 j (a TM x BN/16 register micro-tile), of the output the
// columns 4c + 64 jj + {0..3} (jj < d / 64) and, at d 32 and 96, 64 (d / 64)
// + 2c + {0, 1}, in registers for the whole walk.
//   - s = q . k^T runs over d in float4 steps: TM q rows (one address per
//     half-warp, a broadcast) and BN/16 k rows (16 rows at an odd 16-byte
//     pitch LD = DP + 4: one wavefront per quarter-warp) per step, 4 TM BN/16
//     FMAs for TM + BN/16 loads.
//   - The online softmax stays in registers, in log2 units: t = s * (scale
//     log2 e) + bias log2 e as one fmaf, the row max over the half-warp by
//     four shuffles, p = exp2f(t - m2).  The stats keep their contract: m =
//     m2 ln 2 is in natural-log units of s * scale + bias (the fp32 backward
//     reads p = expf(s * scale + bias - m) / l); it differs from that row max
//     by about one rounding, so the backward's p sums to 1 within ~|m| 2^-23.
//     A fully masked row (every t = -1e9 log2 e in fp32, one ulp there 128)
//     gets m = -1e9 exactly and l = S: the backward's p = 1 / S, as the
//     forward's uniform softmax.
//   - p goes to shared memory ([BM][BN + 16]: the two rows a warp writes lie
//     16 banks apart) only as the A operand of o += p . v, read back as
//     float4 along the keys (a broadcast per half-warp) beside float4 /
//     float2 reads of a v row (contiguous across the half-warp).
//   - k, v and the tile's key bias come by 16-byte cp.async into a two-stage
//     ring, the next tile's copy running under this tile's products; the q
//     tile is copied once.  Two barriers a tile (p whole; ring and p free).
// BM is 112 (TM 7) where that pads S to fewer rows than 128 (S 560 = 5 x
// 112), else 128 (S 512 = 4 x 128): _build.flash_fwd_f32_rows repeats the
// rule.  One block per SM (195 KB of shared memory at d 96); the lab grid is
// 640 blocks, 4.85 waves on 132 SMs, the text grid (B 32 x 12 heads, S 512)
// 1536.  Numerics: each score is an fmaf chain over the head dim in order,
// each output an fmaf chain over the keys in order, l the sum of each
// thread's p then of the 16 lanes in a fixed order, o / l once at the end:
// IEEE fp32 (no TF32), the same bits every run; only the summation order
// differs from the plain version.

constexpr int F32_FWD_THREADS = 256;  // 16 row groups (two a warp) x 16 lanes
constexpr float LN2 = 0.6931471805599453f;
static_assert(F32_FWD_THREADS == F32_BWD_THREADS, "load_tile_f32 strides by the block size");

template <int DP, int TM>
struct FwdF32Smem {  // byte offsets of the shared-memory regions
  static constexpr int BM = 16 * TM;                // query rows a block owns
  static constexpr int BN = DP == 128 ? 32 : 64;    // keys per tile
  static constexpr int LD = DP + 4;                 // q / k / v tile pitch (floats)
  static constexpr int LP = BN + 16;                // p tile pitch
  static constexpr int Q = 0;                       // [BM][LD]
  static constexpr int RING = Q + BM * LD * 4;      // 2 stages x (k, v) [BN][LD]
  static constexpr int P = RING + 4 * BN * LD * 4;  // [BM][LP]
  static constexpr int BIAS = P + BM * LP * 4;      // 2 stages x [BN] key bias
  static constexpr int BYTES = BIAS + 2 * BN * 4;
};

// Rows per block of the fp32 forward (16 TM): 112 where that pads S to fewer
// rows than 128, else 128.
int f32_fwd_tm(int S) { return (S + 111) / 112 * 112 < (S + 127) / 128 * 128 ? 7 : 8; }

template <int DP, int TM>
__global__ void __launch_bounds__(F32_FWD_THREADS, 1)
flash_attn_fwd_f32_kernel(Mat<const float> Q, Mat<const float> K, Mat<const float> V, Mask mask,
                          Mat<float> O, float* __restrict__ stats, int S, int nh, int d,
                          float scale) {
  static_assert(DP % 32 == 0 && DP <= 128, "head dim pad");
  using L = FwdF32Smem<DP, TM>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LP = L::LP, TN = BN / 16;
  constexpr int NQ = DP / 64;          // float4 output groups of a row
  constexpr bool H2 = DP % 64 == 32;   // and one float2 group
  constexpr int NO = DP / 16;          // output columns of a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + L::Q);
  float* ring = reinterpret_cast<float*>(smem_raw + L::RING);  // stage st: k, v at 2st, 2st+1
  float* Ps = reinterpret_cast<float*>(smem_raw + L::P);
  float* kbias = reinterpret_cast<float*>(smem_raw + L::BIAS);  // stage st at st * BN

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 2 * warp + lane / 16;
  const int c = lane % 16;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = Q.head(b, h);
  const float* kb = K.head(b, h);
  const float* vb = V.head(b, h);
  const int* mrow = mask.row(b);
  const bool kv_vec = vec16(kb, K.sr, d) && vec16(vb, V.sr, d);
  auto stage = [&](int st, int which) { return ring + (2 * st + which) * BN * LD; };
  auto load_kv = [&](int k0, int st) {
    load_tile_f32<DP, BN>(kb, K.sr, k0, S, d, kv_vec, stage(st, 0));
    load_tile_f32<DP, BN>(vb, V.sr, k0, S, d, kv_vec, stage(st, 1));
  };

  load_tile_f32<DP, BM>(qb, Q.sr, q0, S, d, vec16(qb, Q.sr, d), Qs);
  load_kv(0, 0);
  cp_async_commit();
  if (threadIdx.x < BN) kbias[threadIdx.x] = key_bias(mrow, threadIdx.x, S) * LOG2E;
  cp_async_wait_all();
  __syncthreads();

  const float scale2 = scale * LOG2E;  // scores in log2 units
  float o[TM][NO];     // row r + 16 i: columns 4c + 64 jj + e, then 64 NQ + 2c + e
  float m_r[TM], l_r[TM];  // running max (log2 units) and this thread's share of the sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.0f;
  }

  const int ntiles = (S + BN - 1) / BN;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const bool next = it + 1 < ntiles;
    float nbias = 0.0f;  // the next tile's key bias, stored after this tile's products
    if (next) {
      load_kv((it + 1) * BN, st ^ 1);
      if (threadIdx.x < BN) nbias = key_bias(mrow, (it + 1) * BN + threadIdx.x, S) * LOG2E;
    }
    cp_async_commit();

    // s = q . k^T over the padded head dim, each an fmaf chain in order.
    const float* ks = stage(st, 0);
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < DP; k += 4) {
      float4 kv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (c + 16 * j) * LD + k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r + 16 * i) * LD + k);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // Scale and key bias (in log2 units), then the online softmax.
    const float* kbs = kbias + st * BN;
    float kbj[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) kbj[j] = kbs[c + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(s[i][j], scale2, kbj[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_r[i], fm::half_warp_max(mx));  // finite: a key < S per tile
      const float alpha = exp2f(m_r[i] - m_new);                 // 0 on the first tile
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        l_r[i] += p;
        Ps[(r + 16 * i) * LP + c + 16 * j] = p;
      }
    }
    __syncthreads();  // the p tile is whole

    // o += p . v, each output an fmaf chain over the keys in order.
    const float* vs = stage(st, 1);
#pragma unroll 2
    for (int t = 0; t < BN; t += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (r + 16 * i) * LP + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (t + u) * LD;
        float w[NO];
#pragma unroll
        for (int jj = 0; jj < NQ; ++jj) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + 64 * jj + 4 * c);
          w[4 * jj] = t4.x;
          w[4 * jj + 1] = t4.y;
          w[4 * jj + 2] = t4.z;
          w[4 * jj + 3] = t4.w;
        }
        if constexpr (H2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vrow + 64 * NQ + 2 * c);
          w[4 * NQ] = t2.x;
          w[4 * NQ + 1] = t2.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int n = 0; n < NO; ++n) o[i][n] = fmaf(p, w[n], o[i][n]);
        }
      }
    }

    if (next && threadIdx.x < BN) kbias[(st ^ 1) * BN + threadIdx.x] = nbias;
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one (and with p)
  }

  float* ob = O.head(b, h);
  const bool o_vec = vec16(ob, O.sr, d);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float l = fm::half_warp_sum(l_r[i]);
    const int row = q0 + r + 16 * i;
    if (row >= S) continue;
    if (stats && c == 0) {
      float* sp = stats + (((size_t)b * nh + h) * S + row) * 2;
      sp[0] = m_r[i] * LN2;  // natural-log units, the backward's contract
      sp[1] = l;
    }
    float* dst = ob + row * O.sr;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] /= l;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const int col = 64 * jj + 4 * c;
      if (o_vec && col + 4 <= d) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(o[i][4 * jj], o[i][4 * jj + 1], o[i][4 * jj + 2], o[i][4 * jj + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) dst[col + e] = o[i][4 * jj + e];
      }
    }
    if constexpr (H2) {
      const int col = 64 * NQ + 2 * c;
      if (o_vec && col + 2 <= d) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(o[i][4 * NQ], o[i][4 * NQ + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < d) dst[col + e] = o[i][4 * NQ + e];
      }
    }
  }
}


// ---- host-side operands and dispatch -------------------------------------------------

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

struct BwdArgs {
  Op q, k, v, o, dout, dq, dk, dv;
  Mask mask;
  const float* stats;
  float* D;
  float* ds;  // fp32: the [B, nh, S, f32_ds_pitch(S)] ds scratch
  float* colpart;
  int B, S, nh, d;
  float scale;
};

// The padded head dim of d (0 when d is outside 1..128).
int head_pad(int d) {
  if (d < 1 || d > 128) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
}

// The TMA map of one [B, heads, S, d] bf16 operand over its own strides:
// dims (d, S, heads, B), boxes of [rows][32] with the 64-byte swizzle; reads
// past d or past S inside a head give zeros.  A dim of size 1 takes a stride
// TMA accepts whatever the tensor's (_build.tma_compatible ignores it too).
bool head_map(CUtensorMap* map, const Op& o, int B, int S, int nh, int d, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const long long sr = S > 1 ? o.sr * 2 : (d * 2 + 15) / 16 * 16;
  const long long sh = nh > 1 ? o.sh * 2 : sr * S;
  const long long sb = B > 1 ? o.sb * 2 : sh * nh;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)nh, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sr, (cuuint64_t)sh, (cuuint64_t)sb};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(o.p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BN>
cudaError_t launch_fwd_wgmma(const FwdArgs& a, cudaStream_t s) {
  using L = FwdLayout<DP, BN>;
  const int nrb = (a.S + FA_CONSUMERS * FA_ROWS - 1) / (FA_CONSUMERS * FA_ROWS);
  const int items = a.B * a.nh * nrb;
  if (items == 0) return cudaSuccess;
  // Set on every launch: the attribute belongs to the current device, and
  // the call costs about a microsecond.  It also makes the device's context
  // current in this thread (the autograd engine runs a backward in its own),
  // which the tensor-map encoding below needs.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_wgmma_kernel<DP, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = sm_count(sms);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, a.q, a.B, a.S, a.nh, a.d, FA_ROWS) ||
      !head_map(&tk, a.k, a.B, a.S, a.nh, a.d, BN) || !head_map(&tv, a.v, a.B, a.S, a.nh, a.d, BN))
    return cudaErrorInvalidValue;
  flash_attn_fwd_wgmma_kernel<DP, BN><<<sms < items ? sms : items, FA_THREADS, L::BYTES, s>>>(
      tq, tk, tv, a.mask, as_mat<fm_bf16>(a.o), a.stats, a.S, a.nh, a.d, a.scale, nrb, items);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wgmma_dp(const FwdArgs& a, cudaStream_t s) {
  return fwd_bn(a.S) == FWD_BN_NARROW ? launch_fwd_wgmma<DP, FWD_BN_NARROW>(a, s)
                                      : launch_fwd_wgmma<DP, FWD_BN_WIDE>(a, s);
}

template <int DP, int TM>
cudaError_t launch_f32_tm(const FwdArgs& a, cudaStream_t stream) {
  constexpr int bytes = FwdF32Smem<DP, TM>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_f32_kernel<DP, TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);  // per device, as above
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + 16 * TM - 1) / (16 * TM), a.nh, a.B);
  flash_attn_fwd_f32_kernel<DP, TM><<<grid, F32_FWD_THREADS, bytes, stream>>>(
      as_mat<const float>(a.q), as_mat<const float>(a.k), as_mat<const float>(a.v), a.mask,
      as_mat<float>(a.o), a.stats, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_dp(const FwdArgs& a, cudaStream_t s) {
  return f32_fwd_tm(a.S) == 7 ? launch_f32_tm<DP, 7>(a, s) : launch_f32_tm<DP, 8>(a, s);
}

cudaError_t launch_fwd(const FwdArgs& a, int dtype, cudaStream_t s) {
  const bool bf16 = dtype == FM_BF16;
  if (!bf16 && dtype != FM_F32) return cudaErrorInvalidValue;
  switch (head_pad(a.d)) {
    case 32: return bf16 ? launch_wgmma_dp<32>(a, s) : launch_f32_dp<32>(a, s);
    case 64: return bf16 ? launch_wgmma_dp<64>(a, s) : launch_f32_dp<64>(a, s);
    case 96: return bf16 ? launch_wgmma_dp<96>(a, s) : launch_f32_dp<96>(a, s);
    case 128: return bf16 ? launch_wgmma_dp<128>(a, s) : launch_f32_dp<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Both backward kernels in order: the dQ kernel writes D, the dK / dV kernel
// reads it.
template <int DP>
cudaError_t launch_bwd_wgmma(const BwdArgs& a, cudaStream_t s) {
  constexpr int rows = FA_CONSUMERS * BWD_TILE;
  if (a.B == 0 || a.nh == 0) return cudaSuccess;
  // The attributes first: they make the context current for the maps (as in
  // the forward; the autograd engine calls this from its own thread).
  constexpr int dq_bytes = BwdLayout<DP, 3>::BYTES, dkdv_bytes = BwdLayout<DP, 2>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, to, tg;
  if (!head_map(&tq, a.q, a.B, a.S, a.nh, a.d, BWD_TILE) ||
      !head_map(&tk, a.k, a.B, a.S, a.nh, a.d, BWD_TILE) ||
      !head_map(&tv, a.v, a.B, a.S, a.nh, a.d, BWD_TILE) ||
      !head_map(&to, a.o, a.B, a.S, a.nh, a.d, BWD_TILE) ||
      !head_map(&tg, a.dout, a.B, a.S, a.nh, a.d, BWD_TILE))
    return cudaErrorInvalidValue;
  const dim3 grid((a.S + rows - 1) / rows, a.nh, a.B);
  flash_bwd_dq_wgmma_kernel<DP><<<grid, FA_THREADS, dq_bytes, s>>>(
      tq, tk, tv, to, tg, a.mask, a.stats, a.D, as_mat<fm_bf16>(a.dq), a.colpart, a.S, a.nh, a.d,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma_kernel<DP><<<grid, FA_THREADS, dkdv_bytes, s>>>(
      tq, tk, tv, tg, a.mask, a.stats, a.D, as_mat<fm_bf16>(a.dk), as_mat<fm_bf16>(a.dv),
      a.colpart, a.S, a.nh, a.d, a.scale);
  return cudaGetLastError();
}

// The three fp32 launches in order: D, then dK / dV (which stores ds), then dQ.
template <int DP>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t s) {
  if (a.B == 0 || a.nh == 0) return cudaSuccess;
  if (a.ds == nullptr) return cudaErrorInvalidValue;
  constexpr int bytes = BwdF32Smem<DP>::BYTES, dq_bytes = DqF32Smem<DP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (e != cudaSuccess) return e;
  // All of the SM's unified memory as shared, so F32_DQ_BLOCKS blocks fit.
  e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DP>,
                           cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + F32_TL - 1) / F32_TL, a.nh, a.B);
  const int SP = f32_ds_pitch(a.S);
  flash_bwd_rowterm_f32_kernel<<<grid, F32_BWD_THREADS, 0, s>>>(
      as_mat<const float>(a.o), as_mat<const float>(a.dout), a.D, a.S, a.nh, a.d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32_kernel<DP><<<grid, F32_BWD_THREADS, bytes, s>>>(
      as_mat<const float>(a.q), as_mat<const float>(a.k), as_mat<const float>(a.v),
      as_mat<const float>(a.dout), a.mask, a.stats, a.D, as_mat<float>(a.dk),
      as_mat<float>(a.dv), a.ds, a.colpart, a.S, SP, a.nh, a.d, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_f32_kernel<DP><<<grid, F32_DQ_THREADS, dq_bytes, s>>>(
      a.ds, as_mat<const float>(a.k), as_mat<float>(a.dq), a.colpart, a.S, SP, a.nh, a.d);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int dtype, cudaStream_t s) {
  const bool bf16 = dtype == FM_BF16;
  if (!bf16 && dtype != FM_F32) return cudaErrorInvalidValue;
  switch (head_pad(a.d)) {
    case 32: return bf16 ? launch_bwd_wgmma<32>(a, s) : launch_bwd_f32<32>(a, s);
    case 64: return bf16 ? launch_bwd_wgmma<64>(a, s) : launch_bwd_f32<64>(a, s);
    case 96: return bf16 ? launch_bwd_wgmma<96>(a, s) : launch_bwd_f32<96>(a, s);
    case 128: return bf16 ? launch_bwd_wgmma<128>(a, s) : launch_bwd_f32<128>(a, s);
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
// dim contiguous; bf16 q, k, v with a 16-byte aligned base and strides of a
// multiple of 8 elements, as TMA reads them); mask [B, S] int32 with batch
// stride mask_sb and key stride 1, or null (every key attends); d <= 128.
// stats [B, nh, S, 2] fp32 (contiguous) receives each row's softmax max and
// sum when not null.
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
// #3 / #6 with colpart), two launches in bf16, three in fp32: q, k, v, o,
// dout (dO, io dtype) as in fm_flash_attention_fwd (in bf16 o and dout as
// TMA reads them too), stats from it; D [B, nh, S] fp32 scratch; ds (fp32
// only, else ignored) [B, nh, S, SP] fp32 scratch, SP = S rounded up to 64
// (_build.flash_bwd_f32_scratch); writes dq, dk, dv (strided, io dtype) and,
// when colpart is not null, the column partials [B * ceil(S / tile), 3 * nh *
// d] fp32 of the fp32 dq | dk | dv, tile = 64 (_build.FLASH_BWD_TILE).
int fm_flash_attention_bwd(const void* q, const long long* qs, const void* k,
                           const long long* ks, const void* v, const long long* vs,
                           const void* o, const long long* os, const void* dout,
                           const long long* dos, const void* mask, long long mask_sb,
                           const void* stats, void* D, void* dq, const long long* dqs, void* dk,
                           const long long* dks, void* dv, const long long* dvs, void* colpart,
                           void* ds, int B, int S, int nh, int d, float scale, int dtype,
                           void* stream) {
  const BwdArgs a{strided(q, qs), strided(k, ks), strided(v, vs), strided(o, os),
                  strided(dout, dos), strided(dq, dqs), strided(dk, dks), strided(dv, dvs),
                  Mask{static_cast<const int*>(mask), mask_sb},
                  static_cast<const float*>(stats), static_cast<float*>(D),
                  static_cast<float*>(ds), static_cast<float*>(colpart), B, S, nh, d, scale};
  return launch_bwd(a, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
