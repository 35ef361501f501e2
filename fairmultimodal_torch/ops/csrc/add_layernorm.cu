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
// Forward design: one warp per row; each lane holds NC chunks of 8
// consecutive elements in registers (H % 8 == 0, H <= 1024), loaded and
// stored 16 bytes at a time, and draws one Philox block per 4 elements (one
// call gives the 4 words of a counter).
//
// Backward design (layernorm_bwd_kernel, redesigned for the H100).  What it
// must keep, bit for bit, is its order: lane l holds chunks l + 32 j of a
// row and sums them serially in (j, k) order before fm::warp_sum's
// butterfly; dz = rstd * fma(-xhat, m2, fma(g, gamma, -m1)), the sums of
// (z - mu)^2 and g*gamma*xhat as fma chains, g*gamma rounded into m1's sum
// (the parent's contraction, written out with intrinsics so no compiler
// choice moves it); the rows of a 64-row unit are summed into its partials
// by warp w over rows w, w + 8, ..., w + 56 in order (g*xhat as an fma
// chain), then the 8 warps are added in warp order.  How the rows reach
// the SM is new:
//   - persistent: SMs x (blocks an SM) blocks, each walking the units
//     blockIdx.x, blockIdx.x + gridDim.x, ... (the [3, ceil(R / 64), H]
//     partials layout is the parent's);
//   - each warp keeps its three column partials in its own shared-memory
//     slice (3 x H fp32), which only its own lanes touch until the unit's
//     flush, so the partials hold no registers; the flush adds the 8
//     slices in warp order and clears them;
//   - each warp brings its next row by 16-byte cp.async into its own shared
//     ring row while it reduces the current one from registers (the next
//     unit's first rows are in flight across the flush): g and z of a bf16
//     row; z alone of an fp32 row, whose g the warp loads a row ahead into
//     registers, each chunk as soon as the current row is done with it (its
//     dz, da and partials), so it is in flight across the rest of the row.
//     Gamma is staged once a block.  Shared rows of 4-byte
//     values keep the two halves of a chunk H / 2 apart, so each warp-wide
//     16-byte access is contiguous.
//   Shared memory a block: 8 x 3 x H x 4 (slices) + H x 4 (gamma) + 8 x H x
//   4 (ring rows: 2 x H bf16, or H fp32) = 132 x H bytes.  At H 768 that is
//   101,376 bytes: two blocks (16 warps, 16 rows in flight) in an SM's
//   233,472 with 1,024 reserved a block, for bf16 and fp32 alike; two blocks
//   fit up to H 872, so at every H of NC <= 3 (H <= 768).  At H 1024
//   135,168 bytes, one block (under 227 KB).  __launch_bounds__(256, 2)
//   holds NC <= 3 to 128 registers, so registers never take the second
//   block away.  At FAME's fp32 batch 16 (140 units) every unit is then
//   resident at once, where one block an SM ran 132 and then 8.
#include <stdint.h>

#include "fm_common.cuh"
#include "philox.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int WARPS = LN_THREADS / 32;
constexpr int BWD_ROWS = 64;  // rows per backward block (8 per warp)
constexpr int MAX_H = 1024;
constexpr int V = 8;  // elements per chunk
constexpr int SM_SMEM = 233472;            // shared memory of an SM (228 KB)
constexpr int BLOCK_RESERVED_SMEM = 1024;  // the runtime's share of each resident block

// Whether a warp's ring row holds the next row's g beside its z: for a
// 2-byte io dtype; an fp32 ring holds z alone, so that the ring is 8 x H x 4
// bytes a block either way.
template <typename T>
__host__ __device__ constexpr bool ring_holds_g() { return sizeof(T) == 2; }
// Dynamic shared memory of a backward block (bytes): the warps' partial
// slices, gamma, and the warps' ring rows, 132 x H bytes.
template <typename T>
constexpr int bwd_smem(int H) {
  return (WARPS * 3 * H + H) * 4 + WARPS * (ring_holds_g<T>() ? 2 : 1) * H * (int)sizeof(T);
}
// Blocks an SM that registers allow (__launch_bounds__'s minimum).
constexpr int bwd_min_blocks(int nc) { return nc <= 3 ? 2 : 1; }

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

// Place in a shared row of H values of element k of chunk c (columns 8c ..
// 8c + 7): 2-byte rows keep the natural order (a chunk is one 16-byte
// access), 4-byte rows keep a chunk's halves H / 2 apart.
template <typename T>
__device__ __forceinline__ int spos(int H, int c, int k) {
  if constexpr (sizeof(T) == 2) return c * V + k;
  else return (k / 4) * (H / 2) + c * 4 + k % 4;
}
// The column of shared position q of a 4-byte row (spos's inverse).
__device__ __forceinline__ int scol(int H, int q) {
  const int half = q >= H / 2, r = q - half * (H / 2);
  return (r / 4) * V + half * 4 + r % 4;
}
__device__ __forceinline__ void lds8(const float* row, int H, int c, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(row + c * 4);
  const float4 b = *reinterpret_cast<const float4*>(row + H / 2 + c * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void lds8(const fm_bf16* row, int H, int c, float* v) {
  load8(row + c * V, v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A warp's copy of one global row of H io values into its shared ring row,
// 16 bytes a lane at a time (neighbouring lanes on neighbouring pieces).
template <typename T>
__device__ __forceinline__ void ring_fill(T* dst, const T* src, int H, int lane) {
  constexpr int PER = 16 / sizeof(T);
  for (int p = lane; p < H / PER; p += 32)
    cp_async16(dst + (sizeof(T) == 2 ? p * PER : spos<T>(H, p / 2, (p % 2) * 4)), src + p * PER);
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
__global__ void __launch_bounds__(LN_THREADS, bwd_min_blocks(NC))
layernorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ z,
                     const float* __restrict__ gamma, TDZ* __restrict__ dz,
                     T* __restrict__ da, float* __restrict__ part, int R, int H, float eps,
                     fm::Dropout drop) {
  constexpr bool RING_G = ring_holds_g<T>();
  fm::load_key(drop);
  extern __shared__ __align__(16) float ln_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int units = (R + BWD_ROWS - 1) / BWD_ROWS;
  float* acc = ln_smem;                   // [WARPS][3][H]: this block's partial slices
  float* gam = acc + WARPS * 3 * H;       // [H]
  float* mine = acc + warp * 3 * H;       // this warp's slices (g*xhat, g, dropout(dz))
  // This warp's ring row: the next row's z, after its g where RING_G.
  T* ring = reinterpret_cast<T*>(gam + H) + warp * (RING_G ? 2 : 1) * H;
  T* ring_z = ring + (RING_G ? H : 0);
  // Row t of this warp's walk: row w + 8 (t % 8) of its block's unit t / 8,
  // or -1 past the walk's end (R lies in the last unit).
  auto walk = [&](int t) {
    const int u = blockIdx.x + (t / 8) * gridDim.x;
    const int row = u * BWD_ROWS + warp + WARPS * (t % 8);
    return u < units && row < R ? row : -1;
  };
  auto fill = [&](int t) {
    const int row = walk(t);
    if (row >= 0) {
      if constexpr (RING_G) ring_fill(ring, g + (size_t)row * H, H, lane);
      ring_fill(ring_z, z + (size_t)row * H, H, lane);
    }
    cp_async_commit();
  };

  for (int i = threadIdx.x; i < H; i += LN_THREADS) gam[spos<float>(H, i / V, i % V)] = gamma[i];
  for (int i = lane; i < 3 * H; i += 32) mine[i] = 0.0f;
  fill(0);
  // fp32: g lives in registers, each chunk loaded a row ahead (below).
  float gv[NC][V];
  if constexpr (!RING_G) {
    const int first = walk(0);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (first >= 0 && (lane + 32 * j) * V < H)
        load8(g + (size_t)first * H + (lane + 32 * j) * V, gv[j]);
  }
  __syncthreads();

  const size_t plane = (size_t)units * H;
  int t = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    for (int rr = warp; rr < BWD_ROWS; rr += WARPS, ++t) {
      const int row = u * BWD_ROWS + rr;
      if (row >= R) break;  // uniform across the warp
      const size_t base = (size_t)row * H;
      const int next = RING_G ? -1 : walk(t + 1);
      float zv[NC][V];
      cp_async_wait_all();  // this row has landed
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c * V < H) {
          if constexpr (RING_G) lds8(ring, H, c, gv[j]);
          lds8(ring_z, H, c, zv[j]);
        }
      }
      __syncwarp();
      fill(t + 1);  // the warp's next row, into the ring row just read

      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if ((lane + 32 * j) * V < H)
#pragma unroll
          for (int k = 0; k < V; ++k) sum = __fadd_rn(sum, zv[j][k]);
      const float mu = fm::warp_sum(sum) / H;
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if ((lane + 32 * j) * V < H)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = __fsub_rn(zv[j][k], mu);
            sq = __fmaf_rn(d, d, sq);
          }
      const float rstd = rsqrtf(__fadd_rn(fm::warp_sum(sq) / H, eps));
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c * V < H) {
          float gm[V];
          lds8(gam, H, c, gm);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            zv[j][k] = __fmul_rn(__fsub_rn(zv[j][k], mu), rstd);  // xhat
            const float gg = __fmul_rn(gv[j][k], gm[k]);
            s1 = __fadd_rn(s1, gg);
            s2 = __fmaf_rn(gg, zv[j][k], s2);
          }
        }
      }
      const float m1 = fm::warp_sum(s1) / H;
      const float m2 = fm::warp_sum(s2) / H;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c * V < H) {
          float gm[V], d[V], a[V];
          lds8(gam, H, c, gm);
#pragma unroll
          for (int k = 0; k < V; ++k)
            a[k] = d[k] = __fmul_rn(rstd, __fmaf_rn(-zv[j][k], m2, __fmaf_rn(gv[j][k], gm[k], -m1)));
          dropout8(drop, base + c * V, a);
          store8(dz + base + c * V, d);
          store8(da + base + c * V, a);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4* pg = reinterpret_cast<float4*>(mine + h * (H / 2) + c * 4);
            float4* pb = reinterpret_cast<float4*>(mine + H + h * (H / 2) + c * 4);
            float4* pd = reinterpret_cast<float4*>(mine + 2 * H + h * (H / 2) + c * 4);
            float4 vg = *pg, vb = *pb, vd = *pd;
            const float* gh = gv[j] + 4 * h;
            const float* xh = zv[j] + 4 * h;
            const float* ah = a + 4 * h;
            vg.x = __fmaf_rn(gh[0], xh[0], vg.x); vg.y = __fmaf_rn(gh[1], xh[1], vg.y);
            vg.z = __fmaf_rn(gh[2], xh[2], vg.z); vg.w = __fmaf_rn(gh[3], xh[3], vg.w);
            vb.x = __fadd_rn(vb.x, gh[0]); vb.y = __fadd_rn(vb.y, gh[1]);
            vb.z = __fadd_rn(vb.z, gh[2]); vb.w = __fadd_rn(vb.w, gh[3]);
            vd.x = __fadd_rn(vd.x, ah[0]); vd.y = __fadd_rn(vd.y, ah[1]);
            vd.z = __fadd_rn(vd.z, ah[2]); vd.w = __fadd_rn(vd.w, ah[3]);
            *pg = vg;
            *pb = vb;
            *pd = vd;
          }
          // fp32: this chunk of the warp's next row's g, into the registers
          // just freed, in flight across the rest of this row.
          if constexpr (!RING_G)
            if (next >= 0) load8(g + (size_t)next * H + c * V, gv[j]);
        }
      }
    }

    // The unit's partials: the 8 warps' slices added in warp order, then
    // cleared for the next unit.
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * H; i += LN_THREADS) {
      const int p = i / H, q = i - p * H;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        float* a = acc + (w * 3 + p) * H + q;
        s = __fadd_rn(s, *a);
        *a = 0.0f;
      }
      part[p * plane + (size_t)u * H + scol(H, q)] = s;
    }
    __syncthreads();
  }
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

// The current device's SM count: the persistent grid's size.
static inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T, typename TDZ>
cudaError_t launch_bwd(const void* g, const void* z, const float* gamma, void* dz, void* da,
                       float* part, int R, int H, float eps, const fm::Dropout& d,
                       cudaStream_t s) {
  const int units = (R + BWD_ROWS - 1) / BWD_ROWS;
  if (units == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int smem = bwd_smem<T>(H);
  const int by_smem = SM_SMEM / (smem + BLOCK_RESERVED_SMEM);
  const int min_blocks = bwd_min_blocks((H + 255) / 256);
  const int per_sm = by_smem < min_blocks ? by_smem : min_blocks;
  const int grid = units < sms * per_sm ? units : sms * per_sm;
#define FM_BWD(NC)                                                                        \
  {                                                                                       \
    err = cudaFuncSetAttribute(layernorm_bwd_kernel<T, TDZ, NC>,                          \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);        \
    if (err != cudaSuccess) return err;                                                   \
    layernorm_bwd_kernel<T, TDZ, NC><<<grid, LN_THREADS, smem, s>>>(                      \
        static_cast<const T*>(g), static_cast<const T*>(z), gamma, static_cast<TDZ*>(dz), \
        static_cast<T*>(da), part, R, H, eps, d);                                         \
  }
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
