// Philox4x32-10 dropout bits, the counter-based stream that replaces the
// TPU's on-core random-bit generator (pltpu.prng_seed / prng_random_bits in
// fairmultimodal_tpu/ops/fused_attention_block.py and fused_ffn.py).
//
// One mapping defines every random bit of the port:
//
//     bits(seed, stream, i) = philox4x32_10(ctr = (q_lo, q_hi, stream, 0),
//                                           key = (seed_lo, seed_hi))[i & 3]
//     with q = i >> 2, i the flat element index of the dropped tensor.
//
// fairmultimodal_torch/utils/rng.py computes the same function on int64
// tensors, so a kernel and its plain version draw identical masks from one
// seed.  Dropout keeps an element where bits < threshold, threshold =
// min(int(keep * 2^32), 2^32 - 1), and scales what it keeps by 1/keep: the
// JAX kernels' contract.  The forward draws the mask and the backward
// replays it from the same (seed, stream): nothing is stored.
//
// The seed (the Philox key) lies in device memory: a launch carries a pointer
// to it, and each kernel that draws loads it once, at its start, before any
// draw (load_key).  So a launch captured into a CUDA graph draws from what
// that memory holds when the graph is replayed, not from the key it was
// captured with.
#pragma once

#include <stdint.h>

namespace fm {

struct Dropout {
  unsigned long long seed;        // the key, once load_key has read it
  const unsigned long long* key;  // where the key lies (device memory); null when off
  unsigned int stream;
  unsigned int threshold;
  float inv_keep;
  int on;
};

// Read the key of a launch that draws: once per thread, at the kernel's start.
__device__ __forceinline__ void load_key(Dropout& d) {
  if (d.on) d.seed = __ldg(d.key);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of counter q: the bits of flat indices 4q .. 4q + 3.
__device__ __forceinline__ uint4 random_words(unsigned long long seed, uint32_t stream,
                                              unsigned long long q) {
  return philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), stream, 0u),
                       make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
}

__device__ __forceinline__ uint32_t random_bits(unsigned long long seed, uint32_t stream,
                                                unsigned long long i) {
  const uint4 r = random_words(seed, stream, i >> 2);
  switch (i & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// v after dropout at flat index i (v itself when dropout is off).
__device__ __forceinline__ float apply_dropout(const Dropout& d, float v, unsigned long long i) {
  if (!d.on) return v;
  return random_bits(d.seed, d.stream, i) < d.threshold ? v * d.inv_keep : 0.0f;
}

}  // namespace fm
