// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
// written out by hand so that its stream is the one the plain PyTorch version
// (pipe_tpu_torch/ops/flash_attention.py, philox4x32) reproduces bit for bit. curand's
// Philox keeps its own counter layout, which the plain version could not follow.
//
// The attention-dropout keep mask of the three flash kernels is a function of
// (seed, b*h, query position, key position) only, never of a kernel's tiling:
//   key     = (seed low 32 bits, seed high 32 bits)
//   counter = (key position / 4, query position, b*h, 0)
//   bits    = word (key position % 4) of the output
// and the pair is kept when bits >= threshold, where the wrapper passes
// threshold = min(int(rate * 2^32), 2^32 - 1), the keep rule of the Pallas _drop_mask.

#pragma once

#include <stdint.h>

namespace pipe_philox {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The random word of pair (bh, q, k): see the layout above.
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed_lo, uint32_t seed_hi, int bh,
                                              int q, int k) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)k >> 2, (uint32_t)q, (uint32_t)bh, 0u), seed_lo, seed_hi);
  switch (k & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Dropout of one attention probability: what multiplies it (0 or 1 / (1 - rate)).
struct Dropout {
  int on;              // 0: no dropout, every factor is 1
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // kept when bits >= threshold
  float scale;         // 1 / (1 - rate), rounded to float32 by the wrapper

  __device__ __forceinline__ float factor(int bh, int q, int k) const {
    return keep_bits(seed_lo, seed_hi, bh, q, k) >= threshold ? scale : 0.f;
  }
};

}  // namespace pipe_philox
