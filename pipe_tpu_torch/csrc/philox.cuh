// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
// written out by hand so that its stream is the one the plain PyTorch version
// (pipe_tpu_torch/ops/flash_attention.py, philox4x32) reproduces bit for bit. curand's
// Philox keeps its own counter layout, which the plain version could not follow.
//
// The attention-dropout keep mask of the three flash kernels is a function of
// (seed, b*h, query position, key position) only, never of a kernel's tiling:
//   key     = (seed low 32 bits, seed high 32 bits)
//   counter = (key position / 4, query position, bh_base + b*h, 0)
//   bits    = word (key position % 4) of the output
// and the pair is kept when bits >= threshold, where the wrapper passes
// threshold = min(int(rate * 2^32), 2^32 - 1), the keep rule of the Pallas _drop_mask.
// bh_base is 0 unless the call holds rows of a larger batch (a data rank of a mesh, whose
// rows start at row r of the micro-batch: bh_base = r * heads), so that its mask is the
// one the whole batch's call draws for those rows.

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

// Attention dropout as the wrapper passes it: a pair's probability is multiplied by
// scale when its bits are >= threshold, and by 0 otherwise.
struct Dropout {
  int on;              // 0: no dropout, every factor is 1
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // kept when bits >= threshold
  float scale;         // 1 / (1 - rate), rounded to float32 by the wrapper
  uint32_t bh_base;    // added to the b*h counter word
};

// Keep factors of this lane's four (query, key) pairs in the C layout of mma.sync
// m16n8k8 (tc_tf32.cuh), which the forward and dQ kernels share: rows qa, qb
// (= qa + 8), keys 8j + 2t, 8j + 2t + 1 of the block whose first Philox group is grp.
// Lanes t and t^1 hold the four keys of one group: the even lane computes row qa's
// block, the odd lane row qb's, and each hands over the two words the other needs.
__device__ __forceinline__ void keep_pair(const Dropout& drop, int bh, int grp, int qa, int qb,
                                          float f[4]) {
  const int t = threadIdx.x & 3;
  const bool odd = t & 1;
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)(grp + (t >> 1)), (uint32_t)(odd ? qb : qa),
                 (uint32_t)bh + drop.bh_base, 0u),
      drop.seed_lo, drop.seed_hi);
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  const uint32_t own0 = odd ? r.z : r.x, own1 = odd ? r.w : r.y;
  const uint32_t w[4] = {odd ? got0 : own0, odd ? got1 : own1, odd ? own0 : got0,
                         odd ? own1 : got1};
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = w[i] >= drop.threshold ? drop.scale : 0.f;
}

}  // namespace pipe_philox
