// Flash-attention backward for Hopper (sm_90a), the dK/dV half: dK and dV of
// O = dropout(softmax(scale * Q K^T, masked)) V over contiguous [b*h, s, d] tensors,
// from the forward's per-row logsumexp L and D = rowsum(dO * O).
//
// Replaces: pipe_tpu/ops/pallas_attention.py, _bwd_dkv_kernel (lines 201-250, launched
// at 278), with the dropout of _drop_mask (lines 57-74) inside. Same decomposition and
// arithmetic, with keys as rows: p^T = exp(scale * K Q^T - L) (0 where a score is
// masked), dp^T = V dO^T times the keep factor f, ds^T = p^T (dp^T f - D);
// dV = sum (p^T f) dO and dK = sum ds^T (scale Q), the scale taken after the sum. One
// block owns each key row of dK and dV, so there are no atomics and the same seed gives
// the same bits. The keep factor comes from philox.cuh, a function of absolute
// positions, so this kernel regenerates the forward kernel's mask whatever its tiles.
//
// What bounds it: at the tutorial LM's training shape (b*h = 256, s = 128, d = 64,
// causal, fp32) the call must read q, k, v, dO, L and D and write dK and dV once,
// 50.5 MB, 15.1 us at 3.35 TB/s; the work is 8 d FLOPs per unmasked (query, key) pair,
// 1.08 GFLOP, 6.5 us at the 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core
// products. So it is bound by bytes, and at this size by latency as much.
//
// What the design does about that (tc_tf32.cuh holds the shared pieces):
// - one 128-thread block per (b*h, 64-key tile), 512 blocks at the training shape;
//   each warp owns 16 key rows, the M of mma.sync m16n8k8, and K and V stay in
//   shared memory for the whole block;
// - Q/dO tiles of 32 queries, with their L and D, stream through a two-stage ring
//   filled by cp.async, from the first query tile the causal mask lets see the key
//   tile (iq0 of the Pallas kernel), so tile i+1 is in flight while tile i is used.
//   32 rather than 64 queries keep a block at 70 KB of shared memory (fp32, d = 64)
//   and under 170 registers a thread, so three blocks share an SM: faster at the
//   training shape than 64-query tiles (PERF.md);
// - the four products (S^T, dP^T, dV, dK) are tensor-core products in three TF32
//   passes (fewer for bf16 inputs, which TF32 holds exactly); p^T f and ds^T feed dV
//   and dK from registers by relabelling the k8 step (tc_tf32.cuh), with no shuffle.
//   The products carry no branch inside a tile: a branch around mma.sync makes the
//   compiler fence each dependent three-pass chain on its own, which made it slower
//   (PERF.md). A warp skips a tile only when every query in it is masked;
// - dropout computes each Philox4x32-10 block once: the four keys of a block sit in
//   four lanes 4 apart (rows g, g&3 = 0..3); each of them computes one of the four
//   blocks the group needs and three xor-shuffles hand every lane its word of each.
//
// Head dims up to 128 are instantiated (D = 32, 64, 128; d is zero-padded to D).
//
// C interface for ctypes: pipe_flash_attn_bwd_dkv returns a cudaError_t code, 0 on
// success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"
#include "tc_tf32.cuh"

namespace {

using namespace pipe_tc;

constexpr int BKV = 64;      // key rows per block, 16 per warp
constexpr int BQ = 32;       // queries per streamed tile
constexpr int NJ = BQ / 8;   // 8-query blocks per tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t word(const uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Keep factors of this lane's four (key, query) pairs in the C layout: keys ka, kb
// (= ka + 8), queries qn, qn + 1. The lanes 4 apart with g & 3 = i = 0..3 hold the
// four keys of the groups ka >> 2 and kb >> 2; lane i computes block i of
// (ka, qn), (ka, qn+1), (kb, qn), (kb, qn+1), and in round x of three lane i sends
// word i^x of its block to lane i^x, which needs word i^x of every block.
__device__ __forceinline__ void keep_quad(const pipe_philox::Dropout& drop, int bh, int ka,
                                          int kb, int qn, float f[4]) {
  const int i = (threadIdx.x >> 2) & 3;
  const uint4 r = pipe_philox::philox4x32_10(
      make_uint4((uint32_t)((i < 2 ? ka : kb) >> 2), (uint32_t)(qn + (i & 1)),
                 (uint32_t)bh + drop.bh_base, 0u),
      drop.seed_lo, drop.seed_hi);
  const uint32_t got[4] = {word(r, i), __shfl_xor_sync(FULL, word(r, i ^ 1), 4),
                           __shfl_xor_sync(FULL, word(r, i ^ 2), 8),
                           __shfl_xor_sync(FULL, word(r, i ^ 3), 12)};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int x = b ^ i;  // block b came in round x
    const uint32_t w = x == 0 ? got[0] : x == 1 ? got[1] : x == 2 ? got[2] : got[3];
    f[b] = w >= drop.threshold ? drop.scale : 0.f;
  }
}

// dK and dV for one (b*h, 64-key tile). D is the head dim rounded up to 32, 64, 128.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int s, int d, int causal, float scale, pipe_philox::Dropout drop,
                     int vec) {
  constexpr int LD = Ld<D, T>::value;
  constexpr bool EX = Exact<T>::value;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);
  T* vs = ks + BKV * LD;
  T* ring = vs + BKV * LD;                                // stage st: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + 4 * BQ * LD);  // stage st: L, then D

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;
  const size_t base = (size_t)bh * s * d;
  const float* lrow = lse + (size_t)bh * s;
  const float* drow = delta + (size_t)bh * s;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int ka = k0 + r0 + g, kb = ka + 8;

  const int nq = (s + BQ - 1) / BQ;
  const int iq0 = causal ? k0 / BQ : 0;  // first query tile that sees these keys

  auto load_stage = [&](int st, int q0) {
    T* qs = ring + 2 * st * BQ * LD;
    load_tile<BQ, D, THREADS>(qs, q + base, q0, s, d, vec);
    load_tile<BQ, D, THREADS>(qs + BQ * LD, dout + base, q0, s, d, vec);
    load_stat<THREADS>(stats + 2 * st * BQ, lrow, q0, BQ, s);
    load_stat<THREADS>(stats + (2 * st + 1) * BQ, drow, q0, BQ, s);
  };
  load_tile<BKV, D, THREADS>(ks, k + base, k0, s, d, vec);
  load_tile<BKV, D, THREADS>(vs, v + base, k0, s, d, vec);
  load_stage(0, iq0 * BQ);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  }

  for (int iq = iq0; iq < nq; ++iq) {
    const int st = (iq - iq0) & 1;
    if (iq + 1 < nq) load_stage(st ^ 1, (iq + 1) * BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qs = ring + 2 * st * BQ * LD;
    const T* dos = qs + BQ * LD;
    const float* ls = stats + 2 * st * BQ;
    const float* dls = ls + BQ;

    // 8-query blocks of the tile that hold a query this warp's keys may see: a warp
    // with none skips the tile; otherwise the products run branch-free over every
    // block (the mask zeroes the rest) and only Philox is skipped.
    const int q0 = iq * BQ;
    int jlo = 0;
    if (causal && k0 + r0 > q0) jlo = (k0 + r0 - q0) / 8;
    const int jhi = min(NJ, (s - q0 + 7) / 8);
    if (jlo < jhi) {
      float sc[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t kb_[4], ks_[4], vb_[4], vs_[4];
        load_a<EX, LD>(ks, r0, 8 * kk, kb_, ks_);
        load_a<EX, LD>(vs, r0, 8 * kk, vb_, vs_);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bb[2], bs[2];
          load_b_t<EX, LD>(qs, 8 * j, 8 * kk, bb, bs);
          mma3<EX, EX>(sc[j], kb_, ks_, bb, bs);
          load_b_t<EX, LD>(dos, 8 * j, 8 * kk, bb, bs);
          mma3<EX, EX>(dp[j], vb_, vs_, bb, bs);
        }
      }

      // sc becomes p f (for dV), dp becomes ds = p (dp f - D) (for dK); element
      // 2h + e of block j is key (h ? kb : ka), query q0 + 8j + 2t + e.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if (drop.on && j >= jlo && j < jhi) keep_quad(drop, bh, ka, kb, q0 + 8 * j + 2 * t, f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * j + 2 * t + (i & 1);
          const int qg = q0 + qi;
          const int kg = i < 2 ? ka : kb;
          const bool masked = qg >= s || (causal && kg > qg);
          const float p = masked ? 0.f : expf(sc[j][i] * scale - ls[qi]);
          dp[j][i] = p * (dp[j][i] * f[i] - dls[qi]);
          sc[j][i] = p * f[i];
        }
      }

      // dV += (p f)^T dO and dK += ds^T Q, the A operands straight from registers.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4], sb[4], ss[4];
        a_from_c<false>(sc[j], pb, ps);
        a_from_c<false>(dp[j], sb, ss);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bb[2], bs[2];
          load_b_perm<EX, LD>(dos, 8 * j, 8 * n, bb, bs);
          mma3<false, EX>(dva[n], pb, ps, bb, bs);
          load_b_perm<EX, LD>(qs, 8 * j, 8 * n, bb, bs);
          mma3<false, EX>(dka[n], sb, ss, bb, bs);
        }
      }
    }
    __syncthreads();  // the ring slot is free for the copy two tiles ahead
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? kb : ka;
    if (row >= s) continue;
    T* krow = dk + base + (size_t)row * d;
    T* vrow = dv + base + (size_t)row * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) {
        store(krow + c, dka[n][2 * h] * scale);
        store(vrow + c, dva[n][2 * h]);
      }
      if (c + 1 < d) {
        store(krow + c + 1, dka[n][2 * h + 1] * scale);
        store(vrow + c + 1, dva[n][2 * h + 1]);
      }
    }
  }
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int d, int causal, float scale, pipe_philox::Dropout drop,
                       cudaStream_t stream) {
  const int smem = (2 * BKV + 4 * BQ) * Ld<D, T>::value * (int)sizeof(T) +
                   4 * BQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % (16 / (int)sizeof(T)) == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) == 0;
  const dim3 grid(bh, (s + BKV - 1) / BKV);
  flash_bwd_dkv_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s, d, causal,
      scale, drop, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                         int d, int causal, float scale, pipe_philox::Dropout drop,
                         cudaStream_t st) {
  if (d <= 32) return launch_dkv<32, T>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal, scale, drop, st);
  if (d <= 64) return launch_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal, scale, drop, st);
  if (d <= 128) return launch_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal, scale, drop, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout, dk and dv share it; lse and delta are
// float32 [b*h, s]). dropout, seed, threshold and keep_scale as for pipe_flash_attn_fwd:
// the same values regenerate the forward's mask.
int pipe_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh,
                            int s, int d, int causal, float scale, int dtype, int dropout,
                            unsigned long long seed, unsigned int threshold, float keep_scale,
                            unsigned int bh_base, void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pipe_philox::Dropout drop{dropout, (uint32_t)seed, (uint32_t)(seed >> 32), threshold,
                                  keep_scale, bh_base};
  switch (dtype) {
    case 0:
      return (int)dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal,
                                      scale, drop, st);
    case 1:
      return (int)dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                                              causal, scale, drop, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pipe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
