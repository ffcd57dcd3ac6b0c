// Flash-attention backward for Hopper (sm_90a), the dQ half: dQ of
// O = dropout(softmax(scale * Q K^T, masked)) V over contiguous [b*h, s, d] tensors,
// from the forward's per-row logsumexp L and D = rowsum(dO * O). dK and dV are
// flash_attn_bwd_dkv.cu's.
//
// Replaces: pipe_tpu/ops/pallas_attention.py, _bwd_dq_kernel (lines 162-198, launched
// at 265), with the dropout of _drop_mask (lines 57-74) inside. Same decomposition and
// arithmetic: p = exp(scale * q k^T - L) (0 where a score is masked), dp = dO V^T times
// the keep factor f, ds = p (dp f - D); dQ = scale * sum ds K. The scale is applied to
// the scores and to dQ after the products (Pallas scales q before them): the same up
// to rounding, and it keeps a bf16 Q exact in TF32. No atomics: a block owns its query
// rows of dQ, so the same seed gives the same bits. The keep factor comes from
// philox.cuh, a function of absolute positions, so this kernel regenerates the forward
// kernel's mask whatever its tiles.
//
// What bounds it: at the tutorial LM's training shape (b*h = 256, s = 128, d = 64,
// causal, fp32) the call must read q, k, v, dO, L, D and write dQ once, 42.2 MB,
// 12.6 us at 3.35 TB/s; the work is 6 d FLOPs per unmasked (query, key) pair,
// 0.81 GFLOP, 4.9 us at the 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core products.
// So it is bound by bytes, and at this size by latency as much.
//
// What the design does about that (tc_tf32.cuh holds the shared pieces). dQ's tile is
// the forward's, rows queries and columns keys, and so is its design:
// - one 128-thread block per (b*h, 64-query tile): 512 blocks at the training shape,
//   two to an SM (105 KB of shared memory at d = 64, fp32). Each warp owns 16 query
//   rows, the M of mma.sync m16n8k8;
// - the Q and dO tiles and the block's L and D are copied once with cp.async; K/V
//   tiles of 64 keys pass through a two-stage ring in shared memory filled by 16-byte
//   cp.async copies, so tile i+1 is in flight while tile i is used. The causal loop
//   stops at the diagonal;
// - S = Q K^T, dP = dO V^T and dQ += dS K are tensor-core products in three TF32
//   passes (one for S and dP and two for dS K when the inputs are bf16, which TF32
//   holds exactly). dS feeds dS K from registers by relabelling the k8 step
//   (tc_tf32.cuh): no shuffle and no round trip through shared memory;
// - inside a tile the products carry no branch (a branch around mma.sync fences each
//   three-pass chain on its own, PERF.md): the 8-key blocks wholly above a warp's rows
//   are multiplied and masked, and only their Philox is skipped;
// - dropout computes each Philox4x32-10 block once: the accumulator layout is the
//   forward's, so the forward's lane-pair exchange (keep_pair, philox.cuh) applies.
//
// Head dims up to 128 are instantiated (D = 32, 64, 128; d is zero-padded to D).
// Every model of the repo has head dim 64.
//
// C interface for ctypes: pipe_flash_attn_bwd_dq returns a cudaError_t code, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"
#include "tc_tf32.cuh"

namespace {

using namespace pipe_tc;

constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BK = 64;       // keys per K/V tile
constexpr int THREADS = 128;
constexpr int NB = BK / 8;   // 8-key blocks per tile

// dQ for one (b*h, 64-query tile). D is the head dim rounded up to 32, 64, 128.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, int d,
                    int causal, float scale, pipe_philox::Dropout drop, int vec) {
  constexpr int LD = Ld<D, T>::value;
  constexpr bool EX = Exact<T>::value;
  constexpr int ND = D / 8;  // 8-wide steps of the head dim
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + BQ * LD;
  T* ring = dos + BQ * LD;                                 // stage st: K, then V
  float* stats = reinterpret_cast<float*>(ring + 4 * BK * LD);  // L, then D

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * s * d;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int qa = q0 + r0 + g, qb = qa + 8;

  int nk = (s + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, s) - 1) / BK + 1);

  load_tile<BQ, D, THREADS>(qs, q + base, q0, s, d, vec);
  load_tile<BQ, D, THREADS>(dos, dout + base, q0, s, d, vec);
  load_stat<THREADS>(stats, lse + (size_t)bh * s, q0, BQ, s);
  load_stat<THREADS>(stats + BQ, delta + (size_t)bh * s, q0, BQ, s);
  load_tile<BK, D, THREADS>(ring, k + base, 0, s, d, vec);
  load_tile<BK, D, THREADS>(ring + BK * LD, v + base, 0, s, d, vec);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK;
    if (it + 1 < nk) {
      T* nxt = ring + 2 * BK * LD * ((it + 1) & 1);
      load_tile<BK, D, THREADS>(nxt, k + base, k0 + BK, s, d, vec);
      load_tile<BK, D, THREADS>(nxt + BK * LD, v + base, k0 + BK, s, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q's, dO's, L's, D's) have landed
    __syncthreads();
    const T* ks = ring + 2 * BK * LD * (it & 1);
    const T* vs = ks + BK * LD;

    // 8-key blocks of this tile that hold a key this warp may see (the others are
    // masked whole: their products run, branch-free, and their Philox is skipped).
    int jn = min(NB, (s - k0 + 7) / 8);
    if (causal) jn = min(jn, (q0 + r0 + 15 - k0) / 8 + 1);

    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qbig[4], qsml[4], obig[4], osml[4];
      load_a<EX, LD>(qs, r0, 8 * kk, qbig, qsml);
      load_a<EX, LD>(dos, r0, 8 * kk, obig, osml);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t bb[2], bs[2];
        load_b_t<EX, LD>(ks, 8 * j, 8 * kk, bb, bs);
        mma3<EX, EX>(sc[j], qbig, qsml, bb, bs);
        load_b_t<EX, LD>(vs, 8 * j, 8 * kk, bb, bs);
        mma3<EX, EX>(dp[j], obig, osml, bb, bs);
      }
    }

    // ds = p (dp f - D), kept in sc; element 2h + e of block j is row (h ? qb : qa),
    // key k0 + 8j + 2t + e.
    const float L[2] = {stats[r0 + g], stats[r0 + g + 8]};
    const float Dr[2] = {stats[BQ + r0 + g], stats[BQ + r0 + g + 8]};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (drop.on && j < jn) pipe_philox::keep_pair(drop, bh, (k0 + 8 * j) >> 2, qa, qb, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kg = k0 + 8 * j + 2 * t + (i & 1);
        const bool masked = kg >= s || (causal && kg > (i < 2 ? qa : qb));
        const float p = masked ? 0.f : expf(sc[j][i] * scale - L[i >> 1]);
        sc[j][i] = p * (dp[j][i] * f[i] - Dr[i >> 1]);
      }
    }

    // dQ += dS K, dS straight from the registers.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t ab[4], as[4];
      a_from_c<false>(sc[j], ab, as);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2], bs[2];
        load_b_perm<EX, LD>(ks, 8 * j, 8 * n, bb, bs);
        mma3<false, EX>(acc[n], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the ring slot is free for the copy two tiles ahead
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? qb : qa;
    if (row >= s) continue;
    T* qrow = dq + base + (size_t)row * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) store(qrow + c, acc[n][2 * h] * scale);
      if (c + 1 < d) store(qrow + c + 1, acc[n][2 * h + 1] * scale);
    }
  }
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int d,
                      int causal, float scale, pipe_philox::Dropout drop, cudaStream_t stream) {
  const int smem = (2 * BQ + 4 * BK) * Ld<D, T>::value * (int)sizeof(T) +
                   2 * BQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % (16 / (int)sizeof(T)) == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) == 0;
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s, d, causal, scale, drop, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int s, int d,
                        int causal, float scale, pipe_philox::Dropout drop, cudaStream_t st) {
  if (d <= 32) return launch_dq<32, T>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale, drop, st);
  if (d <= 64) return launch_dq<64, T>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale, drop, st);
  if (d <= 128) return launch_dq<128, T>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale, drop, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout and the gradients share it; lse and delta
// are float32 [b*h, s]). dropout, seed, threshold and keep_scale as for
// pipe_flash_attn_fwd: the same values regenerate the forward's mask.
int pipe_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int s, int d,
                           int causal, float scale, int dtype, int dropout,
                           unsigned long long seed, unsigned int threshold, float keep_scale,
                           void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pipe_philox::Dropout drop{dropout, (uint32_t)seed, (uint32_t)(seed >> 32), threshold,
                                  keep_scale};
  switch (dtype) {
    case 0:
      return (int)dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, scale,
                                     drop, st);
    case 1:
      return (int)dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, s, d, causal,
                                             scale, drop, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pipe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
