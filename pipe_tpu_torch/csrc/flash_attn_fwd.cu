// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T, masked) V
// and the per-row logsumexp L, over contiguous [b*h, s, d] tensors.
//
// Replaces: pipe_tpu/ops/pallas_attention.py, _fwd_kernel (lines 87-130), launched by
// _fwd (lines 137-155), with the attention dropout of _drop_mask (lines 57-74) inside.
// Same arithmetic: the running max m and normaliser l of the online softmax, safe_m = 0
// where m is -inf, p = 0 where a score is masked, l clamped at 1e-30, and L = m + log l
// with m read as 0 where it is not finite. Under dropout, l takes p before the keep
// factor and O takes it after (lines 117-120), so L stays the logsumexp of the
// undropped scores and the backward kernels rebuild p from it. The causal mask and the
// Philox keep mask (philox.cuh) are functions of absolute positions, so the tile sizes
// below (not the Pallas block sizes) decide nothing about the result. The scale is
// applied to the scores after the product (Pallas scales q before it): the same up to
// rounding, and it keeps a bf16 Q exact in TF32.
//
// What bounds it: at the tutorial LM's training shape (b*h = 256, s = 128, d = 64,
// causal, fp32) the call must move q, k, v and o once, 33.7 MB, 10.0 us at 3.35 TB/s,
// and do 4 * d * s(s+1)/2 * b*h = 0.54 GFLOP, 3.3 us at the 165 TFLOP/s of
// fp32-accurate (3xTF32) tensor-core products. So it is bound by bytes, and at this
// size by latency as much.
//
// What the design does about that (tc_tf32.cuh holds the shared pieces):
// - one 128-thread block per (b*h, 64-query tile): 512 blocks at the training shape,
//   two to an SM (87 KB of shared memory and 128 registers a thread at d = 64), and
//   128 at the eval shape, one wave on the 132 SMs, where 128-row tiles would leave
//   half of them idle. Each warp owns 16 query rows, the M of mma.sync m16n8k8;
// - S = Q K^T and O += P V are tensor-core products in three TF32 passes (one for
//   S and two for P V when the inputs are bf16, which TF32 holds exactly);
// - K/V tiles of 64 keys pass through a two-stage ring in shared memory filled by
//   16-byte cp.async copies, so tile i+1 is in flight while tile i is used; rows are
//   padded so that every fragment load is free of bank conflicts;
// - the online softmax runs on the accumulator layout: a thread holds rows g and g+8,
//   and the row max and sum take two xor-shuffles in the quad. P feeds P V from
//   registers by relabelling the k8 step (tc_tf32.cuh), with no shuffle;
// - the causal loop stops at the diagonal. Inside a tile the products carry no
//   branch: a branch around mma.sync makes the compiler fence each dependent
//   three-pass chain on its own, which made it 1.2 to 1.6 times slower (PERF.md), so
//   the 8-key blocks wholly above a warp's rows are multiplied and masked, and only
//   their Philox is skipped;
// - dropout computes each Philox4x32-10 block once (keep_pair, philox.cuh): the two
//   lanes of a pair hold the four keys of one block for rows g and g+8; each computes
//   the block of one row and they swap two words with one shuffle each.
//
// Head dims up to 128 are instantiated (D = 32, 64, 128; d is zero-padded to D).
// Every model of the repo has head dim 64; the wrapper refuses d > 128 with an error.
//
// C interface for ctypes: pipe_flash_attn_fwd returns a cudaError_t code, 0 on success.

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

// D is the head dimension rounded up to 32, 64 or 128; d <= D is the real one.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s, int d, int causal,
                 float scale, pipe_philox::Dropout drop, int vec) {
  constexpr int LD = Ld<D, T>::value;
  constexpr bool EX = Exact<T>::value;
  constexpr int ND = D / 8;  // 8-wide steps of the head dim
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // then stage st: K at 1 + 2 st, V at 2 + 2 st

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * s * d;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const int qa = q0 + r0 + g, qb = qa + 8;

  int nk = (s + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, s) - 1) / BK + 1);

  load_tile<BQ, D, THREADS>(qs, q + base, q0, s, d, vec);
  load_tile<BK, D, THREADS>(qs + BQ * LD, k + base, 0, s, d, vec);
  load_tile<BK, D, THREADS>(qs + (BQ + BK) * LD, v + base, 0, s, d, vec);
  cp_async_commit();

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK;
    if (it + 1 < nk) {
      T* nxt = qs + (BQ + 2 * BK * ((it + 1) & 1)) * LD;
      load_tile<BK, D, THREADS>(nxt, k + base, k0 + BK, s, d, vec);
      load_tile<BK, D, THREADS>(nxt + BK * LD, v + base, k0 + BK, s, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q's) have landed
    __syncthreads();
    const T* ks = qs + (BQ + 2 * BK * (it & 1)) * LD;
    const T* vs = ks + BK * LD;

    // 8-key blocks of this tile that hold a key this warp may see (the others are
    // masked whole: their products run, branch-free, and their Philox is skipped).
    int jn = min(NB, (s - k0 + 7) / 8);
    if (causal) jn = min(jn, (q0 + r0 + 15 - k0) / 8 + 1);

    float sc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ab[4], as[4];
      load_a<EX, LD>(qs, r0, 8 * kk, ab, as);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t bb[2], bs[2];
        load_b_t<EX, LD>(ks, 8 * j, 8 * kk, bb, bs);
        mma3<EX, EX>(sc[j], ab, as, bb, bs);
      }
    }

    // Online softmax; element 2h + e of block j is row (h ? qb : qa), key k0+8j+2t+e.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kg = k0 + 8 * j + 2 * t + (i & 1);
        float x = sc[j][i] * scale;
        if (kg >= s || (causal && kg > (i < 2 ? qa : qb))) x = -INFINITY;
        sc[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float safe[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float new_m = fmaxf(m[h], mx[h]);
      safe[h] = isfinite(new_m) ? new_m : 0.f;
      corr[h] = isfinite(m[h]) ? expf(m[h] - safe[h]) : 0.f;
      m[h] = new_m;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sc[j][i];
        sc[j][i] = isfinite(x) ? expf(x - safe[i >> 1]) : 0.f;
        psum[i >> 1] += sc[j][i];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
      psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
      l[h] = l[h] * corr[h] + psum[h];  // the normaliser takes p before dropout
    }
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < jn) {
          float f[4];
          pipe_philox::keep_pair(drop, bh, (k0 + 8 * j) >> 2, qa, qb, f);
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] *= f[i];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= corr[0]; oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1]; oacc[n][3] *= corr[1];
    }

    // O += P V, P straight from the score registers.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t ab[4], as[4];
      a_from_c<false>(sc[j], ab, as);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2], bs[2];
        load_b_perm<EX, LD>(vs, 8 * j, 8 * n, bb, bs);
        mma3<false, EX>(oacc[n], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the ring slot is free for the copy two tiles ahead
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? qb : qa;
    if (row >= s) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    T* orow = o + base + (size_t)row * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) store(orow + c, oacc[n][2 * h] / lc);
      if (c + 1 < d) store(orow + c + 1, oacc[n][2 * h + 1] / lc);
    }
    if (t == 0) lse[(size_t)bh * s + row] = (isfinite(m[h]) ? m[h] : 0.f) + logf(lc);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int s, int d, int causal, float scale, pipe_philox::Dropout drop,
                   cudaStream_t stream) {
  const int smem = (BQ + 2 * 2 * BK) * Ld<D, T>::value * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % (16 / (int)sizeof(T)) == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, d, causal, scale, drop, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int s, int d, int causal, float scale,
                       pipe_philox::Dropout drop, cudaStream_t stream) {
  if (d <= 32) return launch<32, T>(q, k, v, o, lse, bh, s, d, causal, scale, drop, stream);
  if (d <= 64) return launch<64, T>(q, k, v, o, lse, bh, s, d, causal, scale, drop, stream);
  if (d <= 128) return launch<128, T>(q, k, v, o, lse, bh, s, d, causal, scale, drop, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it; lse is float32).
// dropout: 0 off; else pairs are kept when their Philox bits (philox.cuh, keyed by seed)
// are >= threshold, and scaled by keep_scale.
int pipe_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int s, int d, int causal, float scale, int dtype,
                        int dropout, unsigned long long seed, unsigned int threshold,
                        float keep_scale, void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pipe_philox::Dropout drop{dropout, (uint32_t)seed, (uint32_t)(seed >> 32), threshold,
                                  keep_scale};
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, o, lse, bh, s, d, causal, scale, drop, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, s, d, causal, scale, drop, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pipe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
