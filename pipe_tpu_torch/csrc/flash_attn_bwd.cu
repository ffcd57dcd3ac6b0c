// Flash-attention backward for Hopper (sm_90a), the dQ half: dQ of
// O = dropout(softmax(scale * Q K^T, masked)) V over contiguous [b*h, s, d] tensors,
// from the forward's per-row logsumexp L and D = rowsum(dO * O). dK and dV are
// flash_attn_bwd_dkv.cu's.
//
// Replaces: pipe_tpu/ops/pallas_attention.py, _bwd_dq_kernel (lines 162-198, launched
// at 265), with the dropout of _drop_mask (lines 57-74) inside. Same decomposition and
// arithmetic: p is rebuilt as exp(s - L) (0 where a score is masked), dp = dO V^T times
// the keep factor, ds = p (dp - D); dQ = scale * sum ds K. No atomics: a block owns its
// query rows of dQ, so the results are the same from run to run. The keep factor comes
// from philox.cuh, a function of absolute positions, so this kernel regenerates the
// forward kernel's mask whatever its tiles.
//
// What bounds it: at the tutorial LM's training shape (b*h = 256, s = 128, d = 64,
// causal, fp32) the call must read q, k, v, dO, L, D and write dQ once, 42.2 MB,
// 12.6 us at 3.35 TB/s; the work is 6 d FLOPs per unmasked (query, key) pair,
// 0.81 GFLOP, 4.9 us at the 165 TFLOP/s of fp32-accurate (3xTF32) tensor-core products.
// So it is bound by bytes, and at this size by latency as much.
//
// What the design does about that: one 128-thread block per (b*h, 32-row query tile);
// K/V tiles of 64 keys staged in shared memory and reused by all 32 rows; four threads
// per query row, each holding 16 scores and 16 dp values of the tile and a quarter of
// the dQ row in registers; ds moves between the four by warp shuffles. The k-tile loop
// stops at the causal diagonal. Products are fp32 FMA on the CUDA cores; the forward
// and dK/dV kernels' tensor-core design (tc_tf32.cuh) is this kernel's next step.
//
// Head dims up to 128 are instantiated (every model of the repo has head dim 64).
//
// C interface for ctypes: pipe_flash_attn_bwd_dq returns a cudaError_t code, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "philox.cuh"

namespace {

constexpr int TPR = 4;              // threads per owned row
constexpr int NPT = 16;             // tile columns each thread holds (64 / TPR)
constexpr int THREADS = 128;        // 32 owned rows x TPR
constexpr int ROWS = THREADS / TPR; // rows a block owns (32)
constexpr int TILE = NPT * TPR;     // rows of a streamed tile (64)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rows [row0, row0 + rows) of a row-major [s, d] matrix into a fp32 tile of
// [rows][D + 4], times mul; columns >= d and rows >= s are filled with zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, int row0,
                                          int rows, int s, int d, float mul) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    float x = 0.f;
    if (g < s && c < d) x = to_f(src[(size_t)g * d + c]) * mul;
    tile[r * LD + c] = x;
  }
}

// Entries [row0, row0 + rows) of a length-s row statistic, 0 past s.
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int s) {
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const int g = row0 + i;
    dst[i] = g < s ? src[g] : 0.f;
  }
}

// Writes acc * mul as row g of a [s, d] matrix; this thread holds columns
// 16c + 4t .. 16c + 4t + 3.
template <int NC, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row, const float4* acc, int t, int d,
                                          float mul) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int c0 = 16 * c + 4 * t;
    if (c0 + 0 < d) store(row + c0 + 0, acc[c].x * mul);
    if (c0 + 1 < d) store(row + c0 + 1, acc[c].y * mul);
    if (c0 + 2 < d) store(row + c0 + 2, acc[c].z * mul);
    if (c0 + 3 < d) store(row + c0 + 3, acc[c].w * mul);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// dQ for one (b*h, 32-row query tile).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, int d,
                    int causal, float scale, pipe_philox::Dropout drop) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + ROWS * LD;
  float* ks = dos + ROWS * LD;
  float* vs = ks + TILE * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const size_t base = (size_t)bh * s * d;
  const int r = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qg = q0 + r;
  const int quad = (threadIdx.x & 31) & ~(TPR - 1);

  load_tile<D>(qs, q + base, q0, ROWS, s, d, scale);   // q * scale, as _bwd_dq_kernel
  load_tile<D>(dos, dout + base, q0, ROWS, s, d, 1.f);
  const float L = qg < s ? lse[(size_t)bh * s + qg] : 0.f;
  const float Dr = qg < s ? delta[(size_t)bh * s + qg] : 0.f;

  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  int nk = (s + TILE - 1) / TILE;
  if (causal) nk = min(nk, (min(q0 + ROWS, s) - 1) / TILE + 1);

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * TILE;
    __syncthreads();
    load_tile<D>(ks, k + base, k0, TILE, s, d, 1.f);
    load_tile<D>(vs, v + base, k0, TILE, s, d, 1.f);
    __syncthreads();

    // Scores and dO . V of this row against keys k0 + j*TPR + t.
    float sc[NPT], dp[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) sc[j] = dp[j] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(qs + r * LD);
    const float4* drow = reinterpret_cast<const float4*>(dos + r * LD);
#pragma unroll 2
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 qv = qrow[c4], dv = drow[c4];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int kr = (j * TPR + t) * LD;
        sc[j] = dot4(qv, reinterpret_cast<const float4*>(ks + kr)[c4], sc[j]);
        dp[j] = dot4(dv, reinterpret_cast<const float4*>(vs + kr)[c4], dp[j]);
      }
    }
    // ds = p (dp * keep - D), kept in sc.
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int kg = k0 + j * TPR + t;
      const bool masked = kg >= s || (causal && kg > qg);
      const float p = masked ? 0.f : expf(sc[j] - L);
      float dpj = dp[j];
      if (drop.on) dpj *= drop.factor(bh, qg, kg);
      sc[j] = p * (dpj - Dr);
    }
    // dQ += ds K: key j*TPR + src's ds comes from thread src of the quad.
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
#pragma unroll
      for (int src = 0; src < TPR; ++src) {
        const float ds = __shfl_sync(FULL, sc[j], quad | src);
        const float4* krow = reinterpret_cast<const float4*>(ks + (j * TPR + src) * LD);
#pragma unroll
        for (int c = 0; c < NC; ++c) fma4(acc[c], ds, krow[c * TPR + t]);
      }
    }
  }
  if (qg < s) store_row<NC>(dq + base + (size_t)qg * d, acc, t, d, scale);
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int d,
                      int causal, float scale, pipe_philox::Dropout drop, cudaStream_t stream) {
  const int smem = (2 * ROWS + 2 * TILE) * (D + 4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + ROWS - 1) / ROWS);
  flash_bwd_dq_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s, d, causal, scale, drop);
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

