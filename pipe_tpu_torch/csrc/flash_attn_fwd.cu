// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T, masked) V
// and the per-row logsumexp L, over contiguous [b*h, s, d] tensors.
//
// Replaces: pipe_tpu/ops/pallas_attention.py, _fwd_kernel (lines 87-130), launched by
// _fwd (lines 137-155). Same arithmetic: the running max m and normaliser l of the
// online softmax, safe_m = 0 where m is -inf, p = 0 where a score is masked, l clamped
// at 1e-30, and L = m + log l with m read as 0 where it is not finite. The causal mask
// compares absolute positions, so the tile sizes below (not the Pallas block sizes)
// decide nothing about the result.
//
// What bounds it: at the tutorial LM's shape (b*h = 64, s = 128, d = 64, causal, fp32)
// the call must move q, k, v and o once, 8.4 MB, which takes 2.5 us at 3.35 TB/s, and
// do 4 * d * s(s+1)/2 * b*h = 0.14 GFLOP, 2.0 us at the 67 TFLOP/s of fp32 FMA. So it
// is bound by bytes, and at this size by launch latency more than either.
//
// What the design does about that: one thread block per (b*h, 32-row query tile),
// 256 blocks at the slice shape, all resident at once on 132 SMs (43 KB of shared
// memory and 128 threads each). Each K/V tile of 64 rows is read from device memory
// once per block and staged in shared memory, where all 32 query rows reuse it. The
// scores and the softmax state never leave registers: four threads share a query row,
// each holds 16 of the tile's 64 scores and a quarter of the output row, and the row
// max, the row sum and the probabilities move between the four by warp shuffles. The
// k-tile loop stops at the causal diagonal. Products are fp32 FMA on the CUDA cores;
// tensor cores (wgmma) and TMA come later, when the kernel is made fast.
//
// Head dims up to 128 are instantiated: every model of the repo has head dim 64. The
// Pallas wrapper takes any head dim; the wrapper here refuses d > 128 with an error.
//
// C interface for ctypes: pipe_flash_attn_fwd returns a cudaError_t code, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 32;             // query rows per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;  // 128
constexpr int KPT = BK / TPR;      // scores each thread holds per tile (16)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rows [row0, row0 + rows) of a row-major [s, d] matrix into a fp32 tile of
// [rows][D + 4], times mul; columns >= d and rows >= s are filled with zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int row0, int rows, int s, int d, float mul) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    float x = 0.f;
    if (g < s && c < d) x = to_f(src[(size_t)g * d + c]) * mul;
    tile[r * LD + c] = x;
  }
}

// D is the head dimension rounded up to 32, 64 or 128; d <= D is the real one.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s, int d, int causal,
                 float scale) {
  constexpr int LD = D + 4;  // +4 floats: rows stay 16-byte aligned, banks spread
  constexpr int NC = D / 16; // float4 chunks of the output row per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * s * d;
  const int r = threadIdx.x / TPR;  // query row within the tile
  const int t = threadIdx.x % TPR;  // this thread's quarter of the row
  const int qg = q0 + r;            // absolute query position
  const int quad = (threadIdx.x & 31) & ~(TPR - 1);

  // q * scale before the product, as _fwd_kernel does.
  load_tile<D>(qs, q + base, q0, BQ, s, d, scale);

  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;

  int nk = (s + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, s) - 1) / BK + 1);

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // the previous tile is consumed (and the Q tile is in place)
    load_tile<D>(ks, k + base, k0, BK, s, d, 1.f);
    load_tile<D>(vs, v + base, k0, BK, s, d, 1.f);
    __syncthreads();

    // Scores of this row against keys k0 + j*TPR + t.
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(qs + r * LD);
#pragma unroll 4
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 qv = qrow[c4];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = reinterpret_cast<const float4*>(ks + (j * TPR + t) * LD)[c4];
        sc[j] = fmaf(qv.x, kv.x, sc[j]);
        sc[j] = fmaf(qv.y, kv.y, sc[j]);
        sc[j] = fmaf(qv.z, kv.z, sc[j]);
        sc[j] = fmaf(qv.w, kv.w, sc[j]);
      }
    }

    float bmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kg = k0 + j * TPR + t;
      if (kg >= s || (causal && kg > qg)) sc[j] = -INFINITY;
      bmax = fmaxf(bmax, sc[j]);
    }
    bmax = fmaxf(bmax, __shfl_xor_sync(FULL, bmax, 1));
    bmax = fmaxf(bmax, __shfl_xor_sync(FULL, bmax, 2));
    const float new_m = fmaxf(m, bmax);
    const float safe_m = isfinite(new_m) ? new_m : 0.f;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      sc[j] = isfinite(sc[j]) ? expf(sc[j] - safe_m) : 0.f;
      psum += sc[j];
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    const float corr = isfinite(m) ? expf(m - safe_m) : 0.f;
    l = l * corr + psum;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
    }

    // O += P V: key j*TPR + src's probability comes from thread src of the quad;
    // this thread owns output columns 16c + 4t .. 16c + 4t + 3.
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
#pragma unroll
      for (int src = 0; src < TPR; ++src) {
        const float p = __shfl_sync(FULL, sc[j], quad | src);
        const float4* vrow = reinterpret_cast<const float4*>(vs + (j * TPR + src) * LD);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = vrow[c * TPR + t];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
    }
    m = new_m;
  }

  if (qg < s) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + base + (size_t)qg * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int c0 = 16 * c + 4 * t;
      if (c0 + 0 < d) store(orow + c0 + 0, acc[c].x / lc);
      if (c0 + 1 < d) store(orow + c0 + 1, acc[c].y / lc);
      if (c0 + 2 < d) store(orow + c0 + 2, acc[c].z / lc);
      if (c0 + 3 < d) store(orow + c0 + 3, acc[c].w / lc);
    }
    if (t == 0) lse[(size_t)bh * s + qg] = (isfinite(m) ? m : 0.f) + logf(lc);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int s, int d, int causal, float scale, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (D + 4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int s, int d, int causal, float scale, cudaStream_t stream) {
  if (d <= 32) return launch<32, T>(q, k, v, o, lse, bh, s, d, causal, scale, stream);
  if (d <= 64) return launch<64, T>(q, k, v, o, lse, bh, s, d, causal, scale, stream);
  if (d <= 128) return launch<128, T>(q, k, v, o, lse, bh, s, d, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it; lse is float32).
int pipe_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int s, int d, int causal, float scale, int dtype,
                        void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, s, d, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pipe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
