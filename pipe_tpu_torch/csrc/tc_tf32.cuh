// Tensor-core building blocks shared by the flash forward and dK/dV kernels:
// fp32-accurate products from three TF32 passes on mma.sync m16n8k8, the
// fragment loads from shared-memory tiles, and the cp.async tile copies.
//
// 3xTF32 ("fast fp32" in CUTLASS): x = big + small with big = tf32(x) and
// small = tf32(x - big), both rounded to nearest (cvt.rna); a product a*b is taken as
// small_a*big_b + big_a*small_b + big_a*big_b, small*small dropped. Each TF32
// product is exact in the fp32 accumulator (11 x 11 significant bits), so the
// result keeps fp32-level error at a third of the TF32 rate (495 / 3 TFLOP/s on
// an H100 SXM, against 67 TFLOP/s of fp32 FMA). An operand that is exact in
// TF32 (a bf16 input: 8 significant bits) has small = 0, and its pass is skipped.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16 x 8, row)  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8, col)   b0 (k=t, n=g)              b1 (k=t+4, n=g)
//   C (16 x 8)       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product whose A operand is a C fragment of an earlier product (P V after
// S = Q K^T) relabels its k8 step: logical k = t is the tile's row 2t and
// k = t+4 is row 2t+1. The A fragment is then {c0, c2, c1, c3} of the C
// fragment, with no shuffle, and the B fragment reads rows 2t and 2t+1
// (load_b_perm). A sum over k does not depend on the order of its terms.
//
// Tiles live in shared memory as [rows][LD] of the input type, LD = D + 4
// (fp32) or D + 8 (bf16): the rows stay 16-byte aligned for cp.async, and
// every fragment load below hits 32 different banks (or shares a word).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pipe_tc {

constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Exact { static constexpr bool value = true; };  // bf16
template <> struct Exact<float> { static constexpr bool value = false; };

// Row stride of a [rows][D] tile of T in shared memory.
template <int D, typename T> struct Ld {
  static constexpr int value = D + (sizeof(T) == 4 ? 4 : 8);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// cvt.rna.tf32.f32 for finite x (round to nearest, ties away from zero, to 10
// mantissa bits), as two integer instructions: the cvt instruction itself expands
// to a longer sequence with NaN checks on sm_90.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = EXACT ? 0u : tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in fp32-level accuracy: the small passes first, then big x big.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                     const uint32_t bb[2], const uint32_t bs[2]) {
  if (!A_EXACT) mma(c, as, bb);
  if (!B_EXACT) mma(c, ab, bs);
  mma(c, ab, bb);
}

// A fragment of rows r0..r0+15, columns c0..c0+7 of a [.][LD] tile.
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void load_a(const T* tile, int r0, int c0, uint32_t big[4],
                                       uint32_t small[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (r0 + g) * LD + c0 + t;
  split<EXACT>(to_f(p[0]), big[0], small[0]);
  split<EXACT>(to_f(p[8 * LD]), big[1], small[1]);
  split<EXACT>(to_f(p[4]), big[2], small[2]);
  split<EXACT>(to_f(p[8 * LD + 4]), big[3], small[3]);
}

// A fragment from a C fragment, k relabelled as above.
template <bool EXACT>
__device__ __forceinline__ void a_from_c(const float c[4], uint32_t big[4], uint32_t small[4]) {
  split<EXACT>(c[0], big[0], small[0]);
  split<EXACT>(c[2], big[1], small[1]);
  split<EXACT>(c[1], big[2], small[2]);
  split<EXACT>(c[3], big[3], small[3]);
}

// B fragment with B[k][n] = tile[n0 + n][k0 + k] (the tile holds B transposed).
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void load_b_t(const T* tile, int n0, int k0, uint32_t big[2],
                                         uint32_t small[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (n0 + g) * LD + k0 + t;
  split<EXACT>(to_f(p[0]), big[0], small[0]);
  split<EXACT>(to_f(p[4]), big[1], small[1]);
}

// B fragment with B[k][n] = tile[k0 + row(k)][n0 + n], k relabelled: k = t is
// row 2t and k = t + 4 is row 2t + 1.
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void load_b_perm(const T* tile, int k0, int n0, uint32_t big[2],
                                            uint32_t small[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (k0 + 2 * t) * LD + n0 + g;
  split<EXACT>(to_f(p[0]), big[0], small[0]);
  split<EXACT>(to_f(p[LD]), big[1], small[1]);
}

// --- asynchronous copies ---------------------------------------------------------

// 16 bytes global -> shared; only the first src_bytes are read, the rest is zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, or zero when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major [s, d] matrix into a [ROWS][LD] tile,
// zero where a row is >= s or a column >= d (up to D). vec: every row is
// 16-byte aligned and d a multiple of the 16-byte chunk, so the copy is
// cp.async; else each element is loaded and stored by the threads.
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src, int row0, int s,
                                          int d, bool vec) {
  constexpr int LD = Ld<D, T>::value;
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (D / CH); i += THREADS) {
      const int r = i / (D / CH), c = (i % (D / CH)) * CH;
      const int g = row0 + r;
      const bool ok = g < s && c < d;
      cp_async16(tile + r * LD + c, ok ? src + (size_t)g * d + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int g = row0 + r;
      tile[r * LD + c] = (g < s && c < d) ? src[(size_t)g * d + c] : T(0.f);
    }
  }
}

// Entries [row0, row0 + n) of a length-s fp32 row statistic, 0 past s.
template <int THREADS>
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src, int row0,
                                          int n, int s) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool ok = row0 + i < s;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

}  // namespace pipe_tc
