// Helpers shared by the fused-attention forward (fused_attention.cu,
// kernel 6) and backward (fused_attention_bwd.cu, kernel 7): the block
// shape, dtype conversions, strided tile loads and stores, and one block-wide
// product of two shared-memory tiles (tensor cores for bf16, FMA for fp32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

namespace lafs_attn {

using bf16 = __nv_bfloat16;

constexpr int D = 64;         // head width the kernels take
constexpr int MAX_S = 512;    // longest sequence (the JAX kernel's window)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDO = D + 4;    // fp32 (rows, D) staging tiles

// Row padding of shared tiles in elements: 16 bytes, which keeps rows
// aligned for 16-byte loads and tensor-core fragments and spreads banks.
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The attention probability of one logit from its row's max and sum, as
// the JAX kernel forms it: exp(s * scale - m) / sum. The _rn intrinsics are
// never contracted into an FMA, so the backward's two passes recompute the
// same bits.
__device__ __forceinline__ float prob(float s, float scale, float m,
                                      float sum) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(s, scale), m)), sum);
}

// dS = A (dA - rowsum(dA A)) for one element
__device__ __forceinline__ float dlogit(float a, float da, float dq) {
  return __fmul_rn(a, __fsub_rn(da, dq));
}

// Element strides of one (B, H, S, D) operand; D is contiguous. Each stride
// is a multiple of 16 bytes (the wrapper checks it), so rows load as uint4.
struct Strides {
  long long b, h, s;
};

// Rows [row0, row0 + rows) of one (b, h) slice into a shared tile with row
// stride ld; rows at or past S are zeros.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* __restrict__ src,
                          long long rs, int row0, int rows, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int e = threadIdx.x; e < rows * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// Rows [row0, row0 + rows) of an fp32 (rows, D) staging tile, times mult,
// into one (b, h) slice of the output; rows at or past S are not stored.
template <typename T>
__device__ void store_rows(T* __restrict__ dst, long long rs, const float* src,
                           int ld, float mult, int row0, int rows, int S) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e % D;
    if (row0 + r < S)
      store(dst + (long long)(row0 + r) * rs + c, src[r * ld + c] * mult);
  }
}

// C (M x N, fp32, row stride ldc) = A (M x K) B (K x N), or += when acc,
// with A, B and C in shared memory. A_ROW: element (r, c) of A at
// A[r * lda + c], else at A[r + c * lda]; likewise B_ROW for B. bf16 runs on
// the tensor cores (nvcuda::wmma 16x16x16, fp32 accumulate; M, N and K
// multiples of 16); fp32 runs one FMA chain per element over k in order.
template <typename T, bool A_ROW, bool B_ROW>
__device__ void block_gemm(float* C, int ldc, const T* A, int lda, const T* B,
                           int ldb, int M, int N, int K, bool acc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major,
                                         wmma::col_major>::type;
    const int warp = threadIdx.x / 32;
    const int tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += WARPS) {
      const int i0 = (t / tn) * 16, j0 = (t % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc)
        wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.0f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, A + (A_ROW ? i0 * lda + k0 : i0 + k0 * lda),
                               lda);
        wmma::load_matrix_sync(b, B + (B_ROW ? k0 * ldb + j0 : k0 + j0 * ldb),
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += THREADS) {
      const int i = e / N, j = e % N;
      float s = acc ? C[i * ldc + j] : 0.0f;
      for (int k = 0; k < K; ++k)
        s = fmaf(A[A_ROW ? i * lda + k : i + k * lda],
                 B[B_ROW ? k * ldb + j : k + j * ldb], s);
      C[i * ldc + j] = s;
    }
  }
}

// Bytes of shared memory, each region rounded up to 128 bytes.
__host__ __device__ constexpr int round128(long long bytes) {
  return (int)((bytes + 127) / 128 * 128);
}

__host__ __device__ constexpr int pad_seq(int S) { return (S + 15) / 16 * 16; }

__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

}  // namespace lafs_attn
