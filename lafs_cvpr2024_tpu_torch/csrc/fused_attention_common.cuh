// Helpers shared by the fused-attention forward (fused_attention.cu,
// kernel 6) and backward (fused_attention_bwd.cu, kernel 7), and by the
// flash-attention kernels 11a-c (flash_attention*.cu):
// - lafs_attn: the first designs (kernels 11b-c, and the fp32 instances of
//   6, 7 and 11a): the block shape, dtype conversions, strided tile loads
//   and stores, and one block-wide product of two shared-memory tiles
//   (tensor cores for bf16, FMA for fp32);
// - lafs_attn::hop: the bf16 Hopper designs of kernels 6 and 7 (sm90.cuh):
//   products over 64-row TMA tiles, the row statistics over a quad, the
//   staged TMA store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "sm90.cuh"

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

// ----------------------------------------------------------------- bf16 --

namespace hop {

using namespace lafs_sm90;

constexpr int ROWS = 64;                    // rows of a tile: queries or keys
constexpr int TILE = ROWS * D * 2;          // one 64 x 64 bf16 TMA tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// Column and row half (0: row r, 1: row r + 8) of register i of an m64nN
// fp32 accumulator (sm90.cuh) in the thread at position `quad` of its quad
__device__ __forceinline__ int acc_col(int i, int quad) {
  return 8 * (i / 4) + 2 * quad + (i & 1);
}
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }

__device__ __forceinline__ void quad_max(float (&v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 1));
    v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 2));
  }
}

__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 1);
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 2);
  }
}

// acc (64 x 16·NT, fp32) = A Bᵀ over D: A one K-major 64-row tile at `a`,
// B the first 16·NT rows of the K-major 64-row tiles from `b` on, the last
// one cut to its 16-row slices (a width of 16, 32, 48 or 64: a template
// argument, so no branch surrounds a wgmma). Issues the wgmmas only: the
// caller fences, commits and waits.
template <int NT, int T = 0>
__device__ __forceinline__ void mma_abt(float* acc, uint32_t a, uint32_t b) {
  if constexpr (4 * T < NT) {
    constexpr int W = NT - 4 * T >= 4 ? 64 : 16 * (NT - 4 * T);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<W, 0>(acc + 32 * T, desc_sw128(a + 32 * kk, 16, 1024),
                     desc_sw128(b + T * TILE + 32 * kk, 16, 1024), kk > 0);
    mma_abt<NT, T + 1>(acc, a, b);
  }
}

// acc (64 x 64, fp32) += P B: P the bf16 A fragments of NT 16-column slices
// (pack_a), B 16·NT rows of the 64-row tiles from `b` on, read MN-major
// (the transpose bit: the tiles' rows are the product's depth).
template <int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[32],
                                       const uint32_t (&p)[NT][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk)
    wgmma_rs_n64<1>(acc, p[kk],
                    desc_sw128(b + (kk / 4) * TILE + 2048 * (kk % 4), TILE,
                               1024),
                    1);
}

// The A fragments of all NT 16-column slices of an accumulator, cast to
// bf16 (before the fence: no register changes between it and the product)
template <int NT>
__device__ __forceinline__ void pack_all(const float* acc,
                                         uint32_t (&p)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) pack_a(acc, kk, p[kk]);
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.0f;
}

// Calls f(std::integral_constant<int, W>) with W the width of a block of
// n <= 64 real rows cut to the next multiple of 16: a runtime width picks
// one of four templated bodies.
template <typename F>
__device__ __forceinline__ void by_width(int n, F&& f) {
  switch ((n + 15) / 16) {
    case 1: f(std::integral_constant<int, 16>{}); break;
    case 2: f(std::integral_constant<int, 32>{}); break;
    case 3: f(std::integral_constant<int, 48>{}); break;
    default: f(std::integral_constant<int, 64>{}); break;
  }
}

// The first sweep over one block of W keys (kn of them real) for this
// thread's rows of a 64-row query tile: S = Q Kᵀ, and with GRAD dA = dO Vᵀ,
// scaled into the log2 domain (c = scale · log2 e), keys at or past kn
// masked; then the online row max m (over the quad) and this thread's
// partial sums l = Σ p and, with GRAD, d = Σ p·dA, both rescaled with m.
template <int W, bool GRAD>
__device__ __forceinline__ void sweep_stats(float (&m)[2], float (&l)[2],
                                            float (&d)[2], uint32_t qa,
                                            uint32_t kb, uint32_t doa,
                                            uint32_t vb, int kn, int quad,
                                            float c) {
  constexpr int R = W / 2;
  float sc[R], da[GRAD ? R : 1];
  wgmma_fence();
  mma_abt<W / 16>(sc, qa, kb);
  if constexpr (GRAD) mma_abt<W / 16>(da, doa, vb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R>(sc);
  if constexpr (GRAD) reg_fence<R>(da);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sc[i] = acc_col(i, quad) < kn ? sc[i] * c : -INFINITY;
    mx[acc_half(i)] = fmaxf(mx[acc_half(i)], sc[i]);
  }
  quad_max(mx);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float alpha = ex2(m[e] - mx[e]);  // 0 on the first block
    l[e] *= alpha;
    d[e] *= alpha;
    m[e] = mx[e];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = acc_half(i);
    const float p = ex2(sc[i] - m[e]);  // masked keys: 0
    l[e] += p;
    if constexpr (GRAD) d[e] = fmaf(p, da[i], d[e]);
  }
}

// The second sweep over the same block: S (and dA) again, the normalised
// A = 2^(s·c - m) / l from the row's final statistics (il = 1 / l), and
// acc += cast(A) V, or with GRAD dS = A (dA - dd) and acc += cast(dS) K.
template <int W, bool GRAD>
__device__ __forceinline__ void sweep_out(float (&acc)[32],
                                          const float (&m)[2],
                                          const float (&il)[2],
                                          const float (&dd)[2], uint32_t qa,
                                          uint32_t kb, uint32_t doa,
                                          uint32_t vb, int kn, int quad,
                                          float c) {
  constexpr int NT = W / 16, R = W / 2;
  float sc[R], da[GRAD ? R : 1];
  wgmma_fence();
  mma_abt<NT>(sc, qa, kb);
  if constexpr (GRAD) mma_abt<NT>(da, doa, vb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R>(sc);
  if constexpr (GRAD) reg_fence<R>(da);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = acc_half(i);
    float a = acc_col(i, quad) < kn ? ex2(sc[i] * c - m[e]) * il[e] : 0.0f;
    if constexpr (GRAD) a *= da[i] - dd[e];
    sc[i] = a;
  }
  uint32_t p[NT][4];
  pack_all<NT>(sc, p);
  reg_fence<32>(acc);
  reg_fence(p);
  wgmma_fence();
  mma_pb<NT>(acc, p, GRAD ? kb : vb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<32>(acc);
}

// acc · mult as bf16 into the 128-byte-swizzled staging tile (`stage`, at
// shared address `stage_s`), then one TMA store of its 64 rows at `row` of
// (b, h); TMA drops rows at or past S. The consumer warpgroup (threads
// 0-127) calls it together; thread 0 issues the store, after the tile's
// previous store has read it.
__device__ __forceinline__ void store_tile(const float (&acc)[32], float mult,
                                           unsigned char* stage,
                                           uint32_t stage_s,
                                           const CUtensorMap* map, bool hs,
                                           int b, int h, int row, int r,
                                           int quad) {
  if (threadIdx.x == 0) tma_store_wait_read();
  bar_sync(1, 128);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int rr = r + 8 * acc_half(i), chunk = i / 4;
    *reinterpret_cast<uint32_t*>(stage + rr * 128 + ((chunk ^ (rr % 8)) * 16) +
                                 4 * quad) =
        pack_bf16(acc[i] * mult, acc[i + 1] * mult);
  }
  fence_proxy_async();
  bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_rows(map, stage_s, hs, b, h, row);
    tma_store_commit();
  }
}

// The maps of `n` (B, H, S, 64) operands, pointers p and element strides
// st (3 a map), each in the dim order its strides grow in; bit i of *hs
// says map i is (D, H, S, B).
inline cudaError_t maps(CUtensorMap* m, const void* const* p,
                        const long long* st, int n, int B, int H, int S,
                        int* hs) {
  *hs = 0;
  for (int i = 0; i < n; ++i) {
    const bool h = st[3 * i + 1] <= st[3 * i + 2];
    *hs |= (int)h << i;
    const cudaError_t err =
        lafs_sm90_host::bhsd_map(m + i, p[i], st + 3 * i, B, H, S, ROWS, h);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace hop

}  // namespace lafs_attn
