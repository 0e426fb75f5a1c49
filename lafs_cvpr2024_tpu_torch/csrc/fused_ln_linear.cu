// LayerNorm fused into a bias-free linear projection, forward (kernel 8 of
// the PyTorch/CUDA port; attn_impl='lnqkv', the pre-attention LayerNorm and
// the to_qkv projection).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_ln_linear.py
// (_fwd_kernel, called from _fwd_call):
//     xn = LN(x; g, bt) in fp32 (eps), cast to the input dtype
//     y  = xn @ Wᵀ                    (fp32 accumulate), cast to the input dtype
// W comes in PyTorch's nn.Linear layout, (O, D) row-major; every tensor in
// the input dtype. O is any width: the TPU kernel pads W to the next
// multiple of 128 (2,112 -> 2,176 for Part-fViT-B's to_qkv); here the last
// column block stages zero rows of W past O and stores no column past O.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, O = 2,112, bf16) the product is 82 GFLOP against ~150 MB of
// compulsory traffic (x in, W, y out): 0.083 ms of the tensor-core peak
// against 0.044 ms at the memory rate, so a tiled GEMM would be bound by
// operations. What the TPU kernel was for, and what the design keeps: the
// normalised activations never reach device memory. A block owns ROWS = 32
// token rows and BN = 128 output columns; it normalises its rows into
// shared memory (fp32 statistics, xn rounded to the input dtype, as the JAX
// kernel casts it) and walks D in KC-wide chunks of W staged through
// shared memory, the product on the tensor cores (nvcuda::wmma 16x16x16,
// fp32 accumulate; each warp owns 16 columns of both 16-row halves). Each
// row's statistics are recomputed by the ceil(O / BN) column blocks of its
// rows (x is re-read from L2, ~17 times at O = 2,112), and each block
// re-reads its (BN, D) slice of W from L2: simple and right, not yet the
// pipelined wgmma/TMA form. fp32 runs a scalar FMA loop over 64-column
// blocks. Rows past T are staged as zeros and never stored.

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace {

using namespace lafs_mlp;
using namespace nvcuda;

constexpr int BN = 128;       // output columns per block (bf16)
constexpr int KC = 64;        // D chunk of the staged W tile (bf16)
constexpr int LDW = KC + 8;   // bf16 W tile rows (pad: bank spread)
constexpr int LDO = BN + 4;   // fp32 output staging rows
constexpr int F_BN = 64;      // output columns per block (fp32)
constexpr int F_KC = 32;      // D chunk of the staged W tile (fp32)

__host__ __device__ constexpr int ln_linear_bf16_smem(int D) {
  return ROWS * (D + 8) * 2 + BN * LDW * 2;
}

__global__ void __launch_bounds__(THREADS)
ln_linear_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const bf16* __restrict__ bt, const bf16* __restrict__ w,
                          bf16* __restrict__ y, int T_rows, int D, int O,
                          float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + ROWS * ldx * 2);
  float* os = reinterpret_cast<float*>(ws);  // after the D loop: aliases ws
  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int n0 = blockIdx.y * BN;

  stage_rows<true>(x, g, bt, xs, ldx, row0, T_rows, D, eps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y0, y1;
  wmma::fill_fragment(y0, 0.0f);
  wmma::fill_fragment(y1, 0.0f);
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // xs staged / the previous chunk's ws reads done
    // W[n0 + n, k0 : k0 + KC] -> ws[n], 8 values a 16-byte load; rows past
    // O are zeros
    for (int e = threadIdx.x; e < BN * KC / 8; e += THREADS) {
      const int n = e / (KC / 8), c = (e % (KC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < O)
        v = *reinterpret_cast<const uint4*>(w + (long long)(n0 + n) * D + k0 + c);
      *reinterpret_cast<uint4*>(ws + n * LDW + c) = v;
    }
    __syncthreads();
    // y[:, n0 + 16*warp : +16] += xn[:, k0 : k0 + KC] @ W[.., k0 : k0 + KC]ᵀ;
    // ws read as the column-major (K, N) operand
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a0, xs + k0 + kk, ldx);
      wmma::load_matrix_sync(a1, xs + 16 * ldx + k0 + kk, ldx);
      wmma::load_matrix_sync(bw, ws + warp * 16 * LDW + kk, LDW);
      wmma::mma_sync(y0, a0, bw, y0);
      wmma::mma_sync(y1, a1, bw, y1);
    }
  }
  __syncthreads();  // ws is dead: it stages the output tile
  wmma::store_matrix_sync(os + warp * 16, y0, LDO, wmma::mem_row_major);
  wmma::store_matrix_sync(os + 16 * LDO + warp * 16, y1, LDO,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const long long row = row0 + r;
    if (row < T_rows && n0 + c < O) store(y + row * O + n0 + c, os[r * LDO + c]);
  }
}

__host__ __device__ constexpr int ln_linear_f32_smem(int D) {
  return (ROWS * D + F_BN * (F_KC + 1)) * 4;
}

// Thread (rg, n): output column n0 + n of the block's rows rg*8 .. rg*8+7.
__global__ void __launch_bounds__(THREADS)
ln_linear_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ bt, const float* __restrict__ w,
                         float* __restrict__ y, int T_rows, int D, int O,
                         float eps) {
  extern __shared__ __align__(128) float fsm[];
  float* xs = fsm;                // (ROWS, D)
  float* ws = xs + ROWS * D;      // W tile (F_BN, F_KC + 1)
  const int tid = threadIdx.x;
  const int n = tid % F_BN, rg = tid / F_BN;
  constexpr int RPT = ROWS * F_BN / THREADS;  // rows per thread: 8
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int n0 = blockIdx.y * F_BN;

  stage_rows<true>(x, g, bt, xs, D, row0, T_rows, D, eps);

  float acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += F_KC) {
    __syncthreads();  // xs staged / the previous chunk's ws reads done
    for (int e = tid; e < F_BN * F_KC; e += THREADS) {
      const int nn = e / F_KC, c = e % F_KC;
      ws[nn * (F_KC + 1) + c] =
          n0 + nn < O ? w[(long long)(n0 + nn) * D + k0 + c] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < F_KC; ++k) {
      const float wv = ws[n * (F_KC + 1) + k];
#pragma unroll
      for (int q = 0; q < RPT; ++q) acc[q] += xs[(rg * RPT + q) * D + k0 + k] * wv;
    }
  }
  if (n0 + n >= O) return;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const long long row = row0 + rg * RPT + q;
    if (row < T_rows) y[row * O + n0 + n] = acc[q];
  }
}

}  // namespace

// Widths the kernels take: D a multiple of 128 up to 768 (the staged rows),
// any O >= 1 (checked by the Python wrapper, which also checks that w is
// 16-byte aligned for the bf16 tile loads).
extern "C" int lafs_fused_ln_linear_bf16(const void* x, const void* g,
                                         const void* bt, const void* w, void* y,
                                         int T_rows, int D, int O, float eps,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || O <= 0) return cudaErrorInvalidValue;
  return launch_rows(ln_linear_fwd_bf16_kernel, ln_linear_bf16_smem(D), T_rows,
                     (O + BN - 1) / BN, s, static_cast<const bf16*>(x),
                     static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
                     static_cast<const bf16*>(w), static_cast<bf16*>(y), T_rows,
                     D, O, eps);
}

extern "C" int lafs_fused_ln_linear_f32(const void* x, const void* g,
                                        const void* bt, const void* w, void* y,
                                        int T_rows, int D, int O, float eps,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || O <= 0) return cudaErrorInvalidValue;
  return launch_rows(ln_linear_fwd_f32_kernel, ln_linear_f32_smem(D), T_rows,
                     (O + F_BN - 1) / F_BN, s, static_cast<const float*>(x),
                     static_cast<const float*>(g), static_cast<const float*>(bt),
                     static_cast<const float*>(w), static_cast<float*>(y),
                     T_rows, D, O, eps);
}
