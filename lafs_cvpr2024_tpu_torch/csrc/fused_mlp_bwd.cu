// Transformer MLP backward, no LayerNorm (kernel 5 of the PyTorch/CUDA
// port; the backward of kernel 4, mlp_impl='fused').
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_bwd_kernel, called from _bwd_call). Per row, from the saved
// pre-activation u and the output gradient dy:
//     do  = drop_1(dy)                                  -> input dtype
//     hd  = drop_0(gelu(u))                             -> input dtype
//     dhd = do @ W2ᵀ                  (fp32 accumulate; w2t is (D, H))
//     du  = drop_0(dhd) * gelu'(u)                      -> input dtype
// and nothing more: dx = du·W1, dW1, dW2 and the bias sums are plain
// products outside the kernel, as the JAX package leaves them to XLA. Unlike
// kernel 3 it stops at du: no du·W1, no LayerNorm backward. drop_0/drop_1
// regenerate kernel 4's masks from the counter hash of
// fused_ln_mlp_common.cuh (same seed, same global rows).
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, H = 2048, bf16) the one product is 79 GFLOP and the compulsory
// traffic ~390 MB (u and dy in; do, hd and du out, three of them T x H):
// 0.12 ms at the card's memory rate, above the 0.08 ms of the tensor-core
// peak, so it is bound by bytes. A block owns ROWS = 32 rows, as kernel 3
// does: it stages do once in shared memory, then walks the hidden layer in
// HC-wide chunks, each chunk's dhd computed on the tensor cores (nvcuda::
// wmma, fp32 accumulate, W2 read from L2 per block) and passed through
// shared memory to the element-wise GELU′/mask pass that writes hd and du.
// The TPU kernel's (T, H) dhd never reaches device memory here either. fp32
// runs a scalar FMA loop over W2 chunks staged in shared memory. Rows past
// T read as dy = 0 and are never stored.

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace {

using namespace lafs_mlp;
using namespace nvcuda;

// NT = 16-column tiles of D per warp; D = NT * 16 * WARPS.
template <int NT>
struct MlpBwdLayout {
  static constexpr int D = NT * 16 * WARPS;
  static constexpr int LDX = D + 8;   // bf16 do rows (pad: bank spread)
  static constexpr int LDU = HC + 4;  // fp32 dhd chunk rows
  static constexpr int XS = ROWS * LDX * 2;
  static constexpr int SMEM = XS + ROWS * LDU * 4;
};

template <int NT>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ dy,
                    const bf16* __restrict__ w2t, bf16* __restrict__ do_,
                    bf16* __restrict__ hd, bf16* __restrict__ du, int T_rows,
                    int H, Dropout drop) {
  using L = MlpBwdLayout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dos = reinterpret_cast<bf16*>(smem);
  float* dhs = reinterpret_cast<float*>(smem + L::XS);

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_do(dy, do_, dos, L::LDX, row0, T_rows, D, drop);
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += HC) {
    // dhd[:, h0 + 16*warp : +16] = do @ W2ᵀ for both 16-row halves; the
    // (K = D, N = H) operand is w2t itself, row-major
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> d0, d1;
    wmma::fill_fragment(d0, 0.0f);
    wmma::fill_fragment(d1, 0.0f);
    const bf16* wcol = w2t + h0 + warp * 16;
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a0, dos + k, L::LDX);
      wmma::load_matrix_sync(a1, dos + 16 * L::LDX + k, L::LDX);
      wmma::load_matrix_sync(bw, wcol + (long long)k * H, H);
      wmma::mma_sync(d0, a0, bw, d0);
      wmma::mma_sync(d1, a1, bw, d1);
    }
    wmma::store_matrix_sync(dhs + warp * 16, d0, L::LDU, wmma::mem_row_major);
    wmma::store_matrix_sync(dhs + 16 * L::LDU + warp * 16, d1, L::LDU,
                            wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const long long row = row0 + r;
      if (row < T_rows)
        bwd_hidden(u, hd, du, dhs[r * L::LDU + c], row, H, h0 + c, drop);
    }
    __syncthreads();  // the next chunk overwrites dhs
  }
}

__host__ __device__ constexpr int mlp_bwd_f32_smem_bytes(int D) {
  return (ROWS * D + F_HC * (D + 1)) * 4;
}

__global__ void __launch_bounds__(THREADS)
mlp_bwd_f32_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ w2t, float* __restrict__ do_,
                   float* __restrict__ hd, float* __restrict__ du, int T_rows,
                   int D, int H, Dropout drop) {
  extern __shared__ __align__(128) float fsm[];
  float* dos = fsm;                    // (ROWS, D)
  float* wb = dos + ROWS * D;          // W2 chunk (F_HC, D+1)
  const int tid = threadIdx.x;
  const int n = tid % 32;              // hidden unit of the chunk
  const int rg = tid / 32;             // row group of 4 rows
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_do(dy, do_, dos, D, row0, T_rows, D, drop);

  for (int h0 = 0; h0 < H; h0 += F_HC) {
    __syncthreads();  // dos written / previous chunk's wb reads done
    for (int e = tid; e < F_HC * D; e += THREADS) {
      const int k = e / F_HC, nn = e % F_HC;
      wb[nn * (D + 1) + k] = w2t[(long long)k * H + h0 + nn];
    }
    __syncthreads();
    float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < D; ++k) {
      const float w = wb[n * (D + 1) + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) dh[q] += dos[(rg * 4 + q) * D + k] * w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = row0 + rg * 4 + q;
      if (row < T_rows) bwd_hidden(u, hd, du, dh[q], row, H, h0 + n, drop);
    }
  }
}

}  // namespace

// Widths as kernel 4: D a multiple of 128 up to 768, H a multiple of 128
// (checked by the Python wrapper). `drop` = 0 turns dropout off.
extern "C" int lafs_fused_mlp_bwd_bf16(const void* u, const void* dy,
                                       const void* w2t, void* do_, void* hd,
                                       void* du, int T_rows, int D, int H,
                                       unsigned seed, unsigned thresh,
                                       float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
#define LAFS_BWD_CASE(NT)                                                    \
  case NT * 128:                                                             \
    return launch_rows(mlp_bwd_bf16_kernel<NT>, MlpBwdLayout<NT>::SMEM,      \
                       T_rows, 1, s, static_cast<const bf16*>(u),            \
                       static_cast<const bf16*>(dy),                         \
                       static_cast<const bf16*>(w2t), static_cast<bf16*>(do_), \
                       static_cast<bf16*>(hd), static_cast<bf16*>(du), T_rows, \
                       H, dr);
  switch (D) {
    LAFS_BWD_CASE(1)
    LAFS_BWD_CASE(2)
    LAFS_BWD_CASE(3)
    LAFS_BWD_CASE(4)
    LAFS_BWD_CASE(5)
    LAFS_BWD_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef LAFS_BWD_CASE
}

extern "C" int lafs_fused_mlp_bwd_f32(const void* u, const void* dy,
                                      const void* w2t, void* do_, void* hd,
                                      void* du, int T_rows, int D, int H,
                                      unsigned seed, unsigned thresh,
                                      float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || H % F_HC) return cudaErrorInvalidValue;
  return launch_rows(
      mlp_bwd_f32_kernel, mlp_bwd_f32_smem_bytes(D), T_rows, 1, s,
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(w2t), static_cast<float*>(do_),
      static_cast<float*>(hd), static_cast<float*>(du), T_rows, D, H,
      make_dropout(seed, thresh, inv_keep, drop, 64));
}
