// Bias-free fused transformer MLP forward with dropout, bf16 in and out
// (row 10 of the port's kernel table).
//
// Replaces the Pallas TPU kernel benchmarks/bench_mlp_fusion.py (_mlp_kernel,
// called from pallas_mlp):
//     h = drop_0(gelu(x @ W1))   fp32 accumulate, exact GELU, dropout in fp32
//     y = drop_1(bf16(h) @ W2)   fp32 accumulate, dropout in fp32, bf16 out
// for x (T, D) and the JAX layout of the weights, input by output: W1 is
// (D, H) and W2 is (H, D), both row-major bf16. No biases, no saved
// pre-activation. Kept elements are scaled by the fp32 1/keep (the TPU kernel
// divides by keep: at most one fp32 ulp apart, before the bf16 casts).
//
// GELU is erff's exact form (gelu() of fused_ln_mlp_common.cuh); the TPU
// kernel uses the Abramowitz-Stegun rational erf (|error| <= 1.5e-7), since
// Mosaic has no erf. Both are below bf16's resolution.
//
// Dropout bits. No GPU reproduces the TPU's hardware PRNG
// (pltpu.prng_seed(seed + program_id)). The kernel and its plain PyTorch
// version (ops/mlp_fusion.py) draw the same bits from the port's counter
// hash (Dropout, fused_ln_mlp_common.cuh), keyed by the seed, the TPU
// kernel's 256-row token tile, the draw (0 for h, 1 for y), the row in the
// tile and the column; the keep threshold is the TPU kernel's 32-bit
// round(keep * 2^32). The TPU kernel pads T to a multiple of 256 and slices
// its output; here the ragged last block stages zero rows and stores only
// rows below T.
//
// The design is kernel 4's body (fused_mlp_fwd.cuh) with B fragments loaded
// row-major from the JAX layout: a block owns 32 token rows staged once in
// shared memory, walks the hidden layer in 128-wide chunks (the chunk of
// x @ W1 goes through shared memory for GELU and the mask), and keeps the
// (32, D) fp32 output accumulator in tensor-core fragments for the whole
// loop, so the (T, H) hidden activation and the masks never reach device
// memory, which is what the TPU kernel was for.
//
// What bounds it on the card. At the microbenchmark's shape (T = 22,080,
// D = 768, H = 2048) the two products are 139 GFLOP against ~74 MB of
// compulsory traffic: 0.14 ms of the bf16 tensor-core peak, bound by
// operations. This form is bound instead by L2 traffic of the weights (every
// 32-row block re-reads both matrices, ~4.4 GB a call) and by wmma without a
// load pipeline, as kernels 2 and 4 are; TMA-fed wgmma tiles are the later
// redesign.

#include "fused_mlp_fwd.cuh"

namespace {

using namespace lafs_mlp;

constexpr int TPU_TILE = 256;  // the TPU kernel's token tile: the hash key

template <int NT, bool DROP>
__global__ void __launch_bounds__(THREADS)
mlp_fusion_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const bf16* __restrict__ w2, bf16* __restrict__ y,
                       int T_rows, int H, Dropout drop) {
  using namespace nvcuda;
  using L = Bf16Layout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* us = reinterpret_cast<float*>(smem + L::XS);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::XS + L::US);
  float* os = reinterpret_cast<float*>(smem);  // epilogue: aliases the rest

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_rows<false, bf16>(x, nullptr, nullptr, xs, L::LDX, row0, T_rows, D,
                          0.0f);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::fill_fragment(acc[0][t], 0.0f);
    wmma::fill_fragment(acc[1][t], 0.0f);
  }

  for (int h0 = 0; h0 < H; h0 += HC) {
    // u[:, h0 + 16*warp : +16] = x @ W1 for both 16-row halves; W1's tile
    // (k : k+16, col : col+16) is row-major with leading dimension H
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> u0, u1;
      wmma::fill_fragment(u0, 0.0f);
      wmma::fill_fragment(u1, 0.0f);
      const bf16* wcol = w1 + h0 + warp * 16;
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(a0, xs + k, L::LDX);
        wmma::load_matrix_sync(a1, xs + 16 * L::LDX + k, L::LDX);
        wmma::load_matrix_sync(bw, wcol + (long long)k * H, H);
        wmma::mma_sync(u0, a0, bw, u0);
        wmma::mma_sync(u1, a1, bw, u1);
      }
      wmma::store_matrix_sync(us + warp * 16, u0, L::LDU, wmma::mem_row_major);
      wmma::store_matrix_sync(us + 16 * L::LDU + warp * 16, u1, L::LDU,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const float hv = gelu(us[r * L::LDU + c]);
      store(hs + r * L::LDH + c,
            DROP ? drop.apply(hv, row0 + r, h0 + c, 0) : hv);
    }
    __syncthreads();
    // acc += h_chunk @ W2[h0 : h0 + HC, this warp's columns]; W2's tile is
    // row-major with leading dimension D
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hs + kk, L::LDH);
      wmma::load_matrix_sync(a1, hs + 16 * L::LDH + kk, L::LDH);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp * NT + t) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, w2 + (long long)(h0 + kk) * D + n0, D);
        wmma::mma_sync(acc[0][t], a0, bw, acc[0][t]);
        wmma::mma_sync(acc[1][t], a1, bw, acc[1][t]);
      }
    }
    // the next chunk writes us (free since the GELU pass) and, after its
    // first barrier, hs (free once every warp passed that barrier)
  }
  __syncthreads();  // xs/us/hs are dead: the staging buffer aliases them
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n0 = (warp * NT + t) * 16;
    wmma::store_matrix_sync(os + n0, acc[0][t], L::LDO, wmma::mem_row_major);
    wmma::store_matrix_sync(os + 16 * L::LDO + n0, acc[1][t], L::LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const long long row = row0 + r;
    if (row < T_rows) {
      const float o = os[r * L::LDO + c];
      store(y + row * D + c, DROP ? drop.apply(o, row, c, 1) : o);
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* y,
                   int T_rows, int H, Dropout drop, cudaStream_t s) {
  auto kernel = drop.on ? mlp_fusion_bf16_kernel<NT, true>
                        : mlp_fusion_bf16_kernel<NT, false>;
  return launch_rows(kernel, Bf16Layout<NT>::SMEM, T_rows, 1, s,
                     static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(w2), static_cast<bf16*>(y),
                     T_rows, H, drop);
}

}  // namespace

// x (T, D), w1 (D, H), w2 (H, D), y (T, D), all bf16 and row-major; D a
// multiple of 128 up to 768, H a multiple of 128 (checked by the Python
// wrapper). `drop` = 0 turns dropout off, and then seed, thresh and inv_keep
// are not read.
extern "C" int lafs_mlp_fusion_bf16(const void* x, const void* w1,
                                    const void* w2, void* y, int T_rows, int D,
                                    int H, unsigned seed, unsigned thresh,
                                    float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, TPU_TILE);
#define LAFS_MLP_FUSION_CASE(NT) \
  case NT * 128:                 \
    return launch<NT>(x, w1, w2, y, T_rows, H, dr, s);
  switch (D) {
    LAFS_MLP_FUSION_CASE(1)
    LAFS_MLP_FUSION_CASE(2)
    LAFS_MLP_FUSION_CASE(3)
    LAFS_MLP_FUSION_CASE(4)
    LAFS_MLP_FUSION_CASE(5)
    LAFS_MLP_FUSION_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef LAFS_MLP_FUSION_CASE
}
