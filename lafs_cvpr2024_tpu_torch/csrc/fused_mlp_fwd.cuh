// The MLP forward body shared by kernel 2 (fused_ln_mlp.cu, LayerNorm in
// the prologue) and kernel 4 (fused_mlp.cu, x taken as it is):
//     xn = LN(x; g, bt) or x, in the input dtype
//     u  = xn @ W1 + b1            (fp32 accumulate), optionally saved
//     h  = drop_0(gelu(u)), exact erf form, cast to the input dtype
//     y  = drop_1(h @ W2 + b2)     (fp32 accumulate), cast to the input dtype
// Weights in PyTorch's nn.Linear layout: w1t is (H, D), w2t is (D, H), both
// row-major; every tensor in the input dtype. Each kernel file wraps these
// bodies in its own __global__ functions, so a profile names them apart.
//
// A block owns ROWS token rows; it stages them (normalised or not) in
// shared memory once, then walks the hidden layer in HC-wide chunks: the
// chunk of u goes through shared memory (bias, GELU and the mask need the
// element layout that the tensor-core fragments hide), and the chunk's
// contribution to y is accumulated in tensor-core fragments that stay in
// registers for the whole loop. That register-resident (ROWS, D) fp32
// accumulator caps ROWS at 32, so every block re-reads both weight
// matrices from L2. bf16 runs on the tensor cores through nvcuda::wmma
// (16x16x16, fp32 accumulate); fp32 runs a scalar FMA loop over tiles
// staged in shared memory. Rows past T are staged as zeros and never
// stored.
#pragma once

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace lafs_mlp {

// NT = output column tiles (16 wide) per warp; D = NT * 16 * WARPS.
template <int NT>
struct Bf16Layout {
  static constexpr int D = NT * 16 * WARPS;
  static constexpr int LDX = D + 8;   // bf16 xn rows (pad: bank spread)
  static constexpr int LDU = HC + 4;  // fp32 u chunk rows
  static constexpr int LDH = HC + 8;  // bf16 h chunk rows
  static constexpr int LDO = D + 4;   // fp32 output staging rows
  static constexpr int XS = ROWS * LDX * 2;
  static constexpr int US = ROWS * LDU * 4;
  static constexpr int HS = ROWS * LDH * 2;
  static constexpr int OS = ROWS * LDO * 4;
  static constexpr int MAIN = XS + US + HS;
  static constexpr int SMEM = MAIN > OS ? MAIN : OS;
};

// TRAIN = dropout on or u saved. The served path (rate 0, no u) runs the
// TRAIN = false instance, which carries neither branch nor their registers.
template <int NT, bool TRAIN, bool LN>
__device__ __forceinline__ void mlp_fwd_bf16(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    const bf16* __restrict__ bt, const bf16* __restrict__ w1t,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
    const bf16* __restrict__ b2, bf16* __restrict__ y,
    bf16* __restrict__ u_out, int T_rows, int H, float eps,
    const Dropout& drop) {
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

  stage_rows<LN>(x, g, bt, xs, L::LDX, row0, T_rows, D, eps);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::fill_fragment(acc[0][t], 0.0f);
    wmma::fill_fragment(acc[1][t], 0.0f);
  }

  for (int h0 = 0; h0 < H; h0 += HC) {
    // u[:, h0 + 16*warp : +16] = xn @ W1 for both 16-row halves
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> u0, u1;
      wmma::fill_fragment(u0, 0.0f);
      wmma::fill_fragment(u1, 0.0f);
      const bf16* wcol = w1t + (long long)(h0 + warp * 16) * D;
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a0, xs + k, L::LDX);
        wmma::load_matrix_sync(a1, xs + 16 * L::LDX + k, L::LDX);
        wmma::load_matrix_sync(bw, wcol + k, D);
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
      const long long row = row0 + r;
      const float u = us[r * L::LDU + c] + to_f32(b1[h0 + c]);
      if (TRAIN && u_out != nullptr && row < T_rows)
        store(u_out + row * H + h0 + c, u);
      const float hv = gelu(u);
      store(hs + r * L::LDH + c, TRAIN ? drop.apply(hv, row, h0 + c, 0) : hv);
    }
    __syncthreads();
    // acc += h_chunk @ W2[h0 : h0 + HC, this warp's columns]
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hs + kk, L::LDH);
      wmma::load_matrix_sync(a1, hs + 16 * L::LDH + kk, L::LDH);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp * NT + t) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, w2t + (long long)n0 * H + h0 + kk, H);
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
      const float o = os[r * L::LDO + c] + to_f32(b2[c]);
      store(y + row * D + c, TRAIN ? drop.apply(o, row, c, 1) : o);
    }
  }
}

__host__ __device__ constexpr int f32_smem_bytes(int D) {
  return (ROWS * D + f32_wbuf(D) + ROWS * F_HC) * 4;
}

template <bool LN>
__device__ __forceinline__ void mlp_fwd_f32(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ bt, const float* __restrict__ w1t,
    const float* __restrict__ b1, const float* __restrict__ w2t,
    const float* __restrict__ b2, float* __restrict__ y,
    float* __restrict__ u_out, int T_rows, int D, int H, float eps,
    const Dropout& drop) {
  extern __shared__ __align__(128) float fsm[];
  float* xs = fsm;                   // (ROWS, D)
  float* wb = xs + ROWS * D;         // W1 chunk (F_HC, D+1) or W2 chunk (D, F_HC+1)
  float* hs = wb + f32_wbuf(D);      // (ROWS, F_HC)
  const int tid = threadIdx.x;
  const int n = tid % 32;            // hidden unit of the chunk (u phase)
  const int rg = tid / 32;           // row group of 4 rows (u phase)
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_rows<LN>(x, g, bt, xs, D, row0, T_rows, D, eps);

  float acc[F_MAX_M][ROWS];
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += F_HC) {
    __syncthreads();  // xs written / previous chunk's wb reads done
    for (int e = tid; e < F_HC * D; e += THREADS) {
      const int nn = e / D, k = e % D;
      wb[nn * (D + 1) + k] = w1t[(long long)(h0 + nn) * D + k];
    }
    __syncthreads();
    float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < D; ++k) {
      const float w = wb[n * (D + 1) + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] += xs[(rg * 4 + q) * D + k] * w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = row0 + rg * 4 + q;
      const float uv = u[q] + b1[h0 + n];
      if (u_out != nullptr && row < T_rows) u_out[row * H + h0 + n] = uv;
      hs[(rg * 4 + q) * F_HC + n] = drop.apply(gelu(uv), row, h0 + n, 0);
    }
    __syncthreads();
    for (int e = tid; e < D * F_HC; e += THREADS) {
      const int c = e / F_HC, nn = e % F_HC;
      wb[c * (F_HC + 1) + nn] = w2t[(long long)c * H + h0 + nn];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < F_MAX_M; ++m) {
      const int c = tid + THREADS * m;
      if (c < D) {
        for (int nn = 0; nn < F_HC; ++nn) {
          const float w = wb[c * (F_HC + 1) + nn];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[m][r] += hs[r * F_HC + nn] * w;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m) {
    const int c = tid + THREADS * m;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + r;
      if (row < T_rows) y[row * D + c] = drop.apply(acc[m][r] + b2[c], row, c, 1);
    }
  }
}

}  // namespace lafs_mlp
