// LayerNorm-fused transformer MLP forward with dropout (kernel 2 of the
// PyTorch/CUDA port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_ln_fwd_kernel, called from _ln_fwd_call):
//     xn = LN(x; g, bt) in fp32 (eps), cast to the input dtype
//     u  = xn @ W1 + b1            (fp32 accumulate), optionally saved
//     h  = drop_0(gelu(u)), exact erf form, cast to the input dtype
//     y  = drop_1(h @ W2 + b2)     (fp32 accumulate), cast to the input dtype
// The weights come in PyTorch's nn.Linear layout: w1t is (H, D), w2t is
// (D, H), both row-major; all tensors share the input dtype. The saved
// pre-activation u (T, H) is stored in the input dtype, as the JAX kernel
// saves it, for the backward kernel (fused_ln_mlp_bwd.cu). Dropout masks
// come from the counter hash of fused_ln_mlp_common.cuh, keyed by the
// global row, so the backward regenerates them and the plain PyTorch
// version and the JAX CPU reference draw the same bits.
//
// What bounds it on the card. At the served shape (T = 25,216 tokens,
// D = 768, H = 2048) the two products are 159 GFLOP against ~40 MB of
// activations and 6.3 MB of weights: a tiled GEMM would be bound by
// operations. This form is bound by L2 traffic of the weights instead. What
// the TPU kernel was for, and what this design keeps: the (T, H) hidden
// activation never reaches device memory (unless u is saved for training).
// A block owns ROWS token rows; it normalises them into shared memory once,
// then walks the hidden layer in HC-wide chunks: the chunk of u goes
// through shared memory (bias, GELU and the mask need the element layout
// that the tensor-core fragments hide), and the chunk's contribution to y
// is accumulated in tensor-core fragments that stay in registers for the
// whole loop. That register-resident (ROWS, 768) fp32 accumulator caps ROWS
// at 32, so every block re-reads both weight matrices from L2 (~5 GB per
// call at the served shape). Saving u adds T*H*2 bytes of stores (52 MB at
// the global crops' T = 12,608 in bf16), written from the same pass.
//
// bf16 runs on the tensor cores through nvcuda::wmma (16x16x16, fp32
// accumulate): simple and right, not yet the wgmma/TMA pipeline that
// Hopper's full rate needs. fp32 (the --eval-dtype float32 path) runs a
// scalar FMA loop over tiles staged in shared memory.
//
// The TPU kernel's A&S erf approximation (|err| <= 1.5e-7) is replaced by
// the exact erff. The ragged last row tile is masked: rows past T are
// normalised as zeros and never stored.

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace {

using namespace lafs_mlp;
using namespace nvcuda;

// LayerNorm of the block's ROWS rows into shared memory (row stride ld),
// in fp32 with the same two-pass statistics as the TPU kernel; one warp
// per row. Rows past T are written as zeros.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x, const T* __restrict__ g,
                                const T* __restrict__ bt, T* xs, int ld,
                                long long row0, int T_rows, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    T* dst = xs + r * ld;
    const long long row = row0 + r;
    if (row >= T_rows) {
      for (int k = lane; k < D; k += 32) store(dst + k, 0.0f);
      continue;
    }
    const T* src = x + row * D;
    float mean, rstd;
    row_stats(src, D, eps, lane, &mean, &rstd);
    for (int k = lane; k < D; k += 32) {
      const float xh = (to_f32(src[k]) - mean) * rstd;
      store(dst + k, xh * to_f32(g[k]) + to_f32(bt[k]));
    }
  }
}

// ---------------------------------------------------------------- bf16 --
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
template <int NT, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ bt, const bf16* __restrict__ w1t,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
                   const bf16* __restrict__ b2, bf16* __restrict__ y,
                   bf16* __restrict__ u_out, int T_rows, int H, float eps,
                   Dropout drop) {
  using L = Bf16Layout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* us = reinterpret_cast<float*>(smem + L::XS);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::XS + L::US);
  float* os = reinterpret_cast<float*>(smem);  // epilogue: aliases the rest

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  layer_norm_rows(x, g, bt, xs, L::LDX, row0, T_rows, D, eps);
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

template <int NT, bool TRAIN>
cudaError_t launch_bf16_as(const void* x, const void* g, const void* bt,
                           const void* w1t, const void* b1, const void* w2t,
                           const void* b2, void* y, void* u, int T_rows, int H,
                           float eps, Dropout drop, cudaStream_t s) {
  using L = Bf16Layout<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_bf16_kernel<NT, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (T_rows + ROWS - 1) / ROWS;
  ln_mlp_bf16_kernel<NT, TRAIN><<<blocks, THREADS, L::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(bt), static_cast<const bf16*>(w1t),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2t),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(u), T_rows, H, eps, drop);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bf16(const void* x, const void* g, const void* bt,
                        const void* w1t, const void* b1, const void* w2t,
                        const void* b2, void* y, void* u, int T_rows, int H,
                        float eps, Dropout drop, cudaStream_t s) {
  if (drop.on || u != nullptr)
    return launch_bf16_as<NT, true>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H,
                                    eps, drop, s);
  return launch_bf16_as<NT, false>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H,
                                   eps, drop, s);
}

// ---------------------------------------------------------------- fp32 --
__host__ __device__ constexpr int f32_smem_bytes(int D) {
  return (ROWS * D + f32_wbuf(D) + ROWS * F_HC) * 4;
}

__global__ void __launch_bounds__(THREADS)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ bt, const float* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ w2t,
                  const float* __restrict__ b2, float* __restrict__ y,
                  float* __restrict__ u_out, int T_rows, int D, int H, float eps,
                  Dropout drop) {
  extern __shared__ __align__(128) float fsm[];
  float* xs = fsm;                   // (ROWS, D)
  float* wb = xs + ROWS * D;         // W1 chunk (F_HC, D+1) or W2 chunk (D, F_HC+1)
  float* hs = wb + f32_wbuf(D);      // (ROWS, F_HC)
  const int tid = threadIdx.x;
  const int n = tid % 32;            // hidden unit of the chunk (u phase)
  const int rg = tid / 32;           // row group of 4 rows (u phase)
  const long long row0 = (long long)blockIdx.x * ROWS;

  layer_norm_rows(x, g, bt, xs, D, row0, T_rows, D, eps);

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

}  // namespace

// Widths the kernels take: D a multiple of 128 up to 768, H a multiple of
// 128. The Python wrapper checks the same and raises before calling. `u`
// may be null (no saved pre-activation); `drop` = 0 turns dropout off, and
// then seed, thresh and inv_keep are not read.
extern "C" int lafs_fused_ln_mlp_bf16(const void* x, const void* g, const void* bt,
                                      const void* w1t, const void* b1,
                                      const void* w2t, const void* b2, void* y,
                                      void* u, int T_rows, int D, int H,
                                      float eps, unsigned seed, unsigned thresh,
                                      float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
  switch (D) {
    case 128: return launch_bf16<1>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    case 256: return launch_bf16<2>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    case 384: return launch_bf16<3>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    case 512: return launch_bf16<4>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    case 640: return launch_bf16<5>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    case 768: return launch_bf16<6>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int lafs_fused_ln_mlp_f32(const void* x, const void* g, const void* bt,
                                     const void* w1t, const void* b1,
                                     const void* w2t, const void* b2, void* y,
                                     void* u, int T_rows, int D, int H,
                                     float eps, unsigned seed, unsigned thresh,
                                     float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || H % F_HC) return cudaErrorInvalidValue;
  const int smem = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T_rows + ROWS - 1) / ROWS;
  ln_mlp_f32_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(y),
      static_cast<float*>(u), T_rows, D, H, eps,
      make_dropout(seed, thresh, inv_keep, drop, 64));
  return cudaGetLastError();
}
