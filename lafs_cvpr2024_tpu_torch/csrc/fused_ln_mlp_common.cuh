// Helpers shared by the MLP kernels (2 and 4 forward, 3 and 5 backward)
// and the LN-fused linear (8 and 9): the block shape, dtype conversions,
// exact GELU and its derivative, the dropout hash, the row prologues (LN
// statistics, xn, the dropped-out output gradient) and the LayerNorm
// backward epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lafs_mlp {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 32;      // token rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HC = 128;       // hidden chunk of the bf16 kernels
constexpr int F_HC = 32;      // hidden chunk of the fp32 kernels
constexpr int F_MAX_D = 768;  // fp32 kernels: each thread owns D/256 columns
constexpr int F_MAX_M = F_MAX_D / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// d/du [u Phi(u)] = Phi(u) + u phi(u)
__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * expf(-0.5f * u * u) * 0.39894228040143268f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics of one row of D values, in fp32 with the TPU
// kernel's two-pass form; called by all 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ src, int D,
                                          float eps, int lane, float* mean,
                                          float* rstd) {
  float s = 0.0f;
  for (int k = lane; k < D; k += 32) s += to_f32(src[k]);
  const float m = warp_sum(s) / (float)D;
  float v = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float d = to_f32(src[k]) - m;
    v += d * d;
  }
  *mean = m;
  *rstd = rsqrtf(warp_sum(v) / (float)D + eps);
}

// Dropout of one call: the JAX kernel's interpret-mode counter hash
// (lafs_cvpr2024_tpu/ops/fused_mlp.py::_bits), keyed by (seed, row tile,
// draw, row in tile, column). `tile` is the JAX kernel's row tile (128 for
// bf16, 64 for fp32), not a tile of these kernels: the key is a function
// of the global row alone. Draw 0 masks the hidden activation, draw 1 the
// output. An element is kept when its bits are below `thresh`.
struct Dropout {
  uint32_t seed, thresh;
  float inv_keep;
  int on, tile;

  __device__ __forceinline__ bool keep(long long row, int col, uint32_t draw) const {
    const uint32_t t = (uint32_t)(row / tile), r = (uint32_t)(row % tile);
    uint32_t v = (r * 2654435761u) ^ ((uint32_t)col * 0x9E3779B9u) ^
                 (seed + t * 0xB5297A4Du + draw * 0x85EBCA6Bu);
    v = (v ^ (v >> 16)) * 0x7FEB352Du;
    v = (v ^ (v >> 15)) * 0x846CA68Bu;
    return (v ^ (v >> 16)) < thresh;
  }
  // v as the JAX kernel's where(mask, v * (1/keep), 0) leaves it
  __device__ __forceinline__ float apply(float v, long long row, int col,
                                         uint32_t draw) const {
    if (!on) return v;
    return keep(row, col, draw) ? v * inv_keep : 0.0f;
  }
};

inline Dropout make_dropout(unsigned seed, unsigned thresh, float inv_keep,
                            int on, int tile) {
  Dropout d;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.on = on;
  d.tile = tile;
  return d;
}

// fp32 kernels: floats of the weight-chunk buffer, which holds a (F_HC, D)
// chunk with rows padded to D + 1 or a (D, F_HC) one padded to F_HC + 1
__host__ __device__ constexpr int f32_wbuf(int D) {
  return F_HC * (D + 1) > D * (F_HC + 1) ? F_HC * (D + 1) : D * (F_HC + 1);
}

// The block's ROWS rows of x into shared memory (row stride ld) in x's
// dtype: LayerNorm-ed in fp32 with the TPU kernel's two-pass statistics
// (LN, kernels 2 and 8) or copied as they are (kernel 4); one warp per
// row. Rows past T are written as zeros.
template <bool LN, typename T>
__device__ void stage_rows(const T* __restrict__ x, const T* __restrict__ g,
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
    if (!LN) {
      for (int k = lane; k < D; k += 32) dst[k] = src[k];
      continue;
    }
    float mean, rstd;
    row_stats(src, D, eps, lane, &mean, &rstd);
    for (int k = lane; k < D; k += 32) {
      const float xh = (to_f32(src[k]) - mean) * rstd;
      store(dst + k, xh * to_f32(g[k]) + to_f32(bt[k]));
    }
  }
}

// Backward prologue (kernels 3 and 9): LN statistics of the block's rows
// into shared memory and xn = xhat * g + bt to device memory; with DO
// (kernel 3), in the same pass over each row, the dropped-out output
// gradient do = drop_1(dy), stored to device memory and into shared memory
// (row stride ldd) as the A operand of do @ W2ᵀ. One warp per row. Rows
// past T get mean = rstd = 0 and zero rows of do in shared memory.
template <bool DO, typename T>
__device__ void bwd_prologue(const T* __restrict__ x, const T* __restrict__ g,
                             const T* __restrict__ bt, T* __restrict__ xn,
                             float* mean_s, float* rstd_s, long long row0,
                             int T_rows, int D, float eps,
                             const T* __restrict__ dy, T* __restrict__ do_out,
                             T* dos, int ldd, const Dropout& drop) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    const long long row = row0 + r;
    if (row >= T_rows) {
      if (DO)
        for (int k = lane; k < D; k += 32) store(dos + r * ldd + k, 0.0f);
      if (lane == 0) mean_s[r] = rstd_s[r] = 0.0f;
      continue;
    }
    const T* src = x + row * D;
    float mean, rstd;
    row_stats(src, D, eps, lane, &mean, &rstd);
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
    for (int k = lane; k < D; k += 32) {
      const float xh = (to_f32(src[k]) - mean) * rstd;
      store(xn + row * D + k, xh * to_f32(g[k]) + to_f32(bt[k]));
      if (DO) {
        const float dv = drop.apply(to_f32(dy[row * D + k]), row, k, 1);
        store(do_out + row * D + k, dv);
        store(dos + r * ldd + k, dv);
      }
    }
  }
}

// Backward prologue of kernel 5 (no LayerNorm): the dropped-out output
// gradient do = drop_1(dy) of the block's rows, stored to device memory and
// into shared memory (row stride ldd, in T) as the A operand of do @ W2ᵀ.
// Rows past T are zeros in shared memory and never stored.
template <typename T>
__device__ void stage_do(const T* __restrict__ dy, T* __restrict__ do_out,
                         T* dos, int ldd, long long row0, int T_rows, int D,
                         const Dropout& drop) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, k = e % D;
    const long long row = row0 + r;
    float dv = 0.0f;
    if (row < T_rows) {
      dv = drop.apply(to_f32(dy[row * D + k]), row, k, 1);
      store(do_out + row * D + k, dv);
    }
    store(dos + r * ldd + k, dv);
  }
}

// One hidden element of a valid row (kernels 3 and 5): hd and du stored,
// du returned (before its rounding to T, which the caller's store applies).
template <typename T>
__device__ __forceinline__ float bwd_hidden(const T* __restrict__ u,
                                            T* __restrict__ hd, T* __restrict__ du,
                                            float dh, long long row, int H,
                                            int col, const Dropout& drop) {
  const float uv = to_f32(u[row * H + col]);
  float hv = gelu(uv);
  if (drop.on) {
    const bool keep = drop.keep(row, col, 0);
    hv = keep ? hv * drop.inv_keep : 0.0f;
    dh = keep ? dh * drop.inv_keep : 0.0f;
  }
  const float dv = dh * gelu_grad(uv);
  store(hd + row * H + col, hv);
  store(du + row * H + col, dv);
  return dv;
}

// LayerNorm backward epilogue (kernels 3 and 9): the block's dγ/dβ partial
// row, then dx, from the block's dxn staged in shared memory (row stride
// ldo) and the statistics of bwd_prologue.
template <typename T>
__device__ void bwd_epilogue(const float* os, int ldo, const float* mean_s,
                             const float* rstd_s, const T* __restrict__ x,
                             const T* __restrict__ g, T* __restrict__ dx,
                             float* __restrict__ dgp, float* __restrict__ dbp,
                             long long row0, int T_rows, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + r;
      if (row >= T_rows) break;
      const float v = os[r * ldo + c];
      sg += v * ((to_f32(x[row * D + c]) - mean_s[r]) * rstd_s[r]);
      sb += v;
    }
    dgp[(long long)blockIdx.x * D + c] = sg;
    dbp[(long long)blockIdx.x * D + c] = sb;
  }
  for (int r = warp; r < ROWS; r += WARPS) {
    const long long row = row0 + r;
    if (row >= T_rows) continue;
    const float mean = mean_s[r], rstd = rstd_s[r];
    const T* src = x + row * D;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float xh = (to_f32(src[k]) - mean) * rstd;
      const float dxh = os[r * ldo + k] * to_f32(g[k]);
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    for (int k = lane; k < D; k += 32) {
      const float xh = (to_f32(src[k]) - mean) * rstd;
      const float dxh = os[r * ldo + k] * to_f32(g[k]);
      store(dx + row * D + k, rstd * (dxh - m1 - xh * m2));
    }
  }
}

// Launch `kernel` over ceil(T / ROWS) row blocks (times `cols` column
// blocks) with `smem` bytes of dynamic shared memory; the launch's error.
template <typename... P, typename... A>
cudaError_t launch_rows(void (*kernel)(P...), int smem, int T_rows, int cols,
                        cudaStream_t s, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_rows + ROWS - 1) / ROWS, cols);
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace lafs_mlp
