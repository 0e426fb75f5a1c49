// Helpers shared by the LN-fused MLP forward (fused_ln_mlp.cu, kernel 2)
// and backward (fused_ln_mlp_bwd.cu, kernel 3): the block shape, dtype
// conversions, exact GELU and its derivative, and the dropout hash.
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

}  // namespace lafs_mlp
