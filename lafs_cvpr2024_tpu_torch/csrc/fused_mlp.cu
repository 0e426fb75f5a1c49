// Transformer MLP forward with dropout, no LayerNorm (kernel 4 of the
// PyTorch/CUDA port; mlp_impl='fused', the pre-MLP LayerNorm applied by
// the caller).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_fwd_kernel, called from _fwd_call):
//     u = x @ W1 + b1 (fp32 accumulate), optionally saved in x's dtype
//     y = drop_1(drop_0(gelu(u)) @ W2 + b2), h cast to x's dtype first
// It is kernel 2 without the LayerNorm prologue: the same body
// (fused_mlp_fwd.cuh), the same tiling and the same dropout hash (keyed by
// the JAX kernel's row tile, draw 0 for h, draw 1 for y), so kernel 5
// (fused_mlp_bwd.cu) regenerates its masks and the plain PyTorch version
// and the JAX CPU reference draw the same bits.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216
// tokens, D = 768, H = 2048, bf16, rate 0.1, u saved) the two products are
// 159 GFLOP against ~185 MB of compulsory traffic (x, y, the saved u and
// the weights): 0.16 ms of the bf16 tensor-core peak, so a tiled GEMM pair
// would be bound by operations. This form is bound by L2 traffic of the
// weights (32-row blocks each re-read both matrices, ~5 GB a call) and by
// wmma without a load pipeline, as kernel 2 is. What the TPU kernel was
// for, and what the design keeps: the (T, H) hidden activation and the
// masks never reach device memory (the saved u aside).

#include "fused_mlp_fwd.cuh"

namespace {

using namespace lafs_mlp;

template <int NT, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
                    const bf16* __restrict__ b2, bf16* __restrict__ y,
                    bf16* __restrict__ u_out, int T_rows, int H, Dropout drop) {
  mlp_fwd_bf16<NT, TRAIN, false>(x, nullptr, nullptr, w1t, b1, w2t, b2, y,
                                 u_out, T_rows, H, 0.0f, drop);
}

__global__ void __launch_bounds__(THREADS)
mlp_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                   const float* __restrict__ b1, const float* __restrict__ w2t,
                   const float* __restrict__ b2, float* __restrict__ y,
                   float* __restrict__ u_out, int T_rows, int D, int H,
                   Dropout drop) {
  mlp_fwd_f32<false>(x, nullptr, nullptr, w1t, b1, w2t, b2, y, u_out, T_rows,
                     D, H, 0.0f, drop);
}

template <int NT>
cudaError_t launch_bf16(const void* x, const void* w1t, const void* b1,
                        const void* w2t, const void* b2, void* y, void* u,
                        int T_rows, int H, Dropout drop, cudaStream_t s) {
  auto kernel = (drop.on || u != nullptr) ? mlp_fwd_bf16_kernel<NT, true>
                                          : mlp_fwd_bf16_kernel<NT, false>;
  return launch_rows(
      kernel, Bf16Layout<NT>::SMEM, T_rows, 1, s, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w1t), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2t), static_cast<const bf16*>(b2),
      static_cast<bf16*>(y), static_cast<bf16*>(u), T_rows, H, drop);
}

}  // namespace

// Widths as kernel 2: D a multiple of 128 up to 768, H a multiple of 128
// (checked by the Python wrapper). `u` may be null; `drop` = 0 turns
// dropout off, and then seed, thresh and inv_keep are not read.
extern "C" int lafs_fused_mlp_bf16(const void* x, const void* w1t,
                                   const void* b1, const void* w2t,
                                   const void* b2, void* y, void* u, int T_rows,
                                   int D, int H, unsigned seed, unsigned thresh,
                                   float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
#define LAFS_FWD_CASE(NT) \
  case NT * 128:          \
    return launch_bf16<NT>(x, w1t, b1, w2t, b2, y, u, T_rows, H, dr, s);
  switch (D) {
    LAFS_FWD_CASE(1)
    LAFS_FWD_CASE(2)
    LAFS_FWD_CASE(3)
    LAFS_FWD_CASE(4)
    LAFS_FWD_CASE(5)
    LAFS_FWD_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef LAFS_FWD_CASE
}

extern "C" int lafs_fused_mlp_f32(const void* x, const void* w1t,
                                  const void* b1, const void* w2t,
                                  const void* b2, void* y, void* u, int T_rows,
                                  int D, int H, unsigned seed, unsigned thresh,
                                  float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || H % F_HC) return cudaErrorInvalidValue;
  return launch_rows(
      mlp_fwd_f32_kernel, f32_smem_bytes(D), T_rows, 1, s,
      static_cast<const float*>(x), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(y),
      static_cast<float*>(u), T_rows, D, H,
      make_dropout(seed, thresh, inv_keep, drop, 64));
}
