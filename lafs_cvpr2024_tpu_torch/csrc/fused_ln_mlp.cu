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

#include "fused_mlp_fwd.cuh"

namespace {

using namespace lafs_mlp;

template <int NT, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ bt, const bf16* __restrict__ w1t,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
                   const bf16* __restrict__ b2, bf16* __restrict__ y,
                   bf16* __restrict__ u_out, int T_rows, int H, float eps,
                   Dropout drop) {
  mlp_fwd_bf16<NT, TRAIN, true>(x, g, bt, w1t, b1, w2t, b2, y, u_out, T_rows,
                                H, eps, drop);
}

__global__ void __launch_bounds__(THREADS)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ bt, const float* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ w2t,
                  const float* __restrict__ b2, float* __restrict__ y,
                  float* __restrict__ u_out, int T_rows, int D, int H, float eps,
                  Dropout drop) {
  mlp_fwd_f32<true>(x, g, bt, w1t, b1, w2t, b2, y, u_out, T_rows, D, H, eps,
                    drop);
}

// TRAIN = dropout on or u saved; the served path runs TRAIN = false.
template <int NT>
cudaError_t launch_bf16(const void* x, const void* g, const void* bt,
                        const void* w1t, const void* b1, const void* w2t,
                        const void* b2, void* y, void* u, int T_rows, int H,
                        float eps, Dropout drop, cudaStream_t s) {
  auto kernel = (drop.on || u != nullptr) ? ln_mlp_bf16_kernel<NT, true>
                                          : ln_mlp_bf16_kernel<NT, false>;
  return launch_rows(
      kernel, Bf16Layout<NT>::SMEM, T_rows, 1, s, static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
      static_cast<const bf16*>(w1t), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2t), static_cast<const bf16*>(b2),
      static_cast<bf16*>(y), static_cast<bf16*>(u), T_rows, H, eps, drop);
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
  return launch_rows(
      ln_mlp_f32_kernel, f32_smem_bytes(D), T_rows, 1, s,
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(y),
      static_cast<float*>(u), T_rows, D, H, eps,
      make_dropout(seed, thresh, inv_keep, drop, 64));
}
