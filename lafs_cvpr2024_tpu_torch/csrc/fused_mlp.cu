// Transformer MLP forward with dropout, no LayerNorm (kernel 4 of the
// PyTorch/CUDA port; mlp_impl='fused', the pre-MLP LayerNorm applied by
// the caller).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_fwd_kernel, called from _fwd_call):
//     u = x @ W1 + b1 (fp32 accumulate), optionally saved in x's dtype
//     y = drop_1(drop_0(gelu(u)) @ W2 + b2), h cast to x's dtype first
// It is kernel 2 without the LayerNorm, in both designs: the same bodies,
// the same tiling and the same dropout hash (keyed by the JAX
// kernel's row tile, draw 0 for h, draw 1 for y), so kernel 5
// (fused_mlp_bwd.cu) regenerates its masks and the plain PyTorch version
// and the JAX CPU reference draw the same bits.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216
// tokens, D = 768, H = 2048, bf16, rate 0.1, u saved) the two products are
// 159 GFLOP against ~185 MB of compulsory traffic (x, y, the saved u and
// the weights): 0.16 ms of the bf16 tensor-core peak, bound by operations.
//
// The design in bf16 at D = 768 with H a multiple of 256 (every full-width
// path) is kernel 2's persistent staged form (fused_ln_mlp_sm90.cuh,
// lafs_mlp_fwd::run with LN = false, launched as mlp_fwd_sm90) without its
// LN tiles: the
// hidden tiles read x itself through TMA (rows at or past T zero-filled),
// h goes through the wrapper's h scratch and back from L2, both products
// are 128-row m64n256k16 wgmma tiles from a 4-stage ring. Each (dropout, u
// saved) pair is its own template instance. The name holds no "ln_mlp_",
// so that profiles tell it from kernel 2.
//
// Other widths (D a multiple of 128 up to 640, or H % 256 = 128) keep the
// first design: 32-row blocks, each of which re-reads both weights from L2
// (~5 GB a call), nvcuda::wmma 16x16x16 through shared memory without a
// load pipeline (fused_mlp_fwd.cuh); fp32 (the precision check) runs its
// scalar FMA loop. The C entry points choose by (dtype, D, H).

#include "fused_ln_mlp_sm90.cuh"
#include "fused_mlp_fwd.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

// The body is fused_ln_mlp_sm90.cuh's lafs_mlp_fwd::run without the
// LayerNorm; the parameters are kernel 2's (mxn, g, bt, xn and eps
// unused), so that one host launch serves both.
template <bool DROP, bool SAVE_U>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_sm90(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap mxn,
             const __grid_constant__ CUtensorMap mw1,
             const __grid_constant__ CUtensorMap mh,
             const __grid_constant__ CUtensorMap mw2,
             const bf16* __restrict__ g, const bf16* __restrict__ bt,
             const bf16* __restrict__ b1, const bf16* __restrict__ b2,
             bf16* __restrict__ y, bf16* __restrict__ u_out,
             bf16* __restrict__ xn, bf16* __restrict__ hs, float eps,
             Dropout drop, lafs_mlp_fwd::Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  lafs_mlp_fwd::run<false, DROP, SAVE_U>(smem_raw, &mx, &mx, &mw1, &mh,
                                         &mw2, g, bt, b1, b2, y, u_out, xn,
                                         hs, eps, drop, plan);
}

cudaError_t run(const void* x, const void* w1t, const void* b1,
                const void* w2t, const void* b2, void* y, void* u, void* hs,
                void* sched, int T_rows, int H, Dropout drop, cudaStream_t s) {
  auto kernel = drop.on ? (u ? mlp_fwd_sm90<true, true>
                             : mlp_fwd_sm90<true, false>)
                        : (u ? mlp_fwd_sm90<false, true>
                             : mlp_fwd_sm90<false, false>);
  return lafs_ln_mlp_sm90_host::launch_fwd<false>(
      kernel, x, nullptr, nullptr, w1t, b1, w2t, b2, y, u, nullptr, hs, sched,
      T_rows, H, 0.0f, drop, s);
}

}  // namespace hop

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
// (checked by the Python wrapper); D = 768 with H a multiple of 256 runs
// the Hopper design, which also needs x, b1, b2 and the weights 16-byte
// aligned (TMA, 4-byte pair loads) and kernel 2's h and `sched` scratch
// (fused_ln_mlp.cu; no xn). `u` may be null; `drop` = 0 turns dropout off,
// and then seed, thresh and inv_keep are not read.
extern "C" int lafs_fused_mlp_bf16(const void* x, const void* w1t,
                                   const void* b1, const void* w2t,
                                   const void* b2, void* y, void* u, void* h,
                                   void* sched, int T_rows, int D, int H,
                                   unsigned seed, unsigned thresh,
                                   float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
  if (lafs_ln_mlp_sm90::takes(D, H))
    return hop::run(x, w1t, b1, w2t, b2, y, u, h, sched, T_rows, H, dr, s);
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

// The bf16 entry's arguments (h and sched unread).
extern "C" int lafs_fused_mlp_f32(const void* x, const void* w1t,
                                  const void* b1, const void* w2t,
                                  const void* b2, void* y, void* u, void* h,
                                  void* sched, int T_rows, int D, int H,
                                  unsigned seed, unsigned thresh,
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
