// LayerNorm-fused transformer MLP forward with dropout (kernel 2 of the
// PyTorch/CUDA port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_ln_fwd_kernel, called from _ln_fwd_call):
//     xn = LN(x; g, bt) in fp32 (eps), cast to the input dtype
//     u  = xn @ W1 + b1            (fp32 accumulate), optionally saved
//     h  = drop_0(gelu(u)), cast to the input dtype
//     y  = drop_1(h @ W2 + b2)     (fp32 accumulate), cast to the input dtype
// The weights come in PyTorch's nn.Linear layout: w1t is (H, D), w2t is
// (D, H), both row-major; all tensors share the input dtype. The saved
// pre-activation u (T, H) is stored in the input dtype, as the JAX kernel
// saves it, for the backward kernel (fused_ln_mlp_bwd.cu). Dropout masks
// come from the counter hash of fused_ln_mlp_common.cuh, keyed by the
// global row and the JAX kernel's row tile (128 rows in bf16, 64 in fp32),
// so the backward regenerates them and the plain PyTorch version and the
// JAX CPU reference draw the same bits. GELU's erf is the TPU kernel's A&S
// approximation (|err| <= 1.5e-7) in the Hopper design (phi_as of
// fused_ln_mlp_sm90.cuh, which kernels 3-5 share) and the exact erff in the
// first; both lie below bf16's resolution.
//
// What bounds it on the card. At the served shape (T = 25,216 tokens,
// D = 768, H = 2048) the two products are 159 GFLOP against ~40 MB of
// activations and 6.3 MB of weights: 0.16 ms of the bf16 tensor-core peak,
// bound by operations (0.08 ms at the SSL global crops' T = 12,608, where
// saving u adds 52 MB of stores). What the TPU kernel was for, and what
// the design keeps: the (T, H) hidden activation never reaches device
// memory (unless u is saved for training). The price of keeping it on chip
// is that a block can hold only so many output rows (the (rows, 768) fp32
// accumulator lives in registers), and every block takes in both weight
// matrices once per its rows: the weight bytes each SM ingests, not the
// tensor cores, bound a fused form.
//
// The design in bf16 at D = 768 with H a multiple of 256 (every full-width
// path) is row 10's cluster form (fused_ln_mlp_sm90.cuh, mlp_fusion.cu):
// a 2-CTA cluster owns 64 rows, so the weights are read once per 64 rows
// (6.3 MB a cluster, ~2.5 GB a call at the served T; the first design's
// 32-row blocks read ~5 GB), TMA feeds m64nNk16 wgmmas from a 2-stage ring,
// and both products accumulate in registers. A CTA still ingests 393 KB of
// weight slabs a chunk for its 64 rows (32 FLOP a byte): a 4-CTA form that
// multicast each slab to two row pairs halved the L2 reads but not that,
// and ran slower. Kernel 2's own parts:
// - the prologue: the producer TMA-loads the (64, 768) x tile (rows at or
//   past T zero-filled); the consumers normalise it in place, a warp a row
//   (fp32 two-pass statistics, then xn = bf16(xhat * g + bt) written back
//   into the swizzled layout), then fence the generic-proxy writes for the
//   wgmmas' async-proxy reads and meet at a named barrier;
// - both weights are K-major wgmma operands (the nn.Linear layout): a
//   first-product slab of a warpgroup is three 64 x 64 boxes of w1t (64
//   hidden units by 192 of K), a second-product slab one 192 x 64 box of
//   w2t (192 output columns by 64 hidden units);
// - per chunk: u = xn W1ᵀ + b1 in registers; u is stored as bf16 pairs
//   straight from the accumulator fragments where saved (each CTA its own
//   128 columns: 4-byte stores, 16 contiguous bytes a quad); then GELU and
//   draw 0 in registers, the bf16 h into both CTAs' h buffers;
// - the epilogue adds b2, applies draw 1 and stores y for rows below T.
// Each (dropout, u saved) pair is its own template instance, so the served
// rate-0 path carries neither branch, and no product sits in a runtime
// branch (ptxas serialises every wgmma of such a kernel: warning C7520).
//
// Other widths (D a multiple of 128 up to 640, or H % 256 = 128) keep the
// first design: nvcuda::wmma 16x16x16 over 32-row blocks through shared
// memory (fused_mlp_fwd.cuh); fp32 (the --eval-dtype float32 path and the
// precision check) runs its scalar FMA loop. The C entry points choose by
// (dtype, D, H).

#include "fused_ln_mlp_sm90.cuh"
#include "fused_mlp_fwd.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

// The body is fused_ln_mlp_sm90.cuh::mlp_fwd_cta with the LayerNorm.
template <bool DROP, bool SAVE_U>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
ln_mlp_fwd_sm90(const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mw1,
                const __grid_constant__ CUtensorMap mw2,
                const bf16* __restrict__ g, const bf16* __restrict__ bt,
                const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                bf16* __restrict__ y, bf16* __restrict__ u_out, int T_rows,
                int H, float eps, Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  mlp_fwd_cta<true, DROP, SAVE_U>(smem_raw, &mx, &mw1, &mw2, g, bt, b1, b2, y,
                                  u_out, T_rows, H, eps, drop);
}

cudaError_t run(const void* x, const void* g, const void* bt, const void* w1t,
                const void* b1, const void* w2t, const void* b2, void* y,
                void* u, int T_rows, int H, float eps, Dropout drop,
                cudaStream_t s) {
  auto kernel = drop.on ? (u ? ln_mlp_fwd_sm90<true, true>
                             : ln_mlp_fwd_sm90<true, false>)
                        : (u ? ln_mlp_fwd_sm90<false, true>
                             : ln_mlp_fwd_sm90<false, false>);
  return lafs_ln_mlp_sm90_host::launch_fwd(kernel, x, g, bt, w1t, b1, w2t, b2,
                                           y, u, T_rows, H, eps, drop, s);
}

// An empty kernel for cudaOccupancyMaxActiveClusters: the launch shape
// alone (cluster size, threads, shared memory) decides the answer.
__global__ void cluster_probe() {}

}  // namespace hop

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
// 128 (the Python wrapper checks the same and raises before calling); D =
// 768 with H a multiple of 256 runs the Hopper design, which also needs x,
// g, bt, b1, b2 and the weights 16-byte aligned (TMA, 16-byte loads). `u`
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
  if (lafs_ln_mlp_sm90::takes(D, H))
    return hop::run(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, dr, s);
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

// How many clusters of `cluster` CTAs, each of `threads` threads and
// `smem` bytes of dynamic shared memory, the card runs at once
// (cudaOccupancyMaxActiveClusters); minus the cudaError_t on a failure.
extern "C" int lafs_max_active_clusters(int cluster, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      hop::cluster_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, hop::cluster_probe, &cfg);
  return err == cudaSuccess ? n : -(int)err;
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
