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
// What bounds it on the card. At the served shape (T = 100,864 tokens: a
// request of 256 faces with the flip, 197 tokens each; D = 768, H = 2048)
// the two products are 634.6 GFLOP: 0.642 ms at the bf16 tensor-core
// peak, bound by operations (T = 12,608 at the SSL global crops, where
// saving u adds 52 MB of stores).
//
// The design in bf16 at D = 768 with H a multiple of 256 (every full-width
// path) is the persistent staged form of fused_ln_mlp_sm90.cuh (namespace
// lafs_mlp_fwd): one launch a call, one CTA an SM, drawing LN tiles (xn =
// bf16(LN(x)) into an xn scratch), hidden tiles (128 rows x 256 hidden
// columns: u = xn W1ᵀ + b1, u stored where saved, h = drop_0(gelu(u)) in
// bf16 into an h scratch) and output tiles (128 rows x 256 columns over
// K = H: y = drop_1(h W2ᵀ + b2)) from one static order, each waiting on
// flags of the tiles it reads. Both products are m64n256k16 wgmmas of two
// consumer warpgroups from a 4-stage TMA ring of 48 KB stages. h (413 MB
// at the served T) goes through device memory and is read back from L2
// within about two grids' worth of tiles. The scratch is the wrapper's
// (torch.empty), with a schedule buffer of flags and counters that it
// zeroes once a stream; an epoch the kernel keeps there tells the
// launches apart. The memory floor (x, xn, h and y moved once each) is
// ~0.43 ms at 3.35 TB/s, under the tensor work. It runs near 51% of the
// tensor peak at the served T (1.24-1.26 ms a launch on an H100); the
// likeliest limit is the stream of slabs from L2, 48 KB a 4.2 MFLOP slab
// (85 FLOP a byte), ~6.5 TB/s for the whole card at that pace. Without
// GELU it ran 2% faster, without the h and y stores 7%; a 2-CTA cluster
// that multicast
// half of each weight slab into both CTAs cut the L2 reads by a third and
// ran 1.8x slower (the pair waits on each other's stages).
//
// It replaced row 10's 64-row cluster form, which kept h on chip: the (64,
// 768) fp32 output rows in registers and the xn tile in shared memory
// left two 48 KB ring stages, 64 FLOP a byte of weight slabs, and GELU and
// two cluster barriers between the products; it took 0.5277 ms at T =
// 25,216 against the dense library form's 0.3639 and its 0.1604 ms bound.
// Kernel 3 (the backward) keeps that form and shares the header's
// LayerNorm, GELU (phi_as) and dropout helpers with this one. Each
// (dropout, u saved) pair is its own template instance, so the served
// rate-0 path carries neither branch, and no product sits in a runtime
// branch (ptxas serialises every wgmma of such a kernel: warning C7520).
//
// Other widths (D a multiple of 128 up to 640, or H % 256 = 128) keep the
// first design: nvcuda::wmma 16x16x16 over 32-row blocks through shared
// memory (fused_mlp_fwd.cuh); fp32 (the --eval-dtype float32 path and the
// precision check) runs its scalar FMA loop. The C entry points choose by
// (dtype, D, H); the wrapper counts a call off the Hopper design as
// mlp.first_design.

#include "fused_ln_mlp_sm90.cuh"
#include "fused_mlp_fwd.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

// The body is fused_ln_mlp_sm90.cuh's lafs_mlp_fwd::run with the LayerNorm.
template <bool DROP, bool SAVE_U>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_fwd_sm90(const __grid_constant__ CUtensorMap mx,
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
  lafs_mlp_fwd::run<true, DROP, SAVE_U>(smem_raw, &mx, &mxn, &mw1, &mh, &mw2,
                                        g, bt, b1, b2, y, u_out, xn, hs, eps,
                                        drop, plan);
}

cudaError_t run(const void* x, const void* g, const void* bt, const void* w1t,
                const void* b1, const void* w2t, const void* b2, void* y,
                void* u, void* xn, void* hs, void* sched, int T_rows, int H,
                float eps, Dropout drop, cudaStream_t s) {
  auto kernel = drop.on ? (u ? ln_mlp_fwd_sm90<true, true>
                             : ln_mlp_fwd_sm90<true, false>)
                        : (u ? ln_mlp_fwd_sm90<false, true>
                             : ln_mlp_fwd_sm90<false, false>);
  return lafs_ln_mlp_sm90_host::launch_fwd<true>(kernel, x, g, bt, w1t, b1,
                                                 w2t, b2, y, u, xn, hs, sched,
                                                 T_rows, H, eps, drop, s);
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
// g, bt, b1, b2 and the weights 16-byte aligned (TMA, 16-byte loads) and
// the scratch of fused_ln_mlp_sm90.cuh::launch_fwd: xn (ceil(T / 128) · 128,
// 768), h (that many rows, H) and `sched`, SCHED_WORDS + ceil(T / 128) ·
// (1 + H / 256) 32-bit words zeroed before the stream's first launch (the
// first design and fp32 read none of the three). `u` may be null (no saved
// pre-activation); `drop` = 0 turns dropout off, and then seed, thresh and
// inv_keep are not read.
extern "C" int lafs_fused_ln_mlp_bf16(const void* x, const void* g, const void* bt,
                                      const void* w1t, const void* b1,
                                      const void* w2t, const void* b2, void* y,
                                      void* u, void* xn, void* h, void* sched,
                                      int T_rows, int D, int H, float eps,
                                      unsigned seed, unsigned thresh,
                                      float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
  if (lafs_ln_mlp_sm90::takes(D, H))
    return hop::run(x, g, bt, w1t, b1, w2t, b2, y, u, xn, h, sched, T_rows, H,
                    eps, dr, s);
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

// The bf16 entry's arguments (xn, h and sched unread).
extern "C" int lafs_fused_ln_mlp_f32(const void* x, const void* g, const void* bt,
                                     const void* w1t, const void* b1,
                                     const void* w2t, const void* b2, void* y,
                                     void* u, void* xn, void* h, void* sched,
                                     int T_rows, int D, int H, float eps,
                                     unsigned seed, unsigned thresh,
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
