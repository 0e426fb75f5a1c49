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
// global row and the JAX kernel's row tile (128 rows in bf16, 64 in fp32),
// so the backward regenerates them and the plain PyTorch version and the
// JAX CPU reference draw the same bits. The TPU kernel's A&S erf
// approximation (|err| <= 1.5e-7) is replaced by the exact erff.
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

// Registers: 384 threads a launch get at most 168 each; the producer
// warpgroup drops to 40 (setmaxnreg) so that the consumers rise to 232 for
// their 96 + 32 accumulator registers.
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
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const Bars bars(base + BAR_OFF);
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int row0 = (blockIdx.x / 2) * ROWS;
  const int chunks = H / HC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == CONSUMERS) bars.init();
  cluster_sync();  // the peer's barriers exist before any remote arrival

  // one if-else for the kernel's rest: setmaxnreg needs the two paths apart
  if (warp >= 8) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bars.x_full(), (D / 64) * BOX);
      for (int kb = 0; kb < D / 64; ++kb)
        tma_load_2d(base + X_OFF + kb * BOX, &mx, bars.x_full(), 64 * kb,
                    row0);
      int it = 0;
      for (int c = 0; c < chunks; ++c) {
        const int h0 = c * HC;
        for (int sl = 0; sl < 8; ++sl, ++it) {
          const int s = it % 2, use = it / 2;
          if (use > 0) mbar_wait(bars.empty(s), (use - 1) & 1);
          const uint32_t st = base + R_OFF + s * STAGE;
          mbar_expect_tx(bars.full(s), STAGE);
          if (sl < 4) {  // w1t[h0 + 128 rank + 64 g : +64, 192 sl : +192]
            for (int wg = 0; wg < 2; ++wg)
              for (int bx = 0; bx < 3; ++bx)
                tma_load_2d(st + wg * (STAGE / 2) + bx * BOX, &mw1,
                            bars.full(s), SLAB * sl + 64 * bx,
                            h0 + 128 * rank + 64 * wg);
          } else {  // w2t[384 rank + 192 g : +192, h0 + 64 (sl - 4) : +64]
            for (int wg = 0; wg < 2; ++wg)
              tma_load_2d(st + wg * (STAGE / 2), &mw2, bars.full(s),
                          h0 + 64 * (sl - 4), COLS * rank + 192 * wg);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while its peer may still arrive on it
  } else {  // consumer warpgroup wg: rows rw and rw + 8 of the cluster's 64
    setmaxnreg_inc<232>();
    const int wg = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    const uint32_t h_peer = mapa(base + H_OFF, peer);
    mbar_wait(bars.x_full(), 0);
    ln_tile_in_place(sbase + X_OFF, g, bt, eps, warp, lane);
    fence_proxy_async();  // xn, written here, is read by the wgmmas
    bar_sync(1, CONSUMERS);
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    int it = 0;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = c * HC;
      const int hbox = 2 * rank + wg;  // this warpgroup's 64 chunk columns
      // u = xn @ W1ᵀ[:, h0 + 64 hbox : +64], K = 768 in 4 slabs
      float u[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) u[i] = 0.0f;
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(bars.full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + wg * (STAGE / 2);
        reg_fence<32>(u);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLAB / 16; ++kk)
          wgmma_ss<64, 0>(
              u,
              desc_sw128(base + X_OFF + (3 * sl + kk / 4) * BOX + 32 * (kk % 4),
                         16, 1024),
              desc_sw128(wb + (kk / 4) * BOX + 32 * (kk % 4), 16, 1024),
              sl > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<32>(u);
        mbar_arrive(bars.empty(s));
      }
      // + b1, u saved, h = drop_0(gelu(u)) in bf16 into both CTAs' h
      // buffers once the previous chunk's h has been read by both
      if (c > 0) mbar_wait_cluster(bars.h_free(), (c - 1) & 1);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = rw + 8 * ((i >> 1) & 1), j8 = i / 4;
        const int col = h0 + 64 * hbox + 8 * j8 + 2 * quad;
        const long long grow = (long long)row0 + row;
        const float2 bias = load_pair(b1, col);
        const float u0 = u[i] + bias.x, u1 = u[i + 1] + bias.y;
        if (SAVE_U && grow < T_rows) store_pair(u_out, grow * H + col, u0, u1);
        float v0 = lafs_mlp::gelu(u0), v1 = lafs_mlp::gelu(u1);
        if (DROP) {
          v0 = drop.apply(v0, grow, col, 0);
          v1 = drop.apply(v1, grow, col + 1, 0);
        }
        const uint32_t off = h_offset(hbox, row, j8, quad);
        const uint32_t p = pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(sbase + H_OFF + off) = p;
        st_cluster_u32(h_peer + off, p);
      }
      fence_proxy_async_all();
      arrive_both(bars.h_full(), peer);
      mbar_wait_cluster(bars.h_full(), c & 1);
      // acc += h @ W2ᵀ[h0 : h0 + 256, 384 rank + 192 wg : +192]
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(bars.full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + wg * (STAGE / 2);
        reg_fence<96>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<192, 0>(acc,
                           desc_sw128(base + H_OFF + sl * BOX + 32 * kk, 16,
                                      1024),
                           desc_sw128(wb + 32 * kk, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<96>(acc);
        mbar_arrive(bars.empty(s));
      }
      arrive_both(bars.h_free(), peer);
    }
    // y = drop_1(acc + b2) in bf16, rows below T
#pragma unroll
    for (int i = 0; i < 96; i += 2) {
      const long long row = (long long)row0 + rw + 8 * ((i >> 1) & 1);
      const int col = COLS * rank + 192 * wg + 8 * (i / 4) + 2 * quad;
      if (row < T_rows) {
        const float2 bias = load_pair(b2, col);
        float v0 = acc[i] + bias.x, v1 = acc[i + 1] + bias.y;
        if (DROP) {
          v0 = drop.apply(v0, row, col, 1);
          v1 = drop.apply(v1, row, col + 1, 1);
        }
        store_pair(y, row * D + col, v0, v1);
      }
    }
    __syncwarp();
    cluster_sync();
  }
}

template <bool DROP, bool SAVE_U>
cudaError_t launch(const void* x, const void* g, const void* bt,
                   const void* w1t, const void* b1, const void* w2t,
                   const void* b2, void* y, void* u, int T_rows, int H,
                   float eps, Dropout drop, cudaStream_t s) {
  CUtensorMap mx, mw1, mw2;
  cudaError_t err;
  if ((err = lafs_ln_mlp_sm90_host::map2d(&mx, x, D, T_rows, 64)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw1, w1t, D, H, 64)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw2, w2t, H, D, SLAB)) != cudaSuccess)
    return err;
  return lafs_ln_mlp_sm90_host::launch(
      ln_mlp_fwd_sm90<DROP, SAVE_U>, SMEM, T_rows, s, mx, mw1, mw2,
      static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(y), static_cast<bf16*>(u), T_rows, H, eps, drop);
}

cudaError_t run(const void* x, const void* g, const void* bt, const void* w1t,
                const void* b1, const void* w2t, const void* b2, void* y,
                void* u, int T_rows, int H, float eps, Dropout drop,
                cudaStream_t s) {
  if (drop.on)
    return u ? launch<true, true>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, drop, s)
             : launch<true, false>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, drop, s);
  return u ? launch<false, true>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, drop, s)
           : launch<false, false>(x, g, bt, w1t, b1, w2t, b2, y, u, T_rows, H, eps, drop, s);
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
