// Transformer MLP backward, no LayerNorm (kernel 5 of the PyTorch/CUDA
// port; the backward of kernel 4, mlp_impl='fused').
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_bwd_kernel, called from _bwd_call). Per row, from the saved
// pre-activation u and the output gradient dy:
//     do  = drop_1(dy)                                  -> input dtype
//     hd  = drop_0(gelu(u))                             -> input dtype
//     dhd = do @ W2ᵀ                  (fp32 accumulate; w2t is (D, H))
//     du  = drop_0(dhd) * gelu'(u)                      -> input dtype
// and nothing more: dx = du·W1, dW1, dW2 and the bias sums are plain
// products outside the kernel, as the JAX package leaves them to XLA. Unlike
// kernel 3 it stops at du: no du·W1, no LayerNorm backward. drop_0/drop_1
// regenerate kernel 4's masks from the counter hash of
// fused_ln_mlp_common.cuh (same seed, same global rows).
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, H = 2048, bf16) the one product is 79 GFLOP and the compulsory
// traffic ~390 MB (u and dy in; do, hd and du out, three of them T x H):
// 0.12 ms at the card's memory rate, above the 0.08 ms of the tensor-core
// peak, so it is bound by bytes, and the stores of hd and du decide its
// speed once W2 is fed fast enough. The TPU kernel's (T, H) dhd never
// reaches device memory in either design.
//
// The design in bf16 at D = 768 with H a multiple of 256 (every full-width
// path; on sm90.cuh and fused_ln_mlp_sm90.cuh): kernel 3's prologue and
// first half, without its second product and so without the cluster. A
// CTA owns a 64-row tile:
// - the producer warpgroup TMA-loads dy into the (64, 768) row tile (rows
//   at or past T zero-filled), which the consumers turn into do =
//   drop_1(dy) in place and store (kernel 3's prologue,
//   do_tile_in_place), then fence for the wgmmas and meet at a barrier;
// - the CTA walks H in column tiles of NC = 128: the producer streams w2t
//   (D, H) as (64 K rows x 64 columns) boxes, two a 16 KB stage, through
//   a 6-stage ring (up to five loads in flight while one stage is read),
//   and warpgroup g accumulates dhd for the tile's columns [64g, 64g + 64)
//   in an m64n64 fp32 register accumulator, w2t the MN-major B operand
//   (the transpose bit), one wgmma group in flight while the next stage
//   lands;
// - the thread's u pairs of the tile are loaded ahead of the product, and
//   kernel 3's element-wise pass (hidden_pair) writes hd and du as bf16
//   pairs into the warpgroup's two (64 x 64) staging boxes in the TMA
//   layout, each written to device memory by one TMA store (rows at or
//   past T dropped) while the next tile's product runs. Kernel 3 stores
//   them as 4-byte pairs from the fragments, having no room to stage; here
//   staging (and two ring stages fewer) ran kernel 5 1.1x faster than those
//   stores with eight stages (PERF.md §6).
// Shared memory: the row tile 96 KB + the ring 96 KB + the staging 32 KB
// = 224 KB, one CTA an SM; T = 25,216 gives 394 CTAs (2.98 waves of 132
// SMs). A 256-column tile (an m64n128 accumulator a warpgroup) spilled
// registers. Rate 0 and dropout are two template instances
// (mlp_bwd_sm90<DROP>); the name holds no "ln_mlp_", so that profiles tell
// it from kernel 3.
//
// Other widths and fp32 keep the first design: a block owns ROWS = 32 rows,
// stages do once in shared memory, then walks the hidden layer in HC-wide
// chunks, each chunk's dhd computed on the tensor cores (nvcuda::wmma, fp32
// accumulate, W2 re-read from L2 per block) and passed through shared
// memory to the element-wise GELU′/mask pass that writes hd and du. fp32
// runs a scalar FMA loop over W2 chunks staged in shared memory. Rows past
// T read as dy = 0 and are never stored. The C entry points choose by
// (dtype, D, H).

#include <mma.h>

#include "fused_ln_mlp_common.cuh"
#include "fused_ln_mlp_sm90.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

constexpr int NC = 128;                 // hidden columns of a tile
constexpr int NW = NC / 2;              // of a warpgroup
constexpr int WSTAGE = (NC / 64) * BOX; // a stage: two (64 x 64) w2t boxes
constexpr int STAGES = 6;               // the ring
constexpr int KB = D / 64;              // K boxes: 12
constexpr int BX_OFF = 0;               // the row tile: KB boxes
constexpr int BR_OFF = BX_OFF + KB * BOX;
constexpr int S_OFF = BR_OFF + STAGES * WSTAGE;  // hd, du of each warpgroup
constexpr int BBAR_OFF = S_OFF + 4 * BOX;
constexpr int BSMEM = BBAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
static_assert(BSMEM <= 232448, "one CTA's shared memory");

// A CTA: row tile blockIdx.x, every column tile. Registers: as kernel 3,
// the producer warpgroup drops to 40 so that the consumers rise to 232 (the
// compiler allocates within 168: 32 accumulator registers, 16 u pairs and
// the element-wise pass).
template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_sm90(const __grid_constant__ CUtensorMap mdy,
             const __grid_constant__ CUtensorMap mw2,
             const __grid_constant__ CUtensorMap mhd,
             const __grid_constant__ CUtensorMap mdu,
             const bf16* __restrict__ u, bf16* __restrict__ do_, int T_rows,
             int H, Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t x_full = base + BBAR_OFF;
  const auto full = [&](int s) { return base + BBAR_OFF + 8 + 8 * s; };
  const auto empty = [&](int s) {
    return base + BBAR_OFF + 8 + 8 * STAGES + 8 * s;
  };
  const int row0 = blockIdx.x * ROWS;
  const int tiles = H / NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == CONSUMERS) {
    mbar_init(x_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(x_full, KB * BOX);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(base + BX_OFF + kb * BOX, &mdy, x_full, 64 * kb, row0);
      int it = 0;
      for (int j = 0; j < tiles; ++j)
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
          // w2t[64 kb : +64, NC j + 64 b : +64], b = 0, 1
          const uint32_t st = base + BR_OFF + s * WSTAGE;
          mbar_expect_tx(full(s), WSTAGE);
          for (int b = 0; b < NC / 64; ++b)
            tma_load_2d(st + b * BOX, &mw2, full(s), NC * j + 64 * b, 64 * kb);
        }
    }
  } else {  // consumer warpgroup wg: columns NW wg of each tile
    setmaxnreg_inc<232>();
    const int wg = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    const long long ra = (long long)row0 + rw, rb = ra + 8;
    const uint32_t key_a = drop.row_key(ra, 0), key_b = drop.row_key(rb, 0);
    mbar_wait(x_full, 0);
    do_tile_in_place<DROP>(sbase + BX_OFF, do_, row0, T_rows, drop, 0, D / 8);
    int it = 0;
    for (int j = 0; j < tiles; ++j) {
      const int col0 = NC * j + NW * wg;  // this warpgroup's first column
      uint32_t uw[NW / 4];
      load_u_pairs(u, ra, rb, T_rows, H, col0 + 2 * quad, uw);
      // dhd = do @ W2ᵀ[:, col0 : col0 + 64], K = 768 in 12 stages; one
      // stage's group stays in flight while the next is issued
      float dh[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) dh[i] = 0.0f;
      int prev = 0;
      for (int kb = 0; kb < KB; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        const uint32_t wb = base + BR_OFF + s * WSTAGE + wg * BOX;
        reg_fence<NW / 2>(dh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<NW, 1>(
              dh, desc_sw128(base + BX_OFF + kb * BOX + 32 * kk, 16, 1024),
              desc_sw128(wb + 2048 * kk, BOX, 1024), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence<NW / 2>(dh);
        if (kb > 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      reg_fence<NW / 2>(dh);
      mbar_arrive(empty(prev));
      // hd = drop_0(gelu(u)), du = drop_0(dhd) gelu'(u) into the
      // warpgroup's staging boxes (pair q at row rw + 8 (q & 1), columns 8
      // (q >> 1) + 2 quad + [0, 2) of the 64, the TMA layout), once the
      // previous tile's stores have read them; then one TMA store each,
      // which drops rows at or past T
      const bool issuer = threadIdx.x % 128 == 0;
      const uint32_t st_hd = base + S_OFF + 2 * wg * BOX, st_du = st_hd + BOX;
      if (issuer) tma_store_wait_read();
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const int col = col0 + 8 * (q >> 1) + 2 * quad;
        const uint2 p = hidden_pair<DROP>(uw[q], dh[2 * q], dh[2 * q + 1],
                                          (q & 1) ? key_b : key_a, col, drop);
        const uint32_t off = h_offset(0, rw + 8 * (q & 1), q >> 1, quad);
        *reinterpret_cast<uint32_t*>(sbase + (st_hd - base) + off) = p.x;
        *reinterpret_cast<uint32_t*>(sbase + (st_du - base) + off) = p.y;
      }
      fence_proxy_async();  // the staging, written here, is read by TMA
      bar_sync(2 + wg, 128);
      if (issuer) {
        tma_store_2d(&mhd, st_hd, col0, row0);
        tma_store_2d(&mdu, st_du, col0, row0);
        tma_store_commit();
      }
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_read();
  }
}

cudaError_t run(const void* u, const void* dy, const void* w2t, void* do_,
                void* hd, void* du, int T_rows, int H, Dropout drop,
                cudaStream_t s) {
  CUtensorMap mdy, mw2, mhd, mdu;
  cudaError_t err;
  if ((err = lafs_ln_mlp_sm90_host::map2d(&mdy, dy, D, T_rows, ROWS)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw2, w2t, H, D, 64)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mhd, hd, H, T_rows, ROWS)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mdu, du, H, T_rows, ROWS)) != cudaSuccess)
    return err;
  auto kernel = drop.on ? mlp_bwd_sm90<true> : mlp_bwd_sm90<false>;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  BSMEM)) != cudaSuccess)
    return err;
  kernel<<<clusters(T_rows), THREADS, BSMEM, s>>>(
      mdy, mw2, mhd, mdu, static_cast<const bf16*>(u),
      static_cast<bf16*>(do_), T_rows, H, drop);
  return cudaGetLastError();
}

}  // namespace hop

using namespace lafs_mlp;
using namespace nvcuda;

// NT = 16-column tiles of D per warp; D = NT * 16 * WARPS.
template <int NT>
struct MlpBwdLayout {
  static constexpr int D = NT * 16 * WARPS;
  static constexpr int LDX = D + 8;   // bf16 do rows (pad: bank spread)
  static constexpr int LDU = HC + 4;  // fp32 dhd chunk rows
  static constexpr int XS = ROWS * LDX * 2;
  static constexpr int SMEM = XS + ROWS * LDU * 4;
};

template <int NT>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ dy,
                    const bf16* __restrict__ w2t, bf16* __restrict__ do_,
                    bf16* __restrict__ hd, bf16* __restrict__ du, int T_rows,
                    int H, Dropout drop) {
  using L = MlpBwdLayout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dos = reinterpret_cast<bf16*>(smem);
  float* dhs = reinterpret_cast<float*>(smem + L::XS);

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_do(dy, do_, dos, L::LDX, row0, T_rows, D, drop);
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += HC) {
    // dhd[:, h0 + 16*warp : +16] = do @ W2ᵀ for both 16-row halves; the
    // (K = D, N = H) operand is w2t itself, row-major
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> d0, d1;
    wmma::fill_fragment(d0, 0.0f);
    wmma::fill_fragment(d1, 0.0f);
    const bf16* wcol = w2t + h0 + warp * 16;
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a0, dos + k, L::LDX);
      wmma::load_matrix_sync(a1, dos + 16 * L::LDX + k, L::LDX);
      wmma::load_matrix_sync(bw, wcol + (long long)k * H, H);
      wmma::mma_sync(d0, a0, bw, d0);
      wmma::mma_sync(d1, a1, bw, d1);
    }
    wmma::store_matrix_sync(dhs + warp * 16, d0, L::LDU, wmma::mem_row_major);
    wmma::store_matrix_sync(dhs + 16 * L::LDU + warp * 16, d1, L::LDU,
                            wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const long long row = row0 + r;
      if (row < T_rows)
        bwd_hidden(u, hd, du, dhs[r * L::LDU + c], row, H, h0 + c, drop);
    }
    __syncthreads();  // the next chunk overwrites dhs
  }
}

__host__ __device__ constexpr int mlp_bwd_f32_smem_bytes(int D) {
  return (ROWS * D + F_HC * (D + 1)) * 4;
}

__global__ void __launch_bounds__(THREADS)
mlp_bwd_f32_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ w2t, float* __restrict__ do_,
                   float* __restrict__ hd, float* __restrict__ du, int T_rows,
                   int D, int H, Dropout drop) {
  extern __shared__ __align__(128) float fsm[];
  float* dos = fsm;                    // (ROWS, D)
  float* wb = dos + ROWS * D;          // W2 chunk (F_HC, D+1)
  const int tid = threadIdx.x;
  const int n = tid % 32;              // hidden unit of the chunk
  const int rg = tid / 32;             // row group of 4 rows
  const long long row0 = (long long)blockIdx.x * ROWS;

  stage_do(dy, do_, dos, D, row0, T_rows, D, drop);

  for (int h0 = 0; h0 < H; h0 += F_HC) {
    __syncthreads();  // dos written / previous chunk's wb reads done
    for (int e = tid; e < F_HC * D; e += THREADS) {
      const int k = e / F_HC, nn = e % F_HC;
      wb[nn * (D + 1) + k] = w2t[(long long)k * H + h0 + nn];
    }
    __syncthreads();
    float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < D; ++k) {
      const float w = wb[n * (D + 1) + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) dh[q] += dos[(rg * 4 + q) * D + k] * w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = row0 + rg * 4 + q;
      if (row < T_rows) bwd_hidden(u, hd, du, dh[q], row, H, h0 + n, drop);
    }
  }
}

}  // namespace

// Widths as kernel 4: D a multiple of 128 up to 768, H a multiple of 128
// (checked by the Python wrapper); D = 768 with H a multiple of 256 runs
// the Hopper design, which also needs u, dy and w2t 16-byte aligned (TMA,
// 4-byte pair loads). `drop` = 0 turns dropout off.
extern "C" int lafs_fused_mlp_bwd_bf16(const void* u, const void* dy,
                                       const void* w2t, void* do_, void* hd,
                                       void* du, int T_rows, int D, int H,
                                       unsigned seed, unsigned thresh,
                                       float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
  if (lafs_ln_mlp_sm90::takes(D, H))
    return hop::run(u, dy, w2t, do_, hd, du, T_rows, H, dr, s);
#define LAFS_BWD_CASE(NT)                                                    \
  case NT * 128:                                                             \
    return launch_rows(mlp_bwd_bf16_kernel<NT>, MlpBwdLayout<NT>::SMEM,      \
                       T_rows, 1, s, static_cast<const bf16*>(u),            \
                       static_cast<const bf16*>(dy),                         \
                       static_cast<const bf16*>(w2t), static_cast<bf16*>(do_), \
                       static_cast<bf16*>(hd), static_cast<bf16*>(du), T_rows, \
                       H, dr);
  switch (D) {
    LAFS_BWD_CASE(1)
    LAFS_BWD_CASE(2)
    LAFS_BWD_CASE(3)
    LAFS_BWD_CASE(4)
    LAFS_BWD_CASE(5)
    LAFS_BWD_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef LAFS_BWD_CASE
}

extern "C" int lafs_fused_mlp_bwd_f32(const void* u, const void* dy,
                                      const void* w2t, void* do_, void* hd,
                                      void* du, int T_rows, int D, int H,
                                      unsigned seed, unsigned thresh,
                                      float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || H % F_HC) return cudaErrorInvalidValue;
  return launch_rows(
      mlp_bwd_f32_kernel, mlp_bwd_f32_smem_bytes(D), T_rows, 1, s,
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(w2t), static_cast<float*>(do_),
      static_cast<float*>(hd), static_cast<float*>(du), T_rows, D, H,
      make_dropout(seed, thresh, inv_keep, drop, 64));
}
