// LayerNorm fused into a bias-free linear projection, forward (kernel 8 of
// the PyTorch/CUDA port; attn_impl='lnqkv', the pre-attention LayerNorm and
// the to_qkv projection).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_ln_linear.py
// (_fwd_kernel, called from _fwd_call):
//     xn = LN(x; g, bt) in fp32 (eps), cast to the input dtype
//     y  = xn @ Wᵀ                    (fp32 accumulate), cast to the input dtype
// W comes in PyTorch's nn.Linear layout, (O, D) row-major; every tensor in
// the input dtype. The TPU kernel pads W to the next multiple of 128 (2,112
// -> 2,176 for Part-fViT-B's to_qkv); here no padded copy is made.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, O = 2,112, bf16) the product is 82 GFLOP against ~150 MB of
// compulsory traffic (x in, W, y out): 0.083 ms of the tensor-core peak
// against 0.044 ms at the memory rate, bound by operations. What the TPU
// kernel was for, and what both designs keep: the normalised activations
// never reach device memory. A fused form reads W once per row tile, so
// the W bytes each SM takes in per FLOP fall with the rows a tile holds.
//
// The design in bf16 at D = 768 with O a multiple of 8 (the Hopper design,
// on sm90.cuh and fused_ln_mlp_sm90.cuh): a CTA owns a row tile of 64
// rows, which its producer warpgroup TMA-loads once (rows at or past T
// zero-filled) and its two consumer warpgroups normalise in place (kernel
// 2's prologue: fp32 two-pass statistics, xn rounded to bf16 back into the
// 128-byte-swizzled layout, then a proxy fence and a consumers' barrier
// before the first wgmma reads it). The CTA then walks output column tiles
// of 192 (11 at O = 2,112): the producer streams W as (192 columns x 64 K)
// K-major boxes of the nn.Linear layout through a 5-stage ring (mbarrier
// full/empty phases, up to four loads in flight while one stage is read),
// and warpgroup g accumulates the tile's columns [96g, 96g + 96) in an
// m64n96 fp32 register accumulator, one wgmma group in flight while the
// next stage lands; y leaves as bf16 pairs from the fragments, rows below
// T and columns below O (the tensor map zero-fills W's rows past O).
// Shared memory: the row tile 96 KB + the ring 120 KB = 216 KB, one CTA an
// SM; T = 25,216 gives 394 CTAs (2.98 waves of 132 SMs). The W bytes in
// flight, not the tensor cores, bound it: a 128-row tile (128 FLOP per W
// byte, 64 here) leaves room for only 32 KB of ring and ran 1.2x slower,
// a 4-stage ring of 256-column boxes 1.1x slower, each W box multicast to
// a 2-CTA cluster 2.3x slower (PERF.md §6).
//
// Other widths (D a multiple of 128 up to 640, O not a multiple of 8) keep
// the first design: a block owns ROWS = 32 token rows and BN = 128 output
// columns; it normalises its rows into shared memory and walks D in
// KC-wide chunks of W staged through shared memory, the product on the
// tensor cores (nvcuda::wmma 16x16x16, fp32 accumulate; each warp owns 16
// columns of both 16-row halves). Each row's statistics are recomputed by
// the ceil(O / BN) column blocks of its rows, and each block re-reads its
// (BN, D) slice of W from L2. fp32 (the precision check) runs a scalar FMA
// loop over 64-column blocks. Rows past T are staged as zeros and never
// stored. The C entry points choose by (dtype, D, O).

#include <mma.h>

#include "fused_ln_mlp_common.cuh"
#include "fused_ln_mlp_sm90.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

constexpr int NC = 192;                      // output columns of a tile
constexpr int NW = NC / 2;                   // of a warpgroup
constexpr int WSTAGE = NC * 128;             // a (192 x 64 K) box of W
constexpr int STAGES = 5;                    // the ring
constexpr int KB = D / 64;                   // K boxes: 12
constexpr int LX_OFF = 0;                    // the row tile: KB boxes
constexpr int LR_OFF = LX_OFF + KB * BOX;
constexpr int LBAR_OFF = LR_OFF + STAGES * WSTAGE;
constexpr int LSMEM = LBAR_OFF + 128 + 1024;  // + alignment to 1024 bytes

// A CTA: row tile blockIdx.x, every column tile.
__global__ void __launch_bounds__(THREADS, 1)
ln_linear_fwd_sm90(const __grid_constant__ CUtensorMap mx,
                   const __grid_constant__ CUtensorMap mw,
                   const bf16* __restrict__ g, const bf16* __restrict__ bt,
                   bf16* __restrict__ y, int T_rows, int O, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t x_full = base + LBAR_OFF;
  const auto full = [&](int s) { return base + LBAR_OFF + 8 + 8 * s; };
  const auto empty = [&](int s) {
    return base + LBAR_OFF + 8 + 8 * STAGES + 8 * s;
  };
  const int row0 = blockIdx.x * ROWS;
  const int tiles = (O + NC - 1) / NC;
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
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(x_full, KB * BOX);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(base + LX_OFF + kb * BOX, &mx, x_full, 64 * kb, row0);
      int it = 0;
      for (int j = 0; j < tiles; ++j)
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
          mbar_expect_tx(full(s), WSTAGE);
          tma_load_2d(base + LR_OFF + s * WSTAGE, &mw, full(s), 64 * kb,
                      NC * j);
        }
    }
  } else {  // consumer warpgroup wg: columns NW wg of each tile
    const int wg = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    mbar_wait(x_full, 0);
    ln_tile_in_place(sbase + LX_OFF, g, bt, eps, warp, lane);
    fence_proxy_async();  // xn, written here, is read by the wgmmas
    bar_sync(1, CONSUMERS);
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    int it = 0;
    for (int j = 0; j < tiles; ++j) {
      // acc = xn @ W[NC j + NW wg : +NW]ᵀ, K = 768 in 12 stages; one
      // stage's group stays in flight while the next is issued
      int prev = 0;
      for (int kb = 0; kb < KB; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        reg_fence<NW / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<NW, 0>(
              acc, desc_sw128(base + LX_OFF + kb * BOX + 32 * kk, 16, 1024),
              desc_sw128(base + LR_OFF + s * WSTAGE + NW * 128 * wg + 32 * kk,
                         16, 1024),
              kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence<NW / 2>(acc);
        if (kb > 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      reg_fence<NW / 2>(acc);
      mbar_arrive(empty(prev));
      // y in bf16 pairs: acc[4 jj + e] at row rw + 8 (e >= 2), column
      // NC j + 8 jj + 2 quad + (e & 1)
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const long long row = (long long)row0 + rw + 8 * ((i >> 1) & 1);
        const int col = NC * j + NW * wg + 8 * (i / 4) + 2 * quad;
        if (row < T_rows && col < O)
          store_pair(y, row * O + col, acc[i], acc[i + 1]);
      }
    }
  }
}

cudaError_t run(const void* x, const void* g, const void* bt, const void* w,
                void* y, int T_rows, int O, float eps, cudaStream_t s) {
  CUtensorMap mx, mw;
  cudaError_t err;
  if ((err = lafs_ln_mlp_sm90_host::map2d(&mx, x, D, T_rows, ROWS)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw, w, D, O, NC)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(ln_linear_fwd_sm90,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  LSMEM)) != cudaSuccess)
    return err;
  ln_linear_fwd_sm90<<<lafs_ln_mlp_sm90::clusters(T_rows), THREADS, LSMEM, s>>>(
      mx, mw, static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
      static_cast<bf16*>(y), T_rows, O, eps);
  return cudaGetLastError();
}

}  // namespace hop

using namespace lafs_mlp;
using namespace nvcuda;

constexpr int BN = 128;       // output columns per block (bf16)
constexpr int KC = 64;        // D chunk of the staged W tile (bf16)
constexpr int LDW = KC + 8;   // bf16 W tile rows (pad: bank spread)
constexpr int LDO = BN + 4;   // fp32 output staging rows
constexpr int F_BN = 64;      // output columns per block (fp32)
constexpr int F_KC = 32;      // D chunk of the staged W tile (fp32)

__host__ __device__ constexpr int ln_linear_bf16_smem(int D) {
  return ROWS * (D + 8) * 2 + BN * LDW * 2;
}

__global__ void __launch_bounds__(THREADS)
ln_linear_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const bf16* __restrict__ bt, const bf16* __restrict__ w,
                          bf16* __restrict__ y, int T_rows, int D, int O,
                          float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + ROWS * ldx * 2);
  float* os = reinterpret_cast<float*>(ws);  // after the D loop: aliases ws
  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int n0 = blockIdx.y * BN;

  stage_rows<true>(x, g, bt, xs, ldx, row0, T_rows, D, eps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y0, y1;
  wmma::fill_fragment(y0, 0.0f);
  wmma::fill_fragment(y1, 0.0f);
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // xs staged / the previous chunk's ws reads done
    // W[n0 + n, k0 : k0 + KC] -> ws[n], 8 values a 16-byte load; rows past
    // O are zeros
    for (int e = threadIdx.x; e < BN * KC / 8; e += THREADS) {
      const int n = e / (KC / 8), c = (e % (KC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < O)
        v = *reinterpret_cast<const uint4*>(w + (long long)(n0 + n) * D + k0 + c);
      *reinterpret_cast<uint4*>(ws + n * LDW + c) = v;
    }
    __syncthreads();
    // y[:, n0 + 16*warp : +16] += xn[:, k0 : k0 + KC] @ W[.., k0 : k0 + KC]ᵀ;
    // ws read as the column-major (K, N) operand
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a0, xs + k0 + kk, ldx);
      wmma::load_matrix_sync(a1, xs + 16 * ldx + k0 + kk, ldx);
      wmma::load_matrix_sync(bw, ws + warp * 16 * LDW + kk, LDW);
      wmma::mma_sync(y0, a0, bw, y0);
      wmma::mma_sync(y1, a1, bw, y1);
    }
  }
  __syncthreads();  // ws is dead: it stages the output tile
  wmma::store_matrix_sync(os + warp * 16, y0, LDO, wmma::mem_row_major);
  wmma::store_matrix_sync(os + 16 * LDO + warp * 16, y1, LDO,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const long long row = row0 + r;
    if (row < T_rows && n0 + c < O) store(y + row * O + n0 + c, os[r * LDO + c]);
  }
}

__host__ __device__ constexpr int ln_linear_f32_smem(int D) {
  return (ROWS * D + F_BN * (F_KC + 1)) * 4;
}

// Thread (rg, n): output column n0 + n of the block's rows rg*8 .. rg*8+7.
__global__ void __launch_bounds__(THREADS)
ln_linear_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ bt, const float* __restrict__ w,
                         float* __restrict__ y, int T_rows, int D, int O,
                         float eps) {
  extern __shared__ __align__(128) float fsm[];
  float* xs = fsm;                // (ROWS, D)
  float* ws = xs + ROWS * D;      // W tile (F_BN, F_KC + 1)
  const int tid = threadIdx.x;
  const int n = tid % F_BN, rg = tid / F_BN;
  constexpr int RPT = ROWS * F_BN / THREADS;  // rows per thread: 8
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int n0 = blockIdx.y * F_BN;

  stage_rows<true>(x, g, bt, xs, D, row0, T_rows, D, eps);

  float acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += F_KC) {
    __syncthreads();  // xs staged / the previous chunk's ws reads done
    for (int e = tid; e < F_BN * F_KC; e += THREADS) {
      const int nn = e / F_KC, c = e % F_KC;
      ws[nn * (F_KC + 1) + c] =
          n0 + nn < O ? w[(long long)(n0 + nn) * D + k0 + c] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < F_KC; ++k) {
      const float wv = ws[n * (F_KC + 1) + k];
#pragma unroll
      for (int q = 0; q < RPT; ++q) acc[q] += xs[(rg * RPT + q) * D + k0 + k] * wv;
    }
  }
  if (n0 + n >= O) return;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const long long row = row0 + rg * RPT + q;
    if (row < T_rows) y[row * O + n0 + n] = acc[q];
  }
}

}  // namespace

// Widths the kernels take: D a multiple of 128 up to 768 (the staged rows),
// any O >= 1 (checked by the Python wrapper, which also hands every operand
// 16-byte aligned: TMA tiles and 16-byte loads). bf16 at D = 768 with O a
// multiple of 8 runs the Hopper design.
extern "C" int lafs_fused_ln_linear_bf16(const void* x, const void* g,
                                         const void* bt, const void* w, void* y,
                                         int T_rows, int D, int O, float eps,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || O <= 0) return cudaErrorInvalidValue;
  if (lafs_ln_mlp_sm90::takes_linear(D, O))
    return hop::run(x, g, bt, w, y, T_rows, O, eps, s);
  return launch_rows(ln_linear_fwd_bf16_kernel, ln_linear_bf16_smem(D), T_rows,
                     (O + BN - 1) / BN, s, static_cast<const bf16*>(x),
                     static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
                     static_cast<const bf16*>(w), static_cast<bf16*>(y), T_rows,
                     D, O, eps);
}

extern "C" int lafs_fused_ln_linear_f32(const void* x, const void* g,
                                        const void* bt, const void* w, void* y,
                                        int T_rows, int D, int O, float eps,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || O <= 0) return cudaErrorInvalidValue;
  return launch_rows(ln_linear_fwd_f32_kernel, ln_linear_f32_smem(D), T_rows,
                     (O + F_BN - 1) / F_BN, s, static_cast<const float*>(x),
                     static_cast<const float*>(g), static_cast<const float*>(bt),
                     static_cast<const float*>(w), static_cast<float*>(y),
                     T_rows, D, O, eps);
}
