// LayerNorm-fused transformer MLP backward (kernel 3 of the PyTorch/CUDA
// port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_mlp.py
// (_ln_bwd_kernel, called from _ln_bwd_call). Per row, from x, the saved
// pre-activation u and the output gradient dy:
//     xhat = (x - mean) * rstd, xn = xhat * g + bt       (fp32 statistics)
//     do   = drop_1(dy)                                  -> input dtype
//     hd   = drop_0(gelu(u))                             -> input dtype
//     dhd  = do @ W2ᵀ                  (fp32 accumulate; w2t is (D, H))
//     du   = drop_0(dhd) * gelu'(u)                      -> input dtype
//     dxn  = du @ W1ᵀ                  (fp32 accumulate; w1t is (H, D))
//     dx   = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//            dxhat = dxn * g
// and per block the fp32 partial sums over its rows of dxn * xhat (dγ) and
// dxn (dβ). The outputs do, hd, du and xn feed the weight gradients that
// the JAX package leaves to XLA (the Python wrapper's torch.matmul); dx is
// the input gradient. drop_0/drop_1 regenerate kernel 2's masks from the
// counter hash of fused_ln_mlp_common.cuh (same seed, same global rows).
//
// What bounds it on the card. At the global crops' shape (T = 12,608,
// D = 768, H = 2048) the two products are 79 GFLOP and the compulsory
// device-memory traffic ~180 MB (x, dy and u in; do, hd, du, xn and dx
// out, u/hd/du being T x H each): a tiled pair of GEMMs would be bound by
// operations. This form, like kernel 2, is bound by L2 traffic of the
// weights instead: the TPU kernel's sequential grid carried dγ/dβ in VMEM
// and held 128-row tiles; here blocks run in no order on 132 SMs, so a
// block owns ROWS = 32 rows (the register-resident (32, 768) fp32 dxn
// accumulator caps it, as in kernel 2), re-reads both weight matrices from
// L2 (~2.5 GB per call at T = 12,608) and writes its dγ/dβ partial row to
// a (blocks, D) buffer that the wrapper sums: deterministic, no atomics.
// What the design keeps from the TPU kernel: dhd and dxn never reach
// device memory, and the LayerNorm backward runs on the block's rows while
// dxn is still on chip. The hidden layer is walked in chunks; each chunk's
// dhd goes through shared memory for the element-wise GELU′/mask pass, and
// the chunk's du (rounded to the input dtype, as the JAX kernel rounds it)
// is the A operand of the dxn product.
//
// bf16 runs on the tensor cores through nvcuda::wmma (16x16x16, fp32
// accumulate); fp32 runs a scalar FMA loop over tiles staged in shared
// memory, as kernel 2 does. The ragged last block is masked: rows past T
// read as dy = 0 (so do = du = dxn = 0) and are never stored.

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace {

using namespace lafs_mlp;
using namespace nvcuda;

// ---------------------------------------------------------------- bf16 --
// NT = dxn column tiles (16 wide) per warp; D = NT * 16 * WARPS.
template <int NT>
struct Bf16BwdLayout {
  static constexpr int D = NT * 16 * WARPS;
  static constexpr int LDX = D + 8;   // bf16 do rows (pad: bank spread)
  static constexpr int LDU = HC + 4;  // fp32 dhd chunk rows
  static constexpr int LDH = HC + 8;  // bf16 du chunk rows
  static constexpr int LDO = D + 4;   // fp32 dxn staging rows
  static constexpr int XS = ROWS * LDX * 2;
  static constexpr int US = ROWS * LDU * 4;
  static constexpr int HS = ROWS * LDH * 2;
  static constexpr int OS = ROWS * LDO * 4;
  static constexpr int MAIN = XS + US + HS;
  static constexpr int BODY = MAIN > OS ? MAIN : OS;
  static constexpr int SMEM = BODY + 2 * ROWS * 4;  // + row mean, rstd
};

template <int NT>
__global__ void __launch_bounds__(THREADS)
ln_mlp_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                       const bf16* __restrict__ dy, const bf16* __restrict__ g,
                       const bf16* __restrict__ bt, const bf16* __restrict__ w1t,
                       const bf16* __restrict__ w2t, bf16* __restrict__ do_,
                       bf16* __restrict__ hd, bf16* __restrict__ du,
                       bf16* __restrict__ xn, bf16* __restrict__ dx,
                       float* __restrict__ dgp, float* __restrict__ dbp,
                       int T_rows, int H, float eps, Dropout drop) {
  using L = Bf16BwdLayout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dos = reinterpret_cast<bf16*>(smem);
  float* dhs = reinterpret_cast<float*>(smem + L::XS);
  bf16* dus = reinterpret_cast<bf16*>(smem + L::XS + L::US);
  float* os = reinterpret_cast<float*>(smem);  // epilogue: aliases the rest
  float* mean_s = reinterpret_cast<float*>(smem + L::BODY);
  float* rstd_s = mean_s + ROWS;

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  bwd_prologue<true>(x, g, bt, xn, mean_s, rstd_s, row0, T_rows, D, eps, dy,
                     do_, dos, L::LDX, drop);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::fill_fragment(acc[0][t], 0.0f);
    wmma::fill_fragment(acc[1][t], 0.0f);
  }

  for (int h0 = 0; h0 < H; h0 += HC) {
    // dhd[:, h0 + 16*warp : +16] = do @ W2ᵀ for both 16-row halves; the
    // (K = D, N = H) operand is w2t itself, row-major
    {
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
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const long long row = row0 + r;
      float dv = 0.0f;
      if (row < T_rows)
        dv = bwd_hidden(u, hd, du, dhs[r * L::LDU + c], row, H, h0 + c, drop);
      store(dus + r * L::LDH + c, dv);
    }
    __syncthreads();
    // dxn += du_chunk @ W1ᵀ[h0 : h0 + HC, this warp's columns]; the
    // (K = H, N = D) operand is w1t itself, row-major
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, dus + kk, L::LDH);
      wmma::load_matrix_sync(a1, dus + 16 * L::LDH + kk, L::LDH);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp * NT + t) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, w1t + (long long)(h0 + kk) * D + n0, D);
        wmma::mma_sync(acc[0][t], a0, bw, acc[0][t]);
        wmma::mma_sync(acc[1][t], a1, bw, acc[1][t]);
      }
    }
    // the next chunk writes dhs (free since the element-wise pass) and,
    // after its first barrier, dus (free once every warp passed it)
  }
  __syncthreads();  // dos/dhs/dus are dead: the staging buffer aliases them
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n0 = (warp * NT + t) * 16;
    wmma::store_matrix_sync(os + n0, acc[0][t], L::LDO, wmma::mem_row_major);
    wmma::store_matrix_sync(os + 16 * L::LDO + n0, acc[1][t], L::LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  bwd_epilogue(os, L::LDO, mean_s, rstd_s, x, g, dx, dgp, dbp, row0, T_rows, D);
}

template <int NT>
cudaError_t launch_bwd_bf16(const void* x, const void* u, const void* dy,
                            const void* g, const void* bt, const void* w1t,
                            const void* w2t, void* do_, void* hd, void* du,
                            void* xn, void* dx, void* dgp, void* dbp, int T_rows,
                            int H, float eps, Dropout drop, cudaStream_t s) {
  return launch_rows(
      ln_mlp_bwd_bf16_kernel<NT>, Bf16BwdLayout<NT>::SMEM, T_rows, 1, s,
      static_cast<const bf16*>(x), static_cast<const bf16*>(u),
      static_cast<const bf16*>(dy), static_cast<const bf16*>(g),
      static_cast<const bf16*>(bt), static_cast<const bf16*>(w1t),
      static_cast<const bf16*>(w2t), static_cast<bf16*>(do_),
      static_cast<bf16*>(hd), static_cast<bf16*>(du), static_cast<bf16*>(xn),
      static_cast<bf16*>(dx), static_cast<float*>(dgp), static_cast<float*>(dbp),
      T_rows, H, eps, drop);
}

// ---------------------------------------------------------------- fp32 --
__host__ __device__ constexpr int bwd_f32_smem_bytes(int D) {
  return (ROWS * D + f32_wbuf(D) + ROWS * F_HC + 2 * ROWS) * 4;
}

__global__ void __launch_bounds__(THREADS)
ln_mlp_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                      const float* __restrict__ dy, const float* __restrict__ g,
                      const float* __restrict__ bt, const float* __restrict__ w1t,
                      const float* __restrict__ w2t, float* __restrict__ do_,
                      float* __restrict__ hd, float* __restrict__ du,
                      float* __restrict__ xn, float* __restrict__ dx,
                      float* __restrict__ dgp, float* __restrict__ dbp,
                      int T_rows, int D, int H, float eps, Dropout drop) {
  extern __shared__ __align__(128) float fsm[];
  float* dos = fsm;                    // (ROWS, D); dxn staging at the end
  float* wb = dos + ROWS * D;          // W2 chunk (F_HC, D+1) or W1 chunk (F_HC, D)
  float* dus = wb + f32_wbuf(D);   // (ROWS, F_HC)
  float* mean_s = dus + ROWS * F_HC;
  float* rstd_s = mean_s + ROWS;
  const int tid = threadIdx.x;
  const int n = tid % 32;              // hidden unit of the chunk (dhd phase)
  const int rg = tid / 32;             // row group of 4 rows (dhd phase)
  const long long row0 = (long long)blockIdx.x * ROWS;

  bwd_prologue<true>(x, g, bt, xn, mean_s, rstd_s, row0, T_rows, D, eps, dy,
                     do_, dos, D, drop);

  float acc[F_MAX_M][ROWS];
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.0f;

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
      const int r = rg * 4 + q;
      const long long row = row0 + r;
      float dv = 0.0f;
      if (row < T_rows) dv = bwd_hidden(u, hd, du, dh[q], row, H, h0 + n, drop);
      dus[r * F_HC + n] = dv;
    }
    __syncthreads();
    for (int e = tid; e < F_HC * D; e += THREADS)
      wb[e] = w1t[(long long)h0 * D + e];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < F_MAX_M; ++m) {
      const int c = tid + THREADS * m;
      if (c < D) {
        for (int nn = 0; nn < F_HC; ++nn) {
          const float w = wb[nn * D + c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[m][r] += dus[r * F_HC + nn] * w;
        }
      }
    }
  }
  __syncthreads();  // dos is dead: it stages dxn for the epilogue
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m) {
    const int c = tid + THREADS * m;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dos[r * D + c] = acc[m][r];
  }
  __syncthreads();
  bwd_epilogue(dos, D, mean_s, rstd_s, x, g, dx, dgp, dbp, row0, T_rows, D);
}

}  // namespace

// Rows of the (blocks, D) dγ/dβ partial buffers of kernels 3 and 9 for T
// rows: both give each block ROWS rows.
extern "C" int lafs_row_blocks(int T_rows) {
  return T_rows > 0 ? (T_rows + ROWS - 1) / ROWS : 0;
}

// Widths as kernel 2: D a multiple of 128 up to 768, H a multiple of 128
// (checked by the Python wrapper). `drop` = 0 turns dropout off.
extern "C" int lafs_fused_ln_mlp_bwd_bf16(
    const void* x, const void* u, const void* dy, const void* g, const void* bt,
    const void* w1t, const void* w2t, void* do_, void* hd, void* du, void* xn,
    void* dx, void* dgp, void* dbp, int T_rows, int D, int H, float eps,
    unsigned seed, unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
#define LAFS_BWD_CASE(NT)                                                      \
  case NT * 128:                                                               \
    return launch_bwd_bf16<NT>(x, u, dy, g, bt, w1t, w2t, do_, hd, du, xn, dx, \
                               dgp, dbp, T_rows, H, eps, dr, s);
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

extern "C" int lafs_fused_ln_mlp_bwd_f32(
    const void* x, const void* u, const void* dy, const void* g, const void* bt,
    const void* w1t, const void* w2t, void* do_, void* hd, void* du, void* xn,
    void* dx, void* dgp, void* dbp, int T_rows, int D, int H, float eps,
    unsigned seed, unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || H % F_HC) return cudaErrorInvalidValue;
  return launch_rows(
      ln_mlp_bwd_f32_kernel, bwd_f32_smem_bytes(D), T_rows, 1, s,
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(dy), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const float*>(w1t),
      static_cast<const float*>(w2t), static_cast<float*>(do_),
      static_cast<float*>(hd), static_cast<float*>(du), static_cast<float*>(xn),
      static_cast<float*>(dx), static_cast<float*>(dgp), static_cast<float*>(dbp),
      T_rows, D, H, eps, make_dropout(seed, thresh, inv_keep, drop, 64));
}
