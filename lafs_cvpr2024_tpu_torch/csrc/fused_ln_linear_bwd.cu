// LayerNorm fused into a bias-free linear projection, backward (kernel 9
// of the PyTorch/CUDA port; the backward of kernel 8, attn_impl='lnqkv').
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_ln_linear.py
// (_bwd_kernel, called from _bwd_call). Per row, from x and the output
// gradient dy (T, O):
//     xhat = (x - mean) * rstd, xn = xhat * g + bt      (fp32 statistics)
//     dxn  = dy @ W                   (fp32 accumulate; W is (O, D))
//     dx   = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//            dxhat = dxn * g
// and per block the fp32 partial sums over its rows of dxn * xhat (dγ) and
// dxn (dβ). xn (in the input dtype) feeds dW = dyᵀ·xn, which the JAX
// package leaves to XLA (here the Python wrapper's torch.matmul); dx is the
// input gradient. dxn stays fp32 into the LayerNorm backward, as the JAX
// kernel keeps it.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, O = 2,112, bf16) the product is 82 GFLOP against ~225 MB of
// compulsory traffic (x and dy in; xn and dx out): 0.083 ms of the
// tensor-core peak against 0.067 ms at the memory rate, bound by
// operations. The TPU kernel carried dγ/dβ in VMEM across its sequential
// grid; here blocks run in no order, so each block writes its partial row
// to a (blocks, D) buffer that the wrapper sums (deterministic, no
// atomics), as kernel 3 does. A block owns ROWS = 32 rows and all D
// columns, the (32, D) fp32 dxn held in tensor-core fragments in registers
// (each warp NT 16-column tiles of both 16-row halves, as kernel 3), and
// walks O in OC-wide chunks: the chunk of dy (zeros past T and past O) and
// the (OC, D) rows of W (zeros past O) are staged in shared memory, so the
// ragged O = 2,112 needs no padded copy of W. Then the staged dxn goes
// through kernel 3's LayerNorm-backward epilogue while still on chip. fp32
// runs a scalar FMA loop with the same staging. Every block re-reads W
// from L2 (~2.6 GB a call at this shape): simple and right, not yet the
// pipelined wgmma/TMA form.

#include <mma.h>

#include "fused_ln_mlp_common.cuh"

namespace {

using namespace lafs_mlp;
using namespace nvcuda;

constexpr int OC = 32;        // O chunk (the product's K) per stage

// NT = dxn column tiles (16 wide) per warp; D = NT * 16 * WARPS.
template <int NT>
struct LnLinearBwdLayout {
  static constexpr int D = NT * 16 * WARPS;
  static constexpr int LDY = OC + 8;  // bf16 dy chunk rows
  static constexpr int LDW = D + 8;   // bf16 W chunk rows
  static constexpr int LDO = D + 4;   // fp32 dxn staging rows
  static constexpr int YS = ROWS * LDY * 2;
  static constexpr int WS = OC * LDW * 2;
  static constexpr int OS = ROWS * LDO * 4;
  static constexpr int BODY = YS + WS > OS ? YS + WS : OS;
  static constexpr int SMEM = BODY + 2 * ROWS * 4;  // + row mean, rstd
};

// The chunk o0 .. o0 + OC of dy for the block's rows -> ys (ROWS, ldy) and
// rows o0 .. o0 + OC of W -> wsm (OC, ldw), zeros past T and O. W's rows go
// in 16-byte loads (D % 128 == 0; the wrapper checks W's alignment).
template <typename T>
__device__ void stage_chunk(const T* __restrict__ dy, const T* __restrict__ w,
                            T* ys, int ldy, T* wsm, int ldw, long long row0,
                            int T_rows, int o0, int D, int O) {
  for (int e = threadIdx.x; e < ROWS * OC; e += THREADS) {
    const int r = e / OC, c = e % OC;
    const long long row = row0 + r;
    const bool in = row < T_rows && o0 + c < O;
    store(ys + r * ldy + c, in ? to_f32(dy[row * O + o0 + c]) : 0.0f);
  }
  constexpr int V = 16 / sizeof(T);  // values per 16-byte load
  for (int e = threadIdx.x; e < OC * D / V; e += THREADS) {
    const int o = e / (D / V), k = (e % (D / V)) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (o0 + o < O)
      v = *reinterpret_cast<const uint4*>(w + (long long)(o0 + o) * D + k);
    *reinterpret_cast<uint4*>(wsm + o * ldw + k) = v;
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
ln_linear_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                          const bf16* __restrict__ g, const bf16* __restrict__ bt,
                          const bf16* __restrict__ w, bf16* __restrict__ xn,
                          bf16* __restrict__ dx, float* __restrict__ dgp,
                          float* __restrict__ dbp, int T_rows, int O, float eps) {
  using L = LnLinearBwdLayout<NT>;
  constexpr int D = L::D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* wsm = reinterpret_cast<bf16*>(smem + L::YS);
  float* os = reinterpret_cast<float*>(smem);  // epilogue: aliases the rest
  float* mean_s = reinterpret_cast<float*>(smem + L::BODY);
  float* rstd_s = mean_s + ROWS;

  const int warp = threadIdx.x / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;

  bwd_prologue<false>(x, g, bt, xn, mean_s, rstd_s, row0, T_rows, D, eps,
                      (const bf16*)nullptr, (bf16*)nullptr, (bf16*)nullptr, 0,
                      Dropout());

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::fill_fragment(acc[0][t], 0.0f);
    wmma::fill_fragment(acc[1][t], 0.0f);
  }
  for (int o0 = 0; o0 < O; o0 += OC) {
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(dy, w, ys, L::LDY, wsm, L::LDW, row0, T_rows, o0, D, O);
    __syncthreads();
    // dxn[:, this warp's columns] += dy_chunk @ W_chunk; W's rows are the
    // (K = O, N = D) operand, row-major
#pragma unroll
    for (int kk = 0; kk < OC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, ys + kk, L::LDY);
      wmma::load_matrix_sync(a1, ys + 16 * L::LDY + kk, L::LDY);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp * NT + t) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, wsm + kk * L::LDW + n0, L::LDW);
        wmma::mma_sync(acc[0][t], a0, bw, acc[0][t]);
        wmma::mma_sync(acc[1][t], a1, bw, acc[1][t]);
      }
    }
  }
  __syncthreads();  // ys/wsm are dead: the staging buffer aliases them
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

// fp32: dy chunk (ROWS, OC), W chunk (OC, D) aliased by the (ROWS, D) dxn
// staging of the epilogue (OC == ROWS), row mean and rstd
__host__ __device__ constexpr int ln_linear_bwd_f32_smem(int D) {
  return (OC * D + ROWS * OC + 2 * ROWS) * 4;
}

__global__ void __launch_bounds__(THREADS)
ln_linear_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         const float* __restrict__ g, const float* __restrict__ bt,
                         const float* __restrict__ w, float* __restrict__ xn,
                         float* __restrict__ dx, float* __restrict__ dgp,
                         float* __restrict__ dbp, int T_rows, int D, int O,
                         float eps) {
  static_assert(OC == ROWS, "the W chunk buffer stages the (ROWS, D) dxn");
  extern __shared__ __align__(128) float fsm[];
  float* wsm = fsm;                    // W chunk (OC, D); dxn at the end
  float* ys = wsm + OC * D;            // dy chunk (ROWS, OC)
  float* mean_s = ys + ROWS * OC;
  float* rstd_s = mean_s + ROWS;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ROWS;

  bwd_prologue<false>(x, g, bt, xn, mean_s, rstd_s, row0, T_rows, D, eps,
                      (const float*)nullptr, (float*)nullptr, (float*)nullptr, 0,
                      Dropout());

  float acc[F_MAX_M][ROWS];
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.0f;

  for (int o0 = 0; o0 < O; o0 += OC) {
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(dy, w, ys, OC, wsm, D, row0, T_rows, o0, D, O);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < F_MAX_M; ++m) {
      const int c = tid + THREADS * m;
      if (c < D) {
        for (int oo = 0; oo < OC; ++oo) {
          const float wv = wsm[oo * D + c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[m][r] += ys[r * OC + oo] * wv;
        }
      }
    }
  }
  __syncthreads();  // wsm is dead: it stages dxn for the epilogue
#pragma unroll
  for (int m = 0; m < F_MAX_M; ++m) {
    const int c = tid + THREADS * m;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) wsm[r * D + c] = acc[m][r];
  }
  __syncthreads();
  bwd_epilogue(wsm, D, mean_s, rstd_s, x, g, dx, dgp, dbp, row0, T_rows, D);
}

}  // namespace

// Widths as kernel 8: D a multiple of 128 up to 768, any O >= 1 (checked by
// the Python wrapper).
extern "C" int lafs_fused_ln_linear_bwd_bf16(const void* x, const void* dy,
                                             const void* g, const void* bt,
                                             const void* w, void* xn, void* dx,
                                             void* dgp, void* dbp, int T_rows,
                                             int D, int O, float eps,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (O <= 0) return cudaErrorInvalidValue;
#define LAFS_BWD_CASE(NT)                                                      \
  case NT * 128:                                                               \
    return launch_rows(ln_linear_bwd_bf16_kernel<NT>,                          \
                       LnLinearBwdLayout<NT>::SMEM, T_rows, 1, s,              \
                       static_cast<const bf16*>(x), static_cast<const bf16*>(dy), \
                       static_cast<const bf16*>(g), static_cast<const bf16*>(bt), \
                       static_cast<const bf16*>(w), static_cast<bf16*>(xn),    \
                       static_cast<bf16*>(dx), static_cast<float*>(dgp),       \
                       static_cast<float*>(dbp), T_rows, O, eps);
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

extern "C" int lafs_fused_ln_linear_bwd_f32(const void* x, const void* dy,
                                            const void* g, const void* bt,
                                            const void* w, void* xn, void* dx,
                                            void* dgp, void* dbp, int T_rows,
                                            int D, int O, float eps,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (D % 128 || D > F_MAX_D || O <= 0) return cudaErrorInvalidValue;
  return launch_rows(
      ln_linear_bwd_f32_kernel, ln_linear_bwd_f32_smem(D), T_rows, 1, s,
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<const float*>(w), static_cast<float*>(xn),
      static_cast<float*>(dx), static_cast<float*>(dgp),
      static_cast<float*>(dbp), T_rows, D, O, eps);
}
