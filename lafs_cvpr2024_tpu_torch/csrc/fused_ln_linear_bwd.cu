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
// and per row block the fp32 partial sums over its rows of dxn * xhat (dγ)
// and dxn (dβ). xn (in the input dtype) feeds dW = dyᵀ·xn, which the JAX
// package leaves to XLA (here the Python wrapper's torch.matmul); dx is the
// input gradient. dxn stays fp32 into the LayerNorm backward, as the JAX
// kernel keeps it.
//
// What bounds it on the card. At the SimMIM step's shape (T = 25,216,
// D = 768, O = 2,112, bf16) the product is 82 GFLOP against ~225 MB of
// compulsory traffic (x and dy in; xn and dx out): 0.083 ms of the
// tensor-core peak against 0.067 ms at the memory rate, bound by
// operations. The TPU kernel carried dγ/dβ in VMEM across its sequential
// grid; here blocks run in no order, so each row block writes its partial
// row to a (blocks, D) buffer that the wrapper sums (deterministic, no
// atomics). The full 768-wide row of dxn is needed before dx, so a fused
// form holds (rows, 768) fp32 accumulators and reads W once per its rows.
//
// The design in bf16 at D = 768 with O a multiple of 8 is kernel 3's
// cluster form (fused_ln_mlp_sm90.cuh): a 2-CTA cluster owns 64 rows; CTA r
// owns the dxn columns [384r, 384r + 384), its two consumer warpgroups a
// (64, 192) fp32 accumulator each. The producer warpgroup streams, per
// 64-wide chunk of O (the product's K; 33 chunks at O = 2,112), the dy box
// (64 rows x 64, K-major A, shared by both warpgroups) and six W boxes (64
// O-rows x 64 columns, MN-major B: the transpose bit, as kernel 3's second
// product) through a 3-stage ring of 56 KB, two loads in flight while one
// stage is read; one wgmma group stays in flight while the next stage
// lands. Rows and chunks past T or O load as zeros (the tensor maps), so
// the ragged O needs no padded copy. Meanwhile the consumers find the fp32
// two-pass statistics of the cluster's rows from x in device memory (a
// warp a row, in registers) and store xn for the CTA's columns from the
// same registers. The epilogue is kernel 3's LayerNorm backward: each row's
// sums of dxhat and dxhat xhat, spread over 2 CTAs x 2 warpgroups x a quad,
// meet in each CTA's exchange buffer (written locally and through
// distributed shared memory) and are summed in one fixed order, so both
// CTAs form dx from the same bits; x pairs come from device memory (L2) as
// in kernel 3, dx leaves as bf16 pairs from the fragments; one dγ/dβ
// partial row a cluster (lafs_ln_linear_bwd_partial_rows). Shared memory:
// the ring 168 KB + the exchange and statistics 2.5 KB. The W bytes in
// flight bound it: a TMA-loaded x tile in shared memory (96 KB) leaves
// room for two stages, which ran 1.2x slower (PERF.md §6).
//
// Other widths (D a multiple of 128 up to 640, O not a multiple of 8) keep
// the first design: a block owns ROWS = 32 rows and all D columns, the (32,
// D) fp32 dxn held in tensor-core fragments in registers (nvcuda::wmma,
// each warp NT 16-column tiles of both 16-row halves, as kernel 3's first
// design), and walks O in OC-wide chunks: the chunk of dy (zeros past T and
// past O) and the (OC, D) rows of W (zeros past O) are staged in shared
// memory by plain loads. Then the staged dxn goes through kernel 3's
// LayerNorm-backward epilogue while still on chip; one partial row a
// 32-row block. fp32 (the precision check) runs a scalar FMA loop with the
// same staging. The C entry points choose by (dtype, D, O).

#include <mma.h>

#include "fused_ln_mlp_common.cuh"
#include "fused_ln_mlp_sm90.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

constexpr int STAGE9 = BOX + (COLS / 64) * BOX;  // dy box + six W boxes: 56 KB
constexpr int STAGES9 = 3;                       // the ring
constexpr int BR_OFF = 0;
constexpr int RED_OFF = BR_OFF + STAGES9 * STAGE9;  // row sums: 4 x 64 x 2
constexpr int STAT_OFF = RED_OFF + 4 * ROWS * 8;    // mean, rstd of 64 rows
constexpr int BBAR_OFF = STAT_OFF + 2 * ROWS * 4;
constexpr int SMEM9 = BBAR_OFF + 64 + 1024;      // + alignment to 1024 bytes
static_assert(2 * 4 * 192 * 2 * 4 <= STAGES9 * STAGE9,
              "column sums fit in the ring");

// The CTA's mbarriers, 8 bytes each from `at`: the ring's full and empty
// stages and the row sums of the LayerNorm backward (both CTAs' consumers
// arrive on each CTA's).
struct Bars9 {
  uint32_t at;
  __device__ explicit Bars9(uint32_t a) : at(a) {}
  __device__ uint32_t full(int s) const { return at + 8 * s; }
  __device__ uint32_t empty(int s) const { return at + 8 * (STAGES9 + s); }
  __device__ uint32_t red() const { return at + 16 * STAGES9; }

  __device__ void init() const {
    for (int s = 0; s < STAGES9; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(red(), 2 * CONSUMERS);
    fence_mbar_init();
  }
};

// Registers: as kernel 3, the producer warpgroup drops to 40 so that the
// consumers rise to 232 for their 96 accumulator registers.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
ln_linear_bwd_sm90(const __grid_constant__ CUtensorMap mdy,
                   const __grid_constant__ CUtensorMap mw,
                   const bf16* __restrict__ x,
                   const bf16* __restrict__ g, const bf16* __restrict__ bt,
                   bf16* __restrict__ xn, bf16* __restrict__ dx,
                   float* __restrict__ dgp, float* __restrict__ dbp,
                   int T_rows, int O, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const Bars9 bars(base + BBAR_OFF);
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int cluster = blockIdx.x / 2;
  const int row0 = cluster * ROWS;
  const int chunks = (O + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == CONSUMERS) bars.init();
  cluster_sync();  // the peer's barriers exist before any remote arrival

  if (warp >= 8) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % STAGES9, use = c / STAGES9;
        if (use > 0) mbar_wait(bars.empty(s), (use - 1) & 1);
        const uint32_t st = base + BR_OFF + s * STAGE9;
        mbar_expect_tx(bars.full(s), STAGE9);
        // dy[row0 : +64, 64 c : +64], then W[64 c : +64, this CTA's 384]
        tma_load_2d(st, &mdy, bars.full(s), 64 * c, row0);
        for (int bx = 0; bx < COLS / 64; ++bx)
          tma_load_2d(st + BOX + bx * BOX, &mw, bars.full(s),
                      COLS * rank + 64 * bx, 64 * c);
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while its peer may still arrive on it
  } else {  // consumer warpgroup wg: rows rw and rw + 8 of the cluster's 64
    setmaxnreg_inc<232>();
    const int wg = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    const int tid = threadIdx.x;
    float* mean_s = reinterpret_cast<float*>(sbase + STAT_OFF);
    float* rstd_s = mean_s + ROWS;
    // the statistics of the cluster's rows from x in device memory (a warp
    // a row, lane l the 16-byte chunks l, l + 32, l + 64; rows at or past T
    // read as zeros and get (0, 0), so that their xhat is 0) and xn for
    // this CTA's columns from the same registers, while the producer fills
    // the ring
    for (int r = warp; r < ROWS; r += 8) {
      const long long row = (long long)row0 + r;
      const bool ok = row < T_rows;
      const uint4* src = reinterpret_cast<const uint4*>(x + row * D) + lane;
      float f[24];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        unpack8(ok ? __ldg(src + 32 * j) : make_uint4(0u, 0u, 0u, 0u),
                f + 8 * j);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 24; ++k) s += f[k];
      const float mean = lafs_mlp::warp_sum(s) / (float)D;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 24; ++k) {
        const float d = f[k] - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(lafs_mlp::warp_sum(v) / (float)D + eps);
      if (lane == 0) {
        mean_s[r] = ok ? mean : 0.0f;
        rstd_s[r] = ok ? rstd : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int cc = lane + 32 * j;  // this CTA's chunks: [48 rank, +48)
        if (ok && cc / (COLS / 8) == (int)rank) {
          float h[8], gv[8], bv[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(g) + cc), gv);
          unpack8(__ldg(reinterpret_cast<const uint4*>(bt) + cc), bv);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            h[k] = (f[8 * j + k] - mean) * rstd * gv[k] + bv[k];
          reinterpret_cast<uint4*>(xn + row * D)[cc] = pack8(h);
        }
      }
    }
    bar_sync(1, CONSUMERS);  // the statistics, for every consumer

    // dxn[:, 384 rank + 192 wg : +192] = dy @ W, K = O in 64-wide chunks
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    int prev = 0;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES9;
      mbar_wait(bars.full(s), (c / STAGES9) & 1);
      const uint32_t st = base + BR_OFF + s * STAGE9;
      reg_fence<96>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<192, 1>(acc, desc_sw128(st + 32 * kk, 16, 1024),
                         desc_sw128(st + BOX + wg * 3 * BOX + 2048 * kk, BOX,
                                    1024),
                         c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence<96>(acc);
      if (c > 0) mbar_arrive(bars.empty(prev));
      prev = s;
    }
    wgmma_wait<0>();  // (the last stage is not loaded again)
    reg_fence<96>(acc);

    // The LayerNorm backward. acc[4j + e] is dxn at row rw + 8 (e >= 2),
    // column col0 + 8j + (e & 1).
    const int col0 = COLS * rank + 192 * wg + 2 * quad;
    const long long ra = (long long)row0 + rw, rb = ra + 8;
    const float ma = mean_s[rw], sa = rstd_s[rw];
    const float mb = mean_s[rw + 8], sb = rstd_s[rw + 8];
    const float2 zero = make_float2(0.0f, 0.0f);
    float s1a = 0.0f, s2a = 0.0f, s1b = 0.0f, s2b = 0.0f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = col0 + 8 * j;
      const float2 gp = load_pair(g, col);
      const float2 xa = ra < T_rows ? load_pair(x, ra * D + col) : zero;
      const float2 xb = rb < T_rows ? load_pair(x, rb * D + col) : zero;
      const float xa0 = (xa.x - ma) * sa, xa1 = (xa.y - ma) * sa;
      const float xb0 = (xb.x - mb) * sb, xb1 = (xb.y - mb) * sb;
      const float da0 = acc[4 * j] * gp.x, da1 = acc[4 * j + 1] * gp.y;
      const float db0 = acc[4 * j + 2] * gp.x, db1 = acc[4 * j + 3] * gp.y;
      s1a += da0 + da1;
      s2a += da0 * xa0 + da1 * xa1;
      s1b += db0 + db1;
      s2b += db0 * xb0 + db1 * xb1;
    }
    s1a = quad_sum(s1a);
    s2a = quad_sum(s2a);
    s1b = quad_sum(s1b);
    s2b = quad_sum(s2b);
    // the row sums of the four (CTA, warpgroup) sources meet in both CTAs'
    // exchange buffers: red[source][row] = (sum dxhat, sum dxhat xhat)
    if (quad == 0) {
      const int src = 2 * rank + wg;
      const float v[4] = {s1a, s2a, s1b, s2b};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t off =
            RED_OFF + (src * ROWS + rw + 8 * (k / 2)) * 8 + 4 * (k % 2);
        *reinterpret_cast<float*>(sbase + off) = v[k];
        st_cluster_u32(mapa(base + off, peer), __float_as_uint(v[k]));
      }
    }
    arrive_both(bars.red(), peer);
    mbar_wait_cluster(bars.red(), 0);
    float m1a = 0.0f, m2a = 0.0f, m1b = 0.0f, m2b = 0.0f;
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const float* pa = reinterpret_cast<const float*>(
          sbase + RED_OFF + (src * ROWS + rw) * 8);
      const float* pb = reinterpret_cast<const float*>(
          sbase + RED_OFF + (src * ROWS + rw + 8) * 8);
      m1a += pa[0];
      m2a += pa[1];
      m1b += pb[0];
      m2b += pb[1];
    }
    m1a /= (float)D;
    m2a /= (float)D;
    m1b /= (float)D;
    m2b /= (float)D;
    // dx for this CTA's columns; the dγ/dβ column sums over the warp's 16
    // rows, then over the warpgroup's 4 warps in the ring (every consumer
    // of this CTA is past its last product: the red phase above):
    // colsum[wg][warp][column][dγ, dβ]
    float* colsum = reinterpret_cast<float*>(sbase + BR_OFF);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = col0 + 8 * j;
      const float2 gp = load_pair(g, col);
      const float2 xa = ra < T_rows ? load_pair(x, ra * D + col) : zero;
      const float2 xb = rb < T_rows ? load_pair(x, rb * D + col) : zero;
      const float xa0 = (xa.x - ma) * sa, xa1 = (xa.y - ma) * sa;
      const float xb0 = (xb.x - mb) * sb, xb1 = (xb.y - mb) * sb;
      const float n0 = acc[4 * j], n1 = acc[4 * j + 1];
      const float n2 = acc[4 * j + 2], n3 = acc[4 * j + 3];
      if (ra < T_rows)
        store_pair(dx, ra * D + col, sa * (n0 * gp.x - m1a - xa0 * m2a),
                   sa * (n1 * gp.y - m1a - xa1 * m2a));
      if (rb < T_rows)
        store_pair(dx, rb * D + col, sb * (n2 * gp.x - m1b - xb0 * m2b),
                   sb * (n3 * gp.y - m1b - xb1 * m2b));
      float v[4] = {n0 * xa0 + n2 * xb0, n1 * xa1 + n3 * xb1, n0 + n2, n1 + n3};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
      if (lane < 4) {
        float* cs = colsum + ((wg * 4 + warp % 4) * 192 + 8 * j + 2 * quad) * 2;
        cs[0] = v[0];
        cs[1] = v[2];
        cs[2] = v[1];
        cs[3] = v[3];
      }
    }
    bar_sync(1, CONSUMERS);
    for (int k = tid; k < COLS; k += CONSUMERS) {
      const int kw = k / 192, kc = k % 192;
      float sg = 0.0f, sbeta = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        sg += colsum[((kw * 4 + w) * 192 + kc) * 2];
        sbeta += colsum[((kw * 4 + w) * 192 + kc) * 2 + 1];
      }
      dgp[(long long)cluster * D + COLS * rank + k] = sg;
      dbp[(long long)cluster * D + COLS * rank + k] = sbeta;
    }
    __syncwarp();
    cluster_sync();
  }
}

cudaError_t run(const void* x, const void* dy, const void* g, const void* bt,
                const void* w, void* xn, void* dx, void* dgp, void* dbp,
                int T_rows, int O, float eps, cudaStream_t s) {
  CUtensorMap mdy, mw;
  cudaError_t err;
  if ((err = lafs_ln_mlp_sm90_host::map2d(&mdy, dy, O, T_rows, ROWS)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw, w, D, O, 64)) != cudaSuccess)
    return err;
  return lafs_ln_mlp_sm90_host::launch(
      ln_linear_bwd_sm90, SMEM9, T_rows, s, mdy, mw,
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(bt),
      static_cast<bf16*>(xn), static_cast<bf16*>(dx), static_cast<float*>(dgp),
      static_cast<float*>(dbp), T_rows, O, eps);
}

}  // namespace hop

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

// Rows of kernel 9's (rows, D) dγ/dβ partial buffers for T rows at these
// widths: one a 64-row cluster in the Hopper design (bf16, D = 768, O a
// multiple of 8), one a 32-row block in the first.
extern "C" int lafs_ln_linear_bwd_partial_rows(int T_rows, int D, int O,
                                               int is_bf16) {
  if (T_rows <= 0) return 0;
  if (is_bf16 && lafs_ln_mlp_sm90::takes_linear(D, O))
    return lafs_ln_mlp_sm90::clusters(T_rows);
  return (T_rows + ROWS - 1) / ROWS;
}

// Widths as kernel 8: D a multiple of 128 up to 768, any O >= 1 (checked by
// the Python wrapper, which hands every operand 16-byte aligned); bf16 at
// D = 768 with O a multiple of 8 runs the Hopper design. dgp and dbp hold
// lafs_ln_linear_bwd_partial_rows(T, D, O, 1) rows of D floats.
extern "C" int lafs_fused_ln_linear_bwd_bf16(const void* x, const void* dy,
                                             const void* g, const void* bt,
                                             const void* w, void* xn, void* dx,
                                             void* dgp, void* dbp, int T_rows,
                                             int D, int O, float eps,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (O <= 0) return cudaErrorInvalidValue;
  if (lafs_ln_mlp_sm90::takes_linear(D, O))
    return hop::run(x, dy, g, bt, w, xn, dx, dgp, dbp, T_rows, O, eps, s);
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
