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
// D = 768, H = 2048) the two products are 79 GFLOP (0.08 ms of the bf16
// tensor-core peak) and the compulsory device-memory traffic ~180 MB (x, dy
// and u in; do, hd, du, xn and dx out, u/hd/du being T x H each: 155 MB;
// 0.05 ms): bound by operations. The TPU kernel's sequential grid carried
// dγ/dβ in VMEM; here blocks run in no order on 132 SMs, so each block
// writes a dγ/dβ partial row that the wrapper sums (deterministic, no
// atomics). What the design keeps from the TPU kernel: dhd and dxn never
// reach device memory, and the LayerNorm backward runs while dxn is still
// on chip. As in kernel 2, the (rows, 768) fp32 dxn accumulator caps the
// rows a block can hold, and every block takes in both weights once per
// its rows: the weight bytes each SM ingests bound the fused form.
//
// The design in bf16 at D = 768 with H a multiple of 256 is row 10's
// cluster form (fused_ln_mlp_sm90.cuh, mlp_fusion.cu), whose two products
// have exactly kernel 3's operand layouts (do K-major; w2t (D, H) and w1t
// (H, D) MN-major, the transpose bit; du the bf16 A operand in the shared
// h buffers): a 2-CTA cluster owns 64 rows and reads the weights once per
// 64 rows (~1.24 GB of L2 a call at T = 12,608; the first design's 32-row
// blocks read ~2.5 GB). Kernel 3's own parts:
// - the prologue: the consumers find the fp32 two-pass statistics of their
//   fragment rows from x in device memory (which L2 holds; each quad reads
//   its two rows, so both warpgroups of both CTAs hold them in registers
//   for the epilogue) and store xn for the CTA's columns; the producer
//   TMA-loads dy into the row tile (rows at or past T zero-filled), which
//   the consumers turn into do = drop_1(dy) in place (all 768 columns, the
//   A operand of both CTAs) and store for the CTA's columns, then fence the
//   generic-proxy writes for the wgmmas and meet at a named barrier;
// - per chunk: dhd = do W2 in registers; the thread's u pairs are loaded
//   ahead of the product, so their latency hides under it; the pass
//   computes hd = drop_0(gelu(u)) and du = drop_0(dhd) gelu'(u) in
//   registers and stores both as bf16 pairs from the accumulator fragments
//   (4-byte stores, 16 contiguous bytes a quad: shared memory has no room
//   left to stage hd; storing du from the h buffer in 16-byte chunks cost
//   the dropout instance a register spill), and du goes into both CTAs' h
//   buffers as the A operand of dxn += du W1;
// - the epilogue, the LayerNorm backward in the cluster: each row's sums of
//   dxhat and dxhat xhat over its 768 columns are spread over 2 CTAs x 2
//   warpgroups; a quad reduces its 48 columns (shfl_xor 1, 2), then the
//   four partials meet in each CTA's h buffer (free once both CTAs have read
//   their last chunk: the h_free phase), written locally and through
//   distributed shared memory, and are summed in one order by every reader;
//   dx is formed for the CTA's columns. The dγ/dβ partials sum over the
//   warp's 16 rows (shfl_xor 4, 8, 16), then over the 4 warps through
//   shared memory, one partial row per cluster: ceil(T / 64) rows
//   (lafs_ln_mlp_bwd_partial_rows).
// Rows at or past T read dy = 0 and x = 0, so do = du = dxn = 0 and xhat
// = 0: they add nothing to the sums and are never stored (the JAX kernel's
// own argument). Rate 0 and dropout are two template instances.
//
// Other widths and fp32 keep the first design: bf16 through nvcuda::wmma
// (16x16x16, fp32 accumulate) over 32-row blocks, each chunk's dhd through
// shared memory, ceil(T / 32) partial rows; fp32 a scalar FMA loop over
// tiles staged in shared memory. The C entry points choose by (dtype, D,
// H).

#include <mma.h>

#include "fused_ln_mlp_common.cuh"
#include "fused_ln_mlp_sm90.cuh"

namespace {

namespace hop {

using namespace lafs_ln_mlp_sm90;

// (mean, rstd) of row `row` of x (T, 768) over a quad: lane q of the quad
// reads the 16-byte chunks q, q + 4, ...; a row at or past T gives (0, 0),
// so that its xhat is 0.
__device__ __forceinline__ float2 quad_row_stats(const bf16* __restrict__ x,
                                                 long long row, int T_rows,
                                                 float eps, int quad) {
  const bool ok = row < T_rows;
  const uint4* src = reinterpret_cast<const uint4*>(x + (ok ? row : 0) * D) + quad;
  float s = 0.0f;
  if (ok) {
#pragma unroll 4
    for (int j = 0; j < D / 32; ++j) {
      float f[8];
      unpack8(__ldg(src + 4 * j), f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += f[k];
    }
  }
  const float mean = quad_sum(s) / (float)D;
  float v = 0.0f;
  if (ok) {
#pragma unroll 4
    for (int j = 0; j < D / 32; ++j) {
      float f[8];
      unpack8(__ldg(src + 4 * j), f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = f[k] - mean;
        v += d * d;
      }
    }
  }
  const float rstd = rsqrtf(quad_sum(v) / (float)D + eps);
  return ok ? make_float2(mean, rstd) : make_float2(0.0f, 0.0f);
}

// The row sums' exchange: red[source][row] = (sum dxhat, sum dxhat xhat),
// source = 2 rank + warpgroup, in the h buffer.
__device__ __forceinline__ uint32_t red_offset(int src, int row) {
  return H_OFF + (src * ROWS + row) * 8;
}

// Registers: as kernel 2, the producer warpgroup drops to 40 so that the
// consumers rise to 232 for their 96 + 32 accumulator registers.
template <bool DROP>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
ln_mlp_bwd_sm90(const __grid_constant__ CUtensorMap mdy,
                const __grid_constant__ CUtensorMap mw2,
                const __grid_constant__ CUtensorMap mw1,
                const bf16* __restrict__ x, const bf16* __restrict__ u,
                const bf16* __restrict__ g, const bf16* __restrict__ bt,
                bf16* __restrict__ do_, bf16* __restrict__ hd,
                bf16* __restrict__ du, bf16* __restrict__ xn,
                bf16* __restrict__ dx, float* __restrict__ dgp,
                float* __restrict__ dbp, int T_rows, int H, float eps,
                Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const Bars bars(base + BAR_OFF);
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int cluster = blockIdx.x / 2;
  const int row0 = cluster * ROWS;
  const int chunks = H / HC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == CONSUMERS) bars.init();
  cluster_sync();  // the peer's barriers exist before any remote arrival

  if (warp >= 8) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bars.x_full(), (D / 64) * BOX);
      for (int kb = 0; kb < D / 64; ++kb)
        tma_load_2d(base + X_OFF + kb * BOX, &mdy, bars.x_full(), 64 * kb,
                    row0);
      int it = 0;
      for (int c = 0; c < chunks; ++c) {
        const int h0 = c * HC;
        for (int sl = 0; sl < 8; ++sl, ++it) {
          const int s = it % 2, use = it / 2;
          if (use > 0) mbar_wait(bars.empty(s), (use - 1) & 1);
          const uint32_t st = base + R_OFF + s * STAGE;
          mbar_expect_tx(bars.full(s), STAGE);
          if (sl < 4) {  // w2t[192 sl : +192, h0 + 128 rank + 64 g : +64]
            for (int wg = 0; wg < 2; ++wg)
              tma_load_2d(st + wg * (STAGE / 2), &mw2, bars.full(s),
                          h0 + 128 * rank + 64 * wg, SLAB * sl);
          } else {  // w1t[h0 + 64 (sl - 4) : +64, this CTA's 384 columns]
            for (int bx = 0; bx < COLS / 64; ++bx)
              tma_load_2d(st + bx * BOX, &mw1, bars.full(s),
                          COLS * rank + 64 * bx, h0 + 64 * (sl - 4));
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while its peer may still arrive on it
  } else {  // consumer warpgroup wg: rows rw and rw + 8 of the cluster's 64
    setmaxnreg_inc<232>();
    const int wg = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    const int tid = threadIdx.x;
    const uint32_t h_peer = mapa(base + H_OFF, peer);
    const long long ra = (long long)row0 + rw, rb = ra + 8;
    const uint32_t key_a = drop.row_key(ra, 0), key_b = drop.row_key(rb, 0);
    const float2 sa = quad_row_stats(x, ra, T_rows, eps, quad);
    const float2 sb = quad_row_stats(x, rb, T_rows, eps, quad);
    {  // xn for this CTA's columns: warpgroup wg stores row rw + 8 wg
      const long long row = wg ? rb : ra;
      const float2 st = wg ? sb : sa;
      if (row < T_rows) {
        for (int j = 0; j < 12; ++j) {
          const int c = 48 * rank + quad + 4 * j;
          float f[8], gv[8], bv[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(x + row * D) + c), f);
          unpack8(__ldg(reinterpret_cast<const uint4*>(g) + c), gv);
          unpack8(__ldg(reinterpret_cast<const uint4*>(bt) + c), bv);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] = (f[k] - st.x) * st.y * gv[k] + bv[k];
          reinterpret_cast<uint4*>(xn + row * D)[c] = pack8(f);
        }
      }
    }
    // do = drop_1(dy) in the row tile, in place (all 768 columns: both
    // CTAs' A operand); this CTA's 384 columns stored, rows below T
    mbar_wait(bars.x_full(), 0);
    do_tile_in_place<DROP>(sbase + X_OFF, do_, row0, T_rows, drop,
                           (COLS / 8) * rank, (COLS / 8) * (rank + 1));

    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    int it = 0;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = c * HC;
      const int hbox = 2 * rank + wg;  // this warpgroup's 64 chunk columns
      // this thread's u pairs of the chunk, loaded ahead of the product
      uint32_t uw[16];
      load_u_pairs(u, ra, rb, T_rows, H, h0 + 64 * hbox + 2 * quad, uw);
      // dhd = do @ W2ᵀ[:, h0 + 64 hbox : +64], K = 768 in 4 slabs
      float dh[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dh[i] = 0.0f;
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(bars.full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + wg * (STAGE / 2);
        reg_fence<32>(dh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLAB / 16; ++kk)
          wgmma_ss<64, 1>(
              dh,
              desc_sw128(base + X_OFF + (3 * sl + kk / 4) * BOX + 32 * (kk % 4),
                         16, 1024),
              desc_sw128(wb + 2048 * kk, STAGE / 2, 1024), sl > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<32>(dh);
        mbar_arrive(bars.empty(s));
      }
      // hd = drop_0(gelu(u)), du = drop_0(dhd) gelu'(u): stored, and du in
      // bf16 into both CTAs' h buffers once both have read the last chunk's
      if (c > 0) mbar_wait_cluster(bars.h_free(), (c - 1) & 1);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int row = rw + 8 * (q & 1), j8 = q >> 1;
        const int col = h0 + 64 * hbox + 8 * j8 + 2 * quad;
        const long long grow = (long long)row0 + row;
        const uint2 p = hidden_pair<DROP>(uw[q], dh[2 * q], dh[2 * q + 1],
                                          (q & 1) ? key_b : key_a, col, drop);
        if (grow < T_rows) {
          *reinterpret_cast<uint32_t*>(hd + grow * H + col) = p.x;
          *reinterpret_cast<uint32_t*>(du + grow * H + col) = p.y;
        }
        const uint32_t off = h_offset(hbox, row, j8, quad);
        *reinterpret_cast<uint32_t*>(sbase + H_OFF + off) = p.y;
        st_cluster_u32(h_peer + off, p.y);
      }
      fence_proxy_async_all();
      arrive_both(bars.h_full(), peer);
      mbar_wait_cluster(bars.h_full(), c & 1);
      // dxn += du @ W1ᵀ[h0 : h0 + 256, 384 rank + 192 wg : +192]
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(bars.full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + wg * 3 * BOX;
        reg_fence<96>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<192, 1>(acc,
                           desc_sw128(base + H_OFF + sl * BOX + 32 * kk, 16,
                                      1024),
                           desc_sw128(wb + 2048 * kk, BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<96>(acc);
        mbar_arrive(bars.empty(s));
      }
      arrive_both(bars.h_free(), peer);
    }

    // The LayerNorm backward. acc[4j + e] is dxn at row rw + 8 (e >= 2),
    // column col0 + 8j + (e & 1).
    const int col0 = COLS * rank + 192 * wg + 2 * quad;
    float s1a = 0.0f, s2a = 0.0f, s1b = 0.0f, s2b = 0.0f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = col0 + 8 * j;
      const float2 gp = load_pair(g, col);
      const float2 xa = ra < T_rows ? load_pair(x, ra * D + col) : make_float2(0.f, 0.f);
      const float2 xb = rb < T_rows ? load_pair(x, rb * D + col) : make_float2(0.f, 0.f);
      const float xa0 = (xa.x - sa.x) * sa.y, xa1 = (xa.y - sa.x) * sa.y;
      const float xb0 = (xb.x - sb.x) * sb.y, xb1 = (xb.y - sb.x) * sb.y;
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
    // both CTAs have read their h buffers for the last time: the row sums
    // of the four (CTA, warpgroup) sources meet there, in both CTAs
    mbar_wait_cluster(bars.h_free(), (chunks - 1) & 1);
    if (quad == 0) {
      const int src = 2 * rank + wg;
      const float v[4] = {s1a, s2a, s1b, s2b};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t off = red_offset(src, rw + 8 * (k / 2)) + 4 * (k % 2);
        *reinterpret_cast<float*>(sbase + off) = v[k];
        st_cluster_u32(mapa(base + off, peer), __float_as_uint(v[k]));
      }
    }
    arrive_both(bars.red(), peer);
    mbar_wait_cluster(bars.red(), 0);
    float m1a = 0.0f, m2a = 0.0f, m1b = 0.0f, m2b = 0.0f;
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const float* pa = reinterpret_cast<const float*>(sbase + red_offset(src, rw));
      const float* pb = reinterpret_cast<const float*>(sbase + red_offset(src, rw + 8));
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
    // rows, then over the warpgroup's 4 warps in the (now free) row tile:
    // colsum[wg][warp][column][dγ, dβ]
    float* colsum = reinterpret_cast<float*>(sbase + X_OFF);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = col0 + 8 * j;
      const float2 gp = load_pair(g, col);
      const float2 xa = ra < T_rows ? load_pair(x, ra * D + col) : make_float2(0.f, 0.f);
      const float2 xb = rb < T_rows ? load_pair(x, rb * D + col) : make_float2(0.f, 0.f);
      const float xa0 = (xa.x - sa.x) * sa.y, xa1 = (xa.y - sa.x) * sa.y;
      const float xb0 = (xb.x - sb.x) * sb.y, xb1 = (xb.y - sb.x) * sb.y;
      const float n0 = acc[4 * j], n1 = acc[4 * j + 1];
      const float n2 = acc[4 * j + 2], n3 = acc[4 * j + 3];
      if (ra < T_rows)
        store_pair(dx, ra * D + col, sa.y * (n0 * gp.x - m1a - xa0 * m2a),
                   sa.y * (n1 * gp.y - m1a - xa1 * m2a));
      if (rb < T_rows)
        store_pair(dx, rb * D + col, sb.y * (n2 * gp.x - m1b - xb0 * m2b),
                   sb.y * (n3 * gp.y - m1b - xb1 * m2b));
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

template <bool DROP>
cudaError_t launch(const void* x, const void* u, const void* dy, const void* g,
                   const void* bt, const void* w1t, const void* w2t, void* do_,
                   void* hd, void* du, void* xn, void* dx, void* dgp, void* dbp,
                   int T_rows, int H, float eps, Dropout drop, cudaStream_t s) {
  CUtensorMap mdy, mw2, mw1;
  cudaError_t err;
  if ((err = lafs_ln_mlp_sm90_host::map2d(&mdy, dy, D, T_rows, 64)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw2, w2t, H, D, SLAB)) != cudaSuccess ||
      (err = lafs_ln_mlp_sm90_host::map2d(&mw1, w1t, D, H, 64)) != cudaSuccess)
    return err;
  return lafs_ln_mlp_sm90_host::launch(
      ln_mlp_bwd_sm90<DROP>, SMEM, T_rows, s, mdy, mw2, mw1,
      static_cast<const bf16*>(x), static_cast<const bf16*>(u),
      static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
      static_cast<bf16*>(do_), static_cast<bf16*>(hd), static_cast<bf16*>(du),
      static_cast<bf16*>(xn), static_cast<bf16*>(dx), static_cast<float*>(dgp),
      static_cast<float*>(dbp), T_rows, H, eps, drop);
}

}  // namespace hop

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

// Rows of kernel 3's (rows, D) dγ/dβ partial buffers for T rows at these
// widths: one a 64-row cluster in the Hopper design (bf16, D = 768, H a
// multiple of 256), one a 32-row block in the first.
extern "C" int lafs_ln_mlp_bwd_partial_rows(int T_rows, int D, int H,
                                            int is_bf16) {
  if (T_rows <= 0) return 0;
  if (is_bf16 && lafs_ln_mlp_sm90::takes(D, H))
    return lafs_ln_mlp_sm90::clusters(T_rows);
  return (T_rows + ROWS - 1) / ROWS;
}

// Widths as kernel 2: D a multiple of 128 up to 768, H a multiple of 128
// (checked by the Python wrapper); D = 768 with H a multiple of 256 runs
// the Hopper design, which also needs x, dy, g and the weights 16-byte
// aligned (TMA, 16-byte loads). `drop` = 0 turns dropout off. dgp and dbp
// hold lafs_ln_mlp_bwd_partial_rows(T, D, H, 1) rows of D floats.
extern "C" int lafs_fused_ln_mlp_bwd_bf16(
    const void* x, const void* u, const void* dy, const void* g, const void* bt,
    const void* w1t, const void* w2t, void* do_, void* hd, void* du, void* xn,
    void* dx, void* dgp, void* dbp, int T_rows, int D, int H, float eps,
    unsigned seed, unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0) return cudaSuccess;
  if (H % HC) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(seed, thresh, inv_keep, drop, 128);
  if (lafs_ln_mlp_sm90::takes(D, H)) {
    auto run = drop ? hop::launch<true> : hop::launch<false>;
    return run(x, u, dy, g, bt, w1t, w2t, do_, hd, du, xn, dx, dgp, dbp,
               T_rows, H, eps, dr, s);
  }
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
