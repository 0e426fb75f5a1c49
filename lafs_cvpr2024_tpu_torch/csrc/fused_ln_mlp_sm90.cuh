// The Hopper design shared by kernels 2 (fused_ln_mlp.cu) and 3
// (fused_ln_mlp_bwd.cu) in bf16 at D = 768 with H a multiple of 256: row
// 10's cluster form (mlp_fusion.cu) on sm90.cuh. Kernel 4 (fused_mlp.cu)
// is kernel 2's body without the LayerNorm (mlp_fwd_cta<LN = false>);
// kernel 5 (fused_mlp_bwd.cu) takes kernel 3's row tile, do prologue and
// element-wise pass (do_tile_in_place, load_u_pairs, hidden_pair) around
// one product without the cluster. Kernels 8 and 9 (fused_ln_linear*.cu)
// take its row tile, LayerNorm, layout helpers and launch.
//
// A cluster of 2 CTAs owns ROWS = 64 token rows; CTA r owns the output
// columns [384r, 384r + 384). Each CTA has two consumer warpgroups, each
// holding a (64, 192) fp32 accumulator for the whole hidden loop, and one
// producer warpgroup whose elected lane TMA-loads a (64, 768) row tile once
// and streams weight slabs through a ring of 2 stages of 48 KB. The hidden
// layer is walked in chunks of HC = 256: CTA r computes the chunk's columns
// [128r, 128r + 128) of the first product (warpgroup g 64 of them), applies
// the element-wise pass in registers and writes the bf16 result into its own
// and its peer's h buffer (distributed shared memory); then both CTAs
// accumulate the second product over the whole chunk. Shared memory: the
// row tile 96 KB + h 32 KB + ring 96 KB = 224 KB a CTA, one CTA an SM.
#pragma once

#include "fused_ln_mlp_common.cuh"
#include "sm90.cuh"

namespace lafs_ln_mlp_sm90 {

using namespace lafs_sm90;
using lafs_mlp::bf16;
using lafs_mlp::Dropout;

constexpr int D = 768;         // model width of the design
constexpr int ROWS = 64;       // token rows of a cluster
constexpr int HC = 256;        // hidden chunk of the cluster
constexpr int COLS = D / 2;    // output columns of a CTA
constexpr int THREADS = 384;   // two consumer warpgroups and a producer one
constexpr int CONSUMERS = 256;
constexpr int BOX = 64 * 64 * 2;               // one 64 x 64 bf16 box
constexpr int SLAB = 192;                      // K of a first-product slab
constexpr int STAGE = 2 * SLAB * 128;          // two warpgroups' slabs: 48 KB
constexpr int X_OFF = 0;                       // the row tile: D / 64 boxes
constexpr int H_OFF = X_OFF + (D / 64) * BOX;  // h: HC / 64 boxes
constexpr int R_OFF = H_OFF + (HC / 64) * BOX; // the ring: 2 stages
constexpr int BAR_OFF = R_OFF + 2 * STAGE;
constexpr int SMEM = BAR_OFF + 64 + 1024;      // + alignment to 1024 bytes
static_assert(STAGE == (COLS / 64) * BOX, "a stage holds six 64 x 64 boxes");
static_assert(4 * ROWS * 2 * 4 <= (HC / 64) * BOX, "row sums fit in h");

// Whether the design takes these widths (bf16 is the caller's choice):
// kernels 2 and 3 at hidden width H, kernels 8 and 9 at output width O (a
// multiple of 8: 16-byte rows of dy for TMA).
inline bool takes(int Dm, int H) { return Dm == D && H > 0 && H % HC == 0; }
inline bool takes_linear(int Dm, int O) {
  return Dm == D && O > 0 && O % 8 == 0;
}

inline int clusters(int T_rows) { return (T_rows + ROWS - 1) / ROWS; }

// The CTA's mbarriers, 8 bytes each from `at`: the row tile, the ring's
// full and empty stages, the h buffers' full and free phases (both CTAs'
// consumers arrive on each CTA's) and the row sums of kernel 3's LayerNorm
// backward (the same).
struct Bars {
  uint32_t at;
  __device__ explicit Bars(uint32_t a) : at(a) {}
  __device__ uint32_t x_full() const { return at; }
  __device__ uint32_t full(int s) const { return at + 8 + 8 * s; }
  __device__ uint32_t empty(int s) const { return at + 24 + 8 * s; }
  __device__ uint32_t h_full() const { return at + 40; }
  __device__ uint32_t h_free() const { return at + 48; }
  __device__ uint32_t red() const { return at + 56; }

  __device__ void init() const {
    mbar_init(x_full(), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(h_full(), 2 * CONSUMERS);
    mbar_init(h_free(), 2 * CONSUMERS);
    mbar_init(red(), 2 * CONSUMERS);
    fence_mbar_init();
  }
};

// One arrival of this thread on a barrier of both CTAs of the pair.
__device__ __forceinline__ void arrive_both(uint32_t bar, uint32_t peer) {
  mbar_arrive_cluster(bar);
  mbar_arrive_remote(mapa(bar, peer));
}

// Byte offset in the h buffer of the bf16 pair at (row, 8 j8 + 2 quad) of
// box hbox (64 chunk columns), in the TMA layout (128-byte swizzle).
__device__ __forceinline__ uint32_t h_offset(int hbox, int row, int j8,
                                             int quad) {
  return hbox * BOX + row * 128 + ((j8 ^ (row % 8)) * 16) + 4 * quad;
}

// Byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r of a
// (64, 768) row tile: box c / 8, row r, chunk (c % 8) XOR (r % 8).
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 3) * BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo_f32(v[i]);
    f[2 * i + 1] = hi_f32(v[i]);
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Normalises the (64, 768) x tile in place (kernels 2 and 8): warp w of the
// consumers takes rows w, w + 8, ...; lane l the 16-byte chunks l, l + 32,
// l + 64 of each (fp32 two-pass statistics, xn rounded to bf16).
__device__ __forceinline__ void ln_tile_in_place(unsigned char* xs,
                                                 const bf16* __restrict__ g,
                                                 const bf16* __restrict__ bt,
                                                 float eps, int warp,
                                                 int lane) {
  float gv[24], bv[24];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = lane + 32 * j;
    unpack8(__ldg(reinterpret_cast<const uint4*>(g) + c), gv + 8 * j);
    unpack8(__ldg(reinterpret_cast<const uint4*>(bt) + c), bv + 8 * j);
  }
  for (int r = warp; r < ROWS; r += 8) {
    float f[24];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      unpack8(*reinterpret_cast<const uint4*>(xs + tile_offset(r, lane + 32 * j)),
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
#pragma unroll
    for (int k = 0; k < 24; ++k) f[k] = (f[k] - mean) * rstd * gv[k] + bv[k];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint4*>(xs + tile_offset(r, lane + 32 * j)) =
          pack8(f + 8 * j);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bf16 pair at element `e` (even) of a row-major bf16 array, as floats.
__device__ __forceinline__ float2 load_pair(const bf16* p, long long e) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p + e));
  return make_float2(lo_f32(w), hi_f32(w));
}

__device__ __forceinline__ void store_pair(bf16* p, long long e, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p + e) = pack_bf16(a, b);
}

// Phi(u), the standard normal CDF, with erf by A&S 7.1.26 (|err| <=
// 1.5e-7, the TPU kernel's _phi), and *e = exp(-u^2 / 2), which phi(u) in
// GELU' shares: one exp and one reciprocal where erff and expf took
// several times the instructions. With each row's hash key folded once
// (Dropout::row_key), it ran kernel 5 1.3x and kernel 4 1.2x faster
// (PERF.md §6). Below bf16's resolution either way.
__device__ __forceinline__ float phi_as(float u, float* e) {
  const float a = fabsf(u) * 0.70710678118654752f;
  *e = __expf(-a * a);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return 0.5f * (1.0f + copysignf(1.0f - poly * *e, u));
}

// The forward of kernels 2 (LN) and 4 (no LN), one CTA of a 2-CTA cluster
// owning 64 rows; its __global__ wrappers (ln_mlp_fwd_sm90, mlp_fwd_sm90)
// carry the cluster shape and launch bounds, and pass their dynamic shared
// memory and the tensor maps' addresses. Without the LayerNorm the
// consumers go from the row tile's arrival straight to the first wgmma: g,
// bt and eps are not read, and no generic-proxy write touches the tile.
// Registers: 384 threads a launch get at most 168 each; the producer
// warpgroup drops to 40 (setmaxnreg) so that the consumers rise to 232 for
// their 96 + 32 accumulator registers.
template <bool LN, bool DROP, bool SAVE_U>
__device__ __forceinline__ void mlp_fwd_cta(
    unsigned char* smem_raw, const CUtensorMap* mx, const CUtensorMap* mw1,
    const CUtensorMap* mw2, const bf16* __restrict__ g,
    const bf16* __restrict__ bt, const bf16* __restrict__ b1,
    const bf16* __restrict__ b2, bf16* __restrict__ y,
    bf16* __restrict__ u_out, int T_rows, int H, float eps,
    const Dropout& drop) {
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
        tma_load_2d(base + X_OFF + kb * BOX, mx, bars.x_full(), 64 * kb,
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
                tma_load_2d(st + wg * (STAGE / 2) + bx * BOX, mw1,
                            bars.full(s), SLAB * sl + 64 * bx,
                            h0 + 128 * rank + 64 * wg);
          } else {  // w2t[384 rank + 192 g : +192, h0 + 64 (sl - 4) : +64]
            for (int wg = 0; wg < 2; ++wg)
              tma_load_2d(st + wg * (STAGE / 2), mw2, bars.full(s),
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
    const long long ra = (long long)row0 + rw, rb = ra + 8;
    const uint32_t k0a = drop.row_key(ra, 0), k0b = drop.row_key(rb, 0);
    mbar_wait(bars.x_full(), 0);
    if constexpr (LN) {
      ln_tile_in_place(sbase + X_OFF, g, bt, eps, warp, lane);
      fence_proxy_async();  // xn, written here, is read by the wgmmas
      bar_sync(1, CONSUMERS);
    }
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    int it = 0;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = c * HC;
      const int hbox = 2 * rank + wg;  // this warpgroup's 64 chunk columns
      // u = x @ W1ᵀ[:, h0 + 64 hbox : +64], K = 768 in 4 slabs (x is xn
      // with the LayerNorm)
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
        float e0, e1;
        float v0 = u0 * phi_as(u0, &e0), v1 = u1 * phi_as(u1, &e1);
        if (DROP) {
          const uint32_t rk = ((i >> 1) & 1) ? k0b : k0a;
          v0 = drop.keep_col(rk, col) ? v0 * drop.inv_keep : 0.0f;
          v1 = drop.keep_col(rk, col + 1) ? v1 * drop.inv_keep : 0.0f;
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
    const uint32_t k1a = drop.row_key(ra, 1), k1b = drop.row_key(rb, 1);
#pragma unroll
    for (int i = 0; i < 96; i += 2) {
      const long long row = (long long)row0 + rw + 8 * ((i >> 1) & 1);
      const int col = COLS * rank + 192 * wg + 8 * (i / 4) + 2 * quad;
      if (row < T_rows) {
        const float2 bias = load_pair(b2, col);
        float v0 = acc[i] + bias.x, v1 = acc[i + 1] + bias.y;
        if (DROP) {
          const uint32_t rk = ((i >> 1) & 1) ? k1b : k1a;
          v0 = drop.keep_col(rk, col) ? v0 * drop.inv_keep : 0.0f;
          v1 = drop.keep_col(rk, col + 1) ? v1 * drop.inv_keep : 0.0f;
        }
        store_pair(y, row * D + col, v0, v1);
      }
    }
    __syncwarp();
    cluster_sync();
  }
}

// The backward prologue of kernels 3 and 5: do = drop_1(dy) in place in
// the (64, 768) row tile that TMA filled (rows at or past T are zeros), all
// 768 columns (the A operand of do·W2), and the 16-byte chunks [c_lo, c_hi)
// of each row below T stored to do_; then the proxy fence and the
// consumers' barrier before the first wgmma reads the tile.
template <bool DROP>
__device__ __forceinline__ void do_tile_in_place(unsigned char* xs,
                                                 bf16* __restrict__ do_,
                                                 int row0, int T_rows,
                                                 const Dropout& drop,
                                                 int c_lo, int c_hi) {
  for (int e = threadIdx.x; e < ROWS * (D / 8); e += CONSUMERS) {
    const int r = e / (D / 8), c = e % (D / 8);
    const long long row = (long long)row0 + r;
    uint4* p = reinterpret_cast<uint4*>(xs + tile_offset(r, c));
    uint4 w = *p;
    if (DROP) {
      float f[8];
      unpack8(w, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = drop.apply(f[k], row, 8 * c + k, 1);
      w = pack8(f);
      *p = w;
    }
    if (row < T_rows && c >= c_lo && c < c_hi)
      reinterpret_cast<uint4*>(do_ + row * D)[c] = w;
  }
  fence_proxy_async();  // do, written here, is read by the wgmmas
  bar_sync(1, CONSUMERS);
}

// The thread's Q bf16 pairs of u (T, H) for an accumulator of Q / 2
// 8-column groups: pair q at row ra (q even) or rb (q odd), columns col0 +
// 8 (q >> 1) + [0, 2) (col0 includes 2 quad); rows at or past T read 0.
// Loaded ahead of the product, so that their latency hides under it.
template <int Q>
__device__ __forceinline__ void load_u_pairs(const bf16* __restrict__ u,
                                             long long ra, long long rb,
                                             int T_rows, int H, int col0,
                                             uint32_t (&uw)[Q]) {
  // two row pointers, the pairs at immediate offsets from them
  const unsigned int* pa = reinterpret_cast<const unsigned int*>(
      u + (ra < T_rows ? ra : 0) * H + col0);
  const unsigned int* pb = reinterpret_cast<const unsigned int*>(
      u + (rb < T_rows ? rb : 0) * H + col0);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const bool ok = ((q & 1) ? rb : ra) < T_rows;
    uw[q] = ok ? __ldg(((q & 1) ? pb : pa) + 4 * (q >> 1)) : 0u;
  }
}

// The element-wise pass of kernels 3 and 5 on one bf16 pair of u (columns
// col, col + 1 of a row whose draw-0 key is rk, Dropout::row_key) and its
// fp32 dhd pair: hd = drop_0(gelu(u)) and du = drop_0(dhd) gelu'(u),
// returned as bf16 pairs (.x hd, .y du).
template <bool DROP>
__device__ __forceinline__ uint2 hidden_pair(uint32_t uw, float d0, float d1,
                                             uint32_t rk, int col,
                                             const Dropout& drop) {
  const float u0 = lo_f32(uw), u1 = hi_f32(uw);
  float e0, e1;
  const float p0 = phi_as(u0, &e0), p1 = phi_as(u1, &e1);
  float h0v = u0 * p0, h1v = u1 * p1;
  if (DROP) {
    const bool k0 = drop.keep_col(rk, col), k1 = drop.keep_col(rk, col + 1);
    h0v = k0 ? h0v * drop.inv_keep : 0.0f;
    h1v = k1 ? h1v * drop.inv_keep : 0.0f;
    d0 = k0 ? d0 * drop.inv_keep : 0.0f;
    d1 = k1 ? d1 * drop.inv_keep : 0.0f;
  }
  d0 *= p0 + u0 * e0 * 0.39894228040143268f;  // gelu'(u) = Phi + u phi
  d1 *= p1 + u1 * e1 * 0.39894228040143268f;
  return make_uint2(pack_bf16(h0v, h1v), pack_bf16(d0, d1));
}

}  // namespace lafs_ln_mlp_sm90

namespace lafs_ln_mlp_sm90_host {

// A 2-D bf16 map over a row-major (rows, cols) array, boxes of 64 columns
// (128 bytes, one swizzle row) by `box_rows` rows.
inline cudaError_t map2d(CUtensorMap* m, const void* p, int cols, int rows,
                         int box_rows) {
  const unsigned long long dims[2] = {(unsigned long long)cols,
                                      (unsigned long long)rows};
  const unsigned long long strides[1] = {2ull * cols};
  const unsigned box[2] = {64u, (unsigned)box_rows};
  return lafs_sm90_host::make_map(m, p, 2, dims, strides, box);
}

// One launch of a 2-CTA-cluster kernel with `smem` bytes of dynamic shared
// memory a CTA over ceil(T / 64) clusters.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int smem, int T_rows, cudaStream_t s,
                   A... args) {
  using namespace lafs_ln_mlp_sm90;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<2 * clusters(T_rows), THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

// Kernels 2 and 4: the maps of x, w1t and w2t and one launch of `kernel`
// (an instance of ln_mlp_fwd_sm90 or mlp_fwd_sm90; kernel 4 takes null g
// and bt, which it does not read).
template <typename... P>
cudaError_t launch_fwd(void (*kernel)(P...), const void* x, const void* g,
                       const void* bt, const void* w1t, const void* b1,
                       const void* w2t, const void* b2, void* y, void* u,
                       int T_rows, int H, float eps, lafs_mlp::Dropout drop,
                       cudaStream_t s) {
  using namespace lafs_ln_mlp_sm90;
  using lafs_mlp::bf16;
  CUtensorMap mx, mw1, mw2;
  cudaError_t err;
  if ((err = map2d(&mx, x, D, T_rows, 64)) != cudaSuccess ||
      (err = map2d(&mw1, w1t, D, H, 64)) != cudaSuccess ||
      (err = map2d(&mw2, w2t, H, D, SLAB)) != cudaSuccess)
    return err;
  return launch(kernel, SMEM, T_rows, s, mx, mw1, mw2,
                static_cast<const bf16*>(g), static_cast<const bf16*>(bt),
                static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
                static_cast<bf16*>(y), static_cast<bf16*>(u), T_rows, H, eps,
                drop);
}

}  // namespace lafs_ln_mlp_sm90_host
