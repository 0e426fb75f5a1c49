// The Hopper designs of the MLP kernels in bf16 at D = 768 with H a
// multiple of 256.
//
// The forward, kernels 2 (fused_ln_mlp.cu) and 4 (fused_mlp.cu, the same
// body without the LayerNorm): namespace lafs_mlp_fwd below, one persistent
// launch that stages the normalised rows xn and the hidden activation h
// through device scratch that the wrapper hands it, so that both products
// run as 128-row wgmma tiles from a 4-stage ring. One CTA an SM (the grid
// an occupancy query); 384 threads: two consumer warpgroups that each own
// 64 rows of a tile, a producer warpgroup whose elected lane draws tiles
// and issues TMA. Every CTA draws tiles from one static order by an atomic
// ticket; a row block of 128 rows has three kinds of tile:
// - its LN tile (kernel 2): xn = bf16(LN(x)) into the xn scratch, x read
//   through the ring 32 rows a stage;
// - its hidden tiles, 128 rows by 256 hidden columns over K = 768: u =
//   xn·W1ᵀ + b1 (stored where u is saved), h = drop_0(gelu(u)) in bf16 into
//   the h scratch;
// - its output tiles, 128 rows by 256 output columns over K = H: y =
//   drop_1(h·W2ᵀ + b2).
// A tile waits only for tiles earlier in the order (flags in device memory,
// release and acquire), so no drawn tile waits on one that no running CTA
// holds. The order puts a row block's hidden tiles `lag` slots after its
// LN tile and its output tiles `lag` slots after those, a lag of about two
// grids' worth of tiles, so the rows advance as a wavefront and h is
// read back from L2 while ~12 MB of it is in flight.
//
// Why not the 64-row cluster form it replaced: that form held
// the whole (64, 768) fp32 output row in registers across the hidden loop
// and the xn tile in shared memory, which left two 48 KB ring stages and
// capped a CTA at 64 rows (64 FLOP a byte of weight slabs, one stage in
// flight, GELU and two cluster barriers between the products). At the
// served T = 25,216 it took 0.5277 ms against 0.3639 for the dense library
// form and its 0.1604 ms bound.
//
// What bounds the staged form: its tensor work is 0.642 ms at the served T
// = 100,864; its memory floor (x, y, xn and h written and read once) ~0.43
// ms at 3.35 TB/s if nothing stayed in L2. On the card it runs near half
// the tensor peak, most likely held by the stream of 48 KB slabs from L2
// (fused_ln_mlp.cu).
//
// The backward, kernel 3 (fused_ln_mlp_bwd.cu), keeps row 10's cluster
// form (mlp_fusion.cu): a 2-CTA cluster owns ROWS = 64 token rows, CTA r
// the output columns [384r, 384r + 384), the hidden layer walked in chunks
// of HC = 256 through the h buffers of both CTAs; its layout, barriers
// (Bars) and swizzled offsets are the constants below. Kernel 5
// (fused_mlp_bwd.cu) takes kernel 3's row tile, do prologue and
// element-wise pass (do_tile_in_place, load_u_pairs, hidden_pair) around
// one product without the cluster. Kernels 8 and 9 (fused_ln_linear*.cu)
// take the row tile, LayerNorm (ln_tile_in_place), layout helpers and
// launch.
#pragma once

#include <algorithm>

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

// LayerNorm of one row of 768 held by a warp, 24 values a lane (the 16-byte
// chunks lane, lane + 32, lane + 64), in place: fp32 two-pass statistics,
// then xhat * g + bt with g and bt as ln_params gives them.
__device__ __forceinline__ void ln_row(float (&f)[24], const float (&gv)[24],
                                       const float (&bv)[24], float eps) {
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
}

// The 24 values of a (768,) bf16 vector that lane `lane` applies in ln_row.
__device__ __forceinline__ void ln_params(const bf16* __restrict__ p, int lane,
                                          float (&v)[24]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    unpack8(__ldg(reinterpret_cast<const uint4*>(p) + lane + 32 * j),
            v + 8 * j);
}

// Normalises the (64, 768) x tile in place (kernel 8): warp w of the
// consumers takes rows w, w + 8, ...; lane l the 16-byte chunks l, l + 32,
// l + 64 of each (ln_row: fp32 two-pass statistics, xn rounded to bf16).
__device__ __forceinline__ void ln_tile_in_place(unsigned char* xs,
                                                 const bf16* __restrict__ g,
                                                 const bf16* __restrict__ bt,
                                                 float eps, int warp,
                                                 int lane) {
  float gv[24], bv[24];
  ln_params(g, lane, gv);
  ln_params(bt, lane, bv);
  for (int r = warp; r < ROWS; r += 8) {
    float f[24];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      unpack8(*reinterpret_cast<const uint4*>(xs + tile_offset(r, lane + 32 * j)),
              f + 8 * j);
    ln_row(f, gv, bv, eps);
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

// ---------------------------------------------------------------------
// The forward of kernels 2 (LN) and 4 (no LN): the persistent staged form
// of the header's note. Registers: 384 threads a launch get at most 168
// each; the producer warpgroup drops to 40 (setmaxnreg) so that the
// consumers rise to 232 for their 128 accumulator registers (a warpgroup's
// 64 x 256 fp32 tile). Its own namespace: kernel 4's symbol carries the
// Plan type's, and must not hold "ln_mlp_", which profiles read as kernels
// 2 and 3.
namespace lafs_mlp_fwd {

using namespace lafs_sm90;
using namespace lafs_ln_mlp_sm90;

constexpr int BM = 128;                   // token rows of a row block
constexpr int BN = 256;                   // columns of a product tile
constexpr int BK = 64;                    // K of a slab: one swizzle row
constexpr int STAGES = 4;                 // the ring
constexpr int A_BYTES = BM * BK * 2;      // 16 KB of xn, x or h
constexpr int B_BYTES = BN * BK * 2;      // 32 KB of w1t or w2t
constexpr int STAGE = A_BYTES + B_BYTES;  // 48 KB
constexpr int LN_ROWS = STAGE / (2 * D);  // rows of x a stage holds: 32
constexpr int LN_BOX = LN_ROWS * 128;     // one 64-column box of them
constexpr int OUT_TILES = D / BN;         // output tiles a row block: 3
constexpr int WARPS = CONSUMERS / 32;     // consumer warps
constexpr int BAR_OFF = STAGES * STAGE;
constexpr int SMEM = BAR_OFF + 128 + 1024;  // + alignment to 1024 bytes
constexpr int SCHED_WORDS = 4;  // epoch, CTAs done, next ticket, spare
static_assert(LN_ROWS * 2 * D == STAGE && BM % LN_ROWS == 0,
              "an LN stage holds whole rows of x");
static_assert(SMEM <= 232448, "one CTA an SM");

enum Kind : int { LN_TILE, HID_TILE, OUT_TILE, NO_TILE };

// The launch's tile order and its device-side state. The order is a
// sequence of slots of per_slot positions: slot s holds the LN tile of row
// block s (kernel 2), the hidden tiles of row block s - lag and the output
// tiles of row block s - 2 lag (kernel 4: hidden s, output s - lag); a
// position whose row block lies outside [0, blocks) is empty. `sched`
// holds SCHED_WORDS words and then, per row block, 1 + hid flags (its LN
// tile, then each hidden tile), each the epoch of the last launch that
// finished that tile. The words: the epoch of the last launch that ended,
// the CTAs of this launch that drew their last ticket, the next ticket.
// The last CTA to draw its last ticket resets the two counts and advances
// the epoch, so a buffer zeroed once serves every launch on its stream.
struct Plan {
  uint32_t* sched;
  int rows;      // T
  int H;
  int blocks;    // row blocks, ceil(T / BM)
  int hid;       // hidden tiles a row block, H / BN
  int lag;       // slots between a row block's kinds of tile
  int per_slot;  // (LN tile) + hid + OUT_TILES
  int tickets;   // positions of the order
};

__device__ __forceinline__ uint32_t* flag(const Plan& p, int rb, int k) {
  return p.sched + SCHED_WORDS + (long long)rb * (1 + p.hid) + k;
}

// The tile at position t as (kind, row block or -1 where empty, column
// tile, -).
template <bool LN>
__device__ __forceinline__ int4 decode(const Plan& p, int t) {
  const int slot = t / p.per_slot;
  int q = t - slot * p.per_slot, kind, rb, col = 0;
  if (LN && q == 0) {
    kind = LN_TILE;
    rb = slot;
  } else {
    q -= LN ? 1 : 0;
    const int first = LN ? p.lag : 0;
    if (q < p.hid) {
      kind = HID_TILE;
      rb = slot - first;
      col = q;
    } else {
      kind = OUT_TILE;
      rb = slot - first - p.lag;
      col = q - p.hid;
    }
  }
  return make_int4(kind, rb >= 0 && rb < p.blocks ? rb : -1, col, 0);
}

// The CTA's mbarriers and tile slots from `at`: the ring's full and empty
// stages, and two slots through which the producer hands the consumers
// the tiles it drew (the int4 of decode, the epoch in .w).
struct Bars {
  uint32_t at;
  __device__ explicit Bars(uint32_t a) : at(a) {}
  __device__ uint32_t full(int s) const { return at + 8 * s; }
  __device__ uint32_t empty(int s) const { return at + 32 + 8 * s; }
  __device__ uint32_t tile_full(int i) const { return at + 64 + 8 * i; }
  __device__ uint32_t tile_empty(int i) const { return at + 80 + 8 * i; }
  static constexpr int TILES_OFF = 96;

  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(tile_full(i), 1);
      mbar_init(tile_empty(i), WARPS);
    }
    fence_mbar_init();
  }
};

// A consumer warp is done with a stage or a tile slot: one arrival for its
// 32 threads.
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}
static_assert(STAGES == 4 && Bars::TILES_OFF + 32 <= 128, "the bars fit");

__device__ __forceinline__ void wait_flag(const uint32_t* f, uint32_t epoch) {
  while (ld_acquire_gpu(f) != epoch) __nanosleep(64);
}

// After the consumers' global writes of a tile: their barrier, then one
// release at GPU scope (CUTLASS's generic barrier does the same), so that
// a CTA that acquires the flag and then reads through TMA sees the writes.
__device__ __forceinline__ void publish(uint32_t* f, uint32_t epoch) {
  bar_sync(1, CONSUMERS);
  if (threadIdx.x == 0) {
    fence_proxy_async_all();
    __threadfence();
    st_release_gpu(f, epoch);
  }
}

// The producer's next stage: wait until the consumers freed it, announce
// a whole stage of TMA bytes; its shared address.
__device__ __forceinline__ uint32_t stage_begin(const Bars& bars,
                                                uint32_t base, int it) {
  const int s = it % STAGES;
  if (it >= STAGES) mbar_wait(bars.empty(s), (it / STAGES - 1) & 1);
  mbar_expect_tx(bars.full(s), STAGE);
  return base + s * STAGE;
}

// The producer's elected lane: draws tickets until the order ends, hands
// each tile to the consumers, waits for the tiles it reads, and streams
// its stages: an LN tile 4 stages of 32 rows of x (12 boxes of 64 x 32), a
// product tile a stage a 64-deep slab (the 128 x 64 box of its A, xn, x or
// h, and the 256 x 64 box of its B, w1t or w2t; both K-major).
template <bool LN>
__device__ __forceinline__ void produce(uint32_t base, const Bars& bars,
                                        int4* tiles, const CUtensorMap* mx,
                                        const CUtensorMap* ma,
                                        const CUtensorMap* mw1,
                                        const CUtensorMap* mh,
                                        const CUtensorMap* mw2,
                                        const Plan& p) {
  const uint32_t epoch = *reinterpret_cast<volatile uint32_t*>(p.sched) + 1;
  int it = 0;
  for (int n = 0;; ++n) {
    int4 tile;
    do {
      const int t = atomicAdd(reinterpret_cast<int*>(p.sched + 2), 1);
      tile = t < p.tickets ? decode<LN>(p, t) : make_int4(NO_TILE, 0, 0, 0);
    } while (tile.y < 0);
    tile.w = (int)epoch;
    const int slot = n & 1;
    if (n >= 2) mbar_wait(bars.tile_empty(slot), ((n >> 1) - 1) & 1);
    tiles[slot] = tile;
    mbar_arrive(bars.tile_full(slot));
    if (tile.x == NO_TILE) break;
    const int rb = tile.y;
    if (LN && tile.x == HID_TILE) wait_flag(flag(p, rb, 0), epoch);
    if (tile.x == OUT_TILE)
      for (int j = 0; j < p.hid; ++j) wait_flag(flag(p, rb, 1 + j), epoch);
    fence_proxy_async_all();  // generic writes of other CTAs, read by TMA
    if (tile.x == LN_TILE) {
      for (int sub = 0; sub < BM / LN_ROWS; ++sub, ++it) {
        const uint32_t st = stage_begin(bars, base, it);
        for (int bx = 0; bx < D / 64; ++bx)
          tma_load_2d(st + bx * LN_BOX, mx, bars.full(it % STAGES), 64 * bx,
                      rb * BM + sub * LN_ROWS);
      }
    } else {
      const bool hid = tile.x == HID_TILE;
      const CUtensorMap* mA = hid ? ma : mh;
      const CUtensorMap* mB = hid ? mw1 : mw2;
      const int slabs = (hid ? D : p.H) / BK;
      for (int k = 0; k < slabs; ++k, ++it) {
        const uint32_t st = stage_begin(bars, base, it);
        tma_load_2d(st, mA, bars.full(it % STAGES), BK * k, rb * BM);
        tma_load_2d(st + A_BYTES, mB, bars.full(it % STAGES), BK * k,
                    tile.z * BN);
      }
    }
  }
  __threadfence();  // this CTA's tickets before its count
  if (atomicAdd(p.sched + 1, 1u) == gridDim.x - 1) {
    __threadfence();
    p.sched[2] = 0;
    p.sched[1] = 0;
    p.sched[0] = epoch;
  }
}

// An LN tile on the consumers: each stage's 32 rows of x, warp w its rows
// w, w + 8, ...; xn = bf16(LN(x)) stored 16 bytes a lane (512 contiguous
// bytes a warp) into the xn scratch, whose rows are padded to BM.
__device__ __forceinline__ void ln_block(const unsigned char* sbase,
                                         const Bars& bars, int& it,
                                         const bf16* __restrict__ g,
                                         const bf16* __restrict__ bt,
                                         bf16* __restrict__ xn, int rb,
                                         float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int sub = 0; sub < BM / LN_ROWS; ++sub, ++it) {
    const int s = it % STAGES;
    mbar_wait(bars.full(s), (it / STAGES) & 1);
    const unsigned char* xs = sbase + s * STAGE;
    for (int r = warp; r < LN_ROWS; r += WARPS) {
      float f[24], gv[24], bv[24];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = lane + 32 * j;
        unpack8(*reinterpret_cast<const uint4*>(
                    xs + (c >> 3) * LN_BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4)),
                f + 8 * j);
      }
      ln_params(g, lane, gv);
      ln_params(bt, lane, bv);
      ln_row(f, gv, bv, eps);
      uint4* dst = reinterpret_cast<uint4*>(
          xn + ((long long)rb * BM + sub * LN_ROWS + r) * D);
#pragma unroll
      for (int j = 0; j < 3; ++j) dst[lane + 32 * j] = pack8(f + 8 * j);
    }
    warp_arrive(bars.empty(s), lane);
  }
}

// The epilogues take 8 accumulator registers at a time: the hash keys and
// the first column pass through this point, so that no column's bias load
// or dropout hash is computed ahead of its group, which would hold
// registers beside the 128 of the accumulator.
__device__ __forceinline__ void group_fence(uint32_t& ka, uint32_t& kb,
                                            int& col0) {
  asm volatile("" : "+r"(ka), "+r"(kb), "+r"(col0)::"memory");
}

// The hidden tile's epilogue: u = acc + b1 (stored where saved, rows below
// T), h = drop_0(gelu(u)) in bf16 into the h scratch. The thread holds rows
// ra and ra + 8, columns h0 + 8j + 2 quad + [0, 2) (sm90.cuh's layout).
template <bool DROP, bool SAVE_U>
__device__ __forceinline__ void hidden_epilogue(
    const float (&acc)[128], const bf16* __restrict__ b1,
    bf16* __restrict__ u_out, bf16* __restrict__ hs, long long ra, int quad,
    int h0, const Plan& p, const Dropout& drop) {
  uint32_t ka = DROP ? drop.row_key32((uint32_t)ra, 0) : 0u;
  uint32_t kb = DROP ? drop.row_key32((uint32_t)ra + 8, 0) : 0u;
  int col0 = h0 + 2 * quad;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    if (i % 8 == 0) group_fence(ka, kb, col0);
    const bool second = (i >> 1) & 1;
    const long long row = second ? ra + 8 : ra;
    const int col = col0 + 8 * (i / 4);
    const float2 bias = load_pair(b1, col);
    const float u0 = acc[i] + bias.x, u1 = acc[i + 1] + bias.y;
    if (SAVE_U && row < p.rows) store_pair(u_out, row * p.H + col, u0, u1);
    float e0, e1;
    float v0 = u0 * phi_as(u0, &e0), v1 = u1 * phi_as(u1, &e1);
    if (DROP) {
      const uint32_t rk = second ? kb : ka;
      v0 = drop.keep_col(rk, col) ? v0 * drop.inv_keep : 0.0f;
      v1 = drop.keep_col(rk, col + 1) ? v1 * drop.inv_keep : 0.0f;
    }
    store_pair(hs, row * p.H + col, v0, v1);
  }
}

// The output tile's epilogue: y = drop_1(acc + b2) in bf16, rows below T.
template <bool DROP>
__device__ __forceinline__ void output_epilogue(
    const float (&acc)[128], const bf16* __restrict__ b2,
    bf16* __restrict__ y, long long ra, int quad, int n0, const Plan& p,
    const Dropout& drop) {
  uint32_t ka = DROP ? drop.row_key32((uint32_t)ra, 1) : 0u;
  uint32_t kb = DROP ? drop.row_key32((uint32_t)ra + 8, 1) : 0u;
  int col0 = n0 + 2 * quad;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    if (i % 8 == 0) group_fence(ka, kb, col0);
    const bool second = (i >> 1) & 1;
    const long long row = second ? ra + 8 : ra;
    const int col = col0 + 8 * (i / 4);
    if (row < p.rows) {
      const float2 bias = load_pair(b2, col);
      float v0 = acc[i] + bias.x, v1 = acc[i + 1] + bias.y;
      if (DROP) {
        const uint32_t rk = second ? kb : ka;
        v0 = drop.keep_col(rk, col) ? v0 * drop.inv_keep : 0.0f;
        v1 = drop.keep_col(rk, col + 1) ? v1 * drop.inv_keep : 0.0f;
      }
      store_pair(y, row * D + col, v0, v1);
    }
  }
}

// The consumer warpgroups: warpgroup wg the rows 64 wg .. 64 wg + 63 of
// every product tile, one m64n256k16 wgmma a 16-deep slice, one commit
// group a slab, the previous slab's stage freed once its group is done
// (wgmma_wait<1>), so that issue and completion overlap.
template <bool LN, bool DROP, bool SAVE_U>
__device__ __forceinline__ void consume(
    uint32_t base, const unsigned char* sbase, const Bars& bars,
    const int4* tiles, const bf16* __restrict__ g,
    const bf16* __restrict__ bt, const bf16* __restrict__ b1,
    const bf16* __restrict__ b2, bf16* __restrict__ y,
    bf16* __restrict__ u_out, bf16* __restrict__ xn, bf16* __restrict__ hs,
    float eps, const Dropout& drop, const Plan& p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, quad = lane % 4;
  const int rw = 64 * wg + 16 * (warp % 4) + lane / 4;
  float acc[128];
  int it = 0;
  for (int n = 0;; ++n) {
    const int slot = n & 1;
    mbar_wait(bars.tile_full(slot), (n >> 1) & 1);
    const int4 tile = tiles[slot];
    warp_arrive(bars.tile_empty(slot), lane);
    if (tile.x == NO_TILE) break;
    const int rb = tile.y;
    if (LN && tile.x == LN_TILE) {
      ln_block(sbase, bars, it, g, bt, xn, rb, eps);
      publish(flag(p, rb, 0), (uint32_t)tile.w);
      continue;
    }
    const int slabs = (tile.x == HID_TILE ? D : p.H) / BK;
    for (int k = 0; k < slabs; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars.full(s), (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE + wg * (A_BYTES / 2);
      const uint32_t b = base + s * STAGE + A_BYTES;
      reg_fence<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<256, 0>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                         desc_sw128(b + 32 * kk, 16, 1024), k > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (k > 0) warp_arrive(bars.empty((it - 1) % STAGES), lane);
    }
    wgmma_wait<0>();
    reg_fence<128>(acc);
    warp_arrive(bars.empty((it - 1) % STAGES), lane);
    const long long ra = (long long)rb * BM + rw;
    if (tile.x == HID_TILE) {
      hidden_epilogue<DROP, SAVE_U>(acc, b1, u_out, hs, ra, quad, tile.z * BN,
                                    p, drop);
      publish(flag(p, rb, 1 + tile.z), (uint32_t)tile.w);
    } else {
      output_epilogue<DROP>(acc, b2, y, ra, quad, tile.z * BN, p, drop);
    }
  }
}

// One CTA of the launch; its __global__ wrappers (ln_mlp_fwd_sm90,
// mlp_fwd_sm90) carry the launch bounds and pass their dynamic shared
// memory and the tensor maps' addresses: mx over x (boxes of LN_ROWS rows
// for kernel 2's LN tiles, of BM rows for kernel 4's hidden tiles), ma the
// hidden tiles' A (xn's map for kernel 2, mx for kernel 4), mw1 and mw2
// boxes of BN rows, mh over h. Kernel 4 passes null g, bt and xn.
template <bool LN, bool DROP, bool SAVE_U>
__device__ __forceinline__ void run(
    unsigned char* smem_raw, const CUtensorMap* mx, const CUtensorMap* ma,
    const CUtensorMap* mw1, const CUtensorMap* mh, const CUtensorMap* mw2,
    const bf16* __restrict__ g, const bf16* __restrict__ bt,
    const bf16* __restrict__ b1, const bf16* __restrict__ b2,
    bf16* __restrict__ y, bf16* __restrict__ u_out, bf16* __restrict__ xn,
    bf16* __restrict__ hs, float eps, const Dropout& drop, const Plan& p) {
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const Bars bars(base + BAR_OFF);
  int4* tiles = reinterpret_cast<int4*>(sbase + BAR_OFF + Bars::TILES_OFF);
  if (threadIdx.x == CONSUMERS) bars.init();
  __syncthreads();
  // one if-else for the kernel's rest: setmaxnreg needs the two paths apart
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS)
      produce<LN>(base, bars, tiles, mx, ma, mw1, mh, mw2, p);
  } else {
    setmaxnreg_inc<232>();
    consume<LN, DROP, SAVE_U>(base, sbase, bars, tiles, g, bt, b1, b2, y,
                              u_out, xn, hs, eps, drop, p);
  }
}

}  // namespace lafs_mlp_fwd

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

// Kernels 2 and 4: the tensor maps, the plan and one persistent launch of
// `kernel` (an instance of ln_mlp_fwd_sm90 or mlp_fwd_sm90) over the CTAs
// the card keeps resident (an occupancy query, once a device and
// instance), or fewer where the launch has fewer tiles. The scratch comes
// from the caller: xn (LN only) and h of ceil(T / BM) · BM rows, and
// `sched`, SCHED_WORDS + ceil(T / BM) · (1 + H / BN) 32-bit words zeroed
// once before the stream's first launch (the kernel keeps them in step).
template <bool LN, typename... P>
cudaError_t launch_fwd(void (*kernel)(P...), const void* x, const void* g,
                       const void* bt, const void* w1t, const void* b1,
                       const void* w2t, const void* b2, void* y, void* u,
                       void* xn, void* hs, void* sched, int T_rows, int H,
                       float eps, lafs_mlp::Dropout drop, cudaStream_t s) {
  namespace F = lafs_mlp_fwd;
  using lafs_ln_mlp_sm90::D;
  using lafs_mlp::bf16;
  const int blocks = (T_rows + F::BM - 1) / F::BM;
  CUtensorMap mx, mxn, mw1, mh, mw2;
  cudaError_t err;
  if ((err = map2d(&mx, x, D, T_rows, LN ? F::LN_ROWS : F::BM)) !=
          cudaSuccess ||
      (LN && (err = map2d(&mxn, xn, D, blocks * F::BM, F::BM)) !=
                 cudaSuccess) ||
      (err = map2d(&mw1, w1t, D, H, F::BN)) != cudaSuccess ||
      (err = map2d(&mh, hs, H, blocks * F::BM, F::BM)) != cudaSuccess ||
      (err = map2d(&mw2, w2t, H, D, F::BN)) != cudaSuccess)
    return err;
  if (!LN) mxn = mx;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM)) !=
      cudaSuccess)
    return err;
  static int resident[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, lafs_ln_mlp_sm90::THREADS, F::SMEM)) !=
            cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  F::Plan p;
  p.sched = static_cast<uint32_t*>(sched);
  p.rows = T_rows;
  p.H = H;
  p.blocks = blocks;
  p.hid = H / F::BN;
  p.per_slot = (LN ? 1 : 0) + p.hid + F::OUT_TILES;
  const int grid = std::min(resident[dev], blocks * p.per_slot);
  // about two grids' worth of tiles between a row block's kinds of tile
  p.lag = (2 * grid + p.per_slot - 1) / p.per_slot + 1;
  p.tickets = (blocks + (LN ? 2 : 1) * p.lag) * p.per_slot;
  kernel<<<grid, lafs_ln_mlp_sm90::THREADS, F::SMEM, s>>>(
      mx, mxn, mw1, mh, mw2, static_cast<const bf16*>(g),
      static_cast<const bf16*>(bt), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y),
      static_cast<bf16*>(u), static_cast<bf16*>(xn), static_cast<bf16*>(hs),
      eps, drop, p);
  return cudaGetLastError();
}

}  // namespace lafs_ln_mlp_sm90_host
