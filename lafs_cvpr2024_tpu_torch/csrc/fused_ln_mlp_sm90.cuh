// The Hopper design shared by kernels 2 (fused_ln_mlp.cu) and 3
// (fused_ln_mlp_bwd.cu) in bf16 at D = 768 with H a multiple of 256: row
// 10's cluster form (mlp_fusion.cu) on sm90.cuh. Kernels 8 and 9
// (fused_ln_linear*.cu) take its row tile, LayerNorm, layout helpers and
// launch.
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

}  // namespace lafs_ln_mlp_sm90_host
