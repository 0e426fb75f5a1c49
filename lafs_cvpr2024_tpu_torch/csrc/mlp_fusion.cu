// Bias-free fused transformer MLP forward with dropout, bf16 in and out
// (row 10 of the port's kernel table).
//
// Replaces the Pallas TPU kernel benchmarks/bench_mlp_fusion.py (_mlp_kernel,
// called from pallas_mlp):
//     h = drop_0(gelu(x @ W1))   fp32 accumulate, exact GELU, dropout in fp32
//     y = drop_1(bf16(h) @ W2)   fp32 accumulate, dropout in fp32, bf16 out
// for x (T, 768) and the JAX layout of the weights, input by output: W1 is
// (768, H) and W2 is (H, 768), both row-major bf16, read in place. No
// biases, no saved pre-activation. Kept elements are scaled by the fp32
// 1/keep (the TPU kernel divides by keep: at most one fp32 ulp apart,
// before the bf16 casts).
//
// GELU is erff's exact form (gelu() of fused_ln_mlp_common.cuh); the TPU
// kernel uses the Abramowitz-Stegun rational erf (|error| <= 1.5e-7), since
// Mosaic has no erf. Both are below bf16's resolution.
//
// Dropout bits. No GPU reproduces the TPU's hardware PRNG
// (pltpu.prng_seed(seed + program_id)). The kernel and its plain PyTorch
// version (ops/mlp_fusion.py) draw the same bits from the port's counter
// hash (Dropout, fused_ln_mlp_common.cuh), keyed by the seed, the TPU
// kernel's 256-row token tile, the draw (0 for h, 1 for y), the row in the
// tile and the column; the keep threshold is the TPU kernel's 32-bit
// round(keep * 2^32). Each thread keys the hash from the (row, column) of
// the accumulator elements it holds.
//
// What bounds it on the card. At the microbenchmark's shape (T = 22,080,
// D = 768, H = 2048) the two products are 139 GFLOP against ~74 MB of
// compulsory traffic: 0.14 ms of the bf16 tensor-core peak, bound by
// operations. A 64-row wgmma tile of the (64, 768) fp32 output is 192 KB of
// registers, three quarters of an SM's, so no one block can hold 64 whole
// output rows; a block that holds fewer rows re-reads both weights from L2
// once per those rows.
//
// The design (Hopper, sm90.cuh). A cluster of 2 CTAs on neighbouring SMs
// owns 64 token rows; CTA r owns output columns [384r, 384r + 384). Each CTA
// has two consumer warpgroups and one producer warpgroup (384 threads).
// Consumer warpgroup g holds the (64, 192) fp32 accumulator of columns
// 384r + 192g + [0, 192) for the whole hidden loop (96 registers a thread,
// 232 in all after setmaxnreg; the producer keeps 40).
// The producer's elected lane stages x once (12 TMA boxes of 64 x 64, rows
// at or past T zero-filled) and streams W1 and W2 slabs through a ring of 2
// stages of 48 KB, each completion reported on an mbarrier. The hidden layer
// is walked in chunks of HC = 256:
// - CTA r computes the chunk's columns [128r, 128r + 128) of x @ W1, warpgroup
//   g 64 of them, with m64n64k16 wgmmas (x K-major, W1 MN-major: the
//   transpose bit) over 4 slabs of 192 rows, the sum in registers;
// - GELU and draw 0 in registers; the bf16 result is written into this CTA's
//   h buffer (64 x 256, the TMA layout) and, through distributed shared
//   memory, into the peer's, then both CTAs' 512 consumer threads arrive on
//   each CTA's h_full mbarrier (the first product is computed once);
// - acc += h_chunk (A from shared memory) @ W2[chunk, the warpgroup's 192
//   columns] with m64n192k16 wgmmas over 4 slabs of 64 rows (W2 MN-major);
//   then every consumer thread arrives on both CTAs' h_free, which a CTA
//   waits on before it writes the next chunk's h into either buffer.
// The epilogue applies draw 1 in registers and stores bf16 rows below T.
// Both weights are read once per 64 rows: 6.3 MB per cluster, ~2.2 GB of
// L2 traffic a call at T = 22,080 (the 32-row form read ~4.4 GB). Shared
// memory: x 96 KB + h 32 KB + ring 96 KB = 224 KB a CTA, one CTA an SM.

#include "fused_ln_mlp_common.cuh"
#include "sm90.cuh"

namespace {

using namespace lafs_sm90;
using lafs_mlp::Dropout;
using lafs_mlp::gelu;

constexpr int TPU_TILE = 256;  // the TPU kernel's token tile: the hash key
constexpr int D = 768;         // model width the kernel takes
constexpr int ROWS = 64;       // token rows of a cluster
constexpr int HC = 256;        // hidden chunk of the cluster
constexpr int COLS = D / 2;    // output columns of a CTA
constexpr int THREADS = 384;   // two consumer warpgroups and a producer one
constexpr int BOX = 64 * 64 * 2;                 // one 64 x 64 bf16 box
constexpr int W1_ROWS = 192;                     // W1 slab: 192 x 64 per wg
constexpr int STAGE = 2 * W1_ROWS * 128;         // = 6 W2 boxes: 48 KB
constexpr int X_OFF = 0;                         // x: D / 64 boxes
constexpr int H_OFF = X_OFF + (D / 64) * BOX;    // h: HC / 64 boxes
constexpr int R_OFF = H_OFF + (HC / 64) * BOX;   // the ring: 2 stages
constexpr int BAR_OFF = R_OFF + 2 * STAGE;
constexpr int SMEM = BAR_OFF + 64 + 1024;        // + alignment to 1024 bytes
static_assert(STAGE == (COLS / 64) * BOX, "a stage holds a W2 slab");

template <bool DROP>
// Registers: a launch of 384 threads gives each at most 168 (65,536 in
// all); the consumers' 96 + 32 accumulator registers need more. The
// producer warpgroup drops to 40 (setmaxnreg) and releases 4 x 128 x 32
// registers to the CTA's pool, which lets the two consumer warpgroups rise
// to 232.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
mlp_fusion_bf16_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mw1,
                       const __grid_constant__ CUtensorMap mw2,
                       __nv_bfloat16* __restrict__ y, int T_rows, int H,
                       Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t x_full = base + BAR_OFF;
  auto full = [&](int s) { return x_full + 8 + 8 * s; };
  auto empty = [&](int s) { return x_full + 24 + 8 * s; };
  const uint32_t h_full = x_full + 40, h_free = x_full + 48;

  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  const int row0 = (blockIdx.x / 2) * ROWS;
  const int chunks = H / HC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 256) {
    mbar_init(x_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_init(h_full, 512);  // both CTAs' consumer threads
    mbar_init(h_free, 512);
    fence_mbar_init();
  }
  cluster_sync();  // the peer's barriers exist before any remote arrival

  // one if-else for the kernel's rest: setmaxnreg needs the two paths apart
  if (warp >= 8) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(x_full, (D / 64) * BOX);
      for (int kb = 0; kb < D / 64; ++kb)
        tma_load_2d(base + X_OFF + kb * BOX, &mx, x_full, 64 * kb, row0);
      int it = 0;
      for (int c = 0; c < chunks; ++c) {
        const int h0 = c * HC;
        for (int sl = 0; sl < 8; ++sl, ++it) {
          const int s = it % 2, use = it / 2;
          if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
          const uint32_t st = base + R_OFF + s * STAGE;
          mbar_expect_tx(full(s), STAGE);
          if (sl < 4) {  // W1[192 sl : +192, this CTA's 128 chunk columns]
            for (int g = 0; g < 2; ++g)
              tma_load_2d(st + g * (STAGE / 2), &mw1, full(s),
                          h0 + 128 * rank + 64 * g, W1_ROWS * sl);
          } else {  // W2[h0 + 64 (sl - 4) : +64, this CTA's 384 columns]
            for (int bx = 0; bx < COLS / 64; ++bx)
              tma_load_2d(st + bx * BOX, &mw2, full(s),
                          COLS * rank + 64 * bx, h0 + 64 * (sl - 4));
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while its peer may still arrive on it
  } else {  // consumer warpgroup g: rows rw and rw + 8 of the cluster's 64
    setmaxnreg_inc<232>();
    const int g = warp / 4, rw = 16 * (warp % 4) + lane / 4, quad = lane % 4;
    const uint32_t h_peer = mapa(base + H_OFF, peer);
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    mbar_wait(x_full, 0);
    int it = 0;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = c * HC;
      // u = x @ W1[:, h0 + 128 rank + 64 g : +64], K = 768 in 4 slabs
      float u[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) u[i] = 0.0f;
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + g * (STAGE / 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W1_ROWS / 16; ++kk)
          wgmma_ss<64, 1>(
              u, desc_sw128(base + X_OFF + (3 * sl + kk / 4) * BOX + 32 * (kk % 4),
                            16, 1024),
              desc_sw128(wb + 2048 * kk, STAGE / 2, 1024), sl > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(empty(s));
      }
      // h = drop_0(gelu(u)) in bf16, into both CTAs' h buffers once the
      // previous chunk's h has been read by both
      if (c > 0) mbar_wait_cluster(h_free, (c - 1) & 1);
      const int hbox = 2 * rank + g;  // this warpgroup's 64 chunk columns
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = rw + 8 * ((i >> 1) & 1), j8 = i / 4;
        const int col = h0 + 64 * hbox + 8 * j8 + 2 * quad;
        float v0 = gelu(u[i]), v1 = gelu(u[i + 1]);
        if (DROP) {
          v0 = drop.apply(v0, (long long)row0 + row, col, 0);
          v1 = drop.apply(v1, (long long)row0 + row, col + 1, 0);
        }
        const uint32_t off =
            hbox * BOX + row * 128 + ((j8 ^ (row % 8)) * 16) + 4 * quad;
        const uint32_t p = pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(sbase + H_OFF + off) = p;
        st_cluster_u32(h_peer + off, p);
      }
      fence_proxy_async_all();
      mbar_arrive_cluster(h_full);
      mbar_arrive_remote(mapa(h_full, peer));
      mbar_wait_cluster(h_full, c & 1);
      // acc += h @ W2[h0 : h0 + 256, 384 rank + 192 g : +192]
      for (int sl = 0; sl < 4; ++sl, ++it) {
        const int s = it % 2;
        mbar_wait(full(s), (it / 2) & 1);
        const uint32_t wb = base + R_OFF + s * STAGE + g * 3 * BOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<192, 1>(acc,
                           desc_sw128(base + H_OFF + sl * BOX + 32 * kk, 16,
                                      1024),
                           desc_sw128(wb + 2048 * kk, BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(empty(s));
      }
      mbar_arrive_cluster(h_free);
      mbar_arrive_remote(mapa(h_free, peer));
    }
    // y = drop_1(acc) in bf16, rows below T
#pragma unroll
    for (int i = 0; i < 96; i += 2) {
      const long long row = (long long)row0 + rw + 8 * ((i >> 1) & 1);
      const int col = COLS * rank + 192 * g + 8 * (i / 4) + 2 * quad;
      if (row < T_rows) {
        float v0 = acc[i], v1 = acc[i + 1];
        if (DROP) {
          v0 = drop.apply(v0, row, col, 1);
          v1 = drop.apply(v1, row, col + 1, 1);
        }
        *reinterpret_cast<uint32_t*>(y + row * D + col) = pack_bf16(v0, v1);
      }
    }
    __syncwarp();
    cluster_sync();
  }
}

cudaError_t map2d(CUtensorMap* m, const void* p, int cols, int rows,
                  int box_rows) {
  const unsigned long long dims[2] = {(unsigned long long)cols,
                                      (unsigned long long)rows};
  const unsigned long long strides[1] = {2ull * cols};
  const unsigned box[2] = {64u, (unsigned)box_rows};
  return lafs_sm90_host::make_map(m, p, 2, dims, strides, box);
}

}  // namespace

// x (T, 768), w1 (768, H), w2 (H, 768), y (T, 768), all bf16, row-major and
// 16-byte aligned; H a multiple of 256 (checked by the Python wrapper).
// `drop` = 0 turns dropout off, and then seed, thresh and inv_keep are not
// read.
extern "C" int lafs_mlp_fusion_bf16(const void* x, const void* w1,
                                    const void* w2, void* y, int T_rows, int Dm,
                                    int H, unsigned seed, unsigned thresh,
                                    float inv_keep, int drop, void* stream) {
  if (T_rows <= 0) return cudaSuccess;
  if (Dm != D || H <= 0 || H % HC) return cudaErrorInvalidValue;
  const Dropout dr =
      lafs_mlp::make_dropout(seed, thresh, inv_keep, drop, TPU_TILE);
  CUtensorMap mx, mw1, mw2;
  cudaError_t err;
  if ((err = map2d(&mx, x, D, T_rows, 64)) != cudaSuccess ||
      (err = map2d(&mw1, w1, H, D, W1_ROWS)) != cudaSuccess ||
      (err = map2d(&mw2, w2, D, H, 64)) != cudaSuccess)
    return err;
  auto kernel = drop ? mlp_fusion_bf16_kernel<true>
                     : mlp_fusion_bf16_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const unsigned clusters = (unsigned)((T_rows + ROWS - 1) / ROWS);
  kernel<<<2 * clusters, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      mx, mw1, mw2, static_cast<__nv_bfloat16*>(y), T_rows, H, dr);
  return cudaGetLastError();
}
