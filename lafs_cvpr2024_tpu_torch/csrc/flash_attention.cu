// Flash attention forward (kernel 11a of the PyTorch/CUDA port).
//
// Replaces the forward Pallas TPU kernel behind
// lafs_cvpr2024_tpu/models/layers.py::_flash_attention: JAX's own
// jax/experimental/pallas/ops/tpu/flash_attention.py
// (_flash_attention_kernel, launched by _flash_attention_impl), on
// (B, H, N, D) operands of any length N >= 1:
//     s = (Q K^T) * scale                  fp32 accumulate
//     online softmax over key blocks       fp32 running max m and sum l
//     O = sum_j cast(p_j, V dtype) V_j / l fp32 accumulate
//     lse = m + log(l)                     fp32, saved for the backward
// The JAX wrapper pads N to a multiple of 128 and masks the padded keys
// with segment ids; here keys at or past N are masked inside the last
// block, and rows at or past N are not written, which gives the same
// function on the real rows. The operands may be strided views (the
// to_qkv output split into heads, D contiguous): the kernel reads them in
// place and writes O through its own strides.
//
// What bounds it on the card. At the SSL globals' shape (B = 64, H = 11,
// N = 197, D = 64, bf16) Q, K, V and O are 4 x 17.8 MB, 0.021 ms at
// 3.35 TB/s; the two products are 7 GFLOP, 0.007 ms at the dense bf16 peak:
// bound by bytes. What the TPU kernel was for, and what this design keeps:
// the (N, N) scores never reach device memory, whatever N is.
//
// bf16, the Hopper design (sm90.cuh). A block of 160 threads owns one
// (b, h) and 64 query rows: one consumer warpgroup (one m64 wgmma tile)
// and one producer warp. The producer's elected lane issues TMA loads
// through 4-D tensor maps over the views' own strides, Q once and K and V
// in 64-key tiles into a ring of 2 stages, each completion reported on an
// mbarrier; TMA writes zeros for rows at or past N, so no thread computes
// an address. The consumer computes S = Q K^T with four m64nWk16 wgmmas
// (both operands K-major in shared memory), W the key block cut to the next
// multiple of 16 (16, 32, 48 or 64: a tail costs at most 16 keys of
// products, not 64), scales S and masks keys at or past N to -inf in
// registers, takes the row max and sum over the 4 threads of a quad,
// rescales the register-resident O, casts p to bf16 in registers (the
// accumulator's pairs are the register A layout) and adds P V with W/16
// wgmmas whose B operand is the V tile read MN-major (the transpose bit).
// The running max, sum and O never leave registers. O / l is cast to bf16,
// staged in the Q buffer in the TMA layout and stored by one TMA store over
// O's strides, which drops rows at or past N. Shared memory 41 KB and 160
// threads a block, so several blocks share an SM and hide each other's
// softmax.
//
// fp32 keeps the first design, FMA chains through shared memory: it is the
// precision check of the oracle and no main path runs it.

#include "fused_attention_common.cuh"
#include "sm90.cuh"

namespace {

using namespace lafs_attn;

// ----------------------------------------------------------------- bf16 --

namespace hopper {

using namespace lafs_sm90;

constexpr int ROWS = 64;                      // query rows per block
constexpr int KB = 64;                        // keys per block of keys
constexpr int STAGES = 2;                     // K/V ring
constexpr int THREADS = 160;                  // a warpgroup and a warp
constexpr int TILE = ROWS * D * 2;            // one 64 x 64 bf16 tile, 8 KB
constexpr int Q_OFF = 0;                      // Q, then O's staging
constexpr int K_OFF = TILE;                   // K stages
constexpr int V_OFF = K_OFF + STAGES * TILE;  // V stages
constexpr int BAR_OFF = V_OFF + STAGES * TILE;
constexpr int SMEM = BAR_OFF + 64 + 1024;     // + alignment to 1024 bytes

// One block of keys of width W (64, or the tail cut to 16, 32 or 48) for
// this thread's rows r and r + 8 of the tile: S = Q K^T with four 16-deep
// slices (both operands K-major), scale and mask keys at or past kn in
// registers, the online softmax over the quad, then O += cast(P) V with
// W / 16 slices, P from registers and V MN-major from its TMA tile. No
// branch surrounds a wgmma: the width is a template argument.
template <int W>
__device__ __forceinline__ void step(float (&o)[32], float (&m)[2],
                                     float (&l)[2], uint32_t q, uint32_t kt,
                                     uint32_t vt, uint32_t k_full,
                                     uint32_t v_full, uint32_t empty, int par,
                                     int kn, int quad, float scale) {
  constexpr int R = W / 2;  // accumulator registers of S
  float sc[R];
  mbar_wait(k_full, par);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<W, 0>(sc, desc_sw128(q + 32 * kk, 16, 1024),
                   desc_sw128(kt + 32 * kk, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = 8 * (i / 4) + 2 * quad + (i & 1);
    sc[i] = col < kn ? __fmul_rn(sc[i], scale) : -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e]);
    alpha[e] = expf(m[e] - m_new);  // 0 on the first block
    m[e] = m_new;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = (i >> 1) & 1;
    sc[i] = expf(__fsub_rn(sc[i], m[e]));  // masked keys: exp(-inf) = 0
    sum[e] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
    l[e] = l[e] * alpha[e] + sum[e];
  }

  uint32_t a[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) pack_a(sc, kk, a[kk]);
  mbar_wait(v_full, par);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs_n64<1>(o, a[kk], desc_sw128(vt + 2048 * kk, TILE, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  mbar_arrive(empty);
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mo, float* __restrict__ lse,
               int H, int N, int hn_order, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + BAR_OFF;  // then k_full, v_full, empty
  auto k_full = [&](int s) { return q_full + 8 + 8 * s; };
  auto v_full = [&](int s) { return q_full + 8 + 8 * STAGES + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 16 * STAGES + 8 * s; };

  const int tiles = (N + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * ROWS;
  const int b = bh / H, h = bh % H;
  // TMA coordinates of row n0 of this (b, h): (0, h, n0, b), or
  // (0, n0, h, b) for maps in the (D, N, H, B) order
  auto c1 = [&](int n0) { return hn_order ? h : n0; };
  auto c2 = [&](int n0) { return hn_order ? n0 : h; };
  const int blocks = (N + KB - 1) / KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, TILE);
      tma_load_4d(base + Q_OFF, &mq, q_full, 0, c1(q0), c2(q0), b);
      for (int j = 0; j < blocks; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const int k0 = j * KB;
        mbar_expect_tx(k_full(s), TILE);
        tma_load_4d(base + K_OFF + s * TILE, &mk, k_full(s), 0, c1(k0),
                    c2(k0), b);
        mbar_expect_tx(v_full(s), TILE);
        tma_load_4d(base + V_OFF + s * TILE, &mv, v_full(s), 0, c1(k0),
                    c2(k0), b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r and r + 8 of the tile
  const int r = 16 * warp + lane / 4, quad = lane % 4;
  float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  mbar_wait(q_full, 0);
  // whole blocks of 64 keys, then the last block at its cut width
  for (int j = 0; j < blocks; ++j) {
    const int s = j % STAGES, par = (j / STAGES) & 1;
    const int kn = min(KB, N - j * KB);  // real keys in this block
    const uint32_t kt = base + K_OFF + s * TILE, vt = base + V_OFF + s * TILE;
    const int w16 = (kn + 15) / 16;      // 16-key slices: 4 but at the tail
#define LAFS_FLASH_STEP(W)                                                   \
  step<W>(o, m, l, base + Q_OFF, kt, vt, k_full(s), v_full(s), empty(s), par, \
          kn, quad, scale)
    switch (w16) {
      case 1: LAFS_FLASH_STEP(16); break;
      case 2: LAFS_FLASH_STEP(32); break;
      case 3: LAFS_FLASH_STEP(48); break;
      default: LAFS_FLASH_STEP(64); break;
    }
#undef LAFS_FLASH_STEP
  }

  // lse of the real rows, then O / l through the Q buffer and a TMA store
  if (quad == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + r + 8 * e;
      if (row < N) lse[(long long)bh * N + row] = m[e] + logf(l[e]);
    }
  }
  bar_sync(1, 128);  // every warp's last product has read Q
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = r + 8 * ((i >> 1) & 1), chunk = i / 4;
    const int e = (i >> 1) & 1;
    const uint32_t v = pack_bf16(o[i] / l[e], o[i + 1] / l[e]);
    *reinterpret_cast<uint32_t*>(sbase + Q_OFF + row * 128 +
                                 ((chunk ^ (row % 8)) * 16) + 4 * quad) = v;
  }
  fence_proxy_async();
  bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_4d(&mo, base + Q_OFF, 0, c1(q0), c2(q0), b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

int entry(const void* q, const void* k, const void* v, void* o, void* lse,
          const long long* st, int B, int H, int N, float scale,
          cudaStream_t stream) {
  // one dim order for all four maps: the kernel's coordinates follow it
  using lafs_sm90_host::bhsd_map;
  const bool hn = st[1] <= st[2] && st[4] <= st[5] && st[7] <= st[8] &&
                  st[10] <= st[11];
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = bhsd_map(&mq, q, st, B, H, N, ROWS, hn)) != cudaSuccess ||
      (err = bhsd_map(&mk, k, st + 3, B, H, N, ROWS, hn)) != cudaSuccess ||
      (err = bhsd_map(&mv, v, st + 6, B, H, N, ROWS, hn)) != cudaSuccess ||
      (err = bhsd_map(&mo, o, st + 9, B, H, N, ROWS, hn)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_fwd_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + ROWS - 1) / ROWS);
  flash_fwd_bf16<<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), H, N, hn ? 1 : 0, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ----------------------------------------------------------------- fp32 --

constexpr int QT = 64;  // query rows per block
constexpr int KB = 64;  // keys per step

// Shared-memory regions: Q (QT, LD), K or V (KB, LD), the fp32 scores
// (QT, LDS), whose rows are overwritten with p, the fp32 P V tile and
// accumulator (QT, LDO each), and the row statistics.
struct FwdLayout {
  static constexpr int LD = D + pad<float>();
  static constexpr int LDS = KB + 4;
  static constexpr int TQ = round128((long long)QT * LD * 4);
  static constexpr int TK = round128((long long)KB * LD * 4);
  static constexpr int SC = round128((long long)QT * LDS * 4);
  static constexpr int AC = round128((long long)QT * LDO * 4);
  static constexpr int q = 0, kv = q + TQ, sc = kv + TK, pv = sc + SC;
  static constexpr int acc = pv + AC, st = acc + AC;
  static constexpr int total = st + round128(3 * QT * 4);
};

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
              Strides so, int H, int N, float scale) {
  using L = FwdLayout;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* kv = reinterpret_cast<float*>(smem + L::kv);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* pv = reinterpret_cast<float*>(smem + L::pv);
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  float* row_m = reinterpret_cast<float*>(smem + L::st);
  float* row_l = row_m + QT;
  float* row_a = row_l + QT;

  const int tiles = (N + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, N);
  for (int e = threadIdx.x; e < QT * LDO; e += THREADS) acc[e] = 0.0f;
  for (int r = threadIdx.x; r < QT; r += THREADS) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.0f;
  }
  for (int k0 = 0; k0 < N; k0 += KB) {
    __syncthreads();  // the previous step is done with K/V, P and P V
    load_rows(kv, LD, kb, sk.s, k0, KB, N);
    __syncthreads();
    block_gemm<float, true, false>(sc, L::LDS, qs, LD, kv, LD, QT, KB, D,
                                   false);
    __syncthreads();
    // V replaces K while the warps update the row statistics
    load_rows(kv, LD, vb, sv.s, k0, KB, N);
    const int kn = min(KB, N - k0);  // real keys in this block
    for (int r = warp; r < QT; r += WARPS) {
      float* row = sc + r * L::LDS;  // read, then overwritten with p
      float mb = -INFINITY;
      for (int j = lane; j < kn; j += 32)
        mb = fmaxf(mb, __fmul_rn(row[j], scale));
      mb = warp_max(mb);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mb);
      float sum = 0.0f;
      for (int j = lane; j < KB; j += 32) {
        float e = 0.0f;
        if (j < kn) e = expf(__fsub_rn(__fmul_rn(row[j], scale), m_new));
        sum += e;
        row[j] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first block
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    block_gemm<float, true, true>(pv, LDO, sc, L::LDS, kv, LD, QT, D, KB,
                                  false);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * D; e += THREADS) {
      const int r = e / D, c = e % D;
      acc[r * LDO + c] = acc[r * LDO + c] * row_a[r] + pv[r * LDO + c];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < QT * D; e += THREADS) {
    const int r = e / D, c = e % D;
    acc[r * LDO + c] = acc[r * LDO + c] / row_l[r];
  }
  float* lse_bh = lse + (long long)bh * N;
  for (int r = threadIdx.x; r < QT; r += THREADS)
    if (q0 + r < N) lse_bh[q0 + r] = row_m[r] + logf(row_l[r]);
  __syncthreads();
  store_rows(o + b * so.b + h * so.h, so.s, acc, LDO, 1.0f, q0, QT, N);
}

int entry_f32(const void* q, const void* k, const void* v, void* o,
              void* lse, const long long* st, int B, int H, int N,
              float scale, cudaStream_t stream) {
  using L = FwdLayout;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + QT - 1) / QT);
  flash_fwd_f32<<<(unsigned)blocks, THREADS, L::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, H, N, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, N, D) with D = 64 contiguous, every other stride a
// multiple of 16 bytes and 16-byte-aligned bases; lse: (B, H, N) fp32,
// contiguous; strides: 12 int64, (b, h, n) element strides of q, k, v and o
// in turn; N >= 1. The Python wrapper checks the same and raises before
// calling.
extern "C" int lafs_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int B,
                                         int H, int N, int Dh, float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || N < 1) return cudaErrorInvalidValue;
  return hopper::entry(q, k, v, o, lse, strides, B, H, N, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int lafs_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const long long* strides, int B, int H,
                                        int N, int Dh, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || N < 1) return cudaErrorInvalidValue;
  return entry_f32(q, k, v, o, lse, strides, B, H, N, scale,
                   static_cast<cudaStream_t>(stream));
}
