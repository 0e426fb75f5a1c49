// Flash attention backward (kernels 11b and 11c of the PyTorch/CUDA port).
//
// Replace the two backward Pallas TPU kernels behind
// lafs_cvpr2024_tpu/models/layers.py::_flash_attention, in JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   11b  _flash_attention_dkv_kernel (launched by _flash_attention_bwd_dkv)
//   11c  _flash_attention_dq_kernel  (launched by _flash_attention_bwd_dq)
// From Q, K, V, dO, the forward's O and its per-row logsumexp both recompute
//     p  = exp(s * scale - lse)                   fp32
//     dp = dO V^T                                 fp32
//     ds = (dp - di) * p * scale                  fp32, di = rowsum(O dO)
// and form, as the JAX kernels do, with p and ds cast to the operands' dtype
// before their products (fp32 accumulate):
//     11c: dQ = sum over key blocks of cast(ds) K
//     11b: dV = sum over query tiles of cast(p)^T dO, dK = cast(ds)^T Q
// 11c runs first: it also computes di (the JAX VJP leaves that to XLA) and
// writes each 64-row query tile's statistics, lse * log2 e and di, to a
// (B·H, tiles, 2, 64) fp32 scratch that 11b reads. Rows at or past N get
// lse * log2 e = +inf and di = 0 there, which make p exactly 0. Keys at or
// past N add nothing; no row past N is written. Operands and results may be
// strided views with D contiguous, as in the forward (flash_attention.cu);
// so may lse.
//
// What bounds them on the card. At B = 64, H = 11, N = 197, D = 64 in bf16
// 11c reads Q, K, V, O, dO (5 x 17.8 MB) and lse and writes dQ and the
// 1.4 MB scratch, 11b reads Q, K, V, dO and the scratch and writes dK and
// dV: 0.032 ms each at 3.35 TB/s; their products with the recomputed scores
// are 3 and 4 x 3.5 GFLOP, 0.011 and 0.014 ms at the dense bf16 peak: bound
// by bytes. Kept from the TPU kernels: no (N, N) tensor in device memory.
//
// Two kernels and no atomics, as the library has: each block owns one
// output tile and loops over the other sequence axis in order, so the sums
// come out the same in every run (the exact-resume check of the training CLI
// relies on it).
//
// bf16, the Hopper design (sm90.cuh, fused_attention_common.cuh::hop):
// blocks of 160 threads, a producer warp whose elected lane issues TMA loads
// through 4-D tensor maps over the views' own strides (zeros for rows at or
// past N) and one consumer warpgroup whose products are wgmmas with the
// accumulators in registers; results are staged in swizzled tiles and
// written by TMA stores, which drop rows at or past N. Exponentials are exp2
// of the scores scaled by scale · log2 e, less lse · log2 e.
//   11c, one block per (b, h, 64 query rows): Q, dO and O of the tile loaded
//      once, K and V in 64-key tiles through a ring of 2 stages, so any N
//      works. First di = rowsum(O dO) in fp32 (each thread 16 columns of
//      its two rows, summed over the quad) and the thread's lse by ordinary
//      loads; the tile's statistics go to the scratch. Then per key block
//      (the last cut to the next multiple of 16; one templated body per
//      width, so no branch surrounds a wgmma): S = Q K^T and dP = dO V^T in
//      registers (32 fp32 each), p = 2^(s·c - lse·log2 e) with keys at or
//      past N set to 0 by a select, dS = p (dP - di) scale cast to bf16
//      pairs in registers (the register A operand), dQ += dS K with K read
//      MN-major. One sweep: 3 products and 1 exp an element. dQ is staged
//      in O's tile.
//   11b, one block per (b, h, 64 keys): K and V of those keys loaded once,
//      Q, dO and the query tile's 512 bytes of statistics (one bulk copy)
//      through a ring of 3 stages. Per query tile (cut to a multiple of 16):
//      S^T = K Q^T and dP^T = V dO^T in registers, P^T = 2^(s·c - lse·log2
//      e) with query columns and key rows at or past N set to exactly 0 by a
//      select (no 0 · Inf), dS^T = P^T (dP^T - di) scale; dV += cast(P^T) dO
//      and dK += cast(dS^T) Q, both A operands from registers, dO and Q read
//      MN-major. dK and dV (64 fp32 a thread together) are stored at the end
//      through the K and V tiles' shared memory. A ragged key tile (5 of 64
//      keys at N = 197) idles the rest of its products: one path for all.
// Both at two blocks an SM (__launch_bounds__(160, 2): at most 168
// registers a thread).
//
// fp32 keeps the first design, FMA chains through shared memory: 11c per
// (b, h, 32 query rows), 11b per (b, h, 32 keys) walking the query tiles in
// 64-row steps. It is the precision check of the oracle and no main path
// runs it.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

constexpr int SROWS = 64;  // rows of one statistics tile of the scratch

// ----------------------------------------------------------------- bf16 --

namespace hopper {

using namespace lafs_sm90;
using namespace lafs_attn::hop;

constexpr int THREADS = 160;  // a consumer warpgroup and a producer warp
constexpr int STATS = 2 * ROWS * 4;  // bytes of one tile's lse·log2 e, di

// 11c shared memory: Q, dO, O (then dQ's staging), the K and V stages and
// the barriers.
constexpr int DQ_STAGES = 2;
struct DqSmem {
  static constexpr int q = 0, dout = TILE, o = 2 * TILE, k = 3 * TILE;
  static constexpr int v = k + DQ_STAGES * TILE;
  static constexpr int bar = v + DQ_STAGES * TILE;
  static constexpr int total = bar + 64 + 1024;
};

// One block of W keys (kn real) for this thread's rows of the query tile:
// S and dP in registers, p and dS, then dQ += cast(dS) K.
template <int W>
__device__ __forceinline__ void dq_step(float (&dq)[32], uint32_t qa,
                                        uint32_t doa, uint32_t kt,
                                        uint32_t vt, const float (&lse2)[2],
                                        const float (&di)[2], int kn,
                                        int quad, float c, float scale) {
  constexpr int NT = W / 16, R = W / 2;
  float sc[R], dp[R];
  wgmma_fence();
  mma_abt<NT>(sc, qa, kt);
  mma_abt<NT>(dp, doa, vt);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R>(sc);
  reg_fence<R>(dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = acc_half(i);
    const float p = acc_col(i, quad) < kn ? ex2(sc[i] * c - lse2[e]) : 0.0f;
    sc[i] = p * (dp[i] - di[e]) * scale;
  }
  uint32_t pd[NT][4];
  pack_all<NT>(sc, pd);
  reg_fence<32>(dq);
  reg_fence(pd);
  wgmma_fence();
  mma_pb<NT>(dq, pd, kt);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<32>(dq);
}

// rowsum(O ∘ dO) over this thread's 16 columns (chunks 2·quad and
// 2·quad + 1) of row rr of two 128-byte-swizzled bf16 tiles
__device__ __forceinline__ float row_dot(const unsigned char* o,
                                         const unsigned char* dout, int rr,
                                         int quad) {
  float sum = 0.0f;
#pragma unroll
  for (int ch = 2 * quad; ch < 2 * quad + 2; ++ch) {
    const int off = rr * 128 + ((ch ^ (rr % 8)) * 16);
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 af = __bfloat1622float2(a2[x]);
      const float2 gf = __bfloat1622float2(g2[x]);
      sum = fmaf(af.x, gf.x, sum);
      sum = fmaf(af.y, gf.y, sum);
    }
  }
  return sum;
}

// hs: bit i set when map i (q, k, v, o, do, dq) is in (D, H, S, B) order;
// sl: lse's (b, h, n) element strides
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo,
                  const __grid_constant__ CUtensorMap mdo,
                  const __grid_constant__ CUtensorMap mdq,
                  const float* __restrict__ lse, Strides sl,
                  float* __restrict__ stats, int H, int N, int hs,
                  float scale) {
  using L = DqSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int nt = (N + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nt, t = blockIdx.x % nt, q0 = t * ROWS;
  const int b = bh / H, h = bh % H;
  const uint32_t q_full = base + L::bar;
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * DQ_STAGES + 8 * s; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: Q, dO and O, then K and V block by block
    if (lane == 0) {
      mbar_expect_tx(q_full, 3 * TILE);
      tma_load_rows(base + L::q, &mq, q_full, hs & 1, b, h, q0);
      tma_load_rows(base + L::dout, &mdo, q_full, hs & 16, b, h, q0);
      tma_load_rows(base + L::o, &mo, q_full, hs & 8, b, h, q0);
      for (int j = 0; j < nt; ++j) {
        const int s = j % DQ_STAGES, use = j / DQ_STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * TILE);
        tma_load_rows(base + L::k + s * TILE, &mk, full(s), hs & 2, b, h,
                      j * ROWS);
        tma_load_rows(base + L::v + s * TILE, &mv, full(s), hs & 4, b, h,
                      j * ROWS);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r and r + 8 of the tile
  const int r = 16 * warp + lane / 4, quad = lane % 4;
  const float c = scale * LOG2E;
  float lse2[2], di[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r + 8 * e;
    lse2[e] = row < N ? lse[b * sl.b + h * sl.h + row * sl.s] * LOG2E
                      : INFINITY;
  }
  mbar_wait(q_full, 0);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    di[e] = row_dot(sbase + L::o, sbase + L::dout, r + 8 * e, quad);
  quad_sum(di);  // rows past N: zeros from TMA, so di = 0
  if (quad == 0) {
    float* st = stats + ((long long)bh * nt + t) * 2 * ROWS;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      st[r + 8 * e] = lse2[e];
      st[ROWS + r + 8 * e] = di[e];
    }
  }
  float dq[32];
  zero(dq);
  for (int j = 0; j < nt; ++j) {
    const int s = j % DQ_STAGES;
    const int kn = min(ROWS, N - j * ROWS);  // real keys of the block
    mbar_wait(full(s), (j / DQ_STAGES) & 1);
    by_width(kn, [&](auto w) {
      dq_step<decltype(w)::value>(dq, base + L::q, base + L::dout,
                                  base + L::k + s * TILE,
                                  base + L::v + s * TILE, lse2, di, kn, quad,
                                  c, scale);
    });
    mbar_arrive(empty(s));
  }
  // O was read for di before the first block: its tile stages dQ
  store_tile(dq, 1.0f, sbase + L::o, base + L::o, &mdq, hs & 32, b, h, q0, r,
             quad);
  if (threadIdx.x == 0) tma_store_wait_read();
}

constexpr int DKV_STAGES = 3;
constexpr int DKV_STAGE = 2 * TILE + 1024;  // Q, dO, statistics (+ padding)

// 11b shared memory: K and V of the block's keys (then dK's and dV's
// staging), the stages of (Q, dO, statistics), the barriers.
struct DkvSmem {
  static constexpr int k = 0, v = TILE, stages = 2 * TILE;
  static constexpr int bar = stages + DKV_STAGES * DKV_STAGE;
  static constexpr int total = bar + 64 + 1024;
};

// One query tile of W columns (qn real) against the block's 64 keys (kn
// real): S^T, dP^T, P^T and dS^T in registers, then dV += P^T dO and
// dK += dS^T Q. `stat`: the tile's lse·log2 e and di (64 floats each).
template <int W>
__device__ __forceinline__ void dkv_step(float (&dk)[32], float (&dv)[32],
                                         uint32_t ka, uint32_t va,
                                         uint32_t qb, uint32_t dob,
                                         const float* stat, int qn, int kn,
                                         int r, int quad, float c,
                                         float scale) {
  constexpr int NT = W / 16, R = W / 2;
  float st[R], dpt[R];
  wgmma_fence();
  mma_abt<NT>(st, ka, qb);
  mma_abt<NT>(dpt, va, dob);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R>(st);
  reg_fence<R>(dpt);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = acc_col(i, quad);
    const bool real = col < qn && r + 8 * acc_half(i) < kn;
    const float p = real ? ex2(st[i] * c - stat[col]) : 0.0f;
    dpt[i] = p * (dpt[i] - stat[ROWS + col]) * scale;
    st[i] = p;
  }
  uint32_t pa[NT][4], pd[NT][4];
  pack_all<NT>(st, pa);
  pack_all<NT>(dpt, pd);
  reg_fence<32>(dv);
  reg_fence<32>(dk);
  reg_fence(pa);
  reg_fence(pd);
  wgmma_fence();
  mma_pb<NT>(dv, pa, dob);
  mma_pb<NT>(dk, pd, qb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<32>(dv);
  reg_fence<32>(dk);
}

// hs: bit i set when map i (q, k, v, do, dk, dv) is in (D, H, S, B) order
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mdk,
                   const __grid_constant__ CUtensorMap mdv,
                   const float* __restrict__ stats, int H, int N, int hs,
                   float scale) {
  using L = DkvSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int nt = (N + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nt, kt = blockIdx.x % nt;
  const int b = bh / H, h = bh % H;
  const uint32_t kv_full = base + L::bar;
  auto full = [&](int s) { return kv_full + 8 + 8 * s; };
  auto empty = [&](int s) { return kv_full + 8 + 8 * DKV_STAGES + 8 * s; };
  auto stage = [&](int s) { return L::stages + s * DKV_STAGE; };  // offset
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: K and V of the block, then the stages
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * TILE);
      tma_load_rows(base + L::k, &mk, kv_full, hs & 2, b, h, kt * ROWS);
      tma_load_rows(base + L::v, &mv, kv_full, hs & 4, b, h, kt * ROWS);
      for (int i = 0; i < nt; ++i) {
        const int s = i % DKV_STAGES, use = i / DKV_STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const uint32_t at = base + stage(s);
        mbar_expect_tx(full(s), 2 * TILE + STATS);
        tma_load_rows(at, &mq, full(s), hs & 1, b, h, i * ROWS);
        tma_load_rows(at + TILE, &mdo, full(s), hs & 8, b, h, i * ROWS);
        bulk_load(at + 2 * TILE, stats + ((long long)bh * nt + i) * 2 * ROWS,
                  STATS, full(s));
      }
    }
    return;
  }

  const int r = 16 * warp + lane / 4, quad = lane % 4;
  const int kn = min(ROWS, N - kt * ROWS);  // real keys of the block
  const float c = scale * LOG2E;
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  mbar_wait(kv_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i % DKV_STAGES;
    const uint32_t at = base + stage(s);
    const float* stat =
        reinterpret_cast<const float*>(sbase + stage(s) + 2 * TILE);
    const int qn = min(ROWS, N - i * ROWS);  // real queries of the tile
    mbar_wait(full(s), (i / DKV_STAGES) & 1);
    by_width(qn, [&](auto w) {
      dkv_step<decltype(w)::value>(dk, dv, base + L::k, base + L::v, at,
                                   at + TILE, stat, qn, kn, r, quad, c,
                                   scale);
    });
    mbar_arrive(empty(s));
  }
  // K and V are read: their tiles stage dK and dV
  store_tile(dk, 1.0f, sbase + L::k, base + L::k, &mdk, hs & 16, b, h,
             kt * ROWS, r, quad);
  store_tile(dv, 1.0f, sbase + L::v, base + L::v, &mdv, hs & 32, b, h,
             kt * ROWS, r, quad);
  if (threadIdx.x == 0) tma_store_wait_read();
}

int dq_entry(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dq, void* stats,
             const long long* st, int B, int H, int N, float scale,
             cudaStream_t stream) {
  // maps: q, k, v, o, do, dq (the strides' order; lse's follow)
  const void* ptrs[6] = {q, k, v, o, dout, dq};
  CUtensorMap m[6];
  int hs;
  cudaError_t err = maps(m, ptrs, st, 6, B, H, N, &hs);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + ROWS - 1) / ROWS);
  flash_bwd_dq_bf16<<<(unsigned)blocks, THREADS, DqSmem::total, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(lse),
      Strides{st[18], st[19], st[20]}, static_cast<float*>(stats), H, N, hs,
      scale);
  return cudaGetLastError();
}

int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* stats, void* dk, void* dv, const long long* st,
              int B, int H, int N, float scale, cudaStream_t stream) {
  // maps: q, k, v, do, dk, dv (the strides' order)
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  CUtensorMap m[6];
  int hs;
  cudaError_t err = maps(m, ptrs, st, 6, B, H, N, &hs);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvSmem::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + ROWS - 1) / ROWS);
  flash_bwd_dkv_bf16<<<(unsigned)blocks, THREADS, DkvSmem::total, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(stats), H,
      N, hs, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ----------------------------------------------------------------- fp32 --

// p and ds of one (query row, key) element from the fp32 score s and dp,
// c = scale · log2 e and the row's lse · log2 e and di
__device__ __forceinline__ float prob_lse2(float s, float c, float lse2) {
  return exp2f(__fsub_rn(__fmul_rn(s, c), lse2));
}

__device__ __forceinline__ float dscore(float dp, float di, float p,
                                        float scale) {
  return __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
}

constexpr int LD = D + pad<float>();  // row stride of the shared tiles
constexpr int KT = 32;  // 11b: key rows per block
constexpr int QB = 64;  // 11b: query rows per step (one statistics tile)
constexpr int QT = 32;  // 11c: query rows per block
constexpr int KB = 64;  // 11c: keys per step

// 11c regions: Q and dO of the block (QT, LD each), K and V of the step
// (KB, LD each), the scores (QT, KB + 4; first O's rows for di), dp then ds
// (QT, KB + 4), the dQ sum (QT, LDO) and the block's lse·log2 e and di.
struct DqLayout {
  static constexpr int LDS = KB + 4;
  static constexpr int TQ = round128((long long)QT * LD * 4);
  static constexpr int TK = round128((long long)KB * LD * 4);
  static constexpr int SC = round128((long long)QT * LDS * 4);
  static constexpr int AC = round128((long long)QT * LDO * 4);
  static constexpr int qs = 0, dos = TQ, ks = 2 * TQ, vs = ks + TK;
  static constexpr int sc = vs + TK, dp = sc + SC, acc = dp + SC;
  static constexpr int st = acc + AC;
  static constexpr int total = st + round128(2 * QT * 4);
};
static_assert(DqLayout::LDS == LD, "O's rows are loaded into the scores");

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dq,
                 float* __restrict__ stats, Strides sq, Strides sk,
                 Strides sv, Strides so, Strides sdo, Strides sdq,
                 Strides sl, int H, int N, float scale) {
  using L = DqLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  float* dos = reinterpret_cast<float*>(smem + L::dos);
  float* ks = reinterpret_cast<float*>(smem + L::ks);
  float* vs = reinterpret_cast<float*>(smem + L::vs);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* dp = reinterpret_cast<float*>(smem + L::dp);  // then ds
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  float* s_lse2 = reinterpret_cast<float*>(smem + L::st);
  float* s_di = s_lse2 + QT;

  const int tiles = (N + QT - 1) / QT, nt = (N + SROWS - 1) / SROWS;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float c = __fmul_rn(scale, hop::LOG2E);
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, N);
  load_rows(dos, LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, QT, N);
  load_rows(sc, LD, o + b * so.b + h * so.h, so.s, q0, QT, N);
  __syncthreads();
  // di = rowsum(O dO) and the statistics of the block's rows; rows past N
  // (zeros) get di = 0 and lse·log2 e = +inf
  float* st_bh = stats + (long long)bh * nt * 2 * SROWS;
  for (int r = warp; r < QT; r += WARPS) {
    const int row = q0 + r;
    const float* orow = sc + r * LD;
    const float* grow = dos + r * LD;
    const float di = warp_sum(fmaf(orow[lane], grow[lane],
                                   orow[lane + 32] * grow[lane + 32]));
    if (lane == 0) {
      const float lse2 =
          row < N
              ? __fmul_rn(lse[b * sl.b + h * sl.h + row * sl.s], hop::LOG2E)
              : INFINITY;
      s_lse2[r] = lse2;
      s_di[r] = di;
      float* st = st_bh + (row / SROWS) * 2 * SROWS + row % SROWS;
      st[0] = lse2;
      st[SROWS] = di;
    }
  }
  // the last block of a statistics tile that it starts: the padded rows of
  // the tile's other half
  if (q0 % SROWS == 0 && q0 + QT >= N && threadIdx.x < SROWS - QT) {
    float* st = st_bh + (q0 / SROWS) * 2 * SROWS + QT + threadIdx.x;
    st[0] = INFINITY;
    st[SROWS] = 0.0f;
  }
  for (int e = threadIdx.x; e < QT * LDO; e += THREADS) acc[e] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += KB) {
    __syncthreads();  // the previous step (or di) is done with the tiles
    load_rows(ks, LD, kb, sk.s, k0, KB, N);
    load_rows(vs, LD, vb, sv.s, k0, KB, N);
    __syncthreads();
    block_gemm<float, true, false>(sc, L::LDS, qs, LD, ks, LD, QT, KB, D,
                                   false);
    block_gemm<float, true, false>(dp, L::LDS, dos, LD, vs, LD, QT, KB, D,
                                   false);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * KB; e += THREADS) {
      const int r = e / KB, j = e % KB;
      float g = 0.0f;
      if (k0 + j < N) {
        const float pr = prob_lse2(sc[r * L::LDS + j], c, s_lse2[r]);
        g = dscore(dp[r * L::LDS + j], s_di[r], pr, scale);
      }
      dp[r * L::LDS + j] = g;  // in place: read, then written
    }
    __syncthreads();
    block_gemm<float, true, true>(acc, LDO, dp, L::LDS, ks, LD, QT, D, KB,
                                  true);
  }
  __syncthreads();
  store_rows(dq + b * sdq.b + h * sdq.h, sdq.s, acc, LDO, 1.0f, q0, QT, N);
}

// 11b regions: K and V of the block (KT, LD each), Q and dO of the step
// (QB, LD each), the scores then p and dp then ds (QB, KT + 4 each), the
// dK and dV sums (KT, LDO each) and the step's statistics tile.
struct DkvLayout {
  static constexpr int LDS = KT + 4;
  static constexpr int TK = round128((long long)KT * LD * 4);
  static constexpr int TQ = round128((long long)QB * LD * 4);
  static constexpr int SC = round128((long long)QB * LDS * 4);
  static constexpr int AC = round128((long long)KT * LDO * 4);
  static constexpr int ks = 0, vs = TK, qs = 2 * TK, dos = qs + TQ;
  static constexpr int sc = dos + TQ, dp = sc + SC;
  static constexpr int dk = dp + SC, dv = dk + AC, st = dv + AC;
  static constexpr int total = st + round128(2 * SROWS * 4);
};

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ stats, float* __restrict__ dk,
                  float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                  Strides sdo, Strides sdk, Strides sdv, int H, int N,
                  float scale) {
  using L = DkvLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + L::ks);
  float* vs = reinterpret_cast<float*>(smem + L::vs);
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  float* dos = reinterpret_cast<float*>(smem + L::dos);
  float* sc = reinterpret_cast<float*>(smem + L::sc);  // then p
  float* dp = reinterpret_cast<float*>(smem + L::dp);  // then ds
  float* dk_acc = reinterpret_cast<float*>(smem + L::dk);
  float* dv_acc = reinterpret_cast<float*>(smem + L::dv);
  float* s_st = reinterpret_cast<float*>(smem + L::st);  // lse·log2 e, di

  const int tiles = (N + KT - 1) / KT, nt = (N + SROWS - 1) / SROWS;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * KT;
  const int b = bh / H, h = bh % H;
  const float c = __fmul_rn(scale, hop::LOG2E);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* st_bh = stats + (long long)bh * nt * 2 * SROWS;

  load_rows(ks, LD, k + b * sk.b + h * sk.h, sk.s, k0, KT, N);
  load_rows(vs, LD, v + b * sv.b + h * sv.h, sv.s, k0, KT, N);
  for (int e = threadIdx.x; e < KT * LDO; e += THREADS) {
    dk_acc[e] = 0.0f;
    dv_acc[e] = 0.0f;
  }
  for (int q0 = 0; q0 < N; q0 += QB) {
    __syncthreads();  // the previous step's products are done with the tiles
    load_rows(qs, LD, qb, sq.s, q0, QB, N);
    load_rows(dos, LD, dob, sdo.s, q0, QB, N);
    // the tile's statistics: rows past N hold +inf and 0, so p = 0 there
    for (int e = threadIdx.x; e < 2 * SROWS; e += THREADS)
      s_st[e] = st_bh[(q0 / SROWS) * 2 * SROWS + e];
    __syncthreads();
    block_gemm<float, true, false>(sc, L::LDS, qs, LD, ks, LD, QB, KT, D,
                                   false);
    block_gemm<float, true, false>(dp, L::LDS, dos, LD, vs, LD, QB, KT, D,
                                   false);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * KT; e += THREADS) {
      const int r = e / KT, j = e % KT;
      float pr = 0.0f, g = 0.0f;
      if (k0 + j < N) {
        pr = prob_lse2(sc[r * L::LDS + j], c, s_st[r]);
        g = dscore(dp[r * L::LDS + j], s_st[SROWS + r], pr, scale);
      }
      sc[r * L::LDS + j] = pr;  // in place: read, then written
      dp[r * L::LDS + j] = g;
    }
    __syncthreads();
    // dV += p^T dO and dK += ds^T Q: p and ds read as column-major (KT, QB)
    block_gemm<float, false, true>(dv_acc, LDO, sc, L::LDS, dos, LD, KT, D, QB,
                                   true);
    block_gemm<float, false, true>(dk_acc, LDO, dp, L::LDS, qs, LD, KT, D, QB,
                                   true);
  }
  __syncthreads();
  store_rows(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, LDO, 1.0f, k0, KT, N);
  store_rows(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, LDO, 1.0f, k0, KT, N);
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int dq_entry_f32(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dq, void* stats,
                 const long long* st, int B, int H, int N, float scale,
                 cudaStream_t stream) {
  using L = DqLayout;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + QT - 1) / QT);
  flash_bwd_dq_f32<<<(unsigned)blocks, THREADS, L::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(stats), at(st, 0),
      at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), at(st, 6), H, N,
      scale);
  return cudaGetLastError();
}

int dkv_entry_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* stats, void* dk, void* dv,
                  const long long* st, int B, int H, int N, float scale,
                  cudaStream_t stream) {
  using L = DkvLayout;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + KT - 1) / KT);
  flash_bwd_dkv_f32<<<(unsigned)blocks, THREADS, L::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(dk),
      static_cast<float*>(dv), at(st, 0), at(st, 1), at(st, 2), at(st, 3),
      at(st, 4), at(st, 5), H, N, scale);
  return cudaGetLastError();
}

bool takes(int N, int Dh) { return Dh == D && N >= 1; }

}  // namespace

// 11c. q, k, v, o, dout, dq: (B, H, N, D) with D = 64 contiguous, every
// other stride a multiple of 16 bytes and 16-byte-aligned bases; lse:
// (B, H, N) fp32; strides: 21 int64, (b, h, n) element strides of q, k, v,
// o, dout, dq and lse in turn; stats: the (B·H, ceil(N / 64), 2, 64) fp32
// scratch, contiguous and 16-byte aligned, written whole (each 64-row
// tile's lse·log2 e, then its di; rows past N +inf and 0); N >= 1.
extern "C" int lafs_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* stats,
    const long long* strides, int B, int H, int N, int Dh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(N, Dh)) return cudaErrorInvalidValue;
  return hopper::dq_entry(q, k, v, o, dout, lse, dq, stats, strides, B, H, N,
                          scale, static_cast<cudaStream_t>(stream));
}

extern "C" int lafs_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* stats,
    const long long* strides, int B, int H, int N, int Dh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(N, Dh)) return cudaErrorInvalidValue;
  return dq_entry_f32(q, k, v, o, dout, lse, dq, stats, strides, B, H, N,
                      scale, static_cast<cudaStream_t>(stream));
}

// 11b. q, k, v, dout, dk, dv as above; stats: 11c's scratch; strides: 18
// int64, of q, k, v, dout, dk and dv in turn.
extern "C" int lafs_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dk, void* dv, const long long* strides, int B,
    int H, int N, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(N, Dh)) return cudaErrorInvalidValue;
  return hopper::dkv_entry(q, k, v, dout, stats, dk, dv, strides, B, H, N,
                           scale, static_cast<cudaStream_t>(stream));
}

extern "C" int lafs_flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dk, void* dv, const long long* strides, int B,
    int H, int N, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(N, Dh)) return cudaErrorInvalidValue;
  return dkv_entry_f32(q, k, v, dout, stats, dk, dv, strides, B, H, N, scale,
                       static_cast<cudaStream_t>(stream));
}
