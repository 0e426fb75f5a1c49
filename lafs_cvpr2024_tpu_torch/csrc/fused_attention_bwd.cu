// Fused short-sequence attention backward (kernel 7 of the PyTorch/CUDA
// port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_attention.py
// (_bwd_kernel, called from _bwd_call). From Q, K, V and dO alone (the
// forward saves nothing else) it recomputes the fp32 probabilities A and
// forms, as the JAX kernel does:
//     dV = cast(A) ^T dO                  fp32 accumulate
//     dA = dO V^T                         fp32
//     dS = A (dA - rowsum(dA A))          from the recomputed fp32 A and dA,
//                                         not flash attention's rowsum(dO O)
//     dQ = scale * (cast(dS) K)           dS cast to Q's dtype
//     dK = scale * (cast(dS) ^T Q)
// Operands and results may be strided views with D contiguous, as in the
// forward (fused_attention.cu).
//
// What bounds it on the card. At B = 200, H = 11, S = 197, D = 64 in bf16,
// Q, K, V, dO in and dQ, dK, dV out are 7 x 55 MB = 388 MB a layer
// (116 us at 3.35 TB/s), and the products are ~55 GFLOP with the
// recomputed scores (56 us at the dense bf16 peak): bound by bytes. Kept
// from the TPU kernel: no score tensor in device memory.
//
// dK and dV sum over all queries, and CUDA blocks run in no order; the TPU
// kernel's one grid step per batch element held the whole (H, S, S) problem
// in VMEM. Here two passes, both deterministic, without atomics (each
// output element is written by one block), joined by a scratch of each
// query row's statistics.
//
// bf16, the Hopper design (sm90.cuh): blocks of 160 threads, a producer
// warp whose elected lane issues TMA loads through 4-D tensor maps over the
// views' own strides (zeros for rows at or past S) and one consumer
// warpgroup whose products are wgmmas with the accumulators in registers;
// results are staged in swizzled tiles and written by TMA stores, which
// drop rows at or past S. Exponentials are exp2 of logits scaled by
// scale · log2 e.
//   1. dq pass, one block per (b, h): K and V of the whole sequence loaded
//      once, Q and dO in 64-row query tiles through a ring of 2 stages. For
//      each query tile, two sweeps over 64-key blocks (the last cut to the
//      next multiple of 16; one templated body per width, so no branch
//      surrounds a wgmma), each block's S = Q K^T and dA = dO V^T in
//      registers (32 fp32 each): the first sweep keeps the online row max m
//      and the rescaled sums l = sum p and d = sum p dA, so that
//      rowsum(dA A) = d / l from the fp32 A and dA; the second recomputes
//      S and dA, forms A = 2^(s - m) / l and dS, casts dS to bf16 pairs in
//      registers (the register A operand) and adds dS K with K read MN-major
//      from its tile. dQ (32 fp32 a thread) is scaled and stored. The row's
//      m, 1/l and rowsum go to a (B·H, tiles, 3, 64) fp32 scratch, padded
//      rows included (Q and dO are zeros there: finite values).
//   2. dkv pass, one block per (b, h, 64 keys): K and V of those keys loaded
//      once, Q, dO and the query tile's 768 bytes of statistics (one bulk
//      copy) through a ring of 3 stages. For each query tile (cut to a
//      multiple of 16): S^T = K Q^T and dA^T = V dO^T in registers,
//      A^T = 2^(s - m) / l from the statistics, with query columns and key
//      rows at or past S set to exactly 0 by a select (no 0 · Inf),
//      dS^T = A^T (dA^T - rowsum); then dV += cast(A^T) dO and
//      dK += cast(dS^T) Q, both A operands from registers and dO and Q read
//      MN-major. dK and dV (64 fp32 a thread together) are stored at the end
//      through the K and V tiles' shared memory.
// Shared memory 105 KB (dq, S <= 256; 169 KB up to 512) and 68 KB (dkv);
// 154 and 168 registers, no spills: two blocks an SM. A is not bit for bit the same in the two passes (each
// wgmma sums in its own order); the bar is the plain version's tolerance.
//
// fp32 keeps the first design, FMA chains through shared memory: a dq pass
// per (b, h, 32 or 16 query rows) writing a (3, B·H, S) scratch, and a dkv
// pass per (b, h, 32 keys) that walks the queries in 32-row steps and
// recomputes A and dS bit for bit from it. It is the precision check of the
// oracle and no main path runs it.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

// ----------------------------------------------------------------- bf16 --

namespace hopper {

using namespace lafs_sm90;
using namespace lafs_attn::hop;

constexpr int THREADS = 160;  // a consumer warpgroup and a producer warp

constexpr int STATS = 3 * ROWS * 4;  // bytes of one query tile's m, 1/l, rowsum

// dq pass shared memory over nt tiles: K and V of the whole sequence, two
// stages of (Q, dO), dQ's staging tile and the barriers.
struct DqSmem {
  int k, v, q, o, bar, total;
  __host__ __device__ explicit DqSmem(int nt)
      : k(0), v(nt * TILE), q(2 * nt * TILE), o(q + 4 * TILE), bar(o + TILE),
        total(bar + 64 + 1024) {}
};

// hs: bit i set when map i (q, k, v, do, dq) is in (D, H, S, B) order
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const __grid_constant__ CUtensorMap mdq,
                 float* __restrict__ stats, int H, int S, int hs,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int nt = (S + ROWS - 1) / ROWS;
  const DqSmem L(nt);
  const uint32_t k_full = base + L.bar, v_full = k_full + 8;
  auto full = [&](int s) { return k_full + 16 + 8 * s; };
  auto empty = [&](int s) { return k_full + 32 + 8 * s; };
  auto stage = [&](int s) { return base + L.q + s * 2 * TILE; };  // Q, dO
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128) {
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: K, the first stage, V, then the rest
    if (lane == 0) {
      auto load_stage = [&](int i) {
        const int s = i & 1;
        mbar_expect_tx(full(s), 2 * TILE);
        tma_load_rows(stage(s), &mq, full(s), hs & 1, b, h, i * ROWS);
        tma_load_rows(stage(s) + TILE, &mdo, full(s), hs & 8, b, h, i * ROWS);
      };
      mbar_expect_tx(k_full, nt * TILE);
      for (int t = 0; t < nt; ++t)
        tma_load_rows(base + L.k + t * TILE, &mk, k_full, hs & 2, b, h,
                      t * ROWS);
      load_stage(0);
      mbar_expect_tx(v_full, nt * TILE);
      for (int t = 0; t < nt; ++t)
        tma_load_rows(base + L.v + t * TILE, &mv, v_full, hs & 4, b, h,
                      t * ROWS);
      for (int i = 1; i < nt; ++i) {
        if (i >= 2) mbar_wait(empty(i & 1), ((i >> 1) - 1) & 1);
        load_stage(i);
      }
    }
    return;
  }

  const int r = 16 * warp + lane / 4, quad = lane % 4;
  const float c = scale * LOG2E;
  mbar_wait(k_full, 0);
  mbar_wait(v_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i & 1;
    const uint32_t qa = stage(s), doa = stage(s) + TILE;
    mbar_wait(full(s), (i >> 1) & 1);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
          d[2] = {0.0f, 0.0f};
    for (int j = 0; j < nt; ++j) {
      const int kn = min(ROWS, S - j * ROWS);
      by_width(kn, [&](auto w) {
        sweep_stats<decltype(w)::value, true>(m, l, d, qa,
                                              base + L.k + j * TILE, doa,
                                              base + L.v + j * TILE, kn, quad,
                                              c);
      });
    }
    quad_sum(l);
    quad_sum(d);
    const float il[2] = {1.0f / l[0], 1.0f / l[1]};
    const float dd[2] = {d[0] * il[0], d[1] * il[1]};  // rowsum(dA A)
    float dq[32];
    zero(dq);
    for (int j = 0; j < nt; ++j) {
      const int kn = min(ROWS, S - j * ROWS);
      by_width(kn, [&](auto w) {
        sweep_out<decltype(w)::value, true>(dq, m, il, dd, qa,
                                            base + L.k + j * TILE, doa,
                                            base + L.v + j * TILE, kn, quad,
                                            c);
      });
    }
    mbar_arrive(empty(s));
    if (quad == 0) {
      float* st = stats + ((long long)bh * nt + i) * 3 * ROWS;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        st[r + 8 * e] = m[e];
        st[ROWS + r + 8 * e] = il[e];
        st[2 * ROWS + r + 8 * e] = dd[e];
      }
    }
    store_tile(dq, scale, sbase + L.o, base + L.o, &mdq, hs & 16, b, h,
               i * ROWS, r, quad);
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

constexpr int DKV_STAGES = 3;
constexpr int DKV_STAGE = 2 * TILE + 1024;  // Q, dO, statistics (+ padding)

// dkv pass shared memory: K and V of the block's keys (then dK's and dV's
// staging), the stages of (Q, dO, statistics), the barriers.
struct DkvSmem {
  static constexpr int k = 0, v = TILE, stages = 2 * TILE;
  static constexpr int bar = stages + DKV_STAGES * DKV_STAGE;
  static constexpr int total = bar + 64 + 1024;
};

// One query tile of W columns (qn real) against the block's 64 keys (kn
// real): S^T, dA^T, A^T and dS^T in registers, then dV += A^T dO and
// dK += dS^T Q. `stat`: the tile's m, 1/l, rowsum (64 floats each).
template <int W>
__device__ __forceinline__ void dkv_step(float (&dk)[32], float (&dv)[32],
                                         uint32_t ka, uint32_t va,
                                         uint32_t qb, uint32_t dob,
                                         const float* stat, int qn, int kn,
                                         int r, int quad, float c) {
  constexpr int NT = W / 16, R = W / 2;
  float st[R], dat[R];
  wgmma_fence();
  mma_abt<NT>(st, ka, qb);
  mma_abt<NT>(dat, va, dob);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R>(st);
  reg_fence<R>(dat);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = acc_col(i, quad);
    const bool real = col < qn && r + 8 * acc_half(i) < kn;
    const float a =
        real ? ex2(st[i] * c - stat[col]) * stat[ROWS + col] : 0.0f;
    dat[i] = a * (dat[i] - stat[2 * ROWS + col]);
    st[i] = a;
  }
  uint32_t pa[NT][4], pd[NT][4];
  pack_all<NT>(st, pa);
  pack_all<NT>(dat, pd);
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
attn_bwd_dkv_bf16(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdo,
                  const __grid_constant__ CUtensorMap mdk,
                  const __grid_constant__ CUtensorMap mdv,
                  const float* __restrict__ stats, int H, int S, int hs,
                  float scale) {
  using L = DkvSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int nt = (S + ROWS - 1) / ROWS;
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
        bulk_load(at + 2 * TILE, stats + ((long long)bh * nt + i) * 3 * ROWS,
                  STATS, full(s));
      }
    }
    return;
  }

  const int r = 16 * warp + lane / 4, quad = lane % 4;
  const int kn = min(ROWS, S - kt * ROWS);  // real keys of the block
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
    const int qn = min(ROWS, S - i * ROWS);  // real queries of the tile
    mbar_wait(full(s), (i / DKV_STAGES) & 1);
    by_width(qn, [&](auto w) {
      dkv_step<decltype(w)::value>(dk, dv, base + L::k, base + L::v, at,
                                   at + TILE, stat, qn, kn, r, quad, c);
    });
    mbar_arrive(empty(s));
  }
  // K and V are read: their tiles stage dK and dV
  store_tile(dk, scale, sbase + L::k, base + L::k, &mdk, hs & 16, b, h,
             kt * ROWS, r, quad);
  store_tile(dv, 1.0f, sbase + L::v, base + L::v, &mdv, hs & 32, b, h,
             kt * ROWS, r, quad);
  if (threadIdx.x == 0) tma_store_wait_read();
}

int entry(const void* q, const void* k, const void* v, const void* dout,
          void* dq, void* dk, void* dv, void* stats, const long long* st,
          int B, int H, int S, float scale, cudaStream_t stream) {
  // maps: q, k, v, do, dq, dk, dv (the strides' order)
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  CUtensorMap m[7];
  int hs;
  cudaError_t err = maps(m, ptrs, st, 7, B, H, S, &hs);
  if (err != cudaSuccess) return err;
  const int nt = (S + ROWS - 1) / ROWS;
  const long long bh = (long long)B * H;
  float* fst = static_cast<float*>(stats);

  const int smem1 = DqSmem(nt).total;
  err = cudaFuncSetAttribute(attn_bwd_dq_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_bf16<<<(unsigned)bh, THREADS, smem1, stream>>>(
      m[0], m[1], m[2], m[3], m[4], fst, H, S, hs & 31, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the dkv pass's bits: q, k, v, do as above, then dk, dv
  const int hs2 = (hs & 15) | ((hs >> 5) & 3) << 4;
  err = cudaFuncSetAttribute(attn_bwd_dkv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvSmem::total);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_bf16<<<(unsigned)(bh * nt), THREADS, DkvSmem::total, stream>>>(
      m[0], m[1], m[2], m[3], m[5], m[6], fst, H, S, hs2, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ----------------------------------------------------------------- fp32 --

constexpr int KT = 32;  // key rows per block of the dkv pass
constexpr int QB = 32;  // query rows per step of the dkv pass
constexpr int LD = D + pad<float>();  // row stride of the shared tiles

// dq pass regions: V then K (Sp, LD), Q and dO (QT, LD), the scores and dA
// (QT, Sp + 4 each; the scores also the (QT, LDO) dQ staging tile), and
// dS written over dA.
struct DqLayout {
  int Sp, qt, lds, kv, q, dout, sc, da, total;
  __host__ __device__ explicit DqLayout(int S) {
    Sp = pad_seq(S);
    qt = Sp <= 256 ? 32 : 16;
    lds = Sp + 4;
    kv = 0;
    q = kv + round128((long long)Sp * LD * 4);
    dout = q + round128((long long)qt * LD * 4);
    sc = dout + round128((long long)qt * LD * 4);
    da = sc + round128((long long)qt * max_i(lds, LDO) * 4);
    total = da + round128((long long)qt * lds * 4);
  }
};

__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                float* __restrict__ dq, float* __restrict__ stats, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdq, int BH,
                int H, int S, float scale) {
  const DqLayout L(S);
  const int QT = L.qt;
  extern __shared__ __align__(128) unsigned char smem[];
  float* kv = reinterpret_cast<float*>(smem + L.kv);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* dos = reinterpret_cast<float*>(smem + L.dout);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* da = reinterpret_cast<float*>(smem + L.da);

  const int tiles = (S + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(kv, LD, v + b * sv.b + h * sv.h, sv.s, 0, L.Sp, S);
  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, S);
  load_rows(dos, LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, QT, S);
  __syncthreads();
  block_gemm<float, true, false>(da, L.lds, dos, LD, kv, LD, QT, L.Sp, D,
                                 false);
  __syncthreads();
  load_rows(kv, LD, k + b * sk.b + h * sk.h, sk.s, 0, L.Sp, S);
  __syncthreads();
  block_gemm<float, true, false>(sc, L.lds, qs, LD, kv, LD, QT, L.Sp, D, false);
  __syncthreads();
  float* st_m = stats + (long long)bh * S;
  float* st_l = st_m + (long long)BH * S;
  float* st_d = st_l + (long long)BH * S;
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * L.lds;
    float* drow = da + r * L.lds;  // dA, read, then overwritten with dS
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, __fmul_rn(row[j], scale));
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32)
      sum += expf(__fsub_rn(__fmul_rn(row[j], scale), m));
    sum = warp_sum(sum);
    float dsum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float a = prob(row[j], scale, m, sum);
      row[j] = a;
      dsum += drow[j] * a;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < L.Sp; j += 32)
      drow[j] = j < S ? dlogit(row[j], drow[j], dsum) : 0.0f;
    if (lane == 0 && q0 + r < S) {
      st_m[q0 + r] = m;
      st_l[q0 + r] = sum;
      st_d[q0 + r] = dsum;
    }
  }
  __syncthreads();
  // dQ = dS K, staged in the Q tile, which nothing reads any more
  block_gemm<float, true, true>(qs, LDO, da, L.lds, kv, LD, QT, D, L.Sp, false);
  __syncthreads();
  store_rows(dq + b * sdq.b + h * sdq.h, sdq.s, qs, LDO, scale, q0, QT, S);
}

// dkv pass regions: K and V of the block's key rows, Q and dO of the query
// step (32, LD each), the scores and dA (32, KT + 4; overwritten with A
// and dS), the dK and dV sums (KT, LDO), and the step's row statistics.
struct DkvLayout {
  static constexpr int LDS = KT + 4;
  static constexpr int TILE = round128((long long)32 * LD * 4);
  static constexpr int SC = round128((long long)QB * LDS * 4);
  static constexpr int ACC = round128((long long)KT * LDO * 4);
  static constexpr int ks = 0, vs = TILE, qs = 2 * TILE, dos = 3 * TILE;
  static constexpr int sc = 4 * TILE, da = sc + SC;
  static constexpr int dk = da + SC, dv = dk + ACC, st = dv + ACC;
  static constexpr int total = st + round128(3 * QB * 4);
};

__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 float* __restrict__ dk, float* __restrict__ dv,
                 const float* __restrict__ stats, Strides sq, Strides sk,
                 Strides sv, Strides sdo, Strides sdk, Strides sdv, int BH,
                 int H, int S, float scale) {
  using L = DkvLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + L::ks);
  float* vs = reinterpret_cast<float*>(smem + L::vs);
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  float* dos = reinterpret_cast<float*>(smem + L::dos);
  float* sc = reinterpret_cast<float*>(smem + L::sc);  // then A
  float* da = reinterpret_cast<float*>(smem + L::da);  // then dS
  float* dk_acc = reinterpret_cast<float*>(smem + L::dk);
  float* dv_acc = reinterpret_cast<float*>(smem + L::dv);
  float* row_m = reinterpret_cast<float*>(smem + L::st);
  float* row_l = row_m + QB;
  float* row_d = row_l + QB;

  const int tiles = (S + KT - 1) / KT;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * KT;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* st_m = stats + (long long)bh * S;
  const float* st_l = st_m + (long long)BH * S;
  const float* st_d = st_l + (long long)BH * S;

  load_rows(ks, LD, k + b * sk.b + h * sk.h, sk.s, k0, KT, S);
  load_rows(vs, LD, v + b * sv.b + h * sv.h, sv.s, k0, KT, S);
  for (int e = threadIdx.x; e < KT * LDO; e += THREADS) {
    dk_acc[e] = 0.0f;
    dv_acc[e] = 0.0f;
  }
  for (int q0 = 0; q0 < S; q0 += QB) {
    __syncthreads();  // the previous step's products are done with the tiles
    load_rows(qs, LD, qb, sq.s, q0, QB, S);
    load_rows(dos, LD, dob, sdo.s, q0, QB, S);
    for (int r = threadIdx.x; r < QB; r += THREADS) {
      // rows past S: zero Q and dO, and statistics that keep A finite
      const bool real = q0 + r < S;
      row_m[r] = real ? st_m[q0 + r] : 0.0f;
      row_l[r] = real ? st_l[q0 + r] : 1.0f;
      row_d[r] = real ? st_d[q0 + r] : 0.0f;
    }
    __syncthreads();
    block_gemm<float, true, false>(sc, L::LDS, qs, LD, ks, LD, QB, KT, D,
                                   false);
    block_gemm<float, true, false>(da, L::LDS, dos, LD, vs, LD, QB, KT, D,
                                   false);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * KT; e += THREADS) {
      const int r = e / KT, j = e % KT;
      float a = 0.0f, g = 0.0f;
      if (k0 + j < S) {
        a = prob(sc[r * L::LDS + j], scale, row_m[r], row_l[r]);
        g = dlogit(a, da[r * L::LDS + j], row_d[r]);
      }
      sc[r * L::LDS + j] = a;  // in place: read, then written
      da[r * L::LDS + j] = g;
    }
    __syncthreads();
    // dV += A^T dO and dK += dS^T Q: A and dS read as column-major (KT, QB)
    block_gemm<float, false, true>(dv_acc, LDO, sc, L::LDS, dos, LD, KT, D, QB,
                                   true);
    block_gemm<float, false, true>(dk_acc, LDO, da, L::LDS, qs, LD, KT, D, QB,
                                   true);
  }
  __syncthreads();
  store_rows(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, LDO, scale, k0, KT, S);
  store_rows(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, LDO, 1.0f, k0, KT, S);
}

int entry_f32(const void* q, const void* k, const void* v, const void* dout,
              void* dq, void* dk, void* dv, void* stats, const long long* st,
              int B, int H, int S, float scale, cudaStream_t s) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const int BH = B * H;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  float* fst = static_cast<float*>(stats);

  const DqLayout L1(S);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, L1.total);
  if (err != cudaSuccess) return err;
  const long long b1 = (long long)BH * ((S + L1.qt - 1) / L1.qt);
  attn_bwd_dq_f32<<<(unsigned)b1, THREADS, L1.total, s>>>(
      tq, tk, tv, tdo, static_cast<float*>(dq), fst, sq, sk, sv, sdo, sdq, BH,
      H, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using L2 = DkvLayout;
  err = cudaFuncSetAttribute(attn_bwd_dkv_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L2::total);
  if (err != cudaSuccess) return err;
  const long long b2 = (long long)BH * ((S + KT - 1) / KT);
  attn_bwd_dkv_f32<<<(unsigned)b2, THREADS, L2::total, s>>>(
      tq, tk, tv, tdo, static_cast<float*>(dk), static_cast<float*>(dv), fst,
      sq, sk, sv, sdo, sdk, sdv, BH, H, S, scale);
  return cudaGetLastError();
}

bool takes(int S, int Dh) { return Dh == D && S >= 1 && S <= MAX_S; }

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, S, D) with D = 64 contiguous, every
// other stride a multiple of 16 bytes and 16-byte-aligned bases; strides:
// 21 int64, (b, h, s) element strides of q, k, v, dout, dq, dk and dv in
// turn; stats: fp32 scratch of 3 * B * H * 64 * ceil(S / 64) elements,
// 16-byte aligned (bf16: (B·H, tiles, 3, 64); fp32: (3, B·H, S)); 1 <= S <=
// 512. Two kernels on `stream`, in order.
extern "C" int lafs_fused_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, const long long* strides, int B, int H,
    int S, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(S, Dh)) return cudaErrorInvalidValue;
  return hopper::entry(q, k, v, dout, dq, dk, dv, stats, strides, B, H, S,
                       scale, static_cast<cudaStream_t>(stream));
}

extern "C" int lafs_fused_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, const long long* strides, int B, int H,
    int S, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(S, Dh)) return cudaErrorInvalidValue;
  return entry_f32(q, k, v, dout, dq, dk, dv, stats, strides, B, H, S, scale,
                   static_cast<cudaStream_t>(stream));
}
