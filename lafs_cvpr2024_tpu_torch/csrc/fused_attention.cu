// Fused short-sequence attention forward (kernel 6 of the PyTorch/CUDA
// port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_attention.py
// (_fwd_kernel, called from _fwd_call), on (B, H, S, D) operands:
//     logits = (Q K^T) * scale           fp32 accumulate
//     A      = softmax(logits) in fp32   keys at or past S masked out; the
//                                        exact, normalised row softmax
//     O      = cast(A, V dtype) V        fp32 accumulate, cast to V dtype
// The operands may be strided views (the to_qkv output split into heads,
// D contiguous): the kernel reads them in place and writes O through its own
// strides, so the wrapper allocates O as (B, S, H, D) and the heads merge
// back without a copy.
//
// What bounds it on the card. At the supervised step's shape (B = 200,
// H = 11, S = 197, D = 64, bf16) Q, K, V and O are 4 x 55 MB = 222 MB a
// layer, 66 us at 3.35 TB/s, and the two products are 22 GFLOP, 22 us at
// the dense bf16 peak: bound by bytes. What the TPU kernel was for, and
// what this design keeps: the scores never reach device memory and the
// softmax runs in fp32.
//
// bf16, the Hopper design (sm90.cuh). One block of 160 threads per (b, h):
// a producer warp and one consumer warpgroup. The producer's elected lane
// issues TMA loads through 4-D tensor maps over the views' own strides: K
// and V of the whole sequence once (64-row tiles, zeros for rows at or past
// S), and the 64-row query tiles into a ring of 2 stages. The consumer walks
// the query tiles, one m64 wgmma tile each:
// - S <= 256 (the path's S = 197): the whole row of scores stays in
//   registers. S = Q K^T is NT m64nWk16 wgmmas (both operands K-major), NT
//   the row's 16-key slices (13 at S = 197: 104 fp32 a thread), the last key
//   tile cut to the next multiple of 16; NT is a template argument (one
//   kernel per NT, picked on the host), so no branch surrounds a wgmma.
//   Scale (into the log2 domain), mask keys at or past S to -inf, row max
//   and sum over the quad, exp2, divide, cast to bf16 pairs in registers:
//   they are the register A operand of P V, whose B operand is the V tile
//   read MN-major (the transpose bit).
// - 256 < S <= 512: the row does not fit; two sweeps over 64-key blocks,
//   the first for the row max and sum (online, fp32), the second
//   recomputing each block's scores, normalising with the final max and
//   sum, and accumulating P V. The same normalised A.
// O is cast to bf16, staged in a swizzled tile and stored by one TMA store
// over O's strides, which drops rows at or past S. Shared memory 89 KB at
// S <= 256, 153 KB above. Up to NT = 13 (S <= 208, the path's 197) two
// blocks share an SM and ptxas fits each in 168 registers; NT = 14-16 run
// one block an SM, whose rows need more registers (chip_smoke.py phase 1
// prints them all and fails on a spill). The ragged last query tile
// (5 real rows of 64 at S = 197) costs products and exps only: K and V are
// not read again; 59 of the 256 rows a block computes are empty, 23% of its
// products and softmax.
//
// fp32 keeps the first design: a block per (b, h) and 32 query rows, the
// (32, S) scores formed in shared memory, one warp per row for the softmax,
// FMA chains for the products. It is the precision check of the oracle and
// no main path runs it.

#include <utility>

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

// ----------------------------------------------------------------- bf16 --

namespace hopper {

using namespace lafs_sm90;
using namespace lafs_attn::hop;

constexpr int THREADS = 160;  // a consumer warpgroup and a producer warp

// Shared memory over nt 64-row tiles: K and V of the whole sequence, two Q
// stages, O's staging tile and the barriers, from a 1024-byte-aligned base.
struct Smem {
  int k, v, q, o, bar, total;
  __host__ __device__ explicit Smem(int nt)
      : k(0), v(nt * TILE), q(2 * nt * TILE), o(q + 2 * TILE), bar(o + TILE),
        total(bar + 64 + 1024) {}
};

// The exact softmax of this thread's two rows of a register-resident row
// of NT 16-key slices, in place: into the log2 domain (c = scale · log2 e),
// keys at or past S to -inf, max and sum over the quad, exp2, divided by
// the sum.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&sc)[NT * 8], int S,
                                             int quad, float c) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) {
    sc[i] = acc_col(i, quad) < S ? sc[i] * c : -INFINITY;
    mx[acc_half(i)] = fmaxf(mx[acc_half(i)], sc[i]);
  }
  quad_max(mx);
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) {
    sc[i] = ex2(sc[i] - mx[acc_half(i)]);  // masked keys: 0
    sum[acc_half(i)] += sc[i];
  }
  quad_sum(sum);
  const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) sc[i] *= inv[acc_half(i)];
}

// One query tile, the row in registers (NT > 0): O = softmax(Q K^T) V.
template <int NT>
__device__ __forceinline__ void tile_resident(float (&o)[32], uint32_t qa,
                                              uint32_t kb, uint32_t vb,
                                              uint32_t v_full,
                                              uint32_t q_empty, int S,
                                              int quad, float c) {
  float sc[NT * 8];
  wgmma_fence();
  mma_abt<NT>(sc, qa, kb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<NT * 8>(sc);
  mbar_arrive(q_empty);  // this warp has read Q
  softmax_rows<NT>(sc, S, quad, c);
  uint32_t p[NT][4];
  pack_all<NT>(sc, p);
  zero(o);
  mbar_wait(v_full, 0);
  reg_fence<32>(o);
  reg_fence(p);
  wgmma_fence();
  mma_pb<NT>(o, p, vb);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<32>(o);
}

// One query tile by two sweeps over the nt key blocks (S > 256).
__device__ __forceinline__ void tile_sweeps(float (&o)[32], uint32_t qa,
                                            uint32_t kb, uint32_t vb,
                                            uint32_t v_full, uint32_t q_empty,
                                            int S, int nt, int quad, float c) {
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        unused[2] = {0.0f, 0.0f};
  for (int j = 0; j < nt; ++j) {
    const int kn = min(ROWS, S - j * ROWS);
    by_width(kn, [&](auto w) {
      sweep_stats<decltype(w)::value, false>(m, l, unused, qa, kb + j * TILE,
                                             0, 0, kn, quad, c);
    });
  }
  quad_sum(l);
  const float il[2] = {1.0f / l[0], 1.0f / l[1]};
  zero(o);
  mbar_wait(v_full, 0);
  for (int j = 0; j < nt; ++j) {
    const int kn = min(ROWS, S - j * ROWS);
    by_width(kn, [&](auto w) {
      sweep_out<decltype(w)::value, false>(o, m, il, unused, qa,
                                           kb + j * TILE, 0, vb + j * TILE,
                                           kn, quad, c);
    });
  }
  mbar_arrive(q_empty);
}

// NT: the row's 16-key slices when the row stays in registers, 0 for the
// two sweeps. hs: bit i set when map i (q, k, v, o) is in (D, H, S, B) order.
// Two blocks an SM cap a thread at 168 registers (10 warps on 4 register
// files of 16,384); a row of more than 13 slices runs one block an SM.
template <int NT>
__global__ void __launch_bounds__(THREADS, NT <= 13 ? 2 : 1)
attn_fwd_bf16(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mo, int H, int S, int hs,
              float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int nt = (S + ROWS - 1) / ROWS;  // tiles of keys and of queries
  const Smem L(nt);
  const uint32_t k_full = base + L.bar, v_full = k_full + 8;
  auto q_full = [&](int s) { return k_full + 16 + 8 * s; };
  auto q_empty = [&](int s) { return k_full + 32 + 8 * s; };
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128) {
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: K, the first Q tile, V, then the rest
    if (lane == 0) {
      mbar_expect_tx(k_full, nt * TILE);
      for (int t = 0; t < nt; ++t)
        tma_load_rows(base + L.k + t * TILE, &mk, k_full, hs & 2, b, h,
                      t * ROWS);
      mbar_expect_tx(q_full(0), TILE);
      tma_load_rows(base + L.q, &mq, q_full(0), hs & 1, b, h, 0);
      mbar_expect_tx(v_full, nt * TILE);
      for (int t = 0; t < nt; ++t)
        tma_load_rows(base + L.v + t * TILE, &mv, v_full, hs & 4, b, h,
                      t * ROWS);
      for (int i = 1; i < nt; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(q_empty(s), ((i >> 1) - 1) & 1);
        mbar_expect_tx(q_full(s), TILE);
        tma_load_rows(base + L.q + s * TILE, &mq, q_full(s), hs & 1, b, h,
                      i * ROWS);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r and r + 8 of each tile
  const int r = 16 * warp + lane / 4, quad = lane % 4;
  const float c = scale * LOG2E;
  mbar_wait(k_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i & 1;
    const uint32_t qa = base + L.q + s * TILE;
    mbar_wait(q_full(s), (i >> 1) & 1);
    float o[32];
    if constexpr (NT > 0)
      tile_resident<NT>(o, qa, base + L.k, base + L.v, v_full, q_empty(s), S,
                        quad, c);
    else
      tile_sweeps(o, qa, base + L.k, base + L.v, v_full, q_empty(s), S, nt,
                  quad, c);
    store_tile(o, 1.0f, sbase + L.o, base + L.o, &mo, hs & 8, b, h, i * ROWS,
               r, quad);
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                        int, int, int, float);

// attn_fwd_bf16<n> for n = 0..16
template <int... N>
Kernel kernel_for(int n, std::integer_sequence<int, N...>) {
  static const Kernel table[] = {attn_fwd_bf16<N>...};
  return table[n];
}

int entry(const void* q, const void* k, const void* v, void* o,
          const long long* st, int B, int H, int S, float scale,
          cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  CUtensorMap m[4];
  int hs;
  cudaError_t err = maps(m, ptrs, st, 4, B, H, S, &hs);
  if (err != cudaSuccess) return err;
  const int slices = (S + 15) / 16;  // a row in registers up to 16 slices
  const Kernel kern = kernel_for(slices <= 16 ? slices : 0,
                                 std::make_integer_sequence<int, 17>{});
  const int smem = Smem((S + ROWS - 1) / ROWS).total;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((long long)B * H), THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], H, S, hs, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ----------------------------------------------------------------- fp32 --

constexpr int QT = 32;           // query rows per block
constexpr int LD = D + pad<float>();  // row stride of the shared tiles

// Shared-memory regions of one block: K or V (Sp, LD), Q (QT, LD), the
// scores (QT, Sp + 4), whose rows are overwritten with A.
struct FwdLayout {
  int Sp, lds, kv, q, sc, total;
  __host__ __device__ explicit FwdLayout(int S) {
    Sp = pad_seq(S);
    lds = Sp + 4;
    kv = 0;
    q = kv + round128((long long)Sp * LD * 4);
    sc = q + round128((long long)QT * LD * 4);
    total = sc + round128((long long)QT * max_i(lds, LDO) * 4);
  }
};

__global__ void __launch_bounds__(THREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int H, int S, float scale) {
  const FwdLayout L(S);
  extern __shared__ __align__(128) unsigned char smem[];
  float* kv = reinterpret_cast<float*>(smem + L.kv);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);

  const int tiles = (S + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(kv, LD, k + b * sk.b + h * sk.h, sk.s, 0, L.Sp, S);
  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, S);
  __syncthreads();
  block_gemm<float, true, false>(sc, L.lds, qs, LD, kv, LD, QT, L.Sp, D, false);
  __syncthreads();
  // V replaces K while the warps take the softmax of the score rows
  load_rows(kv, LD, v + b * sv.b + h * sv.h, sv.s, 0, L.Sp, S);
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * L.lds;  // read, then overwritten with A
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, __fmul_rn(row[j], scale));
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(__fsub_rn(__fmul_rn(row[j], scale), m));
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L.Sp; j += 32)
      row[j] = j < S ? __fdiv_rn(row[j], sum) : 0.0f;
  }
  __syncthreads();
  // O = A V, staged in the Q tile, which nothing reads any more
  block_gemm<float, true, true>(qs, LDO, sc, L.lds, kv, LD, QT, D, L.Sp, false);
  __syncthreads();
  store_rows(o + b * so.b + h * so.h, so.s, qs, LDO, 1.0f, q0, QT, S);
}

int entry_f32(const void* q, const void* k, const void* v, void* o,
              const long long* st, int B, int H, int S, float scale,
              cudaStream_t s) {
  const FwdLayout L(S);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((S + QT - 1) / QT);
  attn_fwd_f32<<<(unsigned)blocks, THREADS, L.total, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H, S,
      scale);
  return cudaGetLastError();
}

bool takes(int S, int Dh) { return Dh == D && S >= 1 && S <= MAX_S; }

}  // namespace

// q, k, v, o: (B, H, S, D) with D = 64 contiguous, every other stride a
// multiple of 16 bytes and 16-byte-aligned bases; strides: 12 int64,
// (b, h, s) element strides of q, k, v and o in turn; 1 <= S <= 512. The
// Python wrapper checks the same and raises before calling.
extern "C" int lafs_fused_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int B, int H,
                                         int S, int Dh, float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(S, Dh)) return cudaErrorInvalidValue;
  return hopper::entry(q, k, v, o, strides, B, H, S, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int lafs_fused_attention_f32(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int B, int H,
                                        int S, int Dh, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (!takes(S, Dh)) return cudaErrorInvalidValue;
  return entry_f32(q, k, v, o, strides, B, H, S, scale,
                   static_cast<cudaStream_t>(stream));
}
