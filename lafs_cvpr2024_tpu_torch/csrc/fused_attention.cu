// Fused short-sequence attention forward (kernel 6 of the PyTorch/CUDA
// port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_attention.py
// (_fwd_kernel, called from _fwd_call), on (B, H, S, D) operands:
//     logits = (Q K^T) * scale           fp32 accumulate
//     A      = softmax(logits) in fp32   keys at or past S masked out
//     O      = cast(A, V dtype) V        fp32 accumulate, cast to V dtype
// The operands may be strided views (the to_qkv output split into heads,
// D contiguous): the kernel reads them in place and writes O through its own
// strides, so the wrapper allocates O as (B, S, H, D) and the heads merge
// back without a copy.
//
// What bounds it on the card. At the supervised step's shape (B = 200,
// H = 11, S = 197, D = 64, bf16) Q, K, V and O are 4 x 55 MB = 222 MB a
// layer, 66 us at 3.35 TB/s, and the two products are 22 GFLOP, 22 us at
// the dense bf16 peak: bound by bytes. The einsum path adds the (B, H, S, S)
// scores, written and read back in bf16 by each of its passes (171 MB a
// pass), and its head split and merge copies. What the TPU kernel was for,
// and what this design keeps: the scores never reach device memory and the
// softmax runs in fp32.
//
// The TPU kernel holds every head's (S, S) scores of one batch element in
// VMEM (~2.9 MB at S = 256); a block here has at most 227 KB. So a block
// owns one (b, h) and a tile of QT = 32 query rows: K of the whole sequence
// is staged in shared memory (S padded to a multiple of 16 with zero rows),
// the (QT, S) fp32 score tile is formed there, each warp takes the softmax of
// whole rows (max and sum in fp32, masked keys skipped), then V replaces K in
// the same buffer and P V accumulates into fp32 tiles. 75 KB at S = 197
// (three blocks per SM), 15,400 blocks a layer. bf16 products run on the
// tensor cores through nvcuda::wmma (16x16x16); fp32 runs FMA chains. K and
// V of a (b, h) are read once per query tile, from L2 after the first.
// Right and simple first: wgmma, TMA and a pipelined K/V stream are later
// work.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

constexpr int QT = 32;  // query rows per block

// Shared-memory regions of one block: K or V (Sp, LD), Q (QT, LD), the fp32
// scores (QT, Sp + 4) also used as the (QT, LDO) output staging tile, and P
// (QT, Sp + pad) in T, which aliases the scores for fp32.
template <typename T>
struct FwdLayout {
  static constexpr int LD = D + pad<T>();
  int Sp, lds, ldp, kv, q, sc, p, total;
  __host__ __device__ FwdLayout(int S) {
    Sp = pad_seq(S);
    lds = Sp + 4;
    ldp = is_f32<T>() ? lds : Sp + pad<T>();
    kv = 0;
    q = kv + round128((long long)Sp * LD * sizeof(T));
    sc = q + round128((long long)QT * LD * sizeof(T));
    p = sc + round128((long long)QT * max_i(lds, LDO) * 4);
    total = is_f32<T>() ? p : p + round128((long long)QT * ldp * sizeof(T));
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, Strides sq,
                Strides sk, Strides sv, Strides so, int H, int S, float scale) {
  const FwdLayout<T> L(S);
  constexpr int LD = FwdLayout<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem + L.kv);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  T* p = is_f32<T>() ? reinterpret_cast<T*>(sc)
                     : reinterpret_cast<T*>(smem + L.p);

  const int tiles = (S + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(kv, LD, k + b * sk.b + h * sk.h, sk.s, 0, L.Sp, S);
  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, S);
  __syncthreads();
  block_gemm<T, true, false>(sc, L.lds, qs, LD, kv, LD, QT, L.Sp, D, false);
  __syncthreads();
  // V replaces K while the warps take the softmax of the score rows
  load_rows(kv, LD, v + b * sv.b + h * sv.h, sv.s, 0, L.Sp, S);
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * L.lds;
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
    T* prow = p + r * L.ldp;  // the same row for fp32: read, then written
    for (int j = lane; j < L.Sp; j += 32)
      store(prow + j, j < S ? __fdiv_rn(row[j], sum) : 0.0f);
  }
  __syncthreads();
  // O = P V, staged in fp32 where nothing is read any more: the scores for
  // bf16 (P has its own buffer), the Q tile for fp32 (P aliases the scores)
  float* os = is_f32<T>() ? reinterpret_cast<float*>(qs) : sc;
  block_gemm<T, true, true>(os, LDO, p, L.ldp, kv, LD, QT, D, L.Sp, false);
  __syncthreads();
  store_rows(o + b * so.b + h * so.h, so.s, os, LDO, 1.0f, q0, QT, S);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int S, float scale,
                   cudaStream_t s) {
  const FwdLayout<T> L(S);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((S + QT - 1) / QT);
  attn_fwd_kernel<T><<<(unsigned)blocks, THREADS, L.total, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, H, S, scale);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o,
          const long long* strides, int B, int H, int S, int Dh, float scale,
          void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || S < 1 || S > MAX_S) return cudaErrorInvalidValue;
  return launch<T>(q, k, v, o, strides, B, H, S, scale,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, o: (B, H, S, D) with D = 64 contiguous and every other stride a
// multiple of 16 bytes; strides: 12 int64, (b, h, s) element strides of q,
// k, v and o in turn; 1 <= S <= 512. The Python wrapper checks the same and
// raises before calling.
extern "C" int lafs_fused_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int B, int H,
                                         int S, int Dh, float scale,
                                         void* stream) {
  return entry<bf16>(q, k, v, o, strides, B, H, S, Dh, scale, stream);
}

extern "C" int lafs_fused_attention_f32(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int B, int H,
                                        int S, int Dh, float scale,
                                        void* stream) {
  return entry<float>(q, k, v, o, strides, B, H, S, Dh, scale, stream);
}
