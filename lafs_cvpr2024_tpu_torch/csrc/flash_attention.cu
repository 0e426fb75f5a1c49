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
// with segment ids; here keys at or past N are skipped inside the last
// block, and rows at or past N are neither read nor written, which gives the
// same function on the real rows. The operands may be strided views (the
// to_qkv output split into heads, D contiguous): the kernel reads them in
// place and writes O through its own strides.
//
// What bounds it on the card. At the SSL globals' shape (B = 64, H = 11,
// N = 197, D = 64, bf16) Q, K, V and O are 4 x 17.8 MB, 0.021 ms at
// 3.35 TB/s; the two products are 7 GFLOP, 0.007 ms at the dense bf16 peak:
// bound by bytes. What the TPU kernel was for, and what this design keeps:
// the (N, N) scores never reach device memory, whatever N is.
//
// One block owns one (b, h) and QT = 64 query rows, with Q staged once in
// shared memory. It walks the keys in blocks of KB = 64: K of the block into
// shared memory, the (QT, KB) fp32 scores there, each warp updates the
// running max and sum of whole rows and writes p = exp(s - m) cast to V's
// dtype, V replaces K in the same buffer, and P V lands in an fp32 tile that
// is added to the fp32 accumulator after rescaling it by exp(m_old - m). bf16
// products run on the tensor cores through nvcuda::wmma (16x16x16); fp32
// runs FMA chains (the oracle's precision check). Right and simple first:
// wgmma, TMA and a pipelined K/V stream are later work.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

constexpr int QT = 64;  // query rows per block
constexpr int KB = 64;  // keys per step

// Shared-memory regions: Q (QT, LD), K or V (KB, LD), the fp32 scores
// (QT, KB + 4), P (QT, KB + pad) in T (aliasing the scores for fp32), the
// fp32 P V tile and accumulator (QT, LDO each), and the row statistics.
template <typename T>
struct FwdLayout {
  static constexpr int LD = D + pad<T>();
  static constexpr int LDS = KB + 4;
  static constexpr int LDP = is_f32<T>() ? LDS : KB + pad<T>();
  static constexpr int TQ = round128((long long)QT * LD * sizeof(T));
  static constexpr int TK = round128((long long)KB * LD * sizeof(T));
  static constexpr int SC = round128((long long)QT * LDS * 4);
  static constexpr int PB =
      is_f32<T>() ? 0 : round128((long long)QT * LDP * sizeof(T));
  static constexpr int AC = round128((long long)QT * LDO * 4);
  static constexpr int q = 0, kv = q + TQ, sc = kv + TK, p = sc + SC;
  static constexpr int pv = p + PB, acc = pv + AC, st = acc + AC;
  static constexpr int total = st + round128(3 * QT * 4);
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int N, float scale) {
  using L = FwdLayout<T>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* kv = reinterpret_cast<T*>(smem + L::kv);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  T* p = is_f32<T>() ? reinterpret_cast<T*>(sc)
                     : reinterpret_cast<T*>(smem + L::p);
  float* pv = reinterpret_cast<float*>(smem + L::pv);
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  float* row_m = reinterpret_cast<float*>(smem + L::st);
  float* row_l = row_m + QT;
  float* row_a = row_l + QT;

  const int tiles = (N + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

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
    block_gemm<T, true, false>(sc, L::LDS, qs, LD, kv, LD, QT, KB, D, false);
    __syncthreads();
    // V replaces K while the warps update the row statistics
    load_rows(kv, LD, vb, sv.s, k0, KB, N);
    const int kn = min(KB, N - k0);  // real keys in this block
    for (int r = warp; r < QT; r += WARPS) {
      float* row = sc + r * L::LDS;
      float mb = -INFINITY;
      for (int j = lane; j < kn; j += 32)
        mb = fmaxf(mb, __fmul_rn(row[j], scale));
      mb = warp_max(mb);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mb);
      float sum = 0.0f;
      T* prow = p + r * L::LDP;  // the same row for fp32: read, then written
      for (int j = lane; j < KB; j += 32) {
        float e = 0.0f;
        if (j < kn) e = expf(__fsub_rn(__fmul_rn(row[j], scale), m_new));
        sum += e;
        store(prow + j, e);
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
    block_gemm<T, true, true>(pv, LDO, p, L::LDP, kv, LD, QT, D, KB, false);
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

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o, void* lse,
          const long long* st, int B, int H, int N, int Dh, float scale,
          void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || N < 1) return cudaErrorInvalidValue;
  using L = FwdLayout<T>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + QT - 1) / QT);
  flash_fwd_kernel<T><<<(unsigned)blocks, THREADS, L::total,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H, N,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, N, D) with D = 64 contiguous and every other stride a
// multiple of 16 bytes; lse: (B, H, N) fp32, contiguous; strides: 12 int64,
// (b, h, n) element strides of q, k, v and o in turn; N >= 1. The Python
// wrapper checks the same and raises before calling.
extern "C" int lafs_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int B,
                                         int H, int N, int Dh, float scale,
                                         void* stream) {
  return entry<bf16>(q, k, v, o, lse, strides, B, H, N, Dh, scale, stream);
}

extern "C" int lafs_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const long long* strides, int B, int H,
                                        int N, int Dh, float scale,
                                        void* stream) {
  return entry<float>(q, k, v, o, lse, strides, B, H, N, Dh, scale, stream);
}
