// Flash attention backward (kernels 11b and 11c of the PyTorch/CUDA port).
//
// Replace the two backward Pallas TPU kernels behind
// lafs_cvpr2024_tpu/models/layers.py::_flash_attention, in JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   11b  _flash_attention_dkv_kernel (launched by _flash_attention_bwd_dkv)
//   11c  _flash_attention_dq_kernel  (launched by _flash_attention_bwd_dq)
// From Q, K, V, dO, the forward's per-row logsumexp and di = rowsum(O dO)
// (computed outside, as the JAX VJP computes it with XLA) both recompute
//     p  = exp(s * scale - lse)                   fp32
//     dp = dO V^T                                 fp32
//     ds = (dp - di) * p * scale                  fp32
// and form, as the JAX kernels do, with p and ds cast to the operands' dtype
// before their products (fp32 accumulate):
//     11b: dV = sum over query blocks of cast(p)^T dO, dK = cast(ds)^T Q
//     11c: dQ = sum over key blocks of cast(ds) K
// Keys at or past N are skipped in the last block; query rows past N enter
// as zero rows with p = 0 (lse = +inf), so they add nothing; no row past N is
// read or written. Operands and results may be strided views with D
// contiguous, as in the forward (flash_attention.cu).
//
// What bounds them on the card. At B = 64, H = 11, N = 197, D = 64 in bf16
// the backward reads Q, K, V, dO (4 x 17.8 MB) and writes dQ, dK, dV
// (3 x 17.8 MB), 0.037 ms at 3.35 TB/s together; the products with the
// recomputed scores are ~17 GFLOP, 0.018 ms: bound by bytes. Kept from the
// TPU kernels: no (N, N) tensor in device memory.
//
// Two kernels and no atomics, as the library has: each block owns one
// output tile and loops over the other sequence axis in order, so the sums
// come out the same in every run (the exact-resume check of the training CLI
// relies on it).
//   11b: one block per (b, h, KT = 32 key rows); K and V stay in shared
//        memory, the query blocks of QB = 64 rows stream through, dK and dV
//        accumulate in fp32 shared memory.
//   11c: one block per (b, h, QT = 32 query rows); Q and dO stay, the key
//        blocks of KB = 64 stream through, dQ accumulates in fp32.
// bf16 products run on the tensor cores through nvcuda::wmma; fp32 runs FMA
// chains. wgmma, TMA and pipelined streams are later work.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

// p and ds of one (query row, key) element from the fp32 score s and dp
__device__ __forceinline__ float prob_lse(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

__device__ __forceinline__ float dscore(float dp, float di, float p,
                                        float scale) {
  return __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
}

// lse and di of rows [row0, row0 + rows) into shared memory; rows at or
// past N get lse = +inf and di = 0, so their p and ds are 0.
__device__ void load_stats(float* s_lse, float* s_di, const float* lse,
                           const float* di, int row0, int rows, int N) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const bool real = row0 + r < N;
    s_lse[r] = real ? lse[row0 + r] : INFINITY;
    s_di[r] = real ? di[row0 + r] : 0.0f;
  }
}

constexpr int KT = 32;  // 11b: key rows per block
constexpr int QB = 64;  // 11b: query rows per step
constexpr int QT = 32;  // 11c: query rows per block
constexpr int KB = 64;  // 11c: keys per step

// 11b regions: K and V of the block (KT, LD each), Q and dO of the step
// (QB, LD each), the fp32 scores and dp (QB, KT + 4 each), p and ds in T
// (QB, KT + pad each; aliasing the scores and dp for fp32), the fp32 dK and
// dV sums (KT, LDO each) and the step's lse and di.
template <typename T>
struct DkvLayout {
  static constexpr int LD = D + pad<T>();
  static constexpr int LDS = KT + 4;
  static constexpr int LDP = is_f32<T>() ? LDS : KT + pad<T>();
  static constexpr int TK = round128((long long)KT * LD * sizeof(T));
  static constexpr int TQ = round128((long long)QB * LD * sizeof(T));
  static constexpr int SC = round128((long long)QB * LDS * 4);
  static constexpr int PB =
      is_f32<T>() ? 0 : round128((long long)QB * LDP * sizeof(T));
  static constexpr int AC = round128((long long)KT * LDO * 4);
  static constexpr int ks = 0, vs = TK, qs = 2 * TK, dos = qs + TQ;
  static constexpr int sc = dos + TQ, dp = sc + SC, p = dp + SC, ds = p + PB;
  static constexpr int dk = ds + PB, dv = dk + AC, st = dv + AC;
  static constexpr int total = st + round128(2 * QB * 4);
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, int H, int N,
                     float scale) {
  using L = DkvLayout<T>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::ks);
  T* vs = reinterpret_cast<T*>(smem + L::vs);
  T* qs = reinterpret_cast<T*>(smem + L::qs);
  T* dos = reinterpret_cast<T*>(smem + L::dos);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* dp = reinterpret_cast<float*>(smem + L::dp);
  T* pt = is_f32<T>() ? reinterpret_cast<T*>(sc)
                      : reinterpret_cast<T*>(smem + L::p);
  T* dst = is_f32<T>() ? reinterpret_cast<T*>(dp)
                       : reinterpret_cast<T*>(smem + L::ds);
  float* dk_acc = reinterpret_cast<float*>(smem + L::dk);
  float* dv_acc = reinterpret_cast<float*>(smem + L::dv);
  float* s_lse = reinterpret_cast<float*>(smem + L::st);
  float* s_di = s_lse + QB;

  const int tiles = (N + KT - 1) / KT;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * KT;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_bh = lse + (long long)bh * N;
  const float* di_bh = di + (long long)bh * N;

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
    load_stats(s_lse, s_di, lse_bh, di_bh, q0, QB, N);
    __syncthreads();
    block_gemm<T, true, false>(sc, L::LDS, qs, LD, ks, LD, QB, KT, D, false);
    block_gemm<T, true, false>(dp, L::LDS, dos, LD, vs, LD, QB, KT, D, false);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * KT; e += THREADS) {
      const int r = e / KT, j = e % KT;
      float pr = 0.0f, g = 0.0f;
      if (k0 + j < N) {
        pr = prob_lse(sc[r * L::LDS + j], scale, s_lse[r]);
        g = dscore(dp[r * L::LDS + j], s_di[r], pr, scale);
      }
      store(pt + r * L::LDP + j, pr);  // in place for fp32: read, then written
      store(dst + r * L::LDP + j, g);
    }
    __syncthreads();
    // dV += p^T dO and dK += ds^T Q: p and ds read as column-major (KT, QB)
    block_gemm<T, false, true>(dv_acc, LDO, pt, L::LDP, dos, LD, KT, D, QB,
                               true);
    block_gemm<T, false, true>(dk_acc, LDO, dst, L::LDP, qs, LD, KT, D, QB,
                               true);
  }
  __syncthreads();
  store_rows(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, LDO, 1.0f, k0, KT, N);
  store_rows(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, LDO, 1.0f, k0, KT, N);
}

// 11c regions: Q and dO of the block (QT, LD each), K and V of the step
// (KB, LD each), the fp32 scores and dp (QT, KB + 4 each), ds in T (QT,
// KB + pad; aliasing dp for fp32), the fp32 dQ sum (QT, LDO) and the
// block's lse and di.
template <typename T>
struct DqLayout {
  static constexpr int LD = D + pad<T>();
  static constexpr int LDS = KB + 4;
  static constexpr int LDP = is_f32<T>() ? LDS : KB + pad<T>();
  static constexpr int TQ = round128((long long)QT * LD * sizeof(T));
  static constexpr int TK = round128((long long)KB * LD * sizeof(T));
  static constexpr int SC = round128((long long)QT * LDS * 4);
  static constexpr int PB =
      is_f32<T>() ? 0 : round128((long long)QT * LDP * sizeof(T));
  static constexpr int AC = round128((long long)QT * LDO * 4);
  static constexpr int qs = 0, dos = TQ, ks = 2 * TQ, vs = ks + TK;
  static constexpr int sc = vs + TK, dp = sc + SC, ds = dp + SC;
  static constexpr int acc = ds + PB, st = acc + AC;
  static constexpr int total = st + round128(2 * QT * 4);
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, int H, int N, float scale) {
  using L = DqLayout<T>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::qs);
  T* dos = reinterpret_cast<T*>(smem + L::dos);
  T* ks = reinterpret_cast<T*>(smem + L::ks);
  T* vs = reinterpret_cast<T*>(smem + L::vs);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* dp = reinterpret_cast<float*>(smem + L::dp);
  T* dst = is_f32<T>() ? reinterpret_cast<T*>(dp)
                       : reinterpret_cast<T*>(smem + L::ds);
  float* acc = reinterpret_cast<float*>(smem + L::acc);
  float* s_lse = reinterpret_cast<float*>(smem + L::st);
  float* s_di = s_lse + QT;

  const int tiles = (N + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, N);
  load_rows(dos, LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, QT, N);
  load_stats(s_lse, s_di, lse + (long long)bh * N, di + (long long)bh * N, q0,
             QT, N);
  for (int e = threadIdx.x; e < QT * LDO; e += THREADS) acc[e] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += KB) {
    __syncthreads();  // the previous step's product is done with K and ds
    load_rows(ks, LD, kb, sk.s, k0, KB, N);
    load_rows(vs, LD, vb, sv.s, k0, KB, N);
    __syncthreads();
    block_gemm<T, true, false>(sc, L::LDS, qs, LD, ks, LD, QT, KB, D, false);
    block_gemm<T, true, false>(dp, L::LDS, dos, LD, vs, LD, QT, KB, D, false);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * KB; e += THREADS) {
      const int r = e / KB, j = e % KB;
      float g = 0.0f;
      if (k0 + j < N) {
        const float pr = prob_lse(sc[r * L::LDS + j], scale, s_lse[r]);
        g = dscore(dp[r * L::LDS + j], s_di[r], pr, scale);
      }
      store(dst + r * L::LDP + j, g);  // in place for fp32: read, then written
    }
    __syncthreads();
    block_gemm<T, true, true>(acc, LDO, dst, L::LDP, ks, LD, QT, D, KB, true);
  }
  __syncthreads();
  store_rows(dq + b * sdq.b + h * sdq.h, sdq.s, acc, LDO, 1.0f, q0, QT, N);
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dk, void* dv,
              const long long* st, int B, int H, int N, int Dh, float scale,
              void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || N < 1) return cudaErrorInvalidValue;
  using L = DkvLayout<T>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + KT - 1) / KT);
  flash_bwd_dkv_kernel<T><<<(unsigned)blocks, THREADS, L::total,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]},
      Strides{st[15], st[16], st[17]}, H, N, scale);
  return cudaGetLastError();
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* di, void* dq, const long long* st,
             int B, int H, int N, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || N < 1) return cudaErrorInvalidValue;
  using L = DqLayout<T>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::total);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + QT - 1) / QT);
  flash_bwd_dq_kernel<T><<<(unsigned)blocks, THREADS, L::total,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, H, N,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv: (B, H, N, D) with D = 64 contiguous and every other
// stride a multiple of 16 bytes; lse, di: (B, H, N) fp32, contiguous;
// strides: 18 int64, (b, h, n) element strides of q, k, v, dout, dk and dv
// in turn; N >= 1.
extern "C" int lafs_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv,
    const long long* strides, int B, int H, int N, int Dh, float scale,
    void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, di, dk, dv, strides, B, H, N, Dh,
                         scale, stream);
}

extern "C" int lafs_flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv,
    const long long* strides, int B, int H, int N, int Dh, float scale,
    void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, di, dk, dv, strides, B, H, N,
                          Dh, scale, stream);
}

// As above with dq in place of dk and dv; strides: 15 int64, of q, k, v,
// dout and dq in turn.
extern "C" int lafs_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const long long* strides,
    int B, int H, int N, int Dh, float scale, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, di, dq, strides, B, H, N, Dh,
                        scale, stream);
}

extern "C" int lafs_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const long long* strides,
    int B, int H, int N, int Dh, float scale, void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, di, dq, strides, B, H, N, Dh,
                         scale, stream);
}
