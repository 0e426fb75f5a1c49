// Fused short-sequence attention backward (kernel 7 of the PyTorch/CUDA
// port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/fused_attention.py
// (_bwd_kernel, called from _bwd_call). From Q, K, V and dO alone (the
// forward saves nothing else) it recomputes the fp32 probabilities A and
// forms, as the JAX kernel does:
//     dV = cast(A) ^T dO                  fp32 accumulate
//     dA = dO V^T                         fp32
//     dS = A (dA - rowsum(dA A))          from the recomputed fp32 A, not
//                                         flash attention's rowsum(dO O)
//     dQ = scale * (cast(dS) K)           dS cast to Q's dtype
//     dK = scale * (cast(dS) ^T Q)
// Operands and results may be strided views with D contiguous, as in the
// forward (fused_attention.cu).
//
// What bounds it on the card. At B = 200, H = 11, S = 197, D = 64 in bf16,
// Q, K, V, dO in and dQ, dK, dV out are 7 x 55 MB = 388 MB a layer
// (116 us at 3.35 TB/s), and the products are ~55 GFLOP with the
// recomputed scores. The einsum path's autograd writes and reads the
// (B, H, S, S) scores, probabilities and their gradients (171 MB each in
// bf16). Kept from the TPU kernel: no score tensor in device memory.
//
// dK and dV sum over all queries, and CUDA blocks run in no order; the TPU
// kernel's one grid step per batch element held the whole (H, S, S) problem
// in VMEM. Here two passes, both deterministic, without atomics:
//   1. dq pass, one block per (b, h, QT query rows): dA = dO V^T against V
//      of the whole sequence, then S = Q K^T with K in the same buffer, the
//      row softmax, rowsum(dA A) and dS; dQ = dS K. It writes each row's
//      max, sum and rowsum(dA A) to a (3, B*H, S) fp32 scratch.
//   2. dkv pass, one block per (b, h, 32 key rows): walks the queries in
//      tiles of 32, recomputes the tile's scores and dA, and from the row
//      statistics the same A and dS bit for bit (the same 16x16 products in
//      the same order; the _rn intrinsics of fused_attention_common.cuh);
//      accumulates dV and dK in fp32 shared memory.
// Each pass re-reads K and V (pass 1) or Q and dO (pass 2) from L2 once per
// tile. bf16 products run on the tensor cores through nvcuda::wmma; fp32
// runs FMA chains. wgmma, TMA and one fused pass are later work.

#include "fused_attention_common.cuh"

namespace {

using namespace lafs_attn;

constexpr int KT = 32;  // key rows per block of the dkv pass
constexpr int QB = 32;  // query rows per step of the dkv pass

// dq pass regions: V then K (Sp, LD), Q and dO (QT, LD), the fp32 scores
// and dA (QT, Sp + 4 each; the scores also the (QT, LDO) dQ staging tile
// for bf16), dS (QT, Sp + pad) in T, which aliases dA for fp32.
template <typename T>
struct DqLayout {
  static constexpr int LD = D + pad<T>();
  int Sp, qt, lds, ldd, kv, q, dout, sc, da, ds, total;
  __host__ __device__ DqLayout(int S) {
    Sp = pad_seq(S);
    qt = Sp <= 256 ? 32 : 16;
    lds = Sp + 4;
    ldd = is_f32<T>() ? lds : Sp + pad<T>();
    kv = 0;
    q = kv + round128((long long)Sp * LD * sizeof(T));
    dout = q + round128((long long)qt * LD * sizeof(T));
    sc = dout + round128((long long)qt * LD * sizeof(T));
    da = sc + round128((long long)qt * max_i(lds, LDO) * 4);
    ds = da + round128((long long)qt * lds * 4);
    total = is_f32<T>() ? ds : ds + round128((long long)qt * ldd * sizeof(T));
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   T* __restrict__ dq, float* __restrict__ stats, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq, int BH,
                   int H, int S, float scale) {
  const DqLayout<T> L(S);
  constexpr int LD = DqLayout<T>::LD;
  const int QT = L.qt;
  extern __shared__ __align__(128) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem + L.kv);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* dos = reinterpret_cast<T*>(smem + L.dout);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* da = reinterpret_cast<float*>(smem + L.da);
  T* ds = is_f32<T>() ? reinterpret_cast<T*>(da)
                      : reinterpret_cast<T*>(smem + L.ds);

  const int tiles = (S + QT - 1) / QT;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * QT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(kv, LD, v + b * sv.b + h * sv.h, sv.s, 0, L.Sp, S);
  load_rows(qs, LD, q + b * sq.b + h * sq.h, sq.s, q0, QT, S);
  load_rows(dos, LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, QT, S);
  __syncthreads();
  block_gemm<T, true, false>(da, L.lds, dos, LD, kv, LD, QT, L.Sp, D, false);
  __syncthreads();
  load_rows(kv, LD, k + b * sk.b + h * sk.h, sk.s, 0, L.Sp, S);
  __syncthreads();
  block_gemm<T, true, false>(sc, L.lds, qs, LD, kv, LD, QT, L.Sp, D, false);
  __syncthreads();
  float* st_m = stats + (long long)bh * S;
  float* st_l = st_m + (long long)BH * S;
  float* st_d = st_l + (long long)BH * S;
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * L.lds;
    float* drow = da + r * L.lds;
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
    T* dsrow = ds + r * L.ldd;  // fp32: the dA row itself, read then written
    for (int j = lane; j < L.Sp; j += 32)
      store(dsrow + j, j < S ? dlogit(row[j], drow[j], dsum) : 0.0f);
    if (lane == 0 && q0 + r < S) {
      st_m[q0 + r] = m;
      st_l[q0 + r] = sum;
      st_d[q0 + r] = dsum;
    }
  }
  __syncthreads();
  // dQ = dS K, staged where nothing is read any more: the scores for bf16,
  // the Q tile for fp32 (dS aliases dA there)
  float* os = is_f32<T>() ? reinterpret_cast<float*>(qs) : sc;
  block_gemm<T, true, true>(os, LDO, ds, L.ldd, kv, LD, QT, D, L.Sp, false);
  __syncthreads();
  store_rows(dq + b * sdq.b + h * sdq.h, sdq.s, os, LDO, scale, q0, QT, S);
}

// dkv pass regions: K and V of the block's key rows, Q and dO of the query
// step (32, LD each), the fp32 scores and dA (32, KT + 4), A and dS in T
// (32, KT + pad; aliasing the scores and dA for fp32), the fp32 dK and dV
// sums (KT, LDO), and the step's row statistics.
template <typename T>
struct DkvLayout {
  static constexpr int LD = D + pad<T>();
  static constexpr int LDS = KT + 4;
  static constexpr int LDA = is_f32<T>() ? LDS : KT + pad<T>();
  static constexpr int TILE = round128((long long)32 * LD * sizeof(T));
  static constexpr int SC = round128((long long)QB * LDS * 4);
  static constexpr int AT =
      is_f32<T>() ? 0 : round128((long long)QB * LDA * sizeof(T));
  static constexpr int ACC = round128((long long)KT * LDO * 4);
  static constexpr int ks = 0, vs = TILE, qs = 2 * TILE, dos = 3 * TILE;
  static constexpr int sc = 4 * TILE, da = sc + SC, a = da + SC, ds = a + AT;
  static constexpr int dk = ds + AT, dv = dk + ACC, st = dv + ACC;
  static constexpr int total = st + round128(3 * QB * 4);
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    T* __restrict__ dk, T* __restrict__ dv,
                    const float* __restrict__ stats, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdk, Strides sdv, int BH,
                    int H, int S, float scale) {
  using L = DkvLayout<T>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::ks);
  T* vs = reinterpret_cast<T*>(smem + L::vs);
  T* qs = reinterpret_cast<T*>(smem + L::qs);
  T* dos = reinterpret_cast<T*>(smem + L::dos);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* da = reinterpret_cast<float*>(smem + L::da);
  T* at = is_f32<T>() ? reinterpret_cast<T*>(sc)
                      : reinterpret_cast<T*>(smem + L::a);
  T* dst = is_f32<T>() ? reinterpret_cast<T*>(da)
                       : reinterpret_cast<T*>(smem + L::ds);
  float* dk_acc = reinterpret_cast<float*>(smem + L::dk);
  float* dv_acc = reinterpret_cast<float*>(smem + L::dv);
  float* row_m = reinterpret_cast<float*>(smem + L::st);
  float* row_l = row_m + QB;
  float* row_d = row_l + QB;

  const int tiles = (S + KT - 1) / KT;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * KT;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
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
    block_gemm<T, true, false>(sc, L::LDS, qs, LD, ks, LD, QB, KT, D, false);
    block_gemm<T, true, false>(da, L::LDS, dos, LD, vs, LD, QB, KT, D, false);
    __syncthreads();
    for (int e = threadIdx.x; e < QB * KT; e += THREADS) {
      const int r = e / KT, j = e % KT;
      float a = 0.0f, g = 0.0f;
      if (k0 + j < S) {
        a = prob(sc[r * L::LDS + j], scale, row_m[r], row_l[r]);
        g = dlogit(a, da[r * L::LDS + j], row_d[r]);
      }
      store(at + r * L::LDA + j, a);  // in place for fp32: read, then written
      store(dst + r * L::LDA + j, g);
    }
    __syncthreads();
    // dV += A^T dO and dK += dS^T Q: A and dS read as column-major (KT, QB)
    block_gemm<T, false, true>(dv_acc, LDO, at, L::LDA, dos, LD, KT, D, QB,
                               true);
    block_gemm<T, false, true>(dk_acc, LDO, dst, L::LDA, qs, LD, KT, D, QB,
                               true);
  }
  __syncthreads();
  store_rows(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, LDO, scale, k0, KT, S);
  store_rows(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, LDO, 1.0f, k0, KT, S);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, void* stats,
                   const long long* st, int B, int H, int S, float scale,
                   cudaStream_t s) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const int BH = B * H;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  float* fst = static_cast<float*>(stats);

  const DqLayout<T> L1(S);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L1.total);
  if (err != cudaSuccess) return err;
  const long long b1 = (long long)BH * ((S + L1.qt - 1) / L1.qt);
  attn_bwd_dq_kernel<T><<<(unsigned)b1, THREADS, L1.total, s>>>(
      tq, tk, tv, tdo, static_cast<T*>(dq), fst, sq, sk, sv, sdo, sdq, BH, H,
      S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using L2 = DkvLayout<T>;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L2::total);
  if (err != cudaSuccess) return err;
  const long long b2 = (long long)BH * ((S + KT - 1) / KT);
  attn_bwd_dkv_kernel<T><<<(unsigned)b2, THREADS, L2::total, s>>>(
      tq, tk, tv, tdo, static_cast<T*>(dk), static_cast<T*>(dv), fst, sq, sk,
      sv, sdo, sdk, sdv, BH, H, S, scale);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* dout,
          void* dq, void* dk, void* dv, void* stats, const long long* strides,
          int B, int H, int S, int Dh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Dh != D || S < 1 || S > MAX_S) return cudaErrorInvalidValue;
  return launch<T>(q, k, v, dout, dq, dk, dv, stats, strides, B, H, S, scale,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, S, D) with D = 64 contiguous and every
// other stride a multiple of 16 bytes; strides: 21 int64, (b, h, s) element
// strides of q, k, v, dout, dq, dk and dv in turn; stats: 3 * B * H * S
// fp32 of scratch; 1 <= S <= 512. Two kernels on `stream`, in order.
extern "C" int lafs_fused_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, const long long* strides, int B, int H,
    int S, int Dh, float scale, void* stream) {
  return entry<bf16>(q, k, v, dout, dq, dk, dv, stats, strides, B, H, S, Dh,
                     scale, stream);
}

extern "C" int lafs_fused_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, const long long* strides, int B, int H,
    int S, int Dh, float scale, void* stream) {
  return entry<float>(q, k, v, dout, dq, dk, dv, stats, strides, B, H, S, Dh,
                      scale, stream);
}
