// Landmark patch gather, forward (kernel 1 of the PyTorch/CUDA port).
//
// Replaces the Pallas TPU kernel lafs_cvpr2024_tpu/ops/patch_gather_pallas.py
// (_kernel, called from patch_gather_pallas). For each image b, landmark n
// and patch offset (i, j) it samples the NHWC image bilinearly at
//     x = lx + i - P/2 - 0.5,   y = ly + j - P/2 - 0.5
// with grid_sample(align_corners=False) zero-padding semantics: each of the
// four corners contributes only when it lies inside the image. The output
// token is (B, N, P*P*C) with features in (x_off, y_off, c) order, i.e.
// feature (i*P + j)*C + c where i is the X offset.
//
// What bounds it on the card: bytes. Each output value reads four image
// values and does a handful of FLOPs, so the kernel is a gather bound by
// memory traffic (the image batch, 4.8 MB in fp32 at 128x112x112x3, stays
// in the 50 MB L2). The TPU kernel padded channel-major planes only for
// Mosaic's alignment rules; here one thread per output pixel (b, n, i, j)
// reads NHWC directly and loops over the channels, and neighbouring threads
// write neighbouring output addresses.
//
// Landmarks are clamped to [-(P+1), W+P+1] x [-(P+1), H+P+1] first, as the
// TPU kernel does: a landmark that far out samples only zeros either way,
// and the clamp keeps floorf -> int defined for any input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename L>
__global__ void patch_gather_kernel(const T* __restrict__ img,
                                    const L* __restrict__ lm,
                                    T* __restrict__ out, int B, int H, int W,
                                    int C, int N, int P) {
  const long long total = (long long)B * N * P * P;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % P);          // y offset
  const int i = (int)((idx / P) % P);    // x offset
  const long long bn = idx / ((long long)P * P);
  const int b = (int)(bn / N);

  const float pf = (float)P;
  float lx = to_f32(lm[bn * 2 + 0]);
  float ly = to_f32(lm[bn * 2 + 1]);
  lx = fminf(fmaxf(lx, -(pf + 1.0f)), (float)W + pf + 1.0f);
  ly = fminf(fmaxf(ly, -(pf + 1.0f)), (float)H + pf + 1.0f);
  const float x = (lx + ((float)i - 0.5f * pf)) - 0.5f;
  const float y = (ly + ((float)j - 0.5f * pf)) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool in_x0 = x0 >= 0 && x0 < W;
  const bool in_x1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool in_y0 = y0 >= 0 && y0 < H;
  const bool in_y1 = y0 + 1 >= 0 && y0 + 1 < H;
  const float w00 = (1.0f - wx) * (1.0f - wy);
  const float w01 = (1.0f - wx) * wy;
  const float w10 = wx * (1.0f - wy);
  const float w11 = wx * wy;

  const T* base = img + (long long)b * H * W * C;
  const long long r0 = (long long)y0 * W;
  const long long r1 = (long long)(y0 + 1) * W;
  T* o = out + bn * P * P * C + (long long)(i * P + j) * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = (in_x0 && in_y0) ? to_f32(base[(r0 + x0) * C + c]) : 0.f;
    const float v01 = (in_x0 && in_y1) ? to_f32(base[(r1 + x0) * C + c]) : 0.f;
    const float v10 = (in_x1 && in_y0) ? to_f32(base[(r0 + x0 + 1) * C + c]) : 0.f;
    const float v11 = (in_x1 && in_y1) ? to_f32(base[(r1 + x0 + 1) * C + c]) : 0.f;
    store(o + c, v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11);
  }
}

template <typename T, typename L>
cudaError_t launch(const void* img, const void* lm, void* out, int B, int H,
                   int W, int C, int N, int P, cudaStream_t stream) {
  const long long total = (long long)B * N * P * P;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (total == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  patch_gather_kernel<T, L><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const L*>(lm),
      static_cast<T*>(out), B, H, W, C, N, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lafs_patch_gather(const void* img, const void* lm, void* out,
                                 int B, int H, int W, int C, int N, int P,
                                 int img_bf16, int lm_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_bf16) {
    return lm_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(img, lm, out, B, H, W, C, N, P, s)
                   : launch<__nv_bfloat16, float>(img, lm, out, B, H, W, C, N, P, s);
  }
  return lm_bf16 ? launch<float, __nv_bfloat16>(img, lm, out, B, H, W, C, N, P, s)
                 : launch<float, float>(img, lm, out, B, H, W, C, N, P, s);
}

extern "C" const char* lafs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
