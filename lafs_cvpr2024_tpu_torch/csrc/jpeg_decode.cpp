// Batched JPEG decode on the card with nvJPEG, finished the way libjpeg
// finishes it (no TPU kernel behind it: the JAX package decodes on the
// host with PIL, data/dataset.py, or libjpeg, native/lafs_dataplane.cc;
// both run libjpeg with its defaults).
//
// Built (nvcc -x cu) into its own shared library (data/decode.py), apart
// from the kernels, so that a missing libnvjpeg cannot take the kernels
// down with it. For each JPEG of a batch, nvjpegDecode (Huffman decoding on
// the host, the inverse DCT on the card) writes the planes at their coded
// resolution (NVJPEG_OUTPUT_YUV, or Y alone for grayscale) into device
// scratch (waiting for each image: see the loop); then one kernel
// upsamples the chroma and converts to RGB as
// libjpeg does by default: the triangular "fancy" upsampling of 4:2:0 and
// 4:2:2 chroma (jdsample.c h2v2/h2v1_fancy_upsample, with its alternating
// rounding biases and replicated edges) and the fixed-point YCbCr → RGB of
// jdcolor.c (16-bit tables, arithmetic shifts). nvJPEG's own RGB output
// replicates the chroma instead, which moved the fixture's pixels by 1.3
// levels on average and 27 at most. Results land in one slot of a
// (n, H, W, 3) uint8 RGB device buffer, in order on the caller's stream.
// Other chroma layouts (4:4:0, 4:1:1) are refused. One handle and one
// decode state serve the process, behind a mutex.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>

namespace {

std::mutex mu;
nvjpegHandle_t handle = nullptr;
nvjpegJpegState_t state = nullptr;

constexpr int kBadSize = -1;    // an image of another size than the batch's
constexpr int kBadLayout = -2;  // a chroma layout the kernel does not take

int init() {
  if (handle != nullptr) return NVJPEG_STATUS_SUCCESS;
  nvjpegStatus_t st = nvjpegCreateSimple(&handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    handle = nullptr;
    return st;
  }
  st = nvjpegJpegStateCreate(handle, &state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(handle);
    handle = nullptr;
  }
  return st;
}

struct Info {
  int components;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT];
  int h[NVJPEG_MAX_COMPONENT];
};

int info(const unsigned char* data, size_t len, Info* in) {
  return nvjpegGetImageInfo(handle, data, len, &in->components, &in->sub,
                            in->w, in->h);
}

// libjpeg's jdcolor.c constants: FIX(x) = (int)(x * 65536 + 0.5)
constexpr int SCALEBITS = 16;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);
constexpr int FIX_1_40200 = 91881;
constexpr int FIX_1_77200 = 116130;
constexpr int FIX_0_71414 = 46802;
constexpr int FIX_0_34414 = 22554;
__device__ __forceinline__ unsigned char clamp255(int v) {
  return (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One chroma sample at output pixel (r, c) of an (H, W) image from a
// (ch, cw) plane with pitch cp, as libjpeg's fancy upsampling makes it:
// sv/sh = 2 when the plane is halved vertically/horizontally.
__device__ int chroma(const unsigned char* p, int cp, int ch, int cw, int r,
                      int c, int sv, int sh) {
  const int i = r / sv, j = c / sh;
  auto at = [&](int y, int x) {
    y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
    x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
    return (int)p[y * cp + x];
  };
  if (sv == 1 && sh == 1) return at(i, j);
  if (sv == 1) {  // h2v1: (3 * nearer + farther + 1 or 2) >> 2
    return (c % 2 == 0) ? (3 * at(i, j) + at(i, j - 1) + 1) >> 2
                        : (3 * at(i, j) + at(i, j + 1) + 2) >> 2;
  }
  // h2v2: column sums 3 * nearer row + farther row, then across columns
  const int i2 = (r % 2 == 0) ? i - 1 : i + 1;
  const int here = 3 * at(i, j) + at(i2, j);
  if (c % 2 == 0)
    return (3 * here + (3 * at(i, j - 1) + at(i2, j - 1)) + 8) >> 4;
  return (3 * here + (3 * at(i, j + 1) + at(i2, j + 1)) + 7) >> 4;
}

__global__ void ycc_to_rgb(const unsigned char* y, int yp,
                           const unsigned char* cb, const unsigned char* cr,
                           int cp, int ch, int cw, int sv, int sh, int gray,
                           int H, int W, unsigned char* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * W) return;
  const int r = e / W, c = e % W;
  const int Y = y[r * yp + c];
  unsigned char* o = out + (long long)e * 3;
  if (gray) {
    o[0] = o[1] = o[2] = (unsigned char)Y;
    return;
  }
  const int xb = chroma(cb, cp, ch, cw, r, c, sv, sh) - 128;
  const int xr = chroma(cr, cp, ch, cw, r, c, sv, sh) - 128;
  const int cr_r = (FIX_1_40200 * xr + ONE_HALF) >> SCALEBITS;
  const int cb_b = (FIX_1_77200 * xb + ONE_HALF) >> SCALEBITS;
  const int g = (-FIX_0_34414 * xb + ONE_HALF - FIX_0_71414 * xr) >> SCALEBITS;
  o[0] = clamp255(Y + cr_r);
  o[1] = clamp255(Y + g);
  o[2] = clamp255(Y + cb_b);
}

}  // namespace

// Height and width of one JPEG; returns an nvjpegStatus_t (0: success).
extern "C" int lafs_jpeg_info(const unsigned char* data, size_t len, int* h,
                              int* w) {
  std::lock_guard<std::mutex> lock(mu);
  int err = init();
  if (err != NVJPEG_STATUS_SUCCESS) return err;
  Info in;
  err = info(data, len, &in);
  if (err != NVJPEG_STATUS_SUCCESS) return err;
  *h = in.h[0];
  *w = in.w[0];
  return NVJPEG_STATUS_SUCCESS;
}

// Decode n JPEGs (data[i], lengths[i] bytes) of H x W pixels into out, a
// (n, H, W, 3) uint8 RGB buffer in device memory, on `stream`; scratch is
// 3 * H * W bytes of device memory for the planes. Returns 0, an
// nvjpegStatus_t, -1 when an image is not H x W, -2 for a chroma layout
// other than 4:4:4, 4:2:2, 4:2:0 or grayscale, or 1000 + a cudaError_t.
// Synchronous: `stream` has finished the batch when it returns.
extern "C" int lafs_jpeg_decode_batch(const unsigned char* const* data,
                                      const size_t* lengths, int n,
                                      unsigned char* out, unsigned char* scratch,
                                      int H, int W, void* stream) {
  std::lock_guard<std::mutex> lock(mu);
  int err = init();
  if (err != NVJPEG_STATUS_SUCCESS) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    Info in;
    err = info(data[i], lengths[i], &in);
    if (err != NVJPEG_STATUS_SUCCESS) return err;
    if (in.h[0] != H || in.w[0] != W) return kBadSize;
    const bool gray = in.sub == NVJPEG_CSS_GRAY || in.components == 1;
    int sv = 1, sh = 1;
    if (!gray) {
      if (in.sub == NVJPEG_CSS_420) {
        sv = sh = 2;
      } else if (in.sub == NVJPEG_CSS_422) {
        sh = 2;
      } else if (in.sub != NVJPEG_CSS_444) {
        return kBadLayout;
      }
    }
    const int cw = (W + sh - 1) / sh, ch = (H + sv - 1) / sv;
    nvjpegImage_t img = {};
    img.channel[0] = scratch;
    img.pitch[0] = (size_t)W;
    img.channel[1] = scratch + (size_t)H * W;
    img.pitch[1] = (size_t)cw;
    img.channel[2] = scratch + (size_t)H * W + (size_t)ch * cw;
    img.pitch[2] = (size_t)cw;
    err = nvjpegDecode(handle, state, data[i], lengths[i],
                       gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img, s);
    if (err != NVJPEG_STATUS_SUCCESS) return err;
    const int threads = 256, blocks = (H * W + threads - 1) / threads;
    ycc_to_rgb<<<blocks, threads, 0, s>>>(
        img.channel[0], W, img.channel[1], img.channel[2], cw, ch, cw, sv, sh,
        gray ? 1 : 0, H, W, out + (size_t)H * W * 3 * i);
    cudaError_t cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return 1000 + (int)cerr;
    // nvjpegDecode returns once its host stage is done and leaves the copy
    // of the Huffman-decoded coefficients from the state's pinned buffer
    // queued on the stream; the next image's host stage overwrites that
    // buffer. When the card is busy with other streams the queued copy runs
    // late and reads the next image's coefficients (seen on the H100 with
    // a training step on the default stream), so every image waits for its
    // copy, and the whole batch is done on the device when this returns.
    cerr = cudaStreamSynchronize(s);
    if (cerr != cudaSuccess) return 1000 + (int)cerr;
  }
  return 0;
}
