// FastBlend's three PatchMatch kernels for Hopper (sm_90a):
//   F1 remap                 patch-vote average of a padded style image
//                            through a nearest-neighbour field (NNF)
//   F2 patch_error           SSD between each target patch and the source
//                            patch its NNF entry points at
//   F3 pairwise_patch_error  SSD between the patches two NNFs point at in
//                            two sources
//
// They replace `JaxKernels.remap`, `.patch_error` and
// `.pairwise_patch_error` (video_styler_tpu/extensions/fastblend/
// kernels.py:104, :139, :156), an XLA shift-and-gather form, whose C++
// oracle is native/fastblend_kernels.cpp (:18, :57, :89); the reference
// shipped them as CUDA (CuPy RawKernels). Layout as there: images are
// padded NHWC float32 (B, H + 2 pad, W + 2 pad, C), NNFs int32 (B, H, W, 2)
// holding (row, column) in the unpadded image.
//
// Arithmetic order. PatchMatch keeps a candidate only where its error is
// strictly lower, so a last-bit difference in an SSD flips a choice. The
// kernels therefore round where the plain PyTorch versions
// (extensions/fastblend/kernels.py) and the XLA form do: per patch shift,
// the channel sum of squared differences, then accumulate over shifts in
// row-major shift order; F1 sums its votes in that order and divides by
// their count. __fmul_rn/__fadd_rn keep nvcc from contracting a product
// and a sum into one FMA.
//
// What bounds them on the H100: at 480x832 with a 13x13 patch, F2 and F3
// do 169 x 3 x 3 fp32 operations per pixel against ~37 bytes of
// compulsory traffic per pixel, so their floor is the fp32 rate (67
// TFLOP/s without the tensor cores); F1 does ~1/3 of that and moves a
// padded image in and out, so its floor is the memory (3.35 TB/s).
// Design, simple first: one thread per output pixel (b, x, y), 256 a
// block, adjacent threads on adjacent columns; the patch loop reads the
// padded images through L1/L2, which serve the 13x13 overlap between
// neighbouring threads. F1 gathers its votes (no atomics), so it is
// deterministic. Offsets are int64. Source coordinates are clamped into
// the padded image, as the XLA gather clamps them: an NNF from PatchMatch
// is always in range, so this only keeps a bad field from reading out of
// bounds. Shared-memory tiles of the padded image and several channels per
// load are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int C>
__device__ __forceinline__ float channel_ssd(const float* a, const float* b) {
  float d = __fsub_rn(a[0], b[0]);
  float s = __fmul_rn(d, d);
#pragma unroll
  for (int c = 1; c < C; ++c) {
    d = __fsub_rn(a[c], b[c]);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  return s;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
remap_kernel(const float* __restrict__ src, const int2* __restrict__ nnf,
             float* __restrict__ out, int batch, int height, int width, int r,
             int pad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * height * width) return;
  const int y = static_cast<int>(i % width);
  const int x = static_cast<int>((i / width) % height);
  const int64_t b = i / (static_cast<int64_t>(width) * height);
  const int64_t pw = width + 2 * pad;
  const int64_t image = (height + 2 * pad) * pw * C;
  const float* s_b = src + b * image;
  const int2* n_b = nnf + b * height * width;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  int votes = 0;
  for (int px = -r; px <= r; ++px) {
    const int xn = x + px;
    if (xn < 0 || xn >= height) continue;
    for (int py = -r; py <= r; ++py) {
      const int yn = y + py;
      if (yn < 0 || yn >= width) continue;
      // the neighbour's match, shifted back by the neighbour's offset
      const int2 m = n_b[static_cast<int64_t>(xn) * width + yn];
      const int xs = m.x - px, ys = m.y - py;
      if (xs < 0 || ys < 0 || xs >= height || ys >= width) continue;
      const float* v = s_b + ((xs + pad) * pw + ys + pad) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], v[c]);
      ++votes;
    }
  }
  const float n = static_cast<float>(votes > 0 ? votes : 1);
  float* o = out + b * image + ((x + pad) * pw + y + pad) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = __fdiv_rn(acc[c], n);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
patch_error_kernel(const float* __restrict__ src, const int2* __restrict__ nnf,
                   const float* __restrict__ tgt, float* __restrict__ err,
                   int batch, int height, int width, int r, int pad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * height * width) return;
  const int y = static_cast<int>(i % width);
  const int x = static_cast<int>((i / width) % height);
  const int64_t b = i / (static_cast<int64_t>(width) * height);
  const int ph = height + 2 * pad, pw = width + 2 * pad;
  const int64_t image = static_cast<int64_t>(ph) * pw * C;
  const float* s_b = src + b * image;
  const float* t_b = tgt + b * image;
  const int2 m = nnf[i];
  float e = 0.f;
  for (int px = -r; px <= r; ++px) {
    const int64_t trow = static_cast<int64_t>(x + pad + px) * pw;
    const int64_t srow = static_cast<int64_t>(clampi(m.x + pad + px, 0, ph - 1)) * pw;
    for (int py = -r; py <= r; ++py) {
      const float* t = t_b + (trow + y + pad + py) * C;
      const float* s = s_b + (srow + clampi(m.y + pad + py, 0, pw - 1)) * C;
      e = __fadd_rn(e, channel_ssd<C>(t, s));
    }
  }
  err[i] = e;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
pairwise_patch_error_kernel(const float* __restrict__ src_a,
                            const int2* __restrict__ nnf_a,
                            const float* __restrict__ src_b,
                            const int2* __restrict__ nnf_b,
                            float* __restrict__ err, int batch, int height,
                            int width, int r, int pad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * height * width) return;
  const int64_t b = i / (static_cast<int64_t>(width) * height);
  const int ph = height + 2 * pad, pw = width + 2 * pad;
  const int64_t image = static_cast<int64_t>(ph) * pw * C;
  const float* a_b = src_a + b * image;
  const float* b_b = src_b + b * image;
  const int2 ma = nnf_a[i], mb = nnf_b[i];
  float e = 0.f;
  for (int px = -r; px <= r; ++px) {
    const int64_t arow = static_cast<int64_t>(clampi(ma.x + pad + px, 0, ph - 1)) * pw;
    const int64_t brow = static_cast<int64_t>(clampi(mb.x + pad + px, 0, ph - 1)) * pw;
    for (int py = -r; py <= r; ++py) {
      const float* pa = a_b + (arow + clampi(ma.y + pad + py, 0, pw - 1)) * C;
      const float* pb = b_b + (brow + clampi(mb.y + pad + py, 0, pw - 1)) * C;
      e = __fadd_rn(e, channel_ssd<C>(pa, pb));
    }
  }
  err[i] = e;
}

unsigned blocks_for(int batch, int height, int width) {
  const int64_t n = static_cast<int64_t>(batch) * height * width;
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Instantiate `kernel<C>` for C in 1..4 and launch it; anything else is
// cudaErrorInvalidValue with nothing launched.
#define FASTBLEND_DISPATCH(kernel, channel, grid, stream, ...)                  \
  switch (channel) {                                                            \
    case 1: kernel<1><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
    case 2: kernel<2><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
    case 3: kernel<3><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
    case 4: kernel<4><<<grid, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
    default: return static_cast<int>(cudaErrorInvalidValue);                   \
  }

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 on success).
// r = (patch_size - 1) / 2 must be at most pad; the caller checks it.

// F1: out (B, H + 2 pad, W + 2 pad, C), zeroed by the caller; the kernel
// writes its core.
int fastblend_remap(const void* src, const void* nnf, void* out, int batch,
                    int height, int width, int channel, int patch_size,
                    int pad, void* stream) {
  if (batch * static_cast<int64_t>(height) * width == 0) return 0;
  const unsigned grid = blocks_for(batch, height, width);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FASTBLEND_DISPATCH(remap_kernel, channel, grid, st,
                     static_cast<const float*>(src), static_cast<const int2*>(nnf),
                     static_cast<float*>(out), batch, height, width,
                     (patch_size - 1) / 2, pad);
  return static_cast<int>(cudaGetLastError());
}

// F2: err (B, H, W).
int fastblend_patch_error(const void* src, const void* nnf, const void* tgt,
                          void* err, int batch, int height, int width,
                          int channel, int patch_size, int pad, void* stream) {
  if (batch * static_cast<int64_t>(height) * width == 0) return 0;
  const unsigned grid = blocks_for(batch, height, width);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FASTBLEND_DISPATCH(patch_error_kernel, channel, grid, st,
                     static_cast<const float*>(src), static_cast<const int2*>(nnf),
                     static_cast<const float*>(tgt), static_cast<float*>(err),
                     batch, height, width, (patch_size - 1) / 2, pad);
  return static_cast<int>(cudaGetLastError());
}

// F3: err (B, H, W).
int fastblend_pairwise_patch_error(const void* src_a, const void* nnf_a,
                                   const void* src_b, const void* nnf_b,
                                   void* err, int batch, int height, int width,
                                   int channel, int patch_size, int pad,
                                   void* stream) {
  if (batch * static_cast<int64_t>(height) * width == 0) return 0;
  const unsigned grid = blocks_for(batch, height, width);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FASTBLEND_DISPATCH(pairwise_patch_error_kernel, channel, grid, st,
                     static_cast<const float*>(src_a), static_cast<const int2*>(nnf_a),
                     static_cast<const float*>(src_b), static_cast<const int2*>(nnf_b),
                     static_cast<float*>(err), batch, height, width,
                     (patch_size - 1) / 2, pad);
  return static_cast<int>(cudaGetLastError());
}

const char* fastblend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
