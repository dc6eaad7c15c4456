// K4 (fused RMSNorm + 3-D RoPE on the self-attention Q and K) and
// K5 (single-pass RMSNorm on the cross-attention Q) for Hopper (sm_90a).
//
// Replace the Pallas kernels `_fused_kernel` and `_rms_kernel`
// (video_styler_tpu/ops/fused_norm_rope.py:51 and :154).  Both are a row
// reduction over the whole model dim Dm (all heads, not one head) fused with
// an elementwise epilogue, with the Pallas kernels' rounding points:
//   r  = rsqrt(mean(x^2) + eps)                        (fp32)
//   xn = bf16(bf16(x * r) * w)                          (cast, then weight)
//   K4 only: rotate interleaved pairs in fp32 with the per-token tables,
//     y[2i] = xn[2i] cos_i - xn[2i+1] sin_i,  y[2i+1] = xn[2i] sin_i + xn[2i+1] cos_i
//   and cast to bf16.
//
// What bounds them on the H100: bytes.  Each row is read once and written
// once (at the 14B shape, 29,640 x 5120 bf16 = 303 MB per tensor) and the
// arithmetic is a few flops per byte, far below the ~295 flop/byte ridge,
// so the floor is the traffic over 3.35 TB/s and no tensor core is used.
//
// Design. K4: one warp per token row, 8 rows per block, no shared memory
// and no block barrier. Pass 1 streams the row in 16-byte chunks and
// reduces the sum of squares with warp shuffles; pass 2 re-reads the row
// and writes the normalised, weighted, rotated output. It handles Q and K
// in one launch (grid.y selects the tensor) and reads the cos/sin tables
// as float4.
// K5: one warp per row, 4 rows per block, and the row held in registers,
// so that x is read from device memory exactly once: each lane issues all
// of its 16-byte loads (20 at Dm = 5120; the kernel is instantiated for a
// few such counts, up to 32, i.e. Dm <= 8192) before the shuffle
// reduction, then writes the output from the same registers; w comes
// through the read-only path. The row stays packed in bf16 across the
// reduction (at Dm = 5120 about 112 registers a thread, four blocks an
// SM; holding its fp32 copies took 181 and ran slower at 4,680 rows). A
// re-read pass, as K4's, finds its row in L1 only while few rows are in
// flight, and makes a second trip to L2 or memory otherwise.
// The TPU's one-tensor-per-launch split and its Dm <= 5120 / S >= 1024
// gates were VMEM and Mosaic limits and are gone. CUDA C++ rather than
// Triton: it shares the build of the attention kernels and needs no
// tensor-core tiling, so a plain warp-per-row kernel is short.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_rsqrt(const uint4* xr, int nchunks,
                                           int lane, int dm, float eps) {
  float ss = 0.f;
  for (int c = lane; c < nchunks; c += 32) {
    const uint4 raw = xr[c];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  ss = warp_sum(ss);
  return rsqrtf(ss / static_cast<float>(dm) + eps);
}

// bf16(bf16(x * r) * w), returned as fp32
__device__ __forceinline__ float norm_weight(float x, float r, float w) {
  const float xn = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, r)));
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(xn, w)));
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_rope_kernel(const __nv_bfloat16* xq, const __nv_bfloat16* xk,
                    const __nv_bfloat16* wq, const __nv_bfloat16* wk,
                    const float* cos, const float* sin,
                    __nv_bfloat16* oq, __nv_bfloat16* ok,
                    int rows, int seq, int dm, int head_dim, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bool is_k = blockIdx.y == 1;
  const __nv_bfloat16* x = is_k ? xk : xq;
  const __nv_bfloat16* w = is_k ? wk : wq;
  __nv_bfloat16* o = is_k ? ok : oq;
  const int nchunks = dm / 8;
  const int half = head_dim / 2;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * dm);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(o + (long long)row * dm);
  const float* cs = cos + (long long)(row % seq) * half;
  const float* sn = sin + (long long)(row % seq) * half;

  const float r = row_rsqrt(xr, nchunks, lane, dm, eps);
  for (int c = lane; c < nchunks; c += 32) {
    const uint4 raw = xr[c];
    const uint4 wraw = wr[c];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const __nv_bfloat162* we = reinterpret_cast<const __nv_bfloat162*>(&wraw);
    const int i0 = ((c * 8) % head_dim) / 2;  // first pair index, multiple of 4
    const float4 c4 = *reinterpret_cast<const float4*>(cs + i0);
    const float4 s4 = *reinterpret_cast<const float4*>(sn + i0);
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
    const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
    uint4 out;
    uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const float2 wf = __bfloat1622float2(we[j]);
      const float x0 = norm_weight(f.x, r, wf.x);
      const float x1 = norm_weight(f.y, r, wf.y);
      const float y0 = __fsub_rn(__fmul_rn(x0, cc[j]), __fmul_rn(x1, ss[j]));
      const float y1 = __fadd_rn(__fmul_rn(x0, ss[j]), __fmul_rn(x1, cc[j]));
      __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
      po[j] = *reinterpret_cast<uint32_t*>(&v);
    }
    orow[c] = out;
  }
}

constexpr int kRmsRows = 4;  // K5: rows (warps) per block

// K5 with kPer 16-byte chunks of the row per lane in registers (chunk
// lane + 32 i; those past the row are not read)
template <int kPer>
__global__ void __launch_bounds__(kRmsRows * 32)
rmsnorm_kernel(const __nv_bfloat16* x, const __nv_bfloat16* w,
               __nv_bfloat16* o, int rows, int dm, float eps) {
  const int row = blockIdx.x * kRmsRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nchunks = dm / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * dm);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(o + (long long)row * dm);

  uint4 raw[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunks) raw[i] = xr[c];
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (lane + 32 * i < nchunks) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(dm) + eps);
  // the row stays packed (4 registers a chunk): without this the compiler
  // keeps the sum's fp32 copies of it (8 a chunk) for the output
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    asm volatile("" : "+r"(raw[i].x), "+r"(raw[i].y), "+r"(raw[i].z), "+r"(raw[i].w));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c >= nchunks) continue;
    const uint4 wraw = __ldg(wr + c);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
    const __nv_bfloat162* we = reinterpret_cast<const __nv_bfloat162*>(&wraw);
    uint4 out;
    uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const float2 wf = __bfloat1622float2(we[j]);
      __nv_bfloat162 v = __floats2bfloat162_rn(norm_weight(f.x, r, wf.x),
                                               norm_weight(f.y, r, wf.y));
      po[j] = *reinterpret_cast<uint32_t*>(&v);
    }
    orow[c] = out;
  }
}

template <int kPer>
void launch_rms(const void* x, const void* w, void* o, int rows, int dm, float eps,
                cudaStream_t stream) {
  rmsnorm_kernel<kPer><<<(rows + kRmsRows - 1) / kRmsRows, kRmsRows * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(o), rows, dm, eps);
}

}  // namespace

extern "C" {

// K4: q/k (rows, dm) -> roped (rows, dm); cos/sin (seq, head_dim/2) fp32.
// Returns cudaGetLastError() after the launch (0 on success).
int fused_rmsnorm_rope_fwd(const void* xq, const void* xk, const void* wq,
                           const void* wk, const void* cos, const void* sin,
                           void* oq, void* ok, int rows, int seq, int dm,
                           int head_dim, float eps, void* stream) {
  dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, 2);
  rmsnorm_rope_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
      static_cast<const __nv_bfloat16*>(wq), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<__nv_bfloat16*>(oq), static_cast<__nv_bfloat16*>(ok),
      rows, seq, dm, head_dim, eps);
  return static_cast<int>(cudaGetLastError());
}

// K5: x (rows, dm) -> rms_norm(x) * w; dm a multiple of 8 and at most
// 8192 (else cudaErrorInvalidValue, nothing launched).
int fused_rmsnorm_fwd(const void* x, const void* w, void* o, int rows, int dm,
                      float eps, void* stream) {
  const int per = (dm / 8 + 31) / 32;  // 16-byte chunks per lane
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per <= 4) launch_rms<4>(x, w, o, rows, dm, eps, st);
  else if (per <= 8) launch_rms<8>(x, w, o, rows, dm, eps, st);
  else if (per <= 16) launch_rms<16>(x, w, o, rows, dm, eps, st);
  else if (per <= 20) launch_rms<20>(x, w, o, rows, dm, eps, st);
  else if (per <= 32) launch_rms<32>(x, w, o, rows, dm, eps, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_norm_rope_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
