// Shared device helpers of the mma.sync attention kernels (K2 and K8, K6
// and K7): cp.async tile copies, ldmatrix, mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), and the XOR swizzle of 16-byte chunks that makes
// ldmatrix reads of a (rows x 128) bf16 tile free of bank conflicts; K1
// and K3 (sm90_wgmma.cuh) use its exp2, packing and address helpers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

constexpr int kD = 128;          // head dim of every Wan DiT config
constexpr int kChunks = kD / 8;  // 16-byte chunks per row

__device__ __forceinline__ int swz(int r, int c) {
  return r * kChunks + (c ^ (r & 7));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address of this lane's ldmatrix row for an A fragment (16 rows x 16 k) of
// a row-major [row][d] tile: rows row0.., k chunk pair kk.
__device__ __forceinline__ uint32_t a_frag_addr(const uint4* tile, int row0,
                                                int kk, int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = kk * 2 + (lane >> 4);
  return smem_addr(tile + swz(r, c));
}

// B fragments of two n-tiles (16 n x 16 k) from a row-major [n][k] tile
// (non-transposed ldmatrix): n rows n0.., k chunk pair kk.
__device__ __forceinline__ uint32_t b_frag_addr(const uint4* tile, int n0,
                                                int kk, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = kk * 2 + ((lane >> 3) & 1);
  return smem_addr(tile + swz(r, c));
}

// B fragments of two n-tiles (16 k x 16 n) from a row-major [k][n] tile
// (transposed ldmatrix): k rows k0.., n chunk pair np.
__device__ __forceinline__ uint32_t bt_frag_addr(const uint4* tile, int k0,
                                                 int np, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = np * 2 + (lane >> 4);
  return smem_addr(tile + swz(r, c));
}

// Copy `rows` rows of 128 bf16 (row stride `ss` elements) into a swizzled
// tile with cp.async; rows at or past `limit` are zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile_async(uint4* dst,
                                                const __nv_bfloat16* src,
                                                long long ss, int row0,
                                                int limit, int tid) {
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < limit;
    const long long sr = ok ? row : 0;
    cp_async16(smem_addr(dst + swz(r, c)), src + sr * ss + c * 8, ok ? 16 : 0);
  }
}

}  // namespace sm90
