// K6 and K7: SageAttention-style int8 flash-attention forward for Hopper
// (sm_90a): Q K^T on the s8 tensor cores, P V in bf16.
//
// K6 replaces the Pallas kernels `_flash_kernel_int8_4d_capped`
// (video_styler_tpu/ops/flash_attention.py:1025) and `_flash_kernel_int8_4d`
// (:980), reached through `_flash_fwd_4d_int8` (:1072); K7 replaces the 3-D
// twin `_flash_kernel_int8` (:862, via `_flash_fwd_3d_int8`), which is the
// online body on (BH, S, D) strides.  The pre-pass that makes the inputs
// (token-mean smoothing of K, per-row absmax quantisation, the row bound m2)
// is a set of plain reductions outside the kernel, as in the JAX package.
//
// Inputs: q8 (B, Sq, N, D) and k8 (B, Sk, N, D) int8 through strides, v bf16
// (B, Sk, N, D), qs (B, N, Sq) and ks (B, N, Sk) f32 row scales (qs carries
// the softmax scale and log2 e), capped only: m2 (B, N, Sq) f32.
// What it computes, per query row i (the Pallas kernels' rounding points):
//   s_ij = (f32(q8_i . k8_j) * qs_i) * ks_j          (the int32 dot is exact)
//   capped:  p_ij = exp2(s_ij - m2_i), 0 past Sk; l = sum_j p_ij;
//            o = (sum_j bf16(p_ij) v_j) / max(l, 1e-37)
//   online:  the running max of K2: m_new = max(m, max_j s_ij),
//            alpha = exp2(m - m_new), p = exp2(s - m_new), l and acc rescaled
//            by alpha, o = acc / l
//
// What bounds it on the H100: 2*Sq*Sk*D int8 operations per head at 1,979
// TOP/s plus 2*Sq*Sk*D bf16 flops at 989 TFLOP/s (13.6 ms at 29,640 tokens
// and 40 heads, against K1's 18.2 ms); the bytes are a third of a
// millisecond.  It is bound by the tensor cores.
//
// Design: K1's structure (one block of 4 warps per 64 query rows, head and
// batch; 64-key tiles double-buffered with cp.async).  The int8 tiles have
// 128-byte rows, 8 chunks of 16 bytes, stored with their own XOR swizzle.
// ldmatrix moves 16-bit pairs and knows no types: an 8x8 .b16 matrix is 8
// rows of 16 bytes, and thread T receives bytes 4*(T%4)..+3 of row T/4,
// which is exactly the 4 x s8 register of an m16n8k32 A or B fragment.  So
// the fragment addressing of the bf16 kernels carries over with k-steps of
// 32 bytes.  The int32 logits are dequantised in registers; the key scales
// of a tile ride in shared memory beside it; p is packed to bf16 A
// fragments for mma.sync m16n8k16 as in K1.

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks8 = kD / 16;  // 16-byte chunks per int8 row
constexpr float kNegInf = -1e30f;
// q8 + 2 x k8 + 2 x v + 2 x ks
constexpr int kSmemBytes =
    (kBQ * kChunks8 + 2 * kBK * kChunks8 + 2 * kBK * kChunks) * 16 + 2 * kBK * 4;

__device__ __forceinline__ int swz8(int r, int c) {
  return r * kChunks8 + (c ^ (r & 7));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// c += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows of 128 int8 (row stride `ss` bytes) into a swizzled tile; rows at or
// past `limit` are zero-filled
__device__ __forceinline__ void load_tile8_async(uint4* dst, const int8_t* src,
                                                 long long ss, int row0,
                                                 int limit, int tid) {
  for (int i = tid; i < kBK * kChunks8; i += kThreads) {
    const int r = i / kChunks8;
    const int c = i % kChunks8;
    const int row = row0 + r;
    const bool ok = row < limit;
    const long long sr = ok ? row : 0;
    cp_async16(smem_addr(dst + swz8(r, c)), src + sr * ss + c * 16, ok ? 16 : 0);
  }
}

struct Args {
  const int8_t* q8;
  const int8_t* k8;
  const __nv_bfloat16* v;
  const float* qs;  // (B, H, Sq)
  const float* ks;  // (B, H, Sk)
  const float* m2;  // (B, H, Sq), capped only
  __nv_bfloat16* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
};

template <bool kCapped>
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8_kernel(const Args a) {
  static_assert(kBQ == kBK, "one tile loader serves q8 and k8");
  extern __shared__ __align__(128) uint4 smem[];
  uint4* s_q = smem;                       // int8, kBQ x 8 chunks
  uint4* s_k = s_q + kBQ * kChunks8;       // int8, two buffers
  uint4* s_v = s_k + 2 * kBK * kChunks8;   // bf16, two buffers
  float* s_ks = reinterpret_cast<float*>(s_v + 2 * kBK * kChunks);  // two x kBK

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const int8_t* qb = a.q8 + b * a.q_sb + h * a.q_sh;
  const int8_t* kb = a.k8 + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* ksb = a.ks + ((long long)b * a.heads + h) * a.sk;
  const int ntiles = (a.sk + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * kBK;
    load_tile8_async(s_k + buf * kBK * kChunks8, kb, a.k_ss, k0, a.sk, tid);
    load_tile_async<kBK, kThreads>(s_v + buf * kBK * kChunks, vb, a.v_ss, k0,
                                   a.sk, tid);
    if (tid < kBK) {
      const bool ok = k0 + tid < a.sk;
      cp_async4(smem_addr(s_ks + buf * kBK + tid), ksb + (ok ? k0 + tid : 0),
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

  load_tile8_async(s_q, qb, a.q_ss, q0, a.sq, tid);
  cp_async_commit();
  load_kv(0, 0);

  // row scales (and bounds) of rows g and g + 8 of this warp
  const long long rowbase = ((long long)b * a.heads + h) * a.sq;
  float qsr[2], m2r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + hh * 8;
    const bool ok = row < a.sq;
    qsr[hh] = ok ? a.qs[rowbase + row] : 0.f;
    m2r[hh] = (kCapped && ok) ? a.m2[rowbase + row] : 0.f;
  }

  // q8 as A fragments, 4 steps of 32 along D (key tile 0 may still be in flight)
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 2 + (lane >> 4);
    ldsm_x4(qf[kk], smem_addr(s_q + swz8(r, c)));
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float lsum[2] = {0.f, 0.f};
  float mrow[2] = {kNegInf, kNegInf};  // online only

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* tk = s_k + buf * kBK * kChunks8;
    const uint4* tv = s_v + buf * kBK * kChunks;
    const float* tks = s_ks + buf * kBK;

    // integer logits for 16 rows x 64 keys
    int si[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) si[i][0] = si[i][1] = si[i][2] = si[i][3] = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 2 + ((lane >> 3) & 1);
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(tk + swz8(r, c)));
        mma_s8(si[2 * np], qf[kk], kf[0], kf[1]);
        mma_s8(si[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // dequantise: (dot * qs) * ks, each product rounded (no contraction)
    const int kbase = t * kBK;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 kq = *reinterpret_cast<const float2*>(tks + nt * 8 + tig * 2);
      s[nt][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][0]), qsr[0]), kq.x);
      s[nt][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][1]), qsr[0]), kq.y);
      s[nt][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][2]), qsr[1]), kq.x);
      s[nt][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][3]), qsr[1]), kq.y);
    }

    float sub[2];  // what exp2 subtracts from each row's logits
    if constexpr (kCapped) {
      sub[0] = m2r[0];
      sub[1] = m2r[1];
    } else {
      float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = kbase + nt * 8 + tig * 2;
        if (key >= a.sk) s[nt][0] = s[nt][2] = kNegInf;
        if (key + 1 >= a.sk) s[nt][1] = s[nt][3] = kNegInf;
        mcur[0] = fmaxf(mcur[0], fmaxf(s[nt][0], s[nt][1]));
        mcur[1] = fmaxf(mcur[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mcur[hh] = fmaxf(mcur[hh], __shfl_xor_sync(0xffffffffu, mcur[hh], 1));
        mcur[hh] = fmaxf(mcur[hh], __shfl_xor_sync(0xffffffffu, mcur[hh], 2));
        const float mnew = fmaxf(mrow[hh], mcur[hh]);
        alpha[hh] = fast_exp2(mrow[hh] - mnew);
        mrow[hh] = mnew;
        lsum[hh] *= alpha[hh];
        sub[hh] = mnew;
      }
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
    }

    // p = exp2(s - sub), 0 past Sk; fp32 row sums; bf16 A fragments
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = kbase + nt * 8 + tig * 2;
      const bool ok0 = key < a.sk;
      const bool ok1 = key + 1 < a.sk;
      const float p0 = ok0 ? fast_exp2(__fsub_rn(s[nt][0], sub[0])) : 0.f;
      const float p1 = ok1 ? fast_exp2(__fsub_rn(s[nt][1], sub[0])) : 0.f;
      const float p2 = ok0 ? fast_exp2(__fsub_rn(s[nt][2], sub[1])) : 0.f;
      const float p3 = ok1 ? fast_exp2(__fsub_rn(s[nt][3], sub[1])) : 0.f;
      lsum[0] += p0 + p1;
      lsum[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, bt_frag_addr(tv, j * 16, dp, lane));
        mma_bf16(acc[2 * dp], pf[j], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[j], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
    if (kCapped) lsum[hh] = fmaxf(lsum[hh], 1e-37f);  // flushed row -> 0, not NaN
  }
  __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + hh * 8;
    if (row >= a.sq) continue;
    __nv_bfloat16* orow = ob + (long long)row * a.o_ss;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const uint32_t val = pack_bf16(acc[dt][hh * 2] / lsum[hh],
                                     acc[dt][hh * 2 + 1] / lsum[hh]);
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) = val;
    }
  }
}

template <bool kCapped>
int launch(const void* q8, const void* k8, const void* v, const void* qs,
           const void* ks, const void* m2, void* o, const long long* strides,
           int batch, int heads, int sq, int sk, void* stream) {
  Args a;
  a.q8 = static_cast<const int8_t*>(q8);
  a.k8 = static_cast<const int8_t*>(k8);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qs = static_cast<const float*>(qs);
  a.ks = static_cast<const float*>(ks);
  a.m2 = static_cast<const float*>(m2);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.heads = heads; a.sq = sq; a.sk = sk;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_int8_kernel<kCapped>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_int8_kernel<kCapped><<<grid, kThreads, kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success). `strides`
// points at 12 element strides on the host: (batch, sequence, head) of q8,
// k8, v, o.

// K6, capped: m2 holds each row's bound on its logits
int flash_attention_int8_capped_fwd(const void* q8, const void* k8,
                                    const void* v, const void* qs,
                                    const void* ks, const void* m2, void* o,
                                    const long long* strides, int batch,
                                    int heads, int sq, int sk, void* stream) {
  return launch<true>(q8, k8, v, qs, ks, m2, o, strides, batch, heads, sq, sk,
                      stream);
}

// K6, online softmax
int flash_attention_int8_online_fwd(const void* q8, const void* k8,
                                    const void* v, const void* qs,
                                    const void* ks, void* o,
                                    const long long* strides, int batch,
                                    int heads, int sq, int sk, void* stream) {
  return launch<false>(q8, k8, v, qs, ks, nullptr, o, strides, batch, heads, sq,
                       sk, stream);
}

// K7: the online body on (BH, S, D) tensors; `strides` holds the (batch,
// sequence) strides of q8, k8, v, o (8 values), scales are (BH, Sq), (BH, Sk)
int flash_attention_int8_3d_fwd(const void* q8, const void* k8, const void* v,
                                const void* qs, const void* ks, void* o,
                                const long long* strides, int bh, int sq,
                                int sk, void* stream) {
  long long s4[12];
  for (int i = 0; i < 4; ++i) {
    s4[3 * i] = strides[2 * i];
    s4[3 * i + 1] = strides[2 * i + 1];
    s4[3 * i + 2] = 0;  // one head per batch entry
  }
  return launch<false>(q8, k8, v, qs, ks, nullptr, o, s4, bh, 1, sq, sk, stream);
}

const char* flash_attention_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
