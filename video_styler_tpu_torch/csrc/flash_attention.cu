// K1: capped-softmax flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel_4d_capped`
// (video_styler_tpu/ops/flash_attention.py:213, reached through
// `_flash_fwd_4d` with capped=True).  Non-causal attention on the
// (B, S, N, D) layout, read through strides: no transpose, no copy.
//
// What it computes, per query row (the Pallas kernel's rounding points):
//   q'  = bf16(q * scale * log2(e))                    (fp32 multiply, downcast)
//   m2  = min(||q'|| * kmax[b, h] * 1.0001, 96)        (a per-row bound on q'.k)
//   p_j = exp2(q'.k_j - m2)  for real keys, 0 for keys past Sk
//   o   = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-37)
//   L2  = m2 + log2(max(sum_j p_j, 1e-37))   (f32, (B, H, Sq); only when a
//         stats pointer is given, i.e. when the backward (K3) will need it)
// kmax[b, h] = max_j ||k_j|| comes in from the caller (a plain reduction).
// There is no running max and no accumulator rescale: the bound makes
// p <= 1 by construction, so one pass over the keys suffices.
//
// What bounds it on the H100: the two products, 4*Sq*Sk*D flops per head
// (at the 14B self-attention shape, 29,640^2 x 40 heads, ~1.8e13 flops,
// 18 ms at the 989 TFLOP/s bf16 peak), against 1.2 GB of q/k/v/o traffic
// (0.4 ms at 3.35 TB/s).  It is bound by the tensor cores.
//
// Design, the simple first version: one block of 4 warps per
// (q-tile of 64 rows, head, batch); each warp owns 16 query rows.  The
// TPU's sequential KV grid axis becomes a loop inside the block over
// 64-key tiles, double-buffered in shared memory with cp.async.  Both
// products run on mma.sync m16n8k16 bf16 with fp32 accumulators; q stays in
// registers as A fragments, p is re-packed from the S accumulators into A
// fragments without touching shared memory.  Tiles are stored with an XOR
// swizzle of their 16-byte chunks so ldmatrix reads are free of bank
// conflicts.  wgmma and TMA are left for a later version.

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBytes = (kBQ + 4 * kBK) * kChunks * 16;  // q + 2x(k, v)

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* kmax;  // (B, H)
  __nv_bfloat16* o;
  float* l2;          // (B, H, Sq) base-2 logsumexp, or nullptr (not wanted)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
  float q_scale;
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_capped_kernel(const Args a) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* s_q = smem;
  uint4* s_k = s_q + kBQ * kChunks;      // two buffers
  uint4* s_v = s_k + 2 * kBK * kChunks;  // two buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within an 8-row group of a fragment
  const int tig = lane & 3;  // thread within that group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int ntiles = (a.sk + kBK - 1) / kBK;

  // K/V tile loader: keys past Sk are zero-filled (src size 0)
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * kBK;
    uint4* dk = s_k + buf * kBK * kChunks;
    uint4* dv = s_v + buf * kBK * kChunks;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int key = k0 + r;
      const bool ok = key < a.sk;
      const long long kr = ok ? key : 0;
      cp_async16(smem_addr(dk + swz(r, c)), kb + kr * a.k_ss + c * 8,
                 ok ? 16 : 0);
      cp_async16(smem_addr(dv + swz(r, c)), vb + kr * a.v_ss + c * 8,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  load_kv(0, 0);

  // q tile: fp32 scale, bf16 downcast, swizzled store; rows past Sq are 0
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.sq) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qb + (long long)row * a.q_ss + c * 8);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* out = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        out[j] = pack_bf16(f.x * a.q_scale, f.y * a.q_scale);
      }
    }
    s_q[swz(r, c)] = val;
  }
  __syncthreads();

  // q as A fragments, 8 steps of 16 along D
  uint32_t qf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 2 + (lane >> 4);
    ldsm_x4(qf[kk], smem_addr(s_q + swz(r, c)));
  }

  // per-row bound m2 for rows g and g+8 of this warp, from the downcast q
  const float kcap = a.kmax[b * a.heads + h] * 1.0001f;
  float m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + hh * 8;
    float ss = 0.f;
#pragma unroll
    for (int c = tig * 4; c < tig * 4 + 4; ++c) {
      const uint4 raw = s_q[swz(r, c)];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    m2[hh] = fminf(sqrtf(ss) * kcap, 96.f);
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float lsum[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* tk = s_k + buf * kBK * kChunks;
    const uint4* tv = s_v + buf * kBK * kChunks;

    // S = q' K^T for 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 2 + ((lane >> 3) & 1);
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(tk + swz(r, c)));
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // p = exp2(s - m2), masked past Sk; fp32 row sums; bf16 A fragments
    const int kbase = t * kBK;
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = kbase + nt * 8 + tig * 2;
      const bool ok0 = key < a.sk;
      const bool ok1 = key + 1 < a.sk;
      const float p0 = ok0 ? fast_exp2(s[nt][0] - m2[0]) : 0.f;
      const float p1 = ok1 ? fast_exp2(s[nt][1] - m2[0]) : 0.f;
      const float p2 = ok0 ? fast_exp2(s[nt][2] - m2[1]) : 0.f;
      const float p3 = ok1 ? fast_exp2(s[nt][3] - m2[1]) : 0.f;
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
        const int r = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = dp * 2 + (lane >> 4);
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_addr(tv + swz(r, c)));
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
    lsum[hh] = fmaxf(lsum[hh], 1e-37f);  // a flushed row gives 0, not NaN
  }
  if (a.l2 != nullptr && tig == 0) {
    // the backward's residual: L2 = m2 + log2(l), one per query row
    float* l2b = a.l2 + ((long long)b * a.heads + h) * a.sq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + warp * 16 + g + hh * 8;
      if (row < a.sq) l2b[row] = m2[hh] + log2f(lsum[hh]);
    }
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). l2 may be
// nullptr (inference: no stats wanted).
int flash_attention_capped_fwd(
    const void* q, const void* k, const void* v, const void* kmax, void* o,
    void* l2, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int batch, int heads, int sq, int sk, float q_scale, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.kmax = static_cast<const float*>(kmax);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.l2 = static_cast<float*>(l2);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.heads = heads; a.sq = sq; a.sk = sk;
  a.q_scale = q_scale;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_capped_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
