// K2 and K8: online-softmax flash-attention forward for Hopper (sm_90a).
//
// K2 replaces the Pallas kernel `_flash_kernel_4d`
// (video_styler_tpu/ops/flash_attention.py:150, reached through
// `_flash_fwd_4d` with capped=False) and, on an n = 1 view, its 3-D twin
// `_flash_kernel` (:54, via `_flash_fwd_3d`).  K8 replaces
// `_flash_kernel_4d_dual` (:288, `_flash_fwd_4d(dual=True)`): the same
// function with two key sub-tiles per loop step and one merged update.
// Non-causal attention on the (B, S, N, D) layout, read through strides.
//
// What it computes, per query row (the Pallas kernel's rounding points):
//   q'  = bf16(q * scale * log2(e))      (fp32 multiply, downcast; a launch
//                                         with q_scale = 1 takes q as it is)
//   per step over a tile of keys (padded keys count as -1e30):
//     m_new = max(m, max_j q'.k_j)        alpha = exp2(m - m_new)
//     p_j   = exp2(q'.k_j - m_new)
//     l     = l * alpha + sum_j p_j       acc = acc * alpha + sum_j bf16(p_j) v_j
//   o   = acc / l
//   L2  = m + log2(l)    (f32, (B, H, Sq); only when a stats pointer is given)
// m starts at -1e30, so the first step's alpha is exp2(-1e30 - m_new) = 0; a
// tile always holds at least one real key (K8's second sub-tile may hold
// none: its logits are all -1e30, below any real maximum, so its p are 0).
//
// What bounds it on the H100: as K1, the two products (4*Sq*Sk*D flops per
// head) on the tensor cores; the running max adds a row reduction, one
// exp2 and a rescale of the 16x128 accumulator per step.
//
// Design: K1's structure.  One block of 4 warps per (64 query rows, head,
// batch), each warp owning 16 rows; key tiles of kSub x 64 keys,
// double-buffered in shared memory with cp.async; both products on
// mma.sync m16n8k16 bf16 with fp32 accumulators; the per-row max is reduced
// over the four threads of a row with shuffles and m, l and alpha live in
// registers.  kSub = 1 is K2; kSub = 2 is K8, which takes one max over both
// sub-tiles and rescales once.  With kSub = 2 the q fragments are read from
// shared memory at each k-step instead of being held, to leave registers
// for the second sub-tile's logits.

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 64;   // query rows per block
constexpr int kSubK = 64; // keys per sub-tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int kSub>
constexpr int smem_bytes() {
  return (kBQ + 4 * kSub * kSubK) * kChunks * 16;  // q + 2x(k, v)
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* l2;  // (B, H, Sq) base-2 logsumexp, or nullptr (not wanted)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
  float q_scale;
};

template <int kSub>
__global__ void __launch_bounds__(kThreads)
flash_fwd_online_kernel(const Args a) {
  constexpr int kBK = kSub * kSubK;
  extern __shared__ __align__(128) uint4 smem[];
  uint4* s_q = smem;
  uint4* s_k = s_q + kBQ * kChunks;      // two buffers
  uint4* s_v = s_k + 2 * kBK * kChunks;  // two buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int ntiles = (a.sk + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int buf) {
    load_tile_async<kBK, kThreads>(s_k + buf * kBK * kChunks, kb, a.k_ss,
                                   tile * kBK, a.sk, tid);
    load_tile_async<kBK, kThreads>(s_v + buf * kBK * kChunks, vb, a.v_ss,
                                   tile * kBK, a.sk, tid);
    cp_async_commit();
  };

  load_kv(0, 0);

  // q tile: fp32 scale, bf16 downcast, swizzled store; rows past Sq are 0
  const bool scale_q = a.q_scale != 1.f;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.sq) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)row * a.q_ss + c * 8);
      if (scale_q) {
        const uint4 raw = val;
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t* out = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          out[j] = pack_bf16(f.x * a.q_scale, f.y * a.q_scale);
        }
      }
    }
    s_q[swz(r, c)] = val;
  }
  __syncthreads();

  // K2 holds q as A fragments (8 steps of 16 along D); K8 reads them per step
  uint32_t qf[8][4];
  if constexpr (kSub == 1) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      ldsm_x4(qf[kk], a_frag_addr(s_q, warp * 16, kk, lane));
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float lsum[2] = {0.f, 0.f};          // this thread's share of each row's l
  float mrow[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8

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

    // S = q' K^T for 16 rows x kBK keys
    float s[8 * kSub][4];
#pragma unroll
    for (int i = 0; i < 8 * kSub; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[4];
      if constexpr (kSub == 1) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_x4(qa, a_frag_addr(s_q, warp * 16, kk, lane));
      }
#pragma unroll
      for (int np = 0; np < 4 * kSub; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, b_frag_addr(tk, np * 16, kk, lane));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // padded keys count as -1e30; one max over the whole step's keys
    const int kbase = t * kBK;
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8 * kSub; ++nt) {
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
    }
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // p = exp2(s - m_new) (0 for padded keys), O += P V, a sub-tile at a time
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      uint32_t pf[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* sv = s[sub * 8 + nt];
        const float p0 = fast_exp2(sv[0] - mrow[0]);
        const float p1 = fast_exp2(sv[1] - mrow[0]);
        const float p2 = fast_exp2(sv[2] - mrow[1]);
        const float p3 = fast_exp2(sv[3] - mrow[1]);
        lsum[0] += p0 + p1;
        lsum[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int dp = 0; dp < 8; ++dp) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, bt_frag_addr(tv, sub * kSubK + j * 16, dp, lane));
          mma_bf16(acc[2 * dp], pf[j], vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pf[j], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
    lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
  }
  if (a.l2 != nullptr && tig == 0) {
    // the backward's residual: L2 = m + log2(l), one per query row
    float* l2b = a.l2 + ((long long)b * a.heads + h) * a.sq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + warp * 16 + g + hh * 8;
      if (row < a.sq) l2b[row] = mrow[hh] + log2f(lsum[hh]);
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

template <int kSub>
int launch(const void* q, const void* k, const void* v, void* o, void* l2,
           const long long* strides, int batch, int heads, int sq, int sk,
           float q_scale, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.l2 = static_cast<float*>(l2);
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.heads = heads; a.sq = sq; a.sk = sk;
  a.q_scale = q_scale;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_online_kernel<kSub>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<kSub>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_online_kernel<kSub><<<grid, kThreads, smem_bytes<kSub>(),
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success). `strides`
// points at 12 element strides on the host: (batch, sequence, head) of q, k,
// v, o. l2 may be nullptr (no stats wanted).

// K2: one 64-key tile per step
int flash_attention_online_fwd(const void* q, const void* k, const void* v,
                               void* o, void* l2, const long long* strides,
                               int batch, int heads, int sq, int sk,
                               float q_scale, void* stream) {
  return launch<1>(q, k, v, o, l2, strides, batch, heads, sq, sk, q_scale, stream);
}

// K8: two 64-key sub-tiles per step, one merged max / alpha update
int flash_attention_online_dual_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* l2, const long long* strides,
                                    int batch, int heads, int sq, int sk,
                                    float q_scale, void* stream) {
  return launch<2>(q, k, v, o, l2, strides, batch, heads, sq, sk, q_scale, stream);
}

const char* flash_attention_online_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
