// K1: capped-softmax flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel_4d_capped`
// (video_styler_tpu/ops/flash_attention.py:213, reached through
// `_flash_fwd_4d` with capped=True).  Non-causal attention on the
// (B, S, N, D) layout, read through strides by TMA: no transpose, no copy.
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
// Design: one block of three warpgroups per (128 query rows, head, batch).
// Warpgroup 2 is the producer: after giving up registers (setmaxnreg) one
// of its threads issues every TMA load: the block's Q tile once, then K
// and V tiles of 128 keys into a ring of two stages, each stage released
// by the consumers through an mbarrier. Warpgroups 0 and 1 are the
// consumers, 64 query rows each. Each rescales its Q rows in shared memory
// once (q', the rounding point above, and ||q'|| for m2), fences the async
// proxy, then per key tile: S = q' K^T on wgmma m64n128k16 (A and B from
// shared memory), p = exp2(s - m2) in registers, re-packed from the S
// accumulator layout into A fragments, and O += bf16(P) V on wgmma with A
// from registers and V as an MN-major B. The two consumers overlap each
// other's exp2 with their products through the warp scheduler; there is no
// explicit ping-pong yet. Shared memory: Q 32 KB + 2 x (K 32 + V 32 KB).
// Ragged tails: TMA fills rows past Sq or Sk with zeros; keys past Sk get
// p = 0 on the last tile; rows past Sq are not stored.

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;             // query rows per block (2 x 64)
constexpr int kBK = 128;             // keys per tile
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kQBytes = kBQ * 256;   // 32 KB: per consumer [2 halves][64][128 B]
constexpr int kKVBytes = kBK * 256;  // 32 KB: [2 halves][128 rows][128 B]
constexpr int kHalfKV = kBK * 128;   // one 64-column box of a K or V tile
constexpr int kOffK = kQBytes;
constexpr int kStageBytes = 2 * kKVBytes;  // K then V
constexpr int kOffM2 = kOffK + 2 * kStageBytes;
constexpr int kOffBar = kOffM2 + kBQ * 4;
constexpr int kSmemBytes = kOffBar + 64 + 1024;  // + alignment slack

struct Params {
  const float* kmax;  // (B, H)
  __nv_bfloat16* o;
  float* l2;          // (B, H, Sq) base-2 logsumexp, or nullptr (not wanted)
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
  float q_scale;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_capped_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Params a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const s_m2 = reinterpret_cast<float*>(sbase + kOffM2);
  const uint32_t bar_q = base + kOffBar;
  const uint32_t bar_full = bar_q + 8;    // [2]
  const uint32_t bar_empty = bar_q + 24;  // [2]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (a.sk + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    regs_dealloc<40>();
    if (tid == 256) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int w = 0; w < 2; ++w)
        for (int hf = 0; hf < 2; ++hf)
          tma_load_4d(base + w * (kQBytes / 2) + hf * (kQBytes / 4), &qmap, hf * 64, h,
                      q0 + 64 * w, b, bar_q);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(bar_empty + 8 * s, ((t >> 1) - 1) & 1);
        const uint32_t st = base + kOffK + s * kStageBytes;
        mbar_expect_tx(bar_full + 8 * s, kStageBytes);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load_4d(st + hf * kHalfKV, &kmap, hf * 64, h, t * kBK, b, bar_full + 8 * s);
          tma_load_4d(st + kKVBytes + hf * kHalfKV, &vmap, hf * 64, h, t * kBK, b,
                      bar_full + 8 * s);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    const int wg = tid >> 7;        // consumer warpgroup: query rows 64 wg..
    const int wt = tid & 127;
    const int warp = wt >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const uint32_t qs = base + wg * (kQBytes / 2);  // [2 halves][64 rows][128 B]

    // q' = bf16(q * scale * log2 e) in place, and m2 from ||q'||: two
    // threads per row, one 64-column half each
    mbar_wait(bar_q, 0);
    {
      const int r = wt >> 1;
      const int hf = wt & 1;
      uint4* row = reinterpret_cast<uint4*>(sbase + wg * (kQBytes / 2) +
                                            hf * (kQBytes / 4) + r * 128);
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint4 val = row[c];
        uint32_t* e = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&e[j]));
          e[j] = pack_bf16(f.x * a.q_scale, f.y * a.q_scale);
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&e[j]));
          ss += r2.x * r2.x + r2.y * r2.y;
        }
        row[c] = val;
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      if (hf == 0)
        s_m2[wg * 64 + r] = fminf(sqrtf(ss) * (a.kmax[b * a.heads + h] * 1.0001f), 96.f);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    float m2[2];
    m2[0] = s_m2[wg * 64 + warp * 16 + g];
    m2[1] = s_m2[wg * 64 + warp * 16 + g + 8];

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float lsum[2] = {0.f, 0.f};

    for (int t = 0; t < ntiles; ++t) {
      const int s = t & 1;
      const uint32_t tk = opaque(base) + kOffK + s * kStageBytes;
      const uint32_t tv = tk + kKVBytes;
      mbar_wait(bar_full + 8 * s, (t >> 1) & 1);

      // S = q' K^T: 64 rows x 128 keys, 8 steps of 16 along D
      float sacc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * (kQBytes / 4) + (kk & 3) * 32;
        const uint32_t koff = (kk >> 2) * kHalfKV + (kk & 3) * 32;
        wgmma_m64n128_ss<0, 0>(sacc, wgmma_desc(opaque(qs) + off, 16, 1024),
                               wgmma_desc(tk + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sacc);

      // p = exp2(s - m2), 0 past Sk; fp32 row sums; bf16 A fragments
      const int kbase = t * kBK;
      const bool tail = kbase + kBK > a.sk;
      uint32_t pf[8][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int key = kbase + nt * 8 + tig * 2;
        float p0 = fast_exp2(sacc[4 * nt + 0] - m2[0]);
        float p1 = fast_exp2(sacc[4 * nt + 1] - m2[0]);
        float p2 = fast_exp2(sacc[4 * nt + 2] - m2[1]);
        float p3 = fast_exp2(sacc[4 * nt + 3] - m2[1]);
        if (tail) {
          if (key >= a.sk) p0 = p2 = 0.f;
          if (key + 1 >= a.sk) p1 = p3 = 0.f;
        }
        lsum[0] += p0 + p1;
        lsum[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V: 8 steps of 16 keys, V an MN-major B (D contiguous)
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n128_rs<1>(acc, pf[kk], wgmma_desc(tv + kk * 2048, kHalfKV, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
      lsum[hh] = fmaxf(lsum[hh], 1e-37f);  // a flushed row gives 0, not NaN
    }
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    if (a.l2 != nullptr && tig == 0) {
      // the backward's residual: L2 = m2 + log2(l), one per query row
      float* l2b = a.l2 + ((long long)b * a.heads + h) * a.sq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + hh * 8;
        if (row < a.sq) l2b[row] = m2[hh] + log2f(lsum[hh]);
      }
    }
    __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + hh * 8;
      if (row >= a.sq) continue;
      __nv_bfloat16* orow = ob + (long long)row * a.o_ss;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + tig * 2) =
            pack_bf16(acc[4 * nt + 2 * hh] / lsum[hh], acc[4 * nt + 2 * hh + 1] / lsum[hh]);
      }
    }
  }
}

}  // namespace

extern "C" {

// layout: the tensor-map layouts of q, k and v (7 values each, see
// kMapLayout); o_strides: (batch, seq, head) element strides of o. Returns
// 0, a cudaError_t after the launch, or kMapError + a CUresult. l2 may be
// nullptr (inference: no stats wanted).
int flash_attention_capped_fwd(const void* q, const void* k, const void* v,
                               const void* kmax, void* o, void* l2,
                               const long long* layout, const long long* o_strides,
                               int batch, int heads, int sq, int sk, float q_scale,
                               void* stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {64, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    const int e = encode_bf16_map(&maps[i], ptrs[i], layout + kMapLayout * i, rows[i]);
    if (e != 0) return kMapError + e;
  }
  Params a;
  a.kmax = static_cast<const float*>(kmax);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.l2 = static_cast<float*>(l2);
  a.o_sb = o_strides[0];
  a.o_ss = o_strides[1];
  a.o_sh = o_strides[2];
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.q_scale = q_scale;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_capped_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                 maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) { return error_string(code); }

}  // extern "C"
