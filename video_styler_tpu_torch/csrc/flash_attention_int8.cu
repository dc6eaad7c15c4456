// K6 and K7: SageAttention-style int8 flash-attention forward for Hopper
// (sm_90a): Q K^T on the s8 tensor cores, P V in bf16.
//
// K6 replaces the Pallas kernels `_flash_kernel_int8_4d_capped`
// (video_styler_tpu/ops/flash_attention.py:1025) and `_flash_kernel_int8_4d`
// (:980), reached through `_flash_fwd_4d_int8` (:1072); K7 replaces the 3-D
// twin `_flash_kernel_int8` (:862, via `_flash_fwd_3d_int8`), which is the
// online body on (BH, S, D) tensors: the wrapper hands this kernel their
// (BH, S, 1, D) views. The pre-pass that makes the inputs (token-mean
// smoothing of K, per-row absmax quantisation, the row bound m2) is a set
// of plain reductions outside the kernel, as in the JAX package.
//
// Inputs: q8 (B, Sq, N, D) and k8 (B, Sk, N, D) int8 and v bf16
// (B, Sk, N, D), read through 4-D tensor maps; qs (B, N, Sq) f32 row
// scales (carrying the softmax scale and log2 e), ks (B, N, Sk_pad) f32,
// the key scales padded by the wrapper to whole 128-key tiles, and on the
// capped body m2 (B, N, Sq) f32.
// What it computes, per query row i (the Pallas kernels' rounding points):
//   s_ij = (f32(q8_i . k8_j) * qs_i) * ks_j          (the int32 dot is exact)
//   capped:  p_ij = exp2(s_ij - m2_i), 0 past Sk; l = sum_j p_ij;
//            o = (sum_j bf16(p_ij) v_j) / max(l, 1e-37)
//   online:  K2's running max over 128-key steps, keys past Sk at -1e30:
//            m_new = max(m, max_j s_ij), alpha = exp2(m - m_new),
//            p = exp2(s - m_new), l and acc rescaled by alpha every step,
//            o = acc / l
//
// What bounds it on the H100: 2*Sq*Sk*D int8 operations per head at 1,979
// TOP/s plus 2*Sq*Sk*D bf16 flops at 989 TFLOP/s (13.6 ms at 29,640 tokens
// and 40 heads, against K1's 18.2 ms); the bytes are a third of a
// millisecond. It is bound by the tensor cores, and beside them by the
// per-logit work: a conversion, two multiplies and an exp2.
//
// Design: K1's block. Per (128 query rows, head, batch) three warpgroups:
// warpgroup 2 is the producer, which gives up registers (setmaxnreg) and
// of which one thread issues every TMA load: the block's int8 Q tile once
// (128 rows x 128 bytes, one 128-byte-swizzled box), then per step of 128
// keys the int8 K tile (one box, 16 KB), the bf16 V tile (two 64-column
// boxes, 32 KB) and the tile's 128 key scales (one 512-byte bulk copy)
// into a ring of two stages that mbarriers complete and release (a third
// stage, which shared memory would hold, measured no faster; consumers
// reading their key scales from device memory measured slower). Warpgroups 0
// and 1 are the consumers, 64 query rows each; per step: S = q8 k8^T on
// wgmma m64n128k32 s8 (both operands K-major from shared memory, four
// steps of 32 bytes along D, exact s32 sums in 64 registers a thread),
// the logits dequantised in registers with the key scales from shared
// memory, p = exp2(s - m2) (capped) or the running max's p (online)
// packed to bf16 A fragments, and O += bf16(P) V on wgmma with A from
// registers and V as an MN-major B, as in K1. Q needs no rescale: the
// scales are applied to the logits, so the consumers start on the tile as
// TMA wrote it.
// The dot is an integer of magnitude at most 128 * 127^2 = 2,064,512 <
// 2^24, so cvt.rn.f32.s32 gives it exactly. An integer add and an fp32
// subtract would too (|x| < 2^22: x + 0x4B400000 is the bit pattern of the
// float 1.5 * 2^23 + x), but they load the fp32 pipe that the dequantising
// multiplies already fill, and measured 1-3% slower on the self-attention
// shapes.
// Ragged tails: TMA fills rows past Sq or Sk with zeros; keys past Sk get
// p = 0 (capped) or the logit -1e30 before the row max (online); the key
// scales past Sk are the wrapper's zero padding; rows past Sq are not
// stored, and their qs and m2 are not read.

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;                 // query rows per block (2 x 64)
constexpr int kBK = 128;                 // keys per step
constexpr int kThreads = 384;            // 2 consumer warpgroups + 1 producer
constexpr int kStages = 2;
constexpr int kQBytes = kBQ * 128;       // 16 KB: per consumer [64 rows][128 B]
constexpr int kKBytes = kBK * 128;       // 16 KB: [128 keys][128 B]
constexpr int kHalfV = kBK * 128;        // one 64-column box of a V tile
constexpr int kVBytes = 2 * kHalfV;      // 32 KB
constexpr int kKsBytes = kBK * 4;        // the step's key scales
constexpr int kStageBytes = kKBytes + kVBytes;
constexpr int kOffStages = kQBytes;
constexpr int kOffKs = kOffStages + kStages * kStageBytes;
constexpr int kOffBar = kOffKs + kStages * kKsBytes;
constexpr int kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
constexpr float kNegInf = -1e30f;

struct Params {
  const float* qs;  // (B, H, Sq)
  const float* ks;  // (B, H, ks_row): each (b, h) row padded to whole steps
  const float* m2;  // (B, H, Sq), capped only
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk, ks_row;
};

template <bool kCapped>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_int8_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Params a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + kOffBar;
  const uint32_t bar_full = bar_q + 8;                // [kStages]
  const uint32_t bar_empty = bar_q + 8 + 8 * kStages;  // [kStages]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (a.sk + kBK - 1) / kBK;
  const long long bh = (long long)b * a.heads + h;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
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
      tma_load_4d(base, &qmap, 0, h, q0, b, bar_q);
      const float* ksb = a.ks + bh * a.ks_row;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t st = base + kOffStages + s * kStageBytes;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, kStageBytes + kKsBytes);
        bulk_load(base + kOffKs + s * kKsBytes, ksb + t * kBK, kKsBytes, full);
        tma_load_4d(st, &kmap, 0, h, t * kBK, b, full);
        tma_load_4d(st + kKBytes, &vmap, 0, h, t * kBK, b, full);
        tma_load_4d(st + kKBytes + kHalfV, &vmap, 64, h, t * kBK, b, full);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    const int wg = tid >> 7;  // consumer warpgroup: query rows 64 wg..
    const int warp = (tid >> 5) & 3;
    const int g = (tid & 31) >> 2;
    const int tig = tid & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + g;  // and row0 + 8

    float qsr[2], m2r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + hh * 8;
      const bool ok = row < a.sq;
      qsr[hh] = ok ? a.qs[bh * a.sq + row] : 0.f;
      m2r[hh] = (kCapped && ok) ? a.m2[bh * a.sq + row] : 0.f;
    }
    mbar_wait(bar_q, 0);

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float l[2] = {0.f, 0.f};          // this thread's share of each row's l
    float m[2] = {kNegInf, kNegInf};  // online: running max of rows g, g + 8

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      const uint32_t sb = opaque(base);
      const uint32_t tk = sb + kOffStages + s * kStageBytes;
      const uint32_t qt = sb + wg * (kQBytes / 2);
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S = q8 k8^T: 64 rows x 128 keys, 4 steps of 32 bytes along D
      int si[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k32_s8(si, wgmma_desc(qt + kk * 32, 16, 1024),
                            wgmma_desc(tk + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(si);

      // dequantise: (dot * qs) * ks, the dot converted exactly and each
      // product rounded (no contraction); this thread's keys are 8 nt +
      // 2 tig and + 1
      const int kbase = t * kBK;
      float sv[64];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int key = kbase + nt * 8 + tig * 2;
        float2 kq;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(kq.x), "=f"(kq.y)
                     : "r"(sb + kOffKs + s * kKsBytes + (nt * 8 + tig * 2) * 4));
        sv[4 * nt + 0] = __fmul_rn(__fmul_rn(__int2float_rn(si[4 * nt + 0]), qsr[0]), kq.x);
        sv[4 * nt + 1] = __fmul_rn(__fmul_rn(__int2float_rn(si[4 * nt + 1]), qsr[0]), kq.y);
        sv[4 * nt + 2] = __fmul_rn(__fmul_rn(__int2float_rn(si[4 * nt + 2]), qsr[1]), kq.x);
        sv[4 * nt + 3] = __fmul_rn(__fmul_rn(__int2float_rn(si[4 * nt + 3]), qsr[1]), kq.y);
      }
      const bool tail = kbase + kBK > a.sk;

      float sub[2];  // what exp2 subtracts from each row's logits
      if constexpr (kCapped) {
        sub[0] = m2r[0];
        sub[1] = m2r[1];
      } else {
        float mx[2] = {kNegInf, kNegInf};
        if (tail) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int key = kbase + nt * 8 + tig * 2;
            if (key >= a.sk) sv[4 * nt + 0] = sv[4 * nt + 2] = kNegInf;
            if (key + 1 >= a.sk) sv[4 * nt + 1] = sv[4 * nt + 3] = kNegInf;
          }
        }
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          mx[0] = fmaxf(mx[0], fmaxf(sv[4 * nt + 0], sv[4 * nt + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sv[4 * nt + 2], sv[4 * nt + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          alpha[hh] = fast_exp2(m[hh] - m_new);
          m[hh] = m_new;
          l[hh] *= alpha[hh];
          sub[hh] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          acc[4 * nt + 0] *= alpha[0];
          acc[4 * nt + 1] *= alpha[0];
          acc[4 * nt + 2] *= alpha[1];
          acc[4 * nt + 3] *= alpha[1];
        }
      }

      // p = exp2(s - sub) (capped: 0 past Sk); fp32 row sums; bf16 A
      // fragments of the P V product
      uint32_t pf[8][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        float p0 = fast_exp2(__fsub_rn(sv[4 * nt + 0], sub[0]));
        float p1 = fast_exp2(__fsub_rn(sv[4 * nt + 1], sub[0]));
        float p2 = fast_exp2(__fsub_rn(sv[4 * nt + 2], sub[1]));
        float p3 = fast_exp2(__fsub_rn(sv[4 * nt + 3], sub[1]));
        if (kCapped && tail) {
          const int key = kbase + nt * 8 + tig * 2;
          if (key >= a.sk) p0 = p2 = 0.f;
          if (key + 1 >= a.sk) p1 = p3 = 0.f;
        }
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V: 8 steps of 16 keys, V an MN-major B (D contiguous)
      const uint32_t tv = tk + kKBytes;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128_rs<1>(acc, pf[kk], wgmma_desc(tv + kk * 2048, kHalfV, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if (kCapped) l[hh] = fmaxf(l[hh], 1e-37f);  // a flushed row gives 0, not NaN
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
            pack_bf16(acc[4 * nt + 2 * hh] / l[hh], acc[4 * nt + 2 * hh + 1] / l[hh]);
      }
    }
  }
}

template <bool kCapped>
int launch(const void* q8, const void* k8, const void* v, const void* qs, const void* ks,
           const void* m2, void* o, const long long* layout, const long long* o_strides,
           int batch, int heads, int sq, int sk, int ks_row, void* stream) {
  CUtensorMap maps[3];
  int e = encode_int8_map(&maps[0], q8, layout, kBQ);
  if (e == 0) e = encode_int8_map(&maps[1], k8, layout + kMapLayout, kBK);
  if (e == 0) e = encode_bf16_map(&maps[2], v, layout + 2 * kMapLayout, kBK);
  if (e != 0) return kMapError + e;
  Params a;
  a.qs = static_cast<const float*>(qs);
  a.ks = static_cast<const float*>(ks);
  a.m2 = static_cast<const float*>(m2);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o_sb = o_strides[0];
  a.o_ss = o_strides[1];
  a.o_sh = o_strides[2];
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.ks_row = ks_row;
  cudaError_t ce = cudaFuncSetAttribute(flash_fwd_int8_kernel<kCapped>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kSmemBytes);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_int8_kernel<kCapped><<<grid, kThreads, kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                        maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// layout: the tensor-map layouts of q8, k8 and v (7 values each, see
// kMapLayout); o_strides: (batch, seq, head) element strides of o; ks_row:
// the length of each (batch, head) row of ks, a multiple of 128 at least
// Sk. Both return 0, a cudaError_t after the launch, or kMapError + a
// CUresult. K7 is the online entry on (BH, S, 1, D) views, batch = BH,
// heads = 1.

// K6, capped: m2 holds each row's bound on its logits
int flash_attention_int8_capped_fwd(const void* q8, const void* k8, const void* v,
                                    const void* qs, const void* ks, const void* m2,
                                    void* o, const long long* layout,
                                    const long long* o_strides, int batch, int heads,
                                    int sq, int sk, int ks_row, void* stream) {
  return launch<true>(q8, k8, v, qs, ks, m2, o, layout, o_strides, batch, heads, sq, sk,
                      ks_row, stream);
}

// K6 (and K7), online softmax
int flash_attention_int8_online_fwd(const void* q8, const void* k8, const void* v,
                                    const void* qs, const void* ks, void* o,
                                    const long long* layout, const long long* o_strides,
                                    int batch, int heads, int sq, int sk, int ks_row,
                                    void* stream) {
  return launch<false>(q8, k8, v, qs, ks, nullptr, o, layout, o_strides, batch, heads, sq,
                       sk, ks_row, stream);
}

const char* flash_attention_int8_error_string(int code) { return error_string(code); }

}  // extern "C"
