// K2 and K8: online-softmax flash-attention forward for Hopper (sm_90a).
//
// K2 replaces the Pallas kernel `_flash_kernel_4d`
// (video_styler_tpu/ops/flash_attention.py:150, reached through
// `_flash_fwd_4d` with capped=False) and, on an n = 1 view, its 3-D twin
// `_flash_kernel` (:54, via `_flash_fwd_3d`).  K8 replaces
// `_flash_kernel_4d_dual` (:288, `_flash_fwd_4d(dual=True)`): the same
// function with two key sub-tiles per loop step and one merged update.
// Non-causal attention on the (B, S, N, D) layout, read through strides by
// TMA: no transpose, no copy.
//
// What it computes, per query row (the Pallas kernel's rounding points):
//   q'  = bf16(q * scale * log2(e))      (fp32 multiply, downcast; a launch
//                                         with q_scale = 1 takes q as it is)
//   per step over a tile of keys (K2: 128 keys; K8: two sub-tiles of 128,
//   one max over both; keys past Sk count as -1e30):
//     m_new = max(m, max_j q'.k_j)        alpha = exp2(m - m_new)
//     p_j   = exp2(q'.k_j - m_new)
//     l     = l * alpha + sum_j p_j       acc = acc * alpha + sum_j bf16(p_j) v_j
//   o   = acc / l
//   L2  = m + log2(l)    (f32, (B, H, Sq); only when a stats pointer is given)
// m starts at -1e30, so the first step's alpha is exp2(-1e30 - m_new) = 0. A
// step always holds at least one real key; K8's second sub-tile may hold
// none (Sk = 300: keys 384..511 of the second step), and then its logits
// are all -1e30, below the first sub-tile's real maximum, so its p are 0.
// The accumulator is rescaled by alpha at every step, whether m moved or
// not: alpha = 1 leaves it exactly as it was, so both choices round alike.
//
// What bounds it on the H100: as K1, the two products, 4*Sq*Sk*D flops per
// head (at the 14B self-attention shape, 29,640^2 x 40 heads, ~1.8e13
// flops, 18 ms at the 989 TFLOP/s bf16 peak), against 1.2 GB of q/k/v/o
// traffic (0.4 ms at 3.35 TB/s).  It is bound by the tensor cores; the
// running max adds, per step and row, a reduction over the quad, one exp2
// and a rescale of the 64 x 128 accumulator.
//
// Design. Both kernels take 128 query rows per block in two consumer
// warpgroups of 64 rows, which rescale their Q rows in shared memory once
// (q', the rounding point above) and fence the async proxy; per key tile:
// S = q' K^T on wgmma m64n128k16 (A and B from shared memory), the masked
// row max reduced over the four threads of a row with two shuffles, p =
// exp2(s - m_new) from the S accumulator, and O += bf16(P) V on wgmma with
// V as an MN-major B. K and V arrive by TMA (128-byte swizzle) into rings
// of stages completed and released through mbarriers.
//   K2 is K1's block: a third, producer warpgroup (setmaxnreg 232/40) of
//   which one thread issues every load, K and V tiles of 128 keys in a
//   ring of two stages. P goes to the P V product as register A fragments.
//   Its 64 S + 64 O accumulators fit the 168 registers that three
//   warpgroups leave each thread.
//   K8 holds the S accumulators of both sub-tiles (128) beside O (64): that
//   does not fit 168, so it runs K3's block, two warpgroups and no producer
//   (255 registers a thread), thread 0 issuing, at the start of each step,
//   the K tiles of the next step (a ring of two steps, 4 x 32 KB) and the
//   V tiles of this one (a ring of one step, 2 x 32 KB). Three 64-register
//   accumulators leave too few registers for P as A fragments as well
//   (ptxas spilled), so P goes through shared memory: once both
//   warpgroups' S products have landed (a 256-thread barrier), each K
//   stage of the step takes the bf16 P of its sub-tile (16 KB per
//   warpgroup, swizzled by hand), and the P V product reads it as a
//   K-major A. The second sub-tile's S product runs while the first one's
//   row max is taken, the first sub-tile's P V product while the second
//   one's p are computed. Shared memory: Q 32 KB + 192 KB of rings.
// Ragged tails: TMA fills rows past Sq or Sk with zeros; the logits of keys
// past Sk are set to -1e30 before the row max; rows past Sq are not stored.

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;                // query rows per block (2 x 64)
constexpr int kBK = 128;                // keys per tile
constexpr int kQBytes = kBQ * 256;      // 32 KB: per consumer [2 halves][64][128 B]
constexpr int kTileBytes = kBK * 256;   // one K or V tile: [2 halves][128 rows][128 B]
constexpr int kHalfTile = kBK * 128;    // one 64-column box of a tile
constexpr float kNegInf = -1e30f;

struct Params {
  __nv_bfloat16* o;
  float* l2;          // (B, H, Sq) base-2 logsumexp, or nullptr (not wanted)
  long long o_sb, o_ss, o_sh;
  int heads, sq, sk;
  float q_scale;
};

// Consumer thread coordinates within its warpgroup of 64 query rows.
struct Lane {
  int wg, wt, warp, g, tig;
  __device__ __forceinline__ explicit Lane(int tid)
      : wg(tid >> 7), wt(tid & 127), warp((tid >> 5) & 3), g((tid & 31) >> 2),
        tig(tid & 3) {}
};

// The Q boxes of the block: for each warpgroup its 64 rows, two 64-column
// halves, completing on `bar`.
__device__ __forceinline__ void load_q(uint32_t base, const CUtensorMap* qmap, int h,
                                       int q0, int b, uint32_t bar) {
  mbar_expect_tx(bar, kQBytes);
  for (int w = 0; w < 2; ++w)
    for (int hf = 0; hf < 2; ++hf)
      tma_load_4d(base + w * (kQBytes / 2) + hf * (kQBytes / 4), qmap, hf * 64, h,
                  q0 + 64 * w, b, bar);
}

// One 128-key tile of K or V into `dst`, completing on `bar` (whose
// expect_tx the caller has announced).
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int h,
                                          int key0, int b, uint32_t bar) {
  for (int hf = 0; hf < 2; ++hf)
    tma_load_4d(dst + hf * kHalfTile, map, hf * 64, h, key0, b, bar);
}

// q' = bf16(q * q_scale) in place over this warpgroup's 64 rows: two
// threads per row, one 64-column half each (the swizzle permutes chunks
// within a row, so the row is scaled whole either way).
__device__ __forceinline__ void scale_q(uint8_t* rows, int wt, float q_scale) {
  uint4* row = reinterpret_cast<uint4*>(rows + (wt & 1) * (kQBytes / 4) + (wt >> 1) * 128);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint4 val = row[c];
    uint32_t* e = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&e[j]));
      e[j] = pack_bf16(f.x * q_scale, f.y * q_scale);
    }
    row[c] = val;
  }
}

// S = q' K^T for this warpgroup's 64 rows and one 128-key tile: 8 wgmma
// steps of 16 along D (the caller fences and commits).
__device__ __forceinline__ void s_product(float (&s)[64], uint32_t qs, uint32_t tk) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * (kQBytes / 4) + (kk & 3) * 32;
    const uint32_t koff = (kk >> 2) * kHalfTile + (kk & 3) * 32;
    wgmma_m64n128_ss<0, 0>(s, wgmma_desc(qs + off, 16, 1024),
                           wgmma_desc(tk + koff, 16, 1024), kk > 0);
  }
}

// Logits of keys past Sk become -1e30 (TMA zero-filled them); mx takes
// this thread's maximum of its rows g and g + 8 (columns 8 nt + 2 tig, +1).
__device__ __forceinline__ void mask_and_max(float (&s)[64], int kbase, int sk, int tig,
                                             float (&mx)[2]) {
  if (kbase + kBK > sk) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int key = kbase + nt * 8 + tig * 2;
      if (key >= sk) s[4 * nt + 0] = s[4 * nt + 2] = kNegInf;
      if (key + 1 >= sk) s[4 * nt + 1] = s[4 * nt + 3] = kNegInf;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt + 0], s[4 * nt + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
}

// The step's update: the row max over the quad, m_new, alpha, and l and
// the accumulator rescaled by alpha.
__device__ __forceinline__ void online_update(float (&mx)[2], float (&m)[2], float (&l)[2],
                                              float (&acc)[64]) {
  float alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    alpha[hh] = fast_exp2(m[hh] - m_new);
    m[hh] = m_new;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    acc[4 * nt + 0] *= alpha[0];
    acc[4 * nt + 1] *= alpha[0];
    acc[4 * nt + 2] *= alpha[1];
    acc[4 * nt + 3] *= alpha[1];
  }
}

// p = exp2(s - m) in fp32, summed into this thread's share of l, rounded
// to bf16 A fragments (the m16n8k16 layout) of the P V product.
__device__ __forceinline__ void p_fragments(const float (&s)[64], const float (&m)[2],
                                            float (&l)[2], uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float p0 = fast_exp2(s[4 * nt + 0] - m[0]);
    const float p1 = fast_exp2(s[4 * nt + 1] - m[0]);
    const float p2 = fast_exp2(s[4 * nt + 2] - m[1]);
    const float p3 = fast_exp2(s[4 * nt + 3] - m[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
    pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// O += P V over one 128-key tile: 8 wgmma steps of 16 keys, V an MN-major
// B (D contiguous); the caller fences and commits.
__device__ __forceinline__ void pv_product(float (&acc)[64], const uint32_t (&pf)[8][4],
                                           uint32_t tv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n128_rs<1>(acc, pf[kk], wgmma_desc(tv + kk * 2048, kHalfTile, 1024), 1);
}

// p = exp2(s - m) in fp32, summed into this thread's share of l, rounded
// to bf16 and stored as a [2 halves][64 rows][128 B] tile (rows warp * 16
// + g and + 8, the 128-byte swizzle by hand: both rows have the chunk
// order of g), the K-major A operand of pv_product_ss. A warp's stores of
// one nt cover 8 chunks x 4 lanes: every bank once.
__device__ __forceinline__ void p_to_smem(const float (&s)[64], const float (&m)[2],
                                          float (&l)[2], uint32_t tile, int warp, int g,
                                          int tig) {
  const uint32_t row = tile + (warp * 16 + g) * 128 + tig * 4;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float p0 = fast_exp2(s[4 * nt + 0] - m[0]);
    const float p1 = fast_exp2(s[4 * nt + 1] - m[0]);
    const float p2 = fast_exp2(s[4 * nt + 2] - m[1]);
    const float p3 = fast_exp2(s[4 * nt + 3] - m[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    const uint32_t at = row + (nt >> 3) * (kQBytes / 4) + (((nt & 7) ^ g) << 4);
    st_shared(at, pack_bf16(p0, p1));
    st_shared(at + 8 * 128, pack_bf16(p2, p3));
  }
}

// O += P V over one 128-key tile with P from shared memory (p_to_smem's
// tile) and V an MN-major B; the caller fences and commits.
__device__ __forceinline__ void pv_product_ss(float (&acc)[64], uint32_t pt, uint32_t tv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n128_ss<0, 1>(acc, wgmma_desc(pt + (kk >> 2) * (kQBytes / 4) + (kk & 3) * 32, 16, 1024),
                           wgmma_desc(tv + kk * 2048, kHalfTile, 1024), 1);
}

// o = acc / l for this thread's rows (rows past Sq are not stored), and
// L2 = m + log2(l) when wanted.
__device__ __forceinline__ void store_rows(const float (&acc)[64], float (&l)[2],
                                           const float (&m)[2], const Params& a, int b,
                                           int h, int row0, int tig) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (a.l2 != nullptr && tig == 0) {
    // the backward's residual: L2 = m + log2(l), one per query row
    float* l2b = a.l2 + ((long long)b * a.heads + h) * a.sq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + hh * 8;
      if (row < a.sq) l2b[row] = m[hh] + log2f(l[hh]);
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
          pack_bf16(acc[4 * nt + 2 * hh] / l[hh], acc[4 * nt + 2 * hh + 1] / l[hh]);
    }
  }
}

// ------------------------------------------------------------------ K2

constexpr int kThreadsK2 = 384;           // 2 consumer warpgroups + 1 producer
constexpr int kStageK2 = 2 * kTileBytes;  // K then V
constexpr int kOffKVK2 = kQBytes;
constexpr int kOffBarK2 = kOffKVK2 + 2 * kStageK2;
constexpr int kSmemK2 = kOffBarK2 + 64 + 1024;  // + alignment slack

__global__ void __launch_bounds__(kThreadsK2, 1)
flash_fwd_online_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Params a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + kOffBarK2;
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
      load_q(base, &qmap, h, q0, b, bar_q);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(bar_empty + 8 * s, ((t >> 1) - 1) & 1);
        const uint32_t st = base + kOffKVK2 + s * kStageK2;
        mbar_expect_tx(bar_full + 8 * s, kStageK2);
        load_tile(st, &kmap, h, t * kBK, b, bar_full + 8 * s);
        load_tile(st + kTileBytes, &vmap, h, t * kBK, b, bar_full + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    const Lane ln(tid);
    const uint32_t qoff = ln.wg * (kQBytes / 2);  // [2 halves][64 rows][128 B]

    mbar_wait(bar_q, 0);
    scale_q(sbase + qoff, ln.wt, a.q_scale);
    fence_proxy_async();
    named_barrier(1 + ln.wg, 128);

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float l[2] = {0.f, 0.f};          // this thread's share of each row's l
    float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8

    for (int t = 0; t < ntiles; ++t) {
      const int s = t & 1;
      const uint32_t sb = opaque(base);
      const uint32_t tk = sb + kOffKVK2 + s * kStageK2;
      mbar_wait(bar_full + 8 * s, (t >> 1) & 1);

      float sacc[64];
      wgmma_fence();
      s_product(sacc, sb + qoff, tk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sacc);

      float mx[2] = {kNegInf, kNegInf};
      mask_and_max(sacc, t * kBK, a.sk, ln.tig, mx);
      online_update(mx, m, l, acc);
      uint32_t pf[8][4];
      p_fragments(sacc, m, l, pf);

      reg_fence(acc);
      wgmma_fence();
      pv_product(acc, pf, tk + kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(bar_empty + 8 * s);
    }
    store_rows(acc, l, m, a, b, h, q0 + ln.wg * 64 + ln.warp * 16 + ln.g, ln.tig);
  }
}

// ------------------------------------------------------------------ K8

constexpr int kSub = 2;                // 128-key sub-tiles per step, one max
constexpr int kThreadsK8 = 256;        // 2 warpgroups, no producer
constexpr int kKStagesK8 = 2 * kSub;   // K (then P) tiles of two steps
constexpr int kVStagesK8 = kSub;       // V tiles of one step
constexpr int kOffKK8 = kQBytes;
constexpr int kOffVK8 = kOffKK8 + kKStagesK8 * kTileBytes;
constexpr int kOffBarK8 = kOffVK8 + kVStagesK8 * kTileBytes;
// mbarriers: Q, then K full and empty [kKStagesK8], V full and empty
// [kVStagesK8]
constexpr int kBarK = 1, kBarV = 1 + 2 * kKStagesK8;
constexpr int kSmemK8 = kOffBarK8 + 8 * (kBarV + 2 * kVStagesK8) + 1024;  // + slack

// Special registers read where they are used: the K8 loop's registers go
// to the two sub-tiles' logits and the accumulator, not to coordinates.
__device__ __forceinline__ int sreg_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ int sreg_ctaid(int dim) {
  int v;
  if (dim == 0) asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  else if (dim == 1) asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  else asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(v));
  return v;
}

__global__ void __launch_bounds__(kThreadsK8, 1)
flash_fwd_online_dual_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const Params a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  // barrier i, at an address rebuilt from an opaque base where used
  auto bar = [&](int i) { return opaque(base) + kOffBarK8 + 8 * i; };
  const int nsteps = (a.sk + kSub * kBK - 1) / (kSub * kBK);

  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < kKStagesK8; ++s) {
      mbar_init(bar(kBarK + s), 1);
      mbar_init(bar(kBarK + kKStagesK8 + s), 256);
    }
    for (int s = 0; s < kVStagesK8; ++s) {
      mbar_init(bar(kBarV + s), 1);
      mbar_init(bar(kBarV + kVStagesK8 + s), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Issued by thread 0: the K tiles of step u into stages (u % 2) * kSub..,
  // the V tiles of step u into stages 0.., each after the stage's previous
  // use (step u - 2 for K, u - 1 for V) has been released by all 256
  // threads.
  auto load_k = [&](int u) {
    for (int i = 0; i < kSub; ++i) {
      const int st = (u & 1) * kSub + i;
      if (u >= 2) mbar_wait(bar(kBarK + kKStagesK8 + st), ((u >> 1) - 1) & 1);
      mbar_expect_tx(bar(kBarK + st), kTileBytes);
      load_tile(opaque(base) + kOffKK8 + st * kTileBytes, &kmap, sreg_ctaid(1),
                (u * kSub + i) * kBK, sreg_ctaid(2), bar(kBarK + st));
    }
  };
  auto load_v = [&](int u) {
    for (int i = 0; i < kSub; ++i) {
      if (u >= 1) mbar_wait(bar(kBarV + kVStagesK8 + i), (u - 1) & 1);
      mbar_expect_tx(bar(kBarV + i), kTileBytes);
      load_tile(opaque(base) + kOffVK8 + i * kTileBytes, &vmap, sreg_ctaid(1),
                (u * kSub + i) * kBK, sreg_ctaid(2), bar(kBarV + i));
    }
  };
  if (threadIdx.x == 0) {
    load_q(base, &qmap, blockIdx.y, blockIdx.x * kBQ, blockIdx.z, bar(0));
    load_k(0);
  }

  {
    const Lane ln(threadIdx.x);
    mbar_wait(bar(0), 0);
    scale_q(sbase + ln.wg * (kQBytes / 2), ln.wt, a.q_scale);
    fence_proxy_async();
    named_barrier(1 + ln.wg, 128);
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float l[2] = {0.f, 0.f};
  float m[2] = {kNegInf, kNegInf};

  for (int t = 0; t < nsteps; ++t) {
    const int kst = (t & 1) * kSub;
    // the next step's K and this step's V (its stages were released at the
    // end of the previous step)
    if (sreg_tid() == 0) {
      if (t + 1 < nsteps) load_k(t + 1);
      load_v(t);
    }
    __syncwarp();
    for (int i = 0; i < kSub; ++i) mbar_wait(bar(kBarK + kst + i), (t >> 1) & 1);

    // S of both sub-tiles, one commit group each
    const uint32_t sb = opaque(base);
    const uint32_t qs = sb + (sreg_tid() >> 7) * (kQBytes / 2);
    float sacc[kSub][64];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      s_product(sacc[i], qs, sb + kOffKK8 + (kst + i) * kTileBytes);
      wgmma_commit();
    }

    // one max over the step's keys: the first sub-tile's while the second
    // one's product runs
    float mx[2] = {kNegInf, kNegInf};
    wgmma_wait<1>();
    reg_fence(sacc[0]);
    mask_and_max(sacc[0], t * kSub * kBK, a.sk, sreg_tid() & 3, mx);
    wgmma_wait<0>();
    reg_fence(sacc[1]);
    mask_and_max(sacc[1], (t * kSub + 1) * kBK, a.sk, sreg_tid() & 3, mx);
    // both warpgroups' S products have read this step's K tiles: their
    // stages take the P tiles now
    named_barrier(3, 256);
    online_update(mx, m, l, acc);

    // p and O += P V a sub-tile at a time: the second sub-tile's p while
    // the first one's product runs
    for (int i = 0; i < kSub; ++i) mbar_wait(bar(kBarV + i), t & 1);
    reg_fence(acc);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int tid = sreg_tid();
      const uint32_t pt =
          opaque(base) + kOffKK8 + (kst + i) * kTileBytes + (tid >> 7) * (kTileBytes / 2);
      p_to_smem(sacc[i], m, l, pt, (tid >> 5) & 3, (tid & 31) >> 2, tid & 3);
      fence_proxy_async();
      named_barrier(1 + (tid >> 7), 128);
      wgmma_fence();
      pv_product_ss(acc, pt, opaque(base) + kOffVK8 + i * kTileBytes);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(acc);
    for (int i = 0; i < kSub; ++i) {
      mbar_arrive(bar(kBarK + kKStagesK8 + kst + i));
      mbar_arrive(bar(kBarV + kVStagesK8 + i));
    }
  }
  const Lane ln(threadIdx.x);
  store_rows(acc, l, m, a, blockIdx.z, blockIdx.y,
             blockIdx.x * kBQ + ln.wg * 64 + ln.warp * 16 + ln.g, ln.tig);
}

template <bool kDual>
int launch(const void* q, const void* k, const void* v, void* o, void* l2,
           const long long* layout, const long long* o_strides, int batch, int heads,
           int sq, int sk, float q_scale, void* stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {64, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    const int e = encode_bf16_map(&maps[i], ptrs[i], layout + kMapLayout * i, rows[i]);
    if (e != 0) return kMapError + e;
  }
  Params a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.l2 = static_cast<float*>(l2);
  a.o_sb = o_strides[0];
  a.o_ss = o_strides[1];
  a.o_sh = o_strides[2];
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.q_scale = q_scale;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (kDual) {
    e = cudaFuncSetAttribute(flash_fwd_online_dual_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemK8);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_online_dual_kernel<<<grid, kThreadsK8, kSmemK8, st>>>(maps[0], maps[1],
                                                                    maps[2], a);
  } else {
    e = cudaFuncSetAttribute(flash_fwd_online_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemK2);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_online_kernel<<<grid, kThreadsK2, kSmemK2, st>>>(maps[0], maps[1], maps[2],
                                                               a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// layout: the tensor-map layouts of q, k and v (7 values each, see
// kMapLayout); o_strides: (batch, seq, head) element strides of o. Both
// return 0, a cudaError_t after the launch, or kMapError + a CUresult. l2
// may be nullptr (no stats wanted).

// K2: one 128-key tile per step
int flash_attention_online_fwd(const void* q, const void* k, const void* v, void* o,
                               void* l2, const long long* layout,
                               const long long* o_strides, int batch, int heads, int sq,
                               int sk, float q_scale, void* stream) {
  return launch<false>(q, k, v, o, l2, layout, o_strides, batch, heads, sq, sk, q_scale,
                       stream);
}

// K8: two 128-key sub-tiles per step, one merged max / alpha update
int flash_attention_online_dual_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* l2, const long long* layout,
                                    const long long* o_strides, int batch, int heads,
                                    int sq, int sk, float q_scale, void* stream) {
  return launch<true>(q, k, v, o, l2, layout, o_strides, batch, heads, sq, sk, q_scale,
                      stream);
}

const char* flash_attention_online_error_string(int code) { return error_string(code); }

}  // extern "C"
