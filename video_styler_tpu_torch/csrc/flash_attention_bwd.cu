// K3: flash-attention backward for Hopper (sm_90a), two kernels.
//
// Replaces the Pallas kernels `_fa_bwd_kernel_dkv` and `_fa_bwd_kernel_dq`
// (video_styler_tpu/ops/flash_attention.py:582 and :624, reached through
// `_fa_bwd_pallas` :664, the backward of `_flash_4d`'s custom_vjp).
// Non-causal attention on the (B, S, H, D=128) layout, read through strides.
//
// What it computes, from the forward's saved base-2 logsumexp L2 (B, H, Sq)
// (the Pallas kernels' rounding points):
//   delta_i = sum_d dO_id O_id                            (fp32)
//   s2_ij   = (q_i . k_j) * c,  c = scale * log2(e)       (fp32, unscaled q)
//   P_ij    = exp2(s2_ij - L2_i)                          (0 past Sq or Sk)
//   dV_j    = sum_i bf16(P_ij) dO_i
//   dS_ij   = bf16(P_ij * (dO_i . v_j - delta_i) * scale)
//   dK_j    = sum_i dS_ij q_i ;  dQ_i = sum_j dS_ij k_j
// dQ, dK and dV accumulate in fp32 registers and are rounded once at the end.
//
// Kernels, launched in this order on one stream:
//   dq   one block per (64-row query tile, head, batch) loops over 64-key
//        tiles: S, dP, dS, dQ += dS K. It also computes delta for its rows
//        (from dO and O read once) and writes it to a (B, H, Sq) scratch.
//   dkv  one block per (64-key tile, head, batch) loops over 64-row query
//        tiles: S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T,
//        dK += dS^T Q. It reads L2 and delta per query tile.
// Ragged tails: rows past Sq and keys past Sk are zero-filled on load;
// past Sq, L2 reads as +1e30 (P = 0) and delta as 0, as the Pallas code pads
// them; keys past Sk get P = 0 in dq and are never stored in dkv.
//
// What bounds it on the H100: the products. dkv does 4 of them and dq 3
// (S is recomputed in both): 14 * Sq * Sk * D flops per head, 6.3e13 at the
// 14B self-attention shape (29,640^2 x 40 heads), 63.7 ms at the 989
// TFLOP/s bf16 peak, against ~1.5 GB of q/k/v/o/dO/dq/dk/dv traffic
// (0.5 ms at 3.35 TB/s). A fused one-kernel backward (dQ by atomics) would
// do 10 * Sq * Sk * D; this first version keeps two kernels and no atomics.
//
// Design, the simple first version: 4 warps per block, each warp owns 16
// rows of the block's resident tile (queries in dq, keys in dkv) and all 64
// columns of the streamed tile; the streamed tiles are double-buffered in
// shared memory with cp.async. Every product is mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); A fragments of the resident tile are re-read from
// shared memory per k-step (registers hold the fp32 accumulators: 128 a
// thread in dkv), P and dS are re-packed from accumulators into A fragments
// in registers. Tiles are XOR-swizzled for conflict-free ldmatrix.

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64 * kChunks;  // uint4 slots of one 64-row tile
// dq: q, dO + 2x(k, v); dkv: k, v + 2x(q, dO) + 2x(L2, delta) rows
constexpr int kSmemDq = 6 * kTile * 16;
constexpr int kSmemDkv = 6 * kTile * 16 + 4 * kBQ * 4;
static_assert(kBQ == kBK && kBQ == kWarps * 16, "one 16-row slab per warp");
static_assert(kThreads == 2 * kBQ, "dkv: one L2 or delta value per thread");

constexpr float kPadL2 = 1e30f;      // L2 of a row past Sq: P = 0

// tensors of the stride table, each (batch, seq, head) strides in elements
enum { Q = 0, K, V, O, G, DQ, DK, DV, kTensors };

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *g;
  const float* l2;  // (B, H, Sq)
  float* delta;     // (B, H, Sq): written by dq, read by dkv
  __nv_bfloat16 *dq, *dk, *dv;
  long long st[kTensors][3];
  int heads, sq, sk;
  float c_scale;    // scale * log2(e)
  float scale;
};

__device__ __forceinline__ long long row_base(const Args& a, int t, int b,
                                              int h) {
  return b * a.st[t][0] + h * a.st[t][2];
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss,
                                           const float (&acc)[16][4], int row0,
                                           int limit, int g, int tig) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + hh * 8;
    if (row >= limit) continue;
    __nv_bfloat16* out = base + (long long)row * ss;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16(acc[dt][hh * 2], acc[dt][hh * 2 + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* s_q = smem;
  uint4* s_g = s_q + kTile;
  uint4* s_k = s_g + kTile;      // two buffers
  uint4* s_v = s_k + 2 * kTile;  // two buffers
  __shared__ float s_delta[kBQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = a.q + row_base(a, Q, b, h);
  const __nv_bfloat16* kb = a.k + row_base(a, K, b, h);
  const __nv_bfloat16* vb = a.v + row_base(a, V, b, h);
  const __nv_bfloat16* ob = a.o + row_base(a, O, b, h);
  const __nv_bfloat16* gb = a.g + row_base(a, G, b, h);
  const long long stat = ((long long)b * a.heads + h) * a.sq;
  const int ntiles = (a.sk + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int buf) {
    load_tile_async<kBK, kThreads>(s_k + buf * kTile, kb, a.st[K][1],
                                   tile * kBK, a.sk, tid);
    load_tile_async<kBK, kThreads>(s_v + buf * kTile, vb, a.st[V][1],
                                   tile * kBK, a.sk, tid);
    cp_async_commit();
  };

  load_tile_async<kBQ, kThreads>(s_q, qb, a.st[Q][1], q0, a.sq, tid);
  load_tile_async<kBQ, kThreads>(s_g, gb, a.st[G][1], q0, a.sq, tid);
  cp_async_commit();
  load_kv(0, 0);

  // delta for the tile's rows while the copies fly: 16 threads per row,
  // one 16-byte chunk of dO and of O each, reduced with shuffles
  {
    const int c = tid & 15;
#pragma unroll
    for (int r = tid >> 4; r < kBQ; r += kThreads / 16) {
      const int row = q0 + r;
      float acc = 0.f;
      if (row < a.sq) {
        const uint4 graw = *reinterpret_cast<const uint4*>(
            gb + (long long)row * a.st[G][1] + c * 8);
        const uint4 oraw = *reinterpret_cast<const uint4*>(
            ob + (long long)row * a.st[O][1] + c * 8);
        const __nv_bfloat162* ge = reinterpret_cast<const __nv_bfloat162*>(&graw);
        const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&oraw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 gf = __bfloat1622float2(ge[j]);
          const float2 of = __bfloat1622float2(oe[j]);
          acc += gf.x * of.x + gf.y * of.y;
        }
      }
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (c == 0) {
        s_delta[r] = acc;
        if (row < a.sq) a.delta[stat + row] = acc;
      }
    }
  }
  __syncthreads();

  float l2r[2], dlr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + hh * 8;
    l2r[hh] = q0 + r < a.sq ? a.l2[stat + q0 + r] : kPadL2;
    dlr[hh] = s_delta[r];
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* tk = s_k + buf * kTile;
    const uint4* tv = s_v + buf * kTile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, a_frag_addr(s_q, warp * 16, kk, lane));
      ldsm_x4(ga, a_frag_addr(s_g, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_frag_addr(tk, np * 16, kk, lane));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        ldsm_x4(vf, b_frag_addr(tv, np * 16, kk, lane));
        mma_bf16(dp[2 * np], ga, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], ga, vf[2], vf[3]);
      }
    }

    // dS = bf16(P (dP - delta) scale), P = exp2(c s - L2), 0 past Sk
    const int kbase = t * kBK;
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = kbase + nt * 8 + tig * 2;
      const bool ok0 = key < a.sk;
      const bool ok1 = key + 1 < a.sk;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (e & 1) ? ok1 : ok0;
        p[e] = ok ? fast_exp2(__fmul_rn(s[nt][e], a.c_scale) - l2r[e >> 1]) : 0.f;
        p[e] = p[e] * (dp[nt][e] - dlr[e >> 1]) * a.scale;
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dpair = 0; dpair < 8; ++dpair) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, bt_frag_addr(tk, j * 16, dpair, lane));
        mma_bf16(acc[2 * dpair], dsf[j], kf[0], kf[1]);
        mma_bf16(acc[2 * dpair + 1], dsf[j], kf[2], kf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  store_rows(a.dq + row_base(a, DQ, b, h), a.st[DQ][1], acc,
             q0 + warp * 16, a.sq, g, tig);
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* s_k = smem;
  uint4* s_v = s_k + kTile;
  uint4* s_q = s_v + kTile;      // two buffers
  uint4* s_g = s_q + 2 * kTile;  // two buffers
  float* s_l2 = reinterpret_cast<float*>(s_g + 2 * kTile);  // [2][kBQ]
  float* s_dl = s_l2 + 2 * kBQ;                             // [2][kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = a.q + row_base(a, Q, b, h);
  const __nv_bfloat16* kb = a.k + row_base(a, K, b, h);
  const __nv_bfloat16* vb = a.v + row_base(a, V, b, h);
  const __nv_bfloat16* gb = a.g + row_base(a, G, b, h);
  const long long stat = ((long long)b * a.heads + h) * a.sq;
  const int ntiles = (a.sq + kBQ - 1) / kBQ;

  // q/dO tiles by cp.async; L2 (threads 0..63) and delta (64..127) by plain
  // loads, visible after the barrier that precedes their use
  auto load_q = [&](int tile, int buf) {
    const int r0 = tile * kBQ;
    load_tile_async<kBQ, kThreads>(s_q + buf * kTile, qb, a.st[Q][1], r0,
                                   a.sq, tid);
    load_tile_async<kBQ, kThreads>(s_g + buf * kTile, gb, a.st[G][1], r0,
                                   a.sq, tid);
    cp_async_commit();
    const int r = tid & (kBQ - 1);
    const int row = r0 + r;
    if (tid < kBQ) {
      s_l2[buf * kBQ + r] = row < a.sq ? a.l2[stat + row] : kPadL2;
    } else {
      s_dl[buf * kBQ + r] = row < a.sq ? a.delta[stat + row] : 0.f;
    }
  };

  load_tile_async<kBK, kThreads>(s_k, kb, a.st[K][1], k0, a.sk, tid);
  load_tile_async<kBK, kThreads>(s_v, vb, a.st[V][1], k0, a.sk, tid);
  cp_async_commit();
  load_q(0, 0);

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_q(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* tq = s_q + buf * kTile;
    const uint4* tg = s_g + buf * kTile;
    const float* l2t = s_l2 + buf * kBQ;
    const float* dlt = s_dl + buf * kBQ;

    // S^T = K Q^T: 16 keys x 64 queries per warp
    float st[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, a_frag_addr(s_k, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t qf[4];
        ldsm_x4(qf, b_frag_addr(tq, np * 16, kk, lane));
        mma_bf16(st[2 * np], ka, qf[0], qf[1]);
        mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
      }
    }

    // P^T = exp2(c s - L2[query]); queries past Sq have L2 = +1e30 -> 0
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = fast_exp2(__fmul_rn(st[nt][e], a.c_scale) - l2t[col + (e & 1)]);
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(st[nt][0], st[nt][1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(st[nt][2], st[nt][3]);
    }

    // dV += P^T dO
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dpair = 0; dpair < 8; ++dpair) {
        uint32_t gf[4];
        ldsm_x4_trans(gf, bt_frag_addr(tg, j * 16, dpair, lane));
        mma_bf16(dv[2 * dpair], pf[j], gf[0], gf[1]);
        mma_bf16(dv[2 * dpair + 1], pf[j], gf[2], gf[3]);
      }
    }

    // dP^T = V dO^T
    float dpt[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t va[4];
      ldsm_x4(va, a_frag_addr(s_v, warp * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t gf[4];
        ldsm_x4(gf, b_frag_addr(tg, np * 16, kk, lane));
        mma_bf16(dpt[2 * np], va, gf[0], gf[1]);
        mma_bf16(dpt[2 * np + 1], va, gf[2], gf[3]);
      }
    }

    // dS^T = bf16(P^T (dP^T - delta[query]) scale), into A fragments
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + tig * 2;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[e] = st[nt][e] * (dpt[nt][e] - dlt[col + (e & 1)]) * a.scale;
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dK += dS^T Q
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dpair = 0; dpair < 8; ++dpair) {
        uint32_t qf[4];
        ldsm_x4_trans(qf, bt_frag_addr(tq, j * 16, dpair, lane));
        mma_bf16(dk[2 * dpair], pf[j], qf[0], qf[1]);
        mma_bf16(dk[2 * dpair + 1], pf[j], qf[2], qf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  store_rows(a.dk + row_base(a, DK, b, h), a.st[DK][1], dk, k0 + warp * 16,
             a.sk, g, tig);
  store_rows(a.dv + row_base(a, DV, b, h), a.st[DV][1], dv, k0 + warp * 16,
             a.sk, g, tig);
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* g, const void* l2, void* delta, void* dq, void* dk,
               void* dv, const long long* strides, int heads, int sq, int sk,
               float scale, float c_scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.l2 = static_cast<const float*>(l2);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  for (int t = 0; t < kTensors; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.c_scale = c_scale;
  return a;
}

}  // namespace

extern "C" {

// strides: 8 x (batch, seq, head) element strides of q, k, v, o, dO, dq,
// dk, dv (host memory); c_scale = scale * log2(e). Each entry returns
// cudaGetLastError() after its launch (0 on success). dq must run before
// dkv: it writes delta.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* g, const void* l2,
                           void* delta, void* dq, const long long* strides,
                           int batch, int heads, int sq, int sk, float scale,
                           float c_scale, void* stream) {
  const Args a = make_args(q, k, v, o, g, l2, delta, dq, nullptr, nullptr,
                           strides, heads, sq, sk, scale, c_scale);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  fa_bwd_dq_kernel<<<grid, kThreads, kSmemDq,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* g, const void* l2, const void* delta,
                            void* dk, void* dv, const long long* strides,
                            int batch, int heads, int sq, int sk, float scale,
                            float c_scale, void* stream) {
  const Args a = make_args(q, k, v, nullptr, g, l2, const_cast<void*>(delta),
                           nullptr, dk, dv, strides, heads, sq, sk, scale,
                           c_scale);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sk + kBK - 1) / kBK, heads, batch);
  fa_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
