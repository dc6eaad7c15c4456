// K3: flash-attention backward for Hopper (sm_90a), one fused kernel.
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
// dQ, dK and dV accumulate in fp32 and are rounded to bf16 once.
//
// Launches, in this order on one stream, behind one entry point:
//   memset  the fp32 dQ accumulator to 0
//   stats   delta for every query row, and L2, into (B, H, Sq_pad) fp32
//           buffers padded to a multiple of 64 rows (pad: delta 0, L2
//           +1e30, so P = 0 there) that the main kernel copies whole
//   main    one block per (128 keys, head, batch), K and V resident in
//           shared memory, looping over every 64-row query tile
//   convert the fp32 dQ accumulator to bf16 dq, rounded once
// The main kernel: two warpgroups and no producer warp. Thread 0 issues
// the TMA loads (K and V once, then Q, dO and the tile's L2/delta one tile
// ahead into a ring of two stages, each stage released through an
// mbarrier). Eight warps leave up to 255 registers to each thread, which
// the 64 x 128 dK and dV accumulators need: with a third (producer)
// warpgroup, three warps share each SM quarter's 16K registers, the
// compiler held every thread to 168 and spilled, and setmaxnreg did not
// change that. Warpgroups 0 and 1 each own 64 of the block's keys and, per
// query tile:
//   S^T  = K Q^T        wgmma m64n64k16, A and B from shared memory
//   dP^T = V dO^T       the same
//   P^T  = exp2(c s - L2), dS^T = bf16(P^T (dP^T - delta) scale), in
//          registers, stored as bf16 to shared memory (128-byte swizzle by
//          hand), then fence.proxy.async and a 256-thread barrier
//   dV  += P^T dO       wgmma m64n128k16, A = P^T (K-major), dO MN-major
//   dK  += dS^T Q       the same with dS^T and Q
//   dQ   = dS K         wgmma m64n64k16 over the block's 128 keys, A = the
//          dS^T of both warpgroups read transposed (MN-major), B = K
//          (MN-major); each warpgroup takes 64 of the 128 columns of D
// Keeping P^T and dS^T in shared memory rather than as A fragments in
// registers leaves the registers to the 64 x 128 dK and dV accumulators.
// Each warpgroup's dQ part (64 x 64 fp32) is staged in shared memory in
// its register order and added into the accumulator with one 16 KB bulk
// reduce-add (cp.reduce.async.bulk ... add.f32); the accumulator keeps
// that order per (batch, head, query tile, half of D), which the convert
// kernel undoes. dS^T is double-buffered, so one 256-thread barrier per
// query tile orders its writes and reads. The order of the adds changes
// from run to run: dq is not bit-reproducible, only within the fp32
// rounding of its sum (then rounded once to bf16). dK and dV are stored
// from registers. need_kv = false (dK/dV not wanted: the cross-attention
// to frozen text keys) instantiates the same kernel without the dV and dK
// products.
//
// What bounds it on the H100: the five products, 10 * Sq * Sk * D flops per
// head, 4.5e13 at the 14B self-attention shape (29,640^2 x 40 heads),
// 45.5 ms at the 989 TFLOP/s bf16 peak, against ~1.5 GB of q/k/v/o/dO/
// dq/dk/dv traffic (0.5 ms at 3.35 TB/s); the dQ accumulation adds Sq*D*4
// bytes of reduce-adds per head for every block of 128 keys (140 GB there,
// resolved in L2; the buffer itself is 607 MB).
// Ragged tails: TMA fills rows past Sq or Sk with zeros; keys past Sk get
// P = 0 and are not stored; query rows past Sq read L2 = +1e30 (P = 0) and
// delta = 0 and are not converted.

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBK = 128;              // keys per block (2 x 64)
constexpr int kBQ = 64;               // query rows per tile
constexpr int kThreads = 256;         // 2 warpgroups
constexpr int kKVBytes = kBK * 256;   // K or V: [2 halves][128 rows][128 B]
constexpr int kHalfKV = kBK * 128;
constexpr int kQBytes = kBQ * 256;    // Q or dO tile: [2 halves][64 rows][128 B]
constexpr int kHalfQ = kBQ * 128;
constexpr int kDSBytes = kBK * 128;   // dS^T: [128 keys][64 queries] bf16
constexpr int kOffV = kKVBytes;
constexpr int kOffQ = 2 * kKVBytes;               // [2 stages]
constexpr int kOffG = kOffQ + 2 * kQBytes;        // [2 stages]
constexpr int kOffDS = kOffG + 2 * kQBytes;       // [2 buffers]
constexpr int kOffStats = kOffDS + 2 * kDSBytes;  // [2 stages][L2 64, delta 64]
constexpr int kOffPT = kOffStats + 2 * 2 * kBQ * 4;  // P^T: [128 keys][64 queries]
constexpr int kDQTile = kBQ * 64 * 4;              // one warpgroup's dQ part, fp32
constexpr int kOffDQ = kOffPT + kDSBytes;          // [2 warpgroups] staged dQ parts
constexpr int kOffBar = kOffDQ + 2 * kDQTile;
constexpr int kSmemBytes = kOffBar + 64 + 1024;  // + alignment slack
constexpr int kStageTx = 2 * kQBytes + 2 * kBQ * 4;

constexpr float kPadL2 = 1e30f;       // L2 of a row past Sq: P = 0

struct Params {
  const float* l2p;     // (B, H, sq_pad)
  const float* deltap;  // (B, H, sq_pad)
  float* dq_acc;        // (B, H, sq_pad / 64, 2, 4096) fp32, zeroed: see below
  __nv_bfloat16 *dk, *dv;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int heads, sq, sk, sq_pad;
  float c_scale;        // scale * log2(e)
  float scale;
};

template <bool kKV>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap gmap, const Params a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_kv = base + kOffBar;
  const uint32_t bar_full = bar_kv + 8;    // [2]
  const uint32_t bar_empty = bar_kv + 24;  // [2]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (a.sq + kBQ - 1) / kBQ;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 issues every TMA load: K and V once, then each query tile's
  // Q, dO, L2 and delta, one tile ahead, into the stage that the tile two
  // back has released
  const long long stat = ((long long)b * a.heads + h) * a.sq_pad;
  auto load_tile = [&](int u) {
    const int su = u & 1;
    const uint32_t full = bar_full + 8 * su;
    mbar_expect_tx(full, kStageTx);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(base + kOffQ + su * kQBytes + hf * kHalfQ, &qmap, hf * 64, h, u * kBQ, b,
                  full);
      tma_load_4d(base + kOffG + su * kQBytes + hf * kHalfQ, &gmap, hf * 64, h, u * kBQ, b,
                  full);
    }
    const uint32_t st = base + kOffStats + su * 2 * kBQ * 4;
    bulk_load(st, a.l2p + stat + u * kBQ, kBQ * 4, full);
    bulk_load(st + kBQ * 4, a.deltap + stat + u * kBQ, kBQ * 4, full);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * kKVBytes);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(base + hf * kHalfKV, &kmap, hf * 64, h, k0, b, bar_kv);
      tma_load_4d(base + kOffV + hf * kHalfKV, &vmap, hf * 64, h, k0, b, bar_kv);
    }
    for (int u = 0; u < 2 && u < ntiles; ++u) load_tile(u);
  }
  {
    const int wg = tid >> 7;  // keys k0 + 64 wg ..
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int wt = tid & 127;
    const int krow = wg * 64 + warp * 16 + g;  // this thread's keys: krow, krow + 8
    const bool key_ok[2] = {k0 + krow < a.sk, k0 + krow + 8 < a.sk};

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t & 1;
      if (tid == 0 && t >= 1 && t + 1 < ntiles) {
        mbar_wait(bar_empty + 8 * ((t + 1) & 1), (((t + 1) >> 1) - 1) & 1);
        load_tile(t + 1);
      }
      // Shared addresses are rebuilt per tile from opaque bases: hoisted out
      // of the loop, the wgmma descriptors and the per-thread store
      // addresses would hold registers that the accumulators need.
      const uint32_t sb = opaque(base);
      const uint32_t tq = sb + kOffQ + s * kQBytes;
      const uint32_t tg = sb + kOffG + s * kQBytes;
      const uint32_t stats = sb + kOffStats + s * 2 * kBQ * 4 + opaque(tig * 8);
      const uint32_t rowp = opaque(krow * 128 + tig * 4);  // + ((chunk ^ g) << 4)
      const int gx = opaque(g);
      mbar_wait(bar_full + 8 * s, (t >> 1) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t aoff = (kk >> 2) * kHalfKV + wg * 64 * 128 + (kk & 3) * 32;
        const uint32_t boff = (kk >> 2) * kHalfQ + (kk & 3) * 32;
        wgmma_m64n64_ss<0, 0>(st, wgmma_desc(sb + aoff, 16, 1024),
                              wgmma_desc(tq + boff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t aoff = (kk >> 2) * kHalfKV + wg * 64 * 128 + (kk & 3) * 32;
        const uint32_t boff = (kk >> 2) * kHalfQ + (kk & 3) * 32;
        wgmma_m64n64_ss<0, 0>(dpt, wgmma_desc(sb + kOffV + aoff, 16, 1024),
                              wgmma_desc(tg + boff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T (0 past Sk; past Sq L2 = +1e30 gives 0) and dS^T, rounded to
      // bf16 into shared memory (128-byte swizzle: rows krow and krow + 8
      // share the chunk order of g), where the dV, dK and dQ products read
      // them: no A fragments held in registers
      const uint32_t dsb = sb + kOffDS + s * kDSBytes;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t col = stats + (nt * 8 + (e & 1)) * 4;
          p[e] = key_ok[e >> 1]
              ? fast_exp2(__fmul_rn(st[4 * nt + e], a.c_scale) - ld_shared_f32(col))
              : 0.f;
          ds[e] = p[e] * (dpt[4 * nt + e] - ld_shared_f32(col + kBQ * 4)) * a.scale;
        }
        const uint32_t at = rowp + ((nt ^ gx) << 4);
        if (kKV) {
          st_shared(sb + kOffPT + at, pack_bf16(p[0], p[1]));
          st_shared(sb + kOffPT + at + 8 * 128, pack_bf16(p[2], p[3]));
        }
        st_shared(dsb + at, pack_bf16(ds[0], ds[1]));
        st_shared(dsb + at + 8 * 128, pack_bf16(ds[2], ds[3]));
      }
      fence_proxy_async();
      named_barrier(1, 256);

      // dV += P^T dO and dK += dS^T Q (4 steps of 16 queries; A K-major
      // from this warpgroup's 64 rows, B MN-major); dQ = dS K for this
      // warpgroup's 64 columns of D (8 steps of 16 keys; A = dS^T read
      // transposed, B = K, both MN-major)
      float dq[32];
      if (kKV) {
        reg_fence(dv);
        reg_fence(dk);
      }
      wgmma_fence();
      if (kKV) {
        const uint32_t rows = wg * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128_ss<0, 1>(dv, wgmma_desc(sb + kOffPT + rows + kk * 32, 16, 1024),
                                 wgmma_desc(tg + kk * 2048, kHalfQ, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128_ss<0, 1>(dk, wgmma_desc(dsb + rows + kk * 32, 16, 1024),
                                 wgmma_desc(tq + kk * 2048, kHalfQ, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n64_ss<1, 1>(dq, wgmma_desc(dsb + kk * 2048, kDSBytes, 1024),
                              wgmma_desc(sb + wg * kHalfKV + kk * 2048, kHalfKV, 1024),
                              kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      if (kKV) {
        reg_fence(dv);
        reg_fence(dk);
      }
      mbar_arrive(bar_empty + 8 * s);

      // This warpgroup's dQ part (64 rows x 64 columns) goes out as one
      // bulk fp32 reduce-add of 16 KB, staged in the accumulator's own
      // register order (element i of lane l of warp w at (w * 32 + i) * 32
      // + l: conflict-free stores), which is the layout of dq_acc too. The
      // previous tile's copy must have left the staging buffer first.
      const uint32_t dqs = sb + kOffDQ + wg * kDQTile;
      if (wt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_barrier(2 + wg, 128);
      const uint32_t mine = dqs + opaque((warp * 1024 + lane) * 4);
#pragma unroll
      for (int i = 0; i < 32; ++i) st_shared(mine + i * 128, dq[i]);
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (wt == 0) {
        const float* out = a.dq_acc + ((((long long)b * a.heads + h) * (a.sq_pad / kBQ) + t) *
                                       2 + wg) * (kDQTile / 4);
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
            "cp.async.bulk.commit_group;\n" ::"l"(out),
            "r"(dqs), "n"(kDQTile)
            : "memory");
      }
    }
    if (wt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

    if (kKV) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = k0 + krow + hh * 8;
        if (key >= a.sk) continue;
        __nv_bfloat16* ok = a.dk + b * a.dk_sb + h * a.dk_sh + (long long)key * a.dk_ss;
        __nv_bfloat16* ov = a.dv + b * a.dv_sb + h * a.dv_sh + (long long)key * a.dv_ss;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          *reinterpret_cast<uint32_t*>(ok + nt * 8 + tig * 2) =
              pack_bf16(dk[4 * nt + 2 * hh], dk[4 * nt + 2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(ov + nt * 8 + tig * 2) =
              pack_bf16(dv[4 * nt + 2 * hh], dv[4 * nt + 2 * hh + 1]);
        }
      }
    }
  }
}

// delta = sum_d dO * O (16 threads per row, 8 rows per block) and the
// padded copies of delta and L2 that the main kernel loads by the tile
__global__ void __launch_bounds__(128)
fa_bwd_stats_kernel(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ l2, float* __restrict__ l2p,
                    float* __restrict__ deltap, long long o_sb, long long o_ss,
                    long long o_sh, long long g_sb, long long g_ss, long long g_sh,
                    int heads, int sq, int sq_pad) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 4);
  const int c = threadIdx.x & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float acc = 0.f;
  if (row < sq) {
    const uint4 graw = *reinterpret_cast<const uint4*>(
        g + b * g_sb + h * g_sh + (long long)row * g_ss + c * 8);
    const uint4 oraw = *reinterpret_cast<const uint4*>(
        o + b * o_sb + h * o_sh + (long long)row * o_ss + c * 8);
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
  if (c == 0 && row < sq_pad) {
    const long long bh = (long long)b * heads + h;
    deltap[bh * sq_pad + row] = acc;
    l2p[bh * sq_pad + row] = row < sq ? l2[bh * sq + row] : kPadL2;
  }
}

// dq = bf16(dq_acc), 8 values (one row, 8 columns) per thread. dq_acc
// holds, per (batch, head, 64-row query tile, 64-column half of D), the
// main kernel's dQ accumulator in register order: row 16 w + g + 8 (e / 2)
// and column 8 n + 2 c + e % 2 of the half sit at (w * 32 + 4 n + e) * 32 +
// 4 g + c (warp w, n-tile n, element e, lane 4 g + c).
__global__ void __launch_bounds__(256)
fa_bwd_convert_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                      long long sb, long long ss, long long sh, int heads, int sq,
                      int sq_pad, long long chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int c8 = static_cast<int>(i & 15);  // columns 8 c8 .. 8 c8 + 7
  const long long r = i >> 4;               // (b, s, h) row of dq
  const int h = static_cast<int>(r % heads);
  const int s = static_cast<int>((r / heads) % sq);
  const long long b = r / ((long long)heads * sq);
  const int half = c8 >> 3, n = c8 & 7;
  const int rr = s & (kBQ - 1), w = rr >> 4, g = rr & 7, hi = (rr >> 3) & 1;
  const float* tile = acc + (((b * heads + h) * (sq_pad / kBQ) + s / kBQ) * 2 + half) *
                                (kDQTile / 4);
  uint32_t out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* p = tile + (w * 32 + 4 * n + 2 * hi) * 32 + 4 * g + c;
    out[c] = pack_bf16(p[0], p[32]);
  }
  *reinterpret_cast<uint4*>(dq + b * sb + (long long)s * ss + h * sh + c8 * 8) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

template <bool kKV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* l2, void* l2p, void* deltap, void* dq_acc,
           void* dq, void* dk, void* dv, const long long* layout,
           const long long* strides, int batch, int heads, int sq, int sk,
           float scale, float c_scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, g};
  const int rows[4] = {kBQ, kBK, kBK, kBQ};
  for (int i = 0; i < 4; ++i) {
    const int e = encode_bf16_map(&maps[i], ptrs[i], layout + kMapLayout * i, rows[i]);
    if (e != 0) return kMapError + e;
  }
  const int sq_pad = (sq + kBQ - 1) / kBQ * kBQ;
  const size_t acc_bytes = (size_t)batch * sq_pad * heads * 128 * sizeof(float);
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, acc_bytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  // strides: (batch, seq, head) element strides of o, dO, dq, dk, dv
  const long long* so = strides;
  const long long* sg = strides + 3;
  const long long* sdq = strides + 6;
  fa_bwd_stats_kernel<<<dim3(sq_pad / 8, heads, batch), 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(l2), static_cast<float*>(l2p),
      static_cast<float*>(deltap), so[0], so[1], so[2], sg[0], sg[1], sg[2], heads, sq,
      sq_pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  Params a;
  a.l2p = static_cast<const float*>(l2p);
  a.deltap = static_cast<const float*>(deltap);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dk_sb = kKV ? strides[9] : 0;
  a.dk_ss = kKV ? strides[10] : 0;
  a.dk_sh = kKV ? strides[11] : 0;
  a.dv_sb = kKV ? strides[12] : 0;
  a.dv_ss = kKV ? strides[13] : 0;
  a.dv_sh = kKV ? strides[14] : 0;
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.sq_pad = sq_pad;
  a.c_scale = c_scale;
  a.scale = scale;
  e = cudaFuncSetAttribute(fa_bwd_kernel<kKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_kernel<kKV><<<dim3((sk + kBK - 1) / kBK, heads, batch), kThreads, kSmemBytes,
                       stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long chunks = (long long)batch * sq * heads * 16;
  fa_bwd_convert_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), sdq[0], sdq[1],
      sdq[2], heads, sq, sq_pad, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// layout: the tensor-map layouts of q, k, v and dO (7 values each, see
// kMapLayout); strides: (batch, seq, head) element strides of o, dO, dq,
// dk, dv (the last two unread without dK/dV). l2p and deltap are (B, H,
// Sq rounded up to 64) fp32 scratch, dq_acc a (B, H, that, 128) fp32 scratch.
// Returns 0, a cudaError_t, or kMapError + a CUresult.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* g, const void* l2, void* l2p, void* deltap,
                        void* dq_acc, void* dq, void* dk, void* dv,
                        const long long* layout, const long long* strides, int batch,
                        int heads, int sq, int sk, float scale, float c_scale,
                        void* stream) {
  return launch<true>(q, k, v, o, g, l2, l2p, deltap, dq_acc, dq, dk, dv, layout,
                      strides, batch, heads, sq, sk, scale, c_scale, stream);
}

// the same without dK and dV: three products instead of five
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* g, const void* l2, void* l2p, void* deltap,
                           void* dq_acc, void* dq, const long long* layout,
                           const long long* strides, int batch, int heads, int sq,
                           int sk, float scale, float c_scale, void* stream) {
  return launch<false>(q, k, v, o, g, l2, l2p, deltap, dq_acc, dq, nullptr, nullptr,
                       layout, strides, batch, heads, sq, sk, scale, c_scale, stream);
}

const char* flash_attention_bwd_error_string(int code) { return error_string(code); }

}  // extern "C"
