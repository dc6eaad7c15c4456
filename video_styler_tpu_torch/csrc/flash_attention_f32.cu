// K1f, K3f and K3q-f: the capped-softmax flash-attention forward and its
// backward on float32 operands, for Hopper (sm_90a).
//
// Replace the Pallas kernels `_flash_kernel_4d_capped`
// (video_styler_tpu/ops/flash_attention.py:213, via `_flash_fwd_4d` :352)
// and `_fa_bwd_kernel_dkv` (:582) / `_fa_bwd_kernel_dq` (:624), via
// `_fa_bwd_pallas` (:664), where those run on float32 inputs: the Ditto LoRA
// recipe casts its activations to fp32 (examples/train.py:281-282), and the
// Pallas kernels then round nowhere but in their fp32 sums (P is cast to
// v.dtype, a no-op; the output is fp32).
//
// What they compute (the rounding points of `flash_attention_plain` and
// `flash_attention_bwd_plain` on fp32 tensors):
//   forward:  q' = q * (scale log2 e);  m2 = min(||q'|| * kmax * 1.0001, 96);
//             p_j = exp2(q'.k_j - m2), 0 for keys past Sk;
//             o = (sum_j p_j v_j) / max(sum_j p_j, 1e-37);
//             L2 = m2 + log2(max(sum_j p_j, 1e-37))  (when asked for)
//   backward: delta = sum_d dO o;  p = exp2((q.k) c - L2), c = scale log2 e;
//             dV = P^T dO;  dS = p (dO.v - delta) scale;  dK = dS^T q;  dQ = dS k.
//
// Products: three TF32 passes on mma.sync.m16n8k8. Each fp32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi); an 8-deep step sums lo*hi +
// hi*lo + hi*hi in a fresh fp32 fragment (the dropped lo*lo is ~2^-22 of
// it), which is added to the running sum in registers. One TF32 pass keeps
// about three decimal digits and would not compute the fp32 function; three
// keep about fp32's, at a third of the TF32 rate: 165 TFLOP/s of the
// H100's 495.
//
// Sums over the sequence (K1f's O and row sum l, dQ, dK, dV: thousands of
// 8-deep steps at 29,640 tokens) are compensated (Kahan): each keeps the
// rounding error of its running total in a second register and feeds it
// back, so that the total keeps fp32's precision however many steps it
// takes. A plain fp32 running sum loses about a bit for every fourfold
// growth in its number of steps: at 29,640 keys it put the kernels beyond
// 2^-17 of the plain version, whose GEMMs sum in shorter chains.
//
// What bounds them on the H100: operations. At the 14B self-attention shape
// (29,640 tokens, 40 heads of 128) the forward is 4 S Sk D = 1.8e13 flop
// (109 ms at 165 TFLOP/s) against 2.4 GB of fp32 q, k, v, o (0.7 ms at 3.35
// TB/s); the backward 10 S Sk D (273 ms).
//
// Design (right and simple first: no TMA, no wgmma, no warp
// specialisation):
//  - Tiles live in shared memory as rows of 128 floats padded to 132, so
//    that every fragment load below hits 32 distinct banks. cp.async copies
//    16 bytes a thread, zero-filled past the ragged edge, and double-buffers
//    the streamed tiles.
//  - A product's C fragment is the next product's A fragment without a
//    shuffle: A's columns (t, t + 4) of an 8-wide step are taken as keys
//    (2t, 2t + 1), and the B fragment's rows are loaded in that order.
//  - K1f: a block of 8 warps per (128 query rows, head, batch), each warp
//    16 rows; q' in shared memory (scaled once, with its row norms for m2),
//    64-key K and V tiles double-buffered: 202,752 bytes. The capped
//    softmax needs no running max, as in K1.
//  - K3f follows the Pallas structure: delta by a warp-per-row pass; dV,
//    then dK, by a block per 128 keys looping over 32-row tiles of q and dO
//    (two launches: see fa_bwd_dkv_f32_kernel); dQ by a block per 128 query
//    rows looping over 32-key tiles of k and v. Every output element is
//    summed by one thread in a fixed order: no atomics, and a run repeats
//    bit for bit. K3q-f: delta and the dQ kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                  // head dim
constexpr int kLd = kD + 4;              // padded shared-memory row, floats
constexpr int kRowBytes = kLd * 4;       // 528, a multiple of 16
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // rows a block owns: 16 a warp
constexpr int kFwdKeys = 64;             // keys a step of K1f
constexpr int kBwdStep = 32;             // query rows (dK/dV) or keys (dQ) a step of K3f
constexpr int kFwdSmem = (kBlockRows + 4 * kFwdKeys) * kRowBytes;      // 202,752
constexpr int kBwdSmem = (2 * kBlockRows + 4 * kBwdStep) * kRowBytes;  // 202,752

// A (B, S, N, 128) fp32 tensor read through its element strides.
struct Tensor4 {
  const float* p;
  long long sb, ss, sh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) of head h, batch b of t into R shared rows at dst;
// rows at or past `limit` are zero-filled.
template <int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const Tensor4& t, int b, int h,
                                          int row0, int limit) {
  const float* base = t.p + b * t.sb + h * t.sh;
  for (int c = threadIdx.x; c < R * 32; c += kThreads) {
    const int r = c >> 5, chunk = c & 31;
    const bool ok = row0 + r < limit;
    const float* src = ok ? base + (row0 + r) * t.ss + chunk * 4 : t.p;
    cp_async16(dst + r * kRowBytes + chunk * 16, src, ok);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: the three TF32 passes (small terms first) summed apart from c,
// then added to it with one IEEE add. The tensor core truncates its fp32
// accumulator, so chaining thousands of steps through it biases a long sum;
// here each 8-deep step rounds once, to nearest.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], d[i]);
}

// Compensated c += d: e holds minus what the rounding of c has dropped so
// far (the total is c - e).
__device__ __forceinline__ void kahan_add(float& c, float& e, float d) {
  const float y = __fsub_rn(d, e);
  const float s = __fadd_rn(c, y);
  e = __fsub_rn(__fsub_rn(s, c), y);
  c = s;
}

// c += a b as mma3 does, compensated in e: for sums along the sequence.
__device__ __forceinline__ void mma3k(float c[4], float e[4], const uint32_t ah[4],
                                      const uint32_t al[4], const uint32_t bh[2],
                                      const uint32_t bl[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) kahan_add(c[i], e[i], d[i]);
}

// A warp's compensated 16 x 128 fragment folded into its total.
__device__ __forceinline__ void fold(float c[16][4], const float e[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[n][j] = __fsub_rn(c[n][j], e[n][j]);
}

// Fragment loads (g = lane / 4, t = lane % 4), each value split hi/lo.
// A: rows r0 + g, r0 + g + 8 and columns k0 + t, k0 + t + 4 of a shared tile.
__device__ __forceinline__ void load_a(const float* s, int r0, int k0, int g, int t,
                                       uint32_t hi[4], uint32_t lo[4]) {
  const float* p = s + (r0 + g) * kLd + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * kLd], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * kLd + 4], hi[3], lo[3]);
}

// B = X^T for a shared tile X [n][k]: b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4].
__device__ __forceinline__ void load_bt(const float* s, int n0, int k0, int g, int t,
                                        uint32_t hi[2], uint32_t lo[2]) {
  const float* p = s + (n0 + g) * kLd + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B = X for a shared tile X [k][n], rows in the paired order:
// b0 = X[k0 + 2t][n0 + g], b1 = X[k0 + 2t + 1][n0 + g].
__device__ __forceinline__ void load_b_paired(const float* s, int k0, int n0, int g, int t,
                                              uint32_t hi[2], uint32_t lo[2]) {
  const float* p = s + (k0 + 2 * t) * kLd + n0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[kLd], hi[1], lo[1]);
}

// The A fragment of a C fragment (columns 2t, 2t + 1 taken as t, t + 4).
__device__ __forceinline__ void c_to_a(const float c[4], uint32_t hi[4], uint32_t lo[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

struct FwdParams {
  Tensor4 q, k, v;
  const float* kmax;  // (B, H) max over keys of ||k_j||
  float* o;
  long long o_sb, o_ss, o_sh;
  float* l2;          // (B, H, Sq) base-2 logsumexp, or nullptr (not wanted)
  int heads, sq, sk;
  float q_scale;
};

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(const FwdParams a) {
  extern __shared__ __align__(16) float smem[];
  float* const s_q = smem;                           // [128][kLd]
  float* const s_k = s_q + kBlockRows * kLd;         // [2][64][kLd]
  float* const s_v = s_k + 2 * kFwdKeys * kLd;       // [2][64][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int tiles = (a.sk + kFwdKeys - 1) / kFwdKeys;

  load_tile<kBlockRows>(smem_u32(s_q), a.q, b, h, q0, a.sq);
  cp_commit();
  load_tile<kFwdKeys>(smem_u32(s_k), a.k, b, h, 0, a.sk);
  load_tile<kFwdKeys>(smem_u32(s_v), a.v, b, h, 0, a.sk);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // q' = q * q_scale in place, each warp on its own 16 rows, and the
  // per-row bound m2 (rows g and g + 8 of the warp kept by this thread)
  const float kcap = a.kmax[b * a.heads + h] * 1.0001f;
  float m2_lo = 0.f, m2_hi = 0.f;
  for (int i = 0; i < 16; ++i) {
    float* row = s_q + (warp * 16 + i) * kLd;
    float ss = 0.f;
#pragma unroll
    for (int j = lane; j < kD; j += 32) {
      const float x = __fmul_rn(row[j], a.q_scale);
      row[j] = x;
      ss += x * x;
    }
    const float m2 = fminf(__fmul_rn(sqrtf(warp_sum(ss)), kcap), 96.f);
    if (i == g) m2_lo = m2;
    if (i == g + 8) m2_hi = m2;
  }
  __syncwarp();

  float acc[16][4], acc_e[16][4];  // O's sum and its compensation
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = acc_e[n][j] = 0.f;
  float l_lo = 0.f, l_hi = 0.f, l_lo_e = 0.f, l_hi_e = 0.f;
  const float* const qw = s_q + warp * 16 * kLd;

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < tiles) {
      const int nx = st ^ 1;
      load_tile<kFwdKeys>(smem_u32(s_k + nx * kFwdKeys * kLd), a.k, b, h,
                          (tile + 1) * kFwdKeys, a.sk);
      load_tile<kFwdKeys>(smem_u32(s_v + nx * kFwdKeys * kLd), a.v, b, h,
                          (tile + 1) * kFwdKeys, a.sk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* const ks = s_k + st * kFwdKeys * kLd;
    const float* const vs = s_v + st * kFwdKeys * kLd;

    // S = q' K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kD / 8; ++kk) {
      uint32_t ah[4], al[4];
      load_a(qw, 0, kk * 8, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh[2], bl[2];
        load_bt(ks, n * 8, kk * 8, g, t, bh, bl);
        mma3(s[n], ah, al, bh, bl);
      }
    }
    // p = exp2(s - m2), 0 past Sk
    const int key0 = tile * kFwdKeys;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + n * 8 + 2 * t + (j & 1);
        const float p = key < a.sk ? exp2f(__fsub_rn(s[n][j], j < 2 ? m2_lo : m2_hi)) : 0.f;
        s[n][j] = p;
        if (j < 2) kahan_add(l_lo, l_lo_e, p); else kahan_add(l_hi, l_hi_e, p);
      }
    }
    // O += P V
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      uint32_t ah[4], al[4];
      c_to_a(s[kt], ah, al);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        uint32_t bh[2], bl[2];
        load_b_paired(vs, kt * 8, n * 8, g, t, bh, bl);
        mma3k(acc[n], acc_e[n], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  fold(acc, acc_e);
  l_lo = __fsub_rn(l_lo, l_lo_e);
  l_hi = __fsub_rn(l_hi, l_hi_e);

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  l_lo = fmaxf(l_lo, 1e-37f);
  l_hi = fmaxf(l_hi, 1e-37f);
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  float* const o_lo = a.o + b * a.o_sb + r_lo * a.o_ss + h * a.o_sh + 2 * t;
  float* const o_hi = o_lo + 8 * a.o_ss;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (r_lo < a.sq)
      *reinterpret_cast<float2*>(o_lo + n * 8) =
          make_float2(__fdiv_rn(acc[n][0], l_lo), __fdiv_rn(acc[n][1], l_lo));
    if (r_hi < a.sq)
      *reinterpret_cast<float2*>(o_hi + n * 8) =
          make_float2(__fdiv_rn(acc[n][2], l_hi), __fdiv_rn(acc[n][3], l_hi));
  }
  if (a.l2 != nullptr && t == 0) {
    float* const l2 = a.l2 + (static_cast<long long>(b) * a.heads + h) * a.sq;
    if (r_lo < a.sq) l2[r_lo] = __fadd_rn(m2_lo, log2f(l_lo));
    if (r_hi < a.sq) l2[r_hi] = __fadd_rn(m2_hi, log2f(l_hi));
  }
}

// delta = sum_d dO o: one warp per (batch, head, row), rows of (B, H, Sq)
__global__ void __launch_bounds__(kThreads)
fa_delta_f32_kernel(const Tensor4 g, const Tensor4 o, float* delta, int heads, int sq,
                    long long rows) {
  const long long idx = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= rows) return;
  const int i = static_cast<int>(idx % sq);
  const long long bh = idx / sq;
  const int h = static_cast<int>(bh % heads), b = static_cast<int>(bh / heads);
  const float4 gv = *reinterpret_cast<const float4*>(g.p + b * g.sb + i * g.ss + h * g.sh + lane * 4);
  const float4 ov = *reinterpret_cast<const float4*>(o.p + b * o.sb + i * o.ss + h * o.sh + lane * 4);
  const float s = warp_sum(gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w);
  if (lane == 0) delta[idx] = s;
}

struct BwdParams {
  Tensor4 q, k, v, g;
  const float* l2;     // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  float* dq;
  float* dk;
  float* dv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int heads, sq, sk;
  float scale, c;      // c = scale * log2 e
};

// Store a warp's 16 x 128 fragment (rows r_lo, r_lo + 8 of the tensor) below `limit`.
__device__ __forceinline__ void store_rows(float* base, long long row_stride, int r_lo,
                                           int limit, int t, const float acc[16][4]) {
  float* const lo = base + r_lo * row_stride + 2 * t;
  float* const hi = lo + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (r_lo < limit) *reinterpret_cast<float2*>(lo + n * 8) = make_float2(acc[n][0], acc[n][1]);
    if (r_lo + 8 < limit)
      *reinterpret_cast<float2*>(hi + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

// dV (kDK false: += P^T dO) or dK (kDK true: += dS^T q) of 128 keys (16 a
// warp), over every query row in steps of 32. dV and dK are two launches:
// each keeps one compensated 16 x 128 sum a warp in registers (both sums
// with their compensations would not fit), and dK's recomputes S^T: five
// products where a fused pass takes four.
template <bool kDK>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkv_f32_kernel(const BwdParams a) {
  extern __shared__ __align__(16) float smem[];
  float* const s_k = smem;                       // [128][kLd]
  float* const s_v = s_k + kBlockRows * kLd;     // [128][kLd], dK's pass only
  float* const s_q = s_v + kBlockRows * kLd;     // [2][32][kLd]
  float* const s_g = s_q + 2 * kBwdStep * kLd;   // [2][32][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int tiles = (a.sq + kBwdStep - 1) / kBwdStep;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  const float* const l2 = a.l2 + row_base;
  const float* const delta = a.delta + row_base;

  load_tile<kBlockRows>(smem_u32(s_k), a.k, b, h, k0, a.sk);
  if (kDK) load_tile<kBlockRows>(smem_u32(s_v), a.v, b, h, k0, a.sk);
  load_tile<kBwdStep>(smem_u32(s_q), a.q, b, h, 0, a.sq);
  load_tile<kBwdStep>(smem_u32(s_g), a.g, b, h, 0, a.sq);
  cp_commit();

  float acc[16][4], acc_e[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = acc_e[n][j] = 0.f;
  const float* const kw = s_k + warp * 16 * kLd;
  const float* const vw = s_v + warp * 16 * kLd;

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < tiles) {
      const int nx = st ^ 1;
      load_tile<kBwdStep>(smem_u32(s_q + nx * kBwdStep * kLd), a.q, b, h,
                          (tile + 1) * kBwdStep, a.sq);
      load_tile<kBwdStep>(smem_u32(s_g + nx * kBwdStep * kLd), a.g, b, h,
                          (tile + 1) * kBwdStep, a.sq);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* const qs = s_q + st * kBwdStep * kLd;
    const float* const gs = s_g + st * kBwdStep * kLd;

    // S^T = K q^T and (dK) dP^T = V dO^T: 16 keys x 32 query rows a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kD / 8; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      load_a(kw, 0, kk * 8, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        load_bt(qs, n * 8, kk * 8, g, t, bh, bl);
        mma3(s[n], ah, al, bh, bl);
      }
      if (kDK) {
        load_a(vw, 0, kk * 8, g, t, ah, al);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          load_bt(gs, n * 8, kk * 8, g, t, bh, bl);
          mma3(dp[n], ah, al, bh, bl);
        }
      }
    }
    // P^T = exp2(S^T c - L2), and for dK dS^T = P^T (dP^T - delta) scale;
    // 0 past Sq
    const int row0 = tile * kBwdStep;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = row0 + n * 8 + 2 * t + (j & 1);
        float x = 0.f;
        if (qi < a.sq) {
          x = exp2f(__fsub_rn(__fmul_rn(s[n][j], a.c), l2[qi]));
          if (kDK) x = __fmul_rn(__fmul_rn(x, __fsub_rn(dp[n][j], delta[qi])), a.scale);
        }
        s[n][j] = x;
      }
    }
    // dV += P^T dO, or dK += dS^T q
    const float* const rhs = kDK ? qs : gs;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      c_to_a(s[kt], ah, al);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        load_b_paired(rhs, kt * 8, n * 8, g, t, bh, bl);
        mma3k(acc[n], acc_e[n], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  fold(acc, acc_e);
  const int r_lo = k0 + warp * 16 + g;
  if (kDK)
    store_rows(a.dk + b * a.dk_sb + h * a.dk_sh, a.dk_ss, r_lo, a.sk, t, acc);
  else
    store_rows(a.dv + b * a.dv_sb + h * a.dv_sh, a.dv_ss, r_lo, a.sk, t, acc);
}

// dQ of 128 query rows (16 a warp), over every key in steps of 32.
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_f32_kernel(const BwdParams a) {
  extern __shared__ __align__(16) float smem[];
  float* const s_q = smem;                       // [128][kLd]
  float* const s_g = s_q + kBlockRows * kLd;     // [128][kLd]
  float* const s_k = s_g + kBlockRows * kLd;     // [2][32][kLd]
  float* const s_v = s_k + 2 * kBwdStep * kLd;   // [2][32][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int tiles = (a.sk + kBwdStep - 1) / kBwdStep;

  load_tile<kBlockRows>(smem_u32(s_q), a.q, b, h, q0, a.sq);
  load_tile<kBlockRows>(smem_u32(s_g), a.g, b, h, q0, a.sq);
  load_tile<kBwdStep>(smem_u32(s_k), a.k, b, h, 0, a.sk);
  load_tile<kBwdStep>(smem_u32(s_v), a.v, b, h, 0, a.sk);
  cp_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.sq;
  const float l2_lo = r_lo < a.sq ? a.l2[row_base + r_lo] : 0.f;
  const float l2_hi = r_hi < a.sq ? a.l2[row_base + r_hi] : 0.f;
  const float d_lo = r_lo < a.sq ? a.delta[row_base + r_lo] : 0.f;
  const float d_hi = r_hi < a.sq ? a.delta[row_base + r_hi] : 0.f;

  float dq[16][4], dq_e[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = dq_e[n][j] = 0.f;
  const float* const qw = s_q + warp * 16 * kLd;
  const float* const gw = s_g + warp * 16 * kLd;

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < tiles) {
      const int nx = st ^ 1;
      load_tile<kBwdStep>(smem_u32(s_k + nx * kBwdStep * kLd), a.k, b, h,
                          (tile + 1) * kBwdStep, a.sk);
      load_tile<kBwdStep>(smem_u32(s_v + nx * kBwdStep * kLd), a.v, b, h,
                          (tile + 1) * kBwdStep, a.sk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* const ks = s_k + st * kBwdStep * kLd;
    const float* const vs = s_v + st * kBwdStep * kLd;

    // S = q K^T and dP = dO V^T: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kD / 8; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      load_a(qw, 0, kk * 8, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        load_bt(ks, n * 8, kk * 8, g, t, bh, bl);
        mma3(s[n], ah, al, bh, bl);
      }
      load_a(gw, 0, kk * 8, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        load_bt(vs, n * 8, kk * 8, g, t, bh, bl);
        mma3(dp[n], ah, al, bh, bl);
      }
    }
    // dS = exp2(S c - L2) (dP - delta) scale; 0 past Sk
    const int key0 = tile * kBwdStep;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + n * 8 + 2 * t + (j & 1);
        float ds = 0.f;
        if (key < a.sk) {
          const float p = exp2f(__fsub_rn(__fmul_rn(s[n][j], a.c), j < 2 ? l2_lo : l2_hi));
          ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][j], j < 2 ? d_lo : d_hi)), a.scale);
        }
        dp[n][j] = ds;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      c_to_a(dp[kt], ah, al);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        load_b_paired(ks, kt * 8, n * 8, g, t, bh, bl);
        mma3k(dq[n], dq_e[n], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  fold(dq, dq_e);
  store_rows(a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_ss, r_lo, a.sq, t, dq);
}

Tensor4 tensor4(const void* p, const long long* strides) {
  return Tensor4{static_cast<const float*>(p), strides[0], strides[1], strides[2]};
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The shared part of K3f and K3q-f: delta, then (need_kv) dK/dV, then dQ.
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               const void* l2, void* delta, void* dq, void* dk, void* dv,
               const long long* strides, int batch, int heads, int sq, int sk, float scale,
               float c, void* stream, bool need_kv) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdParams a;
  a.q = tensor4(q, strides);
  a.k = tensor4(k, strides + 3);
  a.v = tensor4(v, strides + 6);
  const Tensor4 ot = tensor4(o, strides + 9);
  a.g = tensor4(g, strides + 12);
  a.l2 = static_cast<const float*>(l2);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dq_sb = strides[15]; a.dq_ss = strides[16]; a.dq_sh = strides[17];
  a.dk_sb = strides[18]; a.dk_ss = strides[19]; a.dk_sh = strides[20];
  a.dv_sb = strides[21]; a.dv_ss = strides[22]; a.dv_sh = strides[23];
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.c = c;
  int e = set_smem(reinterpret_cast<const void*>(fa_bwd_dq_f32_kernel), kBwdSmem);
  if (e == 0 && need_kv)
    e = set_smem(reinterpret_cast<const void*>(fa_bwd_dkv_f32_kernel<false>), kBwdSmem);
  if (e == 0 && need_kv)
    e = set_smem(reinterpret_cast<const void*>(fa_bwd_dkv_f32_kernel<true>), kBwdSmem);
  if (e != 0) return e;
  const long long rows = static_cast<long long>(batch) * heads * sq;
  fa_delta_f32_kernel<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      a.g, ot, static_cast<float*>(delta), heads, sq, rows);
  if (need_kv) {
    const dim3 grid((sk + kBlockRows - 1) / kBlockRows, heads, batch);
    fa_bwd_dkv_f32_kernel<false><<<grid, kThreads, kBwdSmem, st>>>(a);
    fa_bwd_dkv_f32_kernel<true><<<grid, kThreads, kBwdSmem, st>>>(a);
  }
  fa_bwd_dq_f32_kernel<<<dim3((sq + kBlockRows - 1) / kBlockRows, heads, batch), kThreads,
                         kBwdSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1f. strides: the (batch, seq, head) element strides of q, k, v and o (12
// values); every row of 128 floats contiguous and 16-byte aligned. l2 may be
// nullptr (no stats wanted). Returns cudaGetLastError() after the launch.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v, const void* kmax,
                            void* o, void* l2, const long long* strides, int batch,
                            int heads, int sq, int sk, float q_scale, void* stream) {
  FwdParams a;
  a.q = tensor4(q, strides);
  a.k = tensor4(k, strides + 3);
  a.v = tensor4(v, strides + 6);
  a.kmax = static_cast<const float*>(kmax);
  a.o = static_cast<float*>(o);
  a.o_sb = strides[9];
  a.o_ss = strides[10];
  a.o_sh = strides[11];
  a.l2 = static_cast<float*>(l2);
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.q_scale = q_scale;
  const int e = set_smem(reinterpret_cast<const void*>(flash_fwd_f32_kernel), kFwdSmem);
  if (e != 0) return e;
  flash_fwd_f32_kernel<<<dim3((sq + kBlockRows - 1) / kBlockRows, heads, batch), kThreads,
                         kFwdSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3f: dq, dk, dv. strides: of q, k, v, o, dO, dq, dk, dv (24 values);
// delta: (B, H, Sq) fp32 scratch. Returns cudaGetLastError() after the launches.
int flash_attention_f32_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, const void* l2, void* delta, void* dq, void* dk,
                            void* dv, const long long* strides, int batch, int heads, int sq,
                            int sk, float scale, float c, void* stream) {
  return launch_bwd(q, k, v, o, g, l2, delta, dq, dk, dv, strides, batch, heads, sq, sk,
                    scale, c, stream, true);
}

// K3q-f: dq alone (the dk/dv strides are not read).
int flash_attention_f32_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* g, const void* l2, void* delta, void* dq,
                               const long long* strides, int batch, int heads, int sq, int sk,
                               float scale, float c, void* stream) {
  return launch_bwd(q, k, v, o, g, l2, delta, dq, nullptr, nullptr, strides, batch, heads, sq,
                    sk, scale, c, stream, false);
}

const char* flash_attention_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
