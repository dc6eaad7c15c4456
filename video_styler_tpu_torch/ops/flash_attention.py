"""The flash-attention kernels: K1 (capped-softmax forward), K2 and K8
(online-softmax forward, single and dual), K3 (the backward), K6 and K7
(int8 Q K^T forward, 4-D and 3-D), with their plain versions and the
autograd Function that joins a forward with K3.

K1 replaces the Pallas kernel `_flash_kernel_4d_capped`
(video_styler_tpu/ops/flash_attention.py:213, via `_flash_fwd_4d` :352 with
capped=True, the default of the JAX package); with stats it also writes the
per-row base-2 logsumexp L2 (B, N, Sq) that the backward needs (:284-285).
K3 replaces `_fa_bwd_kernel_dkv` (:582) and `_fa_bwd_kernel_dq` (:624), via
`_fa_bwd_pallas` (:664). Both are hand-written CUDA C++ for Hopper on
`wgmma` and TMA (`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`,
their building blocks in `csrc/sm90_wgmma.cuh`); their header notes say
what bounds them on the H100 (the tensor cores) and how the designs meet
that. They load q, k, v and dO through 4-D tensor maps, which
`tma_layout` describes and checks.

The capped softmax has no running max. Each query row gets an upper bound
on its base-2 logits, m2 = min(||q'|| * max_j ||k_j|| * 1.0001, 96), with q'
the scaled and downcast query; then p = exp2(q'.k - m2) <= 1 and
o = sum(bf16(p) v) / max(sum(p), 1e-37), so a fully flushed row gives 0.
The per-(batch, head) max key norm is a plain reduction outside the kernel,
as in the JAX package (:386-387).

`flash_attention` goes through `FlashAttentionFunction` (the counterpart of
`_flash_4d`'s custom_vjp, :793-822) when grad is enabled and an input
requires grad: its forward keeps q, k, v, o and L2, its backward runs K3.
Otherwise it runs the forward alone, without stats. On CPU tensors every
step takes its plain version; on CUDA tensors it launches the kernel or
raises.

K2 replaces `_flash_kernel_4d` (:150, `_flash_fwd_4d` with capped=False,
i.e. `FLASH_CAPPED=0`) and its 3-D twin `_flash_kernel` (:54); K8 replaces
`_flash_kernel_4d_dual` (:288, `FLASH_DUAL=1`). Both are the exact softmax
with a running max over steps of TILE_K keys (K8: two such sub-tiles and
one max), on the same `wgmma` and TMA building blocks as K1
(`csrc/flash_attention_online.cu`, bound by the tensor cores as K1 is): K2
in K1's block with a producer warpgroup, K8, whose two sub-tiles' logits
do not fit three warpgroups' registers, in K3's block of two warpgroups.
K2 can write the same L2 = m + log2 l, so K3 serves that route unchanged.
`flash_attention` reads `FLASH_CAPPED` / `FLASH_DUAL` at call time when its
`capped` / `dual` arguments are None, as `_flash_fwd_4d` does (:372-379).

K1f, K3f and K3q-f are K1, K3 and K3q on float32 operands, the Pallas
kernels as the Ditto LoRA recipe runs them on its fp32 activations
(examples/train.py:281-282): q scaled in fp32, P not rounded before P V,
every sum in fp32, fp32 outputs (`csrc/flash_attention_f32.cu`: three TF32
passes a product on `mma.sync`, bound by the tensor cores like K1). Every
CUDA entry picks the instantiation by q's dtype (`forward_kernel`,
`backward_kernel`); any other dtype, and K2 or K8 on float32 (still to
port: ROADMAP Queue 2 item 9), raises TypeError.

K6 replaces `_flash_kernel_int8_4d_capped` (:1025) and
`_flash_kernel_int8_4d` (:980), K7 the 3-D `_flash_kernel_int8` (:862):
SageAttention-style attention with Q K^T on the int8 tensor cores
(`csrc/flash_attention_int8.cu`: K1's block, S on `wgmma` s8, the int8 Q
and K tiles through the same tensor maps, K7 the online body on an n = 1
view). Their pre-pass (K minus its token mean, per-row absmax int8
quantisation, the capped route's row bound m2) is plain PyTorch here as it
is XLA in the JAX package (:1103-1120). They have no backward, there as
here.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import F32, I32, I64, P, Kernel
# per-row absmax / 127 scales floored at 1e-8, round half to even, clip to
# +-127: `_quantize_rows_int8` (:909) is the linears' activation quantiser
from .quant import quantize_act_int8 as quantize_rows_int8

LOG2_E = 1.4426950408889634
NEG_INF = -1e30  # what a padded key's logit counts as
HEAD_DIM = 128  # the kernels' head dim (every Wan DiT config)
TILE_K = 128    # keys per step of K2 (K8: two such sub-tiles, one max)
INT8_TILE_K = 128  # keys per step of K6's online body and K7
BWD_TILE_Q = 64  # query rows per step of K3 (its L2/delta copies pad to it)
TMA_MAX_STRIDE = 1 << 40  # a tensor map's byte strides stay below this

KERNEL = Kernel("flash_attention", "flash_attention_capped_fwd",
                [P] * 8 + [I32, I32, I32, I32, F32, P],
                "flash_attention_error_string")
# K3: dq, dk and dv in one kernel; without dK/dV wanted, its dq-only twin
BWD_KERNEL = Kernel("flash_attention_bwd", "flash_attention_bwd",
                    [P] * 14 + [I32] * 4 + [F32, F32, P],
                    "flash_attention_bwd_error_string")
BWD_DQ_KERNEL = Kernel("flash_attention_bwd", "flash_attention_bwd_dq",
                       [P] * 12 + [I32] * 4 + [F32, F32, P],
                       "flash_attention_bwd_error_string")
ONLINE_KERNEL = Kernel("flash_attention_online", "flash_attention_online_fwd",
                       [P] * 7 + [I32] * 4 + [F32, P],
                       "flash_attention_online_error_string")
DUAL_KERNEL = Kernel("flash_attention_online", "flash_attention_online_dual_fwd",
                     [P] * 7 + [I32] * 4 + [F32, P],
                     "flash_attention_online_error_string")
INT8_CAPPED_KERNEL = Kernel("flash_attention_int8", "flash_attention_int8_capped_fwd",
                            [P] * 9 + [I32] * 5 + [P],
                            "flash_attention_int8_error_string")
INT8_ONLINE_KERNEL = Kernel("flash_attention_int8", "flash_attention_int8_online_fwd",
                            [P] * 8 + [I32] * 5 + [P],
                            "flash_attention_int8_error_string")
# K1f, K3f, K3q-f: K1, K3 and K3q on float32 operands
F32_KERNEL = Kernel("flash_attention_f32", "flash_attention_f32_fwd",
                    [P] * 7 + [I32] * 4 + [F32, P], "flash_attention_f32_error_string")
BWD_F32_KERNEL = Kernel("flash_attention_f32", "flash_attention_f32_bwd",
                        [P] * 11 + [I32] * 4 + [F32, F32, P],
                        "flash_attention_f32_error_string")
BWD_DQ_F32_KERNEL = Kernel("flash_attention_f32", "flash_attention_f32_bwd_dq",
                           [P] * 9 + [I32] * 4 + [F32, F32, P],
                           "flash_attention_f32_error_string")
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# K7: the online entry on (BH, S, 1, D) views, counted apart
INT8_3D_KERNEL = Kernel("flash_attention_int8", "flash_attention_int8_online_fwd",
                        [P] * 8 + [I32] * 5 + [P],
                        "flash_attention_int8_error_string")


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """(B, Sk, N, D) -> (B, N) float32 max over keys of ||k_j||."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1)


def _row_chunk(b: int, n: int, sk: int, max_elements: int) -> int:
    return max(1, max_elements // max(1, b * n * sk))


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          max_elements: int = 1 << 28,
                          return_stats: bool = False):
    """K1's plain version: q (B, Sq, N, D), k/v (B, Sk, N, D) -> (B, Sq, N, D),
    and with return_stats also L2 = m2 + log2(max(l, 1e-37)), (B, N, Sq) f32.

    Same rounding points as the kernel: the scaled q is downcast to q.dtype,
    both products accumulate in fp32 from exactly upcast operands, p is
    rounded to v.dtype before the PV product. Query rows are independent,
    so they are processed in chunks of at most `max_elements` logits."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kcap = key_norm_max(k) * 1.0001                              # (B, N)
    qs = (q.float() * (scale * LOG2_E)).to(q.dtype)
    kt = k.float().permute(0, 2, 3, 1)                           # (B, N, D, Sk)
    vf = v.float().permute(0, 2, 1, 3)                           # (B, N, Sk, D)
    rows = _row_chunk(b, n, sk, max_elements)
    out = torch.empty_like(q)
    l2 = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
          if return_stats else None)
    for i0 in range(0, sq, rows):
        qc = qs[:, i0:i0 + rows].float().permute(0, 2, 1, 3)     # (B, N, c, D)
        m2 = torch.clamp(torch.linalg.vector_norm(qc, dim=-1)
                         * kcap[:, :, None], max=96.0)           # (B, N, c)
        p = torch.exp2(torch.matmul(qc, kt) - m2[..., None])
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        out[:, i0:i0 + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
        if return_stats:
            l2[:, :, i0:i0 + rows] = m2 + torch.log2(l[..., 0])
    return (out, l2) if return_stats else out


def flash_attention_bwd_plain(q, k, v, o, l2, g, scale: Optional[float] = None,
                              max_elements: int = 1 << 28):
    """K3's plain version: the gradients (dq, dk, dv) of K1 at output
    cotangent g, from the forward's o and L2 (B, N, Sq).

    The Pallas kernels' rounding points: delta = sum_d g*o in fp32;
    s2 = (q.k) * scale*log2(e) in fp32 from the unscaled q; P = exp2(s2 - L2);
    dV = bf16(P)^T g; dS = bf16(P (g.v - delta) scale); dK = dS^T q and
    dQ = dS k, accumulated in fp32 and cast once. Query rows go in chunks
    of at most `max_elements` logits; dK and dV sum over the chunks."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    c = scale * LOG2_E
    kf = k.float().permute(0, 2, 1, 3)                           # (B, N, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.empty_like(q)
    rows = _row_chunk(b, n, sk, max_elements)
    for i0 in range(0, sq, rows):
        sl = slice(i0, i0 + rows)
        qc = q[:, sl].float().permute(0, 2, 1, 3)                # (B, N, c, D)
        gc = g[:, sl].to(q.dtype).float().permute(0, 2, 1, 3)
        delta = (gc * o[:, sl].float().permute(0, 2, 1, 3)).sum(-1, keepdim=True)
        p = torch.exp2(torch.matmul(qc, kf.transpose(-1, -2)) * c
                       - l2[:, :, sl, None].float())             # (B, N, c, Sk)
        dv += torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gc)
        dp = torch.matmul(gc, vf.transpose(-1, -2))
        ds = (p * (dp - delta) * scale).to(q.dtype).float()
        dq[:, sl] = torch.matmul(ds, kf).permute(0, 2, 1, 3).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))

def _online_terms(s, block: int):
    """The running max's rounding points, without the loop over key tiles.

    s: (..., Sk) fp32 logits. Tile t of `block` keys sees the running max
    m_t = max over tiles 0..t. Returns p = exp2(s - m_t) (what a step rounds
    to v.dtype for the PV product), w = exp2(m_t - m) (what the later
    steps' alphas multiply that step's sums by, up to fp32 rounding of the
    chain) and the final max m (...)."""
    sk = s.shape[-1]
    tiles = -(-sk // block)
    sp = F.pad(s, (0, tiles * block - sk), value=NEG_INF)
    m_t = sp.unflatten(-1, (tiles, block)).amax(-1).cummax(-1).values
    m_run = m_t.repeat_interleave(block, dim=-1)[..., :sk]
    m = m_t[..., -1]
    return torch.exp2(s - m_run), torch.exp2(m_run - m[..., None]), m


def flash_attention_online_plain(q, k, v, scale: Optional[float] = None,
                                 dual: bool = False, return_stats: bool = False,
                                 max_elements: int = 1 << 27):
    """K2's plain version (K8's with dual=True): the exact softmax with the
    kernels' running max over steps of TILE_K keys (dual: two such
    sub-tiles, one merged update). q (B, Sq, N, D), k/v (B, Sk, N, D) -> (B, Sq, N, D), and with
    return_stats L2 = m + log2 l, (B, N, Sq) f32 (single only, as in the JAX
    package).

    Same rounding points as the kernels: the scaled q is downcast to
    q.dtype, both products accumulate in fp32, each step's p is taken
    against the running max of its step and rounded to v.dtype."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if dual and return_stats:
        raise ValueError("the dual kernel writes no stats")
    block = TILE_K * (2 if dual else 1)
    qs = (q.float() * (scale * LOG2_E)).to(q.dtype)
    kt = k.float().permute(0, 2, 3, 1)                           # (B, N, D, Sk)
    vf = v.float().permute(0, 2, 1, 3)                           # (B, N, Sk, D)
    rows = _row_chunk(b, n, sk, max_elements)
    out = torch.empty_like(q)
    l2 = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
          if return_stats else None)
    for i0 in range(0, sq, rows):
        qc = qs[:, i0:i0 + rows].float().permute(0, 2, 1, 3)     # (B, N, c, D)
        p, w, m = _online_terms(torch.matmul(qc, kt), block)
        l = (p * w).sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float() * w, vf) / l
        out[:, i0:i0 + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
        if return_stats:
            l2[:, :, i0:i0 + rows] = m + torch.log2(l[..., 0])
    return (out, l2) if return_stats else out


def int8_prepass(q, k, v, scale: float, capped: bool):
    """What the int8 kernels take, from float q (B, Sq, N, D), k/v
    (B, Sk, N, D): q_i8, k_i8 (same shapes, int8; K minus its mean over
    tokens first, which shifts every logit of a row by the same q . k_mean
    and so leaves the softmax alone), v in bfloat16, the row scales qs
    (B, N, Sq) (carrying scale * log2 e) and ks (B, N, Sk), and on the
    capped route m2 (B, N, Sq) = min(qs ||q_i8|| max_j(ks_j ||k_i8_j||)
    * 1.0001, 96), an exact bound on the integer logits (else None).
    The order of operations is `_flash_fwd_4d_int8`'s (:1103-1120)."""
    kf = k.float()
    # the mean as sum * (1 / n), which is how XLA evaluates `jnp.mean`
    k_mean = kf.sum(dim=1, keepdim=True) * (1.0 / k.shape[1])
    q_i8, q_s = quantize_rows_int8(q)                            # (B, Sq, N, 1)
    k_i8, k_s = quantize_rows_int8(kf - k_mean)
    q_s = q_s * (scale * LOG2_E)
    m2 = None
    if capped:
        # the sums of squares are exact integers; the root goes through
        # float64 because PyTorch's CPU float32 sqrt is not correctly rounded
        qn = q_i8.float().square().sum(dim=-1, keepdim=True).double().sqrt().float()
        kn = k_i8.float().square().sum(dim=-1, keepdim=True).double().sqrt().float()
        kmax = (k_s * kn).amax(dim=1, keepdim=True)              # (B, 1, N, 1)
        m2 = (q_s * qn * kmax * 1.0001).clamp(max=96.0)
        m2 = m2[..., 0].transpose(1, 2).contiguous()
    return (q_i8, k_i8, v.to(torch.bfloat16),
            q_s[..., 0].transpose(1, 2).contiguous(),
            k_s[..., 0].transpose(1, 2).contiguous(), m2)


def flash_attention_int8_core_plain(q_i8, k_i8, v, qs, ks, m2=None,
                                    max_elements: int = 1 << 27):
    """K6's plain version on the pre-pass's outputs (m2 given: the capped
    body; None: the online body over steps of INT8_TILE_K keys) -> (B, Sq, N, D)
    bfloat16.

    The kernels' rounding points: the integer dot is exact (128 terms of at
    most 127^2 stay below 2^24, so fp32 holds it), s = (dot * qs) * ks, p is
    rounded to bfloat16 before the PV product, which accumulates in fp32."""
    b, sq, n, d = q_i8.shape
    sk = k_i8.shape[1]
    kt = k_i8.float().permute(0, 2, 3, 1)                        # (B, N, D, Sk)
    vf = v.float().permute(0, 2, 1, 3)
    rows = _row_chunk(b, n, sk, max_elements)
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q_i8.device)
    for i0 in range(0, sq, rows):
        sl = slice(i0, i0 + rows)
        qc = q_i8[:, sl].float().permute(0, 2, 1, 3)             # (B, N, c, D)
        s = torch.matmul(qc, kt) * qs[:, :, sl, None] * ks[:, :, None, :]
        if m2 is not None:
            p = torch.exp2(s - m2[:, :, sl, None])
            l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
            o = torch.matmul(p.to(torch.bfloat16).float(), vf) / l
        else:
            p, w, _ = _online_terms(s, INT8_TILE_K)
            l = (p * w).sum(dim=-1, keepdim=True)
            o = torch.matmul(p.to(torch.bfloat16).float() * w, vf) / l
        out[:, sl] = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out


def flash_attention_int8_plain(q, k, v, scale: Optional[float] = None,
                               capped: bool = True, max_elements: int = 1 << 27):
    """The pre-pass and K6's plain version: q (B, Sq, N, D), k/v
    (B, Sk, N, D), any float dtype and head dim -> (B, Sq, N, D) q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_int8_core_plain(*int8_prepass(q, k, v, scale, capped),
                                          max_elements=max_elements)
    return out.to(q.dtype)


def _check_dtype(name: str, dtype):
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the flash kernels take bfloat16 (K1, K2, K3, K8) or "
                        f"float32 (K1f, K3f), got {dtype}")


def forward_kernel(dtype, capped: bool = True, dual: bool = False) -> Kernel:
    """The forward kernel that a CUDA call on `dtype` tensors launches: K1
    (capped), K2 (online) or K8 (online, dual) on bfloat16, K1f on float32.
    Raises TypeError for any other dtype, and for K2 or K8 on float32."""
    _check_dtype("q", dtype)
    if dtype == torch.float32:
        if not capped or dual:
            raise TypeError("K2 and K8 take bfloat16: their float32 instantiations are "
                            "still to port (ROADMAP Queue 2 item 9)")
        return F32_KERNEL
    if not capped:
        return DUAL_KERNEL if dual else ONLINE_KERNEL
    return KERNEL


def backward_kernel(dtype, need_kv: bool = True) -> Kernel:
    """The backward kernel that a CUDA call on `dtype` tensors launches: K3
    (dq, dk, dv) or K3q (dq alone) on bfloat16, K3f or K3q-f on float32;
    TypeError for any other dtype."""
    _check_dtype("q", dtype)
    if dtype == torch.float32:
        return BWD_F32_KERNEL if need_kv else BWD_DQ_F32_KERNEL
    return BWD_KERNEL if need_kv else BWD_DQ_KERNEL


def _check(name: str, t: torch.Tensor, device, dtype=torch.bfloat16):
    if t.dtype != dtype:
        _check_dtype(name, t.dtype)
        raise TypeError(f"{name} is {t.dtype}, q is {dtype}: one call takes bfloat16 "
                        f"or float32 throughout")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: need a (B, S, N, {HEAD_DIM}) bfloat16 or float32 "
                         f"tensor, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows of bfloat16 or float32 must be contiguous and "
                         f"16-byte aligned (strides {t.stride()})")


def _check_qkv(q, k, v):
    b, sq, n, _ = q.shape
    _check_dtype("q", q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device, q.dtype)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n or k.shape[1] == 0:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")


def tma_layout(t: torch.Tensor):
    """The 4-D tensor map through which K1, K2, K3, K6 and K8 load a
    (B, S, N, D) tensor (bf16, or int8 for K6's q8 and k8): its dims
    innermost first, (D, N, S, B), and the byte strides of
    N, S and B. A dimension of size 1 takes the stride of a contiguous
    layout, which its real one may not be (the map never steps along it).
    Raises ValueError where TMA cannot read the tensor: D not contiguous,
    a base or a byte stride not a multiple of 16, a stride of 0 (broadcast)
    or of 2**40 bytes or more."""
    b, s, n, d = t.shape
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"tensor map: the last dim must be contiguous (strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError("tensor map: the base address must be 16-byte aligned")
    strides, extent = [], d * es
    for size, st in ((n, t.stride(2)), (s, t.stride(1)), (b, t.stride(0))):
        nbytes = st * es if size > 1 else extent
        if nbytes <= 0 or nbytes % 16 or nbytes >= TMA_MAX_STRIDE:
            raise ValueError(f"tensor map: byte strides must be positive multiples of 16 "
                             f"below 2**40 (strides {t.stride()}, {es}-byte elements)")
        strides.append(nbytes)
        extent = nbytes * size
    return (d, n, s, b, *strides)


def _layouts(*tensors):
    """The tensor-map layouts of the tensors, 7 values each, as a C array."""
    vals = [v for t in tensors for v in tma_layout(t)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_cuda(q, k, v, scale: float, with_stats: bool = False):
    """K1 on bfloat16, K1f on float32."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v)
    kern = forward_kernel(q.dtype)
    kmax = key_norm_max(k).contiguous()
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    l2 = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
          if with_stats else None)
    if kern is F32_KERNEL:
        strides = _strides(q, k, v, out)
        kern(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(), out.data_ptr(),
             None if l2 is None else l2.data_ptr(), ctypes.addressof(strides),
             b, n, sq, sk, scale * LOG2_E, torch.cuda.current_stream(q.device).cuda_stream)
        return (out, l2) if with_stats else out
    layout = _layouts(q, k, v)
    o_strides = _strides(out)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
           out.data_ptr(), None if l2 is None else l2.data_ptr(),
           ctypes.addressof(layout), ctypes.addressof(o_strides),
           b, n, sq, sk, scale * LOG2_E,
           torch.cuda.current_stream(q.device).cuda_stream)
    return (out, l2) if with_stats else out


class _BwdLaunch:
    """The checked arguments, outputs and scratch of one K3 call; `run()`
    launches it: the fused kernel when dK/dV are wanted, else its dq-only
    twin. Scratch: L2 and delta padded to whole query tiles, and the fp32
    dQ accumulator that the blocks add into, (B, N, Sq padded, D) elements
    in the kernel's tile order. On float32 (K3f, K3q-f) the scratch is delta
    alone, (B, N, Sq), and the outputs are float32."""

    def __init__(self, q, k, v, o, l2, g, scale: float, need_kv: bool):
        b, sq, n, d = q.shape
        _check_qkv(q, k, v)
        self.kernel = backward_kernel(q.dtype, need_kv)
        g = g.contiguous()
        for name, t in (("o", o), ("dO", g)):
            _check(name, t, q.device, q.dtype)
            if t.shape != q.shape:
                raise ValueError(f"{name} {tuple(t.shape)} does not fit q {tuple(q.shape)}")
        if (l2.dtype != torch.float32 or l2.shape != (b, n, sq)
                or not l2.is_contiguous() or l2.device != q.device):
            raise ValueError(f"L2: need contiguous float32 {(b, n, sq)} on {q.device}")
        dev = q.device
        self.need_kv = need_kv
        self.dk = self.dv = None
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        if q.dtype == torch.float32:
            self._init_f32(q, k, v, o, l2, g, scale)
            return
        sq_pad = -(-sq // BWD_TILE_Q) * BWD_TILE_Q
        self.l2p = torch.empty((b, n, sq_pad), dtype=torch.float32, device=dev)
        self.deltap = torch.empty_like(self.l2p)
        self.dq_acc = torch.empty((b, n, sq_pad, d), dtype=torch.float32, device=dev)
        self.dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=dev)
        if need_kv:
            self.dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
            self.dv = torch.empty_like(self.dk)
        self.layout = _layouts(q, k, v, g)
        self.strides = _strides(o, g, self.dq, *((self.dk, self.dv) if need_kv else ()))
        self.ptrs = [t.data_ptr() for t in (q, k, v, o, g, l2, self.l2p, self.deltap,
                                            self.dq_acc, self.dq)]
        self.keep = (q, k, v, o, l2, g)
        self.dims = (b, n, sq, k.shape[1], scale, scale * LOG2_E)

    def _init_f32(self, q, k, v, o, l2, g, scale: float):
        b, sq, n, d = q.shape
        dev = q.device
        self.delta = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
        self.dq = torch.empty((b, sq, n, d), dtype=torch.float32, device=dev)
        if self.need_kv:
            self.dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
            self.dv = torch.empty_like(self.dk)
        outs = (self.dq, self.dk, self.dv) if self.need_kv else (self.dq, self.dq, self.dq)
        self.strides = _strides(q, k, v, o, g, *outs)
        self.ptrs = [t.data_ptr() for t in (q, k, v, o, g, l2, self.delta, self.dq)]
        if self.need_kv:
            self.ptrs += [self.dk.data_ptr(), self.dv.data_ptr()]
        self.keep = (q, k, v, o, l2, g)
        self.dims = (b, n, sq, k.shape[1], scale, scale * LOG2_E)

    def run(self):
        if self.kernel in (BWD_F32_KERNEL, BWD_DQ_F32_KERNEL):
            self.kernel(*self.ptrs, ctypes.addressof(self.strides), *self.dims, self.stream)
            return
        tail = (ctypes.addressof(self.layout), ctypes.addressof(self.strides),
                *self.dims, self.stream)
        if self.need_kv:
            BWD_KERNEL(*self.ptrs, self.dk.data_ptr(), self.dv.data_ptr(), *tail)
        else:
            BWD_DQ_KERNEL(*self.ptrs, *tail)


def _flash_bwd_cuda(q, k, v, o, l2, g, scale: float, need_kv: bool = True):
    """K3 on the card. Returns (dq, dk, dv); dk and dv are None when not
    wanted."""
    launch = _BwdLaunch(q, k, v, o, l2, g, scale, need_kv)
    launch.run()
    return launch.dq, launch.dk, launch.dv


def flash_attention_bwd(q, k, v, o, l2, g, scale: Optional[float] = None,
                        need_kv: bool = True):
    """K3: (dq, dk, dv) of K1 at cotangent g. CUDA tensors launch the
    kernel (dk, dv None unless need_kv): K3 on bfloat16, K3f on float32;
    CPU tensors run the plain version. On the card K3's dq is summed by
    reduce-adds in an order that changes from run to run: it agrees with
    itself within fp32 rounding, not bit for bit (K3f repeats exactly)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, l2, g, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"K3 runs on CUDA or (plain) CPU, not {q.device}")
    return _flash_bwd_cuda(q, k, v, o, l2, g, scale, need_kv)


def _strides(*tensors):
    """The (batch, sequence, head) element strides of each tensor, as a C
    array."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flash_online_cuda(q, k, v, q_scale: float, with_stats: bool = False,
                       dual: bool = False):
    """K2 (dual: K8) on the card. `q_scale` multiplies q on load (fp32,
    downcast); 1.0 takes q as it is (the 3-D entry scales it beforehand)."""
    b, sq, n, d = q.shape
    _check_qkv(q, k, v)
    forward_kernel(q.dtype, capped=False, dual=dual)
    if dual and with_stats:
        raise ValueError("the dual kernel writes no stats")
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    l2 = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
          if with_stats else None)
    layout = _layouts(q, k, v)
    o_strides = _strides(out)
    (DUAL_KERNEL if dual else ONLINE_KERNEL)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if l2 is None else l2.data_ptr(), ctypes.addressof(layout),
        ctypes.addressof(o_strides), b, n, sq, k.shape[1], q_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    return (out, l2) if with_stats else out


def _flash_forward(q, k, v, scale: float, with_stats: bool = False,
                   capped: bool = True, dual: bool = False):
    """One forward: K1 (capped), K2 (online) or K8 (online, dual), or on CPU
    tensors the plain version of the same."""
    if q.device.type == "cpu":
        if capped:
            return flash_attention_plain(q, k, v, scale, return_stats=with_stats)
        return flash_attention_online_plain(q, k, v, scale, dual=dual,
                                            return_stats=with_stats)
    if q.device.type != "cuda":
        raise RuntimeError(f"the flash kernels run on CUDA or (plain) CPU, not {q.device}")
    if capped:
        return _flash_cuda(q, k, v, scale, with_stats)
    return _flash_online_cuda(q, k, v, scale * LOG2_E, with_stats, dual)


class FlashAttentionFunction(torch.autograd.Function):
    """K1 (capped) or K2 (online) forward with stats, K3 backward
    (`_flash_4d`'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, capped: bool = True):
        o, l2 = _flash_forward(q, k, v, scale, with_stats=True, capped=capped)
        ctx.save_for_backward(q, k, v, o, l2)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, l2 = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l2, g, ctx.scale, need_kv)
        return dq, dk, dv, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) == "1"


def flash_attention(q, k, v, scale: Optional[float] = None,
                    capped: Optional[bool] = None,
                    dual: Optional[bool] = None) -> torch.Tensor:
    """q: (B, Sq, N, D), k/v: (B, Sk, N, D) -> (B, Sq, N, D), non-causal;
    differentiable through K3 when grad is enabled.

    capped (None: the environment's FLASH_CAPPED, unset = on) picks K1 over
    the online-softmax K2; dual (None: FLASH_DUAL, unset = off) picks K8,
    which writes no stats: a call that needs the backward, or capped with
    dual off, switches it off, and dual switches capped off, as
    `_flash_fwd_4d` does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dual is None:
        dual = _env_flag("FLASH_DUAL", "0")
    if capped is None:
        capped = _env_flag("FLASH_CAPPED", "1")
    if _wants_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, scale, capped)
    capped = capped and not dual
    return _flash_forward(q, k, v, scale, capped=capped, dual=dual)


class _Flash3dFunction(torch.autograd.Function):
    """`_flash_3d`'s custom_vjp: K2 with stats on the n = 1 view, then K3."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, l2 = _flash_forward(q[:, :, None], k[:, :, None], v[:, :, None], scale,
                               with_stats=True, capped=False)
        ctx.save_for_backward(q, k, v, o, l2)
        ctx.scale = scale
        return o[:, :, 0]

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, l2 = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = flash_attention_bwd(q[:, :, None], k[:, :, None], v[:, :, None],
                                         o, l2, g[:, :, None], ctx.scale, need_kv)
        return (dq[:, :, 0], None if dk is None else dk[:, :, 0],
                None if dv is None else dv[:, :, 0], None)


def flash_attention_3d(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """The (BH, S, D) entry (`_flash_3d`, :768): q (BH, Sq, D), k/v
    (BH, Sk, D) -> (BH, Sq, D), online softmax (K2 on an n = 1 view of the
    same memory), differentiable through K3.

    Without grad it is `_flash_fwd_3d` (:103): q is scaled by
    scale * log2 e beforehand (fp32 multiply, downcast) and the kernel
    takes it as it is."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _wants_grad(q, k, v):
        return _Flash3dFunction.apply(q, k, v, scale)
    q4, k4, v4 = q[:, :, None], k[:, :, None], v[:, :, None]
    if q.device.type == "cpu":
        return flash_attention_online_plain(q4, k4, v4, scale)[:, :, 0]
    if q.device.type != "cuda":
        raise RuntimeError(f"K2 runs on CUDA or (plain) CPU, not {q.device}")
    q4 = (q4.float() * (scale * LOG2_E)).to(q.dtype)
    return _flash_online_cuda(q4, k4, v4, 1.0)[:, :, 0]


def _check_rows(name: str, t: torch.Tensor, shape, device):
    if (t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name}: need contiguous float32 {tuple(shape)} on {device}")


def _flash_int8_cuda(q_i8, k_i8, v, qs, ks, m2=None, three_d: bool = False):
    """K6 on the card (m2 given: the capped body, None: the online body), or
    with three_d K7 (the online body, counted apart), on the pre-pass's
    outputs. 4-D tensors either way; K7 takes them as (BH, S, 1, D) views of
    3-D tensors. q_i8, k_i8 and v go through tensor maps (`tma_layout`);
    ks is copied with each (batch, head) row padded by zeros to whole
    128-key steps, which the kernel reads 512 bytes at a time."""
    b, sq, n, d = q_i8.shape
    sk = k_i8.shape[1]
    dev = q_i8.device
    _check("v", v, dev)
    if d != HEAD_DIM or k_i8.shape != v.shape or k_i8.shape[0] != b \
            or k_i8.shape[2] != n or sk == 0:
        raise ValueError(f"q_i8 {tuple(q_i8.shape)} / k_i8 {tuple(k_i8.shape)} / "
                         f"v {tuple(v.shape)} do not fit (head dim {HEAD_DIM})")
    for name, t in (("q_i8", q_i8), ("k_i8", k_i8)):
        if t.dtype != torch.int8 or t.device != dev:
            raise ValueError(f"{name}: need int8 on {dev}, got {t.dtype} on {t.device}")
    _check_rows("qs", qs, (b, n, sq), dev)
    _check_rows("ks", ks, (b, n, sk), dev)
    if m2 is not None:
        _check_rows("m2", m2, (b, n, sq), dev)
    if three_d and (n != 1 or m2 is not None):
        raise ValueError("K7 is the online body on one head per batch entry")
    layout = _layouts(q_i8, k_i8, v)
    ks_pad = F.pad(ks, (0, -sk % INT8_TILE_K))
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=dev)
    o_strides = _strides(out)
    ptrs = (q_i8.data_ptr(), k_i8.data_ptr(), v.data_ptr(), qs.data_ptr(),
            ks_pad.data_ptr())
    tail = (out.data_ptr(), ctypes.addressof(layout), ctypes.addressof(o_strides),
            b, n, sq, sk, ks_pad.shape[-1], torch.cuda.current_stream(dev).cuda_stream)
    if m2 is not None:
        INT8_CAPPED_KERNEL(*ptrs, m2.data_ptr(), *tail)
    else:
        (INT8_3D_KERNEL if three_d else INT8_ONLINE_KERNEL)(*ptrs, *tail)
    return out


def _int8_forward(q, k, v, scale: float, capped: bool, three_d: bool = False):
    if _wants_grad(q, k, v):
        raise RuntimeError("the int8 attention kernels have no backward "
                           "(inference only, as in the JAX package)")
    pre = int8_prepass(q, k, v, scale, capped)
    if q.device.type == "cpu":
        return flash_attention_int8_core_plain(*pre)
    if q.device.type != "cuda":
        raise RuntimeError(f"K6/K7 run on CUDA or (plain) CPU, not {q.device}")
    return _flash_int8_cuda(*pre, three_d=three_d)


def flash_attention_int8(q, k, v, scale: Optional[float] = None,
                         capped: Optional[bool] = None) -> torch.Tensor:
    """SageAttention-style int8 flash attention (K6): q (B, Sq, N, D), k/v
    (B, Sk, N, D) -> (B, Sq, N, D) in q.dtype. capped None reads the
    environment's FLASH_CAPPED (unset = on): the row-bound body, else the
    online-softmax body. No backward."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if capped is None:
        capped = _env_flag("FLASH_CAPPED", "1")
    return _int8_forward(q, k, v, scale, capped).to(q.dtype)


def flash_attention_int8_3d(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """The (BH, S, D) int8 entry (K7, `_flash_fwd_3d_int8` :918): online
    softmax, scales per (batch-head, token); returns bfloat16 as the JAX
    function does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _int8_forward(q[:, :, None], k[:, :, None], v[:, :, None], scale,
                         capped=False, three_d=True)[:, :, 0]
