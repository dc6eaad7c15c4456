"""K1 (the capped-softmax flash-attention forward) and K3 (its backward),
with their plain versions and the autograd Function that joins them.

K1 replaces the Pallas kernel `_flash_kernel_4d_capped`
(video_styler_tpu/ops/flash_attention.py:213, via `_flash_fwd_4d` :352 with
capped=True, the default of the JAX package); with stats it also writes the
per-row base-2 logsumexp L2 (B, N, Sq) that the backward needs (:284-285).
K3 replaces `_fa_bwd_kernel_dkv` (:582) and `_fa_bwd_kernel_dq` (:624), via
`_fa_bwd_pallas` (:664). Both are hand-written CUDA C++
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`); their header
notes say what bounds them on the H100 (the tensor cores) and how the
mma.sync designs meet that.

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
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .cuda_build import F32, I32, I64, P, Kernel

LOG2_E = 1.4426950408889634
HEAD_DIM = 128  # the kernels' head dim (every Wan DiT config)

KERNEL = Kernel("flash_attention", "flash_attention_capped_fwd",
                [P] * 6 + [I64] * 12 + [I32, I32, I32, I32, F32, P],
                "flash_attention_error_string")
BWD_DQ_KERNEL = Kernel("flash_attention_bwd", "flash_attention_bwd_dq",
                       [P] * 9 + [I32] * 4 + [F32, F32, P],
                       "flash_attention_bwd_error_string")
BWD_DKV_KERNEL = Kernel("flash_attention_bwd", "flash_attention_bwd_dkv",
                        [P] * 9 + [I32] * 4 + [F32, F32, P],
                        "flash_attention_bwd_error_string")


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


def _check(name: str, t: torch.Tensor, device):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: K1/K3 take bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: need (B, S, N, {HEAD_DIM}), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned "
                         f"(strides {t.stride()})")


def _check_qkv(q, k, v):
    b, sq, n, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n or k.shape[1] == 0:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")


def _flash_cuda(q, k, v, scale: float, with_stats: bool = False):
    b, sq, n, d = q.shape
    sk = k.shape[1]
    _check_qkv(q, k, v)
    kmax = key_norm_max(k).contiguous()
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    l2 = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
          if with_stats else None)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
           out.data_ptr(), None if l2 is None else l2.data_ptr(),
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], b, n, sq, sk, scale * LOG2_E,
           torch.cuda.current_stream(q.device).cuda_stream)
    return (out, l2) if with_stats else out


class _BwdLaunch:
    """The checked arguments and outputs of one K3 call; `dq_kernel()`
    launches the dq kernel (which also writes delta), `dkv_kernel()` the dkv
    kernel, in that order."""

    def __init__(self, q, k, v, o, l2, g, scale: float, need_kv: bool):
        b, sq, n, d = q.shape
        _check_qkv(q, k, v)
        g = g.contiguous()
        for name, t in (("o", o), ("dO", g)):
            _check(name, t, q.device)
            if t.shape != q.shape:
                raise ValueError(f"{name} {tuple(t.shape)} does not fit q {tuple(q.shape)}")
        if (l2.dtype != torch.float32 or l2.shape != (b, n, sq)
                or not l2.is_contiguous() or l2.device != q.device):
            raise ValueError(f"L2: need contiguous float32 {(b, n, sq)} on {q.device}")
        self.delta = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
        self.dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
        self.dk = self.dv = None
        if need_kv:
            self.dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
            self.dv = torch.empty_like(self.dk)
        outs = (self.dq,) + ((self.dk, self.dv) if need_kv else (self.dq, self.dq))
        self.strides = (ctypes.c_longlong * 24)(*(
            st for t in (q, k, v, o, g) + outs for st in t.stride()[:3]))
        self.q, self.k, self.v, self.o, self.l2, self.g = q, k, v, o, l2, g
        self.dims = (b, n, sq, k.shape[1], scale, scale * LOG2_E)
        self.stream = torch.cuda.current_stream(q.device).cuda_stream

    def dq_kernel(self):
        BWD_DQ_KERNEL(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                      self.o.data_ptr(), self.g.data_ptr(), self.l2.data_ptr(),
                      self.delta.data_ptr(), self.dq.data_ptr(),
                      ctypes.addressof(self.strides), *self.dims, self.stream)

    def dkv_kernel(self):
        BWD_DKV_KERNEL(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                       self.g.data_ptr(), self.l2.data_ptr(),
                       self.delta.data_ptr(), self.dk.data_ptr(),
                       self.dv.data_ptr(), ctypes.addressof(self.strides),
                       *self.dims, self.stream)


def _flash_bwd_cuda(q, k, v, o, l2, g, scale: float, need_kv: bool = True):
    """K3 on the card: the dq kernel, then, when dK or dV is wanted, the dkv
    kernel. Returns (dq, dk, dv); dk and dv are None when not wanted."""
    launch = _BwdLaunch(q, k, v, o, l2, g, scale, need_kv)
    launch.dq_kernel()
    if need_kv:
        launch.dkv_kernel()
    return launch.dq, launch.dk, launch.dv


def flash_attention_bwd(q, k, v, o, l2, g, scale: Optional[float] = None,
                        need_kv: bool = True):
    """K3: (dq, dk, dv) of K1 at cotangent g. CUDA tensors launch the
    kernels (dk, dv None unless need_kv); CPU tensors run the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, l2, g, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"K3 runs on CUDA or (plain) CPU, not {q.device}")
    return _flash_bwd_cuda(q, k, v, o, l2, g, scale, need_kv)


def _flash_forward(q, k, v, scale: float, with_stats: bool = False):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_stats=with_stats)
    if q.device.type != "cuda":
        raise RuntimeError(f"K1 runs on CUDA or (plain) CPU, not {q.device}")
    return _flash_cuda(q, k, v, scale, with_stats)


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward with stats, K3 backward (`_flash_4d`'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, l2 = _flash_forward(q, k, v, scale, with_stats=True)
        ctx.save_for_backward(q, k, v, o, l2)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, l2 = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l2, g, ctx.scale, need_kv)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, N, D), k/v: (B, Sk, N, D) -> (B, Sq, N, D), non-causal;
    differentiable through K3 when grad is enabled."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale)
